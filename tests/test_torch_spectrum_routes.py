"""The `spectrum` block's full-DFT and ct4 routes against the JAX
package, on the CPU: the K6 (``spectrum_fused``) and K5
(``spectrum_fused_ct4``) plain versions in ``ops/kernels.py``,
``SpectrumPipeline.step_dft``, ``step_dft_kernel`` and ``step_kernel``'s
ct4 fallback, the block on a CPU flowgraph, and ``convert.py``.  JAX's
Pallas kernels run in interpret mode.

Tolerances, and why:
- the n-entry twiddle table: bit-exact against JAX's ``_dft_cs`` (both
  float64 on the host, then cast);
- K6 and K5 plain vs JAX interpret-mode ``spectrum_fused`` /
  ``step_pallas_ct`` (ct4): 2e-4, with the same argmax bin per row (JAX's
  float32 products sit ~1e-4 from a float64 truth at the display's deep
  nulls; the JAX tests' own bars are 2e-3 and 1e-3,
  ``tests/models/test_pallas_kernels.py:217-226,310-329``);
- the model of K6's split route (``spectrum_split_plain``: the window,
  two passes of the Stockham core, the epilogue) vs JAX interpret-mode
  ``spectrum_fused`` at forced splits, a 131-point factor among them:
  2e-4, as above; vs K6's plain version: 1e-4 (16768 = 128 x 131 too);
- the model of K6's chirp route (``spectrum_chirp_plain``: the window,
  Bluestein's transform over M on the core's passes, |W|^2, the
  epilogue) vs JAX interpret-mode ``spectrum_fused`` (bin tile 1031) at n
  = 1031 and 2062: 2e-4, as above; vs K6's plain version: 1e-4 (also at
  16381); vs a float64 truth at 131968 = 128 x 1031: 1e-4;
- K6 and K5 plain vs a numpy float64 truth: 1e-4 (K6's plain version
  sums in float64; K5's m-point stage and radix-2 passes are a few
  float32 roundings deep).  JAX's ``_dft_cs(n)`` holds two n x n
  matrices, so sizes past 2048 compare with the truth only;
- ``step_dft`` vs JAX ``step_dft``: 2e-4, fp32 and bf16;
- the port's fp32 K6 on JAX's bf16 display tier: the 0.999 quantile of
  the error under 8e-3 and its max under 2e-2, JAX's own bars on its
  broadband input (``test_pallas_kernels.py:259-276``).
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cyberether_tpu_torch as tpkg
from cyberether_tpu.models.spectrum import SpectrumPipeline as JaxSpectrum
from cyberether_tpu.ops import pallas_kernels as jk
from cyberether_tpu_torch import convert
from cyberether_tpu_torch.models.spectrum import SpectrumPipeline
from cyberether_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

B = 8                              # JAX's K6 takes B % min(128, B) == 0
ZERO_ROW = 3
K5_SIZES = [384, 640, 1536, 3968]  # m = 3, 5, 12, 31


def _pair(n, batches=B, **kw):
    """A JAX pipeline and a port pipeline on the CPU computing with the
    JAX pipeline's constants."""
    j = JaxSpectrum(fft_size=n, batches=batches, **kw)
    t = SpectrumPipeline(fft_size=n, batches=batches, device="cpu", **kw)
    t.load_params(convert.spectrum_params_from_arrays(
        {"win": np.asarray(j._win), "coeff": j._coeff, "scale": j._scale,
         "offset": j._offset}, device="cpu"))
    return j, t


def _truth(iq, j):
    """The fused spectrum of ``iq`` in float64 (numpy FFT)."""
    x = (iq[..., 0].astype(np.float64) + 1j * iq[..., 1]) \
        * np.asarray(j._win, np.float64)
    with np.errstate(divide="ignore"):
        db = 10.0 * np.log10(np.abs(np.fft.fft(x, axis=-1)) ** 2) \
            + float(j._coeff)
    return 0.5 + 0.5 * np.tanh(
        4.0 * (db * float(j._scale) + float(j._offset) - 0.5))


@functools.lru_cache(maxsize=None)
def _input(n, batches=B, seed=11):
    """make_input with one zero row, as numpy."""
    iq = JaxSpectrum(fft_size=n, batches=batches).make_input(seed=seed)
    iq[min(ZERO_ROW, batches - 1)] = 0.0
    return iq


def _held(got, ref, tol, zero_row=ZERO_ROW):
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= tol
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).all()
    assert (got[zero_row] == 0.0).all()


# -- the n-entry twiddle table -----------------------------------------------

@pytest.mark.parametrize("n", [1, 100, 256])
def test_dft_twiddles_are_jax_dft_cs(n):
    tw = tk._dft_twiddles(n, torch.device("cpu")).numpy()
    cmat, smat = jk._dft_cs(n)
    jk_idx = np.outer(np.arange(n), np.arange(n)) % n
    np.testing.assert_array_equal(tw[jk_idx, 0], cmat)
    np.testing.assert_array_equal(-tw[jk_idx, 1], smat)


# -- K6: the plain version of the full-DFT kernel ----------------------------

@pytest.mark.parametrize("n", [64, 100, 256, 2048])
def test_plain_k6_matches_jax_k6(n):
    j, t = _pair(n, fast_math=False)
    iq = _input(n)
    ref = np.asarray(j.step_pallas(jnp.asarray(iq), interpret=True))
    got = tk.spectrum_fused_plain(torch.from_numpy(iq), t._win, t._coeff,
                                  t._scale, t._offset).numpy()
    _held(got, ref, 2e-4)
    assert (ref[ZERO_ROW] == 0.0).all()
    # the tone lands on one bin in every live row
    live = np.arange(B) != ZERO_ROW
    assert len(set(np.argmax(got[live], -1))) == 1


@pytest.mark.parametrize("n,batches", [(1, 3), (5, 3), (64, 8), (100, 5),
                                       (2048, 8), (4224, 2), (8192, 2)])
def test_plain_k6_matches_f64_truth(n, batches):
    """Any n and any B, past what the ct kernels take (4224 = 33 x 128)."""
    j, t = _pair(n, batches=batches)
    iq = _input(n, batches)
    got = tk.spectrum_fused_plain(torch.from_numpy(iq), t._win, t._coeff,
                                  t._scale, t._offset).numpy()
    _held(got, _truth(iq, j), 1e-4, zero_row=min(ZERO_ROW, batches - 1))


@pytest.mark.parametrize("n,split", [(384, (16, 24)), (384, (24, 16)),
                                     (1536, (32, 48)), (1536, (12, 128))])
def test_split_steps_match_jax_k6(n, split):
    """The split route's steps at forced splits of 384 and 1536 (either
    order; 12 = 4 x 3 and 24 = 8 x 3 on runtime plans)."""
    j, t = _pair(n, fast_math=False)
    iq = _input(n)
    ref = np.asarray(j.step_pallas(jnp.asarray(iq), interpret=True))
    got = tk.spectrum_split_plain(torch.from_numpy(iq), t._win, t._coeff,
                                  t._scale, t._offset, split).numpy()
    _held(got, ref, 2e-4)


@pytest.mark.parametrize("n,batches,split", [
    (384, 8, (16, 24)), (1536, 8, (12, 128)), (16512, 2, None),
    (16768, 2, None), (2 * 1021, 4, (2, 1021))])
def test_split_steps_match_plain_k6(n, batches, split):
    """Against K6's plain version (float64 sums), at forced splits and at
    16512 = 128 x 129, the first spectrum size past 16384 points, and
    16768 = 128 x 131, the first with a prime past 127 (its rows on the
    large-prime pass)."""
    _, t = _pair(n, batches=batches)
    iq = torch.from_numpy(_input(n, batches))
    args = (t._win, t._coeff, t._scale, t._offset)
    got = tk.spectrum_split_plain(iq, *args, split).numpy()
    _held(got, tk.spectrum_fused_plain(iq, *args).numpy(), 1e-4,
          zero_row=min(ZERO_ROW, batches - 1))


@pytest.mark.parametrize("n,split", [(262, (2, 131)), (262, (131, 2)),
                                     (393, (3, 131))])
def test_large_prime_split_steps_match_jax_k6(n, split):
    """The split route's steps with a 131-point factor on either side
    against JAX's interpret-mode ``spectrum_fused``, its bin tile 131 (a
    divisor of n): 2e-4, as above."""
    j, t = _pair(n, fast_math=False)
    iq = _input(n)
    ref = np.asarray(jk.spectrum_fused(
        jnp.asarray(iq), np.asarray(j._win), float(j._coeff),
        float(j._scale), float(j._offset), tile_k=131, interpret=True))
    got = tk.spectrum_split_plain(torch.from_numpy(iq), t._win, t._coeff,
                                  t._scale, t._offset, split).numpy()
    _held(got, ref, 2e-4)


@pytest.mark.parametrize("n", [1031, 2062])
def test_chirp_steps_match_jax_k6(n):
    """The chirp route's steps at a prime past 1021 (M = 2560) and twice
    it (M = 5120) against JAX's interpret-mode ``spectrum_fused``, its bin
    tile 1031 (a divisor of n): 2e-4, as above; and against K6's plain
    version: 1e-4."""
    j, t = _pair(n, fast_math=False)
    iq = _input(n)
    ref = np.asarray(jk.spectrum_fused(
        jnp.asarray(iq), np.asarray(j._win), float(j._coeff),
        float(j._scale), float(j._offset), tile_k=1031, interpret=True))
    args = (t._win, t._coeff, t._scale, t._offset)
    got = tk.spectrum_chirp_plain(torch.from_numpy(iq), *args).numpy()
    _held(got, ref, 2e-4)
    _held(got, tk.spectrum_fused_plain(torch.from_numpy(iq), *args).numpy(),
          1e-4)


def test_chirp_steps_match_plain_k6_past_16384_points():
    """n = 16381, the largest prime below 16384: M = 32768, past one
    block, on the split's passes (128 x 256)."""
    n, batches = 16381, 2
    _, t = _pair(n, batches=batches)
    iq = torch.from_numpy(_input(n, batches))
    args = (t._win, t._coeff, t._scale, t._offset)
    _held(tk.spectrum_chirp_plain(iq, *args).numpy(),
          tk.spectrum_fused_plain(iq, *args).numpy(), 1e-4, zero_row=1)


def test_chirp_steps_match_f64_truth_at_128_x_1031():
    """n = 131968, the first spectrum size with a prime past 1021: M =
    327680 = 512 x 640 (the float64 product of K6's plain version takes
    minutes here; the truth is numpy's FFT)."""
    n, batches = 131968, 2
    j, t = _pair(n, batches=batches)
    iq = _input(n, batches)
    got = tk.spectrum_chirp_plain(torch.from_numpy(iq), t._win, t._coeff,
                                  t._scale, t._offset).numpy()
    _held(got, _truth(iq, j), 1e-4, zero_row=1)


def test_k6_wrapper_on_cpu_runs_plain_without_counting():
    _, t = _pair(100)
    iq = torch.from_numpy(_input(100))
    before = tk.spectrum_fused.launches
    got = tk.spectrum_fused(iq, t._win, t._coeff, t._scale, t._offset)
    ref = tk.spectrum_fused_plain(iq, t._win, t._coeff, t._scale, t._offset)
    assert torch.equal(got, ref)
    assert tk.spectrum_fused.launches == before


# -- K5: the plain version of the ct4 kernel ---------------------------------

@pytest.mark.parametrize("n", K5_SIZES + [1024])
def test_plain_k5_matches_jax_ct4(n):
    """JAX's ct4 route: its fallback for m not a power of two, and
    version="ct4" at a power of two (m = 8)."""
    j, t = _pair(n, fast_math=False)
    iq = _input(n)
    ref = np.asarray(j.step_pallas_ct(jnp.asarray(iq), interpret=True,
                                      version="ct4"))
    got = tk.spectrum_fused_ct4_plain(torch.from_numpy(iq), t._win,
                                      t._coeff, t._scale, t._offset).numpy()
    _held(got, ref, 2e-4)


@pytest.mark.parametrize("m", range(1, 33))
def test_plain_k5_matches_f64_truth(m):
    n = 128 * m
    j, t = _pair(n, batches=2)
    iq = _input(n, 2, seed=m)
    got = tk.spectrum_fused_ct4_plain(torch.from_numpy(iq), t._win,
                                      t._coeff, t._scale, t._offset).numpy()
    _held(got, _truth(iq, j), 1e-4, zero_row=1)


def test_k5_plain_is_k2_plain_at_a_power_of_two():
    """At m = 1 both run the 128-point radix-2 passes alone."""
    _, t = _pair(128)
    iq = torch.from_numpy(_input(128))
    args = (t._win, t._coeff, t._scale, t._offset)
    assert torch.equal(tk.spectrum_fused_ct4_plain(iq, *args),
                       tk.spectrum_fused_ct5_plain(iq, *args))


def test_k5_wrapper_on_cpu_runs_plain_without_counting():
    _, t = _pair(384)
    iq = torch.from_numpy(_input(384))
    before = tk.spectrum_fused_ct4.launches
    got = tk.spectrum_fused_ct4(iq, t._win, t._coeff, t._scale, t._offset)
    ref = tk.spectrum_fused_ct4_plain(iq, t._win, t._coeff, t._scale,
                                      t._offset)
    assert torch.equal(got, ref)
    assert tk.spectrum_fused_ct4.launches == before


@pytest.mark.parametrize("name", ["spectrum_fused", "spectrum_fused_ct4"])
@pytest.mark.parametrize("bad", ["rank", "pairs", "dtype", "win",
                                 "win_dtype", "rows", "samples"])
def test_wrappers_reject_bad_arguments(name, bad):
    iq, win = torch.zeros((B, 384, 2)), torch.zeros(384)
    if bad == "rank":
        iq = torch.zeros((384, 2))
    elif bad == "pairs":
        iq = torch.zeros((B, 384, 3))
    elif bad == "dtype":
        iq = torch.zeros((B, 384, 2), dtype=torch.float64)
    elif bad == "win":
        win = torch.zeros(128)
    elif bad == "win_dtype":
        win = torch.zeros(384, dtype=torch.float64)
    elif bad == "rows":
        iq = torch.zeros((0, 384, 2))
    else:
        iq, win = torch.zeros((B, 0, 2)), torch.zeros(0)
    with pytest.raises(ValueError):
        getattr(tk, name)(iq, win, 0.0, 1.0, 0.0)


@pytest.mark.parametrize("n,problem", [(128, ""), (384, ""), (3968, ""),
                                       (4096, ""), (64, "n=64"),
                                       (4224, "n=4224"), (200, "n=200")])
def test_k5_cuda_unsupported(n, problem):
    got = tk.k5_cuda_unsupported(n)
    assert (got == "") == (problem == "") and problem in got
    with pytest.raises(ValueError, match=problem) if problem else \
            contextlib.nullcontext():
        tk.spectrum_fused_ct4(torch.zeros((1, n, 2)), torch.zeros(n),
                              0.0, 1.0, 0.0)


# -- models/spectrum.py --------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_step_dft_matches_jax_step_dft(bf16, fast):
    j, t = _pair(256, fast_math=fast)
    iq = _input(256)
    ref = np.asarray(j.step_dft(jnp.asarray(iq), bf16=bf16))
    got = t.step_dft(torch.from_numpy(iq), bf16=bf16).numpy()
    assert got.shape == (B, 256) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 2e-4


def test_step_dft_kernel_matches_jax_step_pallas():
    j, t = _pair(100, range_min=-80.0, range_max=-10.0)
    iq = _input(100)
    ref = np.asarray(j.step_pallas(jnp.asarray(iq), interpret=True))
    got = t.step_dft_kernel(torch.from_numpy(iq)).numpy()
    _held(got, ref, 2e-4)
    # a window passed in replaces the installed one, as in JAX
    w = np.asarray(j._win) * np.float32(0.5)
    ref = np.asarray(j.step_pallas(jnp.asarray(iq), interpret=True, win=w))
    got = t.step_dft_kernel(torch.from_numpy(iq), win=torch.from_numpy(w))
    assert np.abs(got.numpy() - ref).max() <= 2e-4


def test_fp32_k6_meets_jax_bf16_display_tier():
    """The fp32 kernel, which also serves the bf16 tier, stays within
    JAX's own bars for its bf16 tier against the exact model."""
    j, t = _pair(2048, use_mxu_fft=False, fast_math=False)
    rng = np.random.default_rng(7)
    iq = (0.3 * rng.standard_normal((B, 2048, 2))).astype(np.float32)
    ref = np.asarray(j.step_pallas(jnp.asarray(iq), bf16=True,
                                   interpret=True))
    got = t.step_dft_kernel(torch.from_numpy(iq)).numpy()
    err = np.abs(got - ref)
    assert np.quantile(err, 0.999) < 8e-3 and err.max() < 2e-2


@pytest.mark.parametrize("n", [384, 1536])
def test_step_kernel_ct5_falls_back_to_ct4(n):
    """m not a power of two: version "ct5" runs K5, as JAX's
    ``step_pallas_ct`` falls back to ``spectrum_fused_ct4``."""
    j, t = _pair(n)
    iq = _input(n)
    got = t.step_kernel(torch.from_numpy(iq))
    assert torch.equal(got, t.step_kernel(torch.from_numpy(iq),
                                          version="ct4"))
    ref = np.asarray(j.step_pallas_ct(jnp.asarray(iq), interpret=True))
    _held(got.numpy(), ref, 2e-4)


# -- the dti -> spectrum flowgraph on every route --------------------------------

def _run(n, config=None, dtype="F32", iqs=()):
    """``iqs`` through dti -> spectrum on a CPU flowgraph; the outputs."""
    fg = tpkg.Flowgraph(default_device="cpu")
    shape = [B, n, 2] if dtype == "F32" else [B, n]
    fg.block_create("src", "dti", {"shape": shape, "dataType": dtype})
    fg.block_create("spec", "spectrum", config or {},
                    {"buffer": "${graph.src.output.buffer}"},
                    provider="pallas")
    outs = []
    try:
        assert fg.block_state("spec").value == "complete", \
            fg.block_error("spec")
        for iq in iqs:
            if dtype == "CF32":
                iq = (iq[..., 0] + 1j * iq[..., 1]).astype(np.complex64)
            fg.block_module("src").attach_buffer(iq)
            assert fg.compute(timeout=30.0)
            assert fg.scheduler.output_valid("spec.spectrum")
            outs.append(np.asarray(fg.scheduler.output("spec.spectrum")))
    finally:
        fg.stop()
    return outs


@pytest.mark.parametrize("n,config", [
    (256, {"algorithm": "dft"}), (64, {}), (384, {}), (1536, {}),
    (384, {"algorithm": "ct"})])
@pytest.mark.parametrize("dtype", ["F32", "CF32"])
def test_flowgraph_matches_jax_block_route(n, config, dtype):
    """JAX's block runs ``step_pallas`` (K6) for algorithm dft and for
    n < 128, and ``step_pallas_ct`` (here its ct4 fallback) otherwise."""
    j = JaxSpectrum(fft_size=n, batches=B)
    iqs = [_input(n, seed=s) for s in (1, 2)]
    dft = config.get("algorithm") == "dft" or n < 128
    for iq, got in zip(iqs, _run(n, config, dtype, iqs)):
        ref = np.asarray(j.step_pallas(jnp.asarray(iq), interpret=True)
                         if dft else
                         j.step_pallas_ct(jnp.asarray(iq), interpret=True))
        assert got.shape == (B, n) and np.isfinite(got).all()
        _held(got, ref, 2e-4)


def test_flowgraph_past_m_32_matches_f64_truth():
    """n = 4224 (m = 33): the full DFT, where JAX's n x n matrices are
    too large to hold here."""
    j = JaxSpectrum(fft_size=4224, batches=B)
    iq = _input(4224, seed=3)
    got, = _run(4224, iqs=[iq])
    _held(got, _truth(iq, j), 1e-4)


@pytest.mark.parametrize("n,tiers", [
    (256, ({"algorithm": "dft", "bf16": True},)),
    (100, ({"bf16": True},)),
    (384, ({"precision": "exact"}, {"precision": "accurate"},
           {"precision": "display"}, {"bf16": True}))])
def test_precision_tiers_run_the_same_kernel(n, tiers):
    rng = np.random.default_rng(n)
    iq = rng.standard_normal((B, n, 2)).astype(np.float32)
    base = {"algorithm": "dft"} if n == 256 else {}
    ref, = _run(n, base, iqs=[iq])
    for tier in tiers:
        got, = _run(n, tier, iqs=[iq])
        np.testing.assert_array_equal(got, ref)


# -- convert.py ------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 1536])
def test_convert_params_at_route_sizes(n):
    j = JaxSpectrum(fft_size=n, batches=B, range_min=-60.0, range_max=20.0)
    t = SpectrumPipeline(fft_size=n, batches=B, device="cpu")   # -100..0
    t.load_params(convert.spectrum_params_from_arrays(
        {"win": np.asarray(j._win), "coeff": j._coeff, "scale": j._scale,
         "offset": j._offset}, device="cpu"))
    np.testing.assert_array_equal(t._win.numpy(), np.asarray(j._win))
    assert (t._coeff, t._scale, t._offset) == \
        (float(j._coeff), float(j._scale), float(j._offset))
    iq = _input(n)
    ref = np.asarray(j.step_pallas(jnp.asarray(iq), interpret=True)
                     if n < 128 else
                     j.step_pallas_ct(jnp.asarray(iq), interpret=True))
    got = (t.step_dft_kernel if n < 128 else t.step_kernel)(
        torch.from_numpy(iq)).numpy()
    _held(got, ref, 2e-4)
