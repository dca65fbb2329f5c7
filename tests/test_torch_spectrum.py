"""The port's spectrum slice against the JAX package, on the CPU:
``ops/windows.py``, ``ops/fastmath.py``, the K2 plain version in
``ops/kernels.py``, ``models/spectrum.py``, the ``spectrum`` block and
its routing to K2, K5 and K6, and ``convert.py``.  JAX's Pallas kernels
run in interpret mode.  ``tests/test_torch_spectrum_routes.py`` holds
the K5 and K6 routes themselves.

Tolerances, and why:
- the Blackman window and ``make_input``: bit-exact (both float64 on the
  host, then cast);
- ``approx_log10`` / ``approx_tanh``: 1e-6 (the same float32 formulas);
- K2 plain vs a float64 numpy truth: 1e-4 (an fp32 radix-2 FFT is
  ~1e-5 from it at n = 4096); vs JAX ``spectrum_fused_ct5``: 2e-4 (JAX's
  own interpret-mode kernel sits ~3.6e-5 from the truth; the JAX test's
  bar is 1e-3, ``tests/models/test_pallas_kernels.py:304``), with the
  same argmax bin per row;
- ``step`` vs JAX ``step``: 1e-4 (an FFT against the JAX package's
  matmul DFT, both float32);
- the flowgraph vs JAX ``step_pallas_ct``: 2e-4, as the kernel.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cyberether_tpu_torch as tpkg
from cyberether_tpu.models.spectrum import SpectrumPipeline as JaxSpectrum
from cyberether_tpu.ops import fastmath as jfast
from cyberether_tpu.ops import pallas_kernels as jk
from cyberether_tpu.ops import windows as jwin
from cyberether_tpu_torch import convert
from cyberether_tpu_torch.blocks.fused import SpectrumFusedModule
from cyberether_tpu_torch.core.tensor import TensorSpec
from cyberether_tpu_torch.core.types import DataType, Device, ValidationError
from cyberether_tpu_torch.models.spectrum import SpectrumPipeline
from cyberether_tpu_torch.ops import fastmath as tfast
from cyberether_tpu_torch.ops import kernels as tk
from cyberether_tpu_torch.ops import windows as twin

torch.set_num_threads(1)

B = 8
SIZES = [128, 256, 2048, 4096]
ZERO_ROW = 3                       # a dti buffer before the radio fills


def _pair(n, **kw):
    """A JAX pipeline and a port pipeline on the CPU computing with the
    JAX pipeline's constants."""
    j = JaxSpectrum(fft_size=n, batches=B, **kw)
    t = SpectrumPipeline(fft_size=n, batches=B, device="cpu", **kw)
    t.load_params(convert.spectrum_params_from_arrays(
        {"win": np.asarray(j._win), "coeff": j._coeff, "scale": j._scale,
         "offset": j._offset}, device="cpu"))
    return j, t


@functools.lru_cache(maxsize=None)
def _case(n):
    """make_input(seed=11) with one zero row; the float64 truth and the
    JAX kernel's output (interpret mode) on it."""
    j, _ = _pair(n, fast_math=False)
    iq = j.make_input(seed=11)
    iq[ZERO_ROW] = 0.0
    x = (iq[..., 0].astype(np.float64) + 1j * iq[..., 1]) \
        * np.asarray(j._win, np.float64)
    mag2 = np.abs(np.fft.fft(x, axis=-1)) ** 2
    with np.errstate(divide="ignore"):
        db = 10.0 * np.log10(mag2) + float(j._coeff)
    truth = 0.5 + 0.5 * np.tanh(
        4.0 * (db * float(j._scale) + float(j._offset) - 0.5))
    ref = np.asarray(jk.spectrum_fused_ct5(
        jnp.asarray(iq), np.asarray(j._win), float(j._coeff),
        float(j._scale), float(j._offset), interpret=True,
        stage2="cpack5"))
    return iq, truth, ref


def _plain(n):
    iq, truth, ref = _case(n)
    _, t = _pair(n, fast_math=False)
    got = tk.spectrum_fused_ct5_plain(torch.from_numpy(iq), t._win,
                                      t._coeff, t._scale, t._offset)
    return got.numpy(), truth, ref


# -- ops/windows.py, ops/fastmath.py, make_input -----------------------------

@pytest.mark.parametrize("size", [1, 2, 128, 2048, 4097])
def test_blackman_matches_jax(size):
    np.testing.assert_array_equal(twin.blackman(size).numpy(),
                                  np.asarray(jwin.blackman(size)))


@pytest.mark.parametrize("n,seed", [(128, 0), (2048, 11), (4096, 5)])
def test_make_input_and_window_match_jax(n, seed):
    j, t = JaxSpectrum(fft_size=n, batches=B), \
        SpectrumPipeline(fft_size=n, batches=B, device="cpu")
    np.testing.assert_array_equal(t.make_input(seed), j.make_input(seed))
    np.testing.assert_array_equal(t.make_input(seed, device="cpu").numpy(),
                                  j.make_input(seed))
    np.testing.assert_array_equal(t._win.numpy(), np.asarray(j._win))
    assert (t._coeff, t._scale, t._offset) == \
        (float(j._coeff), float(j._scale), float(j._offset))


def test_fastmath_matches_jax():
    rng = np.random.default_rng(3)
    x = (10.0 ** rng.uniform(-30, 8, 4096)).astype(np.float32)
    x[:3] = (0.0, 1.0, 1e-45)          # zero (mag2 floor), one, subnormal
    np.testing.assert_allclose(
        tfast.approx_log10(torch.from_numpy(x)).numpy(),
        np.asarray(jfast.approx_log10(jnp.asarray(x))), atol=1e-6, rtol=0)
    t = rng.uniform(-8, 8, 4096).astype(np.float32)
    np.testing.assert_allclose(
        tfast.approx_tanh(torch.from_numpy(t)).numpy(),
        np.asarray(jfast.approx_tanh(jnp.asarray(t))), atol=1e-6, rtol=0)


# -- K2: the plain version of the kernel -------------------------------------

@pytest.mark.parametrize("n", [128, 4096])
def test_twiddle_table_and_bit_reversal(n):
    tw = tk._k2_twiddles(n, torch.device("cpu")).numpy()
    k = np.arange(n // 2)
    w = np.exp(-2j * np.pi * k / n)
    np.testing.assert_array_equal(tw[:, 0], w.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], w.imag.astype(np.float32))
    rev = tk._bit_reversal(n, torch.device("cpu")).numpy()
    bits = n.bit_length() - 1
    assert [int(format(int(r), f"0{bits}b")[::-1], 2) for r in rev] == \
        list(range(n))


@pytest.mark.parametrize("n", SIZES)
def test_plain_k2_matches_f64_truth(n):
    got, truth, _ = _plain(n)
    assert got.shape == (B, n) and got.dtype == np.float32
    assert np.abs(got - truth).max() <= 1e-4
    assert (np.argmax(got, -1) == np.argmax(truth, -1)).all()


@pytest.mark.parametrize("n", SIZES)
def test_plain_k2_matches_jax_k2(n):
    got, _, ref = _plain(n)
    assert np.abs(got - ref).max() <= 2e-4
    # bin order: the carrier's peak lands on the same bin in every row
    live = np.arange(B) != ZERO_ROW
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).all()
    assert len(set(np.argmax(got[live], -1))) == 1


@pytest.mark.parametrize("n", SIZES)
def test_zero_row_is_exactly_zero(n):
    got, _, ref = _plain(n)
    assert (got[ZERO_ROW] == 0.0).all() and (ref[ZERO_ROW] == 0.0).all()


def test_wrapper_on_cpu_runs_plain_without_counting():
    _, t = _pair(256)
    iq = torch.from_numpy(t.make_input(seed=2))
    before = tk.spectrum_fused_ct5.launches
    got = tk.spectrum_fused_ct5(iq, t._win, t._coeff, t._scale, t._offset)
    ref = tk.spectrum_fused_ct5_plain(iq, t._win, t._coeff, t._scale,
                                      t._offset)
    assert torch.equal(got, ref)
    assert tk.spectrum_fused_ct5.launches == before


@pytest.mark.parametrize("bad", ["rank", "pairs", "dtype", "n", "win",
                                 "win_dtype", "empty"])
def test_wrapper_rejects_bad_arguments(bad):
    iq, win = torch.zeros((B, 256, 2)), torch.zeros(256)
    if bad == "rank":
        iq = torch.zeros((256, 2))
    elif bad == "pairs":
        iq = torch.zeros((B, 256, 3))
    elif bad == "dtype":
        iq = torch.zeros((B, 256, 2), dtype=torch.float64)
    elif bad == "n":
        iq, win = torch.zeros((B, 384, 2)), torch.zeros(384)   # m = 3
    elif bad == "win":
        win = torch.zeros(128)
    elif bad == "win_dtype":
        win = torch.zeros(256, dtype=torch.float64)
    else:
        iq = torch.zeros((0, 256, 2))
    with pytest.raises(ValueError):
        tk.spectrum_fused_ct5(iq, win, 0.0, 1.0, 0.0)


@pytest.mark.parametrize("n,problem", [(128, ""), (4096, ""), (64, "n=64"),
                                       (384, "n=384"), (8192, "n=8192"),
                                       (200, "n=200")])
def test_k2_cuda_unsupported(n, problem):
    got = tk.k2_cuda_unsupported(n)
    assert (got == "") == (problem == "") and problem in got


# -- models/spectrum.py ---------------------------------------------------------

@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("mxu", [True, False])
@pytest.mark.parametrize("fast", [True, False])
def test_step_matches_jax_step(n, mxu, fast):
    j, t = _pair(n, use_mxu_fft=mxu, fast_math=fast)
    iq = j.make_input(seed=4)
    iq[ZERO_ROW] = 0.0
    ref = np.asarray(j.step(jnp.asarray(iq)))
    got = t.step(torch.from_numpy(iq)).numpy()
    assert got.shape == (B, n) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-4


def test_step_kernel_matches_jax_step_pallas_ct():
    iq, _, _ = _case(256)
    j, t = _pair(256, range_min=-80.0, range_max=-10.0)
    ref = np.asarray(j.step_pallas_ct(jnp.asarray(iq), interpret=True))
    got = t.step_kernel(torch.from_numpy(iq)).numpy()
    assert np.abs(got - ref).max() <= 2e-4
    # a window passed in replaces the installed one, as in JAX
    w = np.asarray(j._win) * np.float32(0.5)
    ref = np.asarray(j.step_pallas_ct(jnp.asarray(iq), interpret=True,
                                      win=w))
    got = t.step_kernel(torch.from_numpy(iq), win=torch.from_numpy(w))
    assert np.abs(got.numpy() - ref).max() <= 2e-4


def _spy(monkeypatch):
    """Record which fused spectrum wrapper each call reaches."""
    calls = []
    for name in ("spectrum_fused", "spectrum_fused_ct4",
                 "spectrum_fused_ct5"):
        real = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _real=real, _name=name:
                            calls.append(_name) or _real(*a))
    return calls


@pytest.mark.parametrize("n,version,kernel", [
    (384, "ct5", "spectrum_fused_ct4"), (2048, "ct4", "spectrum_fused_ct4"),
    (2048, "ct5", "spectrum_fused_ct5"), (128, "ct4", "spectrum_fused_ct4")])
def test_step_kernel_routes(n, version, kernel, monkeypatch):
    """ct5 runs K2 for m a power of two and falls back to K5 otherwise,
    as JAX's ``step_pallas_ct``; ct4 runs K5 for any m."""
    iq, _, _ = _case(n) if n in SIZES else (
        JaxSpectrum(fft_size=n, batches=B).make_input(seed=5), None, None)
    j, t = _pair(n)
    calls = _spy(monkeypatch)
    got = t.step_kernel(torch.from_numpy(iq), version=version).numpy()
    assert calls == [kernel]
    ref = np.asarray(j.step_pallas_ct(jnp.asarray(iq), interpret=True,
                                      version=version))
    assert np.abs(got - ref).max() <= 2e-4
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).all()


@pytest.mark.parametrize("n,version", [(8192, "ct5"), (64, "ct5"),
                                       (4224, "ct4"), (200, "ct4")])
def test_step_kernel_rejects_sizes_past_the_ct_kernels(n, version):
    """n = 128 m with m <= 32 only, where JAX's ct kernels assert."""
    t = SpectrumPipeline(fft_size=n, batches=2, device="cpu")
    with pytest.raises(ValueError, match=f"n={n}"):
        t.step_kernel(torch.zeros((2, n, 2)), version=version)


def test_step_kernel_rejects_unknown_version():
    t = SpectrumPipeline(fft_size=256, batches=2, device="cpu")
    with pytest.raises(ValueError, match="version"):
        t.step_kernel(torch.zeros((2, 256, 2)), version="ct9")


def test_convert_params_from_jax():
    j = JaxSpectrum(fft_size=256, batches=B, range_min=-60.0,
                    range_max=20.0)
    t = SpectrumPipeline(fft_size=256, batches=B, device="cpu")   # -100..0
    params = convert.spectrum_params_from_arrays(
        {"win": np.asarray(j._win), "coeff": j._coeff, "scale": j._scale,
         "offset": j._offset}, device="cpu")
    t.load_params(params)
    assert (t._scale, t._offset) == (float(j._scale), float(j._offset))
    assert isinstance(t._coeff, float)
    with pytest.raises(ValueError):
        convert.spectrum_params_from_arrays(
            {"win": np.zeros((2, 128), np.float32), "coeff": 0.0,
             "scale": 1.0, "offset": 0.0}, device="cpu")
    with pytest.raises(ValueError):
        t.load_params({**params, "win": np.zeros(128, np.float32)})


# -- the dti -> spectrum flowgraph -------------------------------------------

def _flowgraph(config=None, dtype="F32", n=256):
    fg = tpkg.Flowgraph(default_device="cpu")
    shape = [B, n, 2] if dtype == "F32" else [B, n]
    fg.block_create("src", "dti", {"shape": shape, "dataType": dtype})
    fg.block_create("spec", "spectrum", config or {},
                    {"buffer": "${graph.src.output.buffer}"},
                    provider="pallas")
    return fg


def _run(fg, bufs):
    outs = []
    try:
        for b in bufs:
            fg.block_module("src").attach_buffer(b)
            assert fg.compute(timeout=30.0)
            assert fg.scheduler.output_valid("spec.spectrum")
            outs.append(np.asarray(fg.scheduler.output("spec.spectrum")))
    finally:
        fg.stop()
    return outs


def test_flowgraph_matches_jax_step_pallas_ct():
    j = JaxSpectrum(fft_size=256, batches=B)
    iqs = [j.make_input(seed=s) for s in (1, 2)]
    iqs[1][ZERO_ROW] = 0.0
    f32 = _run(_flowgraph(), iqs)
    cf32 = _run(_flowgraph(dtype="CF32"), [
        (iq[..., 0] + 1j * iq[..., 1]).astype(np.complex64) for iq in iqs])
    for iq, a, c in zip(iqs, f32, cf32):
        ref = np.asarray(j.step_pallas_ct(jnp.asarray(iq), interpret=True))
        assert a.shape == (B, 256) and np.isfinite(a).all()
        assert np.abs(a - ref).max() <= 2e-4
        assert (np.argmax(a, -1) == np.argmax(ref, -1)).all()
        np.testing.assert_array_equal(c, a)
    assert (f32[1][ZERO_ROW] == 0.0).all()


def test_precision_tiers_run_the_same_kernel():
    rng = np.random.default_rng(0)
    iq = rng.standard_normal((B, 256, 2)).astype(np.float32)
    outs = {prec: _run(_flowgraph({"precision": prec}), [iq])[0]
            for prec in ("", "exact", "accurate", "display")}
    outs["bf16"] = _run(_flowgraph({"bf16": True}), [iq])[0]
    for out in outs.values():
        np.testing.assert_array_equal(out, outs[""])
    j = JaxSpectrum(fft_size=256, batches=B)
    ref = np.asarray(j.step_pallas_ct(jnp.asarray(iq), interpret=True))
    assert np.abs(outs[""] - ref).max() <= 2e-4


def test_block_output_spec_and_range():
    fg = _flowgraph({"rangeMin": -80.0, "rangeMax": -20.0})
    spec = fg.block_module("spec").output_specs["spectrum"]
    assert spec.shape == (B, 256) and spec.dtype == DataType.F32
    pipe = fg.block_module("spec")._pipe
    assert pipe._scale == float(np.float32(1.0 / 60.0))
    fg.stop()


@pytest.mark.parametrize("shape,dtype,config,match", [
    ((B, 256, 3), DataType.F32, {}, "CF32"),          # not (B, n, 2)
    ((256,), DataType.CF32, {}, "CF32"),              # not (B, n)
    ((B, 300), DataType.CF32, {}, "multiple of 128"),
    ((B, 256), DataType.CF32, {"algorithm": "fast"}, "auto/ct/dft"),
    ((B, 256), DataType.CF32, {"precision": "wrong"}, "precision"),
    ((B, 256), DataType.CF32, {"algorithm": "dft", "precision": "exact"},
     "precision tiers"),
    ((B, 8192), DataType.CF32, {"algorithm": "ct"}, "m<=32"),
])
def test_block_validation_errors(shape, dtype, config, match):
    spec = {"buffer": TensorSpec(shape, dtype)}
    with pytest.raises(ValidationError, match=match):
        SpectrumFusedModule("spec/m", config, spec, device=Device.CPU)


@pytest.mark.parametrize("shape,config,kernel", [
    ((B, 384), {}, "spectrum_fused_ct4"),             # m = 3
    ((B, 384), {"algorithm": "ct"}, "spectrum_fused_ct4"),
    ((B, 256), {"algorithm": "dft"}, "spectrum_fused"),
    ((B, 64), {}, "spectrum_fused"),                  # n < 128
    ((B, 8192), {}, "spectrum_fused"),                # m > 32
])
def test_block_routes(shape, config, kernel, monkeypatch):
    """Each shape the JAX block takes reaches its kernel's wrapper, and
    matches JAX's ``step_pallas`` (K6) or ``step_pallas_ct`` (here its
    ct4 fallback); at n = 8192, where JAX's two n x n matrices are too
    large to hold here, a float64 truth at 1e-3 instead."""
    n = shape[1]
    mod = SpectrumFusedModule("spec/m", config,
                              {"buffer": TensorSpec(shape, DataType.CF32)},
                              device=Device.CPU)
    j = JaxSpectrum(fft_size=n, batches=B)
    iq = j.make_input(seed=7)
    iq[ZERO_ROW] = 0.0
    calls = _spy(monkeypatch)
    got = mod.apply({"buffer": torch.complex(
        torch.from_numpy(iq[..., 0]), torch.from_numpy(iq[..., 1]))},
        None)[0]["spectrum"].numpy()
    assert calls == [kernel]
    if n == 8192:
        x = (iq[..., 0].astype(np.float64) + 1j * iq[..., 1]) \
            * np.asarray(j._win, np.float64)
        with np.errstate(divide="ignore"):
            db = 10.0 * np.log10(np.abs(np.fft.fft(x, axis=-1)) ** 2) \
                + float(j._coeff)
        ref = 0.5 + 0.5 * np.tanh(
            4.0 * (db * float(j._scale) + float(j._offset) - 0.5))
        tol = 1e-3
    else:
        ref = np.asarray(
            j.step_pallas(jnp.asarray(iq), interpret=True)
            if kernel == "spectrum_fused" else
            j.step_pallas_ct(jnp.asarray(iq), interpret=True))
        tol = 2e-4
    assert got.shape == (B, n) and np.abs(got - ref).max() <= tol
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).all()
    assert (got[ZERO_ROW] == 0.0).all()


def test_bad_block_config_errors_the_block():
    fg = _flowgraph({"algorithm": "fast"})
    assert fg.block_state("spec").value == "errored"
    assert "auto/ct/dft" in fg.block_error("spec")
    assert fg.block_state("src").value == "complete"
    fg.stop()
