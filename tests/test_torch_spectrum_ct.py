"""The spectrum's remaining ct routes against the JAX package, on the
CPU: K10 (``spectrum_fused_ct``, JAX's ct1, through
``SpectrumPipeline.step_kernel(version="ct1")``), K11
(``spectrum_fused_ct3``, every ``stage2``/``three_mul``/``kb``/``ep``/
``skip`` the JAX function takes), K3's display tier
(``fft_pallas(exact=False)``) and ``step_kernel``'s JAX keywords.  JAX's
Pallas kernels run in interpret mode.

Tolerances, and why:
- against JAX where it computes its stage 2 in float32 (K10 both tiers;
  K11 ``stage2`` "default"/"highest"): 2e-4, with the same argmax bin per
  row and exactly 0 on a zero row (the port's K5 bar);
- against JAX's bf16-split stages (K11 "x3", "x4" and ``three_mul``):
  1e-3, since their split error puts JAX ~3e-4 from a float64 truth;
- every exact-epilogue output against a numpy float64 truth: 1e-4;
- ``ep="approx"`` against JAX (float32 stage): 5e-5, its zero row
  included, where both give ~1e-4 (JAX's interpret mode runs its
  approximate reciprocal as a bf16 divide; one Newton step brings it to
  ~1e-5 relative);
- ``ep="none"`` (|X|^2): 1e-5 of each row's max;
- K3's display tier: 1e-5 of max|X| against JAX's display tier and
  ``np.fft`` (the JAX tests' bar for ``fft_pallas``).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cyberether_tpu.models.spectrum import SpectrumPipeline as JaxSpectrum
from cyberether_tpu.ops import pallas_kernels as jk
from cyberether_tpu_torch import convert
from cyberether_tpu_torch.models.spectrum import SpectrumPipeline
from cyberether_tpu_torch.ops import fastmath
from cyberether_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

B = 16
ZERO_ROW = 3
K10_SIZES = [128, 384, 2048, 4096]         # m = 1, 3, 16, 32
K11_SIZES = [384, 2048]                    # m = 3, 16
BF16_STAGES = ("x3", "x4")


@functools.lru_cache(maxsize=None)
def _pair(n, batches=B):
    """A JAX pipeline and a port pipeline on the CPU computing with the
    JAX pipeline's constants."""
    j = JaxSpectrum(fft_size=n, batches=batches)
    t = SpectrumPipeline(fft_size=n, batches=batches, device="cpu")
    t.load_params(convert.spectrum_params_from_arrays(
        {"win": np.asarray(j._win), "coeff": j._coeff, "scale": j._scale,
         "offset": j._offset}, device="cpu"))
    return j, t


@functools.lru_cache(maxsize=None)
def _input(n, batches=B, seed=1):
    """make_input with one zero row, as numpy."""
    iq = JaxSpectrum(fft_size=n, batches=batches).make_input(seed=seed)
    iq[ZERO_ROW] = 0.0
    iq.flags.writeable = False
    return iq


@functools.lru_cache(maxsize=None)
def _truth(n, batches=B, seed=1):
    """The fused spectrum of ``_input`` in float64 (numpy FFT)."""
    j, _ = _pair(n, batches)
    iq = _input(n, batches, seed)
    x = (iq[..., 0].astype(np.float64) + 1j * iq[..., 1]) \
        * np.asarray(j._win, np.float64)
    with np.errstate(divide="ignore"):
        db = 10.0 * np.log10(np.abs(np.fft.fft(x, axis=-1)) ** 2) \
            + float(j._coeff)
    return 0.5 + 0.5 * np.tanh(
        4.0 * (db * float(j._scale) + float(j._offset) - 0.5))


def _args(n, batches=B):
    """The JAX kernels' and the port's (win, coeff, scale, offset)."""
    j, t = _pair(n, batches)
    jargs = (np.asarray(j._win), float(j._coeff), float(j._scale),
             float(j._offset))
    return jargs, (t._win, t._coeff, t._scale, t._offset)


@functools.lru_cache(maxsize=None)
def _jax_ct3(n, batches=B, seed=1, **kw):
    jargs, _ = _args(n, batches)
    return np.asarray(jk.spectrum_fused_ct3(
        jnp.asarray(_input(n, batches, seed)), *jargs, interpret=True,
        **kw))


def _port_ct3(n, batches=B, seed=1, plain=False, **kw):
    _, targs = _args(n, batches)
    fn = tk.spectrum_fused_ct3_plain if plain else tk.spectrum_fused_ct3
    return fn(torch.from_numpy(_input(n, batches, seed).copy()), *targs,
              **kw).numpy()


def _held(got, ref, tol, zero=0.0):
    """Within ``tol``, the same argmax bin in every row, and ``zero`` on
    the zero row (None: the reference's value there)."""
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).all()
    if zero is not None:
        assert (got[ZERO_ROW] == zero).all()


def _rel_to_row_max(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


# -- K10: spectrum_fused_ct (ct1) --------------------------------------------

@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n", K10_SIZES)
def test_k10_matches_jax_ct1(n, exact):
    """The plain version and ``step_kernel(version="ct1", exact=...)``
    against JAX's ``step_pallas_ct`` on the same route and tier."""
    j, t = _pair(n)
    iq = _input(n)
    ref = np.asarray(j.step_pallas_ct(jnp.asarray(iq), interpret=True,
                                      version="ct1", exact=exact))
    assert (ref[ZERO_ROW] == 0.0).all()
    _, targs = _args(n)
    x = torch.from_numpy(iq.copy())
    plain = tk.spectrum_fused_ct_plain(x, *targs, exact=exact).numpy()
    got = t.step_kernel(x, version="ct1", exact=exact).numpy()
    np.testing.assert_array_equal(got, plain)
    _held(got, ref, 2e-4)
    _held(got, _truth(n).astype(np.float32), 1e-4)


@pytest.mark.parametrize("m", [1, 5, 12, 31])
def test_k10_plain_is_k5_plain(m):
    """K10 runs K5's kernel, so its plain version is K5's, bit for bit."""
    n = 128 * m
    _, targs = _args(n, 4)
    x = torch.from_numpy(_input(n, 4, seed=m).copy())
    np.testing.assert_array_equal(
        tk.spectrum_fused_ct_plain(x, *targs).numpy(),
        tk.spectrum_fused_ct4_plain(x, *targs).numpy())


# -- K11: spectrum_fused_ct3 -----------------------------------------------------

@pytest.mark.parametrize("kb", [1, 2])
@pytest.mark.parametrize("three_mul", [False, True])
@pytest.mark.parametrize("stage2", ["x3", "x4", "default", "highest"])
@pytest.mark.parametrize("n", K11_SIZES)
def test_k11_matches_jax_ct3(n, stage2, three_mul, kb):
    """Every stage-2 tier runs the port's fp32 stage: 1e-3 of JAX where
    JAX splits to bf16, 2e-4 where it does not, 1e-4 of the truth."""
    kw = dict(stage2=stage2, three_mul=three_mul, kb=kb)
    ref = _jax_ct3(n, **kw)
    got = _port_ct3(n, **kw)
    bf16 = stage2 in BF16_STAGES or three_mul
    _held(got, ref, 1e-3 if bf16 else 2e-4)
    _held(got, _truth(n).astype(np.float32), 1e-4)
    np.testing.assert_array_equal(got, _port_ct3(n, plain=True, **kw))


@pytest.mark.parametrize("stage2", ["x9", ""])
def test_k11_takes_any_stage2_string(stage2):
    """JAX takes any string (a name it does not know falls to its split
    branch); the port runs its fp32 stage for every one."""
    np.testing.assert_array_equal(_port_ct3(384, stage2=stage2),
                                  _port_ct3(384))


@pytest.mark.parametrize("kb", [1, 2])
@pytest.mark.parametrize("n", K11_SIZES)
def test_k11_approx_epilogue_matches_jax(n, kb):
    """``ep="approx"``: 5e-5 of JAX with its float32 stage, the zero row
    included, where neither gives 0 (the Padé tanh clamps at 4.5)."""
    ref = _jax_ct3(n, stage2="highest", kb=kb, ep="approx")
    got = _port_ct3(n, stage2="highest", kb=kb, ep="approx")
    _held(got, ref, 5e-5, zero=None)
    assert (1.0e-4 <= got[ZERO_ROW]).all() and \
        (got[ZERO_ROW] <= 1.1e-4).all()
    # the exponent-bits log10 and the Padé tanh stay near the exact ones
    exact = _port_ct3(n)
    live = np.arange(B) != ZERO_ROW
    assert np.abs(got - exact)[live].max() <= 3e-4


@pytest.mark.parametrize("stage2", ["highest", "x3"])
@pytest.mark.parametrize("n", K11_SIZES)
def test_k11_mag2_matches_jax(n, stage2):
    """``ep="none"`` returns |X|^2 in natural bin order: 1e-5 of each
    row's max; exactly 0 on the zero row."""
    ref = _jax_ct3(n, stage2=stage2, ep="none")
    got = _port_ct3(n, stage2=stage2, ep="none")
    assert got.shape == ref.shape and got.dtype == np.float32
    live = np.arange(B) != ZERO_ROW
    assert max(_rel_to_row_max(g, r) for g, r in
               zip(got[live], ref[live])) <= 1e-5
    assert (got[ZERO_ROW] == 0.0).all() and (ref[ZERO_ROW] == 0.0).all()
    assert (np.argmax(got[live], -1) == np.argmax(ref[live], -1)).all()


@pytest.mark.parametrize("ep", ["exact", "none"])
@pytest.mark.parametrize("skip", [("s1",), ("tw",), ("s2",), ("tw", "s2"),
                                  ("s1", "tw", "s2")])
@pytest.mark.parametrize("n", K11_SIZES)
def test_k11_skip_flags_match_jax(n, skip, ep):
    """Each ablation flag, with JAX's float32 stage: its display output
    at 2e-4, its |X|^2 at 1e-5 of the row max, in natural bin order."""
    kw = dict(stage2="highest", skip=skip, ep=ep)
    ref = _jax_ct3(n, **kw)
    got = _port_ct3(n, **kw)
    if ep == "none":
        live = np.arange(B) != ZERO_ROW
        assert max(_rel_to_row_max(g, r) for g, r in
                   zip(got[live], ref[live])) <= 1e-5
        assert (got[ZERO_ROW] == 0.0).all()
    else:
        _held(got, ref, 2e-4)
    assert not np.array_equal(got, _port_ct3(n, stage2="highest", ep=ep))


@pytest.mark.parametrize("batches,n,kb,tile_b,honoured", [
    (16, 2048, 2, 256, False),     # kb = 2 stands: JAX ignores "s1"
    (24, 2048, 2, 16, False),      # tile 16 -> 8 divides 24: kb = 2
    (12, 2048, 2, 256, True),      # tile 12 is not a multiple of 8
    (16, 384, 2, 256, True),       # m = 3: kb does not divide it
    (16, 2048, 1, 256, True)])
def test_k11_takes_s1_where_jax_does(batches, n, kb, tile_b, honoured):
    """JAX honours "s1" only at an effective kb of 1; the port follows
    its arithmetic, and both agree on the output."""
    kw = dict(stage2="highest", kb=kb, tile_b=tile_b, skip=("s1",))
    ref = _jax_ct3(n, batches, **kw)
    got = _port_ct3(n, batches, **kw)
    _held(got, ref, 2e-4)
    full = _port_ct3(n, batches, stage2="highest")
    assert np.array_equal(got, full) != honoured
    _, flags = tk.ct3_modes(batches, n, kb, "exact", ("s1",), tile_b)
    assert ("s1" in flags) == honoured


@pytest.mark.parametrize("ep,skip,want", [
    ("exact", (), ("exact", set())),
    ("approx", ("tw",), ("approx", {"tw"})),
    ("none", ("s2", "s1"), ("none", {"s1", "s2"})),
    ("fast", ("s3", "tw"), ("exact", {"tw"})),       # unknown: ignored
    ("exact", "s1,s2", ("exact", {"s1", "s2"}))])    # by `in`, as JAX
def test_ct3_modes_reads_ep_and_skip_as_jax(ep, skip, want):
    got = tk.ct3_modes(16, 384, 1, ep, skip)
    assert (got[0], set(got[1])) == want


@pytest.mark.parametrize("kb,tile_b", [(0, 256), (1, 0), (-2, 256)])
def test_ct3_rejects_tiles_jax_cannot_take(kb, tile_b):
    _, targs = _args(384)
    with pytest.raises(ValueError, match="kb and tile_b"):
        tk.spectrum_fused_ct3(torch.zeros((2, 384, 2)), *targs, kb=kb,
                              tile_b=tile_b)


def test_atanh_pade_is_the_clamped_pade_tanh():
    """The reciprocal-and-Newton form is the divided Padé form to ~1 ulp,
    within 2.6e-4 of tanh, saturating at the clamp."""
    x = torch.linspace(-20.0, 20.0, 40001)
    got = tk._atanh_pade(x)
    assert float((got - fastmath.approx_tanh(x)).abs().max()) <= 2e-7
    assert float((got.double() - torch.tanh(x.double())).abs().max()) \
        <= 2.6e-4
    assert torch.equal(got, -tk._atanh_pade(-x))
    assert float(got[0]) == float(tk._atanh_pade(torch.tensor([-4.5]))[0])


# -- the wrappers on the CPU -------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("spectrum_fused_ct", {}), ("spectrum_fused_ct", {"exact": False}),
    ("spectrum_fused_ct3", {"ep": "approx", "skip": ("tw",)})])
def test_ct_wrappers_on_cpu_run_plain_without_counting(name, kw):
    _, targs = _args(384)
    x = torch.from_numpy(_input(384).copy())
    kernel = getattr(tk, name)
    before = kernel.launches
    got = kernel(x, *targs, **kw)
    assert torch.equal(got, getattr(tk, name + "_plain")(x, *targs, **kw))
    assert kernel.launches == before


@pytest.mark.parametrize("name", ["spectrum_fused_ct", "spectrum_fused_ct3"])
@pytest.mark.parametrize("bad", ["rank", "pairs", "dtype", "win",
                                 "win_dtype", "rows", "size"])
def test_ct_wrappers_reject_bad_arguments(name, bad):
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
        iq, win = torch.zeros((B, 4224, 2)), torch.zeros(4224)
    with pytest.raises(ValueError):
        getattr(tk, name)(iq, win, 0.0, 1.0, 0.0)


# -- K3's display tier -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("shape", [(8, 128), (8, 512), (4, 2048),
                                   (2, 3, 256)])
def test_fft_pallas_display_tier_matches_jax(shape):
    x = _cplx(shape, seed=shape[-1])
    ref = np.asarray(jk.fft_pallas(jnp.asarray(x), interpret=True,
                                   exact=False))
    before = tk.fft_pallas.launches
    got = tk.fft_pallas(torch.from_numpy(x), exact=False).numpy()
    assert tk.fft_pallas.launches == before
    assert got.shape == shape and got.dtype == np.complex64
    truth = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel_to_row_max(got, ref) <= 1e-5
    assert _rel_to_row_max(got, truth) <= 1e-5
    np.testing.assert_array_equal(
        got, tk.fft_pallas(torch.from_numpy(x)).numpy())


# -- step_kernel with JAX's keywords -------------------------------------------

def _spy(monkeypatch):
    """Record which fused spectrum wrapper each call reaches, and with
    which keywords."""
    calls = []
    for name in ("spectrum_fused_ct", "spectrum_fused_ct3",
                 "spectrum_fused_ct4", "spectrum_fused_ct5",
                 "spectrum_fused"):
        real = getattr(tk, name)
        monkeypatch.setattr(
            tk, name, lambda *a, _real=real, _name=name, **kw:
            calls.append((_name, kw)) or _real(*a, **kw))
    return calls


@pytest.mark.parametrize("n,kw,kernel", [
    (384, {"version": "ct1"}, ("spectrum_fused_ct", {"exact": True})),
    (2048, {"version": "ct1", "exact": False},
     ("spectrum_fused_ct", {"exact": False})),
    (2048, {"exact": False}, ("spectrum_fused_ct5", {})),
    (2048, {"stage2": "x4"}, ("spectrum_fused_ct5", {})),
    (2048, {"version": "ct4", "stage2": "highest", "kb": 4},
     ("spectrum_fused_ct4", {})),
    (384, {"exact": False, "kb": 3}, ("spectrum_fused_ct4", {})),
    (384, {"stage2": "cpack5"}, ("spectrum_fused_ct4", {})),
    (128, {"version": "ct1", "stage2": "x4", "kb": 1},
     ("spectrum_fused_ct", {"exact": True}))])
def test_step_kernel_takes_jax_keywords(n, kw, kernel, monkeypatch):
    """Each keyword of JAX's ``step_pallas_ct`` is taken; the route is
    JAX's, every tier runs the fp32 kernel, and the output agrees with
    JAX's on the same keywords (1e-3 where JAX splits to bf16)."""
    j, t = _pair(n)
    iq = _input(n)
    calls = _spy(monkeypatch)
    got = t.step_kernel(torch.from_numpy(iq.copy()), **kw).numpy()
    assert calls == [kernel]
    ref = np.asarray(j.step_pallas_ct(jnp.asarray(iq), interpret=True,
                                      **kw))
    bf16 = kw.get("stage2") in BF16_STAGES
    _held(got, ref, 1e-3 if bf16 else 2e-4)
    plain = t.step_kernel(torch.from_numpy(iq.copy()),
                          version=kw.get("version", "ct5"))
    np.testing.assert_array_equal(got, plain.numpy())


def test_step_kernel_ct1_takes_a_window_and_a_strided_iq():
    """A window passed in replaces the installed one, as in JAX; a
    strided iq is made contiguous for the kernel."""
    j, t = _pair(384)
    iq = _input(384)
    w = np.asarray(j._win) * np.float32(0.5)
    ref = np.asarray(j.step_pallas_ct(jnp.asarray(iq), interpret=True,
                                      version="ct1", win=w))
    wide = torch.from_numpy(np.concatenate([iq, iq], axis=-1))
    strided = wide[..., :2]
    assert not strided.is_contiguous()
    got = t.step_kernel(strided, win=torch.from_numpy(w), version="ct1")
    _held(got.numpy(), ref, 2e-4)
