"""The port's WBFM receiver slice against the JAX package, on the CPU:
``ops/firs.py``, the K4/K12 plain versions in ``ops/kernels.py``,
``models/wbfm.py``, the ``wbfm`` block and ``convert.py``.  JAX's Pallas
kernels run in interpret mode.

Tolerances, and why:
- the streaming FIRs: 1e-5 of JAX's (the same float32 sums in another
  order);
- ``step`` vs JAX ``step``: 1e-4, after the FIR warm-up (with zero
  history the first outputs are ~1e-20 and atan2's branch flips on
  rounding noise: ``tests/models/test_models.py:241-243``);
- K4/K12 plain vs JAX with the exact reciprocal (``fast3=False``, v1):
  1e-4.  Against the JAX default (``fast3=True``) 5e-3 on demod and 1e-3
  on audio (the JAX test's bar, ``test_pallas_kernels.py:162-165``): in
  interpret mode ``pl.reciprocal(approx=True)`` is a bf16 divide, and
  the port uses a true fp32 division;
- coherent vs a float64 truth: 1e-4; vs the JAX default: 5e-3;
- a stream split in two vs whole: 1e-5; carried history: exact.
"""

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

import jax.numpy as jnp

import cyberether_tpu as jpkg
import cyberether_tpu_torch as tpkg
from cyberether_tpu.models.wbfm import WbfmReceiver as JaxWbfm
from cyberether_tpu.ops import firs as jfirs
from cyberether_tpu.ops import pallas_kernels as jk
from cyberether_tpu_torch import convert
from cyberether_tpu_torch.blocks.fused import WbfmFusedModule
from cyberether_tpu_torch.core.tensor import TensorSpec
from cyberether_tpu_torch.core.types import DataType, Device, ValidationError
from cyberether_tpu_torch.models.wbfm import WbfmReceiver
from cyberether_tpu_torch.ops import firs as tfirs
from cyberether_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

N = 128 * 40 * 4                     # rows of 128, decim 40


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(**kw):
    j = JaxWbfm(**kw)
    t = WbfmReceiver(device="cpu", **kw)
    t.load_taps(convert.wbfm_taps_from_arrays(
        {"taps": np.asarray(j._taps), "ref": j._ref}, device="cpu"))
    return j, t


def _hist(seed, K=128):
    """A history that continues a real signal: the tail of another
    synthetic input (non-zero, on the FM carrier's scale)."""
    iq = JaxWbfm().make_input(K + 128, seed=seed)
    return np.ascontiguousarray(iq[-K:].T)


def _truth(iq, h, hist, gain, D=0):
    """float64 FIR over [0 | hist | x] + lag-1 discriminator."""
    ext = np.concatenate([np.zeros((2, 1)), hist, iq.T], -1)
    y = lfilter(h.astype(np.float64), [1.0], ext, axis=-1)[:, h.size - 1:]
    p, c = y[:, :-1], y[:, 1:]
    dr = p[0] * c[0] + p[1] * c[1]
    di = p[0] * c[1] - p[1] * c[0]
    if D:
        m = dr.size // D
        dr = dr[:m * D].reshape(m, D).mean(1)
        di = di[:m * D].reshape(m, D).mean(1)
    return np.arctan2(di, dr) * gain


# -- ops/firs.py ---------------------------------------------------------------

@pytest.mark.parametrize("taps,centers", [(129, [0.0]), (33, [0.0, 3e5]),
                                          (1, [1e5])])
def test_windowed_sinc_bandpass_matches_jax(taps, centers):
    np.testing.assert_array_equal(
        tfirs.windowed_sinc_bandpass(taps, 2e6, 2e5, centers),
        jfirs.windowed_sinc_bandpass(taps, 2e6, 2e5, centers))


def _fir_case(kind, seed):
    rng = np.random.default_rng(seed)
    h = (np.hamming(33) / np.hamming(33).sum()).astype(np.float32)
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    hist = rng.standard_normal((2, 32)).astype(np.float32)
    if kind == "complex_x":
        x = (x[0] + 1j * x[1]).astype(np.complex64)[None]
        hist = (hist[0] + 1j * hist[1]).astype(np.complex64)[None]
    elif kind == "complex_taps":
        h = tfirs.windowed_sinc_bandpass(33, 2e6, 2e5, [3e5])[0]
    elif kind == "short":
        x = x[:, :20]
    return x, h, hist


@pytest.mark.parametrize("fn,kind", [
    (fn, kind)
    for fn in ("fir_filter_streaming", "fir_matmul_streaming",
               "fir_fft_streaming")
    for kind in ("real", "complex_x", "short")] + [
    ("fir_filter_streaming", "complex_taps")])   # the others take real taps
def test_streaming_firs_match_jax(fn, kind):
    x, h, hist = _fir_case(kind, seed=len(fn) + len(kind))
    kw = {"fft_size": 256} if fn == "fir_fft_streaming" else {}
    ry, rh = getattr(jfirs, fn)(jnp.asarray(x), jnp.asarray(h),
                                jnp.asarray(hist), **kw)
    gy, gh = getattr(tfirs, fn)(_t(x), _t(h), _t(hist), **kw)
    assert gy.shape == ry.shape and gy.dtype == torch.from_numpy(
        np.asarray(ry)).dtype
    assert np.abs(gy.numpy() - np.asarray(ry)).max() <= 1e-5
    np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))


def test_fir_filter_streaming_along_another_axis():
    rng = np.random.default_rng(3)
    h = rng.standard_normal(9).astype(np.float32)
    x = rng.standard_normal((100, 3)).astype(np.float32)
    hist = rng.standard_normal((8, 3)).astype(np.float32)
    ry, rh = jfirs.fir_filter_streaming(jnp.asarray(x), jnp.asarray(h),
                                        jnp.asarray(hist), axis=0)
    gy, gh = tfirs.fir_filter_streaming(_t(x), _t(h), _t(hist), axis=0)
    assert np.abs(gy.numpy() - np.asarray(ry)).max() <= 1e-5
    np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))


# -- models/wbfm.py: tables, inputs, the XLA step ---------------------------------

def test_taps_gain_and_input_match_jax():
    j = JaxWbfm()
    t = WbfmReceiver(device="cpu")
    np.testing.assert_array_equal(t._taps.numpy(), np.asarray(j._taps))
    assert t._ref == float(j._ref)
    np.testing.assert_array_equal(t.make_input(4096, seed=5),
                                  j.make_input(4096, seed=5))
    on = t.make_input(4096, seed=5, device="cpu")
    assert isinstance(on, torch.Tensor)
    np.testing.assert_array_equal(on.numpy(), j.make_input(4096, seed=5))
    st = t.init_state()
    assert st["fir_hist"].shape == (2, 128) and st["prev"].shape == (2,)


@pytest.mark.parametrize("impl", ["conv", "matmul", "fft"])
@pytest.mark.parametrize("fast", [True, False])
def test_step_matches_jax_step(impl, fast):
    j, t = _pair(fir_impl=impl, fast_atan2=fast)
    iq = j.make_input(N, seed=1)
    ref, rst = j.step(j.init_state(), jnp.asarray(iq))
    got, gst = t.step(t.init_state(), _t(iq))
    warm = -(-t.taps // t.audio_decim)
    assert got.shape == (N // 40,)
    assert np.abs(got.numpy()[warm:] - np.asarray(ref)[warm:]).max() <= 1e-4
    np.testing.assert_array_equal(gst["fir_hist"].numpy(),
                                  np.asarray(rst["fir_hist"]))
    assert np.abs(gst["prev"].numpy() - np.asarray(rst["prev"])).max() \
        <= 1e-5
    # from a carried state no warm-up is skipped
    st = {"fir_hist": _hist(2), "prev": np.asarray(rst["prev"])}
    ref2, _ = j.step({k: jnp.asarray(v) for k, v in st.items()},
                     jnp.asarray(iq))
    got2, _ = t.step(convert.wbfm_state_from_arrays(st, device="cpu"),
                     _t(iq))
    assert np.abs(got2.numpy() - np.asarray(ref2)).max() <= 1e-4


def test_step_recovers_the_tone():
    t = WbfmReceiver(device="cpu", fir_impl="conv")
    audio, _ = t.step(t.init_state(), _t(t.make_input(40 * 2048)))
    a = audio.numpy()
    spec = np.abs(np.fft.rfft(a - a.mean()))
    freqs = np.fft.rfftfreq(a.size, 1.0 / (2e6 / 40))
    assert abs(freqs[np.argmax(spec)] - 1000.0) < 50.0


# -- K4 / K12 plain versions ---------------------------------------------------

@pytest.mark.parametrize("hist_seed", [None, 7])
def test_plain_k4_matches_jax(hist_seed):
    j, t = _pair()
    iq = j.make_input(N, seed=3)
    hist = np.zeros((2, 128), np.float32) if hist_seed is None \
        else _hist(hist_seed)
    args = (jnp.asarray(iq), j._taps, jnp.asarray(hist), j._ref)
    exact = np.asarray(jk.wbfm_fused_v2(*args, interpret=True, fast3=False))
    default = np.asarray(jk.wbfm_fused_v2(*args, interpret=True))
    got = tk.wbfm_fused_v2_plain(_t(iq), t._taps, _t(hist), t._ref).numpy()
    assert got.shape == (N,)
    assert np.abs(got - exact).max() <= 1e-4
    assert np.abs(got - default).max() <= 5e-3
    dec = got.reshape(-1, 40).mean(1)
    assert np.abs(dec - default.reshape(-1, 40).mean(1)).max() <= 1e-3
    # after a zero history the first filtered samples are ~1e-20 and
    # nearly anti-parallel: their angle's sign is rounding noise (+/-pi)
    skip = t.taps if hist_seed is None else 0
    truth = _truth(iq, np.asarray(j._taps), hist, t._ref)
    assert np.abs(got - truth)[skip:].max() <= 1e-4


@pytest.mark.parametrize("D,n", [(40, 128 * 200 * 5), (6, 128 * 100)])
def test_plain_k4_coherent(D, n):
    """D=40 over several of JAX's group chunks; D=6 with n % D != 0
    (the partial last group gives no output, as in JAX)."""
    j, t = _pair(audio_decim=D)
    iq = j.make_input(n, seed=4)
    hist = _hist(8)
    ref = np.asarray(jk.wbfm_fused_v2(
        jnp.asarray(iq), j._taps, jnp.asarray(hist), j._ref,
        interpret=True, coherent_decim=D))
    got = tk.wbfm_fused_v2_plain(_t(iq), t._taps, _t(hist), t._ref,
                                 coherent_decim=D).numpy()
    assert got.shape == ref.shape == (n // D,)
    truth = _truth(iq, np.asarray(j._taps), hist, t._ref, D)
    assert np.abs(got - truth).max() <= 1e-4
    assert np.abs(got - ref).max() <= 5e-3


def test_plain_k12_matches_jax():
    j, t = _pair()
    iq = j.make_input(N, seed=5)
    hist = _hist(9)
    x = np.ascontiguousarray(iq.T)
    ref = np.asarray(jk.wbfm_fused(jnp.asarray(x), j._taps,
                                   jnp.asarray(hist), j._ref,
                                   interpret=True))
    got = tk.wbfm_fused_plain(_t(x), t._taps, _t(hist), t._ref).numpy()
    assert np.abs(got - ref).max() <= 1e-4
    assert np.abs(got - _truth(iq, np.asarray(j._taps), hist,
                               t._ref)).max() <= 1e-4


@pytest.mark.parametrize("kernel", ["v1", "v2", "v2_coherent"])
def test_nonzero_last_tap_vs_lfilter(kernel):
    """Mirror of the JAX test: random taps with h[T-1] != 0, so the
    sample before the history (which counts as zero) matters."""
    rng = np.random.default_rng(13)
    T = 129
    h = rng.standard_normal(T).astype(np.float32) * 0.1
    assert h[-1] != 0.0
    n = 128 * 8
    iq = rng.standard_normal((n, 2)).astype(np.float32)
    hist = rng.standard_normal((2, T - 1)).astype(np.float32)
    gain = 1.7
    if kernel == "v1":
        got = tk.wbfm_fused(_t(iq.T), _t(h), _t(hist), gain)
        jref = jk.wbfm_fused(jnp.asarray(iq.T), jnp.asarray(h),
                             jnp.asarray(hist), gain, interpret=True)
        assert np.abs(got.numpy() - np.asarray(jref)).max() <= 1e-4
    else:
        D = 8 if kernel == "v2_coherent" else 0
        got = tk.wbfm_fused_v2(_t(iq), _t(h), _t(hist), gain,
                               coherent_decim=D)
    truth = _truth(iq, h, hist, gain, 8 if kernel == "v2_coherent" else 0)
    assert np.abs(got.numpy() - truth).max() <= 1e-4


@pytest.mark.parametrize("D", [0, 40])
def test_plain_k4_streams(D):
    j, t = _pair()
    iq = _t(j.make_input(2 * N, seed=12))
    hist = torch.zeros((2, 128))
    whole = tk.wbfm_fused_v2_plain(iq, t._taps, hist, t._ref, D)
    a1 = tk.wbfm_fused_v2_plain(iq[:N], t._taps, hist, t._ref, D)
    a2 = tk.wbfm_fused_v2_plain(iq[N:], t._taps, iq[N - 128:N].T, t._ref, D)
    assert (torch.cat([a1, a2]) - whole).abs().max() <= 1e-5


def test_wrapper_on_cpu_runs_plain_without_counting():
    _, t = _pair()
    iq = _t(t.make_input(1280, seed=2))
    hist = torch.zeros((2, 128))
    b4, b12 = tk.wbfm_fused_v2.launches, tk.wbfm_fused.launches
    for D in (0, 40):
        assert torch.equal(tk.wbfm_fused_v2(iq, t._taps, hist, t._ref, D),
                           tk.wbfm_fused_v2_plain(iq, t._taps, hist,
                                                  t._ref, D))
    assert torch.equal(tk.wbfm_fused(iq.T, t._taps, hist, t._ref),
                       tk.wbfm_fused_plain(iq.T, t._taps, hist, t._ref))
    assert (tk.wbfm_fused_v2.launches, tk.wbfm_fused.launches) == (b4, b12)


@pytest.mark.parametrize("bad", ["n", "shape", "dtype", "taps", "hist",
                                 "coherent"])
def test_wrapper_rejects_bad_arguments(bad):
    _, t = _pair()
    iq = _t(t.make_input(1280))
    taps, hist, D = t._taps, torch.zeros((2, 128)), 0
    if bad == "n":
        iq = iq[:1000]
    elif bad == "shape":
        iq = iq.reshape(640, 4)
    elif bad == "dtype":
        iq = iq.double()
    elif bad == "taps":
        taps = torch.zeros(130)
    elif bad == "hist":
        hist = torch.zeros((2, 127))
    else:
        D = 250                     # lcm(250, 128) / 128 = 125 rows
    with pytest.raises((ValueError, TypeError)):
        tk.wbfm_fused_v2(iq, taps, hist, 1.0, D)
    if bad == "coherent":           # the JAX kernel refuses it as well
        with pytest.raises(ValueError, match="selector table"):
            jk.wbfm_fused_v2(jnp.asarray(iq.numpy()), jnp.asarray(
                taps.numpy()), jnp.asarray(hist.numpy()), 1.0,
                interpret=True, coherent_decim=D)


# -- step_kernel: the production path -----------------------------------------

@pytest.mark.parametrize("version,mode", [("v2", "classic"),
                                          ("v2", "coherent"),
                                          ("v1", "classic")])
def test_step_kernel_matches_step_pallas(version, mode):
    j, t = _pair()
    iq = j.make_input(2 * N, seed=6)
    jst, tst = j.init_state(), t.init_state()
    # the first step starts from a zero history: skip the FIR warm-up
    # (see test_step_matches_jax_step); the second carries real state
    for half, warm in ((iq[:N], -(-t.taps // 40)), (iq[N:], 0)):
        ref, jst = j.step_pallas(jst, jnp.asarray(half), interpret=True,
                                 version=version, demod_mode=mode)
        got, tst = t.step_kernel(tst, _t(half), version=version,
                                 demod_mode=mode)
        tol = 1e-4 if version == "v1" else 5e-3 if mode == "coherent" \
            else 1e-3
        assert got.shape == (N // 40,)
        assert np.abs(got.numpy() - np.asarray(ref))[warm:].max() <= tol
        np.testing.assert_array_equal(tst["fir_hist"].numpy(),
                                      np.asarray(jst["fir_hist"]))
        assert np.abs(tst["prev"].numpy() - np.asarray(jst["prev"])).max() \
            <= 1e-5


@pytest.mark.parametrize("mode", ["classic", "coherent"])
def test_step_kernel_streams(mode):
    _, t = _pair()
    iq = _t(t.make_input(2 * N, seed=12))
    whole, wst = t.step_kernel(t.init_state(), iq, demod_mode=mode)
    a1, st = t.step_kernel(t.init_state(), iq[:N], demod_mode=mode)
    a2, st = t.step_kernel(st, iq[N:], demod_mode=mode)
    assert (torch.cat([a1, a2]) - whole).abs().max() <= 1e-5
    assert torch.equal(st["fir_hist"], wst["fir_hist"])
    assert (st["prev"] - wst["prev"]).abs().max() <= 1e-6


@pytest.mark.parametrize("kw", [{"version": "v3"}, {"demod_mode": "approx"},
                                {"version": "v1", "demod_mode": "coherent"}])
def test_step_kernel_rejects_bad_options(kw):
    _, t = _pair()
    with pytest.raises(ValueError):
        t.step_kernel(t.init_state(), torch.zeros((1280, 2)), **kw)


def test_step_kernel_rejects_ragged_input():
    _, t = _pair()
    with pytest.raises(ValueError):
        t.step_kernel(t.init_state(), torch.zeros((1300, 2)))


def test_convert_taps_and_state_from_jax():
    j = JaxWbfm(taps=65, deviation=5e4)
    t = WbfmReceiver(taps=65, device="cpu")           # another gain
    t.load_taps(convert.wbfm_taps_from_arrays(
        {"taps": np.asarray(j._taps), "ref": j._ref}, device="cpu"))
    assert t._ref == float(j._ref)
    iq = j.make_input(2 * N, seed=9)
    _, jst = j.step_pallas(j.init_state(), jnp.asarray(iq[:N]),
                           interpret=True)
    st = convert.wbfm_state_from_arrays(
        {k: np.asarray(v) for k, v in jst.items()}, device="cpu")
    assert st["fir_hist"].shape == (2, 64) and st["prev"].shape == (2,)
    ref = np.asarray(jk.wbfm_fused_v2(
        jnp.asarray(iq[N:]), j._taps, jst["fir_hist"], j._ref,
        interpret=True, fast3=False)).reshape(-1, 40).mean(1)
    got, _ = t.step_kernel(st, _t(iq[N:]))
    assert np.abs(got.numpy() - ref).max() <= 1e-4
    with pytest.raises(ValueError):
        convert.wbfm_state_from_arrays({"fir_hist": np.zeros((3, 64)),
                                        "prev": np.zeros(2)}, device="cpu")
    with pytest.raises(ValueError):
        t.load_taps({"taps": np.zeros(64, np.float32), "ref": 1.0})


# -- the dti -> wbfm flowgraph -------------------------------------------------

def _buffers(seeds, n=N):
    rx = JaxWbfm()
    return [(lambda iq: (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64))(
        rx.make_input(n, seed=s)) for s in seeds]


def _flowgraph(pkg, config=None, n=N, dtype="CF32"):
    fg = pkg.Flowgraph(default_device="cpu") if pkg is tpkg \
        else pkg.Flowgraph()
    shape = [n] if dtype == "CF32" else [n, 2]
    fg.block_create("src", "dti", {"shape": shape, "dataType": dtype})
    fg.block_create("rx", "wbfm", config or {},
                    {"buffer": "${graph.src.output.buffer}"},
                    provider="pallas")
    return fg


def _run(fg, bufs):
    outs = []
    try:
        for b in bufs:
            fg.records["src"].build.modules["src/m"].attach_buffer(b)
            assert fg.compute(timeout=30.0)
            assert fg.scheduler.output_valid("rx.audio")
            outs.append(np.asarray(fg.scheduler.output("rx.audio")))
    finally:
        fg.stop()
    return outs


@pytest.mark.parametrize("mode", ["classic", "coherent"])
def test_flowgraph_matches_jax_step_pallas_chain(mode):
    bufs = _buffers([1, 2, 3])
    got = _run(_flowgraph(tpkg, {"demodMode": mode}), bufs)
    j = JaxWbfm()
    st = j.init_state()
    # the first cycle starts from a zero history: skip the FIR warm-up
    for g, b, warm in zip(got, bufs, (-(-j.taps // 40), 0, 0)):
        iq = np.stack([b.real, b.imag], -1).astype(np.float32)
        if mode == "classic":        # JAX's kernel with the exact divide
            exact = np.asarray(jk.wbfm_fused_v2(
                jnp.asarray(iq), j._taps, st["fir_hist"], j._ref,
                interpret=True, fast3=False)).reshape(-1, 40).mean(1)
            assert np.abs(g - exact)[warm:].max() <= 1e-4
        ref, st = j.step_pallas(st, jnp.asarray(iq), interpret=True,
                                demod_mode=mode)
        assert g.shape == (N // 40,) and np.isfinite(g).all()
        assert np.abs(g - np.asarray(ref))[warm:].max() <= \
            (1e-3 if mode == "classic" else 5e-3)


def test_flowgraph_matches_jax_flowgraph_and_f32_input():
    bufs = _buffers([4])
    got = _run(_flowgraph(tpkg), bufs)[0]
    ref = _run(_flowgraph(jpkg), bufs)[0]
    warm = -(-129 // 40)             # zero history: skip the FIR warm-up
    assert np.abs(got - ref)[warm:].max() <= 1e-3
    pairs = np.stack([bufs[0].real, bufs[0].imag], -1).astype(np.float32)
    f32 = _run(_flowgraph(tpkg, dtype="F32"), [pairs])[0]
    np.testing.assert_array_equal(f32, got)
    fg = _flowgraph(tpkg)
    audio = fg.block_module("rx").output_specs["audio"]
    assert audio.shape == (N // 40,)
    assert audio.attributes["sampleRate"] == 2e6 / 40
    fg.stop()


@pytest.mark.parametrize("shape,dtype,config", [
    ((N, 3), DataType.F32, {}),                       # not (n, 2)
    ((N + 40,), DataType.CF32, {}),                   # n % 128
    ((128 * 41,), DataType.CF32, {}),                 # n % audioDecim
    ((N,), DataType.CF32, {"taps": 1}),
    ((N,), DataType.CF32, {"taps": 130}),
    ((N,), DataType.CF32, {"demodMode": "sideways"}),
    ((128 * 250,), DataType.CF32, {"demodMode": "coherent",
                                   "audioDecim": 250}),   # 125 rows
])
def test_block_validation_errors(shape, dtype, config):
    spec = {"buffer": TensorSpec(shape, dtype)}
    with pytest.raises(ValidationError):
        WbfmFusedModule("rx/m", config, spec, device=Device.CPU)


def test_bad_block_config_errors_the_block():
    fg = _flowgraph(tpkg, {"taps": 200})
    assert fg.block_state("rx").value == "errored"
    assert "taps" in fg.block_error("rx")
    assert fg.block_state("src").value == "complete"
    fg.stop()
