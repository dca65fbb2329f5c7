"""The port's fft slice against the JAX package, on the CPU:
``ops/fftops.py``, the K3 plain version in ``ops/kernels.py``, and the
``fft`` block's providers ``generic``, ``pallas`` and ``mxu``.  JAX's
Pallas kernel runs in interpret mode.

Tolerances, and why:
- every transform against its JAX counterpart and against a float64
  numpy truth: 1e-5 of max|X| (both are float32 FFTs, ~1e-7 of max|X|
  from the truth; 1e-5 is the JAX tests' bar for ``fft_pallas``,
  ``tests/models/test_pallas_kernels.py:394-413``);
- r2r against ``scipy.fftpack``: 1e-3, the JAX test's bar
  (``tests/blocks/test_dsp_ops.py:80-89``);
- the unnormalized round trips: n x within 1e-2, the reference's bar
  (``test_dsp_ops.py:60-67``, ``test_pallas_kernels.py:416-430``).
"""

import functools

import numpy as np
import pytest
import scipy.fftpack
import torch

import jax.numpy as jnp

import cyberether_tpu_torch as tpkg
from cyberether_tpu.blocks import dsp as jdsp
from cyberether_tpu.core.tensor import TensorSpec as JaxSpec
from cyberether_tpu.core.types import DataType as JaxDataType
from cyberether_tpu.ops import fftops as jfft
from cyberether_tpu.ops import pallas_kernels as jk
from cyberether_tpu.testing import TestContext, default_axes
from cyberether_tpu_torch.blocks import dsp as tdsp
from cyberether_tpu_torch.core.registry import registry
from cyberether_tpu_torch.core.tensor import SignalAxes, TensorSpec, spec_of
from cyberether_tpu_torch.core.types import DataType, Device, GraphError, \
    ValidationError
from cyberether_tpu_torch.ops import fftops as tfft
from cyberether_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

REL = 1e-5


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _axes(arr, axes=None):
    """The port's SignalAxes for ``arr``: ``axes`` or the JAX test
    harness's default (rank 1: sample; rank 2: batch, sample)."""
    a = axes or default_axes(arr)
    return SignalAxes(sample=a.sample, batch=a.batch, channel=a.channel)


def _port_module(module_type, config, inputs, provider="generic",
                 axes=None):
    """Build the port's module on the CPU and run it once: (module,
    outputs as numpy)."""
    cls = registry.build_module(module_type, "cpu", "torch", provider)
    specs = {p: spec_of(a, axes=_axes(a, axes), device=Device.CPU)
             for p, a in inputs.items()}
    mod = cls("test/m", config, specs, device=Device.CPU)
    outs, _ = mod.apply({p: torch.from_numpy(np.ascontiguousarray(a))
                         for p, a in inputs.items()}, mod.init_state())
    return mod, {p: v.numpy() for p, v in outs.items()}


def _jax_module(module_type, config, inputs, provider="generic",
                axes=None):
    ctx = TestContext(module_type, config, provider=provider)
    for p, a in inputs.items():
        ctx.set_input(p, a, axes=axes)
    return ctx.run()


def _both(module_type, config, inputs, provider="generic", axes=None):
    """(port output, JAX output) of the ``signal`` port.  ``axes`` is a
    JAX SignalAxes; the port gets the same."""
    _, outs = _port_module(module_type, config, inputs, provider,
                           axes=axes)
    ctx = _jax_module(module_type, config, inputs, provider, axes=axes)
    return outs["signal"], ctx.output("signal")


# -- ops/fftops.py -------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 63, 256, 255])
@pytest.mark.parametrize("axis", [-1, 0])
def test_fftops_match_jax(n, axis):
    rng = np.random.default_rng(n)
    shape = (3, n) if axis == -1 else (n, 3)
    xc = _cplx(rng, shape)
    xr = rng.standard_normal(shape).astype(np.float32)
    ax = -1 if axis == -1 else 0
    x64 = xc.astype(np.complex128)
    cases = [
        (tfft.fft_c2c(torch.from_numpy(xc), ax, True),
         jfft.fft_c2c(jnp.asarray(xc), ax, True), np.fft.fft(x64, axis=ax)),
        (tfft.fft_c2c(torch.from_numpy(xc), ax, False),
         jfft.fft_c2c(jnp.asarray(xc), ax, False),
         np.fft.ifft(x64, axis=ax) * n),
        (tfft.fft_r2c(torch.from_numpy(xr), ax),
         jfft.fft_r2c(jnp.asarray(xr), ax),
         np.fft.rfft(xr.astype(np.float64), axis=ax)),
        (tfft.fft_r2r_fftpack(torch.from_numpy(xr), ax, True),
         jfft.fft_r2r_fftpack(jnp.asarray(xr), ax, True),
         scipy.fftpack.rfft(xr.astype(np.float64), axis=ax)),
        (tfft.fft_r2r_fftpack(torch.from_numpy(xr), ax, False),
         jfft.fft_r2r_fftpack(jnp.asarray(xr), ax, False),
         scipy.fftpack.irfft(xr.astype(np.float64), axis=ax) * n),
    ]
    for got, ref, truth in cases:
        got, ref = got.numpy(), np.asarray(ref)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _rel(got, ref) <= REL
        assert _rel(got, truth) <= REL


@pytest.mark.parametrize("n", [8, 9])
def test_fftpack_packing_matches_jax(n):
    rng = np.random.default_rng(1)
    spec = _cplx(rng, (2, n // 2 + 1))
    packed = tfft._pack_fftpack(torch.from_numpy(spec), n, -1).numpy()
    np.testing.assert_array_equal(
        packed, np.asarray(jfft._pack_fftpack(jnp.asarray(spec), n, -1)))
    back = tfft._unpack_fftpack(torch.from_numpy(packed), -1).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jfft._unpack_fftpack(jnp.asarray(packed), -1)))
    # the round trip keeps every bin FFTPACK stores (the imaginary parts
    # of bin 0, and of bin n/2 for even n, are not stored)
    keep = spec.copy()
    keep[:, 0] = keep[:, 0].real
    if n % 2 == 0:
        keep[:, -1] = keep[:, -1].real
    np.testing.assert_array_equal(back, keep)


# -- FftModule (provider generic), as tests/blocks/test_dsp_ops.py ------------

def test_fft_c2c_forward_dc_bin():
    x = np.ones(128, np.complex64)
    got, ref = _both("fft", {"forward": True}, {"signal": x})
    assert abs(got[0] - 128.0) < 1e-3
    np.testing.assert_allclose(np.abs(got[1:]), 0, atol=1e-3)
    assert _rel(got, ref) <= REL


def test_fft_c2c_known_sinusoid():
    n, k = 256, 16
    x = np.exp(2j * np.pi * k * np.arange(n) / n).astype(np.complex64)
    got, ref = _both("fft", {"forward": True}, {"signal": x})
    assert abs(got[k] - n) < 1e-2
    mask = np.ones(n, bool)
    mask[k] = False
    np.testing.assert_allclose(np.abs(got[mask]), 0, atol=1e-2)
    assert _rel(got, ref) <= REL


def test_fft_c2c_roundtrip_unnormalized():
    x = _cplx(np.random.default_rng(2), 512)
    f, fj = _both("fft", {"forward": True}, {"signal": x})
    b, bj = _both("fft", {"forward": False}, {"signal": f})
    np.testing.assert_allclose(b, x * 512, atol=1e-2)
    assert _rel(b, bj) <= REL and _rel(f, fj) <= REL


def test_fft_r2c_complex_output():
    x = np.random.default_rng(3).standard_normal(128).astype(np.float32)
    mod, outs = _port_module("fft", {"forward": True,
                                     "complexOutput": True}, {"signal": x})
    got = outs["signal"]
    assert got.shape == (65,) and got.dtype == np.complex64
    spec = mod.output_specs["signal"]
    assert spec.shape == (65,) and spec.dtype == DataType.CF32
    np.testing.assert_allclose(got, np.fft.rfft(x), atol=1e-3)
    ctx = _jax_module("fft", {"forward": True, "complexOutput": True},
                      {"signal": x})
    assert _rel(got, ctx.output("signal")) <= REL


def test_fft_r2r_fftpack_packing():
    x = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    got, ref = _both("fft", {"forward": True, "complexOutput": False},
                     {"signal": x})
    assert got.dtype == np.float32 and got.shape == (64,)
    np.testing.assert_allclose(got, scipy.fftpack.rfft(x), atol=1e-3)
    assert _rel(got, ref) <= REL


def test_fft_r2r_backward():
    x = np.random.default_rng(5).standard_normal(64).astype(np.float32)
    fwd = scipy.fftpack.rfft(x).astype(np.float32)
    got, ref = _both("fft", {"forward": False, "complexOutput": False},
                     {"signal": fwd})
    np.testing.assert_allclose(got, x * 64, atol=1e-2)
    assert _rel(got, ref) <= REL


def test_fft_batched_axis():
    x = _cplx(np.random.default_rng(6), (4, 64))
    got, ref = _both("fft", {"forward": True}, {"signal": x})
    np.testing.assert_allclose(got, np.fft.fft(x, axis=1), atol=1e-2)
    assert _rel(got, ref) <= REL


def test_fft_sample_axis_first():
    from cyberether_tpu.core.tensor import SignalAxes as JaxAxes

    x = _cplx(np.random.default_rng(7), (64, 3))
    got, ref = _both("fft", {"forward": True}, {"signal": x},
                     axes=JaxAxes(sample=0, batch=1))
    assert _rel(got, np.fft.fft(x, axis=0)) <= REL
    assert _rel(got, ref) <= REL


@pytest.mark.parametrize("shape,dtype,axes,match", [
    ((64,), np.int16, None, "dtype"),
    ((4, 64, 2), np.complex64, SignalAxes(), "sampleAxis"),
])
def test_fft_validation_errors(shape, dtype, axes, match):
    spec = TensorSpec(shape, DataType.from_np(np.dtype(dtype)),
                      Device.CPU, axes or SignalAxes(sample=0))
    with pytest.raises(ValidationError, match=match):
        tdsp.FftModule("t/m", {}, {"signal": spec}, device=Device.CPU)


# -- K3: the plain version of the kernel ------------------------------------

@functools.lru_cache(maxsize=None)
def _k3_case(shape):
    x = _cplx(np.random.default_rng(sum(shape)), shape)
    ref = np.asarray(jk.fft_pallas(jnp.asarray(x), interpret=True))
    return x, ref


@pytest.mark.parametrize("shape", [(4, 128), (4, 512), (4, 2048),
                                   (2, 3, 1024)])
def test_plain_k3_matches_jax_k3_and_numpy(shape):
    x, ref = _k3_case(shape)
    got = tk.fft_pallas_plain(torch.from_numpy(x)).numpy()
    assert got.shape == shape and got.dtype == np.complex64
    assert _rel(got, ref) <= REL
    assert _rel(got, np.fft.fft(x.astype(np.complex128))) <= REL


def test_k3_wrapper_on_cpu_runs_plain_without_counting():
    x, _ = _k3_case((4, 512))
    before = tk.fft_pallas.launches
    xt = torch.from_numpy(x)
    assert torch.equal(tk.fft_pallas(xt), tk.fft_pallas_plain(xt))
    assert tk.fft_pallas.launches == before


@pytest.mark.parametrize("bad,match", [
    ("dtype", "complex64"), ("n", "n=384"), ("small", "n=64"),
    ("conj", "conjugate"), ("empty", "at least one row")])
def test_k3_wrapper_rejects_bad_arguments(bad, match):
    x = torch.zeros((2, 256), dtype=torch.complex64)
    if bad == "dtype":
        x = torch.zeros((2, 256), dtype=torch.complex128)
    elif bad == "n":
        x = torch.zeros((2, 384), dtype=torch.complex64)
    elif bad == "small":
        x = torch.zeros((2, 64), dtype=torch.complex64)
    elif bad == "conj":
        x = x.conj()
    elif bad == "empty":
        x = torch.zeros((0, 256), dtype=torch.complex64)
    with pytest.raises(ValueError, match=match):
        tk.fft_pallas(x)


def test_k2_and_k3_share_the_pass_loop():
    """K2's plain version is K3's on the windowed rows, then |X|^2 as the
    kernels round it and the epilogue."""
    rng = np.random.default_rng(8)
    iq = rng.standard_normal((3, 256, 2)).astype(np.float32)
    win = rng.uniform(0.5, 1.0, 256).astype(np.float32)
    t_iq, t_win = torch.from_numpy(iq), torch.from_numpy(win)
    X = tk.fft_pallas_plain(torch.view_as_complex(t_iq) * t_win)
    ref = tk._spectrum_epilogue(tk._mag2(X.real, X.imag), 0.5, 0.01, 0.9)
    got = tk.spectrum_fused_ct5_plain(t_iq, t_win, 0.5, 0.01, 0.9)
    assert torch.equal(got, ref)


# -- FftPallasModule (provider pallas) and the eligibility rule -------------

@pytest.mark.parametrize("n,dtype", [
    (128, "CF32"), (256, "CF32"), (4096, "CF32"), (384, "CF32"),
    (8192, "CF32"), (64, "CF32"), (200, "CF32"), (256, "F32")])
def test_eligibility_matches_jax(n, dtype):
    port = TensorSpec((2, n), DataType(dtype), Device.CPU)
    jax = JaxSpec((2, n), JaxDataType(dtype))
    assert tdsp.fft_pallas_eligible(port, 1) == \
        jdsp.fft_pallas_eligible(jax, 1)


@pytest.mark.parametrize("shape,axes", [((4, 512), None),
                                        ((1024,), None),
                                        ((256, 3), "first")])
def test_pallas_module_forward_matches_jax(shape, axes):
    from cyberether_tpu.core.tensor import SignalAxes as JaxAxes

    x = _cplx(np.random.default_rng(9), shape)
    jaxes = JaxAxes(sample=0, batch=1) if axes == "first" else None
    got, ref = _both("fft", {"forward": True}, {"signal": x}, "pallas",
                     axes=jaxes)
    ax = 0 if axes == "first" else -1
    assert _rel(got, ref) <= REL
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=ax)) <= REL


def test_pallas_module_backward_round_trip():
    """As tests/models/test_pallas_kernels.py:416-430: the unnormalized
    backward transform of fft(x) gives n x."""
    n = 1024
    x = _cplx(np.random.default_rng(2), n)
    f = np.fft.fft(x).astype(np.complex64)
    mod, outs = _port_module("fft", {"forward": False}, {"signal": f},
                             "pallas")
    assert isinstance(mod, tdsp.FftPallasModule)
    np.testing.assert_allclose(outs["signal"], n * x, atol=1e-2)
    ctx = _jax_module("fft", {"forward": False}, {"signal": f}, "pallas")
    assert _rel(outs["signal"], ctx.output("signal")) <= REL


def test_pallas_module_resolves_a_lazy_conjugate():
    """The module hands the kernel physical memory: a lazily conjugated
    input is transformed as conj(x), not as x."""
    x = _cplx(np.random.default_rng(11), (2, 256))
    spec = TensorSpec((2, 256), DataType.CF32, Device.CPU,
                      SignalAxes(batch=0, sample=1))
    mod = tdsp.FftPallasModule("t/m", {}, {"signal": spec},
                               device=Device.CPU)
    got = mod.apply({"signal": torch.from_numpy(x).conj()}, None)[0]
    assert _rel(got["signal"].numpy(),
                np.fft.fft(np.conj(x).astype(np.complex128))) <= REL


@pytest.mark.parametrize("shape,dtype,provider,match", [
    ((2, 256), "F32", "pallas", "CF32"),
    ((2, 384), "CF32", "pallas", "n=384"),
    ((2, 8192), "CF32", "pallas", "n=8192"),
    ((2, 256), "CF32", "mxu", "provider 'mxu'"),
])
def test_pallas_and_mxu_validation_errors(shape, dtype, provider, match):
    """The pallas provider refuses shapes it cannot take at validate
    time; provider 'mxu' (``ops/mxu_fft.py``, not ported) is refused by
    the registry rather than served by another provider."""
    spec = TensorSpec(shape, DataType(dtype), Device.CPU,
                      SignalAxes(batch=0, sample=1))
    if provider == "mxu":
        with pytest.raises(GraphError, match=match):
            registry.build_module("fft", "cpu", "torch", provider)
        return
    cls = registry.build_module("fft", "cpu", "torch", provider)
    assert cls.provider == provider
    with pytest.raises(ValidationError, match=match):
        cls("t/m", {}, {"signal": spec}, device=Device.CPU)


# -- the dti -> fft flowgraph ------------------------------------------------

@pytest.mark.parametrize("forward", [True, False])
def test_flowgraph_dti_fft_on_cpu(forward):
    B, n = 4, 512
    rng = np.random.default_rng(10)
    bufs = [_cplx(rng, (B, n)) for _ in range(2)]
    fg = tpkg.Flowgraph(default_device="cpu")
    fg.block_create("src", "dti", {"shape": [B, n], "dataType": "CF32"})
    fg.block_create("fft", "fft", {"forward": forward},
                    {"signal": "${graph.src.output.buffer}"},
                    provider="pallas")
    assert isinstance(fg.block_module("fft"), tdsp.FftPallasModule)
    before = tk.fft_pallas.launches
    try:
        for x in bufs:
            fg.block_module("src").attach_buffer(x)
            assert fg.compute(timeout=30.0)
            got = fg.scheduler.output("fft.signal")
            x64 = x.astype(np.complex128)
            truth = np.fft.fft(x64, axis=-1) if forward \
                else np.fft.ifft(x64, axis=-1) * n
            ctx = _jax_module("fft", {"forward": forward}, {"signal": x},
                              "pallas")
            assert got.shape == (B, n) and got.dtype == np.complex64
            assert _rel(got, truth) <= REL
            assert _rel(got, ctx.output("signal")) <= REL
    finally:
        fg.stop()
    assert tk.fft_pallas.launches == before
