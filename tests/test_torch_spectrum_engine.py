"""The port's ``spectrum_engine`` composite against the JAX package, on
the CPU: each of its nine modules (``cast``, ``window``, ``invert``,
``reshape``, ``signal_axes``, ``multiply``, ``agc``, ``amplitude``,
``range``) against its JAX module, then the composite against JAX's
``BlockTestContext`` and in a ``Flowgraph`` on the CPU.

On the CPU the port's composite takes the ``generic`` FFT provider, as
the JAX composite does on a CPU block; the JAX side runs on its default
(accelerator) placement too, where the composite takes the Pallas FFT in
interpret mode.

Tolerances, and why:
- window, reshape, signal_axes and cast: bit-exact (the same float32
  operations, or a float64 computation cast once);
- invert and multiply: 1e-6 relative (complex products, rounded by two
  libraries);
- agc, amplitude and range: 1e-5 relative, or 1e-4 dB (float32
  transcendentals from two libraries);
- the composite: 1e-3 dB, or 1e-4 in [0, 1] units, with -inf (dB) or
  exactly 0 ([0, 1]) on the same bins (the reference's 1e-3 dB FFT bar,
  ``tests/blocks/test_dsp_ops.py:1-5``), and the same argmax bin in
  every row.  A real input's spectrum is symmetric: after the inversion
  bin j and bin n - j hold the same magnitude, and rounding decides
  which one is the maximum, so for F32 input either bin of that pair
  counts as the same.
"""

import numpy as np
import pytest
import torch

import cyberether_tpu_torch as tpkg
from cyberether_tpu.core.tensor import SignalAxes as JaxAxes
from cyberether_tpu.core.types import Device as JaxDevice
from cyberether_tpu.testing import BlockTestContext, TestContext, \
    default_axes
from cyberether_tpu_torch.blocks import composites, core as tcore
from cyberether_tpu_torch.blocks import dsp as tdsp
from cyberether_tpu_torch.core.block import PortRef
from cyberether_tpu_torch.core.registry import registry
from cyberether_tpu_torch.core.tensor import SignalAxes, TensorSpec, spec_of
from cyberether_tpu_torch.core.types import DataType, Device, GraphError, \
    ValidationError
from cyberether_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

DB_TOL = 1e-3
UNIT_TOL = 1e-4


def _port_axes(a):
    return None if a is None else SignalAxes(sample=a.sample, batch=a.batch,
                                             channel=a.channel)


def _port(module_type, config, inputs, axes=None):
    """The port's module on the CPU, run once: (module, outputs)."""
    cls = registry.build_module(module_type, "cpu", "torch", "generic")
    specs = {p: spec_of(a, axes=_port_axes((axes or {}).get(p)
                                           or default_axes(a)),
                        device=Device.CPU)
             for p, a in inputs.items()}
    mod = cls("test/m", config, specs, device=Device.CPU)
    outs, _ = mod.apply({p: torch.from_numpy(np.ascontiguousarray(a))
                         for p, a in inputs.items()}, mod.init_state())
    return mod, {p: v.numpy() for p, v in outs.items()}


def _jax(module_type, config, inputs, axes=None):
    ctx = TestContext(module_type, config)
    for p, a in inputs.items():
        ctx.set_input(p, a, axes=(axes or {}).get(p))
    return ctx.run()


def _pair(module_type, config, inputs, port, axes=None):
    mod, outs = _port(module_type, config, inputs, axes)
    ctx = _jax(module_type, config, inputs, axes)
    jspec = ctx.output_spec(port)
    spec = mod.output_specs[port]
    assert spec.shape == tuple(jspec.shape)
    assert spec.dtype.value == jspec.dtype.value
    assert (spec.axes.sample, spec.axes.batch, spec.axes.channel) == \
        (jspec.axes.sample, jspec.axes.batch, jspec.axes.channel)
    return outs[port], ctx.output(port)


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# -- the nine modules ---------------------------------------------------------

@pytest.mark.parametrize("size", [1, 64, 257])
def test_window_matches_jax(size):
    got, ref = _pair("window", {"size": size}, {}, "window")
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,dtype", [((8,), np.complex64),
                                         ((7,), np.complex64),
                                         ((3, 9), np.float32),
                                         ((3, 16), np.complex64)])
def test_invert_matches_jax(shape, dtype):
    rng = np.random.default_rng(1)
    x = _cplx(rng, shape) if dtype == np.complex64 else \
        rng.standard_normal(shape).astype(dtype)
    got, ref = _pair("invert", {}, {"signal": x}, "signal")
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [[1, 64], [-1, 8], [64]])
def test_reshape_matches_jax(shape):
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    got, ref = _pair("reshape", {"shape": shape}, {"buffer": x}, "buffer")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("axes", ["sample=1", "sample=-1,batch=0",
                                  "channel=0", ""])
def test_signal_axes_matches_jax(axes):
    x = np.zeros((2, 4), np.float32)
    got, ref = _pair("signal_axes", {"axes": axes}, {"buffer": x}, "buffer")
    np.testing.assert_array_equal(got, ref)


def test_multiply_broadcast_matches_jax():
    rng = np.random.default_rng(2)
    a = _cplx(rng, (3, 16))
    b = _cplx(rng, (1, 16))
    got, ref = _pair("multiply", {}, {"a": a, "b": b}, "product",
                     axes={"b": JaxAxes(sample=1)})
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("src,out", [
    (np.int16, "F32"), (np.int8, "CF32"), (np.float32, "CF32"),
    (np.complex64, "CF32"), (np.float32, "F32")])
def test_cast_matches_jax(src, out):
    rng = np.random.default_rng(3)
    if np.issubdtype(src, np.integer):
        info = np.iinfo(src)
        x = rng.integers(info.min, info.max, 32, endpoint=True).astype(src)
    elif src == np.complex64:
        x = _cplx(rng, 32)
    else:
        x = rng.standard_normal(32).astype(src)
    got, ref = _pair("cast", {"outputType": out}, {"buffer": x}, "buffer")
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lo,hi", [(-100.0, 0.0), (0.0, -50.0),
                                   (-1.0, -1.0)])
def test_range_matches_jax(lo, hi):
    x = np.linspace(-130.0, 20.0, 97).astype(np.float32)
    x[3] = -np.inf
    got, ref = _pair("range", {"min": lo, "max": hi}, {"signal": x},
                     "signal")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert got[3] == ref[3]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_amplitude_matches_jax(fast, dtype):
    rng = np.random.default_rng(4)
    x = _cplx(rng, (3, 64)) if dtype == np.complex64 else \
        rng.standard_normal((3, 64)).astype(dtype)
    x[1, 5] = 0.0
    got, ref = _pair("amplitude", {"fastMath": fast}, {"signal": x},
                     "signal")
    assert got.dtype == np.float32
    assert np.isneginf(got[1, 5]) and np.isneginf(ref[1, 5])
    fin = np.isfinite(ref)
    assert (np.isfinite(got) == fin).all()
    assert np.abs(got[fin] - ref[fin]).max() <= 1e-4


@pytest.mark.parametrize("config", [
    {"tileSize": 16}, {"tileSize": 24, "maxGainChange": 1.5},
    {"tileSize": 64, "reference": 0.5}])
@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_agc_matches_jax(config, dtype):
    rng = np.random.default_rng(5)
    shape = (3, 64)
    x = _cplx(rng, shape) if dtype == np.complex64 else \
        rng.standard_normal(shape).astype(dtype)
    x *= np.linspace(0.05, 20.0, 64, dtype=np.float32)  # rising level
    got, ref = _pair("agc", config, {"signal": x}, "signal")
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_agc_sample_axis_first_matches_jax():
    x = _cplx(np.random.default_rng(6), (48, 2))
    axes = {"signal": JaxAxes(sample=0, batch=1)}
    got, ref = _pair("agc", {"tileSize": 16}, {"signal": x}, "signal",
                     axes=axes)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("module_type,config,inputs,match", [
    ("multiply", {}, {"a": np.zeros(4, np.float32),
                      "b": np.zeros(4, np.complex64)}, "dtype mismatch"),
    ("multiply", {}, {"a": np.zeros(4, np.float32),
                      "b": np.zeros(3, np.float32)}, "broadcast"),
    ("reshape", {"shape": [3, -1]}, {"buffer": np.zeros(8, np.float32)},
     "cannot reshape"),
    ("reshape", {"shape": [-1, -1]}, {"buffer": np.zeros(8, np.float32)},
     "at most one"),
    ("signal_axes", {"axes": "sample"}, {"buffer": np.zeros(4)},
     "bad axes syntax"),
    ("signal_axes", {"axes": "time=0"}, {"buffer": np.zeros(4)},
     "unknown axis role"),
    ("signal_axes", {"axes": "sample=0,batch=0"},
     {"buffer": np.zeros((2, 2))}, "overlap"),
    ("window", {"size": 0}, {}, "cannot be zero"),
    ("agc", {"tileSize": 0}, {"signal": np.zeros(8, np.float32)},
     "cannot be zero"),
    ("invert", {}, {"signal": np.zeros(8, np.int16)}, "dtype"),
])
def test_module_validation_errors(module_type, config, inputs, match):
    with pytest.raises(ValidationError, match=match):
        _port(module_type, config, inputs)


def test_amplitude_needs_an_axis():
    spec = TensorSpec((2, 4, 8), DataType.CF32, Device.CPU)
    with pytest.raises(ValidationError, match="sampleAxis or channelAxis"):
        tdsp.AmplitudeModule("t/m", {}, {"signal": spec},
                             device=Device.CPU)


# -- the composite --------------------------------------------------------------

def _engine_input(B, n, dtype=np.complex64, seed=0):
    """Tones on different bins plus noise at 0.1 (so no bin sits near
    the float32 error floor), with one row all zeros."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    k = rng.integers(0, n, B)
    x = np.exp(2j * np.pi * k[:, None] * t / n) + 0.1 * _cplx(rng, (B, n))
    x[B // 2] = 0.0
    if dtype == np.float32:
        return x.real.astype(np.float32)
    return x.astype(np.complex64)


def _port_engine(config, x, fg_device="cpu"):
    """The composite through a CPU Flowgraph: (output, flat module
    types)."""
    fg = tpkg.Flowgraph(default_device=fg_device)
    fg.block_create("src", "dti", {"shape": list(x.shape),
                                   "dataType": DataType.from_np(
                                       x.dtype).value})
    fg.block_create("spec", "spectrum_engine", config,
                    {"buffer": "${graph.src.output.buffer}"})
    try:
        assert fg.block_state("spec").value == "complete", \
            fg.block_error("spec")
        fg.block_module("src").attach_buffer(x)
        assert fg.compute(timeout=30.0)
        out = fg.scheduler.output("spec.buffer")
        mods = {k.split("/", 1)[1]: type(m).__name__
                for k, m in fg.records["spec"].build.modules.items()}
    finally:
        fg.stop()
    return out, mods


def _same_peak(got, ref, real_input):
    """The argmax bin of every row agrees (for a real input, up to the
    mirror bin n - j of the symmetric spectrum)."""
    n = got.shape[-1]
    a, b = np.argmax(got, -1), np.argmax(ref, -1)
    return bool(((a == b) | (real_input & (a == (n - b) % n))).all())


def _compare(got, ref, scaled, real_input=False):
    assert got.shape == ref.shape and got.dtype == np.float32
    if scaled:
        assert np.abs(got - ref).max() <= UNIT_TOL
        assert ((got == 0.0) == (ref == 0.0)).all()
    else:
        fin = np.isfinite(ref)
        assert (np.isneginf(got) == ~fin).all()
        assert np.abs(got[fin] - ref[fin]).max() <= DB_TOL
    assert _same_peak(got, ref, real_input)


@pytest.mark.parametrize("agc", [False, True])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_engine_matches_jax(agc, scale, fast):
    config = {"enableAgc": agc, "enableScale": scale, "fastMath": fast,
              "rangeMin": -100.0, "rangeMax": 0.0}
    x = _engine_input(4, 256)
    got, mods = _port_engine(config, x)
    assert mods["fft"] == "FftModule"            # generic on the CPU
    assert ("agc" in mods) == agc and ("range" in mods) == scale
    for jdev in (JaxDevice.TPU, JaxDevice.CPU):
        ctx = BlockTestContext("spectrum_engine", config, device=jdev)
        ref = ctx.set_input("buffer", x).run().output("buffer")
        _compare(got, ref, scale)
    if scale:
        assert (got[2] == 0.0).all()             # the zero row
    else:
        assert np.isneginf(got[2]).all()


@pytest.mark.parametrize("n", [128, 255, 512])
def test_engine_f32_and_odd_n_match_jax(n):
    """F32 input (cast to CF32), odd n (the integer-bin phasor and the
    generic FFT on both sides), the default range."""
    x = _engine_input(3, n, np.float32, seed=n)
    config = {"enableScale": True}
    got, _ = _port_engine(config, x)
    ctx = BlockTestContext("spectrum_engine", config)
    _compare(got, ctx.set_input("buffer", x).run().output("buffer"), True,
             real_input=True)


def test_engine_tone_bin_matches_jax():
    """A single tone: the inverting window moves it by n/2; both
    packages put the peak on the same bin."""
    n, k = 256, 32
    x = np.exp(2j * np.pi * k * np.arange(n) / n).astype(np.complex64)
    got, _ = _port_engine({}, x)
    ref = BlockTestContext("spectrum_engine").set_input("buffer", x) \
        .run().output("buffer")
    assert got.shape == (n,)
    assert np.argmax(got) == np.argmax(ref)


def test_engine_needs_a_sample_axis():
    blk = composites.SpectrumEngineBlock("spec", {}, Device.CPU,
                                         tpkg.Runtime.TORCH, "generic")
    spec = TensorSpec((2, 4, 256), DataType.CF32, Device.CPU)
    with pytest.raises(ValidationError, match="sampleAxis"):
        blk.instantiate({"buffer": (PortRef("src/m", "buffer"), spec)})


def test_engine_on_a_cpu_block_keeps_generic_even_when_eligible():
    """The JAX composite's routing: pallas only for an eligible shape
    on a block that is not on the CPU."""
    blk = composites.SpectrumEngineBlock("spec", {}, Device.CPU,
                                         tpkg.Runtime.TORCH, "generic")
    spec = TensorSpec((4, 2048), DataType.F32, Device.CPU,
                      SignalAxes(batch=0, sample=1))
    build = blk.instantiate({"buffer": (PortRef("src/m", "buffer"), spec)})
    fft = build.modules["spec/fft"]
    assert type(fft) is tdsp.FftModule
    assert tdsp.fft_pallas_eligible(
        build.modules["spec/multiply"].output_specs["product"], 1)


def test_flowgraph_engine_benchmark_shape_on_cpu():
    """The repo's benchmark configuration (F32 input, enableScale),
    narrowed to 8 rows of 2048, in a Flowgraph on the CPU; no kernel
    launch is counted."""
    x = _engine_input(8, 2048, np.float32, seed=7)
    config = {"enableScale": True}
    before = (tk.fft_pallas.launches, tk.spectrum_fused_ct5.launches)
    got, mods = _port_engine(config, x)
    assert list(mods) == ["cast_input", "window", "invert",
                          "reshape_window", "axes_window", "multiply",
                          "fft", "amplitude", "range"]
    ref = BlockTestContext("spectrum_engine", config,
                           device=JaxDevice.CPU).set_input(
        "buffer", x).run().output("buffer")
    _compare(got, ref, True, real_input=True)
    assert (tk.fft_pallas.launches, tk.spectrum_fused_ct5.launches) == before


def test_blocks_of_the_slice_are_registered():
    for t in ("spectrum_engine", "fft", "window", "amplitude", "invert",
              "agc", "cast", "multiply", "reshape", "range", "signal_axes"):
        assert registry.has_block(t)
    with pytest.raises(GraphError):
        registry.build_module("decimator")
    assert tcore._resolve_axis(-1, 3) == 2
    with pytest.raises(ValidationError):
        tcore._resolve_axis(3, 3)
