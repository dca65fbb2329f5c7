"""The port's core layer (types, tensor specs, params, registry, topo sort)
run through the cases of ``tests/core/test_tensor.py``,
``tests/core/test_params.py`` and the flowgraph cycle rejection, as
cases parametrised over both packages."""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PACKAGES = ["cyberether_tpu", "cyberether_tpu_torch"]


@pytest.fixture(params=PACKAGES, ids=["jax", "torch"])
def pkg(request):
    name = request.param
    return {
        "name": name,
        "types": importlib.import_module(f"{name}.core.types"),
        "tensor": importlib.import_module(f"{name}.core.tensor"),
        "params": importlib.import_module(f"{name}.core.params"),
        "flowgraph": importlib.import_module(f"{name}.core.flowgraph"),
    }


# -- tensor specs -------------------------------------------------------------
def test_basic_spec(pkg):
    T, t = pkg["types"], pkg["tensor"]
    s = t.TensorSpec((8, 2048), T.DataType.CF32,
                     axes=t.SignalAxes(batch=0, sample=1))
    assert s.size == 8 * 2048
    assert s.size_bytes == 8 * 2048 * 8
    assert s.dtype.is_complex


def test_axes_out_of_range(pkg):
    T, t = pkg["types"], pkg["tensor"]
    with pytest.raises(T.ValidationError):
        t.TensorSpec((4,), T.DataType.F32, axes=t.SignalAxes(sample=1))


def test_axes_overlap_rejected(pkg):
    T, t = pkg["types"], pkg["tensor"]
    with pytest.raises(T.ValidationError):
        t.TensorSpec((4, 4), T.DataType.F32,
                     axes=t.SignalAxes(sample=0, batch=0))


def test_expand_squeeze_axis_maps(pkg):
    T, t = pkg["types"], pkg["tensor"]
    s = t.TensorSpec((8, 2048), T.DataType.CF32,
                     axes=t.SignalAxes(batch=0, sample=1))
    e = s.expand_dims(1)
    assert e.shape == (8, 1, 2048)
    assert e.axes.batch == 0 and e.axes.sample == 2
    q = e.squeeze_dims(1)
    assert q.shape == (8, 2048)
    assert q.axes.sample == 1


def test_squeeze_nonunit_rejected(pkg):
    T, t = pkg["types"], pkg["tensor"]
    s = t.TensorSpec((8, 2048), T.DataType.CF32)
    with pytest.raises(T.ValidationError):
        s.squeeze_dims(0)


def test_permute_remaps_axes(pkg):
    T, t = pkg["types"], pkg["tensor"]
    s = t.TensorSpec((8, 2048), T.DataType.CF32,
                     axes=t.SignalAxes(batch=0, sample=1))
    p = s.permute([1, 0])
    assert p.shape == (2048, 8)
    assert p.axes.sample == 0 and p.axes.batch == 1


def test_attribute_propagation(pkg):
    T, t = pkg["types"], pkg["tensor"]
    a = t.TensorSpec((4,), T.DataType.CF32, attributes={"sampleRate": 2e6})
    b = t.TensorSpec((4,), T.DataType.F32).propagate(a)
    assert b.attr("sampleRate") == 2e6


def test_dtype_tables(pkg):
    DT = pkg["types"].DataType
    assert DT.CF32.real_dtype == DT.F32
    assert DT.F32.complex_dtype == DT.CF32
    assert DT.CF32.element_size == 8
    assert DT.CI16.element_size == 4
    assert DT.parse("cf32") == DT.CF32
    assert len(list(DT)) == 20


def test_spec_of_numpy(pkg):
    spec = pkg["tensor"].spec_of(np.zeros((3, 5), np.complex64))
    assert spec.shape == (3, 5) and spec.dtype.value == "CF32"


# -- params -------------------------------------------------------------------
def test_defaults_and_coercion(pkg):
    p = pkg["params"]
    s = p.Schema(p.Field("size", "int", 1024), p.Field("rate", "float", 2e6),
                 p.Field("on", "bool", True), p.Field("name", "str", "x"))
    cfg = s.decode({"size": "2048", "rate": "1e6", "on": "false"})
    assert cfg == {"size": 2048, "rate": 1e6, "on": False, "name": "x"}


def test_string_vector_literals(pkg):
    parse = pkg["params"].parse_literal_list
    assert parse("[0]") == [0]
    assert parse("[1, 2.5, -3]") == [1, 2.5, -3]
    assert parse([4, 5]) == [4, 5]
    assert parse("[0, :]") == ["0", ":"]


def test_list_field(pkg):
    p = pkg["params"]
    s = p.Schema(p.Field("center", "list[float]", [0.0]))
    assert s.decode({"center": "[1e6, -2e6]"})["center"] == [1e6, -2e6]
    assert s.decode({})["center"] == [0.0]


def test_dtype_field(pkg):
    p, T = pkg["params"], pkg["types"]
    s = p.Schema(p.Field("dataType", "dtype", T.DataType.CF32))
    assert s.decode({"dataType": "f32"})["dataType"] == T.DataType.F32


def test_unknown_keys_kept_and_strict(pkg):
    p, T = pkg["params"], pkg["types"]
    s = p.Schema(p.Field("a", "int", 1))
    assert s.decode({"b": 2})["b"] == 2
    with pytest.raises(T.ValidationError):
        s.decode({"b": 2}, strict=True)


def test_bad_coercion_raises(pkg):
    p, T = pkg["params"], pkg["types"]
    s = p.Schema(p.Field("n", "int", 0))
    with pytest.raises(T.ValidationError):
        s.decode({"n": "not-a-number"})


def test_config_hash_stability_and_sensitivity(pkg):
    h = pkg["params"].config_hash
    assert h({"a": 1, "b": [1, 2]}) == h({"b": [1, 2], "a": 1})
    assert h({"a": 1, "b": [1, 2]}) != h({"a": 2, "b": [1, 2]})


def test_config_hash_equal_across_packages():
    from cyberether_tpu.core.params import config_hash as jh
    from cyberether_tpu_torch.core.params import config_hash as th

    cfg = {"threshold": 0.25, "shape": [8, 16], "name": "sq"}
    assert jh(cfg) == th(cfg)


def test_encode_roundtrip(pkg):
    p = pkg["params"]
    s = p.Schema(p.Field("size", "int", 8), p.Field("z", "complex", 0j))
    enc = s.encode(s.decode({"size": 16, "z": "1+2j"}))
    assert enc["size"] == 16
    assert enc["z"] == [1.0, 2.0]


# -- flowgraph topology -----------------------------------------------------------
def test_cycle_rejected(pkg):
    Flowgraph = pkg["flowgraph"].Flowgraph
    fg = Flowgraph(default_device="cpu") if pkg["name"].endswith("torch") \
        else Flowgraph()
    fg.block_create("src", "dti", {"shape": [64, 8], "dataType": "CF32"})
    fg.block_create("p1", "squelch", {},
                    {"signal": "${graph.src.output.buffer}"})
    fg.block_create("p2", "squelch", {},
                    {"signal": "${graph.p1.output.signal}"})
    with pytest.raises(pkg["types"].GraphError, match="cycle"):
        fg.block_connect("p1", "signal", "${graph.p2.output.signal}")
        fg.compute(timeout=1.0)
    fg.stop()


# -- the port's own spellings ---------------------------------------------------
@pytest.mark.parametrize("spelling,want", [
    ("cpu", "CPU"), ("cuda", "CUDA"), ("gpu", "CUDA"), ("tpu", "CUDA"),
    ("", "ANY")])
def test_device_parse_accepts_jax_spellings(spelling, want):
    from cyberether_tpu_torch.core.types import Device

    assert Device.parse(spelling) == Device[want]


@pytest.mark.parametrize("spelling,want", [
    ("jax", "TORCH"), ("native", "TORCH"), ("pallas", "KERNEL"),
    ("python", "HOST"), ("torch", "TORCH")])
def test_runtime_parse_accepts_jax_spellings(spelling, want):
    from cyberether_tpu_torch.core.types import Runtime

    assert Runtime.parse(spelling) == Runtime[want]


def test_datatype_torch_mapping():
    from cyberether_tpu_torch.core.types import DataType

    assert DataType.CF32.torch_dtype == torch.complex64
    assert DataType.parse(torch.int16) == DataType.I16
    assert DataType.from_torch(torch.float32) == DataType.F32
    for dt in DataType:
        assert DataType.parse(dt.value) == dt


def test_registry_lookup_and_fallback():
    import cyberether_tpu_torch  # noqa: F401 — registers the blocks
    from cyberether_tpu_torch.core.registry import registry
    from cyberether_tpu_torch.core.types import GraphError

    assert registry.list_blocks() == [
        "agc", "amplitude", "cast", "channelizer", "dti", "fft", "invert",
        "multiply", "range", "reshape", "signal_axes", "spectrum",
        "spectrum_engine", "squelch", "wbfm", "window"]
    chan = registry.build_module("channelizer", "cpu", "jax", "pallas")
    assert chan.module_type == "channelizer"
    assert registry.build_module("wbfm", "cuda", "kernel",
                                 "pallas").module_type == "wbfm"
    assert registry.build_module("spectrum", "cuda", "kernel",
                                 "pallas").module_type == "spectrum"
    assert registry.build_module("squelch", "cuda").module_type == "squelch"
    # a provider registered for the card also serves a CPU request, and
    # is preferred to another provider of the same type
    assert registry.build_module("fft", "cpu", "torch",
                                 "pallas").provider == "pallas"
    assert registry.build_module("fft", "cpu").provider == "generic"
    # a named provider that no device registers for the type is refused,
    # never served by another provider
    with pytest.raises(GraphError, match="provider 'pallas'"):
        registry.build_module("window", "cuda", "torch", "pallas")
    with pytest.raises(GraphError):
        registry.build_module("am")


# -- scheduler semantics, on modules that are not registered ----------------
def _semantics_graph():
    from cyberether_tpu_torch.core.block import PortRef
    from cyberether_tpu_torch.core.module import Module, PASS_FLAG
    from cyberether_tpu_torch.core.tensor import TensorSpec
    from cyberether_tpu_torch.core.types import DataType, Device, \
        Runtime, Taint

    spec = TensorSpec((4,), DataType.F32, device=Device.CPU)

    class Src(Module):
        device, runtime, taints = Device.CPU, Runtime.HOST, Taint.HOST_SOURCE
        buf, ver = np.ones(4, np.float32), 0

        def create(self):
            return {"out": spec}

        def host_poll(self):
            return {"out": self.buf}

        def host_output_version(self):
            return self.ver

    class Const(Module):
        taints = Taint.STATIC_OUTPUT
        applies = 0

        def create(self):
            return {"out": spec}

        def apply(self, inputs, state):
            type(self).applies += 1
            return {"out": torch.full((4,), 10.0)}, state

    class Gate(Module):
        taints = Taint.STATELESS
        input_ports = ("x",)

        def create(self):
            return {"out": spec}

        def apply(self, inputs, state):
            x = inputs["x"]
            return {"out": x, PASS_FLAG: x.sum() > 0,
                    "metric:sum": x.sum()}, state

    class Acc(Module):
        input_ports = ("x", "c")

        def create(self):
            return {"out": spec}

        def init_state(self):
            return {"n": torch.zeros(())}

        def apply(self, inputs, state):
            out = inputs["x"] + inputs["c"] + state["n"]
            return {"out": out}, {"n": state["n"] + 1}

    dev = Device.CPU
    mods = {"src/m": Src("src/m", {}, {}),
            "k/m": Const("k/m", {}, {}, device=dev),
            "g/m": Gate("g/m", {}, {"x": spec}, device=dev),
            "acc/m": Acc("acc/m", {}, {"x": spec, "c": spec}, device=dev)}
    ins = {"g/m": {"x": PortRef("src/m", "out")},
           "acc/m": {"x": PortRef("g/m", "out"), "c": PortRef("k/m", "out")}}

    class Graph:
        _generation = 0
        records = {}

        def flattened(self):
            return dict(mods), {k: dict(v) for k, v in ins.items()}

        def mark_modules_errored(self, names, error):
            raise AssertionError(f"{names}: {error}")

    return Graph(), mods, Const


def test_scheduler_settles_gates_and_freezes_state():
    from cyberether_tpu_torch.core.scheduler import Scheduler

    graph, mods, Const = _semantics_graph()
    sch = Scheduler(graph)
    src = mods["src/m"]
    seen = []
    for buf in (np.ones(4), -np.ones(4), np.ones(4)):
        src.buf, src.ver = buf.astype(np.float32), src.ver + 1
        assert sch.compute()
        out = sch._latest["acc/m:out"]
        seen.append((out.clone(), bool(sch._valid["acc/m:out"]),
                     float(sch.state_of("acc/m")["n"])))
    assert Const.applies == 1                    # settled once, reused
    assert "k/m" in sch._settled and "g/m" not in sch._settled
    # cycle 2 is gated: invalid output, state not advanced
    assert [v for _, v, _ in seen] == [True, False, True]
    assert [n for _, _, n in seen] == [1.0, 1.0, 2.0]
    assert torch.equal(seen[2][0], torch.full((4,), 12.0))
    assert sch.metrics()["g/m"]["sum"] == 4.0


def test_scheduler_uploads_once_per_source_version():
    from cyberether_tpu_torch.core.scheduler import DeviceSegment, Scheduler

    graph, mods, _ = _semantics_graph()
    sch = Scheduler(graph)
    src = mods["src/m"]
    sch._ensure_built()
    seg = next(s for s in sch._segments if isinstance(s, DeviceSegment))
    assert sch.compute()
    first = sch._upload("src/m:out", seg)
    assert sch.compute()
    assert sch._upload("src/m:out", seg) is first      # cached
    src.ver += 1
    assert sch.compute()
    assert sch._upload("src/m:out", seg) is not first  # new version
