"""Guards of the port's rules: ``cyberether_tpu_torch``,
``chip_smoke.py`` and ``ab_spectrum.py`` import nothing of JAX or of the
JAX package; the entry points run on the card unless asked for the CPU,
and never fall back; the kernel wrappers count only real launches."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "cyberether_tpu_torch").rglob("*.py")) + \
    ["chip_smoke.py", "ab_spectrum.py"]
FORBIDDEN = ("jax", "jaxlib", "cyberether_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_nothing_of_jax(rel):
    bad = [m for m in _imported_roots(ROOT / rel) if m in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'cyberether_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import cyberether_tpu_torch, cyberether_tpu_torch.convert\n"
            "from cyberether_tpu_torch.ops import kernels, _build, firs, "
            "windows, fastmath, fftops\n"
            "from cyberether_tpu_torch.blocks import core, composites, dsp\n"
            "from cyberether_tpu_torch.models import channelizer, wbfm, "
            "spectrum\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device works")


@pytest.mark.parametrize("entry", ["Flowgraph", "Instance", "Channelizer",
                                   "WbfmReceiver", "SpectrumPipeline"])
def test_default_device_raises_without_a_card(entry):
    _no_card()
    import cyberether_tpu_torch as tpkg
    from cyberether_tpu_torch.core.types import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        getattr(tpkg, entry)()
    # asking for the CPU works
    getattr(tpkg, entry)(**({"device": "cpu"} if entry in (
        "Channelizer", "WbfmReceiver", "SpectrumPipeline")
        else {"default_device": "cpu"}))


def test_cpu_tensors_never_count_as_launches():
    from cyberether_tpu_torch.models.channelizer import Channelizer
    from cyberether_tpu_torch.models.spectrum import SpectrumPipeline
    from cyberether_tpu_torch.models.wbfm import WbfmReceiver
    from cyberether_tpu_torch.blocks.dsp import FftPallasModule
    from cyberether_tpu_torch.core.tensor import SignalAxes, TensorSpec
    from cyberether_tpu_torch.core.types import DataType, Device
    from cyberether_tpu_torch.ops import kernels

    _no_card()
    m = Channelizer(channels=8, taps_per_branch=4, audio_decim=4,
                    device="cpu")
    iq = torch.from_numpy(m.make_input_full(64))
    for kernel in ("v5", "v4", "v6"):
        m.step_kernel(m.init_state_v4(), iq, kernel=kernel)
    for variant in ("v1", "v2"):
        m.step_carry_kernel(m.init_state(), iq, variant)
    rx = WbfmReceiver(device="cpu")
    iq = rx.make_input(1280, device="cpu")
    for version, mode in (("v2", "classic"), ("v2", "coherent"),
                          ("v1", "classic")):
        rx.step_kernel(rx.init_state(), iq, version=version, demod_mode=mode)
    sp = SpectrumPipeline(fft_size=256, batches=2, device="cpu")
    sp.step_kernel(torch.from_numpy(sp.make_input()))
    sp = SpectrumPipeline(fft_size=384, batches=2, device="cpu")
    iq = torch.from_numpy(sp.make_input())
    sp.step_kernel(iq)
    sp.step_dft_kernel(iq)
    for exact in (True, False):
        sp.step_kernel(iq, version="ct1", exact=exact)
    for ep in ("exact", "approx", "none"):
        kernels.spectrum_fused_ct3(iq, sp._win, sp._coeff, sp._scale,
                                   sp._offset, ep=ep, skip=("tw",))
    spec = TensorSpec((2, 256), DataType.CF32, Device.CPU,
                      SignalAxes(batch=0, sample=1))
    x = torch.ones((2, 256), dtype=torch.complex64)
    for forward in (True, False):
        fft = FftPallasModule("fft/m", {"forward": forward},
                              {"signal": spec}, device=Device.CPU)
        fft.apply({"signal": x}, None)
    kernels.fft_pallas(x, exact=False)
    assert (kernels.channelize_demod_decim.launches,
            kernels.wbfm_fused_v2.launches, kernels.wbfm_fused.launches,
            kernels.spectrum_fused_ct5.launches,
            kernels.fft_pallas.launches, kernels.spectrum_fused.launches,
            kernels.spectrum_fused_ct4.launches,
            kernels.channelize_demod.launches,
            kernels.channelize_demod_decim_v4.launches,
            kernels.channelize_demod_decim_v6.launches,
            kernels.spectrum_fused_ct.launches,
            kernels.spectrum_fused_ct3.launches) == (0,) * 12


def test_chip_smoke_alone_fails_without_printing_a_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
