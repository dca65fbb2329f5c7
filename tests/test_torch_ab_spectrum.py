"""``ab_spectrum.py``, the A/B timer of two trees' kernels, on the CPU
(``--device cpu``: each case through its wrapper's plain version): the
probes family runs every K13, K14 and K15 case, and the spectrum family
passes K11's ``skip`` flags and K5's m through to the wrappers."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cyberether_tpu_torch.models.spectrum import SpectrumPipeline
from cyberether_tpu_torch.ops import kernels
from cyberether_tpu_torch.ops import probe_kernels as pk
from cyberether_tpu_torch.probes.platform_probe import DOT_ROWS_PER_BLOCK

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import ab_spectrum  # noqa: E402

CPU = torch.device("cpu")


def test_probe_family_runs_every_probe_kernel_case():
    out = subprocess.run(
        [sys.executable, "ab_spectrum.py", "--family", "probes", "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["family"] == "probes"
    cases = [(c["case"], c.get("rows_per_block")) for c in report["cases"]]
    assert cases == [("scale_copy[s=2]", None), ("scale_copy[s=1]", None),
                     ("staged_copy", None)] + [
        (f"tile_dot[{mode}]", rpb) for mode in pk.TILE_DOT_MODES
        for rpb in DOT_ROWS_PER_BLOCK]
    bits = {c["case"]: c["bits"] for c in report["cases"]}
    # s = 1 and the staged copy both return x; s = 2 does not
    assert bits["scale_copy[s=1]"] == bits["staged_copy"]
    assert bits["scale_copy[s=2]"] != bits["staged_copy"]


def test_probe_family_cases_are_the_wrappers_on_one_input():
    runs = list(ab_spectrum.probe_cases(torch, kernels, CPU, False))
    x = runs[1][1]()                        # s = 1: x itself
    assert x.shape == (256, pk.WIDTH) and x.dtype == torch.float32
    assert torch.equal(runs[0][1](), pk.scale_copy_plain(x, 2.0))
    tiles = [(label, run) for label, run in runs
             if label["case"].startswith("tile_dot")]
    assert len(tiles) == len(pk.TILE_DOT_MODES) * len(DOT_ROWS_PER_BLOCK)
    # rows a block change the kernel's walk, never the CPU route's result
    for mode in pk.TILE_DOT_MODES:
        outs = [run() for label, run in tiles
                if label["case"] == f"tile_dot[{mode}]"]
        assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("flags", ["s1", "tw", "s2", "s1,tw,s2"])
def test_spectrum_family_passes_k11_skip_flags(flags):
    label, run = next(
        (label, run) for label, run in ab_spectrum.spectrum_cases(
            torch, kernels, CPU, False)
        if label["case"] == f"spectrum_fused_ct3[exact,{flags}]")
    B, n = label["B"], label["n"]
    sp = SpectrumPipeline(fft_size=n, batches=B, device=CPU)
    iq = sp.make_input(seed=n, device=CPU)
    iq[1] = 0.0
    args = (iq, sp._win, sp._coeff, sp._scale, sp._offset)
    got = run()
    assert torch.equal(got, kernels.spectrum_fused_ct3_plain(
        *args, ep="exact", skip=tuple(flags.split(","))))
    assert not torch.equal(got, kernels.spectrum_fused_ct3_plain(*args))


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1a2b3c4d_20_channelize_demod_cu_5e6f7a8b17channelize_kernelI6__halfLi64ELb0ELi1ELi0EEEvPKT_' for 'sm_90a'
ptxas info    : Used 94 registers, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1a2b3c4d_20_channelize_demod_cu_5e6f7a8b17channelize_kernelIfLi64ELb0ELi1ELi0EEEvPKT_' for 'sm_90a'
ptxas info    : Used 109 registers, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1a2b3c4d_20_channelize_demod_cu_5e6f7a8b17scale_copy_kernelEPK6float4PS0_xif' for 'sm_90a'
ptxas info    : Used 38 registers, 0 bytes spill stores, 0 bytes spill loads
"""


def test_ptxas_report_names_every_instance_apart():
    """chip_smoke's build lines: one entry an instance, types and values
    of its template arguments kept, so that instances differing only in
    an input type do not merge."""
    usage = ab_spectrum.ptxas(PTXAS_LOG)
    named = {ab_spectrum.instance_name(k): v for k, v in usage.items()}
    assert named == {"channelize_kernel<__half,64,0,1,0>": [94, 0],
                     "channelize_kernel<float,64,0,1,0>": [109, 12],
                     "scale_copy_kernel": [38, 0]}
    assert ab_spectrum.instance_name(
        "spectrum_ct_kernelILi2ELb1ELin3EEEvPK6float2") == \
        "spectrum_ct_kernel<2,1,-3>"
    # int8_t and int16_t inputs
    assert [ab_spectrum.instance_name(f"channelize_kernelI{t}Li8ELb0EEEv")
            for t in "as"] == ["channelize_kernel<schar,8,0>",
                               "channelize_kernel<short,8,0>"]
