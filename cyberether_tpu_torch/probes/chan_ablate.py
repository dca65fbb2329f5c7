"""Channelizer stage ablation: where K1's step time goes on this card.
K16 (``channelize_ablate``) runs the v5 step's split form with one stage
compiled out at a time, beside K1's own call on the same buffers; before
them, the matrix-unit calibration and the correctness lines of the TPU
script.

The counterpart of the JAX package's ``tools/ablation/chan_ablate.py``:
its seven Pallas bodies (``k_full`` .. ``k_fullrate``) become six
instances of K1's tensor-core template (``channelize_tc_kernel``, the
3xTF32 ``wgmma`` product; ``reshape_mean`` computes ``full``'s function
and runs that instance), its halo array a zero history (what its first
halo gives), its selector product the kernel's boxcar mean.  The
template runs its phases in turn (window, FIR, product, y rows, then
the epilogue), so a stage's time less ``full``'s is the cost of the
phases it takes out; ``full`` less K1 is the 5-term atan2 with a true
division against K1's 3-term one.  Each time is the difference of
chains of k and 1 calls.

    python -m cyberether_tpu_torch.probes.chan_ablate

prints one line per measurement, then the whole as one JSON line.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable

import numpy as np
import torch

from cyberether_tpu_torch.models.channelizer import Channelizer
from cyberether_tpu_torch.ops.kernels import CHANNELIZE_ABLATE_INSTANCE_OF, \
    CHANNELIZE_ABLATE_STAGES, channelize_ablate, channelize_demod_decim
from cyberether_tpu_torch.probes.common import card, chain_ms, require_card
from cyberether_tpu_torch.probes.platform_probe import library_product, \
    tf32

C, P, D, M = 64, 8, 16, 1 << 17       # the TPU script's channelizer step
CHECK_FRAMES = 8192                   # its correctness lines' input
# its matrix-unit calibration: (mode, dtype, n) products of n^3
CALIBRATION = (("fp32", torch.float32, 4096), ("bf16", torch.bfloat16, 4096),
               ("bf16", torch.bfloat16, 8192))
# each stage's cost, as the difference of two stages' times:
# (name, minuend, subtrahend); a subtrahend None takes the time itself,
# PRODUCTION K1's call on the same buffers
PRODUCTION = "K1"
STAGE_COSTS = (("FIR", "full", "no_fir"),
               ("atan2", "full", "no_atan"),
               ("lag and demod", "full", "no_demod"),
               ("full-rate write less decimation", "full_rate", "full"),
               ("DFT, staging and decimation", "matmul_only", None),
               ("5-term atan2 and division less K1's 3-term", "full",
                PRODUCTION))


def measure(device: "str | torch.device" = "cuda") -> Dict[str, object]:
    """Every line of the channelizer ablation, on the card ``device``."""
    dev = require_card(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    out: Dict[str, object] = {"card": card(dev)}

    calibration = []
    for mode, dtype, n in CALIBRATION:
        a = (torch.randn((n, n), device=dev, generator=gen) * 0.01).to(dtype)
        b = (torch.randn((n, n), device=dev, generator=gen) * 0.01).to(dtype)
        with tf32(False):
            call, name = library_product(a, b)
            ms = chain_ms(call, k=9, reps=3)
        calibration.append({"what": f"{name} {mode} {n}", "mode": mode,
                            "n": n, "ms": ms,
                            "TFLOP/s": 2 * n ** 3 / ms / 1e9})
        del a, b
    out["calibration"] = calibration

    model = Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                        device=dev)
    with tf32(False):
        iq = model.make_input_full(CHECK_FRAMES, device=dev)
        ref, _ = model.step(model.init_state(), iq)
        correctness = []
        for kernel in ("v4", "v5"):
            got, _ = model.step_kernel(model.init_state_v4(), iq,
                                       kernel=kernel)
            correctness.append({
                "what": f"step_kernel(kernel={kernel!r}) vs step, "
                        f"make_input_full({CHECK_FRAMES})",
                "max_abs_err": float((got - ref).abs().max())})
    out["correctness"] = correctness

    rng = np.random.default_rng(1)
    x2 = torch.from_numpy(rng.standard_normal((M, C, 2)).astype(
        np.float32)).to(dev).reshape(M, 2 * C)
    hist = torch.zeros((P, 2 * C), device=dev)
    args = (x2, hist, model.hp5, model.bperm5, model.fm_ref, D)
    stages = []
    for stage in CHANNELIZE_ABLATE_STAGES:
        ms = chain_ms(lambda s=stage: channelize_ablate(*args, s))
        stages.append({"stage": stage,
                       "instance": CHANNELIZE_ABLATE_INSTANCE_OF[stage],
                       "ms": ms, "Gsamp/s": M * C / ms / 1e6})
    out["stages"] = stages
    ms = chain_ms(lambda: channelize_demod_decim(*args))
    out["production"] = {"what": "channelize_demod_decim (K1)", "ms": ms,
                         "Gsamp/s": M * C / ms / 1e6}
    by = {s["stage"]: s["ms"] for s in stages}
    by[PRODUCTION] = ms
    out["stage_costs"] = {name: by[a] - (by[b] if b else 0.0)
                          for name, a, b in STAGE_COSTS}
    return out


def lines(result: Dict[str, object]) -> Iterable[str]:
    """The result as the TPU script prints it: one line a measurement."""
    c = result["card"]
    yield f"card: {c['name']}, power limit {c['power_limit']}"
    for e in result["calibration"]:
        yield f"{e['what']}: {e['ms']:.3f} ms = {e['TFLOP/s']:.1f} TFLOP/s"
    for e in result["correctness"]:
        yield f"{e['what']}: max err {e['max_abs_err']:.3e}"
    for e in result["stages"]:
        ran = "" if e["instance"] == e["stage"] else \
            f" (runs {e['instance']}'s instance)"
        yield (f"{e['stage']}{ran}: {e['ms']:.4f} ms = {e['Gsamp/s']:.2f} "
               "Gsamp/s")
    p = result["production"]
    yield f"production {p['what']}: {p['ms']:.4f} ms = {p['Gsamp/s']:.2f} " \
          "Gsamp/s"
    for name, ms in result["stage_costs"].items():
        yield f"stage cost, {name}: {ms:.4f} ms"


def main() -> int:
    result = measure()
    for line in lines(result):
        print(line, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
