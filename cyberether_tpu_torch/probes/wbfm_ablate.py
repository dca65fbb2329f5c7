"""WBFM stage ablation: where K12's time goes on this card.  K17
(``wbfm_ablate``) runs K12's kernel with stages compiled out, beside
K12's own call (``wbfm_fused``) on the same input.

The counterpart of the JAX package's ``tools/ablation/wbfm_ablate.py``,
at its size: n = 2^22 samples, its 129 Hamming-windowed sinc taps, gain
1, a zero history.  Its ``shift`` variants take y[j-1] by a roll of y
instead of a second band matrix; K12's kernel always takes it from its
neighbour in shared memory, so ``shift`` runs ``full``'s instance and
``shiftnoat`` ``noatan``'s.  Each time is the difference of chains of k
and 1 calls.

    python -m cyberether_tpu_torch.probes.wbfm_ablate

prints one line per measurement, then the whole as one JSON line.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable

import numpy as np
import torch

from cyberether_tpu_torch.ops.kernels import WBFM_ABLATE_INSTANCE_OF, \
    WBFM_ABLATE_STAGES, wbfm_ablate, wbfm_fused
from cyberether_tpu_torch.probes.common import card, chain_ms, require_card

N, T = 1 << 22, 129                   # the TPU script's
GAIN = 1.0
# each stage's cost: (name, minuend, subtrahend or None: the time itself)
STAGE_COSTS = (("atan2", "full", "noatan"),
               ("lag path", "noatan", "onlyfir"),
               ("FIR, staging and write", "onlyfir", None))


def script_taps(t: int = T) -> np.ndarray:
    """The TPU script's taps: a Hamming-windowed sinc, unit DC gain."""
    h = np.hamming(t) * np.sinc(0.4 * (np.arange(t) - (t - 1) / 2))
    return (h / h.sum()).astype(np.float32)


def measure(device: "str | torch.device" = "cuda") -> Dict[str, object]:
    """Every line of the WBFM ablation, on the card ``device``."""
    dev = require_card(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, N)).astype(
        np.float32)).to(dev)
    taps = torch.from_numpy(script_taps()).to(dev)
    hist = torch.zeros((2, T - 1), device=dev)
    variants = []
    for stage in WBFM_ABLATE_STAGES:
        ms = chain_ms(lambda s=stage: wbfm_ablate(x, taps, hist, GAIN, s))
        variants.append({"stage": stage,
                         "instance": WBFM_ABLATE_INSTANCE_OF[stage],
                         "ms": ms, "Gsamp/s": N / ms / 1e6})
    ms = chain_ms(lambda: wbfm_fused(x, taps, hist, GAIN))
    by = {v["stage"]: v["ms"] for v in variants}
    return {"card": card(dev), "n": N, "taps": T, "variants": variants,
            "production": {"what": "wbfm_fused (K12)", "ms": ms,
                           "Gsamp/s": N / ms / 1e6},
            "stage_costs": {name: by[a] - (by[b] if b else 0.0)
                            for name, a, b in STAGE_COSTS}}


def lines(result: Dict[str, object]) -> Iterable[str]:
    c = result["card"]
    yield f"card: {c['name']}, power limit {c['power_limit']}"
    yield f"n={result['n']} samples, {result['taps']} taps"
    for v in result["variants"]:
        ran = "" if v["instance"] == v["stage"] else \
            f" (runs {v['instance']}'s instance)"
        yield (f"{v['stage']}{ran}: {v['ms']:.4f} ms  {v['Gsamp/s']:.2f} "
               "Gsamp/s")
    p = result["production"]
    yield f"prod {p['what']}: {p['ms']:.4f} ms  {p['Gsamp/s']:.2f} Gsamp/s"
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
