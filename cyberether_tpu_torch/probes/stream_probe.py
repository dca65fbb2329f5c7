"""Stream probe: the card's streaming floor over the channelizer's
(131072, 128) float32 working set, through K13 (``scale_copy`` with
s = 1, by rows a block) and K14 (``staged_copy``, a copy through two
shared-memory stages filled by ``cp.async``, by stage size), beside
PyTorch's ``x + 1`` and ``x.clone()``.

The counterpart of the JAX package's ``tools/ablation/stream_probe.py``:
its auto-pipelined copy by block size becomes K13, its hand
double-buffered DMA by chunk K14, and its XLA stream PyTorch's.  Each
time is the difference of chains of k and 1 calls, as its
``chain_time`` takes it.

    python -m cyberether_tpu_torch.probes.stream_probe

prints one line per measurement, then the whole as one JSON line.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable

import torch

from cyberether_tpu_torch.ops.probe_kernels import scale_copy, staged_copy
from cyberether_tpu_torch.probes.common import ROWS, WIDTH, card, \
    chain_ms, chained, rate, require_card
from cyberether_tpu_torch.probes.platform_probe import ROWS_PER_BLOCK

STAGE_BYTES = (4096, 16384, 32768, 65536)


def measure(device: "str | torch.device" = "cuda") -> Dict[str, object]:
    """Every line of the stream probe, on the card ``device``."""
    dev = require_card(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((ROWS, WIDTH), device=dev, generator=gen)
    moved = 2 * x.numel() * 4
    streaming = []
    for what, step in [
            ("torch x + 1", lambda y: y + 1.0),
            ("torch x.clone()", lambda y: y.clone())] + [
            (f"scale_copy s=1 rows_per_block={r}",
             lambda y, r=r: scale_copy(y, 1.0, r)) for r in ROWS_PER_BLOCK] + [
            (f"staged_copy stage_bytes={s}",
             lambda y, s=s: staged_copy(y, s)) for s in STAGE_BYTES]:
        ms = chain_ms(chained(step, x))
        entry = {"what": what, "ms": ms, "GB/s": rate(moved, ms)}
        if what.startswith(("scale_copy", "staged_copy")):
            entry["kernel"] = what.split()[0]
        streaming.append(entry)
    return {"card": card(dev), "streaming": streaming}


def lines(result: Dict[str, object]) -> Iterable[str]:
    c = result["card"]
    yield f"card: {c['name']}, power limit {c['power_limit']}"
    for s in result["streaming"]:
        yield (f"{s['what']} ({ROWS}, {WIDTH}) f32: {s['ms']:.4f} ms = "
               f"{s['GB/s']:.0f} GB/s (read + write)")


def main() -> int:
    result = measure()
    for line in lines(result):
        print(line, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
