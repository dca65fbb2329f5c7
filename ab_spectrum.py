"""Times the fused spectrum and FFT wrappers of the
``cyberether_tpu_torch`` package found in one tree, on the card or on the
CPU: one side of an A/B of two trees.

    python3 ab_spectrum.py --tree DIR [--device cuda|cpu]

Unpack the older commit into a directory that git ignores
(``git archive <commit> | tar -x -C build/parent``) and run the script
for both trees in one session on the card, in the order old, new, new,
old, so that a drift of the card's clock falls on both.  The cases are
K2 (``spectrum_fused_ct5``) and K3 (``fft_pallas``) at 4096 x 2048, and
K5 (``spectrum_fused_ct4``) at 5461 x 1536 and at 8.39 Msamp for several
m; each runs through the tree's own wrapper, so its arguments are never
declared here.  On the card a case is timed by CUDA events (20 calls
after 3 warm-ups), and the tree's ``csrc/spectrum_fused.cu``, built into
that tree's ``build/``, has its registers and spill bytes printed a
kernel.  On the CPU a case is the wall time of the wrapper's plain
version (the median of 5 calls after one) at 64 rows.  Prints one JSON
line: the tree, the device (the card's name and power limit from
nvidia-smi, or the CPU's threads), and for each case its time and a
digest of the output's bits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

MSAMP = 8_388_608                   # the spectrum cycle's samples a call


def cases(B_cpu: int | None):
    """(wrapper, B, n) for each case; ``B_cpu`` replaces B on the CPU."""
    full = [("spectrum_fused_ct5", 4096, 2048), ("fft_pallas", 4096, 2048),
            ("spectrum_fused_ct4", 5461, 1536)] + \
        [("spectrum_fused_ct4", MSAMP // (128 * m), 128 * m)
         for m in (1, 3, 8, 16, 32)]
    if B_cpu is None:
        return full
    return [(name, B_cpu, n) for name, _, n in full[:3]] + \
        [("spectrum_fused_ct4", B_cpu, 128 * m) for m in (3, 16)]


def ptxas(err: str) -> dict:
    """ptxas -v's report: {kernel: [registers, spill bytes]}."""
    out, name = {}, None
    for line in err.splitlines():
        hit = re.search(r"entry function '(\S+)'", line)
        if hit:
            name = hit.group(1)
            out[name] = [0, 0]
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill", line)
        if hit and name:
            out[name][1] = int(hit.group(1)) + int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            out[name][0] = int(hit.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).parent,
                    help="the checkout whose package is timed")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    from cyberether_tpu_torch.models.spectrum import SpectrumPipeline
    from cyberether_tpu_torch.ops import _build, kernels

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("ab_spectrum: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    rows = []
    for name, B, n in cases(None if cuda else 64):
        sp = SpectrumPipeline(fft_size=n, batches=B, device=dev)
        iq = sp.make_input(seed=n, device=dev)
        iq[1] = 0.0
        wrapper = getattr(kernels, name)
        if name == "fft_pallas":
            x = torch.view_as_complex(iq)
            run = lambda: wrapper(x)                           # noqa: E731
        else:
            run = lambda: wrapper(iq, sp._win, sp._coeff,     # noqa: E731
                                  sp._scale, sp._offset)
        out = run()
        if cuda:
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 20
        else:
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
        bits = out.detach().cpu().contiguous().numpy().tobytes()
        rows.append({"case": name, "B": B, "n": n, "ms": ms,
                     "bits": hashlib.sha256(bits).hexdigest()[:16]})
    if cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        device = smi.stdout.strip() or torch.cuda.get_device_name(0)
    else:
        device = f"cpu, {torch.get_num_threads()} threads"
    report = {"tree": str(args.tree), "device": device, "cases": rows}
    if cuda and "spectrum_fused.cu" in _build.build_log:
        report["ptxas"] = ptxas(_build.build_log["spectrum_fused.cu"][1])
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
