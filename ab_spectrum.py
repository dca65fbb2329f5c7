"""Times the kernel wrappers of one family of the ``cyberether_tpu_torch``
package found in one tree, on the card or on the CPU: one side of an A/B
of two trees.

    python3 ab_spectrum.py --tree DIR [--family spectrum|channelizer|wbfm]
                           [--device cuda|cpu]

Unpack the older commit into a directory that git ignores
(``git archive <commit> | tar -x -C build/parent``) and run the script
for both trees in one session on the card, in the order old, new, new,
old, so that a drift of the card's clock falls on both.  The families
and their cases, each through the tree's own wrapper, so that no
argument of a C entry point is declared here:

- ``spectrum`` (the default; ``csrc/spectrum_fused.cu``): K2
  (``spectrum_fused_ct5``) and K3 (``fft_pallas``) at 4096 x 2048, and
  K5 (``spectrum_fused_ct4``) at 5461 x 1536 and at 8.39 Msamp for
  several m;
- ``channelizer`` (``csrc/channelize_demod_decim.cu``): K1
  (``channelize_demod_decim``) classic and coherent, K8 (v4), K9 (v6)
  and K7 (``channelize_demod``) v1 and v2, at C=64, P=8, D=16, M=131072
  on normal frames;
- ``wbfm`` (``csrc/wbfm_fused.cu``): K4 (``wbfm_fused_v2``) classic and
  coherent (D=40) and K12 (``wbfm_fused``) at n = 8,192,000, T = 129, on
  the receiver's FM input.

On the card a case is timed by CUDA events (100 calls after 3
warm-ups, so that a 2% difference stands above the noise), and the family's source, built into that tree's ``build/``,
has its registers and spill bytes printed a kernel.  On the CPU a case
is the wall time of the wrapper's plain version (the median of 5 calls
after one) at a small size.  Prints one JSON line: the tree, the family,
the device (the card's name and power limit from nvidia-smi, or the
CPU's threads), and for each case its time and a digest of the output's
bits.
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

import numpy as np

MSAMP = 8_388_608                   # the spectrum cycle's samples a call
ITERS = 100                         # calls timed a case on the card
SOURCES = {"spectrum": "spectrum_fused.cu",
           "channelizer": "channelize_demod_decim.cu",
           "wbfm": "wbfm_fused.cu"}


def spectrum_cases(torch, kernels, dev, cuda: bool):
    """(label, run) for each case of the spectrum family."""
    from cyberether_tpu_torch.models.spectrum import SpectrumPipeline

    full = [("spectrum_fused_ct5", 4096, 2048), ("fft_pallas", 4096, 2048),
            ("spectrum_fused_ct4", 5461, 1536)] + \
        [("spectrum_fused_ct4", MSAMP // (128 * m), 128 * m)
         for m in (1, 3, 8, 16, 32)]
    if not cuda:
        full = [(name, 64, n) for name, _, n in full[:3]] + \
            [("spectrum_fused_ct4", 64, 128 * m) for m in (3, 16)]
    for name, B, n in full:
        sp = SpectrumPipeline(fft_size=n, batches=B, device=dev)
        iq = sp.make_input(seed=n, device=dev)
        iq[1] = 0.0
        wrapper = getattr(kernels, name)
        if name == "fft_pallas":
            x = torch.view_as_complex(iq)
            run = lambda w=wrapper, x=x: w(x)                  # noqa: E731
        else:
            run = (lambda w=wrapper, iq=iq, sp=sp:              # noqa: E731
                   w(iq, sp._win, sp._coeff, sp._scale, sp._offset))
        yield {"case": name, "B": B, "n": n}, run


def channelizer_cases(torch, kernels, dev, cuda: bool):
    """(label, run) for each case of the channelizer family."""
    from cyberether_tpu_torch.models.channelizer import Channelizer

    C, P, D = 64, 8, 16
    M = 131072 if cuda else 4096
    m = Channelizer(channels=C, taps_per_branch=P, audio_decim=D, device=dev)
    # normal frames from a numpy seed: the same bits in every process
    # (``make_input_full`` on the card sums its phases by a scan whose
    # float64 rounding differs from run to run)
    iq = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (M, C, 2)).astype(np.float32)).to(dev)
    x2 = iq.reshape(M, 2 * C)
    hist = torch.zeros((P, 2 * C), device=dev)
    # K7's re|im-halves rows after P - 1 zero history frames
    ext = torch.cat([torch.zeros((P - 1, 2 * C), device=dev),
                     iq.permute(0, 2, 1).reshape(M, 2 * C)]).contiguous()
    prev = torch.zeros((1, 2 * C), device=dev)
    label = {"C": C, "P": P, "D": D, "M": M}
    for mode in ("classic", "coherent"):
        yield {"case": f"channelize_demod_decim[{mode}]", **label}, \
            (lambda mode=mode: kernels.channelize_demod_decim(
                x2, hist, m.hp5, m.bperm5, m.fm_ref, D, mode))
    yield {"case": "channelize_demod_decim_v4", **label}, \
        (lambda: kernels.channelize_demod_decim_v4(x2, hist, m.bp4,
                                                   m.fm_ref, D))
    yield {"case": "channelize_demod_decim_v6", **label}, \
        (lambda: kernels.channelize_demod_decim_v6(x2, hist, m.hp5, m.bperm5,
                                                   m.fm_ref, D))
    for variant in ("v1", "v2"):
        yield {"case": f"channelize_demod[{variant}]", **label}, \
            (lambda v=variant: kernels.channelize_demod(
                ext, m.hp, m.wr, m.wi, prev, m.fm_ref, v,
                tables=m.k7_tables[v]))


def wbfm_cases(torch, kernels, dev, cuda: bool):
    """(label, run) for each case of the WBFM family."""
    from cyberether_tpu_torch.models.wbfm import WbfmReceiver

    rx = WbfmReceiver(device=dev)
    n = 8_192_000 if cuda else 128 * 640
    iq = rx.make_input(n, seed=1, device=dev)              # (n, 2)
    x = iq.T.contiguous()
    hist = torch.zeros((2, rx._taps.shape[0] - 1), device=dev)
    label = {"n": n, "T": rx._taps.shape[0]}
    for D in (0, rx.audio_decim):
        yield {"case": f"wbfm_fused_v2[{'coherent' if D else 'classic'}]",
               **label}, \
            (lambda D=D: kernels.wbfm_fused_v2(iq, rx._taps, hist, rx._ref,
                                               D))
    yield {"case": "wbfm_fused", **label}, \
        (lambda: kernels.wbfm_fused(x, rx._taps, hist, rx._ref))


FAMILIES = {"spectrum": spectrum_cases, "channelizer": channelizer_cases,
            "wbfm": wbfm_cases}


def ptxas(err: str) -> dict:
    """ptxas -v's report: {kernel: [registers, spill bytes]}."""
    out, name = {}, None
    for line in err.splitlines():
        hit = re.search(r"entry function '(\S+)'", line)
        if hit:
            # without the anonymous namespace's per-build prefix
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "",
                          hit.group(1))
            out[name] = [0, 0]
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill", line)
        if hit and name:
            out[name][1] = int(hit.group(1)) + int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            out[name][0] = int(hit.group(1))
    return out


def digest(out) -> str:
    """A digest of the bits of an output tensor, or of a tuple of them."""
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).parent,
                    help="the checkout whose package is timed")
    ap.add_argument("--family", choices=tuple(FAMILIES), default="spectrum")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    from cyberether_tpu_torch.ops import _build, kernels

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("ab_spectrum: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    rows = []
    for label, run in FAMILIES[args.family](torch, kernels, dev, cuda):
        out = run()
        if cuda:
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / ITERS
        else:
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
        rows.append({**label, "ms": ms, "bits": digest(out)})
    if cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        device = smi.stdout.strip() or torch.cuda.get_device_name(0)
    else:
        device = f"cpu, {torch.get_num_threads()} threads"
    report = {"tree": str(args.tree), "family": args.family,
              "device": device, "cases": rows}
    source = SOURCES[args.family]
    if cuda and source in _build.build_log:
        report["ptxas"] = ptxas(_build.build_log[source][1])
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
