"""Times the kernel wrappers of one family of the ``cyberether_tpu_torch``
package found in one tree, on the card or on the CPU: one side of an A/B
of two trees.

    python3 ab_spectrum.py --tree DIR
                           [--family spectrum|dft|dft_sweep|chirp_length|
                                     channelizer|wbfm|probes]
                           [--device cuda|cpu] [--route fft|split|direct]
                           [--profile]

Unpack the older commit into a directory that git ignores
(``git archive <commit> | tar -x -C build/parent``) and run the script
for both trees in one session on the card, in the order old, new, new,
old, so that a drift of the card's clock falls on both.  The families
and their cases, each through the tree's own wrapper, so that no
argument of a C entry point is declared here:

- ``spectrum`` (the default; ``csrc/spectrum_fused.cu`` and
  ``csrc/spectrum_fft.cu``): K2 (``spectrum_fused_ct5``), K3
  (``fft_pallas``), K10 (``spectrum_fused_ct``) and K11
  (``spectrum_fused_ct3``, each ``ep``, and the exact one with each
  ``skip`` flag) at 4096 x 2048, and K5 (``spectrum_fused_ct4``) at
  5461 x 1536 (m = 12) and at 8.39 Msamp for m = 1, 3, 8, 16 and 32;
- ``dft`` (``csrc/spectrum_fft.cu`` and ``csrc/spectrum_dft.cu``): K6
  (``spectrum_fused``) at 4096 x 2048, 1024 x 8192 and 5461 x 1536 (the
  FFT route where a tree has one), at 8 x 16512, 256 x 32768 and 128 x
  65536 (the split route where a tree has one, else the direct product),
  at 8.39 Msamp for n = 16, 61, 64, 100 and 127 (rows of fewer than 128
  points), 131 (a prime past 127) and 16256 = 128 x 127 (the largest
  shared-memory prime pass), and at 8 x 16768 and at 8.39 Msamp as 500 x
  16768, 255 x 32896, 128 x 65152 and 64 x 130688 (128 p for the primes
  p = 131, 257, 509, 1021: the large-prime pass where a tree has one; a
  tree that runs the direct product there takes 500 x 16768 alone, in
  DIRECT_CALLS calls), and at 37 x 1031, 37 x 16381, 8 x 131968 and 64 x
  131968 (a prime past 1021: the chirp route where a tree has one; a tree
  that runs the direct product there skips 64 x 131968, ~2 s a call, and
  takes 8 x 131968 in DIRECT_CALLS calls);
- ``dft_sweep``: K6 at 8.39 Msamp (at most the direct product's 4.19 M
  rows) for every n in 1 .. 128, for n = p 2^a up to 4096 with a
  prime p of 11 .. 127, and for n = 16512, 32768, 65536 and 131072, one
  input cut into rows;
  with ``--route`` (a tree with ``kernels.k6_route``) every case runs on
  that route ("split": every case whose n ``kernels.k6_split`` splits;
  the others keep the tree's route), for the crossover of the routes;
- ``chirp_length``: K6's chirp route at 8 x 131968 and 64 x 131968 over
  each convolution length of CHIRP_LENGTHS (``kernels.chirp_length``
  replaced), the lengths its passes could take;
- ``channelizer`` (``csrc/channelize_demod_decim.cu``): K1
  (``channelize_demod_decim``) classic and coherent and from int8 and
  int16 frames, K8 (v4), K9 (v6), K7 (``channelize_demod``) v1 and v2
  and K16 (``channelize_ablate``) at each instance, at C=64, P=8, D=16,
  M=131072 on normal frames, and K1 classic and K9 at C=8, 16 and 32 on
  the same samples;
- ``wbfm`` (``csrc/wbfm_fused.cu``): K4 (``wbfm_fused_v2``) classic and
  coherent (D=40) and K12 (``wbfm_fused``) at n = 8,192,000, T = 129, on
  the receiver's FM input;
- ``probes`` (``csrc/platform_probe.cu`` and ``csrc/stream_probe.cu``,
  through ``ops/probe_kernels.py``): K13 (``scale_copy``, s = 2 and 1),
  K14 (``staged_copy`` at stage sizes 4096, 16384 and 65536, each
  between two ``x.clone()`` cases, the library's copy) and K15
  (``tile_dot``, each mode at each rows a block of
  ``probes.platform_probe.DOT_ROWS_PER_BLOCK``) at (131072, 128) float32
  rows, each mode's input type for K15.

On the card a case is timed by CUDA events (100 calls after 3
warm-ups, so that a 2% difference stands above the noise; the probes,
whose kernels take less than a call's host time, by the probes' own
``chain_ms``: runs of 33 and of 1 calls queued behind a spin of the
card), with ``--profile`` also by torch.profiler (the device time of
each kernel a call, over 10 calls: where the host's time to issue a
call exceeds its device time, events read the host), and the
family's sources that the tree has, built into that tree's ``build/``,
have their registers and spill bytes printed a kernel.  On the CPU a case
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
DIRECT_CALLS = 3                    # ... on the direct product at 8.39 Msamp
# the large primes' spectrum sizes at 8.39 Msamp: (B, 128 p)
LARGE_PRIME_SHAPES = ((500, 16768), (255, 32896), (128, 65152),
                      (64, 130688))
# a prime past 1021 (the chirp route): (B, n)
CHIRP_SHAPES = ((37, 1031), (37, 16381), (8, 131968), (64, 131968))
# convolution lengths of the chirp route at 131968 points: 5 x 2^16
# (chirp_length's), 3 x 2^17 and 2^19 (a length with no power-of-two
# factor from 128, such as 504 x 525, has no column instance)
CHIRP_LENGTHS = (327680, 393216, 524288)
SOURCES = {"spectrum": ("spectrum_fused.cu", "spectrum_fft.cu"),
           "dft": ("spectrum_dft.cu", "spectrum_fft.cu"),
           "dft_sweep": ("spectrum_dft.cu", "spectrum_fft.cu"),
           "chirp_length": ("spectrum_fft.cu",),
           "channelizer": ("channelize_demod_decim.cu",),
           "wbfm": ("wbfm_fused.cu",),
           "probes": ("platform_probe.cu", "stream_probe.cu")}


def spectrum_cases(torch, kernels, dev, cuda: bool):
    """(label, run) for each case of the spectrum family."""
    full = [("spectrum_fused_ct5", 4096, 2048), ("fft_pallas", 4096, 2048),
            ("spectrum_fused_ct4", 5461, 1536),
            ("spectrum_fused_ct", 4096, 2048)] + \
        [(f"spectrum_fused_ct3[{ep}]", 4096, 2048)
         for ep in ("exact", "approx", "none", "exact,s1", "exact,tw",
                    "exact,s2", "exact,s1,tw,s2")] + \
        [("spectrum_fused_ct4", MSAMP // (128 * m), 128 * m)
         for m in (1, 3, 8, 16, 32)]
    if not cuda:
        full = [(name, 64, n) for name, _, n in full[:11]] + \
            [("spectrum_fused_ct4", 64, 128 * m) for m in (3, 16)]
    yield from _fused_cases(torch, kernels, dev, full)


def dft_cases(torch, kernels, dev, cuda: bool):
    """(label, run) for each case of the dft family."""
    full = [("spectrum_fused", 4096, 2048), ("spectrum_fused", 1024, 8192),
            ("spectrum_fused", 5461, 1536), ("spectrum_fused", 8, 16512),
            ("spectrum_fused", 256, 32768), ("spectrum_fused", 128, 65536)] \
        + [("spectrum_fused", MSAMP // n, n)
           for n in (16, 61, 64, 100, 127, 131, 16256)] \
        + [("spectrum_fused", 8, 16768)] \
        + [("spectrum_fused", B, n) for B, n in LARGE_PRIME_SHAPES
           if kernels.k6_route(n) != "direct" or n == 16768] \
        + [("spectrum_fused", B, n) for B, n in CHIRP_SHAPES
           if kernels.k6_route(n) != "direct" or B * n < MSAMP]
    if not cuda:
        full = [("spectrum_fused", 8, n) for n in (384, 2048, 1536, 127,
                                                   131, 1021, 1031)] + \
            [("spectrum_fused", 2, n) for n in (16512, 16768)]
    for label, run in _fused_cases(torch, kernels, dev, full):
        if cuda and label["B"] * label["n"] > 1 << 20 and \
                kernels.k6_route(label["n"]) == "direct":
            label["calls"] = DIRECT_CALLS
        yield label, run


SWEEP_PRIMES = (11, 13, 31, 61, 127)
SWEEP_SPLIT_SIZES = (16512, 32768, 65536, 131072)
DIRECT_MAX_ROWS = 65535 * 64        # csrc/spectrum_dft.cu: 65535 row tiles


def dft_sweep_cases(torch, kernels, dev, cuda: bool):
    """(label, run) for each case of the dft_sweep family: the rows of
    one input of 8.39 Msamp (on the CPU, 4096 samples)."""
    from cyberether_tpu_torch.models.spectrum import SpectrumPipeline

    total = MSAMP if cuda else 4096
    sizes = sorted(set(range(1, 129)) | {
        p << a for p in SWEEP_PRIMES for a in range(13)
        if 128 < p << a <= 4096} | {
        n for n in SWEEP_SPLIT_SIZES if n <= total})
    rng = np.random.default_rng(1)
    base = torch.from_numpy(rng.standard_normal((total, 2), np.float32)) \
        .to(dev)
    for n in sizes:
        B = min(total // n, DIRECT_MAX_ROWS)
        iq = base[:B * n].reshape(B, n, 2)
        sp = SpectrumPipeline(fft_size=n, batches=B, device=dev)
        yield {"case": "spectrum_fused", "B": B, "n": n}, \
            (lambda iq=iq, sp=sp: kernels.spectrum_fused(
                iq, sp._win, sp._coeff, sp._scale, sp._offset))


def chirp_length_cases(torch, kernels, dev, cuda: bool):
    """(label, run) for each case of the chirp_length family: each run
    sets ``kernels.chirp_length`` to its length before the call."""
    shapes = ((8, 131968), (64, 131968)) if cuda else ((2, 1031),)
    lengths = CHIRP_LENGTHS if cuda else (2560, 3072, 4096)
    own = kernels.chirp_length
    for (label, run), M in ((case, M) for case in _fused_cases(
            torch, kernels, dev, [("spectrum_fused", B, n)
                                  for B, n in shapes]) for M in lengths):
        def forced(run=run, M=M):
            kernels.chirp_length = lambda n: M
            try:
                return run()
            finally:
                kernels.chirp_length = own
        yield {**label, "M": M}, forced


def _fused_cases(torch, kernels, dev, cases):
    """(label, run) for each (wrapper name, B, n): K3 on the complex
    view of a spectrum input, the others on the input and the
    pipeline's constants; "name[ep]" passes ``ep``, and
    "name[ep,flag,...]" also ``skip``."""
    from cyberether_tpu_torch.models.spectrum import SpectrumPipeline

    for name, B, n in cases:
        sp = SpectrumPipeline(fft_size=n, batches=B, device=dev)
        iq = sp.make_input(seed=n, device=dev)
        iq[1] = 0.0
        base, _, inner = name.rstrip("]").partition("[")
        wrapper = getattr(kernels, base)
        ep, *skip = inner.split(",")
        kw = {"ep": ep} if ep else {}
        if skip:
            kw["skip"] = tuple(skip)
        if name == "fft_pallas":
            x = torch.view_as_complex(iq)
            run = lambda w=wrapper, x=x: w(x)                  # noqa: E731
        else:
            run = (lambda w=wrapper, iq=iq, sp=sp, kw=kw:       # noqa: E731
                   w(iq, sp._win, sp._coeff, sp._scale, sp._offset, **kw))
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
    # integer ingest: the frames scaled to the type's full range
    for dtype, full in ((torch.int8, 127), (torch.int16, 32767)):
        q = torch.round(x2 * (full / float(x2.abs().max()))).clamp(
            -full, full).to(dtype)
        qz = torch.zeros((P, 2 * C), dtype=dtype, device=dev)
        yield {"case": f"channelize_demod_decim[{str(dtype)[6:]}]",
               **label}, \
            (lambda q=q, qz=qz: kernels.channelize_demod_decim(
                q, qz, m.hp5, m.bperm5, m.fm_ref, D))
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
    for stage in kernels.CHANNELIZE_ABLATE_INSTANCES:
        yield {"case": f"channelize_ablate[{stage}]", **label}, \
            (lambda stage=stage: kernels.channelize_ablate(
                x2, hist, m.hp5, m.bperm5, m.fm_ref, D, stage))
    # K1 and K9 at the other C, on as many samples
    for c in (8, 16, 32):
        mc = Channelizer(channels=c, taps_per_branch=P, audio_decim=D,
                         sample_rate=c * 2e6, device=dev)
        xc = iq.reshape(-1, 2 * c)
        hc = torch.zeros((P, 2 * c), device=dev)
        small = {"C": c, "P": P, "D": D, "M": xc.shape[0]}
        yield {"case": "channelize_demod_decim[classic]", **small}, \
            (lambda mc=mc, xc=xc, hc=hc: kernels.channelize_demod_decim(
                xc, hc, mc.hp5, mc.bperm5, mc.fm_ref, D))
        yield {"case": "channelize_demod_decim_v6", **small}, \
            (lambda mc=mc, xc=xc, hc=hc: kernels.channelize_demod_decim_v6(
                xc, hc, mc.hp5, mc.bperm5, mc.fm_ref, D))


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


def probe_cases(torch, kernels, dev, cuda: bool):
    """(label, run) for each case of the probes family."""
    from cyberether_tpu_torch.ops import probe_kernels as pk
    from cyberether_tpu_torch.probes.platform_probe import \
        DOT_ROWS_PER_BLOCK

    rows = 131072 if cuda else 256
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((rows, pk.WIDTH),
                                             np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((pk.WIDTH, pk.WIDTH),
                                             np.float32)).to(dev)
    for s in (2.0, 1.0):
        yield {"case": f"scale_copy[s={s:g}]", "rows": rows}, \
            (lambda s=s: pk.scale_copy(x, s))
    clone = ({"case": "x.clone()", "rows": rows}, lambda: x.clone())
    yield clone
    for sb in (4096, 16384, 65536):
        yield {"case": f"staged_copy[{sb}]", "rows": rows}, \
            (lambda sb=sb: pk.staged_copy(x, sb))
        yield clone
    for mode, (_, dtype) in pk.TILE_DOT_MODES.items():
        xm, bm = x.to(dtype), b.to(dtype)
        for rpb in DOT_ROWS_PER_BLOCK:
            yield {"case": f"tile_dot[{mode}]", "rows": rows,
                   "rows_per_block": rpb}, \
                (lambda xm=xm, bm=bm, mode=mode, rpb=rpb:
                 pk.tile_dot(xm, bm, mode, rpb))


FAMILIES = {"spectrum": spectrum_cases, "dft": dft_cases,
            "dft_sweep": dft_sweep_cases, "chirp_length": chirp_length_cases,
            "channelizer": channelizer_cases, "wbfm": wbfm_cases,
            "probes": probe_cases}


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


BUILTIN_TYPES = {"f": "float", "d": "double", "b": "bool", "c": "char",
                 "a": "schar", "h": "uchar", "s": "short", "t": "ushort",
                 "i": "int", "j": "unsigned", "l": "long", "m": "ulong",
                 "x": "llong", "y": "ullong"}


def instance_name(mangled: str) -> str:
    """A kernel instance's name from ``ptxas``'s key: the function and
    its template arguments, values and types (``?`` where the mangling
    goes past what is read here)."""
    hit = re.match(r"[A-Za-z0-9_]+?_kernel", mangled)
    if not hit:
        return mangled
    if not mangled.startswith("I", hit.end()):
        return hit.group(0)
    args, i = [], hit.end() + 1
    while i < len(mangled) and mangled[i] != "E":
        value = re.match(r"L[a-z](n?\d+)E", mangled[i:])
        named = re.match(r"\d+", mangled[i:])
        if value:
            args.append(value.group(1).replace("n", "-"))
            i += value.end()
        elif named:
            start = i + named.end()
            args.append(mangled[start:start + int(named.group(0))])
            i = start + int(named.group(0))
        elif mangled[i] in BUILTIN_TYPES:
            args.append(BUILTIN_TYPES[mangled[i]])
            i += 1
        else:
            args.append("?")
            break
    return f"{hit.group(0)}<{','.join(args)}>"


def profile_ms(torch, run, calls: int = 10) -> dict:
    """Device ms a call of ``run`` by kernel name, from torch.profiler
    over ``calls`` calls after one."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / calls / 1e3
    return per


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
    ap.add_argument("--route", choices=("fft", "split", "direct"),
                    help="run K6 on this route whatever n (replaces the "
                         "tree's kernels.k6_route; split: where n splits)")
    ap.add_argument("--profile", action="store_true",
                    help="also each case's device time by torch.profiler")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    from cyberether_tpu_torch.ops import _build, kernels

    if args.route:
        own = kernels.k6_route
        kernels.k6_route = lambda n, route=args.route: (
            route if route != "split" or kernels.k6_split(n) else own(n))
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("ab_spectrum: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    chain_ms = None
    if cuda and args.family == "probes":
        from cyberether_tpu_torch.probes.common import chain_ms
    rows = []
    for label, run in FAMILIES[args.family](torch, kernels, dev, cuda):
        out = run()
        if chain_ms:
            ms = chain_ms(run)
        elif cuda:
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            calls = label.get("calls", ITERS)
            start.record()
            for _ in range(calls):
                run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / calls
        else:
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
        row = {**label, "ms": ms, "bits": digest(out)}
        if cuda and args.profile:
            row["kernels_ms"] = profile_ms(torch, run)
            row["device_ms"] = sum(row["kernels_ms"].values())
        rows.append(row)
    if cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        device = smi.stdout.strip() or torch.cuda.get_device_name(0)
    else:
        device = f"cpu, {torch.get_num_threads()} threads"
    report = {"tree": str(args.tree), "family": args.family,
              "route": args.route, "device": device, "cases": rows}
    if cuda:
        # an older tree keeps no report beside its libraries: it gives
        # ptxas's only for the sources this process built
        logs = ({s: _build.report(s) for s in SOURCES[args.family]}
                if hasattr(_build, "report") else
                {s: _build.build_log[s][1] for s in SOURCES[args.family]
                 if s in _build.build_log})
        if logs:
            report["ptxas"] = {s: ptxas(log) for s, log in logs.items()}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
