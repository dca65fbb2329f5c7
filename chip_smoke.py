#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cyberether_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one line each on stdout:

1. build: every CUDA source under ``cyberether_tpu_torch/csrc/`` with
   nvcc for sm_90a, one nvcc per source, all started together; then
   load each; each source's nvcc time and ptxas's registers and spill
   bytes, kernel instance by instance, the instances K1 and K9 launch
   at the path's C (``kernels.k1_instance``) and K16's at each stage and
   C (``kernels.k16_instance``; one that spills fails the phase).
2. kernel vs plain: each kernel against its plain PyTorch version at its
   path's full width, max abs error <= 1e-4:
   - channelize_demod_decim (K1, the tensor-core template: C=64, P=8,
     D=16, M=131072 frames): classic and coherent, f32/int8/int16
     ingest, a non-zero history, a stream split in two at half and at a
     frame that is no multiple of 64;
   - channelize_demod_decim_v4 (K8, the taps folded into P matrices) and
     channelize_demod_decim_v6 (K9, the 5-term atan2 on an approximate
     reciprocal, K1's template) at the same width: a zero and a non-zero
     history, a stream split in two at the same frames, and C=8, P=4,
     D=4, M=1024;
   - channelize_demod (K7, v1 and v2: undecimated, re|im-halves rows, the
     lag frame carried in prev) at the same width: demod and ylast, a
     stream split in two with ylast carried into the second call's prev,
     and C=8, P=4, M=1024;
   - wbfm_fused_v2 (n=8192000 samples, T=129, D=40): classic and
     coherent, and wbfm_fused (the same, planar input): a zero and a
     non-zero history, a stream split in two, and a small odd shape;
   - spectrum_fused_ct5 (B=4096 rows of n=2048, one row all zeros):
     values, the argmax bin of every row, and exactly 0 on the zero row;
     then every n from 128 to 4096 on 37 rows;
   - fft_pallas (K3, the Stockham core of ``csrc/spectrum_fft.cu``;
     B=4096 rows of n=2048 complex64): against its plain version, the
     plain model of its passes (``stockham_fft_plain``) and a complex128
     ``torch.fft.fft`` truth, within 1e-5 of max|X|; then every n from
     128 to 4096 on 37 rows, a (2, 3, 1024) leading shape, and the
     ``fft`` module's unnormalized backward round trip (n x within 1e-2);
   - spectrum_fused (K6) on its FFT route (the same core) at B=4096 x
     n=2048 on the spectrum's buffer, at B=1024 x n=8192, at B=5461 x
     n=1536 (the runtime plan, 8 8 8 3), and at every n of K6_SIZES on 37
     rows (131, 1021 and 2042 on the large-prime pass), also against the
     plain model of its passes
     (``spectrum_fft_plain``, 1e-4); on its split route (two passes
     of the core, past the FFT route's 16384 points) at every (B, n) of
     SPLIT_SHAPES: 8 x 16512 = 128 x 129, and the spectrum cycle's 8.39
     Msamp as 256 x 32768 and 128 x 65536, also against the plain model
     of its passes (``spectrum_split_plain``, 1e-4; at 8.39 Msamp the
     float64 product on PLAIN_ROWS rows), with its p-point rows on the
     large-prime pass at 8 x 16768 and at 8.39 Msamp as 500 x 16768, 255
     x 32896, 128 x 65152 and 64 x 130688 (128 p, p = 131, 257, 509,
     1021), and with the prime first (pass A's columns on the large-prime
     pass) at 8 x 33536 and 250 x 33536 (131 x 256); on its chirp route
     (Bluestein's transform on the core's passes) at every n of
     K6_CHIRP_SIZES on 37 rows (a prime past 1021: one launch over M =
     2560; 2062 and 4099: one launch on 512 threads; the largest prime
     below 16384: three over M = 32768 = 128 x 256; 16411: 256 x 160), at
     every (B, n) of CHIRP_SHAPES (8 x 131968 = 8 x 128 x 1031, and 8.45
     Msamp as 64 x 131968: three launches over M = 327680 = 512 x 640)
     and of CHIRP_CHECK_SHAPES (2 rows of 128 x 2053: 1024 x 640; of
     1310723: 2048 x 1536; of 128 x 65537: 4096 x 5120, pass B on 512
     threads), also against the model of its steps
     (``spectrum_chirp_plain``, 1e-4; the float64 product on PLAIN_ROWS
     rows, and on no row past PLAIN_MAX_SAMPLES points, where the model
     of its steps takes its place); the direct product
     (``csrc/spectrum_dft.cu``, which keeps the n past 25165824
     that do not split) with
     ``kernels.k6_route`` forced to "direct" at every n of
     K6_DIRECT_SIZES on 37 rows; each launch's
     route checked; spectrum_fused_ct4 (K5) at B=5461 x n=1536 (m = 12)
     and at every m from 1 to 32 on 37 rows: each with zero rows, against
     its plain version (1e-4, the argmax bin of every row, for n <= 3
     but for bins the float64 truth ties, exactly 0 on a zero row) and a complex128
     truth (1e-3).
3. paths, each driven with every launch counter set to 0 just before it
   and read just after, on three buffers against the plain version
   chained over the same buffers:
   - the flowgraph dti -> squelch -> channelizer; then a silent buffer
     leaves the output invalid and the channelizer's state unchanged;
   - ``Channelizer.step_carry_kernel`` (K7) with variant v1, then v2, and
     ``Channelizer.step_kernel`` with kernel v4 (K8), then v6 (K9), on
     the channelizer path's buffers, state carried; K7's steps also
     against the model's reference ``step`` (torch.atan2);
   - the flowgraph dti -> wbfm, classic, then coherent;
   - ``WbfmReceiver.step_kernel(version="v1")``;
   - the flowgraph dti -> spectrum (B=4096, n=2048, CF32);
   - the flowgraph dti -> fft (provider pallas, B=4096, n=2048, CF32),
     forward, then backward;
   - the flowgraph dti -> spectrum_engine at the benchmark's
     configuration (512 x 2048 F32, enableScale), then at 4096 x 2048
     CF32 with range -100..0 on the spectrum path's buffers, where it
     also agrees with the fused spectrum block;
   - the flowgraph dti -> spectrum with algorithm dft on the spectrum
     path's buffers (K6's FFT route; it also agrees with the ct5 route
     there), then with the default algorithm at 1024 x 8192 CF32 (K6's
     FFT route) and at 5461 x 1536 F32 (B, n, 2) (K5), with algorithm
     dft at 5461 x 1536 F32 (K6's FFT route on the runtime plan), and
     with the default algorithm at every (B, n) of SPLIT_SHAPES, CF32
     (K6's split route: a high-resolution display), and at every (B, n)
     of CHIRP_SHAPES, CF32 (K6's chirp route: no split; each cycle against
     the model of its steps); then at 8 x 131968 CF32 with
     ``kernels.k6_route`` forced to "direct" (the direct product).
   Each of the fft and spectrum_engine paths launches fft_pallas once a
   cycle and no other kernel; each of the last five its own kernel (K6:
   on the route named), as each channelizer model route does once a
   step.
   Then the ct routes, each with the counters zeroed before it and only
   its own kernel launched, once a call, against its plain version
   (1e-5; |X|^2: of each row's max; the argmax bin of every row; a zero
   row exactly 0, or the plain version's ~1e-4 for the fast epilogue)
   and, with the exact epilogue, a float64 truth (1e-4):
   - ``SpectrumPipeline.step_kernel(version="ct1")`` (K10,
     spectrum_fused_ct) on the spectrum path's three buffers (4096 x 2048
     CF32 through view_as_real), with exact=True, then exact=False; then
     at 5461 x 1536 F32 (m = 12) on the K5 route's buffers;
   - spectrum_fused_ct3 (K11) on the spectrum path's buffers with
     ep="exact", "approx" and "none";
   - K10 and K11 at every m from 1 to 32 on 37 rows; K11 with each skip
     flag ("s1", "tw", "s2", all three) on 37 rows at m = 1, 12, 16, 32;
   - fft_pallas(exact=False) (K3's display tier) on the fft path's three
     buffers, bit for bit the exact call.
4. timing: CUDA events after warm-up for each kernel, its plain version
   and one cycle of each flowgraph; the host time to issue one call and
   one cycle; a torch.profiler trace of 10 cycles of each flowgraph
   (device time per kernel and the card's idle share between the first
   and the last kernel).  For the fused spectrum kernels also the
   library route, ``torch.fft.fft`` (cuFFT) with the window and the
   epilogue in torch ops, as ``library_ms`` (for K6 at 4096 x 2048 and
   1024 x 8192 also ``step_dft``, the same product as float32 cuBLAS
   matmuls); for fft_pallas ``torch.fft.fft`` alone.  K6 (a row by route
   and shape: ``spectrum_fused[fft]`` at 4096 x 2048,
   ``spectrum_fused[fft 1024x8192]``, ``spectrum_fused[fft 5461x1536]``,
   ``spectrum_fused[split BxN]`` at each of SPLIT_SHAPES, with each of its
   two passes' device time from a trace of 10 calls,
   ``spectrum_fused[chirp BxN]`` at each of CHIRP_SHAPES, with each of its
   three passes', ``spectrum_fused[direct]`` at 8 x 131968 on the forced
   route, its plain and library times those of the chirp row on the same
   input) and K5 are also timed by n
   and by m at ~8.39 Msamp a call.  The channelizer model routes: each kernel, its
   plain version, one step and its host time, and a trace of 10 steps.
   The ct routes: K10, K11 with each epilogue (library: cuFFT with the
   epilogue, or with |X|^2 alone for ep="none") and K3's display tier
   at 4096 x 2048; K10 also with exact=False and at 5461 x 1536; the
   ct1 step of both shapes, its host time and a trace of 10 steps.

5. floors: scale_copy (K13, s = 2 and 1), staged_copy (K14) and
   tile_dot (K15: fp32, tf32, 3xtf32, bf16, f16) against their plain
   versions at (131072, 128) and on 37 and 1 rows (K13, K14 bit for bit;
   K15 1e-5 of max|o|; the float32 modes also against the unrounded
   float64 product, tf32 within 2e-3 and more than 1e-5 from it); then
   the platform and stream probes (``cyberether_tpu_torch.probes``) as a
   user runs them, the counts
   zeroed before each and read after it: the dispatch floor, the copy
   rates by rows a block and by stage size, the tile products of every
   instance beside torch.matmul, the f16 line, and the library's peak
   rates at 4096^3.  The best measured copy rate and the best measured
   rate of each product type are the card's floors; one above 105% of
   its published peak fails the phase.
6. ablations: each K16 stage (channelize_ablate: full, no_fir, no_atan,
   no_demod, matmul_only, reshape_mean on full's instance, full_rate)
   against its plain version at C=64, P=8, D=16, M=131072 (the stages
   that take an atan2 on full-band input, the rest on the probe's normal
   input), then at C=8, P=4, D=4, M=1024 with a non-zero history; each
   K17 variant (wbfm_ablate: full, noatan, onlyfir, shift and shiftnoat
   on full's and noatan's instances) at n = 2^22, T = 129, and at n =
   128 x 37 with a non-zero history, on FM input (those without an
   angle also on the probe's normal input).  Angles within 1e-4, every other
   output (full_rate's dr half too) within 1e-5 of its max|o|.  Then the
   chan_ablate and wbfm_ablate probes as a user runs them, the counts
   zeroed before each and read after: each launches only its own
   instances and K1 and K8, or K12.

Then a JSON line with each kernel's numbers, a row per K16 and K17
instance too (``bound_ms`` against the published peaks, the operations
on each pipe: a float32 product of the channelizer rows as three TF32
products on the tensor cores, ``was_bound_ms`` the same work with that
product at the fp32 FFMA rate; ``work``, the bytes and operations by
type it counts; ``floor_ms``, that work over the measured floors; K1's,
K9's and K16's ``instance``; K1's times coherent and by integer ingest), the
card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, on any failure, without a CUDA device, or
without the package beside it.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

C, P, D, M = 64, 8, 16, 131072        # the flagship channelizer, one cycle
WN, WT, WD = 8_192_000, 129, 40       # the WBFM receiver, one cycle
SB, SN = 4096, 2048                   # the spectrum, one cycle (bench.py:325)
DB, DN = 1024, 8192                   # the spectrum past m = 32: full DFT
CB, CN = 5461, 1536                   # m = 12, the spectrum cycle's samples
K6_SIZES = (1, 2, 3, 5, 7, 64, 100, 127, 128, 384, 1000, 2048, 4224,
            16384, 131, 1021, 2042)
# K6's split route: 8 x 16512 (m = 129), and the spectrum cycle's 8.39
# Msamp at m = 256 and 512; with p-point rows on the large-prime pass, 8 x
# 16768 (m = 131) and 8.39 Msamp at m = p = 131, 257, 509, 1021; with the
# prime first (131 x 256: pass A's columns on the large-prime pass), 8 x
# 33536 and 250 x 33536 (m = 262)
SPLIT_SHAPES = ((8, 16512), (256, 32768), (128, 65536), (8, 16768),
                (500, 16768), (255, 32896), (128, 65152), (64, 130688),
                (8, 33536), (250, 33536))
PRIME_FIRST_N = (33536,)
# K6's plain version, a float64 product, takes every row of a call up to
# this many samples, and PLAIN_ROWS rows past it (seconds a call at 8.39
# Msamp); no row past this many points (minutes a row), where the chirp
# route is held to the model of its steps and the float64 truth
PLAIN_MAX_SAMPLES = 1 << 20
PLAIN_ROWS = 8
# the chirp route: a prime past the core's 1021 (M = 2560, one launch on
# 256 threads), 2062 and 4099 (M = 5120 and 10240, one launch on 512),
# the largest prime below 16384 (M = 32768 = 128 x 256, three launches)
# and 16411 (M = 40960 = 256 x 160); its paths at 8 x 128 x 1031, the
# first spectrum size past 16384 points that does not split, and at 8.45
# Msamp as 64 x 131968 (M = 327680 = 512 x 640); held but not driven at
# CHIRP_CHECK_SHAPES, the other column instances (M = 1024 x 640 at 128 x
# 2053, 2048 x 1536, 4096 x 5120 at 128 x 65537: pass B on 512 threads)
K6_CHIRP_SIZES = (1031, 2062, 4099, 16381, 16411)
CHIRP_SHAPES = ((8, 131968), (64, 131968))
CHIRP_CHECK_SHAPES = ((2, 262784), (2, 1310723), (2, 8388736))
# the direct product, on a forced route, at the sizes the chirp route took
# from it, and its path and timing row at 8 x 131968
K6_DIRECT_SIZES = (1031, 16381)
DXB, DXN = 8, 131968
EB = 512                              # spectrum_engine rows (bench.py:577)
TOL = 1e-4                            # exact tier: 1e-4 on audio
FFT_TOL = 1e-5                        # of max|X|: the JAX tests' fft bar
RT_TOL = 1e-2                         # fft round trip (test_pallas_kernels)
STREAM_TOL = 1e-5
CT_TOL = 1e-5                         # K10, K11 vs plain: K5's arithmetic
CT3_EPILOGUES = ("exact", "approx", "none")
CT3_SKIPS = (("s1",), ("tw",), ("s2",), ("s1", "tw", "s2"))
# K10, K11 vs the float64 truth: the exact tier's bar; |X|^2 of each
# row's max, K3's bar
CT_TRUTH_TOL = {"exact": 1e-4, "approx": 1e-4, "none": 1e-5}
THRESHOLD = 0.25                      # squelch threshold of the main path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# ... and by the input type of a product: the fp32 units, and the tensor
# cores (TF32; bf16 and fp16)
PEAK_FLOPS = {"fp32": FP32_FLOPS, "tf32": 495e12, "bf16": 989e12,
              "f16": 989e12}
# a measured floor may pass its published peak by this factor, no more
PEAK_SLACK = 1.05
ATAN2_OPS = 15                        # fp32 ops of one poly3 atan2
ATAN2_OPS5 = 21                       # ... of one poly5 atan2 (3 more FMAs)
KERNEL_VARIANTS = ("v4", "v6")        # step_kernel's routes besides K1
CARRY_VARIANTS = ("v1", "v2")         # step_carry_kernel's (K7)
# fp32 ops counted for one accurate logf or tanhf: the instruction count of
# the CUDA library's range reduction and polynomial, rounded up
TRANSCENDENTAL_OPS = 20


class SmokeFailure(RuntimeError):
    pass


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_cuda(torch, fn, warm: int = 3, iters: int = 20) -> float:
    """Mean ms per call of ``fn`` by CUDA events, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters: int = 20) -> float:
    """Mean host microseconds to issue one call of ``fn``, warm, without
    waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def trace_cycles(torch, fn, cycles: int = 10):
    """torch.profiler's CUDA activity over ``cycles`` calls of ``fn``:
    (device ms per cycle by kernel name, idle share of the card between
    the first kernel's start and the last one's end, the profiler
    sessions before that one that recorded no device activity), or None
    if three sessions recorded none (one late in a long run has come back
    empty, its kernels launched).  Every empty session is printed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for empty in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(cycles):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
        say(f"trace: profiler session {empty + 1} of 3 recorded no device "
            "activity")
    if not events:
        return None
    per_name = {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    span = max(e.time_range.end for e in events) - \
        min(e.time_range.start for e in events)
    idle = 1.0 - sum(per_name.values()) / span
    return ({k: us / cycles / 1e3 for k, us in sorted(
        per_name.items(), key=lambda kv: -kv[1])}, idle, empty)


def say_trace(what: str, trace) -> None:
    if trace is None:
        say(f"trace: {what}: no device activity recorded (not measured)")
        return
    per, idle, empty = trace
    say(f"trace: {what}: device {sum(per.values()):.4f} ms per cycle, "
        f"idle share {idle:.3f}; " + ", ".join(
            f"{name[:60]} {ms:.4f} ms" for name, ms in per.items()) +
        (f" (after {empty} empty profiler sessions)" if empty else ""))


def roofline_ms(nbytes: float, ops, kind: str = "fp32") -> tuple:
    """(the larger of ``nbytes`` over HBM bandwidth and the time of the
    operations on each pipe, in ms; which of the two it is; the work
    itself, ``{"bytes", "ops": {type: count}}``, which a kernels row
    carries as ``work`` so that :func:`floor_ms` can set it over the
    measured rates).  ``ops``: a count of type ``kind``, or
    ``{type: count}`` for work that runs on several pipes at once (the
    tensor cores beside the fp32 units), each over its type's peak."""
    ops = dict(ops) if isinstance(ops, dict) else {kind: ops}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_FLOPS[k] for k, n in ops.items()) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
            {"bytes": nbytes, "ops": ops})


def floor_ms(work: dict, bytes_per_s: float, flops: dict) -> float:
    """A row's work (``roofline_ms``'s third value) over the card's
    measured floors: the best copy rate in bytes/s and the best measured
    rate of each operation type in operations/s."""
    return max([work["bytes"] / bytes_per_s] + [
        n / flops[k] for k, n in work["ops"].items()]) * 1e3


def dft_ops(rows: int, n: int, dft: str) -> dict:
    """The operations of a (rows, n) @ (n, n) float32 product by type: an
    fp32-grade product on this card is three TF32 products on the tensor
    cores ("tf32x3", the function's bound); "fp32" counts one product at
    the fp32 FFMA rate (the bound these rows had before)."""
    if dft == "tf32x3":
        return {"tf32": 3 * 2 * rows * n * n}
    return {"fp32": 2 * rows * n * n}


def _add_fp32(ops: dict, fp32: float) -> dict:
    return {**ops, "fp32": ops.get("fp32", 0) + fp32}


def k1_bound_ms(m: int, c: int, p: int, d: int, in_bytes: int,
                coherent: bool, atan_ops: int = ATAN2_OPS,
                stage: str = "full", dft: str = "tf32x3") -> tuple:
    """Least time for one channelize_demod_decim call: the larger of its
    bytes over HBM bandwidth (each input read once, the output written
    once) and its operations on each pipe: the DFT as :func:`dft_ops`
    counts it (three TF32 products on the tensor cores), the FIR, lag
    products, atan2 and boxcar at the fp32 peak.  K8 and K9 compute the
    same function with the 5-term atan2 (``atan_ops``): the folded form's
    P products are its algorithm's, not the function's.

    ``stage``, one of K16's instances, keeps only the work its function
    does, as the TPU ablation body writes it: "no_fir" reads no taps and
    filters nothing; "no_atan" keeps the lag's imaginary part alone;
    "no_demod" no lag products or atan2; "matmul_only" the DFT of the m
    frames and the boxcar, no history or taps; "full_rate" no boxcar, and
    an (m, 2c) output."""
    n = 2 * c
    dft_rows = m if stage == "matmul_only" else m + 1
    outs = m * n if stage == "full_rate" else (m // d) * c
    nbytes = m * n * in_bytes + n * n * 4 + outs * 4
    if stage != "matmul_only":
        nbytes += p * n * in_bytes                   # history
    if stage not in ("matmul_only", "no_fir"):
        nbytes += p * n * 4                          # taps
    ops = 0
    if stage not in ("matmul_only", "no_fir"):
        ops += 2 * p * dft_rows * n                  # FIR
    if stage in ("full", "no_fir", "full_rate"):
        ops += 6 * m * c                             # lag products
        ops += atan_ops * (m // d if coherent else m) * c
    elif stage == "no_atan":
        ops += 3 * m * c                             # the lag's Im part
    if stage != "full_rate":
        ops += 2 * m * c                             # boxcar sums
    return roofline_ms(nbytes, _add_fp32(dft_ops(dft_rows, n, dft), ops))


def k7_bound_ms(m: int, c: int, p: int, dft: str = "tf32x3") -> tuple:
    """Least time for one channelize_demod call (K7): K1's function
    undecimated, with the lag frame given: ext, taps, DFT parts and prev
    read once, the (m, c) demod and ylast written once, against the FIR,
    the DFT (:func:`dft_ops`), the lag products and one 5-term atan2 and
    gain a value."""
    n = 2 * c
    nbytes = ((m + p - 1) * n + p * c + 2 * c * c + n + m * c + n) * 4
    ops = 2 * p * m * n + 6 * m * c + (ATAN2_OPS5 + 1) * m * c
    return roofline_ms(nbytes, _add_fp32(dft_ops(m, n, dft), ops))


def folded_product_ms(rows: int, c: int, p: int) -> float:
    """The folded form's own fp32 floor (K8, K7 v2): P accumulating
    (2C)^2 products a row over the fp32 peak, shown beside the kernel's
    time, never as its bound."""
    return 2 * rows * p * (2 * c) ** 2 / FP32_FLOPS * 1e3


def wbfm_bound_ms(n: int, t: int, d: int, poly3: bool,
                  stage: str = "full") -> tuple:
    """Least time for one wbfm_fused_v2 (d=0: classic, else coherent over
    groups of d) or wbfm_fused call: bytes over HBM bandwidth (IQ, taps
    and history read once, the output written once) against fp32
    operations over the fp32 peak.  ``stage``, one of K17's instances
    (classic): "noatan" adds dr + di where "full" takes the angle;
    "onlyfir" adds Re y + Im y, with no lag sample or lag products."""
    outs = n // d if d else n
    nbytes = n * 2 * 4 + 2 * (t - 1) * 4 + t * 4 + outs * 4
    atan = ATAN2_OPS if poly3 else ATAN2_OPS5
    if stage == "onlyfir":
        return roofline_ms(nbytes, 2 * 2 * t * n + n)
    ops = (2 * 2 * t * (n + 1)         # FIR, re and im, incl. the lag sample
           + 6 * n                     # lag products
           + (2 * n if d else 0))      # group sums
    ops += n if stage == "noatan" else outs * (atan + 1)   # angle x gain
    return roofline_ms(nbytes, ops)


def k3_bound_ms(b: int, n: int) -> tuple:
    """Least time for one fft_pallas call: bytes over HBM bandwidth (x
    read once, X written once, 8 bytes a value each; the kernel's own
    twiddle table is not part of the function) against 5 n log2 n fp32
    operations a row over the fp32 peak."""
    log2n = n.bit_length() - 1
    nbytes = 2 * b * n * 8
    ops = 5 * n * log2n * b
    return roofline_ms(nbytes, ops)


# fp32 operations a bin of the fused spectrum's window (2), |X|^2 (3),
# scalar epilogue (8), log and tanh
SPECTRUM_BIN_OPS = 2 + 3 + 8 + 2 * TRANSCENDENTAL_OPS
# ... with K11's fast epilogue instead: the exponent-bits log10 (~10) and
# the clamped Padé tanh on a reciprocal and a Newton step (~15); with its
# |X|^2 output: the window and |X|^2 alone
CT3_BIN_OPS = {"exact": SPECTRUM_BIN_OPS, "approx": 2 + 3 + 8 + 10 + 15,
               "none": 2 + 3}


def spectrum_bound_ms(b: int, n: int,
                      bin_ops: int = SPECTRUM_BIN_OPS) -> tuple:
    """Least time for one call of the fused spectrum function (K2
    spectrum_fused_ct5, K5 spectrum_fused_ct4, K6 spectrum_fused, K10
    spectrum_fused_ct and K11 spectrum_fused_ct3 all compute it; K11's
    other epilogues count ``bin_ops`` instead): bytes over HBM bandwidth
    (IQ and window read once, the spectrum written once; a kernel's own
    twiddle table is not part of the function) against fp32 operations
    over the fp32 peak: an FFT's
    5 n log2 n a row, which mixed-radix or Bluestein transforms reach
    for any n, and ``bin_ops`` a bin.  The algorithm a kernel happens to
    use (K6's direct product, K5's direct m-point stage) does not raise
    it."""
    nbytes = b * n * 2 * 4 + n * 4 + b * n * 4
    ops = b * (5 * n * math.log2(n) + bin_ops * n)
    return roofline_ms(nbytes, ops)


def dft_product_ms(b: int, n: int) -> float:
    """The direct DFT product's own fp32 floor, 8 n^2 operations a row
    (4 FFMA a complex multiply-add) over the fp32 peak: what K6's
    algorithm could reach at best, shown beside its bound, never as
    it."""
    return b * 8 * n * n / FP32_FLOPS * 1e3


def spectrum_truth(torch, x, sp):
    """The fused spectrum of (B, n, 2) rows ``x`` in float64: complex128
    torch.fft.fft of the windowed rows, then the epilogue; a yardstick
    only."""
    x64 = torch.view_as_complex(x.double()) * sp._win.double()
    db = 10.0 * torch.log10(torch.fft.fft(x64, dim=-1).abs() ** 2) \
        + sp._coeff
    return 0.5 + 0.5 * torch.tanh(4.0 * (db * sp._scale + sp._offset - 0.5))


def ct_truth(torch, x, sp, ep: str = "exact", skip=()):
    """K10's and K11's function of (B, n, 2) rows ``x`` in float64, a
    yardstick only, with t = 128 n1 + n2 and k = m k2 + k1: the windowed
    m-point DFT over the chunk axis n1 (with "s1" in ``skip``: windowed
    chunk 0 for every k1), the twiddle W_n^(k1 n2) (not with "tw"), the
    128-point DFT over n2 (not with "s2"), then the epilogue ``ep``:
    "exact" (log10 and tanh), "none" (|X|^2) or "approx", the TPU
    kernel's exponent-bits log10 of float32 |X|^2 (its cubic evaluated in
    float64) and its clamped Padé tanh, divided exactly."""
    B, n, _ = x.shape
    m = n // 128
    xw = (torch.view_as_complex(x.double()) * sp._win.double()) \
        .reshape(B, m, 128)
    a = xw[:, :1].expand(B, m, 128) if "s1" in skip else \
        torch.fft.fft(xw, dim=1)
    if "tw" not in skip:
        k1n2 = torch.outer(torch.arange(m, device=x.device),
                           torch.arange(128, device=x.device)).double()
        a = a * torch.polar(torch.ones_like(k1n2), -2 * math.pi * k1n2 / n)
    y = a if "s2" in skip else torch.fft.fft(a, dim=2)
    mag2 = (y.abs() ** 2).transpose(1, 2).reshape(B, n)
    if ep == "none":
        return mag2
    if ep == "exact":
        db = 10.0 * torch.log10(mag2) + sp._coeff
        return 0.5 + 0.5 * torch.tanh(
            4.0 * (db * sp._scale + sp._offset - 0.5))
    bits = mag2.float().view(torch.int32)
    e = (((bits >> 23) & 0xFF) - 126).double()
    f = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32).double()
    log2 = ((1.23149591368684 * f - 4.11852516267426) * f
            + 6.02197014179219) * f - 3.13396450166353 + e
    db = 10.0 * math.log10(2.0) * log2 + sp._coeff
    t = (4.0 * (db * sp._scale + sp._offset - 0.5)).clamp(-4.5, 4.5)
    t2 = t * t
    return 0.5 + 0.5 * (t * (135135.0 + t2 * (17325.0 + t2 * (378.0 + t2)))
                        / (135135.0 + t2 * (62370.0 + t2 * (3150.0
                                                            + t2 * 28.0))))


def spectrum_library(torch, x, sp):
    """cuFFT through torch.fft.fft, with the window and the epilogue in
    torch ops: the same function as the fused spectrum kernels."""
    xc = torch.view_as_complex(x) * sp._win
    spec = torch.fft.fft(xc, dim=-1)
    mag2 = spec.real * spec.real + spec.imag * spec.imag
    db = 10.0 * (torch.log(mag2) * 0.43429448190325176) + sp._coeff
    return 0.5 + 0.5 * torch.tanh(4.0 * (db * sp._scale + sp._offset - 0.5))


def mag2_library(torch, x, sp):
    """torch.fft.fft (cuFFT) of the windowed rows, then |X|^2 in torch
    ops: the same function as K11 with ep="none"."""
    spec = torch.fft.fft(torch.view_as_complex(x) * sp._win, dim=-1)
    return spec.real * spec.real + spec.imag * spec.imag


def same_peaks(got, ref, real_input: bool) -> bool:
    """The argmax bin of every row agrees.  A real input's spectrum is
    symmetric (after the inverting window, bin j and bin n - j hold the
    same magnitude and rounding picks the maximum), so for real input
    either bin of that pair counts."""
    n = got.shape[-1]
    a, b = got.argmax(-1), ref.argmax(-1)
    same = a == b
    if real_input:
        same = same | (a == (n - b) % n)
    return bool(same.all())


# K15 against its plain version, of max|o| (each plain version rounds
# its inputs as its mode does: "bf16" and "f16" take rounded inputs)
K15_TOL = 1e-5
# the float32 modes against the float64 product of the unrounded inputs,
# of max|o|; "tf32" must also lie more than TF32_MIN_ERR from it, which a
# product that skipped the rounding to TF32 would not
K15_TRUTH_TOL = {"fp32": 1e-5, "tf32": 2e-3, "3xtf32": 1e-5}
TF32_MIN_ERR = 1e-5


def floors(torch, dev, gen, zero_counts, only) -> tuple:
    """The floors phase: K13 (scale_copy), K14 (staged_copy) and every
    K15 (tile_dot) instance against their plain versions at full width
    and on ragged rows; the platform and stream probes driven with every
    count set to 0 before each; a ``kernels`` row per instance; and the
    card's measured floors.  Returns (rows, the best copy rate in bytes/s,
    the best rate in operations/s by ``PEAK_FLOPS`` type)."""
    from cyberether_tpu_torch.ops import probe_kernels as pk
    from cyberether_tpu_torch.probes import platform_probe, stream_probe
    from cyberether_tpu_torch.probes.common import ROWS, WIDTH

    t0 = time.perf_counter()
    x = torch.randn((ROWS, WIDTH), device=dev, generator=gen)
    b = torch.randn((WIDTH, WIDTH), device=dev, generator=gen)
    for rows_ in (ROWS, 37, 1):
        xr = x[:rows_]
        for s_ in (2.0, 1.0):
            for rpb in platform_probe.ROWS_PER_BLOCK:
                got = pk.scale_copy(xr, s_, rpb)
                torch.cuda.synchronize()
                check(torch.equal(got, pk.scale_copy_plain(xr, s_)),
                      f"scale_copy s={s_:g} rows={rows_} rows_per_block="
                      f"{rpb}: not its plain version bit for bit")
        for sb in (16,) + stream_probe.STAGE_BYTES:
            got = pk.staged_copy(xr, sb)
            torch.cuda.synchronize()
            check(torch.equal(got, xr), f"staged_copy rows={rows_} "
                  f"stage_bytes={sb}: not a copy bit for bit")
    say(f"kernel vs plain: scale_copy (s = 2 and 1, rows_per_block "
        f"{platform_probe.ROWS_PER_BLOCK}) and staged_copy (stage_bytes "
        f"{(16,) + stream_probe.STAGE_BYTES}) bit for bit at ({ROWS}, "
        f"{WIDTH}), 37 and 1 rows")
    errs = {"scale_copy[s=2]": 0.0, "scale_copy[s=1]": 0.0,
            "staged_copy": 0.0}
    truth = x.double() @ b.double()
    for mode, (_, dt) in pk.TILE_DOT_MODES.items():
        xm, bm = x.to(dt), b.to(dt)
        ref = pk.tile_dot_plain(xm, bm, mode)
        peak = float(ref.abs().max())
        worst = 0.0
        for rpb in platform_probe.DOT_ROWS_PER_BLOCK:
            got = pk.tile_dot(xm, bm, mode, rpb)
            torch.cuda.synchronize()
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                  f"tile_dot {mode}: output shape/finite")
            worst = max(worst, float((got - ref).abs().max()))
        rag = pk.tile_dot(xm[:37], bm, mode, pk.K15_TILE_ROWS)
        rag_err = float((rag - ref[:37]).abs().max())
        t_err = float((got.double() - truth).abs().max()) / float(
            truth.abs().max())
        say(f"kernel vs plain: tile_dot {mode} ({ROWS}, {WIDTH}) @ ({WIDTH}, "
            f"{WIDTH}) rows_per_block {platform_probe.DOT_ROWS_PER_BLOCK}: "
            f"{worst / peak:.3e} of max|o| (bar {K15_TOL:g}), 37 rows "
            f"{rag_err / peak:.3e}; against the float64 product of the "
            f"unrounded float32 inputs {t_err:.3e}")
        check(max(worst, rag_err) <= K15_TOL * peak,
              f"tile_dot {mode}: {worst / peak} of max|o| from its plain "
              "version")
        if dt == torch.float32:
            check(t_err <= K15_TRUTH_TOL[mode], f"tile_dot {mode}: {t_err} "
                  "of max|o| from the float64 product")
        if mode == "tf32":
            check(t_err > TF32_MIN_ERR, f"tile_dot tf32: {t_err} of max|o| "
                  "from the unrounded product: its inputs were not rounded")
        errs[f"tile_dot[{mode}]"] = worst
    del xm, ref, got, truth

    # the path: each probe as a user runs it, the counts zeroed before it
    pk.zero_counts()
    zero_counts()
    plat = platform_probe.measure(dev)
    by_mode = dict(pk.tile_dot.launches)
    launches = {"scale_copy[s=2]": pk.scale_copy.launches,
                **{f"tile_dot[{m}]": n for m, n in by_mode.items()}}
    check(pk.staged_copy.launches == 0, "platform_probe launched staged_copy")
    only("platform_probe", {})
    pk.zero_counts()
    strm = stream_probe.measure(dev)
    launches["scale_copy[s=1]"] = pk.scale_copy.launches
    launches["staged_copy"] = pk.staged_copy.launches
    check(not any(pk.tile_dot.launches.values()),
          "stream_probe launched tile_dot")
    only("stream_probe", {})
    for line in platform_probe.lines(plat):
        say(f"floors: platform_probe: {line}")
    for line in stream_probe.lines(strm):
        say(f"floors: stream_probe: {line}")
    say(f"main-path: the probes' launches by instance {launches}")
    check(all(n >= 1 for n in launches.values()),
          f"a probe kernel was never launched: {launches}")
    f16 = plat["f16_probe"]["rel_err_vs_f64"]
    check(f16 <= K15_TOL, f"f16_probe line: {f16} from float64")

    entries = {e["what"]: e for e in plat["streaming"] + plat["products"]
               + strm["streaming"]}
    library = {e["mode"]: e["ms"] for e in plat["products"]
               if "kernel" not in e}
    moved = 2 * ROWS * WIDTH * 4
    flops = 2 * ROWS * WIDTH * WIDTH
    rows = []
    for name, source, replaces, what, plain_fn, bound, lib_ms in [
            ("scale_copy[s=2]", "platform_probe.cu", "platform_probe.py:91",
             f"scale_copy s=2 rows_per_block={pk.K13_ROWS_PER_BLOCK}",
             lambda: pk.scale_copy_plain(x, 2.0),
             roofline_ms(moved, ROWS * WIDTH), entries["torch x * 2"]["ms"]),
            ("scale_copy[s=1]", "platform_probe.cu", "stream_probe.py:77",
             f"scale_copy s=1 rows_per_block={pk.K13_ROWS_PER_BLOCK}",
             lambda: pk.scale_copy_plain(x, 1.0), roofline_ms(moved, 0),
             entries["torch x.clone()"]["ms"]),
            ("staged_copy", "stream_probe.cu", "stream_probe.py:95",
             f"staged_copy stage_bytes={pk.K14_STAGE_BYTES}",
             lambda: pk.staged_copy_plain(x), roofline_ms(moved, 0),
             entries["torch x.clone()"]["ms"])] + [
            (f"tile_dot[{mode}]", "platform_probe.cu",
             "f16_probe.py:10" if mode == "f16" else "platform_probe.py:110",
             f"tile_dot {mode} rows_per_block={pk.K15_ROWS_PER_BLOCK}",
             lambda dt=dt, mode=mode: pk.tile_dot_plain(
                 x.to(dt), b.to(dt), mode),
             roofline_ms((ROWS * WIDTH + WIDTH * WIDTH) * dt.itemsize
                         + ROWS * WIDTH * 4,
                         flops * (3 if mode == "3xtf32" else 1),
                         "tf32" if mode == "3xtf32" else mode),
             library["fp32" if mode == "3xtf32" else mode])
            for mode, (_, dt) in pk.TILE_DOT_MODES.items()]:
        p_ms = time_cuda(torch, plain_fn, warm=2, iters=5)
        b_ms, b_by, b_work = bound
        k_ms = entries[what]["ms"]
        say(f"timing: {name} ({what}) {k_ms:.4f} ms ({100 * b_ms / k_ms:.1f}"
            f"% of bound), plain {p_ms:.4f} ms, library {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"cyberether_tpu_torch/csrc/{source}",
            "replaces": f"tools/ablation/{replaces}",
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "work": b_work,
            "library_ms": lib_ms,
        })

    copies = [e for e in plat["streaming"] + strm["streaming"]
              if "read only" not in e["what"]]
    best = max(copies, key=lambda e: e["GB/s"])
    rated = [e for e in plat["products"] + plat["peaks"]
             if e["mode"] in PEAK_FLOPS]
    rates = {kind: max((e for e in rated if e["mode"] == kind),
                       key=lambda e: e["TFLOP/s"]) for kind in PEAK_FLOPS}
    # a measured floor above its published peak is a failed measurement
    check(best["GB/s"] * 1e9 <= PEAK_SLACK * HBM_BYTES_PER_S,
          f"floors: copy {best['GB/s']} GB/s above the published peak")
    for kind, e in rates.items():
        check(e["TFLOP/s"] * 1e12 <= PEAK_SLACK * PEAK_FLOPS[kind],
              f"floors: {kind} {e['TFLOP/s']} TFLOP/s ({e['what']}) above "
              "the published peak")
    say(f"floors: measured best copy {best['GB/s']:.1f} GB/s ({best['what']})"
        f", published {HBM_BYTES_PER_S / 1e9:.0f}; " + "; ".join(
            f"{kind} {e['TFLOP/s']:.1f} TFLOP/s ({e['what']}), published "
            f"{PEAK_FLOPS[kind] / 1e12:.0f}" for kind, e in rates.items()))
    say(f"floors: the phase took {time.perf_counter() - t0:.1f} s")
    return (rows, best["GB/s"] * 1e9,
            {kind: e["TFLOP/s"] * 1e12 for kind, e in rates.items()})


# K16 and K17 against their plain versions: outputs that take no atan2,
# of their max|o| (one float32 product and sum apart); angles take TOL
ABLATE_TOL = 1e-5
AC, AP, AD, AM = 8, 4, 4, 1024        # K16's small shape
# the K16 stages that take an atan2: held on full-band input (an empty or
# noisy channel demodulates to atan-branch noise); the rest on the probe's
# normal input
K16_ANGLE_STAGES = ("full", "no_fir", "reshape_mean", "full_rate")
# the TPU ablation body each K16 instance replaces (chan_ablate.py lines;
# "full" also runs k_reshape_mean, :180)
K16_BODY_LINES = {"full": 109, "no_fir": 127, "no_atan": 143,
                  "no_demod": 160, "matmul_only": 173, "full_rate": 197}


def ablations(torch, dev, gen, zero_counts, only) -> list:
    """The ablations phase: every K16 (channelize_ablate) and K17
    (wbfm_ablate) instance against its plain version at full width and at
    a small shape with a non-zero history; the chan_ablate and wbfm_ablate
    probes driven with every count set to 0 before each; a ``kernels`` row
    per instance.  Returns the rows."""
    import numpy as np

    from cyberether_tpu_torch.models.channelizer import Channelizer
    from cyberether_tpu_torch.models.wbfm import WbfmReceiver
    from cyberether_tpu_torch.ops import kernels as kn
    from cyberether_tpu_torch.ops import probe_kernels as pk
    from cyberether_tpu_torch.probes import chan_ablate, wbfm_ablate

    t0 = time.perf_counter()
    K16, K16p = kn.channelize_ablate, kn.channelize_ablate_plain
    K17, K17p = kn.wbfm_ablate, kn.wbfm_ablate_plain
    every = slice(None)
    errs = {**{("K16", i): 0.0 for i in kn.CHANNELIZE_ABLATE_INSTANCES},
            **{("K17", i): 0.0 for i in kn.WBFM_ABLATE_INSTANCES}}

    def held(name, key, got, ref, shape, angles, values) -> None:
        """got against ref: the columns ``angles`` (a slice, or None) at
        TOL absolute, the columns ``values`` at ABLATE_TOL of their
        max|o|."""
        torch.cuda.synchronize()
        check(tuple(got.shape) == shape and bool(torch.isfinite(got).all()),
              f"{name}: output shape/finite")
        errs[key] = max(errs[key], float((got - ref).abs().max()))
        parts = []
        if angles is not None:
            err = float((got[..., angles] - ref[..., angles]).abs().max())
            parts.append(f"angles max_abs_err={err:.3e} tol={TOL:g}")
            check(err <= TOL, f"{name}: angles {err} > {TOL}")
        if values is not None:
            rel = float((got[..., values] - ref[..., values]).abs().max()
                        / ref[..., values].abs().max())
            parts.append(f"{rel:.3e} of max|o| tol={ABLATE_TOL:g}")
            check(rel <= ABLATE_TOL, f"{name}: {rel} of max|o| > "
                  f"{ABLATE_TOL}")
        say(f"kernel-vs-plain: {name} " + ", ".join(parts))

    def k16_columns(stage: str, c: int) -> tuple:
        if stage == "full_rate":            # [angle | dr]
            return slice(0, c), slice(c, None)
        return (every, None) if stage in K16_ANGLE_STAGES else (None, every)

    model = Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                        device=dev)
    tables = (model.hp5, model.bperm5, model.fm_ref)
    band = model.make_input_full(M, seed=1, device=dev).reshape(M, 2 * C)
    noise = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (M, C, 2)).astype(np.float32)).to(dev).reshape(M, 2 * C)
    zero = torch.zeros((P, 2 * C), device=dev)
    small = Channelizer(channels=AC, taps_per_branch=AP, audio_decim=AD,
                        sample_rate=AC * 2e6, device=dev)
    frames = small.make_input_full(AM + AP, seed=3, device=dev).reshape(
        AM + AP, 2 * AC)
    xs, hs = frames[AP:].contiguous(), frames[:AP].contiguous()
    for stage in kn.CHANNELIZE_ABLATE_STAGES:
        key = ("K16", kn.CHANNELIZE_ABLATE_INSTANCE_OF[stage])
        angle_stage = stage in K16_ANGLE_STAGES
        args = (band if angle_stage else noise, zero, *tables, D, stage)
        held(f"channelize_ablate[{stage}] C={C} P={P} D={D} M={M} "
             f"{'full-band' if angle_stage else 'normal'} input", key,
             K16(*args), K16p(*args),
             (M, 2 * C) if stage == "full_rate" else (M // D, C),
             *k16_columns(stage, C))
        args = (xs, hs, small.hp5, small.bperm5, small.fm_ref, AD, stage)
        held(f"channelize_ablate[{stage}] C={AC} P={AP} D={AD} M={AM} "
             "non-zero hist", key, K16(*args), K16p(*args),
             (AM, 2 * AC) if stage == "full_rate" else (AM // AD, AC),
             *k16_columns(stage, AC))
    del band

    # K17 on the WBFM receiver's FM input (the lag angles of noise come
    # near pi, where a rounding flips an angle by 2 pi), with the probe's
    # taps; the stages without an angle also on the probe's normal input
    n, T = wbfm_ablate.N, wbfm_ablate.T
    taps = torch.from_numpy(wbfm_ablate.script_taps()).to(dev)
    rx = WbfmReceiver(device=dev)
    wzero = torch.zeros((2, T - 1), device=dev)
    fm = rx.make_input(n, seed=5, device=dev).T.contiguous()
    fms = rx.make_input(128 * 37, seed=6, device=dev).T.contiguous()
    fmh = rx.make_input(2 * T, seed=7, device=dev)[-(T - 1):].T.contiguous()
    wx = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, n)).astype(np.float32)).to(dev)
    for stage in kn.WBFM_ABLATE_STAGES:
        key = ("K17", kn.WBFM_ABLATE_INSTANCE_OF[stage])
        angle = key[1] == "full"
        cases = [(f"n={n} FM input, zero hist", fm, wzero),
                 ("n=128*37 FM input, non-zero hist", fms, fmh)]
        if not angle:
            cases.append((f"n={n} normal input, zero hist", wx, wzero))
        for what, x, h in cases:
            held(f"wbfm_ablate[{stage}] T={T} {what}", key,
                 K17(x, taps, h, 1.0, stage), K17p(x, taps, h, 1.0, stage),
                 (x.shape[1],), *((every, None) if angle else (None, every)))
    del fm

    # the path: each probe as a user runs it, the counts zeroed before it
    pk.zero_counts()
    zero_counts()
    kn.zero_ablate_counts()
    chan = chan_ablate.measure(dev)
    k16_launches = dict(K16.launches)
    used = {kn.channelize_demod_decim: kn.channelize_demod_decim.launches,
            kn.channelize_demod_decim_v4:
                kn.channelize_demod_decim_v4.launches}
    only("chan_ablate probe", used)
    check(all(used.values()), "chan_ablate probe: K1 or K8 never launched")
    check(not any(K17.launches.values()), "chan_ablate probe launched K17")
    pk.zero_counts()
    zero_counts()
    kn.zero_ablate_counts()
    wbfm = wbfm_ablate.measure(dev)
    k17_launches = dict(K17.launches)
    used = {kn.wbfm_fused: kn.wbfm_fused.launches}
    only("wbfm_ablate probe", used)
    check(all(used.values()), "wbfm_ablate probe: K12 never launched")
    check(not any(K16.launches.values()), "wbfm_ablate probe launched K16")
    check(not (pk.scale_copy.launches or pk.staged_copy.launches
               or any(pk.tile_dot.launches.values())),
          "an ablation probe launched a floor kernel")
    for line in chan_ablate.lines(chan):
        say(f"ablations: chan_ablate: {line}")
    for line in wbfm_ablate.lines(wbfm):
        say(f"ablations: wbfm_ablate: {line}")
    say(f"main-path: the ablation probes' launches by instance: K16 "
        f"{k16_launches}, K17 {k17_launches}")
    check(all(k16_launches.values()) and all(k17_launches.values()),
          "an ablation instance was never launched")

    rows = []
    chan_ms = {e["stage"]: e["ms"] for e in chan["stages"]}
    wbfm_ms = {e["stage"]: e["ms"] for e in wbfm["variants"]}
    for kernel, inst, replaces, k_ms, plain_fn, bound, launches in [
            (K16, inst, f"chan_ablate.py:{K16_BODY_LINES[inst]}",
             chan_ms[inst],
             lambda i=inst: K16p(noise, zero, *tables, D, i),
             (k1_bound_ms(M, C, P, D, 4, coherent=False,
                          atan_ops=ATAN2_OPS5, stage=inst),
              k1_bound_ms(M, C, P, D, 4, coherent=False,
                          atan_ops=ATAN2_OPS5, stage=inst, dft="fp32")[0]),
             k16_launches[inst])
            for inst in kn.CHANNELIZE_ABLATE_INSTANCES] + [
            (K17, inst, "wbfm_ablate.py:38", wbfm_ms[inst],
             lambda i=inst: K17p(wx, taps, wzero, 1.0, i),
             (wbfm_bound_ms(n, T, 0, poly3=False, stage=inst), None),
             k17_launches[inst])
            for inst in kn.WBFM_ABLATE_INSTANCES]:
        name = f"{kernel.__name__}[{inst}]"
        p_ms = time_cuda(torch, plain_fn, warm=2, iters=5)
        (b_ms, b_by, b_work), was_ms = bound
        say(f"timing: {name} {k_ms:.4f} ms ({100 * b_ms / k_ms:.1f}% of "
            f"bound), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "cyberether_tpu_torch/csrc/" + (
                "channelize_demod_decim.cu" if kernel is K16
                else "wbfm_fused.cu"),
            "replaces": f"tools/ablation/{replaces}",
            **({"instance": kn.k16_instance(C, inst)} if kernel is K16
               else {}),
            "launches": launches,
            "max_abs_err": errs[("K16" if kernel is K16 else "K17", inst)],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            **({} if was_ms is None else {"was_bound_ms": was_ms}),
            "work": b_work,
            "library_ms": None,
        })
    say(f"ablations: the phase took {time.perf_counter() - t0:.1f} s")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from cyberether_tpu_torch import Flowgraph
        from cyberether_tpu_torch.blocks.dsp import FftPallasModule
        from cyberether_tpu_torch.core.tensor import SignalAxes, TensorSpec
        from cyberether_tpu_torch.core.types import DataType, Device
        from cyberether_tpu_torch.models.channelizer import Channelizer
        from cyberether_tpu_torch.models.spectrum import SpectrumPipeline
        from cyberether_tpu_torch.models.wbfm import WbfmReceiver
        from cyberether_tpu_torch.ops import _build, kernels
        from cyberether_tpu_torch.ops.windows import blackman
        from ab_spectrum import instance_name, ptxas
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    K = kernels.channelize_demod_decim
    plain = kernels.channelize_demod_decim_plain
    W4, W4p = kernels.wbfm_fused_v2, kernels.wbfm_fused_v2_plain
    W12, W12p = kernels.wbfm_fused, kernels.wbfm_fused_plain
    S2, S2p = kernels.spectrum_fused_ct5, kernels.spectrum_fused_ct5_plain
    F3, F3p = kernels.fft_pallas, kernels.fft_pallas_plain
    S6, S6p = kernels.spectrum_fused, kernels.spectrum_fused_plain
    S5, S5p = kernels.spectrum_fused_ct4, kernels.spectrum_fused_ct4_plain
    K7, K7p = kernels.channelize_demod, kernels.channelize_demod_plain
    K8 = kernels.channelize_demod_decim_v4
    K9 = kernels.channelize_demod_decim_v6
    S10, S10p = kernels.spectrum_fused_ct, kernels.spectrum_fused_ct_plain
    S11, S11p = kernels.spectrum_fused_ct3, kernels.spectrum_fused_ct3_plain
    wrappers = (K, W4, W12, S2, F3, S6, S5, K7, K8, K9, S10, S11)
    # the kernel of each channelizer model route
    route_kernel = {"v1": K7, "v2": K7, "v4": K8, "v6": K9}
    errs = []
    werrs = {"classic": [], "coherent": [], "v1": []}
    serrs = []
    ferrs = []                 # K3: max |kernel - plain|, absolute
    # K6 by route, K5: max |kernel - plain|
    rerrs = {"fft": [], "split": [], "chirp": [], "direct": [], S5: []}
    # K10, K11 by epilogue, K3's display tier: max |kernel - plain|
    cterrs = {"ct": [], "exact": [], "approx": [], "none": [], "display": []}
    # K8 ("v4"), K9 ("v6") and K7 by variant: max |kernel - plain|
    cerrs = {v: [] for v in KERNEL_VARIANTS + CARRY_VARIANTS}
    gen = torch.Generator(device=dev).manual_seed(3)

    def crandn(*shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev,
                           generator=gen)

    def engine_plain(x, lo: float, hi: float):
        """The spectrum_engine chain in plain torch ops with K3's plain
        version: cast to CF32, window x (-1)^k, FFT, 20 log10 |X| -
        20 log10 n (-inf where |X| = 0), then the range soft clip."""
        n = x.shape[-1]
        sign = 1.0 - 2.0 * (torch.arange(n, device=dev) % 2)
        win = (blackman(n, device=dev) * sign).to(torch.complex64)
        X = F3p(x.to(torch.complex64) * win)
        mag = X.abs()
        db = torch.where(mag == 0, -torch.inf,
                         20.0 * torch.log10(mag) + 20.0 * math.log10(1 / n))
        scale = 1.0 / (hi - lo)
        return 0.5 + 0.5 * torch.tanh(4.0 * (db * scale - lo * scale - 0.5))

    def zero_counts() -> None:
        for w in wrappers:
            w.launches = 0
        S6.routes = dict.fromkeys(kernels.K6_ROUTES, 0)

    def counts() -> dict:
        return {w.__name__: w.launches for w in wrappers}

    # -- 1. build ------------------------------------------------------------
    sources = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    for source in sources:
        _build.load(source)
    say(f"build: {len(sources)} source(s) {sources} in "
        f"{time.perf_counter() - t0:.1f} s")
    # instances by their integer template arguments: K15's by mode, the
    # ct kernel's by <epilogue, ablate, m bucket, m compiled in>
    # (ptxas's report is kept beside each library, so a cached one has it)
    usage = {}
    for src in sources:
        named = {instance_name(k): v
                 for k, v in ptxas(_build.report(src)).items()}
        usage.update(named)
        built = (f"nvcc {_build.build_log[src][0]:.1f} s"
                 if src in _build.build_log else "cached")
        say(f"build: {src} {built}, registers/spill bytes by "
            "instance: " + "; ".join(
                f"{k} {regs}/{spill}" for k, (regs, spill) in sorted(
                    named.items())))
    # the instances K1 (each ingest type) and K9 launch at the path's C
    k1_instances = {what: kernels.k1_instance(C, dtype, atan)
                    for what, dtype, atan in (
                        ("K1 float32", torch.float32, "poly3"),
                        ("K1 int8", torch.int8, "poly3"),
                        ("K1 int16", torch.int16, "poly3"),
                        ("K9", torch.float32, "poly5rcp"))}
    say("build: K1 and K9 at C=%d launch " % C + "; ".join(
        f"{what} {inst} (registers/spill bytes "
        f"{'/'.join(map(str, usage.get(inst, ('?', '?'))))})"
        for what, inst in k1_instances.items()))
    # K16's instances, each stage at each C it is built for: none spills
    k16_usage = {inst: usage.get(inst) for inst in (
        kernels.k16_instance(c, stage) for c in kernels.K16_CHANNELS
        for stage in kernels.CHANNELIZE_ABLATE_INSTANCES)}
    say("build: K16 launches " + "; ".join(
        f"{inst} (registers/spill bytes "
        f"{'/'.join(map(str, regs or ('?', '?')))})"
        for inst, regs in k16_usage.items()))
    check(all(u is not None and u[1] == 0 for u in k16_usage.values()),
          f"K16: an instance is missing or spills: {k16_usage}")

    # -- 2. kernel vs plain at full width --------------------------------------
    model = Channelizer(channels=C, taps_per_branch=P, audio_decim=D)
    hp, bperm, g = model.hp5, model.bperm5, model.fm_ref
    x2 = model.make_input_full(M, seed=1, device=dev).reshape(M, 2 * C)
    other = model.make_input_full(M, seed=2, device=dev).reshape(M, 2 * C)
    zero_hist = torch.zeros((P, 2 * C), device=dev)
    peak = float(x2.abs().max())

    def compare(name: str, x, hist, mode: str):
        got = K(x, hist, hp, bperm, g, D, mode)
        ref = plain(x, hist, hp, bperm, g, D, mode)
        torch.cuda.synchronize()
        check(got.shape == (M // D, C) and bool(torch.isfinite(got).all()),
              f"{name}: output shape/finite")
        err = float((got - ref).abs().max())
        errs.append(err)
        say(f"kernel-vs-plain: {name} max_abs_err={err:.3e} tol={TOL:g}")
        check(err <= TOL, f"{name}: max abs error {err} > {TOL}")
        return got

    a_f32 = compare("classic f32", x2, zero_hist, "classic")
    compare("coherent f32", x2, zero_hist, "coherent")
    for dtype, full in ((torch.int8, 127), (torch.int16, 32767)):
        q = torch.round(x2 * (full / peak)).clamp(-full, full).to(dtype)
        a_q = compare(f"classic {str(dtype)[6:]}", q,
                      torch.zeros((P, 2 * C), dtype=dtype, device=dev),
                      "classic")
        a_qf = K(q.float(), zero_hist, hp, bperm, g, D, "classic")
        check(torch.equal(a_q, a_qf),
              f"{dtype} ingest differs from f32 ingest of the same values")
    hist = other[M - P:].contiguous()
    compare("classic f32, non-zero hist", x2, hist, "classic")
    compare("coherent f32, non-zero hist", x2, hist, "coherent")
    # split at half, and at a frame that is no multiple of K1's 64-row
    # tiles
    for h in (M // 2, M // 2 + 5 * D):
        a1 = K(x2[:h], zero_hist, hp, bperm, g, D, "classic")
        a2 = K(x2[h:], x2[h - P:h].contiguous(), hp, bperm, g, D, "classic")
        err = float((torch.cat([a1, a2]) - a_f32).abs().max())
        say(f"kernel-vs-plain: streaming split at frame {h} vs whole "
            f"max_abs_err={err:.3e} tol={STREAM_TOL:g}")
        check(err <= STREAM_TOL, "streaming split changes the output")
    small = Channelizer(channels=8, taps_per_branch=4, audio_decim=4,
                        sample_rate=16e6)
    xs = small.make_input_full(1024, seed=3, device=dev).reshape(1024, 16)
    hs = torch.zeros((4, 16), device=dev)
    err = float((K(xs, hs, small.hp5, small.bperm5, small.fm_ref, 4)
                 - plain(xs, hs, small.hp5, small.bperm5, small.fm_ref, 4)
                 ).abs().max())
    errs.append(err)
    say(f"kernel-vs-plain: C=8 P=4 D=4 M=1024 max_abs_err={err:.3e}")
    check(err <= TOL, "small-shape kernel disagrees")

    def decim_route(kernel: str, m_, x, hist_):
        """(wrapper, plain version, arguments) of K8 ("v4") or K9
        ("v6") on model ``m_``'s tables."""
        if kernel == "v4":
            return K8, kernels.channelize_demod_decim_v4_plain, (
                x, hist_, m_.bp4, m_.fm_ref, m_.audio_decim)
        return K9, kernels.channelize_demod_decim_v6_plain, (
            x, hist_, m_.hp5, m_.bperm5, m_.fm_ref, m_.audio_decim)

    half = M // 2
    for kernel in KERNEL_VARIANTS:
        for hname, hh, m_, x in (("zero hist", zero_hist, model, x2),
                                 ("non-zero hist", hist, model, x2),
                                 ("C=8 P=4 D=4 M=1024", hs, small, xs)):
            fn, plain_fn, args = decim_route(kernel, m_, x, hh)
            got, ref = fn(*args), plain_fn(*args)
            torch.cuda.synchronize()
            check(got.shape == (x.shape[0] // m_.audio_decim, m_.channels)
                  and bool(torch.isfinite(got).all()),
                  f"{fn.__name__} {hname}: output shape/finite")
            err = float((got - ref).abs().max())
            cerrs[kernel].append(err)
            say(f"kernel-vs-plain: {fn.__name__} {hname} max_abs_err="
                f"{err:.3e} tol={TOL:g}")
            check(err <= TOL, f"{fn.__name__} {hname}: {err} > {TOL}")
        fn, _, args = decim_route(kernel, model, x2, zero_hist)
        whole = fn(*args)
        for h in (half, half + 5 * D):
            a1 = fn(*decim_route(kernel, model, x2[:h], zero_hist)[2])
            a2 = fn(*decim_route(kernel, model, x2[h:],
                                 x2[h - P:h].contiguous())[2])
            err = float((torch.cat([a1, a2]) - whole).abs().max())
            say(f"kernel-vs-plain: {fn.__name__} streaming split at frame "
                f"{h} vs whole max_abs_err={err:.3e} tol={STREAM_TOL:g}")
            check(err <= STREAM_TOL, f"{fn.__name__}: streaming split "
                  "changes the output")

    def halves_rows(frames):
        """(n, C, 2) frames -> (n, 2C) rows [re 0..C-1 | im 0..C-1]."""
        return frames.permute(0, 2, 1).reshape(frames.shape[0], -1) \
            .contiguous()

    def k7_case(m_, frames: int, seed: int):
        """ext (frames + P - 1, 2C) of a full band and a non-zero prev."""
        rows = m_.make_input_full(frames + m_.taps_per_branch, seed=seed,
                                  device=dev)
        return halves_rows(rows[1:]), halves_rows(rows[:1])

    def ylast_err(got, ref) -> float:
        """|ylast - ref| over max(1, max|ref|): y frames grow with C."""
        return float((got - ref).abs().max()) / max(1.0,
                                                    float(ref.abs().max()))

    ext7, prev7 = k7_case(model, M, seed=4)
    small_ext, small_prev = k7_case(small, 1024, seed=5)
    for variant in CARRY_VARIANTS:
        for what, m_, e, pv in (("C=64 P=8 M=131072", model, ext7, prev7),
                                ("C=8 P=4 M=1024", small, small_ext,
                                 small_prev)):
            args = (e, m_.hp, m_.wr, m_.wi, pv, m_.fm_ref, variant)
            (got, glast), (ref, rlast) = K7(*args), K7p(*args)
            torch.cuda.synchronize()
            frames = e.shape[0] - m_.taps_per_branch + 1
            check(got.shape == (frames, m_.channels)
                  and bool(torch.isfinite(got).all())
                  and bool(torch.isfinite(glast).all()),
                  f"channelize_demod {variant} {what}: output shape/finite")
            err, yerr = float((got - ref).abs().max()), ylast_err(glast,
                                                                  rlast)
            cerrs[variant].append(err)
            say(f"kernel-vs-plain: channelize_demod {variant} {what} demod "
                f"max_abs_err={err:.3e}, ylast {yerr:.3e} of max(1, |y|) "
                f"tol={TOL:g}")
            check(err <= TOL and yerr <= TOL,
                  f"channelize_demod {variant} {what}: {err}, {yerr}")
        rest = (model.hp, model.wr, model.wi)
        whole, wlast = K7(ext7, *rest, prev7, g, variant)
        a1, l1 = K7(ext7[:half + P - 1].contiguous(), *rest, prev7, g,
                    variant)
        a2, l2 = K7(ext7[half:].contiguous(), *rest, l1, g, variant)
        err = float((torch.cat([a1, a2]) - whole).abs().max())
        yerr = ylast_err(l2, wlast)
        say(f"kernel-vs-plain: channelize_demod {variant} streaming two "
            f"halves, ylast carried into prev, vs whole max_abs_err="
            f"{err:.3e}, ylast {yerr:.3e} tol={STREAM_TOL:g}")
        check(err <= STREAM_TOL and yerr <= STREAM_TOL,
              f"channelize_demod {variant}: streaming split changes the "
              "output")
    del ext7, whole, a1, a2

    rx = WbfmReceiver(device=dev)
    taps, g4 = rx._taps, rx._ref
    wiq = rx.make_input(WN, seed=1, device=dev)
    wzero = torch.zeros((2, WT - 1), device=dev)
    whist = rx.make_input(2 * WT, seed=2, device=dev)[-(WT - 1):].T \
        .contiguous()

    def wcompare(name: str, kind: str, got, ref, shape) -> None:
        torch.cuda.synchronize()
        check(tuple(got.shape) == shape and bool(torch.isfinite(got).all()),
              f"{name}: output shape/finite")
        err = float((got - ref).abs().max())
        werrs[kind].append(err)
        say(f"kernel-vs-plain: {name} max_abs_err={err:.3e} tol={TOL:g}")
        check(err <= TOL, f"{name}: max abs error {err} > {TOL}")

    wx = wiq.T.contiguous()                       # planar, for wbfm_fused
    for hname, hh in (("zero hist", wzero), ("non-zero hist", whist)):
        wcompare(f"wbfm_fused_v2 classic, {hname}", "classic",
                 W4(wiq, taps, hh, g4), W4p(wiq, taps, hh, g4), (WN,))
        wcompare(f"wbfm_fused_v2 coherent D={WD}, {hname}", "coherent",
                 W4(wiq, taps, hh, g4, WD), W4p(wiq, taps, hh, g4, WD),
                 (WN // WD,))
        wcompare(f"wbfm_fused (planar), {hname}", "v1",
                 W12(wx, taps, hh, g4), W12p(wx, taps, hh, g4), (WN,))
    h = WN // 2
    for dd, kind in ((0, "classic"), (WD, "coherent")):
        whole = W4(wiq, taps, whist, g4, dd)
        a1 = W4(wiq[:h], taps, whist, g4, dd)
        a2 = W4(wiq[h:], taps, wiq[h - WT + 1:h].T.contiguous(), g4, dd)
        err = float((torch.cat([a1, a2]) - whole).abs().max())
        say(f"kernel-vs-plain: wbfm_fused_v2 {kind} streaming two halves "
            f"vs whole max_abs_err={err:.3e} tol={STREAM_TOL:g}")
        check(err <= STREAM_TOL, f"wbfm {kind}: streaming split changes "
              "the output")
    small = WbfmReceiver(taps=33, audio_decim=6, device=dev)
    xs = small.make_input(128 * 37, seed=3, device=dev)   # odd rows, ragged
    hs = torch.zeros((2, 32), device=dev)
    for dd, kind in ((0, "classic"), (6, "coherent")):
        wcompare(f"wbfm_fused_v2 {kind} T=33 n=128*37", kind,
                 W4(xs, small._taps, hs, small._ref, dd),
                 W4p(xs, small._taps, hs, small._ref, dd),
                 ((128 * 37) // dd,) if dd else (128 * 37,))

    sp = SpectrumPipeline(fft_size=SN, batches=SB, device=dev)
    sconst = (sp._win, sp._coeff, sp._scale, sp._offset)
    siq = sp.make_input(seed=1, device=dev)
    siq[7] = 0.0                              # a buffer row not yet filled

    def scompare(name: str, x, sconst_, shape):
        got, ref = S2(x, *sconst_), S2p(x, *sconst_)
        torch.cuda.synchronize()
        check(tuple(got.shape) == shape, f"{name}: output shape")
        err = float((got - ref).abs().max())
        serrs.append(err)
        same_bins = bool(torch.equal(got.argmax(-1), ref.argmax(-1)))
        say(f"kernel-vs-plain: {name} max_abs_err={err:.3e} tol={TOL:g} "
            f"argmax_equal={same_bins}")
        check(err <= TOL, f"{name}: max abs error {err} > {TOL}")
        check(same_bins, f"{name}: bin order differs from the plain version")
        return got

    sgot = scompare(f"spectrum_fused_ct5 B={SB} n={SN}", siq, sconst,
                    (SB, SN))
    check(bool((sgot[7] == 0.0).all()), "spectrum: the zero row is not 0")
    check(bool(torch.isfinite(sgot).all()), "spectrum: non-finite output")
    # against a float64 truth (torch.fft.fft in double, a yardstick only),
    # held to the JAX tests' 1e-3 of the f64 truth
    truth = spectrum_truth(torch, siq, sp)
    t_err = float((sgot.double() - truth).abs().max())
    say(f"kernel-vs-truth: spectrum_fused_ct5 B={SB} n={SN} vs float64 "
        f"max_abs_err={t_err:.3e} tol=1e-3")
    check(t_err <= 1e-3, f"spectrum: {t_err} from the float64 truth")
    del truth
    for n in (128, 256, 512, 1024, 2048, 4096):
        small = SpectrumPipeline(fft_size=n, batches=37, device=dev)
        scompare(f"spectrum_fused_ct5 B=37 n={n}",
                 small.make_input(seed=n, device=dev),
                 (small._win, small._coeff, small._scale, small._offset),
                 (37, n))

    def fcompare(name: str, x):
        got, ref = F3(x), F3p(x)
        truth = torch.fft.fft(x.to(torch.complex128), dim=-1)
        steps = kernels.stockham_fft_plain(x)
        torch.cuda.synchronize()
        check(got.shape == x.shape and got.dtype == torch.complex64
              and bool(torch.isfinite(torch.view_as_real(got)).all()),
              f"{name}: output shape/dtype/finite")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        t_rel = float((got.to(torch.complex128) - truth).abs().max()
                      / truth.abs().max())
        s_rel = float((got - steps).abs().max() / steps.abs().max())
        ferrs.append(err)
        say(f"kernel-vs-plain: {name} max_abs_err={err:.3e} "
            f"rel={rel:.3e}, vs complex128 truth rel={t_rel:.3e}, vs the "
            f"model of its passes rel={s_rel:.3e} tol={FFT_TOL:g} of "
            "max|X|")
        check(rel <= FFT_TOL, f"{name}: {rel} of max|X| from the plain "
              "version")
        check(t_rel <= FFT_TOL, f"{name}: {t_rel} of max|X| from the truth")
        check(s_rel <= FFT_TOL, f"{name}: {s_rel} of max|X| from the model "
              "of its passes")
        return got

    fx = crandn(SB, SN)
    fgot = fcompare(f"fft_pallas B={SB} n={SN}", fx)
    for n in (128, 256, 512, 1024, 2048, 4096):
        fcompare(f"fft_pallas B=37 n={n}", crandn(37, n))
    fcompare("fft_pallas (2, 3, 1024)", crandn(2, 3, 1024))
    rt = FftPallasModule(
        "rt/m", {"forward": False}, {"signal": TensorSpec(
            (37, 1024), DataType.CF32, Device.CUDA,
            SignalAxes(batch=0, sample=1))}, device=Device.CUDA)
    rt_x = crandn(37, 1024)
    back = rt.apply({"signal": torch.fft.fft(rt_x.to(torch.complex128))
                     .to(torch.complex64)}, None)[0]["signal"]
    err = float((back - 1024 * rt_x).abs().max())
    say(f"kernel-vs-plain: fft module backward round trip (37, 1024) "
        f"|back - n x| max={err:.3e} tol={RT_TOL:g}")
    check(err <= RT_TOL, "fft backward round trip")

    def rcompare(kern, plain_fn, x, sp_, plain_rows=None):
        """K6 or K5 against its plain version (1e-4, the argmax bin of
        every row, for n <= 3 but for bins the float64 truth ties: at n = 3
        the window leaves one sample; exactly 0 on every zero row) and against the float64 truth (1e-3, the JAX tests'
        bar); K6 on the route ``kernels.k6_route`` names, and on its FFT,
        split and chirp routes also against the plain model of its passes
        (1e-4, and the argmax bin of every row).  With ``plain_rows``, the
        plain version (a float64 product) takes the first rows only."""
        B_, n_ = x.shape[:2]
        name = f"{kern.__name__} B={B_} n={n_}"
        args = (sp_._win, sp_._coeff, sp_._scale, sp_._offset)
        route = kernels.k6_route(n_) if kern is S6 else None
        before = dict(S6.routes)
        got = kern(x, *args)
        xp = x[:plain_rows] if plain_rows else x
        ref = plain_fn(xp, *args)
        truth = spectrum_truth(torch, x, sp_)
        steps = {"fft": kernels.spectrum_fft_plain,
                 "split": kernels.spectrum_split_plain,
                 "chirp": kernels.spectrum_chirp_plain}.get(route)
        steps = steps and steps(x, *args)
        torch.cuda.synchronize()
        check(tuple(got.shape) == (B_, n_)
              and bool(torch.isfinite(got).all()),
              f"{name}: output shape/finite")
        gp, tp = got[:len(xp)], truth[:len(xp)]
        err = float((gp - ref).abs().max())
        t_err = float((got.double() - truth).abs().max())
        p_err = float((ref.double() - tp).abs().max())
        a, b = gp.argmax(-1, keepdim=True), ref.argmax(-1, keepdim=True)
        tied = (tp.gather(-1, a) - tp.gather(-1, b)).abs() <= 1e-12
        if n_ > 3:
            tied = torch.zeros_like(tied)
        same_bins = bool(((a == b) | tied).all())
        zero = x.abs().amax(dim=(1, 2)) == 0
        zeros = bool((got[zero] == 0).all())
        rerrs[route or kern].append(err)
        line = (f"kernel-vs-plain: {name}"
                + (f" ({route} route)" if route else "")
                + f" max_abs_err={err:.3e}"
                + (f" on {len(xp)} rows" if plain_rows else "")
                + f" tol={TOL:g} "
                f"argmax_equal={same_bins} (ties {int((tied & (a != b)).sum())}"
                f") zero_rows={int(zero.sum())} exactly_0={zeros}; vs "
                f"float64 truth {t_err:.3e} (plain {p_err:.3e}) tol=1e-3")
        if steps is not None:
            s_err = float((got - steps).abs().max())
            s_bins = n_ <= 3 or bool(torch.equal(got.argmax(-1),
                                                 steps.argmax(-1)))
            line += (f"; vs the model of its passes {s_err:.3e} tol={TOL:g} "
                     f"argmax_equal={s_bins}")
            check(s_err <= TOL, f"{name}: {s_err} from the model of its "
                  "passes")
            check(s_bins, f"{name}: bin order differs from the model of its "
                  "passes")
        say(line)
        check(err <= TOL, f"{name}: max abs error {err} > {TOL}")
        check(same_bins, f"{name}: bin order differs from the plain version")
        check(zeros, f"{name}: a zero row is not 0")
        check(t_err <= 1e-3, f"{name}: {t_err} from the float64 truth")
        if route:
            check(S6.routes == {**before, route: before[route] + 1},
                  f"{name}: not launched on the {route} route")

    rcompare(S6, S6p, siq, sp)                 # the spectrum path's buffer
    dsp = SpectrumPipeline(fft_size=DN, batches=DB, device=dev)
    diq = dsp.make_input(seed=2, device=dev)
    diq[5] = 0.0
    rcompare(S6, S6p, diq, dsp)
    for n in K6_SIZES:
        small = SpectrumPipeline(fft_size=n, batches=37, device=dev)
        x = small.make_input(seed=n, device=dev)
        x[3] = 0.0
        rcompare(S6, S6p, x, small)
    csp = SpectrumPipeline(fft_size=CN, batches=CB, device=dev)
    ciq = csp.make_input(seed=3, device=dev)
    ciq[11] = 0.0
    rcompare(S6, S6p, ciq, csp)                # the runtime plan, 8 8 8 3
    # the split route: (input, pipeline) by (B, n)
    split_cases = {}
    for B_, n_ in SPLIT_SHAPES:
        p = SpectrumPipeline(fft_size=n_, batches=B_, device=dev)
        x = p.make_input(seed=n_, device=dev)
        x[2] = 0.0
        check(kernels.k6_route(n_) == "split", f"K6 n={n_}: not the split "
              "route")
        if n_ in PRIME_FIRST_N:
            check(kernels._large_prime(kernels.k6_split(n_)[0]) > 0,
                  f"K6 n={n_}: pass A holds no large prime")
        rcompare(S6, S6p, x, p,
                 PLAIN_ROWS if B_ * n_ > PLAIN_MAX_SAMPLES else None)
        split_cases[B_, n_] = (x, p)
    # the chirp route: (input, pipeline) by (B, n)
    for n in K6_CHIRP_SIZES:
        small = SpectrumPipeline(fft_size=n, batches=37, device=dev)
        x = small.make_input(seed=n, device=dev)
        x[3] = 0.0
        check(kernels.k6_route(n) == "chirp", f"K6 n={n}: not the chirp "
              "route")
        rcompare(S6, S6p, x, small)
    chirp_cases = {}
    for B_, n_ in CHIRP_SHAPES:
        p = SpectrumPipeline(fft_size=n_, batches=B_, device=dev)
        x = p.make_input(seed=4 if B_ == DXB else n_, device=dev)
        x[2] = 0.0
        check(kernels.k6_route(n_) == "chirp", f"K6 n={n_}: not the chirp "
              "route")
        rcompare(S6, S6p, x, p,
                 PLAIN_ROWS if B_ * n_ > PLAIN_MAX_SAMPLES else None)
        chirp_cases[B_, n_] = (x, p)
    for B_, n_ in CHIRP_CHECK_SHAPES:
        p = SpectrumPipeline(fft_size=n_, batches=B_, device=dev)
        x = p.make_input(seed=n_, device=dev)
        x[-1] = 0.0
        check(kernels.k6_route(n_) == "chirp", f"K6 n={n_}: not the chirp "
              "route")
        rcompare(S6, S6p if n_ <= PLAIN_MAX_SAMPLES
                 else kernels.spectrum_chirp_plain, x, p)
        del x
    xiq, xsp = chirp_cases[DXB, DXN]
    # the direct product, on a forced route
    own_route = kernels.k6_route
    kernels.k6_route = lambda n: "direct"
    try:
        for n in K6_DIRECT_SIZES:
            small = SpectrumPipeline(fft_size=n, batches=37, device=dev)
            x = small.make_input(seed=n, device=dev)
            x[3] = 0.0
            rcompare(S6, S6p, x, small)
    finally:
        kernels.k6_route = own_route
    rcompare(S5, S5p, ciq, csp)
    for m in range(1, 33):
        small = SpectrumPipeline(fft_size=128 * m, batches=37, device=dev)
        x = small.make_input(seed=m, device=dev)
        x[3] = 0.0
        rcompare(S5, S5p, x, small)

    # -- 3. the main path ---------------------------------------------------------
    fg = Flowgraph()                                   # on the card
    fg.block_create("src", "dti", {"shape": [M, C], "dataType": "CF32"})
    fg.block_create("sq", "squelch", {"threshold": THRESHOLD},
                    {"signal": "${graph.src.output.buffer}"})
    fg.block_create("chan", "channelizer",
                    {"tapsPerBranch": P, "audioDecim": D},
                    {"buffer": "${graph.sq.output.signal}"},
                    provider="pallas")
    for name in fg.records:
        check(fg.block_state(name).value == "complete",
              f"block {name}: {fg.block_error(name)}")
    src = fg.block_module("src")
    bufs = [torch.view_as_complex(
        model.make_input_full(M, seed=s, device=dev)) for s in (11, 12, 13)]
    refs, st = [], zero_hist
    for b in bufs:
        xb = torch.view_as_real(b).reshape(M, 2 * C)
        refs.append(plain(xb, st, hp, bperm, g, D, "classic"))
        st = xb[M - P:]
    torch.cuda.synchronize()

    zero_counts()                     # count the path's launches only
    for i, (b, ref) in enumerate(zip(bufs, refs)):
        src.attach_buffer(b)
        check(fg.compute(), f"cycle {i} did not run")
        out = fg.scheduler.output_tensor("chan.audio")
        check(fg.scheduler.output_valid("chan.audio"), f"cycle {i} invalid")
        check(tuple(out.shape) == (M // D, C)
              and bool(torch.isfinite(out).all()),
              f"cycle {i}: output shape/finite")
        err = float((out - ref).abs().max())
        errs.append(err)
        say(f"main-path: cycle {i} audio vs chained plain "
            f"max_abs_err={err:.3e} launches={K.launches}")
        check(err <= TOL, f"cycle {i}: {err} > {TOL}")
        check(K.launches == i + 1, "kernel launches != valid cycles")
    hist_before = fg.scheduler.state_of("chan/m")["hist"].clone()
    src.attach_buffer(torch.zeros_like(bufs[0]))
    check(fg.compute(), "silent cycle did not run")
    valid = fg.scheduler.output_valid("chan.audio")
    frozen = torch.equal(hist_before,
                         fg.scheduler.state_of("chan/m")["hist"])
    launches = K.launches
    say(f"main-path: silent cycle valid={valid} state_frozen={frozen} "
        f"metrics={fg.scheduler.metrics().get('sq/m')}")
    check(not valid and frozen, "squelch did not gate the silent cycle")
    say(f"main-path: launches {counts()}")
    check(launches > 0, "the main path never launched the kernel")

    def carry_plain(variant: str, st_, iq):
        """One step_carry_kernel step in plain torch: the model's ext
        rows, K7's plain version, the boxcar mean."""
        x = iq.permute(2, 1, 0)
        ext3 = torch.cat([st_["hist"], x], dim=-1)
        ext = ext3.permute(2, 0, 1).reshape(M + P - 1, 2 * C)
        demod, ylast = K7p(ext, model.hp, model.wr, model.wi,
                           st_["prev"].reshape(1, 2 * C), g, variant)
        return demod.reshape(M // D, D, C).mean(1), {
            "hist": ext3[:, :, M:], "prev": ylast.reshape(2, C)}

    mpaths = {}                       # route -> (launches, step for timing)
    iqs = [torch.view_as_real(b) for b in bufs]
    for route in CARRY_VARIANTS + KERNEL_VARIANTS:
        carry = route in CARRY_VARIANTS
        kern = route_kernel[route]
        if carry:
            def step(st_, iq, route=route):
                return model.step_carry_kernel(st_, iq, variant=route)

            def plain_step(st_, iq, route=route):
                return carry_plain(route, st_, iq)
            init = model.init_state
        else:
            def step(st_, iq, route=route):
                return model.step_kernel(st_, iq, kernel=route)

            def plain_step(st_, iq, route=route):
                x = iq.reshape(M, 2 * C)
                _, fn_p, args = decim_route(route, model, x, st_["hist"])
                return fn_p(*args), {"hist": x[M - P:]}
            init = model.init_state_v4
        what = (f"Channelizer.step_carry_kernel(variant={route!r})" if carry
                else f"Channelizer.step_kernel(kernel={route!r})")
        refs, st = [], init()
        for iq in iqs:
            ref, st = plain_step(st, iq)
            refs.append(ref)
        xla = []                      # the reference step (torch.atan2)
        if carry:
            st = model.init_state()
            for iq in iqs:
                a, st = model.step(st, iq)
                xla.append(a)
        torch.cuda.synchronize()
        zero_counts()
        st = init()
        for i, (iq, ref) in enumerate(zip(iqs, refs)):
            out, st = step(st, iq)
            torch.cuda.synchronize()
            check(tuple(out.shape) == (M // D, C)
                  and bool(torch.isfinite(out).all()),
                  f"{what} step {i}: output shape/finite")
            err = float((out - ref).abs().max())
            cerrs[route].append(err)
            line = (f"main-path: {what} step {i} audio vs chained plain "
                    f"max_abs_err={err:.3e}")
            check(err <= TOL, f"{what} step {i}: {err} > {TOL}")
            if carry:
                x_err = float((out - xla[i]).abs().max())
                line += f", vs the reference step {x_err:.3e}"
                check(x_err <= TOL, f"{what} step {i}: {x_err} from the "
                      "reference step")
            say(line + f" tol={TOL:g} launches={kern.launches}")
        got = counts()
        say(f"main-path: {what} launches {got}")
        check(got == {w.__name__: len(iqs) if w is kern else 0
                      for w in wrappers},
              f"{what}: {kern.__name__} did not run once a step alone")
        mpaths[route] = (got[kern.__name__], what, step, init)

    wbufs = [torch.view_as_complex(rx.make_input(WN, seed=s, device=dev))
             for s in (21, 22, 23)]

    def plain_chain(fn, dd: int):
        """The plain version chained over ``wbufs`` from a zero history."""
        outs, st = [], wzero
        for b in wbufs:
            xb = torch.view_as_real(b)
            a = fn(xb, st, dd)
            outs.append(a if dd else a.reshape(-1, WD).mean(1))
            st = xb[WN - WT + 1:].T.contiguous()
        return outs

    wfgs, wlaunches = {}, {}
    for mode in ("classic", "coherent"):
        dd = WD if mode == "coherent" else 0
        refs = plain_chain(lambda xb, st, d: W4p(xb, taps, st, g4, d), dd)
        torch.cuda.synchronize()
        wfg = Flowgraph()                              # on the card
        wfg.block_create("src", "dti", {"shape": [WN], "dataType": "CF32"})
        wfg.block_create("rx", "wbfm", {"demodMode": mode},
                         {"buffer": "${graph.src.output.buffer}"},
                         provider="pallas")
        for name in wfg.records:
            check(wfg.block_state(name).value == "complete",
                  f"wbfm block {name}: {wfg.block_error(name)}")
        zero_counts()
        for i, (b, ref) in enumerate(zip(wbufs, refs)):
            wfg.block_module("src").attach_buffer(b)
            check(wfg.compute(), f"wbfm {mode} cycle {i} did not run")
            out = wfg.scheduler.output_tensor("rx.audio")
            check(wfg.scheduler.output_valid("rx.audio"),
                  f"wbfm {mode} cycle {i} invalid")
            check(tuple(out.shape) == (WN // WD,)
                  and bool(torch.isfinite(out).all()),
                  f"wbfm {mode} cycle {i}: output shape/finite")
            err = float((out - ref).abs().max())
            werrs[mode].append(err)
            say(f"main-path: dti -> wbfm {mode} cycle {i} audio vs chained "
                f"plain max_abs_err={err:.3e} launches={W4.launches}")
            check(err <= TOL, f"wbfm {mode} cycle {i}: {err} > {TOL}")
        wlaunches[mode] = W4.launches
        say(f"main-path: dti -> wbfm {mode} launches {counts()}")
        check(W4.launches == len(wbufs),
              "the wbfm path did not launch wbfm_fused_v2 once a cycle")
        wfgs[mode] = wfg

    refs = plain_chain(lambda xb, st, d: W12p(xb.T, taps, st, g4), 0)
    torch.cuda.synchronize()
    zero_counts()
    st = rx.init_state()
    for i, (b, ref) in enumerate(zip(wbufs, refs)):
        out, st = rx.step_kernel(st, torch.view_as_real(b), version="v1")
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        werrs["v1"].append(err)
        say(f"main-path: WbfmReceiver.step_kernel(version='v1') cycle {i} "
            f"audio vs chained plain max_abs_err={err:.3e}")
        check(err <= TOL, f"wbfm v1 cycle {i}: {err} > {TOL}")
    wlaunches["v1"] = W12.launches
    say(f"main-path: step_kernel v1 launches {counts()}")
    check(W12.launches == len(wbufs),
          "the v1 path did not launch wbfm_fused once a step")

    sbufs = [torch.view_as_complex(sp.make_input(seed=s, device=dev))
             for s in (31, 32, 33)]
    sbufs[0][3] = 0                           # one row not yet filled
    srefs = [S2p(torch.view_as_real(b), *sconst) for b in sbufs]
    torch.cuda.synchronize()
    sfg = Flowgraph()                                  # on the card
    sfg.block_create("src", "dti", {"shape": [SB, SN], "dataType": "CF32"})
    sfg.block_create("spec", "spectrum", {},
                     {"buffer": "${graph.src.output.buffer}"},
                     provider="pallas")
    for name in sfg.records:
        check(sfg.block_state(name).value == "complete",
              f"spectrum block {name}: {sfg.block_error(name)}")
    zero_counts()
    for i, (b, ref) in enumerate(zip(sbufs, srefs)):
        sfg.block_module("src").attach_buffer(b)
        check(sfg.compute(), f"spectrum cycle {i} did not run")
        out = sfg.scheduler.output_tensor("spec.spectrum")
        check(sfg.scheduler.output_valid("spec.spectrum"),
              f"spectrum cycle {i} invalid")
        check(tuple(out.shape) == (SB, SN)
              and bool(torch.isfinite(out).all()),
              f"spectrum cycle {i}: output shape/finite")
        err = float((out - ref).abs().max())
        serrs.append(err)
        say(f"main-path: dti -> spectrum cycle {i} vs plain "
            f"max_abs_err={err:.3e} launches={S2.launches}")
        check(err <= TOL, f"spectrum cycle {i}: {err} > {TOL}")
        check(i or bool((out[3] == 0.0).all()),
              "spectrum cycle 0: the zero row is not 0")
    slaunches = S2.launches
    say(f"main-path: dti -> spectrum launches {counts()}")
    check(slaunches == len(sbufs),
          "the spectrum path did not launch spectrum_fused_ct5 once a cycle")
    souts = [sfg.scheduler.output_tensor("spec.spectrum")]  # last cycle

    def only_k3(what: str, cycles: int) -> None:
        got = counts()
        say(f"main-path: {what} launches {got}")
        check(got == {w.__name__: cycles if w is F3 else 0
                      for w in wrappers},
              f"{what}: fft_pallas did not run once a cycle alone")

    fbufs = [crandn(SB, SN) for _ in range(3)]
    ffgs, flaunches = {}, {}
    for forward in (True, False):
        kind = "forward" if forward else "backward"
        refs = [F3p(b) if forward else
                torch.conj_physical(F3p(torch.conj_physical(b)))
                for b in fbufs]
        torch.cuda.synchronize()
        ffg = Flowgraph()                              # on the card
        ffg.block_create("src", "dti", {"shape": [SB, SN],
                                        "dataType": "CF32"})
        ffg.block_create("fft", "fft", {"forward": forward},
                         {"signal": "${graph.src.output.buffer}"},
                         provider="pallas")
        for name in ffg.records:
            check(ffg.block_state(name).value == "complete",
                  f"fft block {name}: {ffg.block_error(name)}")
        zero_counts()
        for i, (b, ref) in enumerate(zip(fbufs, refs)):
            ffg.block_module("src").attach_buffer(b)
            check(ffg.compute(), f"fft {kind} cycle {i} did not run")
            out = ffg.scheduler.output_tensor("fft.signal")
            check(ffg.scheduler.output_valid("fft.signal"),
                  f"fft {kind} cycle {i} invalid")
            check(tuple(out.shape) == (SB, SN)
                  and bool(torch.isfinite(torch.view_as_real(out)).all()),
                  f"fft {kind} cycle {i}: output shape/finite")
            err = float((out - ref).abs().max())
            rel = err / float(ref.abs().max())
            ferrs.append(err)
            say(f"main-path: dti -> fft {kind} cycle {i} vs plain "
                f"max_abs_err={err:.3e} rel={rel:.3e} "
                f"launches={F3.launches}")
            check(rel <= FFT_TOL, f"fft {kind} cycle {i}: {rel}")
        flaunches[kind] = F3.launches
        only_k3(f"dti -> fft {kind}", len(fbufs))
        ffgs[kind] = ffg

    ebufs = [torch.randn((EB, SN), device=dev, generator=gen)
             for _ in range(3)]                        # bench.py:580
    efgs, elaunches = {}, {}
    for kind, shape, dtype, config, lo, ebatch in (
            ("F32 512x2048", [EB, SN], "F32", {"enableScale": True},
             -120.0, ebufs),
            ("CF32 4096x2048", [SB, SN], "CF32",
             {"enableScale": True, "rangeMin": -100, "rangeMax": 0},
             -100.0, sbufs)):
        erefs = [engine_plain(b, lo, 0.0) for b in ebatch]
        torch.cuda.synchronize()
        efg = Flowgraph()                              # on the card
        efg.block_create("src", "dti", {"shape": shape, "dataType": dtype})
        efg.block_create("spec", "spectrum_engine", config,
                         {"buffer": "${graph.src.output.buffer}"})
        for name in efg.records:
            check(efg.block_state(name).value == "complete",
                  f"spectrum_engine block {name}: {efg.block_error(name)}")
        real = dtype == "F32"
        zero_counts()
        eouts = []
        for i, (b, ref) in enumerate(zip(ebatch, erefs)):
            efg.block_module("src").attach_buffer(b)
            check(efg.compute(), f"spectrum_engine {kind} cycle {i} did "
                  "not run")
            out = efg.scheduler.output_tensor("spec.buffer")
            check(efg.scheduler.output_valid("spec.buffer"),
                  f"spectrum_engine {kind} cycle {i} invalid")
            check(tuple(out.shape) == tuple(shape)
                  and bool(torch.isfinite(out).all()),
                  f"spectrum_engine {kind} cycle {i}: output shape/finite")
            err = float((out - ref).abs().max())
            peaks = same_peaks(out, ref, real)
            say(f"main-path: dti -> spectrum_engine {kind} cycle {i} vs "
                f"plain chain max_abs_err={err:.3e} tol={TOL:g} "
                f"argmax_equal={peaks} launches={F3.launches}")
            check(err <= TOL, f"spectrum_engine {kind} cycle {i}: {err}")
            check(peaks, f"spectrum_engine {kind} cycle {i}: bin order")
            eouts.append(out.clone())
        elaunches[kind] = F3.launches
        only_k3(f"dti -> spectrum_engine {kind}", len(ebatch))
        efgs[kind] = efg
    # the composite and the fused spectrum block compute one function
    cross = max(float((o - r).abs().max()) for o, r in zip(eouts, srefs))
    last = float((eouts[-1] - souts[0]).abs().max())
    say(f"main-path: spectrum_engine CF32 vs the spectrum block's plain "
        f"version max_abs_err={cross:.3e}, vs the spectrum block's last "
        f"cycle {last:.3e} tol={TOL:g}")
    check(max(cross, last) <= TOL, "spectrum_engine and spectrum disagree")

    def route_path(what, dtype, config, bufs, kern, plain_fn, sp_):
        """Drive dti -> spectrum over ``bufs`` with the launch counters
        zeroed, each cycle against ``plain_fn`` on its buffer; only
        ``kern`` launches, once a cycle.  Returns the flowgraph, the
        launches and each cycle's output."""
        args = (sp_._win, sp_._coeff, sp_._scale, sp_._offset)
        rows = [torch.view_as_real(b) if b.is_complex() else b for b in bufs]
        refs_ = [plain_fn(x, *args) for x in rows]
        torch.cuda.synchronize()
        rfg = Flowgraph()                              # on the card
        rfg.block_create("src", "dti", {"shape": list(bufs[0].shape),
                                        "dataType": dtype})
        rfg.block_create("spec", "spectrum", config,
                         {"buffer": "${graph.src.output.buffer}"},
                         provider="pallas")
        for name in rfg.records:
            check(rfg.block_state(name).value == "complete",
                  f"{what} block {name}: {rfg.block_error(name)}")
        zero_counts()
        outs = []
        for i, (b, x, ref) in enumerate(zip(bufs, rows, refs_)):
            rfg.block_module("src").attach_buffer(b)
            check(rfg.compute(), f"{what} cycle {i} did not run")
            out = rfg.scheduler.output_tensor("spec.spectrum")
            check(rfg.scheduler.output_valid("spec.spectrum"),
                  f"{what} cycle {i} invalid")
            check(tuple(out.shape) == tuple(x.shape[:2])
                  and bool(torch.isfinite(out).all()),
                  f"{what} cycle {i}: output shape/finite")
            err = float((out - ref).abs().max())
            peaks = bool(torch.equal(out.argmax(-1), ref.argmax(-1)))
            zero = x.abs().amax(dim=(1, 2)) == 0
            rerrs[kernels.k6_route(x.shape[1]) if kern is S6 else kern] \
                .append(err)
            say(f"main-path: {what} cycle {i} vs plain max_abs_err="
                f"{err:.3e} tol={TOL:g} argmax_equal={peaks} "
                f"launches={kern.launches}")
            check(err <= TOL, f"{what} cycle {i}: {err} > {TOL}")
            check(peaks, f"{what} cycle {i}: bin order")
            check(bool((out[zero] == 0).all()), f"{what} cycle {i}: a zero "
                  "row is not 0")
            outs.append(out.clone())
        got = counts()
        say(f"main-path: {what} launches {got}"
            + (f", K6 by route {S6.routes}" if kern is S6 else ""))
        check(got == {w.__name__: len(bufs) if w is kern else 0
                      for w in wrappers},
              f"{what}: {kern.__name__} did not run once a cycle alone")
        if kern is S6:
            route = kernels.k6_route(rows[0].shape[1])
            check(S6.routes == {r: len(bufs) if r == route else 0
                                for r in kernels.K6_ROUTES},
                  f"{what}: K6 did not run its {route} route once a cycle")
        return rfg, got[kern.__name__], outs

    routes = []                # (what, flowgraph, a buffer, launches)
    path_launches = {}         # kernels row -> launches on its path
    what = "dti -> spectrum {algorithm: dft} 4096 x 2048 CF32"
    rfg, rl, douts = route_path(what, "CF32", {"algorithm": "dft"}, sbufs,
                                S6, S6p, sp)
    routes.append((what, rfg, sbufs[1], rl))
    path_launches["spectrum_fused[fft]"] = rl
    # K6 and K2 compute one function: the same buffers through both
    cross = max(float((o - r).abs().max()) for o, r in zip(douts, srefs))
    last = float((douts[-1] - souts[0]).abs().max())
    peaks = all(torch.equal(o.argmax(-1), r.argmax(-1))
                for o, r in zip(douts, srefs))
    say(f"main-path: dft route vs the ct5 (K2) route on the same buffers: "
        f"vs K2's plain version max_abs_err={cross:.3e}, vs the K2 "
        f"block's last cycle {last:.3e} tol={TOL:g} argmax_equal={peaks}")
    check(max(cross, last) <= TOL and peaks, "the dft and ct5 routes "
          "disagree")
    d8bufs = [torch.view_as_complex(dsp.make_input(seed=s, device=dev))
              for s in (41, 42, 43)]
    d8bufs[0][5] = 0
    what = "dti -> spectrum (auto, m > 32) 1024 x 8192 CF32"
    rfg, rl, _ = route_path(what, "CF32", {}, d8bufs, S6, S6p, dsp)
    routes.append((what, rfg, d8bufs[1], rl))
    path_launches["spectrum_fused[fft 1024x8192]"] = rl
    cbufs = [csp.make_input(seed=s, device=dev) for s in (51, 52, 53)]
    cbufs[0][11] = 0.0
    what = "dti -> spectrum (auto, m = 12) 5461 x 1536 F32"
    rfg, rl, _ = route_path(what, "F32", {}, cbufs, S5, S5p, csp)
    routes.append((what, rfg, cbufs[1], rl))
    path_launches["spectrum_fused_ct4"] = rl
    what = "dti -> spectrum {algorithm: dft} 5461 x 1536 F32"
    rfg, rl, _ = route_path(what, "F32", {"algorithm": "dft"}, cbufs, S6,
                            S6p, csp)
    routes.append((what, rfg, cbufs[1], rl))
    path_launches["spectrum_fused[fft 5461x1536]"] = rl
    # the split route, the high-resolution display: at 8.39 Msamp each
    # cycle against the model of the split's passes (the float64 product
    # takes seconds a cycle there; phase 2 holds the two together)
    for (B_, n_), (_, p) in split_cases.items():
        bufs_ = [torch.view_as_complex(p.make_input(seed=n_ + s, device=dev))
                 for s in (1, 2, 3)]
        bufs_[0][2] = 0
        what = f"dti -> spectrum (auto, m = {n_ // 128}) {B_} x {n_} CF32"
        rfg, rl, _ = route_path(
            what, "CF32", {}, bufs_, S6,
            S6p if B_ * n_ <= PLAIN_MAX_SAMPLES
            else kernels.spectrum_split_plain, p)
        routes.append((what, rfg, bufs_[1], rl))
        path_launches[f"spectrum_fused[split {B_}x{n_}]"] = rl
    # the chirp route, each cycle against the model of its steps (phase 2
    # holds the two to the float64 product)
    for (B_, n_), (_, p) in chirp_cases.items():
        bufs_ = [torch.view_as_complex(p.make_input(seed=60 + s, device=dev))
                 for s in (1, 2, 3)]
        bufs_[0][2] = 0
        what = f"dti -> spectrum (auto, m = {n_ // 128}) {B_} x {n_} CF32"
        rfg, rl, _ = route_path(what, "CF32", {}, bufs_, S6,
                                kernels.spectrum_chirp_plain, p)
        routes.append((what, rfg, bufs_[1], rl))
        path_launches[f"spectrum_fused[chirp {B_}x{n_}]"] = rl
        if B_ == DXB:
            xbufs = bufs_
    # the direct product on the first of them, its route forced; the
    # flowgraph is not timed as a cycle
    what = (f"dti -> spectrum (auto, m = {DXN // 128}) {DXB} x {DXN} CF32, "
            "kernels.k6_route forced to direct")
    kernels.k6_route = lambda n: "direct"
    try:
        rfg, rl, _ = route_path(what, "CF32", {}, xbufs, S6,
                                kernels.spectrum_chirp_plain, xsp)
    finally:
        kernels.k6_route = own_route
    rfg.stop()
    path_launches["spectrum_fused[direct]"] = rl

    # the ct routes: K10 through step_kernel(version="ct1"), K11 and K3's
    # display tier through their wrappers, as their callers reach them
    def ct_check(what, kind, got, ref, x=None, sp_=None, zero_value=0.0,
                 skip=()):
        """K10 or K11 (or K3's display tier, kind "display") against its
        plain version: CT_TOL (|X|^2: of each row's max), the argmax bin of
        every row, ``zero_value`` on every zero row (None: the plain
        version's value there); with ``sp_``, also against the float64
        truth of the same epilogue and ``skip`` flags (:func:`ct_truth`),
        within CT_TRUTH_TOL."""
        torch.cuda.synchronize()
        check(got.shape == ref.shape and bool(torch.isfinite(
            torch.view_as_real(got) if got.is_complex() else got).all()),
            f"{what}: output shape/finite")
        diff = (got - ref).abs()
        err = float(diff.max())
        cterrs[kind].append(err)
        if kind == "display":
            check(torch.equal(got, ref), f"{what}: not the exact call's bits")
            say(f"kernel-vs-exact: {what} max_abs_err={err:.3e} "
                f"bit_equal=True")
            return
        rel = diff if kind != "none" else \
            diff / ref.amax(-1, keepdim=True).clamp_min(1e-30)
        rel = float(rel.max())
        peaks = bool(torch.equal(got.argmax(-1), ref.argmax(-1)))
        zero = x.abs().amax(dim=(1, 2)) == 0
        if zero_value is None:
            zeros = bool(((got[zero] - ref[zero]).abs() <= CT_TOL).all())
        else:
            zeros = bool((got[zero] == zero_value).all())
        line = (f"kernel-vs-plain: {what} max_abs_err={err:.3e} "
                + (f"(of row max {rel:.3e}) " if kind == "none" else "")
                + f"tol={CT_TOL:g} argmax_equal={peaks} zero_rows="
                f"{int(zero.sum())} held={zeros}")
        if sp_ is not None:
            ep = "exact" if kind == "ct" else kind
            truth = ct_truth(torch, x, sp_, ep, skip)
            t_diff = (got.double() - truth).abs()
            if ep == "none":
                t_diff = t_diff / truth.amax(-1, keepdim=True).clamp_min(
                    1e-300)
            t_err, t_tol = float(t_diff.max()), CT_TRUTH_TOL[ep]
            line += (f"; vs float64 truth {t_err:.3e}"
                     + (" of row max" if ep == "none" else "")
                     + f" tol={t_tol:g}")
        say(line)
        check(rel <= CT_TOL, f"{what}: {rel} > {CT_TOL}")
        check(peaks, f"{what}: bin order differs from the plain version")
        check(zeros, f"{what}: a zero row is not its expected value")
        if sp_ is not None:
            check(t_err <= t_tol, f"{what}: {t_err} from the float64 truth")

    def only(what, expected: dict) -> dict:
        got = counts()
        say(f"main-path: {what} launches {got}")
        check(got == {w.__name__: expected.get(w, 0) for w in wrappers},
              f"{what}: launches {got}")
        return got

    srows = [torch.view_as_real(b) for b in sbufs]   # (B, n, 2), no copy
    cconst = (csp._win, csp._coeff, csp._scale, csp._offset)
    s10refs = [S10p(x, *sconst) for x in srows]
    c10refs = [S10p(x, *cconst) for x in cbufs]
    torch.cuda.synchronize()
    ctlaunches = {}
    for exact in (True, False):
        zero_counts()
        for i, (x, ref) in enumerate(zip(srows, s10refs)):
            ct_check(f"step_kernel(version='ct1', exact={exact}) {SB} x {SN} "
                     f"CF32 cycle {i}", "ct", sp.step_kernel(
                         x, version="ct1", exact=exact), ref, x, sp)
        got = only(f"step_kernel(version='ct1', exact={exact}) {SB} x {SN}",
                   {S10: len(srows)})
        ctlaunches.setdefault("ct", got[S10.__name__])
    zero_counts()
    for i, (x, ref) in enumerate(zip(cbufs, c10refs)):
        ct_check(f"step_kernel(version='ct1') {CB} x {CN} F32 cycle {i}",
                 "ct", csp.step_kernel(x, version="ct1"), ref, x, csp)
    only(f"step_kernel(version='ct1') {CB} x {CN}", {S10: len(cbufs)})
    del s10refs, c10refs
    for ep in CT3_EPILOGUES:
        refs = [S11p(x, *sconst, ep=ep) for x in srows]
        torch.cuda.synchronize()
        zero_counts()
        for i, (x, ref) in enumerate(zip(srows, refs)):
            ct_check(f"spectrum_fused_ct3(ep={ep!r}) {SB} x {SN} cycle {i}",
                     ep, S11(x, *sconst, ep=ep), ref, x, sp,
                     None if ep == "approx" else 0.0)
        ctlaunches[ep] = only(f"spectrum_fused_ct3(ep={ep!r}) {SB} x {SN}",
                              {S11: len(srows)})[S11.__name__]
        del refs
    zero_counts()
    for m in range(1, 33):
        small = SpectrumPipeline(fft_size=128 * m, batches=37, device=dev)
        x = small.make_input(seed=m + 100, device=dev)
        x[3] = 0.0
        args = (small._win, small._coeff, small._scale, small._offset)
        ct_check(f"spectrum_fused_ct B=37 n={128 * m}", "ct", S10(x, *args),
                 S10p(x, *args), x, small)
        ct_check(f"spectrum_fused_ct3 B=37 n={128 * m}", "exact",
                 S11(x, *args), S11p(x, *args), x, small)
    only("the ct kernels at every m on 37 rows", {S10: 32, S11: 32})
    zero_counts()
    nskips = 0
    for m in (1, 12, 16, 32):
        small = SpectrumPipeline(fft_size=128 * m, batches=37, device=dev)
        x = small.make_input(seed=m + 200, device=dev)
        x[3] = 0.0
        args = (small._win, small._coeff, small._scale, small._offset)
        for skip in CT3_SKIPS:           # kb = 1: every flag is taken
            for ep in CT3_EPILOGUES:
                ct_check(f"spectrum_fused_ct3(ep={ep!r}, skip={skip}) B=37 "
                         f"n={128 * m}", ep,
                         S11(x, *args, ep=ep, skip=skip),
                         S11p(x, *args, ep=ep, skip=skip), x, small,
                         None if ep == "approx" else 0.0, skip)
                nskips += 1
    only("spectrum_fused_ct3 with each skip flag", {S11: nskips})
    frefs = [F3(b) for b in fbufs]                 # the exact tier
    torch.cuda.synchronize()
    zero_counts()
    for i, (b, ref) in enumerate(zip(fbufs, frefs)):
        ct_check(f"fft_pallas(exact=False) {SB} x {SN} cycle {i}", "display",
                 F3(b, exact=False), ref)
    ctlaunches["display"] = only(f"fft_pallas(exact=False) {SB} x {SN}",
                                 {F3: len(fbufs)})[F3.__name__]
    del frefs

    # -- 4. timing --------------------------------------------------------------
    ms = time_cuda(torch, lambda: K(x2, zero_hist, hp, bperm, g, D))
    ms_coh = time_cuda(torch, lambda: K(x2, zero_hist, hp, bperm, g, D,
                                        "coherent"))
    ms_ingest = {}                   # classic, by integer ingest type
    for dtype, full in ((torch.int8, 127), (torch.int16, 32767)):
        q = torch.round(x2 * (full / peak)).clamp(-full, full).to(dtype)
        qz = torch.zeros((P, 2 * C), dtype=dtype, device=dev)
        ms_ingest[str(dtype)[6:]] = time_cuda(
            torch, lambda q=q, qz=qz: K(q, qz, hp, bperm, g, D))
    del q, qz
    plain_ms = time_cuda(torch, lambda: plain(x2, zero_hist, hp, bperm, g,
                                              D), warm=2, iters=5)
    # the squelch module's device work: a peak magnitude over the buffer
    squelch_ms = time_cuda(torch, lambda: bufs[0].abs().amax() > THRESHOLD)
    src.attach_buffer(bufs[0])
    cycle_ms = time_cuda(torch, fg.compute)
    cycle_us = host_us(torch, fg.compute)
    issue_us = host_us(torch, lambda: K(x2, zero_hist, hp, bperm, g, D))
    bound, bound_by, k1_work = k1_bound_ms(M, C, P, D, 4, coherent=False)
    was_bound = k1_bound_ms(M, C, P, D, 4, coherent=False, dft="fp32")[0]
    msamp = M * C / 1e3
    say(f"timing: kernel classic {ms:.4f} ms ({msamp / ms:.1f} Msamp/s), "
        f"wrapper host {issue_us:.2f} us per launch, "
        f"coherent {ms_coh:.4f} ms, int8 {ms_ingest['int8']:.4f} ms, "
        f"int16 {ms_ingest['int16']:.4f} ms, plain {plain_ms:.4f} ms "
        f"({msamp / plain_ms:.1f} Msamp/s), bound {bound:.4f} ms "
        f"({bound_by}; {was_bound:.4f} with the DFT at the fp32 FFMA rate), "
        f"instance {k1_instances['K1 float32']}, squelch {squelch_ms:.4f} ms, "
        f"flowgraph cycle {cycle_ms:.4f} ms "
        f"({msamp / cycle_ms:.1f} Msamp/s), host {cycle_us:.1f} us to "
        f"issue one cycle")
    say_trace("dti -> squelch -> channelizer", trace_cycles(torch, fg.compute))
    fg.stop()

    crows = []
    ext7, prev7 = k7_case(model, M, seed=4)
    for route in KERNEL_VARIANTS + CARRY_VARIANTS:
        if route in CARRY_VARIANTS:
            name, replaces = f"channelize_demod[{route}]", 2785
            # the model's tables, as its steps pass them
            args = (ext7, model.hp, model.wr, model.wi, prev7, g, route,
                    model.k7_tables[route])
            run, run_plain = (lambda a=args: K7(*a)), (lambda a=args: K7p(*a))
            b_ms, b_by, b_work = k7_bound_ms(M, C, P)
            was_ms = k7_bound_ms(M, C, P, dft="fp32")[0]
            rows = M
        else:
            fn, plain_fn, args = decim_route(route, model, x2, hist)
            name, replaces = fn.__name__, 735 if route == "v4" else 549
            run = lambda fn=fn, a=args: fn(*a)            # noqa: E731
            run_plain = lambda fn=plain_fn, a=args: fn(*a)  # noqa: E731
            b_ms, b_by, b_work = k1_bound_ms(M, C, P, D, 4, coherent=False,
                                             atan_ops=ATAN2_OPS5)
            was_ms = k1_bound_ms(M, C, P, D, 4, coherent=False,
                                 atan_ops=ATAN2_OPS5, dft="fp32")[0]
            rows = M + 1
        k_ms = time_cuda(torch, run)
        p_ms = time_cuda(torch, run_plain, warm=2, iters=5)
        us = host_us(torch, run)
        line = (f"timing: {name} {k_ms:.4f} ms ({msamp / k_ms:.1f} Msamp/s, "
                f"{100 * b_ms / k_ms:.1f}% of bound), wrapper host {us:.2f} "
                f"us per launch, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by})")
        if route in ("v4", "v2"):
            line += (f"; the folded form's own floor (P (2C)^2 products a "
                     f"row) {folded_product_ms(rows, C, P):.4f} ms")
        say(line)
        launches_, what, step, init = mpaths[route]
        st, iq = init(), iqs[1]
        s_ms = time_cuda(torch, lambda: step(st, iq))
        s_us = host_us(torch, lambda: step(st, iq))
        say(f"timing: {what} step {s_ms:.4f} ms ({msamp / s_ms:.1f} "
            f"Msamp/s), host {s_us:.1f} us to issue one step")
        say_trace(what, trace_cycles(torch, lambda: step(st, iq)))
        crows.append({
            "name": name,
            "route": "cuda",
            "source": "cyberether_tpu_torch/csrc/channelize_demod_decim.cu",
            "replaces": f"cyberether_tpu/ops/pallas_kernels.py:{replaces}",
            "launches": launches_,
            "max_abs_err": max(cerrs[route]),
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "was_bound_ms": was_ms,
            "work": b_work,
            "library_ms": None,
            **({"instance": k1_instances["K9"]} if route == "v6" else {}),
        })
    del ext7

    wmsamp = WN / 1e3
    wrows = []
    for kind, name, replaces, run, run_plain, dd, poly3 in (
            ("classic", "wbfm_fused_v2", 2626,
             lambda: W4(wiq, taps, whist, g4),
             lambda: W4p(wiq, taps, whist, g4), 0, True),
            ("coherent", "wbfm_fused_v2[coherent]", 2626,
             lambda: W4(wiq, taps, whist, g4, WD),
             lambda: W4p(wiq, taps, whist, g4, WD), WD, True),
            ("v1", "wbfm_fused", 2458,
             lambda: W12(wx, taps, whist, g4),
             lambda: W12p(wx, taps, whist, g4), 0, False)):
        k_ms = time_cuda(torch, run)
        p_ms = time_cuda(torch, run_plain, warm=2, iters=5)
        b_ms, b_by, b_work = wbfm_bound_ms(WN, WT, dd, poly3)
        say(f"timing: {name} {k_ms:.4f} ms ({wmsamp / k_ms:.1f} Msamp/s, "
            f"{100 * b_ms / k_ms:.1f}% of bound), plain {p_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        wrows.append({
            "name": name,
            "route": "cuda",
            "source": "cyberether_tpu_torch/csrc/wbfm_fused.cu",
            "replaces": f"cyberether_tpu/ops/pallas_kernels.py:{replaces}",
            "launches": wlaunches[kind],
            "max_abs_err": max(werrs[kind]),
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "work": b_work,
            "library_ms": None,
        })
    demod = W4(wiq, taps, whist, g4)
    mean_ms = time_cuda(torch, lambda: demod.reshape(-1, WD).mean(1))
    say(f"timing: wbfm boxcar mean of the classic demod {mean_ms:.4f} ms")
    for mode, wfg in wfgs.items():
        wfg.block_module("src").attach_buffer(wbufs[0])
        c_ms = time_cuda(torch, wfg.compute)
        c_us = host_us(torch, wfg.compute)
        say(f"timing: dti -> wbfm {mode} flowgraph cycle {c_ms:.4f} ms "
            f"({wmsamp / c_ms:.1f} Msamp/s), host {c_us:.1f} us to issue "
            f"one cycle")
        say_trace(f"dti -> wbfm {mode}", trace_cycles(torch, wfg.compute))
        wfg.stop()
    w_us = host_us(torch, lambda: W4(wiq, taps, whist, g4))
    say(f"timing: wbfm_fused_v2 wrapper host {w_us:.2f} us per launch")

    def library():
        return spectrum_library(torch, siq, sp)

    lib_err = float((library() - sgot).abs().max())
    s_ms = time_cuda(torch, lambda: S2(siq, *sconst))
    s_plain = time_cuda(torch, lambda: S2p(siq, *sconst), warm=2, iters=5)
    s_lib = time_cuda(torch, library)
    s_us = host_us(torch, lambda: S2(siq, *sconst))
    s_bound, s_by, s_work = spectrum_bound_ms(SB, SN)
    smsamp = SB * SN / 1e3
    say(f"timing: spectrum_fused_ct5 {s_ms:.4f} ms ({smsamp / s_ms:.1f} "
        f"Msamp/s, {100 * s_bound / s_ms:.1f}% of bound), wrapper host "
        f"{s_us:.2f} us per launch, plain {s_plain:.4f} ms, library "
        f"(torch.fft.fft + window + epilogue in torch ops) {s_lib:.4f} ms "
        f"(max abs diff from the kernel {lib_err:.3e}), bound "
        f"{s_bound:.4f} ms ({s_by})")
    # the same 8.4 Msamp a call at every n: how the time grows with the
    # number of radix-2 passes (log2 n)
    sweep = []
    for n in (128, 256, 512, 1024, 2048, 4096):
        p = SpectrumPipeline(fft_size=n, batches=SB * SN // n, device=dev)
        x = p.make_input(seed=n, device=dev)
        args = (p._win, p._coeff, p._scale, p._offset)
        sweep.append(f"n={n} {time_cuda(torch, lambda: S2(x, *args)):.4f}")
    say(f"timing: spectrum_fused_ct5 at {smsamp / 1e3:.2f} Msamp a call, "
        f"ms by n: " + ", ".join(sweep))
    sfg.block_module("src").attach_buffer(sbufs[1])
    sc_ms = time_cuda(torch, sfg.compute)
    sc_us = host_us(torch, sfg.compute)
    say(f"timing: dti -> spectrum flowgraph cycle {sc_ms:.4f} ms "
        f"({smsamp / sc_ms:.1f} Msamp/s), host {sc_us:.1f} us to issue one "
        f"cycle")
    say_trace("dti -> spectrum", trace_cycles(torch, sfg.compute))
    sfg.stop()
    wrows.append({
        "name": "spectrum_fused_ct5",
        "route": "cuda",
        "source": "cyberether_tpu_torch/csrc/spectrum_fused.cu",
        "replaces": "cyberether_tpu/ops/pallas_kernels.py:2245",
        "launches": slaunches,
        "max_abs_err": max(serrs),
        "ms": s_ms,
        "plain_ms": s_plain,
        "bound_ms": s_bound,
        "bound_by": s_by,
        "work": s_work,
        "library_ms": s_lib,
    })

    f_lib_err = float((torch.fft.fft(fx) - fgot).abs().max())
    f_ms = time_cuda(torch, lambda: F3(fx))
    f_plain = time_cuda(torch, lambda: F3p(fx), warm=2, iters=5)
    f_lib = time_cuda(torch, lambda: torch.fft.fft(fx))
    f_us = host_us(torch, lambda: F3(fx))
    f_bound, f_by, f_work = k3_bound_ms(SB, SN)
    say(f"timing: fft_pallas {f_ms:.4f} ms ({smsamp / f_ms:.1f} Msamp/s, "
        f"{100 * f_bound / f_ms:.1f}% of bound), wrapper host "
        f"{f_us:.2f} us per launch, plain {f_plain:.4f} ms, library "
        f"(torch.fft.fft) {f_lib:.4f} ms (max abs diff from the kernel "
        f"{f_lib_err:.3e}), bound {f_bound:.4f} ms ({f_by})")
    sweep = []
    for n in (128, 256, 512, 1024, 2048, 4096):
        x = crandn(SB * SN // n, n)
        sweep.append(f"n={n} {time_cuda(torch, lambda: F3(x)):.4f}")
    del x
    say(f"timing: fft_pallas at {smsamp / 1e3:.2f} Msamp a call, ms by n: "
        + ", ".join(sweep))
    for kind, ffg in ffgs.items():
        ffg.block_module("src").attach_buffer(fbufs[0])
        c_ms = time_cuda(torch, ffg.compute)
        c_us = host_us(torch, ffg.compute)
        say(f"timing: dti -> fft {kind} flowgraph cycle {c_ms:.4f} ms "
            f"({smsamp / c_ms:.1f} Msamp/s), host {c_us:.1f} us to issue "
            f"one cycle")
        say_trace(f"dti -> fft {kind}", trace_cycles(torch, ffg.compute))
        ffg.stop()
    for (kind, efg), ebatch in zip(efgs.items(), (ebufs, sbufs)):
        efg.block_module("src").attach_buffer(ebatch[1])
        msamp = ebatch[1].numel() / 1e3
        c_ms = time_cuda(torch, efg.compute)
        c_us = host_us(torch, efg.compute)
        say(f"timing: dti -> spectrum_engine {kind} flowgraph cycle "
            f"{c_ms:.4f} ms ({msamp / c_ms:.1f} Msamp/s), host {c_us:.1f} "
            f"us to issue one cycle")
        say_trace(f"dti -> spectrum_engine {kind}",
                  trace_cycles(torch, efg.compute))
        efg.stop()
    wrows.append({
        "name": "fft_pallas",
        "route": "cuda",
        "source": "cyberether_tpu_torch/csrc/spectrum_fft.cu",
        "replaces": "cyberether_tpu/ops/pallas_kernels.py:1693",
        "launches": flaunches["forward"],
        "max_abs_err": max(ferrs),
        "ms": f_ms,
        "plain_ms": f_plain,
        "bound_ms": f_bound,
        "bound_by": f_by,
        "work": f_work,
        "library_ms": f_lib,
    })
    say(f"main-path: fft_pallas launches by path: dti -> fft {flaunches}, "
        f"dti -> spectrum_engine {elaunches}")

    # K6 on its FFT route at the dft path's width, past m = 32 and on the
    # runtime plan, on its split and chirp routes past 16384 points and on
    # the direct product (its route forced); K5 at m = 12
    plain_lib_ms = {}          # (B, n) -> the plain and library ms
    for name, kern, plain_fn, x, sp_, iters in [
            ("spectrum_fused[fft]", S6, S6p, siq, sp, 20),
            ("spectrum_fused[fft 1024x8192]", S6, S6p, diq, dsp, 20),
            ("spectrum_fused[fft 5461x1536]", S6, S6p, ciq, csp, 20)] + [
            (f"spectrum_fused[split {B_}x{n_}]", S6, S6p, x, p, 20)
            for (B_, n_), (x, p) in split_cases.items()] + [
            (f"spectrum_fused[chirp {B_}x{n_}]", S6, S6p, x, p, 20)
            for (B_, n_), (x, p) in chirp_cases.items()] + [
            ("spectrum_fused[direct]", S6, S6p, xiq, xsp, 5),
            ("spectrum_fused_ct4", S5, S5p, ciq, csp, 20)]:
        B_, n_ = x.shape[:2]
        args = (sp_._win, sp_._coeff, sp_._scale, sp_._offset)
        direct = name == "spectrum_fused[direct]"
        if direct:
            kernels.k6_route = lambda n: "direct"
        try:
            k_ms = time_cuda(torch, lambda: kern(x, *args), warm=2,
                             iters=iters)
            us = host_us(torch, lambda: kern(x, *args), iters=iters)
        finally:
            kernels.k6_route = own_route
        if direct:
            # the same function on the same input as the chirp row's
            p_ms, l_ms = plain_lib_ms[DXB, DXN]
        else:
            p_ms = time_cuda(torch, lambda: plain_fn(x, *args), warm=1,
                             iters=3 if B_ * n_ <= PLAIN_MAX_SAMPLES else 1)
            l_ms = time_cuda(torch, lambda: spectrum_library(torch, x, sp_),
                             iters=iters)
            plain_lib_ms[B_, n_] = p_ms, l_ms
        b_ms, b_by, b_work = spectrum_bound_ms(B_, n_)
        msamp = B_ * n_ / 1e3
        line = (f"timing: {name} B={B_} n={n_} {k_ms:.4f} ms "
                f"({msamp / k_ms:.1f} Msamp/s, {100 * b_ms / k_ms:.1f}% of "
                f"bound), wrapper host {us:.2f} us per launch, plain "
                f"{p_ms:.4f} ms, library (torch.fft.fft + window + "
                f"epilogue in torch ops) {l_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by})")
        if (B_, n_) in ((SB, SN), (DB, DN)):
            # the same product as four float32 cuBLAS matmuls (step_dft),
            # and how far those land from the truth with exact math
            d_ms = time_cuda(torch, lambda: sp_.step_dft(x), warm=1, iters=3)
            exact = SpectrumPipeline(fft_size=n_, batches=B_,
                                     fast_math=False, device=dev)
            d_err = float((exact.step_dft(x).double()
                           - spectrum_truth(torch, x, exact)).abs().max())
            line += (", step_dft (float32 matmuls, fast-math epilogue) "
                     f"{d_ms:.4f} ms, its exact-math output vs float64 "
                     f"truth {d_err:.3e}")
        passes = None
        if direct:
            line += (f"; the direct product's own floor (8 n^2 a row) "
                     f"{dft_product_ms(B_, n_):.4f} ms")
        if "[split" in name or "[chirp" in name:
            # the route's kernels a call (two; the chirp route's three past
            # one block a row), by device time: on the card a trace
            # without them means the route or the tracing broke
            want = 2 if "[split" in name else \
                1 if kernels.chirp_length(n_) <= kernels.FFT_MAX_POINTS else 3
            trace = trace_cycles(torch, lambda: kern(x, *args))
            check(trace is not None and len(trace[0]) == want,
                  f"{name}: not {want} kernels a call: {trace}")
            passes = dict(trace[0])
            line += (f"; its passes by the profiler {passes}, idle "
                     f"share {trace[1]:.3f}" + (
                         f" (after {trace[2]} empty profiler sessions)"
                         if trace[2] else ""))
        say(line)
        wrows.append({
            "name": name,
            "route": "cuda",
            "source": "cyberether_tpu_torch/csrc/" + (
                "spectrum_fused.cu" if kern is S5 else
                "spectrum_dft.cu" if direct else
                "spectrum_fft.cu"),
            "replaces": "cyberether_tpu/ops/pallas_kernels.py:" + (
                "849" if kern is S6 else "1424"),
            "launches": path_launches[name],
            "max_abs_err": max(rerrs[S5 if kern is S5 else "direct"
                                     if direct else kernels.k6_route(n_)]),
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "work": b_work,
            "library_ms": l_ms,
            **({"passes_ms": passes} if passes else {}),
        })
    sweep = []
    for n in (64, 100, 127, 131, 384, 1536, 4224, 8192, 16384, 16512, 16768,
              32768, 32896, 65152, 65536, 130688, 131072):
        p = SpectrumPipeline(fft_size=n, batches=SB * SN // n, device=dev)
        x = p.make_input(seed=n, device=dev)
        args = (p._win, p._coeff, p._scale, p._offset)
        ms_n = time_cuda(torch, lambda: S6(x, *args), iters=5)
        sweep.append(f"n={n} {ms_n:.4f}")
    say(f"timing: spectrum_fused at ~{SB * SN / 1e6:.2f} Msamp a call, ms by "
        "n: " + ", ".join(sweep))
    sweep = []
    for m in (1, 3, 5, 12, 24, 31):
        p = SpectrumPipeline(fft_size=128 * m, batches=SB * SN // (128 * m),
                             device=dev)
        x = p.make_input(seed=m, device=dev)
        args = (p._win, p._coeff, p._scale, p._offset)
        sweep.append(f"m={m} {time_cuda(torch, lambda: S5(x, *args)):.4f}")
    del x
    say(f"timing: spectrum_fused_ct4 at ~{SB * SN / 1e6:.2f} Msamp a call, "
        "ms by m: " + ", ".join(sweep))
    for what, rfg, b, _ in routes:
        rfg.block_module("src").attach_buffer(b)
        msamp = b.numel() / (1e3 if b.is_complex() else 2e3)
        c_ms = time_cuda(torch, rfg.compute, iters=10)
        c_us = host_us(torch, rfg.compute, iters=10)
        say(f"timing: {what} flowgraph cycle {c_ms:.4f} ms "
            f"({msamp / c_ms:.1f} Msamp/s), host {c_us:.1f} us to issue "
            "one cycle")
        say_trace(what, trace_cycles(torch, rfg.compute))
        rfg.stop()
    say("main-path: launches by path: " + ", ".join(
        f"{what}: {rl}" for what, _, _, rl in routes))

    # the ct routes: K10, K11 by epilogue and K3's display tier on the
    # spectrum and fft paths' buffers, K10 also at m = 12
    x, cx = srows[1], cbufs[1]
    for name, kind, run, run_plain, run_lib, b_bound in [
            ("spectrum_fused_ct", "ct", lambda: S10(x, *sconst),
             lambda: S10p(x, *sconst),
             lambda: spectrum_library(torch, x, sp),
             spectrum_bound_ms(SB, SN))] + [
            (f"spectrum_fused_ct3[{ep}]", ep,
             lambda ep=ep: S11(x, *sconst, ep=ep),
             lambda ep=ep: S11p(x, *sconst, ep=ep),
             (lambda: mag2_library(torch, x, sp)) if ep == "none" else
             (lambda: spectrum_library(torch, x, sp)),
             spectrum_bound_ms(SB, SN, CT3_BIN_OPS[ep]))
            for ep in CT3_EPILOGUES] + [
            ("fft_pallas[display]", "display",
             lambda: F3(fbufs[1], exact=False), lambda: F3p(fbufs[1]),
             lambda: torch.fft.fft(fbufs[1]), k3_bound_ms(SB, SN))]:
        k_ms = time_cuda(torch, run)
        p_ms = time_cuda(torch, run_plain, warm=2, iters=5)
        l_ms = time_cuda(torch, run_lib)
        us = host_us(torch, run)
        b_ms, b_by, b_work = b_bound
        say(f"timing: {name} B={SB} n={SN} {k_ms:.4f} ms "
            f"({smsamp / k_ms:.1f} Msamp/s, {100 * b_ms / k_ms:.1f}% of "
            f"bound), wrapper host {us:.2f} us per launch, plain "
            f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by})")
        wrows.append({
            "name": name,
            "route": "cuda",
            "source": "cyberether_tpu_torch/csrc/" + (
                "spectrum_fft.cu" if kind == "display" else
                "spectrum_fused.cu"),
            "replaces": "cyberether_tpu/ops/pallas_kernels.py:" + (
                "1018" if kind == "ct" else
                "1693" if kind == "display" else "1280"),
            "launches": ctlaunches[kind],
            "max_abs_err": max(cterrs[kind]),
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "work": b_work,
            "library_ms": l_ms,
        })
    disp_ms = time_cuda(torch, lambda: S10(x, *sconst, exact=False))
    c_ms = time_cuda(torch, lambda: S10(cx, *cconst))
    c_bound, _, _ = spectrum_bound_ms(CB, CN)
    say(f"timing: spectrum_fused_ct exact=False B={SB} n={SN} "
        f"{disp_ms:.4f} ms; B={CB} n={CN} {c_ms:.4f} ms (bound "
        f"{c_bound:.4f} ms)")
    for what, step in (
            (f"step_kernel(version='ct1') {SB} x {SN} CF32",
             lambda: sp.step_kernel(x, version="ct1")),
            (f"step_kernel(version='ct1') {CB} x {CN} F32",
             lambda: csp.step_kernel(cx, version="ct1"))):
        st_ms = time_cuda(torch, step)
        st_us = host_us(torch, step)
        say(f"timing: {what} step {st_ms:.4f} ms, host {st_us:.1f} us to "
            "issue one step")
        say_trace(what, trace_cycles(torch, step))
    say(f"main-path: ct routes launches by path: {ctlaunches}")

    rows = [{
        "name": "channelize_demod_decim",
        "route": "cuda",
        "source": "cyberether_tpu_torch/csrc/channelize_demod_decim.cu",
        "replaces": "cyberether_tpu/ops/pallas_kernels.py:624",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "was_bound_ms": was_bound,
        "work": k1_work,
        "library_ms": None,
        "instance": k1_instances["K1 float32"],
        "ms_coherent": ms_coh,
        **{f"ms_{k}": v for k, v in ms_ingest.items()},
    }] + crows + wrows
    frows, copy_rate, rates = floors(torch, dev, gen, zero_counts, only)
    rows += frows
    rows += ablations(torch, dev, gen, zero_counts, only)
    for row in rows:
        row["floor_ms"] = floor_ms(row["work"], copy_rate, rates)
        if "[chirp" in row["name"]:
            say(f"timing: {row['name']} {row['ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), floor "
                f"{row['floor_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"library {row['library_ms']:.4f} ms, launches "
                f"{row['launches']}")
    say(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    say(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                  # noqa: BLE001 — report and fail
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
