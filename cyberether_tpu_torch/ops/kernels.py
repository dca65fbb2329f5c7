"""Hand-written CUDA kernels of the hot paths, their wrappers, and the
plain PyTorch version of each.

Port of the kernels of ``cyberether_tpu/ops/pallas_kernels.py`` that the
ported slices run:

- ``channelize_demod_decim``: the polyphase channelizer inner loop —
  P-tap branch FIR, C-point DFT as one (2C)x(2C) real product, lag-1
  FM discriminator, atan2 x gain, boxcar decimation by D — in one pass
  (``csrc/channelize_demod_decim.cu``, its tensor-core template: the
  DFT as a 3xTF32 ``wgmma`` product; replaces
  ``channelize_demod_decim_v5``).
- ``channelize_demod_decim_v4`` and ``channelize_demod_decim_v6``: the
  same function with the taps folded into P DFT matrices (replaces the
  JAX package's ``channelize_demod_decim``, v4; the source's FFMA
  template), and with the 5-term atan2 on an approximate reciprocal
  (replaces ``channelize_demod_decim_v6``; K1's tensor-core template).
- ``channelize_demod``: the FIR, DFT and lag-1 discriminator without the
  decimation, from re|im-halves rows, with the lag frame carried in
  ``prev`` (replaces ``channelize_demod``, v1 and v2); the same source.
- ``channelize_ablate``: K1's split form with stages removed, one kernel
  instance a stage of K1's tensor-core template (replaces the TPU stage
  ablation ``tools/ablation/chan_ablate.py``).
- ``wbfm_fused_v2`` and ``wbfm_fused``: the WBFM front end — a real
  channel FIR of up to 129 taps and the lag-1 FM discriminator, from
  raw interleaved (n, 2) or planar (2, n) IQ; ``wbfm_fused_v2`` can
  also average the lag products over D-sample groups and return audio
  (``csrc/wbfm_fused.cu``; replace ``wbfm_fused_v2`` and ``wbfm_fused``).
- ``wbfm_ablate``: ``wbfm_fused``'s function with stages removed, on its
  kernel template (replaces ``tools/ablation/wbfm_ablate.py``).
- ``spectrum_fused_ct5``: the fused spectrum — window, n-point FFT,
  |X|^2 in dB, range scale and tanh soft clip — for n = 128 m with m a
  power of two <= 32 (``csrc/spectrum_fused.cu``; replaces
  ``spectrum_fused_ct5``).
- ``spectrum_fused_ct4``: the same function for n = 128 m with any
  m <= 32, by a direct m-point DFT over the chunk axis and 128-point
  radix-2 passes; the same source and pass routine (replaces
  ``spectrum_fused_ct4``).
- ``spectrum_fused``: the same function for any n: a Stockham FFT for
  every n <= 16384 whose prime factors are all <= 1021
  (``csrc/spectrum_fft.cu``), two passes of it (columns, then rows) for
  n that splits into two such factors (the same source), Bluestein's
  chirp-z transform on its passes for n with a prime factor past 1021
  (the same source), else one full DFT product tiled in fp32 FFMA
  (``csrc/spectrum_dft.cu``); replaces ``spectrum_fused``.
- ``spectrum_fused_ct`` and ``spectrum_fused_ct3``: ``spectrum_fused_ct4``'s
  function on its kernel, a template on the epilogue (replace
  ``spectrum_fused_ct``, ct1, and ``spectrum_fused_ct3``, with the
  latter's fast epilogue, its |X|^2 output and its ablation flags).
- ``fft_pallas``: the forward C2C FFT of complex64 rows, unnormalized,
  natural bin order, for n = 128 m with m a power of two <= 32, on the
  Stockham core of ``csrc/spectrum_fft.cu`` that K6's FFT route shares
  (replaces ``fft_pallas``, exact and display tiers).

A wrapper given CPU tensors computes its kernel's plain version; given
CUDA tensors it launches the kernel or raises.  Each wrapper counts its
launches in a plain integer attribute (``wrapper.launches``); the two
ablations by kernel instance, a dict whose sum is the count;
``spectrum_fused`` also by route (``spectrum_fused.routes``), one
launch a call on every route, the split and chirp routes' kernels
included.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from cyberether_tpu_torch.ops import _build
from cyberether_tpu_torch.ops.fastmath import approx_log10
from cyberether_tpu_torch.ops.firs import _corr_valid

_INGEST_DTYPES = {torch.float32: 0, torch.int8: 1, torch.int16: 2}
_DEMOD_MODES = {"classic": 0, "coherent": 1}

# what the CUDA kernel takes (see csrc/channelize_demod_decim.cu)
K1_CHANNELS = (8, 16, 32, 64)
K1_MAX_TAPS = 16
K1_BLOCK_FRAMES = 128
# K1 and K9 run the tensor-core template at every C; its tile (kTcTile):
# the frames of one m64 wgmma tile, two to a block's 128 frames at once
K1_TILE_FRAMES = 64
WBFM_MAX_TAPS = 129
# a coherent group may span at most this many 128-sample rows: the JAX
# package's limit (its selector table), kept so both accept the same D
WBFM_MAX_COHERENT_ROWS = 16
CT_MAX_CHUNKS = 32                    # the ct kernels: n = 128 m, m <= 32
# columns of the DFT matrices a plain product gathers at once: at most
# this many entries, so n x n is never held at large n
DFT_COLUMN_ENTRIES = 1 << 20

# float32-rounded constants (python floats, so they never promote a tensor)
_PI = float(np.float32(math.pi))
_PI_2 = float(np.float32(math.pi / 2))
_PI_4 = float(np.float32(math.pi / 4))
_LOG10_E = float(np.float32(0.43429448190325176))


def _launch(name: str, tensors: dict, aligned, fn, *args) -> None:
    """Call a kernel's C launcher ``fn(*args, stream)`` on the current
    stream of the device of ``tensors``, after checking that each of
    ``tensors`` ({what: tensor}) is contiguous and that ``aligned``
    (what, tensor, bytes), unless None, starts on such a boundary.
    Raises on a CUDA error.  The caller counts the launch."""
    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if aligned is not None:
        what, t, nbytes = aligned
        if t.data_ptr() % nbytes:
            raise ValueError(f"{name}: {what} must be {nbytes}-byte "
                             "aligned")
    device = next(iter(tensors.values())).device
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def atan2_poly(y: torch.Tensor, x: torch.Tensor,
               poly3: bool = True) -> torch.Tensor:
    """atan2 from basic ops: octant reduction + double-angle range
    reduction + minimax odd polynomial, with one true division.

    ``poly3``: the 3-term polynomial (max error 7.3e-6 rad) the
    channelizer kernel uses; otherwise the 5-term one (~2e-7 rad).
    signbit (not <0) keeps atan2(+/-0, -0.0) = +/-pi consistent with
    IEEE.  Same arithmetic as the JAX package's ``_atan2`` with
    ``recip=False``."""
    ax = x.abs()
    ay = y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    red = lo > 0.41421356 * hi
    num = torch.where(red, lo - hi, lo)
    den = torch.where(red, lo + hi, hi)
    u = num / den.clamp_min(1e-30)
    z = u * u
    if poly3:
        p = 1.6837577807e-01 * z + -3.3141539781e-01
        p = p * z + 9.9998249344e-01
        a = u * p
    else:
        p = 6.1687607318e-02 * z + -1.0648017377e-01
        p = p * z + 1.4253635705e-01
        p = p * z + -1.9999158382e-01
        p = p * z + 3.3333328366e-01
        a = u - u * z * p
    a = torch.where(red, _PI_4 + a, a)
    a = torch.where(ay > ax, _PI_2 - a, a)
    a = torch.where(torch.signbit(x), _PI - a, a)
    return torch.where(torch.signbit(y), -a, a)


def perm_channelizer_matrix(wr: np.ndarray, wi: np.ndarray) -> np.ndarray:
    """Lane-permuted real DFT block matrix for interleaved input rows
    ``[re0, im0, re1, im1, ...]``: row 2k <- row k of
    [[Wr^T, Wi^T], [-Wi^T, Wr^T]], row 2k+1 <- row C+k.  Output lanes
    are ``[Re y_0..C-1 | Im y_0..C-1]``."""
    C = wr.shape[0]
    b = np.concatenate(
        [np.concatenate([wr.T, wi.T], axis=1),
         np.concatenate([-wi.T, wr.T], axis=1)], axis=0)   # (2C, 2C)
    perm = np.empty(2 * C, np.int64)
    perm[0::2] = np.arange(C)
    perm[1::2] = np.arange(C) + C
    return b[perm].astype(np.float32)


def fold_channelizer_matrices(hp: np.ndarray, wr: np.ndarray,
                              wi: np.ndarray) -> np.ndarray:
    """(P, 2C, 2C) float32 Bp[p] = diag(hp_interleaved[p]) @ B_perm: the
    kernel-order taps ``hp`` (P, C), duplicated on the interleaved re|im
    lanes, folded into the lane-permuted DFT block matrix of
    :func:`perm_channelizer_matrix`, so that y = sum_p x[p:] @ Bp[p]."""
    b_perm = perm_channelizer_matrix(wr, wi)
    hp_int = np.repeat(hp.astype(np.float32), 2, axis=1)   # (P, 2C)
    return (hp_int[:, :, None] * b_perm[None, :, :]).astype(np.float32)


_INSTANCE_TYPES = {torch.float32: "float", torch.int8: "schar",
                   torch.int16: "short"}
# Atan in the source: K1's, K16's and K9's atan2
_ATAN_INSTANCE = {"poly3": 0, "poly5div": 1, "poly5rcp": 2}


def _tc_instance(channels: int, dtype: torch.dtype, atan: str,
                 stage: int) -> str:
    return (f"channelize_tc_kernel<{_INSTANCE_TYPES[dtype]},{channels},"
            f"{_ATAN_INSTANCE[atan]},{stage}>")


def k1_instance(channels: int, dtype: torch.dtype = torch.float32,
                atan: str = "poly3") -> str:
    """The kernel instance that K1 (``atan="poly3"``) or K9
    (``"poly5rcp"``) launches for this C and input type, named as ptxas's
    report names it (``ab_spectrum.instance_name``)."""
    return _tc_instance(channels, dtype, atan, 0)        # Stage kFull


def k1_cuda_unsupported(channels: int, taps: int, decim: int) -> str:
    """Why the CUDA kernel cannot take this shape, or "" if it can (the
    same for every kernel of ``csrc/channelize_demod_decim.cu``)."""
    if channels in K1_CHANNELS and taps <= K1_MAX_TAPS and \
            K1_BLOCK_FRAMES % decim == 0:
        return ""
    return (f"the CUDA kernel takes C in {K1_CHANNELS}, P <= {K1_MAX_TAPS} "
            f"and decim dividing {K1_BLOCK_FRAMES}; got C={channels}, "
            f"P={taps}, decim={decim}")


_VP, _INT, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points of csrc/channelize_demod_decim.cu and their arguments
_CHANNELIZE_ARGTYPES = {
    "channelize_demod_decim_launch": [_VP] * 5 + [_INT] * 6 + [_FLT, _VP],
    "channelize_demod_decim_v4_launch": [_VP] * 4 + [_INT] * 4 + [_FLT, _VP],
    "channelize_demod_decim_v6_launch": [_VP] * 5 + [_INT] * 4 + [_FLT, _VP],
    "channelize_demod_launch": [_VP] * 6 + [_INT] * 4 + [_FLT, _VP],
    "channelize_ablate_launch": [_VP] * 5 + [_INT] * 5 + [_FLT, _VP],
}


@functools.lru_cache(maxsize=None)
def _channelize_launcher(symbol: str):
    fn = getattr(_build.load("channelize_demod_decim.cu"), symbol)
    fn.argtypes = _CHANNELIZE_ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _check_frames(x2: torch.Tensor, float_only: bool) -> None:
    if x2.dim() != 2 or x2.shape[1] % 2:
        raise ValueError(f"x2 must be (M, 2C); got {tuple(x2.shape)}")
    if float_only and x2.dtype != torch.float32:
        # as the JAX package's v4 and v6 kernels refuse integer ingest
        raise TypeError(f"x2 must be float32; got {x2.dtype}")
    if x2.dtype not in _INGEST_DTYPES:
        raise TypeError(f"x2 must be float32, int8 or int16; got {x2.dtype}")


def _check_hist_decim(x2: torch.Tensor, hist: torch.Tensor, P: int,
                      decim: int) -> None:
    M, n = x2.shape
    if tuple(hist.shape) != (P, n) or hist.dtype != x2.dtype:
        raise ValueError(f"hist must be {x2.dtype} ({P}, {n}); got "
                         f"{hist.dtype} {tuple(hist.shape)}")
    if decim < 1 or M % decim:
        raise ValueError(f"frames ({M}) must be a multiple of decim "
                         f"({decim})")


def _check_same_device(**tensors) -> None:
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"{', '.join(tensors)} must share one device")


def _check_k1(x2: torch.Tensor, hist: torch.Tensor, hp: torch.Tensor,
              bperm: torch.Tensor, decim: int, demod_mode: str,
              float_only: bool = False) -> None:
    _check_frames(x2, float_only)
    n = x2.shape[1]
    if hp.dim() != 2 or hp.shape[1] != n or hp.dtype != torch.float32 \
            or hp.shape[0] < 1:
        raise ValueError(f"hp must be float32 (P, {n}); got "
                         f"{hp.dtype} {tuple(hp.shape)}")
    _check_hist_decim(x2, hist, hp.shape[0], decim)
    if tuple(bperm.shape) != (n, n) or bperm.dtype != torch.float32:
        raise ValueError(f"bperm must be float32 ({n}, {n}); got "
                         f"{bperm.dtype} {tuple(bperm.shape)}")
    if demod_mode not in _DEMOD_MODES:
        raise ValueError("demod_mode must be 'classic' or 'coherent'; "
                         f"got {demod_mode!r}")
    _check_same_device(x2=x2, hist=hist, hp=hp, bperm=bperm)


def _cuda_shape(name: str, x: torch.Tensor, C: int, P: int,
                decim: int) -> None:
    """Raise unless ``x`` lies on the card and the kernels of
    ``csrc/channelize_demod_decim.cu`` take (C, P, decim)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    problem = k1_cuda_unsupported(C, P, decim)
    if problem:
        raise ValueError(f"{name}: {problem}")


def _split_products(ext: torch.Tensor, hp: torch.Tensor, b: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """y[r] = (sum_p ext[r + p] * hp[p]) @ b, r < rows: the split form's
    FIR and one DFT product."""
    _require_ieee_fp32(ext.device)
    z = ext[0:rows] * hp[0]
    for p in range(1, hp.shape[0]):
        z = z + ext[p:p + rows] * hp[p]
    return z @ b


def _folded_products(ext: torch.Tensor, bp: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """y[r] = sum_p ext[r + p] @ bp[p], r < rows: the folded form's FIR
    and DFT in P accumulating products."""
    _require_ieee_fp32(ext.device)
    y = ext[0:rows] @ bp[0]
    for p in range(1, bp.shape[0]):
        y = y + ext[p:p + rows] @ bp[p]
    return y


def _lag_products(lag: torch.Tensor, y: torch.Tensor):
    """(dr, di) = conj(lag) * y, for rows of lanes [Re | Im]."""
    C = y.shape[1] // 2
    pr, pi = lag[:, :C], lag[:, C:]
    yr, yi = y[:, :C], y[:, C:]
    return pr * yr + pi * yi, pr * yi - pi * yr


def _boxcar(v: torch.Tensor, decim: int) -> torch.Tensor:
    M, C = v.shape
    return v.reshape(M // decim, decim, C).mean(1)


def _decimated_demod(y: torch.Tensor, fm_ref: float, decim: int,
                     demod_mode: str, poly3: bool) -> torch.Tensor:
    """y (M + 1, 2C), row 0 the lag frame -> (M // decim, C) audio."""
    dr, di = _lag_products(y[:-1], y[1:])
    g = float(np.float32(fm_ref))
    if demod_mode == "coherent":
        return atan2_poly(_boxcar(di, decim), _boxcar(dr, decim),
                          poly3=poly3) * g
    return _boxcar(atan2_poly(di, dr, poly3=poly3) * g, decim)


def channelize_demod_decim_plain(x2: torch.Tensor, hist: torch.Tensor,
                                 hp: torch.Tensor, bperm: torch.Tensor,
                                 fm_ref: float, decim: int,
                                 demod_mode: str = "classic"
                                 ) -> torch.Tensor:
    """Plain PyTorch version of :func:`channelize_demod_decim`."""
    M = x2.shape[0]
    ext = torch.cat([hist.float(), x2.float()])        # (P + M, 2C)
    # row 0 of y is the lag frame
    y = _split_products(ext, hp, bperm, M + 1)         # (M + 1, 2C)
    return _decimated_demod(y, fm_ref, decim, demod_mode, poly3=True)


def channelize_demod_decim(x2: torch.Tensor, hist: torch.Tensor,
                           hp: torch.Tensor, bperm: torch.Tensor,
                           fm_ref: float, decim: int,
                           demod_mode: str = "classic") -> torch.Tensor:
    """(M, 2C) interleaved frames -> (M // decim, C) FM audio.

    x2: raw interleaved rows ``[re0, im0, re1, im1, ...]`` per frame,
    float32, int8 or int16 (integer ingest needs no rescaling: atan2 of
    a ratio is scale-invariant).  hist: the previous P rows, same dtype.
    hp: (P, 2C) kernel-order taps duplicated on re|im lanes.  bperm:
    (2C, 2C) from :func:`perm_channelizer_matrix`.  ``demod_mode``:
    "classic" (boxcar mean of per-frame angles) or "coherent" (angle of
    the boxcar mean of the lag products).
    """
    _check_k1(x2, hist, hp, bperm, decim, demod_mode)
    if x2.device.type == "cpu":
        return channelize_demod_decim_plain(x2, hist, hp, bperm, fm_ref,
                                            decim, demod_mode)
    M, n = x2.shape
    C, P = n // 2, hp.shape[0]
    _cuda_shape("channelize_demod_decim", x2, C, P, decim)
    out = torch.empty((M // decim, C), dtype=torch.float32,
                      device=x2.device)
    _launch("channelize_demod_decim",
            {"x2": x2, "hist": hist, "hp": hp, "bperm": bperm},
            ("bperm", bperm, 16),
            _channelize_launcher("channelize_demod_decim_launch"),
            x2.data_ptr(), hist.data_ptr(), hp.data_ptr(), bperm.data_ptr(),
            out.data_ptr(), M, C, P, decim, _INGEST_DTYPES[x2.dtype],
            _DEMOD_MODES[demod_mode], float(np.float32(fm_ref)))
    channelize_demod_decim.launches += 1
    return out


channelize_demod_decim.launches = 0


# ---------------------------------------------------------------------------
# K1's split form with stages removed (K16, the TPU's chan_ablate.py)

# the stages, and the kernel instance each runs: "reshape_mean" (the TPU's
# decimation by reshape and mean, a relayout question there) computes
# "full"'s function, so it runs that instance
CHANNELIZE_ABLATE_STAGES = ("full", "no_fir", "no_atan", "no_demod",
                            "matmul_only", "reshape_mean", "full_rate")
CHANNELIZE_ABLATE_INSTANCES = ("full", "no_fir", "no_atan", "no_demod",
                               "matmul_only", "full_rate")
CHANNELIZE_ABLATE_INSTANCE_OF = {
    **{s: s for s in CHANNELIZE_ABLATE_INSTANCES}, "reshape_mean": "full"}
K16_CHANNELS = (8, 64)                # the C the kernel is built for


def _check_ablate_stage(stage: str, stages) -> None:
    if stage not in stages:
        raise ValueError(f"stage must be one of {stages}; got {stage!r}")


def k16_instance(channels: int, stage: str = "full") -> str:
    """The kernel instance that :func:`channelize_ablate` launches for
    this C and stage: K1's tensor-core template on float32 rows with the
    5-term atan2 and a true division, named as ptxas's report names it
    (``ab_spectrum.instance_name``)."""
    _check_ablate_stage(stage, CHANNELIZE_ABLATE_STAGES)
    return _tc_instance(channels, torch.float32, "poly5div",
                        CHANNELIZE_ABLATE_INSTANCES.index(
                            CHANNELIZE_ABLATE_INSTANCE_OF[stage]))


def channelize_ablate_plain(x2: torch.Tensor, hist: torch.Tensor,
                            hp: torch.Tensor, bperm: torch.Tensor,
                            gain: float, decim: int,
                            stage: str = "full") -> torch.Tensor:
    """Plain PyTorch version of :func:`channelize_ablate`."""
    _check_ablate_stage(stage, CHANNELIZE_ABLATE_STAGES)
    M, C = x2.shape[0], x2.shape[1] // 2
    g = float(np.float32(gain))
    if stage == "matmul_only":
        _require_ieee_fp32(x2.device)
        return _boxcar((x2 @ bperm)[:, :C], decim)
    ext = torch.cat([hist, x2])                        # (P + M, 2C)
    if stage == "no_fir":
        _require_ieee_fp32(x2.device)
        y = ext[:M + 1] @ bperm
    else:
        y = _split_products(ext, hp, bperm, M + 1)     # row 0: the lag frame
    if stage == "no_demod":
        return _boxcar(y[1:, :C] * g, decim)
    dr, di = _lag_products(y[:-1], y[1:])
    if stage == "no_atan":
        return _boxcar(di * g, decim)
    angle = atan2_poly(di, dr, poly3=False) * g
    if stage == "full_rate":
        return torch.cat([angle, dr], dim=1)
    return _boxcar(angle, decim)


def channelize_ablate(x2: torch.Tensor, hist: torch.Tensor,
                      hp5: torch.Tensor, bperm5: torch.Tensor, gain: float,
                      decim: int, stage: str = "full") -> torch.Tensor:
    """K1's function in classic mode, from float32 rows, with the 5-term
    atan2 and a true division (the JAX ``_atan2``'s default), with the
    stages of ``stage`` removed: ext = [hist | x2] and y row r the frame
    r - 1 (row 0 the lag frame), y = FIR(ext) @ bperm5.

    - "full" (and "reshape_mean"): mean_D atan2(di, dr) * gain;
    - "no_fir": as "full" with y row r = ext[r] @ bperm5 (no taps);
    - "no_atan": mean_D di * gain;
    - "no_demod": mean_D Re y[frame] * gain, no lag product;
    - "matmul_only": mean_D Re (x2[frame] @ bperm5): no hist, no taps, no
      lag, no gain;
    - "full_rate": (M, 2C) [atan2(di, dr) * gain | dr] at every frame;
      ``decim`` is not used.

    Every other stage returns (M // decim, C).  hist: the previous P rows
    (zeros give the TPU ablation's first halo).  Replaces the TPU stage
    ablation ``tools/ablation/chan_ablate.py`` (``make_call`` with
    ``k_full`` .. ``k_fullrate``) on K1's tensor-core template, one
    instance a stage (:func:`k16_instance`), built for C in
    ``K16_CHANNELS``."""
    _check_ablate_stage(stage, CHANNELIZE_ABLATE_STAGES)
    full_rate = stage == "full_rate"
    _check_k1(x2, hist, hp5, bperm5, 1 if full_rate else decim, "classic",
              float_only=True)
    if x2.device.type == "cpu":
        return channelize_ablate_plain(x2, hist, hp5, bperm5, gain, decim,
                                       stage)
    M, n = x2.shape
    C, P = n // 2, hp5.shape[0]
    _cuda_shape("channelize_ablate", x2, C, P, 1 if full_rate else decim)
    if C not in K16_CHANNELS:
        raise ValueError(f"channelize_ablate: the kernel is built for C in "
                         f"{K16_CHANNELS}; got C={C}")
    instance = CHANNELIZE_ABLATE_INSTANCE_OF[stage]
    out = torch.empty((M, n) if full_rate else (M // decim, C),
                      dtype=torch.float32, device=x2.device)
    _launch("channelize_ablate",
            {"x2": x2, "hist": hist, "hp": hp5, "bperm": bperm5},
            ("bperm", bperm5, 16),
            _channelize_launcher("channelize_ablate_launch"),
            x2.data_ptr(), hist.data_ptr(), hp5.data_ptr(),
            bperm5.data_ptr(), out.data_ptr(), M, C, P, decim,
            CHANNELIZE_ABLATE_INSTANCES.index(instance),
            float(np.float32(gain)))
    channelize_ablate.launches[instance] += 1
    return out


channelize_ablate.launches = dict.fromkeys(CHANNELIZE_ABLATE_INSTANCES, 0)


# ---------------------------------------------------------------------------
# The same function, taps folded into P DFT matrices (K8, JAX v4)


def _check_k8(x2: torch.Tensor, hist: torch.Tensor, bp: torch.Tensor,
              decim: int) -> None:
    _check_frames(x2, float_only=True)
    n = x2.shape[1]
    if bp.dim() != 3 or tuple(bp.shape[1:]) != (n, n) or bp.shape[0] < 1 \
            or bp.dtype != torch.float32:
        raise ValueError(f"bp must be float32 (P, {n}, {n}); got "
                         f"{bp.dtype} {tuple(bp.shape)}")
    _check_hist_decim(x2, hist, bp.shape[0], decim)
    _check_same_device(x2=x2, hist=hist, bp=bp)


def channelize_demod_decim_v4_plain(x2: torch.Tensor, hist: torch.Tensor,
                                    bp: torch.Tensor, fm_ref: float,
                                    decim: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`channelize_demod_decim_v4`."""
    M = x2.shape[0]
    y = _folded_products(torch.cat([hist, x2]), bp, M + 1)
    return _decimated_demod(y, fm_ref, decim, "classic", poly3=False)


def channelize_demod_decim_v4(x2: torch.Tensor, hist: torch.Tensor,
                              bp: torch.Tensor, fm_ref: float,
                              decim: int) -> torch.Tensor:
    """The function of :func:`channelize_demod_decim` in classic mode,
    from float32 rows, with the FIR folded into P accumulating products
    y = sum_p ext[p:] @ bp[p] (bp (P, 2C, 2C) from
    :func:`fold_channelizer_matrices`) and the 5-term atan2 with a true
    division.  Replaces the JAX package's ``channelize_demod_decim``
    (v4).  hist: the previous P rows."""
    _check_k8(x2, hist, bp, decim)
    if x2.device.type == "cpu":
        return channelize_demod_decim_v4_plain(x2, hist, bp, fm_ref, decim)
    M, n = x2.shape
    C, P = n // 2, bp.shape[0]
    _cuda_shape("channelize_demod_decim_v4", x2, C, P, decim)
    out = torch.empty((M // decim, C), dtype=torch.float32,
                      device=x2.device)
    # bp is read as float4
    _launch("channelize_demod_decim_v4", {"x2": x2, "hist": hist, "bp": bp},
            ("bp", bp, 16),
            _channelize_launcher("channelize_demod_decim_v4_launch"),
            x2.data_ptr(), hist.data_ptr(), bp.data_ptr(), out.data_ptr(),
            M, C, P, decim, float(np.float32(fm_ref)))
    channelize_demod_decim_v4.launches += 1
    return out


channelize_demod_decim_v4.launches = 0


# ---------------------------------------------------------------------------
# The same function, 5-term atan2 on an approximate reciprocal (K9, JAX v6)


def channelize_demod_decim_v6_plain(x2: torch.Tensor, hist: torch.Tensor,
                                    hp: torch.Tensor, bperm: torch.Tensor,
                                    fm_ref: float,
                                    decim: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`channelize_demod_decim_v6`, with a
    true division where the kernel refines an approximate reciprocal
    (~1e-7 relative apart)."""
    M = x2.shape[0]
    y = _split_products(torch.cat([hist, x2]), hp, bperm, M + 1)
    return _decimated_demod(y, fm_ref, decim, "classic", poly3=False)


def channelize_demod_decim_v6(x2: torch.Tensor, hist: torch.Tensor,
                              hp: torch.Tensor, bperm: torch.Tensor,
                              fm_ref: float, decim: int) -> torch.Tensor:
    """The function of :func:`channelize_demod_decim` in classic mode,
    from float32 rows, with the 5-term atan2 on the card's approximate
    reciprocal and one Newton step.  Replaces the JAX package's
    ``channelize_demod_decim_v6``."""
    _check_k1(x2, hist, hp, bperm, decim, "classic", float_only=True)
    if x2.device.type == "cpu":
        return channelize_demod_decim_v6_plain(x2, hist, hp, bperm, fm_ref,
                                               decim)
    M, n = x2.shape
    C, P = n // 2, hp.shape[0]
    _cuda_shape("channelize_demod_decim_v6", x2, C, P, decim)
    out = torch.empty((M // decim, C), dtype=torch.float32,
                      device=x2.device)
    _launch("channelize_demod_decim_v6",
            {"x2": x2, "hist": hist, "hp": hp, "bperm": bperm},
            ("bperm", bperm, 16),
            _channelize_launcher("channelize_demod_decim_v6_launch"),
            x2.data_ptr(), hist.data_ptr(), hp.data_ptr(), bperm.data_ptr(),
            out.data_ptr(), M, C, P, decim, float(np.float32(fm_ref)))
    channelize_demod_decim_v6.launches += 1
    return out


channelize_demod_decim_v6.launches = 0


# ---------------------------------------------------------------------------
# FIR + DFT + lag-1 demod, undecimated, lag frame carried (K7, v1 and v2)

K7_VARIANTS = ("v1", "v2")


def block_dft_matrix(wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """[[Wr^T, Wi^T], [-Wi^T, Wr^T]] (2C, 2C): y = z @ B is the complex
    DFT y[c] = sum_k W[c, k] z[k] for re|im-halves rows z."""
    return torch.cat([torch.cat([wr.T, wi.T], dim=1),
                      torch.cat([-wi.T, wr.T], dim=1)], dim=0)


def k7_tables(hp: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
              variant: str):
    """(taps (P, 2C) on both halves, the matrices), contiguous: the block
    DFT matrix (2C, 2C) for "v1", the taps folded into it (P, 2C, 2C) for
    "v2".  A model builds them once (``Channelizer.load_tables``) and
    passes them to :func:`channelize_demod` on every step."""
    b = block_dft_matrix(wr, wi)
    hp2 = torch.cat([hp, hp], dim=1)
    mat = hp2[:, :, None] * b if variant == "v2" else b
    return hp2.contiguous(), mat.contiguous()


def _check_k7(ext: torch.Tensor, hp: torch.Tensor, wr: torch.Tensor,
              wi: torch.Tensor, prev: torch.Tensor, variant: str,
              tables) -> None:
    if variant not in K7_VARIANTS:
        raise ValueError(f"variant must be 'v1' or 'v2'; got {variant!r}")
    if hp.dim() != 2 or hp.shape[0] < 1 or hp.dtype != torch.float32:
        raise ValueError(f"hp must be float32 (P, C); got {hp.dtype} "
                         f"{tuple(hp.shape)}")
    P, C = hp.shape
    if ext.dim() != 2 or ext.shape[1] != 2 * C or ext.shape[0] < P \
            or ext.dtype != torch.float32:
        raise ValueError(f"ext must be float32 (M + {P - 1}, {2 * C}) with "
                         f"M >= 1; got {ext.dtype} {tuple(ext.shape)}")
    for what, t, shape in (("wr", wr, (C, C)), ("wi", wi, (C, C)),
                           ("prev", prev, (1, 2 * C))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{what} must be float32 {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if tables is None:
        _check_same_device(ext=ext, hp=hp, wr=wr, wi=wi, prev=prev)
        return
    hp2, mat = tables
    mshape = (P, 2 * C, 2 * C) if variant == "v2" else (2 * C, 2 * C)
    for what, t, shape in (("tables[0]", hp2, (P, 2 * C)),
                           ("tables[1]", mat, mshape)):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{what} must be float32 {shape} for "
                             f"variant {variant!r}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    _check_same_device(ext=ext, hp=hp, wr=wr, wi=wi, prev=prev, hp2=hp2,
                       mat=mat)


def channelize_demod_plain(ext: torch.Tensor, hp: torch.Tensor,
                           wr: torch.Tensor, wi: torch.Tensor,
                           prev: torch.Tensor, fm_ref: float,
                           variant: str = "v1", tables=None):
    """Plain PyTorch version of :func:`channelize_demod`."""
    M = ext.shape[0] - (hp.shape[0] - 1)
    hp2, mat = tables if tables is not None else \
        k7_tables(hp, wr, wi, variant)
    y = _folded_products(ext, mat, M) if variant == "v2" else \
        _split_products(ext, hp2, mat, M)              # (M, 2C)
    dr, di = _lag_products(torch.cat([prev, y[:-1]]), y)
    g = float(np.float32(fm_ref))
    return atan2_poly(di, dr, poly3=False) * g, y[M - 1:].clone()


def channelize_demod(ext: torch.Tensor, hp: torch.Tensor, wr: torch.Tensor,
                     wi: torch.Tensor, prev: torch.Tensor, fm_ref: float,
                     variant: str = "v1", tables=None):
    """(M + P - 1, 2C) frames and history -> (demod (M, C), ylast
    (1, 2C)), the contract of the JAX package's ``channelize_demod``.

    ext: float32 rows, re in [:, :C], im in [:, C:]; its first P - 1 rows
    are the history.  hp: (P, C) taps (tap p applies to window offset p),
    duplicated onto both halves here.  wr, wi: (C, C) DFT matrix parts,
    packed here into :func:`block_dft_matrix`.  prev: (1, 2C) the last
    filterbank frame of the previous step, the lag of frame 0.
    demod[m, c] = atan2(Im, Re)(conj(y[m-1]) y[m]) * fm_ref with the
    5-term atan2 and a true division; ylast = y[M-1].  ``variant``: "v1"
    FIR then one DFT product; "v2" the taps folded into P matrices.
    ``tables``: :func:`k7_tables` of these taps and parts for this
    variant, which a model builds once; built here when None."""
    _check_k7(ext, hp, wr, wi, prev, variant, tables)
    if ext.device.type == "cpu":
        return channelize_demod_plain(ext, hp, wr, wi, prev, fm_ref, variant,
                                      tables)
    P, C = hp.shape
    M = ext.shape[0] - (P - 1)
    _cuda_shape("channelize_demod", ext, C, P, 1)
    hp2, mat = tables if tables is not None else \
        k7_tables(hp, wr, wi, variant)
    demod = torch.empty((M, C), dtype=torch.float32, device=ext.device)
    ylast = torch.empty((1, 2 * C), dtype=torch.float32, device=ext.device)
    # the matrices are read as float4
    _launch("channelize_demod", {"ext": ext, "prev": prev, "hp2": hp2,
                                 "B": mat}, ("B", mat, 16),
            _channelize_launcher("channelize_demod_launch"),
            ext.data_ptr(), hp2.data_ptr(), mat.data_ptr(), prev.data_ptr(),
            demod.data_ptr(), ylast.data_ptr(), M, C, P,
            int(variant == "v2"),
            float(np.float32(fm_ref)))
    channelize_demod.launches += 1
    return demod, ylast


channelize_demod.launches = 0


# ---------------------------------------------------------------------------
# WBFM front end: channel FIR + lag-1 discriminator (K4 v2, K12 v1)


def wbfm_coherent_unsupported(decim: int) -> str:
    """Why ``coherent_decim=decim`` is refused, or "" if it is taken.
    A group of D samples spans lcm(D, 128)/128 rows of 128; more than
    16 is refused, as the JAX package refuses it."""
    if decim < 1:
        return f"coherent_decim must be >= 1; got {decim}"
    rows = math.lcm(decim, 128) // 128
    if rows > WBFM_MAX_COHERENT_ROWS:
        return (f"coherent_decim={decim} groups span lcm(D,128)/128 = "
                f"{rows} rows of 128 samples (more than "
                f"{WBFM_MAX_COHERENT_ROWS}); use a D sharing more factors "
                "with 128 or the classic mode")
    return ""


def _check_wbfm(name: str, x: torch.Tensor, n: int, taps: torch.Tensor,
                hist: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: IQ must be float32; got {x.dtype}")
    if n < 128 or n % 128:
        raise ValueError(f"{name}: n ({n}) must be a positive multiple "
                         "of 128")
    if taps.dim() != 1 or taps.dtype != torch.float32 or \
            not 1 <= taps.shape[0] <= WBFM_MAX_TAPS:
        raise ValueError(f"{name}: taps must be float32 (T,) with "
                         f"1 <= T <= {WBFM_MAX_TAPS}; got {taps.dtype} "
                         f"{tuple(taps.shape)}")
    K = taps.shape[0] - 1
    if tuple(hist.shape) != (2, K) or hist.dtype != torch.float32:
        raise ValueError(f"{name}: hist must be float32 (2, {K}); got "
                         f"{hist.dtype} {tuple(hist.shape)}")
    if len({t.device for t in (x, taps, hist)}) != 1:
        raise ValueError(f"{name}: IQ, taps and hist must share one device")


def _wbfm_fir(x: torch.Tensor, taps: torch.Tensor,
              hist: torch.Tensor) -> torch.Tensor:
    """Planar x (2, n) -> y = FIR(x) (2, n + 1), samples -1 .. n-1.
    y[-1], the lag of the first sample, is filtered from ``hist`` alone:
    the sample before ``hist`` counts as zero."""
    zero = torch.zeros((2, 1), dtype=torch.float32, device=x.device)
    ext = torch.cat([zero, hist, x], dim=-1)           # (2, 1 + K + n)
    return _corr_valid(ext, taps.flip(0))


def _wbfm_lag_products(x: torch.Tensor, taps: torch.Tensor,
                       hist: torch.Tensor):
    """Planar x (2, n) -> the lag products (dr, di) of y = FIR(x), each
    (n,), with y[-1] as :func:`_wbfm_fir` takes it."""
    y = _wbfm_fir(x, taps, hist)                       # y[-1 .. n-1]
    pr, pi = y[0, :-1], y[1, :-1]
    yr, yi = y[0, 1:], y[1, 1:]
    return pr * yr + pi * yi, pr * yi - pi * yr        # conj(y[i-1]) y[i]


def _wbfm_demod(dr: torch.Tensor, di: torch.Tensor, ref_gain: float,
                poly3: bool, coherent_decim: int) -> torch.Tensor:
    g = float(np.float32(ref_gain))
    D = coherent_decim
    if D:
        m = dr.shape[0] // D
        drm = dr[:m * D].reshape(m, D).mean(1)
        dim = di[:m * D].reshape(m, D).mean(1)
        return atan2_poly(dim, drm, poly3=poly3) * g
    return atan2_poly(di, dr, poly3=poly3) * g


# the C entry points of csrc/wbfm_fused.cu and their arguments
_WBFM_ARGTYPES = {
    "wbfm_fused_launch": [_VP] * 4 + [_INT] * 2 + [_FLT, _VP],
    "wbfm_fused_v2_launch": [_VP] * 4 + [_INT] * 3 + [_FLT, _VP],
    "wbfm_ablate_launch": [_VP] * 4 + [_INT] * 3 + [_FLT, _VP],
}


@functools.lru_cache(maxsize=None)
def _wbfm_launcher(symbol: str):
    fn = getattr(_build.load("wbfm_fused.cu"), symbol)
    fn.argtypes = _WBFM_ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _wbfm_launch(name: str, planar: bool, x: torch.Tensor, n: int,
                 taps: torch.Tensor, hist: torch.Tensor, ref_gain: float,
                 D: int) -> torch.Tensor:
    """Launch K12 (``planar``) or K4 on CUDA tensors; returns the output
    (n // D,) or (n,), which must not be empty.  The caller counts the
    launch."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if n >= 2 ** 31:
        raise ValueError(f"{name}: the CUDA kernel takes n < 2^31 samples")
    out = torch.empty((n // D if D else n,), dtype=torch.float32,
                      device=x.device)
    # interleaved IQ is read as float2
    _launch(name, {"IQ": x, "taps": taps, "hist": hist},
            None if planar else ("interleaved IQ", x, 8),
            _wbfm_launcher("wbfm_fused_launch" if planar
                           else "wbfm_fused_v2_launch"),
            x.data_ptr(), hist.data_ptr(), taps.data_ptr(), out.data_ptr(),
            n, taps.shape[0], *(() if planar else (D,)),
            float(np.float32(ref_gain)))
    return out


def wbfm_fused_v2_plain(iq: torch.Tensor, taps: torch.Tensor,
                        hist: torch.Tensor, ref_gain: float,
                        coherent_decim: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`wbfm_fused_v2`."""
    dr, di = _wbfm_lag_products(iq.T, taps, hist)
    return _wbfm_demod(dr, di, ref_gain, True, coherent_decim)


def wbfm_fused_v2(iq: torch.Tensor, taps: torch.Tensor, hist: torch.Tensor,
                  ref_gain: float, coherent_decim: int = 0) -> torch.Tensor:
    """(n, 2) raw interleaved IQ -> (n,) FM demod, or (n // D,) audio.

    y = FIR(x) with real ``taps`` (T,), T <= 129, over ``[hist | x]``;
    ``hist`` (2, T-1) planar holds the previous block's last raw samples.
    demod[i] = atan2(Im(conj(y[i-1]) y[i]), Re(...)) * ref_gain, with the
    3-term polynomial atan2 and a true fp32 division.  With
    ``coherent_decim=D`` the lag products are averaged over each group
    of D samples [gD, (g+1)D) and one angle is taken per group.
    n % 128 == 0.
    """
    if iq.dim() != 2 or iq.shape[1] != 2:
        raise ValueError(f"iq must be (n, 2); got {tuple(iq.shape)}")
    n = iq.shape[0]
    _check_wbfm("wbfm_fused_v2", iq, n, taps, hist)
    if coherent_decim:
        problem = wbfm_coherent_unsupported(coherent_decim)
        if problem:
            raise ValueError(problem)
    if iq.device.type == "cpu":
        return wbfm_fused_v2_plain(iq, taps, hist, ref_gain, coherent_decim)
    if coherent_decim > n:              # fewer samples than one group
        return iq.new_empty((0,))
    out = _wbfm_launch("wbfm_fused_v2", False, iq, n, taps, hist, ref_gain,
                       int(coherent_decim))
    wbfm_fused_v2.launches += 1
    return out


wbfm_fused_v2.launches = 0


def wbfm_fused_plain(x: torch.Tensor, taps: torch.Tensor,
                     hist: torch.Tensor, ref_gain: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`wbfm_fused`."""
    dr, di = _wbfm_lag_products(x, taps, hist)
    return _wbfm_demod(dr, di, ref_gain, False, 0)


def wbfm_fused(x: torch.Tensor, taps: torch.Tensor, hist: torch.Tensor,
               ref_gain: float) -> torch.Tensor:
    """(2, n) planar IQ -> (n,) FM demod: the contract of
    :func:`wbfm_fused_v2` in classic mode, from planar input, with the
    5-term polynomial atan2."""
    if x.dim() != 2 or x.shape[0] != 2:
        raise ValueError(f"x must be (2, n); got {tuple(x.shape)}")
    n = x.shape[1]
    _check_wbfm("wbfm_fused", x, n, taps, hist)
    if x.device.type == "cpu":
        return wbfm_fused_plain(x, taps, hist, ref_gain)
    out = _wbfm_launch("wbfm_fused", True, x, n, taps, hist, ref_gain, 0)
    wbfm_fused.launches += 1
    return out


wbfm_fused.launches = 0


# ---------------------------------------------------------------------------
# wbfm_fused with stages removed (K17, the TPU's wbfm_ablate.py)

# the variants, and the kernel instance each runs: the TPU's "shift" and
# "shiftnoat" take y[j-1] by a roll of y instead of a second band matrix;
# K12's kernel always takes it from its neighbour in shared memory, so they
# run "full"'s and "noatan"'s instances
WBFM_ABLATE_STAGES = ("full", "noatan", "onlyfir", "shift", "shiftnoat")
WBFM_ABLATE_INSTANCES = ("full", "noatan", "onlyfir")
WBFM_ABLATE_INSTANCE_OF = {"full": "full", "noatan": "noatan",
                           "onlyfir": "onlyfir", "shift": "full",
                           "shiftnoat": "noatan"}


def wbfm_ablate_plain(x: torch.Tensor, taps: torch.Tensor,
                      hist: torch.Tensor, gain: float,
                      stage: str = "full") -> torch.Tensor:
    """Plain PyTorch version of :func:`wbfm_ablate`."""
    _check_ablate_stage(stage, WBFM_ABLATE_STAGES)
    instance = WBFM_ABLATE_INSTANCE_OF[stage]
    if instance == "onlyfir":
        y = _wbfm_fir(x, taps, hist)[:, 1:]
        return y[0] + y[1]
    dr, di = _wbfm_lag_products(x, taps, hist)
    if instance == "noatan":
        return dr + di
    return _wbfm_demod(dr, di, gain, False, 0)


def wbfm_ablate(x: torch.Tensor, taps: torch.Tensor, hist: torch.Tensor,
                gain: float, stage: str = "full") -> torch.Tensor:
    """(2, n) planar IQ -> (n,): :func:`wbfm_fused`'s function with the
    stages of ``stage`` removed, for y = FIR(x) over [hist | x]:

    - "full" (and "shift"): atan2(di, dr) * gain, K12's function;
    - "noatan" (and "shiftnoat"): dr + di;
    - "onlyfir": Re y + Im y, no lag path.

    Every sample is exact: the TPU ablation's dropped tap at T = 129 and
    its shift variants' unpatched lag at each tile's start are not carried
    over.  Replaces ``tools/ablation/wbfm_ablate.py`` (``make_variant``)."""
    _check_ablate_stage(stage, WBFM_ABLATE_STAGES)
    if x.dim() != 2 or x.shape[0] != 2:
        raise ValueError(f"x must be (2, n); got {tuple(x.shape)}")
    n = x.shape[1]
    _check_wbfm("wbfm_ablate", x, n, taps, hist)
    if x.device.type == "cpu":
        return wbfm_ablate_plain(x, taps, hist, gain, stage)
    if x.device.type != "cuda":
        raise ValueError(f"wbfm_ablate: unsupported device {x.device}")
    if n >= 2 ** 31:
        raise ValueError("wbfm_ablate: the CUDA kernel takes n < 2^31 "
                         "samples")
    instance = WBFM_ABLATE_INSTANCE_OF[stage]
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    _launch("wbfm_ablate", {"IQ": x, "taps": taps, "hist": hist}, None,
            _wbfm_launcher("wbfm_ablate_launch"),
            x.data_ptr(), hist.data_ptr(), taps.data_ptr(), out.data_ptr(),
            n, taps.shape[0], WBFM_ABLATE_INSTANCES.index(instance),
            float(np.float32(gain)))
    wbfm_ablate.launches[instance] += 1
    return out


wbfm_ablate.launches = dict.fromkeys(WBFM_ABLATE_INSTANCES, 0)


def zero_ablate_counts() -> None:
    """Set the two ablation wrappers' launch counts to 0."""
    channelize_ablate.launches = dict.fromkeys(CHANNELIZE_ABLATE_INSTANCES,
                                               0)
    wbfm_ablate.launches = dict.fromkeys(WBFM_ABLATE_INSTANCES, 0)


# ---------------------------------------------------------------------------
# Fused spectrum: window + FFT + dB + range + soft clip (K2 ct5)


def k2_cuda_unsupported(n: int) -> str:
    """Why the spectrum kernel cannot take an n-point row, or "" if it
    can: n = 128 m with m a power of two <= 32 (n = 128 .. 4096)."""
    m = n // 128
    if n % 128 == 0 and 1 <= m <= CT_MAX_CHUNKS and m & (m - 1) == 0:
        return ""
    return (f"the spectrum kernel takes n = 128*m with m a power of two "
            f"<= {CT_MAX_CHUNKS} (n = 128 .. {128 * CT_MAX_CHUNKS}); "
            f"got n={n}")


@functools.lru_cache(maxsize=None)
def _dft_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """(n, 2) float32 W_n^t = [cos, -sin] of 2 pi t / n, t < n, computed
    in float64 on the host.  Entry (j k) mod n holds the JAX package's
    ``_dft_cs(n)`` at [j, k]: its cos, and minus its sin."""
    ang = 2.0 * np.pi * np.arange(n) / n
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def _k2_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """(n/2, 2) float32 [cos, sin] of -2 pi k / n, k < n/2: the radix-2
    passes' table, the first half of :func:`_dft_twiddles`."""
    return _dft_twiddles(n, device)[:n // 2]


@functools.lru_cache(maxsize=None)
def _bit_reversal(n: int, device: torch.device) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return torch.from_numpy(rev).to(device)


def _check_spectrum(iq: torch.Tensor, win: torch.Tensor,
                    unsupported) -> None:
    """The checks of the fused spectrum wrappers; ``unsupported(n)`` says
    why the kernel cannot take n-point rows, or ""."""
    if iq.dim() != 3 or iq.shape[2] != 2 or iq.dtype != torch.float32:
        raise ValueError(f"iq must be float32 (B, n, 2); got {iq.dtype} "
                         f"{tuple(iq.shape)}")
    if iq.shape[0] < 1 or iq.shape[1] < 1:
        raise ValueError("iq must hold at least one row of one sample")
    n = iq.shape[1]
    problem = unsupported(n)
    if problem:
        raise ValueError(problem)
    if tuple(win.shape) != (n,) or win.dtype != torch.float32:
        raise ValueError(f"win must be float32 ({n},); got {win.dtype} "
                         f"{tuple(win.shape)}")
    if win.device != iq.device:
        raise ValueError("iq and win must share one device")


def _spectrum_epilogue(mag2: torch.Tensor, coeff: float, scale: float,
                       offset: float) -> torch.Tensor:
    """|X|^2 -> 0.5 + 0.5 tanh(4 (db scale + offset - 0.5)), db = 10 log10
    |X|^2 + coeff, log10 as ln x 0.4342944819 (the JAX kernel's form); the
    JAX floor f32(1e-60) is 0, so |X|^2 = 0 gives -inf and then 0."""
    db = 10.0 * (torch.log(mag2) * _LOG10_E) + coeff
    norm = db * scale + offset
    return 0.5 + 0.5 * torch.tanh(4.0 * (norm - 0.5))


def _spectrum_scalars(coeff: float, scale: float, offset: float):
    """The epilogue's scalars as float32-rounded python floats."""
    return tuple(float(np.float32(v)) for v in (coeff, scale, offset))


def _round(x: torch.Tensor) -> torch.Tensor:
    """A float64 result rounded to float32, kept in float64."""
    return x.float().double()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c of float32 values held in float64, rounded once to float32
    as a fused multiply-add rounds it (the float64 product is exact; the
    float64 sum rounds a second time only near a float32 halfway case);
    kept in float64."""
    return _round(a * b + c)


def _cmul(wr, wi, vr, vi):
    """(wr + j wi)(vr + j vi) of float32 values held in float64, rounded
    as the kernels' ``cmul``: fma(wr, vr, -(wi vi)), fma(wr, vi, wi vr),
    the inner products rounded to float32 first."""
    return (_fma(wr, vr, -_round(wi * vi)), _fma(wr, vi, _round(wi * vr)))


def _mag2(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """float32 |X|^2 rounded as the kernels' fma(re, re, im im): the fast
    log10 jumps at each power of two, so a last-bit difference there would
    show."""
    re, im = re.double(), im.double()
    return _fma(re, re, _round(im * im)).float()


def _radix2_passes(re: torch.Tensor, im: torch.Tensor, tw: torch.Tensor):
    """log2 n radix-2 decimation-in-time passes over (B, n) rows already
    in bit-reversed order, with twiddles from the float32 table ``tw``
    (:func:`_k2_twiddles`): the kernels' own pass loop, rounded as they
    round it (float32 values carried in float64, each step rounded to
    float32 as the kernel's fused multiply-adds and adds round it), so
    that the FFT's cancellation at the spectrum's deep nulls does not
    amplify a difference of rounding.  Returns float32 (re, im) planes in
    natural bin order."""
    B, n = re.shape
    re, im, tw = re.double(), im.double(), tw.double()
    half = 1
    while half < n:
        w = tw[::n // (2 * half)]                      # (half, 2)
        re, im = re.reshape(B, -1, 2, half), im.reshape(B, -1, 2, half)
        ur, ui = re[:, :, 0], im[:, :, 0]
        tr, ti = _cmul(w[:, 0], w[:, 1], re[:, :, 1], im[:, :, 1])
        re = _round(torch.stack([ur + tr, ur - tr], dim=2)).reshape(B, n)
        im = _round(torch.stack([ui + ti, ui - ti], dim=2)).reshape(B, n)
        half *= 2
    return re.float(), im.float()


def spectrum_fused_ct5_plain(iq: torch.Tensor, win: torch.Tensor,
                             coeff: float, scale: float,
                             offset: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`spectrum_fused_ct5`, following the
    kernel's own steps: the windowed load at bit-reversed positions,
    log2 n radix-2 decimation-in-time passes with twiddles from the same
    float32 table, then the epilogue."""
    n = iq.shape[1]
    rev = _bit_reversal(n, iq.device)
    re, im = _radix2_passes((iq[..., 0] * win)[:, rev],
                            (iq[..., 1] * win)[:, rev],
                            _k2_twiddles(n, iq.device))
    return _spectrum_epilogue(_mag2(re, im),
                              *_spectrum_scalars(coeff, scale, offset))


@functools.lru_cache(maxsize=None)
def _k2_launcher():
    fn = _build.load("spectrum_fused.cu").spectrum_fused_ct5_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
        [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spectrum_fused_ct5(iq: torch.Tensor, win: torch.Tensor, coeff: float,
                       scale: float, offset: float) -> torch.Tensor:
    """(B, n, 2) float32 re/im -> (B, n) float32 in [0, 1], natural bin
    order: X = FFT_n(win (re + j im)); out = 0.5 + 0.5 tanh(4 (db scale +
    offset - 0.5)) with db = 10 log10 |X|^2 + coeff.  ``win`` (n,) holds
    the window times (-1)^k.  n = 128 m, m a power of two <= 32."""
    _check_spectrum(iq, win, k2_cuda_unsupported)
    if iq.device.type == "cpu":
        return spectrum_fused_ct5_plain(iq, win, coeff, scale, offset)
    if iq.device.type != "cuda":
        raise ValueError(f"spectrum_fused_ct5: unsupported device "
                         f"{iq.device}")
    B, n, _ = iq.shape
    tw = _k2_twiddles(n, iq.device)
    out = torch.empty((B, n), dtype=torch.float32, device=iq.device)
    # iq is read as float2
    _launch("spectrum_fused_ct5", {"iq": iq, "win": win}, ("iq", iq, 8),
            _k2_launcher(),
            iq.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(),
            B, n, *_spectrum_scalars(coeff, scale, offset))
    spectrum_fused_ct5.launches += 1
    return out


spectrum_fused_ct5.launches = 0


# ---------------------------------------------------------------------------
# The plain DFT product of K6 (and of step_dft)


def _require_ieee_fp32(device: torch.device) -> None:
    """Refuse float32 matrix products on the card under TF32: cuBLAS
    follows the global TF32 switches, and TF32 products are ~1e-3 off, so
    a reference made with them would be wrong."""
    if device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "these float32 products need full float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def dft_products(xr: torch.Tensor, xi: torch.Tensor, bf16: bool = False,
                 dtype: torch.dtype = torch.float32):
    """(B, n) float32 re/im planes -> (yr, yi), Y[k] = sum_t x[t] W_n^(t k),
    as the JAX package's four real matrix products (xr C + xi S,
    xi C - xr S) in ``dtype``, against the C/S columns of the DFT matrix
    gathered from :func:`_dft_twiddles`, a block of columns at a time
    (at most ``DFT_COLUMN_ENTRIES`` entries).  ``bf16`` rounds x, C and
    S to bfloat16 first and sums the exact products in float32, as a
    bf16 product with float32 accumulation does."""
    if dtype == torch.float32:
        _require_ieee_fp32(xr.device)
    n = xr.shape[-1]
    tw = _dft_twiddles(n, xr.device).to(dtype)
    t = torch.arange(n, device=xr.device)
    if bf16:
        xr, xi = (v.to(torch.bfloat16).float() for v in (xr, xi))
    xr, xi = xr.to(dtype), xi.to(dtype)
    yr, yi = torch.empty_like(xr), torch.empty_like(xr)
    step = max(1, DFT_COLUMN_ENTRIES // n)
    for k0 in range(0, n, step):
        w = tw[torch.outer(t, t[k0:k0 + step]) % n]     # (n, cols, 2)
        c, s = w[..., 0], -w[..., 1]                    # cos, sin
        if bf16:
            c, s = (v.to(torch.bfloat16).to(dtype) for v in (c, s))
        yr[..., k0:k0 + step] = xr @ c + xi @ s
        yi[..., k0:k0 + step] = xi @ c - xr @ s
    return yr, yi


# ---------------------------------------------------------------------------
# Fused spectrum for any m <= 32: direct m-point stage + 128-point FFT, on
# one kernel template (K5 ct4, K10 ct1, K11 ct3)


def k5_cuda_unsupported(n: int) -> str:
    """Why the ct spectrum kernel (K5, K10, K11) cannot take an n-point
    row, or "" if it can: n = 128 m with 1 <= m <= 32 (n = 128 .. 4096)."""
    if n % 128 == 0 and 1 <= n // 128 <= CT_MAX_CHUNKS:
        return ""
    return (f"the ct spectrum kernel takes n = 128*m with 1 <= m <= "
            f"{CT_MAX_CHUNKS} (n = 128 .. {128 * CT_MAX_CHUNKS}); got n={n}")


# the kernel's epilogue instances and K11's ablation flags (csrc)
_CT_EPILOGUES = {"exact": 0, "approx": 1, "none": 2}
_CT_SKIP_FLAGS = {"s1": 1, "tw": 2, "s2": 4}


def _chunk_dft(xr: torch.Tensor, xi: torch.Tensor, wm: torch.Tensor):
    """The ct kernel's m-point DFT over the chunk axis, A[b, k1, n2] =
    sum_n1 x[b, n1, n2] W_m^(n1 k1), with ``wm`` (n1, k1, 2) the float32
    table and x (B, m, 128) the windowed float32 chunks: summed over n1 in
    the kernel's order with its two fused multiply-adds a step, so that
    both round alike (a float32 matrix product sums in another order, and
    the display amplifies that difference at the spectrum's deep nulls).
    Returns (re, im) float32, (B, m, 128)."""
    B, m, _ = xr.shape
    wr, wi = wm[..., 0, None].double(), wm[..., 1, None].double()
    ar = torch.zeros((B, m, 128), dtype=torch.float64, device=xr.device)
    ai = torch.zeros_like(ar)
    for n1 in range(m):
        xr1, xi1 = xr[:, n1, None].double(), xi[:, n1, None].double()
        ar = _fma(xr1, wr[n1], _fma(-xi1, wi[n1], ar))
        ai = _fma(xr1, wi[n1], _fma(xi1, wr[n1], ai))
    return ar.float(), ai.float()


def _ct_stages(iq: torch.Tensor, win: torch.Tensor, skip=frozenset()):
    """The ct kernel's steps up to the epilogue, with t = 128 n1 + n2 and
    k = m k2 + k1: the windowed m-point DFT over the chunk axis n1, the
    twiddle W_n^(k1 n2), the m 128-point radix-2 transforms over n2 (rows
    in bit-reversed order, K2's passes and table: the kernel runs the same
    butterflies, stage for stage, in registers).  ``skip`` holds K11's
    ablation flags: "s1" takes windowed chunk 0 for every stage-1 output,
    "tw" drops the twiddle, "s2" the 128-point stage.  Returns the (re,
    im) planes of Y[b, k1, k2] as (B m, 128)."""
    B, n, _ = iq.shape
    m = n // 128
    dev = iq.device
    tw = _dft_twiddles(n, dev)
    xr = (iq[..., 0] * win).reshape(B, m, 128)
    xi = (iq[..., 1] * win).reshape(B, m, 128)
    k1 = torch.arange(m, device=dev)
    if "s1" in skip:
        br, bi = xr[:, :1].expand(B, m, 128), xi[:, :1].expand(B, m, 128)
    else:
        br, bi = _chunk_dft(xr, xi, tw[128 * (torch.outer(k1, k1) % m)])
    if "tw" not in skip:
        t2 = tw[torch.outer(k1, torch.arange(128, device=dev))].double()
        br, bi = (v.float() for v in _cmul(t2[..., 0], t2[..., 1],
                                           br.double(), bi.double()))
    br, bi = br.reshape(B * m, 128), bi.reshape(B * m, 128)
    if "s2" in skip:
        return br, bi
    rev = _bit_reversal(128, dev)
    return _radix2_passes(br[:, rev], bi[:, rev], _k2_twiddles(128, dev))


def _atanh_pade(x: torch.Tensor) -> torch.Tensor:
    """K11's Padé(7,6) tanh, clamped at |x| = 4.5, its division as a
    reciprocal and one Newton step r (2 - den r), as the kernel's
    ``rcp.approx`` and the TPU kernel's approximate reciprocal take it
    (:func:`fastmath.approx_tanh` divides)."""
    xc = x.clamp(-4.5, 4.5)
    x2 = xc * xc
    num = xc * (135135.0 + x2 * (17325.0 + x2 * (378.0 + x2)))
    den = 135135.0 + x2 * (62370.0 + x2 * (3150.0 + x2 * 28.0))
    r = torch.reciprocal(den)
    return num * (r * (2.0 - den * r))


def _ct_epilogue(re: torch.Tensor, im: torch.Tensor, ep: str, coeff: float,
                 scale: float, offset: float) -> torch.Tensor:
    """The ct kernel's epilogue instance ``ep``: "exact" (log and tanh),
    "approx" (the exponent-bits log10, whose value at |X|^2 = 0 is finite,
    and :func:`_atanh_pade`) or "none" (|X|^2 itself)."""
    mag2 = _mag2(re, im)
    if ep == "none":
        return mag2
    if ep == "exact":
        return _spectrum_epilogue(mag2, coeff, scale, offset)
    db = 10.0 * approx_log10(mag2) + coeff
    return 0.5 + 0.5 * _atanh_pade(4.0 * (db * scale + offset - 0.5))


def _ct_plain(iq: torch.Tensor, win: torch.Tensor, coeff: float,
              scale: float, offset: float, ep: str = "exact",
              skip=frozenset()) -> torch.Tensor:
    """The ct kernel's plain version: :func:`_ct_stages`, the epilogue
    ``ep``, and the un-permute out[b, m k2 + k1] = Y[b, k1, k2]."""
    B, n, _ = iq.shape
    y = _ct_epilogue(*_ct_stages(iq, win, skip), ep,
                     *_spectrum_scalars(coeff, scale, offset))
    return y.reshape(B, n // 128, 128).transpose(1, 2).reshape(B, n)


def spectrum_fused_ct4_plain(iq: torch.Tensor, win: torch.Tensor,
                             coeff: float, scale: float,
                             offset: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`spectrum_fused_ct4`, following the
    kernel's steps (:func:`_ct_plain`)."""
    return _ct_plain(iq, win, coeff, scale, offset)


@functools.lru_cache(maxsize=None)
def _ct_launcher(ct3: bool = False):
    """K5's C entry point (K10 shares it), or K11's with its two mode
    codes."""
    lib = _build.load("spectrum_fused.cu")
    fn = lib.spectrum_fused_ct3_launch if ct3 else \
        lib.spectrum_fused_ct4_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (4 if ct3 else 2) \
        + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ct_launch(name: str, iq: torch.Tensor, win: torch.Tensor,
               coeff: float, scale: float, offset: float,
               modes=None) -> torch.Tensor:
    """Launch the ct kernel on CUDA tensors for the wrapper ``name``: the
    exact epilogue without ablation flags, or with ``modes`` K11's
    epilogue and skip codes.  The caller counts the launch."""
    if iq.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {iq.device}")
    B, n, _ = iq.shape
    tw = _dft_twiddles(n, iq.device)
    tw128 = _k2_twiddles(128, iq.device)
    out = torch.empty((B, n), dtype=torch.float32, device=iq.device)
    # iq is read as float2
    _launch(name, {"iq": iq, "win": win}, ("iq", iq, 8),
            _ct_launcher(modes is not None),
            iq.data_ptr(), win.data_ptr(), tw.data_ptr(), tw128.data_ptr(),
            out.data_ptr(), B, n, *(modes or ()),
            *_spectrum_scalars(coeff, scale, offset))
    return out


def spectrum_fused_ct4(iq: torch.Tensor, win: torch.Tensor, coeff: float,
                       scale: float, offset: float) -> torch.Tensor:
    """The contract of :func:`spectrum_fused_ct5` for n = 128 m with any
    1 <= m <= 32."""
    _check_spectrum(iq, win, k5_cuda_unsupported)
    if iq.device.type == "cpu":
        return spectrum_fused_ct4_plain(iq, win, coeff, scale, offset)
    out = _ct_launch("spectrum_fused_ct4", iq, win, coeff, scale, offset)
    spectrum_fused_ct4.launches += 1
    return out


spectrum_fused_ct4.launches = 0


def spectrum_fused_ct_plain(iq: torch.Tensor, win: torch.Tensor,
                            coeff: float, scale: float, offset: float,
                            exact: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`spectrum_fused_ct`: K5's steps
    (:func:`_ct_plain`) for either tier."""
    return _ct_plain(iq, win, coeff, scale, offset)


def spectrum_fused_ct(iq: torch.Tensor, win: torch.Tensor, coeff: float,
                      scale: float, offset: float,
                      exact: bool = True) -> torch.Tensor:
    """K10, the JAX package's ct1 ``spectrum_fused_ct``: the contract of
    :func:`spectrum_fused_ct4` (n = 128 m, any 1 <= m <= 32) on its
    kernel.  ``exact=False`` is the JAX display tier (one default-precision
    matrix pass on the TPU); the same fp32 kernel, which meets the exact
    tier, serves it.  JAX's ``tile_b`` tiles the TPU grid and has no
    counterpart."""
    _check_spectrum(iq, win, k5_cuda_unsupported)
    if iq.device.type == "cpu":
        return spectrum_fused_ct_plain(iq, win, coeff, scale, offset, exact)
    out = _ct_launch("spectrum_fused_ct", iq, win, coeff, scale, offset)
    spectrum_fused_ct.launches += 1
    return out


spectrum_fused_ct.launches = 0


def ct3_modes(B: int, n: int, kb: int = 1, ep: str = "exact", skip=(),
              tile_b: int = 256):
    """K11's epilogue name ("exact", "approx" or "none") and the set of
    ablation flags it honours, as the JAX package's ``spectrum_fused_ct3``
    reads them: ``ep`` "none" and "approx" pick those epilogues and any
    other value the exact one; of ``skip`` it takes "s1", "tw" and "s2"
    (by ``in``) and ignores anything else; and it honours "s1" only where
    its effective ``kb`` is 1.  That ``kb`` falls to 1 when it does not
    divide m, or when the batch tile it derives from B (halved from
    ``tile_b`` until it divides B, else B) is not a multiple of 8."""
    if kb < 1 or tile_b < 1:
        raise ValueError(f"spectrum_fused_ct3: kb and tile_b must be >= 1; "
                         f"got kb={kb}, tile_b={tile_b}")
    if (n // 128) % kb:
        kb = 1
    tile_b = min(tile_b, B)
    while tile_b > 8 and B % tile_b:
        tile_b //= 2
    if B % tile_b:
        tile_b = B
    if tile_b % 8:
        kb = 1
    flags = frozenset(f for f in _CT_SKIP_FLAGS
                      if f in skip and (f != "s1" or kb == 1))
    return (ep if ep in ("approx", "none") else "exact"), flags


def spectrum_fused_ct3_plain(iq: torch.Tensor, win: torch.Tensor,
                             coeff: float, scale: float, offset: float,
                             stage2: str = "x3", three_mul: bool = False,
                             kb: int = 1, ep: str = "exact", skip=(),
                             tile_b: int = 256) -> torch.Tensor:
    """Plain PyTorch version of :func:`spectrum_fused_ct3`: K5's steps
    with the ablation flags and epilogue of :func:`ct3_modes`."""
    ep_, flags = ct3_modes(iq.shape[0], iq.shape[1], kb, ep, skip, tile_b)
    return _ct_plain(iq, win, coeff, scale, offset, ep_, flags)


def spectrum_fused_ct3(iq: torch.Tensor, win: torch.Tensor, coeff: float,
                       scale: float, offset: float, stage2: str = "x3",
                       three_mul: bool = False, kb: int = 1,
                       ep: str = "exact", skip=(),
                       tile_b: int = 256) -> torch.Tensor:
    """K11, the JAX package's ``spectrum_fused_ct3``, with its parameters
    and defaults: the contract of :func:`spectrum_fused_ct4` on its kernel,
    for ``ep`` "exact"; ``ep="approx"`` takes the exponent-bits log10 and
    the clamped Padé tanh (an all-zero row gives ~1e-4, not 0, as in JAX);
    ``ep="none"`` returns |X|^2 in natural bin order.  ``skip`` holds the
    ablation flags "s1", "tw" and "s2", honoured as :func:`ct3_modes`
    says.  Every ``stage2`` (JAX's bf16-split "x3"/"x4", "default",
    "highest" or any other string) runs the fp32 stage, and
    ``three_mul`` only changes JAX's summation order; ``kb`` and
    ``tile_b`` tile the TPU grid and matter here only through "s1"."""
    _check_spectrum(iq, win, k5_cuda_unsupported)
    ep_, flags = ct3_modes(iq.shape[0], iq.shape[1], kb, ep, skip, tile_b)
    if iq.device.type == "cpu":
        return _ct_plain(iq, win, coeff, scale, offset, ep_, flags)
    out = _ct_launch("spectrum_fused_ct3", iq, win, coeff, scale, offset,
                     (_CT_EPILOGUES[ep_],
                      sum(_CT_SKIP_FLAGS[f] for f in flags)))
    spectrum_fused_ct3.launches += 1
    return out


spectrum_fused_ct3.launches = 0


# ---------------------------------------------------------------------------
# The Stockham FFT core of K3 and K6's FFT route (csrc/spectrum_fft.cu)

FFT_MAX_POINTS = 16384            # K6's FFT route takes n <= this ...
FFT_MAX_PRIME = 1021              # ... with every prime factor <= this
FFT_REGISTER_RADICES = (2, 3, 4, 5, 7, 8, 16)
# the largest prime of the shared-memory prime pass; a prime past it runs
# the large-prime pass, register-tiled (csrc/spectrum_fft.cu)
FFT_SMALL_PRIME_MAX = 127
# the runtime-plan instances: (threads a block, values of a pass a thread)
FFT_ANY_BLOCKS = ((256, 16), (512, 32))
# ... and the one that runs a plan with a prime past FFT_SMALL_PRIME_MAX
FFT_LARGE_BLOCK = (256, 12)
# the large-prime pass: a thread holds this many consecutive outputs of
# one group (kLpQ in csrc/spectrum_fft.cu)
LARGE_PASS_OUTPUTS = 4
# the plan as the kernel takes it: radices of PLAN_RADIX_BITS bits, six to
# each of two 64-bit words
PLAN_RADIX_BITS = 10
PLAN_RADICES_A_WORD = 6
K6_ROUTES = ("fft", "split", "chirp", "direct")
# the split route's largest power-of-two factor: its passes' pow2
# instances stop here (kSplitMaxLog2 in csrc/spectrum_fft.cu)
SPLIT_MAX_POW2 = 4096
# the chirp route's preferred convolution lengths: m 2^a for these m
CHIRP_LENGTH_ODD = (1, 3, 5)


def _pow2_radices(bits: int) -> list:
    """2^bits in ceil(bits / 4) passes of radix <= 16, the bits as even as
    they go, larger first: the split the kernel compiles in for n = 128 ..
    16384 (2048 = 16 16 8)."""
    if bits == 0:
        return []
    passes = -(-bits // 4)
    return [1 << (bits // passes + (p < bits % passes))
            for p in range(passes)]


@functools.lru_cache(maxsize=None)
def _prime_factors(n: int) -> tuple:
    """n's prime factors with their multiplicity, smallest first."""
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    return tuple(out + [n] if n > 1 else out)


@functools.lru_cache(maxsize=None)
def fft_plan(n: int) -> tuple:
    """The radices of the FFT core's passes for n points, in pass order,
    whose product is n: the power of two as :func:`_pow2_radices` splits
    it, then the 3s, 5s and 7s (register radices too), then each other
    prime factor (a direct p-point pass: the shared-memory pass up to
    ``FFT_SMALL_PRIME_MAX``, the large-prime pass past it); () for n = 1.
    Raises for a prime factor past ``FFT_MAX_PRIME``."""
    if n < 1:
        raise ValueError(f"fft_plan: n must be >= 1; got {n}")
    odd = [p for p in _prime_factors(n) if p > 2]
    if odd and odd[-1] > FFT_MAX_PRIME:
        raise ValueError(f"fft_plan: n={n} has the prime factor {odd[-1]} "
                         f"> {FFT_MAX_PRIME}")
    return tuple(_pow2_radices((n & -n).bit_length() - 1) + odd)


@functools.lru_cache(maxsize=None)
def _packed_plan(n: int) -> tuple:
    """:func:`fft_plan` as the kernel takes it: the number of passes and
    the radices as ``PLAN_RADIX_BITS``-bit fields of two 64-bit words,
    ``PLAN_RADICES_A_WORD`` to a word, pass 0 lowest.  Raises for a plan
    the fields do not hold (the launcher re-checks every field)."""
    plan = fft_plan(n)
    if len(plan) > 2 * PLAN_RADICES_A_WORD or \
            max(plan, default=0) >> PLAN_RADIX_BITS:
        raise ValueError(f"_packed_plan: the plan {plan} of n={n} does not "
                         "fit two words")
    words = [0, 0]
    for i, r in enumerate(plan):
        words[i // PLAN_RADICES_A_WORD] |= \
            r << (PLAN_RADIX_BITS * (i % PLAN_RADICES_A_WORD))
    return (len(plan), *words)


def _large_prime(n: int) -> int:
    """The prime factor of n past ``FFT_SMALL_PRIME_MAX`` (n <= 16384 has
    at most one: 131^2 > 16384), or 0."""
    big = [p for p in fft_plan(n) if p > FFT_SMALL_PRIME_MAX]
    return big[-1] if big else 0


def _large_pass_fits(n: int, p: int, rows: int, threads: int) -> bool:
    """Whether a block of ``threads`` holds the large-prime pass of prime p
    over ``rows`` rows of n points: its tiles, ``LARGE_PASS_OUTPUTS`` of
    the Ha = (p - 1) / 2 outputs (rounded up to whole tiles) of one of
    its G = rows n / p groups, one a thread at most, and the groups'
    folded values in Rader's order (2 + 2 Ha each) inside the rows' padded
    shared memory: what csrc/spectrum_fft.cu's any_block_valid checks."""
    q = LARGE_PASS_OUTPUTS
    groups = rows * (n // p)
    half = -(-((p - 1) // 2) // q) * q
    return half // q * groups <= threads and \
        groups * (2 + 2 * half) <= rows * n + rows * n // 16 + 1


@functools.lru_cache(maxsize=None)
def _runtime_block(n: int):
    """(threads, rows a block) of the FFT core's runtime-plan instance for
    n points, or None if no instance holds a row.  A plan with a prime
    past ``FFT_SMALL_PRIME_MAX`` runs on ``FFT_LARGE_BLOCK`` alone, with as
    many rows as its values hold and :func:`_large_pass_fits` admits; any
    other on the first of ``FFT_ANY_BLOCKS`` whose threads hold rows n
    values (rows as many as fit, at least 1) and, for each prime pass
    p > 7 of G = n / p groups a row, the pass's ceil(rows G / 4)
    (p - 1) / 2 items at values / 8 a thread (an item is one output pair
    of four groups)."""
    plan = fft_plan(n)
    large = _large_prime(n)
    for threads, values in (FFT_LARGE_BLOCK,) if large else FFT_ANY_BLOCKS:
        rows = max(1, values * threads // n)
        if rows * n > values * threads:
            continue
        for p in plan:
            if p in FFT_REGISTER_RADICES:
                continue
            if p == large:
                def fits(rows, p=p):
                    return _large_pass_fits(n, p, rows, threads)
            else:
                def fits(rows, p=p):
                    return -(-rows * (n // p) // 4) * ((p - 1) // 2) <= \
                        values // 8 * threads
            while rows > 1 and not fits(rows):
                rows -= 1
            if not fits(rows):
                break
        else:
            return threads, rows
    return None


@functools.lru_cache(maxsize=None)
def k6_route(n: int) -> str:
    """K6's route for n-point rows, from n alone: "fft" (the FFT core) for
    n <= ``FFT_MAX_POINTS`` whose prime factors are all <= ``FFT_MAX_PRIME``
    and, unless n is a power of two >= 128, whose passes a runtime-plan
    block holds (:func:`_runtime_block`): every n <= 128, every 128 m for
    m <= 128, and every prime up to 1021; else "split" (two passes of the
    core) for any n that :func:`k6_split` splits: 128 m for every m <=
    1024, and every other n <= 16384 whose primes are all <= 1021; else
    "chirp" (Bluestein's transform on the core's passes) wherever
    :func:`chirp_length` finds a convolution length: a prime factor past
    1021, and every other n up to 25165824; else "direct" (the full DFT
    product: n past 25165824 that does not split, such as 2^25)."""
    if n <= FFT_MAX_POINTS and \
            _prime_factors(n)[-1:] <= (FFT_MAX_PRIME,) and \
            (n >= 128 and n & (n - 1) == 0 or _runtime_block(n)):
        return "fft"
    if k6_split(n):
        return "split"
    return "chirp" if chirp_length(n) else "direct"


@functools.lru_cache(maxsize=None)
def k6_split(n: int):
    """(n1, n2), n1 <= n2, n1 n2 = n, the most balanced pair of factors
    that the FFT core takes each (``k6_route(n_i) == "fft"``, and no
    power of two past ``SPLIT_MAX_POW2``), or None: K6's split route runs
    n1-point FFTs over the columns, then n2-point FFTs over the rows
    (csrc/spectrum_fft.cu).  65536 = 256 x 256, 32768 = 128 x 256, 16512
    = 128 x 129, 16768 = 128 x 131."""
    def takes(f):
        return k6_route(f) == "fft" and (f & (f - 1) or f <= SPLIT_MAX_POW2)

    for n1 in range(math.isqrt(n), 1, -1):
        n2 = n // n1
        if n1 * n2 == n and n2 <= FFT_MAX_POINTS and takes(n1) and takes(n2):
            return n1, n2
    return None


def chirp_split(M: int):
    """(M1, M2), M1 M2 = M, the factors of K6's chirp route in three
    launches, or None: M1 a power of two from 128 to ``SPLIT_MAX_POW2``
    (passes A and A' on the core's pow2 instances), M2 <=
    ``FFT_MAX_POINTS`` on a runtime-plan block (pass B) and, as the split
    takes it, no power of two past ``SPLIT_MAX_POW2``; of those the pair
    whose larger factor is least, M1 the smaller on a tie.  327680 = 512
    x 640, 655360 = 1024 x 640, 20971520 = 4096 x 5120."""
    best = None
    for bits in range(7, SPLIT_MAX_POW2.bit_length()):
        M1 = 1 << bits
        M2 = M // M1
        if M1 * M2 != M or M2 > FFT_MAX_POINTS or \
                not M2 & (M2 - 1) and M2 > SPLIT_MAX_POW2 or \
                _runtime_block(M2) is None:
            continue
        if best is None or max(M1, M2) < max(best):
            best = M1, M2
    return best


def _chirp_takes(M: int) -> bool:
    """Whether the chirp route's kernels take M-point transforms: every
    prime factor <= ``FFT_SMALL_PRIME_MAX`` (the route's instances hold no
    large-prime pass), and a runtime-plan block a row (M <=
    ``FFT_MAX_POINTS``) or the factors :func:`chirp_split` gives."""
    if _prime_factors(M)[-1:] > (FFT_SMALL_PRIME_MAX,):
        return False
    if M <= FFT_MAX_POINTS:
        return _runtime_block(M) is not None
    return chirp_split(M) is not None


@functools.lru_cache(maxsize=None)
def chirp_length(n: int):
    """The convolution length M >= 2 n - 1 of K6's chirp route for n
    points, or None where the route's kernels take no such M (n past
    25165824: M = 3 2^24 = 4096 x 12288 is the largest).  The smallest
    m 2^a, m in ``CHIRP_LENGTH_ODD``, that :func:`_chirp_takes`: its
    passes are then register radices (16, 8, 4, 2 and one 3 or 5), the
    cheapest the core has, its split's column factor a power of two (the
    core's compiled pow2 instances), and it lies within 4/3 of 2 n - 1
    (2^a, 5 2^(a-2), 3 2^(a-1), 2^(a+1) each within 4/3 of the one
    before), so that the ~32 bytes a point of M that the route moves stay
    near their least (at 8 x 131968 on an H100, 327680 = 512 x 640 ran
    in 0.096 ms, 393216 in 0.113 and 2^19 in 0.148: ``ab_spectrum.py
    --family chirp_length``).  1031 takes 2560."""
    need = 2 * n - 1
    for M in sorted(m << ((need - 1) // m).bit_length()
                    for m in CHIRP_LENGTH_ODD):
        if _chirp_takes(M):
            return M
    return None


def _primitive_root(p: int) -> int:
    """The smallest generator of the multiplicative group mod the prime p."""
    factors = set(_prime_factors(p - 1))
    return next(g for g in range(2, p)
                if all(pow(g, (p - 1) // f, p) != 1 for f in factors))


@functools.lru_cache(maxsize=None)
def _core_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """The table the FFT core's runtime plan takes for n points: the
    n-entry table :func:`_dft_twiddles`, and, for a plan with a prime p
    past ``FFT_SMALL_PRIME_MAX``, its large-prime pass's tables after it
    (csrc/spectrum_fft.cu large_prime_pass), with g the smallest primitive
    root of p: p + 2 ``LARGE_PASS_OUTPUTS`` rows (cos, sin) of
    2 pi g^k / p, entry (g^k mod p) n / p of the n-entry table with its
    sine negated (k past p - 2 wraps: g^(p - 1) = 1), then g^k mod p for
    k < (p - 1) / 2, int32 bits, two to a row.  float32 (rows, 2)."""
    tw = _dft_twiddles(n, device)
    p = _large_prime(n)
    if not p:
        return tw
    g = _primitive_root(p)
    host = tw.cpu().numpy()
    k = np.arange(p + 2 * LARGE_PASS_OUTPUTS)
    cs = host[np.array([pow(g, int(e), p) for e in k]) * (n // p)] \
        * np.float32([1, -1])
    perm = np.array([pow(g, e, p) for e in range((p - 1) // 2)], np.int32)
    perm = np.pad(perm, (0, len(perm) % 2)).view(np.float32).reshape(-1, 2)
    # one copy of the host's bits: the int32 rows are not float arithmetic
    return torch.from_numpy(np.concatenate([host, cs, perm])).to(device)


@functools.lru_cache(maxsize=None)
def _stockham_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """(n - 1, 2) float32: the twiddles of the FFT core's passes in pass
    order, entries of the n-entry table :func:`_dft_twiddles` gathered on
    the host so that a warp's twiddle loads coalesce.  For the pass of
    radix R after radices whose product is Ns, entry r Ns + k - 1 holds
    W_n^(r k n / (Ns R)) = W_(Ns R)^(r k), 0 < r < R, k < Ns; the passes'
    (R - 1) Ns entries sum to n - 1."""
    idx, ns = [], 1
    for R in fft_plan(n):
        r, k = np.arange(1, R), np.arange(ns)
        idx.append((np.outer(r, k) * (n // (ns * R))).reshape(-1))
        ns *= R
    idx = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    return _dft_twiddles(n, device)[torch.from_numpy(idx).to(device)] \
        .contiguous()


def stockham_fft_plain(x: torch.Tensor) -> torch.Tensor:
    """A plain model of the FFT core's passes, for the tests and
    ``chip_smoke.py`` (no wrapper runs it): (..., n) complex -> the forward
    DFT of each row, unnormalized, natural bin order, in x's complex type.
    Pass p of radix R, after radices whose product is Ns, with k = j mod
    Ns: group j < n / R reads x[j + r n / R], multiplies it by entry
    r Ns + k - 1 of the passes' table (:func:`_stockham_twiddles`; 1 for
    r = 0), takes the R-point DFT (entries (r q mod R) n / R of
    :func:`_dft_twiddles`) and writes output q to (j - k) R + k + q Ns: the
    kernel's indices, with the R-point DFT as a product instead of its
    register butterflies.  The float32 tables' values, in complex128
    arithmetic, rounded to x's type at the end: a p-point product summed
    in float32 lands as far from the truth as the kernel's prime passes
    do, and would be no reference for them."""
    n = x.shape[-1]
    dev = x.device
    rows = x.reshape(-1, n).to(torch.complex128)
    tw, ptw = (torch.complex(t[:, 0], t[:, 1]).to(rows.dtype) for t in (
        _dft_twiddles(n, dev), _stockham_twiddles(n, dev)))
    ns = 1
    for R in fft_plan(n):
        G = n // R
        j = torch.arange(G, device=dev)
        k = j % ns
        r = torch.arange(R, device=dev)
        w = torch.ones((R, G), dtype=rows.dtype, device=dev)
        w[1:] = ptw[r[1:, None] * ns + k[None, :] - 1]
        v = rows.reshape(-1, R, G) * w
        y = torch.einsum("brj,rq->bqj", v, tw[(torch.outer(r, r) % R) * G])
        dest = ((j - k) * R + k)[None, :] + (r * ns)[:, None]    # (q, j)
        out = torch.empty_like(rows)
        out[:, dest.reshape(-1)] = y.reshape(rows.shape[0], -1)
        rows, ns = out, ns * R
    return rows.reshape(x.shape).to(x.dtype)


def split_fft_plain(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """A plain model of K6's split route before its epilogue, for the tests
    and ``chip_smoke.py`` (no wrapper runs it): (..., n) complex, n = n1
    n2, -> the forward DFT of each row, natural bin order, in x's complex
    type.  With t = n2 t1 + t2 and k = k1 + n1 k2: :func:`stockham_fft_plain`
    of each column x[n2 t1 + t2] over t1 (pass A), times the float32
    twiddle W_n^(t2 k1) of :func:`_dft_twiddles` (t2 k1 < n), then
    :func:`stockham_fft_plain` of each row Y[k1, :] over t2 (pass B), bin
    k1 + n1 k2 out; in complex128, as :func:`stockham_fft_plain`."""
    n = x.shape[-1]
    if n1 * n2 != n:
        raise ValueError(f"split_fft_plain: {n1} x {n2} is not n={n}")
    rows = x.reshape(-1, n1, n2).to(torch.complex128)
    a = stockham_fft_plain(rows.transpose(1, 2).contiguous())  # [t2, k1]
    tw = _dft_twiddles(n, x.device)
    idx = torch.outer(torch.arange(n2, device=x.device),
                      torch.arange(n1, device=x.device))
    w = torch.complex(tw[idx, 0], tw[idx, 1]).to(rows.dtype)
    y = (a * w).transpose(1, 2).contiguous()                    # [k1, t2]
    z = stockham_fft_plain(y)                                    # [k1, k2]
    return z.transpose(1, 2).reshape(x.shape).to(x.dtype)


def spectrum_split_plain(iq: torch.Tensor, win: torch.Tensor, coeff: float,
                         scale: float, offset: float,
                         split=None) -> torch.Tensor:
    """K6's split route step by step, for the tests and ``chip_smoke.py``:
    the window, :func:`split_fft_plain` over ``split`` = (n1, n2)
    (:func:`k6_split` of n unless given), then K6's epilogue.  The
    wrapper's plain version stays :func:`spectrum_fused_plain`."""
    n1, n2 = split or k6_split(iq.shape[1])
    X = split_fft_plain(torch.complex(iq[..., 0] * win, iq[..., 1] * win),
                        n1, n2)
    return _spectrum_epilogue(_mag2(X.real, X.imag),
                              *_spectrum_scalars(coeff, scale, offset))


def spectrum_fft_plain(iq: torch.Tensor, win: torch.Tensor, coeff: float,
                       scale: float, offset: float) -> torch.Tensor:
    """K6's FFT route step by step, for the tests and ``chip_smoke.py``:
    :func:`stockham_fft_plain` of the windowed float32 rows, then K6's
    epilogue.  The wrapper's plain version stays
    :func:`spectrum_fused_plain`."""
    X = stockham_fft_plain(torch.complex(iq[..., 0] * win, iq[..., 1] * win))
    return _spectrum_epilogue(_mag2(X.real, X.imag),
                              *_spectrum_scalars(coeff, scale, offset))


@functools.lru_cache(maxsize=None)
def _fft_core_launcher(name: str):
    """A C entry point of ``csrc/spectrum_fft.cu``: K3's ("fft_pallas"),
    K6's FFT route ("spectrum_fft"), K6's split route ("spectrum_split")
    or K6's chirp route, in one launch ("spectrum_chirp") or three
    ("spectrum_chirp_split")."""
    fn = getattr(_build.load("spectrum_fft.cu"), f"{name}_launch")
    plan = [ctypes.c_int, ctypes.c_ulonglong, ctypes.c_ulonglong]
    block = plan + [ctypes.c_int] * 2     # ... and its runtime-plan block
    tail = [ctypes.c_float] * 3 + [ctypes.c_void_p]
    if name == "fft_pallas":
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + plan + \
            [ctypes.c_void_p]
    elif name == "spectrum_fft":
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + block + \
            tail
    elif name == "spectrum_split":
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + \
            block * 2 + tail
    elif name == "spectrum_chirp":
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + block + \
            tail
    else:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + \
            plan + block + tail
    fn.restype = ctypes.c_int
    return fn


def _core_block(n: int) -> tuple:
    """The FFT core's runtime-plan block (threads, rows) for n points, or
    (0, 0) for a power of two >= 128 (its own instance)."""
    return _runtime_block(n) if n < 128 or n & (n - 1) else (0, 0)


@functools.lru_cache(maxsize=None)
def _split_tables(n1: int, n2: int, device: torch.device) -> tuple:
    """The split route's float32 tables for n = n1 n2: each factor's
    passes' table and runtime-plan table (:func:`_stockham_twiddles`,
    :func:`_core_twiddles`), and (n1, n2, 2) W_n^(t2 k1) at [k1, t2], the
    n-entry table's entries gathered on the host so that pass A's loads
    coalesce (t2 k1 < n)."""
    idx = torch.outer(torch.arange(n1), torch.arange(n2)).to(device)
    return (_stockham_twiddles(n1, device), _core_twiddles(n1, device),
            _stockham_twiddles(n2, device), _core_twiddles(n2, device),
            _dft_twiddles(n1 * n2, device)[idx].contiguous())


def _chirp_phase(n: int) -> np.ndarray:
    """pi t^2 / n for t < n in float64, from t^2 mod 2 n in int64 (t^2
    overflows int32 from t = 46341, and a float32 t^2 loses the phase's
    low bits: K6's 1e-4 fails near n = 16384)."""
    t = np.arange(n, dtype=np.int64)
    return np.pi * ((t * t) % (2 * n)) / n


@functools.lru_cache(maxsize=None)
def _chirp_table(n: int, device: torch.device) -> torch.Tensor:
    """(n, 2) float32 [cos, -sin] of :func:`_chirp_phase`: the chirp c_t =
    exp(-j pi t^2 / n), t < n, rounded once to float32."""
    ang = _chirp_phase(n)
    tab = np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tab).to(device)


@functools.lru_cache(maxsize=None)
def _chirp_spectrum(n: int, M: int, device: torch.device) -> torch.Tensor:
    """(M, 2) float32, the chirp route's pointwise factor D = conj(C) / M,
    C the M-point DFT of conj(c_t) for |t| < n wrapped mod M: in
    complex128 on the host from :func:`_chirp_phase`, rounded once to
    complex64.  For M past ``FFT_MAX_POINTS`` in the split's layout, bin
    k1 + M1 k2 at k1 M2 + k2 ((M1, M2) = :func:`chirp_split` of M), so
    that pass B reads a row's bins in its own order."""
    b = np.zeros(M, np.complex128)
    b[:n] = np.exp(1j * _chirp_phase(n))
    b[M - n + 1:] = b[1:n][::-1]
    d = np.conj(np.fft.fft(b)) / M
    if M > FFT_MAX_POINTS:
        M1, M2 = chirp_split(M)
        d = d.reshape(M2, M1).T
    d = np.ascontiguousarray(d).astype(np.complex64)
    return torch.from_numpy(d.view(np.float32).reshape(M, 2)).to(device)


def _table_complex(tab: torch.Tensor) -> torch.Tensor:
    """A float32 (.., 2) table's values as complex128."""
    return torch.complex(tab[..., 0], tab[..., 1]).to(torch.complex128)


def _chirp_steps(x: torch.Tensor, M: int) -> torch.Tensor:
    """The chirp route's steps before |.|^2, in complex128 on the float32
    tables: a = x c (zeros from n to M), the forward transform over M (one
    row: :func:`stockham_fft_plain`; past ``FFT_MAX_POINTS`` the split's
    passes, :func:`split_fft_plain` over :func:`chirp_split`'s (M1, M2)),
    Z = conj(A) D, then
    the forward transform of Z (the split's passes in the other order,
    (M2, M1), as the kernel runs them on the [k1, k2] layout).  Returns
    W (rows, M); W[k] = conj(X[k] / c_k) for k < n."""
    n = x.shape[-1]
    dev = x.device
    rows = x.reshape(-1, n).to(torch.complex128)
    a = torch.zeros((rows.shape[0], M), dtype=rows.dtype, device=dev)
    a[:, :n] = rows * _table_complex(_chirp_table(n, dev))
    d = _table_complex(_chirp_spectrum(n, M, dev))
    if M <= FFT_MAX_POINTS:
        return stockham_fft_plain(stockham_fft_plain(a).conj() * d)
    M1, M2 = chirp_split(M)
    d = d.reshape(M1, M2).T.reshape(M)                  # natural bin order
    return split_fft_plain(split_fft_plain(a, M1, M2).conj() * d, M2, M1)


def chirp_fft_plain(x: torch.Tensor, M=None) -> torch.Tensor:
    """A plain model of K6's chirp route before its epilogue, for the
    tests and ``chip_smoke.py`` (no wrapper runs it): (..., n) complex ->
    the forward DFT of each row, natural bin order, in x's complex type,
    by Bluestein's transform over M (:func:`chirp_length` of n unless
    given): with c_t = exp(-j pi t^2 / n),
    X[k] = c_k sum_t (x_t c_t) conj(c_(k-t)), a convolution of length M
    taken with two M-point transforms (:func:`_chirp_steps`), then the
    final chirp, X[k] = c_k conj(W[k]), which the kernel does not apply:
    |c_k| = 1, so |X[k]|^2 = |W[k]|^2."""
    n = x.shape[-1]
    W = _chirp_steps(x, M or chirp_length(n))[:, :n]
    X = _table_complex(_chirp_table(n, x.device)) * W.conj()
    return X.reshape(x.shape).to(x.dtype)


def spectrum_chirp_plain(iq: torch.Tensor, win: torch.Tensor, coeff: float,
                         scale: float, offset: float) -> torch.Tensor:
    """K6's chirp route step by step, for the tests and ``chip_smoke.py``:
    the window, :func:`_chirp_steps` over :func:`chirp_length` of n, |W|^2
    of the first n bins, then K6's epilogue.  The wrapper's plain version
    stays :func:`spectrum_fused_plain`."""
    n = iq.shape[1]
    W = _chirp_steps(torch.complex(iq[..., 0] * win, iq[..., 1] * win),
                     chirp_length(n))[:, :n].to(torch.complex64)
    return _spectrum_epilogue(_mag2(W.real, W.imag),
                              *_spectrum_scalars(coeff, scale, offset))


# ---------------------------------------------------------------------------
# Fused spectrum for any n: the FFT core, two passes of it, or one full DFT
# product (K6)


def spectrum_fused_plain(iq: torch.Tensor, win: torch.Tensor, coeff: float,
                         scale: float, offset: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`spectrum_fused`: the float32
    windowed rows times the DFT matrix from the kernel's float32 table,
    summed in float64 (:func:`dft_products`) and rounded to float32,
    then the epilogue.

    Why float64 sums: near the tone's mirror bin the four real products
    each grow to about |X| of the tone and cancel, so at a deep null of
    the display a float32 matrix product lands several times farther
    from the truth than the kernel's blocked complex sums do: a float32
    reference would be the worse of the two.  float64 also leaves the
    global TF32 switches without effect."""
    yr, yi = (v.float() for v in dft_products(
        iq[..., 0] * win, iq[..., 1] * win, dtype=torch.float64))
    return _spectrum_epilogue(yr * yr + yi * yi,
                              *_spectrum_scalars(coeff, scale, offset))


@functools.lru_cache(maxsize=None)
def _k6_launcher():
    fn = _build.load("spectrum_dft.cu").spectrum_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
        [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spectrum_fused(iq: torch.Tensor, win: torch.Tensor, coeff: float,
                   scale: float, offset: float) -> torch.Tensor:
    """The contract of :func:`spectrum_fused_ct5` for any B >= 1 and any
    n >= 1, the full n-point DFT X[k] = sum_t win[t] x[t] W_n^(t k): on
    the card by the route :func:`k6_route` picks from n, the FFT core, its
    two passes over the split :func:`k6_split` gives (through a (B, n)
    complex64 scratch), Bluestein's transform over the length
    :func:`chirp_length` gives on the core's passes (one launch a row up
    to ``FFT_MAX_POINTS`` points, else three through a (B, M) complex64
    scratch), or the direct product.  ``spectrum_fused.routes``
    counts the calls by route; a call counts one launch, the split and
    chirp routes' kernels included."""
    _check_spectrum(iq, win, lambda n: "")
    if iq.device.type == "cpu":
        return spectrum_fused_plain(iq, win, coeff, scale, offset)
    if iq.device.type != "cuda":
        raise ValueError(f"spectrum_fused: unsupported device {iq.device}")
    B, n, _ = iq.shape
    route = k6_route(n)
    # the n-entry table, and on the FFT route the large-prime pass's tables
    # after it (the split and chirp routes' tables are cached apart)
    tw = None if route in ("split", "chirp") else (
        _core_twiddles if route == "fft" else _dft_twiddles)(n, iq.device)
    out = torch.empty((B, n), dtype=torch.float32, device=iq.device)
    scalars = _spectrum_scalars(coeff, scale, offset)
    # iq is read as float2
    if route == "fft":
        _launch("spectrum_fused", {"iq": iq, "win": win}, ("iq", iq, 8),
                _fft_core_launcher("spectrum_fft"), iq.data_ptr(),
                win.data_ptr(), _stockham_twiddles(n, iq.device).data_ptr(),
                tw.data_ptr(), out.data_ptr(), B, n, *_packed_plan(n),
                *_core_block(n), *scalars)
    elif route == "split":
        n1, n2 = k6_split(n)
        y = torch.empty((B, n), dtype=torch.complex64, device=iq.device)
        _launch("spectrum_fused", {"iq": iq, "win": win}, ("iq", iq, 8),
                _fft_core_launcher("spectrum_split"), iq.data_ptr(),
                win.data_ptr(), *(t.data_ptr() for t in _split_tables(
                    n1, n2, iq.device)), y.data_ptr(), out.data_ptr(), B, n1,
                n2, *_packed_plan(n1), *_core_block(n1), *_packed_plan(n2),
                *_core_block(n2), *scalars)
    elif route == "chirp":
        M = chirp_length(n)
        chirp = (_chirp_table(n, iq.device), _chirp_spectrum(n, M, iq.device))
        if M <= FFT_MAX_POINTS:
            _launch("spectrum_fused", {"iq": iq, "win": win}, ("iq", iq, 8),
                    _fft_core_launcher("spectrum_chirp"), iq.data_ptr(),
                    win.data_ptr(), *(t.data_ptr() for t in chirp),
                    _stockham_twiddles(M, iq.device).data_ptr(),
                    _core_twiddles(M, iq.device).data_ptr(), out.data_ptr(),
                    B, n, M, *_packed_plan(M), *_runtime_block(M), *scalars)
        else:
            M1, M2 = chirp_split(M)
            y = torch.empty((B, M), dtype=torch.complex64, device=iq.device)
            _launch("spectrum_fused", {"iq": iq, "win": win}, ("iq", iq, 8),
                    _fft_core_launcher("spectrum_chirp_split"), iq.data_ptr(),
                    win.data_ptr(), *(t.data_ptr() for t in chirp),
                    *(t.data_ptr() for t in _split_tables(M1, M2, iq.device)),
                    y.data_ptr(), out.data_ptr(), B, n, M1, M2,
                    *_packed_plan(M1), *_packed_plan(M2),
                    *_runtime_block(M2), *scalars)
    else:
        _launch("spectrum_fused", {"iq": iq, "win": win}, ("iq", iq, 8),
                _k6_launcher(), iq.data_ptr(), win.data_ptr(),
                tw.data_ptr(), out.data_ptr(), B, n, *scalars)
    spectrum_fused.launches += 1
    spectrum_fused.routes[route] += 1
    return out


spectrum_fused.launches = 0
spectrum_fused.routes = dict.fromkeys(K6_ROUTES, 0)


# ---------------------------------------------------------------------------
# Forward C2C FFT of complex64 rows (K3, exact and display tiers)


def _check_k3(x: torch.Tensor) -> None:
    if x.dtype != torch.complex64 or x.dim() < 1:
        raise ValueError(f"fft_pallas: x must be complex64 (..., n); got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("fft_pallas: x must hold at least one row")
    # a lazily conjugated tensor's memory holds x, not conj(x): a kernel
    # reading it by pointer would transform the wrong signal
    if x.is_conj():
        raise ValueError("fft_pallas: x has the conjugate bit set; pass "
                         "torch.conj_physical(x) or x.resolve_conj()")
    problem = k2_cuda_unsupported(x.shape[-1])
    if problem:
        raise ValueError(f"fft_pallas: {problem}")


def fft_pallas_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fft_pallas`: the load at
    bit-reversed positions, then log2 n radix-2 passes with twiddles from
    the float32 table (:func:`_radix2_passes`).  The kernel runs the
    Stockham core's passes instead (:func:`stockham_fft_plain` models
    them); the two are held together at 1e-5 of max|X|, a bar that does
    not depend on the order of the passes."""
    n = x.shape[-1]
    xb = x.reshape(-1, n)
    rev = _bit_reversal(n, x.device)
    re, im = _radix2_passes(xb.real[:, rev], xb.imag[:, rev],
                            _k2_twiddles(n, x.device))
    return torch.complex(re, im).reshape(x.shape)


def fft_pallas(x: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """(..., n) complex64 -> (..., n) complex64: the forward FFT of each
    row on the last axis, X[k] = sum_t x[t] exp(-2 pi j t k / n),
    unnormalized, in natural bin order.  n = 128 m, m a power of two
    <= 32; leading dims are flattened into rows.  ``x`` must be
    contiguous and must not carry the conjugate bit.  ``exact=False`` is
    the JAX package's display tier (one default-precision matrix pass on
    the TPU); the same fp32 kernel, which meets the exact tier, serves
    it, so both tiers give the same bits."""
    _check_k3(x)
    if x.device.type == "cpu":
        return fft_pallas_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"fft_pallas: unsupported device {x.device}")
    n = x.shape[-1]
    B = x.numel() // n
    ptw = _stockham_twiddles(n, x.device)
    out = torch.empty(x.shape, dtype=torch.complex64, device=x.device)
    # x is read as float2
    _launch("fft_pallas", {"x": x}, ("x", x, 8),
            _fft_core_launcher("fft_pallas"),
            x.data_ptr(), ptw.data_ptr(), out.data_ptr(), B, n,
            *_packed_plan(n))
    fft_pallas.launches += 1
    return out


fft_pallas.launches = 0
