"""Hand-written CUDA kernels of the card-floor probes, their wrappers, and
the plain PyTorch version of each.

Port of the Pallas kernels of the JAX package's probes
(``tools/ablation/``), which measure what the card gives rather than
serve a user path:

- ``scale_copy`` (K13): o = s x over (rows, 128) float32, 16-byte loads,
  ``rows_per_block`` rows a block as the counterpart of the TPU tile
  (``csrc/platform_probe.cu``; replaces ``platform_probe.k_copy``, s = 2,
  and ``stream_probe.copy_kernel``, s = 1).
- ``tile_dot`` (K15): o = x @ b, x (rows, 128), b (128, 128) held in
  shared memory, float32 out, in five modes: "fp32" (FFMA), "tf32",
  "3xtf32", "bf16" and "f16" (``wgmma``); x's tiles arrive by TMA, so x
  must start on a 16-byte boundary; the same source (replaces
  ``platform_probe.k_dot`` and ``f16_probe.kern``).
- ``staged_copy`` (K14): o = x through a ring of shared-memory stages of
  ``stage_bytes``, filled and drained by TMA bulk copies
  (``csrc/stream_probe.cu``; replaces ``stream_probe.manual_kernel``).

The probes (``cyberether_tpu_torch.probes``) and ``chip_smoke.py`` call
these wrappers; nothing declares the C entry points' arguments again.  A
wrapper given CPU tensors computes its kernel's plain version; given
CUDA tensors it launches the kernel or raises.  Each wrapper counts its
launches in ``wrapper.launches``; ``tile_dot`` by mode, a dict whose sum
is its count.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cyberether_tpu_torch.ops import _build
from cyberether_tpu_torch.ops.kernels import _check_same_device, _launch

WIDTH = 128                      # the probes' row width, and tile_dot's K
K13_ROWS_PER_BLOCK = 16
K14_STAGE_BYTES = 16384
# a ring of two stages must fit the 227 KB of shared memory a block may
# use
K14_MAX_STAGE_BYTES = 113 * 1024
K15_TILE_ROWS = 64               # rows_per_block is a multiple of this
K15_ROWS_PER_BLOCK = 512
# mode -> (C mode number, input dtype)
TILE_DOT_MODES = {
    "fp32": (0, torch.float32),
    "tf32": (1, torch.float32),
    "3xtf32": (2, torch.float32),
    "bf16": (3, torch.bfloat16),
    "f16": (4, torch.float16),
}

_VP, _INT, _LL, _FLT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
# each C entry point: its source and its arguments
_ENTRY_POINTS = {
    "scale_copy_launch": ("platform_probe.cu",
                          [_VP, _VP, _LL, _INT, _FLT, _VP]),
    "tile_dot_launch": ("platform_probe.cu",
                        [_VP, _VP, _VP, _LL, _INT, _INT, _VP]),
    "staged_copy_launch": ("stream_probe.cu", [_VP, _VP, _LL, _INT, _VP]),
}


@functools.lru_cache(maxsize=None)
def _launcher(symbol: str):
    source, argtypes = _ENTRY_POINTS[symbol]
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_rows(name: str, what: str, x: torch.Tensor,
                dtype: torch.dtype) -> None:
    if x.dim() != 2 or x.shape[1] != WIDTH or x.shape[0] < 1 or \
            x.dtype != dtype:
        raise ValueError(f"{name}: {what} must be {dtype} (rows >= 1, "
                         f"{WIDTH}); got {x.dtype} {tuple(x.shape)}")


def _on_card(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


# ---------------------------------------------------------------------------
# K13: o = s x


def scale_copy_plain(x: torch.Tensor, s: float = 2.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`scale_copy`: s x in float32."""
    return x * float(np.float32(s))


def scale_copy(x: torch.Tensor, s: float = 2.0,
               rows_per_block: int = K13_ROWS_PER_BLOCK) -> torch.Tensor:
    """o = s x over x (rows, 128) float32, in float32 (s = 1: a copy bit
    for bit).  ``rows_per_block``: the rows a block of the kernel walks,
    the counterpart of the TPU probe's tile."""
    _check_rows("scale_copy", "x", x, torch.float32)
    if rows_per_block < 1:
        raise ValueError(f"scale_copy: rows_per_block must be >= 1; got "
                         f"{rows_per_block}")
    if x.device.type == "cpu":
        return scale_copy_plain(x, s)
    _on_card("scale_copy", x)
    out = torch.empty_like(x)
    _launch("scale_copy", {"x": x}, ("x", x, 16),
            _launcher("scale_copy_launch"), x.data_ptr(), out.data_ptr(),
            x.shape[0], rows_per_block, float(np.float32(s)))
    scale_copy.launches += 1
    return out


scale_copy.launches = 0


# ---------------------------------------------------------------------------
# K14: o = x through a ring of shared-memory stages


def staged_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`staged_copy`."""
    return x.clone()


def staged_copy(x: torch.Tensor,
                stage_bytes: int = K14_STAGE_BYTES) -> torch.Tensor:
    """o = x, bit for bit, over x (rows, 128) float32: each block of the
    kernel streams its chunks of ``stage_bytes`` (a multiple of 16, the
    counterpart of the TPU probe's chunk) through a ring of shared-memory
    stages by TMA bulk copies, refilling a stage only after its store has
    read it out."""
    _check_rows("staged_copy", "x", x, torch.float32)
    if stage_bytes < 16 or stage_bytes % 16 or \
            stage_bytes > K14_MAX_STAGE_BYTES:
        raise ValueError("staged_copy: stage_bytes must be a multiple of 16 "
                         f"in [16, {K14_MAX_STAGE_BYTES}]; got {stage_bytes}")
    if x.device.type == "cpu":
        return staged_copy_plain(x)
    _on_card("staged_copy", x)
    out = torch.empty_like(x)
    _launch("staged_copy", {"x": x}, ("x", x, 16),
            _launcher("staged_copy_launch"), x.data_ptr(), out.data_ptr(),
            x.numel() // 4, stage_bytes)
    staged_copy.launches += 1
    return out


staged_copy.launches = 0


# ---------------------------------------------------------------------------
# K15: o = x @ b, b (128, 128) held on chip


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 as ``cvt.rna.tf32.f32`` rounds them:
    to 10 mantissa bits, to nearest, ties away from zero (half an ulp
    added to the magnitude bits, then the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tile_dot_plain(x: torch.Tensor, b: torch.Tensor,
                   mode: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of :func:`tile_dot`, each mode its own
    function, summed in float64 and rounded to float32: "fp32", "bf16"
    and "f16" the product of the inputs as given; "tf32" of the inputs
    rounded to TF32; "3xtf32" hi(x) hi(b) + hi(x) lo(b) + lo(x) hi(b) with
    hi = tf32(v) and lo = tf32(v - hi)."""
    if mode not in TILE_DOT_MODES:
        raise ValueError(f"mode must be one of {tuple(TILE_DOT_MODES)}; got "
                         f"{mode!r}")
    if mode in ("tf32", "3xtf32"):
        xh, bh = tf32_round(x), tf32_round(b)
        out = xh.double() @ bh.double()
        if mode == "3xtf32":
            xl, bl = tf32_round(x - xh), tf32_round(b - bh)
            out = out + xh.double() @ bl.double() + xl.double() @ bh.double()
    else:
        out = x.double() @ b.double()
    return out.float()


def tile_dot(x: torch.Tensor, b: torch.Tensor, mode: str = "fp32",
             rows_per_block: int = K15_ROWS_PER_BLOCK) -> torch.Tensor:
    """o = x @ b, x (rows, 128) and b (128, 128) in the mode's input type
    (float32 for "fp32", "tf32" and "3xtf32", bfloat16 for "bf16", half
    for "f16"), o float32.  ``rows_per_block``, a multiple of 64: the rows
    a block of the kernel walks with b held in its shared memory, the
    counterpart of the TPU probe's tile."""
    if mode not in TILE_DOT_MODES:
        raise ValueError(f"mode must be one of {tuple(TILE_DOT_MODES)}; got "
                         f"{mode!r}")
    number, dtype = TILE_DOT_MODES[mode]
    _check_rows("tile_dot", "x", x, dtype)
    if tuple(b.shape) != (WIDTH, WIDTH) or b.dtype != dtype:
        raise ValueError(f"tile_dot: b must be {dtype} ({WIDTH}, {WIDTH}); "
                         f"got {b.dtype} {tuple(b.shape)}")
    if rows_per_block < K15_TILE_ROWS or rows_per_block % K15_TILE_ROWS:
        raise ValueError(f"tile_dot: rows_per_block must be a multiple of "
                         f"{K15_TILE_ROWS}; got {rows_per_block}")
    _check_same_device(x=x, b=b)
    if x.device.type == "cpu":
        return tile_dot_plain(x, b, mode)
    _on_card("tile_dot", x)
    out = torch.empty((x.shape[0], WIDTH), dtype=torch.float32,
                      device=x.device)
    # x is read by TMA: a 16-byte aligned start
    _launch("tile_dot", {"x": x, "b": b}, ("x", x, 16),
            _launcher("tile_dot_launch"), x.data_ptr(), b.data_ptr(),
            out.data_ptr(), x.shape[0], rows_per_block, number)
    tile_dot.launches[mode] += 1
    return out


tile_dot.launches = dict.fromkeys(TILE_DOT_MODES, 0)


def zero_counts() -> None:
    """Set every wrapper's launch counts to 0."""
    scale_copy.launches = staged_copy.launches = 0
    tile_dot.launches = dict.fromkeys(TILE_DOT_MODES, 0)
