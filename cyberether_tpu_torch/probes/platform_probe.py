"""Platform probe: the dispatch floor, the copy rate and the rates of the
channelizer DFT's tile product on this card, through the hand-written
kernels K13 (``scale_copy``) and K15 (``tile_dot``) beside PyTorch's own
calls, and the library's peak matrix rates.

The counterpart of the JAX package's ``tools/ablation/platform_probe.py``
(and of ``f16_probe.py``, a line of it here): each of its lines, with the
Pallas kernels replaced by K13 and K15 and XLA by PyTorch.

    python -m cyberether_tpu_torch.probes.platform_probe

prints one line per measurement, then the whole as one JSON line.
"""

from __future__ import annotations

import contextlib
import json
import sys
from typing import Dict, Iterable

import numpy as np
import torch

from cyberether_tpu_torch.ops.probe_kernels import TILE_DOT_MODES, \
    scale_copy, tile_dot
from cyberether_tpu_torch.probes.common import ROWS, WIDTH, card, \
    chain_ms, chained, dispatch, rate, require_card

# rows a block of K13 walks; 2048 is the TPU probe's tile
ROWS_PER_BLOCK = (4, 16, 64, 2048)
# rows a block of K15 walks with b held in shared memory
DOT_ROWS_PER_BLOCK = (128, 512, 2048)
PEAK_N, PEAK_CHAIN = 4096, 8          # the library peaks: 8 products of n^3


@contextlib.contextmanager
def tf32(allow: bool):
    """torch.matmul's float32 products in TF32 or not, restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def library_product(x: torch.Tensor, b: torch.Tensor):
    """One PyTorch call computing x @ b with float32 out, K15's function,
    and the call's name: ``torch.matmul`` for float32 inputs,
    ``torch.mm(..., out_dtype=torch.float32)`` for bfloat16 and half."""
    if x.dtype == torch.float32:
        return (lambda: torch.matmul(x, b)), "torch.matmul"
    return (lambda: torch.mm(x, b, out_dtype=torch.float32)), \
        "torch.mm(out_dtype=float32)"


def _product_bytes(rows: int, dtype: torch.dtype) -> int:
    """x and b read once, the float32 product written once."""
    return (rows * WIDTH + WIDTH * WIDTH) * dtype.itemsize + rows * WIDTH * 4


def measure(device: "str | torch.device" = "cuda") -> Dict[str, object]:
    """Every line of the platform probe, on the card ``device``."""
    dev = require_card(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    out: Dict[str, object] = {"card": card(dev)}

    tiny = torch.ones((8, WIDTH), device=dev)
    out["dispatch"] = [
        {"what": "scale_copy (8, 128)", **dispatch(lambda: scale_copy(tiny))},
        {"what": "torch x + 1 (8, 128)", **dispatch(lambda: tiny + 1.0)}]

    x = torch.randn((ROWS, WIDTH), device=dev, generator=gen)
    moved = 2 * x.numel() * 4
    streaming = []
    for rpb in ROWS_PER_BLOCK:
        ms = chain_ms(chained(lambda y, r=rpb: scale_copy(y, 2.0, r), x))
        streaming.append({"what": f"scale_copy s=2 rows_per_block={rpb}",
                          "kernel": "scale_copy", "ms": ms,
                          "GB/s": rate(moved, ms)})
    ms = chain_ms(chained(lambda y: y * 2.0, x))
    streaming.append({"what": "torch x * 2", "ms": ms,
                      "GB/s": rate(moved, ms)})
    ms = chain_ms(lambda: x.sum(0))
    streaming.append({"what": "torch x.sum(0) (read only)", "ms": ms,
                      "GB/s": rate(x.numel() * 4, ms)})
    out["streaming"] = streaming

    b = torch.randn((WIDTH, WIDTH), device=dev, generator=gen)
    flops = 2 * ROWS * WIDTH * WIDTH
    products = []
    for mode, (_, dtype) in TILE_DOT_MODES.items():
        xm, bm = x.to(dtype), b.to(dtype)
        nbytes = _product_bytes(ROWS, dtype)
        for rpb in DOT_ROWS_PER_BLOCK:
            ms = chain_ms(lambda: tile_dot(xm, bm, mode, rpb))
            products.append({"what": f"tile_dot {mode} rows_per_block={rpb}",
                             "kernel": "tile_dot", "mode": mode, "ms": ms,
                             "TFLOP/s": flops / ms / 1e9,
                             "GB/s": rate(nbytes, ms)})
    for mode, dtype, allow in (("fp32", torch.float32, False),
                               ("tf32", torch.float32, True),
                               ("bf16", torch.bfloat16, False),
                               ("f16", torch.float16, False)):
        xm, bm = x.to(dtype), b.to(dtype)
        with tf32(allow):
            call, name = library_product(xm, bm)
            ms = chain_ms(call)
        products.append({"what": f"{name} {mode}", "mode": mode,
                         "allow_tf32": allow, "ms": ms,
                         "TFLOP/s": flops / ms / 1e9,
                         "GB/s": rate(_product_bytes(ROWS, dtype), ms)})
    out["products"] = products
    del x, xm

    # f16_probe: does the f16 product work, and how far from float64
    rng = np.random.default_rng(0)
    a16 = torch.from_numpy(rng.standard_normal((256, 128)).astype(
        np.float16)).to(dev)
    b16 = torch.from_numpy(rng.standard_normal((128, 128)).astype(
        np.float16)).to(dev)
    got = tile_dot(a16, b16, "f16")
    ref = a16.double() @ b16.double()
    out["f16_probe"] = {
        "what": "tile_dot f16 (256, 128) @ (128, 128)",
        "rel_err_vs_f64": float((got.double() - ref).abs().max()
                                / ref.abs().max()),
        "ms": chain_ms(lambda: tile_dot(a16, b16, "f16"))}

    peaks = []
    for mode, dtype, allow in (("fp32", torch.float32, False),
                               ("tf32", torch.float32, True),
                               ("bf16", torch.bfloat16, False),
                               ("f16", torch.float16, False)):
        a = (torch.randn((PEAK_N, PEAK_N), device=dev, generator=gen)
             * 0.01).to(dtype)
        w = (torch.randn((PEAK_N, PEAK_N), device=dev, generator=gen)
             * 0.01).to(dtype)

        def chain(a=a, w=w):
            y = a
            for _ in range(PEAK_CHAIN):
                y = torch.matmul(y, w)
            return y

        with tf32(allow):
            ms = chain_ms(chain, k=5, reps=3)
        peaks.append({"what": f"torch.matmul chain x{PEAK_CHAIN} "
                              f"[{mode} {PEAK_N}]", "mode": mode,
                      "allow_tf32": allow, "ms": ms,
                      "TFLOP/s": PEAK_CHAIN * 2 * PEAK_N ** 3 / ms / 1e9})
    out["peaks"] = peaks
    return out


def lines(result: Dict[str, object]) -> Iterable[str]:
    """The result as the JAX probe prints it: one line a measurement."""
    c = result["card"]
    yield f"card: {c['name']}, power limit {c['power_limit']}"
    for d in result["dispatch"]:
        yield (f"dispatch floor {d['what']}: host {d['host_us']:.2f} us, "
               f"{d['event_ms']:.4f} ms a call by CUDA events")
    for s in result["streaming"]:
        yield f"{s['what']}: {s['ms']:.4f} ms = {s['GB/s']:.0f} GB/s"
    for p in result["products"]:
        tf = f", allow_tf32={p['allow_tf32']}" if "allow_tf32" in p else ""
        yield (f"{p['what']}{tf}: {p['ms']:.4f} ms = {p['TFLOP/s']:.1f} "
               f"TFLOP/s = {p['GB/s']:.0f} GB/s")
    f = result["f16_probe"]
    yield (f"{f['what']}: rel err vs f64 {f['rel_err_vs_f64']:.3e}, "
           f"{f['ms']:.4f} ms")
    for p in result["peaks"]:
        yield (f"{p['what']}, allow_tf32={p['allow_tf32']}: {p['ms']:.2f} "
               f"ms = {p['TFLOP/s']:.1f} TFLOP/s")


def main() -> int:
    result = measure()
    for line in lines(result):
        print(line, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
