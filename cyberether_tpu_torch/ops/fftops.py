"""FFT with pocketfft-compatible conventions.

Port of ``cyberether_tpu/ops/fftops.py``.  The reference's FFT module is
unnormalized in BOTH directions and has three paths:

- C2C forward/backward (CF32);
- R2C (F32 -> CF32, n/2+1 bins) when ``complexOutput``;
- R2R in FFTPACK halfcomplex packing otherwise (pocketfft
  ``r2r_fftpack``: [r0, r1, i1, r2, i2, ...]).

The JAX package leaves these transforms to XLA; here they are
``torch.fft`` calls (the ``generic`` provider of the ``fft`` block).
"""

from __future__ import annotations

import torch


def fft_c2c(x: torch.Tensor, axis: int, forward: bool) -> torch.Tensor:
    if forward:
        return torch.fft.fft(x, dim=axis).to(x.dtype)
    # norm="forward" leaves the backward transform unscaled: n * ifft
    return torch.fft.ifft(x, dim=axis, norm="forward").to(x.dtype)


def fft_r2c(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.fft.rfft(x, dim=axis).to(torch.complex64)


def _pack_fftpack(spec: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """rfft output (n//2+1 complex bins) -> FFTPACK real packing of length
    n: [r0, r1, i1, r2, i2, ...(, r_{n/2} if n is even)]."""
    spec = torch.movedim(spec, axis, -1)
    r, im = spec.real, spec.imag
    nb = spec.shape[-1]
    inter = torch.stack([r[..., 1:], im[..., 1:]], dim=-1)
    inter = inter.reshape(inter.shape[:-2] + (2 * (nb - 1),))
    packed = torch.cat([r[..., :1], inter], dim=-1)[..., :n]
    return torch.movedim(packed, -1, axis)


def _unpack_fftpack(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """FFTPACK real packing -> complex rfft-format bins (n//2+1)."""
    p = torch.movedim(packed, axis, -1)
    n = p.shape[-1]
    nb = n // 2 + 1
    r0 = p[..., :1]
    zero = torch.zeros_like(r0)
    if n % 2 == 0:
        body = p[..., 1:-1].reshape(p.shape[:-1] + (nb - 2, 2))
        rn = p[..., -1:]
        real = torch.cat([r0, body[..., 0], rn], dim=-1)
        imag = torch.cat([zero, body[..., 1], zero], dim=-1)
    else:
        body = p[..., 1:].reshape(p.shape[:-1] + (nb - 1, 2))
        real = torch.cat([r0, body[..., 0]], dim=-1)
        imag = torch.cat([zero, body[..., 1]], dim=-1)
    return torch.movedim(torch.complex(real, imag), -1, axis)


def fft_r2r_fftpack(x: torch.Tensor, axis: int, forward: bool
                    ) -> torch.Tensor:
    """pocketfft ``r2r_fftpack``, unnormalized both ways."""
    n = x.shape[axis]
    if forward:
        spec = torch.fft.rfft(x, dim=axis)
        return _pack_fftpack(spec, n, axis).to(x.dtype)
    spec = _unpack_fftpack(x, axis)
    return torch.fft.irfft(spec, n=n, dim=axis, norm="forward").to(x.dtype)
