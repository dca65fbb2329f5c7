"""FIR design and streaming FIR filtering, in plain torch ops.

Port of ``cyberether_tpu/ops/firs.py`` (XLA code in the JAX package):

- ``windowed_sinc_bandpass``: windowed-sinc band-pass taps with a
  Blackman window and complex upconversion, in double precision (numpy,
  bit-identical to the JAX package's);
- three causal streaming FIRs with the same ``(y, new_history)``
  contract: ``fir_filter_streaming`` (a valid convolution over
  ``[history | block]``), ``fir_matmul_streaming`` (a banded matrix
  product per frame of samples) and ``fir_fft_streaming`` (overlap-save
  in the frequency domain).

Everything runs in float32 on the CPU or the card; matrix products use
no TF32 unless the caller turned it on.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def windowed_sinc_bandpass(taps: int, sample_rate: float, bandwidth: float,
                           centers) -> np.ndarray:
    """Complex band-pass taps, shape (heads, taps), dtype complex64."""
    centers = np.atleast_1d(np.asarray(centers, dtype=np.float64))
    filter_width = (bandwidth / sample_rate) / 2.0
    i = np.arange(taps, dtype=np.float64)
    half_len = (taps - 1) / 2.0
    n = i - half_len
    sinc = np.where(
        n == 0.0,
        2.0 * filter_width,
        np.sin(2.0 * np.pi * filter_width * n) / (np.pi * np.where(n == 0.0,
                                                                   1.0, n)))
    if taps == 1:
        win = np.ones_like(i)
    else:
        win = (0.42 - 0.50 * np.cos(2.0 * np.pi * i / (taps - 1))
               + 0.08 * np.cos(4.0 * np.pi * i / (taps - 1)))
    offsets = centers[:, None] / sample_rate                  # (H, 1)
    upconvert = np.exp(1j * 2.0 * np.pi * n[None, :] * offsets)
    return (sinc[None, :] * win[None, :] * upconvert).astype(np.complex64)


def _new_history(history: torch.Tensor, x: torch.Tensor,
                 K: int) -> torch.Tensor:
    """The last K samples of ``[history | x]`` along the last axis."""
    n = x.shape[-1]
    if not K:
        return history
    if n >= K:
        return x[..., n - K:]
    return torch.cat([history.to(x.dtype), x], dim=-1)[..., -K:]


def fir_filter_streaming(x: torch.Tensor, taps: torch.Tensor,
                         history: torch.Tensor, axis: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal FIR along ``axis``: ``y[n] = sum_k h[k] x[n-k]`` with
    ``history`` providing the ``len(taps)-1`` samples before the block.

    ``history`` has the same shape as ``x`` except ``axis`` has extent
    ``len(taps)-1``.  Returns ``(y, new_history)``.
    """
    axis = axis % x.ndim
    ntaps = taps.shape[-1]
    ext = torch.cat([history.to(x.dtype), x], dim=axis)
    n = x.shape[axis]
    flat = ext.movedim(axis, -1)
    lane_shape = flat.shape[:-1]
    flat = flat.reshape(-1, flat.shape[-1])

    h = taps.flip(-1)  # convolution kernel ordering for correlation
    if x.is_complex() and not taps.is_complex():
        y = torch.complex(_corr_valid(flat.real, h), _corr_valid(flat.imag, h))
    elif taps.is_complex():
        rr = _corr_valid(flat.real, h.real)
        ri = _corr_valid(flat.real, h.imag)
        if x.is_complex():
            ir = _corr_valid(flat.imag, h.real)
            ii = _corr_valid(flat.imag, h.imag)
            y = torch.complex(rr - ii, ri + ir)
        else:
            y = torch.complex(rr, ri)
        y = y.to(torch.complex64)
    else:
        y = _corr_valid(flat, h).to(x.dtype)

    y = y.reshape(lane_shape + (n,)).movedim(-1, axis)
    if ntaps > 1:
        new_hist = ext.narrow(axis, ext.shape[axis] - (ntaps - 1),
                              ntaps - 1)
    else:
        new_hist = history
    return y, new_hist


def fir_matmul_streaming(x: torch.Tensor, taps: torch.Tensor,
                         history: torch.Tensor, frame: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal FIR as a banded matrix product.

    Each output frame of ``frame`` samples is ``window (frame+T-1) @ M
    (frame+T-1, frame)``, with the taps laid out on M's band.

    x: (..., n); taps real (T,); history: (..., T-1).  Returns
    (y, new_history).
    """
    T = taps.shape[-1]
    K = T - 1
    n = x.shape[-1]
    pad = (-n) % frame
    xp = F.pad(x, (0, pad)) if pad else x

    h = taps.to(torch.float32)
    band = torch.zeros((frame + K, frame), dtype=torch.float32,
                       device=x.device)
    cols = torch.arange(frame, device=x.device).expand(T, frame)
    t = torch.arange(T, device=x.device)[:, None]
    band[cols + t, cols] = h.flip(0)[:, None].expand(T, frame)  # h[K - t]

    ext = torch.cat([history.to(x.dtype), xp], dim=-1)
    frames = ext.unfold(-1, frame + K, frame)   # (..., nf, frame + K)
    if x.is_complex():
        y = torch.complex(frames.real @ band, frames.imag @ band)
    else:
        y = (frames @ band).to(x.dtype)
    y = y.reshape(x.shape[:-1] + (n + pad,))[..., :n]
    return y, _new_history(history, x, K)


def fir_fft_streaming(x: torch.Tensor, taps: torch.Tensor,
                      history: torch.Tensor, fft_size: int = 8192
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal real-tap FIR via overlap-save frequency-domain
    convolution: segments of ``fft_size`` overlap by ``len(taps)-1``,
    multiply by the taps' rfft, and the first ``T-1`` outputs of each
    segment (circular wrap) are discarded.

    x real (..., n); taps real (T,) with T <= fft_size // 2; history
    (..., T-1).  Returns (y, new_history).
    """
    T = taps.shape[-1]
    K = T - 1
    if K >= fft_size // 2:
        raise ValueError("fft_size must be > 2*taps for overlap-save")
    L = int(fft_size)
    step = L - K
    n = x.shape[-1]
    nseg = -(-n // step)
    pad = nseg * step - n
    xp = F.pad(x, (0, pad)) if pad else x
    bodies = xp.reshape(x.shape[:-1] + (nseg, step))
    heads = torch.cat([history.to(x.dtype).unsqueeze(-2),
                       bodies[..., :-1, step - K:]], dim=-2)   # (..., nseg, K)
    segs = torch.cat([heads, bodies], dim=-1)                  # (..., nseg, L)
    H = torch.fft.rfft(taps.to(torch.float32), L)
    Y = torch.fft.irfft(torch.fft.rfft(segs.to(torch.float32), L) * H,
                        L)[..., K:]           # valid part per segment
    y = Y.reshape(x.shape[:-1] + (nseg * step,))[..., :n]
    return y.to(x.dtype), _new_history(history, x, K)


def _corr_valid(x2d: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """(lanes, W) valid cross-correlation with a flipped kernel, i.e. a
    causal FIR: ``out[:, i] = sum_t x2d[:, i + t] * k1d[t]``, as one
    float32 multiply-add per tap (no TF32 on any device)."""
    x = x2d.to(torch.float32)
    k = k1d.to(torch.float32)
    nout = x.shape[-1] - k.shape[-1] + 1
    # from +0, as a CUDA kernel's FMA chain starts: a sum of zeros is then
    # +0 whatever the taps' signs (atan2 tells -0 from +0)
    out = torch.zeros((x.shape[0], nout), dtype=torch.float32,
                      device=x.device)
    for t in range(k.shape[-1]):
        out.addcmul_(x[:, t:t + nout], k[t])
    return out
