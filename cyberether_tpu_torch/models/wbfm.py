"""WBFM broadcast receiver: channel filter (FIR) -> FM discriminator ->
boxcar audio decimation, one streaming step with explicit state.

Port of ``cyberether_tpu/models/wbfm.py`` (reference cognate: the
simple-fm flowgraph, source -> filter -> fm -> audio).

- ``step`` is the reference path in plain torch ops: one of the three
  streaming FIRs of :mod:`cyberether_tpu_torch.ops.firs`, the lag-1
  discriminator carried across steps by ``prev``, and a boxcar mean.
- ``step_kernel`` is the production path (the counterpart of the JAX
  package's ``step_pallas``): one hand-written CUDA kernel for FIR +
  discriminator (``ops.kernels.wbfm_fused_v2``, or ``wbfm_fused`` for
  ``version="v1"``), then the boxcar mean; in coherent mode the kernel
  returns the audio itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cyberether_tpu_torch.core.types import require_device
from cyberether_tpu_torch.ops import kernels
from cyberether_tpu_torch.ops.firs import fir_fft_streaming, \
    fir_filter_streaming, fir_matmul_streaming, windowed_sinc_bandpass

_FIRS = {"conv": fir_filter_streaming, "matmul": fir_matmul_streaming,
         "fft": fir_fft_streaming}


@dataclass
class WbfmReceiver:
    sample_rate: float = 2.0e6
    channel_bw: float = 200e3
    audio_decim: int = 40            # 2 MHz -> 50 kHz audio
    taps: int = 129
    deviation: float = 75e3
    #: FIR of :meth:`step`: "conv" (direct form), "matmul" (banded
    #: matrix product) or "fft" (overlap-save)
    fir_impl: str = "fft"
    #: polynomial atan2 (5-term, ~2e-7 rad) instead of ``torch.atan2``
    fast_atan2: bool = True
    device: "str | torch.device" = "cuda"

    def __post_init__(self):
        self.device = require_device(self.device)
        if self.fir_impl not in _FIRS:
            raise ValueError(f"fir_impl must be one of {sorted(_FIRS)}; "
                             f"got {self.fir_impl!r}")
        h = windowed_sinc_bandpass(self.taps, self.sample_rate,
                                   self.channel_bw, [0.0])[0].real
        kf = self.deviation / self.sample_rate
        self.load_taps({"taps": h.astype(np.float32),
                        "ref": np.float32(1.0 / (2.0 * np.pi * kf))})

    def load_taps(self, arrays: Mapping[str, object]) -> None:
        """Install the channel filter ``taps`` (T,) and the FM gain
        ``ref`` (see :mod:`cyberether_tpu_torch.convert`)."""
        taps = torch.as_tensor(arrays["taps"]).to(self.device, torch.float32)
        if tuple(taps.shape) != (self.taps,):
            raise ValueError(f"taps must be ({self.taps},); got "
                             f"{tuple(taps.shape)}")
        self._taps = taps.contiguous()
        self._ref = float(np.float32(np.asarray(arrays["ref"])))

    def init_state(self) -> Dict[str, torch.Tensor]:
        """``fir_hist`` (2, T-1): the last raw samples; ``prev`` (2,): the
        last filtered sample (the discriminator's lag in :meth:`step`)."""
        return {
            "fir_hist": torch.zeros((2, self.taps - 1), dtype=torch.float32,
                                    device=self.device),
            "prev": torch.zeros((2,), dtype=torch.float32,
                                device=self.device),
        }

    def _check(self, iq: torch.Tensor) -> int:
        if iq.dim() != 2 or iq.shape[1] != 2:
            raise ValueError(f"iq must be (n, 2); got {tuple(iq.shape)}")
        n = iq.shape[0]
        if n % self.audio_decim:
            raise ValueError(f"n ({n}) must be a multiple of audio_decim "
                             f"({self.audio_decim})")
        return n

    def _decimate(self, demod: torch.Tensor) -> torch.Tensor:
        """Boxcar audio decimation: the mean of each D samples."""
        return demod.reshape(-1, self.audio_decim).mean(-1)

    def step(self, state: Dict[str, torch.Tensor], iq: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """iq: (n, 2) float32 re/im, n divisible by audio_decim.
        Returns (audio (n // audio_decim,), new_state)."""
        self._check(iq)
        filt, new_hist = _FIRS[self.fir_impl](iq.T, self._taps,
                                              state["fir_hist"])
        yr, yi = filt[0], filt[1]
        pr = torch.cat([state["prev"][:1], yr[:-1]])
        pi = torch.cat([state["prev"][1:], yi[:-1]])
        di, dr = pr * yi - pi * yr, pr * yr + pi * yi
        if self.fast_atan2:
            demod = kernels.atan2_poly(di, dr, poly3=False) * self._ref
        else:
            demod = torch.atan2(di, dr) * self._ref
        new_state = {
            "fir_hist": new_hist.clone(memory_format=torch.contiguous_format),
            "prev": torch.stack([yr[-1], yi[-1]]),
        }
        return self._decimate(demod), new_state

    def step_kernel(self, state: Dict[str, torch.Tensor], iq: torch.Tensor,
                    version: str = "v2", demod_mode: str = "classic"
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One streaming step of the production path; the same (audio,
        state) contract as :meth:`step`.

        ``version="v2"`` (default) hands the raw (n, 2) input to the
        kernel; ``"v1"`` transposes it to planar (2, n) first.
        ``demod_mode="coherent"`` (v2 only) averages the lag products
        over each audio sample's D input samples in the kernel, one angle
        per audio sample.  On the card this launches the CUDA kernel; on
        the CPU it runs the kernel's plain version.  The kernels take the
        lag of the first sample from ``fir_hist`` alone (the sample
        before it counts as zero), as the JAX package's do: ``prev`` is
        written, for :meth:`step`, and not read."""
        self._check(iq)
        if version not in ("v1", "v2"):
            raise ValueError(f"version must be 'v1' or 'v2'; got {version!r}")
        if demod_mode not in ("classic", "coherent"):
            raise ValueError("demod_mode must be 'classic' or 'coherent'; "
                             f"got {demod_mode!r}")
        if demod_mode == "coherent" and version != "v2":
            raise ValueError("demod_mode='coherent' requires the v2 kernel")
        hist = state["fir_hist"]
        x = iq.T                                        # (2, n) view
        if version == "v1":
            demod = kernels.wbfm_fused(x.contiguous(), self._taps, hist,
                                       self._ref)
            audio = self._decimate(demod)
        elif demod_mode == "coherent":
            audio = kernels.wbfm_fused_v2(iq.contiguous(), self._taps, hist,
                                          self._ref,
                                          coherent_decim=self.audio_decim)
        else:
            audio = self._decimate(kernels.wbfm_fused_v2(
                iq.contiguous(), self._taps, hist, self._ref))
        # the last filtered sample (the lag that step() threads); the new
        # history is copied out of the caller's buffer, which the caller
        # may refill in place
        T = self.taps
        tail = torch.cat([hist, x[:, -T:]], dim=-1)[:, -T:]
        return audio, {"fir_hist": tail[:, 1:].contiguous(),
                       "prev": tail @ self._taps.flip(0)}

    # ------------------------------------------------------------------
    def make_input(self, n: int, seed: int = 0,
                   device: "Optional[str | torch.device]" = None):
        """A 1 kHz tone, FM-modulated at ``deviation``, plus complex
        noise at 0.01, as (n, 2) float32.  ``device=None`` gives the
        numpy array, bit-identical to the JAX package's; given a torch
        device, the same array as a tensor there."""
        rng = np.random.default_rng(seed)
        t = np.arange(n) / self.sample_rate
        msg = np.sin(2 * np.pi * 1e3 * t)
        phase = 2 * np.pi * self.deviation * np.cumsum(msg) \
            / self.sample_rate
        x = np.exp(1j * phase).astype(np.complex64)
        x += 0.01 * (rng.standard_normal(n)
                     + 1j * rng.standard_normal(n)).astype(np.complex64)
        out = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
        if device is None:
            return out
        return torch.from_numpy(out).to(require_device(device))
