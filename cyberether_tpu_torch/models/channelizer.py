"""64-channel polyphase channelizer + per-channel FM demod.

Port of ``cyberether_tpu/models/channelizer.py``: the flagship model.

- ``step`` is the reference path in plain torch ops: the polyphase
  branch FIR as P shifted multiply-adds over the frame axis, the
  C-point filterbank DFT as two C x C real products, the lag-1 phase
  difference with ``torch.atan2``, and a boxcar mean for the audio
  decimation.
- ``step_kernel`` is the production path: interleaved input rows, one
  hand-written CUDA kernel for FIR + DFT + demod + decimation, and P raw
  history rows as state.  ``kernel`` picks it: "v5" (the default,
  ``ops.kernels.channelize_demod_decim``), "v4" (the taps folded into P
  DFT matrices, ``channelize_demod_decim_v4``) or "v6" (the 5-term atan2
  on an approximate reciprocal, ``channelize_demod_decim_v6``).
- ``step_carry_kernel`` is the JAX package's ``step_pallas``: the state of
  ``step``, re|im-halves rows, the undecimated kernel
  ``ops.kernels.channelize_demod`` (variants "v1" and "v2"), and the
  boxcar mean in torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cyberether_tpu_torch.core.types import require_device
from cyberether_tpu_torch.ops.kernels import K7_VARIANTS, \
    channelize_demod, channelize_demod_decim, channelize_demod_decim_v4, \
    channelize_demod_decim_v6, fold_channelizer_matrices, k7_tables, \
    perm_channelizer_matrix

# step_kernel's kernels: K1, K8, K9
STEP_KERNELS = ("v5", "v4", "v6")


def design_prototype(channels: int, taps_per_branch: int,
                     kaiser_beta: float = 9.0) -> np.ndarray:
    """Prototype lowpass for a critically-sampled filterbank: windowed
    sinc with cutoff 1/(2C), length C*P, unity DC gain per branch."""
    n = channels * taps_per_branch
    t = np.arange(n) - (n - 1) / 2.0
    cutoff = 1.0 / (2.0 * channels)
    h = 2 * cutoff * np.sinc(2 * cutoff * t)
    h *= np.kaiser(n, kaiser_beta)
    h /= h.sum() / channels   # per-channel unity gain at band center
    return h.astype(np.float32)


@dataclass
class Channelizer:
    channels: int = 64
    taps_per_branch: int = 8
    audio_decim: int = 16          # frames per audio sample
    sample_rate: float = 128e6     # aggregate input rate (Hz)
    deviation: float = 75e3
    device: "str | torch.device" = "cuda"

    def __post_init__(self):
        self.device = require_device(self.device)
        C, Pt = self.channels, self.taps_per_branch
        hp = design_prototype(C, Pt).reshape(Pt, C)     # branch p, phase k
        hp_rev = hp[::-1].copy()                        # causal FIR order
        k = np.arange(C)
        W = np.exp(-2j * np.pi * np.outer(k, k) / C)    # analysis DFT
        wr = W.real.astype(np.float32)
        wi = W.imag.astype(np.float32)
        chan_rate = self.sample_rate / C
        kf = self.deviation / chan_rate
        self.load_tables({
            # kernel-order taps (P, C): the reference path's and K7's
            "hp": hp_rev,
            # the analysis DFT's parts (C, C)
            "wr": wr,
            "wi": wi,
            # kernel-order taps duplicated on interleaved re|im lanes
            "hp5": np.repeat(hp_rev, 2, axis=1),
            # lane-permuted DFT block matrix for interleaved rows
            "bperm5": perm_channelizer_matrix(wr, wi),
            # the taps folded into it: P matrices (K8)
            "bp4": fold_channelizer_matrices(hp_rev, wr, wi),
            "fm_ref": float(np.float32(1.0 / (2.0 * np.pi * kf))),
        })

    def load_tables(self, tables: Dict[str, object]) -> None:
        """Install every table of the model (see
        :mod:`cyberether_tpu_torch.convert`): ``hp`` (P, C) kernel-order
        taps, ``wr`` and ``wi`` (C, C), ``hp5`` (P, 2C), ``bperm5``
        (2C, 2C), ``bp4`` (P, 2C, 2C) and ``fm_ref``; K7's tables are
        derived here from ``hp``, ``wr`` and ``wi``."""
        C, Pt = self.channels, self.taps_per_branch
        shapes = {"hp": (Pt, C), "wr": (C, C), "wi": (C, C),
                  "hp5": (Pt, 2 * C), "bperm5": (2 * C, 2 * C),
                  "bp4": (Pt, 2 * C, 2 * C)}
        missing = sorted((set(shapes) | {"fm_ref"}) - set(tables))
        if missing:
            raise ValueError(f"tables lack {missing}")
        got = {k: torch.as_tensor(tables[k]).to(self.device, torch.float32)
               for k in shapes}
        wrong = {k: tuple(t.shape) for k, t in got.items()
                 if tuple(t.shape) != shapes[k]}
        if wrong:
            raise ValueError(f"tables do not fit C={C}, P={Pt}: {wrong}")
        for k, t in got.items():
            setattr(self, k, t.contiguous())
        # the reference path's per-branch taps (C, P)
        self.taps = self.hp.T.contiguous()
        # K7's re|im-halves tables by variant, derived from hp, wr and wi
        self.k7_tables = {v: k7_tables(self.hp, self.wr, self.wi, v)
                          for v in K7_VARIANTS}
        self.fm_ref = float(np.float32(tables["fm_ref"]))

    # ------------------------------------------------------------------
    def init_state(self, dtype: torch.dtype = torch.float32
                   ) -> Dict[str, torch.Tensor]:
        """State of :meth:`step`: P-1 history frames as (re/im, C, P-1)
        and the last filterbank frame as (re/im, C)."""
        C, Pt = self.channels, self.taps_per_branch
        return {
            "hist": torch.zeros((2, C, Pt - 1), dtype=dtype,
                                device=self.device),
            "prev": torch.zeros((2, C), dtype=dtype, device=self.device),
        }

    def init_state_v4(self, dtype: torch.dtype = torch.float32
                      ) -> Dict[str, torch.Tensor]:
        """State of :meth:`step_kernel`: P history frames in the
        kernel's interleaved row layout (= raw ``iq.reshape(-1, 2C)``
        rows), in the ingest dtype."""
        C, Pt = self.channels, self.taps_per_branch
        return {"hist": torch.zeros((Pt, 2 * C), dtype=dtype,
                                    device=self.device)}

    def frames_for(self, samples: int) -> int:
        return samples // self.channels

    # ------------------------------------------------------------------
    def step(self, state: Dict[str, torch.Tensor], iq: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One streaming step of the reference path.

        iq: (frames, C, 2) float32 — interleaved re/im of the input
        stream reshaped into polyphase frames (frame m, branch k =
        sample m*C+k).  Returns (audio, new_state): audio
        (frames // audio_decim, C) float32.
        """
        C, Pt = self.channels, self.taps_per_branch
        M = iq.shape[0]
        x = iq.permute(2, 1, 0)                           # (2, C, M)
        ext = torch.cat([state["hist"], x], dim=-1)       # (2, C, M+P-1)
        # polyphase branch FIR: z[k, m] = sum_p ext[k, m+p] * taps[k, p]
        z = ext[..., 0:M] * self.taps[:, 0:1]
        for p in range(1, Pt):
            z = z + ext[..., p:p + M] * self.taps[:, p:p + 1]
        # filterbank DFT: y[c, m] = sum_k W[c, k] * z[k, m]   (complex)
        zr, zi = z[0], z[1]
        yr = self.wr @ zr - self.wi @ zi
        yi = self.wr @ zi + self.wi @ zr                  # (C, M)
        # FM demod: angle(conj(y[m-1]) * y[m]) * ref, lag along frames
        pr = torch.cat([state["prev"][0][:, None], yr[:, :-1]], dim=1)
        pi = torch.cat([state["prev"][1][:, None], yi[:, :-1]], dim=1)
        dr = pr * yr + pi * yi
        di = pr * yi - pi * yr
        demod = torch.atan2(di, dr) * self.fm_ref         # (C, M)
        D = self.audio_decim
        audio = demod.reshape(C, M // D, D).mean(-1).T    # (M//D, C)
        new_state = {
            "hist": ext[:, :, M:].clone(),
            "prev": torch.stack([yr[:, -1], yi[:, -1]]),
        }
        return audio.contiguous(), new_state

    def step_kernel(self, state: Dict[str, torch.Tensor],
                    iq: torch.Tensor, demod_mode: str = "classic",
                    kernel: str = "v5"
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One streaming step of the production path (the counterpart of
        the JAX package's ``step_pallas_v4``).

        iq: (frames, C, 2) or (frames, 2C) on this model's device;
        ``state`` from :meth:`init_state_v4` in the same dtype.
        ``kernel``: "v5" takes float32, int8 or int16 rows and both demod
        modes; "v4" and "v6" take float32 rows and the classic mode, as
        the JAX package's do.  On the card this launches the CUDA kernel;
        on the CPU it runs the kernel's plain version."""
        if kernel not in STEP_KERNELS:
            raise ValueError(f"kernel must be one of {STEP_KERNELS}; got "
                             f"{kernel!r}")
        if kernel != "v5" and demod_mode != "classic":
            raise ValueError(f"demod_mode={demod_mode!r} requires the v5 "
                             f"kernel (got kernel={kernel!r}): v4 and v6 "
                             "take only the classic mode")
        C, Pt = self.channels, self.taps_per_branch
        M = iq.shape[0]
        if M < Pt:
            raise ValueError(f"a step needs at least P={Pt} frames; "
                             f"got {M}")
        x2 = iq.reshape(M, 2 * C).contiguous()    # a view when contiguous
        hist, D = state["hist"], self.audio_decim
        if kernel == "v4":
            audio = channelize_demod_decim_v4(x2, hist, self.bp4,
                                              self.fm_ref, D)
        elif kernel == "v6":
            audio = channelize_demod_decim_v6(x2, hist, self.hp5,
                                              self.bperm5, self.fm_ref, D)
        else:
            audio = channelize_demod_decim(x2, hist, self.hp5, self.bperm5,
                                           self.fm_ref, D,
                                           demod_mode=demod_mode)
        # the new history is copied out of the caller's buffer, which the
        # caller may refill in place
        return audio, {"hist": x2[M - Pt:].clone()}

    def step_carry_kernel(self, state: Dict[str, torch.Tensor],
                          iq: torch.Tensor, variant: str = "v1"
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One streaming step of :meth:`step`'s function through the
        undecimated kernel (the counterpart of the JAX package's
        ``step_pallas``).

        iq: (frames, C, 2) float32 on this model's device; ``state`` from
        :meth:`init_state`.  The frames and history become re|im-halves
        rows ext (frames + P - 1, 2C) as in the JAX package (transpose,
        concatenate, reshape); the kernel (``variant`` "v1" or "v2")
        returns the demod and the last filterbank frame; the boxcar mean
        runs in torch."""
        C, Pt, D = self.channels, self.taps_per_branch, self.audio_decim
        M = iq.shape[0]
        if iq.dim() != 3 or tuple(iq.shape[1:]) != (C, 2) or M % D:
            raise ValueError(f"iq must be (frames, {C}, 2) with frames a "
                             f"multiple of {D}; got {tuple(iq.shape)}")
        x = iq.permute(2, 1, 0)                           # (2, C, M)
        ext3 = torch.cat([state["hist"], x], dim=-1)      # (2, C, M+P-1)
        # (a strided view, copied to the rows the kernel reads)
        ext = ext3.permute(2, 0, 1).reshape(M + Pt - 1, 2 * C).contiguous()
        demod, ylast = channelize_demod(
            ext, self.hp, self.wr, self.wi, state["prev"].reshape(1, 2 * C),
            self.fm_ref, variant=variant,
            tables=self.k7_tables.get(variant))           # (M, C)
        audio = demod.reshape(M // D, D, C).mean(1)
        # the last P-1 frames (for P = 1 none: the JAX package's
        # ext3[:, :, -(P-1):] keeps all of them there)
        return audio, {"hist": ext3[:, :, M:].clone(),
                       "prev": ylast.reshape(2, C)}

    # ------------------------------------------------------------------
    def make_input_full(self, frames: int, seed: int = 0,
                        device: "Optional[str | torch.device]" = None):
        """FM carriers in EVERY channel (distinct audio tones), as
        (frames, C, 2) float32.  For elementwise correctness checks:
        demod of an empty channel (and of noise) is +/-2pi atan2-branch
        noise, so only a fully occupied band compares cleanly across
        implementations.

        ``device=None`` builds a numpy array bit-identical to the JAX
        package's.  Given a torch device, the same signal (same random
        phases) is built there in float64 — fast at full width, equal to
        the numpy array up to float32 rounding."""
        rng = np.random.default_rng(seed)
        C = self.channels
        n = frames * C
        offsets = [rng.uniform(0, 6.28) for _ in range(C)]
        if device is not None:
            return self._make_input_full_torch(frames, offsets,
                                               require_device(device))
        t = np.arange(n) / self.sample_rate
        x = np.zeros(n, np.complex64)
        for ch in range(C):
            fc = (ch - C / 2) * (self.sample_rate / C)
            tone = 300.0 + 37.0 * ch
            msg = np.sin(2 * np.pi * tone * t + offsets[ch])
            phase = 2 * np.pi * (fc * t + self.deviation
                                 * np.cumsum(msg) / self.sample_rate)
            x += np.exp(1j * phase).astype(np.complex64)
        frames_arr = x.reshape(frames, C)
        return np.stack([frames_arr.real, frames_arr.imag],
                        axis=-1).astype(np.float32)

    def _make_input_full_torch(self, frames: int, offsets,
                               device: torch.device) -> torch.Tensor:
        C = self.channels
        n = frames * C
        t = torch.arange(n, dtype=torch.float64, device=device) \
            / self.sample_rate
        x = torch.zeros(n, dtype=torch.complex64, device=device)
        for ch in range(C):
            fc = (ch - C / 2) * (self.sample_rate / C)
            tone = 300.0 + 37.0 * ch
            msg = torch.sin(2 * math.pi * tone * t + offsets[ch])
            phase = 2 * math.pi * (fc * t + self.deviation
                                   * torch.cumsum(msg, 0) / self.sample_rate)
            x += torch.polar(torch.ones_like(phase), phase).to(
                torch.complex64)
        return torch.view_as_real(x.reshape(frames, C)).contiguous()

    def make_input(self, frames: int, seed: int = 0) -> np.ndarray:
        """Synthetic multicarrier test input (frames, C, 2) float32."""
        rng = np.random.default_rng(seed)
        n = frames * self.channels
        t = np.arange(n) / self.sample_rate
        x = np.zeros(n, np.complex64)
        for ch in (3, 17, 40):
            fc = (ch - self.channels / 2) * \
                (self.sample_rate / self.channels)
            msg = np.sin(2 * np.pi * 1e3 * t)
            phase = 2 * np.pi * (fc * t +
                                 self.deviation * np.cumsum(msg)
                                 / self.sample_rate)
            x += np.exp(1j * phase).astype(np.complex64)
        x += (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
            .astype(np.complex64) * 0.01
        frames_arr = x.reshape(frames, self.channels)
        return np.stack([frames_arr.real, frames_arr.imag],
                        axis=-1).astype(np.float32)
