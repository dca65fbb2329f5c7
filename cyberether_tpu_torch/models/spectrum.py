"""Single-channel spectrum pipeline: window -> FFT -> |.| dB -> range
scale -> soft clip.

Port of ``cyberether_tpu/models/spectrum.py`` (the spectrum-analyzer
flowgraph as one direct-callable step).

- ``step`` is the reference path in plain torch ops (``torch.fft.fft``),
  in both of the JAX package's formulations: |X|^2 with 10 log10
  (``use_mxu_fft``) or |X| with 20 log10, each with exact or fast
  transcendentals (``fast_math``).
- ``step_kernel`` is the production path, the counterpart of the JAX
  package's ``step_pallas_ct`` for ``version="ct5"``: one hand-written
  CUDA kernel (``ops.kernels.spectrum_fused_ct5``).  The routes to the
  kernels not yet ported raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cyberether_tpu_torch.core.types import require_device
from cyberether_tpu_torch.ops import kernels
from cyberether_tpu_torch.ops.fastmath import approx_log10, approx_tanh
from cyberether_tpu_torch.ops.windows import blackman


def unported_route(fft_size: int, version: str = "ct5") -> str:
    """The TPU kernel that would serve this request and has no CUDA port
    yet, or "" when it goes to the ported ct5 kernel (whose shape rule
    ``kernels.k2_cuda_unsupported`` owns)."""
    if version == "ct5" and not kernels.k2_cuda_unsupported(fft_size):
        return ""
    if version == "ct1":
        return "K10 spectrum_fused_ct (ct1)"
    if fft_size % 128 or not 1 <= fft_size // 128 <= kernels.K2_MAX_CHUNKS:
        return "K6 spectrum_fused (the full DFT)"
    return "K5 spectrum_fused_ct4"


@dataclass
class SpectrumPipeline:
    fft_size: int = 2048
    batches: int = 8
    range_min: float = -100.0
    range_max: float = 0.0
    #: |X|^2 with 10 log10 (the JAX package's matrix-unit DFT form);
    #: otherwise |X| with 20 log10.  Both use ``torch.fft.fft`` here
    use_mxu_fft: bool = True
    #: the reference's approximations (ApproxLog10, Padé tanh) in ``step``
    fast_math: bool = True
    device: "str | torch.device" = "cuda"

    def __post_init__(self):
        self.device = require_device(self.device)
        w = blackman(self.fft_size).numpy()
        # fftshift through (-1)^k folded into the window (invert module)
        sign = np.where(np.arange(self.fft_size) % 2 == 0, 1.0, -1.0)
        lo = min(self.range_min, self.range_max)
        hi = max(self.range_min, self.range_max)
        self.load_params({
            "win": (w * sign).astype(np.float32),
            "coeff": np.float32(20.0 * np.log10(1.0 / self.fft_size)),
            "scale": np.float32(1.0 / (hi - lo)),
            "offset": np.float32(-lo / (hi - lo))})

    def load_params(self, params) -> None:
        """Install the window ``win`` (n,) and the scalars ``coeff``,
        ``scale`` and ``offset`` (see :mod:`cyberether_tpu_torch.convert`)."""
        win = torch.as_tensor(params["win"]).to(self.device, torch.float32)
        if tuple(win.shape) != (self.fft_size,):
            raise ValueError(f"win must be ({self.fft_size},); got "
                             f"{tuple(win.shape)}")
        self._win = win.contiguous()
        for name in ("coeff", "scale", "offset"):
            setattr(self, f"_{name}", float(np.float32(params[name])))

    def step(self, iq: torch.Tensor, win: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """iq: (batches, fft_size, 2) float32 re/im -> (batches, fft_size)
        float32 normalized spectrum in [0, 1]."""
        w = self._win if win is None else win
        x = torch.complex(iq[..., 0] * w, iq[..., 1] * w)
        spec = torch.fft.fft(x, dim=-1)
        log10 = approx_log10 if self.fast_math else torch.log10
        if self.use_mxu_fft:
            mag2 = (spec.real * spec.real + spec.imag * spec.imag) \
                .clamp_min(1e-60)                 # float32: a floor of 0
            db = 10.0 * log10(mag2) + self._coeff
        else:
            db = 20.0 * log10(spec.abs().clamp_min(1e-30)) + self._coeff
        t = 4.0 * (db * self._scale + self._offset - 0.5)
        return 0.5 + 0.5 * (approx_tanh(t) if self.fast_math
                            else torch.tanh(t))

    def step_kernel(self, iq: torch.Tensor, win: Optional[torch.Tensor] = None,
                    version: str = "ct5") -> torch.Tensor:
        """The fused kernel: the contract of :meth:`step` with exact math
        and |X|^2, as the JAX package's ``step_pallas_ct``.  On the card
        this launches the CUDA kernel; on the CPU it runs the kernel's
        plain version.  Routes to kernels not yet ported (``version``
        "ct4" or "ct1", a chunk count m = n/128 that is not a power of
        two, n outside 128 .. 4096) raise ``NotImplementedError``."""
        if version not in ("ct5", "ct4", "ct1"):
            raise ValueError(f"version must be ct5, ct4 or ct1; got "
                             f"{version!r}")
        missing = unported_route(self.fft_size, version)
        if missing:
            raise NotImplementedError(
                f"fft_size={self.fft_size}, version={version!r} routes to "
                f"{missing}, which has no CUDA port yet")
        w = self._win if win is None else win
        return kernels.spectrum_fused_ct5(iq.contiguous(), w, self._coeff,
                                          self._scale, self._offset)

    def make_input(self, seed: int = 0,
                   device: "Optional[str | torch.device]" = None):
        """A tone at 0.1 of the sample rate plus complex noise at 0.01, as
        (batches, fft_size, 2) float32.  ``device=None`` gives the numpy
        array, bit-identical to the JAX package's; given a torch device,
        the same array as a tensor there."""
        rng = np.random.default_rng(seed)
        shape = (self.batches, self.fft_size)
        x = np.exp(2j * np.pi * 0.1 * np.arange(self.fft_size))[None, :] \
            + 0.01 * (rng.standard_normal(shape)
                      + 1j * rng.standard_normal(shape))
        out = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
        if device is None:
            return out
        return torch.from_numpy(out).to(require_device(device))
