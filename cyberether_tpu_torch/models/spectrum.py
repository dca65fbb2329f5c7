"""Single-channel spectrum pipeline: window -> FFT -> |.| dB -> range
scale -> soft clip.

Port of ``cyberether_tpu/models/spectrum.py`` (the spectrum-analyzer
flowgraph as one direct-callable step).

- ``step`` is the reference path in plain torch ops (``torch.fft.fft``),
  in both of the JAX package's formulations: |X|^2 with 10 log10
  (``use_mxu_fft``) or |X| with 20 log10, each with exact or fast
  transcendentals (``fast_math``).
- ``step_kernel`` is the production path, the counterpart of the JAX
  package's ``step_pallas_ct``, with its keywords: one hand-written CUDA
  kernel, K2 (``ops.kernels.spectrum_fused_ct5``), K5
  (``spectrum_fused_ct4``) or, for ``version="ct1"``, K10
  (``spectrum_fused_ct``).
- ``step_dft_kernel``, the counterpart of ``step_pallas``, runs the full
  DFT kernel K6 (``spectrum_fused``) for any n; ``step_dft`` is the
  same product in plain torch matmuls, as the JAX package leaves its
  ``step_dft`` to XLA.
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
        if self.use_mxu_fft:
            return self._display(spec.real * spec.real
                                 + spec.imag * spec.imag)
        log10 = approx_log10 if self.fast_math else torch.log10
        db = 20.0 * log10(spec.abs().clamp_min(1e-30)) + self._coeff
        return self._soft_clip(db)

    def _display(self, mag2: torch.Tensor) -> torch.Tensor:
        """|X|^2 -> the display value, with ``fast_math``'s log10 and
        tanh: the tail of the JAX package's ``step`` and ``step_dft``."""
        log10 = approx_log10 if self.fast_math else torch.log10
        # float32: the floor 1e-60 is 0
        return self._soft_clip(10.0 * log10(mag2.clamp_min(1e-60))
                               + self._coeff)

    def _soft_clip(self, db: torch.Tensor) -> torch.Tensor:
        t = 4.0 * (db * self._scale + self._offset - 0.5)
        return 0.5 + 0.5 * (approx_tanh(t) if self.fast_math
                            else torch.tanh(t))

    def step_kernel(self, iq: torch.Tensor, win: Optional[torch.Tensor] = None,
                    version: str = "ct5", exact: bool = True,
                    stage2: str = "", kb: int = 8) -> torch.Tensor:
        """The fused Cooley-Tukey kernels: the contract of :meth:`step`
        with exact math and |X|^2, as the JAX package's
        ``step_pallas_ct``, for n = 128 m with m <= 32.  "ct5" runs K2
        (``spectrum_fused_ct5``) when m is a power of two and falls back
        to K5 (``spectrum_fused_ct4``) otherwise; "ct4" runs K5 for any
        m; "ct1" runs K10 (``spectrum_fused_ct``) for any m.

        ``exact``, ``stage2`` and ``kb`` are JAX's: a precision tier
        (``exact=False`` is one default-precision matrix pass; ``stage2``
        names the matrix unit's pass structure) and the k1 values a TPU
        grid cell takes.  Every tier runs the same fp32 kernel here, which
        meets the exact tier, and ``kb`` tiles nothing here, so none of the
        three changes the output.  On the card this launches the CUDA
        kernel; on the CPU it runs the kernel's plain version."""
        if version not in ("ct5", "ct4", "ct1"):
            raise ValueError(f"version must be ct5, ct4 or ct1; got "
                             f"{version!r}")
        w = self._win if win is None else win
        args = (iq.contiguous(), w, self._coeff, self._scale, self._offset)
        if version == "ct1":
            return kernels.spectrum_fused_ct(*args, exact=exact)
        if version == "ct5" and \
                not kernels.k2_cuda_unsupported(self.fft_size):
            return kernels.spectrum_fused_ct5(*args)
        return kernels.spectrum_fused_ct4(*args)

    def step_dft_kernel(self, iq: torch.Tensor,
                        win: Optional[torch.Tensor] = None,
                        bf16: bool = False) -> torch.Tensor:
        """The full-DFT kernel K6 (``spectrum_fused``) for any n: the
        contract of :meth:`step_kernel`, as the JAX package's
        ``step_pallas``.  ``bf16`` is JAX's display tier (bfloat16
        products on the TPU's matrix unit); the exact fp32 kernel meets
        that tier too, so both values run it."""
        w = self._win if win is None else win
        return kernels.spectrum_fused(iq.contiguous(), w, self._coeff,
                                      self._scale, self._offset)

    def step_dft(self, iq: torch.Tensor, win: Optional[torch.Tensor] = None,
                 bf16: bool = False) -> torch.Tensor:
        """The full DFT as plain torch matrix products
        (:func:`kernels.dft_products`), then :meth:`step`'s tail with
        ``fast_math``, as the JAX package's ``step_dft``; ``bf16`` rounds
        x and the DFT matrices to bfloat16 and accumulates in float32."""
        w = self._win if win is None else win
        yr, yi = kernels.dft_products(iq[..., 0] * w, iq[..., 1] * w, bf16)
        return self._display(yr * yr + yi * yi)

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
