"""Window functions.

Port of ``cyberether_tpu/ops/windows.py``: the reference's Blackman
window (coefficients 0.42 / 0.50 / 0.08, N-1 denominator, a single tap
is 1).
"""

from __future__ import annotations

import numpy as np
import torch


def blackman(size: int, device: "str | torch.device" = "cpu",
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Computed in float64 with numpy, then cast, so it is bit-identical
    to the JAX package's window."""
    if size == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    n = np.arange(size, dtype=np.float64)
    tap = (0.42
           - 0.50 * np.cos(2.0 * np.pi * n / (size - 1))
           + 0.08 * np.cos(4.0 * np.pi * n / (size - 1)))
    return torch.from_numpy(tap).to(device=device, dtype=dtype)
