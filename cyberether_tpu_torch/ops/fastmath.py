"""Fast transcendental approximations.

Port of ``cyberether_tpu/ops/fastmath.py``: ``approx_log10`` is the
reference's ``ApproxLog10`` (frexp + cubic mantissa polynomial) through
the float's bits, and ``approx_tanh`` a Padé(7,6) form.  The spectrum
pipeline's ``step`` uses both when ``fast_math`` is on.
"""

from __future__ import annotations

import torch


def approx_log10(x: torch.Tensor) -> torch.Tensor:
    """log10(|x|) from the exponent bits and a mantissa polynomial; within
    ~1e-4 of log10.  x must be > 0."""
    bits = x.abs().float().contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 126                    # frexp exponent
    f = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [.5, 1)
    y = 1.23149591368684 * f - 4.11852516267426
    y = y * f + 6.02197014179219
    y = y * f - 3.13396450166353
    y = y + e.float()
    return y * 0.3010299956639812


def approx_tanh(x: torch.Tensor) -> torch.Tensor:
    """Padé(7,6) tanh (Lambert's continued fraction), clamped at |x| = 4.5,
    where tanh is within 2.5e-4 of saturation; no transcendental."""
    xc = x.clamp(-4.5, 4.5)
    x2 = xc * xc
    num = xc * (135135.0 + x2 * (17325.0 + x2 * (378.0 + x2)))
    den = 135135.0 + x2 * (62370.0 + x2 * (3150.0 + x2 * 28.0))
    return num / den
