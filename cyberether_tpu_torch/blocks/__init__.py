"""Built-in block library of the port: the blocks of the ported slices
(``dti``; ``squelch``, ``window``, ``fft``, ``amplitude``, ``invert``,
``agc``; ``cast``, ``multiply``, ``reshape``, ``range``,
``signal_axes``; ``channelizer``, ``wbfm``, ``spectrum``; the
``spectrum_engine`` composite)."""

from __future__ import annotations

_registered = False


def register_all() -> None:
    global _registered
    if _registered:
        return
    _registered = True
    from cyberether_tpu_torch.blocks import composites  # noqa: F401
    from cyberether_tpu_torch.blocks import core  # noqa: F401
    from cyberether_tpu_torch.blocks import dsp  # noqa: F401
    from cyberether_tpu_torch.blocks import dti  # noqa: F401
    from cyberether_tpu_torch.blocks import fused  # noqa: F401
