"""CyberEther on PyTorch and CUDA: the port of ``cyberether_tpu`` to an
NVIDIA Hopper card.

Flowgraphs of DSP blocks, declared in YAML or Python, run as eager torch
ops on the card, with hand-written CUDA kernels (``csrc/``) on the hot
paths.  The package mirrors the JAX package's layout module for module.
Entry points (``Flowgraph``, ``Instance``, ``Channelizer``,
``WbfmReceiver``, ``SpectrumPipeline``) run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise rather than
fall back.

Ported so far: the channelizer slice (``dti -> squelch -> channelizer``),
the WBFM receiver (``dti -> wbfm``), the fused spectrum
(``dti -> spectrum``), the ``fft`` block (``dti -> fft``) and the
``spectrum_engine`` composite (``dti -> spectrum_engine``), and the
card-floor probes (``cyberether_tpu_torch.probes``).
"""

__version__ = "0.1.0"

from cyberether_tpu_torch.core.types import (  # noqa: F401
    BlockState,
    DataType,
    Device,
    Result,
    Runtime,
    Taint,
)
from cyberether_tpu_torch.core.tensor import SignalAxes, TensorSpec  # noqa: F401
from cyberether_tpu_torch.core.registry import registry  # noqa: F401
from cyberether_tpu_torch.core.flowgraph import Flowgraph  # noqa: F401
from cyberether_tpu_torch.core.instance import Instance  # noqa: F401
from cyberether_tpu_torch.models.channelizer import Channelizer  # noqa: F401
from cyberether_tpu_torch.models.spectrum import SpectrumPipeline  # noqa: F401
from cyberether_tpu_torch.models.wbfm import WbfmReceiver  # noqa: F401
from cyberether_tpu_torch import blocks as _blocks

_blocks.register_all()
