"""Card-floor probes: what this card gives for a launch, a copy and the
channelizer DFT's tile product, measured through the hand-written kernels
of ``ops/probe_kernels.py`` beside PyTorch's own calls.

The counterparts of the JAX package's TPU probes under
``tools/ablation/``:

    python -m cyberether_tpu_torch.probes.platform_probe
    python -m cyberether_tpu_torch.probes.stream_probe

Each module's ``measure()`` returns its numbers as a dict naming the card
and its power limit; neither runs without a CUDA card.
"""
