"""Probes of this card: what it gives for a launch, a copy and the
channelizer DFT's tile product, measured through the hand-written kernels
of ``ops/probe_kernels.py`` beside PyTorch's own calls; and where the time
of K1 and K12 goes, through their kernel templates with stages compiled
out (``ops/kernels.py``'s ``channelize_ablate`` and ``wbfm_ablate``).

The counterparts of the JAX package's TPU probes under
``tools/ablation/``:

    python -m cyberether_tpu_torch.probes.platform_probe
    python -m cyberether_tpu_torch.probes.stream_probe
    python -m cyberether_tpu_torch.probes.chan_ablate
    python -m cyberether_tpu_torch.probes.wbfm_ablate

Each module's ``measure()`` returns its numbers as a dict naming the card
and its power limit; none runs without a CUDA card.
"""
