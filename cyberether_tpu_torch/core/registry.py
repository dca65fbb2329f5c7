"""Component registry.

Port of ``cyberether_tpu/core/registry.py`` (modules and blocks; the
example, benchmark and plugin tables belong to surfaces not ported yet):
modules keyed by (type, device, runtime, provider), blocks keyed by type.
"""

from __future__ import annotations

from typing import Dict, List, Type

from cyberether_tpu_torch.core.types import (
    ComponentKey,
    Device,
    GraphError,
    Runtime,
)


class Registry:
    def __init__(self) -> None:
        self._modules: Dict[ComponentKey, Type] = {}
        self._blocks: Dict[str, Type] = {}

    # -- modules -----------------------------------------------------------
    def register_module(self, cls: Type) -> Type:
        key = ComponentKey(cls.module_type, cls.device, cls.runtime,
                           getattr(cls, "provider", "generic"))
        if key in self._modules:
            raise GraphError(f"module already registered: {key}")
        self._modules[key] = cls
        return cls

    def build_module(self, type: str, device: Device | str = Device.CUDA,
                     runtime: Runtime | str = Runtime.TORCH,
                     provider: str = "generic") -> Type:
        device = Device.parse(device)
        runtime = Runtime.parse(runtime)
        key = ComponentKey(type, device, runtime, provider)
        if key in self._modules:
            return self._modules[key]
        # fallbacks, in order of preference:
        #   exact -> the same provider on another device or runtime ->
        #   (provider 'generic' only) same type any provider ->
        #   same type CUDA, then CPU
        # (a provider registered for the card also serves a CPU block:
        # its kernel wrappers run their plain versions on CPU tensors)
        candidates = [k for k in self._modules if k.type == type]
        if not candidates:
            raise GraphError(f"no module registered for type '{type}'")
        same = [k for k in candidates if k.provider == provider]
        if not same and provider != "generic":
            # a named provider is never served by another one
            have = sorted({k.provider for k in candidates})
            raise GraphError(
                f"no module of type '{type}' registered for provider "
                f"'{provider}' (has {have})")
        candidates = same or candidates
        for k in candidates:
            if k.device == device and k.runtime == runtime:
                return self._modules[k]
        for k in candidates:
            if k.device == device:
                return self._modules[k]
        for pref_dev in (Device.CUDA, Device.CPU):
            for k in candidates:
                if k.device == pref_dev:
                    return self._modules[k]
        return self._modules[candidates[0]]

    # -- blocks ------------------------------------------------------------
    def register_block(self, cls: Type) -> Type:
        t = cls.block_type
        if t in self._blocks:
            raise GraphError(f"block already registered: '{t}'")
        self._blocks[t] = cls
        return cls

    def build_block(self, type: str) -> Type:
        if type not in self._blocks:
            raise GraphError(f"no block registered for type '{type}'")
        return self._blocks[type]

    def has_block(self, type: str) -> bool:
        return type in self._blocks

    def list_blocks(self) -> List[str]:
        return sorted(self._blocks)


registry = Registry()


def register_module(cls: Type) -> Type:
    """Decorator: ``@register_module`` on a Module subclass."""
    return registry.register_module(cls)


def register_block(cls: Type) -> Type:
    """Decorator: ``@register_block`` on a Block subclass."""
    return registry.register_block(cls)
