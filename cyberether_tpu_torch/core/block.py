"""Block base — the user-facing flowgraph node.

Port of ``cyberether_tpu/core/block.py``.  A block instantiates one or
more modules against its (device, runtime, provider) target, wires them
internally, and exposes a subset of module ports as its own interface.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Type

from cyberether_tpu_torch.core.module import Module
from cyberether_tpu_torch.core.params import Schema, config_hash
from cyberether_tpu_torch.core.registry import registry
from cyberether_tpu_torch.core.tensor import TensorSpec
from cyberether_tpu_torch.core.types import (
    Device,
    GraphError,
    MissingInputError,
    Runtime,
)


@dataclass(frozen=True)
class PortRef:
    """A reference to a module output in the flattened graph."""

    module: str   # flattened module name, e.g. "chan/m"
    port: str


@dataclass
class BlockBuild:
    """Result of building one block: its modules (in creation order),
    internal wiring, and the exposed output map."""

    modules: Dict[str, Module] = field(default_factory=dict)
    module_inputs: Dict[str, Dict[str, PortRef]] = field(default_factory=dict)
    exposed: Dict[str, PortRef] = field(default_factory=dict)


class BlockContext:
    """Passed to ``Block.build``; creates modules and exposes outputs."""

    def __init__(self, block: "Block",
                 external_inputs: Dict[str, Tuple[PortRef, TensorSpec]]):
        self._block = block
        self._external = external_inputs
        self.out = BlockBuild()

    # -- block interface ----------------------------------------------------
    def input_ref(self, port: str) -> PortRef:
        if port not in self._external:
            raise MissingInputError(
                f"block '{self._block.name}' missing input '{port}'")
        return self._external[port][0]

    def input_spec(self, port: str) -> TensorSpec:
        return self._external[port][1]

    def has_input(self, port: str) -> bool:
        return port in self._external

    def external_ports(self) -> Tuple[str, ...]:
        return tuple(self._external)

    def module(self, local_name: str, module_type: str,
               config: Optional[Dict[str, Any]] = None,
               inputs: Optional[Dict[str, PortRef]] = None,
               provider: Optional[str] = None) -> "PortRefFactory":
        """Create module ``local_name`` fed by ``inputs``, on the block's
        (device, runtime, provider) target unless ``provider`` names
        another (a composite picks a provider per module)."""
        blk = self._block
        flat = f"{blk.name}/{local_name}"
        if flat in self.out.modules:
            raise GraphError(f"duplicate module '{flat}'")
        cls = registry.build_module(
            module_type, blk.device, blk.runtime,
            provider if provider is not None else blk.provider)
        inputs = dict(inputs or {})
        specs = {port: self.resolve_spec(ref)
                 for port, ref in inputs.items()}
        # the *requested* device wins for segment placement: a block
        # asking for `device: cpu` runs on the CPU even though its module
        # class registered for CUDA
        mod = cls(flat, config, specs, device=blk.device)
        self.out.modules[flat] = mod
        self.out.module_inputs[flat] = inputs
        return PortRefFactory(flat, mod)

    def resolve_spec(self, ref: PortRef) -> TensorSpec:
        if ref.module in self.out.modules:
            mod = self.out.modules[ref.module]
            if ref.port not in mod.output_specs:
                raise GraphError(
                    f"module '{ref.module}' has no output '{ref.port}'")
            return mod.output_specs[ref.port]
        for ext_ref, spec in self._external.values():
            if ext_ref == ref:
                return spec
        raise GraphError(f"unresolvable internal link {ref}")

    def expose(self, block_port: str, ref: "PortRef | PortRefFactory",
               port: Optional[str] = None) -> None:
        if isinstance(ref, PortRefFactory):
            ref = ref.output(port if port is not None else
                             next(iter(ref.module_obj.output_specs)))
        self.out.exposed[block_port] = ref


@dataclass
class PortRefFactory:
    """Handle returned by ``ctx.module`` for ergonomic wiring."""

    flat_name: str
    module_obj: Module

    def output(self, port: str) -> PortRef:
        if port not in self.module_obj.output_specs:
            raise GraphError(
                f"module '{self.flat_name}' has no output '{port}' "
                f"(has {sorted(self.module_obj.output_specs)})")
        return PortRef(self.flat_name, port)

    def __getitem__(self, port: str) -> PortRef:
        return self.output(port)


class Block:
    """Base class for flowgraph blocks."""

    block_type: str = ""
    summary: str = ""
    schema: Schema = Schema()
    #: declared interface; () = derived dynamically
    input_ports: Tuple[str, ...] = ()
    output_ports: Tuple[str, ...] = ()

    def __init__(self, name: str, raw_config: Optional[Dict[str, Any]],
                 device: Device, runtime: Runtime, provider: str):
        self.name = name
        self.device = device
        self.runtime = runtime
        self.provider = provider
        self.raw_config = dict(raw_config or {})
        self.config: Dict[str, Any] = self.schema.decode(raw_config)
        self.config_hash = config_hash(self.config)
        self.validate()
        self.build_result: Optional[BlockBuild] = None

    def validate(self) -> None:
        """Config-only validation (no inputs yet)."""

    def build(self, ctx: BlockContext) -> None:
        """Create modules + wiring.  Must expose every output port."""
        raise NotImplementedError

    def instantiate(self, external_inputs: Dict[str, Tuple[PortRef,
                                                           TensorSpec]]
                    ) -> BlockBuild:
        for port in self.input_ports:
            if port not in external_inputs:
                raise MissingInputError(
                    f"block '{self.name}' missing input '{port}'")
        ctx = BlockContext(self, external_inputs)
        self.build(ctx)
        for port in self.output_ports:
            if port not in ctx.out.exposed:
                raise GraphError(
                    f"block '{self.name}' did not expose output '{port}'")
        self.build_result = ctx.out
        return ctx.out


def simple_block(block_type: str, summary: str = "") -> Type[Block]:
    """Factory for 1:1 blocks wrapping a single module of the same type."""

    class _SimpleBlock(Block):
        pass

    def build(self: Block, ctx: BlockContext) -> None:
        cls = registry.build_module(block_type, self.device, self.runtime,
                                    self.provider)
        # dynamic-port modules (no declared inputs) take every external
        # input
        in_ports = cls.input_ports or ctx.external_ports()
        inputs = {p: ctx.input_ref(p) for p in in_ports if ctx.has_input(p)}
        handle = ctx.module("m", block_type, self.raw_config, inputs)
        for p in handle.module_obj.output_specs:
            ctx.expose(p, handle.output(p))

    _SimpleBlock.__name__ = f"Block_{block_type}"
    _SimpleBlock.block_type = block_type
    _SimpleBlock.summary = summary
    _SimpleBlock.build = build
    return _SimpleBlock
