"""core/ domain — tensor-manipulation modules.

Port of ``cyberether_tpu/blocks/core.py`` (so far: ``multiply``,
``cast``, ``reshape``, ``range`` and ``signal_axes``, the ones the
``spectrum_engine`` composite builds on).  Compute is plain torch ops on
the segment's device; structural ops are views.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict

import numpy as np
import torch

from cyberether_tpu_torch.core.block import simple_block
from cyberether_tpu_torch.core.module import Module
from cyberether_tpu_torch.core.params import Field, Schema
from cyberether_tpu_torch.core.registry import register_block, \
    register_module
from cyberether_tpu_torch.core.tensor import SignalAxes, TensorSpec
from cyberether_tpu_torch.core.types import DataType, Taint, ValidationError


def _resolve_axis(axis: int, rank: int) -> int:
    """-1 means the last axis."""
    a = axis if axis >= 0 else rank + axis
    if not 0 <= a < rank:
        raise ValidationError(f"axis {axis} out of range for rank {rank}")
    return a


# ---------------------------------------------------------------------------
# multiply — element-wise product with broadcast
# ---------------------------------------------------------------------------
@register_module
class MultiplyModule(Module):
    module_type = "multiply"
    taints = Taint.STATELESS
    input_ports = ("a", "b")
    output_ports = ("product",)

    def validate(self) -> None:
        a, b = self.input_specs["a"], self.input_specs["b"]
        if a.dtype != b.dtype:
            raise ValidationError(f"dtype mismatch {a.dtype} vs {b.dtype}")
        try:
            np.broadcast_shapes(a.shape, b.shape)
        except ValueError as e:
            raise ValidationError(str(e)) from None

    def create(self) -> Dict[str, TensorSpec]:
        a, b = self.input_specs["a"], self.input_specs["b"]
        shape = np.broadcast_shapes(a.shape, b.shape)
        base = a if a.rank >= b.rank else b
        return {"product": base.with_shape(shape).propagate(base)}

    def apply(self, inputs, state):
        return {"product": inputs["a"] * inputs["b"]}, state


# ---------------------------------------------------------------------------
# cast — dtype conversion; integer inputs are scaled to [-1, 1) by their
# width (128, 32768, 2^31)
# ---------------------------------------------------------------------------
_CAST_SCALERS = {
    DataType.I8: 128.0, DataType.U8: 128.0,
    DataType.CI8: 128.0, DataType.CU8: 128.0,
    DataType.I16: 32768.0, DataType.U16: 32768.0,
    DataType.CI16: 32768.0, DataType.CU16: 32768.0,
    DataType.I32: 2147483648.0, DataType.U32: 2147483648.0,
    DataType.CI32: 2147483648.0, DataType.CU32: 2147483648.0,
}


@register_module
class CastModule(Module):
    module_type = "cast"
    taints = Taint.STATELESS
    input_ports = ("buffer",)
    output_ports = ("buffer",)
    schema = Schema(Field("outputType", "dtype", DataType.CF32))

    def validate(self) -> None:
        self._out_dtype = DataType.parse(self.config["outputType"])
        in_dtype = self.input_specs["buffer"].dtype
        self._scaler = _CAST_SCALERS.get(in_dtype, 1.0)
        self._bypass = in_dtype == self._out_dtype

    def create(self) -> Dict[str, TensorSpec]:
        return {"buffer": self.input_specs["buffer"]
                .with_dtype(self._out_dtype)}

    def apply(self, inputs, state):
        x = inputs["buffer"]
        if self._bypass:
            return {"buffer": x}, state
        out = x.to(self._out_dtype.torch_dtype)
        if self._scaler != 1.0:
            out = out / self._scaler
        return {"buffer": out}, state


# ---------------------------------------------------------------------------
# reshape
# ---------------------------------------------------------------------------
@register_module
class ReshapeModule(Module):
    module_type = "reshape"
    taints = Taint.STATELESS
    input_ports = ("buffer",)
    output_ports = ("buffer",)
    schema = Schema(Field("shape", "list[int]", []))

    def validate(self) -> None:
        spec = self.input_specs["buffer"]
        shape = [int(s) for s in self.config["shape"]]
        n_infer = shape.count(-1)
        if n_infer > 1:
            raise ValidationError("at most one -1 in reshape")
        if n_infer:
            known = int(np.prod([s for s in shape if s != -1])) or 1
            if spec.size % known:
                raise ValidationError(
                    f"cannot reshape {spec.shape} to {shape}")
            shape = [spec.size // known if s == -1 else s for s in shape]
        if int(np.prod(shape)) != spec.size:
            raise ValidationError(f"cannot reshape {spec.shape} to {shape}")
        self._shape = tuple(shape)

    def create(self) -> Dict[str, TensorSpec]:
        return {"buffer": self.input_specs["buffer"].with_shape(self._shape)}

    def apply(self, inputs, state):
        return {"buffer": inputs["buffer"].reshape(self._shape)}, state


# ---------------------------------------------------------------------------
# range — soft-clip normalize [min, max] -> [0, 1]:
#   0.5 + 0.5 tanh(4 (x scale + offset - 0.5))
# ---------------------------------------------------------------------------
@register_module
class RangeModule(Module):
    module_type = "range"
    taints = Taint.STATELESS
    input_ports = ("signal",)
    output_ports = ("signal",)
    schema = Schema(Field("min", "float", -1.0), Field("max", "float", 1.0))

    def create(self) -> Dict[str, TensorSpec]:
        return {"signal": self.input_specs["signal"]}

    def apply(self, inputs, state):
        x = inputs["signal"]
        lower = min(self.config["min"], self.config["max"])
        upper = max(self.config["min"], self.config["max"])
        if lower == upper:
            return {"signal": torch.full_like(x, 0.5)}, state
        scale = 1.0 / (upper - lower)
        offset = -lower * scale
        out = 0.5 + 0.5 * torch.tanh(4.0 * (x * scale + offset - 0.5))
        return {"signal": out.to(x.dtype)}, state


# ---------------------------------------------------------------------------
# signal_axes — set sample/batch/channel axis metadata
# ---------------------------------------------------------------------------
@register_module
class SignalAxesModule(Module):
    module_type = "signal_axes"
    taints = Taint.STATELESS
    input_ports = ("buffer",)
    output_ports = ("buffer",)
    schema = Schema(Field("axes", "str", ""))

    def validate(self) -> None:
        """axes syntax: 'sample=1,batch=0,channel=2' (a subset may be
        given)."""
        spec = self.input_specs["buffer"]
        kv: Dict[str, int] = {}
        s = self.config["axes"].strip()
        if s:
            for part in s.split(","):
                if "=" not in part:
                    raise ValidationError(f"bad axes syntax '{s}'")
                k, v = part.split("=", 1)
                k = k.strip().lower()
                if k not in ("sample", "batch", "channel"):
                    raise ValidationError(f"unknown axis role '{k}'")
                kv[k] = _resolve_axis(int(v), spec.rank)
        self._axes = SignalAxes(**kv)
        self._axes.validate(spec.rank)

    def create(self) -> Dict[str, TensorSpec]:
        return {"buffer": replace(self.input_specs["buffer"],
                                  axes=self._axes)}

    def apply(self, inputs, state):
        return {"buffer": inputs["buffer"]}, state


for _type in ("cast", "multiply", "range", "reshape", "signal_axes"):
    register_block(simple_block(_type))
