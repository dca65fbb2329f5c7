"""Tensor metadata layer.

Port of ``cyberether_tpu/core/tensor.py``: the metadata that travels
along flowgraph links — shape, dtype, signal axes and free-form
attributes (sampleRate etc.).  ``TensorSpec`` is used at graph-build
time; at run time values are plain ``torch.Tensor``s (or numpy arrays
on the host side) keyed by the same link.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cyberether_tpu_torch.core.types import DataType, Device, ValidationError


@dataclass(frozen=True)
class SignalAxes:
    """Signal-axis roles attached to a tensor."""

    sample: Optional[int] = None
    batch: Optional[int] = None
    channel: Optional[int] = None

    def validate(self, rank: int) -> None:
        for name in ("sample", "batch", "channel"):
            v = getattr(self, name)
            if v is not None and not (0 <= v < rank):
                raise ValidationError(
                    f"{name}Axis {v} out of range for rank {rank}")
        used = [v for v in (self.sample, self.batch, self.channel)
                if v is not None]
        if len(used) != len(set(used)):
            raise ValidationError(f"signal axes overlap: {self}")

    def remap(self, axis_map: Sequence[Optional[int]]) -> "SignalAxes":
        """Push axes through a structural op.  ``axis_map[old] = new`` with
        ``None`` for dropped axes."""

        def mv(v: Optional[int]) -> Optional[int]:
            if v is None or v >= len(axis_map):
                return None
            return axis_map[v]

        return SignalAxes(sample=mv(self.sample), batch=mv(self.batch),
                          channel=mv(self.channel))


@dataclass(frozen=True)
class TensorSpec:
    """Static description of a link's tensor."""

    shape: Tuple[int, ...]
    dtype: DataType
    device: Device = Device.CUDA
    axes: SignalAxes = field(default_factory=SignalAxes)
    attributes: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        if not isinstance(self.dtype, DataType):
            object.__setattr__(self, "dtype", DataType.parse(self.dtype))
        self.axes.validate(self.rank)

    # -- basic queries -----------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(math.prod(self.shape)) if self.shape else 1

    @property
    def size_bytes(self) -> int:
        return self.size * self.dtype.element_size

    def valid(self) -> bool:
        return all(s > 0 for s in self.shape)

    # -- attribute handling ------------------------------------------------
    def attr(self, key: str, default: Any = None) -> Any:
        return self.attributes.get(key, default)

    def propagate(self, other: "TensorSpec") -> "TensorSpec":
        """Copy attributes + axes from ``other`` where compatible."""
        axes = other.axes
        try:
            axes.validate(self.rank)
        except ValidationError:
            axes = SignalAxes()
        return replace(self, axes=axes,
                       attributes={**other.attributes, **self.attributes})

    # -- shape algebra (spec transforms; the runtime op is a torch view) ---
    def with_shape(self, shape: Sequence[int],
                   axis_map: Optional[Sequence[Optional[int]]] = None
                   ) -> "TensorSpec":
        axes = self.axes.remap(axis_map) if axis_map is not None else \
            (self.axes if len(shape) == self.rank else SignalAxes())
        return replace(self, shape=tuple(shape), axes=axes)

    def with_dtype(self, dtype: "DataType | str") -> "TensorSpec":
        return replace(self, dtype=DataType.parse(dtype))

    def expand_dims(self, axis: int) -> "TensorSpec":
        axis = axis if axis >= 0 else self.rank + 1 + axis
        shape = self.shape[:axis] + (1,) + self.shape[axis:]
        axis_map = [i if i < axis else i + 1 for i in range(self.rank)]
        return self.with_shape(shape, axis_map)

    def squeeze_dims(self, axis: int) -> "TensorSpec":
        axis = axis if axis >= 0 else self.rank + axis
        if self.shape[axis] != 1:
            raise ValidationError(
                f"cannot squeeze non-unit axis {axis} of {self.shape}")
        shape = self.shape[:axis] + self.shape[axis + 1:]
        axis_map: list[Optional[int]] = []
        for i in range(self.rank):
            if i == axis:
                axis_map.append(None)
            else:
                axis_map.append(i if i < axis else i - 1)
        return self.with_shape(shape, axis_map)

    def permute(self, perm: Sequence[int]) -> "TensorSpec":
        shape = tuple(self.shape[p] for p in perm)
        axis_map: list[Optional[int]] = [0] * self.rank
        for new, old in enumerate(perm):
            axis_map[old] = new
        return self.with_shape(shape, axis_map)


def spec_of(array: Any, axes: SignalAxes = SignalAxes(),
            attributes: Optional[Dict[str, Any]] = None,
            device: Device = Device.CUDA) -> TensorSpec:
    """Build a TensorSpec describing a concrete numpy array or tensor."""
    if isinstance(array, torch.Tensor):
        dtype = DataType.from_torch(array.dtype)
    else:
        dtype = DataType.from_np(np.dtype(array.dtype))
    return TensorSpec(shape=tuple(array.shape), dtype=dtype, device=device,
                      axes=axes, attributes=dict(attributes or {}))
