"""Width groups and parameter slicing specs, on the port's tensor axes.

Port of ``heterofl_tpu/models/spec.py``.  A ``Group`` is a named width axis
of the global model; a client at ``width_rate`` keeps the first
``ceil(size * rate)`` entries (``prefix``), the first ``ceil(head_dim *
rate)`` entries of each of ``num_heads`` heads (``per_head``), or all of
them (``full``).  A ``ParamSpec`` says which group governs each axis of a
parameter -- in PyTorch layout here: a conv weight's output channels are
axis 0 and its input channels axis 1 (OIHW, where the reference's HWIO has
3 and 2), a linear weight is ``[out, in]`` -- plus the axis restricted to
the client's label split at aggregation time.

Width rates are host floats in this port (fix mode knows every client's
rate before the round), so the masks are built without a device sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Group:
    name: str
    size: int
    kind: str = "prefix"  # "prefix" | "per_head" | "full"
    num_heads: int = 1

    def active_count(self, width_rate: float) -> int:
        if self.kind == "full":
            return self.size
        if self.kind == "prefix":
            return _ceil_f32(self.size, width_rate)
        if self.kind == "per_head":
            return _ceil_f32(self.size // self.num_heads, width_rate) * self.num_heads
        raise ValueError(f"Not valid group kind: {self.kind!r}")

    def mask(self, width_rate: float) -> torch.Tensor:
        """0/1 activity mask of shape ``[size]`` (CPU)."""
        if self.kind == "per_head":
            hd = self.size // self.num_heads
            idx = torch.arange(self.size) % hd
            return (idx < _ceil_f32(hd, width_rate)).to(torch.float32)
        m = torch.zeros(self.size, dtype=torch.float32)
        m[: self.active_count(width_rate)] = 1.0
        return m


def _ceil_f32(size: int, width_rate: float) -> int:
    """``ceil(size * rate)`` of the float32 product, as the reference
    computes it in-jit."""
    return int(math.ceil(np.float32(size) * np.float32(width_rate)))


@dataclass(frozen=True)
class ParamSpec:
    axis_groups: Dict[int, str] = field(default_factory=dict)
    label_axis: Optional[int] = None


def _axis_view(shape: Tuple[int, ...], axis: int, vec: torch.Tensor) -> torch.Tensor:
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return vec.reshape(view)


def label_vector(label_mask: torch.Tensor, length: int) -> torch.Tensor:
    """A label mask over a label axis of ``length`` entries: zero-padded
    when the axis is longer (the transformer's token embedding has one more
    row, the ``<mask>`` token, which is outside every label split and never
    aggregated)."""
    short = length - label_mask.shape[0]
    if short > 0:
        label_mask = torch.cat([label_mask, label_mask.new_zeros(short)])
    return label_mask


def param_mask(shape: Tuple[int, ...], spec: ParamSpec, groups: Dict[str, Group],
               width_rate: float, label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Activity mask of one parameter (product over its sliced axes); given
    ``label_mask``, the label axis is also restricted (the count mask)."""
    m = torch.ones(shape, dtype=torch.float32)
    for axis, gname in spec.axis_groups.items():
        m = m * _axis_view(shape, axis, groups[gname].mask(width_rate))
    if spec.label_axis is not None and label_mask is not None:
        vec = label_vector(label_mask.detach().to("cpu", torch.float32), shape[spec.label_axis])
        m = m * _axis_view(shape, spec.label_axis, vec)
    return m


def mask_params(params: Dict[str, torch.Tensor], specs: Dict[str, ParamSpec],
                groups: Dict[str, Group], width_rate: float) -> Dict[str, torch.Tensor]:
    """Zero the inactive entries of every parameter (distribute-time mask)."""
    return {k: v * param_mask(tuple(v.shape), specs[k], groups, width_rate).to(v.device)
            for k, v in params.items()}


def count_masks(params_shapes: Dict[str, Tuple[int, ...]], specs: Dict[str, ParamSpec],
                groups: Dict[str, Group], width_rate: float,
                label_mask: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Aggregation-time contribution masks (width x label split)."""
    return {k: param_mask(tuple(s), specs[k], groups, width_rate, label_mask)
            for k, s in params_shapes.items()}
