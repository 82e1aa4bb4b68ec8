"""Width groups and parameter slicing specs, on the port's tensor axes.

Port of ``heterofl_tpu/models/spec.py``.  A ``Group`` is a named width axis
of the global model; a client at ``width_rate`` keeps the first
``ceil(size * rate)`` entries (``prefix``) or all of them (``full``).  A
``ParamSpec`` says which group governs each axis of a parameter -- in
PyTorch layout here: a conv weight's output channels are axis 0 and its
input channels axis 1 (OIHW, where the reference's HWIO has 3 and 2), a
linear weight is ``[out, in]`` -- plus the axis restricted to the client's
label split at aggregation time.

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
    kind: str = "prefix"  # "prefix" | "full"

    def active_count(self, width_rate: float) -> int:
        if self.kind == "full":
            return self.size
        if self.kind == "prefix":
            # float32 product, as the reference computes it in-jit
            return int(math.ceil(np.float32(self.size) * np.float32(width_rate)))
        raise NotImplementedError(f"group kind {self.kind!r} is not ported")

    def mask(self, width_rate: float) -> torch.Tensor:
        """0/1 activity mask of shape ``[size]`` (CPU)."""
        m = torch.zeros(self.size, dtype=torch.float32)
        m[: self.active_count(width_rate)] = 1.0
        return m


@dataclass(frozen=True)
class ParamSpec:
    axis_groups: Dict[int, str] = field(default_factory=dict)
    label_axis: Optional[int] = None


def _axis_view(shape: Tuple[int, ...], axis: int, vec: torch.Tensor) -> torch.Tensor:
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return vec.reshape(view)


def param_mask(shape: Tuple[int, ...], spec: ParamSpec, groups: Dict[str, Group],
               width_rate: float, label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Activity mask of one parameter (product over its sliced axes); given
    ``label_mask``, the label axis is also restricted (the count mask)."""
    m = torch.ones(shape, dtype=torch.float32)
    for axis, gname in spec.axis_groups.items():
        m = m * _axis_view(shape, axis, groups[gname].mask(width_rate))
    if spec.label_axis is not None and label_mask is not None:
        vec = label_mask.detach().to("cpu", torch.float32)
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
