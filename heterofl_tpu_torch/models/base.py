"""Model base class and init helpers.

Port of ``heterofl_tpu/models/base.py``.  A model is an ``nn.Module`` whose
parameters are named exactly as the reference's param-dict keys
(``conv1.w``, ``layer0.0.n1.g``, ``linear.b``, ...) and stored in PyTorch
layout (OIHW conv, ``[out, in]`` linear; see :mod:`..convert`).  The
forward takes an optional ``params`` dict of tensors with those names, so
the round engine can run it on views of a flat buffer without copying them
into the module.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .spec import Group, ParamSpec


class Holder(nn.Module):
    """A leaf module holding named parameters of the given shapes."""

    def __init__(self, **shapes: Tuple[int, ...]):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))


class FedModel(nn.Module):
    """Common surface of the vision models: ``specs``, ``groups``,
    ``meta``, :meth:`params` and the training forward."""

    specs: Dict[str, ParamSpec]
    groups: Dict[str, Group]

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def init_(self, generator: torch.Generator) -> "FedModel":
        """Fill every parameter from ``generator`` (sorted-name order):
        torch's default uniform(+-1/sqrt(fan_in)) for weights and conv
        biases, zeros for the classifier bias, ones/zeros for norm scale and
        shift (ref models/utils.py:4-10)."""
        with torch.no_grad():
            for name, p in sorted(self.named_parameters()):
                fan_in = self.fan_in(name, tuple(p.shape))
                if fan_in is None:
                    p.fill_(1.0 if name.endswith(".g") else 0.0)
                else:
                    bound = 1.0 / math.sqrt(fan_in)
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
        return self

    def fan_in(self, name: str, shape: Tuple[int, ...]) -> Optional[int]:
        """Fan-in of a uniformly initialised parameter, or None for a
        constant-initialised one."""
        if name.endswith(".w"):
            return shape[1] * shape[2] * shape[3] if len(shape) == 4 else shape[1]
        return None
