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

from ..convert import Perms, rank_perms
from ..ops.layers import group_onehot, group_onehot_clients
from .norms import NUM_GROUPS
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

    def group_ops(self, group: str, width_rate: float, device: torch.device
                  ) -> Optional[Tuple[torch.Tensor, int, torch.Tensor]]:
        """``(mask [C], k, onehot [C, G])`` of width group ``group`` at
        ``width_rate`` on ``device``, for the masked group norms (``ln``,
        ``gn``; None for the other norms).  Built once per (group, active
        count, device) and kept, so a round copies no mask to the device
        after its first step at that width (the round engine builds every
        width's before the first round, :meth:`prepare_width`)."""
        groups = NUM_GROUPS.get(getattr(self, "norm", None))
        if groups is None:
            return None
        grp = self.groups[group]
        k = grp.active_count(width_rate)
        key = (group, k, str(device))
        cache = self.__dict__.setdefault("_group_ops", {})
        if key not in cache:
            mask = grp.mask(width_rate).to(device)
            cache[key] = (mask, k, group_onehot(grp.size, groups, mask, k))
        return cache[key]

    def clients_onehot(self, C: int, G: int, device: torch.device) -> Optional[torch.Tensor]:
        """The ``ln``/``gn`` block-diagonal channel-to-group map of G
        clients of ``C`` channels (None for the other norms), made once per
        (C, G, device) and kept."""
        groups = NUM_GROUPS.get(getattr(self, "norm", None))
        if groups is None:
            return None
        key = (C, G, str(device))
        cache = self.__dict__.setdefault("_clients_onehot", {})
        if key not in cache:
            cache[key] = group_onehot_clients(C, groups, G, device)
        return cache[key]

    def prepare_width(self, width_rate: float, device: torch.device) -> None:
        """Build every width group's :meth:`group_ops` at ``width_rate``."""
        for name in self.groups:
            self.group_ops(name, width_rate, device)

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

    def jax_perms(self) -> Perms:
        """Per leaf, the axis permutation from the port's layout to the
        reference's (``convert``): every 4-D leaf of a vision model is a
        conv kernel and every 2-D leaf a linear kernel."""
        return rank_perms({k: tuple(p.shape) for k, p in self.named_parameters()})

    def fan_in(self, name: str, shape: Tuple[int, ...]) -> Optional[int]:
        """Fan-in of a uniformly initialised parameter, or None for a
        constant-initialised one."""
        if name.endswith(".w"):
            return shape[1] * shape[2] * shape[3] if len(shape) == 4 else shape[1]
        return None
