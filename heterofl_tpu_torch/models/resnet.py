"""Pre-activation ResNet with the basic block (ResNet-18/34).

Port of ``heterofl_tpu/models/resnet.py``: scaler -> norm -> relu before
each conv, a bare 1x1 conv shortcut, final norm -> relu -> avgpool ->
linear with zero-fill label masking.  Slicing: stage channels are
prefix-sliced and chained, the shortcut's input follows conv1's input, the
classifier keeps its full output width.  The bottleneck block
(ResNet-50/101/152) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..ops.layers import conv2d, cross_entropy, global_avg_pool, linear, masked_logits, scaler
from .base import FedModel, Holder
from .norms import apply_norm, check_norm, norm_has_params
from .spec import Group, ParamSpec


class ResNet(FedModel):
    def __init__(self, data_shape, hidden_size, num_blocks: List[int], classes_size: int, *,
                 norm: str = "bn", scale: bool = True, mask: bool = True,
                 pallas_norm: bool = False):
        super().__init__()
        check_norm(norm)
        in_ch = data_shape[-1]
        n_stages = len(hidden_size)
        self.norm, self.scale, self.mask, self.pallas_norm = norm, scale, mask, pallas_norm
        self.groups: Dict[str, Group] = {f"s{s}": Group(f"s{s}", hidden_size[s])
                                         for s in range(n_stages)}
        self.groups["classes"] = Group("classes", classes_size, kind="full")
        self.groups["s0_stem"] = Group("s0_stem", hidden_size[0])
        self.specs: Dict[str, ParamSpec] = {}
        self.norm_sites: Dict[str, str] = {}  # site -> group
        # (prefix, stride, has_shortcut, in_group, out_group)
        self.blocks = []

        def add_norm(module, attr, site, group, size):
            if norm_has_params(norm):
                setattr(module, attr, Holder(g=(size,), b=(size,)))
                self.specs[f"{site}.g"] = ParamSpec({0: group})
                self.specs[f"{site}.b"] = ParamSpec({0: group})
            self.norm_sites[site] = group

        self.conv1 = Holder(w=(hidden_size[0], in_ch, 3, 3))
        self.specs["conv1.w"] = ParamSpec({0: "s0_stem"})
        in_planes, in_group = hidden_size[0], "s0_stem"
        for s in range(n_stages):
            layer = torch.nn.ModuleList()
            planes, out_g = hidden_size[s], f"s{s}"
            for bi, stride in enumerate([1 if s == 0 else 2] + [1] * (num_blocks[s] - 1)):
                pfx = f"layer{s}.{bi}"
                has_short = stride != 1 or in_planes != planes
                blk = torch.nn.Module()
                add_norm(blk, "n1", f"{pfx}.n1", in_group, in_planes)
                blk.conv1 = Holder(w=(planes, in_planes, 3, 3))
                self.specs[f"{pfx}.conv1.w"] = ParamSpec({0: out_g, 1: in_group})
                add_norm(blk, "n2", f"{pfx}.n2", out_g, planes)
                blk.conv2 = Holder(w=(planes, planes, 3, 3))
                self.specs[f"{pfx}.conv2.w"] = ParamSpec({0: out_g, 1: out_g})
                if has_short:
                    blk.shortcut = Holder(w=(planes, in_planes, 1, 1))
                    self.specs[f"{pfx}.shortcut.w"] = ParamSpec({0: out_g, 1: in_group})
                layer.append(blk)
                self.blocks.append((pfx, stride, has_short))
                in_planes, in_group = planes, out_g
            self.add_module(f"layer{s}", layer)
        add_norm(self, "n4", "n4", f"s{n_stages-1}", hidden_size[-1])
        self.linear = Holder(w=(classes_size, hidden_size[-1]), b=(classes_size,))
        self.specs["linear.w"] = ParamSpec({1: f"s{n_stages-1}"}, label_axis=0)
        self.specs["linear.b"] = ParamSpec({}, label_axis=0)
        self.meta = {"kind": "resnet", "hidden_size": list(hidden_size),
                     "classes_size": classes_size}

    def forward(self, img, label, *, params=None, width_rate: float = 1.0,
                scaler_rate: float = 1.0, label_mask=None, sample_weight=None):
        """Training forward on an NCHW (channels_last) batch ->
        ``(score [N, classes], mean loss)``."""
        P = params if params is not None else self.params()

        def norm_site(site, x):
            return apply_norm(self.norm, x, P.get(f"{site}.g"), P.get(f"{site}.b"),
                              sample_weight=sample_weight, use_fused=self.pallas_norm)

        def sc(x):
            return scaler(x, scaler_rate) if self.scale else x

        x = conv2d(img, P["conv1.w"], stride=1, padding=1)
        for pfx, stride, has_short in self.blocks:
            out = torch.relu(norm_site(f"{pfx}.n1", sc(x)))
            short = conv2d(out, P[f"{pfx}.shortcut.w"], stride=stride, padding=0) \
                if has_short else x
            out = conv2d(out, P[f"{pfx}.conv1.w"], stride=stride, padding=1)
            out = conv2d(torch.relu(norm_site(f"{pfx}.n2", sc(out))), P[f"{pfx}.conv2.w"],
                         stride=1, padding=1)
            x = out + short
        x = torch.relu(norm_site("n4", sc(x)))
        out = linear(global_avg_pool(x), P["linear.w"], P["linear.b"])
        out = masked_logits(out, label_mask, self.mask)
        return out, cross_entropy(out, label, sample_weight)
