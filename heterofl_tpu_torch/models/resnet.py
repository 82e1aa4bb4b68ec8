"""Pre-activation ResNets: the basic block (ResNet-18/34) and the
bottleneck (ResNet-50/101/152).

Port of ``heterofl_tpu/models/resnet.py``: scaler -> norm -> relu before
each conv, a bare 1x1 conv shortcut, final norm -> relu -> avgpool ->
linear with zero-fill label masking.  Slicing: stage channels are
prefix-sliced and chained, the shortcut's input follows conv1's input, the
classifier keeps its full output width.  A bottleneck block (expansion 4)
runs 1x1 -> 3x3 (the stride) -> 1x1; its stage's output group ``s{stage}``
is ``4 * hidden`` wide and its two inner widths form their own group
``m{stage}`` of ``hidden`` channels (the reference's rule, which the
original HeteroFL lacks for ``conv3``).  :meth:`ResNet.forward_clients` is
the training forward of G clients of one dense level model at once (the
grouped engine).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..ops.layers import (channels_to_clients, conv2d, conv2d_clients, cross_entropy,
                          cross_entropy_clients, global_avg_pool, linear, linear_clients,
                          masked_logits, masked_logits_clients, scaler)
from .base import FedModel, Holder
from .norms import apply_norm, apply_norm_clients, check_norm, norm_has_params
from .spec import Group, ParamSpec


class ResNet(FedModel):
    def __init__(self, data_shape, hidden_size, num_blocks: List[int], classes_size: int, *,
                 bottleneck: bool = False, norm: str = "bn", scale: bool = True,
                 mask: bool = True, pallas_norm: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, conv_impl: Optional[str] = None):
        super().__init__()
        check_norm(norm)
        in_ch = data_shape[-1]
        n_stages = len(hidden_size)
        exp = 4 if bottleneck else 1
        self.bottleneck = bottleneck
        self.norm, self.scale, self.mask, self.pallas_norm = norm, scale, mask, pallas_norm
        # each conv's and linear's operand dtype (None: float32) and the
        # convolution's lowering (None: direct; "im2col")
        self.compute_dtype, self.conv_impl = compute_dtype, conv_impl
        self.groups: Dict[str, Group] = {f"s{s}": Group(f"s{s}", hidden_size[s] * exp)
                                         for s in range(n_stages)}
        if bottleneck:
            self.groups.update({f"m{s}": Group(f"m{s}", hidden_size[s])
                                for s in range(n_stages)})
        self.groups["classes"] = Group("classes", classes_size, kind="full")
        self.groups["s0_stem"] = Group("s0_stem", hidden_size[0])
        self.specs: Dict[str, ParamSpec] = {}
        self.norm_sites: Dict[str, str] = {}  # site -> group
        # (prefix, stride, has_shortcut)
        self.blocks = []

        def add_norm(module, attr, site, group, size):
            if norm_has_params(norm):
                setattr(module, attr, Holder(g=(size,), b=(size,)))
                self.specs[f"{site}.g"] = ParamSpec({0: group})
                self.specs[f"{site}.b"] = ParamSpec({0: group})
            self.norm_sites[site] = group

        def add_conv(module, attr, name, out_c, in_c, ksize, out_g, in_g):
            setattr(module, attr, Holder(w=(out_c, in_c, ksize, ksize)))
            self.specs[f"{name}.w"] = ParamSpec({0: out_g, 1: in_g})

        self.conv1 = Holder(w=(hidden_size[0], in_ch, 3, 3))
        self.specs["conv1.w"] = ParamSpec({0: "s0_stem"})
        in_planes, in_group = hidden_size[0], "s0_stem"
        for s in range(n_stages):
            layer = torch.nn.ModuleList()
            planes, out_g, mid_g = hidden_size[s], f"s{s}", f"m{s}"
            for bi, stride in enumerate([1 if s == 0 else 2] + [1] * (num_blocks[s] - 1)):
                pfx = f"layer{s}.{bi}"
                has_short = stride != 1 or in_planes != planes * exp
                blk = torch.nn.Module()
                add_norm(blk, "n1", f"{pfx}.n1", in_group, in_planes)
                if bottleneck:
                    add_conv(blk, "conv1", f"{pfx}.conv1", planes, in_planes, 1, mid_g, in_group)
                    add_norm(blk, "n2", f"{pfx}.n2", mid_g, planes)
                    add_conv(blk, "conv2", f"{pfx}.conv2", planes, planes, 3, mid_g, mid_g)
                    add_norm(blk, "n3", f"{pfx}.n3", mid_g, planes)
                    add_conv(blk, "conv3", f"{pfx}.conv3", planes * exp, planes, 1, out_g, mid_g)
                else:
                    add_conv(blk, "conv1", f"{pfx}.conv1", planes, in_planes, 3, out_g, in_group)
                    add_norm(blk, "n2", f"{pfx}.n2", out_g, planes)
                    add_conv(blk, "conv2", f"{pfx}.conv2", planes, planes, 3, out_g, out_g)
                if has_short:
                    add_conv(blk, "shortcut", f"{pfx}.shortcut", planes * exp, in_planes, 1,
                             out_g, in_group)
                layer.append(blk)
                self.blocks.append((pfx, stride, has_short))
                in_planes, in_group = planes * exp, out_g
            self.add_module(f"layer{s}", layer)
        add_norm(self, "n4", "n4", f"s{n_stages-1}", in_planes)
        self.linear = Holder(w=(classes_size, in_planes), b=(classes_size,))
        self.specs["linear.w"] = ParamSpec({1: f"s{n_stages-1}"}, label_axis=0)
        self.specs["linear.b"] = ParamSpec({}, label_axis=0)
        self.meta = {"kind": "resnet", "hidden_size": list(hidden_size),
                     "classes_size": classes_size, "expansion": exp}

    def forward(self, img, label, *, params=None, width_rate: float = 1.0,
                scaler_rate: float = 1.0, label_mask=None, sample_weight=None,
                bn_mode: str = "batch", bn_state=None, bn_collect=None):
        """Forward on an NCHW (channels_last) batch -> ``(score [N,
        classes], mean loss)``; ``width_rate``, ``bn_mode``, ``bn_state`` and
        ``bn_collect`` as in :meth:`~.conv.ConvNet.forward`."""
        P = params if params is not None else self.params()

        def norm_site(site, x):
            y, st = apply_norm(self.norm, x, P.get(f"{site}.g"), P.get(f"{site}.b"),
                               sample_weight=sample_weight, use_fused=self.pallas_norm,
                               bn_mode=bn_mode,
                               bn_running=None if bn_state is None else bn_state.get(site),
                               group_ops=self.group_ops(self.norm_sites[site], width_rate,
                                                        x.device))
            if st is not None and bn_collect is not None:
                bn_collect[site] = st
            return y

        def sc(x):
            return scaler(x, scaler_rate) if self.scale else x

        def conv(x, name, stride, padding):
            return conv2d(x, P[f"{name}.w"], stride=stride, padding=padding,
                          compute_dtype=self.compute_dtype, impl=self.conv_impl)

        x = conv(img, "conv1", 1, 1)
        for pfx, stride, has_short in self.blocks:
            out = torch.relu(norm_site(f"{pfx}.n1", sc(x)))
            short = conv(out, f"{pfx}.shortcut", stride, 0) if has_short else x
            if self.bottleneck:
                out = conv(out, f"{pfx}.conv1", 1, 0)
                out = torch.relu(norm_site(f"{pfx}.n2", sc(out)))
                out = conv(out, f"{pfx}.conv2", stride, 1)
                out = torch.relu(norm_site(f"{pfx}.n3", sc(out)))
                out = conv(out, f"{pfx}.conv3", 1, 0)
            else:
                out = conv(out, f"{pfx}.conv1", stride, 1)
                out = conv(torch.relu(norm_site(f"{pfx}.n2", sc(out))), f"{pfx}.conv2", 1, 1)
            x = out + short
        x = torch.relu(norm_site("n4", sc(x)))
        out = linear(global_avg_pool(x), P["linear.w"], P["linear.b"], self.compute_dtype)
        out = masked_logits(out, label_mask, self.mask)
        return out, cross_entropy(out, label, sample_weight)

    def forward_clients(self, img, label, G: int, *, params, scaler_rate: float = 1.0,
                        label_mask=None, sample_weight=None):
        """Training forward of G clients at once; arguments and results as
        in :meth:`~.conv.ConvNet.forward_clients`."""
        P = params

        def norm_site(site, x):
            return apply_norm_clients(self.norm, x, P.get(f"{site}.g"), P.get(f"{site}.b"), G,
                                      sample_weight, self.pallas_norm,
                                      self.clients_onehot(x.shape[1] // G, G, x.device))

        def sc(x):
            return scaler(x, scaler_rate) if self.scale else x

        def conv(x, name, stride, padding):
            return conv2d_clients(x, P[f"{name}.w"], None, G, stride=stride, padding=padding,
                                  compute_dtype=self.compute_dtype, impl=self.conv_impl)

        x = conv(img, "conv1", 1, 1)
        for pfx, stride, has_short in self.blocks:
            out = torch.relu(norm_site(f"{pfx}.n1", sc(x)))
            short = conv(out, f"{pfx}.shortcut", stride, 0) if has_short else x
            if self.bottleneck:
                out = conv(out, f"{pfx}.conv1", 1, 0)
                out = torch.relu(norm_site(f"{pfx}.n2", sc(out)))
                out = conv(out, f"{pfx}.conv2", stride, 1)
                out = torch.relu(norm_site(f"{pfx}.n3", sc(out)))
                out = conv(out, f"{pfx}.conv3", 1, 0)
            else:
                out = conv(out, f"{pfx}.conv1", stride, 1)
                out = conv(torch.relu(norm_site(f"{pfx}.n2", sc(out))), f"{pfx}.conv2", 1, 1)
            x = out + short
        x = torch.relu(norm_site("n4", sc(x)))
        out = linear_clients(channels_to_clients(global_avg_pool(x), G), P["linear.w"],
                             P["linear.b"], self.compute_dtype)
        out = masked_logits_clients(out, label_mask, self.mask)
        return out, cross_entropy_clients(out, label, sample_weight)
