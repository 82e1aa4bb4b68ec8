"""The HeteroFL CNN: Conv3x3 -> Scaler -> Norm -> ReLU -> MaxPool per block
(the last pool dropped), then GlobalAvgPool -> Linear, loss in the forward.

Port of ``heterofl_tpu/models/conv.py``.  Width slicing: hidden channels are
prefix-sliced and chained; the classifier keeps its full output width and
is label-restricted at aggregation time only.  :meth:`ConvNet.
forward_clients` is the training forward of G clients of one dense level
model at once (the grouped engine; ``ops/layers.py``'s clients axis).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.layers import (channels_to_clients, conv2d, conv2d_clients, cross_entropy,
                          cross_entropy_clients, global_avg_pool, linear, linear_clients,
                          masked_logits, masked_logits_clients, max_pool2, scaler)
from .base import FedModel, Holder
from .norms import apply_norm, apply_norm_clients, check_norm, norm_has_params
from .spec import Group, ParamSpec


class ConvNet(FedModel):
    def __init__(self, data_shape, hidden_size, classes_size: int, *, norm: str = "bn",
                 scale: bool = True, mask: bool = True, pallas_norm: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, conv_impl: Optional[str] = None):
        super().__init__()
        check_norm(norm)
        in_ch = data_shape[-1]
        self.n_blocks = len(hidden_size)
        self.norm, self.scale, self.mask, self.pallas_norm = norm, scale, mask, pallas_norm
        # each conv's and linear's operand dtype (None: float32) and the
        # convolution's lowering (None: direct; "im2col")
        self.compute_dtype, self.conv_impl = compute_dtype, conv_impl
        self.groups = {f"h{i}": Group(f"h{i}", hidden_size[i]) for i in range(self.n_blocks)}
        self.groups["classes"] = Group("classes", classes_size, kind="full")
        self.specs: Dict[str, ParamSpec] = {}
        ci = in_ch
        for i, co in enumerate(hidden_size):
            block = torch.nn.Module()
            block.conv = Holder(w=(co, ci, 3, 3), b=(co,))
            in_group = {} if i == 0 else {1: f"h{i-1}"}
            self.specs[f"block{i}.conv.w"] = ParamSpec({0: f"h{i}", **in_group})
            self.specs[f"block{i}.conv.b"] = ParamSpec({0: f"h{i}"})
            if norm_has_params(norm):
                block.norm = Holder(g=(co,), b=(co,))
                self.specs[f"block{i}.norm.g"] = ParamSpec({0: f"h{i}"})
                self.specs[f"block{i}.norm.b"] = ParamSpec({0: f"h{i}"})
            self.add_module(f"block{i}", block)
            ci = co
        self.linear = Holder(w=(classes_size, hidden_size[-1]), b=(classes_size,))
        self.specs["linear.w"] = ParamSpec({1: f"h{self.n_blocks-1}"}, label_axis=0)
        self.specs["linear.b"] = ParamSpec({}, label_axis=0)
        self.meta = {"kind": "conv", "hidden_size": list(hidden_size),
                     "classes_size": classes_size}

    def fan_in(self, name: str, shape: Tuple[int, ...]) -> Optional[int]:
        if name.endswith("conv.b"):  # the conv's own fan-in (ref conv.py:58)
            w = self.get_parameter(name[:-1] + "w")
            return w.shape[1] * w.shape[2] * w.shape[3]
        return super().fan_in(name, shape)

    def forward(self, img, label, *, params=None, width_rate: float = 1.0,
                scaler_rate: float = 1.0, label_mask=None, sample_weight=None,
                bn_mode: str = "batch", bn_state=None, bn_collect=None, bn_group=None):
        """Forward on an NCHW (channels_last) batch -> ``(score [N,
        classes], mean loss)``.  ``width_rate`` gives the ``ln``/``gn`` sites
        their active channels; bn/in/none need no channel mask (masked
        channels hold ``g == b == 0``).
        ``bn_mode``/``bn_state`` pick the BN sites' mode and running
        statistics ``{site: (mean, var)}``; in ``"collect"`` mode each site's
        ``(mean, unbiased var)`` goes into the dict ``bn_collect``.
        ``bn_group`` (a mesh whose data axis splits the batch) synchronises
        the BN sites over its data group (``models/norms.py``)."""
        P = params if params is not None else self.params()
        x = img
        for i in range(self.n_blocks):
            x = conv2d(x, P[f"block{i}.conv.w"], P[f"block{i}.conv.b"],
                       compute_dtype=self.compute_dtype, impl=self.conv_impl)
            if self.scale:
                x = scaler(x, scaler_rate)
            site = f"block{i}.norm"
            x, st = apply_norm(self.norm, x, P.get(f"{site}.g"), P.get(f"{site}.b"),
                               sample_weight=sample_weight, use_fused=self.pallas_norm,
                               bn_mode=bn_mode,
                               bn_running=None if bn_state is None else bn_state.get(site),
                               group_ops=self.group_ops(f"h{i}", width_rate, x.device),
                               bn_group=bn_group)
            if st is not None and bn_collect is not None:
                bn_collect[site] = st
            x = torch.relu(x)
            if i < self.n_blocks - 1:  # last pool dropped (ref conv.py:56)
                x = max_pool2(x)
        out = linear(global_avg_pool(x), P["linear.w"], P["linear.b"], self.compute_dtype)
        out = masked_logits(out, label_mask, self.mask)
        return out, cross_entropy(out, label, sample_weight)

    def forward_clients(self, img, label, G: int, *, params, scaler_rate: float = 1.0,
                        label_mask=None, sample_weight=None, bn_group=None):
        """Training forward of G clients at once: ``img [B, G*C_in, H, W]``
        clients-in-channels, ``label``/``sample_weight [G, B]``,
        ``label_mask [G, classes]``, ``params`` leaves ``[G, *shape]`` ->
        ``(scores [G, B, classes], per-client mean loss [G])``.  ``bn_group``
        (a mesh whose data axis splits each client's batch) synchronises the
        BN sites over its data group, as in :meth:`forward`."""
        P = params
        x = img
        for i in range(self.n_blocks):
            x = conv2d_clients(x, P[f"block{i}.conv.w"], P[f"block{i}.conv.b"], G,
                               compute_dtype=self.compute_dtype, impl=self.conv_impl)
            if self.scale:
                x = scaler(x, scaler_rate)
            site = f"block{i}.norm"
            x = apply_norm_clients(self.norm, x, P.get(f"{site}.g"), P.get(f"{site}.b"), G,
                                   sample_weight, self.pallas_norm,
                                   self.clients_onehot(x.shape[1] // G, G, x.device), bn_group)
            x = torch.relu(x)
            if i < self.n_blocks - 1:
                x = max_pool2(x)
        out = linear_clients(channels_to_clients(global_avg_pool(x), G), P["linear.w"],
                             P["linear.b"], self.compute_dtype)
        out = masked_logits_clients(out, label_mask, self.mask)
        return out, cross_entropy_clients(out, label, sample_weight)
