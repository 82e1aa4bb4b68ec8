"""Masked primitive layers.

Port of ``heterofl_tpu/ops/layers.py`` for the vision path.  A HeteroFL
sub-model is a prefix slice of the global tensors, so running the full-width
model with the suffix channels held at zero is the sliced sub-model's math;
every op here is per channel or masks its statistics.

Conventions (PyTorch's, where the reference's are NHWC / HWIO / ``[in,
out]``): activations are NCHW-shaped and channels_last in memory, so an
activation views as ``[N*H*W, C]`` without a copy; conv weights are OIHW;
linear weights are ``[out, in]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 1) -> torch.Tensor:
    """3x3 / 1x1 convolution, NCHW x OIHW -> NCHW.  A plain large product
    that the reference leaves to XLA, so it goes to ``F.conv2d`` here.

    On the CPU the input is made NCHW-contiguous first: the oneDNN backward
    of a strided 1x1 convolution on a channels_last input corrupts the heap
    in PyTorch 2.13's CPU build (the ResNet shortcut), and the CPU path is
    the tests' only."""
    if x.device.type == "cpu":
        x = x.contiguous()
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, w, b)


def scaler(x: torch.Tensor, rate) -> torch.Tensor:
    """HeteroFL Scaler at training time: ``x / rate``."""
    return x / rate


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2) with floor semantics."""
    return F.max_pool2d(x, 2)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) + flatten: NCHW -> NC."""
    return x.mean(dim=(2, 3))


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (ndim - 2))


def batch_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               sample_weight: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics normalisation (mode ``"batch"``) of an NCHW or NC
    tensor, in the reference's two-pass form (layers.py:173-193): mean, then
    the centred variance, both weighted by ``sample_weight`` when given.

    Zero-weight samples are excluded by multiplying, as in the reference, so
    a non-finite value there reaches the statistics; the fused kernel path
    (ops/fused_norm.py) excludes them with a select instead."""
    axes = (0,) + tuple(range(2, x.ndim))
    if sample_weight is None:
        n = float(x.numel() // x.shape[1])
        mean = x.sum(dim=axes, keepdim=True) / n
        var = ((x - mean) ** 2).sum(dim=axes, keepdim=True) / n
    else:
        w = sample_weight.reshape((-1,) + (1,) * (x.ndim - 1)).expand(x.shape)
        n = w.sum(dim=axes, keepdim=True)
        d = n.clamp_min(1e-6)  # all-padding batches: zero statistics, not NaN
        mean = (x * w).sum(dim=axes, keepdim=True) / d
        var = (w * (x - mean) ** 2).sum(dim=axes, keepdim=True) / d
    return (x - mean) / torch.sqrt(var + eps) * _channel_view(g, x.ndim) + _channel_view(b, x.ndim)


def masked_logits(out: torch.Tensor, label_mask: Optional[torch.Tensor],
                  enabled: bool) -> torch.Tensor:
    """Zero-fill logits of classes outside the client's label set (zero, not
    -inf, as the reference)."""
    if label_mask is None or not enabled:
        return out
    return torch.where(label_mask == 0, torch.zeros((), dtype=out.dtype, device=out.device), out)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy over the last axis; ``sample_weight`` makes it the
    weighted mean ``sum(nll * w) / max(sum(w), 1e-12)``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    if sample_weight is None:
        return nll.mean()
    return (nll * sample_weight).sum() / sample_weight.sum().clamp_min(1e-12)
