"""Masked primitive layers.

Port of ``heterofl_tpu/ops/layers.py`` for the vision and transformer
paths (and of the instance norm of ``heterofl_tpu/models/norms.py``).  A HeteroFL
sub-model is a prefix slice of the global tensors, so running the full-width
model with the suffix channels held at zero is the sliced sub-model's math;
every op here is per channel or masks its statistics.

Conventions (PyTorch's, where the reference's are NHWC / HWIO / ``[in,
out]``): activations are NCHW-shaped and channels_last in memory, so an
activation views as ``[N*H*W, C]`` without a copy; conv weights are OIHW;
linear weights are ``[out, in]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 1, compute_dtype: Optional[torch.dtype] = None,
           impl: Optional[str] = None) -> torch.Tensor:
    """3x3 / 1x1 convolution, NCHW x OIHW -> NCHW (ref ops/layers.py:29-75):
    :func:`conv2d_clients` of one client.

    ``compute_dtype`` (``torch.bfloat16``) casts both operands; the op's
    result is cast back to float32 and the bias added after that cast, in
    float32, as the reference does.  ``impl='im2col'`` computes the op as
    patch extraction plus a matmul (:func:`_im2col`); else the direct
    convolution, a plain large product that the reference leaves to XLA,
    goes to ``F.conv2d``."""
    return conv2d_clients(x, w[None], None if b is None else b[None], 1, stride, padding,
                          compute_dtype, impl)


def _out_hw(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> Tuple[int, int]:
    """The output's ``(H', W')``."""
    return tuple((n + 2 * padding - k) // stride + 1 for n, k in zip(x.shape[2:], w.shape[-2:]))


def _im2col(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """The convolution of G clients as patch extraction plus a batched
    matmul (ref ops/layers.py:52-63): ``x [B, G*C, H, W]`` (channels_last,
    client g's channels ``[g*C, (g+1)*C)``), ``w [G, O, C, kh, kw]`` ->
    ``[G, B*H'*W', O]``, rows in ``(B, H', W')`` order.

    The patches are taken from the channels-last view ``[B, H, W, G*C]``
    (padded, then ``Tensor.unfold`` over H and W, a strided view), so the
    one copy is the patch matrix ``[B*H'*W', G, C*kh*kw]`` itself, its
    features in ``(C, kh, kw)`` order -- the OIHW weight's own order, so
    ``w.reshape(G, O, C*kh*kw)`` needs no transpose; ``F.unfold`` would
    first copy a channels_last input to NCHW.  A 1x1 convolution with no
    padding is a matmul on the strided pixels, with no patch matrix."""
    G, O, C, kh, kw = w.shape
    B = x.shape[0]
    if (kh, kw) == (1, 1) and padding == 0:
        xh = x[:, :, ::stride, ::stride].permute(0, 2, 3, 1)
        patches = xh.reshape(-1, G, C)
    else:
        xh = x.permute(0, 2, 3, 1)
        if padding:
            xh = F.pad(xh, (0, 0, padding, padding, padding, padding))
        xh = xh.unfold(1, kh, stride).unfold(2, kw, stride)  # [B, H', W', G*C, kh, kw]
        patches = xh.reshape(B * xh.shape[1] * xh.shape[2], G, C * kh * kw)
    return torch.bmm(patches.transpose(0, 1), w.reshape(G, O, -1).transpose(1, 2))


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w.T + b``; ``compute_dtype`` casts both operands, the product
    goes back to float32 and the bias is added after, in float32 (ref
    ops/layers.py:78-87)."""
    if compute_dtype is None:
        return F.linear(x, w, b)
    y = F.linear(x.to(compute_dtype), w.to(compute_dtype)).to(torch.float32)
    return y if b is None else y + b


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids``."""
    return table[ids]


def scaler(x: torch.Tensor, rate, train: bool = True) -> torch.Tensor:
    """HeteroFL Scaler: ``x / rate`` in training, identity in evaluation."""
    return x / rate if train else x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2) with floor semantics."""
    return F.max_pool2d(x, 2)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) + flatten: NCHW -> NC."""
    return x.mean(dim=(2, 3))


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (ndim - 2))


def batch_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               sample_weight: Optional[torch.Tensor] = None, eps: float = 1e-5,
               mode: str = "batch",
               running: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Static batch norm (momentum=None, per channel) of an NCHW or NC
    tensor -> ``(y, stats or None)``, the reference's ``mode``s
    (layers.py:112-197):

    * ``"batch"``: normalise with batch statistics in the two-pass form --
      mean, then the centred variance, both weighted by ``sample_weight``
      when given;
    * ``"running"``: normalise with ``running = (mean, var)`` (evaluation
      after sBN recalibration);
    * ``"collect"``: as ``"batch"``, and return ``(mean, var * n / max(n -
      1, 1))`` -- the unbiased variance, ``n`` the (weighted) count per
      channel -- for the cumulative average of sBN.

    Zero-weight samples are excluded by multiplying, as in the reference, so
    a non-finite value there reaches the statistics; the fused kernel path
    (ops/fused_norm.py) excludes them with a select instead."""
    if mode == "running":
        mean, var = running
        y = (x - _channel_view(mean, x.ndim)) / torch.sqrt(_channel_view(var, x.ndim) + eps)
        return y * _channel_view(g, x.ndim) + _channel_view(b, x.ndim), None
    if mode not in ("batch", "collect"):
        raise ValueError(f"Not valid batch_norm mode: {mode!r} (batch | running | collect)")
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
    y = (x - mean) / torch.sqrt(var + eps) * _channel_view(g, x.ndim) + _channel_view(b, x.ndim)
    if mode == "collect":
        unbiased = var * n / torch.clamp_min(torch.as_tensor(n) - 1, 1)
        return y, (mean.reshape(-1), unbiased.reshape(-1))
    return y, None


def instance_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5
                  ) -> torch.Tensor:
    """GroupNorm(C, C) of an NCHW tensor: per sample and channel, the mean
    and biased variance over the spatial axes (ref models/norms.py:51-56).
    Unmasked: a masked channel is zero in ``x``, ``g`` and ``b``, so it
    stays zero."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * _channel_view(g, 4) + _channel_view(b, 4)


def group_onehot(C: int, num_groups: int, mask: torch.Tensor, k: int) -> torch.Tensor:
    """``[C, G]`` channel-to-group assignment of :func:`dynamic_group_norm`
    at ``k`` active channels: channel ``c`` to group ``min(c * G // k, G -
    1)``, masked channels to none."""
    gid = ((torch.arange(C, device=mask.device) * num_groups) // max(int(k), 1)
           ).clamp(0, num_groups - 1)
    return F.one_hot(gid, num_groups).to(torch.float32) * mask[:, None]


def dynamic_group_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, num_groups: int,
                       mask: torch.Tensor, k: int, eps: float = 1e-5,
                       onehot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm(G) of an NCHW tensor whose group boundaries follow the
    ``k`` active channels (ref ops/layers.py:216-249): a sliced sub-model
    with ``k`` channels splits them into G contiguous groups of ``k / G``,
    so the full-width op assigns channel ``c`` to group ``floor(c G / k)``
    and takes masked statistics per sample and group over (channels, H,
    W).  ``num_groups=1`` is the layer norm over CHW.  ``mask`` is the
    channels' 0/1 activity ``[C]`` on ``x``'s device; ``onehot`` the
    :func:`group_onehot` of (C, G, mask, k), when the caller keeps it."""
    C = x.shape[1]
    if onehot is None:
        onehot = group_onehot(C, num_groups, mask, k)
    spatial = x.shape[2] * x.shape[3]
    n_per_group = (onehot.sum(0) * spatial).clamp_min(1.0)           # [G]
    mc = _channel_view(mask, 4)
    xm = x * mc
    mean_g = torch.einsum("nchw,cg->ng", xm, onehot) / n_per_group    # [N, G]
    mean_c = (mean_g @ onehot.t())[:, :, None, None]                  # [N, C, 1, 1]
    d = (xm - mean_c) * mc
    var_g = torch.einsum("nchw,cg->ng", d * d, onehot) / n_per_group
    var_c = (var_g @ onehot.t())[:, :, None, None]
    y = d / torch.sqrt(var_c + eps) * _channel_view(g, 4) + _channel_view(b, 4)
    return y * mc


def masked_layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                      k: float, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis counting only the ``k = sum(mask)``
    active dims (the biased variance, ``eps`` 1e-5: ``nn.LayerNorm`` at full
    width).  ``g``/``b`` are zero at masked dims, which zeroes the output
    there."""
    xm = x * mask
    mean = xm.sum(-1, keepdim=True) / k
    var = (mask * (xm - mean) ** 2).sum(-1, keepdim=True) / k
    return (xm - mean) / torch.sqrt(var + eps) * g + b


def masked_logits(out: torch.Tensor, label_mask: Optional[torch.Tensor],
                  enabled: bool) -> torch.Tensor:
    """Zero-fill logits of classes outside the client's label set (zero, not
    -inf, as the reference)."""
    if label_mask is None or not enabled:
        return out
    return torch.where(label_mask == 0, torch.zeros((), dtype=out.dtype, device=out.device), out)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy, the class axis last (``[N, C]`` or the
    transformer's ``[N, S, C]``); ``sample_weight`` of the labels' shape
    (per sample, or per position ``[N, S]``) makes it the weighted mean
    ``sum(nll * w) / max(sum(w), 1e-12)``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    if sample_weight is None:
        return nll.mean()
    return (nll * sample_weight).sum() / sample_weight.sum().clamp_min(1e-12)


# -- the clients axis: a level's G clients batched through one dense model ---
#
# Activations hold the clients in the channels, ``[B, G*C, H, W]``
# channels_last (client g's channels are ``[g*C, (g+1)*C)``), so a batch norm
# site views them as rows ``[B*H*W, G*C]``; a parameter leaf holds the G
# clients' copies contiguously, ``[G, *shape]``.


def clients_in_channels(x: torch.Tensor) -> torch.Tensor:
    """``[G, B, H, W, C]`` channels-last images of G clients -> the
    clients-in-channels NCHW view ``[B, G*C, H, W]`` (channels_last memory)."""
    G, B, H, W, C = x.shape
    return x.permute(1, 2, 3, 0, 4).reshape(B, H, W, G * C).permute(0, 3, 1, 2)


def conv2d_clients(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], G: int,
                   stride: int = 1, padding: int = 1,
                   compute_dtype: Optional[torch.dtype] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Each client's convolution at once: ``x [B, G*I, H, W]``, ``w [G, O,
    I, k, k]``, ``b [G, O]`` -> ``[B, G*O, H', W']`` (channels_last).
    Direct: one grouped convolution (``groups=G``) whose group g is client
    g.  ``impl='im2col'``: the patches extracted once for all G clients and
    each client's multiplied by its own weights in one batched matmul (ref
    ops/layers.py:39-48, the op under ``vmap``).  ``compute_dtype`` as in
    :func:`conv2d`.

    On the CPU the direct convolution's input is made NCHW-contiguous first:
    the oneDNN backward of a strided 1x1 convolution on a channels_last
    input corrupts the heap in PyTorch 2.13's CPU build (the ResNet
    shortcut), and the CPU path is the tests' only."""
    bias = None if b is None else b.reshape(-1)
    if compute_dtype is None and impl is None:
        if x.device.type == "cpu":
            x = x.contiguous()
        return F.conv2d(x, w.reshape((-1,) + tuple(w.shape[2:])), bias, stride=stride,
                        padding=padding, groups=G)
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    if impl == "im2col":
        y = _im2col(x, w, stride, padding)  # [G, B*H'*W', O]
        y = y.transpose(0, 1).reshape(x.shape[0], *_out_hw(x, w, stride, padding), -1)
        y = y.permute(0, 3, 1, 2)
    else:
        if x.device.type == "cpu":
            x = x.contiguous()
        y = F.conv2d(x, w.reshape((-1,) + tuple(w.shape[2:])), stride=stride, padding=padding,
                     groups=G)
    if compute_dtype is not None:
        y = y.to(torch.float32)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


def linear_clients(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Each client's linear layer: ``x [G, ..., I]``, ``w [G, O, I]``, ``b
    [G, O]`` -> ``[G, ..., O]`` (one batched product); ``compute_dtype``
    as in :func:`linear`."""
    G, lead = x.shape[0], x.shape[1:-1]
    x3 = x.reshape(G, -1, x.shape[-1])
    if compute_dtype is not None:
        out = torch.bmm(x3.to(compute_dtype), w.to(compute_dtype).transpose(1, 2))
        out = out.to(torch.float32)
        if b is not None:
            out = out + b.unsqueeze(1)
    elif b is None:
        out = torch.bmm(x3, w.transpose(1, 2))
    else:
        out = torch.baddbmm(b.unsqueeze(1), x3, w.transpose(1, 2))
    return out.reshape((G,) + tuple(lead) + (w.shape[1],))


def channels_to_clients(x: torch.Tensor, G: int) -> torch.Tensor:
    """``[B, G*C]`` features -> ``[G, B, C]``."""
    B = x.shape[0]
    return x.reshape(B, G, -1).transpose(0, 1)


def masked_logits_clients(out: torch.Tensor, label_mask: Optional[torch.Tensor],
                          enabled: bool) -> torch.Tensor:
    """:func:`masked_logits` per client: ``out [G, ..., K]``, ``label_mask
    [G, K]``."""
    if label_mask is None or not enabled:
        return out
    lm = label_mask.reshape((label_mask.shape[0],) + (1,) * (out.ndim - 2) + (-1,))
    return torch.where(lm == 0, torch.zeros((), dtype=out.dtype, device=out.device), out)


def cross_entropy_clients(logits: torch.Tensor, labels: torch.Tensor,
                          sample_weight: torch.Tensor) -> torch.Tensor:
    """:func:`cross_entropy` per client -> ``[G]``: ``logits [G, ..., K]``,
    ``labels`` and ``sample_weight [G, ...]``; client g's weighted mean
    over its own samples (or positions)."""
    G = logits.shape[0]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    w = sample_weight.reshape(G, -1)
    return (nll.reshape(G, -1) * w).sum(1) / w.sum(1).clamp_min(1e-12)


def batch_norm_clients(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                       sample_weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """:func:`batch_norm`'s ``"batch"`` mode per client (the two-pass
    form): ``x [B, G*C, H, W]``, ``g``/``b [G, C]``, ``sample_weight [G,
    B]``; client g's statistics over its own weighted samples."""
    G, B = sample_weight.shape
    xv = x.reshape(B, G, -1, *x.shape[2:])
    view = (1, G, -1) + (1,) * (x.ndim - 2)
    w = sample_weight.t().reshape((B, G) + (1,) * (x.ndim - 1)).expand(xv.shape)
    axes = (0,) + tuple(range(3, xv.ndim))
    n = w.sum(dim=axes, keepdim=True)
    d = n.clamp_min(1e-6)
    mean = (xv * w).sum(dim=axes, keepdim=True) / d
    var = (w * (xv - mean) ** 2).sum(dim=axes, keepdim=True) / d
    y = (xv - mean) / torch.sqrt(var + eps) * g.reshape(view) + b.reshape(view)
    return y.reshape(x.shape)


def group_onehot_clients(C: int, num_groups: int, G: int, device) -> torch.Tensor:
    """Block-diagonal ``[G*C, G*num_groups]`` channel-to-group map of G
    clients of ``C`` channels each, all active: client g's channels go to
    its own groups only, so no group straddles two clients."""
    one = group_onehot(C, num_groups, torch.ones(C, device=device), C)
    return torch.block_diag(*([one] * G))
