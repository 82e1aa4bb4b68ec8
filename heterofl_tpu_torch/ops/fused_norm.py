"""Train-time batch norm through hand-written CUDA kernels.

Port of ``heterofl_tpu/ops/pallas_norm.py`` (the Pallas TPU kernels
``_bn_fwd_kernel``/``_bn_bwd_kernel``, entry ``batch_norm_pallas``).  The
kernels are ``csrc/bn.cu``; beside each is its plain PyTorch version
(:func:`bn_fwd_plain`, :func:`bn_bwd_plain`) with the same arithmetic, and
a launch counter (:data:`LAUNCHES`, one per wrapper call that launches the
kernel pair).

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises -- there is no fallback on the
card.  The gradient is a ``torch.autograd.Function`` whose backward is the
backward kernel; it saves ``(x2, w, g, stats)``, the reference's residuals.

Semantics (pallas_norm.py:45-109): per-channel weighted moments over all
rows in the ONE-pass form ``var = max(s2/n - mean^2, 0)``; rows whose
sample weight is not positive are excluded from the sums by a select, not
by multiplying, so a non-finite value in such a row does not reach the
statistics; ``y = (x - mean) * inv * g + b`` with ``inv = 1/sqrt(var +
eps)``.  ``stats`` is ``[3, C]`` (mean, inv, n).  The sample-weight
gradient is zero, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

#: kernel-pair launches per wrapper (CUDA only; the plain versions do not count)
LAUNCHES = {"bn_fwd": 0, "bn_bwd": 0}


def _row_weight(w: torch.Tensor, P: int) -> torch.Tensor:
    return w.repeat_interleave(P).unsqueeze(1)  # [M, 1]


def bn_fwd_plain(x2: torch.Tensor, w: torch.Tensor, P: int, g: torch.Tensor,
                 b: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: ``x2 [M, C]``, per-sample
    weight ``w [M // P]`` -> ``(y2 [M, C], stats [3, C])``."""
    wr = _row_weight(w, P)
    xs = torch.where(wr > 0, x2, torch.zeros((), dtype=x2.dtype, device=x2.device))
    s1 = (xs * wr).sum(0)
    s2 = (xs * xs * wr).sum(0)
    n = wr.sum().clamp_min(1e-6)
    mean = s1 / n
    var = (s2 / n - mean * mean).clamp_min(0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    y2 = (x2 - mean) * inv * g + b
    return y2, torch.stack([mean, inv, n.expand_as(mean)])


def bn_bwd_plain(x2: torch.Tensor, w: torch.Tensor, P: int, g: torch.Tensor,
                 dy2: torch.Tensor, stats: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel -> ``(dx2, dg, db)``."""
    mean, inv, n = stats[0], stats[1], stats[2].clamp_min(1e-6)
    wr = _row_weight(w, P)
    xhat = (x2 - mean) * inv
    db = dy2.sum(0)
    dg = (dy2 * xhat).sum(0)
    dx2 = inv * g * dy2 - wr * (inv / n) * (g * db) - wr * xhat * (inv / n) * (g * dg)
    return dx2, dg, db


def bn_fwd_cuda(x2, w, P: int, g, b, eps: float = 1e-5):
    """The forward kernel pair (``csrc/bn.cu``) on CUDA tensors."""
    _build.require_cuda("bn_fwd", x2, w, g, b)
    lib = _build.load()
    M, C = x2.shape
    y2 = torch.empty_like(x2)
    stats = torch.empty((3, C), dtype=torch.float32, device=x2.device)
    part = torch.empty(lib.hfl_bn_scratch_floats(M, C), dtype=torch.float32, device=x2.device)
    _build.check(lib.hfl_bn_fwd(x2.data_ptr(), w.data_ptr(), P, g.data_ptr(), b.data_ptr(),
                                y2.data_ptr(), stats.data_ptr(), part.data_ptr(), M, C,
                                float(eps), _build.stream_of(x2)), "bn_fwd")
    LAUNCHES["bn_fwd"] += 1
    return y2, stats


def bn_bwd_cuda(x2, w, P: int, g, dy2, stats):
    """The backward kernel pair (``csrc/bn.cu``) on CUDA tensors."""
    _build.require_cuda("bn_bwd", x2, w, g, dy2, stats)
    lib = _build.load()
    M, C = x2.shape
    dx2 = torch.empty_like(x2)
    dg = torch.empty(C, dtype=torch.float32, device=x2.device)
    db = torch.empty(C, dtype=torch.float32, device=x2.device)
    part = torch.empty(lib.hfl_bn_scratch_floats(M, C), dtype=torch.float32, device=x2.device)
    _build.check(lib.hfl_bn_bwd(x2.data_ptr(), w.data_ptr(), P, g.data_ptr(), dy2.data_ptr(),
                                stats.data_ptr(), dx2.data_ptr(), dg.data_ptr(), db.data_ptr(),
                                part.data_ptr(), M, C, _build.stream_of(x2)), "bn_bwd")
    LAUNCHES["bn_bwd"] += 1
    return dx2, dg, db


def bn_fwd(x2, w, P, g, b, eps=1e-5):
    """Forward wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_fwd_plain(x2, w, P, g, b, eps)
    return bn_fwd_cuda(x2, w, P, g, b, eps)


def bn_bwd(x2, w, P, g, dy2, stats):
    """Backward wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_bwd_plain(x2, w, P, g, dy2, stats)
    return bn_bwd_cuda(x2, w, P, g, dy2, stats)


class _BatchNormRows(torch.autograd.Function):
    """Differentiable ``[M, C]`` batch norm; the gradient is the backward
    kernel (the reference's ``_bn2d`` custom VJP)."""

    @staticmethod
    def forward(ctx, x2, w, g, b, P: int, eps: float):
        y2, stats = bn_fwd(x2, w, P, g, b, eps)
        ctx.save_for_backward(x2, w, g, stats)
        ctx.P = P
        return y2

    @staticmethod
    def backward(ctx, dy2):
        x2, w, g, stats = ctx.saved_tensors
        dx2, dg, db = bn_bwd(x2, w, ctx.P, g, dy2.contiguous(), stats)
        return dx2, None, dg, db, None, None


def batch_norm_fused(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     sample_weight: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics normalisation of an NCHW (channels_last) or NC
    tensor through the fused kernels.  A channels_last activation views as
    ``[N*H*W, C]`` without a copy; the output keeps that layout."""
    n, c = x.shape[0], x.shape[1]
    x2 = (x.permute(0, 2, 3, 1) if x.ndim == 4 else x).reshape(-1, c).contiguous()
    P = x2.shape[0] // n
    if sample_weight is None:
        w = torch.ones(n, dtype=torch.float32, device=x.device)
    else:
        w = sample_weight.to(torch.float32).contiguous()
    y2 = _BatchNormRows.apply(x2, w, g.contiguous(), b.contiguous(), P, eps)
    if x.ndim == 4:
        return y2.view(n, x.shape[2], x.shape[3], c).permute(0, 3, 1, 2)
    return y2
