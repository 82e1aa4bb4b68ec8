"""Ring attention: exact attention over a sequence split on the data axis.

Port of ``heterofl_tpu/parallel/ring_attention.py``.  Each rank of a data
group holds its positions' queries, keys and values ``[..., S_local, d]``;
the key/value blocks travel round the ring (:meth:`~.mesh.Mesh.ring_shift`:
to data rank ``d + 1``, from ``d - 1``) while each rank folds them into the
online-softmax accumulator ``(o, m, l)`` of its queries, the blockwise
(flash) form of ``softmax(q k^T / temperature) v`` over the whole
sequence -- bidirectional, as the masked LM's attention is.

The gradient is a ``torch.autograd.Function`` that reproduces the
gradient of the reference's ring (``jax.grad`` through its ``ppermute``s):
each block's probabilities are recomputed from the saved row maxima and
sums ``(m, l)``, ``dq`` accumulates on its rank, and ``dk`` / ``dv``
travel round the ring with their key/value block, one more shift landing
them on the rank that owns the block.  A forward makes ``n - 1`` shifts
(of ``k`` and ``v``), a backward ``n`` (of ``k``, ``v``, ``dk``, ``dv``,
the last of ``dk`` and ``dv`` alone).  Plain ``torch.matmul`` and
``exp``: the reference has no TPU kernel for attention, and the port's
dense attention is the plain chain (``models/transformer.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """``softmax(q k^T / temperature) v`` over the last two axes, on one
    rank (the reference's ``dense_attention``)."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / temperature
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def _fold(q, kb, vb, o, m, l, temperature) -> Tuple[torch.Tensor, ...]:
    """One key/value block folded into the online-softmax accumulator (ref
    ``_online_block``)."""
    s = torch.matmul(q, kb.transpose(-1, -2)) / temperature
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new.unsqueeze(-1))
    return o * alpha.unsqueeze(-1) + torch.matmul(p, vb), m_new, l * alpha + p.sum(-1)


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, temperature: float, mesh):
        n = 1 if mesh is None else mesh.data_size
        o = torch.zeros_like(q)
        m = torch.full(q.shape[:-1], float("-inf"), dtype=q.dtype, device=q.device)
        l = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
        kb, vb = k, v
        for i in range(n):
            o, m, l = _fold(q, kb, vb, o, m, l, temperature)
            if i + 1 < n:
                kb, vb = mesh.ring_shift([kb, vb])
        out = o / l.unsqueeze(-1)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.temperature, ctx.mesh, ctx.n = temperature, mesh, n
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        temp, mesh, n = ctx.temperature, ctx.mesh, ctx.n
        dout = dout.contiguous()
        delta = (dout * out).sum(-1, keepdim=True)
        dq = torch.zeros_like(q)
        kb, vb, dk, dv = k, v, torch.zeros_like(k), torch.zeros_like(v)
        for i in range(n):
            s = torch.matmul(q, kb.transpose(-1, -2)) / temp
            p = torch.exp(s - m.unsqueeze(-1)) / l.unsqueeze(-1)
            dv = dv + torch.matmul(p.transpose(-1, -2), dout)
            ds = p * (torch.matmul(dout, vb.transpose(-1, -2)) - delta)
            dq = dq + torch.matmul(ds, kb) / temp
            dk = dk + torch.matmul(ds.transpose(-1, -2), q) / temp
            if n == 1:
                break
            if i + 1 < n:  # the block and its gradients to the next rank
                kb, vb, dk, dv = mesh.ring_shift([kb, vb, dk, dv])
            else:  # the gradients home, to the rank that owns the block
                dk, dv = mesh.ring_shift([dk, dv])
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   temperature: float) -> torch.Tensor:
    """Exact (bidirectional) attention of this rank's queries over the
    whole sequence, split over ``mesh``'s data group (``parallel.mesh.
    Mesh``; None or a data axis of 1: this rank's block alone, the dense
    attention up to float association): ``q``/``k``/``v`` ``[...,
    S_local, d]`` -> ``[..., S_local, d]``."""
    return _Ring.apply(q, k, v, float(temperature), mesh)
