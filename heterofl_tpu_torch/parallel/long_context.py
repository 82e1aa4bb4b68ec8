"""Sequence-parallel (long-context) masked-LM training on the data axis.

Port of ``heterofl_tpu/parallel/long_context.py`` (``SeqParallelLM``).  The
window of ``cfg['bptt']`` positions is split over the data axis of a
:class:`~.mesh.Mesh` (``bptt % data == 0``): each rank embeds its own
positions (``pos_offset``), its attention is exact ring attention
(:func:`~.ring_attention.ring_attention`, the key/value blocks shifted
round the data group), and each encoder layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so
activation memory stays O(S_local).  The batch rows are split over the
clients axis (rank ``c`` takes its block of the ``N`` rows).  A step's
gradients, loss sum and position count are all-reduced over the world in
one collective, divided by the global count, then clipped to norm 1 and
applied by the configured optimizer (``utils.optim.make_optimizer``).

Draws: a step's corruption (and dropout) are drawn over the whole window
from ``gen`` on every rank and sliced (``models/transformer.py``), or
handed in through ``draws`` (whole-window ``{"corrupt": [N, bptt]}``);
the reference draws each rank's from ``fold_in(key, d)`` instead.
Params are a dict of tensors in the port's layout (``convert.
params_from_jax`` for the reference's).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models import make_model
from ..utils.optim import clip_by_global_norm, make_optimizer
from .mesh import Mesh
from .ring_attention import ring_attention

Params = Dict[str, torch.Tensor]


class SeqParallelLM:
    """The forward and the train step of a sequence-split transformer;
    ``cfg['bptt']`` is the FULL window, split over ``mesh``'s data axis."""

    def __init__(self, cfg: Dict[str, Any], mesh: Mesh, model_rate: Optional[float] = None,
                 dense: bool = False):
        """``dense``: the model's own dense attention instead of the ring
        (a data axis of 1 only; the yardstick the ring is held against)."""
        self.cfg, self.mesh = cfg, mesh
        self.n_seq = mesh.data_size
        if dense and self.n_seq > 1:
            raise ValueError(f"dense attention holds the whole window: data axis of "
                             f"{self.n_seq}, not 1")
        self._attn = None if dense else self._ring
        if cfg["bptt"] % self.n_seq:
            raise ValueError(f"data axis size ({self.n_seq}) must divide bptt={cfg['bptt']} "
                             f"for sequence-parallel LM rounds")
        self.model = make_model(cfg, model_rate).to(mesh.device)
        self._opt_init, self._opt_update = make_optimizer(cfg)

    def init(self, gen: torch.Generator) -> Params:
        """Fresh params from ``gen`` (``Transformer.init_``), on the mesh's
        device."""
        self.model.init_(gen)
        return {k: v.detach().clone().to(self.mesh.device)
                for k, v in self.model.named_parameters()}

    def init_opt(self, params: Params):
        return self._opt_init(params)

    def _ring(self, q, k, v, temp):
        return ring_attention(q, k, v, self.mesh, temp)

    def _local(self, params: Params, labels: torch.Tensor, w: Optional[torch.Tensor],
               gen: Optional[torch.Generator], draws, train: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's ``(loss sum, position count)``: its block of the rows
        (clients axis) at its positions (data axis)."""
        N, S_full = labels.shape
        lo, hi = self.mesh.block(N)
        s_loc = S_full // self.n_seq
        off = self.mesh.data_rank * s_loc
        if w is None:
            w = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        if draws is not None:
            draws = {k: (v[lo:hi] if k == "corrupt" else {s: m[lo:hi] for s, m in v.items()})
                     for k, v in draws.items()}
        w_loc = w[lo:hi, off:off + s_loc]
        _, loss = self.model(labels[lo:hi, off:off + s_loc], params=params, sample_weight=w_loc,
                             train=train, gen=gen, draws=draws, pos_offset=off, seq_full=S_full,
                             attn=self._attn, remat=train)
        n_loc = w_loc.sum()
        return loss * n_loc, n_loc

    def forward(self, params: Params, labels: torch.Tensor, gen: Optional[torch.Generator] = None,
                w: Optional[torch.Tensor] = None, draws=None) -> torch.Tensor:
        """The global weighted-mean masked-LM loss over a ``[N, bptt]``
        batch (every rank holds the whole batch and takes its part), in
        evaluation mode; one all-reduce over the world."""
        with torch.no_grad():
            lsum, n_loc = self._local(params, labels, w, gen, draws, train=False)
            lsum, n = self.mesh.all_reduce_sum([torch.stack([lsum, n_loc])], axis="world")[0]
        return lsum / n.clamp_min(1e-6)

    def train_step(self, params: Params, opt, labels: torch.Tensor, lr: float,
                   gen: Optional[torch.Generator] = None, w: Optional[torch.Tensor] = None,
                   draws=None) -> Tuple[Params, Any, torch.Tensor]:
        """One optimizer step on a ``[N, bptt]`` batch -> ``(params, opt
        state, global mean loss)``: the gradients and ``[loss sum, count]``
        all-reduced over the world in one collective, divided by the
        global count, clipped to norm 1, then the optimizer's update."""
        names = sorted(params)
        leaves = {k: params[k].detach().requires_grad_() for k in names}
        lsum, n_loc = self._local(leaves, labels, w, gen, draws, train=True)
        grads = torch.autograd.grad(lsum, [leaves[k] for k in names])
        flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack([lsum.detach(), n_loc])])
        flat = self.mesh.all_reduce_sum([flat], axis="world")[0]
        lsum, n = flat[-2], flat[-1]
        denom = n.clamp_min(1e-6)
        red, off = {}, 0
        for k, g in zip(names, grads):
            red[k] = flat[off:off + g.numel()].view(g.shape) / denom
            off += g.numel()
        red, _ = clip_by_global_norm(red, 1.0)
        new_p, opt = self._opt_update({k: params[k].detach() for k in names}, red, opt, lr)
        return new_p, opt, lsum / denom
