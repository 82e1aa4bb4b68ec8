"""The grouped round engine on one GPU: each level's clients batched through
its dense sub-model.

Port of ``heterofl_tpu/parallel/grouped.py`` (``GroupedRoundEngine.
train_round``, ``level_placement='span'``, one round a dispatch).  The
masked engine (round_engine.py) trains every client at full width with
masks, one after another; this engine:

* groups the round's clients by level on the host, after snapping their
  rates onto the level table (``fed.core.snap_to_levels``; ref
  grouped.py:713-731);
* runs the levels in descending rate.  A level's G clients train together
  as ONE batched dense sub-model at the level's own widths: the sub-model
  is the global params at the level's entries (``P.index_select(0, idx)``,
  ``fed.core.level_index_map``), trained at width rate 1 with the Scaler at
  ``rate / global_rate`` (``make_model(cfg, rate)``, ref grouped.py:
  458-529).  The local loop is the masked engine's: E epochs of S steps,
  real samples sorted first, an all-padding batch gated off per client
  through the batched kernel's ``has``;
* adds each level's counted sums (each client's label restriction; inside
  its slice the width mask is all ones) into zero global buffers at the
  level's indices, levels in descending rate (the reference's ``merge``,
  grouped.py:636-639), then takes the counted average with the stale
  fallback (``combine_counted``).

Every client keeps the masked engine's stream: its generator is seeded by
``client_seed(round_seed, uid)`` and drawn in ``RoundEngine.local_train``'s
order (the epoch permutations, then each step's augmentation; an LM
client's corruption and dropout draws, at its level's widths), so grouped
equals masked up to float association (and, for the LM, up to the dropout
draws, which have the level's widths).  The reference buckets a level's
slots to powers of two to bound its compile cache (grouped.py:743); the
port has no compile cache and runs exactly the level's clients -- the
reference's padded slots add exact zeros, so the numbers are the same.

**Layout, and what it costs a step.**  A level's params, momentum and
gradient are client-major ``[G, n_l]`` buffers (each client's flat buffer
one contiguous row), which the batched fused SGD (ops/fused_update.py,
kernel 3b) needs for its per-client norm.  The batched forward needs each
leaf's G copies contiguous (a grouped convolution takes ``[G*O, I, k,
k]``), so a step first gathers the client-major params into a leaf-major
copy (one ``index_select`` over a precomputed map), and the gradients,
which autograd gives per leaf as ``[G, *shape]``, go back client-major in
the ``torch.cat`` along the rows that packs them (the masked engine's
pack).  Over the masked engine's step that is one launch more (the
gather) and ``G * n_l * 12`` bytes more (the map is int32); against it the
step makes one pass of the model for G clients, one BN launch a site a
direction for G clients (kernels 1b/2b, ops/fused_norm.py) and one SGD pair
for G clients.  A leaf-major layout would save the gather but cut each
client's row into a segment per leaf, so the SGD kernel's per-client norm
would read strided segments; the client-major one keeps 3b a plain
``(parts, G)`` grid.

The engine takes the masked engine's test hooks (``rates``,
``epoch_perms``, ``aug_draws``, ``lm_draws``) and returns the per-client
metric sums in user order (ref ``_assemble``, grouped.py:775-787).  A lossy
wire codec is refused, as the reference's K=1 round refuses it
(grouped.py:690-695): the reference compresses the grouped round only in
its fused superstep.

**Determinism.**  A round runs under cuDNN's deterministic algorithms
(``torch.backends.cudnn.deterministic``, set for the round and put back
after): cuDNN's default algorithms for the grouped convolutions' weight
gradients sum in an order that changes from run to run, which a level-e
client grows to about 3e-3 over a round, so a resumed run would not equal
an uninterrupted one.  With them it does, bit for bit, as on every other
path of the port; the headline round costs about 7% more on an H100
(PERF.md).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compress import resolve_codec_cfg
from ..fed.core import combine_counted, level_index_map, snap_to_levels
from ..models import make_model
from ..models.base import FedModel
from ..models.spec import label_vector
from ..ops.augment import augment_cifar, augment_draws, normalize_image
from ..ops.fused_update import FlatSpec, fused_sgd_batched
from ..ops.layers import clients_in_channels
from .round_engine import FlatParams, RoundEngine, client_seed, cohort_rates


class Level:
    """One level of the engine: its dense sub-model, the one-client engine
    of that sub-model (its width mask, and the per-leaf chain that
    ``fused_update=False`` runs), and the map of its flat entries into the
    global layout."""

    def __init__(self, cfg: Dict[str, Any], rate: float, global_model: FedModel,
                 global_spec: FlatSpec, device: torch.device):
        self.model = make_model(cfg, rate)
        self.scaler_rate = self.model.meta["scaler_rate"]
        # the dense sub-model trains at width rate 1: its only width mask
        level_cfg = dict(cfg, model_rate=[cfg["global_model_rate"]], model_split_mode="fix")
        self.engine = RoundEngine(self.model, level_cfg, device)
        self.spec = self.engine.spec
        self.mask = self.engine.param_mask_flat(1.0)
        self.idx = torch.from_numpy(level_index_map(
            global_spec, self.spec, global_model.specs, global_model.groups,
            self.scaler_rate)).to(device)
        self._label_axes = [(k, s.label_axis) for k, s in self.model.specs.items()
                            if s.label_axis is not None]
        self._leaf_major: Dict[int, torch.Tensor] = {}

    def leaf_major(self, G: int) -> torch.Tensor:
        """``[G * n_l]`` (int32; int64 past 2**31): for each entry of the
        leaf-major layout (leaf k's G copies contiguous, ``[G, *shape_k]``,
        leaves in order), its place in the client-major ``[G, n_l]`` buffer."""
        if G not in self._leaf_major:  # made on the device: G * n_l entries
            dev, n = self.idx.device, self.spec.total
            dt = torch.int32 if G * n < 2 ** 31 else torch.int64
            rows = torch.arange(G, dtype=dt, device=dev)[:, None] * n
            self._leaf_major[G] = torch.cat([
                (rows + torch.arange(self.spec.offsets[k], self.spec.offsets[k]
                                     + self.spec.sizes[k], dtype=dt,
                                     device=dev)).reshape(-1) for k in self.spec.names])
        return self._leaf_major[G]

    def leaves(self, flat: torch.Tensor, G: int) -> Dict[str, torch.Tensor]:
        """Leaf views ``[G, *shape]`` of a leaf-major buffer, each a leaf
        for autograd."""
        return {k: flat[G * self.spec.offsets[k]:G * (self.spec.offsets[k] + self.spec.sizes[k])]
                .view((G,) + self.spec.shapes[k]).requires_grad_() for k in self.spec.names}

    def count_masks(self, label_masks: torch.Tensor) -> torch.Tensor:
        """``[G, n_l]`` aggregation masks of G clients: ones, the label-axis
        rows restricted to each client's labels (``label_masks [G, K]``)."""
        G = label_masks.shape[0]
        cm = torch.ones((G, self.spec.total), dtype=torch.float32, device=label_masks.device)
        for k, axis in self._label_axes:
            off, shape = self.spec.offsets[k], self.spec.shapes[k]
            leaf = cm[:, off:off + self.spec.sizes[k]].view((G,) + shape)
            vec = torch.stack([label_vector(lm, shape[axis]) for lm in label_masks])
            view = [G] + [1] * len(shape)
            view[axis + 1] = shape[axis]
            leaf.mul_(vec.reshape(view))
        return cm


class GroupedRoundEngine(FlatParams):
    """Local training and counted aggregation of one round, each level's
    clients batched, for one (global model, cfg, device)."""

    def __init__(self, model: FedModel, cfg: Dict[str, Any], device: torch.device):
        resolve_codec_cfg(dict(cfg, strategy="grouped"))  # a lossy codec is refused
        self.model, self.cfg, self.device = model, cfg, device
        self.is_lm = model.meta["kind"] == "transformer"
        self.spec = FlatSpec.of(dict(model.named_parameters()))
        self.levels: Dict[float, Level] = {
            rate: Level(cfg, rate, model, self.spec, device)
            for rate in sorted({float(r) for r in cfg["model_rate"]}, reverse=True)}
        eng0 = next(iter(self.levels.values())).engine
        self.local_epochs, self.batch_size = eng0.local_epochs, eng0.batch_size
        self.fused_mode, self.momentum, self.weight_decay = \
            eng0.fused_mode, eng0.momentum, eng0.weight_decay
        if self.is_lm:
            self.bptt = eng0.bptt
        else:
            self.norm, self.augment = eng0.norm, eng0.augment

    # -- one level's clients ------------------------------------------------

    def _step(self, lv: Level, p, buf, g, grads, n_glob, lr) -> None:
        """The optimizer tail of one step of G clients, in place on ``p``
        and ``buf`` ``[G, n_l]``: the batched fused epilogue (gradients packed
        client-major into ``g``), or each client's per-leaf chain."""
        G = p.shape[0]
        if self.fused_mode is None:
            for i in range(G):
                lv.engine._reference_step(p[i], buf[i], [gr[i] for gr in grads], lv.mask,
                                          n_glob[i], lr)
            return
        torch.cat([gr.reshape(G, -1) for gr in grads], dim=1, out=g)
        scal = torch.stack([n_glob.clamp_min(1e-6), lr.expand(G),
                            (n_glob > 0).to(torch.float32)], dim=1)
        fused_sgd_batched(g, p, buf, lv.mask, scal, momentum=self.momentum,
                          weight_decay=self.weight_decay, max_norm=1.0)

    def local_train_level(self, lv: Level, P: torch.Tensor, uids: torch.Tensor, data,
                          gens: List[torch.Generator], lr: torch.Tensor,
                          raw_perms: Optional[List[np.ndarray]] = None,
                          aug: Optional[Callable[[int], List[Tuple[Any, Any]]]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local SGD of a level's G vision clients (``uids``) from the global
        flat params ``P`` -> ``(trained [G, n_l], [G, 3] sums of loss,
        correct, n)``.  Hooks as in ``RoundEngine.local_train``, one entry a
        client: ``raw_perms`` their ``[E, N]`` permutations, ``aug(t)`` their
        step-``t`` ``(offsets, flips)``."""
        B, E, G = self.batch_size, self.local_epochs, len(gens)
        x_all, y_all, sm_all, lm_all = data
        dev = P.device
        N = x_all.shape[1]
        S = math.ceil(N / B)
        SB = S * B
        p = P.index_select(0, lv.idx).expand(G, -1).contiguous()
        buf = torch.zeros_like(p)
        g = torch.empty_like(p)
        if raw_perms is None:
            perms = torch.stack([torch.stack([torch.randperm(N, generator=gen, device=dev)
                                              for _ in range(E)]) for gen in gens])
        else:
            perms = torch.as_tensor(np.stack(raw_perms), dtype=torch.int64).to(dev)
        smu, lmu = sm_all[uids], lm_all[uids]
        order = torch.sort(-torch.gather(smu[:, None, :].expand(G, E, N), 2, perms), dim=2,
                           stable=True).indices
        perms = torch.gather(perms, 2, order)
        wpad = torch.ones(SB, dtype=torch.float32, device=dev)
        if SB > N:
            perms = perms.repeat(1, 1, math.ceil(SB / N))[:, :, :SB]
            wpad[N:] = 0.0
        leaf_idx = lv.leaf_major(G)
        rows = uids[:, None]
        acc = torch.zeros((G, 3), dtype=torch.float32, device=dev)
        for t in range(E * S):
            e, s = divmod(t, S)
            ids = perms[:, e, s * B:(s + 1) * B]
            w = wpad[s * B:(s + 1) * B] * torch.gather(smu, 1, ids)
            n_glob = w.sum(1)
            labels = y_all[rows, ids]
            xb = x_all[rows, ids]
            if self.augment:
                if aug is None:
                    draws = [augment_draws(B, gen, dev) for gen in gens]
                else:
                    draws = [tuple(torch.as_tensor(np.array(a)).to(dev) for a in d)
                             for d in aug(t)]
                xb = augment_cifar(xb.reshape((G * B,) + tuple(xb.shape[2:])), None,
                                   torch.cat([d[0] for d in draws]),
                                   torch.cat([d[1] for d in draws])).view(xb.shape)
            img = normalize_image(xb, *self.norm) if self.norm is not None \
                else xb.to(torch.float32)
            leaves = lv.leaves(p.view(-1).index_select(0, leaf_idx), G)
            score, loss = lv.model.forward_clients(
                clients_in_channels(img), labels, G, params=leaves,
                scaler_rate=lv.scaler_rate, label_mask=lmu, sample_weight=w)
            lsum = loss * n_glob  # weighted-SUM form, each client's own
            grads = torch.autograd.grad(lsum.sum(), [leaves[k] for k in lv.spec.names])
            del leaves
            correct = ((score.detach().argmax(-1) == labels).to(torch.float32) * w).sum(1)
            self._step(lv, p, buf, g, grads, n_glob, lr)
            del grads
            acc += torch.stack([lsum.detach(), correct, n_glob], dim=1)
        return p, acc

    def local_train_level_lm(self, lv: Level, P: torch.Tensor, uids: torch.Tensor, data,
                             gens: List[torch.Generator], lr: torch.Tensor,
                             draws: Optional[Callable[[int], List[Dict[str, Any]]]] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local SGD of a level's G masked-LM clients on their token rows
        -> ``(trained [G, n_l], [G, 3] sums of loss, score, n)``, as
        ``RoundEngine.local_train_lm``; ``draws(t)`` (test hook) gives each
        client's step-``t`` corruption and dropout draws."""
        bptt, E, G = self.bptt, self.local_epochs, len(gens)
        rows_all, lm_all = data
        dev = P.device
        rows = rows_all[uids]
        R, T = rows.shape[1], rows.shape[2]
        S = math.ceil(T / bptt)
        pad = S * bptt - T
        rows_p = torch.nn.functional.pad(rows, (0, pad))
        wpos = torch.ones((R, S * bptt), dtype=torch.float32, device=dev)
        if pad:
            wpos[:, T:] = 0.0
        n_win = wpos.view(R, S, bptt).sum((0, 2))
        p = P.index_select(0, lv.idx).expand(G, -1).contiguous()
        buf = torch.zeros_like(p)
        g = torch.empty_like(p)
        lmu = lm_all[uids]
        leaf_idx = lv.leaf_major(G)
        acc = torch.zeros((G, 3), dtype=torch.float32, device=dev)
        rows_n = torch.full((G,), float(R), dtype=torch.float32, device=dev)
        for t in range(E * S):
            s = t % S
            lab = rows_p[:, :, s * bptt:(s + 1) * bptt]
            w = wpos[:, s * bptt:(s + 1) * bptt].expand(G, R, bptt)
            n_glob = n_win[s].expand(G)
            leaves = lv.leaves(p.view(-1).index_select(0, leaf_idx), G)
            _, loss = lv.model.forward_clients(
                lab, G, params=leaves, scaler_rate=lv.scaler_rate, label_mask=lmu,
                sample_weight=w, gens=gens, draws=None if draws is None else draws(t))
            lsum = loss * n_glob
            grads = torch.autograd.grad(lsum.sum(), [leaves[k] for k in lv.spec.names])
            del leaves
            self._step(lv, p, buf, g, grads, n_glob, lr)
            del grads
            wl = lsum.detach() / n_glob.clamp_min(1e-6)
            acc += torch.stack([wl * rows_n, torch.exp(wl) * rows_n, rows_n], dim=1)
        return p, acc

    # -- one round --------------------------------------------------------------

    def train_round(self, P: torch.Tensor, lr: float, user_idx: Sequence[int],
                    data: Tuple[torch.Tensor, ...], round_seed: int,
                    epoch_perms: Optional[Dict[int, np.ndarray]] = None,
                    lm_draws: Optional[Callable[[int, int], Dict[str, Any]]] = None,
                    rates: Optional[Sequence[float]] = None,
                    aug_draws: Optional[Callable[[int, int], Tuple[Any, Any]]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One round from the global flat params ``P``, under cuDNN's
        deterministic algorithms; arguments, hooks and results as
        ``RoundEngine.train_round``'s (no codec)."""
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return self._train_round(P, lr, user_idx, data, round_seed, epoch_perms, lm_draws,
                                     rates, aug_draws)
        finally:
            torch.backends.cudnn.deterministic = deterministic

    def _train_round(self, P, lr, user_idx, data, round_seed, epoch_perms, lm_draws, rates,
                     aug_draws):
        user_idx = np.asarray(user_idx, np.int64).reshape(-1)
        rates_abs = cohort_rates(self.cfg, user_idx, round_seed, rates)
        snapped = snap_to_levels(rates_abs, self.levels)
        by_level: Dict[float, List[int]] = {}
        for pos, r in enumerate(snapped.tolist()):
            by_level.setdefault(r, []).append(pos)
        dev = P.device
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=dev)
        summed = torch.zeros_like(P)
        counts = torch.zeros_like(P)
        acc = torch.zeros((len(user_idx), 3), dtype=torch.float32, device=dev)
        for rate in sorted(by_level, reverse=True):
            lv, pos = self.levels[rate], by_level[rate]
            users = user_idx[pos].tolist()
            gens = [torch.Generator(device=dev).manual_seed(client_seed(round_seed, u))
                    for u in users]
            uids = torch.as_tensor(users, dtype=torch.int64).to(dev)
            if self.is_lm:
                draws = None if lm_draws is None else \
                    (lambda t, us=users: [lm_draws(u, t) for u in us])
                trained, acc_l = self.local_train_level_lm(lv, P, uids, data, gens, lr_t, draws)
            else:
                trained, acc_l = self.local_train_level(
                    lv, P, uids, data, gens, lr_t,
                    None if epoch_perms is None else [epoch_perms[u] for u in users],
                    None if aug_draws is None else
                    (lambda t, us=users: [aug_draws(u, t) for u in us]))
            cm = lv.count_masks(data[-1][uids])
            summed.index_add_(0, lv.idx, (trained * cm).sum(0))
            counts.index_add_(0, lv.idx, cm.sum(0))
            acc[torch.as_tensor(pos, dtype=torch.int64).to(dev)] = acc_l
        ms = {"loss_sum": acc[:, 0], "score_sum": acc[:, 1], "n": acc[:, 2],
              "rate": rates_abs}
        return combine_counted(P, summed, counts), ms
