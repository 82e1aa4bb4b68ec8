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
gradient are client-major ``[G, ld]`` buffers (each client's flat buffer of
n_l entries one contiguous row, rows padded to ``ld``, a multiple of 4, so
each starts 16-byte aligned: ResNet-18's n_l are 2 mod 4), which the
batched fused SGD (ops/fused_update.py, kernel 3b) needs for its
per-client norm; it and the aggregation take the ``[:, :n_l]`` views, and
no pad entry is read.  The batched forward needs each
leaf's G copies contiguous (a grouped convolution takes ``[G*O, I, k,
k]``), so a step first gathers the client-major params into a leaf-major
copy (one ``index_select`` over a precomputed map), and the gradients,
which autograd gives per leaf as ``[G, *shape]``, go back client-major in
the ``torch.cat`` along the rows that packs them (the masked engine's
pack).  Over the masked engine's step that is one launch more (the
gather) and ``G * n_l * 12`` bytes more (the map is int32); against it the
step makes one pass of the model for G clients, one BN launch a site a
direction for G clients (kernels 1b/2b, ops/fused_norm.py) and one SGD launch
for G clients.  A leaf-major layout would save the gather but cut each
client's row into a segment per leaf, so the SGD kernel's per-client norm
would read strided segments; the client-major one keeps 3b's rows whole.

The engine takes the masked engine's test hooks (``rates``,
``epoch_perms``, ``aug_draws``, ``lm_draws``) and returns the per-client
metric sums in user order (ref ``_assemble``, grouped.py:775-787).  A lossy
wire codec is refused by its K=1 round, as the reference's K=1 round
refuses it (grouped.py:690-695; with ``client_store='stream'`` a K=1 run
is a run of one-round supersteps, which compress); the superstep (:meth:`GroupedRoundEngine.
train_superstep`, ref grouped.py:1416-1617) compresses the merged global
sums with it, as the reference's superstep does, on the grid the
reference sizes for its slots (:meth:`GroupedRoundEngine.codec_slots`), so
such a run resumes bit for bit at a superstep boundary.  A per-level
``{rate: codec}`` map (ref grouped.py:399-456, :1103-1159) instead sends
each level's sliced sums through that level's codec, a grid a level's
slots, the lossy levels' residuals in one ``[2, total_lossy]`` carry
(:meth:`GroupedRoundEngine._merge`).  There the clients of
each round are grouped by level from the ``[k, A]`` schedules, and a
level's G clients replay one captured batched step a (level, G)
(``parallel/step_graph.py``), cached: a capture costs about three eager
steps, a level's round replays E x S of them, so G is not bucketed (the
reference buckets it to powers of two to bound its compiles, grouped.py:743).

**The scheduler.**  A ``-1`` slot sits in the level of user ``U - 1``'s
rate (the reference's ``jnp.take`` wraps ``-1``), so it counts towards its
level's G and the codec's slots; it and a failed client ride in their
level's batch on user 0's data with a budget of 0 steps.  When some slot
of the round (the superstep) sits out or stops early, each row's budget is
a static buffer the step reads: step ``t`` of a row with ``t >= budget``
gates off its update (kernel 3b's ``has`` row 0) and its sums, and the
level replays up to its largest budget; otherwise the steps are the
lockstep ones.  Buffered aggregation runs in the superstep only; the K=1
round refuses it with the reference's message.

**The streamed cohort.**  :meth:`GroupedRoundEngine.stage_cohort` gathers a
superstep's cohort from a ``ClientStore`` in the reference's per-level
layout (``[k, levels, per]`` slots, each level's clients contiguous); a
level plan reads its clients' data at their slots' rows instead of their
user ids, so the steps and their graphs are the eager store's.

**Determinism.**  A round runs under cuDNN's deterministic algorithms
(``torch.backends.cudnn.deterministic``, set for the round and put back
after): cuDNN's default algorithms for the grouped convolutions' weight
gradients sum in an order that changes from run to run, which a level-e
client grows to about 3e-3 over a round, so a resumed run would not equal
an uninterrupted one.  With them it does, bit for bit, as on every other
path of the port; the headline round costs about 7% more on an H100
(PERF.md).

**Observability and its guards** (ref grouped.py:530-577, :688, :928-955):
the poison and the quarantine gate act on each level's ``[G, n_l]`` rows
before they are summed (a row gated to zero count, its values selected to
zero); the probes read the merged global sums after the codec.  The K=1
round refuses the probes and the poison with the reference's messages;
the superstep (and the stream store's one-round superstep) runs both.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chaos.inject import poison_hits
from ..compress import make_codec, resolve_codec_cfg
from ..compress.codecs import compressed_sum
from ..fed.core import combine_counted, level_index_map, round_seed, snap_to_levels
from ..models import make_model
from ..models.base import FedModel
from ..models.spec import label_vector
from ..ops.augment import augment_cifar, augment_draws, normalize_image
from ..ops.fused_update import FlatSpec, fused_sgd_batched
from ..ops.layers import clients_in_channels
from .round_engine import (FlatParams, RoundEngine, client_seed, cohort_rates,
                           superstep_schedules)
from .staging import ClientStore, PendingMetrics, StagedCohort
from .step_graph import StepGraphs, device_counter


def row_stride(n: int) -> int:
    """The row stride of a level's ``[G, ld]`` buffers: ``n`` rounded up to
    a multiple of 4, so every client's row starts 16-byte aligned."""
    return -(-n // 4) * 4


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
        level_cfg = dict(cfg, model_rate=[cfg["global_model_rate"]], model_split_mode="fix",
                         wire_codec="dense", schedule=None,  # the engine compresses,
                         client_failure_rate=0.0,           # schedules and observes,
                         telemetry="off", watchdog=None,    # not its levels
                         quarantine="off", chaos_poison=None)
        self.engine = RoundEngine(self.model, level_cfg, device)
        self.spec = self.engine.spec
        self.ld = row_stride(self.spec.total)
        self.mask = self.engine.param_mask_flat(1.0)
        self.idx = torch.from_numpy(level_index_map(
            global_spec, self.spec, global_model.specs, global_model.groups,
            self.scaler_rate)).to(device)
        self._label_axes = [(k, s.label_axis) for k, s in self.model.specs.items()
                            if s.label_axis is not None]
        self._leaf_major: Dict[int, torch.Tensor] = {}
        self._pad: Dict[int, List[torch.Tensor]] = {}

    def buffers(self, P: torch.Tensor, G: int) -> Tuple[torch.Tensor, ...]:
        """G clients' params (the global ``P`` at the level's entries),
        momentum (zeros) and gradient buffers, each ``[G, ld]``; the pad
        columns of params and momentum are zero."""
        p = torch.zeros((G, self.ld), dtype=P.dtype, device=P.device)
        p[:, :self.spec.total] = P.index_select(0, self.idx)
        return p, torch.zeros_like(p), torch.empty_like(p)

    def pad(self, G: int) -> List[torch.Tensor]:
        """The zeros that fill a ``[G, ld]`` gradient buffer's pad columns
        when the gradients are packed into it (none where ``ld == n_l``)."""
        if G not in self._pad:
            w = self.ld - self.spec.total
            self._pad[G] = [torch.zeros((G, w), dtype=torch.float32,
                                        device=self.idx.device)] if w else []
        return self._pad[G]

    def leaf_major(self, G: int) -> torch.Tensor:
        """``[G * n_l]`` (int32; int64 past 2**31): for each entry of the
        leaf-major layout (leaf k's G copies contiguous, ``[G, *shape_k]``,
        leaves in order), its place in the client-major ``[G, ld]`` buffer."""
        if G not in self._leaf_major:  # made on the device: G * n_l entries
            dev = self.idx.device
            dt = torch.int32 if G * self.ld < 2 ** 31 else torch.int64
            rows = torch.arange(G, dtype=dt, device=dev)[:, None] * self.ld
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


class LevelPlan(NamedTuple):
    """One level's slots in one round of the superstep: its rate, the
    slots' positions in the round and their users (``-1`` slots as user 0,
    the reference's ``max(uid, 0)``), their rows of the data stacks on the
    device (the users themselves in the eager stacks, their slots in a
    cohort's), the positions on the device, each row's step budget on the
    device (None: the step gates no row), the steps the level replays (its
    largest budget), and its rows' validity as float32 on the device
    (None: every row counts)."""

    rate: float
    pos: List[int]
    users: List[int]
    rows: torch.Tensor
    pos_dev: torch.Tensor
    lim: Optional[torch.Tensor]
    steps: int
    valid: Optional[torch.Tensor]


class GroupedRoundEngine(FlatParams):
    """Local training and counted aggregation of one round, each level's
    clients batched, for one (global model, cfg, device)."""

    def __init__(self, model: FedModel, cfg: Dict[str, Any], device: torch.device):
        # a lossy codec (or per-level map) is refused at superstep_rounds 1
        name, ef = resolve_codec_cfg(dict(cfg, strategy="grouped"))
        self.model, self.cfg, self.device = model, cfg, device
        self.is_lm = model.meta["kind"] == "transformer"
        self.spec = FlatSpec.of(dict(model.named_parameters()))
        self.codec_map = name if isinstance(name, dict) else None
        self.codec = None if self.codec_map else make_codec(name, self.spec, 1,
                                                            error_feedback=ef)
        self._resid = None
        self._init_sched(cfg)
        self._init_obs(cfg)
        # the superstep's captured batched steps, one a (level, G) met, their
        # static buffers and generators
        self.graphs = StepGraphs(device)
        self._st: Dict[Tuple[float, int], Dict[str, torch.Tensor]] = {}
        self._ggens: List[torch.Generator] = []
        self._lr = torch.zeros((), dtype=torch.float32, device=device)
        self.levels: Dict[float, Level] = {
            rate: Level(cfg, rate, model, self.spec, device)
            for rate in sorted({float(r) for r in cfg["model_rate"]}, reverse=True)}
        self._map_codecs: Dict[float, Tuple[Any, int]] = {}
        self._total_lossy = 0
        if self.codec_map is not None:
            self._map_layout(ef)
        eng0 = next(iter(self.levels.values())).engine
        self.local_epochs, self.batch_size = eng0.local_epochs, eng0.batch_size
        self.fused_mode, self.momentum, self.weight_decay = \
            eng0.fused_mode, eng0.momentum, eng0.weight_decay
        if self.is_lm:
            self.bptt = eng0.bptt
        else:
            self.norm, self.augment = eng0.norm, eng0.augment

    # -- one level's clients ------------------------------------------------

    def _step(self, lv: Level, p, buf, g, grads, n_glob, lr, live=None) -> None:
        """The optimizer tail of one step of G clients, in place on ``p``
        and ``buf`` ``[G, n_l]`` (views of ``[G, ld]`` rows): the batched
        fused epilogue (gradients packed client-major into ``g [G, ld]``),
        or each client's per-leaf chain.  A row steps where its batch has
        weight and, with ``live [G]`` (bool), where it is live."""
        G = p.shape[0]
        has = n_glob > 0 if live is None else (n_glob > 0) & live
        if self.fused_mode is None:
            for i in range(G):
                lv.engine._reference_step(p[i], buf[i], [gr[i] for gr in grads], lv.mask,
                                          n_glob[i], lr, has[i])
            return
        torch.cat([gr.reshape(G, -1) for gr in grads] + lv.pad(G), dim=1, out=g)
        scal = torch.stack([n_glob.clamp_min(1e-6), lr.expand(G), has.to(torch.float32)],
                           dim=1)
        fused_sgd_batched(g[:, :lv.spec.total], p, buf, lv.mask, scal, momentum=self.momentum,
                          weight_decay=self.weight_decay, max_norm=1.0)

    def local_train_level(self, lv: Level, P: torch.Tensor, uids: torch.Tensor, data,
                          gens: List[torch.Generator], lr: torch.Tensor,
                          raw_perms: Optional[List[np.ndarray]] = None,
                          aug: Optional[Callable[[int], List[Tuple[Any, Any]]]] = None,
                          lim: Optional[np.ndarray] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local SGD of a level's G vision clients (``uids``) from the global
        flat params ``P`` -> ``(trained [G, n_l], [G, 3] sums of loss,
        correct, n)``.  ``lim [G]`` (host int64, or None): each row's step
        budget -- step ``t`` of a row with ``t >= lim`` changes neither its
        params nor its sums, and the level stops after its largest budget.
        Hooks as in ``RoundEngine.local_train``, one entry a client:
        ``raw_perms`` their ``[E, N]`` permutations, ``aug(t)`` their
        step-``t`` ``(offsets, flips)``."""
        B, G, dev = self.batch_size, len(gens), P.device
        x_all, y_all, sm_all, lm_all = data
        S = math.ceil(x_all.shape[1] / B)
        p_rows, buf_rows, g = lv.buffers(P, G)
        smu = sm_all[uids]
        st = {"p": p_rows, "buf": buf_rows, "g": g, "lr": lr, "lm": lm_all[uids],
              "acc": torch.zeros((G, 3), dtype=torch.float32, device=dev)}
        perms = self._level_perms(gens, smu, raw_perms)
        wpad = lv.engine._pad_weights(x_all.shape[1], dev)
        rows = uids[:, None]
        steps, lim = self._budgets(self.local_epochs * S, lim, dev)
        for t in range(steps):
            e, s = divmod(t, S)
            ids = perms[:, e, s * B:(s + 1) * B]
            draws = None if aug is None else [
                tuple(torch.as_tensor(np.array(a)).to(dev) for a in d) for d in aug(t)]
            self._level_vision_step(lv, st, gens, x_all[rows, ids], y_all[rows, ids],
                                    wpad[s * B:(s + 1) * B] * torch.gather(smu, 1, ids), draws,
                                    None if lim is None else lim > t)
        return p_rows[:, :lv.spec.total], st["acc"]

    def local_train_level_lm(self, lv: Level, P: torch.Tensor, uids: torch.Tensor, data,
                             gens: List[torch.Generator], lr: torch.Tensor,
                             draws: Optional[Callable[[int], List[Dict[str, Any]]]] = None,
                             lim: Optional[np.ndarray] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local SGD of a level's G masked-LM clients on their token rows
        -> ``(trained [G, n_l], [G, 3] sums of loss, score, n)``, as
        ``RoundEngine.local_train_lm``; ``lim`` as in
        :meth:`local_train_level`; ``draws(t)`` (test hook) gives each
        client's step-``t`` corruption and dropout draws."""
        bptt, G, dev = self.bptt, len(gens), P.device
        rows_all, lm_all = data
        rows = rows_all[uids]
        R, T = rows.shape[1], rows.shape[2]
        wpos, n_win = lv.engine._window_weights(R, T, dev)
        S = n_win.numel()
        rows_p = torch.nn.functional.pad(rows, (0, S * bptt - T))
        p_rows, buf_rows, g = lv.buffers(P, G)
        st = {"p": p_rows, "buf": buf_rows, "g": g, "lr": lr, "lm": lm_all[uids],
              "acc": torch.zeros((G, 3), dtype=torch.float32, device=dev),
              "rows_n": torch.full((G,), float(R), dtype=torch.float32, device=dev)}
        steps, lim = self._budgets(self.local_epochs * S, lim, dev)
        for t in range(steps):
            s = t % S
            self._level_lm_step(lv, st, gens, rows_p[:, :, s * bptt:(s + 1) * bptt],
                                wpos[:, s * bptt:(s + 1) * bptt].expand(G, R, bptt),
                                n_win[s].expand(G), None if draws is None else draws(t),
                                None if lim is None else lim > t)
        return p_rows[:, :lv.spec.total], st["acc"]

    @staticmethod
    def _budgets(total: int, lim: Optional[np.ndarray], device: torch.device
                 ) -> Tuple[int, Optional[torch.Tensor]]:
        """A level's steps (``total``, or its largest budget) and its rows'
        budgets on the device (None: every row runs every step)."""
        if lim is None:
            return total, None
        lim = np.asarray(lim, np.int64)
        return min(total, int(lim.max(initial=0))), torch.from_numpy(lim).to(device)

    # -- one batched step: shared by the eager loops above and the captured steps

    def _level_perms(self, gens: List[torch.Generator], smu: torch.Tensor,
                     raw_perms: Optional[List[np.ndarray]] = None) -> torch.Tensor:
        """G clients' ``[G, E, S * B]`` epoch orders (sample masks ``smu [G,
        N]``), as ``RoundEngine._epoch_perms``: drawn from each client's
        generator (or ``raw_perms``), real samples first, tiled."""
        G, E, N, dev = len(gens), self.local_epochs, smu.shape[1], smu.device
        SB = math.ceil(N / self.batch_size) * self.batch_size
        if raw_perms is None:
            perms = torch.stack([torch.stack([torch.randperm(N, generator=gen, device=dev)
                                              for _ in range(E)]) for gen in gens])
        else:
            perms = torch.as_tensor(np.stack(raw_perms), dtype=torch.int64).to(dev)
        order = torch.sort(-torch.gather(smu[:, None, :].expand(G, E, N), 2, perms), dim=2,
                           stable=True).indices
        perms = torch.gather(perms, 2, order)
        if SB > N:
            perms = perms.repeat(1, 1, math.ceil(SB / N))[:, :, :SB]
        return perms

    def _level_vision_step(self, lv: Level, st, gens: List[torch.Generator], xb, labels, w,
                           draws=None, live=None) -> None:
        """One batched step of G vision clients on their batches ``(xb [G,
        B, ...], labels, w [G, B])``, in place on ``st`` (``p``, ``buf``,
        ``g`` ``[G, ld]`` rows, ``acc``; ``lr``, ``lm``); ``draws`` the
        clients' augmentation ``(offsets, flips)`` instead of ``gens``;
        ``live [G]`` (bool, or None: all) gates each row's update and sums,
        as the reference's deadline gates a step (round_engine.py:688-713)."""
        B, G = self.batch_size, len(gens)
        n_glob = w.sum(1)
        if self.augment:
            if draws is None:
                draws = [augment_draws(B, gen, xb.device) for gen in gens]
            xb = augment_cifar(xb.reshape((G * B,) + tuple(xb.shape[2:])), None,
                               torch.cat([d[0] for d in draws]),
                               torch.cat([d[1] for d in draws])).view(xb.shape)
        img = normalize_image(xb, *self.norm) if self.norm is not None \
            else xb.to(torch.float32)
        leaves = lv.leaves(st["p"].view(-1).index_select(0, lv.leaf_major(G)), G)
        score, loss = lv.model.forward_clients(
            clients_in_channels(img), labels, G, params=leaves,
            scaler_rate=lv.scaler_rate, label_mask=st["lm"], sample_weight=w)
        lsum = loss * n_glob  # weighted-SUM form, each client's own
        grads = torch.autograd.grad(lsum.sum(), [leaves[k] for k in lv.spec.names])
        del leaves
        correct = ((score.detach().argmax(-1) == labels).to(torch.float32) * w).sum(1)
        n = lv.spec.total
        self._step(lv, st["p"][:, :n], st["buf"][:, :n], st["g"], grads, n_glob, st["lr"], live)
        del grads
        sums = [lsum.detach(), correct, n_glob]
        if live is not None:
            gate = live.to(torch.float32)
            sums = [v * gate for v in sums]
        st["acc"] += torch.stack(sums, dim=1)

    def _level_lm_step(self, lv: Level, st, gens: List[torch.Generator], lab, w, n_glob,
                       draws=None, live=None) -> None:
        """One batched step of G masked-LM clients on their windows ``(lab
        [G, R, bptt], w)`` of weight sums ``n_glob [G]``, in place on
        ``st`` (as :meth:`_level_vision_step`'s, and ``rows_n``)."""
        G = len(gens)
        leaves = lv.leaves(st["p"].view(-1).index_select(0, lv.leaf_major(G)), G)
        _, loss = lv.model.forward_clients(
            lab, G, params=leaves, scaler_rate=lv.scaler_rate, label_mask=st["lm"],
            sample_weight=w, gens=gens, draws=draws)
        lsum = loss * n_glob
        grads = torch.autograd.grad(lsum.sum(), [leaves[k] for k in lv.spec.names])
        del leaves
        n = lv.spec.total
        self._step(lv, st["p"][:, :n], st["buf"][:, :n], st["g"], grads, n_glob, st["lr"], live)
        del grads
        wl = lsum.detach() / n_glob.clamp_min(1e-6)
        rows_n = st["rows_n"] if live is None else st["rows_n"] * live.to(torch.float32)
        st["acc"] += torch.stack([wl * rows_n, torch.exp(wl) * rows_n, rows_n], dim=1)

    # -- one round --------------------------------------------------------------

    def train_round(self, P: torch.Tensor, lr: float, user_idx: Sequence[int],
                    data: Tuple[torch.Tensor, ...], round_seed: int,
                    epoch_perms: Optional[Dict[int, np.ndarray]] = None,
                    lm_draws: Optional[Callable[[int, int], Dict[str, Any]]] = None,
                    rates: Optional[Sequence[float]] = None,
                    aug_draws: Optional[Callable[[int, int], Tuple[Any, Any]]] = None,
                    step_limits=None, alive=None, epoch: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One round from the global flat params ``P``, under cuDNN's
        deterministic algorithms; arguments, hooks and results as
        ``RoundEngine.train_round``'s (no codec: a lossy one is refused, as
        the reference's K=1 round refuses it; nor buffered aggregation,
        the probes or the chaos poison, each refused with the reference's
        message, grouped.py:682-694 and :534-539).  The quarantine gate
        runs, its row under ``obs_gate``."""
        if self.lossy:
            raise ValueError(
                f"wire_codec={self.cfg['wire_codec']!r} with the grouped strategy needs the fused "
                f"superstep (superstep_rounds > 1 or client_store='stream'): the K=1 "
                f"host-orchestrated path reduces per level and has no single global psum "
                f"to compress")
        if self.sched.buffered:
            raise ValueError(
                "schedule aggregation='buffered' needs the fused grouped "
                "superstep (set superstep_rounds > 1 or client_store="
                "'stream'): the K=1 host-orchestrated path combines in its "
                "own program and has no scan carry to buffer")
        if self._obs_on:
            raise ValueError(
                "telemetry='on' with the grouped strategy needs the fused "
                "superstep (set superstep_rounds > 1 or client_store="
                "'stream'): the K=1 path splits the round across L+1 "
                "host-orchestrated programs with no shared round core to "
                "probe")
        if self._poison is not None:
            raise ValueError(
                "chaos_poison with the grouped strategy needs the "
                "fused superstep (superstep_rounds > 1 or client_store"
                "='stream'): the K=1 host-orchestrated path does not "
                "thread the round epoch into its level programs")
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return self._train_round(P, lr, user_idx, data, round_seed, epoch_perms, lm_draws,
                                     rates, aug_draws, step_limits=step_limits, alive=alive)
        finally:
            torch.backends.cudnn.deterministic = deterministic

    def _train_round(self, P, lr, user_idx, data, round_seed, epoch_perms, lm_draws, rates,
                     aug_draws, codec_noise=None, codec_slots=None, step_limits=None,
                     alive=None):
        """:meth:`train_round`'s body, which also takes a codec: its grid
        sized for ``codec_slots`` clients (default: :meth:`codec_slots` of
        this round alone; under a per-level map a level's, :meth:`level_slots`),
        ``codec_noise`` the codec's draw (:meth:`_merge`).

        A ``-1`` slot sits in the level of user ``U - 1``'s rate, as in the
        reference (``cohort_rates``); it and a failed client ride in their
        level's batch on user 0's data (the reference's ``max(uid, 0)``)
        with a budget of 0 steps: every step gated off (kernel 3b's ``has``
        row 0), no count, a zero metrics row and rate 0."""
        user_idx = np.asarray(user_idx, np.int64).reshape(-1)
        rates_abs = cohort_rates(self.cfg, user_idx, round_seed, rates)
        total = self.total_steps(data)
        valid, limits = self.slot_plan(user_idx, round_seed, total, step_limits, alive)
        gate = bool((limits < total).any())  # a slot sits out or stops early
        snapped = snap_to_levels(rates_abs, self.levels)
        by_level: Dict[float, List[int]] = {}
        for pos, r in enumerate(snapped.tolist()):
            by_level.setdefault(r, []).append(pos)
        dev = P.device
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=dev)
        sums: Dict[float, Tuple[torch.Tensor, torch.Tensor]] = {}
        acc = torch.zeros((len(user_idx), 3), dtype=torch.float32, device=dev)
        oks, gpos = ([], []) if self._quarantine.enabled else (None, None)
        for rate in sorted(by_level, reverse=True):
            lv, pos = self.levels[rate], by_level[rate]
            users = np.maximum(user_idx[pos], 0).tolist()
            gens = [torch.Generator(device=dev).manual_seed(client_seed(round_seed, u))
                    for u in users]
            uids = torch.as_tensor(users, dtype=torch.int64).to(dev)
            lim = limits[pos] if gate else None
            if self.is_lm:
                draws = None if lm_draws is None else \
                    (lambda t, us=users: [lm_draws(u, t) for u in us])
                trained, acc_l = self.local_train_level_lm(lv, P, uids, data, gens, lr_t, draws,
                                                           lim)
            else:
                trained, acc_l = self.local_train_level(
                    lv, P, uids, data, gens, lr_t,
                    None if epoch_perms is None else [epoch_perms[u] for u in users],
                    None if aug_draws is None else
                    (lambda t, us=users: [aug_draws(u, t) for u in us]), lim)
            cm = lv.count_masks(data[-1][uids])
            if not valid[pos].all():  # padding and failed rows count nothing
                cm = cm * torch.from_numpy(valid[pos].astype(np.float32)).to(dev)[:, None]
            trained, cm, ok = self._guard(trained, self._level_ref(P, lv), cm, None)
            if ok is not None:
                oks.append(ok)
                gpos += pos
            sums[rate] = ((trained * cm).sum(0), cm.sum(0))
            acc[torch.as_tensor(pos, dtype=torch.int64).to(dev)] = acc_l
        ms = {"loss_sum": acc[:, 0], "score_sum": acc[:, 1], "n": acc[:, 2],
              "rate": rates_abs * valid}
        if codec_slots is None:
            codec_slots = self.codec_slots(rates_abs[None])
        new_P, summed, counts = self._merge(P, sums, round_seed, len(user_idx), codec_noise,
                                            codec_slots)
        obs = self._round_obs(P, new_P, summed, counts,
                              self._gate_row(oks, gpos, len(user_idx), dev), limits, total)
        if obs is not None:
            ms.update(obs)
        return new_P, ms

    def _level_ref(self, P: torch.Tensor, lv: Level) -> Optional[torch.Tensor]:
        """The params a level's rows trained from (the global ``P`` at its
        entries), which the gate's norm bound measures against; None when
        the gate has no bound."""
        return None if self._quarantine.max_norm is None else P.index_select(0, lv.idx)

    def level_slots(self, rate_schedule) -> int:
        """A level's slots over the ``[k, A]`` rates of a superstep, as the
        reference's one-device span layout counts them (ref grouped.py:
        1305-1335): the most clients any level holds in any of the k
        rounds, rounded up to a power of two.  A per-level map sizes each
        lossy level's grid for it (ref grouped.py:1103-1159,
        ``encode(..., per_dev)``)."""
        need = 1
        for row in np.asarray(rate_schedule, np.float32):
            snapped = snap_to_levels(row, self.levels)
            need = max([need] + [int(np.sum(snapped == rate)) for rate in self.levels])
        return 1 << (need - 1).bit_length()

    def codec_slots(self, rate_schedule) -> int:
        """The clients one wire codec's grid is sized for over the ``[k,
        A]`` rates of a superstep (ref grouped.py:900): every level of the
        engine times :meth:`level_slots`; under a per-level map, a level's
        own :meth:`level_slots`."""
        slots = self.level_slots(rate_schedule)
        return slots if self.codec_map is not None else len(self.levels) * slots

    # -- the per-level wire-codec map -----------------------------------------

    @property
    def lossy(self) -> bool:
        return self.codec is not None or bool(self._map_codecs)

    def _map_layout(self, ef: bool) -> None:
        """The per-level map's layout (ref grouped.py:399-444): its keys
        must be the level table; each lossy level gets a codec over its
        sliced flat layout (the level model's) and the offset of its
        columns in ONE residual ``[2, total_lossy]``, lossy levels in
        descending rate (row 1 only written by ``topk``).  A map of dense
        levels only is ``dense`` (``resolve_codec_cfg``)."""
        if set(self.codec_map) != set(self.levels):
            raise ValueError(
                f"per-level wire_codec map keys {sorted(self.codec_map)} do not match the "
                f"engine's level table {sorted(self.levels)}: every level needs exactly one "
                f"codec")
        off = 0
        for rate, lv in self.levels.items():
            name = self.codec_map[rate]
            if name != "dense":
                self._map_codecs[rate] = (make_codec(name, lv.spec, 1, error_feedback=ef), off)
                off += lv.spec.total
        self._total_lossy = off

    def resid_shape(self) -> Tuple[int, int]:
        if self.codec_map is None:
            return super().resid_shape()
        return (2, self._total_lossy)

    def resid_segments(self) -> Sequence[Tuple[int, FlatSpec]]:
        if self.codec_map is None:
            return super().resid_segments()
        return [(off, self.levels[rate].spec) for rate, (_, off) in self._map_codecs.items()]

    def _merge(self, P: torch.Tensor, sums: Dict[float, Tuple[torch.Tensor, torch.Tensor]],
               rseed: int, n_clients: int, codec_noise=None, cmax: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The round's new global params from each trained level's sliced
        counted sums ``{rate: (s_l, c_l)}``: added into zero global
        buffers at the level's entries, levels in descending rate (the
        reference's ``merge``), then the uniform codec (its grid sized for
        ``cmax`` clients) and the counted average.  Under a per-level map
        (ref grouped.py:1103-1159) every lossy level -- trained or not, as
        the reference runs every level's slots -- encodes its sliced sums
        with its residual under its own codec on a grid sized for ``cmax``
        slots and the global params at its entries, and is decoded before
        it is added; a dense level adds its float32 sums.  ``codec_noise``:
        the uniform codec's int8 noise, or under a map ``{rate: draw}`` (an
        int8 level's noise ``[n_l]``, a topk level's block offset), test
        hooks replacing the draws from ``rseed``.  Returns ``(new P, summed,
        counts)``, the merged global sums the combine read (decoded)."""
        summed = torch.zeros_like(P)
        counts = torch.zeros_like(P)
        lossy = self.codec_map is not None and n_clients > 0
        if lossy:
            resid = self._ensure_resid(P.device)
            new_resid = torch.zeros_like(resid)
        for rate, lv in self.levels.items():  # descending rate
            if rate in sums:
                s_l, c_l = sums[rate]
            elif lossy and rate in self._map_codecs:
                s_l = c_l = torch.zeros(lv.spec.total, dtype=P.dtype, device=P.device)
            else:
                continue
            if lossy and rate in self._map_codecs:
                cobj, off = self._map_codecs[rate]
                n, slots = lv.spec.total, cobj.resid_slots
                draw = None if codec_noise is None else codec_noise.get(rate)
                if draw is None:
                    draw = cobj.draw(rseed, P.device)
                s_l, c_l, new_resid[:slots, off:off + n] = compressed_sum(
                    cobj, P.index_select(0, lv.idx), s_l, c_l, resid[:slots, off:off + n],
                    draw, cmax)
            summed.index_add_(0, lv.idx, s_l)
            counts.index_add_(0, lv.idx, c_l)
        if lossy:
            self._resid = new_resid
            return combine_counted(P, summed, counts), summed, counts
        return self._aggregate(P, summed, counts, rseed, n_clients, codec_noise, cmax=cmax)

    # -- the superstep: k rounds, each level's batched steps replayed ---------

    def _slots(self, lv: Level, G: int, P: torch.Tensor, data, gate: bool = False
               ) -> Dict[str, torch.Tensor]:
        """Static buffers of the captured step of G clients at level ``lv``
        (made on first use): their ``[G, ld]`` params, momentum and
        gradient, their data, permutations (vision) or token rows (LM),
        sums and the step counter; with ``gate`` also each row's step
        budget (``lim``), which the step reads."""
        key = (lv.scaler_rate, G, gate)
        if key in self._st:
            return self._st[key]
        dev = P.device
        p = torch.zeros((G, lv.ld), dtype=P.dtype, device=dev)
        st = {"p": p, "buf": torch.zeros_like(p), "g": torch.zeros_like(p),
              "acc": torch.zeros((G, 3), dtype=torch.float32, device=dev),
              "t": device_counter(dev), "lr": self._lr,
              "lm": torch.zeros((G,) + tuple(data[-1].shape[1:]), dtype=data[-1].dtype,
                                device=dev)}
        if self.is_lm:
            R, T = data[0].shape[1:]
            wpos, n_win = lv.engine._window_weights(R, T, dev)
            S = n_win.numel()
            st.update(rows_p=torch.zeros((G,) + tuple(wpos.shape), dtype=data[0].dtype,
                                         device=dev),
                      wpos=wpos, n_win=n_win,
                      rows_n=torch.full((G,), float(R), dtype=torch.float32, device=dev),
                      ar=torch.arange(self.bptt, device=dev))
        else:
            wpad = lv.engine._pad_weights(data[0].shape[1], dev)
            S = wpad.numel() // self.batch_size
            st.update(x=torch.zeros((G,) + tuple(data[0].shape[1:]), dtype=data[0].dtype,
                                    device=dev),
                      y=torch.zeros((G,) + tuple(data[1].shape[1:]), dtype=data[1].dtype,
                                    device=dev),
                      sm=torch.zeros((G,) + tuple(data[2].shape[1:]), dtype=data[2].dtype,
                                     device=dev),
                      wpad=wpad, perms=torch.zeros((G, self.local_epochs * wpad.numel()),
                                                   dtype=torch.int64, device=dev),
                      ar=torch.arange(self.batch_size, device=dev),
                      rows=torch.arange(G, device=dev)[:, None])
        st["steps"] = self.local_epochs * S
        if gate:  # each row's step budget, read by the captured step
            st["lim"] = torch.zeros(G, dtype=torch.int64, device=dev)
        lv.leaf_major(G)
        lv.pad(G)
        self._st[key] = st
        return st

    def _counted_level_step(self, lv: Level, st, gens: List[torch.Generator]) -> None:
        """:meth:`_level_vision_step` on the static buffers, batch ``t`` read
        through the device step counter, which it advances."""
        B = self.batch_size
        S = st["wpad"].numel() // B
        t = st["t"]
        ids = st["perms"].index_select(1, t * B + st["ar"])
        w = st["wpad"].index_select(0, torch.remainder(t, S) * B + st["ar"]) \
            * torch.gather(st["sm"], 1, ids)
        self._level_vision_step(lv, st, gens, st["x"][st["rows"], ids],
                                torch.gather(st["y"], 1, ids), w, live=self._live(st))
        st["t"] += 1

    def _counted_level_step_lm(self, lv: Level, st, gens: List[torch.Generator]) -> None:
        """:meth:`_level_lm_step` on the static buffers, window ``t % S``
        read through the device step counter, which it advances."""
        bptt, G = self.bptt, len(gens)
        s = torch.remainder(st["t"], st["n_win"].numel())
        cols = s * bptt + st["ar"]
        R = st["wpos"].shape[0]
        self._level_lm_step(lv, st, gens, st["rows_p"].index_select(2, cols),
                            st["wpos"].index_select(1, cols).expand(G, R, bptt),
                            st["n_win"].index_select(0, s.view(1)).expand(G),
                            live=self._live(st))
        st["t"] += 1

    @staticmethod
    def _live(st) -> Optional[torch.Tensor]:
        """The rows of the captured step ``t`` still within their budget
        (the static ``lim``), or None when the step gates no row."""
        return st["t"] < st["lim"] if "lim" in st else None

    def level_step(self, lv: Level, G: int, P: torch.Tensor, data, gate: bool = False):
        """The captured batched step of G clients at level ``lv`` (captured
        on first use; with ``gate`` one that gates each row by its budget),
        its static buffers and its generators."""
        st = self._slots(lv, G, P, data, gate)
        while len(self._ggens) < G:
            self._ggens.append(torch.Generator(device=P.device))
        gens = self._ggens[:G]
        body = self._counted_level_step_lm if self.is_lm else self._counted_level_step
        step = self.graphs.get(("level", lv.scaler_rate, G, gate), lambda: body(lv, st, gens),
                               st["t"].zero_, gens)
        return step, st, gens

    def stage_level(self, lv: Level, st, gens, P: torch.Tensor, uids: torch.Tensor,
                    users: Sequence[int], data, rseed: int,
                    raw_perms: Optional[List[np.ndarray]] = None,
                    lim: Optional[torch.Tensor] = None) -> None:
        """Eager set-up of a level's G clients into the static buffers: the
        global params at the level's entries, zero momentum and sums, the
        step counter at 0, the rows' budgets ``lim`` (a gated step), their
        data (rows ``uids`` of the stacks) and (vision) their epoch
        permutations with real samples first, each client's generator
        reseeded for its user -- ``local_train_level``'s prologue
        (``raw_perms`` its hook)."""
        for gen, u in zip(gens, users):
            gen.manual_seed(client_seed(rseed, u))
        n = lv.spec.total
        st["p"].zero_()
        st["p"][:, :n] = P.index_select(0, lv.idx)
        st["buf"].zero_()
        st["acc"].zero_()
        st["t"].zero_()
        if "lim" in st:
            st["lim"].copy_(lim)
        st["lm"].copy_(data[-1][uids])
        if self.is_lm:
            rows = data[0][uids]
            st["rows_p"].zero_()
            st["rows_p"][:, :, :rows.shape[2]].copy_(rows)
            return
        st["x"].copy_(data[0][uids])
        st["y"].copy_(data[1][uids])
        st["sm"].copy_(data[2][uids])
        st["perms"].copy_(self._level_perms(gens, st["sm"], raw_perms).reshape(len(gens), -1))

    def _replayed_round(self, P: torch.Tensor, user_idx: np.ndarray, rates_abs: np.ndarray,
                        data, rseed: int, plan, cmax: int, epoch_perms=None, codec_noise=None,
                        epoch: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray, Optional[Dict]]:
        """One round (number ``epoch``) of the superstep: per level, in
        descending rate, the eager set-up of its G clients, their batched
        steps replayed (up to the level's largest budget), the poison and
        the gate on their rows (ref grouped.py:530-577), their counted sums
        added at the level's entries; then the codec (its grid sized for
        ``cmax`` clients), the counted average and the probes -> ``(new P,
        [A, 3] device sums, reported rates, obs rows or None)``.  ``plan``:
        the round's valid slots, budgets and :class:`LevelPlan` s; hooks as
        :meth:`train_superstep`'s, this round's."""
        valid, limits, levels = plan
        sums: Dict[float, Tuple[torch.Tensor, torch.Tensor]] = {}
        acc = torch.zeros((len(user_idx), 3), dtype=torch.float32, device=P.device)
        hits = None if self._poison is None else poison_hits(self._poison, epoch, user_idx)
        oks, gpos = ([], []) if self._quarantine.enabled else (None, None)
        for lp in levels:
            lv = self.levels[lp.rate]
            step, st, gens = self.level_step(lv, len(lp.pos), P, data, lp.lim is not None)
            self.stage_level(lv, st, gens, P, lp.rows, lp.users, data, rseed,
                             None if epoch_perms is None else [epoch_perms[u] for u in lp.users],
                             lp.lim)
            for _ in range(min(st["steps"], lp.steps)):
                step.replay()
            cm = lv.count_masks(data[-1][lp.rows])
            if lp.valid is not None:
                cm = cm * lp.valid[:, None]
            trained, cm, ok = self._guard(
                st["p"][:, :lv.spec.total], self._level_ref(P, lv), cm,
                None if hits is None else hits[lp.pos])
            if ok is not None:
                oks.append(ok)
                gpos += lp.pos
            sums[lp.rate] = ((trained * cm).sum(0), cm.sum(0))
            acc[lp.pos_dev] = st["acc"]
        new_P, summed, counts = self._merge(P, sums, rseed, len(user_idx), codec_noise, cmax)
        return new_P, acc, rates_abs * valid, self._round_obs(
            P, new_P, summed, counts, self._gate_row(oks, gpos, len(user_idx), P.device), limits,
            self.total_steps(data))

    def _plans(self, seed: int, epoch0: int, users: np.ndarray, rates: np.ndarray, data,
               device: torch.device, step_limits=None, alive=None, rows=None):
        """Each round's ``(valid slots, budgets, [LevelPlan])``: its slots' plan
        (:meth:`slot_plan` at the round's seed) and its levels in
        descending rate; the data rows (``rows [k, A]``, default the users,
        ``-1`` as 0), positions, budgets and valid rows of the whole
        superstep go to the device in one copy.  The steps gate their rows
        by the budgets when some slot of the superstep sits out or stops
        early, and run as without a scheduler otherwise."""
        if rows is None:
            rows = np.maximum(users, 0)
        total, plans, host = self.total_steps(data), [], []
        for r in range(users.shape[0]):
            valid, limits = self.slot_plan(
                users[r], round_seed(seed, epoch0 + r), total,
                None if step_limits is None else step_limits[r],
                None if alive is None else alive[r])
            snapped = snap_to_levels(rates[r], self.levels)
            by_level: Dict[float, List[int]] = {}
            for pos, rate in enumerate(snapped.tolist()):
                by_level.setdefault(rate, []).append(pos)
            levels = [(rate, by_level[rate], np.maximum(users[r][by_level[rate]], 0))
                      for rate in sorted(by_level, reverse=True)]
            plans.append((valid, limits, levels))
            for _, pos, _ in levels:
                host += [rows[r][pos], np.asarray(pos, np.int64), limits[pos], valid[pos]]
        flat = torch.from_numpy(np.concatenate(host).astype(np.int64)).to(device) if host \
            else None
        gate = any(bool((limits < total).any()) for _, limits, _ in plans)
        out, off = [], 0
        for valid, limits, levels in plans:
            rnd = []
            for rate, pos, uids in levels:
                G = len(pos)
                seg = [flat[off + i * G:off + (i + 1) * G] for i in range(4)]
                off += 4 * G
                rnd.append(LevelPlan(
                    rate, pos, uids.tolist(), seg[0], seg[1],
                    seg[2] if gate else None, int(limits[pos].max()) if gate else total,
                    None if valid[pos].all() else seg[3].to(torch.float32)))
            out.append((valid, limits, rnd))
        return out

    def stage_cohort(self, store: ClientStore, user_schedule, rate_schedule) -> StagedCohort:
        """Gather and commit one superstep's cohort from ``store`` in the
        per-level slot layout (ref grouped.py:1305-1413): ``[k, L, per]``
        slots, round r's level-l clients (levels in descending rate, a
        ``-1`` slot at user ``U - 1``'s) in the first slots of ``[r, l]``,
        ``per`` the most clients a level holds in a round rounded up to a
        power of two, the slots left over ``-1`` (user 0's shard, never
        read); each level's rows are contiguous.  Through the engine's
        cohort ring, O(k x L x per x shard) bytes whatever the population;
        call it for superstep N+1 right after superstep N is dispatched."""
        users = np.asarray(user_schedule, np.int64)
        rates = np.asarray(rate_schedule, np.float32)
        if users.shape != rates.shape or users.ndim != 2:
            raise ValueError(f"user/rate schedules must both be [k, A], got {users.shape} / "
                             f"{rates.shape}")
        k, a = users.shape
        level_rates = list(self.levels)  # descending
        snapped = snap_to_levels(rates.reshape(-1), self.levels).reshape(k, a)
        positions = [[np.flatnonzero(snapped[r] == rate) for rate in level_rates]
                     for r in range(k)]
        need = max([1] + [len(pos) for per_round in positions for pos in per_round])
        per = 1 << (need - 1).bit_length()
        sched = np.full((k, len(level_rates), per), -1, np.int64)
        rows = np.zeros((k, a), np.int64)
        for r in range(k):
            for li, pos in enumerate(positions[r]):
                sched[r, li, :len(pos)] = users[r][pos]
                rows[r][pos] = (r * len(level_rates) + li) * per + np.arange(len(pos))
        return self.cohort_stager().stage(("grouped",) + sched.shape, store, "grouped", sched,
                                          users, rates, rows)

    def train_superstep(self, P: torch.Tensor, seed: int, epoch0: int, k: int,
                        data: Tuple[torch.Tensor, ...], user_schedule, rate_schedule, lrs,
                        eval_mask=None, fused_eval=None,
                        epoch_perms: Optional[Sequence[Dict[int, np.ndarray]]] = None,
                        codec_noise: Optional[Sequence[torch.Tensor]] = None,
                        step_limits: Optional[Sequence[Any]] = None,
                        alive: Optional[Sequence[Any]] = None,
                        cohort: Optional[StagedCohort] = None
                        ) -> Tuple[torch.Tensor, PendingMetrics]:
        """Rounds ``epoch0 .. epoch0 + k - 1`` with no host read between
        them (ref parallel/grouped.py:1416-1617), under cuDNN's
        deterministic algorithms: arguments and results as
        ``RoundEngine.train_superstep``'s; the slots are grouped by level
        once for the superstep from the schedules (a ``-1`` slot at user
        ``U - 1``'s rate, its row gated off), each level's G clients replay
        the captured step of (level, G) up to their largest step budget,
        a lossy codec compresses each round's merged sums on a grid sized
        for :meth:`codec_slots` of the schedule, and buffered aggregation
        applies the previous round's sums.  ``cohort`` (:meth:`stage_cohort`)
        replaces ``data``, its schedules the defaults of ``user_schedule``
        and ``rate_schedule``, each client's data its slot's row.  Test
        hooks, which replace a draw from the round seed, one entry a round:
        ``epoch_perms[r]`` ``{uid: [E, N]}`` raw permutations,
        ``codec_noise[r]`` the int8 codec's noise, ``step_limits[r]`` and
        ``alive[r]`` the deadline budgets and the survivors in slot order."""
        data, user_schedule, rate_schedule, rows = self._cohort_args(
            "grouped", k, data, user_schedule, rate_schedule, cohort)
        users, rates, lrs = superstep_schedules(user_schedule, rate_schedule, lrs, k)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            plans = self._plans(seed, epoch0, users, rates, data, P.device, step_limits, alive,
                                rows)
            cmax = self.codec_slots(rates)
            return self._superstep(
                P, seed, epoch0, k, users, rates, lrs, eval_mask, fused_eval, self._lr,
                lambda P, r, u, rates, rseed: self._replayed_round(
                    P, u, rates, data, rseed, plans[r], cmax,
                    None if epoch_perms is None else epoch_perms[r],
                    None if codec_noise is None else codec_noise[r], epoch0 + r))
        finally:
            torch.backends.cudnn.deterministic = deterministic
            if cohort is not None:
                cohort.release()
