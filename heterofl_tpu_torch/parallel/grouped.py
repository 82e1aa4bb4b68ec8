"""The grouped round engine: each level's clients batched through its dense
sub-model, on one GPU or over the ranks of the clients mesh axis.

Port of ``heterofl_tpu/parallel/grouped.py`` (``GroupedRoundEngine``, both
level placements, one round a dispatch or a superstep).  The
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

**The clients mesh axis** (``parallel/mesh.py``; ref grouped.py:266-397,
:581-621, :722-741, :1013-1213, :1305-1352).  At a world of n ranks each
level's clients are cut into contiguous blocks of ``ceil(G / ranks)``
(:meth:`GroupedRoundEngine._block`; the reference packs them the same way
under ``P("clients")``, its count bucketed to a power of two, here not) over
the level's ranks: every rank under ``level_placement='span'``; under
``'slices'`` the level's own block of ranks (:func:`static_mesh_slices`,
sized by the level's expected FLOP share, in chunks of one rank, or of
``n / slice_align`` ranks), so each rank runs one level.  A slices table
that cannot be laid out (one level, fewer ranks than levels -- always so on
one rank -- or a ``slice_align`` that does not divide the ranks) falls back
to ``span`` with a structured warning, or raises under
``strict_placement``.  Rank r trains its block of each level as one batched
launch of kernels 1b/2b/3b; a client's draws stay keyed by its user, so it
trains the same way on whichever rank holds it.  The round then makes ONE
``Mesh.all_reduce_sum``: of the merged global ``(summed, counts)`` dense
or under the uniform codec (its payload, each rank encoding its own sums
with its own residual row and noise), or under the per-level map of every
level's payload at once (a dense level's sliced sums, a lossy level's
lanes; under ``slices`` a rank sends its identity payload for the levels
it does not run, and each lossy codec counts the level's ranks as its
participants).  That is the reference's fused-superstep contract, also in
the K=1 round, where the reference makes one psum a level
(``_level_prog``): a deliberate difference, the levels' sums associating
across the ranks in one buffer.  Each rank's metric rows (its levels'
blocks in order) reach every rank in one ``Mesh.gather_rows`` a round (a
superstep: one for its k rounds).  Without a process group the mesh is
one rank, and a round is what it was; so is every rank's twin under
``fed/sliced.py``.  The stream store and arms stay on one rank.

**The data mesh axis** (``Mesh.data_size`` > 1; ref grouped.py:458-529,
where ``_level_core`` vmaps the masked engine's local training, its
``data_axis`` passed through): the ranks of a clients row train the same
levels' blocks, each on its share of every step of every client, as the
masked engine's step splits one client's (``round_engine.py``).  Vision:
each client's ``n_glob`` is taken before the split, its augmentation drawn
over the whole batch from its generator and sliced (``_data_slice``; the
padding rows weigh 0), and BN is synchronised over the data group for the
G clients at once (``fused_norm.batch_norm_sync_clients``: two
all-reduces a site, kernels 1bs/2bs).  LM: this rank's ``bptt / data``
positions of every window, each client's corruption and dropout drawn over
the whole window and sliced, ring attention with the G clients folded into
its leading axes (one ring a layer for the level).  A level step sends its
packed ``g [G, ld]`` and the ``[G, 2]`` sums in ONE all-reduce over the
data group, then kernel 3b runs as on one rank; the round's one
all-reduce over the clients group is unchanged, each data column making
its own.  At data > 1 the superstep's steps run eagerly (a step holds
gloo collectives, which a CUDA graph cannot), with the same one fetch a
superstep.  Under ``slices`` a level's slice is a block of clients rows
with all their data columns.

**Experiment arms** (``multi/``; ref grouped.py:960-1010): the superstep
takes the arms' params ``[E, n]``; the ``[k, A]`` schedules, and so each
round's levels, are shared by the arms, each arm's stream draws its
clients' generators, budgets and failures, and the arms train one after
another through the same captured (level, G) steps (dense codec only,
no probes or gate, as the reference refuses them).
"""

from __future__ import annotations

import json
import math
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chaos.inject import poison_hits
from ..compress import make_codec, resolve_codec_cfg
from ..fed.core import (combine_counted, level_flop_table, level_index_map, round_seed,
                        snap_to_levels)
from ..models import make_model
from ..models.base import FedModel
from ..models.spec import label_vector
from ..ops.augment import augment_cifar, augment_draws, normalize_image
from ..ops.fused_update import FlatSpec, fused_sgd_batched
from ..ops.layers import clients_in_channels
from .round_engine import (FlatParams, RoundEngine, client_seed, cohort_rates,
                           superstep_schedules)
from .mesh import Mesh, block_bounds, single_mesh
from .staging import ClientStore, PendingMetrics, StagedCohort
from .step_graph import StepGraphs, device_counter


def row_stride(n: int) -> int:
    """The row stride of a level's ``[G, ld]`` buffers: ``n`` rounded up to
    a multiple of 4, so every client's row starts 16-byte aligned."""
    return -(-n // 4) * 4


def clients_row_chunks(n: int, align: int = 0) -> Optional[List[Tuple[int, int]]]:
    """The contiguous rank chunks a level boundary may land on (ref
    grouped.py:287-334): every rank alone -- a rank is one process holding
    one device, so a chunk is one rank -- or, with ``slice_align`` ``align >
    0``, ``n / align`` contiguous ranks a chunk, as on the reference's
    one-process mesh (None when ``align`` does not divide ``n``).  A chunk
    of several ranks needs no host alignment here: every rank joins the
    same one all-reduce, whatever level it trains."""
    if align > 0:
        if n % align:
            return None
        unit = n // align
        return [(i * unit, (i + 1) * unit) for i in range(align)]
    return [(i, i + 1) for i in range(n)]


def static_mesh_slices(cfg: Dict[str, Any], level_rates: Sequence[float], n: int
                       ) -> Tuple[Dict[float, Tuple[int, int]], str]:
    """Each level's block of ranks ``[lo, hi)`` over ``n`` ranks, in
    proportion to its expected FLOP share (ref grouped.py:336-397): fix
    mode weighs a level by its users, dynamic mode by its proportion, both
    times :func:`~..fed.core.level_flop_table`; every level gets at least one
    chunk (:func:`clients_row_chunks`), the floor's overshoot comes off the
    largest block, and the leftovers go to the most loaded level.  Returns
    ``(slices, "")``, or ``({}, reason)`` when no partition exists."""
    level_rates = sorted((float(r) for r in level_rates), reverse=True)
    if len(level_rates) <= 1:
        return {}, "a single level leaves nothing to slice"
    chunks = clients_row_chunks(n, int(cfg.get("slice_align") or 0))
    if chunks is None:
        return {}, (f"slice_align={cfg.get('slice_align')} does not divide the {n} ranks of "
                    f"the clients axis")
    if len(chunks) < len(level_rates):
        return {}, (f"{len(chunks)} clients rows cannot host {len(level_rates)} levels (each "
                    f"level needs at least one)")
    if cfg["model_split_mode"] == "fix":
        vec = np.asarray(cfg["model_rate"], np.float64)
        # staticcheck: allow(no-float-coercion) a numpy count of the config's users
        weights = [float((vec == r).sum()) for r in level_rates]
    else:
        order = {float(r): i for i, r in enumerate(cfg["model_rate"])}
        weights = [float(cfg["proportion"][order[r]]) for r in level_rates]
    table = level_flop_table(cfg, level_rates)
    shares = np.maximum(np.array([w * table[r] for w, r in zip(weights, level_rates)],
                                 np.float64), 1e-9)
    units = len(chunks)
    rows = np.maximum(1, np.floor(shares / shares.sum() * units)).astype(int)
    while rows.sum() > units:  # the floor of one can overshoot
        rows[int(np.argmax(np.where(rows > 1, rows, -1)))] -= 1
    while rows.sum() < units:  # leftovers to the most loaded level
        rows[int(np.argmax(shares / rows))] += 1
    out, lo = {}, 0
    for r, k in zip(level_rates, rows):
        out[r] = (chunks[lo][0], chunks[lo + int(k) - 1][1])
        lo += int(k)
    return out, ""


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
    """This rank's block of one level's slots in one round of the
    superstep: its rate, the slots' positions in the round and their users
    (``-1`` slots as user 0, the reference's ``max(uid, 0)``), their rows
    of the data stacks on the device (the users themselves in the eager
    stacks, their slots in a cohort's), their rows of this rank's metric
    rows on the device, each row's step budget on the
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

    def __init__(self, model: FedModel, cfg: Dict[str, Any], device: torch.device,
                 mesh: Optional[Mesh] = None):
        # a lossy codec (or per-level map) is refused at superstep_rounds 1
        name, ef = resolve_codec_cfg(dict(cfg, strategy="grouped"))
        self.model, self.cfg, self.device = model, cfg, device
        # the clients axis (parallel/mesh.py): one rank without a group
        self.mesh = single_mesh(device) if mesh is None else mesh
        self.is_lm = model.meta["kind"] == "transformer"
        if self.is_lm:
            self.bptt = cfg["bptt"]
        # the data axis: each client's batch (an LM window's positions) split
        # over this row's data ranks, a level's G clients at once
        self._init_data_axis()
        self.spec = FlatSpec.of(dict(model.named_parameters()))
        self.codec_map = name if isinstance(name, dict) else None
        # a participant a rank of the mesh, as the masked engine's codec
        self.codec = None if self.codec_map else make_codec(name, self.spec, self.mesh.size,
                                                            error_feedback=ef)
        self._resid = None
        self._init_sched(cfg)
        self._init_obs(cfg)
        self._init_arms(cfg)
        # the superstep's captured batched steps, one a (level, G) met, their
        # static buffers and generators; at data > 1 they run eagerly (a step
        # holds collectives, which gloo cannot put in a CUDA graph)
        self.graphs = StepGraphs(device, capture=self.n_data == 1)
        self._st: Dict[Tuple[float, int], Dict[str, torch.Tensor]] = {}
        self._ggens: List[torch.Generator] = []
        self._lr = torch.zeros((), dtype=torch.float32, device=device)
        self.levels: Dict[float, Level] = {
            rate: Level(cfg, rate, model, self.spec, device)
            for rate in sorted({float(r) for r in cfg["model_rate"]}, reverse=True)}
        # the level placement: every level over every rank ('span'), or each
        # level over its own block of ranks ('slices', self.slices)
        self.level_placement = cfg.get("level_placement", "span") or "span"
        if self.level_placement not in ("span", "slices"):
            raise ValueError(f"Not valid level_placement: {self.level_placement!r}")
        self.slices: Dict[float, Tuple[int, int]] = {}
        if self.level_placement == "slices":
            self.slices, reason = static_mesh_slices(cfg, list(self.levels), self.mesh.size)
            if not self.slices:
                self._refuse_slices(reason)
        self._map_codecs: Dict[float, Tuple[Any, int]] = {}
        self._total_lossy = 0
        if self.codec_map is not None:
            self._map_layout(ef)
        eng0 = next(iter(self.levels.values())).engine
        self.local_epochs, self.batch_size = eng0.local_epochs, eng0.batch_size
        self.fused_mode, self.momentum, self.weight_decay = \
            eng0.fused_mode, eng0.momentum, eng0.weight_decay
        if not self.is_lm:
            self.norm, self.augment = eng0.norm, eng0.augment

    # -- the clients mesh axis ----------------------------------------------

    def _refuse_slices(self, reason: str) -> None:
        """A slices placement that cannot be honoured (ref grouped.py:
        266-285): a structured warning and ``span``, or ``ValueError``
        under ``cfg['strict_placement']``."""
        detail = json.dumps({"event": "slices-fallback", "reason": reason,
                             "clients_rows": self.mesh.size, "processes": self.mesh.size},
                            sort_keys=True)
        if self.cfg.get("strict_placement"):
            raise ValueError(f"level_placement='slices' cannot be honoured and strict_placement "
                             f"is set: {reason} ({detail})")
        warnings.warn(f"level_placement='slices' falling back to 'span': {reason} ({detail})")
        self.level_placement = "span"

    def _by_level(self, rates: np.ndarray) -> List[Tuple[float, List[int]]]:
        """A round's slots grouped by level after snapping their rates onto
        the level table: ``(rate, schedule positions)``, descending rate."""
        by_level: Dict[float, List[int]] = {}
        # staticcheck: allow(no-device-get) a numpy array
        for pos, r in enumerate(snap_to_levels(rates, self.levels).tolist()):
            by_level.setdefault(r, []).append(pos)
        return [(rate, by_level[rate]) for rate in sorted(by_level, reverse=True)]

    def level_ranks(self, rate: float) -> Tuple[int, int]:
        """The ranks ``[lo, hi)`` that train level ``rate``: every rank
        under ``span``, the level's block under ``slices``."""
        return self.slices[rate] if self.slices else (0, self.mesh.size)

    def _block(self, rate: float, n: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """Rank ``rank``'s (default this rank's) contiguous block ``[a, b)``
        of a level's ``n`` slots: ``ceil(n / ranks)`` a rank over the
        level's ranks (the reference's slots under ``P("clients")``, not
        bucketed), empty off them."""
        rank = self.mesh.rank if rank is None else rank
        lo, hi = self.level_ranks(rate)
        if not lo <= rank < hi:
            return 0, 0
        return block_bounds(n, hi - lo, rank - lo)

    def _rank_rows(self, levels: Sequence[Tuple[float, Sequence[int]]]) -> List[List[int]]:
        """Each rank's metric rows of one round (``levels``: each level's
        rate and schedule positions, descending rate): the positions it
        trains, level by level, each level's block in order."""
        rows: List[List[int]] = [[] for _ in range(self.mesh.size)]
        for rate, pos in levels:
            for d in range(self.mesh.size):
                a, b = self._block(rate, len(pos), d)
                rows[d] += list(pos[a:b])
        return rows

    def _collect(self, train: List[torch.Tensor], rows: List[List[List[int]]], a: int
                 ) -> List[torch.Tensor]:
        """The k rounds' ``[A, 3]`` metric rows in schedule order from each
        rank's ``[m, 3]`` rows of every round (``rows[r][rank]`` their
        positions, :meth:`_rank_rows`): ONE ``Mesh.gather_rows`` of the
        stacked ``[k, m, 3]`` (under arms, which stay on one rank, the rows
        themselves), then ``RoundEngine._to_schedule`` a round."""
        local = torch.stack(train)
        g = local if self.arms is not None else self.mesh.gather_rows(local)
        k, m = local.shape[0], local.shape[1]
        g = g.view(self.mesh.size, k, m, 3)
        return [RoundEngine._to_schedule(g[:, r].reshape(self.mesh.size * m, 3), rows[r], m, a)
                for r in range(k)]

    # -- one level's clients ------------------------------------------------

    def _step(self, lv: Level, p, buf, g, grads, n_glob, lr, live=None, sums=None
              ) -> Optional[torch.Tensor]:
        """The optimizer tail of one step of G clients, in place on ``p``
        and ``buf`` ``[G, n_l]`` (views of ``[G, ld]`` rows): the batched
        fused epilogue (gradients packed client-major into ``g [G, ld]``),
        or each client's per-leaf chain.  A row steps where its batch has
        weight and, with ``live [G]`` (bool), where it is live.  With
        ``sums [G, 2]`` (the data axis) the packed gradient and ``sums`` go
        out in ONE all-reduce over the data group first; ``n_glob`` None
        takes the reduced ``sums[:, 1]``.  Returns the reduced ``sums``."""
        self.local_steps += 1  # eager calls only: a replayed step does not count
        G, n = p.shape[0], lv.spec.total
        if sums is not None or self.fused_mode is not None:
            torch.cat([gr.reshape(G, -1) for gr in grads] + lv.pad(G), dim=1, out=g)
        if sums is not None:
            red, sums = self.mesh.all_reduce_sum([g, sums], axis="data")
            g.copy_(red)
            if n_glob is None:
                n_glob = sums[:, 1]
            grads = [g[:, lv.spec.offsets[k]:lv.spec.offsets[k] + lv.spec.sizes[k]]
                     .view((G,) + lv.spec.shapes[k]) for k in lv.spec.names]
        has = n_glob > 0 if live is None else (n_glob > 0) & live
        if self.fused_mode is None:
            for i in range(G):
                lv.engine._reference_step(p[i], buf[i], [gr[i] for gr in grads], lv.mask,
                                          n_glob[i], lr, has[i])
            return sums
        scal = torch.stack([n_glob.clamp_min(1e-6), lr.expand(G), has.to(torch.float32)],
                           dim=1)
        fused_sgd_batched(g[:, :n], p, buf, lv.mask, scal, momentum=self.momentum,
                          weight_decay=self.weight_decay, max_norm=1.0)
        return sums

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
        # staticcheck: allow(no-float-coercion) numpy budgets
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
        as the reference's deadline gates a step (round_engine.py:688-713).
        At data > 1 each client's slice of its batch (``_data_slice``; its
        augmentation drawn for the whole batch, then sliced), BN synchronised
        over the data group, and the packed gradient with the ``[G, 2]``
        ``[loss_sum, correct]`` reduced over it in one all-reduce."""
        B, G = self.batch_size, len(gens)
        n_glob = w.sum(1)  # each client's whole batch's weight, before any split
        group = None
        if self.n_data > 1:
            group = self.mesh
            if self.augment and draws is None:
                draws = [augment_draws(B, gen, xb.device) for gen in gens]
            src, keep = self._data_slice(B, w.device)
            xb, labels, w = xb[:, src], labels[:, src], w[:, src] * keep
            draws = None if draws is None else [tuple(a[src] for a in d) for d in draws]
            B = src.numel()
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
            scaler_rate=lv.scaler_rate, label_mask=st["lm"], sample_weight=w, bn_group=group)
        lsum = loss * (n_glob if group is None else w.sum(1))  # weighted-SUM form, each client's
        grads = torch.autograd.grad(lsum.sum(), [leaves[k] for k in lv.spec.names])
        del leaves
        correct = ((score.detach().argmax(-1) == labels).to(torch.float32) * w).sum(1)
        n = lv.spec.total
        sums = None if group is None else torch.stack([lsum.detach(), correct], dim=1)
        sums = self._step(lv, st["p"][:, :n], st["buf"][:, :n], st["g"], grads, n_glob, st["lr"],
                          live, sums)
        del grads
        if sums is not None:
            lsum, correct = sums[:, 0], sums[:, 1]
        sums = [lsum.detach(), correct, n_glob]
        if live is not None:
            gate = live.to(torch.float32)
            sums = [v * gate for v in sums]
        st["acc"] += torch.stack(sums, dim=1)

    def _level_lm_step(self, lv: Level, st, gens: List[torch.Generator], lab, w, n_glob,
                       draws=None, live=None) -> None:
        """One batched step of G masked-LM clients on their windows ``(lab
        [G, R, bptt], w)`` of weight sums ``n_glob [G]``, in place on
        ``st`` (as :meth:`_level_vision_step`'s, and ``rows_n``).  At data
        > 1 this rank's positions of every window, ring attention over the
        data group (one ring for the G clients), and the packed gradient with
        the ``[G, 2]`` ``[loss_sum, n_loc]`` reduced over it in one
        all-reduce, whose sums are ``n_glob``."""
        G = len(gens)
        extra = {}
        if self.n_data > 1:
            s_loc = lab.shape[2] // self.n_data
            off = self.mesh.data_rank * s_loc
            lab, w = lab[:, :, off:off + s_loc], w[:, :, off:off + s_loc]
            extra = {"pos_offset": off, "seq_full": s_loc * self.n_data, "attn": self._ring}
        leaves = lv.leaves(st["p"].view(-1).index_select(0, lv.leaf_major(G)), G)
        _, loss = lv.model.forward_clients(
            lab, G, params=leaves, scaler_rate=lv.scaler_rate, label_mask=st["lm"],
            sample_weight=w, gens=gens, draws=draws, **extra)
        n_loc = n_glob if not extra else w.sum((1, 2))
        lsum = loss * n_loc
        grads = torch.autograd.grad(lsum.sum(), [leaves[k] for k in lv.spec.names])
        del leaves
        n = lv.spec.total
        if extra:
            sums = self._step(lv, st["p"][:, :n], st["buf"][:, :n], st["g"], grads, None,
                              st["lr"], live, torch.stack([lsum.detach(), n_loc], dim=1))
            lsum, n_glob = sums[:, 0], sums[:, 1]
        else:
            self._step(lv, st["p"][:, :n], st["buf"][:, :n], st["g"], grads, n_glob, st["lr"],
                       live)
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
        self._refuse_arms_k1()
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
        # staticcheck: allow(no-float-coercion) numpy limits
        gate = bool((limits < total).any())  # a slot sits out or stops early
        levels = self._by_level(rates_abs)
        rows = self._rank_rows(levels)
        dev = P.device
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=dev)
        sums: Dict[float, Tuple[torch.Tensor, torch.Tensor]] = {}
        # this rank's metric rows, its levels' blocks one after another
        acc = torch.zeros((max(len(r) for r in rows), 3), dtype=torch.float32, device=dev)
        off = 0
        oks, gpos = ([], []) if self._quarantine.enabled else (None, None)
        for rate, all_pos in levels:
            a, b = self._block(rate, len(all_pos))
            if a == b:
                continue
            lv, pos = self.levels[rate], all_pos[a:b]
            # staticcheck: allow(no-device-get) a numpy array
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
            acc[off:off + len(pos)] = acc_l
            off += len(pos)
        if codec_slots is None:
            codec_slots = self.codec_slots(rates_abs[None])
        new_P, summed, counts = self._merge(P, sums, round_seed, len(user_idx), codec_noise,
                                            codec_slots)
        (acc,) = self._collect([acc], [rows], len(user_idx))
        ms = {"loss_sum": acc[:, 0], "score_sum": acc[:, 1], "n": acc[:, 2],
              "rate": rates_abs * valid}
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
        """A level's slots a rank over the ``[k, A]`` rates of a superstep,
        as the reference's layout counts them (ref grouped.py:1305-1335):
        the most clients a rank of any level holds in any of the k rounds
        (``ceil(G / ranks)`` over the level's ranks), at least 1, rounded
        up to a power of two.  A per-level map sizes each lossy level's
        grid for it (ref grouped.py:1103-1159, ``encode(..., per_dev)``)."""
        need = 1
        for row in np.asarray(rate_schedule, np.float32):
            for rate, pos in self._by_level(row):
                lo, hi = self.level_ranks(rate)
                need = max(need, -(-len(pos) // (hi - lo)))
        return 1 << (need - 1).bit_length()

    def codec_slots(self, rate_schedule) -> int:
        """The clients one wire codec's grid is sized for over the ``[k,
        A]`` rates of a superstep (ref grouped.py:900): :meth:`level_slots`
        times the levels a rank runs (every level under ``span``, its own
        under ``slices``); under a per-level map, a level's own
        :meth:`level_slots`."""
        slots = self.level_slots(rate_schedule)
        if self.codec_map is not None:
            return slots
        return (1 if self.slices else len(self.levels)) * slots

    # -- the per-level wire-codec map -----------------------------------------

    @property
    def lossy(self) -> bool:
        return self.codec is not None or bool(self._map_codecs)

    def _map_layout(self, ef: bool) -> None:
        """The per-level map's layout (ref grouped.py:399-444): its keys
        must be the level table; each lossy level gets a codec over its
        sliced flat layout (the level model's), its participants the ranks
        that encode it (every rank under ``span``, the level's block under
        ``slices``, the other ranks sending its identity payload), and the
        offset of its columns in ONE residual ``[2, total_lossy]``, lossy
        levels in descending rate (row 1 only written by ``topk``).  A map
        of dense levels only is ``dense`` (``resolve_codec_cfg``)."""
        if set(self.codec_map) != set(self.levels):
            raise ValueError(
                f"per-level wire_codec map keys {sorted(self.codec_map)} do not match the "
                f"engine's level table {sorted(self.levels)}: every level needs exactly one "
                f"codec")
        off = 0
        for rate, lv in self.levels.items():
            name = self.codec_map[rate]
            if name != "dense":
                lo, hi = self.level_ranks(rate)
                self._map_codecs[rate] = (make_codec(name, lv.spec, hi - lo, error_feedback=ef),
                                          off)
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
        """The round's new global params from this rank's trained levels'
        sliced counted sums ``{rate: (s_l, c_l)}``, in ONE all-reduce over
        the mesh.  Dense or under the uniform codec: the sums added into
        zero global buffers at each level's entries, levels in descending
        rate (the reference's ``merge``), then reduced, compressed (its
        grid sized for ``cmax`` clients) and averaged by
        :meth:`FlatParams._aggregate`.  Under a per-level map (ref
        grouped.py:1013-1162): every level's payload goes into the one
        all-reduce (:meth:`_reduce_levels`) -- a dense level its float32
        sums, a lossy level its codec's lanes, encoded from its sums (zeros
        where this rank trained none of its clients, as the reference runs
        every level's slots) with this rank's residual columns and noise on
        a grid sized for ``cmax`` slots and the global params at its
        entries, by each rank the level runs on (the others send its
        identity payload) -- then each level is decoded and added.
        ``codec_noise``: the uniform codec's int8 noise, or under a map
        ``{rate: draw}`` (an int8 level's noise ``[n_l]``, a topk level's
        block offset), test hooks replacing this rank's draws from
        ``rseed``.  Returns ``(new P, summed, counts)``, the merged global
        sums the combine read (decoded)."""
        if self.codec_map is None or not n_clients:
            summed = torch.zeros_like(P)
            counts = torch.zeros_like(P)
            for rate, lv in self.levels.items():  # descending rate
                if rate in sums:
                    summed.index_add_(0, lv.idx, sums[rate][0])
                    counts.index_add_(0, lv.idx, sums[rate][1])
            return self._aggregate(P, summed, counts, rseed, n_clients, codec_noise, cmax=cmax)
        resid = self._ensure_resid(P.device)
        new_resid = torch.zeros_like(resid)
        summed = torch.zeros_like(P)
        counts = torch.zeros_like(P)
        # one process: the all-reduce is the identity, so each level is
        # decoded and added as it is encoded and only its payload waits (an
        # untrained dense level adds nothing); over ranks every level waits
        # for the one all-reduce, a lossy level with its params ``P_l``
        now = not self.mesh.distributed
        parts, held = [], []
        for rate, lv in self.levels.items():  # descending rate
            lossy = rate in self._map_codecs
            if now and not lossy and rate not in sums:
                continue
            n = lv.spec.total
            s_l, c_l = sums[rate] if rate in sums else (P.new_zeros(n), P.new_zeros(n))
            draw = P_l = None
            if not lossy:
                payload = {"s": s_l, "c": c_l}
            else:
                cobj, off = self._map_codecs[rate]
                lo, hi = self.level_ranks(rate)
                P_l = P.index_select(0, lv.idx)
                draw = None if codec_noise is None else codec_noise.get(rate)
                if lo <= self.mesh.rank < hi:
                    if draw is None:
                        draw = cobj.draw(rseed, P.device, self.mesh.rank)
                    slots = cobj.resid_slots
                    payload, new_resid[:slots, off:off + n] = cobj.encode(
                        s_l, c_l, resid[:slots, off:off + n], P_l, draw, cmax)
                else:  # the level's identity payload; its decode reads the topk block alone
                    payload = cobj.zero_payload(P.device)
                    if draw is None and cobj.name == "topk":
                        draw = cobj.draw(rseed, P.device, self.mesh.rank)
            parts.append((rate, payload))
            if now:
                self._add_level(summed, counts, rate, payload, P_l, draw, cmax)
            else:
                held.append((P_l, draw))
        reduced = self._reduce_levels(parts)
        if not now:
            for (rate, _), agg, (P_l, draw) in zip(parts, reduced, held):
                self._add_level(summed, counts, rate, agg, P_l, draw, cmax)
        self._resid = new_resid
        return combine_counted(P, summed, counts), summed, counts

    def _add_level(self, summed, counts, rate: float, agg: Dict[str, torch.Tensor], P_l, draw,
                   cmax: int) -> None:
        """Add a level's summed payload at its entries: a dense level's sums,
        a lossy level's decoded from its params ``P_l``."""
        lv = self.levels[rate]
        if rate in self._map_codecs:
            s_l, c_l = self._map_codecs[rate][0].decode(agg, P_l, draw, cmax)
        else:
            s_l, c_l = agg["s"], agg["c"]
        summed.index_add_(0, lv.idx, s_l)
        counts.index_add_(0, lv.idx, c_l)

    def _reduce_levels(self, payloads: Sequence[Tuple[float, Dict[str, torch.Tensor]]]
                       ) -> List[Dict[str, torch.Tensor]]:
        """Every level's payload (``(rate, {name: tensor})``, descending
        rate) summed over the ranks in ONE ``Mesh.all_reduce_sum`` (the
        reference's one psum bind of the payload tree, grouped.py:1077-1079,
        :1137-1140) -> each level's summed payload."""
        flat = [t for _, payload in payloads for t in payload.values()]
        out = iter(self.mesh.all_reduce_sum(flat))
        return [{name: next(out) for name in payload} for _, payload in payloads]

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
            # staticcheck: allow(no-fresh-rng) seeded per client in stage_level
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
        added at the level's entries; then the round's one all-reduce, the
        codec (its grid sized for ``cmax`` clients), the counted average
        and the probes -> ``(new P, [m, 3] device sums of this rank's rows,
        reported rates, obs rows or None)``.  ``plan``: the round's valid
        slots, budgets, this rank's :class:`LevelPlan` s and ``m``, the
        rows a rank of the superstep (:meth:`_plans`); hooks as
        :meth:`train_superstep`'s, this round's."""
        valid, limits, levels, m = plan
        sums: Dict[float, Tuple[torch.Tensor, torch.Tensor]] = {}
        acc = torch.zeros((m, 3), dtype=torch.float32, device=P.device)
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
        """Each round's ``(valid slots, budgets, [LevelPlan], m)`` and each
        round's rows of every rank (:meth:`_rank_rows`): its slots' plan
        (:meth:`slot_plan` at the round's seed) and this rank's block of
        each of its levels in descending rate (:meth:`_block`; a level with
        no slot here has no plan), ``m`` the most rows a rank holds in any
        round; the data rows (``rows [k, A]``, default the users, ``-1`` as
        0), row offsets, budgets and valid rows of the whole superstep go
        to the device in one copy.  The steps gate their rows by the
        budgets when some slot of the superstep sits out or stops early,
        and run as without a scheduler otherwise."""
        if rows is None:
            rows = np.maximum(users, 0)
        total, plans, host, rank_rows = self.total_steps(data), [], [], []
        for r in range(users.shape[0]):
            valid, limits = self.slot_plan(
                users[r], round_seed(seed, epoch0 + r), total,
                None if step_limits is None else step_limits[r],
                None if alive is None else alive[r])
            by_level = self._by_level(rates[r])
            rank_rows.append(self._rank_rows(by_level))
            levels, off = [], 0
            for rate, all_pos in by_level:
                a, b = self._block(rate, len(all_pos))
                if a == b:
                    continue
                pos = all_pos[a:b]
                levels.append((rate, pos, np.maximum(users[r][pos], 0)))
                host += [rows[r][pos], np.arange(off, off + len(pos)), limits[pos], valid[pos]]
                off += len(pos)
            plans.append((valid, limits, levels))
        m = max(len(mine) for rr in rank_rows for mine in rr) if rank_rows else 0
        flat = torch.from_numpy(np.concatenate(host).astype(np.int64)).to(device) if host \
            else None
        # staticcheck: allow(no-float-coercion) numpy limits
        gate = any(bool((limits < total).any()) for _, limits, _ in plans)
        out, off = [], 0
        for valid, limits, levels in plans:
            rnd = []
            for rate, pos, uids in levels:
                G = len(pos)
                seg = [flat[off + i * G:off + (i + 1) * G] for i in range(4)]
                off += 4 * G
                rnd.append(LevelPlan(
                    # staticcheck: allow(no-device-get) a numpy array
                    rate, pos, uids.tolist(), seg[0], seg[1],
                    # staticcheck: allow(no-float-coercion) numpy limits
                    seg[2] if gate else None, int(limits[pos].max()) if gate else total,
                    None if valid[pos].all() else seg[3].to(torch.float32)))
            out.append((valid, limits, rnd, m))
        return out, rank_rows

    def stage_cohort(self, store: ClientStore, user_schedule, rate_schedule) -> StagedCohort:
        """Gather and commit one superstep's cohort from ``store`` in the
        per-level slot layout (ref grouped.py:1305-1413): ``[k, L, per]``
        slots, round r's level-l clients (levels in descending rate, a
        ``-1`` slot at user ``U - 1``'s) in the first slots of ``[r, l]``,
        ``per`` the most clients a level holds in a round rounded up to a
        power of two, the slots left over ``-1`` (user 0's shard, never
        read); each level's rows are contiguous.  Through the engine's
        cohort ring, O(k x L x per x shard) bytes whatever the population;
        call it for superstep N+1 right after superstep N is dispatched.
        One rank only: the stream store is not on the mesh yet."""
        if self.mesh.size > 1:
            raise NotImplementedError(
                "client_store='stream' at several ranks: the clients mesh axis does not carry "
                "it yet (ROADMAP Queue 1 item 5, the stream store on the mesh)")
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
        ``alive[r]`` the deadline budgets and the survivors in slot order.

        Under ``cfg['arms']`` (dense codec only; ref grouped.py:960-1010):
        ``P`` is the arms' params ``[E, n]`` and ``lrs`` ``[E, k]`` (or the
        shared ``[k]``, scaled per arm); the ``[k, A]`` schedules, and so
        each round's levels and the codec's grid, are shared by the arms,
        while each arm's stream (``fed.core.arm_stream_seed`` of ``seed``)
        draws its clients' generators, deadline budgets and failures.  The
        arms train one after another, each level's G clients of an arm in
        one launch of kernels 1b/2b/3b, as in a solo run; the hooks take a
        leading arm index."""
        if self.arms is not None and cohort is not None:
            raise ValueError(
                "arms need the eager data path: a staged cohort holds "
                "ONE schedule's shards, and per-arm cohorts would "
                "multiply the staged bytes by E (a ROADMAP follow-on)")
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            if self.arms is None:
                data, user_schedule, rate_schedule, rows = self._cohort_args(
                    "grouped", k, data, user_schedule, rate_schedule, cohort)
                P, tree, assemble, timers = self._superstep_arm(
                    P, seed, epoch0, k, data, user_schedule, rate_schedule, lrs, eval_mask,
                    fused_eval, epoch_perms, codec_noise, step_limits, alive, rows)
                return P, PendingMetrics(tree, assemble, timers)
            if np.asarray(user_schedule).ndim != 2 or np.asarray(rate_schedule).ndim != 2:
                raise ValueError("grouped arms share one [k, A] user and rate schedule (the "
                                 "level-grouped slots are the arms'), not one an arm")

            def hook(h, e):
                return None if h is None else h[e]

            return self._arms_superstep(
                P, seed, k, user_schedule, rate_schedule, lrs,
                lambda e, Pe, aseed, u, rt, lrs_e: self._superstep_arm(
                    Pe, aseed, epoch0, k, data, u, rt, lrs_e, eval_mask, fused_eval,
                    hook(epoch_perms, e), hook(codec_noise, e), hook(step_limits, e),
                    hook(alive, e), None))
        finally:
            torch.backends.cudnn.deterministic = deterministic
            if cohort is not None:
                cohort.release()

    def _superstep_arm(self, P, seed, epoch0, k, data, user_schedule, rate_schedule, lrs,
                       eval_mask, fused_eval, epoch_perms, codec_noise, step_limits, alive, rows):
        """One trajectory's rounds of :meth:`train_superstep` (the run's, or
        an arm's on its stream root ``seed``) -> the superstep's parts
        (``_superstep_parts``)."""
        users, rates, lrs = superstep_schedules(user_schedule, rate_schedule, lrs, k)
        plans, rank_rows = self._plans(seed, epoch0, users, rates, data, P.device, step_limits,
                                       alive, rows)
        cmax = self.codec_slots(rates)
        return self._superstep_parts(
            P, seed, epoch0, k, users, rates, lrs, eval_mask, fused_eval, self._lr,
            lambda P, r, u, rates, rseed: self._replayed_round(
                P, u, rates, data, rseed, plans[r], cmax,
                None if epoch_perms is None else epoch_perms[r],
                None if codec_noise is None else codec_noise[r], epoch0 + r),
            finish=lambda train: self._collect(train, rank_rows, users.shape[1]))
