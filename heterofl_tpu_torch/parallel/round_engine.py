"""The federated round engine on one GPU.

Port of ``heterofl_tpu/parallel/round_engine.py`` (``train_round`` ->
``_round_core`` -> ``_local_train_vision`` / ``_local_train_lm``, masked
strategy, ``fix`` and ``dynamic`` rates).  The reference runs a round as one
XLA program with the clients under ``vmap``; here the clients train one after another
in a Python loop (batching them is later work), each through:

* its width mask applied to the global params (distribute);
* per local epoch a shuffle, then a stable sort that puts real samples
  first, ``ceil(N/B)`` steps per epoch, all-padding batches gated off by
  ``has``;
* per step the model forward/backward on leaf views of ONE flat params
  buffer (weighted-SUM loss), the per-leaf gradients packed into one flat
  buffer, and the fused masked-SGD epilogue over the flat params, momentum,
  gradient and hoisted width mask (ops/fused_update.py) -- or, with
  ``fused_update=False``, the per-leaf reference chain on views of the same
  buffers;
* a masked-LM client (:meth:`RoundEngine.local_train_lm`) instead runs
  ``E * ceil(T / bptt)`` steps over its token rows' bptt windows in order
  (zero position weights on the padded tail), through the same fused
  epilogue; its draws (token corruption, dropout) come from its generator;
* aggregation in the flat domain: ``sum += trained * count_mask``,
  ``count += count_mask``, then the counted average with stale fallback.
  With a lossy ``wire_codec`` the flat ``(sum, count)`` pair goes through
  the codec first (compress/codecs.py: encode, the sum over participants,
  decode), and the codec's error-feedback residual is carried on the device
  from round to round (the reference's ``_WireCodecCarry``);
* the client scheduler (``sched/``; :meth:`FlatParams.slot_plan`): a
  ``-1`` slot (a schedule's padding) or a failed client
  (``client_failure_rate``) trains nothing and reports a zero metrics row;
  under a deadline a client stops after its budget of local steps (the
  reference gates the steps past it, which changes nothing either); with
  buffered aggregation the round applies the previous round's sums and
  buffers its own (``sched/buffer.py``), the ``[2, total]`` buffer carried
  on the device beside the residual.  The codec's grid is sized for the
  round's slots, padding and failed ones included, and the codec runs
  whenever the round has slots, as the reference's does.

The step loop never waits for the device: the batch weight sum, ``lr`` and
``has`` stay device tensors the kernel reads by pointer, and no value is
read back per step.  Per-client randomness (epoch permutations,
augmentation draws) comes from a ``torch.Generator`` on the device seeded
from (round seed, user id), and a ``dynamic`` round's rates from
``fed.core.round_rates`` on the host; ``jax.random`` streams are not
reproducible in torch, so tests hand in the reference's rates, epoch
permutations and augmentation draws (and an LM client's corruption and
dropout draws) instead.  Every width mask a round can need is on the device
before the first round.

With ``client_store='stream'`` a superstep reads a cohort
(:meth:`RoundEngine.stage_cohort`, ``parallel/staging.py``) instead of the
``[U, ...]`` stacks: a client's data is its slot's row of the cohort
(``rows``), the same steps on the same bytes.

Observability and its guards (``obs/``, ``chaos/``; ref round_engine.py:
926-1030): a ``chaos_poison`` (round, uid) makes that client's trained
params NaN, then ``quarantine`` gates each client's update before the sum
(``FlatParams._guard``); after the aggregation ``telemetry`` adds the
round's probes on the device (``FlatParams._round_obs``).  Their rows ride
the round's (the superstep's) one fetch and are finished on the host
(``obs.split_probes``).  With all of them off a round runs as before.

Experiment arms (``multi/``; ref round_engine.py:278-300, 483-520,
1131-1420, 1686-1761): with ``cfg['arms']`` the superstep takes the arms'
params stacked ``[E, n]`` and trains the arms one after another
(:meth:`FlatParams._arms_superstep`), arm e on its own stream
(``fed.core.arm_stream_seed``), cohorts, rates and learning rates, with its
own wire-codec residual and its own probe and gate rows, every arm's
clients replaying the same captured steps (arm e's params copied into the
static buffers as any client's are); every arm's metrics ride ONE fetch.
The K=1 round refuses arms, as the reference's does.

The clients mesh axis (``parallel/mesh.py``; ref round_engine.py:215-240,
965-985, 1166-1167, 1431-1451, 1566-1600): at a world of n ranks a round's
slots are laid out as the reference lays them over its ``clients`` axis
(:func:`rank_slots`) -- ``ceil(A / n)`` a rank in schedule order, in
contiguous blocks, the padding slots training nothing; under
``data_placement='sharded'`` each rank holds only its block of users'
shards (:func:`shard_client_data`) and trains the cohort's users it holds.
Rank r trains only its slots (a client's draws stay keyed by
``client_seed(round_seed, uid)``, so it trains the same way on whichever
rank holds it), then the round's ``(summed, counts)`` go out in ONE
``Mesh.all_reduce_sum`` (:meth:`FlatParams._aggregate`, K=1 and the
superstep alike); under a wire codec each rank encodes its partial sums
with its own residual row and rounding noise (participant index = rank),
the packed payload is all-reduced once and every rank decodes it.  The
per-slot metric rows reach every rank in one ``Mesh.gather_rows`` a round
(a superstep: one for its k rounds), back in schedule order.  Without a
process group the mesh is one rank, and a round is what it was.

The data mesh axis (``Mesh.data_size`` > 1; ref round_engine.py:637-815):
the ranks of a clients row train the same slots, each on its share of
every step.  Vision: rank ``d`` takes ids ``[d * b_loc, (d + 1) * b_loc)``
of the step's B, ``b_loc = ceil(B / n_data)``, the ids padded with
weight-0 repeats to ``b_loc * n_data``; ``n_glob`` is the whole batch's
weight, taken before the split; the BN sites are synchronised over the
data group (``fused_norm.batch_norm_sync``).  LM: rank ``d`` holds
positions ``[d * s_loc, (d + 1) * s_loc)`` of every window, ``s_loc = bptt
/ n_data``, its attention ring attention over the data group
(``parallel/ring_attention.py``), its ``n_glob`` the reduced position
weight.  Each step's packed gradient rides ONE all-reduce over the data
group with ``[loss_sum, correct]`` (the LM: ``[loss_sum, n_loc]``), then
the fused epilogue runs as on one rank; the round's aggregation stays one
all-reduce over the clients group.  Every draw is made over the whole
batch (window) on every rank of a row and sliced -- the epoch
permutations, the augmentation, the LM's corruption and dropout -- so the
ranks' generators stay in step and the split consumes the one-rank run's
draws (a deliberate difference: the reference folds the data rank into the
augmentation and dropout keys, ``fold_in(aug_key, d)``, ``fold_in(drop_base,
off)``).  At data > 1 the superstep runs its steps eagerly (a step holds
collectives, which gloo cannot put in a CUDA graph), with the same one
fetch a superstep.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chaos import resolve_poison_cfg
from ..chaos.inject import poison_hits, poison_updates
from ..compress import make_codec, resolve_codec_cfg
from ..config import resolve_prefetch_depth
from ..compress.codecs import compressed_sum
from ..data.datasets import DATASET_STATS
from ..fed.core import (arm_stream_seeds, client_alive, combine_counted, round_rates, round_seed,
                        to_width_rates)
from ..models.base import FedModel
from ..multi import ArmsSpec, resolve_arms_cfg
from ..models.spec import label_vector, param_mask
from ..obs import QuarantineSpec, obs_levels, resolve_quarantine_cfg, resolve_telemetry_cfg, \
    split_probes
from ..obs.hist import stale_hist
from ..obs.probes import quarantine_gate, round_probes, segment_ends
from ..ops.augment import augment_cifar, augment_draws, normalize_image
from ..ops.fused_update import FlatSpec, fused_sgd_flat, make_scal, resolve_fused_mode
from ..sched import ScheduleSpec, resolve_schedule_cfg
from ..sched.buffer import buffered_combine
from ..sched.deadline import deadline_steps
from ..utils.optim import clip_by_global_norm, sgd_update
from .mesh import Mesh, block_bounds, single_mesh
from .ring_attention import ring_attention
from .staging import ClientStore, CohortStager, PendingMetrics, StagedCohort
from .step_graph import StepGraphs, device_counter, maybe_event


def norm_stats_tensors(cfg: Dict[str, Any], device: torch.device
                       ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The vision normalisation ``(mean, std)`` on the device, in the
    reference's order: the computed statistics (``cfg['norm_stats']``,
    ``entry.common._maybe_compute_norm_stats``), else the dataset's
    ``DATASET_STATS`` entry, else None (the images go in as floats of
    their bytes, as in the reference)."""
    stats = cfg.get("norm_stats") or DATASET_STATS.get(cfg["data_name"])
    if stats is None:
        return None
    return tuple(torch.tensor(v, dtype=torch.float32, device=device) for v in stats)


def prep_image(x_u8: torch.Tensor, norm) -> torch.Tensor:
    """uint8 NHWC batch -> normalised NCHW view (channels_last memory)."""
    x = normalize_image(x_u8, *norm) if norm is not None else x_u8.to(torch.float32)
    return x.permute(0, 3, 1, 2)


def cohort_rates(cfg: Dict[str, Any], user_idx: np.ndarray, round_seed: int,
                 rates: Optional[Sequence[float]] = None) -> np.ndarray:
    """The cohort's absolute rates (float32): ``rates`` when given, else each
    user's own in ``fix`` mode and the round's draw (``fed.core.round_rates``
    at ``round_seed``) in ``dynamic`` mode.  A ``-1`` (padding) slot takes
    user ``U - 1``'s rate, as the reference's ``jnp.take`` wraps ``-1``
    (heterofl_tpu/fed/core.py:51)."""
    if rates is not None:
        out = np.asarray(rates, np.float32).reshape(-1)
    elif cfg["model_split_mode"] == "fix":
        out = np.asarray(cfg["model_rate"], np.float32)[user_idx]
    else:
        out = round_rates(round_seed, cfg, user_idx)
    if out.shape != user_idx.shape:
        raise ValueError(f"{out.size} rates for {user_idx.size} users")
    return out


def rank_slots(users: np.ndarray, size: int, placement: str = "replicated",
               users_per_rank: int = 0, bucket: bool = False
               ) -> Tuple[List[List[np.ndarray]], int]:
    """The slot layout of ``[k, A]`` cohorts over ``size`` ranks ->
    ``(positions, per)``: ``positions[r][rank]`` the schedule positions of
    round r that rank trains, ``per`` the slots a rank (the codec's
    ``cmax``, the reference's per-device slot count).  ``replicated``:
    ``ceil(A / size)`` consecutive positions a rank (ref
    round_engine.py:1827-1831, 1450); ``sharded``: the positions of the
    users a rank holds (user ``u`` on rank ``u // users_per_rank``; a
    ``-1`` slot on none), ``per`` the most any rank holds in a round, at
    least 1, rounded up to a power of two over a superstep (``bucket``;
    ref round_engine.py:1583-1600, 1814-1822)."""
    users = np.asarray(users, np.int64)
    k, a = users.shape
    if placement == "sharded":
        owner = np.where(users >= 0, users // max(1, users_per_rank), -1)
        pos = [[np.flatnonzero(owner[r] == d) for d in range(size)] for r in range(k)]
        per = max([1] + [len(p) for row in pos for p in row])
        if bucket:
            per = 1 << (per - 1).bit_length()
        return pos, per
    per = -(-a // size) if a else 0
    blocks = [np.arange(*block_bounds(a, size, d)) for d in range(size)]
    return [blocks for _ in range(k)], per


def shard_client_data(data: Tuple[torch.Tensor, ...], size: int, rank: int
                      ) -> Tuple[torch.Tensor, ...]:
    """Rank ``rank``'s block of the per-user stacks under ``sharded``
    placement (ref round_engine.py:215-240): the user axis padded with
    empty users to a multiple of ``size``, then its ``rank``-th block of
    ``U_pad / size`` users -- each rank holds only its users' shards."""
    u = int(data[0].shape[0])
    pad = (-u) % size
    per = (u + pad) // size
    out = []
    for arr in data:
        if pad:
            arr = torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])
        out.append(arr[rank * per:(rank + 1) * per])
    return tuple(out)


def client_seed(round_seed: int, uid: int) -> int:
    """Seed of one client's generator in one round."""
    return int(np.random.SeedSequence([int(round_seed), 13, int(uid)]).generate_state(1)[0])


def normalize_eval_mask(eval_mask, k: int, fused_eval):
    """The superstep's eval mask as a bool tuple, or None when no round
    evaluates (ref parallel/round_engine.py:136-151)."""
    if eval_mask is None:
        return None
    eval_mask = tuple(bool(m) for m in eval_mask)
    if len(eval_mask) != k:
        raise ValueError(f"eval_mask must have k={k} entries, got {len(eval_mask)}")
    if not any(eval_mask):
        return None
    if fused_eval is None:
        raise ValueError("eval_mask needs a FusedEval (Evaluator.fused) "
                         "carrying the staged eval operands")
    return eval_mask


def superstep_schedules(user_schedule, rate_schedule, lrs, k: int):
    """The superstep's ``[k, A]`` cohorts (int64) and absolute rates
    (float32) and its ``[k]`` learning rates, checked against ``k``."""
    users = np.asarray(user_schedule, np.int64)
    rates = np.asarray(rate_schedule, np.float32)
    lrs = np.asarray(lrs, np.float32).reshape(-1)
    if users.ndim != 2 or users.shape[0] != k or rates.shape != users.shape or lrs.size != k:
        raise ValueError(f"superstep schedules: users {users.shape}, rates {rates.shape}, "
                         f"lrs {lrs.shape}; want [k={k}, A], [k, A], [k]")
    return users, rates, lrs


def assemble_superstep(host, rates, eval_epochs, fused_eval, levels=()):
    """The fetched superstep as the experiment loop reads it: k per-round dicts
    (``loss_sum``, ``score_sum``, ``n`` per client, ``rate``), or
    ``{"train": [...], "eval": [...]}`` when a round evaluated.  With probes
    or the quarantine gate (``host["obs"]``, one dict of ``obs_*`` rows a
    round) each round is finished by ``obs.split_probes`` (a gated slot's
    row and rate read 0) and the records ride under ``"obs"``."""
    rounds = [{"loss_sum": a[:, 0], "score_sum": a[:, 1], "n": a[:, 2], "rate": rates[r]}
              for r, a in enumerate(host["train"])]
    obs = host.get("obs")
    if obs is not None:
        records = []
        for r, o in enumerate(obs):
            rounds[r], rec = split_probes({**rounds[r], **o}, levels)
            records.append(rec)
    if not eval_epochs and obs is None:
        return rounds
    out = {"train": rounds}
    if obs is not None:
        out["obs"] = records
    if eval_epochs:
        out["eval"] = fused_eval.assemble(host["eval"], eval_epochs)
    return out


class FlatParams:
    """What the experiment loop reads of a round engine: the global params
    as one flat buffer (``spec``, on ``device``), the wire codec's residual
    carry (none without a codec), the buffered aggregation's staleness
    carry (none under ``sync``), and the scheduler's per-slot plan."""

    spec: FlatSpec
    device: torch.device
    codec = None
    _resid: Optional[torch.Tensor] = None  # [resid_slots, total] EF carry
    sched: ScheduleSpec = ScheduleSpec()
    failure_rate = 0.0
    _sched_buf: Optional[torch.Tensor] = None  # [2, total] staleness carry
    _obs_on = _obs_hist = False
    _quarantine: QuarantineSpec = QuarantineSpec()
    _poison: Optional[np.ndarray] = None
    _seg_ends: Optional[torch.Tensor] = None
    arms: Optional[ArmsSpec] = None
    _arm_resid: Optional[List[Optional[torch.Tensor]]] = None  # each arm's EF carry
    #: the clients axis the round reduces over (None: no reduction, the
    #: sliced twin, which every rank runs whole)
    mesh: Optional[Mesh] = None
    placement = "replicated"
    n_data = 1
    #: local steps run eagerly (the audit's data-axis budget)
    local_steps = 0

    def _init_data_axis(self) -> None:
        """The data axis of ``self.mesh``: a client's batch (an LM window's
        positions) split over its row's data ranks; an LM's ``bptt`` must
        split evenly (the reference's ``ValueError``)."""
        self.n_data = self.mesh.data_size
        self._slice_idx: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}
        self.local_steps = 0
        if self.is_lm and self.bptt % self.n_data:
            raise ValueError(f"data axis size ({self.n_data}) must divide "
                             f"bptt={self.bptt} for sequence-parallel LM rounds")

    def _data_slice(self, B: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """This data rank's rows of a batch of B (ref round_engine.py:
        695-704): ``(src [b_loc], keep [b_loc])``, ``src`` the batch rows it
        takes (a padded row repeats row ``j - B``) and ``keep`` 1 on real
        rows, 0 on the padding."""
        key = (B, device)
        if key not in self._slice_idx:
            b_loc = -(-B // self.n_data)
            rows = self.mesh.data_rank * b_loc + torch.arange(b_loc)
            self._slice_idx[key] = ((rows % B).to(device),
                                    (rows < B).to(torch.float32).to(device))
        return self._slice_idx[key]

    def _ring(self, q, k, v, temp: float) -> torch.Tensor:
        """Ring attention over this row's data group (the LM's split)."""
        return ring_attention(q, k, v, self.mesh, temp)

    def _init_sched(self, cfg: Dict[str, Any]) -> None:
        """The scheduler of ``cfg`` (``schedule``, ``client_failure_rate``)."""
        self.sched = resolve_schedule_cfg(cfg)
        self.failure_rate = float(cfg.get("client_failure_rate", 0.0) or 0.0)
        self._sched_buf = None

    # -- observability: probes, the quarantine gate, the poison ----------------

    def _init_obs(self, cfg: Dict[str, Any]) -> None:
        """The probes (``telemetry``), the quarantine gate and the chaos
        poison of ``cfg`` (ref round_engine.py:455-477); all off leaves every
        round as it was: no tensor, no launch, no fetched byte more."""
        tele = resolve_telemetry_cfg(cfg)
        self._obs_on, self._obs_hist = tele.probes, tele.hist
        self.obs_levels = obs_levels(cfg)
        self._quarantine = resolve_quarantine_cfg(cfg)
        self._poison = resolve_poison_cfg(cfg)

    @property
    def observing(self) -> bool:
        """Whether a round's metrics carry ``obs_*`` rows (probes or gate)."""
        return self._obs_on or self._quarantine.enabled

    def _guard(self, trained: torch.Tensor, ref: torch.Tensor, cm: torch.Tensor,
               hits: Optional[np.ndarray]):
        """A client's (or a level's rows') update on its way to the sum (ref
        round_engine.py:926-960): the chaos poison on the matched rows
        (``hits``), then the quarantine gate -- its count mask times the gate
        and its trained values selected to zero where gated, so ``NaN * 0``
        cannot reach the sum -> ``(trained, cm, gate or None)``.  A round
        where the gate trips nothing is the ungated round bit for bit."""
        if hits is not None:
            trained = poison_updates(trained, hits)
        if not self._quarantine.enabled:
            return trained, cm, None
        ok = quarantine_gate(trained, ref, cm, self._quarantine.max_norm)
        okc = ok if trained.dim() == 1 else ok[:, None]
        return torch.where(okc, trained, 0.0), cm * okc.to(cm.dtype), ok

    def _round_obs(self, P: torch.Tensor, new_P: torch.Tensor, summed: torch.Tensor,
                   counts: torch.Tensor, gate: Optional[torch.Tensor] = None,
                   limits: Optional[np.ndarray] = None, total: int = 1
                   ) -> Optional[Dict[str, Any]]:
        """The round's ``obs_*`` rows (ref round_engine.py:1008-1030): the
        gate row (float32 ``[A]``, 1 where the update passed), the device
        probes after the aggregation (``obs.probes.round_probes`` on the
        post-codec sums and the new carries) and, under ``'hist'``, the
        staleness carry's histogram and (with a deadline) each slot's step
        fraction from the planned budgets ``limits`` (host).  None when
        neither probes nor gate are on."""
        obs: Dict[str, Any] = {}
        if gate is not None:
            obs["obs_gate"] = gate
        if self._obs_on:
            if self._seg_ends is None:
                self._seg_ends = segment_ends(self.spec, P.device)
            buf = self._sched_buf if self.sched.buffered else None
            obs.update(round_probes(self._seg_ends, P, new_P, summed, counts,
                                    self._resid if self.lossy else None, buf))
            if self._obs_hist:
                obs["obs_hist_stale"] = stale_hist(buf, P.device)
                if self.sched.has_deadline and limits is not None:
                    obs["obs_steps"] = np.asarray(limits, np.float32) / np.float32(total)
        return obs or None

    @staticmethod
    def _gate_row(oks, pos, n_slots: int, device: torch.device) -> Optional[torch.Tensor]:
        """The gate row ``[n_slots]`` (float32): the gates ``oks`` (device
        bools, scalars or rows) at the slots ``pos``, 1 elsewhere."""
        if oks is None:
            return None
        gate = torch.ones(n_slots, dtype=torch.float32, device=device)
        if pos:
            gate[torch.as_tensor(pos, dtype=torch.int64).to(device)] = \
                torch.cat([o.reshape(-1) for o in oks]).to(torch.float32)
        return gate

    def flatten(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.spec.flatten({k: v.detach() for k, v in params.items()}).to(self.device)

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.spec.unflatten(flat)

    # -- the wire codec's error-feedback carry ----------------------------

    @property
    def lossy(self) -> bool:
        """Whether a round sends its sums through a lossy codec (and so
        carries a residual)."""
        return self.codec is not None

    def resid_shape(self) -> Tuple[int, int]:
        """The residual carry's shape, ``[resid_slots, total]``."""
        return (self.codec.resid_slots, self.spec.total)

    def resid_segments(self) -> Sequence[Tuple[int, FlatSpec]]:
        """The residual's columns as ``(offset, flat layout)`` segments:
        one over the whole model here; a per-level codec map has one a
        lossy level (parallel/grouped.py)."""
        return [(0, self.spec)]

    def _ensure_resid(self, device: torch.device) -> torch.Tensor:
        """The residual carry, zeros on first use."""
        if self._resid is None:
            self._resid = torch.zeros(self.resid_shape(), dtype=torch.float32, device=device)
        return self._resid

    def wire_resid_host(self) -> Optional[np.ndarray]:
        """Host copy of the residual carry (:meth:`resid_shape`; for a
        checkpoint); None under ``dense`` or before the first compressed
        round.  Under arms each arm's, stacked ``[E, *resid_shape]``."""
        if self.arms is not None:
            if any(r is None for r in self._arm_resid):
                return None
            # staticcheck: allow(no-device-get) the checkpoint's copy, at a boundary
            return torch.stack(self._arm_resid).cpu().numpy()
        # staticcheck: allow(no-device-get) the checkpoint's copy, at a boundary
        return None if self._resid is None else self._resid.cpu().numpy()

    def set_wire_resid(self, arr) -> None:
        """Restore the residual carry (from a checkpoint) onto the device
        (under arms ``[E, *resid_shape]``, a carry an arm)."""
        host = torch.as_tensor(np.asarray(arr, np.float32))
        want = tuple(self.resid_shape())
        if self.arms is not None:
            want = (self.arms.count,) + want
        if tuple(host.shape) != want:
            raise ValueError(f"wire residual of shape {tuple(host.shape)}, want {want}")
        if self.arms is not None:
            self._arm_resid = list(host.to(self.device).unbind(0))
            return
        self._resid = host.to(self.device)

    # -- the buffered aggregation's staleness carry (ref sched/buffer.py) --

    def sched_buf_host(self) -> Optional[np.ndarray]:
        """Host copy of the staleness buffer ``[2, total]`` (for a
        checkpoint); None under ``sync`` or before the first buffered
        round."""
        # staticcheck: allow(no-device-get) the checkpoint's copy, at a boundary
        return None if self._sched_buf is None else self._sched_buf.cpu().numpy()

    def set_sched_buf(self, arr) -> None:
        """Restore the staleness buffer (from a checkpoint) onto the device."""
        host = torch.as_tensor(np.asarray(arr, np.float32))
        if tuple(host.shape) != (2, self.spec.total):
            raise ValueError(f"staleness buffer of shape {tuple(host.shape)}, want "
                             f"{(2, self.spec.total)}")
        self._sched_buf = host.to(self.device)

    def reset_carries(self) -> None:
        """Drop the residual and staleness carries; the next round starts
        from zeros unless they are restored first."""
        self._resid = None
        self._sched_buf = None
        if self.arms is not None:
            self._arm_resid = [None] * self.arms.count

    # -- experiment arms (multi/) -----------------------------------------

    def _init_arms(self, cfg: Dict[str, Any]) -> None:
        """The arms of ``cfg`` (``multi.resolve_arms_cfg``, whose refusals
        -- a streamed store, buffered aggregation, under ``grouped`` a lossy
        codec, probes or the gate -- apply to an engine made directly too);
        each arm's residual carry starts empty."""
        self.arms = resolve_arms_cfg(cfg)
        self._arm_resid = None if self.arms is None else [None] * self.arms.count

    def _refuse_arms_k1(self) -> None:
        """The K=1 round under arms: refused, with the reference's message
        (round_engine.py:1794-1798)."""
        if self.arms is not None:
            raise ValueError(
                "arms need the fused superstep (train_superstep): the K=1 "
                "train_round path is the host-loop reference twin, which "
                "the arms axis would fork per arm -- set superstep_rounds "
                ">= 1 through the superstep API")

    def arm_lrs(self, lrs, k: int) -> np.ndarray:
        """The arms' learning rates, float32 ``[E, k]``: ``lrs`` itself when
        it is ``[E, k]`` (each arm's own, as under ReduceLROnPlateau), else
        the shared ``[k]`` schedule times each arm's ``lr_scale`` (float32
        products, so a scale of 1 leaves the schedule's bits)."""
        lrs = np.asarray(lrs, np.float32)
        E = self.arms.count
        if lrs.ndim == 2:
            if lrs.shape != (E, k):
                raise ValueError(f"arms learning rates of shape {lrs.shape}; want [E={E}, k={k}] "
                                 f"or the shared [k]")
            return lrs
        return np.stack([lrs.reshape(-1) * np.float32(s) for s in self.arms.lr_scales])

    def _arms_superstep(self, Ps: torch.Tensor, seed: int, k: int, user_schedule,
                        rate_schedule, lrs, run_arm) -> Tuple[torch.Tensor, PendingMetrics]:
        """The arms' superstep: the arms one after another, arm e from its
        row ``Ps[e]`` of the stacked ``[E, n]`` params, on its stream root
        (``fed.core.arm_stream_seed`` of ``seed``), with its cohorts and
        rates (``user_schedule`` / ``rate_schedule`` ``[E, k, A]``, or one
        ``[k, A]`` the arms share), its learning rates (:meth:`arm_lrs`) and
        its residual carry; ``run_arm(e, P, arm seed, users, rates, lrs)``
        runs one arm's rounds -> :meth:`_superstep_parts`.  Returns the new
        params ``[E, n]`` and ONE :class:`~.staging.PendingMetrics` holding
        every arm's sums: its fetch is one copy, yielding ``{"arms": [arm
        e's superstep result]}``; its timers hold the arms' rounds and
        evaluations, arm after arm."""
        E = self.arms.count
        if Ps.dim() != 2 or Ps.shape[0] != E:
            raise ValueError(f"arms params of shape {tuple(Ps.shape)}; want [E={E}, n]")
        seeds = arm_stream_seeds(seed, self.arms.seeds)
        lrs = self.arm_lrs(lrs, k)

        def per_arm(sched, e):
            sched = np.asarray(sched)
            return sched[e] if sched.ndim == 3 else sched

        news, trees, assembles, timers = [], [], [], {"train": [], "eval": []}
        for e in range(E):
            self._resid = self._arm_resid[e]
            try:
                P, tree, assemble, tm = run_arm(e, Ps[e], seeds[e], per_arm(user_schedule, e),
                                                per_arm(rate_schedule, e), lrs[e])
            finally:
                self._arm_resid[e], self._resid = self._resid, None
            news.append(P)
            trees.append(tree)
            assembles.append(assemble)
            for key in timers:
                timers[key] += tm[key]
        return torch.stack(news), PendingMetrics(
            {"arms": trees},
            lambda host: {"arms": [a(h) for a, h in zip(assembles, host["arms"])]}, timers)

    # -- the scheduler's slots --------------------------------------------

    def total_steps(self, data) -> int:
        """A client's local steps, from the stacked, padded shard: ``E *
        ceil(N / B)`` (an LM ``E * ceil(T / bptt)``) -- the deadline's
        ``total`` (ref round_engine.py:881-912)."""
        if self.is_lm:
            return self.local_epochs * math.ceil(data[0].shape[2] / self.bptt)
        return self.local_epochs * math.ceil(data[0].shape[1] / self.batch_size)

    def slot_plan(self, user_idx: np.ndarray, rseed: int, total_steps: int,
                  step_limits=None, alive=None) -> Tuple[np.ndarray, np.ndarray]:
        """``(valid [A] bool, budgets [A] int64)`` of a round's slots: a slot
        trains when it holds a user (not ``-1``) who did not fail
        (``fed.core.client_alive``); its budget is ``total_steps``, or under
        a deadline its drawn step count (``sched.deadline.deadline_steps``),
        and 0 when it does not train.  Test hooks, in slot order, replace
        the draws: ``alive`` the survivors, ``step_limits`` the budgets."""
        valid = user_idx >= 0
        if alive is not None:
            valid = valid & np.asarray(alive, bool).reshape(-1)
        elif self.failure_rate > 0.0:
            valid = valid & client_alive(rseed, user_idx, self.failure_rate)
        if step_limits is not None:
            limits = np.asarray(step_limits, np.int64).reshape(-1)
        elif self.sched.has_deadline:
            limits = deadline_steps(rseed, user_idx, total_steps, self.sched.deadline_min_frac)
        else:
            limits = np.full(user_idx.shape, total_steps, np.int64)
        return valid, np.where(valid, np.minimum(limits, total_steps), 0)

    def _superstep(self, *args, **kw) -> Tuple[torch.Tensor, PendingMetrics]:
        """:meth:`_superstep_parts` as ``(new P, its PendingMetrics)``."""
        P, tree, assemble, timers = self._superstep_parts(*args, **kw)
        return P, PendingMetrics(tree, assemble, timers)

    def _superstep_parts(self, P: torch.Tensor, seed: int, epoch0: int, k: int, user_schedule,
                         rate_schedule, lrs, eval_mask, fused_eval, lr: torch.Tensor, round_fn,
                         finish=None):
        """The superstep's round loop, shared by the engines: round r writes
        ``lrs[r]`` into the steps' static scalar ``lr``, runs
        ``round_fn(P, r, users, rates, round seed) -> (P, [A, 3] sums,
        reported rates, obs rows or None)``, and evaluates where
        ``eval_mask[r]`` fires; device marks around each round and
        evaluation time them.  The rounds' ``obs_*`` rows ride the one fetch
        (under ``"obs"``, only when probes or the gate are on);
        ``finish(train)``, when given, turns the rounds' sums into what is
        fetched (the mesh's gather of the ranks' rows) -> ``(new P, device
        tree, assemble, timers)``, the parts of a
        :class:`~.staging.PendingMetrics`."""
        eval_mask = normalize_eval_mask(eval_mask, k, fused_eval)
        users, rates, lrs = superstep_schedules(user_schedule, rate_schedule, lrs, k)
        lrs_dev = torch.from_numpy(lrs).to(P.device)
        train, evals, timers, reported, obs = [], [], {"train": [], "eval": []}, [], []
        for r in range(k):
            t0 = maybe_event(P.device)
            lr.copy_(lrs_dev[r])
            P, acc, rate_r, obs_r = round_fn(P, r, users[r], rates[r],
                                             round_seed(seed, epoch0 + r))
            train.append(acc)
            reported.append(rate_r)
            obs.append(obs_r)
            t1 = maybe_event(P.device)
            timers["train"].append((t0, t1))
            if eval_mask is not None and eval_mask[r]:
                evals.append(fused_eval.run(P, epoch0 + r))
                timers["eval"].append((t1, maybe_event(P.device)))
        eval_epochs = [epoch0 + r for r in range(k) if eval_mask and eval_mask[r]]
        if finish is not None:
            train = finish(train)
        tree, levels = {"train": train, "eval": evals}, self.obs_levels
        if self.observing:
            tree["obs"] = obs
        return P, tree, lambda host: assemble_superstep(host, reported, eval_epochs, fused_eval,
                                                        levels), timers

    # -- the streamed cohort ------------------------------------------------

    _stager: Optional[CohortStager] = None

    def cohort_stager(self) -> CohortStager:
        """The engine's cohort ring (``stream_prefetch_depth + 1`` slots a
        layout), made at the first cohort."""
        if self._stager is None:
            self._stager = CohortStager(self.device, resolve_prefetch_depth(self.cfg))
        return self._stager

    def _cohort_args(self, engine: str, k: int, data, user_schedule, rate_schedule,
                     cohort: Optional[StagedCohort]):
        """A superstep's ``(data, users, rates, rows)``: the eager stacks and
        the schedules with each slot's data row its user id, or a cohort's
        stacks, schedules and rows (its copy waited for)."""
        if cohort is None:
            if data is None:
                raise ValueError("train_superstep needs data stacks or a staged cohort")
            return data, user_schedule, rate_schedule, None
        if data is not None:
            raise ValueError("train_superstep takes data stacks or a staged cohort, not both")
        users = cohort.users if user_schedule is None else np.asarray(user_schedule, np.int64)
        if not np.array_equal(users, cohort.users):
            raise ValueError("train_superstep: the user schedule is not the staged cohort's")
        if rate_schedule is None:
            rate_schedule = cohort.rates
        return cohort.open(engine, k), users, rate_schedule, cohort.rows

    def _aggregate(self, P, summed, counts, round_seed: int, n_slots: int,
                   codec_noise=None, topk_offset=None, cmax: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The round's new global params: the counted sums reduced over the
        mesh -- through the wire codec (encode, all-reduce the payload,
        decode, this rank's residual carried; its grid sized for ``cmax``
        clients, default the round's ``n_slots``, padding and failed slots
        included, as the reference's ``user_glob.shape[0]``, a rank's slots
        at several ranks) whenever the round has slots, else in one
        all-reduce of ``(summed, counts)`` -- then the counted average with the
        stale fallback -- or under buffered aggregation
        (``sched.buffer.buffered_combine``) the buffered update of the
        previous round, this round's sums buffered.  Returns ``(new P,
        summed, counts)``, the sums as the combine read them (dequantised
        under a codec), which the probes read."""
        if self.codec is not None and n_slots:
            draw = {"int8": codec_noise, "topk": topk_offset}.get(self.codec.name)
            if draw is None:
                draw = self.codec.draw(round_seed, P.device,
                                       0 if self.mesh is None else self.mesh.rank)
            summed, counts, self._resid = compressed_sum(
                self.codec, P, summed, counts, self._ensure_resid(P.device), draw,
                n_slots if cmax is None else cmax, self.mesh)
        elif self.mesh is not None:
            # the round's one collective: the update sums and counts, one buffer
            summed, counts = self.mesh.all_reduce_sum([summed, counts])
        if self.sched.buffered:
            if self._sched_buf is None:
                self._sched_buf = torch.zeros((2, self.spec.total), dtype=torch.float32,
                                              device=P.device)
            new_P, self._sched_buf = buffered_combine(P, self._sched_buf, summed, counts,
                                                      self.sched.staleness)
            return new_P, summed, counts
        return combine_counted(P, summed, counts), summed, counts


class RoundEngine(FlatParams):
    """Local training and counted aggregation of one round, for one
    (model, cfg, device)."""

    def __init__(self, model: FedModel, cfg: Dict[str, Any], device: torch.device,
                 mesh: Optional[Mesh] = None):
        self.model, self.cfg, self.device = model, cfg, device
        # the clients axis (parallel/mesh.py): one rank without a group
        self.mesh = single_mesh(device) if mesh is None else mesh
        self.placement = cfg.get("data_placement", "replicated") or "replicated"
        self.global_rate = cfg["global_model_rate"]
        ne = cfg["num_epochs"]
        self.local_epochs = ne["local"] if isinstance(ne, dict) else 1
        self.batch_size = cfg["batch_size"]["train"]
        self.is_lm = model.meta["kind"] == "transformer"
        if self.is_lm:
            self.bptt = cfg["bptt"]
        # the data axis: a client's batch (an LM window's positions) split
        # over this row's data ranks
        self._init_data_axis()
        if not self.is_lm:
            self.norm = norm_stats_tensors(cfg, device)
            self.augment = cfg["data_name"].startswith("CIFAR")
        # fix mode: every user's rate; dynamic: the rates are drawn per round
        self.fix_rates = np.asarray(cfg["model_rate"], np.float32) \
            if cfg["model_split_mode"] == "fix" else None
        self.fused_mode = resolve_fused_mode(cfg, device)
        self.momentum = float(cfg.get("momentum", 0.0))
        self.weight_decay = float(cfg.get("weight_decay", 0.0))
        self.spec = FlatSpec.of(dict(model.named_parameters()))
        # wire codec: a participant a rank of the mesh; 'dense' builds no
        # codec and no residual, and leaves the round as it was
        name, ef = resolve_codec_cfg(cfg)
        self.codec = make_codec(name, self.spec, self.mesh.size, error_feedback=ef)
        self._resid = None
        self._init_sched(cfg)
        self._init_obs(cfg)
        self._init_arms(cfg)
        self._label_axes = [(k, s.label_axis) for k, s in model.specs.items()
                            if s.label_axis is not None]
        # flat width masks (and the group norms' channel masks) per width
        # rate a round can draw -- every user's in fix mode, every mode
        # rate in dynamic mode -- built once on the host and moved to the
        # device before any round starts (a copy mid-round would wait for
        # the device)
        self._masks: Dict[float, torch.Tensor] = {}
        # staticcheck: allow(no-device-get) a numpy array
        for wr in sorted(set(to_width_rates(cfg["model_rate"], cfg).tolist())):
            self.param_mask_flat(wr)
            model.prepare_width(wr, device)
        # the superstep's captured steps (one a width rate), their static
        # buffers (made at the first superstep) and their generator
        self.graphs = StepGraphs(device, capture=self.n_data == 1)
        self._st: Optional[Dict[str, torch.Tensor]] = None
        # staticcheck: allow(no-fresh-rng) seeded per client in stage_client
        self._ggen = torch.Generator(device=device)
        self._stager = None

    # -- flat buffers ----------------------------------------------------

    def param_mask_flat(self, wr: float) -> torch.Tensor:
        """Flat width mask of a client at width rate ``wr`` (the distribute
        mask and the gradient mask)."""
        if wr not in self._masks:
            m = {k: param_mask(s, self.model.specs[k], self.model.groups, wr)
                 for k, s in self.spec.shapes.items()}
            self._masks[wr] = self.spec.flatten(m).to(self.device)
        return self._masks[wr]

    def count_mask_flat(self, wr: float, label_mask: torch.Tensor) -> torch.Tensor:
        """Flat aggregation mask: the width mask with label-axis rows
        restricted to the client's labels (device ops only)."""
        cm = self.param_mask_flat(wr).clone()
        for k, axis in self._label_axes:
            leaf = self.spec.leaf(cm, k)
            view = [1] * leaf.ndim
            view[axis] = leaf.shape[axis]
            leaf.mul_(label_vector(label_mask, leaf.shape[axis]).reshape(view))
        return cm

    # -- the clients mesh axis ----------------------------------------------

    def _layout(self, users: np.ndarray, data, bucket: bool = False
                ) -> Tuple[List[List[np.ndarray]], int]:
        """:func:`rank_slots` of ``[k, A]`` cohorts over this engine's mesh
        (a sharded rank's users the rows of its ``data`` block)."""
        return rank_slots(users, self.mesh.size, self.placement,
                          int(data[0].shape[0]) if self.placement == "sharded" else 0, bucket)

    def _data_row(self, uid: int, data) -> int:
        """The row of ``data`` holding user ``uid``'s shard: the user id, or
        under ``sharded`` its place in this rank's block."""
        if self.placement != "sharded":
            return uid
        return uid - self.mesh.rank * int(data[0].shape[0])

    def _check_sharded(self, data) -> None:
        """Under ``sharded``, ``data`` must be this rank's block of the
        padded user axis (ref round_engine.py:1808-1813)."""
        if self.placement != "sharded":
            return
        n, users = self.mesh.size, int(self.cfg["num_users"])
        u_pad = int(data[0].shape[0]) * n
        if u_pad != -(-users // n) * n:
            raise ValueError(
                f"sharded placement needs the user axis ({u_pad}) padded to a multiple of "
                f"the clients axis ({n}); use shard_client_data")

    @staticmethod
    def _to_schedule(gathered: torch.Tensor, positions: Sequence[np.ndarray], per: int,
                     a: int) -> torch.Tensor:
        """Rows gathered in rank order (``per`` a rank) back at their ``a``
        schedule positions, zeros where no rank trained the slot; the rows
        themselves where they are in schedule order already (one rank)."""
        src = np.full(a, -1, np.int64)
        for r, p in enumerate(positions):
            src[p] = r * per + np.arange(len(p))
        if gathered.shape[0] == a and np.array_equal(src, np.arange(a)):
            return gathered
        out = gathered.new_zeros((a,) + tuple(gathered.shape[1:]))
        keep = np.flatnonzero(src >= 0)
        if keep.size:
            dev = gathered.device
            out[torch.from_numpy(keep).to(dev)] = gathered[torch.from_numpy(src[keep]).to(dev)]
        return out

    def _collect_rows(self, local: Sequence[torch.Tensor], positions: Sequence[np.ndarray],
                      per: int, a: int) -> torch.Tensor:
        """The round's ``[A, 3]`` per-slot rows from each rank's ``local``
        rows (its slots' in order, zero-padded to ``per``): one
        ``Mesh.gather_rows``, then :meth:`_to_schedule`.  On one rank the
        rows are ``local`` stacked, as before."""
        rows = torch.stack(list(local)) if local else torch.zeros((0, 3), device=self.device)
        if len(local) < per:
            rows = torch.cat([rows, rows.new_zeros((per - len(local), 3))])
        return self._to_schedule(self.mesh.gather_rows(rows), positions, per, a)

    def _collect_superstep(self, train: List[torch.Tensor], layout, a: int
                           ) -> List[torch.Tensor]:
        """The superstep's k rounds of local ``[per, 3]`` rows -> k ``[A,
        3]`` rows in schedule order, through ONE ``Mesh.gather_rows`` of the
        stacked ``[k, per, 3]``."""
        positions, per = layout
        k, mesh = len(train), self.mesh
        g = mesh.gather_rows(torch.stack(train)).view(mesh.size, k, per, 3)
        return [self._to_schedule(g[:, r].reshape(mesh.size * per, 3), positions[r], per, a)
                for r in range(k)]

    # -- one client --------------------------------------------------------

    def _prep(self, x_u8: torch.Tensor, gen: torch.Generator, draw=None) -> torch.Tensor:
        """uint8 NHWC batch -> normalised NCHW view (channels_last memory);
        ``draw``, when given, the augmentation's ``(offsets, flips)``."""
        if self.augment:
            x_u8 = augment_cifar(x_u8, gen, *(draw or (None, None)))
        return prep_image(x_u8, self.norm)

    def local_train(self, P: torch.Tensor, wr: float, x, y, sm, lm, gen: torch.Generator,
                    lr: torch.Tensor, raw_perms: Optional[np.ndarray] = None,
                    aug: Optional[Callable[[int], Tuple[Any, Any]]] = None,
                    scaler_rate: Optional[float] = None, step_limit: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local SGD of one client from the global flat params ``P`` ->
        ``(trained flat params, [loss_sum, correct_sum, n] device sums)``.
        ``scaler_rate`` (default ``wr``): the Scaler's rate, which a dense
        level sub-model trained at ``wr = 1`` takes from its level (the
        sliced twin).  ``step_limit``: a deadline's budget -- the client
        stops after that many of its ``E * S`` steps, which is what the
        reference's gated steps past the budget amount to (no update, no
        metric).

        Test hooks: ``raw_perms`` (``[E, N]``) replaces the generator's epoch
        permutations (the real-first sort still runs on them); ``aug(t)``
        gives local step ``t``'s augmentation ``(offsets [B, 2], flips
        [B])`` instead of the generator."""
        B, dev = self.batch_size, P.device
        S = math.ceil(x.shape[0] / B)
        mask = self.param_mask_flat(wr)
        st = {"p": P * mask, "buf": torch.zeros_like(P), "g": torch.empty_like(P),
              "acc": torch.zeros(3, dtype=torch.float32, device=dev), "lr": lr, "lm": lm}
        perms = self._epoch_perms(gen, sm, raw_perms)
        wpad = self._pad_weights(x.shape[0], dev)
        steps = self.local_epochs * S
        for t in range(steps if step_limit is None else min(steps, step_limit)):
            e, s = divmod(t, S)
            ids = perms[e, s * B:(s + 1) * B]
            draw = None if aug is None else tuple(torch.as_tensor(np.array(a)).to(dev)
                                                  for a in aug(t))
            self._vision_step(st, wr, wr if scaler_rate is None else scaler_rate, mask, gen,
                              x[ids], y[ids], wpad[s * B:(s + 1) * B] * sm[ids], draw)
        return st["p"], st["acc"]

    def local_train_lm(self, P: torch.Tensor, wr: float, rows: torch.Tensor, lm: torch.Tensor,
                       gen: torch.Generator, lr: torch.Tensor,
                       draws: Optional[Callable[[int], Dict[str, Any]]] = None,
                       scaler_rate: Optional[float] = None, step_limit: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local SGD of one masked-LM client on its token rows ``[R, T]``
        from the global flat params ``P`` -> ``(trained flat params,
        [loss_sum, score_sum, n] device sums)``.

        Step ``t`` trains on window ``t % S`` of the ``S = ceil(T / bptt)``
        windows, the loss the weighted SUM over its positions; each step
        adds ``R`` rows to ``n``, ``window CE * R`` to the loss and
        ``exp(window CE) * R`` to the score (Perplexity's sum; ref
        round_engine.py:740-815).  ``draws(t)`` (test hook) gives step
        ``t``'s corruption and dropout draws instead of ``gen``;
        ``scaler_rate`` and ``step_limit`` as in :meth:`local_train`."""
        bptt, dev = self.bptt, P.device
        R, T = rows.shape
        wpos, n_win = self._window_weights(R, T, dev)
        S = n_win.numel()
        rows_p = torch.nn.functional.pad(rows, (0, S * bptt - T))
        mask = self.param_mask_flat(wr)
        st = {"p": P * mask, "buf": torch.zeros_like(P), "g": torch.empty_like(P),
              "acc": torch.zeros(3, dtype=torch.float32, device=dev), "lr": lr, "lm": lm,
              "rows_n": torch.full((), float(R), dtype=torch.float32, device=dev)}
        steps = self.local_epochs * S
        for t in range(steps if step_limit is None else min(steps, step_limit)):
            s = t % S
            self._lm_step(st, wr, wr if scaler_rate is None else scaler_rate, mask, gen,
                          rows_p[:, s * bptt:(s + 1) * bptt], wpos[:, s * bptt:(s + 1) * bptt],
                          n_win[s], None if draws is None else draws(t))
        return st["p"], st["acc"]

    # -- one step: shared by the eager loops above and the captured steps ----

    def _epoch_perms(self, gen: torch.Generator, sm: torch.Tensor,
                     raw_perms: Optional[np.ndarray] = None) -> torch.Tensor:
        """A client's ``[E, S * B]`` epoch orders: a permutation of its N
        samples an epoch (from ``gen``, or ``raw_perms``), real samples
        first (a stable sort), tiled to its steps' ``S * B`` slots."""
        N, E, dev = sm.shape[0], self.local_epochs, sm.device
        SB = math.ceil(N / self.batch_size) * self.batch_size
        if raw_perms is None:
            perms = torch.stack([torch.randperm(N, generator=gen, device=dev) for _ in range(E)])
        else:
            perms = torch.as_tensor(np.asarray(raw_perms), dtype=torch.int64).to(dev)
        order = torch.sort(-sm[perms], dim=1, stable=True).indices
        perms = torch.gather(perms, 1, order)
        if SB > N:
            perms = perms.repeat(1, math.ceil(SB / N))[:, :SB]
        return perms

    def _pad_weights(self, N: int, device: torch.device) -> torch.Tensor:
        """``[S * B]`` slot weights: 1 on a client's N samples, 0 on the
        padded tail of its last batch."""
        wpad = torch.ones(math.ceil(N / self.batch_size) * self.batch_size,
                          dtype=torch.float32, device=device)
        wpad[N:] = 0.0
        return wpad

    def _window_weights(self, R: int, T: int, device: torch.device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """An LM client's ``[R, S * bptt]`` position weights (0 on the
        padded tail of the last window) and each window's weight sum."""
        S = math.ceil(T / self.bptt)
        wpos = torch.ones((R, S * self.bptt), dtype=torch.float32, device=device)
        wpos[:, T:] = 0.0
        return wpos, wpos.view(R, S, self.bptt).sum((0, 2))

    def _vision_step(self, st, wr: float, scaler_rate: float, mask: torch.Tensor,
                     gen: torch.Generator, xb, labels, w, draw=None) -> None:
        """One local step on the batch ``(xb, labels, w)``, in place on the
        client's ``st`` (``p``, ``buf``, ``g``, ``acc``; ``lr``, ``lm``);
        ``draw``, when given, the augmentation's ``(offsets, flips)``.  At
        data > 1 this rank's slice of the batch (:meth:`_data_slice`; the
        augmentation drawn for the whole batch, then sliced), BN
        synchronised over the data group, and the gradient with ``[loss_sum,
        correct]`` reduced over it in one all-reduce."""
        spec = self.spec
        n_glob = w.sum()  # the whole batch's weight, before any split
        group = None
        if self.n_data > 1:
            group = self.mesh
            if self.augment and draw is None:
                draw = augment_draws(xb.shape[0], gen, xb.device)
            src, keep = self._data_slice(w.shape[0], w.device)
            xb, labels, w = xb[src], labels[src], w[src] * keep
            draw = None if draw is None else tuple(a[src] for a in draw)
        img = self._prep(xb, gen, draw)
        leaves = {k: v.requires_grad_() for k, v in spec.unflatten(st["p"]).items()}
        score, loss = self.model(img, labels, params=leaves, width_rate=wr,
                                 scaler_rate=scaler_rate, label_mask=st["lm"], sample_weight=w,
                                 bn_group=group)
        # weighted-SUM form, as the reference
        lsum = loss * (n_glob if group is None else w.sum())
        grads = torch.autograd.grad(lsum, [leaves[k] for k in spec.names])
        del leaves
        correct = ((score.detach().argmax(-1) == labels).to(torch.float32) * w).sum()
        sums = None if group is None else torch.stack([lsum.detach(), correct])
        sums = self._step(st["p"], st["buf"], st["g"], grads, mask, n_glob, st["lr"], sums)
        del grads
        if sums is not None:
            lsum, correct = sums[0], sums[1]
        st["acc"] += torch.stack([lsum.detach(), correct, n_glob])

    def _lm_step(self, st, wr: float, scaler_rate: float, mask: torch.Tensor,
                 gen: torch.Generator, lab, w, n_glob, draws=None) -> None:
        """One masked-LM local step on the window ``(lab, w)`` of weight sum
        ``n_glob``, in place on the client's ``st`` (as :meth:`_vision_step`'s,
        and ``rows_n``); ``draws`` replaces the generator's.  At data > 1
        this rank's positions of the window, ring attention over the data
        group, and the gradient with ``[loss_sum, n_loc]`` reduced over it
        in one all-reduce, whose sum is ``n_glob``."""
        spec = self.spec
        extra = {}
        if self.n_data > 1:
            s_loc = lab.shape[1] // self.n_data
            off = self.mesh.data_rank * s_loc
            lab, w = lab[:, off:off + s_loc], w[:, off:off + s_loc]
            extra = {"pos_offset": off, "seq_full": s_loc * self.n_data, "attn": self._ring}
        leaves = {k: v.requires_grad_() for k, v in spec.unflatten(st["p"]).items()}
        _, loss = self.model(lab, params=leaves, width_rate=wr, scaler_rate=scaler_rate,
                             label_mask=st["lm"], sample_weight=w, train=True, gen=gen,
                             draws=draws, **extra)
        n_loc = n_glob if not extra else w.sum()
        lsum = loss * n_loc  # weighted-SUM form, as the reference
        grads = torch.autograd.grad(lsum, [leaves[k] for k in spec.names])
        del leaves
        if extra:
            lsum, n_glob = self._step(st["p"], st["buf"], st["g"], grads, mask, None, st["lr"],
                                      torch.stack([lsum.detach(), n_loc]))
        else:
            self._step(st["p"], st["buf"], st["g"], grads, mask, n_glob, st["lr"])
        del grads
        wl = lsum.detach() / n_glob.clamp_min(1e-6)
        rows_n = st["rows_n"]
        st["acc"] += torch.stack([wl * rows_n, torch.exp(wl) * rows_n, rows_n])

    def _step(self, p, buf, g, grads, mask, n_glob, lr, sums=None) -> Optional[torch.Tensor]:
        """The optimizer tail of one local step, in place on ``p`` and
        ``buf``: the fused epilogue over the flat buffers (its gradient
        packed into ``g``), or the per-leaf chain.  With ``sums`` (the data
        axis) the packed gradient and ``sums`` go out in ONE all-reduce over
        the data group first (the reference chain unpacks the reduced
        gradient into its leaves); ``n_glob`` None takes the reduced
        ``sums[1]``.  Returns the reduced ``sums``."""
        self.local_steps += 1  # eager calls only: a replayed step does not count
        if sums is not None:
            torch.cat([gr.reshape(-1) for gr in grads], out=g)
            red, sums = self.mesh.all_reduce_sum([g, sums], axis="data")
            g.copy_(red)
            if n_glob is None:
                n_glob = sums[1]
            grads = [self.spec.leaf(g, k) for k in self.spec.names]
        if self.fused_mode is None:
            self._reference_step(p, buf, grads, mask, n_glob, lr)
        else:
            if sums is None:
                torch.cat([gr.reshape(-1) for gr in grads], out=g)
            fused_sgd_flat(g, p, buf, mask, make_scal(n_glob, lr), momentum=self.momentum,
                           weight_decay=self.weight_decay, max_norm=1.0)
        return sums

    def _reference_step(self, p, buf, grads, mask, n_glob, lr, has=None) -> None:
        """``fused_update=False``: the unfused per-leaf optimizer chain
        (ref round_engine.py:622-634) -- mean-normalise, width mask,
        global-norm clip, SGD, ``has`` gate (default ``n_glob > 0``) -- in
        place on leaf views of the flat ``p`` and ``buf``."""
        spec = self.spec
        pt, bt, mt = spec.unflatten(p), spec.unflatten(buf), spec.unflatten(mask)
        denom = n_glob.clamp_min(1e-6)
        gm = {k: (gr / denom) * mt[k] for k, gr in zip(spec.names, grads)}
        gm, _ = clip_by_global_norm(gm, 1.0)
        new_p, new_b = sgd_update(pt, gm, bt, lr, self.momentum, self.weight_decay)
        if has is None:
            has = n_glob > 0  # all-padding batch: skip the step entirely
        for k in spec.names:
            pt[k].copy_(torch.where(has, new_p[k], pt[k]))
            bt[k].copy_(torch.where(has, new_b[k], bt[k]))

    # -- one round ---------------------------------------------------------

    def train_round(self, P: torch.Tensor, lr: float, user_idx: Sequence[int],
                    data: Tuple[torch.Tensor, ...], round_seed: int,
                    epoch_perms: Optional[Dict[int, np.ndarray]] = None,
                    codec_noise: Optional[torch.Tensor] = None,
                    topk_offset: Optional[int] = None,
                    lm_draws: Optional[Callable[[int, int], Dict[str, Any]]] = None,
                    rates: Optional[Sequence[float]] = None,
                    aug_draws: Optional[Callable[[int, int], Tuple[Any, Any]]] = None,
                    step_limits=None, alive=None, epoch: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One round from the global flat params ``P``.

        ``data``: device stacks ``(x [U, N, H, W, C] uint8, y [U, N],
        sample_mask [U, N], label_mask [U, classes])``, or for a masked LM
        ``(token rows [U, R, T], label_mask [U, num_tokens])``.  Returns the new
        global flat params and per-client metric sums (device tensors
        ``loss_sum``, ``score_sum``, ``n``; host ``rate``, the users'
        absolute rates).  ``rates``: the users' absolute rates; without
        them a ``dynamic`` round draws them (``fed.core.round_rates`` at
        ``round_seed``) and a ``fix`` round takes each user's own.  An empty
        cohort leaves ``P`` as it is (the stale-value fallback everywhere)
        and sends nothing through a wire codec.

        The scheduler (:meth:`slot_plan`): a ``-1`` slot (a schedule's
        padding) or a failed client trains nothing, counts nothing and
        reports a zero metrics row and rate 0 -- the reference trains a
        failed client and throws the result away, which gives the same
        round; under a deadline a client stops at its budget.

        Test hooks, which replace a draw from the round seed: ``epoch_perms``
        ``{uid: [E, N]}`` raw permutations; ``aug_draws(uid, t)`` a CIFAR
        client's augmentation ``(offsets [B, 2], flips [B])`` of local step
        ``t``; ``codec_noise`` the int8 codec's rounding noise ``[total]``
        (flat layout of ``self.spec``); ``topk_offset`` the topk codec's
        block offset; ``lm_draws(uid, t)`` an LM client's corruption and
        dropout draws of local step ``t``; ``step_limits`` and ``alive``
        (slot order) the deadline budgets and the survivors.

        ``epoch``: the round's number, which ``chaos_poison`` matches.  With
        probes or the quarantine gate on, the metrics also hold the round's
        ``obs_*`` rows (:meth:`_round_obs`; device tensors, and the host step
        fractions), which ``obs.split_probes`` finishes once fetched."""
        self._refuse_arms_k1()
        if self._poison is not None and epoch is None:
            raise ValueError("chaos_poison needs epoch= on train_round (the "
                             "K=1 program matches poisons by (round, uid))")
        lm_all = data[-1]
        self._check_sharded(data)
        user_idx = np.asarray(user_idx, np.int64).reshape(-1)
        rates_abs = cohort_rates(self.cfg, user_idx, round_seed, rates)
        valid, limits = self.slot_plan(user_idx, round_seed, self.total_steps(data),
                                       step_limits, alive)
        wrs = to_width_rates(rates_abs, self.cfg)
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=P.device)
        summed = torch.zeros_like(P)
        counts = torch.zeros_like(P)
        hits = None if self._poison is None else poison_hits(self._poison, epoch, user_idx)
        oks = [] if self._quarantine.enabled else None
        (positions,), per = self._layout(user_idx[None], data)
        rows, pos = [], []
        # this rank's slots, in schedule order
        # staticcheck: allow(no-device-get) a numpy array
        for slot in positions[self.mesh.rank].tolist():
            uid = int(user_idx[slot])
            if not valid[slot]:
                rows.append(P.new_zeros(3))
                continue
            # staticcheck: allow(no-fresh-rng) seeded on the next line
            gen = torch.Generator(device=P.device)
            gen.manual_seed(client_seed(round_seed, uid))
            wr, limit, row = float(wrs[slot]), int(limits[slot]), self._data_row(uid, data)
            if self.is_lm:
                draws = None if lm_draws is None else (lambda t, u=uid: lm_draws(u, t))
                trained, acc = self.local_train_lm(P, wr, data[0][row], lm_all[row], gen, lr_t,
                                                   draws, step_limit=limit)
            else:
                trained, acc = self.local_train(
                    P, wr, data[0][row], data[1][row], data[2][row], lm_all[row], gen, lr_t,
                    None if epoch_perms is None else epoch_perms[uid],
                    None if aug_draws is None else (lambda t, u=uid: aug_draws(u, t)),
                    step_limit=limit)
            cm = self.count_mask_flat(wr, lm_all[row])
            trained, cm, ok = self._guard(trained, P, cm,
                                          None if hits is None else hits[slot:slot + 1])
            if ok is not None:
                oks.append(ok)
                pos.append(slot)
            summed += trained * cm
            counts += cm
            rows.append(acc)
        new_P, summed, counts = self._aggregate(P, summed, counts, round_seed, len(user_idx),
                                                codec_noise, topk_offset, cmax=per)
        acc = self._collect_rows(rows, positions, per, len(user_idx))
        ms = {"loss_sum": acc[:, 0], "score_sum": acc[:, 1], "n": acc[:, 2],
              "rate": rates_abs * valid}
        obs = self._round_obs(P, new_P, summed, counts,
                              self._gate_row(oks, pos, len(user_idx), P.device), limits,
                              self.total_steps(data))
        if obs is not None:
            ms.update(obs)
        return new_P, ms

    # -- the superstep: k rounds, each client's steps replayed ---------------

    def _slots(self, P: torch.Tensor, data) -> Dict[str, torch.Tensor]:
        """The captured steps' static buffers (made once): the client's
        params, momentum, gradient, data, permutations, sums, the step
        counter and the round's learning rate."""
        if self._st is not None:
            return self._st
        dev = P.device
        st = {"p": torch.empty_like(P), "buf": torch.empty_like(P), "g": torch.empty_like(P),
              "acc": torch.zeros(3, dtype=torch.float32, device=dev),
              "t": device_counter(dev),
              "lr": torch.zeros((), dtype=torch.float32, device=dev),
              "lm": torch.zeros_like(data[-1][0])}
        if self.is_lm:
            R, T = data[0].shape[1:]
            wpos, n_win = self._window_weights(R, T, dev)
            st.update(rows_p=torch.zeros(wpos.shape, dtype=data[0].dtype, device=dev),
                      wpos=wpos, n_win=n_win,
                      rows_n=torch.full((), float(R), dtype=torch.float32, device=dev),
                      ar=torch.arange(self.bptt, device=dev))
            st["steps"] = self.local_epochs * n_win.numel()
        else:
            wpad = self._pad_weights(data[0].shape[1], dev)
            st.update(x=torch.zeros_like(data[0][0]), y=torch.zeros_like(data[1][0]),
                      sm=torch.zeros_like(data[2][0]), wpad=wpad,
                      perms=torch.zeros(self.local_epochs * wpad.numel(), dtype=torch.int64,
                                        device=dev),
                      ar=torch.arange(self.batch_size, device=dev))
            st["steps"] = self.local_epochs * wpad.numel() // self.batch_size
        self._st = st
        return st

    def _counted_vision_step(self, st, wr: float, mask: torch.Tensor,
                             gen: torch.Generator) -> None:
        """:meth:`_vision_step` on the static buffers, batch ``t`` read
        through the device step counter, which it advances."""
        B = self.batch_size
        S = st["wpad"].numel() // B
        t = st["t"]
        ids = st["perms"].index_select(0, t * B + st["ar"])
        w = st["wpad"].index_select(0, torch.remainder(t, S) * B + st["ar"]) \
            * st["sm"].index_select(0, ids)
        self._vision_step(st, wr, wr, mask, gen, st["x"].index_select(0, ids),
                          st["y"].index_select(0, ids), w)
        st["t"] += 1

    def _counted_lm_step(self, st, wr: float, mask: torch.Tensor, gen: torch.Generator) -> None:
        """:meth:`_lm_step` on the static buffers, window ``t % S`` read
        through the device step counter, which it advances."""
        bptt = self.bptt
        s = torch.remainder(st["t"], st["n_win"].numel())
        cols = s * bptt + st["ar"]
        self._lm_step(st, wr, wr, mask, gen, st["rows_p"].index_select(1, cols),
                      st["wpos"].index_select(1, cols),
                      st["n_win"].index_select(0, s.view(1)).view(()))
        st["t"] += 1

    def client_step(self, wr: float, P: torch.Tensor, data):
        """The captured step of a client at width rate ``wr`` (captured on
        first use) and its static buffers."""
        st = self._slots(P, data)
        mask = self.param_mask_flat(wr)
        body = self._counted_lm_step if self.is_lm else self._counted_vision_step
        step = self.graphs.get(("client", wr), lambda: body(st, wr, mask, self._ggen),
                               st["t"].zero_, [self._ggen])
        return step, st

    def stage_client(self, st, P: torch.Tensor, wr: float, row: int, data, cseed: int,
                     raw_perms: Optional[np.ndarray] = None) -> None:
        """Eager set-up of one client into the static buffers: the masked
        params, zero momentum and sums, the step counter at 0, its data
        (row ``row`` of the stacks: its user id in the eager stacks, its
        slot in a cohort's) and (vision) its epoch permutations with real
        samples first, drawn from the step's generator reseeded for the
        client -- ``local_train``'s prologue (``raw_perms`` its hook)."""
        gen = self._ggen
        gen.manual_seed(cseed)
        torch.mul(P, self.param_mask_flat(wr), out=st["p"])
        st["buf"].zero_()
        st["acc"].zero_()
        st["t"].zero_()
        st["lm"].copy_(data[-1][row])
        if self.is_lm:
            rows = data[0][row]
            st["rows_p"].zero_()
            st["rows_p"][:, :rows.shape[1]].copy_(rows)
            return
        st["x"].copy_(data[0][row])
        st["y"].copy_(data[1][row])
        st["sm"].copy_(data[2][row])
        st["perms"].copy_(self._epoch_perms(gen, data[2][row], raw_perms).reshape(-1))

    def _replayed_round(self, P: torch.Tensor, user_idx: np.ndarray, rates_abs: np.ndarray,
                        data, rseed: int, rows=None, epoch_perms=None, codec_noise=None,
                        step_limits=None, alive=None, epoch: int = 0, mine=None,
                        per: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray, Optional[Dict]]:
        """One round (number ``epoch``) of the superstep: per client the eager
        set-up, then its steps replayed (up to its budget, :meth:`slot_plan`;
        a padding or failed slot is skipped with a zero row); the poison and
        the gate, aggregation (and the codec) and the probes on the device
        as :meth:`train_round` -> ``(new P, [per, 3] device sums of this
        rank's slots, reported rates, obs rows or None)``.  ``rows``: each
        slot's row of ``data`` (default its user id, or its place in a
        sharded rank's block); ``mine`` and ``per``: this rank's slot
        positions and the slots a rank (:meth:`_layout`; default the
        round's own layout); hooks as :meth:`train_superstep`'s, this
        round's."""
        total = self.total_steps(data)
        valid, limits = self.slot_plan(user_idx, rseed, total, step_limits, alive)
        wrs = to_width_rates(rates_abs, self.cfg)
        summed = torch.zeros_like(P)
        counts = torch.zeros_like(P)
        hits = None if self._poison is None else poison_hits(self._poison, epoch, user_idx)
        oks = [] if self._quarantine.enabled else None
        if mine is None:
            (positions,), per = self._layout(user_idx[None], data)
            mine = positions[self.mesh.rank]
        sums, pos = [], []
        # this rank's slots, in schedule order
        # staticcheck: allow(no-device-get) a numpy array
        for slot in np.asarray(mine).tolist():
            uid = int(user_idx[slot])
            if not valid[slot]:
                sums.append(P.new_zeros(3))
                continue
            wr = float(wrs[slot])
            row = self._data_row(uid, data) if rows is None else int(rows[slot])
            step, st = self.client_step(wr, P, data)
            self.stage_client(st, P, wr, row, data, client_seed(rseed, uid),
                              None if epoch_perms is None else epoch_perms[uid])
            for _ in range(min(st["steps"], int(limits[slot]))):
                step.replay()
            cm = self.count_mask_flat(wr, data[-1][row])
            trained, cm, ok = self._guard(st["p"], P, cm,
                                          None if hits is None else hits[slot:slot + 1])
            if ok is not None:
                oks.append(ok)
                pos.append(slot)
            summed += trained * cm
            counts += cm
            sums.append(st["acc"].clone())
        a = len(user_idx)
        if per is None:
            per = a
        if len(sums) < per:  # this rank's padding slots
            sums += [P.new_zeros(3) for _ in range(per - len(sums))]
        acc = torch.stack(sums) if sums else P.new_zeros((0, 3))
        new_P, summed, counts = self._aggregate(P, summed, counts, rseed, a, codec_noise,
                                                cmax=per)
        return new_P, acc, rates_abs * valid, self._round_obs(
            P, new_P, summed, counts, self._gate_row(oks, pos, a, P.device), limits,
            total)

    def stage_cohort(self, store: ClientStore, user_schedule, rate_schedule=None
                     ) -> StagedCohort:
        """Gather and commit one superstep's cohort from ``store`` (ref
        round_engine.py:1423-1485): the ``[k, A]`` cohorts in schedule
        order, a slot a row (a ``-1`` slot gathers user 0's shard and is
        skipped in training), through the engine's cohort ring; ``rate_schedule``
        (``[k, A]``, optional) rides with it.  Host and device bytes are
        O(k x A x shard), whatever the population; call it for superstep
        N+1 right after superstep N is dispatched."""
        users = np.asarray(user_schedule, np.int64)
        if users.ndim != 2:
            raise ValueError(f"user_schedule must be [k, A], got {users.shape}")
        k, a = users.shape
        rates = None if rate_schedule is None else np.asarray(rate_schedule, np.float32)
        rows = np.arange(k * a, dtype=np.int64).reshape(k, a)
        return self.cohort_stager().stage(("masked", k, a), store, "masked", users, users,
                                          rates, rows)

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
        them (ref parallel/round_engine.py:1487-1767): round r trains the
        cohort ``user_schedule[r]`` at the absolute rates
        ``rate_schedule[r]`` and learning rate ``lrs[r]`` (written into the
        steps' static scalar), its draws from ``round_seed(seed, epoch0 +
        r)`` as :meth:`train_round` draws them, each client's steps replayed
        from the captured step of its width rate; where ``eval_mask[r]``
        fires, ``fused_eval`` evaluates the round's params.  Returns the new
        params and the :class:`~.staging.PendingMetrics` whose ``fetch()``
        yields k per-round dicts, or ``{"train", "eval"}``; its timers are
        ``train`` and ``eval``.  Test hooks, which replace a draw from the
        round seed, one entry a round: ``epoch_perms[r]`` ``{uid: [E, N]}``
        raw permutations (vision), ``codec_noise[r]`` the int8 codec's
        noise, ``step_limits[r]`` and ``alive[r]`` the deadline budgets and
        the survivors in slot order.

        ``cohort`` (:meth:`stage_cohort`) replaces ``data``: each client's
        data is its slot's row of the cohort (``user_schedule`` defaults to
        the cohort's, ``rate_schedule`` to its rates); the cohort is released
        once the superstep's reads are enqueued.  The steps are the eager
        stacks' steps on the same rows, so the result is the same bit for
        bit.

        Under ``cfg['arms']`` (:meth:`FlatParams._arms_superstep`): ``P`` is
        the arms' params ``[E, n]``, ``seed`` the run's stream root (each
        arm's own derived from it), ``user_schedule`` and ``rate_schedule``
        ``[E, k, A]`` (or ``[k, A]`` shared), ``lrs`` ``[E, k]`` (or the
        shared ``[k]``, scaled per arm); the hooks take a leading arm index
        (``epoch_perms[e][r]``, ...); the result is ``[E, n]`` and the fetch
        ``{"arms": [...]}``."""
        def hook(h, r):
            return None if h is None else h[r]

        if self.arms is not None:
            if cohort is not None:
                raise ValueError(
                    "arms need the eager data path: a staged cohort holds "
                    "ONE schedule's shards, and per-arm cohorts would "
                    "multiply the staged bytes by E (a ROADMAP follow-on)")
            st = self._slots(P[0], data)
            return self._arms_superstep(
                P, seed, k, user_schedule, rate_schedule, lrs,
                lambda e, Pe, aseed, users, rates, lrs_e: self._superstep_parts(
                    Pe, aseed, epoch0, k, users, rates, lrs_e, eval_mask, fused_eval, st["lr"],
                    lambda P, r, u, rt, rseed: self._replayed_round(
                        P, u, rt, data, rseed, None, hook(hook(epoch_perms, e), r),
                        hook(hook(codec_noise, e), r), hook(hook(step_limits, e), r),
                        hook(hook(alive, e), r), epoch0 + r)))
        data, user_schedule, rate_schedule, rows = self._cohort_args(
            "masked", k, data, user_schedule, rate_schedule, cohort)
        if cohort is None:
            self._check_sharded(data)
        st = self._slots(P, data)
        users = np.asarray(user_schedule, np.int64)
        # a cohort's rows are its slots: laid out as the reference's
        # streamed cohort, ceil(A / n) a rank whatever the placement
        layout = self._layout(users, data, bucket=True) if cohort is None \
            else rank_slots(users, self.mesh.size)
        positions, per = layout

        try:
            return self._superstep(
                P, seed, epoch0, k, user_schedule, rate_schedule, lrs, eval_mask, fused_eval,
                st["lr"], lambda P, r, users, rates, rseed: self._replayed_round(
                    P, users, rates, data, rseed, hook(rows, r), hook(epoch_perms, r),
                    hook(codec_noise, r), hook(step_limits, r), hook(alive, r), epoch0 + r,
                    positions[r][self.mesh.rank], per),
                finish=lambda train: self._collect_superstep(train, layout, users.shape[1]))
        finally:
            if cohort is not None:
                cohort.release()
