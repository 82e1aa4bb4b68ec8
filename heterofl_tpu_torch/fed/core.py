"""Federation algebra: per-round rates, width rates, the width-geometry
check and counted aggregation.

Port of ``heterofl_tpu/fed/core.py``: ``sample_model_rates``/
``round_rates`` (core.py:33-58, :145), the cohort draw ``round_users`` and
the superstep's ``[k, A]`` schedules (:155-251), ``validate_width_geometry``
(:63-85), ``snap_to_levels`` (:254-281), ``to_width_rates`` and
``combine_counted`` (:442-473), the per-level FLOP, parameter and
wire-byte tables (``level_flop_table`` ... ``level_flop_shares``,
:277-440; built on ``analysis.summary.module_table``), and the sliced strategy's
``active_indices``/``extract_sliced``/``embed_sliced`` (:555-607) on the
port's tensor axes (OIHW conv, ``[out, in]`` linear).  The round engines
work in the flat domain (one buffer per tree, ops/fused_update.FlatSpec),
so the counted average takes flat buffers.  The torch form of the extract
and embed is one int64 map per level (:func:`level_index_map`): the
level's flat entries at their places in the global flat layout, so
extract is ``P.index_select(0, idx)`` and embed adds at ``idx`` (the
entries are unique, so the embed is exact).

The ``dynamic`` rate draw comes from a ``torch.Generator`` on the host,
seeded from the round seed and :data:`ROUND_RATE_SALT`, so a round's rates
depend on (seed, round) alone and a resumed run draws what an uninterrupted
one drew.  The reference draws from ``jax.random``, which torch does not
reproduce: tests hand the reference's draws to the round engine instead.

Every per-round draw descends from :func:`round_seed` ``(seed, epoch)``,
one stream for the K=1 round and the K-round superstep: a run at
``superstep_rounds=K`` trains the cohorts and rates a K=1 run trains.
Under ``sampler='perm'`` the cohorts come from the experiment's numpy
permutation stream (reference parity at K=1), and the superstep's schedule
takes the next k draws of that same stream; the reference's superstep draws
``jax.random.permutation`` there instead, which torch cannot reproduce.
A schedule's availability row filters either draw (:func:`round_users`),
and :func:`client_alive` draws the round's failures from the port's own
stream.  An experiment arm roots its draws at :func:`arm_stream_seed`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .sampling import prp_round_keys, prp_round_users

#: salt of the per-round rate stream (the reference's ``fold_in(round_key,
#: ROUND_RATE_SALT)``)
ROUND_RATE_SALT = 7


def rate_generator(round_seed: int) -> torch.Generator:
    """The generator of one round's rate draw."""
    state = np.random.SeedSequence([int(round_seed), ROUND_RATE_SALT]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def sample_model_rates(gen: Optional[torch.Generator], cfg: Dict[str, Any],
                       user_idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Absolute model rates (float32) of the given users (all when None) for
    one round.  ``fix``: the static per-user vector of ``process_control``,
    indexed by user.  ``dynamic``: every one of ``num_users`` draws a level
    i.i.d. with probabilities ``cfg['proportion']`` (ref fed.py:15-19), and
    the selected users' draws are kept, as the reference does."""
    users = np.arange(cfg["num_users"]) if user_idx is None \
        else np.asarray(user_idx, np.int64).reshape(-1)
    rates = np.asarray(cfg["model_rate"], np.float32)
    if cfg["model_split_mode"] == "fix":
        return rates[users]
    if cfg["model_split_mode"] == "dynamic":
        p = torch.as_tensor(cfg["proportion"], dtype=torch.float64)
        idx = torch.multinomial(p, cfg["num_users"], replacement=True, generator=gen)
        return rates[idx.numpy()][users]
    raise ValueError("Not valid model split mode")


def round_rates(round_seed: int, cfg: Dict[str, Any],
                user_idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """The rate draw of the round with seed ``round_seed``, salt included:
    the one definition of the rate stream, used by the experiment loop and
    by the round engine when it is handed no rates."""
    return sample_model_rates(rate_generator(round_seed), cfg, user_idx)


#: salt of the per-arm stream derivation (the reference's ``ARM_STREAM_SALT``)
ARM_STREAM_SALT = 0x4152


def arm_stream_seed(seed: int, arm_seed: Optional[int]) -> int:
    """The root of an experiment arm's seed stream (``multi/``): ``seed``
    itself for the identity arm (``arm_seed`` None), else a function of
    (``seed``, :data:`ARM_STREAM_SALT`, ``arm_seed``).  Every per-round draw
    of the arm (its cohort under ``prp``, its dynamic rates, its clients'
    generators, deadline budgets and failures) descends from it through
    :func:`round_seed`, as a run's from its seed, so an arm replays a solo
    run with the same root, and the identity arm replays the unbatched run.
    The reference folds the seed into the host key
    (``fold_in(fold_in(key, ARM_STREAM_SALT), s)``, fed/core.py:108-124),
    which torch does not reproduce."""
    if arm_seed is None:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), ARM_STREAM_SALT, int(arm_seed)]
                                      ).generate_state(1)[0])


def arm_stream_seeds(seed: int, arm_seeds: Sequence[Optional[int]]) -> List[int]:
    """:func:`arm_stream_seed` of each arm, in arm order."""
    return [arm_stream_seed(seed, s) for s in arm_seeds]


def round_seed(seed: int, epoch: int) -> int:
    """The seed of round ``epoch`` of the experiment with seed ``seed``: the
    root of the round's cohort (``prp``), rate, client and codec draws."""
    return int(np.random.SeedSequence([int(seed), int(epoch)]).generate_state(1)[0])


def round_users(rseed: int, num_users: int, num_active: int, sampler: str = "perm",
                rng: Optional[np.random.Generator] = None, avail=None) -> np.ndarray:
    """The cohort of the round with seed ``rseed`` (int64 ``[num_active]``;
    ref core.py:155-207): ``'prp'`` the image of ``[0, num_active)`` under
    the round's keyed permutation; ``'perm'`` the next full permutation of
    the experiment's numpy stream ``rng``, cut to ``num_active``.  A
    ``num_active`` outside ``[0, num_users]`` raises ``ValueError`` with the
    reference's message.

    ``avail``: the round's ``[num_users]`` 0/1 availability row (a
    schedule's, ``ScheduleSpec.avail_row``), or None.  With a row the
    available users come first, in permutation order, and the slots they
    cannot fill are ``-1`` (padding): under ``'perm'`` the reference's
    stable sort of the permuted row (core.py:202-207), under ``'prp'`` its
    draw-then-filter walk (``sampling.prp_round_users``).  An all-ones row
    selects the uniform cohort."""
    if not 0 <= num_active <= num_users:
        raise ValueError(
            f"round_users: num_active={num_active} must be in [0, "
            f"num_users={num_users}] -- the legacy permutation draw would "
            f"silently short the cohort (and a negative count silently "
            f"wrap); fix cfg['frac']/num_active")
    if sampler == "prp":
        return prp_round_users(prp_round_keys(rseed, num_users), num_users,
                               num_active, avail).astype(np.int64)
    if sampler == "perm":
        if rng is None:
            raise ValueError("round_users: sampler='perm' draws from the experiment's "
                             "numpy stream; pass rng")
        return filter_available(rng.permutation(num_users), num_active, avail)
    raise ValueError(f"Not valid sampler: {sampler!r} (one of ('perm', 'prp'))")


def filter_available(perm: np.ndarray, num_active: int, avail=None) -> np.ndarray:
    """The first ``num_active`` users of the permutation ``perm`` (int64),
    or with an availability row the available ones first, in ``perm``'s
    order (a stable sort), the slots they cannot fill ``-1``."""
    perm = np.asarray(perm, np.int64)
    if avail is None:
        return perm[:num_active]
    a = np.asarray(avail, np.float32)[perm]
    order = np.argsort(-a, kind="stable")[:num_active]
    return np.where(a[order] > 0, perm[order], -1).astype(np.int64)


def superstep_user_schedule(seed: int, epoch0: int, k: int, num_users: int, num_active: int,
                            sampler: str = "perm",
                            rng: Optional[np.random.Generator] = None,
                            schedule=None) -> np.ndarray:
    """``[k, A]`` cohorts of rounds ``epoch0 .. epoch0 + k - 1`` (ref
    core.py:210-239): :func:`round_users` at each round's seed, in round
    order, so the schedule is what k K=1 rounds draw.  ``schedule`` (a
    ``sched.ScheduleSpec``, or None) gives round ``epoch0 + r`` its
    availability row; ``-1`` marks a slot it could not fill."""
    if epoch0 < 0:
        raise ValueError(f"superstep_user_schedule: epoch0={epoch0} must be non-negative")
    if k < 0:
        raise ValueError(f"superstep_user_schedule: k={k} must be non-negative")
    if not k:
        return np.zeros((0, num_active), np.int64)
    return np.stack([round_users(round_seed(seed, epoch0 + r), num_users, num_active, sampler,
                                 rng, None if schedule is None
                                 else schedule.avail_row(epoch0 + r)) for r in range(k)])


#: salt of the per-round failure draw (the reference's ``FAILURE_STREAM_SALT``)
FAILURE_STREAM_SALT = 98


def client_alive(rseed: int, uids, failure_rate: float) -> np.ndarray:
    """bool ``[slots]``: which of the round's slots survive
    ``client_failure_rate`` -- a slot fails with probability
    ``failure_rate``, a Bernoulli draw keyed by (round seed, user id) on the
    port's own stream (the reference draws ``jax.random.bernoulli`` at
    ``fold_in(fold_in(key, 98), uid)``, round_engine.py:853-866).  A failed
    client's update never reaches the aggregate; ``-1`` slots draw user
    0's, as the reference's ``max(uid, 0)``."""
    uids = np.asarray(uids, np.int64).reshape(-1)
    if failure_rate <= 0.0:
        return np.ones(uids.shape, bool)
    u = np.asarray([np.random.SeedSequence([int(rseed), FAILURE_STREAM_SALT, max(int(x), 0)])
                    .generate_state(1, np.uint32)[0] >> np.uint32(8) for x in uids],
                   np.float64) * 2.0 ** -24
    return ~(u < float(failure_rate))


def superstep_rate_schedule(seed: int, epoch0: int, k: int, cfg: Dict[str, Any],
                            user_schedule) -> np.ndarray:
    """``[k, A]`` absolute rates (float32) of the schedule's cohorts (ref
    core.py:242-251): each user's own in ``fix`` mode, each round's draw
    (:func:`round_rates` at the round's seed) in ``dynamic`` mode.  A ``-1``
    slot takes user ``U - 1``'s rate, as the reference's ``jnp.take`` wraps
    index ``-1`` (core.py:51): the grouped engine places the padding slot
    in that user's level."""
    users = np.asarray(user_schedule, np.int64)
    if cfg["model_split_mode"] == "fix":
        return np.asarray(cfg["model_rate"], np.float32)[users].reshape(users.shape)
    return np.stack([round_rates(round_seed(seed, epoch0 + r), cfg, users[r])
                     for r in range(k)]).reshape(users.shape).astype(np.float32)


def validate_width_geometry(model, cfg: Dict[str, Any]) -> None:
    """Refuse width configs where the per-head q/k/v slice and the prefix
    width slice keep different numbers of dims at some level (ref
    fed/core.py:63-85; such a transformer trains NaN).  Raises with the
    reference's message."""
    rates = {float(r) / cfg["global_model_rate"] for r in cfg["model_rate"]}
    for name, g in model.groups.items():
        if g.kind != "per_head":
            continue
        hd = g.size // g.num_heads
        for wr in sorted(rates):
            if g.num_heads * math.ceil(hd * wr) != math.ceil(g.size * wr):
                raise ValueError(
                    f"width geometry: group {name!r} (size {g.size}, "
                    f"{g.num_heads} heads) is inconsistent at rate {wr:g}: "
                    f"per-head slice keeps {g.num_heads * math.ceil(hd * wr)} "
                    f"dims but the width slice keeps {math.ceil(g.size * wr)}; "
                    f"pick embedding_size so embedding*rate is a multiple-safe "
                    f"size (e.g. embedding_size*min_rate >= num_heads and "
                    f"head_dim divisible by 1/min_rate)")


#: module_table rows whose backward pass re-runs the contraction twice
#: (grad wrt inputs + grad wrt weights); everything else (norms, relu,
#: pools) back-propagates at about 1x its forward
_MATMUL_LIKE = ("conv", "linear", "shortcut", "mha", "ff.l", "dec.l",
                "embedding", "qk", "av")

#: optimizer + width/label masking + clipping cost per parameter per step
#: (SGD momentum update, weight decay, mask multiply, global-norm terms)
_OPT_FLOPS_PER_PARAM = 10.0

#: bytes per parameter element on the wire and in device memory: params,
#: update sums and count masks are all float32 (compute_dtype only narrows
#: the operands)
PARAM_ITEMSIZE = 4


def _level_rates(cfg: Dict[str, Any], rates: Optional[list]) -> List[float]:
    if rates is None:
        return sorted({float(r) for r in cfg["model_rate"]}, reverse=True)
    return [float(r) for r in rates]


def level_flop_table(cfg: Dict[str, Any], rates: Optional[list] = None) -> Dict[float, float]:
    """Analytic per-client per-local-step training FLOPs at each level of
    the rate table, the one source of level FLOP budgets (ref
    fed/core.py:290-339): from :func:`~..analysis.summary.module_table`,
    forward = 2x MACs, backward = 2x forward for the matmul-like modules
    and 1x for the elementwise ones, plus :data:`_OPT_FLOPS_PER_PARAM` a
    parameter and the width-independent data preparation (normalise; CIFAR
    also crops and flips).  A model, not a measurement: compare shares
    (:func:`level_flop_shares`)."""
    from ..analysis.summary import module_table

    grate = cfg["global_model_rate"]
    bs = cfg["batch_size"]["train"] if isinstance(cfg["batch_size"], dict) \
        else cfg["batch_size"]
    prep = 0.0
    if cfg.get("data_shape"):
        h, w, c = cfg["data_shape"]
        prep = 2.0 * bs * h * w * c
        if str(cfg.get("data_name", "")).startswith("CIFAR"):
            prep *= 3.0
    out: Dict[float, float] = {}
    for r in _level_rates(cfg, rates):
        fwd = bwd = 0.0
        nparam = 0
        for name, _insz, _outsz, p, macs in module_table(cfg, r / grate, bs):
            fl = 2.0 * macs
            fwd += fl
            bwd += fl * (2.0 if any(t in name for t in _MATMUL_LIKE) else 1.0)
            nparam += p
        out[r] = fwd + bwd + _OPT_FLOPS_PER_PARAM * nparam + prep
    return out


def level_param_table(cfg: Dict[str, Any], rates: Optional[list] = None) -> Dict[float, int]:
    """Per-level parameter counts of the sliced sub-model, a count view of
    :func:`level_byte_table` (ref fed/core.py:347-354)."""
    return {r: v["param_bytes"] // PARAM_ITEMSIZE
            for r, v in level_byte_table(cfg, rates).items()}


def level_byte_table(cfg: Dict[str, Any], rates: Optional[list] = None,
                     itemsize: int = PARAM_ITEMSIZE) -> Dict[float, Dict[str, int]]:
    """Per level (ref fed/core.py:357-390): ``param_bytes``, the sliced
    sub-model's parameters; ``wire_bytes``, the dense round's reduced
    payload at that level, the update sums and the count masks, both
    param-shaped float32; ``activation_bytes``, a local step's forward
    outputs at the training batch (:func:`~..analysis.summary.module_table`
    output sizes x float32).  The wire numbers are exact for the port's
    rounds, so ``staticcheck`` holds the payload to them by equality."""
    from ..analysis.summary import module_table

    grate = cfg["global_model_rate"]
    out: Dict[float, Dict[str, int]] = {}
    for r in _level_rates(cfg, rates):
        rows = module_table(cfg, r / grate)
        nparam = int(sum(row[3] for row in rows))
        act = int(sum(int(np.prod(row[2])) for row in rows))
        out[r] = {"param_bytes": nparam * itemsize, "wire_bytes": 2 * nparam * itemsize,
                  "activation_bytes": act * itemsize}
    return out


def level_codec_byte_table(cfg: Dict[str, Any], codec: str, rates: Optional[list] = None,
                           n_leaves: int = 0) -> Dict[float, int]:
    """Per-level wire bytes of one round under ``codec`` (ref
    fed/core.py:393-410): the level's flat element count priced by
    :func:`~..compress.codec_payload_bytes`, the one bytes formula.
    ``n_leaves`` only moves ``signsgd``'s scale vector."""
    from ..compress import codec_payload_bytes

    return {r: codec_payload_bytes(codec, n, n_leaves)
            for r, n in level_param_table(cfg, rates).items()}


def level_codec_map_byte_table(cfg: Dict[str, Any], codec_map: Dict[float, str],
                               rates: Optional[list] = None,
                               n_leaves: int = 0) -> Dict[float, int]:
    """Per-level wire bytes of one grouped round under a per-level codec
    map (ref fed/core.py:413-437): level ``r`` moves its sliced element
    count priced by its own codec; the round moves the sum.  A level the
    map lacks raises ``ValueError``."""
    from ..compress import codec_payload_bytes

    table = level_param_table(cfg, rates)
    missing = set(table) - {float(r) for r in codec_map}
    if missing:
        raise ValueError(f"codec map misses levels {sorted(missing)}: every "
                         f"level in the rate table needs a codec")
    return {r: codec_payload_bytes(codec_map[float(r)], n, n_leaves)
            for r, n in table.items()}


def level_flop_shares(cfg: Dict[str, Any], weights: Optional[Dict[float, float]] = None,
                      rates: Optional[list] = None) -> Dict[float, float]:
    """Each level's share of the FLOPs, ``weight x`` :func:`level_flop_table`
    normalised to sum to 1 (ref fed/core.py:440-452); uniform weights by
    default."""
    table = level_flop_table(cfg, rates)
    w = {r: 1.0 for r in table} if weights is None \
        else {float(r): float(v) for r, v in weights.items()}
    raw = {r: w.get(r, 0.0) * f for r, f in table.items()}
    tot = sum(raw.values())
    if tot <= 0.0:
        raise ValueError(f"level FLOP shares degenerate: weights {w}")
    return {r: v / tot for r, v in raw.items()}


def to_width_rates(model_rates, cfg: Dict[str, Any]) -> np.ndarray:
    """Absolute model rate -> width/scaler rate relative to the global model
    (float32, as the reference computes it)."""
    return np.asarray(model_rates, np.float32) / np.float32(cfg["global_model_rate"])


def combine_counted(global_flat: torch.Tensor, summed: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """Counted average with stale fallback: ``sum / count`` where some client
    held the entry, the previous global value elsewhere (ref fed.py:217-218)."""
    return torch.where(counts > 0, summed / counts.clamp_min(1.0), global_flat)


def snap_to_levels(rates, levels, rtol: float = 1e-5, atol: float = 1e-8) -> np.ndarray:
    """Snap absolute model rates onto a level table (ref core.py:254-281):
    each rate to its nearest level, which must be ``isclose`` to it; a
    rate near no level raises ``ValueError`` naming it, before any client
    trains."""
    table = np.asarray(sorted({float(r) for r in levels}, reverse=True), np.float64)
    r = np.asarray(rates, np.float64).reshape(-1)
    if r.size == 0:
        return r
    snapped = table[np.argmin(np.abs(r[:, None] - table[None, :]), axis=1)]
    ok = np.isclose(r, snapped, rtol=rtol, atol=atol)
    if not ok.all():
        bad = sorted(set(np.round(r[~ok], 6).tolist()))
        raise ValueError(
            f"model rates {bad} are not in the engine's level table {table.tolist()}: every "
            f"sampled rate must match a level built at engine construction (fix "
            f"cfg['model_rate'] or the incoming rate stream)")
    return snapped


def active_indices(group, width_rate: float) -> np.ndarray:
    """The active entries of a width group at ``width_rate`` (host side;
    ref core.py:555-567): all of them (``full``), the first ``ceil(size *
    rate)`` (``prefix``) or the first ``ceil(head_dim * rate)`` of each
    head (``per_head``)."""
    if group.kind == "full":
        return np.arange(group.size)
    if group.kind == "prefix":
        return np.arange(int(math.ceil(group.size * width_rate)))
    if group.kind == "per_head":
        hd = group.size // group.num_heads
        kh = int(math.ceil(hd * width_rate))
        return np.arange(group.size).reshape(group.num_heads, hd)[:, :kh].reshape(-1)
    raise ValueError(group.kind)


def extract_sliced(params: Dict[str, np.ndarray], specs, groups, width_rate: float
                   ) -> Dict[str, np.ndarray]:
    """The sub-model at ``width_rate``: every axis of every leaf cut to its
    group's active entries (ref core.py:570-580, the reference's
    ``v[torch.meshgrid(idx)]``)."""
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        for axis, gname in sorted(specs[k].axis_groups.items()):
            v = np.take(v, active_indices(groups[gname], width_rate), axis=axis)
        out[k] = v.copy()
    return out


def embed_sliced(sliced: Dict[str, np.ndarray], specs, groups, width_rate: float,
                 full_shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, np.ndarray]:
    """A sub-model's leaves scattered into zero leaves of ``full_shapes``
    (the inverse of :func:`extract_sliced`; ref core.py:583-596)."""
    out = {}
    for k, small in sliced.items():
        small = np.asarray(small)
        full = np.zeros(full_shapes[k], dtype=small.dtype)
        idx = [slice(None)] * full.ndim
        for axis, gname in specs[k].axis_groups.items():
            idx[axis] = active_indices(groups[gname], width_rate)
        full[np.ix_(*[np.arange(n) if isinstance(i, slice) else i
                      for n, i in zip(full.shape, idx)])] = small
        out[k] = full
    return out


def level_index_map(spec, level_spec, specs, groups, width_rate: float) -> np.ndarray:
    """int64 ``[level_spec.total]``: for each entry of the sub-model's flat
    layout (``level_spec``, the level model's leaves in sorted-key order),
    its place in the global flat layout ``spec``."""
    ids = {k: np.arange(spec.offsets[k], spec.offsets[k] + spec.sizes[k],
                        dtype=np.int64).reshape(spec.shapes[k]) for k in spec.names}
    sub = extract_sliced(ids, specs, groups, width_rate)
    for k in level_spec.names:
        if sub[k].shape != level_spec.shapes[k]:
            raise ValueError(f"level leaf {k}: the slice at rate {width_rate:g} is "
                             f"{sub[k].shape}, the level model's {level_spec.shapes[k]}")
    return np.concatenate([sub[k].reshape(-1) for k in level_spec.names])
