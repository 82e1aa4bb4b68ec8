"""Population sampler: O(active) cohort draws.

Port of ``heterofl_tpu/fed/sampling.py`` (its own copy, no import of the
reference): the sampler registry and config check (:class:`SamplerSpec`,
:func:`resolve_sampler_cfg`), and the keyed pseudorandom-permutation index
map of ``sampler='prp'`` -- a balanced Feistel network over the smallest
even-bit binary domain covering ``[0, num_users)``, made an exact
bijection on ``[0, num_users)`` by cycle-walking (re-encrypt until the
image lands back in range).  A round's cohort is the image of ``[0,
num_active)``: O(active) work and memory, never a ``[num_users]`` buffer.

The arithmetic is the reference's on the uint32 lattice (numpy ``uint32``
arrays wrap modulo 2**32, as ``jnp.uint32`` does), and the cycle walk runs
on the host: it is O(active) integer work once a round, and a data-dependent
loop has no place in a CUDA graph.  The Feistel round keys ``rk`` are an
argument of :func:`prp_map`: the reference draws them with ``jax.random``,
which torch does not reproduce, so the port derives its own from the round
seed (:func:`prp_round_keys`) and a test hands in the reference's to hold
the map bit for bit.

``sampler='perm'`` is the numpy permutation stream of the experiment loop
(``entry/common.py``), the port's default.  A schedule's availability row
filters either draw (:func:`prp_round_users`, ``fed.core.round_users``).
With ``sample_horizon`` the streaming driver commits its cohort schedule
(:class:`ScheduleCommitment`): superstep N+1's cohort is drawn only once
the state it may read is fetched.  Neither sampler reads that state, so the
committed schedule is the immediate one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

#: the sampler registry (``cfg['sampler']``)
SAMPLER_KINDS = ("perm", "prp")

#: salt of the per-round cohort draw (the reference's ``USER_SAMPLE_SALT``)
USER_SAMPLE_SALT = 11

#: salt of the Feistel key schedule (the reference's ``PRP_KEY_SALT``)
PRP_KEY_SALT = 23

#: candidates the availability walk visits per cohort slot (the
#: reference's ``AVAIL_OVERDRAW``)
AVAIL_OVERDRAW = 4


class SamplerSpec:
    """The resolved sampler configuration: ``kind`` (``'perm'`` or
    ``'prp'``) and ``horizon`` (None: a stateless sampler, prefetch
    unconstrained; an int >= 0: the schedule-commitment mode, where
    superstep N+1's cohort may only consume state fetched through superstep
    ``N - horizon``)."""

    def __init__(self, kind: str = "perm", horizon: Optional[int] = None):
        self.kind = kind
        self.horizon = horizon

    @property
    def committed(self) -> bool:
        return self.horizon is not None


def resolve_sampler_cfg(cfg: Dict[str, Any]) -> SamplerSpec:
    """Validate ``cfg['sampler']`` / ``cfg['sample_horizon']`` and return the
    :class:`SamplerSpec`; an unknown value raises ``ValueError`` with the
    reference's message.  The port's default is ``'perm'``."""
    kind = cfg.get("sampler", "perm") or "perm"
    if kind not in SAMPLER_KINDS:
        raise ValueError(f"Not valid sampler: {kind!r} (one of "
                         f"{SAMPLER_KINDS}; 'prp' is the O(active) "
                         f"index-map draw, 'perm' the legacy full "
                         f"permutation)")
    horizon = cfg.get("sample_horizon")
    if horizon is not None:
        if not isinstance(horizon, int) or isinstance(horizon, bool) or horizon < 0:
            raise ValueError(f"Not valid sample_horizon: {horizon!r} (an "
                             f"int >= 0 -- superstep N+1's cohort draws "
                             f"from superstep N-horizon's committed state "
                             f"-- or None for a stateless sampler)")
    return SamplerSpec(kind=kind, horizon=horizon)


class ScheduleCommitment:
    """The schedule-commitment ledger of ``sample_horizon`` (ref
    fed/sampling.py:115-166): which supersteps' states have been fetched,
    and so which future cohorts may be drawn.  Superstep indices count
    dispatches from 1; superstep ``n``'s cohort may read state no fresher
    than superstep ``n - horizon - 1``'s, so :meth:`may_draw` answers "is
    everything that draw would read on the host?".  With the driver's
    dispatch, prefetch, fetch order and ``horizon=1``, prefetching
    superstep N+1 while N runs is allowed because its draw reads superstep
    N-1's state.  ``state`` is the payload a state-reading sampler would
    read (:meth:`state_for`); ``perm`` and ``prp`` ignore it."""

    def __init__(self, horizon: int):
        self.horizon = int(horizon)
        self._committed = 0  # the highest superstep index whose state is fetched
        self._states: Dict[int, Any] = {}

    @property
    def committed_through(self) -> int:
        return self._committed

    def commit(self, index: int, state: Any = None) -> None:
        """Record superstep ``index``'s fetched state (monotonic); states no
        draw can reference any more are dropped."""
        index = int(index)
        if index > self._committed:
            self._committed = index
        self._states[index] = state
        floor = self._committed - (self.horizon + 1)
        for k in [k for k in self._states if k < floor]:
            del self._states[k]

    def may_draw(self, index: int) -> bool:
        """Whether superstep ``index``'s cohort may be drawn now: the state
        it reads (superstep ``index - horizon - 1``; <= 0 is the initial
        state) is committed."""
        return int(index) - (self.horizon + 1) <= self._committed

    def state_for(self, index: int) -> Any:
        """The committed state superstep ``index``'s draw reads (None before
        any commit and for indices before the run)."""
        return self._states.get(int(index) - (self.horizon + 1))


def _feistel_geometry(num_users: int):
    """Half-width ``b`` of the balanced domain (``4**b >= num_users``) and
    the round count: small domains mix poorly a round, so they get more."""
    b = 1
    while (1 << (2 * b)) < num_users:
        b += 1
    rounds = 24 if b <= 4 else (16 if b <= 8 else 10)
    return b, rounds


def _mix32(v: np.ndarray, k) -> np.ndarray:
    """murmur3-style 32-bit finalizer of ``v`` keyed by ``k`` (uint32
    arrays, wrapping): the Feistel round function."""
    h = v ^ np.uint32(k)
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def prp_round_keys(round_seed: int, num_users: int) -> np.ndarray:
    """The Feistel round keys (uint32 ``[rounds]``) of the round with seed
    ``round_seed``: the port's own stream, salted as the reference salts its
    key (cohort draw, then key schedule)."""
    _, rounds = _feistel_geometry(max(int(num_users), 2))
    return np.random.SeedSequence([int(round_seed), USER_SAMPLE_SALT, PRP_KEY_SALT]) \
        .generate_state(rounds, np.uint32)


def prp_map(rk, x, num_users: int) -> np.ndarray:
    """Apply the keyed PRP over ``[0, num_users)`` to the in-range indices
    ``x`` (ref fed/sampling.py:193-237) -> int32: the balanced Feistel
    network under round keys ``rk`` (uint32 ``[rounds]``), then the cycle
    walk, which ends because it follows the permutation's own cycle from an
    in-range start."""
    if num_users < 1:
        raise ValueError(f"prp_map needs num_users >= 1, got {num_users}")
    x = np.atleast_1d(np.asarray(x))
    if num_users == 1:
        return np.zeros(x.shape, np.int32)
    b, rounds = _feistel_geometry(num_users)
    rk = np.asarray(rk, np.uint32).reshape(-1)
    if rk.size != rounds:
        raise ValueError(f"prp_map over {num_users} users takes {rounds} round keys, "
                         f"got {rk.size}")
    mask, sh = np.uint32((1 << b) - 1), np.uint32(b)

    def enc(v):
        lo, hi = v & mask, v >> sh
        for r in range(rounds):
            hi, lo = lo, hi ^ (_mix32(lo, rk[r]) & mask)
        return (hi << sh) | lo

    y = enc(x.astype(np.uint32))
    out = y >= np.uint32(num_users)
    while out.any():
        y[out] = enc(y[out])
        out = y >= np.uint32(num_users)
    return y.astype(np.int32)


def prp_round_users(rk, num_users: int, num_active: int, avail=None,
                    overdraw: int = AVAIL_OVERDRAW) -> np.ndarray:
    """One round's cohort under the PRP sampler (ref fed/sampling.py:
    240-289): the image of ``[0, num_active)``.

    ``avail``: the round's ``[num_users]`` 0/1 availability row.  The walk
    visits the first ``min(num_users, overdraw * num_active)`` PRP
    candidates in permutation order, keeps the available ones in that
    order, and leaves the slots it could not fill at ``-1`` (padding); an
    all-ones row selects the uniform cohort."""
    if avail is None:
        return prp_map(rk, np.arange(num_active, dtype=np.int32), num_users)
    budget = min(num_users, max(1, overdraw) * num_active)
    cand = prp_map(rk, np.arange(budget, dtype=np.int32), num_users)
    kept = cand[np.asarray(avail, np.float32)[cand] > 0][:num_active]
    out = np.full(num_active, -1, np.int32)
    out[:kept.size] = kept
    return out
