"""Deadline stragglers: per-client local-step budgets.

Port of ``heterofl_tpu/sched/deadline.py``.  Each active client of a round
gets a budget of local steps; its steps past the budget change nothing,
neither its params nor its metric sums, so a slow client contributes the
steps it finished.  The budget is ``ceil((min_frac + (1 - min_frac) *
speed) * total)``, computed in float32 as the reference computes it
(:func:`budgets_from_speeds`), so it lies in ``[ceil(min_frac * total),
total]`` and every participant finishes at least one step.

The speed is a uniform draw keyed by (round seed, user id)
(:func:`deadline_speeds`): the port's own stream, the same for the masked
and the grouped engine.  The reference draws it from ``jax.random``,
which torch does not reproduce, so a test feeds the reference's speeds
into :func:`budgets_from_speeds` instead.  ``total`` is the local steps of
the stacked, padded shard (``E * ceil(N / B)``; an LM ``E * ceil(T /
bptt)``), the same for every client of the round.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

#: salt of the deadline stream (the reference's ``DEADLINE_SALT``)
DEADLINE_SALT = 131


def deadline_speeds(round_seed: int, uids: Sequence[int]) -> np.ndarray:
    """float32 ``[slots]`` speeds in ``[0, 1)``, one a slot, each from
    (round seed, user id); a padding slot (``-1``) draws user 0's, as the
    reference's ``max(uid, 0)`` does."""
    out = [np.random.SeedSequence([int(round_seed), DEADLINE_SALT, max(int(u), 0)])
           .generate_state(1, np.uint32)[0] >> np.uint32(8) for u in np.reshape(uids, -1)]
    return np.asarray(out, np.float32) * np.float32(2.0 ** -24)


def budgets_from_speeds(speeds, total_steps: int, min_frac: float) -> np.ndarray:
    """int64 budgets ``ceil((min_frac + (1 - min_frac) * speed) * total)``
    in float32, in the reference's order of operations
    (heterofl_tpu/sched/deadline.py:45-47)."""
    speed = np.asarray(speeds, np.float32)
    frac = np.float32(min_frac) + np.float32(1.0 - min_frac) * speed
    return np.ceil(frac * np.float32(total_steps)).astype(np.int64)


def deadline_steps(round_seed: int, uids: Sequence[int], total_steps: int,
                   min_frac: float) -> np.ndarray:
    """The round's local-step budgets, int64 ``[slots]`` in
    ``[ceil(min_frac * total), total]``."""
    return budgets_from_speeds(deadline_speeds(round_seed, uids), total_steps, min_frac)
