"""Experiment arms: E sweep arms of one run in one superstep.

Port of ``heterofl_tpu/multi/__init__.py`` (its own copy, numpy-free, the
reference's messages).  An arm may vary what enters the superstep as data:

* its **seed stream** -- arm ``e`` with seed ``s`` owns the stream rooted
  at ``fed.core.arm_stream_seed(seed, s)``, from which its cohorts (under
  ``prp``), dynamic rates, clients' generators, deadline budgets and
  failures are drawn; ``None`` is the identity arm, which consumes the
  run's own stream, so ``arms=1`` equals the unbatched run bit for bit;
* its **learning rate** -- a multiplicative scale over the shared schedule
  (``lr_scales``), or under ReduceLROnPlateau its own plateau state.

Everything that shapes the program -- engine, codec, schedule kind, K,
the model -- is the launch's: a sweep over such a knob is a separate
launch (:mod:`.sweep`).  The engines train the arms one after another
inside one superstep (``parallel/round_engine.py``,
``parallel/grouped.py``), their metrics in one fetch;
``entry.common.ArmsExperiment`` is their experiment loop.  Combinations that do not
batch are refused by :func:`resolve_arms_cfg`, the one validator of
``cfg['arms']``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

#: hard ceiling on arms per program: the arms axis multiplies program
#: FLOPs, wire bytes and the params/metrics footprint linearly, and a
#: fatter batch than this is better served by a second structural launch
MAX_ARMS = 64


class ArmsSpec:
    """Resolved arms configuration (one immutable object, the
    ScheduleSpec convention).

    ``count``: E >= 1.  ``seeds``: per-arm stream seeds -- ints folded
    into the superstep base key, or ``None`` for the identity arm that
    consumes the base stream itself (the ``arms=1`` default, which is
    what the E=1 == unbatched bitwise contract rides on).  ``lr_scales``:
    per-arm multiplicative factors over the shared LR schedule."""

    def __init__(self, count: int, seeds: Tuple[Optional[int], ...],
                 lr_scales: Tuple[float, ...]):
        self.count = int(count)
        self.seeds = tuple(seeds)
        self.lr_scales = tuple(float(s) for s in lr_scales)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"ArmsSpec(count={self.count}, seeds={self.seeds}, "
                f"lr_scales={self.lr_scales})")

    def __eq__(self, other):
        return (isinstance(other, ArmsSpec) and self.count == other.count
                and self.seeds == other.seeds
                and self.lr_scales == other.lr_scales)

    def __hash__(self):
        return hash((self.count, self.seeds, self.lr_scales))

    def solo(self, i: int) -> "ArmsSpec":
        """The single-arm spec of arm ``i``: the solo run the arm-vs-solo
        equivalence contract compares against."""
        return ArmsSpec(1, (self.seeds[i],), (self.lr_scales[i],))


def default_seeds(count: int) -> Tuple[Optional[int], ...]:
    """Default per-arm stream seeds: arm 0 is the identity arm (the base
    stream, ``None``), arms 1..E-1 fold in their index."""
    return (None,) + tuple(range(1, count))


def resolve_arms_cfg(cfg: Dict[str, Any]) -> Optional[ArmsSpec]:
    """Validate ``cfg['arms']`` and return the :class:`ArmsSpec` (or
    ``None`` when arms are off; ref multi/__init__.py:103-227, its
    messages): malformed counts, seed or scale vectors fail at config
    time, never as a silent single-arm fallback mid-run.  Accepted forms::

        "arms": None          # off (default)
        "arms": 4             # E=4, default seeds (None,1,2,3), unit scales
        "arms": {"count": 4,
                 "seeds": [None, 7, 11, 13],     # optional
                 "lr_scales": [1.0, 0.3, 3.0, 1.0]}  # optional

    Cross-field conflicts (strategy, ledger, trace, schedule, store, and
    under ``grouped`` codec, probes, gate and placement) refuse here too;
    the engines apply this validator again when constructed directly."""
    raw = cfg.get("arms")
    if raw is None:
        return None
    if isinstance(raw, bool):
        raise ValueError(f"Not valid arms: {raw!r} (an int count, a dict, "
                         f"or None)")
    if isinstance(raw, int):
        raw = {"count": raw}
    if not isinstance(raw, dict):
        raise ValueError(f"Not valid arms: {raw!r} (an int count, a dict "
                         f"with count/seeds/lr_scales, or None)")
    unknown = set(raw) - {"count", "seeds", "lr_scales"}
    if unknown:
        raise ValueError(f"Not valid arms keys: {sorted(unknown)} "
                         f"(count/seeds/lr_scales)")
    count = raw.get("count")
    if not isinstance(count, int) or isinstance(count, bool) or count < 1:
        raise ValueError(f"Not valid arms count: {count!r} (an int >= 1)")
    if count > MAX_ARMS:
        raise ValueError(f"Not valid arms count: {count} exceeds MAX_ARMS="
                         f"{MAX_ARMS}; split the sweep into several "
                         f"structural launches (multi.sweep does)")
    seeds = raw.get("seeds")
    if seeds is None:
        seeds = default_seeds(count)
    else:
        seeds = tuple(seeds)
        if len(seeds) != count:
            raise ValueError(f"Not valid arms seeds: {len(seeds)} entries "
                             f"for count={count} (one per arm)")
        for s in seeds:
            if s is not None and (not isinstance(s, int)
                                  or isinstance(s, bool) or s < 0):
                raise ValueError(f"Not valid arm seed: {s!r} (a "
                                 f"non-negative int, or None for the "
                                 f"identity arm)")
    scales = raw.get("lr_scales")
    if scales is None:
        scales = (1.0,) * count
    else:
        scales = tuple(scales)
        if len(scales) != count:
            raise ValueError(f"Not valid arms lr_scales: {len(scales)} "
                             f"entries for count={count} (one per arm)")
        for s in scales:
            if not isinstance(s, (int, float)) or isinstance(s, bool) \
                    or not s > 0.0:
                raise ValueError(f"Not valid arm lr_scale: {s!r} (a "
                                 f"positive number)")
    # arms x everything cross-checks, each message the reference's
    strategy = cfg.get("strategy", "masked") or "masked"
    if strategy == "sliced":
        raise ValueError(
            "Not valid arms with strategy='sliced': the sliced debug twin "
            "replays the reference host loop one trajectory at a time -- "
            "use a mesh-native strategy ('masked' or 'grouped')")
    if (cfg.get("ledger", "off") or "off") == "on":
        raise ValueError(
            "Not valid arms with ledger='on': the O(active) fold consumes "
            "ONE sampling stream's cohort rows, and each arm draws its own "
            "(a ROADMAP follow-on)")
    if cfg.get("trace_dir"):
        raise ValueError(
            "Not valid arms with trace_dir: the multiplexed loop does not "
            "build the TraceRecorder, so the trace would be silently empty "
            "(a ROADMAP follow-on; per-arm probes/watchdog DO run)")
    if ((cfg.get("schedule") or {}).get("aggregation") or "sync") \
            == "buffered":
        raise ValueError(
            "Not valid arms with schedule aggregation='buffered': the "
            "staleness buffer is a replicated carry with its own "
            "donation/checkpoint contract -- batch dense-sync arms or run "
            "buffered solo")
    if (cfg.get("client_store", "eager") or "eager") == "stream":
        raise ValueError(
            "Not valid arms with client_store='stream': the streaming "
            "cohort pipeline stages ONE schedule's shards per superstep "
            "(a ROADMAP follow-on)")
    if strategy == "grouped":
        codec = cfg.get("wire_codec", "dense") or "dense"
        if isinstance(codec, dict) and all(v == "dense"
                                           for v in codec.values()):
            codec = "dense"
        if codec != "dense":
            raise ValueError(
                f"Not valid arms with wire_codec={codec!r} under strategy="
                f"'grouped': the grouped EF-residual carry does not batch "
                f"over the arms axis yet (a ROADMAP follow-on) -- grouped "
                f"arms need the dense wire codec, or use the masked engine "
                f"for codec arms")
        if (cfg.get("telemetry", "off") or "off") != "off":
            raise ValueError(
                "Not valid arms with telemetry on under strategy="
                "'grouped': the span probe rows do not carry the arms "
                "axis yet (a ROADMAP follow-on); the masked engine "
                "supports telemetry x arms")
        if (cfg.get("quarantine", "off") or "off") != "off":
            raise ValueError(
                "Not valid arms with quarantine on under strategy="
                "'grouped': the quarantine counter rides the probe rows, "
                "which do not carry the arms axis yet (a ROADMAP "
                "follow-on); the masked engine supports quarantine x arms")
        if (cfg.get("level_placement", "span") or "span") == "slices":
            raise ValueError(
                "Not valid arms with level_placement='slices': the slices "
                "layout dispatches each level to its own device rows, and "
                "the arms axis would have to batch across disjoint "
                "sub-meshes (a ROADMAP follow-on) -- arms need "
                "level_placement='span'")
    return ArmsSpec(count, seeds, scales)
