"""Run tracing: one Chrome-trace and events-JSONL recorder per run.

Port of ``heterofl_tpu/obs/trace.py`` (its own copy, same schema):
:class:`TraceRecorder` puts the experiment loop's ``PhaseTimer`` phases
(``parallel/staging.py``), its events (superstep and round boundaries,
evaluations, checkpoints, prefetches, probes, watchdog trips, recoveries)
and its spans on one timeline:

* every ``PhaseTimer`` phase becomes a complete ("X") event (the timer
  calls :meth:`TraceRecorder.complete` when a recorder is attached to its
  ``trace``);
* :meth:`TraceRecorder.span` also enters ``torch.profiler.record_function``,
  so a device profile taken at the same time (``cfg['profile_dir']``)
  carries the same labels;
* ``close()`` writes ``trace.json`` in the Chrome trace-event format (open
  it in Perfetto or ``chrome://tracing``), and every event also streams to
  ``events.jsonl`` as it happens -- one JSON object a line
  (:data:`EVENT_FIELDS`, checked by :func:`validate_event`), so a killed
  run still leaves its timeline on disk.

Host-side only: recording never touches the device.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

#: events.jsonl schema, version 1: required fields -> type.  ``dur_s`` is
#: present exactly on complete ("X") events; ``args`` is a flat JSON
#: object of event-specific facts.
EVENT_VERSION = 1
EVENT_FIELDS = {"v": int, "t": float, "name": str, "cat": str, "ph": str,
                "args": dict}
EVENT_PHASES = ("i", "X")


def validate_event(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Validate one events.jsonl record against the schema; returns the
    record (so loaders can ``[validate_event(json.loads(l)) ...]``) or
    raises ``ValueError`` naming the violation."""
    if not isinstance(rec, dict):
        raise ValueError(f"event record must be an object, got {type(rec)}")
    for field, typ in EVENT_FIELDS.items():
        if field not in rec:
            raise ValueError(f"event record misses required field {field!r}: "
                             f"{rec}")
        if typ is float:
            if not isinstance(rec[field], (int, float)) \
                    or isinstance(rec[field], bool):
                raise ValueError(f"event field {field!r} must be a number, "
                                 f"got {rec[field]!r}")
        elif not isinstance(rec[field], typ):
            raise ValueError(f"event field {field!r} must be {typ.__name__}, "
                             f"got {rec[field]!r}")
    if rec["v"] != EVENT_VERSION:
        raise ValueError(f"event version {rec['v']} != {EVENT_VERSION}")
    if rec["ph"] not in EVENT_PHASES:
        raise ValueError(f"event ph {rec['ph']!r} not in {EVENT_PHASES}")
    if rec["ph"] == "X":
        dur = rec.get("dur_s")
        if not isinstance(dur, (int, float)) or isinstance(dur, bool):
            raise ValueError(f"complete event needs a numeric dur_s: {rec}")
    extra = set(rec) - set(EVENT_FIELDS) - {"dur_s"}
    if extra:
        raise ValueError(f"unknown event fields {sorted(extra)}: {rec}")
    return rec


def _annotation(name: str):
    """A ``torch.profiler.record_function`` range named ``name``: a device
    profile taken meanwhile shows the span's label over its kernels."""
    from torch.profiler import record_function

    return record_function(name)


class TraceRecorder:
    """One run's trace: collects events in memory for ``trace.json`` and
    streams them to ``events.jsonl`` as they happen.

    Timestamps: the Chrome ``ts``/``dur`` fields are microseconds on the
    ``time.perf_counter`` clock relative to recorder construction (the
    same clock ``PhaseTimer`` uses, so attached phases line up exactly);
    the JSONL ``t`` field is absolute wall-clock seconds for cross-run
    correlation."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.trace_path = os.path.join(out_dir, "trace.json")
        self.events_path = os.path.join(out_dir, "events.jsonl")
        self._events = []
        self._jsonl = open(self.events_path, "w")
        self._t0 = time.perf_counter()
        self._t0_wall = time.time()
        self.closed = False

    # -- recording -----------------------------------------------------

    def _push(self, name: str, cat: str, ph: str, t_perf: float,
              dur: Optional[float], args: Optional[Dict[str, Any]]) -> None:
        if self.closed:
            return
        args = dict(args or {})
        ev = {"name": name, "cat": cat, "ph": ph, "pid": 0, "tid": 0,
              "ts": round((t_perf - self._t0) * 1e6, 1), "args": args}
        if ph == "X":
            ev["dur"] = round((dur or 0.0) * 1e6, 1)
        self._events.append(ev)
        rec = {"v": EVENT_VERSION,
               "t": self._t0_wall + (t_perf - self._t0),
               "name": name, "cat": cat, "ph": ph, "args": args}
        if ph == "X":
            rec["dur_s"] = round(dur or 0.0, 6)
        self._jsonl.write(json.dumps(validate_event(rec)) + "\n")
        self._jsonl.flush()

    def instant(self, name: str, cat: str = "driver",
                args: Optional[Dict[str, Any]] = None) -> None:
        """A point event (watchdog trips, probe snapshots, run markers)."""
        self._push(name, cat, "i", time.perf_counter(), None, args)

    def complete(self, name: str, t0: float, dur: float, cat: str = "phase",
                 args: Optional[Dict[str, Any]] = None) -> None:
        """A finished interval with an explicit ``perf_counter`` start --
        the ``PhaseTimer`` hook (the timer already measured the phase, the
        recorder just files it)."""
        self._push(name, cat, "X", t0, dur, args)

    @contextmanager
    def span(self, name: str, cat: str = "driver",
             args: Optional[Dict[str, Any]] = None):
        """Record an interval around a block AND enter the matching
        ``torch.profiler.record_function`` so a device profile taken in
        parallel carries the same label."""
        t0 = time.perf_counter()
        try:
            with _annotation(name):
                yield
        finally:
            self.complete(name, t0, time.perf_counter() - t0, cat=cat,
                          args=args)

    # -- finish --------------------------------------------------------

    def sync(self) -> str:
        """Flush + fsync the artifacts WITHOUT closing the recorder: the
        rollback path's twin of :meth:`close` (the abort path closes, but a
        rollback continues the run, and each recovery attempt must still
        leave the trip evidence on disk: events.jsonl fsync'd with the trip
        instant as its last line, trace.json a point-in-time snapshot).  Returns the trace
        path; no-op after close."""
        if self.closed:
            return self.trace_path
        self._jsonl.flush()
        os.fsync(self._jsonl.fileno())
        with open(self.trace_path, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ms",
                       "metadata": {"clock": "perf_counter",
                                    "t0_wall": self._t0_wall}}, f)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        return self.trace_path

    def close(self) -> str:
        """Write ``trace.json`` and close the JSONL stream; returns the
        trace path.  Idempotent (a ``finally`` block and an explicit
        close may both run).

        Durability: both artifacts are fsync'd -- close() runs on the abort
        path BEFORE a ``WatchdogError``
        propagates, and the buffered tail it would otherwise lose IS the
        abort evidence (the watchdog instant must be the last event on
        disk after a crash)."""
        if self.closed:
            return self.trace_path
        self.closed = True
        self._jsonl.flush()
        os.fsync(self._jsonl.fileno())
        self._jsonl.close()
        with open(self.trace_path, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ms",
                       "metadata": {"clock": "perf_counter",
                                    "t0_wall": self._t0_wall}}, f)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        return self.trace_path
