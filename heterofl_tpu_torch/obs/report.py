"""The population report.

Port of ``heterofl_tpu/obs/report.py`` (its own copy, the same JSON):
``python -m heterofl_tpu_torch.obs.report <run-dir-or-ledger.npz> [--json]``
renders a snapshot from what a ledger run leaves behind:

* ``ledger.npz`` (:class:`~.ledger.ClientLedger`): participation coverage
  and Gini, current-staleness quantiles and mass by availability class
  (participation-count quartiles of the seen population), per-level
  loss-EMA quantiles;
* ``events.jsonl`` beside it (optional, the run trace): event counts by
  name and the watchdog trips, so an aborted run's report leads with the
  evidence.

``--json`` prints the machine-readable snapshot instead of the table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from .ledger import ClientLedger


def find_ledger(path: str) -> str:
    """Resolve a run directory (searched recursively for the newest
    ``ledger.npz``) or a direct ``.npz`` path."""
    if os.path.isfile(path):
        return path
    hits = []
    for root, _dirs, files in os.walk(path):
        if "ledger.npz" in files:
            p = os.path.join(root, "ledger.npz")
            hits.append((os.path.getmtime(p), p))
    if not hits:
        raise FileNotFoundError(f"no ledger.npz under {path!r}: run with "
                                f"cfg['ledger']='on' (or point at the file)")
    return max(hits)[1]


def summarize_events(events_path: str) -> Dict[str, Any]:
    """Count events.jsonl records by name; surface the watchdog trips."""
    counts: Dict[str, int] = {}
    watchdog: List[Dict[str, Any]] = []
    with open(events_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            name = rec.get("name", "?")
            counts[name] = counts.get(name, 0) + 1
            if name == "watchdog":
                watchdog.append(rec.get("args", {}))
    return {"path": events_path, "events_by_name": counts,
            "watchdog_trips": watchdog[:16]}


def build_report(ledger_path: str,
                 events_path: Optional[str] = None) -> Dict[str, Any]:
    led = ClientLedger.load(ledger_path)
    rep = {"ledger": ledger_path, **led.snapshot()}
    if events_path is None:
        cand = os.path.join(os.path.dirname(ledger_path), "events.jsonl")
        events_path = cand if os.path.exists(cand) else None
    if events_path is not None:
        rep["events"] = summarize_events(events_path)
    return rep


def _fmt_q(q: Dict[str, float]) -> str:
    return "  ".join(f"{k}={v:g}" for k, v in q.items())


def render_text(rep: Dict[str, Any]) -> str:
    """The human-readable table."""
    p = rep["participation"]
    s = rep["staleness"]
    lines = [
        f"population observatory -- {rep['ledger']}",
        f"  users {rep['num_users']}  levels {rep['levels']}  "
        f"round {rep['round']}  updates {rep['updates']}  "
        f"resident {rep['bytes']} B ({rep['bytes_per_user']} B/user)",
        "participation",
        f"  coverage {p['coverage']:.4f}  gini {p['gini']:.4f}  "
        f"total {p['total']}  max {p['count_max']}  "
        f"{_fmt_q(p['count_quantiles'])}",
        "staleness (rounds since last seen)",
        f"  {_fmt_q(s['now_quantiles'])}  cumulative "
        f"{s['cumulative_total']}",
    ]
    for c in s["by_class"]:
        extra = "" if c.get("stale_mean") is None \
            else f"  mean {c['stale_mean']:g}"
        lines.append(f"    class {c['class']:<10} users {c['users']:<8} "
                     f"stale mass {c['stale_mass']:g}{extra}")
    lines.append("per-level loss EMA")
    for lv in rep["per_level"]:
        q = ("(no observations)" if lv["loss_ema_quantiles"] is None
             else _fmt_q(lv["loss_ema_quantiles"]))
        lines.append(f"    level {lv['level']:<8g} users {lv['users_last']:<8}"
                     f" participations {lv['participations']:<8} {q}")
    ev = rep.get("events")
    if ev:
        lines.append(f"events -- {ev['path']}")
        lines.append("  " + "  ".join(f"{k}:{v}" for k, v in
                                      sorted(ev["events_by_name"].items())))
        if ev["watchdog_trips"]:
            lines.append(f"  WATCHDOG TRIPPED {len(ev['watchdog_trips'])}x: "
                         f"{ev['watchdog_trips'][0]}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m heterofl_tpu_torch.obs.report",
        description="Render a population snapshot from ledger.npz "
                    "(+ events.jsonl)")
    ap.add_argument("path", help="run/trace directory or a ledger.npz path")
    ap.add_argument("--events", default=None,
                    help="events.jsonl path (default: next to the ledger)")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable snapshot")
    args = ap.parse_args(argv)
    rep = build_report(find_ledger(args.path), events_path=args.events)
    if args.json:
        print(json.dumps(rep))
    else:
        print(render_text(rep))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via main() tests
    sys.exit(main())
