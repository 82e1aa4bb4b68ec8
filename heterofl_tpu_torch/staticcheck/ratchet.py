"""The baseline ratchet (ref staticcheck/ratchet.py): every audited metric
diffed against the committed ``baseline.json`` beside this module.

The analytic budgets of :mod:`.wire` and :mod:`.memory` are ceilings; the
ratchet is the tight line.  ``baseline.json`` holds one section a device:
``cpu`` (the test-width audit, checked by the tests) and ``cuda`` (the
headline-width audit, written from a run on the card and checked by
``chip_smoke.py``).  It is the port's own file; the JAX package's
``STATICCHECK_BASELINE.json`` is a different audit and never mixed in.
``python -m heterofl_tpu_torch.staticcheck --diff-baseline`` exits 2 on a
regression; ``--update-baseline`` re-pins the device's section.

Torch-free: the diff works on report dicts.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")

#: per-program metrics: (label, path into the serialised ProgramReport,
#: relative headroom).  Growth past the headroom regresses, shrinkage is an
#: improvement.  ``launches`` is a dict of step keys, each diffed alone.
PROGRAM_METRICS: Tuple[Tuple[str, Tuple[str, ...], float], ...] = (
    ("launches", ("launches",), 0.15),
    ("wire_bytes", ("wire", "level_bytes"), 0.0),
    ("graphs", ("graphs",), 0.0),
    ("captures", ("captures",), 0.0),
    ("host_fetches", ("host_fetches",), 0.0),
    ("peak_mb", ("memory", "peak_mb"), 0.25),
    ("pool_mb", ("memory", "pool_mb"), 0.25),
)
#: the FLOP budget's measured FLOPs a level
FLOP_HEADROOM = 0.10

#: audit-config keys that must match for a diff to mean anything
CONFIG_KEYS = ("flagship", "data_name", "model_name", "num_users", "levels", "device")


def _get(d: Optional[Dict[str, Any]], path: Sequence[str]):
    for k in path:
        if not isinstance(d, dict) or k not in d:
            return None
        d = d[k]
    return d


def baseline_view(report_dict: Dict[str, Any]) -> Dict[str, Any]:
    """The committed shape of one device's section: the config subset, the
    per-program metrics, the levels' FLOPs."""
    programs = {name: {label: _get(prog, path) for label, path, _tol in PROGRAM_METRICS}
                for name, prog in sorted((report_dict.get("programs") or {}).items())}
    return {"generated_at": report_dict.get("generated_at"),
            "config": {k: (report_dict.get("config") or {}).get(k) for k in CONFIG_KEYS},
            "programs": programs,
            "flops": dict((report_dict.get("flop_budget") or {}).get("measured_flops") or {})}


def diff_reports(current_dict: Dict[str, Any], baseline: Dict[str, Any]) -> Dict[str, Any]:
    """Diff a fresh report against one device's baseline section -> the
    ``ratchet`` section: ``ok`` False on a metric past its headroom, a
    metric gone dark, a program missing, or another audit config."""
    out: Dict[str, Any] = {"checked": True, "ok": True,
                           "baseline_generated_at": baseline.get("generated_at"),
                           "regressions": [], "improvements": [], "new_programs": [],
                           "missing_programs": []}

    def regress(program, metric, base, cur, tol, msg):
        out["ok"] = False
        out["regressions"].append({"program": program, "metric": metric, "baseline": base,
                                   "current": cur, "tolerance": tol, "message": msg})

    def compare(program, metric, base, cur, tol):
        if base is None:
            return
        if cur is None:
            regress(program, metric, base, None, tol, "recorded in the baseline, absent "
                    "from the fresh audit (the measurement went dark)")
        elif cur > base * (1.0 + tol):
            regress(program, metric, base, cur, tol,
                    f"grew past the baseline by more than {tol:.0%}" if tol
                    else "grew past the exact baseline")
        elif cur < base:
            out["improvements"].append({"program": program, "metric": metric,
                                        "baseline": base, "current": cur})

    cur = baseline_view(current_dict)
    if cur["config"] != (baseline.get("config") or {}):
        regress("<config>", "config", baseline.get("config"), cur["config"], 0.0,
                "the audit config differs from the baseline's; re-pin with "
                "--update-baseline if the change is intentional")
        return out
    base_progs, cur_progs = baseline.get("programs") or {}, cur["programs"]
    for name in sorted(set(base_progs) - set(cur_progs)):
        out["missing_programs"].append(name)
        regress(name, "<program>", "audited", "absent", 0.0,
                "a program of the baseline is missing from the fresh audit")
    out["new_programs"] = sorted(set(cur_progs) - set(base_progs))
    for name in sorted(set(base_progs) & set(cur_progs)):
        for label, _path, tol in PROGRAM_METRICS:
            base, now = base_progs[name].get(label), cur_progs[name].get(label)
            if isinstance(base, dict):
                for key in sorted(base):
                    compare(name, f"{label}[{key}]", base[key], (now or {}).get(key), tol)
            else:
                compare(name, label, base, now, tol)
    for level, base in sorted((baseline.get("flops") or {}).items()):
        compare("<flop_budget>", f"flops[{level}]", base, cur["flops"].get(level),
                FLOP_HEADROOM)
    return out


def load_baseline(path: str = BASELINE_PATH, device: Optional[str] = None) -> Dict[str, Any]:
    """The baseline file, or its ``device`` section."""
    with open(path) as f:
        data = json.load(f)
    if device is None:
        return data
    section = data.get(device)
    if not section:
        raise ValueError(f"{path} has no {device!r} section: run --update-baseline on that "
                         f"device and commit the file")
    return section


def write_baseline(report_dict: Dict[str, Any], device: str, path: str = BASELINE_PATH
                   ) -> None:
    """Re-pin ``device``'s section from a green report, keeping the others."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    data[device] = baseline_view(report_dict)
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
