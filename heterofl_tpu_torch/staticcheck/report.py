"""Finding and report containers of the lint and the audit (ref
staticcheck/report.py).  Torch-free, so the lint and the CLI's report
plumbing run without a device."""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Finding:
    """One violation.  ``where`` is ``path:line`` for a lint finding and the
    program's name for an audit finding."""

    rule: str
    where: str
    message: str

    def __str__(self) -> str:  # `path:line: [rule] message`
        return f"{self.where}: [{self.rule}] {self.message}"


@dataclass
class ProgramReport:
    """The audit of one round program (an engine, a configuration, K)."""

    name: str
    ok: bool = True
    findings: List[Finding] = field(default_factory=list)
    #: launches of one replayed step, by step key: on the CPU the step's
    #: aten operator calls, on the card the kernel nodes of its capture
    launches: Dict[str, int] = field(default_factory=dict)
    #: captured steps the engine holds after the first and the second
    #: dispatch, and the captures (card) each dispatch made
    graphs: Optional[int] = None
    captures: Optional[int] = None
    recompile: Optional[Dict[str, Any]] = None
    #: host_fetch calls of one superstep (None for a K=1 round)
    host_fetches: Optional[int] = None
    #: the bytes the round reduces, by level (``wire.py``)
    wire: Optional[Dict[str, Any]] = None
    #: device memory: peak allocated and graph pool MB (card), and the
    #: analytic ceiling they are held to (``memory.py``)
    memory: Optional[Dict[str, Any]] = None
    #: the clients mesh axis's collectives a dispatch (``parallel/mesh.py``'s
    #: counters): all-reduces a round, gathers, the payload's ring bytes
    collectives: Optional[Dict[str, Any]] = None

    def fail(self, rule: str, message: str) -> None:
        self.ok = False
        self.findings.append(Finding(rule, self.name, message))


@dataclass
class AuditReport:
    """The whole run: lint findings, per-program audits and the cross-program
    checks (the FLOP budget, the wire frontier), serialisable to JSON."""

    ok: bool = True
    config: Dict[str, Any] = field(default_factory=dict)
    programs: Dict[str, ProgramReport] = field(default_factory=dict)
    flop_budget: Dict[str, Any] = field(default_factory=dict)
    wire_frontier: Dict[str, Any] = field(default_factory=dict)
    lint: List[Finding] = field(default_factory=list)
    #: the baseline diff (``ratchet.py``); ``checked`` is False unless the
    #: CLI ran ``--diff-baseline``.  A regression keeps ``ok`` (the audit is
    #: green) and makes the CLI exit 2.
    ratchet: Dict[str, Any] = field(default_factory=lambda: {"checked": False})
    generated_at: Optional[str] = None

    def add_program(self, prog: ProgramReport) -> None:
        self.programs[prog.name] = prog
        self.ok = self.ok and prog.ok

    def add_lint(self, findings: List[Finding]) -> None:
        self.lint.extend(findings)
        self.ok = self.ok and not findings

    def fail(self, section: Dict[str, Any], rule: str, message: str) -> None:
        """Record a cross-program failure in ``section`` and flip the report."""
        self.ok = False
        section.setdefault("findings", []).append(asdict(Finding(rule, "audit", message)))
        section["ok"] = False

    def all_findings(self) -> List[Finding]:
        out = list(self.lint)
        for p in self.programs.values():
            out.extend(p.findings)
        for sec in (self.flop_budget, self.wire_frontier):
            out.extend(Finding(**f) for f in sec.get("findings", []))
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"version": 1, "ok": self.ok, "generated_at": self.generated_at,
                "config": self.config,
                "programs": {k: asdict(v) for k, v in self.programs.items()},
                "flop_budget": self.flop_budget, "wire_frontier": self.wire_frontier,
                "ratchet": self.ratchet, "lint": [asdict(f) for f in self.lint]}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)
