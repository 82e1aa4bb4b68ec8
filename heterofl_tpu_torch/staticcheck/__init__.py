"""The port's static and runtime checks: an AST lint and a runtime audit of
the round programs on one device.

Port of ``heterofl_tpu/staticcheck/``.  Three fronts, one gate:

* :mod:`.rules` -- the path-scoped banned-call lint over the package source
  (host synchronisation and device reads on the round path, wall clocks
  and unseeded generators where steps are built, a library call standing
  in for a hand-written kernel), each legitimate use licensed by a
  ``# staticcheck: allow(<rule>)`` pragma with its reason.  Pure AST,
  torch-free.
* :mod:`.audit` -- builds the round programs (masked and grouped engines
  at K=1 and in the superstep, dense, int8 and the per-level codec map,
  telemetry, both samplers, vision and the LM) and runs them on the CPU or
  the card, holding each to: no float64 and one ``host_fetch`` a
  superstep; its launches a replayed step against the committed budget;
  no recapture on a fresh but identical dispatch; its levels' FLOP shares
  against :func:`~..fed.core.level_flop_shares`; the bytes its round
  reduces equal to :func:`~..fed.core.level_codec_byte_table` (:mod:`.wire`);
  its memory under an analytic ceiling (:mod:`.memory`).
* :mod:`.ratchet` -- every audited metric diffed against the committed
  ``baseline.json`` of this package, one section a device.

CLI: ``python -m heterofl_tpu_torch.staticcheck`` (:mod:`.__main__`).
This module and the lint import no torch themselves: the lint runs
without a device.
"""

from .report import AuditReport, Finding, ProgramReport  # noqa: F401
from .rules import DEFAULT_RULES, lint_paths, lint_tree  # noqa: F401

__all__ = ["AuditReport", "Finding", "ProgramReport", "DEFAULT_RULES", "lint_paths",
           "lint_tree", "run_audit"]


def run_audit(*args, **kwargs):
    """:func:`.audit.run_audit`, imported on first use (it imports torch)."""
    from .audit import run_audit as _run

    return _run(*args, **kwargs)
