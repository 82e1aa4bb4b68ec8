"""Observability and its guards: health probes, cohort histograms, run
tracing, the watchdog, client-update quarantine and the client ledger.

Port of ``heterofl_tpu/obs/__init__.py`` (its own copy, numpy only, no
import of the reference): the modes and defaults, :class:`WatchdogSpec`,
:class:`QuarantineSpec`, :class:`TelemetrySpec`, :class:`LedgerSpec`, the
validators :func:`resolve_telemetry_cfg`, :func:`resolve_quarantine_cfg`
and :func:`resolve_ledger_cfg` with every message and cross-check of the
reference, and :func:`split_probes`, which finishes a fetched round's probe
rows into the reference's per-round record (:data:`PROBE_FIELDS`,
:data:`HIST_FIELDS`).

Where the probes come from (the engines, ``parallel/round_engine.py`` and
``parallel/grouped.py``):

* on the device, after each round's aggregation, as plain PyTorch
  reductions on the compute stream (:mod:`.probes`): the squared norms of
  the update, of the counted-average client delta, of the error-feedback
  residual and of the staleness carry, the non-finite leaf count, and under
  ``telemetry='hist'`` the staleness carry's magnitude histogram; with
  ``quarantine`` the per-slot gate row.  They ride the superstep's
  :class:`~..parallel.staging.PendingMetrics` and cross to the host in its
  one fetch;
* on the host, at the fetch, from the per-slot rows the fetch already
  carries (:func:`split_probes`): participation and ``hist_level`` from the
  gated rates, ``hist_loss`` from the loss sums, ``hist_steps`` from the
  step budgets the host planned (:mod:`.hist`).  The reference sums these
  as per-device partials; one GPU holds every slot, so the host finishes
  them exactly, under the same bucket rule, at no cost to the device.

``telemetry='off'`` with ``quarantine='off'`` adds no tensor, no launch and
no fetched byte to a round.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

#: cfg['telemetry'] values: 'off' (default) leaves every round as it was;
#: 'on' adds the health probes; 'hist' also the cohort histograms (.hist)
TELEMETRY_MODES = ("off", "on", "hist")

#: watchdog reactions (cfg['watchdog']['action']): 'warn' (default) emits a
#: loud warning and a structured event, 'abort' raises WatchdogError at the
#: fetch, 'rollback' raises WatchdogRollback -- the experiment loop restores the
#: newest verifying checkpoint generation, salts its round-seed stream and
#: retries, escalating to abort when the budget is spent -- 'off' disables
#: the watchdog while keeping the probes
WATCHDOG_ACTIONS = ("warn", "abort", "rollback", "off")

#: rollback budget defaults (cfg['watchdog']['max_retries'/'backoff']):
#: attempts before escalating to abort, and the base of the exponential
#: backoff in seconds (attempt n sleeps backoff * 2**(n-1))
DEFAULT_MAX_RETRIES = 3
DEFAULT_BACKOFF = 0.5

#: default loss-spike threshold: loss > factor x rolling median trips
DEFAULT_SPIKE_FACTOR = 3.0

#: default rolling-median window (rounds) of the loss-spike detector
DEFAULT_SPIKE_WINDOW = 8

#: key prefix of probe leaves in a round's metrics dict
PROBE_PREFIX = "obs_"

#: the finished per-round probe record's fields (the order is the schema);
#: ``quarantined`` is present exactly when quarantine is on
PROBE_FIELDS = ("update_norm", "grad_norm", "participation", "resid_norm",
                "stale_norm", "nonfinite", "quarantined")

#: the finished cohort-histogram fields of a telemetry='hist' record (each a
#: list of bucket counts; edges in .hist)
HIST_FIELDS = ("hist_loss", "hist_steps", "hist_level", "hist_stale")

#: cfg['ledger'] values: 'on' keeps the host-side ClientLedger (.ledger)
LEDGER_MODES = ("off", "on")


class WatchdogSpec:
    """Resolved watchdog knobs.  ``spike_factor=None`` disables the
    loss-spike detector while keeping the non-finite check;
    ``max_retries``/``backoff`` only matter under ``action='rollback'``."""

    def __init__(self, action: str = "warn",
                 spike_factor: Optional[float] = DEFAULT_SPIKE_FACTOR,
                 window: int = DEFAULT_SPIKE_WINDOW,
                 max_retries: int = DEFAULT_MAX_RETRIES,
                 backoff: float = DEFAULT_BACKOFF):
        self.action = action
        self.spike_factor = spike_factor
        self.window = window
        self.max_retries = max_retries
        self.backoff = backoff


class QuarantineSpec:
    """The resolved client-update quarantine: the engines read
    ``enabled``/``max_norm`` at construction."""

    def __init__(self, enabled: bool = False, max_norm: Optional[float] = None):
        self.enabled = enabled
        self.max_norm = max_norm


def resolve_quarantine_cfg(cfg: Dict[str, Any]) -> QuarantineSpec:
    """Validate ``cfg['quarantine']`` and return the :class:`QuarantineSpec`:
    ``'off'``/None disabled; ``'on'`` the finiteness gate; ``{'max_norm':
    R}`` also quarantines an update whose masked L2 norm exceeds ``R``
    (ref obs/__init__.py:130-168, its messages)."""
    raw = cfg.get("quarantine", "off")
    if raw is None or raw == "off":
        return QuarantineSpec()
    if raw == "on":
        spec = QuarantineSpec(enabled=True)
    elif isinstance(raw, dict):
        unknown = set(raw) - {"max_norm"}
        if unknown:
            raise ValueError(f"Not valid quarantine keys: {sorted(unknown)} "
                             f"(max_norm)")
        mn = raw.get("max_norm")
        if mn is not None and (not isinstance(mn, (int, float))
                               or isinstance(mn, bool) or float(mn) <= 0.0):
            raise ValueError(f"Not valid quarantine max_norm: {mn!r} (a "
                             f"positive update-norm bound, or None for the "
                             f"finiteness-only gate)")
        spec = QuarantineSpec(enabled=True, max_norm=None if mn is None else float(mn))
    else:
        raise ValueError(f"Not valid quarantine: {raw!r} ('off', 'on' or a "
                         f"{{'max_norm': R}} dict)")
    if (cfg.get("strategy", "masked") or "masked") == "sliced":
        raise ValueError(
            "Not valid quarantine with strategy='sliced': the gate lives "
            "in the mesh-native engines' round cores ('masked' or "
            "'grouped'); the sliced debug twin replays the reference "
            "host loop and has no in-program round core to gate")
    return spec


class TelemetrySpec:
    """The resolved telemetry: the engines read ``probes``/``hist``, the
    experiment loop ``watchdog``/``trace_dir``."""

    def __init__(self, probes: bool = False, watchdog: Optional[WatchdogSpec] = None,
                 trace_dir: Optional[str] = None, hist: bool = False):
        self.probes = probes
        self.watchdog = watchdog
        self.trace_dir = trace_dir
        self.hist = hist


class LedgerSpec:
    """The resolved ledger: ``enabled`` turns the experiment loop's per-fetch
    :class:`~.ledger.ClientLedger` fold on."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled


def resolve_ledger_cfg(cfg: Dict[str, Any]) -> LedgerSpec:
    """Validate ``cfg['ledger']`` and return the :class:`LedgerSpec` (ref
    obs/__init__.py:194-220, its messages)."""
    mode = cfg.get("ledger", "off") or "off"
    if mode not in LEDGER_MODES:
        raise ValueError(f"Not valid ledger: {mode!r} "
                         f"(one of {LEDGER_MODES})")
    if mode == "on":
        if (cfg.get("strategy", "masked") or "masked") == "sliced":
            raise ValueError(
                "Not valid ledger='on' with strategy='sliced': the sliced "
                "debug twin replays the reference host loop, whose metrics "
                "never ride the fetch path the ledger folds from -- use a "
                "mesh-native strategy ('masked' or 'grouped')")
        if cfg.get("data_placement") == "sharded":
            raise ValueError(
                "Not valid ledger='on' with data_placement='sharded': the "
                "sharded slot packing re-orders metric rows by owning "
                "device, dropping the schedule-order uid alignment the "
                "O(active) fold consumes -- use replicated (or streaming) "
                "placement")
    return LedgerSpec(enabled=mode == "on")


def resolve_telemetry_cfg(cfg: Dict[str, Any]) -> TelemetrySpec:
    """Validate ``cfg['telemetry']`` / ``cfg['watchdog']`` /
    ``cfg['trace_dir']`` and return the :class:`TelemetrySpec` (ref
    obs/__init__.py:223-313, its messages).  ``telemetry='on'`` enables the
    watchdog at warn defaults; ``cfg['watchdog']`` refines it (or turns it
    off with ``{'action': 'off'}``).  ``trace_dir`` is independent of the
    probes.  Refused: a watchdog without telemetry, ``sliced``, and
    ``grouped`` at ``superstep_rounds`` 1 on the eager store."""
    mode = cfg.get("telemetry", "off") or "off"
    if mode not in TELEMETRY_MODES:
        raise ValueError(f"Not valid telemetry: {mode!r} "
                         f"(one of {TELEMETRY_MODES})")
    raw_wd = cfg.get("watchdog")
    if raw_wd is not None and mode == "off":
        raise ValueError("cfg['watchdog'] needs telemetry='on'/'hist': the "
                         "watchdog feeds on the in-program probes (the "
                         "non-finite counter), which telemetry='off' does "
                         "not compute")
    watchdog: Optional[WatchdogSpec] = None
    if mode != "off":
        wd = dict(raw_wd or {})
        unknown = set(wd) - {"action", "spike_factor", "window",
                             "max_retries", "backoff"}
        if unknown:
            raise ValueError(f"Not valid watchdog keys: {sorted(unknown)} "
                             f"(action/spike_factor/window/max_retries/"
                             f"backoff)")
        action = wd.get("action", "warn") or "warn"
        if action not in WATCHDOG_ACTIONS:
            raise ValueError(f"Not valid watchdog action: {action!r} "
                             f"(one of {WATCHDOG_ACTIONS})")
        sf = wd.get("spike_factor", DEFAULT_SPIKE_FACTOR)
        if sf is not None and (not isinstance(sf, (int, float))
                               or isinstance(sf, bool) or float(sf) <= 1.0):
            raise ValueError(f"Not valid watchdog spike_factor: {sf!r} "
                             f"(a factor > 1 over the rolling median loss, "
                             f"or None to disable the spike detector)")
        window = wd.get("window", DEFAULT_SPIKE_WINDOW)
        if not isinstance(window, int) or isinstance(window, bool) or window < 2:
            raise ValueError(f"Not valid watchdog window: {window!r} "
                             f"(an int >= 2, the rolling-median horizon in "
                             f"rounds)")
        retries = wd.get("max_retries", DEFAULT_MAX_RETRIES)
        if not isinstance(retries, int) or isinstance(retries, bool) or retries < 1:
            raise ValueError(f"Not valid watchdog max_retries: {retries!r} "
                             f"(an int >= 1 rollback attempts before "
                             f"escalating to abort)")
        backoff = wd.get("backoff", DEFAULT_BACKOFF)
        if not isinstance(backoff, (int, float)) or isinstance(backoff, bool) \
                or float(backoff) < 0.0:
            raise ValueError(f"Not valid watchdog backoff: {backoff!r} (a "
                             f"non-negative exponential-backoff base in "
                             f"seconds)")
        if action != "off":
            watchdog = WatchdogSpec(action=action,
                                    spike_factor=None if sf is None else float(sf),
                                    window=window, max_retries=retries,
                                    backoff=float(backoff))
    trace_dir = cfg.get("trace_dir")
    if trace_dir is not None and not isinstance(trace_dir, str):
        raise ValueError(f"Not valid trace_dir: {trace_dir!r} (a directory "
                         f"path for trace.json + events.jsonl, or None)")
    if mode != "off":
        strategy = cfg.get("strategy", "masked") or "masked"
        if strategy == "sliced":
            raise ValueError(
                f"Not valid telemetry={mode!r} with strategy='sliced': the "
                f"sliced debug twin replays the reference host loop and "
                f"has no in-program round core to probe -- use a "
                f"mesh-native strategy ('masked' or 'grouped')")
        if strategy == "grouped" \
                and int(cfg.get("superstep_rounds", 1) or 1) <= 1 \
                and (cfg.get("client_store", "eager") or "eager") != "stream":
            raise ValueError(
                f"Not valid telemetry={mode!r} with strategy='grouped' at "
                f"superstep_rounds<=1 and client_store='eager': the K=1 "
                f"path splits the round across L+1 host-orchestrated "
                f"programs with no shared round core to probe -- telemetry "
                f"needs the fused superstep path (superstep_rounds>1) or "
                f"client_store='stream'")
    return TelemetrySpec(probes=mode != "off", watchdog=watchdog,
                         trace_dir=trace_dir, hist=mode == "hist")


def obs_levels(cfg: Dict[str, Any]):
    """The probes' level table: the cfg's distinct rates, descending (the
    order of ``participation`` and ``hist_level``)."""
    return sorted({float(r) for r in cfg["model_rate"]}, reverse=True)


def split_probes(ms: Dict[str, Any], levels: Sequence[float]
                 ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """Pop the ``obs_*`` leaves out of ONE fetched round's metrics dict and
    finish them into the round's probe record -> ``(metrics without
    probes, record or None)``.

    ``ms``: the round's host metrics -- per slot ``loss_sum``,
    ``score_sum``, ``n`` and ``rate`` (the rate each slot trained at, 0 for
    a slot that did not train), and the probe leaves the engine left:
    ``obs_update_sq``, ``obs_grad_sq``, ``obs_resid_sq``, ``obs_stale_sq``,
    ``obs_nonfinite`` (device scalars), ``obs_gate`` (quarantine: 1 where
    the slot's update passed the gate), ``obs_hist_stale`` (the staleness
    carry's bucket counts as ``[high, low]`` rows, ``high * 2**24 + low``)
    and ``obs_steps`` (each slot's executed step fraction, host).

    Finishing rules: a gated slot (``obs_gate`` 0) is a zero-count
    participant -- its metric row and rate read 0 (the reference zeroes
    them on its device, round_engine.py:993-1003) -- and ``quarantined``
    counts the slots that trained and were gated; ``participation`` and
    ``hist_level`` count the gated rates per level; the ``_sq`` leaves take
    the square root."""
    keys = [k for k in ms if k.startswith(PROBE_PREFIX)]
    if not keys:
        return ms, None
    from .hist import round_hists

    clean = {k: np.asarray(v) for k, v in ms.items() if not k.startswith(PROBE_PREFIX)}
    rec: Dict[str, Any] = {}
    rate = clean["rate"].astype(np.float32)
    if "obs_gate" in ms:
        ok = np.asarray(ms["obs_gate"]).reshape(-1) > 0
        rec["quarantined"] = int(((rate > 0) & ~ok).sum())
        for k in ("loss_sum", "score_sum", "n"):
            clean[k] = np.where(ok, clean[k], np.float32(0.0)).astype(clean[k].dtype)
        rate = rate * ok.astype(np.float32)
        clean["rate"] = rate
    if "obs_update_sq" not in ms:
        return clean, rec
    part = [float(np.sum(rate == np.float32(lvl))) for lvl in levels]
    rec["update_norm"] = float(np.sqrt(np.asarray(ms["obs_update_sq"]).reshape(-1)[0]))
    rec["grad_norm"] = float(np.sqrt(np.asarray(ms["obs_grad_sq"]).reshape(-1)[0]))
    rec["participation"] = part
    rec["resid_norm"] = float(np.sqrt(np.asarray(ms["obs_resid_sq"]).reshape(-1)[0]))
    rec["stale_norm"] = float(np.sqrt(np.asarray(ms["obs_stale_sq"]).reshape(-1)[0]))
    rec["nonfinite"] = int(np.asarray(ms["obs_nonfinite"]).reshape(-1)[0])
    if "obs_hist_stale" in ms:
        hists = round_hists(levels, rate, clean["loss_sum"], clean["n"], ms.get("obs_steps"))
        hs = np.asarray(ms["obs_hist_stale"], np.float64).reshape(2, -1)
        for name in ("hist_loss", "hist_steps", "hist_level"):
            rec[name] = [float(c) for c in hists[name]]
        rec["hist_stale"] = [float(c) for c in hs[0] * 2.0 ** 24 + hs[1]]
    return clean, rec
