"""Deferred metric fetch.

Port of the ``PendingMetrics`` / ``MetricsPipeline`` half of
``heterofl_tpu/parallel/staging.py`` (:363-410).  A round or a superstep
leaves its metric sums on the device; :meth:`PendingMetrics.fetch` packs
every leaf into one buffer on the device and copies it to the host once,
so a superstep of k rounds (and its evaluations) costs one device-to-host
copy, whatever it holds.  The streaming client store and its cohort stager
are not ported (``config.UNPORTED['client_store']``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _leaves(tree, out: List[torch.Tensor]):
    """The tree with each tensor leaf replaced by its index in ``out``."""
    if isinstance(tree, dict):
        return {k: _leaves(v, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves(v, out) for v in tree)
    if torch.is_tensor(tree):
        out.append(tree)
        return _Leaf(len(out) - 1)
    return tree


class _Leaf:
    def __init__(self, i: int):
        self.i = i


def _fill(tree, host: List[np.ndarray]):
    if isinstance(tree, dict):
        return {k: _fill(v, host) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, host) for v in tree)
    if isinstance(tree, _Leaf):
        return host[tree.i]
    return tree


def host_fetch(tree) -> Any:
    """The tree with every float32 tensor leaf as a numpy array, in ONE
    device-to-host copy (the leaves packed into one device buffer first)."""
    leaves: List[torch.Tensor] = []
    skeleton = _leaves(tree, leaves)
    if not leaves:
        return skeleton
    for t in leaves:
        if t.dtype is not torch.float32:
            raise TypeError(f"host_fetch: float32 metric leaves only, got {t.dtype}")
    flat = torch.cat([t.reshape(-1) for t in leaves]).cpu().numpy()
    host, off = [], 0
    for t in leaves:
        host.append(flat[off:off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return _fill(skeleton, host)


class PendingMetrics:
    """Metric sums left on the device; :meth:`fetch` brings them to the host
    once (one copy) and caches the result.  ``assemble`` maps the fetched
    tree to the caller-facing one; ``timers`` are ``{name: [(start, end)]}``
    CUDA event pairs (or host clock pairs on the CPU) whose seconds, pair
    by pair, come with the fetch as :attr:`seconds` ``{name: [s, ...]}``."""

    def __init__(self, device_tree, assemble: Optional[Callable[[Any], Any]] = None,
                 timers: Optional[Dict[str, List[Tuple[Any, Any]]]] = None):
        self._tree = device_tree
        self._assemble = assemble
        self._timers = timers or {}
        self._host = None
        self.seconds: Dict[str, List[float]] = {}

    def fetch(self):
        if self._host is None:
            host = host_fetch(self._tree)
            self._host = self._assemble(host) if self._assemble is not None else host
            self._tree = None  # release the device refs
            self.seconds = {k: [_elapsed(a, b) for a, b in pairs]
                            for k, pairs in self._timers.items()}
            self._timers = {}
        return self._host


def _elapsed(a, b) -> float:
    """Seconds between two marks: CUDA events (recorded on the device, read
    after the fetch's copy) or host clock readings."""
    if isinstance(a, torch.cuda.Event):
        return a.elapsed_time(b) / 1e3
    return float(b - a)


class MetricsPipeline:
    """Deferred metric fetch: ``push`` returns the ``(tag, host_metrics)``
    pairs that became due -- everything pending once ``fetch_every`` pushes
    have accumulated (1, the default, is a synchronous fetch); ``flush()``
    drains unconditionally (the experiment loops flush at evaluation
    boundaries and before exit)."""

    def __init__(self, fetch_every: int = 1):
        self.fetch_every = max(1, int(fetch_every or 1))
        self._pending: List[Tuple[Any, PendingMetrics]] = []

    def push(self, tag, pending: PendingMetrics) -> List[Tuple[Any, Any]]:
        self._pending.append((tag, pending))
        if len(self._pending) >= self.fetch_every:
            return self.flush()
        return []

    def flush(self) -> List[Tuple[Any, Any]]:
        out = [(tag, p.fetch()) for tag, p in self._pending]
        self._pending = []
        return out

    def __len__(self) -> int:
        return len(self._pending)
