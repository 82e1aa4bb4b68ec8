"""Deferred metric fetch, the experiment loop's phase timer, and the streaming
client store with its cohort stager.

Port of ``heterofl_tpu/parallel/staging.py`` (:306-669; :class:`PhaseTimer`
from :306-360).  A round or a
superstep leaves its metric sums on the device; :meth:`PendingMetrics.fetch`
packs every leaf into one buffer on the device and copies it to the host
once, so a superstep of k rounds (and its evaluations) costs one
device-to-host copy, whatever it holds.

``client_store='stream'``: :class:`ClientStore` holds the population as an
O(1)-per-user index over the raw arrays and gathers a cohort's shards into
caller buffers, byte for byte the rows of the eager ``[U, ...]`` stacks.
:class:`CohortStager` moves them onto the device through a ring of ``depth
+ 1`` slots, each a set of pinned host buffers and preallocated device
buffers of one layout (preallocated from the copy stream's pool, so no
block the compute stream still uses is handed to the copy stream, and
never freed while in use).  A cohort is gathered into a
slot's pinned buffers and copied with ``non_blocking`` copies on the
stager's own stream, which end in a recorded event.  The superstep that
trains it makes the compute stream wait on that event before its first
read (:meth:`StagedCohort.open`) and records a "consumed" event after its
last (:meth:`StagedCohort.release`); the copy stream waits on that event
before it overwrites the slot's device buffers, and the host synchronises
on the slot's last copy before it refills the pinned buffers.  A slot whose
cohort was neither trained nor released is never refilled (the stager
raises), so staging ahead cannot change a committed cohort.  On the CPU the
same ring runs with plain host tensors and synchronous copies.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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


class PhaseTimer:
    """Host-clock phase accounting of the experiment loop (ref parallel/staging.py:
    306-360): phases are free-form names (the loop's ``sample``, the
    cohort draw; ``stage``, a streamed cohort's gather and copy;
    ``dispatch``, the engine's call returning; ``fetch``, the metrics'
    copy to the host and their assembly), each one's seconds summed in
    ``totals`` and its count in ``calls``.  ``trace``: a
    :class:`~..obs.trace.TraceRecorder`, when attached, files every finished
    phase as a complete event on the run's timeline (one clock,
    ``perf_counter``)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.trace = None

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1
            if self.trace is not None:
                self.trace.complete(name, t0, dt, cat="phase")


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


# ---------------------------------------------------------------------------
# the streaming client store
# ---------------------------------------------------------------------------

def _idx64(a) -> np.ndarray:
    return np.asarray(a, np.int64)


class ClientStore:
    """The population as an O(1)-per-user index; a cohort's shards are
    gathered on demand (ref staging.py:416-587).

    Holds the raw arrays (images and targets, or batchified token rows) and
    per-user index metadata in one of two layouts: **CSR**
    (:meth:`from_split`, the split's index lists flattened with per-user
    offsets: O(samples)) or **spans** (:meth:`from_spans`, a contiguous
    ``(start, size)`` window a user: O(users), the layout of the synthetic
    million-user populations, ``data.partition.span_population``).

    ``fill_*`` gather the given users' shards into caller buffers with the
    rows of the eager ``data.stack_client_shards`` /
    ``stack_client_token_rows`` / ``label_split_masks`` stacks (the same
    repeat-first-items padding and masks) at the population's largest
    shard, so a streamed cohort trains exactly what the eager store would.
    A padding slot (user id ``-1``) gathers user 0's shard, as the engines
    read user ``max(uid, 0)``."""

    def __init__(self, data, target, sizes, classes_size, *, starts=None, offsets=None,
                 idx=None, label_offsets=None, label_idx=None, kind="vision"):
        self.kind = kind
        self.data = np.ascontiguousarray(data)
        self.target = None if target is None else np.ascontiguousarray(target)
        self.sizes = _idx64(sizes)
        self.classes_size = int(classes_size)
        self._starts = None if starts is None else _idx64(starts)
        self._off = None if offsets is None else _idx64(offsets)
        self._idx = None if idx is None else _idx64(idx)
        self._loff = None if label_offsets is None else _idx64(label_offsets)
        self._lidx = None if label_idx is None else _idx64(label_idx)
        if (self._starts is None) == (self._off is None):
            raise ValueError("ClientStore needs exactly one of spans or CSR index")
        if self.sizes.size == 0 or (self.sizes <= 0).any():
            raise ValueError("every user needs a non-empty shard")
        self.num_users = int(self.sizes.size)
        self.shard_max = int(self.sizes.max())
        if kind == "lm" and (self.sizes != self.shard_max).any():
            raise ValueError("per-user row counts must match")  # the eager stack's rule

    @staticmethod
    def _label_csr(label_split, users: int):
        if label_split is None:
            return None, None
        rows = [_idx64(label_split[u]) for u in range(users)]
        off = np.concatenate([[0], np.cumsum([r.size for r in rows])]).astype(np.int64)
        return off, (np.concatenate(rows) if rows else np.zeros(0, np.int64))

    @classmethod
    def from_split(cls, data, target, data_split: Dict[int, Sequence[int]], label_split,
                   classes_size: int, kind: str = "vision") -> "ClientStore":
        """From the experiment's per-user index lists (the eager stacks'
        inputs)."""
        rows = [_idx64(data_split[u]) for u in range(len(data_split))]
        sizes = _idx64([r.size for r in rows])
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        idx = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        loff, lidx = cls._label_csr(label_split, len(rows))
        return cls(data, target, sizes, classes_size, offsets=offsets, idx=idx,
                   label_offsets=loff, label_idx=lidx, kind=kind)

    @classmethod
    def from_spans(cls, data, target, starts, sizes, classes_size, label_split=None,
                   kind: str = "vision") -> "ClientStore":
        """From per-user contiguous ``(start, size)`` windows into the raw
        arrays; ``label_split=None``: every user sees every class."""
        starts, sizes = _idx64(starts), _idx64(sizes)
        if starts.shape != sizes.shape:
            raise ValueError(f"starts/sizes shape mismatch: {starts.shape} vs {sizes.shape}")
        if ((starts < 0) | (starts + sizes > len(data))).any():
            raise ValueError("a user span runs outside the raw data array")
        loff, lidx = cls._label_csr(label_split, len(starts))
        return cls(data, target, sizes, classes_size, starts=starts, label_offsets=loff,
                   label_idx=lidx, kind=kind)

    @property
    def metadata_nbytes(self) -> int:
        """Host bytes of the index metadata (the raw arrays, shared with the
        dataset, excluded)."""
        return sum(a.nbytes for a in (self.sizes, self._starts, self._off, self._idx,
                                      self._loff, self._lidx) if a is not None)

    @property
    def row_shape(self) -> Tuple[int, ...]:
        """A user's shard at the store-wide largest shard: vision
        ``(shard_max,) + sample shape``, LM ``(rows, row length)``."""
        return (self.shard_max,) + self.data.shape[1:]

    def _row_idx(self, u: int, n: int) -> np.ndarray:
        """User ``u``'s sample indices padded to ``n``: its own first, then
        its first ``n - size`` repeated cyclically."""
        sz = int(self.sizes[u])
        j = np.arange(n)
        jj = np.where(j < sz, j, (j - sz) % sz)
        if self._starts is not None:
            return int(self._starts[u]) + jj
        lo = int(self._off[u])
        return self._idx[lo:lo + sz][jj]

    def fill_vision(self, user_ids, x_out: np.ndarray, y_out: np.ndarray,
                    m_out: np.ndarray) -> None:
        """Gather the users' shards into ``[slots, n, ...]`` images, targets
        and sample masks."""
        n = x_out.shape[1]
        for s, u in enumerate(_idx64(user_ids).reshape(-1)):
            u = max(int(u), 0)
            idx = self._row_idx(u, n)
            x_out[s] = self.data[idx]
            y_out[s] = self.target[idx]
            sz = int(self.sizes[u])
            m_out[s, :sz] = 1.0
            m_out[s, sz:] = 0.0

    def fill_lm(self, user_ids, rows_out: np.ndarray) -> None:
        """Gather the users' token rows into ``[slots, rows, row length]``."""
        for s, u in enumerate(_idx64(user_ids).reshape(-1)):
            rows_out[s] = self.data[self._row_idx(max(int(u), 0), rows_out.shape[1])]

    def fill_labels(self, user_ids, lm_out: np.ndarray) -> None:
        """The users' label masks ``[slots, classes]``; all ones for a store
        without a label split."""
        if self._lidx is None:
            lm_out[:] = 1.0
            return
        lm_out[:] = 0.0
        for s, u in enumerate(_idx64(user_ids).reshape(-1)):
            u = max(int(u), 0)
            lm_out[s, self._lidx[self._loff[u]:self._loff[u + 1]]] = 1.0

    def layouts(self, slots: int) -> List[Tuple[Tuple[int, ...], np.dtype]]:
        """``(shape, dtype)`` of the cohort buffers of ``slots`` users, in the
        engines' data order: vision ``(x, y, sample mask, label mask)``, LM
        ``(token rows, label mask)``."""
        lm = ((slots, self.classes_size), np.dtype(np.float32))
        if self.kind == "lm":
            return [((slots,) + self.row_shape, self.data.dtype), lm]
        n = self.shard_max
        return [((slots,) + self.row_shape, self.data.dtype), ((slots, n), self.target.dtype),
                ((slots, n), np.dtype(np.float32)), lm]

    def fill(self, user_ids, bufs: Sequence[np.ndarray]) -> None:
        """Gather the users' shards into buffers of :meth:`layouts`."""
        if self.kind == "lm":
            self.fill_lm(user_ids, bufs[0])
        else:
            self.fill_vision(user_ids, *bufs[:3])
        self.fill_labels(user_ids, bufs[-1])


class _RingSlot:
    """One slot of the stager's ring: pinned host buffers (their numpy
    views), device buffers of the same layout, the event of its last copy
    and the cohort it holds."""

    def __init__(self, layouts, device: torch.device, stream=None):
        pin = device.type == "cuda"
        self.host = tuple(torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dt)).dtype,
                                      pin_memory=pin) for shape, dt in layouts)
        self.arrays = tuple(h.numpy() for h in self.host)
        if pin:
            # allocated from the copy stream's pool: a block the compute
            # stream freed may still be read or written by its queued
            # kernels, and the copy stream would write into it at once;
            # read on the compute stream, so it is freed only after both
            compute = torch.cuda.current_stream(device)
            with torch.cuda.stream(stream):
                self.dev = tuple(torch.empty_like(h, device=device) for h in self.host)
            for d in self.dev:
                d.record_stream(compute)
        else:
            self.dev = tuple(torch.empty_like(h) for h in self.host)
        self.copied = None    # event: this slot's last host-to-device copy
        self.consumed = None  # event: the last superstep that read the device buffers
        self.cohort: Optional["StagedCohort"] = None


class StagedCohort:
    """One superstep's cohort on the device: ``data`` (the engine's stacks,
    one row a slot of the layout), the ``[k, A]`` cohorts ``users`` (host
    int64) and absolute ``rates`` (host float32, or None), and ``rows``
    (host int64 ``[k, A]``): the data row of round r's slot i -- what a
    user id indexes in the eager stacks.  A reader (the superstep that
    trains it, or a caller that reads it after that superstep) holds it
    between :meth:`open` and :meth:`release`; the slot is freed when the
    last holder releases it, or when a cohort no one opened is released."""

    def __init__(self, engine: str, users: np.ndarray, rates: Optional[np.ndarray],
                 rows: np.ndarray, data: Tuple[torch.Tensor, ...], slot: _RingSlot):
        self.engine = engine
        self.users, self.rates, self.rows = users, rates, rows
        self.k = users.shape[0]
        self.data = data
        self._slot = slot
        self._holds = 0
        self.released = False

    @property
    def ready(self):
        """The event that ends the cohort's copy (None on the CPU)."""
        return self._slot.copied

    def open(self, engine: str, k: int) -> Tuple[torch.Tensor, ...]:
        """The data for a superstep of ``k`` rounds of ``engine`` (one more
        holder), the current stream made to wait for the cohort's copy."""
        if self.engine != engine or self.k != k:
            raise ValueError(f"cohort mismatch: staged for engine={self.engine!r} k={self.k}, "
                             f"dispatching {engine} k={k}")
        if self.released:
            raise ValueError("cohort already trained or released: its ring slot may hold "
                             "another cohort")
        self._holds += 1
        if self.ready is not None:
            torch.cuda.current_stream(self.data[0].device).wait_event(self.ready)
        return self.data

    def release(self) -> None:
        """One holder is done; when none is left, the cohort is consumed:
        after the reads enqueued so far on the current stream, its slot may
        be overwritten."""
        if self.released:
            return
        self._holds -= 1
        if self._holds > 0:
            return
        self.released = True
        slot = self._slot
        if self.data[0].is_cuda:
            slot.consumed = torch.cuda.Event()
            slot.consumed.record(torch.cuda.current_stream(self.data[0].device))
        if slot.cohort is self:
            slot.cohort = None


class CohortStager:
    """The ring of cohort slots of one engine: ``depth + 1`` slots a
    layout, so ``depth`` cohorts can wait staged while one trains.
    :meth:`stage` fills a slot's pinned host buffers (after the host waited
    for the slot's previous copy) and copies them onto the slot's device
    buffers on the copy stream (after it waited for the slot's previous
    cohort to be consumed)."""

    def __init__(self, device: torch.device, depth: int = 1):
        self.device = device
        self.depth = max(1, int(depth))
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._cursor: Dict[Any, int] = {}
        self._slots: Dict[Tuple[Any, int], _RingSlot] = {}

    def stage(self, key, store: ClientStore, engine: str, slot_users: np.ndarray,
              users: np.ndarray, rates: Optional[np.ndarray], rows: np.ndarray) -> StagedCohort:
        """Gather ``slot_users`` (a user id a slot of the layout, ``-1``
        padding) from ``store`` into the next ring slot of ``key``, copy it
        onto the slot's device buffers and return the cohort; the ring's
        cursor advances."""
        slot_users = _idx64(slot_users).reshape(-1)
        i = self._cursor.get(key, 0)
        slot = self._slots.get((key, i))
        if slot is None:
            slot = self._slots[(key, i)] = _RingSlot(store.layouts(slot_users.size),
                                                     self.device, self.stream)
        if slot.cohort is not None:
            raise RuntimeError(
                f"cohort ring of depth {self.depth}: slot {i} still holds a staged cohort "
                f"that no superstep has trained or released -- staging another would "
                f"overwrite it")
        if slot.copied is not None:
            slot.copied.synchronize()  # the pinned buffers' last copy has left them
        store.fill(slot_users, slot.arrays)
        if self.stream is None:
            for h, d in zip(slot.host, slot.dev):
                d.copy_(h)
        else:
            with torch.cuda.stream(self.stream):
                if slot.consumed is not None:
                    self.stream.wait_event(slot.consumed)
                for h, d in zip(slot.host, slot.dev):
                    d.copy_(h, non_blocking=True)
                slot.copied = torch.cuda.Event(enable_timing=True)
                slot.copied.record(self.stream)
        self._cursor[key] = (i + 1) % (self.depth + 1)
        slot.cohort = StagedCohort(engine, users, rates, rows, slot.dev, slot)
        return slot.cohort
