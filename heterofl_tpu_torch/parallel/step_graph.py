"""Local steps and evaluation forwards captured as CUDA graphs.

The port's counterpart of compiling the reference's K-round superstep
(``heterofl_tpu/parallel/round_engine.py:1487``): where the reference runs
K rounds as one XLA program, the port captures one local step (a step of a
client, of a level's G clients, or one no-grad evaluation batch) as a
``torch.cuda.CUDAGraph`` and replays it, so the several hundred kernels of
a step go to the device with no host work between them.

A step is a function of no arguments over **static buffers**: the engine
allocates them once, copies a client's data, permutations and params into
them before its steps (eager set-up), and the step reads them, writes its
results into them in place and advances a **device step counter** that it
reads its batch through (``index_select`` at ``t * B``), so one graph
serves every step of every client at its key.  Each engine keeps one
:class:`StepGraphs`: its graphs share one memory pool and one capture
stream.  Every persistent output is written in place into a static buffer
allocated outside the pool, so a graph's pool memory holds only its
step's temporaries and the graphs may replay in any order.

Capture: ``WARMUP`` eager steps on the capture stream (cuDNN's and
cuBLAS's algorithm choices and workspaces, autograd's lazy start, every
cache of the model filled), the step counter reset before each, then the
capture.  The warm-up writes garbage into the static buffers, which the
engine's next set-up overwrites.  Random draws: the generators a step
draws from are registered with the graph
(``CUDAGraph.register_generator_state``), so a replay takes its philox
offsets from the generator's state at replay time and advances it by what
the step consumed -- a replay draws what the eager step would draw from
the same state, and two replays draw different numbers.  The engine
reseeds those generators per client.  The garbage collector runs just
before a capture and is paused during it (:func:`gc_paused`): an engine's
graphs sit in a reference cycle (a step keeps its function, which keeps
the engine), and collecting a dead engine mid-capture would destroy its
graphs there -- an API call the capture forbids, which invalidates it.

Launch counts: a wrapper counts its launch when it is called, and during a
capture it is called but launches nothing; so the counts a capture adds
are taken back, kept as the graph's launches a replay, and added to the
same counters at each replay (:data:`STATS` has the captures, their
seconds, the replays and the pool's bytes).

On the CPU (the tests) a step runs eagerly on the same static buffers:
:meth:`Step.replay` calls the step function.  On a CUDA device there is
no eager fallback: a capture that fails raises.
"""

from __future__ import annotations

import gc
import time
from contextlib import contextmanager
from typing import Callable, Dict, Hashable, List, Optional, Sequence

import torch

from ..ops import fused_norm, fused_update, quant

#: eager steps before a capture
WARMUP = 2

#: what this process's graphs did: captures and their seconds (warm-up
#: included), replays, and the bytes their shared pools grew by
STATS = {"captures": 0, "capture_seconds": 0.0, "replays": 0, "pool_bytes": 0}

#: kernel launches made by replays, by wrapper counter name (also in the
#: wrappers' own counters): a graph's captured launches times its replays
REPLAYED: Dict[str, int] = {}

_COUNTERS = (fused_norm.LAUNCHES, fused_update.LAUNCHES, quant.LAUNCHES)


def _snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in _COUNTERS]


@contextmanager
def gc_paused():
    """Collect the garbage now, then pause the collector for the block (a
    CUDA graph capture; PyTorch's ``torch.cuda.graph`` no longer collects
    before capturing)."""
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k == "capture_seconds" else 0
    REPLAYED.clear()


class Step:
    """One captured step (CUDA) or its eager function (CPU)."""

    def __init__(self, fn: Callable[[], None], graph=None, launches=None):
        self.fn = fn
        self.graph = graph
        #: kernel launches of one replay, by wrapper counter
        self.launches: List[Dict[str, int]] = launches or [{} for _ in _COUNTERS]

    def replay(self) -> None:
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        STATS["replays"] += 1
        for counts, delta in zip(_COUNTERS, self.launches):
            for k, v in delta.items():
                counts[k] += v
                REPLAYED[k] = REPLAYED.get(k, 0) + v


class StepGraphs:
    """The graphs of one engine on one device, keyed by what fixes their
    shapes and constants (a level, a level and its G, a batch shape)."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = device
        # capture=False: every step runs eagerly, as on the CPU (a step that
        # holds a collective gloo cannot capture: the data axis)
        self.cuda = device.type == "cuda" and capture
        self.steps: Dict[Hashable, Step] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def get(self, key: Hashable, fn: Callable[[], None], reset: Callable[[], None],
            generators: Sequence[torch.Generator] = ()) -> Step:
        """The step at ``key``, captured on first use: ``fn`` the step,
        ``reset`` puts its step counter back to 0, ``generators`` the
        generators it draws from."""
        if key not in self.steps:
            self.steps[key] = self._capture(fn, reset, generators) if self.cuda else Step(fn)
        return self.steps[key]

    def _capture(self, fn, reset, generators) -> Step:
        if generators and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError("this PyTorch cannot register a generator with a CUDA graph "
                               "(CUDAGraph.register_generator_state, PyTorch >= 2.5): a "
                               "captured step would replay the same random draws")
        # staticcheck: allow(no-block-until-ready) a capture's set-up
        torch.cuda.synchronize(self.device)
        t0 = time.time()  # staticcheck: allow(no-wallclock) a capture's seconds
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP):
                reset()
                fn()
            reset()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        before = _snapshot()
        # staticcheck: allow(no-block-until-ready) a capture's set-up
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with gc_paused(), torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            fn()
        # staticcheck: allow(no-block-until-ready) a capture's set-up
        torch.cuda.synchronize(self.device)
        STATS["pool_bytes"] += torch.cuda.memory_reserved(self.device) - reserved
        after = _snapshot()
        launches = []
        for counts, b, a in zip(_COUNTERS, before, after):
            launches.append({k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)})
            counts.clear()
            counts.update(b)
        STATS["captures"] += 1
        # staticcheck: allow(no-wallclock) a capture's seconds
        STATS["capture_seconds"] += time.time() - t0
        return Step(fn, graph, launches)


def device_counter(device: torch.device) -> torch.Tensor:
    """A step counter: a 0-d int64 tensor on ``device``."""
    return torch.zeros((), dtype=torch.int64, device=device)


def maybe_event(device: torch.device) -> Optional[object]:
    """A mark of the device's clock for :class:`~.staging.PendingMetrics`'s
    timers: a recorded CUDA event on a CUDA device, the host clock on the
    CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.time()  # staticcheck: allow(no-wallclock) the CPU's clock mark
