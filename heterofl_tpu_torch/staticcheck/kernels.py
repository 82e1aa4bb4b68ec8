"""Kernels a step launches, counted from its capture.

On the card a replayed step is a CUDA graph: :func:`graph_kernels`
captures one call of a function and counts the kernel nodes of the
capture -- CUDA's own list (``cuGraphGetNodes``, ``cuGraphNodeGetType``;
memsets and copies not counted), exact where a profiler trace can lose
records.  On the CPU nothing is captured; :func:`op_count` counts the
aten operators one call dispatches (a ``TorchDispatchMode``), the CPU's
measure of the same work, exact and repeatable.  The hand-written
kernels' wrapper counters are put back after a count, so a count adds
no launch to a path's tally.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from ..ops import fused_norm, fused_update, quant

_COUNTERS = (fused_norm.LAUNCHES, fused_update.LAUNCHES, quant.LAUNCHES)


def _restore_counters(fn: Callable[[], int]) -> int:
    before = [dict(c) for c in _COUNTERS]
    try:
        return fn()
    finally:
        for c, b in zip(_COUNTERS, before):
            c.clear()
            c.update(b)


def graph_kernels(fn: Callable[[], None], reset: Optional[Callable[[], None]] = None,
                  generators: Sequence[torch.Generator] = ()) -> int:
    """Kernels one call of ``fn`` launches on the card, counted as the
    kernel nodes of its capture in a CUDA graph.  A warm-up call runs on a
    side stream first; ``reset`` runs before each call (a step's counter
    back to 0), ``generators`` are registered with the capture."""
    from ..parallel.step_graph import gc_paused

    def count() -> int:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            if reset is not None:
                reset()
            fn()
        torch.cuda.current_stream().wait_stream(side)
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in generators:
            graph.register_generator_state(gen)
        with gc_paused(), torch.cuda.graph(graph):
            fn()
        torch.cuda.synchronize()
        return count_kernel_nodes(graph)

    return _restore_counters(count)


def count_kernel_nodes(graph) -> int:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True``."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphNodeGetType.restype = ctypes.c_int
    raw, num = graph.raw_cuda_graph(), ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(raw, None, ctypes.byref(num))  # the count
    nodes = (ctypes.c_void_p * num.value)()
    if rc == 0:
        rc = cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(num))  # the nodes
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        rc = cuda.cuGraphNodeGetType(node, ctypes.byref(kind))
        if rc != 0:
            raise RuntimeError(f"cuGraphNodeGetType failed: CUresult {rc}")
        kinds.append(kind.value)
    return kinds.count(0)  # CU_GRAPH_NODE_TYPE_KERNEL


def op_count(fn: Callable[[], None], reset: Optional[Callable[[], None]] = None) -> int:
    """The aten operators one call of ``fn`` dispatches (forward and
    backward), after ``reset``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            _Count.n += 1
            return func(*args, **(kwargs or {}))

    def count() -> int:
        if reset is not None:
            reset()
        with _Count():
            fn()
        return _Count.n

    return _restore_counters(count)


def step_launches(fn: Callable[[], None], reset: Optional[Callable[[], None]],
                  generators: Sequence[torch.Generator], device: torch.device) -> int:
    """A step's launches: kernel nodes of its capture on the card, aten
    operators on the CPU."""
    if torch.device(device).type == "cuda":
        return graph_kernels(fn, reset, generators)
    return op_count(fn, reset)
