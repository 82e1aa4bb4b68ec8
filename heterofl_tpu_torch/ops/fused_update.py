"""Fused masked-SGD epilogue over flat parameter buffers.

Port of ``heterofl_tpu/ops/fused_update.py``: ``FlatSpec``,
``resolve_fused_mode`` and ``fused_sgd_flat``, whose TPU kernel
(``_fused_sgd_kernel``) is ``csrc/fused_sgd.cu`` here.  A client's params,
momentum, gradient and width mask each live in ONE flat float32 buffer
(sorted-key leaf order, each leaf a contiguous segment), so the whole
optimizer tail of a local step is one kernel pair over four buffers:

    gm  = (g / max(n, 1e-6)) * mask               # mean-normalise + mask
    gm  = gm * min(1, 1 / (||gm||_2 + 1e-6))      # clip_by_global_norm
    buf = momentum * buf + gm + weight_decay * p  # torch SGD
    p   = p - lr * buf
    p, buf = (new if has else old)                # all-padding skip

``denom``, ``lr`` and ``has`` ride in a device vector ``scal[3]``
(:func:`make_scal`), so the step loop never reads a value back to the host.

:func:`fused_sgd_plain` is the plain PyTorch version, in the reference's
expression order; :data:`LAUNCHES` counts kernel launches.  With the clip
not engaged the kernel's elementwise tail equals the plain chain bit for
bit; with it engaged the norm is summed in another order (per block, not
per leaf), so the scale may differ in the last ulp.  The per-leaf chain
that ``fused_update=False`` (and every optimizer but SGD) runs instead is
``utils/optim.py``'s.

The batched kernel (3b; :func:`fused_sgd_batched`, the kernel under
``jax.vmap`` over a level's clients, the grouped engine) takes ``g, p, buf
[G, n]`` client-major (each client's flat buffer one row; rows ``ld >= n``
floats apart, so the grouped engine's rows padded to a multiple of 4 start
16-byte aligned), the mask ``[n]`` shared by the rows, and ``scal [G, 3]``
(each client's denom, lr, has), in ONE launch a step whatever G is.  Each
row's norm is summed over the one-client kernel's parts in its order, so
row g equals the one-client kernel on client g bit for bit; the launch plan
(:func:`sgd_plan_batched`, a pure function of the shape) picks the route:
a persistent grid that sums a group of rows' parts together, a barrier
across the grid (a cooperative launch), then the update; or, for rows of
at most :data:`SGD_CLUSTER_PARTS` parts, one thread-block cluster a row
(csrc/fused_sgd.cu).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

#: calls of :func:`fused_sgd_cuda` (two kernel launches each) and of
#: :func:`fused_sgd_batched_cuda` (one launch each)
LAUNCHES = {"fused_sgd": 0, "fused_sgd_batched": 0}

# the kernels' fixed shape (csrc/fused_sgd.cu): threads a block, a row's
# parts at most (each part about 4 chunks of 4 entries a thread), rows a
# pass of the batched persistent route at most, and the most parts a row
# may have to take the cluster route (a cluster of up to 16 blocks,
# non-portable above 8)
SGD_THREADS = 256
SGD_MAX_PARTS = 1024
SGD_MAX_ROWS = 8
SGD_CLUSTER_PARTS = 16
# rows a pass: all of them (up to SGD_MAX_ROWS) where that still leaves at
# least this many work items, about the blocks of the persistent kernel an
# H100 holds at once (4 of 256 threads on each of 132 SMs); else one, so a
# row of few parts spreads over more blocks
SGD_WIDE_ITEMS = 512
_ROUTES = {"persistent": 0, "cluster": 1}


class SgdPlan(NamedTuple):
    """Launch plan of the batched kernel for ``[G, n]`` rows ``ld`` apart."""
    parts: int   # virtual parts of a row: the one-client kernel's blocks of launch A
    route: str   # "persistent" (a grid-wide barrier) or "cluster" (a cluster a row)
    rows: int    # rows a pass of the persistent route (each part of them summed together)
    groups: int  # row groups, ceil(G / rows); work items = parts * groups
    vec: int     # bytes / 4 of a chunk's loads: 4 (one 16-byte load) or 1 (four scalars)


def sgd_parts(n: int) -> int:
    """``parts_for(n)`` of csrc/fused_sgd.cu: the blocks of the one-client
    kernel's launch A, about 4 chunks of 4 entries a thread, 1 to
    :data:`SGD_MAX_PARTS`."""
    per = 4 * SGD_THREADS
    return max(1, min(SGD_MAX_PARTS, -(-(n // 4) // per)))


@functools.lru_cache(maxsize=None)
def sgd_plan_batched(n: int, G: int, ld: int, route: Optional[str] = None,
                     rows: Optional[int] = None) -> SgdPlan:
    """The batched kernel's plan for ``G`` rows of ``n`` entries ``ld``
    floats apart: the one-client kernel's parts; the cluster route where a
    row has at most :data:`SGD_CLUSTER_PARTS` parts, else the persistent
    one; rows a pass balanced over the fewest groups of at most
    :data:`SGD_MAX_ROWS` where that leaves :data:`SGD_WIDE_ITEMS` work items
    (parts x groups), else one; 16-byte loads where every row starts 16-byte
    aligned with its buffer (``ld % 4 == 0``, or a single row), else
    scalars.  ``route`` and ``rows`` override the choice (a measuring
    aid)."""
    if n < 1 or G < 1 or ld < n:
        raise ValueError(f"sgd_plan_batched: n={n}, G={G}, ld={ld}")
    parts = sgd_parts(n)
    if route is None:
        route = "cluster" if parts <= SGD_CLUSTER_PARTS else "persistent"
    if route not in _ROUTES or (route == "cluster" and parts > SGD_CLUSTER_PARTS):
        raise ValueError(f"sgd_plan_batched: route {route!r} for {parts} parts")
    if rows is None:
        rows = -(-G // -(-G // SGD_MAX_ROWS))
        rows = rows if parts * -(-G // rows) >= SGD_WIDE_ITEMS else 1
    if not 1 <= rows <= SGD_MAX_ROWS:
        raise ValueError(f"sgd_plan_batched: rows {rows} (1 to {SGD_MAX_ROWS})")
    vec = 4 if G == 1 or ld % 4 == 0 else 1
    return SgdPlan(parts, route, rows, -(-G // rows), vec)


class FlatSpec:
    """Static packing of a ``{name: tensor}`` tree into one flat float32
    vector, leaves in sorted-key order (the reference's order)."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]]):
        self.names = sorted(shapes)
        self.shapes = {k: tuple(shapes[k]) for k in self.names}
        self.sizes, self.offsets = {}, {}
        off = 0
        for k in self.names:
            sz = 1
            for d in self.shapes[k]:
                sz *= d
            self.sizes[k] = sz
            self.offsets[k] = off
            off += sz
        self.total = off

    @classmethod
    def of(cls, tree: Dict[str, torch.Tensor]) -> "FlatSpec":
        return cls({k: tuple(v.shape) for k, v in tree.items()})

    def flatten(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([tree[k].reshape(-1).to(torch.float32) for k in self.names])

    def leaf(self, flat: torch.Tensor, k: str) -> torch.Tensor:
        off = self.offsets[k]
        return flat[off:off + self.sizes[k]].view(self.shapes[k])

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Zero-copy leaf views of ``flat``."""
        return {k: self.leaf(flat, k) for k in self.names}


def resolve_fused_mode(cfg: Dict[str, Any], device: torch.device) -> Optional[str]:
    """``cfg['fused_update']`` -> ``"cuda"`` (the kernel), ``"plain"`` (its
    plain version, CPU only) or None (the unfused chain: the clip per leaf,
    then the configured optimizer over flat buffers,
    ``utils.optim.FlatOptimizer``).

    A non-SGD optimizer resolves to None before ``fused_update`` is read, as
    the reference's does (the kernel is torch SGD's update).  For SGD,
    ``True`` (the default) resolves by device: the kernel on CUDA, the plain
    version on the CPU.  ``"cuda"`` asks for the kernel and raises off CUDA.
    ``False`` keeps the unfused chain, as the reference's does."""
    if cfg.get("optimizer_name", "SGD") != "SGD":
        return None
    fu = cfg.get("fused_update", True)
    if fu is True:
        return "cuda" if device.type == "cuda" else "plain"
    if fu is False:
        return None
    if fu == "cuda":
        if device.type != "cuda":
            raise RuntimeError(f"fused_update='cuda' needs a CUDA device, got {device}")
        return "cuda"
    raise ValueError(f"Not valid fused_update: {fu!r} (True/False/'cuda')")


def make_scal(n_glob: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
    """``[denom, lr, has]`` on the device: ``denom = max(n, 1e-6)``,
    ``has = n > 0``."""
    return torch.stack([n_glob.clamp_min(1e-6), lr.to(torch.float32),
                        (n_glob > 0).to(torch.float32)])


def fused_sgd_plain(g: torch.Tensor, p: torch.Tensor, buf: torch.Tensor, mask: torch.Tensor,
                    scal: torch.Tensor, *, momentum: float, weight_decay: float,
                    max_norm: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel; returns new ``(p, buf)``."""
    denom, lr, has = scal[0], scal[1], scal[2]
    gm = (g / denom) * mask
    total = torch.sqrt((gm * gm).sum())
    scale = torch.minimum(total.new_full((), max_norm) / (total + 1e-6), total.new_ones(()))
    nb = momentum * buf + gm * scale + weight_decay * p
    pn = p - lr * nb
    keep = has > 0
    return torch.where(keep, pn, p), torch.where(keep, nb, buf)


def fused_sgd_cuda(g, p, buf, mask, scal, *, momentum: float, weight_decay: float,
                   max_norm: float = 1.0):
    """The one-client kernel pair (``csrc/fused_sgd.cu``), in place on ``p``
    and ``buf``."""
    _build.require_cuda("fused_sgd", g, p, buf, mask, scal)
    n = p.numel()
    if any(t.numel() != n for t in (g, buf, mask)) or scal.numel() != 3:
        raise ValueError("fused_sgd: g, p, buf, mask must have one size; scal three entries")
    if any(t.data_ptr() % 16 for t in (g, p, buf, mask)):
        raise ValueError("fused_sgd: buffers must be 16-byte aligned")
    lib = _build.load()
    part = torch.empty(lib.hfl_sgd_scratch_floats(), dtype=torch.float32, device=p.device)
    _build.check(lib.hfl_fused_sgd(g.data_ptr(), p.data_ptr(), buf.data_ptr(), mask.data_ptr(),
                                   scal.data_ptr(), part.data_ptr(), n, float(momentum),
                                   float(weight_decay), float(max_norm), _build.stream_of(p)),
                 "fused_sgd")
    LAUNCHES["fused_sgd"] += 1
    return p, buf


def fused_sgd_flat(g, p, buf, mask, scal, *, momentum: float, weight_decay: float,
                   max_norm: float = 1.0):
    """One fused masked-SGD step, IN PLACE on ``p`` and ``buf`` (returned):
    the plain version for CPU tensors, the kernel for any other (which
    raises rather than fall back)."""
    if p.device.type != "cpu":
        return fused_sgd_cuda(g, p, buf, mask, scal, momentum=momentum,
                              weight_decay=weight_decay, max_norm=max_norm)
    pn, bn = fused_sgd_plain(g, p, buf, mask, scal, momentum=momentum,
                             weight_decay=weight_decay, max_norm=max_norm)
    p.copy_(pn)
    buf.copy_(bn)
    return p, buf


def fused_sgd_batched_plain(g: torch.Tensor, p: torch.Tensor, buf: torch.Tensor,
                            mask: torch.Tensor, scal: torch.Tensor, *, momentum: float,
                            weight_decay: float, max_norm: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the batched kernel: :func:`fused_sgd_plain`
    on each row of ``g, p, buf [G, n]`` with that row's ``scal [G, 3]``;
    returns new ``(p, buf)``, each row bit for bit the one-client version's
    (each row's norm is summed as a flat buffer's)."""
    denom, lr, has = scal[:, 0:1], scal[:, 1:2], scal[:, 2:3]
    gm = (g / denom) * mask
    total = torch.sqrt(torch.stack([(r * r).sum() for r in gm]))[:, None]
    scale = torch.minimum(total.new_full((), max_norm) / (total + 1e-6), total.new_ones(()))
    nb = momentum * buf + gm * scale + weight_decay * p
    pn = p - lr * nb
    keep = has > 0
    return torch.where(keep, pn, p), torch.where(keep, nb, buf)


def fused_sgd_batched_cuda(g, p, buf, mask, scal, *, momentum: float, weight_decay: float,
                           max_norm: float = 1.0, plan: Optional[SgdPlan] = None):
    """The batched kernel (``csrc/fused_sgd.cu``), one launch, in place on
    ``p`` and ``buf``: ``g, p, buf [G, n]`` with unit-stride rows one stride
    apart, on ``plan`` (default :func:`sgd_plan_batched`)."""
    _build.require_cuda("fused_sgd_batched", g, p, buf, mask, scal, rows=3)
    if p.dim() != 2 or g.shape != p.shape or buf.shape != p.shape \
            or mask.numel() != p.shape[1] or tuple(scal.shape) != (p.shape[0], 3):
        raise ValueError("fused_sgd_batched: g, p, buf [G, n], mask [n] and scal [G, 3]")
    G, n = p.shape
    ld = p.stride(0) if G > 1 else n
    if G > 1 and (ld < n or g.stride(0) != ld or buf.stride(0) != ld):
        raise ValueError("fused_sgd_batched: g, p and buf need one row stride, at least n")
    pl = plan or sgd_plan_batched(n, G, ld)
    if any(t.data_ptr() % (4 * pl.vec) for t in (g, p, buf, mask)):
        raise ValueError(f"fused_sgd_batched: rows must start {4 * pl.vec}-byte aligned")
    lib = _build.load()
    part = None  # the cluster route keeps its partials on chip
    if pl.route == "persistent":
        part = torch.empty(G * pl.parts, dtype=torch.float32, device=p.device)
    _build.check(lib.hfl_fused_sgd_batched(
        g.data_ptr(), p.data_ptr(), buf.data_ptr(), mask.data_ptr(), scal.data_ptr(),
        None if part is None else part.data_ptr(), n, ld, G, float(momentum),
        float(weight_decay), float(max_norm), pl.parts, _ROUTES[pl.route], pl.rows, pl.vec,
        _build.stream_of(p)), "fused_sgd_batched")
    LAUNCHES["fused_sgd_batched"] += 1
    return p, buf


def fused_sgd_batched(g, p, buf, mask, scal, *, momentum: float, weight_decay: float,
                      max_norm: float = 1.0):
    """One fused masked-SGD step of G clients, IN PLACE on ``p`` and
    ``buf`` ``[G, n]`` (returned; rows may be views one stride apart): the
    plain version for CPU tensors, the kernel for any other (which raises
    rather than fall back)."""
    if p.device.type != "cpu":
        return fused_sgd_batched_cuda(g, p, buf, mask, scal, momentum=momentum,
                                      weight_decay=weight_decay, max_norm=max_norm)
    pn, bn = fused_sgd_batched_plain(g, p, buf, mask, scal, momentum=momentum,
                                     weight_decay=weight_decay, max_norm=max_norm)
    p.copy_(pn)
    buf.copy_(bn)
    return p, buf
