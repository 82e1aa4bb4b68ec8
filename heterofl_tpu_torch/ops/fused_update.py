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
that ``fused_update=False`` runs instead is ``utils/optim.py``'s.

The batched pair (:func:`fused_sgd_batched`; the kernel under ``jax.vmap``
over a level's clients, the grouped engine) takes ``g, p, buf [G, n]``
client-major (each client's flat buffer one contiguous row), the mask
``[n]`` shared by the rows, and ``scal [G, 3]`` (each client's denom, lr,
has): launch A writes per-client partial sums of squares on a ``(parts,
G)`` grid, launch B reduces each client's partials in a fixed order and
applies that client's clip scale -- two launches a step whatever G is.
Both kernels cut a row of n entries into the same ``parts(n)`` blocks
(sized by n, csrc/fused_sgd.cu), so row g equals the one-client kernel on
client g bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import _build

#: kernel-pair launches of :func:`fused_sgd_cuda`
LAUNCHES = {"fused_sgd": 0, "fused_sgd_batched": 0}


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
    plain version, CPU only) or None (the per-leaf reference chain).

    ``True`` (the default) resolves by device: the kernel on CUDA, the plain
    version on the CPU.  ``"cuda"`` asks for the kernel and raises off CUDA.
    ``False`` keeps the unfused per-leaf chain, as the reference's does."""
    if cfg.get("optimizer_name", "SGD") != "SGD":
        raise NotImplementedError(
            f"optimizer_name={cfg['optimizer_name']!r} is not ported to "
            f"heterofl_tpu_torch yet (SGD is)")
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
    """The kernel pair (``csrc/fused_sgd.cu``), in place on ``p`` and ``buf``."""
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
                           max_norm: float = 1.0):
    """The batched kernel pair (``csrc/fused_sgd.cu``), in place on ``p``
    and ``buf``."""
    _build.require_cuda("fused_sgd_batched", g, p, buf, mask, scal)
    if p.dim() != 2 or g.shape != p.shape or buf.shape != p.shape \
            or mask.numel() != p.shape[1] or tuple(scal.shape) != (p.shape[0], 3):
        raise ValueError("fused_sgd_batched: g, p, buf [G, n], mask [n] and scal [G, 3]")
    G, n = p.shape
    lib = _build.load()
    part = torch.empty(G * lib.hfl_sgd_scratch_floats(), dtype=torch.float32, device=p.device)
    _build.check(lib.hfl_fused_sgd_batched(
        g.data_ptr(), p.data_ptr(), buf.data_ptr(), mask.data_ptr(), scal.data_ptr(),
        part.data_ptr(), n, G, float(momentum), float(weight_decay), float(max_norm),
        _build.stream_of(p)), "fused_sgd_batched")
    LAUNCHES["fused_sgd_batched"] += 1
    return p, buf


def fused_sgd_batched(g, p, buf, mask, scal, *, momentum: float, weight_decay: float,
                      max_norm: float = 1.0):
    """One fused masked-SGD step of G clients, IN PLACE on ``p`` and
    ``buf`` ``[G, n]`` (returned): the plain version for CPU tensors, the
    kernel for any other (which raises rather than fall back)."""
    if p.device.type != "cpu":
        return fused_sgd_batched_cuda(g, p, buf, mask, scal, momentum=momentum,
                                      weight_decay=weight_decay, max_norm=max_norm)
    pn, bn = fused_sgd_batched_plain(g, p, buf, mask, scal, momentum=momentum,
                                     weight_decay=weight_decay, max_norm=max_norm)
    p.copy_(pn)
    buf.copy_(bn)
    return p, buf
