"""The ``clients`` mesh axis on ``torch.distributed``.

Port of ``heterofl_tpu/parallel/mesh.py``.  The reference lays a round's
clients over a ``clients`` axis of a ``jax.sharding.Mesh`` and reduces the
round with one ``psum``; here each rank is one process holding one device,
the axis is the process group, and the reduction is one
``torch.distributed.all_reduce`` (NCCL on ``cuda``, gloo on the CPU).  The
entries run under ``torchrun --nproc_per_node=N -m
heterofl_tpu_torch.entry.train_classifier_fed ...``;
:func:`initialize_distributed` reads torchrun's variables and joins the
group.  Without them it joins nothing, and every run is the one-process
run as before.

:class:`Mesh` carries the rank, the size, the group and the rank's device.
Its collectives go through thin wrappers, each adding one to its count in
:data:`COLLECTIVES` per call (and the payload's bytes to
:data:`COLLECTIVE_BYTES`) whether or not a group is joined, so the audit
and ``chip_smoke.py`` read one all-reduce a round on one process too:

* :meth:`Mesh.all_reduce_sum` -- the round's one reduction, of a list of
  tensors packed into one contiguous buffer;
* :meth:`Mesh.gather_rows` -- per-slot metric rows, every rank's block in
  rank order, onto every rank (an all-gather, so every rank's experiment
  loop reads the same history);
* :meth:`Mesh.broadcast_int` -- rank 0's int (the resumed epoch);
* :meth:`Mesh.barrier` -- the sharded checkpoint's ordering.

The tensors go to the collective where they live: NCCL takes CUDA
tensors, and gloo takes CPU tensors and, in this PyTorch, CUDA ones too
(the probe's two gloo ranks on one GPU; ``parallel/pod.py::
gloo_cuda_check`` records it on each run), so no wrapper copies to the
host.

Deliberate difference: the reference falls back to every device when
``cfg['mesh']['clients']`` does not fit (``heterofl_tpu/entry/common.py:
247-255``).  A process-per-device world has no idle device to fall back
from -- a rank outside the axis would sit in every collective with nothing
to add -- so :func:`make_mesh` raises ``ValueError`` for any ``clients``
count other than the world size (``0`` means every rank, as in the
reference).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

#: calls of each collective wrapper (the audit's and chip_smoke.py's counts)
COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "gather": 0, "broadcast": 0, "barrier": 0}
#: the payload bytes each wrapper handed its collective, summed over calls
COLLECTIVE_BYTES: Dict[str, int] = {"all_reduce": 0, "gather": 0, "broadcast": 0,
                                    "barrier": 0}

#: torchrun's variables, read by :func:`initialize_distributed`
ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def reset_counts() -> None:
    """Every collective count and byte sum back to 0."""
    for d in (COLLECTIVES, COLLECTIVE_BYTES):
        for k in d:
            d[k] = 0


def _dist():
    import torch.distributed as dist

    return dist


def joined() -> bool:
    """Whether this process is in a process group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK`` (0 without it): the index of this rank's
    device on its host."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def initialize_distributed(backend: Optional[str] = None, device: str = "cuda") -> bool:
    """Join the process group torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) ->
    whether a group is joined.  ``backend`` defaults to NCCL for a
    ``cuda`` device and gloo for the CPU; an explicit one is for two ranks
    sharing one GPU (``parallel/pod.py``: NCCL refuses two ranks on one
    device).  On ``cuda`` the rank's device becomes ``cuda:LOCAL_RANK``
    first.  Without ``RANK`` and ``WORLD_SIZE`` it joins nothing (the
    one-process run); a group joined already is kept."""
    if joined():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    missing = [v for v in ("MASTER_ADDR", "MASTER_PORT") if not os.environ.get(v)]
    if missing:
        raise RuntimeError(f"RANK and WORLD_SIZE are set but {missing} are not: torchrun "
                           f"sets all of {ENV_VARS}")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"Not valid backend: {backend!r} (nccl | gloo)")
    if dev.type == "cuda":
        torch.cuda.set_device(_cuda_index())
    _dist().init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if one is joined: every rank waits for the
    others first, so none tears its connections down while a peer still
    talks over them."""
    if joined():
        _dist().barrier()
        _dist().destroy_process_group()


def _cuda_index() -> int:
    """``LOCAL_RANK``, or 0 where the host has fewer GPUs than that (the
    probe's two gloo ranks on one GPU)."""
    return local_rank() if local_rank() < torch.cuda.device_count() else 0


def rank_device(device: torch.device) -> torch.device:
    """The device of this rank: in a group, ``cuda:LOCAL_RANK`` on
    ``cuda`` (:func:`_cuda_index`); outside one, or on the CPU, the device
    as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not joined():
        return device
    return torch.device("cuda", _cuda_index())


def block_bounds(n: int, size: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s contiguous block ``[lo, hi)`` of ``n`` items over
    ``size`` ranks, ``ceil(n / size)`` a rank (the last ones shorter or
    empty): the reference's layout of an axis padded to a multiple of the
    mesh and split over it."""
    per = -(-n // size) if n else 0
    lo = min(n, rank * per)
    return lo, min(n, lo + per)


def reduce_buffer_bytes(tensors: Sequence[torch.Tensor]) -> int:
    """The bytes of the one buffer :meth:`Mesh.all_reduce_sum` reduces for
    ``tensors`` at several ranks: their own bytes, but 8 for each int32
    word of a mixed float32 / int32 payload (its two halves in float32)."""
    mixed = len({t.dtype for t in tensors}) > 1
    return sum(t.numel() * (8 if mixed and t.dtype == torch.int32 else t.element_size())
               for t in tensors)


@dataclass
class Mesh:
    """The ``clients`` axis: this process's ``rank`` of ``size``, the
    group (None: one process, no collective runs), the rank's ``device``
    and the group's backend."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    backend: Optional[str] = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's block of ``n`` items (:func:`block_bounds`)."""
        return block_bounds(n, self.size, self.rank)

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the ranks of each tensor, in ONE collective: the
        tensors are packed into one contiguous buffer (``[2, total]`` for the
        round's update sums and counts), reduced, and returned as views of
        it in their shapes.  Tensors of one dtype reduce in it.  A mix of
        float32 and int32 (the signsgd payload's lanes and scales, the
        grouped engine's per-level payloads) reduces in float32: the floats
        at their own width, each int32 word as its two 16-bit halves, whose
        sums over at most 256 ranks float32 holds exactly; the halves are
        joined and wrap to int32 as the reference's int32 ``psum`` does.
        Without a group the tensors come back as they are."""
        COLLECTIVES["all_reduce"] += 1
        COLLECTIVE_BYTES["all_reduce"] += sum(t.numel() * t.element_size() for t in tensors)
        if not self.distributed:
            return list(tensors)
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) == 1:
            buf = torch.cat([t.reshape(-1) for t in tensors])
            _dist().all_reduce(buf, group=self.group)
            return [part.view(t.shape) for part, t in zip(buf.split([t.numel() for t in tensors]),
                                                          tensors)]
        if not dtypes <= {torch.float32, torch.int32} or self.size > 256:
            raise ValueError(f"a mixed all-reduce takes float32 and int32 over at most 256 "
                             f"ranks (got {sorted(map(str, dtypes))} over {self.size})")
        parts = []
        for t in tensors:
            flat = t.reshape(-1)
            if t.dtype == torch.int32:  # low and high halves, each exact in float32
                parts += [(flat & 0xFFFF).to(torch.float32), (flat >> 16).to(torch.float32)]
            else:
                parts.append(flat)
        buf = torch.cat(parts)
        _dist().all_reduce(buf, group=self.group)
        out, off = [], 0
        for t in tensors:
            n = t.numel()
            if t.dtype == torch.int32:
                lo, hi = buf[off:off + n].to(torch.int64), buf[off + n:off + 2 * n].to(torch.int64)
                word = (hi * 65536 + lo + 2 ** 31) % 2 ** 32 - 2 ** 31
                out.append(word.to(torch.int32).view(t.shape))
                off += 2 * n
            else:
                out.append(buf[off:off + n].view(t.shape))
                off += n
        return out

    def gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's ``rows`` (``[m, ...]``, the same ``m`` on every
        rank) stacked in rank order, ``[size * m, ...]``, on every rank:
        one all-gather.  Without a group, ``rows`` itself."""
        COLLECTIVES["gather"] += 1
        COLLECTIVE_BYTES["gather"] += rows.numel() * rows.element_size()
        if not self.distributed:
            return rows
        src = rows.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        _dist().all_gather(parts, src, group=self.group)
        return torch.cat(parts)

    def broadcast_int(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        COLLECTIVES["broadcast"] += 1
        COLLECTIVE_BYTES["broadcast"] += 8
        if not self.distributed:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        _dist().broadcast(t, src=0, group=self.group)
        # staticcheck: allow(no-device-get) one int, at a resume
        return int(t.item())

    def barrier(self) -> None:
        """Wait for every rank (the sharded checkpoint's order)."""
        COLLECTIVES["barrier"] += 1
        if self.distributed:
            if self.backend == "nccl":
                _dist().barrier(group=self.group, device_ids=[self.device.index or 0])
            else:
                _dist().barrier(group=self.group)


def single_mesh(device: torch.device) -> Mesh:
    """The one-process mesh: rank 0 of 1, no group."""
    return Mesh(rank=0, size=1, device=torch.device(device))


def make_mesh(n_clients: int = 0, n_data: int = 1, n_arms: int = 1,
              device: torch.device = torch.device("cpu")) -> Mesh:
    """The ``clients`` mesh over the joined group (or one process without
    a group): ``n_clients`` 0 means every rank; any other count must be
    the world size (the module's deliberate difference).  ``device`` is
    the kind of device (``cpu`` or ``cuda``); the mesh's is the rank's
    (:func:`rank_device`).  A ``data`` or ``arms`` axis is not ported."""
    if int(n_data) > 1:
        raise NotImplementedError(
            f"mesh data axis of {n_data}: the data axis with synchronised batch norm is not "
            f"ported yet (ROADMAP Queue 1 item 5, the data axis)")
    if int(n_arms) > 1:
        raise NotImplementedError(
            f"mesh arms axis of {n_arms}: the arms mesh placement is not ported yet "
            f"(ROADMAP Queue 1 item 5, the arms axis)")
    dist = _dist()
    size = dist.get_world_size() if joined() else 1
    n = int(n_clients or 0)
    if n < 0 or (n and n != size):
        raise ValueError(
            f"mesh clients={n_clients} with a world of {size} rank(s): each rank is one "
            f"process holding one device, so the clients axis is every rank (0 or {size}); "
            f"launch torchrun with --nproc_per_node={n} for {n} ranks")
    dev = rank_device(device)
    if not joined():
        return single_mesh(dev)
    return Mesh(rank=dist.get_rank(), size=size, device=dev, group=dist.group.WORLD,
                backend=dist.get_backend())


def mesh_of_cfg(cfg: Dict[str, Any], device: torch.device) -> Mesh:
    """:func:`make_mesh` from ``cfg['mesh']`` (``{"clients": 0, "data":
    1}`` by default, as the reference's)."""
    spec = cfg.get("mesh") or {}
    return make_mesh(spec.get("clients", 0) or 0, spec.get("data", 1) or 1,
                     spec.get("arms", 1) or 1, device)
