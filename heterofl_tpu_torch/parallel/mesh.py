"""The ``clients`` and ``data`` mesh axes on ``torch.distributed``.

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

The ``data`` axis (ref heterofl_tpu/parallel/mesh.py:20-48, the mesh
``devices.reshape(n_clients, n_data)``): rank ``r`` sits at clients row
``c = r // n_data`` and data column ``d = r % n_data``.  :class:`Mesh`'s
``rank`` and ``size`` stay the clients axis (``c`` of ``n_clients``, the
round's slot layout and codec participant), its ``group`` the clients
group of column ``d`` (every column computes the same sums, so each runs
the round's one all-reduce over its own column); ``data_rank``,
``data_size`` and ``data_group`` are row ``c``'s data axis, over which a
client's batch (an LM window's positions) is split and each step reduces.
Every rank calls ``dist.new_group`` for every row and every column in the
same order (a group is collective).  The data axis's collectives are
counted in :data:`DATA_COLLECTIVES`:

* :meth:`Mesh.all_reduce_sum` with ``axis="data"`` -- a step's packed
  gradient and sums, and the synchronised batch norm's moments;
* :meth:`Mesh.ring_shift` -- ring attention's K/V blocks, sent to data rank
  ``d + 1`` and received from ``d - 1``.  gloo has no ``send``/``recv`` of
  CUDA tensors, so under gloo a shift of CUDA tensors stages through pinned
  host buffers (counted again under ``ring_shift_host``); under NCCL it is
  ``dist.batch_isend_irecv`` on the device.  The ring's compute stays on
  the device either way.

:meth:`Mesh.flat` is the whole world as one clients-like axis
(``("clients", "data")`` flattened, rank ``c * n_data + d``), which the
evaluation shards over; ``axis="world"`` reduces over it too.  Barriers and
the resume broadcast go over the world; ``lead`` is world rank 0, which
writes logs and the best copy.

Deliberate difference: the reference falls back to every device when
``cfg['mesh']['clients']`` does not fit (``heterofl_tpu/entry/common.py:
247-255``).  A process-per-device world has no idle device to fall back
from -- a rank outside the axis would sit in every collective with nothing
to add -- so :func:`make_mesh` raises ``ValueError`` for any ``clients``
count other than ``world / data`` (``0`` means that, as in the
reference), and for a world ``data`` does not divide.
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

#: the data axis's calls (``all_reduce``: a step's reduction or a batch-norm
#: site's; ``ring_shift``: ring attention's shifts, ``ring_shift_host`` those
#: staged through host memory) and payload bytes
DATA_COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "ring_shift": 0, "ring_shift_host": 0}
DATA_COLLECTIVE_BYTES: Dict[str, int] = {"all_reduce": 0, "ring_shift": 0,
                                         "ring_shift_host": 0}

#: torchrun's variables, read by :func:`initialize_distributed`
ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def reset_counts() -> None:
    """Every collective count and byte sum back to 0."""
    for d in (COLLECTIVES, COLLECTIVE_BYTES, DATA_COLLECTIVES, DATA_COLLECTIVE_BYTES):
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
        _GROUPS.clear()
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
    """The ``clients`` axis: this process's ``rank`` of ``size`` (its
    clients row), the clients group of its data column (None: one process,
    no collective runs), the rank's ``device`` and the group's backend;
    and its row's ``data`` axis: ``data_rank`` of ``data_size``, the data
    group (None at ``data_size`` 1), and the world group."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    backend: Optional[str] = None
    data_rank: int = 0
    data_size: int = 1
    data_group: Any = None
    world_group: Any = None

    @property
    def distributed(self) -> bool:
        return self.group is not None or self.data_group is not None

    @property
    def client_rank(self) -> int:
        return self.rank

    @property
    def client_size(self) -> int:
        return self.size

    @property
    def world_rank(self) -> int:
        return self.rank * self.data_size + self.data_rank

    @property
    def world_size(self) -> int:
        return self.size * self.data_size

    @property
    def lead(self) -> bool:
        """World rank 0: the rank that writes logs, the header and the best copy."""
        return self.world_rank == 0

    def _world(self):
        return self.group if self.world_group is None else self.world_group

    def flat(self) -> "Mesh":
        """The whole world as one axis, rank ``c * data_size + d`` (the
        reference's ``("clients", "data")``, which the evaluation shards
        over); at ``data_size`` 1 the mesh itself."""
        if self.data_size == 1:
            return self
        return Mesh(rank=self.world_rank, size=self.world_size, device=self.device,
                    group=self._world(), backend=self.backend)

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's block of ``n`` items (:func:`block_bounds`)."""
        return block_bounds(n, self.size, self.rank)

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor], axis: str = "clients"
                       ) -> List[torch.Tensor]:
        """The sum over the ranks of ``axis`` (``clients``: this column's
        clients group, counted in :data:`COLLECTIVES`; ``data``: this row's
        data group, counted in :data:`DATA_COLLECTIVES`; ``world``: every
        rank, counted as ``clients``) of each tensor, in ONE collective: the
        tensors are packed into one contiguous buffer (``[2, total]`` for the
        round's update sums and counts), reduced, and returned as views of
        it in their shapes.  Tensors of one dtype reduce in it.  A mix of
        float32 and int32 (the signsgd payload's lanes and scales, the
        grouped engine's per-level payloads) reduces in float32: the floats
        at their own width, each int32 word as its two 16-bit halves, whose
        sums over at most 256 ranks float32 holds exactly; the halves are
        joined and wrap to int32 as the reference's int32 ``psum`` does.
        Without a group the tensors come back as they are."""
        if axis not in ("clients", "data", "world"):
            raise ValueError(f"Not valid mesh axis: {axis!r} (clients | data | world)")
        counts, nbytes = (DATA_COLLECTIVES, DATA_COLLECTIVE_BYTES) if axis == "data" \
            else (COLLECTIVES, COLLECTIVE_BYTES)
        counts["all_reduce"] += 1
        nbytes["all_reduce"] += sum(t.numel() * t.element_size() for t in tensors)
        group, size = {"clients": (self.group, self.size),
                       "data": (self.data_group, self.data_size),
                       "world": (self._world(), self.world_size)}[axis]
        if group is None:
            return list(tensors)
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) == 1:
            buf = torch.cat([t.reshape(-1) for t in tensors])
            _dist().all_reduce(buf, group=group)
            return [part.view(t.shape) for part, t in zip(buf.split([t.numel() for t in tensors]),
                                                          tensors)]
        if not dtypes <= {torch.float32, torch.int32} or size > 256:
            raise ValueError(f"a mixed all-reduce takes float32 and int32 over at most 256 "
                             f"ranks (got {sorted(map(str, dtypes))} over {size})")
        parts = []
        for t in tensors:
            flat = t.reshape(-1)
            if t.dtype == torch.int32:  # low and high halves, each exact in float32
                parts += [(flat & 0xFFFF).to(torch.float32), (flat >> 16).to(torch.float32)]
            else:
                parts.append(flat)
        buf = torch.cat(parts)
        _dist().all_reduce(buf, group=group)
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
        """World rank 0's ``value`` on every rank."""
        COLLECTIVES["broadcast"] += 1
        COLLECTIVE_BYTES["broadcast"] += 8
        if not self.distributed:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        _dist().broadcast(t, src=0, group=self._world())
        # staticcheck: allow(no-device-get) one int, at a resume
        return int(t.item())

    def barrier(self) -> None:
        """Wait for every rank of the world (the sharded checkpoint's order)."""
        COLLECTIVES["barrier"] += 1
        if self.distributed:
            if self.backend == "nccl":
                _dist().barrier(group=self._world(), device_ids=[self.device.index or 0])
            else:
                _dist().barrier(group=self._world())

    def ring_shift(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor sent to data rank ``d + 1`` and received from ``d -
        1`` (cyclically; ring attention's neighbour exchange), the tensors
        packed into one buffer: one send and one receive a call.  Under
        gloo a CUDA payload goes through pinned host buffers (gloo has no
        ``send``/``recv`` of CUDA tensors); under NCCL it stays on the
        device.  Without a data group the tensors come back as they are."""
        nb = sum(t.numel() * t.element_size() for t in tensors)
        DATA_COLLECTIVES["ring_shift"] += 1
        DATA_COLLECTIVE_BYTES["ring_shift"] += nb
        if self.data_group is None:
            return list(tensors)
        dist = _dist()
        buf = torch.cat([t.reshape(-1) for t in tensors])
        host = buf.is_cuda and self.backend != "nccl"
        if host:
            DATA_COLLECTIVES["ring_shift_host"] += 1
            DATA_COLLECTIVE_BYTES["ring_shift_host"] += nb
            send = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            send.copy_(buf)
        else:
            send = buf
        recv = torch.empty_like(send)
        row = self.rank * self.data_size
        nxt = row + (self.data_rank + 1) % self.data_size
        prv = row + (self.data_rank - 1) % self.data_size
        ops = [dist.P2POp(dist.isend, send, nxt, group=self.data_group),
               dist.P2POp(dist.irecv, recv, prv, group=self.data_group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if host:
            recv = recv.to(buf.device)
        return [part.view(t.shape) for part, t in zip(recv.split([t.numel() for t in tensors]),
                                                      tensors)]


def single_mesh(device: torch.device) -> Mesh:
    """The one-process mesh: rank 0 of 1, no group."""
    return Mesh(rank=0, size=1, device=torch.device(device))


#: the row and column groups made for each layout of the joined world,
#: ``{(n_clients, n_data): (rows, columns)}`` (a group is made once: each
#: ``new_group`` is a collective every rank calls in the same order)
_GROUPS: Dict[Tuple[int, int], Tuple[list, list]] = {}


def _axis_groups(n: int, n_data: int) -> Tuple[list, list]:
    """The data groups of every clients row and the clients groups of every
    data column, made by every rank in this order (rows, then columns)."""
    if (n, n_data) not in _GROUPS:
        dist = _dist()
        rows = [dist.new_group([c * n_data + d for d in range(n_data)]) for c in range(n)]
        cols = [dist.new_group([c * n_data + d for c in range(n)]) for d in range(n_data)]
        _GROUPS[(n, n_data)] = (rows, cols)
    return _GROUPS[(n, n_data)]


def make_mesh(n_clients: int = 0, n_data: int = 1, n_arms: int = 1,
              device: torch.device = torch.device("cpu")) -> Mesh:
    """The ``(clients, data)`` mesh over the joined group (or one process
    without a group): ``n_data`` must divide the world, and ``n_clients`` 0
    means ``world / n_data``; any other count must be that (the module's
    deliberate difference).  ``device`` is the kind of device (``cpu`` or
    ``cuda``); the mesh's is the rank's (:func:`rank_device`).  An ``arms``
    axis is not ported."""
    if int(n_arms) > 1:
        raise NotImplementedError(
            f"mesh arms axis of {n_arms}: the arms mesh placement is not ported yet "
            f"(ROADMAP Queue 1 item 5, the arms axis)")
    dist = _dist()
    size = dist.get_world_size() if joined() else 1
    n_data = int(n_data or 1)
    if n_data < 1 or size % n_data:
        raise ValueError(f"mesh data={n_data} with a world of {size} rank(s): data={n_data} "
                         f"does not divide the world; launch torchrun with a multiple of "
                         f"{n_data} ranks")
    want = size // n_data
    n = int(n_clients or 0)
    if n < 0 or (n and n != want):
        raise ValueError(
            f"mesh clients={n_clients} with a world of {size} rank(s) and data={n_data}: each "
            f"rank is one process holding one device, so the clients axis is world / data "
            f"(0 or {want}); launch torchrun with --nproc_per_node={max(n, 1) * n_data} for "
            f"{n} x {n_data} ranks")
    dev = rank_device(device)
    if not joined():
        return single_mesh(dev)
    backend = dist.get_backend()
    if n_data == 1:
        return Mesh(rank=dist.get_rank(), size=size, device=dev, group=dist.group.WORLD,
                    backend=backend)
    rows, cols = _axis_groups(want, n_data)
    c, d = divmod(dist.get_rank(), n_data)
    return Mesh(rank=c, size=want, device=dev, group=cols[d], backend=backend, data_rank=d,
                data_size=n_data, data_group=rows[c], world_group=dist.group.WORLD)


def mesh_of_cfg(cfg: Dict[str, Any], device: torch.device) -> Mesh:
    """:func:`make_mesh` from ``cfg['mesh']`` (``{"clients": 0, "data":
    1}`` by default, as the reference's)."""
    spec = cfg.get("mesh") or {}
    return make_mesh(spec.get("clients", 0) or 0, spec.get("data", 1) or 1,
                     spec.get("arms", 1) or 1, device)
