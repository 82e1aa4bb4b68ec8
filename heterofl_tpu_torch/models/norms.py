"""Norm sites of the vision models.

Port of ``heterofl_tpu/models/norms.py``: ``bn`` (batch norm, momentum
None), ``in`` (GroupNorm(C, C), unmasked), ``ln`` (GroupNorm(1, C)) and
``gn`` (GroupNorm(4, C)) -- the last two with group boundaries that follow
the client's active channel count (``ops.layers.dynamic_group_norm``) --
and ``none``.  A BN site runs in one of ``ops.layers.batch_norm``'s modes:
``"batch"`` (the training forward), ``"running"`` (evaluation with sBN
statistics) or ``"collect"`` (the sBN pass).  ``pallas_norm=True`` routes
``"batch"`` through the CUDA kernels of ``ops/fused_norm.py`` (the
counterpart of the reference's Pallas route, which takes only that mode and
only ``bn``, norms.py:44-48); otherwise, in the other modes and for the
other norms, plain PyTorch runs, the counterpart of the XLA path (the
reference has no Pallas kernel for them).  ``bn_group`` (a
``parallel.mesh.Mesh`` whose data axis splits the batch; ref norms.py:
35-50's ``bn_axis``) makes a ``"batch"`` BN site synchronised over its data
group (``fused_norm.batch_norm_sync``: its kernels on the card, its plain
versions on the CPU), whatever ``pallas_norm`` says, as the reference
bypasses Pallas there; None leaves every site as it was.

:func:`apply_norm_clients` is a site of a level's G clients on the
clients-in-channels activation ``[B, G*C, H, W]`` (the grouped engine):
``bn`` through the batched kernels (or its plain two-pass form per client
when ``pallas_norm`` is off; with ``bn_group``, a mesh whose data axis
splits each client's batch, synchronised over its data group through
``fused_norm.batch_norm_sync_clients``, whatever ``pallas_norm`` says),
``in`` as is (per sample and channel), and
``ln``/``gn`` over a block-diagonal channel-to-group map, so a group never
straddles two clients.  The sub-models are dense, so every channel is
active.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.fused_norm import batch_norm_fused, batch_norm_fused_clients, batch_norm_sync_clients
from ..ops.layers import (batch_norm, batch_norm_clients, dynamic_group_norm,
                          group_onehot_clients, instance_norm)

NORM_TYPES = ("bn", "in", "ln", "gn", "none")
#: groups of the masked group norms
NUM_GROUPS = {"ln": 1, "gn": 4}


def check_norm(norm_type: str) -> None:
    if norm_type not in NORM_TYPES:
        raise ValueError(f"Not valid norm: {norm_type!r} (control field 7, one of "
                         f"{NORM_TYPES})")


def norm_has_params(norm_type: str) -> bool:
    return norm_type != "none"


def apply_norm(norm_type: str, x: torch.Tensor, g: Optional[torch.Tensor],
               b: Optional[torch.Tensor], sample_weight: Optional[torch.Tensor] = None,
               use_fused: bool = False, bn_mode: str = "batch",
               bn_running: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               group_ops: Optional[Tuple[torch.Tensor, int, torch.Tensor]] = None,
               bn_group=None):
    """One norm site -> ``(y, collected (mean, var) or None)``.
    ``group_ops``: ``(mask [C], k, onehot [C, G])`` of the site's width
    group at the client's width (``FedModel.group_ops``), which ``ln`` and
    ``gn`` need."""
    check_norm(norm_type)
    if norm_type == "none":
        return x, None
    if norm_type == "bn":
        if bn_group is not None and bn_mode == "batch":
            return batch_norm(x, g, b, sample_weight=sample_weight, group=bn_group)
        if use_fused and bn_mode == "batch":
            return batch_norm_fused(x, g, b, sample_weight=sample_weight), None
        return batch_norm(x, g, b, sample_weight=sample_weight, mode=bn_mode,
                          running=bn_running)
    if norm_type == "in":
        return instance_norm(x, g, b), None
    mask, k, onehot = group_ops
    return dynamic_group_norm(x, g, b, NUM_GROUPS[norm_type], mask, k, onehot=onehot), None


def apply_norm_clients(norm_type: str, x: torch.Tensor, g: Optional[torch.Tensor],
                       b: Optional[torch.Tensor], G: int, sample_weight: torch.Tensor,
                       use_fused: bool = False,
                       onehot: Optional[torch.Tensor] = None, bn_group=None) -> torch.Tensor:
    """One norm site of G clients: ``x [B, G*C, H, W]``, ``g``/``b [G, C]``,
    ``sample_weight [G, B]``; ``onehot`` the ``ln``/``gn`` block-diagonal
    map (:func:`~..ops.layers.group_onehot_clients`, made when not given);
    ``bn_group`` as in :func:`apply_norm` (``in``, ``ln``, ``gn`` and
    ``none`` are per sample, so a split batch leaves them as they are)."""
    check_norm(norm_type)
    if norm_type == "none":
        return x
    if norm_type == "bn":
        if bn_group is not None:
            return batch_norm_sync_clients(x, g, b, sample_weight, bn_group)
        if use_fused:
            return batch_norm_fused_clients(x, g, b, sample_weight)
        return batch_norm_clients(x, g, b, sample_weight)
    if norm_type == "in":
        return instance_norm(x, g.reshape(-1), b.reshape(-1))
    groups = NUM_GROUPS[norm_type]
    if onehot is None:
        onehot = group_onehot_clients(x.shape[1] // G, groups, G, x.device)
    mask = torch.ones(x.shape[1], dtype=x.dtype, device=x.device)
    return dynamic_group_norm(x, g.reshape(-1), b.reshape(-1), groups * G, mask, x.shape[1],
                              onehot=onehot)
