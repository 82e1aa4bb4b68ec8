"""Parameters between the reference's layout and the port's.

The reference keeps conv kernels HWIO and linear kernels ``[in, out]``
(heterofl_tpu/ops/layers.py:12-13); the port keeps PyTorch's OIHW and
``[out, in]``.  Keys are the same on both sides (``conv1.w``,
``layer0.0.n1.g``, ``linear.b``, ...); vectors (biases, norm ``g``/``b``)
and tables (the transformer's embeddings, ``[rows, E]`` on both sides)
pass unchanged.  Which leaves are kernels is the model's knowledge
(``FedModel.jax_perms``); the default, by rank, is the vision models'.
Arrays cross as numpy, so this module needs no JAX.

Checkpoint blobs hold the reference's layout, so each package reads the
other's: params through :func:`params_to_jax` / :func:`params_from_jax`,
and flat buffers (the wire codec's error-feedback residual, leaves in
sorted-key order, each a contiguous segment) through :func:`flat_to_jax` /
:func:`flat_from_jax`.  Every conversion is a permutation, so a round trip
is exact.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

#: the axis permutation from the port's layout to the reference's, by rank:
#: OIHW -> HWIO and [out, in] -> [in, out]
RANK_PERMS = {4: (2, 3, 1, 0), 2: (1, 0)}

Perms = Dict[str, Tuple[int, ...]]


def rank_perms(shapes: Dict[str, Tuple[int, ...]]) -> Perms:
    """Every 4-D leaf a conv kernel and every 2-D leaf a linear kernel: the
    layout of the conv net and the ResNets (``FedModel.jax_perms``), and
    the conversions' default.  A model with other 2-D leaves (the
    transformer's embedding tables) passes its own ``perms``."""
    return {k: RANK_PERMS[len(s)] for k, s in shapes.items() if len(s) in RANK_PERMS}


def _inverse(perm: Tuple[int, ...]) -> Tuple[int, ...]:
    inv = [0] * len(perm)
    for i, a in enumerate(perm):
        inv[a] = i
    return tuple(inv)


def params_from_jax(np_params: Dict[str, np.ndarray], perms: Optional[Perms] = None
                    ) -> Dict[str, torch.Tensor]:
    """Reference param dict (numpy) -> port state dict (CPU float32
    tensors).  ``perms``: the model's port-to-reference permutation per leaf
    (``model.jax_perms()``; default :func:`rank_perms`)."""
    if perms is None:
        perms = rank_perms({k: np.shape(v) for k, v in np_params.items()})
    out = {}
    for k, v in np_params.items():
        t = torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        if k in perms:
            t = t.permute(_inverse(perms[k]))
        out[k] = t.contiguous()
    return out


def params_to_jax(state: Dict[str, torch.Tensor], perms: Optional[Perms] = None
                  ) -> Dict[str, np.ndarray]:
    """Port state dict -> reference param dict (numpy float32)."""
    if perms is None:
        perms = rank_perms({k: tuple(t.shape) for k, t in state.items()})
    out = {}
    for k, t in state.items():
        t = t.detach().to("cpu", torch.float32)
        if k in perms:
            t = t.permute(perms[k])
        out[k] = np.ascontiguousarray(t.numpy())
    return out


def _flat_permute(flat: np.ndarray, shapes: Dict[str, Tuple[int, ...]], perms: Perms
                  ) -> np.ndarray:
    """Flat rows ``[..., total]`` whose leaves (``shapes``, sorted-key
    order, each a contiguous segment) are laid out in one layout -> the
    same rows with each leaf in ``perms`` permuted by it."""
    flat = np.asarray(flat, np.float32)
    lead = flat.shape[:-1]
    keep = tuple(range(len(lead)))
    segs, off = [], 0
    for k in sorted(shapes):
        shape = tuple(shapes[k])
        size = int(np.prod(shape, dtype=np.int64))
        seg = flat[..., off:off + size].reshape(lead + shape)
        if k in perms:
            seg = seg.transpose(keep + tuple(len(lead) + a for a in perms[k]))
        segs.append(seg.reshape(lead + (size,)))
        off += size
    if off != flat.shape[-1]:
        raise ValueError(f"flat buffer of {flat.shape[-1]} entries, the shapes hold {off}")
    return np.concatenate(segs, -1)


def flat_to_jax(flat: np.ndarray, shapes: Dict[str, Tuple[int, ...]],
                perms: Optional[Perms] = None) -> np.ndarray:
    """Flat rows ``[..., total]`` in the port's layout (``shapes`` are the
    port's leaf shapes) -> the same rows in the reference's layout."""
    return _flat_permute(flat, shapes, rank_perms(shapes) if perms is None else perms)


def flat_from_jax(flat: np.ndarray, shapes: Dict[str, Tuple[int, ...]],
                  perms: Optional[Perms] = None) -> np.ndarray:
    """Flat rows in the reference's layout -> the port's (``shapes`` are the
    port's leaf shapes)."""
    perms = rank_perms(shapes) if perms is None else perms
    ref = {k: tuple(s[a] for a in perms[k]) if k in perms else tuple(s)
           for k, s in shapes.items()}
    return _flat_permute(flat, ref, {k: _inverse(p) for k, p in perms.items()})
