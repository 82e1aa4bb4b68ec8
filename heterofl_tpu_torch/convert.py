"""Parameters between the reference's layout and the port's.

The reference keeps conv kernels HWIO and linear kernels ``[in, out]``
(heterofl_tpu/ops/layers.py:12-13); the port keeps PyTorch's OIHW and
``[out, in]``.  Keys are the same on both sides (``conv1.w``,
``layer0.0.n1.g``, ``linear.b``, ...); vectors (biases, norm ``g``/``b``)
pass unchanged.  Arrays cross as numpy, so this module needs no JAX.

Checkpoint blobs hold the reference's layout, so each package reads the
other's: params through :func:`params_to_jax` / :func:`params_from_jax`,
and flat buffers (the wire codec's error-feedback residual, leaves in
sorted-key order, each a contiguous segment) through :func:`flat_to_jax` /
:func:`flat_from_jax`.  Every conversion is a permutation, so a round trip
is exact.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def params_from_jax(np_params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Reference param dict (numpy) -> port state dict (CPU float32 tensors)."""
    out = {}
    for k, v in np_params.items():
        t = torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        elif t.ndim == 2:
            t = t.t()  # [in, out] -> [out, in]
        out[k] = t.contiguous()
    return out


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port state dict -> reference param dict (numpy float32)."""
    out = {}
    for k, t in state.items():
        t = t.detach().to("cpu", torch.float32)
        if t.ndim == 4:
            t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
        elif t.ndim == 2:
            t = t.t()
        out[k] = np.ascontiguousarray(t.numpy())
    return out


# leaf axis permutations: OIHW -> HWIO and [out, in] -> [in, out], and back
_TO_JAX = {4: (2, 3, 1, 0), 2: (1, 0)}
_FROM_JAX = {4: (3, 2, 0, 1), 2: (1, 0)}


def _flat_permute(flat: np.ndarray, shapes: Dict[str, Tuple[int, ...]],
                  perms: Dict[int, Tuple[int, ...]]) -> np.ndarray:
    """Flat rows ``[..., total]`` whose leaves (``shapes``, sorted-key
    order, each a contiguous segment) are laid out in one layout -> the
    same rows with every leaf's axes permuted by ``perms[leaf.ndim]``."""
    flat = np.asarray(flat, np.float32)
    lead = flat.shape[:-1]
    keep = tuple(range(len(lead)))
    segs, off = [], 0
    for k in sorted(shapes):
        shape = tuple(shapes[k])
        size = int(np.prod(shape, dtype=np.int64))
        seg = flat[..., off:off + size].reshape(lead + shape)
        if len(shape) in perms:
            seg = seg.transpose(keep + tuple(len(lead) + a for a in perms[len(shape)]))
        segs.append(seg.reshape(lead + (size,)))
        off += size
    if off != flat.shape[-1]:
        raise ValueError(f"flat buffer of {flat.shape[-1]} entries, the shapes hold {off}")
    return np.concatenate(segs, -1)


def flat_to_jax(flat: np.ndarray, shapes: Dict[str, Tuple[int, ...]]) -> np.ndarray:
    """Flat rows ``[..., total]`` in the port's layout (``shapes`` are the
    port's leaf shapes) -> the same rows in the reference's layout."""
    return _flat_permute(flat, shapes, _TO_JAX)


def flat_from_jax(flat: np.ndarray, shapes: Dict[str, Tuple[int, ...]]) -> np.ndarray:
    """Flat rows in the reference's layout -> the port's (``shapes`` are the
    port's leaf shapes)."""
    ref = {k: tuple(s[a] for a in _TO_JAX[len(s)]) if len(s) in _TO_JAX else tuple(s)
           for k, s in shapes.items()}
    return _flat_permute(flat, ref, _FROM_JAX)
