"""Parameters between the reference's layout and the port's.

The reference keeps conv kernels HWIO and linear kernels ``[in, out]``
(heterofl_tpu/ops/layers.py:12-13); the port keeps PyTorch's OIHW and
``[out, in]``.  Keys are the same on both sides (``conv1.w``,
``layer0.0.n1.g``, ``linear.b``, ...); vectors (biases, norm ``g``/``b``)
pass unchanged.  Arrays cross as numpy, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict

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
