"""PyTorch/CUDA port of heterofl-tpu, one slice at a time.

The JAX package ``heterofl_tpu`` stays the reference; this package is its
counterpart for an NVIDIA Hopper GPU (``sm_90a``).  Module names mirror the
reference so each port file sits beside its original:
``heterofl_tpu/ops/fused_update.py`` -> ``heterofl_tpu_torch/ops/fused_update.py``
and so on; the one rename is ``ops/pallas_norm.py`` -> ``ops/fused_norm.py``.

The port imports ``torch`` and numpy only -- never ``jax`` and never the
reference package (``tests/test_torch_port_import.py`` holds it to that).
Every TPU kernel on the ported path is a CUDA C++ kernel under ``csrc/``,
built at first use by :mod:`.ops._build` and bound with ``ctypes``.

Ported so far: one federated training round of the vision path (config,
synthetic data, partition, masked conv / pre-activation ResNet-18/34 with
batch norm, the fused masked-SGD epilogue, counted aggregation, the
experiment loop without evaluation).
"""

from __future__ import annotations

import torch

# The reference computes in float32 (``compute_dtype``, heterofl_tpu
# config.py:134).  cuDNN would otherwise run float32 convolutions in TF32
# (about three decimal digits), so both TF32 switches are pinned off here,
# once, for every user of the package.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(cfg) -> torch.device:
    """The device an entry point runs on: ``cfg['device']`` (default
    ``"cuda"``).  ``"cuda"`` with no CUDA device raises -- the port never
    drops to the CPU unless the caller asks for ``"cpu"``."""
    name = str(cfg.get("device", "cuda") or "cuda")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} but torch.cuda.is_available() is False; "
            f"pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Not valid device: {name!r} (cuda | cpu)")
    return dev
