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

Ported so far: the vision path's experiment lifecycle (config in both
rate modes, ``fix`` and ``dynamic``; synthetic data and the on-disk
MNIST/FashionMNIST/EMNIST/CIFAR readers with computed normalisation
statistics; partition; masked conv / pre-activation ResNet-18/34 and the
bottleneck ResNet-50/101/152 under the ``bn``, ``in``, ``ln``, ``gn`` and
``none`` norms; the fused masked-SGD epilogue, counted aggregation, the
wire codecs, sBN and Local/Global evaluation, the logger, checkpoints in
the reference's format with resume and the best copy, the test entries,
and the centralised baseline), and the masked-LM path on top of it (token
datasets, the transformer with per-head width slicing and the
width-geometry check, Global-Perplexity evaluation, its federated, test
and centralised entries); the grouped engine and the K-round superstep;
bfloat16 compute (``compute_dtype``), the im2col convolution
(``conv_impl``) and the grouped engine's per-level wire-codec map; the
client scheduler (``sched/``: availability traces, deadline stragglers,
buffered aggregation, client failures); the streaming client store; and
observability and its guards (``obs/``: health probes and cohort
histograms, the watchdog with abort and rollback, the update quarantine,
the client ledger and its report, run tracing and profiles; ``chaos/``:
the poisoned updates that prove them).
"""

from __future__ import annotations

import torch

# The reference computes in float32 (``compute_dtype``, heterofl_tpu
# config.py:134).  cuDNN would otherwise run float32 convolutions in TF32
# (about three decimal digits), so both TF32 switches are pinned off here,
# once, for every user of the package.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
# ``compute_dtype='bfloat16'`` multiplies bf16 operands and accumulates the
# products in float32, as the reference does ("XLA:TPU accumulates bf16
# convs in f32", heterofl_tpu/ops/layers.py:74).  cuBLAS may otherwise
# reduce a bf16 GEMM's split-K partial sums in bf16, so that is pinned off
# too.  cuDNN's bf16 convolutions accumulate in float32 (PERF.md).
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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
