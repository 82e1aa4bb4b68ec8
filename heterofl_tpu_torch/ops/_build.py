"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, into ``build/heterofl_tpu_torch/`` beside the package (a
directory git ignores), under a file name keyed by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is not.

Flags: no ``--use_fast_math`` and ``-fmad=false``, so every division and
square root is IEEE-rounded and no product is contracted into an FMA --
the kernels keep the reference's float32 expression order (the fused-SGD
tail matches the plain PyTorch chain bit for bit).

Each C entry returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "heterofl_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build did: seconds, library path, nvcc's -Xptxas -v report
BUILD_INFO: Dict[str, object] = {}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "hfl_bn_fwd": (_I, [_P, _P, _I, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _P]),
    "hfl_bn_bwd": (_I, [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "hfl_sgd_scratch_floats": (_LL, []),
    "hfl_fused_sgd": (_I, [_P, _P, _P, _P, _P, _P, _LL, _F, _F, _F, _P]),
    "hfl_fused_sgd_batched": (_I, [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _F, _F, _F, _I, _I,
                                   _I, _I, _P]),
    "hfl_sgd_floor": (_I, [_I, _I, _I, _LL, _I, _I, _P, _P]),
    "hfl_bn_fwd_batched": (_I, [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I,
                                _I, _I, _P]),
    "hfl_bn_bwd_batched": (_I, [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P]),
    "hfl_quant_pack": (_I, [_P, _P, _P, _LL, _I, _I, _P, _P, _P]),
    "hfl_bn_floor": (_I, [_I, _I, _I, _I, _P]),
    "hfl_bn_sync_stats": (_I, [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "hfl_bn_sync_apply": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]),
    "hfl_bn_sync_bwd_reduce": (_I, [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
    "hfl_bn_sync_bwd_apply": (_I, [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "hfl_bn_sync_stats_batched": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "hfl_bn_sync_bwd_apply_batched": (_I, [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _P]),
}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the "
                           "CUDA kernels can only be built where the CUDA toolkit is")
    return found


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(so_path: str, sources) -> None:
    exe = nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()  # staticcheck: allow(no-wallclock) the build's seconds, outside any step
    units = [s for s in sources if s.endswith(".cu")]
    tag = f"{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o") for s in units]
    procs = [subprocess.Popen([exe, *NVCC_FLAGS, "-Xptxas", "-v", "-c", s, "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s, o in zip(units, objs)]
    reports = []
    for s, p in zip(units, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(s)}:\n{out}{err}")
        reports.append(err)
    tmp = f"{so_path}.{tag}.tmp"
    link = subprocess.run([exe, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so_path)
    for o in objs:
        os.remove(o)
    # staticcheck: allow(no-wallclock) the build's seconds, outside any step
    BUILD_INFO.update(seconds=time.time() - t0, ptxas="".join(reports))


def load() -> ctypes.CDLL:
    """The kernel library, built and its C entries bound (argument types
    set) on the first call, which raises where no ``nvcc``; afterwards a
    return without the lock, and ``load().<entry>`` an attribute lookup."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        so_path = os.path.join(BUILD_DIR, f"libheterofl_kernels_{_digest(sources)}.so")
        if not os.path.exists(so_path):
            _build(so_path, sources)
        else:
            BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO["library"] = so_path
        lib = ctypes.CDLL(so_path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        raise RuntimeError(f"CUDA error {code} launching {what}")


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an integer handle
    (the raw-stream query Triton's launcher uses: no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_cuda(what: str, *tensors, rows: int = 0) -> None:
    """The kernels take CUDA float32 contiguous tensors on one device and
    nothing else; the first ``rows`` may instead be 2-D with unit-stride
    rows (views of wider rows)."""
    dev = tensors[0].get_device()
    for i, t in enumerate(tensors):
        if not t.is_cuda:
            raise RuntimeError(f"{what}: the CUDA kernel needs CUDA tensors, got {t.device}")
        if t.dtype is not torch.float32:
            raise TypeError(f"{what}: float32 only, got {t.dtype}")
        if not (t.is_contiguous() or (i < rows and t.dim() == 2 and t.stride(1) == 1)):
            raise ValueError(f"{what}: contiguous tensors only"
                             + (" (or unit-stride rows)" if i < rows else ""))
        if t.get_device() != dev:
            raise ValueError(f"{what}: tensors on cuda:{dev} and {t.device}")
