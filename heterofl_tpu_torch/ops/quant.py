"""Lane packing and the int8 codec's quantise-and-pack pass.

Port of ``heterofl_tpu/ops/quant.py``.  Lane packing puts ``32 //
lane_bits`` small non-negative integers into the sub-fields of one int32
word, flat order preserved; adding packed words adds the lanes as long as no
lane sum outgrows its bits (the codecs size their lanes for that), which is
what lets one integer all-reduce carry a compressed payload.

The quantise-and-pack pass, whose TPU kernel (``_quant_pack_kernel``) is
``csrc/quant.cu`` here, computes per element

    q = clamp(floor(x / s + u), -qmax, qmax)          # int32
    words = pack_lanes(q + bias, 8)

with the noise ``u`` a kernel input (tests inject the reference's draw).
:func:`quant_pack_plain` is its plain PyTorch version, in the reference's
expression order; both pad the last word with zero lanes, as the reference's
XLA path does.  (The reference's Pallas path leaves ``bias`` in those
padding lanes; decoding keeps only the first ``n`` lanes, so the values
agree either way.)  :func:`quantize_pack` takes the plain version for a CPU
tensor and the kernel for a CUDA tensor; :data:`LAUNCHES` counts kernel
launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

#: launches of :func:`quant_pack_cuda`
LAUNCHES = {"quant_pack": 0}


def pack_lanes(q: torch.Tensor, lane_bits: int) -> torch.Tensor:
    """Pack flat int32 values ``q`` (each in ``[0, 2**lane_bits)``) into
    int32 words, ``32 // lane_bits`` consecutive values per word, the tail
    padded with zero lanes.  The word is built in int64 and wrapped to int32
    explicitly, so the top lane's shift never overflows a signed type."""
    per = 32 // lane_bits
    pad = (-q.numel()) % per
    q = q.to(torch.int64)
    if pad:
        q = torch.cat([q, q.new_zeros(pad)])
    q = q.view(-1, per)
    w = q[:, 0].clone()
    for i in range(1, per):
        w |= q[:, i] << (i * lane_bits)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_lanes(w: torch.Tensor, lane_bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_lanes` on (possibly summed) words: the first
    ``n`` int32 lane values."""
    per = 32 // lane_bits
    mask = (1 << lane_bits) - 1
    w = w.to(torch.int64) & 0xFFFFFFFF
    cols = [(w >> (i * lane_bits)) & mask for i in range(per)]
    return torch.stack(cols, dim=1).reshape(-1)[:n].to(torch.int32)


def stochastic_round(x: torch.Tensor, u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Unbiased stochastic rounding ``floor(x + u)``, ``u ~ U[0, 1)``: the
    given noise ``u``, or a draw from ``generator`` on ``x``'s device."""
    if u is None:
        u = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return torch.floor(x + u)


def quant_pack_plain(x: torch.Tensor, s: torch.Tensor, u: torch.Tensor, qmax: int,
                     bias: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel -> ``(words [ceil(n/4)], q [n])``."""
    q = torch.clamp(stochastic_round(x / s, u), -qmax, qmax).to(torch.int32)
    return pack_lanes(q + bias, 8), q


def quant_pack_cuda(x: torch.Tensor, s: torch.Tensor, u: torch.Tensor, qmax: int,
                    bias: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel (``csrc/quant.cu``) on CUDA tensors -> ``(words, q)``."""
    _build.require_cuda("quant_pack", x, s, u)
    n = x.numel()
    if s.numel() != n or u.numel() != n:
        raise ValueError("quant_pack: x, s and u must have one size")
    if not (0 < qmax < bias <= 255 - qmax):
        raise ValueError(f"quant_pack: lanes of 8 bits need 0 < qmax < bias <= 255 - qmax, "
                         f"got qmax={qmax}, bias={bias}")
    q = torch.empty(n, dtype=torch.int32, device=x.device)
    words = torch.empty((n + 3) // 4, dtype=torch.int32, device=x.device)
    if any(t.data_ptr() % 16 for t in (x, s, u, q, words)):
        raise ValueError("quant_pack: buffers must be 16-byte aligned")
    lib = _build.load()
    _build.check(lib.hfl_quant_pack(x.data_ptr(), s.data_ptr(), u.data_ptr(), n, int(qmax),
                                    int(bias), q.data_ptr(), words.data_ptr(),
                                    _build.stream_of(x)), "quant_pack")
    LAUNCHES["quant_pack"] += 1
    return words, q


def quantize_pack(x: torch.Tensor, s: torch.Tensor, u: torch.Tensor, qmax: int,
                  bias: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-round ``x / s`` onto ``[-qmax, qmax]``, bias to unsigned
    and pack 4 values per int32 word -> ``(words, q)``; ``q`` is the signed
    grid value the encoder needs for its error-feedback residual.  The plain
    version for CPU tensors, the kernel for any other (which raises rather
    than fall back)."""
    if x.device.type == "cpu":
        return quant_pack_plain(x, s, u, qmax, bias)
    return quant_pack_cuda(x, s, u, qmax, bias)
