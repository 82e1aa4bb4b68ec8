"""The wire codecs on flat tensors.

Port of ``heterofl_tpu/compress/codecs.py``.  A codec turns one
participant's flat ``(sums, counts)`` contribution -- the layout of
:class:`~..ops.fused_update.FlatSpec`, leaves in sorted-key order -- into a
payload, and decodes the payload summed over participants back to flat sums
and counts.  :func:`compressed_sum` is the one-GPU form of the reference's
``compressed_psum``: encode, the sum over participants, decode.  With one
participant the sum is the payload itself; the multi-GPU slice puts an
``all_reduce`` between the two steps.

The contract every codec keeps:

* the decoder needs nothing outside the payload but what every participant
  already holds -- the global params (the int8 grid) and the round's seed
  (the topk block);
* the encoder knows what the decoder will attribute to it, so the
  error-feedback residual is ``e' = (x + e) - decode(encode(x + e))``; with
  ``error_feedback=False`` it stays zero.

Randomness (the int8 rounding noise, the topk block) comes from a
``torch.Generator`` seeded from (round seed, salt, participant index), the
salts being the reference's.  ``jax.random`` streams cannot be reproduced in
torch, so each codec's :meth:`draw` result can be replaced by the
reference's (the round engine's ``codec_noise`` and ``topk_offset``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import (COUNT_LANE_BITS, SIGN_LANE_BITS, TOPK_BLOCKS, VALUE_LANE_BITS,
               codec_payload_bytes, resid_slots)
from ..ops.quant import pack_lanes, quantize_pack, unpack_lanes

#: seed salts of the codec streams (the reference's)
QUANT_NOISE_SALT = 9173
TOPK_BLOCK_SALT = 9177


def codec_seed(round_seed: int, salt: int, index: int = 0) -> int:
    """Seed of a codec stream in one round, for participant ``index``."""
    return int(np.random.SeedSequence([int(round_seed), int(salt), int(index)]
                                      ).generate_state(1)[0])


class WireCodec:
    """Shared scaffolding: flat layout, participant count, lane checks."""

    name = "?"

    def __init__(self, spec, participants: int, error_feedback: bool = True):
        self.spec = spec
        self.p = int(participants)
        self.ef = bool(error_feedback)
        self.resid_slots = resid_slots(self.name)

    def payload_bytes(self) -> int:
        return codec_payload_bytes(self.name, self.spec.total, len(self.spec.names))

    def draw(self, round_seed: int, device: torch.device, index: int = 0):
        """The round's random input of the codec (None: it has none)."""
        return None

    def _leaf_expand(self, per_leaf: torch.Tensor) -> torch.Tensor:
        """``[n_leaves]`` -> flat ``[total]``, each leaf's value over its
        segment."""
        dev = per_leaf.device
        if getattr(self, "_sizes", None) is None or self._sizes.device != dev:
            # made once: a copy to the card per round would wait for it
            self._sizes = torch.tensor([self.spec.sizes[k] for k in self.spec.names], device=dev)
        return torch.repeat_interleave(per_leaf, self._sizes, output_size=self.spec.total)

    def _check_count_capacity(self, cmax: int, lane_bits: int) -> None:
        """Counts ride exact integer lanes: the lane sum over participants
        (at most participants x clients each) must fit ``lane_bits``."""
        if self.p * cmax > (1 << lane_bits) - 1:
            raise ValueError(
                f"wire codec {self.name!r}: count lanes overflow -- {self.p} participants x "
                f"{cmax} clients/device exceeds the {lane_bits}-bit lane capacity "
                f"{(1 << lane_bits) - 1}; shrink the per-round cohort or use the dense codec")

    def _count_words(self, cnts: torch.Tensor) -> torch.Tensor:
        return pack_lanes(torch.round(cnts).to(torch.int32), COUNT_LANE_BITS)

    def _counts(self, words: torch.Tensor) -> torch.Tensor:
        return unpack_lanes(words, COUNT_LANE_BITS, self.spec.total).to(torch.float32)


class Int8Codec(WireCodec):
    """Per-leaf stochastic-rounding quantisation with integer accumulation.

    Each value is rounded onto a per-leaf grid whose scale comes from the
    global params (``cmax * max|P_leaf|`` bounds a partial sum of ``cmax``
    clients' sub-models) into an 8-bit lane with enough headroom that the
    sum over all participants cannot carry.  Out-of-range values clip; the
    clip error joins the rounding error in the residual.  Counts ride their
    own 8-bit lanes losslessly."""

    name = "int8"

    def __init__(self, spec, participants, error_feedback=True):
        super().__init__(spec, participants, error_feedback)
        head = (self.p - 1).bit_length()  # headroom bits for the participant sum
        if VALUE_LANE_BITS - head < 2:
            raise ValueError(
                f"int8 wire codec supports at most {1 << (VALUE_LANE_BITS - 2)} participants "
                f"on the reduction axis (got {self.p}): fewer than 4 quantisation levels "
                f"would remain per lane")
        self.levels = 1 << (VALUE_LANE_BITS - head)
        self.bias = self.levels // 2
        self.qmax = self.bias - 1

    def draw(self, round_seed: int, device: torch.device, index: int = 0) -> torch.Tensor:
        """The rounding noise ``u ~ U[0, 1)``, float32 ``[total]``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(codec_seed(round_seed, QUANT_NOISE_SALT, index))
        return torch.rand(self.spec.total, generator=gen, dtype=torch.float32, device=device)

    def scale_flat(self, P: torch.Tensor, cmax: int) -> torch.Tensor:
        """Per-leaf grid step ``(cmax * max|P_leaf| + 1e-3) / qmax`` in
        float32, expanded over each leaf's segment."""
        per_leaf = torch.stack([self.spec.leaf(P, k).abs().max() for k in self.spec.names])
        return self._leaf_expand((cmax * per_leaf + 1e-3) / self.qmax)

    def encode(self, sums, cnts, resid, P, noise, cmax: int):
        self._check_count_capacity(cmax, COUNT_LANE_BITS)
        s = self.scale_flat(P, cmax)
        x = sums + resid[0] if self.ef else sums
        words, q = quantize_pack(x, s, noise, self.qmax, self.bias)
        new_resid = (x - q.to(torch.float32) * s)[None] if self.ef else torch.zeros_like(resid)
        return {"q": words, "c": self._count_words(cnts)}, new_resid

    def decode(self, agg, P, noise, cmax: int):
        s = self.scale_flat(P, cmax)
        qsum = unpack_lanes(agg["q"], VALUE_LANE_BITS, self.spec.total) - self.p * self.bias
        return qsum.to(torch.float32) * s, self._counts(agg["c"])


class SignSGDCodec(WireCodec):
    """One sign bit per element (4-bit lanes: up to 15 participants without
    carries) plus each participant's per-leaf mean magnitude; the decoder
    gives ``mean_scale * (positives - negatives)``.  The residual uses the
    participant's own scale (EF-signSGD)."""

    name = "signsgd"

    def __init__(self, spec, participants, error_feedback=True):
        super().__init__(spec, participants, error_feedback)
        if self.p > (1 << SIGN_LANE_BITS) - 1:
            raise ValueError(
                f"signsgd wire codec supports at most {(1 << SIGN_LANE_BITS) - 1} participants "
                f"on the reduction axis (got {self.p}): the sign lanes would carry")

    def _leaf_means(self, x: torch.Tensor) -> torch.Tensor:
        ax = x.abs()
        return torch.stack([self.spec.leaf(ax, k).mean() for k in self.spec.names])

    def encode(self, sums, cnts, resid, P, draw, cmax: int):
        self._check_count_capacity(cmax, COUNT_LANE_BITS)
        x = sums + resid[0] if self.ef else sums
        s_leaf = self._leaf_means(x)
        s_flat = self._leaf_expand(s_leaf)
        pos = x >= 0
        new_resid = (x - torch.where(pos, s_flat, -s_flat))[None] if self.ef \
            else torch.zeros_like(resid)
        payload = {"b": pack_lanes(pos.to(torch.int32), SIGN_LANE_BITS), "s": s_leaf,
                   "c": self._count_words(cnts)}
        return payload, new_resid

    def decode(self, agg, P, draw, cmax: int):
        npos = unpack_lanes(agg["b"], SIGN_LANE_BITS, self.spec.total).to(torch.float32)
        sbar = self._leaf_expand(agg["s"] / self.p)
        return sbar * (2.0 * npos - self.p), self._counts(agg["c"])


class TopKCodec(WireCodec):
    """Rotating-block sparsification of the flat update.

    The flat update splits into :data:`~.TOPK_BLOCKS` contiguous blocks;
    each round ships one, values and counts as float32, the block drawn from
    the round's seed (every participant and the decoder draw the same).
    Both residual slots accumulate the unsent blocks, so a block that ships
    late carries matching sums and counts; coordinates outside the block
    contribute zero count and keep their global value (``combine_counted``'s
    stale rule).  With ``error_feedback=False`` unsent blocks are dropped."""

    name = "topk"

    def __init__(self, spec, participants, error_feedback=True):
        super().__init__(spec, participants, error_feedback)
        self.blocks = TOPK_BLOCKS
        if spec.total < self.blocks:
            raise ValueError(f"topk wire codec needs at least {self.blocks} flat elements "
                             f"(got {spec.total})")
        self.block_len = -(-spec.total // self.blocks)

    def draw(self, round_seed: int, device: torch.device, index: int = 0) -> int:
        """The shipped block's flat offset: drawn on the host from the round
        seed alone (the same for every participant)."""
        gen = torch.Generator().manual_seed(codec_seed(round_seed, TOPK_BLOCK_SALT))
        b = int(torch.randint(0, self.blocks, (), generator=gen))
        return min(b * self.block_len, self.spec.total - self.block_len)

    def encode(self, sums, cnts, resid, P, off: int, cmax: int):
        blk = slice(off, off + self.block_len)
        if self.ef:
            xv, xc = sums + resid[0], cnts + resid[1]
            payload = {"v": xv[blk].clone(), "c": xc[blk].clone()}
            new_resid = torch.stack([xv, xc])
            new_resid[:, blk] = 0.0
        else:
            payload = {"v": sums[blk].clone(), "c": cnts[blk].clone()}
            new_resid = torch.zeros_like(resid)
        return payload, new_resid

    def decode(self, agg, P, off: int, cmax: int):
        blk = slice(off, off + self.block_len)
        sums = agg["v"].new_zeros(self.spec.total)
        cnts = agg["c"].new_zeros(self.spec.total)
        sums[blk] = agg["v"]
        cnts[blk] = agg["c"]
        return sums, cnts


def compressed_sum(codec: WireCodec, P: torch.Tensor, summed: torch.Tensor,
                   counts: torch.Tensor, resid: torch.Tensor, draw, cmax: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode -> sum over participants -> decode: the compressed form of
    the round's reduction of flat ``(summed, counts)``.  ``resid`` is the
    ``[resid_slots, total]`` error-feedback carry, ``draw`` the codec's
    round input (:meth:`WireCodec.draw`), ``cmax`` the clients this
    participant summed (it sizes the int8 grid and the count lanes).
    Returns ``(sums, counts, new_resid)``."""
    payload, new_resid = codec.encode(summed, counts, resid, P, draw, cmax)
    agg: Dict[str, torch.Tensor] = payload  # one participant: the sum is its payload
    sums, cnts = codec.decode(agg, P, draw, cmax)
    return sums, cnts, new_resid
