"""Wire codecs: compressed aggregation of a round's (sums, counts).

Port of ``heterofl_tpu/compress/__init__.py`` (the registry, the lane
widths, the payload byte formula and the config validation; its own copy,
no import of the reference).  The codecs themselves are in
:mod:`.codecs`.  ``cfg['wire_codec']``:

* ``dense`` (default): no payload transform, no residual -- the round is
  the uncompressed one;
* ``int8``: per-leaf stochastic-rounding quantisation onto a grid derived
  from the global params, four 8-bit lanes per int32 word, counts in exact
  8-bit lanes: 25% of dense;
* ``signsgd``: one sign per element in 4-bit lanes plus a per-leaf scale;
* ``topk``: one of :data:`TOPK_BLOCKS` contiguous blocks of the flat
  update per round, values and counts as float32: 25% of dense.

The lossy codecs carry an error-feedback residual across rounds
(``cfg['error_feedback']``, default True).  A per-level codec map and the
grouped strategy need the grouped engine, which is not ported: they raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

#: the codec registry; ``dense`` is the default and the only lossless one
CODEC_NAMES = ("dense", "int8", "signsgd", "topk")

#: lossy codecs carry an error-feedback residual across rounds
LOSSY_CODECS = ("int8", "signsgd", "topk")

#: blocks of the ``topk`` rotation: one block of ``ceil(N / TOPK_BLOCKS)``
#: flat coordinates ships per round
TOPK_BLOCKS = 4

#: lane widths (bits) of the packed integer payloads
VALUE_LANE_BITS = 8   # int8 codec: quantised values
SIGN_LANE_BITS = 4    # signsgd codec: sign bits with cross-device headroom
COUNT_LANE_BITS = 8   # both: exact integer count masks


def lane_words(n_elems: int, lane_bits: int) -> int:
    """int32 words needed to pack ``n_elems`` lanes of ``lane_bits`` bits."""
    per = 32 // lane_bits
    return -(-n_elems // per)


def resid_slots(name: str) -> int:
    """Flat error-feedback buffers the codec carries: ``topk`` carries value
    AND count residuals (a block that ships after m rounds carries m rounds
    of both, so sum/count stays a mean); the quantising codecs carry one."""
    return 2 if name == "topk" else (0 if name == "dense" else 1)


def codec_payload_bytes(name: str, n_elems: int, n_leaves: int = 0,
                        blocks: int = TOPK_BLOCKS) -> int:
    """Per-participant payload bytes of one compressed round."""
    if name == "dense":
        return 2 * 4 * n_elems  # f32 sums + f32 counts
    if name == "int8":
        return 4 * lane_words(n_elems, VALUE_LANE_BITS) + 4 * lane_words(n_elems, COUNT_LANE_BITS)
    if name == "signsgd":
        return (4 * lane_words(n_elems, SIGN_LANE_BITS)
                + 4 * lane_words(n_elems, COUNT_LANE_BITS) + 4 * n_leaves)
    if name == "topk":
        return 2 * 4 * (-(-n_elems // blocks))  # f32 value + count block
    raise ValueError(f"Not valid wire_codec: {name!r} (one of {CODEC_NAMES})")


def resolve_codec_cfg(cfg: Dict[str, Any]) -> Tuple[str, bool]:
    """Validate ``cfg['wire_codec']`` and ``cfg['error_feedback']`` ->
    ``(codec name, error_feedback)``.  An unknown codec or a non-bool
    ``error_feedback`` raises ``ValueError`` (never a silent dense run); a
    per-level map, or a lossy codec under a strategy other than ``masked``,
    raises ``NotImplementedError``.  A codec with the ``sliced`` strategy is
    invalid in the reference too (``ValueError``)."""
    name = cfg.get("wire_codec", "dense") or "dense"
    if isinstance(name, dict):
        raise NotImplementedError(
            "a per-level wire_codec map is not ported to heterofl_tpu_torch yet: it needs "
            "the grouped engine's fused superstep")
    if name not in CODEC_NAMES:
        raise ValueError(f"Not valid wire_codec: {name!r} (one of {CODEC_NAMES})")
    ef = cfg.get("error_feedback", True)
    if not isinstance(ef, bool):
        raise ValueError(f"Not valid error_feedback: {ef!r} (must be a bool; it gates the "
                         f"residual re-injection of lossy wire codecs)")
    strategy = cfg.get("strategy", "masked") or "masked"
    if name != "dense" and strategy == "sliced":
        raise ValueError(f"Not valid wire_codec={name!r} with strategy='sliced': the sliced "
                         f"debug twin aggregates on the host, there is no reduction to "
                         f"compress")
    if name != "dense" and strategy != "masked":
        raise NotImplementedError(
            f"wire_codec={name!r} with strategy={strategy!r} is not ported to "
            f"heterofl_tpu_torch yet (the masked strategy is)")
    return name, ef


def make_codec(name: str, spec, participants: int, error_feedback: bool = True):
    """The codec object over the flat layout ``spec`` (None for ``dense``)."""
    if name == "dense":
        return None
    from .codecs import Int8Codec, SignSGDCodec, TopKCodec

    cls = {"int8": Int8Codec, "signsgd": SignSGDCodec, "topk": TopKCodec}
    if name not in cls:
        raise ValueError(f"Not valid wire_codec: {name!r} (one of {CODEC_NAMES})")
    return cls[name](spec, participants, error_feedback=error_feedback)
