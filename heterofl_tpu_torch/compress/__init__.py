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
(``cfg['error_feedback']``, default True).  Only the ``masked`` strategy
compresses: the reference compresses the grouped strategy's round only in
its fused K-round superstep, which is not ported, so the grouped K=1 round,
the sliced twin and a per-level ``{rate: codec}`` map refuse a lossy codec
with the reference experiment loop's ``ValueError``s
(heterofl_tpu/entry/common.py:288-335).
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


def normalize_codec_map(raw: Dict[Any, Any]) -> Dict[float, str]:
    """A per-level codec map with float rate keys (heterofl_tpu/compress/
    __init__.py:101-127): keys are rates or their string forms, values
    codec names; a bad key or name, a level named twice or an empty map
    raises ``ValueError``."""
    out: Dict[float, str] = {}
    for k, v in raw.items():
        try:
            rate = float(k)
        except (TypeError, ValueError):
            raise ValueError(f"Not valid wire_codec level key: {k!r} (a rate level, e.g. 1.0 "
                             f"or '0.0625')")
        if v not in CODEC_NAMES:
            raise ValueError(f"Not valid wire_codec for level {rate:g}: {v!r} (one of "
                             f"{CODEC_NAMES})")
        if rate in out:
            raise ValueError(f"Not valid wire_codec map: level {rate:g} assigned twice "
                             f"(duplicate keys coerce to the same rate)")
        out[rate] = v
    if not out:
        raise ValueError("Not valid wire_codec: an empty per-level map")
    return out


def resolve_codec_cfg(cfg: Dict[str, Any]) -> Tuple[Any, bool]:
    """Validate ``cfg['wire_codec']`` and ``cfg['error_feedback']`` ->
    ``(codec, error_feedback)``.  An unknown codec or a non-bool
    ``error_feedback`` raises ``ValueError`` (never a silent dense run); a
    per-level map whose levels are all ``dense`` is ``dense``.

    The codec is also checked against ``cfg['strategy']``, with the
    reference experiment loop's ``ValueError``s (heterofl_tpu/entry/
    common.py:307-335): a per-level map outside ``grouped``, a lossy codec
    with ``sliced``, and a lossy codec (or map) with ``grouped`` -- the port
    runs only its K=1 round, which reduces per level and has no single sum
    to compress.  The grouped engine and the sliced twin refuse through
    this function, with their own strategy."""
    name = cfg.get("wire_codec", "dense") or "dense"
    if isinstance(name, dict):
        name = normalize_codec_map(name)
        if all(v == "dense" for v in name.values()):
            name = "dense"
    elif name not in CODEC_NAMES:
        raise ValueError(f"Not valid wire_codec: {name!r} (one of {CODEC_NAMES})")
    ef = cfg.get("error_feedback", True)
    if not isinstance(ef, bool):
        raise ValueError(f"Not valid error_feedback: {ef!r} (must be a bool; it gates the "
                         f"residual re-injection of lossy wire codecs)")
    strategy = cfg.get("strategy", "masked") or "masked"
    if isinstance(name, dict) and strategy != "grouped":
        raise ValueError(
            "a per-level wire_codec map needs strategy='grouped' (its fused superstep "
            "compresses each level's sliced payload under that level's codec); the other "
            "strategies have no levels to assign codecs to")
    if name != "dense":
        if strategy == "sliced":
            raise ValueError(
                f"wire_codec={name!r} needs a mesh-native strategy ('masked' or 'grouped'): "
                f"the sliced debug twin aggregates on the host, there is no psum to compress")
        if strategy == "grouped":
            raise ValueError(
                f"wire_codec={name!r} with the grouped strategy needs the fused superstep "
                f"(superstep_rounds > 1 or client_store='stream'): the K=1 host-orchestrated "
                f"path reduces per level and has no single global psum to compress")
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
