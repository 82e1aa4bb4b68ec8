"""The wire: the bytes a round's one all-reduce carries over the clients
mesh axis (ref staticcheck/wire.py).

The payload is what the round reduces: the merged global update and
count buffers (the masked engine's, and the grouped engine's dense round),
the codec's packed lanes (the int8 codec's value and count words), and
under a per-level codec map every level's payload in the grouped engine's
one all-reduce (a dense level's sliced sums and counts, a lossy level's
lanes; ``parallel/grouped.py::_reduce_levels``).  The audit records each
payload's ``nbytes`` as the round builds it and :func:`check_wire` holds
them to :func:`~..fed.core.level_codec_byte_table` (or, level by level,
:func:`~..fed.core.level_codec_map_byte_table`) **by equality**: a widened
buffer, a smuggled dtype or a second payload shows up as bytes.  The
int8 payload stays at or under 25% of dense (:func:`codec_frontier`,
the reference's ``wire-frontier``); :func:`ring_allreduce_bytes` prices
the payload on a ring of the mesh's ranks; :func:`data_step_bytes` a
local step's payloads over the data axis.

Torch-free: the analytic records need no device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence


def ring_allreduce_bytes(payload_bytes: int, participants: int) -> int:
    """Per-participant traffic of a bidirectional-ring all-reduce, ``2 (p -
    1) / p x payload``; zero for one participant."""
    if participants <= 1:
        return 0
    return int(round(2.0 * (participants - 1) / participants * payload_bytes))


def codec_round_wire(codec: str, payload_bytes: int, dense_bytes: int,
                     participants: int = 1) -> Dict[str, Any]:
    """The compressed round's wire record; ``payload_bytes`` from
    :func:`~..fed.core.level_codec_byte_table` (ref wire.py:243-260)."""
    return {"format": codec, "payload_bytes_per_round": int(payload_bytes),
            "dense_bytes_per_round": int(dense_bytes),
            "ratio_vs_dense": round(payload_bytes / dense_bytes, 6),
            "reduction_x": round(dense_bytes / payload_bytes, 3),
            "ring_allreduce_bytes_per_device": ring_allreduce_bytes(payload_bytes, participants),
            "participants": int(participants)}


def dense_round_wire(param_bytes: int, participants: int = 1,
                     count_bytes: Optional[int] = None) -> Dict[str, Any]:
    """The dense round's wire record: the update sums plus the count masks,
    both param-shaped float32 (ref wire.py:263-281)."""
    if count_bytes is None:
        count_bytes = param_bytes
    payload = param_bytes + count_bytes
    return {"format": "dense-f32", "param_bytes": int(param_bytes),
            "count_bytes": int(count_bytes), "payload_bytes_per_round": int(payload),
            "ring_allreduce_bytes_per_device": ring_allreduce_bytes(payload, participants),
            "participants": int(participants)}


def data_step_bytes(rows: int, ld: int, bn_channels: Sequence[int] = ()) -> int:
    """The float32 bytes one local step hands its all-reduces over the data
    group (the data axis, ``parallel/mesh.py``): its packed gradient ``[rows,
    ld]`` with its ``[rows, 2]`` sums in one buffer, and at each BN site of
    ``C`` channels a client the moments ``[3, rows * C]`` forward and the
    partial sums ``[2, rows * C]`` backward.  ``rows`` is 1 and ``ld`` the
    flat size for the masked engine's step; a grouped level step has a row a
    client and the level's row stride ``ld``.  An LM step (no BN site) adds
    ring attention's shifts, which this does not count."""
    return 4 * (rows * (ld + 2) + sum(5 * rows * int(c) for c in bn_channels))


def check_wire(rep, wire: Dict[str, Any], expected: Dict[float, int]) -> None:
    """Hold one program's recorded payloads to the analytic table by
    equality (``rep`` a :class:`~.report.ProgramReport`).

    ``wire['levels']`` maps each level (its rate as a string) to the bytes
    its payload moved in each reduction the program made; ``expected``
    maps the rate to the table's bytes.  Every recorded reduction of a
    level must move exactly its table's bytes (``wire-budget``); a program
    that reduced nothing, or a level the table does not know, fails too.
    ``wire['level_bytes']`` is the table's bytes summed over the levels the
    program reduced (one round's payload when every round reduces them
    all)."""
    levels = wire.get("levels") or {}
    if not levels:
        rep.fail("wire-budget", "the program reduced no payload: the wire audit saw "
                 "nothing")
        return
    for key, seen in sorted(levels.items()):
        want = expected.get(float(key))
        if want is None:
            rep.fail("wire-budget", f"level {key} reduced {seen} bytes, and the table has "
                     f"no such level")
            continue
        bad = sorted({b for b in seen if b != want})
        if bad:
            rep.fail("wire-budget", f"level {key}: a round's payload is {bad} bytes, the "
                     f"table's is exactly {want} (the update sums and counts, or the "
                     f"codec's lanes, at this level's element count)")
    wire["level_bytes"] = sum(expected[float(k)] for k in levels if float(k) in expected)


def codec_frontier(dense_bytes: int, payloads: Dict[str, int]) -> Dict[str, Any]:
    """Each lossy codec's payload against dense at the headline's widths
    (ref audit.py:1202-1240); ``ok`` is False when the int8 payload passes
    25% of dense, with the reference's slack of one padded lane word a
    packed stream (``4 x int8 <= dense + 32``)."""
    sec: Dict[str, Any] = {"ok": True, "dense_bytes": int(dense_bytes), "codecs": {
        name: {"payload_bytes_per_round": int(b), "ratio_vs_dense": round(b / dense_bytes, 6),
               "reduction_x": round(dense_bytes / b, 3)} for name, b in payloads.items()}}
    sec["ok"] = 4 * payloads["int8"] <= dense_bytes + 32
    return sec
