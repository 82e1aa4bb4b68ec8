"""Checkpoint and resume: durable, generational, verified.

Port of the single-process part of ``heterofl_tpu/utils/checkpoint.py``.
Each round the experiment loop stores ``{cfg, epoch, data_split,
label_split, params, bn_state, wire_resid, sched_buf, pivot, logger_state,
scheduler_state, ...}`` to ``output_dir/model/{tag}_checkpoint.pkl`` and
copies it to ``_best.pkl`` when the pivot metric improves; resume restores
everything, the data partition included, so a resumed run keeps the same
client shards.

The file format is the reference's byte for byte: the ``HFTCKPT1`` magic,
the SHA-256 of the payload, then the payload, a protocol-4 pickle of numpy
arrays, Python scalars, lists, tuples and dicts only.  Torch tensors are
turned into numpy arrays on the way in (:func:`_to_host`), so a blob holds
no torch object and each package reads the other's files.  Params go in
the reference's layout (``convert.params_to_jax``), and the flat carries
(the residual, the staleness buffer ``sched_buf``) in the reference's flat
layout (``convert.flat_to_jax``); the caller's job.

* every write goes tmp -> flush -> ``os.fsync`` -> ``os.replace`` ->
  fsync(dir), so a crash never leaves a torn blob under the final name;
* a blob that fails its checksum, is truncated or does not unpickle raises
  :class:`CheckpointCorruptError` ("corrupt", not "absent");
* ``save_checkpoint(..., keep=N)`` rotates older blobs to ``.g1 ..
  .g{N-1}``; :func:`resume` falls back generation by generation to the
  newest blob that verifies, with a ``checkpoint-corrupt`` warning for each
  one skipped, and raises only when every generation fails.

Per-rank sharded checkpoints (ref checkpoint.py:290-517), for a run on
the clients mesh axis (``parallel/mesh.py``): a leaf only one rank holds --
its row of the wire codec's residual -- is a shard-blocks marker
(:func:`rank_block_marker`); :func:`save_checkpoint_sharded` has each rank
write its blocks to its own self-verifying shard file
(:func:`shard_path`) and rank 0 the header, the ordinary blob with each
such leaf a metadata marker and a shard set naming every shard file and a
generation stamp each shard echoes; :func:`load_checkpoint_sharded`
merges them back (a missing shard, a stamp from another generation or a
coverage hole raises :class:`CheckpointCorruptError`), and
:func:`dense_from_blocks` makes the full array.  A blob with no such leaf
(every run on one rank) is the plain blob, written by rank 0 alone.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

#: blob header: magic + 32-byte SHA-256 of the pickle payload
CHECKPOINT_MAGIC = b"HFTCKPT1"
#: the header's record of its shard set, and a shard-blocks leaf's flag
#: (the reference's keys, so each package reads the other's files)
SHARD_SET_KEY = "__heterofl_shard_set__"
BLOCKS_KEY = "__shard_blocks__"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint blob exists but fails verification: bad checksum,
    truncated header, or an unpickling failure."""


def _to_host(tree):
    """The blob with every tensor as a host numpy array; containers keep
    their types (a numpy array passes through as the same object, as in the
    reference, so the pickle's shared references match)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray):
        return np.asarray(tree)
    return tree


def _fsync_dir(path: str) -> None:
    """fsync the directory entry so a rename survives power loss (no-op on
    filesystems that do not support opening directories)."""
    d = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic fs
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - exotic fs
        pass
    finally:
        os.close(fd)


def _write_durable(path: str, payload: bytes) -> None:
    """tmp -> flush -> fsync -> rename -> fsync(dir): the one byte sink of
    every checkpoint write (save and best copy)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic: a crash never corrupts the previous blob
    _fsync_dir(path)


def _blob_bytes(blob: Dict[str, Any]) -> bytes:
    payload = pickle.dumps(_to_host(blob), protocol=4)
    digest = hashlib.sha256(payload).digest()
    return CHECKPOINT_MAGIC + digest + payload


def generation_path(path: str, gen: int) -> str:
    """Generation ``gen`` of ``path``: 0 is the live checkpoint, 1.. the
    rotated older ones (``{path}.g1``, ``{path}.g2``, ...)."""
    return path if gen == 0 else f"{path}.g{gen}"


def generation_paths(path: str) -> List[str]:
    """Every existing generation of ``path``, newest first, found by listing
    the directory (a crash between two renames of a rotation can leave a
    gap, and the older blob past it must stay reachable)."""
    out = [path] if os.path.exists(path) else []
    d, base = os.path.split(path)
    prefix = base + ".g"
    try:
        names = os.listdir(d or ".")
    except OSError:
        names = []
    gens = sorted(int(n[len(prefix):]) for n in names
                  if n.startswith(prefix) and n[len(prefix):].isdigit())
    out.extend(os.path.join(d, f"{base}.g{g}") for g in gens)
    return out


def _rotate(path: str, keep: int) -> None:
    """Shift existing generations one slot older, dropping those past
    ``keep - 1`` (the blob about to be written is generation 0).  Renames
    only: a crash mid-rotation leaves every blob under some generation."""
    if keep <= 1 or not os.path.exists(path):
        return
    gens = []
    g = 1
    while os.path.exists(generation_path(path, g)):
        gens.append(g)
        g += 1
    for g in reversed(gens):
        src = generation_path(path, g)
        if g + 1 >= keep:
            os.remove(src)
        else:
            os.replace(src, generation_path(path, g + 1))
    os.replace(path, generation_path(path, 1))
    _fsync_dir(path)


def save_checkpoint(path: str, blob: Dict[str, Any], keep: int = 1) -> None:
    """Durably write ``blob`` to ``path``, keeping up to ``keep``
    generations (``keep=1``: the live blob only)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = _blob_bytes(blob)
    _rotate(path, keep)
    _write_durable(path, payload)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load and verify one blob.  ``FileNotFoundError`` when absent,
    :class:`CheckpointCorruptError` on a checksum mismatch, a truncated
    header or (for a headerless legacy blob) an unpickling error."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(CHECKPOINT_MAGIC):
        head = len(CHECKPOINT_MAGIC)
        if len(raw) < head + 32:
            raise CheckpointCorruptError(f"checkpoint {path}: truncated header "
                                         f"({len(raw)} bytes)")
        digest, payload = raw[head:head + 32], raw[head + 32:]
        if hashlib.sha256(payload).digest() != digest:
            raise CheckpointCorruptError(
                f"checkpoint {path}: SHA-256 mismatch (bit rot or a torn "
                f"write); {len(payload)} payload bytes")
    else:
        payload = raw  # legacy headerless blob: verified by unpickling only
    try:
        return pickle.loads(payload)
    except Exception as e:
        raise CheckpointCorruptError(f"checkpoint {path}: unpickling failed ({e!r})") from e


def checkpoint_path(output_dir: str, tag: str, which: str = "checkpoint") -> str:
    return os.path.join(output_dir, "model", f"{tag}_{which}.pkl")


def copy_best(output_dir: str, tag: str, sharded: bool = False) -> None:
    """Copy the live checkpoint's bytes to the best-pivot blob through the
    same durable write (the checksum header rides along unchanged).  A
    ``sharded`` live checkpoint (the writer's word:
    :func:`save_checkpoint_sharded` returns it) is mirrored file by file:
    every shard under the best tag's shard names, and the header rewritten
    with the renamed shard set (the same stamp), so rotating the live
    shards cannot tear the best blob."""
    src = checkpoint_path(output_dir, tag, "checkpoint")
    dst = checkpoint_path(output_dir, tag, "best")
    if not sharded:
        with open(src, "rb") as f:
            _write_durable(dst, f.read())
        return
    header = load_checkpoint(src)
    ss = header[SHARD_SET_KEY]
    d = os.path.dirname(src)
    files = []
    for j, base in enumerate(ss["files"]):
        with open(os.path.join(d, base), "rb") as f:
            sbytes = f.read()
        nbase = os.path.basename(shard_path(dst, j, ss["count"]))
        _write_durable(os.path.join(d, nbase), sbytes)
        files.append(nbase)
    header[SHARD_SET_KEY] = {**ss, "files": files}
    _write_durable(dst, _blob_bytes(header))


def iter_verified_generations(path: str) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """``(generation path, verified blob)`` newest first, with a structured
    ``checkpoint-corrupt`` warning for every generation that fails."""
    for p in generation_paths(path):
        try:
            yield p, load_checkpoint(p)
        except CheckpointCorruptError as e:
            warnings.warn("checkpoint generation failed verification, falling back: "
                          + json.dumps({"event": "checkpoint-corrupt", "path": p,
                                        "error": str(e)}))


def load_newest_verifying(path: str) -> Optional[Dict[str, Any]]:
    """The newest generation of ``path`` that verifies; None when there is
    none at all.  Raises :class:`CheckpointCorruptError` when generations
    exist but every one fails: never a silent fresh start over a run that
    could be recovered."""
    gens = generation_paths(path)
    if not gens:
        return None
    for _p, blob in iter_verified_generations(path):
        return blob
    raise CheckpointCorruptError(
        f"all {len(gens)} checkpoint generation(s) of {path} failed verification; "
        f"refusing to silently restart from scratch (delete the blobs to run fresh)")


def resume(output_dir: str, tag: str, mode: int, load_tag: str = "checkpoint"
           ) -> Optional[Dict[str, Any]]:
    """The checkpoint blob as ``resume_mode`` asks, or None: mode 0 always
    fresh; 1 the full blob; 2 params, ``bn_state`` and the splits only (the
    epoch restarts at 1 with a fresh logger and scheduler)."""
    if mode == 0:
        return None
    path = checkpoint_path(output_dir, tag, load_tag)
    blob = load_newest_verifying_sharded(path)
    if blob is None:
        print(f"Not exists model tag: {tag}, start from scratch", flush=True)
        return None
    print(f"Resume from {blob.get('epoch')}", flush=True)
    if mode == 2:
        return {k: blob[k] for k in ("params", "bn_state", "data_split", "label_split")
                if k in blob}
    return blob


# -- per-rank shard checkpoints (ref checkpoint.py:290-517) -----------------

def shard_path(path: str, i: int, n: int) -> str:
    """Rank ``i``'s shard file of an ``n``-rank sharded checkpoint:
    ``{path}.shard{i:03d}-of-{n:03d}`` (a self-verifying blob, the same
    header as the main checkpoint)."""
    return f"{path}.shard{i:03d}-of-{n:03d}"


def is_shard_marker(x) -> bool:
    """Whether ``x`` is a leaf persisted as per-rank shard blocks."""
    return isinstance(x, dict) and x.get(BLOCKS_KEY) is True


def rank_block_marker(row: np.ndarray, rank: int, size: int) -> Dict[str, Any]:
    """Rank ``rank``'s row ``row`` of a ``[size, *row.shape]`` array as a
    shard-blocks marker: ``{BLOCKS_KEY: True, shape, dtype, blocks:
    {((start, stop), ...): ndarray}}`` (the reference's form)."""
    row = np.asarray(row)
    key = ((rank, rank + 1),) + tuple((0, d) for d in row.shape)
    return {BLOCKS_KEY: True, "shape": (size,) + tuple(row.shape), "dtype": str(row.dtype),
            "blocks": {key: row[None]}}


def dense_from_blocks(marker: Dict[str, Any]) -> np.ndarray:
    """The full array of a merged shard-blocks marker (one out of
    :func:`load_checkpoint_sharded`); a coverage hole raises
    :class:`CheckpointCorruptError`."""
    shape = tuple(marker["shape"])
    out = np.empty(shape, np.dtype(marker["dtype"]))
    filled = np.zeros(shape, bool) if shape else None
    for key, blk in marker["blocks"].items():
        idx = tuple(slice(a, b) for a, b in key)
        out[idx] = blk
        if filled is not None:
            filled[idx] = True
    if filled is not None and not filled.all():
        raise CheckpointCorruptError(
            f"sharded checkpoint leaf (shape {shape}) has coverage holes: "
            f"{int((~filled).sum())} elements missing from the merged "
            f"shard blocks (an incomplete shard set verified?)")
    return out


def _split_shards(tree, blocks_out: Dict[str, Any], path: str = ""):
    """The blob with each shard-blocks marker replaced by a metadata marker
    (the header's side), this rank's blocks collected into ``blocks_out``
    by the leaf's tree path."""
    if is_shard_marker(tree):
        blocks_out[path] = tree["blocks"]
        return {BLOCKS_KEY: True, "shape": tuple(tree["shape"]), "dtype": str(tree["dtype"]),
                "key": path}
    if isinstance(tree, dict):
        return {k: _split_shards(v, blocks_out, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_split_shards(v, blocks_out, f"{path}/{i}")
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split_shards(v, blocks_out, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return tree


def _join_shards(tree, blocks_by_key: Dict[str, Dict]):
    """The header's metadata markers with the merged blocks put back (the
    load side of :func:`_split_shards`)."""
    if is_shard_marker(tree):
        key = tree.get("key")
        if key not in blocks_by_key:
            raise CheckpointCorruptError(
                f"sharded checkpoint header references leaf {key!r} but no "
                f"shard file carried blocks for it")
        return {BLOCKS_KEY: True, "shape": tuple(tree["shape"]), "dtype": str(tree["dtype"]),
                "blocks": blocks_by_key[key]}
    if isinstance(tree, dict):
        return {k: _join_shards(v, blocks_by_key) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_join_shards(v, blocks_by_key) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_join_shards(v, blocks_by_key) for v in tree)
    return tree


def save_checkpoint_sharded(path: str, blob: Dict[str, Any], keep: int = 1,
                            stamp: Optional[str] = None, mesh=None) -> bool:
    """The collective durable checkpoint write of a run on the clients mesh
    axis: EVERY rank calls it with a blob of the same structure.  Each rank
    writes the blocks of its shard-blocks markers to its own shard file;
    rank 0 then writes the header (the blob with those leaves as metadata
    markers, and the shard set: every shard file and the generation
    ``stamp``, default ``e<epoch>``, each shard echoes).  Barriers bracket
    the header: the shards are on disk before the header names them, and no
    rank returns before it landed.  A blob with no marker (one rank, or no
    per-rank leaf) is the plain :func:`save_checkpoint` of rank 0.
    ``mesh`` is ``parallel.mesh.Mesh`` (None: one rank).  With a data axis
    the ranks of a clients row hold the same blocks (either engine's), so
    data column 0 of each row writes the row's shard file and world rank 0
    the header; the barriers span the world.  Returns whether shard files were written
    (:func:`copy_best`'s ``sharded``)."""
    rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    lead = mesh is None or mesh.lead
    writes = mesh is None or mesh.data_rank == 0
    blocks: Dict[str, Any] = {}
    header = _split_shards(blob, blocks)
    if not blocks:
        if lead:
            save_checkpoint(path, blob, keep)
        if mesh is not None:
            mesh.barrier()
        return False
    if stamp is None:
        stamp = f"e{blob.get('epoch', 0)}"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if writes:
        sp = shard_path(path, rank, size)
        _rotate(sp, keep)
        _write_durable(sp, _blob_bytes({"stamp": stamp, "process": rank, "blocks": blocks}))
    if mesh is not None:
        mesh.barrier()
    if lead:
        header[SHARD_SET_KEY] = {"count": size, "stamp": stamp,
                                 "files": [os.path.basename(shard_path(path, j, size))
                                           for j in range(size)]}
        _rotate(path, keep)
        _write_durable(path, _blob_bytes(header))
    if mesh is not None:
        mesh.barrier()
    return True


def load_checkpoint_sharded(path: str, gen: int = 0) -> Dict[str, Any]:
    """Load and verify generation ``gen`` of a (possibly sharded)
    checkpoint: the header names its shard set, every shard must verify
    and echo the header's stamp, and the merged blocks replace the header's
    markers.  A plain blob loads as it is."""
    header = load_checkpoint(generation_path(path, gen))
    ss = header.pop(SHARD_SET_KEY, None) if isinstance(header, dict) else None
    if ss is None:
        return header
    d = os.path.dirname(os.path.abspath(path))
    blocks_by_key: Dict[str, Dict] = {}
    for base in ss["files"]:
        spath = generation_path(os.path.join(d, base), gen)
        try:
            shard = load_checkpoint(spath)
        except FileNotFoundError as e:
            raise CheckpointCorruptError(
                f"sharded checkpoint {path} (gen {gen}): shard file {base} "
                f"named by the header is missing") from e
        if shard.get("stamp") != ss["stamp"]:
            raise CheckpointCorruptError(
                f"sharded checkpoint {path} (gen {gen}): shard {base} stamp "
                f"{shard.get('stamp')!r} != header stamp {ss['stamp']!r} "
                f"(torn multi-file rotation)")
        for key, blk in shard["blocks"].items():
            blocks_by_key.setdefault(key, {}).update(blk)
    return _join_shards(header, blocks_by_key)


def load_newest_verifying_sharded(path: str) -> Optional[Dict[str, Any]]:
    """:func:`load_newest_verifying` over sharded checkpoints: a generation
    verifies only if its header and its whole shard set do."""
    gens = generation_paths(path)
    if not gens:
        return None
    for p in gens:
        gen = 0 if p == path else int(p.rsplit(".g", 1)[1])
        try:
            return load_checkpoint_sharded(path, gen)
        except CheckpointCorruptError as e:
            warnings.warn("checkpoint generation failed verification, falling back: "
                          + json.dumps({"event": "checkpoint-corrupt", "path": p,
                                        "error": str(e)}))
    raise CheckpointCorruptError(
        f"all {len(gens)} checkpoint generation(s) of {path} failed verification; "
        f"refusing to silently restart from scratch (delete the blobs to run fresh)")
