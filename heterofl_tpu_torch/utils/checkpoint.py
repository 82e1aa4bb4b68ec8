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

The reference's per-process sharded checkpoints (multi-host meshes) are
not ported: the port runs on one GPU.
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


def copy_best(output_dir: str, tag: str) -> None:
    """Copy the live checkpoint's bytes to the best-pivot blob through the
    same durable write (the checksum header rides along unchanged)."""
    src = checkpoint_path(output_dir, tag, "checkpoint")
    with open(src, "rb") as f:
        payload = f.read()
    _write_durable(checkpoint_path(output_dir, tag, "best"), payload)


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
    blob = load_newest_verifying(path)
    if blob is None:
        print(f"Not exists model tag: {tag}, start from scratch", flush=True)
        return None
    print(f"Resume from {blob.get('epoch')}", flush=True)
    if mode == 2:
        return {k: blob[k] for k in ("params", "bn_state", "data_split", "label_split")
                if k in blob}
    return blob
