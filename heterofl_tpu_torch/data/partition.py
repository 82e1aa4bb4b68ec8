"""Client data partitioning: iid equal shards (of images or of token rows)
and non-iid label shards.

Port of ``heterofl_tpu/data/partition.py`` (iid, non_iid, split_dataset,
span_population).  Randomness comes from an explicit
``numpy.random.Generator``, consumed in the reference's order, so the
splits are identical for the same stream.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


def _labels_of(dataset) -> np.ndarray:
    """A vision dataset's targets; an LM dataset's token rows (each row is
    an example, its tokens the labels)."""
    if hasattr(dataset, "target"):
        return np.asarray(dataset.target)
    return np.asarray(dataset.token)


def iid(dataset, num_users: int, rng: np.random.Generator
        ) -> Tuple[Dict[int, List[int]], Dict[int, List[int]]]:
    """Random equal shards and the per-user observed label sets."""
    label = _labels_of(dataset)
    n = len(dataset)
    num_items = n // num_users
    perm = rng.permutation(n)
    data_split: Dict[int, List[int]] = {}
    label_split: Dict[int, List[int]] = {}
    for i in range(num_users):
        shard = perm[i * num_items: (i + 1) * num_items]
        data_split[i] = shard.tolist()
        label_split[i] = np.unique(label[shard].reshape(-1)).tolist()
    return data_split, label_split


def non_iid(dataset, num_users: int, rng: np.random.Generator, shard_per_user: int,
            classes_size: int, label_split: Optional[List[List[int]]] = None
            ) -> Tuple[Dict[int, List[int]], List[List[int]]]:
    """"non-iid-N": each user holds shards of N distinct labels."""
    label = np.asarray(dataset.target)
    label_idx_split: Dict[int, List[int]] = {}
    for i in range(len(label)):
        label_idx_split.setdefault(int(label[i]), []).append(i)
    shard_per_class = int(shard_per_user * num_users / classes_size)
    if (shard_per_class < 1
            or (shard_per_user * num_users) % classes_size != 0
            or (classes_size * shard_per_class) % num_users != 0):
        raise ValueError(
            f"non-iid-{shard_per_user} needs shard_per_user*num_users to tile "
            f"classes_size exactly (and classes*shards to tile users): got "
            f"num_users={num_users}, classes_size={classes_size}")
    pools: Dict[int, List[np.ndarray]] = {}
    for label_i, label_idx in label_idx_split.items():
        num_leftover = len(label_idx) % shard_per_class
        leftover = label_idx[-num_leftover:] if num_leftover > 0 else []
        body = np.array(label_idx[:-num_leftover]) if num_leftover > 0 else np.array(label_idx)
        shards = [s for s in body.reshape(shard_per_class, -1)]
        for i, extra in enumerate(leftover):
            shards[i] = np.concatenate([shards[i], [extra]])
        pools[label_i] = shards
    if label_split is None:
        flat = np.array(list(range(classes_size)) * shard_per_class)
        flat = flat[rng.permutation(len(flat))]
        label_split = [np.unique(row).tolist() for row in flat.reshape(num_users, -1)]
    data_split: Dict[int, List[int]] = {i: [] for i in range(num_users)}
    for i in range(num_users):
        for label_i in label_split[i]:
            pick = int(rng.integers(len(pools[label_i])))
            data_split[i].extend(pools[label_i].pop(pick).tolist())
    return data_split, label_split


def span_population(num_items: int, num_users: int, shard_size: int,
                    stride: int = 9973) -> Tuple[np.ndarray, np.ndarray]:
    """A synthetic population larger than its dataset (ref partition.py:
    87-111): user ``u``'s shard is the contiguous window ``[starts[u],
    starts[u] + shard_size)`` of a pool of ``num_items`` samples, ``starts
    = (u * stride) % hi`` with ``hi = num_items - shard_size + 1`` --
    O(num_users) metadata (``parallel.staging.ClientStore.from_spans``), no
    index lists.  A stride that shares a factor with ``hi`` would walk only
    ``hi / gcd`` starts (every user the same shard when the gcd is ``hi``),
    so it is bumped to the next stride coprime to ``hi``."""
    if shard_size <= 0 or shard_size > num_items:
        raise ValueError(f"shard_size {shard_size} must be in [1, {num_items}]")
    hi = num_items - shard_size + 1
    stride = max(1, stride)
    while math.gcd(stride, hi) != 1:
        stride += 1
    starts = (np.arange(num_users, dtype=np.int64) * stride) % hi
    sizes = np.full(num_users, shard_size, np.int64)
    return starts, sizes


def split_dataset(dataset, num_users: int, data_split_mode: str, rng: np.random.Generator,
                  classes_size: Optional[int] = None):
    """Split train and test for all users; the train split's label sets
    are the users' label splits."""
    data_split = {}
    if data_split_mode == "iid":
        data_split["train"], label_split = iid(dataset["train"], num_users, rng)
        data_split["test"], _ = iid(dataset["test"], num_users, rng)
    elif "non-iid" in data_split_mode:
        shard_per_user = int(data_split_mode.split("-")[-1])
        cs = classes_size if classes_size is not None else dataset["train"].classes_size
        data_split["train"], label_split = non_iid(dataset["train"], num_users, rng,
                                                   shard_per_user, cs)
        data_split["test"], _ = non_iid(dataset["test"], num_users, rng, shard_per_user, cs,
                                        label_split)
        label_split = {i: label_split[i] for i in range(num_users)}
    else:
        raise ValueError("Not valid data split mode")
    return data_split, label_split
