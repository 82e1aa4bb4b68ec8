"""Client data partitioning: iid equal shards and non-iid label shards.

Port of ``heterofl_tpu/data/partition.py`` (iid, non_iid, split_dataset).
Randomness comes from an explicit ``numpy.random.Generator``, consumed in
the reference's order, so the splits are identical for the same stream.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def iid(dataset, num_users: int, rng: np.random.Generator
        ) -> Tuple[Dict[int, List[int]], Dict[int, List[int]]]:
    """Random equal shards and the per-user observed label sets."""
    label = np.asarray(dataset.target)
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
