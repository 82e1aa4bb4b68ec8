"""Stacking of per-client shards into dense ``[num_clients, ...]`` arrays
and the per-user label masks.

Port of ``heterofl_tpu/data/pipeline.py:72-125``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def stack_client_shards(data: np.ndarray, target: np.ndarray,
                        data_split: Dict[int, List[int]], user_idx: List[int]
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(x [C, N, ...], y [C, N], sample_mask [C, N])`` where ``N`` is the
    largest shard; shorter shards repeat their first items with
    ``sample_mask == 0``."""
    sizes = [len(data_split[u]) for u in user_idx]
    n = max(sizes)
    all_idx, ms = [], []
    for u, sz in zip(user_idx, sizes):
        idx = np.asarray(data_split[u], dtype=np.int64)
        if sz < n:
            idx = np.concatenate([idx, idx[np.arange(n - sz) % sz]])
        all_idx.append(idx)
        m = np.zeros(n, dtype=np.float32)
        m[:sz] = 1.0
        ms.append(m)
    flat = np.concatenate(all_idx)
    x = data[flat].reshape((len(user_idx), n) + data.shape[1:])
    y = target[flat].reshape(len(user_idx), n)
    return x, y, np.stack(ms)


def label_split_masks(label_split, num_users: int, classes_size: int) -> np.ndarray:
    """Dense ``[num_users, classes_size]`` 0/1 masks from per-user label lists."""
    m = np.zeros((num_users, classes_size), dtype=np.float32)
    for i in range(num_users):
        m[i, np.asarray(label_split[i], dtype=np.int64)] = 1.0
    return m
