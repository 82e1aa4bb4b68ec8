"""Data-dependent cfg fields, token batchify and bptt windows, stacking of
per-client shards into dense ``[num_clients, ...]`` arrays, and the
per-user label masks.

Port of ``heterofl_tpu/data/pipeline.py``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Tuple

import numpy as np

from .datasets import TokenDataset


def process_dataset(cfg: Dict[str, Any], dataset: Dict[str, Any]
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(cfg, dataset)`` with the data-dependent fields set: a vision
    dataset's ``classes_size`` and ``data_shape``; an LM dataset's
    ``vocab``, ``num_tokens`` and ``classes_size`` (the vocabulary's size),
    and each split's stream batchified into ``[batch_size[split], T]``
    rows."""
    cfg = copy.deepcopy(cfg)
    dataset = dict(dataset)
    train = dataset["train"]
    if not isinstance(train, TokenDataset):
        cfg["classes_size"] = train.classes_size
        cfg["data_shape"] = list(train.data.shape[1:])
        return cfg, dataset
    cfg["vocab"] = train.vocab
    cfg["num_tokens"] = cfg["classes_size"] = len(train.vocab)
    for split, ds in dataset.items():
        dataset[split] = TokenDataset(batchify(ds.token, cfg["batch_size"][split]), ds.vocab,
                                      ds.data_name)
    return cfg, dataset


def batchify(token: np.ndarray, batch_size: int) -> np.ndarray:
    """A 1-D token stream -> ``[batch_size, len // batch_size]`` rows (the
    tail that does not fill a column is dropped)."""
    num_batch = len(token) // batch_size
    return token[: num_batch * batch_size].reshape(batch_size, -1)


def bptt_windows(rows: np.ndarray, bptt: int) -> List[np.ndarray]:
    """``[R, T]`` rows -> windows of ``bptt`` along T; the last may be
    shorter."""
    return [rows[:, s: s + bptt] for s in range(0, rows.shape[1], bptt)]


def stack_windows(wins: List[np.ndarray], bptt: int) -> Tuple[np.ndarray, np.ndarray]:
    """bptt windows -> ``([S, R, bptt], position weights [S, R, bptt])``; a
    short tail window is zero-padded with zero weights."""
    full = [w for w in wins if w.shape[1] == bptt]
    if full:
        xs = np.stack(full)
    else:
        r = wins[0].shape[0] if wins else 0
        xs = np.zeros((0, r, bptt), np.int64)
    ws = np.ones(xs.shape, np.float32)
    tail = wins[-1] if wins and wins[-1].shape[1] < bptt else None
    if tail is not None:
        pad = bptt - tail.shape[1]
        xs = np.concatenate([xs, np.pad(tail, ((0, 0), (0, pad)))[None]], 0)
        ws = np.concatenate([ws, np.pad(np.ones(tail.shape, np.float32),
                                        ((0, 0), (0, pad)))[None]], 0)
    return xs, ws


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


def stack_client_token_rows(token_rows: np.ndarray, data_split: Dict[int, List[int]],
                            user_idx: List[int]) -> np.ndarray:
    """Each user's batchified rows -> ``[C, R, T]`` (the iid split hands
    out whole rows, the same number to every user)."""
    rows = [token_rows[np.asarray(data_split[u], dtype=np.int64)] for u in user_idx]
    r = max(x.shape[0] for x in rows)
    if not all(x.shape[0] == r for x in rows):
        raise ValueError("per-user row counts must match")
    return np.stack(rows)


def label_split_masks(label_split, num_users: int, classes_size: int) -> np.ndarray:
    """Dense ``[num_users, classes_size]`` 0/1 masks from per-user label lists."""
    m = np.zeros((num_users, classes_size), dtype=np.float32)
    for i in range(num_users):
        m[i, np.asarray(label_split[i], dtype=np.int64)] = 1.0
    return m
