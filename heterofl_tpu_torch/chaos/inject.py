"""The NaN poison: a client's update made non-finite before aggregation.

Port of ``heterofl_tpu/chaos/inject.py::poison_updates``.  The reference
matches (round, uid) inside its program; the port knows each slot's round
and user on the host, so the match is a host decision and the poison one
elementwise add on the device, only for a matched slot: a run without
``chaos_poison`` runs nothing of it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def poison_hits(table: Optional[np.ndarray], epoch: int, uids) -> np.ndarray:
    """Bool ``[slots]``: the slots whose (round ``epoch``, user) the plan
    poisons; a ``-1`` (padding) slot never matches a uid >= 0."""
    uids = np.asarray(uids, np.int64).reshape(-1)
    if table is None:
        return np.zeros(uids.shape, bool)
    rows = table[table[:, 0] == int(epoch)]
    return np.isin(uids, rows[:, 1].astype(np.int64))


def poison_updates(trained: torch.Tensor, hits: np.ndarray) -> torch.Tensor:
    """NaN added to every element of the matched rows of ``trained`` (``[n]``
    one client, ``hits`` of one entry; ``[G, n]`` a level's G clients): the
    reference's ``v + where(hit, nan, 0)``.  Unmatched rows are left as
    they are, and with no match ``trained`` itself is returned."""
    hits = np.asarray(hits, bool).reshape(-1)
    if not hits.any():
        return trained
    if trained.dim() == 1:
        return trained + float("nan")
    bad = torch.from_numpy(np.where(hits, np.float32(np.nan), np.float32(0.0))).to(trained.device)
    return trained + bad[:, None]
