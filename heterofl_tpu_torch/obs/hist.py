"""Cohort histograms: fixed-bucket counts of a round's per-client losses,
executed step fractions, levels and staleness-carry magnitudes.

Port of ``heterofl_tpu/obs/hist.py`` (the edges, the bucket rule and
:func:`round_hists`).  The reference computes every histogram inside its
round program; the port computes the one over a device carry on the device
(:func:`stale_hist`, the ``[2, total]`` staleness buffer) and the three
over per-slot rows on the host from the rows the fetch already carries
(``obs.split_probes``): exact, and free for the device.

Bucket rule (the reference's, ``searchsorted(edges, v, side='left')``):
bucket ``i`` covers ``(edges[i-1], edges[i]]``, bucket ``len(edges)``
collects the overflow (NaN included), so a histogram has ``len(edges) + 1``
bins.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

#: per-client mean-loss bucket edges (upper bounds; cross-entropy scale)
LOSS_EDGES = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 100.0)

#: executed-step FRACTION edges (deadline truncation); (0.875, 1] is the
#: "met the deadline" bin
STEP_EDGES = (0.25, 0.5, 0.75, 0.875, 1.0)

#: |pending buffered update| magnitude edges (log-spaced); exact zeros land
#: in bin 0
STALE_EDGES = (1e-8, 1e-6, 1e-4, 1e-2, 1.0, 100.0)


def bucket_counts(values, weights, edges: Sequence[float]) -> np.ndarray:
    """Weighted fixed-bucket histogram (host): ``[len(edges) + 1]`` float32
    counts of ``values`` under the bucket rule, values and edges compared
    in float32 as the reference compares them."""
    e = np.asarray(edges, np.float32)
    idx = np.searchsorted(e, np.asarray(values, np.float32).reshape(-1), side="left")
    out = np.zeros(e.shape[0] + 1, np.float32)
    np.add.at(out, idx, np.asarray(weights, np.float32).reshape(-1))
    return out


def round_hists(levels: Sequence[float], rate, loss_sum, n,
                steps: Optional[np.ndarray] = None,
                sched_buf: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """One round's histograms from host rows (the reference's
    :func:`round_hists` on the host): ``rate``/``loss_sum``/``n`` per slot
    (a slot with rate 0 did not train), ``steps`` each slot's executed
    step fraction (None: every trained slot at 1.0), ``sched_buf`` the
    staleness carry (None: zeros)."""
    rate = np.asarray(rate, np.float32).reshape(-1)
    valid = (rate > 0).astype(np.float32)
    loss = np.asarray(loss_sum, np.float32).reshape(-1)
    nn = np.asarray(n, np.float32).reshape(-1)
    w_loss = valid * (nn > 0).astype(np.float32)
    frac = np.ones_like(rate) if steps is None else np.asarray(steps, np.float32)
    if sched_buf is None:
        stale = np.zeros(len(STALE_EDGES) + 1, np.float32)
    else:
        flat = np.abs(np.asarray(sched_buf, np.float32)).reshape(-1)
        stale = bucket_counts(flat, np.ones_like(flat), STALE_EDGES)
    return {
        "hist_loss": bucket_counts(loss / np.maximum(nn, np.float32(1.0)), w_loss, LOSS_EDGES),
        "hist_steps": bucket_counts(frac, valid, STEP_EDGES),
        "hist_level": np.asarray([np.sum(rate == np.float32(lvl)) for lvl in levels],
                                 np.float32),
        "hist_stale": stale,
    }


def stale_hist(sched_buf: Optional[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The staleness carry's magnitude histogram on the device, exact and
    with no value read back to the host: the int64 counts of ``|sched_buf|``
    at or below each edge (one broadcast compare, one sum), differenced
    into the bucket counts, carried as float32 ``[2, bins]`` rows
    ``[count // 2**24, count % 2**24]`` (each exact in float32, which the
    one metrics fetch carries); zeros without a carry.  A NaN compares
    below no edge: the overflow bucket, as ``searchsorted`` puts it."""
    bins = len(STALE_EDGES) + 1
    if sched_buf is None:
        return torch.zeros((2, bins), dtype=torch.float32, device=device)
    e = torch.tensor(STALE_EDGES, dtype=torch.float32, device=sched_buf.device)
    mag = sched_buf.abs().reshape(1, -1)
    at_or_below = (mag <= e[:, None]).sum(1)
    c = torch.diff(at_or_below, prepend=at_or_below.new_zeros(1),
                   append=at_or_below.new_full((1,), mag.shape[1]))
    return torch.stack([torch.div(c, 2 ** 24, rounding_mode="floor"),
                        torch.remainder(c, 2 ** 24)]).to(torch.float32)
