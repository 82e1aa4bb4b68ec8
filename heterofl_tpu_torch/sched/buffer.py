"""Buffered asynchronous aggregation: the staleness carry.

Port of ``heterofl_tpu/sched/buffer.py``.  With
``cfg['schedule']['aggregation'] = 'buffered'`` the server applies a
cohort's update one round late: a ``[2, total]`` buffer on the device
holds the previous round's reduced ``(sums, counts)`` in the flat layout
(``ops/fused_update.FlatSpec``), and each round (a) trains its cohort on
params that do not include that update yet and (b) mixes the buffered
update in with the weight :func:`~heterofl_tpu_torch.sched.staleness_weight`
``(alpha, 1)``.  Entries no buffered client held keep the previous global
value (the counted average's stale rule).

The buffer itself lives on the engine beside the wire codec's residual
(``parallel/round_engine.FlatParams``: ``sched_buf_host`` /
``set_sched_buf``), one copy for both engines, and is checkpointed under
``sched_buf`` in the reference's flat layout.  The combine is a few
elementwise tensor ops; the reference computes it in XLA outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import staleness_weight

#: rounds the buffer holds an update before it lands
BUFFER_STALENESS = 1


def buffered_combine(P: torch.Tensor, buf: torch.Tensor, summed: torch.Tensor,
                     counts: torch.Tensor, alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One buffered server step on the flat params ``P [total]``: apply the
    buffered update ``buf [2, total]`` with weight ``w =
    staleness_weight(alpha, 1)`` -- ``where(bcnt > 0, (1 - w) * P + w *
    (bsum / max(bcnt, 1)), P)``, the reference's order of operations -- and
    buffer this round's reduced ``(summed, counts)`` -> ``(new P, new
    buf)``.  A zero buffer (the first round) leaves ``P`` as it is."""
    w = staleness_weight(alpha, BUFFER_STALENESS)
    bsum, bcnt = buf[0], buf[1]
    new_p = torch.where(bcnt > 0, (1.0 - w) * P + w * (bsum / bcnt.clamp_min(1.0)), P)
    return new_p, torch.stack([summed, counts])
