"""Health probes and the quarantine gate on the device.

Port of ``heterofl_tpu/obs/probes.py`` (``round_probes``,
``quarantine_gate``), as functions on the port's flat params buffer ``P
[total]`` and its :class:`~..ops.fused_update.FlatSpec` segments (one
segment a leaf of the reference's params dict).  Plain PyTorch reductions
on the compute stream, run eagerly after a round's aggregation (never
inside a captured step); their results stay on the device until the
round's (the superstep's) one metrics fetch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.fused_update import FlatSpec


def segment_ends(spec: FlatSpec, device: torch.device) -> torch.Tensor:
    """The index of each leaf's last entry in the flat layout, in flat
    order, on the device (the non-finite counter's segments)."""
    return torch.tensor([spec.offsets[k] + spec.sizes[k] - 1 for k in spec.names],
                        dtype=torch.int64, device=device)


def round_probes(ends: torch.Tensor, P: torch.Tensor, new_P: torch.Tensor,
                 summed: torch.Tensor, counts: torch.Tensor,
                 resid: Optional[torch.Tensor] = None,
                 sched_buf: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One round's probe leaves, each a float32 ``[1]`` device tensor (ref
    obs/probes.py:77-131).  ``P``/``new_P``: the flat params before and
    after the combine; ``summed``/``counts``: the round's aggregates after
    the wire codec (dequantised); ``resid``: the new error-feedback carry
    (None under dense); ``sched_buf``: the new staleness carry (None under
    sync aggregation); ``ends``: :func:`segment_ends` of the layout.  No
    op here reads a value back to the host.

    * ``obs_update_sq`` -- squared norm of the applied update ``new - old``;
    * ``obs_grad_sq`` -- squared norm of the counted-average client delta
      ``(summed - old * counts) / max(counts, 1)``;
    * ``obs_resid_sq`` -- the residual's sum of squares (0 under dense);
    * ``obs_stale_sq`` -- the staleness carry's sum of squares (0 under
      sync aggregation);
    * ``obs_nonfinite`` -- how many LEAVES of ``new_P`` hold a non-finite
      element: the running count of non-finite entries, read at each
      leaf's last entry, grows across that leaf exactly when it holds one."""
    d = new_P - P
    g = (summed - P * counts) / counts.clamp_min(1.0)
    run = torch.cumsum((~torch.isfinite(new_P)).to(torch.int32), 0, dtype=torch.int32)
    at_end = run.index_select(0, ends)
    per_leaf = at_end - torch.cat([at_end.new_zeros(1), at_end[:-1]])
    zero = P.new_zeros(())
    return {
        "obs_update_sq": torch.sum(d * d).reshape(1),
        "obs_grad_sq": torch.sum(g * g).reshape(1),
        "obs_resid_sq": (zero if resid is None else torch.sum(resid * resid)).reshape(1),
        "obs_stale_sq": (zero if sched_buf is None
                         else torch.sum(sched_buf * sched_buf)).reshape(1),
        "obs_nonfinite": (per_leaf > 0).sum().to(torch.float32).reshape(1),
    }


def quarantine_gate(trained: torch.Tensor, ref: torch.Tensor, cm: torch.Tensor,
                    max_norm: Optional[float] = None) -> torch.Tensor:
    """The update-quarantine gate (ref obs/probes.py:39-80): a bool device
    tensor, one entry a row of ``trained`` (``[n]``: a scalar; ``[G, n]``:
    ``[G]``) -- True keeps the client's update.  It trips on any non-finite
    element of the trained row and, with ``max_norm``, on a masked update
    norm ``|(trained - ref) * cm|`` above it (``cm``: the row's count
    mask, the aggregation weights; ``ref``: the params it trained from).  A
    non-finite delta fails the norm comparison too (NaN compares False)."""
    ok = torch.isfinite(trained).all(dim=-1)
    if max_norm is not None:
        d = (trained - ref) * cm
        bound = float(np.float32(max_norm) ** 2)  # the reference's float32 square
        ok = ok & (torch.sum(d * d, dim=-1) <= bound)
    return ok
