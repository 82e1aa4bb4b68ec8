"""Federation algebra: per-round rates, width rates, the width-geometry
check and counted aggregation.

Port of the masked-strategy part of ``heterofl_tpu/fed/core.py``
(``sample_model_rates``/``round_rates``, core.py:33-58 and :145;
``validate_width_geometry``, :63-85; ``to_width_rates``,
``combine_counted``, :442-473).  The round engine works in the flat domain
(one buffer per tree, ops/fused_update.FlatSpec), so the counted average
takes flat buffers; the count masks are built by the engine from
``models.spec.param_mask``.

The ``dynamic`` rate draw comes from a ``torch.Generator`` on the host,
seeded from the round seed and :data:`ROUND_RATE_SALT`, so a round's rates
depend on (seed, round) alone and a resumed run draws what an uninterrupted
one drew.  The reference draws from ``jax.random``, which torch does not
reproduce: tests hand the reference's draws to the round engine instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

#: salt of the per-round rate stream (the reference's ``fold_in(round_key,
#: ROUND_RATE_SALT)``)
ROUND_RATE_SALT = 7


def rate_generator(round_seed: int) -> torch.Generator:
    """The generator of one round's rate draw."""
    state = np.random.SeedSequence([int(round_seed), ROUND_RATE_SALT]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def sample_model_rates(gen: Optional[torch.Generator], cfg: Dict[str, Any],
                       user_idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Absolute model rates (float32) of the given users (all when None) for
    one round.  ``fix``: the static per-user vector of ``process_control``,
    indexed by user.  ``dynamic``: every one of ``num_users`` draws a level
    i.i.d. with probabilities ``cfg['proportion']`` (ref fed.py:15-19), and
    the selected users' draws are kept, as the reference does."""
    users = np.arange(cfg["num_users"]) if user_idx is None \
        else np.asarray(user_idx, np.int64).reshape(-1)
    rates = np.asarray(cfg["model_rate"], np.float32)
    if cfg["model_split_mode"] == "fix":
        return rates[users]
    if cfg["model_split_mode"] == "dynamic":
        p = torch.as_tensor(cfg["proportion"], dtype=torch.float64)
        idx = torch.multinomial(p, cfg["num_users"], replacement=True, generator=gen)
        return rates[idx.numpy()][users]
    raise ValueError("Not valid model split mode")


def round_rates(round_seed: int, cfg: Dict[str, Any],
                user_idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """The rate draw of the round with seed ``round_seed``, salt included:
    the one definition of the rate stream, used by the experiment loop and
    by the round engine when it is handed no rates."""
    return sample_model_rates(rate_generator(round_seed), cfg, user_idx)


def validate_width_geometry(model, cfg: Dict[str, Any]) -> None:
    """Refuse width configs where the per-head q/k/v slice and the prefix
    width slice keep different numbers of dims at some level (ref
    fed/core.py:63-85; such a transformer trains NaN).  Raises with the
    reference's message."""
    rates = {float(r) / cfg["global_model_rate"] for r in cfg["model_rate"]}
    for name, g in model.groups.items():
        if g.kind != "per_head":
            continue
        hd = g.size // g.num_heads
        for wr in sorted(rates):
            if g.num_heads * math.ceil(hd * wr) != math.ceil(g.size * wr):
                raise ValueError(
                    f"width geometry: group {name!r} (size {g.size}, "
                    f"{g.num_heads} heads) is inconsistent at rate {wr:g}: "
                    f"per-head slice keeps {g.num_heads * math.ceil(hd * wr)} "
                    f"dims but the width slice keeps {math.ceil(g.size * wr)}; "
                    f"pick embedding_size so embedding*rate is a multiple-safe "
                    f"size (e.g. embedding_size*min_rate >= num_heads and "
                    f"head_dim divisible by 1/min_rate)")


def to_width_rates(model_rates, cfg: Dict[str, Any]) -> np.ndarray:
    """Absolute model rate -> width/scaler rate relative to the global model
    (float32, as the reference computes it)."""
    return np.asarray(model_rates, np.float32) / np.float32(cfg["global_model_rate"])


def combine_counted(global_flat: torch.Tensor, summed: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """Counted average with stale fallback: ``sum / count`` where some client
    held the entry, the previous global value elsewhere (ref fed.py:217-218)."""
    return torch.where(counts > 0, summed / counts.clamp_min(1.0), global_flat)
