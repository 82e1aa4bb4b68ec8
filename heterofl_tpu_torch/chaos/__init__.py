"""Chaos injection: client updates poisoned on purpose.

Port of the poison half of ``heterofl_tpu/chaos/__init__.py`` (its own
copy, numpy only): :func:`resolve_poison_cfg` validates
``cfg['chaos_poison']``, a list of ``[round, uid]`` pairs whose client
updates go NaN after local training and before aggregation
(:mod:`.inject`, called by both engines).  It is how the quarantine gate
and the watchdog's rollback are proved.  The reference's fault plans,
kills, checkpoint corruptions and drill are not ported here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def resolve_poison_cfg(cfg: Dict[str, Any]) -> Optional[np.ndarray]:
    """Validate ``cfg['chaos_poison']`` and return the int32 ``[N, 2]``
    (round, uid) table, or None when unset (ref chaos/__init__.py:66-93,
    its messages)."""
    raw = cfg.get("chaos_poison")
    if raw is None:
        return None
    if not isinstance(raw, (list, tuple)) or not raw:
        raise ValueError(f"Not valid chaos_poison: {raw!r} (a non-empty "
                         f"list of [round, uid] pairs, or None)")
    table = []
    for item in raw:
        if (not isinstance(item, (list, tuple)) or len(item) != 2
                or any(not isinstance(v, int) or isinstance(v, bool)
                       or v < 0 for v in item)):
            raise ValueError(f"Not valid chaos_poison entry: {item!r} "
                             f"(a [round >= 0, uid >= 0] int pair)")
        table.append((int(item[0]), int(item[1])))
    if (cfg.get("strategy", "masked") or "masked") == "sliced":
        raise ValueError(
            "Not valid chaos_poison with strategy='sliced': the sliced "
            "debug twin has no in-program update to poison -- use a "
            "mesh-native strategy ('masked' or 'grouped')")
    return np.asarray(table, np.int32)
