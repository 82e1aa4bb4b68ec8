"""Device memory against an analytic ceiling (ref staticcheck/memory.py).

The reference holds XLA's ``memory_analysis()`` fields to bounds derived
from :func:`~..fed.core.level_byte_table`.  Its counterpart on the card is
what the caching allocator saw over a program's dispatches:
``torch.cuda.max_memory_allocated`` (peak allocated bytes) and the bytes
its captured steps' graph pool grew by (``step_graph.STATS["pool_bytes"]``).
:func:`analytic_budget` derives one ceiling from the byte table:

* the working set ``clients x ACT_WORKING_SET x activation_bytes`` (a
  step's forward outputs, what backward keeps, the gradient workspace, for
  the clients a step runs at once) ``+ CARRY_COPIES x param_bytes`` (the
  global params, the round's sums and counts, each client's params,
  momentum and gradient, the codec's residual) ``+`` the staged operands;
* ``peak_budget = PEAK_FACTOR x working + SLACK``, ``pool_budget =
  POOL_FACTOR x clients x ACT_WORKING_SET x activation_bytes + SLACK``
  (an engine's captured steps share one pool, which holds a step's
  temporaries).

The factors are generous ceilings, not fits: they catch an order of
magnitude (a leaked copy a step, a graph a dispatch); the ratchet
(:mod:`.ratchet`, 25% headroom) holds the measured MB.  On the CPU only
the analytic half is computed.  Torch-free.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

ACT_WORKING_SET = 3
CARRY_COPIES = 10
PEAK_FACTOR = 4.0
POOL_FACTOR = 4.0
#: the CUDA context's own allocations stay outside the caching allocator;
#: this covers cuDNN's and cuBLAS's workspaces and the allocator's rounding
SLACK = 256 << 20


def analytic_budget(param_bytes: int, activation_bytes: int, clients: int,
                    staged_bytes: int) -> Dict[str, Any]:
    """The program's analytic ceilings (bytes) and their inputs."""
    act = clients * ACT_WORKING_SET * activation_bytes
    working = act + CARRY_COPIES * param_bytes + staged_bytes
    return {"peak_budget": int(PEAK_FACTOR * working) + SLACK,
            "pool_budget": int(POOL_FACTOR * act) + SLACK,
            "inputs": {"param_bytes": int(param_bytes),
                       "activation_bytes": int(activation_bytes),
                       "clients": int(clients), "staged_bytes": int(staged_bytes)}}


def check_memory(rep, mem: Optional[Dict[str, Any]], budget: Dict[str, Any]) -> None:
    """Hold a program's measured peak and pool bytes (card) to the ceilings
    (``hbm-budget`` names the field and both numbers); on the CPU ``mem``
    has no measured fields and nothing is checked."""
    if not mem:
        return
    for field, bkey in (("peak_bytes", "peak_budget"), ("pool_bytes", "pool_budget")):
        if mem.get(field) is not None and mem[field] > budget[bkey]:
            rep.fail("hbm-budget", f"{field} = {mem[field]} exceeds the analytic ceiling "
                     f"{budget[bkey]} ({bkey}; inputs {budget['inputs']})")
