"""Storage-tier planning (the port of ``repro/core/tierstore.py``, its pure
functions so far): the demotion policy and the disk prefetch ring's
depth, which the memory model's tier accounting calls
(``core.memory_model.estimate``).  The disk tier itself (the segment
store, the tier chain) is not ported yet.
"""
from __future__ import annotations

from typing import List


def demote_plan(per_layer_bytes: List[int], n_layers: List[int],
                host_budget: int) -> List[int]:
    """Hot (host-resident) row count per group under ``host_budget``.

    Rows are demoted coldest-first: last group's last rows first, walking
    toward group 0, until the resident stacked state fits the budget.
    ``host_budget <= 0`` demotes everything (the fully-streamed mode); a
    budget larger than the total demotes nothing."""
    assert len(per_layer_bytes) == len(n_layers)
    if host_budget <= 0:
        return [0] * len(n_layers)
    hot = list(n_layers)
    resident = sum(b * n for b, n in zip(per_layer_bytes, n_layers))
    for gi in range(len(n_layers) - 1, -1, -1):
        if resident <= host_budget:
            break
        over = resident - host_budget
        drop = min(hot[gi], -(-over // max(per_layer_bytes[gi], 1)))
        hot[gi] -= drop
        resident -= drop * per_layer_bytes[gi]
    return hot


def ring_depth(prefetch_depth: int, chunk_bytes: int, slack: int,
               bounded: bool) -> int:
    """Effective read-ahead depth of the disk prefetch ring: the
    configured ``prefetch_depth``, shrunk so the in-flight chunks fit the
    host-budget ``slack`` when the budget is ``bounded`` (never below 1
    in-flight read)."""
    k = max(1, int(prefetch_depth))
    if not bounded or chunk_bytes <= 0:
        return k
    return max(1, min(k, slack // chunk_bytes))
