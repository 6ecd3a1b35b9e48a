"""Application hints the serving engine uses (subset of ``repro/core/hints.py``).

The port copies only what the engine needs — fair-share apportionment and
deadline headroom — so that it imports nothing of the JAX package.  The
rest of the hint vocabulary (access advice, prefetch planning, the
page-size advisor) belongs to the host pager, which the port does not
carry yet.
"""

from __future__ import annotations

import math


def fair_shares(weights: "dict[str, float]", total_pages: int
                ) -> "dict[str, int]":
    """Apportion a page budget across tenants by weight (DESIGN.md §16.2).

    Largest-remainder apportionment: shares sum exactly to ``total_pages``,
    every tenant with positive weight gets its floor, and leftover pages go
    to the largest fractional remainders (ties broken by tenant name for
    determinism).
    """
    if total_pages < 0:
        raise ValueError("total_pages must be >= 0")
    if not weights:
        return {}
    wsum = float(sum(weights.values()))
    if wsum <= 0 or any(w < 0 for w in weights.values()):
        raise ValueError("tenant weights must be non-negative, sum > 0")
    exact = {name: total_pages * w / wsum for name, w in weights.items()}
    shares = {name: int(exact[name]) for name in weights}
    leftover = total_pages - sum(shares.values())
    by_remainder = sorted(weights, key=lambda n: (shares[n] - exact[n], n))
    for name in by_remainder[:leftover]:
        shares[name] += 1
    return shares


def deadline_headroom_s(deadline_s: "float | None", submitted_at: float,
                        now: float) -> float:
    """Remaining SLO budget of a request in seconds (DESIGN.md §16.3).

    ``inf`` when the request carries no deadline; negative once the
    deadline has been missed.
    """
    if deadline_s is None:
        return math.inf
    return deadline_s - (now - submitted_at)
