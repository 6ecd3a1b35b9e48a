"""Open-loop Poisson arrivals at ``rate_per_s``: independent users who send
whether or not earlier requests have finished.  ``rate_per_s * seconds``
requests, rounded; their gaps are the exponential's quantiles at
``(i + 0.5) / n`` in the order ``rng`` gives (the generator's fixed
schedule), scaled so that the n gaps sum to the window (the first request
is due at its start, the last gap runs to its end)."""

import math

import numpy as np

OPEN = True


def count(params: dict, seconds: float) -> int:
    return max(1, round(params["rate_per_s"] * seconds))


def due(params: dict, seconds: float, n: int, rng) -> np.ndarray:
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def warm_lanes(params: dict, engine: dict) -> int:
    return 0
