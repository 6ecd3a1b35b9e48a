"""A saturated backlog: the engine's waiting queue is topped up to
``depth`` requests before every step, so it never runs dry, and the
window opens in steady state with ``max_batch`` requests in service whose
remaining outputs are the residual of the output distribution (each was
prefilled, and gave its first token, in set-up).  ``max_rate_per_s`` only
sizes the pool of requests the run can draw from; a run that exhausts it
fails."""

import math

import numpy as np

OPEN = False


def count(params: dict, seconds: float) -> int:
    return math.ceil(params["max_rate_per_s"] * seconds)


def due(params: dict, seconds: float, n: int, rng) -> np.ndarray:
    return np.zeros(n)


def warm_lanes(params: dict, engine: dict) -> int:
    return engine["max_batch"]
