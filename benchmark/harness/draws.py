"""Seeded draws shared by the traffic kinds.

Lengths come from a fixed set of quantiles of their distribution, and the
seed only orders them: every seed gives the same sizes in another order, so a
seed never changes the amount of work.  Token ids, condition vectors, paths
and arrival orders come from ``numpy.random.default_rng(seed)`` (any seed,
also past 32 bits) or a ``torch.Generator`` seeded alike.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def lognormal_lengths(count: int, median: float, sigma: float, low: int, high: int) -> np.ndarray:
    """``count`` lengths at the quantiles (i + 0.5) / count of a log-normal
    of ``median`` and log-sd ``sigma``, clipped to [low, high], ascending."""
    nd = NormalDist()
    q = [(i + 0.5) / count for i in range(count)]
    vals = [median * math.exp(sigma * nd.inv_cdf(p)) for p in q]
    return np.clip(np.rint(vals), low, high).astype(np.int64)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` and a stream of sub-keys."""
    return np.random.default_rng([int(x) % 2 ** 64 for x in (seed, *stream)])


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from ``seed`` and a
    stream."""
    return int(rng(seed, *stream).integers(0, 2 ** 63 - 1))


def zipf_ranks(r: np.random.Generator, count: int, pool: int, s: float) -> np.ndarray:
    """``count`` ranks in [0, pool) with P(i) ∝ 1 / (i + 1)^s."""
    p = 1.0 / np.arange(1, pool + 1) ** s
    return r.choice(pool, size=count, p=p / p.sum())
