"""Seeded draws with a fixed set of values: every seed gets the same sizes
and gaps, stratified over the distribution's quantiles, in an order of its
own. Runs with different seeds then do the same work, and differ only in
the order and in the token ids."""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream): any whole seed, 64 bits
    or more included."""
    return np.random.default_rng([int(seed) & (2**64 - 1), int(seed) >> 64, *stream])


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lognormal(n: int, median: float, sigma: float, lo: int, hi: int,
              gen: np.random.Generator) -> np.ndarray:
    """``n`` whole lengths, lognormal (``median``, ``sigma``) clipped to [lo, hi]."""
    z = np.array([NormalDist().inv_cdf(q) for q in _quantiles(n)])
    vals = np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)
    return gen.permutation(vals)


def uniform_int(n: int, lo: int, hi: int, gen: np.random.Generator) -> np.ndarray:
    """``n`` whole values spread evenly over [lo, hi]."""
    vals = lo + np.floor(_quantiles(n) * (hi - lo + 1)).astype(np.int64)
    return gen.permutation(vals)


def poisson_times(n: int, span_s: float, gen: np.random.Generator) -> np.ndarray:
    """``n`` arrival offsets in (0, span_s): exponential gaps at the
    quantiles of rate n / span_s, shuffled, the first counted from 0, all
    scaled so that one gap more would end the span."""
    if n <= 0:
        return np.zeros(0)
    gaps = -np.log1p(-_quantiles(n))
    return np.cumsum(gen.permutation(gaps)) * (span_s / (math.fsum(gaps) + gaps.mean()))


def tokens(n: int, vocab: int, gen: np.random.Generator) -> list:
    """``n`` token ids drawn uniformly from the vocabulary."""
    return gen.integers(0, vocab, n).tolist()
