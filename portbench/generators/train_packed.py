"""Training batches: a seeded corpus of documents with lognormal lengths
and uniform token ids, packed end to end with an end-of-sequence id
between them, cut into consecutive crops of ``seq`` tokens (the model
reads ``seq - 1`` and predicts the next of each). Step ``k`` takes the
``k``-th ``batch`` crops, so every row of every step differs.

Parameters (``traffic/<mix>.json``): ``batch``, ``seq``, ``eos``,
``document`` ``{median, sigma, min, max}``, ``lr`` (AdamW's rate),
``checked_steps`` (the first steps the reference follows) and
``warm_steps`` (further steps before the window).
"""

from __future__ import annotations

import numpy as np

from portbench import draw

DRIVER = "train"  # portbench/train.py runs this mix


class Batches:
    """``batch(k)`` -> int64 [batch, seq] of step ``k`` (from 0)."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.traffic, self.vocab, self.seed = traffic, vocab, seed
        self.rows, self.seq = int(traffic["batch"]), int(traffic["seq"])

    def batch(self, k: int) -> np.ndarray:
        d = self.traffic["document"]
        g = draw.rng(self.seed, 3, k)
        need = self.rows * self.seq
        lens = draw.lognormal(max(8, 4 * need // d["median"]), d["median"], d["sigma"],
                              d["min"], d["max"], g)
        stream = []
        for n in lens:
            stream.extend(draw.tokens(int(n), self.vocab, g))
            stream.append(int(self.traffic["eos"]))
            if len(stream) >= need:
                break
        while len(stream) < need:  # lengths too short for the crops: draw on
            stream.extend(draw.tokens(need - len(stream), self.vocab, g))
        return np.asarray(stream[:need], dtype=np.int64).reshape(self.rows, self.seq)


def plan(traffic: dict, vocab: int, seed: int, seconds: float) -> dict:
    return {"mode": "train", "batches": Batches(traffic, vocab, seed)}
