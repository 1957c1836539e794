"""The generators: deterministic per seed, the stated distributions, and
the same set of sizes and gaps for every seed in another order."""

from __future__ import annotations

import statistics

import numpy as np
import pytest

from conftest import MIXES

from portbench import draw, spec

RAG = {"kind": "open_poisson", "rate_per_s": 5.0, "warm_s": 4, "schedule_seed": 1,
       "prompt": {"median": 2500, "sigma": 0.5, "min": 512, "max": 6144},
       "output": {"min": 8, "max": 32}}
DOCQA = {"kind": "closed_sessions", "workers": 4, "questions": 4, "sessions_per_worker": 6,
         "schedule_seed": 1,
         "warm_s": 2, "document": {"min": 3072, "max": 3808}, "question": {"min": 64, "max": 256},
         "output": {"min": 8, "max": 32}}
BIG = 2**40 + 12345  # seeds past 32 bits, as the driver draws them


@pytest.mark.parametrize("mix", [RAG, DOCQA, MIXES["open"], MIXES["closed"]],
                         ids=["rag", "docqa", "tiny-open", "tiny-closed"])
def test_deterministic_per_seed(mix):
    gen = spec.generator(mix["kind"])
    a = gen.plan(mix, 32768, BIG, 30)
    assert a == gen.plan(mix, 32768, BIG, 30)
    assert a != gen.plan(mix, 32768, BIG + 1, 30)


def _window(plan):
    return [r for r in plan["requests"] if r["due"] >= 0]


def test_open_loop_distributions():
    gen = spec.generator("open_poisson")
    w = _window(gen.plan(RAG, 32768, BIG, 40))
    assert len(w) == 200
    lens = [len(r["prompt"]) for r in w]
    assert min(lens) >= 512 and max(lens) <= 6144
    assert abs(statistics.median(lens) - 2500) < 40
    # lognormal sigma 0.5: the quartiles sit at median * exp(+-0.337)
    q1, _, q3 = statistics.quantiles(lens, n=4)
    assert abs(np.log(q3 / q1) / 2 - 0.5 * 0.6745) < 0.03
    outs = [r["max_tokens"] for r in w]
    assert min(outs) == 8 and max(outs) == 32
    dues = sorted(r["due"] for r in w)
    assert 0 < dues[0] and dues[-1] < 40
    gaps = np.diff([0.0] + dues)
    assert abs(gaps.mean() - 40 / 200) < 0.01
    assert abs(np.std(gaps) / gaps.mean() - 1.0) < 0.15  # exponential: cv 1
    warm = [r for r in gen.plan(RAG, 32768, BIG, 40)["requests"] if r["due"] < 0]
    assert len(warm) == 20 and min(r["due"] for r in warm) >= -4


@pytest.mark.parametrize("mix", [RAG, DOCQA], ids=["rag", "docqa"])
def test_same_work_every_seed(mix):
    """The run's seed draws the token ids; lengths, gaps and order come
    from the mix's schedule_seed."""
    gen = spec.generator(mix["kind"])
    a, b = gen.plan(mix, 32768, 1, 30), gen.plan(mix, 32768, BIG, 30)

    def shape(plan):
        if plan["mode"] == "open":
            return [(r["due"], len(r["prompt"]), r["max_tokens"]) for r in plan["requests"]]
        return [(len(s["doc"]), [(len(q["suffix"]), q["max_tokens"]) for q in s["questions"]])
                for w in plan["workers"] for s in w]

    assert shape(a) == shape(b)
    assert a != b
    assert shape(gen.plan(dict(mix, schedule_seed=2), 32768, 1, 30)) != shape(a)


def test_closed_sessions_distributions():
    gen = spec.generator("closed_sessions")
    p = gen.plan(DOCQA, 102400, BIG, 30)
    assert p["mode"] == "closed" and len(p["workers"]) == 4
    for sessions in p["workers"]:
        assert len(sessions) == 6
        for s in sessions:
            assert 3072 <= len(s["doc"]) <= 3808
            assert len(s["questions"]) == 4
            for q in s["questions"]:
                assert 64 <= len(q["suffix"]) <= 256 and 8 <= q["max_tokens"] <= 32
                assert len(s["doc"]) + len(q["suffix"]) + q["max_tokens"] <= 4096
    ids = [t for s in p["workers"][0] for t in s["doc"]]
    assert 0 <= min(ids) and max(ids) < 102400


def test_stratified_draws():
    g = draw.rng(3)
    vals = draw.uniform_int(100, 8, 32, g)
    assert sorted(vals) == sorted(draw.uniform_int(100, 8, 32, draw.rng(4)))
    counts = np.bincount(vals - 8)
    assert counts.max() - counts.min() <= 1
    t = draw.poisson_times(50, 10.0, draw.rng(5))
    assert 0 < t[0] and t[-1] < 10.0 and np.all(np.diff(t) > 0)
