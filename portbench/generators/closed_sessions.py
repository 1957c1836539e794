"""A closed loop of sessions: ``workers`` callers, each of which takes a
fresh document and asks ``questions`` questions about it in turn (the
document followed by one question's tokens), waiting for each answer
before the next, then takes the next document. Every question after a
session's first shares the document with an earlier prompt.

Parameters (``traffic/<mix>.json``): ``workers``, ``questions``,
``sessions_per_worker`` (enough never to run out), ``warm_s`` (seconds the
loop runs before the window: set-up), ``document`` ``{min, max}``,
``question`` ``{min, max}`` and ``output`` ``{min, max}`` (uniform
tokens), and ``schedule_seed``, which draws every length and its order:
every run does the same work, and the run's seed draws the token ids.
"""

from __future__ import annotations

from portbench import draw

DRIVER = "serve"  # portbench/serve.py runs this mix


def plan(traffic: dict, vocab: int, seed: int, seconds: float) -> dict:
    workers = int(traffic["workers"])
    n_q = int(traffic["questions"])
    n_s = int(traffic["sessions_per_worker"])
    d, q, o = traffic["document"], traffic["question"], traffic["output"]
    plans = []
    for w in range(workers):
        g = draw.rng(traffic["schedule_seed"], 2, w)
        docs = draw.uniform_int(n_s, d["min"], d["max"], g)
        suffixes = draw.uniform_int(n_s * n_q, q["min"], q["max"], g)
        outs = draw.uniform_int(n_s * n_q, o["min"], o["max"], g)
        ids = draw.rng(seed, 2, w)
        sessions = []
        for s, doc_len in enumerate(docs):
            sessions.append({
                "doc": draw.tokens(int(doc_len), vocab, ids),
                "questions": [
                    {"suffix": draw.tokens(int(suffixes[s * n_q + i]), vocab, ids),
                     "max_tokens": int(outs[s * n_q + i])}
                    for i in range(n_q)
                ],
            })
        plans.append(sessions)
    return {"mode": "closed", "warm_s": float(traffic["warm_s"]), "workers": plans}
