"""An open loop: independent users whose requests arrive as a Poisson
stream at a fixed rate, whatever the server's speed. Each request is a
fresh prompt (no shared prefix) with a greedy answer.

Parameters (``traffic/<mix>.json``): ``rate_per_s``; ``warm_s``, the
seconds of the same traffic sent before the window (set-up); ``prompt``
``{median, sigma, min, max}`` (lognormal tokens); ``output`` ``{min,
max}`` (uniform tokens); ``schedule_seed``. The lengths, gaps and their
order come from ``schedule_seed``, stratified apart for the window and the
warm-up, so every run does the same work at the same times; the run's seed
draws the token ids (and the weights).
"""

from __future__ import annotations

from portbench import draw

DRIVER = "serve"  # portbench/serve.py runs this mix


def plan(traffic: dict, vocab: int, seed: int, seconds: float) -> dict:
    rate = float(traffic["rate_per_s"])
    warm = float(traffic["warm_s"])
    p, o = traffic["prompt"], traffic["output"]
    requests = []
    for stream, (start, span) in enumerate(((-warm, warm), (0.0, float(seconds)))):
        n = int(round(rate * span))
        g = draw.rng(traffic["schedule_seed"], 1, stream)
        lens = draw.lognormal(n, p["median"], p["sigma"], p["min"], p["max"], g)
        outs = draw.uniform_int(n, o["min"], o["max"], g)
        times = draw.poisson_times(n, span, g)
        ids = draw.rng(seed, 1, stream)
        for t, length, out in zip(times, lens, outs):
            requests.append({"due": start + float(t), "max_tokens": int(out),
                             "prompt": draw.tokens(int(length), vocab, ids)})
    return {"mode": "open", "warm_s": warm, "requests": requests}
