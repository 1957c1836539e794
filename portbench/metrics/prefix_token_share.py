"""Share of the window's prompt tokens that the prefix cache gave:
Δprefix_tokens over Δ(prefix_tokens + prefill_tokens) of the runner's
``prefix_stats`` (the tokens a hit or a partial hit took from the cache,
and those a prefill computed, pad excluded), in %. Layer: the runner and
its prefix cache. None where the program keeps no such counts."""


def read(run: dict):
    s, e = run["counters"]["start"]["prefix"], run["counters"]["end"]["prefix"]
    if "prefix_tokens" not in e or "prefix_tokens" not in s:
        return None
    cached = e["prefix_tokens"] - s["prefix_tokens"]
    computed = e["prefill_tokens"] - s["prefill_tokens"]
    return 100.0 * cached / (cached + computed) if cached + computed > 0 else None
