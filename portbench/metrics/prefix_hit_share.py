"""Share of the window's prefix-cache lookups that hit, whole or in part
(``prefix_stats``: (hits + partial hits) over lookups), in %. Layer: the
runner and its prefix cache."""


def read(run: dict):
    s, e = run["counters"]["start"]["prefix"], run["counters"]["end"]["prefix"]
    d = {k: e[k] - s[k] for k in ("hits", "partial_hits", "misses")}
    lookups = d["hits"] + d["partial_hits"] + d["misses"]
    return 100.0 * (d["hits"] + d["partial_hits"]) / lookups if lookups else None
