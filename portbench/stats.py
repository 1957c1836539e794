"""End-to-end numbers from the client's records, and the spread that sets
a bound. A failed request counts against every latency as missing it: its
time to first token runs to when it failed, or to the end of the wait."""

from __future__ import annotations

import math
import statistics


def percentile(values: list, q: float) -> float:
    """Nearest-rank ``q``-th percentile (the value at rank ceil(q/100 · n))."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def spread(values: list) -> float:
    """Distance between the first and third quartiles as a share of the
    median (Python's ``statistics.quantiles``, exclusive method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def in_window(records: list, t0: float, seconds: float, closed: bool) -> list:
    """The requests of the window: due in it (open loop) or sent in it
    (closed loop)."""
    key = "sent" if closed else "due"
    return [r for r in records if r.get(key) is not None and t0 <= r[key] < t0 + seconds]


def ok(r: dict) -> bool:
    return r["status"] == "ok" and len(r["tokens"]) > 0


def ttft_s(r: dict, closed: bool) -> float:
    """First token's arrival from the due time (open) or send (closed); a
    failed request's runs to its end."""
    start = r["sent"] if closed else r["due"]
    end = r["token_times"][0] if ok(r) else r["done"]
    return end - start


def tpot_s(r: dict) -> "float | None":
    """(last token - first token) / (tokens - 1), for 2 tokens or more."""
    times = r["token_times"]
    if not ok(r) or len(times) < 2:
        return None
    return (times[-1] - times[0]) / (len(times) - 1)


def serving_metrics(records: list, t0: float, seconds: float, closed: bool) -> dict:
    """ttft_p95_ms over all the window's requests, tpot_p95_ms over those
    completed with 2 tokens or more, requests_per_s completed in the
    window, and the counts."""
    window = in_window(records, t0, seconds, closed)
    ttfts = [ttft_s(r, closed) for r in window]
    tpots = [t for t in (tpot_s(r) for r in window) if t is not None]
    completed = [r for r in records if ok(r) and t0 <= r["done"] < t0 + seconds]
    out = {
        "attempted": len(window),
        "failed": sum(1 for r in window if not ok(r)),
        "requests_per_s": len(completed) / seconds,
    }
    if ttfts:
        out["ttft_p95_ms"] = percentile(ttfts, 95) * 1e3
        out["ttft_p50_ms"] = statistics.median(ttfts) * 1e3
    if tpots:
        out["tpot_p95_ms"] = percentile(tpots, 95) * 1e3
        out["tpot_p50_ms"] = statistics.median(tpots) * 1e3
    return out


def backlog(records: list, t: float) -> int:
    """Requests due (or sent) by ``t`` and not finished by it."""
    return sum(1 for r in records if (r.get("due") or r.get("sent") or t + 1) <= t
               and r["done"] > t)
