"""What the per-layer readers share: the work the program did inside the
traced window, counted from every request's lengths and token arrival
times with ``flops.py``, and the window's counter deltas.

A request's work is placed in time by what the client saw on its own
monotonic clock (the system's, which the server's trace stamps share):
a decode step by the arrival of the token it produced, a prefill slice
at its share of the way from the request's send to its first token (a
chunked prefill's slices run one between two decode chunks). Every
record counts, the warm phase's and those in flight at either edge of
the window alike, so the count does not depend on how long requests
take. Steps of a decode chunk reach the client together when the chunk
ends, so each edge of the window is placed to within one chunk."""

from __future__ import annotations

from portbench import flops


def delta(run: dict, key: str) -> float:
    c = run["counters"]
    return c["end"][key] - c["start"][key]


def computed_from(r: dict) -> int:
    """The first prompt position the program had to compute: a session's
    later questions need only what follows the document they share with
    its first (what the prefix cache holds); everything else from 0."""
    return r["doc_len"] if r.get("q", 0) > 0 else 0


def prefill_calls(run: dict, r: dict) -> list:
    """(rows, offset) of a request's prefill calls: one within the chunk
    width, slices of it past it."""
    return flops.prefill_calls(r["prompt_len"], computed_from(r), run["prefill_width"])


def decode_offsets(r: dict) -> range:
    """Cache lengths before each decode step: every token but the first,
    which the prefill gives."""
    p = r["prompt_len"]
    return range(p, p + len(r["tokens"]) - 1)


def window_calls(run: dict) -> tuple:
    """The calls the program ran inside the traced window, over every
    record. -> (prefill [(rows, offset)], decode [(1, offset)])."""
    tr = run["trace"]
    start, end = tr["start"], tr["end"]
    prefill, decode = [], []
    for r in run["records"]:
        times = r.get("token_times") or []
        if not times or r.get("sent") is None:
            continue
        calls = prefill_calls(run, r)
        span = times[0] - r["sent"]
        for k, call in enumerate(calls):
            if start <= r["sent"] + span * (k + 1) / len(calls) <= end:
                prefill.append(call)
        for t, off in zip(times[1:], decode_offsets(r)):
            if start <= t <= end:
                decode.append((1, off))
    return prefill, decode


def step_mfu(run: dict) -> "float | None":
    """The window's operations (products and causal attention, prefill
    and decode) over the traced window at the card's bf16 peak, in %."""
    if run.get("trace") is None:
        return None
    prefill, decode = window_calls(run)
    m = run["model"]
    work = sum(flops.forward_flops(m, rows, off) for rows, off in prefill + decode)
    if work <= 0:
        return None
    return 100.0 * work / (run["trace"]["window_s"] * flops.PEAK_FLOPS_BF16)


def attention_share(run: dict, calls: list, needles: tuple) -> "float | None":
    """Least time of ``calls`` (each layer's attention) over the device
    seconds of the kernels named by ``needles``, in %."""
    from portbench.devtrace import seconds_of

    m = run["model"]
    hd = m["dim"] // m["n_heads"]
    least = sum(flops.attention_bound_s(rows, off, m["n_heads"], m["n_kv_heads"], hd)[0]
                for rows, off in calls)
    spent = seconds_of(run["trace"], *needles)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least * m["n_layers"] / spent


def device_idle(run: dict) -> "float | None":
    tr = run.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
