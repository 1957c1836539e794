"""The end-to-end arithmetic: p95 by nearest rank, rates over the window,
and a failed request counted as missing."""

from __future__ import annotations

import pytest

from portbench import stats


def _rec(i, due, first, n=4, step=0.1, status="ok", sent=None):
    times = [first + k * step for k in range(n)] if status == "ok" else []
    return {"i": i, "due": due, "sent": due if sent is None else sent, "token_times": times,
            "tokens": list(range(len(times))), "status": status,
            "done": (times[-1] if times else first)}


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(list(range(1, 21)), 95) == 19


def test_window_rates_and_latencies():
    t0 = 100.0
    recs = [_rec(i, t0 + i, t0 + i + 0.5) for i in range(10)]
    recs.append(_rec(10, t0 - 1, t0 - 0.5))  # before the window: not counted
    m = stats.serving_metrics(recs, t0, 10.0, closed=False)
    assert m["attempted"] == 10 and m["failed"] == 0
    assert m["ttft_p95_ms"] == pytest.approx(500.0)
    assert m["tpot_p95_ms"] == pytest.approx(100.0)
    # done = due + 0.8: all ten end inside the window
    assert m["requests_per_s"] == pytest.approx(1.0)
    recs[9]["done"] = t0 + 10.5  # ends after the close: attempted, not completed in it
    assert stats.serving_metrics(recs, t0, 10.0, closed=False)["requests_per_s"] == 0.9


def test_failure_counts_as_missing():
    t0 = 0.0
    recs = [_rec(i, float(i), i + 0.2) for i in range(19)]
    recs.append(_rec(19, 0.5, 9.5, status="ConnectionResetError: boom"))
    m = stats.serving_metrics(recs, t0, 20.0, closed=False)
    assert m["failed"] == 1 and m["attempted"] == 20
    # the failure waited 9 s: the p95 of 20 is the 19th smallest, 200 ms,
    # and the worst (max) is the failure
    assert m["ttft_p95_ms"] == pytest.approx(200.0)
    assert stats.percentile([stats.ttft_s(r, False) for r in recs], 100) == pytest.approx(9.0)
    recs[0]["status"] = "http 500"
    m = stats.serving_metrics(recs, t0, 20.0, closed=False)
    assert m["failed"] == 2 and m["ttft_p95_ms"] == pytest.approx(500.0)  # now the 19th


def test_closed_loop_times_from_send():
    r = _rec(0, None, 5.0, sent=4.0)
    r["due"] = None
    assert stats.ttft_s(r, closed=True) == pytest.approx(1.0)
    assert stats.in_window([r], 3.0, 2.0, closed=True) == [r]


def test_spread():
    assert stats.spread([10, 10, 10, 10, 10, 10]) == 0.0
    assert stats.spread([9, 10, 10, 10, 10, 11]) == pytest.approx((10.25 - 9.75) / 10)
