"""The host's side of a serving run (``hostside.py``) and the prefix
cache's token share (``metrics/prefix_token_share.py``): the clock mapping
between the device trace and the program's marks, the split of the card's
idle seconds by what the host was doing, the readers on synthetic runs and
on a tiny run on the CPU, and on the card a known host span placed on its
device gap.

    python -m pytest portbench/tests -q            # here: the card test skips
    python -m pytest portbench/tests -q -m cuda    # on the card
"""

from __future__ import annotations

import time

import pytest

from conftest import make_checkout

from portbench import hostside, spec


def test_a_wall_stamp_maps_onto_the_monotonic_clock():
    pair = hostside.clock_pair()
    now_wall, now_mono = time.time_ns(), time.monotonic()
    assert abs(hostside.to_monotonic(now_wall, pair) - now_mono) < 1e-3
    assert hostside.to_monotonic(1_500, (1_000, 10)) == pytest.approx(510e-9)
    # the wall clock stepped 2 ms against the monotonic one: the drift
    assert hostside.drift_ns((1_000, 10), (3_001_000, 1_000_010)) == 2_000_000
    assert abs(hostside.drift_ns(pair, hostside.clock_pair())) < 1_000_000


def _rec(i, kind="decode_chunk", running=0.0, issued=None, wait=None, synced=None, done=None,
         queued=None):
    return {"dispatch_id": i, "kind": kind, "status": "ok",
            "t_queued": running if queued is None else queued, "t_running": running,
            "t_issued": issued, "t_wait": wait, "t_synced": synced, "t_done": done}


def test_idle_seconds_split_by_the_hosts_phases():
    """Busy 0-1 and 3-4 of a 0-6 window: idle 1-3 and 4-6. Two threads'
    issue phases overlap (1.5-2.5 and 2.0-3.0): one stretch, counted once;
    a wait 4.0-4.5; and 4.5-6 with no dispatch in either phase."""
    busy = [(3.0, 4.0), (0.0, 0.6), (0.5, 1.0)]
    recs = [_rec(1, running=1.5, issued=2.5, done=2.6),
            _rec(2, kind="prefill_chunk", running=2.0, issued=3.0, done=3.1),
            _rec(3, running=0.2, issued=0.4, wait=4.0, synced=4.5, done=4.6)]
    split = hostside.idle_split(busy, 0.0, 6.0, recs)
    assert split["idle_s"] == pytest.approx(4.0)
    # 1.5-3.0 in issue; 4.0-4.5 in a wait; 1.0-1.5 and 4.5-6.0 outside
    assert split["in_issue_s"] == pytest.approx(1.5)
    assert split["in_wait_s"] == pytest.approx(0.5)
    assert split["outside_s"] == pytest.approx(2.0)
    assert hostside.merge([(3, 4), (0, 1), (1, 2)]) == [(0, 2), (3, 4)]
    assert hostside.gaps([(1, 2)], 0, 3) == [(0, 1), (2, 3)]


def _run(window=(10.0, 20.0), prefix=None):
    start = {"pool_dispatches": 100, "prefix": {"hits": 0, "partial_hits": 0, "misses": 0}}
    end = {"pool_dispatches": 110, "prefix": {"hits": 3, "partial_hits": 0, "misses": 1}}
    if prefix is not None:
        start["prefix"].update(prefix_tokens=1_000, prefill_tokens=500)
        end["prefix"].update(prefix_tokens=1_000 + prefix[0], prefill_tokens=500 + prefix[1])
    return {"t0": window[0], "window_s": window[1] - window[0],
            "counters": {"start": start, "end": end}, "trace": None}


def test_the_readers_on_a_synthetic_run():
    """Ten chunks closed in a 10 s window (1,000 ms a chunk): each 0.5 s of
    issue, 0.1 s between, 0.2 s of wait and 0.05 s of finish; one before
    the window and one still open at its end are not counted. Two prefill
    dispatches queued 40 and 60 ms."""
    recs = [_rec(0, running=9.0, issued=9.5, wait=9.6, synced=9.8, done=9.85)]
    for k in range(10):
        t = 10.1 + k
        recs.append(_rec(k + 1, running=t, issued=t + 0.5, wait=t + 0.6, synced=t + 0.8,
                         done=t + 0.85))
    recs.append(_rec(11, running=19.5, issued=19.9, wait=19.95, synced=20.1, done=20.2))
    recs += [_rec(12, kind="prefill_chunk", queued=12.0, running=12.04, issued=12.2, done=12.25),
             _rec(13, kind="prefill", queued=13.0, running=13.06, issued=13.1, wait=13.1,
                  synced=13.3, done=13.31)]
    host = {"records": recs, "handler": [(9.9, 1.0), (10.2, 1.1), (19.9, 1.6), (20.1, 1.7)]}
    got = hostside.readings(_run(prefix=(300, 100)), host)
    assert got["pool_chunks_closed"] == 10
    assert got["pool_issue_ms"] == pytest.approx(500.0)
    assert got["pool_wait_ms"] == pytest.approx(200.0)
    assert got["pool_finish_ms"] == pytest.approx(50.0)
    assert got["pool_chunk_ms"] == pytest.approx(1_000.0)
    assert got["pool_rest_ms"] == pytest.approx(250.0)
    assert got["prefill_queue_ms"] == pytest.approx(50.0) and got["prefills_closed"] == 2
    assert got["http_busy_share"] == pytest.approx(100.0 * 0.6 / 10.0)
    assert got["prefix_token_share"] == pytest.approx(75.0)
    # the slice issuing 12.04-12.2 overlaps chunk 3's issue (12.1-12.6) by 0.1 s;
    # the batcher's prefill (13.06-13.1) ends as chunk 4 begins: no overlap
    assert (got["chunks_alone"], got["chunks_beside_prefill"]) == (9, 1)
    assert got["pool_issue_ms_alone"] == got["pool_issue_ms_beside_prefill"] == \
        pytest.approx(500.0)
    assert got["pool_issue_beside_prefill_share"] == pytest.approx(2.0)
    # chunks open 10.1-10.95, 11.1-11.95, ...: 0.15 s a second empty (the
    # first 0.1 s too, and the last chunk's 0.5 s open to the window's end)
    assert got["pool_empty_share"] == pytest.approx(100.0 * (0.1 + 9 * 0.15 + 0.0) / 10.0)
    assert "idle_s" not in got  # untraced
    # the parent's program: no marks, no handler clock, no token counts
    bare = hostside.readings(_run(), {"records": [], "handler": []})
    assert bare == {}


def test_prefix_token_share_reads_the_windows_token_counts():
    reader = spec.reader("prefix_token_share.docqa")
    assert reader.read(_run(prefix=(300, 100))) == pytest.approx(75.0)
    assert reader.read(_run(prefix=(0, 0))) is None
    assert reader.read(_run()) is None  # a program without the counts


def test_a_tiny_run_reads_the_hosts_side(tmp_path):
    """The poller around a real run of the program (tiny model, CPU): every
    counter reading, and the pool's phases within its chunk time."""
    root = make_checkout(tmp_path, mix="closed", kv_heads=4)
    out, got = hostside.execute("tiny.cell", 2**35 + 6, 2.0, False, root, device="cpu")
    assert out["correct"], out["checked"]
    for key in ("pool_issue_ms", "pool_wait_ms", "pool_finish_ms", "prefill_queue_ms",
                "http_busy_share", "prefix_token_share"):
        assert got[key] is not None and got[key] >= 0.0, key
    assert got["pool_issue_ms"] + got["pool_wait_ms"] + got["pool_finish_ms"] <= \
        got["pool_chunk_ms"] * 1.02
    assert 0.0 < got["prefix_token_share"] < 100.0  # later questions hit the document
    assert got["http_busy_share"] > 0.0


@pytest.mark.cuda
def test_a_host_span_lands_on_its_device_gap(card):
    """Between two kernels, a dispatch record's issue phase holds a 20 ms
    host sleep: mapped through the trace's clock pair, the device's idle
    gap between the kernels lies on that span within 0.5 ms, and the split
    counts it in the issue phase."""
    import torch

    from gofr_tpu_torch.tpu.introspect import DispatchTimeline, host_wait

    x = torch.randn(2048, 2048, device="cuda")
    trace = hostside.ClockedTrace()
    trace.arm()
    (x @ x).sum().item()
    torch.cuda.synchronize()
    trace.start()
    timeline = DispatchTimeline()
    (x @ x).sum().item()  # the card idles from here
    rec = timeline.begin("decode_chunk")
    rec.mark_running()
    time.sleep(0.02)
    y = x @ x
    rec.mark_issued()
    with host_wait(rec):
        torch.cuda.synchronize()
    timeline.finish(rec)
    trace.stop()
    out = trace.read()
    gap = max(hostside.gaps(out["busy_intervals"], trace.start_t, trace.stop_t),
              key=lambda g: g[1] - g[0])
    assert abs(gap[0] - rec.t_running) < 5e-4, (gap, rec.marks())
    assert abs(gap[1] - rec.t_issued) < 5e-4, (gap, rec.marks())
    split = hostside.idle_split(out["busy_intervals"], trace.start_t, trace.stop_t,
                                [rec.marks()])
    # the whole gap lies in the issue phase: the sleep and the launch after it
    assert split["in_issue_s"] >= 0.0195
    assert split["in_issue_s"] == pytest.approx(rec.t_issued - rec.t_running, abs=1e-3)
    assert abs(hostside.drift_ns(trace.start_pair, trace.stop_pair)) < 1_000_000
    del y
