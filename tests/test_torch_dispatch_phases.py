"""The host's side of every dispatch (``tpu/introspect.py``): each serving
dispatcher of the port marks its record's phases (queue, issue, between,
wait, finish), the timeline totals them by kind and hands its closed
records to a poller (``since``), the OpenAI handlers bill their host time
(``telemetry.HandlerClock``), and the runner counts the prompt tokens the
prefix cache gave and the ones it computed. On the CPU with the tiny model
(and the echo model behind the OpenAI routes)."""

from __future__ import annotations

import json
import socket
import time
import urllib.request

import pytest

from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.tpu.device import TPUDevice
from gofr_tpu_torch.tpu.introspect import PHASES, DispatchTimeline, host_wait

TINY = {"TORCH_DEVICE": "cpu", "MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "4",
        "BATCH_TIMEOUT_MS": "1", "DECODE_CHUNK": "4", "DECODE_SLOTS": "4",
        "PREFILL_CHUNK_TOKENS": "32", "PREFIX_CACHE": "8", "PREFIX_LCP_MIN": "16",
        "MODEL_BUCKETS": "16,32,64,128", "LOG_LEVEL": "FATAL"}
DOC = [(7 * i + 3) % 250 + 1 for i in range(80)]  # 80 tokens: three 32-token slices
SHORT = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14]  # one batcher prefill
TAIL = [201, 202, 203, 204, 205]  # DOC + TAIL: a partial hit, a tail prefill


def _device(monkeypatch, **env):
    for key in DECLARED_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in {**TINY, **env}.items():
        monkeypatch.setenv(key, value)
    return TPUDevice(EnvFileConfig("/nonexistent"), Logger(Level.FATAL))


def _wait_idle(pool, timeout: float = 60.0) -> None:
    t0 = time.monotonic()
    while (pool._active or pool._in_flight) and time.monotonic() - t0 < timeout:
        time.sleep(0.01)


def _records(dev) -> list:
    """Every record of the ring, oldest first (the live objects)."""
    with dev.timeline._lock:
        return list(dev.timeline._ring)


def _ordered(rec) -> bool:
    marks = [rec.t_queued, rec.t_running, rec.t_issued]
    if rec.t_wait is not None:
        marks += [rec.t_wait, rec.t_synced]
    return all(a <= b for a, b in zip(marks, marks[1:] + [rec.t_done]))


@pytest.fixture
def served(monkeypatch):
    """A tiny device after a chunked prefill (a miss), a batcher prefill,
    a tail prefill (a partial hit) and their pooled decode."""
    dev = _device(monkeypatch)
    try:
        dev.generate(DOC, max_new_tokens=6)
        dev.generate(SHORT, max_new_tokens=6)
        dev.generate(DOC + TAIL, max_new_tokens=6)
        _wait_idle(dev.decode_pool)
        yield dev
    finally:
        dev.close()


def _of(dev, which: str) -> list:
    recs = [r for r in _records(dev) if r.status == "ok"]
    if which == "batcher prefill":
        return [r for r in recs if r.kind == "prefill"]
    if which == "chunked slice":
        return [r for r in recs if r.kind == "prefill_chunk" and not r.detail]
    if which == "tail prefill":
        return [r for r in recs if r.kind == "prefill_chunk" and r.detail.startswith("tail")]
    return [r for r in recs if r.kind == "decode_chunk"]


@pytest.mark.parametrize("which", ["batcher prefill", "chunked slice", "tail prefill",
                                   "pool chunk"])
def test_marks_are_ordered_on_every_dispatcher(served, which):
    recs = _of(served, which)
    assert recs, which
    for rec in recs:
        assert rec.t_issued is not None and _ordered(rec), rec.marks()
        assert rec.phases() is not None and min(rec.phases()) >= 0.0
        d = rec.to_dict()
        assert d["issue_s"] == pytest.approx(rec.t_issued - rec.t_running)
        assert {"wait_s", "finish_s"} <= set(d)
    if which != "chunked slice":
        assert all(r.t_wait is not None and r.t_synced is not None for r in recs)
        return
    # DOC's three slices: the first two have no host wait of their own,
    # the last waits for the prompt's first token
    assert len(recs) == 3
    assert [r.t_wait is None for r in recs] == [True, True, False]
    for rec in recs[:2]:
        assert rec.phases()[3:] == (0.0, 0.0)
        assert rec.to_dict()["wait_s"] == rec.to_dict()["finish_s"] == 0.0


def test_marks_are_ordered_on_a_spec_verify(monkeypatch):
    dev = _device(monkeypatch, SPEC_POOLED="on", SPEC_K_MAX="4", PREFIX_CACHE="0")
    try:
        dev.generate([7] * 30, max_new_tokens=24)
        _wait_idle(dev.decode_pool)
        verifies = [r for r in _records(dev) if r.kind == "spec_verify"]
        assert verifies and dev.decode_pool.occupancy()["spec"]["cycles"] == len(verifies)
        for rec in verifies:
            assert rec.t_wait is not None and _ordered(rec), rec.marks()
            assert rec.to_dict()["wait_s"] == pytest.approx(rec.t_synced - rec.t_wait)
    finally:
        dev.close()


class _Deferring:
    """A scheduler whose gate holds every prefill slice 20 ms."""

    def admit_prefill(self, tokens: int) -> float:
        time.sleep(0.02)
        return 0.02


def test_a_scheduler_defer_is_the_slice_queue_phase(monkeypatch):
    dev = _device(monkeypatch, PREFIX_CACHE="0")
    try:
        import numpy as np

        last = dev.timeline.stats()["total"]
        dev.runner._chunked_prefill(np.asarray(DOC, np.int32), bucket=32, scheduler=_Deferring())
        slices = [r for r in _records(dev) if r.dispatch_id > last]
        assert [r.kind for r in slices] == ["prefill_chunk"] * 3
        for rec in slices:
            assert rec.queue_wait >= 0.02 and rec.phases()[0] == rec.queue_wait
            # the gate is not the slice's issue: its launches begin after it
            assert rec.t_issued - rec.t_running < rec.t_issued - rec.t_queued - 0.019
    finally:
        dev.close()


def test_totals_are_the_sums_of_the_closed_records(served):
    recs = [r for r in _records(served) if r.phases() is not None]
    totals = served.timeline.stats()["phases"]
    assert set(totals) == {r.kind for r in recs} == {"prefill", "prefill_chunk",
                                                      "decode_chunk"}
    for kind, t in totals.items():
        mine = [r.phases() for r in recs if r.kind == kind]
        assert t["n"] == len(mine)
        for i, phase in enumerate(PHASES):
            assert t[f"{phase}_s"] == pytest.approx(sum(p[i] for p in mine), abs=1e-9)
    # the engine snapshot (/admin/engine) carries the same totals
    assert served.engine_snapshot()["dispatches"]["phases"] == totals


def test_phases_split_the_cost_models_inputs(served):
    """``queue_wait`` and ``duration`` keep their definitions: the queue
    phase is the queue wait, and issue + between + wait + finish is the
    duration (running to done) the cost rows are fitted on. A dispatch with
    no queue of its own (a pool chunk, a slice behind no scheduler) still
    reads a queue wait of about nothing."""
    marked = [r for r in _records(served) if r.phases() is not None]
    assert marked
    for rec in marked:
        p = rec.phases()
        assert rec.queue_wait == p[0]
        assert rec.duration == pytest.approx(sum(p[1:]), abs=1e-12)
        assert rec.duration == rec.t_done - rec.t_running
        assert rec.to_dict()["duration_s"] == rec.duration
        if rec.kind == "decode_chunk":
            assert rec.queue_wait == 0.0
        elif rec.kind == "prefill_chunk":
            assert rec.queue_wait < 0.05


def test_since_hands_over_closed_records_in_order():
    timeline = DispatchTimeline(capacity=8)
    a = timeline.begin("prefill_chunk")
    b = timeline.begin("decode_chunk")
    c = timeline.begin("prefill_chunk")
    a.mark_issued()
    timeline.finish(a)
    c.mark_issued()
    timeline.finish(c)
    # b still runs: the reader stops before it, so it misses nothing later
    assert [m["dispatch_id"] for m in timeline.since(0)] == [a.dispatch_id]
    b.mark_issued()
    with host_wait(b):
        pass
    timeline.finish(b)
    got = timeline.since(a.dispatch_id)
    assert [m["dispatch_id"] for m in got] == [b.dispatch_id, c.dispatch_id]
    assert got[0]["t_wait"] <= got[0]["t_synced"] <= got[0]["t_done"]
    assert set(got[0]) == {"dispatch_id", "kind", "status", "t_queued", "t_running",
                           "t_issued", "t_wait", "t_synced", "t_done"}
    assert timeline.since(c.dispatch_id) == []
    # an unmarked record (a boot stage) has no phases and adds to no total
    d = timeline.begin("warmup_compile")
    timeline.finish(d)
    assert d.phases() is None and "issue_s" not in d.to_dict()
    assert set(timeline.stats()["phases"]) == {"prefill_chunk", "decode_chunk"}


@pytest.mark.parametrize("mode", ["paged", "row"])
def test_prompt_tokens_on_a_miss_a_hit_and_a_partial_hit(monkeypatch, mode):
    dev = _device(monkeypatch, KV_PAGED="on" if mode == "paged" else "off")
    try:
        stats = dev.runner.prefix_stats

        def delta(prompt):
            before = (stats["prefix_tokens"], stats["prefill_tokens"])
            dev.generate(prompt, max_new_tokens=1)  # one token: no generation entry
            return stats["prefix_tokens"] - before[0], stats["prefill_tokens"] - before[1]

        assert delta(DOC) == (0, len(DOC))  # a miss: chunked
        assert delta(SHORT) == (0, len(SHORT))  # a miss: the batcher
        assert delta(DOC) == (len(DOC), 0)  # a hit
        assert delta(DOC + TAIL) == (len(DOC), len(TAIL))  # a partial hit
        assert (stats["hits"], stats["partial_hits"], stats["misses"]) == (1, 1, 2)
        assert dev.engine_snapshot()["caches"]["prefix"]["prefix_tokens"] == 2 * len(DOC)
    finally:
        dev.close()


# -- the OpenAI handlers' host time ---------------------------------------------------

ECHO = {"MODEL_NAME": "echo", "TOKENIZER": "byte", "BATCH_MAX_SIZE": "4",
        "BATCH_TIMEOUT_MS": "1", "LOG_LEVEL": "FATAL"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def echo_app(monkeypatch, tmp_path):
    import gofr_tpu_torch

    for key in DECLARED_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    for key, value in {**ECHO, "TORCH_DEVICE": "cpu", "HTTP_PORT": str(_free_port())}.items():
        monkeypatch.setenv(key, value)
    app = gofr_tpu_torch.new()
    gofr_tpu_torch.register_openai_routes(app)
    app.start()
    yield app
    app.shutdown()


def _post(app, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{app.http_port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read().decode()


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "whole"])
@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "count the host", "max_tokens": 5}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                              "max_tokens": 5}),
], ids=["completions", "chat"])
def test_the_handler_counter_grows(echo_app, stream, path, body):
    recorder = echo_app.container.telemetry
    before = recorder.handler_seconds()
    status, raw = _post(echo_app, path, {**body, "stream": stream})
    assert status == 200
    if stream:
        assert raw.rstrip().endswith("data: [DONE]")
    after = recorder.handler_seconds()
    assert after > before
    records = recorder.records(limit=1)
    assert records[0]["endpoint"] == path
    assert 0.0 < records[0]["handler_s"] <= after - before + 1e-9
    # the handler's share is host time, within the request's own span
    assert records[0]["handler_s"] <= records[0]["duration_s"] + 0.05
    snap = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{echo_app.http_port}/admin/engine", timeout=60).read())["data"]
    assert snap["handlers"]["host_s"] >= after


def test_a_request_in_flight_is_billed_as_it_goes():
    """The clock bills each stretch when it ends, before the request does;
    the waits it wraps are not billed."""
    from gofr_tpu_torch.telemetry import FlightRecorder, HandlerClock

    recorder = FlightRecorder()
    clock = HandlerClock(recorder)
    time.sleep(0.01)  # host work before the record starts
    record = recorder.start(model="m", endpoint="/e", activate=False)
    clock.attach(record)
    assert record.handler_s == recorder.handler_seconds() == 0.0  # billed at the first lap

    def tokens():
        for t in range(3):
            time.sleep(0.03)  # the wait on the device
            yield t

    seen = []
    for t in clock.waits(tokens()):
        seen.append((t, recorder.handler_seconds()))
        time.sleep(0.005)  # a frame's host work
    assert [t for t, _ in seen] == [0, 1, 2]
    assert seen[0][1] >= 0.01  # billed while the request is in flight
    clock.lap()
    total = recorder.handler_seconds()
    assert 0.025 <= total < 0.08  # 0.01 + 3 x 0.005, none of the 0.09 s of waits
    assert clock.waiting(time.sleep, 0.05) is None
    clock.lap()
    assert recorder.handler_seconds() - total < 0.02
    assert record.handler_s == pytest.approx(recorder.handler_seconds())
