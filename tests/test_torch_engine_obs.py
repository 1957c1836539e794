"""gofr_tpu_torch's engine introspection (``tpu/introspect.py``: the
dispatch timeline, the engine state machine, the stall watchdog) against
gofr_tpu's (``tests/test_engine_obs.py``).

- Unit: the same operations on both timelines give the same ids, ring
  bounds, filters and in-flight views; the same transitions give the same
  state history; a watched stall walks degraded -> wedged -> serving and
  counts one stall in both packages.
- Over HTTP, a JAX echo app and the port's take the same traffic:
  ``/admin/dispatches`` kinds, buckets, batch sizes and padded tokens
  equal, every flight record's dispatch ids resolve, and an injected stall
  (the echo runner's ``stall_hook``) walks both engines through the same
  states, with the port's readiness 503 and its watchdog evidence meanwhile.
- The tiny model on the CPU (``TORCH_DEVICE=cpu``, JAX's weights carried
  over): the ``gofr_tpu_mfu``, compile and cache series carry the JAX
  package's names and labels, and the request and dispatch records match in
  count.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.telemetry as jt
import gofr_tpu.tpu.introspect as ji
import gofr_tpu_torch
import gofr_tpu_torch.telemetry as tt
import gofr_tpu_torch.tpu.introspect as ti
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu.metrics import Registry as JaxRegistry
from gofr_tpu_torch.config import DECLARED_KEYS
from gofr_tpu_torch.metrics import Registry
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY

TIMES = ("start_ts", "queue_wait_s", "duration_s", "predicted_ms", "residual_ratio", "mfu",
         "mbu")


@pytest.fixture(autouse=True)
def _no_leaked_record():
    """Both packages' record and dispatch contextvars clear around each test."""
    for mod in (jt, tt):
        mod.activate_record(None)
    for mod in (ji, ti):
        mod.activate_dispatch(None)
    yield
    for mod in (jt, tt):
        mod.activate_record(None)
    for mod in (ji, ti):
        mod.activate_dispatch(None)


def _masked(record):
    return {k: ("time" if k in TIMES and v is not None else v) for k, v in record.items()}


# -- unit: the timeline and the state machine ------------------------------------------

def _timeline_ops(mod):
    timeline = mod.DispatchTimeline(capacity=3)
    recs = []
    for i, kind in enumerate(("prefill", "decode_chunk", "prefill", "prefill_chunk", "prefill")):
        recs.append(timeline.begin(kind, bucket=64 * (i + 1), batch_size=i + 1,
                                   padded_tokens=i, tokens=2 * i, detail=f"d{i}"))
    timeline.finish(recs[1])
    timeline.finish(recs[2], status="error")
    timeline.finish(recs[2])  # idempotent: the first finish wins
    timeline.finish(recs[4])
    return timeline


@pytest.mark.parametrize("query", [{}, {"kind": "prefill"}, {"limit": 1},
                                   {"kind": "decode_chunk", "limit": 5}])
def test_timeline_matches_jax(query):
    want, got = _timeline_ops(ji), _timeline_ops(ti)
    assert [_masked(r) for r in got.records(**query)] == \
        [_masked(r) for r in want.records(**query)]
    assert got.stats() == want.stats()
    assert got.stats()["in_flight"] == 2 and len(got.records()) == 3


def test_dispatch_record_queue_vs_running_split():
    for mod in (ji, ti):
        queued = time.perf_counter() - 0.05
        rec = mod.DispatchTimeline().begin("prefill", queued_at=queued)
        assert rec.queue_wait is None and rec.duration is None
        time.sleep(0.01)
        rec.mark_running()
        assert rec.queue_wait >= 0.05
        assert rec.to_dict()["status"] == "running"


def _engine_ops(mod):
    registry = (JaxRegistry if mod is ji else Registry)()
    engine = mod.EngineState(metrics=registry)
    for state in ("warming", "warming", "serving", "degraded", "wedged", "serving", "closed"):
        engine.transition(state, f"to {state}")
    return engine, registry


def test_state_machine_matches_jax():
    (want, jreg), (got, treg) = _engine_ops(ji), _engine_ops(ti)
    strip = [{k: v for k, v in h.items() if k != "ts"} for h in got.snapshot()["history"]]
    assert strip == [{k: v for k, v in h.items() if k != "ts"}
                     for h in want.snapshot()["history"]]
    assert got.state == want.state == "closed"
    assert ti.ENGINE_STATES == ji.ENGINE_STATES and ti.DISPATCH_KINDS == ji.DISPATCH_KINDS
    gauge = treg.gauge("gofr_tpu_engine_state", labels=("state",))
    assert [gauge.value(state=s) for s in ti.ENGINE_STATES] == \
        [jreg.gauge("gofr_tpu_engine_state", labels=("state",)).value(state=s)
         for s in ji.ENGINE_STATES]
    with pytest.raises(ValueError, match="unknown"):
        got.transition("confused")


@pytest.mark.parametrize("mod", [ji, ti], ids=["jax", "torch"])
def test_watchdog_flags_stall_wedges_and_recovers(mod):
    registry = (JaxRegistry if mod is ji else Registry)()
    engine = mod.EngineState(metrics=registry)
    engine.transition("serving")
    watchdog = mod.StallWatchdog(engine, metrics=registry, timeout_s=0.05, wedge_factor=3.0)

    def stalled():
        with watchdog.watch("prefill", 7):
            time.sleep(0.4)

    worker = threading.Thread(target=stalled)
    worker.start()
    worker.join()
    watchdog.close()
    states = [h["state"] for h in engine.snapshot()["history"]]
    assert states == ["booting", "serving", "degraded", "wedged", "serving"]
    assert watchdog.stall_counts == {"prefill": 1}
    counter = registry.counter("gofr_tpu_device_stalls_total", labels=("kind",))
    assert counter.value(kind="prefill") == 1
    assert "recovered" in engine.snapshot()["detail"]


def test_watchdog_off_and_fast_waits_never_flag():
    engine = ti.EngineState()
    engine.transition("serving")
    off = ti.StallWatchdog(engine, timeout_s=0.0)
    with off.watch("prefill", 1):
        time.sleep(0.02)
    assert not off.enabled and off.snapshot()["timeout_s"] is None
    armed = ti.StallWatchdog(engine)
    armed.arm(0.2)
    for _ in range(4):
        with armed.watch("decode_chunk", 1):
            time.sleep(0.005)
    time.sleep(0.06)
    armed.close()
    assert armed.stall_counts == {} and engine.state == "serving"
    with pytest.raises(ValueError):
        ti.StallWatchdog(engine, wedge_factor=0.5)


# -- over HTTP: JAX's echo app against the port's ----------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _boot(monkeypatch, tmp_path, settings, model=None):
    """A JAX app and a port app (OpenAI routes) under ``settings``;
    ``model(japp)`` builds the port's model from the JAX app's weights."""
    from gofr_tpu.openai import register_openai_routes as jax_routes

    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    for key, value in settings.items():
        monkeypatch.setenv(key, value)
    apps = []
    for label in ("jax", "torch"):
        monkeypatch.setenv("HTTP_PORT", str(_free_port()))
        if label == "jax":
            app = gofr_tpu.new()
            jax_routes(app)
        else:
            monkeypatch.setenv("TORCH_DEVICE", "cpu")
            app = gofr_tpu_torch.new(model=model(apps[0]) if model else None)
            gofr_tpu_torch.register_openai_routes(app)
        app.start()
        apps.append(app)
    return apps


def _call(app, path, body=None):
    url = f"http://127.0.0.1:{app.http_port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _body(raw):
    """A completion's body, or a stream's data frames, without the random
    id, the clock and the JAX package's SSE frame numbers."""
    frames = [line[6:] for line in raw.split("\n") if line.startswith("data: ")] or [raw]
    out = []
    for frame in frames:
        if frame == "[DONE]":
            out.append(frame)
            continue
        obj = json.loads(frame)
        obj.pop("id", None)
        obj.pop("created", None)
        out.append(obj)
    return out


def _admin(app, path):
    status, raw = _call(app, path)
    assert status == 200, (path, raw)
    return json.loads(raw)["data"]


ECHO = {"MODEL_NAME": "echo", "TOKENIZER": "byte", "BATCH_MAX_SIZE": "4",
        "BATCH_TIMEOUT_MS": "1", "LOG_LEVEL": "FATAL", "OPENAI_FANOUT_WORKERS": "1",
        "FLIGHT_SLOW_MS": "60000", "WATCHDOG_DISPATCH_TIMEOUT_S": "0.15"}
ECHO_TRAFFIC = [
    {"prompt": "warm the echo", "max_tokens": 4},
    {"prompt": "x" * 100, "max_tokens": 3},  # bucket 128
    {"prompt": "n of two", "max_tokens": 3, "n": 2},
    {"prompt": "y" * 300, "max_tokens": 2, "stream": True},  # bucket 512
]
SHAPE = ("kind", "status", "bucket", "batch_size", "padded_tokens", "tokens", "detail")


@pytest.fixture
def echo_apps(monkeypatch, tmp_path):
    apps = _boot(monkeypatch, tmp_path, ECHO)
    yield apps
    for app in reversed(apps):
        app.shutdown()


def test_dispatches_match_jax_and_ids_resolve(echo_apps):
    japp, tapp = echo_apps
    for body in ECHO_TRAFFIC:
        assert _call(tapp, "/v1/completions", body)[0] == \
            _call(japp, "/v1/completions", body)[0] == 200
    shape = {}
    for label, app in (("jax", japp), ("torch", tapp)):
        recs = _admin(app, "/admin/dispatches?kind=prefill")["dispatches"]
        shape[label] = [tuple(r[k] for k in SHAPE) for r in recs]
    assert shape["torch"] == shape["jax"]
    assert [s[2] for s in shape["torch"]] == [512, 64, 64, 128, 64]
    # every dispatch id a flight record names resolves to its record
    records = _admin(tapp, "/admin/requests")["requests"]
    dispatches = {r["dispatch_id"]: r for r in _admin(tapp, "/admin/dispatches?limit=500")
                  ["dispatches"]}
    assert len(records) == len(ECHO_TRAFFIC)
    for rec in records:
        assert rec["dispatch_ids"]
        for did in rec["dispatch_ids"]:
            assert dispatches[did]["kind"] == "prefill" and dispatches[did]["status"] == "ok"
    assert _admin(tapp, "/admin/dispatches?kind=device_probe")["dispatches"][0]["detail"] == \
        "none (echo)"
    assert _call(tapp, "/admin/dispatches?kind=warp")[0] == 400
    assert _admin(tapp, "/admin/dispatches?limit=1")["count"] == 1
    snap = _admin(tapp, "/admin/engine")
    jsnap = _admin(japp, "/admin/engine")
    assert snap["engine"]["state"] == jsnap["engine"]["state"] == "serving"
    assert snap["dispatches"] == jsnap["dispatches"]
    assert snap["watchdog"]["timeout_s"] == jsnap["watchdog"]["timeout_s"] == 0.15
    assert snap["queue_depth"] == jsnap["queue_depth"] == 0
    assert snap["scheduler"]["policy"] == "fair"
    assert snap["tenants"] == jsnap["tenants"]
    assert snap["watchdog"]["on_stall"].startswith("recover:")  # RECOVERY_ENABLED on
    assert snap["recovery"].keys() == jsnap["recovery"].keys()
    assert snap["recovery"]["state"] == jsnap["recovery"]["state"] == "idle"
    assert snap["brownout"] == jsnap["brownout"]
    assert snap["journal"].keys() == jsnap["journal"].keys()
    assert _call(tapp, "/admin/engine")[0] == 200


def _stall_walk(app, stall):
    """Drive one completion through a stalled echo prefill; returns (the
    engine's states after it, the readiness 503 bodies seen meanwhile)."""
    tpu = app.container.tpu
    if hasattr(tpu, "recovery"):
        tpu.recovery.enabled = False  # the watchdog's own walk, as JAX's test pins it
    before = len(tpu.engine.snapshot()["history"])
    tpu.runner.stall_hook = lambda: time.sleep(stall)
    bodies = []
    try:
        worker = threading.Thread(target=_call, args=(app, "/v1/completions",
                                                      {"prompt": "stall", "max_tokens": 1}))
        worker.start()
        while worker.is_alive():
            status, raw = _call(app, "/.well-known/ready")
            if status == 503:
                bodies.append(json.loads(raw))
            time.sleep(0.02)
        worker.join()
    finally:
        tpu.runner.stall_hook = None
    deadline = time.time() + 2.0
    while tpu.engine.state != "serving" and time.time() < deadline:
        time.sleep(0.02)
    return [h["state"] for h in tpu.engine.snapshot()["history"][before:]], bodies


def test_injected_stall_walks_both_engines_alike(echo_apps):
    japp, tapp = echo_apps
    want, _ = _stall_walk(japp, 0.7)
    got, bodies = _stall_walk(tapp, 0.7)
    assert got == want == ["degraded", "wedged", "serving"]
    assert bodies and {b["state"] for b in bodies} <= {"degraded", "wedged"}
    assert any("stalled" in (b.get("detail") or "") for b in bodies)
    assert bodies[-1]["watchdog"]["timeout_s"] == 0.15
    assert _call(tapp, "/.well-known/ready")[0] == 200
    stalls = _admin(tapp, "/admin/engine")["watchdog"]["stalls"]
    assert stalls == _admin(japp, "/admin/engine")["watchdog"]["stalls"] == {"prefill": 1}
    metrics = _call(tapp, "/metrics")[1]
    assert 'gofr_tpu_device_stalls_total{kind="prefill"} 1' in metrics
    assert 'gofr_tpu_engine_state{state="serving"} 1' in metrics


# -- the tiny model on the CPU ---------------------------------------------------------------

TINY_SETTINGS = {"MODEL_NAME": "tiny", "TOKENIZER": "byte", "BATCH_MAX_SIZE": "4",
                 "BATCH_TIMEOUT_MS": "2", "DECODE_CHUNK": "4", "LOG_LEVEL": "FATAL",
                 "PREFIX_CACHE": "2", "OPENAI_FANOUT_WORKERS": "1"}
TINY_TRAFFIC = [
    {"prompt": "the tiny model", "max_tokens": 9, "temperature": 0},
    {"prompt": "the tiny model", "max_tokens": 9, "temperature": 0},  # exact hit
    {"prompt": "the tiny model, longer", "max_tokens": 5, "temperature": 0},  # partial hit
    {"prompt": [1, 2, 3, 40, 50], "max_tokens": 6, "temperature": 0, "stream": True},
]


def _series(text, family):
    """{labels} of the samples of ``family`` (its _bucket/_sum/_count too)."""
    out = set()
    for line in text.splitlines():
        if line.startswith(family) and not line.startswith("#"):
            name, _, rest = line.partition("{")
            labels = tuple(sorted(p.split("=")[0] for p in rest.split("}")[0].split(",")
                                  if p and p.split("=")[0] != "le"))
            out.add((name, labels))
    return out


def test_tiny_mfu_compile_and_cache_series_and_record_counts(monkeypatch, tmp_path):
    def carried(japp):
        params = jax.tree.map(np.asarray, japp.container.tpu.runner.params)
        return transformer_from_tree(params, TINY, device="cpu")

    japp, tapp = _boot(monkeypatch, tmp_path, TINY_SETTINGS, model=carried)
    try:
        for body in TINY_TRAFFIC:
            got, want = _call(tapp, "/v1/completions", body), _call(japp, "/v1/completions", body)
            assert got[0] == want[0] == 200 and _body(got[1]) == _body(want[1])
        jtext, ttext = _call(japp, "/metrics")[1], _call(tapp, "/metrics")[1]
        for family in ("gofr_tpu_mfu", "gofr_tpu_compile_seconds", "gofr_tpu_compiles_total",
                       "gofr_tpu_cache_events_total"):
            assert _series(ttext, family), family
            assert _series(ttext, family) <= _series(jtext, family) | _series(ttext, family)
            names = {labels for _, labels in _series(ttext, family)}
            assert names == {labels for _, labels in _series(jtext, family)}, family
        assert 'gofr_tpu_mfu{model="tiny",op="prefill"}' in ttext
        assert 'gofr_tpu_mfu{model="tiny",op="decode"}' in ttext
        # the prefix cache's lookups, counted alike (the port has no
        # executable cache: cache="prefix" is its only one)
        prefix = [line for line in ttext.splitlines()
                  if line.startswith('gofr_tpu_cache_events_total{cache="prefix"')]
        assert prefix == [line for line in jtext.splitlines()
                          if line.startswith('gofr_tpu_cache_events_total{cache="prefix"')]
        assert any('event="hit"' in line for line in prefix)
        assert any('event="miss"' in line for line in prefix)
        assert 'cache="executable"' not in ttext
        assert 'gofr_tpu_compiles_total{kind="prefill"}' in ttext
        assert 'gofr_tpu_mbu{model="tiny",op="decode"}' in ttext
        want = _admin(japp, "/admin/requests")["requests"]
        got = _admin(tapp, "/admin/requests")["requests"]
        assert len(got) == len(want) == len(TINY_TRAFFIC)
        assert [r["tokens_out"] for r in got] == [r["tokens_out"] for r in want]
        # each request's prefill dispatches by kind, and decode chunks on
        # every request (how many chunks a pooled request rides depends on
        # the pipeline's timing: the count of those is not compared)
        rode = {}
        for label, app, recs in (("jax", japp, want), ("torch", tapp, got)):
            kinds = {r["dispatch_id"]: r["kind"]
                     for r in _admin(app, "/admin/dispatches?limit=500")["dispatches"]}
            rode[label] = [sorted(kinds[d] for d in r["dispatch_ids"] if kinds[d] != "decode_chunk")
                           for r in recs]
            assert all("decode_chunk" in {kinds[d] for d in r["dispatch_ids"]} for r in recs)
        assert rode["torch"] == rode["jax"]
        assert _admin(tapp, "/admin/dispatches?kind=prefill")["count"] == \
            _admin(japp, "/admin/dispatches?kind=prefill")["count"]
        decode = _admin(tapp, "/admin/dispatches?kind=decode_chunk")["dispatches"]
        assert decode and all(r["mbu"] is not None and r["status"] == "ok" for r in decode)
        stages = _admin(tapp, "/admin/engine")["boot_timeline"]
        assert [s["kind"] for s in stages if s["kind"]][:1] == ["prefill"]
        assert any(s["kind"] == "decode_pool" for s in stages)
    finally:
        tapp.shutdown()
        japp.shutdown()
