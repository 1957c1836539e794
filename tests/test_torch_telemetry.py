"""gofr_tpu_torch's flight recorder and tenant ledger (``telemetry.py``)
against gofr_tpu's (``tests/test_telemetry.py``).

- The recorder's ring, side buffer, filters and SLO percentiles, and the
  tenant ledger's space-saving table, driven by the same operations in
  both packages: equal records (times masked), equal SLO and ledger bodies.
- ``sanitize_request_id``, ``parse_hop`` and ``origin_from_headers`` on the
  same inputs.
- Over HTTP, a JAX echo app and the port's echo app (byte tokenizer, pooled
  speculation, paged KV) take the same requests (completions, chat,
  streamed, n = 2, a router-stamped origin, two tenants): ``/admin/requests``
  field for field with the times masked, ``/admin/slo`` and
  ``/admin/tenants`` equal, ``priority`` (``PRIORITY_DEFAULT``, 5)
  included.

Every test resets both packages' record contextvars (a record a test
activates in this thread must not leak into the next one).
"""

import json
import socket
import urllib.error
import urllib.request

import pytest

import gofr_tpu
import gofr_tpu.telemetry as jt
import gofr_tpu_torch
import gofr_tpu_torch.telemetry as tt
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu_torch.config import DECLARED_KEYS

# fields that hold a time (or the request's random trace id)
TIMES = ("trace_id", "start_ts", "enqueue_ts", "dispatch_ts", "first_token_ts", "done_ts",
         "queue_wait_s", "ttft_s", "tpot_s", "duration_s", "sched_defer_s")


@pytest.fixture(autouse=True)
def _no_leaked_record():
    """Both packages' record contextvars clear before and after each test."""
    jt.activate_record(None)
    tt.activate_record(None)
    yield
    jt.activate_record(None)
    tt.activate_record(None)


def _masked(record):
    return {k: ("time" if k in TIMES and v is not None else v) for k, v in record.items()}


# -- the recorder and the ledger, unit by unit ----------------------------------------

def _drive(mod, script):
    """Run the same recorder operations in ``mod`` (jt or tt)."""
    recorder = mod.FlightRecorder(capacity=3, keep=2, slow_threshold_s=0.5,
                                  tenants=mod.TenantLedger(size=2))
    for model, tenant, ttft, tpot, status, tokens in script:
        mod.activate_tenant(tenant)
        rec = recorder.start(model=model, endpoint="/t", tokens_in=4, activate=False)
        mod.activate_tenant(None)
        rec.mark_enqueue()
        rec.mark_dispatch(2)
        rec.note_prefill_chunk(bucket=64)
        rec.note_dispatch_id(len(recorder.records(limit=100)) + 1)
        rec.note_kv(3, 1)
        if ttft is not None:
            rec.t_first_token = rec.t_start + ttft
        if tpot is not None:
            rec.t_last_token = rec.t_first_token + tpot * (tokens - 1)
        rec.tokens_out = tokens
        recorder.finish(rec, error=RuntimeError("boom") if status == "error" else None)
    return recorder


SCRIPTS = {
    "ring": [("m0", "a", 0.01, 0.002, "ok", 5), ("m1", "b", 0.02, 0.003, "ok", 3),
             ("m0", "a", 0.03, None, "ok", 1), ("m1", "c", 0.9, 0.01, "ok", 4),
             ("m0", "d", 0.04, 0.004, "error", 2)],
    "slow_and_errors": [("m", "a", 0.9, 0.1, "ok", 6), ("m", "a", 0.1, 0.01, "error", 2),
                        ("m", "b", 0.2, 0.02, "ok", 3), ("m", "b", 0.3, 0.03, "ok", 3),
                        ("m", "b", 0.4, 0.04, "ok", 3), ("m", "e", 0.5, 0.05, "ok", 3)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("query", [{}, {"slow": True}, {"slow": False}, {"errored": True},
                                   {"tenant": "b"}, {"limit": 1}])
def test_records_match_jax(script, query):
    want = [_masked(r) for r in _drive(jt, SCRIPTS[script]).records(**query)]
    got = [_masked(r) for r in _drive(tt, SCRIPTS[script]).records(**query)]
    assert got == want


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_slo_and_tenants_match_jax(script):
    want, got = _drive(jt, SCRIPTS[script]), _drive(tt, SCRIPTS[script])
    assert got.slo(window_s=60.0) == want.slo(window_s=60.0)
    assert got.tenants.snapshot() == want.tenants.snapshot()
    assert got.tenants.overview() == want.tenants.overview()
    assert got.tenants.get("a") == want.tenants.get("a")


def test_ledger_eviction_matches_jax():
    """Space-saving eviction into ~other: the same table, the same
    undercount bounds and totals that conserve every request."""
    ledgers = []
    for mod in (jt, tt):
        ledger = mod.TenantLedger(size=2)
        for tenant, n in (("a", 5), ("b", 1), ("c", 1), ("a", 2), ("d", 3), ("", 9)):
            ledger.observe(tenant, requests=n, tokens_in=10 * n, tokens_out=n, errors=n % 2)
        ledger.observe("e", sheds=1)
        ledgers.append(ledger)
    want, got = ledgers
    assert got.snapshot() == want.snapshot()
    assert got.totals()["requests"] == 12 and got.stats()["evictions"] == 3
    with pytest.raises(ValueError):
        tt.TenantLedger(size=0)


def test_flight_guard_drops_a_rejection_and_defers_a_stream():
    """The ``Flight`` guard: a 4xx before inference leaves no record, an
    error finishes it errored, a Stream finishes when it ends."""
    from gofr_tpu_torch.errors import HTTPError
    from gofr_tpu_torch.http.response import Stream

    recorder = tt.FlightRecorder()
    with pytest.raises(HTTPError):
        with tt.flight(recorder, model="m", endpoint="/t"):
            raise HTTPError(400, "bad")
    assert recorder.records() == []
    with pytest.raises(RuntimeError):
        with tt.flight(recorder, model="m", endpoint="/t"):
            raise RuntimeError("device")
    assert recorder.records()[0]["status"] == "error"
    with tt.flight(recorder, model="m", endpoint="/s", stream=True) as fl:
        stream = fl.defer(Stream(iter(["a", "b"])))
    assert len(recorder.records()) == 1  # not finished until consumed
    assert list(stream.events) == ["a", "b"]
    assert recorder.records()[0]["endpoint"] == "/s"
    assert tt.flight(None, model="m", endpoint="/t").defer("x") == "x"


REQUEST_IDS = ["abc", "a" * 64, "a" * 65, "", None, 7, "bad id", "ok._-1", " padded ", "ü"]
HOPS = ["router=r1;attempt=2;resume=3", "router=r1;attempt=0", "attempt=1", "router=r1",
        "router=r 1;attempt=1", "router=r1;attempt=-1", "router=r1;attempt=x", None, "",
        "x" * 300, "router=r1;attempt=1;resume=4;extra=5"]


@pytest.mark.parametrize("raw", REQUEST_IDS)
def test_sanitize_request_id_matches_jax(raw):
    assert tt.sanitize_request_id(raw) == jt.sanitize_request_id(raw)


@pytest.mark.parametrize("raw", HOPS)
def test_parse_hop_matches_jax(raw):
    assert tt.parse_hop(raw) == jt.parse_hop(raw)
    assert tt.origin_from_headers("req-1", raw) == jt.origin_from_headers("req-1", raw)
    assert tt.origin_from_headers(None, raw) == jt.origin_from_headers(None, raw)


def test_a_router_hop_round_trips():
    hop = jt.format_hop("r9", 2, 5)  # the JAX router's stamp
    assert tt.parse_hop(hop) == jt.parse_hop(hop) == {"router": "r9", "attempt": 2,
                                                      "resume_from": 5}


def test_exemplar_provider_reads_the_record_and_the_dispatch():
    from gofr_tpu_torch.tpu.introspect import DispatchTimeline, activate_dispatch

    assert tt.exemplar_provider() is None
    rec = tt.FlightRecorder().start(model="m", endpoint="/t", trace_id="t" * 32)
    drec = DispatchTimeline().begin("prefill")
    activate_dispatch(drec)
    try:
        assert tt.exemplar_provider() == {"trace_id": "t" * 32,
                                          "dispatch_id": str(drec.dispatch_id)}
    finally:
        activate_dispatch(None)
    assert tt.current_record() is rec


# -- over HTTP: the JAX echo app against the port's --------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SETTINGS = {"MODEL_NAME": "echo", "TOKENIZER": "byte", "BATCH_MAX_SIZE": "4",
            "BATCH_TIMEOUT_MS": "1", "LOG_LEVEL": "FATAL", "SPEC_POOLED": "on",
            "SPEC_FAKE_ACCEPT": "2,0,1", "KV_BLOCK_TOKENS": "8", "OPENAI_FANOUT_WORKERS": "1",
            "FLIGHT_SLOW_MS": "60000"}


@pytest.fixture
def apps(monkeypatch, tmp_path):
    """A JAX echo app and a port echo app under the same settings."""
    from gofr_tpu.openai import register_openai_routes as jax_routes

    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    for key, value in SETTINGS.items():
        monkeypatch.setenv(key, value)
    out = []
    for label in ("jax", "torch"):
        monkeypatch.setenv("HTTP_PORT", str(_free_port()))
        if label == "jax":
            app = gofr_tpu.new()
            jax_routes(app)
        else:
            app = gofr_tpu_torch.new()
            gofr_tpu_torch.register_openai_routes(app)
        app.start()
        out.append(app)
    yield out
    for app in reversed(out):
        app.shutdown()


def _call(app, path, body=None, headers=None):
    url = f"http://127.0.0.1:{app.http_port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json",
                                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()
    return status, raw


def _admin(app, path):
    status, raw = _call(app, path)
    assert status == 200, (path, raw)
    return json.loads(raw)["data"]


TRAFFIC = [
    ("/v1/completions", {"prompt": "hello echo", "max_tokens": 12}, {}),
    ("/v1/completions", {"prompt": "hello echo", "max_tokens": 12, "stream": True},
     {"Authorization": "Bearer tenant-one"}),
    ("/v1/completions", {"prompt": "hello echo, again", "max_tokens": 5, "n": 2},
     {"X-Gofr-Request-Id": "route-7", "X-Gofr-Hop": "router=r1;attempt=1;resume=0"}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                              "max_tokens": 9}, {"Authorization": "Bearer tenant-two"}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                              "max_tokens": 9, "stream": True}, {}),
    ("/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 4, "logprobs": 2},
     {"X-Gofr-Request-Id": "bad id!"}),
    ("/v1/completions", {"prompt": "", "max_tokens": 3}, {}),  # 400: no record
]


def test_admin_requests_slo_and_tenants_match_jax(apps):
    japp, tapp = apps
    for path, body, headers in TRAFFIC:
        want, got = _call(japp, path, body, headers), _call(tapp, path, body, headers)
        assert got[0] == want[0], (path, body, got, want)
    want = _admin(japp, "/admin/requests")
    got = _admin(tapp, "/admin/requests")
    assert got["count"] == want["count"] == len(TRAFFIC) - 1
    for w, g in zip(want["requests"], got["requests"]):
        assert g["priority"] == w["priority"] == 5  # PRIORITY_DEFAULT in both
        assert _masked(g) == _masked(w)
    # the filters resolve the same records
    for query in ("?request_id=route-7", "?tenant=anonymous", "?errored=true", "?limit=2",
                  "?slow=false"):
        w = _admin(japp, "/admin/requests" + query)["requests"]
        g = _admin(tapp, "/admin/requests" + query)["requests"]
        assert [r["endpoint"] for r in g] == [r["endpoint"] for r in w], query
        assert [r["tokens_out"] for r in g] == [r["tokens_out"] for r in w], query
    mine = _admin(tapp, "/admin/requests?request_id=route-7")["requests"]
    assert mine[0]["origin"] == {"router": "r1", "attempt": 1, "resume_from": 0}
    assert mine[0]["tokens_out"] == 10  # two candidates of 5 on one record
    # /admin/slo: the same models and counts; the percentiles are times
    want, got = _admin(japp, "/admin/slo"), _admin(tapp, "/admin/slo")
    assert got["window_s"] == want["window_s"]
    assert {m: {k: (v if k in ("count", "errors", "chunked_prefills") else sorted(v))
                for k, v in e.items()} for m, e in got["models"].items()} == \
        {m: {k: (v if k in ("count", "errors", "chunked_prefills") else sorted(v))
             for k, v in e.items()} for m, e in want["models"].items()}
    assert _admin(tapp, "/admin/tenants") == _admin(japp, "/admin/tenants")
    tenant = _admin(tapp, "/admin/tenants")["tenants"][0]["tenant"]
    assert _admin(tapp, f"/admin/tenants?tenant={tenant}") == \
        _admin(japp, f"/admin/tenants?tenant={tenant}")
    assert _call(tapp, "/admin/tenants?tenant=nobody")[0] == \
        _call(japp, "/admin/tenants?tenant=nobody")[0] == 404
    assert _call(tapp, "/admin/requests?limit=0")[0] == 400
    assert _call(tapp, "/admin/slo?window=-1")[0] == 400


def test_admin_routes_need_the_token(apps, monkeypatch):
    _, tapp = apps
    monkeypatch.setenv("ADMIN_TOKEN", "s3cret")
    for path in ("/admin/requests", "/admin/slo", "/admin/tenants"):
        assert _call(tapp, path)[0] == 401
        assert _call(tapp, path, headers={"Authorization": "Bearer s3cret"})[0] == 200
