"""The port's fleet trace (``fleet/trace.py``, the hop headers, route and
flight records, ``devtools/trace_capture.py``) held to the JAX package's
``tests/test_fleet_trace.py`` case for case. The JAX file's own
description follows.

Fleet-wide request tracing, tier-1: the hop-correlation layer
(request-id mint/honor/echo, ``X-Gofr-Hop`` provenance), the
``/admin/fleet/trace/<id>`` causal-timeline assembly, and trace
capture→replay determinism.

Unit tier: header sanitization/parsing never crashes on garbage, the
pure ``assemble`` join decomposes latency correctly and degrades to
partial-with-evidence, capture anonymization is seeded-deterministic.

Chaos e2e tier (same in-process echo fleets as test_fleet.py): ids
echo on success AND shed responses, client hop spoofing is overridden
at the router boundary, and THE acceptance spine — a streamed request
that rides a cross-replica KV transfer and survives a forced mid-
stream wedge + resume assembles into ONE timeline via
``GET /admin/fleet/trace/<id>``, span-continuous across the resume.
"""

import json
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from gofr_tpu_torch.fleet import trace as fleet_trace
from gofr_tpu_torch.telemetry import (
    format_hop,
    origin_from_headers,
    parse_hop,
    sanitize_request_id,
)


@pytest.fixture(autouse=True)
def _no_leaked_contextvars():
    """Clear both packages' request contextvars around each test: the
    flight record, the journal entry, the deadline, the priority, the fleet
    origin and the KV-donor hint (a leaked one fails another file's test)."""
    import gofr_tpu.deadline as jd
    import gofr_tpu.fleet.kvwire as jk
    import gofr_tpu.telemetry as jt
    import gofr_tpu_torch.deadline as td
    import gofr_tpu_torch.fleet.kvwire as tk
    import gofr_tpu_torch.telemetry as tt

    def clear():
        for mod in (jt, tt):
            mod.activate_journal_entry(None)
            mod.activate_record(None)
            mod.activate_origin(None)
        for mod in (jd, td):
            mod.activate_deadline(None)
            mod.activate_priority(None)
        for mod in (jk, tk):
            mod.activate_kv_hint(None)

    clear()
    yield
    clear()


# -- helpers -------------------------------------------------------------------

def _get(url, headers=None, timeout=10):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), dict(r.headers.items())


def _post(url, payload, headers=None, timeout=10):
    send = {"Content-Type": "application/json"}
    send.update(headers or {})
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers=send, method="POST"
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), dict(r.headers.items())


def _wait(cond, timeout=10.0, interval=0.02, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


def _read_sse_tokens(resp, initial: bytes = b"") -> tuple:
    """Drain one SSE response: returns (token_ids, raw)."""
    raw = initial
    while True:
        chunk = resp.read(4096)
        if not chunk:
            break
        raw += chunk
    tokens: list = []
    for block in raw.split(b"\n\n"):
        for line in block.split(b"\n"):
            if line.startswith(b"data:"):
                data = line[5:].strip()
                if data == b"[DONE]" or not data.startswith(b"{"):
                    continue
                frame = json.loads(data)
                if "error" in frame:
                    raise AssertionError(f"error frame reached client: {frame}")
                choice = frame["choices"][0]
                if choice.get("tokens"):
                    tokens.extend(choice["tokens"])
    return tokens, raw


# -- unit: header sanitization + hop parsing -----------------------------------

def test_sanitize_request_id_contract():
    assert sanitize_request_id("req-a1B2.x_y-9") == "req-a1B2.x_y-9"
    assert sanitize_request_id("a" * 64) == "a" * 64
    assert sanitize_request_id("a" * 65) is None  # too long
    assert sanitize_request_id("has space") is None
    assert sanitize_request_id("semi;colon") is None
    assert sanitize_request_id("") is None
    assert sanitize_request_id(None) is None
    # header injection attempts die at the charset, not downstream
    assert sanitize_request_id("evil\r\nX-Admin: yes") is None


def test_hop_round_trip_and_garbage_never_raises():
    hop = format_hop("router-0", 2, 7)
    assert hop == "router=router-0;attempt=2;resume=7"
    parsed = parse_hop(hop)
    assert parsed == {"router": "router-0", "attempt": 2, "resume_from": 7}
    for garbage in (
        None, "", ";;;", "router=", "router=a;attempt=x", "attempt=1",
        "router=ok;attempt=-1;resume=0", "router=sp ace;attempt=1;resume=0",
        "=" * 500, "a" * 300,
    ):
        assert parse_hop(garbage) is None, garbage
    # unknown extra fields are tolerated (forward-compat), known ones win
    assert parse_hop("router=a;attempt=1;resume=1;extra=junk") == {
        "router": "a", "attempt": 1, "resume_from": 1,
    }
    rng = random.Random(20260807)
    alphabet = "ra=;0123456789\x00\r\n %züter"
    for _ in range(500):
        fuzz = "".join(
            rng.choice(alphabet) for _ in range(rng.randint(0, 80))
        )
        parse_hop(fuzz)  # must never raise, whatever it returns
        origin_from_headers(fuzz, fuzz)  # nor the combined parser


# -- unit: timeline assembly ---------------------------------------------------

def _route(**over):
    base = {
        "ts": 100.0, "request_id": "req-abc", "router_id": "router-0",
        "method": "POST", "path": "/v1/completions", "tenant": "t0",
        "stream": True, "resumable": True, "resumes": 0, "role": "decode",
        "kv_donor": "r0", "status": 200, "outcome": "ok", "retries": 1,
        "elapsed_ms": 200.0,
        "attempts": [
            {"replica": "r1", "status": 503, "error": "saturated",
             "elapsed_ms": 10.0},
            {"replica": "r2", "status": 200, "error": None,
             "elapsed_ms": 150.0},
        ],
    }
    base.update(over)
    return base


def test_assemble_joins_flights_and_decomposes_latency():
    flights = {
        "r2": [{
            "request_id": "req-abc",
            "origin": {"router": "router-0", "attempt": 1, "resume_from": 0},
            "queue_wait_s": 0.010, "ttft_s": 0.050, "status": 200,
        }],
    }
    transfers = [{"replica": "r2", "side": "receiver", "outcome": "ok",
                  "request_id": "req-abc"}]
    out = fleet_trace.assemble("req-abc", _route(), flights, transfers)
    assert out["request_id"] == "req-abc"
    assert out["partial"] is False and out["evidence_gaps"] == []
    assert out["router"]["elapsed_ms"] == 200.0
    assert out["router"]["kv_donor"] == "r0"
    assert [a["replica"] for a in out["attempts"]] == ["r1", "r2"]
    assert out["attempts"][0]["flight"] is None  # failed hop: no record
    assert out["attempts"][1]["flight"]["status"] == 200
    assert out["transfers"] == transfers
    lat = out["latency"]
    assert lat["total_ms"] == 200.0
    # 200 total - (10 + 150) upstream = 40ms router overhead
    assert lat["router_overhead_ms"] == 40.0
    assert lat["replica_queue_ms"] == 10.0
    assert lat["device_ttft_ms"] == 40.0  # ttft net of queue wait
    # remainder: 200 - 40 - 10 - 40
    assert lat["stream_ms"] == 110.0


def test_assemble_is_partial_with_evidence_when_flights_missing():
    out = fleet_trace.assemble(
        "req-abc", _route(), flights={}, transfers=[],
        evidence_gaps=["r2: flight scrape failed (connection refused)"],
    )
    assert out["partial"] is True
    # the served attempt with no flight record is ITSELF named as a gap
    assert any("attempt 1" in g for g in out["evidence_gaps"])
    assert any("connection refused" in g for g in out["evidence_gaps"])
    lat = out["latency"]
    assert lat["router_overhead_ms"] == 40.0  # route-record-only math
    assert lat["replica_queue_ms"] is None  # no flight: no invention
    assert lat["device_ttft_ms"] is None and lat["stream_ms"] is None


def test_assemble_matches_flight_by_attempt_index_not_order():
    # two flights from the SAME replica (original + a retry that landed
    # back on it): the origin attempt index disambiguates
    flights = {"r2": [
        {"origin": {"router": "router-0", "attempt": 5, "resume_from": 0},
         "status": 200, "marker": "wrong"},
        {"origin": {"router": "router-0", "attempt": 1, "resume_from": 0},
         "status": 200, "marker": "right"},
        {"origin": {"router": "OTHER", "attempt": 1, "resume_from": 0},
         "status": 200, "marker": "foreign"},
    ]}
    out = fleet_trace.assemble("req-abc", _route(), flights, [])
    assert out["attempts"][1]["flight"]["marker"] == "right"


def test_assemble_fuzzed_inputs_never_crash():
    rng = random.Random(7)

    def junk(depth=0):
        pick = rng.randint(0, 5 if depth < 2 else 3)
        if pick == 0:
            return rng.randint(-10, 10)
        if pick == 1:
            return rng.random() * 1e3
        if pick == 2:
            return "".join(chr(rng.randint(32, 126)) for _ in range(8))
        if pick == 3:
            return None
        if pick == 4:
            return [junk(depth + 1) for _ in range(rng.randint(0, 3))]
        return {
            rng.choice(["attempts", "elapsed_ms", "status", "replica",
                        "origin", "ts", "x"]): junk(depth + 1)
            for _ in range(rng.randint(0, 4))
        }

    for _ in range(300):
        route = junk()
        if not isinstance(route, dict):
            route = {"attempts": route}
        flights = {"r1": junk() if rng.random() < 0.5 else [junk()]}
        if not isinstance(flights["r1"], list):
            flights["r1"] = [flights["r1"]]
        out = fleet_trace.assemble("req-fuzz", route, flights, [])
        assert out["request_id"] == "req-fuzz"
        assert isinstance(out["partial"], bool)


# -- unit: zipkin exporter drop counter ----------------------------------------

def test_zipkin_exporter_counts_dropped_batches():
    from gofr_tpu_torch.metrics import Registry
    from gofr_tpu_torch.tracing import Span, Tracer, ZipkinExporter

    exporter = ZipkinExporter("http://127.0.0.1:1/api/v2/spans")
    registry = Registry()
    exporter.attach_metrics(registry)
    try:
        span = Span("t", "ab" * 16, "cd" * 8, None, None, Tracer(exporter))
        span.end_us = span.start_us + 5
        exporter._post([span])  # collector port 1: refused, counted
        assert exporter.post_failures == 1
        counted = sum(
            registry.counter(
                "gofr_tpu_trace_export_failures_total"
            ).data().values()
        )
        assert counted == 1
    finally:
        exporter.shutdown()


# -- unit: capture determinism + anonymization ---------------------------------

def _capture_fixtures():
    routes = [
        {"ts": 50.0, "request_id": "req-b", "tenant": "acme",
         "affinity_key": "aff1234567", "stream": True, "outcome": "ok",
         "status": 200, "attempts": [{"replica": "r0", "status": 200}]},
        {"ts": 49.0, "request_id": "req-a", "tenant": "globex",
         "affinity_key": None, "stream": False, "outcome": "ok",
         "status": 200, "attempts": [{"replica": "r0", "status": 200}]},
        {"ts": 51.0, "request_id": "req-c", "tenant": "acme",
         "outcome": "shed:quota", "status": 429, "attempts": []},
    ]
    flights = [
        {"request_id": "req-a", "tokens_in": 12, "tokens_out": 4,
         "priority": 7},
        {"request_id": "req-b", "tokens_in": 33, "tokens_out": 9,
         "priority": 5},
    ]
    return routes, flights


def test_capture_events_are_deterministic_and_anonymized():
    from gofr_tpu_torch.devtools.trace_capture import build_events, capture_artifact

    routes, flights = _capture_fixtures()
    events, dropped = build_events(routes, flights, seed=99)
    events2, _ = build_events(list(routes), list(flights), seed=99)
    assert events == events2  # seeded: byte-identical
    assert dropped["shed"] == 1  # the 429 had no prompt evidence
    assert len(events) == 2
    # sorted by timestamp: req-a (ts 49) first, offsets rebased to 0
    assert events[0]["at_s"] == 0.0 and events[1]["at_s"] == 1.0
    # anonymization: raw tenant names never appear, hashes are stable
    blob = json.dumps(events)
    assert "acme" not in blob and "globex" not in blob
    assert events[0]["tenant"] != events[1]["tenant"]
    # prompt SHAPES survive (length = tokens_in), content is synthetic
    assert len(events[0]["prompt"]) == 12
    assert len(events[1]["prompt"]) == 33
    assert all(1 <= t <= 997 for t in events[1]["prompt"])
    # stream/unary mix survives; fleetsim schema keys all present
    assert events[1]["kind"] == "stream" and events[0]["kind"] == "unary"
    for ev in events:
        assert set(ev) == {"at_s", "phase", "tenant", "session", "priority",
                           "kind", "abort_after", "prompt", "max_tokens",
                           "seed", "i"}
    # a different seed unlinks tenants AND prompts
    events3, _ = build_events(routes, flights, seed=100)
    assert events3[0]["tenant"] != events[0]["tenant"]
    assert events3[0]["prompt"] != events[0]["prompt"]
    artifact = capture_artifact(routes, flights, seed=99)
    assert artifact["digest"] == capture_artifact(routes, flights, 99)["digest"]
    assert artifact["requests"] == 2 and artifact["dropped"]["shed"] == 1


def test_load_capture_rejects_tampered_files(tmp_path):
    from gofr_tpu_torch.devtools.trace_capture import capture_artifact, load_capture

    routes, flights = _capture_fixtures()
    artifact = capture_artifact(routes, flights, seed=5)
    path = tmp_path / "cap.json"
    path.write_text(json.dumps(artifact))
    loaded = load_capture(str(path))
    assert loaded["digest"] == artifact["digest"]
    artifact["events"][0]["max_tokens"] = 9999  # hand-edit
    path.write_text(json.dumps(artifact))
    with pytest.raises(ValueError, match="digest mismatch"):
        load_capture(str(path))
    path.write_text(json.dumps({"kind": "FLEETSIM"}))
    with pytest.raises(ValueError, match="not a TRACE_CAPTURE"):
        load_capture(str(path))


# -- e2e: request-id mint / honor / echo / spoof-stripping ---------------------

def test_request_id_minted_honored_and_hop_spoof_overridden(
        tmp_path, monkeypatch):
    """The id contract at the front door: the router mints an id when
    the client sends none, honors a sanitized ``X-Request-ID``, mints
    over garbage, and OVERRIDES any client-supplied ``X-Gofr-Hop`` —
    provenance headers are router-asserted, never client-asserted. The
    id is then visible end to end: response header, route record, and
    the replica's flight record (``?request_id=`` filter)."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(1) as replicas, chaos_router(replicas) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 1,
              message="replica in rotation")
        # no client id: minted, echoed, recorded
        _, _, headers = _post(base + "/generate", {"tokens": [1, 2]})
        minted = headers.get("X-Gofr-Request-Id")
        assert minted and minted.startswith("req-")
        # sanitized client id: honored verbatim
        _, _, headers = _post(
            base + "/generate", {"tokens": [1, 2]},
            headers={"X-Request-ID": "client-id-42"},
        )
        assert headers.get("X-Gofr-Request-Id") == "client-id-42"
        # garbage client id: minted over, never reflected back raw
        _, _, headers = _post(
            base + "/generate", {"tokens": [1, 2]},
            headers={"X-Request-ID": "evil id\twith junk!"},
        )
        echoed = headers.get("X-Gofr-Request-Id")
        assert echoed and echoed.startswith("req-") and "evil" not in echoed
        # client-minted hop: overridden by the router's own stamp.
        # (/v1/completions, not /generate: flight records ride the
        # OpenAI admission gate, and the replica-side origin is the
        # evidence that the spoof died at the router boundary)
        _, _, headers = _post(
            base + "/v1/completions",
            {"model": "echo", "prompt": [1, 2, 3], "max_tokens": 2},
            headers={"X-Request-ID": "spoof-probe",
                     "X-Gofr-Hop": "router=evil;attempt=9;resume=5"},
        )
        assert headers.get("X-Gofr-Request-Id") == "spoof-probe"
        route = fleet.records(request_id="spoof-probe")[0]
        assert route["router_id"] == fleet.router_id
        # the replica-side flight record carries the ROUTER's provenance
        victim = replicas[0]
        status, body, _ = _get(
            victim.address + "/admin/requests?request_id=spoof-probe"
        )
        flights = json.loads(body)["data"]["requests"]
        assert flights, "flight record not found by request id"
        origin = flights[0]["origin"]
        assert origin["router"] == fleet.router_id  # not "evil"
        assert origin["attempt"] == 0 and origin["resume_from"] == 0
        # ?request_id= on /admin/fleet narrows the route view too
        status, body, _ = _get(base + "/admin/fleet?request_id=spoof-probe")
        routes = json.loads(body)["data"]["routes"]
        assert [r["request_id"] for r in routes] == ["spoof-probe"]
        # garbage hop/id sent DIRECTLY to a replica never crashes it
        for fuzz in (";;;;", "router=;attempt=z", "a" * 300, "\x00\x01"):
            status, _, _ = _post(
                victim.address + "/generate", {"tokens": [3]},
                headers={"X-Gofr-Hop": fuzz},
            )
            assert status == 200


def test_shed_responses_carry_the_request_id(tmp_path, monkeypatch):
    """A 429 the router refused is otherwise untraceable — the id must
    ride the error body AND header so the client can quote it."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(1) as replicas, chaos_router(
        replicas,
        env={"FLEET_QUOTA_RPS": "0.5", "FLEET_QUOTA_BURST": "1",
             "FLEET_TRUST_TENANT_HEADER": "on"},
    ) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 1,
              message="replica in rotation")
        acme = {"X-Tenant": "acme", "X-Request-ID": "shed-evidence-1"}
        _post(base + "/generate", {"tokens": [1]}, headers=acme)
        try:
            _post(base + "/generate", {"tokens": [1]}, headers=acme)
            raise AssertionError("expected 429 over quota")
        except urllib.error.HTTPError as exc:
            assert exc.code == 429
            assert exc.headers.get("X-Gofr-Request-Id") == "shed-evidence-1"
            assert json.loads(exc.read())["error"]["request_id"] == \
                "shed-evidence-1"
        # the shed left a route record findable by the same id
        shed_routes = fleet.records(request_id="shed-evidence-1")
        assert any(
            str(r.get("outcome", "")).startswith("shed:") for r in shed_routes
        )
        # drain 503 carries the id the same way
        fleet.begin_drain()
        try:
            _post(base + "/generate", {"tokens": [1]},
                  headers={"X-Request-ID": "drain-evidence"})
            raise AssertionError("expected 503 while draining")
        except urllib.error.HTTPError as exc:
            assert exc.code == 503
            assert exc.headers.get("X-Gofr-Request-Id") == "drain-evidence"
            assert json.loads(exc.read())["error"]["request_id"] == \
                "drain-evidence"


# -- e2e: THE acceptance spine -------------------------------------------------

def test_fleet_trace_assembles_transfer_and_resume_timeline(
        tmp_path, monkeypatch):
    """One request's whole story on one page: a streamed completion on
    a prefill/decode fleet rides a cross-replica KV transfer (donor
    warm, router-stamped ``X-KV-Donor``), survives a REAL mid-stream
    device wedge + recovery + resume — and
    ``GET /admin/fleet/trace/<id>`` assembles the route record, the
    replica flight records (joined on the hop-stamped origin), the
    KV-transfer ledger entries from BOTH ends, and the latency
    decomposition into one causal timeline. The continuation's flight
    record shares the original's trace id (span continuity across
    resume) and names its resume offset. A replica that then goes dark
    degrades the SAME endpoint to partial-with-evidence, never a 500."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    prompt = [((7 * i) % 251) + 1 for i in range(48)]
    n_tokens = 24
    expected = [prompt[i % len(prompt)] for i in range(n_tokens)]
    with chaos_fleet(
        2,
        env={"ECHO_STEP_MS": "40", "KV_BLOCK_TOKENS": "16",
             "KV_TRANSFER_TIMEOUT_S": "5"},
        per_replica_env=[{"FLEET_ROLE": "prefill"},
                         {"FLEET_ROLE": "decode"}],
    ) as replicas, chaos_router(
        replicas,
        env={"FLEET_PROBE_INTERVAL_S": "0.05", "FLEET_OUT_AFTER": "2",
             "FLEET_PROBATION_PROBES": "2", "FLEET_READ_TIMEOUT_S": "5",
             "FLEET_DEADLINE_S": "30"},
    ) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        donor, decoder = replicas
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 2,
              message="replicas in rotation")
        # warm the donor: the decode replica's admission will PULL this
        # prompt's KV instead of prefilling locally
        _post(donor.address + "/generate",
              {"tokens": prompt, "max_new_tokens": 2}, timeout=20)

        req = urllib.request.Request(
            base + "/v1/completions",
            data=json.dumps({
                "model": "echo", "prompt": prompt, "max_tokens": n_tokens,
                "stream": True, "seed": 7,
            }).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-ID": "trace-spine-1"},
            method="POST",
        )
        resp = urllib.request.urlopen(req, timeout=30)
        assert resp.status == 200
        assert resp.headers.get("X-Gofr-Request-Id") == "trace-spine-1"
        first = resp.read(1)
        assert first
        decoder.wedge()  # REAL device wedge mid-stream

        def kick():
            try:
                _post(decoder.address + "/generate",
                      {"tokens": [9], "max_new_tokens": 2}, timeout=30)
            except Exception:
                pass  # the wedged dispatch fails by design

        kicker = threading.Thread(target=kick, name="trace-wedge-kick")
        kicker.start()
        try:
            tokens, raw = _read_sse_tokens(resp, initial=first)
        finally:
            decoder.recover()
            kicker.join(20)
        assert b"data: [DONE]" in raw
        assert tokens == expected  # resume was bit-identical

        # -- the timeline ----------------------------------------------------
        status, body, _ = _get(base + "/admin/fleet/trace/trace-spine-1")
        assert status == 200
        timeline = json.loads(body)["data"]
        assert timeline["request_id"] == "trace-spine-1"
        router_block = timeline["router"]
        assert router_block["router_id"] == fleet.router_id
        assert router_block["kv_donor"] == donor.name
        assert router_block["resumes"] >= 1  # the forced resume happened
        assert isinstance(router_block["elapsed_ms"], float)
        served = [a for a in timeline["attempts"] if a.get("status") == 200]
        assert served and served[0]["replica"] == decoder.name
        flight = served[0]["flight"]
        assert flight is not None, timeline["evidence_gaps"]
        assert flight["request_id"] == "trace-spine-1"
        assert flight["origin"]["attempt"] == served[0]["index"]
        # KV-transfer evidence from both ends, keyed by the SAME id
        sides = {t["side"] for t in timeline["transfers"]}
        assert "receiver" in sides, timeline["transfers"]
        assert all(
            t["request_id"] == "trace-spine-1" for t in timeline["transfers"]
        )
        lat = timeline["latency"]
        assert lat["total_ms"] == router_block["elapsed_ms"]
        assert lat["router_overhead_ms"] is not None
        assert lat["replica_queue_ms"] is not None
        assert lat["device_ttft_ms"] is not None

        # span continuity across the resume: the continuation's flight
        # record exists SOMEWHERE in the fleet (the router resumes onto
        # whichever replica is healthy — here the wedged decoder is out,
        # so it lands on the other one), shares the original trace id,
        # and names the journal offset it resumed from
        flights = []
        for member in replicas:
            status, body, _ = _get(
                member.address + "/admin/requests?request_id=trace-spine-1"
            )
            flights.extend(json.loads(body)["data"]["requests"])
        assert len(flights) >= 2, "continuation flight record missing"
        trace_ids = {f["trace_id"] for f in flights}
        assert len(trace_ids) == 1, f"trace broke across resume: {trace_ids}"
        resumed = [f for f in flights if f["origin"]["resume_from"] > 0]
        assert resumed, [f["origin"] for f in flights]

        # -- partial-with-evidence when the replica goes dark ---------------
        decoder.stop_listener()
        try:
            status, body, _ = _get(
                base + "/admin/fleet/trace/trace-spine-1", timeout=30
            )
            assert status == 200  # partial, NOT a 500
            degraded = json.loads(body)["data"]
            assert degraded["partial"] is True
            assert any(
                decoder.name in gap for gap in degraded["evidence_gaps"]
            )
            # the router-side half of the story still stands
            assert degraded["router"]["elapsed_ms"] is not None
        finally:
            decoder.start_listener()


def test_fleet_trace_endpoint_rejects_garbage_and_404s_unknown(
        tmp_path, monkeypatch):
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(1) as replicas, chaos_router(replicas) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        _wait(lambda: len(app.container.fleet.replica_set.in_rotation()) == 1,
              message="replica in rotation")
        # valid-shaped but unknown: 404 with a reasoned message
        try:
            _get(base + "/admin/fleet/trace/req-never-seen")
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as exc:
            assert exc.code == 404
        # fuzzed ids: 4xx verdicts only, the assembler never 500s
        rng = random.Random(1)
        for _ in range(30):
            fuzz = "".join(
                chr(rng.randint(33, 126)) for _ in range(rng.randint(1, 90))
            )
            quoted = urllib.parse.quote(fuzz, safe="")
            try:
                status, _, _ = _get(f"{base}/admin/fleet/trace/{quoted}")
                assert status in (200, 404)
            except urllib.error.HTTPError as exc:
                assert exc.code in (400, 404), (fuzz, exc.code)
