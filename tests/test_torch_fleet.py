"""The port's fleet (``gofr_tpu_torch/fleet/``, ``service.py``,
``devtools/chaos.py``) held to the JAX package's ``tests/test_fleet.py``
case for case (the host-mesh case: the port refuses ``TPU_MESH``, ROADMAP
§A7) and to ``tests/test_deadline.py``'s two router cases; then against the
JAX package: the affinity helpers, the breaker's transitions, the quota
decisions and the probe delays on the same inputs and one fake clock, and
mixed fleets (a JAX router before port replicas and the reverse) answering
as an all-JAX fleet. The JAX file's own description follows.

Fleet front door, tier-1: unit semantics for the breaker / quota /
affinity pieces, then chaos e2e over real sockets — multi-replica echo
fleets in ONE process (``gofr_tpu/devtools/chaos.py``), every failure
injected deterministically:

- a force-wedged replica mid-request: the client request still
  completes, retried to a healthy replica (non-stream AND not-yet-
  streamed SSE), and the wedged replica's breaker opens within its
  configured threshold;
- connection refused (listener gone): retries land elsewhere, the
  breaker opens, half-open probes, closes on recovery;
- a device-level wedge (echo ``stall_hook`` + watchdog): the replica
  leaves rotation on its OWN readiness 503 — whose body now carries the
  watchdog evidence — and re-enters through probation;
- induced ``kv_exhausted``: admission sheds 429 + Retry-After while
  every in-rotation replica is starved, never queueing unboundedly;
- graceful drain: in-flight requests finish, new ones shed, readiness
  flips 503.

These tests spawn several HTTP servers each; CI also runs this module
serially in the ``fleet-chaos`` step.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from gofr_tpu_torch.fleet import parse_replicas
from gofr_tpu_torch.fleet.admission import QuotaTable, TokenBucket, tenant_of
from gofr_tpu_torch.fleet.breaker import CLOSED, HALF_OPEN, OPEN, PROBE, CircuitBreaker
from gofr_tpu_torch.fleet.replica import affinity_order


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


def _fleet_snapshot(app):
    return app.container.fleet.snapshot()


def _key_for(target: str, names: list) -> str:
    """An affinity key that rendezvous-routes to ``target``."""
    for i in range(1000):
        key = f"conv-{i}"
        if affinity_order(key, list(names))[0] == target:
            return key
    raise AssertionError(f"no key found mapping to {target}")


def _tokens_for(target: str, names: list) -> list:
    """A token-id prompt whose KV-hash rendezvous routes to ``target``
    (token prompts route by prompt hash, not by the session-key
    heuristics, unless the client pins a session explicitly)."""
    from gofr_tpu_torch.fleet.kvwire import prompt_hash

    for i in range(1000):
        tokens = [i + 1, i + 2, i + 3]
        if affinity_order(prompt_hash(tokens), list(names))[0] == target:
            return tokens
    raise AssertionError(f"no tokens found mapping to {target}")


# -- unit: circuit breaker -----------------------------------------------------

def test_breaker_opens_half_opens_and_closes():
    transitions = []
    breaker = CircuitBreaker(
        failure_threshold=2, cooldown_s=0.1,
        on_transition=lambda was, to: transitions.append((was, to)),
    )
    assert breaker.state == CLOSED and breaker.try_acquire()
    breaker.record_failure()
    assert breaker.state == CLOSED  # one failure is not a trip
    breaker.record_failure()
    assert breaker.state == OPEN
    assert not breaker.try_acquire()  # cooldown running
    time.sleep(0.12)
    assert breaker.try_acquire() == PROBE  # the half-open probe slot
    assert breaker.state == HALF_OPEN
    assert not breaker.try_acquire()  # ONE probe at a time
    breaker.record_success(probe=True)
    assert breaker.state == CLOSED
    assert transitions == [
        (CLOSED, OPEN), (OPEN, HALF_OPEN), (HALF_OPEN, CLOSED)
    ]
    snap = breaker.snapshot()
    assert snap["state"] == CLOSED and snap["transitions"] == 3


def test_breaker_half_open_failure_reopens():
    breaker = CircuitBreaker(failure_threshold=1, cooldown_s=0.05)
    breaker.record_failure()
    assert breaker.state == OPEN
    time.sleep(0.06)
    assert breaker.try_acquire()
    breaker.record_failure()  # the probe failed
    assert breaker.state == OPEN
    assert not breaker.try_acquire()  # cooldown restarted
    assert "cooldown_remaining_s" in breaker.snapshot()


def test_breaker_half_open_race_admits_exactly_one_probe():
    """Two (here: eight) threads contending for the single half-open
    probe slot must admit EXACTLY one — the race is real: try_acquire
    reads the cooldown clock and claims the slot in one critical
    section, and a double grant would double-probe a replica that
    earned exactly one trial request."""
    breaker = CircuitBreaker(failure_threshold=1, cooldown_s=0.05)
    breaker.record_failure()
    assert breaker.state == OPEN
    time.sleep(0.06)  # cooldown passed: next acquire flips half-open

    n = 8
    barrier = threading.Barrier(n)
    grants: list = [None] * n

    def contend(i: int) -> None:
        barrier.wait()
        grants[i] = breaker.try_acquire()

    threads = [
        threading.Thread(target=contend, args=(i,), name=f"probe-race-{i}")
        for i in range(n)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    assert sum(1 for g in grants if g == PROBE) == 1
    assert all(g is False for g in grants if g != PROBE)
    assert breaker.state == HALF_OPEN
    # the single winner reports success -> the breaker closes; the
    # losers' (refused) outcomes never touched the probe slot
    breaker.record_success(probe=True)
    assert breaker.state == CLOSED


def test_breaker_success_resets_failure_streak():
    breaker = CircuitBreaker(failure_threshold=2, cooldown_s=1)
    breaker.record_failure()
    breaker.record_success()
    breaker.record_failure()
    assert breaker.state == CLOSED  # streak broken: 1+1 is not 2


def test_breaker_open_ignores_stale_success():
    """A success from a request dispatched BEFORE the trip (or a long
    stream finishing minutes later) must not close an OPEN breaker —
    recovery goes through the half-open probe, always."""
    breaker = CircuitBreaker(failure_threshold=1, cooldown_s=10)
    breaker.record_failure()
    assert breaker.state == OPEN
    breaker.record_success()  # stale: pre-trip dispatch completing
    assert breaker.state == OPEN
    assert not breaker.try_acquire()  # cooldown still holds


def test_breaker_half_open_stale_success_does_not_preempt_probe():
    """While probe P runs, a stale non-probe success must not close the
    breaker on P's behalf — only the probe's own verdict counts."""
    breaker = CircuitBreaker(failure_threshold=1, cooldown_s=0.05)
    breaker.record_failure()
    time.sleep(0.06)
    assert breaker.try_acquire() == PROBE  # probe P in flight
    breaker.record_success()  # stale success from a pre-trip request
    assert breaker.state == HALF_OPEN  # P's outcome still pending
    breaker.record_success(probe=True)  # P reports
    assert breaker.state == CLOSED


# -- unit: admission -----------------------------------------------------------

def test_token_bucket_denies_with_refill_hint():
    bucket = TokenBucket(rate=10.0, capacity=2.0)
    assert bucket.take() == (True, 0.0)
    assert bucket.take()[0]
    ok, retry_after = bucket.take()
    assert not ok and 0 < retry_after <= 0.11
    time.sleep(retry_after + 0.02)
    assert bucket.take()[0]  # the hint was honest


def test_quota_table_per_tenant_and_disabled():
    # near-zero refill: at high rates the bucket regains a token within
    # the microseconds between takes and the deny assertion flakes
    table = QuotaTable(rate_rps=0.001, burst=1.0)
    assert table.take("a")[0]
    assert not table.take("a")[0]  # a's burst spent
    assert table.take("b")[0]     # b unaffected
    stats = table.stats()
    assert stats["tenants"] == 2 and stats["denied"] == 1
    off = QuotaTable(rate_rps=0.0, burst=0.0)
    assert all(off.take("x")[0] for _ in range(100))


def test_quota_table_redis_backend_and_fail_open():
    """The redis backing runs against the REAL client + miniredis —
    the pipelined HGET/HSET/EXPIRE path, fleet-wide bucket sharing
    across two QuotaTables (two router processes), and fail-open."""
    from gofr_tpu_torch.datasource.miniredis import MiniRedis
    from gofr_tpu_torch.datasource.redis import new_client
    from gofr_tpu_torch.testutil import MockLogger

    mini = MiniRedis().run()
    client = new_client("127.0.0.1", mini.port, MockLogger())
    try:
        table = QuotaTable(rate_rps=0.001, burst=1.0, redis=client)
        assert table.take("t")[0]
        # a SECOND router process sees the same spent bucket
        sibling = QuotaTable(rate_rps=0.001, burst=1.0, redis=client)
        ok, retry_after = sibling.take("t")
        assert not ok and retry_after > 0
        assert table.stats()["backend"] == "redis"
        assert client.ttl("fleet:quota:t") > 0  # idle tenants expire
    finally:
        client.close()
        mini.close()

    class BrokenRedis:
        def pipeline(self):
            raise ConnectionError("redis down")

    logger = MockLogger()
    failing = QuotaTable(rate_rps=0.001, burst=1.0, redis=BrokenRedis(),
                         logger=logger)
    assert failing.take("t")[0]  # fail OPEN to the memory bucket
    assert not failing.take("t")[0]  # which still enforces
    assert "failing open" in logger.output


def test_tenant_of_header_then_auth_then_anonymous():
    from gofr_tpu_torch.http.request import Request

    # X-Tenant is honored only when the operator opted in (a gateway
    # stamps it); trusted from arbitrary clients it would let anyone
    # mint a fresh quota bucket per request by randomizing the header
    trusted = Request("GET", "/", {"x-tenant": "acme"})
    assert tenant_of(trusted, trust_tenant_header=True) == "acme"
    assert tenant_of(trusted) == "anonymous"
    both = Request("GET", "/", {"x-tenant": "spoof",
                                "authorization": "Bearer sk-123"})
    assert tenant_of(both).startswith("key-")  # the KEY pays, not the header
    key_a = tenant_of(Request("GET", "/", {"authorization": "Bearer sk-123"}))
    key_b = tenant_of(Request("GET", "/", {"authorization": "Bearer sk-456"}))
    # API keys bucket stably but the tenant string (which lands in
    # route records, /admin/fleet, and redis keys) is a HASH — no
    # secret material may leak through the admin surface
    assert key_a.startswith("key-") and key_b.startswith("key-")
    assert key_a != key_b
    assert "sk-123" not in key_a
    assert key_a == tenant_of(
        Request("GET", "/", {"authorization": "Bearer sk-123"})
    )
    assert tenant_of(Request("GET", "/", {})) == "anonymous"


def test_router_sheds_do_not_charge_quota_tokens():
    """Router-side rejections (no replicas, draining, in-flight cap)
    must not burn the tenant's tokens — a tenant retrying politely
    through a saturation episode would otherwise arrive quota-blocked
    when capacity returns. A QUOTA shed in turn must release the
    in-flight slot it briefly held."""
    from gofr_tpu_torch.fleet.replica import Replica, ReplicaSet
    from gofr_tpu_torch.fleet.router import FleetRouter
    from gofr_tpu_torch.http.request import Request
    from gofr_tpu_torch.metrics import Registry
    from gofr_tpu.testutil import MockLogger

    logger = MockLogger()
    quota = QuotaTable(rate_rps=1.0, burst=1.0)
    router = FleetRouter(
        logger, Registry(), ReplicaSet([], logger), quota,
    )
    request = Request("POST", "/generate", {"x-tenant": "acme"})
    verdict = router._admit(request, "acme")
    assert verdict is not None and verdict.status == 503  # no replicas
    router._draining = True
    verdict = router._admit(request, "acme")
    assert verdict is not None and verdict.status == 503  # draining
    stats = quota.stats()
    assert stats["admitted"] == 0 and stats["denied"] == 0  # untouched
    assert router.in_flight == 0  # no slot held across sheds

    # with a rotation: admitted requests HOLD the slot, quota denials
    # release it
    with_replica = FleetRouter(
        logger, Registry(),
        ReplicaSet([Replica("r0", "http://127.0.0.1:1", logger)], logger),
        QuotaTable(rate_rps=0.001, burst=1.0),
    )
    assert with_replica._admit(request, "acme") is None
    assert with_replica.in_flight == 1  # held for the forward
    with_replica._release()
    verdict = with_replica._admit(request, "acme")  # burst of 1 spent
    assert verdict is not None and verdict.status == 429
    assert with_replica.in_flight == 0  # quota shed released the slot

    # the in-flight cap itself is atomic check-and-increment
    capped = FleetRouter(
        logger, Registry(),
        ReplicaSet([Replica("r0", "http://127.0.0.1:1", logger)], logger),
        QuotaTable(rate_rps=0.0, burst=0.0),
        max_inflight=1,
    )
    assert capped._admit(request, "t") is None
    verdict = capped._admit(request, "t")
    assert verdict is not None and verdict.status == 429
    assert json.loads(verdict.body)["error"]["reason"] == "inflight"
    capped._release()
    assert capped._admit(request, "t") is None  # slot freed, admits again


# -- unit: affinity + replica spec ---------------------------------------------

def test_affinity_order_is_stable_under_membership_churn():
    names = ["r0", "r1", "r2", "r3"]
    for key in ("alice", "bob", "conv-42"):
        full = affinity_order(key, names)
        survivor_order = [n for n in full if n != full[0]]
        assert affinity_order(key, [n for n in names if n != full[0]]) == \
            survivor_order  # removing the holder only remaps ITS keys
    # keys spread: not everything lands on one replica
    firsts = {affinity_order(f"k{i}", names)[0] for i in range(32)}
    assert len(firsts) > 1


def test_parse_replicas_names_and_errors():
    assert parse_replicas("http://a:1,http://b:2") == [
        ("r0", "http://a:1"), ("r1", "http://b:2")
    ]
    assert parse_replicas("x=http://a:1, y=http://b:2 ,") == [
        ("x", "http://a:1"), ("y", "http://b:2")
    ]
    with pytest.raises(ValueError, match="twice"):
        parse_replicas("x=http://a:1,x=http://b:2")
    with pytest.raises(ValueError, match="no URL"):
        parse_replicas("x=")


# -- unit: resilient service client -------------------------------------------

def test_service_call_error_carries_elapsed_and_attempts():
    from gofr_tpu_torch.service import HTTPService, ServiceCallError
    from gofr_tpu.testutil import MockLogger

    svc = HTTPService("http://127.0.0.1:1", MockLogger(), name="ghost",
                      connect_timeout=0.2, read_timeout=0.2)
    with pytest.raises(ServiceCallError) as excinfo:
        svc.request("GET", "/x", retries=2)
    err = excinfo.value
    assert err.attempts == 3
    assert err.elapsed_s > 0
    assert "3 attempt(s)" in str(err)


def test_service_client_retries_5xx_for_idempotent_only(free_port):
    import http.server

    port = free_port()
    hits = {"n": 0}

    class Flaky(http.server.BaseHTTPRequestHandler):
        def _serve(self):
            hits["n"] += 1
            status = 503 if hits["n"] < 3 else 200
            payload = b'{"ok": true}'
            self.send_response(status)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = _serve

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", port), Flaky)
    thread = threading.Thread(target=srv.serve_forever, daemon=True,
                              name="test-flaky-http")
    thread.start()
    try:
        from gofr_tpu_torch.service import HTTPService
        from gofr_tpu.testutil import MockLogger

        svc = HTTPService(f"http://127.0.0.1:{port}", MockLogger())
        resp = svc.request("GET", "/x", retries=3)
        assert resp.status_code == 200 and hits["n"] == 3
        hits["n"] = 0
        resp = svc.request("POST", "/x", retries=3)  # NOT idempotent
        assert resp.status_code == 503 and hits["n"] == 1
        hits["n"] = 0
        resp = svc.request("POST", "/x", retries=3, retryable=True)
        assert resp.status_code == 200 and hits["n"] == 3
    finally:
        srv.shutdown()
        thread.join(5)


def test_redirects_followed_for_safe_methods_only(free_port):
    """urlopen parity: GET follows Location hops; POST gets the 3xx
    raw (replaying a body across a redirect is the caller's call)."""
    import http.server

    port = free_port()

    class Redirecting(http.server.BaseHTTPRequestHandler):
        def _serve(self):
            if self.path == "/old":
                self.send_response(302)
                self.send_header("Location", "/new")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            payload = b'{"moved": true}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = _serve

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", port), Redirecting)
    thread = threading.Thread(target=srv.serve_forever, daemon=True,
                              name="test-redirect-http")
    thread.start()
    try:
        from gofr_tpu_torch.service import HTTPService
        from gofr_tpu.testutil import MockLogger

        svc = HTTPService(f"http://127.0.0.1:{port}", MockLogger())
        resp = svc.get("/old")
        assert resp.status_code == 200 and resp.json() == {"moved": True}
        resp = svc.post("/old", body={"x": 1})
        assert resp.status_code == 302  # returned raw, not replayed
    finally:
        srv.shutdown()
        thread.join(5)


def test_drip_fed_body_cannot_outlive_the_read_budget(free_port):
    """Socket timeouts are per-recv: an upstream dripping one byte per
    interval would reset the clock forever and pin a router handler
    thread. The buffered read is bounded by a TOTAL read_timeout."""
    import socket as socket_mod

    port = free_port()
    stop = threading.Event()
    server = socket_mod.socket()
    server.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", port))
    server.listen(1)

    def drip():
        conn, _ = server.accept()
        try:
            conn.recv(65536)
            conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 1000000\r\n\r\n")
            while not stop.wait(0.05):  # one byte per 50ms, forever
                conn.sendall(b"x")
        except OSError:
            pass
        finally:
            conn.close()

    thread = threading.Thread(target=drip, name="test-drip-server")
    thread.start()
    try:
        from gofr_tpu_torch.service import HTTPService, ServiceCallError
        from gofr_tpu.testutil import MockLogger

        svc = HTTPService(f"http://127.0.0.1:{port}", MockLogger())
        start = time.monotonic()
        with pytest.raises(ServiceCallError):
            svc.request("GET", "/x", read_timeout=0.4, retries=0)
        assert time.monotonic() - start < 3.0  # bounded, not forever
    finally:
        stop.set()
        server.close()
        thread.join(5)


def test_backoff_delays_decorrelate_and_cap():
    from gofr_tpu_torch.service import backoff_delays

    delays = list(backoff_delays(50, base=0.01, cap=0.2))
    assert len(delays) == 50
    assert all(0.01 <= d <= 0.2 for d in delays)
    assert len(set(delays)) > 10  # jittered, not a fixed ladder


# -- e2e: routing, retry, breaker ---------------------------------------------

def _completion(base, prompt, headers=None, stream=False, max_tokens=4,
                timeout=15):
    payload = {"model": "echo", "prompt": prompt, "max_tokens": max_tokens}
    if stream:
        payload["stream"] = True
    return _post(base + "/v1/completions", payload, headers=headers,
                 timeout=timeout)


def test_wedged_replica_mid_request_retries_to_healthy(tmp_path, monkeypatch):
    """The acceptance spine: one of three replicas force-wedged while
    serving; the client request still completes, and the wedged
    replica's breaker opens within its threshold."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(3) as replicas, chaos_router(
        replicas,
        # read timeout must be comfortably above a healthy echo
        # completion on a LOADED runner (0.4s raced real decode work
        # and flaked) while staying far below the 30s chaos stall
        env={"FLEET_READ_TIMEOUT_S": "2", "FLEET_BREAKER_THRESHOLD": "1",
             "FLEET_BREAKER_COOLDOWN_S": "30", "FLEET_PROBE_INTERVAL_S": "30"},
    ) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 3,
              message="3 replicas in rotation")
        names = [r.name for r in fleet.replica_set.replicas]
        target = "r1"
        key = _key_for(target, names)
        victim = next(r for r in replicas if r.name == target)
        victim.chaos.stall(30.0)  # wedged: accepts, never answers

        # non-stream: first attempt times out on r1, retry completes
        status, body, _ = _completion(
            base, [5, 6, 7], headers={"X-Session-ID": key}
        )
        assert status == 200
        payload = json.loads(body)
        assert payload["choices"]  # a full completion from a HEALTHY replica
        assert payload["usage"]["completion_tokens"] == 4
        snap = _fleet_snapshot(app)
        route = snap["routes"][0]
        assert route["retries"] >= 1
        assert route["attempts"][0]["replica"] == target
        assert route["attempts"][0]["error"]
        assert route["attempts"][-1]["status"] == 200
        assert route["attempts"][-1]["replica"] != target
        by_name = {r["name"]: r for r in snap["replica_set"]["replicas"]}
        assert by_name[target]["breaker"]["state"] == "open"  # threshold 1

        # streaming, not-yet-streamed: r1 would stall before the response
        # head, so the router may still fail over; the SSE completes
        victim2 = next(r for r in replicas if r.name != target)
        key2 = _key_for(victim2.name, names)
        victim2.chaos.stall(30.0)
        status, body, headers = _completion(
            base, [1, 2, 3], headers={"X-Session-ID": key2}, stream=True
        )
        assert status == 200
        assert headers["Content-Type"].startswith("text/event-stream")
        assert b"data: [DONE]" in body  # the stream COMPLETED elsewhere

        # router metrics observed the retries
        _, metrics_body, _ = _get(base + "/metrics")
        text = metrics_body.decode()
        assert "gofr_tpu_router_retries_total" in text
        assert 'gofr_tpu_router_breaker_state{replica="' + target + '"} 2' \
            in text


def test_connection_refused_breaker_cycle(tmp_path, monkeypatch):
    """Listener killed: requests retry elsewhere (clients never see the
    failure), the breaker opens after its threshold, half-opens after
    the cooldown, and closes once the listener returns."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(3) as replicas, chaos_router(
        replicas,
        env={"FLEET_BREAKER_THRESHOLD": "2",
             "FLEET_BREAKER_COOLDOWN_S": "0.2",
             "FLEET_PROBE_INTERVAL_S": "30"},  # rotation state frozen
    ) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 3,
              message="3 replicas in rotation")
        names = [r.name for r in fleet.replica_set.replicas]
        dead = replicas[0]
        dead.stop_listener()  # connection refused from here on

        def breaker_state():
            return fleet.replica_set.by_name(dead.name).breaker.state

        # drive requests until the breaker trips; the prompt's KV-hash
        # rendezvous pins the dead replica first in every pick, so each
        # request charges its breaker deterministically
        tokens = _tokens_for(dead.name, names)
        for _ in range(8):
            status, _, _ = _post(base + "/generate", {"tokens": tokens})
            assert status == 200  # the CLIENT never sees the dead replica
            if breaker_state() == "open":
                break
        assert breaker_state() == "open"

        dead.start_listener()
        time.sleep(0.25)  # past the cooldown: next pick half-opens
        for _ in range(8):
            status, _, _ = _post(base + "/generate", {"tokens": tokens})
            assert status == 200
            if breaker_state() == "closed":
                break
        assert breaker_state() == "closed", \
            "breaker must close after recovery probe"
        snap = _fleet_snapshot(app)
        by_name = {r["name"]: r for r in snap["replica_set"]["replicas"]}
        assert by_name[dead.name]["breaker"]["transitions"] >= 3
        _, metrics_body, _ = _get(base + "/metrics")
        assert 'gofr_tpu_router_breaker_transitions_total{replica="' \
            + dead.name + '",to="open"}' in metrics_body.decode()


def test_device_wedge_leaves_rotation_and_probation_reentry(
        tmp_path, monkeypatch):
    """A REAL engine wedge (echo stall_hook + watchdog): the replica's
    own readiness 503s — with the watchdog evidence in the body — the
    prober takes it out of rotation, and recovery walks probation
    before traffic returns. RECOVERY_ENABLED=off on purpose: this test
    pins the legacy stall-resolves-itself path (the watchdog's own
    recovery transition); the supervisor-driven rebuild has its own
    e2e (test_recovery.py + the resume e2e below)."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(2, env={"RECOVERY_ENABLED": "off"}) as replicas, chaos_router(
        replicas,
        env={"FLEET_PROBE_INTERVAL_S": "0.05", "FLEET_OUT_AFTER": "1",
             "FLEET_PROBATION_PROBES": "3"},
    ) as app:
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 2,
              message="both replicas in rotation")
        victim = replicas[0]
        victim.wedge(1.2)  # next dispatch stalls 1.2s; watchdog is 0.2s

        def kick():
            try:
                _post(victim.address + "/generate",
                      {"tokens": [9], "max_new_tokens": 2}, timeout=15)
            except Exception:
                pass

        kicker = threading.Thread(target=kick, name="test-wedge-kick")
        kicker.start()
        try:
            _wait(lambda: fleet.replica_set.by_name(victim.name).state
                  == "out", timeout=15, message="wedged replica out")
            # the replica's OWN ready body explains why (satellite:
            # engine state + watchdog reason in the 503 body) — read it
            # BEFORE recover(): releasing the latch un-stalls the
            # dispatch and the watchdog flips the engine back instantly
            try:
                _get(victim.address + "/.well-known/ready", timeout=5)
                raise AssertionError("expected 503 while wedged")
            except urllib.error.HTTPError as exc:
                payload = json.loads(exc.read())
                assert payload["state"] in ("degraded", "wedged")
                assert payload["detail"]
                assert "watchdog" in payload
                assert payload["watchdog"]["stalls"]
            victim.recover()  # the paired heal control: stall releases NOW
            # traffic avoids the wedged replica meanwhile
            base = f"http://127.0.0.1:{app.http_port}"
            status, _, _ = _post(base + "/generate", {"tokens": [1]})
            assert status == 200
            snap = _fleet_snapshot(app)
            served = {a["replica"] for r in snap["routes"]
                      for a in r["attempts"] if a.get("status") == 200}
            assert victim.name not in served
        finally:
            kicker.join(20)
        # recovery: the stall ends, the engine recovers, and the replica
        # must string together FLEET_PROBATION_PROBES ok probes
        _wait(lambda: fleet.replica_set.by_name(victim.name).state
              == "healthy", timeout=20, message="probation re-entry")
        assert fleet.replica_set.by_name(victim.name).probes >= 3


# -- e2e: admission control ----------------------------------------------------

def test_kv_exhausted_sheds_429_with_retry_after(tmp_path, monkeypatch):
    """Induced kv_exhausted: a long generation pins EVERY paged-KV
    block of the only replica, the next request is rejected by the pool
    (it still completes via the solo fallback — the reject is a signal,
    not a failure), the prober picks the rising reject counter up, and
    the router sheds subsequent work with 429 + Retry-After instead of
    queueing unboundedly."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(
        1,
        env={"KV_BLOCKS": "64", "KV_BLOCK_TOKENS": "2",
             "ECHO_STEP_MS": "30", "WATCHDOG_DISPATCH_TIMEOUT_S": "off"},
    ) as replicas, chaos_router(
        replicas, env={"FLEET_PROBE_INTERVAL_S": "0.05"}
    ) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        replica = fleet.replica_set.replicas[0]
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 1,
              message="replica in rotation")
        _wait(lambda: replica.engine is not None, message="engine scraped")
        # 28 prompt + 100 new tokens = 128 tokens = ALL 64 blocks of 2,
        # held for ~3s of step-delayed decoding
        hog = threading.Thread(
            target=lambda: _post(
                base + "/generate",
                {"tokens": list(range(1, 29)), "max_new_tokens": 100},
                timeout=30,
            ),
            name="test-kv-hog",
        )
        hog.start()
        try:
            _wait(
                lambda: (replica.engine or {}).get("kv_free") == 0,
                timeout=10, message="hog pinned every block",
            )
            # the canary is REJECTED by the pool (kv_exhausted) but the
            # request itself still completes — solo fallback
            status, _, _ = _post(base + "/generate",
                                 {"tokens": [1, 2], "max_new_tokens": 2},
                                 timeout=10)
            assert status == 200
            _wait(lambda: replica.saturated, timeout=10,
                  message="prober sees the kv_exhausted rejects")
            assert (replica.engine or {}).get("kv_exhausted_rejects", 0) >= 1
            try:
                _post(base + "/generate", {"tokens": [1, 2]}, timeout=5)
                raise AssertionError("expected 429 while saturated")
            except urllib.error.HTTPError as exc:
                assert exc.code == 429
                assert int(exc.headers["Retry-After"]) >= 1
                payload = json.loads(exc.read())
                assert payload["error"]["reason"] == "kv_exhausted"
            counter = app.container.metrics.counter(
                "gofr_tpu_router_shed_total", labels=("reason",)
            )
            assert counter.value(reason="kv_exhausted") >= 1
            snap = _fleet_snapshot(app)
            assert any(r["outcome"] == "shed:kv_exhausted"
                       for r in snap["routes"])
        finally:
            hog.join(30)
        # blocks free as the hog finishes: admission recovers
        _wait(lambda: not replica.saturated,
              timeout=10, message="saturation clears")
        status, _, _ = _post(base + "/generate", {"tokens": [1, 2]})
        assert status == 200


def test_quota_sheds_429_per_tenant(tmp_path, monkeypatch):
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(1) as replicas, chaos_router(
        replicas,
        env={"FLEET_QUOTA_RPS": "0.5", "FLEET_QUOTA_BURST": "2",
             "FLEET_TRUST_TENANT_HEADER": "on"},
    ) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        _wait(lambda: len(app.container.fleet.replica_set.in_rotation()) == 1,
              message="replica in rotation")
        acme = {"X-Tenant": "acme"}
        for _ in range(2):
            status, _, _ = _post(base + "/generate", {"tokens": [1]},
                                 headers=acme)
            assert status == 200
        try:
            _post(base + "/generate", {"tokens": [1]}, headers=acme)
            raise AssertionError("expected 429 over quota")
        except urllib.error.HTTPError as exc:
            assert exc.code == 429
            assert "Retry-After" in exc.headers
            assert json.loads(exc.read())["error"]["reason"] == "quota"
        # another tenant is unaffected
        status, _, _ = _post(base + "/generate", {"tokens": [1]},
                             headers={"X-Tenant": "other"})
        assert status == 200


def test_upstream_429_burst_echoes_with_retry_after(tmp_path, monkeypatch):
    """A replica answering 429 (its own admission) is echoed upstream
    verbatim with a Retry-After — the router never retry-storms an
    overloaded replica."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(1) as replicas, chaos_router(replicas) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        _wait(lambda: len(app.container.fleet.replica_set.in_rotation()) == 1,
              message="replica in rotation")
        replicas[0].chaos.error_burst(1, status=429,
                                      paths=("/generate",))
        try:
            _post(base + "/generate", {"tokens": [1]})
            raise AssertionError("expected 429 echoed")
        except urllib.error.HTTPError as exc:
            assert exc.code == 429
            assert "Retry-After" in exc.headers
        assert replicas[0].chaos.injected.get("error_burst") == 1  # ONE try


def test_5xx_burst_retries_and_mid_stream_disconnect_aborts(
        tmp_path, monkeypatch):
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(2) as replicas, chaos_router(replicas) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 2,
              message="replicas in rotation")
        # 5xx burst on both replicas: first two attempts eat the bursts,
        # retry completes on whichever recovered first
        for replica in replicas:
            replica.chaos.error_burst(1, status=503, paths=("/generate",))
        status, _, _ = _post(base + "/generate", {"tokens": [4, 5]})
        assert status == 200
        snap = _fleet_snapshot(app)
        assert snap["routes"][0]["retries"] >= 1

        # mid-stream disconnect: chunks flowed, so NO replay — the
        # router aborts the client connection (truncated body)
        names = [r.name for r in fleet.replica_set.replicas]
        key = _key_for(replicas[0].name, names)
        replicas[0].chaos.disconnect_after(1, paths=("/v1/",))
        with pytest.raises(Exception) as excinfo:
            _completion(base, [1, 2, 3], headers={"X-Session-ID": key},
                        stream=True, max_tokens=8)
        assert not isinstance(excinfo.value, urllib.error.HTTPError) or \
            excinfo.value.code >= 500
        _wait(
            lambda: any(r["outcome"] == "aborted"
                        for r in _fleet_snapshot(app)["routes"]),
            timeout=5, message="aborted route record",
        )


# -- e2e: self-healing engine + resumable streams (acceptance) ---------

def _read_sse_tokens(resp, initial: bytes = b"") -> tuple:
    """Drain one SSE response: returns (token_ids, event_ids, raw)."""
    raw = initial
    while True:
        chunk = resp.read(4096)
        if not chunk:
            break
        raw += chunk
    tokens: list = []
    ids: list = []
    for block in raw.split(b"\n\n"):
        event_id = None
        for line in block.split(b"\n"):
            if line.startswith(b"id:"):
                event_id = int(line[3:].strip())
            elif line.startswith(b"data:"):
                data = line[5:].strip()
                if data == b"[DONE]" or not data.startswith(b"{"):
                    continue
                frame = json.loads(data)
                if "error" in frame:
                    raise AssertionError(f"error frame reached client: {frame}")
                choice = frame["choices"][0]
                if choice.get("tokens"):
                    tokens.extend(choice["tokens"])
                    if event_id is not None:
                        ids.append(event_id)
    return tokens, ids, raw


def test_wedge_mid_stream_recovers_and_resumes_bit_identical(
        tmp_path, monkeypatch):
    """THE acceptance spine of the self-healing engine: a seeded SSE
    stream is interrupted by a REAL device wedge (echo stall_hook +
    watchdog); the recovery supervisor rebuilds the engine back to
    serving WITHOUT a process restart; the router's stream relay
    resumes from the journaled offset — and the client's stream
    completes with zero missing and zero duplicated tokens, asserted
    bit-identical against the uninterrupted expectation. Recovery is
    visible on gofr_tpu_engine_recoveries_total and /admin/engine."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    prompt, n_tokens = [5, 6, 7], 40
    expected = [prompt[i % 3] for i in range(n_tokens)]  # echo's contract
    with chaos_fleet(1, env={"ECHO_STEP_MS": "40"}) as replicas, chaos_router(
        replicas,
        env={"FLEET_PROBE_INTERVAL_S": "0.05", "FLEET_OUT_AFTER": "2",
             "FLEET_PROBATION_PROBES": "2", "FLEET_READ_TIMEOUT_S": "5",
             "FLEET_DEADLINE_S": "30"},
    ) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        victim = replicas[0]
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 1,
              message="replica in rotation")

        req = urllib.request.Request(
            base + "/v1/completions",
            data=json.dumps({
                "model": "echo", "prompt": prompt, "max_tokens": n_tokens,
                "stream": True, "seed": 7,
            }).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        resp = urllib.request.urlopen(req, timeout=30)
        assert resp.status == 200

        # let a few tokens flow, then wedge the device mid-stream: the
        # latch holds until recover(); a sacrificial direct request
        # carries the stall into a watched dispatch
        first = resp.read(1)  # at least one byte of the stream arrived
        assert first
        victim.wedge()

        def kick():
            try:
                _post(victim.address + "/generate",
                      {"tokens": [9], "max_new_tokens": 2}, timeout=30)
            except Exception:
                pass  # the wedged dispatch fails by design

        kicker = threading.Thread(target=kick, name="test-wedge-kick")
        kicker.start()
        try:
            # the client keeps reading through wedge -> recovery ->
            # resume; the relay splices the continuation in
            tokens, ids, raw = _read_sse_tokens(resp, initial=first)
        finally:
            victim.recover()
            kicker.join(20)
        assert raw  # the stream carried data after the wedge
        assert b"data: [DONE]" in raw  # completed, not truncated

        # ZERO missing, ZERO duplicated: bit-identical to uninterrupted
        assert tokens == expected
        assert ids == sorted(set(ids))  # strictly monotonic event ids

        # the engine RECOVERED (no process restart): counter + admin
        status, body, _ = _get(victim.address + "/admin/engine")
        engine = json.loads(body)["data"]
        assert engine["engine"]["state"] == "serving"
        assert engine["recovery"]["recoveries"].get("recovered", 0) >= 1
        assert engine["recovery"]["last_mttr_s"] is not None
        states = [h["state"] for h in engine["engine"]["history"]]
        assert "recovering" in states and "wedged" in states
        _, metrics_body, _ = _get(victim.address + "/metrics")
        assert ('gofr_tpu_engine_recoveries_total{outcome="recovered"}'
                in metrics_body.decode())

        # the router saw (and journaled) the resume
        snap = _fleet_snapshot(app)
        resumed_routes = [r for r in snap["routes"] if r.get("resumes")]
        assert resumed_routes, snap["routes"]
        _, router_metrics, _ = _get(base + "/metrics")
        assert ('gofr_tpu_router_stream_resumes_total{outcome="resumed"}'
                in router_metrics.decode())


# -- e2e: graceful drain -------------------------------------------------------

def test_sigterm_drain_finishes_inflight_then_sheds(tmp_path, monkeypatch):
    """App.shutdown (the SIGTERM path) drains: the in-flight request
    completes through the still-open listener, new requests shed, and
    readiness flips to a draining 503."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    fleet_ctx = chaos_fleet(2, env={"ECHO_STEP_MS": "25"})
    replicas = fleet_ctx.__enter__()
    try:
        router_ctx = chaos_router(
            replicas, env={"FLEET_DRAIN_TIMEOUT_S": "20"}
        )
        app = router_ctx.__enter__()
        shutdown_done = False
        try:
            base = f"http://127.0.0.1:{app.http_port}"
            fleet = app.container.fleet
            _wait(lambda: len(fleet.replica_set.in_rotation()) == 2,
                  message="replicas in rotation")
            slow_result = {}

            def slow():
                # ~100 tokens x 25ms ≈ 2.5s of decoding
                slow_result["resp"] = _post(
                    base + "/generate",
                    {"tokens": [1, 2, 3], "max_new_tokens": 100},
                    timeout=30,
                )

            worker = threading.Thread(target=slow, name="test-drain-slow")
            worker.start()
            _wait(lambda: fleet.in_flight >= 1, message="request in flight")

            shutdown_thread = threading.Thread(
                target=app.shutdown, name="test-drain-shutdown"
            )
            shutdown_thread.start()
            _wait(lambda: fleet.draining, message="drain began")
            # while draining with work in flight the listener is still
            # up: new work is SHED and readiness says why
            assert fleet.in_flight >= 1
            try:
                _post(base + "/generate", {"tokens": [7]}, timeout=5)
                raise AssertionError("expected 503 while draining")
            except urllib.error.HTTPError as exc:
                assert exc.code == 503
                assert json.loads(exc.read())["error"]["reason"] == "draining"
            try:
                _get(base + "/.well-known/ready", timeout=5)
                raise AssertionError("expected ready 503 while draining")
            except urllib.error.HTTPError as exc:
                assert exc.code == 503
                assert json.loads(exc.read())["state"] == "draining"

            shutdown_thread.join(30)
            assert not shutdown_thread.is_alive()
            shutdown_done = True
            worker.join(10)
            # the in-flight request FINISHED before the listener died
            status, body, _ = slow_result["resp"]
            assert status == 200
            assert json.loads(body)["data"]["count"] == 100
            counter = app.container.metrics.counter(
                "gofr_tpu_router_shed_total", labels=("reason",)
            )
            assert counter.value(reason="draining") >= 1
        finally:
            if not shutdown_done:
                router_ctx.__exit__(None, None, None)
            else:
                # already shut down; just unwind the contextmanager
                try:
                    router_ctx.__exit__(None, None, None)
                except Exception:
                    pass
    finally:
        fleet_ctx.__exit__(None, None, None)


# -- e2e: affinity -------------------------------------------------------------

def test_affinity_pins_conversation_to_one_replica(tmp_path, monkeypatch):
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(3) as replicas, chaos_router(replicas) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 3,
              message="replicas in rotation")
        headers = {"X-Session-ID": "conversation-7"}
        for _ in range(5):
            status, _, _ = _post(base + "/generate", {"tokens": [1, 2]},
                                 headers=headers)
            assert status == 200
        from gofr_tpu_torch.fleet.router import hash_affinity

        snap = _fleet_snapshot(app)
        # records carry the HASHED key (raw keys can be prompt text)
        pinned = {r["attempts"][0]["replica"] for r in snap["routes"]
                  if r.get("affinity_key") == hash_affinity("conversation-7")}
        assert len(pinned) == 1  # every turn landed on ONE replica
        assert not any(r.get("affinity_key") == "conversation-7"
                       for r in snap["routes"])
        # and the SAME prompt routes by its own prefix without a header
        for _ in range(3):
            _completion(base, [9, 9, 9, 9])
        snap = _fleet_snapshot(app)
        by_prompt = {r["attempts"][0]["replica"] for r in snap["routes"]
                     if r["path"] == "/v1/completions"}
        assert len(by_prompt) == 1


def test_fleet_replicas_on_host_mesh(tmp_path, monkeypatch):
    """Echo replicas booted on TPU_MESH=tp=2 (host-mesh mode: paged block
    tables split over 2 fake devices) serve through the router exactly
    like unsharded ones, and each replica's /admin/engine shows the mesh it
    runs on, as the JAX package's case does."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    mesh_env = {"TPU_MESH": "tp=2", "KV_BLOCKS": "64", "KV_BLOCK_TOKENS": "4"}
    with chaos_fleet(2, env=mesh_env) as replicas, chaos_router(
        replicas, env={"FLEET_PROBE_INTERVAL_S": "0.1"},
    ) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 2,
              message="2 mesh replicas in rotation")
        status, body, _ = _completion(base, [5, 6, 7, 8])
        assert status == 200
        # id-prompt on the tokenizer-less echo runner: tokens came back
        # (text stays empty without a tokenizer — the count is the proof)
        assert json.loads(body)["usage"]["completion_tokens"] == 4
        for r in replicas:
            rstatus, engine, _ = _get(
                f"http://127.0.0.1:{r.port}/admin/engine"
            )
            assert rstatus == 200
            data = json.loads(engine)["data"]
            assert data["mesh"] == {"axes": {"tp": 2}, "devices": 2}
            assert data["kv_blocks"]["total"] == 64
            assert r.app.container.tpu.runner.paged.arena.shards == 2


# -- unit: disaggregated role routing (unit) -------------------------------

def _role_set(roles, logger=None):
    """A ReplicaSet of named replicas with fixed roles, all healthy, no
    prober traffic (probe thread is started by start(), never called)."""
    from gofr_tpu_torch.fleet.replica import Replica, ReplicaSet
    from gofr_tpu.testutil import MockLogger

    logger = logger or MockLogger()
    replicas = []
    for i, role in enumerate(roles):
        replica = Replica(f"r{i}", f"http://127.0.0.1:{20000 + i}", logger)
        replica.role = role
        replicas.append(replica)
    return ReplicaSet(replicas, logger)


def test_candidates_role_tier_includes_mixed_and_empty_tier_is_empty():
    rs = _role_set(["prefill", "decode", "mixed"])
    assert {r.name for r in rs.candidates(role="decode")} == {"r1", "r2"}
    assert {r.name for r in rs.candidates(role="prefill")} == {"r0", "r2"}
    assert {r.name for r in rs.candidates()} == {"r0", "r1", "r2"}
    # an empty tier returns [] — the CALLER degrades, candidates never
    # invents capacity
    only_prefill = _role_set(["prefill", "prefill"])
    assert only_prefill.candidates(role="decode") == []
    # roles compose with exclusion
    assert {r.name for r in rs.candidates(role="decode", exclude={"r1"})} \
        == {"r2"}


def test_classify_role_and_kv_hash_of():
    from gofr_tpu_torch.fleet.kvwire import prompt_hash
    from gofr_tpu_torch.fleet.router import FleetRouter

    classify = FleetRouter._classify_role
    assert classify("/v1/completions") == "decode"
    assert classify("/v1/chat/completions") == "decode"
    assert classify("/generate") == "decode"
    assert classify("/v1/embeddings") == "prefill"
    assert classify("/infer") == "prefill"
    assert classify("/v1/models") is None

    kv_hash = FleetRouter._kv_hash_of
    assert kv_hash({"tokens": [1, 2, 3]}) == prompt_hash([1, 2, 3])
    assert kv_hash({"prompt": [4, 5]}) == prompt_hash([4, 5])
    # text prompts tokenize replica-side: no router-side identity
    assert kv_hash({"prompt": "hello"}) == ""
    assert kv_hash({"prompt": [1, True, 3]}) == ""  # bools are not ids
    assert kv_hash({"prompt": []}) == ""
    assert kv_hash(None) == ""


def test_pick_degrades_from_empty_and_vetoed_tiers():
    """Role config can never make the fleet serve less: an empty tier
    AND a tier whose breakers all veto both fall through to role-free
    selection; only a fleet with nothing admittable returns None."""
    from gofr_tpu_torch.fleet.router import FleetRouter
    from gofr_tpu_torch.metrics import Registry
    from gofr_tpu.testutil import MockLogger

    logger = MockLogger()
    rs = _role_set(["prefill", "decode", "decode"], logger=logger)
    router = FleetRouter(logger, Registry(), rs, QuotaTable(0.0, 0.0))

    picked, _ = router._pick("", set(), role="decode")
    assert picked.role == "decode"  # the tier is preferred when alive

    # every decode breaker open: the prefill replica must still serve
    for name in ("r1", "r2"):
        breaker = rs.by_name(name).breaker
        for _ in range(breaker.failure_threshold):
            breaker.record_failure()
    picked, _ = router._pick("", set(), role="decode")
    assert picked.name == "r0"  # degraded to role-free, not to a 502

    # empty tier (no decode/mixed at all): same degradation
    prefill_only = _role_set(["prefill", "prefill"], logger=logger)
    router2 = FleetRouter(logger, Registry(), prefill_only,
                          QuotaTable(0.0, 0.0))
    picked, _ = router2._pick("", set(), role="decode")
    assert picked.role == "prefill"

    # nothing admittable anywhere: None (the caller 502s/retries)
    for replica in prefill_only.replicas:
        for _ in range(replica.breaker.failure_threshold):
            replica.breaker.record_failure()
    assert router2._pick("", set(), role="decode") is None


def test_kv_donor_picks_the_prefill_replica_by_rendezvous():
    from gofr_tpu_torch.fleet.kvwire import prompt_hash
    from gofr_tpu_torch.fleet.router import FleetRouter
    from gofr_tpu_torch.metrics import Registry
    from gofr_tpu.testutil import MockLogger

    logger = MockLogger()
    rs = _role_set(["prefill", "prefill", "decode"], logger=logger)
    router = FleetRouter(logger, Registry(), rs, QuotaTable(0.0, 0.0))
    kv_hash = prompt_hash([7, 8, 9])
    donor = router._kv_donor(kv_hash)
    assert donor is not None and donor.role == "prefill"
    # deterministic: rendezvous on the hash over the prefill tier only
    expected = affinity_order(kv_hash, ["r0", "r1"])[0]
    assert donor.name == expected
    assert router._kv_donor("") is None
    # a mixed/decode-only fleet has no dedicated donors
    no_prefill = _role_set(["mixed", "decode"], logger=logger)
    router2 = FleetRouter(logger, Registry(), no_prefill,
                          QuotaTable(0.0, 0.0))
    assert router2._kv_donor(kv_hash) is None


def test_explicit_session_key_outranks_kv_hash_affinity():
    """KV-hash rendezvous replaces the prompt-head HEURISTIC only; a
    client that pinned a session keeps its pin."""
    from gofr_tpu_torch.fleet.router import FleetRouter
    from gofr_tpu_torch.http.request import Request

    body = {"tokens": [1, 2, 3]}
    assert not FleetRouter._explicit_affinity(
        Request("POST", "/generate", {}), body)
    assert FleetRouter._explicit_affinity(
        Request("POST", "/generate", {"x-session-id": "conv"}), body)
    assert FleetRouter._explicit_affinity(
        Request("POST", "/generate", {"x-affinity-key": "k"}), body)
    assert FleetRouter._explicit_affinity(
        Request("POST", "/generate", {}), {"user": "alice"})


# -- unit: quota redis outage-window observability -----------------------------

class _FlakyRedis:
    """A chainable pipeline stub with a kill switch — deterministic
    outage windows without racing a real miniredis teardown."""

    def __init__(self):
        self.down = False

    def pipeline(self):
        if self.down:
            raise ConnectionError("redis down")
        return self

    def hget(self, *a):
        return self

    def hset(self, *a):
        return self

    def expire(self, *a):
        return self

    def execute(self):
        if self.down:
            raise ConnectionError("redis down")
        return [None, None]


def test_quota_fail_open_counts_fallbacks_and_logs_once_per_outage():
    """A silent redis outage must be VISIBLE: every fail-open take
    counts on gofr_tpu_router_quota_fallback_total (and the stats
    block), while the log gets ONE line per outage window — not one per
    request — and recovery re-arms the next window's line."""
    from gofr_tpu_torch.metrics import Registry
    from gofr_tpu.testutil import MockLogger

    logger = MockLogger()
    registry = Registry()
    redis = _FlakyRedis()
    table = QuotaTable(rate_rps=100.0, burst=10.0, redis=redis,
                       logger=logger, metrics=registry)
    counter = registry.counter("gofr_tpu_router_quota_fallback_total")
    assert table.take("t")[0] and counter.value() == 0
    assert not table.stats()["redis_down"]

    redis.down = True
    for _ in range(5):
        assert table.take("t")[0]  # fail-open: still admitted
    assert counter.value() == 5
    stats = table.stats()
    assert stats["redis_down"] and stats["fallbacks"] == 5
    assert stats["backend"] == "redis"
    failed_lines = [ln for ln in logger.lines if "failed" in ln]
    assert len(failed_lines) == 1  # once per window, not per request

    redis.down = False
    assert table.take("t")[0]
    assert counter.value() == 5  # recovery takes are not fallbacks
    assert not table.stats()["redis_down"]
    assert any("recovered" in ln for ln in logger.lines)

    # a SECOND outage logs its own first-failure line
    redis.down = True
    assert table.take("t")[0]
    failed_lines = [ln for ln in logger.lines if "failed" in ln]
    assert len(failed_lines) == 2


# -- e2e: disaggregated prefill/decode (acceptance) -------------------

def test_disagg_fleet_corrupt_and_dead_donor_streams_bit_identical(
    tmp_path, monkeypatch
):
    """The acceptance spine: a 1-prefill/2-decode echo fleet behind the
    router. Decode-bound streams carry an X-KV-Donor stamp naming the
    prefill replica; corrupting a KV payload mid-pull AND killing the
    donor mid-pull both yield a COMPLETED, bit-identical client stream
    via local-prefill fallback, every outcome lands on
    gofr_tpu_kv_transfer_total and /admin/fleet, and no BlockPool
    refcount leaks anywhere (all pools balance back to idle)."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(3, per_replica_env=[
        {"FLEET_ROLE": "prefill"},
        {"FLEET_ROLE": "decode"},
        {"FLEET_ROLE": "decode"},
    ], env={"KV_TRANSFER_TIMEOUT_S": "1"}) as replicas, chaos_router(
        replicas,
        # rotation state frozen after the initial probe: the donor must
        # stay "healthy" in the router's view even once its listener is
        # killed, so the hint keeps getting stamped and the RECEIVER's
        # pull (not the prober) discovers the death
        env={"FLEET_PROBE_INTERVAL_S": "30"},
    ) as app:
        donor = replicas[0]
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 3,
              message="3 replicas in rotation")
        # roles ride the /admin/engine scrape, which lands AFTER the
        # rotation entry the _wait above observed (same probe thread,
        # separate HTTP request) — so wait for every replica's role
        _wait(lambda: [fleet.replica_set.by_name(n).role
                       for n in ("r0", "r1", "r2")]
              == ["prefill", "decode", "decode"],
              message="advertised roles scraped")

        def stream_tokens(prompt, base_url=None):
            payload = {"model": "echo", "prompt": prompt, "max_tokens": 6,
                       "stream": True}
            req = urllib.request.Request(
                (base_url or base) + "/v1/completions",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=20) as resp:
                assert resp.status == 200
                tokens, _, raw = _read_sse_tokens(resp)
            assert b"data: [DONE]" in raw  # completed, never truncated
            assert len(tokens) == 6
            return tokens

        def donor_stream(prompt):
            """Clean reference + donor warm-up in one: the donor serves
            (and caches) the prompt itself; echo decoding is
            deterministic across replicas, so its token stream is the
            bit-identity baseline for the fallback streams below."""
            return stream_tokens(prompt, base_url=donor.address)

        def xfer_totals():
            out: dict = {}
            for r in replicas[1:]:
                _, body, _ = _get(f"{r.address}/admin/engine")
                for k, v in json.loads(body)["data"]["kv_transfer"].items():
                    if isinstance(v, int):
                        out[k] = out.get(k, 0) + v
            return out

        # scenario 0, the happy path: a donor-warmed prompt streamed
        # through the router is pulled from the donor (outcome ok)
        prompt0 = list(range(1, 40))
        clean0 = donor_stream(prompt0)
        assert stream_tokens(prompt0) == clean0
        assert xfer_totals()["ok"] >= 1  # the donor stamp was honored

        # scenario 1: payload corrupted mid-pull -> per-block CRC
        # catches it, local-prefill fallback, bit-identical stream.
        # Fresh prompt: the serving decode replica must actually PULL
        # (a locally-warm prompt skips the transfer entirely).
        prompt1 = list(range(100, 140))
        clean1 = donor_stream(prompt1)
        donor.chaos.corrupting_proxy(mode="flip", n=1, after_bytes=280)
        assert stream_tokens(prompt1) == clean1
        assert xfer_totals()["corrupt"] == 1
        assert xfer_totals()["fallback"] == 1

        # scenario 2: donor killed mid-pull — the body ends with no
        # trailer frame, exactly what a dying donor process leaves on
        # the wire -> detected, fallback, bit-identical
        prompt2 = list(range(200, 250))
        clean2 = donor_stream(prompt2)
        donor.chaos.corrupting_proxy(mode="truncate", n=1, after_bytes=80)
        assert stream_tokens(prompt2) == clean2
        assert xfer_totals()["corrupt"] == 2

        # scenario 3: donor wedged mid-pull (drip-feeding past the
        # budget) -> timeout, fallback, bit-identical
        prompt3 = list(range(300, 340))
        clean3 = donor_stream(prompt3)
        donor.chaos.corrupting_proxy(mode="stall", n=1, after_bytes=50,
                                     stall_s=4.0)
        assert stream_tokens(prompt3) == clean3
        assert xfer_totals()["timeout"] == 1

        # scenario 4: the donor is GONE entirely (listener down, the
        # router still believes in it) -> refused pull, fallback
        donor.stop_listener()
        prompt4 = list(range(400, 440))
        stream_tokens(prompt4)
        assert xfer_totals()["timeout"] == 2
        donor.start_listener()

        # route records carry the disagg evidence
        snap = _fleet_snapshot(app)
        routes = [r for r in snap["routes"]
                  if r["path"] == "/v1/completions"]
        assert routes and all(r["role"] == "decode" for r in routes)
        assert any(r["kv_donor"] == "r0" for r in routes)
        # decode work landed on the decode tier while it was healthy
        for r in routes:
            assert r["attempts"][-1]["replica"] in ("r1", "r2")
        # /admin/fleet surfaces each replica's role + transfer ledger
        by_name = {r["name"]: r for r in snap["replica_set"]["replicas"]}
        assert by_name["r0"]["role"] == "prefill"
        _wait(lambda: (
            (_fleet_snapshot(app)["replica_set"]["replicas"][1].get("engine")
             or {}).get("kv_transfer") is not None
        ), timeout=5, message="kv_transfer ledger scraped onto /admin/fleet")

        # every outcome visible, fleet-wide
        merged = xfer_totals()
        assert merged["corrupt"] == 2 and merged["timeout"] == 2
        assert merged["fallback"] == 4 and merged["ok"] >= 1

        # zero refcount leaks fleet-wide: every pool balances to idle
        for r in replicas:
            _, body, _ = _get(f"{r.address}/admin/engine")
            kv = json.loads(body)["data"]["kv_blocks"]
            assert kv["active"] == 0 and kv["reserved"] == 0, r.name


def test_role_routing_off_restores_mixed_behavior(tmp_path, monkeypatch):
    """FLEET_ROLE_ROUTING=off: advertised roles are ignored, no donor
    stamps, routing is exactly the pre-disaggregation fleet."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(2, per_replica_env=[
        {"FLEET_ROLE": "prefill"}, {"FLEET_ROLE": "decode"},
    ]) as replicas, chaos_router(
        replicas, env={"FLEET_ROLE_ROUTING": "off"},
    ) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        assert fleet.role_routing is False
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 2,
              message="2 replicas in rotation")
        status, _, _ = _completion(base, [1, 2, 3])
        assert status == 200
        snap = _fleet_snapshot(app)
        route = snap["routes"][0]
        assert route["role"] is None and route["kv_donor"] is None
        assert snap["role_routing"] is False


# -- fleet-scale hardening ------------------------------------------

def test_token_bucket_exact_accounting_under_concurrency():
    """Many threads, ONE tenant: the memory-mode bucket admits EXACTLY
    its capacity — no over-admission from racing read-modify-writes, no
    lost tokens from double refills. Refill is negligible over the test
    window (0.001 rps), so capacity is the whole supply and the count
    is exact, not approximate."""
    table = QuotaTable(rate_rps=0.001, burst=48.0)
    n_threads, per_thread = 16, 25
    barrier = threading.Barrier(n_threads)
    admitted = [0] * n_threads
    denied = [0] * n_threads

    def worker(w):
        barrier.wait()
        for _ in range(per_thread):
            ok, retry_after = table.take("hot")
            if ok:
                admitted[w] += 1
            else:
                assert retry_after > 0
                denied[w] += 1

    threads = [
        threading.Thread(target=worker, args=(w,), name=f"test-quota-{w}")
        for w in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(15)
    assert sum(admitted) == 48
    assert sum(admitted) + sum(denied) == n_threads * per_thread
    stats = table.stats()
    assert stats["admitted"] == 48
    assert stats["denied"] == n_threads * per_thread - 48


def test_quota_lease_cache_serves_hot_tenant_locally():
    """The hot-key fix: with ``cache_ttl_s`` > 0 a hot tenant's takes
    are served from a local token lease, not one redis sync each —
    every take is either a cache hit or a sync, and syncs are rare."""
    from gofr_tpu_torch.devtools.fleetsim import SimRedis

    redis = SimRedis()
    table = QuotaTable(rate_rps=200.0, burst=400.0, redis=redis,
                       cache_ttl_s=0.5)
    for _ in range(100):
        assert table.take("hot")[0]
    stats = table.stats()
    assert stats["cache_hits"] + stats["redis_syncs"] == 100
    assert stats["redis_syncs"] <= 5  # ~1 sync per lease of ~100 tokens
    # each sync is one read + one write pipeline round trip
    assert redis.execs == 2 * stats["redis_syncs"]


def test_quota_lease_leases_at_least_one_token_at_low_rates():
    """``rate * ttl`` < 1 must still lease a WHOLE token: a fractional
    lease can never admit, which silently disables the cache at
    realistic per-tenant rates (the first live fleetsim runs measured
    zero cache hits for exactly this reason)."""
    from gofr_tpu_torch.devtools.fleetsim import SimRedis

    redis = SimRedis()
    table = QuotaTable(rate_rps=2.0, burst=8.0, redis=redis,
                       cache_ttl_s=0.05)
    assert table._lease_target() == 1.0  # max(1, 2*0.05), capped burst/2
    assert table.take("t")[0]  # sync: admits AND leases one token
    assert table.take("t")[0]  # served from the lease, no redis trip
    stats = table.stats()
    assert stats["cache_hits"] == 1 and stats["redis_syncs"] == 1
    # the hoard cap gets the SAME ≥1 floor: a sub-2.0 burst must not
    # clamp the lease back under one token and silently re-disable the
    # cache (min(1.0, burst/2) with burst 1.0 was exactly that hole)
    tiny = QuotaTable(rate_rps=0.5, burst=0.0, redis=SimRedis(),
                      cache_ttl_s=0.05)
    assert tiny.burst == 1.0  # the burst<=0 default: max(1, 2*rate)
    assert tiny._lease_target() == 1.0


def test_quota_lease_concurrent_sync_merges_instead_of_stranding():
    """Two syncs for the same tenant can race (lease expired, many
    workers): each debits a lease batch from the shared redis bucket,
    so the second install must MERGE the first's unused tokens, not
    overwrite them — an overwritten lease's tokens were debited in
    redis, never admitted, never credited: gone. Conservation is the
    assertion: bucket + live lease + admitted == burst, exactly."""
    from gofr_tpu_torch.devtools.fleetsim import SimRedis

    redis = SimRedis()
    table = QuotaTable(rate_rps=100.0, burst=200.0, redis=redis,
                       cache_ttl_s=0.5)
    assert table.take("t")[0]   # sync 1: debits 1 + leases 50
    first_lease = table._leases["t"].tokens
    assert table._take_redis("t")[0]  # a racing sync: debits 1 + 50 more
    merged = table._leases["t"].tokens
    assert merged >= first_lease + 1.0  # both batches live, none stranded
    stored = float(redis.hashes["fleet:quota:t"]["tokens"])
    # refill over the test's microseconds is < 1 token
    assert stored + merged + 2.0 == pytest.approx(200.0, abs=1.0)


def test_quota_lease_caches_denial_with_counted_down_hint():
    """A denied sync caches the DENIAL for the TTL window too (a
    hammering tenant must not buy a redis trip per rejected request),
    and the cached Retry-After counts down as the window ages instead
    of re-serving the sync-time value."""
    from gofr_tpu_torch.devtools.fleetsim import SimRedis

    redis = SimRedis()
    table = QuotaTable(rate_rps=0.5, burst=1.0, redis=redis,
                       cache_ttl_s=5.0)
    assert table.take("t")[0]  # burns the only token
    ok2, retry2 = table.take("t")  # sync: denied, denial cached
    assert not ok2 and retry2 > 0
    execs_after_denial = redis.execs
    ok3, retry3 = table.take("t")  # cached denial: no redis trip
    assert not ok3 and 0 < retry3 <= retry2
    assert redis.execs == execs_after_denial
    assert table.stats()["cache_hits"] >= 1


def test_quota_no_phantom_lease_when_redis_dies_mid_sync():
    """Redis failing BETWEEN the read and the write pipeline (exactly
    what the fleetsim redis-outage scenario injects mid-run) must not
    leave a local lease behind: its tokens were never debited
    fleet-wide, so a whole TTL window would admit from tokens every
    other router can also spend. The verdict must be fail-open (memory
    bucket), with no lease and the popped credit restored."""
    from gofr_tpu_torch.devtools.fleetsim import SimRedis

    class _DiesOnWrite(SimRedis):
        def __init__(self):
            super().__init__()
            self.fail_after = None

        def pipeline(self):
            if self.fail_after is not None:
                if self.fail_after <= 0:
                    raise ConnectionError("injected mid-sync outage")
                self.fail_after -= 1
            return super().pipeline()

    redis = _DiesOnWrite()
    table = QuotaTable(rate_rps=100.0, burst=200.0, redis=redis,
                       cache_ttl_s=0.5)
    table._credit["t"] = 7.0  # pending give-back from an expired lease
    redis.fail_after = 1  # the read pipeline builds; the write raises
    ok, _ = table.take("t")
    assert ok  # failed open to the memory bucket
    assert "t" not in table._leases  # no phantom tokens
    assert table._credit["t"] == 7.0  # the give-back survived, once
    redis.fail_after = None
    assert table.take("t")[0]  # recovery: a real sync with a real lease
    assert table._leases["t"].tokens > 0
    assert "t" not in table._credit  # credit consumed exactly once


def test_quota_lease_expiry_credits_unused_tokens_back():
    """Leased-but-unused tokens return to the fleet-wide bucket on the
    tenant's next sync: the accounting error is bounded by one lease
    per router per TTL window, never cumulative."""
    from gofr_tpu_torch.devtools.fleetsim import SimRedis

    redis = SimRedis()
    table = QuotaTable(rate_rps=100.0, burst=200.0, redis=redis,
                       cache_ttl_s=0.5)
    assert table.take("t")[0]  # sync: debits 1, leases 50 (rate*ttl)
    lease = table._leases["t"]
    assert lease.tokens >= 1.0
    lease.expires = 0.0  # force expiry (monotonic 0 = the distant past)
    assert table.take("t")[0]  # expiry -> credit -> sync gives it back
    stored = float(redis.hashes["fleet:quota:t"]["tokens"])
    new_lease = table._leases["t"].tokens
    # bucket contents = burst - 2 takes - the live lease; the expired
    # lease's 50 unused tokens came BACK (without the credit this would
    # sit ~50 lower). Refill noise over the test's microseconds < 1.
    assert stored == pytest.approx(200.0 - 2.0 - new_lease, abs=1.0)


def test_route_records_and_outstanding_survive_concurrent_load(
        tmp_path, monkeypatch):
    """Satellite: the route-record ring and the outstanding/in-flight
    bookkeeping under genuinely concurrent traffic, with a concurrent
    snapshot reader hammering the ring the whole time. The fleet-chaos
    CI job runs this module with GOFR_SANITIZE=1, so a lock-order
    inversion or an over-held lock inside the selection/record path is
    a FAILURE here, not a warning. Exactness: every request leaves
    exactly one intact record, and every depth counter drains to 0."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    with chaos_fleet(2) as replicas, chaos_router(replicas) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 2,
              message="2 replicas in rotation")
        n_threads, per_thread = 12, 6
        errors: list = []
        snap_stop = threading.Event()

        def snapshotter():
            while not snap_stop.is_set():
                snap = fleet.snapshot()
                assert isinstance(snap["routes"], list)
                time.sleep(0.002)

        def client(w):
            for i in range(per_thread):
                try:
                    status, body, _ = _post(
                        base + "/generate",
                        {"tokens": [w + 1, i + 1], "max_new_tokens": 3},
                        headers={"X-Session-ID": f"s{w}-{i}"}, timeout=20,
                    )
                    assert status == 200
                except Exception as exc:  # collected, asserted below
                    errors.append(exc)

        snap_thread = threading.Thread(
            target=snapshotter, name="test-fleet-snap")
        threads = [
            threading.Thread(target=client, args=(w,), name=f"test-load-{w}")
            for w in range(n_threads)
        ]
        snap_thread.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        snap_stop.set()
        snap_thread.join(10)
        assert not errors
        _wait(lambda: fleet.in_flight == 0, message="in-flight drained")
        for r in fleet.replica_set.replicas:
            assert r.outstanding == 0, r.name
        records = fleet.records(limit=1024)  # the admin page shows 50
        oks = [r for r in records if r["outcome"] == "ok"]
        assert len(oks) == n_threads * per_thread
        for rec in oks:
            assert rec["attempts"] and rec["attempts"][-1]["status"] == 200


def test_stream_dead_before_first_frame_resumes_from_zero(
        tmp_path, monkeypatch):
    """A stream that dies before ANY event reaches the client used to
    get its resume REFUSED (the relay required seen event ids), so
    every wedge-before-first-token became a truncated client stream —
    the fleetsim harness surfaced the whole cohort. Resuming from 0 is
    trivially safe when nothing was delivered: the relay now hunts, and
    the client sees one complete, token-exact stream."""
    from gofr_tpu_torch.devtools.chaos import chaos_fleet, chaos_router

    monkeypatch.chdir(tmp_path)
    prompt, n_tokens = [3, 5, 7], 12
    expected = [prompt[i % 3] for i in range(n_tokens)]
    with chaos_fleet(2) as replicas, chaos_router(replicas) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 2,
              message="2 replicas in rotation")
        victim = replicas[0]
        key = _key_for(victim.name, [r.name for r in replicas])
        # one-shot: the next streamed response dies after ZERO chunks
        # (headers sent, zero SSE frames — the pre-first-token wedge)
        victim.chaos.arm("disconnect_after", chunks=0, remaining=1,
                         paths=("/v1/",))
        req = urllib.request.Request(
            base + "/v1/completions",
            data=json.dumps({
                "model": "echo", "prompt": prompt, "max_tokens": n_tokens,
                "stream": True, "seed": 5,
            }).encode(),
            headers={"Content-Type": "application/json",
                     "X-Session-ID": key},
            method="POST",
        )
        resp = urllib.request.urlopen(req, timeout=30)
        assert resp.status == 200
        tokens, ids, raw = _read_sse_tokens(resp)
        assert b"data: [DONE]" in raw  # completed, not truncated
        assert tokens == expected  # zero missing, zero duplicated
        assert ids and ids[0] == 0  # the splice really started at zero
        snap = _fleet_snapshot(app)
        resumed = [r for r in snap["routes"] if r.get("resumes")]
        assert resumed, snap["routes"]
        assert resumed[0]["attempts"][-1]["resume_from"] == 0
        _, metrics_body, _ = _get(base + "/metrics")
        assert ('gofr_tpu_router_stream_resumes_total{outcome="resumed"}'
                in metrics_body.decode())


# -- the router's remaining-budget forwarding (test_deadline.py's router legs)

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture()
def budget_fleet(tmp_path, monkeypatch):
    """Two device-free replicas that RECORD the deadline header they
    receive — each 503s its first request (forcing a retry), then serves.
    Fronted by a real FleetRouter."""
    import gofr_tpu_torch
    from gofr_tpu_torch.devtools.chaos import _env_overrides, chaos_router
    from gofr_tpu_torch.errors import HTTPError
    from gofr_tpu_torch.http.response import Raw

    monkeypatch.chdir(tmp_path)
    seen: dict[str, list] = {"r0": [], "r1": []}
    fail_first = {"r0": True, "r1": True}

    def make_handler(name):
        def handler(ctx):
            seen[name].append(ctx.request.header("X-Request-Deadline-Ms"))
            if fail_first.get(name):
                fail_first[name] = False
                time.sleep(0.2)  # burn visible budget before failing
                raise HTTPError(503, "warming up")
            return Raw({"served_by": name})
        return handler

    class _Stub:
        def __init__(self, name, port):
            self.name = name
            self.port = port
            self.address = f"http://127.0.0.1:{port}"

    apps, replicas = [], []
    for name in ("r0", "r1"):
        port = _free_port()
        with _env_overrides({
            "HTTP_PORT": str(port), "LOG_LEVEL": "FATAL",
            "MODEL_NAME": None, "TPU_ENABLED": None, "TIMEBASE_ENABLED": "off",
        }):
            app = gofr_tpu_torch.new()
            app.post("/v1/completions", make_handler(name))
            app.start()
        apps.append(app)
        replicas.append(_Stub(name, port))
    try:
        with chaos_router(replicas, env={
            "FLEET_RETRIES": "2", "FLEET_DEADLINE_S": "30", "FLEET_AFFINITY": "off",
        }) as router_app:
            fleet = router_app.container.fleet
            _wait(lambda: len(fleet.replica_set.in_rotation()) == 2,
                  message="2 replicas in rotation")
            yield f"http://127.0.0.1:{router_app.http_server.port}", seen
    finally:
        for app in apps:
            app.shutdown()


def test_router_forwards_remaining_budget_across_retry(budget_fleet):
    """The second attempt must see a SMALLER X-Request-Deadline-Ms than
    the first (the failed attempt's elapsed time is subtracted), and both
    must be bounded by the client's own budget."""
    base, seen = budget_fleet
    status, _, _ = _post(base + "/v1/completions", {"prompt": [1], "max_tokens": 1},
                         headers={"X-Request-Deadline-Ms": "5000"})
    assert status == 200
    budgets = [int(v) for v in seen["r0"] + seen["r1"] if v]
    assert len(budgets) >= 2, seen
    first, second = budgets[0], budgets[-1]
    assert first <= 5000  # capped at the client's budget
    # the failed attempt slept 200 ms before 503ing: the retry's forwarded
    # budget must be visibly smaller
    assert second <= first - 150, (first, second)
    assert second >= 1  # floored per attempt, never zero or negative


def test_router_never_mints_a_deadline(budget_fleet):
    """No deadline header, and an explicit ``0`` opt-out, reach the
    replica untouched: the router re-stamps only budgets the client set
    (FLEET_DEADLINE_S bounds the router's own forwarding, never the
    engine's)."""
    base, seen = budget_fleet
    status, _, _ = _post(base + "/v1/completions", {"prompt": [1], "max_tokens": 1})
    assert status == 200
    assert seen["r0"] + seen["r1"], seen
    assert all(not v for v in seen["r0"] + seen["r1"]), seen
    status, _, _ = _post(base + "/v1/completions", {"prompt": [1], "max_tokens": 1},
                         headers={"X-Request-Deadline-Ms": "0"})
    assert status == 200
    stamped = [v for v in seen["r0"] + seen["r1"] if v]
    assert stamped and all(v == "0" for v in stamped), seen


# -- parity with the JAX package: helpers and state machines -----------------

class _FakeTime:
    """One injected clock for both packages' ``time`` module reads."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return self.now

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.now += s


def _both(name):
    import importlib

    return importlib.import_module(f"gofr_tpu.fleet.{name}"), importlib.import_module(
        f"gofr_tpu_torch.fleet.{name}")


def test_affinity_helpers_agree_with_jax():
    """affinity_order, hash_affinity and affinity_key_of give the JAX
    package's answers on the same inputs (seeded names, keys, bodies)."""
    import random

    from gofr_tpu.http.request import Request as JaxRequest
    from gofr_tpu_torch.http.request import Request

    jrep, prep = _both("replica")
    jrouter, prouter = _both("router")
    rng = random.Random(14)
    for _ in range(50):
        names = [f"r{i}" for i in rng.sample(range(40), rng.randint(1, 9))]
        key = "".join(rng.choice("abcxyz0123 ") for _ in range(rng.randint(0, 40)))
        assert prep.affinity_order(key, names) == jrep.affinity_order(key, names)
        assert prouter.hash_affinity(key) == jrouter.hash_affinity(key)
    bodies = [
        {"prompt": [5, 6, 7] * 20}, {"prompt": "once upon a time " * 12},
        {"user": "u-7", "prompt": "x"},
        {"messages": [{"role": "system", "content": "be brief"},
                      {"role": "user", "content": "hi there"}]},
        {"messages": [{"role": "system", "content": "only system"}]},
        {}, None, [1, 2],
    ]
    for headers in ({}, {"x-session-id": "sess-1"}, {"x-affinity-key": "aff-9"}):
        for body in bodies:
            assert prouter.affinity_key_of(Request("POST", "/", dict(headers)), body) == \
                jrouter.affinity_key_of(JaxRequest("POST", "/", dict(headers)), body)


def test_breaker_transitions_agree_with_jax(monkeypatch):
    """One scripted event sequence under one fake clock: both packages'
    breakers walk the same transitions and grant the same acquires."""
    jb, pb = _both("breaker")
    clock = _FakeTime()
    monkeypatch.setattr(jb, "time", clock)
    monkeypatch.setattr(pb, "time", clock)
    script = ("fail", "fail", "acq", "fail", "acq", "tick", "acq", "acq", "ok_probe",
              "fail", "fail", "fail", "acq", "tick", "acq", "fail", "acq", "tick", "acq",
              "ok", "ok_probe", "acq")
    runs = []
    for mod in (jb, pb):
        seen = []
        breaker = mod.CircuitBreaker(failure_threshold=3, cooldown_s=2.0,
                                     on_transition=lambda a, b: seen.append((a, b)))
        clock.now = 1000.0
        out = []
        for step in script:
            if step == "fail":
                breaker.record_failure()
            elif step == "ok":
                breaker.record_success()
            elif step == "ok_probe":
                breaker.record_success(probe=True)
            elif step == "tick":
                clock.now += 2.5
            else:
                out.append(repr(breaker.try_acquire()))
            out.append(breaker.state)
        runs.append((out, seen, breaker.snapshot()))
    assert runs[0] == runs[1]
    assert ("open", "half_open") in runs[1][1] and ("half_open", "closed") in runs[1][1]


def test_quota_decisions_agree_with_jax(monkeypatch):
    """TokenBucket and QuotaTable (memory and redis-backed with its lease
    cache) admit and shed the same requests with the same Retry-After
    under one fake clock."""
    from gofr_tpu.devtools.fleetsim import SimRedis as JaxSimRedis
    from gofr_tpu_torch.devtools.fleetsim import SimRedis

    ja, pa = _both("admission")
    clock = _FakeTime()
    monkeypatch.setattr(ja, "time", clock)
    monkeypatch.setattr(pa, "time", clock)
    runs = []
    for mod in (ja, pa):
        clock.now = 1000.0
        bucket = mod.TokenBucket(rate=2.0, capacity=3.0)
        mem = mod.QuotaTable(rate_rps=1.0, burst=2.0)
        redis = JaxSimRedis() if mod is ja else SimRedis()
        shared = mod.QuotaTable(rate_rps=5.0, burst=4.0, redis=redis, cache_ttl_s=0.05)
        out = []
        for i in range(40):
            clock.now += 0.13 if i % 3 else 0.01
            out.append(bucket.take())
            out.append(mem.take(f"t{i % 2}"))
            out.append(shared.take("hot"))
        out.append(mem.stats())
        out.append({k: v for k, v in shared.stats().items() if k != "lease"})
        runs.append(out)
    assert runs[0] == runs[1]


def test_probe_delays_agree_with_jax():
    """The probe scheduler draws the same delay sequence from one seeded
    random.Random (initial spread, then jittered rounds; jitter 0 is the
    synchronized sweep)."""
    import random

    from gofr_tpu.testutil import MockLogger

    jrep, prep = _both("replica")
    for jitter in (0.0, 0.2, 0.5):
        seqs = []
        for mod in (jrep, prep):
            rs = mod.ReplicaSet([], MockLogger(), probe_interval_s=0.5, probe_jitter=jitter)
            rng = random.Random("gofr-probe-jitter|r0")
            seqs.append([rs.next_probe_delays(rng, initial=True)]
                        + [rs.next_probe_delays(rng) for _ in range(20)])
        assert seqs[0] == seqs[1]


# -- mixed fleets: a JAX router before port replicas, and the reverse --------

def _mixed_requests(base):
    """The same requests through one router, each tenant its own
    credential: unary and streamed completions, a tenant's second request
    shed by its quota, and a malformed request's 4xx."""
    import urllib.error

    def call(payload, headers):
        try:
            status, body, hdrs = _post(base + "/v1/completions", payload, headers=headers)
        except urllib.error.HTTPError as err:
            status, body, hdrs = err.code, err.read(), dict(err.headers.items())
        return status, body, hdrs

    out = []
    for i, (payload, headers) in enumerate((
        ({"model": "echo", "prompt": [3, 1, 4, 1, 5], "max_tokens": 6}, {"Authorization": "a"}),
        ({"model": "echo", "prompt": [9, 2, 6], "max_tokens": 4, "stream": True},
         {"Authorization": "b"}),
        ({"model": "echo", "prompt": [7, 7], "max_tokens": 3}, {"Authorization": "Bearer q"}),
        ({"model": "echo", "prompt": [7, 7], "max_tokens": 3}, {"Authorization": "Bearer q"}),
        ({"model": "echo", "prompt": [8], "max_tokens": 2, "tools": [{"type": "function"}]},
         {"Authorization": "c"}),
    )):
        headers = dict(headers, **{"X-Request-ID": f"mixed-{i}"})
        status, body, hdrs = call(payload, headers)
        if body.startswith(b"{"):
            doc = json.loads(body)
            for field in ("id", "created"):
                doc.pop(field, None)
            if "retry_after_s" in doc.get("error", {}):
                # the bucket's refill hint reads the clock
                doc["error"]["retry_after_s"] = doc["error"]["retry_after_s"] > 0
            body = doc
        else:
            # SSE: the frames' data without their per-response ids
            frames = []
            for line in body.decode().splitlines():
                if line.startswith("data: ") and line != "data: [DONE]":
                    frame = json.loads(line[6:])
                    frame.pop("id", None)
                    frame.pop("created", None)
                    frames.append(frame)
            body = frames
        out.append((status, body, hdrs.get("X-Gofr-Request-Id"), hdrs.get("Retry-After")))
    return out


@pytest.mark.parametrize("router_pkg,replica_pkg", [
    ("gofr_tpu", "gofr_tpu"), ("gofr_tpu", "gofr_tpu_torch"), ("gofr_tpu_torch", "gofr_tpu"),
    ("gofr_tpu_torch", "gofr_tpu_torch"),
])
def test_mixed_fleet_answers_like_an_all_jax_fleet(router_pkg, replica_pkg, tmp_path,
                                                   monkeypatch):
    """A JAX router before port echo replicas, a port router before JAX
    ones, and an all-port fleet give the all-JAX fleet's statuses, bodies
    and fleet headers (X-Gofr-Request-Id, Retry-After) for the same
    requests."""
    import importlib

    monkeypatch.chdir(tmp_path)
    results = {}
    for routers, replicas in ((router_pkg, replica_pkg), ("gofr_tpu", "gofr_tpu")):
        rchaos = importlib.import_module(f"{routers}.devtools.chaos")
        pchaos = importlib.import_module(f"{replicas}.devtools.chaos")
        with pchaos.chaos_fleet(2) as reps, rchaos.chaos_router(reps, env={
            "FLEET_QUOTA_RPS": "0.01", "FLEET_QUOTA_BURST": "1",
        }) as app:
            fleet = app.container.fleet
            _wait(lambda: len(fleet.replica_set.in_rotation()) == 2,
                  message="2 replicas in rotation")
            results[(routers, replicas)] = _mixed_requests(f"http://127.0.0.1:{app.http_port}")
    got, want = results[(router_pkg, replica_pkg)], results[("gofr_tpu", "gofr_tpu")]
    assert got == want
    assert [r[0] for r in want] == [200, 200, 200, 429, 400]
