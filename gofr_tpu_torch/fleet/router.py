"""The fleet front door: health-aware routing, resilient forwarding,
admission control, and graceful drain — one :class:`FleetRouter` object
wired onto a plain gofr app (``gofr_tpu_torch.fleet.wire_fleet``).

Request path, in order:

1. **Admission** — draining? 503. Tenant over quota? 429 +
   ``Retry-After`` (exact token-refill time). Router at its in-flight
   cap, or every in-rotation replica reporting KV/queue saturation
   (the replica's ``pool_reject``/``kv_exhausted`` signals, scraped by
   the prober)? 429 + ``Retry-After`` — the queue is bounded by
   construction, overload is always an explicit signal upstream.
2. **Selection** — in-rotation replicas only (prober state machine),
   prefix-affinity first (rendezvous hash on the conversation key, so
   a follow-up turn lands on the replica holding its paged-KV prefix
   blocks), then least-outstanding with a rotating tie-break; the
   per-replica circuit breaker gets the final veto.
3. **Forwarding** — per-request deadline budget across attempts;
   bounded retries with decorrelated-jitter backoff for failures that
   produced no client-visible bytes (connect errors always; read
   timeouts and 5xx for requests not yet streamed); streaming requests
   pass SSE chunks through. DETERMINISTIC streams (an explicit seed,
   or temperature 0) stay recoverable even after bytes flowed: the
   router journals the last SSE event id it delivered
   (:class:`_StreamRelay`), and a mid-stream upstream failure — a
   dropped connection, a read timeout, or the replica's own error
   frame when its engine wedges — retries/fails over with
   ``X-Resume-From: <next id>`` and splices the continuation into the
   SAME client response, filtering by event id so the client sees zero
   missing and zero duplicated tokens. Non-deterministic streams keep
   the old contract (abort truncated).
4. **Accounting** — every decision rides the existing telemetry:
   ``gofr_tpu_router_*`` metrics, a bounded ring of per-request route
   records (the flight-recorder idiom one layer up), and the
   ``GET /admin/fleet`` snapshot.
"""

from __future__ import annotations

import json
import secrets
import threading
import time
from collections import deque
from typing import Any, Optional

from gofr_tpu_torch.fleet import breaker as breaker_mod
from gofr_tpu_torch.fleet.admission import QuotaTable, tenant_of
from gofr_tpu_torch.fleet.replica import (
    HEALTHY,
    PROBATION,
    STATE_VALUES,
    ReplicaSet,
    affinity_order,
)
from gofr_tpu_torch.http.response import Response
from gofr_tpu_torch.service import ServiceCallError, _encode_query, backoff_delays
from gofr_tpu_torch.telemetry import format_hop, sanitize_request_id
from gofr_tpu_torch.tracing import current_span

_JSON = "application/json"


def mint_request_id() -> str:
    """A fresh fleet-wide request id (the router mints one when the
    client supplied none, or supplied garbage)."""
    return "req-" + secrets.token_hex(8)


class _ResumeSpec:
    """Everything a stream relay needs to re-issue its request on a
    failover: the wire request (method/target/headers/body), the
    absolute deadline, and the affinity key for candidate ordering."""

    __slots__ = ("method", "target", "headers", "body", "deadline",
                 "affinity", "budgeted")

    def __init__(self, method: str, target: str, headers: dict[str, str],
                 body: Any, deadline: float, affinity: str,
                 budgeted: bool = False):
        self.method = method
        self.target = target
        self.headers = headers
        self.body = body
        self.deadline = deadline
        self.affinity = affinity
        # True only when the CLIENT set a positive deadline: a
        # continuation re-stamps the remaining budget iff the original
        # attempt did (an opted-out stream must stay opted out)
        self.budgeted = budgeted

# request headers forwarded to the replica (hop-by-hop and router-local
# headers are stripped; the service client adds its own traceparent /
# correlation id so the replica's spans join the router's trace).
# x-priority forwards VERBATIM (the replica's brownout controller sheds
# by tier). x-request-deadline-ms also forwards verbatim by DEFAULT —
# an absent header, an explicit "0" opt-out, and a malformed value all
# reach the replica untouched (the 400 for garbage is the replica's to
# give) — but when the client set a positive budget, _forward OVERWRITES
# it per attempt with the REMAINING budget, so a retried hop never
# hands a replica more time than the client has left.
_FORWARD_HEADERS = (
    "content-type", "accept", "authorization", "x-tenant",
    "x-session-id", "x-affinity-key", "user-agent", "x-forwarded-for",
    "x-priority", "x-request-deadline-ms",
)
# response headers forwarded back to the client
_RETURN_HEADERS = ("content-type", "retry-after", "x-request-id")


def hash_affinity(key: str) -> str:
    """The display form of an affinity key: route records and
    ``/admin/fleet`` must never carry the raw key, which can be the
    user's prompt text."""
    import hashlib

    return "aff-" + hashlib.sha256(key.encode("utf-8")).hexdigest()[:16]


def affinity_key_of(request: Any, body: Any) -> str:
    """The conversation/prefix key a request routes by: explicit
    ``X-Session-ID``/``X-Affinity-Key`` header first, then the OpenAI
    ``user`` field, else the conversation prefix itself (first user
    message / prompt head) — the same bytes the replica's prefix cache
    keys on."""
    key = request.header("X-Session-ID") or request.header("X-Affinity-Key")
    if key:
        return key
    if not isinstance(body, dict):
        return ""
    user = body.get("user")
    if isinstance(user, str) and user:
        return user
    messages = body.get("messages")
    if isinstance(messages, list) and messages:
        # the first USER message, not messages[0]: chat traffic shares
        # its system prompt, and keying on it would rendezvous the
        # whole fleet's load onto one replica
        for message in messages:
            if (isinstance(message, dict)
                    and message.get("role") == "user"
                    and isinstance(message.get("content"), str)
                    and message["content"]):
                return message["content"][:128]
        first = messages[0]
        if isinstance(first, dict) and isinstance(first.get("content"), str):
            return first["content"][:128]
    prompt = body.get("prompt")
    if isinstance(prompt, str) and prompt:
        return prompt[:128]
    if isinstance(prompt, list) and prompt:
        # token-id prompts key on their head, same as the prefix cache
        return ",".join(str(t) for t in prompt[:32])
    return ""


class FleetRouter:
    def __init__(
        self,
        logger: Any,
        metrics: Any,
        replica_set: ReplicaSet,
        quota: QuotaTable,
        retries: int = 2,
        deadline_s: float = 30.0,
        connect_timeout_s: float = 2.0,
        read_timeout_s: float = 30.0,
        max_inflight: int = 256,
        retry_after_s: float = 1.0,
        record_capacity: int = 256,
        router_id: str = "",
    ):
        self.logger = logger
        self.metrics = metrics
        self.replica_set = replica_set
        self.quota = quota
        self.retries = retries
        self.deadline_s = deadline_s
        self.connect_timeout_s = connect_timeout_s
        self.read_timeout_s = read_timeout_s
        self.max_inflight = max_inflight
        self.retry_after_s = retry_after_s
        # router HA (no single point of failure): N router processes run
        # side by side over the same FLEET_REPLICAS. The router's state
        # is shardable by construction — quota is redis-backed (shared,
        # with per-instance short-TTL leases), affinity/KV-locality is
        # stateless rendezvous hashing (every router picks the same
        # replica), and the rest is EXPLICITLY per-instance: the
        # in-flight cap bounds THIS process (N routers = N * cap), the
        # route-record ring, breaker verdicts, and prober state are this
        # instance's local view, and a stream relay lives and dies with
        # the connection it serves (a router death mid-stream is the
        # CLIENT's retry — deterministic streams replay bit-identically
        # through any sibling). router_id (FLEET_ROUTER_ID, defaulting
        # to the process boot id) labels /admin/fleet so operators can
        # tell N instances apart.
        from gofr_tpu_torch.telemetry import BOOT_ID

        self.router_id = router_id or f"router-{BOOT_ID}"
        # resumable streams: journal delivered SSE event ids and splice
        # a failover continuation into a broken deterministic stream
        # instead of truncating (FLEET_RESUME / FLEET_MAX_RESUMES —
        # wire_fleet sets both post-construction, like affinity)
        self.resume_enabled = True
        self.max_resumes = 4
        self.affinity_enabled = True
        # disaggregated prefill/decode (FLEET_ROLE_ROUTING): route
        # prefill-heavy work to prefill-tier replicas and decodes to
        # decode-tier ones, with KV-locality (prompt-hash rendezvous)
        # beating plain prefix affinity, and stamp X-KV-Donor with the
        # prefill replica that rendezvous-owns the prompt's KV. Every
        # tier decision DEGRADES to mixed routing when the tier is
        # empty or its breakers veto — role config can never make the
        # fleet serve less than it does without it.
        self.role_routing = True
        self.trust_tenant_header = False  # FLEET_TRUST_TENANT_HEADER
        # the container's bounded per-tenant usage sketch (wire_fleet
        # sets it post-construction, like the flags above): the router
        # meters its own admissions and shed verdicts per tenant
        self.tenants: Optional[Any] = None
        self._records: deque = deque(maxlen=record_capacity)
        self._records_lock = threading.Lock()
        self._inflight = 0
        self._idle = threading.Condition()
        self._draining = False
        self._init_metrics()
        self._wire_hooks()

    # -- metrics ---------------------------------------------------------------
    def _init_metrics(self) -> None:
        m = self.metrics
        self._req_total = m.counter(
            "gofr_tpu_router_requests_total",
            "forwarded requests by replica and outcome "
            "(ok | upstream_5xx | network_error | client_aborted)",
            labels=("replica", "outcome"),
        )
        self._retries_total = m.counter(
            "gofr_tpu_router_retries_total",
            "router retry attempts by failing replica and reason",
            labels=("replica", "reason"),
        )
        self._shed_total = m.counter(
            "gofr_tpu_router_shed_total",
            "requests shed at admission (429/503) by reason",
            labels=("reason",),
        )
        self._breaker_total = m.counter(
            "gofr_tpu_router_breaker_transitions_total",
            "circuit-breaker state transitions by replica and target state",
            labels=("replica", "to"),
        )
        self._breaker_gauge = m.gauge(
            "gofr_tpu_router_breaker_state",
            "breaker state per replica (0 closed, 1 half-open, 2 open)",
            labels=("replica",),
        )
        self._replica_gauge = m.gauge(
            "gofr_tpu_router_replica_state",
            "rotation state per replica (0 out, 1 probation, 2 healthy)",
            labels=("replica",),
        )
        self._outstanding_gauge = m.gauge(
            "gofr_tpu_router_outstanding_depth",
            "requests currently outstanding against each replica",
            labels=("replica",),
        )
        self._inflight_gauge = m.gauge(
            "gofr_tpu_router_inflight_depth",
            "requests currently inside the router (admitted, not finished)",
        )
        self._upstream_seconds = m.histogram(
            "gofr_tpu_router_upstream_seconds",
            "upstream attempt latency per replica (success or failure)",
            labels=("replica",),
        )
        self._replica_restarts = m.counter(
            "gofr_tpu_router_replica_restarts_total",
            "replica processes observed REBORN by the prober (ready "
            "boot_id changed): a supervisor respawned the process after "
            "a crash/SIGKILL; the replica re-enters through probation "
            "as `restarting`",
            labels=("replica",),
        )
        self._hop_seconds = m.histogram(
            "gofr_tpu_router_hop_seconds",
            "per-hop latency decomposition of one routed request: "
            "router (admission + selection overhead before the first "
            "upstream dispatch), upstream (one buffered attempt's "
            "round trip), stream (one streaming attempt's body "
            "duration), resume (a mid-stream failover continuation's "
            "splice latency) — the metric behind the per-stage "
            "breakdown /admin/fleet/trace/<id> shows for one request",
            labels=("stage",),
        )
        self._stream_resumes = m.counter(
            "gofr_tpu_router_stream_resumes_total",
            "mid-stream failover outcomes on resumable (deterministic) "
            "SSE streams: resumed (continuation spliced in), exhausted "
            "(deadline/attempts spent — truncated), refused (the "
            "replica rejected the resume — truncated)",
            labels=("outcome",),
        )

    def _wire_hooks(self) -> None:
        """Attach breaker-transition and rotation-state hooks so every
        decision is observable the moment it happens."""
        for replica in self.replica_set.replicas:
            self._replica_gauge.set(
                float(STATE_VALUES[replica.state]), replica=replica.name
            )
            self._breaker_gauge.set(
                float(breaker_mod.STATE_VALUES[replica.breaker.state]),
                replica=replica.name,
            )
            replica.breaker._on_transition = self._breaker_hook(replica.name)
        self.replica_set._on_state_change = self._rotation_hook
        self.replica_set._on_restart = self._restart_hook

    def _breaker_hook(self, name: str) -> Any:
        def hook(was: str, to: str) -> None:
            self._breaker_total.inc(replica=name, to=to)
            self._breaker_gauge.set(
                float(breaker_mod.STATE_VALUES[to]), replica=name
            )
            self.logger.infof("fleet breaker %s: %s -> %s", name, was, to)
        return hook

    def _rotation_hook(self, replica: Any, was: str, now: str) -> None:
        self._replica_gauge.set(
            float(STATE_VALUES[now]), replica=replica.name
        )
        self.logger.infof(
            "fleet replica %s: %s -> %s (%s)",
            replica.name, was, now, replica.last_probe_error or "ready",
        )

    def _restart_hook(self, replica: Any) -> None:
        self._replica_restarts.inc(replica=replica.name)
        self.logger.infof(
            "fleet replica %s: process restarted (boot_id %s, restart #%s)"
            " — restarting via probation",
            replica.name, replica.boot_id, replica.restarts,
        )

    # -- lifecycle -------------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def in_flight(self) -> int:
        # lock-free read (int attribute reads are GIL-atomic): admin
        # snapshots and drain logging must not contend with the
        # admission path for the condition's mutex
        return self._inflight

    def begin_drain(self) -> None:
        """Stop admitting; readiness flips to 503 (handler.py checks
        :attr:`draining`)."""
        self._draining = True
        self.logger.infof(
            "fleet drain: admission closed, %s in flight", self.in_flight
        )

    # the in-flight counter releases when the HANDLER finishes; the
    # server still has to flush that last response onto the socket, so
    # drain() lingers briefly before declaring the listener safe to stop
    DRAIN_GRACE_S = 0.25

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Graceful drain: stop admitting, then wait for the in-flight
        requests to finish. Returns True when fully drained."""
        self.begin_drain()
        deadline = time.monotonic() + timeout_s
        with self._idle:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._idle.wait(remaining)
            drained = self._inflight == 0
        if drained:
            time.sleep(self.DRAIN_GRACE_S)
        self.logger.infof(
            "fleet drain %s (%s left)",
            "complete" if drained else "TIMED OUT", self.in_flight,
        )
        return drained

    def close(self) -> None:
        self._draining = True
        self.replica_set.close()

    # -- admission -------------------------------------------------------------
    def _shed(self, status: int, reason: str, retry_after_s: float,
              detail: str, request_id: str = "", tenant: str = "") -> Response:
        self._shed_total.inc(reason=reason)
        if tenant and self.tenants is not None:
            # a router shed never reaches a replica's flight recorder,
            # so the tenant ledger meters it at the verdict
            self.tenants.shed(tenant)
        # the request id rides the shed body AND header: a 429/503 the
        # router refused is otherwise untraceable — no route forward,
        # no replica record, just a log line the client needs to quote.
        # The HASHED tenant id rides next to it: the subject of a quota
        # verdict should be able to quote itself to /admin/tenants.
        body = json.dumps({"error": {
            "message": detail, "reason": reason,
            "retry_after_s": round(retry_after_s, 3),
            "request_id": request_id or None,
            "tenant": tenant or None,
        }}).encode("utf-8")
        headers = {"Content-Type": _JSON,
                   "Retry-After": str(max(1, int(retry_after_s + 0.999)))}
        if request_id:
            headers["X-Gofr-Request-Id"] = request_id
        response = Response(status=status, headers=headers, body=body)
        response._shed_reason = reason
        return response

    def _admit(self, request: Any, tenant: str,
               request_id: str = "") -> Optional[Response]:
        """None = admitted AND the in-flight slot is HELD (the caller
        must ``_release()``); a Response = the shed verdict. Ordering:
        router-state sheds first, then the slot (check-and-increment
        atomically under the lock — a read-then-act gap would let a
        thundering herd overshoot the cap by up to the handler-pool
        size), then the quota LAST so router-side rejections never
        charge the tenant a token for a request the router itself
        refused."""
        if self._draining:
            return self._shed(
                503, "draining", self.retry_after_s,
                "router is draining; retry against another front door",
                request_id=request_id, tenant=tenant,
            )
        if self.replica_set.all_saturated():
            return self._shed(
                429, "kv_exhausted", self.retry_after_s,
                "every replica reports KV/queue saturation",
                request_id=request_id, tenant=tenant,
            )
        if not self.replica_set.in_rotation():
            return self._shed(
                503, "no_replicas", self.retry_after_s,
                "no replica in rotation",
                request_id=request_id, tenant=tenant,
            )
        if not self._try_acquire_slot():
            return self._shed(
                429, "inflight", self.retry_after_s,
                "router at its in-flight cap",
                request_id=request_id, tenant=tenant,
            )
        ok, retry_after = self.quota.take(tenant)
        if not ok:
            self._release()
            return self._shed(
                429, "quota", retry_after,
                f"tenant '{tenant}' over its request quota",
                request_id=request_id, tenant=tenant,
            )
        if self.tenants is not None:
            # admitted: one request on the router's own tenant ledger
            # (replica-side ledgers add tokens when the flight finishes)
            self.tenants.observe(tenant, requests=1)
        return None

    def _try_acquire_slot(self) -> bool:
        # the gauge write happens OUTSIDE the condition's mutex: the
        # metric registry has its own lock, and nesting it under _idle
        # put a foreign lock inside the hottest router mutex (lock-order
        # edge + hold time — both sanitizer findings at fleet scale).
        # Two concurrent updates may publish out of order; the depth
        # gauge self-corrects on the next admission, which is the right
        # trade for not serializing admission on metric bookkeeping.
        with self._idle:
            if self.max_inflight > 0 and self._inflight >= self.max_inflight:
                return False
            self._inflight += 1
            depth = self._inflight
        self._inflight_gauge.set(float(depth))
        return True

    # -- the forward handler ---------------------------------------------------
    def handle(self, ctx: Any) -> Response:
        """The transport handler registered for every forwarded route
        (sync: runs on the container's handler pool)."""
        request = ctx.request
        tenant = tenant_of(request, self.trust_tenant_header)
        # the fleet-wide correlation id: honor a sanitized client
        # X-Request-ID (length-bounded, charset-restricted — garbage
        # degrades to a minted id, never to a 4xx), else mint. The id
        # echoes on EVERY response — sheds included — and keys the
        # route record, every replica FlightRecord this request causes,
        # and /admin/fleet/trace/<id>. A client-supplied X-Gofr-Hop is
        # NOT consulted: hop provenance is the router's to assert (same
        # trust discipline as X-KV-Donor).
        request_id = sanitize_request_id(
            request.header("X-Request-ID")
            or request.header("X-Gofr-Request-Id")
        ) or mint_request_id()
        verdict = self._admit(request, tenant, request_id)
        if verdict is not None:
            # record construction stays OUTSIDE the ring lock: the lock
            # guards exactly one deque.append per request, so a shed
            # storm (the moment every request takes this path) never
            # serializes on dict building
            shed_record = {
                "ts": time.time(),  # gofrlint: wall-clock — route-record display timestamp
                "request_id": request_id,
                "method": request.method, "path": request.path,
                "tenant": tenant, "attempts": [], "retries": 0,
                "status": verdict.status,
                "outcome": f"shed:{verdict._shed_reason}",
            }
            with self._records_lock:
                self._records.append(shed_record)
            return verdict
        # reached here: _admit HOLDS the in-flight slot for this request
        body_json = self._body_json(request)
        affinity = (affinity_key_of(request, body_json)
                    if self.affinity_enabled else "")
        # disaggregated routing: classify the request's tier and, for
        # token-id prompts, derive the EXACT KV identity — prompt-hash
        # rendezvous then beats the PROMPT-HEAD affinity heuristic
        # (locality to actual cached blocks, not to a conversation
        # guess). An EXPLICIT client key (X-Session-ID / X-Affinity-Key
        # / the OpenAI user field) still wins: the client asked to pin,
        # and the donor hint carries KV locality anyway.
        role = self._classify_role(request.path) if self.role_routing else None
        kv_hash = (
            self._kv_hash_of(body_json)
            if self.role_routing and self.affinity_enabled else ""
        )
        if kv_hash and not self._explicit_affinity(request, body_json):
            affinity = kv_hash
        wants_stream = isinstance(body_json, dict) and bool(body_json.get("stream"))
        # resumable: deterministic streams (seed / greedy) can be
        # regenerated bit-identically, so a mid-stream upstream failure
        # is recoverable by event-id splicing instead of truncation
        resumable = (
            self.resume_enabled and wants_stream and self.max_resumes > 0
            and _deterministic_body(body_json)
        )
        try:
            response = self._forward(
                request, tenant, affinity, wants_stream,
                executor=ctx.container.handler_executor,
                resumable=resumable, role=role, kv_hash=kv_hash,
                request_id=request_id,
            )
            response.headers["X-Gofr-Request-Id"] = request_id
            return response
        finally:
            # streaming responses decrement in their own finally instead
            # (the handler returns before the body is pulled); _forward
            # flags that by setting _stream_owns_release
            if not getattr(request, "_stream_owns_release", False):
                self._release()

    def _release(self) -> None:
        with self._idle:
            self._inflight = max(0, self._inflight - 1)
            depth = self._inflight
            if depth == 0:
                self._idle.notify_all()
        # outside the mutex on purpose — see _try_acquire_slot
        self._inflight_gauge.set(float(depth))

    @staticmethod
    def _body_json(request: Any) -> Any:
        if not request.body:
            return None
        try:
            return json.loads(request.body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None

    def _target(self, request: Any) -> str:
        # parse_qs gives {key: [values]}; _encode_query repeats the key
        # per value, round-tripping the original query string
        query = _encode_query(request.query)
        return request.path + ("?" + query if query else "")

    @staticmethod
    def _forward_headers(request: Any) -> dict[str, str]:
        return {
            name: request.headers[name]
            for name in _FORWARD_HEADERS if name in request.headers
        }

    @staticmethod
    def _client_budget_s(request: Any) -> Optional[float]:
        """The client's own ``X-Request-Deadline-Ms`` budget in seconds
        (None when absent/malformed — the router's FLEET_DEADLINE_S
        then stands alone; a malformed header is the REPLICA's 400 to
        give, the router must not eat the request first)."""
        raw = request.header("X-Request-Deadline-Ms")
        if not raw:
            return None
        try:
            ms = int(raw)
        except ValueError:
            return None
        if ms <= 0:
            return None
        return ms / 1000.0

    @staticmethod
    def _classify_role(path: str) -> Optional[str]:
        """The replica tier a route prefers: prefill-only surfaces
        (embeddings, single-shot infer) want the prefill tier; token
        generation wants the decode tier; everything else (models
        listing, unknown routes) has no preference."""
        if path.endswith("/embeddings") or path.endswith("/infer"):
            return "prefill"
        if path.endswith("/completions") or path.endswith("/generate"):
            return "decode"
        return None

    @staticmethod
    def _explicit_affinity(request: Any, body: Any) -> bool:
        """True when the CLIENT pinned the conversation (session/
        affinity header or the OpenAI ``user`` field) — those pins
        outrank KV-hash rendezvous; only the prompt-head heuristic
        yields to it."""
        if request.header("X-Session-ID") or request.header("X-Affinity-Key"):
            return True
        return isinstance(body, dict) and bool(body.get("user"))

    @staticmethod
    def _kv_hash_of(body: Any) -> str:
        """The prompt's exact KV identity, derivable only for token-id
        prompts (text prompts tokenize replica-side; their locality
        stays with the affinity heuristics)."""
        if not isinstance(body, dict):
            return ""
        tokens = body.get("tokens")
        if not isinstance(tokens, list):
            tokens = body.get("prompt")
        if (
            isinstance(tokens, list) and tokens
            and all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in tokens
            )
        ):
            from gofr_tpu_torch.fleet.kvwire import prompt_hash

            return prompt_hash(tokens)
        return ""

    def _kv_donor(self, kv_hash: str) -> Optional[Any]:
        """The prefill-tier replica that rendezvous-owns this prompt's
        KV — the X-KV-Donor stamp for decode-bound requests. None when
        no prefill replica is in rotation (a mixed fleet has no
        dedicated donors; locality then rides selection alone)."""
        if not kv_hash:
            return None
        tier = [
            r for r in self.replica_set.replicas
            if r.state == HEALTHY and r.role == "prefill"
        ]
        if not tier:
            return None
        ranked = affinity_order(kv_hash, [r.name for r in tier])
        return next(r for r in tier if r.name == ranked[0])

    def _forward(self, request: Any, tenant: str, affinity: str,
                 wants_stream: bool, executor: Any = None,
                 resumable: bool = False, role: Optional[str] = None,
                 kv_hash: str = "", request_id: str = "") -> Response:
        start = time.monotonic()
        # the router's SERVER span, captured ONCE: every attempt — and
        # every relay continuation, which re-reads the same headers dict
        # from a pool thread where the span contextvar is gone — stamps
        # this traceparent explicitly, so failover hops parent to the
        # ORIGINAL request span instead of starting fresh traces (the
        # service client's setdefault respects an existing stamp)
        span = current_span()
        # the effective budget is the TIGHTER of the router's own
        # forwarding deadline and the client's end-to-end deadline —
        # retrying past what the client will wait for is pure waste
        budget_s = self.deadline_s
        client_budget = self._client_budget_s(request)
        if client_budget is not None:
            budget_s = min(budget_s, client_budget)
        deadline = start + budget_s
        target = self._target(request)
        headers = self._forward_headers(request)
        record: dict[str, Any] = {
            "ts": time.time(),  # gofrlint: wall-clock — route-record display timestamp
            "request_id": request_id,
            "router_id": self.router_id,
            "method": request.method,
            "path": request.path,
            "tenant": tenant,
            # hashed: the raw key can be PROMPT TEXT (affinity_key_of
            # falls back to the message head) and route records serve
            # on /admin/fleet — same rule as the tenant hash
            "affinity_key": hash_affinity(affinity) if affinity else None,
            "stream": wants_stream,
            "resumable": resumable,
            "resumes": 0,
            # disaggregated routing evidence: the tier asked for, and
            # which replica (if any) was named as the KV donor
            "role": role,
            "kv_donor": None,
            "attempts": [],
            "outcome": "error",
            "status": 0,
            # monotonic start for the END-TO-END elapsed stamped at
            # finish ("_"-prefixed: stripped from the admin surface)
            "_start_mono": start,
        }
        # the donor is decided ONCE per request (the prefill replica
        # rendezvous-owning the prompt's KV), then stamped per attempt
        # so a failover hop still knows where the warm blocks live
        donor = (
            self._kv_donor(kv_hash) if role == "decode" else None
        )
        if donor is not None:
            record["kv_donor"] = donor.name
        tried: set[str] = set()
        delays = backoff_delays(self.retries)
        response: Optional[Response] = None
        attempts = 0
        while attempts <= self.retries:
            # budget check BEFORE the pick: _pick may claim a breaker's
            # single half-open probe slot, and only _attempt releases it
            # (via record_success/record_failure) — breaking between the
            # two would wedge that breaker half-open forever
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            picked = self._pick(affinity, tried, role=role)
            if picked is None:
                break
            replica, is_probe = picked
            # the donor hint: stamped only when a DIFFERENT replica
            # holds the warm blocks (pulling from yourself is a no-op
            # the replica would skip anyway, but why ask)
            if donor is not None and donor.name != replica.name:
                headers["X-KV-Donor"] = donor.address
            else:
                headers.pop("X-KV-Donor", None)
            # hop provenance, re-stamped per attempt: which router,
            # which failover attempt (0-based), resume 0 (continuations
            # re-stamp their own index in _StreamRelay._try_resume).
            # Client copies of these headers never reach here — they
            # are not in _FORWARD_HEADERS — so the replica can trust
            # the stamp the way it trusts X-KV-Donor.
            headers["X-Gofr-Request-Id"] = request_id
            headers["X-Gofr-Hop"] = format_hop(self.router_id, attempts, 0)
            if span is not None:
                headers["traceparent"] = span.traceparent()
            if attempts == 0:
                # router-overhead stage: admission, body parse, and
                # selection paid before the FIRST upstream dispatch
                self._hop_seconds.observe(
                    time.monotonic() - start, stage="router"
                )
            if record["attempts"]:
                # a retry is now CERTAIN (a replica was found and will
                # be attempted): count it against the attempt it redoes
                prev = record["attempts"][-1]
                self._retries_total.inc(
                    replica=prev["replica"],
                    reason=prev.get("reason") or "error",
                )
            attempts += 1
            tried.add(replica.name)
            # deadline propagation: each attempt hands the replica the
            # REMAINING budget (floored at 1 ms) — a second attempt
            # after a 2 s failure sees a budget 2 s smaller, so no hop
            # is ever granted more time than the client has left. Only
            # when the client SET a budget: no header / "0" / garbage
            # forward verbatim (the replica's default or 400 applies) —
            # the router must never mint a deadline the client didn't ask for
            if client_budget is not None:
                headers["X-Request-Deadline-Ms"] = str(
                    max(1, int(remaining * 1000))
                )
            resume = (
                _ResumeSpec(request.method, target, headers,
                            request.body or None, deadline, affinity,
                            budgeted=client_budget is not None)
                if resumable else None
            )
            response = self._attempt(
                replica, request, target, headers, wants_stream,
                remaining, record, executor, is_probe, resume=resume,
            )
            if response is not None:
                if response.stream is None:
                    # streaming responses finish their record (and the
                    # in-flight release) when the body completes
                    self._finish_record(record, response.status)
                return response
            delay = next(delays, None)
            if delay is None or time.monotonic() + delay >= deadline:
                break
            time.sleep(delay)
        # nothing served: every candidate failed, refused, or timed out
        last = record["attempts"][-1] if record["attempts"] else None
        detail = (last or {}).get("error") or "no replica could serve the request"
        self._finish_record(record, 502)
        body = json.dumps({"error": {
            "message": f"fleet forward failed after {attempts} attempt(s): {detail}",
            "request_id": request_id or None,
        }}).encode("utf-8")
        return Response(
            status=502,
            headers={"Content-Type": _JSON,
                     "Retry-After": str(max(1, int(self.retry_after_s)))},
            body=body,
        )

    def _pick(self, affinity: str, tried: set[str],
              role: Optional[str] = None) -> Optional[tuple[Any, bool]]:
        """First candidate whose breaker admits the request, plus
        whether this dispatch IS that breaker's half-open probe (its
        success report must carry the probe grant). Pass order: the
        requested role tier first, then role-free (an empty tier OR a
        tier whose breakers all veto must degrade to mixed routing,
        never to a 502 the un-roled fleet would have served), then
        already-tried replicas as the last resort (a 2-replica fleet
        with one dead replica must still retry the healthy one rather
        than give up). Re-testing a breaker across passes is harmless:
        a closed breaker grants again (we returned the first time), a
        vetoing one vetoes again."""
        passes: list[tuple[Optional[set[str]], Optional[str]]] = []
        if role is not None:
            passes.append((tried, role))
        passes.append((tried, None))
        if tried:
            passes.append((None, None))
        for exclude, tier in passes:
            for replica in self.replica_set.candidates(
                affinity, exclude=exclude, role=tier
            ):
                grant = replica.breaker.try_acquire()
                if grant:
                    return replica, grant == breaker_mod.PROBE
        return None

    def _attempt(
        self,
        replica: Any,
        request: Any,
        target: str,
        headers: dict[str, str],
        wants_stream: bool,
        remaining_s: float,
        record: dict[str, Any],
        executor: Any = None,
        is_probe: bool = False,
        resume: Optional[_ResumeSpec] = None,
    ) -> Optional[Response]:
        """One forward attempt. Returns the client-facing Response, or
        None when the failure is retryable (breaker/metrics/record
        already updated)."""
        entry: dict[str, Any] = {"replica": replica.name, "status": None,
                                 "error": None, "elapsed_ms": 0}
        record["attempts"].append(entry)
        depth = replica.mark_dispatch()
        self._outstanding_gauge.set(float(depth), replica=replica.name)
        attempt_start = time.monotonic()
        read_timeout = min(self.read_timeout_s, remaining_s)
        streaming: Optional[Any] = None
        try:
            if wants_stream:
                streaming = replica.client.stream(
                    request.method, target, body=request.body or None,
                    headers=headers,
                    connect_timeout=min(self.connect_timeout_s, remaining_s),
                    read_timeout=read_timeout,
                )
                status = streaming.status_code
                if status == 200:
                    if resume is not None:
                        # committed, but NOT final: the relay journals
                        # delivered event ids and can splice a failover
                        # continuation into this very response
                        return self._relay_response(
                            replica, request, streaming, entry,
                            attempt_start, record, executor, is_probe,
                            resume,
                        )
                    # committed: from here the bytes flow to the client
                    # and the request stops being retryable
                    return self._stream_response(
                        replica, request, streaming, entry, attempt_start,
                        record, executor, is_probe,
                    )
                # bounded drain: an untrusted replica dripping its
                # error body must not pin this thread past the budget
                payload = streaming.read(budget_s=read_timeout)
                resp_headers = streaming.headers
                streaming = None
            else:
                resp = replica.client.request(
                    request.method, target, body=request.body or None,
                    headers=headers,
                    connect_timeout=min(self.connect_timeout_s, remaining_s),
                    read_timeout=read_timeout,
                    retries=0,
                )
                status, payload, resp_headers = (
                    resp.status_code, resp.body, resp.headers
                )
        except ServiceCallError as exc:
            return self._note_failure(
                replica, entry, attempt_start, "network", str(exc.cause)
            )
        except Exception as exc:
            # a mid-read socket timeout / reset from StreamingServiceResponse
            # arrives unwrapped; the connection closed with it
            if streaming is not None:
                streaming.close()
            return self._note_failure(
                replica, entry, attempt_start, "read", str(exc)
            )
        elapsed = time.monotonic() - attempt_start
        entry["status"] = status
        entry["elapsed_ms"] = round(elapsed * 1000, 1)
        self._upstream_seconds.observe(elapsed, replica=replica.name)
        self._hop_seconds.observe(elapsed, stage="upstream")
        self._finish_attempt(replica)
        if status >= 500:
            replica.breaker.record_failure()
            self._req_total.inc(replica=replica.name, outcome="upstream_5xx")
            entry["error"] = f"upstream {status}"
            entry["reason"] = f"status_{status}"
            return None  # retryable: no bytes reached the client
        replica.breaker.record_success(probe=is_probe)
        self._req_total.inc(replica=replica.name, outcome="ok")
        out_headers = _filter_return_headers(resp_headers)
        if status == 429:
            # echo the replica's overload verdict upstream, always with
            # a backoff hint (never an unbounded queue)
            out_headers.setdefault(
                "Retry-After", str(max(1, int(self.retry_after_s)))
            )
            self._shed_total.inc(reason="upstream_429")
        return Response(status=status, headers=out_headers, body=payload)

    def _note_failure(self, replica: Any, entry: dict, attempt_start: float,
                      reason: str, detail: str) -> None:
        elapsed = time.monotonic() - attempt_start
        entry["error"] = detail
        entry["reason"] = reason
        entry["elapsed_ms"] = round(elapsed * 1000, 1)
        self._upstream_seconds.observe(elapsed, replica=replica.name)
        self._hop_seconds.observe(elapsed, stage="upstream")
        self._finish_attempt(replica)
        replica.breaker.record_failure()
        self._req_total.inc(replica=replica.name, outcome="network_error")
        return None

    def _finish_attempt(self, replica: Any) -> None:
        depth = replica.mark_done()
        self._outstanding_gauge.set(float(depth), replica=replica.name)

    def _stream_response(
        self,
        replica: Any,
        request: Any,
        streaming: Any,
        entry: dict[str, Any],
        attempt_start: float,
        record: dict[str, Any],
        executor: Any = None,
        is_probe: bool = False,
    ) -> Response:
        """Wrap the upstream chunk iterator for SSE passthrough. The
        handler returns immediately; accounting (outstanding, breaker,
        in-flight release, route record) completes when the body
        finishes — through an IDEMPOTENT finalizer invoked from both
        the chunk generator's ``finally`` and the async bridge's, so a
        cancelled connection task (drain, client gone, shutdown) can
        never leave the in-flight counter elevated or a half-open
        breaker probe slot claimed, even if the sync generator is
        mid-``next`` on a pool thread or was never started at all."""
        request._stream_owns_release = True
        entry["status"] = 200
        finalizer = _StreamFinalizer(
            self, replica, streaming, entry, record, attempt_start, is_probe
        )

        def chunks() -> Any:
            try:
                for chunk in streaming.iter_chunks():
                    yield chunk
            except Exception:
                finalizer.finish("upstream_error")
                raise  # the server aborts the client connection (truncated)
            finally:
                finalizer.finish("ok")

        return Response(
            status=200,
            headers=_filter_return_headers(streaming.headers),
            stream=_sync_pull(chunks(), executor, finalizer),
        )

    def _relay_response(
        self,
        replica: Any,
        request: Any,
        streaming: Any,
        entry: dict[str, Any],
        attempt_start: float,
        record: dict[str, Any],
        executor: Any,
        is_probe: bool,
        resume: _ResumeSpec,
    ) -> Response:
        """Resumable SSE passthrough: like ``_stream_response`` but the
        relay owns a retry loop — a mid-stream upstream failure resumes
        from the last delivered event id instead of truncating."""
        request._stream_owns_release = True
        entry["status"] = 200
        relay = _StreamRelay(
            self, replica, streaming, entry, record, attempt_start,
            is_probe, resume,
        )
        return Response(
            status=200,
            headers=_filter_return_headers(streaming.headers),
            stream=_sync_pull(relay.chunks(), executor, relay),
        )

    def _finish_record(self, record: dict[str, Any], status: int) -> None:
        record["status"] = status
        record["retries"] = max(0, len(record["attempts"]) - 1)
        start_mono = record.get("_start_mono")
        if start_mono is not None and "elapsed_ms" not in record:
            # end-to-end router-side latency: the minuend the trace
            # assembly decomposes into router/queue/TTFT/stream stages
            record["elapsed_ms"] = round(
                (time.monotonic() - start_mono) * 1000, 1
            )
        # outcome follows the status CLASS — a forwarded 429 or 404 is
        # not a successful route, and an operator triaging overload
        # from these records must see it agree with the shed metrics
        if status == 499:
            record["outcome"] = "aborted"
        elif status == 429:
            record["outcome"] = "shed_upstream"
        elif 200 <= status < 400:
            record["outcome"] = "ok"
        elif 400 <= status < 500:
            record["outcome"] = "client_error"
        else:
            record["outcome"] = "error"
        if record.get("_stored"):
            return
        record["_stored"] = True
        with self._records_lock:
            self._records.append(record)

    # -- admin surface ---------------------------------------------------------
    def records(self, limit: int = 50,
                request_id: Optional[str] = None) -> list[dict[str, Any]]:
        """Most-recent-first route records. ``request_id`` filters to
        the records that carried that id (the whole ring is scanned
        then — an id lookup must not miss a match because 50 newer
        requests landed)."""
        with self._records_lock:
            recent = (
                list(self._records) if request_id is not None
                else list(self._records)[-limit:]
            )
        out = []
        for r in reversed(recent):
            if request_id is not None and r.get("request_id") != request_id:
                continue
            out.append({k: v for k, v in r.items() if not k.startswith("_")})
            if len(out) >= limit:
                break
        return out

    def snapshot(self) -> dict[str, Any]:
        """``GET /admin/fleet``: the whole front door on one page. The
        view is THIS router instance's (in-flight, records, breaker and
        rotation verdicts are per-instance by design — see router_id)."""
        return {
            "router_id": self.router_id,
            "draining": self._draining,
            "in_flight": self.in_flight,
            "max_inflight": self.max_inflight,
            "retries": self.retries,
            "deadline_s": self.deadline_s,
            "role_routing": self.role_routing,
            "quota": self.quota.stats(),
            "replica_set": self.replica_set.snapshot(),
            "routes": self.records(limit=50),
        }


class _StreamFinalizer:
    """Idempotent completion accounting for one proxied stream. Invoked
    from the chunk generator's ``finally``, the async bridge's
    ``finally``, or both in either order — the FIRST call wins. Keeping
    it out of the generators means a generator that is cancelled
    mid-``next`` (``close()`` would raise 'generator already
    executing') or finalized before its first pull (its body — and
    ``finally`` — never ran) still releases everything."""

    def __init__(self, router: "FleetRouter", replica: Any, streaming: Any,
                 entry: dict[str, Any], record: dict[str, Any],
                 attempt_start: float, is_probe: bool = False):
        self._router = router
        self._replica = replica
        self._streaming = streaming
        self._entry = entry
        self._record = record
        self._attempt_start = attempt_start
        self._is_probe = is_probe
        self._done = False
        self._lock = threading.Lock()

    def finish(self, outcome: str) -> None:
        """``outcome``: "ok" (body completed), "upstream_error" (the
        REPLICA broke the stream — breaker failure), or "aborted" (the
        CLIENT walked away / the connection task was cancelled — the
        replica was serving fine, so its breaker records a success:
        punishing replicas for client disconnects would open breakers
        on a healthy fleet, and a half-open probe slot must still be
        released either way)."""
        with self._lock:
            if self._done:
                return
            self._done = True
        router, replica, entry = self._router, self._replica, self._entry
        # closing the upstream also unblocks a pool thread still parked
        # in next() on this stream — its read errors out and returns
        self._streaming.close()
        elapsed = time.monotonic() - self._attempt_start
        entry["elapsed_ms"] = round(elapsed * 1000, 1)
        router._upstream_seconds.observe(elapsed, replica=replica.name)
        router._hop_seconds.observe(elapsed, stage="stream")
        router._finish_attempt(replica)
        if outcome == "upstream_error":
            entry["error"] = "stream aborted mid-body"
            replica.breaker.record_failure()
            router._req_total.inc(replica=replica.name, outcome="network_error")
            router._finish_record(self._record, 499)
        elif outcome == "aborted":
            entry["error"] = "client abandoned the stream"
            replica.breaker.record_success(probe=self._is_probe)
            router._req_total.inc(replica=replica.name, outcome="client_aborted")
            router._finish_record(self._record, 499)
        else:
            replica.breaker.record_success(probe=self._is_probe)
            router._req_total.inc(replica=replica.name, outcome="ok")
            router._finish_record(self._record, 200)
        router._release()


def _deterministic_body(body: Any) -> bool:
    """True when the request's stream can be REGENERATED bit-identically
    (the resume precondition): an explicit seed, or explicit greedy
    sampling (temperature 0). Anything else — including the server-side
    default temperature, which this router must not assume — keeps the
    non-resumable truncate-on-failure contract."""
    if not isinstance(body, dict):
        return False
    if body.get("seed") is not None:
        return True
    temperature = body.get("temperature")
    return isinstance(temperature, (int, float)) and float(temperature) == 0.0


class _SSEEventScanner:
    """Incremental SSE event framer: feed raw chunks, get back complete
    ``(block_bytes, event_id, is_error)`` events. ``block_bytes`` is the
    verbatim wire slice (passthrough stays byte-identical); ``event_id``
    is the parsed ``id:`` line (None when absent); ``is_error`` flags
    the engine's error frame (``data: {"error": ...}``) — the signal
    that a replica's generation died mid-stream even though the HTTP
    stream ended 'cleanly'."""

    MAX_BUFFER = 1 << 20  # a frame larger than 1 MiB is not ours

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, chunk: bytes) -> list[tuple[bytes, Optional[int], bool]]:
        self._buf += chunk
        if len(self._buf) > self.MAX_BUFFER:
            raise ValueError("SSE frame exceeds the relay buffer bound")
        events: list[tuple[bytes, Optional[int], bool]] = []
        while True:
            idx = self._buf.find(b"\n\n")
            if idx < 0:
                return events
            block, self._buf = self._buf[:idx + 2], self._buf[idx + 2:]
            event_id: Optional[int] = None
            is_error = False
            for line in block.split(b"\n"):
                line = line.rstrip(b"\r")
                if line.startswith(b"id:"):
                    try:
                        event_id = int(line[3:].strip())
                    except ValueError:
                        pass
                elif line.startswith(b"data:") and line[5:].lstrip(
                ).startswith(b'{"error"'):
                    is_error = True
            events.append((block, event_id, is_error))


class _UpstreamStreamError(Exception):
    """A proxied stream's upstream died mid-body (transport failure or
    the replica's own error frame)."""


class _StreamRelay:
    """Resumable proxied stream: one client response spliced together
    from up to ``max_resumes + 1`` upstream attempts.

    The relay forwards complete SSE events, journaling the next
    expected event id as it goes. When the CURRENT upstream fails — a
    socket error, a read timeout, or the replica's in-band error frame
    (a wedged engine ends its stream with ``data: {"error": ...}``, not
    a reset) — the relay settles that attempt's accounting (breaker
    failure, outstanding depth, route record) and hunts for a
    continuation: the ORIGINATING replica first (it holds the
    generation journal, and probation counts as "coming back"), then
    any healthy candidate, re-issuing the request with
    ``X-Resume-From: <next id>``. Continuation events are filtered by
    id, so a replica that ignores the resume header and regenerates
    from zero still splices correctly — the deterministic-body
    precondition guarantees the regenerated frames match.

    Idempotent ``finish``-style finalization mirrors
    :class:`_StreamFinalizer` (the async bridge calls
    ``finish("aborted")`` on client disconnect)."""

    def __init__(self, router: "FleetRouter", replica: Any, streaming: Any,
                 entry: dict[str, Any], record: dict[str, Any],
                 attempt_start: float, is_probe: bool, resume: _ResumeSpec):
        self._router = router
        self._replica = replica          # current upstream's replica
        self._origin = replica           # served the original prefix
        self._streaming = streaming
        self._entry = entry              # current attempt's route entry
        self._record = record
        self._attempt_start = attempt_start
        self._is_probe = is_probe
        self._resume = resume
        self._scanner = _SSEEventScanner()
        self._next_id = 0         # next event id the client expects
        self._saw_ids = False     # the upstream actually numbers frames
        self._delivered = 0       # events actually forwarded to the client
        self._resumed = False     # current upstream is a continuation
        self._resumes = 0
        self._attempt_settled = False
        self._done = False
        self._lock = threading.Lock()

    # -- the client-facing chunk generator -------------------------------------
    def chunks(self) -> Any:
        while True:
            try:
                failed = False
                for chunk in self._streaming.iter_chunks():
                    for block in self._drain(chunk):
                        yield block
                # the upstream closed; an error frame mid-buffer still
                # counts as a failure (flagged by _drain via exception)
                self._settle_attempt("ok")
                self._finalize("ok")
                return
            except GeneratorExit:
                # client gone: _sync_pull finalizes via finish(); close
                # the CURRENT upstream here too — a continuation opened
                # after the abort would otherwise leak until GC
                self._streaming.close()
                raise
            except _UpstreamStreamError as exc:
                failed = str(exc)
            except Exception as exc:
                failed = f"{type(exc).__name__}: {exc}"
            self._settle_attempt("upstream_error", failed)
            if not self._try_resume():
                self._finalize("upstream_error")
                raise _UpstreamStreamError(
                    f"stream failed and could not resume: {failed}"
                )

    def _drain(self, chunk: bytes) -> list[bytes]:
        """Complete events from one raw chunk, filtered for delivery.
        Raises :class:`_UpstreamStreamError` on the replica's in-band
        error frame — it must never reach the client (the relay's whole
        point is to replace it with a continuation)."""
        out: list[bytes] = []
        for block, event_id, is_error in self._scanner.feed(chunk):
            if is_error:
                raise _UpstreamStreamError("replica error frame")
            if event_id is not None:
                self._saw_ids = True
                if event_id < self._next_id:
                    continue  # continuation replaying delivered events
                self._next_id = event_id + 1
            elif self._resumed:
                # id-less frames are only trustworthy from the original
                # attempt (a regenerating continuation re-emits them)
                continue
            out.append(block)
        self._delivered += len(out)
        return out

    # -- per-attempt accounting ------------------------------------------------
    def _settle_attempt(self, outcome: str, detail: str = "") -> None:
        """Close the CURRENT upstream attempt's books (idempotent per
        attempt): outstanding depth, latency histogram, breaker verdict,
        request counter. The guard is LOCKED: a client abort (event
        loop) and an upstream failure (pool thread) can race here, and
        a double settle would double-record breaker verdicts."""
        with self._lock:
            if self._attempt_settled:
                return
            self._attempt_settled = True
        router, replica = self._router, self._replica
        self._streaming.close()
        elapsed = time.monotonic() - self._attempt_start
        self._entry["elapsed_ms"] = round(elapsed * 1000, 1)
        router._upstream_seconds.observe(elapsed, replica=replica.name)
        router._hop_seconds.observe(elapsed, stage="stream")
        router._finish_attempt(replica)
        if outcome == "upstream_error":
            self._entry["error"] = detail or "stream aborted mid-body"
            self._entry["reason"] = "stream"
            replica.breaker.record_failure()
            router._req_total.inc(replica=replica.name, outcome="network_error")
        elif outcome == "aborted":
            self._entry["error"] = "client abandoned the stream"
            replica.breaker.record_success(probe=self._is_probe)
            router._req_total.inc(replica=replica.name, outcome="client_aborted")
        else:
            replica.breaker.record_success(probe=self._is_probe)
            router._req_total.inc(replica=replica.name, outcome="ok")

    def _install_attempt(self, replica: Any, streaming: Any,
                         entry: dict[str, Any], attempt_start: float,
                         is_probe: bool) -> bool:
        """Adopt a continuation upstream as the current attempt. Under
        the relay lock, and REFUSED once finalized: a client abort that
        landed while the hunt was mid-connect must not adopt (and then
        never settle) a fresh upstream — its outstanding mark and
        connection would leak forever."""
        with self._lock:
            if self._done:
                return False
            self._replica = replica
            self._streaming = streaming
            self._entry = entry
            self._attempt_start = attempt_start
            self._is_probe = is_probe
            self._scanner = _SSEEventScanner()
            # a continuation opened before ANYTHING reached the client
            # is indistinguishable from a fresh original attempt, and
            # must deliver like one: with _resumed set, _drain drops
            # id-less frames (only trustworthy from the original), so
            # an id-less continuation of a died-at-zero stream would
            # have every frame dropped and settle as a silently EMPTY
            # "ok" — exactly the truncation-masquerading-as-success the
            # resume contract exists to prevent
            self._resumed = self._saw_ids or self._delivered > 0
            self._attempt_settled = False
        return True

    # -- the resume hunt -------------------------------------------------------
    def _pick_resume_target(
        self, tried: set[str]
    ) -> Optional[tuple[Any, bool]]:
        """The originating replica first — it holds the generation
        journal (teacher-forced resume is nearly free there), and its
        PROBATION state counts as "coming back" rather than hard-out —
        then any healthy candidate the breaker admits. Replicas that
        already failed THIS hunt (``tried``) are skipped on the first
        pass and allowed back only as a last resort: the prober needs
        out_after×interval to evict a drained replica, and during that
        window the dead origin still LOOKS healthy — re-picking it
        every round burned the whole resume budget on connection
        refusals in milliseconds (the fleetsim harness surfaced exactly
        that: drained-mid-stream requests exhausting 4 resumes in 50 ms
        while healthy replicas sat idle)."""
        candidates: list[Any] = []
        if self._origin.state in (HEALTHY, PROBATION):
            candidates.append(self._origin)
        candidates.extend(
            r for r in self._router.replica_set.candidates(
                self._resume.affinity
            )
            if r.name != self._origin.name
        )
        for skip_tried in (True, False) if tried else (False,):
            for replica in candidates:
                if skip_tried and replica.name in tried:
                    continue
                grant = replica.breaker.try_acquire()
                if grant:
                    return replica, grant == breaker_mod.PROBE
        return None

    def _try_resume(self) -> bool:
        router = self._router
        if not self._saw_ids and self._delivered:
            # id-less frames already reached the client (e.g. a fan-out
            # stream): without ids a continuation cannot be spliced —
            # its frames would all be dropped and the truncation would
            # masquerade as success. Keep the abort contract. A stream
            # that died before ANY event was delivered is different:
            # resuming from 0 is trivially safe (nothing to splice
            # against), and refusing it turned every
            # wedge-before-first-token into a truncated client stream —
            # the fleetsim harness surfaced exactly that cohort.
            router._stream_resumes.inc(outcome="refused")
            return False
        # failed-attempt pacing, mirroring the forward retry loop: a
        # decorrelated-jitter sleep between failed continuations gives
        # the prober time to evict a dead origin (and a transient 5xx
        # burst time to pass) instead of spending the whole resume
        # budget inside one failure window
        tried: set[str] = set()
        delays = backoff_delays(router.max_resumes)
        while True:
            with self._lock:
                if self._done:
                    return False  # client already abandoned the stream
            remaining = self._resume.deadline - time.monotonic()
            if remaining <= 0.05 or self._resumes >= router.max_resumes:
                router._stream_resumes.inc(outcome="exhausted")
                return False
            picked = self._pick_resume_target(tried)
            if picked is None:
                # nothing admitted right now: the origin may be mid-
                # recovery (probation arrives within a probe interval)
                time.sleep(min(0.1, remaining))
                continue
            replica, is_probe = picked
            tried.add(replica.name)
            self._resumes += 1
            self._record["resumes"] = self._resumes
            router._retries_total.inc(
                replica=self._replica.name, reason="stream_resume"
            )
            headers = dict(self._resume.headers)
            headers["X-Resume-From"] = str(self._next_id)
            # hop provenance for the continuation: same router, the
            # attempt index this entry lands at, and the event id it
            # resumes from — the replica's FlightRecord origin block
            # then distinguishes "a fresh attempt" from "a splice".
            # traceparent rides _resume.headers untouched (stamped once
            # in _forward), so the continuation parents to the ORIGINAL
            # request span even from this pool thread.
            headers["X-Gofr-Hop"] = format_hop(
                router.router_id, len(self._record["attempts"]),
                self._next_id,
            )
            # a budgeted continuation gets the remaining budget, never
            # the original attempt's stale stamp; an opted-out stream
            # stays opted out
            if self._resume.budgeted:
                headers["X-Request-Deadline-Ms"] = str(
                    max(1, int(remaining * 1000))
                )
            entry: dict[str, Any] = {
                "replica": replica.name, "status": None, "error": None,
                "elapsed_ms": 0, "resume_from": self._next_id,
            }
            self._record["attempts"].append(entry)
            depth = replica.mark_dispatch()
            router._outstanding_gauge.set(float(depth), replica=replica.name)
            attempt_start = time.monotonic()
            try:
                streaming = replica.client.stream(
                    self._resume.method, self._resume.target,
                    body=self._resume.body, headers=headers,
                    connect_timeout=min(router.connect_timeout_s, remaining),
                    read_timeout=min(router.read_timeout_s, remaining),
                )
            except Exception as exc:
                entry["error"] = str(exc)
                entry["elapsed_ms"] = round(
                    (time.monotonic() - attempt_start) * 1000, 1
                )
                router._finish_attempt(replica)
                replica.breaker.record_failure()
                router._req_total.inc(
                    replica=replica.name, outcome="network_error"
                )
                self._hunt_pause(delays)
                continue
            status = streaming.status_code
            if status == 200:
                entry["status"] = 200
                if not self._install_attempt(
                    replica, streaming, entry, attempt_start, is_probe
                ):
                    # the client aborted while we connected: settle this
                    # never-adopted upstream and stop hunting
                    streaming.close()
                    router._finish_attempt(replica)
                    replica.breaker.record_success(probe=is_probe)
                    return False
                router._stream_resumes.inc(outcome="resumed")
                router._hop_seconds.observe(
                    time.monotonic() - attempt_start, stage="resume"
                )
                return True
            # non-200: drain bounded, close, judge
            try:
                streaming.read(budget_s=min(2.0, remaining))
            except Exception:
                pass  # the error body is best-effort evidence only
            streaming.close()
            entry["status"] = status
            entry["elapsed_ms"] = round(
                (time.monotonic() - attempt_start) * 1000, 1
            )
            router._finish_attempt(replica)
            if status >= 500:
                replica.breaker.record_failure()
                router._req_total.inc(
                    replica=replica.name, outcome="upstream_5xx"
                )
                self._hunt_pause(delays)
                continue
            # 4xx: the replica is healthy but refuses the resume
            # (non-resumable shape, journal gone AND determinism
            # rejected, …) — continuing elsewhere cannot help
            replica.breaker.record_success(probe=is_probe)
            router._stream_resumes.inc(outcome="refused")
            return False

    def _hunt_pause(self, delays: Any) -> None:
        """Sleep the hunt's next decorrelated-jitter delay, clipped to
        the remaining deadline (a hunt never sleeps past its budget —
        the loop head turns that into a clean ``exhausted``)."""
        delay = next(delays, None)
        if delay is None:
            return
        remaining = self._resume.deadline - time.monotonic()
        if remaining > 0.05:
            time.sleep(min(delay, remaining - 0.05))

    # -- terminal accounting ---------------------------------------------------
    def finish(self, outcome: str) -> None:
        """Async-bridge finalizer hook (client disconnect / task
        cancellation). After a NORMAL completion ``_finalize`` already
        ran — the idempotency guard makes this a no-op then."""
        del outcome  # the bridge only ever reports an abort
        self._settle_attempt_safe("aborted")
        self._finalize("aborted")

    def _settle_attempt_safe(self, outcome: str) -> None:
        with self._lock:
            if self._done:
                return
        self._settle_attempt(outcome)

    def _finalize(self, outcome: str) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
        router = self._router
        if outcome == "ok":
            router._finish_record(self._record, 200)
        else:
            router._finish_record(self._record, 499)
        router._release()


def _filter_return_headers(headers: dict[str, str]) -> dict[str, str]:
    """The response-header allowlist applied to BOTH the buffered and
    streaming forward paths."""
    return {
        name.title(): value
        for name, value in ((k.lower(), v) for k, v in headers.items())
        if name in _RETURN_HEADERS
    }


async def _sync_pull(iterator: Any, executor: Any = None,
                     finalizer: Any = None) -> Any:
    """Bridge a sync chunk generator onto the event loop: each ``next``
    is pulled on the container's I/O-sized handler pool so a slow
    upstream never stalls other connections (same rationale as the
    responder's Stream path — asyncio's cpu_count+4 default executor
    caps concurrent proxied streams on small VMs).

    The ``finally`` runs when this async generator is finalized (client
    disconnect / task cancellation → the loop's async-gen finalizer →
    GeneratorExit here): it settles the stream's accounting through the
    idempotent ``finalizer`` DIRECTLY — never through the sync
    generator, which may be suspended mid-``next`` on a pool thread.
    All inline work is socket close + metric writes, no blocking I/O."""
    import asyncio

    loop = asyncio.get_running_loop()
    it = iter(iterator)
    sentinel = object()
    try:
        while True:
            item = await loop.run_in_executor(executor, next, it, sentinel)
            if item is sentinel:
                break
            yield item
    finally:
        if finalizer is not None:
            # an abandoned stream is a CLIENT-side outcome, not a
            # replica failure; a normally-finished (or upstream-failed)
            # stream already settled — finish is then a no-op
            finalizer.finish("aborted")
        try:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        except ValueError:
            pass  # generator mid-next on a pool thread; it exits on its own
