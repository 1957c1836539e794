"""Handler adapter and built-in handlers (trimmed copy of
``gofr_tpu/handler.py``): health, readiness, ``/metrics``, the favicon,
the catch-all, and the admin surface behind the optional ``ADMIN_TOKEN``:
LoRA adapters (``GET``/``POST /admin/adapters``, ``DELETE
/admin/adapters/{name}``), the flight recorder (``/admin/requests``,
``/admin/slo``, ``/admin/tenants``), the SLO engine
(``/admin/slo/budget``), engine introspection (``/admin/engine``,
``/admin/dispatches``), the cost model (``/admin/costmodel``,
``/admin/anomalies``), the timebase (``/admin/timeseries``,
``/admin/overview``), the postmortem store (``GET``/``POST
/admin/postmortem``) and the profiler (``GET /admin/profiler``, ``POST
/admin/profiler/start|stop``), the donor side of a KV pull (``GET
/admin/kv/{hash}``) and, on a router, the fleet pages (``/admin/fleet``,
``/admin/fleet/trace/{id}``, ``/admin/fleet/overview``). The adapter opens a "gofr-handler" span around each
handler; sync handlers run on the container's pool inside a copy of the
request's context, so the span (and its trace id) reaches their thread."""

from __future__ import annotations

import asyncio
import contextvars
import hmac
import inspect
import json
import time
from typing import Any, Callable

from gofr_tpu_torch import static
from gofr_tpu_torch.context import Context
from gofr_tpu_torch.anomaly import ANOMALY_CAUSES
from gofr_tpu_torch.deadline import parse_deadline
from gofr_tpu_torch.errors import (
    EntityNotFoundError,
    HTTPError,
    InvalidParamError,
    RouteNotFoundError,
    UnauthenticatedError,
)
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.responder import respond
from gofr_tpu_torch.fleet import trace as fleet_trace
from gofr_tpu_torch.fleet.kvwire import CONTENT_TYPE, encode_block, encode_header, encode_trailer
from gofr_tpu_torch.http.response import File, Response
from gofr_tpu_torch.profiling import profiler
from gofr_tpu_torch.telemetry import BOOT_ID, sanitize_request_id
from gofr_tpu_torch.tpu.introspect import DISPATCH_KINDS
from gofr_tpu_torch.tracing import get_tracer

Handler = Callable[[Context], Any]


def make_endpoint(func: Handler, container: Any) -> Callable:
    """Adapt ``handler(ctx) -> result`` into an async router endpoint. Sync
    handlers run on the container's thread pool (a generation blocks its
    thread for the whole decode)."""
    is_async = inspect.iscoroutinefunction(func)

    async def endpoint(request: Request) -> Response:
        ctx = Context(request, container)
        with get_tracer().start_span("gofr-handler"):
            try:
                if is_async:
                    result = await func(ctx)
                else:
                    loop = asyncio.get_running_loop()
                    # the active span reaches the worker thread
                    call = contextvars.copy_context().run
                    result = await loop.run_in_executor(
                        container.handler_executor, call, func, ctx
                    )
                error = None
            except Exception as exc:  # handler errors -> enveloped response
                result, error = None, exc
        if error is not None and not hasattr(error, "status_code"):
            container.logger.errorf(
                "handler error on %s %s: %r", request.method, request.path, error
            )
        return respond(result, error, executor=container.handler_executor)

    return endpoint


def health_handler(ctx: Context) -> Any:
    return ctx.container.health()


def favicon_handler(_: Context) -> File:
    return File(content=static.favicon(), content_type="image/x-icon")


def catch_all_handler(_: Context) -> None:
    raise RouteNotFoundError()


def ready_handler(ctx: Context) -> Response:
    """Readiness, distinct from health (liveness): 200 with no device, 503
    with the boot's state and stage while the device boots (or after its
    boot failed, or while a recovery rebuilds it), 503 with the engine
    state and the watchdog's evidence (the kinds that stalled, what it
    still watches) while a stalled wait holds the engine degraded or
    wedged, 200 once requests would be served without waiting. A 503 also
    carries the recovery incident while one is live or has happened. (The
    router's drain answers 503 first: new work must go to another front
    door.)"""
    fleet = getattr(ctx.container, "fleet", None)
    if fleet is not None and fleet.draining:
        return Response(
            status=503,
            headers={"Content-Type": "application/json"},
            body=json.dumps({
                "state": "draining",
                "detail": f"router draining, {fleet.in_flight} in flight",
            }).encode("utf-8"),
        )
    tpu = ctx.container.tpu
    if tpu is None:
        status, state = 200, {"state": "ready", "boot_id": BOOT_ID}
    elif not tpu.ready():
        status, state = 503, dict(tpu.boot_status)
        _attach_recovery_evidence(tpu, state)
    elif tpu.engine.state in ("degraded", "wedged", "recovering"):
        snap = tpu.engine.snapshot()
        wsnap = tpu.watchdog.snapshot()
        status = 503
        state = {
            "state": snap["state"], "detail": snap["detail"],
            "watchdog": {
                "stalls": wsnap.get("stalls"),
                "watching": wsnap.get("watching"),
                "timeout_s": wsnap.get("timeout_s"),
            },
        }
        _attach_recovery_evidence(tpu, state)
    else:
        status, state = 200, {"state": "ready", "boot_id": BOOT_ID}
    return Response(
        status=status,
        headers={"Content-Type": "application/json"},
        body=json.dumps(state).encode("utf-8"),
    )


def _attach_recovery_evidence(tpu: Any, state: dict) -> None:
    """The recovery incident for a readiness 503 (the ``/admin/engine``
    block's probe-sized part), while one is live or has history: a
    never-wedged server's body stays as it was."""
    snap = tpu.recovery.snapshot()
    if snap["state"] == "idle" and not snap["incidents"]:
        return
    state["recovery"] = {
        "state": snap["state"],
        "attempts": snap["attempts"],
        "max_attempts": snap["max_attempts"],
        "backoff_in_s": snap["backoff_in_s"],
        "last_outcome": snap["last_outcome"],
    }


def metrics_handler(ctx: Context) -> Response:
    """Prometheus text exposition, content-negotiated: ``Accept:
    application/openmetrics-text`` gets OpenMetrics 1.0 (histogram bucket
    exemplars and the closing ``# EOF``), everyone else text 0.0.4."""
    accept = ctx.request.header("Accept") or ""
    openmetrics = "application/openmetrics-text" in accept
    content_type = (
        "application/openmetrics-text; version=1.0.0; charset=utf-8"
        if openmetrics
        else "text/plain; version=0.0.4; charset=utf-8"
    )
    return Response(
        status=200,
        headers={"Content-Type": content_type},
        body=ctx.container.metrics.expose(openmetrics=openmetrics).encode("utf-8"),
    )


def _check_admin(ctx: Context) -> None:
    """ADMIN_TOKEN (optional) gates the admin surface: when it is set,
    requests need ``Authorization: Bearer <token>``. Unset keeps the
    routes open, as the JAX package's built-in ones are."""
    token = ctx.config.get("ADMIN_TOKEN")
    if not token:
        return
    header = ctx.header("Authorization") or ""
    # compare BYTES: compare_digest raises TypeError on a non-ASCII str (a
    # mangled header must 401, not 500)
    expected = f"Bearer {token}".encode("utf-8")
    if not hmac.compare_digest(header.encode("utf-8", "replace"), expected):
        raise UnauthenticatedError("admin token required")


def _admin_device(ctx: Context) -> Any:
    _check_admin(ctx)
    if ctx.tpu is None:
        raise HTTPError(503, "no model configured (set MODEL_NAME)")
    return ctx.tpu


def adapters_list_handler(ctx: Context) -> Any:
    return {"adapters": _admin_device(ctx).list_adapters()}


def adapter_load_handler(ctx: Context) -> Any:
    """POST /admin/adapters {name, path}: load a LoRA adapter artifact over
    the serving base at runtime (no restart, no second copy of the base)."""
    dev = _admin_device(ctx)
    body = ctx.bind() if ctx.request.body else {}
    if not isinstance(body, dict) or "name" not in body or "path" not in body:
        raise InvalidParamError('body (expected {"name": ..., "path": ...})')
    return {"adapters": dev.load_adapter(body["name"], body["path"])}


def adapter_unload_handler(ctx: Context) -> Any:
    return {"adapters": _admin_device(ctx).unload_adapter(ctx.path_param("name"))}


# -- the flight recorder, engine introspection and the cost model --------------

def _query_flag(ctx: Context, name: str) -> Any:
    """Tri-state query flag: absent -> None; present empty or truthy
    (?slow=, ?slow=1, ?slow=true) -> True; false/0/no -> False."""
    if name not in ctx.request.query:
        return None
    return ctx.param(name).strip().lower() not in ("false", "0", "no")


def _limit(ctx: Context, default: str) -> int:
    try:
        limit = int(ctx.param("limit") or default)
    except ValueError:
        raise InvalidParamError('"limit" must be an integer') from None
    if limit < 1:
        raise InvalidParamError('"limit" must be >= 1')
    return limit


def requests_admin_handler(ctx: Context) -> Any:
    """GET /admin/requests: recent flight records, newest first.
    ``?slow=``/``?errored=`` filter (the side buffer keeps flagged requests
    after ring eviction); ``?request_id=``/``?trace_id=``/``?tenant=``
    match exactly; ``?limit=`` bounds the page (default 100)."""
    _check_admin(ctx)
    records = ctx.container.telemetry.records(
        slow=_query_flag(ctx, "slow"),
        errored=_query_flag(ctx, "errored"),
        limit=_limit(ctx, "100"),
        request_id=ctx.param("request_id") or None,
        trace_id=ctx.param("trace_id") or None,
        tenant=ctx.param("tenant") or None,
    )
    return {"requests": records, "count": len(records)}


def slo_admin_handler(ctx: Context) -> Any:
    """GET /admin/slo: rolling-window per-model p50/p95/p99 TTFT and TPOT
    from the flight records (exact sample percentiles); ``?window=``
    seconds (default 300)."""
    _check_admin(ctx)
    try:
        window = float(ctx.param("window") or "300")
    except ValueError:
        raise InvalidParamError('"window" must be a number of seconds') from None
    if window <= 0:
        raise InvalidParamError('"window" must be > 0')
    return ctx.container.telemetry.slo(window_s=window)


def slo_budget_handler(ctx: Context) -> Any:
    """GET /admin/slo/budget: every objective (``SLO_TARGETS``) with its
    windowed burn rates, the budget left over the long window, its alert
    states and the latest burn evidence from the anomaly ring."""
    _check_admin(ctx)
    if ctx.container.slo is None:
        raise HTTPError(503, "slo engine disabled (set SLO=on)")
    return ctx.container.slo.budget()


def tenants_admin_handler(ctx: Context) -> Any:
    """GET /admin/tenants: the tenant ledger's top tenants by tokens (exact
    counts), the rest in ``~other``; ``?tenant=`` looks one up (404 when it
    is not tracked), ``?limit=`` bounds the ranking (default 50). Tenant
    ids are hashed (``key-<sha256 prefix>``), never raw keys."""
    _check_admin(ctx)
    ledger = ctx.container.tenants
    tenant = ctx.param("tenant") or None
    if tenant is not None:
        entry = ledger.get(tenant)
        if entry is None:
            raise EntityNotFoundError(
                f"tenant '{tenant}' is not tracked (unseen, or folded "
                "into ~other by the top-K sketch)"
            )
        return {"tenant": entry, "stats": ledger.stats()}
    return ledger.snapshot(k=_limit(ctx, "50"))


def engine_admin_handler(ctx: Context) -> Any:
    """GET /admin/engine: the engine's state and history, boot timeline,
    watchdog, recovery, journal, brownout, dispatch counts, queue depth,
    pool occupancy, scheduler, caches and device memory, with the SLO and
    tenant headlines. Host reads only: it answers while the engine is
    wedged."""
    dev = _admin_device(ctx)
    snap = dev.engine_snapshot()
    if ctx.container.slo is not None:
        snap["slo"] = ctx.container.slo.headline()
    snap["tenants"] = ctx.container.tenants.overview()
    return snap


def dispatches_admin_handler(ctx: Context) -> Any:
    """GET /admin/dispatches: recent dispatch records, newest first;
    ``?kind=`` filters, ``?limit=`` bounds the page (default 100). A
    dispatch in flight (or stuck) shows with status "running"."""
    dev = _admin_device(ctx)
    limit = _limit(ctx, "100")
    kind = ctx.param("kind") or None
    if kind is not None and kind not in DISPATCH_KINDS:
        raise InvalidParamError(f'"kind" must be one of {", ".join(DISPATCH_KINDS)}')
    records = dev.timeline.records(limit=limit, kind=kind)
    return {"dispatches": records, "count": len(records)}


def costmodel_admin_handler(ctx: Context) -> Any:
    """GET /admin/costmodel: the calibration in force, every cost sheet
    (analytic or synthetic), the families' residual EMAs, the thresholds,
    the anomaly ring's stats and the anomaly-rate trend from the
    timebase."""
    dev = _admin_device(ctx)
    if dev.costmodel is None:
        raise HTTPError(503, "cost model disabled (set COSTMODEL=on)")
    out = dev.costmodel.snapshot()
    out["anomalies_per_sec"] = _trend(
        ctx.container.timebase.rate_total("gofr_tpu_dispatch_anomalies_total")
    )
    return out


def anomalies_admin_handler(ctx: Context) -> Any:
    """GET /admin/anomalies: the cost model's anomaly events, newest first
    (``slow_dispatch``, ``ema_drift``) and the SLO engine's burn alerts
    (``slo_fast_burn``, ``slo_slow_burn``) in one ring; ``?kind=``/
    ``?cause=`` filter, ``?limit=`` bounds the page (default 100). A
    healthy process serves an empty list. Without a cost model the ring is
    the SLO engine's own."""
    _check_admin(ctx)
    costmodel = getattr(ctx.tpu, "costmodel", None)
    slo = ctx.container.slo
    ring = costmodel.ring if costmodel is not None else (slo.ring if slo is not None else None)
    if ring is None:
        raise HTTPError(503, "no anomaly ring on this process (set COSTMODEL=on or SLO=on)")
    limit = _limit(ctx, "100")
    cause = ctx.param("cause") or None
    if cause is not None and cause not in ANOMALY_CAUSES:
        raise InvalidParamError(f'"cause" must be one of {", ".join(ANOMALY_CAUSES)}')
    events = ring.events(limit=limit, kind=ctx.param("kind") or None, cause=cause)
    return {"anomalies": events, "count": len(events), "stats": ring.stats()}


def timeseries_admin_handler(ctx: Context) -> Any:
    """GET /admin/timeseries: a metric's history from the timebase ring.
    ``?metric=`` (required) names a registered metric; ``?labels=k:v,...``
    filters label-sets by subset; ``?window=`` bounds the lookback in
    seconds (default the whole ring). Counters and histograms carry a
    per-second ``rate`` series beside the raw points."""
    _check_admin(ctx)
    metric = ctx.param("metric")
    if not metric:
        raise InvalidParamError('"metric" is required (a registered metric name)')
    labels: dict[str, str] = {}
    for part in (ctx.param("labels") or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, found, value = part.partition(":" if ":" in part else "=")
        if not found or not name:
            raise InvalidParamError('"labels" must be comma-separated name:value pairs')
        labels[name.strip()] = value.strip()
    window = None
    raw_window = ctx.param("window")
    if raw_window:
        try:
            window = float(raw_window)
        except ValueError:
            raise InvalidParamError('"window" must be a number of seconds') from None
        if window <= 0:
            raise InvalidParamError('"window" must be > 0')
    timebase = ctx.container.timebase
    result = timebase.series(metric, labels=labels or None, window=window)
    if result is None:
        raise InvalidParamError(
            f'metric "{metric}" unknown to the timebase (not registered, or no snapshot '
            "taken yet)"
        )
    result["timebase"] = timebase.stats()
    return result


def overview_admin_handler(ctx: Context) -> Any:
    """GET /admin/overview: the one-page rollup: engine state, req/s and
    TTFT p95 trends from the timebase, the SLO view and headline, requests
    in flight, tenants, the watchdog, dispatches, the cost model and its
    anomaly trend, queue depth, pool occupancy, compile and cache counts,
    and the newest postmortems. Host reads only: it answers while wedged."""
    _check_admin(ctx)
    container = ctx.container
    timebase = container.timebase
    out: dict[str, Any] = {
        "ts": time.time(),
        "timebase": timebase.stats(),
        "requests_in_flight": container.telemetry.active_count(),
        "slo": container.telemetry.slo(window_s=300.0),
        "req_per_sec": _trend(timebase.rate_total("gofr_http_requests_total")),
        "ttft_p95_s": _trend(timebase.hist_quantile_trend("gofr_tpu_ttft_seconds", 0.95)),
        "postmortems": container.postmortem.list()[-5:],
        "slo_budget": container.slo.headline() if container.slo is not None else None,
        "tenants": container.tenants.overview(),
    }
    tpu = container.tpu
    if tpu is None:
        out["engine"] = None
        return out
    engine = tpu.engine.snapshot()
    out["engine"] = {"state": engine["state"], "detail": engine["detail"],
                     "since": engine["since"]}
    out["model"] = tpu.model_name
    out["platform"] = tpu.platform
    out["watchdog"] = tpu.watchdog.snapshot()
    out["dispatches"] = tpu.timeline.stats()
    out["costmodel"] = None
    if tpu.costmodel is not None:
        out["costmodel"] = tpu.costmodel.overview()
        out["anomalies_per_sec"] = _trend(
            timebase.rate_total("gofr_tpu_dispatch_anomalies_total")
        )
    out["queue_depth"] = tpu.batcher._depth() if tpu.batcher is not None else None
    out["decode_pool"] = tpu.decode_pool.occupancy() if tpu.decode_pool is not None else None
    registry = container.metrics
    out["compiles_total"] = sum(
        registry.counter("gofr_tpu_compiles_total", labels=("kind",)).data().values()
    )
    cache_counter = registry.counter("gofr_tpu_cache_events_total", labels=("cache", "event"))
    out["cache_events"] = {"/".join(k): v for k, v in cache_counter.data().items()}
    return out


def _trend(points: list) -> dict[str, Any]:
    """A trend series and its latest value (the rollup's headline)."""
    return {"now": points[-1][1] if points else None, "trend": points}


def fleet_admin_handler(ctx: Context) -> Any:
    """GET /admin/fleet: the fleet front door on one page — rotation
    state + probe evidence per replica, breaker states, outstanding
    depths, quota stats, drain status, and the recent route records
    (which replica served each request, retries, shed verdicts).
    Registered by ``gofr_tpu_torch.fleet.wire_fleet``; 503 on a process that
    is not a router."""
    _check_admin(ctx)
    fleet = getattr(ctx.container, "fleet", None)
    if fleet is None:
        raise HTTPError(503, "fleet not configured (set FLEET_REPLICAS)")
    snapshot = fleet.snapshot()
    request_id = ctx.param("request_id") or ctx.param("trace_id") or None
    try:
        limit = int(ctx.param("limit") or "0")
    except ValueError:
        raise InvalidParamError('"limit" must be an integer') from None
    if request_id:
        snapshot["routes"] = fleet.records(
            request_id=request_id, limit=limit or 50
        )
    elif limit > 0:
        # trace capture pages deeper than the default view
        snapshot["routes"] = fleet.records(limit=limit)
    return snapshot


def fleet_trace_handler(ctx: Context) -> Any:
    """GET /admin/fleet/trace/{id}: ONE causal timeline for a request id
    across every process it touched — the router's route record joined
    with each attempt's replica-side flight record (matched on the
    ``origin`` block the X-Gofr-Hop header stamped) and the KV-transfer
    ledger entries from donor and receiver, plus a latency decomposition
    (router overhead / replica queue / device TTFT / stream). A replica
    that is down or mid-restart degrades the trace to
    ``partial: true`` with the gap named — never a 500."""
    _check_admin(ctx)
    fleet = getattr(ctx.container, "fleet", None)
    if fleet is None:
        raise HTTPError(503, "fleet not configured (set FLEET_REPLICAS)")
    request_id = sanitize_request_id(ctx.request.path_param("id"))
    if request_id is None:
        raise InvalidParamError(
            '"id" must be a request id ([A-Za-z0-9._-], <= 64 chars)'
        )
    routes = fleet.records(limit=10, request_id=request_id)
    if not routes:
        raise HTTPError(
            404,
            f"no route record for request id '{request_id}' "
            "(expired from the ring, or served by another router)",
        )
    route = routes[0]  # newest first: the latest routing of this id
    timeout_s = float(
        ctx.container.config.get_or_default("FLEET_TRACE_SCRAPE_TIMEOUT_S", "1")
    )
    evidence = fleet_trace.gather_evidence(
        fleet, request_id, route, timeout_s=timeout_s
    )
    return fleet_trace.assemble(request_id, route, **evidence)


def fleet_overview_handler(ctx: Context) -> Any:
    """GET /admin/fleet/overview: the fleet-wide ops rollup — one page
    built from evidence the router already holds (replica snapshots and
    the prober's piggybacked engine scrapes) plus the router's own
    timebase trends. No fan-out scrape on request: a replica that
    stopped answering shows its last-scraped state, it does not stall
    the overview. The per-process ``/admin/overview`` stays the
    deep-dive; this is the incident headline across N replicas."""
    _check_admin(ctx)
    container = ctx.container
    fleet = getattr(container, "fleet", None)
    if fleet is None:
        raise HTTPError(503, "fleet not configured (set FLEET_REPLICAS)")
    states: dict[str, int] = {}
    restarts = 0
    kv_free = kv_total = 0
    kv_seen = False
    transfers: dict[str, int] = {}
    brownout_max = 0
    anomalies_total = 0
    anomalies_seen = False
    slo_alerting: list[dict[str, Any]] = []
    slo_worst_burn = None
    slo_worst_replica = None
    slo_budget_min = None
    slo_alerts_total = 0
    slo_seen = False
    tenant_totals: dict[str, dict[str, int]] = {}
    tenants_tracked = 0
    replicas = []
    for replica in fleet.replica_set.replicas:
        snap = replica.snapshot()
        state = snap.get("state") or "unknown"
        states[state] = states.get(state, 0) + 1
        restarts += int(snap.get("restarts") or 0)
        engine = snap.get("engine") or {}
        if isinstance(engine.get("kv_free"), int) and isinstance(
            engine.get("kv_total"), int
        ):
            kv_seen = True
            kv_free += engine["kv_free"]
            kv_total += engine["kv_total"]
        ledger = engine.get("kv_transfer") or {}
        for outcome, count in ledger.items():
            # outcome counters only: skip the recents lists and the
            # `enabled` bool (bool IS an int to isinstance)
            if isinstance(count, int) and not isinstance(count, bool):
                transfers[outcome] = transfers.get(outcome, 0) + count
        level = engine.get("brownout_level")
        if isinstance(level, int):
            brownout_max = max(brownout_max, level)
        anomalies = engine.get("anomalies")
        if isinstance(anomalies, int) and not isinstance(anomalies, bool):
            anomalies_seen = True
            anomalies_total += anomalies
        # SLO + tenant rollup off the same piggybacked engine scrape —
        # router-side aggregation only, never a fan-out on request
        slo = engine.get("slo") or {}
        burn = slo.get("worst_burn")
        if isinstance(burn, (int, float)) and not isinstance(burn, bool):
            slo_seen = True
            if slo_worst_burn is None or burn > slo_worst_burn:
                slo_worst_burn = burn
                slo_worst_replica = snap.get("name")
        remaining = slo.get("budget_remaining_min")
        if isinstance(remaining, (int, float)) and not isinstance(
            remaining, bool
        ):
            if slo_budget_min is None or remaining < slo_budget_min:
                slo_budget_min = remaining
        for objective in slo.get("alerting") or []:
            slo_alerting.append(
                {"replica": snap.get("name"), "objective": objective}
            )
        slo_alerts_total += int(slo.get("alerts_total") or 0)
        tenants = engine.get("tenants") or {}
        tenants_tracked += int(tenants.get("tracked") or 0)
        for row in tenants.get("top") or []:
            name = row.get("tenant")
            if not name:
                continue
            agg = tenant_totals.setdefault(
                name, {"requests": 0, "tokens": 0, "sheds": 0}
            )
            for field in ("requests", "tokens", "sheds"):
                agg[field] += int(row.get(field) or 0)
        replicas.append({
            "name": snap.get("name"),
            "state": state,
            "role": snap.get("role"),
            "outstanding": snap.get("outstanding"),
            "saturated": snap.get("saturated"),
            "restarts": snap.get("restarts"),
            "queue_depth": engine.get("queue_depth"),
            "kv_free": engine.get("kv_free"),
            "kv_total": engine.get("kv_total"),
            "brownout_level": level,
            # cost-model residual watchtower, per replica: which box is
            # blowing its predictions (scraped off /admin/engine)
            "anomalies": anomalies,
            "worst_residual_ema": engine.get("worst_residual_ema"),
            # SLO headline per replica: which box is burning its budget
            "slo_worst_burn": slo.get("worst_burn"),
            "slo_alerting": slo.get("alerting"),
            "tenants_tracked": tenants.get("tracked"),
        })
    timebase = container.timebase
    return {
        "ts": time.time(),
        "router_id": fleet.router_id,
        "replicas": replicas,
        "states": states,
        "restarts_total": restarts,
        "kv_utilization": (
            round(1.0 - kv_free / kv_total, 4)
            if kv_seen and kv_total else None
        ),
        "kv_free": kv_free if kv_seen else None,
        "kv_total": kv_total if kv_seen else None,
        "kv_transfers": transfers,
        "brownout_level_max": brownout_max,
        "anomalies_total": anomalies_total if anomalies_seen else None,
        "slo": {
            "worst_burn": slo_worst_burn,
            "worst_replica": slo_worst_replica,
            "budget_remaining_min": slo_budget_min,
            "alerting": slo_alerting,
            "alerts_total": slo_alerts_total,
        } if slo_seen else None,
        "tenants": {
            "tracked": tenants_tracked,
            # fleet-wide top talkers: per-replica top lists merged and
            # re-ranked by token volume (exact within what each replica's
            # sketch tracked)
            "top": sorted(
                (dict(v, tenant=k) for k, v in tenant_totals.items()),
                key=lambda row: (row["tokens"], row["requests"]),
                reverse=True,
            )[:5],
        },
        "req_per_sec": _trend(
            timebase.rate_total("gofr_tpu_router_requests_total")
        ),
        "upstream_p95_s": _trend(
            timebase.hist_quantile_trend("gofr_tpu_router_upstream_seconds", 0.95)
        ),
        "in_flight": fleet.in_flight,
        "draining": fleet.draining,
    }


def kv_export_handler(ctx: Context) -> Response:
    """GET /admin/kv/{hash}: the donor side of a cross-replica paged-KV
    transfer (disaggregated prefill/decode). Serves the cached block
    table whose prompt hashes to ``{hash}`` in the kvwire format —
    versioned header, per-block CRC frames, mandatory trailer — so the
    pulling replica can detect truncation, corruption, and version
    skew and fall back to local prefill.

    Contract points the fleet depends on:

    - the entry's blocks are PINNED (increfed) for the duration of the
      stream and released when the response closes — an aborted pull
      never leaks refcounts, and a dead serving thread is covered by
      the pin's own bounded-lifetime timer (``KV_TRANSFER_PIN_TTL_S``);
    - the request's deadline budget applies (``X-Request-Deadline-Ms``,
      default ``KV_TRANSFER_TIMEOUT_S``): an expired budget stops the
      stream mid-body — a deliberate truncation the receiver detects;
    - 404 when the entry was evicted between advertise and pull (or
      was never here, or transfer is off) — never a 500."""
    _check_admin(ctx)
    tpu = ctx.container.tpu
    if tpu is None:
        raise HTTPError(503, "tpu not configured (set MODEL_NAME)")
    if not getattr(tpu, "kv_transfer_enabled", False):
        raise HTTPError(404, "KV transfer disabled (KV_TRANSFER=off)")
    prompt_hash = (ctx.request.path_param("hash") or "").strip().lower()
    if not prompt_hash or len(prompt_hash) > 64 or any(
        c not in "0123456789abcdef" for c in prompt_hash
    ):
        raise InvalidParamError('"hash" must be a hex prompt hash')
    default_s = float(
        ctx.container.config.get_or_default("KV_TRANSFER_TIMEOUT_S", "2")
    )
    deadline = parse_deadline(
        ctx.request.header("X-Request-Deadline-Ms"), default_s
    )
    # the requesting id (the receiver forwards its own origin id):
    # lands in the donor's served ledger so /admin/fleet/trace/<id>
    # can show which donor streamed this request's warm blocks
    export = tpu.kv_export(
        prompt_hash,
        request_id=sanitize_request_id(
            ctx.request.header("X-Gofr-Request-Id")
        ) or "",
    )
    if export is None:
        raise HTTPError(
            404,
            f"no cached KV for {prompt_hash} (evicted between advertise "
            "and pull, never seen here, or paged KV inactive)",
        )
    spec, table, arena, pin = export
    n_blocks = int(spec["n_blocks"])

    executor = ctx.container.handler_executor

    async def frames() -> Any:
        # runs on the event loop after the handler returns; the pin is
        # released on EVERY exit — completion, client abort (the server
        # acloses the stream), or an exception — and the TTL timer
        # backstops a loop that never finalizes this generator
        loop = asyncio.get_running_loop()
        try:
            yield encode_header(spec)
            for j in range(n_blocks):
                if pin.expired:
                    return  # the TTL guard took the blocks back
                if deadline is not None and deadline.expired():
                    return  # budget spent: truncate; the receiver's
                    # trailer check turns this into a clean fallback
                # a device arena's per-block export is a synchronous
                # device-to-host copy: off the serving loop, on the handler
                # executor, or every concurrent stream on the donor stalls
                # per block
                payload = await loop.run_in_executor(
                    executor, arena.export_block_payload, table, j
                )
                yield encode_block(j, payload)
            yield encode_trailer(n_blocks)
        finally:
            pin.release()

    return Response(
        status=200,
        headers={"Content-Type": CONTENT_TYPE},
        stream=frames(),
    )


def postmortem_list_handler(ctx: Context) -> Any:
    """GET /admin/postmortem: the bundles on disk."""
    _check_admin(ctx)
    store = ctx.container.postmortem
    return {"dir": store.directory, "bundles": store.list()}


def postmortem_trigger_handler(ctx: Context) -> Any:
    """POST /admin/postmortem: write a bundle now (the operator's trigger,
    past the automatic rate limit); an optional ``{"detail": "..."}``
    annotates it."""
    _check_admin(ctx)
    detail = ""
    try:
        body = ctx.bind() if ctx.request.body else {}
        if isinstance(body, dict):
            detail = str(body.get("detail") or "")
    except Exception:
        pass  # a garbage body: an unannotated bundle still helps
    path = ctx.container.postmortem.write(reason="manual", detail=detail, force=True)
    if path is None:
        raise HTTPError(500, "postmortem write failed (see server log)")
    return {"path": path, "reason": "manual"}


# -- the profiler ----------------------------------------------------------------

def _profiler_gauge(ctx: Context) -> Any:
    """1 while a trace captures: a trace left running slows serving and
    fills the disk, so it must be alertable."""
    return ctx.container.metrics.gauge(
        "gofr_tpu_profiler_active",
        "1 while a torch.profiler trace is capturing (0 otherwise)",
    )


def profiler_status_handler(ctx: Context) -> Any:
    _check_admin(ctx)
    status = profiler().status()
    _profiler_gauge(ctx).set(1.0 if status["state"] == "tracing" else 0.0)
    return status


def profiler_start_handler(ctx: Context) -> Any:
    """POST /admin/profiler/start [{"dir": ...}]: 409 while a trace runs."""
    _check_admin(ctx)
    body = ctx.bind() if ctx.request.body else {}
    if not isinstance(body, dict):
        raise InvalidParamError('body (expected {"dir": ...} or empty)')
    try:
        out = profiler().start(body.get("dir"), default_dir=ctx.config.get("PROFILE_DIR"))
    except RuntimeError as exc:
        raise HTTPError(409, str(exc)) from exc
    _profiler_gauge(ctx).set(1.0)
    return out


def profiler_stop_handler(ctx: Context) -> Any:
    """POST /admin/profiler/stop: the trace's directory and files; 409 when
    none runs."""
    _check_admin(ctx)
    try:
        out = profiler().stop()
    except RuntimeError as exc:
        raise HTTPError(409, str(exc)) from exc
    _profiler_gauge(ctx).set(0.0)
    return out
