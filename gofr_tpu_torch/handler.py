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
/admin/profiler/start|stop``). The adapter opens a "gofr-handler" span around each
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
from gofr_tpu_torch.errors import (
    EntityNotFoundError,
    HTTPError,
    InvalidParamError,
    RouteNotFoundError,
    UnauthenticatedError,
)
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.responder import respond
from gofr_tpu_torch.http.response import File, Response
from gofr_tpu_torch.profiling import profiler
from gofr_tpu_torch.telemetry import BOOT_ID
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
    JAX handler's fleet branch comes with the fleet.)"""
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
