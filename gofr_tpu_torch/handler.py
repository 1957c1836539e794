"""Handler adapter and built-in handlers (trimmed copy of
``gofr_tpu/handler.py``): health, readiness, ``/metrics``, the favicon,
the catch-all, and the LoRA adapter admin surface (``GET``/``POST
/admin/adapters``, ``DELETE /admin/adapters/{name}``) behind the optional
``ADMIN_TOKEN``. The adapter opens a "gofr-handler" span around each
handler; sync handlers run on the container's pool inside a copy of the
request's context, so the span (and its trace id) reaches their thread."""

from __future__ import annotations

import asyncio
import contextvars
import hmac
import inspect
import json
import uuid
from typing import Any, Callable

from gofr_tpu_torch import static
from gofr_tpu_torch.context import Context
from gofr_tpu_torch.errors import (
    HTTPError,
    InvalidParamError,
    RouteNotFoundError,
    UnauthenticatedError,
)
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.responder import respond
from gofr_tpu_torch.http.response import File, Response
from gofr_tpu_torch.tracing import get_tracer

Handler = Callable[[Context], Any]

# this process's identity on the readiness verdict: a restarted process
# (same address) answers with another id
BOOT_ID = uuid.uuid4().hex[:16]


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
    boot failed), 200 once requests would be served without waiting. (The
    JAX handler's watchdog and fleet branches come with those slices.)"""
    tpu = ctx.container.tpu
    if tpu is None or tpu.ready():
        status, state = 200, {"state": "ready", "boot_id": BOOT_ID}
    else:
        status, state = 503, dict(tpu.boot_status)
    return Response(
        status=status,
        headers={"Content-Type": "application/json"},
        body=json.dumps(state).encode("utf-8"),
    )


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
