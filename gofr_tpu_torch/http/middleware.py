"""HTTP middleware (copy of ``gofr_tpu/http/middleware.py``), installed by
``App`` outermost first:

- ``tracer_middleware``: a root SERVER span per request, named
  "METHOD /path", joined to an incoming ``traceparent``;
- ``logging_middleware``: a timed ``RequestLog`` access line (trace id,
  method, uri, client ip from ``X-Forwarded-For``, status, microseconds),
  the ``X-Correlation-ID`` response header from the trace id, and panic
  recovery: an exception escaping the handler becomes a logged stack and
  a JSON 500;
- ``metrics_middleware``: ``gofr_http_requests_total`` and
  ``gofr_http_request_duration_seconds`` by route pattern;
- ``cors_middleware``: permissive wildcard CORS with the OPTIONS
  short-circuit.

Middleware compose as ``mw(next_endpoint) -> endpoint`` over async
endpoints (``Router.use``).
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from typing import Any

from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.response import Response
from gofr_tpu_torch.http.router import Endpoint
from gofr_tpu_torch.tracing import SERVER, get_tracer


@dataclass
class RequestLog:
    """Typed access-log entry."""

    trace_id: str
    method: str
    uri: str
    ip: str
    status: int
    response_time_us: int
    user_agent: str = ""

    def pretty_terminal(self) -> str:
        color = 32 if self.status < 400 else (33 if self.status < 500 else 31)
        return (
            f"\x1b[{color}m{self.status}\x1b[0m "
            f"{self.method:<7s} {self.uri} {self.response_time_us}µs {self.ip}"
        )

    def log_fields(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "method": self.method,
            "uri": self.uri,
            "ip": self.ip,
            "status": self.status,
            "response_time_us": self.response_time_us,
            "user_agent": self.user_agent,
        }


def client_ip(request: Request) -> str:
    """The first ``X-Forwarded-For`` hop, else the peer address."""
    fwd = request.header("x-forwarded-for")
    if fwd:
        return fwd.split(",")[0].strip()
    return request.remote_addr


def tracer_middleware(next_ep: Endpoint) -> Endpoint:
    """Root server span per request."""

    async def endpoint(request: Request) -> Response:
        tracer = get_tracer()
        span = tracer.start_span(
            f"{request.method} {request.path}",
            kind=SERVER,
            traceparent=request.header("traceparent"),
        )
        try:
            response = await next_ep(request)
            span.set_tag("http.status_code", response.status)
            return response
        finally:
            span.__exit__(None, None, None)

    return endpoint


def logging_middleware(logger: Any) -> Any:
    """Access log + panic recovery."""

    def middleware(next_ep: Endpoint) -> Endpoint:
        async def endpoint(request: Request) -> Response:
            from gofr_tpu_torch.tracing import current_trace_id

            start = time.perf_counter()
            trace_id = current_trace_id() or ""
            try:
                response = await next_ep(request)
            except Exception:
                # panic recovery: JSON 500 + stack trace log
                logger.error(
                    {"error": "panic recovered",
                     "stack": traceback.format_exc(), "trace_id": trace_id}
                )
                response = Response(
                    status=500,
                    headers={"Content-Type": "application/json"},
                    body=b'{"error":{"message":"some unexpected error has occurred"}}',
                )
            elapsed_us = int((time.perf_counter() - start) * 1e6)
            if trace_id:
                response.headers.setdefault("X-Correlation-ID", trace_id)
            logger.info(
                RequestLog(
                    trace_id=trace_id,
                    method=request.method,
                    uri=request.target,
                    ip=client_ip(request),
                    status=response.status,
                    response_time_us=elapsed_us,
                    user_agent=request.header("user-agent"),
                )
            )
            return response

        return endpoint

    return middleware


def cors_middleware(next_ep: Endpoint) -> Endpoint:
    """Permissive CORS."""

    async def endpoint(request: Request) -> Response:
        if request.method == "OPTIONS":
            return Response(status=200, headers=dict(_CORS_HEADERS))
        response = await next_ep(request)
        response.headers.setdefault("Access-Control-Allow-Origin", "*")
        return response

    return endpoint


_CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, POST, PUT, PATCH, DELETE, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type, Authorization, Traceparent",
}


def metrics_middleware(registry: Any) -> Any:
    """Request counters + latency histogram for every route.

    The ``path`` label is the MATCHED ROUTE PATTERN the router records on
    the request (``/greet/{name}``, bounded cardinality) — never the raw
    URL, which would mint one series per distinct path-param value.
    Unrouted requests (404s) share one ``unmatched`` label. Exceptions
    escaping the inner chain count as status 500 instead of silently
    bypassing the counters (the outer logging middleware still converts
    them into the JSON 500)."""

    requests_total = registry.counter(
        "gofr_http_requests_total", "HTTP requests",
        labels=("method", "path", "status"),
    )
    duration = registry.histogram(
        "gofr_http_request_duration_seconds", "HTTP request latency",
        labels=("path",),
    )

    def middleware(next_ep: Endpoint) -> Endpoint:
        async def endpoint(request: Request) -> Response:
            start = time.perf_counter()
            status = "500"
            try:
                response = await next_ep(request)
                status = str(response.status)
                return response
            finally:
                path = getattr(request, "route_pattern", None) or "unmatched"
                duration.observe(time.perf_counter() - start, path=path)
                requests_total.inc(
                    method=request.method, path=path, status=status
                )

        return endpoint

    return middleware
