"""Distributed tracing: spans, W3C trace-context propagation, Zipkin export
(copy of ``gofr_tpu/tracing.py``).

Span creation is always on: trace ids double as the access log's and the
``X-Correlation-ID`` header's ids. ``traceparent`` is injected and
extracted, and with ``TRACER_HOST`` set a background batch exporter posts
Zipkin JSON v2 to ``http://$TRACER_HOST:$TRACER_PORT/api/v2/spans`` (its
daemon thread drops spans on overflow and never blocks the caller; failed
posts count on ``gofr_tpu_trace_export_failures_total``).

Spans carry microsecond timestamps (Zipkin's unit). The current span is a
contextvar, so asyncio handlers and thread-pool handlers each see their own.
"""

from __future__ import annotations

import contextvars
import json
import queue
import secrets
import threading
import time
import urllib.request
from typing import Any, Optional

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "gofr_current_span", default=None
)

SERVER = "SERVER"
CLIENT = "CLIENT"
INTERNAL = None  # zipkin has no INTERNAL kind; omit


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "kind",
        "start_us", "end_us", "tags", "_tracer", "_token",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        kind: Optional[str],
        tracer: "Tracer",
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.kind = kind
        self.start_us = time.time_ns() // 1000
        self.end_us: Optional[int] = None
        self.tags: dict[str, str] = {}
        self._tracer = tracer
        self._token: Any = None

    def set_tag(self, key: str, value: Any) -> None:
        self.tags[key] = str(value)

    def end(self) -> None:
        if self.end_us is None:
            self.end_us = time.time_ns() // 1000
            self._tracer._finish(self)

    # context-manager sugar: ``with ctx.trace("name"):``
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        if exc is not None:
            self.set_tag("error", exc)
        self.end()
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_zipkin(self, service_name: str) -> dict[str, Any]:
        out: dict[str, Any] = {
            "traceId": self.trace_id,
            "id": self.span_id,
            "name": self.name,
            "timestamp": self.start_us,
            "duration": max(1, (self.end_us or self.start_us) - self.start_us),
            "localEndpoint": {"serviceName": service_name},
            "tags": self.tags,
        }
        if self.parent_id:
            out["parentId"] = self.parent_id
        if self.kind:
            out["kind"] = self.kind
        return out


class _NoopExporter:
    def export(self, span: Span) -> None:  # pragma: no cover - trivial
        pass

    def shutdown(self) -> None:  # pragma: no cover - trivial
        pass


class ZipkinExporter:
    """Background batch exporter: batches up to ``max_batch`` spans or
    ``flush_interval`` seconds, drops on queue overflow (export must never
    block the hot path)."""

    def __init__(
        self,
        endpoint: str,
        service_name: str = "gofr-app",
        max_batch: int = 128,
        flush_interval: float = 1.0,
        max_queue: int = 4096,
    ):
        self.endpoint = endpoint
        self.service_name = service_name
        self.max_batch = max_batch
        self.flush_interval = flush_interval
        self._queue: "queue.Queue[Optional[Span]]" = queue.Queue(maxsize=max_queue)
        self.post_failures = 0  # rejected/unreachable collector posts
        self._drop_counter: Any = None  # attach_metrics wires it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="gofr-zipkin", daemon=True)
        self._thread.start()

    def attach_metrics(self, metrics: Any) -> None:
        """Count exporter drops on the metrics registry: a dead/refusing
        collector silently eating spans was only visible by reading
        ``post_failures`` off the object — now an alert can watch it.
        Called after the container builds its registry (the exporter is
        constructed before metrics exist at init_tracer time)."""
        self._drop_counter = metrics.counter(
            "gofr_tpu_trace_export_failures_total",
            "zipkin span batches dropped: the collector POST failed "
            "(unreachable, refused, or timed out) — spans in the batch "
            "are lost; see also ZipkinExporter.post_failures",
        )

    def export(self, span: Span) -> None:
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            pass

    def shutdown(self) -> None:
        self._stop.set()
        try:  # wake the worker promptly; Event alone covers a full queue
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=2.0)

    def _run(self) -> None:
        batch: list[Span] = []
        deadline = time.monotonic() + self.flush_interval
        running = True
        while running:
            timeout = max(0.01, deadline - time.monotonic())
            try:
                item = self._queue.get(timeout=timeout)
                if item is None:
                    running = False
                else:
                    batch.append(item)
            except queue.Empty:
                pass
            if self._stop.is_set():
                running = False
                while len(batch) < self.max_batch:
                    try:
                        extra = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if extra is not None:
                        batch.append(extra)
            if batch and (
                len(batch) >= self.max_batch
                or time.monotonic() >= deadline or not running
            ):
                self._post(batch)
                batch = []
            if time.monotonic() >= deadline:
                deadline = time.monotonic() + self.flush_interval

    def _post(self, batch: list[Span]) -> None:
        body = json.dumps([s.to_zipkin(self.service_name) for s in batch]).encode()
        req = urllib.request.Request(
            self.endpoint, data=body, headers={"Content-Type": "application/json"}
        )
        try:
            urllib.request.urlopen(req, timeout=2.0).close()
        except Exception:
            # tracing must never take the app down — but a dead
            # collector should be diagnosable, so count the failures
            self.post_failures += 1
            if self._drop_counter is not None:
                self._drop_counter.inc()


class Tracer:
    """Creates spans and manages the current-span context."""

    def __init__(self, exporter: Any = None):
        self.exporter = exporter or _NoopExporter()

    def start_span(
        self,
        name: str,
        kind: Optional[str] = None,
        parent: Optional[Span] = None,
        traceparent: Optional[str] = None,
        activate: bool = True,
    ) -> Span:
        parent = parent or _current_span.get()
        trace_id = None
        parent_id = None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif traceparent:
            parsed = parse_traceparent(traceparent)
            if parsed:
                trace_id, parent_id = parsed
        if trace_id is None:
            trace_id = secrets.token_hex(16)
        span = Span(name, trace_id, secrets.token_hex(8), parent_id, kind, self)
        if activate:
            span._token = _current_span.set(span)
        return span

    def _finish(self, span: Span) -> None:
        self.exporter.export(span)

    def shutdown(self) -> None:
        self.exporter.shutdown()


def current_span() -> Optional[Span]:
    return _current_span.get()


def current_trace_id() -> Optional[str]:
    span = _current_span.get()
    return span.trace_id if span else None


def parse_traceparent(header: str) -> Optional[tuple[str, str]]:
    """Parse a W3C ``traceparent`` header -> (trace_id, span_id)."""
    parts = (header or "").strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


_global_tracer = Tracer()


def set_global_tracer(tracer: Tracer) -> None:
    global _global_tracer
    _global_tracer = tracer


def get_tracer() -> Tracer:
    return _global_tracer


def init_tracer(config: Any, logger: Any = None, service_name: str = "gofr-app") -> Tracer:
    """Always install a tracer; attach the Zipkin exporter only when
    ``TRACER_HOST`` is configured (``TRACER_PORT``, default 9411;
    ``APP_NAME`` names the service)."""
    host = config.get("TRACER_HOST")
    if host:
        port = config.get_or_default("TRACER_PORT", "9411")
        endpoint = f"http://{host}:{port}/api/v2/spans"
        name = config.get_or_default("APP_NAME", service_name)
        tracer = Tracer(ZipkinExporter(endpoint, service_name=name))
        if logger:
            logger.infof("exporting traces to zipkin at %s", endpoint)
    else:
        tracer = Tracer()
    set_global_tracer(tracer)
    return tracer

