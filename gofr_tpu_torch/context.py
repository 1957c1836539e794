"""Per-request Context handed to every handler (copy of
``gofr_tpu/context.py``): the request plus the container, with ``ctx.tpu``
exposing the inference device, ``ctx.redis`` and ``ctx.db`` the
datasources, ``ctx.get_http_service(name)`` a registered service client,
``ctx.metrics`` the registry, ``ctx.telemetry`` the flight recorder and
``ctx.trace(name)`` a child span of the request's. The same Context serves
the HTTP, gRPC and CLI transports."""

from __future__ import annotations

from typing import Any, Optional

from gofr_tpu_torch.tracing import Span, current_trace_id, get_tracer


class Context:
    def __init__(self, request: Any, container: Any):
        self.request = request
        self.container = container

    def param(self, key: str) -> str:
        return self.request.param(key)

    def params(self, key: str) -> list[str]:
        return self.request.params(key)

    def path_param(self, key: str) -> str:
        return self.request.path_param(key)

    def bind(self, into: Any = None) -> Any:
        return self.request.bind(into)

    def header(self, name: str) -> str:
        header = getattr(self.request, "header", None)
        return header(name) if header else ""

    def host_name(self) -> str:
        return self.request.host_name()

    @property
    def logger(self) -> Any:
        return self.container.logger

    @property
    def config(self) -> Any:
        return self.container.config

    @property
    def redis(self) -> Any:
        return self.container.redis

    @property
    def db(self) -> Any:
        return self.container.db

    @property
    def tpu(self) -> Any:
        """The inference device (the JAX package's attribute name)."""
        return self.container.tpu

    @property
    def metrics(self) -> Any:
        return self.container.metrics

    @property
    def telemetry(self) -> Any:
        """The request flight recorder."""
        return self.container.telemetry

    def get_http_service(self, name: str) -> Any:
        return self.container.get_http_service(name)

    def trace(self, name: str) -> Span:
        """A user span, child of the request's: ``with ctx.trace("work"):``."""
        return get_tracer().start_span(name)

    @property
    def trace_id(self) -> Optional[str]:
        return current_trace_id()
