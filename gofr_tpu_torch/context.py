"""Per-request Context handed to every handler (trimmed copy of
``gofr_tpu/context.py``): the request plus the container, with
``ctx.tpu`` exposing the inference device, ``ctx.metrics`` the registry
and ``ctx.trace(name)`` a child span of the request's."""

from __future__ import annotations

from typing import Any, Optional

from gofr_tpu_torch.tracing import Span, current_trace_id, get_tracer


class Context:
    def __init__(self, request: Any, container: Any):
        self.request = request
        self.container = container

    def param(self, key: str) -> str:
        return self.request.param(key)

    def path_param(self, key: str) -> str:
        return self.request.path_param(key)

    def bind(self, into: Any = None) -> Any:
        return self.request.bind(into)

    def header(self, name: str) -> str:
        return self.request.header(name)

    @property
    def logger(self) -> Any:
        return self.container.logger

    @property
    def config(self) -> Any:
        return self.container.config

    @property
    def tpu(self) -> Any:
        """The inference device (the JAX package's attribute name)."""
        return self.container.tpu

    @property
    def metrics(self) -> Any:
        return self.container.metrics

    def trace(self, name: str) -> Span:
        """A user span, child of the request's: ``with ctx.trace("work"):``."""
        return get_tracer().start_span(name)

    @property
    def trace_id(self) -> Optional[str]:
        return current_trace_id()
