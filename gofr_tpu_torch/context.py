"""Per-request Context handed to every handler (trimmed copy of
``gofr_tpu/context.py``): the request plus the container, with
``ctx.tpu`` exposing the inference device."""

from __future__ import annotations

from typing import Any


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
