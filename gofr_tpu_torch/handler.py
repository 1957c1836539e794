"""Handler adapter and built-in handlers (trimmed copy of
``gofr_tpu/handler.py``)."""

from __future__ import annotations

import asyncio
import contextvars
import inspect
from typing import Any, Callable

from gofr_tpu_torch.context import Context
from gofr_tpu_torch.errors import RouteNotFoundError
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.responder import respond
from gofr_tpu_torch.http.response import Response

Handler = Callable[[Context], Any]


def make_endpoint(func: Handler, container: Any) -> Callable:
    """Adapt ``handler(ctx) -> result`` into an async router endpoint. Sync
    handlers run on the container's thread pool (a generation blocks its
    thread for the whole decode)."""
    is_async = inspect.iscoroutinefunction(func)

    async def endpoint(request: Request) -> Response:
        ctx = Context(request, container)
        try:
            if is_async:
                result = await func(ctx)
            else:
                loop = asyncio.get_running_loop()
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


def catch_all_handler(_: Context) -> None:
    raise RouteNotFoundError()
