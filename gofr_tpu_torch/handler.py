"""Handler adapter and built-in handlers (trimmed copy of
``gofr_tpu/handler.py``): health, the catch-all, and the LoRA adapter
admin surface (``GET``/``POST /admin/adapters``, ``DELETE
/admin/adapters/{name}``) behind the optional ``ADMIN_TOKEN``."""

from __future__ import annotations

import asyncio
import contextvars
import hmac
import inspect
from typing import Any, Callable

from gofr_tpu_torch.context import Context
from gofr_tpu_torch.errors import (
    HTTPError,
    InvalidParamError,
    RouteNotFoundError,
    UnauthenticatedError,
)
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
