"""gRPC transport (copy of ``gofr_tpu/grpcx.py``): server wiring with
recovery + logging/tracing interceptors, generated-stub registration, and a
reflection-free JSON service mode sharing the transport-agnostic handler
signature. Its JSON bytes and status codes are the JAX server's.

Parity: GoFr's pkg/gofr/grpc.go:16-47 (server with interceptor
chain recovery -> logging :23-27, listen/serve :32-46) and
grpc/log.go:15-50 (per-RPC span, RPCLog JSON entry, trace id as log id).

Additions over GoFr: ``json_services`` lets handlers serve
application/json unary RPCs without protoc codegen (the environment ships
grpcio but not grpc_tools), and server-streaming RPCs are wrapped for token
decode streams.
"""

from __future__ import annotations

import json
import time
import traceback
from concurrent import futures
from dataclasses import dataclass
from typing import Any, Callable, Optional

import grpc

from gofr_tpu_torch.context import Context
from gofr_tpu_torch.errors import status_from_error
from gofr_tpu_torch.tracing import SERVER, current_trace_id, get_tracer


@dataclass
class RPCLog:
    """Typed per-RPC log entry (parity: grpc/log.go:15-25)."""

    id: str
    method: str
    status: str
    response_time_us: int

    def pretty_terminal(self) -> str:
        color = 32 if self.status == "OK" else 31
        return (
            f"\x1b[{color}m{self.status}\x1b[0m "
            f"{self.method} {self.response_time_us}µs"
        )

    def log_fields(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "method": self.method,
            "status": self.status,
            "response_time_us": self.response_time_us,
        }


def _is_abort(exc: BaseException, context: Any) -> bool:
    """grpc's ServicerContext.abort() raises a bare ``Exception()`` after
    marking the context aborted; recovery must let deliberate aborts
    propagate instead of rewriting them to INTERNAL."""
    state = getattr(context, "_state", None)
    if state is not None and getattr(state, "aborted", False):
        return True
    return type(exc) is Exception and not exc.args


class _RecoveryLoggingInterceptor(grpc.ServerInterceptor):
    """Recovery -> logging chain as one interceptor (parity: grpc.go:23-27,
    grpc/log.go:27-50)."""

    def __init__(self, logger: Any):
        self.logger = logger

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        method = handler_call_details.method
        metadata = dict(handler_call_details.invocation_metadata or ())
        traceparent = metadata.get("traceparent")
        logger = self.logger

        def _span():
            return get_tracer().start_span(f"grpc {method}", kind=SERVER, traceparent=traceparent)

        if handler.unary_unary:
            inner = handler.unary_unary

            def unary_unary(request, context):
                start = time.perf_counter()
                abort_exc = None
                with _span():
                    trace_id = current_trace_id() or ""
                    try:
                        response = inner(request, context)
                        status = "OK"
                    except Exception as exc:
                        if _is_abort(exc, context):
                            status = "ABORTED"
                            abort_exc = exc
                        else:
                            logger.error(
                                {"error": "rpc panic recovered", "method": method,
                                 "stack": traceback.format_exc(), "trace_id": trace_id}
                            )
                            status = "INTERNAL"
                        response = None
                elapsed = int((time.perf_counter() - start) * 1e6)
                logger.info(RPCLog(trace_id, method, status, elapsed))
                if abort_exc is not None:
                    raise abort_exc
                if status != "OK":
                    context.abort(grpc.StatusCode.INTERNAL, "some unexpected error has occurred")
                return response

            return grpc.unary_unary_rpc_method_handler(
                unary_unary,
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )

        if handler.unary_stream:
            inner_stream = handler.unary_stream

            def unary_stream(request, context):
                start = time.perf_counter()
                span = _span()
                trace_id = span.trace_id
                status = "OK"
                abort_exc = None
                try:
                    yield from inner_stream(request, context)
                except Exception as exc:
                    if _is_abort(exc, context):
                        status = "ABORTED"
                        abort_exc = exc
                    else:
                        logger.error(
                            {"error": "rpc panic recovered", "method": method,
                             "stack": traceback.format_exc(), "trace_id": trace_id}
                        )
                        status = "INTERNAL"
                finally:
                    span.__exit__(None, None, None)  # end + reset current-span
                    elapsed = int((time.perf_counter() - start) * 1e6)
                    logger.info(RPCLog(trace_id, method, status, elapsed))
                if abort_exc is not None:
                    raise abort_exc
                if status != "OK":
                    context.abort(grpc.StatusCode.INTERNAL, "some unexpected error has occurred")

            return grpc.unary_stream_rpc_method_handler(
                unary_stream,
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )

        return handler  # other streaming shapes pass through un-instrumented


class GRPCRequest:
    """Request façade over a JSON unary RPC body (transport abstraction
    parity: pkg/gofr/request.go:10-16)."""

    def __init__(self, method: str, payload: Any, metadata: dict[str, str]):
        self.method = method
        self.payload = payload if isinstance(payload, dict) else {"body": payload}
        self._raw = payload
        self.metadata = metadata

    def param(self, key: str) -> str:
        value = self.payload.get(key, "")
        return "" if value is None else str(value)

    def params(self, key: str) -> list[str]:
        value = self.payload.get(key)
        if value is None:
            return []
        return [str(v) for v in value] if isinstance(value, list) else [str(value)]

    def path_param(self, key: str) -> str:
        return self.param(key)

    def bind(self, into: Any = None) -> Any:
        if into is None:
            return self._raw
        obj = into() if isinstance(into, type) else into
        if isinstance(self._raw, dict):
            for k, v in self._raw.items():
                setattr(obj, k, v)
        return obj

    def header(self, name: str) -> str:
        return self.metadata.get(name.lower(), "")

    def host_name(self) -> str:
        return self.metadata.get(":authority", "grpc")


class GRPCServer:
    """Parity: grpc.go:16-47."""

    def __init__(
        self,
        port: int,
        container: Any,
        registrations: Optional[list[tuple[Callable, Any]]] = None,
        json_services: Optional[dict[str, dict[str, Callable]]] = None,
        json_stream_services: Optional[dict[str, dict[str, Callable]]] = None,
        max_workers: int = 32,
    ):
        self.port = port
        self.container = container
        self.logger = container.logger
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            interceptors=[_RecoveryLoggingInterceptor(self.logger)],
        )
        for add_to_server, servicer in registrations or []:
            add_to_server(servicer, self.server)
        stream_services = json_stream_services or {}
        for service_name in set(json_services or {}) | set(stream_services):
            self._register_json_service(
                service_name,
                (json_services or {}).get(service_name, {}),
                stream_services.get(service_name, {}),
            )

    def _register_json_service(
        self,
        service_name: str,
        methods: dict[str, Callable],
        stream_methods: Optional[dict[str, Callable]] = None,
    ) -> None:
        overlap = set(methods) & set(stream_methods or {})
        if overlap:
            raise ValueError(
                f"service '{service_name}' registers {sorted(overlap)} as both "
                "unary and streaming — a method must be one or the other"
            )
        handlers: dict[str, grpc.RpcMethodHandler] = {}
        for method_name, handler in methods.items():
            handlers[method_name] = grpc.unary_unary_rpc_method_handler(
                self._wrap_json_handler(f"/{service_name}/{method_name}", handler),
                request_deserializer=None,  # raw bytes
                response_serializer=None,
            )
        for method_name, handler in (stream_methods or {}).items():
            handlers[method_name] = grpc.unary_stream_rpc_method_handler(
                self._wrap_json_stream_handler(f"/{service_name}/{method_name}", handler),
                request_deserializer=None,
                response_serializer=None,
            )
        generic = grpc.method_handlers_generic_handler(service_name, handlers)
        self.server.add_generic_rpc_handlers((generic,))

    def _build_json_context(
        self, request_bytes: bytes, context: grpc.ServicerContext, method: str
    ) -> Context:
        """Shared request preamble for unary and streaming JSON RPCs:
        metadata normalization, JSON decode (malformed → INVALID_ARGUMENT
        abort), and handler Context construction."""
        metadata = {k.lower(): v for k, v in (context.invocation_metadata() or ())}
        try:
            payload = json.loads(request_bytes.decode("utf-8")) if request_bytes else None
        except (json.JSONDecodeError, UnicodeDecodeError):
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "invalid JSON payload")
        return Context(GRPCRequest(method, payload, metadata), self.container)

    def _wrap_json_handler(self, method: str, handler: Callable) -> Callable:
        container = self.container

        def unary(request_bytes: bytes, context: grpc.ServicerContext) -> bytes:
            ctx = self._build_json_context(request_bytes, context, method)
            try:
                result = handler(ctx)
            except Exception as exc:
                _abort_for_error(container, context, method, exc)
                return b""
            from gofr_tpu_torch.http.responder import _jsonable

            return json.dumps({"data": result}, default=_jsonable).encode("utf-8")

        return unary

    def _wrap_json_stream_handler(self, method: str, handler: Callable) -> Callable:
        """Server-streaming JSON RPC: the handler returns an iterator (or a
        ``Stream``); each yielded item is one JSON message on the stream —
        the token-decode transport."""
        container = self.container

        def unary_stream(request_bytes: bytes, context: grpc.ServicerContext):
            ctx = self._build_json_context(request_bytes, context, method)
            from gofr_tpu_torch.http.responder import _jsonable
            from gofr_tpu_torch.http.response import Stream

            try:
                result = handler(ctx)
                events = result.events if isinstance(result, Stream) else result
                for item in events:
                    yield json.dumps(item, default=_jsonable).encode("utf-8")
            except Exception as exc:
                _abort_for_error(container, context, method, exc)

        return unary_stream

    # -- lifecycle (parity: grpc.go:32-46) -----------------------------------
    def start(self) -> None:
        addr = f"[::]:{self.port}"
        self.server.add_insecure_port(addr)
        self.server.start()
        self.logger.infof("starting gRPC server on port %s", self.port)

    def wait(self) -> None:
        self.server.wait_for_termination()

    def stop(self, grace: float = 2.0) -> None:
        self.server.stop(grace)


def _abort_for_error(
    container: Any, context: grpc.ServicerContext, method: str, exc: Exception
) -> None:
    """Shared error→status policy for unary and streaming JSON handlers:
    typed errors surface their message on the mapped status; unexpected
    errors are logged server-side and masked as INTERNAL."""
    status = status_from_error(exc)
    code = _status_to_grpc(status)
    if status == 500 and not hasattr(exc, "status_code"):
        container.logger.errorf("grpc handler error on %s: %r", method, exc)
        context.abort(code, "some unexpected error has occurred")
    else:
        context.abort(code, str(exc))


def _status_to_grpc(status: int) -> grpc.StatusCode:
    return {
        400: grpc.StatusCode.INVALID_ARGUMENT,
        401: grpc.StatusCode.UNAUTHENTICATED,
        403: grpc.StatusCode.PERMISSION_DENIED,
        404: grpc.StatusCode.NOT_FOUND,
        408: grpc.StatusCode.DEADLINE_EXCEEDED,
        429: grpc.StatusCode.RESOURCE_EXHAUSTED,
        502: grpc.StatusCode.UNAVAILABLE,
        503: grpc.StatusCode.UNAVAILABLE,
    }.get(status, grpc.StatusCode.INTERNAL)
