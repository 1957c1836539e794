"""App core (copy of ``gofr_tpu/app.py``): config, container, tracer, the
middleware chain, route registration, service clients
(``add_http_service``), the gRPC server (``register_service`` for
generated stubs, ``register_json_service`` for JSON methods; it listens on
``GRPC_PORT``, 9000, when a service is registered), CLI sub-commands
(``new_cmd``, ``sub_command``; ``run`` then dispatches argv and exits with
its code) and the HTTP server with the default routes (``/.well-known/health``, ``/.well-known/ready``,
``/favicon.ico``, ``/metrics``, the profiler, flight-recorder, SLO, engine,
cost-model, timebase, postmortem and LoRA adapter admin routes, and the
donor side of a KV pull, ``GET /admin/kv/{hash}``). A router made by
``gofr_tpu_torch.fleet.wire_fleet(app)`` drains at shutdown before the
listener stops.

    import gofr_tpu_torch
    app = gofr_tpu_torch.new()
    gofr_tpu_torch.register_openai_routes(app)
    app.run()          # blocks; start()/shutdown() for in-process use

    cli = gofr_tpu_torch.new_cmd()
    cli.sub_command("hello", lambda ctx: f"Hello {ctx.param('name')}!")
    cli.run()          # runs the argv's command, exits non-zero on error
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from gofr_tpu_torch.config import EnvFileConfig
from gofr_tpu_torch.container import Container
from gofr_tpu_torch.handler import (
    Handler,
    adapter_load_handler,
    adapter_unload_handler,
    adapters_list_handler,
    anomalies_admin_handler,
    catch_all_handler,
    costmodel_admin_handler,
    dispatches_admin_handler,
    engine_admin_handler,
    favicon_handler,
    health_handler,
    kv_export_handler,
    make_endpoint,
    metrics_handler,
    overview_admin_handler,
    postmortem_list_handler,
    postmortem_trigger_handler,
    profiler_start_handler,
    profiler_status_handler,
    profiler_stop_handler,
    ready_handler,
    requests_admin_handler,
    slo_admin_handler,
    slo_budget_handler,
    tenants_admin_handler,
    timeseries_admin_handler,
)
from gofr_tpu_torch.http.middleware import (
    cors_middleware,
    logging_middleware,
    metrics_middleware,
    tracer_middleware,
)
from gofr_tpu_torch.http.router import Router
from gofr_tpu_torch.http.server import HTTPServer
from gofr_tpu_torch.tracing import init_tracer

DEFAULT_HTTP_PORT = 8000
DEFAULT_GRPC_PORT = 9000


class App:
    def __init__(self, configs_dir: Optional[str] = None, model: Any = None,
                 cmd_app: bool = False):
        """``model``: an already-built model of ``MODEL_NAME``'s family (a
        ``Transformer``, ``Bert`` or ``MLP``) to serve instead of the
        seeded random init (tests carry weights over from JAX).
        ``cmd_app``: a CLI app (``new_cmd``): the same container, no
        servers."""
        self.config = EnvFileConfig(configs_dir or "./configs")
        self.container = Container(self.config, model=model)
        self.logger = self.container.logger
        self.tracer = init_tracer(self.config, self.logger)
        # exporter drops become a counter an alert can watch
        attach = getattr(self.tracer.exporter, "attach_metrics", None)
        if attach is not None:
            attach(self.container.metrics)
        self._cmd_app = cmd_app
        self._cmd_routes: list[tuple[str, Handler]] = []
        self._grpc_registrations: list[tuple[Any, Any]] = []
        self._grpc_json_services: dict[str, dict[str, Handler]] = {}
        self._grpc_json_stream_services: dict[str, dict[str, Handler]] = {}
        self._grpc_server: Optional[Any] = None
        self.http_server: Optional[HTTPServer] = None
        self.router = Router()
        if not cmd_app:
            self.http_port = int(self.config.get_or_default("HTTP_PORT", str(DEFAULT_HTTP_PORT)))
            self.grpc_port = int(self.config.get_or_default("GRPC_PORT", str(DEFAULT_GRPC_PORT)))
            # middleware chain, outermost first
            self.router.use(
                tracer_middleware,
                logging_middleware(self.logger),
                metrics_middleware(self.container.metrics),
                cors_middleware,
            )

    def get(self, pattern: str, handler: Handler) -> None:
        self.add_route("GET", pattern, handler)

    def post(self, pattern: str, handler: Handler) -> None:
        self.add_route("POST", pattern, handler)

    def put(self, pattern: str, handler: Handler) -> None:
        self.add_route("PUT", pattern, handler)

    def patch(self, pattern: str, handler: Handler) -> None:
        self.add_route("PATCH", pattern, handler)

    def delete(self, pattern: str, handler: Handler) -> None:
        self.add_route("DELETE", pattern, handler)

    def add_route(self, method: str, pattern: str, handler: Handler) -> None:
        self.router.add(method, pattern, make_endpoint(handler, self.container))

    def add_http_service(self, name: str, address: str) -> None:
        """Register a downstream service client for ``ctx.get_http_service``."""
        from gofr_tpu_torch.service import new_http_service

        self.container.services[name] = new_http_service(address, self.logger, name=name)

    def register_service(self, add_to_server: Callable, servicer: Any) -> None:
        """Register a generated-stub gRPC service: ``add_to_server`` is the
        protoc-generated ``add_XServicer_to_server`` callable."""
        self._grpc_registrations.append((add_to_server, servicer))

    def register_json_service(
        self,
        service_name: str,
        methods: dict[str, Handler],
        stream_methods: Optional[dict[str, Handler]] = None,
    ) -> None:
        """Register a JSON-over-gRPC service of ``handler(ctx)`` methods
        (no protoc codegen). A ``stream_methods`` handler returns an
        iterator, each item one JSON message on a server stream. A name in
        both maps is refused here."""
        overlap = set(methods) & set(stream_methods or {})
        if overlap:
            raise ValueError(
                f"service '{service_name}' registers {sorted(overlap)} as both "
                "unary and streaming — a method must be one or the other"
            )
        if methods:
            self._grpc_json_services[service_name] = methods
        if stream_methods:
            self._grpc_json_stream_services[service_name] = stream_methods

    def sub_command(self, pattern: str, handler: Handler) -> None:
        """A CLI command: ``pattern`` is the command string (the argv's
        non-flag words joined) or a regex over it."""
        self._cmd_routes.append((pattern, handler))

    def _install_default_routes(self) -> None:
        for method, pattern, handler in (
            ("GET", "/.well-known/health", health_handler),
            ("GET", "/.well-known/ready", ready_handler),
            ("GET", "/favicon.ico", favicon_handler),
            ("GET", "/metrics", metrics_handler),
            # the admin surface (ADMIN_TOKEN gates it when set): the
            # profiler, the flight recorder and the SLO engine, engine
            # introspection, the cost model, the timebase, the postmortem
            # store, the LoRA adapters and the KV export
            ("GET", "/admin/profiler", profiler_status_handler),
            ("POST", "/admin/profiler/start", profiler_start_handler),
            ("POST", "/admin/profiler/stop", profiler_stop_handler),
            ("GET", "/admin/requests", requests_admin_handler),
            ("GET", "/admin/slo", slo_admin_handler),
            ("GET", "/admin/slo/budget", slo_budget_handler),
            ("GET", "/admin/tenants", tenants_admin_handler),
            ("GET", "/admin/engine", engine_admin_handler),
            ("GET", "/admin/dispatches", dispatches_admin_handler),
            ("GET", "/admin/costmodel", costmodel_admin_handler),
            ("GET", "/admin/anomalies", anomalies_admin_handler),
            ("GET", "/admin/timeseries", timeseries_admin_handler),
            ("GET", "/admin/overview", overview_admin_handler),
            ("GET", "/admin/postmortem", postmortem_list_handler),
            ("POST", "/admin/postmortem", postmortem_trigger_handler),
            ("GET", "/admin/adapters", adapters_list_handler),
            ("POST", "/admin/adapters", adapter_load_handler),
            ("DELETE", "/admin/adapters/{name}", adapter_unload_handler),
            # cross-replica KV transfer: peers pull cached paged-KV block
            # tables by prompt hash
            ("GET", "/admin/kv/{hash}", kv_export_handler),
        ):
            self.router.add(method, pattern, make_endpoint(handler, self.container))
        self.router.set_not_found(make_endpoint(catch_all_handler, self.container))

    def start(self) -> "App":
        """Start the HTTP server (and the gRPC server, when a service is
        registered) in background threads and return."""
        self._install_default_routes()
        self.http_server = HTTPServer(self.router, self.http_port, self.logger)
        self.http_server.run_in_thread()
        if (
            self._grpc_registrations
            or self._grpc_json_services
            or self._grpc_json_stream_services
        ):
            from gofr_tpu_torch.grpcx import GRPCServer

            self._grpc_server = GRPCServer(
                self.grpc_port,
                self.container,
                registrations=self._grpc_registrations,
                json_services=self._grpc_json_services,
                json_stream_services=self._grpc_json_stream_services,
            )
            self._grpc_server.start()
        return self

    def run(self) -> None:
        """Blocking run until SIGTERM or Ctrl-C; a CLI app runs the argv's
        command instead and raises SystemExit with a non-zero code."""
        if self._cmd_app:
            from gofr_tpu_torch.cmd import run_cmd

            code = run_cmd(self)
            if code != 0:
                raise SystemExit(code)
            return
        self.start()
        stop = threading.Event()
        try:
            import signal

            signal.signal(signal.SIGTERM, lambda *_: stop.set())
        except (ValueError, OSError):
            pass  # not the main thread
        try:
            stop.wait()
            self.logger.info("SIGTERM received, shutting down")
        except KeyboardInterrupt:
            self.logger.info("shutting down")
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        # streams the shutdown closes are no client aborts
        self.container.closing = True
        fleet = getattr(self.container, "fleet", None)
        if fleet is not None:
            # graceful drain BEFORE the listener stops: admission closes
            # (new requests shed 503, readiness flips) while in-flight
            # requests finish through the still-running server
            fleet.drain(timeout_s=float(self.config.get_or_default("FLEET_DRAIN_TIMEOUT_S", "10")))
        if self.http_server:
            self.http_server.shutdown()
        if self._grpc_server:
            self._grpc_server.stop()
        self.container.close()
        self.tracer.shutdown()


def new(configs_dir: Optional[str] = None, model: Any = None) -> App:
    return App(configs_dir=configs_dir, model=model)


def new_cmd(configs_dir: Optional[str] = None) -> App:
    """A CLI app: the same container (``ctx.tpu`` when ``MODEL_NAME`` is
    set), sub-commands in place of servers."""
    return App(configs_dir=configs_dir, cmd_app=True)
