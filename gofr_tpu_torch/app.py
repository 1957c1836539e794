"""App core (trimmed copy of ``gofr_tpu/app.py``): config, container,
tracer, the middleware chain, route registration and the HTTP server with
the default routes (``/.well-known/health``, ``/.well-known/ready``,
``/favicon.ico``, ``/metrics``, the profiler, flight-recorder, SLO, engine,
cost-model, timebase, postmortem and LoRA adapter admin routes).

    import gofr_tpu_torch
    app = gofr_tpu_torch.new()
    gofr_tpu_torch.register_openai_routes(app)
    app.run()          # blocks; start()/shutdown() for in-process use
"""

from __future__ import annotations

import threading
from typing import Any, Optional

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


class App:
    def __init__(self, configs_dir: Optional[str] = None, model: Any = None):
        """``model``: an already-built model of ``MODEL_NAME``'s family (a
        ``Transformer``, ``Bert`` or ``MLP``) to serve instead of the
        seeded random init (tests carry weights over from JAX)."""
        self.config = EnvFileConfig(configs_dir or "./configs")
        self.container = Container(self.config, model=model)
        self.logger = self.container.logger
        self.tracer = init_tracer(self.config, self.logger)
        # exporter drops become a counter an alert can watch
        attach = getattr(self.tracer.exporter, "attach_metrics", None)
        if attach is not None:
            attach(self.container.metrics)
        self.http_port = int(self.config.get_or_default("HTTP_PORT", str(DEFAULT_HTTP_PORT)))
        self.router = Router()
        # middleware chain, outermost first
        self.router.use(
            tracer_middleware,
            logging_middleware(self.logger),
            metrics_middleware(self.container.metrics),
            cors_middleware,
        )
        self.http_server: Optional[HTTPServer] = None

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

    def _install_default_routes(self) -> None:
        for method, pattern, handler in (
            ("GET", "/.well-known/health", health_handler),
            ("GET", "/.well-known/ready", ready_handler),
            ("GET", "/favicon.ico", favicon_handler),
            ("GET", "/metrics", metrics_handler),
            # the admin surface (ADMIN_TOKEN gates it when set): the
            # profiler, the flight recorder and the SLO engine, engine
            # introspection, the cost model, the timebase, the postmortem
            # store and the LoRA adapters
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
        ):
            self.router.add(method, pattern, make_endpoint(handler, self.container))
        self.router.set_not_found(make_endpoint(catch_all_handler, self.container))

    def start(self) -> "App":
        """Start the HTTP server in a background thread and return."""
        self._install_default_routes()
        self.http_server = HTTPServer(self.router, self.http_port, self.logger)
        self.http_server.run_in_thread()
        return self

    def run(self) -> None:
        """Blocking run until SIGTERM or Ctrl-C."""
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
        if self.http_server:
            self.http_server.shutdown()
        self.container.close()
        self.tracer.shutdown()


def new(configs_dir: Optional[str] = None, model: Any = None) -> App:
    return App(configs_dir=configs_dir, model=model)
