"""App core (trimmed copy of ``gofr_tpu/app.py``): config, container,
route registration and the HTTP server (with ``/.well-known/health`` and
the LoRA adapter admin routes).

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
    catch_all_handler,
    health_handler,
    make_endpoint,
)
from gofr_tpu_torch.http.router import Router
from gofr_tpu_torch.http.server import HTTPServer

DEFAULT_HTTP_PORT = 8000


class App:
    def __init__(self, configs_dir: Optional[str] = None, model: Any = None):
        """``model``: an already-built model of ``MODEL_NAME``'s family (a
        ``Transformer``, ``Bert`` or ``MLP``) to serve instead of the
        seeded random init (tests carry weights over from JAX)."""
        self.config = EnvFileConfig(configs_dir or "./configs")
        self.container = Container(self.config, model=model)
        self.logger = self.container.logger
        self.http_port = int(self.config.get_or_default("HTTP_PORT", str(DEFAULT_HTTP_PORT)))
        self.router = Router()
        self.http_server: Optional[HTTPServer] = None

    def get(self, pattern: str, handler: Handler) -> None:
        self.add_route("GET", pattern, handler)

    def post(self, pattern: str, handler: Handler) -> None:
        self.add_route("POST", pattern, handler)

    def add_route(self, method: str, pattern: str, handler: Handler) -> None:
        self.router.add(method, pattern, make_endpoint(handler, self.container))

    def start(self) -> "App":
        """Start the HTTP server in a background thread and return."""
        self.router.add(
            "GET", "/.well-known/health", make_endpoint(health_handler, self.container)
        )
        # LoRA adapter admin (ADMIN_TOKEN gates it when set)
        for method, pattern, handler in (
            ("GET", "/admin/adapters", adapters_list_handler),
            ("POST", "/admin/adapters", adapter_load_handler),
            ("DELETE", "/admin/adapters/{name}", adapter_unload_handler),
        ):
            self.router.add(method, pattern, make_endpoint(handler, self.container))
        self.router.set_not_found(make_endpoint(catch_all_handler, self.container))
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
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        if self.http_server:
            self.http_server.shutdown()
        self.container.close()


def new(configs_dir: Optional[str] = None, model: Any = None) -> App:
    return App(configs_dir=configs_dir, model=model)
