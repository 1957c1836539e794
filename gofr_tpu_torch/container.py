"""Dependency container: config, logger, metrics registry, the flight
recorder and tenant ledger, handler thread pool and the inference device
(trimmed copy of ``gofr_tpu/container.py``).

- ``LOG_LEVEL`` sets the logger's level (INFO by default);
- the registry caps each metric's label-sets at ``METRICS_MAX_SERIES``
  (1000) and, unless ``METRICS_EXEMPLARS=off``, gives histograms the
  current trace id and dispatch id as their OpenMetrics exemplar
  (``telemetry.exemplar_provider``);
- ``telemetry`` (a ``FlightRecorder``: ``FLIGHT_RECORDER_SIZE`` 512,
  ``FLIGHT_RECORDER_KEEP`` 128, ``FLIGHT_SLOW_MS`` 2000) keeps the
  requests' flight records, metered into ``tenants`` (a ``TenantLedger``
  of ``TENANT_LEDGER_SIZE`` 256);
- ``HANDLER_THREADS`` (64) sizes the pool sync handlers run on;
- the device is built when ``MODEL_NAME`` is set or ``TPU_ENABLED`` is
  true (it then serves ``mlp``, the default ``MODEL_NAME``), and boots in
  the foreground or, under ``TPU_BOOT=background``, on a thread while the
  server already answers (readiness 503 until it is ready).

Unlike the JAX package, a device that fails to start is NOT logged and
dropped: a foreground boot's error propagates, and a background boot's
failure stays on the device (readiness 503, health DOWN, every request
fails with it), so a missing GPU or a failed kernel build never turns into
a server that serves something else.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from gofr_tpu_torch.config import check_unhonored
from gofr_tpu_torch.logging import new_logger
from gofr_tpu_torch.metrics import Registry
from gofr_tpu_torch.telemetry import FlightRecorder, TenantLedger, exemplar_provider


class Container:
    def __init__(self, config: Any, model: Any = None):
        self.config = config
        self.logger = new_logger(config.get_or_default("LOG_LEVEL", "INFO"))
        # the reference's settings the port does not honor: refuse or warn
        # before anything boots
        check_unhonored(config, self.logger)
        self.metrics = Registry(
            max_series=int(config.get_or_default("METRICS_MAX_SERIES", "1000")),
            exemplar_provider=(
                exemplar_provider
                if config.get_or_default("METRICS_EXEMPLARS", "on") != "off" else None
            ),
        )
        # bounded per-tenant usage (/admin/tenants): exact for the top
        # tenants, the rest in ~other; never a per-tenant series
        self.tenants = TenantLedger(
            size=int(config.get_or_default("TENANT_LEDGER_SIZE", "256")), metrics=self.metrics,
        )
        # the flight recorder behind /admin/requests and /admin/slo
        self.telemetry = FlightRecorder(
            capacity=int(config.get_or_default("FLIGHT_RECORDER_SIZE", "512")),
            keep=int(config.get_or_default("FLIGHT_RECORDER_KEEP", "128")),
            slow_threshold_s=float(config.get_or_default("FLIGHT_SLOW_MS", "2000")) / 1000.0,
            logger=self.logger,
            tenants=self.tenants,
        )
        self.tpu: Optional[Any] = None
        self._handler_pool: Optional[ThreadPoolExecutor] = None
        enabled = config.get_or_default("TPU_ENABLED", "").lower()
        if enabled in ("true", "1", "yes") or config.get("MODEL_NAME"):
            from gofr_tpu_torch.tpu.device import TPUDevice

            self.tpu = TPUDevice(config, self.logger, model=model, metrics=self.metrics)
            if config.get_or_default("TPU_BOOT", "") == "background":
                self.logger.infof(
                    "device booting in background (model=%s); readiness at "
                    "/.well-known/ready", self.tpu.model_name,
                )

    def health(self) -> dict[str, Any]:
        if self.tpu is None:
            return {"status": "UP", "details": {}}
        h = self.tpu.health_check()
        return {"status": h["status"], "details": {"tpu": h}}

    @property
    def handler_executor(self) -> ThreadPoolExecutor:
        """Thread pool for sync handlers, sized for blocking generations
        (``HANDLER_THREADS``)."""
        if self._handler_pool is None:
            self._handler_pool = ThreadPoolExecutor(
                max_workers=int(self.config.get_or_default("HANDLER_THREADS", "64")),
                thread_name_prefix="gofr-handler",
            )
        return self._handler_pool

    def close(self) -> None:
        if self.tpu is not None:
            self.tpu.close()
        if self._handler_pool is not None:
            self._handler_pool.shutdown(wait=False)
