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
- ``timebase`` (a ``TimebaseSampler``: ``TIMEBASE_ENABLED`` on,
  ``TIMEBASE_INTERVAL_S`` 5, ``TIMEBASE_WINDOW_S`` 900) keeps the metric
  history behind ``/admin/timeseries`` and ``/admin/overview``;
- ``postmortem`` (a ``PostmortemStore``: ``POSTMORTEM_DIR``
  ./postmortems, ``POSTMORTEM_KEEP`` 20, ``POSTMORTEM_MIN_INTERVAL_S`` 30,
  ``POSTMORTEM_SNAPSHOTS`` 60) writes a bundle when the engine wedges or
  fails, before the recovery supervisor quarantines, and on
  ``POST /admin/postmortem``; with ``POSTMORTEM_DIR`` set it also hooks
  crashes and fatal signals;
- ``slo`` (an ``SloEngine`` unless ``SLO=off``: ``SLO_TARGETS`` and the
  ``SLO_BURN_*`` windows and rates, ``SLO_EVAL_INTERVAL_S``) burns budgets
  over the flight records into the device's anomaly ring;
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
from gofr_tpu_torch.postmortem import PostmortemStore
from gofr_tpu_torch.slo import DEFAULT_TARGETS, SloEngine
from gofr_tpu_torch.telemetry import FlightRecorder, TenantLedger, exemplar_provider
from gofr_tpu_torch.timebase import TimebaseSampler


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
        self.timebase = TimebaseSampler(
            self.metrics,
            interval_s=float(config.get_or_default("TIMEBASE_INTERVAL_S", "5")),
            window_s=float(config.get_or_default("TIMEBASE_WINDOW_S", "900")),
            logger=self.logger,
            start=config.get_or_default("TIMEBASE_ENABLED", "on") != "off",
        )
        self.postmortem = PostmortemStore(
            self,
            directory=config.get_or_default("POSTMORTEM_DIR", "./postmortems"),
            keep=int(config.get_or_default("POSTMORTEM_KEEP", "20")),
            min_interval_s=float(config.get_or_default("POSTMORTEM_MIN_INTERVAL_S", "30")),
            snapshots=int(config.get_or_default("POSTMORTEM_SNAPSHOTS", "60")),
            logger=self.logger,
        )
        if config.get("POSTMORTEM_DIR"):
            # process-global hooks: armed only on the operator's opt-in
            self.postmortem.install_crash_hooks()
        # set by App.shutdown: streams closed by the shutdown are no client
        # aborts
        self.closing = False
        self.tpu: Optional[Any] = None
        self._handler_pool: Optional[ThreadPoolExecutor] = None
        enabled = config.get_or_default("TPU_ENABLED", "").lower()
        if enabled in ("true", "1", "yes") or config.get("MODEL_NAME"):
            from gofr_tpu_torch.tpu.device import TPUDevice

            try:
                self.tpu = TPUDevice(config, self.logger, model=model, metrics=self.metrics)
            except BaseException:
                self.timebase.close()  # a failed boot leaves no thread behind
                self.postmortem.detach()
                raise
            # a wedged or failed engine writes its bundle; the recovery
            # supervisor writes one synchronously before it quarantines
            # (the store's rate limit dedupes the two)
            self.postmortem.watch_engine(self.tpu.engine)
            self.tpu.recovery.postmortem = (
                lambda detail: self.postmortem.write(reason="wedged", detail=detail)
            )
            if config.get_or_default("TPU_BOOT", "") == "background":
                self.logger.infof(
                    "device booting in background (model=%s); readiness at "
                    "/.well-known/ready", self.tpu.model_name,
                )

        # after the device: the burn verdicts land in its cost model's
        # anomaly ring (one /admin/anomalies surface); a malformed
        # SLO_TARGETS fails the boot with the clause named
        self.slo: Optional[SloEngine] = None
        if config.get_or_default("SLO", "on") != "off":
            self.slo = SloEngine(
                self.telemetry, timebase=self.timebase, metrics=self.metrics,
                logger=self.logger,
                targets=config.get_or_default("SLO_TARGETS", DEFAULT_TARGETS),
                ring=getattr(getattr(self.tpu, "costmodel", None), "ring", None),
                fast_s=float(config.get_or_default("SLO_BURN_FAST_S", "300")),
                fast_long_s=float(config.get_or_default("SLO_BURN_FAST_LONG_S", "3600")),
                slow_s=float(config.get_or_default("SLO_BURN_SLOW_S", "21600")),
                slow_long_s=float(config.get_or_default("SLO_BURN_SLOW_LONG_S", "259200")),
                fast_rate=float(config.get_or_default("SLO_BURN_FAST_RATE", "14.4")),
                slow_rate=float(config.get_or_default("SLO_BURN_SLOW_RATE", "6")),
                interval_s=float(config.get_or_default("SLO_EVAL_INTERVAL_S", "15")),
                start=True,
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
        if self.slo is not None:
            self.slo.close()
        if self.tpu is not None:
            self.tpu.close()
        self.timebase.close()
        self.postmortem.detach()
        if self._handler_pool is not None:
            self._handler_pool.shutdown(wait=False)
