"""Fleet front door: a thin router process that fronts N engine
replicas and stays correct when they misbehave (copy of
``gofr_tpu/fleet/``; the router, the breaker, admission, the replica set
and the fleet trace are host code and hold no kernel).

``wire_fleet(app)`` turns a plain ``gofr_tpu_torch.new()`` app into the
router: it reads the ``FLEET_*`` config keys, builds the
:class:`~gofr_tpu_torch.fleet.replica.ReplicaSet` (+ health prober), the
:class:`~gofr_tpu_torch.fleet.admission.QuotaTable` (redis-backed when the
container has redis), and the
:class:`~gofr_tpu_torch.fleet.router.FleetRouter`, registers the forwarded
serving routes plus ``GET /admin/fleet``, and hangs the router on
``container.fleet`` so readiness (``handler.py``) and graceful
shutdown (``app.py``) see it. ``python -m
gofr_tpu_torch.devtools.router_proc`` is the process entrypoint.

Config keys (all optional except ``FLEET_REPLICAS``):

- ``FLEET_REPLICAS`` — comma list of replica base URLs, optionally
  named: ``r0=http://host:8001,r1=http://host:8002`` (unnamed entries
  get ``r0``, ``r1``, ... in order).
- routing: ``FLEET_RETRIES`` (2), ``FLEET_DEADLINE_S`` (30),
  ``FLEET_CONNECT_TIMEOUT_S`` (2), ``FLEET_READ_TIMEOUT_S`` (30),
  ``FLEET_AFFINITY`` (on), ``FLEET_AFFINITY_MAX_SKEW`` (4).
- health: ``FLEET_PROBE_INTERVAL_S`` (1), ``FLEET_PROBE_TIMEOUT_S``
  (1), ``FLEET_PROBE_JITTER`` (0.2 — decorrelated per-replica jitter
  as a fraction of the interval; 0 restores the synchronized sweep),
  ``FLEET_PROBE_HEDGE_MS`` (0 = off), ``FLEET_OUT_AFTER`` (2),
  ``FLEET_PROBATION_PROBES`` (3).
- breaker: ``FLEET_BREAKER_THRESHOLD`` (5),
  ``FLEET_BREAKER_COOLDOWN_S`` (5).
- admission: ``FLEET_QUOTA_RPS`` (0 = off), ``FLEET_QUOTA_BURST``
  (2×rps), ``FLEET_QUOTA_CACHE_TTL_S`` (0.05 — short-TTL local lease
  cache over the redis bucket, the hot-key fix; 0 = a redis sync —
  two pipelined round trips — per request),
  ``FLEET_TRUST_TENANT_HEADER`` (off),
  ``FLEET_MAX_INFLIGHT`` (256), ``FLEET_SATURATION_QUEUE`` (64),
  ``FLEET_RETRY_AFTER_S`` (1).
- drain: ``FLEET_DRAIN_TIMEOUT_S`` (10).
- tracing: ``FLEET_TRACE_SCRAPE_TIMEOUT_S`` (1 — per-replica budget
  for the evidence scrapes behind ``GET /admin/fleet/trace/<id>``; a
  replica that cannot answer within it becomes an ``evidence_gaps``
  entry on a partial trace, not a stalled request).
- ``FLEET_ROUTES`` — the forwarded surface, comma-separated
  ``METHOD /path`` pairs (default: the OpenAI serving surface +
  ``/generate`` + ``/infer``).
"""

from __future__ import annotations

from typing import Any

__all__ = [
    "CircuitBreaker", "FleetRouter", "QuotaTable", "Replica",
    "ReplicaSet", "affinity_order", "parse_replicas", "wire_fleet",
]

_EXPORTS = {
    "QuotaTable": "gofr_tpu_torch.fleet.admission",
    "CircuitBreaker": "gofr_tpu_torch.fleet.breaker",
    "Replica": "gofr_tpu_torch.fleet.replica",
    "ReplicaSet": "gofr_tpu_torch.fleet.replica",
    "affinity_order": "gofr_tpu_torch.fleet.replica",
    "FleetRouter": "gofr_tpu_torch.fleet.router",
}


def __getattr__(name):  # PEP 562: kvwire importers (every replica's
    # pull path) must not pay for the router stack
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'gofr_tpu_torch.fleet' has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(module), name)

DEFAULT_ROUTES = (
    "POST /v1/completions,POST /v1/chat/completions,POST /v1/embeddings,"
    "GET /v1/models,POST /generate,POST /infer"
)


def parse_replicas(spec: str) -> list[tuple[str, str]]:
    """``FLEET_REPLICAS`` → ``[(name, url), ...]``. Entries are URLs or
    ``name=url``; unnamed entries are named ``r<index>``."""
    out: list[tuple[str, str]] = []
    seen: set[str] = set()
    for i, chunk in enumerate(spec.split(",")):
        chunk = chunk.strip()
        if not chunk:
            continue
        if "=" in chunk.split("://", 1)[0]:
            name, _, url = chunk.partition("=")
            name = name.strip()
        else:
            name, url = f"r{i}", chunk
        url = url.strip()
        if not url:
            raise ValueError(f"FLEET_REPLICAS entry '{chunk}' has no URL")
        if name in seen:
            raise ValueError(f"FLEET_REPLICAS names replica '{name}' twice")
        seen.add(name)
        out.append((name, url))
    return out


def wire_fleet(app: Any) -> FleetRouter:
    """Wire the fleet router onto ``app`` (see module docstring)."""
    from gofr_tpu_torch.fleet.admission import QuotaTable
    from gofr_tpu_torch.fleet.breaker import CircuitBreaker
    from gofr_tpu_torch.fleet.replica import Replica, ReplicaSet
    from gofr_tpu_torch.fleet.router import FleetRouter

    config = app.config
    container = app.container
    logger = app.logger
    spec = config.get("FLEET_REPLICAS") or ""
    replicas_cfg = parse_replicas(spec)
    if not replicas_cfg:
        raise ValueError(
            "FLEET_REPLICAS is required to run the fleet router "
            "(comma-separated replica base URLs)"
        )

    def _f(key: str, default: str) -> float:
        return float(config.get_or_default(key, default))

    def _i(key: str, default: str) -> int:
        return int(config.get_or_default(key, default))

    connect_t = _f("FLEET_CONNECT_TIMEOUT_S", "2")
    read_t = _f("FLEET_READ_TIMEOUT_S", "30")
    threshold = _i("FLEET_BREAKER_THRESHOLD", "5")
    cooldown = _f("FLEET_BREAKER_COOLDOWN_S", "5")
    replicas = [
        Replica(
            name, url, logger,
            connect_timeout=connect_t, read_timeout=read_t,
            breaker=CircuitBreaker(
                failure_threshold=threshold, cooldown_s=cooldown
            ),
        )
        for name, url in replicas_cfg
    ]
    replica_set = ReplicaSet(
        replicas, logger,
        probe_interval_s=_f("FLEET_PROBE_INTERVAL_S", "1"),
        probe_timeout_s=_f("FLEET_PROBE_TIMEOUT_S", "1"),
        probe_jitter=_f("FLEET_PROBE_JITTER", "0.2"),
        hedge_ms=_f("FLEET_PROBE_HEDGE_MS", "0"),
        out_after=_i("FLEET_OUT_AFTER", "2"),
        probation_probes=_i("FLEET_PROBATION_PROBES", "3"),
        saturation_queue=_i("FLEET_SATURATION_QUEUE", "64"),
        affinity_max_skew=_i("FLEET_AFFINITY_MAX_SKEW", "4"),
    )
    quota = QuotaTable(
        rate_rps=_f("FLEET_QUOTA_RPS", "0"),
        burst=_f("FLEET_QUOTA_BURST", "0"),
        # REDIS_HOST wires the container's redis: the buckets are then
        # shared fleet-wide
        redis=container.redis,
        logger=logger,
        metrics=container.metrics,
        cache_ttl_s=_f("FLEET_QUOTA_CACHE_TTL_S", "0.05"),
    )
    fleet = FleetRouter(
        logger, container.metrics, replica_set, quota,
        retries=_i("FLEET_RETRIES", "2"),
        deadline_s=_f("FLEET_DEADLINE_S", "30"),
        connect_timeout_s=connect_t,
        read_timeout_s=read_t,
        max_inflight=_i("FLEET_MAX_INFLIGHT", "256"),
        retry_after_s=_f("FLEET_RETRY_AFTER_S", "1"),
        # N routers run side by side (router HA): the id labels THIS
        # instance's /admin/fleet view; everything cross-instance is
        # redis-backed or stateless (see FleetRouter.router_id)
        router_id=config.get_or_default("FLEET_ROUTER_ID", ""),
    )
    if (config.get_or_default("FLEET_RESUME", "on") or "").lower() in (
        "off", "0", "false", "no"
    ):
        # resume off: a mid-stream upstream failure truncates the stream
        fleet.resume_enabled = False
    fleet.max_resumes = max(0, _i("FLEET_MAX_RESUMES", "4"))
    if (config.get_or_default("FLEET_AFFINITY", "on") or "").lower() in (
        "off", "0", "false", "no"
    ):
        # affinity off: every request routes least-outstanding
        fleet.affinity_enabled = False
    if (config.get_or_default("FLEET_ROLE_ROUTING", "on") or "").lower() in (
        "off", "0", "false", "no"
    ):
        # role routing off: replicas' advertised FLEET_ROLE is ignored
        # and no X-KV-Donor hints are stamped (pre-disaggregation
        # behavior)
        fleet.role_routing = False
    if (config.get_or_default("FLEET_TRUST_TENANT_HEADER", "off") or "").lower() in (
        "on", "1", "true", "yes"
    ):
        # ONLY behind an authenticating gateway that stamps X-Tenant:
        # trusted from arbitrary clients it makes quotas mintable
        fleet.trust_tenant_header = True
    # the container's bounded tenant sketch: the router meters its own
    # admissions and shed verdicts per tenant (/admin/tenants answers
    # on the front door too)
    fleet.tenants = getattr(container, "tenants", None)
    routes = config.get_or_default("FLEET_ROUTES", DEFAULT_ROUTES)
    for entry in routes.split(","):
        entry = entry.strip()
        if not entry:
            continue
        method, _, pattern = entry.partition(" ")
        pattern = pattern.strip()
        if not pattern:
            raise ValueError(
                f"FLEET_ROUTES entry '{entry}' must be 'METHOD /path'"
            )
        app.add_route(method.upper(), pattern, fleet.handle)
    from gofr_tpu_torch.handler import (
        fleet_admin_handler,
        fleet_overview_handler,
        fleet_trace_handler,
    )

    app.get("/admin/fleet", fleet_admin_handler)
    # fleet-wide causal trace for one request id (fleet/trace.py) and
    # the fleet rollup built from the prober's piggybacked scrapes
    app.get("/admin/fleet/trace/{id}", fleet_trace_handler)
    app.get("/admin/fleet/overview", fleet_overview_handler)
    container.fleet = fleet
    replica_set.start()
    logger.infof(
        "fleet router fronting %d replica(s): %s",
        len(replicas), ", ".join(f"{n}={u}" for n, u in replicas_cfg),
    )
    return fleet
