"""Fleet-scale chaos simulation (copy of ``gofr_tpu/devtools/fleetsim.py``;
the same seed gives the same trace and scenario digests): tens of echo
replicas behind the REAL router, driven by a seeded trace-driven load
generator while a scenario schedule injects overlapping faults — the
proving ground for the fleet's behaviour at scale without the hardware.

Three deterministic generators feed one live run:

- :func:`build_trace` — the traffic. Seeded RNG produces a schedule of
  requests with per-session prefix reuse (``X-Session-ID`` +
  shared-prefix token prompts, hitting rendezvous affinity and the
  prefix cache), Zipf tenant skew (the quota hot key), diurnal/burst
  phases, an ``X-Priority`` mix (tier 9 rides a dedicated low-volume
  tenant — the "never shed" cohort), and a fraction of streaming
  clients, some of which hard-abort mid-stream (RST, via
  :func:`~gofr_tpu_torch.devtools.chaos.abandoning_client`). Same seed ⇒
  byte-identical schedule (asserted via the sha256 digest recorded in
  the artifact).
- :func:`build_scenario` — the faults. A timed schedule of overlapping
  chaos: a replica wedge with recovery, a rolling drain, a redis quota
  outage, a slow-loris window, a mid-stream disconnect burst, a 5xx
  burst, and corrupted KV pulls against the prefill tier of a
  prefill/decode split topology. Every randomized choice draws from
  the seed, so a failing CI run replays locally with
  ``python -m gofr_tpu_torch.devtools.fleetsim --seed <seed from the
  artifact>``.
- :func:`hardening_report` — before/after micro-measures for the
  router-tier fixes the sim surfaced (probe fan-out jitter, the quota
  lease cache, lock-free selection), A/B'd through their config
  switches so the win is measured, not asserted.

:class:`FleetSim` boots the fleet (``chaos_fleet`` + ``chaos_router``),
drives the trace from a worker pool, runs the scenario on its own
thread, waits for the fleet to converge back to idle, and emits a
``FLEETSIM`` JSON artifact with fleet-level SLOs — p99 TTFT, shed rate
by priority, stream token-exactness (zero duplicated / zero missing on
seeded streams), resume outcomes, breaker flap count, pool convergence
— gated in CI by ``tools/fleetsim_gate.py`` against the committed
``fleetsim_baseline.json``.

Run it as a module (the counterpart of the JAX package's
``tools/fleetsim.py``; the lock sanitizer's ``--sanitize`` leg is not
ported)::

    python -m gofr_tpu_torch.devtools.fleetsim [--replicas 16]
        [--seed 20260803] [--requests 240] [--out FLEETSIM.json]
        [--no-hardening] [--replay capture.json] [--capture-out capture.json]

The artifact prints on stdout (and goes to ``--out``); gate it with
``python tools/fleetsim_gate.py FLEETSIM.json fleetsim_baseline.json``.
``--replay`` drives a ``TRACE_CAPTURE`` artifact (from
``gofr_tpu_torch.devtools.trace_capture`` or an earlier ``--capture-out``)
instead of a synthetic trace.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Optional

# priority tiers and their traffic share: tier 9 is the protected
# cohort (dedicated tenant, low volume — the gate asserts it is NEVER
# shed); the rest spread across sheddable/default tiers
DEFAULT_PRIORITY_MIX = ((0, 0.22), (3, 0.30), (5, 0.40), (9, 0.08))
# (name, fraction of requests, rps multiplier): a compressed diurnal
# curve with a burst spike — the load generator scales absolute rate by
# ``base_rps``
DEFAULT_PHASES = (
    ("night", 0.15, 0.5),
    ("morning", 0.25, 1.0),
    ("peak", 0.25, 2.0),
    ("burst", 0.15, 4.0),
    ("evening", 0.20, 1.0),
)


class TraceSpec:
    """Knobs for :func:`build_trace`. ``requests`` is the wall-time
    lever — CI scales trace length, never replica count (the whole
    point is N≥16)."""

    def __init__(
        self,
        requests: int = 240,
        sessions: int = 24,
        tenants: int = 12,
        zipf_alpha: float = 1.1,
        base_rps: float = 12.0,
        stream_fraction: float = 0.5,
        abort_fraction: float = 0.08,
        prefix_tokens: int = 24,
        turn_tokens: int = 4,
        max_new_tokens: int = 10,
        priority_mix: tuple = DEFAULT_PRIORITY_MIX,
        phases: tuple = DEFAULT_PHASES,
        seed: int = 0,
    ):
        self.requests = requests
        self.sessions = sessions
        self.tenants = tenants
        self.zipf_alpha = zipf_alpha
        self.base_rps = base_rps
        self.stream_fraction = stream_fraction
        self.abort_fraction = abort_fraction
        self.prefix_tokens = prefix_tokens
        self.turn_tokens = turn_tokens
        self.max_new_tokens = max_new_tokens
        self.priority_mix = priority_mix
        self.phases = phases
        self.seed = seed


def _digest(payload: Any) -> str:
    """Canonical-JSON sha256 — the replayability witness: same seed ⇒
    byte-identical schedule ⇒ identical digest."""
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _zipf_pick(rng: random.Random, weights: list[float]) -> int:
    total = sum(weights)
    mark = rng.random() * total
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w
        if mark <= acc:
            return i
    return len(weights) - 1


def _pick_priority(rng: random.Random, mix: tuple) -> int:
    mark = rng.random()
    acc = 0.0
    for tier, share in mix:
        acc += share
        if mark <= acc:
            return tier
    return mix[-1][0]


def build_trace(spec: TraceSpec) -> tuple[list[dict[str, Any]], str]:
    """The deterministic request schedule: ``(events, digest)``. Every
    event is a plain JSON-able dict; the digest is the replay
    contract (same seed ⇒ identical digest, asserted in tier-1)."""
    rng = random.Random(f"fleetsim-trace|{spec.seed}")
    prefixes = [
        [rng.randint(1, 997) for _ in range(spec.prefix_tokens)]
        for _ in range(spec.sessions)
    ]
    vip_prefixes = [
        [rng.randint(1, 997) for _ in range(spec.prefix_tokens)]
        for _ in range(2)
    ]
    tenant_weights = [
        1.0 / ((rank + 1) ** spec.zipf_alpha) for rank in range(spec.tenants)
    ]
    events: list[dict[str, Any]] = []
    at_s = 0.0
    counts = [max(1, int(spec.requests * frac)) for _, frac, _ in spec.phases]
    for (phase, _, mult), n in zip(spec.phases, counts):
        gap = 1.0 / max(0.1, spec.base_rps * mult)
        for _ in range(n):
            at_s += gap
            event = _trace_event(
                rng, spec, phase, round(at_s, 4), prefixes, vip_prefixes,
                tenant_weights,
            )
            event["i"] = len(events)
            events.append(event)
    return events, _digest(events)


def _trace_event(
    rng: random.Random, spec: TraceSpec, phase: str, at_s: float,
    prefixes: list, vip_prefixes: list, tenant_weights: list[float],
) -> dict[str, Any]:
    priority = _pick_priority(rng, spec.priority_mix)
    if priority == 9:
        # the protected cohort: its OWN tenant and sessions, sized well
        # under the quota rate so "tier 9 is never shed" is a property
        # of the system, not luck
        tenant = "t-platinum"
        session_idx = rng.randint(0, len(vip_prefixes) - 1)
        session = f"vip{session_idx}"
        base = vip_prefixes[session_idx]
    else:
        tenant_idx = _zipf_pick(rng, tenant_weights)
        tenant = f"t{tenant_idx:02d}"
        # sessions partitioned round-robin across tenants: the Zipf
        # head tenant's few sessions dominate -> heavy prefix reuse
        owned = [
            s for s in range(len(prefixes)) if s % spec.tenants == tenant_idx
        ] or [0]
        session_idx = owned[rng.randint(0, len(owned) - 1)]
        session = f"s{session_idx:03d}"
        base = prefixes[session_idx]
    # half the turns replay the session's exact base prompt (warm-KV /
    # transfer hits), half extend it (prefix reuse with fresh suffixes)
    if rng.random() < 0.5:
        prompt = list(base)
    else:
        prompt = list(base) + [
            rng.randint(1, 997) for _ in range(spec.turn_tokens)
        ]
    kind = "unary"
    abort_after = None
    if rng.random() < spec.stream_fraction:
        kind = "stream"
        if rng.random() < spec.abort_fraction:
            kind = "abort_stream"
            abort_after = rng.randint(2, 4)
    return {
        "at_s": at_s,
        "phase": phase,
        "tenant": tenant,
        "session": session,
        "priority": priority,
        "kind": kind,
        "abort_after": abort_after,
        "prompt": prompt,
        "max_tokens": rng.randint(6, spec.max_new_tokens),
        "seed": rng.randint(1, 10_000),
    }


def build_scenario(
    seed: int, n_replicas: int, n_prefill: int, duration_s: float,
    process_kill: bool = False, n_routers: int = 1,
) -> tuple[list[dict[str, Any]], str]:
    """The deterministic fault schedule: explicit paired events (every
    arm has its clear, every wedge its recover) so the digest captures
    the WHOLE incident timeline. The wedge/disconnect victim is AIMED
    at the hottest session's home replica, the rest draw from the
    seed; faults overlap by construction (wedge recovery overlaps the
    drain window, the redis outage overlaps both).

    ``process_kill=True`` layers REAL process death on top of the
    default schedule: two SIGKILLs of the fleet's subprocess-mode
    replica (its supervisor respawns it; the journal WAL rehydrates),
    and — when ``n_routers >= 2`` — a hard router-listener kill with a
    late restart, so a whole router-tier instance dies mid-trace and
    clients prove the fleet has no single point of failure by failing
    over to a sibling router."""
    from gofr_tpu_torch.fleet.replica import affinity_order

    rng = random.Random(f"fleetsim-scenario|{seed}")
    decode = list(range(n_prefill, n_replicas))
    # the wedge and the disconnect burst are AIMED: they hit the
    # replica the hottest session ("s000", the Zipf head tenant's
    # busiest) rendezvous-pins, so the chaos deterministically
    # intersects live traffic — the resume/failover paths must actually
    # run, not depend on a lucky victim draw. affinity_order is pure,
    # so the schedule stays a function of (seed, topology) and the
    # digest contract holds.
    names = [f"r{i}" for i in decode]
    hot = int(affinity_order("s000", names)[0][1:])
    others = [i for i in decode if i != hot] or [hot]
    victims = rng.sample(others, min(3, len(others)))
    drain_a, drain_b, burst_v = (victims + victims * 3)[:3]
    wedge_v = hot
    # the loris victim is AIMED like the wedge: the SECOND-hottest
    # session's home replica, so the slow window provably intersects
    # live streams (a randomly drawn victim at N=16 usually saw none
    # and the loris invariant went vacuous)
    warm = int(affinity_order("s001", names)[0][1:])
    loris_v = warm if warm != hot else others[0]
    t = duration_s
    events = [
        {"at_s": round(0.15 * t, 3), "op": "error_burst",
         "replica": burst_v, "n": 6, "status": 503},
        {"at_s": round(0.22 * t, 3), "op": "wedge", "replica": wedge_v},
        {"at_s": round(0.22 * t + min(4.0, 0.2 * t), 3), "op": "recover",
         "replica": wedge_v},
        {"at_s": round(0.30 * t, 3), "op": "redis_down"},
        {"at_s": round(0.30 * t + min(3.0, 0.15 * t), 3), "op": "redis_up"},
        {"at_s": round(0.40 * t, 3), "op": "drain", "replica": drain_a},
        {"at_s": round(0.40 * t + 1.5, 3), "op": "restart",
         "replica": drain_a},
        {"at_s": round(0.48 * t, 3), "op": "drain", "replica": drain_b},
        {"at_s": round(0.48 * t + 1.5, 3), "op": "restart",
         "replica": drain_b},
        {"at_s": round(0.55 * t, 3), "op": "slow_loris", "replica": loris_v,
         "delay_s": 0.08},
        {"at_s": round(0.55 * t + min(3.0, 0.15 * t), 3), "op": "clear",
         "replica": loris_v, "mode": "slow_loris"},
        {"at_s": round(0.62 * t, 3), "op": "disconnect", "replica": wedge_v,
         "chunks": 2, "shots": 2},
        {"at_s": round(0.62 * t + min(2.0, 0.1 * t), 3), "op": "clear",
         "replica": wedge_v, "mode": "disconnect_after"},
    ]
    if n_prefill > 0:
        donor = rng.randint(0, n_prefill - 1)
        events.append({
            "at_s": round(0.58 * t, 3), "op": "kv_corrupt",
            "replica": donor, "mode": "flip", "n": 2,
        })
    if process_kill:
        # process death layered on the default chaos: the kill at 0.35t
        # lands inside the peak phase and the second inside the burst,
        # so the SIGKILLed replica's respawn + WAL rehydration happen
        # under live traffic both times
        events.append({"at_s": round(0.35 * t, 3), "op": "process_kill"})
        events.append({"at_s": round(0.68 * t, 3), "op": "process_kill"})
        if n_routers >= 2:
            events.append({"at_s": round(0.45 * t, 3), "op": "router_kill",
                           "router": 0})
            events.append({"at_s": round(0.80 * t, 3),
                           "op": "router_restart", "router": 0})
    events.sort(key=lambda e: e["at_s"])
    return events, _digest(events)


class SimRedis:
    """The smallest redis the quota layer can talk to, with an outage
    switch: supports exactly the pipelined hget/hset/expire chains
    ``QuotaTable._take_redis`` issues, counts ``execute()`` round
    trips, and raises while :attr:`down` — the redis-quota-outage
    scenario without a real server to kill."""

    def __init__(self) -> None:
        self.hashes: dict[str, dict[str, str]] = {}
        self.execs = 0
        self.down = False
        self._lock = threading.Lock()

    def pipeline(self) -> "SimRedis._Pipe":
        return SimRedis._Pipe(self)

    class _Pipe:
        def __init__(self, owner: "SimRedis"):
            self._owner = owner
            self._ops: list[tuple] = []

        def hget(self, key: str, field: str) -> "SimRedis._Pipe":
            self._ops.append(("hget", key, field))
            return self

        def hset(self, key: str, field: str, value: Any) -> "SimRedis._Pipe":
            self._ops.append(("hset", key, field, str(value)))
            return self

        def expire(self, key: str, ttl: int) -> "SimRedis._Pipe":
            self._ops.append(("expire", key, ttl))
            return self

        def execute(self) -> list[Any]:
            owner = self._owner
            with owner._lock:
                if owner.down:
                    raise ConnectionError("fleetsim: injected redis outage")
                owner.execs += 1
                out: list[Any] = []
                for op in self._ops:
                    if op[0] == "hget":
                        out.append(owner.hashes.get(op[1], {}).get(op[2]))
                    elif op[0] == "hset":
                        owner.hashes.setdefault(op[1], {})[op[2]] = op[3]
                        out.append(1)
                    else:
                        out.append(1)
                return out


def _parse_metric_total(text: str, name: str,
                        labels: Optional[dict[str, str]] = None) -> float:
    """Sum every sample of ``name`` in a Prometheus exposition whose
    labels include ``labels``."""
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        rest = line[len(name):]
        if rest and rest[0] not in ("{", " "):
            continue  # a different metric sharing the prefix
        if labels:
            if not all(f'{k}="{v}"' in rest for k, v in labels.items()):
                continue
        try:
            total += float(line.rsplit(" ", 1)[1])
        except (ValueError, IndexError):
            continue
    return total


def _pct(values: list[float], q: float) -> Optional[float]:
    if not values:
        return None
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


class _NullLogger:
    def infof(self, *a: Any) -> None:
        pass

    def errorf(self, *a: Any) -> None:
        pass


class FleetSim:
    """One end-to-end simulation run: boot, drive, injure, converge,
    measure. ``run()`` returns the FLEETSIM artifact dict."""

    def __init__(
        self,
        n_replicas: int = 16,
        n_prefill: int = 2,
        seed: int = 0,
        spec: Optional[TraceSpec] = None,
        quota_rps: float = 4.0,
        quota_burst: float = 8.0,
        workers: int = 12,
        echo_step_ms: int = 2,
        measure_hardening: bool = True,
        progress: Any = None,
        n_routers: int = 1,
        scenario: str = "default",
        replay: Optional[dict[str, Any]] = None,
        capture_out: str = "",
    ):
        if scenario not in ("default", "process_kill"):
            raise ValueError(
                f"fleetsim scenario '{scenario}' not one of "
                "default | process_kill"
            )
        self.n_replicas = n_replicas
        self.n_prefill = min(n_prefill, max(0, n_replicas - 2))
        self.seed = seed
        self.spec = spec or TraceSpec(seed=seed)
        self.spec.seed = seed
        self.quota_rps = quota_rps
        self.quota_burst = quota_burst
        self.workers = workers
        self.echo_step_ms = echo_step_ms
        self.measure_hardening = measure_hardening
        self._progress = progress or (lambda msg: None)
        # router HA: N router instances front the same fleet; the load
        # workers spread across them and FAIL OVER on connection-level
        # errors — a dead router must cost a retry, not a request
        self.n_routers = max(1, n_routers)
        # "process_kill" adds a subprocess-mode replica (real OS
        # process under a Supervisor, journal WAL armed) and layers
        # SIGKILL + router-death events onto the default schedule
        self.scenario = scenario
        # replay: a TRACE_CAPTURE artifact (tools/trace_capture.py)
        # drives the run INSTEAD of build_trace — captured production
        # traffic reruns through the same harness, chaos, and SLO gate
        self.replay = replay
        # capture_out: scrape this run's OWN route/flight records into
        # a TRACE_CAPTURE file before teardown (the CI round trip:
        # sim -> capture -> replay, digests asserted at every step)
        self.capture_out = capture_out
        self._sp: Optional[Any] = None
        self._results: list[dict[str, Any]] = []
        self._results_lock = threading.Lock()
        self._chaos_log: list[dict[str, Any]] = []
        self.redis = SimRedis()

    # -- the run ---------------------------------------------------------------
    def run(self) -> dict[str, Any]:
        import contextlib as _contextlib
        import tempfile

        from gofr_tpu_torch.devtools.chaos import (
            SubprocessReplica,
            chaos_fleet,
            chaos_router,
        )

        if self.replay is not None:
            # a captured window replays verbatim: the events ARE the
            # schedule, and the digest re-derived here must match the
            # capture's own (the determinism witness survives the hop
            # through the file)
            trace = [dict(ev) for ev in self.replay["events"]]
            trace_digest = _digest(trace)
        else:
            trace, trace_digest = build_trace(self.spec)
        duration_s = trace[-1]["at_s"] if trace else 0.0
        scenario, scenario_digest = build_scenario(
            self.seed, self.n_replicas, self.n_prefill, duration_s,
            process_kill=self.scenario == "process_kill",
            n_routers=self.n_routers,
        )
        roles = [
            {"FLEET_ROLE": "prefill"} if i < self.n_prefill
            else {"FLEET_ROLE": "decode"}
            for i in range(self.n_replicas)
        ]
        # one decode replica runs pooled speculative decoding
        # (SPEC_POOLED + zero-weight n-gram drafting): echo spec output
        # is bit-identical by construction, so the trace's token-
        # exactness invariant now also covers spec streams — rollback,
        # adaptive k, and the brownout clamp soak under the same chaos
        # schedule and SLO gate as every other replica
        spec_replica = self.n_replicas - 1
        if spec_replica >= self.n_prefill:
            roles[spec_replica] = dict(
                roles[spec_replica], SPEC_POOLED="on", SPEC_K_MAX="4",
            )
        self._progress(
            f"fleetsim: booting {self.n_replicas} replicas "
            f"({self.n_prefill} prefill) for a {duration_s:.1f}s trace "
            f"of {len(trace)} requests (seed {self.seed})"
        )
        with chaos_fleet(
            self.n_replicas, seed=self.seed,
            env={"ECHO_STEP_MS": str(self.echo_step_ms),
                 "KV_TRANSFER_TIMEOUT_S": "1"},
            per_replica_env=roles,
        ) as replicas, _contextlib.ExitStack() as stack:
            members = list(replicas)
            if self.scenario == "process_kill":
                # the kill victim is a REAL OS process: supervised, WAL
                # armed, advertised as one more decode replica
                journal_dir = stack.enter_context(
                    tempfile.TemporaryDirectory(prefix="fleetsim-wal-")
                )
                sp = SubprocessReplica(
                    f"r{self.n_replicas}",
                    env={
                        "ECHO_STEP_MS": str(self.echo_step_ms),
                        "JOURNAL_DIR": journal_dir,
                        "FLEET_ROLE": "decode",
                        "KV_TRANSFER_TIMEOUT_S": "1",
                    },
                    backoff_s=0.2, backoff_max_s=0.5,
                )
                sp.start()
                stack.callback(sp.close)
                sp.wait_ready(30)
                self._sp = sp
                members.append(sp)
            routers = [
                stack.enter_context(
                    chaos_router(members, env=self._router_env(i))
                )
                for i in range(self.n_routers)
            ]
            self._routers = routers
            for router_app in routers:
                # one shared quota backend across ALL router instances:
                # outage-able, trip-counted — the redis-backed half of
                # the router-HA story
                router_app.container.fleet.quota._redis = self.redis
            fleet = routers[-1].container.fleet
            bases = [
                f"http://127.0.0.1:{router_app.http_port}"
                for router_app in routers
            ]
            for router_app in routers:
                self._await(
                    lambda: len(
                        router_app.container.fleet.replica_set.in_rotation()
                    ) == len(members),
                    timeout=30, message="all replicas in rotation",
                )
            self._warm_donors(replicas, trace)
            self._progress("fleetsim: driving load + chaos")
            self._drive(bases, trace, scenario, replicas, routers)
            self._progress("fleetsim: waiting for fleet convergence")
            converged = self._converge(fleet, members)
            artifact = self._collect(
                bases, routers, members, trace, trace_digest, scenario,
                scenario_digest, duration_s, converged,
            )
            if self.replay is not None:
                artifact["trace"]["replay_of"] = self.replay.get("digest")
            if self.capture_out:
                self._progress(
                    f"fleetsim: capturing served trace -> {self.capture_out}"
                )
                artifact["capture"] = self._capture(routers, members)
        self._sp = None
        if self.measure_hardening:
            self._progress("fleetsim: measuring hardening before/after")
            artifact["hardening"] = hardening_report()
            artifact["hardening"]["quota"]["live_syncs_per_request"] = (
                artifact["quota"]["syncs_per_request"]
            )
        return artifact

    def _router_env(self, index: int = 0) -> dict[str, str]:
        return {
            "FLEET_ROUTER_ID": f"router-{index}",
            # 0.25s keeps eviction sub-second (OUT_AFTER=2) while the
            # probe plane stays ~128 req/s at N=16 — at 0.1s the probe
            # fan-out alone starved the data plane on the 2-core CI box
            "FLEET_PROBE_INTERVAL_S": "0.25",
            "FLEET_PROBE_JITTER": "0.3",
            "FLEET_PROBE_TIMEOUT_S": "1",
            "FLEET_OUT_AFTER": "2",
            "FLEET_PROBATION_PROBES": "2",
            "FLEET_RETRIES": "3",
            "FLEET_DEADLINE_S": "20",
            "FLEET_CONNECT_TIMEOUT_S": "2",
            "FLEET_READ_TIMEOUT_S": "10",
            "FLEET_QUOTA_RPS": str(self.quota_rps),
            "FLEET_QUOTA_BURST": str(self.quota_burst),
            "FLEET_QUOTA_CACHE_TTL_S": "0.05",
            "FLEET_TRUST_TENANT_HEADER": "on",
            "FLEET_MAX_INFLIGHT": "256",
        }

    @staticmethod
    def _await(cond: Any, timeout: float, message: str,
               interval: float = 0.05) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return True
            time.sleep(interval)
        return False

    def _warm_donors(self, replicas: list, trace: list[dict]) -> None:
        """Pre-serve a few hot base prompts on the prefill tier so the
        decode tier's donor pulls find warm KV (the transfer path the
        kv_corrupt scenario then injures). Bounded: the hottest 6
        distinct prompts only."""
        if not self.n_prefill:
            return
        seen: dict[str, list[int]] = {}
        for ev in trace:
            if ev["kind"] != "unary" and len(ev["prompt"]) > 0:
                seen.setdefault(
                    ",".join(map(str, ev["prompt"])), ev["prompt"]
                )
            if len(seen) >= 6:
                break
        donor = replicas[0]
        for prompt in seen.values():
            try:
                self._post_json(
                    donor.address + "/generate",
                    {"tokens": prompt, "max_new_tokens": 2}, {}, 10,
                )
            except Exception:
                pass  # warm-up is best-effort; cold donors just fall back

    # -- load + chaos drivers --------------------------------------------------
    def _drive(self, bases: list[str], trace: list[dict],
               scenario: list[dict], replicas: list,
               routers: list) -> None:
        start = time.monotonic()
        cursor = {"i": 0}
        cursor_cv = threading.Condition()
        self._cursor, self._cursor_cv, self._fence = cursor, cursor_cv, None

        def worker() -> None:
            while True:
                with cursor_cv:
                    i = cursor["i"]
                    if i >= len(trace):
                        return
                    cursor["i"] = i + 1
                    cursor_cv.notify_all()
                    # an event at or past the fault being armed waits for
                    # it: the fault meets the traffic it was aimed at
                    cursor_cv.wait_for(
                        lambda: self._fence is None or i < self._fence, timeout=5.0)
                ev = trace[i]
                delay = start + ev["at_s"] - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                result = self._do_request(bases, ev)
                with self._results_lock:
                    self._results.append(result)

        threads = [
            threading.Thread(
                target=worker, name=f"gofr-fleetsim-load-{w}", daemon=True
            )
            for w in range(self.workers)
        ]
        chaos_thread = threading.Thread(
            target=self._run_scenario,
            args=(start, scenario, replicas, routers, len(trace),
                  trace[-1]["at_s"] if trace else 0.0),
            name="gofr-fleetsim-chaos", daemon=True,
        )
        for t in threads:
            t.start()
        chaos_thread.start()
        for t in threads:
            t.join(timeout=120)
        chaos_thread.join(timeout=60)

    def _run_scenario(self, start: float, scenario: list[dict],
                      replicas: list, routers: list, n_trace: int,
                      duration_s: float) -> None:
        """Apply the fault schedule. Each event waits for its wall-clock
        mark AND for the load to have dispatched the matching FRACTION
        of the trace: on a fast box the two coincide (dispatch is
        wall-paced), but on a loaded box the workers lag the clock, and
        a purely wall-timed fault window (the disconnect burst, the
        slow-loris window) would open and close before any traffic
        reached the victim — the committed baseline's flagship resume
        invariants were passing VACUOUSLY because no stream ever got
        cut. Progress-gating pins the chaos to the traffic, so the
        faults it was aimed at actually intersect it. While an event waits
        for its index, a fence holds the workers' events from that index on
        until it is applied (the JAX package's harness polls the cursor
        every 20 ms, and a request path faster than that reaches the victim
        before the fault is armed)."""
        for ev in scenario:
            delay = start + ev["at_s"] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            want_i = int(n_trace * ev["at_s"] / max(duration_s, 0.001))
            with self._cursor_cv:
                self._fence = min(want_i, n_trace)
            try:
                self._await_dispatched(self._fence)
                note = self._apply_chaos(ev, replicas, routers)
                entry = dict(ev, applied=True)
                if note:
                    entry.update(note)
                self._chaos_log.append(entry)
            except Exception as exc:
                self._chaos_log.append(dict(ev, applied=False, error=str(exc)))
            finally:
                with self._cursor_cv:
                    self._fence = None
                    self._cursor_cv.notify_all()
        # terminal safety: whatever the schedule left armed comes off
        for r in replicas:
            r.chaos.clear()
            r.recover()
            r.start_listener()
        for router_app in routers:
            self._restart_router(router_app)
        with self.redis._lock:
            self.redis.down = False

    def _await_dispatched(self, want_i: int, timeout: float = 120.0) -> None:
        """Block until the load workers have dispatched ``want_i`` trace
        events (bounded: a wedged load plane must not stall the fault
        schedule forever — the terminal-safety sweep still runs)."""
        with self._cursor_cv:
            self._cursor_cv.wait_for(lambda: self._cursor["i"] >= want_i, timeout=timeout)

    @staticmethod
    def _restart_router(router_app: Any) -> None:
        from gofr_tpu_torch.http.server import HTTPServer

        if router_app.http_server is None:
            router_app.http_server = HTTPServer(
                router_app.router, router_app.http_port, router_app.logger
            )
            router_app.http_server.run_in_thread()

    def _apply_chaos(self, ev: dict, replicas: list,
                     routers: list) -> Optional[dict]:
        op = ev["op"]
        if op == "process_kill":
            # SIGKILL the subprocess victim: its supervisor respawns it
            # (None = the previous kill's respawn has not finished yet;
            # the event still counts as applied, the log records it)
            pid = self._sp.kill9() if self._sp is not None else None
            return {"pid": pid}
        if op == "router_kill":
            router_app = routers[ev["router"]]
            if router_app.http_server is not None:
                router_app.http_server.shutdown()
                router_app.http_server = None
            return None
        if op == "router_restart":
            self._restart_router(routers[ev["router"]])
            return None
        target = replicas[ev["replica"]] if "replica" in ev else None
        if op == "error_burst":
            target.chaos.error_burst(ev["n"], status=ev["status"])
        elif op == "wedge":
            target.wedge()
        elif op == "recover":
            target.recover()
        elif op == "drain":
            target.stop_listener()
        elif op == "restart":
            target.start_listener()
        elif op == "redis_down":
            with self.redis._lock:
                self.redis.down = True
        elif op == "redis_up":
            with self.redis._lock:
                self.redis.down = False
        elif op == "slow_loris":
            target.chaos.slow_loris(ev["delay_s"], paths=("/v1/",))
        elif op == "disconnect":
            target.chaos.disconnect_after(ev["chunks"], paths=("/v1/",),
                                          shots=ev.get("shots"))
        elif op == "clear":
            target.chaos.clear(ev["mode"])
        elif op == "kv_corrupt":
            target.chaos.corrupting_proxy(mode=ev["mode"], n=ev["n"])
        else:
            raise ValueError(f"unknown scenario op '{op}'")

    # -- one request -----------------------------------------------------------
    def _headers(self, ev: dict) -> dict[str, str]:
        return {
            "Content-Type": "application/json",
            "X-Tenant": ev["tenant"],
            "X-Session-ID": ev["session"],
            "X-Priority": str(ev["priority"]),
        }

    @staticmethod
    def _post_json(url: str, payload: dict, headers: dict,
                   timeout: float) -> tuple[int, bytes]:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode("utf-8"),
            headers=dict({"Content-Type": "application/json"}, **headers),
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()

    def _do_request(self, bases: list[str], ev: dict) -> dict[str, Any]:
        """One trace event against the router tier. The worker spreads
        requests across the N router instances and FAILS OVER on a
        connection-level error (refused, reset, a stream severed by a
        dying router): no-single-point-of-failure means a dead router
        costs the client one retry against a sibling — deterministic
        requests replay bit-identically, so a from-scratch retry is
        sound. App-level verdicts (HTTP status) never fail over: a 429
        from router A would be a 429 from router B too (shared quota)."""
        out: dict[str, Any] = {
            "i": ev["i"], "kind": ev["kind"], "priority": ev["priority"],
            "tenant": ev["tenant"], "phase": ev["phase"],
            "outcome": "error", "status": 0, "ttft_ms": None,
            "router_failovers": 0,
        }
        t0 = time.monotonic()
        first = ev["i"] % len(bases)
        order = bases[first:] + bases[:first]
        for attempt, base in enumerate(order):
            try:
                if ev["kind"] == "abort_stream":
                    self._do_abort_stream(base, ev, out)
                elif ev["kind"] == "stream":
                    self._do_stream(base, ev, out, t0)
                else:
                    self._do_unary(base, ev, out, t0)
                break
            except urllib.error.HTTPError as exc:
                self._note_http_error(exc, out)
                break
            except Exception as exc:
                if attempt + 1 < len(order):
                    out["router_failovers"] += 1
                    continue
                out["outcome"] = "error"
                out["error"] = f"{type(exc).__name__}: {exc}"
        out["elapsed_ms"] = round((time.monotonic() - t0) * 1000, 2)
        return out

    @staticmethod
    def _note_http_error(exc: urllib.error.HTTPError, out: dict) -> None:
        out["status"] = exc.code
        body = b""
        try:
            body = exc.read()
        except Exception:
            pass
        reason = ""
        try:
            reason = json.loads(body.decode("utf-8"))["error"].get(
                "reason", ""
            )
        except Exception:
            pass
        if exc.code in (429, 503) and reason:
            out["outcome"] = "shed"
            out["shed_reason"] = reason
        elif exc.code == 429:
            out["outcome"] = "shed"
            out["shed_reason"] = "upstream_429"
        else:
            out["outcome"] = "error"
            out["error"] = f"http {exc.code}"

    def _do_unary(self, base: str, ev: dict, out: dict, t0: float) -> None:
        status, body = self._post_json(
            base + "/generate",
            {"tokens": ev["prompt"], "max_new_tokens": ev["max_tokens"]},
            self._headers(ev), timeout=30,
        )
        out["status"] = status
        out["ttft_ms"] = round((time.monotonic() - t0) * 1000, 2)
        data = json.loads(body.decode("utf-8"))["data"]
        out["outcome"] = (
            "ok" if data.get("count") == ev["max_tokens"] else "bad_count"
        )

    def _do_stream(self, base: str, ev: dict, out: dict, t0: float) -> None:
        payload = {
            "model": "echo", "prompt": ev["prompt"],
            "max_tokens": ev["max_tokens"], "stream": True,
            "seed": ev["seed"],
        }
        req = urllib.request.Request(
            base + "/v1/completions",
            data=json.dumps(payload).encode("utf-8"),
            headers=self._headers(ev), method="POST",
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            out["status"] = resp.status
            first = resp.read(1)
            out["ttft_ms"] = round((time.monotonic() - t0) * 1000, 2)
            raw = first
            while True:
                chunk = resp.read(65536)
                if not chunk:
                    break
                raw += chunk
        tokens = _sse_tokens(raw)
        expected = [
            ev["prompt"][i % len(ev["prompt"])]
            for i in range(ev["max_tokens"])
        ]
        out["verified"] = True
        out["complete"] = b"data: [DONE]" in raw
        out["missing"] = max(0, len(expected) - len(tokens))
        out["duplicated"] = max(0, len(tokens) - len(expected))
        out["token_exact"] = tokens == expected
        out["outcome"] = "ok" if out["token_exact"] and out["complete"] else (
            "stream_mismatch"
        )

    def _do_abort_stream(self, base: str, ev: dict, out: dict) -> None:
        from gofr_tpu_torch.devtools.chaos import abandoning_client

        payload = {
            "model": "echo", "prompt": ev["prompt"],
            "max_tokens": max(ev["max_tokens"], 8), "stream": True,
            "seed": ev["seed"],
        }
        frames = abandoning_client(
            base, "/v1/completions",
            json.dumps(payload).encode("utf-8"),
            frames=ev["abort_after"] or 2,
            headers={k: v for k, v in self._headers(ev).items()
                     if k != "Content-Type"},
        )
        out["outcome"] = "client_aborted"
        out["status"] = 200 if frames else 0
        out["frames_before_abort"] = len(frames)

    # -- convergence + collection ----------------------------------------------
    def _converge(self, fleet: Any, members: list) -> dict[str, Any]:
        rotation_ok = self._await(
            lambda: len(fleet.replica_set.in_rotation()) == len(members),
            timeout=30, message="rotation recovered",
        )
        pools_ok = self._await(
            lambda: all(self._pool_idle(r) for r in members),
            timeout=30, message="pools idle",
        )
        return {"rotation": rotation_ok, "pools_idle": pools_ok}

    @staticmethod
    def _pool_idle(replica: Any) -> bool:
        try:
            req = urllib.request.Request(replica.address + "/admin/engine")
            with urllib.request.urlopen(req, timeout=5) as resp:
                data = json.loads(resp.read().decode("utf-8"))["data"]
        except Exception:
            return False
        if (data.get("engine") or {}).get("state") != "serving":
            return False
        kv = data.get("kv_blocks") or {}
        return int(kv.get("active") or 0) == 0

    def _collect(
        self, bases: list[str], routers: list, members: list, trace: list,
        trace_digest: str, scenario: list, scenario_digest: str,
        duration_s: float, converged: dict,
    ) -> dict[str, Any]:
        with self._results_lock:
            results = list(self._results)
        metrics_text = ""
        for base in bases:
            # summed across router instances: resume outcomes and
            # breaker flaps are per-instance views of one fleet
            try:
                req = urllib.request.Request(base + "/metrics")
                with urllib.request.urlopen(req, timeout=10) as resp:
                    metrics_text += resp.read().decode("utf-8") + "\n"
            except Exception:
                continue
        admitted = denied = 0
        quota_stats: dict[str, Any] = {}
        for router_app in routers:
            stats = router_app.container.fleet.quota.stats()
            admitted += stats["admitted"]
            denied += stats["denied"]
            quota_stats = stats  # representative knobs; counts summed below
        quota_stats = dict(quota_stats, admitted=admitted, denied=denied)
        decisions = max(1, admitted + denied)
        injected: dict[str, int] = {}
        for r in members:
            chaos = getattr(r, "chaos", None)
            if chaos is None:
                continue  # subprocess replicas carry no in-proc chaos
            for mode, n in chaos.injected.items():
                injected[mode] = injected.get(mode, 0) + n
        return {
            "kind": "FLEETSIM",
            "schema": 1,
            "seed": self.seed,
            "replicas": self.n_replicas,
            "prefill_replicas": self.n_prefill,
            "routers": self.n_routers,
            "scenario_mode": self.scenario,
            "process_kill": self._process_kill_block(),
            # the pooled-spec-enabled decode replica (-1 = none at this
            # topology): its streams ride the same token-exactness gate
            "spec_replica": (
                self.n_replicas - 1
                if self.n_replicas - 1 >= self.n_prefill else -1
            ),
            "trace": {
                "requests": len(trace),
                "digest": trace_digest,
                "duration_s": round(duration_s, 2),
            },
            "scenario": {
                "digest": scenario_digest,
                "events": scenario,
                "applied": self._chaos_log,
                "injected": injected,
            },
            "slo": self._slo(results, metrics_text, converged),
            "quota": {
                "backend_trips": self.redis.execs,
                "syncs_per_request": round(
                    self.redis.execs / (2.0 * decisions), 3
                ),
                "stats": quota_stats,
            },
        }

    def _capture(self, routers: list, members: list) -> dict[str, Any]:
        """Scrape this run's OWN route + flight records into a
        TRACE_CAPTURE file (tools/trace_capture.py schema): the run's
        served traffic becomes a replayable regression trace, and the
        CI round trip (sim -> capture -> --replay) asserts the digest
        at every hop."""
        from gofr_tpu_torch.devtools.trace_capture import capture_artifact

        routes: list[dict[str, Any]] = []
        for router_app in routers:
            routes.extend(router_app.container.fleet.records(limit=5000))
        flights: list[dict[str, Any]] = []
        for member in members:
            app = getattr(member, "app", None)
            if app is not None:  # in-process replica: read directly
                flights.extend(app.container.telemetry.records(limit=5000))
                continue
            try:  # subprocess replica: over the wire
                req = urllib.request.Request(
                    member.address + "/admin/requests?limit=1000"
                )
                with urllib.request.urlopen(req, timeout=10) as resp:
                    data = json.loads(resp.read().decode("utf-8"))
                if isinstance(data, dict) and isinstance(
                    data.get("data"), dict
                ):
                    data = data["data"]
                flights.extend(data.get("requests") or [])
            except Exception:
                continue  # a dead victim's flights are simply absent
        artifact = capture_artifact(
            routes, flights, self.seed,
            source={"fleetsim_seed": self.seed, "routers": len(routers),
                    "replicas": len(members)},
        )
        with open(self.capture_out, "w") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)
            f.write("\n")
        return {"path": self.capture_out, "requests": artifact["requests"],
                "digest": artifact["digest"], "dropped": artifact["dropped"]}

    def _process_kill_block(self) -> Optional[dict[str, Any]]:
        """The process-death evidence: kills applied, supervisor
        respawns, and the victim's WAL rehydration count (scraped off
        its /admin/engine journal block)."""
        if self._sp is None:
            return None
        rehydrated = None
        try:
            req = urllib.request.Request(self._sp.address + "/admin/engine")
            with urllib.request.urlopen(req, timeout=5) as resp:
                data = json.loads(resp.read().decode("utf-8"))["data"]
            rehydrated = (data.get("journal") or {}).get("rehydrated")
        except Exception:
            pass
        kills = [
            e for e in self._chaos_log
            if e.get("op") == "process_kill" and e.get("applied")
        ]
        router_kills = [
            e for e in self._chaos_log
            if e.get("op") == "router_kill" and e.get("applied")
        ]
        return {
            "victim": self._sp.name,
            "replica_kills": len([e for e in kills if e.get("pid")]),
            "router_kills": len(router_kills),
            "supervisor_restarts": self._sp.supervisor.restarts,
            "victim_rehydrated": rehydrated,
        }

    def _slo(self, results: list[dict], metrics_text: str,
             converged: dict) -> dict[str, Any]:
        ttfts = [r["ttft_ms"] for r in results
                 if r.get("ttft_ms") is not None and r["outcome"] == "ok"]
        sheds = [r for r in results if r["outcome"] == "shed"]
        shed_by_priority: dict[str, int] = {}
        for r in sheds:
            key = str(r["priority"])
            shed_by_priority[key] = shed_by_priority.get(key, 0) + 1
        verified = [r for r in results if r.get("verified")]
        errors = [r for r in results if r["outcome"] in (
            "error", "bad_count", "stream_mismatch"
        )]
        resumes = {
            outcome: int(_parse_metric_total(
                metrics_text, "gofr_tpu_router_stream_resumes_total",
                {"outcome": outcome},
            ))
            for outcome in ("resumed", "exhausted", "refused")
        }
        return {
            "requests": len(results),
            "ok": sum(1 for r in results if r["outcome"] == "ok"),
            "client_aborted": sum(
                1 for r in results if r["outcome"] == "client_aborted"
            ),
            "errors": len(errors),
            "error_detail": [
                {k: r.get(k) for k in ("i", "kind", "status", "error")}
                for r in errors[:10]
            ],
            "ttft_p50_ms": _pct(ttfts, 0.50),
            "ttft_p99_ms": _pct(ttfts, 0.99),
            "shed": {
                "total": len(sheds),
                "rate": round(len(sheds) / max(1, len(results)), 4),
                "by_priority": shed_by_priority,
                "p9": shed_by_priority.get("9", 0),
            },
            "streams": {
                "verified": len(verified),
                "token_exact": sum(
                    1 for r in verified if r.get("token_exact")
                ),
                "duplicated_tokens": sum(
                    r.get("duplicated", 0) for r in verified
                ),
                "missing_tokens": sum(
                    r.get("missing", 0) for r in verified
                ),
            },
            "resume": dict(resumes, failures=(
                resumes["exhausted"] + resumes["refused"]
            )),
            "router_failovers": sum(
                r.get("router_failovers", 0) for r in results
            ),
            "breaker_flaps": int(_parse_metric_total(
                metrics_text, "gofr_tpu_router_breaker_transitions_total"
            )),
            "converged": converged,
            "pools_idle": bool(converged.get("pools_idle")),
            "tenants": _tenant_slo_lines(results),
        }


# per-tenant availability targets in the artifact's SLO block: the
# protected tier-9 cohort carries the tighter target the serving
# default SLO_TARGETS declares for tier 9; everyone else the global one
TENANT_SLO_TARGETS = {"t-platinum": 0.9995}
TENANT_SLO_DEFAULT_TARGET = 0.999


def _tenant_slo_lines(results: list[dict]) -> list[dict[str, Any]]:
    """Per-tenant SLO lines for the artifact: availability + remaining
    error budget per tenant, computed the SLO engine's way (sheds and
    errors burn; client aborts are the CLIENT's verdict and leave the
    eligible set). The gate pins the protected cohort on these lines —
    "t-platinum never exhausts its budget under default chaos" is a CI
    invariant, not a dashboard hope."""
    by_tenant: dict[str, dict[str, int]] = {}
    for r in results:
        row = by_tenant.setdefault(
            r["tenant"], {"requests": 0, "ok": 0, "sheds": 0, "errors": 0,
                          "client_aborted": 0}
        )
        row["requests"] += 1
        outcome = r["outcome"]
        if outcome == "ok":
            row["ok"] += 1
        elif outcome == "shed":
            row["sheds"] += 1
        elif outcome == "client_aborted":
            row["client_aborted"] += 1
        else:  # error / bad_count / stream_mismatch
            row["errors"] += 1
    lines = []
    for tenant, row in sorted(by_tenant.items()):
        target = TENANT_SLO_TARGETS.get(tenant, TENANT_SLO_DEFAULT_TARGET)
        budget = 1.0 - target
        eligible = row["requests"] - row["client_aborted"]
        bad = row["errors"] + row["sheds"]
        bad_fraction = bad / eligible if eligible else 0.0
        lines.append(dict(
            row,
            tenant=tenant,
            availability=round(1.0 - bad_fraction, 6),
            target=target,
            budget_remaining=round(1.0 - bad_fraction / budget, 4),
        ))
    return lines


def _sse_tokens(raw: bytes) -> list[int]:
    """Token ids delivered by one SSE completion body, in order."""
    tokens: list[int] = []
    for block in raw.split(b"\n\n"):
        for line in block.split(b"\n"):
            if not line.startswith(b"data:"):
                continue
            data = line[5:].strip()
            if data == b"[DONE]" or not data.startswith(b"{"):
                continue
            try:
                frame = json.loads(data)
            except ValueError:
                continue
            choices = frame.get("choices") or []
            if choices and choices[0].get("tokens"):
                tokens.extend(choices[0]["tokens"])
    return tokens


# -- hardening before/after measures ------------------------------------------
#
# Each router-tier fix keeps its "before" reachable through config
# (jitter 0, cache TTL 0), so the FLEETSIM artifact carries a MEASURED
# improvement, not a claimed one.

def measure_probe_spread(
    n_replicas: int = 16, interval_s: float = 0.1, jitter: float = 0.3,
    duration_s: float = 2.4, window_s: float = 0.02,
) -> dict[str, Any]:
    """Probe fan-out synchrony for one jitter setting: run a stubbed
    prober (no HTTP — scheduling is what changed) over ``n_replicas``
    and report the largest number of probes landing inside any
    ``window_s`` burst window at STEADY STATE (the first half of the
    run is warm-up: decorrelated jitter needs a few rounds to drift
    initially-near phases apart). The synchronized sweep puts a whole
    round (= ``n_replicas``) in one window every interval, forever; the
    jittered schedule converges toward the uniform expectation
    (``n_replicas * window / interval``)."""
    from gofr_tpu_torch.fleet.replica import Replica, ReplicaSet

    times: list[float] = []
    times_lock = threading.Lock()

    class _RecordingSet(ReplicaSet):
        def probe_once(self, replica: Any) -> bool:
            with times_lock:
                times.append(time.monotonic())
            return True

    logger = _NullLogger()
    replicas = [
        Replica(f"m{i}", "http://127.0.0.1:9", logger)
        for i in range(n_replicas)
    ]
    start = time.monotonic()
    rset = _RecordingSet(
        replicas, logger, probe_interval_s=interval_s,
        probe_jitter=jitter,
    ).start()
    time.sleep(duration_s)
    rset.close()
    with times_lock:
        stamps = sorted(t for t in times if t - start >= duration_s / 2)
    max_burst = 0
    for i, t0 in enumerate(stamps):
        burst = sum(1 for t in stamps[i:] if t - t0 <= window_s)
        max_burst = max(max_burst, burst)
    return {
        "jitter": jitter,
        "probes": len(stamps),
        "window_ms": round(window_s * 1000, 1),
        "uniform_expectation": round(
            n_replicas * window_s / interval_s, 1
        ),
        "max_probes_in_window": max_burst,
        "burst_fraction": round(max_burst / max(1, n_replicas), 3),
    }


def measure_quota_trips(requests: int = 300,
                        cache_ttl_s: float = 0.05) -> dict[str, Any]:
    """Redis round trips per admission decision for one cache setting:
    hammer one hot tenant (the Zipf head) through a QuotaTable backed
    by a trip-counting fake redis. TTL 0 is the pre-cache behavior —
    one sync (two pipelined trips) per request."""
    from gofr_tpu_torch.fleet.admission import QuotaTable

    redis = SimRedis()
    table = QuotaTable(
        rate_rps=1000.0, burst=2000.0, redis=redis,
        cache_ttl_s=cache_ttl_s,
    )
    for _ in range(requests):
        table.take("hot-tenant")
    return {
        "cache_ttl_s": cache_ttl_s,
        "requests": requests,
        "backend_execs": redis.execs,
        "syncs_per_request": round(redis.execs / (2.0 * requests), 3),
        "cache_hits": table.stats()["cache_hits"],
    }


def measure_selection_latency(n_replicas: int = 16,
                              rounds: int = 2000) -> dict[str, Any]:
    """p50 of one router selection (``candidates()`` with an affinity
    key) over a full-size healthy fleet — the lock-free-outstanding /
    counted-tie-break fast path's regression watch."""
    from gofr_tpu_torch.fleet.replica import Replica, ReplicaSet

    logger = _NullLogger()
    replicas = [
        Replica(f"m{i}", "http://127.0.0.1:9", logger)
        for i in range(n_replicas)
    ]
    rset = ReplicaSet(replicas, logger, probe_interval_s=3600)
    samples: list[float] = []
    for i in range(rounds):
        t0 = time.perf_counter()
        rset.candidates(f"conv-{i % 32}")
        samples.append((time.perf_counter() - t0) * 1e6)
    return {
        "replicas": n_replicas,
        "rounds": rounds,
        "selection_p50_us": round(_pct(samples, 0.5) or 0.0, 2),
        "selection_p99_us": round(_pct(samples, 0.99) or 0.0, 2),
    }


def hardening_report() -> dict[str, Any]:
    """The artifact's ``hardening`` block: before/after for the probe
    jitter and the quota lease cache (A/B through config), plus the
    live selection latency."""
    return {
        "probe_spread": {
            "before": measure_probe_spread(jitter=0.0),
            "after": measure_probe_spread(jitter=0.3),
        },
        "quota": {
            "before": measure_quota_trips(cache_ttl_s=0.0),
            "after": measure_quota_trips(cache_ttl_s=0.05),
        },
        "selection": measure_selection_latency(),
    }


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(description="fleet-scale chaos simulation")
    parser.add_argument("--replicas", type=int, default=16)
    parser.add_argument("--prefill", type=int, default=2,
                        help="replicas advertising the prefill role")
    parser.add_argument("--seed", type=int, default=20260803)
    parser.add_argument("--requests", type=int, default=240)
    parser.add_argument("--base-rps", type=float, default=12.0)
    parser.add_argument("--quota-rps", type=float, default=4.0)
    parser.add_argument("--workers", type=int, default=12)
    parser.add_argument("--routers", type=int, default=1,
                        help="router instances fronting the fleet")
    parser.add_argument("--scenario", default="default",
                        choices=("default", "process_kill"))
    parser.add_argument("--out", default="")
    parser.add_argument("--no-hardening", action="store_true",
                        help="skip the before/after micro-measures")
    parser.add_argument("--replay", default="",
                        help="TRACE_CAPTURE file to drive instead of a synthetic trace")
    parser.add_argument("--capture-out", default="",
                        help="write this run's served traffic as a TRACE_CAPTURE file")
    args = parser.parse_args(argv)

    replay = None
    if args.replay:
        from gofr_tpu_torch.devtools.trace_capture import load_capture

        replay = load_capture(args.replay)
        print(f"fleetsim: replaying {replay['requests']} captured events "
              f"(digest {replay['digest'][:16]}…)", file=sys.stderr, flush=True)
    t0 = time.monotonic()
    sim = FleetSim(
        n_replicas=args.replicas, n_prefill=args.prefill, seed=args.seed,
        spec=TraceSpec(requests=args.requests, base_rps=args.base_rps, seed=args.seed),
        quota_rps=args.quota_rps, workers=args.workers, n_routers=args.routers,
        scenario=args.scenario, measure_hardening=not args.no_hardening,
        progress=lambda msg: print(msg, file=sys.stderr, flush=True),
        replay=replay, capture_out=args.capture_out,
    )
    artifact = sim.run()
    artifact["wall_s"] = round(time.monotonic() - t0, 1)
    artifact["generated_at"] = time.time()
    blob = json.dumps(artifact, indent=2, sort_keys=True)
    print(blob)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    slo = artifact["slo"]
    print(
        f"fleetsim: {slo['requests']} requests, ok={slo['ok']} "
        f"shed={slo['shed']['total']} errors={slo['errors']} "
        f"p99_ttft={slo['ttft_p99_ms']}ms resume={slo['resume']} "
        f"pools_idle={slo['pools_idle']} wall={artifact['wall_s']}s",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
