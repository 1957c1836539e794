"""Replica bookkeeping + the health prober that decides rotation
membership.

Each engine replica is wrapped in a :class:`Replica`: its resilient
HTTP client (``service.py``), an outstanding-request counter (the
least-outstanding selection signal), a per-replica circuit breaker
(``fleet/breaker.py``), and the prober-maintained rotation state:

- ``healthy`` — in rotation, receives traffic.
- ``probation`` — recovering: the replica answered ready again after
  being out, but must string together ``probation_probes`` consecutive
  OK probes before traffic returns (a flapping replica — wedge,
  recover, wedge — never oscillates back into rotation on one good
  poll).
- ``out`` — readiness failed (connect error, 503 while booting,
  watchdog degraded/wedged); receives no traffic.

The prober (one named daemon thread per :class:`ReplicaSet`, joined on
``close()``) polls ``/.well-known/ready`` every ``probe_interval_s``
and — piggybacked on the same round — scrapes ``GET /admin/engine`` for
the saturation signals the admission layer sheds on: paged-KV free
blocks and batcher queue depth. Probes can optionally HEDGE: when
``hedge_ms`` > 0 a second probe fires if the first hasn't answered in
that window and the first reply wins — the p99 of a health check on a
busy replica stops deciding rotation membership.

Probe SCHEDULING is per-replica and jittered (``probe_jitter``, a
fraction of the interval): each replica draws its own next-due time
from an independent RNG, so a 16-replica fleet never fires 16 probe
threads + 16 engine scrapes in the same instant every interval — the
fleetsim harness measured the synchronized sweep putting every probe
of a round inside one 50 ms burst window at N=16, and the jittered
schedule spreading them across the whole interval (FLEETSIM artifact,
``hardening.probe_spread``).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import queue
import random
import threading
import time
from typing import Any, Optional

from gofr_tpu_torch.fleet.breaker import CircuitBreaker
from gofr_tpu_torch.service import HTTPService

HEALTHY = "healthy"
PROBATION = "probation"
OUT = "out"

# numeric gauge encoding for gofr_tpu_router_replica_state{replica}
STATE_VALUES = {OUT: 0, PROBATION: 1, HEALTHY: 2}


def affinity_order(key: str, names: list[str]) -> list[str]:
    """Rendezvous (highest-random-weight) order of ``names`` for
    ``key``: stable under membership churn — removing one replica only
    remaps the conversations that lived on it, never the whole fleet."""
    def score(name: str) -> int:
        digest = hashlib.md5(f"{key}|{name}".encode("utf-8")).digest()
        return int.from_bytes(digest[:8], "big")

    return sorted(names, key=score, reverse=True)


class Replica:
    def __init__(
        self,
        name: str,
        address: str,
        logger: Any,
        connect_timeout: float = 2.0,
        read_timeout: float = 30.0,
        breaker: Optional[CircuitBreaker] = None,
    ):
        self.name = name
        self.address = address
        self.client = HTTPService(
            address, logger, name=name,
            connect_timeout=connect_timeout, read_timeout=read_timeout,
        )
        self.breaker = breaker or CircuitBreaker()
        self._lock = threading.Lock()
        self._outstanding = 0
        self.state = HEALTHY  # optimistic: the prober corrects within a round
        self.ok_streak = 0
        self.fail_streak = 0
        self.probes = 0
        self.last_probe_error = ""
        self.saturated = False
        self.engine: Optional[dict[str, Any]] = None
        self.last_kv_rejects: Optional[int] = None  # prober-only state
        self.kv_starved = False  # KV-only component of `saturated`
        # restart awareness: the last boot_id the ready probe reported.
        # A CHANGED id means a new process answers at this address (the
        # supervisor respawned it after a crash/SIGKILL) — a first-class
        # `restarting` passage through probation: cold caches, empty
        # pools, and (with JOURNAL_DIR) a WAL rehydration behind it.
        self.boot_id: Optional[str] = None
        self.restarts = 0
        self.restarting = False
        # disaggregated serving: the role the replica ADVERTISES on
        # /admin/engine (FLEET_ROLE). "mixed" — the default, and what a
        # replica that advertises nothing gets — serves every tier, so
        # role routing can never shrink the fleet below today's
        # behavior. Sticky across probe failures (an out-of-rotation
        # replica keeps its last-known role for when it returns).
        self.role = "mixed"

    # -- outstanding-request accounting (selection signal) -------------------
    def mark_dispatch(self) -> int:
        with self._lock:
            self._outstanding += 1
            return self._outstanding

    def mark_done(self) -> int:
        with self._lock:
            self._outstanding = max(0, self._outstanding - 1)
            return self._outstanding

    @property
    def outstanding(self) -> int:
        # deliberately lock-free: reading an int attribute is atomic
        # under the GIL, and this property sits inside the router's
        # selection loop — N replicas × every request. Taking the
        # writer lock here measurably serialized selection against
        # dispatch accounting at fleet scale (the fleetsim's
        # selection microbench is the regression watch).
        return self._outstanding

    def snapshot(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "address": self.address,
            "state": self.state,
            "role": self.role,
            "outstanding": self.outstanding,
            "saturated": self.saturated,
            "probes": self.probes,
            "ok_streak": self.ok_streak,
            "fail_streak": self.fail_streak,
            "last_probe_error": self.last_probe_error or None,
            "boot_id": self.boot_id,
            "restarts": self.restarts,
            "restarting": self.restarting,
            "breaker": self.breaker.snapshot(),
            "engine": self.engine,
        }


class ReplicaSet:
    """The fleet membership + its prober thread."""

    def __init__(
        self,
        replicas: list[Replica],
        logger: Any,
        probe_interval_s: float = 1.0,
        probe_timeout_s: float = 1.0,
        probe_jitter: float = 0.2,
        hedge_ms: float = 0.0,
        out_after: int = 2,
        probation_probes: int = 3,
        saturation_queue: int = 64,
        affinity_max_skew: int = 4,
        on_state_change: Optional[Any] = None,
    ):
        self.replicas = replicas
        self.logger = logger
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        # jitter as a FRACTION of the interval (0 = the old synchronized
        # sweep, clamped below 1 so the schedule can never stall): each
        # replica's next probe lands uniformly in interval*(1±jitter),
        # drawn from a per-replica RNG — de-synchronization is the
        # thundering-herd fix that is load-bearing at N=16
        self.probe_jitter = max(0.0, min(0.9, probe_jitter))
        self.hedge_ms = hedge_ms
        self.out_after = max(1, out_after)
        self.probation_probes = max(1, probation_probes)
        self.saturation_queue = saturation_queue
        self.affinity_max_skew = max(0, affinity_max_skew)
        self._on_state_change = on_state_change
        # fired when a probe detects a REBORN process (boot_id changed);
        # the router counts it on gofr_tpu_router_replica_restarts_total
        self._on_restart: Optional[Any] = None
        self._stop = threading.Event()
        # round-robin tie-break for equal-outstanding picks; a C-level
        # counter, not a locked int (see candidates())
        self._rr = itertools.count(1)
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "ReplicaSet":
        self._thread = threading.Thread(
            target=self._probe_loop, name="gofr-fleet-probe", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- selection ------------------------------------------------------------
    def by_name(self, name: str) -> Optional[Replica]:
        for replica in self.replicas:
            if replica.name == name:
                return replica
        return None

    def candidates(self, affinity_key: str = "",
                   exclude: Optional[set[str]] = None,
                   role: Optional[str] = None) -> list[Replica]:
        """Dispatch order for one attempt round: in-rotation replicas,
        affinity target first (rendezvous on the conversation key —
        that replica holds the paged-KV blocks of the prefix), the rest
        by least-outstanding with a rotating tie-break. Affinity yields
        to load once the preferred replica runs ``affinity_max_skew``
        more outstanding requests than the least-loaded sibling — a
        popular shared prefix must not funnel the whole fleet onto one
        replica. ``exclude`` drops replicas already tried this
        request. ``role`` restricts to that tier (role-advertising
        replicas plus ``mixed`` ones); an empty tier returns [] and the
        CALLER falls back to role-free selection — role config narrows
        preference, never capacity."""
        eligible = [
            r for r in self.replicas
            if r.state == HEALTHY and (exclude is None or r.name not in exclude)
        ]
        if role is not None:
            eligible = [r for r in eligible if r.role in (role, "mixed")]
        if not eligible:
            return []
        # lock-free rotating tie-break: itertools.count.__next__ is a
        # single C call (GIL-atomic), where the old lock+int pair made
        # every selection of every request serialize on one mutex
        rotate = next(self._rr)
        # outstanding is SNAPSHOTTED once per selection: the sort and
        # the affinity-skew check below must agree on one consistent
        # view, and re-reading the live counters per comparison paid
        # n_replicas extra attribute reads per request for a value
        # that may shift mid-sort anyway
        loads = {r.name: r.outstanding for r in eligible}
        order = {r.name: i for i, r in enumerate(eligible)}
        eligible.sort(
            key=lambda r: (loads[r.name],
                           (order[r.name] + rotate) % len(order))
        )
        if affinity_key:
            ranked = affinity_order(affinity_key, [r.name for r in eligible])
            preferred = next(
                r for r in eligible if r.name == ranked[0]
            )
            least_loaded = loads[eligible[0].name]
            if loads[preferred.name] <= least_loaded + self.affinity_max_skew:
                eligible.sort(key=lambda r: 0 if r.name == preferred.name else 1)
        return eligible

    def in_rotation(self) -> list[Replica]:
        return [r for r in self.replicas if r.state == HEALTHY]

    def all_saturated(self) -> bool:
        """True when every in-rotation replica reports KV/queue
        saturation — the admission layer sheds instead of queueing."""
        rotation = self.in_rotation()
        return bool(rotation) and all(r.saturated for r in rotation)

    def snapshot(self) -> dict[str, Any]:
        return {
            "probe_interval_s": self.probe_interval_s,
            "probe_jitter": self.probe_jitter,
            "out_after": self.out_after,
            "probation_probes": self.probation_probes,
            "replicas": [r.snapshot() for r in self.replicas],
        }

    # -- probing --------------------------------------------------------------
    def next_probe_delays(self, rng: random.Random,
                          initial: bool = False) -> float:
        """One replica's delay until its next probe. Jitter draws
        uniformly from ``interval * (1 ± probe_jitter)`` per round —
        each replica's independent RNG decorrelates phases over time,
        so even replicas that START aligned drift apart. The INITIAL
        delay spreads only across the JITTER window ``[0,
        jitter*interval)``: a freshly booted 16-replica router must not
        open with one synchronized probe burst, but it must also still
        learn real rotation state within ≈ one round — replicas boot
        optimistically healthy, and a long stagger would stretch the
        window in which a dead replica keeps taking traffic."""
        spread = self.probe_jitter * self.probe_interval_s
        if self.probe_jitter <= 0.0:
            return 0.0 if initial else self.probe_interval_s
        if initial:
            return rng.random() * spread
        return self.probe_interval_s - spread + rng.random() * 2 * spread

    def _probe_loop(self) -> None:
        """One probe thread PER REPLICA per round: a serial sweep would
        make failure-detection latency O(n_replicas × probe_timeout) —
        two hard-down replicas must not delay taking a third, newly
        wedged one out of rotation. A replica whose previous probe is
        still running (stuck in its connect timeout) is skipped, never
        double-probed; each replica's state machine thus stays
        single-threaded. Scheduling is per-replica with decorrelated
        jitter (:meth:`next_probe_delays`)."""
        pending: dict[str, threading.Thread] = {}
        # per-replica RNGs, seeded off the replica name: deterministic
        # for a given fleet spec (tests can reason about it) while still
        # independent streams across replicas
        rngs = {
            r.name: random.Random(f"gofr-probe-jitter|{r.name}")
            for r in self.replicas
        }
        now = time.monotonic()
        due = {
            r.name: now + self.next_probe_delays(rngs[r.name], initial=True)
            for r in self.replicas
        }
        while not self._stop.is_set():
            now = time.monotonic()
            for replica in self.replicas:
                if now < due[replica.name]:
                    continue
                due[replica.name] = now + self.next_probe_delays(
                    rngs[replica.name]
                )
                previous = pending.get(replica.name)
                if previous is not None and previous.is_alive():
                    continue
                thread = threading.Thread(
                    target=self._probe_guarded, args=(replica,),
                    name=f"gofr-fleet-probe-{replica.name}", daemon=True,
                )
                pending[replica.name] = thread
                thread.start()
            wake = min(due.values()) - time.monotonic() if due else (
                self.probe_interval_s
            )
            self._stop.wait(min(max(wake, 0.001), self.probe_interval_s))
        for thread in pending.values():
            thread.join(timeout=self.probe_timeout_s * 2 + 1.0)

    def _probe_guarded(self, replica: Replica) -> None:
        try:
            self.probe_once(replica)
        except Exception as exc:
            # a prober crash would silently freeze rotation state
            self.logger.errorf(
                "fleet probe of %s failed: %r", replica.name, exc
            )

    def probe_once(self, replica: Replica) -> bool:
        """One probe round for ``replica``: readiness decides rotation,
        the piggybacked engine scrape updates saturation. Returns the
        readiness verdict (also applied to the state machine)."""
        ok, detail, recovering, boot_id = self._ready_probe(replica)
        replica.probes += 1
        replica.last_probe_error = "" if ok else detail
        self._apply_probe(replica, ok, recovering=recovering,
                          boot_id=boot_id)
        if ok:
            self._scrape_engine(replica)
        else:
            replica.saturated = False
            replica.engine = None
        return ok

    def _ready_probe(
        self, replica: Replica
    ) -> tuple[bool, str, bool, Optional[str]]:
        if self.hedge_ms and self.hedge_ms > 0:
            return self._hedged_ready(replica)
        return self._ready_once(replica)

    @staticmethod
    def _recovering_verdict(body: bytes) -> bool:
        """Does a 503 ready body say the engine is COMING BACK (an
        active wedge-recovery incident) rather than hard-down? Keys on
        the engine state and the recovery evidence block handler.py
        attaches; terminal verdicts (exhausted/hung) are NOT coming
        back."""
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return False
        if not isinstance(payload, dict):
            return False
        if payload.get("state") == "recovering":
            return True
        recovery = payload.get("recovery")
        return isinstance(recovery, dict) and recovery.get("state") in (
            "recovering", "waiting_backoff"
        )

    @staticmethod
    def _ready_boot_id(body: bytes) -> Optional[str]:
        """The ready 200 body's process identity (None on replicas that
        predate it — restart detection then simply stays off)."""
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        if not isinstance(payload, dict):
            return None
        boot_id = payload.get("boot_id")
        return boot_id if isinstance(boot_id, str) and boot_id else None

    def _ready_once(
        self, replica: Replica
    ) -> tuple[bool, str, bool, Optional[str]]:
        try:
            resp = replica.client.request(
                "GET", "/.well-known/ready",
                connect_timeout=self.probe_timeout_s,
                read_timeout=self.probe_timeout_s,
                retries=0,
            )
        except Exception as exc:
            return False, str(exc), False, None
        if resp.status_code == 200:
            return True, "", False, self._ready_boot_id(resp.body)
        detail = resp.body.decode("utf-8", "replace")[:200]
        return (
            False, f"ready {resp.status_code}: {detail}",
            self._recovering_verdict(resp.body), None,
        )

    def _hedged_ready(
        self, replica: Replica
    ) -> tuple[bool, str, bool, Optional[str]]:
        """Hedged readiness read: fire a second probe if the first is
        slower than ``hedge_ms``; first answer wins. The loser's reply
        is discarded (its connection closes with its thread)."""
        results: "queue.Queue[tuple[bool, str, bool, Optional[str]]]" = (
            queue.Queue()
        )

        def attempt() -> None:
            results.put(self._ready_once(replica))

        first = threading.Thread(
            target=attempt, name="gofr-fleet-hedge", daemon=True
        )
        first.start()
        try:
            return results.get(timeout=self.hedge_ms / 1000.0)
        except queue.Empty:
            pass
        second = threading.Thread(
            target=attempt, name="gofr-fleet-hedge", daemon=True
        )
        second.start()
        try:
            return results.get(timeout=self.probe_timeout_s * 2 + 1.0)
        except queue.Empty:
            return False, "hedged probe timed out", False, None

    def _scrape_engine(self, replica: Replica) -> None:
        """Saturation signals off ``GET /admin/engine``: paged-KV free
        blocks and batcher queue depth. A router fronting replicas
        without an engine (or with admin auth) keeps saturated=False —
        shedding then falls back to the router's own in-flight cap."""
        try:
            resp = replica.client.request(
                "GET", "/admin/engine",
                connect_timeout=self.probe_timeout_s,
                read_timeout=self.probe_timeout_s,
                retries=0,
            )
            if resp.status_code != 200:
                replica.saturated = False
                return
            data = json.loads(resp.body.decode("utf-8"))
        except Exception:
            replica.saturated = False
            return
        if isinstance(data, dict) and isinstance(data.get("data"), dict):
            data = data["data"]  # the framework envelope
        engine: dict[str, Any] = {
            "state": (data.get("engine") or {}).get("state"),
            "queue_depth": data.get("queue_depth"),
        }
        # disaggregated serving: adopt the advertised role (FLEET_ROLE)
        # and carry the KV-transfer ledger onto /admin/fleet
        role = data.get("role")
        if role in ("prefill", "decode", "mixed"):
            replica.role = role
        engine["role"] = replica.role
        engine["kv_transfer"] = (
            data.get("kv_transfer")
            if isinstance(data.get("kv_transfer"), dict) else None
        )
        # overload-brownout level (0 normal): piggybacked for the
        # /admin/fleet/overview rollup — a fleet-wide brownout is an
        # incident headline, not something to scrape N replicas for
        brownout = data.get("brownout")
        engine["brownout_level"] = (
            brownout.get("level") if isinstance(brownout, dict) else None
        )
        # cost-model watchtower: anomaly totals + worst residual EMA
        # piggybacked off engine_snapshot()'s `costmodel` block, so
        # /admin/fleet/overview can name the replica blowing its
        # predictions without a second fan-out scrape
        cm = data.get("costmodel")
        engine["anomalies"] = (
            cm.get("anomalies_total") if isinstance(cm, dict) else None
        )
        engine["worst_residual_ema"] = (
            cm.get("worst_residual_ema") if isinstance(cm, dict) else None
        )
        # SLO + tenant headlines ride the same scrape: the fleet
        # overview aggregates burn/budget/top-talkers router-side with
        # zero extra endpoints (same piggyback discipline as costmodel)
        engine["slo"] = (
            data.get("slo") if isinstance(data.get("slo"), dict) else None
        )
        engine["tenants"] = (
            data.get("tenants")
            if isinstance(data.get("tenants"), dict) else None
        )
        kv = data.get("kv_blocks") or {}
        engine["kv_free"] = kv.get("free")
        engine["kv_cached"] = kv.get("cached")
        engine["kv_total"] = kv.get("total")
        engine["kv_exhausted_rejects"] = kv.get("kv_exhausted_rejects")
        replica.engine = engine
        # KV starvation keys on the replica's OWN verdicts: a rising
        # kv_exhausted_rejects counter means admissions are being
        # rejected RIGHT NOW (the pool's authoritative signal — free/
        # cached counts can't tell pinned-shared cache blocks from
        # evictable ones). Starvation then sustains while blocks stay
        # visibly scarce (free == 0 with live decodes) and clears when
        # free blocks appear or every decode has finished (an idle
        # cache is wholly evictable).
        rejects = int(kv.get("kv_exhausted_rejects") or 0)
        delta = (rejects - replica.last_kv_rejects
                 if replica.last_kv_rejects is not None else 0)
        replica.last_kv_rejects = rejects
        free = int(kv.get("free") or 0)
        active = int(kv.get("active") or 0)
        if delta > 0:
            replica.kv_starved = True
        elif free > 0 or active == 0:
            replica.kv_starved = False
        # else: sticky on the KV-ONLY flag while blocks stay scarce —
        # never on the composite `saturated`, or a one-time queue spike
        # would latch as KV starvation for as long as the warm cache
        # keeps the free list empty (its routine steady state)
        depth = engine["queue_depth"] or 0
        queue_full = self.saturation_queue > 0 and depth >= self.saturation_queue
        replica.saturated = replica.kv_starved or queue_full

    def _apply_probe(self, replica: Replica, ok: bool,
                     recovering: bool = False,
                     boot_id: Optional[str] = None) -> None:
        """The probation state machine. Runs on the prober thread only
        (plus tests), so plain attribute writes are safe.

        ``recovering``: the failed probe's 503 body carried an ACTIVE
        wedge-recovery incident — the replica is coming back, not
        hard-down. It parks in PROBATION (no traffic, but the router's
        stream-resume path may target it, and re-entry needs only the
        usual ok-probe streak) instead of dropping to OUT.

        ``boot_id``: the ready 200 body's process identity. A CHANGED
        id means a supervisor respawned the process (connection-refused
        then reborn): a first-class ``restarting`` passage — even a
        replica that never visibly failed a probe (killed and restarted
        inside one probe interval) re-enters through the probation
        window, because the NEW process has cold caches, empty pools,
        and possibly a WAL rehydration behind its ready verdict. The
        restart is counted (``on_restart`` hook → the router's
        gofr_tpu_router_replica_restarts_total) and ``restarting``
        stays visible on /admin/fleet until the replica walks back to
        HEALTHY."""
        was = replica.state
        if ok:
            reborn = (
                boot_id is not None
                and replica.boot_id is not None
                and boot_id != replica.boot_id
            )
            if boot_id is not None:
                replica.boot_id = boot_id
            if reborn:
                replica.restarts += 1
                replica.restarting = True
                replica.state = PROBATION
                replica.ok_streak = 0
                self._note_restart(replica)
            replica.ok_streak += 1
            replica.fail_streak = 0
            if replica.state == OUT:
                replica.state = PROBATION
                replica.ok_streak = 1
            if (replica.state == PROBATION
                    and replica.ok_streak >= self.probation_probes):
                replica.state = HEALTHY
            if replica.state == HEALTHY:
                replica.restarting = False
        else:
            replica.fail_streak += 1
            replica.ok_streak = 0
            if recovering:
                if replica.state == OUT or (
                    replica.state == HEALTHY
                    and replica.fail_streak >= self.out_after
                ):
                    replica.state = PROBATION
                # PROBATION holds: a replica mid-recovery never demotes
                # to hard-out on the strength of its own progress report
            elif replica.state == PROBATION or (
                replica.fail_streak >= self.out_after
            ):
                replica.state = OUT
        if was != replica.state and self._on_state_change is not None:
            try:
                self._on_state_change(replica, was, replica.state)
            except Exception:  # gofrlint: disable=GFL006 — hook must not kill the prober
                pass

    def _note_restart(self, replica: Replica) -> None:
        if self._on_restart is None:
            return
        try:
            self._on_restart(replica)
        except Exception:  # gofrlint: disable=GFL006 — hook must not kill the prober
            pass
