"""The port's fleet-scale chaos simulation
(``gofr_tpu_torch/devtools/fleetsim.py``), case for case with
``tests/test_fleetsim.py``, then beside the JAX package's: the same seeds
give the same trace and scenario digests, the port's smoke artifact holds
the gate's absolute invariants (``tools/fleetsim_gate.py``, loaded as a
tool), and the module entry captures a run and replays it."""

import importlib.util
import json
import pathlib
import random

import pytest

from gofr_tpu_torch.devtools import fleetsim
from gofr_tpu_torch.devtools.fleetsim import (
    FleetSim,
    SimRedis,
    TraceSpec,
    build_scenario,
    build_trace,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "fleetsim_gate", REPO / "tools" / "fleetsim_gate.py"
)
fleetsim_gate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fleetsim_gate)


# -- replayability: the seed IS the run ----------------------------------------

def test_trace_same_seed_is_byte_identical():
    """The replay contract: the trace is a pure function of its spec.
    Byte-identity is asserted on the canonical JSON itself, not just
    the digest — the digest is merely the witness the artifact
    records."""
    a_events, a_digest = build_trace(TraceSpec(requests=120, seed=42))
    b_events, b_digest = build_trace(TraceSpec(requests=120, seed=42))
    assert a_digest == b_digest
    assert (json.dumps(a_events, sort_keys=True)
            == json.dumps(b_events, sort_keys=True))
    c_events, c_digest = build_trace(TraceSpec(requests=120, seed=43))
    assert c_digest != a_digest


def test_scenario_same_seed_is_byte_identical():
    a_events, a_digest = build_scenario(7, n_replicas=16, n_prefill=2,
                                        duration_s=20.0)
    b_events, b_digest = build_scenario(7, n_replicas=16, n_prefill=2,
                                        duration_s=20.0)
    assert a_digest == b_digest
    assert (json.dumps(a_events, sort_keys=True)
            == json.dumps(b_events, sort_keys=True))
    _, c_digest = build_scenario(8, n_replicas=16, n_prefill=2,
                                 duration_s=20.0)
    assert c_digest != a_digest


def test_trace_structure_and_protected_cohort():
    """Structural invariants the SLOs depend on: timestamps
    non-decreasing, phases in spec order, priority tiers drawn from the
    mix, and the priority-9 cohort riding its OWN low-volume tenant —
    'tier 9 is never shed' must be a property of the system, not of a
    lucky tenant draw."""
    spec = TraceSpec(requests=200, seed=3)
    events, _ = build_trace(spec)
    assert len(events) >= spec.requests
    tiers = {tier for tier, _ in spec.priority_mix}
    phase_order = [name for name, _, _ in spec.phases]
    last_at, last_phase_idx = 0.0, 0
    for ev in events:
        assert ev["at_s"] >= last_at
        last_at = ev["at_s"]
        idx = phase_order.index(ev["phase"])
        assert idx >= last_phase_idx  # phases never rewind
        last_phase_idx = idx
        assert ev["priority"] in tiers
        assert ev["kind"] in ("unary", "stream", "abort_stream")
        assert (ev["abort_after"] is not None) == (
            ev["kind"] == "abort_stream")
        if ev["priority"] == 9:
            assert ev["tenant"] == "t-platinum"
        else:
            assert ev["tenant"].startswith("t") and ev["tenant"] != (
                "t-platinum")
    p9 = [ev for ev in events if ev["priority"] == 9]
    assert 0 < len(p9) < len(events) / 4  # present AND low-volume


def test_scenario_events_are_paired_and_ordered():
    """Every injected fault carries its own cure in the schedule: a
    wedge has a recover, a drain a restart, an armed stream-mangler a
    clear, the redis outage an end — the digest captures the WHOLE
    incident timeline, so convergence is part of the replayed run."""
    events, _ = build_scenario(11, n_replicas=16, n_prefill=2,
                               duration_s=20.0)
    assert events == sorted(events, key=lambda e: e["at_s"])
    ops = [e["op"] for e in events]
    assert "redis_down" in ops and "redis_up" in ops

    def targets(op):
        return sorted(e["replica"] for e in events if e["op"] == op)

    assert targets("wedge") == targets("recover")
    assert targets("drain") == targets("restart")
    cleared = {(e["replica"], e["mode"]) for e in events if e["op"] == "clear"}
    for e in events:
        if e["op"] == "slow_loris":
            assert (e["replica"], "slow_loris") in cleared
        if e["op"] == "disconnect":
            assert (e["replica"], "disconnect_after") in cleared
    # faults target the decode tier; the prefill tier only ever gets
    # the KV corruption (its serving plane must stay healthy so the
    # local-prefill fallback has somewhere to run)
    for e in events:
        if e["op"] == "kv_corrupt":
            assert e["replica"] < 2
        elif "replica" in e:
            assert e["replica"] >= 2


# -- probe jitter: the thundering-herd fix -------------------------------------

def _fire_times(jitter, n=16, rounds=40, interval=1.0):
    """Simulate the prober's schedule without threads: accumulate each
    replica's per-round delays exactly as ``_probe_loop`` draws them
    (same per-replica RNG seeding), returning all fire times sorted."""
    from gofr_tpu_torch.fleet.replica import Replica, ReplicaSet

    logger = fleetsim._NullLogger()
    replicas = [
        Replica(f"m{i}", "http://127.0.0.1:9", logger) for i in range(n)
    ]
    rset = ReplicaSet(replicas, logger, probe_interval_s=interval,
                      probe_jitter=jitter)
    times = []
    for r in replicas:
        rng = random.Random(f"gofr-probe-jitter|{r.name}")
        t = rset.next_probe_delays(rng, initial=True)
        for _ in range(rounds):
            times.append(t)
            t += rset.next_probe_delays(rng)
    return sorted(times)


def _max_burst(times, window):
    best = 0
    for i, t0 in enumerate(times):
        n = 0
        for t in times[i:]:
            if t - t0 > window:
                break
            n += 1
        best = max(best, n)
    return best


def test_probe_jitter_desynchronizes_schedule():
    """The satellite's unit: with jitter off, every round of a
    16-replica fleet fires as ONE instantaneous burst, forever; with
    decorrelated jitter the phases drift apart and stay apart. Fully
    deterministic — the per-replica RNGs are seeded off replica names,
    exactly as the live prober seeds them."""
    sync = [t for t in _fire_times(jitter=0.0) if t > 20.0]
    jit = [t for t in _fire_times(jitter=0.3) if t > 20.0]
    assert _max_burst(sync, 0.05) == 16  # the whole round, one instant
    assert _max_burst(jit, 0.05) <= 8  # uniform expectation is ~0.8


def test_next_probe_delays_bounds():
    from gofr_tpu_torch.fleet.replica import Replica, ReplicaSet

    logger = fleetsim._NullLogger()
    replicas = [Replica("m0", "http://127.0.0.1:9", logger)]
    rset = ReplicaSet(replicas, logger, probe_interval_s=2.0,
                      probe_jitter=0.25)
    rng = random.Random(1)
    for _ in range(200):
        initial = rset.next_probe_delays(rng, initial=True)
        assert 0.0 <= initial < 0.5  # spread over the jitter window only
        steady = rset.next_probe_delays(rng)
        assert 1.5 <= steady <= 2.5  # interval * (1 +/- jitter)
    # jitter 0 restores the synchronized sweep exactly
    plain = ReplicaSet(replicas, logger, probe_interval_s=2.0,
                       probe_jitter=0.0)
    assert plain.next_probe_delays(rng, initial=True) == 0.0
    assert plain.next_probe_delays(rng) == 2.0
    # the constructor clamps runaway jitter below 1 so the schedule
    # can never stall (delay can never reach 0 at steady state)
    wild = ReplicaSet(replicas, logger, probe_interval_s=2.0,
                      probe_jitter=5.0)
    assert wild.probe_jitter == 0.9


def test_quota_lease_cache_ab_measure():
    """The hardening A/B the artifact records: TTL 0 is exactly one
    sync per request; the lease cache cuts it by an order of
    magnitude on a hot tenant."""
    before = fleetsim.measure_quota_trips(cache_ttl_s=0.0)
    after = fleetsim.measure_quota_trips(cache_ttl_s=0.05)
    assert before["syncs_per_request"] == 1.0
    assert before["cache_hits"] == 0
    assert after["syncs_per_request"] < 0.5
    assert after["cache_hits"] > 0


# -- the SLO gate --------------------------------------------------------------

def _artifact(**overrides):
    art = {
        "kind": "FLEETSIM",
        "schema": 1,
        "seed": 1,
        "replicas": 16,
        "scenario": {
            "injected": {"error_burst": 5, "slow_loris": 3,
                         "disconnect_after": 2},
        },
        "slo": {
            "requests": 240, "ok": 200, "client_aborted": 10, "errors": 2,
            "ttft_p50_ms": 30.0, "ttft_p99_ms": 120.0,
            "shed": {"total": 28, "rate": 0.1167,
                     "by_priority": {"0": 20, "3": 8}, "p9": 0},
            "streams": {"verified": 90, "token_exact": 90,
                        "duplicated_tokens": 0, "missing_tokens": 0},
            "resume": {"resumed": 3, "exhausted": 0, "refused": 0,
                       "failures": 0},
            "tenants": [
                {"tenant": "t-platinum", "requests": 24, "ok": 24,
                 "sheds": 0, "errors": 0, "client_aborted": 0,
                 "availability": 1.0, "target": 0.9995,
                 "budget_remaining": 1.0},
                {"tenant": "t00", "requests": 70, "ok": 60, "sheds": 9,
                 "errors": 1, "client_aborted": 0,
                 "availability": 0.9833, "target": 0.999,
                 "budget_remaining": -15.7},
            ],
            "breaker_flaps": 6,
            "pools_idle": True,
            "converged": {"rotation": True, "pools_idle": True},
        },
        "hardening": {
            "probe_spread": {"before": {"max_probes_in_window": 16},
                             "after": {"max_probes_in_window": 4}},
            "quota": {"before": {"syncs_per_request": 1.0},
                      "after": {"syncs_per_request": 0.02}},
        },
    }
    for path, value in overrides.items():
        cursor, keys = art, path.split(".")
        for key in keys[:-1]:
            cursor = cursor[key]
        cursor[keys[-1]] = value
    return art


def test_gate_passes_a_healthy_artifact():
    assert fleetsim_gate.gate(_artifact(), _artifact()) == []


def test_gate_absolute_invariants():
    baseline = _artifact()
    cases = [
        ({"slo.streams.missing_tokens": 3}, "lost/duplicated"),
        ({"slo.streams.duplicated_tokens": 1}, "lost/duplicated"),
        ({"slo.streams.token_exact": 88}, "token-exact"),
        ({"slo.resume.failures": 1, "slo.resume.refused": 1},
         "resume success must be 100%"),
        ({"slo.shed.p9": 2}, "never shed"),
        ({"slo.pools_idle": False}, "idle"),
        ({"hardening.probe_spread.after": {"max_probes_in_window": 16}},
         "probe jitter"),
        ({"hardening.quota.after": {"syncs_per_request": 1.0}},
         "lease cache"),
        # anti-vacuity: invariants only count when their chaos fired
        ({"scenario.injected": {"error_burst": 5, "slow_loris": 3}},
         "'disconnect_after' never fired"),
        ({"scenario.injected": {"error_burst": 5, "disconnect_after": 2}},
         "'slow_loris' never fired"),
        ({"slo.resume.resumed": 0}, "vacuously true"),
        # the protected tenant: its SLO lines must exist and hold
        ({"slo.tenants": []}, "no per-tenant SLO lines"),
        ({"slo.tenants": [{"tenant": "t00", "budget_remaining": 1.0}]},
         "t-platinum"),
        ({"slo.tenants": [{"tenant": "t-platinum", "availability": 0.5,
                           "target": 0.9995, "budget_remaining": -999.0}]},
         "exhausted its availability budget"),
    ]
    for overrides, needle in cases:
        failures = fleetsim_gate.gate(_artifact(**overrides), baseline)
        assert failures, overrides
        assert any(needle in f for f in failures), (overrides, failures)


def test_gate_relative_tolerances():
    baseline = _artifact()
    # inside tolerance: loose-first factors absorb CI noise
    assert fleetsim_gate.gate(
        _artifact(**{"slo.ttft_p99_ms": 400.0, "slo.errors": 6,
                     "slo.breaker_flaps": 14}),
        baseline,
    ) == []
    cases = [
        # above BOTH the factor allowance and the 15s absolute floor
        ({"slo.ttft_p99_ms": 16000.0}, "p99 TTFT"),
        ({"slo.errors": 8}, "error count"),
        ({"slo.shed.rate": 0.4}, "shed rate"),
        ({"slo.breaker_flaps": 30}, "breaker flap"),
        ({"replicas": 8}, "fleet shrank"),
    ]
    # the shed-rate floor keeps the check alive against a ZERO-shed
    # baseline (0 * factor would disable it entirely)
    zero_base = _artifact(**{"slo.shed.rate": 0.0, "slo.shed.total": 0})
    assert fleetsim_gate.gate(
        _artifact(**{"slo.shed.rate": 0.08}), zero_base) == []
    floor_failures = fleetsim_gate.gate(
        _artifact(**{"slo.shed.rate": 0.4}), zero_base)
    assert floor_failures and any(
        "shed rate" in f for f in floor_failures)
    for overrides, needle in cases:
        failures = fleetsim_gate.gate(_artifact(**overrides), baseline)
        assert failures and any(needle in f for f in failures), (
            overrides, failures)


def test_gate_rejects_foreign_artifacts():
    failures = fleetsim_gate.gate({"kind": "BENCH"}, _artifact())
    assert failures and "not a FLEETSIM artifact" in failures[0]


def test_sim_redis_speaks_the_quota_pipeline():
    """The in-sim redis honors the exact pipelined chains
    ``QuotaTable._take_redis`` issues, counts round trips, and raises
    while down (the redis-outage scenario's switch)."""
    redis = SimRedis()
    tokens, ts = redis.pipeline().hget("k", "tokens").hget("k", "ts").execute()
    assert tokens is None and ts is None
    redis.pipeline().hset("k", "tokens", "3.5").hset(
        "k", "ts", "99.0").expire("k", 60).execute()
    assert redis.pipeline().hget("k", "tokens").execute() == ["3.5"]
    assert redis.execs == 3
    redis.down = True
    with pytest.raises(ConnectionError):
        redis.pipeline().hget("k", "tokens").execute()
    assert redis.execs == 3  # a down backend serves nothing


# -- end-to-end smoke ----------------------------------------------------------

def test_fleetsim_smoke_small_fleet(tmp_path, monkeypatch):
    """One real run at tier-1 scale: 5 echo replicas (1 prefill)
    behind the real router, the full seeded trace + fault schedule,
    and the gate's ABSOLUTE invariants asserted on the artifact. The
    N=16 topology runs in the CI ``fleet-sim`` job — this smoke keeps
    the harness itself honest inside plain pytest."""
    monkeypatch.chdir(tmp_path)
    spec = TraceSpec(requests=50, base_rps=25.0, seed=11)
    sim = FleetSim(
        n_replicas=5, n_prefill=1, seed=11, spec=spec,
        quota_rps=30.0, quota_burst=60.0, workers=8,
        measure_hardening=False,
    )
    artifact = sim.run()
    # the artifact's digests ARE the replay contract
    _, trace_digest = build_trace(TraceSpec(requests=50, base_rps=25.0,
                                            seed=11))
    assert artifact["trace"]["digest"] == trace_digest
    assert artifact["seed"] == 11
    slo = artifact["slo"]
    assert slo["requests"] == len(build_trace(spec)[0])
    assert slo["ok"] > 0 and slo["ttft_p99_ms"] is not None
    # the gate's absolute chaos-correctness invariants, at tier-1 scale
    assert slo["shed"]["p9"] == 0
    assert slo["streams"]["duplicated_tokens"] == 0
    assert slo["streams"]["missing_tokens"] == 0
    assert slo["streams"]["token_exact"] == slo["streams"]["verified"]
    assert slo["resume"]["failures"] == 0, slo["resume"]
    assert slo["pools_idle"], artifact["scenario"]["applied"]
    assert slo["converged"]["rotation"]
    assert slo["errors"] <= 3, slo["error_detail"]
    # chaos actually fired: the schedule was applied, not skipped
    assert all(e["applied"] for e in artifact["scenario"]["applied"])
    assert artifact["scenario"]["injected"]


# -- process death (router HA + supervised subprocess victim) ------------------

def test_process_kill_scenario_is_deterministic_and_layered():
    """process_kill layers SIGKILL + router-death events ON TOP of the
    default schedule (so the existing chaos anti-vacuity checks stay
    armed), deterministically: same seed ⇒ identical digest, and the
    router events appear only when a second router exists to fail over
    to."""
    base_events, base_digest = build_scenario(
        7, n_replicas=16, n_prefill=2, duration_s=20.0)
    a_events, a_digest = build_scenario(
        7, n_replicas=16, n_prefill=2, duration_s=20.0,
        process_kill=True, n_routers=2)
    b_events, b_digest = build_scenario(
        7, n_replicas=16, n_prefill=2, duration_s=20.0,
        process_kill=True, n_routers=2)
    assert a_digest == b_digest
    assert (json.dumps(a_events, sort_keys=True)
            == json.dumps(b_events, sort_keys=True))
    assert a_digest != base_digest
    ops = [e["op"] for e in a_events]
    assert ops.count("process_kill") == 2
    assert ops.count("router_kill") == 1 and ops.count("router_restart") == 1
    kill_at = next(e["at_s"] for e in a_events if e["op"] == "router_kill")
    restart_at = next(
        e["at_s"] for e in a_events if e["op"] == "router_restart")
    assert restart_at > kill_at  # the dead router comes back for converge
    # every default-schedule fault survives the layering
    base_ops = [e["op"] for e in base_events]
    for op in set(base_ops):
        assert ops.count(op) >= base_ops.count(op)
    # a single-router fleet schedules no router death (nothing to fail
    # over to — the kill would just truncate the whole trace)
    solo_events, _ = build_scenario(
        7, n_replicas=16, n_prefill=2, duration_s=20.0,
        process_kill=True, n_routers=1)
    solo_ops = [e["op"] for e in solo_events]
    assert "router_kill" not in solo_ops
    assert solo_ops.count("process_kill") == 2


def test_gate_process_kill_invariants():
    healthy_block = {
        "victim": "r16", "replica_kills": 2, "router_kills": 1,
        "supervisor_restarts": 2, "victim_rehydrated": 1,
    }
    healthy = _artifact(**{
        "scenario_mode": "process_kill",
        "routers": 2,
        "process_kill": healthy_block,
        "slo.router_failovers": 5,
    })
    baseline = _artifact()
    assert fleetsim_gate.gate(healthy, baseline) == []
    cases = [
        ({"process_kill": None}, "no process_kill evidence"),
        ({"process_kill": dict(healthy_block, replica_kills=0)},
         "no replica SIGKILL landed"),
        ({"process_kill": dict(healthy_block, supervisor_restarts=0)},
         "never respawned"),
        ({"process_kill": dict(healthy_block, victim_rehydrated=None)},
         "rehydration cannot be verified"),
        ({"process_kill": dict(healthy_block, router_kills=0)},
         "router kill never applied"),
        ({"slo.router_failovers": 0}, "no-single-point-of-failure"),
    ]
    for overrides, needle in cases:
        broken = _artifact(**{
            "scenario_mode": "process_kill", "routers": 2,
            "process_kill": dict(healthy_block),
            "slo.router_failovers": 5,
        })
        for path, value in overrides.items():
            cursor, keys = broken, path.split(".")
            for key in keys[:-1]:
                cursor = cursor[key]
            cursor[keys[-1]] = value
        failures = fleetsim_gate.gate(broken, baseline)
        assert failures and any(needle in f for f in failures), (
            overrides, failures)
    # a default-scenario artifact is never held to process-kill checks
    assert fleetsim_gate.gate(_artifact(), baseline) == []


def test_fleetsim_smoke_process_kill_two_routers(tmp_path, monkeypatch):
    """The router-HA acceptance at tier-1 scale: 5 in-process replicas
    + 1 SUPERVISED SUBPROCESS replica behind TWO router instances; the
    schedule SIGKILLs the subprocess victim twice and hard-kills router
    0 mid-trace — and the absolute SLOs hold: zero token loss, 100%
    resume success, pools idle, clients failed over between routers,
    the supervisor respawned the victim. The CI ``fleet-sim`` job runs
    the same scenario at N=16."""
    monkeypatch.chdir(tmp_path)
    spec = TraceSpec(requests=60, base_rps=12.0, seed=13)
    sim = FleetSim(
        n_replicas=5, n_prefill=1, seed=13, spec=spec,
        quota_rps=30.0, quota_burst=60.0, workers=8,
        n_routers=2, scenario="process_kill",
        measure_hardening=False,
    )
    artifact = sim.run()
    assert artifact["routers"] == 2
    assert artifact["scenario_mode"] == "process_kill"
    slo = artifact["slo"]
    block = artifact["process_kill"]
    assert block["replica_kills"] >= 1
    assert block["supervisor_restarts"] >= 1
    assert block["victim_rehydrated"] is not None
    assert block["router_kills"] == 1
    assert slo["router_failovers"] >= 1  # clients rode the sibling router
    # the existing correctness SLOs hold THROUGH process death
    assert slo["streams"]["duplicated_tokens"] == 0
    assert slo["streams"]["missing_tokens"] == 0
    assert slo["streams"]["token_exact"] == slo["streams"]["verified"]
    assert slo["resume"]["failures"] == 0, slo["resume"]
    assert slo["shed"]["p9"] == 0
    assert slo["pools_idle"], artifact["scenario"]["applied"]
    assert slo["errors"] <= 3, slo["error_detail"]


# -- capture -> replay round trip ---------------------------------------------

def test_fleetsim_capture_then_replay_round_trip(tmp_path, monkeypatch):
    """Production traffic becomes a regression suite: a small live run
    scrapes its OWN route + flight records into a TRACE_CAPTURE
    artifact (seeded anonymization), and a second run driven by
    ``replay=`` replays those exact events — trace digest equal to the
    capture's, ``replay_of`` stamped, and the replay itself digest-
    stable (the determinism the CI fleet-sim smoke leans on)."""
    from gofr_tpu_torch.devtools.trace_capture import load_capture

    monkeypatch.chdir(tmp_path)
    cap_path = tmp_path / "capture.json"
    spec = TraceSpec(requests=30, base_rps=25.0, seed=21)
    sim = FleetSim(
        n_replicas=3, n_prefill=1, seed=21, spec=spec,
        quota_rps=30.0, quota_burst=60.0, workers=6,
        measure_hardening=False, capture_out=str(cap_path),
    )
    artifact = sim.run()
    block = artifact["capture"]
    assert block["path"] == str(cap_path)
    assert block["requests"] > 0
    capture = load_capture(str(cap_path))  # digest verified on load
    assert capture["digest"] == block["digest"]
    # raw tenant names never leak into the capture (t0/t1... are the
    # sim's real tenant ids; captured events carry seeded hashes)
    blob = json.dumps(capture["events"])
    assert '"t0"' not in blob and '"t1"' not in blob

    replay_sim = FleetSim(
        n_replicas=3, n_prefill=1, seed=21,
        quota_rps=30.0, quota_burst=60.0, workers=6,
        measure_hardening=False, replay=capture,
    )
    replayed = replay_sim.run()
    assert replayed["trace"]["digest"] == capture["digest"]
    assert replayed["trace"]["replay_of"] == capture["digest"]
    assert replayed["slo"]["requests"] == len(capture["events"])
    assert replayed["slo"]["ok"] > 0


# -- the two packages side by side --------------------------------------------

from gofr_tpu.devtools import fleetsim as jax_fleetsim  # noqa: E402


@pytest.mark.parametrize("seed,requests,base_rps", [
    (0, 50, 12.0), (11, 50, 25.0), (20260803, 240, 12.0), (42, 120, 30.0),
])
def test_trace_digest_equals_jax(seed, requests, base_rps):
    ours = build_trace(TraceSpec(requests=requests, base_rps=base_rps, seed=seed))
    theirs = jax_fleetsim.build_trace(
        jax_fleetsim.TraceSpec(requests=requests, base_rps=base_rps, seed=seed))
    assert ours[1] == theirs[1]
    assert json.dumps(ours[0], sort_keys=True) == json.dumps(theirs[0], sort_keys=True)


@pytest.mark.parametrize("seed,n_replicas,n_prefill,duration_s,process_kill,n_routers", [
    (7, 16, 2, 20.0, False, 1), (11, 5, 1, 3.0, False, 1),
    (7, 16, 2, 20.0, True, 2), (13, 5, 1, 6.0, True, 2), (20260803, 16, 2, 18.25, False, 1),
])
def test_scenario_digest_equals_jax(seed, n_replicas, n_prefill, duration_s, process_kill,
                                    n_routers):
    ours = build_scenario(seed, n_replicas, n_prefill, duration_s,
                          process_kill=process_kill, n_routers=n_routers)
    theirs = jax_fleetsim.build_scenario(seed, n_replicas, n_prefill, duration_s,
                                         process_kill=process_kill, n_routers=n_routers)
    assert ours == theirs


def test_sim_redis_equals_jax():
    """The quota pipeline's fake redis answers and counts as the JAX
    package's, outage included."""
    runs = []
    for cls in (SimRedis, jax_fleetsim.SimRedis):
        r = cls()
        out = []
        for i in range(3):
            out.append(r.pipeline().hget("k", "tokens").hget("k", "ts").execute())
            out.append(r.pipeline().hset("k", "tokens", str(i)).hset("k", "ts", "1.5")
                       .expire("k", 30).execute())
        r.down = True
        try:
            r.pipeline().hget("k", "tokens").execute()
        except Exception as exc:
            out.append(type(exc).__name__)
        out.append((r.execs, r.hashes))
        runs.append(out)
    assert runs[0] == runs[1]


def test_smoke_artifact_passes_the_gates_absolute_invariants(tmp_path, monkeypatch):
    """The port's small fleet, gated by the JAX package's tool: no
    absolute, tenant-budget or process-kill failure (the relative checks
    and the anti-vacuity ones need the N=16 topology of the module
    entry)."""
    monkeypatch.chdir(tmp_path)
    spec = TraceSpec(requests=50, base_rps=25.0, seed=11)
    artifact = FleetSim(
        n_replicas=5, n_prefill=1, seed=11, spec=spec,
        quota_rps=30.0, quota_burst=60.0, workers=8, measure_hardening=False,
    ).run()
    slo = artifact["slo"]
    assert fleetsim_gate._absolute_failures(slo, {}) == []
    assert fleetsim_gate._tenant_budget_failures(slo) == []
    assert fleetsim_gate._process_kill_failures(artifact, slo) == []
    assert artifact["trace"]["digest"] == jax_fleetsim.build_trace(spec)[1]


def test_module_entry_captures_then_replays(tmp_path):
    """``python -m gofr_tpu_torch.devtools.fleetsim``: a small run writes
    its artifact and a TRACE_CAPTURE of its traffic, and ``--replay`` of
    that capture drives a second run whose trace digest is the
    capture's."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(REPO))
    common = ["--replicas", "3", "--prefill", "1", "--seed", "21", "--workers", "6",
              "--quota-rps", "30", "--base-rps", "25", "--no-hardening"]

    def run(*args):
        proc = subprocess.run([sys.executable, "-m", "gofr_tpu_torch.devtools.fleetsim",
                               *common, *args], cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return json.loads(proc.stdout)

    first = run("--requests", "30", "--capture-out", str(tmp_path / "cap.json"),
                "--out", str(tmp_path / "a.json"))
    assert json.loads((tmp_path / "a.json").read_text())["trace"] == first["trace"]
    assert first["capture"]["requests"] > 0
    replayed = run("--replay", str(tmp_path / "cap.json"))
    assert replayed["trace"]["replay_of"] == first["capture"]["digest"]
    assert replayed["trace"]["digest"] == first["capture"]["digest"]
    assert replayed["slo"]["ok"] > 0


def test_a_fault_is_armed_before_the_traffic_it_aims_at():
    """The progress fence: with the load behind the clock, every event at
    or past a fault's index is sent after the fault is applied (the JAX
    harness polls the cursor, so a fast request path can beat the arm)."""
    import threading
    import time

    sim = FleetSim(n_replicas=3, n_prefill=1, seed=1, workers=2, measure_hardening=False)
    sent, applied, lock = {}, [], threading.Lock()

    def do_request(bases, ev):
        with lock:
            sent[ev["i"]] = time.monotonic()
        time.sleep(0.05)
        return {"outcome": "ok"}

    def apply_chaos(ev, replicas, routers):
        time.sleep(0.05)  # a slow arm
        applied.append(time.monotonic())

    sim._do_request, sim._apply_chaos = do_request, apply_chaos
    trace = [{"at_s": i * 0.01, "i": i} for i in range(20)]
    sim._drive([], trace, [{"op": "x", "at_s": 0.095}], [], [])
    want_i = int(20 * 0.095 / 0.19)
    assert len(sent) == 20 and len(applied) == 1
    assert all(sent[i] >= applied[0] for i in range(want_i, 20)), (want_i, sent, applied)
    assert any(sent[i] < applied[0] for i in range(want_i))
