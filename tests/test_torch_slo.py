"""gofr_tpu_torch's SLO engine (``slo.py``) against gofr_tpu's
(``tests/test_slo.py``).

- ``parse_targets`` gives the same objectives (ids, budgets, scopes,
  thresholds) and refuses the same malformed specs.
- ``Objective.judge`` gives the same verdicts on the same records.
- ``SloEngine.evaluate`` over the same seeded flight records and the same
  timebase samples, under one injected clock, gives the same report:
  windows, burns, budgets, latched alerts (one an excursion, re-armed when
  the burn clears), anomaly events and gauges; the headline too.
- Over HTTP, a JAX echo app and the port's: a healthy run raises no alert;
  a burst of deadline misses pages on ``/admin/slo/budget``,
  ``/admin/anomalies`` and ``/admin/engine``'s ``slo`` headline alike.

Every test clears both packages' record, tenant, deadline and journal
contextvars.
"""

import json
import socket
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.deadline as jd
import gofr_tpu.slo as js
import gofr_tpu.telemetry as jt
import gofr_tpu.timebase as jtb
import gofr_tpu_torch
import gofr_tpu_torch.deadline as td
import gofr_tpu_torch.slo as ts
import gofr_tpu_torch.telemetry as tt
import gofr_tpu_torch.timebase as ttb
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu.metrics import Registry as JaxRegistry
from gofr_tpu_torch.config import DECLARED_KEYS
from gofr_tpu_torch.metrics import Registry


def _clear():
    for mod in (jt, tt):
        mod.activate_record(None)
        mod.activate_tenant(None)
        mod.activate_journal_entry(None)
    for mod in (jd, td):
        mod.activate_deadline(None)
        mod.activate_priority(None)


@pytest.fixture(autouse=True)
def _no_leaked_contextvars():
    _clear()
    yield
    _clear()


class Clock:
    """One injected clock: ``perf`` (the records' timebase), ``mono`` (the
    timebase's) and ``wall`` (display) all advance together."""

    def __init__(self, t=1000.0):
        self.t = t

    def perf(self):
        return self.t

    def mono(self):
        return self.t + 5.0

    def wall(self):
        return 1.7e9 + self.t


@pytest.fixture()
def clock(monkeypatch):
    """The port takes the clock as arguments; the JAX modules read it off
    their ``time`` module, replaced here by one that reads the same clock."""
    c = Clock()
    fake = types.SimpleNamespace(perf_counter=c.perf, monotonic=c.mono, time=c.wall)
    monkeypatch.setattr(js, "time", fake)
    monkeypatch.setattr(jtb, "time", fake)
    return c


# -- parsing and judging ---------------------------------------------------------

SPECS = [
    js.DEFAULT_TARGETS,
    "model=echo:ttft_p95_ms=500; tier>=5:availability=0.99;tpot_p99_ms=40",
    "tier=3:ttft_p99_ms=250;model=tiny:availability=0.95;shed_rate=1",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_targets_matches_jax(spec):
    assert ts.DEFAULT_TARGETS == js.DEFAULT_TARGETS
    got = [(o.to_dict(), o.threshold_s, o.tier, o.tier_ge, o.model)
           for o in ts.parse_targets(spec)]
    want = [(o.to_dict(), o.threshold_s, o.tier, o.tier_ge, o.model)
            for o in js.parse_targets(spec)]
    assert got == want and got


@pytest.mark.parametrize("spec", [
    "bogus=1", "availability", "availability=lots", "availability=1.5", "ttft_p95_ms=-3",
    "tier=11:availability=0.9", "planet=mars:availability=0.9", "model=:availability=0.9",
    "tier=9:shed_rate=0.1", "availability=0.9;availability=0.99",
])
def test_malformed_targets_refuse_alike(spec):
    with pytest.raises(ValueError) as got:
        ts.parse_targets(spec)
    with pytest.raises(ValueError) as want:
        js.parse_targets(spec)
    assert str(got.value) == str(want.value)


def _workload(mod, clock, n=240, seed=3):
    """``n`` finished records drawn from a numpy seed: statuses, models,
    tiers, TTFT and TPOT, and ages over four hours; the same draws in
    either package."""
    rng = np.random.default_rng(seed)
    recorder = mod.FlightRecorder(capacity=4096)
    statuses = rng.choice(["ok", "ok", "ok", "error", "deadline_exceeded", "cancelled"], n)
    models = rng.choice(["echo", "tiny"], n)
    priorities = rng.choice([-1, 3, 5, 9], n)
    ttfts = rng.uniform(0.01, 1.2, n)
    ages = rng.uniform(0.0, 4 * 3600.0, n)
    no_token = rng.uniform(size=n) < 0.2
    decode_s = rng.uniform(0.1, 1.0, n)
    for i in range(n):
        rec = recorder.start(str(models[i]), "/v1/completions", activate=False)
        rec.priority = None if priorities[i] < 0 else int(priorities[i])
        recorder.finish(rec, status=str(statuses[i]))
        rec.t_done = clock.perf() - float(ages[i])
        rec.t_start = rec.t_done - 2.0
        if not no_token[i]:
            rec.t_first_token = rec.t_start + float(ttfts[i])
            rec.t_last_token = rec.t_first_token + float(decode_s[i])
            rec.tokens_out = 11
    return recorder


def test_judge_matches_jax(clock):
    records = {"port": _workload(tt, clock), "jax": _workload(jt, clock)}
    for spec in SPECS[1:]:
        for got_o, want_o in zip(ts.parse_targets(spec), js.parse_targets(spec)):
            if got_o.metric == "shed_rate":
                continue  # measured from the shed counters, never judged per record
            got = [got_o.judge(r) for r in records["port"].finished_since(-1e18)]
            want = [want_o.judge(r) for r in records["jax"].finished_since(-1e18)]
            assert got == want
            assert {v for v in got} >= {True, None}


def _engine(mod, tb_mod, clock, registry, recorder, targets, **kw):
    sampler_kw = {} if tb_mod is jtb else {"clock": clock.mono, "wall": clock.wall}
    sampler = tb_mod.TimebaseSampler(registry, interval_s=60.0, window_s=4 * 3600.0,
                                     start=False, **sampler_kw)
    engine_kw = {} if mod is js else {"clock": clock.perf, "wall": clock.wall}
    engine = mod.SloEngine(recorder, timebase=sampler, metrics=registry, targets=targets,
                           fast_s=300.0, fast_long_s=3600.0, slow_s=7200.0,
                           slow_long_s=14400.0, **kw, **engine_kw)
    return engine, sampler


def _burn_story(mod, tb_mod, tel, registry, clock):
    targets = ("availability=0.99;tier=9:availability=0.999;model=echo:ttft_p95_ms=500;"
               "tpot_p99_ms=400;shed_rate=0.2")
    recorder = _workload(tel, clock)
    engine, sampler = _engine(mod, tb_mod, clock, registry, recorder, targets)
    shed = registry.counter("gofr_tpu_brownout_shed_total", labels=("priority",))
    out = []
    for step in range(6):
        sampler.sample_now()
        shed.inc(5 * step, priority=str(step % 3))
        clock.t += 60.0
        report = engine.evaluate()
        report.pop("ts")
        out.append(report)
    # a burst of errors pages; the latch holds while it burns
    for _ in range(40):
        rec = recorder.start("echo", "/v1/completions", activate=False)
        recorder.finish(rec, status="error")
    out.append(engine.evaluate()["alerts_total"])
    out.append(engine.evaluate()["alerts_total"])
    out.append(engine.headline())
    # the burst ages out of every window: the latch re-arms
    clock.t += 5 * 3600.0
    cleared = engine.evaluate()
    out.append([row["alerting"] for row in cleared["objectives"]])
    events = engine.ring.events(kind="slo")
    out.append([{k: v for k, v in e.items() if k not in ("seq", "ts")} for e in events])
    gauges = {name: registry.gauge(name, labels=labels).data() for name, labels in (
        ("gofr_tpu_slo_burn_rate", ("objective", "window")),
        ("gofr_tpu_slo_budget_remaining", ("objective",)),
    )}
    out.append(gauges)
    out.append(registry.counter("gofr_tpu_slo_burn_alerts_total",
                                labels=("objective", "window")).data())
    return out


def test_evaluate_matches_jax_under_one_clock(clock):
    start = clock.t
    got = _burn_story(ts, ttb, tt, Registry(), clock)
    clock.t = start
    want = _burn_story(js, jtb, jt, JaxRegistry(), clock)
    assert got == want
    assert got[6] > 0 and got[7] == got[6]  # one alert an excursion
    assert got[8]["alerting"]


def test_engine_validates_its_windows():
    for kwargs, match in (({"fast_s": 10, "fast_long_s": 5}, "windows"),
                          ({"fast_rate": 0}, "threshold"), ({"interval_s": 0}, "INTERVAL")):
        with pytest.raises(ValueError, match=match):
            ts.SloEngine(tt.FlightRecorder(capacity=4), **kwargs)
        with pytest.raises(ValueError, match=match):
            js.SloEngine(jt.FlightRecorder(capacity=4), **kwargs)


# -- over HTTP ----------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture()
def echo_apps(monkeypatch, tmp_path):
    from gofr_tpu.openai_compat import register_openai_routes as jax_routes

    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    for key, value in {"MODEL_NAME": "echo", "BATCH_MAX_SIZE": "1", "BATCH_TIMEOUT_MS": "1",
                       "ECHO_STEP_MS": "10", "TIMEBASE_ENABLED": "off", "LOG_LEVEL": "FATAL",
                       "WATCHDOG_DISPATCH_TIMEOUT_S": "off"}.items():
        monkeypatch.setenv(key, value)
    apps = []
    for label in ("jax", "torch"):
        monkeypatch.setenv("HTTP_PORT", str(_free_port()))
        if label == "jax":
            app = gofr_tpu.new()
            jax_routes(app)
        else:
            app = gofr_tpu_torch.new()
            gofr_tpu_torch.register_openai_routes(app)
        app.start()
        apps.append(app)
    yield apps
    for app in reversed(apps):
        app.shutdown()


def _post(app, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{app.http_port}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status
    except urllib.error.HTTPError as exc:
        return exc.code


def _admin(app, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{app.http_port}{path}", timeout=10) as resp:
        return json.loads(resp.read())["data"]


def _budget_view(app):
    budget = _admin(app, "/admin/slo/budget")
    rows = {row["objective"]: (row["windows"]["5m"]["bad"], row["windows"]["5m"]["total"],
                               row["alerting"]) for row in budget["objectives"]}
    causes = sorted(e["cause"] for e in _admin(app, "/admin/anomalies")["anomalies"])
    return rows, budget["alerts_total"], causes, _admin(app, "/admin/engine")["slo"]


def test_a_healthy_run_is_quiet_and_a_burst_pages_alike(echo_apps):
    views = []
    for app in echo_apps:
        for _ in range(6):
            assert _post(app, {"prompt": [1, 2, 3], "max_tokens": 3}) == 200
        healthy = _budget_view(app)
        for _ in range(6):
            assert _post(app, {"prompt": [1, 2, 3], "max_tokens": 3},
                         {"X-Request-Deadline-Ms": "2", "X-Priority": "9"}) == 504
        views.append((healthy, _budget_view(app)))
    assert views[1] == views[0]
    healthy, burst = views[1]
    assert healthy[1] == 0 and healthy[2] == [] and healthy[3]["alerting"] == []
    assert burst[0]["availability"][:2] == (6, 12)
    assert burst[0]["tier9.availability"][:2] == (6, 6)
    assert burst[1] > 0 and "slo_fast_burn" in burst[2]
    assert "availability" in burst[3]["alerting"]
