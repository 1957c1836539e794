"""gofr_tpu_torch's telemetry timebase (``timebase.py``) against gofr_tpu's
(``tests/test_timebase.py``, its timebase part).

- The same registry traffic sampled by both samplers under one injected
  clock gives the same series, per-second rates (a counter reset clamps to
  0), summed rates, counter deltas, interval-local quantile trends (the
  overflow bucket included), bounded rings, windows and JSON snapshots.
- The samplers refuse the same bad intervals.
- Over HTTP, a JAX echo app and the port's serve ``/admin/timeseries`` (a
  counter with its rate series, label filters, the 400s) and
  ``/admin/overview`` with the same keys and the same counts, and the
  port's ``/admin/costmodel`` carries ``anomalies_per_sec``.

Every test clears both packages' record, deadline and journal
contextvars.
"""

import json
import socket
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.deadline as jd
import gofr_tpu.telemetry as jt
import gofr_tpu.timebase as jtb
import gofr_tpu_torch
import gofr_tpu_torch.deadline as td
import gofr_tpu_torch.telemetry as tt
import gofr_tpu_torch.timebase as ttb
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu.metrics import Registry as JaxRegistry
from gofr_tpu_torch.config import DECLARED_KEYS
from gofr_tpu_torch.metrics import Registry


def _clear():
    for mod in (jt, tt):
        mod.activate_record(None)
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
    def __init__(self, t=50.0):
        self.t = t

    def mono(self):
        return self.t

    def wall(self):
        return 1.7e9 + self.t


@pytest.fixture()
def clock(monkeypatch):
    """One clock for both samplers: the port's takes it as arguments, the
    JAX module reads it off its ``time`` module, replaced here."""
    c = Clock()
    monkeypatch.setattr(jtb, "time", types.SimpleNamespace(monotonic=c.mono, time=c.wall))
    return c


def _sampler(mod, registry, clock, interval_s=1.0, window_s=30.0):
    kw = {"clock": clock.mono, "wall": clock.wall} if mod is ttb else {}
    return mod.TimebaseSampler(registry, interval_s=interval_s, window_s=window_s,
                               start=False, **kw)


def _traffic(mod, registry, clock, seed=11):
    """Seeded counter, gauge and histogram traffic over 40 samples (more
    than the ring keeps), with a counter reset, then every query."""
    rng = np.random.default_rng(seed)
    sampler = _sampler(mod, registry, clock)
    counter = registry.counter("gofr_t_total", "t", labels=("k",))
    gauge = registry.gauge("gofr_g", "g", labels=("k",))
    hist = registry.histogram("gofr_q_seconds", "q", buckets=(0.1, 1.0, 10.0))
    for step in range(40):
        for k in ("a", "b"):
            counter.inc(int(rng.integers(0, 20)), k=k)
            gauge.set(float(rng.uniform()), k=k)
        for value in rng.choice([0.05, 0.5, 5.0, 50.0], size=int(rng.integers(0, 12))):
            hist.observe(float(value))
        if step == 25:
            counter._values[("a",)] = 3.0  # a restarted process's fresh counter
        clock.t += float(rng.uniform(0.5, 1.5))
        sampler.sample_now()
    return [
        sampler.stats(),
        sampler.series("gofr_t_total"),
        sampler.series("gofr_t_total", labels={"k": "a"}, window=10.0),
        sampler.series("gofr_g"),
        sampler.series("gofr_q_seconds"),
        sampler.series("gofr_unknown_total"),
        sampler.rate_total("gofr_t_total"),
        sampler.rate_total("gofr_t_total", labels={"k": "b"}),
        sampler.counter_delta("gofr_t_total", window=15.0),
        sampler.hist_quantile_trend("gofr_q_seconds", 0.95),
        sampler.hist_quantile_trend("gofr_q_seconds", 0.5, window=8.0),
        len(sampler.snapshots(last=3)),
        len(sampler.snapshots(window=5.0)),
        mod.jsonable_snapshots(sampler.snapshots(last=2)),
    ]


def test_the_same_traffic_gives_the_same_views(clock):
    start = clock.t
    got = _traffic(ttb, Registry(), clock)
    clock.t = start
    want = _traffic(jtb, JaxRegistry(), clock)
    assert got == want
    stats, series = got[0], got[1]
    assert stats["snapshots"] == 31  # window / interval + 1
    assert all(r >= 0 for s in series["series"] for _, r in s["rate"])  # the reset clamps
    assert got[9] and {v for _, v in got[9]} <= {0.1, 1.0, 10.0}


def test_the_samplers_refuse_the_same_intervals():
    for kwargs in ({"interval_s": 0}, {"interval_s": 5, "window_s": 1}):
        with pytest.raises(ValueError) as got:
            ttb.TimebaseSampler(Registry(), start=False, **kwargs)
        with pytest.raises(ValueError) as want:
            jtb.TimebaseSampler(JaxRegistry(), start=False, **kwargs)
        assert str(got.value) == str(want.value)


def test_the_sampler_thread_samples_and_stops():
    sampler = ttb.TimebaseSampler(Registry(), interval_s=0.02, window_s=1.0)
    try:
        deadline_at = time.monotonic() + 2.0
        while sampler.stats()["snapshots"] < 3:
            assert time.monotonic() < deadline_at
            time.sleep(0.01)
    finally:
        sampler.close()
    assert sampler._thread.name == "gofr-timebase"


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
                       "LOG_LEVEL": "FATAL", "TIMEBASE_INTERVAL_S": "60",
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


def _get(app, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{app.http_port}{path}",
                                    timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _post(app, body):
    req = urllib.request.Request(f"http://127.0.0.1:{app.http_port}/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status


def test_timeseries_and_overview_match_jax(echo_apps):
    views = []
    for app in echo_apps:
        timebase = app.container.timebase
        timebase.sample_now()  # the sampler thread took the first already
        for _ in range(3):
            assert _post(app, {"prompt": [1, 2, 3], "max_tokens": 4}) == 200
        timebase.sample_now()
        status, body = _get(app, "/admin/timeseries?metric=gofr_tpu_requests_total"
                                 "&labels=op:generate")
        series = body["data"]["series"]
        view = [status, body["data"]["kind"],
                [(s["labels"], s["points"][-1][1], len(s["rate"]) > 0) for s in series]]
        view.append(sorted(body["data"]["timebase"]))
        for bad in ("", "?metric=gofr_nope_total", "?metric=gofr_tpu_requests_total&window=-1",
                    "?metric=gofr_tpu_requests_total&labels=broken"):
            view.append(_get(app, "/admin/timeseries" + bad))
        status, overview = _get(app, "/admin/overview")
        data = overview["data"]
        view.append((status, sorted(data), data["engine"]["state"], data["requests_in_flight"],
                     data["slo_budget"]["alerting"], data["decode_pool"]))
        views.append(view)
    assert views[1] == views[0]
    assert views[1][2][0][1] == 3.0
    status, cost = _get(echo_apps[1], "/admin/costmodel")
    assert status == 200 and set(cost["data"]["anomalies_per_sec"]) == {"now", "trend"}
    assert set(cost["data"]) == set(_get(echo_apps[0], "/admin/costmodel")[1]["data"])
