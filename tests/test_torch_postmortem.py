"""gofr_tpu_torch's postmortem black box (``postmortem.py``) against
gofr_tpu's (``tests/test_timebase.py``, its postmortem part).

- A bundle assembled from the same stub sources carries the same sections
  in both packages (the schema, the requests and those in flight, the
  timebase snapshots, the thread stacks), written atomically; the
  ``versions`` block names torch and its CUDA (and, on a machine with a
  card, the driver, the card and its power limit), never jax.
- The same write sequence gives the same verdicts: the automatic rate
  limit, a forced write that neither reads nor spends it, retention, a
  failed write refunding the budget.
- The config fingerprint redacts the same secrets of the same environment.
- The engine listener writes a ``wedged`` bundle on a thread of its own.
- Over HTTP, a JAX echo app and the port's: ``POST /admin/postmortem``
  writes an annotated bundle and ``GET /admin/postmortem`` lists it; an
  injected stall (recovery off) leaves a bundle holding the stalled
  dispatch id, the flight record riding it and the stalled thread's stack.

Every test clears both packages' record, deadline and journal
contextvars.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import gofr_tpu
import gofr_tpu.deadline as jd
import gofr_tpu.postmortem as jp
import gofr_tpu.telemetry as jt
import gofr_tpu.timebase as jtb
import gofr_tpu.tpu.introspect as ji
import gofr_tpu_torch
import gofr_tpu_torch.deadline as td
import gofr_tpu_torch.postmortem as tp
import gofr_tpu_torch.telemetry as tt
import gofr_tpu_torch.timebase as ttb
import gofr_tpu_torch.tpu.introspect as ti
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


PACKAGES = {"port": (tp, tt, ttb, ti, Registry), "jax": (jp, jt, jtb, ji, JaxRegistry)}


class _Stub:
    """The container's sources a bundle reads, without a device."""

    def __init__(self, tel, tb, registry):
        self.metrics = registry
        self.telemetry = tel.FlightRecorder(capacity=8, keep=4)
        self.timebase = tb.TimebaseSampler(registry, interval_s=0.5, window_s=60.0,
                                           start=False)
        self.tpu = None


def _store(pkg, directory, **kw):
    pm, tel, tb, _, registry = PACKAGES[pkg]
    stub = _Stub(tel, tb, registry())
    return pm.PostmortemStore(stub, directory=str(directory), **kw), stub


def _bundle_view(pkg, tmp_path):
    store, stub = _store(pkg, tmp_path / pkg)
    stub.timebase.sample_now()
    stub.timebase.sample_now()
    record = stub.telemetry.start("m", "/v1/x", trace_id="t1", activate=False)
    stub.telemetry.finish(record)
    in_flight = stub.telemetry.start("m", "/v1/y", trace_id="t2", activate=False)
    path = store.write(reason="manual", detail="drill", force=True)
    assert path and os.path.exists(path) and in_flight is not None
    assert not [n for n in os.listdir(store.directory) if n.endswith(".tmp")]
    bundle = json.load(open(path))
    return bundle, {
        "keys": sorted(bundle),
        "head": (bundle["schema"], bundle["reason"], bundle["detail"], bundle["pid"]),
        "requests": [r["trace_id"] for r in bundle["requests"]],
        "in_flight": [r["trace_id"] for r in bundle["requests_in_flight"]],
        "timebase": len(bundle["timebase"]),
        "threads": bool(any(t["stack"] for t in bundle["threads"])),
        "file": os.path.basename(path).startswith("postmortem-"),
    }


def test_a_bundle_has_the_jax_sections(tmp_path):
    (bundle, got), (jbundle, want) = _bundle_view("port", tmp_path), _bundle_view("jax", tmp_path)
    assert got == want
    assert got["requests"] == ["t1"] and got["in_flight"] == ["t2"] and got["timebase"] == 2
    versions = bundle["versions"]
    assert {"gofr_tpu_torch", "python", "torch", "cuda", "driver", "card", "power_limit",
            "platform"} == set(versions)
    assert versions["torch"] and "jax" not in versions and "libtpu" not in versions
    assert bundle["config"] and set(bundle["config"]) == set(jbundle["config"])


def _limits(pkg, directory):
    store, stub = _store(pkg, directory, keep=2, min_interval_s=3600.0)
    out = [store.write(reason="manual", force=True) is not None]
    time.sleep(0.002)  # distinct file names (ms resolution)
    out.append(store.write(reason="wedged") is not None)
    out.append(store.write(reason="wedged") is None)  # rate-limited
    for _ in range(3):
        time.sleep(0.002)
        out.append(store.write(reason="manual", force=True) is not None)
    out.append(len(store.list()))
    fresh, stub = _store(pkg, str(directory) + "-refund", min_interval_s=3600.0)
    good = stub.timebase
    stub.timebase = object()  # a broken source: the bundle raises
    out.append(fresh.write(reason="wedged") is None)
    stub.timebase = good
    out.append(fresh.write(reason="wedged") is not None)  # the budget came back
    return out


def test_rate_limit_retention_and_refund_match_jax(tmp_path):
    got, want = _limits("port", tmp_path / "port"), _limits("jax", tmp_path / "jax")
    assert got == want == [True, True, True, True, True, True, 2, True, True]


def test_the_config_fingerprint_redacts_alike(monkeypatch):
    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("ADMIN_TOKEN", "hunter2")
    monkeypatch.setenv("MODEL_NAME", "echo")
    monkeypatch.setenv("GEN_STOP_TOKENS", "1,2")  # not a secret
    monkeypatch.setenv("TRACER_PASSWORD", "pw")
    got, want = tp._config_fingerprint(), jp._config_fingerprint()
    assert got == want
    assert got["keys"]["ADMIN_TOKEN"] == got["keys"]["TRACER_PASSWORD"] == "<redacted>"
    assert got["keys"]["GEN_STOP_TOKENS"] == "1,2" and "hunter2" not in json.dumps(got)
    # the port's own keys are fingerprinted too
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    monkeypatch.setenv("JOURNAL_DIR", "/j")
    assert {"TORCH_DEVICE", "JOURNAL_DIR"} <= set(tp._config_fingerprint()["keys"])


def test_the_engine_listener_writes_on_a_wedge(tmp_path):
    out = {}
    for pkg in PACKAGES:
        store, _ = _store(pkg, tmp_path / pkg)
        engine = PACKAGES[pkg][3].EngineState()
        store.watch_engine(engine)
        engine.transition("serving")
        assert store.list() == []  # only wedged and failed write
        engine.transition("wedged", "dispatch 7 stalled")
        deadline_at = time.time() + 5.0
        while not store.list() and time.time() < deadline_at:
            time.sleep(0.01)
        (entry,) = store.list()
        bundle = json.load(open(os.path.join(store.directory, entry["file"])))
        out[pkg] = (bundle["reason"], bundle["detail"])
    assert out["port"] == out["jax"] == ("wedged", "dispatch 7 stalled")


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
    for key, value in {"MODEL_NAME": "echo", "TOKENIZER": "byte", "BATCH_MAX_SIZE": "1",
                       "BATCH_TIMEOUT_MS": "1", "LOG_LEVEL": "FATAL",
                       "TIMEBASE_INTERVAL_S": "0.05", "WATCHDOG_DISPATCH_TIMEOUT_S": "0.05",
                       "RECOVERY_ENABLED": "off"}.items():
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
        # a directory of its own (POSTMORTEM_DIR would also arm the
        # process-wide crash hooks, which outlive the test)
        app.container.postmortem.directory = str(tmp_path / f"pm-{label}")
        app.start()
        apps.append(app)
    yield apps
    for app in reversed(apps):
        app.shutdown()


def _call(app, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{app.http_port}{path}",
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_the_admin_routes_and_a_stall_bundle_match_jax(echo_apps):
    views = []
    for app in echo_apps:
        store = app.container.postmortem
        status, out = _call(app, "/admin/postmortem", {"detail": "operator drill"})
        manual = json.load(open(out["data"]["path"]))
        status2, listing = _call(app, "/admin/postmortem")
        listed = [os.path.join(listing["data"]["dir"], b["file"])
                  for b in listing["data"]["bundles"]]
        # an injected stall wedges the engine: the listener's bundle
        tpu = app.container.tpu
        release = threading.Event()
        tpu.runner.stall_hook = lambda: release.wait(10)  # held until the bundle is read
        worker = threading.Thread(target=_call, args=(
            app, "/v1/completions", {"prompt": "stall", "max_tokens": 1}))
        worker.start()
        bundle = None
        deadline_at = time.time() + 10.0
        while bundle is None and time.time() < deadline_at:
            wedged = [b for b in store.list() if os.path.join(store.directory, b["file"])
                      not in listed]
            if wedged:
                path = os.path.join(store.directory, wedged[0]["file"])
                for _ in range(50):  # the atomic write's rename may still be on its way
                    try:
                        bundle = json.load(open(path))
                        break
                    except (OSError, ValueError):
                        time.sleep(0.01)
            time.sleep(0.01)
        release.set()
        worker.join(30)
        tpu.runner.stall_hook = None
        assert bundle is not None, "a wedge wrote no bundle"
        stalled = {w["dispatch_id"] for w in bundle["engine"]["watchdog"]["watching"]
                   if w["stalled"]}
        running = {d["dispatch_id"] for d in bundle["dispatches"] if d["status"] == "running"}
        riders = [r for r in bundle["requests_in_flight"] if set(r["dispatch_ids"]) & stalled]
        stacks = [t["stack"] for t in bundle["threads"]]
        views.append((status, out["data"]["reason"], manual["detail"], status2,
                      out["data"]["path"] in listed, bundle["reason"], bool(stalled),
                      stalled <= running, len(riders), any("stall_hook" in s for s in stacks),
                      len(bundle["timebase"]) >= 1))
    assert views[1] == views[0] == (200, "manual", "operator drill", 200, True, "wedged",
                                    True, True, 1, True, True)
