"""gofr_tpu_torch's deadlines, priorities, brownout and client-abort
cancellation (``deadline.py``, the batcher's queue shed, the admission gate
of ``openai/parse.py``, the decode loops' expiry) against gofr_tpu's
(``tests/test_deadline.py``, its echo parts).

- Units on the same inputs: ``parse_deadline`` / ``parse_priority`` give
  the same budgets, tiers and 400s; ``clamp_spec_k`` the same widths over
  a grid; the ``BrownoutController`` the same levels, verdicts and
  snapshots over the same signal sequence (a numpy seed); both batchers
  shed an expired item at dequeue (stage ``queue``) and skip a cancelled
  one, and count alike.
- Over HTTP, a JAX echo app and the port's take the same requests: the
  same statuses, the same ``gofr_tpu_deadline_exceeded_total`` stages,
  pool rejects and cancellations, the same flight-record ``deadline_s``,
  ``priority`` and ``shed_stage``, the same brownout levels, 429 bodies and
  ``Retry-After``; a stream cut by its deadline is a prefix of the full one
  and gives its blocks back, and a client that hangs up is counted and
  freed the same way.

Every test clears both packages' deadline, priority, journal and record
contextvars (none may leak into another test in this worker).
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.deadline as jd
import gofr_tpu.telemetry as jt
import gofr_tpu_torch
import gofr_tpu_torch.deadline as td
import gofr_tpu_torch.telemetry as tt
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu.errors import DeadlineExceeded as JaxDeadlineExceeded
from gofr_tpu.errors import HTTPError as JaxHTTPError
from gofr_tpu.metrics import Registry as JaxRegistry
from gofr_tpu_torch.config import DECLARED_KEYS
from gofr_tpu_torch.errors import DeadlineExceeded, HTTPError
from gofr_tpu_torch.metrics import Registry


def _clear():
    for mod in (jd, td):
        mod.activate_deadline(None)
        mod.activate_priority(None)
    for mod in (jt, tt):
        mod.activate_record(None)
        mod.activate_journal_entry(None)


@pytest.fixture(autouse=True)
def _no_leaked_contextvars():
    _clear()
    yield
    _clear()


# -- units on the same inputs -----------------------------------------------------

@pytest.mark.parametrize("raw,default", [
    (None, 0.0), ("", 0.0), (None, 2.5), ("1500", 0.0), ("1500", 9.0), ("0", 3.0),
    ("-1", 0.0), ("soon", 0.0), ("2.5", 0.0),
])
def test_parse_deadline_matches_jax(raw, default):
    def run(mod, http_error):
        try:
            d = mod.parse_deadline(raw, default, priority=7)
        except http_error as exc:
            return ("400", exc.status_code, str(exc))
        return None if d is None else (d.budget_s, d.priority, round(d.remaining()))

    assert run(td, HTTPError) == run(jd, JaxHTTPError)


@pytest.mark.parametrize("raw", [None, "", "0", "5", "9", "12", "-3", "high"])
def test_parse_priority_matches_jax(raw):
    def run(mod, http_error):
        try:
            return mod.parse_priority(raw, default=4)
        except http_error as exc:
            return ("400", exc.status_code, str(exc))

    assert run(td, HTTPError) == run(jd, JaxHTTPError)


def test_deadline_expiry_and_constants():
    assert (td.PRIORITY_MIN, td.PRIORITY_MAX, td.PRIORITY_DEFAULT) == \
        (jd.PRIORITY_MIN, jd.PRIORITY_MAX, jd.PRIORITY_DEFAULT)
    d = td.Deadline(0.05, priority=3)
    assert not d.expired() and 0 < d.remaining() <= 0.05 and d.priority == 3
    time.sleep(0.06)
    assert d.expired() and d.remaining() < 0
    assert repr(d).startswith("Deadline(budget_s=0.050")


def test_clamp_spec_k_matches_jax_over_a_grid():
    class Fixed:  # a deadline with a fixed remaining budget
        def __init__(self, remaining):
            self._r = remaining

        def remaining(self):
            return self._r

    for k in range(0, 6):
        for level in (0, 1, 2):
            for remaining in (None, 0.0, 0.05, 0.3, 2.0):
                for cadence in (0.0, 0.1):
                    dl = None if remaining is None else Fixed(remaining)
                    assert td.clamp_spec_k(k, level, dl, cadence) == \
                        jd.clamp_spec_k(k, level, dl, cadence), (k, level, remaining, cadence)


def _brownout_run(mod, registry, depths, utils, priorities):
    state = {"depth": 0, "util": 0.0}
    ctl = mod.BrownoutController(
        metrics=registry, queue_hi=6, kv_hi=0.6, shed_priority=5, clamp_tokens=16,
        queue_depth_fn=lambda: state["depth"], kv_util_fn=lambda: state["util"],
        refresh_s=0.0,
    )
    out = []
    for depth, util, priority in zip(depths, utils, priorities):
        state["depth"], state["util"] = int(depth), float(util)
        out.append((ctl.level(), ctl.admit(int(priority), 256)))
    snap = ctl.snapshot()
    gauge = registry.gauge("gofr_tpu_brownout_level").value()
    sheds = registry.counter("gofr_tpu_brownout_shed_total", labels=("priority",)).data()
    return out, snap, gauge, sheds


def test_brownout_controller_matches_jax_on_a_seeded_signal():
    rng = np.random.default_rng(13)
    depths = rng.integers(0, 15, size=60)
    utils = rng.uniform(0.0, 1.0, size=60)
    priorities = rng.integers(0, 10, size=60)
    got = _brownout_run(td, Registry(), depths, utils, priorities)
    want = _brownout_run(jd, JaxRegistry(), depths, utils, priorities)
    assert got == want
    levels = {level for level, _ in got[0]}
    assert levels == {0, 1, 2}  # the seed walks every level
    # an inert controller sheds nothing in both
    for mod in (td, jd):
        inert = mod.BrownoutController(queue_depth_fn=lambda: 10 ** 6)
        assert not inert.armed and inert.level() == 0 and inert.admit(0, 8) == (True, 8, 0)


def _shed_in_queue(mod_batcher, mod_deadline, registry):
    """The JAX test's shape: one dispatch thread parked by a blocker, a
    doomed item expiring in the queue behind it, then a fresh item."""
    seen: list = []
    gate = threading.Event()

    def run_batch(payloads):
        if payloads == ["blocker"]:
            gate.wait(5.0)
        seen.extend(payloads)
        return payloads

    batcher = mod_batcher.DynamicBatcher(run_batch, max_batch=1, timeout_ms=1,
                                         metrics=registry, name="t-shed", pipeline_depth=1)
    try:
        blocker = batcher.submit("blocker")
        time.sleep(0.02)
        mod_deadline.activate_deadline(mod_deadline.Deadline(0.03))
        try:
            doomed = batcher.submit("doomed")
        finally:
            mod_deadline.activate_deadline(None)
        time.sleep(0.06)
        gate.set()
        assert blocker.result(timeout=5) == "blocker"
        with pytest.raises(Exception) as err:
            doomed.result(timeout=5)
        fresh = batcher.submit("fresh")
        assert fresh.result(timeout=5) == "fresh"
        # a cancelled item is skipped at dequeue
        gate.clear()
        blocker = batcher.submit("blocker")
        time.sleep(0.02)
        victim = batcher.submit("victim")
        assert victim.cancel()
        gate.set()
        blocker.result(timeout=5)
        assert batcher.submit("survivor").result(timeout=5) == "survivor"
    finally:
        gate.set()
        batcher.close()
    counter = registry.counter("gofr_tpu_deadline_exceeded_total", labels=("stage",))
    return (type(err.value).__name__, err.value.stage, "doomed" in seen, "victim" in seen,
            counter.value(stage="queue"))


def test_batcher_queue_shed_matches_jax():
    import gofr_tpu.tpu.batcher as jb
    import gofr_tpu_torch.tpu.batcher as tb

    got = _shed_in_queue(tb, td, Registry())
    want = _shed_in_queue(jb, jd, JaxRegistry())
    assert got == want == ("DeadlineExceeded", "queue", False, False, 1.0)


def test_the_queue_signal_misses_the_dispatch_backlog():
    """A fault of the reference the port keeps (ROADMAP §C): the brownout's
    queue-depth signal reads the batcher's queue and displaced items, but
    the worker hands batches to the dispatch threads at once, where they
    wait uncounted. 12 requests behind two busy dispatch threads: most
    are unserved, yet the depth reads at most one, in both packages."""
    import gofr_tpu.tpu.batcher as jb
    import gofr_tpu_torch.tpu.batcher as tb

    out = {}
    for label, mod in (("port", tb), ("jax", jb)):
        gate = threading.Event()

        def run_batch(payloads, gate=gate):
            gate.wait(5.0)
            return payloads

        batcher = mod.DynamicBatcher(run_batch, max_batch=2, timeout_ms=1, pipeline_depth=2)
        try:
            futures = [batcher.submit(i) for i in range(12)]
            time.sleep(0.1)
            out[label] = (batcher._depth() <= 1, sum(not f.done() for f in futures))
            gate.set()
            assert [f.result(timeout=5) for f in futures] == list(range(12))
        finally:
            gate.set()
            batcher.close()
    assert out["port"] == out["jax"] == (True, 12)


def test_deadline_exceeded_maps_to_504_with_its_stage():
    exc = DeadlineExceeded("late", stage="decode")
    jexc = JaxDeadlineExceeded("late", stage="decode")
    assert (exc.status_code, exc.stage, str(exc)) == (jexc.status_code, jexc.stage, str(jexc))
    assert exc.status_code == 504


# -- over HTTP: a JAX echo app and the port's ----------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ECHO = {"MODEL_NAME": "echo", "BATCH_MAX_SIZE": "1",
        "BATCH_TIMEOUT_MS": "1", "ECHO_STEP_MS": "15", "FLIGHT_SLOW_MS": "60000",
        "KV_BLOCKS": "32", "TIMEBASE_ENABLED": "off", "LOG_LEVEL": "FATAL",
        "WATCHDOG_DISPATCH_TIMEOUT_S": "off"}


@pytest.fixture()
def echo_apps(monkeypatch, tmp_path):
    """A JAX echo app and the port's, with a per-token cadence and a small
    paged arena (32 blocks)."""
    from gofr_tpu.openai_compat import register_openai_routes as jax_routes

    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    for key, value in ECHO.items():
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


def _post(app, body, headers=None, path="/v1/completions"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{app.http_port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), dict(exc.headers)


def _admin(app, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{app.http_port}{path}", timeout=10) as resp:
        return json.loads(resp.read())["data"]


def _counter(app, name, label):
    registry = app.container.metrics
    return dict(registry.counter(name, labels=(label,)).data())


def _sse_tokens(raw):
    """The token ids a completions stream carried, and its error frame."""
    ids, error = [], None
    for line in raw.split("\n"):
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        frame = json.loads(line[6:])
        if "error" in frame:
            error = frame["error"]["message"]
            continue
        for choice in frame["choices"]:
            ids.extend(choice.get("tokens") or ())
    return ids, error


def _record_fields(app):
    rec = _admin(app, "/admin/requests?limit=1")["requests"][0]
    return rec["status"], rec["deadline_s"], rec["priority"], rec["shed_stage"]


def test_deadline_and_priority_stamp_the_flight_record(echo_apps):
    got = []
    for app in echo_apps:
        status, _, _ = _post(app, {"prompt": [1, 2, 3], "max_tokens": 3, "temperature": 0},
                             {"X-Request-Deadline-Ms": "30000", "X-Priority": "8"})
        got.append((status, _record_fields(app)))
        # no header and no REQUEST_DEADLINE_S: no deadline, the default tier
        _post(app, {"prompt": [4, 5], "max_tokens": 2})
        got.append(_record_fields(app))
    assert got[0] == got[2] == (200, ("ok", 30.0, 8, None))
    assert got[1] == got[3] == ("ok", None, 5, None)


@pytest.mark.parametrize("headers", [
    {"X-Request-Deadline-Ms": "soon"}, {"X-Request-Deadline-Ms": "-5"},
    {"X-Priority": "urgent"},
])
def test_malformed_headers_are_400_alike(echo_apps, headers):
    got = [_post(app, {"prompt": [1, 2], "max_tokens": 2}, headers) for app in echo_apps]
    assert got[0][0] == got[1][0] == 400
    assert json.loads(got[0][1]) == json.loads(got[1][1])


def test_a_budget_below_a_step_is_refused_at_admission(echo_apps):
    """25 ms of budget against a 15 ms prefill and a 15 ms step: what is
    left after the prefill cannot cover a step, so both shed at the decode
    admission gate (504), with the ``deadline`` pool reject."""
    got = []
    for app in echo_apps:
        status, raw, _ = _post(app, {"prompt": [1, 2, 3], "max_tokens": 8},
                               {"X-Request-Deadline-Ms": "25"})
        got.append((status, json.loads(raw)["error"]["message"].split(" budget")[0],
                    _counter(app, "gofr_tpu_deadline_exceeded_total", "stage"),
                    _counter(app, "gofr_tpu_pool_reject_total", "reason"),
                    _record_fields(app)))
    assert got[0] == got[1]
    assert got[1][0] == 504 and got[1][2] == {("admission",): 1.0}
    assert got[1][4] == ("deadline_exceeded", 0.025, 5, "admission")


def test_a_stream_cut_by_its_deadline_is_a_prefix_and_frees_its_blocks(echo_apps):
    body = {"prompt": [3, 1, 4, 1, 5], "max_tokens": 60, "stream": True, "temperature": 0}
    full = {}
    for label, app in zip(("jax", "torch"), echo_apps):
        full[label] = _sse_tokens(_post(app, body)[1])[0]
    assert full["torch"] == full["jax"] and len(full["torch"]) == 60
    got = []
    for label, app in zip(("jax", "torch"), echo_apps):
        kv = app.container.tpu.kv_pool
        free = kv.stats()["free"]
        status, raw, _ = _post(app, body, {"X-Request-Deadline-Ms": "250"})
        ids, error = _sse_tokens(raw)
        assert status == 200 and error is not None and "deadline" in error
        assert 0 < len(ids) < 60 and ids == full[label][: len(ids)]
        deadline_at = time.time() + 2
        while kv.stats()["free"] != free and time.time() < deadline_at:
            time.sleep(0.01)
        got.append((kv.stats()["free"] == free,
                    _counter(app, "gofr_tpu_deadline_exceeded_total", "stage"),
                    _counter(app, "gofr_tpu_cancellations_total", "cause"),
                    _record_fields(app)[0::3]))
    assert got[0] == got[1] == (True, {("decode",): 1.0}, {("deadline",): 1.0},
                                ("deadline_exceeded", "decode"))


def test_a_client_that_hangs_up_is_cancelled_and_freed(echo_apps):
    got = []
    for app in echo_apps:
        # admission stores a new prompt in the prefix cache by design: warm
        # it first, so the baseline holds that entry
        assert _post(app, {"prompt": [1, 2, 3], "max_tokens": 1})[0] == 200
        kv = app.container.tpu.kv_pool
        free = kv.stats()["free"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{app.http_port}/v1/completions",
            data=json.dumps({"prompt": [1, 2, 3], "max_tokens": 200, "stream": True}).encode(),
            headers={"Content-Type": "application/json"},
        )
        resp = urllib.request.urlopen(req, timeout=30)
        assert resp.read(64)  # the first frames arrived
        resp.close()  # the client walks away mid-stream
        deadline_at = time.time() + 5
        while time.time() < deadline_at and (
            kv.stats()["free"] != free
            or not _counter(app, "gofr_tpu_cancellations_total", "cause")
        ):
            time.sleep(0.02)
        time.sleep(0.1)
        rec = _admin(app, "/admin/requests?limit=1")["requests"][0]
        got.append((kv.stats()["free"] == free,
                    _counter(app, "gofr_tpu_cancellations_total", "cause"),
                    rec["status"], rec["tokens_out"] < 200))
    assert got[0] == got[1] == (True, {("client_abort",): 1.0}, "cancelled", True), got


def test_brownout_sheds_low_priority_and_serves_high_alike(echo_apps):
    """The queue signal pinned through the controller's probe in both apps:
    level 1 sheds below the floor with a 429, Retry-After and the hashed
    tenant; level 2 sheds at the floor and clamps max_tokens; both levels
    show on the gauge and /admin/engine, and a shed is metered on the
    tenant ledger."""
    depth = {"value": 0}
    for app in echo_apps:
        ctl = app.container.tpu.brownout
        ctl.queue_hi = 4
        ctl.clamp_tokens = 3
        ctl.refresh_s = 0.0
        ctl._queue_depth_fn = lambda: depth["value"]
    cases = [(0, "2"), (4, "2"), (4, "5"), (4, "9"), (8, "5"), (8, "6"), (0, "0")]
    got = {0: [], 1: []}
    for i, app in enumerate(echo_apps):
        for d, priority in cases:
            depth["value"] = d
            status, raw, headers = _post(
                app, {"prompt": [1, 2, 3], "max_tokens": 6},
                {"X-Priority": priority, "Authorization": "Bearer k1"},
            )
            body = json.loads(raw)
            tokens = len(body["choices"][0].get("tokens", ())) if status == 200 else None
            got[i].append((status, headers.get("Retry-After"), body.get("error"), tokens,
                           _admin(app, "/admin/engine")["brownout"]["level"],
                           app.container.metrics.gauge("gofr_tpu_brownout_level").value()))
        got[i].append(_admin(app, "/admin/engine")["brownout"])
        got[i].append(_counter(app, "gofr_tpu_brownout_shed_total", "priority"))
        got[i].append(_admin(app, "/admin/tenants")["tenants"][0]["sheds"])
    assert got[1] == got[0]
    statuses = [row[0] for row in got[1][: len(cases)]]
    assert statuses == [200, 429, 200, 200, 429, 200, 200]
    assert got[1][1][1] == "1" and "tenant" in got[1][1][2]
    assert got[1][5][3] == 3  # level 2 clamps max_tokens to BROWNOUT_CLAMP_TOKENS
    assert got[1][-1] == 2


# -- the decode pool on the tiny model (JAX's weights carried over) --------------------

TINY_ENV = {"MODEL_NAME": "tiny", "MODEL_BUCKETS": "32", "DECODE_SLOTS": "2",
            "DECODE_CHUNK": "4", "BATCH_MAX_SIZE": "2", "BATCH_TIMEOUT_MS": "1",
            "PREFIX_CACHE": "2", "WATCHDOG_DISPATCH_TIMEOUT_S": "off"}


def _with_env(env, fn):
    import os

    keys = set(DECLARED_KEYS) | set(JAX_KEYS) | set(env)
    old = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny device (decode pool, paged KV) and the port's on its
    weights; each test leaves both pools idle."""
    import jax

    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level as JaxLevel
    from gofr_tpu.testutil import MockLogger
    from gofr_tpu.tpu.device import new_device
    from gofr_tpu_torch.config import EnvFileConfig
    from gofr_tpu_torch.logging import Level, Logger
    from gofr_tpu_torch.models.convert import transformer_from_tree
    from gofr_tpu_torch.models.llama import TINY
    from gofr_tpu_torch.tpu.device import TPUDevice

    _clear()
    jreg, treg = JaxRegistry(), Registry()

    def jax_build():
        dev = new_device(EnvConfig(), MockLogger(JaxLevel.FATAL), jreg)
        dev.wait_ready(600)
        return dev

    jdev = _with_env(TINY_ENV, jax_build)
    model = transformer_from_tree(jax.tree.map(np.asarray, jdev.runner.params), TINY,
                                  device="cpu")
    tdev = _with_env({**TINY_ENV, "TORCH_DEVICE": "cpu"}, lambda: TPUDevice(
        EnvFileConfig("/nonexistent"), Logger(Level.FATAL), model=model, metrics=treg))
    yield {"jax": (jdev, jreg, jd), "port": (tdev, treg, td)}
    tdev.close()
    jdev.close()


class _AfterCalls:
    """A deadline that expires from its ``n``-th ``expired()`` check on:
    the stages check it at the same points in both packages (the pool once
    a delivered chunk, the solo loop once a fetched chunk), so the expiry
    lands at the same token; ``remaining`` stays ample, so no gate refuses
    it."""

    budget_s = 60.0
    priority = 5

    def __init__(self, n):
        self.n = n
        self.calls = 0

    def remaining(self):
        return 60.0

    def expired(self):
        self.calls += 1
        return self.calls >= self.n


def _expiry(entry, sampler, n_checks):
    dev, registry, mod = entry
    kv = dev.kv_pool
    dev.generate([3, 1, 4, 1, 5], 1)  # the prompt's prefix-cache entry: in the baseline
    free = kv.stats()["free"]
    tokens: list = []
    mod.activate_deadline(_AfterCalls(n_checks))
    try:
        with pytest.raises(Exception) as err:
            dev.generate([3, 1, 4, 1, 5], 40, on_token=tokens.append, sampler=sampler)
    finally:
        mod.activate_deadline(None)
    deadline_at = time.time() + 5
    while kv.stats()["free"] != free and time.time() < deadline_at:
        time.sleep(0.01)
    counters = {
        name: dict(registry.counter(name, labels=(label,)).data())
        for name, label in (("gofr_tpu_deadline_exceeded_total", "stage"),
                            ("gofr_tpu_cancellations_total", "cause"))
    }
    return (type(err.value).__name__, getattr(err.value, "stage", None), tokens,
            kv.stats()["free"] == free, counters)


def test_pool_and_solo_expiry_match_jax(tiny_pair):
    """At the chunk boundary past its deadline a pooled row ends (504,
    stage ``decode``) with the same tokens in both packages and its blocks
    back; a seeded greedy request decodes solo and expires alike."""
    from gofr_tpu.ops.sampling import Sampler as JaxSampler
    from gofr_tpu_torch.ops.sampling import Sampler

    got = _expiry(tiny_pair["port"], None, 6)
    want = _expiry(tiny_pair["jax"], None, 6)
    assert got == want
    assert got[:2] == ("DeadlineExceeded", "decode") and 1 < len(got[2]) < 40 and got[3]
    solo = _expiry(tiny_pair["port"], Sampler(seed=5), 6)
    jsolo = _expiry(tiny_pair["jax"], JaxSampler(seed=5), 6)
    assert solo == jsolo and solo[:2] == ("DeadlineExceeded", "decode")
    assert solo[4]["gofr_tpu_deadline_exceeded_total"] == {("decode",): 2.0}


def test_pool_admission_gate_matches_jax(tiny_pair):
    """The pool's gate while a row decodes at a known cadence: a budget
    under one chunk is refused (504 ``admission``, reject ``deadline``) and
    one over it passes; an idle pool refuses only a spent budget."""
    out = {}
    for label, (dev, registry, mod) in tiny_pair.items():
        pool = dev.decode_pool
        verdicts = []
        with pool._work:
            saved = (pool._chunk_ema_s, dict(pool._active))
            pool._chunk_ema_s = 0.5
            for active in (True, False):
                if active:
                    pool._active[0] = pool._slots[0]
                else:
                    pool._active.clear()
                for budget in (0.1, 0.9, -1.0):
                    deadline = mod.Deadline(budget)
                    try:
                        pool._admit_deadline(deadline)
                        verdicts.append("admitted")
                    except Exception as exc:
                        verdicts.append((type(exc).__name__, exc.stage))
            pool._chunk_ema_s, active_rows = saved
            pool._active.clear()
            pool._active.update(active_rows)
        rejects = registry.counter("gofr_tpu_pool_reject_total", labels=("reason",))
        stages = registry.counter("gofr_tpu_deadline_exceeded_total", labels=("stage",))
        out[label] = (verdicts, rejects.value(reason="deadline"),
                      stages.value(stage="admission"))
    assert out["port"] == out["jax"]
    refused = ("DeadlineExceeded", "admission")
    assert out["port"][0] == [refused, "admitted", refused, "admitted", "admitted", refused]


def test_a_cancelled_pool_row_frees_its_slot_and_blocks(tiny_pair):
    """A stop event set at the first token: the consumer stops at once and
    the pool finishes the row at its next chunk boundary, its slot and its
    blocks back, in both packages."""
    out = {}
    for label, (dev, _, _) in tiny_pair.items():
        kv, pool = dev.kv_pool, dev.decode_pool
        dev.generate([2, 7, 1, 8], 1)  # the prompt's prefix-cache entry: in the baseline
        free = kv.stats()["free"]
        stop = threading.Event()
        ids = dev.generate([2, 7, 1, 8], 60, on_token=lambda _t: stop.set(), stop=stop)
        deadline_at = time.time() + 5
        while (kv.stats()["free"] != free or pool.occupancy()["active"]) and \
                time.time() < deadline_at:
            time.sleep(0.01)
        out[label] = (ids, kv.stats()["free"] == free, pool.occupancy()["active"])
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 1 and out["port"][1:] == (True, 0)


def test_a_dying_pool_stamps_the_journal_entry(tiny_pair):
    """The pool closed under a live row: the generation fails, and its
    journal entry stays interrupted with the pool's cause, in both
    packages; a recovery rebuild serves again."""
    out = {}
    for label, (dev, _, _) in tiny_pair.items():
        seen: list = []

        def close_in_the_pool(token, dev=dev, seen=seen):
            seen.append(token)
            if len(seen) == 2:  # the first token the pool decoded
                dev.decode_pool.close()

        with pytest.raises(Exception) as err:
            dev.generate([9, 9, 2, 3], 60, on_token=close_in_the_pool)
        (entry,) = dev.journal.interrupted()[-1:]
        out[label] = (str(err.value), entry["status"], entry["reason"])
        dev.recover("test rebuild")
        assert dev.generate([1, 2, 3], 4) and dev.engine.state == "serving"
    assert out["port"] == out["jax"]
    assert out["port"][1:] == ("interrupted",
                               "decode pool failed: RuntimeError: decode pool closed "
                               "mid-generation")
