"""gofr_tpu_torch's wedge recovery and resumable streams
(``tpu/recovery.py``, the watchdog's quarantine, ``TPUDevice.recover``,
``generate_stream(resume_from=)``) against gofr_tpu's
(``tests/test_recovery.py``).

- Echo devices of both packages wedge on a stalled prefill and walk the
  same states (wedged, recovering, warming, serving), with the same
  incident counts, the postmortem hook called before the quarantine, the
  stalled dispatch quarantined, the interrupted request journalled and a
  fresh request served; with ``RECOVERY_ENABLED=off`` the wedge stays until
  the stall resolves, in both.
- The supervisor's bookkeeping on a scripted device, in both packages:
  bounded attempts with backoff, exhaustion (terminal until a reset), a
  hung rebuild; the readiness body's recovery block.
- Resume: on echo, teacher-forced from a journal entry and replayed without
  one, the same ids as the JAX device's; the refusals. On the tiny model
  (the JAX runner's weights carried over by ``models/convert.py``), the
  teacher-forced resume and the replayed resume give ids equal to the JAX
  package's exactly; a seeded sampled request resumes by replay, equal to
  its own uninterrupted run (the two packages' random streams differ).
- The port's own rules: a rebuild keeps the model object and its tensors'
  storage (never a reload); a device whose re-probe raises a CUDA error
  runs out its attempts into ``failed``, the detail naming the error and a
  process restart; a pool launch blocked behind a stuck card is watched,
  so it wedges and recovers.

Every test clears both packages' journal, record and deadline
contextvars.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest

import gofr_tpu.deadline as jd
import gofr_tpu.telemetry as jt
import gofr_tpu.tpu.introspect as ji
import gofr_tpu.tpu.recovery as jr
import gofr_tpu_torch.deadline as td
import gofr_tpu_torch.telemetry as tt
import gofr_tpu_torch.tpu.introspect as ti
import gofr_tpu_torch.tpu.recovery as tr
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.errors import InvalidParamError
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.metrics import Registry
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.ops.sampling import Sampler

PROMPT = [5, 6, 7]


def _clear():
    for mod in (jt, tt):
        mod.activate_journal_entry(None)
        mod.activate_record(None)
    for mod in (jd, td):
        mod.activate_deadline(None)
        mod.activate_priority(None)


@pytest.fixture(autouse=True)
def _no_leaked_contextvars():
    _clear()
    yield
    _clear()


def _with_env(env, fn):
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


def _device(package, registry=None, model=None, **env):
    cfg = {"MODEL_NAME": "echo", "WATCHDOG_DISPATCH_TIMEOUT_S": "0.1",
           "RECOVERY_BACKOFF_S": "0.05", **env}
    if package == "jax":
        from gofr_tpu.config import EnvConfig
        from gofr_tpu.logging import Level as JaxLevel
        from gofr_tpu.metrics import Registry as JaxRegistry
        from gofr_tpu.testutil import MockLogger
        from gofr_tpu.tpu.device import new_device

        def build():
            dev = new_device(EnvConfig(), MockLogger(JaxLevel.FATAL), registry or JaxRegistry())
            dev.wait_ready(600)
            return dev

        return _with_env(cfg, build)
    from gofr_tpu_torch.tpu.device import TPUDevice

    cfg.setdefault("TORCH_DEVICE", "cpu")
    return _with_env(cfg, lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(Level.FATAL),
                                            model=model, metrics=registry or Registry()))


def _wait(cond, timeout=15.0, message="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {message}")
        time.sleep(0.02)


def _wedge(device, release):
    """A latch stall in the echo prefill, and a request kicked into it."""
    device.runner.stall_hook = lambda: release.wait(30)

    def kick():
        try:
            device.generate([9], max_new_tokens=2)
        except Exception:
            pass  # the wedged request fails by design

    thread = threading.Thread(target=kick, name="test-wedge-kick")
    thread.start()
    return thread


def _incident(package):
    device = _device(package)
    try:
        evidence: list = []
        device.recovery.postmortem = lambda detail: evidence.append(device.watchdog.snapshot())
        release = threading.Event()
        kicker = _wedge(device, release)
        _wait(lambda: device.engine.state == "serving"
              and device.recovery.snapshot()["recoveries"].get("recovered"), message="recovery")
        release.set()
        kicker.join(10)
        snap = device.recovery.snapshot()
        states = [h["state"] for h in device.engine.snapshot()["history"]]
        watchdog = device.watchdog.snapshot()
        return {
            "walk": states[states.index("wedged"):],
            "recoveries": snap["recoveries"],
            "outcome": (snap["state"], snap["last_outcome"], snap["attempts"],
                        snap["incidents"]),
            "mttr": snap["last_mttr_s"] is not None,
            "hook_saw_stall": bool(evidence) and any(w["stalled"]
                                                     for w in evidence[0]["watching"]),
            "watching": watchdog["watching"],
            "quarantined": [q["kind"] for q in watchdog["quarantined"]],
            "fresh": device.generate(PROMPT, max_new_tokens=6),
            "journal": device.engine_snapshot()["journal"]["interruptions"] >= 1,
            "keys": sorted(device.engine_snapshot()["recovery"]),
        }
    finally:
        device.close()


def test_a_wedge_recovers_to_serving_as_in_jax():
    got, want = _incident("port"), _incident("jax")
    assert got == want
    assert got["walk"] == ["wedged", "recovering", "warming", "serving"]
    assert got["recoveries"] == {"recovered": 1} and got["quarantined"] == ["prefill"]
    assert got["fresh"] == [5, 6, 7, 5, 6, 7] and got["hook_saw_stall"]


def test_recovery_off_keeps_the_wedge_until_the_stall_resolves():
    walks = {}
    for package in ("port", "jax"):
        device = _device(package, RECOVERY_ENABLED="off")
        try:
            release = threading.Event()
            kicker = _wedge(device, release)
            _wait(lambda: device.engine.state == "wedged", message="wedge")
            time.sleep(0.2)  # no rebuild starts
            assert device.engine.state == "wedged"
            assert device.recovery.snapshot()["recoveries"] == {}
            release.set()
            kicker.join(10)
            _wait(lambda: device.engine.state == "serving", message="the stall resolving")
            walks[package] = [h["state"] for h in device.engine.snapshot()["history"]][-3:]
            if package == "port":
                on_stall = device.engine_snapshot()["watchdog"]["on_stall"]
                assert on_stall.startswith("observe-only")
        finally:
            device.close()
    assert walks["port"] == walks["jax"] == ["degraded", "wedged", "serving"]


class _FakeDevice:
    """Engine and watchdog real; ``recover`` scripted."""

    def __init__(self, mod, fail_times=0, hang_s=0.0):
        self.engine = mod.EngineState()
        self.watchdog = mod.StallWatchdog(self.engine)
        self._closed = False
        self.fail_times = fail_times
        self.hang_s = hang_s
        self.calls = 0

    def recover(self, detail=""):
        self.calls += 1
        if self.hang_s:
            time.sleep(self.hang_s)
        if self.calls <= self.fail_times:
            raise RuntimeError(f"rebuild {self.calls} failed")
        self.engine.transition("serving", detail)


def _supervised(intro, rec, fail_times=0, hang_s=0.0, **kw):
    device = _FakeDevice(intro, fail_times, hang_s)
    supervisor = rec.RecoverySupervisor(device, **kw)
    device.engine.transition("serving")
    device.engine.transition("wedged", "test")
    return device, supervisor


def _strip(snap):
    return {k: v for k, v in snap.items() if k not in ("last_mttr_s", "backoff_in_s")}


PACKAGES = {"port": (ti, tr), "jax": (ji, jr)}


def _attempts_then_recovered(pkg):
    device, sup = _supervised(*PACKAGES[pkg], fail_times=2, max_attempts=3, backoff_s=0.02,
                              backoff_max_s=0.05)
    _wait(lambda: sup.snapshot()["state"] == "idle"
          and sup.snapshot()["recoveries"].get("recovered") == 1, message="third attempt")
    sup.close()
    return device.calls, _strip(sup.snapshot())


def test_bounded_attempts_with_backoff_match_jax():
    got, want = _attempts_then_recovered("port"), _attempts_then_recovered("jax")
    assert got == want
    assert got[0] == 3 and got[1]["recoveries"] == {"failed_attempt": 2, "recovered": 1}


def _exhausted_then_reset(pkg):
    device, sup = _supervised(*PACKAGES[pkg], fail_times=99, max_attempts=2, backoff_s=0.02,
                              backoff_max_s=0.05)
    _wait(lambda: sup.snapshot()["state"] == "exhausted", message="exhaustion")
    out = [device.engine.state, device.calls, _strip(sup.snapshot()),
           device.engine.snapshot()["detail"]]
    device.engine.transition("wedged", "again")  # terminal: no new incident
    time.sleep(0.1)
    out.append(device.calls)
    sup.reset()
    device.engine.transition("serving")
    device.fail_times = 0
    device.engine.transition("wedged", "after reset")
    _wait(lambda: sup.snapshot()["recoveries"].get("recovered") == 1, message="post-reset")
    sup.close()
    out.append(_strip(sup.snapshot()))
    return out


def test_exhaustion_is_terminal_until_a_reset_as_in_jax():
    got, want = _exhausted_then_reset("port"), _exhausted_then_reset("jax")
    assert got == want
    assert got[0] == "failed" and got[1] == got[4] == 2
    assert got[3].startswith("recovery exhausted after 2 attempt(s)")


def test_a_hung_rebuild_is_terminal_as_in_jax():
    out = {}
    for pkg, (intro, rec) in PACKAGES.items():
        device, sup = _supervised(intro, rec, hang_s=0.2, max_attempts=3, backoff_s=0.01,
                                  attempt_timeout_s=0.05)
        _wait(lambda: sup.snapshot()["state"] == "hung", message="hang")
        out[pkg] = (device.engine.state, device.engine.snapshot()["detail"],
                    _strip(sup.snapshot()))
        sup.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == "failed" and tr.HUNG_DETAIL == jr.HUNG_DETAIL == out["port"][1]


def test_watchdog_quarantine_matches_jax():
    out = {}
    for pkg, (intro, _) in PACKAGES.items():
        engine = intro.EngineState()
        watchdog = intro.StallWatchdog(engine, timeout_s=0.05)
        engine.transition("serving")
        release = threading.Event()

        def stuck(watchdog=watchdog, release=release):
            with watchdog.watch("decode_chunk", 7):
                release.wait(10)

        thread = threading.Thread(target=stuck, name="test-stuck")
        thread.start()
        _wait(lambda: engine.state == "degraded", message="stall flag")
        quarantined = [(q["kind"], q["dispatch_id"]) for q in watchdog.quarantine()]
        watching = watchdog.snapshot()["watching"]
        engine.transition("serving", "rebuilt")
        release.set()
        thread.join(5)
        out[pkg] = (quarantined, watching, engine.state,
                    [q["dispatch_id"] for q in watchdog.snapshot()["quarantined"]])
        watchdog.close()
    assert out["port"] == out["jax"] == ([("decode_chunk", 7)], [], "serving", [7])


def test_the_ready_body_carries_recovery_evidence_as_in_jax():
    from gofr_tpu.handler import _attach_recovery_evidence as jax_attach
    from gofr_tpu_torch.handler import _attach_recovery_evidence

    out = {}
    for pkg, attach in (("port", _attach_recovery_evidence), ("jax", jax_attach)):
        intro, rec = PACKAGES[pkg]
        device = _FakeDevice(intro, fail_times=99)
        device.recovery = rec.RecoverySupervisor(device, max_attempts=2, backoff_s=5.0,
                                                 backoff_max_s=5.0)
        before: dict = {}
        attach(device, before)
        device.engine.transition("serving")
        device.engine.transition("wedged", "test")
        _wait(lambda: device.recovery.snapshot()["state"] == "waiting_backoff",
              message="backoff")
        after: dict = {}
        attach(device, after)
        after["recovery"]["backoff_in_s"] = after["recovery"]["backoff_in_s"] > 0
        out[pkg] = (before, after)
        device.recovery.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == {}
    assert out["port"][1]["recovery"] == {"state": "waiting_backoff", "attempts": 1,
                                          "max_attempts": 2, "backoff_in_s": True,
                                          "last_outcome": "failed_attempt"}


# -- resume on echo ---------------------------------------------------------------

def _echo_resumes(package):
    registry = Registry() if package == "port" else None
    if registry is None:
        from gofr_tpu.metrics import Registry as JaxRegistry

        registry = JaxRegistry()
    device = _device(package, registry, ECHO_STEP_MS="1", WATCHDOG_DISPATCH_TIMEOUT_S="off")
    try:
        full = device.generate(PROMPT, max_new_tokens=12)
        key = device._journal_key(PROMPT, 12, None, device.default_stop_ids, None)
        entry = device.journal.start(key, "echo", 12, seeded=False, deterministic=True)
        for token in full[:7]:
            entry.append(token)
        device.journal.interrupt(entry, "injected wedge")
        forced = list(device.generate_stream(PROMPT, max_new_tokens=12, resume_from=5))
        replayed = list(device.generate_stream(PROMPT, max_new_tokens=12, resume_from=4))
        seeded = list(device.generate_stream(
            PROMPT, 8, sampler=(Sampler if package == "port" else _jax_sampler())(
                temperature=0.9, seed=3), resume_from=2))
        # a clean finish and a client walking away leave nothing interrupted
        device.generate(PROMPT, max_new_tokens=4)
        it = device.generate_stream(PROMPT, max_new_tokens=8)
        next(it)
        it.close()
        _wait(lambda: device.journal.stats()["active"] == 0, message="the stream settling")
        modes = registry.counter("gofr_tpu_journal_resumes_total", labels=("mode",)).data()
        return full, forced, replayed, seeded, dict(modes), device.journal.stats()["interrupted"]
    finally:
        device.close()


def _jax_sampler():
    from gofr_tpu.ops.sampling import Sampler as JaxSampler

    return JaxSampler


def test_echo_resumes_match_jax():
    got, want = _echo_resumes("port"), _echo_resumes("jax")
    assert got == want
    full, forced, replayed, seeded, modes, interrupted = got
    assert full[:5] + forced == full and full[:4] + replayed == full
    assert len(seeded) == 6
    assert modes == {("teacher_forced",): 1.0, ("replayed",): 2.0} and interrupted == 0


def test_resume_refuses_what_cannot_be_reproduced():
    device = _device("port", WATCHDOG_DISPATCH_TIMEOUT_S="off")
    try:
        with pytest.raises(InvalidParamError, match="deterministic"):
            device.generate_stream(PROMPT, 8, sampler=Sampler(temperature=0.9), resume_from=2)
        with pytest.raises(InvalidParamError, match="logprobs"):
            device.generate_stream(PROMPT, 8, logprobs=True, resume_from=2)
        with pytest.raises(InvalidParamError, match=">= 0"):
            device.generate_stream(PROMPT, 8, resume_from=-1)
    finally:
        device.close()


# -- resume on the tiny model --------------------------------------------------------

TINY_ENV = {"MODEL_NAME": "tiny", "MODEL_BUCKETS": "64", "DECODE_SLOTS": "2",
            "PREFIX_CACHE": "2", "BATCH_MAX_SIZE": "2", "BATCH_TIMEOUT_MS": "1",
            "WATCHDOG_DISPATCH_TIMEOUT_S": "off"}


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny device and the port's on its weights."""
    _clear()
    jdev = _device("jax", **TINY_ENV)
    model = transformer_from_tree(jax.tree.map(np.asarray, jdev.runner.params), TINY,
                                  device="cpu")
    tdev = _device("port", model=model, **TINY_ENV)
    yield jdev, tdev
    tdev.close()
    jdev.close()


def _teacher_forced(device, prompt):
    full = device.generate(prompt, max_new_tokens=10)
    key = device._journal_key(prompt, 10, None, device.default_stop_ids, None)
    entry = device.journal.start(key, "tiny", 10, seeded=False, deterministic=True,
                                 prior=full[:6])
    device.journal.interrupt(entry, "injected wedge")
    resumed = list(device.generate_stream(prompt, max_new_tokens=10, resume_from=4))
    replayed = list(device.generate_stream(prompt, max_new_tokens=10, resume_from=3))
    return full, resumed, replayed


def test_tiny_model_resumes_equal_jax(tiny_pair):
    """Teacher-forced (a prefill over prompt + the journalled ids, then
    pooled decode) and replayed (no entry left: regenerate, suppress):
    the port's ids equal the JAX device's exactly."""
    jdev, tdev = tiny_pair
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    got, want = _teacher_forced(tdev, prompt), _teacher_forced(jdev, prompt)
    assert got == want
    full, resumed, replayed = got
    assert len(full) == 10 and full[:4] + resumed == full and full[:3] + replayed == full


def test_tiny_model_seeded_sampled_resume_replays_its_own_run(tiny_pair):
    """A seeded sampled request cannot teacher-force (its draws are laid
    out from the first decode step): it resumes by replay, bit-identical to
    its own uninterrupted run in each package."""
    jdev, tdev = tiny_pair
    prompt = [2, 7, 1, 8, 2, 8]
    for dev, sampler in ((tdev, Sampler), (jdev, _jax_sampler())):
        full = dev.generate(prompt, max_new_tokens=8, sampler=sampler(temperature=0.8, seed=11))
        resumed = list(dev.generate_stream(prompt, max_new_tokens=8,
                                           sampler=sampler(temperature=0.8, seed=11),
                                           resume_from=3))
        assert full[:3] + resumed == full


def test_a_rebuild_keeps_the_weights(tiny_pair, monkeypatch):
    """``recover`` tears the stack down and rebuilds it over the SAME model
    object and tensors: nothing is reloaded or redrawn (the loader would
    raise), and the greedy ids are unchanged."""
    import gofr_tpu_torch.tpu.device as tdevice

    _, tdev = tiny_pair
    model = tdev.runner.model
    ptrs = [p.data_ptr() for p in model.parameters()]
    before = tdev.generate([4, 4, 2], max_new_tokens=6)
    old_pool = tdev.decode_pool

    def no_reload(*args, **kwargs):
        raise AssertionError("a rebuild reloaded the weights")

    monkeypatch.setattr(tdevice, "load_model", no_reload)
    tdev.recover("test rebuild")
    assert tdev.runner.model is model
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    assert tdev.decode_pool is not old_pool and tdev.engine.state == "serving"
    assert tdev.generate([4, 4, 2], max_new_tokens=6) == before
    states = [h["state"] for h in tdev.engine.snapshot()["history"]][-2:]
    assert states == ["warming", "serving"]


def test_a_sticky_device_fault_fails_with_a_restart_verdict():
    """A re-probe that raises a CUDA error (what every CUDA call does after
    error 719) fails each attempt; the engine ends ``failed``, its detail
    naming the error and a process restart."""
    device = _device("port", RECOVERY_MAX_ATTEMPTS="2", RECOVERY_BACKOFF_S="0.01")
    try:
        def faulted_probe():
            raise RuntimeError("CUDA error: unspecified launch failure")

        device._probe = faulted_probe
        release = threading.Event()
        kicker = _wedge(device, release)
        _wait(lambda: device.recovery.snapshot()["state"] == "exhausted", message="exhaustion")
        release.set()
        kicker.join(10)
        detail = device.engine.snapshot()["detail"]
        assert device.engine.state == "failed"
        assert "CUDA error: unspecified launch failure" in detail
        assert "process restart is needed" in detail
        assert device.recovery.snapshot()["recoveries"] == {"failed_attempt": 2, "exhausted": 1}
        assert not device.ready() and device.boot_status["state"] == "failed"
    finally:
        device.close()


def test_a_launch_blocked_behind_a_stuck_card_is_a_wedge(tiny_pair):
    """On a card the pool's launches block once a stuck kernel fills the
    CUDA launch queue, before any wait: the dispatch runs under the
    watchdog too, so the engine wedges and recovers (a launch held here by
    a sleep in the pool's chunk, on the CPU)."""
    jdev, _ = tiny_pair
    model = transformer_from_tree(jax.tree.map(np.asarray, jdev.runner.params), TINY,
                                  device="cpu")
    dev = _device("port", model=model, **{**TINY_ENV, "WATCHDOG_DISPATCH_TIMEOUT_S": "0.1",
                                          "RECOVERY_BACKOFF_S": "0.05"})
    try:
        pool = dev.decode_pool
        run = pool._run_executable
        release = threading.Event()

        def blocked():  # held until the recovery began, as a full launch queue holds
            vars(pool).pop("_run_executable")
            release.wait(30)
            return run()

        pool._run_executable = blocked
        before = len(dev.engine.snapshot()["history"])
        def release_once_recovering():
            try:
                _wait(lambda: dev.recovery.snapshot()["incidents"], message="the incident")
            finally:
                release.set()

        watcher = threading.Thread(target=release_once_recovering)
        watcher.start()
        with pytest.raises(Exception, match="decode pool"):
            dev.generate([3, 1, 4, 1, 5], 20)
        watcher.join(30)
        release.set()
        _wait(lambda: dev.engine.state == "serving"
              and dev.recovery.snapshot()["recoveries"].get("recovered"), message="recovery")
        walk = [h["state"] for h in dev.engine.snapshot()["history"][before:]]
        assert walk == ["degraded", "wedged", "recovering", "warming", "serving"]
        assert [q["kind"] for q in dev.watchdog.snapshot()["quarantined"]] == ["decode_chunk"]
        assert dev.decode_pool is not pool and dev.runner.model is model
        assert dev.generate([3, 1, 4, 1, 5], 6) == jdev.generate([3, 1, 4, 1, 5], 6)
    finally:
        dev.close()
