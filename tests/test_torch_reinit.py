"""gofr_tpu_torch's device rebuild on device loss and its probing health
check (``TPUDevice.reinit``, ``_maybe_auto_reinit``, ``health_check``)
against gofr_tpu's (``tests/test_tpu.py::test_reinit_rebuilds_working_stack``,
``::test_auto_reinit_rate_limited``, ``::test_failed_background_boot_recovers``).

- On the tiny model (the JAX runner's weights carried over by
  ``models/convert.py``, the port's device given them as the boot's
  model): a wedged stack rebuilt by ``reinit`` gives the ids it gave
  before, equal to the JAX device's, and health is UP; the automatic
  rebuild's 30 s window returns False in both packages; a background boot
  whose build fails once recovers through the health check with
  ``reinitialized``, in both packages.
- The port's ``reinit`` carries nothing: from ``MODEL_PATH`` (a checkpoint
  of the JAX weights) it loads a new model, and re-seeded it draws one,
  each giving the same ids. A ``recover`` keeps the model object.
- A ``ValueError`` at boot is never rebuilt; a sticky device fault in a
  rebuild is never rebuilt either; a health check while a rebuild runs
  answers at once, UP and not ready; a probe that times out answers DOWN
  without a rebuild, and one that fails rebuilds.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest

import gofr_tpu.telemetry as jt
import gofr_tpu_torch.telemetry as tt
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.metrics import Registry
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.tpu import device as tdevice
from gofr_tpu_torch.training.checkpoint import save_params

TINY_ENV = {"MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "2", "BATCH_TIMEOUT_MS": "1",
            "MODEL_BUCKETS": "64", "DECODE_SLOTS": "2"}
PROMPT = [1, 2, 3]


@pytest.fixture(autouse=True)
def _no_leaked_record():
    for mod in (jt, tt):
        mod.activate_record(None)
    yield
    for mod in (jt, tt):
        mod.activate_record(None)


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


def _jax_device(**env):
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level as JaxLevel
    from gofr_tpu.metrics import Registry as JaxRegistry
    from gofr_tpu.testutil import MockLogger
    from gofr_tpu.tpu.device import new_device

    return _with_env({**TINY_ENV, **env}, lambda: new_device(
        EnvConfig(), MockLogger(JaxLevel.FATAL), JaxRegistry()))


def _port_device(model=None, **env):
    return _with_env({**TINY_ENV, "TORCH_DEVICE": "cpu", **env}, lambda: tdevice.TPUDevice(
        EnvFileConfig("/nonexistent"), Logger(Level.FATAL), model=model, metrics=Registry()))


def _port_weights(jdev):
    return transformer_from_tree(jax.tree.map(np.asarray, jdev.runner.params), TINY,
                                 device="cpu")


@pytest.fixture(scope="module")
def jax_tiny():
    jdev = _jax_device()
    yield jdev
    jdev.close()


def _wedge(dev):
    """Device loss as the reference's test presents it: runner calls fail
    and the batcher is gone."""
    def lost(payloads):
        raise RuntimeError("device lost")

    dev.runner.run_batch = lost
    dev.batcher.close()


def test_reinit_rebuilds_a_working_stack_equal_to_jax(jax_tiny):
    jdev = jax_tiny
    want_before = jdev.generate(PROMPT, max_new_tokens=5)
    tdev = _port_device(model=_port_weights(jdev))
    try:
        before = tdev.generate(PROMPT, max_new_tokens=5)
        assert before == want_before
        _wedge(jdev)
        _wedge(tdev)
        old_runner = tdev.runner
        jdev.reinit()
        tdev.reinit()
        assert tdev.runner is not old_runner and tdev.ready()
        assert jdev.generate(PROMPT, max_new_tokens=5) == want_before
        assert tdev.generate(PROMPT, max_new_tokens=5) == before
        health = tdev.health_check()
        assert jdev.health_check().status == health["status"] == "UP"
        assert health["details"]["probe_ms"] >= 0
        assert tdev.engine.state == "serving" and tdev.boot_status["state"] == "ready"
    finally:
        tdev.close()


def test_auto_reinit_is_rate_limited_as_in_jax(jax_tiny):
    tdev = _port_device(model=_port_weights(jax_tiny))
    try:
        for dev in (jax_tiny, tdev):
            dev._last_reinit = time.monotonic()
            assert dev._maybe_auto_reinit() is False  # within the 30 s window
        assert tdevice.AUTO_REINIT_INTERVAL_S == 30.0
    finally:
        tdev.close()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_failed_background_boot_recovers(jax_tiny, monkeypatch, package):
    """A transient failure in a background boot is not terminal: the health
    check's rate-limited rebuild recovers the stack, answers UP with
    ``reinitialized`` and flips readiness back."""
    calls = {"n": 0}
    if package == "jax":
        import gofr_tpu.tpu.device as jdevice

        target, name = jdevice, "_build_runner"
    else:
        target, name = tdevice.TPUDevice, "_build_stack"
    orig = getattr(target, name)

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient init failure")
        return orig(*a, **k)

    monkeypatch.setattr(target, name, flaky)
    env = {"TPU_BOOT": "background", "DECODE_POOL": "off"}
    dev = (_jax_device(**env) if package == "jax"
           else _port_device(model=_port_weights(jax_tiny), **env))
    try:
        assert dev._ready.wait(30)
        assert not dev.ready() and dev.boot_status["state"] == "failed"
        dev._last_reinit = -1e9  # past the 30 s window
        health = dev.health_check()
        status, details = ((health.status, health.details) if package == "jax"
                           else (health["status"], health["details"]))
        assert status == "UP" and details.get("reinitialized")
        assert dev.ready() and calls["n"] == 2
        assert len(dev.generate(PROMPT, max_new_tokens=3)) == 3
    finally:
        dev.close()


def test_reinit_reloads_from_model_path(jax_tiny, tmp_path):
    """Nothing is carried: a rebuild from MODEL_PATH loads a new model
    object, with the same ids as before and as the JAX device's."""
    want = jax_tiny.generate(PROMPT, max_new_tokens=6)
    save_params(str(tmp_path / "ckpt"), _port_weights(jax_tiny).state_dict())
    tdev = _port_device(MODEL_PATH=str(tmp_path / "ckpt"))
    try:
        old = tdev.runner.model
        assert tdev.generate(PROMPT, max_new_tokens=6) == want
        tdev.reinit()
        assert tdev.runner.model is not old
        assert tdev.generate(PROMPT, max_new_tokens=6) == want
        history = [h["state"] for h in tdev.engine.snapshot()["history"]]
        assert history[-1] == "serving" and "warming" in history[-3:]
    finally:
        tdev.close()


def test_reinit_reseeds_and_recover_carries(monkeypatch):
    """Without MODEL_PATH a rebuild re-seeds as the boot did (a new model,
    the same ids); a recovery keeps the model object and reloads nothing."""
    tdev = _port_device()
    try:
        before = tdev.generate(PROMPT, max_new_tokens=6)
        first = tdev.runner.model
        tdev.reinit()
        assert tdev.runner.model is not first
        assert tdev.generate(PROMPT, max_new_tokens=6) == before
        second = tdev.runner.model

        def no_reload(*a, **k):
            raise AssertionError("a recovery reloaded the weights")

        monkeypatch.setattr(tdevice, "load_model", no_reload)
        tdev.recover("test")
        assert tdev.runner.model is second
        assert tdev.generate(PROMPT, max_new_tokens=6) == before
    finally:
        tdev.close()


def test_a_value_error_boot_is_never_rebuilt(monkeypatch):
    calls = {"n": 0}
    orig = tdevice.TPUDevice._build_stack

    def bad_config(*a, **k):
        calls["n"] += 1
        raise ValueError("MODEL_BUCKETS typo")

    monkeypatch.setattr(tdevice.TPUDevice, "_build_stack", bad_config)
    dev = _port_device(TPU_BOOT="background")
    try:
        assert dev._ready.wait(30)
        assert dev._boot_error_permanent
        dev._last_reinit = -1e9
        for _ in range(2):
            health = dev.health_check()
            assert health["status"] == "DOWN" and health["details"]["boot"]["state"] == "failed"
        assert calls["n"] == 1  # never retried
        monkeypatch.setattr(tdevice.TPUDevice, "_build_stack", orig)
        assert dev._maybe_auto_reinit() is False
    finally:
        dev.close()


def test_a_sticky_device_fault_is_never_rebuilt(jax_tiny):
    """A rebuild whose probe meets a CUDA fault fails with the restart
    verdict and stays DOWN: the health check never retries it."""
    dev = _port_device(model=_port_weights(jax_tiny))
    try:
        def faulted():
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        dev._probe = faulted
        with pytest.raises(tdevice.StickyDeviceFault, match="process restart is needed"):
            dev.reinit()
        assert dev._boot_error_permanent and not dev.ready()
        dev._last_reinit = -1e9
        builds = []
        dev._build_stack = lambda *a, **k: builds.append(1)
        health = dev.health_check()
        assert health["status"] == "DOWN" and builds == []
        assert dev.engine.state == "failed"
    finally:
        dev.close()


def test_a_health_check_during_a_rebuild_answers_at_once(jax_tiny, monkeypatch):
    """The rebuild holds the reinit lock: a concurrent health check neither
    waits for it nor starts another (the lock is taken without blocking);
    it answers UP, not ready, while the rebuild runs."""
    dev = _port_device(model=_port_weights(jax_tiny))
    entered, release = threading.Event(), threading.Event()
    orig = tdevice.TPUDevice._build_stack

    def held(self, *a, **k):
        entered.set()
        release.wait(30)
        return orig(self, *a, **k)

    try:
        monkeypatch.setattr(tdevice.TPUDevice, "_build_stack", held)
        rebuild = threading.Thread(target=dev.reinit)
        rebuild.start()
        assert entered.wait(30)
        start = time.perf_counter()
        health = dev.health_check()
        dev._last_reinit = -1e9
        assert dev._maybe_auto_reinit() is False
        assert time.perf_counter() - start < 1.0
        assert health["status"] == "UP" and health["details"]["boot"]["state"] != "ready"
        release.set()
        rebuild.join(60)
        assert dev.ready() and dev.health_check()["status"] == "UP"
    finally:
        release.set()
        dev.close()


def test_a_probe_timeout_is_down_without_a_rebuild_and_a_failure_rebuilds(jax_tiny):
    dev = _port_device(model=_port_weights(jax_tiny))
    try:
        rebuilds = []
        dev._rebuild = lambda *a, **k: rebuilds.append(a)

        def timed_out():
            raise tdevice.ProbeTimeout("device probe did not return within 2 s")

        dev._liveness_probe = timed_out
        dev._last_reinit = -1e9
        health = dev.health_check()
        assert health["status"] == "DOWN" and "did not return" in health["details"]["error"]
        assert rebuilds == []
        del dev._rebuild
        state = {"n": 0}

        def lost_once():
            state["n"] += 1
            if state["n"] == 1:
                raise RuntimeError("device lost")
            return True

        dev._liveness_probe = lost_once
        health = dev.health_check()
        assert health["status"] == "UP" and health["details"]["reinitialized"] is True
        assert dev.ready() and len(dev.generate(PROMPT, max_new_tokens=2)) == 2
    finally:
        dev.close()


def test_the_cpu_probe_is_a_round_trip(jax_tiny):
    dev = _port_device(model=_port_weights(jax_tiny))
    try:
        assert dev._liveness_probe() is True
        health = dev.health_check()
        assert health["status"] == "UP" and "error" not in health["details"]
    finally:
        dev.close()
    assert dev.health_check()["status"] == "DOWN"
