"""gofr_tpu_torch's configuration against gofr_tpu's: the port's declared
keys and its list of the reference's unhonored keys partition the JAX
package's DECLARED_KEYS; each listed key, set in the environment or in
``configs/.env``, refuses the boot (naming the key) or warns once; the
keys of the overload and failure layer are declared, read, and neither
refuse nor warn (the journal's keys boot); and LOG_LEVEL, HANDLER_THREADS
and TPU_ENABLED are honored as the JAX container honors them."""

import io
import json
import sys

import pytest

import gofr_tpu_torch
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu.config import parse_env_file as jax_parse_env_file
from gofr_tpu_torch.config import (
    DECLARED_KEYS,
    UNHONORED_KEYS,
    EnvFileConfig,
    check_unhonored,
    parse_env_file,
)
from gofr_tpu_torch.container import Container
from gofr_tpu_torch.logging import Level, Logger

# at least these refuse (ignoring them changes the topology, a durability
# guarantee or the memory the process takes)
MUST_REFUSE = {"TPU_MESH", "TPU_TOPOLOGY", "TPU_COORDINATOR", "TPU_NUM_PROCESSES",
               "TPU_PROCESS_ID", "KV_HBM_BUDGET_MB", "FLEET_ROLE"}

# the keys the overload and failure layer honors: deadlines, priorities and
# brownout, the timebase and postmortems, the SLO engine, recovery, and the
# journal with its WAL
FAILURE_KEYS = (
    "REQUEST_DEADLINE_S", "PRIORITY_DEFAULT", "BROWNOUT_QUEUE_DEPTH", "BROWNOUT_KV_UTIL",
    "BROWNOUT_SHED_PRIORITY", "BROWNOUT_CLAMP_TOKENS", "TIMEBASE_ENABLED",
    "TIMEBASE_INTERVAL_S", "TIMEBASE_WINDOW_S", "POSTMORTEM_DIR", "POSTMORTEM_KEEP",
    "POSTMORTEM_MIN_INTERVAL_S", "POSTMORTEM_SNAPSHOTS", "SLO", "SLO_TARGETS",
    "SLO_BURN_FAST_S", "SLO_BURN_FAST_LONG_S", "SLO_BURN_FAST_RATE", "SLO_BURN_SLOW_S",
    "SLO_BURN_SLOW_LONG_S", "SLO_BURN_SLOW_RATE", "SLO_EVAL_INTERVAL_S", "RECOVERY_ENABLED",
    "RECOVERY_MAX_ATTEMPTS", "RECOVERY_BACKOFF_S", "RECOVERY_BACKOFF_MAX_S",
    "RECOVERY_ATTEMPT_TIMEOUT_S", "JOURNAL", "JOURNAL_CAPACITY", "JOURNAL_MAX_TOKENS",
    "JOURNAL_DIR", "JOURNAL_FSYNC", "JOURNAL_SEGMENT_BYTES", "JOURNAL_SEGMENTS",
)


@pytest.fixture
def clean_env(monkeypatch):
    """No key of either package's set leaks in from the process."""
    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


def test_the_port_partitions_the_jax_keys():
    port_declared = set(DECLARED_KEYS) & set(JAX_KEYS)
    assert not set(DECLARED_KEYS) & set(UNHONORED_KEYS)
    assert port_declared | set(UNHONORED_KEYS) == set(JAX_KEYS)
    assert set(UNHONORED_KEYS) <= set(JAX_KEYS)
    assert MUST_REFUSE <= {k for k, (refuse, _) in UNHONORED_KEYS.items() if refuse}
    # every entry names the ROADMAP item that ports it
    assert all(why.startswith("§") for _, why in UNHONORED_KEYS.values())
    # the 11 keys this slice honors
    assert {"APP_NAME", "LOG_LEVEL", "HANDLER_THREADS", "TPU_ENABLED", "TPU_BOOT",
            "ECHO_STEP_MS", "SPEC_FAKE_ACCEPT", "METRICS_MAX_SERIES", "METRICS_EXEMPLARS",
            "TRACER_HOST", "TRACER_PORT"} <= port_declared


@pytest.mark.parametrize("key", FAILURE_KEYS)
def test_a_failure_layer_key_is_declared_and_silent(key, clean_env, tmp_path):
    """Each key this layer honors is one of the JAX package's, declared,
    read from the environment, and neither refuses nor warns at boot."""
    assert key in JAX_KEYS and key in DECLARED_KEYS and key not in UNHONORED_KEYS
    clean_env.setenv(key, "7")
    config = EnvFileConfig(str(tmp_path))
    assert config.get(key) == "7"
    out = io.StringIO()
    saved, sys.stdout = sys.stdout, out
    try:
        check_unhonored(config, Logger(Level.INFO, terminal=False))
    finally:
        sys.stdout = saved
    assert _warnings(out.getvalue()) == []


def test_the_journal_keys_boot(clean_env, tmp_path):
    """JOURNAL, JOURNAL_DIR and JOURNAL_FSYNC no longer refuse the boot: an
    echo app boots with its journal on a WAL in the directory."""
    clean_env.setenv("MODEL_NAME", "echo")
    clean_env.setenv("JOURNAL", "on")
    clean_env.setenv("JOURNAL_DIR", str(tmp_path / "wal"))
    clean_env.setenv("JOURNAL_FSYNC", "always")
    clean_env.setenv("LOG_LEVEL", "FATAL")
    c = Container(EnvFileConfig(str(tmp_path)))
    try:
        assert c.tpu.journal_wal is not None and c.tpu.journal_wal.fsync_policy == "always"
        assert c.tpu.journal.stats()["wal"]["dir"] == str(tmp_path / "wal")
    finally:
        c.close()


def _warnings(logger_out: str) -> list:
    return [json.loads(x)["message"] for x in logger_out.splitlines()
            if json.loads(x)["level"] == "WARN"]


@pytest.mark.parametrize("key", sorted(UNHONORED_KEYS))
def test_a_set_unhonored_key_refuses_or_warns(key, clean_env, tmp_path):
    refuse, why = UNHONORED_KEYS[key]
    clean_env.setenv(key, "1")
    config = EnvFileConfig(str(tmp_path))
    out = io.StringIO()
    saved, sys.stdout = sys.stdout, out
    try:
        if refuse:
            with pytest.raises(ValueError, match=key) as info:
                check_unhonored(config, Logger(Level.INFO, terminal=False))
            assert why in str(info.value)
        else:
            check_unhonored(config, Logger(Level.INFO, terminal=False))
    finally:
        sys.stdout = saved
    if not refuse:
        assert _warnings(out.getvalue()) == [
            f"{key} is set but gofr_tpu_torch does not honor it yet (ROADMAP {why})"
        ]


def test_the_env_file_counts_and_each_key_warns_once(clean_env, tmp_path):
    (tmp_path / ".env").write_text("GRPC_PORT=9000\nFLEET_ROUTES=a\n")
    clean_env.setenv("FLEET_ROUTES", "b")  # in both: one warning
    clean_env.setenv("FLEET_RETRIES", "")  # empty is unset
    out = io.StringIO()
    saved, sys.stdout = sys.stdout, out
    try:
        check_unhonored(EnvFileConfig(str(tmp_path)), Logger(Level.INFO, terminal=False))
    finally:
        sys.stdout = saved
    assert [w.split()[0] for w in _warnings(out.getvalue())] == ["GRPC_PORT", "FLEET_ROUTES"]
    (tmp_path / ".env").write_text("KV_HBM_BUDGET_MB=512\n")
    with pytest.raises(ValueError, match="KV_HBM_BUDGET_MB"):
        gofr_tpu_torch.new(str(tmp_path))


def test_a_refused_key_stops_the_app_before_the_device(clean_env, tmp_path):
    clean_env.setenv("MODEL_NAME", "tiny")
    clean_env.setenv("TORCH_DEVICE", "cpu")
    clean_env.setenv("TPU_MESH", "tp=2")
    with pytest.raises(ValueError, match="TPU_MESH"):
        gofr_tpu_torch.new(str(tmp_path))


def test_undeclared_keys_still_raise(tmp_path):
    with pytest.raises(KeyError):
        EnvFileConfig(str(tmp_path)).get("TPU_MESH")


def test_parse_env_file_matches_jax(tmp_path):
    p = tmp_path / ".env"
    p.write_text('# c\nAPP_NAME=a\nexport HTTP_PORT=8001\nQ="x y"\nS=\'s\'\n'
                 'I=value # trailing\nE=\nNOEQ\n')
    assert parse_env_file(str(p)) == jax_parse_env_file(str(p))


@pytest.mark.parametrize("name", ["DEBUG", "WARN", "ERROR", "bogus"])
def test_log_level_is_honored(name, clean_env, tmp_path):
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.container import Container as JaxContainer

    clean_env.setenv("LOG_LEVEL", name)
    port = Container(EnvFileConfig(str(tmp_path)))
    jax = JaxContainer(EnvConfig(), wire=False)
    assert port.logger.level.name == jax.logger.level.name
    jax.close()


def test_handler_threads_is_honored(clean_env, tmp_path):
    clean_env.setenv("HANDLER_THREADS", "3")
    c = Container(EnvFileConfig(str(tmp_path)))
    assert c.handler_executor._max_workers == 3
    c.close()
    clean_env.delenv("HANDLER_THREADS")
    c = Container(EnvFileConfig(str(tmp_path)))
    assert c.handler_executor._max_workers == 64
    c.close()


def test_tpu_enabled_builds_the_default_device(clean_env, tmp_path):
    """TPU_ENABLED without MODEL_NAME: the device, serving mlp (JAX's
    container wiring); neither set: no device and health UP with no
    details."""
    c = Container(EnvFileConfig(str(tmp_path)))
    assert c.tpu is None and c.health() == {"status": "UP", "details": {}}
    clean_env.setenv("TPU_ENABLED", "true")
    clean_env.setenv("TORCH_DEVICE", "cpu")
    c = Container(EnvFileConfig(str(tmp_path)))
    try:
        assert c.tpu is not None and c.tpu.model_name == "mlp" and c.tpu.ready()
        assert c.health()["status"] == "UP"
    finally:
        c.close()
