"""gofr_tpu_torch's ``.env`` loading and ambient-environment config
(``config.py``: ``EnvFileConfig``, ``EnvConfig``, ``new_env_file``,
``environ_snapshot``, the ``Config`` protocol) against gofr_tpu's
(``gofr_tpu/config.py``).

- A key only in ``configs/.env`` reaches ``os.environ`` (the JAX package's
  ``setdefault``), so the port's raw readers (``get_env``, ``env_flag``)
  and a spawned child see it; a set key wins over the file; both packages
  leave the same environment behind.
- ``EnvConfig`` reads the environment with the port's rule (an undeclared
  key raises); ``new_env_file`` builds an ``EnvFileConfig``; both satisfy
  ``Config``.
- ``environ_snapshot`` equals the JAX package's, and the postmortem's
  config fingerprint (which reads through it) equals the JAX package's on
  the same environment, the file's keys included.

Every test restores ``os.environ`` whole afterwards (the loader writes
into it), so nothing leaks to other files on the same worker.
"""

import os
import subprocess
import sys

import pytest

import gofr_tpu.config as jconfig
import gofr_tpu_torch.config as tconfig
from gofr_tpu_torch import postmortem as tpostmortem


@pytest.fixture
def environ(monkeypatch, tmp_path):
    """``os.environ`` as it was, restored whole after the test; every key
    either package declares cleared for it."""
    saved = dict(os.environ)
    for key in set(jconfig.DECLARED_KEYS) | set(tconfig.DECLARED_KEYS):
        os.environ.pop(key, None)
    yield tmp_path
    os.environ.clear()
    os.environ.update(saved)


def _write(tmp_path, text):
    (tmp_path / ".env").write_text(text)
    return str(tmp_path)


def test_a_file_key_reaches_the_environment_as_in_jax(environ):
    configs = _write(environ, "APP_NAME=from-file\nGOFR_POOL_DEBUG=1\nHTTP_PORT='8123'\n")
    config = tconfig.EnvFileConfig(configs)
    assert os.environ["APP_NAME"] == "from-file"
    assert tconfig.get_env("HTTP_PORT") == "8123" and tconfig.env_flag("GOFR_POOL_DEBUG")
    assert config.get("APP_NAME") == "from-file"
    port_env = dict(os.environ)
    for key in ("APP_NAME", "GOFR_POOL_DEBUG", "HTTP_PORT"):
        os.environ.pop(key)
    jconfig.EnvFileConfig(configs)
    assert dict(os.environ) == port_env


def test_an_ambient_key_wins_over_the_file(environ):
    configs = _write(environ, "APP_NAME=from-file\nLOG_LEVEL=DEBUG\n")
    os.environ["APP_NAME"] = "ambient"
    config = tconfig.new_env_file(configs)
    assert isinstance(config, tconfig.EnvFileConfig)
    assert config.get("APP_NAME") == os.environ["APP_NAME"] == "ambient"
    assert config.get("LOG_LEVEL") == "DEBUG"
    jconfig.new_env_file(configs)
    assert os.environ["APP_NAME"] == "ambient"


def test_a_spawned_child_sees_a_file_key(environ):
    configs = _write(environ, "APP_NAME=child-sees-it\n")
    tconfig.EnvFileConfig(configs)
    out = subprocess.run(
        [sys.executable, "-c", "import os; print(os.environ.get('APP_NAME'))"],
        env=tconfig.environ_snapshot(), capture_output=True, text=True, timeout=60,
    )
    assert out.stdout.strip() == "child-sees-it"


def test_env_config_reads_the_environment_with_the_ports_rule(environ):
    os.environ["MODEL_NAME"] = "tiny"
    config = tconfig.EnvConfig()
    assert config.get("MODEL_NAME") == jconfig.EnvConfig().get("MODEL_NAME") == "tiny"
    assert config.get_or_default("MODEL_SEED", "0") == "0"
    os.environ["MODEL_SEED"] = ""
    assert config.get_or_default("MODEL_SEED", "0") == "0"  # empty is unset, as in JAX
    with pytest.raises(KeyError, match="not read"):
        config.get("MODEL_ATTN_IMPL")
    os.environ["COSTMODEL_HLO"] = "1"
    assert config.unhonored() == ["COSTMODEL_HLO"]
    for cfg in (config, tconfig.EnvFileConfig(str(environ))):
        assert isinstance(cfg, tconfig.EnvConfig)
        assert callable(cfg.get) and callable(cfg.get_or_default)


def test_environ_snapshot_and_the_fingerprint_equal_jax(environ):
    from gofr_tpu import postmortem as jpostmortem

    configs = _write(environ, "MODEL_NAME=tiny\nADMIN_TOKEN=hunter2\nAPP_NAME=fp\n")
    tconfig.EnvFileConfig(configs)
    snapshot = tconfig.environ_snapshot()
    assert snapshot == jconfig.environ_snapshot() == dict(os.environ)
    snapshot["APP_NAME"] = "changed"
    assert os.environ["APP_NAME"] == "fp"  # a copy
    got = tpostmortem._config_fingerprint()
    assert got == jpostmortem._config_fingerprint()
    assert got["keys"]["MODEL_NAME"] == "tiny" and got["keys"]["ADMIN_TOKEN"] == "<redacted>"


def test_a_file_key_counts_as_set_for_the_unhonored_check(environ):
    configs = _write(environ, "MODEL_ATTN_IMPL=xla\n")
    config = tconfig.EnvFileConfig(configs)
    assert os.environ["MODEL_ATTN_IMPL"] == "xla"
    assert config.unhonored() == ["MODEL_ATTN_IMPL"]
