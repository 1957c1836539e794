"""The multi-host runtime (``gofr_tpu_torch/parallel/multihost.py``)
without a cluster: two real processes join a process group over gloo on
localhost and run the reference worker's assertions
(``tests/test_multihost.py:23-41``); one process is a no-op without
``TPU_COORDINATOR``; ``process_info()`` equals the JAX package's in one
process under the 8 virtual devices; and a ``TORCH_DEVICE=cpu`` boot of
the tiny model with the three keys at world size 1 joins, serves a
request, and leaves the group at shutdown."""

import http.client
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

import gofr_tpu_torch
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["TORCH_DEVICE"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)  # one device per process
    sys.path.insert(0, "@@REPO@@")

    from gofr_tpu_torch.config import EnvFileConfig
    from gofr_tpu_torch.parallel import multihost

    cfg = EnvFileConfig()
    assert multihost.init_from_config(cfg) is True
    assert multihost.init_from_config(cfg) is True  # idempotent
    info = multihost.process_info()
    assert info["process_count"] == 2, info
    assert info["global_devices"] == 2 * info["local_devices"], info
    total = multihost.global_psum_check()
    assert total == info["global_devices"], (total, info)
    print(f"rank {info['process_id']} OK total={total}", flush=True)
    multihost.shutdown()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def clean_env(monkeypatch):
    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


def test_two_process_runtime_and_collective(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER.replace("@@REPO@@", REPO))
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in DECLARED_KEYS}
        env.update(TPU_COORDINATOR=f"127.0.0.1:{port}", TPU_NUM_PROCESSES="2",
                   TPU_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, cwd=tmp_path,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outputs.append(out)
    finally:
        # a rank that died before the join leaves its peer waiting in
        # init_process_group: never leak it
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank} OK total=2.0" in out, out


def test_single_host_is_noop(clean_env, tmp_path):
    assert multihost.init_from_config(EnvFileConfig(str(tmp_path))) is False
    assert multihost.global_psum_check() is None


def test_process_info_is_the_jax_package_s_in_one_process():
    from gofr_tpu.parallel import multihost as jax_multihost

    assert multihost.process_info() == jax_multihost.process_info()
    assert multihost.process_info()["local_devices"] == 8


def _post(port: int, body: dict) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_a_boot_with_the_three_keys_joins_serves_and_leaves(clean_env, tmp_path):
    import torch.distributed as dist

    for key, value in {"TORCH_DEVICE": "cpu", "MODEL_NAME": "tiny", "TOKENIZER": "byte",
                       "LOG_LEVEL": "FATAL", "HTTP_PORT": str(_free_port()),
                       "TPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
                       "TPU_NUM_PROCESSES": "1", "TPU_PROCESS_ID": "0"}.items():
        clean_env.setenv(key, value)
    app = gofr_tpu_torch.new(str(tmp_path))
    try:
        gofr_tpu_torch.register_openai_routes(app)
        app.start()
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        # the CPU's devices: the 8 virtual ones of conftest's XLA_FLAGS
        assert multihost.process_info() == {"process_id": 0, "process_count": 1,
                                            "local_devices": 8, "global_devices": 8}
        assert multihost.global_psum_check() is None
        status, body = _post(app.http_port, {"prompt": "multihost", "max_tokens": 4,
                                             "temperature": 0})
        assert status == 200, body
        assert body["usage"]["completion_tokens"] == 4
        stages = [s["stage"] for s in app.container.tpu.boot_timeline]
        assert "joining multi-host runtime" in stages, stages
    finally:
        app.shutdown()
    assert not dist.is_initialized()
