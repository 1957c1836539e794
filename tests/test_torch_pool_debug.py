"""``GOFR_POOL_DEBUG=1`` on the port's decode pool against the JAX pool's:
one stderr line a fetched chunk, in the JAX pool's format (``[pool] chunk
active=N dispatch->fetch Xms fetch-wait Yms deliver Zms``), as many lines
as the pool dispatched chunks, each naming that chunk's riders; nothing
without the flag. The flag is read when the module is imported, as in the
JAX package.
"""

import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import gofr_tpu.tpu.decode_pool as jax_decode_pool
from gofr_tpu.testutil import serving_device
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.tpu import decode_pool
from gofr_tpu_torch.tpu.device import TPUDevice

REPO = Path(__file__).resolve().parents[1]
LINE = re.compile(r"^\[pool\] chunk active=(\d+) dispatch->fetch \d+ms fetch-wait \d+ms "
                  r"deliver \d+ms$")
PROMPTS = ([5, 6, 7, 8], [9, 10], list(range(1, 30)))


def _port_device(monkeypatch):
    for key in DECLARED_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in {"TORCH_DEVICE": "cpu", "MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "4",
                       "BATCH_TIMEOUT_MS": "1", "DECODE_CHUNK": "4",
                       "DECODE_SLOTS": "4"}.items():
        monkeypatch.setenv(key, value)
    return TPUDevice(EnvFileConfig("/nonexistent"), Logger(Level.FATAL))


def _concurrently(generate) -> list:
    out = [None] * len(PROMPTS)

    def run(i):
        out[i] = generate(PROMPTS[i], 10)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


def _pool_lines(err: str) -> list:
    lines = [ln for ln in err.splitlines() if ln.startswith("[pool]")]
    assert all(LINE.match(ln) for ln in lines), lines
    return lines


@pytest.mark.parametrize("flag", [True, False])
def test_one_line_a_chunk_in_the_jax_format(monkeypatch, capfd, flag):
    monkeypatch.setattr(decode_pool, "_POOL_DEBUG", flag)
    dev = _port_device(monkeypatch)
    try:
        capfd.readouterr()
        d0 = dev.decode_pool.dispatches
        outs = _concurrently(lambda p, n: dev.generate(p, max_new_tokens=n))
        chunks = dev.decode_pool.dispatches - d0
        # chunks still in flight when the last row finished are fetched
        # (and print) after the requests return
        err, t0 = "", time.monotonic()
        while time.monotonic() - t0 < 10:
            err += capfd.readouterr().err
            if not flag or len(_pool_lines(err)) >= chunks:
                break
            time.sleep(0.05)
    finally:
        dev.close()
    lines = _pool_lines(err + capfd.readouterr().err)
    assert all(len(o) == 10 for o in outs) and chunks >= 3
    if not flag:
        assert lines == []
        return
    assert len(lines) == chunks
    riders = [int(LINE.match(ln).group(1)) for ln in lines]
    assert max(riders) >= 2 and all(1 <= r <= 4 for r in riders)


def test_the_jax_pool_prints_the_same_lines(monkeypatch, capfd):
    """The reference: the JAX pool's lines under the flag match the same
    pattern (the JAX pool keeps no chunk count to hold them to)."""
    monkeypatch.setattr(jax_decode_pool, "_POOL_DEBUG", True)
    with serving_device(DECODE_SLOTS="4", DECODE_CHUNK="4") as dev:
        capfd.readouterr()
        _concurrently(lambda p, n: dev.generate(p, max_new_tokens=n))
    lines = _pool_lines(capfd.readouterr().err)
    assert len(lines) >= 3
    assert max(int(LINE.match(ln).group(1)) for ln in lines) >= 2


@pytest.mark.parametrize("value,armed", [("1", True), ("0", False), ("", False)])
def test_the_flag_is_read_at_import(value, armed):
    env = {k: v for k, v in os.environ.items() if k != "GOFR_POOL_DEBUG"}
    env.update({"GOFR_POOL_DEBUG": value, "PYTHONPATH": str(REPO)})
    run = subprocess.run(
        [sys.executable, "-c", "import gofr_tpu_torch.tpu.decode_pool as d; print(d._POOL_DEBUG)"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip() == str(armed)
