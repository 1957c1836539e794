"""``GOFR_POOL_DEBUG=1`` on the port's decode pool against the JAX pool's:
one stderr line a fetched chunk, in the JAX pool's format (``[pool] chunk
active=N dispatch->fetch Xms fetch-wait Yms deliver Zms``), as many lines
as the pool dispatched chunks, each naming that chunk's riders; nothing
without the flag. The flag is read when the module is imported, as in the
JAX package.

The chunk test holds by construction on a loaded host: the pool's worker
admits nothing until all three requests are in (so every chunk carries
them all), and the chunks are counted once the pool is idle and its worker
has joined (every dispatched chunk fetched and printed). A close with
chunks in flight closes their dispatch records as errors, as the JAX pool
does (``gofr_tpu/tpu/decode_pool.py``'s close branch).
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


def _admit_together(monkeypatch, pool, n: int) -> None:
    """Hold the pool's first admission until ``n`` requests are in: the
    worker waits on the pool's own condition (which releases the lock to
    the submits), so the first chunk already carries all ``n``."""
    admit = pool._admit_pending
    held = [True]

    def gated():
        t0 = time.monotonic()
        while held[0] and len(pool._active) < n and time.monotonic() - t0 < 60:
            pool._work.wait(0.05)
        held[0] = False
        admit()

    monkeypatch.setattr(pool, "_admit_pending", gated)


def _wait_idle(pool, timeout: float = 60.0) -> None:
    """Until no slot is active and no chunk is in flight."""
    t0 = time.monotonic()
    while (pool._active or pool._in_flight) and time.monotonic() - t0 < timeout:
        time.sleep(0.01)


@pytest.mark.parametrize("flag", [True, False])
def test_one_line_a_chunk_in_the_jax_format(monkeypatch, capfd, flag):
    monkeypatch.setattr(decode_pool, "_POOL_DEBUG", flag)
    dev = _port_device(monkeypatch)
    pool = dev.decode_pool
    _admit_together(monkeypatch, pool, len(PROMPTS))
    try:
        capfd.readouterr()
        d0 = pool.dispatches
        outs = _concurrently(lambda p, n: dev.generate(p, max_new_tokens=n))
        # chunks still in flight when the last row finished are fetched
        # (and print) after the requests return: count once the pool is idle
        _wait_idle(pool)
        chunks = pool.dispatches - d0
    finally:
        dev.close()  # joins the worker: a chunk popped for its fetch has printed
    lines = _pool_lines(capfd.readouterr().err)
    assert all(len(o) == 10 for o in outs) and chunks >= 3
    if not flag:
        assert lines == []
        return
    assert len(lines) == chunks
    riders = [int(LINE.match(ln).group(1)) for ln in lines]
    assert riders[0] == len(PROMPTS) and all(1 <= r <= 4 for r in riders)


def test_a_close_closes_the_records_of_chunks_in_flight(monkeypatch):
    """Closed with chunks dispatched and not fetched, the pool closes their
    dispatch records as errors and fails the request, where it left them
    "running" before."""
    dev = _port_device(monkeypatch)
    pool = dev.decode_pool
    fetch = pool._fetch_and_deliver
    reached, release = threading.Event(), threading.Event()
    in_flight_at_close = []

    def held_fetch(in_flight):
        if not reached.is_set():
            reached.set()
            release.wait(60)
            if pool._closed:
                in_flight_at_close.append(len(in_flight))
                return  # the loop sees the close next
        fetch(in_flight)

    monkeypatch.setattr(pool, "_fetch_and_deliver", held_fetch)
    failure = []

    def run():
        try:
            dev.generate(PROMPTS[0], max_new_tokens=40)
        except Exception as exc:  # the close fails the request
            failure.append(exc)

    request = threading.Thread(target=run)
    request.start()
    assert reached.wait(60)
    closer = threading.Thread(target=dev.close)
    closer.start()
    t0 = time.monotonic()
    while not pool._closed and time.monotonic() - t0 < 60:
        time.sleep(0.01)
    release.set()
    closer.join(60)
    request.join(60)
    chunks = dev.timeline.records(kind="decode_chunk", limit=1000)
    statuses = [r["status"] for r in chunks]
    assert in_flight_at_close and in_flight_at_close[0] >= 1
    assert len(chunks) == pool.dispatches
    assert "running" not in statuses
    assert statuses.count("error") == in_flight_at_close[0]
    assert failure and "closed" in str(failure[0])


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
