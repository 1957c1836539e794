"""The port's ``devtools/supervise.py`` and subprocess replicas
(``python -m gofr_tpu_torch.devtools.replica_proc``) held to the JAX
package's ``tests/test_process_death.py`` case for case, the SIGKILL legs
included. The JAX file's own description follows.

Process death as a routine event, tier-1: the supervisor
(restart-on-exit, bounded backoff, crash-loop verdict), the prober's
``restarting`` passage for connection-refused-then-reborn replicas
(boot_id change → probation, counted), and THE acceptance e2e —
``kill -9`` a REAL subprocess replica mid-stream, the supervisor
respawns it, the respawned process rehydrates its journal WAL, and the
client's stream completes token-exact through the router with the
restart visible on metrics and ``/admin/fleet``.

These tests spawn real OS processes.
"""

import json
import sys
import time
import urllib.request

import pytest

from gofr_tpu_torch.devtools.supervise import CRASH_LOOP, STOPPED, Supervisor

PY = sys.executable


@pytest.fixture(autouse=True)
def _no_leaked_contextvars():
    """Clear both packages' request contextvars around each test: the
    flight record, the journal entry, the deadline, the priority, the fleet
    origin and the KV-donor hint (a leaked one fails another file's test)."""
    import gofr_tpu.deadline as jd
    import gofr_tpu.fleet.kvwire as jk
    import gofr_tpu.telemetry as jt
    import gofr_tpu_torch.deadline as td
    import gofr_tpu_torch.fleet.kvwire as tk
    import gofr_tpu_torch.telemetry as tt

    def clear():
        for mod in (jt, tt):
            mod.activate_journal_entry(None)
            mod.activate_record(None)
            mod.activate_origin(None)
        for mod in (jd, td):
            mod.activate_deadline(None)
            mod.activate_priority(None)
        for mod in (jk, tk):
            mod.activate_kv_hint(None)

    clear()
    yield
    clear()


def _get(url, headers=None, timeout=10):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), dict(r.headers.items())


def _wait(cond, timeout=20.0, interval=0.02, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


def _read_sse_tokens(resp, initial: bytes = b"") -> tuple:
    """Drain one SSE response: returns (token_ids, event_ids, raw)."""
    raw = initial
    while True:
        chunk = resp.read(4096)
        if not chunk:
            break
        raw += chunk
    tokens: list = []
    ids: list = []
    for block in raw.split(b"\n\n"):
        event_id = None
        for line in block.split(b"\n"):
            if line.startswith(b"id:"):
                event_id = int(line[3:].strip())
            elif line.startswith(b"data:"):
                data = line[5:].strip()
                if data == b"[DONE]" or not data.startswith(b"{"):
                    continue
                frame = json.loads(data)
                if "error" in frame:
                    raise AssertionError(f"error frame reached client: {frame}")
                choice = frame["choices"][0]
                if choice.get("tokens"):
                    tokens.extend(choice["tokens"])
                    if event_id is not None:
                        ids.append(event_id)
    return tokens, ids, raw


# -- the supervisor ------------------------------------------------------------

def test_supervisor_restarts_after_kill():
    supervisor = Supervisor(
        [PY, "-c", "import time; time.sleep(60)"],
        backoff_s=0.05, backoff_max_s=0.2,
    ).start()
    try:
        assert supervisor.running
        first_pid = supervisor.pid
        assert supervisor.kill9() == first_pid
        _wait(lambda: supervisor.restarts == 1 and supervisor.running,
              message="respawn")
        assert supervisor.pid != first_pid
        assert supervisor.last_exit_code != 0  # SIGKILL is not clean
        assert supervisor.verdict is None  # still supervising
    finally:
        supervisor.stop()
    assert supervisor.verdict == STOPPED
    assert not supervisor.running


def test_supervisor_crash_loop_verdict_stops_respawning():
    supervisor = Supervisor(
        [PY, "-c", "raise SystemExit(3)"],
        backoff_s=0.01, backoff_max_s=0.02,
        crash_window_s=10.0, max_restarts_in_window=3,
    ).start()
    try:
        _wait(lambda: supervisor.verdict == CRASH_LOOP,
              message="crash-loop verdict")
        assert supervisor.last_exit_code == 3
        restarts_at_verdict = supervisor.restarts
        time.sleep(0.2)  # the verdict is terminal: no further respawns
        assert supervisor.restarts == restarts_at_verdict
        assert not supervisor.running
        snap = supervisor.snapshot()
        assert snap["verdict"] == CRASH_LOOP
    finally:
        supervisor.stop()


def test_supervisor_stop_racing_respawn_leaves_no_orphan():
    """Regression: stop() arriving while the monitor is mid-respawn
    must not leak the just-spawned child (the old code terminated the
    already-dead process and let the fresh one run forever)."""
    import os

    for _ in range(5):  # the race window is narrow: hammer it
        supervisor = Supervisor(
            [PY, "-c", "import time; time.sleep(60)"],
            backoff_s=0.01, backoff_max_s=0.02,
        ).start()
        supervisor.kill9()
        time.sleep(0.012)  # land stop() around the respawn
        supervisor.stop()
        assert not supervisor.running
        pid = supervisor.pid
        if pid is not None:
            try:
                os.kill(pid, 0)
                # the pid exists: it must be a zombie awaiting reap by
                # us (its parent), not a live orphan still sleeping
                with open(f"/proc/{pid}/stat") as f:
                    assert f.read().split()[2] == "Z"
            except OSError:
                pass  # fully gone: the desired outcome


def test_supervisor_clean_stop_terminates_child():
    supervisor = Supervisor(
        [PY, "-c", "import time; time.sleep(60)"], backoff_s=0.05,
    ).start()
    pid = supervisor.pid
    supervisor.stop()
    assert not supervisor.running
    assert supervisor.verdict == STOPPED
    assert pid is not None


# -- the restarting probation path (prober unit) -------------------------------

def test_reborn_boot_id_walks_probation_as_restarting():
    from gofr_tpu_torch.fleet.replica import (
        HEALTHY,
        PROBATION,
        Replica,
        ReplicaSet,
    )
    from gofr_tpu_torch.logging import Level
    from gofr_tpu.testutil import MockLogger

    replica = Replica("r0", "http://127.0.0.1:1", MockLogger(Level.FATAL))
    replica_set = ReplicaSet([replica], MockLogger(Level.FATAL),
                             out_after=2, probation_probes=2)
    restarts_seen = []
    replica_set._on_restart = lambda r: restarts_seen.append(r.name)

    # steady state: same boot id, stays healthy
    replica_set._apply_probe(replica, True, boot_id="boot-a")
    replica_set._apply_probe(replica, True, boot_id="boot-a")
    assert replica.state == HEALTHY and replica.restarts == 0

    # killed and respawned INSIDE one probe interval: no probe ever
    # failed, but the new process must still walk probation
    replica_set._apply_probe(replica, True, boot_id="boot-b")
    assert replica.state == PROBATION
    assert replica.restarting and replica.restarts == 1
    assert restarts_seen == ["r0"]
    # the reboot probe opened the streak (exactly like OUT->PROBATION);
    # one more OK probe completes the 2-probe window
    replica_set._apply_probe(replica, True, boot_id="boot-b")
    assert replica.state == HEALTHY and not replica.restarting

    # the usual shape: connection refused (probe fails) then reborn
    replica_set._apply_probe(replica, False)
    replica_set._apply_probe(replica, False)
    assert replica.state == "out"
    replica_set._apply_probe(replica, True, boot_id="boot-c")
    assert replica.state == PROBATION
    assert replica.restarts == 2 and replica.restarting
    snap = replica.snapshot()
    assert snap["restarts"] == 2 and snap["restarting"] is True
    assert snap["boot_id"] == "boot-c"

    # replicas that predate boot_id (None): detection stays off
    replica_set._apply_probe(replica, True, boot_id=None)
    replica_set._apply_probe(replica, True, boot_id=None)
    assert replica.restarts == 2


# -- THE acceptance e2e --------------------------------------------------------

def test_sigkill_mid_stream_resumes_token_exact_through_router(
        tmp_path, monkeypatch):
    """SIGKILL a subprocess replica mid-stream → the supervisor
    respawns it → the respawned process rehydrates its journal WAL →
    the router's stream relay resumes against the reborn replica — and
    the client sees one unbroken, token-exact stream. The restart is
    visible on gofr_tpu_router_replica_restarts_total and
    /admin/fleet; the rehydration on the replica's /admin/engine."""
    from gofr_tpu_torch.devtools.chaos import chaos_router, subprocess_replica

    monkeypatch.chdir(tmp_path)
    prompt, n_tokens = [5, 6, 7], 40
    expected = [prompt[i % 3] for i in range(n_tokens)]  # echo's contract
    with subprocess_replica(
        name="sp0",
        env={
            "JOURNAL_DIR": str(tmp_path / "journal"),
            "ECHO_STEP_MS": "40",
        },
        backoff_s=0.2, backoff_max_s=0.5,
    ) as replica, chaos_router(
        [replica],
        env={"FLEET_PROBE_INTERVAL_S": "0.05", "FLEET_OUT_AFTER": "2",
             "FLEET_PROBATION_PROBES": "2", "FLEET_READ_TIMEOUT_S": "5",
             "FLEET_DEADLINE_S": "30", "FLEET_MAX_RESUMES": "8"},
    ) as app:
        base = f"http://127.0.0.1:{app.http_port}"
        fleet = app.container.fleet
        _wait(lambda: len(fleet.replica_set.in_rotation()) == 1,
              message="replica in rotation")

        req = urllib.request.Request(
            base + "/v1/completions",
            data=json.dumps({
                "model": "echo", "prompt": prompt, "max_tokens": n_tokens,
                "stream": True, "seed": 7,
            }).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        resp = urllib.request.urlopen(req, timeout=60)
        assert resp.status == 200
        first = resp.read(1)  # at least one byte of the stream arrived
        assert first
        time.sleep(0.2)  # a few tokens flow (and land in the WAL)

        killed_pid = replica.kill9()
        assert killed_pid is not None

        # the client keeps reading straight through process death,
        # supervisor respawn, WAL rehydration, and the relay's resume
        tokens, ids, raw = _read_sse_tokens(resp, initial=first)
        assert raw and b"data: [DONE]" in raw  # completed, not truncated
        assert tokens == expected  # ZERO missing, ZERO duplicated
        assert ids == sorted(set(ids))  # strictly monotonic event ids

        # a NEW process serves now, and its WAL rehydrated the stream
        assert replica.supervisor.restarts >= 1
        assert replica.pid != killed_pid
        _, body, _ = _get(replica.address + "/admin/engine")
        engine = json.loads(body)["data"]
        assert engine["journal"]["rehydrated"] >= 1
        assert engine["journal"]["wal"]["segments"] >= 1
        _, replica_metrics, _ = _get(replica.address + "/metrics")
        assert ('gofr_tpu_journal_resumes_total{mode="teacher_forced"}'
                in replica_metrics.decode())

        # the router observed the restart AND the resume
        _wait(lambda: fleet.replica_set.replicas[0].restarts >= 1,
              message="prober counts the restart")
        snap = fleet.snapshot()
        rep_snap = snap["replica_set"]["replicas"][0]
        assert rep_snap["restarts"] >= 1
        _, router_metrics, _ = _get(base + "/metrics")
        text = router_metrics.decode()
        assert "gofr_tpu_router_replica_restarts_total" in text
        assert ('gofr_tpu_router_stream_resumes_total{outcome="resumed"}'
                in text)


def test_sigkilled_replica_serves_x_resume_from_directly(
        tmp_path, monkeypatch):
    """The replica-side half without a router: kill a subprocess
    replica mid-stream, wait for the supervisor respawn, and ask the
    REBORN process for the rest via X-Resume-From — the WAL-rehydrated
    journal serves the continuation bit-identically."""
    from gofr_tpu_torch.devtools.chaos import subprocess_replica

    monkeypatch.chdir(tmp_path)
    prompt, n_tokens = [11, 12, 13], 30
    expected = [prompt[i % 3] for i in range(n_tokens)]
    with subprocess_replica(
        name="sp1",
        env={
            "JOURNAL_DIR": str(tmp_path / "journal"),
            "ECHO_STEP_MS": "40",
        },
        backoff_s=0.2, backoff_max_s=0.5,
    ) as replica:
        payload = json.dumps({
            "model": "echo", "prompt": prompt, "max_tokens": n_tokens,
            "stream": True, "seed": 3,
        }).encode()
        req = urllib.request.Request(
            replica.address + "/v1/completions", data=payload,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        resp = urllib.request.urlopen(req, timeout=30)
        # read a couple of complete events off the wire, then the
        # process dies under the client
        buf = b""
        while buf.count(b"\n\n") < 2:
            chunk = resp.read(1)
            assert chunk, "stream ended before two events"
            buf += chunk
        delivered, _, _ = _read_sse_partial(buf)
        replica.kill9()
        try:
            resp.read()
        except Exception:
            pass  # the kill severs the socket mid-body; expected
        replica.wait_ready(30)

        # the REBORN process continues from the delivered offset
        resume_req = urllib.request.Request(
            replica.address + "/v1/completions", data=payload,
            headers={"Content-Type": "application/json",
                     "X-Resume-From": str(len(delivered))},
            method="POST",
        )
        with urllib.request.urlopen(resume_req, timeout=30) as r2:
            rest, _, raw2 = _read_sse_tokens(r2)
        assert b"data: [DONE]" in raw2
        assert delivered + rest == expected
        _, body, _ = _get(replica.address + "/admin/engine")
        engine = json.loads(body)["data"]
        assert engine["journal"]["rehydrated"] >= 1


def _read_sse_partial(buf: bytes) -> tuple:
    """Tokens from the COMPLETE events inside a partial SSE buffer."""
    complete = buf.rsplit(b"\n\n", 1)[0] + b"\n\n"
    return _sse_blocks(complete)


def _sse_blocks(raw: bytes) -> tuple:
    tokens: list = []
    ids: list = []
    for block in raw.split(b"\n\n"):
        for line in block.split(b"\n"):
            if line.startswith(b"id:"):
                ids.append(int(line[3:].strip()))
            elif line.startswith(b"data:"):
                data = line[5:].strip()
                if data == b"[DONE]" or not data.startswith(b"{"):
                    continue
                frame = json.loads(data)
                choice = (frame.get("choices") or [{}])[0]
                if choice.get("tokens"):
                    tokens.extend(choice["tokens"])
    return tokens, ids, raw
