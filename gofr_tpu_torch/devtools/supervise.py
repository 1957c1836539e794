"""Process supervisor: restart-on-exit with bounded backoff and a
crash-loop verdict — process death as a ROUTINE event, not an incident.

A replica that is SIGKILLed must come back without an operator: the
supervisor respawns the child command when it exits, backing off
exponentially between restarts (decorrelated enough that a rack of
supervisors does not thundering-herd a shared dependency), and gives up
with an explicit ``crash_loop`` verdict when the child dies more than
``max_restarts_in_window`` times inside ``crash_window_s`` — a child
that cannot hold a process up is an operator page, and respawning it
forever just burns the machine while hiding the page.

Copy of ``gofr_tpu/devtools/supervise.py``. Used two ways: ``python -m
gofr_tpu_torch.devtools.supervise [options] -- <command>`` is the CLI
entry (wrap any serving command, e.g. ``python -m
gofr_tpu_torch.devtools.replica_proc``); and the chaos harness's
subprocess-mode replicas ride it, so a ``kill -9`` exercises the real
respawn. More than ``--max-restarts`` exits inside ``--crash-window``
seconds is a crash loop: the CLI stops respawning and exits 1;
SIGTERM/SIGINT stop the child and exit 0.

Restart semantics compose with the journal WAL (``JOURNAL_DIR``): the
respawned process rehydrates its pre-crash resumable entries at boot,
and the fleet prober walks it back into rotation through the
``restarting`` probation path (its ready ``boot_id`` changed).
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
from collections import deque
from typing import Any, Optional

CRASH_LOOP = "crash_loop"
STOPPED = "stopped"


class Supervisor:
    """Supervise one child command.

    ``start()`` spawns the child and a named monitor thread; when the
    child exits (and the supervisor was not asked to stop) it respawns
    after the current backoff. ``stop()`` terminates the child
    (SIGTERM, then SIGKILL after ``term_grace_s``) and joins the
    monitor. ``verdict`` is ``None`` while supervising, ``crash_loop``
    when the restart budget inside the window is spent, ``stopped``
    after a clean stop."""

    def __init__(
        self,
        argv: list[str],
        env: Optional[dict[str, str]] = None,
        backoff_s: float = 0.5,
        backoff_max_s: float = 10.0,
        crash_window_s: float = 30.0,
        max_restarts_in_window: int = 5,
        term_grace_s: float = 5.0,
        logger: Any = None,
        stdout: Any = subprocess.DEVNULL,
        stderr: Any = subprocess.DEVNULL,
        on_restart: Any = None,
    ):
        self.argv = list(argv)
        self.env = env
        self.backoff_s = max(0.0, backoff_s)
        self.backoff_max_s = max(self.backoff_s, backoff_max_s)
        self.crash_window_s = crash_window_s
        self.max_restarts_in_window = max(1, max_restarts_in_window)
        self.term_grace_s = term_grace_s
        self.logger = logger
        self._stdout = stdout
        self._stderr = stderr
        self._on_restart = on_restart
        self.restarts = 0
        self.verdict: Optional[str] = None
        self.last_exit_code: Optional[int] = None
        self._exits: "deque[float]" = deque()
        self._proc: Optional[subprocess.Popen] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guards the process handle against a stop() racing a respawn;
        # spawn/terminate happen OUTSIDE it (GFL004: no blocking under
        # a lock) — the monitor thread is the only spawner
        self._lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------------
    @property
    def pid(self) -> Optional[int]:
        with self._lock:
            return self._proc.pid if self._proc is not None else None

    @property
    def running(self) -> bool:
        with self._lock:
            return self._proc is not None and self._proc.poll() is None

    def start(self) -> "Supervisor":
        self._spawn()
        self._thread = threading.Thread(
            target=self._loop, name="gofr-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def _spawn(self) -> None:
        proc = subprocess.Popen(
            self.argv, env=self.env, stdout=self._stdout,
            stderr=self._stderr,
        )
        with self._lock:
            self._proc = proc
        if self.logger is not None:
            self.logger.infof(
                "supervisor: child %s up (pid %s)", self.argv[0], proc.pid
            )

    def _loop(self) -> None:
        backoff = self.backoff_s
        while not self._stop.is_set():
            with self._lock:
                proc = self._proc
            if proc is None:
                return
            code = proc.wait()
            self.last_exit_code = code
            if self._stop.is_set():
                return
            now = time.monotonic()
            self._exits.append(now)
            while self._exits and now - self._exits[0] > self.crash_window_s:
                self._exits.popleft()
            if len(self._exits) > self.max_restarts_in_window:
                self.verdict = CRASH_LOOP
                if self.logger is not None:
                    self.logger.errorf(
                        "supervisor: crash loop — %s exits inside %.0fs, "
                        "giving up (last exit code %s)",
                        len(self._exits), self.crash_window_s, code,
                    )
                return
            # a child that stayed up long enough to leave the crash
            # window earns its backoff back BEFORE this wait: the first
            # crash after a long healthy run respawns at backoff_s, not
            # at whatever the last crash burst had ramped the delay to
            if len(self._exits) <= 1:
                backoff = self.backoff_s
            if self.logger is not None:
                self.logger.warnf(
                    "supervisor: child exited %s; restart #%s in %.2fs",
                    code, self.restarts + 1, backoff,
                )
            if self._stop.wait(backoff):
                return
            backoff = min(self.backoff_max_s, max(backoff * 2, 0.01))
            self.restarts += 1
            try:
                self._spawn()
            except OSError as exc:
                self.verdict = CRASH_LOOP
                if self.logger is not None:
                    self.logger.errorf("supervisor: respawn failed: %r", exc)
                return
            if self._stop.is_set():
                # a stop() raced the respawn: it terminated the OLD
                # (already-dead) child, so the just-spawned one must
                # not outlive this loop
                self._terminate_child()
                return
            if self._on_restart is not None:
                try:
                    self._on_restart(self)
                except Exception:  # gofrlint: disable=GFL006 — hook must not kill the monitor
                    pass

    def kill9(self) -> Optional[int]:
        """SIGKILL the current child (the chaos fault). Returns the pid
        killed, or None when no child is up. The monitor respawns it
        after backoff — this is the fault injection, not a stop."""
        with self._lock:
            proc = self._proc
        if proc is None or proc.poll() is not None:
            return None
        pid = proc.pid
        os.kill(pid, signal.SIGKILL)
        return pid

    def _terminate_child(self) -> None:
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                proc.terminate()
                try:
                    proc.wait(timeout=self.term_grace_s)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5)
            except OSError:
                pass

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop supervising and bring the child down: SIGTERM, then
        SIGKILL after ``term_grace_s``."""
        self._stop.set()
        if self.verdict is None:
            self.verdict = STOPPED
        self._terminate_child()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        # the monitor may have respawned between our terminate and its
        # own stop check — the post-join sweep catches that child too
        self._terminate_child()

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            proc = self._proc
        return {
            "argv": self.argv,
            "pid": proc.pid if proc is not None else None,
            "running": proc is not None and proc.poll() is None,
            "restarts": self.restarts,
            "last_exit_code": self.last_exit_code,
            "verdict": self.verdict,
            "backoff_s": self.backoff_s,
            "backoff_max_s": self.backoff_max_s,
            "crash_window_s": self.crash_window_s,
            "max_restarts_in_window": self.max_restarts_in_window,
        }


def main(argv: Optional[list] = None) -> int:
    """The CLI: ``python -m gofr_tpu_torch.devtools.supervise [options] --
    <command> [args...]`` (the JAX package's ``tools/supervisor.py``)."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description="restart-on-exit process supervisor with bounded "
        "backoff and a crash-loop verdict",
    )
    parser.add_argument("--backoff", type=float, default=0.5,
                        help="initial restart backoff seconds (default 0.5)")
    parser.add_argument("--backoff-max", type=float, default=10.0,
                        help="backoff ceiling seconds (default 10)")
    parser.add_argument("--crash-window", type=float, default=30.0,
                        help="crash-loop detection window seconds (default 30)")
    parser.add_argument("--max-restarts", type=int, default=5,
                        help="exits tolerated inside the window before the "
                        "crash-loop verdict (default 5)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="-- command to supervise")
    args = parser.parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no command given (use: supervise [options] -- cmd)")

    class _StderrLogger:
        @staticmethod
        def _emit(fmt: str, *fmt_args: Any) -> None:
            print(fmt % fmt_args, file=sys.stderr, flush=True)

        infof = warnf = errorf = _emit

    supervisor = Supervisor(
        command, backoff_s=args.backoff, backoff_max_s=args.backoff_max,
        crash_window_s=args.crash_window, max_restarts_in_window=args.max_restarts,
        logger=_StderrLogger(),
        stdout=None,  # inherit: the child's output is the operator's
        stderr=None,
    )

    def handle_signal(signum: int, _frame: Any) -> None:
        supervisor.logger.infof("supervisor: signal %s — stopping child", signum)
        supervisor.stop()
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGINT, handle_signal)
    supervisor.start()
    try:
        while supervisor.verdict is None:
            time.sleep(0.2)
    finally:
        if supervisor.verdict == CRASH_LOOP:
            supervisor.logger.errorf(
                "supervisor: crash-loop verdict (last exit %s)", supervisor.last_exit_code
            )
            supervisor.stop()
            return 1
        supervisor.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
