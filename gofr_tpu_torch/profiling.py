"""Device profiling behind the admin endpoints (port of
``gofr_tpu/profiling.py``), over ``torch.profiler``.

``POST /admin/profiler/start`` starts one process-wide
``torch.profiler.profile`` (CPU activity on every thread, plus CUDA when the
card is there); ``POST /admin/profiler/stop`` stops it and exports a Chrome trace
(``trace.json``, open it in Perfetto or ``chrome://tracing``) into the
directory the start named: the request body's ``dir``, else
``PROFILE_DIR``, else a fresh ``mkdtemp``. ``GET /admin/profiler`` says
whether a trace is running. A live serving process is traced without a
redeploy; while no trace runs, the serving path pays nothing for it.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Optional

import torch

TRACE_FILE = "trace.json"


class Profiler:
    """Thread-safe owner of at most one running ``torch.profiler`` session."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._started_at: Optional[float] = None
        self._session: Any = None

    def start(self, log_dir: Optional[str] = None, default_dir: Optional[str] = None) -> dict[str, Any]:
        """Start tracing into ``log_dir`` (else ``default_dir``, the
        caller's ``PROFILE_DIR``, else a fresh temporary directory). A
        trace already running raises RuntimeError: restarting would drop
        the capture in flight."""
        with self._lock:
            if self._dir is not None:
                raise RuntimeError(f"profiler already tracing into {self._dir}")
            log_dir = log_dir or default_dir or tempfile.mkdtemp(prefix="gofr-profile-")
            os.makedirs(log_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            # every thread's host ops (the handler, batcher and pool
            # threads), and a stop on whichever thread the stop request runs
            session = torch.profiler.profile(
                activities=activities,
                experimental_config=torch.profiler._ExperimentalConfig(profile_all_threads=True),
            )
            session.start()
            self._session = session
            self._dir = log_dir
            self._started_at = time.monotonic()
            return {"state": "tracing", "dir": log_dir}

    def stop(self) -> dict[str, Any]:
        """Stop the trace and export it as a Chrome trace. The state is
        cleared BEFORE the stop and the export, so a failed export cannot
        leave the profiler stuck in "tracing"; the failure propagates."""
        with self._lock:
            if self._dir is None:
                raise RuntimeError("profiler is not tracing")
            log_dir, self._dir = self._dir, None
            session, self._session = self._session, None
            elapsed = time.monotonic() - (self._started_at or time.monotonic())
            self._started_at = None
            session.stop()
            session.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
        files = []
        for root, _, names in os.walk(log_dir):
            files.extend(os.path.relpath(os.path.join(root, n), log_dir) for n in names)
        return {
            "state": "stopped", "dir": log_dir,
            "seconds": round(elapsed, 2), "artifacts": sorted(files),
        }

    def status(self) -> dict[str, Any]:
        with self._lock:
            if self._dir is None:
                return {"state": "idle"}
            return {
                "state": "tracing", "dir": self._dir,
                "seconds": round(time.monotonic() - (self._started_at or 0), 2),
            }


_PROFILER = Profiler()


def profiler() -> Profiler:
    """The process-wide profiler (the CUDA profiler is process-wide too)."""
    return _PROFILER
