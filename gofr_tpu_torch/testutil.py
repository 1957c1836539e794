"""Test utilities: capture stdout/stderr of a function, mock logger (copy
of ``gofr_tpu/testutil.py``).

Parity: GoFr's pkg/gofr/testutil/os.go:8-36 (pipe-swap capture) and
testutil/mock_logger.go:15-75 (leveled mock logger recording output). The
Python logger resolves ``sys.stdout``/``sys.stderr`` at call time, so a
simple swap captures everything the real logger writes.
"""

from __future__ import annotations

import contextlib
import io
import sys
import time
from typing import Any, Callable

from gofr_tpu_torch.logging import Level, Logger


def stdout_output_for(func: Callable[[], Any]) -> str:
    """Run ``func`` and return everything written to stdout.

    Parity: testutil/os.go:8-21.
    """
    old = sys.stdout
    sys.stdout = buf = io.StringIO()
    try:
        func()
    finally:
        sys.stdout = old
    return buf.getvalue()


def stderr_output_for(func: Callable[[], Any]) -> str:
    """Parity: testutil/os.go:23-36."""
    old = sys.stderr
    sys.stderr = buf = io.StringIO()
    try:
        func()
    finally:
        sys.stderr = old
    return buf.getvalue()


class MockLogger(Logger):
    """Logger that records rendered lines in ``.lines`` (JSON mode) while
    still honoring level filtering. Parity: testutil/mock_logger.go:15-75."""

    def __init__(self, level: Level = Level.DEBUG):
        super().__init__(level, terminal=False)
        self.lines: list[str] = []

    def _write(self, level: Level, message: Any) -> None:  # type: ignore[override]
        # gofrlint: wall-clock — rendered log-line timestamp (presentation)
        self.lines.append(self._render_json(level, message, time.time()))

    @property
    def output(self) -> str:
        return "".join(self.lines)

    def contains(self, text: str) -> bool:
        return text in self.output


@contextlib.contextmanager
def serving_device(**env: str):
    """Build a ``TPUDevice`` under temporary env overrides; close it and
    restore the environment on exit, also when construction raises, so a
    failed boot leaks no env change or worker thread into later tests.
    Pass ``TORCH_DEVICE="cpu"`` to build it on the CPU."""
    import os

    from gofr_tpu_torch.config import EnvFileConfig
    from gofr_tpu_torch.metrics import Registry
    from gofr_tpu_torch.tpu.device import TPUDevice

    defaults = {"MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "2",
                "BATCH_TIMEOUT_MS": "1"}
    defaults.update(env)
    old = {k: os.environ.get(k) for k in defaults}
    os.environ.update(defaults)
    dev = None
    try:
        dev = TPUDevice(EnvFileConfig(), MockLogger(Level.INFO), metrics=Registry())
        yield dev
    finally:
        if dev is not None:
            dev.close()
        for k, v in old.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
