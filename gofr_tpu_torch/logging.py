"""Minimal logger: one JSON line per entry on stderr."""

from __future__ import annotations

import json
import sys
import time
from typing import Any


class Logger:
    def __init__(self, stream: Any = None):
        self.stream = stream or sys.stderr

    def _log(self, level: str, fmt: str, args: tuple) -> None:
        message = fmt % args if args else fmt
        line = json.dumps({"level": level, "time": time.time(), "message": message})
        print(line, file=self.stream, flush=True)

    def infof(self, fmt: str, *args: Any) -> None:
        self._log("INFO", fmt, args)

    def warnf(self, fmt: str, *args: Any) -> None:
        self._log("WARN", fmt, args)

    def errorf(self, fmt: str, *args: Any) -> None:
        self._log("ERROR", fmt, args)
