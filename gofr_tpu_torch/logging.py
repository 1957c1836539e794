"""Leveled structured logging with two sinks and terminal pretty-printing
(copy of ``gofr_tpu/logging.py``).

- six levels DEBUG < INFO < NOTICE < WARN < ERROR < FATAL (``LOG_LEVEL``);
- the level filter, then ERROR and FATAL to stderr and the rest to stdout;
- JSON entries ``{"level": .., "time": .., "message": ..}`` when the sink is
  not a terminal, a colorized pretty line when it is;
- typed entries (the access log's ``RequestLog``) render through a
  duck-typed ``pretty_terminal()`` / ``log_fields()`` protocol;
- streams are resolved at call time, so tests capture output by swapping
  ``sys.stdout`` / ``sys.stderr``.
"""

from __future__ import annotations

import enum
import json
import sys
import time
from typing import Any, Optional, Protocol, runtime_checkable


class Level(enum.IntEnum):
    """The six levels, lowest first."""

    DEBUG = 1
    INFO = 2
    NOTICE = 3
    WARN = 4
    ERROR = 5
    FATAL = 6

    def color(self) -> int:
        return {
            Level.DEBUG: 36,
            Level.INFO: 34,
            Level.NOTICE: 32,
            Level.WARN: 33,
            Level.ERROR: 31,
            Level.FATAL: 35,
        }[self]


def level_from_string(name: str) -> Level:
    """A level by name; unknown strings fall back to INFO."""
    try:
        return Level[(name or "").strip().upper()]
    except KeyError:
        return Level.INFO


@runtime_checkable
class PrettyLoggable(Protocol):
    """Typed log entries (RequestLog, SQLLog, RedisLog, ServiceLog, RPCLog,
    TPULog) implement this to get custom terminal rendering and flat JSON
    fields."""

    def pretty_terminal(self) -> str: ...

    def log_fields(self) -> dict[str, Any]: ...


def _is_terminal(stream: Any) -> bool:
    try:
        return bool(stream.isatty())
    except Exception:
        return False


def _fmt_message(args: tuple[Any, ...]) -> Any:
    if len(args) == 1:
        a = args[0]
        if isinstance(a, (str, int, float, bool, dict, list)) or a is None:
            return a
        if isinstance(a, PrettyLoggable):
            return a
        return str(a)
    return " ".join(str(a) for a in args)


class Logger:
    """Concrete logger.

    ``terminal`` tristate: None = auto-detect per write (so redirecting
    stdout in tests switches to JSON mode automatically, matching the
    reference's check at construction but more test-friendly).
    """

    def __init__(self, level: Level = Level.INFO, terminal: Optional[bool] = None):
        self.level = level
        self._terminal = terminal

    # -- public leveled API -------------------------------------------------
    def debug(self, *args: Any) -> None:
        self._log(Level.DEBUG, args)

    def debugf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.DEBUG, fmt, args)

    def info(self, *args: Any) -> None:
        self._log(Level.INFO, args)

    def infof(self, fmt: str, *args: Any) -> None:
        self._logf(Level.INFO, fmt, args)

    # GoFr names the INFO pair Log/Logf; keep aliases for ergonomic parity.
    log = info
    logf = infof

    def notice(self, *args: Any) -> None:
        self._log(Level.NOTICE, args)

    def noticef(self, fmt: str, *args: Any) -> None:
        self._logf(Level.NOTICE, fmt, args)

    def warn(self, *args: Any) -> None:
        self._log(Level.WARN, args)

    def warnf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.WARN, fmt, args)

    def error(self, *args: Any) -> None:
        self._log(Level.ERROR, args)

    def errorf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.ERROR, fmt, args)

    def fatal(self, *args: Any) -> None:
        self._log(Level.FATAL, args)

    def fatalf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.FATAL, fmt, args)

    def change_level(self, level: Level) -> None:
        self.level = level

    # -- internals ----------------------------------------------------------
    def _logf(self, level: Level, fmt: str, args: tuple[Any, ...]) -> None:
        if level < self.level:
            return
        try:
            message = (fmt % args) if args else fmt
        except (TypeError, ValueError):
            try:
                message = fmt.format(*args)
            except (IndexError, KeyError, ValueError):
                # A log call must never crash the caller; degrade to a join.
                message = " ".join([fmt, *(str(a) for a in args)])
        self._write(level, message)

    def _log(self, level: Level, args: tuple[Any, ...]) -> None:
        if level < self.level:
            return
        self._write(level, _fmt_message(args))

    def _stream(self, level: Level) -> Any:
        # ERROR and above to stderr
        return sys.stderr if level >= Level.ERROR else sys.stdout

    def _write(self, level: Level, message: Any) -> None:
        stream = self._stream(level)
        terminal = self._terminal if self._terminal is not None else _is_terminal(stream)
        now = time.time()  # the rendered line's timestamp
        try:
            if terminal:
                stream.write(self._render_pretty(level, message, now))
            else:
                stream.write(self._render_json(level, message, now))
            stream.flush()
        except (ValueError, OSError):  # closed stream during shutdown
            pass

    def _render_json(self, level: Level, message: Any, now: float) -> str:
        entry: dict[str, Any] = {
            "level": level.name,
            "time": _rfc3339(now),
        }
        if isinstance(message, PrettyLoggable):
            entry["message"] = message.log_fields()
        else:
            entry["message"] = message
        return json.dumps(entry, default=str) + "\n"

    def _render_pretty(self, level: Level, message: Any, now: float) -> str:
        # "LEVL [ts] <typed or plain message>"
        ts = time.strftime("%H:%M:%S", time.localtime(now))
        head = f"\x1b[{level.color()}m{level.name[:4]}\x1b[0m [{ts}] "
        if isinstance(message, PrettyLoggable):
            body = message.pretty_terminal()
        elif isinstance(message, (dict, list)):
            body = json.dumps(message, default=str)
        else:
            body = str(message)
        return head + body + "\n"


def new_logger(level: Level | str = Level.INFO) -> Logger:
    """A logger at ``level`` (a Level or its name)."""
    if isinstance(level, str):
        level = level_from_string(level)
    return Logger(level)


def new_silent_logger() -> Logger:
    """Logger that emits nothing."""
    logger = Logger(Level.FATAL, terminal=False)
    logger._write = lambda *a, **k: None  # type: ignore[method-assign]
    return logger


def _rfc3339(now: float) -> str:
    lt = time.localtime(now)
    frac = int((now % 1) * 1e6)
    off = time.strftime("%z", lt)
    if len(off) == 5:  # +0000 -> +00:00 (RFC 3339 requires the colon)
        off = off[:3] + ":" + off[3:]
    return time.strftime("%Y-%m-%dT%H:%M:%S", lt) + f".{frac:06d}" + off
