"""CMD transport: CLI apps sharing the transport-agnostic handler signature
(copy of ``gofr_tpu/cmd.py``).

Parity: GoFr's pkg/gofr/cmd.go:12-70 (non-flag args joined into the
command string :33-41, regex route matching :54-63, "No Command Found!" on
stderr :46-49), cmd/request.go:14-114 (flag parsing ``-a`` / ``--a=b``
:36-60, reflection Bind into str/bool/int fields :87-114), and
cmd/responder.go:8-19 (stdout for results, stderr for errors).
"""

from __future__ import annotations

import json
import re
import sys
from typing import Any, Optional

from gofr_tpu_torch.context import Context
from gofr_tpu_torch.tracing import get_tracer


class CMDRequest:
    """Argv-backed request façade (parity: cmd/request.go:14-114)."""

    def __init__(self, args: Optional[list[str]] = None):
        self.args = list(sys.argv[1:] if args is None else args)
        self.flags: dict[str, str] = {}
        self._parse_flags()

    def _parse_flags(self) -> None:
        # parity: cmd/request.go:36-60 — `-a` / `-a=b` / `--a=b`; bare flags
        # get value "true"
        for arg in self.args:
            if not arg.startswith("-"):
                continue
            name = arg.lstrip("-")
            if not name:
                continue
            if "=" in name:
                key, _, value = name.partition("=")
                if key:
                    self.flags[key] = value
            else:
                self.flags[name] = "true"

    # -- Request interface ---------------------------------------------------
    def param(self, key: str) -> str:
        return self.flags.get(key, "")

    def params(self, key: str) -> list[str]:
        value = self.param(key)
        return [value] if value else []

    def path_param(self, key: str) -> str:
        return self.param(key)

    def bind(self, into: Any = None) -> Any:
        """Reflection-style bind of flags into an object's declared fields
        (parity: cmd/request.go:87-114 — string/bool/int conversions)."""
        if into is None:
            return dict(self.flags)
        obj = into() if isinstance(into, type) else into
        hints = getattr(obj, "__annotations__", {}) or {
            k: type(v) for k, v in vars(obj).items()
        }
        for key, value in self.flags.items():
            if key not in hints:
                continue
            kind = hints[key]
            if kind is bool:
                setattr(obj, key, value.lower() in ("true", "1", "yes", ""))
            elif kind is int:
                try:
                    setattr(obj, key, int(value))
                except ValueError:
                    pass
            elif kind is float:
                try:
                    setattr(obj, key, float(value))
                except ValueError:
                    pass
            else:
                setattr(obj, key, value)
        return obj

    def header(self, name: str) -> str:
        return ""

    def host_name(self) -> str:
        return "cli"


class CMDResponder:
    """stdout/stderr responder (parity: cmd/responder.go:8-19)."""

    def respond(self, result: Any, error: Optional[BaseException]) -> None:
        if error is not None:
            print(str(error), file=sys.stderr)
            return
        if result is None:
            return
        if isinstance(result, str):
            print(result)
        else:
            print(json.dumps(result, default=str))


def command_string(args: list[str]) -> str:
    """Join non-flag args (parity: cmd.go:28-41)."""
    return " ".join(a for a in args if not a.startswith("-"))


def run_cmd(app: Any, args: Optional[list[str]] = None) -> int:
    """Match the command against registered sub-command patterns and run the
    handler (parity: cmd.go:27-63). Returns a process exit code."""
    argv = list(sys.argv[1:] if args is None else args)
    command = command_string(argv)
    responder = CMDResponder()
    for pattern, handler in app._cmd_routes:
        if pattern == command:
            matched = True
        else:
            try:
                matched = re.fullmatch(pattern, command) is not None
            except re.error:  # pattern is a plain literal, not a regex
                matched = False
        if matched:
            request = CMDRequest(argv)
            ctx = Context(request, app.container)
            with get_tracer().start_span(f"cmd {command or pattern}"):
                try:
                    result, error = handler(ctx), None
                except Exception as exc:
                    result, error = None, exc
            responder.respond(result, error)
            return 0 if error is None else 1
    print("No Command Found!", file=sys.stderr)  # parity: cmd.go:46-49
    return 1
