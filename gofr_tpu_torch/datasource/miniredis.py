"""In-process mini Redis server for tests (copy of
``gofr_tpu/datasource/miniredis.py``).

Parity role: the reference tests Redis against **miniredis** (go.mod:7,
redis_test.go:23 ``miniredis.Run()``) instead of real infrastructure
(SURVEY.md §4). This is the same idea: a real TCP server speaking enough
RESP2 for the framework's client and examples, running on a daemon thread.

Supported: PING ECHO SET GET DEL EXISTS INCR DECR EXPIRE TTL KEYS INFO
FLUSHDB HSET HGET HGETALL LPUSH RPUSH RPOP LPOP LRANGE QUIT.
Expiry is lazy (checked on access), like miniredis's FastForward-free mode.
"""

from __future__ import annotations

import fnmatch
import socket
import socketserver
import threading
import time
from typing import Any, Optional


class _Store:
    def __init__(self) -> None:
        self.data: dict[str, Any] = {}
        self.expiry: dict[str, float] = {}
        self.lock = threading.RLock()

    def _check_expired(self, key: str) -> None:
        deadline = self.expiry.get(key)
        if deadline is not None and time.monotonic() >= deadline:
            self.data.pop(key, None)
            self.expiry.pop(key, None)

    def get(self, key: str) -> Any:
        with self.lock:
            self._check_expired(key)
            return self.data.get(key)

    def set(self, key: str, value: Any, ex: Optional[float] = None) -> None:
        with self.lock:
            self.data[key] = value
            if ex is not None:
                self.expiry[key] = time.monotonic() + ex
            else:
                self.expiry.pop(key, None)

    def delete(self, key: str) -> bool:
        with self.lock:
            self._check_expired(key)
            existed = key in self.data
            self.data.pop(key, None)
            self.expiry.pop(key, None)
            return existed

    def keys(self) -> list[str]:
        with self.lock:
            for key in list(self.data):
                self._check_expired(key)
            return list(self.data)


def _encode(value: Any) -> bytes:
    if value is None:
        return b"$-1\r\n"
    if isinstance(value, _Simple):
        return b"+" + value.text.encode() + b"\r\n"
    if isinstance(value, _Error):
        return b"-" + value.text.encode() + b"\r\n"
    if isinstance(value, int):
        return b":%d\r\n" % value
    if isinstance(value, (list, tuple)):
        return b"*%d\r\n" % len(value) + b"".join(_encode(v) for v in value)
    data = value if isinstance(value, bytes) else str(value).encode("utf-8")
    return b"$%d\r\n%s\r\n" % (len(data), data)


class _Simple:
    def __init__(self, text: str):
        self.text = text


class _Error:
    def __init__(self, text: str):
        self.text = text


OK = _Simple("OK")


class _Handler(socketserver.BaseRequestHandler):
    def setup(self) -> None:
        with self.server.conns_lock:  # type: ignore[attr-defined]
            self.server.conns.add(self.request)  # type: ignore[attr-defined]

    def finish(self) -> None:
        with self.server.conns_lock:  # type: ignore[attr-defined]
            self.server.conns.discard(self.request)  # type: ignore[attr-defined]

    def handle(self) -> None:
        store: _Store = self.server.store  # type: ignore[attr-defined]
        buf = b""
        sock = self.request
        while True:
            args, buf, closed = _read_command(sock, buf)
            if closed:
                return
            if not args:
                continue
            cmd = args[0].decode("utf-8", "replace").upper()
            rest = [a.decode("utf-8", "replace") for a in args[1:]]
            if cmd == "QUIT":
                sock.sendall(_encode(OK))
                return
            try:
                reply = _dispatch(store, cmd, rest)
            except Exception as exc:  # pragma: no cover - defensive
                reply = _Error(f"ERR {exc}")
            try:
                sock.sendall(_encode(reply))
            except OSError:
                return


def _read_command(sock: socket.socket, buf: bytes) -> tuple[list[bytes], bytes, bool]:
    def need(n: int) -> bool:
        nonlocal buf
        while len(buf) < n:
            chunk = sock.recv(65536)
            if not chunk:
                return False
            buf += chunk
        return True

    def read_line() -> Optional[bytes]:
        nonlocal buf
        while b"\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                return None
            buf += chunk
        line, _, buf = buf.partition(b"\r\n")
        return line

    line = read_line()
    if line is None:
        return [], buf, True
    if not line.startswith(b"*"):
        # inline command
        return line.split(), buf, False
    n = int(line[1:])
    args: list[bytes] = []
    for _ in range(n):
        header = read_line()
        if header is None or not header.startswith(b"$"):
            return [], buf, True
        size = int(header[1:])
        if not need(size + 2):
            return [], buf, True
        args.append(buf[:size])
        buf = buf[size + 2:]
    return args, buf, False


def _cmd_ping(store: _Store, cmd: str, args: list[str]) -> Any:
    return _Simple(args[0]) if args else _Simple("PONG")


def _cmd_echo(store: _Store, cmd: str, args: list[str]) -> Any:
    return args[0]


def _cmd_set(store: _Store, cmd: str, args: list[str]) -> Any:
    ex = None
    i = 2
    while i < len(args):
        opt = args[i].upper()
        if opt == "EX" and i + 1 < len(args):
            ex = float(args[i + 1])
            i += 2
        elif opt == "PX" and i + 1 < len(args):
            ex = float(args[i + 1]) / 1000.0
            i += 2
        else:
            i += 1
    store.set(args[0], args[1], ex)
    return OK


def _cmd_get(store: _Store, cmd: str, args: list[str]) -> Any:
    value = store.get(args[0])
    if isinstance(value, (dict, list)):
        return _Error(
            "WRONGTYPE Operation against a key holding the wrong kind of value"
        )
    return value


def _cmd_del(store: _Store, cmd: str, args: list[str]) -> Any:
    return sum(1 for k in args if store.delete(k))


def _cmd_exists(store: _Store, cmd: str, args: list[str]) -> Any:
    return sum(1 for k in args if store.get(k) is not None)


def _cmd_incr(store: _Store, cmd: str, args: list[str]) -> Any:
    delta = int(args[1]) if len(args) > 1 else 1
    if cmd.startswith("DECR"):
        delta = -delta
    with store.lock:
        current = store.get(args[0])
        try:
            value = (int(current) if current is not None else 0) + delta
        except (TypeError, ValueError):
            return _Error("ERR value is not an integer or out of range")
        deadline = store.expiry.get(args[0])  # INCR preserves TTL
        store.set(args[0], str(value), None)
        if deadline is not None:
            store.expiry[args[0]] = deadline
    return value


def _cmd_expire(store: _Store, cmd: str, args: list[str]) -> Any:
    with store.lock:
        if store.get(args[0]) is None:
            return 0
        store.expiry[args[0]] = time.monotonic() + float(args[1])
        return 1


def _cmd_ttl(store: _Store, cmd: str, args: list[str]) -> Any:
    with store.lock:
        if store.get(args[0]) is None:
            return -2
        deadline = store.expiry.get(args[0])
        if deadline is None:
            return -1
        return max(0, int(round(deadline - time.monotonic())))


def _cmd_keys(store: _Store, cmd: str, args: list[str]) -> Any:
    pattern = args[0] if args else "*"
    return [k for k in store.keys() if fnmatch.fnmatchcase(k, pattern)]


def _cmd_info(store: _Store, cmd: str, args: list[str]) -> Any:
    return (
        "# Server\r\nredis_version:7.0.0-mini\r\n"
        "# Clients\r\nconnected_clients:1\r\n"
        "# Memory\r\nused_memory:1024\r\n"
    )


def _cmd_flushdb(store: _Store, cmd: str, args: list[str]) -> Any:
    with store.lock:
        store.data.clear()
        store.expiry.clear()
    return OK


def _cmd_hset(store: _Store, cmd: str, args: list[str]) -> Any:
    with store.lock:
        h = store.get(args[0])
        if h is None:
            h = {}
            store.set(args[0], h, None)
        added = 0
        for field, value in zip(args[1::2], args[2::2]):
            added += 0 if field in h else 1
            h[field] = value
        return added


def _cmd_hget(store: _Store, cmd: str, args: list[str]) -> Any:
    h = store.get(args[0])
    return None if not isinstance(h, dict) else h.get(args[1])


def _cmd_hgetall(store: _Store, cmd: str, args: list[str]) -> Any:
    h = store.get(args[0])
    if not isinstance(h, dict):
        return []
    out: list[str] = []
    for k, v in h.items():
        out.extend((k, v))
    return out


def _cmd_push(store: _Store, cmd: str, args: list[str]) -> Any:
    with store.lock:
        lst = store.get(args[0])
        if lst is None:
            lst = []
            store.set(args[0], lst, None)
        for v in args[1:]:
            lst.insert(0, v) if cmd == "LPUSH" else lst.append(v)
        return len(lst)


def _cmd_pop(store: _Store, cmd: str, args: list[str]) -> Any:
    with store.lock:
        lst = store.get(args[0])
        if not lst:
            return None
        return lst.pop(0) if cmd == "LPOP" else lst.pop()


def _cmd_lrange(store: _Store, cmd: str, args: list[str]) -> Any:
    lst = store.get(args[0]) or []
    start, stop = int(args[1]), int(args[2])
    if stop == -1:
        return lst[start:]
    return lst[start : stop + 1]


# command table: each handler takes (store, cmd, args) — variant commands
# (INCR/DECR, LPUSH/RPUSH, LPOP/RPOP) share a handler and branch on cmd
_COMMANDS: dict = {
    "PING": _cmd_ping, "ECHO": _cmd_echo, "SET": _cmd_set,
    "GET": _cmd_get, "DEL": _cmd_del, "EXISTS": _cmd_exists,
    "INCR": _cmd_incr, "DECR": _cmd_incr, "INCRBY": _cmd_incr,
    "DECRBY": _cmd_incr, "EXPIRE": _cmd_expire, "TTL": _cmd_ttl,
    "KEYS": _cmd_keys, "INFO": _cmd_info, "FLUSHDB": _cmd_flushdb,
    "HSET": _cmd_hset, "HGET": _cmd_hget, "HGETALL": _cmd_hgetall,
    "LPUSH": _cmd_push, "RPUSH": _cmd_push, "LPOP": _cmd_pop,
    "RPOP": _cmd_pop, "LRANGE": _cmd_lrange,
}


def _dispatch(store: _Store, cmd: str, args: list[str]) -> Any:
    handler = _COMMANDS.get(cmd)
    if handler is None:
        return _Error(f"ERR unknown command '{cmd}'")
    return handler(store, cmd, args)


class MiniRedis:
    """``run()`` starts the server on an OS-assigned port; ``.port`` is what
    clients dial (parity role: miniredis.Run())."""

    def __init__(self) -> None:
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self.port = 0
        self.store = _Store()

    def run(self) -> "MiniRedis":
        socketserver.ThreadingTCPServer.allow_reuse_address = True
        self._server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Handler)
        self._server.store = self.store  # type: ignore[attr-defined]
        self._server.conns = set()  # type: ignore[attr-defined]
        self._server.conns_lock = threading.Lock()  # type: ignore[attr-defined]
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="gofr-miniredis",
        ).start()
        return self

    def close(self) -> None:
        """Stop listening and cut every open client connection (the JAX
        package's server keeps serving connections it accepted before), so
        a stopped server reads as down to a pooled client."""
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            with self._server.conns_lock:  # type: ignore[attr-defined]
                live = list(self._server.conns)  # type: ignore[attr-defined]
            for sock in live:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
