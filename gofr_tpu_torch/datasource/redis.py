"""Redis datasource: a from-scratch RESP2 client with command logging,
tracing, pooling, and health checks (copy of ``gofr_tpu/datasource/redis.py``).

Parity: GoFr's pkg/gofr/datasource/redis/redis.go:16-58 (connect
with 5s ping timeout :29-57, otel tracing instrument :48), hook.go:13-58
(per-command log entry with args + µs), health.go:10-30 (INFO-backed
Health). The environment has no redis-py, so the protocol layer is
implemented here directly (RESP2 encode/decode over TCP) — the same
miniredis-style strategy the reference uses for tests applies via
``gofr_tpu_torch.datasource.miniredis``.
"""

from __future__ import annotations

import queue
import socket
import time
from dataclasses import dataclass
from typing import Any, Optional

from gofr_tpu_torch.datasource.health import DOWN, UP, Health
from gofr_tpu_torch.tracing import get_tracer


@dataclass
class RedisLog:
    """Typed command log (parity: redis/hook.go:25-31)."""

    command: str
    duration_us: int

    def pretty_terminal(self) -> str:
        return f"\x1b[35mREDIS\x1b[0m [{self.command}] {self.duration_us}µs"

    def log_fields(self) -> dict[str, Any]:
        return {"datasource": "redis", "command": self.command, "duration_us": self.duration_us}


class RedisError(Exception):
    pass


class RedisServerError(RedisError):
    """A ``-ERR ...`` reply: the server answered, the connection is fine."""


class _Connection:
    def __init__(self, host: str, port: int, timeout: float):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.buf = b""

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    # -- RESP2 wire format ---------------------------------------------------
    @staticmethod
    def encode_command(args: tuple) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for arg in args:
            if isinstance(arg, bytes):
                data = arg
            elif isinstance(arg, str):
                data = arg.encode("utf-8")
            elif isinstance(arg, (int, float)):
                data = str(arg).encode()
            else:
                data = str(arg).encode("utf-8")
            out.append(b"$%d\r\n%s\r\n" % (len(data), data))
        return b"".join(out)

    def send_command(self, args: tuple) -> None:
        self.sock.sendall(self.encode_command(args))

    def _read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise RedisError("connection closed by server")
            self.buf += chunk
        line, _, self.buf = self.buf.partition(b"\r\n")
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self.buf) < n + 2:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise RedisError("connection closed by server")
            self.buf += chunk
        data, self.buf = self.buf[:n], self.buf[n + 2:]
        return data

    def read_reply(self) -> Any:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode("utf-8")
        if kind == b"-":
            raise RedisServerError(rest.decode("utf-8"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self.read_reply() for _ in range(n)]
        raise RedisError(f"unexpected RESP type: {line[:32]!r}")


class _Commands:
    """Command surface shared by the client (immediate execution) and
    Pipeline (queued execution): each method routes through ``_do``."""

    def _do(self, *args: Any) -> Any:
        raise NotImplementedError

    def get(self, key: str) -> Any:
        return self._do("GET", key)

    def set(self, key: str, value: Any, ex: Optional[int] = None) -> Any:
        if ex is not None:
            return self._do("SET", key, value, "EX", ex)
        return self._do("SET", key, value)

    def delete(self, *keys: str) -> int:
        return self._do("DEL", *keys)

    def exists(self, *keys: str) -> int:
        return self._do("EXISTS", *keys)

    def incr(self, key: str) -> int:
        return self._do("INCR", key)

    def expire(self, key: str, seconds: int) -> int:
        return self._do("EXPIRE", key, seconds)

    def ttl(self, key: str) -> int:
        return self._do("TTL", key)

    def keys(self, pattern: str = "*") -> list:
        return self._do("KEYS", pattern)

    def hset(self, key: str, field: str, value: Any) -> int:
        return self._do("HSET", key, field, value)

    def hget(self, key: str, field: str) -> Any:
        return self._do("HGET", key, field)

    def lpush(self, key: str, *values: Any) -> int:
        return self._do("LPUSH", key, *values)

    def rpop(self, key: str) -> Any:
        return self._do("RPOP", key)

    def flushdb(self) -> Any:
        return self._do("FLUSHDB")


class RedisClient(_Commands):
    """Thread-safe pooled client. Commands return decoded replies (bulk
    strings as ``str`` where valid UTF-8, else bytes)."""

    def __init__(
        self,
        host: str,
        port: int = 6379,
        logger: Any = None,
        timeout: float = 5.0,  # parity: redis/redis.go:14 5s ping timeout
        pool_size: int = 8,
        decode: bool = True,
    ):
        self.host = host
        self.port = port
        self.logger = logger
        self.timeout = timeout
        self.decode = decode
        self._pool: "queue.Queue[_Connection]" = queue.Queue(maxsize=pool_size)
        self._pool_size = pool_size
        self._created = 0
        # connect + ping eagerly (parity: redis.go:41-46 — fail fast so the
        # container can log-and-degrade)
        conn = self._connect()
        self._put(conn)
        self.execute("PING")

    def _connect(self) -> _Connection:
        return _Connection(self.host, self.port, self.timeout)

    def _get(self) -> _Connection:
        try:
            return self._pool.get_nowait()
        except queue.Empty:
            return self._connect()

    def _put(self, conn: _Connection) -> None:
        try:
            self._pool.put_nowait(conn)
        except queue.Full:
            conn.close()

    # -- generic command execution ------------------------------------------
    def execute(self, *args: Any) -> Any:
        command = " ".join(str(a) for a in args)
        start = time.perf_counter()
        span = get_tracer().start_span(f"redis-{str(args[0]).lower()}", activate=False)
        span.set_tag("db.system", "redis")
        span.set_tag("db.statement", command[:256])
        conn = self._get()
        try:
            conn.send_command(args)
            reply = conn.read_reply()
            self._put(conn)
        except RedisServerError:
            self._put(conn)  # server replied; connection still healthy
            raise
        except (OSError, RedisError) as exc:
            conn.close()
            raise RedisError(f"redis {args[0]}: {exc}") from exc
        finally:
            span.end()
            if self.logger is not None:
                elapsed_us = int((time.perf_counter() - start) * 1e6)
                self.logger.debug(RedisLog(command=command[:128], duration_us=elapsed_us))
        return self._decode(reply)

    def _decode(self, reply: Any) -> Any:
        if not self.decode:
            return reply
        if isinstance(reply, bytes):
            try:
                return reply.decode("utf-8")
            except UnicodeDecodeError:
                return reply
        if isinstance(reply, list):
            return [self._decode(r) for r in reply]
        return reply

    # -- convenience commands route through _Commands -------------------------
    def _do(self, *args: Any) -> Any:
        return self.execute(*args)

    def ping(self) -> bool:
        return self.execute("PING") == "PONG"

    # -- pipelining (parity: redis/hook.go:38-58 logs pipelined batches) ------
    def pipeline(self) -> "Pipeline":
        """Queue commands and flush them in ONE round trip::

            with r.pipeline() as p:
                p.set("a", 1)
                p.incr("counter")
            # p.results == ["OK", 2]

        or explicitly: ``results = p.execute()``."""
        return Pipeline(self)

    def _execute_pipeline(self, cmds: list[tuple], raise_on_error: bool) -> list:
        """Send every queued command in one write, then read all replies —
        one round trip total. Per-command server errors are captured (all
        replies are always drained) and re-raised after the batch unless
        ``raise_on_error=False``."""
        if not cmds:
            return []
        summary = f"pipeline[{len(cmds)}] " + " | ".join(
            " ".join(str(a) for a in cmd)[:48] for cmd in cmds[:8]
        )
        start = time.perf_counter()
        span = get_tracer().start_span("redis-pipeline", activate=False)
        span.set_tag("db.system", "redis")
        span.set_tag("db.statement", summary[:256])
        span.set_tag("db.redis.pipeline_length", len(cmds))
        conn = self._get()
        try:
            conn.sock.sendall(b"".join(_Connection.encode_command(c) for c in cmds))
            replies: list[Any] = []
            for _ in cmds:
                try:
                    replies.append(conn.read_reply())
                except RedisServerError as exc:
                    replies.append(exc)
            self._put(conn)
        except (OSError, RedisError) as exc:
            conn.close()
            raise RedisError(f"redis pipeline: {exc}") from exc
        finally:
            span.end()
            if self.logger is not None:
                elapsed_us = int((time.perf_counter() - start) * 1e6)
                self.logger.debug(RedisLog(command=summary[:128], duration_us=elapsed_us))
        results = [
            r if isinstance(r, RedisServerError) else self._decode(r) for r in replies
        ]
        if raise_on_error:
            for r in results:
                if isinstance(r, RedisServerError):
                    raise r
        return results

    # -- health (parity: redis/health.go:10-30) -------------------------------
    def health_check(self) -> Health:
        try:
            start = time.perf_counter()
            info_raw = self.execute("INFO")
            latency_us = int((time.perf_counter() - start) * 1e6)
            details: dict[str, Any] = {
                "host": f"{self.host}:{self.port}",
                "latency_us": latency_us,
            }
            if isinstance(info_raw, str):
                for line in info_raw.splitlines():
                    if line.startswith(("redis_version", "connected_clients", "used_memory:")):
                        key, _, value = line.partition(":")
                        details[key] = value.strip()
            return Health(UP, details)
        except Exception as exc:
            return Health(DOWN, {"host": f"{self.host}:{self.port}", "error": str(exc)})

    def close(self) -> None:
        while True:
            try:
                self._pool.get_nowait().close()
            except queue.Empty:
                break


class Pipeline(_Commands):
    """Queued command batch; ``execute()`` (or clean ``with``-exit) flushes
    everything in one round trip. Command methods return the pipeline for
    chaining; replies come back as a list in command order."""

    def __init__(self, client: RedisClient):
        self._client = client
        self._cmds: list[tuple] = []
        self.results: Optional[list] = None

    def _do(self, *args: Any) -> "Pipeline":
        self._cmds.append(args)
        return self

    def command(self, *args: Any) -> "Pipeline":
        """Queue an arbitrary command (the generic escape hatch)."""
        return self._do(*args)

    def __len__(self) -> int:
        return len(self._cmds)

    def execute(self, raise_on_error: bool = True) -> list:
        cmds, self._cmds = self._cmds, []
        self.results = self._client._execute_pipeline(cmds, raise_on_error)
        return self.results

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.execute()


def new_client(host: str, port: int = 6379, logger: Any = None) -> RedisClient:
    """Parity: redis/redis.go:29."""
    return RedisClient(host, port, logger)
