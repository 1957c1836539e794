"""Fault-injection harness (copy of ``gofr_tpu/devtools/chaos.py``):
multi-replica echo fleets in one process, with deterministic failure
modes, so every routing / retry / breaker / shed decision in
``gofr_tpu_torch/fleet`` is provoked in tier-1 tests without hardware,
sleep-and-hope, or a second process (``SubprocessReplica`` adds the one
fault that needs a process: ``kill -9``).

A :class:`ChaosReplica` is a full serving app (echo runner: the real
batcher → scheduler → decode pool → paged KV path, compile-free) with a
:class:`ChaosController` consulted by an injected middleware. Failure
modes, all armable and clearable at runtime:

- ``error_burst(n, status)`` — the next ``n`` matching requests answer
  ``status`` (5xx bursts; also 429 storms).
- ``stall(seconds)`` — matching requests hang before reaching the
  handler (a wedged replica that still ACCEPTS connections: provokes
  the router's read-timeout retry — the "force-wedged mid-stream"
  acceptance case).
- ``slow_loris(delay_s)`` — streamed responses crawl one chunk per
  ``delay_s`` (client-side read-timeout handling).
- ``disconnect_after(chunks)`` — streamed responses abort mid-body
  after ``chunks`` chunks (truncated SSE: the router must NOT replay a
  stream that already produced client-visible bytes).
- :meth:`ChaosReplica.stop_listener` — the socket goes away entirely
  (connection refused: the fastest failure, and the one that historically
  leaked client connections).
- :meth:`ChaosReplica.wedge` — an injected DEVICE stall via the echo
  runner's ``stall_hook``: the watchdog walks degraded → wedged, the
  replica's own readiness 503s, and the fleet prober takes it out of
  rotation (a tunnel wedge, reproduced on demand).
- :func:`abandoning_client` — a CLIENT-side scenario: open an SSE
  stream over a raw socket, read k frames, hard-close (RST). The
  replica must reclaim the stream's decode slot and paged-KV blocks
  within one chunk (deadline-aware serving acceptance).

``chaos_fleet(n)`` builds N replicas + teardown; ``chaos_router``
fronts them with a wired fleet app. Both swap env vars only around app
CONSTRUCTION (config keys are read at wiring time), so parallel test
workers never see each other's ports.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import socket
import struct
import threading
from typing import Any, Iterator, Optional

from gofr_tpu_torch.http.response import Response

# paths chaos applies to by default: the serving surface, never the
# health/admin plane (the prober must keep seeing the truth unless a
# test explicitly widens the blast radius)
DEFAULT_CHAOS_PATHS = ("/v1/", "/generate", "/infer")
# the KV-transfer pull surface (disaggregated prefill/decode): the
# corrupting proxy targets it by default — KV chaos must break
# TRANSFERS, not the serving plane the fallback path needs
KV_CHAOS_PATHS = ("/admin/kv/",)


class ChaosController:
    """Thread-safe switchboard of armed failure modes.

    ``seed`` makes scenario randomness REPLAYABLE: every randomized
    parameter a controller mode draws (today: the corrupted bit in
    :meth:`corrupting_proxy` ``flip``) comes from :attr:`rng`, never
    from the global ``random`` module — and any future mode wanting
    randomness must do the same — so a failing CI run replays locally
    from the seed recorded in its artifact
    (a fleet simulation's trace and fault schedules derive from the same
    master seed)."""

    def __init__(self, seed: Optional[int] = None) -> None:
        import random

        self.seed = seed
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self._modes: dict[str, dict[str, Any]] = {}
        self.injected: dict[str, int] = {}  # mode -> times fired

    # -- arming ----------------------------------------------------------------
    def arm(self, mode: str, **params: Any) -> None:
        with self._lock:
            self._modes[mode] = params

    def error_burst(self, n: int, status: int = 500,
                    paths: tuple = DEFAULT_CHAOS_PATHS) -> None:
        self.arm("error_burst", remaining=n, status=status, paths=paths)

    def stall(self, seconds: float,
              paths: tuple = DEFAULT_CHAOS_PATHS) -> None:
        self.arm("stall", seconds=seconds, paths=paths)

    def slow_loris(self, delay_s: float,
                   paths: tuple = DEFAULT_CHAOS_PATHS) -> None:
        self.arm("slow_loris", delay_s=delay_s, paths=paths)

    def disconnect_after(self, chunks: int,
                         paths: tuple = DEFAULT_CHAOS_PATHS,
                         shots: Optional[int] = None) -> None:
        """``shots`` bounds how many streamed responses get cut
        (None = every one until cleared). A bounded burst lets a resume
        hunt SUCCEED against the same replica once the shots are spent
        — the fleetsim uses it to exercise mid-stream splicing without
        manufacturing unrecoverable streams."""
        if shots is None:
            self.arm("disconnect_after", chunks=chunks, paths=paths)
        else:
            self.arm("disconnect_after", chunks=chunks, paths=paths,
                     remaining=shots)

    def corrupting_proxy(self, mode: str = "flip", n: int = 1,
                         after_bytes: int = 512, stall_s: float = 5.0,
                         paths: tuple = KV_CHAOS_PATHS) -> None:
        """The KV-transfer failure injector, sitting where a broken
        network element would: the next ``n`` matching STREAMED
        responses are mangled mid-body —

        - ``flip``: one byte past ``after_bytes`` is bit-flipped (the
          receiver's per-block CRC must catch it: outcome ``corrupt``);
        - ``truncate``: the body ends after ``after_bytes`` with no
          trailer frame (donor killed mid-pull: outcome ``corrupt``);
        - ``stall``: every chunk past ``after_bytes`` waits ``stall_s``
          (a wedged donor: the receiver's pull budget expires, outcome
          ``timeout``).

        Defaults target ``/admin/kv/`` only — the serving plane (where
        the local-prefill fallback runs) stays healthy. The flipped
        bit is drawn from the controller's seeded :attr:`rng` at arm
        time: which bit of the payload dies is part of the replayable
        incident, not fresh noise per run."""
        if mode not in ("flip", "truncate", "stall"):
            raise ValueError(
                f"corrupting_proxy mode '{mode}' not supported — use "
                "flip, truncate, or stall"
            )
        self.arm(
            "kv_corrupt", remaining=n, kind=mode,
            after_bytes=after_bytes, stall_s=stall_s, paths=paths,
            xor_mask=1 << self.rng.randint(0, 7),
        )

    def clear(self, mode: Optional[str] = None) -> None:
        with self._lock:
            if mode is None:
                self._modes.clear()
            else:
                self._modes.pop(mode, None)

    # -- middleware-side reads -------------------------------------------------
    def _matches(self, params: dict[str, Any], path: str) -> bool:
        return any(path.startswith(p) for p in params.get("paths", ("/",)))

    def take(self, mode: str, path: str) -> Optional[dict[str, Any]]:
        """Fetch ``mode``'s params when armed for ``path`` (consuming
        one shot from counted modes); None otherwise."""
        with self._lock:
            params = self._modes.get(mode)
            if params is None or not self._matches(params, path):
                return None
            if "remaining" in params:
                if params["remaining"] <= 0:
                    return None
                params["remaining"] -= 1
                if params["remaining"] == 0:
                    self._modes.pop(mode, None)
            self.injected[mode] = self.injected.get(mode, 0) + 1
            return dict(params)

    def peek(self, mode: str, path: str) -> Optional[dict[str, Any]]:
        with self._lock:
            params = self._modes.get(mode)
            if params is None or not self._matches(params, path):
                return None
            return dict(params)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {"armed": {k: dict(v) for k, v in self._modes.items()},
                    "injected": dict(self.injected)}


def chaos_middleware(controller: ChaosController):
    """Router middleware consulting the controller per request — the
    injection point sits where a real failure would: between transport
    and handler (bursts, stalls) or inside the response body stream
    (slow-loris, mid-stream disconnects)."""

    def middleware(next_ep: Any) -> Any:
        async def endpoint(request: Any) -> Response:
            path = request.path
            burst = controller.take("error_burst", path)
            if burst is not None:
                return Response(
                    status=burst["status"],
                    headers={"Content-Type": "application/json",
                             "Retry-After": "1"},
                    body=b'{"error":{"message":"chaos: injected burst"}}',
                )
            stall = controller.take("stall", path)
            if stall is not None:
                # hang while ACCEPTING the connection, re-checking so a
                # cleared stall releases parked requests quickly
                deadline = (asyncio.get_running_loop().time()
                            + float(stall["seconds"]))
                while asyncio.get_running_loop().time() < deadline:
                    if controller.peek("stall", path) is None:
                        break  # cleared: release parked requests
                    await asyncio.sleep(0.02)
            response = await next_ep(request)
            if response.stream is not None:
                loris = controller.take("slow_loris", path)
                cut = controller.take("disconnect_after", path)
                if loris is not None or cut is not None:
                    response.stream = _mangle_stream(
                        response.stream,
                        delay_s=float(loris["delay_s"]) if loris else 0.0,
                        cut_after=int(cut["chunks"]) if cut else -1,
                    )
                corrupt = controller.take("kv_corrupt", path)
                if corrupt is not None:
                    response.stream = _corrupt_stream(
                        response.stream,
                        mode=corrupt["kind"],
                        after_bytes=int(corrupt["after_bytes"]),
                        stall_s=float(corrupt["stall_s"]),
                        xor_mask=int(corrupt.get("xor_mask", 0x40)),
                    )
            return response

        return endpoint

    return middleware


async def _mangle_stream(stream: Any, delay_s: float,
                         cut_after: int) -> Any:
    """Slow-loris and/or mid-body disconnect over an async chunk
    iterator. Raising inside the iterator makes the server abort the
    transport WITHOUT the terminal chunk — exactly what a yanked
    network cable produces on the wire."""
    sent = 0
    async for chunk in stream:
        if cut_after >= 0 and sent >= cut_after:
            raise ConnectionResetError("chaos: injected mid-stream disconnect")
        if delay_s:
            await asyncio.sleep(delay_s)
        yield chunk
        sent += 1


async def _corrupt_stream(stream: Any, mode: str, after_bytes: int,
                          stall_s: float, xor_mask: int = 0x40) -> Any:
    """The :meth:`ChaosController.corrupting_proxy` byte-mangler,
    applied to one streamed response body. ``flip`` XORs ``xor_mask``
    (drawn from the controller's seeded rng at arm time) into the
    first byte past ``after_bytes`` (every later chunk passes
    untouched — the receiver must localize the damage via its per-block
    CRC); ``truncate`` ends the body there with a CLEAN end-of-stream
    (no exception: the trailer frame is simply missing, exactly what a
    killed donor process leaves on the wire); ``stall`` delays every
    chunk past the mark by ``stall_s`` (a wedged donor: the puller's
    overall budget, not its between-chunk socket timeout, must catch
    it)."""
    sent = 0
    mangled = False
    async for chunk in stream:
        if sent >= after_bytes:
            if mode == "truncate":
                return
            if mode == "stall":
                await asyncio.sleep(stall_s)
            elif mode == "flip" and not mangled and chunk:
                chunk = bytes([chunk[0] ^ xor_mask]) + chunk[1:]
                mangled = True
        sent += len(chunk)
        yield chunk


def abandoning_client(
    base_url: str, path: str, body: bytes, frames: int,
    headers: Optional[dict[str, str]] = None, timeout_s: float = 15.0,
) -> list[bytes]:
    """The client-abort chaos scenario: POST an SSE request over a raw
    socket, read ``frames`` complete SSE events off the wire, then
    HARD-close the connection (SO_LINGER 0 → TCP RST — the abrupt
    vanish of a killed browser tab, not a polite FIN). Returns the raw
    event blocks read before the abort.

    The replica under test must then free the stream's decode slot and
    paged-KV blocks within one chunk: the server's next write fails,
    the responder's abort hook trips the generation's stop event, and
    the KV free-block count returns to baseline
    (``gofr_tpu_cancellations_total{cause=client_abort}`` counts it)."""
    from urllib.parse import urlparse

    parsed = urlparse(base_url)
    sock = socket.create_connection(
        (parsed.hostname, parsed.port), timeout=timeout_s
    )
    try:
        head = [
            f"POST {path} HTTP/1.1",
            f"Host: {parsed.hostname}:{parsed.port}",
            "Content-Type: application/json",
            f"Content-Length: {len(body)}",
        ]
        for name, value in (headers or {}).items():
            head.append(f"{name}: {value}")
        sock.sendall(
            ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body
        )
        # read until `frames` complete SSE events (\n\n separators)
        # arrive past the response head; the chunked framing rides
        # inside buf — event boundaries are all this client needs
        buf = b""
        events: list[bytes] = []
        body_started = False
        while len(events) < frames:
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
            if not body_started:
                split = buf.find(b"\r\n\r\n")
                if split < 0:
                    continue
                buf = buf[split + 4:]
                body_started = True
            while len(events) < frames:
                idx = buf.find(b"\n\n")
                if idx < 0:
                    break
                events.append(buf[:idx + 2])
                buf = buf[idx + 2:]
        # HARD close: linger 0 turns close() into an immediate RST —
        # the server's next chunk write fails instead of buffering
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
    finally:
        sock.close()
    return events


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _env_overrides(overrides: dict[str, str]) -> Iterator[None]:
    """Apply env overrides for the duration (app construction reads
    config then); ``None`` values unset keys. Restores on exit."""
    old = {k: os.environ.get(k) for k in overrides}
    for key, value in overrides.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


class ChaosReplica:
    """One in-process echo serving replica with its chaos switchboard."""

    def __init__(self, name: str, app: Any, chaos: ChaosController,
                 port: int):
        self.name = name
        self.app = app
        self.chaos = chaos
        self.port = port

    @property
    def address(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- listener-level chaos --------------------------------------------------
    def stop_listener(self) -> None:
        """Connection refused: the socket goes away, the app object (and
        its engine) stays alive for a later :meth:`start_listener`."""
        if self.app.http_server is not None:
            self.app.http_server.shutdown()
            self.app.http_server = None

    def start_listener(self) -> None:
        from gofr_tpu_torch.http.server import HTTPServer

        if self.app.http_server is None:
            self.app.http_server = HTTPServer(
                self.app.router, self.port, self.app.logger
            )
            self.app.http_server.run_in_thread()

    # -- device-level chaos ----------------------------------------------------
    def wedge(self, seconds: Optional[float] = None) -> None:
        """Inject a device stall: the NEXT dispatch blocks on an
        internal latch — until :meth:`recover` releases it, or
        ``seconds`` elapse (None = held until recovered). With the
        watchdog armed the replica walks degraded → wedged and its
        readiness 503s; with the recovery supervisor on, the engine
        then quarantines the stuck dispatch and rebuilds. The paired
        wedge()/recover() controls make the WHOLE recovery loop
        testable compile-free — chaos can heal, not just break."""
        release = threading.Event()
        self._wedge_release = release
        tpu = self.app.container.tpu
        tpu.runner.stall_hook = lambda: release.wait(seconds)

    def recover(self) -> None:
        """Un-wedge: release every dispatch parked on the latch and
        clear the hook. After a recovery rebuild the CURRENT runner is
        a fresh object (hook already gone) — this still frees the OLD
        stack's stuck dispatch thread so tests never leak it."""
        release = getattr(self, "_wedge_release", None)
        if release is not None:
            release.set()
        runner = getattr(self.app.container.tpu, "runner", None)
        if runner is not None:
            runner.stall_hook = None

    def unwedge(self) -> None:
        """Back-compat alias for :meth:`recover`."""
        self.recover()

    def close(self) -> None:
        self.app.shutdown()


def build_replica(name: str, env: Optional[dict[str, str]] = None,
                  port: Optional[int] = None,
                  seed: Optional[int] = None) -> ChaosReplica:
    """One echo replica app: real serving surface (OpenAI routes +
    ``/generate``), chaos middleware armed, watchdog on a short leash so
    injected device stalls flip the state machine within test budgets."""
    import gofr_tpu_torch
    from gofr_tpu_torch.openai import register_openai_routes

    port = port or _free_port()
    overrides: dict[str, Any] = {
        "HTTP_PORT": str(port),
        "MODEL_NAME": "echo",
        "LOG_LEVEL": "FATAL",
        "BATCH_MAX_SIZE": "4",
        "BATCH_TIMEOUT_MS": "1",
        "WATCHDOG_DISPATCH_TIMEOUT_S": "0.2",
        # recovery on a test leash: rebuild attempts back off in
        # fractions of a second so wedge->recover e2e fits test budgets
        "RECOVERY_BACKOFF_S": "0.1",
        "TIMEBASE_ENABLED": "off",
        # chaos replicas model a fleet behind the router on a trusted
        # segment, so the router's X-KV-Donor stamp is honored; pass
        # "off" in env to exercise the untrusted default posture
        "KV_TRANSFER_TRUST_HINT": "on",
    }
    overrides.update(env or {})
    chaos = ChaosController(seed=seed)
    with _env_overrides(overrides):
        app = gofr_tpu_torch.new()
        app.router.use(chaos_middleware(chaos))
        register_openai_routes(app)
        app.post("/generate", _generate_handler)
        app.start()
    return ChaosReplica(name, app, chaos, port)


def _generate_handler(ctx: Any) -> Any:
    """Minimal token-in/token-out surface for fleet tests: reserves real
    paged-KV blocks for the full generation like any decode. Honors the
    router's ``X-KV-Donor`` stamp the same way the OpenAI admission path
    does, so disaggregated-transfer e2es drive the real pull path."""
    from gofr_tpu_torch.fleet.kvwire import activate_kv_hint, parse_kv_hint
    from gofr_tpu_torch.telemetry import activate_origin, origin_from_headers

    activate_kv_hint(parse_kv_hint(ctx.request.header("X-KV-Donor")))
    # fleet origin, same as the OpenAI admission gate: stamp the
    # router's request id + hop block onto any flight record this
    # generation starts, so fleet-trace e2es work over /generate too
    activate_origin(origin_from_headers(
        ctx.request.header("X-Gofr-Request-Id"),
        ctx.request.header("X-Gofr-Hop"),
    ))
    body = ctx.bind() if ctx.request.body else {}
    tokens = body.get("tokens") or [1, 2, 3]
    max_new = int(body.get("max_new_tokens") or 8)
    out = ctx.tpu.generate(tokens, max_new_tokens=max_new)
    return {"tokens": out, "count": len(out)}


class SubprocessReplica:
    """A replica in its OWN OS process — the only honest substrate for
    the ``kill -9`` fault. Runs ``gofr_tpu_torch.devtools.replica_proc``
    under a :class:`~gofr_tpu_torch.devtools.supervise.Supervisor` (so the
    kill is followed by a respawn on the SAME port, rehydrating the
    journal WAL when ``JOURNAL_DIR`` is set) and presents the same
    ``name``/``address`` surface as :class:`ChaosReplica` so
    ``chaos_router`` fronts both kinds interchangeably."""

    def __init__(self, name: str, env: Optional[dict[str, str]] = None,
                 port: Optional[int] = None, supervise: bool = True,
                 backoff_s: float = 0.2, backoff_max_s: float = 1.0,
                 max_restarts_in_window: int = 10):
        import sys

        from gofr_tpu_torch.config import environ_snapshot
        from gofr_tpu_torch.devtools.supervise import Supervisor

        self.name = name
        self.port = port or _free_port()
        child_env = environ_snapshot()
        # the child must import the package whatever the caller's cwd is
        # (tests chdir into tmp dirs): prepend the package's parent to
        # PYTHONPATH explicitly instead of relying on an installed copy
        import gofr_tpu_torch as _pkg

        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)
        ))
        existing = child_env.get("PYTHONPATH", "")
        child_env["PYTHONPATH"] = (
            repo_root + (os.pathsep + existing if existing else "")
        )
        child_env.update({
            "HTTP_PORT": str(self.port),
                "MODEL_NAME": "echo",
            "LOG_LEVEL": "FATAL",
            "BATCH_MAX_SIZE": "4",
            "BATCH_TIMEOUT_MS": "1",
            "WATCHDOG_DISPATCH_TIMEOUT_S": "0.2",
            "RECOVERY_BACKOFF_S": "0.1",
            "TIMEBASE_ENABLED": "off",
            "KV_TRANSFER_TRUST_HINT": "on",
        })
        child_env.update(env or {})
        argv = [sys.executable, "-m", "gofr_tpu_torch.devtools.replica_proc"]
        self.supervisor = Supervisor(
            argv, env=child_env, backoff_s=backoff_s,
            backoff_max_s=backoff_max_s,
            max_restarts_in_window=max_restarts_in_window,
        ) if supervise else None
        self._argv, self._env = argv, child_env
        self._bare_proc = None

    @property
    def address(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "SubprocessReplica":
        import subprocess

        if self.supervisor is not None:
            self.supervisor.start()
        else:
            self._bare_proc = subprocess.Popen(
                self._argv, env=self._env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
        return self

    @property
    def pid(self) -> Optional[int]:
        if self.supervisor is not None:
            return self.supervisor.pid
        return self._bare_proc.pid if self._bare_proc is not None else None

    def wait_ready(self, timeout_s: float = 30.0) -> None:
        """Block until the child's readiness answers 200 (cold boot or
        post-kill respawn)."""
        import time
        import urllib.request

        deadline = time.monotonic() + timeout_s
        last: Optional[str] = None
        while time.monotonic() < deadline:
            try:
                req = urllib.request.Request(
                    self.address + "/.well-known/ready"
                )
                with urllib.request.urlopen(req, timeout=2) as resp:
                    if resp.status == 200:
                        return
                    last = f"ready {resp.status}"
            except Exception as exc:
                last = f"{type(exc).__name__}: {exc}"
            time.sleep(0.05)
        raise TimeoutError(
            f"subprocess replica {self.name} never became ready: {last}"
        )

    def kill9(self) -> Optional[int]:
        """SIGKILL the child process (the process-death fault). With a
        supervisor, a fresh process respawns on the same port after the
        backoff; without one, the address stays dead."""
        if self.supervisor is not None:
            return self.supervisor.kill9()
        import os as _os
        import signal as _signal

        if self._bare_proc is not None and self._bare_proc.poll() is None:
            pid = self._bare_proc.pid
            _os.kill(pid, _signal.SIGKILL)
            return pid
        return None

    def close(self) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
        elif self._bare_proc is not None:
            try:
                self._bare_proc.terminate()
                self._bare_proc.wait(timeout=5)
            except Exception:
                try:
                    self._bare_proc.kill()
                    self._bare_proc.wait(timeout=5)
                except Exception:
                    pass


@contextlib.contextmanager
def subprocess_replica(name: str = "sp0",
                       env: Optional[dict[str, str]] = None,
                       supervise: bool = True,
                       **kw: Any) -> Iterator[SubprocessReplica]:
    """One started-and-ready subprocess replica, torn down on exit."""
    replica = SubprocessReplica(name, env=env, supervise=supervise, **kw)
    replica.start()
    try:
        replica.wait_ready()
        yield replica
    finally:
        replica.close()


@contextlib.contextmanager
def chaos_fleet(n: int = 3, env: Optional[dict[str, str]] = None,
                per_replica_env: Optional[list[dict[str, str]]] = None,
                seed: Optional[int] = None
                ) -> Iterator[list[ChaosReplica]]:
    """N echo replicas, torn down in reverse on exit. ``seed`` derives
    one replayable sub-seed per replica's :class:`ChaosController`
    (``seed + index`` — deterministic AND distinct streams)."""
    replicas: list[ChaosReplica] = []
    try:
        for i in range(n):
            merged = dict(env or {})
            if per_replica_env and i < len(per_replica_env):
                merged.update(per_replica_env[i])
            replicas.append(build_replica(
                f"r{i}", env=merged,
                seed=None if seed is None else seed + i,
            ))
        yield replicas
    finally:
        for replica in reversed(replicas):
            try:
                replica.close()
            except Exception:
                pass


@contextlib.contextmanager
def chaos_router(replicas: list[ChaosReplica],
                 env: Optional[dict[str, str]] = None) -> Iterator[Any]:
    """A fleet router app fronting ``replicas`` (names preserved, so
    ``/admin/fleet`` talks about r0/r1/r2). Yields the started app;
    ``app.container.fleet`` is the FleetRouter."""
    import gofr_tpu_torch
    from gofr_tpu_torch.fleet import wire_fleet

    spec = ",".join(f"{r.name}={r.address}" for r in replicas)
    overrides: dict[str, Any] = {
        "HTTP_PORT": str(_free_port()),
        "LOG_LEVEL": "FATAL",
        "TIMEBASE_ENABLED": "off",
        "MODEL_NAME": None,  # the router serves no model of its own
        "TPU_ENABLED": None,
        "FLEET_REPLICAS": spec,
        "FLEET_PROBE_INTERVAL_S": "0.05",
        "FLEET_PROBE_TIMEOUT_S": "1",
        "FLEET_RETRIES": "2",
        "FLEET_DEADLINE_S": "10",
        "FLEET_CONNECT_TIMEOUT_S": "1",
        "FLEET_READ_TIMEOUT_S": "5",
    }
    overrides.update(env or {})
    with _env_overrides(overrides):
        app = gofr_tpu_torch.new()
        wire_fleet(app)
        app.start()
    try:
        yield app
    finally:
        app.shutdown()
