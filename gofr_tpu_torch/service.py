"""Inter-service HTTP client (copy of ``gofr_tpu/service.py``): named
downstream services with uniform logging, tracing and correlation-ID
propagation. ``HTTPService`` has the ten-method surface (``get``, ``post``,
``put``, ``patch``, ``delete``, each also ``*_with_headers``), their
``async_*`` forms for async handlers, ``request``, ``stream`` and
``health_check``; ``new_http_service`` builds one and
``App.add_http_service`` registers it for ``ctx.get_http_service``. The
request bytes on the wire are the JAX client's.

- **connect/read timeout split**: ``connect_timeout`` bounds TCP
  establishment (default 5 s), ``read_timeout`` each response read
  (default 30 s); every call can override both.
- **bounded retries with decorrelated-jitter backoff**: ``retries=N``
  re-attempts connect errors, read timeouts and 502/503/504 replies for
  idempotent methods (``retryable=True`` opts a POST in); sleeps follow
  ``min(cap, uniform(base, 3*prev))``; ``deadline_s`` caps the total.
- **no leaked connections**: each attempt runs on its own
  ``http.client`` connection, closed in a ``finally``.
- **streaming**: :meth:`HTTPService.stream` returns status and headers as
  soon as they arrive and an iterator over raw body chunks (the router's
  SSE passthrough, the KV pull).
- **redirects**: GET/HEAD follow up to 3 ``Location`` hops; other
  methods return the 3xx raw.
"""

from __future__ import annotations

import http.client
import json as _json
import random
import time
import urllib.parse
from dataclasses import dataclass
from typing import Any, Iterator, Optional

from gofr_tpu_torch.datasource.health import DOWN, UP, Health
from gofr_tpu_torch.tracing import CLIENT, get_tracer

DEFAULT_CONNECT_TIMEOUT_S = 5.0
DEFAULT_READ_TIMEOUT_S = 30.0

# statuses a retry may help with: the upstream answered but couldn't
# serve (gateway errors / overload) — 4xx replies are the caller's bug
# and never retried
RETRYABLE_STATUSES = frozenset({502, 503, 504})

# methods safe to replay without caller opt-in (RFC 9110 §9.2.2)
IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "PUT", "DELETE", "OPTIONS"})

# the old urllib path auto-followed redirects; the http.client rewrite
# preserves that for SAFE methods only — replaying a POST across a 3xx
# is the caller's decision, not the client's
REDIRECT_STATUSES = frozenset({301, 302, 303, 307, 308})
REDIRECT_METHODS = frozenset({"GET", "HEAD"})
MAX_REDIRECTS = 3

# decorrelated-jitter backoff constants (AWS architecture-blog rule):
# sleep_n = min(cap, uniform(base, 3 * sleep_{n-1}))
BACKOFF_BASE_S = 0.05
BACKOFF_CAP_S = 2.0


@dataclass
class ServiceLog:
    """Typed outbound-call log entry (parity: service/logger.go:5-21)."""

    correlation_id: str
    service: str
    method: str
    uri: str
    status: int
    response_time_us: int
    attempts: int = 1

    def pretty_terminal(self) -> str:
        color = 32 if 0 < self.status < 400 else 31
        retry = f" ({self.attempts} attempts)" if self.attempts > 1 else ""
        return (
            f"\x1b[{color}m{self.status}\x1b[0m "
            f"{self.method:<7s} {self.uri} {self.response_time_us}µs "
            f"[svc {self.service}]{retry}"
        )

    def log_fields(self) -> dict[str, Any]:
        return {
            "correlation_id": self.correlation_id,
            "service": self.service,
            "method": self.method,
            "uri": self.uri,
            "status": self.status,
            "response_time_us": self.response_time_us,
            "attempts": self.attempts,
        }


class ServiceResponse:
    """Parity: service/response.go:5-17."""

    def __init__(self, status_code: int, body: bytes, headers: dict[str, str]):
        self.status_code = status_code
        self.body = body
        self.headers = headers

    def json(self) -> Any:
        return _json.loads(self.body.decode("utf-8") or "null")


class StreamingServiceResponse:
    """A response whose body is consumed incrementally: status + headers
    are available immediately; :meth:`iter_chunks` yields raw body bytes
    as the upstream produces them. The caller owns the connection and
    MUST exhaust the iterator or call :meth:`close` (both release it)."""

    def __init__(self, status_code: int, headers: dict[str, str],
                 resp: Any, conn: Any):
        self.status_code = status_code
        self.headers = headers
        self._resp = resp
        self._conn = conn
        self._closed = False

    def iter_chunks(self, size: int = 8192) -> Iterator[bytes]:
        # read1, not read: read(size) BLOCKS until `size` bytes (or EOF)
        # accumulate, which turned an SSE passthrough into an 8 KiB
        # store-and-forward buffer — every proxied token waited for the
        # whole stream on short responses. read1 returns as soon as the
        # socket has ANY bytes, so each upstream flush reaches the
        # client (and the router's resume journal) immediately.
        read1 = getattr(self._resp, "read1", None)
        try:
            while True:
                chunk = (
                    read1(size) if read1 is not None
                    else self._resp.read(size)
                )
                if not chunk:
                    break
                yield chunk
        finally:
            self.close()

    def read(self, budget_s: Optional[float] = None) -> bytes:
        """Drain the remaining body (non-streaming consumption).
        ``budget_s`` bounds the TOTAL drain time — callers draining an
        error body from an untrusted upstream must pass it, or a
        drip-fed body pins the thread (see :func:`_read_body`)."""
        try:
            if budget_s is None:
                return self._resp.read()
            return _read_body(self._resp, self._conn.sock, budget_s)
        finally:
            self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._conn.close()
        except OSError:
            pass


class ServiceCallError(Exception):
    """The downstream never produced a usable reply. Carries the total
    elapsed time and how many attempts were burned — the fleet router's
    deadline budgeting and breaker accounting read both."""

    status_code = 502

    def __init__(self, service: str, uri: str, cause: Exception,
                 elapsed_s: float = 0.0, attempts: int = 1):
        super().__init__(
            f"call to service '{service}' failed after "
            f"{attempts} attempt(s) in {elapsed_s * 1000:.0f}ms: {cause}"
        )
        self.service = service
        self.uri = uri
        self.cause = cause
        self.elapsed_s = elapsed_s
        self.attempts = attempts


class _ConnectError(Exception):
    """Internal marker: the failure happened before the request was on
    the wire (always safe to retry, even for non-idempotent methods)."""

    def __init__(self, cause: Exception):
        super().__init__(str(cause))
        self.cause = cause


def _read_body(resp: Any, sock: Any, read_timeout: float) -> bytes:
    """Read a buffered response body under a TOTAL ``read_timeout``
    budget. Socket timeouts are per-``recv``, so a drip-fed body (one
    byte every few seconds — a broken or malicious upstream) would
    reset the clock forever and pin the calling thread; here the
    remaining budget shrinks the socket timeout before each ``read1``
    (at most one ``recv`` per call) and the read aborts when it hits
    zero. Streaming consumers (:meth:`HTTPService.stream`) are exempt
    by design — an SSE body is SUPPOSED to stay open."""
    deadline = time.perf_counter() + read_timeout
    read1 = getattr(resp, "read1", None)
    if read1 is None:  # non-buffered fake in tests: single bounded read
        return resp.read()
    chunks: list[bytes] = []
    while True:
        remaining = deadline - time.perf_counter()
        if remaining <= 0:
            raise TimeoutError(
                f"response body exceeded the {read_timeout}s read budget"
            )
        if sock is not None:
            sock.settimeout(remaining)
        chunk = read1(1 << 16)
        if not chunk:
            return b"".join(chunks)
        chunks.append(chunk)


def backoff_delays(retries: int, base: float = BACKOFF_BASE_S,
                   cap: float = BACKOFF_CAP_S) -> Iterator[float]:
    """Decorrelated-jitter delays: each sleep is drawn from
    ``uniform(base, 3 * previous)`` capped at ``cap`` — retry storms from
    many clients decorrelate instead of synchronizing into waves."""
    sleep = base
    for _ in range(retries):
        sleep = min(cap, random.uniform(base, max(base, sleep * 3)))
        yield sleep


class HTTPService:
    """A named downstream-service client (parity: service/new.go:18-23)."""

    def __init__(self, address: str, logger: Any, name: str = "",
                 timeout: float = DEFAULT_READ_TIMEOUT_S,
                 connect_timeout: Optional[float] = None,
                 read_timeout: Optional[float] = None,
                 retries: int = 0):
        if "://" not in address:
            address = "http://" + address
        self.address = address.rstrip("/")
        self.logger = logger
        self.name = name or self.address
        # back-compat: ``timeout`` is the legacy flat knob and seeds the
        # read timeout; the split knobs win when given explicitly
        self.timeout = timeout
        self.connect_timeout = (
            connect_timeout if connect_timeout is not None
            else min(DEFAULT_CONNECT_TIMEOUT_S, timeout)
        )
        self.read_timeout = read_timeout if read_timeout is not None else timeout
        self.retries = retries

    # -- the 10-method HTTP interface (parity: new.go:25-54) -----------------
    def get(self, path: str, params: Optional[dict] = None) -> ServiceResponse:
        return self.request("GET", path, params, None, None)

    def get_with_headers(self, path: str, params: Optional[dict], headers: dict) -> ServiceResponse:
        return self.request("GET", path, params, None, headers)

    def post(self, path: str, params: Optional[dict] = None, body: Any = None) -> ServiceResponse:
        return self.request("POST", path, params, body, None)

    def post_with_headers(self, path, params, body, headers) -> ServiceResponse:
        return self.request("POST", path, params, body, headers)

    def put(self, path: str, params: Optional[dict] = None, body: Any = None) -> ServiceResponse:
        return self.request("PUT", path, params, body, None)

    def put_with_headers(self, path, params, body, headers) -> ServiceResponse:
        return self.request("PUT", path, params, body, headers)

    def patch(self, path: str, params: Optional[dict] = None, body: Any = None) -> ServiceResponse:
        return self.request("PATCH", path, params, body, None)

    def patch_with_headers(self, path, params, body, headers) -> ServiceResponse:
        return self.request("PATCH", path, params, body, headers)

    def delete(self, path: str, body: Any = None) -> ServiceResponse:
        return self.request("DELETE", path, None, body, None)

    def delete_with_headers(self, path, body, headers) -> ServiceResponse:
        return self.request("DELETE", path, None, body, headers)

    # -- async variants -------------------------------------------------------
    # The sync methods block; calling them from an ``async def`` handler
    # would stall the server's event loop. Async handlers must use these.
    async def async_get(self, path: str, params: Optional[dict] = None) -> ServiceResponse:
        return await self._offload(self.get, path, params)

    async def async_post(self, path: str, params: Optional[dict] = None,
                         body: Any = None) -> ServiceResponse:
        return await self._offload(self.post, path, params, body)

    async def async_put(self, path: str, params: Optional[dict] = None,
                        body: Any = None) -> ServiceResponse:
        return await self._offload(self.put, path, params, body)

    async def async_patch(self, path: str, params: Optional[dict] = None,
                          body: Any = None) -> ServiceResponse:
        return await self._offload(self.patch, path, params, body)

    async def async_delete(self, path: str, body: Any = None) -> ServiceResponse:
        return await self._offload(self.delete, path, body)

    @staticmethod
    async def _offload(fn: Any, *args: Any) -> ServiceResponse:
        import asyncio
        import contextvars

        loop = asyncio.get_running_loop()
        call = contextvars.copy_context().run
        return await loop.run_in_executor(None, call, fn, *args)

    # -- internals (parity: createAndSendRequest, new.go:111-159) ------------
    def _resolve(self, path: str, params: Optional[dict]) -> tuple[str, str]:
        """Full display URI + the request target sent on the wire."""
        uri = self.address + "/" + path.lstrip("/")
        if params:
            uri += "?" + _encode_query(params)
        split = urllib.parse.urlsplit(uri)
        target = split.path or "/"
        if split.query:
            target += "?" + split.query
        return uri, target

    def _encode_body(self, body: Any, send_headers: dict) -> Optional[bytes]:
        if body is None:
            return None
        if isinstance(body, bytes):
            return body
        send_headers.setdefault("Content-Type", "application/json")
        return _json.dumps(body).encode("utf-8")

    def _open(self, connect_timeout: float,
              split: Optional[urllib.parse.SplitResult] = None,
              ) -> http.client.HTTPConnection:
        if split is None:
            split = urllib.parse.urlsplit(self.address)
        cls = (http.client.HTTPSConnection if split.scheme == "https"
               else http.client.HTTPConnection)
        return cls(split.hostname or "", split.port, timeout=connect_timeout)

    def _attempt(self, method: str, target: str, data: Optional[bytes],
                 headers: dict, connect_timeout: float,
                 read_timeout: float,
                 split: Optional[urllib.parse.SplitResult] = None,
                 ) -> tuple[int, bytes, dict[str, str]]:
        """One request on a fresh connection, closed whatever happens —
        an aborted attempt never leaks its socket or response body into
        the next one. ``split`` overrides the destination (redirect
        hops)."""
        conn = self._open(connect_timeout, split)
        try:
            try:
                conn.connect()
            except Exception as exc:
                raise _ConnectError(exc) from exc
            # connect succeeded: the remaining socket ops (send, response
            # head, body reads) run under the READ budget
            if conn.sock is not None:
                conn.sock.settimeout(read_timeout)
            conn.request(method, target, body=data, headers=headers)
            resp = conn.getresponse()
            payload = _read_body(resp, conn.sock, read_timeout)
            return resp.status, payload, dict(resp.getheaders())
        finally:
            conn.close()

    def _retry_loop(
        self,
        method: str,
        target: str,
        data: Optional[bytes],
        send_headers: dict,
        connect_t: float,
        read_t: float,
        budget: int,
        may_retry: bool,
        deadline_s: Optional[float],
        start: float,
    ) -> tuple[Optional[tuple[int, bytes, dict[str, str]]], int,
               Optional[Exception]]:
        """Attempt/backoff loop shared by every non-streaming call.
        Connect-phase failures replay even for non-idempotent methods
        (nothing was on the wire); post-connect failures and retryable
        statuses replay only when ``may_retry``. Returns
        ``(result-or-None, attempts, last_exception)``."""
        delays = backoff_delays(budget)
        attempts = 0
        last_exc: Optional[Exception] = None
        result: Optional[tuple[int, bytes, dict[str, str]]] = None
        while True:
            attempts += 1
            ct, rt = connect_t, read_t
            if deadline_s is not None:
                # the deadline is a TOTAL budget: each attempt's connect
                # and read windows shrink to what is left of it
                remaining = deadline_s - (time.perf_counter() - start)
                if remaining <= 0 and attempts > 1:
                    attempts -= 1  # this attempt never ran
                    break
                remaining = max(remaining, 0.001)
                ct, rt = min(ct, remaining), min(rt, remaining)
            try:
                result = self._attempt(
                    method, target, data, send_headers, ct, rt
                )
                last_exc = None
            except _ConnectError as exc:
                last_exc = exc.cause
            except Exception as exc:
                last_exc = exc
                if not may_retry:
                    break  # request may have executed: do not replay
            if result is not None and (
                result[0] not in RETRYABLE_STATUSES or not may_retry
            ):
                break
            delay = next(delays, None)
            if delay is None:
                break
            elapsed = time.perf_counter() - start
            if deadline_s is not None and elapsed + delay >= deadline_s:
                break  # budget exhausted: surface what we have
            time.sleep(delay)
            result = None
        return result, attempts, last_exc

    def request(
        self,
        method: str,
        path: str,
        params: Optional[dict] = None,
        body: Any = None,
        headers: Optional[dict] = None,
        *,
        connect_timeout: Optional[float] = None,
        read_timeout: Optional[float] = None,
        retries: Optional[int] = None,
        retryable: Optional[bool] = None,
        deadline_s: Optional[float] = None,
    ) -> ServiceResponse:
        """The generic call every helper delegates to, with per-call
        overrides for the timeout split and the retry budget.

        ``retryable=None`` applies the method rule (idempotent methods
        retry, POST/PATCH do not); ``True``/``False`` overrides it —
        the fleet router passes ``True`` for requests it KNOWS produced
        no client-visible effect yet. ``deadline_s`` bounds the total
        time across attempts including backoff sleeps."""
        method = method.upper()
        uri, target = self._resolve(path, params)
        send_headers = dict(headers or {})
        data = self._encode_body(body, send_headers)
        connect_t = connect_timeout if connect_timeout is not None else self.connect_timeout
        read_t = read_timeout if read_timeout is not None else self.read_timeout
        budget = retries if retries is not None else self.retries
        may_retry = (method in IDEMPOTENT_METHODS if retryable is None
                     else retryable)

        tracer = get_tracer()
        span = tracer.start_span(f"{method} {uri}", kind=CLIENT, activate=False)
        correlation_id = span.trace_id
        # downstream SERVER span must parent onto this CLIENT span
        send_headers.setdefault("traceparent", span.traceparent())
        send_headers.setdefault("X-Correlation-ID", correlation_id)

        start = time.perf_counter()
        result, attempts, last_exc = self._retry_loop(
            method, target, data, send_headers, connect_t, read_t,
            budget, may_retry, deadline_s, start,
        )
        if result is not None and result[0] in REDIRECT_STATUSES:
            try:
                uri, result = self._follow_redirects(
                    method, uri, result, data, send_headers,
                    connect_t, read_t,
                    deadline_left=(
                        None if deadline_s is None
                        else deadline_s - (time.perf_counter() - start)
                    ),
                )
            except Exception as exc:
                last_exc, result = exc, None
        elapsed_us = int((time.perf_counter() - start) * 1e6)
        if result is None:
            span.set_tag("error", last_exc)
            span.set_tag("attempts", attempts)
            span.end()
            self.logger.error(ServiceLog(
                correlation_id, self.name, method, uri, 0, elapsed_us,
                attempts=attempts,
            ))
            raise ServiceCallError(
                self.name, uri, last_exc or RuntimeError("request failed"),
                elapsed_s=elapsed_us / 1e6, attempts=attempts,
            ) from last_exc

        status, payload, resp_headers = result
        span.set_tag("http.status_code", status)
        span.set_tag("attempts", attempts)
        span.end()
        log_entry = ServiceLog(
            correlation_id, self.name, method, uri, status, elapsed_us,
            attempts=attempts,
        )
        if status >= 500:
            self.logger.error(log_entry)
        else:
            self.logger.info(log_entry)
        return ServiceResponse(status, payload, resp_headers)

    def _follow_redirects(
        self,
        method: str,
        uri: str,
        result: tuple[int, bytes, dict[str, str]],
        data: Optional[bytes],
        headers: dict,
        connect_t: float,
        read_t: float,
        deadline_left: Optional[float] = None,
    ) -> tuple[str, tuple[int, bytes, dict[str, str]]]:
        """Follow up to MAX_REDIRECTS Location hops for safe methods
        (``urlopen`` parity); everything else returns the 3xx raw.
        ``deadline_left`` is what remains of the caller's total budget
        — each hop's connect/read windows shrink with it, and an
        exhausted budget returns the last 3xx instead of hopping on."""
        hops = 0
        hop_start = time.perf_counter()
        while (result[0] in REDIRECT_STATUSES
               and method in REDIRECT_METHODS and hops < MAX_REDIRECTS):
            location = next(
                (v for k, v in result[2].items() if k.lower() == "location"),
                None,
            )
            if not location:
                break
            ct, rt = connect_t, read_t
            if deadline_left is not None:
                remaining = deadline_left - (time.perf_counter() - hop_start)
                if remaining <= 0:
                    break
                ct, rt = min(ct, remaining), min(rt, remaining)
            hops += 1
            uri = urllib.parse.urljoin(uri, location)
            split = urllib.parse.urlsplit(uri)
            target = (split.path or "/") + (
                "?" + split.query if split.query else ""
            )
            result = self._attempt(
                method, target, data, headers, connect_timeout=ct,
                read_timeout=rt, split=split,
            )
        return uri, result

    def stream(
        self,
        method: str,
        path: str,
        params: Optional[dict] = None,
        body: Any = None,
        headers: Optional[dict] = None,
        *,
        connect_timeout: Optional[float] = None,
        read_timeout: Optional[float] = None,
    ) -> StreamingServiceResponse:
        """Single-attempt streaming call: returns once the response HEAD
        arrives; the body is consumed through the returned object (SSE
        token passthrough). Retry policy is the CALLER's job — only it
        knows whether any chunk already reached its own client."""
        method = method.upper()
        uri, target = self._resolve(path, params)
        send_headers = dict(headers or {})
        data = self._encode_body(body, send_headers)
        connect_t = connect_timeout if connect_timeout is not None else self.connect_timeout
        read_t = read_timeout if read_timeout is not None else self.read_timeout

        tracer = get_tracer()
        span = tracer.start_span(f"{method} {uri}", kind=CLIENT, activate=False)
        send_headers.setdefault("traceparent", span.traceparent())
        send_headers.setdefault("X-Correlation-ID", span.trace_id)

        start = time.perf_counter()
        conn = self._open(connect_t)
        try:
            try:
                conn.connect()
            except Exception as exc:
                raise _ConnectError(exc) from exc
            if conn.sock is not None:
                conn.sock.settimeout(read_t)
            conn.request(method, target, body=data, headers=send_headers)
            resp = conn.getresponse()
        except Exception as exc:
            conn.close()
            elapsed_us = int((time.perf_counter() - start) * 1e6)
            cause = exc.cause if isinstance(exc, _ConnectError) else exc
            span.set_tag("error", cause)
            span.end()
            self.logger.error(ServiceLog(
                span.trace_id, self.name, method, uri, 0, elapsed_us
            ))
            raise ServiceCallError(
                self.name, uri, cause, elapsed_s=elapsed_us / 1e6
            ) from cause
        elapsed_us = int((time.perf_counter() - start) * 1e6)
        span.set_tag("http.status_code", resp.status)
        span.set_tag("streamed", True)
        span.end()
        self.logger.info(ServiceLog(
            span.trace_id, self.name, method, uri, resp.status, elapsed_us
        ))
        return StreamingServiceResponse(
            resp.status, dict(resp.getheaders()), resp, conn
        )

    def health_check(self) -> Health:
        """GET /.well-known/health on the downstream: UP on a 200. The
        container's own health does not probe services (one that points
        back at the same app would recurse)."""
        try:
            resp = self.get("/.well-known/health")
            return Health(UP if resp.status_code == 200 else DOWN, {"host": self.address})
        except Exception as exc:
            return Health(DOWN, {"host": self.address, "error": str(exc)})


def _encode_query(params: dict) -> str:
    """Parity: service/new.go:161-176 — list values repeat the key."""
    pairs: list[tuple[str, str]] = []
    for key, value in params.items():
        if isinstance(value, (list, tuple)):
            pairs.extend((key, str(v)) for v in value)
        else:
            pairs.append((key, str(value)))
    return urllib.parse.urlencode(pairs)


def new_http_service(address: str, logger: Any, name: str = "") -> HTTPService:
    """Parity: service/new.go:56."""
    return HTTPService(address, logger, name=name)
