"""gofr_tpu_torch's app and middleware against gofr_tpu's, over real
sockets: two apps with no model and the same routes get the same
requests, and give the same status, body and headers (the date, the
server's name, ids and the ready verdict's boot id aside). Covered: the
envelope and errors, panic recovery's 500 (an exception escaping the
handler adapter), health, readiness, the favicon's bytes, ``/metrics``,
CORS preflight, ``traceparent`` propagation and the generated
``X-Correlation-ID`` reaching a sync handler's thread, the route-pattern
path label and escaping exceptions counted as 500, and put, patch and
delete."""

import asyncio
import http.client
import json
import socket
import types

import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import errors as jerrors
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu.http.response import Raw as JaxRaw
from gofr_tpu.http.response import Response as JaxResponse
from gofr_tpu.http.response import Stream as JaxStream
from gofr_tpu_torch import errors as terrors
from gofr_tpu_torch.config import DECLARED_KEYS
from gofr_tpu_torch.http.response import Raw, Response, Stream

MASKED = {"date", "server", "x-correlation-id", "content-length"}
TRACE = "ab" * 16
TRACEPARENT = f"00-{TRACE}-{'cd' * 8}-01"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _routes(app, errors, raw, stream, response, seen):
    app.get("/hello", lambda ctx: "Hello World!")
    app.get("/greet/{name}", lambda ctx: f"hi {ctx.path_param('name')} x{ctx.param('times')}")

    def bad(ctx):
        raise errors.InvalidParamError("id")

    def crash(ctx):
        raise RuntimeError("kaboom")

    def double(ctx):
        return raw({"echo": ctx.bind()["v"] * 2})

    def sync_trace(ctx):
        # a sync handler on the pool: the request's span reaches its thread
        ctx.logger.debugf("trace %s", ctx.trace_id)
        ctx.logger.notice("notice")
        with ctx.trace("work") as span:  # a child span in the same trace
            assert span.trace_id == ctx.trace_id
        seen.setdefault(app.label, []).append(ctx.trace_id)
        return "ok"

    async def sse(ctx):
        async def gen():
            for i in range(3):
                yield f"tok{i}"

        return stream(gen())

    async def escaping(request):
        raise RuntimeError("escapes the handler adapter")

    app.get("/err", bad)
    app.get("/crash", crash)
    app.post("/double", double)
    app.get("/trace", sync_trace)
    app.get("/sse", sse)
    for method in ("put", "patch", "delete"):
        getattr(app, method)("/thing/{id}", lambda ctx, m=method: {m: ctx.path_param("id")})
    app.router.add("GET", "/escape", escaping)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    seen: dict = {}
    built = []
    with pytest.MonkeyPatch.context() as mp:
        for key in set(JAX_KEYS) | set(DECLARED_KEYS):
            mp.delenv(key, raising=False)
        mp.setenv("LOG_LEVEL", "FATAL")
        for label, pkg, errors, raw, stream, response in (
            ("jax", gofr_tpu, jerrors, JaxRaw, JaxStream, JaxResponse),
            ("torch", gofr_tpu_torch, terrors, Raw, Stream, Response),
        ):
            mp.setenv("HTTP_PORT", str(_free_port()))
            mp.chdir(tmp_path_factory.mktemp(label))
            app = pkg.new()
            app.label = label
            _routes(app, errors, raw, stream, response, seen)
            app.start()
            built.append(app)
    yield types.SimpleNamespace(jax=built[0], torch=built[1], seen=seen)
    for app in built:
        app.shutdown()


def _request(app, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", app.http_port, timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()


def _both(apps, method, path, body=None, headers=None):
    """The same request to both apps: equal status, body and headers (the
    masked ones aside). -> the port's (status, body, headers)."""
    j = _request(apps.jax, method, path, body, headers)
    t = _request(apps.torch, method, path, body, headers)
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert {k: v for k, v in t[2].items() if k not in MASKED} == \
        {k: v for k, v in j[2].items() if k not in MASKED}
    return t


def test_envelope_params_and_errors(apps):
    status, body, headers = _both(apps, "GET", "/hello")
    assert (status, json.loads(body)) == (200, {"data": "Hello World!"})
    assert headers["content-type"] == "application/json"
    assert json.loads(_both(apps, "GET", "/greet/ada?times=3")[1]) == {"data": "hi ada x3"}
    status, body, _ = _both(apps, "GET", "/err")
    assert status == 400 and "invalid" in json.loads(body)["error"]["message"]
    status, body, _ = _both(apps, "GET", "/crash")
    assert (status, body) == (500, b'{"error":{"message":"some unexpected error has occurred"}}')
    assert _both(apps, "GET", "/nope")[0] == 404
    status, _, headers = _both(apps, "POST", "/hello")
    assert status == 405 and headers["allow"] == "GET"
    status, body, _ = _both(apps, "POST", "/double", b'{"v": 21}',
                            {"Content-Type": "application/json"})
    assert json.loads(body) == {"echo": 42}
    status, body, headers = _both(apps, "GET", "/sse")
    assert body == b"data: tok0\n\ndata: tok1\n\ndata: tok2\n\n"


def test_panic_recovery_is_the_json_500(apps):
    """An exception escaping the handler adapter: the logging middleware's
    recovery answers the JSON 500 (and keeps the correlation id)."""
    status, body, headers = _both(apps, "GET", "/escape")
    assert (status, body) == (500, b'{"error":{"message":"some unexpected error has occurred"}}')
    assert len(headers["x-correlation-id"]) == 32


def test_default_routes(apps):
    status, body, _ = _both(apps, "GET", "/.well-known/health")
    assert json.loads(body) == {"data": {"status": "UP", "details": {}}}
    status, body, headers = _both(apps, "GET", "/favicon.ico")
    assert headers["content-type"] == "image/x-icon" and len(body) == 1150
    assert body[:4] == b"\x00\x00\x01\x00"
    j = _request(apps.jax, "GET", "/.well-known/ready")
    t = _request(apps.torch, "GET", "/.well-known/ready")
    assert t[0] == j[0] == 200
    jb, tb = json.loads(j[1]), json.loads(t[1])
    assert set(tb) == set(jb) == {"state", "boot_id"} and tb["state"] == jb["state"] == "ready"
    assert len(tb["boot_id"]) == len(jb["boot_id"]) == 16
    for accept, ctype in (("", "text/plain; version=0.0.4; charset=utf-8"),
                          ("application/openmetrics-text",
                           "application/openmetrics-text; version=1.0.0; charset=utf-8")):
        for app in (apps.jax, apps.torch):
            status, body, headers = _request(app, "GET", "/metrics", headers={"Accept": accept})
            assert status == 200 and headers["content-type"] == ctype
            assert b"gofr_http_requests_total" in body
            assert body.endswith(b"# EOF\n") == bool(accept)


def test_cors_preflight_and_header(apps):
    status, body, headers = _both(apps, "OPTIONS", "/anything")
    assert status == 200 and body == b""
    assert headers["access-control-allow-methods"] == "GET, POST, PUT, PATCH, DELETE, OPTIONS"
    assert _both(apps, "GET", "/hello")[2]["access-control-allow-origin"] == "*"


def test_traceparent_and_generated_correlation_ids(apps):
    """A traceparent's trace id is the X-Correlation-ID and the sync
    handler's ``ctx.trace_id`` (its thread got the span); without one the
    server's own 32-hex id, the same in the header and the handler."""
    for app in (apps.jax, apps.torch):
        apps.seen.pop(app.label, None)
        _, _, headers = _request(app, "GET", "/trace", headers={"traceparent": TRACEPARENT})
        assert headers["x-correlation-id"] == TRACE
        _, body, headers = _request(app, "GET", "/trace")
        cid = headers["x-correlation-id"]
        assert len(cid) == 32 and cid != TRACE
        int(cid, 16)
        assert json.loads(body) == {"data": "ok"}
        assert apps.seen[app.label] == [TRACE, cid]


def test_put_patch_delete(apps):
    for method in ("PUT", "PATCH", "DELETE"):
        status, body, _ = _both(apps, method, "/thing/7", b"{}" if method != "DELETE" else None)
        assert json.loads(body) == {"data": {method.lower(): "7"}}


def _series(text, family):
    return sorted(line for line in text.splitlines() if line.startswith(family + "{"))


def test_request_metrics_match_by_route_pattern(apps):
    """After the same requests, both registries hold the same request
    series: the route pattern (or ``unmatched``) as the path, escaping
    exceptions as 500; and the duration histogram's counts."""
    for app in (apps.jax, apps.torch):
        _request(app, "GET", "/greet/bob?times=1")
        _request(app, "GET", "/definitely/not/routed")
    texts = [_request(app, "GET", "/metrics")[1].decode() for app in (apps.jax, apps.torch)]
    jax_text, port_text = texts
    assert _series(port_text, "gofr_http_requests_total") == \
        _series(jax_text, "gofr_http_requests_total")
    assert _series(port_text, "gofr_http_request_duration_seconds_count") == \
        _series(jax_text, "gofr_http_request_duration_seconds_count")
    assert 'path="/greet/{name}"' in port_text and "/greet/bob" not in port_text
    assert 'gofr_http_requests_total{method="GET",path="unmatched",status="404"}' in port_text
    assert 'gofr_http_requests_total{method="GET",path="/escape",status="500"} 1' in port_text


def test_escaping_exceptions_count_as_500():
    """The metrics middleware alone: an exception escaping the inner chain
    counts as 500 and still propagates, as in the JAX package."""
    from gofr_tpu_torch.http.middleware import metrics_middleware
    from gofr_tpu_torch.http.request import Request
    from gofr_tpu_torch.metrics import Registry

    registry = Registry()

    async def exploding(request):
        raise RuntimeError("middleware-level failure")

    with pytest.raises(RuntimeError):
        asyncio.run(metrics_middleware(registry)(exploding)(Request("GET", "/boom", {})))
    counter = registry.counter("gofr_http_requests_total")
    assert counter.value(method="GET", path="unmatched", status="500") == 1
