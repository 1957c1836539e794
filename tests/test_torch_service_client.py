"""The port's inter-service HTTP client (``gofr_tpu_torch/service.py``),
case for case with ``tests/test_service_client.py``, then beside the JAX
package's: every verb and ``*_with_headers`` form (and the async forms)
sends the JAX client's request bytes to a recording server, the trace ids
aside."""

import http.server
import json
import threading

import pytest

from gofr_tpu_torch.service import ServiceCallError, new_http_service
from gofr_tpu_torch.testutil import MockLogger


@pytest.fixture
def echo_server(free_port):
    port = free_port()
    seen = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def _handle(self):
            seen["method"] = self.command
            seen["path"] = self.path
            seen["headers"] = dict(self.headers.items())
            length = int(self.headers.get("Content-Length", 0))
            seen["body"] = self.rfile.read(length) if length else b""
            status = 500 if self.path.startswith("/fail") else 200
            payload = json.dumps({"ok": True}).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _handle

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{port}", seen
    srv.shutdown()


def test_get_with_params_and_correlation(echo_server):
    base, seen = echo_server
    logger = MockLogger()
    svc = new_http_service(base, logger, name="downstream")
    resp = svc.get("items", params={"limit": 5, "tag": ["a", "b"]})
    assert resp.status_code == 200
    assert resp.json() == {"ok": True}
    assert seen["method"] == "GET"
    assert seen["path"] == "/items?limit=5&tag=a&tag=b"
    lower_headers = {k.lower(): v for k, v in seen["headers"].items()}
    assert "x-correlation-id" in lower_headers
    assert lower_headers["traceparent"].startswith("00-")
    assert "downstream" in logger.output


def test_post_json_body_and_headers(echo_server):
    base, seen = echo_server
    svc = new_http_service(base, MockLogger())
    svc.post_with_headers("create", None, {"a": 1}, {"X-Api-Key": "k"})
    assert seen["method"] == "POST"
    assert json.loads(seen["body"]) == {"a": 1}
    assert seen["headers"]["Content-Type"] == "application/json"
    assert seen["headers"]["X-Api-Key"] == "k"


def test_5xx_logged_as_error(echo_server):
    base, _ = echo_server
    logger = MockLogger()
    svc = new_http_service(base, logger)
    resp = svc.get("fail")
    assert resp.status_code == 500
    assert '"level": "ERROR"' in logger.output


def test_unreachable_service_raises_502():
    svc = new_http_service("http://127.0.0.1:1", MockLogger(), name="ghost")
    with pytest.raises(ServiceCallError) as exc:
        svc.get("x")
    assert exc.value.status_code == 502
    assert "ghost" in str(exc.value)


def test_health_check(echo_server):
    base, _ = echo_server
    svc = new_http_service(base, MockLogger())
    assert svc.health_check().status == "UP"
    ghost = new_http_service("http://127.0.0.1:1", MockLogger())
    assert ghost.health_check().status == "DOWN"


# -- the two packages on one wire --------------------------------------------

import asyncio  # noqa: E402
import re  # noqa: E402
import socket  # noqa: E402

from gofr_tpu.service import new_http_service as jax_new_http_service  # noqa: E402
from gofr_tpu.testutil import MockLogger as JaxMockLogger  # noqa: E402


@pytest.fixture
def raw_server():
    """A one-request-per-connection HTTP server that keeps each request's
    raw bytes and answers 201 with a JSON body."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(8)
    port = sock.getsockname()[1]
    seen = []

    def serve():
        while True:
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            with conn:
                data = b""
                while b"\r\n\r\n" not in data:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                head, _, body = data.partition(b"\r\n\r\n")
                m = re.search(rb"(?i)content-length: *(\d+)", head)
                while m and len(body) < int(m.group(1)):
                    body += conn.recv(65536)
                seen.append(head + b"\r\n\r\n" + body)
                payload = b'{"ok": true, "n": 1}'
                conn.sendall(b"HTTP/1.1 201 Created\r\nContent-Type: application/json\r\n"
                             b"Content-Length: %d\r\nConnection: close\r\n\r\n" % len(payload)
                             + payload)

    threading.Thread(target=serve, daemon=True).start()
    yield f"http://127.0.0.1:{port}", seen
    sock.close()


def _normalized(raw):
    """The request without its per-call trace ids (random in both)."""
    raw = re.sub(rb"traceparent: 00-[0-9a-f]{32}-[0-9a-f]{16}-0[01]", b"traceparent: 00-T-S-01", raw)
    return re.sub(rb"X-Correlation-ID: [0-9a-f]{32}", b"X-Correlation-ID: T", raw)


_BODY = {"name": "ada", "tags": ["a", "b"], "n": 1.5, "u": "über"}
_HEADERS = {"X-Api-Key": "k", "X-Tenant": "acme"}
_CALLS = {
    "get": lambda s: s.get("items", {"limit": 5, "tag": ["a", "b"], "q": "a b&c"}),
    "get_with_headers": lambda s: s.get_with_headers("items", {"limit": 5}, _HEADERS),
    "post": lambda s: s.post("create", {"dry": "1"}, _BODY),
    "post_with_headers": lambda s: s.post_with_headers("create", None, _BODY, _HEADERS),
    "put": lambda s: s.put("items/7", None, _BODY),
    "put_with_headers": lambda s: s.put_with_headers("items/7", {"v": 2}, b"raw bytes", _HEADERS),
    "patch": lambda s: s.patch("items/7", None, {"n": 2}),
    "patch_with_headers": lambda s: s.patch_with_headers("items/7", None, "text body", _HEADERS),
    "delete": lambda s: s.delete("items/7"),
    "delete_with_headers": lambda s: s.delete_with_headers("items/7", {"why": "x"}, _HEADERS),
    "async_get": lambda s: asyncio.run(s.async_get("items", {"limit": 1})),
    "async_post": lambda s: asyncio.run(s.async_post("create", None, _BODY)),
    "async_put": lambda s: asyncio.run(s.async_put("items/7", None, _BODY)),
    "async_patch": lambda s: asyncio.run(s.async_patch("items/7", None, _BODY)),
    "async_delete": lambda s: asyncio.run(s.async_delete("items/7")),
}


@pytest.mark.parametrize("verb", sorted(_CALLS))
def test_request_bytes_equal_jax(raw_server, verb):
    base, seen = raw_server
    answers = []
    for make, logger in ((jax_new_http_service, JaxMockLogger()),
                         (new_http_service, MockLogger())):
        resp = _CALLS[verb](make(base, logger, name="downstream"))
        answers.append((resp.status_code, resp.body, resp.json()))
    assert len(seen) == 2
    assert _normalized(seen[1]) == _normalized(seen[0])
    assert b"traceparent: 00-T-S-01" in _normalized(seen[0])
    assert answers[1] == answers[0] == (201, b'{"ok": true, "n": 1}', {"ok": True, "n": 1})


def test_service_log_equals_jax(raw_server):
    """The outbound call's log entry: the same fields (service, method,
    URI, status, attempts; not the ids and time)."""
    base, _ = raw_server
    entries = []
    for make, logger in ((jax_new_http_service, JaxMockLogger()),
                         (new_http_service, MockLogger())):
        make(base, logger, name="downstream").put("items/7", {"v": 1}, _BODY)
        message = json.loads(logger.lines[-1])["message"]
        for key in ("correlation_id", "response_time_us"):
            message.pop(key)
        entries.append(message)
    assert entries[1] == entries[0]
