"""The port's HTTP server (``gofr_tpu_torch/http/server.py``, a copy of the
JAX package's) held to the JAX server at the wire.

- ``tests/test_http_protocol.py``'s 8 cases: the same raw bytes go to a
  plain JAX app and a plain port app, each with the same two routes; the
  responses must be the same bytes once the server's name and the
  correlation ids are masked (status lines, headers in order, framing,
  bodies), and each carries the status the reference test requires.
- ``tests/test_fuzz.py::test_fuzz_malformed_bodies_never_500``'s zoo of
  broken bodies against the port's tiny model on the CPU: a 4xx, never a
  5xx, and the same status as the JAX app for each body.
"""

import json
import re
import socket
import urllib.error
import urllib.request

import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu_torch.config import DECLARED_KEYS

_PAYLOAD = json.dumps({"a": 1}).encode()
CASES = {
    "malformed_head": (b"NOT A REQUEST\r\n\r\n", 400, [b"malformed"]),
    "bad_content_length": (b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: banana\r\n\r\n",
                           400, [b"content-length"]),
    "oversized_headers": (b"GET /hello HTTP/1.1\r\nHost: x\r\nX-Pad: " + b"a" * (70 * 1024)
                          + b"\r\n\r\n", 431, []),
    # the limit rejects on the DECLARED length, before any body byte is read
    "oversized_body": (b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 999999999\r\n\r\n",
                       413, []),
    "http10_closes": (b"GET /hello HTTP/1.0\r\nHost: x\r\n\r\n", 200, [b"Connection: close"]),
    "head_without_body": (b"HEAD /hello HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
                          200, [b"Content-Length: 13"]),
    "chunked_request_body": (b"POST /echo HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n"
                             b"Connection: close\r\n\r\n" + (b"%x\r\n" % len(_PAYLOAD))
                             + _PAYLOAD + b"\r\n0\r\n\r\n", 200, [b'{"a":1}']),
    "pipelined_keepalive": (b"GET /hello HTTP/1.1\r\nHost: x\r\n\r\n"
                            b"GET /hello HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
                            200, []),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def env(monkeypatch, tmp_path):
    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("LOG_LEVEL", "FATAL")
    monkeypatch.chdir(tmp_path)
    return monkeypatch


@pytest.fixture
def apps(env):
    """A plain (datasource-free) JAX app and port app with the reference
    test's two routes."""
    built = []
    for pkg in (gofr_tpu, gofr_tpu_torch):
        env.setenv("HTTP_PORT", str(_free_port()))
        app = pkg.new()
        app.post("/echo", lambda ctx: ctx.bind())
        app.get("/hello", lambda ctx: "hi")
        app.start()
        built.append(app)
    yield built
    for app in built:
        app.shutdown()


def _raw(app, payload: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", app.http_port), timeout=10) as s:
        s.sendall(payload)
        s.settimeout(10)
        out = b""
        try:
            while True:
                data = s.recv(65536)
                if not data:
                    break
                out += data
        except socket.timeout:
            pass
        return out


def _masked(raw: bytes) -> bytes:
    raw = re.sub(rb"\r\nServer: [^\r]*", b"\r\nServer: <server>", raw)
    return re.sub(rb"\r\nX-Correlation-ID: [0-9a-f]+", b"\r\nX-Correlation-ID: <id>", raw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_server_answers_as_jax(apps, case):
    payload, status, needles = CASES[case]
    jax_out, port_out = (_raw(app, payload) for app in apps)
    assert _masked(port_out) == _masked(jax_out)
    assert port_out.startswith(b"HTTP/1.1 %d" % status), port_out[:200]
    assert b"Server: gofr-tpu-torch\r\n" in port_out
    for needle in needles:
        assert needle in port_out
    if case == "head_without_body":
        assert port_out.endswith(b"\r\n\r\n")  # the length advertised, no body
    if case == "pipelined_keepalive":
        assert port_out.count(b"HTTP/1.1 200") == 2
        assert b"Connection: keep-alive" in port_out


BROKEN_BODIES = [
    b"",
    b"not json",
    b"[1, 2",
    b"null",
    b'{"tokens": "abc"}',
    b'{"tokens": []}',
    b'{"tokens": [1.5]}',
    b'{"tokens": [999999999]}',
    b'{"tokens": [-4]}',
    b'{"tokens": [1, 2], "max": "lots"}',
    b'{"tokens": [1, 2], "temperature": -3}',
    b'{"tokens": [1, 2], "top_p": 0}',
    b'{"tokens": [1, 2], "min_p": 2}',
    b'{"tokens": [1, 2], "repetition_penalty": 0}',
    b'{"tokens": [1, 2], "stop_tokens": "x"}',
    b'{"tokens": [1, 2], "seed": "abc"}',
]


def _generate_route(errors, sampling):
    """The reference test's handler over a package's errors and sampling."""
    def generate(ctx):
        body = ctx.bind()
        if not isinstance(body, dict):
            raise errors.InvalidParamError("body (expected a JSON object)")
        try:
            sampler = sampling.Sampler.from_body(body)
            stops = sampling.stop_tokens_from_body(body)
            max_new = int(body.get("max", 8))
        except (TypeError, ValueError) as exc:
            raise errors.InvalidParamError(f"sampling params ({exc})") from exc
        return {"tokens": ctx.tpu.generate(body.get("tokens"), max_new_tokens=max_new,
                                           sampler=sampler, stop_tokens=stops)}

    return generate


def test_fuzz_malformed_bodies_never_500(env):
    import gofr_tpu.errors as jax_errors
    import gofr_tpu.ops.sampling as jax_sampling
    import gofr_tpu_torch.errors as errors
    import gofr_tpu_torch.ops.sampling as sampling

    for key, value in {"MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "2", "BATCH_TIMEOUT_MS": "1",
                       "TORCH_DEVICE": "cpu"}.items():
        env.setenv(key, value)
    statuses = []
    for pkg, errs, samp in ((gofr_tpu, jax_errors, jax_sampling),
                            (gofr_tpu_torch, errors, sampling)):
        env.setenv("HTTP_PORT", str(_free_port()))
        app = pkg.new()
        app.post("/generate", _generate_route(errs, samp))
        app.start()
        got = []
        try:
            for raw in BROKEN_BODIES:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{app.http_port}/generate", data=raw,
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        got.append(resp.status)  # some payloads may succeed
                except urllib.error.HTTPError as e:
                    assert 400 <= e.code < 500, (pkg.__name__, raw, e.code, e.read(300))
                    got.append(e.code)
        finally:
            app.shutdown()
        statuses.append(got)
    assert statuses[1] == statuses[0]
