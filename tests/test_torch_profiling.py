"""gofr_tpu_torch's profiler (``profiling.py``, over ``torch.profiler``)
against gofr_tpu's contract (``tests/test_profiling.py``): the lifecycle
and its states, a second start refused while one traces, a stop with no
trace refused, the admin endpoints (``GET /admin/profiler``, ``POST
/admin/profiler/start|stop``) behind ``ADMIN_TOKEN`` with the
``gofr_tpu_profiler_active`` gauge, and a Chrome trace of the CPU activity
written into the directory the start named, or ``PROFILE_DIR``.
(The JAX profiler's own capture is an XLA trace, slow-marked in the JAX
suite; the states, messages and response shapes are compared here.)"""

import json
import socket
import urllib.error
import urllib.request

import pytest
import torch

import gofr_tpu.telemetry as jt
import gofr_tpu_torch
import gofr_tpu_torch.telemetry as tt
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu.profiling import Profiler as JaxProfiler
from gofr_tpu_torch.config import DECLARED_KEYS
from gofr_tpu_torch.profiling import TRACE_FILE, Profiler


@pytest.fixture(autouse=True)
def _no_leaked_record():
    jt.activate_record(None)
    tt.activate_record(None)
    yield
    jt.activate_record(None)
    tt.activate_record(None)


def _trace_events(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)["traceEvents"]


def test_profiler_lifecycle_writes_a_chrome_trace(tmp_path):
    p = Profiler()
    assert p.status() == JaxProfiler().status() == {"state": "idle"}
    out = p.start(str(tmp_path / "trace"))
    assert out == {"state": "tracing", "dir": str(tmp_path / "trace")}
    x = torch.randn(64, 64)
    (x @ x).sum()
    assert p.status()["state"] == "tracing"
    stopped = p.stop()
    assert set(stopped) == {"state", "dir", "seconds", "artifacts"}
    assert stopped["state"] == "stopped" and stopped["artifacts"] == [TRACE_FILE]
    names = {e.get("name") for e in _trace_events(tmp_path / "trace" / TRACE_FILE)}
    assert any("mm" in str(n) for n in names)
    assert p.status() == {"state": "idle"}


def test_double_start_and_idle_stop_are_refused(tmp_path):
    p = Profiler()
    p.start(str(tmp_path / "t"))
    with pytest.raises(RuntimeError, match="already tracing"):
        p.start(str(tmp_path / "t2"))
    p.stop()
    with pytest.raises(RuntimeError, match="not tracing"):
        p.stop()
    with pytest.raises(RuntimeError, match="not tracing"):
        JaxProfiler().stop()


def test_default_dir_and_a_failed_export_leave_it_idle(tmp_path, monkeypatch):
    p = Profiler()
    assert p.start(default_dir=str(tmp_path / "pd"))["dir"] == str(tmp_path / "pd")
    p.stop()
    assert p.start()["dir"].startswith(str(tmp_path.anchor))  # a mkdtemp
    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace",
                        lambda self, path: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(OSError, match="disk full"):
        p.stop()
    assert p.status() == {"state": "idle"}  # the failure is not stuck "tracing"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def app(monkeypatch, tmp_path):
    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HTTP_PORT", str(_free_port()))
    monkeypatch.setenv("LOG_LEVEL", "FATAL")
    application = gofr_tpu_torch.new().start()
    yield application
    application.shutdown()


def _call(app, method, path, body=None, token=None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{app.http_port}{path}", data=data,
                                 headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_admin_profiler_endpoints(app, tmp_path, monkeypatch):
    assert _call(app, "GET", "/admin/profiler") == (200, {"data": {"state": "idle"}})
    status, body = _call(app, "POST", "/admin/profiler/start", {"dir": str(tmp_path / "p")})
    assert status == 200
    assert body["data"] == {"state": "tracing", "dir": str(tmp_path / "p")}
    assert _call(app, "GET", "/admin/profiler")[1]["data"]["state"] == "tracing"
    assert _call(app, "POST", "/admin/profiler/start", {})[0] == 409
    assert 'gofr_tpu_profiler_active 1' in app.container.metrics.expose()
    status, body = _call(app, "POST", "/admin/profiler/stop", {})
    assert body["data"]["artifacts"] == [TRACE_FILE]
    assert (tmp_path / "p" / TRACE_FILE).exists()
    assert _call(app, "POST", "/admin/profiler/stop", {})[0] == 409
    assert 'gofr_tpu_profiler_active 0' in app.container.metrics.expose()
    monkeypatch.setenv("PROFILE_DIR", str(tmp_path / "env"))
    assert _call(app, "POST", "/admin/profiler/start")[1]["data"]["dir"] == str(tmp_path / "env")
    _call(app, "POST", "/admin/profiler/stop")
    assert _call(app, "POST", "/admin/profiler/start", [1])[0] == 400


def test_admin_token_gates_the_profiler(app, monkeypatch):
    monkeypatch.setenv("ADMIN_TOKEN", "s3cret")
    for method, path in (("GET", "/admin/profiler"), ("POST", "/admin/profiler/start"),
                         ("POST", "/admin/profiler/stop")):
        assert _call(app, method, path)[0] == 401
        assert _call(app, method, path, token="wrong")[0] == 401
    assert _call(app, "GET", "/admin/profiler", token="s3cret")[0] == 200
