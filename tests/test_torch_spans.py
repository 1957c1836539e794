"""gofr_tpu_torch's device trace spans against gofr_tpu's
(``tests/test_telemetry.py::test_chat_trace_is_one_connected_tree``,
``tests/test_profiling.py::test_batch_span_tags``).

- One chat request to a JAX app and a port app (echo; the tiny model on
  the same weights), each with an in-memory exporter: the request's trace
  holds the same span names, each under a parent of the same name, with
  the same tag keys; ``tpu-batch`` descends from the HTTP server span and
  carries ``tpu.model`` and a device time above 0; ``tpu-<model>-generate``
  carries ``tpu.tokens_out``.
- ``infer`` on the tiny model: a ``tpu-tiny`` span over one ``tpu-batch``
  whose tags equal the JAX device's (``tpu.batch_size`` "1", the model,
  a device time), and the dispatch's ``TPULog`` at debug.
- A dispatch thread keeps no span active after its batch.
"""

import json
import os
import socket
import urllib.request

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.telemetry as jt
import gofr_tpu.tracing as jtracing
import gofr_tpu_torch
import gofr_tpu_torch.telemetry as tt
import gofr_tpu_torch.tracing as ttracing
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu.openai_compat import register_openai_routes as jax_routes
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.metrics import Registry
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.testutil import MockLogger
from gofr_tpu_torch.tpu.device import TPUDevice, TPULog

BASE = {"LOG_LEVEL": "FATAL", "TOKENIZER": "byte", "BATCH_MAX_SIZE": "4",
        "BATCH_TIMEOUT_MS": "1", "FLIGHT_SLOW_MS": "60000"}
SETTINGS = {"echo": {"MODEL_NAME": "echo", "ECHO_STEP_MS": "1"},
            "tiny": {"MODEL_NAME": "tiny", "TORCH_DEVICE": "cpu", "MODEL_BUCKETS": "64",
                     "DECODE_SLOTS": "2"}}
TAGGED = ("tpu-batch", "tpu-echo-generate", "tpu-tiny-generate")


class _ListExporter:
    def __init__(self):
        self.spans = []

    def export(self, span):
        self.spans.append(span)

    def shutdown(self):
        pass


@pytest.fixture(autouse=True)
def _no_leaked_record():
    for mod in (jt, tt):
        mod.activate_record(None)
    yield
    for mod in (jt, tt):
        mod.activate_record(None)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def env(monkeypatch, tmp_path):
    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    for key, value in BASE.items():
        monkeypatch.setenv(key, value)
    return monkeypatch


def _chat(port):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({"messages": [{"role": "user", "content": "trace me"}],
                         "max_tokens": 4, "temperature": 0}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read()), dict(resp.headers.items())


def _trace(pkg, routes, tracing, env, model=None):
    """One chat request's spans on a fresh app of ``pkg`` with an
    in-memory exporter: [(name, parent's name, tags)] and the spans."""
    env.setenv("HTTP_PORT", str(_free_port()))
    app = pkg.new(model=model) if model is not None else pkg.new()
    routes(app)
    exporter = _ListExporter()
    previous = tracing.get_tracer()
    tracing.set_global_tracer(tracing.Tracer(exporter))
    app.start()
    try:
        body, headers = _chat(app.http_port)
    finally:
        app.shutdown()
        tracing.set_global_tracer(previous)
    corr = headers["X-Correlation-ID"]
    spans = [s for s in exporter.spans if s.trace_id == corr]
    return body, spans


def _shape(spans):
    by_id = {s.span_id: s for s in spans}
    return sorted(
        (s.name, by_id[s.parent_id].name if s.parent_id in by_id else None,
         tuple(sorted(s.tags)))
        for s in spans
    )


def _descends(span, ancestor, spans):
    by_id = {s.span_id: s for s in spans}
    cursor, hops = span, 0
    while cursor.parent_id is not None and hops < 10:
        cursor = by_id[cursor.parent_id]
        hops += 1
    return cursor is ancestor


@pytest.mark.parametrize("model", ["echo", "tiny"])
def test_a_chat_trace_is_the_jax_tree(env, model):
    for key, value in SETTINGS[model].items():
        env.setenv(key, value)
    jbody, jspans = _trace(gofr_tpu, jax_routes, jtracing, env)
    weights = None
    if model == "tiny":
        jdev = None
        from gofr_tpu.config import EnvConfig
        from gofr_tpu.logging import Level as JaxLevel
        from gofr_tpu.metrics import Registry as JaxRegistry
        from gofr_tpu.testutil import MockLogger as JaxMockLogger
        from gofr_tpu.tpu.device import new_device

        jdev = new_device(EnvConfig(), JaxMockLogger(JaxLevel.FATAL), JaxRegistry())
        weights = transformer_from_tree(jax.tree.map(np.asarray, jdev.runner.params), TINY,
                                        device="cpu")
        jdev.close()
    tbody, tspans = _trace(gofr_tpu_torch, gofr_tpu_torch.register_openai_routes, ttracing,
                           env, model=weights)
    assert _shape(tspans) == _shape(jspans)
    by_name = {s.name: s for s in tspans}
    server, batch = by_name["POST /v1/chat/completions"], by_name["tpu-batch"]
    assert server.kind == "SERVER" and server.parent_id is None
    assert _descends(batch, server, tspans)
    assert batch.tags["tpu.model"] == model and int(batch.tags["tpu.device_time_us"]) > 0
    generate = by_name[f"tpu-{model}-generate"]
    assert batch.parent_id == generate.span_id
    assert generate.tags["tpu.tokens_out"] == str(tbody["usage"]["completion_tokens"])
    assert tbody["choices"][0]["message"] == jbody["choices"][0]["message"]
    for name in TAGGED:
        jtags = {s.name: s.tags for s in jspans}.get(name)
        if jtags is not None:
            assert set(by_name[name].tags) == set(jtags)
            if name != "tpu-batch":
                assert by_name[name].tags == jtags


def _spy(tracing, names):
    tracer = tracing.get_tracer()
    orig = tracer.start_span
    spans = []

    def spy(name, **kw):
        span = orig(name, **kw)
        if name in names:
            spans.append(span)
        return span

    tracer.start_span = spy
    return spans, lambda: setattr(tracer, "start_span", orig)


def test_infer_tags_its_batch_span_as_jax(env):
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level as JaxLevel
    from gofr_tpu.metrics import Registry as JaxRegistry
    from gofr_tpu.testutil import MockLogger as JaxMockLogger
    from gofr_tpu.tpu.device import new_device

    for key, value in {**SETTINGS["tiny"], "BATCH_MAX_SIZE": "2", "DECODE_POOL": "off"}.items():
        env.setenv(key, value)
    jdev = new_device(EnvConfig(), JaxMockLogger(JaxLevel.INFO), JaxRegistry())
    logger = MockLogger()
    tdev = TPUDevice(EnvFileConfig(os.getcwd()), logger, metrics=Registry(),
                     model=transformer_from_tree(jax.tree.map(np.asarray, jdev.runner.params),
                                                 TINY, device="cpu"))
    tags = []
    try:
        for dev, tracing in ((jdev, jtracing), (tdev, ttracing)):
            spans, unpatch = _spy(tracing, ("tpu-batch", "tpu-tiny"))
            try:
                dev.infer({"tokens": [1, 2, 3]})
            finally:
                unpatch()
            batch = [s for s in spans if s.name == "tpu-batch"][-1]
            outer = [s for s in spans if s.name == "tpu-tiny"][-1]
            assert batch.parent_id == outer.span_id and batch.trace_id == outer.trace_id
            assert int(batch.tags["tpu.device_time_us"]) > 0
            tags.append({k: v for k, v in batch.tags.items() if k != "tpu.device_time_us"})
        assert tags[0] == tags[1] == {"tpu.batch_size": "1", "tpu.model": "tiny"}
        logged = [json.loads(line)["message"] for line in logger.lines
                  if json.loads(line)["level"] == "DEBUG"
                  and isinstance(json.loads(line)["message"], dict)
                  and json.loads(line)["message"].get("datasource") == "tpu"]
        assert logged and logged[-1]["op"] == "batch" and logged[-1]["batch_size"] == 1
        assert logged[-1]["model"] == "tiny" and logged[-1]["duration_us"] > 0
        # no span stays active on a dispatch thread after its batch
        leftovers = []
        tdev.batcher._dispatch_pool.submit(
            lambda: leftovers.append(ttracing.current_span())).result(10)
        assert leftovers == [None]
    finally:
        tdev.close()
        jdev.close()


def test_the_tpulog_renders_as_jax():
    from gofr_tpu.tpu.device import TPULog as JaxLog

    for args in (("tiny", "batch", 2, 1234), ("echo", "batch", 1, 5)):
        assert TPULog(*args).log_fields() == JaxLog(*args).log_fields()
        assert TPULog(*args).pretty_terminal() == JaxLog(*args).pretty_terminal()
