"""The slice as a whole: the port's example binaries
(``gofr_tpu_torch/examples/``) beside the JAX package's (``examples/*/main.py``),
on the CPU with the tiny f32 model and the byte tokenizer.

Four apps serve the same weights (the JAX package's seeded init, carried
over to the port by ``models/convert.py``): the JAX ``http-server`` and
``grpc-server`` examples and the port's ``http_server`` and ``grpc_server``.
Both HTTP apps form prefill cohorts; both gRPC apps run ``BATCH_COHORT=off``.
The same prompts, sent at once so the batcher mixes their lengths, give
equal greedy ids through ``/generate`` (and its SSE stream),
``/v1/completions`` and ``LLMService/Generate`` in all four. The hello,
redis, mysql, trace and error routes answer as the JAX example's over the
port's mini servers; ``HelloService`` answers both ways; the
``OPENAI_ACCEPT_UNKNOWN_MODEL`` switch acts as in the JAX package. The
``lora_finetune`` example trains 2 steps and its merged checkpoint serves
through both of the port's servers."""

import concurrent.futures
import importlib.util
import json
import os
import pathlib
import socket
import types
import urllib.error
import urllib.request

import grpc
import jax
import numpy as np
import pytest

from gofr_tpu_torch.config import DECLARED_KEYS
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV = {"MODEL_NAME": "tiny", "TOKENIZER": "byte", "BATCH_MAX_SIZE": "4",
       "BATCH_TIMEOUT_MS": "40", "DECODE_CHUNK": "4", "LOG_LEVEL": "FATAL",
       "TIMEBASE_ENABLED": "off"}
# three lengths in three prefill buckets, sent together: cohorts split
# them, FIFO pads them into one batch
PROMPTS = ["Hi", "The port serves its first request over gRPC.",
           "A longer prompt that lands in a larger prefill bucket than the other two do, "
           "so a FIFO batch pads every row to it."]
NEW = 12


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _boot(tmp_path_factory, label, env, build):
    """``build()`` (an unstarted app) under ``env`` in a fresh directory,
    every key either package reads cleared first and restored after; the
    app is started. Returns (app, http url, grpc port)."""
    http_port, grpc_port = _free_port(), _free_port()
    env = {**env, "HTTP_PORT": str(http_port), "GRPC_PORT": str(grpc_port)}
    keys = set(DECLARED_KEYS) | set(env)
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp(label))
    try:
        app = build()
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    app.start()
    return app, f"http://127.0.0.1:{http_port}", grpc_port


def _jax_example(name):
    """Build the JAX example's app through its own ``main()``, with
    ``App.run`` held back (the test starts it)."""
    import gofr_tpu.app as jax_app

    path = REPO / "examples" / name / "main.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    built = []
    original = jax_app.App.run
    jax_app.App.run = lambda self: built.append(self)
    try:
        module.main()
    finally:
        jax_app.App.run = original
    return built[0]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from gofr_tpu_torch.datasource.minimysql import MiniMySQL
    from gofr_tpu_torch.datasource.miniredis import MiniRedis
    from gofr_tpu_torch.datasource.redis import new_client
    from gofr_tpu_torch.examples import grpc_server, http_server

    redis = MiniRedis().run()
    seed_client = new_client("127.0.0.1", redis.port)
    seed_client.set("test", "from-redis")
    seed_client.close()
    mysql = MiniMySQL(user="gofr", password="pw")
    data = {"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(redis.port), "DB_DIALECT": "mysql",
            "DB_HOST": "127.0.0.1", "DB_PORT": str(mysql.port), "DB_USER": "gofr",
            "DB_PASSWORD": "pw", "DB_NAME": "test"}
    fifo = {**ENV, "BATCH_COHORT": "off"}
    apps = {}
    apps["jax_http"] = _boot(tmp_path_factory, "jh", {**ENV, **data},
                             lambda: _jax_example("http-server"))
    params = jax.tree.map(np.asarray, apps["jax_http"][0].container.tpu.runner.params)
    model = transformer_from_tree(params, TINY, device="cpu")
    apps["jax_grpc"] = _boot(tmp_path_factory, "jg", fifo, lambda: _jax_example("grpc-server"))
    apps["torch_http"] = _boot(tmp_path_factory, "th", {**ENV, **data, "TORCH_DEVICE": "cpu"},
                               lambda: http_server.build(model=model))
    apps["torch_grpc"] = _boot(tmp_path_factory, "tg", {**fifo, "TORCH_DEVICE": "cpu"},
                               lambda: grpc_server.build(model=model))
    assert apps["torch_grpc"][0].container.tpu.batcher.cohort is False
    assert apps["torch_http"][0].container.tpu.batcher.cohort is True
    yield types.SimpleNamespace(apps=apps, redis=redis, mysql=mysql)
    for app, _, _ in apps.values():
        app.shutdown()
    redis.close()
    mysql.close()


def _get(url, path, body=None):
    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="GET" if body is None else "POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _http_ids(url, prompt):
    status, raw = _get(url, "/generate", {"text": prompt, "max_new_tokens": NEW})
    assert status == 200, raw
    return json.loads(raw)["data"]["tokens"]


def _sse_ids(url, prompt):
    status, raw = _get(url, "/generate?stream=true", {"text": prompt, "max_new_tokens": NEW})
    assert status == 200
    events = [json.loads(line[5:]) for line in raw.decode().splitlines()
              if line.startswith("data:") and line[5:].strip() not in ("", "[DONE]")]
    return [e["token"] for e in events if "token" in e]


def _completion_text(url, prompt, model=None):
    body = {"prompt": prompt, "max_tokens": NEW, "temperature": 0}
    if model:
        body["model"] = model
    status, raw = _get(url, "/v1/completions", body)
    return status, json.loads(raw)


def _grpc_ids(port, prompt):
    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        call = channel.unary_stream("/LLMService/Generate")
        return [json.loads(m)["token"] for m in call(
            json.dumps({"text": prompt, "max_new_tokens": NEW}).encode(), timeout=60)
            if "token" in json.loads(m)]


def _at_once(fn, target):
    with concurrent.futures.ThreadPoolExecutor(len(PROMPTS)) as pool:
        return list(pool.map(lambda p: fn(target, p), PROMPTS))


def test_greedy_ids_equal_across_examples_and_packages(servers):
    """The same three prompts at once: equal greedy ids from the JAX and
    the port's HTTP examples (cohorts) and gRPC examples (FIFO), through
    /generate, its SSE stream and the gRPC stream; /v1/completions gives
    the same text in both HTTP apps."""
    apps = servers.apps
    ref = _at_once(_http_ids, apps["jax_http"][1])
    assert all(len(ids) > 0 for ids in ref)
    assert _at_once(_http_ids, apps["torch_http"][1]) == ref
    assert _at_once(_sse_ids, apps["torch_http"][1]) == ref
    assert _at_once(_sse_ids, apps["jax_http"][1]) == ref
    assert _at_once(_grpc_ids, apps["torch_grpc"][2]) == ref
    assert _at_once(_grpc_ids, apps["jax_grpc"][2]) == ref
    jax_text = _at_once(lambda u, p: _completion_text(u, p), apps["jax_http"][1])
    torch_text = _at_once(lambda u, p: _completion_text(u, p), apps["torch_http"][1])
    for (js, jb), (ts, tb) in zip(jax_text, torch_text):
        assert js == ts == 200
        assert tb["choices"][0]["text"] == jb["choices"][0]["text"]
    tok = apps["torch_http"][0].container.tpu.tokenizer
    assert [tb["choices"][0]["text"] for _, tb in torch_text] == [tok.decode(ids) for ids in ref]


def test_fifo_batches_mix_buckets_where_cohorts_do_not(servers):
    """The gRPC app without cohorts dispatched fewer, mixed batches than the
    HTTP app with them, for the same arrivals (the ids above are equal)."""
    http_dev = servers.apps["torch_http"][0].container.tpu
    grpc_dev = servers.apps["torch_grpc"][0].container.tpu
    before = (http_dev.batcher.dispatches, grpc_dev.batcher.dispatches)
    _at_once(_http_ids, servers.apps["torch_http"][1])
    _at_once(_grpc_ids, servers.apps["torch_grpc"][2])
    cohort_n = http_dev.batcher.dispatches - before[0]
    fifo_n = grpc_dev.batcher.dispatches - before[1]
    assert fifo_n < cohort_n, (fifo_n, cohort_n)


@pytest.mark.parametrize("path", ["/hello", "/hello?name=ada", "/error", "/redis", "/mysql",
                                  "/trace", "/nope"])
def test_example_routes_answer_as_jax(servers, path):
    """The http example's own routes: the same status and body in both
    packages (redis and mysql over the port's mini servers, /trace through
    ``get_http_service("anotherService")``)."""
    jax_answer = _get(servers.apps["jax_http"][1], path)
    torch_answer = _get(servers.apps["torch_http"][1], path)
    assert torch_answer[0] == jax_answer[0]
    assert json.loads(torch_answer[1]) == json.loads(jax_answer[1])
    if path == "/mysql":
        assert json.loads(torch_answer[1]) == {"data": 4}


def test_health_lists_the_datasources_and_the_device(servers):
    status, raw = _get(servers.apps["torch_http"][1], "/.well-known/health")
    body = json.loads(raw)["data"]
    assert status == 200 and body["status"] == "UP"
    assert {k: v["status"] for k, v in body["details"].items()} == {
        "redis": "UP", "sql": "UP", "tpu": "UP"}
    _, jraw = _get(servers.apps["jax_http"][1], "/.well-known/health")
    assert set(json.loads(jraw)["data"]["details"]) == set(body["details"])


def test_hello_service_both_ways(servers):
    """``HelloService/SayHello`` as JSON and ``hello.Hello/SayHello``
    through the generated stub: the same answers from both gRPC apps."""
    from gofr_tpu_torch.examples.pb import hello_pb2, hello_pb2_grpc

    answers = []
    for name in ("jax_grpc", "torch_grpc"):
        with grpc.insecure_channel(f"127.0.0.1:{servers.apps[name][2]}") as channel:
            stub = hello_pb2_grpc.HelloStub(channel)
            unary = channel.unary_unary("/HelloService/SayHello")
            answers.append((
                stub.SayHello(hello_pb2.HelloRequest(name="ada"), timeout=10).message,
                stub.SayHello(hello_pb2.HelloRequest(), timeout=10).message,
                bytes(unary(b'{"name": "bo"}', timeout=10)),
                bytes(unary(b"{}", timeout=10)),
            ))
    assert answers[1] == answers[0] == (
        "Hello ada!", "Hello World!", b'{"data": "Hello bo!"}', b'{"data": "Hello World!"}')


def test_llm_embed_and_refusals_as_jax(servers):
    """``LLMService/Embed`` (the decoder's next token) and a malformed
    request's status, through both gRPC apps."""
    answers = []
    for name in ("jax_grpc", "torch_grpc"):
        with grpc.insecure_channel(f"127.0.0.1:{servers.apps[name][2]}") as channel:
            embed = channel.unary_unary("/LLMService/Embed")
            ok = json.loads(embed(json.dumps({"tokens": [5, 6, 7]}).encode(), timeout=30))
            codes = []
            for body in ({"tokens": []}, {"text": 3}, {"tokens": [1], "temperature": "hot"}):
                gen = channel.unary_stream("/LLMService/Generate")
                try:
                    list(gen(json.dumps(body).encode(), timeout=30))
                    codes.append(None)
                except grpc.RpcError as exc:
                    codes.append(exc.code())
            answers.append((ok, codes))
    assert answers[1] == answers[0]
    assert "next_token" in answers[0][0]["data"]


def test_unknown_model_name_follows_the_switch(servers, monkeypatch):
    """An unknown ``model`` is a 404 in both packages; with
    ``OPENAI_ACCEPT_UNKNOWN_MODEL=on`` both serve the base model."""
    jurl, turl = servers.apps["jax_http"][1], servers.apps["torch_http"][1]
    refused = [_completion_text(u, "Hi", model="gpt-x") for u in (jurl, turl)]
    assert refused[0][0] == refused[1][0] == 404
    monkeypatch.setenv("OPENAI_ACCEPT_UNKNOWN_MODEL", "on")
    served = [_completion_text(u, "Hi", model="gpt-x") for u in (jurl, turl)]
    base = _completion_text(turl, "Hi")
    assert served[0][0] == served[1][0] == 200
    assert served[1][1]["choices"][0]["text"] == served[0][1]["choices"][0]["text"] == \
        base[1]["choices"][0]["text"]


def test_lora_finetune_then_serve_over_http_and_grpc(tmp_path_factory, tmp_path, monkeypatch):
    """``lora_finetune finetune --model=tiny --steps=2`` through
    ``new_cmd`` and ``run_cmd``, then its merged checkpoint as
    ``MODEL_PATH`` of the port's http and grpc examples: the two serve the
    same greedy ids, and they are the merged weights', not the seeded
    init's."""
    from gofr_tpu_torch.cmd import run_cmd
    from gofr_tpu_torch.examples import grpc_server, http_server, lora_finetune
    from gofr_tpu_torch.testutil import stdout_output_for

    out = str(tmp_path / "merged")
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    monkeypatch.setenv("LOG_LEVEL", "INFO")
    monkeypatch.delenv("MODEL_NAME", raising=False)
    monkeypatch.chdir(tmp_path)
    codes = []
    text = stdout_output_for(lambda: codes.append(run_cmd(
        lora_finetune.build(), ["finetune", "--model=tiny", "--steps=2", "--rank=2",
                                f"--out={out}"])))
    assert codes == [0], text
    steps = [json.loads(line)["message"] for line in text.splitlines() if line.startswith("{")]
    assert [m.split()[:2] for m in steps] == [["step", "0"], ["step", "1"]]
    assert "merged checkpoint at" in text

    env = {**ENV, "TORCH_DEVICE": "cpu", "MODEL_PATH": out}
    http_app, url, _ = _boot(tmp_path_factory, "lh", env, http_server.build)
    grpc_app, _, gport = _boot(tmp_path_factory, "lg", {**env, "BATCH_COHORT": "off"},
                               grpc_server.build)
    seeded, _, _ = _boot(tmp_path_factory, "ls", {**ENV, "TORCH_DEVICE": "cpu"},
                         http_server.build)
    try:
        served = _at_once(_http_ids, url)
        assert _at_once(_grpc_ids, gport) == served
        merged = http_app.container.tpu.runner.model
        init = seeded.container.tpu.runner.model
        assert not np.array_equal(merged.layers[0].wq.detach().numpy(),
                                  init.layers[0].wq.detach().numpy())
    finally:
        for app in (http_app, grpc_app, seeded):
            app.shutdown()
