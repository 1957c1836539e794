"""gofr_tpu_torch's encoder and MLP serving against gofr_tpu's, on the CPU.

Apps of both packages serve the same weights (carried over by
``models/convert.py``) with the byte tokenizer, and get the same requests:
- ``POST /v1/embeddings`` on bert-tiny (bf16) with each input form (a
  string, a list of strings, an id list, a list of id lists): embeddings
  within the bf16 tolerance (2e-2), and equal ``object``, ``model``,
  ``index`` and ``usage``; the refusals (a decoder model, bad inputs, an
  item over the 128-token bucket, an empty item, no device) with equal
  status and text; completions on an encoder or MLP deployment alike;
- ``/infer`` through a copy of ``examples/http-server/main.py``'s handler:
  on ``mlp`` (f32, 2e-5) with its refusals, and on ``tiny`` (the decoder's
  greedy next token, exactly);
- ``_BertRunner.run_batch`` and ``_MLPRunner.run_batch`` against the JAX
  runners on the same payloads;
- the runner selection: the ``mlp`` default, an unknown ``MODEL_NAME``,
  ``LORA_ADAPTERS`` on an encoder (equal errors)."""

import asyncio
import json
import os
import socket
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import gofr_tpu_torch
from gofr_tpu.errors import HTTPError as JaxHTTPError
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.errors import HTTPError
from gofr_tpu_torch.logging import Logger
from gofr_tpu_torch.models.bert import BERT_TINY
from gofr_tpu_torch.models.convert import bert_from_tree, mlp_from_tree, transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.models.mlp import MLPConfig
from gofr_tpu_torch.tpu.device import TPUDevice

ENV = {"TOKENIZER": "byte", "BATCH_MAX_SIZE": "8", "BATCH_TIMEOUT_MS": "20",
       "LOG_LEVEL": "FATAL"}
EMBED_TOL = 2e-2  # bf16 (tests/test_flash.py's)
MLP_TOL = 2e-5  # f32


def make_infer_handler(http_error):
    """``examples/http-server/main.py``'s ``/infer`` handler (a user's
    route, not the package's), raising ``http_error``."""

    async def infer_handler(ctx):
        if ctx.tpu is None:
            raise http_error(503, "tpu not configured (set MODEL_NAME)")
        payload = ctx.bind() if ctx.request.body else {"x": [0.0] * 64}
        if not isinstance(payload, dict):
            raise http_error(400, 'request body must be a JSON object like {"tokens": [...]}')
        data = payload.get("x") or payload.get("tokens")
        if not data:
            raise http_error(400, 'missing "x" (features) or "tokens" (ids) in body')
        result = await ctx.tpu.infer_async(data)
        if isinstance(result, dict):  # transformer prefill state -> next token
            return {"next_token": result["next_token"]}
        return {"y": np.asarray(result).tolist()}

    return infer_handler


def _with_env(env, fn):
    """``fn()`` with every key either package reads cleared, then ``env``."""
    keys = set(DECLARED_KEYS) | set(env) | {"LOG_LEVEL"}
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _boot(tmp_path_factory, label, env, build):
    """``build()`` under ``env`` in a fresh directory -> (app, url)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp(label))
    try:
        app = _with_env({**env, "HTTP_PORT": str(port)}, build)
    finally:
        os.chdir(cwd)
    app.start()
    return app, f"http://127.0.0.1:{port}"


def _jax_app(with_infer=True):
    import gofr_tpu
    from gofr_tpu.openai import register_openai_routes

    app = gofr_tpu.new()
    register_openai_routes(app)
    if with_infer:
        app.post("/infer", make_infer_handler(JaxHTTPError))
    if app.container.tpu is not None:
        app.container.tpu.wait_ready(120)
    return app


def _port_app(model=None):
    app = gofr_tpu_torch.new(model=model)
    gofr_tpu_torch.register_openai_routes(app)
    app.post("/infer", make_infer_handler(HTTPError))
    return app


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """Pairs of apps (JAX url, port url) on the same weights: bert-tiny,
    mlp, tiny and one without a model; and the bert and mlp devices."""
    booted, pairs = [], {}

    def pair(name, env, convert):
        japp, jurl = _boot(tmp_path_factory, f"jax-{name}", env, _jax_app)
        booted.append(japp)
        model = convert(japp.container.tpu) if convert else None
        tapp, turl = _boot(tmp_path_factory, f"torch-{name}", {**env, "TORCH_DEVICE": "cpu"},
                           lambda: _port_app(model))
        booted.append(tapp)
        pairs[name] = (jurl, turl, japp.container.tpu, tapp.container.tpu)

    def params(dev):
        return jax.tree.map(np.asarray, dev.runner.params)

    try:
        pair("bert", {**ENV, "MODEL_NAME": "bert-tiny"},
             lambda dev: bert_from_tree(params(dev), BERT_TINY, "cpu"))
        pair("mlp", {**ENV, "MODEL_NAME": "mlp"},
             lambda dev: mlp_from_tree(params(dev), MLPConfig(), "cpu"))
        pair("tiny", {**ENV, "MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "4"},
             lambda dev: transformer_from_tree(params(dev), TINY, "cpu"))
        pair("none", ENV, None)
        yield types.SimpleNamespace(**pairs)
    finally:
        for app in booted:
            app.shutdown()


def _post(url, body, path):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, raw = resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read().decode()
    if raw.startswith(("data: ", "id: ")):  # SSE: whole frames, their id: lines included
        return status, [frame for frame in raw.split("\n\n") if frame]
    return status, json.loads(raw)


def _both(pair, body, path):
    return _post(pair[0], body, path), _post(pair[1], body, path)


# -- /v1/embeddings -----------------------------------------------------------------

INPUTS = {
    "a string": "the quick brown fox",
    "a list of strings": ["attention", "is computed tile by tile", "x"],
    "an id list": [5, 17, 300, 29999, 42],
    "a list of id lists": [[1], list(range(100, 228)), [7, 7, 7]],
}


@pytest.mark.parametrize("form", INPUTS)
def test_embeddings_match_jax(apps, form):
    (js, jb), (ts, tb) = _both(apps.bert, {"input": INPUTS[form], "model": "x"}, "/v1/embeddings")
    assert js == ts == 200, (jb, tb)
    assert tb["object"] == jb["object"] == "list"
    assert tb["model"] == jb["model"] == "bert-tiny"
    assert tb["usage"] == jb["usage"]
    assert [r["index"] for r in tb["data"]] == [r["index"] for r in jb["data"]]
    assert all(r["object"] == "embedding" for r in tb["data"] + jb["data"])
    got = np.asarray([r["embedding"] for r in tb["data"]])
    want = np.asarray([r["embedding"] for r in jb["data"]])
    assert got.shape == want.shape == (len(jb["data"]), BERT_TINY.dim)
    np.testing.assert_allclose(got, want, rtol=EMBED_TOL, atol=EMBED_TOL)


def test_a_multi_item_request_packs_into_one_dispatch(apps):
    dev = apps.bert[3]
    before = dev.batcher.dispatches
    status, body = _post(apps.bert[1], {"input": ["a", "bb", "ccc", "dddd"]}, "/v1/embeddings")
    assert status == 200 and len(body["data"]) == 4
    assert dev.batcher.dispatches - before == 1


REFUSED = {
    "not an object": ["a"],
    "no input": {},
    "empty input list": {"input": []},
    "an empty item": {"input": [[]]},
    "a float item": {"input": [1.5]},
    "a mixed id list": {"input": [[1, "a"]]},
    "an item over the bucket": {"input": [list(range(129))]},
    "a string of 129 bytes": {"input": "y" * 129},
    "an empty string": {"input": [""]},
}


@pytest.mark.parametrize("case", REFUSED)
def test_embeddings_refusals_match_jax(apps, case):
    (js, jb), (ts, tb) = _both(apps.bert, REFUSED[case], "/v1/embeddings")
    assert js == ts == 400 and jb == tb


def test_an_id_past_the_vocabulary_is_refused(apps):
    """A difference that stays (ROADMAP §C): JAX's gather clamps an id past
    the table and embeds it; on the card such an index is a device fault,
    so the port answers 400."""
    (js, jb), (ts, tb) = _both(apps.bert, {"input": [[5, 30522]]}, "/v1/embeddings")
    assert js == 200 and len(jb["data"]) == 1
    assert ts == 400
    assert tb["error"]["message"] == ("'1' invalid parameter token ids must be in [0, 30522) "
                                      "for model 'bert-tiny'")


@pytest.mark.parametrize("name", ["mlp", "tiny", "none"])
def test_embeddings_without_an_encoder_match_jax(apps, name):
    (js, jb), (ts, tb) = _both(getattr(apps, name), {"input": "hi"}, "/v1/embeddings")
    assert js == ts == (503 if name == "none" else 400) and jb == tb


@pytest.mark.parametrize("name", ["bert", "mlp"])
@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hi", "max_tokens": 2}),
    ("/v1/completions", {"prompt": "hi", "max_tokens": 2, "stream": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 2}),
])
def test_completions_on_an_encoder_or_mlp_match_jax(apps, name, path, body):
    (js, jb), (ts, tb) = _both(getattr(apps, name), body, path)
    assert js == ts and jb == tb, (js, jb, ts, tb)


# -- /infer ---------------------------------------------------------------------------

def test_infer_on_mlp_matches_jax(apps):
    x = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)

    def send(url):
        async def go():
            loop = asyncio.get_running_loop()
            return await asyncio.gather(*(
                loop.run_in_executor(None, _post, url, {"x": row.tolist()}, "/infer") for row in x))
        return asyncio.run(go())

    for (js, jb), (ts, tb) in zip(send(apps.mlp[0]), send(apps.mlp[1])):
        assert js == ts == 200
        np.testing.assert_allclose(tb["data"]["y"], jb["data"]["y"], rtol=MLP_TOL, atol=MLP_TOL)


@pytest.mark.parametrize("body", [{"x": [0.0] * 63}, {"tokens": [1, 2, 3]}, {"x": []},
                                  [1, 2], {}])
def test_infer_refusals_on_mlp_match_jax(apps, body):
    (js, jb), (ts, tb) = _both(apps.mlp, body, "/infer")
    assert js == ts and jb == tb, (js, jb, ts, tb)
    assert js != 200 or body == {}


@pytest.mark.parametrize("body", [{"tokens": [5, 3, 8, 1, 9, 2]}, {"tokens": [200] * 70},
                                  {"tokens": "hello"}])
def test_infer_on_the_decoder_gives_jax_next_token(apps, body):
    (js, jb), (ts, tb) = _both(apps.tiny, body, "/infer")
    assert js == ts == 200 and tb == jb


def test_infer_on_bert_matches_jax(apps):
    (js, jb), (ts, tb) = _both(apps.bert, {"tokens": [1, 2, 3, 4]}, "/infer")
    assert js == ts == 200
    np.testing.assert_allclose(tb["data"]["y"], jb["data"]["y"], rtol=EMBED_TOL, atol=EMBED_TOL)


# -- the runners ---------------------------------------------------------------------

def test_bert_runner_run_batch_matches_jax(apps):
    jax_dev, port_dev = apps.bert[2], apps.bert[3]
    rng = np.random.default_rng(4)
    payloads = [{"tokens": rng.integers(0, 30522, n).tolist()} for n in (1, 5, 128, 77, 300)]
    want = jax_dev.runner.run_batch([jax_dev.runner.prepare(p) for p in payloads])
    got = port_dev.runner.run_batch([port_dev.runner.prepare(p) for p in payloads])
    assert len(got) == len(want) == len(payloads)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=EMBED_TOL, atol=EMBED_TOL)
    assert port_dev.runner.bucket == jax_dev.runner.bucket == 128


def test_mlp_runner_run_batch_matches_jax(apps):
    jax_dev, port_dev = apps.mlp[2], apps.mlp[3]
    rows = list(np.random.default_rng(5).standard_normal((3, 64)).astype(np.float32))
    want = jax_dev.runner.run_batch([jax_dev.runner.prepare(r) for r in rows])
    got = port_dev.runner.run_batch([port_dev.runner.prepare(r) for r in rows])
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=MLP_TOL, atol=MLP_TOL)


def test_encoders_build_no_serving_machinery(apps):
    for dev in (apps.bert[3], apps.mlp[3]):
        assert dev.decode_pool is None and dev.kv_pool is None and dev.scheduler is None
        assert dev.list_adapters() == []
        with pytest.raises(NotImplementedError, match="transformer"):
            dev.generate([1, 2, 3], 4)
    assert apps.bert[3].runner.model.device.type == "cpu"


# -- the runner selection --------------------------------------------------------------

def _port_device(env):
    return _with_env({**env, "TORCH_DEVICE": "cpu"},
                     lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger()))


def _jax_device(env):
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level
    from gofr_tpu.metrics import Registry
    from gofr_tpu.testutil import MockLogger
    from gofr_tpu.tpu.device import new_device

    return _with_env(env, lambda: new_device(EnvConfig(), MockLogger(Level.ERROR), Registry()))


@pytest.mark.parametrize("env", [{"MODEL_NAME": "gpt-9"},
                                 {"MODEL_NAME": "bert-tiny", "LORA_ADAPTERS": "a=/nowhere"},
                                 {"MODEL_NAME": "mlp", "LORA_ADAPTERS": "a=/nowhere"}])
def test_runner_selection_errors_match_jax(env):
    with pytest.raises(ValueError) as want:
        _jax_device(env)
    with pytest.raises(ValueError) as got:
        _port_device(env)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["mlp", "bert-tiny", "bert-base"])
def test_the_families_need_a_card_unless_cpu_is_asked_for(monkeypatch, name):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _with_env({"MODEL_NAME": name}, lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger()))


def test_the_default_model_is_mlp():
    dev = _port_device({})
    try:
        assert dev.model_name == "mlp" and type(dev.runner).__name__ == "_MLPRunner"
        assert dev.infer([0.0] * 64).shape == (16,)
    finally:
        dev.close()
    jdev = _jax_device({})
    try:
        assert jdev.model_name == "mlp"
    finally:
        jdev.close()
