"""gofr_tpu_torch's OpenAI surface against gofr_tpu's.

Two apps serve the tiny model with the byte tokenizer in the default
configuration (decode pool, paged KV): the JAX package's, and the port's
on the same weights (carried over by ``models/convert.py``). The same
requests go to both:
- ``GET /v1/models``;
- greedy completions with ``logprobs``/``top_logprobs`` (pooled decode):
  equal ids and alternatives, logprobs within 1e-4;
- chat completions, stream and non-stream, their logprobs too;
- ``echo`` + ``logprobs`` at ``max_tokens: 0``: ``[None]`` + JAX
  ``score_tokens`` within 2e-5 (f32), and the prompt part unchanged when a
  completion follows;
- greedy ``n``, the streaming fan-out and ``include_usage`` frames: the
  same frames (response ids and times aside) with the same SSE ``id:``
  lines; sampled fan-outs: the same shape;
- refused requests: the same status.
Without a server: ``render_chat_prompt`` (simple form, opener override,
inline and file jinja, ``tokenizer_config.json`` discovery, the errors),
the logprobs objects, ``parse_fanout``/``stream_usage_opt``, the default
stop ids (``GEN_STOP_EOS``, ``GEN_STOP_TOKENS``) and ``score_tokens``,
each against the JAX function on the same inputs."""

import json
import os
import socket
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu_torch
from gofr_tpu.errors import HTTPError as JaxHTTPError
from gofr_tpu.openai import fanout as jfan
from gofr_tpu.openai import logprobs as jlp
from gofr_tpu.openai import parse as jparse
from gofr_tpu.openai import template as jtpl
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.errors import HTTPError
from gofr_tpu_torch.logging import Logger
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.openai import fanout as tfan
from gofr_tpu_torch.openai import logprobs as tlp
from gofr_tpu_torch.openai import parse as tparse
from gofr_tpu_torch.openai import template as ttpl
from gofr_tpu_torch.tokenizer import Tokenizer, train_bpe
from gofr_tpu_torch.tpu.device import TPUDevice, resolve_default_stop_ids

ENV = {"MODEL_NAME": "tiny", "TOKENIZER": "byte", "BATCH_MAX_SIZE": "4",
       "BATCH_TIMEOUT_MS": "2", "DECODE_CHUNK": "4", "LOG_LEVEL": "FATAL"}
LP_TOL = 1e-4  # pooled decode, f32: JAX's and the port's sums in other orders
SCORE_TOL = 2e-5  # one f32 forward (tests/test_flash.py's f32 tolerance)
CHAT = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi there"}]


def _boot(tmp_path_factory, label, env, build):
    """``build()`` under ``env`` in a fresh directory (no configs/.env),
    every key either package reads cleared first."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**env, "HTTP_PORT": str(port)}
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
    return app, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """(JAX url, port url, the JAX weights) on the same weights and
    configuration."""
    import gofr_tpu
    from gofr_tpu.openai import register_openai_routes as jax_routes

    def jax_app():
        app = gofr_tpu.new()
        jax_routes(app)
        return app

    japp, jurl = _boot(tmp_path_factory, "jax", ENV, jax_app)
    params = jax.tree.map(np.asarray, japp.container.tpu.runner.params)
    model = transformer_from_tree(params, TINY, device="cpu")

    def torch_app():
        app = gofr_tpu_torch.new(model=model)
        gofr_tpu_torch.register_openai_routes(app)
        return app

    tapp, turl = _boot(tmp_path_factory, "torch", {**ENV, "TORCH_DEVICE": "cpu"}, torch_app)
    assert tapp.container.tpu.decode_pool is not None
    yield types.SimpleNamespace(jax=jurl, torch=turl, params=params, dev=tapp.container.tpu)
    tapp.shutdown()
    japp.shutdown()


def _post(url, body, path="/v1/completions"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())
    if raw.startswith(("data: ", "id: ")):  # SSE: each frame's data, with its id: line
        return status, [_Frame(frame) for frame in raw.split("\n\n") if frame]
    return status, json.loads(raw)


class _Frame(str):
    """One SSE frame's data, carrying the frame's ``id:`` (None without)."""

    def __new__(cls, frame):
        fields = dict(line.split(": ", 1) for line in frame.split("\n"))
        self = super().__new__(cls, fields["data"])
        self.sse_id = fields.get("id")
        return self


def _both(apps, body, path="/v1/completions"):
    (js, jb), (ts, tb) = _post(apps.jax, body, path), _post(apps.torch, body, path)
    assert js == ts == 200, (jb, tb)
    if isinstance(jb, list):  # SSE: the frames number alike
        assert _numbering(tb) == _numbering(jb)
    return jb, tb


def _numbering(frames):
    """None for unnumbered frames (a fan-out), else the first SSE id of a
    run numbered one a frame."""
    ids = [f.sse_id for f in frames]
    if all(i is None for i in ids):
        return None
    first = int(ids[0])
    assert ids == [str(first + k) for k in range(len(ids))]
    return first


def _strip(frame):
    """An SSE frame without its response id and time."""
    if frame == "[DONE]":
        return frame
    f = json.loads(frame)
    f.pop("id", None)
    f.pop("created", None)
    return f


def _close(a, b, tol):
    a = [x for x in a if x is not None]
    b = [x for x in b if x is not None]
    assert len(a) == len(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=0)


# -- over HTTP, against the JAX app ----------------------------------------------

def test_models_lists_the_served_model(apps):
    for url in (apps.jax, apps.torch):
        with urllib.request.urlopen(url + "/v1/models", timeout=30) as resp:
            body = json.loads(resp.read())
        assert body == {"object": "list",
                        "data": [{"id": "tiny", "object": "model", "owned_by": "gofr_tpu"}]}


@pytest.mark.parametrize("lp", [{"logprobs": 1}, {"logprobs": 3},
                                {"logprobs": 1, "top_logprobs": 5}])
def test_pooled_logprobs_match_jax(apps, lp):
    """Greedy decode through the pool on both: equal ids, tokens, offsets
    and alternatives (ids as decoded strings), logprobs within 1e-4."""
    body = {"prompt": [1, 2, 3, 40, 50], "max_tokens": 9, "temperature": 0, **lp}
    jb, tb = _both(apps, body)
    jc, tc = jb["choices"][0], tb["choices"][0]
    assert (tc["text"], tc["finish_reason"]) == (jc["text"], jc["finish_reason"])
    assert tb["usage"] == jb["usage"]
    jl, tl = jc["logprobs"], tc["logprobs"]
    assert set(tl) == set(jl)
    assert tl["tokens"] == jl["tokens"] and tl["text_offset"] == jl["text_offset"]
    _close(tl["token_logprobs"], jl["token_logprobs"], LP_TOL)
    assert all(x <= 0 for x in tl["token_logprobs"])
    if "top_logprobs" in jl:
        for jt, tt in zip(jl["top_logprobs"], tl["top_logprobs"], strict=True):
            assert list(tt) == list(jt)  # the same alternatives, best first
            _close(list(tt.values()), list(jt.values()), LP_TOL)


def test_chat_logprobs_match_jax(apps):
    """Chat's content entries: the same tokens and bytes for the chosen
    ids and the top 5 (bytes name the ids: equal top ids), logprobs within
    1e-4; the greedy chosen id is its own best alternative."""
    body = {"messages": CHAT, "max_tokens": 8, "temperature": 0, "logprobs": True,
            "top_logprobs": 5}
    jb, tb = _both(apps, body, "/v1/chat/completions")
    jc, tc = jb["choices"][0], tb["choices"][0]
    assert tc["message"] == jc["message"] and tc["finish_reason"] == jc["finish_reason"]
    for je, te in zip(jc["logprobs"]["content"], tc["logprobs"]["content"], strict=True):
        assert (te["token"], te["bytes"]) == (je["token"], je["bytes"])
        assert abs(te["logprob"] - je["logprob"]) <= LP_TOL
        assert [a["bytes"] for a in te["top_logprobs"]] == [a["bytes"] for a in je["top_logprobs"]]
        _close([a["logprob"] for a in te["top_logprobs"]],
               [a["logprob"] for a in je["top_logprobs"]], LP_TOL)
        assert te["top_logprobs"][0]["bytes"] == te["bytes"]
        assert te["top_logprobs"][0]["logprob"] == te["logprob"]


def test_echo_scoring_is_jax_score_tokens(apps):
    """echo + logprobs at max_tokens 0: [None] + JAX score_tokens over the
    prompt (f32, within 2e-5), nothing generated; with a completion after
    it the prompt part is unchanged and its alternatives are null."""
    from gofr_tpu.models.llama import TINY as JAX_TINY
    from gofr_tpu.models.transformer import score_tokens

    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    ref = np.asarray(score_tokens(apps.params, jnp.asarray([prompt], jnp.int32), JAX_TINY))[0]
    body = {"prompt": prompt, "max_tokens": 0, "echo": True, "logprobs": 1}
    jb, tb = _both(apps, body)
    lps = tb["choices"][0]["logprobs"]["token_logprobs"]
    assert lps[0] is None and len(lps) == len(prompt)
    np.testing.assert_allclose(lps[1:], ref, atol=SCORE_TOL, rtol=0)
    _close(lps, jb["choices"][0]["logprobs"]["token_logprobs"], SCORE_TOL)
    assert tb["choices"][0]["text"] == jb["choices"][0]["text"]
    assert tb["usage"] == jb["usage"] and tb["usage"]["completion_tokens"] == 0
    body = {"prompt": prompt, "max_tokens": 3, "temperature": 0, "echo": True, "logprobs": 2}
    jb, tb = _both(apps, body)
    tl, jl = tb["choices"][0]["logprobs"], jb["choices"][0]["logprobs"]
    assert tl["token_logprobs"][: len(prompt)] == lps and len(tl["token_logprobs"]) == 14
    assert tl["top_logprobs"][: len(prompt)] == [None] * len(prompt)
    assert tl["tokens"] == jl["tokens"] and tl["text_offset"] == jl["text_offset"]
    _close(tl["token_logprobs"], jl["token_logprobs"], LP_TOL)
    assert tb["choices"][0]["text"] == jb["choices"][0]["text"]


def test_echo_without_logprobs_replays_the_prompt(apps):
    jb, tb = _both(apps, {"prompt": "echo me", "max_tokens": 3, "temperature": 0, "echo": True})
    assert tb["choices"][0]["text"] == jb["choices"][0]["text"]
    assert tb["choices"][0]["text"].startswith("echo me")
    jb, tb = _both(apps, {"prompt": "echo me", "max_tokens": 0, "echo": True})
    assert tb["choices"] == jb["choices"] and tb["usage"] == jb["usage"]


def test_greedy_n_replicates_and_bills_each(apps):
    jb, tb = _both(apps, {"prompt": [7, 8, 9], "max_tokens": 5, "temperature": 0, "n": 3})
    assert [c["index"] for c in tb["choices"]] == [0, 1, 2]
    assert len({c["text"] for c in tb["choices"]}) == 1
    assert tb["choices"] == jb["choices"]
    assert tb["usage"]["completion_tokens"] == 15 == jb["usage"]["completion_tokens"]


def test_seeded_fanout_is_reproducible_and_best_of_ranks(apps):
    """Seeded candidates derive seed + index: n = 3 twice gives the same
    three streams; best_of 4 keeps the two best of n = 4's candidates by
    mean logprob and bills all four."""
    base = {"prompt": [1, 2, 3], "max_tokens": 6, "temperature": 1.0, "seed": 11}
    a = _post(apps.torch, {**base, "n": 3})[1]
    b = _post(apps.torch, {**base, "n": 3})[1]
    texts = [c["text"] for c in a["choices"]]
    assert texts == [c["text"] for c in b["choices"]] and len(set(texts)) >= 2
    four = _post(apps.torch, {**base, "n": 4, "logprobs": 1})[1]["choices"]
    best = _post(apps.torch, {**base, "n": 2, "best_of": 4})[1]
    means = sorted(four, key=lambda c: -np.mean(c["logprobs"]["token_logprobs"]))
    assert [c["text"] for c in best["choices"]] == [c["text"] for c in means[:2]]
    assert all(c["logprobs"] is None for c in best["choices"])
    assert best["usage"]["completion_tokens"] == sum(
        len(c["logprobs"]["token_logprobs"]) for c in four)


def test_unseeded_fanout_decodes_in_the_pool(apps):
    pool = apps.dev.decode_pool
    d0 = pool.dispatches
    tb = _post(apps.torch, {"prompt": [5, 6], "max_tokens": 12, "temperature": 0.8, "n": 3})[1]
    assert len(tb["choices"]) == 3 and tb["usage"]["completion_tokens"] == 36
    assert pool.dispatches > d0 and pool.occupancy()["active"] == 0


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 4}),
    ("/v1/completions", {"prompt": "abc", "max_tokens": 4, "echo": True}),
    ("/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 4, "n": 2}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 4}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 4, "n": 2}),
])
def test_greedy_stream_frames_match_jax(apps, path, body):
    """The same frames (response id and time aside): the role frames, one
    frame a token for each index, each index's finish frame, the usage
    frame with empty choices, [DONE]."""
    body = {**body, "temperature": 0, "stream": True, "stream_options": {"include_usage": True}}
    jf, tf = _both(apps, body, path)
    assert [_strip(f) for f in tf] == [_strip(f) for f in jf]
    assert tf[-1] == "[DONE]" and json.loads(tf[-2])["choices"] == []


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": [1, 2], "max_tokens": 5}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 5, "logprobs": True}),
])
def test_sampled_stream_fanout_has_the_jax_shape(apps, path, body):
    """Sampled candidates stream at once: the frames interleave by index;
    each index ends with its finish frame; then exactly one usage frame
    (empty choices, every candidate billed), then [DONE]."""
    body = {**body, "temperature": 1.0, "n": 2, "stream": True,
            "stream_options": {"include_usage": True}}

    def shape(frames):
        assert frames[-1] == "[DONE]"
        parsed = [json.loads(f) for f in frames[:-1]]
        usage = [f for f in parsed if not f["choices"]]
        assert len(usage) == 1 and parsed[-1] is usage[0]
        assert all(f["usage"] is None for f in parsed[:-1])
        finishes = {}
        for f in parsed[:-1]:
            (c,) = f["choices"]
            assert c["index"] not in finishes  # nothing after an index's finish
            if c["finish_reason"] is not None:
                finishes[c["index"]] = c["finish_reason"]
        assert sorted(finishes) == [0, 1]
        keys = {(f["object"], tuple(sorted(f)), tuple(sorted(f["choices"][0])))
                for f in parsed[:-1]}
        return keys, usage[0]["usage"]

    jf, tf = _both(apps, body, path)
    (jkeys, jusage), (tkeys, tusage) = shape(jf), shape(tf)
    assert tkeys == jkeys
    assert tusage == jusage == {"prompt_tokens": tusage["prompt_tokens"],
                                "completion_tokens": 10,
                                "total_tokens": tusage["prompt_tokens"] + 10}


def test_chat_stream_joins_to_the_non_stream_content(apps):
    body = {"messages": CHAT, "max_tokens": 12, "temperature": 0}
    _, whole = _both(apps, body, "/v1/chat/completions")
    _, frames = _both(apps, {**body, "stream": True}, "/v1/chat/completions")
    deltas = [json.loads(f)["choices"][0]["delta"] for f in frames[:-1]]
    assert deltas[0] == {"role": "assistant"}
    content = whole["choices"][0]["message"]["content"]
    assert "".join(d.get("content", "") for d in deltas) == content
    # the chat prompt's ids through /v1/completions give the same text
    ids = apps.dev.tokenizer.encode("[system]: be brief\n[user]: hi there\n[assistant]: ")
    _, comp = _both(apps, {"prompt": ids, "max_tokens": 12, "temperature": 0})
    assert comp["choices"][0]["text"] == whole["choices"][0]["message"]["content"]


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": [1, 2], "n": 17}),
    ("/v1/completions", {"prompt": [1, 2], "n": 0}),
    ("/v1/completions", {"prompt": [1, 2], "best_of": 2, "n": 3}),
    ("/v1/completions", {"prompt": [1, 2], "echo": "false"}),
    ("/v1/completions", {"prompt": [1, 2], "logprobs": 6}),
    ("/v1/completions", {"prompt": [1, 2], "top_logprobs": -1}),
    ("/v1/completions", {"prompt": [1, 2], "max_tokens": 0}),
    ("/v1/completions", {"prompt": [1, 2], "logprobs": 2, "stream": True}),
    ("/v1/completions", {"prompt": [1, 2], "echo": True, "logprobs": 1, "stream": True}),
    ("/v1/completions", {"prompt": [1, 2], "best_of": 3, "n": 2, "stream": True}),
    ("/v1/completions", {"prompt": [1, 2], "max_tokens": 0, "echo": True, "stream": True}),
    ("/v1/completions", {"prompt": [1, 2], "stream_options": {"include_usage": True}}),
    ("/v1/completions", {"prompt": [1, 2], "stream": True, "stream_options": {"usage": True}}),
    ("/v1/completions", {"prompt": [1, 2], "logprobs": 2, "stop": ["xy"]}),
    ("/v1/completions", {"prompt": [1, 2], "suffix": "x"}),
    ("/v1/completions", {"prompt": list(range(1, 200)) * 4, "max_tokens": 0, "echo": True,
                         "logprobs": 1}),
    ("/v1/chat/completions", {"messages": CHAT, "best_of": 2}),
    ("/v1/chat/completions", {"messages": CHAT, "echo": True}),
    ("/v1/chat/completions", {"messages": CHAT, "tools": [{"type": "function"}]}),
    ("/v1/chat/completions", {"messages": CHAT, "response_format": {"type": "json_object"}}),
    ("/v1/chat/completions", {"messages": []}),
    ("/v1/chat/completions", {"messages": CHAT, "top_logprobs": 2, "stream": True}),
])
def test_refused_requests_match_jax(apps, path, body):
    (js, jb), (ts, tb) = _post(apps.jax, body, path), _post(apps.torch, body, path)
    assert ts == js == 400, (jb, tb)
    assert "error" in tb


def test_default_stop_tokens_stop_generation(tmp_path, monkeypatch):
    """GEN_STOP_TOKENS set to the id a greedy request emits at position 3
    stops that request there; GEN_STOP_EOS=off leaves nothing."""
    monkeypatch.chdir(tmp_path)
    for k in DECLARED_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in {**ENV, "TORCH_DEVICE": "cpu", "DECODE_POOL": "on"}.items():
        monkeypatch.setenv(k, v)
    dev = TPUDevice(EnvFileConfig(str(tmp_path)), Logger())
    try:
        full = dev.generate([4, 5, 6], 10)
    finally:
        dev.close()
    stop = full[3]
    first = full.index(stop)
    monkeypatch.setenv("GEN_STOP_TOKENS", str(stop))
    dev = TPUDevice(EnvFileConfig(str(tmp_path)), Logger())
    try:
        assert dev.default_stop_ids == frozenset({stop})
        assert dev.generate([4, 5, 6], 10) == full[:first]
        assert dev.generate([4, 5, 6], 10, sampler=None, logprobs=True)[0] == full[:first]
    finally:
        dev.close()


# -- without a server, against the JAX functions -----------------------------------

class _Cfg:
    def __init__(self, env):
        self.env = env

    def get(self, key):
        return self.env.get(key)

    def get_or_default(self, key, default):
        value = self.env.get(key)
        return value if value not in (None, "") else default


def _ctx(env, tok):
    return types.SimpleNamespace(config=_Cfg(env), tpu=types.SimpleNamespace(tokenizer=tok))


@pytest.mark.parametrize("config", [
    {}, {"GEN_STOP_EOS": "off"}, {"GEN_STOP_TOKENS": "5, 7"},
    {"GEN_STOP_TOKENS": "9", "GEN_STOP_EOS": "off"}, {"GEN_STOP_TOKENS": "a,b"},
])
@pytest.mark.parametrize("tokenizer", [None, "byte"])
def test_default_stop_ids_match_jax(config, tokenizer):
    from gofr_tpu import tokenizer as jtok
    from gofr_tpu.tpu.device import TPUDevice as JaxDevice

    ttok = Tokenizer.byte_level() if tokenizer else None
    jdev = types.SimpleNamespace(model_path=None,
                                 tokenizer=jtok.Tokenizer.byte_level() if tokenizer else None)
    try:
        want = JaxDevice._resolve_default_stop_ids(jdev, _Cfg(config))
    except ValueError:
        with pytest.raises(ValueError, match="GEN_STOP_TOKENS"):
            resolve_default_stop_ids(_Cfg(config), ttok)
        return
    assert resolve_default_stop_ids(_Cfg(config), ttok) == want


CHATML = ("{% for m in messages %}<|im_start|>{{ m.role }}\n{{ m.content }}<|im_end|>\n"
          "{% endfor %}{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
LLAMA3 = ("{{ bos_token }}{% for m in messages %}<|start_header_id|>{{ m.role }}"
          "<|end_header_id|>\n\n{{ m.content }}<|eot_id|>{% endfor %}"
          "{% if add_generation_prompt %}<|start_header_id|>assistant<|end_header_id|>\n\n"
          "{% endif %}")


def _hf_tokenizers(tmp_path):
    """(JAX, port) tokenizers from one hand-written tokenizer.json with the
    Llama-3 specials, and its path (beside it a tokenizer_config.json)."""
    from gofr_tpu import tokenizer as jtok

    from gofr_tpu_torch.tokenizer import _byte_unicode_tables

    tok = train_bpe("the quick brown fox jumps over the lazy dog " * 4, vocab_size=280)
    b2u, _ = _byte_unicode_tables()

    def s(i):
        return "".join(b2u[b] for b in tok._pieces[i])

    n = 256 + len(tok.merges)
    spec = {"added_tokens": [{"id": n, "content": "<|begin_of_text|>"},
                             {"id": n + 1, "content": "<|end_of_text|>"}],
            "model": {"type": "BPE", "vocab": {s(i): i for i in range(n)},
                      "merges": [f"{s(a)} {s(b)}" for a, b in tok.merges]}}
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"chat_template": LLAMA3}))
    return jtok.Tokenizer.from_hf_json(str(path)), Tokenizer.from_hf_json(str(path)), str(path)


@pytest.mark.parametrize("form", [
    "default", "custom", "opener", "inline jinja", "jinja file", "discovery",
    "discovery under a simple template", "jinja wins over discovery",
])
def test_render_chat_prompt_matches_jax(tmp_path, form):
    jt, tt, tok_path = _hf_tokenizers(tmp_path)
    (tmp_path / "t.jinja").write_text(CHATML)
    env = {
        "default": {},
        "custom": {"CHAT_TEMPLATE": "<{role}> {content} </{role}>\n"},
        "opener": {"CHAT_TEMPLATE": "<{role}> {content}\n", "CHAT_TEMPLATE_OPENER": "<asst>:"},
        "inline jinja": {"CHAT_TEMPLATE_JINJA": CHATML},
        "jinja file": {"CHAT_TEMPLATE_JINJA": str(tmp_path / "t.jinja")},
        "discovery": {"TOKENIZER_PATH": tok_path},
        "discovery under a simple template": {"TOKENIZER_PATH": tok_path,
                                              "CHAT_TEMPLATE_OPENER": "<asst>"},
        "jinja wins over discovery": {"TOKENIZER_PATH": tok_path, "CHAT_TEMPLATE_JINJA": CHATML},
    }[form]
    want = jtpl.render_chat_prompt(_ctx(env, jt), CHAT)
    got = ttpl.render_chat_prompt(_ctx(env, tt), CHAT)
    assert got == want
    if form == "discovery":
        assert got.startswith("<|begin_of_text|><|start_header_id|>system")


@pytest.mark.parametrize("env,messages", [
    ({"CHAT_TEMPLATE": "{role} {nope}"}, CHAT),
    ({"CHAT_TEMPLATE": "{role} only"}, CHAT),
    ({"CHAT_TEMPLATE_JINJA": "{{ raise_exception('only user turns') }}"}, CHAT),
    ({}, []),
    ({}, [{"role": "user"}]),
])
def test_render_chat_prompt_errors_match_jax(env, messages):
    tok = Tokenizer.byte_level()
    with pytest.raises(JaxHTTPError) as jexc:
        jtpl.render_chat_prompt(_ctx(env, None), messages)
    with pytest.raises(HTTPError) as texc:
        ttpl.render_chat_prompt(_ctx(env, tok), messages)
    assert texc.value.status_code == jexc.value.status_code
    assert str(texc.value) == str(jexc.value)


def test_corrupt_tokenizer_config_is_a_500(tmp_path):
    (tmp_path / "tokenizer_config.json").write_text("{truncated")
    env = {"TOKENIZER_PATH": str(tmp_path / "tokenizer.json")}
    with pytest.raises(HTTPError) as exc:
        ttpl.render_chat_prompt(_ctx(env, None), CHAT)
    assert exc.value.status_code == 500


def _lp_cases():
    """(tokenizer kind, lp_list, ids, tops, top_n, prompt positions) from a
    seeded generator: multi-byte characters split across byte tokens, a
    stop-truncated lp list, echo prompt positions, duplicate decodes."""
    rng = np.random.default_rng(0)
    text_ids = list("héllo ☃ wörld".encode())
    cases = []
    for kind in (None, "byte"):
        for n, cut, top_n, prompt in ((6, 6, 0, 0), (len(text_ids), len(text_ids), 3, 0),
                                      (8, 5, 2, 0), (9, 9, 5, 4)):
            ids = text_ids[:n] if kind else rng.integers(0, 300, n).tolist()
            lps = rng.uniform(-6, 0, cut).tolist()
            if prompt:
                lps = [None] + lps[1:]
            tops = [[(int(rng.integers(0, 256)), float(v))
                     for v in sorted(rng.uniform(-9, 0, 5))[::-1]]
                    for _ in range(cut - prompt)]
            cases.append((kind, lps, ids, tops if top_n else None, top_n, prompt))
    return cases


@pytest.mark.parametrize("case", range(len(_lp_cases())))
def test_logprobs_objects_match_jax(case):
    kind, lps, ids, tops, top_n, prompt = _lp_cases()[case]
    from gofr_tpu import tokenizer as jtok

    jt = jtok.Tokenizer.byte_level() if kind else None
    tt = Tokenizer.byte_level() if kind else None
    assert (tlp.logprobs_obj(tt, lps, ids, tops, top_n, prompt_positions=prompt)
            == jlp._logprobs_obj(jt, lps, ids, tops, top_n, prompt_positions=prompt))
    if kind and not prompt:
        assert (tlp.chat_logprobs_obj(tt, lps, ids, tops, top_n)
                == jlp._chat_logprobs_obj(jt, lps, ids, tops, top_n))


FANOUT_BODIES = [
    {}, {"n": 3}, {"n": 2, "best_of": 4}, {"best_of": 5}, {"n": 16}, {"n": 17},
    {"best_of": 17}, {"n": 0}, {"n": True}, {"n": "2"}, {"n": 3, "best_of": 2},
    {"echo": True}, {"echo": False}, {"echo": "false"}, {"echo": None, "n": None},
]


@pytest.mark.parametrize("allow_best_of", [True, False])
def test_parse_fanout_matches_jax(allow_best_of):
    for body in FANOUT_BODIES:
        try:
            want = jparse._parse_fanout(body, allow_best_of)
        except JaxHTTPError as exc:
            with pytest.raises(HTTPError) as got:
                tparse.parse_fanout(body, allow_best_of)
            assert (got.value.status_code, str(got.value)) == (exc.status_code, str(exc)), body
            continue
        assert tparse.parse_fanout(body, allow_best_of) == want, body


@pytest.mark.parametrize("body", [
    {}, {"stream": True}, {"stream": True, "stream_options": {"include_usage": True}},
    {"stream": True, "stream_options": {"include_usage": False}},
    {"stream_options": {"include_usage": True}}, {"stream": True, "stream_options": []},
    {"stream": True, "stream_options": {"include_usage": 1}},
    {"stream": True, "stream_options": {"include_usages": True}},
])
def test_stream_usage_opt_matches_jax(body):
    try:
        want = jparse._stream_usage_opt(body)
    except JaxHTTPError as exc:
        with pytest.raises(HTTPError) as got:
            tparse.stream_usage_opt(body)
        assert str(got.value) == str(exc)
        return
    assert tparse.stream_usage_opt(body) == want


def test_candidate_samplers_derive_seed_plus_index():
    body = {"temperature": 0.7, "seed": "7", "top_k": 5}
    got = [(s.seed, s.seeded, s.temperature, s.top_k) for s in tfan.candidate_samplers(body, 3)]
    want = [(s.seed, s.seeded, s.temperature, s.top_k) for s in jfan._candidate_samplers(body, 3)]
    assert got == want == [(7, True, 0.7, 5), (8, True, 0.7, 5), (9, True, 0.7, 5)]
    with pytest.raises(HTTPError, match="seed"):
        tfan.candidate_samplers({"seed": "x"}, 2)


def test_linked_cancel_sets_its_own_side_only():
    import threading

    shared = threading.Event()
    a, b = tfan.LinkedCancel(shared), tfan.LinkedCancel(shared)
    a.set()
    assert a.is_set() and not b.is_set() and not shared.is_set()
    shared.set()
    assert b.is_set()


def test_score_tokens_matches_jax():
    """score_tokens on the JAX weights: one f32 forward, within 2e-5;
    the runner's bucket padding leaves the real positions unchanged."""
    from gofr_tpu.models.llama import TINY as JAX_TINY
    from gofr_tpu.models.transformer import init_transformer, score_tokens

    params = jax.tree.map(np.asarray, init_transformer(jax.random.key(3), JAX_TINY))
    model = transformer_from_tree(params, TINY, device="cpu")
    tokens = np.random.default_rng(3).integers(0, TINY.vocab_size, (2, 40)).astype(np.int32)
    want = np.asarray(score_tokens(params, jnp.asarray(tokens), JAX_TINY))
    got = model.score_tokens(torch.from_numpy(tokens))
    assert got.shape == (2, 39) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=SCORE_TOL, rtol=0)
    padded = np.zeros((1, 64), np.int32)
    padded[0, :40] = tokens[0]
    np.testing.assert_allclose(model.score_tokens(torch.from_numpy(padded))[0, :39].numpy(),
                               want[0], atol=SCORE_TOL, rtol=0)
