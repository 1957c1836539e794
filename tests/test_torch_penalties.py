"""gofr_tpu_torch's penalties and ``logit_bias`` against the JAX package on
the CPU:
- ``apply_penalties`` and its helpers against ``gofr_tpu.ops.sampling``
  (f32: bit-equal), the cases of ``tests/test_sampling.py``, and the
  Sampler's parse and validation;
- penalized greedy and seeded-sampled ids equal to the JAX device's on the
  tiny model (same weights, carried over by ``models/convert.py``), solo
  and pooled; the seeded requests sample with ``top_k=1`` (the port cannot
  reproduce ``jax.random``'s draws, so equal ids need a draw that does not
  depend on them);
- ``tests/test_pool_penalties.py``'s five cases on the port's pool
  (pooled equals solo, the bias row zeroed on slot reuse, mixed
  co-tenants, lazy mode solos then pools, off mode always solos);
- ``tests/test_openai_compat.py``'s penalty and ``logit_bias`` cases
  through the port's HTTP app (an out-of-vocab bias id is a 400 before
  the stream commits);
- the raw logprobs of a penalized request."""

import os
import queue
import socket
import threading
import time
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu_torch
from gofr_tpu.ops import sampling as js
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.errors import InvalidParamError
from gofr_tpu_torch.logging import Logger
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.ops import sampling as ts
from gofr_tpu_torch.ops.sampling import Sampler
from gofr_tpu_torch.tpu.device import TPUDevice

PROMPT = [1, 2, 3]
PEN = dict(presence_penalty=2.0, frequency_penalty=2.0)
LP_TOL = 1e-4


def _np(x):
    return np.asarray(x)


# -- the functions ---------------------------------------------------------------------

def test_apply_repetition_penalty_semantics_match_jax():
    logits = np.asarray([[2.0, -2.0, 1.0, 3.0]], np.float32)
    presence = np.asarray([[True, True, False, False]])
    for penalty in (2.0, 1.0):
        got = ts.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(presence),
                                          penalty).numpy()
        want = _np(js.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(presence),
                                               penalty))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ts.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(presence),
                                    2.0).numpy(), [[1.0, -4.0, 1.0, 3.0]])


def test_apply_penalties_semantics_match_jax():
    """tests/test_sampling.py's case: rep over the context, presence once
    per generated token, frequency per count, the bias last."""
    logits = np.asarray([[2.0, -2.0, 1.0, 3.0]], np.float32)
    presence = np.asarray([[True, True, False, False]])
    counts = np.asarray([[1.0, 0.0, 3.0, 0.0]], np.float32)
    t = torch.from_numpy
    out = ts.apply_penalties(t(logits), t(presence), 2.0, t(counts), 0.5, 0.25).numpy()
    np.testing.assert_array_equal(out, [[0.25, -4.0, -0.25, 3.0]])
    out0 = ts.apply_penalties(t(logits), t(presence), 2.0, torch.zeros(1, 4)).numpy()
    np.testing.assert_array_equal(
        out0, ts.apply_repetition_penalty(t(logits), t(presence), 2.0).numpy())
    c = ts.update_counts(t(counts.copy()), torch.tensor([2]))
    np.testing.assert_array_equal(c.numpy(), [[1.0, 0.0, 4.0, 0.0]])
    bias = ts.bias_row_from_map({1: 5.0, 3: -100.0}, 4)
    np.testing.assert_array_equal(bias.numpy(), _np(js.bias_row_from_map({1: 5.0, 3: -100.0}, 4)))
    out_b = ts.apply_penalties(t(logits), t(presence), 2.0, t(counts), 0.5, 0.25, bias).numpy()
    np.testing.assert_array_equal(out_b, [[0.25, 1.0, -0.25, -97.0]])


def test_apply_penalties_random_rows_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    b, v = 4, 300
    logits = (rng.standard_normal((b, v)) * 5).astype(np.float32)
    presence = rng.random((b, v)) < 0.2
    counts = rng.integers(0, 4, (b, v)).astype(np.float32)
    bias = np.where(rng.random((b, v)) < 0.05, rng.uniform(-100, 100, (b, v)), 0.0).astype(
        np.float32)
    rep = np.asarray([[1.0], [1.3], [0.7], [2.0]], np.float32)  # per-row knobs [B, 1]
    pp = np.asarray([[0.0], [0.5], [-1.0], [2.0]], np.float32)
    fp = np.asarray([[0.0], [0.25], [1.5], [-2.0]], np.float32)
    t = torch.from_numpy
    got = ts.apply_penalties(t(logits), t(presence), t(rep), t(counts), t(pp), t(fp),
                             t(bias)).numpy()
    want = _np(js.apply_penalties(jnp.asarray(logits), jnp.asarray(presence), jnp.asarray(rep),
                                  jnp.asarray(counts), jnp.asarray(pp), jnp.asarray(fp),
                                  jnp.asarray(bias)))
    np.testing.assert_array_equal(got, want)
    # the scalar form equals the JAX scalar form too
    got = ts.apply_penalties(t(logits), t(presence), 1.3, t(counts), 0.5, 0.25, t(bias)).numpy()
    want = _np(js.apply_penalties(jnp.asarray(logits), jnp.asarray(presence), 1.3,
                                  jnp.asarray(counts), 0.5, 0.25, jnp.asarray(bias)))
    np.testing.assert_array_equal(got, want)


def test_presence_and_count_updates_match_jax():
    ids = [3, 7, 7, 0]
    got = ts.presence_from_tokens(ids, 10)
    want = js.presence_from_tokens(ids, 10)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    toks = np.asarray([9], np.int32)
    np.testing.assert_array_equal(
        ts.update_presence(got.clone(), torch.from_numpy(toks)).numpy(),
        _np(js.update_presence(want, jnp.asarray(toks))))
    counts = np.zeros((2, 5), np.float32)
    toks = np.asarray([1, 4], np.int32)
    got_c = ts.update_counts(torch.from_numpy(counts.copy()), torch.from_numpy(toks))
    got_c = ts.update_counts(got_c, torch.from_numpy(toks))
    want_c = js.update_counts(js.update_counts(jnp.asarray(counts), jnp.asarray(toks)),
                              jnp.asarray(toks))
    np.testing.assert_array_equal(got_c.numpy(), _np(want_c))


@pytest.mark.parametrize("bias", [{7: 1.0}, {-1: 1.0}, {10 ** 9: -1.0}])
def test_bias_ids_outside_the_vocab_are_refused(bias):
    for mod in (ts, js):
        with pytest.raises(ValueError, match="outside vocab"):
            mod.check_bias_ids(bias, 4)
        with pytest.raises(ValueError, match="vocab"):
            mod.bias_row_from_map(bias, 4)


@pytest.mark.parametrize("body", [
    {"logit_bias": {"5": -100, "9": 2.5}},
    {"repetition_penalty": 1.3},
    {"presence_penalty": 2.0, "frequency_penalty": -2.0},
    {"presence_penalty": None, "frequency_penalty": None, "logit_bias": None},
    {"logit_bias": {}},
    {"repetition_penalty": 1.0, "presence_penalty": 0.0},
], ids=["bias", "rep", "additive", "nulls", "empty-bias", "identity"])
def test_sampler_parse_matches_jax(body):
    got, want = Sampler.from_body(body), js.Sampler.from_body(body)
    for name in ("repetition_penalty", "presence_penalty", "frequency_penalty", "logit_bias",
                 "penalized"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("kwargs,match", [
    ({"logit_bias": {"5": 101.0}}, "logit_bias"),
    ({"logit_bias": {"x": 1.0}}, "logit_bias"),
    ({"logit_bias": [5]}, "logit_bias"),
    ({"repetition_penalty": 0.0}, "repetition_penalty"),
    ({"presence_penalty": 2.5}, "presence_penalty"),
    ({"frequency_penalty": -2.5}, "frequency_penalty"),
])
def test_sampler_validation_matches_jax(kwargs, match):
    for cls in (Sampler, js.Sampler):
        with pytest.raises(ValueError, match=match):
            cls(**kwargs)


# -- devices -------------------------------------------------------------------------------

def _with_env(env, fn):
    keys = set(DECLARED_KEYS) | set(env)
    old = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


ENV = {"MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "2", "BATCH_TIMEOUT_MS": "1",
       "DECODE_CHUNK": "4"}


def _jax_device(**env):
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level
    from gofr_tpu.metrics import Registry
    from gofr_tpu.testutil import MockLogger
    from gofr_tpu.tpu.device import new_device

    def build():
        dev = new_device(EnvConfig(), MockLogger(Level.ERROR), Registry())
        dev.wait_ready(600)
        return dev

    return _with_env({**ENV, **env}, build)


def _port_device(model, **env):
    return _with_env({**ENV, "TORCH_DEVICE": "cpu", **env},
                     lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(), model=model))


@pytest.fixture(scope="module")
def jax_dev():
    dev = _jax_device(DECODE_POOL_PENALTIES="eager")
    yield dev
    dev.close()


@pytest.fixture(scope="module")
def model(jax_dev):
    return transformer_from_tree(jax.tree.map(np.asarray, jax_dev.runner.params), TINY,
                                 device="cpu")


@pytest.fixture(scope="module")
def pooled(model):
    dev = _port_device(model, DECODE_POOL_PENALTIES="eager")
    yield dev
    dev.close()


@pytest.fixture(scope="module")
def solo(model):
    dev = _port_device(model, DECODE_POOL="off")
    yield dev
    dev.close()


def _spy_submit(dev):
    """Record, for each pool submit that was accepted, whether it pooled a
    penalty."""
    pool = dev.decode_pool
    seen = []
    orig = pool.submit

    def submit(*args, **kwargs):
        out = orig(*args, **kwargs)  # raises queue.Full on fallback
        seen.append(kwargs.get("penalty") is not None)
        return out

    pool.submit = submit
    return seen, orig


CASES = {
    "additive": dict(PEN),
    "repetition": dict(repetition_penalty=1.3),
    "repetition-extreme": dict(repetition_penalty=1e6),
    "ban-and-boost": dict(logit_bias={82: -100.0, 17: 3.0}),
    "force": dict(logit_bias={42: 100.0}),
    "all": dict(repetition_penalty=1.5, presence_penalty=0.5, frequency_penalty=1.0,
                logit_bias={9: 2.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_penalized_greedy_ids_equal_jax_solo_and_pooled(jax_dev, pooled, solo, case):
    want = jax_dev.generate(PROMPT, max_new_tokens=10, sampler=js.Sampler(**CASES[case]))
    seen, orig = _spy_submit(pooled)
    try:
        got_pooled = pooled.generate(PROMPT, 10, sampler=Sampler(**CASES[case]))
    finally:
        pooled.decode_pool.submit = orig
    assert seen == [True], "the penalized request did not pool"
    assert got_pooled == want
    assert solo.generate(PROMPT, 10, sampler=Sampler(**CASES[case])) == want


@pytest.mark.parametrize("case", ["additive", "repetition", "all"])
def test_penalized_seeded_sampled_ids_equal_jax(jax_dev, pooled, case):
    # top_k=1: the sampled path (sort, filters, the draw) with a draw the
    # generators cannot change; seeded requests decode solo in both packages
    kw = dict(CASES[case], temperature=0.9, top_k=1, seed=5)
    want = jax_dev.generate([4, 5, 6, 7], max_new_tokens=9, sampler=js.Sampler(**kw))
    assert pooled.generate([4, 5, 6, 7], 9, sampler=Sampler(**kw)) == want
    assert pooled.generate([4, 5, 6, 7], 9, sampler=Sampler(**kw)) == want


def test_penalties_change_greedy_output_as_in_jax(pooled):
    plain = pooled.generate(PROMPT, 10)
    assert len(set(plain)) < len(plain), "tiny greedy should repeat"
    pen = pooled.generate(PROMPT, 10, sampler=Sampler(**PEN))
    assert pen != plain
    assert pen[0] == plain[0]  # additive penalties count generated ids only
    no_rep = pooled.generate(PROMPT, 10, sampler=Sampler(repetition_penalty=1e6))
    assert len(set(no_rep)) == len(no_rep) and not set(no_rep) & set(PROMPT)
    assert pooled.generate(PROMPT, 10, sampler=Sampler(repetition_penalty=1.0)) == plain
    banned = pooled.generate(PROMPT, 8, sampler=Sampler(logit_bias={plain[0]: -100.0}))
    assert plain[0] not in banned
    with pytest.raises(InvalidParamError, match="vocab"):
        pooled.generate([1, 2], 2, sampler=Sampler(logit_bias={10 ** 9: -1.0}))
    with pytest.raises(InvalidParamError, match="vocab"):
        pooled.generate_stream([1, 2], 2, sampler=Sampler(logit_bias={256: 1.0}))


def test_penalized_logprobs_are_the_raw_models(jax_dev, pooled, solo):
    """The chosen ids' logprobs: log-softmax of the UNPENALIZED logits, as
    the JAX package returns them (a forced id keeps its low raw value)."""
    sampler_kw = dict(logit_bias={42: 100.0}, presence_penalty=1.0)
    want_ids, want_lps = jax_dev.generate(PROMPT, max_new_tokens=6,
                                          sampler=js.Sampler(**sampler_kw), logprobs=True)
    for dev in (pooled, solo):
        ids, lps = dev.generate(PROMPT, 6, sampler=Sampler(**sampler_kw), logprobs=True)
        assert ids == want_ids == [42] * 6
        np.testing.assert_allclose(lps, want_lps, atol=LP_TOL, rtol=0)
        assert max(lps) < -1.0  # not the penalized distribution's ~0
    ids, lps, tops = pooled.generate(PROMPT, 4, sampler=Sampler(**sampler_kw),
                                     top_logprobs=True)
    raw_top = pooled.generate(PROMPT, 1, top_logprobs=True)[2][0]
    assert tops[0] == raw_top  # the alternatives are the raw model's too


# -- the pool's per-slot state (tests/test_pool_penalties.py) --------------------------------

def test_penalized_pooled_equals_solo(model, solo):
    ref = solo.generate(PROMPT, 10, sampler=Sampler(**PEN))
    plain = solo.generate(PROMPT, 10)
    dev = _port_device(model, DECODE_CHUNK="4", DECODE_POOL_PENALTIES="eager")
    try:
        seen, _ = _spy_submit(dev)
        assert dev.generate(PROMPT, 10, sampler=Sampler(**PEN)) == ref
        assert seen == [True]
        assert ref != plain
        assert dev.generate(PROMPT, 6, sampler=Sampler(logit_bias={42: 100.0})) == [42] * 6
        assert seen == [True, True]
    finally:
        dev.close()


def test_bias_row_zeroed_on_slot_reuse(model):
    dev = _port_device(model, BATCH_MAX_SIZE="2", DECODE_POOL_PENALTIES="eager")
    try:
        plain_before = dev.generate(PROMPT, 8)
        for _ in range(dev.decode_pool.n_slots):
            assert dev.generate(PROMPT, 4, sampler=Sampler(logit_bias={7: 100.0})) == [7] * 4
        assert dev.generate(PROMPT, 8) == plain_before
        assert dev.decode_pool._pen_slots == set()
        assert not dev.decode_pool._bias.any()
    finally:
        dev.close()


def test_mixed_penalized_and_plain_cotenants(model):
    dev = _port_device(model, BATCH_MAX_SIZE="2", DECODE_POOL_PENALTIES="eager")
    try:
        plain_alone = dev.generate(PROMPT, 12)
        pen_alone = dev.generate(PROMPT, 12, sampler=Sampler(**PEN))
        results = {}
        chunks_before = dev.decode_pool.dispatches

        def run(name, sampler):
            results[name] = dev.generate(PROMPT, 12, sampler=sampler)

        threads = [threading.Thread(target=run, args=("plain", None)),
                   threading.Thread(target=run, args=("pen", Sampler(**PEN)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert results["plain"] == plain_alone
        assert results["pen"] == pen_alone
        assert dev.decode_pool.dispatches > chunks_before
    finally:
        dev.close()


def test_lazy_mode_solos_then_pools(model):
    dev = _port_device(model, DECODE_POOL_PENALTIES="lazy")
    try:
        pool = dev.decode_pool
        assert not pool._pen_ready and pool.occupancy()["penalties"] == "lazy"
        first = dev.generate(PROMPT, 8, sampler=Sampler(**PEN))
        assert pool.rejects.get("penalties_warming") == 1
        for _ in range(600):
            if pool._pen_ready:
                break
            time.sleep(0.05)
        assert pool._pen_ready
        seen, _ = _spy_submit(dev)
        assert dev.generate(PROMPT, 8, sampler=Sampler(**PEN)) == first
        assert seen == [True]
    finally:
        dev.close()


def test_off_mode_always_solos(model):
    dev = _port_device(model, DECODE_POOL_PENALTIES="off")
    try:
        pool = dev.decode_pool
        out = dev.generate(PROMPT, 6, sampler=Sampler(**PEN))
        assert len(out) == 6
        assert not pool._pen_ready
        assert pool.rejects.get("penalties_off") == 1
        with pytest.raises(queue.Full):
            pool.submit(None, 0, 0, 0, Sampler(), penalty=(None,) * 6)
        assert len(dev.generate(PROMPT, 6)) == 6  # plain requests still pool
    finally:
        dev.close()


def test_penalized_generation_is_not_an_exact_prefix_hit(model):
    """A penalized reply is not the greedy continuation: its conversation
    entry must not answer a later plain request's exact lookup."""
    dev = _port_device(model, PREFIX_CACHE="4", MODEL_BUCKETS="16,32",
                       KV_BLOCK_TOKENS="16", DECODE_POOL_PENALTIES="eager")
    ref = _port_device(model, MODEL_BUCKETS="16,32", DECODE_POOL="off")
    try:
        prompt = [7, 3, 9, 2, 11, 5]
        pen = dev.generate(prompt, 6, sampler=Sampler(**PEN))
        follow = prompt + pen[:-1]
        assert dev.generate(follow, 5) == ref.generate(follow, 5)
    finally:
        dev.close()
        ref.close()


# -- HTTP (tests/test_openai_compat.py's cases) -----------------------------------------------

def _app(model, tmp_path_factory, **env):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**ENV, "TORCH_DEVICE": "cpu", "HTTP_PORT": str(port), **env}
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("pen-app"))
    try:
        def build():
            app = gofr_tpu_torch.new(model=model)
            gofr_tpu_torch.register_openai_routes(app)
            return app

        app = _with_env(env, build)
    finally:
        os.chdir(cwd)
    app.start()
    return app, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def base(model, tmp_path_factory):
    app, url = _app(model, tmp_path_factory)
    yield url
    app.shutdown()


@pytest.fixture(scope="module")
def chat_base(model, tmp_path_factory):
    app, url = _app(model, tmp_path_factory, TOKENIZER="byte")
    yield url
    app.shutdown()


def _post(base, body, path="/v1/completions"):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read().decode()
        return resp.status, (json.loads(raw) if not body.get("stream") else raw)


def _status(base, body, path="/v1/completions"):
    try:
        return _post(base, body, path)[0], ""
    except urllib.error.HTTPError as e:
        return e.code, e.read(300).decode()


def test_openai_penalties_honored(base):
    plain = _post(base, {"prompt": PROMPT, "max_tokens": 8, "temperature": 0})[1]
    pen = _post(base, {"prompt": PROMPT, "max_tokens": 8, "temperature": 0,
                       "presence_penalty": 2.0, "frequency_penalty": 2.0})[1]
    plain_ids, pen_ids = plain["choices"][0]["tokens"], pen["choices"][0]["tokens"]
    assert len(plain_ids) == len(pen_ids) == 8
    assert len(set(plain_ids)) < len(plain_ids)
    assert pen_ids != plain_ids and pen_ids[0] == plain_ids[0]
    status, text = _status(base, {"prompt": [1, 2], "max_tokens": 2, "presence_penalty": 3.5})
    assert status == 400 and "presence_penalty" in text
    status, _ = _status(base, {"prompt": [1, 2], "max_tokens": 2, "temperature": None,
                               "top_p": None, "presence_penalty": None,
                               "frequency_penalty": None, "logit_bias": None})
    assert status == 200
    status, text = _status(base, {"prompt": [1, 2], "max_tokens": 2, "adapter": "x"})
    assert status == 400 and "adapter" in text


def test_logit_bias_honored(base):
    plain = _post(base, {"prompt": PROMPT, "max_tokens": 6,
                         "temperature": 0})[1]["choices"][0]["tokens"]
    banned = _post(base, {"prompt": PROMPT, "max_tokens": 6, "temperature": 0,
                          "logit_bias": {str(plain[0]): -100}})[1]
    assert plain[0] not in banned["choices"][0]["tokens"]
    forced = _post(base, {"prompt": PROMPT, "max_tokens": 4, "temperature": 0,
                          "logit_bias": {"42": 100}})[1]
    assert forced["choices"][0]["tokens"] == [42] * 4
    status, text = _status(base, {"prompt": [1, 2], "max_tokens": 2, "logit_bias": {"1": 200}})
    assert status == 400 and "logit_bias" in text
    # streaming: an out-of-vocab id is a 400 BEFORE the stream commits
    status, text = _status(base, {"prompt": [1, 2], "max_tokens": 2, "stream": True,
                                  "logit_bias": {"999999999": -1}})
    assert status == 400 and "vocab" in text
    status, text = _status(base, {"prompt": [1, 2], "max_tokens": 2, "stream": True, "n": 2,
                                  "logit_bias": {"256": -1}})
    assert status == 400 and "vocab" in text
    status, body = _post(base, {"prompt": [1, 2], "max_tokens": None, "temperature": 0})
    assert status == 200 and body["usage"]["completion_tokens"] >= 1


def test_penalties_ride_the_fanout(base):
    """n/best_of candidates carry the knobs: every greedy candidate is the
    penalized reply."""
    pen = _post(base, {"prompt": PROMPT, "max_tokens": 6, "temperature": 0,
                       **PEN})[1]["choices"][0]["tokens"]
    fan = _post(base, {"prompt": PROMPT, "max_tokens": 6, "temperature": 0, "n": 2,
                       **PEN})[1]
    assert [c["tokens"] for c in fan["choices"]] == [pen, pen]
    sampled = _post(base, {"prompt": PROMPT, "max_tokens": 4, "temperature": 0.8, "n": 3,
                           "logit_bias": {"42": 100}})[1]
    assert [c["tokens"] for c in sampled["choices"]] == [[42] * 4] * 3


def test_chat_takes_the_knobs(chat_base):
    chat = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "temperature": 0}
    plain = _post(chat_base, chat, "/v1/chat/completions")[1]
    forced = _post(chat_base, {**chat, "logit_bias": {"42": 100}, "repetition_penalty": 1.3,
                               "presence_penalty": 0.5, "frequency_penalty": 0.5},
                   "/v1/chat/completions")[1]
    assert forced["choices"][0]["message"]["content"] == "*" * 4  # byte 42
    assert plain["choices"][0]["message"]["content"] != "*" * 4
    status, text = _status(chat_base, {**chat, "frequency_penalty": -3},
                           "/v1/chat/completions")
    assert status == 400 and "frequency_penalty" in text
    status, text = _status(chat_base, {**chat, "stream": True, "logit_bias": {"300": 1}},
                           "/v1/chat/completions")
    assert status == 400 and "vocab" in text
