"""gofr_tpu_torch's speculative decoding on the CPU (tiny f32 model)
against the JAX package, with the JAX weights carried across
(``models/convert.py``): the target verify (``verify_chunk``: ids exactly,
f32 logits within 2e-5), speculative sampling's accept test and residual
resample fed the very uniforms and Gumbel noise ``jax.random`` draws from
the verify's split key (``n_acc`` and the emitted ids exactly), its
emitted marginal (statistically, as ``tests/test_spec_sampling.py`` checks
the JAX one), the sampled draft's distributions, and the solo latency mode
(``DRAFT_MODEL_NAME``) through ``TPUDevice``: greedy ids equal to JAX's
plain greedy ``prefill`` + ``decode_step`` loop whatever the draft (JAX's
key-1 weights, near-zero acceptance, and the target's own, full
acceptance), with stop tokens mid-burst, cancellation, the capacity tail,
an over-long prompt chunked like the target and the conversation KV
store; and the speculation keys' defaults and errors against the JAX
device's."""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import transformer as jt
from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu.ops.sampling import warped_probs as jax_warped_probs
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Logger
from gofr_tpu_torch.models import transformer as tt
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.ops.sampling import Sampler
from gofr_tpu_torch.tpu import device as device_mod
from gofr_tpu_torch.tpu.device import TPUDevice, spec_options

LOGIT_TOL = 2e-5
PROB_TOL = 1e-5
TEMP = 0.25  # concentrates the tiny model's near-uniform logits


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_transformer(jax.random.key(0), JAX_TINY)


@pytest.fixture(scope="module")
def model(jax_params):
    return transformer_from_tree(jax.tree.map(np.asarray, jax_params), TINY, device="cpu")


@pytest.fixture(scope="module")
def draft_model():
    """The JAX engine's seeded draft: the same config from key 1."""
    params = jt.init_transformer(jax.random.key(1), JAX_TINY)
    return transformer_from_tree(jax.tree.map(np.asarray, params), TINY, device="cpu")


_jax_prefill = jax.jit(lambda p, t, c, n: jt.prefill(p, t, c, JAX_TINY, n))
_jax_step = jax.jit(lambda p, t, c: jt.decode_step(p, t, c, JAX_TINY))


def jax_greedy(params, prompt, n):
    """JAX's plain greedy loop: one prefill, then ``decode_step`` until
    ``n`` ids or the cache is full (the port's stopping rule)."""
    ids = np.asarray(prompt, np.int32)[-JAX_TINY.max_seq:][None]
    cache = jt.init_cache(JAX_TINY, 1, JAX_TINY.max_seq)
    logits, cache = _jax_prefill(params, jnp.asarray(ids), cache,
                                 jnp.asarray([ids.shape[1]], jnp.int32))
    out, length = [], ids.shape[1]
    while True:
        out.append(int(jnp.argmax(logits[0])))
        if len(out) >= n or length >= JAX_TINY.max_seq:
            return out
        logits, cache = _jax_step(params, jnp.asarray([[out[-1]]], jnp.int32), cache)
        length += 1


def _with_env(env: dict, fn):
    """Call ``fn`` with exactly ``env`` set among the port's keys."""
    old = {k: os.environ.get(k) for k in DECLARED_KEYS}
    for k in DECLARED_KEYS:
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


def _device(model, draft=None, **env):
    base = {"TORCH_DEVICE": "cpu", "MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "2",
            "BATCH_TIMEOUT_MS": "1", "DECODE_CHUNK": "4", "DECODE_POOL": "off"}
    base.update(env)
    return _with_env(base, lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(),
                                             model=model, draft_model=draft))


@pytest.fixture(scope="module")
def spec(model, draft_model):
    """Draft "tiny" from JAX's key 1: real accept AND reject traffic."""
    dev = _device(model, draft_model, DRAFT_MODEL_NAME="tiny", DRAFT_TOKENS="4")
    yield dev
    dev.close()


@pytest.fixture(scope="module")
def spec_self(model):
    """The target as its own draft: every draft accepted (bursts of k)."""
    dev = _device(model, model, DRAFT_MODEL_NAME="tiny", DRAFT_TOKENS="4")
    yield dev
    dev.close()


def _cache_pair(jax_params, model, tokens, lengths):
    """The same prefilled cache in both packages."""
    b = tokens.shape[0]
    jcache = jt.init_cache(JAX_TINY, b, JAX_TINY.max_seq)
    _, jcache = jt.prefill(jax_params, jnp.asarray(tokens), jcache, JAX_TINY,
                           jnp.asarray(lengths))
    cache = model.init_cache(b, TINY.max_seq)
    _, cache = model.prefill(torch.from_numpy(tokens), cache, torch.from_numpy(lengths))
    return jcache, cache


# -- the target verify ---------------------------------------------------------


@pytest.mark.parametrize("lengths,width", [
    ([5, 40], 5),
    ([1, 77], 2),
    # a row within the verify's width of its cache end writes through the
    # start clamp (the reference's dynamic_update_slice), as the pool's
    # padded rows near their end do
    ([TINY.max_seq - 3, 40], 4),
])
def test_verify_chunk_matches_jax(jax_params, model, lengths, width):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, TINY.vocab_size, (2, TINY.max_seq)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    jcache, cache = _cache_pair(jax_params, model, tokens, lengths)
    verify_in = rng.integers(0, TINY.vocab_size, (2, width)).astype(np.int32)
    # the verify's f32 logits, from each package's shared cached forward
    jx, *_ = jt._run_cached(jax_params, jnp.asarray(verify_in), jcache, JAX_TINY)
    jlogits = np.asarray(jt._mm(jx, jax_params["lm_head"]).astype(jnp.float32))
    scratch = {name: t.clone() for name, t in cache.items()}
    x, _ = model._run_cached(torch.from_numpy(verify_in), scratch)
    logits = tt.mm(x, model.lm_head).float().numpy()
    np.testing.assert_allclose(logits, jlogits, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    jids, jcache = jt.verify_chunk(jax_params, jnp.asarray(verify_in), jcache, JAX_TINY)
    ids, cache = model.verify_chunk(torch.from_numpy(verify_in), cache)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("start,width,call", [
    # a verify row within its width of the cache end (a pooled cohort's
    # width is its widest row's, rounded up the ladder)
    (TINY.max_seq - 3, 4, "verify"),
    # a prefix-cache tail prefill: 1 tail token through bucket 64 after 65
    # shared tokens of a 128-token cache
    (65, 64, "prefill"),
])
def test_write_through_the_clamp_matches_jax(jax_params, model, start, width, call):
    """A cached call whose S tokens do not fit after its start writes at
    max_seq - S (the start clamp of dynamic_update_slice), over committed
    positions: a fault of the reference (ROADMAP.md §C), which the port
    keeps so its ids stay JAX's. Both packages overwrite the same committed
    positions and give the same ids; the reference's logits for the first
    token there are not its plain decode_step's."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, TINY.vocab_size, (1, TINY.max_seq)).astype(np.int32)
    lengths = np.asarray([start], np.int32)
    jcache, cache = _cache_pair(jax_params, model, tokens, lengths)
    before = np.asarray(jcache["k"])
    step_logits, _ = jt.decode_step(jax_params, jnp.asarray(tokens[:, start:start + 1]), jcache,
                                    JAX_TINY)
    call_in = np.zeros((1, width), np.int32)
    call_in[0, 0] = tokens[0, start]
    jx, *_ = jt._run_cached(jax_params, jnp.asarray(call_in), jcache, JAX_TINY)
    first_logits = jt._mm(jx[:, 0], jax_params["lm_head"]).astype(jnp.float32)
    assert not np.allclose(np.asarray(first_logits), np.asarray(step_logits), atol=1e-3)
    if call == "verify":
        jids, jcache = jt.verify_chunk(jax_params, jnp.asarray(call_in), jcache, JAX_TINY)
        ids, cache = model.verify_chunk(torch.from_numpy(call_in), cache)
        jfirst, first = np.asarray(jids)[0, 0], ids.numpy()[0, 0]
    else:
        one = np.asarray([1], np.int32)
        jl, jcache = jt.prefill(jax_params, jnp.asarray(call_in), jcache, JAX_TINY,
                                jnp.asarray(one))
        tl, cache = model.prefill(torch.from_numpy(call_in), cache, torch.from_numpy(one))
        jfirst, first = np.asarray(jnp.argmax(jl, -1))[0], int(torch.argmax(tl, -1)[0])
    assert first == jfirst
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    committed = slice(TINY.max_seq - width, start)
    assert not np.allclose(np.asarray(jcache["k"])[:, :, committed], before[:, :, committed])


# -- speculative sampling --------------------------------------------------------


def _draws_of(key, b, n_drafts, v):
    """The uniforms and the Gumbel noise JAX's verify_chunk_sampled draws
    from ``key``, and the check that its categorical is the Gumbel-max."""
    _, ku, kc = jax.random.split(key, 3)
    u = jax.random.uniform(ku, (b, n_drafts))
    noise = jax.random.gumbel(kc, (b, v))
    logits = jax.random.normal(jax.random.key(99), (b, v))
    assert np.array_equal(np.asarray(jax.random.categorical(kc, logits, axis=-1)),
                          np.asarray(jnp.argmax(logits + noise, axis=-1)))
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("draft_kind", ["adversarial", "target", "uniform"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sampled_accept_matches_jax(jax_params, model, monkeypatch, draft_kind, seed):
    """verify_chunk_sampled against JAX's on the same cache, drafts, q and
    randomness: n_acc and the emitted ids exactly."""
    rng = np.random.default_rng(seed)
    b, kd, v = 3, 3, TINY.vocab_size
    prompts = rng.integers(0, v, (b, 16)).astype(np.int32)
    lengths = np.asarray([16, 9, 4], np.int32)
    jcache, cache = _cache_pair(jax_params, model, prompts, lengths)
    tokens = rng.integers(0, v, (b, kd + 1)).astype(np.int32)
    drafts = tokens[:, 1:]
    if draft_kind == "adversarial":  # q on the drafts, which p did not choose
        q = np.full((b, kd, v), 0.1 / v, np.float32)
        np.put_along_axis(q, drafts[..., None], 0.9 + 0.1 / v, axis=-1)
    elif draft_kind == "target":  # q = the target's warped p, drafts its argmax
        jx, *_ = jt._run_cached(jax_params, jnp.asarray(tokens), jcache, JAX_TINY)
        jl = jt._mm(jx, jax_params["lm_head"]).astype(jnp.float32)
        p = np.asarray(jax_warped_probs(jl.reshape(b * (kd + 1), v), TEMP)).reshape(b, kd + 1, v)
        drafts = p[:, :kd].argmax(-1).astype(np.int32)
        tokens[:, 1:] = drafts
        jx, *_ = jt._run_cached(jax_params, jnp.asarray(tokens), jcache, JAX_TINY)
        jl = jt._mm(jx, jax_params["lm_head"]).astype(jnp.float32)
        q = np.asarray(jax_warped_probs(jl.reshape(b * (kd + 1), v), TEMP)).reshape(
            b, kd + 1, v)[:, :kd]
    else:
        q = np.full((b, kd, v), 1.0 / v, np.float32)
    q = np.array(q)  # writable, for torch.from_numpy
    key = jax.random.key(100 + seed)
    jemitted, jn_acc, _, _ = jt.verify_chunk_sampled(
        jax_params, jnp.asarray(tokens), jcache, JAX_TINY, jnp.asarray(drafts), jnp.asarray(q),
        key, TEMP,
    )
    u, noise = _draws_of(key, b, kd, v)
    monkeypatch.setattr(tt, "_spec_draws", lambda gen, b_, n_, v_, dev: (u, noise))
    emitted, n_acc, cache = model.verify_chunk_sampled(
        torch.from_numpy(tokens), cache, torch.from_numpy(drafts), torch.from_numpy(q), None,
        TEMP,
    )
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn_acc))
    np.testing.assert_array_equal(emitted.numpy(), np.asarray(jemitted))
    assert cache["lengths"].tolist() == (lengths + kd + 1).tolist()
    if draft_kind == "target":
        assert n_acc.tolist() == [kd] * b  # u < p/q = 1 accepts every draft


def _tv(counts, p, n):
    """Total variation between the empirical law and exact p, over p's
    effective support plus a lumped tail."""
    support = [i for i in range(len(p)) if p[i] > 0.01]
    tv = sum(abs(counts.get(i, 0) / n - p[i]) for i in support)
    tail_p = 1.0 - sum(p[i] for i in support)
    tail_e = sum(c for i, c in counts.items() if i not in support) / n
    return 0.5 * (tv + abs(tail_e - tail_p))


def test_sampled_spec_marginal_is_exactly_target(jax_params, model):
    """An adversarial draft (q concentrated on an arbitrary first draft):
    rejections dominate and the residual does the work; the first emitted
    token's law must still be the target's warped p at that position.
    2,000 rows in one verify, the generator's own draws."""
    n, v = 2000, TINY.vocab_size
    t0, drafts = 7, [3, 11, 200]
    tokens = np.tile(np.asarray([[t0] + drafts], np.int32), (n, 1))
    logits = jt.transformer_forward(jax_params, jnp.asarray(tokens[:1]), JAX_TINY)
    p0 = np.asarray(jax_warped_probs(logits[:, 0, :], TEMP)[0])
    q_row = np.full(v, 0.1 / v, np.float32)
    q_row[drafts[0]] += 0.9
    q = torch.from_numpy(np.tile(q_row, (n, 3, 1)))
    gen = torch.Generator()
    gen.manual_seed(0)
    emitted, n_acc, _ = model.verify_chunk_sampled(
        torch.from_numpy(tokens), model.init_cache(n, 8), torch.from_numpy(tokens[:, 1:]), q,
        gen, TEMP,
    )
    counts: dict = {}
    for t in emitted[:, 0].tolist():
        counts[t] = counts.get(t, 0) + 1
    assert _tv(counts, p0, n) < 0.08
    assert int(n_acc.max()) <= 3  # never beyond the tested drafts


def test_draft_chunk_sampled_distributions_match_jax(jax_params, model):
    """Each step's q is the warped distribution JAX's teacher-forced
    forward gives after the tokens the port drew."""
    gen = torch.Generator()
    gen.manual_seed(5)
    toks, q, cache = model.draft_chunk_sampled(
        torch.tensor([[7]], dtype=torch.int32), model.init_cache(1, 16), 4, gen, TEMP, 8, 0.9,
    )
    assert toks.shape == (1, 4) and q.shape == (1, 4, TINY.vocab_size)
    assert cache["lengths"].tolist() == [4]
    seq = np.concatenate([[7], toks[0, :3].numpy()]).astype(np.int32)[None]
    logits = jt.transformer_forward(jax_params, jnp.asarray(seq), JAX_TINY)
    want = np.asarray(jax_warped_probs(logits[0], TEMP, 8, 0.9))
    np.testing.assert_allclose(q[0].numpy(), want, atol=PROB_TOL)
    for j, t in enumerate(toks[0].tolist()):
        assert want[j, t] > 0  # every draw lies in its filtered support


# -- the solo latency mode through TPUDevice -------------------------------------

PROMPTS = (([1, 2, 3], 12), ([7] * 30, 6), ([42], 1), ([5, 6], 17))


@pytest.mark.parametrize("which", ["spec", "spec_self"])
def test_spec_greedy_matches_jax_plain_greedy(request, jax_params, which):
    dev = request.getfixturevalue(which)
    before = dict(dev.runner.spec_stats)
    for prompt, n in PROMPTS:
        assert dev.generate(prompt, max_new_tokens=n) == jax_greedy(jax_params, prompt, n)
    stats = dev.runner.spec_stats
    assert stats["cycles"] > before["cycles"]
    assert stats["drafted"] >= stats["accepted"] >= before["accepted"]
    if which == "spec_self":
        # the target drafting for itself: every draft matches
        assert stats["accepted"] - before["accepted"] == stats["drafted"] - before["drafted"]


def test_spec_respects_stop_tokens_mid_burst(spec_self, jax_params):
    full = jax_greedy(jax_params, [1, 2, 3], 10)
    stop_tok = full[5]  # inside the second cycle's burst of k
    want = full[: full.index(stop_tok)]
    assert spec_self.generate([1, 2, 3], max_new_tokens=10, stop_tokens=[stop_tok]) == want


def test_spec_streams_and_cancels(spec_self):
    stop = threading.Event()
    seen = []

    def on_token(t):
        seen.append(t)
        if len(seen) >= 3:
            stop.set()

    out = spec_self.generate([1, 2, 3], max_new_tokens=100, on_token=on_token, stop=stop)
    assert out == seen
    assert 3 <= len(out) < 100


@pytest.mark.parametrize("which", ["spec", "spec_self"])
def test_spec_cache_capacity_tail(request, jax_params, which):
    """A near-full prompt: verifies until k + 1 no longer fit, then the
    single-step tail to the cache end."""
    prompt = list(range(1, 120))
    assert request.getfixturevalue(which).generate(prompt, max_new_tokens=50) == \
        jax_greedy(jax_params, prompt, 50)


def test_seeded_requests_skip_spec(spec):
    before = dict(spec.runner.spec_stats)
    out = spec.generate([1, 2, 3], max_new_tokens=5, sampler=Sampler(temperature=1.0, seed=3))
    assert len(out) == 5
    assert spec.runner.spec_stats == before  # the seeded path never drafts


def test_penalized_and_logprobs_requests_skip_spec(spec, model):
    plain = _device(model)
    try:
        before = dict(spec.runner.spec_stats)
        pen = Sampler(repetition_penalty=1.3)
        assert spec.generate([1, 2, 3], 6, sampler=pen) == plain.generate([1, 2, 3], 6,
                                                                          sampler=pen)
        ids, lps = spec.generate([1, 2, 3], 6, logprobs=True)
        assert ids == plain.generate([1, 2, 3], 6)
        assert len(lps) == 6
        assert spec.runner.spec_stats == before
    finally:
        plain.close()


def test_unseeded_sampled_requests_draft(spec_self):
    before = dict(spec_self.runner.spec_stats)
    out = spec_self.generate([1, 2, 3], max_new_tokens=9, sampler=Sampler(temperature=1.0))
    assert len(out) == 9 and all(0 <= t < TINY.vocab_size for t in out)
    after = spec_self.runner.spec_stats
    assert after["cycles"] > before["cycles"] and after["drafted"] > before["drafted"]
    # the stop token is never emitted, the budget never passed
    outs = [spec_self.generate([1, 2, 3], 12, sampler=Sampler(temperature=1.0, top_k=8),
                               stop_tokens=[5]) for _ in range(4)]
    assert all(5 not in o and len(o) <= 12 for o in outs)


def test_spec_overlong_prompt_chunks_like_target(jax_params, model, draft_model):
    """A prompt longer than the largest bucket: target and draft prefill
    chunked through it; the ids still equal plain greedy."""
    dev = _device(model, draft_model, DRAFT_MODEL_NAME="tiny", MODEL_BUCKETS="64")
    try:
        prompt = [(i % 9) + 1 for i in range(100)]
        assert dev.generate(prompt, max_new_tokens=8) == jax_greedy(jax_params, prompt, 8)
        assert dev.runner.spec_stats["cycles"] > 0
    finally:
        dev.close()


def test_spec_generation_seeds_conversation_kv(jax_params, model):
    """A speculative generation stores the whole conversation in the prefix
    cache: the follow-up turn partial-hits and stays equal to plain greedy."""
    dev = _device(model, model, DRAFT_MODEL_NAME="tiny", PREFIX_CACHE="4",
                  PREFIX_LCP_MIN="4")
    try:
        turn1 = [7, 3, 9, 2, 11, 5, 61, 62]
        reply = dev.generate(turn1, max_new_tokens=8)
        assert reply == jax_greedy(jax_params, turn1, 8)
        followup = turn1 + reply + [71, 72]
        before = dict(dev.runner.prefix_stats)
        assert dev.generate(followup, max_new_tokens=6) == jax_greedy(jax_params, followup, 6)
        assert dev.runner.prefix_stats["partial_hits"] == before["partial_hits"] + 1
    finally:
        dev.close()


def test_seeded_draft_is_seed_one(model):
    """Without DRAFT_MODEL_PATH the draft is the seeded init at seed 1
    (the JAX engine's key 1 where the target's is key 0)."""
    dev = _device(model, DRAFT_MODEL_NAME="tiny", DRAFT_TOKENS="3")
    try:
        want = tt.Transformer.random(TINY, "cpu", seed=1)
        got = dev.runner.spec.model.state_dict()
        assert all(torch.equal(got[k], t) for k, t in want.state_dict().items())
        assert dev.runner.spec.k == 3
    finally:
        dev.close()


def test_draft_model_path_loads_the_checkpoint(tmp_path, model):
    """DRAFT_MODEL_PATH goes through the target's loader: a training
    checkpoint of the target drafts for it and accepts every draft."""
    from gofr_tpu_torch.training import checkpoint

    checkpoint.save_params(str(tmp_path / "ckpt"), model.state_dict())
    dev = _device(model, DRAFT_MODEL_NAME="tiny", DRAFT_MODEL_PATH=str(tmp_path / "ckpt"))
    try:
        got = dev.runner.spec.model.state_dict()
        assert all(torch.equal(got[k], t) for k, t in model.state_dict().items())
        dev.generate([1, 2, 3], max_new_tokens=9)
        stats = dev.runner.spec_stats
        assert stats["cycles"] > 0 and stats["accepted"] == stats["drafted"]
    finally:
        dev.close()


# -- config ------------------------------------------------------------------------

_JAX_ATTRS = {
    "draft_name": "_draft_name", "draft_tokens": "_draft_tokens", "draft_path": "_draft_path",
    "spec_pooled": "_spec_pooled", "spec_ngram": "_spec_ngram", "spec_k_max": "_spec_k_max",
    "spec_fake_accept": "_spec_fake_accept",
}


def _jax_options(env):
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level
    from gofr_tpu.metrics import Registry
    from gofr_tpu.testutil import MockLogger
    from gofr_tpu.tpu.device import new_device

    def build():
        os.environ["MODEL_NAME"] = "echo"
        try:
            dev = new_device(EnvConfig(), MockLogger(Level.ERROR), Registry())
        except ValueError as exc:
            return ("err", str(exc))
        finally:
            os.environ.pop("MODEL_NAME", None)
        try:
            return ("ok", {k: getattr(dev, a) for k, a in _JAX_ATTRS.items()})
        finally:
            dev.close()

    return _with_env(env, build)


def _port_options(env):
    def build():
        try:
            return ("ok", spec_options(EnvFileConfig("/nonexistent")))
        except ValueError as exc:
            return ("err", str(exc))

    return _with_env(env, build)


@pytest.mark.parametrize("env", [
    {},
    {"DRAFT_MODEL_NAME": "tiny", "DRAFT_TOKENS": "3", "DRAFT_MODEL_PATH": "/ckpt",
     "SPEC_POOLED": " ON ", "SPEC_K_MAX": "7", "SPEC_NGRAM": "on"},
    {"DRAFT_TOKENS": "1"},  # ignored without a draft
    {"DRAFT_MODEL_NAME": "tiny", "DRAFT_TOKENS": "1"},
    {"SPEC_K_MAX": "0"},
    {"SPEC_POOLED": "on", "SPEC_NGRAM": "off"},
    {"SPEC_POOLED": "off", "SPEC_NGRAM": "off"},
    {"SPEC_POOLED": "on", "SPEC_NGRAM": "off", "SPEC_FAKE_ACCEPT": "3, 1,0"},
    {"SPEC_FAKE_ACCEPT": "2,-1"},
])
def test_config_defaults_and_errors_match_jax(env):
    """The speculation keys' defaults and validation errors are the JAX
    device's, the echo runner's SPEC_FAKE_ACCEPT schedule included."""
    jax_side, port_side = _jax_options(env), _port_options(env)
    assert port_side[0] == jax_side[0]
    if port_side[0] == "ok":
        assert port_side == jax_side
    else:
        assert jax_side[1].startswith(port_side[1].split(" (")[0])


def _engine_error(build):
    try:
        build()
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("name,max_seq,k", [
    ("nope", None, 4),  # unknown
    ("small", None, 4),  # vocab 32000 against tiny's 256
    ("tiny", 4096, 4),  # the draft's max_seq below the target's
    ("tiny", 5, 4),  # no room for a verify of k + 1
])
def test_draft_engine_fails_fast_as_jax(name, max_seq, k):
    from gofr_tpu.tpu.device import _SpecEngine as JaxSpecEngine

    jcfg = JAX_TINY if max_seq is None else dataclasses.replace(JAX_TINY, max_seq=max_seq)
    cfg = TINY if max_seq is None else dataclasses.replace(TINY, max_seq=max_seq)
    want = _engine_error(lambda: JaxSpecEngine(jcfg, None, name, k))
    assert want is not None
    assert _engine_error(
        lambda: device_mod._SpecEngine(cfg, None, name, k, torch.device("cpu"))) == want


@pytest.mark.parametrize("env,match", [
    ({"DRAFT_MODEL_NAME": "nope"}, "DRAFT_MODEL_NAME"),
    ({"DRAFT_MODEL_NAME": "small"}, "vocab"),
    ({"DRAFT_MODEL_NAME": "tiny", "DRAFT_TOKENS": "1"}, ">= 2"),
    ({"SPEC_K_MAX": "0"}, "SPEC_K_MAX"),
    ({"SPEC_POOLED": "on", "SPEC_NGRAM": "off"}, "draft source"),
])
def test_device_boot_raises(model, env, match):
    with pytest.raises(ValueError, match=match):
        _device(model, **env)
