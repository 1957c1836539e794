"""gofr_tpu_torch's pooled speculation (``SPEC_POOLED``) on the CPU (tiny
f32 model, JAX weights carried across): the pure helpers against the JAX
package's copies on every case (``NgramDraft``, ``AdaptiveK``,
``SpecRequestState``, ``PoolSpecConfig``, ``clamp_spec_k``,
``verify_width`` and its ladder, mirroring ``tests/test_spec_pool.py``),
one pooled verify over a 4-slot cache against JAX's ``verify_chunk``, and
``TPUDevice`` with ``SPEC_POOLED=on`` at 4 slots against JAX's plain greedy
``prefill`` + ``decode_step`` loop: ids exactly alone and among
co-tenants, with a sampled co-tenant (a mixed cohort decodes plain), stop
tokens mid-burst, cancellation, the capacity tail and an over-long prompt
chunked like the target, spec cycles on the verify ladder, and the solo
draft mode standing down."""

import itertools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import deadline as jax_deadline
from gofr_tpu.models import transformer as jt
from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu.tpu import batcher as jax_batcher
from gofr_tpu.tpu import spec_pool as jax_spec
from gofr_tpu_torch import deadline
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Logger
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.ops.sampling import Sampler
from gofr_tpu_torch.tpu import batcher, spec_pool
from gofr_tpu_torch.tpu.decode_pool import DONE
from gofr_tpu_torch.tpu.device import TPUDevice

KV_TOL = 2e-5


# -- the pure helpers against the JAX package's ----------------------------------


def _contexts():
    rng = np.random.default_rng(11)
    fixed = [[1, 2, 3, 9, 1, 2, 3], [5, 6, 7, 6, 8, 5, 6], [1, 2, 3, 4], [1, 2, 3], [7], [],
             [4, 4, 4, 4], [1, 2, 1, 2, 1]]
    drawn = [list(map(int, rng.integers(0, 4, int(rng.integers(2, 30))))) for _ in range(12)]
    return fixed + drawn


@pytest.mark.parametrize("n_max,n_min", [(3, 1), (2, 2), (4, 2), (1, 1)])
def test_ngram_draft_matches_jax(n_max, n_min):
    for ctx in _contexts():
        ours = spec_pool.NgramDraft(ctx, n_max, n_min)
        ref = jax_spec.NgramDraft(ctx, n_max, n_min)
        assert [ours.propose(k) for k in range(6)] == [ref.propose(k) for k in range(6)], ctx
        ours.extend([1, 2])
        ref.extend([1, 2])
        assert ours.context == ref.context
        assert [ours.propose(k) for k in range(6)] == [ref.propose(k) for k in range(6)], ctx


def test_ngram_draft_cases():
    """tests/test_spec_pool.py's cases, on the port's draft."""
    assert spec_pool.NgramDraft([1, 2, 3, 9, 1, 2, 3], n_max=3).propose(2) == [9, 1]
    assert spec_pool.NgramDraft([5, 6, 7, 6, 8, 5, 6], n_max=3).propose(1) == [7]
    d = spec_pool.NgramDraft([1, 2, 3, 4], n_max=3)
    assert d.propose(3) == []
    d.extend([1, 2])
    assert d.propose(2) == [3, 4]
    assert spec_pool.NgramDraft([1, 2, 3]).propose(0) == []
    assert spec_pool.NgramDraft([7]).propose(4) == []


@pytest.mark.parametrize("n_max,n_min", [(0, 1), (1, 2), (3, 0)])
def test_ngram_draft_validates_as_jax(n_max, n_min):
    for cls in (spec_pool.NgramDraft, jax_spec.NgramDraft):
        with pytest.raises(ValueError, match="n_max >= n_min >= 1"):
            cls([1], n_max=n_max, n_min=n_min)


def _outcomes(seed):
    """A cycle script: (drafted, accepted) pairs, runs of full, partial and
    no acceptance, and dry cycles."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(60):
        d = int(rng.integers(0, 5))
        out.append((d, int(rng.integers(0, d + 1)) if rng.random() < 0.5 else 0))
    return out


@pytest.mark.parametrize("k_max", [1, 4, 7])
@pytest.mark.parametrize("seed", range(4))
def test_adaptive_k_matches_jax(k_max, seed):
    ours, ref = spec_pool.AdaptiveK(k_max), jax_spec.AdaptiveK(k_max)
    for drafted, accepted in _outcomes(seed):
        assert ours.current() == ref.current()
        ours.observe(drafted, accepted)
        ref.observe(drafted, accepted)
        assert (ours.ema, ours.cycles) == (ref.ema, ref.cycles)
    # degrade to plain decode, probe, recover: the JAX tests' arcs
    for _ in range(30):
        ours.observe(4, 0)
        ref.observe(4, 0)
    assert [ours.current() for _ in range(16)] == [ref.current() for _ in range(16)]
    for _ in range(20):
        ours.observe(1, 1)
        ref.observe(1, 1)
    assert ours.current() == ref.current()


def test_adaptive_k_validates_as_jax():
    for cls in (spec_pool.AdaptiveK, jax_spec.AdaptiveK):
        with pytest.raises(ValueError, match="k_max must be >= 1"):
            cls(0)


def _state_view(s):
    return (s.pending, list(s.draft.context), s.drafted, s.accepted, s.dispatches, s.emitted,
            s.tokens_per_dispatch, s.adaptive.ema, s.adaptive.cycles)


@pytest.mark.parametrize("k_max", [2, 4])
@pytest.mark.parametrize("seed", range(3))
def test_spec_request_state_matches_jax(k_max, seed):
    """The port drafts by n-gram alone: JAX's state with its n-gram
    source on."""
    rng = np.random.default_rng(seed)
    ctx = list(map(int, rng.integers(0, 5, 20)))
    ours = spec_pool.SpecRequestState(ctx, 3, k_max)
    ref = jax_spec.SpecRequestState(ctx, 3, k_max, ngram=True)
    assert _state_view(ours) == _state_view(ref)
    for _ in range(25):
        k = int(rng.integers(0, 5))
        assert ours.propose(k) == ref.propose(k)
        emitted = list(map(int, rng.integers(0, 5, int(rng.integers(0, 5)))))
        if rng.random() < 0.3:
            ours.note_plain(emitted)
            ref.note_plain(emitted)
        else:
            drafted = int(rng.integers(0, 5))
            accepted = int(rng.integers(0, drafted + 1))
            ours.commit(emitted, drafted, accepted)
            ref.commit(emitted, drafted, accepted)
        assert _state_view(ours) == _state_view(ref)


def test_spec_state_commit_and_tokens_per_dispatch():
    """tests/test_spec_pool.py's arithmetic, on the port's state."""
    s = spec_pool.SpecRequestState([1, 2, 3], pending=4, k_max=4)
    s.commit([5, 6, 7], drafted=4, accepted=2)
    assert s.pending == 7 and s.draft.context == [1, 2, 3, 4, 5, 6, 7]
    s.note_plain([8])
    assert s.pending == 8 and s.tokens_per_dispatch == 2.0
    assert s.drafted == 4 and s.accepted == 2


def test_pool_spec_config_matches_jax():
    for cls in (spec_pool.PoolSpecConfig, jax_spec.PoolSpecConfig):
        with pytest.raises(ValueError, match="SPEC_K_MAX must be >= 1"):
            cls(k_max=0)
    ours, ref = spec_pool.PoolSpecConfig(k_max=3), jax_spec.PoolSpecConfig(k_max=3)
    assert ours.k_max == ref.k_max and ref.ngram is True
    a, b = ours.new_state([1, 2, 3, 1, 2], 3), ref.new_state([1, 2, 3, 1, 2], 3)
    assert _state_view(a) == _state_view(b)
    assert a.propose(3) == b.propose(3) != []


class _Remaining:
    """A deadline with a fixed budget left (both packages read only
    ``remaining()``)."""

    def __init__(self, seconds):
        self.seconds = seconds

    def remaining(self):
        return self.seconds


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_clamp_spec_k_matches_jax(level):
    for k, left, cadence in itertools.product([-1, 0, 1, 2, 4, 7],
                                              [None, 0.0, 0.05, 0.25, 10.0], [0.0, 0.1]):
        dl = None if left is None else _Remaining(left)
        assert deadline.clamp_spec_k(k, level, dl, cadence) == \
            jax_deadline.clamp_spec_k(k, level, dl, cadence), (k, left, cadence)


def test_clamp_spec_k_with_jax_deadlines():
    tight = jax_deadline.Deadline(0.25)  # ~2 chunks of budget: at most 1 draft
    assert deadline.clamp_spec_k(4, deadline=tight, cadence_s=0.1) <= 1
    assert deadline.clamp_spec_k(4, deadline=jax_deadline.Deadline(0.0), cadence_s=0.1) == 0
    assert deadline.clamp_spec_k(4, deadline=tight, cadence_s=0.0) == 4


@pytest.mark.parametrize("k_max", range(1, 10))
def test_verify_width_and_ladder_match_jax(k_max):
    assert batcher.verify_width_ladder(k_max) == jax_batcher.verify_width_ladder(k_max)
    for max_k in range(0, k_max + 1):
        w = batcher.verify_width(max_k, k_max)
        assert w == jax_batcher.verify_width(max_k, k_max)
        if max_k >= 1:  # every dispatched width is on the ladder, room for k + 1
            assert w in batcher.verify_width_ladder(k_max) and w >= max_k + 1
    for mod in (batcher, jax_batcher):
        with pytest.raises(ValueError, match="max_k must be >= 0"):
            mod.verify_width(-1, k_max)
    assert batcher.verify_width_ladder(4) == (2, 4, 5)


# -- one pooled verify against JAX's ------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_transformer(jax.random.key(0), JAX_TINY)


@pytest.fixture(scope="module")
def model(jax_params):
    return transformer_from_tree(jax.tree.map(np.asarray, jax_params), TINY, device="cpu")


def test_pooled_verify_matches_jax_at_the_cache_end(jax_params, model):
    """One [4, 5] verify over a slot cache as the pool holds it: ragged
    rows, one within the width of its end (its write goes through the
    start clamp of the reference's dynamic_update_slice, and its
    pending-token id differs from plain decode's there, in JAX as in the
    port) and an idle row whose length ran past max_seq. Ids, lengths and
    the cache equal JAX's."""
    rng = np.random.default_rng(3)
    s = TINY.max_seq
    tokens = rng.integers(0, TINY.vocab_size, (4, s)).astype(np.int32)
    lengths = np.asarray([s - 2, 9, 60, 1], np.int32)
    jcache = jt.init_cache(JAX_TINY, 4, s)
    _, jcache = jt.prefill(jax_params, jnp.asarray(tokens), jcache, JAX_TINY,
                           jnp.asarray(lengths))
    cache = model.init_cache(4, s)
    _, cache = model.prefill(torch.from_numpy(tokens), cache, torch.from_numpy(lengths))
    past = np.asarray([s - 2, 9, 60, s + 5], np.int32)  # the idle slot ran on
    jcache = {**jcache, "lengths": jnp.asarray(past)}
    cache["lengths"] = torch.from_numpy(past.copy())
    verify_in = rng.integers(0, TINY.vocab_size, (4, 5)).astype(np.int32)
    jids, jcache = jt.verify_chunk(jax_params, jnp.asarray(verify_in), jcache, JAX_TINY)
    ids, cache = model.verify_chunk(torch.from_numpy(verify_in), cache)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=KV_TOL, atol=KV_TOL)


# -- TPUDevice with SPEC_POOLED=on ------------------------------------------------

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
    base = {"TORCH_DEVICE": "cpu", "MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "4",
            "BATCH_TIMEOUT_MS": "1", "DECODE_CHUNK": "4", "DECODE_SLOTS": "4"}
    base.update(env)
    return _with_env(base, lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(),
                                             model=model, draft_model=draft))


@pytest.fixture(scope="module")
def pooled_spec(model):
    dev = _device(model, SPEC_POOLED="on", SPEC_K_MAX="4")
    yield dev
    dev.close()


def _spec(dev):
    return dev.decode_pool.occupancy()["spec"]


PROMPTS = (([1, 2, 3], 12), ([7] * 30, 24), ([42], 8), ([5, 6], 17), ([3, 9, 4] * 12, 30))


def test_pooled_spec_matches_jax_plain_greedy(pooled_spec, jax_params):
    """Speculation through the pool emits exactly the plain greedy stream:
    the n-gram drafts only move tokens per dispatch."""
    before = _spec(pooled_spec)
    for prompt, n in PROMPTS:
        assert pooled_spec.generate(prompt, max_new_tokens=n) == \
            jax_greedy(jax_params, prompt, n), (prompt, n)
    after = _spec(pooled_spec)
    assert after["cycles"] > before["cycles"] and after["drafted"] > before["drafted"]
    assert after["accepted"] > before["accepted"]  # repeated passages draft well
    assert set(after["widths"]) <= set(batcher.verify_width_ladder(4))
    assert after["k_max"] == 4
    assert after["emitted"] > after["rows"]  # more than one token a row-cycle
    assert 4 in after["widths"] or 5 in after["widths"]  # past the narrowest rung


def test_pooled_spec_concurrent_streams(pooled_spec, jax_params):
    """Co-tenant rows share one batched verify; every stream still emits
    its own plain sequence."""
    prompts = ([1, 2, 3], [7] * 30, [42, 9], [3, 9, 4] * 12)
    want = [jax_greedy(jax_params, p, 14) for p in prompts]
    results = [None] * len(prompts)

    def run(i):
        results[i] = pooled_spec.generate(prompts[i], max_new_tokens=14)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert results == want


def test_pooled_spec_mixed_cohort_with_sampled_co_tenant(pooled_spec, jax_params):
    """An unseeded sampled co-tenant pools but is not armed: the cohort
    decodes plain chunks while it is active, and the greedy stream's ids
    do not move."""
    want = jax_greedy(jax_params, [7] * 30, 24)
    results = {}
    started = threading.Event()

    def greedy():
        started.wait(30)
        results["g"] = pooled_spec.generate([7] * 30, max_new_tokens=24)

    def sampled():
        results["s"] = pooled_spec.generate(
            [9, 8], max_new_tokens=40, sampler=Sampler(temperature=1.0),
            on_token=lambda t: started.set(),
        )

    threads = [threading.Thread(target=greedy), threading.Thread(target=sampled)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert results["g"] == want
    assert len(results["s"]) == 40


def test_pooled_spec_stop_tokens_mid_burst(pooled_spec, jax_params):
    full = jax_greedy(jax_params, [7] * 30, 16)
    stop_tok = full[7]
    want = full[: full.index(stop_tok)]
    assert pooled_spec.generate([7] * 30, max_new_tokens=16, stop_tokens=[stop_tok]) == want


def test_pooled_spec_cancellation_frees_the_slot(pooled_spec):
    stop = threading.Event()
    seen = []

    def on_token(t):
        seen.append(t)
        if len(seen) >= 3:
            stop.set()

    out = pooled_spec.generate([7] * 30, max_new_tokens=90, on_token=on_token, stop=stop)
    assert out == seen and 3 <= len(out) < 90
    pool = pooled_spec.decode_pool
    for _ in range(200):
        if pool.occupancy()["active"] == 0:
            break
        threading.Event().wait(0.05)
    assert pool.occupancy()["active"] == 0


def test_pooled_spec_capacity_tail(pooled_spec, jax_params):
    """Near-full prompts decode to the cache end: drafts shrink to the room
    a row has left, then plain chunks take the tail."""
    for prompt in (list(range(1, 120)), [4, 5] * 50, [3, 9, 4] * 38):
        assert pooled_spec.generate(prompt, max_new_tokens=50) == \
            jax_greedy(jax_params, prompt, 50)


def test_pooled_spec_overlong_prompt_chunks_like_target(model, jax_params):
    dev = _device(model, SPEC_POOLED="on", MODEL_BUCKETS="64")
    try:
        prompt = [(i % 9) + 1 for i in range(100)]
        assert dev.generate(prompt, max_new_tokens=20) == jax_greedy(jax_params, prompt, 20)
        assert _spec(dev)["cycles"] > 0
    finally:
        dev.close()


def test_ineligible_requests_pool_unarmed(pooled_spec, jax_params):
    """A logprobs request pools unarmed: no spec cycle carries it."""
    before = _spec(pooled_spec)["rows"]
    ids, lps = pooled_spec.generate([7] * 30, max_new_tokens=12, logprobs=True)
    assert ids == jax_greedy(jax_params, [7] * 30, 12) and len(lps) == 12
    assert _spec(pooled_spec)["rows"] == before


def test_pooled_spec_stands_down_solo_draft_mode(model, jax_params):
    """SPEC_POOLED with DRAFT_MODEL_NAME: the pool speculates for
    pool-eligible requests and the solo draft engine never runs."""
    dev = _device(model, model, DRAFT_MODEL_NAME="tiny", SPEC_POOLED="on", DECODE_SLOTS="2")
    try:
        before = dict(dev.runner.spec_stats)
        assert dev.generate([7] * 30, max_new_tokens=20) == jax_greedy(jax_params, [7] * 30, 20)
        assert dev.runner.spec_stats == before
        assert _spec(dev)["cycles"] > 0
    finally:
        dev.close()


def test_spec_off_pool_has_no_spec_state(model):
    dev = _device(model)
    try:
        assert dev.decode_pool.spec_cfg is None and _spec(dev) is None
        q = dev.decode_pool.submit(
            dev.runner.run_batch([np.asarray([5, 6, 7], np.int32)])[0].row(), 3, 1, 4,
            Sampler(), spec_ctx=np.asarray([5, 6, 7], np.int32),
        )
        while q.get(timeout=60) is not DONE:
            pass
    finally:
        dev.close()
