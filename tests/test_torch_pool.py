"""gofr_tpu_torch's continuous-batching decode pool on the CPU (tiny
model): ``decode_chunk_pool`` against the JAX package's (greedy ids
exactly, logprobs and top-5 values within 1e-4, top-5 ids exactly), the
pool's behaviour as ``tests/test_decode_pool.py`` holds the JAX pool to
(pooled greedy equals solo, slot reuse, saturation and kv_exhausted fall
back to solo, seeded requests bypass it, stop tokens, cancellation, worker
death, close mid-stream, idle slots past max_seq), the solo path's fetch
order, the batcher's scheduler gate, and the new config keys' defaults and
errors against the JAX device's."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import transformer as jt
from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Logger
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.models.transformer import _chosen_logprobs
from gofr_tpu_torch.ops.sampling import Sampler
from gofr_tpu_torch.tpu.batcher import DynamicBatcher
from gofr_tpu_torch.tpu import decode_pool
from gofr_tpu_torch.tpu.decode_pool import DONE, HostFetch, PoolFailure
from gofr_tpu_torch.tpu.device import TPUDevice, serving_options

LP_TOL = 1e-4


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


def _device(model=None, **env):
    base = {"TORCH_DEVICE": "cpu", "MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "4",
            "BATCH_TIMEOUT_MS": "1", "DECODE_CHUNK": "4"}
    base.update(env)
    return _with_env(base, lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(), model=model))


@pytest.fixture(scope="module")
def pooled():
    dev = _device(DECODE_SLOTS="4")
    yield dev
    dev.close()


@pytest.fixture(scope="module")
def solo():
    dev = _device(DECODE_POOL="off")
    yield dev
    dev.close()


def _threads(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)


def _occupy(dev, n):
    """Fill ``n`` pool slots with requests that decode until told to stop:
    -> (their stop events, their queues)."""
    state = dev.runner.run_batch([np.asarray([5, 6, 7], np.int32)])[0]
    stops, queues = [], []
    for _ in range(n):
        stop = threading.Event()
        queues.append(dev.decode_pool.submit(state.row(), state["length"], state["next_token"],
                                             10_000, Sampler(), stop))
        stops.append(stop)
    return stops, queues


def _release(stops, queues):
    for s in stops:
        s.set()
    for q in queues:
        while q.get(timeout=60) is not DONE:
            pass


# -- decode_chunk_pool against the JAX package -------------------------------


def test_decode_chunk_pool_matches_jax():
    """B=4 rows with ragged lengths, the last an idle row near the cache
    end that runs past it; greedy ids, logprobs and top-5 of the live rows
    match the JAX chunk."""
    params = jt.init_transformer(jax.random.PRNGKey(0), JAX_TINY)
    model = transformer_from_tree(jax.tree.map(np.asarray, params), TINY, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, TINY.vocab_size, (4, 16)).astype(np.int32)
    lengths = np.asarray([5, 16, 9, 1], np.int32)
    jcache = jt.init_cache(JAX_TINY, 4, JAX_TINY.max_seq)
    jlogits, jcache = jt.prefill(params, jnp.asarray(tokens), jcache, JAX_TINY,
                                 jnp.asarray(lengths))
    cache = model.init_cache(4, TINY.max_seq)
    logits, cache = model.prefill(torch.from_numpy(tokens), cache, torch.from_numpy(lengths))
    idle_len = TINY.max_seq - 3  # the idle row crosses max_seq inside the chunk
    jcache = {**jcache, "lengths": jcache["lengths"].at[3].set(idle_len)}
    cache["lengths"][3] = idle_len
    first = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)[:, None]
    assert (logits.argmax(-1).numpy() == first[:, 0]).all()
    n = 6
    temps, tks = np.zeros(4, np.float32), np.zeros(4, np.int32)
    tps, mps = np.ones(4, np.float32), np.zeros(4, np.float32)
    jtoks, jlps, jtv, jti, jnext, _, _ = jt.decode_chunk_pool(
        params, jnp.asarray(first), jcache, JAX_TINY, n, jax.random.key(0),
        jnp.asarray(temps), jnp.asarray(tks), jnp.asarray(tps), jnp.asarray(mps),
    )
    toks, lps, tv, ti, nxt, cache = model.decode_chunk_pool(
        torch.from_numpy(first), cache, n, None, torch.from_numpy(temps),
        torch.from_numpy(tks), torch.from_numpy(tps), torch.from_numpy(mps), all_greedy=True,
    )
    live = slice(0, 3)
    np.testing.assert_array_equal(toks.numpy()[live], np.asarray(jtoks)[live])
    np.testing.assert_array_equal(nxt.numpy()[live], np.asarray(jnext)[live])
    np.testing.assert_allclose(lps.numpy()[live], np.asarray(jlps)[live], atol=LP_TOL, rtol=LP_TOL)
    np.testing.assert_allclose(tv.numpy()[live], np.asarray(jtv)[live], atol=LP_TOL, rtol=LP_TOL)
    np.testing.assert_array_equal(ti.numpy()[live], np.asarray(jti)[live])
    assert toks.dtype == ti.dtype == torch.int32 and lps.shape == (4, n)
    assert tv.shape == ti.shape == (4, n, 5)
    assert bool(torch.isfinite(lps).all()) and bool(torch.isfinite(tv).all())
    np.testing.assert_array_equal(cache["lengths"].numpy()[live], lengths[live] + n)


# -- the pool against solo decode --------------------------------------------


def test_pooled_greedy_matches_solo(pooled, solo):
    for prompt, n in (([1, 2, 3], 11), ([7] * 30, 6), ([42], 1), ([5, 6], 4)):
        assert pooled.generate(prompt, n) == solo.generate(prompt, n), (prompt, n)


def test_concurrent_streams_share_the_pool(pooled, solo):
    prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
    want = [solo.generate(p, 9) for p in prompts]
    got = [None] * 4
    before = pooled.decode_pool.dispatches

    def run(i):
        got[i] = pooled.generate(prompts[i], 9)

    _threads(run, 4)
    assert got == want
    # four streams of 8 pooled tokens in chunks of 4 need 2 chunks apiece
    # alone; sharing, far fewer than 4 x 2 + pipeline slack each
    assert pooled.decode_pool.dispatches - before < 4 * (2 + 3)
    assert pooled.decode_pool.occupancy()["active"] == 0


def test_slots_recycle_across_many_requests(pooled, solo):
    for i in range(12):  # 12 sequential requests through 4 slots
        prompt = [(i % 5) + 1, 2, 3]
        assert pooled.generate(prompt, 5) == solo.generate(prompt, 5), i


def test_saturation_falls_back_to_solo(pooled, solo):
    stops, queues = _occupy(pooled, 4)
    try:
        before = pooled.decode_pool.rejects.get("no_free_slots", 0)
        assert pooled.generate([9, 8, 7], 7) == solo.generate([9, 8, 7], 7)
        assert pooled.decode_pool.rejects["no_free_slots"] == before + 1
    finally:
        _release(stops, queues)
    assert pooled.decode_pool.occupancy()["free"] == 4


def test_seeded_requests_bypass_pool(pooled):
    before = pooled.decode_pool.dispatches
    a = pooled.generate([1, 2, 3], 8, sampler=Sampler(temperature=1.0, seed=5))
    b = pooled.generate([1, 2, 3], 8, sampler=Sampler(temperature=1.0, seed=5))
    assert a == b and len(a) == 8
    assert pooled.decode_pool.dispatches == before


def test_pooled_sampling_respects_top_k(pooled):
    """Unseeded sampling decodes in the pool on its per-slot knobs; top_k=1
    reduces to greedy, and the slot's knobs go back to greedy on free."""
    greedy = pooled.generate([4, 5, 6], 6)
    before = pooled.decode_pool.dispatches
    assert pooled.generate([4, 5, 6], 6, sampler=Sampler(temperature=5.0, top_k=1)) == greedy
    assert pooled.decode_pool.dispatches > before
    pool = pooled.decode_pool
    with pool._work:
        assert (pool._temps == 0).all() and (pool._top_ks == 0).all()
        assert pool._temps_dev.tolist() == [0.0] * 4 and pool._top_ks_dev.tolist() == [0] * 4


@pytest.mark.parametrize("at", [0, 5])
def test_stop_tokens_pooled_and_solo_agree(pooled, solo, at):
    full = solo.generate([1, 2, 3], 10)
    assert len(full) == 10
    stop_tok = full[at]
    want = full[: full.index(stop_tok)]
    for dev in (solo, pooled):
        assert dev.generate([1, 2, 3], 10, stop_tokens=[stop_tok]) == want


def test_cancellation_frees_slot(pooled):
    stop = threading.Event()
    seen = []

    def on_token(t):
        seen.append(t)
        if len(seen) >= 2:
            stop.set()

    out = pooled.generate([1, 2, 3], 100, on_token=on_token, stop=stop)
    assert 2 <= len(out) < 100
    pool = pooled.decode_pool
    for _ in range(200):  # the worker frees it at its next delivery
        if pool.occupancy()["active"] == 0:
            break
        threading.Event().wait(0.01)
    assert pool.occupancy()["active"] == 0
    assert len(pooled.generate([1, 2, 3], 5)) == 5


def _pool_bursts(dev, prompt, n, top):
    """Submit a prefilled prompt to the pool asking for logprobs (and
    ``top`` alternatives): -> (first token, [(id, logprob, alts | None)])."""
    state = dev.runner.run_batch([np.asarray(prompt, np.int32)])[0]
    q = dev.decode_pool.submit(state.row(), state["length"], state["next_token"], n - 1,
                               Sampler(), want_logprobs=True, want_top_logprobs=top)
    items = []
    while (item := q.get(timeout=60)) is not DONE:
        items.extend(item)
    return state["next_token"], items


def _teacher_forced_logprobs(dev, prompt, first, ids):
    """Batch-1 logprobs of ``ids`` after ``prompt`` + ``first``."""
    state = dev.runner.run_batch([np.asarray(prompt, np.int32)])[0]
    cache, tok, lps = state["cache"], torch.tensor([[first]], dtype=torch.int32), []
    for t in ids:
        logits, cache = dev.runner.model.decode_step(tok, cache)
        lps.append(float(_chosen_logprobs(logits, torch.tensor([t]))[0]))
        tok = torch.tensor([[t]], dtype=torch.int32)
    return lps


@pytest.mark.parametrize("prompt,n,top", [([1, 2, 3], 11, False), ([5, 6], 4, False),
                                          ([1, 2, 3], 6, True)])
def test_pooled_logprobs_match_solo(pooled, solo, prompt, n, top):
    """The pool's delivered logprobs against a teacher-forced batch-1
    decode of the same ids; asked for, the top-5 alternatives in order,
    the greedy token first."""
    first, burst = _pool_bursts(pooled, prompt, n, top)
    ids = [t for t, _, _ in burst]
    assert [first] + ids == solo.generate(prompt, n)
    np.testing.assert_allclose([lp for _, lp, _ in burst],
                               _teacher_forced_logprobs(solo, prompt, first, ids),
                               rtol=LP_TOL, atol=LP_TOL)
    for t, lp, alts in burst:
        if not top:
            assert alts is None
            continue
        vals = [v for _, v in alts]
        assert len(alts) == 5 and vals == sorted(vals, reverse=True)
        assert alts[0][0] == t  # greedy picks the argmax
        np.testing.assert_allclose(alts[0][1], lp, rtol=LP_TOL, atol=LP_TOL)


def test_idle_slot_past_max_seq_is_reused_cleanly(pooled, solo):
    """Idle slots decode in lockstep: one long request drives the other
    slots' lengths past max_seq; the clamps keep them harmless, and a
    request landing in such a slot decodes as it does solo."""
    pool = pooled.decode_pool
    for _ in range(2):  # ~32 chunks of 4 steps each
        assert len(pooled.generate([3, 1, 4], 120)) <= 120
    with pool._work:
        assert int(pool.cache["lengths"].max()) > TINY.max_seq
    prompts = [[i + 2, 7, 1] for i in range(4)]
    want = [solo.generate(p, 9) for p in prompts]
    got = [None] * 4

    def run(i):
        got[i] = pooled.generate(prompts[i], 9)

    _threads(run, 4)
    assert got == want


def test_kv_exhausted_rejects_and_decodes_solo(solo):
    """With the shared ledger claimed, submit rejects with kv_exhausted and
    the request decodes solo; released budget admits the next request."""
    dev = _device(DECODE_SLOTS="2", KV_BLOCKS="8", KV_BLOCK_TOKENS="16")
    try:
        assert dev.kv_pool is not None
        claimed = dev.kv_pool.reserve_ledger(TINY.max_seq)  # the whole ledger
        out = dev.generate([1, 2, 3], 6)
        assert dev.decode_pool.rejects == {"kv_exhausted": 1}
        assert out == solo.generate([1, 2, 3], 6)
        dev.kv_pool.release_ledger(claimed)
        before = dev.decode_pool.dispatches
        assert dev.generate([1, 2, 3], 6) == out
        assert dev.decode_pool.dispatches > before  # pooled this time
        assert dev.kv_pool.stats()["reserved"] == 0  # released at finish
    finally:
        dev.close()


def test_worker_death_fails_requests_not_hangs():
    dev = _device(DECODE_SLOTS="2", DECODE_CHUNK="2")
    try:
        pool = dev.decode_pool

        def boom():
            raise RuntimeError("device fell off")

        pool._run_executable = boom
        with pytest.raises(RuntimeError, match="device fell off"):
            dev.generate([1, 2, 3], 8)
        assert pool.occupancy()["closed"]
        assert len(dev.generate([1, 2, 3], 4)) == 4  # later requests decode solo
    finally:
        dev.close()


def test_close_mid_stream_raises_not_truncates():
    dev = _device(DECODE_SLOTS="2", DECODE_CHUNK="2")
    try:
        results = []
        started = threading.Event()

        def run():
            try:
                results.append(("ok", dev.generate([1, 2, 3], 10_000,
                                                   on_token=lambda t: started.set())))
            except RuntimeError as exc:
                results.append(("err", str(exc)))

        t = threading.Thread(target=run)
        t.start()
        assert started.wait(60)
        dev.decode_pool.close()
        t.join(timeout=60)
        assert results, "generation thread hung"
        kind, value = results[0]
        if kind == "ok":  # finished at the cache bound before the close
            assert len(value) >= TINY.max_seq - 4
        else:
            assert "closed" in value
    finally:
        dev.close()


def test_close_raises_while_the_worker_runs(monkeypatch):
    """close() returns only once the worker has stopped: a worker held in a
    dispatch past the join raises instead of running on unnoticed."""
    dev = _device(DECODE_SLOTS="2", DECODE_CHUNK="2")
    pool = dev.decode_pool
    entered, release = threading.Event(), threading.Event()
    real = pool._run_executable

    def held():
        entered.set()
        release.wait(60)
        return real()

    monkeypatch.setattr(pool, "_run_executable", held)
    monkeypatch.setattr(decode_pool, "CLOSE_TIMEOUT_S", 0.2)
    stops, queues = _occupy(dev, 1)
    try:
        assert entered.wait(60)
        with pytest.raises(RuntimeError, match="still running"):
            pool.close()
    finally:
        release.set()
        monkeypatch.setattr(decode_pool, "CLOSE_TIMEOUT_S", 60)
        dev.close()  # the worker stops at its next look at the pool
    assert not pool._thread.is_alive()
    items = []
    while (item := queues[0].get(timeout=60)) is not DONE:
        items.append(item)
    assert any(isinstance(i, PoolFailure) for i in items)


# -- the solo path's fetch (the copy is never queued behind the next chunk) --


def test_solo_fetch_starts_before_the_next_chunk(solo, monkeypatch):
    events = []
    model = solo.runner.model
    real_chunk, real_init, real_wait = model.decode_chunk_pool, HostFetch.__init__, HostFetch.wait

    def chunk(*a, **k):
        events.append("dispatch")
        return real_chunk(*a, **k)

    def init(self, *tensors):
        events.append("copy")
        real_init(self, *tensors)

    def wait(self):
        events.append("wait")
        return real_wait(self)

    monkeypatch.setattr(model, "decode_chunk_pool", chunk)  # solo decode's chunk at B = 1
    monkeypatch.setattr(HostFetch, "__init__", init)
    monkeypatch.setattr(HostFetch, "wait", wait)
    assert len(solo.generate([2, 7, 1], 17)) == 17
    # every chunk's copy starts right behind its dispatch, and chunk N+1 is
    # dispatched before chunk N is waited for
    for i, e in enumerate(events):
        if e == "dispatch":
            assert events[i + 1] == "copy", events
    assert events[:5] == ["dispatch", "copy", "dispatch", "copy", "wait"], events


# -- the batcher's scheduler gate ---------------------------------------------


def test_batcher_waits_for_the_scheduler():
    calls = []

    class Sched:
        def admit_prefill(self, tokens):
            calls.append(tokens)
            return 0.0

    b = DynamicBatcher(lambda ps: [len(p) for p in ps], max_batch=4, timeout_ms=100,
                       bucket_fn=lambda p: 16 if len(p) <= 16 else 32, scheduler=Sched())
    try:
        futs = [b.submit([0] * n) for n in (3, 5)]
        assert [f.result(10) for f in futs] == [3, 5]
        assert calls == [16 * 2]  # one cohort: its bucket x its rows
    finally:
        b.close()


# -- config ---------------------------------------------------------------------

_JAX_ATTRS = {
    "pool_enabled": "_pool_enabled", "pool_slots": "_pool_slots", "pool_depth": "_pool_depth",
    "kv_paged": "_kv_paged", "kv_block_tokens": "_kv_block_tokens", "kv_blocks": "_kv_blocks_cfg",
    "prefix_cache": "_prefix_cache_size", "prefix_lcp_min": "_prefix_lcp_min",
    "prefill_chunk_tokens": "_prefill_chunk_cfg", "sched_policy": "_sched_policy",
    "sched_max_defer_ms": "_sched_max_defer_ms", "pool_penalties": "_pool_penalties",
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
            return ("ok", serving_options(EnvFileConfig("/nonexistent"), int(env["BATCH_MAX_SIZE"])))
        except ValueError as exc:
            return ("err", str(exc))

    return _with_env(env, build)


@pytest.mark.parametrize("env", [
    {},
    {"BATCH_MAX_SIZE": "4", "DECODE_PIPELINE": "2", "KV_PAGED": "off", "PREFIX_CACHE": "3",
     "PREFIX_LCP_MIN": "-1", "PREFILL_CHUNK_TOKENS": "512", "SCHED_POLICY": " Decode-First ",
     "SCHED_MAX_DEFER_MS": "20", "KV_BLOCKS": "9", "KV_BLOCK_TOKENS": "16", "DECODE_POOL": "off"},
    {"PREFIX_CACHE": "-1"}, {"PREFIX_LCP_MIN": "-2"}, {"PREFILL_CHUNK_TOKENS": "-5"},
    {"SCHED_POLICY": "lifo"}, {"SCHED_MAX_DEFER_MS": "0"}, {"KV_BLOCK_TOKENS": "0"},
    {"KV_BLOCKS": "-1"}, {"DECODE_PIPELINE": "0"},
    {"DECODE_POOL_PENALTIES": " Eager "}, {"DECODE_POOL_PENALTIES": "sometimes"},
])
def test_config_defaults_and_errors_match_jax(env):
    """The new keys' defaults (DECODE_SLOTS follows BATCH_MAX_SIZE, here the
    port's default of 8) and validation messages are the JAX device's."""
    env = {"BATCH_MAX_SIZE": "8", **env}
    jax_side, port_side = _jax_options(env), _port_options(env)
    assert port_side == jax_side
    if not env.keys() - {"BATCH_MAX_SIZE"}:
        assert port_side[1]["pool_enabled"] and port_side[1]["kv_paged"]
        assert port_side[1]["pool_slots"] == 8 and port_side[1]["pool_depth"] == 3
