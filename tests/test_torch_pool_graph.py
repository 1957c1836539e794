"""The decode pool's CUDA graph over its plain chunk.

On the CPU: ``chunk_path``, which decides from what the pool observes
whether a chunk replays the captured graph or runs eagerly and why; the
pool's ``graph_chunks`` / ``eager_chunks`` counters on every path (plain,
penalized, adapter, speculative, a tp = 2 sharded model); and the storage of the tensors a graph
holds (the cache's ``k``, ``v`` and ``lengths``, the token row), which no
path may rebind. On the card (``cuda``): a graphed pool against the same
pool run eagerly, 8 slots at pipeline depth 3, with admissions between
chunks, a slot freed mid-pipeline and re-admitted: the same ids and
logprobs, the same kernel launch counts a chunk, every plain chunk a
replay.

Run the card tests there with ``python3 -m pytest --noconftest
tests/test_torch_pool_graph.py -m cuda``.
"""

import time

import numpy as np
import pytest
import torch

from gofr_tpu_torch.models import lora
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.models.transformer import Transformer, TransformerConfig
from gofr_tpu_torch.ops import flash
from gofr_tpu_torch.ops.sampling import Sampler
from gofr_tpu_torch.parallel import mesh as pm
from gofr_tpu_torch.parallel.serving import ShardedTransformer
from gofr_tpu_torch.tpu.decode_pool import DONE, DecodePool, PoolFailure, chunk_path
from gofr_tpu_torch.tpu.spec_pool import PoolSpecConfig

GREEDY = Sampler()


def _row(model, prompt):
    """A prefilled row for ``prompt``: (row cache, length, first token)."""
    cache = model.init_cache(1)
    tokens = torch.tensor([prompt], dtype=torch.int32, device=model.device)
    logits, cache = model.prefill(tokens, cache)
    return cache, len(prompt), int(torch.argmax(logits[0]))


def _submit(pool, model, prompt, max_new, row=None, **kw):
    row, length, first = row or _row(model, prompt)
    return first, pool.submit(row, length, first, max_new, kw.pop("sampler", GREEDY), **kw)


def _drain(q) -> list:
    """A pooled request's delivered items (ids, or (id, lp, tops) triples)."""
    out = []
    while True:
        item = q.get(timeout=120)
        if item is DONE:
            return out
        if isinstance(item, PoolFailure):
            raise item.exc
        if isinstance(item, tuple) and item[0] == "kv":
            continue
        out.extend(item)


def _idle(pool) -> None:
    """Wait until the worker has fetched every chunk it dispatched."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < 60:
        with pool._work:
            if not pool._active and not pool._in_flight:
                return
        time.sleep(0.01)
    raise AssertionError("pool did not drain")


def _storage(pool) -> tuple:
    """Where the pool's fixed tensors live (a sharded cache's k and v:
    the ``ShardedKV`` objects themselves)."""
    return tuple(t.data_ptr() if isinstance(t, torch.Tensor) else id(t)
                 for t in (pool.cache["k"], pool.cache["v"], pool.cache["lengths"],
                           pool._last_tokens))


# -- the decision, from what the pool observes ---------------------------------

@pytest.mark.parametrize("observed,path", [
    # (adapter, penalized, all_greedy, sharded, device, captured all_greedy values)
    ((False, False, True, False, "cuda", {True, False}), "graph"),
    ((False, False, False, False, "cuda", {True, False}), "graph"),
    ((True, False, True, False, "cuda", {True, False}), "adapter"),
    ((False, True, False, False, "cuda", {True, False}), "penalized"),
    ((False, False, True, True, "cuda", {True, False}), "sharded"),
    ((False, False, True, False, "cpu", {True, False}), "cpu"),
    ((False, False, True, False, "cuda", set()), "uncaptured"),
    ((False, False, False, False, "cuda", {True}), "uncaptured"),
    ((True, True, False, True, "cpu", set()), "adapter"),
], ids=["greedy", "sampled", "adapter", "penalized", "sharded", "cpu", "uncaptured",
        "uncaptured-sampled", "adapter-first"])
def test_chunk_path_decides_from_what_the_pool_observes(observed, path):
    assert chunk_path(*observed) == path


# -- the counters and the fixed tensors on the CPU -----------------------------

@pytest.fixture(scope="module")
def tiny():
    return Transformer.random(TINY, "cpu", 0)


def _plain(pool, model):
    _, q = _submit(pool, model, [5, 6, 7], 9)
    assert len(_drain(q)) == 9


def _penalized(pool, model):
    v = model.cfg.vocab_size
    pres = torch.zeros((1, v), dtype=torch.bool)
    pres[0, [5, 6, 7]] = True
    penalty = (pres, torch.zeros((1, v)), torch.zeros((1, v)), 1.3, 0.5, 0.2)
    _, q = _submit(pool, model, [5, 6, 7], 9, penalty=penalty)
    assert len(_drain(q)) == 9


def _adapter(pool, model):
    stack = lora.build_lora_stack(model, {"calm": lora.add_lora(model, seed=1)})
    pool.enable_lora(stack, {"calm": 1})
    _, q = _submit(pool, model, [5, 6, 7], 9, adapter="calm")
    assert len(_drain(q)) == 9


def _spec(pool, model):
    prompt = [1, 2, 3, 4] * 6
    _, q = _submit(pool, model, prompt, 12, spec_ctx=prompt)
    assert len(_drain(q)) == 12
    assert pool.spec_stats["cycles"] > 0


CYCLES = {"plain": (_plain, "cpu"), "penalized": (_penalized, "penalized"),
          "adapter": (_adapter, "adapter"), "spec": (_spec, None), "sharded": (_plain, "sharded")}


@pytest.mark.parametrize("cycle", sorted(CYCLES))
def test_every_path_keeps_the_pools_tensors(tiny, cycle):
    run, reason = CYCLES[cycle]
    model = tiny
    if cycle == "sharded":
        mesh = pm.make_mesh(pm.mesh_shape_for(2, tp=2), devices=[torch.device("cpu")] * 2)
        model = ShardedTransformer.from_model(tiny, mesh)
    pool = DecodePool(model, n_slots=4, chunk=4, penalties="eager",
                      spec=PoolSpecConfig(k_max=4) if cycle == "spec" else None)
    try:
        before = _storage(pool)
        occ = pool.occupancy()
        assert (occ["graph_chunks"], occ["eager_chunks"], occ["graph_pool_bytes"]) == (0, {}, 0)
        run(pool, model)
        _idle(pool)
        assert _storage(pool) == before
        # the freed slot (the first taken) restarts at length 0: its idle
        # row reads nothing of the finished request
        assert int(pool.cache["lengths"][0]) == 0
        occ = pool.occupancy()
        assert occ["graph_chunks"] == 0 and occ["graph_capture_s"] == 0
        if reason is not None:
            # every chunk eager, counted under its reason
            assert occ["eager_chunks"].get(reason, 0) > 0
            assert sum(occ["eager_chunks"].values()) == occ["dispatches"]
    finally:
        pool.close()


def test_records_mark_eager_chunks_not_graphed(tiny):
    from gofr_tpu_torch.tpu.introspect import DispatchTimeline

    timeline = DispatchTimeline()
    pool = DecodePool(tiny, n_slots=4, chunk=4, timeline=timeline)
    try:
        _plain(pool, tiny)
        _idle(pool)
    finally:
        pool.close()
    chunks = timeline.records(kind="decode_chunk")
    assert chunks and all(r["graphed"] is False for r in chunks)
    assert all("graphed" not in r for r in timeline.records() if r["kind"] != "decode_chunk")


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    flash.build()
    return torch.device("cuda")


# the decode variant's shape class: bf16, head dim 128
D128 = TransformerConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
                         hidden_dim=512, max_seq=256, rope_theta=10000.0,
                         dtype=torch.bfloat16)
PROMPTS = [[5 + i, 9, 17 + 3 * i, 2] * (1 + i % 3) for i in range(10)]
FIRST_WAVE = (3, 20, 9, 30, 5, 17, 24)
SECOND_WAVE = (14, 6)


def _serve(pool, model) -> tuple:
    """Seven requests in eight slots, the first finishing within one chunk
    while the pipeline holds more, then two admitted between chunks: one
    into the slot just freed, one into the slot never used. -> (each
    request's (ids, logprobs), the launch counters' deltas over the
    chunks (the rows are prefilled before), the most chunks in flight at
    a dispatch)."""
    rows = [_row(model, p) for p in PROMPTS[:len(FIRST_WAVE) + len(SECOND_WAVE)]]
    depths = []
    dispatch = pool._dispatch_chunk

    def counted(in_flight, *args):
        depths.append(len(in_flight))  # chunks already in flight
        return dispatch(in_flight, *args)

    pool._dispatch_chunk = counted
    counters = flash.launch_counters()
    before = {n: c.value for n, c in counters.items()}
    firsts, queues = [], []
    for i, n in enumerate(FIRST_WAVE):
        first, q = _submit(pool, model, None, n, row=rows[i], want_logprobs=True,
                           want_top_logprobs=i == 1)
        firsts.append(first)
        queues.append(q)
    served = [_drain(queues[0])]  # freed mid-pipeline: the others decode on
    for i, n in enumerate(SECOND_WAVE, len(FIRST_WAVE)):
        first, q = _submit(pool, model, None, n, row=rows[i], want_logprobs=True)
        firsts.append(first)
        queues.append(q)
    served += [_drain(q) for q in queues[1:]]
    _idle(pool)
    out = [([f] + [t for t, _, _ in items], [lp for _, lp, _ in items])
           for f, items in zip(firsts, served)]
    return out, {n: c.value - before[n] for n, c in counters.items()}, max(depths)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [TINY, D128], ids=["tiny-f32", "bf16-d128"])
def test_graphed_pool_matches_the_eager_pool(cuda, cfg):
    model = Transformer.random(cfg, cuda, 0)
    runs = {}
    for label in ("eager", "graph"):
        pool = DecodePool(model, n_slots=8, chunk=4, pipeline_depth=3)
        try:
            occ = pool.occupancy()
            assert occ["graph_pool_bytes"] > 0 and occ["graph_capture_s"] > 0
            if label == "eager":
                pool._graphs.clear()  # the same pool, every chunk eager
            served, launched, depth = _serve(pool, model)
            runs[label] = (served, launched, pool.occupancy())
            # a replay keeps one chunk in flight; eager chunks fill the pipeline
            assert depth == (0 if label == "graph" else 2)
        finally:
            pool.close()
    (eager, e_launched, e_occ), (graph, g_launched, g_occ) = runs["eager"], runs["graph"]
    for (e_ids, e_lps), (g_ids, g_lps) in zip(eager, graph):
        assert g_ids == e_ids
        np.testing.assert_allclose(g_lps, e_lps, rtol=0, atol=1e-5)
    assert [len(ids) for ids, _ in graph] == [n + 1 for n in FIRST_WAVE + SECOND_WAVE]
    # every plain chunk after the warm-up replayed; none in the eager run
    assert g_occ["graph_chunks"] == g_occ["dispatches"] > 0 and g_occ["eager_chunks"] == {}
    assert e_occ["graph_chunks"] == 0
    assert e_occ["eager_chunks"] == {"uncaptured": e_occ["dispatches"]}
    # the launch counters count what the card ran: the same per chunk
    per_chunk = cfg.n_layers * 4
    for launched, occ in ((e_launched, e_occ), (g_launched, g_occ)):
        assert launched["launches"] == per_chunk * occ["dispatches"]
    e_rate = {n: v / e_occ["dispatches"] for n, v in e_launched.items()}
    g_rate = {n: v / g_occ["dispatches"] for n, v in g_launched.items()}
    assert g_rate == e_rate


@pytest.mark.cuda
def test_sampled_graph_draws_what_the_eager_chunk_draws(cuda):
    # one sampled request alone, the pool's generator seeded alike: the
    # graphed pool's draws are the eager pool's, chunk for chunk
    model = Transformer.random(TINY, cuda, 0)
    row = _row(model, PROMPTS[1])
    sampler = Sampler(temperature=0.8, top_p=0.9)
    runs = {}
    for label in ("eager", "graph"):
        pool = DecodePool(model, n_slots=8, chunk=4)
        try:
            if label == "eager":
                pool._graphs.clear()
            pool._generator.manual_seed(1234)
            _, q = _submit(pool, model, None, 40, row=row, sampler=sampler)
            runs[label] = _drain(q)
            _idle(pool)
            occ = pool.occupancy()
        finally:
            pool.close()
        replays = occ["dispatches"] if label == "graph" else 0
        assert occ["graph_chunks"] == replays
    assert runs["graph"] == runs["eager"] and len(runs["graph"]) == 40
