"""gofr_tpu_torch.tpu.kv_blocks and scheduler against the JAX package's:
the same scripted and seeded operation sequences on ``BlockPool`` give
equal block ids, refcounts, ``stats()`` and raised errors;
``TorchKVArena`` holds the same rows as ``JaxKVArena`` (bit-equal within a
table's length, equal byte counts); the scheduler admits and defers alike."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu.tpu import kv_blocks as jkv
from gofr_tpu.tpu import scheduler as jsched
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.tpu import kv_blocks as tkv
from gofr_tpu_torch.tpu import scheduler as tsched


def _run(pool, op, *args):
    """One operation -> ("ok", result) or ("err", type name, message)."""
    try:
        return ("ok", getattr(pool, op)(*args))
    except (RuntimeError, ValueError) as exc:
        return ("err", type(exc).__name__, str(exc))


def _table(res):
    if res[0] == "ok" and hasattr(res[1], "table"):  # a cache entry
        return ("ok", list(res[1].table.blocks), res[1].table.length, res[1].meta)
    if res[0] == "ok" and hasattr(res[1], "blocks"):
        return ("ok", list(res[1].blocks), res[1].length)
    if res[0] == "ok" and isinstance(res[1], tuple) and res[1] and hasattr(res[1][0], "blocks"):
        return ("ok", list(res[1][0].blocks), res[1][0].length, res[1][1])
    return res


def _state(pool):
    return list(pool._ref), pool.stats(), [k for k, _ in pool.cache_items()]


class _Pair:
    """The JAX pool and the port's, driven in lockstep; every result and
    every state must agree."""

    def __init__(self, *args, **kwargs):
        self.j = jkv.BlockPool(*args, **kwargs)
        self.t = tkv.BlockPool(*args, **kwargs)
        self.tables = {}  # name -> (jax table, torch table)

    def op(self, op, *args, tables=()):
        jargs = [self.tables[a][0] if a in tables else a for a in args]
        targs = [self.tables[a][1] if a in tables else a for a in args]
        rj, rt = _run(self.j, op, *jargs), _run(self.t, op, *targs)
        assert _table(rj) == _table(rt), (op, args, rj, rt)
        assert _state(self.j) == _state(self.t), (op, args)
        return rj, rt

    def keep(self, name, rj, rt):
        if rj[0] == "ok":
            j, t = rj[1], rt[1]
            if isinstance(j, tuple):
                j, t = j[0], t[0]
            self.tables[name] = (j, t)


def _key(ids):
    return np.asarray(ids, np.int32).tobytes()


def test_scripted_sequence_matches_jax():
    p = _Pair(12, 4, block_bytes=100, hbm_budget_bytes=1200, cache_entries=3,
              scratch=True, ledger_blocks=14)
    p.keep("a", *p.op("reserve", 10))
    p.tables["a"][0].length = p.tables["a"][1].length = 10
    p.op("trim", "a", tables=("a",))
    p.keep("b", *p.op("alias", "a", 6, tables=("a",)))
    p.op("alias", "a", 11, tables=("a",))  # past the donor: ValueError
    p.op("cow_boundary", "b", tables=("b",))  # shared boundary -> private copy
    p.keep("c", *p.op("alias_full_blocks", "a", 9, tables=("a",)))
    p.op("ensure", "c", 12, tables=("c",))
    p.op("cache_put", _key(range(10)), "a", {"n": 1}, tables=("a",))
    p.op("cache_put", _key(range(6)), "b", {"n": 2}, tables=("b",))
    p.op("cache_lookup", _key(range(10)))
    p.op("reserve_ledger", 20)
    p.op("reserve_ledger", 400)  # more than the ledger: KVExhausted
    p.op("alloc", 9)  # evicts LRU entries to make room
    p.op("alloc", 30)  # unsatisfiable even after evicting everything
    p.op("release_ledger", 5)
    p.op("incref", [0])
    p.op("release_blocks", [11, 11, 11])  # double free
    p.op("cache_clear")
    p.op("release", "c", tables=("c",))
    assert jkv.blocks_for(65, 64) == tkv.blocks_for(65, 64) == 2


@pytest.mark.parametrize("seed", range(4))
def test_random_sequences_match_jax(seed):
    """Seeded fuzz over alloc/alias/cow/cache/ledger/release, with the
    arena small enough that eviction and exhaustion happen."""
    rng = np.random.default_rng(seed)
    p = _Pair(10, 4, block_bytes=64, cache_entries=4, scratch=True, ledger_blocks=12)
    live = []
    for step in range(120):
        kind = rng.integers(0, 9)
        if kind == 0:
            name = f"t{step}"
            n = int(rng.integers(1, 16))
            p.keep(name, *p.op("reserve", n))
            if name in p.tables:
                for tab in p.tables[name]:
                    tab.length = n
                live.append(name)
        elif kind == 1 and live:
            donor = live[rng.integers(len(live))]
            n = int(rng.integers(0, p.tables[donor][0].length + 2))  # may overshoot
            name = f"a{step}"
            p.keep(name, *p.op("alias", donor, n, tables=(donor,)))
            if name in p.tables:
                live.append(name)
        elif kind == 2 and live:
            donor = live[rng.integers(len(live))]
            name = f"f{step}"
            p.keep(name, *p.op("alias_full_blocks", donor, int(rng.integers(0, 16)),
                               tables=(donor,)))
            if name in p.tables:
                live.append(name)
        elif kind == 3 and live:
            p.op("cow_boundary", live[rng.integers(len(live))], tables=tuple(live))
        elif kind == 4 and live:
            name = live.pop(rng.integers(len(live)))
            p.op("cache_put", _key(rng.integers(0, 5, size=int(rng.integers(1, 6)))), name,
                 {"s": step}, tables=(name,))
        elif kind == 5:
            p.op("cache_lookup", _key(rng.integers(0, 5, size=int(rng.integers(1, 6)))))
        elif kind == 6:
            p.op("reserve_ledger", int(rng.integers(1, 30)))
        elif kind == 7:
            p.op("release_ledger", int(rng.integers(0, 4)))
        elif kind == 8 and live:
            p.op("release", live.pop(rng.integers(len(live))), tables=tuple(p.tables))
    ids = np.asarray([1, 2, 3, 4], np.int32)
    for limit, min_shared in ((4, 1), (3, 2), (4, 9)):
        js = jkv.lcp_scan(p.j.cache_items(), ids, limit, min_shared)
        ts = tkv.lcp_scan(p.t.cache_items(), ids, limit, min_shared)
        assert (js[0], js[1]) == (ts[0], ts[1])


def test_arena_matches_jax_arena():
    """Same rows scattered into the same tables (one aliasing its donor's
    whole blocks, skipped) gather to bit-equal rows within each length;
    scatter_row reports the same bytes."""
    bt, n_blocks = 16, 12
    jar = jkv.JaxKVArena(JAX_TINY, n_blocks, bt)
    tar = tkv.TorchKVArena(TINY, n_blocks, bt, device="cpu")
    assert jar.block_bytes == tar.block_bytes
    rng = np.random.default_rng(0)
    shape = (TINY.n_layers, 1, TINY.max_seq, TINY.n_kv_heads, TINY.head_dim)

    def row():
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
        return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                {"k": torch.from_numpy(k), "v": torch.from_numpy(v)})

    donor = jkv.BlockTable([3, 7, 1, 9], 50)
    jrow, trow = row()
    assert jar.scatter_row(jrow, donor) == tar.scatter_row(trow, donor)
    ext = jkv.BlockTable([3, 7, 4, 5, 11], 70)  # extends the donor's first 2 blocks
    jrow2, trow2 = row()
    assert jar.scatter_row(jrow2, ext, skip_blocks=2) == tar.scatter_row(trow2, ext, skip_blocks=2)
    for table in (donor, ext, jkv.BlockTable([7, 4], 20)):
        jg = jar.gather_row(table, table.length)
        tg = tar.gather_row(table, table.length)
        n = table.length
        for name in ("k", "v"):
            assert tuple(tg[name].shape) == tuple(jg[name].shape) == shape
            np.testing.assert_array_equal(tg[name][:, :, :n].numpy(),
                                          np.asarray(jg[name])[:, :, :n])
        assert tg["lengths"].tolist() == np.asarray(jg["lengths"]).tolist() == [n]
    # the skipped blocks keep the donor's content
    got = tar.gather_row(ext, 32)["k"][:, 0, :32].numpy()
    np.testing.assert_array_equal(got, trow["k"][:, 0, :32].numpy())
    with pytest.raises(ValueError, match="must divide"):
        tkv.TorchKVArena(TINY, 4, 48, device="cpu")


def _sched_trace(mod, policy, notes):
    """Admit one prefill against a pool that notes ``notes`` decode
    chunks after 40 ms each (0 = idle); -> (deferred at all, stats)."""
    s = mod.InterferenceScheduler(policy=policy, max_defer_ms=400, idle_after_s=5.0)
    if notes:
        s.note_decode_chunk(4)
        s.admit_prefill(64)  # takes this interval's turn

        def decode():
            for _ in range(notes):
                time.sleep(0.04)
                s.note_decode_chunk(4)

        t = threading.Thread(target=decode)
        t.start()
        waited = s.admit_prefill(64)
        t.join()
    else:
        waited = s.admit_prefill(64)
    stats = dict(s.stats)
    stats.pop("deferred_chunks")
    return waited > 0.02, stats


@pytest.mark.parametrize("policy,notes", [("fair", 0), ("fair", 1), ("decode-first", 2),
                                          ("prefill-first", 1)])
def test_scheduler_matches_jax(policy, notes):
    assert tsched.POLICIES == jsched.POLICIES
    assert _sched_trace(tsched, policy, notes) == _sched_trace(jsched, policy, notes)
    for mod in (tsched, jsched):
        with pytest.raises(ValueError, match="not supported"):
            mod.InterferenceScheduler(policy="lifo")
