"""``parallel/mesh.py``, ``parallel/sharding.py`` and the sharded model
(``parallel/serving.py``) against the JAX package on the CPU.

- The mesh: ``mesh_shape_for``, ``make_mesh``, ``mesh_axes`` and the
  device's ``_parse_mesh_request`` / ``_mesh_from_topology`` over a table
  of requests, equal results or the same exception class and message; the
  port counts the CPU's devices from ``XLA_FLAGS`` as JAX does.
- The specs: ``param_specs`` of the dense, int8, int4 (one group and
  several), w8a8 and LoRA trees equal JAX's ``PartitionSpec`` entry by
  entry; ``shard_params`` gives the blocks JAX's placement gives, and they
  reassemble into the tree's arrays.
- The reduce: ``quant.row_parallel_mm`` over two shards equals the
  unsharded ``mm`` (f32 within 1e-5; w8a8 exactly, where a per-shard
  activation scale would show).
- The model: every entry point of a ``ShardedTransformer`` (tp = 2,
  tp = 2 x dp = 2, dp = 2, tp = 2 x fsdp = 2) against the unsharded model
  on the JAX package's tiny weights: ids exactly, f32 logits within 1e-5
  (the row-parallel sums add two f32 partials where the unsharded product
  accumulates once); the prefill against the JAX function within 1e-4, the
  tolerance of ``tests/test_torch_model.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import transformer as jt
from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu_torch.models import quant
from gofr_tpu_torch.models.convert import to_torch, transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.parallel import mesh as pm
from gofr_tpu_torch.parallel import sharding as ps
from gofr_tpu_torch.parallel.serving import ShardedTransformer
from gofr_tpu_torch.tpu import device as port_device
from gofr_tpu_torch.tpu.kv_blocks import BlockTable, TorchKVArena

TOL = 1e-5
MESHES = {"tp2": {"tp": 2}, "tp2-dp2": {"tp": 2, "dp": 2}, "dp2": {"dp": 2},
          "tp2-fsdp2": {"tp": 2, "fsdp": 2}}


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    kw = {k: v for k, v in shape.items() if k != "dp"}
    return pm.make_mesh(pm.mesh_shape_for(n, **kw), devices=pm.visible_devices("cpu")[:n])


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # the class and message are the outcome
        return (type(exc).__name__, str(exc))


# -- the mesh ----------------------------------------------------------------------

def test_visible_devices_reads_the_host_device_count(monkeypatch):
    assert len(pm.visible_devices("cpu")) == len(jax.devices()) == 8
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=3")
    assert pm.visible_devices("cpu") == [torch.device("cpu")] * 3
    monkeypatch.delenv("XLA_FLAGS")
    assert pm.visible_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="no devices"):
        pm.visible_devices("tpu")


@pytest.mark.parametrize("n, kw", [
    (8, {}), (8, {"tp": 2}), (8, {"tp": 2, "fsdp": 2}), (8, {"tp": 4, "sp": 2}),
    (4, {"pp": 2, "ep": 2}), (6, {"tp": 4}), (4, {"tp": 8}),
])
def test_mesh_shape_for_matches_jax(n, kw):
    from gofr_tpu.parallel.mesh import mesh_shape_for

    assert _outcome(pm.mesh_shape_for, n, **kw) == _outcome(mesh_shape_for, n, **kw)


@pytest.mark.parametrize("shape", [
    {"tp": 2}, {"dp": 2, "tp": 2}, {"dp": 8}, {"fsdp": 2, "tp": 4}, {"tp": 1}, None,
])
def test_make_mesh_and_mesh_axes_match_jax(shape):
    from gofr_tpu.parallel.mesh import axis_size, make_mesh, mesh_axes

    n = 8 if shape is None else int(np.prod(list(shape.values())))
    jmesh = make_mesh(shape, devices=jax.devices()[:n])
    mesh = pm.make_mesh(shape, devices=pm.visible_devices("cpu")[:n])
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.size == jmesh.size == n
    assert pm.mesh_axes(mesh) == mesh_axes(jmesh)
    assert pm.axis_size(mesh, "tp") == axis_size(jmesh, "tp")
    assert pm.mesh_axes(None) is mesh_axes(None) is None
    wrong = _outcome(make_mesh, {"tp": 3}, devices=jax.devices()[:2])
    assert _outcome(pm.make_mesh, {"tp": 3}, devices=pm.visible_devices("cpu")[:2]) == wrong


@pytest.mark.parametrize("request_", [
    "tp=2", "tp=2,dp=2", " fsdp=2 , tp=2 ", "dp=4", "", "  ", "2x4", "1x1", "tp=", "tp=abc",
    "pp=2", "sp=2", "ep=4", "tp=2,,dp=2", "TP=2",
])
def test_parse_mesh_request_matches_jax(request_):
    from gofr_tpu.tpu.device import _parse_mesh_request

    want = _outcome(_parse_mesh_request, request_)
    assert _outcome(port_device._parse_mesh_request, request_) == want


@pytest.mark.parametrize("request_", [
    "tp=2,dp=2", "", "1x1", "tp=64", "pp=2", "fsdp=2,tp=2", "dp=3", "tp=2,dp=4", "tp=8,dp=2",
])
def test_mesh_from_topology_matches_jax(request_):
    from gofr_tpu.tpu.device import _mesh_from_topology

    want = _outcome(_mesh_from_topology, request_, jax.devices())
    got = _outcome(port_device._mesh_from_topology, request_, pm.visible_devices("cpu"))
    assert got[0] == want[0]
    if want[0] == "ok":
        assert (got[1] is None) == (want[1] is None)
        if want[1] is not None:
            assert got[1].shape == dict(want[1].shape) and got[1].size == want[1].size
    else:
        assert got[1] == want[1]


# -- the specs ---------------------------------------------------------------------

def _jax_tree(kind):
    from gofr_tpu.models.lora import add_lora
    from gofr_tpu.models.quant import quantize_array_int4

    key = jax.random.PRNGKey(0)
    if kind == "lora":
        return add_lora(jt.init_transformer(key, JAX_TINY), jax.random.PRNGKey(1), rank=4)
    if kind == "int4-groups":
        # tiny's reduction dims clamp int4 to one group: several need a
        # smaller group, as the JAX package's own case builds
        w = jax.random.normal(key, (256, 64), jnp.float32)
        return {"w_down": quantize_array_int4(w, group=64), "wq": quantize_array_int4(w, group=32)}
    return jt.init_transformer(key, JAX_TINY, quantize={"dense": False}.get(kind, kind))


def _torch_tree(tree):
    return jax.tree.map(lambda a: to_torch(np.asarray(a)), tree)


def _assert_specs_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_specs_equal(got[k], want[k])
        return
    assert got == tuple(want), (got, want)


@pytest.mark.parametrize("kind", ["dense", "int8", "int4", "int4-groups", "w8a8", "lora"])
def test_param_specs_match_jax(kind):
    from gofr_tpu.parallel.sharding import param_specs

    tree = _jax_tree(kind)
    want = param_specs(tree)
    _assert_specs_equal(ps.param_specs(_torch_tree(tree)), want)
    if kind == "int4-groups":
        assert want["w_down"]["scale"] == want["w_down"]["q4"]
        return
    if kind == "lora":
        return
    # the port's own modules (per-layer 2-D weights): JAX's spec without
    # its leading layer axis
    model = transformer_from_tree(jax.tree.map(np.asarray, tree), TINY, device="cpu")
    for name in ("wq", "wo", "w_gate", "w_down", "attn_norm"):
        spec = ps.param_specs(getattr(model.layers[0], name), name)
        jspec = want["layers"][name]
        if isinstance(jspec, dict):
            assert set(spec) == {"q" if "q" in jspec else "q4" if "q4" in jspec else "q8", "scale"}
            for k in spec:
                if k == "scale" and "q4" in spec:
                    # the port's tiny int4 scale has one group: the int8 rule
                    assert spec[k] == (None, tuple(jspec[k])[-1])
                else:
                    assert spec[k] == tuple(jspec[k])[1:]
        else:
            assert spec == tuple(jspec)[1:]
    for name in ("embed", "lm_head", "norm_f"):
        _assert_specs_equal(ps.param_specs(getattr(model, name), name), want[name])


def test_cache_batch_and_arena_specs_match_jax():
    from gofr_tpu.parallel import sharding as js

    _assert_specs_equal(ps.cache_specs(None), js.cache_specs(None))
    assert ps.batch_spec() == tuple(js.batch_spec())
    assert ps.batch_spec(sp=True) == tuple(js.batch_spec(sp=True))
    assert ps.kv_arena_spec() == tuple(js.kv_arena_spec())


def _unshard(blocks, spec, mesh):
    """Reassemble a leaf from its per-device blocks: the inverse of
    ``shard_params`` for one leaf (replicas hold equal blocks)."""
    dims = [d for d, entry in enumerate(spec) if entry is not None]
    by_index = {}
    for c, block in zip(ps.device_coords(mesh), blocks):
        by_index.setdefault(tuple(ps._split(spec[d], mesh, c)[1] for d in dims), block)

    def build(prefix, level):
        if level == len(dims):
            return by_index[prefix]
        n = ps._split(spec[dims[level]], mesh, {})[0]
        return torch.cat([build((*prefix, i), level + 1) for i in range(n)], dims[level])

    return build((), 0)


def _blocks(leaf_blocks):
    """Distinct blocks of a leaf: (shape, bytes)."""
    return {(tuple(b.shape), np.ascontiguousarray(b).tobytes()) for b in leaf_blocks}


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("kind", ["dense", "int8", "w8a8"])
def test_shard_params_place_the_jax_blocks_and_reassemble(kind, mesh_id):
    from gofr_tpu.parallel.mesh import make_mesh, mesh_shape_for
    from gofr_tpu.parallel.sharding import param_specs, shard_params

    shape = MESHES[mesh_id]
    n = int(np.prod(list(shape.values())))
    kw = {k: v for k, v in shape.items() if k != "dp"}
    tree = _jax_tree(kind)
    jplaced = shard_params(tree, make_mesh(mesh_shape_for(n, **kw), devices=jax.devices()[:n]))
    ttree = _torch_tree(tree)
    mesh = _mesh(shape)
    placed = ps.shard_params(ttree, mesh)
    specs = ps.param_specs(ttree)

    def walk(p, s, j, t):
        if isinstance(t, dict):
            for k in t:
                walk(p[k], s[k], j[k], t[k])
            return
        assert len(p) == n
        assert _blocks(b.numpy() for b in p) == _blocks(
            np.asarray(sh.data) for sh in j.addressable_shards)
        assert torch.equal(_unshard(p, s, mesh), t)

    walk(placed, specs, jplaced, ttree)
    assert specs.keys() == param_specs(tree).keys()


def test_int4_multigroup_scale_shards_with_weight():
    """A row-parallel int4 weight with several scale groups: the scale's
    group axis splits over tp with the weight's input axis, each shard
    dequantizes to the JAX shard's values, and the shards reassemble."""
    from gofr_tpu.models.quant import dequantize_array_int4 as jdeq
    from gofr_tpu.models.quant import quantize_array_int4 as jq4
    from gofr_tpu.parallel.mesh import make_mesh, mesh_shape_for
    from gofr_tpu.parallel.sharding import shard_params

    w = jax.random.normal(jax.random.key(0), (256, 64), jnp.float32)
    jtree = {"w_down": jq4(w, group=64)}  # 4 groups
    jplaced = shard_params(jtree, make_mesh(mesh_shape_for(2, tp=2), devices=jax.devices()[:2]))
    tree = {"w_down": quant.quantize_array_int4(to_torch(np.asarray(w)), group=64)}
    specs = ps.param_specs(tree)
    assert specs["w_down"]["scale"] == specs["w_down"]["q4"] == ("tp", "fsdp")
    mesh = _mesh({"tp": 2})
    placed = ps.shard_params(tree, mesh)
    want = {
        np.asarray(jdeq({"q4": q.data, "scale": s.data}, jnp.float32)).tobytes()
        for q, s in zip(jplaced["w_down"]["q4"].addressable_shards,
                        jplaced["w_down"]["scale"].addressable_shards)
    }
    got = {
        quant.dequantize_array_int4({"q4": q, "scale": s}, torch.float32).numpy().tobytes()
        for q, s in zip(placed["w_down"]["q4"], placed["w_down"]["scale"])
    }
    assert got == want and len(got) == 2
    whole = {k: _unshard(placed["w_down"][k], specs["w_down"][k], mesh) for k in ("q4", "scale")}
    np.testing.assert_array_equal(
        quant.dequantize_array_int4(whole, torch.float32).numpy(),
        np.asarray(jdeq(jtree["w_down"], jnp.float32)),
    )


def test_int4_row_split_off_a_group_boundary_raises():
    import dataclasses

    from gofr_tpu_torch.models.transformer import Transformer

    cfg = dataclasses.replace(TINY, n_heads=8, n_kv_heads=4)
    model = Transformer.random(cfg, "cpu", 0)
    # wo's 64 inputs as two groups of 32 cannot split over tp=4 (16 rows a shard)
    layer = model.layers[0]
    pack = quant.Pack(quant.quantize_array_int4(layer.wo, group=32))
    del layer.wo
    layer.wo = pack
    with pytest.raises(ValueError, match="wo: axis 0 of size 2 does not split over tp=4"):
        ShardedTransformer.from_model(model, _mesh({"tp": 4}))


# -- the sharded KV ---------------------------------------------------------------

def test_sharded_kv_rows_copies_and_shape():
    shards = [[torch.arange(2 * 4 * 3 * 1 * 2, dtype=torch.float32).reshape(2, 4, 3, 1, 2) + 100 * (g * 2 + t)
               for t in range(2)] for g in range(2)]
    kv = ps.ShardedKV([(g, shards[g]) for g in range(2)])
    assert kv.shape == (2, 8, 3, 2, 2) and kv.dtype == torch.float32
    row = kv[:, 5:6]
    assert row.groups[0][0] == 1 and row.shape == (2, 1, 3, 2, 2)
    assert torch.equal(row.groups[0][1][1], shards[1][1][:, 1:2])
    cross = kv[:, 3:6]
    assert [gid for gid, _ in cross.groups] == [0, 1] and cross.shape[1] == 3
    copy = row.clone()  # a clone owns its storage
    assert copy.groups[0][1][0].data_ptr() != row.groups[0][1][0].data_ptr()
    assert torch.equal(copy.groups[0][1][0], row.groups[0][1][0])
    kv[:, 0, :2].copy_(row[:, 0, :2])  # a row into another group's slot
    assert torch.equal(shards[0][1][:, 0, :2], shards[1][1][:, 1, :2])
    assert kv.view(torch.int32).dtype == torch.int32
    with pytest.raises(IndexError):
        kv[0]


# -- the reduce ----------------------------------------------------------------------

def _split_rows(w, tp):
    """A row-parallel weight's tp blocks, by its spec."""
    mesh = _mesh({"tp": tp})
    spec = ps.param_specs(w, "wo")
    tree = w.pack if isinstance(w, quant.Pack) else w
    blocks = ps.shard_params({"wo": tree}, mesh, {"wo": spec})["wo"]
    if isinstance(blocks, dict):
        return [quant.Pack({k: v[t] for k, v in blocks.items()}) for t in range(tp)]
    return blocks


@pytest.mark.parametrize("kind", ["dense", "int8", "int4", "w8a8", "lora"])
def test_row_parallel_reduce_equals_the_unsharded_product(kind):
    from gofr_tpu_torch.models.lora import LoraWeight

    g = torch.Generator().manual_seed(0)
    w = torch.randn(256, 48, generator=g)
    x = torch.randn(3, 5, 256, generator=g)
    if kind in ("int8", "int4", "w8a8"):
        w = quant.Pack(quant.quantizer_for(kind)(w))
    shards = _split_rows(w, 2)
    if kind == "lora":
        a, b = torch.randn(256, 4, generator=g), torch.randn(4, 48, generator=g)
        s = torch.full((1, 1), 0.5)
        w = LoraWeight(w, a, b, s)
        shards = [LoraWeight(sh, a[t * 128:(t + 1) * 128], b, s) for t, sh in enumerate(shards)]
    pairs = [(x[..., t * 128:(t + 1) * 128], shards[t]) for t in range(2)]
    got = quant.row_parallel_mm(pairs, x.device)
    want = quant.mm(x, w)
    if kind == "w8a8":
        # int32 partials under the row's whole-row scale: exact
        assert torch.equal(got, want)
        # a per-shard activation scale would show
        per_shard = sum(quant.mm(xs, ws) for xs, ws in pairs)
        assert not torch.equal(per_shard, want)
    else:
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL * float(want.abs().max()))


# -- the sharded model ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return jt.init_transformer(jax.random.PRNGKey(0), JAX_TINY)


@pytest.fixture(scope="module")
def model(jax_params):
    return transformer_from_tree(jax.tree.map(np.asarray, jax_params), TINY, device="cpu")


@pytest.fixture(scope="module", params=list(MESHES))
def sharded(request, model):
    return ShardedTransformer.from_model(model, _mesh(MESHES[request.param]))


def _tokens(seed, shape):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, TINY.vocab_size, shape).astype(np.int32))


def _prefilled(m, b=4, s=16):
    lengths = torch.tensor([16, 7, 12, 3][:b], dtype=torch.int32)
    cache = m.init_cache(b, 64)
    logits, cache = m.prefill(_tokens(1, (b, s)), cache, lengths)
    return logits, cache


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_prefill_matches_unsharded_and_jax(model, sharded, jax_params):
    toks = _tokens(1, (4, 16))
    lengths = torch.tensor([16, 7, 12, 3], dtype=torch.int32)
    want, _ = model.prefill(toks, model.init_cache(4, 64), lengths)
    got, cache = sharded.prefill(toks, sharded.init_cache(4, 64), lengths)
    _close(got, want)
    jlogits, _ = jt.prefill(jax_params, jnp.asarray(toks.numpy()), jt.init_cache(JAX_TINY, 4, 64),
                            JAX_TINY, jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert torch.equal(cache["lengths"], lengths)
    assert isinstance(cache["k"], ps.ShardedKV)


def test_decode_step_and_greedy_chunk(model, sharded):
    (want, wc), (got, gc) = _prefilled(model), _prefilled(sharded)
    first = torch.argmax(want, -1).to(torch.int32)[:, None]
    _close(sharded.decode_step(first, {k: v.clone() for k, v in gc.items()})[0],
           model.decode_step(first, {k: v.clone() for k, v in wc.items()})[0])
    w = model.decode_chunk_pool(first, wc, 8)
    g = sharded.decode_chunk_pool(first, gc, 8)
    assert torch.equal(g[0], w[0])
    _close(g[1], w[1])
    _close(g[2], w[2])
    assert torch.equal(g[-1]["lengths"], w[-1]["lengths"])


def test_penalized_chunk(model, sharded):
    (want, wc), (_, gc) = _prefilled(model), _prefilled(sharded)
    first = torch.argmax(want, -1).to(torch.int32)[:, None]

    def run(m, cache):
        presence = torch.zeros(4, TINY.vocab_size, dtype=torch.bool)
        counts = torch.zeros(4, TINY.vocab_size)
        bias = torch.zeros(4, TINY.vocab_size)
        return m.decode_chunk_pool_penalized(first, cache, 6, None, 0.0, 0, 1.0, 0.0, presence,
                                             1.3, counts, 0.5, 0.5, bias, all_greedy=True)

    w, g = run(model, wc), run(sharded, gc)
    assert torch.equal(g[0], w[0]) and torch.equal(g[-1], w[-1]) and torch.equal(g[-2], w[-2])


def test_verify_chunks(model, sharded):
    (_, wc), (_, gc) = _prefilled(model), _prefilled(sharded)
    toks = _tokens(2, (4, 5))
    w_ids, wc = model.verify_chunk(toks, wc)
    g_ids, gc = sharded.verify_chunk(toks, gc)
    assert torch.equal(g_ids, w_ids)
    q = torch.softmax(torch.randn(4, 4, TINY.vocab_size, generator=torch.Generator().manual_seed(3)),
                      -1)
    outs = []
    for m, cache in ((model, wc), (sharded, gc)):
        gen = torch.Generator().manual_seed(11)
        outs.append(m.verify_chunk_sampled(toks, cache, toks[:, 1:], q, gen, 0.8)[:2])
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_draft_chunk_sampled(model, sharded):
    (want, wc), (_, gc) = _prefilled(model), _prefilled(sharded)
    first = torch.argmax(want, -1).to(torch.int32)[:, None]
    outs = [m.draft_chunk_sampled(first, c, 3, torch.Generator().manual_seed(5), 0.7)
            for m, c in ((model, wc), (sharded, gc))]
    assert torch.equal(outs[0][0], outs[1][0])
    _close(outs[1][1], outs[0][1])


def test_score_tokens_and_forward(model, sharded):
    toks = _tokens(4, (4, 12))
    _close(sharded.score_tokens(toks), model.score_tokens(toks))
    _close(sharded.transformer_forward(toks), model.transformer_forward(toks))
    _close(sharded.score_tokens(toks[:1]), model.score_tokens(toks[:1]))  # one row: group 0


def test_row_of_a_batch_decodes_where_it_lives(model, sharded):
    """A [1]-row slice of a batch cache (the pool's admit, a solo decode)
    keeps its row group's devices and decodes as the unsharded row."""
    (want, wc), (_, gc) = _prefilled(model), _prefilled(sharded)
    first = torch.argmax(want, -1).to(torch.int32)[:, None]
    for i in (1, 3):
        wrow = {"k": wc["k"][:, i:i + 1].clone(), "v": wc["v"][:, i:i + 1].clone(),
                "lengths": wc["lengths"][i:i + 1].clone()}
        grow = {"k": gc["k"][:, i:i + 1].clone(), "v": gc["v"][:, i:i + 1].clone(),
                "lengths": gc["lengths"][i:i + 1].clone()}
        assert torch.equal(sharded.decode_chunk_pool(first[i:i + 1], grow, 6)[0],
                           model.decode_chunk_pool(first[i:i + 1], wrow, 6)[0])


def test_paged_scatter_gather_and_payload(model):
    """The tp = 2 arena: a row scattered into blocks and gathered back is
    the row; each block's wire payload is byte-equal to the unsharded
    arena's holding the same KV, and a tp = 1 arena ingests it into the
    same row (and a tp = 2 arena back)."""
    mesh = _mesh({"tp": 2})
    _, wc = _prefilled(model, b=1)
    half = TINY.n_kv_heads // 2
    rows = [{name: wc[name][:, 0:1] for name in ("k", "v")},
            {name: ps.ShardedKV([(0, [wc[name][:, 0:1, :, :half].clone(),
                                      wc[name][:, 0:1, :, half:].clone()])])
             for name in ("k", "v")}]
    arenas = [TorchKVArena(TINY, 9, 16, max_seq=64, device="cpu"),
              TorchKVArena(TINY, 9, 16, max_seq=64, mesh=mesh)]
    assert isinstance(arenas[1].k, ps.ShardedKV) and arenas[1].k.shape == arenas[0].k.shape
    table = BlockTable([3, 5, 1], 40)
    for arena, row in zip(arenas, rows):
        assert arena.scatter_row(row, table) == 3 * arena.block_bytes
        back = arena.gather_row(table, 40)
        for name in ("k", "v"):
            for dst, src in ps.kv_pairs(back[name], row[name]):
                assert torch.equal(dst[:, :, :48], src[:, :, :48])
    assert arenas[1].wire_spec() == arenas[0].wire_spec()
    payloads = [arenas[1].export_block_payload(table, j) for j in range(3)]
    assert payloads == [arenas[0].export_block_payload(table, j) for j in range(3)]
    fresh = TorchKVArena(TINY, 9, 16, max_seq=64, device="cpu")
    other = BlockTable([2, 4, 6], 40)
    for j, payload in enumerate(payloads):
        fresh.ingest_block_payload(other, j, payload)
    want = arenas[0].gather_row(table, 40)
    got = fresh.gather_row(other, 40)
    assert torch.equal(got["k"][:, :, :48], want["k"][:, :, :48])
    sharded_rx = TorchKVArena(TINY, 9, 16, max_seq=64, mesh=mesh)
    for j, payload in enumerate(payloads):
        sharded_rx.ingest_block_payload(other, j, payload)
    assert [sharded_rx.export_block_payload(other, j) for j in range(3)] == payloads


@pytest.mark.parametrize("mode", ["int8", "int4", "w8a8"])
def test_quantized_sharded_ids(jax_params, mode):
    """A pack is split after the whole weight is quantized: the tp = 2
    model's ids equal the unsharded packed model's (w8a8's logits
    exactly: its int32 partials reduce before the whole-row scale)."""
    from gofr_tpu.models.quant import quantize_params

    tree = jax.tree.map(np.asarray, quantize_params(jax_params, mode))
    qmodel = transformer_from_tree(tree, TINY, device="cpu")
    smodel = ShardedTransformer.from_model(qmodel, _mesh({"tp": 2}))
    (want, wc), (got, gc) = _prefilled(qmodel), _prefilled(smodel)
    if mode == "w8a8":
        assert torch.equal(got, want)
    else:
        _close(got, want)
    first = torch.argmax(want, -1).to(torch.int32)[:, None]
    assert torch.equal(smodel.decode_chunk_pool(first, gc, 8)[0],
                       qmodel.decode_chunk_pool(first, wc, 8)[0])


def test_lora_adapter_under_tp(model):
    """A solo adapter under tp = 2: A and B split by the LoRA leaf rule, the
    row-parallel delta joins the base's reduce."""
    from gofr_tpu_torch.models.lora import (
        add_lora,
        apply_adapter,
        export_adapter,
        wrapped_weights,
    )

    trained = add_lora(model, seed=3, rank=4)
    gen = torch.Generator().manual_seed(7)
    for _, _, w in wrapped_weights(trained):  # a trained adapter: B away from zero
        w.lora_b.data.normal_(0, 0.05, generator=gen)
    artifact = export_adapter(trained)
    plain = apply_adapter(model, artifact)
    sharded = apply_adapter(ShardedTransformer.from_model(model, _mesh({"tp": 2})), artifact)
    (want, wc), (got, gc) = _prefilled(plain), _prefilled(sharded)
    _close(got, want)
    first = torch.argmax(want, -1).to(torch.int32)[:, None]
    assert torch.equal(sharded.decode_chunk_pool(first, gc, 6)[0],
                       plain.decode_chunk_pool(first, wc, 6)[0])
