"""Multi-device serving on the port (``TPU_MESH``) held to the JAX
package's unsharded path on the CPU, at the tiny model: the 15 cases of
``tests/test_tpu_sharded.py`` (which the JAX package marks slow for its XLA
compiles; the port compiles nothing), then the acceptance grid: greedy ids
at tp = 2, tp = 2 x dp = 2 and dp = 2 equal the port's unsharded ids and
the JAX package's, exactly, on the pooled, solo, prefix-hit and
chunked-prefill paths, dense and under int8, int4 and w8a8. Adapters under
a mesh, the degrade counters, and a tp = 2 donor's KV crossing to an
unsharded receiver complete it. The JAX weights cross to the port through
``models/convert.py``; ``infer`` logits within 1e-4 (two frameworks, as
``tests/test_torch_model.py``).
"""

import os
import time

import jax
import numpy as np
import pytest

from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.errors import InvalidParamError
from gofr_tpu_torch.logging import Level
from gofr_tpu_torch.metrics import Registry
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.ops.sampling import Sampler
from gofr_tpu_torch.parallel.mesh import visible_devices
from gofr_tpu_torch.parallel.serving import ShardedTransformer
from gofr_tpu_torch.testutil import MockLogger
from gofr_tpu_torch.tpu.device import TPUDevice, _mesh_from_topology

PROMPT = {"tokens": [3, 1, 4, 1, 5, 9, 2, 6]}
IDS = PROMPT["tokens"]
LONG = [(5 * i) % 240 + 3 for i in range(40)]
PEN = dict(presence_penalty=2.0, frequency_penalty=2.0)
BASE = {"MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "4", "BATCH_TIMEOUT_MS": "1"}


def _with_env(env, fn):
    from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS

    keys = set(DECLARED_KEYS) | set(JAX_KEYS) | set(env)
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


def _jax(**env):
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level as JaxLevel
    from gofr_tpu.metrics import Registry as JaxRegistry
    from gofr_tpu.testutil import MockLogger as JaxLogger
    from gofr_tpu.tpu.device import new_device

    dev = _with_env({**BASE, **env},
                    lambda: new_device(EnvConfig(), JaxLogger(JaxLevel.ERROR), JaxRegistry()))
    dev.wait_ready(600)
    return dev


def _port(model=None, **env):
    return _with_env({**BASE, "TORCH_DEVICE": "cpu", **env},
                     lambda: TPUDevice(EnvFileConfig("/nonexistent"), MockLogger(Level.INFO),
                                       model=model, metrics=Registry()))


def _weights(jdev):
    return transformer_from_tree(jax.tree.map(np.asarray, jdev.runner.params), TINY,
                                 device="cpu")


@pytest.fixture(scope="module")
def jplain():
    d = _jax(TPU_MESH="")
    yield d
    d.close()


@pytest.fixture(scope="module")
def model(jplain):
    return _weights(jplain)


@pytest.fixture(scope="module")
def sharded(model):
    d = _port(model, TPU_MESH="tp=2")
    yield d
    d.close()


def _jax_sampler(**kw):
    from gofr_tpu.ops.sampling import Sampler as JaxSampler

    return JaxSampler(**kw)


# -- tests/test_tpu_sharded.py --------------------------------------------------------

def test_topology_parsing():
    devs = visible_devices("cpu")
    mesh = _mesh_from_topology("tp=2,dp=2", devs)
    assert mesh.shape["tp"] == 2 and mesh.shape["dp"] == 2
    assert _mesh_from_topology("", devs) is None
    assert _mesh_from_topology("1x1", devs) is None
    with pytest.raises(ValueError, match="needs"):
        _mesh_from_topology("tp=64", devs)
    with pytest.raises(ValueError, match="not supported"):
        _mesh_from_topology("pp=2", devs)


def test_params_actually_sharded(sharded):
    m = sharded.runner.model
    assert isinstance(m, ShardedTransformer) and m.mesh is sharded.mesh
    wq = [store.layers[0].wq for store in m.stores]
    assert len(wq) == 2 and all(w.shape == (TINY.dim, TINY.dim // 2) for w in wq)
    assert "mesh" in sharded.describe()


def test_int4_multigroup_scale_shards_with_weight(model):
    """Int4 packs of several scale groups (tiny's dims clamp the default
    group to one): the tp = 2 device serves the unsharded device's ids."""
    from gofr_tpu_torch.models import quant

    q4 = model.quantized("int4")
    for layer in q4.layers:
        for name in ("wo", "w_down"):
            pack = quant.Pack(quant.quantize_array_int4(
                quant.dequantize_pack(getattr(layer, name).pack, TINY.dtype), group=32))
            delattr(layer, name)
            setattr(layer, name, pack)
    assert q4.layers[0].w_down.scale.shape[0] == 4  # 128 inputs, groups of 32
    plain, meshed = _port(q4, MODEL_QUANT="int4"), _port(q4, MODEL_QUANT="int4", TPU_MESH="tp=2")
    try:
        stores = meshed.runner.model.stores
        assert [s.layers[0].w_down.scale.shape[0] for s in stores] == [2, 2]
        assert meshed.generate(IDS, 8) == plain.generate(IDS, 8)
    finally:
        plain.close()
        meshed.close()


def test_int4_sharded_matches_plain():
    jdev = _jax(MODEL_QUANT="int4", TPU_MESH="")
    try:
        want = jdev.generate(IDS, max_new_tokens=8)
        from gofr_tpu_torch.models.convert import tree_quant_mode

        params = jax.tree.map(np.asarray, jdev.runner.params)
        assert tree_quant_mode(params) == "int4"
        d = _port(transformer_from_tree(params, TINY, device="cpu"), MODEL_QUANT="int4",
                  TPU_MESH="tp=2")
        try:
            assert d.generate(IDS, 8) == want
        finally:
            d.close()
    finally:
        jdev.close()


def test_sharded_infer_matches_plain(jplain, sharded):
    a = jplain.infer(PROMPT)
    b = sharded.infer(PROMPT)
    np.testing.assert_allclose(np.asarray(b["logits"]), np.asarray(a["logits"]),
                               rtol=1e-4, atol=1e-4)


def test_sharded_generate_matches_plain(jplain, sharded):
    assert sharded.generate(IDS, 8) == jplain.generate(IDS, max_new_tokens=8)


def test_dp_tp_mesh_infer(jplain, model):
    d = _port(model, TPU_MESH="tp=2,dp=2")
    try:
        out = d.infer(PROMPT)
        assert np.isfinite(np.asarray(out["logits"])).all()
        np.testing.assert_allclose(np.asarray(out["logits"]),
                                   np.asarray(jplain.infer(PROMPT)["logits"]), rtol=1e-4, atol=1e-4)
        assert d.health_check()["status"] == "UP"
    finally:
        d.close()


def test_pool_active_under_mesh(sharded):
    assert sharded.decode_pool is not None


def test_pooled_sharded_matches_solo_sharded(jplain, model, sharded):
    solo = _port(model, TPU_MESH="tp=2", DECODE_POOL="off")
    try:
        assert solo.decode_pool is None
        a = solo.generate(IDS, 8)
    finally:
        solo.close()
    assert sharded.generate(IDS, 8) == a == jplain.generate(IDS, max_new_tokens=8)


def test_pooled_generate_under_dp_mesh(jplain, model):
    d = _port(model, TPU_MESH="tp=2,dp=2", DECODE_SLOTS="4")
    try:
        assert d.decode_pool is not None  # 4 slots over dp*fsdp=2
        assert d.decode_pool.occupancy()["mesh_axes"] == {"tp": 2, "dp": 2}
        out = d.generate(IDS, 6)
        assert out == jplain.generate(IDS, max_new_tokens=6)
    finally:
        d.close()


def test_pool_disabled_on_indivisible_slots(model):
    d = _port(model, TPU_MESH="tp=2,dp=4", DECODE_SLOTS="3")
    try:
        assert d.decode_pool is None  # 3 slots can't shard over dp=4
        assert d._mesh_degrade.value(feature="decode_pool") == 1
    finally:
        d.close()


def test_kv_head_divisibility_enforced():
    with pytest.raises(ValueError, match="n_kv_heads"):
        _port(TPU_MESH="tp=4")  # tiny has 2 kv heads


def test_batch_divisibility_enforced():
    with pytest.raises(ValueError, match="BATCH_MAX_SIZE"):
        _port(BATCH_MAX_SIZE="2", TPU_MESH="dp=4")


def test_penalized_pool_under_tp_mesh(jplain, model):
    solo = _port(model, BATCH_MAX_SIZE="2", TPU_MESH="tp=2", DECODE_POOL="off")
    try:
        want = solo.generate(IDS, 8, sampler=Sampler(**PEN))
    finally:
        solo.close()
    assert want == jplain.generate(IDS, max_new_tokens=8, sampler=_jax_sampler(**PEN))
    pooled = _port(model, BATCH_MAX_SIZE="2", TPU_MESH="tp=2", DECODE_POOL_PENALTIES="eager")
    try:
        assert pooled.generate(IDS, 8, sampler=Sampler(**PEN)) == want
        toks, lps, tops = pooled.generate(IDS, 4, logprobs=True, top_logprobs=True,
                                          sampler=Sampler(**PEN))
        assert len(toks) == len(lps) == len(tops) == 4
    finally:
        pooled.close()


def test_penalized_pool_lazy_under_dp_mesh(jplain, model):
    """The lazy penalty build under a dp mesh: plain traffic first, then a
    penalized request (solo, it starts the build), then one that pools."""
    d = _port(model, TPU_MESH="dp=2", DECODE_SLOTS="4")
    try:
        plain = d.generate(IDS, 8)
        first = d.generate(IDS, 8, sampler=Sampler(**PEN))
        deadline = time.monotonic() + 60
        while not d.decode_pool._pen_ready and time.monotonic() < deadline:
            time.sleep(0.05)
        assert d.decode_pool._pen_ready
        assert d.generate(IDS, 8, sampler=Sampler(**PEN)) == first
        assert d.generate(IDS, 8) == plain == jplain.generate(IDS, max_new_tokens=8)
        assert first == jplain.generate(IDS, max_new_tokens=8, sampler=_jax_sampler(**PEN))
    finally:
        d.close()


# -- the acceptance grid --------------------------------------------------------------

@pytest.fixture(scope="module", params=["dense", "int8", "int4", "w8a8"])
def quant_pair(request):
    """(quant env, JAX unsharded device, the port weights) of one mode."""
    env = {} if request.param == "dense" else {"MODEL_QUANT": request.param}
    jdev = _jax(TPU_MESH="", MODEL_BUCKETS="16,32", PREFIX_CACHE="2", DECODE_SLOTS="4", **env)
    yield env, jdev, _weights(jdev)
    jdev.close()


@pytest.mark.parametrize("mesh", ["tp=2", "tp=2,dp=2", "dp=2"])
def test_ids_equal_unsharded_and_jax(quant_pair, mesh):
    env, jdev, weights = quant_pair
    cfg = dict(env, MODEL_BUCKETS="16,32", PREFIX_CACHE="2", DECODE_SLOTS="4",
               PREFILL_CHUNK_TOKENS="16")
    plain, meshed = _port(weights, **cfg), _port(weights, TPU_MESH=mesh, **cfg)
    try:
        def both(prompt, **kw):
            a, b = plain.generate(prompt, 8, **kw), meshed.generate(prompt, 8, **kw)
            assert a == b, (mesh, prompt, a, b)
            return b

        assert both(IDS) == jdev.generate(IDS, max_new_tokens=8)  # pooled
        want = jdev.generate(IDS, max_new_tokens=8, sampler=_jax_sampler(seed=7))
        assert both(IDS, sampler=Sampler(seed=7)) == want  # solo
        prompt = [11, 13, 17, 19, 23, 29, 31, 37]
        first = both(prompt)
        hits = meshed.runner.prefix_stats["hits"]
        assert both(prompt) == first == jdev.generate(prompt, max_new_tokens=8)  # prefix hit
        assert meshed.runner.prefix_stats["hits"] == hits + 1
        # past PREFILL_CHUNK_TOKENS: sliced under tp, whole under dp (degraded)
        assert both(LONG) == jdev.generate(LONG, max_new_tokens=8)
        rows_split = "dp" in mesh
        assert (meshed.runner.prefill_chunk_bucket is None) == rows_split
        assert meshed._mesh_degrade.value(feature="chunked_prefill") == int(rows_split)
        assert meshed._mesh_degrade.value(feature="kv_paged") == int(rows_split)
    finally:
        plain.close()
        meshed.close()


# -- adapters under a mesh ------------------------------------------------------------

@pytest.fixture(scope="module")
def adapter_dir(model, tmp_path_factory):
    import torch

    from gofr_tpu_torch.models.lora import add_lora, export_adapter, wrapped_weights
    from gofr_tpu_torch.training.checkpoint import save_params

    trained = add_lora(model, seed=3, rank=4)
    gen = torch.Generator().manual_seed(7)
    for _, _, w in wrapped_weights(trained):
        w.lora_b.data.normal_(0, 0.05, generator=gen)
    path = str(tmp_path_factory.mktemp("adapter") / "calm")
    save_params(path, export_adapter(trained))
    return path


def test_adapters_decode_solo_under_tp_and_count_the_pool_degrade(model, adapter_dir):
    plain = _port(model, LORA_ADAPTERS=f"calm={adapter_dir}")
    meshed = _port(model, TPU_MESH="tp=2", LORA_ADAPTERS=f"calm={adapter_dir}")
    try:
        assert meshed._mesh_degrade.value(feature="pooled_lora") == 1
        assert plain._mesh_degrade.value(feature="pooled_lora") == 0
        want = plain.generate(IDS, 8, adapter="calm")
        assert want != plain.generate(IDS, 8)  # the adapter moves the ids
        assert meshed.generate(IDS, 8, adapter="calm") == want
        meshed.load_adapter("wild", adapter_dir)
        assert meshed._mesh_degrade.value(feature="pooled_lora") == 2
        assert meshed.generate(IDS, 8, adapter="wild") == want
    finally:
        plain.close()
        meshed.close()


def test_adapters_refuse_a_dp_mesh(model, adapter_dir):
    with pytest.raises(ValueError, match="tp-only TPU_MESH"):
        _port(model, TPU_MESH="dp=2", LORA_ADAPTERS=f"calm={adapter_dir}")
    d = _port(model, TPU_MESH="dp=2")
    try:
        with pytest.raises(InvalidParamError, match="tp-only TPU_MESH"):
            d.load_adapter("calm", adapter_dir)
    finally:
        d.close()


# -- cross-replica KV from a sharded donor --------------------------------------------

def _export(dev, prompt):
    from gofr_tpu_torch.fleet.kvwire import prompt_hash

    spec, table, arena, pin = dev.kv_export(prompt_hash(prompt))
    payloads = [arena.export_block_payload(table, j) for j in range(spec["n_blocks"])]
    pin.release()
    return spec, payloads


@pytest.mark.parametrize("donor_mesh,recv_mesh", [("tp=2", ""), ("", "tp=2")])
def test_kv_payload_crosses_between_a_sharded_and_an_unsharded_replica(model, jplain, donor_mesh,
                                                                       recv_mesh):
    """A tp = 2 donor's prefix entry has the unsharded donor's spec and
    layout (heads in order; f32 bytes within 2e-5: the row-parallel sums
    round differently), and the other replica installs it and serves the
    prompt from it: a prefix hit with the JAX package's ids."""
    from gofr_tpu_torch.fleet import kvwire

    env = dict(MODEL_BUCKETS="16,32,64", PREFIX_CACHE="4", KV_BLOCK_TOKENS="16")
    donor = _port(model, TPU_MESH=donor_mesh, **env)
    plain_donor = _port(model, **env)
    receiver = _port(model, TPU_MESH=recv_mesh, **env)
    try:
        prompt = [(7 * i + 5) % 250 + 1 for i in range(37)]
        want = jplain.generate(prompt, max_new_tokens=8)
        assert donor.generate(prompt, 8) == plain_donor.generate(prompt, 8) == want
        spec, payloads = _export(donor, prompt)
        pspec, ppay = _export(plain_donor, prompt)
        assert {k: v for k, v in spec.items() if k != "meta"} == \
            {k: v for k, v in pspec.items() if k != "meta"}
        for a, b in zip(payloads, ppay):
            np.testing.assert_allclose(np.frombuffer(a, np.float32), np.frombuffer(b, np.float32),
                                       atol=2e-5, rtol=0)
        store = receiver._kv_store()
        kvwire.check_spec(spec, store.arena.wire_spec())
        hits = receiver.runner.prefix_stats["hits"]
        assert store.install_remote(np.asarray(prompt, np.int32), payloads, spec["meta"]) is True
        assert receiver.generate(prompt, 8) == want
        assert receiver.runner.prefix_stats["hits"] == hits + 1
    finally:
        donor.close()
        plain_donor.close()
        receiver.close()
