"""gofr_tpu_torch's weight quantization (``models/quant.py``: int8, int4,
w8a8) and float8 KV cache against the JAX package on the CPU: the packs
bit-equal to ``gofr_tpu.models.quant``'s (q values and f32 scales), w8a8
``mm`` bit-equal, int8/int4 ``mm`` within ``tests/test_models.py``'s
tolerances, the w8a8 ``lm_head`` carve-out, quantize-during-init equal to
quantize-after, JAX quantized trees across ``models/convert.py`` bit for
bit, TINY forwards, the config errors, and the f8 KV deployment's greedy
ids equal to the JAX device's with ``MODEL_KV_DTYPE=f8``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import quant as jq
from gofr_tpu.models import transformer as jt
from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Logger
from gofr_tpu_torch.models import quant
from gofr_tpu_torch.models.convert import transformer_from_tree, tree_from_transformer
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.models.transformer import Transformer
from gofr_tpu_torch.tpu.device import TPUDevice

MODES = ("int8", "int4", "w8a8")
TOKENS = np.asarray([[5, 3, 8, 1, 9, 2]], np.int32)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jax_pack_np(pack: dict) -> dict:
    """A JAX pack as numpy, int4 values one a byte."""
    return {k: np.asarray(v).astype(np.int8) if k == "q4" else np.asarray(v)
            for k, v in pack.items()}


def _port_pack_np(pack: dict) -> dict:
    return {k: (quant.unpack_int4(v) if k == "q4" else v).numpy() for k, v in pack.items()}


def _assert_pack_equal(port: dict, jax_pack: dict) -> None:
    got, want = _port_pack_np(port), _jax_pack_np(jax_pack)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the packs ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(256, 32), (64, 48), (3, 384, 40)],
                         ids=["group-128", "group-clamped", "stacked"])
def test_packs_bit_equal_to_jax(mode, shape):
    w = _rand(1, shape, 0.05)
    w[..., 0, 0] = 0.0
    w[..., 1, :] *= 40.0  # a row that sets the scale of its column
    if len(shape) == 2:
        w[:, 3] = 0.0  # an all-zero column: the scale floor
    port = quant.quantizer_for(mode)(torch.from_numpy(w))
    want = jq.quantizer_for(mode)(jnp.asarray(w))
    _assert_pack_equal(port, want)
    back = quant.dequantize_pack(port, torch.float32).numpy()
    ref = np.asarray(jq.dequantize_params({"x": want}, jnp.float32)["x"])
    np.testing.assert_array_equal(back, ref)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_pack_of_bf16_weights_bit_equal(dtype):
    w = _rand(2, (128, 24), 0.05)
    port = quant.quantize_array(torch.from_numpy(w).to(getattr(torch, dtype)))
    want = jq.quantize_array(jnp.asarray(w).astype(getattr(jnp, dtype)))
    _assert_pack_equal(port, want)


def test_int4_packing_round_trips_every_value():
    q = torch.arange(-8, 8, dtype=torch.int8).repeat(4).reshape(8, 8)
    packed = quant.pack_int4(q)
    assert packed.dtype == torch.uint8 and packed.shape == (4, 8)
    assert torch.equal(quant.unpack_int4(packed), q)


def test_act_rows_bit_equal_to_jax():
    x = _rand(3, (4, 7, 64))
    x[0, 0] = 0.0
    qx, sx = quant.quantize_act_rows(torch.from_numpy(x))
    jqx, jsx = jq.quantize_act_rows(jnp.asarray(x))
    np.testing.assert_array_equal(qx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


# -- mm ------------------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [(3,), (2, 5)], ids=["2d", "3d"])
def test_w8a8_mm_bit_equal_to_jax(rows):
    w, x = _rand(4, (256, 40), 0.05), _rand(5, (*rows, 256))
    port = quant.mm(torch.from_numpy(x), quant.quantize_array_w8a8(torch.from_numpy(w)))
    want = jq.mm(jnp.asarray(x), jq.quantize_array_w8a8(jnp.asarray(w)))
    np.testing.assert_array_equal(port.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_weight_only_mm_matches_jax(mode):
    # tests/test_models.py: mm against the pack == x @ dequantized, 1e-4
    w, x = _rand(6, (256, 32), 0.05), _rand(7, (3, 256))
    port_pack = quant.quantizer_for(mode)(torch.from_numpy(w))
    jax_pack = jq.quantizer_for(mode)(jnp.asarray(w))
    got = quant.mm(torch.from_numpy(x), port_pack).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.mm(jnp.asarray(x), jax_pack)),
                               rtol=1e-4, atol=1e-4)
    back = quant.dequantize_pack(port_pack, torch.float32).numpy()
    np.testing.assert_allclose(got, x @ back, rtol=1e-4, atol=1e-4)


# bf16 activations and packs of bf16 weights, as the card serves them. int8
# and w8a8 keep the JAX order (exact int8 values in an f32-sum product, the
# scales on the f32 result), so they are bit-equal; int4 rounds q x scale to
# bf16 before its one product where JAX sums f32 partials per group: at most
# one bf16 step of the output apart (measured 2^-5 at |y| up to 9.4)
BF16_MM_ATOL = {"int8": 0.0, "int4": 2.0 ** -4, "w8a8": 0.0}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,n,rows", [(256, 40, (3,)), (1024, 96, (2, 5)), (4096, 64, (8,))],
                         ids=["small", "3d", "llama-width"])
def test_bf16_mm_matches_jax(mode, k, n, rows):
    w, x = _rand(6, (k, n), 0.05), _rand(7, (*rows, k))
    port_w, jax_w = torch.from_numpy(w).bfloat16(), jnp.asarray(w).astype(jnp.bfloat16)
    got = quant.mm(torch.from_numpy(x).bfloat16(), quant.quantizer_for(mode)(port_w))
    want = jq.mm(jnp.asarray(x).astype(jnp.bfloat16), jq.quantizer_for(mode)(jax_w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=BF16_MM_ATOL[mode])


def test_mm_takes_a_model_pack_and_refuses_unknown_keys():
    w, x = _rand(8, (64, 16), 0.05), torch.from_numpy(_rand(9, (2, 64)))
    pack = quant.quantize_array(torch.from_numpy(w))
    assert torch.equal(quant.mm(x, quant.Pack(pack)), quant.mm(x, pack))
    with pytest.raises(ValueError, match="unknown weight pack"):
        quant.mm(x, {"q5": pack["q"], "scale": pack["scale"]})


def test_quantization_error_matches_jax():
    w = _rand(10, (256, 64))
    assert quant.quantization_error(torch.from_numpy(w)) < 0.02
    assert quant.quantization_error(torch.from_numpy(w)) == pytest.approx(
        jq.quantization_error(jnp.asarray(w)), rel=1e-5)


# -- modes, keys and trees -------------------------------------------------------------

def test_quantizer_for_refuses_unknown_modes():
    with pytest.raises(ValueError, match="int8, int4, or w8a8"):
        quant.quantizer_for("fp4")
    assert quant.quantizer_for("") is None and quant.quantizer_for(None) is None
    assert quant.quantizer_for(True) is quant.quantize_array
    with pytest.raises(ValueError, match="int8, int4, or w8a8"):
        Transformer(TINY, "cpu", quant="bogus")


def test_w8a8_lm_head_carve_out():
    assert quant.quantizer_for_key("w8a8", "lm_head") is quant.quantize_array
    assert quant.quantizer_for_key("w8a8", "wq") is quant.quantize_array_w8a8
    assert quant.quantizer_for_key("int4", "lm_head") is quant.quantize_array_int4
    model = Transformer.random(TINY, "cpu", 0, quant="w8a8")
    assert model.lm_head.names == ("q", "scale")
    assert model.layers[0].wq.names == ("q8", "scale")


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_transformer(jax.random.PRNGKey(0), JAX_TINY)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_tree_bit_equal_to_jax(jax_params, mode):
    dense = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jax_params)
    port = quant.quantize_params(dense, mode)
    want = jq.quantize_params(jax_params, mode)
    assert quant.quantize_params(dense, "") is dense
    _assert_pack_equal(port["lm_head"], want["lm_head"])
    for key in ("wq", "w_down"):
        _assert_pack_equal(port["layers"][key], want["layers"][key])
    assert isinstance(port["embed"], torch.Tensor)  # embeddings stay dense
    back = quant.dequantize_params(port, torch.float32)
    np.testing.assert_array_equal(
        back["layers"]["wk"].numpy(),
        np.asarray(jq.dequantize_params(want, jnp.float32)["layers"]["wk"]))


def test_moe_blocks_stay_dense():
    tree = {"router": torch.zeros(4, 2), "w_gate": torch.ones(2, 4, 8), "wq": torch.ones(4, 4)}
    out = quant.quantize_params(tree, "int8")
    assert isinstance(out["w_gate"], torch.Tensor) and quant.is_quantized(out["wq"])


@pytest.mark.parametrize("mode", MODES)
def test_quantize_during_init_equals_quantize_after(mode):
    a = Transformer.random(TINY, "cpu", 3, quant=mode)
    b = Transformer.random(TINY, "cpu", 3).quantized(mode)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.weight_bytes() < Transformer.random(TINY, "cpu", 3).weight_bytes()


@pytest.mark.parametrize("mode", MODES)
def test_jax_quantized_tree_crosses_bit_for_bit(jax_params, mode):
    dense_tree = jax.tree.map(np.asarray, jax_params)
    quant_tree = jax.tree.map(np.asarray, jq.quantize_params(jax_params, mode))
    from_tree = transformer_from_tree(quant_tree, TINY, device="cpu")
    assert from_tree.quant == mode
    ported = quant.quantize_params(transformer_from_tree(dense_tree, TINY, device="cpu"), mode)
    sa, sb = from_tree.state_dict(), ported.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    # and back: the JAX tree's packs (int4 one value a byte)
    back = tree_from_transformer(from_tree)
    for key in ("wq", "w_up"):
        for name, arr in back["layers"][key].items():
            want = np.asarray(quant_tree["layers"][key][name])
            np.testing.assert_array_equal(arr, want.astype(np.int8) if name == "q4" else want)


def test_a_pack_where_the_model_holds_a_dense_weight_is_refused(jax_params):
    tree = jax.tree.map(np.asarray, jq.quantize_params(jax_params, "int8"))
    tree["layers"]["w_up"] = np.asarray(jax_params["layers"]["w_up"])
    with pytest.raises(ValueError, match="dense array where the model holds a pack"):
        transformer_from_tree(tree, TINY, device="cpu")


@pytest.mark.parametrize("mode,tol", [("int8", 1e-4), ("int4", 1e-4), ("w8a8", 2e-3)])
def test_tiny_forward_per_mode_matches_jax(jax_params, mode, tol):
    qparams = jq.quantize_params(jax_params, mode)
    want = np.asarray(jt.transformer_forward(qparams, jnp.asarray(TOKENS), JAX_TINY))
    model = transformer_from_tree(jax.tree.map(np.asarray, qparams), TINY, device="cpu")
    got = model(torch.from_numpy(TOKENS)).numpy()
    # w8a8 rounds the activations per token: an ulp apart in x can move a
    # value one quantum (tests/test_models.py holds quant vs dequant at 1e-3)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    deq = model.dequantized(torch.float32)(torch.from_numpy(TOKENS)).numpy()
    np.testing.assert_allclose(got, deq, rtol=1e-1 if mode == "w8a8" else 1e-3,
                               atol=1e-1 if mode == "w8a8" else 1e-3)


# TINY in bf16: the dense port differs from JAX by up to 2^-5 (measured, its
# own op order); int8 stays there, int4 adds its bf16 weight rounding
# (measured 0.043) and w8a8 its activation rounding (measured 0.083)
BF16_FORWARD_ATOL = {"": 2.0 ** -4, "int8": 2.0 ** -4, "int4": 2.0 ** -4, "w8a8": 2.0 ** -3}


@pytest.mark.parametrize("mode", ["", *MODES], ids=["bf16", *MODES])
def test_bf16_tiny_forward_per_mode_matches_jax(mode):
    jcfg = dataclasses.replace(JAX_TINY, dtype=jnp.bfloat16)
    params = jt.init_transformer(jax.random.PRNGKey(0), jcfg)
    qparams = jq.quantize_params(params, mode) if mode else params
    tokens = np.asarray([[5, 3, 8, 1, 9, 2, 7, 7, 4, 11]], np.int32)
    want = np.asarray(jt.transformer_forward(qparams, jnp.asarray(tokens), jcfg)
                      .astype(jnp.float32))
    model = transformer_from_tree(jax.tree.map(np.asarray, qparams),
                                  dataclasses.replace(TINY, dtype=torch.bfloat16), device="cpu")
    got = model(torch.from_numpy(tokens)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_FORWARD_ATOL[mode])


def test_trainer_refuses_a_quantized_model():
    from gofr_tpu_torch.training import optim, trainer

    model = Transformer.random(TINY, "cpu", 0, quant="int8")
    with pytest.raises(ValueError, match="cannot train a quantized model"):
        trainer.init_train_state_from(model, optim.adamw(1e-3))


# -- the device's keys -------------------------------------------------------------------

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


BASE = {"TORCH_DEVICE": "cpu", "MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "2",
        "BATCH_TIMEOUT_MS": "1", "DECODE_CHUNK": "4"}


def _port_device(model=None, **env):
    return _with_env({**BASE, **env},
                     lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(), model=model))


@pytest.mark.parametrize("key,value", [("MODEL_QUANT", "bogus"), ("MODEL_KV_DTYPE", "int4"),
                                       ("DECODE_POOL_PENALTIES", "sometimes")])
def test_bad_keys_fail_at_construction(key, value):
    # tests/test_tpu.py:711 and :782 hold the JAX device to the same
    with pytest.raises(ValueError, match=key if key != "MODEL_QUANT" else "int8, int4, or w8a8"):
        _port_device(**{key: value})


def test_a_given_model_must_match_model_quant():
    model = Transformer.random(TINY, "cpu", 0)
    with pytest.raises(ValueError, match="MODEL_QUANT"):
        _port_device(model=model, MODEL_QUANT="int8")


@pytest.mark.parametrize("mode", MODES)
def test_quantized_device_serves_jax_greedy_ids(jax_params, mode):
    jax_tree = jq.quantize_params(jax_params, mode)
    model = transformer_from_tree(jax.tree.map(np.asarray, jax_tree), TINY, device="cpu")
    cache = jt.init_cache(JAX_TINY, 1, JAX_TINY.max_seq)
    logits, cache = jt.prefill(jax_tree, jnp.asarray(TOKENS), cache, JAX_TINY)
    want = []
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for _ in range(8):
        want.append(int(tok[0, 0]))
        logits, cache = jt.decode_step(jax_tree, tok, cache, JAX_TINY)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for pool in ("on", "off"):
        dev = _port_device(model=model, MODEL_QUANT=mode, DECODE_POOL=pool)
        try:
            assert dev.generate(TOKENS[0].tolist(), 8) == want, pool
        finally:
            dev.close()


def test_quantized_boot_draws_packs():
    dev = _port_device(MODEL_QUANT="int4", DECODE_POOL="off")
    try:
        assert dev.runner.model.quant == "int4"
        assert dev.runner.model.layers[0].w_up.names == ("q4", "scale")
        assert len(dev.generate([1, 2, 3], 4)) == 4
        assert "quant=int4" in dev.describe()
    finally:
        dev.close()


# -- float8 KV ---------------------------------------------------------------------------

def test_float8_conversion_agrees_with_jax_up_to_464():
    # both round to nearest even; 464 ties to 448. Above 464 they part:
    # ml_dtypes gives NaN, torch saturates to 448 (so the cache's values
    # here stay far below it)
    grid = np.asarray([-464, -460, -448, -447, -1e-9, 0, 0.5, 1.5, 2.5, 3.3, 17.0, 447,
                       448, 449, 456, 463.9, 464], np.float32)
    got = torch.from_numpy(grid).to(torch.float8_e4m3fn).float().numpy()
    want = np.asarray(jnp.asarray(grid).astype(jnp.float8_e4m3fn).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    above = torch.tensor([500.0, -1000.0]).to(torch.float8_e4m3fn).float()
    assert above.tolist() == [448.0, -448.0]
    assert np.isnan(np.asarray(jnp.asarray([500.0]).astype(jnp.float8_e4m3fn),
                               np.float32)).all()


F8_ENV = {"MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "4", "BATCH_TIMEOUT_MS": "2",
          "DECODE_SLOTS": "4", "DECODE_CHUNK": "4", "MODEL_BUCKETS": "16,32",
          "PREFIX_CACHE": "4", "PREFIX_LCP_MIN": "4", "KV_BLOCK_TOKENS": "16",
          "MODEL_KV_DTYPE": "f8"}


@pytest.fixture(scope="module")
def f8_pair():
    """(JAX device, port device) with MODEL_KV_DTYPE=f8 on the same weights."""
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level
    from gofr_tpu.metrics import Registry
    from gofr_tpu.testutil import MockLogger
    from gofr_tpu.tpu.device import new_device

    def build():
        dev = new_device(EnvConfig(), MockLogger(Level.ERROR), Registry())
        dev.wait_ready(600)
        return dev

    jdev = _with_env(F8_ENV, build)
    model = transformer_from_tree(jax.tree.map(np.asarray, jdev.runner.params), TINY,
                                  device="cpu")
    tdev = _with_env({**F8_ENV, "TORCH_DEVICE": "cpu"},
                     lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(), model=model))
    yield jdev, tdev
    tdev.close()
    jdev.close()


def test_f8_caches_are_e4m3(f8_pair):
    _, dev = f8_pair
    f8 = torch.float8_e4m3fn
    assert dev.runner.cache_dtype == f8
    assert dev.decode_pool.cache["k"].dtype == f8 and dev.decode_pool.cache["v"].dtype == f8
    arena = dev.runner._paged_prefix.arena
    assert arena.k.dtype == f8 and arena.v.dtype == f8
    state = dev.runner.run_batch([np.asarray([1, 2, 3], np.int32)])[0]
    assert state["cache"]["k"].dtype == f8
    # the model itself keeps its dtype: only the deployment's caches change
    assert dev.runner.model.cfg.dtype == torch.float32
    assert "kv_dtype=float8_e4m3fn" in dev.describe()


def test_f8_greedy_ids_equal_jax_and_survive_a_prefix_hit(f8_pair):
    jdev, tdev = f8_pair
    prompts = [[7, 3, 9, 2, 11, 5, 8, 1, 4], [7, 3, 9, 2, 11, 5, 8, 1, 6, 6, 2], [1, 2, 3]]
    for p in prompts:
        want = jdev.generate(p, max_new_tokens=10)
        assert tdev.generate(p, 10) == want, p
    hits = dict(tdev.runner.prefix_stats)
    # an exact repeat and a shared-prefix request: served from the f8 arena
    assert tdev.generate(prompts[0], 10) == jdev.generate(prompts[0], max_new_tokens=10)
    longer = prompts[0] + [12, 13, 14, 15, 16, 17]
    assert tdev.generate(longer, 10) == jdev.generate(longer, max_new_tokens=10)
    after = tdev.runner.prefix_stats
    assert after["hits"] + after["partial_hits"] > hits["hits"] + hits["partial_hits"]


def test_f8_solo_equals_pooled(f8_pair):
    _, tdev = f8_pair
    solo = _port_device(model=tdev.runner.model, DECODE_POOL="off", MODEL_KV_DTYPE="f8")
    try:
        assert solo.runner.model.cfg == dataclasses.replace(TINY)
        for p in ([4, 4, 2, 9], [30, 31, 32, 33, 34]):
            assert solo.generate(p, 9) == tdev.generate(p, 9)
    finally:
        solo.close()
