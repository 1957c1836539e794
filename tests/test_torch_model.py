"""gofr_tpu_torch.models against the JAX package: weights from
``init_transformer(jax.random.PRNGKey(0), TINY)`` cross through
``models/convert.py``, then the full forward, ragged bucketed prefill,
decode_step and greedy decode_chunk_pool are compared with the JAX functions,
whose attention runs both the XLA path and the Pallas kernel (interpret
mode). Greedy ids must match exactly; f32 logits within 1e-4 (two
frameworks sum the same f32 products in different orders over two layers).
The chunk-resume contract must hold bit-exactly inside torch.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import transformer as jt
from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu_torch.models.convert import to_torch, transformer_from_tree
from gofr_tpu_torch.models.llama import CONFIGS, TINY
from gofr_tpu_torch.models.transformer import Transformer
from gofr_tpu_torch.training import checkpoint

LOGIT_TOL = 1e-4
IMPLS = ["xla", "pallas"]


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_transformer(jax.random.PRNGKey(0), JAX_TINY)


@pytest.fixture(scope="module")
def model(jax_params):
    return transformer_from_tree(jax.tree.map(np.asarray, jax_params), TINY, device="cpu")


def _jcfg(impl):
    return dataclasses.replace(JAX_TINY, attn_impl=impl)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, TINY.vocab_size, shape).astype(np.int32)


def test_configs_match_the_jax_package():
    from gofr_tpu.models.llama import CONFIGS as JAX_CONFIGS

    assert set(CONFIGS) == set(JAX_CONFIGS)
    for name, cfg in CONFIGS.items():
        jcfg = JAX_CONFIGS[name]
        for field in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                      "hidden_dim", "max_seq", "rope_theta", "norm_eps"):
            assert getattr(cfg, field) == getattr(jcfg, field), (name, field)
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_logits_match_jax(jax_params, model, impl):
    toks = _tokens(0, (2, 12))
    want = np.asarray(jt.transformer_forward(jax_params, jnp.asarray(toks), _jcfg(impl)))
    got = model.transformer_forward(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_ragged_prefill_decode_step_and_chunk_match_jax(jax_params, model, impl):
    cfg = _jcfg(impl)
    toks = _tokens(1, (2, 16))  # one bucket; row 1 is padded past 7
    lengths = np.array([16, 7], np.int32)
    jcache = jt.init_cache(cfg, 2, 64)
    jlogits, jcache = jt.prefill(jax_params, jnp.asarray(toks), jcache, cfg, jnp.asarray(lengths))
    cache = model.init_cache(2, 64)
    logits, cache = model.prefill(torch.from_numpy(toks), cache, torch.from_numpy(lengths))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(
            cache[key].numpy(), np.asarray(jcache[key]), rtol=LOGIT_TOL, atol=LOGIT_TOL
        )

    first = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)[:, None]
    assert (logits.argmax(-1).numpy() == first[:, 0]).all()
    # one decode step
    jstep, jcache1 = jt.decode_step(jax_params, jnp.asarray(first), jcache, cfg)
    step_cache = {k: v.clone() for k, v in cache.items()}
    step, _ = model.decode_step(torch.from_numpy(first), step_cache)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # 8-step greedy chunk: ids exactly
    jids, _ = jt.decode_chunk(jax_params, jnp.asarray(first), jcache, cfg, 8, jax.random.key(0))
    out = model.decode_chunk_pool(torch.from_numpy(first), cache, 8)
    ids, cache = out[0], out[-1]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(cache["lengths"].numpy(), lengths + 8)


def test_chunk_resume_is_bit_exact(model):
    """Feeding a prompt in bucket-sized slices gives the same cache and final
    logits as one full-width call (transformer.py's chunk-resume contract)."""
    toks = torch.from_numpy(_tokens(2, (1, 32)))
    full_logits, full = model.prefill(toks, model.init_cache(1, 64))
    cache = model.init_cache(1, 64)
    _, cache = model.prefill(toks[:, :16], cache)
    logits, cache = model.prefill(toks[:, 16:], cache)
    assert torch.equal(logits, full_logits)
    assert torch.equal(cache["k"], full["k"]) and torch.equal(cache["v"], full["v"])
    assert torch.equal(cache["lengths"], full["lengths"])


def test_sampled_decode_chunk_is_seeded(model):
    first = torch.tensor([[5], [9]], dtype=torch.int32)
    prompt = torch.from_numpy(_tokens(3, (2, 8)))

    def run(seed):
        cache = model.init_cache(2, 64)
        _, cache = model.prefill(prompt, cache)
        gen = torch.Generator().manual_seed(seed)
        return model.decode_chunk_pool(first, cache, 6, gen, 0.9, 20, 0.95)[0]

    a, b = run(1), run(1)
    assert torch.equal(a, b)
    assert a.shape == (2, 6) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < TINY.vocab_size


def test_bf16_bits_cross_unchanged():
    x = jnp.asarray(np.linspace(-3, 3, 97, dtype=np.float32)).astype(jnp.bfloat16)
    t = to_torch(np.asarray(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(), np.asarray(x).view(np.int16)
    )
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x.astype(jnp.float32)))


def test_bf16_tree_converts_to_a_bf16_model():
    cfg = dataclasses.replace(JAX_TINY, dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jt.init_transformer(jax.random.PRNGKey(1), cfg))
    model = transformer_from_tree(params, dataclasses.replace(TINY, dtype=torch.bfloat16),
                                  device="cpu")
    assert model.layers[1].wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.layers[1].wq.view(torch.int16).numpy(), params["layers"]["wq"][1].view(np.int16)
    )


def test_quantized_tree_is_not_ported_yet():
    from gofr_tpu.models.quant import quantize_params

    params = jax.tree.map(
        np.asarray, quantize_params(jt.init_transformer(jax.random.PRNGKey(0), JAX_TINY), "int8")
    )
    model = transformer_from_tree(params, TINY, device="cpu")
    assert model.quant == "int8"
    # every pack of the JAX tree lands in the model as it is
    for i, block in enumerate(model.layers):
        for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            for name in ("q", "scale"):
                np.testing.assert_array_equal(getattr(getattr(block, key), name).numpy(),
                                              params["layers"][key][name][i], err_msg=key)
    np.testing.assert_array_equal(model.lm_head.scale.numpy(), params["lm_head"]["scale"])


@pytest.mark.parametrize("fn", [transformer_from_tree, Transformer.__init__,
                                checkpoint.restore_params, checkpoint.restore_train_state],
                         ids=["transformer_from_tree", "Transformer", "restore_params",
                              "restore_train_state"])
def test_entry_points_default_to_the_card(fn):
    # the port's entry points run on the card unless the caller asks for
    # the CPU, as the tests here do
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_random_init_is_seeded_and_truncated():
    a = Transformer.random(TINY, "cpu", seed=3)
    b = Transformer.random(TINY, "cpu", seed=3)
    c = Transformer.random(TINY, "cpu", seed=4)
    assert torch.equal(a.layers[0].w_up, b.layers[0].w_up)
    assert not torch.equal(a.layers[0].w_up, c.layers[0].w_up)
    w = a.layers[1].w_down
    assert float(w.abs().max()) <= 3 * w.shape[0] ** -0.5 + 1e-6
    # the std of N(0, 1) cut at +-3 is 0.9866
    assert abs(float(w.std()) * w.shape[0] ** 0.5 - 0.9866) < 0.03
    assert torch.equal(a.norm_f, torch.ones(TINY.dim))


def test_cache_bound_by_rope_table(model):
    with pytest.raises(ValueError, match="RoPE"):
        model.init_cache(1, TINY.max_seq + 1)
