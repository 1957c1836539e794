"""The MoE decoder (``gofr_tpu_torch/models/moe.py``) against the JAX
package's ``gofr_tpu/models/moe.py`` on the CPU.

The config is ``tests/test_moe.py``'s (f32, vocab 89, dim 16, 2 layers, 4
heads, 2 KV heads, hidden 32, 4 experts, top-2); JAX initialises and the
weights cross through ``models/convert.py::moe_from_tree``. Tolerances: the
dense forward's logits 1e-5 and its aux losses 1e-6, the chosen expert ids
and the dispatch slots exactly, the combine weights 1e-6; int8 at
``test_torch_quant.py``'s 1e-4; a bf16 model at the bf16 tolerance 2e-2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from gofr_tpu.models import moe as jm
from gofr_tpu.models import quant as jq
from gofr_tpu.models import transformer as jt
from gofr_tpu_torch.models import moe
from gofr_tpu_torch.models.convert import (
    moe_from_tree,
    transformer_from_tree,
    tree_from_transformer,
)
from gofr_tpu_torch.models.quant import Pack, mm, quantize_params
from gofr_tpu_torch.models.transformer import Transformer, TransformerConfig

JCFG = jm.MoEConfig(vocab_size=89, dim=16, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=32,
                    max_seq=64, n_experts=4, top_k=2, capacity_factor=2.0,
                    dtype=jnp.float32, attn_impl="xla")
CFG = moe.MoEConfig(vocab_size=89, dim=16, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=32,
                    max_seq=64, n_experts=4, top_k=2, capacity_factor=2.0, dtype=torch.float32)


@functools.lru_cache(maxsize=1)
def tree():
    return jax.tree.map(np.asarray, jm.init_moe(jax.random.key(0), JCFG))


def tokens() -> np.ndarray:
    return np.asarray(jax.random.randint(jax.random.key(1), (8, 12), 0, CFG.vocab_size))


def model(cfg=CFG):
    return moe_from_tree(tree(), cfg, device="cpu")


def test_the_config_and_the_model_carry_the_jax_shapes():
    # every field the port has holds the JAX default (the port has no
    # attn_impl or kv_dtype: its kernels and the deployment's cache decide)
    names = [f.name for f in dataclasses.fields(moe.MoEConfig) if f.name != "dtype"]
    assert {"n_experts", "top_k", "capacity_factor", "aux_weight", "z_weight"} <= set(names)
    assert ({n: getattr(moe.MoEConfig(), n) for n in names}
            == {n: getattr(jm.MoEConfig(), n) for n in names})
    m = model()
    layer = m.layers[0]
    assert layer.router.dtype == torch.float32 and tuple(layer.router.shape) == (16, 4)
    assert tuple(layer.w_gate.shape) == (4, 16, 32) and tuple(layer.w_down.shape) == (4, 32, 16)
    back = tree_from_transformer(m)
    for name, want in tree()["layers"].items():
        np.testing.assert_array_equal(back["layers"][name], want)


def test_random_draws_the_router_in_the_model_dtype_and_holds_it_in_f32():
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    m = moe.MoETransformer.random(cfg, "cpu", seed=3)
    r = m.layers[1].router
    assert r.dtype == torch.float32
    assert torch.equal(r, r.to(torch.bfloat16).float())
    assert m.layers[0].w_down.dtype == torch.bfloat16
    # fan-in: each stack's input axis (D for w_gate, F for w_down)
    assert float(m.layers[0].w_gate.float().abs().max()) <= 3 * 16 ** -0.5 + 1e-3
    assert float(m.layers[0].w_down.float().abs().max()) <= 3 * 32 ** -0.5 + 1e-3


def _layer_tree(i: int) -> dict:
    return jax.tree.map(lambda a: jnp.asarray(a[i]), tree()["layers"])


def test_dense_forward_matches_jax_and_picks_the_same_experts():
    toks = tokens()
    want, want_aux = jm.moe_forward(jax.tree.map(jnp.asarray, tree()), jnp.asarray(toks), JCFG)
    # the JAX layers one at a time, eagerly, recording each layer's choice
    jax_ids = []

    def jax_record(p, x, cfg):
        b, s, d = x.shape
        logits = jnp.einsum("td,de->te", x.reshape(b * s, d).astype(jnp.float32), p["router"])
        jax_ids.append(np.asarray(jm._route_top_k(logits, cfg.top_k)[1]))
        return jm._moe_mlp_dense(p, x, cfg)

    params = jax.tree.map(jnp.asarray, tree())
    freqs = jnp.asarray(jt._cached_freqs(JCFG.head_dim, JCFG.max_seq, JCFG.rope_theta))
    x = params["embed"][jnp.asarray(toks)]
    for i in range(JCFG.n_layers):
        x, _ = jm.moe_block(JCFG, _layer_tree(i), x, freqs, jnp.arange(12), jax_record)
    ids = []

    def record(layer, h, cfg):
        b, s, d = h.shape
        ids.append(moe._route_top_k(moe._router_logits(layer, h.reshape(b * s, d)),
                                    cfg.top_k)[1].numpy())
        return moe._moe_mlp_dense(layer, h, cfg)

    with torch.no_grad():
        got, aux = moe.moe_forward(model(), torch.from_numpy(toks), moe_mlp=record)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), rtol=1e-6, atol=1e-6)
    assert float(aux["load_balance"]) >= 0.99
    assert len(ids) == len(jax_ids) == JCFG.n_layers
    for mine, theirs in zip(ids, jax_ids):
        np.testing.assert_array_equal(mine, theirs)


def test_dense_loss_matches_jax():
    toks = tokens()
    want = float(jm.moe_loss(jax.tree.map(jnp.asarray, tree()), jnp.asarray(toks), JCFG))
    with torch.no_grad():
        got = float(moe.moe_loss(model(), torch.from_numpy(toks)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_remat_gives_the_same_loss_and_gradients():
    toks = torch.from_numpy(tokens())
    runs = []
    for remat in (False, True):
        m = model()
        for p in m.parameters():
            p.requires_grad_(True)
        loss = moe.moe_loss(m, toks, remat=remat)
        loss.backward()
        runs.append((float(loss), [p.grad.clone() for p in m.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


ROUTE_T = 12


def _router_logits() -> np.ndarray:
    return np.random.default_rng(7).standard_normal((ROUTE_T, 4)).astype(np.float32)


def test_route_top_k_matches_jax():
    logits = _router_logits()
    vals, idx, aux = jm._route_top_k(jnp.asarray(logits), 2)
    g_vals, g_idx, g_aux = moe._route_top_k(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(g_vals.numpy(), np.asarray(vals), rtol=1e-6, atol=1e-6)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(g_aux[k]), float(aux[k]), rtol=1e-6, atol=1e-6)


def test_route_top_k_orders_a_tie_as_lax_top_k():
    logits = np.asarray([[0.5, 1.0, 1.0, 0.2], [2.0, 2.0, 2.0, 2.0]], np.float32)
    _, idx, _ = jm._route_top_k(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(moe._route_top_k(torch.from_numpy(logits), 2)[1].numpy(),
                                  np.asarray(idx))


@pytest.mark.parametrize("capacity", range(1, ROUTE_T + 1))
def test_routing_slots_match_jax_at_every_capacity(capacity):
    """Dispatch bit for bit and combine within 1e-6 from C = 1 (most
    assignments dropped) to C = T (none can drop): the port's slot of a
    token past C is a zero row, as ``jax.nn.one_hot``'s."""
    logits = _router_logits()
    want_d, want_c, _ = jm._routing(jnp.asarray(logits), 2, capacity)
    got_d, got_c, _ = moe._routing(torch.from_numpy(logits), 2, capacity)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6, atol=1e-6)
    # each expert's slots hold at most C tokens, each slot at most one
    assert float(got_d.sum(dim=0).max()) <= 1.0
    assert float(got_d.sum()) == min(float(np.asarray(want_d).sum()), ROUTE_T * 2)


def test_expert_ffn_matches_jax():
    rng = np.random.default_rng(3)
    xs, wg, wu = (rng.standard_normal(s).astype(np.float32)
                  for s in ((4, 5, 16), (4, 16, 32), (4, 16, 32)))
    wd = rng.standard_normal((4, 32, 16)).astype(np.float32)
    want = jm._expert_ffn(*map(jnp.asarray, (wg, wu, wd, xs)))
    got = moe._expert_ffn(*map(torch.from_numpy, (wg, wu, wd, xs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_int8_keeps_the_experts_dense_and_packs_attention_as_jax():
    qtree = jax.tree.map(np.asarray, jq.quantize_params(jax.tree.map(jnp.asarray, tree()), "int8"))
    q = quantize_params(model(), "int8")
    assert isinstance(q, moe.MoETransformer) and q.quant == "int8"
    for layer in q.layers:
        for name in moe.EXPERT_KEYS:
            assert isinstance(getattr(layer, name), nn.Parameter)
        assert isinstance(layer.router, nn.Parameter) and layer.router.dtype == torch.float32
        for name in ("wq", "wk", "wv", "wo"):
            assert isinstance(getattr(layer, name), Pack)
    assert isinstance(q.lm_head, Pack)
    back = tree_from_transformer(q)
    for name in ("wq", "wk", "wv", "wo"):
        for part, arr in back["layers"][name].items():
            np.testing.assert_array_equal(arr, qtree["layers"][name][part])
    for part, arr in back["lm_head"].items():
        np.testing.assert_array_equal(arr, qtree["lm_head"][part])
    for name in moe.EXPERT_KEYS:
        np.testing.assert_array_equal(back["layers"][name], qtree["layers"][name])
    # a tree walks the same way: the experts beside a router stay dense
    as_torch = {"layers": {k: torch.from_numpy(v) for k, v in tree()["layers"].items()}}
    walked = quantize_params(as_torch, "int8")["layers"]
    assert isinstance(walked["w_gate"], torch.Tensor) and isinstance(walked["wq"], dict)


def test_int8_forward_matches_jax():
    toks = tokens()
    qparams = jq.quantize_params(jax.tree.map(jnp.asarray, tree()), "int8")
    want, _ = jm.moe_forward(qparams, jnp.asarray(toks), JCFG)
    loaded = moe_from_tree(jax.tree.map(np.asarray, qparams), CFG, device="cpu")
    assert loaded.quant == "int8" and isinstance(loaded.layers[0].wq, Pack)
    with torch.no_grad():
        got, _ = moe.moe_forward(loaded, torch.from_numpy(toks))
        mine, _ = moe.moe_forward(quantize_params(model(), "int8"), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(mine.numpy(), got.numpy())


@functools.lru_cache(maxsize=1)
def bf16_tree():
    return jm.init_moe(jax.random.key(0), dataclasses.replace(JCFG, dtype=jnp.bfloat16))


@pytest.mark.parametrize("index", range(JCFG.n_layers))
def test_bf16_layer_matches_jax(index):
    """Each bf16 MoE layer on the same input as JAX's (that layer's input
    in the JAX forward): the output and the aux losses within the bf16
    tolerance 2e-2 + 2e-2 |ref| (tests/test_flash.py's). Through a whole
    bf16 forward the two hidden states part by bf16 roundings, and a
    router choice at a near tie (gates 3e-4 apart measured) can flip."""
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    params = bf16_tree()
    freqs = jnp.asarray(jt._cached_freqs(jcfg.head_dim, jcfg.max_seq, jcfg.rope_theta))
    x = params["embed"][jnp.asarray(tokens())]
    for i in range(index):
        x, _ = jm.moe_block(jcfg, jax.tree.map(lambda a, i=i: a[i], params["layers"]), x, freqs,
                            jnp.arange(12))
    p = jax.tree.map(lambda a: a[index], params["layers"])
    want, want_aux = jm.moe_block(jcfg, p, x, freqs, jnp.arange(12))
    m = moe_from_tree(jax.tree.map(np.asarray, params),
                      dataclasses.replace(CFG, dtype=torch.bfloat16), device="cpu")
    inp = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got, aux = moe.moe_block(m.cfg, m, m.layers[index], inp, torch.arange(12))
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= 2e-2 + 2e-2 * np.abs(want)).all(), float(diff.max())
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), rtol=2e-2)


DENSE = TransformerConfig(vocab_size=89, dim=16, n_layers=2, n_heads=4, n_kv_heads=2,
                          hidden_dim=32, max_seq=64, dtype=torch.float32)


def test_mlp_fn_none_leaves_the_dense_model_bit_equal():
    """The hook's plumbing is exact: the dense SwiGLU through ``mlp_fn``
    gives the hookless forward's logits bit for bit, and the hookless
    forward is the JAX decoder's."""
    jcfg = jt.TransformerConfig(vocab_size=89, dim=16, n_layers=2, n_heads=4, n_kv_heads=2,
                                hidden_dim=32, max_seq=64, dtype=jnp.float32, attn_impl="xla")
    params = jt.init_transformer(jax.random.PRNGKey(0), jcfg)
    dense = transformer_from_tree(jax.tree.map(np.asarray, params), DENSE, device="cpu")
    toks = torch.from_numpy(tokens())

    def swiglu(layer, h):
        return mm(F.silu(mm(h, layer.w_gate)) * mm(h, layer.w_up), layer.w_down), {}

    with torch.no_grad():
        plain = dense.transformer_forward(toks)
        hooked, auxes = dense.transformer_forward(toks, mlp_fn=swiglu)
    assert torch.equal(plain, hooked) and auxes == [{}, {}]
    assert isinstance(dense, Transformer) and not isinstance(dense, moe.MoETransformer)
    want = np.asarray(jt.transformer_forward(params, jnp.asarray(tokens()), jcfg))
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)
