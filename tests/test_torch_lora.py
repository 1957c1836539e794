"""gofr_tpu_torch's LoRA models against the JAX package's
``gofr_tpu.models.lora`` on the CPU (tiny model, inputs from numpy seeds):
the wrapped product and the pooled bank's per-row product on dense, int8
and int4 bases (bank id 0 the bare base product bit for bit),
``build_lora_stack``'s layout and errors, ``add_lora``'s identity and its
w8a8 refusal, ``apply_adapter``'s shape check, ``merge_lora``, the weight
bridge for wrapped trees and adapter artifacts, ``decode_chunk_pool_lora``
with mixed ids [0, 1, 2, 1] (f32: ids exactly, logits within 2e-5; bf16
within 2e-2), adapter-only training (LoRA and QLoRA over int8, 3 AdamW
steps against optax) with the base unchanged bit for bit,
``masked``/``set_to_zero``/``lora_optimizer`` against optax, and the
export -> save -> restore -> apply round trip.

Weights start in JAX (``init_transformer``, ``add_lora``) and cross
through ``models/convert.py``; B gets seeded nonzero values so every delta
is real.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu.models import lora as jlora
from gofr_tpu.models import quant as jquant
from gofr_tpu.models import transformer as jt
from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu_torch.models import lora
from gofr_tpu_torch.models.convert import (
    _pack_from_tree,
    artifact_from_tree,
    to_torch,
    transformer_from_tree,
    tree_from_artifact,
    tree_from_transformer,
)
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.models.quant import Pack, mm
from gofr_tpu_torch.training import checkpoint, optim, trainer

F32_TOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def params():
    return jt.init_transformer(jax.random.PRNGKey(0), JAX_TINY)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _with_b(wrapped, seed, scale=0.05, dtype=jnp.bfloat16):
    """The wrapped tree with every B drawn (numpy seed), adapters in dtype."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if jlora.is_lora(t):
            b = rng.standard_normal(t["lora_b"].shape).astype(np.float32) * scale
            return {**t, "lora_a": t["lora_a"].astype(dtype), "lora_b": jnp.asarray(b, dtype)}
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t

    return walk(wrapped)


def _tokens(seed, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, TINY.vocab_size, shape).astype(np.int32)


def _fwd(model, tokens):
    with torch.no_grad():
        return model(torch.from_numpy(tokens)).numpy()


def _jfwd(tree, tokens, cfg=JAX_TINY):
    return np.asarray(jt.transformer_forward(tree, jnp.asarray(tokens), cfg))


# -- the products ----------------------------------------------------------------

def _base_weights(kind, w):
    """(JAX base leaf, port base weight) for a dense [in, out] f32 array."""
    if kind == "dense":
        return jnp.asarray(w), torch.from_numpy(w)
    jpack = (jquant.quantize_array if kind == "int8" else jquant.quantize_array_int4)(
        jnp.asarray(w))
    return jpack, Pack(_pack_from_tree(_np(jpack)))


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_lora_mm_and_plora_mm_match_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 48)) * 0.1).astype(np.float32)
    jbase, base = _base_weights(kind, w)
    a = jnp.asarray(rng.standard_normal((3, 128, 4)) * 0.1, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((3, 4, 48)) * 0.1, jnp.bfloat16)
    s = jnp.asarray([[[0.0]], [[2.0]], [[4.0]]], jnp.float32)
    # the wrapped product, adapter 1
    jleaf = {"w": jbase, "lora_a": a[1], "lora_b": b[1], "lora_scale": s[1]}
    want = np.asarray(jlora.lora_mm(jnp.asarray(x), jleaf, jquant.mm))
    leaf = lora.LoraWeight(base, to_torch(np.asarray(a[1])), to_torch(np.asarray(b[1])),
                           torch.tensor([[2.0]]))
    got = lora.lora_mm(torch.from_numpy(x), leaf).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    # the bank: zero entry, then two adapters; rows pick [0, 1, 2]
    za = jnp.zeros_like(a[0])
    zb = jnp.zeros_like(b[0])
    sa = jnp.stack([za, a[1], a[2]])
    sb = jnp.stack([zb, b[1], b[2]])
    ids = np.asarray([0, 1, 2], np.int32)
    jstack = {"w": jbase, "lora_stack_a": sa, "lora_stack_b": sb, "lora_stack_scale": s,
              "lora_ids": jnp.asarray(ids)}
    want = np.asarray(jlora.plora_mm(jnp.asarray(x), jstack, jquant.mm))
    stack = lora.LoraStack(base, to_torch(np.asarray(sa)), to_torch(np.asarray(sb)),
                           torch.from_numpy(np.array(s)))
    got = lora.plora_mm(torch.from_numpy(x), stack, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    # [B, in] rows (the last position's lm_head) as well
    want2 = np.asarray(jlora.plora_mm(jnp.asarray(x[:, 0]), jstack, jquant.mm))
    got2 = lora.plora_mm(torch.from_numpy(x[:, 0]), stack, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got2, want2, atol=F32_TOL, rtol=F32_TOL)
    # bank id 0 is the bare base product, bit for bit
    zeros = torch.zeros(3, dtype=torch.int32)
    np.testing.assert_array_equal(lora.plora_mm(torch.from_numpy(x), stack, zeros).numpy(),
                                  mm(torch.from_numpy(x), base).numpy())


# -- trees -------------------------------------------------------------------------

def test_add_lora_is_identity_and_shares_the_base():
    model = transformer_from_tree(_np(jt.init_transformer(jax.random.PRNGKey(0), JAX_TINY)),
                                  TINY, device="cpu")
    wrapped = lora.add_lora(model, seed=2, rank=4)
    assert lora.is_lora(wrapped.layers[0].wq) and lora.is_lora(wrapped.lm_head)
    assert wrapped.layers[0].wq.lora_a.dtype == torch.bfloat16
    assert float(wrapped.layers[0].wq.lora_scale) == 16.0 / 4
    tokens = _tokens(1)
    np.testing.assert_array_equal(_fwd(wrapped, tokens), _fwd(model, tokens))
    # the base's own tensors, not copies
    assert wrapped.layers[1].w_up.w is model.layers[1].w_up
    assert wrapped.embed is model.embed and wrapped.norm_f is model.norm_f
    assert wrapped.layers[0].wq.w.data_ptr() == model.layers[0].wq.data_ptr()
    # a keys restriction wraps those alone
    only_q = lora.add_lora(model, seed=3, rank=2, keys=["wq"])
    assert lora.is_lora(only_q.layers[0].wq) and not lora.is_lora(only_q.layers[0].wk)
    assert not lora.is_lora(only_q.lm_head)


def test_add_lora_rejects_a_w8a8_base():
    model = transformer_from_tree(
        _np(jquant.quantize_params(jt.init_transformer(jax.random.PRNGKey(4), JAX_TINY), "w8a8")),
        TINY, device="cpu")
    with pytest.raises(ValueError, match="w8a8"):
        lora.add_lora(model)


def test_wrapped_tree_crosses_and_matches_jax(params):
    wrapped = _with_b(jlora.add_lora(params, jax.random.key(2), rank=4), 5)
    model = transformer_from_tree(_np(wrapped), TINY, device="cpu")
    assert lora.is_lora(model.layers[1].w_down) and model.layers[1].w_down.rank == 4
    tokens = _tokens(2)
    np.testing.assert_allclose(_fwd(model, tokens), _jfwd(wrapped, tokens),
                               atol=F32_TOL, rtol=F32_TOL)
    # back to the JAX tree, every leaf equal
    back = tree_from_transformer(model)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), _np(wrapped))
    flat_w, tree_w = jax.tree.flatten(want)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_w == tree_b
    for g, w in zip(flat_b, flat_w):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_qlora_tree_crosses_and_matches_jax(params, mode):
    wrapped = _with_b(jlora.add_lora(jquant.quantize_params(params, mode), jax.random.key(6),
                                     rank=4), 7)
    model = transformer_from_tree(_np(wrapped), TINY, device="cpu")
    assert isinstance(model.layers[0].wq.w, Pack) and model.quant == mode
    tokens = _tokens(3)
    np.testing.assert_allclose(_fwd(model, tokens), _jfwd(wrapped, tokens),
                               atol=F32_TOL, rtol=F32_TOL)


def test_build_lora_stack_layout_and_errors(params):
    wa = _with_b(jlora.add_lora(params, jax.random.key(2), rank=4), 5)
    wb = _with_b(jlora.add_lora(params, jax.random.key(3), rank=4), 6)
    base = transformer_from_tree(_np(params), TINY, device="cpu")
    ma = lora.apply_adapter(base, artifact_from_tree(_np(_artifact(wa))))
    mb = lora.apply_adapter(base, artifact_from_tree(_np(_artifact(wb))))
    stacked = lora.build_lora_stack(base, {"a": ma, "b": mb})
    jstack = jlora.build_lora_stack(params, {"a": wa, "b": wb})
    for i, block in enumerate(stacked.layers):
        leaf = block.wq
        assert isinstance(leaf, lora.LoraStack) and leaf.w is base.layers[i].wq
        assert tuple(leaf.lora_stack_a.shape) == (3, TINY.dim, 4)
        assert not leaf.lora_stack_a[0].any() and not leaf.lora_stack_scale[0].any()
        for name in ("lora_stack_a", "lora_stack_b", "lora_stack_scale"):
            np.testing.assert_array_equal(
                getattr(leaf, name).float().numpy(),
                np.asarray(jstack["layers"]["wq"][name][i], np.float32))
    np.testing.assert_array_equal(
        stacked.lm_head.lora_stack_b.float().numpy(),
        np.asarray(jstack["lm_head"]["lora_stack_b"], np.float32))
    odd = lora.add_lora(base, seed=1, rank=2)
    with pytest.raises(ValueError, match="rank mismatch"):
        lora.build_lora_stack(base, {"a": ma, "odd": odd})
    partial = lora.add_lora(base, seed=1, rank=4, keys=["wq"])
    with pytest.raises(ValueError, match="disagree on target"):
        lora.build_lora_stack(base, {"a": ma, "p": partial})


def _artifact(wrapped):
    """A JAX export_adapter artifact of a wrapped tree (no training)."""
    adapters, rest = jlora.split_lora(wrapped)
    return jlora.export_adapter({"adapters": adapters, "rest": rest})


def test_apply_adapter_checks_shapes(params):
    base = transformer_from_tree(_np(params), TINY, device="cpu")
    art = artifact_from_tree(_np(_artifact(jlora.add_lora(params, jax.random.key(2), rank=4))))
    wrong = {"adapters": {"layers": {"wq": {
        "lora_a": art["adapters"]["layers"]["wq"]["lora_a"][:1],  # one layer of two
        "lora_b": art["adapters"]["layers"]["wq"]["lora_b"][:1]}}},
        "scales": {"layers": {"wq": art["scales"]["layers"]["wq"][:1]}}}
    with pytest.raises(ValueError, match="do not fit base weight"):
        lora.apply_adapter(base, wrong)
    with pytest.raises(ValueError, match="not weights of the model"):
        lora.apply_adapter(base, {"adapters": {"embed": {}}, "scales": {}})


@pytest.mark.parametrize("mode", [None, "int8"])
def test_merge_lora_matches_jax_and_the_unmerged_forward(params, mode):
    tree = jquant.quantize_params(params, mode) if mode else params
    wrapped = _with_b(jlora.add_lora(tree, jax.random.key(4), rank=4), 8)
    model = transformer_from_tree(_np(wrapped), TINY, device="cpu")
    merged = lora.merge_lora(model)
    assert not lora.is_lora(merged.layers[0].wq) and merged.quant is None
    jmerged = jlora.merge_lora(wrapped)
    got = tree_from_transformer(merged)
    for key in ("wq", "w_down"):
        np.testing.assert_allclose(got["layers"][key], np.asarray(jmerged["layers"][key],
                                                                  np.float32),
                                   atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got["lm_head"], np.asarray(jmerged["lm_head"], np.float32),
                               atol=1e-6, rtol=1e-6)
    tokens = _tokens(5)
    np.testing.assert_allclose(_fwd(merged, tokens), _jfwd(jmerged, tokens),
                               atol=F32_TOL, rtol=F32_TOL)
    if mode is None:  # an int8 merge rounds its weights to bf16, as JAX's does
        np.testing.assert_allclose(_fwd(merged, tokens), _fwd(model, tokens), atol=1e-4,
                                   rtol=1e-4)


def test_artifact_crosses_and_round_trips_through_a_checkpoint(params, tmp_path):
    wrapped = _with_b(jlora.add_lora(params, jax.random.key(9), rank=4), 10)
    jart = _artifact(wrapped)
    art = artifact_from_tree(_np(jart))
    base = transformer_from_tree(_np(params), TINY, device="cpu")
    model = lora.apply_adapter(base, art)
    tokens = _tokens(6)
    np.testing.assert_allclose(_fwd(model, tokens), _jfwd(wrapped, tokens),
                               atol=F32_TOL, rtol=F32_TOL)
    # export -> save -> restore (weights_only) -> apply: the same model
    out = lora.export_adapter(model)
    flat_a, tree_a = jax.tree.flatten(tree_from_artifact(out))
    flat_j, tree_j = jax.tree.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                   _np(jart)))
    assert tree_a == tree_j
    for g, w in zip(flat_a, flat_j):
        np.testing.assert_array_equal(g, w)
    checkpoint.save_params(str(tmp_path / "ad"), out)
    restored = checkpoint.restore_params(str(tmp_path / "ad"), device="cpu")
    again = lora.apply_adapter(base, restored)
    np.testing.assert_array_equal(_fwd(again, tokens), _fwd(model, tokens))
    # split -> combine: another model takes these adapters' values
    other = lora.add_lora(base, seed=1, rank=4)
    lora.combine_lora(lora.split_lora(model)[0], other)
    np.testing.assert_array_equal(_fwd(other, tokens), _fwd(model, tokens))
    assert restored["adapters"]["layers"]["wq"]["lora_a"].dtype == torch.bfloat16


# -- the pooled chunk -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_chunk_pool_lora_matches_jax(dtype):
    jcfg = JAX_TINY if dtype == "f32" else dataclasses.replace(JAX_TINY, dtype=jnp.bfloat16)
    cfg = TINY if dtype == "f32" else dataclasses.replace(TINY, dtype=torch.bfloat16)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    params = jt.init_transformer(jax.random.PRNGKey(0), jcfg)
    wa = _with_b(jlora.add_lora(params, jax.random.key(2), rank=4), 5, scale=0.2)
    wb = _with_b(jlora.add_lora(params, jax.random.key(3), rank=4), 6, scale=0.2)
    jstack = jlora.build_lora_stack(params, {"a": wa, "b": wb})
    base = transformer_from_tree(_np(params), cfg, device="cpu")
    stack = lora.build_lora_stack(base, {
        "a": lora.apply_adapter(base, artifact_from_tree(_np(_artifact(wa)))),
        "b": lora.apply_adapter(base, artifact_from_tree(_np(_artifact(wb))))})
    ids = np.asarray([0, 1, 2, 1], np.int32)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    lengths = np.asarray([5, 16, 9, 12], np.int32)
    jlogits, jcache = jt.prefill(params, jnp.asarray(tokens), jt.init_cache(jcfg, 4, jcfg.max_seq),
                                 jcfg, jnp.asarray(lengths))
    cache = base.init_cache(4, cfg.max_seq)
    _, cache = base.prefill(torch.from_numpy(tokens), cache, torch.from_numpy(lengths))
    first = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)[:, None]
    n = 6
    knobs = (np.zeros(4, np.float32), np.zeros(4, np.int32), np.ones(4, np.float32),
             np.zeros(4, np.float32))
    jtoks, jlps, jtv, jti, jnext, _, _ = jt.decode_chunk_pool_lora(
        jstack, jnp.asarray(ids), jnp.asarray(first), jcache, jcfg, n, jax.random.key(0),
        *(jnp.asarray(k) for k in knobs))
    toks, lps, tv, ti, nxt, cache = stack.decode_chunk_pool_lora(
        torch.from_numpy(ids), torch.from_numpy(first), cache, n, None,
        *(torch.from_numpy(k) for k in knobs), all_greedy=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), atol=tol, rtol=tol)
    if dtype == "f32":  # bf16 logits tie often among the top-5 alternatives
        np.testing.assert_allclose(tv.numpy(), np.asarray(jtv), atol=tol, rtol=tol)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(jti))
    # the adapters moved the rows they serve: rows 1 and 3 share adapter 1
    plain = base.decode_chunk_pool(torch.from_numpy(first), _fresh_cache(base, tokens, lengths),
                                   n, None, *(torch.from_numpy(k) for k in knobs),
                                   all_greedy=True)
    np.testing.assert_array_equal(plain[0].numpy()[0], toks.numpy()[0])  # id 0: the base
    assert not np.array_equal(plain[1].numpy()[1:], lps.numpy()[1:])


def _fresh_cache(model, tokens, lengths):
    cache = model.init_cache(tokens.shape[0], model.cfg.max_seq)
    _, cache = model.prefill(torch.from_numpy(tokens), cache, torch.from_numpy(lengths))
    return cache


# -- training -----------------------------------------------------------------------

def _f32_adapters(wrapped):
    return _with_b(wrapped, 0, scale=0.0, dtype=jnp.float32)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_three_lora_steps_match_jax(params, mode):
    """3 AdamW steps over the adapters alone (f32 adapters; QLoRA over the
    int8 base): losses within 1e-5 relative, adapters within 1e-4, and
    every base tensor bit-unchanged."""
    lr = 1e-3
    tree = jquant.quantize_params(params, mode) if mode else params
    wrapped = _f32_adapters(jlora.add_lora(tree, jax.random.key(11), rank=4))
    batches = [_tokens(20 + i, (2, 17)) for i in range(3)]
    model = transformer_from_tree(_np(wrapped), TINY, device="cpu")
    jopt = optax.adamw(lr)
    jstate = jlora.init_lora_train_state(wrapped, jopt)
    jstep = jlora.make_lora_train_step(JAX_TINY, jopt)
    want = []
    for b in batches:
        jstate, m = jstep(jstate, jnp.asarray(b))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "lora_a" not in k and "lora_b" not in k}
    opt = optim.adamw(lr)
    state = lora.init_lora_train_state(model, opt)
    step = lora.make_lora_train_step(TINY, opt)
    for b, (w_loss, w_norm) in zip(batches, want):
        state, m = step(state, b)
        assert float(m["loss"]) == pytest.approx(w_loss, rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(w_norm, rel=1e-5)
    assert state["step"] == 3
    # the optimizer holds adapter tensors alone
    ids = {id(p) for p in state["adapters"]}
    assert len(state["opt_state"]["mu"]) == len(state["adapters"])
    assert all(p.requires_grad for p in state["adapters"])
    assert not any(p.requires_grad for p in model.parameters() if id(p) not in ids)
    got = tree_from_transformer(model)
    jtree = _np(jlora.combine_lora(jstate["adapters"], jstate["rest"]))
    for path in ("lm_head",) + tuple(f"layers/{k}" for k in ("wq", "wk", "wv", "wo", "w_gate",
                                                              "w_up", "w_down")):
        g, w = got, jtree
        for part in path.split("/"):
            g, w = g[part], w[part]
        for name in ("lora_a", "lora_b"):
            np.testing.assert_allclose(g[name], np.asarray(w[name]), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{path}/{name}")
        assert np.abs(g["lora_b"]).max() > 1e-3  # B moved off zero
    for k, v in model.state_dict().items():
        if k in before:
            assert torch.equal(v, before[k]), k


def test_lora_optimizer_matches_optax(params):
    """masked + set_to_zero over every parameter: the adapters take
    optax's Adam update, the base none, and the moments exist for the
    adapters alone."""
    wrapped = _f32_adapters(_with_b(jlora.add_lora(params, jax.random.key(12), rank=4), 13))
    tokens = _tokens(7, (2, 17))
    jopt = jlora.lora_optimizer(optax.adam(1e-2), wrapped)
    from gofr_tpu.training.trainer import cross_entropy_loss as jloss

    jgrads = jax.grad(jloss)(wrapped, jnp.asarray(tokens), JAX_TINY)
    updates, _ = jopt.update(jgrads, jopt.init(wrapped), wrapped)
    jnew = _np(optax.apply_updates(wrapped, updates))

    model = transformer_from_tree(_np(wrapped), TINY, device="cpu")
    params_t = list(model.parameters())
    for p in params_t:
        p.requires_grad_(True)
    before = [p.detach().clone() for p in params_t]
    loss = trainer.cross_entropy_loss(model, torch.from_numpy(tokens))
    grads = list(torch.autograd.grad(loss, params_t))
    opt = lora.lora_optimizer(optim.adamw(1e-2, weight_decay=0.0), model)
    state = opt.init(params_t)
    mask = lora.lora_mask(model)
    assert sum(mask) == 2 * (1 + 7 * TINY.n_layers) == len(state[0]["mu"])
    assert state[1] == {}
    opt.update(grads, state, params_t)
    for p, b, m in zip(params_t, before, mask):
        if not m:
            assert torch.equal(p.detach(), b)
    got = tree_from_transformer(model)
    for key in ("wq", "w_gate"):
        for name in ("lora_a", "lora_b"):
            np.testing.assert_allclose(got["layers"][key][name], jnew["layers"][key][name],
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["embed"], np.asarray(jnew["embed"]))


def test_masked_and_set_to_zero_match_optax():
    rng = np.random.default_rng(14)
    arrays = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(3)]
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(3)]
    mask = [True, False, True]
    jtx = optax.chain(optax.masked(optax.adam(0.1), mask),
                      optax.masked(optax.set_to_zero(), [not m for m in mask]))
    jstate = jtx.init(arrays)
    jp = arrays
    for _ in range(2):
        upd, jstate = jtx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    tx = optim.chain(optim.masked(optim.adamw(0.1, weight_decay=0.0), mask),
                     optim.masked(optim.set_to_zero(), [not m for m in mask]))
    ps = [torch.from_numpy(a.copy()) for a in arrays]
    state = tx.init(ps)
    for _ in range(2):
        tx.update([torch.from_numpy(g.copy()) for g in grads], state, ps)
    for p, w in zip(ps, jp):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert len(state[0]["mu"]) == 2
    with pytest.raises(ValueError, match="mask"):
        optim.masked(optim.set_to_zero(), [True]).init(ps)


def test_quantized_full_training_points_at_lora(params):
    model = transformer_from_tree(_np(jquant.quantize_params(params, "int8")), TINY,
                                  device="cpu")
    with pytest.raises(ValueError, match="make_lora_train_step"):
        trainer.init_train_state_from(model, trainer.default_optimizer())
    state = lora.init_lora_train_state(lora.add_lora(model, rank=2), optim.adamw(1e-3))
    assert len(state["adapters"]) == 2 * (1 + 7 * TINY.n_layers)
    with pytest.raises(ValueError, match="no adapters"):
        lora.init_lora_train_state(model, optim.adamw(1e-3))
