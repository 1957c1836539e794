"""Expert parallelism (``gofr_tpu_torch/parallel/expert.py``) against the
JAX package's ``make_moe_forward`` / ``make_moe_loss`` on its 8-device
virtual CPU mesh (``tests/conftest.py``), the port's ``Mesh`` over 8
repeated ``cpu`` devices.

The cases of ``tests/test_moe.py`` held against JAX's ep functions (the
reference holds them against the dense model): the ep = 4 x fsdp = 2
forward within 2e-5; the ep = 2 loss with ``aux_weight = 0`` and its
``w_gate``, ``w_down``, ``router`` and ``wq`` gradients within the
reference's rtol 5e-3 (atol 1e-5); the full loss with the aux terms equal
to JAX's ep loss within 1e-5; the ``capacity_factor = 0.25`` logits equal
to JAX's ep logits within 2e-5 (the same tokens dropped); the refusals.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import moe as jm
from gofr_tpu.parallel import expert as jexpert
from gofr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gofr_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from gofr_tpu_torch.models import moe
from gofr_tpu_torch.models.convert import moe_from_tree
from gofr_tpu_torch.parallel import expert
from gofr_tpu_torch.parallel import mesh as pm

JCFG = jm.MoEConfig(vocab_size=89, dim=16, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=32,
                    max_seq=64, n_experts=4, top_k=2, capacity_factor=2.0,
                    dtype=jnp.float32, attn_impl="xla")
CFG = moe.MoEConfig(vocab_size=89, dim=16, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=32,
                    max_seq=64, n_experts=4, top_k=2, capacity_factor=2.0, dtype=torch.float32)
NO_AUX = {"aux_weight": 0.0}
TIGHT = {"capacity_factor": 0.25}
GRAD_KEYS = ("w_gate", "w_down", "router", "wq")


@functools.lru_cache(maxsize=1)
def tree():
    return jax.tree.map(np.asarray, jm.init_moe(jax.random.key(0), JCFG))


def tokens() -> np.ndarray:
    return np.asarray(jax.random.randint(jax.random.key(1), (8, 12), 0, CFG.vocab_size))


def meshes(**axes):
    jmesh = jax_make_mesh(jax_mesh_shape_for(8, **axes), devices=jax.devices()[:8])
    return jmesh, pm.make_mesh(pm.mesh_shape_for(8, **axes), devices=[torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX ep function built and run once for the module."""
    params = jax.tree.map(jnp.asarray, tree())
    toks = jnp.asarray(tokens())
    out = {}
    jmesh, _ = meshes(ep=4, fsdp=2)
    placed = jexpert.place_moe_params(params, jmesh)
    out["forward"] = jax.tree.map(np.asarray, jexpert.make_moe_forward(JCFG, jmesh)(placed, toks))
    out["tight"] = np.asarray(jexpert.make_moe_forward(
        dataclasses.replace(JCFG, **TIGHT), jmesh)(placed, toks)[0])
    jmesh, _ = meshes(ep=2, fsdp=2)
    placed = jexpert.place_moe_params(params, jmesh)
    loss, grads = jax.value_and_grad(jexpert.make_moe_loss(
        dataclasses.replace(JCFG, **NO_AUX), jmesh))(placed, toks)
    out["loss_no_aux"] = float(loss)
    out["grads"] = {k: np.asarray(grads["layers"][k]) for k in GRAD_KEYS}
    out["loss"] = float(jexpert.make_moe_loss(JCFG, jmesh)(placed, toks))
    out["dense"], _ = jm.moe_forward(params, toks, JCFG)
    return out


def placed(mesh):
    return expert.place_moe_params(moe_from_tree(tree(), CFG, device="cpu"), mesh)


def test_specs_are_the_jax_package_s():
    want = jexpert.moe_param_specs(jax.tree.map(jnp.asarray, tree()))
    got = expert.moe_param_specs(tree())
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for k in ("embed", "norm_f", "lm_head"):
        assert got[k] == tuple(want[k])
    for k, spec in want["layers"].items():
        assert got["layers"][k] == tuple(spec), k
    assert expert.moe_param_specs(moe_from_tree(tree(), CFG, device="cpu")) == got
    assert expert.moe_param_specs() == got


def test_placement_splits_the_experts_over_ep_and_copies_the_rest():
    _, mesh = meshes(ep=4, fsdp=2)
    p = placed(mesh)
    assert len(p.shards) == 8
    for i, shard in enumerate(p.shards):
        ep = i % 4  # ep is the last non-trivial axis of (dp, fsdp, sp, pp, ep, tp)
        layer = shard.layers[1]
        assert tuple(layer.w_gate.shape) == (1, 16, 32)
        np.testing.assert_array_equal(layer.w_gate.numpy(), tree()["layers"]["w_gate"][1, ep:ep + 1])
        np.testing.assert_array_equal(layer.wq.numpy(), tree()["layers"]["wq"][1])
    leaves = ([(k, None) for k in ("embed", "norm_f", "lm_head")]
              + [(k, li) for li in range(CFG.n_layers) for k in moe.MoETransformer.layer_weights])
    for name, li in leaves:
        want = tree()[name] if li is None else tree()["layers"][name][li]
        np.testing.assert_array_equal(p.logical(name, li).numpy(), want)


def test_ep_forward_matches_jax(jax_runs):
    _, mesh = meshes(ep=4, fsdp=2)
    want, want_aux = jax_runs["forward"]
    with torch.no_grad():
        got, aux = expert.make_moe_forward(CFG, mesh)(placed(mesh), tokens())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # with ample capacity (C = T) the ep path is the exact mixture
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_runs["dense"]), rtol=2e-4, atol=2e-4)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), rtol=1e-5, atol=1e-6)


def test_ep_loss_and_grads_match_jax(jax_runs):
    _, mesh = meshes(ep=2, fsdp=2)
    p = placed(mesh)
    for t in p.parameters():
        t.requires_grad_(True)
    loss = expert.make_moe_loss(dataclasses.replace(CFG, **NO_AUX), mesh)(p, tokens())
    loss.backward()
    np.testing.assert_allclose(float(loss), jax_runs["loss_no_aux"], rtol=1e-5)
    for key in GRAD_KEYS:
        got = np.stack([p.logical(key, li, grad=True).numpy() for li in range(CFG.n_layers)])
        np.testing.assert_allclose(got, jax_runs["grads"][key], rtol=5e-3, atol=1e-5,
                                   err_msg=f"layers.{key}")


def test_ep_full_loss_with_aux_matches_jax(jax_runs):
    _, mesh = meshes(ep=2, fsdp=2)
    with torch.no_grad():
        got = float(expert.make_moe_loss(CFG, mesh)(placed(mesh), tokens()))
    np.testing.assert_allclose(got, jax_runs["loss"], rtol=1e-5)


def test_capacity_overflow_drops_the_jax_package_s_tokens(jax_runs):
    _, mesh = meshes(ep=4, fsdp=2)
    stats: dict = {}
    with torch.no_grad():
        got, _ = expert.make_moe_forward(dataclasses.replace(CFG, **TIGHT), mesh, stats=stats)(
            placed(mesh), tokens())
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), jax_runs["tight"], rtol=2e-5, atol=2e-5)
    # 12 tokens a shard, C = int(12 * 2 * 0.25 / 4) = 1 slot an expert
    assert stats["assignments"] == 8 * 12 * 2 * CFG.n_layers
    assert 0 < stats["dropped"] < stats["assignments"]


def test_ep_rejects_indivisible_experts():
    _, mesh = meshes(ep=8)
    bad = dataclasses.replace(CFG, n_experts=6)
    with pytest.raises(ValueError, match="n_experts=6 not divisible by ep=8"):
        expert.make_moe_forward(bad, mesh)
    with pytest.raises(ValueError, match="n_experts=6 not divisible by ep=8"):
        expert.make_moe_loss(bad, mesh)
    jmesh, _ = meshes(ep=8)
    with pytest.raises(ValueError, match="n_experts=6 not divisible by ep=8"):
        jexpert.make_moe_forward(dataclasses.replace(JCFG, n_experts=6), jmesh)


def test_a_batch_the_row_groups_do_not_divide_is_refused():
    _, mesh = meshes(ep=4, fsdp=2)
    with pytest.raises(ValueError, match="batch 6 does not split over 8 row groups"):
        expert.make_moe_forward(CFG, mesh)(placed(mesh), tokens()[:6])
    with pytest.raises(ValueError, match="leave out ep=4"):
        expert.make_moe_forward(CFG, mesh, batch_axes=("dp", "fsdp"))
