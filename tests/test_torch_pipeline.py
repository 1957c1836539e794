"""Pipeline parallelism (``parallel/pipeline.py``) against the JAX package's
GPipe schedule on the CPU: the four cases of ``tests/test_pipeline.py``
(pp=4 over dp=2; pp=2 x fsdp=2; the loss and every gradient against the
plain model and ``jax.value_and_grad`` of ``make_pipeline_loss``; the
indivisible microbatch refused), plus the specs, the stage placement and
the schedule's layer applications (no drain replays).

The config is ``tests/test_pipeline.py``'s (vocab 97, dim 16, 4 layers, 4
heads, 2 KV heads, hidden 32, max_seq 64, f32); JAX initialises and the
weights cross through ``models/convert.py``. Tolerances: logits and loss
1e-5 relative, gradients 1e-4 relative with 1e-5 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import transformer as jt
from gofr_tpu.parallel import pipeline as jpipe
from gofr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gofr_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from gofr_tpu.training.trainer import cross_entropy_loss as jax_loss
from gofr_tpu_torch.models.convert import transformer_from_tree, tree_from_transformer
from gofr_tpu_torch.models.transformer import TransformerConfig
from gofr_tpu_torch.parallel import mesh as pm
from gofr_tpu_torch.parallel import pipeline
from gofr_tpu_torch.training.trainer import cross_entropy_loss

JCFG = jt.TransformerConfig(vocab_size=97, dim=16, n_layers=4, n_heads=4, n_kv_heads=2,
                            hidden_dim=32, max_seq=64, dtype=jnp.float32, attn_impl="xla")
CFG = TransformerConfig(vocab_size=97, dim=16, n_layers=4, n_heads=4, n_kv_heads=2,
                        hidden_dim=32, max_seq=64, dtype=torch.float32)
MESHES = {"pp4": {"pp": 4}, "pp2-fsdp2": {"pp": 2, "fsdp": 2}}  # dp fills 8 devices


@functools.lru_cache(maxsize=1)
def tree():
    return jax.tree.map(np.asarray, jt.init_transformer(jax.random.PRNGKey(0), JCFG))


def tokens() -> np.ndarray:
    return np.random.default_rng(1).integers(0, CFG.vocab_size, (8, 12)).astype(np.int32)


def meshes(name: str):
    kw = MESHES[name]
    jmesh = jax_make_mesh(jax_mesh_shape_for(8, **kw), devices=jax.devices()[:8])
    return jmesh, pm.make_mesh(pm.mesh_shape_for(8, **kw), devices=[torch.device("cpu")] * 8)


def placed(mesh):
    return pipeline.place_pipeline_params(transformer_from_tree(tree(), CFG, device="cpu"), mesh)


@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_forward_matches_jax_and_plain(name):
    jmesh, mesh = meshes(name)
    jparams = jax.tree.map(jnp.asarray, tree())
    want = np.asarray(jpipe.make_pipeline_forward(JCFG, jmesh, n_micro=2)(
        jpipe.place_pipeline_params(jparams, jmesh), jnp.asarray(tokens())))
    plain = np.asarray(jt.transformer_forward(jparams, jnp.asarray(tokens()), JCFG))
    with torch.no_grad():
        got = pipeline.make_pipeline_forward(CFG, mesh, n_micro=2)(placed(mesh), tokens())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), plain, rtol=1e-5, atol=1e-5)


def test_pipeline_loss_and_grads_match_plain():
    jmesh, mesh = meshes("pp4")
    jparams = jax.tree.map(jnp.asarray, tree())
    toks = jnp.asarray(tokens())
    want_loss, want = jax.value_and_grad(jpipe.make_pipeline_loss(JCFG, jmesh, n_micro=2))(
        jpipe.place_pipeline_params(jparams, jmesh), toks)
    plain_loss = float(jax_loss(jparams, toks, JCFG))
    model = placed(mesh)
    params = list(model.parameters())
    loss = pipeline.make_pipeline_loss(CFG, mesh, n_micro=2)(model, tokens())
    grads = torch.autograd.grad(loss, params)
    unsharded = transformer_from_tree(tree(), CFG, device="cpu")
    for p in unsharded.parameters():
        p.requires_grad_(True)
    plain = torch.autograd.grad(cross_entropy_loss(unsharded, torch.from_numpy(tokens())),
                                list(unsharded.parameters()))
    value = float(loss.detach())
    assert value == pytest.approx(float(want_loss), rel=1e-5)
    assert value == pytest.approx(plain_loss, rel=1e-5)
    for g, w in zip(grads, plain):  # every stage's layers and the single copies
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)
    for p, g in zip(params, grads):
        p.data = g
    got = tree_from_transformer(model)
    want = jax.tree.map(np.asarray, want)
    for key in ("embed", "norm_f", "lm_head"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)
    for key, w in want["layers"].items():
        np.testing.assert_allclose(got["layers"][key], w, rtol=1e-4, atol=1e-5, err_msg=key)


def test_pipeline_rejects_indivisible_microbatch():
    jmesh, mesh = meshes("pp4")
    bad = np.ones((8, 12), np.int32)  # a local batch of 4 over n_micro=3
    with pytest.raises(ValueError, match="n_micro") as want:
        jpipe.make_pipeline_forward(JCFG, jmesh, n_micro=3)(
            jpipe.place_pipeline_params(jax.tree.map(jnp.asarray, tree()), jmesh),
            jnp.asarray(bad))
    with pytest.raises(ValueError, match="n_micro") as got:
        pipeline.make_pipeline_forward(CFG, mesh, n_micro=3)(placed(mesh), bad)
    assert str(got.value) == str(want.value)


def test_stages_specs_and_schedule():
    from jax.sharding import PartitionSpec as P

    jmesh, mesh = meshes("pp4")
    assert {k: tuple(v) for k, v in jpipe.pipeline_param_specs().items()} == \
        pipeline.pipeline_param_specs() == {k: tuple(v) for k, v in
                                            jpipe.pipeline_param_specs(tree()).items()}
    assert jpipe.pipeline_param_specs()["layers"] == P("pp")
    model = placed(mesh)
    assert [layer.wq.device for layer in model.layers] == [mesh.device(pp=s) for s in range(4)]
    assert all(p.requires_grad for p in model.parameters())
    # n_micro x n_layers layer applications a row group: no drain replays
    calls = []
    block = model._block
    model._block = lambda *a, **kw: calls.append(1) or block(*a, **kw)
    with torch.no_grad():  # n_micro = 2·pp = 8 over a local batch of 8
        pipeline.make_pipeline_forward(CFG, mesh)(model, np.concatenate([tokens()] * 2))
    assert len(calls) == mesh.shape["dp"] * 8 * CFG.n_layers
    bad_mesh = pm.make_mesh({"pp": 3}, devices=[torch.device("cpu")] * 3)
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        pipeline.make_pipeline_loss(CFG, bad_mesh)
