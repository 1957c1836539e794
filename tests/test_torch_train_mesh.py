"""Training over a mesh (``training/trainer.py::place_train_state`` and
``make_train_step(mesh=)``) against the JAX trainer's on the CPU.

The config is the JAX package's multichip dry run's (``__graft_entry__.py``:
vocab 128, dim 32, 2 layers, 4 heads, 2 KV heads, hidden 64, f32). JAX runs
on ``tests/conftest.py``'s 8-device virtual mesh, the port on a ``Mesh``
over repeated ``cpu`` devices; JAX initialises and the weights cross
through ``models/convert.py``. At tp=2, dp=2, fsdp=2, tp=2 x fsdp=2 and
dp=2 x tp=2 the two trainers take 3 steps on the same batches: loss and
grad norm each step within 1e-5 relative, the step count exactly, the
unsharded parameters after within 3 x lr (``tests/test_torch_train.py``'s
tolerances). The dp replicas stay bit-equal; the norm counts each logical
block once (at dp=2 it equals the unsharded step's); a placed state's
checkpoint is the unsharded state's, byte for byte, and resumes the run;
an indivisible batch and a quantized model are refused.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import transformer as jt
from gofr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gofr_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from gofr_tpu.training import trainer as jtrain
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.transformer import TransformerConfig
from gofr_tpu_torch.parallel import mesh as pm
from gofr_tpu_torch.parallel.serving import ShardedTransformer
from gofr_tpu_torch.training import checkpoint, trainer

JCFG = jt.TransformerConfig(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                            hidden_dim=64, max_seq=64, dtype=jnp.float32, attn_impl="xla")
CFG = TransformerConfig(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                        hidden_dim=64, max_seq=64, dtype=torch.float32)
LR = 1e-4  # parameters after n steps are held to n * lr
STEPS = 3
MESHES = {"tp2": {"tp": 2}, "dp2": {"dp": 2}, "fsdp2": {"fsdp": 2},
          "tp2-fsdp2": {"tp": 2, "fsdp": 2}, "dp2-tp2": {"dp": 2, "tp": 2}}


@functools.lru_cache(maxsize=1)
def _tree():
    return jax.tree.map(np.asarray, jt.init_transformer(jax.random.PRNGKey(0), JCFG))


def _batches():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG.vocab_size, (4, 17)).astype(np.int32) for _ in range(STEPS)]


def _size(shape: dict) -> int:
    return int(np.prod(list(shape.values())))


def _mesh(shape: dict) -> pm.Mesh:
    return pm.make_mesh(shape, devices=[torch.device("cpu")] * _size(shape))


@functools.lru_cache(maxsize=None)
def _jax_run(name: str):
    """The JAX mesh trainer's 3 steps at ``MESHES[name]``: per step (loss,
    grad norm, step), and the parameters after, as numpy."""
    shape = MESHES[name]
    n = _size(shape)
    kw = {k: v for k, v in shape.items() if k != "dp"}
    mesh = jax_make_mesh(jax_mesh_shape_for(n, **kw), devices=jax.devices()[:n])
    opt = jtrain.default_optimizer(LR)
    params = jax.tree.map(jnp.array, _tree())
    state = jtrain.place_train_state(
        {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)},
        mesh)
    step = jtrain.make_train_step(JCFG, opt, mesh=mesh)
    metrics = []
    for b in _batches():
        state, m = step(state, jnp.asarray(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["step"])))
    return metrics, jax.tree.map(np.asarray, state["params"])


def _state(opt=None):
    model = transformer_from_tree(_tree(), CFG, device="cpu")
    return trainer.init_train_state_from(model, opt or trainer.default_optimizer(LR))


def _placed(shape: dict, opt=None):
    opt = opt or trainer.default_optimizer(LR)
    mesh = _mesh(shape)
    return trainer.place_train_state(_state(opt), mesh), trainer.make_train_step(CFG, opt, mesh)


def _assert_tree(model, want: dict, atol: float) -> None:
    from gofr_tpu_torch.models.convert import tree_from_transformer

    got = tree_from_transformer(model)
    for key in ("embed", "norm_f", "lm_head"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol, err_msg=key)
    for key, w in want["layers"].items():
        np.testing.assert_allclose(got["layers"][key], w, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_steps_match_jax(name):
    want, jparams = _jax_run(name)
    state, step = _placed(MESHES[name])
    assert isinstance(state["model"], ShardedTransformer)
    for b, (w_loss, w_norm, w_step) in zip(_batches(), want):
        state, m = step(state, b)
        assert float(m["loss"]) == pytest.approx(w_loss, rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(w_norm, rel=1e-5)
        assert m["step"] == w_step
    _assert_tree(state["model"].unshard(), jparams, STEPS * LR)


@pytest.mark.parametrize("name", ["dp2", "dp2-tp2"])
def test_dp_replicas_stay_bit_equal(name):
    state, step = _placed(MESHES[name])
    model = state["model"]
    for b in _batches():
        state, _ = step(state, b)
        for leaf, _, spec, blocks in model.leaves():
            for devs in model.copies(spec):
                assert len(devs) >= 2, leaf  # every block has a dp copy
                for d in devs[1:]:
                    assert torch.equal(blocks[d], blocks[devs[0]]), leaf


def test_grad_norm_at_dp2_is_the_unsharded_steps():
    opt = trainer.default_optimizer(LR)
    ref, ref_step = _state(opt), trainer.make_train_step(CFG, opt)
    state, step = _placed({"dp": 2}, opt)
    for b in _batches():
        ref, want = ref_step(ref, b)
        state, got = step(state, b)
        assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=1e-5)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)


def test_norm_counts_each_logical_block_once():
    """At tp=2 x dp=2 the norm weights sit on 4 devices and every matmul
    block on 2: summing the copies' squares would count them 4 and 2 times."""
    state, _ = _placed({"dp": 2, "tp": 2})
    model = state["model"]
    tokens = torch.from_numpy(_batches()[0])
    loss = trainer.cross_entropy_loss(model, tokens)
    params, grads, logical = trainer._mesh_grads(model, loss)
    assert len(params) == len(grads) == 4 * (3 + 9 * CFG.n_layers)
    assert len(logical) == 2 + 1 + 2 + CFG.n_layers * (2 + 7 * 2)  # one per distinct block
    ref = _state()
    want = torch.autograd.grad(trainer.cross_entropy_loss(ref["model"], tokens),
                               list(ref["model"].parameters()))
    total = float(torch.stack([(g.float() ** 2).sum() for g in logical]).sum().sqrt())
    every_copy = float(torch.stack([(g.float() ** 2).sum() for g in grads]).sum().sqrt())
    unsharded = float(torch.stack([(g ** 2).sum() for g in want]).sum().sqrt())
    assert total == pytest.approx(unsharded, rel=1e-5)
    assert every_copy > 1.3 * unsharded


def test_placement_mirrors_the_moments():
    state, _ = _placed({"tp": 2, "fsdp": 2})
    model, (clip, adam) = state["model"], state["opt_state"]
    params = trainer.mesh_params(model)
    assert clip == {} and adam["count"] == 0
    assert len(adam["mu"]) == len(adam["nu"]) == len(params)
    for p, mu, nu in zip(params, adam["mu"], adam["nu"]):
        assert mu.shape == nu.shape == p.shape and mu.device == p.device
        assert p.requires_grad and p.is_contiguous()


def test_release_frees_the_unsharded_state():
    state = _state()
    model, moments = state["model"], state["opt_state"][1]["mu"]
    placed = trainer.place_train_state(state, _mesh({"tp": 2}), release=True)
    assert all(p.numel() == 0 for p in model.parameters())
    assert all(m.numel() == 0 for m in moments)
    want = transformer_from_tree(_tree(), CFG, device="cpu")
    got = placed["model"].unshard()
    for a, b in zip(got.parameters(), want.parameters()):
        assert torch.equal(a, b)


def _bytes(path) -> bytes:
    return (path / "state_0" / "state.pt").read_bytes()


def test_placed_checkpoint_is_the_unsharded_one_and_resumes(tmp_path):
    opt = trainer.default_optimizer(1e-2)
    shape = {"tp": 2, "dp": 2}
    # the same bytes as the unsharded state it came from
    checkpoint.save_state(str(tmp_path / "unsharded"), _state(opt))
    checkpoint.save_state(str(tmp_path / "placed"),
                          trainer.place_train_state(_state(opt), _mesh(shape)))
    assert _bytes(tmp_path / "unsharded") == _bytes(tmp_path / "placed")
    # 4 steps in one run, against 2 steps, a checkpoint, a restore into
    # other weights, placing again and 2 steps
    batches = _batches() + _batches()[:1]
    step = trainer.make_train_step(CFG, opt, _mesh(shape))
    run = trainer.place_train_state(_state(opt), _mesh(shape))
    for b in batches:
        run, want = step(run, b)
    part = trainer.place_train_state(_state(opt), _mesh(shape))
    for b in batches[:2]:
        part, _ = step(part, b)
    checkpoint.save_state(str(tmp_path / "mid"), part)
    restored = checkpoint.restore_train_state(str(tmp_path / "mid"), device="cpu")
    assert restored["step"] == 2
    other = trainer.init_train_state(CFG, opt, device="cpu", seed=9)
    resumed = trainer.place_train_state(checkpoint.resume_train_state(other, restored),
                                        _mesh(shape))
    for b in batches[2:]:
        resumed, got = step(resumed, b)
    assert resumed["step"] == run["step"] == 4
    assert torch.equal(got["loss"], want["loss"])
    for a, b in zip(resumed["model"].unshard().parameters(), run["model"].unshard().parameters()):
        assert torch.equal(a, b)


def test_indivisible_batch_is_refused_as_jax_refuses_it():
    state, step = _placed({"dp": 2, "tp": 2})
    bad = np.ones((3, 17), np.int32)
    with pytest.raises(ValueError, match="does not split"):
        step(state, bad)
    mesh = jax_make_mesh(jax_mesh_shape_for(4, tp=2), devices=jax.devices()[:4])
    opt = jtrain.default_optimizer(LR)
    params = jax.tree.map(jnp.array, _tree())
    jstate = jtrain.place_train_state(
        {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)},
        mesh)
    with pytest.raises(ValueError):
        jtrain.make_train_step(JCFG, opt, mesh=mesh)(jstate, jnp.asarray(bad))


def test_a_quantized_model_and_a_wrong_state_are_refused():
    model = transformer_from_tree(_tree(), CFG, device="cpu").quantized("int8")
    with pytest.raises(ValueError, match="cannot train a quantized model"):
        trainer.place_train_state({"model": model, "opt_state": None, "step": 0},
                                  _mesh({"tp": 2}))
    state, step = _placed({"tp": 2})
    with pytest.raises(ValueError, match="place_train_state"):
        trainer.make_train_step(CFG, trainer.default_optimizer(LR))(state, _batches()[0])
    with pytest.raises(ValueError, match="already placed"):
        trainer.place_train_state(state, _mesh({"tp": 2}))

