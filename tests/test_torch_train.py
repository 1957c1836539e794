"""gofr_tpu_torch.training against the JAX package's trainer: the loss,
the optimizer against optax, the first step's loss and gradients and a
3-step trajectory against ``gofr_tpu.training.trainer`` (whose attention
runs the Pallas forward and fused backward in interpret mode), remat,
the data pipeline and checkpoint resume. All f32, on the CPU: the port's
attention backward there is the kernels' plain version.

Weights start in JAX (``init_transformer``) and cross through
``models/convert.py``; tokens and gradients are made with numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu.models import transformer as jt
from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu.training import trainer as jtrain
from gofr_tpu.training.data import TokenDataset as JaxTokenDataset
from gofr_tpu_torch.models.convert import transformer_from_tree, tree_from_transformer
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.ops.loss import next_token_nll
from gofr_tpu_torch.training import checkpoint, optim, trainer
from gofr_tpu_torch.training.data import (
    TokenDataset,
    corpus_to_bin,
    dtype_for_vocab,
    prefetch_to_device,
)

JAX_CFG = dataclasses.replace(JAX_TINY, attn_impl="pallas")


@pytest.fixture(scope="module")
def tree():
    """The JAX initial weights as numpy (the JAX train step donates its
    arrays, so each test takes fresh copies)."""
    return jax.tree.map(np.asarray, jt.init_transformer(jax.random.PRNGKey(0), JAX_CFG))


def _jax_params(tree):
    return jax.tree.map(jnp.array, tree)


def _model(tree):
    return transformer_from_tree(tree, TINY, device="cpu")


def _tokens(seed, shape=(2, 17)):
    return np.random.default_rng(seed).integers(0, TINY.vocab_size, shape).astype(np.int32)


def test_next_token_nll_matches_jax():
    from gofr_tpu.ops.loss import next_token_nll as jax_nll

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 33), dtype=np.float32) * 4
    targets = rng.integers(0, 33, (2, 5)).astype(np.int32)
    want = np.asarray(jax_nll(jnp.asarray(logits), jnp.asarray(targets)))
    got = next_token_nll(torch.from_numpy(logits), torch.from_numpy(targets))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# -- the optimizer against optax -------------------------------------------------

_SHAPES = {"w": (6, 5), "norm": (5,), "b": (3, 2, 4)}


def _run_optimizers(make_optax, make_port, grad_scales, seed=0):
    """Apply the same numpy grads to the same params through optax and the
    port; return both parameter sets after each update."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s, dtype=np.float32) for k, s in _SHAPES.items()}
    jp = jax.tree.map(jnp.asarray, params)
    tx = make_optax()
    jstate = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in _SHAPES]
    opt = make_port()
    tstate = opt.init(tp)
    out = []
    for scale in grad_scales:
        grads = {k: rng.standard_normal(s, dtype=np.float32) * scale for k, s in _SHAPES.items()}
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.from_numpy(grads[k].copy()) for k in _SHAPES], tstate, tp)
        out.append(([np.asarray(jp[k]) for k in _SHAPES], [t.numpy().copy() for t in tp]))
    return out


def _assert_params(out, tol=1e-6):
    for want, got in out:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["under_max_norm", "clipped"])
def test_default_optimizer_matches_optax(grad_scale):
    # global norms of ~0.03 and ~30 against max_norm 1: the clip both ways
    out = _run_optimizers(
        lambda: jtrain.default_optimizer(1e-2), lambda: trainer.default_optimizer(1e-2),
        [grad_scale] * 4,
    )
    _assert_params(out)


def test_clip_rule_is_optax_without_epsilon():
    g = [torch.tensor([3.0, 4.0])]  # norm 5
    optim.clip_by_global_norm(1.0).update(g, {}, [])
    np.testing.assert_array_equal(g[0].numpy(), np.array([3.0, 4.0], np.float32) / 5.0)
    g = [torch.tensor([0.3, 0.4])]  # norm 0.5 < 1: untouched
    optim.clip_by_global_norm(1.0).update(g, {}, [])
    np.testing.assert_array_equal(g[0].numpy(), np.array([0.3, 0.4], np.float32))


def test_warmup_cosine_first_update_uses_lr_zero():
    out = _run_optimizers(
        lambda: jtrain.warmup_cosine_optimizer(1e-2, total_steps=20, warmup_steps=4),
        lambda: trainer.warmup_cosine_optimizer(1e-2, total_steps=20, warmup_steps=4),
        [1.0] * 7,
    )
    _assert_params(out)
    rng = np.random.default_rng(0)
    init = [rng.standard_normal(s, dtype=np.float32) for s in _SHAPES.values()]
    for p0, p1 in zip(init, out[0][1]):
        np.testing.assert_array_equal(p0, p1)  # lr(0) = 0: nothing moved
    assert not np.array_equal(init[0], out[1][1][0])


def test_schedule_matches_optax():
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 5, 50, 1e-3)
    got = optim.warmup_cosine_decay_schedule(0.0, 1e-2, 5, 50, 1e-3)
    for count in (0, 1, 3, 5, 6, 20, 49, 50, 80):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12)


def test_weight_decay_reaches_norm_weights():
    # zero grads: the only update is -lr * wd * p, on 1-D norm weights too
    out = _run_optimizers(
        lambda: optax.adamw(1e-1, b1=0.9, b2=0.95, weight_decay=0.5),
        lambda: optim.adamw(1e-1, b1=0.9, b2=0.95, weight_decay=0.5),
        [0.0] * 3,
    )
    _assert_params(out)
    rng = np.random.default_rng(0)
    init = [rng.standard_normal(s, dtype=np.float32) for s in _SHAPES.values()]
    np.testing.assert_allclose(out[0][1][1], init[1] * (1 - 0.1 * 0.5), rtol=1e-6)


# -- train steps against the JAX trainer -------------------------------------------

def test_first_step_loss_and_grads_match_jax(tree):
    tokens = _tokens(3)
    loss, grads = jax.value_and_grad(jtrain.cross_entropy_loss)(
        _jax_params(tree), jnp.asarray(tokens), JAX_CFG
    )
    model = _model(tree)
    trainer.init_train_state_from(model, trainer.default_optimizer())
    got = trainer.cross_entropy_loss(model, torch.from_numpy(tokens))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    for p in model.parameters():
        p.data = p.grad  # read the grads in the JAX tree layout
    want = jax.tree.map(np.asarray, grads)
    got_tree = tree_from_transformer(model)
    for key in ("embed", "norm_f", "lm_head"):
        np.testing.assert_allclose(got_tree[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)
    for key, w in want["layers"].items():
        np.testing.assert_allclose(got_tree["layers"][key], w, rtol=1e-4, atol=1e-5, err_msg=key)


def test_three_steps_match_jax_make_train_step(tree):
    # lr 1e-4: Adam divides each grad by its own running RMS, so a grad
    # entry near zero where the two frameworks' f32 sums differ in the last
    # bits can move by up to lr in one and not the other. Parameters are
    # held to 3 * lr (three steps), loss and grad norm to 1e-5 relative.
    lr = 1e-4
    batches = [_tokens(10 + i) for i in range(3)]
    opt = jtrain.default_optimizer(lr)
    step = jtrain.make_train_step(JAX_CFG, opt)
    params = _jax_params(tree)
    jstate = {"params": params, "opt_state": opt.init(params),
              "step": jnp.zeros((), jnp.int32)}
    want = []
    for b in batches:
        jstate, m = step(jstate, jnp.asarray(b))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    state = trainer.init_train_state_from(_model(tree), trainer.default_optimizer(lr))
    tstep = trainer.make_train_step(TINY, trainer.default_optimizer(lr))
    for b, (w_loss, w_norm) in zip(batches, want):
        state, m = tstep(state, b)
        assert float(m["loss"]) == pytest.approx(w_loss, rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(w_norm, rel=1e-5)
    assert state["step"] == 3 == int(jstate["step"])
    got_tree = tree_from_transformer(state["model"])
    jtree = jax.tree.map(np.asarray, jstate["params"])
    for key in ("embed", "norm_f", "lm_head"):
        np.testing.assert_allclose(got_tree[key], jtree[key], rtol=0, atol=3 * lr, err_msg=key)
    for key, w in jtree["layers"].items():
        np.testing.assert_allclose(got_tree["layers"][key], w, rtol=0, atol=3 * lr, err_msg=key)


def test_remat_equals_no_remat_exactly(tree):
    tokens = torch.from_numpy(_tokens(4))
    results = []
    for remat in (False, True):
        model = _model(tree)
        trainer.init_train_state_from(model, trainer.default_optimizer())
        loss = trainer.cross_entropy_loss(model, tokens, remat=remat)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append((loss, grads))
    assert torch.equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)


def test_loss_mask_weights_the_mean(tree):
    tokens = _tokens(5)
    mask = np.ones((2, 16), np.float32)
    mask[1, 9:] = 0
    want = jtrain.cross_entropy_loss(tree, jnp.asarray(tokens), JAX_CFG, jnp.asarray(mask))
    with torch.no_grad():
        got = trainer.cross_entropy_loss(
            _model(tree), torch.from_numpy(tokens), torch.from_numpy(mask)
        )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_train_step_from_seed_on_cpu_learns():
    opt = trainer.warmup_cosine_optimizer(1e-2, total_steps=50, warmup_steps=2)
    state = trainer.init_train_state(TINY, opt, device="cpu", seed=0)
    assert all(p.requires_grad for p in state["model"].parameters())
    step = trainer.make_train_step(TINY, opt)
    tokens = _tokens(6, (4, 17))
    losses = [float(step(state, tokens)[1]["loss"]) for _ in range(6)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


# -- data ------------------------------------------------------------------------

def test_token_dataset_batches_match_jax():
    tokens = np.arange(3000) % 251
    for seed in (0, 7):
        ours = TokenDataset(tokens, seq_len=17, batch_size=3, seed=seed)
        theirs = JaxTokenDataset(tokens, seq_len=17, batch_size=3, seed=seed)
        for step in (0, 1, 5, 2**33 + 1):
            np.testing.assert_array_equal(ours.batch(step), theirs.batch(step))


class _BigVocab:
    vocab_size = 100_000

    def encode(self, text):
        return [(ord(c) * 997) % self.vocab_size for c in text]


def test_uint32_corpus_round_trips_through_both_readers(tmp_path):
    path = str(tmp_path / "corpus.bin")
    assert dtype_for_vocab(100_000) == np.uint32 and dtype_for_vocab(65536) == np.uint16
    n = corpus_to_bin("the port reads what the reference reads " * 20, _BigVocab(), path)
    ours = TokenDataset(path, seq_len=9, batch_size=2, seed=3)
    theirs = JaxTokenDataset(path, seq_len=9, batch_size=2, seed=3)
    assert len(ours) == n and ours.tokens.dtype == np.uint32
    assert ours.batch(4).max() >= 65536
    np.testing.assert_array_equal(ours.batch(4), theirs.batch(4))
    with pytest.raises(ValueError, match="uint32"):
        corpus_to_bin("x", _BigVocab(), path, dtype=np.uint16)


def test_prefetch_keeps_order_and_passes_errors():
    ds = TokenDataset(np.arange(500) % 200, seq_len=4, batch_size=2, seed=1)
    want = [ds.batch(i) for i in range(5)]
    got = list(prefetch_to_device(iter(want), size=2, device="cpu"))
    assert len(got) == 5 and all(isinstance(t, torch.Tensor) for t in got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())

    def failing():
        yield want[0]
        raise RuntimeError("producer broke")

    it = prefetch_to_device(failing(), size=2, device="cpu")
    np.testing.assert_array_equal(next(it).numpy(), want[0])
    with pytest.raises(RuntimeError, match="producer broke"):
        next(it)


# -- checkpoints -----------------------------------------------------------------

def test_resume_matches_uninterrupted_run(tree, tmp_path):
    batches = [_tokens(20 + i) for i in range(4)]
    opt = trainer.default_optimizer(1e-2)
    step = trainer.make_train_step(TINY, opt)

    s = trainer.init_train_state_from(_model(tree), opt)
    for b in batches:
        s, ref_metrics = step(s, b)

    s2 = trainer.init_train_state_from(_model(tree), opt)
    for b in batches[:2]:
        s2, _ = step(s2, b)
    checkpoint.save_train_state(
        str(tmp_path), s2["model"].state_dict(), s2["opt_state"], s2["step"]
    )
    assert checkpoint.latest_step(str(tmp_path)) == 2
    (tmp_path / "state_3.gofr-tmp-12345").mkdir()  # a save cut short
    (tmp_path / "state_x").mkdir()
    assert checkpoint.latest_step(str(tmp_path)) == 2
    restored = checkpoint.restore_train_state(str(tmp_path), device="cpu")
    assert restored["step"] == 2

    s3 = trainer.init_train_state(TINY, opt, device="cpu", seed=9)  # other weights
    checkpoint.resume_train_state(s3, restored)
    for b in batches[2:]:
        s3, metrics = step(s3, b)
    assert s3["step"] == 4
    assert torch.equal(metrics["loss"], ref_metrics["loss"])
    for (name, a), b in zip(s["model"].state_dict().items(), s3["model"].state_dict().values()):
        assert torch.equal(a, b), name


def test_params_round_trip(tree, tmp_path):
    model = _model(tree)
    checkpoint.save_params(str(tmp_path), model.state_dict())
    checkpoint.save_params(str(tmp_path), model.state_dict())  # a save replaces
    restored = checkpoint.restore_params(str(tmp_path), device="cpu")
    for name, t in model.state_dict().items():
        assert torch.equal(restored[name], t), name
    assert checkpoint.latest_step(str(tmp_path)) is None
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(str(tmp_path), device="cpu")
