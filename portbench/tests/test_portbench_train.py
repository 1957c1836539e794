"""The training cell's check on the CPU at a tiny size (the look for a
card skipped): a sound run reads ``correct``, the float8 control reads far
above it, and each fault a training step can have reads incorrect."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import make_checkout

from portbench import run, spec


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: the AdamW update applies
    nothing (its count still advances)."""
    from gofr_tpu_torch.training import optim

    def idle(self, grads, state, params, norm=None):
        state["count"] += 1

    monkeypatch.setattr(optim.adamw, "update", idle)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from gofr_tpu_torch.training import trainer

    loss = trainer.cross_entropy_loss

    def half(model, tokens, loss_mask=None, remat=False):
        return loss(model, tokens[: tokens.shape[0] // 2], loss_mask, remat)

    monkeypatch.setattr(trainer, "cross_entropy_loss", half)


def test_sound_step_is_correct(tmp_path):
    root = make_checkout(tmp_path, mix="train", cell="tiny.train")
    out = run.execute("tiny.train", 2**34 + 1, 1.0, False, root, device="cpu", control=True)
    assert out["correct"], out["checked"]
    f = out["found"]
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert f[f"control_{name}"] > 10 * max(f[name], 1e-7), name
    assert out["e2e"]["train_tokens_per_s"] > 0 and out["e2e"]["failed"] == 0


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state-unchanged", "half-batch"])
def test_fault_reads_incorrect(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    root = make_checkout(tmp_path, mix="train", cell="tiny.train")
    out = run.execute("tiny.train", 2**34 + 2, 1.0, False, root, device="cpu")
    assert not out["correct"], out["checked"]


def test_batches_differ_and_repeat():
    mix = {"kind": "train_packed", "batch": 4, "seq": 2049, "eos": 2,
           "document": {"median": 1024, "sigma": 1.0, "min": 32, "max": 8192}}
    gen = spec.generator("train_packed")
    a = gen.plan(mix, 32768, 2**40, 30)["batches"]
    b = gen.plan(mix, 32768, 2**40, 30)["batches"]
    x0, x1 = a.batch(0), a.batch(1)
    assert x0.shape == (4, 2049) and np.array_equal(x0, b.batch(0))
    rows = {r.tobytes() for r in np.concatenate([x0, x1])}
    assert len(rows) == 8
    assert (x0 == 2).sum() >= 4  # end-of-sequence ids between documents
