"""The check that decides ``correct`` fails a broken timed path: a run on
the CPU at a tiny size (the look for a card skipped), with the path broken
underneath, reads ``correct`` false for each fault a served cell can have,
and true unbroken. The control (the reference in float8 weights) reads far
above the program on the same requests."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import make_checkout

from portbench import run


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: the decode pool delivers each
    fetched chunk's ids shifted by one."""
    from gofr_tpu_torch.tpu import decode_pool

    deliver = decode_pool.DecodePool._deliver

    def shifted(self, records, toks, *a, **kw):
        return deliver(self, records, (np.asarray(toks) + 1) % self.model.cfg.vocab_size, *a, **kw)

    monkeypatch.setattr(decode_pool.DecodePool, "_deliver", shifted)


def _state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: the step's keys and
    values go to a copy of the cache, so the cache never holds them."""
    from gofr_tpu_torch.models import transformer

    attn_half = transformer.Transformer._attn_half

    def stale(self, layer, x, positions, n_heads, n_kv_heads, kv_cache=None, *a, **kw):
        if kv_cache is not None and x.shape[1] == 1:
            kv_cache = (kv_cache[0].clone(), kv_cache[1].clone())
        return attn_half(self, layer, x, positions, n_heads, n_kv_heads, kv_cache, *a, **kw)

    monkeypatch.setattr(transformer.Transformer, "_attn_half", stale)


@pytest.mark.parametrize("mix", ["open", "closed"])
def test_sound_run_is_correct(tmp_path, mix):
    root = make_checkout(tmp_path, mix=mix, kv_heads=4 if mix == "closed" else 2)
    out = run.execute("tiny.cell", 2**35 + 3, 2.0, False, root, device="cpu", control=True)
    assert out["correct"], out["checked"]
    found = out["found"]
    assert found["tokens"] >= 24
    # the control reads at least a hundred times what the program does
    assert found["control_logprob_err"] > 100 * max(found["logprob_err"], 1e-6)
    assert found["control_logprob_err"] > out["checked"]["logprob_err"]["limit"]


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged],
                         ids=["token-altered", "state-unchanged"])
@pytest.mark.parametrize("mix", ["open", "closed"])
def test_fault_reads_incorrect(tmp_path, monkeypatch, fault, mix):
    fault(monkeypatch)
    root = make_checkout(tmp_path, mix=mix)
    out = run.execute("tiny.cell", 2**35 + 4, 2.0, False, root, device="cpu")
    assert not out["correct"], out["checked"]


def test_the_program_control_keys_reach_the_program_and_stay_with_the_run(tmp_path, monkeypatch):
    """A limits file's ``program_control`` keys serve the run with them
    (here a float8 cache: the tiny float32 model then reads far above its
    limits), and the next run is served without them."""
    import json
    import os

    monkeypatch.delenv("MODEL_KV_DTYPE", raising=False)
    root = make_checkout(tmp_path, mix="closed")
    path = root / "portbench" / "limits" / "tiny.cell.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "program_control": {"MODEL_KV_DTYPE": "f8"}}))
    out = run.execute("tiny.cell", 2**35 + 5, 2.0, False, root, device="cpu",
                      program_control=True)
    assert not out["correct"], out["checked"]
    assert "MODEL_KV_DTYPE" not in os.environ
    assert run.execute("tiny.cell", 2**35 + 5, 2.0, False, root, device="cpu")["correct"]
