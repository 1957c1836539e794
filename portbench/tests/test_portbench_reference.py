"""The plain reference against the port's decoder on the CPU, float32, at
a tiny grouped-query (GQA) and a tiny multi-head (MHA) configuration, and
its float8 control against it."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_config

from portbench import weights
from portbench.references import decoder


def _port_logits(m: dict, seed: int, seq: list) -> torch.Tensor:
    from gofr_tpu_torch.models.transformer import Transformer, TransformerConfig

    cfg = TransformerConfig(vocab_size=m["vocab_size"], dim=m["dim"], n_layers=m["n_layers"],
                            n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"],
                            hidden_dim=m["hidden_dim"], max_seq=m["max_seq"],
                            rope_theta=m["rope_theta"], norm_eps=m["norm_eps"],
                            dtype=torch.float32)
    model = Transformer(cfg, "cpu")
    weights.fill(model, m, seed)
    return model.transformer_forward(torch.tensor([seq]))[0]


@pytest.mark.parametrize("kv_heads", [2, 4], ids=["gqa", "mha"])
def test_reference_matches_the_port(kv_heads):
    m = weights.dims(tiny_config(kv_heads))
    seed = 2**36 + 9
    seqs = [list(range(5, 90)), [7, 3, 500, 1, 2] * 9]
    wanted = [list(range(len(s))) for s in seqs]
    ref = decoder.logits_at(m, seed, seqs, wanted, torch.device("cpu"), rows=16)
    for s, r in zip(seqs, ref):
        port = _port_logits(m, seed, s)
        assert torch.allclose(r, port, atol=1e-4, rtol=1e-4), float((r - port).abs().max())


def test_control_departs():
    m = weights.dims(tiny_config(2))
    seq = [list(range(3, 120))]
    wanted = [list(range(117))]
    ref = decoder.logits_at(m, 11, seq, wanted, torch.device("cpu"))[0]
    ctl = decoder.logits_at(m, 11, seq, wanted, torch.device("cpu"), weights="fp8")[0]
    gap = (ctl.log_softmax(-1) - ref.log_softmax(-1)).abs().max()
    assert float(gap) > 0.05


def test_weights_regenerate_bit_for_bit():
    m = weights.dims(tiny_config(2))
    a = weights.draw_group(m, 5, 3, "layer", torch.device("cpu"))
    b = weights.draw_group(m, 5, 3, "layer", torch.device("cpu"))
    c = weights.draw_group(m, 6, 3, "layer", torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], c["wq"])
    assert all(torch.equal(v, v.to(torch.bfloat16).float()) for v in a.values())
