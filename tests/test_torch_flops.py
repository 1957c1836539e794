"""gofr_tpu_torch's FLOPs accounting (``tpu/flops.py``) against gofr_tpu's:
the parameter counts of llama3-8b, tiny and small (the decoder) and
bert-base and bert-tiny, ``mfu`` / ``mfu_from_flops`` / ``mbu`` /
``mbu_from_bytes`` / ``train_mfu`` on the same inputs, and ``tree_bytes``
over the same weights (bf16, int8 and int4 packs: the port's int4 buffer
holds two values a byte, as the JAX count does); then the port's NVIDIA
table: the H100 SXM's data-sheet peaks, w8a8 at the int8 rate, and a
labelled nominal default for a card the table does not know."""

import jax
import numpy as np
import pytest

from gofr_tpu.models import bert as jbert
from gofr_tpu.models import llama as jllama
from gofr_tpu.models.quant import quantize_params
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.tpu import flops as jf
from gofr_tpu_torch.models import bert as tbert
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.tpu import flops as tf


@pytest.mark.parametrize("name", ["LLAMA3_8B", "TINY", "SMALL"])
def test_transformer_param_count_matches_jax(name):
    got = tf.transformer_param_count(getattr(tllama, name))
    assert got == jf.transformer_param_count(getattr(jllama, name))
    if name == "LLAMA3_8B":
        assert got == 8_030_261_248  # N behind PERF.md's MFU predictions


@pytest.mark.parametrize("name", ["BERT_BASE", "BERT_TINY"])
def test_bert_param_count_matches_jax(name):
    cfg = getattr(tbert, name)
    jcfg = jbert.BertConfig(vocab_size=cfg.vocab_size, dim=cfg.dim, n_layers=cfg.n_layers,
                            n_heads=cfg.n_heads, hidden_dim=cfg.hidden_dim, max_seq=cfg.max_seq)
    assert tf.bert_param_count(cfg) == jf.bert_param_count(jcfg)


CASES = [(8_030_261_248, 4096, 0.11692, 989e12), (1000, 3.5, 0.0, 1e9), (5, 7, 2.0, 0.0),
         (2_000_000, 31, 0.38, 197e12)]


@pytest.mark.parametrize("n,tokens,seconds,peak", CASES)
def test_mfu_and_mbu_match_jax(n, tokens, seconds, peak):
    assert tf.mfu(n, tokens, seconds, peak) == jf.mfu(n, tokens, seconds, peak)
    assert tf.train_mfu(n, tokens, seconds, peak) == jf.train_mfu(n, tokens, seconds, peak)
    assert tf.mfu_from_flops(n * tokens, seconds, peak) == \
        jf.mfu_from_flops(n * tokens, seconds, peak)
    assert tf.mbu(n * 2.0, seconds, peak / 100) == jf.mbu(n * 2.0, seconds, peak / 100)
    assert tf.mbu_from_bytes(n, seconds, peak) == jf.mbu_from_bytes(n, seconds, peak)


def test_the_predictions_arithmetic():
    """PERF.md's predictions from §5's measurements (H100 SXM peaks)."""
    n = tf.transformer_param_count(tllama.LLAMA3_8B)
    assert tf.mfu(n, 4 * 1024, 0.11692, 989e12) == pytest.approx(0.569, abs=1e-3)
    assert tf.mbu(8 * 16.061e9, 0.38, 3.35e12) == pytest.approx(0.101, abs=1e-3)
    assert tf.mbu(16.061e9, 9.385e-3, 3.35e12) == pytest.approx(0.511, abs=1e-3)


@pytest.mark.parametrize("quant", [False, "int8", "int4"])
def test_tree_bytes_matches_jax(quant):
    params = init_transformer(jax.random.key(0), jllama.TINY)
    if quant:
        params = quantize_params(params, quant)
    host = jax.tree.map(np.asarray, params)
    model = transformer_from_tree(host, tllama.TINY, device="cpu")
    assert tf.tree_bytes(model) == jf.tree_bytes(params) == model.weight_bytes()
    # a tensor reachable twice counts once; containers walk
    assert tf.tree_bytes({"a": model.embed, "b": [model.embed]}) == model.embed.nbytes


def test_nvidia_peaks():
    assert tf.device_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12, "table")
    assert tf.device_peak_flops("NVIDIA H100 80GB HBM3", quant="w8a8") == 2 * 989e12
    assert tf.device_peak_hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    assert tf.device_peaks("Some Future Card")[2] == "nominal"
    assert tf.device_peaks("cpu", "cpu") == (100e9, 50e9, "nominal")
    assert tf.device_peak_flops("cpu", "cpu", quant="w8a8") == 100e9
    assert tf.device_peak_flops("cpu", "cpu") == jf.device_peak_flops("cpu", "cpu")
    assert tf.device_peak_hbm_bw("cpu", "cpu") == jf.device_peak_hbm_bw("cpu", "cpu")
