"""gofr_tpu_torch against the HF ecosystem (tests/test_golden_hf.py's
checks, on the port): a random ``LlamaForCausalLM`` shaped like ``tiny``,
written by ``transformers.save_pretrained``, loads through the port's
``MODEL_PATH`` ingest and teacher-forces the logits and logprobs HF's
torch forward computes; and the port's ``Tokenizer.from_hf_json`` encodes
exactly as the ``tokenizers`` library on a ``tokenizer.json`` trained
here. Nothing is downloaded. The tolerance is tests/test_golden_hf.py's,
2e-3 (f32 logits: a convention mismatch in the RoPE layout, the norm, GQA
grouping or a transpose diverges by O(1))."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.models.ingest import load_llama_params
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.tokenizer import Tokenizer
from gofr_tpu_torch.tpu.device import TPUDevice

# imported inside the tests (collection stays cheap for every worker)
pytestmark = pytest.mark.skipif(
    importlib.util.find_spec("transformers") is None
    or importlib.util.find_spec("tokenizers") is None,
    reason="needs the transformers and tokenizers libraries",
)

TOL = 2e-3
PROMPT = [1, 5, 9, 33, 77, 2, 64, 100, 42, 7]


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """(checkpoint dir, HF logits [S, V] f32) of a random HF Llama shaped
    like the port's ``tiny``."""
    with pytest.MonkeyPatch.context() as mp:
        # the torch classes alone: no TensorFlow or Flax import
        mp.setenv("USE_TF", "0")
        mp.setenv("USE_FLAX", "0")
        from transformers import LlamaConfig, LlamaForCausalLM

    hf_cfg = LlamaConfig(
        vocab_size=TINY.vocab_size, hidden_size=TINY.dim, intermediate_size=TINY.hidden_dim,
        num_hidden_layers=TINY.n_layers, num_attention_heads=TINY.n_heads,
        num_key_value_heads=TINY.n_kv_heads, max_position_embeddings=TINY.max_seq,
        rope_theta=TINY.rope_theta, rms_norm_eps=TINY.norm_eps, tie_word_embeddings=False,
        attention_bias=False, mlp_bias=False,
    )
    torch.manual_seed(0)
    model = LlamaForCausalLM(hf_cfg).eval()
    path = tmp_path_factory.mktemp("hf_ckpt")
    model.save_pretrained(str(path), safe_serialization=True)
    with torch.no_grad():
        logits = model(torch.tensor([PROMPT])).logits[0].float().numpy()
    return str(path), logits


def test_hf_checkpoint_golden_logits(hf_checkpoint):
    path, hf_logits = hf_checkpoint
    model = load_llama_params(path, TINY, device="cpu")
    with torch.no_grad():
        ours = model.transformer_forward(torch.tensor([PROMPT], dtype=torch.int32))[0]
    np.testing.assert_allclose(ours.float().numpy(), hf_logits, rtol=TOL, atol=TOL)


def test_hf_checkpoint_golden_teacher_forced_logprobs(hf_checkpoint, monkeypatch):
    """The serving form of the same check: ``TPUDevice.score`` (echo +
    logprobs' primitive) booted through ``MODEL_PATH`` reproduces HF's
    log p(t_i | t_<i)."""
    path, hf_logits = hf_checkpoint
    want = torch.log_softmax(torch.tensor(hf_logits), dim=-1).numpy()
    golden = [float(want[i - 1, PROMPT[i]]) for i in range(1, len(PROMPT))]
    for key in DECLARED_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in {"MODEL_NAME": "tiny", "TORCH_DEVICE": "cpu",
                       "MODEL_PATH": os.path.join(path, "model.safetensors"),
                       "DECODE_POOL": "off"}.items():
        monkeypatch.setenv(key, value)
    dev = TPUDevice(EnvFileConfig("/nonexistent"), Logger(Level.FATAL))
    try:
        got = dev.score(PROMPT)
    finally:
        dev.close()
    np.testing.assert_allclose(got, golden, rtol=TOL, atol=TOL)


def test_tokenizer_matches_hf_tokenizers_library(tmp_path):
    """``from_hf_json`` encodes exactly as ``tokenizers`` on a byte-level
    BPE trained by that library in-process, and decodes alike."""
    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tok = HFTokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    corpus = [
        "the quick brown fox jumps over the lazy dog",
        "hello world, hello GPU serving",
        "pack my box with five dozen liquor jugs",
    ]
    tok.train_from_iterator(corpus, trainer)
    path = str(tmp_path / "tokenizer.json")
    tok.save(path)
    ours = Tokenizer.from_hf_json(path)
    for text in corpus + ["unseen zebra text!", "  spaces  and\ttabs", "ünïcödé ✓ 漢字"]:
        want = tok.encode(text).ids
        got = ours.encode(text)
        assert got == want, (text, got, want)
        assert ours.decode(got) == tok.decode(want, skip_special_tokens=False)
