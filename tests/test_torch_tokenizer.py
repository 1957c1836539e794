"""gofr_tpu_torch's tokenizer against gofr_tpu's on the same inputs: the
trainer gives equal merges; encode and decode give identical ids and text
(seeded texts, multi-byte characters split across tokens, random bytes);
merges files, special ids and the stream decoder behave alike; and HF
``tokenizer.json`` files the tests write by hand (added specials, external
ids permuted away from the internal ones, a Split regex, ByteLevel only,
no pre-tokenizer) load to identical ids. No file is downloaded."""

import json
import random
import sys
import time

import numpy as np
import pytest

from gofr_tpu import tokenizer as jtok
from gofr_tpu_torch import tokenizer as ttok
from gofr_tpu_torch.config import EnvFileConfig

CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "the quicker the fox, the lazier the dog — überraschung! "
) * 8
# Llama-3's pre-tokenizer pattern (its tokenizer.json's Split regex)
LLAMA3_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)
TEXTS = (
    "", "a", "the quick brown fox", "überraschung! the lazier dog", "  leading spaces and   runs",
    "punctuation, too! (yes?) it's 12345 o'clock",
    "emoji \U0001f680 mixed 123 ☃ é\n\nnew lines\r\n",
    CORPUS[:300],
)


def _seeded_texts(seed: int, n: int) -> list:
    """Seeded texts of corpus words and multi-byte characters."""
    rng = np.random.default_rng(seed)
    words = CORPUS.split() + ["☃", "é", "überraschung", "\U0001f680", "12", "\n", "  "]
    return [" ".join(words[i] for i in rng.integers(0, len(words), rng.integers(1, 30)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def trained():
    """(JAX tokenizer, port tokenizer), both trained on CORPUS."""
    return jtok.train_bpe(CORPUS, vocab_size=320), ttok.train_bpe(CORPUS, vocab_size=320)


def test_train_bpe_gives_equal_merges(trained):
    j, t = trained
    assert t.merges == j.merges and len(t.merges) == 320 - 256 - 3
    assert t.vocab_size == j.vocab_size


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_decode_identical_on_seeded_texts(trained, seed):
    j, t = trained
    for text in (*TEXTS, *_seeded_texts(seed, 20)):
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids) == text


def test_byte_level_roundtrip():
    j, t = jtok.Tokenizer.byte_level(), ttok.Tokenizer.byte_level()
    text = "hello wörld ☃"
    assert t.encode(text) == j.encode(text) == list(text.encode())
    assert t.decode(t.encode(text)) == text
    assert t.special_id("eos") == j.special_id("eos") == 258


def test_trained_compresses_its_corpus(trained):
    _, t = trained
    ids = t.encode(CORPUS)
    assert t.decode(ids) == CORPUS
    assert len(ids) < len(CORPUS.encode()) * 0.6


def test_random_bytes_encode_identically(trained):
    j, t = trained
    rng = random.Random(7)
    for _ in range(30):
        data = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 200)))
        assert t.encode(data) == j.encode(data), data
        assert t.decode_bytes(t.encode(data)) == data


def test_overlapping_merges():
    a = ord("a")
    j, t = jtok.Tokenizer([(a, a), (256, a)]), ttok.Tokenizer([(a, a), (256, a)])
    for text in ("aaaa", "aaa", "aaaaa", "aabaa", "a" * 37):
        assert t.encode(text) == j.encode(text), text
        assert t.decode(t.encode(text)) == text


def test_save_load_roundtrip(tmp_path, trained):
    _, t = trained
    path = str(tmp_path / "merges.txt")
    t.save(path)
    loaded = ttok.Tokenizer.from_file(path)
    assert loaded.merges == t.merges == jtok.Tokenizer.from_file(path).merges
    assert loaded.encode(CORPUS[:100]) == t.encode(CORPUS[:100])


def test_merges_file_headers_and_duplicates(tmp_path):
    path = tmp_path / "merges.txt"
    path.write_text("#version: 0.2\n104 105\n104 105\n99 100\n999999 3\n")
    t, j = ttok.Tokenizer.from_file(str(path)), jtok.Tokenizer.from_file(str(path))
    assert t.merges == j.merges == [(104, 105), (99, 100)]
    assert t.encode("hicd") == j.encode("hicd") == [256, 257]


def test_special_ids_top_of_vocab(trained):
    j, t = trained
    for name in ("pad", "bos", "eos"):
        assert t.special_id(name) == j.special_id(name)
    assert t.special_id("eos") == t.vocab_size - 1
    assert t.decode([t.special_id("pad")]) == ""
    with pytest.raises(ValueError, match="vocab_size"):
        ttok.train_bpe("abc", vocab_size=10)


def test_stream_decoder_multibyte_split(trained):
    j, t = trained
    for tok_j, tok_t in ((jtok.Tokenizer.byte_level(), ttok.Tokenizer.byte_level()), (j, t)):
        text = "héllo ☃ é überraschung \U0001f680"
        ids = tok_t.encode(text)
        dj, dt = tok_j.stream_decoder(), tok_t.stream_decoder()
        pieces = [dt.feed(i) for i in ids]
        assert pieces == [dj.feed(i) for i in ids]
        assert "".join(pieces) + dt.flush() == text
        assert "�" not in "".join(pieces)
    dec = ttok.Tokenizer.byte_level().stream_decoder()
    assert dec.feed("é".encode()[0]) == "" and dec.flush() == "�"


def test_encode_large_input_is_fast(trained):
    _, t = trained
    big = (CORPUS * 300)[:200_000]
    start = time.perf_counter()
    ids = t.encode(big)
    assert time.perf_counter() - start < 3.0, "not O(n log n)?"
    assert t.decode(ids) == big


# -- HF tokenizer.json, written by hand ------------------------------------------

def _hf_json(path, tok, pre_tokenizer, seed=0):
    """A byte-level BPE tokenizer.json over ``tok``'s merges: vocab strings
    in the GPT-2 byte alphabet, external ids a seeded permutation of the
    internal ones, the two Llama-3 specials as added tokens."""
    b2u, _ = ttok._byte_unicode_tables()

    def s(i):
        return "".join(b2u[b] for b in tok._pieces[i])

    n = 256 + len(tok.merges)
    ext = np.random.default_rng(seed).permutation(n).tolist()
    spec = {
        "version": "1.0",
        "added_tokens": [{"id": n, "content": "<|begin_of_text|>", "special": True},
                         {"id": n + 1, "content": "<|end_of_text|>", "special": True}],
        "pre_tokenizer": pre_tokenizer,
        "model": {"type": "BPE", "vocab": {s(i): ext[i] for i in range(n)},
                  "merges": [f"{s(a)} {s(b)}" for a, b in tok.merges]},
    }
    path.write_text(json.dumps(spec))
    return str(path)


PRE_TOKENIZERS = {
    "llama3-split": {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
         "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
         "use_regex": False}]},
    "byte-level-only": {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True},
    "none": None,
}


@pytest.mark.parametrize("pre", sorted(PRE_TOKENIZERS))
def test_hf_json_gives_identical_ids(tmp_path, trained, pre):
    path = _hf_json(tmp_path / "tokenizer.json", trained[1], PRE_TOKENIZERS[pre])
    j, t = jtok.Tokenizer.from_hf_json(path), ttok.Tokenizer.from_hf_json(path)
    for text in (*TEXTS, *_seeded_texts(3, 15)):
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids) == text
        assert t.decode_bytes(ids) == j.decode_bytes(ids)
    assert t.vocab_size == j.vocab_size
    for name in ("bos", "eos"):
        assert t.special_id(name) == j.special_id(name)
    assert t.token_id("<|end_of_text|>") == j.token_id("<|end_of_text|>")
    with pytest.raises(ValueError, match="no pad"):
        t.special_id("pad")
    # the stream decoder skips specials, as the JAX one does
    ids = [t.special_id("bos"), *t.encode("the fox ☃")]
    dt, dj = t.stream_decoder(), j.stream_decoder()
    assert [dt.feed(i) for i in ids] == [dj.feed(i) for i in ids]
    assert dt.flush() == dj.flush()


def test_hf_json_split_regex_needs_the_regex_package(tmp_path, trained, monkeypatch):
    path = _hf_json(tmp_path / "tokenizer.json", trained[1], PRE_TOKENIZERS["llama3-split"])
    monkeypatch.setitem(sys.modules, "regex", None)  # import regex now raises
    with pytest.raises(RuntimeError, match="regex"):
        ttok.Tokenizer.from_hf_json(path)
    # a file without a pre-tokenizer needs no regex
    plain = _hf_json(tmp_path / "plain.json", trained[1], None)
    assert ttok.Tokenizer.from_hf_json(plain).encode("the fox")


def test_hf_json_rejects_non_bpe(tmp_path):
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps({"model": {"type": "Unigram", "vocab": []}}))
    with pytest.raises(ValueError, match="Unigram"):
        ttok.Tokenizer.from_hf_json(str(path))


def test_load_tokenizer_routes_tokenizer_path(tmp_path, trained, monkeypatch):
    from gofr_tpu.config import EnvConfig

    hf = _hf_json(tmp_path / "tokenizer.json", trained[1], PRE_TOKENIZERS["byte-level-only"])
    merges = str(tmp_path / "merges.txt")
    trained[1].save(merges)
    for path in (hf, merges):
        monkeypatch.setenv("TOKENIZER_PATH", path)
        t = ttok.load_tokenizer(EnvFileConfig(str(tmp_path)))
        j = jtok.load_tokenizer(EnvConfig())
        assert (t._ext_of is None) == (j._ext_of is None) == (path == merges)
        assert t.encode(CORPUS[:200]) == j.encode(CORPUS[:200])
    monkeypatch.delenv("TOKENIZER_PATH")
    monkeypatch.setenv("TOKENIZER", "byte")
    assert ttok.load_tokenizer(EnvFileConfig(str(tmp_path))).merges == []
