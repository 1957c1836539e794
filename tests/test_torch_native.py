"""The port's native host library (``gofr_tpu_torch/native/``, built from
``gofr_tpu_torch/csrc/tokenizer.cpp``) against the port's Python paths and
the JAX package's native library (``gofr_tpu/native/``, built from the
repo's ``native/tokenizer.cpp``).

- The library builds here (g++ is in this image), and its source is the
  repo's, byte for byte.
- Encode and decode: the port's native backend equals its Python backend
  and the JAX package's native backend on ``tests/test_tokenizer.py``'s
  cases (a trained corpus, overlapping merges, a seeded random corpus,
  multibyte stream decode, the merges file's headers and duplicates, the
  direct-ABI robustness case). The port decodes in Python on both.
- ``pack_token_rows`` (numpy in the port), the library's
  ``gofr_pack_rows`` and the JAX package's pack give the same arrays on
  ``tests/test_scheduler.py``'s edge cases.
- ``GOFR_NATIVE_DISABLE``, ``GOFR_NATIVE_LIB`` and ``GOFR_NATIVE_CACHE``
  do in the port what they do in the JAX package.

Ids and packed arrays must match exactly.
"""

import ctypes
import random
import threading
from pathlib import Path

import numpy as np
import pytest

import gofr_tpu.native as jax_native
import gofr_tpu_torch.native as native
from gofr_tpu.tokenizer import Tokenizer as JaxTokenizer
from gofr_tpu.tpu.batcher import pack_token_rows as jax_pack
from gofr_tpu_torch.tokenizer import Tokenizer, train_bpe
from gofr_tpu_torch.tpu import batcher

REPO = Path(__file__).resolve().parents[1]
CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "the quicker the fox, the lazier the dog — überraschung! "
) * 8


@pytest.fixture(scope="module")
def trained():
    return train_bpe(CORPUS, vocab_size=320)


def _python_twin(tok: Tokenizer) -> Tokenizer:
    twin = Tokenizer(tok.merges, tok.n_special)
    twin._native = None  # the Python path
    return twin


@pytest.fixture
def fresh(monkeypatch):
    """Both loaders untried, so a test's environment decides what they load."""
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_lib_tried", False)
    for key in ("GOFR_NATIVE_LIB", "GOFR_NATIVE_CACHE", "GOFR_NATIVE_DISABLE"):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


# -- the library and its source ----------------------------------------------------

def test_native_library_builds():
    assert native.load() is not None, "g++ is in this image: the library must build"
    assert Path(native.load()._name).parent == native.BUILD_DIR


def test_source_is_the_repos_tokenizer_cpp():
    assert native.SOURCE.read_bytes() == (REPO / "native" / "tokenizer.cpp").read_bytes()


def test_two_threads_build_one_library(fresh, tmp_path):
    """g++ runs outside the lock into a per-process, per-thread file that
    is renamed into place: two builders meet, one library results."""
    fresh.setenv("GOFR_NATIVE_CACHE", str(tmp_path))
    paths: list = []
    threads = [threading.Thread(target=lambda: paths.append(native._build())) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert paths[0] is not None and paths[0] == paths[1]
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]  # no temporary left
    assert ctypes.CDLL(str(paths[0])).gofr_pack_rows


# -- encode and decode ---------------------------------------------------------------

def _three_ways(merges: list, texts: list) -> None:
    """Native port, Python port and native JAX: the same ids and text."""
    port = Tokenizer(merges)
    python = _python_twin(port)
    jax = JaxTokenizer(merges)
    assert port.backend == jax.backend == "native" and python.backend == "python"
    for text in texts:
        ids = port.encode(text)
        assert ids == python.encode(text) == jax.encode(text), text
        assert port.decode(ids) == python.decode(ids) == jax.decode(ids)
        assert port.decode_bytes(ids) == python.decode_bytes(ids)


def test_trained_corpus_three_ways(trained):
    _three_ways(trained.merges, ["", "a", CORPUS[:200], "emoji \U0001f680 mixed 123",
                                 "\x00\xff binary", CORPUS])


def test_overlapping_merges_three_ways():
    a = ord("a")  # "aa" + "a": the leftmost at equal rank
    _three_ways([(a, a), (256, a)], ["aaaa", "aaa", "aaaaa", "aabaa", "a" * 37])


def test_seeded_random_corpus_three_ways(trained):
    rng = random.Random(7)
    port, python = trained, _python_twin(trained)
    jax = JaxTokenizer(trained.merges)
    for _ in range(20):
        data = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 200)))
        assert port.encode(data) == python.encode(data) == jax.encode(data), data


def test_multibyte_stream_decode_three_ways(trained):
    text = "héllo ☃ é überraschung"
    for tok in (trained, _python_twin(trained), JaxTokenizer(trained.merges)):
        ids = tok.encode(text)
        dec = tok.stream_decoder()
        pieces = [dec.feed(i) for i in ids]
        assert "".join(pieces) + dec.flush() == text
        assert "�" not in "".join(pieces)
        dec2 = tok.stream_decoder()
        assert dec2.feed("é".encode()[0]) == ""  # buffered, not garbled
        assert dec2.flush() == "�"


def test_merges_file_headers_and_duplicates_three_ways(tmp_path):
    path = tmp_path / "merges.txt"
    path.write_text("#version: 0.2\n104 105\n104 105\n99 100\n999999 3\n")
    port, jax = Tokenizer.from_file(str(path)), JaxTokenizer.from_file(str(path))
    assert port.merges == jax.merges == [(104, 105), (99, 100)]
    assert port.backend == "native"
    for tok in (port, _python_twin(port), jax):
        assert tok.encode("hi") == [256] and tok.encode("cd") == [257]
        assert tok.decode([256, 257]) == "hicd"


@pytest.mark.parametrize("lib_of", [native.load, jax_native.load], ids=["port", "jax"])
def test_direct_abi_robustness(lib_of):
    """Raw merges blobs through the C ABI (GOFR_NATIVE_LIB users): headers,
    duplicates and special-range ids are skipped, in both builds."""
    lib = lib_of()
    blob = b"#version: 0.2\n104 105\n104 105\n300 3\n99 100\n"
    h = lib.gofr_tok_new(blob, len(blob), 3)
    try:
        assert lib.gofr_tok_vocab_size(h) == 256 + 2 + 3
        buf = (ctypes.c_int32 * 4)()
        n = lib.gofr_tok_encode(h, b"hicd", 4, buf, 4)
        assert list(buf[:n]) == [256, 257]
    finally:
        lib.gofr_tok_free(h)


def test_hf_ids_are_translated_on_the_native_backend(trained):
    """An HF file's external ids: the native encode's internal ids go
    through the same Python translation as the Python encode's."""
    port, python = Tokenizer(trained.merges), _python_twin(trained)
    for tok in (port, python):
        tok._ext_of = [i + 1000 for i in range(256 + len(trained.merges))]
        tok._int_of = {e: i for i, e in enumerate(tok._ext_of)}
    ids = port.encode(CORPUS[:120])
    assert ids == python.encode(CORPUS[:120]) and min(ids) >= 1000
    assert port.decode(ids) == python.decode(ids) == CORPUS[:120]


# -- pack_token_rows -----------------------------------------------------------------

PACK_CASES = [
    ("empty_rows", [], 4, 8),
    ("zero_length_row", [np.array([], np.int32), np.array([5, 6], np.int32)], 2, 4),
    ("overlong_keeps_last", [np.arange(1, 11, dtype=np.int32)], 1, 4),
    ("pad_rows_beyond_inputs", [np.array([9], np.int32)], 4, 4),
    ("all_zero_length", [np.array([], np.int32)], 2, 4),
    ("mixed", [np.asarray(r, np.int32) for r in ([1, 2, 3], [4], list(range(20)))], 4, 8),
]


def _library_pack(rows, n_rows, width, pad_id):
    """The native library's ``gofr_pack_rows`` through its C ABI (the
    JAX package's pack; the port packs with numpy)."""
    lib = native.load()
    out = np.full((n_rows, width), pad_id, np.int32)
    lens = np.zeros(n_rows, np.int32)
    flat = np.concatenate([np.asarray(r, np.int32).reshape(-1) for r in rows] or
                          [np.zeros(0, np.int32)])
    sizes = np.asarray([np.asarray(r).size for r in rows], np.int64)
    lib.gofr_pack_rows(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(rows), width, pad_id,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out, lens


@pytest.mark.parametrize("name,rows,n_rows,width", PACK_CASES, ids=[c[0] for c in PACK_CASES])
@pytest.mark.parametrize("pad_id", [0, 3])
def test_pack_rows_native_python_and_jax(name, rows, n_rows, width, pad_id):
    """The port's pack, the port's library's ``gofr_pack_rows`` and the
    JAX package's pack: the same arrays."""
    got = batcher.pack_token_rows(rows, n_rows, width, pad_id)
    library = _library_pack(rows, n_rows, width, pad_id)
    want = jax_pack(rows, n_rows, width, pad_id)
    for a, b, c in zip(got, library, want):
        assert a.dtype == c.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if name == "overlong_keeps_last":
        assert list(got[0][0]) == [7, 8, 9, 10]  # the LAST tokens


def test_pack_without_the_library_takes_python(fresh):
    """The pack needs no library: disabled, it gives the same arrays."""
    fresh.setenv("GOFR_NATIVE_DISABLE", "1")
    out, lens = batcher.pack_token_rows([np.arange(6, dtype=np.int32)], 2, 4, 9)
    assert native.load() is None
    assert out.tolist() == [[2, 3, 4, 5], [9, 9, 9, 9]] and lens.tolist() == [4, 0]


# -- the settings --------------------------------------------------------------------

def test_disable_gives_the_python_backend_in_both(fresh, trained):
    fresh.setenv("GOFR_NATIVE_DISABLE", "1")
    assert native.load() is None and jax_native.load() is None
    port, jax = Tokenizer(trained.merges), JaxTokenizer(trained.merges)
    assert port.backend == jax.backend == "python"
    assert port.encode(CORPUS[:100]) == jax.encode(CORPUS[:100])


def test_native_lib_loads_that_file_and_builds_nothing(fresh, tmp_path):
    prebuilt = native._build()  # the default directory's library
    cache = tmp_path / "cache"
    fresh.setenv("GOFR_NATIVE_LIB", str(prebuilt))
    fresh.setenv("GOFR_NATIVE_CACHE", str(cache))
    for mod in (native, jax_native):
        lib = mod.load()
        assert lib is not None and lib._name == str(prebuilt)
    assert not cache.exists()  # neither built into the cache
    # a path that does not load: no library, no build, in both
    for mod in (native, jax_native):
        fresh.setattr(mod, "_lib", None)
        fresh.setattr(mod, "_lib_tried", False)
    fresh.setenv("GOFR_NATIVE_LIB", str(tmp_path / "missing.so"))
    assert native.load() is None and jax_native.load() is None
    assert not cache.exists()


def test_native_cache_is_where_both_build(fresh, tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    fresh.setenv("GOFR_NATIVE_CACHE", str(port_dir))
    lib = native.load()
    fresh.setenv("GOFR_NATIVE_CACHE", str(jax_dir))
    jlib = jax_native.load()
    assert Path(lib._name).parent == port_dir and Path(jlib._name).parent == jax_dir
    assert [p.suffix for p in port_dir.iterdir()] == [".so"]
    assert [p.suffix for p in jax_dir.iterdir()] == [".so"]


def test_a_failed_build_leaves_the_python_path(fresh, tmp_path):
    """No toolchain (here: no g++ on PATH): None, no temporary left, and
    the tokenizer on its Python backend, as in the JAX package."""
    fresh.setenv("GOFR_NATIVE_CACHE", str(tmp_path))
    fresh.setenv("PATH", str(tmp_path / "empty"))
    assert native.load() is None and jax_native.load() is None
    assert list(tmp_path.iterdir()) == []
    assert Tokenizer.byte_level().backend == "python"
