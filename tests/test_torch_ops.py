"""gofr_tpu_torch ops against the JAX package on the same numpy inputs:
rms_norm, RoPE, attention (the cases of tests/test_ops.py and the XLA
path's semantics), sampling, the dense matmul; plus the import guard that
keeps JAX and the JAX package out of the port.

f32 tolerance 2e-5 unless stated (the reference tests' attention bound);
warped distributions within 1e-6 per row.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models.quant import mm as jax_mm
from gofr_tpu.models.transformer import _cached_freqs
from gofr_tpu.ops import sampling as jsampling
from gofr_tpu.ops.attention import _xla_attention
from gofr_tpu.ops.attention import attention as jax_attention
from gofr_tpu.ops.norms import rms_norm as jax_rms_norm
from gofr_tpu.ops.rope import apply_rope as jax_apply_rope
from gofr_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from gofr_tpu_torch.models.quant import mm
from gofr_tpu_torch.ops import sampling
from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.rope import apply_rope, cached_freqs, rope_frequencies

TOL = 2e-5
REPO = Path(__file__).resolve().parent.parent


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- norms, rope ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x = _rand(0, (2, 5, 64)) * 3
    w = np.linspace(0.5, 1.5, 64).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jax_rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)).astype(jnp.float32))
    got = rms_norm(_t(x).to(tdt), _t(w).to(tdt))
    assert got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_rope_tables_match_jax():
    np.testing.assert_allclose(
        rope_frequencies(16, 64, 500000.0).numpy(),
        np.asarray(jax_rope_frequencies(16, 64, 500000.0)), rtol=TOL, atol=TOL,
    )
    np.testing.assert_array_equal(cached_freqs(16, 128, 10000.0), _cached_freqs(16, 128, 10000.0))


@pytest.mark.parametrize("ragged", [False, True])
def test_apply_rope_matches_jax(ragged):
    x = _rand(2, (2, 6, 3, 16))
    freqs = _cached_freqs(16, 64, 10000.0)
    if ragged:
        pos = np.array([[0, 1, 2, 3, 4, 5], [9, 10, 11, 12, 13, 14]])
    else:
        pos = np.arange(6)
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(freqs), jnp.asarray(pos)))
    got = apply_rope(_t(x), _t(freqs), _t(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -- attention --------------------------------------------------------------------

def _attn_pair(q, k, v, causal, q_offset=0, kv_lens=None):
    jlens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    joff = q_offset if isinstance(q_offset, int) else jnp.asarray(q_offset, jnp.int32)
    want = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=joff, kv_lens=jlens, impl="xla",
    ))
    toff = q_offset if isinstance(q_offset, int) else _t(np.asarray(q_offset, np.int32))
    tlens = None if kv_lens is None else _t(np.asarray(kv_lens, np.int32))
    got = attention(_t(q), _t(k), _t(v), causal=causal, q_offset=toff, kv_lens=tlens).numpy()
    return got, want


@pytest.mark.parametrize(
    "name,shape,causal,q_offset,kv_lens",
    [
        ("causal", (1, 6, 6, 2, 2, 4), True, 0, None),
        ("gqa", (2, 5, 5, 4, 2, 8), True, 0, None),
        ("non_causal_kv_lens", (2, 12, 12, 1, 1, 8), False, 0, [5, 9]),
        ("scalar_offset_decode", (1, 1, 8, 1, 1, 4), True, 3, None),
        ("ragged_offsets", (2, 3, 16, 4, 2, 8), True, [2, 9], [5, 12]),
        ("fully_masked_row", (2, 8, 8, 1, 1, 8), False, 0, [0, 8]),
    ],
)
def test_attention_matches_xla_path(name, shape, causal, q_offset, kv_lens):
    b, sq, skv, hq, hkv, d = shape
    q, k, v = _rand(1, (b, sq, hq, d)), _rand(2, (b, skv, hkv, d)), _rand(3, (b, skv, hkv, d))
    got, want = _attn_pair(q, k, v, causal, q_offset, kv_lens)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_attention_causality_and_gqa_equivalence():
    q, k, v = _rand(5, (1, 6, 2, 4)), _rand(6, (1, 6, 2, 4)), _rand(7, (1, 6, 2, 4))
    out1 = attention(_t(q), _t(k), _t(v))
    k2, v2 = k.copy(), v.copy()
    k2[:, -1], v2[:, -1] = 99.0, -99.0
    out2 = attention(_t(q), _t(k2), _t(v2))
    np.testing.assert_allclose(out1[:, :-1].numpy(), out2[:, :-1].numpy(), atol=1e-6)
    assert not np.allclose(out1[:, -1].numpy(), out2[:, -1].numpy())
    # GQA equals MHA over repeated KV heads
    qg, kg, vg = _rand(8, (2, 5, 4, 8)), _rand(9, (2, 5, 2, 8)), _rand(10, (2, 5, 2, 8))
    gqa = attention(_t(qg), _t(kg), _t(vg))
    mha = attention(_t(qg), _t(np.repeat(kg, 2, axis=2)), _t(np.repeat(vg, 2, axis=2)))
    np.testing.assert_allclose(gqa.numpy(), mha.numpy(), rtol=TOL, atol=TOL)


def test_attention_matches_xla_reference_scale():
    q, k, v = _rand(15, (1, 16, 1, 8)), _rand(16, (1, 16, 1, 8)), _rand(17, (1, 16, 1, 8))
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 0, None, 0.1))
    got = attention(_t(q), _t(k), _t(v), scale=0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_attention_low_precision_kv_upcasts():
    q, k, v = _rand(11, (2, 6, 4, 8)), _rand(12, (2, 6, 2, 8)), _rand(13, (2, 6, 2, 8))
    full = attention(_t(q), _t(k), _t(v))
    low = attention(_t(q), _t(k).to(torch.float8_e4m3fn), _t(v).to(torch.float8_e4m3fn))
    assert low.dtype == torch.float32
    want = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k).astype(jnp.float8_e4m3fn),
        jnp.asarray(v).astype(jnp.float8_e4m3fn), causal=True, impl="xla",
    ))
    np.testing.assert_allclose(low.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(low.numpy(), full.numpy(), atol=0.2, rtol=0.2)


# -- sampling ---------------------------------------------------------------------

_KNOBS = [
    # temperature, top_k, top_p, min_p
    (1.0, 0, 1.0, 0.0),
    (0.7, 5, 1.0, 0.0),
    (1.3, 0, 0.8, 0.0),
    (0.9, 10, 0.9, 0.05),
    (0.5, 1, 0.3, 0.0),
]


@pytest.mark.parametrize("knobs", _KNOBS)
def test_warped_probs_match_jax(knobs):
    temp, top_k, top_p, min_p = knobs
    logits = _rand(21, (4, 50)) * 3
    want = np.asarray(jsampling.warped_probs(jnp.asarray(logits), temp, top_k, top_p, min_p))
    got = sampling.warped_probs(_t(logits), temp, top_k, top_p, min_p).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_filter_per_row_knobs_match_jax():
    logits = _rand(22, (3, 40)) * 2
    top_k = np.array([0, 3, 7], np.int32)
    top_p = np.array([[1.0], [0.9], [0.5]], np.float32)
    min_p = np.array([[0.0], [0.1], [0.0]], np.float32)
    want = np.asarray(jsampling._filter_top_k_top_p(
        jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(min_p)
    ))
    got = sampling._filter_top_k_top_p(_t(logits), _t(top_k), _t(top_p), _t(min_p)).numpy()
    np.testing.assert_array_equal(got, want)
    # the argmax always survives
    assert (got.argmax(-1) == logits.argmax(-1)).all()


def test_greedy_rows_match_jax_exactly():
    logits = _rand(23, (4, 300)) * 4
    temp = np.array([0.0, 0.8, 0.0, 1.0], np.float32)
    want = np.asarray(jsampling.sample_logits_rows(
        jnp.asarray(logits), jax.random.key(0), jnp.asarray(temp),
        jnp.zeros(4, jnp.int32), jnp.ones(4, jnp.float32),
    ))
    gen = torch.Generator().manual_seed(0)
    got = sampling.sample_logits_rows(_t(logits), gen, _t(temp), 0, 1.0).numpy()
    assert got[0] == want[0] == logits[0].argmax()
    assert got[2] == want[2] == logits[2].argmax()
    all_greedy = sampling.sample_logits_rows(_t(logits), None, 0.0)
    np.testing.assert_array_equal(all_greedy.numpy(), logits.argmax(-1))


def test_sampled_rows_stay_in_support_and_follow_the_distribution():
    logits = np.log(np.array([[0.5, 0.3, 0.15, 0.05]], np.float32)).repeat(4000, 0)
    gen = torch.Generator().manual_seed(3)
    ids = sampling.sample_logits_rows(_t(logits), gen, 1.0, top_k=3).numpy()
    assert set(ids.tolist()) <= {0, 1, 2}  # top-k removed id 3
    freq = np.bincount(ids, minlength=4) / ids.size
    want = np.array([0.5, 0.3, 0.15, 0.0]) / 0.95
    np.testing.assert_allclose(freq, want, atol=0.03)


def test_sampler_seeded_reproducible_and_validated():
    logits = _t(_rand(24, (1, 64)) * 2)
    a = [sampling.Sampler(temperature=0.9, seed=5).pick(logits) for _ in range(3)]
    assert len(set(a)) == 1
    s = sampling.Sampler(temperature=0.9, seed=5)
    draws = [s.pick(logits) for _ in range(20)]
    assert len(set(draws)) > 1  # the generator advances per draw
    assert sampling.Sampler().pick(logits) == int(logits.argmax())
    assert sampling.Sampler.from_body({"temperature": None, "top_k": 4}).top_k == 4
    for bad in ({"temperature": -1}, {"top_p": 0.0}, {"top_k": -2}, {"min_p": 1.0}):
        with pytest.raises(ValueError):
            sampling.Sampler(**bad)


# -- dense matmul -------------------------------------------------------------------

def test_mm_dense_matches_jax_and_rejects_packs():
    x, w = _rand(30, (2, 3, 16)), _rand(31, (16, 8))
    want = np.asarray(jax_mm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(mm(_t(x), _t(w)).numpy(), want, rtol=TOL, atol=TOL)
    # the three packs are ported (tests/test_torch_quant.py); a pack of
    # any other keys is refused
    for pack in ({"q5": None, "scale": None}, {"q": None}, {"scale": None}):
        with pytest.raises(ValueError, match="unknown weight pack"):
            mm(_t(x), pack)


# -- the port stands alone ---------------------------------------------------------

def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module)
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "gofr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {p.relative_to(REPO).as_posix() for p in files}
    assert {"gofr_tpu_torch/models/moe.py", "gofr_tpu_torch/parallel/expert.py",
            "gofr_tpu_torch/parallel/multihost.py"} <= scanned
    for path in files:
        for mod in _imported_roots(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "gofr_tpu", "ml_dtypes"), (
                f"{path.relative_to(REPO)} imports {mod}"
            )
