"""gofr_tpu_torch.ops.flash: the kernel's plain PyTorch version against the
JAX package's Pallas forward kernel (``_flash_fwd_impl`` in interpret
mode), out AND log-sum-exp, over every forward case of tests/test_flash.py;
the wrapper's device dispatch and build failure; and, on a CUDA card only,
the hand-written kernel against its plain version.

Tolerances are the reference tests': f32 2e-5, bf16 2e-2 (atol and rtol).
On the card: ``python3 -m pytest --noconftest tests/test_torch_flash.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from gofr_tpu_torch.ops import flash

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _inputs(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
    return q, k, v


def _jax_fwd(q, k, v, causal, q_offset=0, kv_lens=None, scale=None, dtype="float32",
             block_q=8, block_kv=8):
    # imported here: the card's machine runs this file's `cuda` tests
    # (pytest --noconftest -m cuda) without JAX installed
    import jax.numpy as jnp

    from gofr_tpu.ops.flash import _flash_fwd_impl, _normalize_scalars

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    qj, kj, vj = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    offsets, lens = _normalize_scalars(
        qj, kj, q_offset, None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, lse = _flash_fwd_impl(
        qj, kj, vj, offsets, lens, causal, float(scale), block_q, block_kv, True
    )
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _torch_fwd(q, k, v, causal, q_offset=0, kv_lens=None, scale=None, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    if not isinstance(q_offset, int):
        q_offset = torch.as_tensor(np.asarray(q_offset))
    lens = None if kv_lens is None else torch.as_tensor(np.asarray(kv_lens))
    out, lse = flash.flash_attention_ref(qt, kt, vt, causal, q_offset, lens, scale)
    return out.float().numpy(), lse.numpy()


def _assert_match(got, want, tol):
    out, lse = got
    w_out, w_lse = want
    np.testing.assert_allclose(out, w_out, rtol=tol, atol=tol)
    assert np.array_equal(np.isinf(lse), np.isinf(w_lse))
    finite = np.isfinite(w_lse)
    np.testing.assert_allclose(lse[finite], w_lse[finite], rtol=tol, atol=tol)


# (name, shapes (b, sq, skv, hq, hkv, d), causal, q_offset, kv_lens, scale)
_F32_CASES = [
    ("causal", (2, 64, 64, 2, 2, 32), True, 0, None, None),
    ("non_causal", (1, 32, 32, 2, 2, 16), False, 0, None, None),
    ("gqa", (2, 32, 32, 4, 2, 16), True, 0, None, None),
    ("unaligned_pad", (1, 23, 23, 1, 1, 8), True, 0, None, None),
    ("ragged_offsets", (2, 8, 64, 2, 2, 16), True, [5, 17], [13, 25], None),
    ("scale_override", (1, 16, 16, 1, 1, 8), True, 0, None, 0.1),
    ("decode_sq1", (2, 1, 64, 2, 2, 16), True, [10, 30], [11, 31], None),
    ("fully_masked_row", (2, 8, 8, 1, 1, 8), False, 0, [0, 8], None),
]


@pytest.mark.parametrize("case", _F32_CASES, ids=[c[0] for c in _F32_CASES])
def test_ref_matches_pallas_forward_f32(case):
    name, (b, sq, skv, hq, hkv, d), causal, offs, lens, scale = case
    q, k, v = _inputs(len(name), b, sq, skv, hq, hkv, d)
    bq = 16 if sq == 1 else 8
    want = _jax_fwd(q, k, v, causal, offs, lens, scale, block_q=bq, block_kv=bq)
    got = _torch_fwd(q, k, v, causal, offs, lens, scale)
    _assert_match(got, want, F32_TOL)


def test_ref_bf16_matches_pallas_forward():
    q, k, v = _inputs(18, 1, 32, 32, 2, 2, 16)
    want = _jax_fwd(q, k, v, True, dtype="bfloat16")
    got = _torch_fwd(q, k, v, True, dtype=torch.bfloat16)
    _assert_match(got, want, BF16_TOL)


def test_ref_poisoned_tail_is_invisible():
    # keys/values past kv_lens (the unwritten cache tail) never reach the output
    q, k, v = _inputs(12, 2, 8, 64, 2, 2, 16)
    offs, lens = [5, 17], [13, 25]
    clean = _torch_fwd(q, k, v, True, offs, lens)
    k2, v2 = k.copy(), v.copy()
    k2[:, 40:] = 99.0
    v2[:, 40:] = np.nan
    poisoned = _torch_fwd(q, k2, v2, True, offs, lens)
    np.testing.assert_array_equal(poisoned[0], clean[0])
    np.testing.assert_array_equal(poisoned[1], clean[1])


def test_fully_masked_row_is_zero_with_inf_lse():
    q, k, v = _inputs(36, 2, 8, 8, 1, 1, 8)
    out, lse = _torch_fwd(q, k, v, False, 0, [0, 8])
    assert np.all(out[0] == 0.0)
    assert np.all(np.isposinf(lse[0]))
    assert np.all(np.isfinite(lse[1]))


def test_cpu_tensors_run_the_plain_version_without_counting():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 1, 16, 16, 2, 1, 16))
    before = flash.launches.value
    out, lse = flash.flash_attention_fwd(q, k, v, True)
    ref_out, ref_lse = flash.flash_attention_ref(q, k, v, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert flash.launches.value == before
    assert torch.equal(flash.flash_attention(q, k, v), out)


def test_other_devices_raise():
    q = torch.empty(1, 4, 2, 16, device="meta")
    k = torch.empty(1, 4, 1, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash.flash_attention_fwd(q, k, k, True)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(flash.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(flash, "_built", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash.build()


def test_kernel_checks_reject_bad_inputs():
    q = torch.zeros(1, 4, 2, 24)
    with pytest.raises(ValueError, match="head dim"):
        flash._check(q, torch.zeros(1, 4, 1, 24), torch.zeros(1, 4, 1, 24))
    q = torch.zeros(1, 4, 2, 16, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash._check(q, q, q)
    q = torch.zeros(1, 4, 3, 16)
    with pytest.raises(ValueError, match="does not fit"):
        flash._check(q, torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16))
    q = torch.zeros(1, 16, 4, 2).transpose(1, 3)  # head dim not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        flash._check(q, q, q)
    # bf16 K/V rows must be 16-byte aligned: pointer and strides
    q = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    kv = torch.zeros(1, 4, 1, 16, dtype=torch.bfloat16)
    flash._check(q, kv, kv)
    shifted = torch.zeros(65, dtype=torch.bfloat16)[1:].view(1, 4, 1, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash._check(q, shifted, kv)
    strided = torch.zeros(1, 4, 1, 20, dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash._check(q, kv, strided)
    # f32 loads element by element: the same layouts pass
    q32 = torch.zeros(1, 4, 2, 16)
    flash._check(q32, torch.zeros(65)[1:].view(1, 4, 1, 16), torch.zeros(1, 4, 1, 20)[..., :16])


def test_ref_kv_lens_past_the_cache_stop_at_its_end():
    # lengths beyond Skv are not clamped by the wrapper: both the kernel and
    # the plain version read no key past Skv
    q, k, v = _inputs(7, 2, 8, 16, 2, 1, 16)
    at_end = _torch_fwd(q, k, v, True, [8, 8], [16, 16])
    past = _torch_fwd(q, k, v, True, [8, 8], [16, 40])
    np.testing.assert_array_equal(past[0], at_end[0])
    np.testing.assert_array_equal(past[1], at_end[1])


def test_source_and_wrapper_agree():
    src = flash.SOURCE.read_text()
    for d in flash.HEAD_DIMS:
        assert f"case {d}: launch_f32<{d}>(a)" in src
        assert f"case {d}: launch_bf16<{d}>(a)" in src
    assert "0 = float32, 1 = bfloat16" in src
    assert flash._DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1}
    # the sm90 variant: its tile, the grid the wrapper computes, its entry
    assert f"constexpr int kF90BlockM = {flash.FWD_SM90_BLOCK_Q};" in src
    assert "grid_z != (sq + kF90BlockM - 1) / kF90BlockM" in src
    assert "int gofr_flash_fwd_sm90(" in src and "int gofr_flash_fwd_sm90_smem()" in src
    assert "a.causal ? a.n_qt - 1 - (int)blockIdx.z" in src  # longest first


def _q(dtype, sq, d, hq=4, b=1):
    return torch.zeros(b, sq, hq, d, dtype=dtype)


# (q, expected variant)
_VARIANTS = [
    ("training bf16 S=2048 D=128", _q(torch.bfloat16, 2048, 128, 32), "sm90"),
    ("prefill bucket 64", _q(torch.bfloat16, 64, 128), "sm90"),
    ("ragged tail Sq=130", _q(torch.bfloat16, 130, 128), "sm90"),
    ("short tail Sq=63", _q(torch.bfloat16, 63, 128), "mma"),
    ("decode Sq=1", _q(torch.bfloat16, 1, 128, 32, 4), "mma"),
    ("f32 D=128", _q(torch.float32, 2048, 128), "mma"),
    ("bf16 D=64", _q(torch.bfloat16, 256, 64), "mma"),
    ("bf16 D=16 tiny model", _q(torch.bfloat16, 128, 16), "mma"),
    # a q whose rows are not 16-byte aligned: TMA cannot read it
    ("misaligned rows", torch.zeros(1, 128, 4, 132, dtype=torch.bfloat16)[..., :128], "mma"),
    # q as a view of the fused QKV projection: aligned strides, TMA reads it
    ("fused qkv view", torch.zeros(1, 128, 48, 128, dtype=torch.bfloat16)[:, :, :32], "sm90"),
]


@pytest.mark.parametrize("case", _VARIANTS, ids=[c[0] for c in _VARIANTS])
def test_forward_variant_by_shape(case):
    _, q, want = case
    assert flash.fwd_variant(q) == want


@pytest.mark.parametrize("b, sq, hq, want", [
    (1, 2048, 32, (32, 1, 16)),
    (4, 1024, 32, (32, 4, 8)),
    (2, 130, 8, (8, 2, 2)),
    (4, 64, 32, (32, 4, 1)),
])
def test_forward_sm90_grid(b, sq, hq, want):
    assert flash.fwd_sm90_grid(b, sq, hq) == want


def test_variant_override_only_where_it_fits():
    assert flash._pick("flash_fwd", "sm90", None) == "sm90"
    assert flash._pick("flash_fwd", "sm90", "mma") == "mma"  # the mma kernel takes any call
    assert flash._pick("flash_fwd", "mma", None) == "mma"
    with pytest.raises(ValueError, match="does not take this call"):
        flash._pick("flash_fwd", "mma", "sm90")


# -- on the card only ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


_KERNEL_CASES = [
    # b, sq, skv, hq, hkv, d, dtype, causal, offsets, kv_lens
    (2, 512, 1024, 32, 8, 128, torch.bfloat16, True, [0, 300], [512, 812]),
    (4, 1, 2048, 32, 8, 128, torch.bfloat16, True, [0, 699, 1499, 2047], [1, 700, 1500, 2048]),
    (2, 1, 256, 32, 8, 128, torch.bfloat16, True, [0, 99], [0, 100]),
    (2, 40, 128, 4, 2, 16, torch.float32, True, [0, 20], [40, 60]),
    (2, 37, 37, 4, 4, 32, torch.float32, False, [0, 0], [37, 20]),
    (1, 70, 70, 8, 2, 64, torch.float32, True, [0], [70]),
    (2, 130, 200, 8, 2, 64, torch.bfloat16, True, [0, 70], [130, 200]),
    (2, 33, 33, 4, 2, 32, torch.bfloat16, False, [0, 0], [33, 5]),
    (3, 1, 100, 4, 2, 16, torch.bfloat16, True, [9, 0, 98], [10, 1, 99]),
    (2, 40, 128, 4, 2, 16, torch.bfloat16, True, [0, 20], [40, 60]),
]


def _kernel_inputs(cuda, b, sq, skv, hq, hkv, d, dtype, offs, lens, seed=0):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    q = torch.randn(b, sq, hq, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(b, skv, hkv, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(b, skv, hkv, d, device=cuda, generator=gen).to(dtype)
    offs = torch.tensor(offs, dtype=torch.int32, device=cuda)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, k, v, offs, lens


def _matches_plain(q, k, v, causal, offs, lens, out, lse):
    ref_out, ref_lse = flash.flash_attention_ref(q, k, v, causal, offs, lens)
    tol = BF16_TOL if q.dtype == torch.bfloat16 else F32_TOL
    _assert_match(
        (out.float().cpu().numpy(), lse.cpu().numpy()),
        (ref_out.float().cpu().numpy(), ref_lse.cpu().numpy()),
        tol,
    )


# the sm90 variant: b, sq, skv, hq, hkv, causal, offsets, kv_lens
_SM90_CASES = [
    ("training shape", (1, 2048, 2048, 32, 8, True, [0], [2048])),
    ("tiles cut 130/200", (2, 130, 200, 8, 2, True, [0, 70], [130, 200])),
    ("ragged 300/1024", (2, 300, 1024, 8, 2, True, [0, 500], [300, 800])),
    ("kv_lens=0 row", (2, 64, 128, 4, 2, True, [0, 64], [0, 128])),
    ("non-causal ragged", (2, 200, 333, 8, 2, False, [0, 0], [333, 100])),
    ("groups 1", (1, 256, 256, 4, 4, True, [0], [256])),
    ("groups 2", (1, 256, 256, 4, 2, True, [0], [256])),
    ("groups 4", (1, 256, 256, 8, 2, True, [0], [256])),
    ("groups 8", (1, 256, 256, 16, 2, True, [0], [256])),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _SM90_CASES, ids=[c[0] for c in _SM90_CASES])
def test_sm90_forward_matches_plain_version(cuda, case):
    b, sq, skv, hq, hkv, causal, offs, lens = case[1]
    q, k, v, offs, lens = _kernel_inputs(cuda, b, sq, skv, hq, hkv, 128, torch.bfloat16,
                                         offs, lens)
    assert flash.fwd_variant(q) == "sm90"
    before = (flash.launches.value, flash.launches_fwd_sm90.value)
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    torch.cuda.synchronize()
    assert (flash.launches.value, flash.launches_fwd_sm90.value) == (before[0] + 1, before[1] + 1)
    _matches_plain(q, k, v, causal, offs, lens, out, lse)
    if 0 in lens.tolist():
        row = lens.tolist().index(0)
        assert bool((out[row] == 0).all()) and bool(torch.isposinf(lse[row]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [float("nan"), 300.0])
def test_sm90_forward_reads_a_poisoned_cache_slice(cuda, poison):
    # K/V one layer of a [L, B, 2048, 8, 128] cache (strided, starting
    # mid-allocation), the tail past kv_len poisoned: TMA loads whole tiles,
    # so the kernel must keep the tail out of P.V itself
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    b, sq, lens_ = 4, 256, [256, 300, 700, 1024]
    shape = (2, b, 2048, 8, 128)
    k_cache = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
    v_cache = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
    for i, n in enumerate(lens_):
        k_cache[:, i, n:] = poison
        v_cache[:, i, n:] = poison
    q = torch.randn(b, sq, 32, 128, device=cuda, generator=gen).to(torch.bfloat16)
    k, v = k_cache[-1], v_cache[-1]
    lens = torch.tensor(lens_, dtype=torch.int32, device=cuda)
    offs = lens - sq
    before = flash.launches_fwd_sm90.value
    out, lse = flash.flash_attention_fwd(q, k, v, True, offs, lens)
    torch.cuda.synchronize()
    assert flash.launches_fwd_sm90.value == before + 1
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    clean = (torch.arange(2048, device=cuda)[None, :] < lens[:, None])[:, :, None, None]
    out2, lse2 = flash.flash_attention_fwd(q, k.masked_fill(~clean, 0), v.masked_fill(~clean, 0),
                                           True, offs, lens)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    _matches_plain(q, k, v, True, offs, lens, out, lse)


@pytest.mark.cuda
def test_short_calls_keep_the_mma_kernel(cuda):
    # decode and tails under 64 rows: the mma kernel, counted in the total only
    q, k, v, offs, lens = _kernel_inputs(cuda, 2, 63, 256, 8, 2, 128, torch.bfloat16,
                                         [0, 100], [63, 163])
    assert flash.fwd_variant(q) == "mma"
    before = (flash.launches.value, flash.launches_fwd_sm90.value)
    out, lse = flash.flash_attention_fwd(q, k, v, True, offs, lens)
    torch.cuda.synchronize()
    assert (flash.launches.value, flash.launches_fwd_sm90.value) == (before[0] + 1, before[1])
    _matches_plain(q, k, v, True, offs, lens, out, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _KERNEL_CASES)
def test_kernel_matches_plain_version(cuda, case):
    b, sq, skv, hq, hkv, d, dtype, causal, offs, lens = case
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    q = torch.randn(b, sq, hq, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(b, skv, hkv, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(b, skv, hkv, d, device=cuda, generator=gen).to(dtype)
    offs = torch.tensor(offs, dtype=torch.int32, device=cuda)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = flash.launches.value
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    torch.cuda.synchronize()
    assert flash.launches.value == before + 1
    ref_out, ref_lse = flash.flash_attention_ref(q, k, v, causal, offs, lens)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    _assert_match(
        (out.float().cpu().numpy(), lse.cpu().numpy()),
        (ref_out.float().cpu().numpy(), ref_lse.cpu().numpy()),
        tol,
    )
