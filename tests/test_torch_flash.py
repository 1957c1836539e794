"""gofr_tpu_torch.ops.flash: the kernel's plain PyTorch version against the
JAX package's Pallas forward kernel (``_flash_fwd_impl`` in interpret
mode), out AND log-sum-exp, over every forward case of tests/test_flash.py;
the wrapper's device dispatch and build failure; and, on a CUDA card only,
the hand-written kernel against its plain version (its sm90, decode and
mma variants).

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


@pytest.mark.parametrize("debug", [False, True])
def test_debug_build_is_opt_in(monkeypatch, tmp_path, debug):
    """FLASH_DEBUG_BUILD=1 compiles the device-side index checks in, into
    _build/debug/; without it the flags and the directory are the default
    build's."""
    calls = []

    class FailedNvcc:
        returncode = 1

        def __init__(self, cmd, **kwargs):
            calls.append(cmd)

        def communicate(self):
            return ("",)

    if debug:
        monkeypatch.setenv("FLASH_DEBUG_BUILD", "1")
    else:
        monkeypatch.delenv("FLASH_DEBUG_BUILD", raising=False)
    monkeypatch.setattr(flash, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(flash, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(flash.subprocess, "Popen", FailedNvcc)
    monkeypatch.setattr(flash, "_built", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        flash.build()
    assert flash.debug_build() == debug
    assert {c.name for c in flash.CSRC.glob("*.cu")} == {c[-1].split("/")[-1] for c in calls}
    for cmd in calls:
        assert tuple(cmd[1:1 + len(flash.NVCC_FLAGS)]) == flash.NVCC_FLAGS
        assert ("-DGOFR_FLASH_DEBUG" in cmd) == debug
        assert cmd[cmd.index("-o") + 1].startswith(str(tmp_path / "debug" if debug else tmp_path))
    header = (flash.CSRC / "sm90.cuh").read_text()
    assert "#ifdef GOFR_FLASH_DEBUG" in header and "#define GOFR_DCHECK(cond) ((void)0)" in header


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
    # the decode variant: its packed rows, key tile, split bound, entry and
    # the split arithmetic the CPU tests copy (_decode_split_keys)
    assert f"constexpr int kDecRows = {flash.FWD_DECODE_ROWS};" in src
    assert "constexpr int kDecThreads = 128;" in src and flash.FWD_DECODE_BLOCK_KV == 16 * 128 // 32
    assert "constexpr int kDecBlockN = 16 * kDecWarps;" in src
    assert f"constexpr int kDecMaxSplits = {flash.MAX_CLUSTER};" in src
    assert "sq * (hq / hkv) > kDecRows" in src
    assert "int gofr_flash_fwd_decode(" in src and "int gofr_flash_fwd_decode_smem()" in src
    for line in ("const int kv_end = a.causal ? min(kv_len, max(0, offset + a.sq)) : kv_len;",
                 "const int per = (n_tiles + a.splits - 1) / a.splits;",
                 "const int t_lo = split * per;",
                 "const int nt = max(0, min(t_lo + per, n_tiles) - t_lo);",
                 "const int k_hi = min((t_lo + nt) * kDecBlockN, kv_end);"):
        assert line in src, line
    # the merge is deterministic: no atomic adds anywhere in the source
    assert "atomicAdd" not in src and "red.global" not in src
    # every redesigned kernel reports its shared memory under its own name
    for name, query in flash.SMEM_QUERIES.items():
        kernel_src = src if "fwd" in name else (flash.CSRC / "flash_bwd.cu").read_text()
        assert f"{name}(" in kernel_src and f"int {query}()" in kernel_src


def _q(dtype, sq, d, hq=4, b=1):
    return torch.zeros(b, sq, hq, d, dtype=dtype)


def _kv(dtype, d, hkv=4, skv=64):
    return torch.zeros(1, skv, hkv, d, dtype=dtype)


_BF16 = torch.bfloat16
# (q, k, expected variant)
_VARIANTS = [
    ("training bf16 S=2048 D=128", _q(_BF16, 2048, 128, 32), _kv(_BF16, 128, 8), "sm90"),
    ("prefill bucket 64", _q(_BF16, 64, 128), _kv(_BF16, 128), "sm90"),
    ("ragged tail Sq=130", _q(_BF16, 130, 128), _kv(_BF16, 128), "sm90"),
    ("short tail Sq=63", _q(_BF16, 63, 128), _kv(_BF16, 128), "mma"),
    ("decode Sq=1", _q(_BF16, 1, 128, 32, 4), _kv(_BF16, 128, 8, 2048), "decode"),
    ("decode groups 1", _q(_BF16, 1, 128, 8), _kv(_BF16, 128, 8), "decode"),
    ("decode groups 2", _q(_BF16, 1, 128, 16), _kv(_BF16, 128, 8), "decode"),
    ("decode groups 8", _q(_BF16, 1, 128, 32), _kv(_BF16, 128, 4), "decode"),
    # the largest Sq the decode variant packs (Sq x groups <= 16), and one more
    ("groups 4 Sq=4", _q(_BF16, 4, 128, 32), _kv(_BF16, 128, 8), "decode"),
    ("groups 4 Sq=5", _q(_BF16, 5, 128, 32), _kv(_BF16, 128, 8), "mma"),
    ("groups 1 Sq=16", _q(_BF16, 16, 128, 8), _kv(_BF16, 128, 8), "decode"),
    ("groups 1 Sq=17", _q(_BF16, 17, 128, 8), _kv(_BF16, 128, 8), "mma"),
    ("groups 8 Sq=2", _q(_BF16, 2, 128, 32), _kv(_BF16, 128, 4), "decode"),
    ("groups 8 Sq=3", _q(_BF16, 3, 128, 32), _kv(_BF16, 128, 4), "mma"),
    ("decode f32 D=128", _q(torch.float32, 1, 128, 32), _kv(torch.float32, 128, 8), "mma"),
    ("decode bf16 D=64", _q(_BF16, 1, 64, 32), _kv(_BF16, 64, 8), "mma"),
    ("f32 D=128", _q(torch.float32, 2048, 128), _kv(torch.float32, 128), "mma"),
    ("bf16 D=64", _q(_BF16, 256, 64), _kv(_BF16, 64), "mma"),
    ("bf16 D=16 tiny model", _q(_BF16, 128, 16), _kv(_BF16, 16), "mma"),
    # a q whose rows are not 16-byte aligned: TMA cannot read it
    ("misaligned rows", torch.zeros(1, 128, 4, 132, dtype=_BF16)[..., :128], _kv(_BF16, 128),
     "mma"),
    # q as a view of the fused QKV projection: aligned strides, TMA reads it
    ("fused qkv view", torch.zeros(1, 128, 48, 128, dtype=_BF16)[:, :, :32], _kv(_BF16, 128, 8),
     "sm90"),
]


@pytest.mark.parametrize("case", _VARIANTS, ids=[c[0] for c in _VARIANTS])
def test_forward_variant_by_shape(case):
    _, q, k, want = case
    assert flash.fwd_variant(q, k) == want


@pytest.mark.parametrize("b, sq, hq, want", [
    (1, 2048, 32, (32, 1, 16)),
    (4, 1024, 32, (32, 4, 8)),
    (2, 130, 8, (8, 2, 2)),
    (4, 64, 32, (32, 4, 1)),
])
def test_forward_sm90_grid(b, sq, hq, want):
    assert flash.fwd_sm90_grid(b, sq, hq) == want


@pytest.mark.parametrize("b, hkv, skv, want", [
    (1, 8, 128, 2),  # one split per 64-key tile of a short cache
    (1, 8, 2048, 8),  # the served batch-1 decode: a full cluster
    (4, 8, 128, 2),
    (4, 8, 2048, 8),
    (16, 8, 2048, 3),  # 128 (row, head) pairs: about two blocks an SM
    (64, 8, 2048, 1),
    (1, 8, 1, 1),
])
def test_forward_decode_splits(b, hkv, skv, want):
    splits = flash.fwd_decode_splits(b, hkv, skv)
    assert splits == want and 1 <= splits <= flash.MAX_CLUSTER


def _decode_split_keys(kv_end, splits, s):
    """csrc/flash_fwd.cu's split arithmetic, copied: the keys [lo, hi) that
    split ``s`` of ``splits`` takes of the visible keys [0, kv_end)."""
    block = flash.FWD_DECODE_BLOCK_KV
    n_tiles = -(-kv_end // block)
    per = -(-n_tiles // splits)
    t_lo = s * per
    nt = max(0, min(t_lo + per, n_tiles) - t_lo)
    return t_lo * block, min((t_lo + nt) * block, kv_end)


@pytest.mark.parametrize("kv_len", [0, 1, 63, 64, 616, 2047, 2048])
def test_decode_splits_cover_every_key_once(kv_len):
    for splits in range(1, flash.MAX_CLUSTER + 1):
        seen = np.zeros(max(kv_len, 1), dtype=int)
        for s in range(splits):
            lo, hi = _decode_split_keys(kv_len, splits, s)
            assert lo % flash.FWD_DECODE_BLOCK_KV == 0  # whole tiles, 16-byte aligned rows
            seen[lo:max(lo, hi)] += 1
        assert (seen[:kv_len] == 1).all(), (kv_len, splits)


def _ref_split_and_merge(q, k, v, offs, lens, splits):
    """The decode variant's rule in plain torch: ``flash_attention_ref`` on
    each split's keys, merged by log-sum-exp; a split that sees no key
    (LSE +inf) weighs 0, a row with no key at all gives out 0 and LSE +inf."""
    b, sq = q.shape[:2]
    outs, lses = [], []
    for bi in range(b):
        kv_end = min(int(lens[bi]), int(offs[bi]) + sq, k.shape[1])
        part_out, part_lse = [], []
        for s in range(splits):
            lo, hi = _decode_split_keys(kv_end, splits, s)
            hi = max(lo, hi)
            o, lse = flash.flash_attention_ref(
                q[bi:bi + 1], k[bi:bi + 1, lo:hi], v[bi:bi + 1, lo:hi], True,
                torch.tensor([int(offs[bi]) - lo]), torch.tensor([hi - lo]))
            part_out.append(o.float())
            part_lse.append(lse)
        lse = torch.stack(part_lse)  # [splits, 1, Hq, Sq]
        live = torch.isfinite(lse)
        total = torch.logsumexp(torch.where(live, lse, -torch.inf), dim=0)
        w = torch.where(live, torch.exp(lse - total), 0.0)  # [splits, 1, Hq, Sq]
        merged = sum(w_s.transpose(1, 2)[..., None] * o_s for w_s, o_s in zip(w, part_out))
        none = ~live.any(dim=0)
        outs.append(torch.where(none.transpose(1, 2)[..., None], 0.0, merged))
        lses.append(torch.where(none, torch.inf, total))
    return torch.cat(outs).to(q.dtype), torch.cat(lses)


@pytest.mark.parametrize("splits", [2, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_and_merge_matches_whole_range_and_pallas(dtype, splits):
    # ragged kv_lens: a 0-length row, a row whose keys end inside the first
    # split, and (at 8 splits over 4 tiles) splits wholly past kv_len
    tdt, tol = (torch.float32, F32_TOL) if dtype == "float32" else (torch.bfloat16, BF16_TOL)
    q, k, v = _inputs(40 + splits, 4, 1, 256, 8, 2, 32)
    lens = [0, 37, 130, 256]
    offs = [max(n - 1, 0) for n in lens]
    qt, kt, vt = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = _ref_split_and_merge(qt, kt, vt, offs, lens, splits)
    whole = flash.flash_attention_ref(qt, kt, vt, True, torch.tensor(offs), torch.tensor(lens))
    got = (got[0].float().numpy(), got[1].numpy())
    _assert_match(got, (whole[0].float().numpy(), whole[1].numpy()), tol)
    want = _jax_fwd(q, k, v, True, offs, lens, dtype=dtype, block_q=16, block_kv=16)
    _assert_match(got, want, tol)
    assert np.all(got[0][0] == 0) and np.all(np.isposinf(got[1][0]))


def test_variant_override_only_where_it_fits():
    assert flash._pick("flash_fwd", "sm90", None) == "sm90"
    assert flash._pick("flash_fwd", "sm90", "mma") == "mma"  # the mma kernel takes any call
    assert flash._pick("flash_fwd", "mma", None) == "mma"
    assert flash._pick("flash_fwd", "decode", None) == "decode"
    assert flash._pick("flash_fwd", "decode", "decode") == "decode"
    assert flash._pick("flash_fwd", "decode", "mma") == "mma"
    for chosen, asked in (("mma", "sm90"), ("mma", "decode"), ("sm90", "decode"),
                          ("decode", "sm90")):
        with pytest.raises(ValueError, match="does not take this call"):
            flash._pick("flash_fwd", chosen, asked)


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
    assert flash.fwd_variant(q, k) == "sm90"
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
    # tails under 64 rows past the decode variant's 16: the mma kernel,
    # counted in the total only
    q, k, v, offs, lens = _kernel_inputs(cuda, 2, 63, 256, 8, 2, 128, torch.bfloat16,
                                         [0, 100], [63, 163])
    assert flash.fwd_variant(q, k) == "mma"
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


# the decode variant: b, sq, hq, hkv, offsets, kv_lens, poison of the tail
_DECODE_CASES = [
    ("served B=1 kv 616", (1, 1, 32, 8, [615], [616], 300.0)),
    ("served B=1 kv 1800 NaN tail", (1, 1, 32, 8, [1799], [1800], float("nan"))),
    ("B=4 cache 2048", (4, 1, 32, 8, [0, 699, 1499, 2047], [1, 700, 1500, 2048], None)),
    ("groups 1", (2, 1, 8, 8, [99, 400], [100, 401], None)),
    ("groups 2", (2, 1, 16, 8, [99, 400], [100, 401], None)),
    ("groups 8", (2, 1, 32, 4, [99, 400], [100, 401], None)),
    ("kv_lens=0 row", (2, 1, 32, 8, [0, 899], [0, 900], float("nan"))),
    ("Sq=4 groups 4", (2, 4, 32, 8, [96, 290], [100, 294], 300.0)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _DECODE_CASES, ids=[c[0] for c in _DECODE_CASES])
def test_decode_forward_matches_plain_version(cuda, case):
    # K/V one layer of a [2, B, 2048, Hkv, 128] cache, poisoned past kv_len
    b, sq, hq, hkv, offs, lens, poison = case[1]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    caches = [torch.randn(2, b, 2048, hkv, 128, device=cuda, generator=gen).to(torch.bfloat16)
              for _ in "kv"]
    if poison is not None:
        for cache in caches:
            for i, n in enumerate(lens):
                cache[:, i, n:] = poison
    q = torch.randn(b, sq, hq, 128, device=cuda, generator=gen).to(torch.bfloat16)
    k, v = caches[0][-1], caches[1][-1]
    offs = torch.tensor(offs, dtype=torch.int32, device=cuda)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    assert flash.fwd_variant(q, k) == "decode"
    before = (flash.launches.value, flash.launches_fwd_decode.value)
    out, lse = flash.flash_attention_fwd(q, k, v, True, offs, lens)
    torch.cuda.synchronize()
    assert (flash.launches.value, flash.launches_fwd_decode.value) == (before[0] + 1,
                                                                      before[1] + 1)
    assert torch.isfinite(out).all()
    _matches_plain(q, k, v, True, offs, lens, out, lse)
    again = flash.flash_attention_fwd(q, k, v, True, offs, lens)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)  # a fixed merge order
    if 0 in lens.tolist():
        row = lens.tolist().index(0)
        assert bool((out[row] == 0).all()) and bool(torch.isposinf(lse[row]).all())


@pytest.mark.cuda
def test_decode_wrapper_reads_no_device_value(cuda):
    # the split count comes from shapes: no host sync in the wrapper
    q, k, v, offs, lens = _kernel_inputs(cuda, 4, 1, 2048, 32, 8, 128, torch.bfloat16,
                                         [0, 699, 1499, 2047], [1, 700, 1500, 2048])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flash.flash_attention_fwd(q, k, v, True, offs, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
