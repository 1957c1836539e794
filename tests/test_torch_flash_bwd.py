"""gofr_tpu_torch.ops.flash, backward: the plain version of the backward
kernels (``flash_attention_bwd_ref``) against the JAX package's Pallas
backward (``_flash_bwd_impl`` in interpret mode) on the same q, k, v, out,
lse and dO; gradients through the port's ``flash_attention`` (its
``autograd.Function``) against ``jax.grad`` of the JAX package's
``flash_attention`` (Pallas forward and fused backward, interpret mode,
block_q = block_kv = 8); the wrapper's dispatch and build failure; and, on
a CUDA card only, the dQ and dK/dV kernels (their sm90 and mma variants)
against their plain version.

Tolerances: f32 atol 1e-4 with rtol 2e-5 (tests/test_flash.py's gradient
tests), bf16 2e-2 (atol and rtol). On the card:
``python3 -m pytest --noconftest tests/test_torch_flash_bwd.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from gofr_tpu_torch.ops import flash

F32_ATOL, F32_RTOL = 1e-4, 2e-5
BF16_TOL = 2e-2


def _inputs(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
    g = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    return q, k, v, g


def _jnp(x, dtype):
    # imported here: the card's machine runs this file's `cuda` tests
    # (pytest --noconftest -m cuda) without JAX installed
    import jax.numpy as jnp

    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _f32(x):
    return np.array(x.astype("float32"))


def _scalars(q_offset, kv_lens):
    offs = q_offset if isinstance(q_offset, int) else torch.tensor(q_offset)
    lens = None if kv_lens is None else torch.tensor(kv_lens)
    return offs, lens


def _assert_grads(got, want, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if dtype == "bfloat16":
            np.testing.assert_allclose(a, b, rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=F32_RTOL, atol=F32_ATOL, err_msg=name)


# (name, shapes (b, sq, skv, hq, hkv, d), causal, q_offset, kv_lens) as in
# tests/test_flash.py's gradient tests
_CASES = [
    ("causal_mha", (1, 16, 16, 2, 2, 8), True, 0, None),
    ("gqa_4_2", (2, 32, 32, 4, 2, 16), True, 0, None),
    ("non_causal", (1, 24, 24, 2, 2, 8), False, 0, None),
    ("ragged", (2, 19, 40, 2, 2, 8), True, [2, 11], [21, 30]),
    ("zero_kv_lens_row", (2, 8, 8, 1, 1, 8), False, 0, [0, 8]),
]


def _jax_bwd(q, k, v, g, causal, q_offset, kv_lens, dtype):
    """The Pallas forward then backward, interpret mode: (out, lse, dq, dk, dv)."""
    import jax.numpy as jnp

    from gofr_tpu.ops.flash import _flash_bwd_impl, _flash_fwd_impl, _normalize_scalars

    qj, kj, vj, gj = (_jnp(x, dtype) for x in (q, k, v, g))
    offsets, lens = _normalize_scalars(
        qj, kj, q_offset, None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    )
    scale = float(q.shape[-1] ** -0.5)
    out, lse = _flash_fwd_impl(qj, kj, vj, offsets, lens, causal, scale, 8, 8, True)
    grads = _flash_bwd_impl(qj, kj, vj, offsets, lens, out, lse, gj, causal, scale, 8, 8, True)
    return out, lse, grads


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_bwd_ref_matches_pallas_backward(case):
    name, (b, sq, skv, hq, hkv, d), causal, offs, lens = case
    q, k, v, g = _inputs(len(name), b, sq, skv, hq, hkv, d)
    out, lse, want = _jax_bwd(q, k, v, g, causal, offs, lens, "float32")
    o, l_ = _scalars(offs, lens)
    got = flash.flash_attention_bwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), o, l_,
        torch.from_numpy(_f32(out)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(g), causal, d ** -0.5,
    )
    _assert_grads([x.numpy() for x in got], [_f32(x) for x in want], "float32")


def test_bwd_ref_bf16_matches_pallas_backward():
    q, k, v, g = _inputs(3, 2, 32, 32, 4, 2, 16)
    out, lse, want = _jax_bwd(q, k, v, g, True, 0, None, "bfloat16")
    bf = lambda x: torch.from_numpy(_f32(_jnp(x, "bfloat16"))).to(torch.bfloat16)  # noqa: E731
    got = flash.flash_attention_bwd_ref(
        bf(q), bf(k), bf(v), 0, None, torch.from_numpy(_f32(out)).to(torch.bfloat16),
        torch.from_numpy(np.array(lse)), bf(g), True, 16 ** -0.5,
    )
    assert all(x.dtype == torch.bfloat16 for x in got)
    _assert_grads([x.float().numpy() for x in got], [_f32(x) for x in want], "bfloat16")


def _jax_grads(q, k, v, g, causal, q_offset, kv_lens):
    import jax
    import jax.numpy as jnp

    from gofr_tpu.ops.flash import flash_attention

    lens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    offs = q_offset if isinstance(q_offset, int) else jnp.asarray(q_offset, jnp.int32)

    def loss(q, k, v):
        out = flash_attention(q, k, v, causal=causal, q_offset=offs, kv_lens=lens,
                              block_q=8, block_kv=8)
        return jnp.sum(out * g)

    return [_f32(x) for x in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _torch_grads(q, k, v, g, causal, q_offset, kv_lens):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, l_ = _scalars(q_offset, kv_lens)
    out = flash.flash_attention(qt, kt, vt, causal, o, l_)
    (out * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_gradients_match_jax_flash_attention(case):
    name, (b, sq, skv, hq, hkv, d), causal, offs, lens = case
    q, k, v, g = _inputs(100 + len(name), b, sq, skv, hq, hkv, d)
    want = _jax_grads(q, k, v, g, causal, offs, lens)
    got = _torch_grads(q, k, v, g, causal, offs, lens)
    _assert_grads(got, want, "float32")
    if name == "zero_kv_lens_row":
        for grad in got:
            assert np.isfinite(grad).all()
            assert np.all(grad[0] == 0.0)


def test_bwd_ref_poisoned_tail_gives_exact_zeros():
    # keys past kv_len (NaN or garbage in the unwritten cache) get dK = dV
    # = 0 exactly and leave dQ unchanged
    q, k, v, g = _inputs(9, 2, 8, 32, 2, 2, 16)
    o, l_ = torch.tensor([5, 17]), torch.tensor([13, 25])
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash.flash_attention_ref(qt, kt, vt, True, o, l_)
    clean = flash.flash_attention_bwd_ref(qt, kt, vt, o, l_, out, lse, gt, True, 0.25)
    k2, v2 = kt.clone(), vt.clone()
    k2[0, 13:] = float("nan")
    v2[:, 25:] = 300.0
    dq, dk, dv = flash.flash_attention_bwd_ref(qt, k2, v2, o, l_, out, lse, gt, True, 0.25)
    assert torch.equal(dq, clean[0])
    assert torch.all(dk[0, 13:] == 0) and torch.all(dv[0, 13:] == 0)
    assert torch.all(dk[1, 25:] == 0) and torch.all(dv[1, 25:] == 0)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_cpu_backward_runs_the_plain_version_without_counting():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(4, 1, 16, 16, 4, 2, 16))
    q.requires_grad_()
    counts = [c.value for c in (flash.launches, flash.launches_dq, flash.launches_dkv)]
    out = flash.flash_attention(q, k, v)
    (gq,) = torch.autograd.grad(out, q, g)
    assert [c.value for c in (flash.launches, flash.launches_dq, flash.launches_dkv)] == counts
    ref_out, lse = flash.flash_attention_ref(q.detach(), k, v)
    want = flash.flash_attention_bwd_ref(q.detach(), k, v, 0, None, ref_out, lse, g, True, 0.25)
    assert torch.equal(gq, want[0])


def test_backward_without_nvcc_raises(monkeypatch, tmp_path):
    # the wrapper a CUDA tensor reaches builds the kernels or raises: it
    # never falls back to the plain version
    monkeypatch.setattr(flash.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(flash, "_built", None)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(5, 1, 8, 8, 2, 1, 16))
    out, lse = flash.flash_attention_ref(q, k, v)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash._launch_bwd(q, k, v, torch.zeros(1, dtype=torch.int32),
                          torch.full((1,), 8, dtype=torch.int32), out, lse, g, True, 0.25)


def test_build_compiles_every_source_and_names_the_one_that_failed(monkeypatch, tmp_path):
    # a stand-in nvcc: records each call, fails on the backward source
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {calls}\n'
                    'case "$*" in *flash_bwd.cu*) echo "error: boom"; exit 1;; esac\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(flash.shutil, "which", lambda name: str(nvcc))
    monkeypatch.setattr(flash, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(flash, "_built", None)
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed building flash_bwd\.cu.*boom"):
        flash.build()
    compiled = calls.read_text().splitlines()
    assert len(compiled) == len(flash._sources()) >= 2
    assert all("-c" in line.split() and "arch=compute_90a,code=sm_90a" in line
               for line in compiled)


def test_bwd_checks_reject_bad_inputs():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(6, 1, 8, 8, 2, 1, 16))
    out, lse = flash.flash_attention_ref(q, k, v)
    dvec = (g * out).sum(-1).transpose(1, 2).contiguous()
    flash._check_bwd(q, k, v, g, lse, dvec)
    with pytest.raises(ValueError, match="q's shape"):
        flash._check_bwd(q, k, v, g[:, :4], lse, dvec)
    with pytest.raises(TypeError, match="dO must be q's dtype"):
        flash._check_bwd(q, k, v, g.double(), lse, dvec)
    with pytest.raises(ValueError, match="contiguous"):
        flash._check_bwd(q, k, v, g.transpose(1, 2).contiguous().transpose(1, 2), lse, dvec)
    with pytest.raises(ValueError, match="lse must be"):
        flash._check_bwd(q, k, v, g, lse.transpose(1, 2), dvec)
    with pytest.raises(ValueError, match="D must be"):
        flash._check_bwd(q, k, v, g, lse, dvec.double())
    qb, kb = q.bfloat16(), k.bfloat16()
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash._check_bwd(qb, kb, kb, shifted, lse, dvec)


def test_bwd_source_and_wrapper_agree():
    bwd = flash.CSRC / "flash_bwd.cu"
    src = bwd.read_text()
    for d in flash.HEAD_DIMS:
        assert f"case {d}: return (int)launch_d<{d}>(dtype, which, a);" in src
    assert "dtype: 0 = float32, 1 = bfloat16" in src
    assert "which: 0 = the dQ kernel" in src
    assert bwd in flash._sources() and flash.SOURCE in flash._sources()
    # the sm90 dK/dV variant: its tile, cluster bound and the geometry check
    assert f"constexpr int kD90BlockN = {flash.DKV_SM90_BLOCK_KV};" in src
    assert f"constexpr int kMaxCluster = {flash.MAX_CLUSTER};" in src
    assert "grid_x != hkv * cluster || grid_y != b" in src
    assert "int gofr_flash_bwd_dkv_sm90(" in src and "int gofr_flash_bwd_dkv_sm90_smem()" in src
    # the sm90 dQ variant: its q tile, the grid the wrapper computes, its entry
    assert f"constexpr int kQ90BlockM = {flash.DQ_SM90_BLOCK_Q};" in src
    assert "grid_z != (sq + kQ90BlockM - 1) / kQ90BlockM" in src
    assert "int gofr_flash_bwd_dq_sm90(" in src and "int gofr_flash_bwd_dq_sm90_smem()" in src
    assert "a.causal ? a.n_qt - 1 - (int)blockIdx.z" in src  # longest first
    # every kernel of each family carries the name profile_training counts
    assert "flash_bwd_dkv_sm90_kernel(" in src and "flash_bwd_dq_sm90_kernel(" in src
    # the group sum is deterministic: no atomic adds anywhere in the source
    assert "atomicAdd" not in src and "red.global" not in src


# (groups, expected cluster, heads per block)
_GEOMETRY = [(1, 1, 1), (2, 2, 1), (4, 4, 1), (8, 8, 1), (16, 8, 2), (6, 6, 1), (12, 6, 2),
             (32, 8, 4)]


@pytest.mark.parametrize("groups, cluster, hpb", _GEOMETRY)
def test_dkv_sm90_geometry(groups, cluster, hpb):
    hkv = 8 if groups <= 4 else 2
    geo = flash.dkv_sm90_geometry(2, 2048, hkv * groups, hkv)
    assert geo["cluster"] == cluster and geo["heads_per_block"] == hpb
    assert cluster * hpb == groups and cluster <= flash.MAX_CLUSTER
    # clusters of heads along x, batch along y, key tiles along z
    assert geo["grid"] == (hkv * cluster, 2, 16)


def test_dkv_sm90_geometry_cuts_the_last_key_tile():
    assert flash.dkv_sm90_geometry(1, 200, 32, 8)["grid"] == (32, 1, 2)
    assert flash.dkv_sm90_geometry(3, 128, 8, 8)["grid"] == (8, 3, 1)


@pytest.mark.parametrize("dtype, sq, d, want", [
    (torch.bfloat16, 2048, 128, "sm90"),
    (torch.bfloat16, 1, 128, "sm90"),
    (torch.bfloat16, 0, 128, "mma"),
    (torch.bfloat16, 256, 64, "mma"),
    (torch.float32, 2048, 128, "mma"),
])
def test_dkv_variant_by_shape(dtype, sq, d, want):
    assert flash.dkv_variant(torch.zeros(1, sq, 4, d, dtype=dtype)) == want


# (q, expected dQ variant), as the forward's _VARIANTS
_DQ_VARIANTS = [
    ("training bf16 S=2048 D=128", torch.zeros(1, 2048, 32, 128, dtype=torch.bfloat16), "sm90"),
    ("ragged tail Sq=130", torch.zeros(2, 130, 8, 128, dtype=torch.bfloat16), "sm90"),
    ("one row", torch.zeros(1, 1, 4, 128, dtype=torch.bfloat16), "sm90"),
    ("no rows", torch.zeros(1, 0, 4, 128, dtype=torch.bfloat16), "mma"),
    ("f32 D=128", torch.zeros(1, 256, 4, 128), "mma"),
    ("bf16 D=64", torch.zeros(1, 256, 4, 64, dtype=torch.bfloat16), "mma"),
    ("bf16 D=16 tiny model", torch.zeros(1, 128, 4, 16, dtype=torch.bfloat16), "mma"),
    # q rows that are not 16-byte aligned: TMA cannot read them
    ("misaligned rows", torch.zeros(1, 128, 4, 132, dtype=torch.bfloat16)[..., :128], "mma"),
    # q as a view of the fused QKV projection: aligned strides, TMA reads it
    ("fused qkv view", torch.zeros(1, 128, 48, 128, dtype=torch.bfloat16)[:, :, :32], "sm90"),
]


@pytest.mark.parametrize("case", _DQ_VARIANTS, ids=[c[0] for c in _DQ_VARIANTS])
def test_dq_variant_by_shape(case):
    _, q, want = case
    assert flash.dq_variant(q) == want


@pytest.mark.parametrize("b, sq, hq, want", [
    (1, 2048, 32, (32, 1, 16)),
    (2, 300, 8, (8, 2, 3)),
    (2, 64, 4, (4, 2, 1)),
    (1, 129, 16, (16, 1, 2)),
])
def test_dq_sm90_grid(b, sq, hq, want):
    assert flash.dq_sm90_grid(b, sq, hq) == want


def test_bwd_variant_override_only_where_it_fits():
    assert flash._pick("flash_bwd_dq", "sm90", "mma") == "mma"
    with pytest.raises(ValueError, match="does not take this call"):
        flash._pick("flash_bwd_dq", "mma", "sm90")


# -- on the card only ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


_KERNEL_CASES = [
    # b, sq, skv, hq, hkv, d, dtype, causal, offsets, kv_lens
    (1, 256, 256, 8, 2, 128, torch.bfloat16, True, [0], [256]),
    (2, 300, 1024, 8, 2, 128, torch.bfloat16, True, [0, 500], [300, 800]),
    (2, 64, 128, 4, 2, 128, torch.bfloat16, True, [0, 64], [0, 128]),
    (2, 100, 100, 4, 4, 64, torch.bfloat16, False, [0, 0], [100, 37]),
    (2, 33, 70, 4, 2, 32, torch.bfloat16, True, [0, 30], [33, 63]),
    (1, 40, 40, 2, 1, 16, torch.bfloat16, True, [0], [40]),
    (2, 40, 128, 4, 2, 16, torch.float32, True, [0, 20], [40, 60]),
    (2, 37, 37, 4, 4, 32, torch.float32, False, [0, 0], [37, 0]),
    (1, 70, 70, 8, 2, 64, torch.float32, True, [0], [70]),
    (1, 50, 80, 4, 2, 128, torch.float32, True, [30], [80]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _KERNEL_CASES)
def test_kernels_match_plain_version(cuda, case):
    b, sq, skv, hq, hkv, d, dtype, causal, offs, lens = case
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    q, k, v, g = (torch.randn(b, s, h, d, device=cuda, generator=gen).to(dtype)
                  for s, h in ((sq, hq), (skv, hkv), (skv, hkv), (sq, hq)))
    offs = torch.tensor(offs, dtype=torch.int32, device=cuda)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    tail = (torch.arange(skv, device=cuda)[None, :] >= lens[:, None])[:, :, None, None]
    k, v = k.masked_fill(tail, 300.0), v.masked_fill(tail, float("nan"))
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    before = (flash.launches_dq.value, flash.launches_dkv.value)
    got = flash._launch_bwd(q, k, v, offs, lens, out, lse, g, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (flash.launches_dq.value, flash.launches_dkv.value) == (before[0] + 1, before[1] + 1)
    want = flash.flash_attention_bwd_ref(q, k, v, offs, lens, out, lse, g, causal, d ** -0.5)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.float().cpu().numpy(), w.float().cpu().numpy()
        assert np.isfinite(a).all(), name
        if dtype == torch.bfloat16:
            np.testing.assert_allclose(a, w, rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)
        else:
            np.testing.assert_allclose(a, w, rtol=F32_RTOL, atol=F32_ATOL, err_msg=name)
    dk, dv = got[1], got[2]
    assert bool((dk.masked_select(tail) == 0).all()) and bool((dv.masked_select(tail) == 0).all())


def _bwd_inputs(cuda, b, sq, skv, hq, hkv, offs, lens, poison=None, seed=0):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    q, k, v, g = (torch.randn(b, s, h, 128, device=cuda, generator=gen).to(torch.bfloat16)
                  for s, h in ((sq, hq), (skv, hkv), (skv, hkv), (sq, hq)))
    offs = torch.tensor(offs, dtype=torch.int32, device=cuda)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    if poison is not None:
        tail = (torch.arange(skv, device=cuda)[None, :] >= lens[:, None])[:, :, None, None]
        k, v = k.masked_fill(tail, poison), v.masked_fill(tail, poison)
    return q, k, v, g, offs, lens


def _dkv_matches_plain(q, k, v, g, offs, lens, causal):
    """The sm90 dK/dV kernel against the plain backward; -> (dk, dv)."""
    scale = 128 ** -0.5
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    do = g.contiguous()
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    before = (flash.launches_dkv.value, flash.launches_dkv_sm90.value)
    dk, dv = flash.launch_dkv(q, k, v, do, lse, dvec, offs, lens, causal, scale)
    torch.cuda.synchronize()
    assert (flash.launches_dkv.value, flash.launches_dkv_sm90.value) == (before[0] + 1,
                                                                        before[1] + 1)
    _, want_k, want_v = flash.flash_attention_bwd_ref(q, k, v, offs, lens, out, lse, g, causal,
                                                     scale)
    for name, a, w in (("dk", dk, want_k), ("dv", dv, want_v)):
        a, w = a.float().cpu().numpy(), w.float().cpu().numpy()
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, w, rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)
    tail = (torch.arange(k.shape[1], device=k.device)[None, :] >= lens[:, None])
    assert bool((dk[tail] == 0).all()) and bool((dv[tail] == 0).all())
    return dk, dv


# b, sq, skv, hq, hkv, causal, offsets, kv_lens
_DKV_SM90_CASES = [
    ("training shape", (1, 2048, 2048, 32, 8, True, [0], [2048])),
    ("tiles cut 130/200", (2, 130, 200, 8, 2, True, [0, 70], [130, 200])),
    ("ragged 300/1024", (2, 300, 1024, 8, 2, True, [0, 500], [300, 800])),
    ("kv_lens=0 row", (2, 64, 128, 4, 2, True, [0, 64], [0, 128])),
    ("non-causal", (2, 100, 333, 8, 2, False, [0, 0], [333, 37])),
    ("groups 1", (1, 256, 256, 4, 4, True, [0], [256])),
    ("groups 2", (1, 256, 256, 4, 2, True, [0], [256])),
    ("groups 4", (1, 256, 256, 8, 2, True, [0], [256])),
    ("groups 8", (1, 256, 256, 16, 2, True, [0], [256])),
    ("groups 16, two heads a block", (1, 192, 256, 16, 1, True, [64], [256])),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _DKV_SM90_CASES, ids=[c[0] for c in _DKV_SM90_CASES])
def test_sm90_dkv_matches_plain_version(cuda, case):
    b, sq, skv, hq, hkv, causal, offs, lens = case[1]
    q, k, v, g, offs, lens = _bwd_inputs(cuda, b, sq, skv, hq, hkv, offs, lens)
    assert flash.dkv_variant(q) == "sm90"
    dk, dv = _dkv_matches_plain(q, k, v, g, offs, lens, causal)
    if 0 in lens.tolist():
        row = lens.tolist().index(0)
        assert bool((dk[row] == 0).all()) and bool((dv[row] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [float("nan"), 300.0])
def test_sm90_dkv_poisoned_cache_slice_gives_exact_zeros(cuda, poison):
    # K/V one layer of a [L, B, 2048, 8, 128] cache, poisoned past kv_len:
    # TMA loads those rows, the kernel keeps them out of every product
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    b, sq, lens_ = 2, 256, [300, 1000]
    shape = (2, b, 2048, 8, 128)
    caches = [torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16) for _ in "kv"]
    for cache in caches:
        for i, n in enumerate(lens_):
            cache[:, i, n:] = poison
    q, g = (torch.randn(b, sq, 32, 128, device=cuda, generator=gen).to(torch.bfloat16)
            for _ in "qg")
    lens = torch.tensor(lens_, dtype=torch.int32, device=cuda)
    _dkv_matches_plain(q, caches[0][-1], caches[1][-1], g, lens - sq, lens, True)


@pytest.mark.cuda
def test_sm90_dkv_is_bit_identical_across_launches(cuda):
    # the GQA sum runs in a fixed order through the cluster: no atomics
    q, k, v, g, offs, lens = _bwd_inputs(cuda, 1, 2048, 2048, 32, 8, [0], [2048], seed=5)
    out, lse = flash.flash_attention_fwd(q, k, v, True, offs, lens)
    dvec = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g, lse, dvec, offs, lens, True, 128 ** -0.5)
    first = flash.launch_dkv(*args)
    for _ in range(2):
        again = flash.launch_dkv(*args)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
def test_autograd_on_the_card_takes_a_non_contiguous_grad(cuda):
    # dO from autograd can be a transposed view; the wrapper makes it
    # contiguous before the kernels read it
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    q, k, v = (torch.randn(1, 128, h, 128, device=cuda, generator=gen).to(torch.bfloat16)
               for h in (8, 2, 2))
    g = torch.randn(1, 8, 128, 128, device=cuda, generator=gen).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash.launches_dq.value, flash.launches_dkv.value)
    out = flash.flash_attention(*leaves)
    (out.transpose(1, 2) * g).float().sum().backward()
    torch.cuda.synchronize()
    assert (flash.launches_dq.value, flash.launches_dkv.value) == (before[0] + 1, before[1] + 1)
    ref_out, lse = flash.flash_attention_ref(q, k, v)
    want = flash.flash_attention_bwd_ref(q, k, v, 0, None, ref_out, lse,
                                         g.transpose(1, 2), True, 128 ** -0.5)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.float().cpu().numpy(), w.float().cpu().numpy(),
                                   rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_read_strided_inputs(cuda, dtype):
    # q, k and v as views of one packed [B, S, Hq + 2*Hkv, D] projection:
    # the kernels follow the strides they are given
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    b, s, hq, hkv, d = 2, 96, 8, 2, 64
    qkv = torch.randn(b, s, hq + 2 * hkv, d, device=cuda, generator=gen).to(dtype)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    g = torch.randn(b, s, hq, d, device=cuda, generator=gen).to(dtype)
    offs = torch.tensor([0, 10], dtype=torch.int32, device=cuda)
    lens = torch.tensor([96, 90], dtype=torch.int32, device=cuda)
    out, lse = flash.flash_attention_fwd(q, k, v, True, offs, lens)
    got = flash._launch_bwd(q, k, v, offs, lens, out, lse, g, True, d ** -0.5)
    want = flash.flash_attention_bwd_ref(q, k, v, offs, lens, out, lse, g, True, d ** -0.5)
    tol = (BF16_TOL, BF16_TOL) if dtype == torch.bfloat16 else (F32_RTOL, F32_ATOL)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.float().cpu().numpy(), w.float().cpu().numpy(),
                                   rtol=tol[0], atol=tol[1])


def _dq_matches_plain(q, k, v, g, offs, lens, causal):
    """The sm90 dQ kernel against the plain backward; -> dq."""
    scale = 128 ** -0.5
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    do = g.contiguous()
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    before = (flash.launches_dq.value, flash.launches_dq_sm90.value)
    dq = flash.launch_dq(q, k, v, do, lse, dvec, offs, lens, causal, scale)
    torch.cuda.synchronize()
    assert (flash.launches_dq.value, flash.launches_dq_sm90.value) == (before[0] + 1,
                                                                      before[1] + 1)
    want = flash.flash_attention_bwd_ref(q, k, v, offs, lens, out, lse, g, causal, scale)[0]
    a, w = dq.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, w, rtol=BF16_TOL, atol=BF16_TOL)
    return dq


@pytest.mark.cuda
@pytest.mark.parametrize("case", _DKV_SM90_CASES, ids=[c[0] for c in _DKV_SM90_CASES])
def test_sm90_dq_matches_plain_version(cuda, case):
    b, sq, skv, hq, hkv, causal, offs, lens = case[1]
    q, k, v, g, offs, lens = _bwd_inputs(cuda, b, sq, skv, hq, hkv, offs, lens)
    assert flash.dq_variant(q) == "sm90"
    dq = _dq_matches_plain(q, k, v, g, offs, lens, causal)
    if 0 in lens.tolist():
        assert bool((dq[lens.tolist().index(0)] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [float("nan"), 300.0])
def test_sm90_dq_reads_a_poisoned_cache_slice(cuda, poison):
    # TMA loads the K/V rows past kv_len; the kernel zeroes those K rows and
    # selects dS to 0 there, so dQ stays finite and right
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    b, sq, lens_ = 2, 256, [300, 1000]
    caches = [torch.randn(2, b, 2048, 8, 128, device=cuda, generator=gen).to(torch.bfloat16)
              for _ in "kv"]
    for cache in caches:
        for i, n in enumerate(lens_):
            cache[:, i, n:] = poison
    q, g = (torch.randn(b, sq, 32, 128, device=cuda, generator=gen).to(torch.bfloat16)
            for _ in "qg")
    lens = torch.tensor(lens_, dtype=torch.int32, device=cuda)
    _dq_matches_plain(q, caches[0][-1], caches[1][-1], g, lens - sq, lens, True)


@pytest.mark.cuda
def test_sm90_dq_is_bit_identical_and_reads_no_device_value(cuda):
    # each block owns its dQ rows: no atomics, the same bits every launch;
    # the wrapper syncs nothing with the host
    q, k, v, g, offs, lens = _bwd_inputs(cuda, 1, 2048, 2048, 32, 8, [0], [2048], seed=7)
    out, lse = flash.flash_attention_fwd(q, k, v, True, offs, lens)
    dvec = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g, lse, dvec, offs, lens, True, 128 ** -0.5)
    first = flash.launch_dq(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = flash.launch_dq(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, again)
