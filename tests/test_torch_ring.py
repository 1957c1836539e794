"""Ring attention (``parallel/ring.py``) against the JAX package's ring under
its ``shard_map``, on the CPU, at dp=2 x sp=2 and sp=4: the five cases of
``tests/test_ring.py`` (attention against one device, the forward and the
loss against the unsharded model, the gradients against ``jax.grad`` of
``make_ring_loss``, the overlong sequence refused), the ring Function's
backward against torch autograd through a plain online-softmax ring, and
the transformer's attention hook and absolute positions against the JAX
``_block``'s ``attn_fn``.

The config is the JAX multichip dry run's (vocab 128, dim 32, 2 layers,
4 heads, 2 KV heads, hidden 64, max_seq 64, f32). JAX initialises; the
weights cross through ``models/convert.py``. On the CPU the ring's pairs
run the flash kernels' plain versions (``flash_attention_fwd`` /
``flash_attention_bwd``). Tolerances: attention 2e-5 (``tests/test_ring.py``'s),
logits and loss 1e-5 relative, gradients 1e-4 relative with 1e-5 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gofr_tpu.models import transformer as jt
from gofr_tpu.models.quant import mm as jax_mm
from gofr_tpu.ops.attention import attention as jax_attention
from gofr_tpu.ops.norms import rms_norm as jax_rms_norm
from gofr_tpu.parallel import ring as jring
from gofr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gofr_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from gofr_tpu.training.trainer import cross_entropy_loss as jax_loss
from gofr_tpu_torch.models.convert import transformer_from_tree, tree_from_transformer
from gofr_tpu_torch.models.transformer import TransformerConfig
from gofr_tpu_torch.ops import flash
from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.parallel import mesh as pm
from gofr_tpu_torch.parallel import ring
from gofr_tpu_torch.training.trainer import cross_entropy_loss

JCFG = jt.TransformerConfig(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                            hidden_dim=64, max_seq=64, dtype=jnp.float32, attn_impl="xla")
CFG = TransformerConfig(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                        hidden_dim=64, max_seq=64, dtype=torch.float32)
MESHES = {"dp2-sp2": 2, "sp4": 4}  # name -> sp over 4 devices (dp fills the rest)
ATTN_TOL = 2e-5


def jax_mesh(sp: int, n: int = 4):
    return jax_make_mesh(jax_mesh_shape_for(n, sp=sp), devices=jax.devices()[:n])


def port_mesh(sp: int, n: int = 4) -> pm.Mesh:
    return pm.make_mesh(pm.mesh_shape_for(n, sp=sp), devices=[torch.device("cpu")] * n)


@functools.lru_cache(maxsize=1)
def tree():
    return jax.tree.map(np.asarray, jt.init_transformer(jax.random.PRNGKey(3), JCFG))


def model(trainable: bool = False):
    m = transformer_from_tree(tree(), CFG, device="cpu")
    for p in m.parameters():
        p.requires_grad_(trainable)
    return m


def tokens(seed: int, shape=(4, 64)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape).astype(np.int32)


def grads_tree(m, loss) -> dict:
    """d loss / d params in the JAX tree layout."""
    params = list(m.parameters())
    grads = torch.autograd.grad(loss, params)
    for p, g in zip(params, grads):
        p.data = g
    return tree_from_transformer(m)


def assert_grads(got: dict, want: dict) -> None:
    for key in ("embed", "norm_f", "lm_head"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    for key, w in want["layers"].items():
        np.testing.assert_allclose(got["layers"][key], np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def qkv(seed: int, b=2, s=32, hq=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


def port_sharded(fn, mesh: pm.Mesh, *arrays):
    """``fn`` over each dp row group's sequence shards, reassembled."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    rows = []
    for g in range(dp):
        parts = [[t for t in torch.from_numpy(a).chunk(dp)[g].chunk(sp, dim=1)] for a in arrays]
        rows.append(torch.cat(fn(*parts), dim=1))
    return torch.cat(rows)


@pytest.mark.parametrize("name", list(MESHES))
def test_ring_attention_matches_single_device(name):
    sp = MESHES[name]
    q, k, v = qkv(0)
    jfn = jax.jit(jax.shard_map(
        lambda q, k, v: jring.ring_attention(q, k, v, axis_name="sp", causal=True),
        mesh=jax_mesh(sp), in_specs=(P("dp", "sp"),) * 3, out_specs=P("dp", "sp"),
        check_vma=False))
    want = np.asarray(jfn(q, k, v))
    single = np.asarray(jax_attention(q, k, v, causal=True, impl="xla"))
    got = port_sharded(ring.ring_attention, port_mesh(sp), q, k, v).numpy()
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(got, single, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_ring_forward_matches_unsharded(name):
    sp, toks = MESHES[name], tokens(4)
    want = np.asarray(jring.make_ring_forward(JCFG, jax_mesh(sp))(
        jax.tree.map(jnp.asarray, tree()), jnp.asarray(toks)))
    m = model()
    with torch.no_grad():
        got = ring.make_ring_forward(CFG, port_mesh(sp))(m, toks).numpy()
        plain = m.transformer_forward(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(MESHES))
def test_ring_loss_matches_unsharded(name):
    sp, toks = MESHES[name], tokens(6)
    jparams = jax.tree.map(jnp.asarray, tree())
    want = float(jring.make_ring_loss(JCFG, jax_mesh(sp))(jparams, jnp.asarray(toks)))
    unsharded = float(jax_loss(jparams, jnp.asarray(toks), JCFG))
    m = model()
    with torch.no_grad():
        got = float(ring.make_ring_loss(CFG, port_mesh(sp))(m, toks))
        plain = float(cross_entropy_loss(m, torch.from_numpy(toks)))
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(unsharded, rel=1e-5)
    assert got == pytest.approx(plain, rel=1e-5)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("remat", [False, True], ids=["", "remat"])
def test_ring_loss_grads_match_jax(name, remat):
    sp, toks = MESHES[name], tokens(8, (2, 32))
    loss_fn = jring.make_ring_loss(JCFG, jax_mesh(sp))
    want = jax.jit(jax.grad(lambda p: loss_fn(p, jnp.asarray(toks))))(
        jax.tree.map(jnp.asarray, tree()))
    m = model(trainable=True)
    got = grads_tree(m, ring.make_ring_loss(CFG, port_mesh(sp), remat=remat)(m, toks))
    assert_grads(got, want)
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in jax.tree.leaves(got)))
    assert np.isfinite(norm) and norm > 0


def test_ring_forward_rejects_overlong_sequence():
    toks = np.ones((2, 256), np.int32)  # sp=4 x 64 local = 256 > max_seq 64
    with pytest.raises(ValueError, match="max_seq") as want:
        jring.make_ring_forward(JCFG, jax_mesh(4))(jax.tree.map(jnp.asarray, tree()),
                                                   jnp.asarray(toks))
    with pytest.raises(ValueError, match="max_seq") as got:
        ring.make_ring_forward(CFG, port_mesh(4))(model(), toks)
    assert str(got.value) == str(want.value)


def plain_ring(qs, ks, vs, causal: bool) -> list:
    """The JAX ring's online softmax written out in torch (autograd
    differentiates it): each query chunk against every K/V chunk, masked."""
    n, (b, s, hq, d) = len(qs), qs[0].shape
    hkv = ks[0].shape[2]
    g, scale = hq // hkv, d ** -0.5
    outs = []
    for i, q in enumerate(qs):
        qg = q.reshape(b, s, hkv, g, d)
        m = torch.full((b, hkv, g, s, 1), -1e30)
        l = torch.zeros((b, hkv, g, s, 1))
        acc = torch.zeros((b, hkv, g, s, d))
        q_pos = i * s + torch.arange(s)
        for j in range(n):
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, ks[j]) * scale
            if causal:
                mask = (j * s + torch.arange(s))[None, :] <= q_pos[:, None]
                sc = torch.where(mask, sc, torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha, p = torch.exp(m - m_new), torch.exp(sc - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p, vs[j])
            m = m_new
        outs.append((acc / l).permute(0, 3, 1, 2, 4).reshape(b, s, hq, d))
    return outs


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_backward_matches_autograd_of_a_plain_ring(causal):
    arrays = qkv(11, b=2, s=48, hq=4, hkv=2, d=16)
    rng = np.random.default_rng(12)
    cot = torch.from_numpy(rng.standard_normal(arrays[0].shape, dtype=np.float32)).chunk(3, 1)
    results = []
    for fn in (functools.partial(ring.ring_attention, causal=causal),
               functools.partial(plain_ring, causal=causal)):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        shards = [list(t.chunk(3, dim=1)) for t in leaves]
        outs = fn(*shards)
        loss = sum((o * c).sum() for o, c in zip(outs, cot))
        results.append((torch.cat(outs, 1).detach(), torch.autograd.grad(loss, leaves)))
    (got, got_g), (want, want_g) = results
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ATTN_TOL, atol=ATTN_TOL)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_flash_attention_bwd_dispatches_by_device():
    q, k, v = (torch.from_numpy(a) for a in qkv(13, s=8))
    out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    do = torch.ones_like(out)
    got = flash.flash_attention_bwd(q, k, v, 0, None, out, lse, do, True)
    want = flash.flash_attention_bwd_ref(q, k, v, 0, None, out, lse, do, True, 16 ** -0.5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    meta = [t.to("meta") for t in (q, k, v, out, lse, do)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash.flash_attention_bwd(*meta[:3], 0, None, *meta[3:], True)


def test_attention_hook_and_positions_match_the_jax_block():
    """``transformer_forward(positions=, attn_fn=)``: a shard at absolute
    positions 16.. with a non-causal attention in place of the causal one,
    against the JAX ``_block`` scanned with the same ``attn_fn``; the
    default hook is the plain forward, bit for bit."""
    toks = tokens(14, (2, 16))
    positions = np.arange(16, 32)
    params = jax.tree.map(jnp.asarray, tree())
    freqs = jnp.asarray(jt._cached_freqs(JCFG.head_dim, JCFG.max_seq, JCFG.rope_theta))

    def jax_fn(q, k, v):
        return jax_attention(q, k, v, causal=False, impl="xla")

    def body(x, p):
        y, _, _ = jt._block(JCFG, p, x, freqs, jnp.asarray(positions), attn_fn=jax_fn)
        return y, None

    x, _ = jax.lax.scan(body, params["embed"][jnp.asarray(toks)], params["layers"])
    want = np.asarray(jax_mm(jax_rms_norm(x, params["norm_f"], JCFG.norm_eps),
                             params["lm_head"]))
    m = model()
    with torch.no_grad():
        got = m.transformer_forward(torch.from_numpy(toks), positions=torch.from_numpy(positions),
                                    attn_fn=lambda q, k, v: attention(q, k, v, causal=False))
        hooked = m.transformer_forward(torch.from_numpy(toks),
                                       attn_fn=lambda q, k, v: attention(q, k, v, causal=True))
        plain = m.transformer_forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(hooked, plain)
