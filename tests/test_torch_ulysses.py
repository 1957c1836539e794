"""Ulysses all-to-all context parallelism (``parallel/ulysses.py``) against
the JAX package's on the CPU: the five cases of ``tests/test_ulysses.py``
(attention against one device with the K/V repeat at Hkv % sp != 0 and
without it, the head-divisibility refusal with the JAX message, the
forward against the unsharded model, the loss against the ring's with
gradients against ``jax.grad`` of ``make_ulysses_loss``).

The config and the weights are ``tests/test_torch_ring.py``'s (the JAX
multichip dry run's config, JAX's init, ``models/convert.py``).
Tolerances: attention 2e-5, logits and loss 1e-5 relative, gradients 1e-4
relative with 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gofr_tpu.ops.attention import attention as jax_attention
from gofr_tpu.parallel import ulysses as julysses
from gofr_tpu.parallel.ring import make_ring_loss as jax_ring_loss
from gofr_tpu_torch.parallel import ring, ulysses
from test_torch_ring import (
    ATTN_TOL,
    CFG,
    JCFG,
    assert_grads,
    grads_tree,
    jax_mesh,
    model,
    port_mesh,
    port_sharded,
    qkv,
    tokens,
    tree,
)


def _jax_attn(mesh):
    return jax.jit(jax.shard_map(
        lambda q, k, v: julysses.ulysses_attention(q, k, v, axis_name="sp"),
        mesh=mesh, in_specs=(P("dp", "sp"),) * 3, out_specs=P("dp", "sp"), check_vma=False))


@pytest.mark.parametrize("sp, n, shape", [
    (4, 8, dict(b=2, s=32, hq=4, hkv=2, d=16)),  # hkv=2 does not divide sp=4: repeat
    (2, 4, dict(b=2, s=16, hq=4, hkv=2, d=8)),   # hkv=2 divides sp=2: no repeat
], ids=["repeat-kv", "divisible-kv"])
def test_ulysses_attention_matches_single_device(sp, n, shape):
    q, k, v = qkv(0, **shape)
    want = np.asarray(_jax_attn(jax_mesh(sp, n))(q, k, v))
    single = np.asarray(jax_attention(q, k, v, causal=True, impl="xla"))
    got = port_sharded(ulysses.ulysses_attention, port_mesh(sp, n), q, k, v).numpy()
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(got, single, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_ulysses_head_divisibility_enforced():
    toks = np.ones((2, 64), np.int32)  # 4 heads; sp=8 cannot split them
    with pytest.raises(ValueError, match="n_heads") as want:
        julysses.make_ulysses_forward(JCFG, jax_mesh(8, 8), batch_axes=())(
            jax.tree.map(jnp.asarray, tree()), jnp.asarray(toks))
    with pytest.raises(ValueError, match="n_heads") as got:
        ulysses.make_ulysses_forward(CFG, port_mesh(8, 8), batch_axes=())(model(), toks)
    assert str(got.value) == str(want.value)


def test_ulysses_forward_matches_unsharded():
    toks = tokens(4)
    want = np.asarray(julysses.make_ulysses_forward(JCFG, jax_mesh(4, 8))(
        jax.tree.map(jnp.asarray, tree()), jnp.asarray(toks)))
    m = model()
    with torch.no_grad():
        got = ulysses.make_ulysses_forward(CFG, port_mesh(4, 8))(m, toks).numpy()
        plain = m.transformer_forward(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


def test_ulysses_loss_matches_ring_and_grads_flow():
    toks = tokens(6)
    jparams = jax.tree.map(jnp.asarray, tree())
    jmesh = jax_mesh(4, 8)
    want_loss, want_grads = jax.value_and_grad(julysses.make_ulysses_loss(JCFG, jmesh))(
        jparams, jnp.asarray(toks))
    want_ring = float(jax_ring_loss(JCFG, jmesh)(jparams, jnp.asarray(toks)))
    m = model(trainable=True)
    mesh = port_mesh(4, 8)
    loss = ulysses.make_ulysses_loss(CFG, mesh)(m, toks)
    with torch.no_grad():
        ring_loss = float(ring.make_ring_loss(CFG, mesh)(m, toks))
    value = float(loss.detach())
    assert value == pytest.approx(float(want_loss), rel=1e-5)
    assert value == pytest.approx(ring_loss, rel=1e-5)
    assert value == pytest.approx(want_ring, rel=1e-5)
    got = grads_tree(m, loss)
    assert_grads(got, want_grads)
    leaves = jax.tree.leaves(got)
    assert all(np.isfinite(g).all() for g in leaves) and any(np.abs(g).max() > 0 for g in leaves)
