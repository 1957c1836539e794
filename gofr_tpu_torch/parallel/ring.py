"""Ring attention: sequence parallelism over the ``sp`` mesh axis.

Port of ``gofr_tpu/parallel/ring.py``. A sequence too long for one
device is split over the ``sp`` axis: shard ``i`` of ``n`` holds the
tokens, activations, K and V of positions ``i·S_local .. (i+1)·S_local``.
Everything in a block but attention is pointwise over the sequence, so
each shard runs the decoder's own projections, norms and MLP
(``Transformer._qkv``, ``_attn_out``, ``_mlp_half``) and ropes its
absolute positions; attention is injected, as the JAX ``_block``'s
``attn_fn`` is: the ring here, Ulysses' all-to-all in ``ulysses.py``.

One process drives every shard (the port's single controller): a layer
runs the projections of all ``n`` shards, the injected attention over
their q/k/v lists, then each shard's output product and MLP. A shard on
another device reads the weights through ``.to(device)``, whose gradient
sums back to the one copy (the JAX ``psum`` over replicated in_specs).

The JAX ring is an online softmax in ``jnp`` over the chunk pairs. The
port computes the same function through the hand-written flash kernels
(:class:`_RingAttention`): query chunk ``i`` attends K/V chunk ``j < i``
with every key visible (``causal=False``) and chunk ``i`` causally; a
chunk ``j > i`` is all masked and is skipped (JAX burns a masked matmul
there, for the same result). The chunks' ``(out, lse)`` merge by
log-sum-exp in f32 into the global output and LSE (the output rounds to
the inputs' dtype once; the backward keeps the f32 merge for its D =
rowsum(dO ⊙ O)). The backward runs the
pairs again through ``flash_attention_bwd`` with the GLOBAL out and LSE, so
the kernels' P = exp(S − LSE) is each chunk's share of the global softmax;
dQ sums over the pairs in f32, and each dK/dV partial goes back to its
chunk's owner, summed there in f32.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gofr_tpu_torch.models.quant import Pack, mm
from gofr_tpu_torch.models.transformer import _LAYER_SHAPES, Block, Transformer, TransformerConfig
from gofr_tpu_torch.ops.flash import flash_attention_bwd, flash_attention_fwd
from gofr_tpu_torch.ops.loss import next_token_nll
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.parallel.mesh import Mesh

# an injected sequence-parallel attention: (q shards, k shards, v shards) ->
# the output shards, each [B, S_local, H, D] on its shard's device
SPAttention = Callable[[list, list, list], list]


def _pairs(i: int, n: int, causal: bool) -> range:
    """The K/V chunks query chunk ``i`` attends: 0..i when causal, all n
    otherwise."""
    return range(i + 1) if causal else range(n)


def merge_chunks(parts: list) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunks' (out [B, Sq, H, D], lse [B, H, Sq]) -> the global (out, lse
    f32): lse = logsumexp_j lse_j, out = sum_j exp(lse_j − lse)·out_j,
    summed in f32 and kept in f32 (one chunk: its own out as it is)."""
    if len(parts) == 1:
        return parts[0]
    lse = torch.logsumexp(torch.stack([p[1] for p in parts]), dim=0)
    acc = None
    for out, part_lse in parts:
        weight = torch.exp(part_lse - lse).transpose(1, 2)[..., None]  # [B, Sq, H, 1]
        term = out.float() * weight
        acc = term if acc is None else acc + term
    return acc, lse


class _RingAttention(torch.autograd.Function):
    """Ring attention over ``n`` sequence shards: ``forward(n, causal,
    scale, *qs, *ks, *vs)`` -> the output shards, each on its query shard's
    device."""

    @staticmethod
    def forward(ctx, n: int, causal: bool, scale: float, *shards: torch.Tensor):
        qs, ks, vs = shards[:n], shards[n:2 * n], shards[2 * n:]
        merges, lses = [], []
        for i, q in enumerate(qs):
            parts = [flash_attention_fwd(q, ks[j].to(q.device), vs[j].to(q.device),
                                         causal=causal and j == i, scale=scale)
                     for j in _pairs(i, n, causal)]
            merged, lse = merge_chunks(parts)
            merges.append(merged)
            lses.append(lse)
        ctx.n, ctx.causal, ctx.scale = n, causal, scale
        # the backward's D = rowsum(dO ⊙ O) reads the f32 merge: a difference
        # dP − D of near-equal terms follows, and a second bf16 rounding of O
        # (after the chunks' own) would show there
        ctx.save_for_backward(*qs, *ks, *vs, *merges, *lses)
        return tuple(m.to(q.dtype) for m, q in zip(merges, qs))

    @staticmethod
    def backward(ctx, *douts: torch.Tensor):
        n, causal, scale = ctx.n, ctx.causal, ctx.scale
        saved = ctx.saved_tensors
        qs, ks, vs, merges, lses = (saved[a * n:(a + 1) * n] for a in range(5))
        dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
        dvs = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
        dqs = []
        for i, q in enumerate(qs):
            do = douts[i].contiguous()
            dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            for j in _pairs(i, n, causal):
                dq_ij, dk_ij, dv_ij = flash_attention_bwd(
                    q, ks[j].to(q.device), vs[j].to(q.device), 0, None, merges[i], lses[i], do,
                    causal=causal and j == i, scale=scale,
                )
                dq += dq_ij.float()
                dks[j] += dk_ij.float().to(dks[j].device)
                dvs[j] += dv_ij.float().to(dvs[j].device)
            dqs.append(dq.to(q.dtype))
        return (None, None, None, *dqs,
                *(d.to(k.dtype) for d, k in zip(dks, ks)),
                *(d.to(v.dtype) for d, v in zip(dvs, vs)))


def ring_attention(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    causal: bool = True,
    scale: Optional[float] = None,
) -> list[torch.Tensor]:
    """Blockwise ring attention over sequence shards: ``qs[i]`` [B, S_local,
    Hq, D] and ``ks[i]`` / ``vs[i]`` [B, S_local, Hkv, D] hold positions
    ``i·S_local ..`` on shard ``i``'s device. Returns the output shards,
    differentiable through the flash kernels' backward."""
    n = len(qs)
    if not (len(ks) == len(vs) == n):
        raise ValueError(f"{n} q shards, {len(ks)} k shards, {len(vs)} v shards")
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    return list(_RingAttention.apply(n, causal, float(scale), *qs, *ks, *vs))


def _ring(qs: list, ks: list, vs: list) -> list:
    return ring_attention(qs, ks, vs, causal=True)


# -- the per-shard transformer ---------------------------------------------------

def layer_on(layer: Block, device: torch.device) -> Block:
    """``layer`` with its weights read on ``device``: itself where it
    lives there, else a view whose tensors are ``.to(device)`` copies (their
    gradients return to the originals)."""
    if layer.attn_norm.device == device:
        return layer
    out = Block.__new__(Block)
    nn.Module.__init__(out)
    for name in ("attn_norm", "mlp_norm", *_LAYER_SHAPES):
        w = getattr(layer, name)
        setattr(out, name, Pack({k: t.to(device) for k, t in w.pack.items()})
                if isinstance(w, Pack) else w.to(device))
    return out


def _sp_layer(model: Transformer, layer: Block, positions: list, attn: SPAttention,
              *xs: torch.Tensor) -> tuple:
    """One decoder layer over the sequence shards ``xs`` in lockstep: every
    shard's projections, the injected attention over them, then each
    shard's output product and MLP with their residuals."""
    cfg = model.cfg
    layers = [layer_on(layer, x.device) for x in xs]
    qkv = [model._qkv(lay, x, pos, cfg.n_heads, cfg.n_kv_heads)
           for lay, x, pos in zip(layers, xs, positions)]
    outs = attn(*(list(t) for t in zip(*qkv)))
    xs = [x + model._attn_out(lay, o) for lay, x, o in zip(layers, xs, outs)]
    return tuple(x + model._mlp_half(lay, x) for lay, x in zip(layers, xs))


def _shard_forward(model: Transformer, tokens: list, devices: list,
                   attn: Optional[SPAttention] = None, remat: bool = False) -> list:
    """The transformer over one row group's sequence shards: ``tokens[i]``
    [B, S_local] on ``devices[i]`` -> f32 logits [B, S_local, V] each, RoPE
    at the shards' absolute positions. ``attn`` defaults to the ring."""
    cfg = model.cfg
    n, s = len(tokens), tokens[0].shape[1]
    if s * n > cfg.max_seq:
        raise ValueError(
            f"global sequence {s * n} exceeds cfg.max_seq {cfg.max_seq} "
            "(RoPE table bound) — raise max_seq for long-context configs"
        )
    attn = attn or _ring
    positions = [torch.arange(i * s, (i + 1) * s, device=d) for i, d in enumerate(devices)]
    xs = tuple(model.embed.to(d)[t.to(d).long()] for t, d in zip(tokens, devices))
    for layer in model.layers:
        step = functools.partial(_sp_layer, model, layer, positions, attn)
        xs = checkpoint(step, *xs, use_reentrant=False) if remat else step(*xs)
    return [mm(rms_norm(x, model.norm_f.to(x.device), cfg.norm_eps),
               model.lm_head.to(x.device)).float() for x in xs]


def _shard_loss(model: Transformer, tokens: list, devices: list,
                attn: Optional[SPAttention] = None, remat: bool = False) -> torch.Tensor:
    """One row group's next-token loss over its sequence shards: the target
    of a shard's last position is the next shard's first token, and the
    global last position (no next token) is masked; the mean over the
    group's positions, on ``devices[0]``."""
    n = len(tokens)
    logits = _shard_forward(model, tokens, devices, attn, remat)
    total = count = None
    for i, (lg, t) in enumerate(zip(logits, tokens)):
        nxt = tokens[(i + 1) % n][:, :1].to(t.device)
        targets = torch.cat([t[:, 1:], nxt], dim=1).to(lg.device)
        weight = torch.ones(targets.shape, dtype=torch.float32, device=lg.device)
        if i == n - 1:
            weight[:, -1] = 0.0
        part_sum = (next_token_nll(lg, targets) * weight).sum().to(devices[0])
        part_cnt = weight.sum().to(devices[0])
        total = part_sum if total is None else total + part_sum
        count = part_cnt if count is None else count + part_cnt
    return total / count


# -- the entry points over a mesh ------------------------------------------------

def check_config(model: Transformer, cfg: TransformerConfig) -> None:
    if model.cfg != cfg:
        raise ValueError("the model was built for another config")


def row_groups(mesh: Mesh, batch_axes: Sequence[str]) -> list[dict]:
    """The coordinates of each row group over ``batch_axes`` (row-major,
    as a JAX ``PartitionSpec`` over those axes splits the batch)."""
    groups = [{}]
    for axis in batch_axes:
        groups = [dict(g, **{axis: i}) for g in groups for i in range(mesh.shape[axis])]
    return groups


def split_batch(tokens: torch.Tensor, n_groups: int) -> list[torch.Tensor]:
    """The batch's rows in ``n_groups`` equal groups; a batch they do not
    divide raises (JAX's sharded input refuses it too)."""
    b = tokens.shape[0]
    if b % n_groups:
        raise ValueError(f"batch {b} does not split over {n_groups} row groups")
    return list(tokens.chunk(n_groups))


def _sp_shards(mesh: Mesh, coords: dict, tokens: torch.Tensor) -> tuple[list, list]:
    """A row group's tokens [b, S] split over ``sp`` onto its devices."""
    sp = mesh.shape["sp"]
    if tokens.shape[1] % sp:
        raise ValueError(f"sequence {tokens.shape[1]} does not split over sp={sp}")
    devices = [mesh.device(**coords, sp=i) for i in range(sp)]
    return [t.to(d) for t, d in zip(tokens.chunk(sp, dim=1), devices)], devices


def make_sp_forward(cfg: TransformerConfig, mesh: Mesh, batch_axes: Sequence[str],
                    attn: SPAttention, remat: bool = False) -> Callable:
    """``forward(model, tokens [B, S]) -> f32 logits [B, S, V]`` on the
    mesh's first device, the batch over ``batch_axes``, the sequence over
    ``sp``, attention by ``attn``."""

    def forward(model: Transformer, tokens) -> torch.Tensor:
        check_config(model, cfg)
        tokens = torch.as_tensor(tokens)
        groups = row_groups(mesh, batch_axes)
        out = []
        for coords, rows in zip(groups, split_batch(tokens, len(groups))):
            shards, devices = _sp_shards(mesh, coords, rows)
            logits = _shard_forward(model, shards, devices, attn, remat)
            out.append(torch.cat([lg.to(mesh.devices[0]) for lg in logits], dim=1))
        return torch.cat(out)

    return forward


def make_sp_loss(cfg: TransformerConfig, mesh: Mesh, batch_axes: Sequence[str],
                 attn: SPAttention, remat: bool = False) -> Callable:
    """``loss(model, tokens [B, S]) -> scalar`` on the mesh's first device:
    each row group's mean over its sequence shards, then the mean over the
    groups (each holds the same number of positions)."""

    def loss(model: Transformer, tokens) -> torch.Tensor:
        check_config(model, cfg)
        tokens = torch.as_tensor(tokens)
        groups = row_groups(mesh, batch_axes)
        losses = []
        for coords, rows in zip(groups, split_batch(tokens, len(groups))):
            shards, devices = _sp_shards(mesh, coords, rows)
            losses.append(_shard_loss(model, shards, devices, attn, remat).to(mesh.devices[0]))
        return sum(losses[1:], losses[0]) / len(losses)

    return loss


def make_ring_forward(cfg: TransformerConfig, mesh: Mesh, batch_axes=("dp", "fsdp"),
                      remat: bool = False) -> Callable:
    """Full-sequence forward with the sequence over ``sp`` and ring
    attention: ``forward(model, tokens [B, S]) -> logits [B, S, V]``. The
    weights are the unsharded model's (replicated over sp, as in JAX)."""
    return make_sp_forward(cfg, mesh, batch_axes, _ring, remat)


def make_ring_loss(cfg: TransformerConfig, mesh: Mesh, batch_axes=("dp", "fsdp"),
                   remat: bool = False) -> Callable:
    """Sequence-parallel next-token loss with ring attention:
    ``loss(model, tokens [B, S]) -> scalar``, differentiable (``remat``
    recomputes each layer in the backward)."""
    return make_sp_loss(cfg, mesh, batch_axes, _ring, remat)

