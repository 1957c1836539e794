"""Ulysses-style context parallelism: all-to-all sequence parallelism over
the ``sp`` mesh axis.

Port of ``gofr_tpu/parallel/ulysses.py``, the second long-context strategy
beside ring attention (``parallel/ring.py``). Where the ring keeps the
sequence split and walks the K/V chunks, Ulysses re-splits around each
attention: heads scatter and the sequence gathers, so each shard holds the
WHOLE sequence for Hq/sp of the heads and runs the ordinary flash kernel
(``ops/attention.py``) over it; a second re-split restores the sequence
split. In JAX these are two ``all_to_all`` collectives; one process driving
every shard does them as concatenations of slices, each moved to the
device that needs it (``.to``: no copy where the shards share a device; the
gradient of each move returns to its source).

Ulysses needs n_heads % sp == 0; KV heads that do not divide sp are
repeated up to n_heads first (GQA degrades toward MHA under a large sp).
Everything else in a block is the ring's per-shard transformer
(``ring._shard_forward`` / ``_shard_loss`` with this attention injected).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from gofr_tpu_torch.models.transformer import TransformerConfig
from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.parallel.mesh import Mesh
from gofr_tpu_torch.parallel.ring import make_sp_forward, make_sp_loss


def ulysses_attention(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    causal: bool = True,
    scale: Optional[float] = None,
) -> list[torch.Tensor]:
    """All-to-all attention over sequence shards: ``qs[i]`` [B, S_local, Hq,
    D], ``ks[i]`` / ``vs[i]`` [B, S_local, Hkv, D] on shard ``i``'s device.
    Head group ``h`` (Hq/sp query heads and their KV heads over the whole
    sequence) is attended on shard ``h``'s device. Returns the output
    shards [B, S_local, Hq, D]."""
    n = len(qs)
    hq, hkv = qs[0].shape[2], ks[0].shape[2]
    if hq % n:
        raise ValueError(
            f"n_heads={hq} not divisible by sp={n} — Ulysses shards the "
            "head axis; use ring attention for this shard count"
        )
    if hkv % n:
        reps = hq // hkv
        ks = [k.repeat_interleave(reps, dim=2) for k in ks]
        vs = [v.repeat_interleave(reps, dim=2) for v in vs]
        hkv = hq

    def gather(shards: Sequence[torch.Tensor], h: int, width: int) -> torch.Tensor:
        # heads scatter, sequence gathers: head group h of every shard, in order
        dev = qs[h].device
        return torch.cat([t[:, :, h * width:(h + 1) * width].to(dev) for t in shards], dim=1)

    outs = [attention(gather(qs, h, hq // n), gather(ks, h, hkv // n), gather(vs, h, hkv // n),
                      causal=causal, scale=scale)
            for h in range(n)]
    # sequence scatters, heads gather: shard i's positions of every head group
    s = qs[0].shape[1]
    return [torch.cat([o[:, i * s:(i + 1) * s].to(q.device) for o in outs], dim=2)
            for i, q in enumerate(qs)]


def _ulysses(qs: list, ks: list, vs: list) -> list:
    return ulysses_attention(qs, ks, vs, causal=True)


def make_ulysses_forward(cfg: TransformerConfig, mesh: Mesh, batch_axes=("dp", "fsdp"),
                         remat: bool = False) -> Callable:
    """``forward(model, tokens [B, S]) -> logits [B, S, V]`` with the
    sequence over ``sp`` and all-to-all attention (the ring's forward with
    this attention)."""
    return make_sp_forward(cfg, mesh, batch_axes, _ulysses, remat)


def make_ulysses_loss(cfg: TransformerConfig, mesh: Mesh, batch_axes=("dp", "fsdp"),
                      remat: bool = False) -> Callable:
    """Sequence-parallel next-token loss with all-to-all attention:
    ``loss(model, tokens [B, S]) -> scalar``."""
    return make_sp_loss(cfg, mesh, batch_axes, _ulysses, remat)
