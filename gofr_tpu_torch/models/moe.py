"""Mixture-of-Experts decoder: top-k routed SwiGLU experts per layer.

Port of ``gofr_tpu/models/moe.py``. Attention is the dense decoder's GQA
(``Transformer._qkv`` / ``_attn_half``: the flash kernels on the card);
every layer's MLP is a top-k mixture of SwiGLU experts, reached through
``Transformer._block``'s ``mlp_fn`` hook:

- :class:`MoEConfig` extends the decoder's config with the expert count
  and the routing hyperparameters (Mixtral-style);
- the router is a linear gate ``[D, E]`` kept in float32 (routing decisions
  are precision-sensitive); the top-k softmax weights are renormalized over
  the chosen experts;
- ``moe_forward`` runs every expert on every token and mixes by the routing
  weights (``_moe_mlp_dense``): exact, no capacity drops, O(E·T·D·F). It is
  the single-device path and the reference that the expert-parallel path
  (``parallel/expert.py``) is held against;
- the auxiliary losses, Switch's load balance and the router z-loss, come
  out beside the logits, averaged over the layers.

The capacity-bounded dispatch (GShard, static shapes) is ``_routing``,
shared with the expert-parallel path.

The expert stacks ``w_gate`` / ``w_up`` [E, D, F] and ``w_down`` [E, F, D]
run through batched products over the expert axis, never ``mm``: a
quantized MoE model packs attention and ``lm_head`` and keeps the experts
dense, as the JAX package's ``quantize_params`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gofr_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    _weight,
    layer_shapes,
)
from gofr_tpu_torch.ops.loss import next_token_nll

EXPERT_KEYS = ("w_gate", "w_up", "w_down")
_ATTN_KEYS = ("wq", "wk", "wv", "wo")


@dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0  # expert slots = T·k·factor/E (EP path)
    aux_weight: float = 0.01  # load-balance loss weight
    z_weight: float = 1e-3  # router z-loss weight


class MoEBlock(nn.Module):
    """One MoE layer's weights: the decoder's norms and attention weights
    (dense or packs), the f32 router [D, E] and the dense expert stacks."""

    def __init__(self, cfg: MoEConfig, device: torch.device, quant: Any = None):
        super().__init__()
        self.attn_norm = nn.Parameter(
            torch.ones(cfg.dim, dtype=cfg.dtype, device=device), requires_grad=False)
        self.mlp_norm = nn.Parameter(
            torch.ones(cfg.dim, dtype=cfg.dtype, device=device), requires_grad=False)
        shapes = layer_shapes(cfg)
        for name in _ATTN_KEYS:
            setattr(self, name, _weight(cfg, device, quant, name, shapes[name]))
        self.router = nn.Parameter(
            torch.empty((cfg.dim, cfg.n_experts), dtype=torch.float32, device=device),
            requires_grad=False)
        e = cfg.n_experts
        for name in EXPERT_KEYS:
            self.register_parameter(name, nn.Parameter(
                torch.empty((e, *shapes[name]), dtype=cfg.dtype, device=device),
                requires_grad=False))


class MoETransformer(Transformer):
    """The MoE decoder: ``Transformer`` with :class:`MoEBlock` layers. Build
    it with ``MoETransformer.random(cfg, device, seed)`` or
    ``models/convert.py::moe_from_tree``; run it with ``moe_forward``."""

    block_class: Callable = MoEBlock
    layer_weights = ("attn_norm", "mlp_norm", *_ATTN_KEYS, "router", *EXPERT_KEYS)

    def _like(self, cfg: TransformerConfig, quant: Any = None) -> "MoETransformer":
        return MoETransformer(cfg, self.device, quant)

    @classmethod
    @torch.no_grad()
    def random(cls, cfg: MoEConfig, device: "torch.device | str", seed: int = 0,
               quant: Any = None) -> "MoETransformer":
        """The decoder's seeded truncated-normal init (fan-in: each weight's
        input axis); the router is drawn in ``cfg.dtype`` and held in f32,
        as the JAX ``init_moe`` casts it."""
        model = super().random(cfg, device, seed, quant)
        for layer in model.layers:
            layer.router.copy_(layer.router.to(cfg.dtype))
        return model

    def with_weights(self, wrap: Callable) -> Transformer:
        raise NotImplementedError("LoRA over an MoE model is not supported (nor in the JAX "
                                  "package: add_lora skips the expert stacks)")


def _route_top_k(logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Top-k expert choice from router logits [T, E]: renormalized weights
    [T, k], expert ids [T, k], and the aux losses."""
    n_experts = logits.shape[-1]
    gates = torch.softmax(logits.float(), dim=-1)  # [T, E]
    # lax.top_k's order: descending, the lower expert id first on a tie
    # (torch.topk does not promise one); a stable descending sort gives it
    gate_vals, expert_idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[:, :top_k], expert_idx[:, :top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # Switch load balance: E · Σ_e (token share to e) · (mean router prob of
    # e). The share counts each token's FIRST choice only, as the JAX
    # package's does
    me = gates.mean(dim=0)
    f = F.one_hot(expert_idx[:, 0], n_experts).float().mean(dim=0)
    load_balance = n_experts * torch.sum(f * me)
    z = torch.mean(torch.logsumexp(logits.float(), dim=-1) ** 2)
    return gate_vals, expert_idx, {"load_balance": load_balance, "router_z": z}


def _routing(logits: torch.Tensor, top_k: int,
             capacity: int) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Capacity-bounded dispatch and combine tensors [T, E, C] (GShard).
    Slots fill one choice ``j`` at a time, token order within it, the
    per-expert ``counts`` carried from one choice to the next, so the first
    choices of every token take slots before any second choice does. A
    token past an expert's C slots is dropped there (its residual stream
    passes through): its slot row is all zero. ``jax.nn.one_hot`` gives
    that zero row for an index >= C; ``F.one_hot`` would raise, so the slot
    is the comparison with ``arange(C)``."""
    t, n_experts = logits.shape
    gate_vals, expert_idx, aux = _route_top_k(logits, top_k)
    dev = logits.device
    dispatch = torch.zeros((t, n_experts, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros((t, n_experts, capacity), dtype=torch.float32, device=dev)
    counts = torch.zeros((n_experts,), dtype=torch.float32, device=dev)
    slots = torch.arange(capacity, device=dev)
    for j in range(top_k):
        oh = F.one_hot(expert_idx[:, j], n_experts).float()  # [T, E]
        pos = counts[None, :] + torch.cumsum(oh, dim=0) - oh  # the slot before me
        pos_t = torch.sum(pos * oh, dim=-1).to(torch.int64)  # [T]
        slot = (pos_t[:, None] == slots[None, :]).float()  # [T, C]; zero past C
        d_j = oh[:, :, None] * slot[:, None, :]
        dispatch = dispatch + d_j
        combine = combine + gate_vals[:, j, None, None] * d_j
        counts = counts + oh.sum(dim=0)
    return dispatch, combine, aux


def _expert_ffn(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                xs: torch.Tensor) -> torch.Tensor:
    """SwiGLU over per-expert token blocks: xs [E, C, D] -> [E, C, D]."""
    return torch.bmm(F.silu(torch.bmm(xs, w_gate)) * torch.bmm(xs, w_up), w_down)


def _router_logits(layer: MoEBlock, xt: torch.Tensor) -> torch.Tensor:
    """[T, D] -> f32 router logits [T, E]."""
    return torch.matmul(xt.float(), layer.router)


def _moe_mlp_dense(layer: MoEBlock, x: torch.Tensor, cfg: MoEConfig) -> tuple[torch.Tensor, dict]:
    """The exact mixture: every expert computes every token, the outputs
    mixed by the renormalized top-k weights. x [B, S, D]. The products run
    expert-major ([E, T, F], a broadcast batched product over the stacks,
    no copy of a weight); each element is the JAX ``[T, E, F]`` einsum's."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gate_vals, expert_idx, aux = _route_top_k(_router_logits(layer, xt), cfg.top_k)
    g = torch.matmul(xt, layer.w_gate)  # [E, T, F]
    u = torch.matmul(xt, layer.w_up)
    y_all = torch.matmul(F.silu(g) * u, layer.w_down)  # [E, T, D]
    oh = F.one_hot(expert_idx, cfg.n_experts).float()  # [T, k, E]
    w = torch.sum(gate_vals[:, :, None] * oh, dim=1)  # [T, E]
    out = torch.einsum("te,etd->td", w.to(y_all.dtype), y_all)
    return out.reshape(b, s, d).to(x.dtype), aux


def stack_aux(auxes: list) -> dict:
    """Each aux loss averaged over the layers."""
    return {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}


def moe_block(cfg: MoEConfig, model: MoETransformer, layer: MoEBlock, x: torch.Tensor,
              positions: torch.Tensor,
              moe_mlp: Callable = _moe_mlp_dense) -> tuple[torch.Tensor, dict]:
    """The decoder block (``Transformer._block``: GQA attention and its
    residual) with the MLP swapped for routed experts."""
    return model._block(layer, x, positions, mlp_fn=lambda lay, h: moe_mlp(lay, h, cfg))


def moe_forward(model: MoETransformer, tokens: torch.Tensor, cfg: Optional[MoEConfig] = None,
                moe_mlp: Callable = _moe_mlp_dense,
                remat: bool = False) -> tuple[torch.Tensor, dict]:
    """[B, S] ids -> (f32 logits [B, S, V], the aux losses averaged over the
    layers). ``cfg`` (default the model's) gives the routing: top-k, the
    experts, the capacity; ``remat`` recomputes each block in the backward."""
    cfg = cfg or model.cfg
    logits, auxes = model.transformer_forward(
        torch.as_tensor(tokens, device=model.device), remat=remat,
        mlp_fn=lambda lay, h: moe_mlp(lay, h, cfg))
    return logits, stack_aux(auxes)


def moe_loss(model: MoETransformer, tokens: torch.Tensor, cfg: Optional[MoEConfig] = None,
             remat: bool = False) -> torch.Tensor:
    """Next-token loss plus the weighted aux losses (the dense, exact
    path)."""
    cfg = cfg or model.cfg
    tokens = torch.as_tensor(tokens, device=model.device)
    logits, aux = moe_forward(model, tokens[:, :-1], cfg, remat=remat)
    nll = next_token_nll(logits, tokens[:, 1:]).mean()
    return nll + cfg.aux_weight * aux["load_balance"] + cfg.z_weight * aux["router_z"]
