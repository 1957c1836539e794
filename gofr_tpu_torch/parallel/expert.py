"""Expert parallelism: MoE token dispatch over the ``ep`` mesh axis.

Port of ``gofr_tpu/parallel/expert.py``:

- each layer's expert stacks [E, D, F] shard over ``ep`` on the expert
  axis, so the device at ep index ``j`` owns experts ``[j·E/ep, (j+1)·E/ep)``;
  attention, the router, the norms, the embedding and ``lm_head``
  replicate; the batch splits over ALL of dp·fsdp·ep, so attention stays
  data-parallel (``place_moe_params``, through ``sharding.shard_params``);
- each shard routes its local tokens (``models/moe.py::_routing``: GShard's
  capacity-bounded dispatch) and gathers each expert's token block [E, C, D]
  by the dispatch product; the JAX package's ``all_to_all`` over ``ep``
  becomes an explicit exchange: the owner of experts ``j·E/ep ..`` receives
  every shard's [C, D] block for them, concatenated along C in shard order
  (JAX's ``tiled=True`` layout [E/ep, ep·C, D]), runs their SwiGLU on its
  device, and the reverse exchange returns each shard its [E, C, D]
  outputs for the combine;
- the aux losses and the loss are averaged over the shards (the JAX
  package's ``pmean`` over the batch axes).

The port's single controller (``parallel/ring.py``, PRs 18–19) drives
every shard from one process, layer by layer: a layer runs every shard's
attention, then the exchange. The moves are ``.to(device)`` copies (none
where shards share a device), and the gradient of each returns to its
source: the backward's exchange is autograd's. A copy of a replicated
weight gets its own shard's gradient; ``PlacedMoE.logical(grad=True)``
sums the copies, the reduction GSPMD inserts. Shards of axes outside the
batch axes (tp, sp, pp) hold copies that only the first of them uses.

With ample capacity this path equals the exact dense mixture
(``models/moe.py::moe_forward``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gofr_tpu_torch.models.moe import (
    EXPERT_KEYS,
    MoEBlock,
    MoEConfig,
    MoETransformer,
    _expert_ffn,
    _router_logits,
    _routing,
    stack_aux,
)
from gofr_tpu_torch.models.quant import Pack
from gofr_tpu_torch.ops.loss import next_token_nll
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.parallel.mesh import AXES, Mesh
from gofr_tpu_torch.parallel.ring import row_groups, split_batch
from gofr_tpu_torch.parallel.sharding import block_index, device_coords, shard_params, unshard_tensor

_TOP_KEYS = ("embed", "norm_f", "lm_head", "layers")


def moe_param_specs(params: Any = None) -> dict:
    """Spec tree: the stacked expert weights [L, E, D, F] shard E over ep,
    everything else replicates. Derived from the model's (or tree's) names
    when given, so placement and specs cannot drift."""
    if params is None:
        top, layer_keys = _TOP_KEYS, MoETransformer.layer_weights
    elif isinstance(params, dict):
        top, layer_keys = tuple(params), tuple(params["layers"])
    else:
        top, layer_keys = _TOP_KEYS, params.layer_weights
    layers = {k: ((None, "ep") if k in EXPERT_KEYS else ()) for k in layer_keys}
    return {k: (layers if k == "layers" else ()) for k in top}


class PlacedMoE:
    """An MoE model over a mesh: ``shards[i]`` is an ``MoETransformer`` on
    ``mesh.devices[i]`` holding that device's blocks (each layer's E/ep
    experts, a copy of every other weight)."""

    def __init__(self, cfg: MoEConfig, mesh: Mesh, specs: dict, shards: list):
        self.cfg, self.mesh, self.specs, self.shards = cfg, mesh, specs, shards

    def parameters(self):
        for shard in self.shards:
            yield from shard.parameters()

    def blocks(self, name: str, layer: Optional[int] = None) -> list:
        """Weight ``name`` (of layer ``layer``) on every device, in
        ``mesh.devices`` order."""
        return [getattr(s if layer is None else s.layers[layer], name) for s in self.shards]

    def logical(self, name: str, layer: Optional[int] = None, grad: bool = False,
                device: "torch.device | str" = "cpu") -> torch.Tensor:
        """The whole weight (``grad``: its gradient, each block's copies
        summed) on ``device``."""
        spec = self.specs[name] if layer is None else self.specs["layers"][name][1:]
        blocks = self.blocks(name, layer)
        if grad:
            coords = device_coords(self.mesh)
            sums: dict = {}
            for b, c in zip(blocks, coords):
                g = torch.zeros_like(b) if b.grad is None else b.grad
                idx = block_index(spec, self.mesh, c)
                sums[idx] = g.to(device) if idx not in sums else sums[idx] + g.to(device)
            blocks = [sums[block_index(spec, self.mesh, c)] for c in coords]
        return unshard_tensor([b.detach() for b in blocks], spec, self.mesh, device)


def _holder(w: Any, block: Any) -> Any:
    """A placed block in the form the model holds it: a pack's buffers, or
    a frozen parameter (a caller turns on its gradient)."""
    if isinstance(w, Pack):
        return Pack(block)
    return nn.Parameter(block, requires_grad=False)


@torch.no_grad()
def place_moe_params(model: MoETransformer, mesh: Mesh) -> PlacedMoE:
    """Each device's blocks by ``moe_param_specs`` (``shard_params``: a
    copy on its device), one weight at a time, as one ``MoETransformer`` a
    device."""
    specs = moe_param_specs(model)
    n = mesh.size
    shards = []
    for d in mesh.devices:
        s = MoETransformer.__new__(MoETransformer)
        nn.Module.__init__(s)
        s.cfg, s.quant = model.cfg, model.quant
        s.register_buffer("freqs", model.freqs.to(d), persistent=False)
        s.layers = nn.ModuleList()
        shards.append(s)
    for name in ("embed", "norm_f", "lm_head"):
        w = getattr(model, name)
        placed = shard_params({name: w}, mesh, {name: specs[name]})[name]
        for i, s in enumerate(shards):
            setattr(s, name, _holder(w, placed[i] if isinstance(placed, list)
                                     else {k: v[i] for k, v in placed.items()}))
    for layer in model.layers:
        blocks = [MoEBlock.__new__(MoEBlock) for _ in range(n)]
        for b in blocks:
            nn.Module.__init__(b)
        for name in MoETransformer.layer_weights:
            w = getattr(layer, name)
            spec = specs["layers"][name][1:]  # the stacked layer axis dropped
            placed = shard_params({name: w}, mesh, {name: spec})[name]
            for i, b in enumerate(blocks):
                setattr(b, name, _holder(w, placed[i] if isinstance(placed, list)
                                         else {k: v[i] for k, v in placed.items()}))
        for s, b in zip(shards, blocks):
            s.layers.append(b)
    return PlacedMoE(model.cfg, mesh, specs, shards)


def _capacity(tokens_local: int, cfg: MoEConfig) -> int:
    cap = int(tokens_local * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cap, 1)


def _check_experts(cfg: MoEConfig, mesh: Mesh, batch_axes: Sequence[str]) -> None:
    ep = mesh.shape.get("ep", 1)
    if cfg.n_experts % ep:
        raise ValueError(
            f"n_experts={cfg.n_experts} not divisible by ep={ep} — each device "
            "needs an equal expert block"
        )
    if ep > 1 and "ep" not in batch_axes:
        raise ValueError(f"batch_axes {tuple(batch_axes)} leave out ep={ep}: each ep shard "
                         "routes its own rows")


def _moe_mlp_ep(layers: list, hs: list, cfg: MoEConfig,
                stats: Optional[dict] = None) -> tuple[list, list]:
    """One MoE layer over one ep group: ``hs[j]`` [b, S, D] the normed
    hidden states of the shard at ep index ``j``, ``layers[j]`` its blocks
    (its experts ``[j·E/ep, (j+1)·E/ep)``). Returns each shard's output and
    aux losses."""
    ep, per = len(hs), cfg.n_experts // len(hs)
    routed = []
    for layer, h in zip(layers, hs):
        b, s, d = h.shape
        t = b * s
        xt = h.reshape(t, d)
        dispatch, combine, aux = _routing(_router_logits(layer, xt), cfg.top_k,
                                          _capacity(t, cfg))
        if stats is not None:  # a host read: only when asked
            stats["assignments"] = stats.get("assignments", 0) + t * cfg.top_k
            stats["dropped"] = (stats.get("dropped", 0)
                                + t * cfg.top_k - int(dispatch.sum().item()))
        e, c = dispatch.shape[1:]
        # each expert's token block [E, C, D] (E: every expert, global)
        xs = torch.matmul(dispatch.to(xt.dtype).reshape(t, e * c).t(), xt).view(e, c, d)
        routed.append((xs, combine, aux, h.shape))
    # the exchange: owner o gets every shard's blocks of its experts, along C
    # in shard order: [E/ep, ep·C, D]
    ys = []
    for o, layer in enumerate(layers):
        dev = layer.w_gate.device
        recv = torch.cat([xs[o * per:(o + 1) * per].to(dev) for xs, *_ in routed], dim=1)
        ys.append(_expert_ffn(layer.w_gate, layer.w_up, layer.w_down, recv))
    # and back: shard j's columns of every owner's outputs, [E, C, D]
    outs = []
    for j, (xs, combine, aux, shape) in enumerate(routed):
        e, c, d = xs.shape
        back = torch.cat([y[:, j * c:(j + 1) * c].to(xs.device) for y in ys], dim=0)
        out = torch.matmul(combine.to(back.dtype).reshape(-1, e * c), back.reshape(e * c, d))
        outs.append(out.reshape(shape).to(hs[j].dtype))
    return outs, [r[2] for r in routed]


def _groups(mesh: Mesh, batch_axes: Sequence[str]) -> tuple[list, list]:
    """(the flat device index of each row group, the ep groups as lists of
    row-group indices in ep order)."""
    coords = row_groups(mesh, batch_axes)
    flats = []
    for c in coords:
        flat = 0
        for axis in AXES:
            flat = flat * mesh.shape[axis] + c.get(axis, 0)
        flats.append(flat)
    sets: dict = {}
    for g, c in enumerate(coords):
        sets.setdefault(tuple(sorted((a, i) for a, i in c.items() if a != "ep")), []).append(g)
    return flats, [sorted(m, key=lambda g: coords[g].get("ep", 0)) for m in sets.values()]


def _ep_layer(placed: PlacedMoE, li: int, flats: list, ep_sets: list, positions: list,
              cfg: MoEConfig, stats: Optional[dict], *xs: torch.Tensor) -> tuple:
    """Layer ``li`` over every row group: attention on each shard, then the
    experts over each ep group. Returns the new hidden states, then each
    group's load-balance and z losses (flat tensors, for ``checkpoint``)."""
    shards = [placed.shards[f] for f in flats]
    layers = [s.layers[li] for s in shards]
    xs = [x + s._attn_half(lay, x, pos, cfg.n_heads, cfg.n_kv_heads)
          for s, lay, x, pos in zip(shards, layers, xs, positions)]
    hs = [rms_norm(x, lay.mlp_norm, cfg.norm_eps) for x, lay in zip(xs, layers)]
    ys, auxes = [None] * len(xs), [None] * len(xs)
    for members in ep_sets:
        outs, aux = _moe_mlp_ep([layers[g] for g in members], [hs[g] for g in members], cfg,
                                stats)
        for g, y, a in zip(members, outs, aux):
            ys[g], auxes[g] = y, a
    return (*[x + y for x, y in zip(xs, ys)], *[a["load_balance"] for a in auxes],
            *[a["router_z"] for a in auxes])


def _ep_logits(placed: PlacedMoE, mesh: Mesh, batch_axes: Sequence[str], tokens: Any,
               cfg: MoEConfig, remat: bool, stats: Optional[dict]) -> tuple[list, list, list]:
    """Every row group's f32 logits on its device and its aux losses
    averaged over the layers."""
    flats, ep_sets = _groups(mesh, batch_axes)
    rows = split_batch(torch.as_tensor(tokens), len(flats))
    devices = [mesh.devices[f] for f in flats]
    shards = [placed.shards[f] for f in flats]
    positions = [torch.arange(r.shape[1], device=d) for r, d in zip(rows, devices)]
    xs = tuple(s._embed(r.to(d)) for s, r, d in zip(shards, rows, devices))
    n = len(xs)
    per_layer = []
    for li in range(cfg.n_layers):
        step = functools.partial(_ep_layer, placed, li, flats, ep_sets, positions, cfg, stats)
        out = checkpoint(step, *xs, use_reentrant=False) if remat else step(*xs)
        xs = out[:n]
        per_layer.append([{"load_balance": out[n + g], "router_z": out[2 * n + g]}
                          for g in range(n)])
    logits = [s._logits(rms_norm(x, s.norm_f, cfg.norm_eps)) for s, x in zip(shards, xs)]
    auxes = [stack_aux([layer[g] for layer in per_layer]) for g in range(n)]
    return logits, auxes, rows


def _mean_on(values: list, device: torch.device) -> torch.Tensor:
    moved = [v.to(device) for v in values]
    return sum(moved[1:], moved[0]) / len(moved)


def make_moe_forward(cfg: MoEConfig, mesh: Mesh,
                     batch_axes: Sequence[str] = ("dp", "fsdp", "ep"),
                     stats: Optional[dict] = None) -> Callable:
    """``forward(placed, tokens [B, S]) -> (f32 logits [B, S, V], aux)`` on
    the mesh's first device, ``placed`` from ``place_moe_params``, the batch
    over ``batch_axes``, the experts over ep; ``aux`` is averaged over the
    shards. ``stats`` (a dict), when given, collects the routed
    ``assignments`` and the ``dropped`` ones (past an expert's capacity)."""
    _check_experts(cfg, mesh, batch_axes)

    def forward(placed: PlacedMoE, tokens: Any) -> tuple[torch.Tensor, dict]:
        dev0 = mesh.devices[0]
        logits, auxes, _ = _ep_logits(placed, mesh, batch_axes, tokens, cfg, False, stats)
        aux = {k: _mean_on([a[k] for a in auxes], dev0) for k in auxes[0]}
        return torch.cat([lg.to(dev0) for lg in logits]), aux

    return forward


def make_moe_loss(cfg: MoEConfig, mesh: Mesh, batch_axes: Sequence[str] = ("dp", "fsdp", "ep"),
                  remat: bool = False) -> Callable:
    """``loss(placed, tokens [B, S]) -> scalar``: next-token NLL plus the
    weighted aux losses on each shard, averaged over the shards, on the
    mesh's first device; ``remat`` recomputes each layer in the backward."""
    _check_experts(cfg, mesh, batch_axes)

    def loss(placed: PlacedMoE, tokens: Any) -> torch.Tensor:
        tokens = torch.as_tensor(tokens)
        logits, auxes, rows = _ep_logits(placed, mesh, batch_axes, tokens[:, :-1], cfg, remat,
                                         None)
        targets = split_batch(tokens[:, 1:], len(rows))
        parts = [next_token_nll(lg, t.to(lg.device)).mean()
                 + cfg.aux_weight * a["load_balance"] + cfg.z_weight * a["router_z"]
                 for lg, t, a in zip(logits, targets, auxes)]
        return _mean_on(parts, mesh.devices[0])

    return loss
