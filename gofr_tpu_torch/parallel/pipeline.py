"""Pipeline parallelism: the GPipe microbatch schedule over the ``pp`` mesh
axis.

Port of ``gofr_tpu/parallel/pipeline.py``. Stage ``s`` of ``pp`` holds the
contiguous layer block ``[s·L/pp, (s+1)·L/pp)`` on its device
(``place_pipeline_params``); the embedding, the final norm and ``lm_head``
stay one copy on the mesh's first device, and a stage that reads them on
another device does so through ``.to``, whose gradient returns to the copy
(JAX's psum over replicated in_specs). A local batch splits into
``n_micro`` microbatches (default 2·pp); at tick ``t`` stage ``s`` runs
microbatch ``t − s`` and hands its activation to stage ``s + 1``'s device.
One process issues every stage's work; on distinct cards their queues run
side by side, and the bubble is GPipe's (pp − 1)/(n_micro + pp − 1).

JAX's SPMD schedule keeps every stage in lockstep and replays the last
microbatch in the drain ticks (outputs never read). The port runs each
microbatch through each stage once: n_micro × L/pp layer applications a
stage, n_micro × L in all. Backward is autograd through the schedule.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gofr_tpu_torch.models.quant import Pack, mm
from gofr_tpu_torch.models.transformer import _LAYER_SHAPES, Block, Transformer, TransformerConfig
from gofr_tpu_torch.ops.loss import next_token_nll
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.parallel.mesh import Mesh
from gofr_tpu_torch.parallel.ring import check_config, layer_on, row_groups, split_batch
from gofr_tpu_torch.parallel.sharding import place

_KEYS = ("embed", "norm_f", "lm_head", "layers")


def pipeline_param_specs(params: Any = None) -> dict:
    """Each top-level weight's spec: the stacked ``layers`` over ``pp`` on
    their layer axis, everything else replicated. Derived from the model's
    (or tree's) names when given, so placement and specs cannot drift."""
    keys = _KEYS if params is None else tuple(
        params if isinstance(params, dict) else (k for k in _KEYS if hasattr(params, k)))
    return {k: (("pp",) if k == "layers" else ()) for k in keys}


def _check_stages(cfg: TransformerConfig, mesh: Mesh) -> None:
    pp = mesh.shape.get("pp", 1)
    if cfg.n_layers % pp:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={pp} — each pipeline "
            "stage needs an equal contiguous layer block"
        )


def _placed(w: Any, device: torch.device) -> Any:
    """A trainable copy of a dense weight on ``device`` (a pack: its
    frozen buffers copied)."""
    if isinstance(w, Pack):
        return Pack({k: place(t, device) for k, t in w.pack.items()})
    return nn.Parameter(place(w.detach(), device))


@torch.no_grad()
def place_pipeline_params(model: Transformer, mesh: Mesh) -> Transformer:
    """A copy of ``model`` placed for the pipeline: layer ``l`` on the device
    of stage ``l // (L/pp)`` (row group 0's), the rest on the mesh's first
    device; dense weights trainable."""
    _check_stages(model.cfg, mesh)
    per = model.cfg.n_layers // mesh.shape["pp"]
    d0 = mesh.devices[0]
    out = Transformer.__new__(Transformer)
    nn.Module.__init__(out)
    out.cfg, out.quant = model.cfg, model.quant
    for key, spec in pipeline_param_specs(model).items():
        if not spec:
            setattr(out, key, _placed(getattr(model, key), d0))
            continue
        blocks = []  # the layer stack, split over pp
        for li, src in enumerate(model.layers):
            device = mesh.device(pp=li // per)
            block = Block.__new__(Block)
            nn.Module.__init__(block)
            for name in ("attn_norm", "mlp_norm", *_LAYER_SHAPES):
                setattr(block, name, _placed(getattr(src, name), device))
            blocks.append(block)
        out.layers = nn.ModuleList(blocks)
    out.register_buffer("freqs", model.freqs.to(d0), persistent=False)
    return out


def _pipe_hidden(model: Transformer, tokens: torch.Tensor, stages: list, n_micro: int,
                 remat: bool) -> torch.Tensor:
    """The GPipe schedule over one row group's stage devices ``stages``:
    tokens [b, S] -> the last stage's hidden states [b, S, D] on its
    device."""
    b, s = tokens.shape
    if b % n_micro:
        raise ValueError(f"local batch {b} not divisible by n_micro={n_micro}")
    pp = len(stages)
    per = model.cfg.n_layers // pp
    positions = {d: torch.arange(s, device=d) for d in set(stages)}
    first = stages[0]
    acts = list(model.embed.to(first)[tokens.to(first).long()].chunk(n_micro))
    for tick in range(n_micro + pp - 1):
        for stage, device in enumerate(stages):
            m = tick - stage  # the microbatch stage `stage` holds at this tick
            if not 0 <= m < n_micro:
                continue
            x = acts[m].to(device)
            for layer in model.layers[stage * per:(stage + 1) * per]:
                layer = layer_on(layer, device)
                if remat:
                    x = checkpoint(model._block, layer, x, positions[device], use_reentrant=False)
                else:
                    x = model._block(layer, x, positions[device])
            acts[m] = x
    return torch.cat(acts)


def _logits(model: Transformer, hidden: torch.Tensor) -> torch.Tensor:
    d = hidden.device
    return mm(rms_norm(hidden, model.norm_f.to(d), model.cfg.norm_eps),
              model.lm_head.to(d)).float()


def _groups(mesh: Mesh, batch_axes: Sequence[str], tokens: Any) -> list:
    """(stage devices, rows) of each row group."""
    pp = mesh.shape["pp"]
    tokens = torch.as_tensor(tokens)
    groups = row_groups(mesh, batch_axes)
    return [([mesh.device(**coords, pp=s) for s in range(pp)], rows)
            for coords, rows in zip(groups, split_batch(tokens, len(groups)))]


def _micro(mesh: Mesh, n_micro: Optional[int]) -> int:
    return n_micro or 2 * mesh.shape["pp"]


def make_pipeline_forward(
    cfg: TransformerConfig,
    mesh: Mesh,
    n_micro: Optional[int] = None,
    batch_axes: Sequence[str] = ("dp", "fsdp"),
    remat: bool = False,
) -> Callable:
    """``forward(model, tokens [B, S]) -> f32 logits [B, S, V]`` on the
    mesh's first device, ``model`` from ``place_pipeline_params``, the batch
    over ``batch_axes``; ``n_micro`` defaults to 2·pp."""
    _check_stages(cfg, mesh)
    n_micro = _micro(mesh, n_micro)

    def forward(model: Transformer, tokens) -> torch.Tensor:
        check_config(model, cfg)
        out = [_logits(model, _pipe_hidden(model, rows, stages, n_micro, remat))
               .to(mesh.devices[0])
               for stages, rows in _groups(mesh, batch_axes, tokens)]
        return torch.cat(out)

    return forward


def make_pipeline_loss(
    cfg: TransformerConfig,
    mesh: Mesh,
    n_micro: Optional[int] = None,
    batch_axes: Sequence[str] = ("dp", "fsdp"),
    remat: bool = False,
) -> Callable:
    """``loss(model, tokens [B, S]) -> scalar`` on the mesh's first device:
    each row group's mean next-token loss at its last stage, then the mean
    over the groups."""
    _check_stages(cfg, mesh)
    n_micro = _micro(mesh, n_micro)

    def loss(model: Transformer, tokens) -> torch.Tensor:
        check_config(model, cfg)
        losses = []
        for stages, rows in _groups(mesh, batch_axes, tokens):
            logits = _logits(model, _pipe_hidden(model, rows[:, :-1], stages, n_micro, remat))
            nll = next_token_nll(logits, rows[:, 1:].to(logits.device))
            losses.append(nll.mean().to(mesh.devices[0]))
        return sum(losses[1:], losses[0]) / len(losses)

    return loss
