"""Training: next-token loss, AdamW update, one step at a time, on one
device or over a mesh.

Port of ``gofr_tpu/training/trainer.py``. The state is a dict
``{"model": Transformer, "opt_state": ..., "step": int}``; the step
updates the model's parameters and the moments in place, where the JAX
step donates its state and returns a new one. Attention's backward runs
through the hand-written dQ and dK/dV kernels on the card
(``ops/flash.py``), through their plain versions on the CPU. The
adapter-only step (LoRA and QLoRA) is ``models/lora.py::
make_lora_train_step``, over this module's ``cross_entropy_loss``.

Over a mesh (dp, fsdp, tp; ``place_train_state``), one process drives
every device, as the JAX trainer's one jitted step does: the model is a
``parallel/serving.py::ShardedTransformer`` with trainable blocks, each
moment sits beside its parameter's block, and the step sums the copies of
each block's gradient (dp replicas, a norm on every tp shard: the
all-reduce GSPMD inserts), counts every logical block once in the global
norm and the clip, and applies the same update to every copy.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from gofr_tpu_torch.models.transformer import Transformer, TransformerConfig
from gofr_tpu_torch.ops.loss import next_token_nll
from gofr_tpu_torch.parallel.mesh import Mesh
from gofr_tpu_torch.parallel.serving import ShardedTransformer, release_storage
from gofr_tpu_torch.parallel.sharding import device_coords, place, shard_tensor, unshard_tensor
from gofr_tpu_torch.training import optim


def cross_entropy_loss(
    model: Transformer,
    tokens: torch.Tensor,
    loss_mask: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> torch.Tensor:
    """Next-token prediction loss over ``tokens`` [B, S]; mask [B, S-1]
    optionally excludes positions (padding) from the mean. A placed model
    takes the mean over the whole batch, its row groups' sums reduced on
    the mesh's first device."""
    if isinstance(model, ShardedTransformer):
        return _mesh_loss(model, tokens, loss_mask, remat)
    logits = model.transformer_forward(tokens[:, :-1], remat=remat)  # [B, S-1, V]
    nll = next_token_nll(logits, tokens[:, 1:])
    if loss_mask is not None:
        weights = loss_mask.float()
        return (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
    return nll.mean()


def _mesh_loss(model: ShardedTransformer, tokens: torch.Tensor,
               loss_mask: Optional[torch.Tensor], remat: bool) -> torch.Tensor:
    dev0 = model.device
    total, count = torch.zeros((), device=dev0), torch.zeros((), device=dev0)
    for r0, r1, logits in model.train_logits(tokens[:, :-1], remat):
        nll = next_token_nll(logits, tokens[r0:r1, 1:].to(logits.device))
        weights = (torch.ones_like(nll) if loss_mask is None
                   else loss_mask[r0:r1].to(logits.device).float())
        total = total + (nll * weights).sum().to(dev0)
        count = count + weights.sum().to(dev0)
    return total / torch.clamp(count, min=1.0)


def _refuse_quantized(model: Transformer) -> None:
    if model.quant is not None:
        raise ValueError(
            f"cannot train a quantized model (MODEL_QUANT={model.quant}): its weight "
            "packs are not trainable; train adapters over it (QLoRA: models/lora.py "
            "add_lora, init_lora_train_state, make_lora_train_step), or train the dense "
            "model and quantize it for serving"
        )


def init_train_state_from(model: Transformer, optimizer: Any) -> dict:
    """A training state around ``model``, whose parameters are turned
    trainable (serving builds them with ``requires_grad=False``). A
    quantized model is refused: its packs are buffers, not parameters.
    Over a quantized base, train adapters (QLoRA): ``models/lora.py``'s
    ``add_lora`` and ``make_lora_train_step``."""
    _refuse_quantized(model)
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    return {"model": model, "opt_state": optimizer.init(params), "step": 0}


def init_train_state(
    cfg: TransformerConfig, optimizer: Any, device: "torch.device | str" = "cuda", seed: int = 0
) -> dict:
    """A fresh model from ``Transformer.random`` (seeded, on ``device``)
    and its optimizer state."""
    return init_train_state_from(Transformer.random(cfg, device, seed), optimizer)


def make_train_step(cfg: TransformerConfig, optimizer: Any, mesh: Optional[Mesh] = None,
                    remat: bool = True) -> Callable:
    """``step(state, tokens) -> (state, {"loss", "grad_norm", "step"})``:
    loss and grads, then the optimizer in place. ``grad_norm`` is the
    global norm before clipping. ``tokens`` is [B, S] (numpy or torch);
    it moves to the model's device. With ``mesh`` the state must be placed
    on it (``place_train_state``): the batch splits over the dp x fsdp row
    groups, each block's copies take the sum of their gradients, and the
    norm counts each logical block once."""

    def train_step(state: dict, tokens: Any) -> tuple[dict, dict]:
        model = state["model"]
        if model.cfg != cfg:
            raise ValueError("the state's model was built for another config")
        placed = isinstance(model, ShardedTransformer)
        if placed != (mesh is not None) or (placed and not _same_mesh(model.mesh, mesh)):
            raise ValueError("a mesh step takes a state placed on its mesh "
                             "(place_train_state), an unmeshed step an unplaced one")
        tokens = torch.as_tensor(tokens, device=model.device)
        # bf16 products accumulate in f32, as XLA's do (see models/quant.py)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        loss = cross_entropy_loss(model, tokens, remat=remat)
        if placed:
            params, grads, logical = _mesh_grads(model, loss)
        else:
            params = list(model.parameters())
            grads = logical = list(torch.autograd.grad(loss, params))
        grad_norm = optim.global_norm(logical)
        optimizer.update(grads, state["opt_state"], params, norm=grad_norm)
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm, "step": state["step"]}

    return train_step


def _same_mesh(a: Mesh, b: Mesh) -> bool:
    return a.shape == b.shape and a.devices == b.devices


def mesh_params(model: ShardedTransformer) -> list:
    """A placed model's parameters in the order its optimizer state
    follows: each logical weight's blocks, one a device."""
    return [b for *_, blocks in model.leaves() for b in blocks]


@torch.no_grad()
def _sum_copies(grads: list, like: torch.Tensor) -> torch.Tensor:
    """One block's gradient from its copies' (None: a copy no row read),
    summed in f32 in device order and rounded once."""
    present = [g for g in grads if g is not None]
    if not present:
        return torch.zeros_like(like)
    if len(present) == 1:
        return present[0]
    total = present[0].float()
    for g in present[1:]:
        total = total + g.to(total.device).float()
    return total.to(like.dtype)


def _mesh_grads(model: ShardedTransformer, loss: torch.Tensor) -> tuple[list, list, list]:
    """(params, their gradients, one gradient a logical block): every copy
    of a block gets its own tensor holding the copies' sum."""
    params = mesh_params(model)
    raw = torch.autograd.grad(loss, params, allow_unused=True)
    grads, logical, at = [], [], 0
    for _, _, spec, blocks in model.leaves():
        mine = raw[at:at + len(blocks)]
        at += len(blocks)
        out: list = [None] * len(blocks)
        for devs in model.copies(spec):
            total = _sum_copies([mine[d] for d in devs], blocks[devs[0]])
            logical.append(total)
            for j, d in enumerate(devs):
                out[d] = total if j == 0 else total.to(blocks[d].device, copy=True)
        grads.extend(out)
    return params, grads, logical


def _map_moments(tree: Any, n: int, fn: Callable[[list], list]) -> Any:
    """``tree`` (an optimizer state) with each list of ``n`` tensors (the
    moments, one a parameter) replaced by ``fn(list)``; other leaves (the
    update count, a host int) as they are."""
    if isinstance(tree, (list, tuple)):
        if len(tree) == n and n and all(isinstance(t, torch.Tensor) for t in tree):
            return fn(list(tree))
        return type(tree)(_map_moments(t, n, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_moments(v, n, fn) for k, v in tree.items()}
    return tree


@torch.no_grad()
def place_train_state(state: dict, mesh: Mesh, release: bool = False) -> dict:
    """The state placed over ``mesh`` (dp, fsdp, tp): the model by the
    specs of ``parallel/sharding.py``, trainable; each moment beside its
    parameter's blocks; the step and the update count stay host ints. With
    ``release`` each unsharded tensor is freed as soon as its blocks exist
    (``state`` is then spent): the card never holds two copies."""
    model = state["model"]
    if isinstance(model, ShardedTransformer):
        raise ValueError("the state is already placed")
    _refuse_quantized(model)
    logical = list(model.parameters())
    placed = ShardedTransformer.from_model(model, mesh, release=release)
    for p in placed.stores.parameters():
        p.requires_grad_(True)
    specs = [spec for _, _, spec, _ in placed.leaves()]
    coords = device_coords(mesh)

    def place_moments(moments: list) -> list:
        out = []
        for m, spec in zip(moments, specs):
            out.extend(place(shard_tensor(m, spec, mesh, c), d)
                       for c, d in zip(coords, mesh.devices))
            if release:
                release_storage(m)
        return out

    return {"model": placed, "step": state["step"],
            "opt_state": _map_moments(state["opt_state"], len(logical), place_moments)}


@torch.no_grad()
def unplace_train_state(state: dict, device: "torch.device | str" = "cpu") -> dict:
    """A placed state gathered to the unsharded layout on ``device``: the
    model (``ShardedTransformer.unshard``) and each moment from its
    blocks, bit for bit; what ``checkpoint.save_state`` writes."""
    model: ShardedTransformer = state["model"]
    leaves = model.leaves()
    n = sum(len(blocks) for *_, blocks in leaves)

    def gather(moments: list) -> list:
        out, at = [], 0
        for _, _, spec, blocks in leaves:
            out.append(unshard_tensor(moments[at:at + len(blocks)], spec, model.mesh, device))
            at += len(blocks)
        return out

    return {"model": model.unshard(device), "step": state["step"],
            "opt_state": _map_moments(state["opt_state"], n, gather)}


def default_optimizer(lr: optim.LearningRate = 3e-4, weight_decay: float = 0.1) -> Any:
    """Grad clip + AdamW. ``lr`` is a float or a schedule."""
    return optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(lr, b1=0.9, b2=0.95, weight_decay=weight_decay),
    )


def warmup_cosine_optimizer(
    peak_lr: float = 3e-4,
    total_steps: int = 10_000,
    warmup_steps: int = 200,
    final_lr_frac: float = 0.1,
    weight_decay: float = 0.1,
) -> Any:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``final_lr_frac``·peak over ``total_steps``, with grad clipping and
    AdamW. The schedule is a pure function of the update count, which the
    optimizer state carries, so a resumed run follows the same rates."""
    schedule = optim.warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=peak_lr,
        warmup_steps=warmup_steps,
        decay_steps=total_steps,
        end_value=peak_lr * final_lr_frac,
    )
    return default_optimizer(schedule, weight_decay)
