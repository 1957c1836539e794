"""Training: next-token loss, AdamW update, one step at a time.

Port of ``gofr_tpu/training/trainer.py`` without the mesh (placement on a
device mesh waits for the port's parallel layer). The state is a dict
``{"model": Transformer, "opt_state": ..., "step": int}``; the step
updates the model's parameters and the moments in place, where the JAX
step donates its state and returns a new one. Attention's backward runs
through the hand-written dQ and dK/dV kernels on the card
(``ops/flash.py``), through their plain versions on the CPU. The
adapter-only step (LoRA and QLoRA) is ``models/lora.py::
make_lora_train_step``, over this module's ``cross_entropy_loss``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from gofr_tpu_torch.models.transformer import Transformer, TransformerConfig
from gofr_tpu_torch.ops.loss import next_token_nll
from gofr_tpu_torch.training import optim


def cross_entropy_loss(
    model: Transformer,
    tokens: torch.Tensor,
    loss_mask: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> torch.Tensor:
    """Next-token prediction loss over ``tokens`` [B, S]; mask [B, S-1]
    optionally excludes positions (padding) from the mean."""
    logits = model.transformer_forward(tokens[:, :-1], remat=remat)  # [B, S-1, V]
    nll = next_token_nll(logits, tokens[:, 1:])
    if loss_mask is not None:
        weights = loss_mask.float()
        return (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
    return nll.mean()


def init_train_state_from(model: Transformer, optimizer: Any) -> dict:
    """A training state around ``model``, whose parameters are turned
    trainable (serving builds them with ``requires_grad=False``). A
    quantized model is refused: its packs are buffers, not parameters.
    Over a quantized base, train adapters (QLoRA): ``models/lora.py``'s
    ``add_lora`` and ``make_lora_train_step``."""
    if model.quant is not None:
        raise ValueError(
            f"cannot train a quantized model (MODEL_QUANT={model.quant}): its weight "
            "packs are not trainable; train adapters over it (QLoRA: models/lora.py "
            "add_lora, init_lora_train_state, make_lora_train_step), or train the dense "
            "model and quantize it for serving"
        )
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


def make_train_step(cfg: TransformerConfig, optimizer: Any, remat: bool = True) -> Callable:
    """``step(state, tokens) -> (state, {"loss", "grad_norm", "step"})``:
    loss and grads, then the optimizer in place. ``grad_norm`` is the
    global norm before clipping. ``tokens`` is [B, S] (numpy or torch);
    it moves to the model's device."""

    def train_step(state: dict, tokens: Any) -> tuple[dict, dict]:
        model: Transformer = state["model"]
        if model.cfg != cfg:
            raise ValueError("the state's model was built for another config")
        tokens = torch.as_tensor(tokens, device=model.device)
        # bf16 products accumulate in f32, as XLA's do (see models/quant.py)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        params = list(model.parameters())
        loss = cross_entropy_loss(model, tokens, remat=remat)
        grads = list(torch.autograd.grad(loss, params))
        grad_norm = optim.global_norm(grads)
        optimizer.update(grads, state["opt_state"], params)
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm, "step": state["step"]}

    return train_step


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
