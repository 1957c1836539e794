"""The parts of ``optax`` the trainer uses, with optax's arithmetic.

The JAX package builds its optimizer from the ``optax`` library
(``gofr_tpu/training/trainer.py``); the port keeps its own copy here:
``clip_by_global_norm``, ``adamw`` (``scale_by_adam``, then decoupled
weight decay on every parameter, then ``-lr``), their ``chain``,
``masked`` and ``set_to_zero`` (LoRA's frozen base,
``models/lora.py::lora_optimizer``) and ``warmup_cosine_decay_schedule``. A schedule is read at the update count
before the increment, so the first update of a warmup schedule from 0
uses lr = 0, as in optax.

Both moments are kept in the parameter's dtype (optax's ``mu_dtype=None``).
The update runs in place, one parameter at a time: torch's ``foreach``
optimizers build temporaries the size of the whole model, which an 8B
model in bf16 on one 80 GB card has no room for. The same code runs on
the CPU and on the card.

A transform has ``init(params) -> state`` and ``update(grads, state,
params)``: ``clip_by_global_norm`` rescales ``grads`` in place, and
``adamw``, the last transform of a chain, applies its step to ``params``
in place (optax's update followed by ``optax.apply_updates``).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import torch

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, as a 0-d float32 tensor
    (each tensor's sum of squares is taken in float32)."""
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32).square() for t in tensors]
    return torch.stack(sq).sum().sqrt()


class clip_by_global_norm:  # noqa: N801 - optax's name
    """g if ||g|| < max_norm else g / ||g|| * max_norm (optax's rule: no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). The comparison
    reads the norm on the host once per update."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]) -> None:
        norm = global_norm(grads)
        if bool(norm < self.max_norm):
            return
        for g in grads:
            g.div_(norm.to(g.dtype)).mul_(self.max_norm)


class adamw:  # noqa: N801 - optax's name
    """optax.adamw: mu = b1·mu + (1-b1)·g, nu = b2·nu + (1-b2)·g², bias
    correction at count + 1, u = mu_hat / (sqrt(nu_hat) + eps), u +=
    weight_decay·param on every parameter, param -= lr(count)·u."""

    def __init__(self, lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params],
            "nu": [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params],
        }

    def learning_rate(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]) -> None:
        count = state["count"]
        lr = self.learning_rate(count)
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            # two parameter-sized temporaries at a time, never the model's
            u = torch.div(mu, bc1)
            u.div_(torch.div(nu, bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        state["count"] = count + 1


class chain:  # noqa: N801 - optax's name
    """Apply transforms in order; the state is one entry per transform."""

    def __init__(self, *transforms):
        self.transforms = transforms

    def init(self, params: Sequence[torch.Tensor]) -> list:
        return [t.init(params) for t in self.transforms]

    def update(self, grads: Sequence[torch.Tensor], state: list,
               params: Sequence[torch.Tensor]) -> None:
        for t, s in zip(self.transforms, state):
            t.update(grads, s, params)


class masked:  # noqa: N801 - optax's name
    """optax.masked: ``inner`` sees only the tensors whose ``mask`` flag
    is True (one flag per tensor of the list the optimizer is built over),
    and holds state for those alone. The other tensors are left to the
    rest of the chain, as optax passes their updates through."""

    def __init__(self, inner, mask: Sequence[bool]):
        self.inner = inner
        self.mask = [bool(m) for m in mask]

    def _pick(self, tensors: Sequence[torch.Tensor]) -> list:
        if len(tensors) != len(self.mask):
            raise ValueError(f"{len(tensors)} tensors for a mask of {len(self.mask)}")
        return [t for t, m in zip(tensors, self.mask) if m]

    def init(self, params: Sequence[torch.Tensor]):
        return self.inner.init(self._pick(params))

    def update(self, grads: Sequence[torch.Tensor], state, params: Sequence[torch.Tensor]) -> None:
        self.inner.update(self._pick(grads), state, self._pick(params))


class set_to_zero:  # noqa: N801 - optax's name
    """optax.set_to_zero: a zero update, so the parameters stay as they
    are; the gradients are zeroed in place for any later transform."""

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]) -> None:
        for g in grads:
            g.zero_()


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (counted from 0, warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)
    return lambda count: warmup(count) if count < warmup_steps else decay(count - warmup_steps)
