"""A two-layer MLP, the model behind ``/infer``.

Port of ``gofr_tpu/models/mlp.py``: ``relu(x @ w1 + b1) @ w2 + b2`` with
weights in the JAX package's [in, out] layout, He-scaled normal weights
and zero biases. ``init_mlp`` draws from an explicit ``torch.Generator``
(JAX's PRNG cannot be reproduced: parity tests carry JAX's weights over
through ``models/convert.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 64
    hidden_dim: int = 256
    out_dim: int = 16
    dtype: torch.dtype = torch.float32


def _param(shape: tuple, dtype: torch.dtype, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device), requires_grad=False)


class MLP(nn.Module):
    """The weights: ``w1`` [in, hidden], ``b1``, ``w2`` [hidden, out], ``b2``."""

    def __init__(self, cfg: MLPConfig, device: "torch.device | str" = "cuda"):
        super().__init__()
        device = torch.device(device)
        self.cfg = cfg
        self.w1 = _param((cfg.in_dim, cfg.hidden_dim), cfg.dtype, device)
        self.b1 = _param((cfg.hidden_dim,), cfg.dtype, device)
        self.w2 = _param((cfg.hidden_dim, cfg.out_dim), cfg.dtype, device)
        self.b2 = _param((cfg.out_dim,), cfg.dtype, device)

    @property
    def device(self) -> torch.device:
        return self.w1.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self, x)


@torch.no_grad()
def init_mlp(cfg: MLPConfig, generator: torch.Generator,
             device: "torch.device | str" = "cuda") -> MLP:
    """Normal weights scaled by sqrt(2 / fan_in) (``w1`` drawn first, then
    ``w2``, in float32 on ``device`` from ``generator``, which lives
    there), zero biases."""
    model = MLP(cfg, device)
    for w, fan_in in ((model.w1, cfg.in_dim), (model.w2, cfg.hidden_dim)):
        draw = torch.empty(w.shape, dtype=torch.float32, device=model.device)
        draw.normal_(generator=generator)
        w.copy_(draw * (2.0 / fan_in) ** 0.5)
    return model


def mlp_forward(model: MLP, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ model.w1 + model.b1)
    return h @ model.w2 + model.b2
