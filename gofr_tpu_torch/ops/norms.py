"""Normalization ops, accumulated in float32 whatever the input dtype.

Port of ``gofr_tpu/ops/norms.py``: ``rms_norm`` (the Llama family) and
``layer_norm`` (the BERT encoder)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (Llama family). Output keeps the input dtype."""
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf / rms) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with a float32 mean and (biased) variance whatever the
    input dtype; the output keeps the input dtype."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)
