"""Normalization ops, accumulated in float32 whatever the input dtype.

Port of ``gofr_tpu/ops/norms.py::rms_norm``."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (Llama family). Output keeps the input dtype."""
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf / rms) * weight.float()).to(x.dtype)
