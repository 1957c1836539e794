"""Next-token loss, as ``gofr_tpu/ops/loss.py``."""

from __future__ import annotations

import torch


def next_token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood.

    logits [..., S, V] (any float dtype; the log-softmax runs in f32),
    targets [..., S] int -> nll [..., S] float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
