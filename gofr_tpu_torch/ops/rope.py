"""Rotary position embeddings (split-half convention, Llama style).

Port of ``gofr_tpu/ops/rope.py``. ``cached_freqs`` is the numpy table the
model builds once per config (``gofr_tpu/models/transformer.py::_cached_freqs``)
so the decode loop does no trigonometry.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def rope_frequencies(
    head_dim: int, max_seq: int, theta: float = 10000.0, device: "torch.device | str" = "cpu"
) -> torch.Tensor:
    """[max_seq, head_dim//2, 2] float32 table of (cos, sin)."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.stack([torch.cos(freqs), torch.sin(freqs)], dim=-1)


@functools.lru_cache(maxsize=16)
def cached_freqs(head_dim: int, max_seq: int, theta: float) -> np.ndarray:
    """The same table computed in numpy and cached per config: the model
    uploads it once to its device."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    freqs = np.outer(np.arange(max_seq, dtype=np.float32), inv_freq)
    return np.stack([np.cos(freqs), np.sin(freqs)], axis=-1).astype(np.float32)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., seq, n_heads, head_dim] by absolute position.

    ``positions``: [seq] or [batch, seq]. (x1, x2) -> (x1*cos - x2*sin,
    x2*cos + x1*sin), computed in float32 and cast back to x's dtype."""
    cos_sin = freqs[positions]  # [..., seq, head_dim//2, 2]
    cos = cos_sin[..., 0].unsqueeze(-2)  # broadcast over heads
    sin = cos_sin[..., 1].unsqueeze(-2)
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
