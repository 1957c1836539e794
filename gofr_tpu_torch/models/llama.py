"""Named Llama-family configurations, as in ``gofr_tpu/models/llama.py``.

The JAX package pins ``TINY`` to its XLA attention; the port has no such
switch: every attention call on the card runs the flash kernel."""

from __future__ import annotations

import torch

from gofr_tpu_torch.models.transformer import TransformerConfig

LLAMA3_8B = TransformerConfig(
    vocab_size=128256,
    dim=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    hidden_dim=14336,
    max_seq=8192,
    rope_theta=500000.0,
)

LLAMA3_70B = TransformerConfig(
    vocab_size=128256,
    dim=8192,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,
    hidden_dim=28672,
    max_seq=8192,
    rope_theta=500000.0,
)

# tiny f32 config: fast CPU tests and the f32 check on the card
TINY = TransformerConfig(
    vocab_size=256,
    dim=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    hidden_dim=128,
    max_seq=128,
    rope_theta=10000.0,
    dtype=torch.float32,
)

SMALL = TransformerConfig(
    vocab_size=32000,
    dim=1024,
    n_layers=8,
    n_heads=8,
    n_kv_heads=4,
    hidden_dim=4096,
    max_seq=2048,
    rope_theta=500000.0,
)

CONFIGS: dict[str, TransformerConfig] = {
    "tiny": TINY,
    "small": SMALL,
    "llama3-8b": LLAMA3_8B,
    "llama3-70b": LLAMA3_70B,
}
