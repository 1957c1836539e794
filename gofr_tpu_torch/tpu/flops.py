"""Analytic parameter counts (trimmed port of ``gofr_tpu/tpu/flops.py``):
what a model's weights should weigh, held against the bytes a boot puts
on the card."""

from __future__ import annotations

from typing import Any


def bert_param_count(cfg: Any) -> int:
    """Parameters of ``models/bert.py``'s layout: the token and position
    embeddings, the final norm, and per layer ``wqkv``, ``wo``,
    ``w_in``/``b_in``, ``w_out``/``b_out`` and two layer norms (weight and
    bias each)."""
    d, f = cfg.dim, cfg.hidden_dim
    per_layer = (
        d * 3 * d  # wqkv
        + d * d  # wo
        + d * f + f  # w_in, b_in
        + f * d + d  # w_out, b_out
        + 4 * d  # two layer norms
    )
    return cfg.vocab_size * d + cfg.max_seq * d + 2 * d + cfg.n_layers * per_layer
