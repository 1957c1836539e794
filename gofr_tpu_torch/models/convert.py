"""Carry weights between the JAX package's parameter tree and the port.

The tree is nested dicts of arrays (numpy, or anything ``np.asarray``
accepts): ``embed`` [V, D], ``norm_f`` [D], ``lm_head`` [D, V] and
``layers`` holding each weight stacked ``[n_layers, ...]``. bfloat16
arrives as an ``ml_dtypes`` dtype; it is viewed as uint16 and then as
``torch.bfloat16`` (bit-exact) without importing ``ml_dtypes``.
Quantized packs (dicts) are not ported yet and raise.
``tree_from_transformer`` goes the other way, for comparing a trained
model with the JAX state.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gofr_tpu_torch.models.transformer import _LAYER_SHAPES, Transformer, TransformerConfig


def to_torch(arr: Any) -> torch.Tensor:
    """Array -> CPU tensor with the same bits (bfloat16 included)."""
    if isinstance(arr, dict):
        raise NotImplementedError(
            f"quantized weight pack with keys {sorted(arr)} is not ported yet"
        )
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@torch.no_grad()
def transformer_from_tree(
    tree: dict, cfg: TransformerConfig, device: "torch.device | str" = "cuda"
) -> Transformer:
    """Build the port's model on ``device`` (the card unless the caller
    asks for the CPU) from the JAX parameter tree, one tensor at a time."""
    model = Transformer(cfg, device)

    def put(dst: torch.Tensor, src: Any) -> None:
        t = to_torch(src)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit {tuple(dst.shape)}")
        dst.copy_(t.to(dst.dtype))

    put(model.embed, tree["embed"])
    put(model.norm_f, tree["norm_f"])
    put(model.lm_head, tree["lm_head"])
    for name in ("attn_norm", "mlp_norm", *_LAYER_SHAPES):
        stacked = tree["layers"][name]
        if isinstance(stacked, dict):
            to_torch(stacked)  # raises for quantized packs
        stacked = np.asarray(stacked)
        for i, block in enumerate(model.layers):
            put(getattr(block, name), stacked[i])
    return model


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16 without ml_dtypes: bf16 widens to f32 exactly
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def tree_from_transformer(model: Transformer) -> dict:
    """The model's weights as the JAX parameter tree: numpy arrays, the
    per-layer weights stacked ``[n_layers, ...]`` under ``layers``."""
    return {
        "embed": _to_numpy(model.embed),
        "norm_f": _to_numpy(model.norm_f),
        "lm_head": _to_numpy(model.lm_head),
        "layers": {
            name: np.stack([_to_numpy(getattr(block, name)) for block in model.layers])
            for name in ("attn_norm", "mlp_norm", *_LAYER_SHAPES)
        },
    }
