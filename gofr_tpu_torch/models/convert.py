"""Carry weights between the JAX package's parameter tree and the port.

The tree is nested dicts of arrays (numpy, or anything ``np.asarray``
accepts): for the decoder ``embed`` [V, D], ``norm_f`` [D], ``lm_head``
[D, V] and ``layers`` holding each weight stacked ``[n_layers, ...]``;
for BERT (``bert_from_tree`` / ``tree_from_bert``) ``tok_embed``,
``pos_embed``, the final norm's ``norm_f_w`` / ``norm_f_b`` and its
stacked ``layers``; for the MLP (``mlp_from_tree`` / ``tree_from_mlp``)
``w1``, ``b1``, ``w2``, ``b2``; for the MoE decoder (``moe_from_tree``) the
decoder's tree with each layer's ``router`` [n_layers, D, E] (f32) and
expert stacks ``w_gate`` / ``w_up`` [n_layers, E, D, F] and ``w_down``
[n_layers, E, F, D] in place of the dense MLP. bfloat16
arrives as an ``ml_dtypes`` dtype; it is viewed as uint16 and then as
``torch.bfloat16`` (bit-exact) without importing ``ml_dtypes``. A quantized
weight is the JAX package's pack: ``{"q", "scale"}`` (int8),
``{"q8", "scale"}`` (w8a8) or ``{"q4", "scale"}`` (int4, whose ``q4``
arrives as an ``ml_dtypes`` int4 array and is read with
``np.asarray(x).astype(np.int8)``, then packed two a byte).
``tree_from_transformer`` goes the other way, for comparing a model with
the JAX state; its ``q4`` is int8 values, one a byte.

LoRA (``models/lora.py``): a wrapped leaf ``{"w", "lora_a", "lora_b",
"lora_scale"}`` (a dense or packed base ``w``; under ``layers`` the
adapters stacked [n_layers, in, r] / [n_layers, r, out], the scale
[n_layers, 1, 1]) crosses as the base model with the adapter attached
(``apply_adapter``: each layer's slice of the stacks), and an
``export_adapter`` artifact ``{"adapters", "scales"}`` crosses with
``artifact_from_tree`` / ``tree_from_artifact``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gofr_tpu_torch.models.bert import LAYER_MATMULS as BERT_LAYER_MATMULS
from gofr_tpu_torch.models.bert import LAYER_VECTORS as BERT_LAYER_VECTORS
from gofr_tpu_torch.models.bert import Bert, BertConfig
from gofr_tpu_torch.models.mlp import MLP, MLPConfig
from gofr_tpu_torch.models.moe import MoEConfig, MoETransformer
from gofr_tpu_torch.models.quant import Pack, pack_int4, unpack_int4
from gofr_tpu_torch.models.transformer import Transformer, TransformerConfig


def to_torch(arr: Any) -> torch.Tensor:
    """Array -> CPU tensor with the same bits (bfloat16 included)."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "int4":
        return torch.from_numpy(a.astype(np.int8))
    return torch.from_numpy(a.copy())


def tree_quant_mode(tree: dict, key: str = "wq") -> Any:
    """The MODEL_QUANT mode a JAX tree was quantized with (None: dense),
    read from its layers' ``key`` (a decoder's ``wq``, BERT's ``wqkv``)."""
    wq = tree["layers"][key]
    if not isinstance(wq, dict):
        return None
    for key, mode in (("q8", "w8a8"), ("q4", "int4"), ("q", "int8")):
        if key in wq:
            return mode
    raise ValueError(f"unknown weight pack with keys {sorted(wq)}")


def _pack_from_tree(leaf: dict, i: Any = None) -> dict:
    """A JAX pack (layer ``i`` of a stacked one) as the port's pack."""
    out = {}
    for name, arr in leaf.items():
        t = to_torch(arr if i is None else np.asarray(arr)[i])
        out[name] = pack_int4(t) if name == "q4" else t
    return out


def _is_lora_leaf(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"w", "lora_a", "lora_b", "lora_scale"}


def split_lora_tree(tree: dict) -> tuple[dict, Any]:
    """A (possibly LoRA-wrapped) JAX tree -> (the base tree, its adapters
    as an artifact of the port's tensors, or None when nothing is
    wrapped)."""
    base = dict(tree)
    base["layers"] = dict(tree["layers"])
    adapters: dict = {}
    scales: dict = {}
    for owner, key, a_out, s_out in (
        [(base, "lm_head", adapters, scales)]
        + [(base["layers"], k, adapters.setdefault("layers", {}), scales.setdefault("layers", {}))
           for k in list(base["layers"])]
    ):
        leaf = owner[key]
        if _is_lora_leaf(leaf):
            owner[key] = leaf["w"]
            a_out[key] = {"lora_a": to_torch(leaf["lora_a"]), "lora_b": to_torch(leaf["lora_b"])}
            s_out[key] = to_torch(leaf["lora_scale"])
    for d in (adapters, scales):
        if not d.get("layers", True):
            del d["layers"]
    return base, ({"adapters": adapters, "scales": scales} if adapters else None)


def _map_tree(tree: Any, fn: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def artifact_from_tree(artifact: dict) -> dict:
    """A JAX ``export_adapter`` artifact -> the port's (tensors, bits kept)."""
    return _map_tree(artifact, to_torch)


def tree_from_artifact(artifact: dict) -> dict:
    """The port's artifact -> numpy (bf16 widened to f32 exactly)."""
    return _map_tree(artifact, _to_numpy)


@torch.no_grad()
def transformer_from_tree(
    tree: dict, cfg: TransformerConfig, device: "torch.device | str" = "cuda"
) -> Transformer:
    """Build the port's model on ``device`` (the card unless the caller
    asks for the CPU) from the JAX parameter tree, one tensor at a time. A
    quantized tree gives a model holding the same packs, bit for bit; a
    LoRA-wrapped tree gives the base with its adapters attached."""
    tree, artifact = split_lora_tree(tree)
    if artifact is not None:
        from gofr_tpu_torch.models.lora import apply_adapter

        return apply_adapter(transformer_from_tree(tree, cfg, device), artifact)
    model = Transformer(cfg, device, tree_quant_mode(tree))
    _fill(model, tree, ("embed", "norm_f", "lm_head"), Transformer.layer_weights)
    return model


def _put(owner: Any, name: str, src: Any, i: Any = None) -> None:
    """Weight ``name`` of ``owner`` from a tree leaf (layer ``i`` of a
    stacked one): a dense copy, or a pack loaded bit for bit."""
    dst = getattr(owner, name)
    if isinstance(dst, Pack):
        if not isinstance(src, dict):
            raise ValueError(f"{name}: a dense array where the model holds a pack")
        dst.load(_pack_from_tree(src, i))
        return
    if isinstance(src, dict):
        raise ValueError(f"{name}: a pack where the model holds a dense weight")
    t = to_torch(src if i is None else np.asarray(src)[i])
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(t.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(t.to(dst.dtype))


@torch.no_grad()
def _fill(model: Any, tree: dict, top: tuple, per_layer: tuple) -> None:
    """The model's top-level weights ``top`` and each layer's ``per_layer``
    weights from the tree, the stacked [n_layers, ...] leaves split per
    layer."""
    for name in top:
        _put(model, name, tree[name])
    for name in per_layer:
        stacked = tree["layers"][name]
        if not isinstance(stacked, dict):
            stacked = np.asarray(stacked)
        for i, block in enumerate(model.layers):
            _put(block, name, stacked, i)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16 without ml_dtypes: bf16 widens to f32 exactly
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _leaf(w: Any) -> Any:
    from gofr_tpu_torch.models.lora import LoraWeight

    if isinstance(w, LoraWeight):
        return {"w": _leaf(w.w), "lora_a": _to_numpy(w.lora_a), "lora_b": _to_numpy(w.lora_b),
                "lora_scale": _to_numpy(w.lora_scale)}
    if isinstance(w, Pack):
        return {name: _to_numpy(unpack_int4(t) if name == "q4" else t)
                for name, t in w.pack.items()}
    return _to_numpy(w)


def _stack(leaves: list) -> Any:
    if isinstance(leaves[0], dict):
        return {name: _stack([leaf[name] for leaf in leaves]) for name in leaves[0]}
    return np.stack(leaves)


def tree_from_transformer(model: Transformer) -> dict:
    """The model's weights (a decoder's or an MoE decoder's) as the JAX
    parameter tree: numpy arrays (packs and LoRA-wrapped weights as dicts),
    the per-layer weights stacked ``[n_layers, ...]`` under ``layers``."""
    return {
        "embed": _leaf(model.embed),
        "norm_f": _leaf(model.norm_f),
        "lm_head": _leaf(model.lm_head),
        "layers": {
            name: _stack([_leaf(getattr(block, name)) for block in model.layers])
            for name in model.layer_weights
        },
    }


@torch.no_grad()
def moe_from_tree(tree: dict, cfg: MoEConfig,
                  device: "torch.device | str" = "cuda") -> MoETransformer:
    """The port's MoE decoder on ``device`` from the JAX ``init_moe`` tree,
    one tensor at a time. A ``quantize_params`` tree gives the same packs
    for attention and ``lm_head``, bit for bit, and dense experts."""
    model = MoETransformer(cfg, device, tree_quant_mode(tree))
    _fill(model, tree, ("embed", "norm_f", "lm_head"), MoETransformer.layer_weights)
    return model


@torch.no_grad()
def bert_from_tree(tree: dict, cfg: BertConfig, device: "torch.device | str" = "cuda") -> Bert:
    """The port's BERT on ``device`` from the JAX ``init_bert`` tree (its
    layers stacked [n_layers, ...]); a ``quantize_params`` tree gives a
    model holding the same packs, bit for bit."""
    model = Bert(cfg, device, tree_quant_mode(tree, "wqkv"))
    _fill(model, tree, ("tok_embed", "pos_embed", "norm_f_w", "norm_f_b"),
          (*BERT_LAYER_VECTORS, *BERT_LAYER_MATMULS))
    return model


def tree_from_bert(model: Bert) -> dict:
    """The model's weights as the JAX ``init_bert`` tree: numpy arrays
    (packs as dicts), each layer's weights stacked under ``layers``."""
    tree = {name: _leaf(getattr(model, name))
            for name in ("tok_embed", "pos_embed", "norm_f_w", "norm_f_b")}
    tree["layers"] = {
        name: _stack([_leaf(getattr(layer, name)) for layer in model.layers])
        for name in (*BERT_LAYER_VECTORS, *BERT_LAYER_MATMULS)
    }
    return tree


@torch.no_grad()
def mlp_from_tree(tree: dict, cfg: MLPConfig, device: "torch.device | str" = "cuda") -> MLP:
    """The port's MLP on ``device`` from the JAX ``init_mlp`` tree."""
    model = MLP(cfg, device)
    for name in ("w1", "b1", "w2", "b2"):
        _put(model, name, tree[name])
    return model


def tree_from_mlp(model: MLP) -> dict:
    return {name: _leaf(getattr(model, name)) for name in ("w1", "b1", "w2", "b2")}
