"""BERT-style bidirectional encoder for sentence embeddings.

Port of ``gofr_tpu/models/bert.py``: pre-LN encoder blocks with learned
position embeddings, a tanh-GELU FFN, then a masked mean pool over the
valid tokens and an L2 normalization. Weights keep the JAX package's
[in, out] layout and names; the layer stack is an ``nn.ModuleList`` (the
JAX ``lax.scan`` over stacked weights becomes a Python loop).

Attention is non-causal over each row's valid keys. The JAX function
takes a key mask and sends it to XLA; here the mask must be a prefix (1s,
then 0s, as the serving runner builds it) and becomes the flash kernel's
``kv_lens``: on a CUDA tensor the hand-written forward
(``csrc/flash_fwd.cu``), on a CPU tensor its plain version. A mask that
is not a prefix raises. q, k and v are strided views of the one ``wqkv``
product, which the kernel reads in place.

Every product goes through ``models/quant.py::mm``, so a model built with
``quant`` (``MODEL_QUANT``: int8, int4, w8a8) holds a
:class:`~gofr_tpu_torch.models.quant.Pack` in place of each of ``wqkv``,
``wo``, ``w_in`` and ``w_out`` (the JAX package's quantized keys);
embeddings, norms and biases stay dense.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from gofr_tpu_torch.models.quant import (
    Pack,
    mm,
    quantizer_for,
    quantizer_for_key,
)
from gofr_tpu_torch.models.transformer import _fill_trunc_normal, _weight
from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.ops.norms import layer_norm


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    max_seq: int = 512
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


# the serving runner's two named configurations (``MODEL_NAME``)
BERT_BASE = BertConfig()
BERT_TINY = BertConfig(vocab_size=30522, dim=128, n_layers=2, n_heads=2, hidden_dim=512,
                       max_seq=128)

# each layer's matmul weights, in the init's draw order
LAYER_MATMULS = ("wqkv", "wo", "w_in", "w_out")
# each layer's vectors: the two norms' weights and biases, the FFN biases
LAYER_VECTORS = ("attn_norm_w", "attn_norm_b", "mlp_norm_w", "mlp_norm_b", "b_in", "b_out")


def layer_shapes(cfg: BertConfig) -> dict:
    """Each layer's matmul weight shapes, [in, out]."""
    return {
        "wqkv": (cfg.dim, 3 * cfg.dim),
        "wo": (cfg.dim, cfg.dim),
        "w_in": (cfg.dim, cfg.hidden_dim),
        "w_out": (cfg.hidden_dim, cfg.dim),
    }


def _vector(n: int, cfg: BertConfig, device: torch.device, ones: bool) -> nn.Parameter:
    fill = torch.ones if ones else torch.zeros
    return nn.Parameter(fill(n, dtype=cfg.dtype, device=device), requires_grad=False)


class BertLayer(nn.Module):
    """One encoder layer: norms (weights 1, biases 0), FFN biases (0) and
    the matmul weights, each dense or a pack."""

    def __init__(self, cfg: BertConfig, device: torch.device, quant: Any = None):
        super().__init__()
        for name in LAYER_VECTORS:
            n = cfg.hidden_dim if name == "b_in" else cfg.dim
            setattr(self, name, _vector(n, cfg, device, ones=name.endswith("norm_w")))
        for name, shape in layer_shapes(cfg).items():
            setattr(self, name, _weight(cfg, device, quant, name, shape))


class Bert(nn.Module):
    """The encoder. Construct with ``Bert.random(cfg, device, seed)`` /
    ``init_bert`` (seeded init on the device) or fill from the JAX tree
    with ``models/convert.py::bert_from_tree``."""

    def __init__(self, cfg: BertConfig, device: "torch.device | str" = "cuda",
                 quant: Any = None):
        super().__init__()
        device = torch.device(device)
        quantizer_for(quant)  # an unknown mode raises here
        self.cfg = cfg
        self.quant = quant or None
        self.tok_embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.dim), dtype=cfg.dtype, device=device),
            requires_grad=False,
        )
        self.pos_embed = nn.Parameter(
            torch.empty((cfg.max_seq, cfg.dim), dtype=cfg.dtype, device=device),
            requires_grad=False,
        )
        self.norm_f_w = _vector(cfg.dim, cfg, device, ones=True)
        self.norm_f_b = _vector(cfg.dim, cfg, device, ones=False)
        self.layers = nn.ModuleList(BertLayer(cfg, device, self.quant)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def named_weights(self):
        """(name, owner module) of every weight the JAX tree names:
        ``tok_embed``, ``pos_embed``, the final norm, then each layer's
        vectors and matmul weights."""
        for name in ("tok_embed", "pos_embed", "norm_f_w", "norm_f_b"):
            yield name, self
        for layer in self.layers:
            for name in (*LAYER_VECTORS, *LAYER_MATMULS):
                yield name, layer

    def weight_bytes(self) -> int:
        """Bytes of every weight the model serves with (packs included)."""
        return sum(t.numel() * t.element_size() for t in (*self.parameters(), *self.buffers()))

    @torch.no_grad()
    def set_weight(self, owner: nn.Module, name: str, dense: torch.Tensor) -> None:
        """Fill weight ``name`` of ``owner`` from a dense tensor: a copy, or
        the pack of ``quantizer_for_key(self.quant, name)``."""
        target = getattr(owner, name)
        if isinstance(target, Pack):
            target.load(quantizer_for_key(self.quant, name)(dense.to(self.cfg.dtype)))
            return
        if tuple(dense.shape) != tuple(target.shape):
            raise ValueError(f"shape {tuple(dense.shape)} does not fit {tuple(target.shape)}")
        target.copy_(dense)

    @classmethod
    @torch.no_grad()
    def random(cls, cfg: BertConfig, device: "torch.device | str", seed: int = 0,
               quant: Any = None) -> "Bert":
        """``init_bert`` from a generator seeded with ``seed`` on ``device``."""
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(seed)
        return init_bert(cfg, gen, device, quant)

    @torch.no_grad()
    def quantized(self, mode: Any) -> "Bert":
        """A new model holding ``mode``'s packs of this dense model's
        matmul weights (embeddings, norms and biases copied)."""
        if self.quant is not None:
            raise ValueError(f"the model is already quantized ({self.quant})")
        out = Bert(self.cfg, self.device, mode)
        for (name, owner), (_, src) in zip(out.named_weights(), self.named_weights()):
            out.set_weight(owner, name, getattr(src, name))
        return out

    def forward(self, tokens: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        return bert_embed(self, tokens, attn_mask)


@torch.no_grad()
def init_bert(cfg: BertConfig, generator: torch.Generator,
              device: "torch.device | str" = "cuda", quant: Any = None) -> Bert:
    """The JAX ``init_bert``'s shapes and scaling: every matrix a normal
    truncated to [-3, 3] times fan_in**-0.5 (the embeddings' fan-in is
    ``dim``), drawn in the JAX order (``tok_embed``, ``pos_embed``, then
    each layer's ``wqkv``, ``wo``, ``w_in``, ``w_out``) from ``generator``
    on ``device``; norm weights 1, biases 0. Under ``quant`` each matmul
    weight is drawn in ``cfg.dtype`` and quantized at once (the values of
    ``init_bert(...).quantized(quant)``)."""
    model = Bert(cfg, device, quant)
    for name, owner in model.named_weights():
        if name not in ("tok_embed", "pos_embed", *LAYER_MATMULS):
            continue
        target = getattr(owner, name)
        if isinstance(target, Pack):
            dense = torch.empty(target.dense_shape, dtype=cfg.dtype, device=model.device)
            _fill_trunc_normal(dense, dense.shape[0], generator)
            model.set_weight(owner, name, dense)
            del dense
        else:
            fan_in = cfg.dim if name.endswith("_embed") else target.shape[0]
            _fill_trunc_normal(target, fan_in, generator)
    return model


def prefix_lengths(attn_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] mask (1 = valid) -> [B] int32 valid lengths. Raises
    ValueError unless each row is a prefix: 1s, then 0s (the kernel bounds
    the keys by length; it takes no arbitrary mask)."""
    valid = attn_mask != 0
    lens = valid.sum(dim=-1, dtype=torch.int32)
    prefix = torch.arange(valid.shape[-1], device=valid.device)[None, :] < lens[:, None]
    if not torch.equal(prefix, valid):
        raise ValueError("attn_mask must be a prefix mask (each row 1s, then 0s): attention "
                         "bounds every row's keys by its length")
    return lens


def bert_embed(model: Bert, tokens: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
    """``tokens`` [B, S] ids, ``attn_mask`` [B, S] prefix mask (1 = valid).
    Returns L2-normalized [B, dim] float32 embeddings."""
    cfg = model.cfg
    b, s = tokens.shape
    lens = prefix_lengths(attn_mask)
    x = model.tok_embed[tokens.long()] + model.pos_embed[:s][None]
    for layer in model.layers:
        h = layer_norm(x, layer.attn_norm_w, layer.attn_norm_b, cfg.norm_eps)
        # q, k, v stay views of the one product (the kernel reads strides)
        qkv = mm(h, layer.wqkv).view(b, s, 3, cfg.n_heads, cfg.head_dim)
        attn = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False, kv_lens=lens)
        x = x + mm(attn.reshape(b, s, cfg.dim), layer.wo)
        h = layer_norm(x, layer.mlp_norm_w, layer.mlp_norm_b, cfg.norm_eps)
        # jax.nn.gelu's default is the tanh form
        h = mm(F.gelu(mm(h, layer.w_in) + layer.b_in, approximate="tanh"), layer.w_out)
        x = x + (h + layer.b_out)  # the JAX order: the bias, then the residual
    x = layer_norm(x, model.norm_f_w, model.norm_f_b, cfg.norm_eps)
    # masked mean pool in f32
    weights = attn_mask.float()[..., None]
    pooled = (x.float() * weights).sum(dim=1) / torch.clamp(weights.sum(dim=1), min=1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-9)
