"""Llama-family decoder-only transformer: RMSNorm, RoPE, GQA attention,
SwiGLU, with a KV-cached ragged-batch serving path.

Port of ``gofr_tpu/models/transformer.py``. Weights keep the JAX
package's [in, out] layout so ``x @ w`` reads the same; the layer stack
is an ``nn.ModuleList`` (the JAX ``lax.scan`` over stacked weights becomes
a Python loop). Attention goes through ``ops/attention.py``: the flash
kernels on the card (forward, and backward when training), their plain
versions on the CPU. Parameters are built with ``requires_grad=False``, so
serving builds no graph; the trainer turns it on.

The KV cache is ``{"k", "v": [n_layers, B, max_seq, n_kv_heads, head_dim],
"lengths": [B] int32}`` in the dtype ``init_cache`` is given (float8 e4m3
under a deployment's ``MODEL_KV_DTYPE=f8``: written through its uint8
bits, upcast to the compute dtype at the attention boundary). Unlike the
JAX package, ``prefill``/``decode_step`` write the new keys and values
into the cache tensors IN PLACE (a full cache copy per call would double
decode's memory traffic) and return a dict holding the same tensors with
advanced ``lengths``.

A model built with ``quant`` (``MODEL_QUANT``: int8, int4, w8a8) holds a
:class:`~gofr_tpu_torch.models.quant.Pack` (buffers, not parameters) in
place of each matmul weight; ``random(..., quant=)`` quantizes each weight
as it is drawn, so the init never holds the dense model and its packs
together. Such a model serves, and trains LoRA adapters over its packs
(QLoRA, ``models/lora.py``); the full-model trainer refuses it.

A LoRA model (``models/lora.py``) is built by ``with_weights``: it shares
the base's tensors and holds a wrapped weight in place of each targeted
one, so every forward here serves it unchanged (``mm`` adds the delta).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gofr_tpu_torch.models.quant import (
    Pack,
    dequantize_pack,
    empty_pack,
    mm,
    quantizer_for,
    quantizer_for_key,
)
from gofr_tpu_torch.ops.attention import attention, kv_bits, zeros_kv
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.rope import apply_rope, cached_freqs
from gofr_tpu_torch.ops.sampling import (
    apply_penalties,
    sample_logits_rows,
    update_counts,
    update_presence,
    warped_probs,
)


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


_LAYER_SHAPES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# Phi(-3) and Phi(3): the uniform range whose inverse-CDF image is the
# normal truncated to [-3, 3]
_TRUNC_LO = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
_TRUNC_HI = 0.5 * (1.0 + math.erf(3.0 / math.sqrt(2.0)))


def _fill_trunc_normal(param: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """param <- truncated normal in [-3, 3] times fan_in**-0.5, drawn in
    float32 on param's device (one weight's f32 copy at a time)."""
    w = torch.empty(param.shape, dtype=torch.float32, device=param.device)
    w.uniform_(2 * _TRUNC_LO - 1, 2 * _TRUNC_HI - 1, generator=gen)
    w.erfinv_().mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0).mul_(fan_in ** -0.5)
    param.copy_(w)


def layer_shapes(cfg: TransformerConfig) -> dict:
    """Each decoder layer's matmul weight shapes, [in, out]."""
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    return {
        "wq": (cfg.dim, cfg.dim),
        "wk": (cfg.dim, kv_dim),
        "wv": (cfg.dim, kv_dim),
        "wo": (cfg.dim, cfg.dim),
        "w_gate": (cfg.dim, cfg.hidden_dim),
        "w_up": (cfg.dim, cfg.hidden_dim),
        "w_down": (cfg.hidden_dim, cfg.dim),
    }


def _weight(cfg: TransformerConfig, device: torch.device, quant: Any, key: str,
            shape: tuple) -> nn.Module:
    """A matmul weight: a dense parameter, or an empty pack under ``quant``."""
    if quantizer_for_key(quant, key) is not None:
        return Pack(empty_pack(quant, key, shape, device))
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device), requires_grad=False)


class Block(nn.Module):
    """One decoder layer's weights ([in, out] layout, as in the JAX tree),
    each matmul weight dense or a pack."""

    def __init__(self, cfg: TransformerConfig, device: torch.device, quant: Any = None):
        super().__init__()
        self.attn_norm = nn.Parameter(
            torch.ones(cfg.dim, dtype=cfg.dtype, device=device), requires_grad=False
        )
        self.mlp_norm = nn.Parameter(
            torch.ones(cfg.dim, dtype=cfg.dtype, device=device), requires_grad=False
        )
        for name, shape in layer_shapes(cfg).items():
            setattr(self, name, _weight(cfg, device, quant, name, shape))


class Transformer(nn.Module):
    """The decoder. Construct with ``Transformer.random(cfg, device, seed)``
    (seeded init on the device) or fill from the JAX tree with
    ``models/convert.py``. A subclass swaps the layer (``block_class``) and
    names its weights (``layer_weights``): ``models/moe.py``'s experts."""

    block_class: Callable = Block
    layer_weights: tuple = ("attn_norm", "mlp_norm", *_LAYER_SHAPES)

    def __init__(self, cfg: TransformerConfig, device: "torch.device | str" = "cuda",
                 quant: Any = None):
        super().__init__()
        device = torch.device(device)
        quantizer_for(quant)  # an unknown mode raises here
        self.cfg = cfg
        self.quant = quant or None
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.dim), dtype=cfg.dtype, device=device),
            requires_grad=False,
        )
        self.norm_f = nn.Parameter(
            torch.ones(cfg.dim, dtype=cfg.dtype, device=device), requires_grad=False
        )
        self.lm_head = _weight(cfg, device, self.quant, "lm_head", (cfg.dim, cfg.vocab_size))
        self.layers = nn.ModuleList(
            self.block_class(cfg, device, self.quant) for _ in range(cfg.n_layers))
        freqs = cached_freqs(cfg.head_dim, cfg.max_seq, cfg.rope_theta)
        self.register_buffer("freqs", torch.from_numpy(freqs).to(device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def named_weights(self):
        """(name, owner module) of every weight the JAX tree names, in the
        init's draw order: ``embed``, ``norm_f``, ``lm_head``, then each
        layer's norms and matmul weights."""
        for name in ("embed", "norm_f", "lm_head"):
            yield name, self
        for layer in self.layers:
            for name in self.layer_weights:
                yield name, layer

    def weight_bytes(self) -> int:
        """Bytes of every weight the model serves with (packs included)."""
        return sum(t.numel() * t.element_size()
                   for t in (*self.parameters(), *self.buffers()) if t is not self.freqs)

    @torch.no_grad()
    def set_weight(self, owner: nn.Module, name: str, dense: torch.Tensor) -> None:
        """Fill weight ``name`` of ``owner`` from a dense [in, out] tensor:
        a copy, or the pack of ``quantizer_for_key(self.quant, name)``."""
        target = getattr(owner, name)
        if isinstance(target, Pack):
            target.load(quantizer_for_key(self.quant, name)(dense.to(self.cfg.dtype)))
            return
        if tuple(dense.shape) != tuple(target.shape):
            raise ValueError(f"shape {tuple(dense.shape)} does not fit {tuple(target.shape)}")
        target.copy_(dense)

    @classmethod
    @torch.no_grad()
    def random(cls, cfg: TransformerConfig, device: "torch.device | str", seed: int = 0,
               quant: Any = None) -> "Transformer":
        """Scaled truncated-normal init drawn on ``device`` from one seeded
        generator, weight by weight, so an 8B model never sits on the host
        or in float32 whole. Norm weights are ones. Under ``quant`` each
        weight is drawn in ``cfg.dtype`` and quantized at once: the values
        equal ``Transformer.random(cfg, device, seed).quantized(quant)``,
        and the init holds the packs plus one dense weight."""
        model = cls(cfg, device, quant)
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
        for name, owner in model.named_weights():
            if name in ("norm_f", "attn_norm", "mlp_norm"):
                continue
            target = getattr(owner, name)
            # fan-in: the input axis of an [..., in, out] weight
            if isinstance(target, Pack):
                dense = torch.empty(target.dense_shape, dtype=cfg.dtype, device=model.device)
                _fill_trunc_normal(dense, cfg.dim if name == "embed" else dense.shape[-2], gen)
                model.set_weight(owner, name, dense)
                del dense
            else:
                _fill_trunc_normal(target, cfg.dim if name == "embed" else target.shape[-2], gen)
        return model

    def _like(self, cfg: TransformerConfig, quant: Any = None) -> "Transformer":
        """An empty model of this kind on this device (``quantized`` and
        ``dequantized`` fill it)."""
        return Transformer(cfg, self.device, quant)

    def with_weights(self, wrap: Callable[[str, Optional[int], Any], Any]) -> "Transformer":
        """A model that shares every tensor of this one (the same Parameter
        and Pack objects, no copy), each matmul weight replaced by
        ``wrap(name, layer index or None for lm_head, weight)``: how
        ``models/lora.py`` serves an adapter, a pooled bank or a chunk's
        gathered rows over one base."""
        out = Transformer.__new__(Transformer)
        nn.Module.__init__(out)
        out.cfg, out.quant = self.cfg, self.quant
        out.embed, out.norm_f = self.embed, self.norm_f
        out.lm_head = wrap("lm_head", None, self.lm_head)
        blocks = []
        for i, src in enumerate(self.layers):
            block = Block.__new__(Block)
            nn.Module.__init__(block)
            block.attn_norm, block.mlp_norm = src.attn_norm, src.mlp_norm
            for name in _LAYER_SHAPES:
                setattr(block, name, wrap(name, i, getattr(src, name)))
            blocks.append(block)
        out.layers = nn.ModuleList(blocks)
        out.register_buffer("freqs", self.freqs, persistent=False)
        return out

    @torch.no_grad()
    def quantized(self, mode: Any) -> "Transformer":
        """A new model holding ``mode``'s packs of this dense model's
        weights (embeddings and norms copied), built one weight at a time."""
        if self.quant is not None:
            raise ValueError(f"the model is already quantized ({self.quant})")
        out = self._like(self.cfg, mode)
        for (name, owner), (_, src) in zip(out.named_weights(), self.named_weights()):
            out.set_weight(owner, name, getattr(src, name))
        return out

    @torch.no_grad()
    def dequantized(self, dtype: Optional[torch.dtype] = None) -> "Transformer":
        """A new dense model (``dtype``, default the config's) with this
        model's packs dequantized, one weight at a time."""
        cfg = self.cfg if dtype is None else dataclasses.replace(self.cfg, dtype=dtype)
        out = self._like(cfg)
        for (name, owner), (_, src) in zip(out.named_weights(), self.named_weights()):
            w = getattr(src, name)
            # a dense weight converts in the copy, to its own dtype in ``out``
            # (an MoE router stays f32)
            out.set_weight(owner, name, dequantize_pack(w.pack, cfg.dtype)
                           if isinstance(w, Pack) else w)
        return out

    # -- one decoder block ---------------------------------------------------
    def _attn_half(
        self,
        layer: Block,
        x: torch.Tensor,
        positions: torch.Tensor,
        n_heads: int,
        n_kv_heads: int,
        kv_cache: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
        write_at: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
        starts: Optional[torch.Tensor] = None,
        kv_lens: Optional[torch.Tensor] = None,
        out: Callable = mm,
        attn_fn: Optional[Callable] = None,
    ) -> Any:
        """The attention half of a block over ``n_heads`` query and
        ``n_kv_heads`` KV heads (the whole model's, or one tp shard's),
        ending in ``out(attn, wo)``: the row-parallel product. Without a
        cache: causal attention over this call's keys, or ``attn_fn(q, k,
        v)`` in its place (the JAX ``_block``'s hook). With one
        (``kv_cache`` = this layer's [B, max_seq, Hkv, D] k and v): write
        the new k/v at the (rows, cols) index ``write_at`` and attend the
        cache from ``starts`` [B] up to ``kv_lens``."""
        q, k, v = self._qkv(layer, x, positions, n_heads, n_kv_heads)
        if kv_cache is None:
            attn = attention(q, k, v, causal=True) if attn_fn is None else attn_fn(q, k, v)
        else:
            k_cache, v_cache = kv_cache
            kv_bits(k_cache)[write_at] = kv_bits(k.to(k_cache.dtype))
            kv_bits(v_cache)[write_at] = kv_bits(v.to(v_cache.dtype))
            attn = attention(
                q, k_cache, v_cache, causal=True, q_offset=starts, kv_lens=kv_lens
            )
        return self._attn_out(layer, attn, out)

    def _qkv(self, layer: Block, x: torch.Tensor, positions: torch.Tensor, n_heads: int,
             n_kv_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The attention half's projections, roped at ``positions``: q [B,
        S, n_heads, D], k and v [B, S, n_kv_heads, D]."""
        b, s, _ = x.shape
        hd = self.cfg.head_dim
        h = rms_norm(x, layer.attn_norm, self.cfg.norm_eps)
        q = mm(h, layer.wq).view(b, s, n_heads, hd)
        k = mm(h, layer.wk).view(b, s, n_kv_heads, hd)
        v = mm(h, layer.wv).view(b, s, n_kv_heads, hd)
        freqs = self._freqs_on(x.device)
        return apply_rope(q, freqs, positions), apply_rope(k, freqs, positions), v

    @staticmethod
    def _attn_out(layer: Block, attn: torch.Tensor, out: Callable = mm) -> Any:
        """The attention half's end: ``out(attn, wo)`` over the heads."""
        b, s, h, hd = attn.shape
        return out(attn.reshape(b, s, h * hd), layer.wo)

    def _mlp_half(self, layer: Block, x: torch.Tensor, out: Callable = mm) -> Any:
        """The SwiGLU half of a block (the whole hidden dimension, or one tp
        shard's), ending in ``out(gated, w_down)``: the row-parallel
        product."""
        h = rms_norm(x, layer.mlp_norm, self.cfg.norm_eps)
        gated = F.silu(mm(h, layer.w_gate)) * mm(h, layer.w_up)
        return out(gated, layer.w_down)

    def _block(
        self,
        layer: Block,
        x: torch.Tensor,
        positions: torch.Tensor,
        kv_cache: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
        write_at: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
        starts: Optional[torch.Tensor] = None,
        kv_lens: Optional[torch.Tensor] = None,
        attn_fn: Optional[Callable] = None,
        mlp_fn: Optional[Callable] = None,
    ) -> Any:
        """One decoder layer: each half with its residual add. ``mlp_fn(layer,
        h)`` replaces the SwiGLU half (the JAX ``_block``'s hook): it gets the
        ``mlp_norm``-normed hidden state and returns ``(out, aux)``, and the
        layer then returns ``(x, aux)``; without it, the SwiGLU half and
        ``x`` alone."""
        cfg = self.cfg
        x = x + self._attn_half(layer, x, positions, cfg.n_heads, cfg.n_kv_heads, kv_cache,
                                write_at, starts, kv_lens, attn_fn=attn_fn)
        if mlp_fn is None:
            return x + self._mlp_half(layer, x)
        y, aux = mlp_fn(layer, rms_norm(x, layer.mlp_norm, cfg.norm_eps))
        return x + y, aux

    def _freqs_on(self, device: torch.device) -> torch.Tensor:
        """The RoPE table on ``device`` (a sharded model keeps one a device;
        a sequence shard on another card reads a copy)."""
        return self.freqs if device == self.freqs.device else self.freqs.to(device)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] ids -> [B, S, D] embeddings."""
        return self.embed[tokens.long()]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states [..., D] -> f32 logits [..., V]."""
        return mm(x, self.lm_head).float()

    # -- full-sequence forward -------------------------------------------------
    def transformer_forward(self, tokens: torch.Tensor, remat: bool = False,
                            positions: Optional[torch.Tensor] = None,
                            attn_fn: Optional[Callable] = None,
                            mlp_fn: Optional[Callable] = None) -> Any:
        """[B, S] ids -> f32 logits [B, S, V] (no cache; training and
        scoring). Differentiable when the parameters require grad.
        ``remat`` recomputes each block in the backward instead of keeping
        its activations (``torch.utils.checkpoint``), the counterpart of
        the JAX trainer's ``jax.checkpoint``: only the block inputs stay.
        ``positions`` [S] are the tokens' absolute positions (default 0..S-1;
        a sequence shard passes its own), ``attn_fn(q, k, v)`` replaces the
        causal attention of every block. With ``mlp_fn`` (``_block``'s hook)
        it returns ``(logits, [each layer's aux])``."""
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._embed(tokens)
        auxes = []
        for layer in self.layers:
            if remat:
                x = checkpoint(self._block, layer, x, positions, use_reentrant=False,
                               attn_fn=attn_fn, mlp_fn=mlp_fn)
            else:
                x = self._block(layer, x, positions, attn_fn=attn_fn, mlp_fn=mlp_fn)
            if mlp_fn is not None:
                x, aux = x
                auxes.append(aux)
        logits = self._logits(rms_norm(x, self.norm_f, self.cfg.norm_eps))
        return logits if mlp_fn is None else (logits, auxes)

    forward = transformer_forward

    @torch.no_grad()
    def score_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced scoring: [B, S] ids -> [B, S-1] f32 where
        ``out[:, i-1] = log p(t_i | t_<i)`` (completions echo + logprobs).
        One cache-free causal forward, so every layer's attention is the
        flash forward at Sq = Skv = S; causal attention keeps a bucket's
        zero padding invisible to the real positions before it."""
        lps = torch.log_softmax(self.transformer_forward(tokens), dim=-1)
        return torch.gather(lps[:, :-1], 2, tokens[:, 1:, None].long())[..., 0]

    # -- KV-cached ragged-batch serving path ------------------------------------
    def init_cache(self, batch: int, max_seq: Optional[int] = None,
                   dtype: Optional[torch.dtype] = None) -> dict:
        """Zeroed cache [n_layers, B, max_seq, n_kv_heads, head_dim] in
        ``dtype`` (default ``cfg.dtype``; a serving deployment passes its
        MODEL_KV_DTYPE) plus per-request ``lengths`` [B]. ``max_seq`` may
        not exceed the config's (the RoPE table bounds valid positions)."""
        cfg = self.cfg
        max_seq = max_seq or cfg.max_seq
        if max_seq > cfg.max_seq:
            raise ValueError(
                f"cache max_seq {max_seq} exceeds config max_seq {cfg.max_seq} "
                "(RoPE table bound)"
            )
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        dev = self.device
        dtype = dtype or cfg.dtype
        return {
            "k": zeros_kv(shape, dtype, dev),
            "v": zeros_kv(shape, dtype, dev),
            "lengths": torch.zeros(batch, dtype=torch.int32, device=dev),
        }

    def _run_cached(self, tokens: torch.Tensor, cache: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Shared cached forward: ``tokens`` [B, S] starting at each row's
        ``cache['lengths']``. Returns final-norm hidden states [B, S, D] and
        the starts [B]. Query j of row b sees cache positions <= start_b + j
        that were written (kv_lens = start + S)."""
        b, s = tokens.shape
        dev = tokens.device
        starts = cache["lengths"]
        steps = torch.arange(s, device=dev)[None, :]
        positions = torch.clamp(starts[:, None].long() + steps, max=self.cfg.max_seq - 1)
        written = starts + s
        # the cache write index, shared by every layer; the write start
        # clamps so the update fits, as XLA's dynamic_update_slice does
        first = torch.clamp(starts, max=cache["k"].shape[2] - s).long()
        write_at = (torch.arange(b, device=dev)[:, None], first[:, None] + steps)
        x = self._embed(tokens)
        for i, layer in enumerate(self.layers):
            x = self._block(
                layer, x, positions, kv_cache=(cache["k"][i], cache["v"][i]),
                write_at=write_at, starts=starts, kv_lens=written,
            )
        return rms_norm(x, self.norm_f, self.cfg.norm_eps), starts

    def _forward_with_cache(
        self, tokens: torch.Tensor, cache: dict, lengths: Optional[torch.Tensor]
    ) -> tuple[torch.Tensor, dict]:
        b, s = tokens.shape
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        x, starts = self._run_cached(tokens, cache)
        # each row's last REAL position (pad-aware bucketed prefill)
        last = torch.clamp(lengths.long() - 1, 0, s - 1)
        x_last = x[torch.arange(b, device=x.device), last]
        logits = self._logits(x_last)
        return logits, {"k": cache["k"], "v": cache["v"], "lengths": starts + lengths}

    @torch.no_grad()
    def prefill(
        self, tokens: torch.Tensor, cache: dict, lengths: Optional[torch.Tensor] = None
    ) -> tuple[torch.Tensor, dict]:
        """A (possibly padded) prompt bucket [B, S] with true ``lengths``
        [B] -> next-token logits [B, V] and the advanced cache.

        Chunk-resume contract: the call starts at ``cache['lengths']`` and
        attends the whole written window, so feeding a prompt in slices
        gives the same cache contents and final logits as one call."""
        return self._forward_with_cache(tokens, cache, lengths)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        """One step: ``token`` [B, 1] -> logits [B, V] and the cache."""
        return self._forward_with_cache(token, cache, None)

    @torch.no_grad()
    def verify_chunk(self, tokens: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        """Speculative decoding's target verify: ``tokens`` [B, S] (each
        row's pending token, then its drafts) through the same cached
        forward as prefill and decode -> the greedy next token at EVERY
        position [B, S] int32 and the cache advanced by S. Position i's
        argmax is the target's continuation after tokens[:i+1]: the caller
        accepts the longest matching draft prefix and takes the next
        position as the bonus token. Logits are f32, as decode's; the
        products run at [B, S] shapes, so a near-tie bf16 argmax can differ
        from the [B, 1] decode's."""
        s = tokens.shape[1]
        x, starts = self._run_cached(tokens, cache)
        next_ids = torch.argmax(self._logits(x), dim=-1).to(torch.int32)
        return next_ids, {"k": cache["k"], "v": cache["v"], "lengths": starts + s}

    @torch.no_grad()
    def verify_chunk_sampled(
        self,
        tokens: torch.Tensor,
        cache: dict,
        draft_toks: torch.Tensor,
        q: torch.Tensor,
        generator: Optional[torch.Generator],
        temperature: Any,
        top_k: Any = 0,
        top_p: Any = 1.0,
        min_p: Any = 0.0,
    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """Speculative SAMPLING's verify: accept draft x with probability
        min(1, p(x)/q(x)); at the first reject resample from the residual
        normalize(max(p - q, 0)); after a full accept draw the bonus from
        p. The emitted sequence is distributed exactly as sampling the
        target's warped p, whatever the draft proposes.

        ``tokens`` [B, k] is the pending token + k-1 drafts;
        ``draft_toks`` [B, k-1] and ``q`` [B, k-1, V] are the draft's
        choices and the warped distributions it drew them from (the same
        knobs). The uniforms and the Gumbel noise come from ``generator``.
        Returns (emitted [B, k] int32, n_acc [B] int32, the cache):
        emitted[:, j] for j < n_acc are accepted drafts, emitted[:, n_acc]
        the correction or bonus, zeros beyond."""
        b, s = tokens.shape
        x, starts = self._run_cached(tokens, cache)
        logits = self._logits(x)
        v = logits.shape[-1]
        p = warped_probs(logits.reshape(b * s, v), temperature, top_k, top_p, min_p)
        u, noise = _spec_draws(generator, b, s - 1, v, logits.device)
        emitted, n_acc = speculative_accept(p.reshape(b, s, v), q, draft_toks, u, noise)
        return emitted, n_acc, {"k": cache["k"], "v": cache["v"], "lengths": starts + s}

    @torch.no_grad()
    def draft_chunk_sampled(
        self,
        token: torch.Tensor,
        cache: dict,
        n_steps: int,
        generator: Optional[torch.Generator],
        temperature: Any,
        top_k: Any = 0,
        top_p: Any = 1.0,
        min_p: Any = 0.0,
    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """The draft's proposal for speculative sampling: ``n_steps``
        sampled steps from ``token`` [B, 1] that also return the warped
        distribution of each step -> (tokens [B, n_steps] int32, q
        [B, n_steps, V] f32, the cache). Each draw is a Gumbel-max sample
        of q, as ``jax.random.categorical`` draws."""
        toks, qs = [], []
        for _ in range(n_steps):
            logits, cache = self.decode_step(token, cache)
            qrow = warped_probs(logits, temperature, top_k, top_p, min_p)
            noise = _gumbel(generator, qrow.shape, qrow.device)
            token = torch.argmax(torch.log(qrow + 1e-30) + noise, dim=-1).to(torch.int32)[:, None]
            toks.append(token[:, 0])
            qs.append(qrow)
        return torch.stack(toks, 1), torch.stack(qs, 1), cache

    @torch.no_grad()
    def decode_chunk_pool(
        self,
        token: torch.Tensor,
        cache: dict,
        n_steps: int,
        generator: Optional[torch.Generator] = None,
        temperature: Any = 0.0,
        top_k: Any = 0,
        top_p: Any = 1.0,
        min_p: Any = 0.0,
        all_greedy: Optional[bool] = None,
    ) -> tuple:
        """The decode chunk of the pool and of solo decode (B = 1):
        ``n_steps`` autoregressive steps with PER-ROW sampling knobs ([B]
        tensors or scalars; a scalar temperature of 0 is greedy) from one
        device ``generator``, no host sync between steps. ``token`` [B, 1]
        is the last known token. ``all_greedy`` (known on the host) skips
        the sampling sort. The chosen tokens' RAW logprobs and the
        top-``TOP_LOGPROBS`` alternatives ride every step. Returns
        (tokens [B, n_steps] int32, logprobs [B, n_steps] f32, top values
        [B, n_steps, TOP_LOGPROBS] f32, top ids [B, n_steps, TOP_LOGPROBS]
        int32, the feed-forward token [B, 1] int32, the cache)."""
        return self._decode_chunk(
            token, cache, n_steps, generator, (temperature, top_k, top_p, min_p), all_greedy
        )

    @torch.no_grad()
    def decode_chunk_pool_penalized(
        self,
        token: torch.Tensor,
        cache: dict,
        n_steps: int,
        generator: Optional[torch.Generator],
        temperature: Any,
        top_k: Any,
        top_p: Any,
        min_p: Any,
        presence: torch.Tensor,
        rep: Any,
        counts: torch.Tensor,
        presence_penalty: Any,
        frequency_penalty: Any,
        bias: torch.Tensor,
        all_greedy: Optional[bool] = None,
    ) -> tuple:
        """``decode_chunk_pool`` with PER-ROW penalty state: ``presence``
        [B, V] bool (prompt and generated ids), ``counts`` [B, V] f32
        (generated ids), ``bias`` [B, V] f32, and the knobs ``rep``,
        ``presence_penalty``, ``frequency_penalty`` ([B] tensors or
        scalars). Rows without penalties carry identity knobs (rep 1,
        penalties 0, a zero bias row) and sample exactly as the plain chunk
        does. The logprobs stay the RAW model's (log-softmax of the
        unpenalized logits). ``presence`` and ``counts`` advance in place
        with every sampled id. Returns ``decode_chunk_pool``'s tuple plus
        (presence, counts)."""
        penalty = (presence, _col(rep), counts, _col(presence_penalty),
                   _col(frequency_penalty), bias)
        out = self._decode_chunk(
            token, cache, n_steps, generator, (temperature, top_k, top_p, min_p), all_greedy,
            penalty,
        )
        return (*out, presence, counts)

    @torch.no_grad()
    def decode_chunk_pool_lora(
        self,
        adapter_ids: torch.Tensor,
        token: torch.Tensor,
        cache: dict,
        n_steps: int,
        generator: Optional[torch.Generator] = None,
        temperature: Any = 0.0,
        top_k: Any = 0,
        top_p: Any = 1.0,
        min_p: Any = 0.0,
        all_greedy: Optional[bool] = None,
    ) -> tuple:
        """``decode_chunk_pool`` with PER-SLOT LoRA adapter selection, on a
        ``build_lora_stack`` model (the shared base with a stacked adapter
        bank on every targeted weight): ``adapter_ids`` [B] int picks each
        slot's adapter (0 = the zero adapter: a base row's delta is exactly
        zero). The ids are fixed for the chunk, so each slot's A, B and
        scale are gathered once (``attach_lora_ids``), not once a step.
        Same outputs as ``decode_chunk_pool``."""
        from gofr_tpu_torch.models.lora import attach_lora_ids

        return attach_lora_ids(self, adapter_ids).decode_chunk_pool(
            token, cache, n_steps, generator, temperature, top_k, top_p, min_p, all_greedy
        )

    def _decode_chunk(self, token: torch.Tensor, cache: dict, n_steps: int,
                      generator: Optional[torch.Generator], knobs: tuple,
                      all_greedy: Optional[bool], penalty: Optional[tuple] = None) -> tuple:
        toks, lps, tvals, tids = [], [], [], []
        for _ in range(n_steps):
            logits, cache = self.decode_step(token, cache)
            scored = logits
            if penalty is not None:
                presence, rep, counts, pp, fp, bias = penalty
                scored = apply_penalties(logits, presence, rep, counts, pp, fp, bias)
            nxt = sample_logits_rows(scored, generator, *knobs, all_greedy=all_greedy)
            lp, tv, ti = _lp_outputs(logits, nxt)
            if penalty is not None:
                update_presence(presence, nxt)
                update_counts(counts, nxt)
            token = nxt.to(torch.int32)[:, None]
            toks.append(token[:, 0])
            lps.append(lp)
            tvals.append(tv)
            tids.append(ti)
        return (torch.stack(toks, 1), torch.stack(lps, 1), torch.stack(tvals, 1),
                torch.stack(tids, 1), token, cache)


def _gumbel(generator: Optional[torch.Generator], shape: tuple,
            device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform in [tiny, 1), f32."""
    u = torch.rand(shape, generator=generator, device=device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _spec_draws(generator: Optional[torch.Generator], b: int, n_drafts: int, v: int,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A sampled verify's randomness: the accept tests' uniforms [B, k-1]
    and the correction draw's Gumbel noise [B, V]."""
    u = torch.rand((b, n_drafts), generator=generator, device=device)
    return u, _gumbel(generator, (b, v), device)


def speculative_accept(p: torch.Tensor, q: torch.Tensor, draft_toks: torch.Tensor,
                       u: torch.Tensor, noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The accept test and the residual resample of speculative sampling,
    as ``gofr_tpu/models/transformer.py::verify_chunk_sampled`` computes
    them. ``p`` [B, k, V] is the target's warped distribution at each
    verified position, ``q`` [B, k-1, V] the draft's, ``draft_toks``
    [B, k-1], ``u`` [B, k-1] uniforms, ``noise`` [B, V] Gumbel noise ->
    (emitted [B, k] int32, n_acc [B] int32). Draft j is accepted while
    u_j q(x_j) < p(x_j); the correction is a Gumbel-max draw from the
    residual at the first reject (q padded with a zero row, so after a
    full accept the residual is p itself, the bonus distribution)."""
    b, s, v = p.shape
    k_drafts = s - 1
    d = draft_toks.long()[..., None]
    px = torch.gather(p[:, :k_drafts], 2, d)[..., 0]
    qx = torch.gather(q, 2, d)[..., 0]
    acc = (u * qx < px).to(torch.int32)
    n_acc = torch.cumprod(acc, dim=1).sum(dim=1).to(torch.int32)  # [B], <= k-1
    idx = n_acc.long()[:, None, None].expand(b, 1, v)
    p_at = torch.gather(p, 1, idx)[:, 0]
    q_at = torch.gather(F.pad(q, (0, 0, 0, 1)), 1, idx)[:, 0]
    resid = torch.clamp(p_at - q_at, min=0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    # p <= q pointwise means no rejection: only float dust reaches here
    dist = torch.where(mass > 1e-9, resid / torch.clamp(mass, min=1e-9), p_at)
    corr = torch.argmax(torch.log(dist + 1e-30) + noise, dim=-1).to(torch.int32)
    pos = torch.arange(s, device=p.device)[None, :]
    draft_pad = F.pad(draft_toks.to(torch.int32), (0, 1))
    n = n_acc[:, None]
    emitted = torch.where(pos < n, draft_pad,
                          torch.where(pos == n, corr[:, None], torch.zeros_like(draft_pad)))
    return emitted, n_acc


def _col(knob: Any) -> Any:
    """A per-row knob as a [B, 1] column; a scalar stays one."""
    return knob.reshape(-1, 1) if isinstance(knob, torch.Tensor) else knob


TOP_LOGPROBS = 5  # OpenAI's completions cap; computed in every pool chunk


def _chosen_logprobs(logits: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """[B] f32 RAW log-probabilities of the chosen tokens: log-softmax of
    the unpenalized logits, the one logprob convention of every decode
    path."""
    lps = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lps, 1, nxt.long()[:, None])[:, 0]


def _lp_outputs(
    logits: torch.Tensor, nxt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(chosen lp [B], top-k values [B, TOP_LOGPROBS] f32, top-k ids
    [B, TOP_LOGPROBS] int32) from one shared log-softmax."""
    lps = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(lps, 1, nxt.long()[:, None])[:, 0]
    tvals, tids = torch.topk(lps, TOP_LOGPROBS, dim=-1)
    return chosen, tvals, tids.to(torch.int32)
