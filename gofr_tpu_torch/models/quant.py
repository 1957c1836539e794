"""Weight quantization for serving, and the matmul entry point of the
model forwards.

Port of ``gofr_tpu/models/quant.py``. Three symmetric schemes, with the JAX
package's numerics (round half to even: ``torch.round`` rounds as
``jnp.round`` does; clip to ±127 or ±7; scales floored at 1e-8):

- **int8, per output channel**: ``w [..., in, out]`` becomes
  ``{"q": int8 [..., in, out], "scale": f32 [..., 1, out]}``;
- **int4, group-wise** (128 input rows per scale, clamped to the reduction
  dim): ``{"q4": uint8 [..., in/2, out], "scale": f32 [..., in/128, out]}``.
  torch has no int4 dtype, so two values share a byte: input row ``2i`` in
  the low nibble, ``2i+1`` in the high one (an int4 model's weight bytes
  are half of int8's, which is why a deployment picks it);
- **w8a8**: the int8 pack under ``q8``, the marker that ``mm`` also
  quantizes the activations per token and runs an int8 x int8 product
  (``torch._int_mm``, int32 sums).

Embeddings and norms stay high precision. Under w8a8 the logits product
(``lm_head``) stays weight-only int8 (``quantizer_for_key``).

``mm`` on an int8 pack keeps the JAX order: the int8 values, cast to
``x.dtype`` (exact), go into one product with f32 sums and an f32 result,
which the per-channel scale multiplies, rounded to ``x.dtype`` on store
(one launch). On an int4 pack it dequantizes the weight into ``x.dtype``
(the unpack and the scale multiply) and runs one ``torch.matmul``; a bf16
product on the card accumulates in f32 once
``allow_bf16_reduced_precision_reduction`` is off, which the serving
device sets. The JAX package's int4 form (one f32 partial per scale group,
then a sum) would hold an [..., in/128, out] f32 tensor: 7.5 GB at a
prefill of 8 x 512 rows through llama3-8b's ``w_gate``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from gofr_tpu_torch.ops.sampling import device_scalar

# weight names eligible for quantization (2-D matmul weights used via mm())
_QUANT_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
               "wqkv", "w_in", "w_out"}

_CLIP = 127.0
_CLIP4 = 7.0
_SCALE_FLOOR = 1e-8

INT4_GROUP = 128  # input rows per int4 scale group
# torch._int_mm on the card needs more than 16 rows, and K and N multiples of 8
_INT_MM_MIN_ROWS = 17


def moe_skip_keys(tree: dict) -> frozenset:
    """Keys a tree walker leaves dense inside a MoE block (its experts
    compute through a batched einsum, not ``mm``)."""
    return (
        frozenset(("w_gate", "w_up", "w_down")) if "router" in tree else frozenset()
    )


def quantize_array(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-output-channel int8 along the reduction axis (second-to-last):
    plain [in, out] weights and stacked [n_layers, in, out] alike."""
    wf = w.float()
    peak = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(peak / device_scalar(_CLIP, wf.device), min=_SCALE_FLOOR)
    q = torch.clamp(torch.round(wf / scale), -_CLIP, _CLIP).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_array(packed: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return _scaled(packed["q"], packed["scale"], dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [..., in, out] with even ``in`` -> uint8
    [..., in/2, out]: row 2i in the low nibble, row 2i+1 in the high."""
    lo = q[..., 0::2, :].to(torch.int16) & 0xF
    hi = (q[..., 1::2, :].to(torch.int16) & 0xF) << 4
    return (lo | hi).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in/2, out] -> int8 [..., in, out], sign-extended."""
    b = packed.view(torch.int8)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(b, 4), 4)
    hi = torch.bitwise_right_shift(b, 4)
    lead, half, out = packed.shape[:-2], packed.shape[-2], packed.shape[-1]
    return torch.stack((lo, hi), dim=-2).reshape(*lead, 2 * half, out)


def quantize_array_int4(w: torch.Tensor, group: int = INT4_GROUP) -> dict[str, torch.Tensor]:
    """Group-wise symmetric int4: ``group`` input rows share one scale per
    output channel. The group clamps to the reduction dim for small
    weights; the dim must divide by the effective group, and be even (two
    values a byte)."""
    wf = w.float()
    i, o = wf.shape[-2], wf.shape[-1]
    group = min(group, i)
    if i % group:
        raise ValueError(
            f"int4 quantization needs the reduction dim ({i}) divisible by "
            f"the scale group ({group})"
        )
    if i % 2:
        raise ValueError(f"int4 packing needs an even reduction dim, got {i}")
    lead = wf.shape[:-2]
    wg = wf.reshape(*lead, i // group, group, o)
    peak = wg.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(peak / device_scalar(_CLIP4, wg.device), min=_SCALE_FLOOR)
    q = torch.clamp(torch.round(wg / scale), -_CLIP4, _CLIP4).to(torch.int8)
    return {"q4": pack_int4(q.reshape(*lead, i, o)), "scale": scale[..., 0, :]}


def dequantize_array_int4(packed: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    q = unpack_int4(packed["q4"])
    scale = packed["scale"]
    i, o = q.shape[-2], q.shape[-1]
    lead = q.shape[:-2]
    n = scale.shape[-2]
    wg = q.reshape(*lead, n, i // n, o)
    return _scaled(wg, scale[..., :, None, :], dtype).reshape(*lead, i, o)


def quantize_array_w8a8(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """The int8 pack under ``q8``: ``mm`` then also quantizes the
    activations (serving only: the activation rounding has no gradient)."""
    packed = quantize_array(w)
    return {"q8": packed["q"], "scale": packed["scale"]}


def dequantize_array_w8a8(packed: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return _scaled(packed["q8"], packed["scale"], dtype)


def _scaled(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(q.float() * scale).to(dtype)`` in ONE elementwise launch: the
    product runs in f32 and is rounded on store (the JAX dequantize's
    numerics), with no f32 copy of the weight."""
    out = torch.empty(torch.broadcast_shapes(q.shape, scale.shape), dtype=dtype,
                      device=q.device)
    return torch.mul(q, scale, out=out)


def quantize_act_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8: each row gets one absmax scale
    over the feature axis. -> (q [..., d] int8, scale [..., 1] f32)."""
    xf = x.float()
    peak = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(peak / device_scalar(_CLIP, xf.device), min=_SCALE_FLOOR)
    q = torch.clamp(torch.round(xf / scale), -_CLIP, _CLIP).to(torch.int8)
    return q, scale


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


def is_quantized_int4(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q4", "scale"}


def is_quantized_w8a8(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q8", "scale"}


def empty_pack(mode: Any, key: str, shape: tuple, device: "torch.device | str") -> dict:
    """Uninitialized pack tensors for the dense [..., in, out] ``shape`` of
    weight ``key`` under ``mode`` (what a loader fills, one weight at a
    time)."""
    fn = quantizer_for_key(mode, key)
    *lead, i, o = shape
    if fn is quantize_array_int4:
        g = min(INT4_GROUP, i)
        return {"q4": torch.empty((*lead, i // 2, o), dtype=torch.uint8, device=device),
                "scale": torch.empty((*lead, i // g, o), dtype=torch.float32, device=device)}
    name = "q8" if fn is quantize_array_w8a8 else "q"
    return {name: torch.empty((*lead, i, o), dtype=torch.int8, device=device),
            "scale": torch.empty((*lead, 1, o), dtype=torch.float32, device=device)}


class Pack(nn.Module):
    """A quantized weight inside a model: its pack's tensors as buffers
    (not trainable parameters), so ``state_dict`` and ``.to`` carry them.
    ``pack`` is the dict ``mm`` reads."""

    def __init__(self, pack: dict):
        super().__init__()
        self.names = tuple(sorted(pack))
        for name, t in pack.items():
            self.register_buffer(name, t)

    @property
    def pack(self) -> dict:
        return {name: getattr(self, name) for name in self.names}

    @property
    def dense_shape(self) -> tuple:
        """The [..., in, out] shape of the weight this pack stands for."""
        q = getattr(self, self.names[0])
        rows = 2 * q.shape[-2] if self.names[0] == "q4" else q.shape[-2]
        return (*q.shape[:-2], rows, q.shape[-1])

    @torch.no_grad()
    def load(self, pack: dict) -> None:
        """Copy a pack of the same kind and shapes into this one."""
        if tuple(sorted(pack)) != self.names:
            raise ValueError(f"pack keys {sorted(pack)} do not fit {list(self.names)}")
        for name in self.names:
            dst, src = getattr(self, name), pack[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"pack {name!r} shape {tuple(src.shape)} does not fit {tuple(dst.shape)}"
                )
            dst.copy_(src)


def mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Quant-aware matmul: ``w`` is a plain [in, out] tensor, a pack dict,
    a :class:`Pack`, or a LoRA weight of ``models/lora.py`` (a wrapped
    weight, a pooled bank, or a bank's rows gathered for one chunk), which
    runs its base product through this function and adds its delta. Dense
    and weight-only products accumulate in f32 and return ``x.dtype``;
    w8a8 accumulates int32. Differentiable in ``x`` (a frozen pack never
    gets a gradient: QLoRA trains adapters over it)."""
    if isinstance(w, torch.Tensor):
        return torch.matmul(x, w)
    if isinstance(w, Pack):
        w = w.pack
    elif not isinstance(w, dict):
        from gofr_tpu_torch.models.lora import lora_product

        return lora_product(x, w)
    if is_quantized(w):
        if torch.is_grad_enabled() and x.requires_grad:
            return _Int8Product.apply(x, w["q"], w["scale"])
        return _scaled(_matmul_f32(x, w["q"].to(x.dtype)), w["scale"], x.dtype)
    if is_quantized_int4(w):
        return torch.matmul(x, dequantize_array_int4(w, x.dtype))
    if is_quantized_w8a8(w):
        return _mm_w8a8(x, w)
    raise ValueError(f"unknown weight pack with keys {sorted(w)}")


class _Int8Product(torch.autograd.Function):
    """The int8 weight-only product with a gradient for ``x`` alone: the
    forward is ``mm``'s (f32 sums, scaled, rounded to ``x.dtype``); the
    backward scales the cotangent by the per-channel scale in f32 and
    multiplies it by the transposed int8 values in ``x.dtype``. The pack
    is a frozen buffer and gets none."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, scale)
        return _scaled(_matmul_f32(x, q.to(x.dtype)), scale, x.dtype)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple:
        q, scale = ctx.saved_tensors
        g = (grad.float() * scale).to(grad.dtype)
        return torch.matmul(g, q.to(grad.dtype).transpose(-1, -2)), None, None


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 sums and an f32 result (the JAX dot's
    ``preferred_element_type``). On the card a bf16 product writes f32
    through ``torch.mm(..., out_dtype=)``; on the CPU the operands are cast
    to f32, where a bf16 activation times an int8 value is exact."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.device.type == "cpu":
        return torch.matmul(x.float(), w.float())
    rows = x.reshape(-1, x.shape[-1])
    y = torch.mm(rows, w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _mm_w8a8(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Per-token int8 activations times the int8 weight through
    ``torch._int_mm`` (int32 sums), rescaled in the JAX order
    ``y.float() * sx * scale``. The card's ``_int_mm`` needs more than 16
    rows: decode's few rows are padded with zero rows, never sent to a
    float path."""
    q8, scale = w["q8"], w["scale"]
    qx, sx = quantize_act_rows(x)
    lead, k = x.shape[:-1], x.shape[-1]
    rows = qx.reshape(-1, k)
    m = rows.shape[0]
    if x.device.type == "cuda" and m < _INT_MM_MIN_ROWS:
        rows = torch.cat([rows, rows.new_zeros(_INT_MM_MIN_ROWS - m, k)])
    y = torch._int_mm(rows, q8)[:m].reshape(*lead, q8.shape[-1])
    return (y.float() * sx * scale.reshape(1, -1)).to(x.dtype)


def quantizer_for(mode: Any) -> Optional[Callable]:
    """A MODEL_QUANT value -> the per-array quantizer: True or "int8",
    "int4", "w8a8"; ""/None/False -> None. Unknown values raise, at
    config time."""
    if mode in ("int8", True):
        return quantize_array
    if mode == "int4":
        return quantize_array_int4
    if mode == "w8a8":
        return quantize_array_w8a8
    if mode in ("", None, False):
        return None
    raise ValueError(f"MODEL_QUANT '{mode}' not supported — use int8, int4, or w8a8")


def quantizer_for_key(mode: Any, key: str) -> Optional[Callable]:
    """Key-aware quantizer, the one home of the w8a8 ``lm_head``
    carve-out: under w8a8 the logits product stays weight-only int8, so
    per-token activation noise cannot flip an argmax. Every walker that
    quantizes a named weight (``quantize_params``, the checkpoint loader,
    the model init) resolves its quantizer here."""
    fn = quantizer_for(mode)
    if fn is None:
        return None
    if mode == "w8a8" and key == "lm_head":
        return quantize_array
    return fn


def quantize_params(params: Any, mode: Any = "int8") -> Any:
    """Quantize every eligible weight of a parameter tree (nested dicts of
    tensors; stacked [n_layers, in, out] weights per layer slice by the
    axis=-2 convention), or of a model (``Transformer.quantized``: a new
    model that holds packs, built one weight at a time)."""
    if isinstance(params, nn.Module):
        return params.quantized(mode)
    if quantizer_for(mode) is None:
        return params

    def walk(tree: Any) -> Any:
        if not isinstance(tree, dict):
            return tree
        skip = moe_skip_keys(tree)
        out = {}
        for key, value in tree.items():
            if (key in _QUANT_KEYS and key not in skip and isinstance(value, torch.Tensor)
                    and value.ndim >= 2):
                out[key] = quantizer_for_key(mode, key)(value)
            else:
                out[key] = walk(value)
        return out

    return walk(params)


def dequantize_pack(pack: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if is_quantized(pack):
        return dequantize_array(pack, dtype)
    if is_quantized_int4(pack):
        return dequantize_array_int4(pack, dtype)
    if is_quantized_w8a8(pack):
        return dequantize_array_w8a8(pack, dtype)
    raise ValueError(f"unknown weight pack with keys {sorted(pack)}")


def dequantize_params(params: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Packs back to dense ``dtype`` arrays, in a tree or a model
    (``Transformer.dequantized``)."""
    if isinstance(params, nn.Module):
        return params.dequantized(dtype)

    def walk(tree: Any) -> Any:
        if is_quantized(tree) or is_quantized_int4(tree) or is_quantized_w8a8(tree):
            return dequantize_pack(tree, dtype)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree

    return walk(params)


def quantization_error(w: torch.Tensor) -> float:
    """Relative RMS error of int8 quantize -> dequantize (diagnostics)."""
    back = dequantize_array(quantize_array(w), torch.float32)
    wf = w.float()
    return float(torch.sqrt(torch.mean((wf - back) ** 2))
                 / (torch.sqrt(torch.mean(wf ** 2)) + 1e-12))
