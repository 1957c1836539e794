"""LoRA adapters: low-rank deltas on the matmul weights.

Port of ``gofr_tpu/models/lora.py``. The JAX package wraps a weight as a
tree leaf ``{"w", "lora_a", "lora_b", "lora_scale"}``; the port holds
weights in modules, so a wrapped weight is a :class:`LoraWeight` whose
``w`` is the base model's own Parameter or :class:`~gofr_tpu_torch.models.
quant.Pack` (never a copy: n adapters cost n x adapter bytes) beside
``lora_a`` [in, r], ``lora_b`` [r, out] and an f32 ``lora_scale`` [1, 1]
(alpha / r). A LoRA model is ``Transformer.with_weights`` over the base:
it shares every base tensor and serves through the same forwards, where
``quant.mm`` dispatches a wrapped weight here. The base may be quantized
(int8 or int4: QLoRA, a frozen packed base under bf16 adapters).

- ``lora_mm``: the base product through ``mm``, plus ``((x @ A) @ B)`` in
  x's dtype (promoted with the adapter's), times the f32 scale, cast to
  the product's dtype, as the JAX package orders it.
- The pooled bank (``build_lora_stack``, :class:`LoraStack`): each targeted
  weight holds ``[A, in, r]`` / ``[A, r, out]`` / ``[A, 1, 1]`` stacks over
  one base, index 0 the zero adapter (a base row's delta is exactly zero),
  adapter i at index i + 1. ``attach_lora_ids`` gathers each row's entries
  for a chunk (:class:`LoraRows`; the ids are fixed for the chunk, so the
  gather runs once, not once a step) and ``plora_mm`` runs the per-row
  batched products.
- Training: the optimizer sees the adapters alone (``split_lora``,
  ``init_lora_train_state``, ``make_lora_train_step``; ``lora_mask`` and
  ``lora_optimizer`` for a step over every parameter), so the base stays
  frozen and holds no optimizer state; autograd reaches each layer's input
  through the frozen products (the flash backward kernels on the card).
- ``export_adapter`` gives a self-contained artifact ``{"adapters",
  "scales"}``, the JAX package's tree with layer weights stacked
  ``[n_layers, ...]``, which ``training/checkpoint.py::save_params``
  writes and ``apply_adapter`` attaches to any base of the same shapes;
  ``merge_lora`` folds the deltas into a dense model.

A fresh adapter (``add_lora``: A scaled-normal, B zeros) is an exact
identity until training moves B.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import torch
from torch import nn

from gofr_tpu_torch.models.quant import (
    _QUANT_KEYS,
    Pack,
    dequantize_pack,
    is_quantized_w8a8,
    mm,
    moe_skip_keys,
)
from gofr_tpu_torch.models.transformer import _LAYER_SHAPES, Transformer, layer_shapes

# the weight names eligible for adapters: the quant keys, lm_head included
_LORA_KEYS = frozenset(_QUANT_KEYS)


def _param(t: torch.Tensor) -> nn.Parameter:
    return t if isinstance(t, nn.Parameter) else nn.Parameter(t, requires_grad=False)


class LoraWeight(nn.Module):
    """A wrapped weight: the base ``w`` (the base model's own object) and
    its adapter."""

    def __init__(self, w: Any, lora_a: torch.Tensor, lora_b: torch.Tensor,
                 lora_scale: torch.Tensor):
        super().__init__()
        self.w = w
        self.lora_a = _param(lora_a)
        self.lora_b = _param(lora_b)
        self.register_buffer("lora_scale", lora_scale)

    @property
    def rank(self) -> int:
        return int(self.lora_a.shape[-1])


class LoraStack(nn.Module):
    """A pooled bank entry: the base ``w`` and every adapter's A, B and
    scale stacked on a leading adapter axis, index 0 the zero adapter."""

    def __init__(self, w: Any, stack_a: torch.Tensor, stack_b: torch.Tensor,
                 stack_scale: torch.Tensor):
        super().__init__()
        self.w = w
        self.register_buffer("lora_stack_a", stack_a)
        self.register_buffer("lora_stack_b", stack_b)
        self.register_buffer("lora_stack_scale", stack_scale)


class LoraRows:
    """One chunk's rows of a bank: each batch row's A [B, in, r], B
    [B, r, out] and scale [B, 1, 1], gathered by ``attach_lora_ids``."""

    __slots__ = ("w", "a", "b", "scale")

    def __init__(self, w: Any, a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor):
        self.w, self.a, self.b, self.scale = w, a, b, scale


def is_lora(leaf: Any) -> bool:
    return isinstance(leaf, LoraWeight)


def is_lora_stack(leaf: Any) -> bool:
    """Whether ``leaf`` is a pooled bank entry (``build_lora_stack``)."""
    return isinstance(leaf, LoraStack)


def _common(x: torch.Tensor, *ts: torch.Tensor) -> tuple:
    """x and the adapter tensors in their promoted dtype (JAX's promotion:
    a bf16 adapter over an f32 model computes in f32)."""
    dtype = torch.promote_types(x.dtype, ts[0].dtype)
    return tuple(t.to(dtype) for t in (x, *ts))


def lora_mm(x: torch.Tensor, w: LoraWeight) -> torch.Tensor:
    """``mm`` for a wrapped weight: the base product (through ``mm``, so a
    packed base keeps its path) plus the low-rank delta."""
    y = mm(x, w.w)
    xc, a, b = _common(x, w.lora_a, w.lora_b)
    delta = (xc @ a) @ b
    return y + (delta * w.lora_scale).to(y.dtype)


def _rows_mm(x: torch.Tensor, rows: LoraRows) -> torch.Tensor:
    """The per-row delta of gathered bank rows: x is [B, ..., in] ([B, S,
    in] through the layers, [B, in] at the last position's lm_head), each
    row against its own A and B (two batched products)."""
    y = mm(x, rows.w)
    n = x.shape[0]
    xc, a, b = _common(x, rows.a, rows.b)
    delta = torch.bmm(torch.bmm(xc.reshape(n, -1, x.shape[-1]), a), b)
    delta = delta.reshape(*x.shape[:-1], b.shape[-1])
    scale = rows.scale.reshape(n, *([1] * (delta.ndim - 1)))
    return y + (delta * scale).to(y.dtype)


def plora_mm(x: torch.Tensor, w: LoraStack, ids: torch.Tensor) -> torch.Tensor:
    """``mm`` for a pooled bank: every batch row selects its adapter by
    ``ids`` [B] (0 = the zero adapter)."""
    return _rows_mm(x, _gather(w, ids.to(device=x.device, dtype=torch.long)))


def _gather(w: LoraStack, ids: torch.Tensor) -> LoraRows:
    return LoraRows(w.w, w.lora_stack_a.index_select(0, ids),
                    w.lora_stack_b.index_select(0, ids), w.lora_stack_scale.index_select(0, ids))


def lora_product(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``quant.mm``'s dispatch for the LoRA weights."""
    if isinstance(w, LoraWeight):
        return lora_mm(x, w)
    if isinstance(w, LoraRows):
        return _rows_mm(x, w)
    if isinstance(w, LoraStack):
        raise ValueError("a pooled adapter bank needs its rows: run decode_chunk_pool_lora")
    raise ValueError(f"unknown weight {type(w).__name__}")


def _weight_shape(w: Any) -> Optional[tuple[int, int]]:
    """(in, out) of a wrappable weight: a dense >= 2-D tensor or a pack."""
    if isinstance(w, Pack):
        return tuple(w.dense_shape[-2:])
    if isinstance(w, torch.Tensor) and w.ndim >= 2:
        return tuple(w.shape[-2:])
    return None


def _targets(model: Transformer, keys: frozenset) -> set:
    """The weight names of ``keys`` that ``model`` holds as matmul
    weights (a MoE block's expert stacks stay dense: moe_skip_keys)."""
    names = {"lm_head"} | set(_LAYER_SHAPES)
    skip = moe_skip_keys(dict(model.layers[0].named_children()))
    return {k for k in names if k in keys and k not in skip}


def _reject_w8a8(model: Transformer) -> None:
    for w in model.modules():
        if isinstance(w, Pack) and is_quantized_w8a8(w.pack):
            raise ValueError(
                "add_lora over a w8a8 base is unsupported: the activation round-to-int8 "
                "has zero gradient, so adapters below the first w8a8 matmul would train "
                "on silent zeros. Train (QLoRA) over an int8/int4 base and re-quantize "
                "w8a8 for deployment."
            )


def add_lora(model: Transformer, seed: int = 0, rank: int = 8, alpha: float = 16.0,
             keys: Optional[Iterable[str]] = None) -> Transformer:
    """Wrap the eligible weights with fresh (identity) adapters: A drawn
    normal times in**-0.5 (from one seeded generator on the model's
    device, weight by weight), B zeros, both bf16, scale alpha / rank in
    f32. Returns a LoRA model over ``model``'s own tensors."""
    _reject_w8a8(model)
    targets = _targets(model, frozenset(keys) if keys is not None else _LORA_KEYS)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)

    def wrap(name: str, _i: Optional[int], w: Any) -> Any:
        shape = _weight_shape(w)
        if name not in targets or shape is None:
            return w
        i, o = shape
        a = torch.randn((i, rank), generator=gen, device=model.device) * (i ** -0.5)
        return LoraWeight(
            w, a.to(torch.bfloat16),
            torch.zeros((rank, o), dtype=torch.bfloat16, device=model.device),
            torch.full((1, 1), alpha / rank, dtype=torch.float32, device=model.device),
        )

    return model.with_weights(wrap)


def wrapped_weights(model: Transformer):
    """(path, layer index or None, LoraWeight) of every wrapped weight, in
    ``named_weights`` order; the path is the JAX tree's (``lm_head``,
    ``layers/wq``)."""
    for i, block in [(None, model)] + list(enumerate(model.layers)):
        for name in ("lm_head",) if i is None else _LAYER_SHAPES:
            w = getattr(block, name)
            if isinstance(w, LoraWeight):
                yield ("lm_head" if i is None else f"layers/{name}"), i, w


def lora_mask(model: Transformer) -> list[bool]:
    """True exactly at adapter parameters (``lora_a`` / ``lora_b``), one
    flag per tensor of ``list(model.parameters())``: the mask for
    ``optim.masked``."""
    ids = {id(t) for _, _, w in wrapped_weights(model) for t in (w.lora_a, w.lora_b)}
    return [id(p) in ids for p in model.parameters()]


def lora_optimizer(inner: Any, model: Transformer) -> Any:
    """Freeze everything but the adapters: ``inner`` updates the adapter
    parameters, every other parameter gets a zero update and no optimizer
    state. Over ``list(model.parameters())``."""
    from gofr_tpu_torch.training import optim

    mask = lora_mask(model)
    return optim.chain(optim.masked(inner, mask),
                       optim.masked(optim.set_to_zero(), [not m for m in mask]))


def split_lora(model: Transformer) -> tuple[list, list]:
    """(adapters, rest): the adapter parameters (each wrapped weight's
    ``lora_a`` then ``lora_b``, in ``wrapped_weights`` order), the
    differentiable set, and every other parameter of the model. Training
    differentiates the adapters alone, which is what makes QLoRA work (a
    pack is no gradient input) and skips the base's gradients."""
    adapters = [t for _, _, w in wrapped_weights(model) for t in (w.lora_a, w.lora_b)]
    ids = {id(t) for t in adapters}
    return adapters, [p for p in model.parameters() if id(p) not in ids]


@torch.no_grad()
def combine_lora(adapters: list, model: Transformer) -> Transformer:
    """Inverse of ``split_lora``: write ``adapters`` (tensors in
    ``split_lora``'s order) into the model's adapter parameters."""
    own, _ = split_lora(model)
    if len(own) != len(adapters):
        raise ValueError(f"{len(adapters)} adapter tensors for {len(own)} adapter parameters")
    for dst, src in zip(own, adapters):
        dst.copy_(src)
    return model


def init_lora_train_state(model: Transformer, optimizer: Any) -> dict:
    """Training state for adapter-only fine-tuning: the adapters turn
    trainable, the base stays frozen, and the optimizer holds moments for
    the adapters alone."""
    adapters, rest = split_lora(model)
    if not adapters:
        raise ValueError("the model holds no adapters: wrap it with add_lora or apply_adapter")
    for p in rest:
        p.requires_grad_(False)
    for p in adapters:
        p.requires_grad_(True)
    return {"model": model, "adapters": adapters, "opt_state": optimizer.init(adapters),
            "step": 0}


def make_lora_train_step(cfg: Any, optimizer: Any, loss_fn: Any = None,
                         remat: bool = True) -> Callable:
    """``step(state, tokens) -> (state, {"loss", "grad_norm", "step"})``
    over the adapters alone (QLoRA-ready: the frozen base may be int8 or
    int4 packs). ``loss_fn(model, tokens, remat=)`` defaults to the
    next-token loss; the adapters update in place."""
    from gofr_tpu_torch.training import optim

    if loss_fn is None:
        from gofr_tpu_torch.training.trainer import cross_entropy_loss

        loss_fn = cross_entropy_loss

    def train_step(state: dict, tokens: Any) -> tuple[dict, dict]:
        model: Transformer = state["model"]
        if model.cfg != cfg:
            raise ValueError("the state's model was built for another config")
        tokens = torch.as_tensor(tokens, device=model.device)
        # bf16 products accumulate in f32, as XLA's do (see models/quant.py)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        loss = loss_fn(model, tokens, remat=remat)
        grads = list(torch.autograd.grad(loss, state["adapters"]))
        grad_norm = optim.global_norm(grads)
        optimizer.update(grads, state["opt_state"], state["adapters"])
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm, "step": state["step"]}

    return train_step


@torch.no_grad()
def export_adapter(state: Any) -> dict:
    """The self-contained artifact of a LoRA train state (or a LoRA
    model): ``{"adapters": {..., {"lora_a", "lora_b"}}, "scales": {...}}``
    in the JAX tree's layout, layer weights stacked [n_layers, ...] (the
    scales ride along: the adapters alone would lose alpha / rank). Saved
    with ``save_params``; ``apply_adapter`` re-attaches it."""
    model = state["model"] if isinstance(state, dict) else state
    adapters: dict = {}
    scales: dict = {}
    grouped: dict = {}
    for path, _, w in wrapped_weights(model):
        grouped.setdefault(path, []).append(w)
    for path, ws in grouped.items():
        if path == "lm_head":
            (w,) = ws
            adapters[path] = {"lora_a": w.lora_a.detach().clone(),
                              "lora_b": w.lora_b.detach().clone()}
            scales[path] = w.lora_scale.clone()
            continue
        key = path.split("/", 1)[1]
        if len(ws) != len(model.layers):
            raise ValueError(f"{path}: {len(ws)} of {len(model.layers)} layers wrapped")
        adapters.setdefault("layers", {})[key] = {
            "lora_a": torch.stack([w.lora_a.detach() for w in ws]),
            "lora_b": torch.stack([w.lora_b.detach() for w in ws]),
        }
        scales.setdefault("layers", {})[key] = torch.stack([w.lora_scale for w in ws])
    return {"adapters": adapters, "scales": scales}


def apply_adapter(base: Transformer, artifact: dict) -> Transformer:
    """Attach an artifact to a base model -> a LoRA model sharing the
    base's tensors (the multi-LoRA serving path). The base may be
    quantized; every shape, stacked layer axis included, must match the
    training base's, or this raises (a wrong-depth adapter fails here)."""
    adapters, scales = artifact["adapters"], artifact["scales"]
    unknown = set(adapters) - {"lm_head", "layers"}
    unknown |= set(adapters.get("layers", {})) - set(_LAYER_SHAPES)
    if unknown:
        raise ValueError(f"adapter targets {sorted(unknown)} are not weights of the model")
    dev = base.device
    leaves: dict = {}
    for path, a, s in ([("lm_head", adapters["lm_head"], scales["lm_head"])]
                       if "lm_head" in adapters else []) + [
            (f"layers/{k}", v, scales["layers"][k]) for k, v in adapters.get("layers", {}).items()]:
        name = path.rsplit("/", 1)[-1]
        lead = () if path == "lm_head" else (base.cfg.n_layers,)
        i, o = (base.cfg.dim, base.cfg.vocab_size) if path == "lm_head" else layer_shapes(
            base.cfg)[name]
        rank = a["lora_a"].shape[-1]
        want_a, want_b = (*lead, i, rank), (*lead, rank, o)
        if tuple(a["lora_a"].shape) != want_a or tuple(a["lora_b"].shape) != want_b:
            raise ValueError(
                f"adapter shapes {tuple(a['lora_a'].shape)} x {tuple(a['lora_b'].shape)} do "
                f"not fit base weight {(*lead, i, o)} (expected {want_a} x {want_b})"
            )
        leaves[path] = (a["lora_a"].to(dev), a["lora_b"].to(dev),
                        torch.as_tensor(s, dtype=torch.float32).to(dev))

    def wrap(name: str, i: Optional[int], w: Any) -> Any:
        leaf = leaves.get("lm_head" if i is None else f"layers/{name}")
        if leaf is None:
            return w
        a, b, s = leaf if i is None else (t[i] for t in leaf)
        return LoraWeight(w, a, b, s.reshape(1, 1))

    if hasattr(base, "with_lora"):  # a sharded base slices the adapter per shard
        return base.with_lora(leaves)
    return base.with_weights(wrap)


def build_lora_stack(base: Transformer, wrapped: "dict[str, Transformer]") -> Transformer:
    """Stack named LoRA models (``apply_adapter`` outputs over ONE shared
    base) into one pooled model for per-slot adapter decode: each targeted
    weight becomes a :class:`LoraStack` over the base weight, index 0 the
    zero adapter and insertion order i at index i + 1. Raises ValueError
    when the adapters disagree on targets or rank (the pool needs one
    uniform bank; such sets serve solo)."""
    models = list(wrapped.values())

    def stack(name: str, i: Optional[int], w: Any) -> Any:
        ws = [getattr(m if i is None else m.layers[i], name) for m in models]
        if not any(isinstance(x, LoraWeight) for x in ws):
            return w
        path = "/lm_head" if i is None else f"/layers/{name}"
        if not all(isinstance(x, LoraWeight) for x in ws):
            raise ValueError(f"adapters disagree on target weight at {path}")
        ranks = {x.rank for x in ws}
        if len(ranks) != 1:
            raise ValueError(f"adapter rank mismatch at {path}: {sorted(ranks)}")
        first = ws[0]
        return LoraStack(
            w,
            torch.stack([torch.zeros_like(first.lora_a)] + [x.lora_a.detach() for x in ws]),
            torch.stack([torch.zeros_like(first.lora_b)] + [x.lora_b.detach() for x in ws]),
            torch.stack([torch.zeros_like(first.lora_scale)] + [x.lora_scale for x in ws]),
        )

    return base.with_weights(stack)


def attach_lora_ids(stacked: Transformer, ids: torch.Tensor) -> Transformer:
    """The bank model with each row's adapter selected by ``ids`` [B]:
    every :class:`LoraStack` becomes the :class:`LoraRows` it gathers (one
    gather a tensor), the rest is shared."""
    ids = ids.to(device=stacked.device, dtype=torch.long)
    return stacked.with_weights(
        lambda _name, _i, w: _gather(w, ids) if isinstance(w, LoraStack) else w
    )


@torch.no_grad()
def merge_lora(model: Transformer, dtype: Optional[torch.dtype] = None) -> Transformer:
    """Fold the adapters into plain weights (serving export): a new dense
    model with ``w + A @ B * scale`` (in f32, then ``dtype``, default the
    config's), built one weight at a time. A quantized base dequantizes
    (to bf16) first: the merged model is dense."""
    import dataclasses

    cfg = model.cfg if dtype is None else dataclasses.replace(model.cfg, dtype=dtype)
    out = Transformer(cfg, model.device)
    for (name, owner), (_, src) in zip(out.named_weights(), model.named_weights()):
        w = getattr(src, name)
        delta = None
        if isinstance(w, LoraWeight):
            delta = (w.lora_a.float() @ w.lora_b.float()) * w.lora_scale
            w = w.w
        # a pack dequantizes to bf16 first and the sum rounds to bf16, as
        # the JAX package's merge does
        packed = isinstance(w, Pack)
        dense = (dequantize_pack(w.pack, torch.bfloat16) if packed else w).float()
        if delta is not None:
            dense = (dense + delta).to(dtype or (torch.bfloat16 if packed else w.dtype))
        out.set_weight(owner, name, dense.to(cfg.dtype))
    return out
