"""The sharded decoder of the serving mesh.

The JAX package serves a mesh from one process: GSPMD partitions the
jitted forward over the chips and inserts the collectives. The port does
the same by hand. :class:`ShardedTransformer` is a ``Transformer`` whose
weights, KV caches and forwards are spread over a :class:`~gofr_tpu_torch.
parallel.mesh.Mesh`:

- **tp**: each of the ``tp`` shards holds n_heads/tp query heads,
  n_kv_heads/tp KV heads (contiguous, so query head h still reads KV head
  h // group) and hidden_dim/tp of the MLP; the embedding's hidden axis and
  ``lm_head``'s vocabulary axis split too (``parallel/sharding.py``). A
  layer runs each shard's attention half, the reduce of the row-parallel
  ``wo`` products (``quant.row_parallel_mm``: the shards' partials summed in
  shard order), the residual; then each shard's MLP half, the reduce of
  ``w_down``, the residual. The logits gather their vocabulary shards:
  sampling needs the whole row.
- **dp / fsdp**: the rows of a batch split over the dp x fsdp row groups
  (when they divide it; a batch they do not divide, such as one request's
  row, runs on group 0), each group a tp replica on its own devices; under
  fsdp each device holds 1/fsdp of its tp shard's weights, and a layer
  gathers the pieces onto the device before use. Both only place data.

Each shard's weights and KV live on its device; the residual stream, the
caches' ``lengths`` and the logits on the group's first device and the
mesh's first (``device``), where the pool and the runner keep their
per-row state. A device may repeat in the mesh (the CPU; two shards on one
card): the moves between shards are then no-ops.

The same placement trains (``training/trainer.py::place_train_state``):
the weights turn trainable, :meth:`ShardedTransformer.train_logits` splits
a batch over the row groups strictly (a batch they do not divide raises,
as JAX's jit over ``batch_spec()`` does), and autograd carries the
collectives: the gradient of an fsdp gather is each piece's share (the
reduce-scatter), a row-parallel reduce's flows back to every shard, and
the copies of a block (a dp replica's, a norm's on each tp shard) each get
their own rows' part, which the trainer sums (the all-reduce).
:meth:`ShardedTransformer.leaves` names each logical weight with its
blocks, and :meth:`ShardedTransformer.unshard` gathers the unsharded
model back.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gofr_tpu_torch.models.lora import LoraWeight
from gofr_tpu_torch.models.quant import Pack, mm, row_parallel_mm
from gofr_tpu_torch.models.transformer import _LAYER_SHAPES, Block, Transformer
from gofr_tpu_torch.ops.attention import zeros_kv
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.parallel.mesh import Mesh, mesh_axes
from gofr_tpu_torch.parallel.sharding import (
    ShardedKV,
    block_index,
    device_coords,
    param_specs,
    place,
    shard_tensor,
    unshard_tensor,
)

_NORMS = ("attn_norm", "mlp_norm")


def _deferred(x: torch.Tensor, w: Any) -> tuple:
    """A half's row-parallel product, handed to the reduce unrun."""
    return x, w


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _leaf_names(n_layers: int) -> list[tuple[str, Optional[int]]]:
    """(name, layer index or None) of every weight, in the order of
    ``Transformer.parameters()``."""
    return ([(name, None) for name in ("embed", "norm_f", "lm_head")]
            + [(name, li) for li in range(n_layers) for name in (*_NORMS, *_LAYER_SHAPES)])


def release_storage(w: Any) -> None:
    """Free a placed weight's (or moment's) unsharded storage in place:
    what holds it keeps an empty tensor."""
    for t in (w.pack.values() if isinstance(w, Pack) else (w,)):
        t.data = torch.empty(0, dtype=t.dtype, device=t.device)


def _place_weight(name: str, w: Any, spec: Any, mesh: Mesh, coords: dict,
                  device: torch.device) -> Any:
    """The block of weight ``name`` the device at ``coords`` holds."""
    try:
        if isinstance(w, Pack):
            return Pack({k: place(shard_tensor(t, spec[k], mesh, coords), device)
                         for k, t in w.pack.items()})
        return _param(place(shard_tensor(w, spec, mesh, coords), device))
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None


def _gather(pieces: list, spec: Any, own: int, device: torch.device) -> Any:
    """Weight pieces of the fsdp axis -> the whole tp-shard weight on
    ``device`` (an axis the spec splits over fsdp concatenates; a piece
    that does not split takes the device's own)."""
    if isinstance(pieces[0], Pack):
        return Pack({k: _gather([p.pack[k] for p in pieces], spec[k], own, device)
                     for k in pieces[0].names})
    dim = next((d for d, entry in enumerate(spec) if entry == "fsdp"), None)
    if dim is None:
        return pieces[own]
    return torch.cat([p.to(device) for p in pieces], dim)


class _Shard(nn.Module):
    """One device's weights: its blocks of every weight."""


def _empty_block() -> Block:
    block = Block.__new__(Block)
    nn.Module.__init__(block)
    return block


class ShardedTransformer(Transformer):
    """A ``Transformer`` placed over ``mesh`` (dp, fsdp and tp; the other
    axes must be 1). Build it from an unsharded model with
    :meth:`from_model`: each weight, packs included, is sharded whole (a
    pack is split after the whole weight was quantized, so its scales are
    the unsharded ones). It serves every entry point of ``Transformer``:
    prefill, decode, the pool's chunks (penalized too), the verifies,
    scoring and the paged row copies, through the sharded caches of
    :meth:`init_cache`."""

    def __init__(self, cfg: Any, quant: Any, mesh: Mesh, stores: list, specs: dict,
                 freqs: torch.Tensor):
        nn.Module.__init__(self)
        self.cfg, self.quant, self.mesh = cfg, quant, mesh
        shape = mesh.shape
        extra = {a: s for a, s in shape.items() if a not in ("dp", "fsdp", "tp") and s > 1}
        if extra:
            raise ValueError(f"a serving mesh places over dp, fsdp and tp, got {extra}")
        self.tp, self.fsdp = shape["tp"], shape["fsdp"]
        self.n_groups = shape["dp"] * shape["fsdp"]
        self.stores = nn.ModuleList(stores)
        self._specs = specs
        self.register_buffer("freqs", freqs, persistent=False)
        self._freqs_by_device: dict = {freqs.device: freqs}

    @classmethod
    @torch.no_grad()
    def from_model(cls, model: Transformer, mesh: Mesh,
                   release: bool = False) -> "ShardedTransformer":
        """``model`` placed over ``mesh``, one weight at a time. With
        ``release`` each unsharded weight's storage is freed once its blocks
        are placed (``model`` is then spent), so the card never holds two
        copies of the model."""
        cfg = model.cfg
        tp = mesh.shape["tp"]
        for what, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                        ("hidden_dim", cfg.hidden_dim)):
            if n % tp:
                raise ValueError(f"{what}={n} not divisible by tp={tp}")
        layer0 = model.layers[0]
        specs = {name: param_specs(getattr(model, name), name)
                 for name in ("embed", "norm_f", "lm_head")}
        specs.update({name: param_specs(getattr(layer0, name), name)
                      for name in (*_NORMS, *_LAYER_SHAPES)})
        coords = device_coords(mesh)
        stores = [_Shard() for _ in mesh.devices]
        blocks = [[_empty_block() for _ in model.layers] for _ in mesh.devices]
        freqs = model.freqs.to(mesh.devices[0])
        for name, li in _leaf_names(cfg.n_layers):
            w = getattr(model if li is None else model.layers[li], name)
            for store, own, c, device in zip(stores, blocks, coords, mesh.devices):
                setattr(store if li is None else own[li], name,
                        _place_weight(name, w, specs[name], mesh, c, device))
            if release:
                release_storage(w)
        for store, own in zip(stores, blocks):
            store.layers = nn.ModuleList(own)
        return cls(cfg, model.quant, mesh, stores, specs, freqs)

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    @property
    def mesh_axes(self) -> Optional[dict]:
        return mesh_axes(self.mesh)

    def weight_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self.stores.parameters(), *self.stores.buffers()))

    def with_weights(self, wrap: Any) -> "Transformer":
        raise NotImplementedError(
            "a pooled adapter bank does not shard: adapters decode solo under a serving mesh"
        )

    # -- placement ------------------------------------------------------------
    def _dev(self, gid: int, t: int) -> torch.device:
        return self.mesh.devices[gid * self.tp + t]

    def _store(self, gid: int, t: int) -> _Shard:
        return self.stores[gid * self.tp + t]

    def _groups_for(self, rows: int) -> list[tuple[int, int, int]]:
        """(group, first row, end row): the rows split over the row groups
        when they divide them, else all on group 0."""
        g = self.n_groups
        if g > 1 and rows % g == 0:
            n = rows // g
            return [(gid, gid * n, (gid + 1) * n) for gid in range(g)]
        return [(0, 0, rows)]

    def _freqs_on(self, device: torch.device) -> torch.Tensor:
        freqs = self._freqs_by_device.get(device)
        if freqs is None:
            freqs = self._freqs_by_device[device] = self.freqs.to(device)
        return freqs

    def _weight(self, gid: int, t: int, name: str, li: Optional[int] = None) -> Any:
        """Weight ``name`` (of layer ``li``) of shard ``t`` in group ``gid``
        on its device: the store's block, or under fsdp its pieces gathered
        from the devices of the group's dp replica."""
        def of(store: _Shard) -> Any:
            return getattr(store if li is None else store.layers[li], name)

        if self.fsdp == 1:
            return of(self._store(gid, t))
        first = gid - gid % self.fsdp
        pieces = [of(self._store(first + j, t)) for j in range(self.fsdp)]
        return _gather(pieces, self._specs[name], gid % self.fsdp, self._dev(gid, t))

    # -- training ----------------------------------------------------------------
    def leaves(self) -> list[tuple[str, Optional[int], Any, list]]:
        """(name, layer index or None, spec, blocks) of every logical weight,
        in ``Transformer.parameters()`` order; ``blocks`` holds one tensor a
        device, in ``mesh.devices`` order."""
        return [(name, li, self._specs[name],
                 [getattr(store if li is None else store.layers[li], name)
                  for store in self.stores])
                for name, li in _leaf_names(self.cfg.n_layers)]

    def copies(self, spec: Any) -> list[list[int]]:
        """The devices (indices into ``mesh.devices``) holding each distinct
        block of a weight under ``spec``, first copy first."""
        groups: dict = {}
        for i, coords in enumerate(device_coords(self.mesh)):
            groups.setdefault(block_index(spec, self.mesh, coords), []).append(i)
        return list(groups.values())

    @torch.no_grad()
    def unshard(self, device: "torch.device | str" = "cpu") -> Transformer:
        """The unsharded model on ``device``: each weight reassembled from
        its blocks (the first copy of each), bit for bit."""
        if self.quant is not None:
            raise NotImplementedError("unshard gathers dense weights; this model is quantized")
        out = Transformer(self.cfg, device)
        for name, li, spec, blocks in self.leaves():
            target = getattr(out if li is None else out.layers[li], name)
            target.copy_(unshard_tensor(blocks, spec, self.mesh, device))
        return out

    def train_logits(self, tokens: torch.Tensor,
                     remat: bool = False) -> list[tuple[int, int, torch.Tensor]]:
        """Training's cache-free forward: ``tokens`` [B, S] split over the row
        groups (B must divide evenly: a batch they do not divide raises) ->
        (first row, end row, f32 logits [rows, S, V] on the group's first
        device) of each group. ``remat`` recomputes each layer, its fsdp
        gathers included, in the backward."""
        b, s = tokens.shape
        if b % self.n_groups:
            raise ValueError(f"batch {b} does not split over the {self.n_groups} dp x fsdp "
                             "row groups")
        out = []
        for gid, r0, r1 in self._groups_for(b):
            args = [(torch.arange(s, device=self._dev(gid, t)), None, None, None)
                    for t in range(self.tp)]
            x = self._embed_group(tokens[r0:r1], gid)
            x = self._group_forward(gid, x, args, remat=remat)
            out.append((r0, r1, self._logits_group(x, gid)))
        return out

    def _layer(self, gid: int, t: int, li: int) -> Block:
        if self.fsdp == 1:
            return self._store(gid, t).layers[li]
        block = _empty_block()
        for name in (*_NORMS, *_LAYER_SHAPES):
            setattr(block, name, self._weight(gid, t, name, li))
        return block

    # -- forwards --------------------------------------------------------------
    def _embed_group(self, tokens: torch.Tensor, gid: int) -> torch.Tensor:
        """[B, S] ids -> [B, S, D] on the group's first device: each shard
        gathers its hidden slice, the slices concatenate."""
        d0 = self._dev(gid, 0)
        parts = [self._store(gid, t).embed[tokens.to(self._dev(gid, t)).long()].to(d0)
                 for t in range(self.tp)]
        return parts[0] if self.tp == 1 else torch.cat(parts, -1)

    def _logits_group(self, x: torch.Tensor, gid: int) -> torch.Tensor:
        """Column-parallel ``lm_head``: each shard's vocabulary slice of the
        f32 logits, gathered on ``x``'s device."""
        dev = x.device
        parts = [mm(x.to(self._dev(gid, t)), self._weight(gid, t, "lm_head")).float().to(dev)
                 for t in range(self.tp)]
        return parts[0] if self.tp == 1 else torch.cat(parts, -1)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self._logits_group(x[r0:r1].to(self._dev(gid, 0)), gid).to(x.device)
                for gid, r0, r1 in self._groups_for(x.shape[0])]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _group_forward(self, gid: int, x: torch.Tensor, args: list,
                       kv: Optional[tuple] = None, remat: bool = False) -> torch.Tensor:
        """The layer loop of one row group: ``x`` [B_g, S, D] on the group's
        first device, ``args`` each shard's (positions, write index, starts,
        kv_lens) on its device, ``kv`` the group's (k shards, v shards) or
        None (cache-free) -> the final-norm hidden states."""
        for li in range(self.cfg.n_layers):
            if remat:
                x = checkpoint(self._group_layer, gid, li, x, args, kv, use_reentrant=False)
            else:
                x = self._group_layer(gid, li, x, args, kv)
        return rms_norm(x, self._store(gid, 0).norm_f, self.cfg.norm_eps)

    def _group_layer(self, gid: int, li: int, x: torch.Tensor, args: list,
                     kv: Optional[tuple]) -> torch.Tensor:
        """Layer ``li`` over every tp shard of row group ``gid``: each
        shard's attention half, their reduce and the residual, then the same
        for the MLP halves."""
        cfg = self.cfg
        nh, nkv = cfg.n_heads // self.tp, cfg.n_kv_heads // self.tp
        d0 = x.device
        devs = [self._dev(gid, t) for t in range(self.tp)]
        layers = [self._layer(gid, t, li) for t in range(self.tp)]
        pairs = []
        for t, (layer, d, (pos, write_at, starts, kv_lens)) in enumerate(
                zip(layers, devs, args)):
            cache = None if kv is None else (kv[0][t][li], kv[1][t][li])
            pairs.append(self._attn_half(layer, x.to(d), pos, nh, nkv, cache, write_at,
                                         starts, kv_lens, out=_deferred))
        x = x + row_parallel_mm(pairs, d0)
        pairs = [self._mlp_half(layer, x.to(d), out=_deferred)
                 for layer, d in zip(layers, devs)]
        return x + row_parallel_mm(pairs, d0)

    def transformer_forward(self, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """[B, S] ids -> f32 logits [B, S, V], cache-free (scoring)."""
        s = tokens.shape[1]
        outs = []
        for gid, r0, r1 in self._groups_for(tokens.shape[0]):
            args = [(torch.arange(s, device=self._dev(gid, t)), None, None, None)
                    for t in range(self.tp)]
            x = self._group_forward(gid, self._embed_group(tokens[r0:r1], gid), args)
            outs.append(self._logits_group(x, gid).to(tokens.device))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    forward = transformer_forward

    def init_cache(self, batch: int, max_seq: Optional[int] = None,
                   dtype: Optional[torch.dtype] = None) -> dict:
        """A zeroed sharded cache: ``k`` and ``v`` :class:`ShardedKV` (rows
        over the row groups, KV heads over tp) and ``lengths`` [B] on the
        mesh's first device."""
        cfg = self.cfg
        max_seq = max_seq or cfg.max_seq
        if max_seq > cfg.max_seq:
            raise ValueError(
                f"cache max_seq {max_seq} exceeds config max_seq {cfg.max_seq} "
                "(RoPE table bound)"
            )
        dtype = dtype or cfg.dtype
        nkv = cfg.n_kv_heads // self.tp

        def kv() -> ShardedKV:
            return ShardedKV([
                (gid, [zeros_kv((cfg.n_layers, r1 - r0, max_seq, nkv, cfg.head_dim), dtype,
                                self._dev(gid, t)) for t in range(self.tp)])
                for gid, r0, r1 in self._groups_for(batch)
            ])

        return {"k": kv(), "v": kv(),
                "lengths": torch.zeros(batch, dtype=torch.int32, device=self.device)}

    def _run_cached(self, tokens: torch.Tensor, cache: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """``Transformer._run_cached`` over the cache's row groups, each on
        its own devices (a row sliced from a batch cache decodes where its
        KV lives)."""
        b, s = tokens.shape
        dev = tokens.device
        starts = cache["lengths"]
        steps = torch.arange(s, device=dev)[None, :]
        positions = torch.clamp(starts[:, None].long() + steps, max=self.cfg.max_seq - 1)
        written = starts + s
        first = torch.clamp(starts, max=cache["k"].shape[2] - s).long()
        outs = []
        for (gid, r0, r1, ks), (_, _, _, vs) in zip(cache["k"].rows(), cache["v"].rows()):
            rows = slice(r0, r1)
            args = []
            for t in range(self.tp):
                d = self._dev(gid, t)
                write_at = (torch.arange(r1 - r0, device=d)[:, None],
                            (first[rows, None] + steps).to(d))
                args.append((positions[rows].to(d), write_at, starts[rows].to(d),
                             written[rows].to(d)))
            x = self._group_forward(gid, self._embed_group(tokens[rows], gid), args, (ks, vs))
            outs.append(x.to(dev))
        return (outs[0] if len(outs) == 1 else torch.cat(outs)), starts

    # -- adapters ----------------------------------------------------------------
    def with_lora(self, leaves: dict) -> "ShardedTransformer":
        """A model over the same stores with each targeted weight of every
        shard wrapped in its slice of the adapter (``leaves``: path ->
        (A, B, scale), the whole adapter's tensors, layer axis first): A
        splits along its input axis, B along its output axis, as the
        weight does. A row-parallel weight's partial (base plus delta) is
        linear in x, so it joins the base's reduce."""
        stores = []
        for coords, device, store in zip(device_coords(self.mesh), self.mesh.devices,
                                         self.stores):
            out = _Shard()
            out.embed, out.norm_f = store.embed, store.norm_f
            out.lm_head = self._wrap_lora(leaves.get("lm_head"), "lm_head", store.lm_head,
                                          coords, device)
            blocks = []
            for li, src in enumerate(store.layers):
                block = _empty_block()
                for name in (*_NORMS, *_LAYER_SHAPES):
                    leaf = leaves.get(f"layers/{name}")
                    if leaf is not None:
                        leaf = tuple(t[li] for t in leaf)
                    setattr(block, name, self._wrap_lora(leaf, name, getattr(src, name),
                                                         coords, device))
                blocks.append(block)
            out.layers = nn.ModuleList(blocks)
            stores.append(out)
        return ShardedTransformer(self.cfg, self.quant, self.mesh, stores, self._specs,
                                  self.freqs)

    def _wrap_lora(self, leaf: Optional[tuple], name: str, w: Any, coords: dict,
                   device: torch.device) -> Any:
        """``w`` wrapped in its shard's slice of ``leaf`` (A, B, scale)."""
        if leaf is None:
            return w
        a, b, s = leaf
        spec = self._specs[name]
        spec = spec.get("q", spec.get("q4", spec.get("q8"))) if isinstance(spec, dict) else spec
        a_spec, b_spec = (spec[-2], None), (None, spec[-1])
        return LoraWeight(w, shard_tensor(a, a_spec, self.mesh, coords).to(device),
                          shard_tensor(b, b_spec, self.mesh, coords).to(device),
                          s.reshape(1, 1).to(device))
