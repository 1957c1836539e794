"""Partition specs for the model's weights and caches, and their placement
over a serving mesh.

Port of ``gofr_tpu/parallel/sharding.py``. A spec is a tuple with one entry
per tensor axis: ``None`` (replicated), an axis name, or a tuple of axis
names (the axis splits over their product, row-major), so a test compares
it entry by entry with the JAX ``PartitionSpec``. The Megatron table
(stacked layer weights take a leading ``None``):

| weight              | shape              | spec                      |
|---------------------|--------------------|---------------------------|
| embed               | [V, D]             | (None, 'tp')              |
| lm_head             | [D, V]             | ('fsdp', 'tp')            |
| wq / wk / wv        | [D, H*hd]          | ('fsdp', 'tp')            |
| wo                  | [D, D]             | ('tp', 'fsdp')            |
| w_gate / w_up       | [D, F]             | ('fsdp', 'tp')            |
| w_down              | [F, D]             | ('tp', 'fsdp')            |
| norms / biases      | [...]              | ()                        |

Column-parallel in-projections, row-parallel out-projections: the sum
over the tp shards follows each row-parallel product. Quantized packs
shard like their weight: int8 and w8a8 scales ([..., 1, out]) follow the
output axis; an int4 scale with several groups ([..., groups, out]) takes
the weight's own spec (its group axis follows the input axis); a
single-group int4 scale falls back to the int8 rule. A LoRA leaf's base
shards by its own rule, A along its input axis, B along its output axis.

:class:`ShardedKV` is one KV tensor of a sharded cache: rows in groups
over (dp, fsdp), each group's KV heads in tp shards on that group's
devices.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from gofr_tpu_torch.parallel.mesh import AXES, Mesh

# name -> (spec for plain 2-D [in, out]; a stacked 3-D weight gets None prepended)
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "wqkv"}  # out dim -> tp
_ROW_PARALLEL = {"wo", "w_down", "w_out"}  # in dim -> tp
_PACK_KEYS = ({"q", "scale"}, {"q4", "scale"}, {"q8", "scale"})
_LORA_KEYS = {"w", "lora_a", "lora_b", "lora_scale"}


def spec_for(name: str, ndim: int) -> tuple:
    """The spec of a plain weight ``name`` of ``ndim`` axes."""
    if name in ("embed", "tok_embed"):
        # the vocab axis stays whole (a token gather over a vocab-split
        # table would need a collective gather); the hidden axis splits
        return (None, "tp")
    if name == "lm_head":
        return ("fsdp", "tp")
    if name == "pos_embed":
        return (None, "fsdp")
    if name in _COL_PARALLEL:
        base: tuple = ("fsdp", "tp")
    elif name in _ROW_PARALLEL:
        base = ("tp", "fsdp")
    else:  # norms, biases, scalars: replicated
        return ()
    return (None,) * (ndim - 2) + base


def _as_tree(leaf: Any) -> Any:
    """A module-held weight as the JAX package's tree leaf: a pack as its
    dict, a LoRA weight as ``{"w", "lora_a", "lora_b", "lora_scale"}``."""
    pack = getattr(leaf, "pack", None)
    if isinstance(pack, dict):
        return pack
    if hasattr(leaf, "lora_a") and hasattr(leaf, "lora_b"):
        return {"w": _as_tree(leaf.w), "lora_a": leaf.lora_a, "lora_b": leaf.lora_b,
                "lora_scale": leaf.lora_scale}
    return leaf


def param_specs(params: Any, _name: str = "") -> Any:
    """Mirror a weight tree (nested dicts of tensors, packs as their dicts,
    LoRA leaves as theirs; a :class:`~gofr_tpu_torch.models.quant.Pack` or a
    LoRA weight module is read as its dict) with specs (name-based rules)."""

    def walk(tree: Any, name: str) -> Any:
        tree = _as_tree(tree)
        if isinstance(tree, dict):
            keys = set(tree)
            if keys == _LORA_KEYS:
                w_spec = walk(tree["w"], name)
                ndim = tree["lora_a"].ndim
                q_spec = spec_for(name, ndim)
                pad = (None,) * (ndim - 2)
                a_in = q_spec[-2] if len(q_spec) >= 2 else None
                b_out = q_spec[-1] if len(q_spec) >= 1 else None
                return {"w": w_spec, "lora_a": (*pad, a_in, None),
                        "lora_b": (*pad, None, b_out), "lora_scale": ()}
            if keys in _PACK_KEYS:
                q_key = next(k for k in ("q", "q4", "q8") if k in tree)
                q_spec = spec_for(name, tree[q_key].ndim)
                if q_key == "q4" and tree["scale"].shape[-2] > 1:
                    # the group axis follows the weight's input axis
                    return {q_key: q_spec, "scale": q_spec}
                tail = q_spec[-1] if len(q_spec) > 0 else None
                return {q_key: q_spec,
                        "scale": (None,) * (tree["scale"].ndim - 1) + (tail,)}
            return {k: walk(v, k) for k, v in tree.items()}
        return spec_for(name, getattr(tree, "ndim", 0))

    return walk(params, _name)


def batch_spec(sp: bool = False) -> tuple:
    """Token batches [B, S]: rows over (dp, fsdp), optionally the sequence
    over sp."""
    return (("dp", "fsdp"), "sp" if sp else None)


def cache_specs(cache: Any = None) -> dict:
    """KV cache [L, B, S, Hkv, hd]: rows over (dp, fsdp), KV heads over tp."""
    return {
        "k": (None, ("dp", "fsdp"), None, "tp", None),
        "v": (None, ("dp", "fsdp"), None, "tp", None),
        "lengths": (("dp", "fsdp"),),
    }


def kv_arena_spec() -> tuple:
    """Paged-KV block arena [L, n_blocks, bt, Hkv, hd]: KV heads over tp
    (the compute caches' head split, so a block moves between the arena
    and a row on one device); block ids stay mesh-agnostic."""
    return (None, None, None, "tp", None)


def _split(entry: Any, mesh: Mesh, coords: dict) -> tuple[int, int]:
    """(pieces, index) of one spec entry at ``coords``."""
    names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
    pieces, index = 1, 0
    for axis in names:
        pieces *= mesh.shape[axis]
        index = index * mesh.shape[axis] + coords.get(axis, 0)
    return pieces, index


def shard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh, coords: dict) -> torch.Tensor:
    """The block of ``t`` that the device at ``coords`` holds under ``spec``
    (a view; an axis that does not split evenly raises, naming it)."""
    out = t
    for dim, entry in enumerate(spec):
        pieces, index = _split(entry, mesh, coords)
        if pieces == 1:
            continue
        size = t.shape[dim]
        if size % pieces:
            raise ValueError(f"axis {dim} of size {size} does not split over {entry}={pieces}")
        width = size // pieces
        out = out.narrow(dim, index * width, width)
    return out


def block_index(spec: tuple, mesh: Mesh, coords: dict) -> tuple:
    """Which block of a weight under ``spec`` the device at ``coords``
    holds: its index along each tensor axis (0 where the axis is whole).
    Devices with equal indices hold copies of one block."""
    return tuple(_split(entry, mesh, coords)[1] for entry in spec)


def unshard_tensor(blocks: list, spec: tuple, mesh: Mesh,
                   device: "torch.device | str" = "cpu") -> torch.Tensor:
    """The whole tensor on ``device`` from ``blocks``, one per device in
    ``mesh.devices`` order (as ``shard_params`` gives them): each block
    written once, from its first copy."""
    first = blocks[0]
    pieces = [_split(entry, mesh, {})[0] for entry in spec]
    shape = [n * p for n, p in zip(first.shape, pieces)] + list(first.shape[len(spec):])
    out = torch.empty(shape, dtype=first.dtype, device=device)
    seen = set()
    for block, coords in zip(blocks, device_coords(mesh)):
        index = block_index(spec, mesh, coords)
        if index in seen:
            continue
        seen.add(index)
        view = out
        for dim, i in enumerate(index):
            width = block.shape[dim]
            view = view.narrow(dim, i * width, width)
        view.copy_(block)
    return out


def device_coords(mesh: Mesh) -> list[dict]:
    """Each device's coordinates, in ``mesh.devices`` order."""
    coords = [{}]
    for axis in AXES:
        coords = [dict(c, **{axis: i}) for c in coords for i in range(mesh.shape[axis])]
    return coords


def shard_params(params: Any, mesh: Mesh, specs: Optional[Any] = None) -> Any:
    """Place a weight tree onto the mesh: each leaf becomes the list of its
    blocks, one per device in ``mesh.devices`` order, each a copy on its
    device (a replicated leaf is copied whole to every device)."""
    if specs is None:
        specs = param_specs(params)
    coords = device_coords(mesh)

    def walk(p: Any, s: Any) -> Any:
        p = _as_tree(p)
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return [place(shard_tensor(p, s, mesh, c), d) for c, d in zip(coords, mesh.devices)]

    return walk(params, specs)


def place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` that owns its storage (a
    view never pins the unsharded tensor)."""
    return t.to(device, copy=True).contiguous()


class ShardedKV:
    """One KV tensor of a sharded cache, logically ``[L, B, S, Hkv, D]``:
    ``groups`` is a list of ``(gid, shards)``, the rows of row group ``gid``
    (a (dp, fsdp) index) in order, ``shards`` its tp head slices
    ``[L, rows, S, Hkv/tp, D]`` on that group's devices. Indexing a batch
    row or a slice of rows, ``clone``, ``copy_`` and ``view``
    act shard by shard, so the pool, the prefix cache and the arena move
    rows of a sharded cache as they move a tensor's. An int batch index
    drops the batch axis (``head_axis`` 2)."""

    __slots__ = ("groups", "head_axis")

    def __init__(self, groups: list, head_axis: int = 3):
        self.groups = groups
        self.head_axis = head_axis

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedKV":
        return ShardedKV([(gid, [fn(t) for t in shards]) for gid, shards in self.groups],
                         self.head_axis)

    @property
    def _first(self) -> torch.Tensor:
        return self.groups[0][1][0]

    @property
    def shape(self) -> torch.Size:
        s = list(self._first.shape)
        if self.head_axis == 3:
            s[1] = sum(shards[0].shape[1] for _, shards in self.groups)
        s[self.head_axis] = sum(t.shape[self.head_axis] for t in self.groups[0][1])
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self._first.dtype

    def element_size(self) -> int:
        return self._first.element_size()

    def view(self, dtype: torch.dtype) -> "ShardedKV":
        return self.map(lambda t: t.view(dtype))

    def clone(self) -> "ShardedKV":
        return self.map(torch.clone)

    def copy_(self, src: "ShardedKV") -> "ShardedKV":
        if len(src.groups) != len(self.groups):
            raise ValueError(f"copy between {len(src.groups)} and {len(self.groups)} row groups")
        for (_, dst), (_, sh) in zip(self.groups, src.groups):
            for d, s in zip(dst, sh):
                d.copy_(s)
        return self

    def rows(self) -> list[tuple[int, int, int, list]]:
        """(gid, first row, end row, shards) of each row group."""
        out, r = [], 0
        for gid, shards in self.groups:
            n = shards[0].shape[1]
            out.append((gid, r, r + n, shards))
            r += n
        return out

    def __getitem__(self, idx: Any) -> "ShardedKV":
        idx = idx if isinstance(idx, tuple) else (idx,)
        if self.head_axis != 3 or len(idx) < 2 or idx[0] != slice(None) or len(idx) > 3:
            raise IndexError(f"a sharded KV tensor indexes [:, rows(, positions)], got {idx}")
        rows, rest = idx[1], idx[2:]
        if isinstance(rows, int):
            for gid, r0, r1, shards in self.rows():
                if r0 <= rows < r1:
                    return ShardedKV([(gid, [t[(slice(None), rows - r0, *rest)] for t in shards])],
                                     head_axis=2)
            raise IndexError(f"row {rows} out of range")
        if not isinstance(rows, slice) or rows.step not in (None, 1):
            raise IndexError(f"a sharded KV tensor takes an int or a slice of rows, got {rows}")
        lo, hi, _ = rows.indices(self.shape[1])
        groups = []
        for gid, r0, r1, shards in self.rows():
            a, b = max(lo, r0), min(hi, r1)
            if a < b:
                groups.append((gid, [t[(slice(None), slice(a - r0, b - r0), *rest)]
                                     for t in shards]))
        return ShardedKV(groups)


def kv_pairs(dst: Any, src: Any) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(dst, src) tensor pairs of two KV tensors that share a layout: the
    tensors themselves, or their shards in order."""
    if isinstance(dst, ShardedKV):
        return [(d, s) for (_, ds), (_, ss) in zip(dst.groups, src.groups)
                for d, s in zip(ds, ss)]
    return [(dst, src)]
