"""Paged KV: a refcounted block allocator over a preallocated KV arena.

Port of ``gofr_tpu/tpu/kv_blocks.py``'s host side (``KVExhausted``,
``blocks_for``, ``lcp_scan``, ``BlockTable``, ``BlockPool``) and of its
device arena (``JaxKVArena`` becomes :class:`TorchKVArena`). The prefix
cache stores prompts as refcounted BLOCK TABLES: exact and LCP hits share
blocks instead of copying rows, a stored conversation aliases the whole
blocks of the prefix it extends, cached entries are LRU-evicted under the
budget when live traffic needs blocks, and the decode pool's admission
reserves each request's block budget on the same ledger.

With ``metrics`` the pool publishes ``gofr_tpu_kv_blocks{state}``
(total/free/active/cached/reserved) at every change and counts
``gofr_tpu_kv_evictions_total``. The echo runner's paged store is the
host side of the same machinery: :class:`HostTokenArena` (a block's "KV"
is the token ids it covers) and :class:`HostPagedKV` (admission with exact
and LCP aliasing, COW on extension, speculative rollback, the store at
finish), compile-free.

The cross-replica transfer side (``fleet/kvwire.py``): ``ForeignKVRejected``,
:class:`TransferPin` (a TTL-guarded incref for an export in flight),
:func:`install_foreign_entry` and each arena's codec (``wire_spec``,
``export_block_payload``, ``ingest_block_payload``). The device arena's
payload is the JAX package's: the raw k bytes then the v bytes of one block,
``[layers, block_tokens, heads, dim]``, and its spec names the dtype as
JAX does (``bfloat16``, ``float32``, ``float8_e4m3fn``), so a port replica
and a JAX replica exchange blocks.

Under a serving mesh (``TPU_MESH``) the device arena splits its KV heads
over tp, each shard's slice on its device, and exports a block with the
shards' heads concatenated in head order: a tp = 2 donor's wire bytes equal
an unsharded donor's. The echo runner's host arena splits each block's
token span over tp fake devices (host-mesh mode).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

from gofr_tpu_torch.ops.attention import kv_bits, zeros_kv
from gofr_tpu_torch.parallel.sharding import ShardedKV, kv_pairs


class KVExhausted(RuntimeError):
    """No free KV blocks (and nothing evictable): the caller's request
    cannot be admitted, and decode falls back to the solo path."""


class ForeignKVRejected(RuntimeError):
    """A transferred (cross-replica) KV payload failed SEMANTIC
    verification on ingest: the wire checksums passed but the content does
    not describe the prompt being admitted. The receiver falls back to
    local prefill; nothing was installed."""


def blocks_for(tokens: int, block_tokens: int) -> int:
    """Blocks needed to hold ``tokens`` tokens (ceil division)."""
    return (max(int(tokens), 0) + block_tokens - 1) // block_tokens


def lcp_scan(items: list, ids: np.ndarray, limit: int, min_shared: int) -> tuple:
    """Longest-common-token-prefix donor among cached sequences.
    ``items`` is ``BlockPool.cache_items()`` output; keys are int32 token
    bytes. Returns ``(shared_tokens, key, entry)`` or ``(0, None, None)``
    when nothing clears ``max(min_shared, 1)``."""
    best_shared, best_key, best_entry = 0, None, None
    for key, entry in items:
        cand = np.frombuffer(key, dtype=np.int32)
        n = min(cand.size, limit)
        if n <= best_shared:
            continue
        neq = np.nonzero(cand[:n] != ids[:n])[0]
        shared = int(neq[0]) if neq.size else n
        if shared > best_shared:
            best_shared, best_key, best_entry = shared, key, entry
    if best_entry is None or best_shared < max(min_shared, 1):
        return 0, None, None
    return best_shared, best_key, best_entry


class BlockTable:
    """One sequence's ordered block list and its valid token length:
    ``blocks[i]`` holds tokens ``[i*block_tokens, (i+1)*block_tokens)``;
    readers respect ``length`` (a shared boundary block may hold another
    sequence's tokens past it)."""

    __slots__ = ("blocks", "length")

    def __init__(self, blocks: Optional[list] = None, length: int = 0):
        self.blocks: list[int] = blocks if blocks is not None else []
        self.length = length

    def __repr__(self) -> str:
        return f"BlockTable(n={len(self.blocks)}, length={self.length})"


class _CacheEntry:
    """A cached sequence: its block table plus caller metadata (opaque to
    the pool)."""

    __slots__ = ("table", "meta")

    def __init__(self, table: BlockTable, meta: dict):
        self.table = table
        self.meta = meta


class BlockPool:
    """Refcounted block allocator plus an LRU registry of cached sequences.

    Thread-safe; ``lock`` is a public RLock so callers can make compound
    operations (LCP scan then alias) atomic against eviction. Block states:
    ``free`` (on the free list), ``cached`` (referenced by a cache entry),
    ``active`` (referenced only by live tables). ``scratch=True`` holds
    block 0 forever: the arena pads every table with it.

    Two admission surfaces share one budget: DATA blocks (``alloc``,
    ``reserve``, ``alias``...) backed by the arena, and the LEDGER
    (``reserve_ledger``/``release_ledger``) for in-flight KV that lives in
    the decode pool's slot cache. A ledger reservation counts cached blocks
    as reclaimable, so the gate is ``ledger - reserved - active``.
    """

    def __init__(
        self,
        n_blocks: int,
        block_tokens: int,
        block_bytes: int = 0,
        hbm_budget_bytes: int = 0,
        cache_entries: int = 0,
        scratch: bool = False,
        ledger_blocks: Optional[int] = None,
        metrics: Any = None,
    ):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        self.n_blocks = n_blocks
        self.block_tokens = block_tokens
        self.block_bytes = block_bytes
        self.hbm_budget_bytes = hbm_budget_bytes
        self.cache_entries = cache_entries  # 0 = unbounded (budget still caps)
        self.lock = threading.RLock()
        self._ref = [0] * n_blocks
        self._cache_ref = [0] * n_blocks  # refs held by cache entries
        first = 1 if scratch else 0
        self._scratch = scratch
        if scratch and n_blocks < 2:
            raise ValueError("scratch pool needs n_blocks >= 2")
        if scratch:
            self._ref[0] = 1  # permanently held, never freed
        # LIFO free list: recently freed blocks are handed out first
        self._free = list(range(n_blocks - 1, first - 1, -1))
        self._cache: "OrderedDict[bytes, _CacheEntry]" = OrderedDict()
        self._cached_unique = 0  # blocks with _cache_ref > 0
        self.ledger_blocks = ledger_blocks if ledger_blocks is not None else self.total_blocks
        self.reserved = 0  # ledger blocks claimed by in-flight requests
        self.evictions = 0
        self.cow_copies = 0
        self.copied_kv_bytes = 0
        self.exhausted_rejects = 0
        self._blocks_gauge = self._evict_counter = None
        if metrics is not None:
            self._blocks_gauge = metrics.gauge(
                "gofr_tpu_kv_blocks",
                "paged KV arena blocks by state "
                "(total/free/active/cached/reserved)",
                labels=("state",),
            )
            self._evict_counter = metrics.counter(
                "gofr_tpu_kv_evictions_total",
                "prefix-cache entries LRU-evicted to free KV blocks",
            )
            self._publish()

    @property
    def total_blocks(self) -> int:
        """Allocatable blocks (the scratch block is bookkeeping)."""
        return self.n_blocks - (1 if self._scratch else 0)

    def _publish(self) -> None:
        """The block-state gauge (lock held)."""
        if self._blocks_gauge is None:
            return
        free = len(self._free)
        self._blocks_gauge.set(self.total_blocks, state="total")
        self._blocks_gauge.set(free, state="free")
        self._blocks_gauge.set(self._cached_unique, state="cached")
        self._blocks_gauge.set(self.total_blocks - free - self._cached_unique, state="active")
        self._blocks_gauge.set(self.reserved, state="reserved")

    def note_copied(self, nbytes: int) -> None:
        """Bytes an engine physically copied moving KV between blocks and
        rows."""
        with self.lock:
            self.copied_kv_bytes += int(nbytes)

    # -- raw block ops -------------------------------------------------------
    def alloc(self, n: int) -> list[int]:
        """Take ``n`` free blocks (refcount 1 each), LRU-evicting cached
        entries as needed; raises :class:`KVExhausted` when live references
        alone exceed the arena."""
        if n <= 0:
            return []
        with self.lock:
            if len(self._free) < n:
                # satisfiability first: a doomed request must not wipe the
                # cache as collateral before failing anyway
                reclaimable = sum(
                    1 for b in range(self.n_blocks)
                    if self._ref[b] > 0 and self._ref[b] == self._cache_ref[b]
                )
                if len(self._free) + reclaimable < n:
                    self.exhausted_rejects += 1
                    raise KVExhausted(
                        f"need {n} KV blocks, {len(self._free)} free + "
                        f"{reclaimable} reclaimable of {self.total_blocks} "
                        "(the rest held by live requests)"
                    )
            while len(self._free) < n and self._cache:
                self._evict_lru()
            if len(self._free) < n:
                self.exhausted_rejects += 1
                raise KVExhausted(
                    f"need {n} KV blocks, {len(self._free)} free of "
                    f"{self.total_blocks} (cache empty — all blocks held "
                    "by live requests)"
                )
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            self._publish()
            return out

    def incref(self, blocks: list) -> None:
        with self.lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise RuntimeError(f"incref of free block {b} (use-after-free)")
                self._ref[b] += 1

    def release_blocks(self, blocks: list) -> None:
        """Drop one reference per block; blocks reaching zero return to
        the free list at once."""
        with self.lock:
            for b in blocks:
                r = self._ref[b] - 1
                if r < 0:
                    raise RuntimeError(f"double free of block {b}")
                self._ref[b] = r
                if r == 0:
                    self._free.append(b)
            self._publish()

    # -- ledger reservations (decode-pool admission) -------------------------
    def reserve_ledger(self, n_tokens: int) -> int:
        """Claim admission budget for ``n_tokens`` of in-flight KV that
        lives outside the arena; returns the block count to hand back via
        :meth:`release_ledger`, or raises :class:`KVExhausted`."""
        n = blocks_for(n_tokens, self.block_tokens)
        with self.lock:
            active = self.total_blocks - len(self._free) - self._cached_unique
            if self.ledger_blocks - self.reserved - active < n:
                self.exhausted_rejects += 1
                raise KVExhausted(
                    f"need {n} KV blocks, "
                    f"{self.ledger_blocks - self.reserved - active} of "
                    f"{self.ledger_blocks} unclaimed (reserved="
                    f"{self.reserved}, active={active})"
                )
            self.reserved += n
            self._publish()
            return n

    def release_ledger(self, n: int) -> None:
        """Return admission budget the moment a request finishes."""
        with self.lock:
            self.reserved = max(self.reserved - int(n), 0)
            self._publish()

    # -- table ops -----------------------------------------------------------
    def reserve(self, n_tokens: int) -> BlockTable:
        """A fresh table with capacity for ``n_tokens`` (length 0)."""
        return BlockTable(self.alloc(blocks_for(n_tokens, self.block_tokens)))

    def ensure(self, table: BlockTable, n_tokens: int) -> None:
        """Grow ``table``'s capacity to ``n_tokens`` tokens."""
        need = blocks_for(n_tokens, self.block_tokens) - len(table.blocks)
        if need > 0:
            table.blocks.extend(self.alloc(need))

    def release(self, table: BlockTable) -> None:
        with self.lock:
            blocks, table.blocks, table.length = table.blocks, [], 0
            self.release_blocks(blocks)

    def trim(self, table: BlockTable) -> int:
        """Free capacity beyond ``length``; returns the blocks released."""
        with self.lock:
            keep = blocks_for(table.length, self.block_tokens)
            tail = table.blocks[keep:]
            del table.blocks[keep:]
            if tail:
                self.release_blocks(tail)
            return len(tail)

    def alias(self, donor: BlockTable, n_tokens: int) -> BlockTable:
        """A new table referencing the donor's blocks that cover its first
        ``n_tokens`` tokens (the boundary block may be shared mid-block)."""
        if n_tokens > donor.length:
            raise ValueError(f"alias of {n_tokens} tokens from a {donor.length}-token table")
        with self.lock:
            shared = donor.blocks[: blocks_for(n_tokens, self.block_tokens)]
            self.incref(shared)
            return BlockTable(list(shared), n_tokens)

    def alias_full_blocks(self, donor: BlockTable, n_tokens: int) -> tuple:
        """Share only WHOLE blocks within ``n_tokens`` (the store path: the
        boundary block stays private to the donor). Returns ``(table,
        shared_tokens)``."""
        full = min(n_tokens, donor.length) // self.block_tokens
        shared_tokens = full * self.block_tokens
        with self.lock:
            shared = donor.blocks[:full]
            self.incref(shared)
            return BlockTable(list(shared), shared_tokens), shared_tokens

    def cow_boundary(self, table: BlockTable) -> Optional[tuple]:
        """Copy-on-write before appending: a shared, partly filled boundary
        block is replaced by a private one. Returns ``(old, new)`` block
        ids when that happened, else None; the caller copies the first
        ``table.length % block_tokens`` tokens of ``old`` into ``new``."""
        frac = table.length % self.block_tokens
        if frac == 0 or not table.blocks:
            return None
        with self.lock:
            i = table.length // self.block_tokens
            old = table.blocks[i]
            if self._ref[old] <= 1:
                return None
            new = self.alloc(1)[0]
            table.blocks[i] = new
            self.release_blocks([old])
            self.cow_copies += 1
            return old, new

    # -- cached sequences (the prefix cache's storage half) ------------------
    def cache_put(self, key: bytes, table: BlockTable, meta: dict) -> None:
        """Insert or replace a cached sequence. The caller's block
        references become the cache's (the caller must not release the
        table afterwards)."""
        with self.lock:
            old = self._cache.pop(key, None)
            if old is not None:
                self._cache_release(old)
            self._cache[key] = _CacheEntry(table, meta)
            for b in table.blocks:
                if self._cache_ref[b] == 0:
                    self._cached_unique += 1
                self._cache_ref[b] += 1
            while self.cache_entries and len(self._cache) > self.cache_entries:
                self._evict_lru()
            self._publish()

    def cache_lookup(self, key: bytes) -> Optional[_CacheEntry]:
        """Exact-key entry (LRU order refreshed) or None. Pin its blocks
        (``incref``) under ``lock`` before device work against them."""
        with self.lock:
            entry = self._cache.get(key)
            if entry is not None:
                self._cache.move_to_end(key)
            return entry

    def cache_items(self) -> list:
        """Snapshot of (key, entry) pairs, LRU-first."""
        with self.lock:
            return list(self._cache.items())

    def cache_touch(self, key: bytes) -> None:
        with self.lock:
            if key in self._cache:
                self._cache.move_to_end(key)

    def cache_clear(self) -> None:
        """Release every cached sequence (not counted as evictions)."""
        with self.lock:
            while self._cache:
                _, entry = self._cache.popitem(last=False)
                self._cache_release(entry)
            self._publish()

    def cache_discard(self, key: bytes) -> None:
        """Release the one cached sequence under ``key``, if any (not
        counted as an eviction)."""
        with self.lock:
            entry = self._cache.pop(key, None)
            if entry is not None:
                self._cache_release(entry)
                self._publish()

    def _cache_release(self, entry: _CacheEntry) -> None:
        for b in entry.table.blocks:
            self._cache_ref[b] -= 1
            if self._cache_ref[b] == 0:
                self._cached_unique -= 1
        self.release_blocks(entry.table.blocks)
        entry.table.blocks = []

    def _evict_lru(self) -> None:
        """Drop the least-recently-used cached sequence (lock held);
        blocks shared with live tables survive on their other refs."""
        _, entry = self._cache.popitem(last=False)
        self._cache_release(entry)
        self.evictions += 1
        if self._evict_counter is not None:
            self._evict_counter.inc()

    def __len__(self) -> int:
        with self.lock:
            return len(self._cache)

    def stats(self) -> dict:
        """Point-in-time accounting, all host-side reads."""
        with self.lock:
            free = len(self._free)
            used = self.total_blocks - free
            return {
                "total": self.total_blocks,
                "ledger": self.ledger_blocks,
                "block_tokens": self.block_tokens,
                "block_bytes": self.block_bytes,
                "free": free,
                "cached": self._cached_unique,
                "active": used - self._cached_unique,
                "reserved": self.reserved,
                "cached_entries": len(self._cache),
                "evictions": self.evictions,
                "cow_copies": self.cow_copies,
                "copied_kv_bytes": self.copied_kv_bytes,
                "kv_exhausted_rejects": self.exhausted_rejects,
                "hbm_budget_bytes": self.hbm_budget_bytes or None,
                "budget_utilization": (
                    round((used + self.reserved) * self.block_bytes / self.hbm_budget_bytes, 4)
                    if self.hbm_budget_bytes and self.block_bytes else None
                ),
            }


class TransferPin:
    """A bounded-lifetime pin on the blocks of an in-flight cross-replica
    KV transfer. The export increfs the entry's blocks so eviction cannot
    free them mid-send, and releases them when the response stream closes;
    a named daemon timer (``gofr-kv-transfer-pin``) releases them after
    ``ttl_s`` if nobody did (a serving thread that died mid-send), and the
    late releaser finds an idempotent no-op. ``expired`` records that the
    guard fired (the export stops streaming a pin it no longer holds)."""

    def __init__(self, pool: "BlockPool", blocks: list, ttl_s: float = 60.0):
        self.pool = pool
        self.blocks = list(blocks)
        self._lock = threading.Lock()
        self._released = False
        self.expired = False
        with pool.lock:
            pool.incref(self.blocks)
        self._timer = threading.Timer(max(ttl_s, 0.001), self._expire)
        self._timer.name = "gofr-kv-transfer-pin"
        self._timer.daemon = True
        self._timer.start()

    def _expire(self) -> None:
        self.expired = True
        self.release()

    def release(self) -> None:
        """Idempotent: the first caller (normal close, abort or the TTL
        timer) drops the refs; everyone else no-ops."""
        with self._lock:
            if self._released:
                return
            self._released = True
        self._timer.cancel()
        self.pool.release_blocks(self.blocks)

    @property
    def released(self) -> bool:
        with self._lock:
            return self._released


def install_foreign_entry(pool: "BlockPool", arena: Any, ids: np.ndarray, payloads: list,
                          meta_extra: dict, *, verify_readback: bool,
                          count_copied: bool) -> bool:
    """The receiving end of a cross-replica KV transfer, shared by the host
    engine and the device prefix store: reserve blocks, ingest the verified
    payloads, and publish the result as a cache entry, so the imminent
    admission of the same prompt aliases it copy-free.

    Returns False when the local pool cannot host it (exhausted: a LOCAL
    condition, not a transfer failure). Raises :class:`ForeignKVRejected`
    on a count mismatch or, with ``verify_readback`` (the host token arena,
    whose payload reads back as the prompt), when the installed blocks read
    back as another token sequence; either way the reservation is rolled
    back and the pool is as it was. ``count_copied`` feeds the ingested
    bytes into the pool's copied-KV accounting."""
    ids = np.asarray(ids, np.int32).reshape(-1)
    key = ids.tobytes()
    need = blocks_for(int(ids.size), pool.block_tokens)
    if len(payloads) != need:
        raise ForeignKVRejected(
            f"{len(payloads)} block payloads for a {ids.size}-token prompt needing {need}"
        )
    with pool.lock:
        if pool.cache_lookup(key) is not None:
            return True  # already warm locally; nothing to install
        try:
            table = pool.reserve(int(ids.size))
        except KVExhausted:
            return False
        table.length = int(ids.size)
    # ingest OUTSIDE pool.lock: the reservation owns the blocks, and a
    # device ingest is a real transfer admissions must not wait behind
    copied = 0
    try:
        for j, payload in enumerate(payloads):
            copied += arena.ingest_block_payload(table, j, payload) or 0
        if verify_readback and not np.array_equal(arena.read(table), ids):
            raise ForeignKVRejected(
                "transferred KV read back as a different token sequence than "
                "the prompt being admitted"
            )
    except Exception:
        pool.release(table)
        raise
    if count_copied:
        pool.note_copied(copied)
    entry_meta = {"length": int(ids.size)}
    entry_meta.update(meta_extra)
    pool.cache_put(key, table, entry_meta)
    return True


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host sync: on a card the copy
    goes from pinned memory, asynchronously, in stream order."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class TorchKVArena:
    """Device block storage and the bridge between block tables and the
    contiguous rows the model computes on.

    Layout ``[n_layers, n_blocks, block_tokens, n_kv_heads, head_dim]`` for
    k and v; block 0 is scratch (pair with ``BlockPool(scratch=True)``):
    ``gather_row`` pads every table with it, so positions past a table's
    end read garbage that attention masks, as the slot model's stale rows.
    Both directions are plain indexed copies (``index_copy_`` and
    ``index_select``) on the current stream; a float8 cache moves as its
    uint8 bits, so its blocks keep float8 end to end.

    With a serving ``mesh`` (tp only: dp and fsdp degrade paged KV) k and v
    are :class:`~gofr_tpu_torch.parallel.sharding.ShardedKV`: the head axis
    splits over tp (``kv_arena_spec``), each shard on its tp device, so a
    block moves between the arena and a sharded row shard by shard, on one
    device; block ids and tables stay mesh-agnostic.
    """

    def __init__(self, cfg: Any, n_blocks: int, block_tokens: int,
                 max_seq: Optional[int] = None, device: "torch.device | str" = "cuda",
                 dtype: Optional[torch.dtype] = None, mesh: Any = None):
        max_seq = max_seq or cfg.max_seq
        if max_seq % block_tokens:
            raise ValueError(
                f"KV_BLOCK_TOKENS={block_tokens} must divide max_seq="
                f"{max_seq} (block boundaries must tile the row)"
            )
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.devices[0]
        self.block_tokens = block_tokens
        self.max_seq = max_seq
        self.blocks_per_seq = max_seq // block_tokens
        dtype = dtype or cfg.dtype
        tp = 1 if mesh is None else mesh.shape["tp"]
        if cfg.n_kv_heads % tp:
            raise ValueError(
                f"n_kv_heads={cfg.n_kv_heads} not divisible by tp={tp} — the paged-KV "
                "arena shards its head axis over tp"
            )
        shape = (cfg.n_layers, n_blocks, block_tokens, cfg.n_kv_heads // tp, cfg.head_dim)
        if mesh is None:
            self.k = zeros_kv(shape, dtype, self.device)
            self.v = zeros_kv(shape, dtype, self.device)
        else:
            devs = [mesh.device(tp=t) for t in range(tp)]
            self.k = ShardedKV([(0, [zeros_kv(shape, dtype, d) for d in devs])])
            self.v = ShardedKV([(0, [zeros_kv(shape, dtype, d) for d in devs])])
        self.block_bytes = (
            2 * cfg.n_layers * block_tokens * cfg.n_kv_heads * cfg.head_dim
            * self.k.element_size()
        )

    def _padded_ids(self, table: BlockTable, skip_blocks: int = 0) -> tuple:
        ids = np.zeros(self.blocks_per_seq, np.int64)  # 0 = scratch
        nb = min(blocks_for(table.length, self.block_tokens), len(table.blocks))
        for j in range(skip_blocks, nb):
            ids[j] = table.blocks[j]
        return ids, nb

    def scatter_row(self, row: dict, table: BlockTable, skip_blocks: int = 0) -> int:
        """Write ``row``'s (a ``[L, 1, max_seq, H, D]`` k/v pair) first
        ``table.length`` tokens into the table's blocks, skipping the first
        ``skip_blocks`` (aliased blocks keep their donor's content).
        Returns the bytes copied into the arena."""
        ids, nb = self._padded_ids(table, skip_blocks)
        n = nb - skip_blocks
        if n <= 0:
            return 0
        bt = self.block_tokens
        idx = to_device(ids[skip_blocks:nb], self.device)
        for arena, src in (*kv_pairs(self.k, row["k"]), *kv_pairs(self.v, row["v"])):
            arena, src = kv_bits(arena), kv_bits(src)
            blocks = src[:, 0, skip_blocks * bt : nb * bt]
            arena.index_copy_(1, idx.to(arena.device),
                              blocks.reshape(arena.shape[0], n, *arena.shape[2:]))
        return n * self.block_bytes

    def gather_row(self, table: BlockTable, length: int) -> dict:
        """The contiguous compute row ``{"k", "v": [L, 1, max_seq, H, D],
        "lengths": [1]}`` of a table: a fresh copy the caller owns (under a
        mesh, sharded as the model's caches)."""
        ids, _ = self._padded_ids(table)
        idx = to_device(ids, self.device)

        def gather(arena: torch.Tensor) -> torch.Tensor:
            l_, _, bt, h, d = arena.shape
            bits = kv_bits(arena).index_select(1, idx.to(arena.device))
            return bits.reshape(l_, 1, self.max_seq, h, d).view(arena.dtype)

        row = {}
        for name, arena in (("k", self.k), ("v", self.v)):
            row[name] = arena.map(gather) if isinstance(arena, ShardedKV) else gather(arena)
        row["lengths"] = torch.full((1,), int(length), dtype=torch.int32, device=self.device)
        return row

    # -- cross-replica transfer codec (fleet/kvwire.py) ----------------------
    @property
    def _block_shape(self) -> tuple:
        # one block's k (or v): [layers, block_tokens, heads, dim]
        s = self.k.shape
        return (s[0], s[2], s[3], s[4])

    def wire_spec(self) -> dict:
        """The compatibility fields a transfer peer must match: payload
        kind, block geometry and dtype, spelled as the JAX arena spells
        them (``str`` of a numpy dtype: ``bfloat16``, not
        ``torch.bfloat16``), so port and JAX replicas agree."""
        return {
            "kind": "device-kv",
            "block_tokens": self.block_tokens,
            "dtype": str(self.k.dtype).removeprefix("torch."),
            "block_shape": list(self._block_shape),
        }

    def _shards(self, arena: Any) -> list[torch.Tensor]:
        return arena.groups[0][1] if isinstance(arena, ShardedKV) else [arena]

    def export_block_payload(self, table: BlockTable, j: int) -> bytes:
        """Block ``j``'s raw k bytes then v bytes, the shards' heads
        concatenated in head order (an unsharded arena's layout). The
        device-to-host copy runs on the current stream, so it reads the
        block after every write queued before it (the prefill's scatter
        included); ``arena[:, bid]`` is a strided view, made contiguous on
        the card first."""
        bid = table.blocks[j]
        parts = []
        for arena in (self.k, self.v):
            blocks = [kv_bits(t)[:, bid].contiguous().cpu() for t in self._shards(arena)]
            block = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=2)
            parts.append(block.view(torch.uint8).numpy().tobytes())
        return parts[0] + parts[1]

    def ingest_block_payload(self, table: BlockTable, j: int, payload: bytes) -> int:
        """Install transferred k/v bytes into block ``j`` of a private
        (freshly reserved) table, on the current stream, split over the
        shards' heads: the pool's next chunk, queued after it, reads the
        installed block."""
        shape = self._block_shape
        half = int(np.prod(shape)) * self.k.element_size()
        if len(payload) != 2 * half:
            raise ForeignKVRejected(f"block {j} payload is {len(payload)}B, expected {2 * half}")
        bid = table.blocks[j]
        host = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        for i, arena in enumerate((self.k, self.v)):
            block = host[i * half:(i + 1) * half].view(*shape[:3], -1)  # [L, bt, H, D bytes]
            h0 = 0
            for t in self._shards(arena):
                dst = t.view(torch.uint8)[:, bid]
                dst.copy_(block[:, :, h0:h0 + dst.shape[2]])
                h0 += dst.shape[2]
        return len(payload)

    def read(self, table: BlockTable) -> Any:
        """Device KV has no semantic read-back (the content is model state,
        not the prompt): install paths verify the transport's checksums and
        the spec only."""
        return None


class HostTokenArena:
    """Host block storage for the echo runner: a block's "KV" is the token
    ids it covers, so aliasing and COW fidelity is checkable directly (read
    the sequence back, compare to the prompt), with no model.

    ``shards`` is the host-mesh mode (echo's ``TPU_MESH``, the counterpart
    of the device arena's tp head split): every block's tokens split
    contiguously across ``shards`` fake devices, shard ``s`` owning
    positions ``[s*w, (s+1)*w)`` of each block (``w = block_tokens /
    shards``), so tables, aliasing, COW and admission run against
    distributed storage, compile-free. ``shard_writes`` counts each fake
    device's writes."""

    TOKEN_BYTES = 4  # int32 ids

    def __init__(self, n_blocks: int, block_tokens: int, shards: int = 1):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if block_tokens % shards:
            raise ValueError(
                f"tp={shards} does not divide KV_BLOCK_TOKENS={block_tokens} — host-mesh "
                "blocks split their token axis evenly across the tp axis"
            )
        self.block_tokens = block_tokens
        self.block_bytes = block_tokens * self.TOKEN_BYTES
        self.shards = shards
        self._width = block_tokens // shards
        # [shards, n_blocks, width]: axis 0 is the fake-device axis; a
        # shard-major reshape of a block reassembles its token order
        self._data = np.zeros((shards, n_blocks, self._width), np.int32)
        self.shard_writes = [0] * shards

    def _write_span(self, blk: int, at: int, ids: np.ndarray) -> None:
        """Write ``ids`` at block-local offset ``at`` of ``blk``: one slice
        store per shard the span overlaps (a 1-token append touches one
        element, never the whole block)."""
        w = self._width
        hi = at + ids.size
        for s in range(at // w, (hi - 1) // w + 1):
            s_lo, s_hi = max(at, s * w), min(hi, (s + 1) * w)
            self._data[s, blk, s_lo - s * w : s_hi - s * w] = ids[s_lo - at : s_hi - at]
            self.shard_writes[s] += 1

    def write(self, table: BlockTable, start: int, ids: np.ndarray) -> int:
        """Write ``ids`` at token offset ``start`` of ``table``; capacity
        must already exist. Returns bytes copied."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        bt = self.block_tokens
        pos = start
        off = 0
        while off < ids.size:
            blk = table.blocks[pos // bt]
            at = pos % bt
            n = min(bt - at, ids.size - off)
            self._write_span(blk, at, ids[off : off + n])
            pos += n
            off += n
        return ids.size * self.TOKEN_BYTES

    def _block_tokens(self, blocks: Any) -> np.ndarray:
        """The blocks' tokens in order: [shards, n, width] -> [n, shards,
        width] -> flat."""
        return np.transpose(self._data[:, blocks, :], (1, 0, 2)).reshape(-1)

    def read(self, table: BlockTable) -> np.ndarray:
        """The sequence's tokens (exactly ``length`` of them)."""
        if not table.blocks or table.length == 0:
            return np.zeros(0, np.int32)
        nb = blocks_for(table.length, self.block_tokens)
        return self._block_tokens(table.blocks[:nb])[: table.length].copy()

    def copy_partial(self, dst_block: int, src_block: int, n_tokens: int) -> int:
        """COW copy of the boundary block's first ``n_tokens``, shard by
        shard (the suffix belongs to whoever writes it next)."""
        w = self._width
        for s in range((n_tokens - 1) // w + 1):
            n_s = min(n_tokens - s * w, w)
            self._data[s, dst_block, :n_s] = self._data[s, src_block, :n_s]
            self.shard_writes[s] += 1
        return n_tokens * self.TOKEN_BYTES

    # -- cross-replica transfer codec (fleet/kvwire.py) ----------------------
    def wire_spec(self) -> dict:
        """The compatibility fields a transfer peer must match. ``shards``
        is absent: the split is local layout, so a tp = 2 host arena and an
        unsharded one exchange the same payloads."""
        return {"kind": "host-tokens", "block_tokens": self.block_tokens}

    def export_block_payload(self, table: BlockTable, j: int) -> bytes:
        """Block ``j``'s valid tokens as int32 bytes (the boundary block
        ships only up to ``table.length``)."""
        lo = j * self.block_tokens
        span = min(table.length, lo + self.block_tokens) - lo
        tokens = self._block_tokens([table.blocks[j]])[:span]
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    def ingest_block_payload(self, table: BlockTable, j: int, payload: bytes) -> int:
        """Install a transferred block payload into block ``j`` of a private
        (freshly reserved) table. Returns the bytes written."""
        if len(payload) % self.TOKEN_BYTES:
            raise ForeignKVRejected(
                f"block {j} payload is {len(payload)}B, not a whole number of int32 tokens"
            )
        ids = np.frombuffer(payload, np.int32)
        if ids.size == 0 or ids.size > self.block_tokens:
            raise ForeignKVRejected(
                f"block {j} carries {ids.size} tokens (block size {self.block_tokens})"
            )
        self._write_span(table.blocks[j], 0, ids)
        return len(payload)


class PagedSequence:
    """One live request's handle on the host engine: its table, the
    prompt's length and the blocks it was admitted with copy-free (a prefix
    shared with a cache entry)."""

    __slots__ = ("table", "prompt_len", "aliased_blocks")

    def __init__(self, table: BlockTable, prompt_len: int, aliased_blocks: int = 0):
        self.table = table
        self.prompt_len = prompt_len
        self.aliased_blocks = aliased_blocks


class HostPagedKV:
    """The echo runner's paged KV engine (copy of the JAX package's, without
    the bench's copy mode): block-table prompt
    storage, copy-free prefix aliasing (exact and LCP), COW on extension,
    reserve-at-admission, rollback of rejected speculative tokens, and the
    finished conversation stored as a cache entry."""

    def __init__(self, pool: BlockPool, arena: HostTokenArena, lcp_min: int = 8):
        self.pool = pool
        self.arena = arena
        self.lcp_min = lcp_min
        # the transformer runner's prefix_stats shape: the device's
        # hit-ratio gauges read both
        self.prefix_stats = {"hits": 0, "partial_hits": 0, "misses": 0}
        self._stats_lock = threading.Lock()

    # -- admission -----------------------------------------------------------
    def admit(self, ids: np.ndarray, max_new: int) -> PagedSequence:
        """Admit a prompt: alias cached blocks where possible, write the
        rest, and reserve decode capacity up front. Raises
        :class:`KVExhausted` (rolled back) when the arena cannot cover it
        even after evicting the cache."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        table = None
        try:
            with self.pool.lock:  # scan + alias must be atomic vs eviction
                table, aliased, kind = self._admit_table(ids)
                # capacity for the whole generation now: an admitted
                # request never dies to block starvation mid-decode, and
                # trim() hands the unused tail back at finish
                self.pool.ensure(table, ids.size + max_new)
                if kind != "hit":
                    # the prompt entry, an alias of the live table: an
                    # exact repeat of this prompt now hits, copy-free
                    self.pool.cache_put(
                        ids.tobytes(), self.pool.alias(table, ids.size),
                        {"length": int(ids.size)},
                    )
                if max_new > 0:
                    # pre-COW the (now shared) boundary block while
                    # exhaustion still rolls back to a clean reject
                    cow = self.pool.cow_boundary(table)
                    if cow is not None:
                        self._copy_boundary(table, cow)
        except KVExhausted:
            if table is not None:
                self.pool.release(table)
            raise
        with self._stats_lock:
            self.prefix_stats[
                "hits" if kind == "hit"
                else "partial_hits" if kind == "partial_hit" else "misses"
            ] += 1
        return PagedSequence(table, ids.size, aliased)

    def _copy_boundary(self, table: BlockTable, cow: tuple) -> None:
        old, new = cow
        self.pool.note_copied(
            self.arena.copy_partial(new, old, table.length % self.pool.block_tokens)
        )

    def _admit_table(self, ids: np.ndarray) -> tuple:
        """Build the admitted table (pool lock held): exact alias, LCP
        partial alias + tail write, or full write -> (table, blocks aliased
        copy-free, hit | partial_hit | miss)."""
        entry = self.pool.cache_lookup(ids.tobytes())
        if entry is not None:
            table = self.pool.alias(entry.table, ids.size)
            return table, len(table.blocks), "hit"
        shared, donor = self._lcp_scan(ids)
        if donor is not None:
            # share whole blocks copy-free; the boundary and the tail are
            # this request's own writes
            table, shared_tokens = self.pool.alias_full_blocks(donor.table, shared)
            n_aliased = len(table.blocks)
            try:
                self.pool.ensure(table, ids.size)
            except KVExhausted:
                self.pool.release(table)  # the alias holds refs the caller never sees
                raise
            self.pool.note_copied(self.arena.write(table, shared_tokens, ids[shared_tokens:]))
            table.length = ids.size
            return table, n_aliased, "partial_hit"
        table = self.pool.reserve(ids.size)
        self.pool.note_copied(self.arena.write(table, 0, ids))
        table.length = ids.size
        return table, 0, "miss"

    def _lcp_scan(self, ids: np.ndarray) -> tuple:
        """Longest-common-prefix donor among cached sequences (pool lock
        held), at this engine's threshold."""
        shared, key, entry = lcp_scan(
            self.pool.cache_items(), ids, int(ids.size) - 1, self.lcp_min
        )
        if entry is None:
            return 0, None
        self.pool.cache_touch(key)
        return shared, entry

    # -- decode-time ---------------------------------------------------------
    def prompt_tokens(self, seq: PagedSequence) -> np.ndarray:
        """The prompt read back THROUGH the block tables: the echo decode
        loop cycles these, so aliasing fidelity shows in its output."""
        return self.arena.read(seq.table)[: seq.prompt_len]

    def append(self, seq: PagedSequence, token: int) -> None:
        """One decoded token lands in the sequence's KV: COW if the
        boundary block is shared, then write (capacity was reserved at
        admission)."""
        with self.pool.lock:
            cow = self.pool.cow_boundary(seq.table)
            if cow is not None:
                self._copy_boundary(seq.table, cow)
            self.pool.ensure(seq.table, seq.table.length + 1)
            self.arena.write(seq.table, seq.table.length, np.asarray([token], np.int32))
            seq.table.length += 1

    def rollback(self, seq: PagedSequence, n_tokens: int) -> None:
        """Speculative reject: the sequence's valid length goes back to
        ``n_tokens`` (the committed prefix). Every reader honors
        ``length``, so the content past it is dead at once; the blocks stay
        in the table (the admission's reservation: releasing them would let
        another admission take them and starve this one's next append) and
        go back at :meth:`finish` through ``trim``."""
        if n_tokens < seq.prompt_len:
            raise ValueError(
                f"rollback to {n_tokens} would cut into the {seq.prompt_len}-token prompt"
            )
        with self.pool.lock:
            if n_tokens > seq.table.length:
                raise ValueError(
                    f"rollback to {n_tokens} past the sequence's "
                    f"{seq.table.length}-token length"
                )
            seq.table.length = n_tokens

    # -- completion ----------------------------------------------------------
    def finish(self, seq: PagedSequence, store: bool = True) -> None:
        """Request done: trim the unused reservation (those blocks admit
        the next request at once), then either hand the table to the cache
        (keyed by the whole conversation, copy-free) or release it."""
        self.pool.trim(seq.table)
        if store and seq.table.length > 0:
            key = self.arena.read(seq.table).tobytes()
            self.pool.cache_put(key, seq.table, {"length": seq.table.length})
        else:
            self.pool.release(seq.table)
        seq.table = BlockTable()

    def abort(self, seq: PagedSequence) -> None:
        self.finish(seq, store=False)

    # -- cross-replica transfer (receiving end) ------------------------------
    def install_remote(self, ids: np.ndarray, payloads: list, meta: dict) -> bool:
        """Install a verified transferred entry so the imminent :meth:`admit`
        of the same prompt aliases it copy-free. Host "KV" is token ids, so
        the install also reads the blocks back and checks they ARE the
        prompt: the wire checksums guard the transport, the readback the
        content."""
        return install_foreign_entry(
            self.pool, self.arena, ids, payloads, {},
            verify_readback=True, count_copied=False,
        )

    def stats(self) -> dict:
        out = self.pool.stats()
        with self._stats_lock:
            out["prefix"] = dict(self.prefix_stats)
        return out
