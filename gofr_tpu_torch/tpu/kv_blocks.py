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

Not ported here: the tp-sharded host arena and the cross-replica transfer
side (``ForeignKVRejected``, ``TransferPin``, ``install_foreign_entry``,
the wire codec).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

from gofr_tpu_torch.ops.attention import kv_bits, zeros_kv


class KVExhausted(RuntimeError):
    """No free KV blocks (and nothing evictable): the caller's request
    cannot be admitted, and decode falls back to the solo path."""


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
    """

    def __init__(self, cfg: Any, n_blocks: int, block_tokens: int,
                 max_seq: Optional[int] = None, device: "torch.device | str" = "cuda",
                 dtype: Optional[torch.dtype] = None):
        max_seq = max_seq or cfg.max_seq
        if max_seq % block_tokens:
            raise ValueError(
                f"KV_BLOCK_TOKENS={block_tokens} must divide max_seq="
                f"{max_seq} (block boundaries must tile the row)"
            )
        self.device = torch.device(device)
        self.block_tokens = block_tokens
        self.max_seq = max_seq
        self.blocks_per_seq = max_seq // block_tokens
        shape = (cfg.n_layers, n_blocks, block_tokens, cfg.n_kv_heads, cfg.head_dim)
        self.k = zeros_kv(shape, dtype or cfg.dtype, self.device)
        self.v = zeros_kv(shape, dtype or cfg.dtype, self.device)
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
        for arena, src in ((self.k, row["k"]), (self.v, row["v"])):
            arena, src = kv_bits(arena), kv_bits(src)
            blocks = src[:, 0, skip_blocks * bt : nb * bt]
            arena.index_copy_(1, idx, blocks.reshape(arena.shape[0], n, *arena.shape[2:]))
        return n * self.block_bytes

    def gather_row(self, table: BlockTable, length: int) -> dict:
        """The contiguous compute row ``{"k", "v": [L, 1, max_seq, H, D],
        "lengths": [1]}`` of a table: a fresh copy the caller owns."""
        ids, _ = self._padded_ids(table)
        idx = to_device(ids, self.device)
        row = {}
        for name, arena in (("k", self.k), ("v", self.v)):
            l_, _, bt, h, d = arena.shape
            bits = kv_bits(arena).index_select(1, idx).reshape(l_, 1, self.max_seq, h, d)
            row[name] = bits.view(arena.dtype)
        row["lengths"] = torch.full((1,), int(length), dtype=torch.int32, device=self.device)
        return row


class HostTokenArena:
    """Host block storage for the echo runner: a block's "KV" is the token
    ids it covers, so aliasing and COW fidelity is checkable directly (read
    the sequence back, compare to the prompt), with no model. (The JAX
    arena's tp shards wait for the mesh slice.)"""

    TOKEN_BYTES = 4  # int32 ids

    def __init__(self, n_blocks: int, block_tokens: int):
        self.block_tokens = block_tokens
        self.block_bytes = block_tokens * self.TOKEN_BYTES
        self._data = np.zeros((n_blocks, block_tokens), np.int32)

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
            self._data[blk, at : at + n] = ids[off : off + n]
            pos += n
            off += n
        return ids.size * self.TOKEN_BYTES

    def read(self, table: BlockTable) -> np.ndarray:
        """The sequence's tokens (exactly ``length`` of them)."""
        if not table.blocks or table.length == 0:
            return np.zeros(0, np.int32)
        nb = blocks_for(table.length, self.block_tokens)
        return self._data[table.blocks[:nb]].reshape(-1)[: table.length].copy()

    def copy_partial(self, dst_block: int, src_block: int, n_tokens: int) -> int:
        """COW copy of the boundary block's first ``n_tokens`` (the suffix
        belongs to whoever writes it next)."""
        self._data[dst_block, :n_tokens] = self._data[src_block, :n_tokens]
        return n_tokens * self.TOKEN_BYTES


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
    the bench's copy mode and the transfer side): block-table prompt
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
