"""Disk-backed write-ahead log behind the generation journal (port of
``gofr_tpu/journal_wal.py``, frame for frame): a killed process must not
erase its resumable streams. A directory written by either package is
recovered by the other.

Layout (``JOURNAL_DIR``): numbered segments ``wal-<seq>.log``, each
``MAGIC + u32 version`` then frames of ``u8 kind + u32 len + u32 crc +
payload`` (the CRC covers the kind byte). Appends go to the newest segment;
at ``segment_bytes`` the log rotates, writing a CHECKPOINT of every live
entry at the head of the new segment, and keeps at most ``retain``
segments. Kinds: ``open`` (an entry's identity), ``tokens`` (emitted ids),
``finish`` / ``claim`` / ``retire`` (no longer resumable), ``interrupt``
(died mid-flight, with its cause) and ``checkpoint``.

Recovery replays the segments oldest first and stops a segment at its
first frame that fails to parse or its CRC (a torn tail after a kill is
expected; everything before it is kept). Entries left ``interrupted``, or
``open`` with no terminal record, rehydrate as resumable entries.
``JOURNAL_FSYNC``: ``interrupt`` (default) flushes every record and fsyncs
on interruption, rotation and close; ``always`` fsyncs every record;
``off`` only flushes. Stdlib only.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Any, Optional

MAGIC = b"GJW1"
WIRE_VERSION = 1
_U32 = struct.Struct("<I")
_FRAME_HEAD = struct.Struct("<BII")  # kind, payload_len, crc32

K_OPEN = 1
K_TOKENS = 2
K_FINISH = 3
K_INTERRUPT = 4
K_CLAIM = 5
K_RETIRE = 6
K_CHECKPOINT = 7
_KINDS = (K_OPEN, K_TOKENS, K_FINISH, K_INTERRUPT, K_CLAIM, K_RETIRE,
          K_CHECKPOINT)

# a single frame's payload bound: a checkpoint of `capacity` entries at
# `max_tokens` tokens each stays far under this; anything larger is a
# framing error, not data
MAX_RECORD_BYTES = 1 << 24

FSYNC_POLICIES = ("always", "interrupt", "off")


class WALError(Exception):
    """A segment stopped being trustworthy (torn tail, flipped byte,
    bad magic). Recovery catches it per segment and keeps everything
    already verified; it never propagates into serving."""


def _frame(kind: int, payload: bytes) -> bytes:
    if len(payload) > MAX_RECORD_BYTES:
        raise ValueError(f"WAL record {len(payload)}B exceeds the bound")
    # the CRC covers the KIND byte too: a flipped kind would otherwise
    # reinterpret a perfectly-checksummed payload under the wrong schema
    crc = zlib.crc32(payload, zlib.crc32(bytes([kind])))
    return _FRAME_HEAD.pack(kind, len(payload), crc) + payload


def _iter_frames(data: bytes) -> Any:
    """Yield ``(kind, payload)`` from one segment's bytes, stopping at
    the first frame that cannot be trusted. Raises :class:`WALError`
    AFTER yielding every intact frame — callers keep the verified
    prefix and refuse the rest, which is the whole recovery contract."""
    if len(data) < len(MAGIC) + _U32.size:
        raise WALError("segment shorter than its header")
    if data[:len(MAGIC)] != MAGIC:
        raise WALError(f"bad segment magic {data[:len(MAGIC)]!r}")
    (version,) = _U32.unpack_from(data, len(MAGIC))
    if version != WIRE_VERSION:
        raise WALError(f"segment speaks WAL version {version}")
    pos = len(MAGIC) + _U32.size
    while pos < len(data):
        if len(data) - pos < _FRAME_HEAD.size:
            raise WALError("torn frame head at segment tail")
        kind, length, crc = _FRAME_HEAD.unpack_from(data, pos)
        if kind not in _KINDS or length > MAX_RECORD_BYTES:
            raise WALError(f"unparseable frame (kind {kind}, len {length})")
        start = pos + _FRAME_HEAD.size
        payload = data[start:start + length]
        if len(payload) != length:
            raise WALError("torn frame payload at segment tail")
        if zlib.crc32(payload, zlib.crc32(bytes([kind]))) != crc:
            raise WALError(f"frame failed its CRC at offset {pos}")
        pos = start + length
        yield kind, payload


class _EntryState:
    """One entry's replayed/live state: the WAL's own mirror, used both
    by recovery and by rotation checkpoints (the journal's JournalEntry
    objects are not reachable from here, and must not be — the WAL
    stays import-light and single-purpose)."""

    __slots__ = ("entry_id", "key", "model", "max_new_tokens", "seeded",
                 "deterministic", "tokens", "status", "reason")

    def __init__(self, entry_id: int, key: str, model: str,
                 max_new_tokens: int, seeded: bool, deterministic: bool,
                 tokens: Optional[list[int]] = None, status: str = "open",
                 reason: str = ""):
        self.entry_id = entry_id
        self.key = key
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.seeded = seeded
        self.deterministic = deterministic
        self.tokens: list[int] = list(tokens or ())
        self.status = status  # open | interrupted | done
        self.reason = reason

    def to_json(self) -> dict[str, Any]:
        return {
            "id": self.entry_id, "key": self.key, "model": self.model,
            "mnt": self.max_new_tokens, "seeded": self.seeded,
            "det": self.deterministic, "tokens": self.tokens,
            "status": self.status, "reason": self.reason,
        }

    @classmethod
    def from_json(cls, raw: dict[str, Any]) -> "_EntryState":
        return cls(
            int(raw["id"]), str(raw["key"]), str(raw["model"]),
            int(raw["mnt"]), bool(raw["seeded"]), bool(raw["det"]),
            tokens=[int(t) for t in raw.get("tokens") or ()],
            status=str(raw.get("status") or "open"),
            reason=str(raw.get("reason") or ""),
        )


class JournalWAL:
    """The segmented on-disk log. Thread-safe: one internal lock covers
    append+rotate (emitting threads are per-request; the per-token
    append is a dict lookup, a small struct pack, and one buffered
    ``write``)."""

    def __init__(self, directory: str, segment_bytes: int = 1 << 20,
                 retain: int = 4, fsync: str = "interrupt",
                 logger: Any = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"JOURNAL_FSYNC '{fsync}' not one of {FSYNC_POLICIES}"
            )
        self.directory = directory
        self.segment_bytes = max(4096, int(segment_bytes))
        self.retain = max(1, int(retain))
        self.fsync_policy = fsync
        self.logger = logger
        self._lock = threading.Lock()
        self._file: Optional[Any] = None
        self._seq = 0
        self._size = 0
        self._next_id = 1
        self._live: dict[int, _EntryState] = {}
        self._closed = False
        # recovery evidence, surfaced on /admin/engine journal.wal
        self.recovered_entries = 0
        self.torn_segments = 0
        self.dropped_records = 0
        os.makedirs(self.directory, exist_ok=True)

    # -- recovery --------------------------------------------------------------
    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.directory, f"wal-{seq:08d}.log")

    def _list_segments(self) -> list[int]:
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            if name.startswith("wal-") and name.endswith(".log"):
                try:
                    out.append(int(name[4:-4]))
                except ValueError:
                    continue
        return sorted(out)

    def recover(self) -> list[dict[str, Any]]:
        """Replay every segment and return the RESUMABLE entries (final
        state ``interrupted``, or ``open`` with no terminal record — the
        SIGKILL signature), oldest first, as plain dicts the journal
        rehydrates from. Also positions the writer: appends go to a
        fresh segment with ids above everything seen, so a rehydrated
        entry can never collide with a new one."""
        entries: dict[int, _EntryState] = {}
        max_id = 0
        for seq in self._list_segments():
            self._seq = max(self._seq, seq)
            try:
                with open(self._segment_path(seq), "rb") as f:
                    data = f.read()
            except OSError:
                self.torn_segments += 1
                continue
            try:
                for kind, payload in _iter_frames(data):
                    try:
                        replayed = self._replay(entries, kind, payload)
                    except (ValueError, KeyError, struct.error) as exc:
                        # a CRC-valid frame whose payload still fails to
                        # parse means the WRITER was broken, not the
                        # disk — refuse the rest of the segment exactly
                        # like a torn tail
                        raise WALError(f"unreplayable frame: {exc}") from exc
                    max_id = max(max_id, replayed)
            except WALError as exc:
                # a torn tail after SIGKILL-mid-append is the EXPECTED
                # shape; everything before it was CRC-verified and kept
                self.torn_segments += 1
                if self.logger is not None:
                    self.logger.warnf(
                        "journal WAL segment %s torn: %s (kept the "
                        "verified prefix)", seq, exc,
                    )
        resumable = [
            e for e in sorted(entries.values(), key=lambda e: e.entry_id)
            if e.status in ("open", "interrupted")
        ]
        for state in resumable:
            if state.status == "open":
                state.status = "interrupted"
                state.reason = "process death (recovered from WAL)"
        self.recovered_entries = len(resumable)
        self._next_id = max_id + 1
        return [s.to_json() for s in resumable]

    def _replay(self, entries: dict[int, _EntryState], kind: int,
                payload: bytes) -> int:
        """Apply one replayed record; returns the highest entry id it
        referenced. Records referencing unknown ids (their open record
        lived in a lost segment prefix) are counted and dropped — an
        entry whose identity cannot be proven is never installed."""
        if kind == K_CHECKPOINT:
            snap = json.loads(payload.decode("utf-8"))
            top = 0
            for raw in snap.get("entries", ()):
                state = _EntryState.from_json(raw)
                entries[state.entry_id] = state
                top = max(top, state.entry_id)
            return max(top, int(snap.get("next_id", 1)) - 1)
        if kind == K_OPEN:
            raw = json.loads(payload.decode("utf-8"))
            state = _EntryState.from_json(raw)
            entries[state.entry_id] = state
            return state.entry_id
        if kind == K_TOKENS:
            (entry_id,) = _U32.unpack_from(payload)
            state = entries.get(entry_id)
            n = (len(payload) - _U32.size) // 4
            tokens = struct.unpack_from(f"<{n}i", payload, _U32.size)
            if state is None or state.status != "open":
                self.dropped_records += 1
            else:
                state.tokens.extend(tokens)
            return entry_id
        if kind == K_INTERRUPT:
            raw = json.loads(payload.decode("utf-8"))
            entry_id = int(raw["id"])
            state = entries.get(entry_id)
            if state is None:
                self.dropped_records += 1
            else:
                state.status = "interrupted"
                state.reason = str(raw.get("reason") or "")
            return entry_id
        # finish / claim / retire: the entry stopped being resumable
        (entry_id,) = _U32.unpack_from(payload)
        state = entries.get(entry_id)
        if state is not None:
            state.status = "done"
        return entry_id

    # -- writing ---------------------------------------------------------------
    def _open_segment(self) -> None:
        self._seq += 1
        path = self._segment_path(self._seq)
        self._file = open(path, "wb")
        self._file.write(MAGIC + _U32.pack(WIRE_VERSION))
        self._size = len(MAGIC) + _U32.size
        if self._live:
            snap = json.dumps(
                {"entries": [s.to_json() for s in self._live.values()],
                 "next_id": self._next_id},
                separators=(",", ":"),
            ).encode("utf-8")
            frame = _frame(K_CHECKPOINT, snap)
            self._file.write(frame)
            self._size += len(frame)
        self._file.flush()
        self._sync(force=True)
        for seq in self._list_segments()[:-self.retain]:
            try:
                os.remove(self._segment_path(seq))
            except OSError:
                pass

    def _sync(self, force: bool = False) -> None:
        if self._file is None or self.fsync_policy == "off":
            return
        if self.fsync_policy == "always" or force:
            try:
                os.fsync(self._file.fileno())
            except OSError:
                pass

    def _append(self, kind: int, payload: bytes, force_sync: bool = False,
                ) -> None:
        frame = _frame(kind, payload)
        with self._lock:
            if self._closed:
                return
            if self._file is None or self._size + len(frame) > (
                self.segment_bytes
            ):
                if self._file is not None:
                    self._file.flush()
                    self._sync(force=True)
                    self._file.close()
                self._open_segment()
            self._file.write(frame)
            self._size += len(frame)
            # flush ALWAYS: buffered bytes die with the process, and
            # process death is the threat model — the flush hands them
            # to the kernel, which survives SIGKILL; fsync (policy) is
            # for the power-loss threat model only
            self._file.flush()
            self._sync(force=force_sync)

    # -- journal-facing API ----------------------------------------------------
    def open_entry(self, key: str, model: str, max_new_tokens: int,
                   seeded: bool, deterministic: bool,
                   prior: Optional[list] = None) -> int:
        with self._lock:
            entry_id = self._next_id
            self._next_id += 1
            self._live[entry_id] = _EntryState(
                entry_id, key, model, max_new_tokens, seeded, deterministic,
                tokens=list(prior or ()),
            )
        state = self._live[entry_id]
        self._append(
            K_OPEN,
            json.dumps(state.to_json(), separators=(",", ":")).encode("utf-8"),
        )
        return entry_id

    def append_tokens(self, entry_id: int, tokens: Any) -> None:
        tokens = [int(t) for t in tokens]
        if not tokens:
            return
        # frame FIRST, mirror second: _append may rotate, and the
        # rotation checkpoint snapshots the mirror — updated before the
        # frame, the checkpoint would already contain this batch and
        # the K_TOKENS frame following it would replay it a SECOND time
        # on recovery (a duplicated token = a corrupted resume prefix)
        self._append(
            K_TOKENS,
            _U32.pack(entry_id) + struct.pack(f"<{len(tokens)}i", *tokens),
        )
        with self._lock:
            state = self._live.get(entry_id)
            if state is not None:
                state.tokens.extend(tokens)

    def finish(self, entry_id: int) -> None:
        self._forget(entry_id)
        self._append(K_FINISH, _U32.pack(entry_id))

    def claim(self, entry_id: int) -> None:
        self._forget(entry_id)
        self._append(K_CLAIM, _U32.pack(entry_id))

    def retire(self, entry_id: int) -> None:
        """Capacity eviction / truncation: the entry stops being
        resumable without having completed."""
        self._forget(entry_id)
        self._append(K_RETIRE, _U32.pack(entry_id))

    def interrupt(self, entry_id: int, reason: str) -> None:
        with self._lock:
            state = self._live.get(entry_id)
            if state is not None:
                state.status = "interrupted"
                state.reason = reason
        self._append(
            K_INTERRUPT,
            json.dumps({"id": entry_id, "reason": reason[:500]},
                       separators=(",", ":")).encode("utf-8"),
            # the record resume depends on: fsync under the default
            # policy, so even power loss right after an engine failure
            # keeps the interruption durable
            force_sync=True,
        )

    def adopt(self, entry_id: int, state: dict[str, Any]) -> None:
        """Re-track a RECOVERED entry as live (rehydration calls this so
        a later claim/eviction writes its terminal record, and rotation
        checkpoints carry it)."""
        with self._lock:
            self._live[entry_id] = _EntryState.from_json(state)

    def _forget(self, entry_id: int) -> None:
        with self._lock:
            self._live.pop(entry_id, None)

    # -- lifecycle / read side -------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._file is not None:
                self._file.flush()
                self._sync(force=True)
                self._file.close()
                self._file = None

    def stats(self) -> dict[str, Any]:
        segments = self._list_segments()
        size = 0
        for seq in segments:
            try:
                size += os.path.getsize(self._segment_path(seq))
            except OSError:
                pass
        with self._lock:
            live = len(self._live)
        return {
            "dir": self.directory,
            "segments": len(segments),
            "bytes": size,
            "segment_bytes": self.segment_bytes,
            "retain": self.retain,
            "fsync": self.fsync_policy,
            "live_entries": live,
            "recovered_entries": self.recovered_entries,
            "torn_segments": self.torn_segments,
            "dropped_records": self.dropped_records,
        }
