"""The cross-replica paged-KV wire format + the per-request donor hint
(copy of ``gofr_tpu/fleet/kvwire.py``: the bytes are identical, so a JAX
replica and a port replica exchange KV).

Disaggregated prefill/decode hands WARM KV between
replicas: a prefill (or previously-visited) replica serves its cached
block tables over ``GET /admin/kv/<prompt_hash>`` and a decode replica
aliases them straight into its own BlockPool instead of re-prefilling.
A KV transfer is a new distributed failure surface — the donor can
wedge mid-send, the payload can be truncated or bit-flipped in flight,
the entry can be evicted between advertise and pull — so the format is
built to make every failure DETECTABLE by the receiver, which then
falls back to local chunked prefill (the request always completes):

- a versioned magic + JSON header (prompt hash, sampling identity,
  arena wire spec, block count, entry meta) — version/spec skew between
  mismatched replicas is caught before any payload is trusted;
- per-block frames, each carrying its own CRC32 — a flipped byte is
  caught at the block it corrupts, never installed;
- a mandatory trailer frame carrying the block count — a mid-stream
  disconnect (donor killed, socket cut) leaves the trailer missing and
  the partial read is detected instead of half-installed.

The payload encoding is the ARENA's: :class:`HostTokenArena` ships
token ids (the echo runner's "KV"), so the whole protocol — pull,
verify, ingest, alias, fall back — runs compile-free in tier-1;
:class:`TorchKVArena` ships raw per-block k/v bytes. Both sides compare
``wire_spec()`` dicts, so a block-size or dtype mismatch is a clean
version-skew refusal, not silent corruption.

Import-light on purpose (stdlib + numpy): the router, the handlers,
and ``tpu/kv_blocks.py`` all import this module without paying for the
rest of the fleet package — use ``from gofr_tpu_torch.fleet import kvwire``
style imports, never through ``gofr_tpu_torch.fleet``'s __init__ exports.
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import struct
import zlib
from typing import Any, Iterable, Iterator, Optional

import numpy as np

WIRE_VERSION = 1
MAGIC = b"GKV1"
# trailer frame index: no real block table reaches 2**32 - 1 entries
END_INDEX = 0xFFFFFFFF
_U32 = struct.Struct("<I")
_FRAME_HEAD = struct.Struct("<III")  # index, payload_len, crc32
# a single block's payload is bounded by the arena's block_bytes (a few
# MiB for real models); anything past this is a framing error, not data
MAX_BLOCK_BYTES = 1 << 26
MAX_HEADER_BYTES = 1 << 16

CONTENT_TYPE = "application/x-gofr-kv"

TRANSFER_OUTCOMES = ("ok", "timeout", "corrupt", "evicted", "fallback")


class KVWireError(Exception):
    """The transfer stream cannot be trusted; the receiver falls back
    to local prefill. ``outcome`` is the
    ``gofr_tpu_kv_transfer_total{outcome}`` label the failure counts
    under."""

    outcome = "corrupt"


class VersionSkew(KVWireError):
    """The peers speak different wire versions or incompatible arena
    specs (block size, payload kind, dtype/shape) — counted as
    ``corrupt``: the bytes are not installable here, whatever they
    meant to the sender."""


class ChecksumMismatch(KVWireError):
    """A block frame's payload does not match its CRC (or frames arrive
    out of order / oversized) — the transport flipped bytes."""


class Truncated(KVWireError):
    """The stream ended before the trailer frame: the donor died (or
    was killed) mid-send, or an intermediary cut the body."""


def prompt_hash(ids: Any) -> str:
    """The transfer identity of a token sequence: sha256 over its int32
    bytes — EXACTLY the bytes the paged prefix caches key on
    (``ids.tobytes()``), so a donor's cache scan and a receiver's local
    recompute agree without ever shipping the raw prompt (prompts are
    user data; only the hash rides URLs and route records)."""
    ids = np.asarray(ids, np.int32).reshape(-1)
    return hashlib.sha256(ids.tobytes()).hexdigest()[:32]


def hash_of_key(key: bytes) -> str:
    """:func:`prompt_hash` for an already-encoded cache key."""
    return hashlib.sha256(key).hexdigest()[:32]


def transfer_counter(metrics: Any) -> Any:
    """The ONE registration of ``gofr_tpu_kv_transfer_total`` (same
    single-home contract as the deadline counters): the receiving end
    counts each pull's outcome — ok, timeout (donor unreachable/stalled
    past the budget), corrupt (checksum/version/truncation), evicted
    (donor 404: the entry vanished between advertise and pull) — plus
    one ``fallback`` increment whenever the request proceeds on local
    prefill instead."""
    return metrics.counter(
        "gofr_tpu_kv_transfer_total",
        "cross-replica KV-transfer pulls by outcome (ok | timeout | "
        "corrupt | evicted), plus fallback (request completed via "
        "local prefill after a failed pull)",
        labels=("outcome",),
    )


# -- the donor hint ----------------------------------------------------------
# The fleet router stamps X-KV-Donor on decode-bound requests: the base
# URL of the replica that rendezvous-owns the prompt's KV. It travels
# to the device layer exactly like the deadline: a contextvar activated
# at admission, read once by TPU.generate before paged admission.
_kv_hint: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "gofr_kv_donor_hint", default=None
)


def current_kv_hint() -> Optional[str]:
    """The in-flight request's KV-donor base URL, if admission parsed
    one."""
    return _kv_hint.get()


def activate_kv_hint(hint: Optional[str]) -> Any:
    """Bind the donor hint (None clears); handlers run inside a
    per-request copied context, so nothing leaks past the request."""
    return _kv_hint.set(hint)


def parse_kv_hint(raw: Optional[str]) -> Optional[str]:
    """Validate an ``X-KV-Donor`` header into a donor base URL. Only a
    plain ``http(s)://host[:port]`` shape is accepted — the header
    names a PEER REPLICA, and a replica must never be steerable into
    fetching arbitrary URLs (paths, userinfo, or schemes are rejected,
    not sanitized). Garbage returns None: a malformed hint degrades to
    local prefill, never to a 4xx."""
    if not raw:
        return None
    raw = raw.strip()
    if len(raw) > 256:
        return None
    from urllib.parse import urlsplit

    try:
        parts = urlsplit(raw)
    except ValueError:
        return None
    if parts.scheme not in ("http", "https"):
        return None
    if not parts.hostname or parts.username or parts.password:
        return None
    if parts.path not in ("", "/") or parts.query or parts.fragment:
        return None
    try:
        port = parts.port  # raises on garbage like :abc
    except ValueError:
        return None
    host = parts.hostname
    if ":" in host:  # bare IPv6 needs brackets back
        host = f"[{host}]"
    return f"{parts.scheme}://{host}" + (f":{port}" if port else "")


# -- encoding ----------------------------------------------------------------

def encode_header(spec: dict) -> bytes:
    """``MAGIC + u32 length + header json``. ``spec`` must carry
    ``version`` (stamped here), the prompt hash, the arena
    ``wire_spec()`` fields, ``length``, ``n_blocks``, and the entry
    ``meta``."""
    payload = dict(spec)
    payload["version"] = WIRE_VERSION
    body = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_HEADER_BYTES:
        raise ValueError(f"wire header {len(body)}B exceeds the bound")
    return MAGIC + _U32.pack(len(body)) + body


def encode_block(index: int, payload: bytes) -> bytes:
    """One block frame: ``u32 index + u32 len + u32 crc + payload``."""
    if len(payload) > MAX_BLOCK_BYTES:
        raise ValueError(f"block payload {len(payload)}B exceeds the bound")
    return _FRAME_HEAD.pack(index, len(payload), zlib.crc32(payload)) + payload


def encode_trailer(n_blocks: int) -> bytes:
    """The end-of-stream frame: index ``END_INDEX``, payload = the
    block count the receiver must have seen. Its ABSENCE is how a
    partial read is detected."""
    payload = _U32.pack(n_blocks)
    return _FRAME_HEAD.pack(
        END_INDEX, len(payload), zlib.crc32(payload)
    ) + payload


def encode_entry(spec: dict, payloads: Iterable[bytes]) -> Iterator[bytes]:
    """Frame a whole entry (header, blocks in order, trailer) — the
    bench/test convenience; the serving handler streams the same frames
    lazily so pins release on socket close."""
    yield encode_header(spec)
    n = 0
    for payload in payloads:
        yield encode_block(n, payload)
        n += 1
    yield encode_trailer(n)


# -- decoding ----------------------------------------------------------------

class WireDecoder:
    """Incremental decoder: feed raw chunks as they arrive off the
    socket, collect events — chunk boundaries never align with frame
    boundaries on a real wire. Events are ``("header", dict)``,
    ``("block", index, payload)``, ``("end", n_blocks)``. Every
    integrity failure raises a :class:`KVWireError` subclass
    immediately; :meth:`finish` raises :class:`Truncated` unless the
    trailer arrived."""

    def __init__(self, max_blocks: Optional[int] = None) -> None:
        # bytearray + consumed-offset, compacted when the consumed
        # prefix dominates: feed() stays O(bytes) end to end — a
        # `bytes += chunk` buffer re-copies every buffered byte per
        # chunk, which on MiB device blocks arriving in 8 KiB reads is
        # exactly the transfer latency the bench gate measures
        self._buf = bytearray()
        self._pos = 0
        self._header: Optional[dict] = None
        self._blocks_seen = 0
        self._ended = False
        # receiver-side bound: the caller knows how many blocks the
        # prompt can legitimately need; a donor claiming more is
        # refused at the header, before any payload is buffered
        self._max_blocks = max_blocks
        self._expect_blocks: Optional[int] = None

    def _remaining(self) -> int:
        return len(self._buf) - self._pos

    def feed(self, chunk: bytes) -> list:
        if chunk:
            self._buf += chunk
        events: list = []
        while True:
            event = self._next_event()
            if event is None:
                if self._pos and self._pos * 2 >= len(self._buf):
                    del self._buf[:self._pos]
                    self._pos = 0
                return events
            events.append(event)

    def _next_event(self) -> Optional[tuple]:
        if self._ended and self._remaining():
            raise ChecksumMismatch("bytes after the trailer frame")
        if self._header is None:
            return self._parse_header()
        if self._remaining() < _FRAME_HEAD.size:
            return None
        index, length, crc = _FRAME_HEAD.unpack_from(self._buf, self._pos)
        if (
            index != END_INDEX
            and self._expect_blocks is not None
            and index >= self._expect_blocks
        ):
            # refuse BEFORE buffering the payload: without this a donor
            # could stream unbounded frames past the header's claim and
            # balloon receiver memory until the post-hoc count check
            raise ChecksumMismatch(
                f"frame {index} beyond the header's "
                f"{self._expect_blocks}-block claim"
            )
        if length > MAX_BLOCK_BYTES:
            raise ChecksumMismatch(
                f"frame {index} claims {length}B (bound {MAX_BLOCK_BYTES})"
            )
        if self._remaining() < _FRAME_HEAD.size + length:
            return None
        start = self._pos + _FRAME_HEAD.size
        payload = bytes(self._buf[start:start + length])
        self._pos = start + length
        if zlib.crc32(payload) != crc:
            raise ChecksumMismatch(f"frame {index} failed its CRC")
        if index == END_INDEX:
            if len(payload) != _U32.size:
                # a CRC-valid but mis-sized trailer must stay inside
                # the KVWireError contract, not escape as struct.error
                raise ChecksumMismatch(
                    f"trailer payload is {length}B (expected {_U32.size})"
                )
            (count,) = _U32.unpack(payload)
            if count != self._blocks_seen:
                raise Truncated(
                    f"trailer promises {count} blocks, saw {self._blocks_seen}"
                )
            if (
                self._expect_blocks is not None
                and count != self._expect_blocks
            ):
                raise Truncated(
                    f"trailer count {count} short of the header's "
                    f"{self._expect_blocks}-block claim"
                )
            self._ended = True
            return ("end", count)
        if index != self._blocks_seen:
            raise ChecksumMismatch(
                f"frame {index} arrived out of order (expected "
                f"{self._blocks_seen})"
            )
        self._blocks_seen += 1
        return ("block", index, payload)

    def _parse_header(self) -> Optional[tuple]:
        if self._remaining() < len(MAGIC) + _U32.size:
            return None
        magic = bytes(self._buf[self._pos:self._pos + len(MAGIC)])
        if magic != MAGIC:
            raise VersionSkew(
                f"bad magic {magic!r} (speaking {MAGIC.decode()}?)"
            )
        (length,) = _U32.unpack_from(self._buf, self._pos + len(MAGIC))
        if length > MAX_HEADER_BYTES:
            raise VersionSkew(f"header claims {length}B (bound exceeded)")
        if self._remaining() < len(MAGIC) + _U32.size + length:
            return None
        start = self._pos + len(MAGIC) + _U32.size
        body = bytes(self._buf[start:start + length])
        self._pos = start + length
        try:
            header = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as exc:
            raise VersionSkew(f"unparseable header: {exc}") from exc
        if not isinstance(header, dict):
            raise VersionSkew("header is not an object")
        if header.get("version") != WIRE_VERSION:
            raise VersionSkew(
                f"wire version {header.get('version')!r} "
                f"(this replica speaks {WIRE_VERSION})"
            )
        n_blocks = header.get("n_blocks")
        if (
            not isinstance(n_blocks, int)
            or isinstance(n_blocks, bool)
            or n_blocks < 0
        ):
            raise VersionSkew(f"header n_blocks {n_blocks!r} is not a count")
        if self._max_blocks is not None and n_blocks > self._max_blocks:
            raise VersionSkew(
                f"header claims {n_blocks} blocks; this receiver expects "
                f"at most {self._max_blocks}"
            )
        self._expect_blocks = n_blocks
        self._header = header
        return ("header", header)

    @property
    def complete(self) -> bool:
        return self._ended

    def finish(self) -> None:
        if not self._ended:
            raise Truncated(
                "stream ended before the trailer frame "
                f"({self._blocks_seen} blocks received)"
            )


def decode_stream(
    chunks: Iterable[bytes], max_blocks: Optional[int] = None
) -> tuple[dict, list[bytes]]:
    """Decode a whole pull: returns ``(header, ordered block payloads)``
    or raises a :class:`KVWireError` subclass the moment the stream
    stops being trustworthy. Pass ``max_blocks`` (the count the prompt
    can legitimately need) so an over-claiming donor is refused at the
    header instead of buffered."""
    decoder = WireDecoder(max_blocks=max_blocks)
    header: Optional[dict] = None
    payloads: list[bytes] = []
    for chunk in chunks:
        for event in decoder.feed(chunk):
            if event[0] == "header":
                header = event[1]
            elif event[0] == "block":
                payloads.append(event[2])
    decoder.finish()
    assert header is not None  # finish() raised otherwise
    return header, payloads


def check_spec(header: dict, local_spec: dict) -> None:
    """Compare the donor's arena wire spec against the local arena's;
    any divergence is :class:`VersionSkew` (the payload cannot be
    installed here)."""
    for field, want in local_spec.items():
        got = header.get(field)
        if got != want:
            raise VersionSkew(
                f"arena spec mismatch on {field!r}: donor sent {got!r}, "
                f"local arena wants {want!r}"
            )
