"""The port's KV wire format (``gofr_tpu_torch/fleet/kvwire.py``) held to
the JAX package's ``tests/test_kv_transfer.py`` wire units (every way a
transfer stream can lie is detected, never installed), and against the JAX
``kvwire`` itself: the encoder's bytes are identical for the same spec and
payloads, and each package decodes the other's stream, truncations and bit
flips included, with the same exception class names and ``outcome``s."""

import random

import numpy as np
import pytest

from gofr_tpu.fleet import kvwire as jax_kvwire
from gofr_tpu_torch.fleet import kvwire


def _entry_bytes(spec, payloads):
    return b"".join(kvwire.encode_entry(spec, payloads))


def _spec(payloads, **extra):
    spec = {"kind": "host-tokens", "block_tokens": 4,
            "prompt_hash": "ab" * 16, "length": 7,
            "n_blocks": len(payloads), "meta": {"length": 7}}
    spec.update(extra)
    return spec


def test_wire_roundtrip_and_chunk_boundary_agnosticism():
    payloads = [b"abcd" * 4, b"wxyz"]
    raw = _entry_bytes(_spec(payloads), payloads)
    # whole-buffer decode
    header, got = kvwire.decode_stream([raw])
    assert got == payloads
    assert header["version"] == kvwire.WIRE_VERSION
    assert header["prompt_hash"] == "ab" * 16
    # byte-by-byte: frame boundaries never align with feed boundaries
    decoder = kvwire.WireDecoder()
    events = []
    for i in range(len(raw)):
        events.extend(decoder.feed(raw[i:i + 1]))
    decoder.finish()
    assert [e[0] for e in events] == ["header", "block", "block", "end"]
    assert [e[2] for e in events if e[0] == "block"] == payloads


def test_wire_bit_flip_fails_the_blocks_own_crc():
    payloads = [b"abcd" * 4, b"wxyz"]
    raw = bytearray(_entry_bytes(_spec(payloads), payloads))
    # flip one bit inside the SECOND block's payload (the last 16 bytes
    # are the trailer frame; the 4-byte payload sits just before it)
    flip_at = len(raw) - 18
    raw[flip_at] ^= 0x01
    with pytest.raises(kvwire.ChecksumMismatch, match="CRC"):
        kvwire.decode_stream([bytes(raw)])


def test_wire_truncation_is_detected_by_the_missing_trailer():
    payloads = [b"abcd" * 4, b"wxyz"]
    raw = _entry_bytes(_spec(payloads), payloads)
    for cut in (len(raw) - 17, len(raw) // 2, 30):
        with pytest.raises(kvwire.Truncated):
            kvwire.decode_stream([raw[:cut]])


def test_wire_trailer_count_mismatch_is_truncation():
    payloads = [b"abcd"]
    frames = [kvwire.encode_header(_spec(payloads)),
              kvwire.encode_block(0, payloads[0]),
              kvwire.encode_trailer(2)]  # promises a block that never came
    with pytest.raises(kvwire.Truncated, match="promises 2"):
        kvwire.decode_stream(frames)


def test_wire_mis_sized_trailer_stays_inside_the_error_contract():
    """A CRC-valid trailer whose payload is not exactly 4 bytes must be
    a KVWireError (corrupt), never a struct.error escaping the decoder
    contract."""
    import struct
    import zlib

    payloads = [b"abcd"]
    frames = list(kvwire.encode_entry(_spec(payloads), payloads))
    bad_payload = b"\x01\x00\x00"  # 3 bytes, CRC freshly computed
    frames[-1] = struct.pack(
        "<III", kvwire.END_INDEX, len(bad_payload), zlib.crc32(bad_payload)
    ) + bad_payload
    with pytest.raises(kvwire.ChecksumMismatch):
        kvwire.decode_stream([b"".join(frames)])


def test_wire_out_of_order_and_post_trailer_bytes_rejected():
    payloads = [b"abcd", b"efgh"]
    frames = [kvwire.encode_header(_spec(payloads)),
              kvwire.encode_block(1, payloads[1])]  # skipped index 0
    with pytest.raises(kvwire.ChecksumMismatch, match="out of order"):
        kvwire.decode_stream(frames)
    good = _entry_bytes(_spec(payloads), payloads)
    with pytest.raises(kvwire.ChecksumMismatch, match="after the trailer"):
        kvwire.decode_stream([good + b"x"])


def test_wire_version_skew_refused_before_any_payload():
    # bad magic
    with pytest.raises(kvwire.VersionSkew, match="magic"):
        kvwire.WireDecoder().feed(b"NOPE" + b"\x00" * 8)
    # wrong version number
    raw = kvwire.MAGIC + _u32(b'{"version":99}')
    with pytest.raises(kvwire.VersionSkew, match="99"):
        kvwire.WireDecoder().feed(raw)
    # unparseable / non-object headers
    for body in (b"not json", b"[1,2]"):
        with pytest.raises(kvwire.VersionSkew):
            kvwire.WireDecoder().feed(kvwire.MAGIC + _u32(body))
    # arena spec divergence
    header = {"kind": "host-tokens", "block_tokens": 8}
    with pytest.raises(kvwire.VersionSkew, match="block_tokens"):
        kvwire.check_spec(header, {"kind": "host-tokens", "block_tokens": 4})


def _u32(body: bytes) -> bytes:
    import struct

    return struct.pack("<I", len(body)) + body


def test_wire_oversized_claims_rejected():
    import struct

    head = struct.pack("<III", 0, kvwire.MAX_BLOCK_BYTES + 1, 0)
    decoder = kvwire.WireDecoder()
    decoder.feed(_entry_bytes(_spec([]), [])[: len(kvwire.MAGIC)])
    with pytest.raises(kvwire.KVWireError):
        # a frame claiming more than any block can hold is a framing
        # error the receiver must not buffer toward
        full = kvwire.WireDecoder()
        full.feed(kvwire.encode_header(_spec([])))
        full.feed(head)
    with pytest.raises(ValueError, match="bound"):
        kvwire.encode_block(0, b"x" * (kvwire.MAX_BLOCK_BYTES + 1))


def test_wire_frames_beyond_header_claim_rejected_before_buffering():
    """A donor streaming more frames than its header claims must be
    cut off at the first excess frame — NOT buffered until a post-hoc
    count check (that gap was an unbounded-memory hole)."""
    payloads = [b"abcd"]
    frames = [kvwire.encode_header(_spec(payloads)),
              kvwire.encode_block(0, payloads[0]),
              kvwire.encode_block(1, b"excess")]
    with pytest.raises(kvwire.ChecksumMismatch, match="claim"):
        kvwire.decode_stream(frames)
    # fewer blocks than claimed (consistent trailer) is truncation
    short = [kvwire.encode_header(_spec([b"abcd", b"efgh"])),
             kvwire.encode_block(0, b"abcd"),
             kvwire.encode_trailer(1)]
    with pytest.raises(kvwire.Truncated, match="short of the header"):
        kvwire.decode_stream(short)


def test_wire_header_claim_bounded_by_receiver_expectation():
    """The receiver knows how many blocks the prompt can need; a donor
    claiming more is refused at the header."""
    payloads = [b"abcd", b"efgh"]
    raw = _entry_bytes(_spec(payloads), payloads)
    with pytest.raises(kvwire.VersionSkew, match="at most 1"):
        kvwire.decode_stream([raw], max_blocks=1)
    header, got = kvwire.decode_stream([raw], max_blocks=2)
    assert got == payloads
    for bad in (None, -1, "2", 1.5, True):
        with pytest.raises(kvwire.VersionSkew, match="n_blocks"):
            kvwire.decode_stream(
                [_entry_bytes(_spec(payloads, n_blocks=bad), payloads)]
            )


def test_parse_kv_hint_accepts_only_peer_base_urls():
    ok = kvwire.parse_kv_hint
    assert ok("http://10.0.0.5:8000") == "http://10.0.0.5:8000"
    assert ok("https://replica-3.fleet.local") == "https://replica-3.fleet.local"
    assert ok(" http://r1:9000/ ") == "http://r1:9000"
    for bad in (
        None, "", "r1:8000", "ftp://r1", "http://", "http://r1/admin/kv",
        "http://user:pw@r1:8000", "http://r1:8000?x=1", "http://r1:8000#f",
        "http://r1:abc", "http://" + "a" * 300,
    ):
        assert ok(bad) is None, bad


def test_prompt_hash_matches_cache_key_hash():
    ids = np.asarray([5, 6, 7, 8], np.int32)
    assert kvwire.prompt_hash([5, 6, 7, 8]) == kvwire.hash_of_key(ids.tobytes())




# -- the port against the JAX kvwire -----------------------------------------

def _random_entry(seed):
    """A seeded spec and payloads: host-token and device-kv specs, 0 to 5
    blocks of 0 to 3 KiB, and unicode in the meta."""
    rng = random.Random(seed)
    n = rng.randint(0, 5)
    payloads = [rng.randbytes(rng.randint(0, 3072)) for _ in range(n)]
    spec = {
        "kind": rng.choice(["host-tokens", "device-kv"]), "block_tokens": rng.choice([4, 16, 64]),
        "prompt_hash": rng.randbytes(16).hex(), "length": rng.randint(1, 4096), "n_blocks": n,
        "dtype": rng.choice(["bfloat16", "float32", "float8_e4m3fn"]),
        "block_shape": [2, 16, 2, 16], "model": "tiny", "identity": rng.randbytes(8).hex(),
        "meta": {"length": 7, "next_token": rng.randint(0, 255), "note": "ü→✓"},
    }
    return spec, payloads


@pytest.mark.parametrize("seed", range(8))
def test_encoder_bytes_equal_jax(seed):
    """Header, every block frame and the trailer are byte-identical to the
    JAX encoder's for the same spec and payloads."""
    spec, payloads = _random_entry(seed)
    assert kvwire.encode_header(spec) == jax_kvwire.encode_header(spec)
    for j, payload in enumerate(payloads):
        assert kvwire.encode_block(j, payload) == jax_kvwire.encode_block(j, payload)
    assert kvwire.encode_trailer(len(payloads)) == jax_kvwire.encode_trailer(len(payloads))
    assert b"".join(kvwire.encode_entry(spec, payloads)) == \
        b"".join(jax_kvwire.encode_entry(spec, payloads))
    for name in ("MAGIC", "WIRE_VERSION", "END_INDEX", "MAX_BLOCK_BYTES", "MAX_HEADER_BYTES",
                 "CONTENT_TYPE", "TRANSFER_OUTCOMES"):
        assert getattr(kvwire, name) == getattr(jax_kvwire, name)


def _decode(mod, raw, chunk, max_blocks=None):
    """(header, payloads) or (exception class name, outcome) of one
    package's decoder over ``raw`` fed in ``chunk``-byte reads."""
    try:
        return mod.decode_stream(
            [raw[i:i + chunk] for i in range(0, len(raw), chunk)], max_blocks=max_blocks
        )
    except mod.KVWireError as exc:
        return type(exc).__name__, exc.outcome


def _damaged(raw, seed):
    """The stream itself, truncated at every kind of point, one bit flipped
    in the header, a frame head or a payload, and bytes after the trailer."""
    rng = random.Random(seed)
    out = [raw, raw + b"x"]
    for cut in {0, 3, 9, len(raw) // 2, len(raw) - 1, len(raw) - 13}:
        if 0 <= cut < len(raw):
            out.append(raw[:cut])
    for _ in range(6):
        at = rng.randrange(len(raw))
        flipped = bytearray(raw)
        flipped[at] ^= 1 << rng.randint(0, 7)
        out.append(bytes(flipped))
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_decodes_the_others_stream(seed, writer):
    """A stream written by either package decodes in both to the same
    header and payloads, and every truncation and bit flip of it fails in
    both with the same exception class and outcome."""
    spec, payloads = _random_entry(seed)
    enc = jax_kvwire if writer == "jax" else kvwire
    raw = b"".join(enc.encode_entry(spec, payloads))
    header, got = _decode(kvwire, raw, 7)
    assert got == payloads and header == dict(spec, version=kvwire.WIRE_VERSION)
    for bad in _damaged(raw, seed):
        for chunk in (1, 64, 1 << 20):
            for max_blocks in (None, len(payloads), max(len(payloads) - 1, 0)):
                assert _decode(kvwire, bad, chunk, max_blocks) == \
                    _decode(jax_kvwire, bad, chunk, max_blocks)


def test_spec_checks_and_hashes_agree_with_jax():
    """prompt_hash, hash_of_key, parse_kv_hint and check_spec give the JAX
    answers (and refusals) on the same inputs."""
    rng = np.random.default_rng(14)
    for _ in range(20):
        ids = rng.integers(0, 128256, size=int(rng.integers(1, 300)), dtype=np.int64)
        assert kvwire.prompt_hash(ids) == jax_kvwire.prompt_hash(ids)
        key = np.asarray(ids, np.int32).tobytes()
        assert kvwire.hash_of_key(key) == jax_kvwire.hash_of_key(key)
    for raw in ("http://10.0.0.5:8000", " https://r:1/ ", "http://[::1]:9", "ftp://x",
                "http://u:p@h", "http://h/p", "", None, "http://h:99999"):
        assert kvwire.parse_kv_hint(raw) == jax_kvwire.parse_kv_hint(raw)
    local = {"kind": "device-kv", "block_tokens": 16, "dtype": "bfloat16",
             "block_shape": [2, 16, 2, 16]}
    for header in (dict(local), dict(local, dtype="torch.bfloat16"), dict(local, block_tokens=8),
                   {"kind": "host-tokens", "block_tokens": 16}):
        outcomes = []
        for mod in (kvwire, jax_kvwire):
            try:
                mod.check_spec(header, local)
                outcomes.append("ok")
            except mod.VersionSkew as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1]
