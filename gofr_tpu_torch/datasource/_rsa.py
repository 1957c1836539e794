"""Pure-stdlib RSA-OAEP(SHA1) — the `cryptography` fallback for the
MySQL ``caching_sha2_password`` full-auth exchange (copy of
``gofr_tpu/datasource/_rsa.py``).

MySQL's non-TLS full auth encrypts the nonce-whitened password with the
server's RSA public key under OAEP/MGF1-SHA1. The client normally uses
the ``cryptography`` package for this; environments without it (a
serving container may ship no OpenSSL bindings) would otherwise
lose the full-auth path entirely — including the in-process
:class:`~gofr_tpu_torch.datasource.minimysql.MiniMySQL` tests that prove the
client drives the sub-protocol correctly. This module implements just
enough, in auditable stdlib Python:

- OAEP-SHA1 encrypt against a PEM/DER ``SubjectPublicKeyInfo`` key
  (the shape a real MySQL server hands over in the key packet);
- key generation + OAEP-SHA1 decrypt for the FAKE server side.

Scope warning: textbook modular exponentiation is not constant-time.
That is acceptable here — the encrypt path protects a password in
transit against a PASSIVE observer exactly as the real exchange does,
and the decrypt path exists only inside the test fake. When
``cryptography`` is installed, callers prefer it (see
``mysql.rsa_encrypt_password``).
"""

from __future__ import annotations

import base64
import hashlib
import os
from typing import Optional

_SHA1_LEN = 20


# -- minimal DER --------------------------------------------------------------

def _der_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _der_int(value: int) -> bytes:
    body = value.to_bytes((value.bit_length() + 8) // 8 or 1, "big")
    return b"\x02" + _der_len(len(body)) + body


def _der_seq(*parts: bytes) -> bytes:
    body = b"".join(parts)
    return b"\x30" + _der_len(len(body)) + body


class _DERReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def _read_len(self) -> int:
        first = self._data[self._pos]
        self._pos += 1
        if first < 0x80:
            return first
        n_bytes = first & 0x7F
        if n_bytes == 0 or n_bytes > 4:
            raise ValueError("unsupported DER length encoding")
        value = int.from_bytes(
            self._data[self._pos:self._pos + n_bytes], "big"
        )
        self._pos += n_bytes
        return value

    def expect(self, tag: int) -> bytes:
        if self._pos >= len(self._data) or self._data[self._pos] != tag:
            raise ValueError(
                f"DER tag 0x{tag:02x} expected at offset {self._pos}"
            )
        self._pos += 1
        length = self._read_len()
        body = self._data[self._pos:self._pos + length]
        if len(body) != length:
            raise ValueError("DER value truncated")
        self._pos += length
        return body


# OID 1.2.840.113549.1.1.1 (rsaEncryption) + NULL params
_RSA_ALG_ID = bytes.fromhex("300d06092a864886f70d0101010500")


def load_public_key(pem_or_der: bytes) -> tuple[int, int]:
    """Parse a SubjectPublicKeyInfo (PEM or raw DER) into ``(n, e)``."""
    data = pem_or_der.strip()
    if data.startswith(b"-----"):
        lines = [
            line for line in data.splitlines()
            if line and not line.startswith(b"-----")
        ]
        data = base64.b64decode(b"".join(lines), validate=True)
    spki = _DERReader(data)
    inner = _DERReader(spki.expect(0x30))
    if inner.expect(0x30) != _RSA_ALG_ID[2:]:
        raise ValueError("not an rsaEncryption SubjectPublicKeyInfo")
    bitstring = inner.expect(0x03)
    if not bitstring or bitstring[0] != 0:
        raise ValueError("unsupported BIT STRING padding")
    rsa_key = _DERReader(bitstring[1:])
    seq = _DERReader(rsa_key.expect(0x30))
    n = int.from_bytes(seq.expect(0x02), "big")
    e = int.from_bytes(seq.expect(0x02), "big")
    return n, e


def public_key_pem(n: int, e: int) -> bytes:
    """Encode ``(n, e)`` as a PEM SubjectPublicKeyInfo — byte-compatible
    with what ``cryptography`` (and a real MySQL server) emits."""
    rsa_key = _der_seq(_der_int(n), _der_int(e))
    spki = _der_seq(_RSA_ALG_ID, b"\x03" + _der_len(len(rsa_key) + 1)
                    + b"\x00" + rsa_key)
    b64 = base64.b64encode(spki)
    body = b"\n".join(b64[i:i + 64] for i in range(0, len(b64), 64))
    return (b"-----BEGIN PUBLIC KEY-----\n" + body
            + b"\n-----END PUBLIC KEY-----\n")


# -- key generation (test-fake server side) -----------------------------------

_SMALL_PRIMES = (
    3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
    67, 71, 73, 79, 83, 89, 97,
)


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = int.from_bytes(os.urandom((n.bit_length() + 7) // 8), "big")
        a = a % (n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        candidate = int.from_bytes(os.urandom(bits // 8), "big")
        candidate |= (1 << (bits - 1)) | 1  # full width, odd
        if _is_probable_prime(candidate):
            return candidate


class PrivateKey:
    """An RSA keypair for the fake server: holds ``(n, e, d)``; the
    public half exports as PEM for the wire."""

    def __init__(self, n: int, e: int, d: int):
        self.n = n
        self.e = e
        self.d = d

    def public_pem(self) -> bytes:
        return public_key_pem(self.n, self.e)

    def decrypt_oaep_sha1(self, ciphertext: bytes) -> bytes:
        return _oaep_decrypt(self, ciphertext)


def generate_key(bits: int = 1024) -> PrivateKey:
    """Generate an RSA keypair. 1024 bits keeps test-fake keygen fast;
    the strength of the TEST exchange is not a production property
    (a real server brings its own key)."""
    e = 65537
    while True:
        p = _random_prime(bits // 2)
        q = _random_prime(bits // 2)
        if p == q:
            continue
        n = p * q
        phi = (p - 1) * (q - 1)
        if phi % e == 0:
            continue
        d = pow(e, -1, phi)
        return PrivateKey(n, e, d)


# -- OAEP (SHA1 / MGF1-SHA1, empty label) -------------------------------------

def _mgf1(seed: bytes, length: int) -> bytes:
    out = b""
    counter = 0
    while len(out) < length:
        out += hashlib.sha1(seed + counter.to_bytes(4, "big")).digest()
        counter += 1
    return out[:length]


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def oaep_encrypt(pub: tuple[int, int], message: bytes,
                 seed: Optional[bytes] = None) -> bytes:
    """RSAES-OAEP-ENCRYPT (RFC 8017 §7.1.1) with SHA1/MGF1-SHA1 and an
    empty label — the parameters MySQL's full-auth exchange fixes."""
    n, e = pub
    k = (n.bit_length() + 7) // 8
    if len(message) > k - 2 * _SHA1_LEN - 2:
        raise ValueError(f"message too long for a {k * 8}-bit OAEP key")
    l_hash = hashlib.sha1(b"").digest()
    padding = b"\x00" * (k - len(message) - 2 * _SHA1_LEN - 2)
    data_block = l_hash + padding + b"\x01" + message
    seed = seed or os.urandom(_SHA1_LEN)
    masked_db = _xor(data_block, _mgf1(seed, k - _SHA1_LEN - 1))
    masked_seed = _xor(seed, _mgf1(masked_db, _SHA1_LEN))
    em = b"\x00" + masked_seed + masked_db
    return pow(int.from_bytes(em, "big"), e, n).to_bytes(k, "big")


def _oaep_decrypt(key: PrivateKey, ciphertext: bytes) -> bytes:
    k = (key.n.bit_length() + 7) // 8
    if len(ciphertext) != k:
        raise ValueError("ciphertext length mismatch")
    em = pow(int.from_bytes(ciphertext, "big"), key.d, key.n).to_bytes(
        k, "big"
    )
    if em[0] != 0:
        raise ValueError("OAEP decoding error")
    masked_seed, masked_db = em[1:1 + _SHA1_LEN], em[1 + _SHA1_LEN:]
    seed = _xor(masked_seed, _mgf1(masked_db, _SHA1_LEN))
    data_block = _xor(masked_db, _mgf1(seed, k - _SHA1_LEN - 1))
    l_hash = hashlib.sha1(b"").digest()
    if data_block[:_SHA1_LEN] != l_hash:
        raise ValueError("OAEP decoding error")
    sep = data_block.find(b"\x01", _SHA1_LEN)
    if sep < 0:
        raise ValueError("OAEP decoding error")
    if any(data_block[_SHA1_LEN:sep]):
        raise ValueError("OAEP decoding error")
    return data_block[sep + 1:]
