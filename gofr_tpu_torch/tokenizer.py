"""Byte-level BPE tokenizer and incremental stream decoder.

Copy of ``gofr_tpu/tokenizer.py``: a greedy rank-based byte-level BPE (the
GPT-2 family's merge loop), with two encoders that give the same ids: the
native library's C++ encode (``native/__init__.py``, built from
``csrc/tokenizer.cpp`` at first use; ``backend == "native"``) on every
request's path, and the pure-Python encoder, which runs without a
toolchain or under ``GOFR_NATIVE_DISABLE`` and is the native one's
equivalence oracle in the tests. Decode joins the ids' byte pieces in
Python on both backends; the JAX package decodes natively, but a native
decode must size its buffer from those same pieces first. With

- merge files (``left right`` id pairs, one a line) and HF
  ``tokenizer.json`` files (byte-level BPE: the merge list translates
  rank for rank, the vocab gives the external ids, the file's Split regex
  pre-splits the text);
- a count-based trainer (``train_bpe``);
- ``TOKENIZER=byte``: the mergeless 256-id byte tokenizer.

Special ids (pad/bos/eos) sit at the TOP of the id space, so byte ids stay
stable. An HF file's external ids are translated in Python on both
backends (``_map_out``, ``_int_of``).
"""

from __future__ import annotations

import codecs
import ctypes
import heapq
import json
from collections import Counter
from functools import lru_cache
from typing import Optional

SPECIAL_TOKENS = ("<pad>", "<bos>", "<eos>")

# the GPT-2 byte-level BPE regex (public algorithm): used when an HF
# tokenizer.json asks for ByteLevel pre-tokenization without its own pattern
_GPT2_SPLIT = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)


@lru_cache(maxsize=1)
def _byte_unicode_tables() -> tuple[dict[int, str], dict[str, int]]:
    """GPT-2 byte<->unicode mapping (public algorithm): printable bytes map
    to themselves, the rest shift into U+0100.. so every byte has a visible
    single-character form inside HF vocab strings."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    byte_to_uni = {b: chr(c) for b, c in zip(bs, cs)}
    uni_to_byte = {u: b for b, u in byte_to_uni.items()}
    return byte_to_uni, uni_to_byte


def _hf_token_bytes(token: str) -> Optional[bytes]:
    """HF vocab string -> raw bytes; None when the string holds characters
    outside the byte-level alphabet (added/special tokens)."""
    _, uni_to_byte = _byte_unicode_tables()
    try:
        return bytes(uni_to_byte[ch] for ch in token)
    except KeyError:
        return None


class Tokenizer:
    def __init__(self, merges: list[tuple[int, int]], n_special: int = len(SPECIAL_TOKENS)):
        # drop duplicates and pairs naming not-yet-defined symbols: ranks and
        # pieces stay in lockstep
        self.merges: list[tuple[int, int]] = []
        self._ranks: dict[tuple[int, int], int] = {}
        self._pieces = [bytes([i]) for i in range(256)]  # id -> byte string
        for left, right in merges:
            if (left, right) in self._ranks:
                continue
            if not (0 <= left < len(self._pieces) and 0 <= right < len(self._pieces)):
                continue
            self._ranks[(left, right)] = len(self.merges)
            self.merges.append((left, right))
            self._pieces.append(self._pieces[left] + self._pieces[right])
        self.n_special = n_special
        # HF interop (from_hf_json): internal ids (byte ids + dense merge
        # ranks) translate to the checkpoint's external ids at the API edge
        self._ext_of: Optional[list[int]] = None  # internal id -> external
        self._int_of: Optional[dict[int, int]] = None  # external -> internal
        self._ext_vocab: Optional[int] = None
        self._special_ids: dict[str, int] = {}  # "bos"/"eos"/"pad" -> ext id
        self._token_ids: dict[str, int] = {}  # special content -> ext id
        self._pretok = None  # compiled split regex (HF pre-tokenizer)
        self._native = None
        self._handle = None
        from gofr_tpu_torch import native

        lib = native.load()
        if lib is not None:
            blob = "\n".join(f"{left} {right}" for left, right in self.merges).encode()
            handle = lib.gofr_tok_new(blob, len(blob), n_special)
            if handle:
                self._native, self._handle = lib, handle

    # -- constructors ----------------------------------------------------------
    @classmethod
    def byte_level(cls, n_special: int = len(SPECIAL_TOKENS)) -> "Tokenizer":
        """No merges: one id per byte (ids 0..255) plus the specials."""
        return cls([], n_special)

    @classmethod
    def from_file(cls, path: str, n_special: int = len(SPECIAL_TOKENS)) -> "Tokenizer":
        merges: list[tuple[int, int]] = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    try:
                        merges.append((int(parts[0]), int(parts[1])))
                    except ValueError:
                        continue  # header/comment lines are skipped
        return cls(merges, n_special)

    @classmethod
    def from_hf_json(cls, path: str) -> "Tokenizer":
        """Load an HF ``tokenizer.json`` (byte-level BPE: GPT-2/Llama-3
        family). The merge list translates rank for rank onto this BPE; the
        vocab supplies the external-id mapping so encode/decode speak the
        checkpoint's ids. The file's own Split regex is honored (merges
        never cross pre-token boundaries, as in HF); ByteLevel-only files
        get the published GPT-2 pattern. A pattern needs the ``regex``
        package, and its absence raises: encoding without the split would
        give other ids than HF."""
        with open(path) as f:
            spec = json.load(f)
        model = spec.get("model", {})
        if model.get("type") != "BPE":
            raise ValueError(
                f"{path}: model.type={model.get('type')!r} — only byte-level "
                "BPE tokenizer.json files are supported"
            )
        vocab: dict[str, int] = model["vocab"]

        # internal piece table: byte ids 0..255, then one id per merge
        piece_ids: dict[bytes, int] = {bytes([b]): b for b in range(256)}
        merges: list[tuple[int, int]] = []
        for entry in model.get("merges", []):
            if isinstance(entry, str):
                left_s, _, right_s = entry.partition(" ")
            else:
                left_s, right_s = entry
            left_b = _hf_token_bytes(left_s)
            right_b = _hf_token_bytes(right_s)
            if left_b is None or right_b is None:
                continue
            left = piece_ids.get(left_b)
            right = piece_ids.get(right_b)
            if left is None or right is None:
                continue  # names a piece never built (a filtered merge)
            piece_ids[left_b + right_b] = 256 + len(merges)
            merges.append((left, right))

        tok = cls(merges, n_special=0)

        # internal -> external ids via the vocab strings
        ext_of = [-1] * (256 + len(tok.merges))
        for token_str, ext_id in vocab.items():
            raw = _hf_token_bytes(token_str)
            if raw is None:
                continue
            internal = piece_ids.get(raw)
            if internal is not None and internal < len(ext_of):
                ext_of[internal] = ext_id
        tok._ext_of = ext_of
        tok._int_of = {e: i for i, e in enumerate(ext_of) if e >= 0}
        max_ext = max((e for e in ext_of if e >= 0), default=-1)

        # added/special tokens (bos/eos/pad by conventional content)
        for added in spec.get("added_tokens", []):
            content, ext_id = added.get("content"), added.get("id")
            if content is None or ext_id is None:
                continue
            tok._token_ids[content] = ext_id
            max_ext = max(max_ext, ext_id)
        for name, candidates in (
            ("bos", ("<|begin_of_text|>", "<s>", "<bos>", "<|startoftext|>")),
            ("eos", ("<|end_of_text|>", "</s>", "<eos>", "<|endoftext|>")),
            ("pad", ("<pad>", "<|pad|>", "<|finetune_right_pad_id|>")),
        ):
            for cand in candidates:
                if cand in tok._token_ids:
                    tok._special_ids[name] = tok._token_ids[cand]
                    break
        tok._ext_vocab = max_ext + 1
        tok._pretok = _compile_pretokenizer(spec.get("pre_tokenizer"))
        return tok

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for left, right in self.merges:
                f.write(f"{left} {right}\n")

    # -- properties --------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        if self._ext_vocab is not None:
            return self._ext_vocab
        return 256 + len(self.merges) + self.n_special

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "python"

    def special_id(self, name: str) -> int:
        """pad/bos/eos ids: the checkpoint's (HF tokenizer.json) or the top
        of the id space."""
        if self._special_ids:
            try:
                return self._special_ids[name]
            except KeyError:
                raise ValueError(f"tokenizer has no {name} token") from None
        idx = SPECIAL_TOKENS.index(f"<{name}>")
        if idx >= self.n_special:
            raise ValueError(f"tokenizer has no <{name}> (n_special={self.n_special})")
        return 256 + len(self.merges) + idx

    def token_id(self, content: str) -> Optional[int]:
        """External id of an added/special token by its literal content
        (e.g. ``"<|eot_id|>"``); None when absent."""
        return self._token_ids.get(content)

    # -- encode / decode -----------------------------------------------------------
    def encode(self, text: str | bytes) -> list[int]:
        if self._pretok is not None:
            # HF pre-tokenization is defined on text: bytes must not bypass
            # it (invalid UTF-8 raises). BPE runs per pre-token chunk; every
            # input byte reaches the encoder, matched or in a gap
            if isinstance(text, bytes):
                text = text.decode("utf-8")
            ids: list[int] = []
            pos = 0
            for m in self._pretok.finditer(text):
                if m.start() > pos:
                    ids.extend(self._encode_raw(text[pos : m.start()].encode("utf-8")))
                if m.group(0):
                    ids.extend(self._encode_raw(m.group(0).encode("utf-8")))
                pos = m.end()
            if pos < len(text):
                ids.extend(self._encode_raw(text[pos:].encode("utf-8")))
            return self._map_out(ids)
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        return self._map_out(self._encode_raw(data))

    def _encode_raw(self, data: bytes) -> list[int]:
        if self._native is not None:
            return self._encode_native(data)
        return self._encode_python(data)

    def _map_out(self, ids: list[int]) -> list[int]:
        if self._ext_of is None:
            return ids
        return [self._ext_of[i] for i in ids if self._ext_of[i] >= 0]

    def decode(self, ids: list[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: list[int]) -> bytes:
        """The RAW bytes behind ``ids``: one byte-level BPE token can hold a
        fragment of a multi-byte character, and the OpenAI logprobs
        ``bytes`` field needs that fragment, not a replacement character."""
        if self._int_of is not None:
            # external ids without a byte-level piece (specials) carry no text
            ids = [self._int_of[i] for i in ids if i in self._int_of]
        top = 256 + len(self.merges)
        return b"".join(self._pieces[i] for i in ids if 0 <= i < top)

    def _encode_native(self, data: bytes) -> list[int]:
        cap = max(len(data), 1)
        buf = (ctypes.c_int32 * cap)()
        n = self._native.gofr_tok_encode(self._handle, data, len(data), buf, cap)
        return list(buf[: min(n, cap)])  # n <= len(data): merges only shrink

    def _encode_python(self, data: bytes) -> list[int]:
        """O(n log n) greedy merge: a linked list and a lazy min-heap, the
        candidates ordered by rank, then leftmost."""
        n = len(data)
        if n == 0:
            return []
        ids = list(data)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        dead = [False] * n
        ranks = self._ranks
        heap: list[tuple[int, int, int, int]] = []
        for i in range(n - 1):
            rank = ranks.get((ids[i], ids[i + 1]))
            if rank is not None:
                heap.append((rank, i, ids[i], ids[i + 1]))
        heapq.heapify(heap)
        while heap:
            rank, i, left, right = heapq.heappop(heap)
            j = -1 if dead[i] else nxt[i]
            if j < 0 or dead[i] or dead[j] or ids[i] != left or ids[j] != right:
                continue  # stale candidate
            ids[i] = 256 + rank
            dead[j] = True
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            for a in (prv[i], i):
                b = nxt[a] if a >= 0 else -1
                if a >= 0 and b >= 0:
                    r = ranks.get((ids[a], ids[b]))
                    if r is not None:
                        heapq.heappush(heap, (r, a, ids[a], ids[b]))
        out = []
        i = 0
        while i >= 0:
            out.append(ids[i])
            i = nxt[i]
        return out

    def stream_decoder(self) -> "StreamDecoder":
        """Incremental decoder for token streams: partial UTF-8 sequences
        stay buffered across token boundaries (SSE streaming)."""
        return StreamDecoder(self)

    def __del__(self) -> None:
        lib, handle = getattr(self, "_native", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            try:
                lib.gofr_tok_free(handle)
            except Exception:
                pass  # interpreter teardown: the library may be gone


class StreamDecoder:
    """Feeds token ids one at a time and emits text as soon as whole UTF-8
    sequences are available; a trailing partial sequence stays buffered."""

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._dec = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def feed(self, token_id: int) -> str:
        if self._tok._int_of is not None:
            internal = self._tok._int_of.get(token_id)
            if internal is None:
                return ""  # special/out-of-range external ids carry no bytes
            token_id = internal
        pieces = self._tok._pieces
        if not 0 <= token_id < len(pieces):
            return ""  # special/out-of-range ids carry no bytes
        return self._dec.decode(pieces[token_id])

    def flush(self) -> str:
        return self._dec.decode(b"", final=True)


def train_bpe(
    corpus: str | bytes,
    vocab_size: int,
    n_special: int = len(SPECIAL_TOKENS),
) -> Tokenizer:
    """Count-based BPE training: merge the most frequent adjacent pair until
    the vocabulary reaches ``vocab_size`` (or no pair repeats). A full
    recount per merge: training is offline, serving is not."""
    data = corpus.encode("utf-8") if isinstance(corpus, str) else bytes(corpus)
    n_merges = vocab_size - 256 - n_special
    if n_merges < 0:
        raise ValueError(f"vocab_size must be >= {256 + n_special}")
    ids = list(data)
    merges: list[tuple[int, int]] = []
    for _ in range(n_merges):
        counts = Counter(zip(ids, ids[1:]))
        if not counts:
            break
        pair, freq = counts.most_common(1)[0]
        if freq < 2:
            break
        new_id = 256 + len(merges)
        merges.append(pair)
        out = []
        i = 0
        while i < len(ids):
            if i + 1 < len(ids) and (ids[i], ids[i + 1]) == pair:
                out.append(new_id)
                i += 2
            else:
                out.append(ids[i])
                i += 1
        ids = out
    return Tokenizer(merges, n_special)


def _compile_pretokenizer(pre: Optional[dict]):
    """The Split regex of an HF pre_tokenizer spec (Sequence / Split /
    ByteLevel), compiled with ``regex``; None when the spec asks for no
    pre-splitting. Raises when it asks for one and ``regex`` is missing."""
    if not pre:
        return None
    nodes = pre.get("pretokenizers", []) if pre.get("type") == "Sequence" else [pre]
    pattern = None
    for node in nodes:
        if node.get("type") == "Split" and "Regex" in node.get("pattern", {}):
            pattern = node["pattern"]["Regex"]
            break
    if pattern is None and any(
        node.get("type") == "ByteLevel" and node.get("use_regex", True) for node in nodes
    ):
        pattern = _GPT2_SPLIT
    if pattern is None:
        return None
    try:
        import regex
    except ImportError:
        raise RuntimeError(
            "this tokenizer.json pre-splits text with a regex, which needs the "
            "'regex' package; without the split the ids would differ from HF"
        ) from None
    return regex.compile(pattern)


def load_tokenizer(config) -> Optional[Tokenizer]:
    """``TOKENIZER_PATH`` (an HF tokenizer.json when the file ends in
    .json, else a merges file) > ``TOKENIZER=byte`` > None (id-only
    endpoints)."""
    path = config.get("TOKENIZER_PATH")
    if path:
        if path.endswith(".json"):
            return Tokenizer.from_hf_json(path)
        return Tokenizer.from_file(path)
    if config.get_or_default("TOKENIZER", "") == "byte":
        return Tokenizer.byte_level()
    return None
