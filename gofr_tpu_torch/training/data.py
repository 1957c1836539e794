"""Training data: flat token files, seeded crops, host-to-device prefetch.

Port of ``gofr_tpu/training/data.py``. Tokens live in a flat binary file
(``np.memmap``, so a corpus larger than RAM streams from disk) with a
``.meta.json`` sidecar naming its dtype; ``TokenDataset.batch(step)`` is
the same pure numpy function of (seed, step) as the JAX package's, so one
seed gives the same batches in both; ``prefetch_to_device`` keeps the next
batches already on the device while a step computes.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch

_DTYPE = np.uint16  # default: vocab <= 65536
_SENTINEL = object()


def dtype_for_vocab(vocab_size: int) -> np.dtype:
    return np.dtype(np.uint16 if vocab_size <= 65536 else np.uint32)


def corpus_to_bin(text: str, tokenizer: Any, path: str, dtype: Any = None) -> int:
    """Tokenize a corpus and write the flat token file ``TokenDataset``
    reads, plus ``<path>.meta.json`` with its dtype, count and vocab.
    Returns the token count. dtype defaults to the smallest type holding
    the tokenizer's vocab (uint16 / uint32)."""
    if dtype is None:
        dtype = dtype_for_vocab(getattr(tokenizer, "vocab_size", 1 << 16))
    dtype = np.dtype(dtype)
    vocab = getattr(tokenizer, "vocab_size", None)
    if vocab is not None and vocab > np.iinfo(dtype).max + 1:
        raise ValueError(f"dtype {dtype} cannot hold tokenizer vocab {vocab} — use uint32")
    ids = np.asarray(tokenizer.encode(text), dtype)
    ids.tofile(path)
    # the sidecar makes the file self-describing: a uint32 file is never
    # read back as uint16
    with open(path + ".meta.json", "w") as f:
        json.dump({"dtype": dtype.name, "count": int(ids.size), "vocab_size": vocab}, f)
    return int(ids.size)


class TokenDataset:
    """Fixed-length [batch, seq_len] crops over a flat token stream.

    ``path_or_array``: a file written by :func:`corpus_to_bin` (memory-
    mapped; its dtype from the sidecar, else uint16, unless ``dtype`` is
    given) or any 1-D integer array. ``batch(step)`` is a pure function of
    (seed, step): a resumed run sees the same data without loader state.
    """

    def __init__(self, path_or_array: Any, seq_len: int, batch_size: int, seed: int = 0,
                 dtype: Any = None):
        if isinstance(path_or_array, str):
            if dtype is None:
                dtype = self._sidecar_dtype(path_or_array) or _DTYPE
            self.tokens = np.memmap(path_or_array, dtype=np.dtype(dtype), mode="r")
        else:
            self.tokens = np.asarray(path_or_array)
        if self.tokens.ndim != 1:
            raise ValueError("token stream must be 1-D")
        if self.tokens.size < seq_len + 1:
            raise ValueError(f"dataset has {self.tokens.size} tokens; needs > seq_len={seq_len}")
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed

    @staticmethod
    def _sidecar_dtype(path: str) -> Optional[np.dtype]:
        meta = path + ".meta.json"
        if not os.path.exists(meta):
            return None
        try:
            with open(meta) as f:
                return np.dtype(json.load(f)["dtype"])
        except (OSError, KeyError, ValueError, TypeError):
            return None

    def __len__(self) -> int:
        return int(self.tokens.size)

    def batch(self, step: int) -> np.ndarray:
        """[batch_size, seq_len] int32 crop for this step (deterministic)."""
        rng = np.random.default_rng((self.seed << 32) | (step & 0xFFFFFFFF))
        starts = rng.integers(0, self.tokens.size - self.seq_len, self.batch_size)
        out = np.empty((self.batch_size, self.seq_len), np.int32)
        for i, s in enumerate(starts):
            out[i] = self.tokens[s : s + self.seq_len]
        return out

    def batches(self, start_step: int = 0) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def prefetch_to_device(
    iterator: Iterator[Any], size: int = 2, device: "torch.device | str" = "cuda"
) -> Iterator[torch.Tensor]:
    """Wrap a host batch iterator so the next ``size`` batches are already
    on ``device`` while the current step computes. A daemon thread turns
    each numpy batch into a tensor and, for a CUDA device, copies it from
    pinned host memory with ``non_blocking=True``. A failure in the
    producer is raised in the consumer; closing the generator stops the
    thread."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    failure: list[BaseException] = []

    def put(item: Any) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run() -> None:
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                t = torch.as_tensor(np.asarray(batch))
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                else:
                    t = t.to(device)
                if not put(t):
                    return
        except BaseException as exc:
            failure.append(exc)
        finally:
            put(_SENTINEL)

    thread = threading.Thread(target=run, daemon=True, name="gofr-data-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()
