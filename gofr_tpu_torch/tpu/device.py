"""The inference device: model init, batched bucketed prefill and solo
chunked decode. The module keeps the JAX package's path
(``gofr_tpu/tpu/device.py``) so a reader finds the counterpart, though it
drives a GPU.

Config keys: ``MODEL_NAME`` (tiny | small | llama3-8b | llama3-70b),
``MODEL_MAX_SEQ`` (KV cache length per request), ``MODEL_BUCKETS``
(prefill buckets, default the ``SEQ_BUCKETS`` ladder up to max_seq),
``MODEL_SEED`` (random weight init seed), ``BATCH_MAX_SIZE`` /
``BATCH_TIMEOUT_MS`` (prefill batcher), ``DECODE_CHUNK`` (decode steps
per host fetch), ``TOKENIZER=byte`` and ``TORCH_DEVICE`` (``cuda`` by
default; ``cpu`` runs the plain versions of the kernels).

Served configuration: bf16 (or the config's dtype) dense weights, no
continuous-batching decode pool, no paged KV, no prefix cache, no draft
model, no LoRA: each request prefills through the dynamic batcher and then
decodes solo in chunks of ``DECODE_CHUNK`` steps.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from gofr_tpu_torch.errors import InvalidParamError
from gofr_tpu_torch.models.llama import CONFIGS
from gofr_tpu_torch.models.transformer import Transformer
from gofr_tpu_torch.ops.sampling import Sampler
from gofr_tpu_torch.tokenizer import load_tokenizer
from gofr_tpu_torch.tpu.batcher import DynamicBatcher, next_pow2, pack_token_rows


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) needs a visible card and raises without one;
    ``cpu`` must be asked for."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"TORCH_DEVICE {name!r} not supported — use cuda or cpu")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("TORCH_DEVICE=cuda but no CUDA device is visible")
    return torch.device(name)


class TPUDevice:
    """The ``ctx.tpu`` datasource of the port (the name is the JAX
    package's, so handlers written for it run unchanged)."""

    def __init__(self, config: Any, logger: Any, model: Optional[Transformer] = None):
        self.logger = logger
        self.model_name = config.get_or_default("MODEL_NAME", "tiny")
        if self.model_name not in CONFIGS:
            raise ValueError(
                f"unknown MODEL_NAME '{self.model_name}' — expected one of {sorted(CONFIGS)}"
            )
        self.device = resolve_device(config.get_or_default("TORCH_DEVICE", "cuda"))
        self.max_batch = int(config.get_or_default("BATCH_MAX_SIZE", "8"))
        self.timeout_ms = float(config.get_or_default("BATCH_TIMEOUT_MS", "5"))
        raw_max_seq = config.get("MODEL_MAX_SEQ")
        raw_buckets = config.get_or_default("MODEL_BUCKETS", "").strip()
        buckets = (
            tuple(sorted(int(b) for b in raw_buckets.split(","))) if raw_buckets else None
        )
        if buckets and buckets[0] <= 0:
            raise ValueError(f"MODEL_BUCKETS entries must be positive, got {raw_buckets!r}")
        self.tokenizer = load_tokenizer(config)
        # the tokenizer's EOS always ends generation (the JAX package's
        # default stop); request stops compose with it
        self.default_stop_ids = (
            frozenset({self.tokenizer.special_id("eos")}) if self.tokenizer else frozenset()
        )
        if self.device.type == "cuda":
            # bf16 products accumulate in f32 (models/quant.py::mm)
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        start = time.perf_counter()
        self.runner = _TransformerRunner(
            self.model_name,
            self.device,
            max_batch=self.max_batch,
            decode_chunk=int(config.get_or_default("DECODE_CHUNK", "8")),
            max_seq=int(raw_max_seq) if raw_max_seq else None,
            buckets=buckets,
            seed=int(config.get_or_default("MODEL_SEED", "0")),
            model=model,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # boot time includes the init
        self.batcher = DynamicBatcher(
            self.runner.run_batch,
            max_batch=self.max_batch,
            timeout_ms=self.timeout_ms,
            name=self.model_name,
            bucket_fn=self.runner.bucket_for_payload,
        )
        self.boot_seconds = time.perf_counter() - start
        self._closed = False
        logger.infof("device ready: %s", self.describe())

    def describe(self) -> str:
        kind = (
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "cpu"
        )
        return (
            f"model={self.model_name} device={kind} max_seq={self.runner.cfg.max_seq} "
            f"buckets={self.runner.buckets} boot={self.boot_seconds:.1f}s"
        )

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """The port boots synchronously in the constructor; a closed device
        is not ready."""
        if self._closed:
            raise RuntimeError("device is closed")

    def health_check(self) -> dict:
        return {
            "status": "DOWN" if self._closed else "UP",
            "details": {"model": self.model_name, "device": str(self.device)},
        }

    def _encode(self, tokens: Any) -> list[int]:
        if not isinstance(tokens, str):
            return tokens
        if self.tokenizer is None:
            raise InvalidParamError(
                "text needs a tokenizer (set TOKENIZER=byte) — or send token ids"
            )
        return self.tokenizer.encode(tokens)

    def generate(
        self,
        tokens: Any,
        max_new_tokens: int = 32,
        on_token: Optional[Any] = None,
        stop: Optional[Any] = None,
        sampler: Optional[Sampler] = None,
        stop_tokens: Optional[Any] = None,
    ) -> list[int]:
        """Autoregressive generation: prefill through the dynamic batcher,
        then solo chunked decode. ``on_token`` receives each id as it
        decodes; ``stop`` (a threading.Event) aborts between chunks;
        ``tokens`` may be a str when a tokenizer is configured; ``sampler``
        sets temperature/top-k/top-p (default greedy); ``stop_tokens`` end
        generation without being emitted."""
        self.wait_ready()
        stop_tokens = frozenset(stop_tokens or ()) | self.default_stop_ids
        return self.runner.generate(
            self._encode(tokens), max_new_tokens, on_token=on_token, stop=stop,
            sampler=sampler, stop_tokens=stop_tokens, prefill_batcher=self.batcher,
        )

    def generate_stream(
        self,
        tokens: Any,
        max_new_tokens: int = 32,
        sampler: Optional[Sampler] = None,
        stop_tokens: Optional[Any] = None,
        cancel: Optional[threading.Event] = None,
    ) -> Any:
        """Iterator of token ids as they decode (the SSE bridge). Closing it,
        or setting ``cancel``, stops the background decode within a chunk."""
        import queue as queue_mod

        out: "queue_mod.Queue" = queue_mod.Queue()
        done = object()
        failure: list[BaseException] = []
        stop = cancel if cancel is not None else threading.Event()

        def run() -> None:
            try:
                self.generate(
                    tokens, max_new_tokens, on_token=out.put, stop=stop,
                    sampler=sampler, stop_tokens=stop_tokens,
                )
            except BaseException as exc:  # re-raised on the consumer side
                failure.append(exc)
            finally:
                out.put(done)

        def iterate() -> Any:
            threading.Thread(target=run, daemon=True, name="gofr-stream-producer").start()
            try:
                while True:
                    item = out.get()
                    if item is done:
                        break
                    yield item
                if failure:
                    raise failure[0]
            finally:
                stop.set()

        return iterate()

    def close(self) -> None:
        self._closed = True
        self.batcher.close()


class _PrefillState(dict):
    """Per-request prefill result. ``cache`` (this row's copy of the batch
    cache) and ``logits`` materialize on first read, which drops the
    reference to the whole padded batch."""

    def __init__(self, full_cache: dict, full_logits: torch.Tensor, index: int, **kw: Any):
        super().__init__(**kw)
        self._full_cache = full_cache
        self._full_logits = full_logits
        self._index = index

    def __getitem__(self, key: str) -> Any:
        if not dict.__contains__(self, key):
            i = self._index
            if key == "cache":
                full = self._full_cache
                dict.__setitem__(self, key, {
                    "k": full["k"][:, i : i + 1].clone(),
                    "v": full["v"][:, i : i + 1].clone(),
                    "lengths": full["lengths"][i : i + 1].clone(),
                })
                self._full_cache = None
            elif key == "logits":
                dict.__setitem__(self, key, self._full_logits[i])
                self._full_logits = None
        return dict.__getitem__(self, key)


class _TransformerRunner:
    """Decoder serving: batched bucketed prefill + per-request chunked
    decode, on one device."""

    # the ladder reaches the model's full context; MODEL_BUCKETS restricts it
    SEQ_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)

    def __init__(
        self,
        name: str,
        device: torch.device,
        max_batch: int = 8,
        decode_chunk: int = 8,
        max_seq: Optional[int] = None,
        buckets: Optional[tuple[int, ...]] = None,
        seed: int = 0,
        model: Optional[Transformer] = None,
    ):
        cfg = CONFIGS[name]
        if max_seq is not None and max_seq < cfg.max_seq:
            cfg = dataclasses.replace(cfg, max_seq=max_seq)
        self.name = name
        self.cfg = cfg
        self.device = device
        self.max_batch = max_batch
        self.decode_chunk_size = decode_chunk
        if model is None:
            model = Transformer.random(cfg, device, seed)
        elif model.cfg != cfg or model.device != device:
            raise ValueError("the given model does not match MODEL_NAME/MODEL_MAX_SEQ/device")
        self.model = model
        source = buckets if buckets else self.SEQ_BUCKETS
        self.buckets = [b for b in source if b <= cfg.max_seq] or [cfg.max_seq]

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def bucket_for_payload(self, ids: Any) -> int:
        """The bucket a prepared payload lands in (the batcher's cohort key)."""
        return self._bucket_for(max(int(getattr(ids, "size", 0) or 0), 1))

    def prepare(self, tokens: Any) -> np.ndarray:
        ids = np.asarray(tokens, dtype=np.int64).reshape(-1)
        if ids.size == 0:
            raise InvalidParamError("tokens must be a non-empty list of ids")
        if ids.min() < 0 or ids.max() >= self.cfg.vocab_size:
            raise InvalidParamError(
                f"token ids must be in [0, {self.cfg.vocab_size}) for model '{self.name}'"
            )
        return ids.astype(np.int32)[-self.cfg.max_seq:]

    @torch.no_grad()
    def run_batch(self, payloads: list[np.ndarray]) -> list[_PrefillState]:
        """Batched prefill over one bucket -> per-request states. The batch
        dim pads to a power of two >= max_batch; prompts longer than the
        largest bucket keep their LAST tokens. Each batch gets a fresh zero
        cache (the model writes it in place)."""
        n = len(payloads)
        bucket = self._bucket_for(max(int(p.size) for p in payloads))
        bsz = next_pow2(max(n, self.max_batch))
        tokens, lengths = pack_token_rows(payloads, bsz, bucket)
        full_lengths = np.maximum(lengths, 1)  # padded rows need length >= 1
        cache = self.model.init_cache(bsz, self.cfg.max_seq)
        logits, cache = self.model.prefill(
            torch.from_numpy(tokens).to(self.device),
            cache,
            torch.from_numpy(full_lengths).to(self.device),
        )
        next_ids = torch.argmax(logits, dim=-1).tolist()  # the batch's one sync
        return [
            _PrefillState(
                cache, logits, i, next_token=int(next_ids[i]), length=int(full_lengths[i])
            )
            for i in range(n)
        ]

    def generate(
        self,
        tokens: Any,
        max_new_tokens: int,
        on_token: Any = None,
        stop: Any = None,
        sampler: Optional[Sampler] = None,
        stop_tokens: Any = None,
        prefill_batcher: Optional[DynamicBatcher] = None,
    ) -> list[int]:
        sampler = sampler or Sampler()
        stop_tokens = frozenset(stop_tokens or ())
        ids = self.prepare(tokens)
        state = (
            prefill_batcher.infer(ids) if prefill_batcher is not None
            else self.run_batch([ids])[0]
        )
        if sampler.greedy:
            token = state["next_token"]
        else:
            with torch.no_grad():
                token = sampler.pick(state["logits"])
        out: list[int] = []
        if token in stop_tokens:
            return out
        out.append(token)
        if on_token:
            on_token(token)
        if max_new_tokens <= 1:
            return out
        cache, cache_len = state["cache"], state["length"]
        state = None  # release the batch's prefill buffers
        self._solo_decode(
            cache, cache_len, token, out, max_new_tokens, sampler, stop, stop_tokens, on_token
        )
        return out

    @torch.no_grad()
    def _solo_decode(
        self, cache: dict, cache_len: int, token: int, out: list, max_new_tokens: int,
        sampler: Sampler, stop: Any, stop_tokens: frozenset, on_token: Any,
    ) -> None:
        """Chunked decode: ``decode_chunk_size`` steps per dispatch with
        on-device sampling and one [1, N] fetch per chunk. Pipelined: chunk
        N+1 is enqueued before chunk N's ids are fetched (its input token
        stays on the device), so the fetch overlaps the next chunk's work;
        stop conditions lag by at most one chunk, whose ids are dropped.
        Every dispatch runs the full chunk unless the cache end forces a
        short one; surplus ids past max_new_tokens are discarded."""
        max_len = int(cache["k"].shape[2])
        greedy = sampler.greedy
        gen = None if greedy else sampler.generator(self.device)
        temp = 0.0 if greedy else sampler.temperature
        pending: deque = deque()
        token_dev = torch.tensor([[token]], dtype=torch.int64, device=self.device)
        in_flight = 0
        stopped = False
        while not stopped:
            while (
                not (stop is not None and stop.is_set())
                and len(pending) < 2
                and in_flight < max_new_tokens - len(out)
                and cache_len + in_flight < max_len
            ):
                n = min(self.decode_chunk_size, max_len - cache_len - in_flight)
                toks_dev, cache = self.model.decode_chunk(
                    token_dev, cache, n, gen, temp, sampler.top_k, sampler.top_p, sampler.min_p
                )
                token_dev = toks_dev[:, -1:].long()
                pending.append((toks_dev, n))
                in_flight += n
            if not pending:
                break
            toks_dev, n = pending.popleft()
            chunk = toks_dev[0].tolist()
            in_flight -= n
            cache_len += n
            for t in chunk[: min(n, max_new_tokens - len(out))]:
                if t in stop_tokens:
                    stopped = True
                    break
                out.append(t)
                if on_token:
                    on_token(t)
                if stop is not None and stop.is_set():
                    stopped = True
                    break
            if len(out) >= max_new_tokens:
                stopped = True
