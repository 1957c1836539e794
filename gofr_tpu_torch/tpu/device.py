"""The inference device: model init, batched bucketed prefill, chunked
prefill, the prefix cache, and decode through the continuous-batching pool
or solo. The module keeps the JAX package's path (``gofr_tpu/tpu/device.py``)
so a reader finds the counterpart, though it drives a GPU.

``MODEL_NAME`` picks the runner as the JAX package does: ``mlp`` (the
default; also ``tiny-mlp``) and ``bert-tiny`` / ``bert-base`` (any other
``bert*`` name) answer ``infer`` / ``infer_async`` through the dynamic
batcher alone (``_MLPRunner``, ``_BertRunner``: a seeded init or a
``training/checkpoint.py`` ``MODEL_PATH``, BERT quantized by
``MODEL_QUANT``; no pool, paged KV, speculation or adapters, and
``generate`` raises NotImplementedError); a decoder (tiny | small |
llama3-8b | llama3-70b) serves as below, and its ``infer`` answers with
its prefill state (``next_token``).

Decoder config keys: ``MODEL_NAME``,
``MODEL_MAX_SEQ`` (KV cache length per request), ``MODEL_BUCKETS``
(prefill buckets, default the ``SEQ_BUCKETS`` ladder up to max_seq),
``MODEL_SEED`` (random weight init seed), ``BATCH_MAX_SIZE`` /
``BATCH_TIMEOUT_MS`` (prefill batcher), ``DECODE_CHUNK`` (decode steps
per host fetch), ``TOKENIZER=byte`` and ``TORCH_DEVICE`` (``cuda`` by
default; ``cpu`` runs the plain versions of the kernels); and the JAX
package's serving defaults (``serving_options``): ``DECODE_POOL`` (on),
``DECODE_SLOTS`` (= ``BATCH_MAX_SIZE``), ``DECODE_PIPELINE`` (3),
``KV_PAGED`` (on), ``KV_BLOCK_TOKENS`` (64), ``KV_BLOCKS`` (0 = auto),
``PREFIX_CACHE`` (0), ``PREFIX_LCP_MIN`` (0 = smallest bucket, -1 = exact
only), ``PREFILL_CHUNK_TOKENS`` (0 = off), ``SCHED_POLICY`` (fair) and
``SCHED_MAX_DEFER_MS`` (1000) and ``DECODE_POOL_PENALTIES`` (lazy). The
weights: ``MODEL_PATH`` (an HF safetensors file or directory, loaded one
tensor at a time; any other path is a ``training/checkpoint.py``
checkpoint), else a seeded random init; ``MODEL_QUANT`` (int8, int4,
w8a8: quantized as they load, or as they are drawn); ``MODEL_KV_DTYPE``
(bf16, or f8 for a float8 e4m3 KV cache). Default stops:
``GEN_STOP_EOS=off`` (none), else ``GEN_STOP_TOKENS`` (ids), else the
checkpoint's ``generation_config.json`` EOS ids, else the tokenizer's EOS.

A request goes: prefix lookup (exact hit, or the longest common prefix
with a tail prefill), else chunked prefill (prompts longer than the largest
bucket or over ``PREFILL_CHUNK_TOKENS``) or the dynamic batcher; then the
prefix store; then a decode-pool slot, or solo chunked decode when the
pool is off, full or closed, or the request carries a seed. Logprobs (and
the top-``TOP_LOGPROBS`` alternatives) ride every decode chunk, pooled or
solo; the first token's come from the prefill logits. Penalties and
``logit_bias`` apply from the first token (``_penalized_first``) and ride
the pool's per-slot state, or the penalized chunk at B = 1 solo; the
logprobs stay the raw model's. ``score`` runs one cache-free forward over
a prompt bucket (teacher-forced scoring).

Speculation (``spec_options``, the JAX package's keys and errors): with
``DRAFT_MODEL_NAME`` (``DRAFT_TOKENS`` k, ``DRAFT_MODEL_PATH``) a request
without penalties or logprobs takes the solo latency mode instead of the
pool: a ``_SpecEngine`` draft proposes k tokens a cycle, the target
verifies them in one forward (``Transformer.verify_chunk``), and greedy
ids are the target's own; unseeded sampled requests take speculative
sampling. ``SPEC_POOLED=on`` stands that mode down and arms the decode
pool's n-gram speculation instead (``SPEC_NGRAM``, ``SPEC_K_MAX``).

Multi-LoRA (``LORA_ADAPTERS`` = ``name=path,...``, artifacts written by
``save_params(path, export_adapter(state))``; ``load_adapter`` /
``unload_adapter`` at runtime): each adapter is a LoRA model over the
shared base (``models/lora.py::apply_adapter``: n adapters cost n x
adapter bytes). A request picks one with ``adapter=``: it prefills solo in
slices of its bucket (never past the chunk budget), skips the prefix cache
and both speculation modes, and decodes in the pool through its stacked
adapter bank (``decode_chunk_pool_lora``), or solo when the pool rejects
it; ``score(adapter=)`` scores under it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import queue
import secrets
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

import numpy as np
import torch

from gofr_tpu_torch.deadline import (
    PRIORITY_MAX,
    PRIORITY_MIN,
    BrownoutController,
    cancellations_counter,
    clamp_spec_k,
    current_deadline,
    deadline_exceeded_counter,
    pool_reject_counter,
)
from gofr_tpu_torch.errors import DeadlineExceeded, HTTPError, InvalidParamError
from gofr_tpu_torch.journal_wal import JournalWAL
from gofr_tpu_torch.metrics import COMPILE_BUCKETS, Registry
from gofr_tpu_torch.models.bert import BERT_BASE, BERT_TINY, Bert, bert_embed
from gofr_tpu_torch.models.ingest import is_safetensors_path, load_llama_params
from gofr_tpu_torch.models.llama import CONFIGS
from gofr_tpu_torch.models.lora import apply_adapter, build_lora_stack
from gofr_tpu_torch.models.mlp import MLP, MLPConfig, init_mlp, mlp_forward
from gofr_tpu_torch.models.quant import quantizer_for
from gofr_tpu_torch.models.transformer import TOP_LOGPROBS, Transformer
from gofr_tpu_torch.ops.sampling import (
    Sampler,
    apply_penalties,
    bias_row_from_map,
    check_bias_ids,
    presence_from_tokens,
    update_counts,
    update_presence,
)
from gofr_tpu_torch.postmortem import runtime_versions
from gofr_tpu_torch.telemetry import (
    BOOT_ID,
    GenerationJournal,
    activate_journal_entry,
    current_record,
    request_key,
)
from gofr_tpu_torch.tokenizer import load_tokenizer
from gofr_tpu_torch.tpu.batcher import DynamicBatcher, next_pow2, pack_token_rows, pad_rows
from gofr_tpu_torch.tpu.decode_pool import (
    DEADLINE,
    DONE,
    PENALTY_MODES,
    PIPELINE_DEPTH,
    DecodePool,
    HostFetch,
    PoolFailure,
)
from gofr_tpu_torch.tpu.costmodel import CostModel, transformer_sheet
from gofr_tpu_torch.tpu.flops import (
    bert_param_count,
    device_peak_flops,
    device_peak_hbm_bw,
    mfu,
    mfu_from_flops,
    transformer_param_count,
)
from gofr_tpu_torch.tpu.introspect import (
    DispatchTimeline,
    EngineState,
    StallWatchdog,
    current_dispatch,
)
from gofr_tpu_torch.tpu.recovery import RecoverySupervisor
from gofr_tpu_torch.tpu.kv_blocks import (
    BlockPool,
    BlockTable,
    HostPagedKV,
    HostTokenArena,
    KVExhausted,
    TorchKVArena,
    blocks_for,
    lcp_scan,
    to_device,
)
from gofr_tpu_torch.tpu.scheduler import POLICIES, InterferenceScheduler
from gofr_tpu_torch.tpu.spec_pool import PoolSpecConfig, parse_fake_accept
from gofr_tpu_torch.training.checkpoint import restore_params

# the stall deadline the watchdog arms itself with on a cuda device when
# WATCHDOG_DISPATCH_TIMEOUT_S is unset: the JAX package's, well above any
# healthy wait (a pool chunk of llama3-8b takes well under a second)
WATCHDOG_AUTO_TIMEOUT_S = 120.0
# how long a recovery teardown waits for the old pool's worker: it may be
# parked on a wedged wait, which no join can cut short (a kernel cannot be
# cancelled); it leaves, failing its rows, when the wait returns
RECOVERY_POOL_JOIN_S = 2.0


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) needs a visible card and raises without one;
    ``cpu`` must be asked for."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"TORCH_DEVICE {name!r} not supported — use cuda or cpu")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("TORCH_DEVICE=cuda but no CUDA device is visible")
    return torch.device(name)


def checkpoint_eos_ids(model_path: Optional[str], tokenizer: Any) -> set:
    """EOS ids for default stopping: the checkpoint's
    ``generation_config.json`` beside ``MODEL_PATH`` (``eos_token_id``, an
    int or a list: Llama-3 instruct lists both <|end_of_text|> and
    <|eot_id|>), else the tokenizer's EOS; empty when neither exists. A
    ``generation_config.json`` that cannot be read fails the boot."""
    if model_path:
        base = model_path if os.path.isdir(model_path) else os.path.dirname(model_path)
        gc_path = os.path.join(base, "generation_config.json")
        if os.path.isfile(gc_path):
            try:
                with open(gc_path, encoding="utf-8") as fh:
                    eos = json.load(fh).get("eos_token_id")
            except (OSError, ValueError) as exc:
                # dropping the checkpoint's extra EOS ids would run every
                # chat past the turn boundary: fail loudly instead
                raise ValueError(
                    f"cannot read {gc_path}: {exc} — fix the checkpoint "
                    "or set GEN_STOP_TOKENS / GEN_STOP_EOS=off"
                ) from None
            if isinstance(eos, int):
                return {eos}
            if isinstance(eos, list) and all(isinstance(t, int) for t in eos):
                return set(eos)
    if tokenizer is not None:
        try:
            return {tokenizer.special_id("eos")}
        except ValueError:
            pass
    return set()


def resolve_default_stop_ids(config: Any, tokenizer: Any) -> frozenset:
    """Default stop ids, which end EVERY generation (OpenAI semantics), in
    the JAX package's order: none under ``GEN_STOP_EOS=off``; else
    ``GEN_STOP_TOKENS`` (comma-separated ids); else the checkpoint's
    ``generation_config.json`` EOS ids beside ``MODEL_PATH``; else the
    tokenizer's EOS (none without a tokenizer)."""
    if config.get_or_default("GEN_STOP_EOS", "on") == "off":
        return frozenset()
    explicit = config.get("GEN_STOP_TOKENS")
    if explicit:
        try:
            return frozenset(int(t) for t in str(explicit).split(",") if t.strip())
        except ValueError:
            raise ValueError("GEN_STOP_TOKENS must be comma-separated token ids") from None
    return frozenset(checkpoint_eos_ids(config.get("MODEL_PATH"), tokenizer))


def parse_kv_dtype(raw: str) -> Optional[torch.dtype]:
    """MODEL_KV_DTYPE: bf16 (the default: the compute dtype) or f8 (float8
    e4m3); anything else raises."""
    raw = raw.strip().lower()
    if raw in ("", "bf16", "bfloat16"):
        return None
    if raw in ("f8", "fp8", "float8", "float8_e4m3fn"):
        return torch.float8_e4m3fn
    raise ValueError(f"MODEL_KV_DTYPE '{raw}' not supported — use bf16 or f8")


def load_model(cfg: Any, device: torch.device, model_path: Optional[str], quant: Any,
               seed: int) -> Transformer:
    """The serving weights (the JAX package's ``_load_params`` routes): a
    safetensors ``MODEL_PATH`` loads one tensor at a time, quantized as it
    lands; any other path is a ``training/checkpoint.py`` checkpoint,
    quantized after the load; no path draws a seeded random model,
    quantized as each weight is drawn. A path that cannot be read raises:
    no route falls back to random weights."""
    if model_path and not os.path.exists(model_path):
        raise FileNotFoundError(f"MODEL_PATH {model_path!r} does not exist")
    if model_path and is_safetensors_path(model_path):
        return load_llama_params(model_path, cfg, quantize=quant, device=device)
    if model_path:
        model = Transformer(cfg, device)
        state = restore_params(model_path, device)
        model.load_state_dict(state)
        del state
        return model.quantized(quant) if quant else model
    return Transformer.random(cfg, device, seed, quant=quant)


def serving_options(config: Any, max_batch: int) -> dict:
    """The pool, paged-KV, prefix-cache, chunked-prefill and scheduler keys
    with the JAX package's defaults and validation errors
    (``gofr_tpu/tpu/device.py::_parse_serving_config``)."""
    opts: dict = {}
    opts["prefix_cache"] = int(config.get_or_default("PREFIX_CACHE", "0"))
    if opts["prefix_cache"] < 0:
        raise ValueError("PREFIX_CACHE must be >= 0")
    opts["prefix_lcp_min"] = int(config.get_or_default("PREFIX_LCP_MIN", "0"))
    if opts["prefix_lcp_min"] < -1:
        raise ValueError("PREFIX_LCP_MIN must be >= -1")
    opts["prefill_chunk_tokens"] = int(config.get_or_default("PREFILL_CHUNK_TOKENS", "0"))
    if opts["prefill_chunk_tokens"] < 0:
        raise ValueError("PREFILL_CHUNK_TOKENS must be >= 0 (0 = off)")
    opts["sched_policy"] = config.get_or_default("SCHED_POLICY", "fair").strip().lower()
    if opts["sched_policy"] not in POLICIES:
        raise ValueError(
            f"SCHED_POLICY '{opts['sched_policy']}' not supported — use one of {POLICIES}"
        )
    opts["sched_max_defer_ms"] = float(config.get_or_default("SCHED_MAX_DEFER_MS", "1000"))
    if opts["sched_max_defer_ms"] <= 0:
        raise ValueError("SCHED_MAX_DEFER_MS must be > 0")
    opts["kv_paged"] = config.get_or_default("KV_PAGED", "on") != "off"
    opts["kv_block_tokens"] = int(config.get_or_default("KV_BLOCK_TOKENS", "64"))
    if opts["kv_block_tokens"] < 1:
        raise ValueError("KV_BLOCK_TOKENS must be >= 1")
    opts["kv_blocks"] = int(config.get_or_default("KV_BLOCKS", "0"))
    if opts["kv_blocks"] < 0:
        raise ValueError("KV_BLOCKS must be >= 0 (0 = auto-size)")
    opts["pool_enabled"] = config.get_or_default("DECODE_POOL", "on") != "off"
    opts["pool_slots"] = int(config.get_or_default("DECODE_SLOTS", str(max_batch)))
    opts["pool_depth"] = int(config.get_or_default("DECODE_PIPELINE", str(PIPELINE_DEPTH)))
    if opts["pool_depth"] < 1:
        raise ValueError("DECODE_PIPELINE must be >= 1")
    # lazy: the pool's penalty state is allocated on the first penalized
    # request (which solos); eager: at boot; off: penalized requests solo
    opts["pool_penalties"] = (
        config.get_or_default("DECODE_POOL_PENALTIES", "lazy").strip().lower()
    )
    if opts["pool_penalties"] not in PENALTY_MODES:
        raise ValueError("DECODE_POOL_PENALTIES must be lazy, eager, or off")
    return opts


def observability_options(config: Any) -> dict:
    """The dispatch timeline, watchdog and cost-model keys with the JAX
    package's defaults and validation errors: ``DISPATCH_TIMELINE_SIZE``
    (512); ``WATCHDOG_DISPATCH_TIMEOUT_S`` (unset: armed at
    ``WATCHDOG_AUTO_TIMEOUT_S`` once the probe finds a cuda device; off or
    0: disabled; seconds: armed from construction); ``COSTMODEL`` (on),
    ``COSTMODEL_PROFILE``, ``COSTMODEL_ANOMALY_FACTOR`` (4),
    ``COSTMODEL_MIN_ANOMALY_MS`` (50), ``COSTMODEL_EMA_ALPHA`` (0.2),
    ``COSTMODEL_EMA_BAND`` (2.5) and ``ANOMALY_RING_SIZE`` (256)."""
    opts: dict = {}
    opts["timeline_size"] = int(config.get_or_default("DISPATCH_TIMELINE_SIZE", "512"))
    raw_wd = (config.get_or_default("WATCHDOG_DISPATCH_TIMEOUT_S", "") or "").strip().lower()
    opts["watchdog_auto"] = raw_wd == ""
    opts["watchdog_timeout"] = 0.0 if raw_wd in ("", "off") else float(raw_wd)
    if opts["watchdog_timeout"] < 0:
        raise ValueError(
            "WATCHDOG_DISPATCH_TIMEOUT_S must be >= 0 (0/off = disabled, "
            "unset = auto-arm on cuda)"
        )
    opts["costmodel"] = config.get_or_default("COSTMODEL", "on").strip().lower() != "off"
    opts["costmodel_profile"] = config.get_or_default("COSTMODEL_PROFILE", "").strip() or None
    opts["anomaly_factor"] = float(config.get_or_default("COSTMODEL_ANOMALY_FACTOR", "4.0"))
    if opts["anomaly_factor"] <= 1.0:
        raise ValueError("COSTMODEL_ANOMALY_FACTOR must be > 1")
    opts["min_anomaly_ms"] = float(config.get_or_default("COSTMODEL_MIN_ANOMALY_MS", "50"))
    if opts["min_anomaly_ms"] < 0:
        raise ValueError("COSTMODEL_MIN_ANOMALY_MS must be >= 0")
    opts["ema_alpha"] = float(config.get_or_default("COSTMODEL_EMA_ALPHA", "0.2"))
    opts["ema_band"] = float(config.get_or_default("COSTMODEL_EMA_BAND", "2.5"))
    opts["ring_size"] = int(config.get_or_default("ANOMALY_RING_SIZE", "256"))
    if opts["ring_size"] < 1:
        raise ValueError("ANOMALY_RING_SIZE must be >= 1")
    return opts


def spec_options(config: Any) -> dict:
    """The speculation keys with the JAX package's defaults and validation
    errors (``gofr_tpu/tpu/device.py``): the solo latency mode's draft
    (``DRAFT_MODEL_NAME``, ``DRAFT_TOKENS``, ``DRAFT_MODEL_PATH``) and
    pooled speculation (``SPEC_POOLED``, ``SPEC_NGRAM``, ``SPEC_K_MAX``,
    and the echo runner's scripted ``SPEC_FAKE_ACCEPT``)."""
    opts: dict = {}
    opts["draft_name"] = config.get_or_default("DRAFT_MODEL_NAME", "").strip()
    opts["draft_tokens"] = int(config.get_or_default("DRAFT_TOKENS", "4"))
    opts["draft_path"] = config.get("DRAFT_MODEL_PATH") or None
    if opts["draft_name"] and opts["draft_tokens"] < 2:
        # acceptance is capped at k-1 (the draft cache holds at most k
        # committed positions a cycle), so k=1 could never accept a draft.
        # A stale DRAFT_TOKENS without a draft model is ignored
        raise ValueError("DRAFT_TOKENS must be >= 2")
    opts["spec_pooled"] = config.get_or_default("SPEC_POOLED", "off").strip().lower() == "on"
    opts["spec_ngram"] = config.get_or_default("SPEC_NGRAM", "on").strip().lower() != "off"
    opts["spec_k_max"] = int(config.get_or_default("SPEC_K_MAX", "4"))
    if opts["spec_k_max"] < 1:
        raise ValueError("SPEC_K_MAX must be >= 1")
    raw_fake = config.get_or_default("SPEC_FAKE_ACCEPT", "").strip()
    opts["spec_fake_accept"] = parse_fake_accept(raw_fake) if raw_fake else None
    if opts["spec_pooled"] and not (opts["spec_ngram"] or opts["spec_fake_accept"]):
        raise ValueError(
            "SPEC_POOLED=on needs a draft source: keep SPEC_NGRAM=on "
            "(zero-weight prompt-lookup drafting) or script "
            "SPEC_FAKE_ACCEPT (echo runner)"
        )
    return opts


def failure_options(config: Any) -> dict:
    """The overload and failure keys with the JAX package's defaults and
    validation errors: the recovery supervisor (``RECOVERY_ENABLED`` on,
    ``RECOVERY_MAX_ATTEMPTS`` 3, ``RECOVERY_BACKOFF_S`` 1,
    ``RECOVERY_BACKOFF_MAX_S`` 30, ``RECOVERY_ATTEMPT_TIMEOUT_S`` 300), the
    journal (``JOURNAL`` on, ``JOURNAL_CAPACITY`` 256,
    ``JOURNAL_MAX_TOKENS`` 8192) and its WAL (``JOURNAL_DIR``, unset = in
    memory; ``JOURNAL_FSYNC`` interrupt; ``JOURNAL_SEGMENT_BYTES`` 1 MiB;
    ``JOURNAL_SEGMENTS`` 4), and the brownout (``BROWNOUT_QUEUE_DEPTH`` and
    ``BROWNOUT_KV_UTIL``, 0 = off; ``BROWNOUT_SHED_PRIORITY`` 5;
    ``BROWNOUT_CLAMP_TOKENS`` 0)."""
    opts: dict = {}
    opts["recovery_enabled"] = config.get_or_default("RECOVERY_ENABLED", "on") != "off"
    opts["recovery_attempts"] = int(config.get_or_default("RECOVERY_MAX_ATTEMPTS", "3"))
    opts["recovery_backoff"] = float(config.get_or_default("RECOVERY_BACKOFF_S", "1"))
    opts["recovery_backoff_max"] = float(config.get_or_default("RECOVERY_BACKOFF_MAX_S", "30"))
    opts["recovery_attempt_timeout"] = float(
        config.get_or_default("RECOVERY_ATTEMPT_TIMEOUT_S", "300")
    )
    opts["journal"] = config.get_or_default("JOURNAL", "on") != "off"
    opts["journal_capacity"] = int(config.get_or_default("JOURNAL_CAPACITY", "256"))
    if opts["journal_capacity"] < 1:
        raise ValueError("JOURNAL_CAPACITY must be >= 1")
    opts["journal_max_tokens"] = int(config.get_or_default("JOURNAL_MAX_TOKENS", "8192"))
    if opts["journal_max_tokens"] < 1:
        raise ValueError("JOURNAL_MAX_TOKENS must be >= 1")
    opts["journal_dir"] = config.get_or_default("JOURNAL_DIR", "")
    opts["journal_fsync"] = config.get_or_default("JOURNAL_FSYNC", "interrupt")
    opts["journal_segment_bytes"] = int(
        config.get_or_default("JOURNAL_SEGMENT_BYTES", str(1 << 20))
    )
    if opts["journal_segment_bytes"] < 4096:
        raise ValueError("JOURNAL_SEGMENT_BYTES must be >= 4096")
    opts["journal_segments"] = int(config.get_or_default("JOURNAL_SEGMENTS", "4"))
    if opts["journal_segments"] < 1:
        raise ValueError("JOURNAL_SEGMENTS must be >= 1")
    opts["brownout_queue_hi"] = int(config.get_or_default("BROWNOUT_QUEUE_DEPTH", "0"))
    if opts["brownout_queue_hi"] < 0:
        raise ValueError("BROWNOUT_QUEUE_DEPTH must be >= 0 (0 = off)")
    opts["brownout_kv_hi"] = float(config.get_or_default("BROWNOUT_KV_UTIL", "0"))
    if not 0.0 <= opts["brownout_kv_hi"] < 1.0:
        raise ValueError("BROWNOUT_KV_UTIL must be a fraction in [0, 1) (0 = off)")
    opts["brownout_shed_priority"] = int(config.get_or_default("BROWNOUT_SHED_PRIORITY", "5"))
    if not PRIORITY_MIN <= opts["brownout_shed_priority"] <= PRIORITY_MAX:
        raise ValueError(f"BROWNOUT_SHED_PRIORITY must be {PRIORITY_MIN}..{PRIORITY_MAX}")
    opts["brownout_clamp"] = int(config.get_or_default("BROWNOUT_CLAMP_TOKENS", "0"))
    if opts["brownout_clamp"] < 0:
        raise ValueError("BROWNOUT_CLAMP_TOKENS must be >= 0 (0 = off)")
    return opts


def parse_lora_adapters(raw: str) -> dict[str, str]:
    """LORA_ADAPTERS "name=path,name2=path2" -> {name: path}; a malformed
    entry fails the boot."""
    adapters: dict[str, str] = {}
    for part in raw.strip().split(",") if raw.strip() else ():
        name, sep, path = part.strip().partition("=")
        if not sep or not name or not path:
            raise ValueError(
                f"LORA_ADAPTERS entry '{part.strip()}' is malformed "
                "— expected name=path[,name2=path2...]"
            )
        adapters[name] = path
    return adapters


class TPUDevice:
    """The ``ctx.tpu`` datasource of the port (the name is the JAX
    package's, so handlers written for it run unchanged). ``model``: an
    already-built model of ``MODEL_NAME``'s family (``Transformer``,
    ``Bert`` or ``MLP``) in place of the seeded init or ``MODEL_PATH``.
    ``metrics``: the app's registry (a private one when omitted).

    The constructor parses and validates the configuration (no device is
    touched); the boot then probes the device, builds the runner, the
    kernels (nvcc at first use), the pool and the batcher, and warms them,
    each step a stage in ``boot_status``. ``TPU_BOOT=background`` runs the
    boot on a thread: ``ready()`` is False and requests wait
    (``wait_ready``) until it ends; a boot that fails leaves
    ``boot_status["state"] == "failed"`` and every request fails with its
    error. A foreground boot's failure raises from the constructor.

    Overload and failure (``failure_options``): the generation journal
    (``journal``, on a ``JournalWAL`` under ``JOURNAL_DIR``, rehydrated
    here before serving), the ``brownout`` controller reading the batcher's
    queue depth and the block pool's committed KV, and the ``recovery``
    supervisor, whose ``recover`` tears the stack down and rebuilds it over
    the SAME weights (taken from the old runner, never reloaded) through
    warming back to serving."""

    def __init__(self, config: Any, logger: Any, model: Any = None,
                 draft_model: Optional[Transformer] = None, metrics: Any = None):
        self.logger = logger
        self.metrics = metrics if metrics is not None else Registry()
        self.model_name = config.get_or_default("MODEL_NAME", "mlp")
        self._device_name = config.get_or_default("TORCH_DEVICE", "cuda")
        if self._device_name not in ("cuda", "cpu"):
            raise ValueError(f"TORCH_DEVICE {self._device_name!r} not supported — use cuda or cpu")
        self.device: Optional[torch.device] = None  # probed by the boot
        self.max_batch = int(config.get_or_default("BATCH_MAX_SIZE", "8"))
        self.timeout_ms = float(config.get_or_default("BATCH_TIMEOUT_MS", "5"))
        raw_max_seq = config.get("MODEL_MAX_SEQ")
        raw_buckets = config.get_or_default("MODEL_BUCKETS", "").strip()
        buckets = (
            tuple(sorted(int(b) for b in raw_buckets.split(","))) if raw_buckets else None
        )
        if buckets and buckets[0] <= 0:
            raise ValueError(f"MODEL_BUCKETS entries must be positive, got {raw_buckets!r}")
        self.options = serving_options(config, self.max_batch)
        self.spec_options = spec_options(config)
        obs = observability_options(config)
        self.echo_step_ms = float(config.get_or_default("ECHO_STEP_MS", "0"))
        if self.echo_step_ms < 0:
            raise ValueError("ECHO_STEP_MS must be >= 0")
        # validated here, so a typo fails at startup
        self.quant = config.get_or_default("MODEL_QUANT", "").strip() or None
        quantizer_for(self.quant)
        kv_dtype = parse_kv_dtype(config.get_or_default("MODEL_KV_DTYPE", ""))
        self.model_path = config.get("MODEL_PATH") or None
        # named adapter artifacts served over the one base (runtime loads
        # and unloads keep this spec in step), and the lock that serializes
        # adapter admin with the pool's bank rebuild
        self._lora_adapters = parse_lora_adapters(config.get_or_default("LORA_ADAPTERS", ""))
        self._adapter_lock = threading.Lock()
        self.tokenizer = load_tokenizer(config)
        # default stops end every generation; request stops compose with them
        self.default_stop_ids = resolve_default_stop_ids(config, self.tokenizer)
        self._init_metrics(self.metrics)
        # engine introspection, built before any boot work so the probe is
        # already observable: the state machine, the cost model (before the
        # timeline: every record flows through its hooks; its coefficients
        # resolve at the probe, when the card is known), the dispatch
        # timeline and the stall watchdog
        self.engine = EngineState(metrics=self.metrics, logger=logger)
        self.costmodel: Optional[CostModel] = None
        if obs["costmodel"]:
            self.costmodel = CostModel(
                metrics=self.metrics, logger=logger, profile_path=obs["costmodel_profile"],
                anomaly_factor=obs["anomaly_factor"], min_anomaly_ms=obs["min_anomaly_ms"],
                ema_alpha=obs["ema_alpha"], ema_band=obs["ema_band"], ring_size=obs["ring_size"],
            )
        self.timeline = DispatchTimeline(
            capacity=obs["timeline_size"], metrics=self.metrics, costmodel=self.costmodel
        )
        self.watchdog = StallWatchdog(
            self.engine, metrics=self.metrics, logger=logger, timeout_s=obs["watchdog_timeout"]
        )
        self._watchdog_auto = obs["watchdog_auto"]
        fail = failure_options(config)
        # the generation journal, durable under JOURNAL_DIR: the WAL
        # rehydrates a killed process's resumable entries before serving
        self.journal_wal: Optional[JournalWAL] = None
        self.journal: Optional[GenerationJournal] = None
        if fail["journal"]:
            if fail["journal_dir"]:
                self.journal_wal = JournalWAL(
                    fail["journal_dir"], segment_bytes=fail["journal_segment_bytes"],
                    retain=fail["journal_segments"], fsync=fail["journal_fsync"], logger=logger,
                )
            self.journal = GenerationJournal(
                capacity=fail["journal_capacity"], max_tokens=fail["journal_max_tokens"],
                metrics=self.metrics, wal=self.journal_wal,
            )
            if self.journal_wal is not None and self.journal.rehydrate():
                logger.infof("journal WAL: rehydrated %s resumable entries from %s",
                             self.journal.rehydrated, fail["journal_dir"])
        # the brownout's signals read the batcher and the block pool through
        # the device: a recovery rebuilds both
        self.brownout = BrownoutController(
            metrics=self.metrics, queue_hi=fail["brownout_queue_hi"],
            kv_hi=fail["brownout_kv_hi"], shed_priority=fail["brownout_shed_priority"],
            clamp_tokens=fail["brownout_clamp"], queue_depth_fn=self._brownout_queue_depth,
            kv_util_fn=self._brownout_kv_util,
        )
        self.recovery = RecoverySupervisor(
            self, metrics=self.metrics, logger=logger,
            max_attempts=fail["recovery_attempts"], backoff_s=fail["recovery_backoff"],
            backoff_max_s=fail["recovery_backoff_max"],
            attempt_timeout_s=fail["recovery_attempt_timeout"],
            enabled=fail["recovery_enabled"],
        )
        self._reinit_lock = threading.Lock()
        self.platform = "pending"
        self.device_kind = "pending"
        self.peak_flops = 0.0
        self.peak_hbm_bw = 0.0
        # per-stage boot wall times ({stage, kind, bucket, seconds, status})
        # for /admin/engine; stages with a kind feed the compile families
        self.boot_timeline: list[dict[str, Any]] = []
        self._open_stage: Optional[tuple] = None
        # the prefill MFU gauge's steady window: completions arrive from the
        # batcher's dispatch threads
        self._last_batch_done = 0.0
        self._mfu_window_lock = threading.Lock()
        self._build_args = (config, kv_dtype, raw_max_seq, buckets,
                            int(config.get_or_default("MODEL_SEED", "0")))
        # a given model is the first stack's; a rebuild carries the old
        # runner's over
        self._given_models: Optional[tuple] = (model, draft_model)
        self.runner: Any = None
        self.scheduler: Optional[InterferenceScheduler] = None
        self.kv_pool: Optional[BlockPool] = None
        self.decode_pool: Optional[DecodePool] = None
        self.batcher: Optional[DynamicBatcher] = None
        self.boot_seconds = 0.0
        # surfaced by /.well-known/ready and health: a slow boot (the
        # kernels' build, an 8B init) is observable, never a silent hang
        self.boot_status: dict[str, Any] = {"state": "booting", "detail": ""}
        self._ready = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._closed = False
        if config.get_or_default("TPU_BOOT", "") == "background":
            threading.Thread(target=self._boot, name="gofr-tpu-boot", daemon=True).start()
        else:
            self._boot()

    def _init_metrics(self, metrics: Any) -> None:
        """The device's families, as the JAX device registers them (its
        mesh families come with a later slice). The port compiles nothing
        per shape: its "compiles" are the boot's once-only stages (the
        kernels' nvcc build, the warm-up prefill per bucket, the pool's
        warm chunk), and its one cache is the prefix cache."""
        self._requests = metrics.counter(
            "gofr_tpu_requests_total", "TPU inference requests", labels=("model", "op", "status")
        )
        self._ttft = metrics.histogram(
            "gofr_tpu_ttft_seconds", "time to first token / result", labels=("model", "op")
        )
        self._mem_gauge = metrics.gauge(
            "gofr_tpu_device_memory_bytes", "device memory", labels=("kind",)
        )
        self._mfu_gauge = metrics.gauge(
            "gofr_tpu_mfu",
            "model FLOPs utilization of the last dispatch (2*N*tokens/time/peak)",
            labels=("model", "op"),
        )
        self._tokens_counter = metrics.counter(
            "gofr_tpu_tokens_total", "tokens processed", labels=("model", "op")
        )
        self._spec_gauge = metrics.gauge(
            "gofr_tpu_spec_acceptance",
            "speculative decoding: accepted draft tokens / drafted",
            labels=("model",),
        )
        self._prefix_gauge = metrics.gauge(
            "gofr_tpu_prefix_hit_ratio",
            "prefix cache: exact prompt hits / lookups",
            labels=("model",),
        )
        self._prefix_partial_gauge = metrics.gauge(
            "gofr_tpu_prefix_partial_hit_ratio",
            "prefix cache: shared-prefix (tail-only prefill) hits / lookups",
            labels=("model",),
        )
        # each entry is one max_seq KV row (blocks, when paged)
        self._prefix_entries_gauge = metrics.gauge(
            "gofr_tpu_prefix_entries",
            "prefix cache: live entries (each one max_seq KV row of HBM)",
            labels=("model",),
        )
        self._compile_hist = metrics.histogram(
            "gofr_tpu_compile_seconds",
            "XLA compile stage duration by kind and sequence bucket",
            labels=("kind", "bucket"), buckets=COMPILE_BUCKETS,
        )
        self._compiles = metrics.counter(
            "gofr_tpu_compiles_total",
            "XLA compile stages run (warmup and lazy)",
            labels=("kind",),
        )
        self._cache_events = metrics.counter(
            "gofr_tpu_cache_events_total",
            "framework cache lookups by result: cache=prefix (prompt KV "
            "reuse) or executable (compiled-shape reuse on the decode/"
            "prefill paths), event=hit|partial_hit|miss",
            labels=("cache", "event"),
        )

    # -- the boot ------------------------------------------------------------
    def _boot(self) -> None:
        start = time.perf_counter()
        del self.boot_timeline[:]
        try:
            self._probe()
            given, self._given_models = self._given_models, None
            self._build_stack(*given)
        except BaseException as exc:
            self._close_boot_stage(status="error")
            self._boot_error = exc
            self.boot_status = {"state": "failed", "detail": repr(exc)}
            self.engine.transition("failed", repr(exc))
            self._ready.set()
            if threading.current_thread().name == "gofr-tpu-boot":
                self.logger.errorf("device boot failed: %r", exc)
                return
            raise
        self._close_boot_stage()
        self.boot_seconds = time.perf_counter() - start
        if self._closed:
            # closed while the background boot built: tear the new stack
            # down instead of leaking its threads and buffers
            self._boot_error = RuntimeError("device closed during boot")
            self.boot_status = {"state": "closed", "detail": ""}
            self.engine.transition("closed")
            self._teardown_stack()
            self._ready.set()
            return
        self.boot_status = {"state": "ready", "detail": ""}
        self.engine.transition("serving")
        self._ready.set()
        self.logger.infof("device ready: %s", self.describe())

    def _probe(self) -> None:
        """The boot's first touch of the card, a ``device_probe`` dispatch
        under the watchdog (echo touches no device: its probe is empty, as
        its runner runs on the host). Then the peaks the MFU/MBU gauges
        divide by, the cost model's coefficients for this card, and, on a
        cuda device with no WATCHDOG_DISPATCH_TIMEOUT_S set, the watchdog
        armed at ``WATCHDOG_AUTO_TIMEOUT_S``."""
        echo = self.model_name == "echo"
        self._boot_progress(
            "echo: no device to probe" if echo
            else f"probing the device (TORCH_DEVICE={self._device_name})"
        )
        rec = self.timeline.begin(
            "device_probe", detail="none (echo)" if echo else f"torch {self._device_name}"
        )
        try:
            with self.watchdog.watch("device_probe", rec.dispatch_id):
                if not echo:
                    self.device = resolve_device(self._device_name)
        except BaseException:
            self.timeline.finish(rec, status="error")
            raise
        self.timeline.finish(rec)
        if self.device is not None and self.device.type == "cuda":
            self.platform = "gpu"
            self.device_kind = torch.cuda.get_device_name(self.device)
            if self._watchdog_auto:
                self.watchdog.arm(WATCHDOG_AUTO_TIMEOUT_S)
        else:
            self.platform = self.device_kind = "cpu"
        self.peak_flops = device_peak_flops(self.device_kind, self.platform, quant=self.quant or "")
        self.peak_hbm_bw = device_peak_hbm_bw(self.device_kind, self.platform)
        if self.costmodel is not None:
            self.costmodel.calibrate(self.device_kind, self.platform)

    def _boot_progress(self, detail: str, kind: str = "", bucket: int = 0) -> None:
        """One boot stage: logged, the readiness body's detail and the
        engine's warming detail; it closes the previous stage into the boot
        timeline. A stage with a ``kind`` is a compile stage: it is also a
        ``warmup_compile`` dispatch and feeds
        ``gofr_tpu_compile_seconds{kind,bucket}``."""
        self._close_boot_stage()
        self.boot_status = {"state": "warming", "detail": detail}
        self.engine.transition("warming", detail)
        rec = (
            self.timeline.begin("warmup_compile", bucket=bucket, detail=detail)
            if kind else None
        )
        self._open_stage = (detail, kind, bucket, time.perf_counter(), rec)
        self.logger.infof("device boot [%s]: %s", self.model_name, detail)

    def _close_boot_stage(self, status: str = "ok") -> None:
        if self._open_stage is None:
            return
        detail, kind, bucket, start, rec = self._open_stage
        self._open_stage = None
        seconds = time.perf_counter() - start
        self.boot_timeline.append({
            "stage": detail, "kind": kind or None, "bucket": bucket or None,
            "seconds": round(seconds, 3), "status": status,
        })
        if kind and status == "ok":
            # a stage the boot died in keeps its truncated time out
            self._compile_hist.observe(seconds, kind=kind, bucket=str(bucket))
            self._compiles.inc(kind=kind)
        if rec is not None:
            self.timeline.finish(rec, status=status)

    def _build_stack(self, model: Any = None, draft_model: Optional[Transformer] = None,
                     carried: bool = False) -> None:
        """The runner, its serving machinery and the batcher, warmed.
        ``model`` / ``draft_model``: weights to build on, given at
        construction or ``carried`` over from the runner a recovery tore
        down (then MODEL_PATH and DRAFT_MODEL_PATH are not read again)."""
        config, kv_dtype, raw_max_seq, buckets, seed = self._build_args
        name = self.model_name
        if self.device is not None and self.device.type == "cuda":
            # bf16 products accumulate in f32 (models/quant.py::mm)
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        # the JAX package's runner selection (``_build_runner``), its
        # checks in its order; mlp and bert deployments build no scheduler,
        # pool, paged KV, speculation or adapter bank
        if self._lora_adapters and name not in CONFIGS:
            raise ValueError(f"LORA_ADAPTERS requires a transformer MODEL_NAME (got '{name}')")
        if name == "echo" or name in CONFIGS:
            # ONE scheduler shared by both dispatchers: the pool notes its
            # chunk cadence, prefill dispatches (batcher cohorts and chunked
            # slices) wait for their turn
            opts = self.options
            self.scheduler = InterferenceScheduler(
                policy=opts["sched_policy"], max_defer_ms=opts["sched_max_defer_ms"],
                metrics=self.metrics, model=name,
            )
        self._boot_progress("building runner (model init / checkpoint load)")
        if name == "echo":
            self.runner = _EchoRunner(step_ms=self.echo_step_ms, metrics=self.metrics)
            self._wire_echo()
            if self.costmodel is not None:
                # one echo prefill or decode step costs one ECHO_STEP_MS
                # sleep whatever its shape: the synthetic sheets the JAX
                # echo device installs
                self.costmodel.install_synthetic("prefill", self.echo_step_ms)
                self.costmodel.install_synthetic("decode_chunk", self.echo_step_ms)
        elif name in ("mlp", "tiny-mlp"):
            self.runner = _MLPRunner(self.device, self.max_batch, seed, model,
                                     None if carried else self.model_path)
        elif name.startswith("bert"):
            self.runner = _BertRunner(name, self.device, self.max_batch, seed, model,
                                      None if carried else self.model_path, self.quant)
        elif name in CONFIGS:
            self._init_decoder(config, model, draft_model, kv_dtype, raw_max_seq, buckets, seed,
                               carried)
        else:
            raise ValueError(
                f"unknown MODEL_NAME '{name}' — expected echo, mlp, bert-tiny, "
                f"bert-base, or one of {sorted(CONFIGS)}"
            )
        if not self.is_decoder:
            # the kernels' build and first launches happen in the boot, not
            # at the first request (the decoder warms in _init_decoder)
            self.runner.warmup(self._boot_progress)
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # boot time includes the init
        self.batcher = DynamicBatcher(
            self._run_batch,
            max_batch=self.max_batch,
            timeout_ms=self.timeout_ms,
            name=self.model_name,
            bucket_fn=getattr(self.runner, "bucket_for_payload", None),
            scheduler=self.scheduler,
            metrics=self.metrics,
            timeline=self.timeline,
            watchdog=self.watchdog,
        )

    def _wire_echo(self) -> None:
        """The echo runner's paged store (``KV_PAGED``, on by default: a
        host arena, ``KV_BLOCKS`` of them or 1024) and its pooled
        speculation (``SPEC_POOLED``, with the ``SPEC_FAKE_ACCEPT``
        schedule), as the JAX device wires them."""
        opts, spec = self.options, self.spec_options
        if opts["kv_paged"]:
            bt = opts["kv_block_tokens"]
            n_blocks = opts["kv_blocks"] or 1024  # ~64k tokens of host "KV"
            arena = HostTokenArena(n_blocks, bt)
            pool = BlockPool(
                n_blocks, bt, block_bytes=arena.block_bytes,
                hbm_budget_bytes=n_blocks * arena.block_bytes,
                # echo has no PREFIX_CACHE of its own: reuse it when set
                cache_entries=opts["prefix_cache"] or 32, metrics=self.metrics,
            )
            lcp_min = opts["prefix_lcp_min"]
            if lcp_min == 0:
                lcp_min = 8  # echo has no buckets to anchor on
            elif lcp_min < 0:
                lcp_min = 1 << 30  # -1 = exact hits only
            self.runner.enable_paged_kv(HostPagedKV(pool, arena, lcp_min=lcp_min),
                                        reject_counter=pool_reject_counter(self.metrics))
            self.kv_pool = pool
        if spec["spec_pooled"]:
            self.runner.enable_pooled_spec(self._spec_config(include_fake=True))

    def _spec_config(self, include_fake: bool) -> PoolSpecConfig:
        """Pooled speculation's settings and gauges; the scripted
        ``SPEC_FAKE_ACCEPT`` source is the echo runner's alone."""
        spec = self.spec_options
        return PoolSpecConfig(
            k_max=spec["spec_k_max"], ngram=spec["spec_ngram"],
            fake_schedule=spec["spec_fake_accept"] if include_fake else None,
            brownout_level=self.brownout.level, metrics=self.metrics, model=self.model_name,
        )

    def _teardown_stack(self, recovery: bool = False) -> None:
        """Close the pool, the batcher and the runner, each even if another
        fails. A ``recovery`` teardown bounds the pool's join and never
        raises for it: the old worker may sit in a wedged wait."""
        runner_close = getattr(self.runner, "close", None)
        try:
            if self.decode_pool is not None:
                if recovery:
                    self.decode_pool.close(timeout=RECOVERY_POOL_JOIN_S, strict=False)
                else:
                    self.decode_pool.close()
        finally:
            try:
                if self.batcher is not None:
                    self.batcher.close()
            finally:
                if runner_close is not None:
                    runner_close()

    def _carried_models(self) -> tuple:
        """The weights a rebuild keeps: the old runner's model and its solo
        speculation's draft (None for echo)."""
        runner = self.runner
        spec = getattr(runner, "spec", None)
        return getattr(runner, "model", None), spec.model if spec is not None else None

    # -- wedge recovery --------------------------------------------------------
    def recover(self, detail: str = "") -> None:
        """The recovery supervisor's rebuild: teardown, a fresh probe and the
        stack rebuilt over the same weights, walking the engine through
        ``warming`` to ``serving``. Readiness clears meanwhile (a resume
        arriving mid-rebuild waits in ``wait_ready``); a failed rebuild
        leaves the boot error set and the event set, so waiters fail fast."""
        with self._reinit_lock:
            self._ready.clear()
            self.boot_status = {"state": "recovering", "detail": detail or "recovery rebuild"}
            try:
                self._reinit_locked(detail or "recovered")
            except BaseException as exc:
                self._boot_error = exc
                self.boot_status = {"state": "failed", "detail": repr(exc)}
                self._ready.set()
                raise

    def _reinit_locked(self, detail: str) -> None:
        self.logger.warnf("rebuilding the device stack (model=%s)", self.model_name)
        models = self._carried_models()
        # the old stack may be wedged: its requests fail (their journal
        # entries stay interrupted), and a kernel still queued on the card
        # keeps running; the rebuilt stack's first work queues behind it
        self._teardown_stack(recovery=True)
        self.runner = self.decode_pool = self.batcher = self.kv_pool = None
        del self.boot_timeline[:]
        try:
            self._reprobe()
            self.engine.transition("warming", "recovery rebuild")
            self._build_stack(*models, carried=True)
        except BaseException:
            self._close_boot_stage(status="error")
            raise
        self._close_boot_stage()
        if self._closed:
            # closed while the rebuild ran: tear the new stack down
            self._boot_error = RuntimeError("device closed during rebuild")
            self.boot_status = {"state": "closed", "detail": ""}
            self.engine.transition("closed")
            self._teardown_stack(recovery=True)
            self._ready.set()
            return
        self._boot_error = None
        self.boot_status = {"state": "ready", "detail": ""}
        self.engine.transition("serving", detail)
        self._ready.set()

    def _reprobe(self) -> None:
        """The rebuild's probe. On a card it also synchronizes: a CUDA
        device fault (error 719 and the like) is sticky, so it fails here,
        and every attempt after it, with an error that names it and says a
        process restart is needed."""
        try:
            self._probe()
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except Exception as exc:
            if "CUDA" in str(exc) or "cuda" in type(exc).__name__.lower():
                raise RuntimeError(
                    f"{exc} — a CUDA device fault is sticky (every later CUDA call of this "
                    "process fails): a process restart is needed"
                ) from exc
            raise

    def _brownout_queue_depth(self) -> int:
        """Brownout signal: requests waiting for a prefill batch (0 with no
        batcher: a booting server sheds nothing)."""
        batcher = self.batcher
        return batcher._depth() if batcher is not None else 0

    def _brownout_kv_util(self) -> float:
        """Brownout signal: the committed share of the paged-KV ledger
        (active rows and reservations; cached prefix blocks evict on
        demand and are left out). 0 without a block pool."""
        kv = self.kv_pool
        if kv is None:
            return 0.0
        stats = kv.stats()
        budget = stats.get("ledger") or stats.get("total") or 0
        if not budget:
            return 0.0
        return min(1.0, (stats.get("active", 0) + stats.get("reserved", 0)) / budget)

    # -- readiness (distinct from liveness) ----------------------------------
    def ready(self) -> bool:
        return self._ready.is_set() and self._boot_error is None

    def wait_ready(self, timeout: Optional[float] = 600.0) -> None:
        """Block until the boot ended; a failed or closed boot raises a 503
        that names its error. Request paths call it, so a request that
        arrives during a background boot waits."""
        if not self._ready.wait(timeout):
            raise HTTPError(
                503, f"device boot still {self.boot_status['state']} "
                     f"({self.boot_status['detail']}) after {timeout}s"
            )
        if self._boot_error is not None:
            raise HTTPError(503, f"device boot failed: {self._boot_error!r}") \
                from self._boot_error
        if self._closed:
            raise RuntimeError("device is closed")

    @property
    def is_decoder(self) -> bool:
        """Whether the runner is a decoder (generate, score, adapters)."""
        return isinstance(self.runner, _TransformerRunner)

    def _init_decoder(self, config: Any, model: Optional[Transformer],
                      draft_model: Optional[Transformer], kv_dtype: Optional[torch.dtype],
                      raw_max_seq: Optional[str], buckets: Optional[tuple], seed: int,
                      carried: bool = False) -> None:
        """The decoder's runner and its serving machinery: paged KV and the
        decode pool, warmed."""
        opts, spec = self.options, self.spec_options
        self.runner = _TransformerRunner(
            self.model_name,
            self.device,
            max_batch=self.max_batch,
            decode_chunk=int(config.get_or_default("DECODE_CHUNK", "8")),
            max_seq=int(raw_max_seq) if raw_max_seq else None,
            buckets=buckets,
            seed=seed,
            model=model,
            model_path=None if carried else self.model_path,
            quant=self.quant,
            kv_dtype=kv_dtype,
            prefix_cache=opts["prefix_cache"],
            prefix_lcp_min=opts["prefix_lcp_min"],
            prefill_chunk_tokens=opts["prefill_chunk_tokens"],
            kv_paged=opts["kv_paged"],
            kv_block_tokens=opts["kv_block_tokens"],
            kv_blocks=opts["kv_blocks"],
            kv_reserve_seqs=opts["pool_slots"],
            draft_name=spec["draft_name"],
            draft_tokens=spec["draft_tokens"],
            draft_path=None if carried else spec["draft_path"],
            draft_model=draft_model,
            lora_adapters=self._lora_adapters,
            metrics=self.metrics,
            timeline=self.timeline,
            watchdog=self.watchdog,
            cache_events=self._note_cache_event,
        )
        if self.runner.kv_paged_disabled:
            self.logger.warnf("paged KV disabled: %s", self.runner.kv_paged_disabled)
        self.kv_pool = self.runner.kv_pool
        self.runner.warmup(self._boot_progress)
        if self.costmodel is not None:
            self._install_sheets(opts)
        # continuous batching: concurrent decodes share one dispatch per
        # chunk; seeded requests bypass it (generate routes them solo). The
        # pool's admission reserves each request's KV blocks on the SAME
        # BlockPool the prefix cache stores into
        if opts["pool_enabled"]:
            self._boot_progress(f"warming decode pool ({opts['pool_slots']} slots)",
                                kind="decode_pool")
            self.decode_pool = DecodePool(
                self.runner.model, n_slots=opts["pool_slots"],
                chunk=self.runner.decode_chunk_size, pipeline_depth=opts["pool_depth"],
                scheduler=self.scheduler, kv=self.kv_pool, penalties=opts["pool_penalties"],
                cache_dtype=self.runner.cache_dtype,
                spec=self._spec_config(include_fake=False) if spec["spec_pooled"] else None,
                metrics=self.metrics, model_name=self.model_name,
                timeline=self.timeline, watchdog=self.watchdog,
                n_params=self.runner.n_params, peak_flops=self.peak_flops,
                peak_hbm_bw=self.peak_hbm_bw,
            )
            if self.runner.adapters:
                self._boot_progress("warming pooled multi-LoRA bank", kind="lora_bank")
                self._refresh_pool_lora()

    def _install_sheets(self, opts: dict) -> None:
        """The decoder's analytic cost sheets (``costmodel.transformer_sheet``):
        a batched prefill per bucket at the batcher's padded batch (causal
        from position 0), a chunked slice at batch 1, and the pool's decode
        chunk over its slots, priced at half the cache window a step (the
        rows' lengths vary; the record's own MBU reads their true lengths)."""
        runner, cfg = self.runner, self.runner.cfg
        weights = float(runner.weight_bytes)
        kv_tok = float(runner.kv_bytes_per_token)
        bsz = next_pow2(self.max_batch)
        for bucket in runner.buckets:
            pairs = bucket * (bucket + 1) / 2
            flops, nbytes = transformer_sheet(cfg, weights, kv_tok, bsz, bucket, pairs, 0)
            self.costmodel.install_analytic("prefill", bucket, bsz, flops, nbytes)
            flops, nbytes = transformer_sheet(cfg, weights, kv_tok, 1, bucket, pairs, 0)
            self.costmodel.install_analytic("prefill_chunk", bucket, 1, flops, nbytes)
        if opts["pool_enabled"]:
            slots, window = opts["pool_slots"], cfg.max_seq / 2
            flops, nbytes = transformer_sheet(cfg, weights, kv_tok, slots, 1, window, window,
                                              steps=runner.decode_chunk_size)
            self.costmodel.install_analytic("decode_chunk", 0, slots, flops, nbytes)

    def describe(self) -> str:
        if self.runner is None:
            return f"model={self.model_name} boot={self.boot_status['state']}"
        if self.device is None:
            return f"model={self.model_name} device=none (loopback) boot={self.boot_seconds:.1f}s"
        kind = (
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "cpu"
        )
        if not self.is_decoder:
            return (f"model={self.model_name} device={kind} {self.runner.describe()} "
                    f"boot={self.boot_seconds:.1f}s")
        pool = self.decode_pool
        return (
            f"model={self.model_name} device={kind} max_seq={self.runner.cfg.max_seq} "
            f"buckets={self.runner.buckets} decode_pool="
            f"{f'{pool.n_slots} slots' if pool else 'off'} "
            f"kv_paged={'off' if self.kv_pool is None else 'on'} "
            f"prefix_cache={self.options['prefix_cache']} quant={self.quant or 'off'} "
            f"kv_dtype={str(self.runner.cache_dtype).replace('torch.', '')} "
            f"draft={self.spec_options['draft_name'] or 'off'}"
            f"{f' k={self.runner.spec.k}' if self.runner.spec else ''} "
            f"spec_pooled={'on' if pool and pool.spec_cfg else 'off'} "
            f"adapters={len(self.runner.adapters)} "
            f"boot={self.boot_seconds:.1f}s"
        )

    def health_check(self) -> dict:
        """UP while booting (alive, not yet ready: readiness is the gate),
        DOWN after a failed boot or a close, else UP with the device's
        allocator bytes (host bookkeeping, no device read)."""
        details: dict[str, Any] = {
            "model": self.model_name,
            "device": str(self.device) if self.device is not None else None,
        }
        if not self._ready.is_set():
            return {"status": "UP", "details": {**details, "boot": dict(self.boot_status)}}
        if self._boot_error is not None:
            return {"status": "DOWN", "details": {**details, "boot": dict(self.boot_status)}}
        if self.device is not None and self.device.type == "cuda":
            used = torch.cuda.memory_stats(self.device).get("allocated_bytes.all.current", 0)
            limit = torch.cuda.get_device_properties(self.device).total_memory
            details["memory_bytes_in_use"] = used
            details["memory_bytes_limit"] = limit
            self._mem_gauge.set(used, kind="in_use")
            self._mem_gauge.set(limit, kind="limit")
        return {"status": "DOWN" if self._closed else "UP", "details": details}

    def _run_batch(self, payloads: list) -> list:
        """The batcher's dispatch: the runner's batched forward (it ends at
        its host sync, so ``elapsed`` covers the card's work), then for
        runners with a parameter count (the decoder and the encoder) the
        prefill's true tokens, ``gofr_tpu_mfu{op="prefill"}`` over the
        steady window and the dispatch record's own MFU (the analytic
        sheet's flops where one exists, else 2·N·tokens)."""
        start = time.perf_counter()
        results = self.runner.run_batch(payloads)
        elapsed = time.perf_counter() - start
        tokens = sum(int(getattr(p, "size", 0)) for p in payloads)
        drec = current_dispatch()  # the batcher activated this dispatch
        if drec is not None:
            drec.tokens = tokens
        n_params = getattr(self.runner, "n_params", None)
        if n_params and tokens:
            # the interval between completions under load (the batcher
            # pipelines dispatches), floored at elapsed / its depth so an
            # idle-then-burst pair cannot spike the gauge
            depth = getattr(self.batcher, "pipeline_depth", 2)
            with self._mfu_window_lock:
                done = time.perf_counter()
                steady = max(done - max(done - elapsed, self._last_batch_done), elapsed / depth)
                self._last_batch_done = done
            self._tokens_counter.inc(tokens, model=self.model_name, op="prefill")
            self._mfu_gauge.set(mfu(n_params, tokens, steady, self.peak_flops),
                                model=self.model_name, op="prefill")
            if drec is not None:
                flops = (
                    self.costmodel.sheet_flops("prefill", drec.bucket, drec.batch_size)
                    if self.costmodel is not None else None
                )
                drec.mfu = (mfu_from_flops(flops, elapsed, self.peak_flops) if flops
                            else mfu(n_params, tokens, elapsed, self.peak_flops))
        return results

    def _note_cache_event(self, cache: str, event: str) -> None:
        """Runner callback: one prefix-cache lookup resolved as ``event``
        (hit | partial_hit | miss)."""
        self._cache_events.inc(cache=cache, event=event)

    def _observe(self, op: str, status: str, start: float) -> None:
        self._requests.inc(model=self.model_name, op=op, status=status)
        if status == "ok":
            self._ttft.observe(time.perf_counter() - start, model=self.model_name, op=op)

    # -- the batched forward of any runner (the JAX package's infer) -------------
    def infer(self, payload: Any, timeout: float = 60.0) -> Any:
        """Blocking single inference through the dynamic batcher (sync
        handlers). The payload is the runner's: a feature vector for the
        MLP, ids (or ``{"tokens": [...]}``) for BERT and the decoder, or
        text (a str or ``{"text": ...}``) with a tokenizer. The MLP returns
        its output row, BERT the embedding, the decoder its prefill state
        (``next_token`` is the greedy next id)."""
        wait_start = time.perf_counter()
        self.wait_ready(timeout)
        # the batcher gets what remains of the caller's budget
        remaining = max(0.001, timeout - (time.perf_counter() - wait_start))
        start = time.perf_counter()
        try:
            result = self.batcher.infer(self._prepare(payload), timeout=remaining)
        except Exception:
            self._observe("infer", "error", start)
            raise
        self._observe("infer", "ok", start)
        return result

    async def infer_async(self, payload: Any) -> Any:
        """``infer`` for async handlers: a multi-item request awaits its
        items together, so they pack into one dispatch. During a
        background boot it waits off the event loop."""
        if not self._ready.is_set():
            import asyncio

            await asyncio.get_running_loop().run_in_executor(None, self.wait_ready, 600.0)
        self.wait_ready()
        start = time.perf_counter()
        try:
            result = await self.batcher.infer_async(self._prepare(payload))
        except Exception:
            self._observe("infer", "error", start)
            raise
        self._observe("infer", "ok", start)
        return result

    def _prepare(self, payload: Any) -> Any:
        return self.runner.prepare(self._detokenize(payload))

    def _detokenize(self, payload: Any) -> Any:
        """A text payload (a str, or ``{"text": ...}``) becomes
        ``{"tokens": ids}`` through the tokenizer."""
        text = None
        if isinstance(payload, str):
            text = payload
        elif isinstance(payload, dict) and isinstance(payload.get("text"), str):
            text = payload["text"]
        if text is None:
            return payload
        if self.tokenizer is None:
            raise InvalidParamError(
                "text (no tokenizer configured — set TOKENIZER=byte or "
                "TOKENIZER_PATH, or send token ids)"
            )
        return {"tokens": self.tokenizer.encode(text)}

    def _generator(self) -> Any:
        """The runner that generates (the decoder or echo); the MLP and the
        encoder raise the JAX runners' NotImplementedError (a 500 over
        HTTP)."""
        if not (self.is_decoder or isinstance(self.runner, _EchoRunner)):
            raise NotImplementedError("generate() requires a transformer model")
        return self.runner

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
        logprobs: bool = False,
        top_logprobs: bool = False,
        adapter: Optional[str] = None,
        adapter_params: Optional[Transformer] = None,
        journal_key: Optional[str] = None,
        journal_prior: Optional[list] = None,
        resume_from: int = 0,
    ) -> "list[int] | tuple":
        """Autoregressive generation (see the module docstring for the
        route). ``adapter`` names a loaded LoRA adapter (an unknown one is
        an InvalidParamError); ``adapter_params`` is the adapter model a
        stream pinned at its eager check, which a concurrent unload must
        not take from it. ``on_token`` receives each id as it decodes; ``stop`` (a
        threading.Event) aborts between chunks; ``tokens`` may be a str when
        a tokenizer is configured; ``sampler`` sets temperature/top-k/top-p
        (default greedy); ``stop_tokens`` end generation without being
        emitted. Returns the ids; with ``logprobs`` (ids, the chosen
        tokens' raw log-softmax values), and ``on_token`` then receives
        (id, logprob) pairs; with ``top_logprobs`` (ids, logprobs, tops),
        tops[i] the ``TOP_LOGPROBS`` [(alt id, alt logprob), ...] at
        position i, best first.

        The journal (when on) records every emitted id under the request's
        key; the entry retires at a clean finish and stays, interrupted,
        when the generation fails. The resume path passes ``journal_key``
        (the ORIGINAL request's key, for a continuation over prompt +
        emitted), ``journal_prior`` (the ids already emitted) and, for the
        echo runner, ``resume_from`` (its decode is position-indexed, so it
        resumes natively)."""
        self.wait_ready()
        runner = self._generator()
        self._check_bias(sampler)
        tokens = self._encode(tokens)
        stop_tokens = frozenset(stop_tokens or ()) | self.default_stop_ids
        start = time.perf_counter()
        record = current_record()
        entry = self._journal_start(tokens, max_new_tokens, sampler, stop_tokens, adapter,
                                    journal_key, journal_prior)

        def ttft() -> None:
            # the callback may fire on a thread without the request's
            # context: the captured record carries its trace id
            exemplar = ({"trace_id": record.trace_id}
                        if record is not None and record.trace_id else None)
            self._ttft.observe(time.perf_counter() - start, exemplar=exemplar,
                               model=self.model_name, op="generate")
            if record is not None:
                record.mark_first_token()

        emit = on_token
        if record is not None or entry is not None:
            def emit(item: Any, _cb: Any = on_token) -> None:
                if record is not None:
                    record.note_tokens(1)
                if entry is not None:
                    # the bare id: (id, logprob) pairs ride logprob runs
                    entry.append(item[0] if isinstance(item, tuple) else item)
                if _cb is not None:
                    _cb(item)
        extra = {"resume_from": resume_from} if resume_from and self.supports_resume else {}
        journal_token = activate_journal_entry(entry) if entry is not None else None
        try:
            out = runner.generate(
                tokens, max_new_tokens, on_token=emit, stop=stop,
                sampler=sampler, stop_tokens=stop_tokens, decode_pool=self.decode_pool,
                prefill_batcher=self.batcher, scheduler=self.scheduler,
                logprobs=logprobs, top_logprobs=top_logprobs, adapter=adapter,
                adapter_params=adapter_params, ttft_cb=ttft, **extra,
            )
        except Exception as exc:
            if record is not None:
                record.note_error(exc)
            if entry is not None:
                # kept: an interrupted request resumes from this entry
                self.journal.interrupt(entry, f"{type(exc).__name__}: {exc}")
            self._requests.inc(model=self.model_name, op="generate", status="error")
            raise
        finally:
            if journal_token is not None:
                activate_journal_entry(None)
        if entry is not None:
            self.journal.finish(entry)
        self._requests.inc(model=self.model_name, op="generate", status="ok")
        self._note_generation()
        return out

    @property
    def supports_resume(self) -> bool:
        """The echo runner resumes natively at a position; a decoder resumes
        by re-prefilling the prompt plus the journalled ids."""
        return isinstance(self.runner, _EchoRunner)

    def _journal_key(self, ids: Any, max_new_tokens: int, sampler: Any, stop_tokens: Any,
                     adapter: Optional[str]) -> str:
        """The request's durable identity (``request_key`` over the composed
        stop set: a resume and its original must agree)."""
        model = f"{self.model_name}+{adapter}" if adapter else self.model_name
        return request_key(model, ids, max_new_tokens, sampler, stop_tokens)

    def _journal_start(self, ids: Any, max_new_tokens: int, sampler: Any, stop_tokens: Any,
                       adapter: Optional[str], journal_key: Optional[str],
                       journal_prior: Optional[list]) -> Any:
        """This generation's journal entry (None with the journal off).
        Deterministic = greedy or seeded: replaying it reproduces the
        stream, which a resume relies on."""
        if self.journal is None:
            return None
        greedy = sampler is None or sampler.greedy
        seeded = sampler is not None and sampler.seeded
        key = journal_key or self._journal_key(ids, max_new_tokens, sampler, stop_tokens,
                                               adapter)
        return self.journal.start(key, self.model_name, max_new_tokens, seeded=seeded,
                                  deterministic=greedy or seeded, prior=journal_prior)

    def _note_generation(self) -> None:
        """The gauges a finished generation moves: the solo-speculation
        acceptance and the prefix cache's hit ratios and entries (host
        counters of the runner)."""
        stats = getattr(self.runner, "spec_stats", None)
        if stats and stats["drafted"]:
            with self.runner._spec_lock:
                ratio = stats["accepted"] / stats["drafted"]
            self._spec_gauge.set(ratio, model=self.model_name)
        pstats = getattr(self.runner, "prefix_stats", None)
        if pstats:
            partial = pstats.get("partial_hits", 0)
            lookups = pstats["hits"] + partial + pstats["misses"]
            if lookups:
                self._prefix_gauge.set(pstats["hits"] / lookups, model=self.model_name)
                self._prefix_partial_gauge.set(partial / lookups, model=self.model_name)
            entries = self.runner.prefix_entries()
            if entries is not None:
                self._prefix_entries_gauge.set(entries, model=self.model_name)

    def generate_stream(
        self,
        tokens: Any,
        max_new_tokens: int = 32,
        sampler: Optional[Sampler] = None,
        stop_tokens: Optional[Any] = None,
        cancel: Optional[Any] = None,
        logprobs: bool = False,
        adapter: Optional[str] = None,
        resume_from: int = 0,
    ) -> Any:
        """Iterator of token ids as they decode (the SSE bridge), or of
        (id, logprob) pairs with ``logprobs``. Closing it, or setting
        ``cancel`` (anything with ``set``/``is_set``: the SSE abort hook
        sets it), stops the background decode within a chunk.

        ``resume_from=k`` resumes an interrupted deterministic stream at
        position k (the client holds ids 0..k-1): the ids the journal kept
        replay at once and the rest continue (``_resume_producer``); without
        a journal entry the request regenerates and the first k ids are
        suppressed. Greedy and seeded requests only (an unseeded sampled
        stream cannot be reproduced), and not with logprobs (the journal
        keeps ids alone): both are a 400."""
        # eager, before the transport commits its 200: an out-of-vocab
        # logit_bias id or an unknown adapter is a 400, not an error frame
        # after the status; the adapter model read here is pinned for the
        # stream (ONE dict read: a concurrent unload must not fail it); an
        # encoder's NotImplementedError comes in the stream, as in JAX
        adapter_params = None
        if adapter is not None or (sampler is not None and sampler.logit_bias):
            self.wait_ready()
        self._check_bias(sampler)
        if adapter is not None:
            adapter_params = getattr(self.runner, "adapters", {}).get(adapter)
            if adapter_params is None:
                raise InvalidParamError(
                    f"adapter '{adapter}' (loaded: "
                    f"{sorted(getattr(self.runner, 'adapters', {}))})"
                )
        if resume_from:
            if resume_from < 0:
                raise InvalidParamError("resume offset must be >= 0")
            if logprobs:
                raise InvalidParamError(
                    "resume is not supported with logprobs (the journal records token ids only)"
                )
            if sampler is not None and not sampler.greedy and not sampler.seeded:
                raise InvalidParamError(
                    "resume requires a deterministic request (greedy or seeded) — an unseeded "
                    "sampled stream cannot be reproduced"
                )
            self.wait_ready()
            tokens = self._encode(tokens)
            produce = self._resume_producer(tokens, max_new_tokens, sampler, stop_tokens,
                                            adapter, adapter_params, resume_from)
        else:
            def produce(put: Any, stop_evt: Any) -> None:
                self.generate(
                    tokens, max_new_tokens, on_token=put, stop=stop_evt,
                    sampler=sampler, stop_tokens=stop_tokens, logprobs=logprobs,
                    adapter=adapter, adapter_params=adapter_params,
                )
        out: "queue.Queue" = queue.Queue()
        done = object()
        failure: list[BaseException] = []
        stop = cancel if cancel is not None else threading.Event()
        # the producer thread decodes in the caller's context: its flight
        # record (and span) reach the batcher and the pool from there
        context = contextvars.copy_context()

        def run() -> None:
            try:
                produce(out.put, stop)
            except BaseException as exc:  # re-raised on the consumer side
                failure.append(exc)
            finally:
                out.put(done)

        def iterate() -> Any:
            threading.Thread(target=context.run, args=(run,), daemon=True,
                             name="gofr-stream-producer").start()
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

    def _resume_producer(self, ids: list, max_new_tokens: int, sampler: Optional[Sampler],
                         stop_tokens: Any, adapter: Optional[str], adapter_params: Any,
                         resume_from: int) -> Any:
        """The producer ``fn(put, stop)`` of a resumed stream, emitting the
        positions from ``resume_from`` on, in one of three modes
        (``gofr_tpu_journal_resumes_total{mode}``):

        - ``teacher_forced``: a journal entry holds at least
          ``resume_from`` ids. They replay, then a decoder continues with a
          generation over prompt + those ids (one prefill re-reads them:
          the paged prefix cache shares the prompt's blocks) for the
          remaining budget, under the original key;
        - native, the echo runner: it continues at the journalled length;
        - ``replayed``: no usable entry (another process's stream, an
          evicted entry, or a seeded sampled request, whose per-chunk draws
          cannot restart mid-stream). The whole request regenerates and its
          first ``resume_from`` ids are suppressed."""
        composed = frozenset(stop_tokens or ()) | self.default_stop_ids
        key = self._journal_key(ids, max_new_tokens, sampler, composed, adapter)
        native = self.supports_resume
        greedy = sampler is None or sampler.greedy
        entry = None
        if self.journal is not None and (native or greedy):
            entry = self.journal.claim(key, resume_from)
        if self.journal is not None:
            self.journal.note_resume("teacher_forced" if entry is not None else "replayed")
        if entry is not None:
            emitted = list(entry.tokens)

            def produce(put: Any, stop: Any) -> None:
                for token in emitted[resume_from:]:
                    if stop is not None and stop.is_set():
                        return
                    put(token)
                remaining = max_new_tokens - len(emitted)
                if remaining <= 0:
                    return
                if native:
                    self.generate(ids, max_new_tokens, on_token=put, stop=stop, sampler=sampler,
                                  stop_tokens=stop_tokens, adapter=adapter,
                                  adapter_params=adapter_params, journal_key=key,
                                  journal_prior=emitted, resume_from=len(emitted))
                else:
                    self.generate(list(ids) + emitted, remaining, on_token=put, stop=stop,
                                  sampler=sampler, stop_tokens=stop_tokens, adapter=adapter,
                                  adapter_params=adapter_params, journal_key=key,
                                  journal_prior=emitted)

            return produce

        def produce(put: Any, stop: Any) -> None:
            skip = resume_from

            def emit(item: Any) -> None:
                nonlocal skip
                if skip > 0:
                    skip -= 1
                    return
                put(item)

            self.generate(ids, max_new_tokens, on_token=emit, stop=stop, sampler=sampler,
                          stop_tokens=stop_tokens, adapter=adapter,
                          adapter_params=adapter_params, journal_key=key)

        return produce

    def _check_bias(self, sampler: Optional[Sampler]) -> None:
        """An out-of-vocab ``logit_bias`` id -> InvalidParamError (400)."""
        if self.is_decoder and sampler is not None and sampler.logit_bias:
            try:
                check_bias_ids(sampler.logit_bias, self.runner.cfg.vocab_size)
            except ValueError as exc:
                raise InvalidParamError(str(exc)) from None

    def score(self, tokens: Any, adapter: Optional[str] = None) -> list[float]:
        """Teacher-forced prompt scoring: log p(t_i | t_<i) for i >= 1
        (see the runner's ``score``), under ``adapter`` when named."""
        self.wait_ready()
        if not self.is_decoder:
            raise InvalidParamError("scoring needs an autoregressive transformer model")
        try:
            out = self.runner.score(self._encode(tokens), adapter=adapter)
        except Exception:
            self._requests.inc(model=self.model_name, op="score", status="error")
            raise
        self._requests.inc(model=self.model_name, op="score", status="ok")
        return out

    # -- runtime multi-LoRA (the admin surface) -----------------------------------
    def _refresh_pool_lora(self) -> None:
        """(Re)build the decode pool's stacked adapter bank from the
        runner's adapters, so adapter traffic shares the pool. A set whose
        adapters disagree on targets or rank disables the bank (logged):
        its requests decode solo, which is always correct."""
        pool = self.decode_pool
        if pool is None:
            return
        adapters = self.runner.adapters
        if not adapters:
            pool.disable_lora()
            return
        try:
            stack = build_lora_stack(self.runner.model, adapters)
        except ValueError as exc:
            self.logger.warnf("pooled multi-LoRA disabled: %s — adapter requests decode solo",
                              exc)
            pool.disable_lora()
            return
        pool.enable_lora(stack, {name: i + 1 for i, name in enumerate(adapters)})

    def list_adapters(self) -> list[str]:
        self.wait_ready()
        return sorted(getattr(self.runner, "adapters", None) or {})

    def load_adapter(self, name: str, path: str) -> list[str]:
        """Load an adapter artifact (the ``LORA_ADAPTERS`` format) over the
        serving base at runtime; in-flight requests keep the model they
        resolved, new ones see the new adapter at once. Returns the loaded
        names."""
        self.wait_ready()
        if not isinstance(name, str) or not name:
            raise InvalidParamError('"name" must be a non-empty string')
        if name == self.model_name:
            # the OpenAI surface routes by model name: a collision would make
            # the adapter unselectable and the listing ambiguous
            raise InvalidParamError(f"adapter name '{name}' collides with the base model name")
        if not isinstance(path, str) or not path:
            raise InvalidParamError('"path" must be a non-empty string')
        if not self.is_decoder:
            raise InvalidParamError("adapters need a transformer model (MODEL_NAME)")
        try:
            wrapped = apply_adapter(self.runner.model, restore_params(path, self.device))
        except Exception as exc:
            # a bad path or artifact is the caller's error, not a server fault
            raise InvalidParamError(f"cannot load adapter from {path!r}: {exc}") from exc
        with self._adapter_lock:
            self._lora_adapters[name] = path
            self.runner.adapters[name] = wrapped
            # the bank swap waits for live adapter slots (decode_pool.py)
            self._refresh_pool_lora()
            loaded = sorted(self.runner.adapters)
        self.logger.infof("adapter '%s' loaded from %s", name, path)
        return loaded

    def unload_adapter(self, name: str) -> list[str]:
        """Drop an adapter. Requests that already resolved it finish on the
        model they hold; new ones get a 400."""
        self.wait_ready()
        with self._adapter_lock:
            adapters = getattr(self.runner, "adapters", None) or {}
            if adapters.pop(name, None) is None:
                raise InvalidParamError(f"adapter '{name}' (loaded: {sorted(adapters)})")
            self._lora_adapters.pop(name, None)
            self._refresh_pool_lora()  # shrink (or disable) the bank
            remaining = sorted(adapters)
        self.logger.infof("adapter '%s' unloaded", name)
        return remaining

    def engine_snapshot(self) -> dict[str, Any]:
        """``GET /admin/engine``: the state machine and its history, the
        boot timeline, the watchdog (and what a stall on this device leads
        to), the recovery incident, the journal, the brownout, dispatch
        counts, queue depth, pool occupancy, paged KV, scheduler, cache and
        compile counts and device memory. Host reads only (the allocator's
        counters, no device sync), so it answers while the engine is
        wedged."""
        watchdog = self.watchdog.snapshot()
        # what a stall leads to here: degraded, then wedged; with recovery
        # on, a rebuild in process over the same weights. On a card a CUDA
        # device fault (error 719 and the like) ends the process's context:
        # every rebuild fails, then failed (a restart)
        fault = ("; a CUDA device fault ends the process's context: bounded attempts fail, "
                 "then failed (restart)" if self.platform == "gpu" else "")
        watchdog["on_stall"] = (
            "recover: degraded, then wedged, then a rebuild in process (recovering, "
            "warming, serving)" + fault
            if self.recovery.enabled else
            "observe-only: degraded, then wedged, back to serving when the wait returns"
            + fault
        )
        snap: dict[str, Any] = {
            "engine": self.engine.snapshot(),
            "boot_id": BOOT_ID,
            "model": self.model_name,
            "platform": self.platform,
            "device_kind": str(self.device_kind),
            "versions": runtime_versions(),
            "boot": dict(self.boot_status),
            "boot_timeline": [dict(stage) for stage in self.boot_timeline],
            "watchdog": watchdog,
            # the wedge-recovery incident (attempts, backoff, last outcome,
            # MTTR), the journal's accounting and the live brownout level
            "recovery": self.recovery.snapshot(),
            "journal": self.journal.stats() if self.journal is not None else None,
            "brownout": self.brownout.snapshot(),
            "dispatches": self.timeline.stats(),
            "costmodel": self.costmodel.overview() if self.costmodel is not None else None,
            "queue_depth": self.batcher._depth() if self.batcher is not None else None,
            "decode_pool": (self.decode_pool.occupancy()
                            if self.decode_pool is not None else None),
            "kv_blocks": self.kv_pool.stats() if self.kv_pool is not None else None,
            "scheduler": self.scheduler.snapshot() if self.scheduler is not None else None,
        }
        caches: dict[str, Any] = {}
        pstats = getattr(self.runner, "prefix_stats", None)
        if pstats:
            caches["prefix"] = dict(pstats)
        snap["caches"] = caches
        snap["compiles"] = {
            kind: self._compiles.value(kind=kind)
            for kind in sorted({s["kind"] for s in snap["boot_timeline"] if s["kind"]})
        }
        hbm = None
        if self.device is not None and self.device.type == "cuda":
            hbm = {
                "bytes_in_use": torch.cuda.memory_allocated(self.device),
                "bytes_limit": torch.cuda.get_device_properties(self.device).total_memory,
            }
        snap["hbm"] = hbm
        return snap

    def close(self) -> None:
        """Stop the recovery supervisor, the watchdog, the pool (its worker
        joined; a stream still decoding gets an error, never a truncated
        result, and its journal entry stays interrupted), the batcher, the
        runner and the journal's WAL. A background boot still running tears
        its stack down when it ends."""
        self._closed = True
        self.recovery.close()
        self.watchdog.close()
        if self._ready.is_set():
            self._teardown_stack()
            self.engine.transition("closed")
        if self.journal_wal is not None:
            self.journal_wal.close()


class _PrefillState(dict):
    """Per-request prefill result. ``cache`` (this row's private copy of
    the batch cache) and ``logits`` materialize on first read; ``row()``
    gives views of the row without a copy (the pool slot and the prefix
    store copy what they need from it)."""

    def __init__(self, full_cache: dict, full_logits: torch.Tensor, index: int, **kw: Any):
        super().__init__(**kw)
        self._full_cache = full_cache
        self._full_logits = full_logits
        self._index = index

    def row(self) -> dict:
        if dict.__contains__(self, "cache"):
            return dict.__getitem__(self, "cache")
        i, full = self._index, self._full_cache
        return {name: full[name][:, i : i + 1] for name in ("k", "v")}

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


def _row_of(state: Any) -> dict:
    """The KV row of a prefill state, without a copy where there is one to
    skip (a batched prefill's row of the batch cache)."""
    return state.row() if isinstance(state, _PrefillState) else state["cache"]


def _copy_row(row: dict) -> dict:
    return {name: t.clone() for name, t in row.items()}


def _cache_with_len(cache: dict, n: int) -> dict:
    """The cache with its write head set to ``n`` (the KV past ``n`` is
    masked by attention and overwritten by later steps)."""
    lengths = torch.full_like(cache["lengths"], int(n))
    return {"k": cache["k"], "v": cache["v"], "lengths": lengths}


def _prompt_chunks(ids: np.ndarray, bucket: int):
    """Slice a prompt into [1, bucket] zero-padded token rows with their
    true lengths: the one chunking of chunked prefill and tail prefill."""
    for start in range(0, max(int(ids.size), 1), bucket):
        chunk = ids[start : start + bucket]
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, : chunk.size] = chunk
        yield tokens, np.asarray([max(int(chunk.size), 1)], np.int32), int(chunk.size)


class _SpecEngine:
    """The draft side of the solo speculative latency mode
    (``DRAFT_MODEL_NAME``): the draft model, a bucketed prefill (the
    draft's cache holds the same prompt as the target's), a k-step greedy
    chunk (one dispatch proposes k tokens), the sampled chunk with its
    warped distributions, and a cache-length reset (rolls back what a
    rejected draft wrote). Output never depends on the draft: the target's
    verify re-derives every emitted token; the draft only sets the
    acceptance rate. Its cache is a [1]-row cache in the draft's dtype."""

    def __init__(self, target_cfg: Any, quant: Any, draft_name: str, k: int,
                 device: torch.device, draft_path: Optional[str] = None,
                 model: Optional[Transformer] = None):
        if draft_name not in CONFIGS:
            raise ValueError(
                f"DRAFT_MODEL_NAME '{draft_name}' unknown — expected one of {sorted(CONFIGS)}"
            )
        cfg = CONFIGS[draft_name]
        if cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft '{draft_name}' vocab {cfg.vocab_size} != target vocab "
                f"{target_cfg.vocab_size} — speculative decoding verifies draft token ids "
                "against the target distribution"
            )
        if cfg.max_seq < target_cfg.max_seq:
            raise ValueError(
                f"draft '{draft_name}' max_seq {cfg.max_seq} < target serving max_seq "
                f"{target_cfg.max_seq}"
            )
        if k + 2 > target_cfg.max_seq:
            raise ValueError(
                f"DRAFT_TOKENS {k} cannot fit a verify (k+1 tokens) in the serving cache "
                f"(max_seq {target_cfg.max_seq}) — spec decoding would silently never engage"
            )
        self.cfg = dataclasses.replace(cfg, max_seq=target_cfg.max_seq)
        self.k = k
        self.device = device
        if model is None:
            # the seeded draft: seed 1 where the target's default is 0, so a
            # same-config draft still exercises real accepts and rejects
            model = load_model(self.cfg, device, draft_path, quant, seed=1)
        elif draft_path:
            raise ValueError("a given draft model and DRAFT_MODEL_PATH exclude each other")
        elif model.cfg != self.cfg or model.device.type != device.type or model.quant != quant:
            raise ValueError("the given draft model does not match DRAFT_MODEL_NAME/"
                             "MODEL_MAX_SEQ/MODEL_QUANT/device")
        self.model = model

    def prefill_prompt(self, ids: np.ndarray, bucket: int, chunked: bool) -> dict:
        """The prompt through the draft -> a fresh [1]-row draft cache
        holding exactly the prompt. ``chunked`` mirrors the target's path
        for over-long prompts (slices through the bucket); otherwise the
        LAST ``bucket`` tokens, as the target's ``pack_token_rows`` keeps
        them: the two caches hold the same prefix either way."""
        if not chunked:
            ids = ids[-bucket:]
        cache = self.model.init_cache(1, self.cfg.max_seq)
        for tokens, lengths, _ in _prompt_chunks(ids, bucket):
            _, cache = self.model.prefill(to_device(tokens, self.device), cache,
                                          to_device(lengths, self.device))
        return cache

    def propose(self, token_dev: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        """k greedy draft tokens [1, k] from the pending token; writes the
        pending token and k-1 drafts into the draft cache."""
        toks, _, _, _, _, cache = self.model.decode_chunk_pool(
            token_dev, cache, self.k, None, 0.0, all_greedy=True
        )
        return toks, cache

    def propose_sampled(self, token_dev: torch.Tensor, cache: dict,
                        generator: torch.Generator, temp: float, tk: int, tp: float,
                        mp: float) -> tuple:
        """k sampled draft tokens [1, k], their warped distributions
        [1, k, V], and the cache."""
        return self.model.draft_chunk_sampled(token_dev, cache, self.k, generator, temp, tk, tp,
                                              mp)

    def reset_len(self, cache: dict, n: int) -> dict:
        return _cache_with_len(cache, n)


def _load_or_init(model_path: Optional[str], device: torch.device, empty: Any,
                  init: Any) -> Any:
    """The weights of an MLP or encoder runner: a ``training/checkpoint.py``
    directory under ``MODEL_PATH`` (its state dict loaded into ``empty()``),
    else ``init()``, a seeded random init."""
    if not model_path:
        return init()
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"MODEL_PATH {model_path!r} does not exist")
    model = empty()
    model.load_state_dict(restore_params(model_path, device))
    return model


def _given(model: Any, kind: type, cfg: Any, device: torch.device, model_path: Optional[str],
           quant: Any = None) -> Any:
    """A model the caller built (tests carry JAX's weights over), checked
    against the runner's configuration."""
    if model_path:
        raise ValueError("a given model and MODEL_PATH exclude each other")
    if (not isinstance(model, kind) or model.cfg != cfg or model.device.type != device.type
            or getattr(model, "quant", None) != quant):
        raise ValueError("the given model does not match MODEL_NAME/MODEL_QUANT/device")
    return model


class _EchoRunner:
    """The loopback runner (``MODEL_NAME=echo``, the JAX package's
    ``_EchoRunner``): it "generates" by cycling the prompt's ids, so the
    whole serving stack (routing, middleware, the batcher, the scheduler,
    SSE streaming, metrics) runs end to end in milliseconds with no model.
    It allocates nothing on any device and touches no CUDA API: it boots
    with or without a card. It is not a fallback: it computes nothing a
    model would. ``ECHO_STEP_MS`` sleeps once a prefill and once a decode
    step (once a verify under pooled speculation), a decode cadence.

    With ``KV_PAGED`` (the device attaches a ``HostPagedKV``) a request's
    prompt is admitted into block tables, decoded off them (the prompt read
    back through the arena) and stored at finish, so exact and LCP hits,
    COW and LRU eviction run as on the device; an exhausted arena decodes
    the request block-free (``gofr_tpu_pool_reject_total{reason=
    "kv_exhausted"}``). With ``SPEC_POOLED`` (``enable_pooled_spec``) it
    decodes in verify cycles: k drafts (n-gram or the ``SPEC_FAKE_ACCEPT``
    script) written speculatively into the paged KV, one sleep a cycle, the
    longest matching prefix plus the bonus token emitted, the rest rolled
    back; the ids are the plain loop's whatever was drafted.

    ``stall_hook`` (tests) is called at the top of every ``run_batch``, so
    a test can wedge a "device" prefill on the card-free path and drive the
    watchdog, the engine's state machine and a recovery end to end.

    Deadlines, as the pool has them: after the prefill a request whose
    budget cannot cover one decode step is refused (stage ``admission``,
    reject reason ``deadline``), and each step checks it (stage
    ``decode``). ``resume_from`` starts the emission at that position (the
    decode is position-indexed): the journal's native resume. Left for a
    later slice: the host-mesh arena (§A7)."""

    # synthetic bucket ladder: echo pads nothing, but the batcher forms
    # bucket cohorts and counts padded tokens on it
    buckets = (64, 128, 256, 512, 1024, 2048, 4096, 8192)

    def __init__(self, step_ms: float = 0.0, metrics: Any = None):
        self.step_s = step_ms / 1000.0
        self._deadline_counter = self._cancel_counter = self._pool_reject = None
        if metrics is not None:
            self._deadline_counter = deadline_exceeded_counter(metrics)
            self._cancel_counter = cancellations_counter(metrics)
            self._pool_reject = pool_reject_counter(metrics)
        self.paged: Optional[HostPagedKV] = None
        self.kv_pool: Optional[BlockPool] = None
        self._kv_reject: Any = None
        # a closed runner breaks its in-flight generate loops
        self._closed = False
        self.spec_pooled: Optional[PoolSpecConfig] = None
        # the transformer runner's shape: the device's gauges read both
        self.spec_stats = {"cycles": 0, "drafted": 0, "accepted": 0}
        self._spec_lock = threading.Lock()
        self.prefix_stats: Optional[dict] = None
        self.stall_hook: Optional[Any] = None

    def enable_pooled_spec(self, cfg: PoolSpecConfig) -> None:
        """Arm pooled speculative decoding: generate() decodes in verify
        cycles."""
        self.spec_pooled = cfg

    def enable_paged_kv(self, engine: HostPagedKV, reject_counter: Any = None) -> None:
        """Attach the host paged-KV engine: the runner then decodes off
        block tables, and the device's prefix gauges read its stats."""
        self.paged = engine
        self.kv_pool = engine.pool
        self._kv_reject = reject_counter
        self.prefix_stats = engine.prefix_stats

    def prefix_entries(self) -> Optional[int]:
        return len(self.kv_pool) if self.kv_pool is not None else None

    def close(self) -> None:
        self._closed = True

    def warmup(self, progress: Any) -> None:
        progress("echo runner ready (nothing to compile)")

    def bucket_for_payload(self, ids: np.ndarray) -> int:
        n = int(getattr(ids, "size", 0) or 0)
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def prepare(self, payload: Any) -> np.ndarray:
        if isinstance(payload, dict):
            payload = payload.get("tokens", [])
        ids = np.asarray(payload, dtype=np.int32).reshape(-1)
        if ids.size == 0:
            raise InvalidParamError("tokens must be a non-empty list of ids")
        return ids

    def run_batch(self, payloads: list[np.ndarray]) -> list[dict]:
        if self.stall_hook is not None:
            self.stall_hook()
        if self._closed:
            raise RuntimeError("echo runner closed (engine recovering)")
        if self.step_s:
            time.sleep(self.step_s)
        return [{"next_token": int(ids[0]), "length": int(ids.size)} for ids in payloads]

    def generate(
        self,
        tokens: Any,
        max_new_tokens: int,
        on_token: Any = None,
        stop: Any = None,
        sampler: Any = None,
        stop_tokens: Any = None,
        decode_pool: Any = None,
        prefill_batcher: Any = None,
        scheduler: Any = None,
        logprobs: bool = False,
        top_logprobs: bool = False,
        adapter: Optional[str] = None,
        adapter_params: Any = None,
        ttft_cb: Any = None,
        resume_from: int = 0,
    ) -> Any:
        if adapter is not None:
            raise InvalidParamError(f"adapter '{adapter}' (the echo runner serves no adapters)")
        ids = self.prepare(tokens)
        stop_tokens = frozenset(stop_tokens or ())
        # the prefill rides the real batcher: queue wait, cohorts and the
        # scheduler behave as on a device
        if prefill_batcher is not None:
            prefill_batcher.infer(ids)
        else:
            self.run_batch([ids])
        if ttft_cb:
            ttft_cb()
        record = current_record()
        deadline = current_deadline()
        if deadline is not None:
            # the pool's admission gate: a budget that cannot cover one
            # decode step is refused before it reserves a block
            remaining = deadline.remaining()
            if remaining <= 0 or remaining < self.step_s:
                if self._pool_reject is not None:
                    self._pool_reject.inc(reason="deadline")
                if self._deadline_counter is not None:
                    self._deadline_counter.inc(stage="admission")
                if record is not None:
                    record.note_pool_reject("deadline")
                    record.note_shed("admission")
                raise DeadlineExceeded(
                    f"remaining deadline budget {max(remaining, 0) * 1000:.0f} ms cannot cover "
                    f"one decode step (cadence {self.step_s * 1000:.0f} ms)", stage="admission",
                )
        # paged admission (the pool's submit timing): reserve the block
        # budget, aliasing cached prefix blocks; exhaustion decodes
        # block-free, counted as the pool counts it
        seq = None
        src = ids
        if self.paged is not None:
            try:
                seq = self.paged.admit(ids, max_new_tokens)
            except KVExhausted:
                if self._kv_reject is not None:
                    self._kv_reject.inc(reason="kv_exhausted")
                if record is not None:
                    record.note_pool_reject("kv_exhausted")
            if seq is not None:
                # decode off the block tables, not the request's buffer
                src = self.paged.prompt_tokens(seq)
                if record is not None:
                    record.note_kv(len(seq.table.blocks), seq.aliased_blocks)
        out: list[int] = []
        lps: list[float] = []
        tops: list = []
        decode = self._generate_spec if self.spec_pooled is not None else self._generate_plain
        try:
            decode(src, seq, out, lps, tops, max_new_tokens, resume_from, stop, stop_tokens,
                   on_token, logprobs, deadline, record)
        except BaseException:
            if seq is not None:
                self.paged.abort(seq)
            raise
        if seq is not None:
            if stop is not None and stop.is_set():
                # cancelled: release everything; a partial generation
                # never becomes a cache entry
                self.paged.abort(seq)
            else:
                # trim the unused reservation and store the conversation
                # copy-free (the request's table becomes the entry)
                self.paged.finish(seq)
        if top_logprobs:
            return out, lps, tops
        return (out, lps) if logprobs else out

    def _emit(self, token: int, out: list, lps: list, tops: list, on_token: Any,
              logprobs: bool) -> None:
        out.append(token)
        if logprobs:
            lps.append(0.0)
            tops.append([(token, 0.0)])
        if on_token:
            on_token((token, 0.0) if logprobs else token)

    def _shed_decode(self, record: Any, emitted: int) -> None:
        """A step past the deadline: the pool's per-chunk accounting, then
        the 504 (the caller's abort path releases the blocks)."""
        if self._deadline_counter is not None:
            self._deadline_counter.inc(stage="decode")
        if self._cancel_counter is not None:
            self._cancel_counter.inc(cause="deadline")
        if record is not None:
            record.note_shed("decode")
        raise DeadlineExceeded(
            f"request deadline exceeded mid-decode (after {emitted} tokens)", stage="decode"
        )

    def _generate_plain(self, src: np.ndarray, seq: Any, out: list, lps: list, tops: list,
                        max_new_tokens: int, resume_from: int, stop: Any,
                        stop_tokens: frozenset, on_token: Any, logprobs: bool, deadline: Any,
                        record: Any) -> None:
        """One token a step (one ``ECHO_STEP_MS`` sleep): token i is the
        prompt's id at position i mod its length, from ``resume_from``."""
        for i in range(resume_from, max_new_tokens):
            if stop is not None and stop.is_set():
                break
            if self._closed:
                raise RuntimeError("echo runner closed mid-generation (engine recovering)")
            if deadline is not None and deadline.expired():
                self._shed_decode(record, len(out))
            token = int(src[i % src.size])
            if token in stop_tokens:
                break
            if seq is not None:
                self.paged.append(seq, token)  # COW first on a shared boundary
            self._emit(token, out, lps, tops, on_token, logprobs)
            if self.step_s:
                time.sleep(self.step_s)

    def _generate_spec(self, src: np.ndarray, seq: Any, out: list, lps: list, tops: list,
                       max_new_tokens: int, resume_from: int, stop: Any,
                       stop_tokens: frozenset, on_token: Any, logprobs: bool, deadline: Any,
                       record: Any) -> None:
        """Pooled-spec cycles (the decode pool's spec mode, with no model):
        per cycle the draft source proposes k tokens, they land
        speculatively in the paged KV, ONE sleep stands for the verify, the
        longest prefix matching the true continuation plus the bonus token
        is emitted and the rejected tail rolls back. Emission is
        position-indexed off ``src`` as in the plain loop, so the ids never
        depend on the drafts; only tokens a dispatch do. k is clamped by the
        brownout level and the deadline's remaining steps."""
        cfg = self.spec_pooled
        # a resumed request drafts from the stream an uninterrupted run
        # would have: the prompt and the ids already emitted
        ctx = [int(t) for t in src] + [int(src[j % src.size]) for j in range(resume_from)]
        state = cfg.new_state(ctx[:-1], ctx[-1])
        i = resume_from
        while i < max_new_tokens:
            if stop is not None and stop.is_set():
                break
            if self._closed:
                raise RuntimeError("echo runner closed mid-generation (engine recovering)")
            if deadline is not None and deadline.expired():
                self._shed_decode(record, len(out))
            k = clamp_spec_k(state.adaptive.current(), cfg.level(), deadline, self.step_s)
            # room for k drafts + the bonus within the request's budget
            k = min(k, max_new_tokens - i - 1)
            truth = [int(src[(i + j) % src.size]) for j in range(k + 1)]
            drafts = state.propose(k, truth=truth[:k]) if k > 0 else []
            k_eff = len(drafts)
            base_len = seq.table.length if seq is not None else 0
            if seq is not None:
                for t in drafts:
                    self.paged.append(seq, t)  # speculative writes before the verify
            if self.step_s:
                time.sleep(self.step_s)  # ONE verify for the whole burst
            n_acc = 0
            while n_acc < k_eff and drafts[n_acc] == truth[n_acc]:
                n_acc += 1
            # accepted drafts + the bonus, cut at a stop token (not emitted)
            burst = truth[: n_acc + 1]
            stopped = False
            for j, t in enumerate(burst):
                if t in stop_tokens:
                    burst = burst[:j]
                    stopped = True
                    break
            if seq is not None:
                # keep the accepted prefix of the speculative writes, then
                # land the bonus token
                self.paged.rollback(seq, base_len + min(len(burst), n_acc))
                if len(burst) > n_acc:
                    self.paged.append(seq, burst[-1])
            cancelled = False
            for t in burst:
                self._emit(t, out, lps, tops, on_token, logprobs)
                if stop is not None and stop.is_set():
                    cancelled = True
                    break
            state.commit(burst, k_eff, n_acc)
            cfg.note_cycle(k_eff, n_acc, len(burst))
            with self._spec_lock:
                self.spec_stats["cycles"] += 1
                self.spec_stats["drafted"] += k_eff
                self.spec_stats["accepted"] += n_acc
            if record is not None:
                record.note_spec(k_eff, n_acc, len(burst))
            i += len(burst)
            if stopped or cancelled:
                break


class _MLPRunner:
    """The MLP behind ``/infer`` (the JAX package's ``_MLPRunner``): one
    feature vector a request, the batch padded to a power of two by
    repeating its last row. ``MODEL_QUANT`` does not apply (the JAX
    runner's products are plain too)."""

    name = "mlp"

    def __init__(self, device: torch.device, max_batch: int = 8, seed: int = 0,
                 model: Optional[MLP] = None, model_path: Optional[str] = None):
        self.cfg = MLPConfig()
        self.device = device
        self.max_batch = max_batch
        if model is not None:
            self.model = _given(model, MLP, self.cfg, device, model_path)
            return

        def init() -> MLP:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            return init_mlp(self.cfg, gen, device)

        self.model = _load_or_init(model_path, device, lambda: MLP(self.cfg, device), init)

    def describe(self) -> str:
        return f"dims={self.cfg.in_dim}->{self.cfg.hidden_dim}->{self.cfg.out_dim}"

    def prepare(self, payload: Any) -> np.ndarray:
        x = np.asarray(payload, dtype=np.float32).reshape(-1)
        if x.shape[0] != self.cfg.in_dim:
            raise InvalidParamError(f"input must have {self.cfg.in_dim} features")
        return x

    @torch.no_grad()
    def run_batch(self, payloads: list[np.ndarray]) -> list[np.ndarray]:
        n = len(payloads)
        batch = torch.from_numpy(pad_rows(payloads, next_pow2(n))).to(self.device)
        out = mlp_forward(self.model, batch).cpu().numpy()
        return [out[i] for i in range(n)]

    def warmup(self, progress: Any) -> None:
        progress("warming the MLP at every padded batch", kind="forward")
        b = 1
        while b <= next_pow2(self.max_batch):
            self.run_batch([np.zeros(self.cfg.in_dim, np.float32)] * b)
            b *= 2


class _BertRunner:
    """Sentence embeddings (the JAX package's ``_BertRunner``): ``bert-tiny``
    or, for any other ``bert*`` name, bert-base. Every request pads to one
    bucket (128 tokens, or ``max_seq`` when shorter; longer inputs keep
    their first tokens), the batch to a power of two; a padded row gets one
    valid token so the pool never divides by zero. The mask is a prefix, so
    each layer's attention is the flash forward, non-causal, at the rows'
    lengths."""

    def __init__(self, name: str, device: torch.device, max_batch: int = 8, seed: int = 0,
                 model: Optional[Bert] = None, model_path: Optional[str] = None,
                 quant: Any = None):
        self.name = name
        self.device = device
        self.max_batch = max_batch
        self.cfg = BERT_TINY if name == "bert-tiny" else BERT_BASE
        self.bucket = 128 if self.cfg.max_seq >= 128 else self.cfg.max_seq
        self.n_params = bert_param_count(self.cfg)
        self.quant = quant
        if model is not None:
            self.model = _given(model, Bert, self.cfg, device, model_path, quant)
            return
        # a seeded init is quantized as each weight is drawn (it never holds
        # both forms); a checkpoint after it loads
        self.model = _load_or_init(model_path, device, lambda: Bert(self.cfg, device),
                                   lambda: Bert.random(self.cfg, device, seed, quant=quant))
        if model_path and quant:
            self.model = self.model.quantized(quant)

    def describe(self) -> str:
        return (f"bucket={self.bucket} layers={self.cfg.n_layers} dim={self.cfg.dim} "
                f"quant={self.quant or 'off'}")

    def prepare(self, payload: Any) -> np.ndarray:
        tokens = payload.get("tokens", []) if isinstance(payload, dict) else payload
        ids = np.asarray(tokens, dtype=np.int64).reshape(-1)[: self.bucket]
        if ids.size == 0:
            raise InvalidParamError("tokens must be a non-empty list of ids")
        if ids.min() < 0 or ids.max() >= self.cfg.vocab_size:
            # the JAX gather clamps an out-of-range id; an index past the
            # card's table is a device fault, so it is refused here
            raise InvalidParamError(
                f"token ids must be in [0, {self.cfg.vocab_size}) for model '{self.name}'"
            )
        return ids.astype(np.int32)

    @torch.no_grad()
    def run_batch(self, payloads: list[np.ndarray]) -> list[np.ndarray]:
        n = len(payloads)
        rows = next_pow2(n)
        tokens = np.zeros((rows, self.bucket), np.int32)
        mask = np.zeros((rows, self.bucket), np.int32)
        for i, ids in enumerate(payloads):
            tokens[i, : ids.size] = ids
            mask[i, : ids.size] = 1
        mask[n:, 0] = 1  # padded rows need >= 1 valid token for the pool
        out = bert_embed(self.model, to_device(tokens, self.device),
                         to_device(mask, self.device)).cpu().numpy()
        return [out[i] for i in range(n)]

    def warmup(self, progress: Any) -> None:
        if self.device.type == "cuda":
            from gofr_tpu_torch.ops import flash

            progress("building the CUDA kernels (nvcc at first use)", kind="kernel_build")
            flash.build()
        progress(f"warming the encoder at bucket {self.bucket}, every padded batch",
                 kind="embed", bucket=self.bucket)
        b = 1
        while b <= next_pow2(self.max_batch):
            self.run_batch([np.zeros(self.bucket, np.int32)] * b)
            b *= 2


class _TransformerRunner:
    """Decoder serving on one device: batched bucketed prefill, chunked
    prefill, the prefix cache, and solo chunked decode (the pool decodes
    the rest)."""

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
        model_path: Optional[str] = None,
        quant: Any = None,
        kv_dtype: Optional[torch.dtype] = None,
        prefix_cache: int = 0,
        prefix_lcp_min: int = 0,
        prefill_chunk_tokens: int = 0,
        kv_paged: bool = True,
        kv_block_tokens: int = 64,
        kv_blocks: int = 0,
        kv_reserve_seqs: int = 0,
        draft_name: str = "",
        draft_tokens: int = 4,
        draft_path: Optional[str] = None,
        draft_model: Optional[Transformer] = None,
        lora_adapters: Optional[dict] = None,
        metrics: Any = None,
        timeline: Any = None,
        watchdog: Any = None,
        cache_events: Any = None,
    ):
        cfg = CONFIGS[name]
        if max_seq is not None and max_seq < cfg.max_seq:
            cfg = dataclasses.replace(cfg, max_seq=max_seq)
        self.name = name
        self.cfg = cfg
        # the KV caches' storage dtype: this runner owns it and passes it to
        # every cache it makes (the model's, the pool's, the arena's)
        self.cache_dtype = kv_dtype or cfg.dtype
        self.device = device
        self.max_batch = max_batch
        self.decode_chunk_size = decode_chunk
        if model is None:
            model = load_model(cfg, device, model_path, quant, seed)
        elif model_path:
            raise ValueError("a given model and MODEL_PATH exclude each other")
        elif (model.cfg != cfg or model.device.type != device.type or model.quant != quant):
            raise ValueError(
                "the given model does not match MODEL_NAME/MODEL_MAX_SEQ/MODEL_QUANT/device"
            )
        self.model = model
        self.metrics = metrics  # the solo path's deadline counters
        # the dispatch timeline and watchdog the chunked and tail prefills
        # report to, and the prefix cache's hit/miss callback
        self.timeline = timeline
        self.watchdog = watchdog
        self._cache_events = cache_events or (lambda cache, event: None)
        # what the MFU/MBU gauges and the cost sheets count: the logical
        # parameters, the bytes a step streams, the KV bytes of a position
        self.n_params = transformer_param_count(cfg)
        self.weight_bytes = model.weight_bytes()
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        self.kv_bytes_per_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * itemsize
        # multi-LoRA: named adapter models over the SHARED base tensors
        # (n adapters cost n x adapter bytes, not n x model bytes)
        self.adapters: dict[str, Transformer] = {
            a_name: apply_adapter(model, restore_params(a_path, device))
            for a_name, a_path in (lora_adapters or {}).items()
        }
        if draft_model is not None and not draft_name:
            raise ValueError("a given draft model needs DRAFT_MODEL_NAME")
        # the solo speculative latency mode: the draft engine, and its
        # counters (request threads add to them under the lock)
        self.spec = (
            _SpecEngine(cfg, quant, draft_name, draft_tokens, device, draft_path, draft_model)
            if draft_name else None
        )
        self.spec_stats = {"cycles": 0, "drafted": 0, "accepted": 0}
        self._spec_lock = threading.Lock()
        source = buckets if buckets else self.SEQ_BUCKETS
        self.buckets = [b for b in source if b <= cfg.max_seq] or [cfg.max_seq]
        # PREFILL_CHUNK_TOKENS resolves to the largest bucket inside the
        # budget (the smallest bucket when none fits: one bucket's compute
        # is the floor)
        self.prefill_chunk_bucket: Optional[int] = None
        if prefill_chunk_tokens:
            fitting = [b for b in self.buckets if b <= prefill_chunk_tokens]
            self.prefill_chunk_bucket = fitting[-1] if fitting else self.buckets[0]
        self.prefills = 0  # prefill forward calls (batches, slices, tails)
        self._count_lock = threading.Lock()
        # the row prefix cache: prompt bytes -> (row, length, next_token,
        # logits); the paged store replaces it under KV_PAGED
        self._prefix_cache: Any = OrderedDict() if prefix_cache > 0 else None
        self._prefix_cache_size = prefix_cache
        # -1: exact hits only; 0: one smallest bucket's worth of tokens
        self._prefix_lcp_min = prefix_lcp_min if prefix_lcp_min != 0 else self.buckets[0]
        self._prefix_lock = threading.Lock()
        self.prefix_stats = {"hits": 0, "partial_hits": 0, "misses": 0}
        self._init_paged_kv(kv_paged, kv_block_tokens, kv_blocks, kv_reserve_seqs, prefix_cache,
                            metrics)

    def _init_paged_kv(self, kv_paged: bool, block_tokens: int, kv_blocks: int,
                       reserve_seqs: int, prefix_cache: int, metrics: Any) -> None:
        """One shared ``BlockPool`` backs the prefix cache (block-aliased
        entries, LRU-evicted under the budget) and the decode pool's
        admission ledger. With neither a prefix cache nor an explicit
        budget there is nothing to page."""
        self.kv_pool: Optional[BlockPool] = None
        self._paged_prefix: Optional[_PagedPrefixStore] = None
        self.kv_paged_disabled = ""
        if not kv_paged or not (prefix_cache > 0 or kv_blocks):
            return
        cfg = self.cfg
        if cfg.max_seq % block_tokens:
            self.kv_paged_disabled = (
                f"KV_BLOCK_TOKENS={block_tokens} does not divide max_seq={cfg.max_seq}"
            )
            return
        blocks_per_seq = cfg.max_seq // block_tokens
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        block_bytes = 2 * cfg.n_layers * block_tokens * cfg.n_kv_heads * cfg.head_dim * itemsize
        # the arena backs the prefix cache's blocks (+1 sequence for the
        # store's transient table); in-flight decode KV lives in the pool's
        # slot cache and claims the LEDGER only
        data_blocks = (max(prefix_cache, 0) + 1) * blocks_per_seq
        # auto: every decode slot plus the whole arena (non-binding)
        ledger = kv_blocks if kv_blocks else data_blocks + reserve_seqs * blocks_per_seq
        if ledger < blocks_per_seq:
            self.kv_paged_disabled = (
                f"KV budget of {ledger} blocks cannot hold one "
                f"{cfg.max_seq}-token sequence ({blocks_per_seq} blocks)"
            )
            return
        data_blocks = min(data_blocks, ledger)
        self.kv_pool = BlockPool(
            data_blocks + 1, block_tokens,  # +1 scratch
            block_bytes=block_bytes, hbm_budget_bytes=ledger * block_bytes,
            cache_entries=prefix_cache, scratch=True, ledger_blocks=ledger, metrics=metrics,
        )
        if prefix_cache > 0:
            # the arena exists only for the prefix cache's blocks; a
            # ledger-only pool (PREFIX_CACHE=0, KV_BLOCKS set) holds none
            arena = TorchKVArena(cfg, data_blocks + 1, block_tokens, device=self.device,
                                 dtype=self.cache_dtype)
            self._paged_prefix = _PagedPrefixStore(self.kv_pool, arena, self._prefix_lcp_min)
            self.prefix_stats = self._paged_prefix.stats
            self._prefix_cache = self._paged_prefix

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def bucket_for_payload(self, ids: Any) -> int:
        """The bucket a prepared payload lands in (the batcher's cohort key)."""
        return self._bucket_for(max(int(getattr(ids, "size", 0) or 0), 1))

    def prepare(self, payload: Any) -> np.ndarray:
        tokens = payload.get("tokens", []) if isinstance(payload, dict) else payload
        ids = np.asarray(tokens, dtype=np.int64).reshape(-1)
        if ids.size == 0:
            raise InvalidParamError("tokens must be a non-empty list of ids")
        if ids.min() < 0 or ids.max() >= self.cfg.vocab_size:
            raise InvalidParamError(
                f"token ids must be in [0, {self.cfg.vocab_size}) for model '{self.name}' "
                "(tokenizer vocab larger than model?)"
            )
        return ids.astype(np.int32)[-self.cfg.max_seq:]

    def _prefill(self, tokens: np.ndarray, cache: dict, lengths: np.ndarray,
                 model: Optional[Transformer] = None) -> tuple:
        """One prefill forward of ``model`` (default the base): host token
        rows [B, S] and true lengths [B] into ``cache`` (in place) ->
        (logits [B, V], the cache)."""
        with self._count_lock:
            self.prefills += 1
        return (model or self.model).prefill(
            to_device(tokens, self.device), cache, to_device(lengths, self.device)
        )

    @torch.no_grad()
    def run_batch(self, payloads: list[np.ndarray]) -> list[_PrefillState]:
        """Batched prefill over one bucket -> per-request states. The batch
        dim pads to a power of two >= max_batch; prompts longer than the
        largest bucket keep their LAST tokens (``generate`` routes those to
        chunked prefill; this clip serves direct batch callers). Each batch
        gets a fresh zero cache (the model writes it in place)."""
        n = len(payloads)
        bucket = self._bucket_for(max(int(p.size) for p in payloads))
        bsz = next_pow2(max(n, self.max_batch))
        tokens, lengths = pack_token_rows(payloads, bsz, bucket)
        full_lengths = np.maximum(lengths, 1)  # padded rows need length >= 1
        cache = self.model.init_cache(bsz, self.cfg.max_seq, self.cache_dtype)
        logits, cache = self._prefill(tokens, cache, full_lengths)
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
        decode_pool: Optional[DecodePool] = None,
        prefill_batcher: Optional[DynamicBatcher] = None,
        scheduler: Any = None,
        logprobs: bool = False,
        top_logprobs: bool = False,
        adapter: Optional[str] = None,
        adapter_params: Optional[Transformer] = None,
        ttft_cb: Any = None,
    ) -> "list[int] | tuple":
        if top_logprobs:
            logprobs = True  # alternatives imply the chosen tokens' values
        sampler = sampler or Sampler()
        stop_tokens = frozenset(stop_tokens or ())
        ids = self.prepare(tokens)
        deadline = current_deadline()
        if decode_pool is not None and not sampler.seeded:
            # the pool's deadline verdict before the prefill: a request
            # that cannot get one chunk in its budget must not burn one
            decode_pool.admit_deadline(deadline)
        model = self.model
        state = None
        if adapter is not None:
            # ONE dict read (adapters unload at runtime); a stream passes the
            # model it pinned at its eager check
            model = adapter_params if adapter_params is not None else self.adapters.get(adapter)
            if model is None:
                raise InvalidParamError(f"adapter '{adapter}' (loaded: {sorted(self.adapters)})")
            # the adapter's weights differ from a batch's: prefill solo in
            # slices of the prompt's bucket, never past the chunk budget,
            # and skip the prefix cache and speculation; decode joins the
            # pool through its adapter bank
            a_bucket = self._bucket_for(int(ids.size))
            if self.prefill_chunk_bucket is not None:
                a_bucket = min(a_bucket, self.prefill_chunk_bucket)
            state = self._chunked_prefill(ids, bucket=a_bucket, scheduler=scheduler, model=model)
        elif self._prefix_cache is not None:
            state = self._prefix_lookup(
                ids, need_logits=logprobs or sampler.penalized or not sampler.greedy
            )
        if state is None:
            chunk_b = self.prefill_chunk_bucket
            if ids.size > self.buckets[-1] or (chunk_b is not None and ids.size > chunk_b):
                # longer than the largest bucket (sliced through it, not
                # clipped) or past the PREFILL_CHUNK_TOKENS budget
                width = self.buckets[-1] if chunk_b is None else min(self.buckets[-1], chunk_b)
                state = self._chunked_prefill(ids, bucket=width, scheduler=scheduler)
            elif prefill_batcher is not None:
                state = prefill_batcher.infer(ids)
            else:
                state = self.run_batch([ids])[0]
            if self._prefix_cache is not None:
                self._prefix_store(ids, state)
        out: list[int] = []
        lps: list[float] = []
        tops: list = []  # per token: [(alt id, alt logprob)] * TOP_LOGPROBS

        def done() -> Any:
            if top_logprobs:
                return out, lps, tops
            return (out, lps) if logprobs else out

        penalty = None  # (presence, counts, bias) rows [1, V] on the device
        if sampler.penalized:
            token, penalty = self._penalized_first(sampler, ids, state)
        elif sampler.greedy:
            token = state["next_token"]
        else:
            with torch.no_grad():
                token = sampler.pick(state["logits"])
        if ttft_cb:
            ttft_cb()
        if token in stop_tokens:
            return done()
        out.append(token)
        if logprobs:
            _first_logprobs(state["logits"], token, top_logprobs, lps, tops)
        if on_token:
            on_token((token, lps[-1]) if logprobs else token)
        if max_new_tokens <= 1:
            return done()
        # seed the prefix cache with the finish-time conversation KV (base
        # requests): a follow-up turn then reuses the whole conversation
        seed_kv = self._prefix_cache is not None and adapter is None
        # speculation: with a draft (DRAFT_MODEL_NAME, the latency mode) a
        # request without penalties or logprobs takes the draft-and-verify
        # path and bypasses the pool; greedy emits exactly the target's
        # argmax, unseeded sampled requests take speculative sampling (the
        # target's warped distribution exactly); seeded ones stay on the
        # exact solo path. SPEC_POOLED stands the latency mode down: the
        # pool speculates instead, from the n-gram state spec_ctx builds
        pool_spec = decode_pool is not None and decode_pool.spec_cfg is not None
        spec_ok = (self.spec is not None and penalty is None and not logprobs
                   and adapter is None and not pool_spec)
        if spec_ok and sampler.greedy:
            cache = self._spec_generate(state, ids, out, token, max_new_tokens, on_token, stop,
                                        stop_tokens)
            if seed_kv:
                self._prefix_store_generation(ids, out, cache, sampler)
            return done()
        if spec_ok and not sampler.seeded and self.spec.k >= 2:
            cache = self._spec_generate_sampled(state, ids, out, token, max_new_tokens, on_token,
                                                stop, stop_tokens, sampler)
            if seed_kv:
                self._prefix_store_generation(ids, out, cache, sampler)
            return done()
        if decode_pool is not None and not sampler.seeded:
            pool_penalty = None
            if penalty is not None:
                pool_penalty = (*penalty, sampler.repetition_penalty,
                                sampler.presence_penalty, sampler.frequency_penalty)
            try:
                slot_q = decode_pool.submit(
                    _row_of(state), state["length"], token, max_new_tokens - 1, sampler, stop,
                    stop_tokens=stop_tokens, want_logprobs=logprobs,
                    want_top_logprobs=top_logprobs, want_kv=seed_kv, penalty=pool_penalty,
                    spec_ctx=ids if pool_spec else None, adapter=adapter,
                )
            except (queue.Full, RuntimeError):
                slot_q = None  # pool saturated/closed -> solo decode below
            if slot_q is not None:
                state = None  # release the batch's prefill buffers
                kv_row = self._consume_pool(
                    slot_q, out, lps, tops, logprobs, top_logprobs, on_token, stop
                )
                if kv_row is not None:
                    self._prefix_store_generation(ids, out, kv_row, sampler)
                return done()
        cache, cache_len = state["cache"], state["length"]
        state = None  # release the batch's prefill buffers
        cache = self._solo_decode(
            cache, cache_len, token, out, lps, tops, max_new_tokens, sampler, stop,
            stop_tokens, on_token, logprobs, top_logprobs, penalty, model, deadline,
        )
        if seed_kv:
            self._prefix_store_generation(ids, out, cache, sampler)
        return done()

    def _consume_pool(self, slot_q: Any, out: list, lps: list, tops: list, logprobs: bool,
                      top_logprobs: bool, on_token: Any, stop: Any) -> Optional[dict]:
        """Drain a pool slot's queue into ``out`` (and ``lps``/``tops``:
        its bursts are then (id, logprob, alternatives | None) triples),
        re-raising a worker failure and honoring cancellation (emission
        stops at once; the pool frees the slot at its next delivery).
        Returns the finish-time KV row when one was asked for, else None."""
        kv_row = None
        while True:
            item = slot_q.get()
            if item is DONE:
                return kv_row
            if item is DEADLINE:
                # the pool expired the row (slot and blocks already freed):
                # a 504, never a silently truncated stream
                raise DeadlineExceeded(
                    f"request deadline exceeded mid-decode (after {len(out)} tokens)",
                    stage="decode",
                )
            if isinstance(item, PoolFailure):
                raise item.exc
            if isinstance(item, tuple) and item and item[0] == "kv":
                kv_row = item[1]
                continue
            for t in item:  # one burst list per decoded chunk
                if logprobs:
                    t, lp, t_tops = t
                    lps.append(lp)
                    if top_logprobs:
                        tops.append(t_tops)
                out.append(t)
                if on_token:
                    on_token((t, lps[-1]) if logprobs else t)
                if stop is not None and stop.is_set():
                    return None  # cancelled: the row may still be mid-write

    @torch.no_grad()
    def _penalized_first(self, sampler: Sampler, ids: np.ndarray, state: Any) -> tuple:
        """First-token pick under penalties -> (token, (presence, counts,
        bias) rows [1, V] on the device, counting the token). Context
        presence penalizes the FIRST token too (greedy included), so the
        device-argmaxed id cannot be used; the additive presence/frequency
        penalties count GENERATED tokens only, so counts start at zero;
        the bias applies to every step, this one included."""
        v, dev = self.cfg.vocab_size, self.device
        presence = presence_from_tokens(ids, v, dev)
        counts = torch.zeros((1, v), dtype=torch.float32, device=dev)
        if sampler.logit_bias:
            try:
                bias = bias_row_from_map(sampler.logit_bias, v, dev)
            except ValueError as exc:
                raise InvalidParamError(str(exc)) from None
        else:
            bias = torch.zeros((1, v), dtype=torch.float32, device=dev)
        scored = apply_penalties(
            state["logits"].reshape(1, -1), presence, sampler.repetition_penalty, counts,
            sampler.presence_penalty, sampler.frequency_penalty, bias,
        )
        token = sampler.pick(scored)
        first = torch.tensor([token], device=dev)
        return token, (update_presence(presence, first), update_counts(counts, first), bias)

    @torch.no_grad()
    def _solo_decode(
        self, cache: dict, cache_len: int, token: int, out: list, lps: list, tops: list,
        max_new_tokens: int, sampler: Sampler, stop: Any, stop_tokens: frozenset,
        on_token: Any, logprobs: bool, top_logprobs: bool, penalty: Optional[tuple] = None,
        model: Optional[Transformer] = None, deadline: Any = None,
    ) -> dict:
        """Chunked decode through the pool's chunk function at B = 1
        (``decode_chunk_pool``: on-device sampling, the chosen logprobs and
        the top-k alternatives in every step), ``decode_chunk_size`` steps
        per dispatch. Pipelined: each chunk's outputs start their copy to
        pinned host memory right after its dispatch (``HostFetch``; the
        logprobs only when asked for), then chunk N+1 is enqueued (its input
        token stays on the card), then chunk N's copy is waited for: the
        wait covers chunk N and its copy, not chunk N+1, which runs
        meanwhile. Stop conditions lag by at most one chunk, whose ids are
        dropped. Every dispatch runs the full chunk unless the cache end
        forces a short one. ``penalty`` (presence, counts, bias rows of a
        penalized request) runs ``decode_chunk_pool_penalized`` at B = 1
        instead. ``model`` is an adapter's LoRA model (default the base).
        ``deadline``: checked at each chunk boundary, as the pool checks a
        row (stage ``decode``, a 504). Returns the final cache (every
        dispatched chunk's writes landed)."""
        model = model or self.model
        max_len = int(cache["k"].shape[2])
        greedy = sampler.greedy
        gen = None if greedy else sampler.generator(self.device)
        temp = 0.0 if greedy else sampler.temperature
        knobs = (temp, sampler.top_k, sampler.top_p, sampler.min_p)
        pen_knobs = [
            torch.full((1,), value, dtype=torch.float32, device=self.device)
            for value in (sampler.repetition_penalty, sampler.presence_penalty,
                          sampler.frequency_penalty)
        ] if penalty is not None else None  # made once: the chunk reads tensors
        pending: deque = deque()
        token_dev = to_device(np.asarray([[token]], np.int32), self.device)
        in_flight = 0
        stopped = False
        while not stopped:
            # the launches too run under the watchdog: behind a stuck kernel
            # the CUDA launch queue fills and the host blocks in the launch
            with self._watch("decode_chunk"):
                while (
                    not (stop is not None and stop.is_set())
                    and len(pending) < 2
                    and in_flight < max_new_tokens - len(out)
                    and cache_len + in_flight < max_len
                ):
                    n = min(self.decode_chunk_size, max_len - cache_len - in_flight)
                    if penalty is None:
                        toks_dev, lps_dev, tvals, tids, token_dev, cache = (
                            model.decode_chunk_pool(
                                token_dev, cache, n, gen, *knobs, all_greedy=greedy
                            )
                        )
                    else:
                        presence, counts, bias = penalty
                        toks_dev, lps_dev, tvals, tids, token_dev, cache, _, _ = (
                            model.decode_chunk_pool_penalized(
                                token_dev, cache, n, gen, *knobs, presence, pen_knobs[0], counts,
                                pen_knobs[1], pen_knobs[2], bias, all_greedy=greedy,
                            )
                        )
                    outputs = (toks_dev, lps_dev) if logprobs else (toks_dev,)
                    tops_out = (tvals, tids) if top_logprobs else ()
                    pending.append((HostFetch(*outputs, *tops_out), n))
                    in_flight += n
            if not pending:
                break
            fetch, n = pending.popleft()
            with self._watch("decode_chunk"):
                arrays = fetch.wait()
            in_flight -= n
            cache_len += n
            if deadline is not None and deadline.expired():
                self._shed_solo_decode(deadline, len(out))
            for j, t in enumerate(arrays[0][0, : min(n, max_new_tokens - len(out))].tolist()):
                if t in stop_tokens:
                    stopped = True
                    break
                out.append(t)
                if logprobs:
                    lps.append(float(arrays[1][0, j]))
                if top_logprobs:
                    alts = zip(arrays[3][0, j].tolist(), arrays[2][0, j].tolist())
                    tops.append([(int(i), float(v)) for i, v in alts])
                if on_token:
                    on_token((t, lps[-1]) if logprobs else t)
                if stop is not None and stop.is_set():
                    stopped = True
                    break
            if len(out) >= max_new_tokens:
                stopped = True
        return cache

    def _shed_solo_decode(self, deadline: Any, emitted: int) -> None:
        """Mid-decode expiry on the solo path: the pool's accounting (stage
        ``decode``, cause ``deadline``, the record's shed stage), then the
        504; the chunks in flight are dropped with the request."""
        if self.metrics is not None:
            deadline_exceeded_counter(self.metrics).inc(stage="decode")
            cancellations_counter(self.metrics).inc(cause="deadline")
        record = current_record()
        if record is not None:
            record.note_shed("decode")
        raise DeadlineExceeded(
            f"deadline expired mid-decode after {emitted} tokens "
            f"(budget {deadline.budget_s * 1000:.0f} ms, solo path)", stage="decode",
        )

    @torch.no_grad()
    def warmup(self, progress: Any) -> None:
        """The boot's warm stages: the kernels' build on the card (nvcc at
        first use), one prefill forward at each shape serving dispatches
        (fresh caches, uncounted), and the solo speculation's calls; the
        decode pool warms its own chunk. The shapes: the batcher's padded
        batch at every bucket it is sent, which under PREFILL_CHUNK_TOKENS
        stops at the chunk bucket, and then the chunked prefill's slice at
        batch 1."""
        if self.device.type == "cuda":
            from gofr_tpu_torch.ops import flash

            progress("building the CUDA kernels (nvcc at first use)", kind="kernel_build")
            flash.build()
        bsz = next_pow2(self.max_batch)
        chunk_b = self.prefill_chunk_bucket
        shapes = [(bsz, b, "prefill") for b in self.buckets if chunk_b is None or b <= chunk_b]
        if chunk_b is not None:
            shapes.append((1, chunk_b, "prefill_chunk"))
        for i, (batch, bucket, kind) in enumerate(shapes):
            progress(f"warming prefill bucket {bucket} (batch {batch}, {i + 1}/{len(shapes)})",
                     kind=kind, bucket=bucket)
            cache = self.model.init_cache(batch, self.cfg.max_seq, self.cache_dtype)
            tokens = np.zeros((batch, bucket), np.int32)
            lengths = np.ones(batch, np.int32)
            logits, _ = self.model.prefill(to_device(tokens, self.device), cache,
                                           to_device(lengths, self.device))
            if self.device.type == "cuda":
                # each stage's time is its shape's work on the card, not
                # the host's issue of it (boot only, never a serving path)
                torch.cuda.synchronize(self.device)
            del logits, cache
        if self.spec is not None:
            progress(f"warming speculation (k={self.spec.k})", kind="spec_verify")
            self._warmup_spec()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefix_entries(self) -> Optional[int]:
        """Live prefix-cache entries (None without a prefix cache)."""
        return len(self._prefix_cache) if self._prefix_cache is not None else None

    # -- the solo speculative latency mode (DRAFT_MODEL_NAME) ------------------
    @torch.no_grad()
    def _warmup_spec(self) -> None:
        """Each speculative call once, on throwaway caches, before serving:
        the draft prefill at the smallest bucket, the greedy and sampled
        draft chunks, both verifies and the capacity tail's single step."""
        spec, dev, k = self.spec, self.device, self.spec.k
        zero = to_device(np.zeros((1, 1), np.int32), dev)
        dcache = spec.prefill_prompt(np.ones((4,), np.int32), self.buckets[0], False)
        dtoks, dcache = spec.propose(zero, dcache)
        target = self.model.init_cache(1, self.cfg.max_seq, self.cache_dtype)
        self.model.verify_chunk(torch.cat([zero, dtoks], dim=1), target)
        self.model.decode_chunk_pool(zero, _cache_with_len(target, 1), 1, None, 0.0,
                                     all_greedy=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        stoks, sq, _ = spec.propose_sampled(zero, spec.reset_len(dcache, 4), gen, 1.0, 0, 1.0, 0.0)
        self.model.verify_chunk_sampled(
            torch.cat([zero, stoks[:, : k - 1]], dim=1), _cache_with_len(target, 1),
            stoks[:, : k - 1], sq[:, : k - 1], gen, 1.0,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _spec_emit_fn(self, out: list, on_token: Any, stop: Any, stop_tokens: frozenset,
                      max_new_tokens: int) -> Any:
        """The emit helper both spec paths share: append tokens, honoring
        stop tokens, the budget and cancellation; True = keep going."""

        def emit(tokens_host: list) -> bool:
            for t in tokens_host:
                if t in stop_tokens:
                    return False
                out.append(t)
                if on_token:
                    on_token(t)
                if len(out) >= max_new_tokens:
                    return False
                if stop is not None and stop.is_set():
                    return False
            return True

        return emit

    def _spec_prefill_draft(self, ids: np.ndarray) -> dict:
        """The draft's prefill under the target's chunk-or-clip policy."""
        chunked = ids.size > self.buckets[-1]
        bucket = self.buckets[-1] if chunked else self._bucket_for(int(ids.size))
        return self.spec.prefill_prompt(ids, bucket, chunked)

    def _spec_tail(self, cache: dict, cache_len: int, max_len: int, token: int, out: list,
                   max_new_tokens: int, emit: Any, stop: Any, sampler: Sampler) -> dict:
        """The capacity tail both spec paths share: the cache got too full
        for a verify but budget remains, so finish with single steps of the
        decode chunk under the request's knobs. Returns the final cache."""
        if not (len(out) < max_new_tokens and not (stop is not None and stop.is_set())
                and cache_len < max_len):
            return cache
        greedy = sampler.greedy
        gen = None if greedy else sampler.generator(self.device)
        knobs = (0.0 if greedy else sampler.temperature, sampler.top_k, sampler.top_p,
                 sampler.min_p)
        cache = _cache_with_len(cache, cache_len)
        token_dev = to_device(np.asarray([[token]], np.int32), self.device)
        while (len(out) < max_new_tokens and not (stop is not None and stop.is_set())
               and cache_len < max_len):
            toks, _, _, _, token_dev, cache = self.model.decode_chunk_pool(
                token_dev, cache, 1, gen, *knobs, all_greedy=greedy
            )
            cache_len += 1
            with self._watch("decode_chunk"):
                fetched = HostFetch(toks).wait()
            if not emit([int(fetched[0][0, 0])]):
                break
        return cache

    @torch.no_grad()
    def _spec_generate(self, state: Any, ids: np.ndarray, out: list, token: int,
                       max_new_tokens: int, on_token: Any, stop: Any,
                       stop_tokens: frozenset) -> dict:
        """Greedy speculative decode: each cycle ONE draft chunk proposes k
        tokens, ONE target verify checks them all, ONE fetch brings back
        the target's argmaxes and the accepted count (counted on the
        card), so an accepted prefix of n tokens costs the target one
        weight stream instead of n. Every emitted token is the target's own
        argmax under the verify, so output never depends on the draft.
        Acceptance is capped at k-1 so the draft cache always holds the
        committed prefix (its chunk writes k positions). Returns the final
        cache (prompt + every committed token)."""
        spec, k = self.spec, self.spec.k
        cache, cache_len = state["cache"], state["length"]
        state = None
        max_len = int(cache["k"].shape[2])
        dcache = self._spec_prefill_draft(ids)
        emit = self._spec_emit_fn(out, on_token, stop, stop_tokens, max_new_tokens)
        while (len(out) < max_new_tokens and not (stop is not None and stop.is_set())
               and cache_len + k + 1 <= max_len):
            token_dev = to_device(np.asarray([[token]], np.int32), self.device)
            draft_toks, dcache = spec.propose(token_dev, dcache)  # [1, k]
            next_ids, cache = self.model.verify_chunk(
                torch.cat([token_dev, draft_toks], dim=1), cache
            )
            # the leading drafts equal to the target's argmax, counted on
            # the card and packed with the ids: one fetch a cycle
            matches = (next_ids[:, :k] == draft_toks).to(torch.int32)
            n_acc = torch.cumprod(matches, dim=1).sum(dim=1, dtype=torch.int32)
            with self._watch("spec_verify"):
                packed = HostFetch(torch.cat([next_ids, n_acc[:, None]], dim=1)).wait()[0]
            a = packed[0, : k + 1]
            # the unclamped count feeds the stats (the budget clamp below
            # reflects emission room, not draft quality)
            n_match = int(packed[0, k + 1])
            n_use = max(min(n_match, k - 1, max_new_tokens - len(out) - 1), 0)
            with self._spec_lock:
                self.spec_stats["cycles"] += 1
                self.spec_stats["drafted"] += k
                self.spec_stats["accepted"] += n_match
            # a[0..n_use]: n_use accepted drafts + the bonus
            keep_going = emit([int(t) for t in a[: n_use + 1]])
            cache_len += 1 + n_use  # the pending token and the accepted drafts
            if not keep_going:
                break
            cache = _cache_with_len(cache, cache_len)
            dcache = spec.reset_len(dcache, cache_len)
            token = int(a[n_use])  # the bonus: emitted, not yet in the cache
        else:
            # natural exhaustion only (a break means a stop already fired)
            cache = self._spec_tail(cache, cache_len, max_len, token, out, max_new_tokens, emit,
                                    stop, Sampler())
        return cache

    @torch.no_grad()
    def _spec_generate_sampled(self, state: Any, ids: np.ndarray, out: list, token: int,
                               max_new_tokens: int, on_token: Any, stop: Any,
                               stop_tokens: frozenset, sampler: Sampler) -> dict:
        """Speculative SAMPLING (temperature > 0): each cycle the draft
        proposes k sampled tokens with their warped distributions q, the
        target verifies k-1 of them in one forward with the accept test
        (u < p/q) and the residual resample, so every emitted token is
        distributed as sampling the target's warped p. The cache
        accounting is the greedy path's: the draft chunk writes k
        positions, at most k-1 drafts commit a cycle, and the correction or
        bonus becomes the next pending token. Draft and verify draw from
        two generators seeded from ``secrets`` (unseeded requests carry no
        reproducibility contract; seeded ones decode solo)."""
        spec, kd = self.spec, self.spec.k - 1
        cache, cache_len = state["cache"], state["length"]
        state = None
        max_len = int(cache["k"].shape[2])
        dcache = self._spec_prefill_draft(ids)
        knobs = (sampler.temperature, sampler.top_k, sampler.top_p, sampler.min_p)
        dgen = torch.Generator(device=self.device)
        dgen.manual_seed(secrets.randbits(63))
        vgen = torch.Generator(device=self.device)
        vgen.manual_seed(secrets.randbits(63))
        emit = self._spec_emit_fn(out, on_token, stop, stop_tokens, max_new_tokens)
        while (len(out) < max_new_tokens and not (stop is not None and stop.is_set())
               and cache_len + kd + 1 <= max_len):
            token_dev = to_device(np.asarray([[token]], np.int32), self.device)
            draft_toks, qs, dcache = spec.propose_sampled(token_dev, dcache, dgen, *knobs)
            emitted, n_acc_dev, cache = self.model.verify_chunk_sampled(
                torch.cat([token_dev, draft_toks[:, :kd]], dim=1), cache, draft_toks[:, :kd],
                qs[:, :kd], vgen, *knobs,
            )
            with self._watch("spec_verify"):
                packed = HostFetch(torch.cat([emitted, n_acc_dev[:, None]], dim=1)).wait()[0]
            row = packed[0, : kd + 1]
            n_acc = int(packed[0, kd + 1])
            n_use = max(min(n_acc, max_new_tokens - len(out) - 1), 0)
            with self._spec_lock:
                self.spec_stats["cycles"] += 1
                self.spec_stats["drafted"] += kd
                self.spec_stats["accepted"] += n_acc
            # row[:n_use] accepted drafts + row[n_use] the correction or
            # bonus (under the budget clamp an accepted draft, equally a
            # sample of p); the last emitted token is pending, not cached
            keep_going = emit([int(t) for t in row[: n_use + 1]])
            cache_len += 1 + n_use
            if not keep_going:
                break
            cache = _cache_with_len(cache, cache_len)
            dcache = spec.reset_len(dcache, cache_len)
            token = int(row[n_use])
        else:
            cache = self._spec_tail(cache, cache_len, max_len, token, out, max_new_tokens, emit,
                                    stop, sampler)
        return cache

    @torch.no_grad()
    def score(self, tokens: Any, adapter: Optional[str] = None) -> list[float]:
        """log p(t_i | t_<i) for every prompt position i >= 1 (completions
        echo + logprobs): the prompt zero-padded to its bucket, one
        ``score_tokens`` forward, the first n - 1 values; under
        ``adapter``'s model when named (an eval of an adapter must never
        get the base's scores). The length is checked before ``prepare``,
        whose clip to the last max_seq tokens would misalign the scores
        with the caller's prompt."""
        model = self.model
        if adapter is not None:
            model = self.adapters.get(adapter)
            if model is None:
                raise InvalidParamError(f"adapter '{adapter}' (loaded: {sorted(self.adapters)})")
        if len(tokens) > self.buckets[-1]:
            raise InvalidParamError(
                f"prompt of {len(tokens)} tokens exceeds the largest bucket "
                f"({self.buckets[-1]}): scoring needs one full-sequence forward"
            )
        ids = self.prepare(tokens)
        n = int(ids.size)
        if n < 2:
            return []  # position 0 has no conditional
        row = np.zeros((1, self._bucket_for(n)), np.int32)
        row[0, :n] = ids
        out = model.score_tokens(to_device(row, self.device))[0, : n - 1]
        return [float(x) for x in out.tolist()]

    @torch.no_grad()
    def _chunked_prefill(self, ids: np.ndarray, bucket: Optional[int] = None,
                         scheduler: Any = None, model: Optional[Transformer] = None) -> dict:
        """Prefill a prompt longer than the largest bucket (or the
        PREFILL_CHUNK_TOKENS budget) in [1, bucket] slices, each written
        into the same fresh [1]-row cache at its offset (the model's
        chunk-resume contract). ``scheduler`` interleaves each slice with
        pooled decode turns. ``model``: an adapter's (default the base).
        One host sync at the end (the last slice's argmax), watched.

        Each slice is a ``prefill_chunk`` dispatch record, and the
        request's flight record gets its enqueue and dispatch marks (no
        batcher queue: the wait is ~0), the slices, their ids and the
        scheduler's defers. A slice's record closes when the next one is
        issued; the last stays running through the sync, so a stuck card
        shows as that slice on /admin/dispatches."""
        bucket = bucket or self.buckets[-1]
        cache = self.model.init_cache(1, self.cfg.max_seq, self.cache_dtype)
        logits = None
        total = 0
        record = current_record()
        if record is not None:
            record.mark_enqueue()
            record.mark_dispatch(1)
        drec = None
        try:
            for tokens, lengths, size in _prompt_chunks(ids, bucket):
                if scheduler is not None:
                    wait = scheduler.admit_prefill(bucket)
                    if record is not None and wait:
                        record.note_sched_defer(wait)
                if self.timeline is not None:
                    if drec is not None:
                        self.timeline.finish(drec)
                    drec = self.timeline.begin("prefill_chunk", bucket=bucket, batch_size=1,
                                               tokens=size)
                    if record is not None:
                        record.note_dispatch_id(drec.dispatch_id)
                logits, cache = self._prefill(tokens, cache, lengths, model)
                if record is not None:
                    record.note_prefill_chunk(bucket=bucket)
                total += size
            with self._watch("prefill_chunk", drec):
                next_token = int(torch.argmax(logits[0]))
        except BaseException:
            if drec is not None:
                self.timeline.finish(drec, status="error")
            raise
        if drec is not None:
            self.timeline.finish(drec)
        return {"cache": cache, "length": total, "next_token": next_token, "logits": logits[0]}

    def _watch(self, kind: str, drec: Any = None) -> Any:
        """The stall watchdog's deadline over one host wait on the card (a
        no-op without a watchdog)."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.watch(kind, drec.dispatch_id if drec is not None else 0)

    # -- the prefix cache ----------------------------------------------------
    def _prefix_lookup(self, ids: np.ndarray, need_logits: bool = False) -> Optional[dict]:
        """Prompt lookup -> a private state or None. An exact match skips
        prefill; otherwise the entry sharing the longest common token
        prefix (of at least ``_prefix_lcp_min``) seeds a tail-only prefill.
        ``need_logits``: the caller samples or scores from the final
        logits, which stored GENERATION entries lack, so those divert to
        the tail prefill instead of hitting exactly."""
        if self._paged_prefix is not None:
            return self._paged_lookup(ids, need_logits)
        key = ids.tobytes()
        with self._prefix_lock:
            entry = self._prefix_cache.get(key)
            if entry is not None and ((entry[3] is None and need_logits) or entry[2] is None):
                entry = None
            if entry is not None:
                self._prefix_cache.move_to_end(key)
                self.prefix_stats["hits"] += 1
            else:
                shared, row = self._lcp_scan(ids) if self._prefix_lcp_min >= 0 else (0, None)
                if row is None:
                    self.prefix_stats["misses"] += 1
                    self._cache_events("prefix", "miss")
                    return None
                self.prefix_stats["partial_hits"] += 1
        self._cache_events("prefix", "hit" if entry is not None else "partial_hit")
        if entry is not None:  # device work outside the lock
            row, length, next_token, logits = entry
            return {"cache": _copy_row(row), "length": length, "next_token": next_token,
                    "logits": logits}
        return self._tail_prefill(ids, _cache_with_len(_copy_row(row), shared), shared)

    def _paged_lookup(self, ids: np.ndarray, need_logits: bool) -> Optional[dict]:
        """Block-table lookup: exact hits gather the entry's blocks into a
        fresh row; LCP hits gather the shared prefix and prefill the tail."""
        hit = self._paged_prefix.lookup(ids, need_logits)
        if hit is None:
            self._cache_events("prefix", "miss")
            return None
        kind, payload, shared = hit
        if kind == "hit":
            self._cache_events("prefix", "hit")
            return payload
        self._cache_events("prefix", "partial_hit")
        return self._tail_prefill(ids, payload, shared)

    def _lcp_scan(self, ids: np.ndarray) -> tuple:
        """Under ``_prefix_lock``: the row-store entry with the longest
        common token prefix, capped at ``ids.size - 1`` so the tail keeps
        at least one token (the logits come from prefilling it)."""
        shared, key, entry = lcp_scan(
            list(self._prefix_cache.items()), ids, int(ids.size) - 1, self._prefix_lcp_min
        )
        if entry is None:
            return 0, None
        self._prefix_cache.move_to_end(key)
        return shared, entry[0]

    @torch.no_grad()
    def _tail_prefill(self, ids: np.ndarray, cache: dict, shared: int) -> dict:
        """Resume prefill from a shared-prefix cache: ``cache`` is a private
        [1]-row cache whose write head sits at ``shared``; only the tail
        runs, through its bucket at that offset. The full prompt's state is
        stored for later exact hits."""
        tail = ids[shared:]
        bucket = self._bucket_for(int(tail.size))
        logits = None
        total = shared
        # a dispatch too: one prefill_chunk record, the sync watched
        drec = None
        if self.timeline is not None:
            drec = self.timeline.begin("prefill_chunk", bucket=bucket, batch_size=1,
                                       tokens=int(tail.size),
                                       detail=f"tail prefill after {shared} shared")
            record = current_record()
            if record is not None:
                record.note_dispatch_id(drec.dispatch_id)
        try:
            for tokens, lengths, size in _prompt_chunks(tail, bucket):
                logits, cache = self._prefill(tokens, cache, lengths)
                total += size
            with self._watch("prefill_chunk", drec):
                next_token = int(torch.argmax(logits[0]))
        except BaseException:
            if drec is not None:
                self.timeline.finish(drec, status="error")
            raise
        if drec is not None:
            self.timeline.finish(drec)
        state = {"cache": cache, "length": total, "next_token": next_token, "logits": logits[0]}
        self._prefix_store(ids, state)
        return state

    def _prefix_store_generation(self, ids: np.ndarray, out: list, row: dict,
                                 sampler: Sampler) -> None:
        """Seed the prefix cache with the whole conversation (prompt +
        reply) so a follow-up turn hits everything already computed. The
        entry covers prompt + out[:-1] (the last token's KV may not be
        written) with out[-1] as its next token, but only when out[-1] is
        the greedy continuation; otherwise exact hits divert to the tail
        prefill. ``row`` must be private (the pool's hand-back copy or the
        solo final cache)."""
        if len(out) < 2 or self._prefix_cache is None:
            return
        full = np.concatenate([ids, np.asarray(out[:-1], np.int32)])
        if full.size > self.cfg.max_seq:
            return
        # out[-1] is the cached entry's next token only when it is the
        # unpenalized greedy continuation
        exactable = sampler.greedy and not sampler.penalized
        if self._paged_prefix is not None:
            self._paged_prefix.store_generation(full, row, exactable, out)
            return
        entry = (_cache_with_len(row, full.size), int(full.size),
                 int(out[-1]) if exactable else None, None)
        with self._prefix_lock:
            self._prefix_cache[full.tobytes()] = entry
            while len(self._prefix_cache) > self._prefix_cache_size:
                self._prefix_cache.popitem(last=False)

    def _prefix_store(self, ids: np.ndarray, state: Any) -> None:
        """Store this prompt's prefill result; the row store keeps a copied
        row (the live one continues into decode) and evicts LRU beyond its
        size; the paged store scatters only the prompt's blocks."""
        if self._paged_prefix is not None:
            self._paged_prefix.store(ids, state)
            return
        row = _row_of(state)
        lengths = torch.full((1,), int(state["length"]), dtype=torch.int32, device=self.device)
        entry = (
            _copy_row({"k": row["k"], "v": row["v"], "lengths": lengths}),
            state["length"], state["next_token"], state["logits"],
        )
        with self._prefix_lock:
            self._prefix_cache[ids.tobytes()] = entry
            while len(self._prefix_cache) > self._prefix_cache_size:
                self._prefix_cache.popitem(last=False)


def _first_logprobs(logits: torch.Tensor, token: int, top_logprobs: bool, lps: list,
                    tops: list) -> None:
    """Append the first token's raw logprob from the prefill logits [V]
    (and, asked for, its ``TOP_LOGPROBS`` alternatives, best first). The
    top-k runs on the card: only its 5 pairs cross to the host."""
    with torch.no_grad():
        row = torch.log_softmax(logits.float().reshape(-1), dim=-1)
        lps.append(float(row[token]))
        if top_logprobs:
            vals, idx = torch.topk(row, TOP_LOGPROBS)
            tops.append([(int(i), float(v)) for i, v in zip(idx.tolist(), vals.tolist())])


class _PagedPrefixStore:
    """Block-table prefix cache (KV_PAGED): entries are refcounted block
    tables in a shared ``BlockPool`` arena. A stored conversation aliases
    the whole blocks of the prefix entry it extends, and the LRU yields
    blocks to decode-pool admission. Lookups hand the model the contiguous
    row it computes on (``TorchKVArena.gather_row``). Entry meta:
    ``length``, ``next_token`` (None: divert to the tail prefill),
    ``logits`` (None for generation entries). ``_lock`` serializes arena
    copies; the pool's own lock nests inside it."""

    def __init__(self, pool: BlockPool, arena: TorchKVArena, lcp_min: int):
        self.pool = pool
        self.arena = arena
        self.lcp_min = lcp_min  # resolved by the runner; -1 = exact only
        self.stats = {"hits": 0, "partial_hits": 0, "misses": 0}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.pool)

    def lookup(self, ids: np.ndarray, need_logits: bool) -> Optional[tuple]:
        """-> ("hit", state, 0) | ("partial", gathered_cache, shared) |
        None. Blocks are pinned (increfed) across the gather so an eviction
        cannot free them mid-copy."""
        key = ids.tobytes()
        with self._lock:
            with self.pool.lock:
                entry = self.pool.cache_lookup(key)
                if entry is not None and (
                    (entry.meta["logits"] is None and need_logits)
                    or entry.meta["next_token"] is None
                ):
                    entry = None  # the row store's divert rules
                if entry is not None:
                    meta = dict(entry.meta)
                    pinned = list(entry.table.blocks)
                    self.pool.incref(pinned)
                    self.stats["hits"] += 1
                    shared = 0
                else:
                    shared, donor = (
                        self._lcp_scan(ids, int(ids.size) - 1, self.lcp_min)
                        if self.lcp_min >= 0 else (0, None)
                    )
                    if donor is None:
                        self.stats["misses"] += 1
                        return None
                    pinned = list(donor.table.blocks[: blocks_for(shared, self.pool.block_tokens)])
                    self.pool.incref(pinned)
                    self.stats["partial_hits"] += 1
            try:
                if shared:
                    return ("partial", self.arena.gather_row(BlockTable(pinned, shared), shared),
                            shared)
                cache = self.arena.gather_row(BlockTable(pinned, meta["length"]), meta["length"])
            finally:
                self.pool.release_blocks(pinned)
        return ("hit", {"cache": cache, "length": meta["length"],
                        "next_token": meta["next_token"], "logits": meta["logits"]}, 0)

    def _lcp_scan(self, ids: np.ndarray, limit: int, min_shared: int) -> tuple:
        """Longest-common-token-prefix donor entry (pool lock held)."""
        shared, key, entry = lcp_scan(self.pool.cache_items(), ids, limit, min_shared)
        if entry is None:
            return 0, None
        self.pool.cache_touch(key)
        return shared, entry

    def store(self, ids: np.ndarray, state: Any) -> None:
        """Prompt prefill result -> blocks: only ``ceil(length /
        block_tokens)`` blocks are copied. Exhaustion skips the store (the
        cache never fails a request)."""
        length = int(state["length"])
        with self._lock:
            try:
                table = self.pool.reserve(length)
            except KVExhausted:
                return
            table.length = length
            self.pool.note_copied(self.arena.scatter_row(_row_of(state), table))
            self.pool.cache_put(ids.tobytes(), table, {
                "length": length, "next_token": state["next_token"], "logits": state["logits"],
            })

    def store_generation(self, full: np.ndarray, row: dict, exactable: bool, out: list) -> None:
        """Conversation store (prompt + reply): alias the whole blocks of
        the longest cached prefix it extends and copy only the rest. The
        boundary block stays the donor's."""
        bt = self.pool.block_tokens
        with self._lock:
            with self.pool.lock:
                shared, donor = self._lcp_scan(full, int(full.size), bt)
                if donor is not None:
                    table, shared_tokens = self.pool.alias_full_blocks(donor.table, shared)
                else:
                    table, shared_tokens = BlockTable(), 0
                try:
                    self.pool.ensure(table, int(full.size))
                except KVExhausted:
                    self.pool.release(table)
                    return
                table.length = int(full.size)
            self.pool.note_copied(
                self.arena.scatter_row(row, table, skip_blocks=shared_tokens // bt)
            )
            self.pool.cache_put(full.tobytes(), table, {
                "length": int(full.size),
                "next_token": int(out[-1]) if exactable else None,
                "logits": None,
            })
