#!/usr/bin/env python3
"""Drive gofr_tpu_torch on one NVIDIA GPU end to end.

    python3 chip_smoke.py        # from the repository root, one card
    python3 chip_smoke.py --repeat-serve-train N   # hunting a device fault (below)
    python3 chip_smoke.py --serve-ab PARENT_TREE   # phases 5 and 10 against a parent tree

Phases, each fatal on failure (no phase is skipped or caught):

1. build: compile every ``gofr_tpu_torch/csrc/*.cu`` (the flash forward and
   the backward's dQ and dK/dV kernels) with nvcc for sm_90a, in parallel,
   and print each redesigned kernel's registers, spills (there must be
   none) and shared memory;
2. kernel vs plain: the flash forward (three variants: sm90 for bf16 D=128
   Sq >= 64, decode for bf16 D=128 Sq x groups <= 16, mma for the rest)
   against ``flash_attention_ref`` at llama3-8b head shapes (bf16, Hq=32,
   Hkv=8, D=128: the training shape, ragged causal prefill with a poisoned
   cache tail, tiles cut at 130/200 and 300/1024, GQA groups 1, 2 and 8 in
   prefill and in decode, decode over a 2048-slot cache, kv_lens=0 rows;
   and the serving run's own calls: batch-4 prefill at buckets 128 and
   1024, batch-1 decode at kv_len 616 and 1800, phase 10's chunk slices
   (B=1, Sq=512 at offsets 512 and 1024, the second ragged at kv_len 1500),
   prefix tail (B=1, Sq=64 at offset 256) and phase 11's teacher-forced
   scoring (B=1, Sq=Skv=512, no cache: the full bucket, and 300 real tokens
   with other keys and values in the pad, the real rows bit-identical), K/V
   one layer of a [L, B,
   2048, 8, 128] cache poisoned past kv_len with +-300 and with NaN) and at
   the tiny model's f32 D=16, tolerances as in tests/test_flash.py (bf16
   2e-2, f32 2e-5, atol + rtol*|ref|); each case must run the variant its
   shape picks (the launch counters say which ran), and the decode variant
   must give the same bits twice; and at the encoder's attention (phase
   15): bert-base's 12 and bert-tiny's 2 heads of D=64, bf16, non-causal,
   B=8, S=128, ragged kv_lens with 1 and 128, K/V poisoned past kv_len
   (+-300, NaN), q/k/v strided views of one [B, S, 3, H, 64] product: each
   one mma launch (the counters say so), the tail invisible bit for bit;
3. kernel times at the prefill and decode shapes: the kernel, the mma
   kernel it replaced, its bound on the card, the plain version, and
   scaled_dot_product_attention as a yardstick (never called by the port;
   at the training shape both with a boolean mask and with
   is_causal=True, as at the scoring shape); at the decode shapes each of
   the kernel, the mma
   kernel and SDPA also by device time (``gofr_tpu_torch.timing.
   graph_ms``: 20 launches in one CUDA graph, replayed), since there the
   CUDA-event time is the host's issue rate; the encoder's attention at
   B=1, 2, 8 (bert-base) and B=8 (bert-tiny), non-causal, SDPA with the
   boolean key mask as the yardstick, by both clocks; and the decode and dQ
   wrappers run once under ``torch.cuda.set_sync_debug_mode("error")``:
   neither reads a device value on the host;
4. f32 path: the tiny f32 model, built on the card from a seed, greedy-
   decodes 16 tokens through the kernel (its mma variant); the same weights
   on the CPU (plain path) must give the same ids;
5. serve: ``new()`` with MODEL_NAME=llama3-8b (full width and depth, bf16,
   random weights from MODEL_SEED) on the solo path (DECODE_POOL=off
   KV_PAGED=off, as seeded requests and pool-off deployments take it), four
   /v1/completions requests (two concurrent prompts in two buckets, one
   streamed, one sampled), the launch counts of the forward over that run
   (sm90 for every prefill dispatch's layers, decode for every decode
   step's, none on mma), TTFT and decode tokens/s; then the solo path's
   chunk (``decode_chunk_pool`` at B=1) under
   ``set_sync_debug_mode("error")``: no host sync between steps;
10. serve the default configuration (run right after phase 5, on its
   model): the decode pool and paged KV at their defaults, DECODE_SLOTS=8,
   DECODE_CHUNK=8, MODEL_BUCKETS=64,128,256,512, PREFILL_CHUNK_TOKENS=512,
   PREFIX_CACHE=4, PREFIX_LCP_MIN=64. Streams of 32 greedy tokens, 1, 4
   and 8 at once (the 8 with prompts of 100-600 bytes): aggregate decode
   tokens/s and TPOT at each; a 1,500-byte prompt prefilled in 3 slices
   (its TTFT); its exact repeat (a prefix-cache hit, equal ids); a
   shared-prefix request (a partial hit); a stream dropped by its client
   (its slot frees); two of the 8 prompts again alone (ids equal to those
   among 8 co-tenants); the launch counts (decode for every layer of every
   pool step, exactly n_layers x DECODE_CHUNK inside each pool dispatch,
   sm90 for every prefill dispatch and slice, none on mma); the 1,500-byte
   prompt's 3 slices against one pass of 2048 (the one pass's top-5
   logprobs at the last position) and the pool's delivered logprobs
   against a teacher-forced batch-1 decode of the same ids (both atol 5e-2
   + rtol 2e-2); one pool dispatch under ``set_sync_debug_mode("error")``;
   the pool's worker joined by ``app.shutdown()``; then the decode kernel at
   the pool's shape (8 slots of a 2048-slot cache, ragged kv_lens, two idle
   slots past the end, 5 splits) against its plain version, with its
   times, and 20 launches with a synchronize after each. The phase runs
   through the middleware chain: every response (of every phase) carries
   an X-Correlation-ID; /metrics, scraped every 0.2 s while the 8 streams
   decode, shows 8 active decode slots at most; before the
   dropped stream, ``gofr_tpu_tokens_total{op="decode"}`` equals the tokens
   the pool delivered (each generation's ids after its first); at its end
   ``gofr_http_requests_total`` of /v1/completions and the
   ``gofr_tpu_ttft_seconds`` count equal the phase's requests;
11. the OpenAI surface (run right after phase 10, on its model, in a fresh
   app in the same configuration), with a BPE merges file trained here
   with ``train_bpe`` from seeded text and an inline Llama-3-style
   ``CHAT_TEMPLATE_JINJA``: ``GET /v1/models``; a greedy chat of 32 tokens
   whose content is its stream's deltas joined and whose ids are
   /v1/completions' on the rendered prompt's ids (chat TTFT); ``logprobs:
   5`` over 16 pooled tokens, every chosen id its top-1 alternative with
   the same logprob, and ``echo`` + ``logprobs`` at ``max_tokens: 0`` on
   prompt + generated ids against the decode's logprobs (phase 10's
   tolerance, 5e-2 + 2e-2*|logprob|: the logits are bf16); scoring at
   bucket 512 (512 and 300 tokens; its time, n_layers sm90 launches a
   request); a seeded request's logprobs twice the same, on the solo path;
   ``n: 4`` at temperature 0.8 with 4 pool slots active at once;
   ``best_of: 4, n: 2`` keeping the two best by mean logprob and billing
   all four; a streamed ``n: 2`` with ``include_usage`` (both indices
   finish, one usage frame before [DONE]); then a second app with
   ``GEN_STOP_TOKENS`` set to the id a greedy request emitted at position
   3, which stops that request there;
12. a deployment (run right after phase 11, on its model): for each of
   ``MODEL_QUANT`` int8, int4 and w8a8 the packs built from the bf16 weights
   with ``quantize_params`` (the previous mode freed first), their weight
   bytes against the shapes' reckoning (bf16 16.1 GB, int8 and w8a8 8.6 GB,
   int4 5.0 GB), the first-token logits against the dequantized twin (the
   packs' values in a dense bf16 model: int4 within atol 1e-2, int8 within
   a twentieth and w8a8 within a tenth of the largest |logit|), each
   weight-only product on the card within one bf16 rounding of the CPU's,
   phase 10's configuration serving
   4 concurrent greedy streams of 32 tokens (aggregate tokens/s and TPOT,
   beside the bf16 model's) and the first prompt alone equal to its ids
   among 3 co-tenants; int8 weights with ``MODEL_KV_DTYPE=f8`` (the pool's
   e4m3 cache at half the bf16 bytes, 8 streams, n_layers decode launches
   a step, the upcast's device time a step under torch.profiler);
   penalties on the bf16 model with ``DECODE_POOL_PENALTIES=eager``
   (logit_bias +100 forces its id at every step, -100 bans the plain
   run's first id, repetition 1.3 + frequency 1.0 pooled equal to solo, a
   plain co-tenant's ids unchanged, an out-of-vocab id a 400 before the
   stream, kernels a step of the penalized chunk against the plain one);
   then phase 5's weights written as an HF safetensors checkpoint (bf16,
   4 shards with an index and a generation_config.json listing two EOS
   ids) by a writer in this script, a device booted through ``MODEL_PATH``
   with ``MODEL_QUANT=int8`` (load seconds and GB/s): every tensor equal
   to the int8 packs, the same greedy ids, both EOS ids default stops; the
   directory kept for phase 13, then deleted. The phase's launch counts
   are those of its served requests alone (the deltas around each), each
   pool dispatch checked at n_layers x DECODE_CHUNK decode launches;
13. speculation (run right after phase 12, on its model, phase 12's
   checkpoint kept for it): the forward at the verify shapes against its
   plain version (the pool's [8, w] verify at w = 2, 4, 5 over a 2048-slot
   cache at offsets = lengths, ragged, one row ending at the cache end, two
   idle; the solo verify B=1 Sq=5 at kv_len 1800; NaN past kv_len), with
   route, device time, bound and SDPA's time (2 and 4 on the decode
   variant, 5 on mma); the tiny f32 model's pooled and solo speculation
   on the card against plain decode, ids exactly (8 streams; the solo
   mode with the target as its own draft); the solo latency mode
   (DECODE_POOL=off,
   DRAFT_MODEL_NAME=llama3-8b, DRAFT_TOKENS=4) with the checkpoint as
   DRAFT_MODEL_PATH (the target's own weights: acceptance above half) and
   with the seeded draft, 4 prompts of 32 greedy tokens one at a time, ids
   against plain solo decode's under the near-tie rule (a divergence only
   where the plain path's top-2 logits there differ by less than 2e-2 x
   |max logit|; every divergence printed with its gap), cycles, drafted,
   accepted, tokens a verify and TPOT beside plain solo TPOT; unseeded
   sampling at temperature 0.8 (valid ids, the acceptance rate); pooled
   n-gram speculation (SPEC_POOLED=on, SPEC_K_MAX=4) at 1, 4 and 8
   concurrent streams of 32 tokens of prompts that repeat a passage, then
   8 whose draft contexts hold the plain pool's answer (4-token drafts: a
   verify of width 5, the ladder's widest, must run), ids against the
   plain pool's under the same rule, verify dispatches (> 0) and drafts
   (> 0), accepted/drafted, tokens a row a verify, aggregate tokens/s and
   TPOT beside the plain pool's. The phase's launch counts are those of
   its served speculative requests alone, by what launched them: every
   verify n_layers launches on its width's route (the decode variant at
   2 and 4, mma at 5), every draft chunk n_layers x k decode launches,
   every plain pool chunk n_layers x DECODE_CHUNK;
14. multi-LoRA (run right after phase 13, on its model, before the model
   is freed): two rank-8 adapters (alpha 16) over all eight weight keys
   (22,030,336 parameters) trained with ``make_lora_train_step`` at phase
   9's shape (B=1, 2049-token crops of a seeded corpus, remat, 4 steps,
   clipped AdamW at 1e-2): ``calm`` over the bf16 base, ``wild`` as QLoRA
   over ``model.quantized("int8")``, each with its step time, tokens/s,
   peak memory, losses (finite), launches (every forward, dQ and dK/dV
   call on sm90), the base bit-identical after the steps (a host copy
   compared tensor by tensor) and the optimizer's moments the adapters'
   alone; both exported with ``save_params(dir, export_adapter(state))``.
   Then phase 10's configuration with ``LORA_ADAPTERS=calm=...,wild=...``
   and ``ADMIN_TOKEN``: greedy /v1/completions of 32 tokens for the base,
   ``"model": "calm"`` and ``"adapter": "wild"`` (one adapter's ids must
   differ from the base's); 8 concurrent streams mixing base, calm and
   wild (adapter chunks > 0, one of them with base rows) beside 8 base-only
   streams (aggregate tokens/s and TPOT); one pool step of 8 slots with an
   adapter slot and without (launches under torch.profiler, device time by
   ``graph_ms``); an adapter's own device memory against the 44.06 MB
   reckoned; the admin routes (401 without the token; a third adapter
   loaded during a live adapter stream, its bank swap deferred until the
   slot finishes; listed; unloaded); a penalized request beside the live
   adapter slot and a penalized adapter request, both solo (the pool's
   ``adapter_mix`` and ``penalized_adapter`` rejects); /v1/models; an
   unknown adapter's 400; echo + logprobs scoring under calm (not the
   base's); the launch counts of the served requests (sm90 prefill, decode
   pool steps, none on mma). Last, each adapter's pooled ids against a
   plain solo ``generate`` on ``merge_lora`` weights under phase 13's
   near-tie rule, and calm's scores against the merged weights' (phase 10's
   tolerance);
6. backward kernels vs plain: the dQ and dK/dV kernels (their sm90 variants
   for bf16 D=128, their mma variants for f32) against
   ``flash_attention_bwd_ref`` at the training shape (B=1, S=2048, Hq=32,
   Hkv=8, D=128, bf16, causal), ragged GQA cases with a poisoned cache tail
   (+-300, and NaN in K/V as a strided slice of a [L, B, 2048, 8, 128]
   cache) whose dK/dV rows must be exactly 0 and whose dQ must be finite,
   tiles cut at 130/200, GQA groups 1, 2 and 8, a kv_lens=0 row (all grads
   exactly 0), a non-causal case and f32 D=16 at the tiny model's shapes
   (bf16 2e-2 + 2e-2*|ref|, f32 1e-4 + 2e-5*|ref|, as tests/test_flash.py's
   gradient tests); dQ and dK/dV bit-identical across two launches;
7. backward kernel times at the training shape: each kernel, the mma
   kernel beside each sm90 one, its bound, the plain backward, and the
   backward of scaled_dot_product_attention (forward + backward minus
   forward) as a yardstick; the forward kernel at the same shape;
8. f32 training parity: the tiny f32 model, built on the card from a seed,
   takes 3 ``make_train_step`` steps through the kernels; a CPU copy with
   the same weights takes them through the plain versions; the losses
   agree and every layer of every step launched all three kernels;
9. train llama3-8b: full width and depth, bf16, random weights from a
   seed, AdamW, remat, batch 1 of 2049-token crops (the model sees 2048)
   from a TokenDataset over a uint32 corpus made with numpy, 4 steps on one
   batch through ``prefetch_to_device``: finite and falling loss, every
   layer's attention through the kernels (every forward, dQ and dK/dV call
   on its sm90 variant) in every step, step time, tokens/s, MFU and peak
   memory;
16. host services (run right after phase 14, on its model, under 60 s):
   ``TPU_BOOT=background`` in phase 5's configuration with the kernels'
   library unloaded first: readiness polled from the moment the server
   listens answers 503 with the boot's stage, then 200, the boot loaded
   the library once and the first request after 200 loads nothing; the
   echo runner (no card) under ``SPEC_POOLED=on
   SPEC_FAKE_ACCEPT=3,1,0,2``: 40 ids the prompt's cycle, drafts accepted
   and rejected; ``/favicon.ico`` (1,150 bytes) and ``/.well-known/ready``;
   ``TPU_MESH`` set stops the boot with its name;
17. observability (run right after phase 16, on its model, under 90 s), in
   phase 10's configuration with the watchdog armed by itself (120 s on
   cuda): 1 stream of 32 greedy tokens, then 8 streams in one bucket under
   ``POST /admin/profiler/start`` / ``stop`` (a ``torch.profiler`` Chrome
   trace; this phase wraps the pool's chunk on its instance with a
   one-cycle ``torch.cuda._sleep`` marker, so each chunk's kernels, by the
   pool thread's launches between two markers, are summed and held under
   that chunk's dispatch record's duration; the idle share and the decode
   MBU on device time printed), a 1,500-byte prompt (3 slices) and one
   full prefill batch of 8 x 512 tokens (its record's MFU on the analytic
   sheet, and 2·N·tokens). Every request is in ``/admin/requests``, every
   dispatch id a record names resolves in ``/admin/dispatches``, the
   timeline's prefill, chunk and slice counts equal the batcher's, the
   pool's and the runner's, the launches are sm90 and decode only (n_layers
   x DECODE_CHUNK a chunk), ``gofr_tpu_mfu`` and ``gofr_tpu_mbu`` print
   beside PERF.md's predictions, the healthy traffic raises no anomaly on a
   fitted cost-profile row, and the row this run's records fit
   (``tpu/costcal.py``) prints with its residual ratios. Then a second app
   with ``WATCHDOG_DISPATCH_TIMEOUT_S=0.5`` and one prefill slowed on the
   card by ``torch.cuda._sleep`` (~1 s, in a wrapper this phase installs on
   the runner): the engine walks serving -> degraded -> serving,
   ``/.well-known/ready`` answers 503 with the watchdog's evidence
   meanwhile, ``gofr_tpu_device_stalls_total`` counts 1 and
   ``/admin/anomalies`` shows the ``slow_dispatch``;
18. overload and failure (run right after phase 17, on its model, ~90 s), in
   phase 10's configuration with ``JOURNAL=on`` on a WAL (``JOURNAL_DIR``,
   a temporary directory), ``RECOVERY_ENABLED=on``, ``SLO_TARGETS`` and
   ``WATCHDOG_DISPATCH_TIMEOUT_S=1``; its forward launches (sm90 and the
   decode variant only) counted from 0: (1) deadlines: a stream with 1.5 s
   of budget and 256 tokens to go expires mid-decode (an error frame, stage
   ``decode``; its ids a prefix of the same request's greedy ids; its ledger
   reservation back), and while it decodes a 20 ms budget is refused at the
   pool's admission (504, stage ``admission``) with no prefill launched;
   (2) client aborts: 8 streams, 4 clients close after their first frames:
   4 ``client_abort`` cancellations, the close-to-free time beside the chunk
   cadence, the other 4 equal to their solo greedy ids; (4) a wedge: an
   uninterrupted greedy stream of 64 tokens, then the same request twice at
   once with the pool's fifth chunk slowed on the card past the wedge
   (``torch.cuda._sleep`` 5 s in a wrapper this phase installs on the pool;
   the streams stop at token 17):
   serving -> degraded -> wedged -> recovering -> warming -> serving, a
   postmortem bundle listed with torch, CUDA and the card in its versions,
   the weights' storage unchanged, the MTTR and peak memory across the
   rebuild; then ``X-Resume-From`` returns the rest (a teacher-forced
   re-prefill on sm90), equal to the uninterrupted ids or parting at a near
   tie; (6) ``/admin/slo/budget``, a token-rate series on
   ``/admin/timeseries``, ``/admin/overview`` and ``/admin/costmodel``'s
   ``anomalies_per_sec``; (5) a second app on the same weights and
   ``JOURNAL_DIR`` rehydrates the other interrupted stream and resumes it,
   equal to (4)'s resumed ids; (3) brownout (``BROWNOUT_QUEUE_DEPTH=1``,
   ``BROWNOUT_KV_UTIL=0.5``): 8 long streams reserve the ledger past half,
   then 16 requests at priorities 2 and 8: every priority 2 shed with 429
   and ``Retry-After``, every priority 8 served, the level on the gauge and
   ``/admin/engine``, back to 0 after; (7) TPOT at 8 streams with the
   journal off, in memory and on disk, in turns on one app;
15. the encoder and MLP families (run last, after phase 9): ``new()`` with
   MODEL_NAME=bert-base (bf16, full width and depth, MODEL_SEED=0, the byte
   tokenizer): its weight bytes on the card equal to ``bert_param_count``
   x 2 (217,706,496); ``POST /v1/embeddings`` with an id list, a string,
   8 items of 1-128 tokens in one request, 8 concurrent single-item
   requests, and a 129-token item (its 400); the launch counts of those
   requests (every dispatch exactly n_layers = 12 mma launches, no sm90 or
   decode); latency at batch 1 and 8, embeddings/s under the 8 concurrent
   requests; one dispatch of 8 under ``torch.profiler`` (its kernels and
   device time); the 18 embeddings against the same weights' on the CPU
   (plain path; bf16 2e-2, max |d| and the smallest cosine printed); other
   ids in the padding give the same embeddings bit for bit. Then
   MODEL_QUANT=int8 (within 0.05 of bf16, tests/test_models.py's bound),
   and MODEL_NAME=mlp (f32, TF32 off) behind a copy of
   ``examples/http-server/main.py``'s ``/infer``: 8 concurrent requests
   equal to the CPU's within 2e-5, a 63-wide input's 400.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.

``--serve-ab PARENT_TREE`` runs instead phases 5 and 10 of PARENT_TREE's
``chip_smoke.py`` and of this one, each in its own process, in three arms
taken in turns (parent, this without /metrics scrapes, this with them,
then back, three times): the parent has no /metrics, so the middleware's
cost is read between the first two arms and the scrapes' between the
last two. It prints each run's aggregate tokens/s, TPOT, mean TTFT at 1,
4 and 8 streams and launch counts, each arm's median and range, and
``host_cost``: the host time the chain adds to one request and the metric
updates add to a request and a pool chunk, measured alone on the same
host.

``--repeat-serve-train N`` runs instead phase 10, the pool's decode kernel
and phase 9 N times in one process, on a fresh llama3-8b each time, under
``CUDA_LAUNCH_BLOCKING=1`` and the debug build of the kernels
(``FLASH_DEBUG_BUILD=1``: their device-side index checks compiled in), so
a device fault stops at the launch that made it; it prints a
``{"repeat_serve_train": ...}`` summary and the card's line. Exits
non-zero, with a line on stderr and no result, without a CUDA device (2)
or without the
gofr_tpu_torch package beside it (3).
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# backward: (atol, rtol), tests/test_flash.py's gradient tolerance for f32
BWD_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 2e-5)}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- phase 2/3: the kernel against its plain version ------------------------

def make_case(torch, gen, b, sq, skv, hq, hkv, d, dtype, offsets, kv_lens, poison=False):
    """q, k, v, offsets, lens; ``poison`` True puts finite garbage (K 300,
    V -300) in the tail past kv_len, a float puts that value in both."""
    dev = "cuda"
    q = torch.randn(b, sq, hq, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, skv, hkv, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, skv, hkv, d, device=dev, generator=gen).to(dtype)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    if poison is not False:
        # garbage in the unwritten tail: must not move the output
        kp, vp = (300.0, -300.0) if poison is True else (poison, poison)
        tail = torch.arange(skv, device=dev)[None, :] >= lens[:, None]
        k = k.masked_fill(tail[:, :, None, None], kp)
        v = v.masked_fill(tail[:, :, None, None], vp)
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
    return q, k, v, offs, lens


def served_case(torch, gen, b, sq, offset, kv_len, max_seq=2048, layers=2,
                poison=(300.0, -300.0)):
    """A call as the serving path makes it: q [B, Sq, 32, 128] bf16, K/V
    the last layer of a [layers, B, max_seq, 8, 128] cache (the runner's
    layout, so the slice starts mid-allocation), every row at the same
    offset and kv_len, garbage (``poison`` for K and V) past kv_len."""
    dev, bf16 = "cuda", torch.bfloat16
    q = torch.randn(b, sq, 32, 128, device=dev, generator=gen).to(bf16)
    shape = (layers, b, max_seq, 8, 128)
    k_cache = torch.randn(shape, device=dev, generator=gen).to(bf16)
    v_cache = torch.randn(shape, device=dev, generator=gen).to(bf16)
    k_cache[:, :, kv_len:] = poison[0]
    v_cache[:, :, kv_len:] = poison[1]
    offs = torch.full((b,), offset, dtype=torch.int32, device=dev)
    lens = torch.full((b,), kv_len, dtype=torch.int32, device=dev)
    return q, k_cache[-1], v_cache[-1], offs, lens


def check_tail_invisible(torch, flash, name, case, out, causal=True):
    """The kernel's output is bit-identical with the tail past kv_len zeroed."""
    q, k, v, offs, lens = case
    tail = (torch.arange(k.shape[1], device="cuda")[None, :] >= lens[:, None])[:, :, None, None]
    out2, _ = flash.flash_attention_fwd(q, k.masked_fill(tail, 0), v.masked_fill(tail, 0), causal,
                                        offs, lens)
    check(torch.equal(out, out2), f"{name}: the poisoned tail moved the kernel's output")


def no_host_sync(torch, name, fn) -> None:
    """``fn`` (one wrapper call) under ``set_sync_debug_mode("error")``:
    PyTorch raises if it synchronizes with the device, as reading a device
    value on the host would."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"no-host-sync {name}: the wrapper ran under set_sync_debug_mode('error') -> ok",
          flush=True)


def compare(torch, flash, name, case, causal=True, errs=None):
    """The forward against its plain version; the max error goes into
    ``errs[variant]``, the variant read from the sm90 counter."""
    q, k, v, offs, lens = case
    counters = {"sm90": flash.launches_fwd_sm90, "decode": flash.launches_fwd_decode}
    before = {n: c.value for n, c in counters.items()}
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    torch.cuda.synchronize()
    variant = next((n for n, c in counters.items() if c.value > before[n]), "mma")
    check(variant == flash.fwd_variant(q, k), f"{name}: ran the {variant} variant")
    if variant == "decode":
        again, _ = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
        check(torch.equal(again, out), f"{name}: the decode variant differs between two launches")
    ref_out, ref_lse = flash.flash_attention_ref(q, k, v, causal, offs, lens)
    tol = TOL[str(q.dtype).split(".")[-1]]
    err_out = (out.float() - ref_out.float()).abs()
    ok_out = bool((err_out <= tol + tol * ref_out.float().abs()).all())
    finite = torch.isfinite(ref_lse)
    check(bool((torch.isinf(lse) == ~finite).all()), f"{name}: +inf LSE rows differ")
    err_lse = (lse[finite] - ref_lse[finite]).abs()
    ok_lse = bool((err_lse <= tol + tol * ref_lse[finite].abs()).all()) if finite.any() else True
    e_out = float(err_out.max())
    e_lse = float(err_lse.max()) if finite.any() else 0.0
    print(f"kernel-vs-plain {name} [{variant}]: max|out err| {e_out:.3e} max|lse err| "
          f"{e_lse:.3e} tol {tol} (atol + rtol*|ref|) -> {'ok' if ok_out and ok_lse else 'FAIL'}",
          flush=True)
    check(ok_out and ok_lse, f"{name}: kernel disagrees with its plain version")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    if errs is not None:
        errs[variant].append(max(e_out, e_lse))
    return out, lse, max(e_out, e_lse)


def bound(q, k, offsets, kv_lens, causal):
    """Least time for the call on the card: bytes each input read once and
    each output written once (K/V only up to kv_len, what this data needs)
    over HBM rate, and the operations of the visible (query, key) pairs
    over the peak rate of the inputs' type. Returns (ms, 'bytes'|'operations')."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    es = q.element_size()
    lens = [min(int(x), k.shape[1]) for x in kv_lens.tolist()]  # the kernel stops at Skv
    offs = [int(x) for x in offsets.tolist()]
    kv_bytes = sum(lens) * hkv * d * es * 2
    nbytes = 2 * q.numel() * es + kv_bytes + b * hq * sq * 4 + 2 * b * 4
    pairs = 0
    for bi in range(b):
        for r in range(sq):
            vis = min(lens[bi], offs[bi] + r + 1) if causal else lens[bi]
            pairs += max(vis, 0)
    flops = 4 * d * hq * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_call(torch, q, k, v, offsets, kv_lens, is_causal=False, causal=True):
    """scaled_dot_product_attention over the same inputs and masking: a
    boolean mask (the keys before kv_len, and with ``causal`` those at or
    before each query's position), or (for a plain causal call: offsets 0,
    every key live, Sq = Skv) its is_causal route."""
    import torch.nn.functional as F

    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if is_causal:
        check(sq == skv and not offsets.any() and bool((kv_lens == skv).all()),
              "is_causal SDPA only for a plain causal call")
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    k_pos = torch.arange(skv, device=q.device)
    q_pos = offsets[:, None] + torch.arange(sq, device=q.device)[None, :]
    mask = k_pos[None, None, :] < kv_lens[:, None, None]
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
    mask = mask[:, None]  # [B, 1, Sq, Skv]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def time_shape(torch, flash, name, case, iters, is_causal=False, device=False, causal=True):
    """One forward shape: the kernel its shape picks, the mma kernel
    beside the sm90 and decode variants, the bound, the plain version, and
    SDPA (the boolean mask; with ``is_causal`` also its causal route, and
    ``library_ms`` the faster of the two). At a decode shape the kernel,
    the mma kernel and SDPA also by device time (a CUDA graph of 20
    launches, replayed): ``device_ms``, ``mma_device_ms``,
    ``library_device_ms``; with ``device`` at any shape (and with
    ``is_causal`` the causal route's ``library_causal_device_ms`` too,
    ``library_device_ms`` then the faster). ``causal`` False times a
    non-causal call (the encoder's) the same ways."""
    from gofr_tpu_torch.timing import event_ms, graph_ms

    q, k, v, offs, lens = case
    scale = q.shape[-1] ** -0.5
    variant = flash.fwd_variant(q, k)
    kernel = lambda: flash.flash_attention_fwd(q, k, v, causal, offs, lens)  # noqa: E731
    mma = lambda: flash._launch(q, k, v, offs, lens, causal, scale, variant="mma")  # noqa: E731
    library = library_call(torch, q, k, v, offs, lens, causal=causal)
    row = {"variant": variant, "ms": event_ms(kernel, iters)}
    if variant != "mma":
        row["mma_ms"] = event_ms(mma, iters)
    if variant == "decode" or device:
        row["device_ms"] = graph_ms(kernel)
        row["mma_device_ms"] = graph_ms(mma)
        row["library_device_ms"] = graph_ms(library)
        if is_causal:
            row["library_causal_device_ms"] = graph_ms(
                library_call(torch, q, k, v, offs, lens, is_causal=True))
            row["library_device_ms"] = min(row["library_device_ms"],
                                           row["library_causal_device_ms"])
    row["plain_ms"] = event_ms(lambda: flash.flash_attention_ref(q, k, v, causal, offs, lens),
                               iters)
    row["library_mask_ms"] = event_ms(library, iters)
    row["library_ms"] = row["library_mask_ms"]
    if is_causal:
        row["library_causal_ms"] = event_ms(
            library_call(torch, q, k, v, offs, lens, is_causal=True), iters)
        row["library_ms"] = min(row["library_mask_ms"], row["library_causal_ms"])
    row["bound_ms"], row["bound_by"] = bound(q, k, offs, lens, causal)
    row["shape"] = (f"B={q.shape[0]} Sq={q.shape[1]} Skv={k.shape[1]} Hq={q.shape[2]} "
                    f"Hkv={k.shape[2]} D={q.shape[3]} {str(q.dtype).split('.')[-1]} "
                    f"{'causal' if causal else 'non-causal'}")
    print(f"kernel-time {name} {tuple(q.shape)} kv {tuple(k.shape)}: {json.dumps(row)}", flush=True)
    return row


# -- phase 2/3 at the encoder's shapes (phase 15's attention) ------------------

ENCODER_LENS = [1, 128, 77, 5, 64, 100, 128, 33]  # ragged, with 1 and 128


def bert_case(torch, gen, b, heads, kv_lens, poison=False, s=128, d=64):
    """q, k, v as ``bert_embed`` makes them: strided views of one
    [B, S, 3, H, D] bf16 product (row stride 3 x H x D, k and v offset by
    H x D and 2 x H x D elements); offsets 0; ``poison`` as ``make_case``,
    written into the product past each row's kv_len."""
    qkv = torch.randn(b, s, 3, heads, d, device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    if poison is not False:
        kp, vp = (300.0, -300.0) if poison is True else (poison, poison)
        tail = torch.arange(s, device="cuda")[None, :] >= lens[:, None]
        qkv[:, :, 1][tail] = kp
        qkv[:, :, 2][tail] = vp
    offs = torch.zeros(b, dtype=torch.int32, device="cuda")
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], offs, lens


def encoder_kernels(torch, flash, gen) -> tuple:
    """Phase 2 and 3 at bert-base's (12 heads) and bert-tiny's (2 heads)
    attention: bf16, D = 64, non-causal, S = 128, ragged kv_lens with 1
    and 128, K/V poisoned past kv_len (+-300, NaN), q/k/v strided views of
    one product. Each case runs the mma kernel (the counters say so) and
    holds to the plain version at tests/test_flash.py's bf16 tolerance;
    the poisoned tail must not move a bit of the output. Then the times at
    B = 1, 2, 8 (bert-base) and B = 8 (bert-tiny), CUDA events and device
    time. -> (max error, timing rows by name)."""
    errs = {"sm90": [], "decode": [], "mma": []}
    cases = {}
    for label, heads in (("bert-base", 12), ("bert-tiny", 2)):
        cases[f"{label} B=8 ragged"] = bert_case(torch, gen, 8, heads, ENCODER_LENS)
        cases[f"{label} B=8 +-300 tail"] = bert_case(torch, gen, 8, heads, ENCODER_LENS,
                                                     poison=True)
        cases[f"{label} B=8 NaN tail"] = bert_case(torch, gen, 8, heads, ENCODER_LENS,
                                                   poison=float("nan"))
    for name, case in cases.items():
        q, k = case[:2]
        check(flash.fwd_variant(q, k) == "mma" and not q.is_contiguous(),
              f"encoder {name}: not the mma variant on strided views")
        before = (flash.launches.value, flash.launches_fwd_sm90.value,
                  flash.launches_fwd_decode.value)
        out, _, _ = compare(torch, flash, f"encoder {name}", case, causal=False, errs=errs)
        after = (flash.launches.value, flash.launches_fwd_sm90.value,
                 flash.launches_fwd_decode.value)
        check(after[0] - before[0] == 1 and after[1:] == before[1:],
              f"encoder {name}: the counters saw {after} after {before}, not one mma launch")
        if "tail" in name:
            check_tail_invisible(torch, flash, f"encoder {name}", case, out, causal=False)
    rows = {
        f"encoder_B{b}": time_shape(torch, flash, f"encoder bert-base B={b}",
                                    bert_case(torch, gen, b, 12, ENCODER_LENS[:b]), 50,
                                    device=True, causal=False)
        for b in (1, 2, 8)
    }
    rows["encoder_tiny_B8"] = time_shape(torch, flash, "encoder bert-tiny B=8",
                                         cases["bert-tiny B=8 ragged"], 50, device=True,
                                         causal=False)
    return max(errs["mma"]), rows


# -- phase 4: f32 path -------------------------------------------------------

def f32_path(torch, flash):
    from gofr_tpu_torch.models.llama import TINY
    from gofr_tpu_torch.models.transformer import Transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Transformer.random(TINY, "cuda", seed=7)
    plain = Transformer(TINY, "cpu")
    plain.load_state_dict(model.state_dict())
    prompt = [(i * 37 + 11) % TINY.vocab_size for i in range(23)]

    def greedy(m):
        dev = m.device
        cache = m.init_cache(1, 64)
        toks = torch.tensor([prompt], device=dev)
        logits, cache = m.prefill(toks, cache)
        first = torch.argmax(logits, dim=-1).to(torch.int64)[:, None]
        rest = m.decode_chunk_pool(first, cache, 15)[0]
        return [int(first[0, 0])] + [int(t) for t in rest[0].tolist()]

    before = flash.launches.value
    on_card = greedy(model)
    launched = flash.launches.value - before
    on_cpu = greedy(plain)
    print(f"f32-path tiny greedy: card {on_card} cpu {on_cpu} kernel launches {launched}", flush=True)
    check(on_card == on_cpu, "f32 path: kernel greedy ids differ from the plain path")
    check(launched >= TINY.n_layers * 16, f"f32 path: only {launched} kernel launches")
    return launched


# -- phase 5: serve llama3-8b --------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# completions requests sent through post() and stream_then_close(), by port
POSTED: dict = {}


def correlated(resp, what: str) -> None:
    """Every response passed the middleware chain: it carries the trace id
    as X-Correlation-ID (32 hex digits)."""
    cid = resp.getheader("X-Correlation-ID") or ""
    check(len(cid) == 32 and all(c in "0123456789abcdef" for c in cid),
          f"{what}: response without an X-Correlation-ID ({cid!r})")


def post(port: int, body: dict, stream: bool = False, path: str = "/v1/completions",
         headers: dict = None):
    """-> (status, response json or SSE frames, seconds to first frame, [frame times])."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    correlated(resp, f"POST {path}")
    if path == "/v1/completions":
        POSTED[port] = POSTED.get(port, 0) + 1
    if not stream:
        data = json.loads(resp.read())
        conn.close()
        return resp.status, data, time.perf_counter() - t0, []
    frames, times, buf = [], [], b""
    while True:
        chunk = resp.read1(65536) if hasattr(resp, "read1") else resp.read(1)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            # a frame is its data line, after the SSE id: line a single
            # stream numbers it with
            for line in frame.split(b"\n"):
                if line.startswith(b"data: "):
                    frames.append(line[6:].decode())
                    times.append(time.perf_counter() - t0)
    conn.close()
    return resp.status, frames, times[0] if times else None, times


def serve(torch, flash, card: str):
    """Phase 5. -> (the forward's launch counts, the served model)."""
    import numpy as np

    # the solo path, as seeded requests and pool-off deployments take it
    os.environ.update({
        "MODEL_NAME": "llama3-8b", "MODEL_MAX_SEQ": "2048", "BATCH_MAX_SIZE": "4",
        "BATCH_TIMEOUT_MS": "50", "TOKENIZER": "byte", "MODEL_SEED": "0",
        "DECODE_CHUNK": "8", "TORCH_DEVICE": "cuda", "HTTP_PORT": str(free_port()),
        "DECODE_POOL": "off", "KV_PAGED": "off",
    })
    import gofr_tpu_torch

    t0 = time.perf_counter()
    app = gofr_tpu_torch.new()
    gofr_tpu_torch.register_openai_routes(app)
    app.start()
    try:
        dev = app.container.tpu
        n_layers = dev.runner.cfg.n_layers
        print(f"serve: llama3-8b booted in {time.perf_counter() - t0:.1f}s "
              f"({dev.describe()}), memory {torch.cuda.memory_allocated() / 2**30:.1f} GiB",
              flush=True)
        port = app.http_port
        short = ("The quick brown fox jumps over the lazy dog while the port serves "
                 "its first request on the card. ")[:100]
        long = (("Attention is computed tile by tile with an online softmax; " * 12))[:600]
        greedy = {"max_tokens": 16, "temperature": 0}
        # record each generation's prompt and output ids (the byte
        # tokenizer gives ids >= 256 no text, so texts cannot be compared)
        generations: list = []
        inner = dev.generate

        def recording_generate(tokens, *args, **kwargs):
            out = inner(tokens, *args, **kwargs)
            generations.append((list(tokens), list(out)))
            return out

        dev.generate = recording_generate
        # every count to 0 just before the main path runs
        for c in (flash.launches, flash.launches_fwd_sm90, flash.launches_fwd_decode):
            c.reset()
        dispatches0 = dev.batcher.dispatches
        results: dict = {}

        def run(key, body, stream=False):
            results[key] = post(port, body, stream)

        pair = [threading.Thread(target=run, args=("short", {"prompt": short, **greedy})),
                threading.Thread(target=run, args=("long", {"prompt": long, **greedy}))]
        t_pair = time.perf_counter()
        for t in pair:
            t.start()
        for t in pair:
            t.join(timeout=600)
        pair_s = time.perf_counter() - t_pair
        run("stream", {"prompt": short, "stream": True, **greedy}, stream=True)
        run("sampled", {"prompt": long, "max_tokens": 16, "temperature": 0.8, "seed": 1})
        launches = flash.launches.value
        sm90 = flash.launches_fwd_sm90.value
        decode = flash.launches_fwd_decode.value
        dispatches = dev.batcher.dispatches - dispatches0

        for key in ("short", "long", "sampled"):
            status, data, secs, _ = results[key]
            check(status == 200, f"serve {key}: HTTP {status} {data}")
            n = data["usage"]["completion_tokens"]
            check(n >= 1, f"serve {key}: no tokens")
            print(f"serve {key}: 200, {n} tokens in {secs:.3f}s, "
                  f"finish {data['choices'][0]['finish_reason']}", flush=True)
        status, frames, ttft, times = results["stream"]
        check(status == 200 and frames and frames[-1] == "[DONE]",
              f"serve stream: {status} {frames[-2:]}")
        n_stream = len(frames) - 2  # one frame per token, the finish frame, [DONE]
        check(n_stream >= 1, "serve stream: no tokens")
        print(f"serve stream: 200, {n_stream} tokens, first after {ttft:.3f}s", flush=True)
        check(len(generations) == 4, f"serve: {len(generations)} generations, want 4")
        short_ids = [ids for prompt, ids in generations if len(prompt) == len(short)]
        print(f"serve greedy ids (short prompt, twice): {short_ids}", flush=True)
        check(len(short_ids) == 2 and short_ids[0] == short_ids[1],
              "serve: the repeated greedy prompt gave different tokens")
        # every prefill dispatch runs each layer's attention through the
        # sm90 variant (buckets >= 64 rows), every decode step through the
        # decode variant, and nothing through mma
        steps = sum(len(ids) - 1 for _, ids in generations)
        mma = launches - sm90 - decode
        print(f"serve: forward launches {launches}: sm90 {sm90} >= n_layers x prefill "
              f"dispatches {dispatches} = {n_layers * dispatches}; decode {decode} >= n_layers x "
              f"decode steps {steps} = {n_layers * steps}; mma {mma}", flush=True)
        check(sm90 >= n_layers * dispatches, "serve: a prefill layer missed the sm90 kernel")
        check(decode >= n_layers * steps, "serve: a decode layer missed the decode kernel")
        check(mma == 0, "serve: a call took the mma kernel")
        decode_tps = (n_stream - 1) / (times[n_stream - 1] - ttft) if n_stream > 1 else 0.0
        print(f"serve-metrics [{card}]: stream TTFT {ttft * 1e3:.1f} ms, decode "
              f"{decode_tps:.1f} tokens/s (batch 1), concurrent pair {pair_s:.3f}s", flush=True)

        # the runner's decode loop reads no device value between steps
        runner = dev.runner
        prompt = np.frombuffer(short.encode(), dtype=np.uint8).astype(np.int32)
        state = runner.run_batch([prompt])[0]
        token = torch.tensor([[state["next_token"]]], device="cuda")
        cache = state["cache"]
        before = flash.launches_fwd_decode.value
        no_host_sync(torch, "solo decode's chunk (decode_chunk_pool at B=1, 4 steps of llama3-8b)",
                     lambda: runner.model.decode_chunk_pool(token, cache, 4, None, 0.0, 0, 1.0,
                                                            0.0, all_greedy=True))
        check(flash.launches_fwd_decode.value - before == 4 * n_layers,
              "serve: the solo decode chunk missed the decode kernel")
        return {"sm90": sm90, "decode": decode}, runner.model
    finally:
        app.shutdown()


# -- phase 10: serve the default configuration ------------------------------------

# pooled (B = 8) against teacher-forced solo (B = 1) logprobs: other cuBLAS
# tilings and split counts, bf16 activations through 32 layers
POOL_LP_TOL = (5e-2, 2e-2)  # (atol, rtol)
# the defaults (pool, paged KV) plus the slice's serving shape
PHASE10_ENV = {
    "MODEL_NAME": "llama3-8b", "MODEL_MAX_SEQ": "2048", "MODEL_BUCKETS": "64,128,256,512",
    "PREFILL_CHUNK_TOKENS": "512", "DECODE_SLOTS": "8", "DECODE_CHUNK": "8",
    "BATCH_MAX_SIZE": "8", "BATCH_TIMEOUT_MS": "20", "PREFIX_CACHE": "4",
    "PREFIX_LCP_MIN": "64", "TOKENIZER": "byte", "TORCH_DEVICE": "cuda",
}
WORDS = ("attention", "kernel", "tile", "softmax", "cache", "block", "stream", "token",
         "prefill", "decode", "slot", "warp", "cluster", "shared", "memory", "copy")


def text(seed: int, n: int) -> str:
    """``n`` bytes of seeded words (the byte tokenizer: one token a byte)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = ""
    while len(out) < n:
        out += WORDS[rng.integers(len(WORDS))] + " "
    return out[:n]


def stream_then_close(port: int, body: dict, frames: int) -> int:
    """Read ``frames`` SSE frames of a stream, then drop the connection."""
    data = json.dumps({**body, "stream": True}).encode()
    POSTED[port] = POSTED.get(port, 0) + 1
    sock = socket.create_connection(("127.0.0.1", port), timeout=600)
    sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                 b"Content-Type: application/json\r\nContent-Length: "
                 + str(len(data)).encode() + b"\r\n\r\n" + data)
    buf = b""
    while buf.count(b"data: ") < frames:
        chunk = sock.recv(65536)
        if not chunk:
            break
        buf += chunk
    sock.close()
    return buf.count(b"data: ")


def get_raw(port: int, path: str, accept: str = "") -> tuple:
    """GET -> (status, headers, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("GET", path, headers={"Accept": accept} if accept else {})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    correlated(resp, f"GET {path}")
    return resp.status, dict(resp.getheaders()), body


def scrape(port: int) -> dict:
    """/metrics (text 0.0.4) -> {sample name{labels}: value}."""
    status, _, body = get_raw(port, "/metrics")
    check(status == 200, f"/metrics: HTTP {status}")
    out = {}
    for line in body.decode().splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def sample_sum(series: dict, prefix: str, must: str = "") -> float:
    """The sum of the samples named ``prefix`` (with ``must`` in their
    labels)."""
    return sum(v for k, v in series.items()
               if (k == prefix or k.startswith(prefix + "{")) and must in k)


def stream_rate(starts: list, results: list) -> tuple:
    """Concurrent streams' send times and (status, frames, ttft, times) ->
    (aggregate decode tokens/s = every stream's tokens after its first over
    the wall time from the earliest first token to the latest last token,
    mean TPOT ms, the tokens of each). Streams decoded one after another
    would read as batch 1, and a stall between them counts."""
    tpots, counts, firsts, lasts = [], [], [], []
    for t0, (status, frames, _, times) in zip(starts, results):
        check(status == 200 and frames and frames[-1] == "[DONE]", f"stream: {status}")
        n = len(frames) - 2  # one frame a token, the finish frame, [DONE]
        counts.append(n)
        check(n >= 2, "stream: fewer than 2 tokens")
        firsts.append(t0 + times[0])
        lasts.append(t0 + times[n - 1])
        tpots.append((times[n - 1] - times[0]) / (n - 1) * 1e3)
    tokens = sum(n - 1 for n in counts)
    return tokens / (max(lasts) - min(firsts)), sum(tpots) / len(tpots), counts


# phase 10 scrapes /metrics during its 8 streams (``--serve-ab`` turns it
# off in one arm, to read the scrapes' cost against the same tree)
SCRAPE_8 = True


def serve_default(torch, flash, card: str, model) -> dict:
    """Phase 10: the JAX package's default serving configuration (decode
    pool, paged KV, prefix cache, chunked prefill, scheduler) on phase 5's
    llama3-8b weights."""
    import numpy as np

    import gofr_tpu_torch
    from gofr_tpu_torch.models.transformer import _chosen_logprobs
    from gofr_tpu_torch.ops.sampling import Sampler
    from gofr_tpu_torch.tpu.decode_pool import DONE, PoolFailure

    env = {**PHASE10_ENV, "HTTP_PORT": str(free_port())}
    for key in ("DECODE_POOL", "KV_PAGED", "KV_BLOCKS", "KV_BLOCK_TOKENS", "DECODE_PIPELINE",
                "SCHED_POLICY", "SCHED_MAX_DEFER_MS"):
        os.environ.pop(key, None)  # the JAX package's defaults
    os.environ.update(env)
    t0 = time.perf_counter()
    app = gofr_tpu_torch.new(model=model)
    gofr_tpu_torch.register_openai_routes(app)
    app.start()
    try:
        dev = app.container.tpu
        pool, runner = dev.decode_pool, dev.runner
        n_layers, chunk = runner.cfg.n_layers, pool.chunk
        check(pool is not None and pool.n_slots == 8, "default: no 8-slot decode pool")
        check(runner.prefill_chunk_bucket == 512, "default: the chunk budget is not bucket 512")
        check(dev.kv_pool is not None, "default: paged KV is off")
        print(f"default: booted in {time.perf_counter() - t0:.1f}s ({dev.describe()}), memory "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
        port = app.http_port
        generations: list = []
        inner = dev.generate

        def recording_generate(tokens, *args, **kwargs):
            out = inner(tokens, *args, **kwargs)
            generations.append((tokens, out))
            return out

        dev.generate = recording_generate

        def ids_of(prompt: str):
            want = list(dev.tokenizer.encode(prompt))
            return [out for tokens, out in generations if list(tokens) == want]

        greedy = {"max_tokens": 32, "temperature": 0}
        # every count to 0 just before the main path runs
        for c in (flash.launches, flash.launches_fwd_sm90, flash.launches_fwd_decode):
            c.reset()
        d0, p0 = pool.dispatches, runner.prefills
        rates, tpots, chunk_ms = {}, {}, {}
        # the worker's chunk cadence while the HTTP, stream and batcher
        # threads run beside it (the host issues every launch of a chunk),
        # and the decode kernel's launches inside the pool's dispatches
        stamps: list = []
        in_pool = {"decode": 0, "dispatches": 0}
        dispatch = pool._dispatch_chunk

        def counted_dispatch(*args, **kwargs):
            stamps.append(time.perf_counter())
            before = flash.launches_fwd_decode.value
            out = dispatch(*args, **kwargs)
            in_pool["decode"] += flash.launches_fwd_decode.value - before
            in_pool["dispatches"] += 1
            return out

        pool._dispatch_chunk = counted_dispatch
        posted0 = POSTED.get(port, 0)
        metrics0 = scrape(port)
        ttfts: dict = {}
        prompts8 = [text(100 + i, n) for i, n in enumerate((100, 170, 240, 310, 380, 450, 500, 600))]
        for k, seed in ((1, 10), (4, 20), (8, None)):
            prompts = prompts8 if k == 8 else [text(seed + i, 100 + 70 * i) for i in range(k)]
            results, starts = [None] * k, [None] * k
            stamps.clear()

            def run(i, prompts=prompts, results=results, starts=starts):
                starts[i] = time.perf_counter()
                results[i] = post(port, {"prompt": prompts[i], "stream": True, **greedy},
                                  stream=True)

            threads = [threading.Thread(target=run, args=(i,)) for i in range(k)]
            # /metrics scraped while the 8 streams decode (not the 1 and 4:
            # a scrape's host work would weigh on their TPOT): the slot
            # gauge moves once a chunk, from host counts
            active_seen, scraping = [], threading.Event()

            def scraper(active_seen=active_seen, scraping=scraping):
                while not scraping.is_set():
                    active_seen.append(scrape(port).get("gofr_tpu_decode_slots_active", 0.0))
                    scraping.wait(0.2)

            watcher = threading.Thread(target=scraper)
            if k == 8 and SCRAPE_8:
                watcher.start()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            scraping.set()
            if k == 8 and SCRAPE_8:
                watcher.join(timeout=60)
            rates[k], tpots[k], counts = stream_rate(starts, results)
            ttfts[k] = sum(r[2] for r in results) / k * 1e3
            gaps = sorted(b - a for a, b in zip(stamps, stamps[1:]))
            chunk_ms[k] = gaps[len(gaps) // 2] * 1e3 if gaps else None
            print(f"default: {k} concurrent greedy streams of up to 32 tokens ({counts}): "
                  f"aggregate {rates[k]:.1f} tokens/s (all streams' tokens after their first "
                  f"over the earliest first to the latest last token), TPOT {tpots[k]:.2f} ms, "
                  f"mean TTFT {ttfts[k]:.1f} ms, pool chunk cadence (median) {chunk_ms[k]} ms "
                  f"over {len(stamps)} chunks", flush=True)
        print(f"default: /metrics scraped {len(active_seen)} times during the 8 streams, "
              f"decode slots active at most {max(active_seen, default=0):g}", flush=True)
        check(not SCRAPE_8 or max(active_seen, default=0) == 8,
              "default: /metrics during the 8 streams never showed 8 active decode slots")
        long = text(7, 1500)
        p1 = runner.prefills
        status, frames, chunked_ttft, _ = post(port, {"prompt": long, "stream": True, **greedy},
                                               stream=True)
        check(status == 200 and frames[-1] == "[DONE]", f"default: chunked prompt {status}")
        slices = runner.prefills - p1
        check(slices == 3, f"default: the 1,500-byte prompt took {slices} prefill dispatches")
        hits = runner.prefix_stats["hits"]
        status, _, repeat_s, _ = post(port, {"prompt": long, **greedy})
        check(status == 200 and runner.prefix_stats["hits"] == hits + 1,
              "default: the exact repeat missed the prefix cache")
        long_ids = ids_of(long)
        check(len(long_ids) == 2 and long_ids[0] == long_ids[1],
              "default: the exact repeat gave other ids than the miss")
        system = text(8, 300)
        post(port, {"prompt": system + "first question?", **greedy})
        partial = runner.prefix_stats["partial_hits"]
        status, _, lcp_s, _ = post(port, {"prompt": system + "a second one", **greedy})
        check(status == 200 and runner.prefix_stats["partial_hits"] == partial + 1,
              "default: the shared-prefix request missed its partial hit")
        # every request so far ran to its end in the pool: the decode token
        # counter holds exactly what the pool delivered (each generation's
        # ids after its first, which the prefill gives)
        check(not pool.rejects, f"default: pool rejects {pool.rejects}")
        delivered = sum(max(len(out) - 1, 0) for _, out in generations)
        key = 'gofr_tpu_tokens_total{model="llama3-8b",op="decode"}'
        counted = scrape(port).get(key, 0.0) - metrics0.get(key, 0.0)
        print(f"default: gofr_tpu_tokens_total decode {counted:g}, the pool's delivered "
              f"tokens {delivered} over {len(generations)} requests", flush=True)
        check(counted == delivered, "default: the decode token counter disagrees with the "
                                    "tokens delivered")
        stream_then_close(port, {"prompt": text(9, 200), "max_tokens": 1500, "temperature": 0}, 4)
        for _ in range(200):
            if pool.occupancy()["active"] == 0:
                break
            time.sleep(0.05)
        check(pool.occupancy()["active"] == 0, "default: the cancelled stream kept its slot")
        for i in (3, 7):
            among = ids_of(prompts8[i])[0]
            status, _, _, _ = post(port, {"prompt": prompts8[i], **greedy})
            alone = ids_of(prompts8[i])[-1]
            check(alone == among, f"default: prompt {i} alone gave other ids than among 8")
        # every completions request of the phase counted once by the
        # middleware, and each one's first token once by the device
        requests = POSTED.get(port, 0) - posted0
        series = scrape(port)
        http_n = (sample_sum(series, "gofr_http_requests_total", 'path="/v1/completions"')
                  - sample_sum(metrics0, "gofr_http_requests_total", 'path="/v1/completions"'))
        ttft_n = (sample_sum(series, "gofr_tpu_ttft_seconds_count", 'op="generate"')
                  - sample_sum(metrics0, "gofr_tpu_ttft_seconds_count", 'op="generate"'))
        print(f"default: {requests} completions requests: gofr_http_requests_total "
              f"{http_n:g}, gofr_tpu_ttft_seconds count {ttft_n:g}, generations "
              f"{len(generations)}", flush=True)
        check(http_n == ttft_n == requests == len(generations),
              "default: the request counters disagree with the phase's requests")
        launches = flash.launches.value
        sm90 = flash.launches_fwd_sm90.value
        decode = flash.launches_fwd_decode.value
        pool._dispatch_chunk = dispatch
        steps = (pool.dispatches - d0) * chunk
        prefills = runner.prefills - p0
        mma = launches - sm90 - decode
        check(in_pool["dispatches"] == pool.dispatches - d0,
              "default: a pool dispatch went around the count")
        per_chunk = in_pool["decode"] / in_pool["dispatches"]
        print(f"default: forward launches {launches}: decode {decode} >= n_layers x pool steps "
              f"{steps} = {n_layers * steps}; sm90 {sm90} >= n_layers x prefill dispatches "
              f"{prefills} = {n_layers * prefills}; mma {mma}; decode launches inside the "
              f"{in_pool['dispatches']} pool dispatches {in_pool['decode']}, {per_chunk} a chunk "
              f"(n_layers x DECODE_CHUNK = {n_layers * chunk})", flush=True)
        check(decode >= n_layers * steps, "default: a pool decode layer missed the decode kernel")
        check(per_chunk == n_layers * chunk,
              f"default: {per_chunk} decode launches a pool chunk, want {n_layers * chunk}")
        check(sm90 >= n_layers * prefills, "default: a prefill layer missed the sm90 kernel")
        check(mma == 0, "default: a call took the mma kernel")
        print(f"default: all 8 prompts and the repeats took ids alone equal to those among 8 "
              f"co-tenants; prefix cache {runner.prefix_stats}, kv {dev.kv_pool.stats()}",
              flush=True)

        # the chunked prompt's 3 slices against one pass over the whole
        # prompt: a slice at a wrong offset moves the last position's logits
        ids = np.asarray(dev.tokenizer.encode(long), np.int32)
        with torch.no_grad():
            chunked = torch.log_softmax(runner._chunked_prefill(ids, 512)["logits"].float(), -1)
            tokens = np.zeros((1, 2048), np.int32)
            tokens[0, : ids.size] = ids
            logits, _ = runner._prefill(tokens, runner.model.init_cache(1, 2048),
                                        np.asarray([ids.size], np.int32))
            whole = torch.log_softmax(logits[0].float(), -1)
            top = torch.topk(whole, 5).indices
            lp_c, lp_w = chunked[top].cpu().numpy(), whole[top].cpu().numpy()
        atol, rtol = POOL_LP_TOL
        slice_diff = np.abs(lp_c - lp_w)
        ok = bool((slice_diff <= atol + rtol * np.abs(lp_w)).all())
        print(f"default: 3 slices of 512 vs one pass of 2048 over the {ids.size}-token prompt: "
              f"the one pass's top-5 logprobs max |diff| {slice_diff.max():.3e} (tol {atol} + "
              f"{rtol}*|lp|), argmax {int(chunked.argmax())} vs {int(whole.argmax())} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, "default: the chunked prefill disagrees with one pass")

        # pooled (B = 8) against solo (B = 1), teacher-forced on the pooled
        # ids: the pool's own delivered logprobs
        ids = np.asarray(dev.tokenizer.encode(prompts8[3]), np.int32)
        with torch.no_grad():
            state = runner.run_batch([ids])[0]
            first = state["next_token"]
            slot_q = pool.submit(state.row(), state["length"], first, 31, Sampler(),
                                 stop_tokens=dev.default_stop_ids, want_logprobs=True)
            burst = []
            while (item := slot_q.get(timeout=600)) is not DONE:
                check(not isinstance(item, PoolFailure), f"default: pool failed: {item}")
                burst.extend(item)
            cache = state["cache"]
            tok = torch.tensor([[first]], dtype=torch.int32, device=runner.device)
            solo_lps = []
            for t, _, _ in burst:
                logits, cache = runner.model.decode_step(tok, cache)
                tok.fill_(t)
                solo_lps.append(float(_chosen_logprobs(logits, tok[0])))
        pooled_lps = [lp for _, lp, _ in burst]
        diff = np.abs(np.asarray(pooled_lps) - np.asarray(solo_lps))
        ok = len(burst) >= 2 and bool((diff <= atol + rtol * np.abs(solo_lps)).all())
        print(f"default: pooled vs solo logprobs of {len(diff)} tokens: max |diff| "
              f"{diff.max():.3e} (tol {atol} + {rtol}*|lp|) -> {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, "default: pooled and solo logprobs differ")

        # the pool's dispatch reads no device value on the host
        from collections import deque

        in_flight: deque = deque()
        with pool._work:
            no_host_sync(torch, "decode pool dispatch (8 slots x 8 steps)",
                         lambda: pool._dispatch_chunk(in_flight))
        in_flight.popleft()[1].wait()

        metrics = {
            "phase_s": time.perf_counter() - t0,
            "aggregate_tokens_per_s": rates, "tpot_ms": tpots, "ttft_ms": ttfts,
            "chunk_ms": chunk_ms,
            "chunked_ttft_ms": chunked_ttft * 1e3, "exact_hit_s": repeat_s,
            "partial_hit_s": lcp_s, "pool_steps": steps, "prefill_dispatches": prefills,
            "pool_lp_max_diff": float(diff.max()), "chunk_slices_lp_max_diff": float(slice_diff.max()),
        }
        print(f"default-metrics [{card}]: {json.dumps(metrics)}", flush=True)
    finally:
        app.shutdown()
    # the pool's worker is joined: nothing of the pool runs beside training
    check(not pool._thread.is_alive(), "default: the pool's worker outlived app.shutdown()")
    return {"decode": decode, "per_chunk": per_chunk, "metrics": metrics}


# -- phase 11: the OpenAI surface on llama3-8b ------------------------------------

# the decode's own logprobs against teacher-forced scoring of the same ids:
# pooled B = 8 against one cache-free forward, bf16 through 32 layers; the
# logits are bf16 (as in the JAX package), and a greedy pick's logit near 4.5
# has a bf16 spacing of 0.03125, so two computation orders differ by a spacing
# or two: phase 10's tolerance, (atol, rtol) on |logprob|
SCORE_LP_TOL = POOL_LP_TOL
LLAMA3_CHAT_TEMPLATE = (
    "{{ bos_token }}{% for m in messages %}<|start_header_id|>{{ m.role }}<|end_header_id|>"
    "\n\n{{ m.content }}<|eot_id|>{% endfor %}{% if add_generation_prompt %}"
    "<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}"
)


def get_json(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("GET", path)
    resp = conn.getresponse()
    correlated(resp, f"GET {path}")
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def boot_openai(model, env: dict):
    """A fresh app in the default configuration (phase 10's) on ``model``,
    with ``env`` on top."""
    import gofr_tpu_torch

    for key in ("DECODE_POOL", "KV_PAGED", "KV_BLOCKS", "KV_BLOCK_TOKENS", "DECODE_PIPELINE",
                "SCHED_POLICY", "SCHED_MAX_DEFER_MS", "TOKENIZER", "GEN_STOP_TOKENS",
                "GEN_STOP_EOS"):
        os.environ.pop(key, None)
    os.environ.update({**PHASE10_ENV, "HTTP_PORT": str(free_port()), **env})
    os.environ.pop("TOKENIZER", None)  # TOKENIZER_PATH names the tokenizer
    app = gofr_tpu_torch.new(model=model)
    gofr_tpu_torch.register_openai_routes(app)
    app.start()
    return app


def serve_openai(torch, flash, card: str, model) -> dict:
    """Phase 11: /v1/models, chat (stream and non-stream), logprobs and
    top-logprobs through the pool, echo + logprobs scoring, a seeded
    request's logprobs on the solo path, n and best_of, the streaming
    fan-out with its usage frame, and GEN_STOP_TOKENS, on phase 5's
    llama3-8b in the default configuration, with a BPE merges file trained
    here from seeded text and an inline Llama-3-style jinja template."""
    from gofr_tpu_torch.tokenizer import train_bpe

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="gofr_smoke_")
    try:
        corpus = " ".join(text(200 + i, 400) for i in range(16))
        bpe = train_bpe(corpus, vocab_size=256 + 3 + 160)
        merges = os.path.join(tmp, "merges.txt")
        bpe.save(merges)
        env = {"TOKENIZER_PATH": merges, "CHAT_TEMPLATE_JINJA": LLAMA3_CHAT_TEMPLATE}
        app = boot_openai(model, env)
        try:
            metrics = openai_checks(torch, flash, card, app)
        finally:
            app.shutdown()
        # GEN_STOP_TOKENS: the id a greedy request emitted at position 3
        full = metrics.pop("greedy_ids")
        stop = full[3]
        app = boot_openai(model, {**env, "GEN_STOP_TOKENS": str(stop)})
        try:
            dev = app.container.tpu
            check(dev.default_stop_ids == frozenset({stop}), "openai: GEN_STOP_TOKENS not read")
            status, data, _, _ = post(app.http_port, {"prompt": metrics.pop("greedy_prompt"),
                                                      "max_tokens": 16, "temperature": 0})
            check(status == 200, f"openai: {status} {data}")
            got = data["usage"]["completion_tokens"]
            print(f"openai: GEN_STOP_TOKENS={stop} (the id at position 3 of {full[:6]}...) -> "
                  f"{got} tokens, want {full.index(stop)} (its first position)", flush=True)
            check(got == full.index(stop), "openai: GEN_STOP_TOKENS did not stop the request")
        finally:
            app.shutdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    metrics["phase_s"] = time.perf_counter() - t0
    print(f"openai-metrics [{card}]: {json.dumps(metrics)}", flush=True)
    return metrics


def openai_checks(torch, flash, card: str, app) -> dict:
    """Phase 11's requests on one app (see ``serve_openai``)."""
    import numpy as np

    dev = app.container.tpu
    pool, port, tok = dev.decode_pool, app.http_port, dev.tokenizer
    n_layers = dev.runner.cfg.n_layers
    check(pool is not None and dev.kv_pool is not None, "openai: not the default configuration")
    check(tok is not None and tok.merges, "openai: the BPE tokenizer did not load")
    generations: list = []
    inner = dev.generate

    def recording_generate(tokens, *args, **kwargs):
        out = inner(tokens, *args, **kwargs)
        generations.append((list(tokens), out, kwargs.get("sampler")))
        return out

    dev.generate = recording_generate
    for c in (flash.launches, flash.launches_fwd_sm90, flash.launches_fwd_decode):
        c.reset()  # every count to 0 just before the path runs

    status, models = get_json(port, "/v1/models")
    check(status == 200 and [m["id"] for m in models["data"]] == ["llama3-8b"],
          f"openai: /v1/models {status} {models}")
    print(f"openai: GET /v1/models -> {models}", flush=True)

    # chat: the non-stream content is the stream's deltas joined, and its
    # ids are /v1/completions' on the rendered prompt's ids
    messages = [{"role": "system", "content": text(31, 120)},
                {"role": "user", "content": text(32, 200)}]
    chat = {"messages": messages, "max_tokens": 32, "temperature": 0}
    # another chat first (the template's first render and compile), then the
    # stream on a cold prefix cache: its TTFT is a prefill's
    status, _, _, _ = post(port, {"messages": [{"role": "user", "content": text(30, 50)}],
                                  "max_tokens": 2, "temperature": 0},
                           path="/v1/chat/completions")
    check(status == 200, f"openai: warm-up chat {status}")
    status, frames, _, times = post(port, {**chat, "stream": True, "logprobs": True},
                                    stream=True, path="/v1/chat/completions")
    check(status == 200 and frames[-1] == "[DONE]", f"openai: chat stream {status} {frames[-2:]}")
    status, whole, chat_s, _ = post(port, chat, path="/v1/chat/completions")
    check(status == 200, f"openai: chat {status} {whole}")
    chat_prompt, chat_ids, _ = generations[-1]
    deltas = [json.loads(f)["choices"][0]["delta"] for f in frames[:-1]]
    check(deltas[0] == {"role": "assistant"}, "openai: the chat stream did not open with the role")
    joined = "".join(d.get("content", "") for d in deltas)
    content = whole["choices"][0]["message"]["content"]
    chat_ttft = times[1]  # the first frame after the role carries the first token
    status, data, _, _ = post(port, {"prompt": chat_prompt, "max_tokens": 32, "temperature": 0})
    check(status == 200, f"openai: completions {status} {data}")
    print(f"openai: chat {len(chat_ids)} tokens in {chat_s:.3f}s, content {content!r:.80}; stream "
          f"deltas joined equal: {joined == content}; /v1/completions on the rendered prompt's "
          f"{len(chat_prompt)} ids gave the same ids: {generations[-1][1] == chat_ids}; chat "
          f"stream TTFT {chat_ttft * 1e3:.1f} ms", flush=True)
    check(joined == content, "openai: the chat stream's deltas differ from the content")
    check(generations[-1][1] == chat_ids, "openai: chat ids differ from /v1/completions'")

    # logprobs through the pool: the chosen id is its own best alternative
    prompt = text(33, 300)
    d0 = pool.dispatches
    status, data, _, _ = post(port, {"prompt": prompt, "max_tokens": 16, "temperature": 0,
                                     "logprobs": 5})
    check(status == 200, f"openai: logprobs {status} {data}")
    prompt_ids, (ids, lps, tops), _ = generations[-1]
    check(pool.dispatches > d0, "openai: the logprobs request did not decode in the pool")
    check(data["choices"][0]["logprobs"]["token_logprobs"] == lps,
          "openai: the response's logprobs are not the decode's")
    top1 = all(t == alts[0][0] and lp == alts[0][1] for t, lp, alts in zip(ids, lps, tops))
    check(len(ids) == len(tops) == 16 and top1,
          "openai: a chosen id is not its top-1 alternative, or its logprob differs")
    # echo + logprobs at max_tokens 0 on prompt + generated ids: teacher-forced
    status, scored, _, _ = post(port, {"prompt": prompt_ids + ids, "max_tokens": 0, "echo": True,
                                       "logprobs": 1})
    check(status == 200, f"openai: echo scoring {status} {scored}")
    score_lps = scored["choices"][0]["logprobs"]["token_logprobs"]
    check(score_lps[0] is None and len(score_lps) == len(prompt_ids) + len(ids),
          "openai: the echo scores have the wrong length")
    diff = np.abs(np.asarray(score_lps[len(prompt_ids):]) - np.asarray(lps))
    atol, rtol = SCORE_LP_TOL
    ok = bool((diff <= atol + rtol * np.abs(lps)).all())
    print(f"openai: logprobs 5 over 16 pooled tokens: every chosen id its top-1 alternative "
          f"with the same logprob: {top1}; teacher-forced scores of prompt + generated ids "
          f"against the decode's logprobs: max |diff| {diff.max():.4e} at position "
          f"{int(diff.argmax())}, |diff| by position {np.round(diff, 4).tolist()} (tol {atol} + "
          f"{rtol}*|lp|, |lp| ~{float(np.mean(np.abs(lps))):.2f}) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "openai: scores differ from the decode's logprobs")

    # scoring at the largest bucket (512): the full bucket and 300 tokens in it
    ids512 = (tok.encode(" ".join(text(40 + i, 400) for i in range(6))) * 2)[:512]
    check(len(ids512) == 512, "openai: not 512 prompt ids")
    sm90_0, dec_0 = flash.launches_fwd_sm90.value, flash.launches_fwd_decode.value
    score_s = []
    for n in (512, 300):
        t = time.perf_counter()
        status, scored, _, _ = post(port, {"prompt": ids512[:n], "max_tokens": 0, "echo": True,
                                           "logprobs": 1})
        score_s.append(time.perf_counter() - t)
        lp = scored["choices"][0]["logprobs"]["token_logprobs"] if status == 200 else []
        check(status == 200 and len(lp) == n and all(np.isfinite(lp[1:])),
              f"openai: scoring {n} tokens: {status}")
    score_launches = flash.launches_fwd_sm90.value - sm90_0
    print(f"openai: scoring at bucket 512 (512 and 300 real tokens): {score_s[0] * 1e3:.1f} / "
          f"{score_s[1] * 1e3:.1f} ms a request, sm90 launches {score_launches} (2 x n_layers = "
          f"{2 * n_layers}), decode launches {flash.launches_fwd_decode.value - dec_0}", flush=True)
    check(score_launches == 2 * n_layers, "openai: a scoring layer missed the sm90 kernel")

    # a seeded request decodes solo: the same ids and logprobs twice
    seeded = {"prompt": prompt, "max_tokens": 16, "temperature": 0.8, "seed": 7, "logprobs": 2}
    d0, dec0 = pool.dispatches, flash.launches_fwd_decode.value
    runs = []
    for _ in range(2):
        status, data, _, _ = post(port, seeded)
        check(status == 200, f"openai: seeded {status} {data}")
        runs.append((generations[-1][1][0], generations[-1][1][1]))
    solo = pool.dispatches == d0 and flash.launches_fwd_decode.value > dec0
    print(f"openai: seeded logprobs twice: same ids {runs[0][0] == runs[1][0]}, same logprobs "
          f"{runs[0][1] == runs[1][1]}, solo (no pool dispatch) {solo}", flush=True)
    check(runs[0] == runs[1] and len(runs[0][0]) >= 1, "openai: the seeded request did not repeat")
    check(solo, "openai: the seeded request did not decode solo")

    # n = 4 unseeded: the candidates decode together in the pool
    peak = {"active": 0}
    watching = threading.Event()

    def watch():
        while not watching.is_set():
            peak["active"] = max(peak["active"], pool.occupancy()["active"])
            time.sleep(0.002)

    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        status, data, fan_s, _ = post(port, {"prompt": prompt, "max_tokens": 32,
                                             "temperature": 0.8, "n": 4})
    finally:
        watching.set()
        watcher.join()
    check(status == 200 and len(data["choices"]) == 4, f"openai: n=4 {status}")
    print(f"openai: n=4 at temperature 0.8: 4 choices in {fan_s:.3f}s, "
          f"{data['usage']['completion_tokens']} tokens billed, pool peak active slots "
          f"{peak['active']}", flush=True)
    check(peak["active"] >= 4, "openai: the 4 candidates did not decode at once")

    # best_of 4, n 2: the two best of four by mean logprob, all four billed
    before = len(generations)
    status, data, _, _ = post(port, {"prompt": prompt, "max_tokens": 16, "temperature": 0.8,
                                     "n": 2, "best_of": 4, "logprobs": 1})
    check(status == 200 and len(data["choices"]) == 2, f"openai: best_of {status}")
    cands = [out for _, out, _ in generations[before:]]
    check(len(cands) == 4, f"openai: best_of made {len(cands)} candidates")
    means = sorted((float(np.mean(lp)) for _, lp in cands), reverse=True)
    got = [float(np.mean(c["logprobs"]["token_logprobs"])) for c in data["choices"]]
    billed = data["usage"]["completion_tokens"]
    print(f"openai: best_of 4 n 2: mean logprobs kept {got} of {means}; billed {billed} of "
          f"{sum(len(ids) for ids, _ in cands)} candidate tokens", flush=True)
    check(np.allclose(got, means[:2], atol=1e-6), "openai: best_of kept the wrong candidates")
    check(billed == sum(len(ids) for ids, _ in cands),
          "openai: best_of did not bill every candidate")

    # streaming fan-out: both indices finish, then one usage frame, then [DONE]
    status, frames, _, _ = post(port, {"prompt": prompt, "max_tokens": 12, "temperature": 0.8,
                                       "n": 2, "stream": True,
                                       "stream_options": {"include_usage": True}}, stream=True)
    check(status == 200 and frames[-1] == "[DONE]", f"openai: stream n=2 {status}")
    parsed = [json.loads(f) for f in frames[:-1]]
    finish = {f["choices"][0]["index"]: f["choices"][0]["finish_reason"]
              for f in parsed[:-1] if f["choices"][0]["finish_reason"] is not None}
    usage = [f for f in parsed if not f["choices"]]
    print(f"openai: stream n=2 include_usage: {len(frames)} frames, finish {finish}, usage frames "
          f"{[u['usage'] for u in usage]}", flush=True)
    check(sorted(finish) == [0, 1], "openai: a streamed index did not finish")
    check(len(usage) == 1 and parsed[-1] is usage[0], "openai: not one usage frame before [DONE]")
    check(all(f["usage"] is None for f in parsed[:-1]), "openai: a frame carries usage")

    launches = flash.launches.value
    sm90, decode = flash.launches_fwd_sm90.value, flash.launches_fwd_decode.value
    print(f"openai: forward launches {launches}: sm90 {sm90}, decode {decode}, mma "
          f"{launches - sm90 - decode}", flush=True)
    check(launches - sm90 - decode == 0, "openai: a call took the mma kernel")
    greedy = [(p, out) for p, out, s in generations if s is not None and s.greedy
              and isinstance(out, list) and len(out) >= 4]
    check(bool(greedy), "openai: no greedy request of 4 or more tokens")
    # one whose id at position 3 is not also earlier, where there is one
    greedy.sort(key=lambda g: g[1][3] not in g[1][:3])
    return {"chat_ttft_ms": chat_ttft * 1e3, "chat_s": chat_s, "score_512_ms": score_s[0] * 1e3,
            "score_300_in_512_ms": score_s[1] * 1e3, "score_launches": score_launches,
            "score_lp_max_diff": float(diff.max()), "fanout_n4_s": fan_s,
            "pool_peak_active": peak["active"], "sm90": sm90, "decode": decode,
            "greedy_prompt": greedy[-1][0], "greedy_ids": greedy[-1][1]}


# -- phase 12: a deployment (MODEL_QUANT, MODEL_KV_DTYPE, penalties, MODEL_PATH) ----

QUANT_MODES = ("int8", "int4", "w8a8")
# first-token logits of a quantized model against the same model with its
# packs dequantized (dequantize, then the bf16 forward). An int4 pack
# dequantizes into the very bf16 weights the dense forward reads, so the two
# agree up to the products' reduction order (atol). int8 sums the exact int8
# values and scales the f32 result, where the twin reads q x scale rounded
# to bf16 (2^-9 of each weight), through 32 layers; w8a8 also rounds each
# token's activations to int8 before every product (a share of the largest
# |logit| each)
QUANT_LOGIT_TOL = {"int8": ("share", 0.05), "int4": ("atol", 1e-2), "w8a8": ("share", 0.1)}
# a weight-only product on the card against the CPU's on the same operands:
# f32 sums in another order (their error, near |y| = 0: atol), one rounding
# to bf16 apart (2^-7 of |y|)
WEIGHT_ONLY_MM_TOL = (1e-3, 2.0 ** -7)  # atol, rtol
EOS_IDS = (128001, 128009)  # Llama-3 instruct's generation_config.json lists both
F8 = "float8_e4m3fn"


def boot_deployment(model, env: dict):
    """A fresh app in phase 10's configuration on ``model`` (or on
    MODEL_PATH when ``model`` is None), ``env`` on top; every other key of
    the port unset."""
    import gofr_tpu_torch
    from gofr_tpu_torch.config import DECLARED_KEYS

    for key in DECLARED_KEYS:
        os.environ.pop(key, None)
    os.environ.update({**PHASE10_ENV, "HTTP_PORT": str(free_port()), **env})
    app = gofr_tpu_torch.new(model=model)
    gofr_tpu_torch.register_openai_routes(app)
    app.start()
    return app


def recorded(dev) -> list:
    """Record each generation's (prompt ids, output) on ``dev``."""
    generations: list = []
    inner = dev.generate

    def recording_generate(tokens, *args, **kwargs):
        out = inner(tokens, *args, **kwargs)
        generations.append((list(dev._encode(tokens)), out))
        return out

    dev.generate = recording_generate
    return generations


def concurrent_streams(port: int, prompts: list, body: dict) -> tuple:
    """``prompts`` streamed at once -> stream_rate's (tokens/s, TPOT ms, counts)."""
    results, starts = [None] * len(prompts), [None] * len(prompts)

    def run(i):
        starts[i] = time.perf_counter()
        results[i] = post(port, {"prompt": prompts[i], "stream": True, **body}, stream=True)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return stream_rate(starts, results)


def ids_for(dev, generations: list, prompt) -> list:
    want = list(dev._encode(prompt))
    return [out for ids, out in generations if ids == want]


def expected_weight_bytes(cfg, mode) -> int:
    """The served weight bytes reckoned from the model's shapes: bf16
    embeddings and norms; per matmul weight bf16, or int8 values and an f32
    scale a column (int8, w8a8), or two int4 values a byte and an f32 scale a
    column per 128 rows (int4); w8a8 keeps lm_head int8."""
    d, f, kv = cfg.dim, cfg.hidden_dim, cfg.n_kv_heads * cfg.head_dim
    mats = [(d, d), (d, kv), (d, kv), (d, d), (d, f), (d, f), (f, d)]

    def weight(i, o, kind):
        if kind is None:
            return i * o * 2
        if kind == "int4":
            return i * o // 2 + (i // min(128, i)) * o * 4
        return i * o + o * 4

    head = weight(d, cfg.vocab_size, "int8" if mode == "w8a8" else mode)
    return (cfg.vocab_size * d * 2 + d * 2 + head
            + cfg.n_layers * (2 * d * 2 + sum(weight(i, o, mode) for i, o in mats)))


@contextlib.contextmanager
def served(flash, dev, tally: dict, label: str):
    """Counts the forward kernels' launches of the served requests inside
    the block, and only those, into ``tally`` (phase 12's sums: the
    profiling and parity helpers between the requests launch too, and stay
    out), and holds them to the deployment's work: every pool dispatch
    launched the decode variant n_layers x DECODE_CHUNK times, every
    prefill dispatch n_layers forward launches at least outside the pool
    (sm90, or the decode variant for a tail of a few tokens), no call the
    mma kernel. Yields the block's counts, filled when it ends."""
    pool, runner = dev.decode_pool, dev.runner
    n_layers = runner.cfg.n_layers
    pool_idle(pool, label)
    counters = {"all": flash.launches, "sm90": flash.launches_fwd_sm90,
                "decode": flash.launches_fwd_decode}
    before = {k: c.value for k, c in counters.items()}
    d0, p0 = pool.dispatches, runner.prefills
    per_dispatch: list = []
    dispatch = pool._dispatch_chunk

    def counted(*args, **kwargs):
        start = flash.launches_fwd_decode.value
        result = dispatch(*args, **kwargs)
        per_dispatch.append(flash.launches_fwd_decode.value - start)
        return result

    pool._dispatch_chunk = counted
    block: dict = {}
    try:
        yield block
        # a request answered before its slot's last chunk (a cancel) has
        # that chunk dispatched after the answer: it is counted here
        pool_idle(pool, label)
    finally:
        pool._dispatch_chunk = dispatch
    block.update({k: c.value - before[k] for k, c in counters.items()})
    block["mma"] = block.pop("all") - block["sm90"] - block["decode"]
    block["dispatches"], block["prefills"] = pool.dispatches - d0, runner.prefills - p0
    block["in_pool"] = sum(per_dispatch)
    for k in ("sm90", "decode", "mma"):
        tally[k] += block[k]
    check(len(per_dispatch) == block["dispatches"],
          f"{label}: a pool dispatch went around the count")
    check(set(per_dispatch) <= {n_layers * pool.chunk},
          f"{label}: decode launches a pool dispatch {sorted(set(per_dispatch))}, want "
          f"n_layers x DECODE_CHUNK = {n_layers * pool.chunk}")
    outside = block["sm90"] + block["decode"] - block["in_pool"]
    check(outside >= n_layers * block["prefills"],
          f"{label}: a prefill layer missed the forward kernels")
    check(block["mma"] == 0, f"{label}: a served call took the mma kernel")


def pool_idle(pool, label: str) -> None:
    """Wait until no slot of ``pool`` is active: only the worker frees a
    slot, after its last dispatch, so none is in flight from then on."""
    for _ in range(1200):
        if pool.occupancy()["active"] == 0:
            return
        time.sleep(0.05)
    check(False, f"{label}: the pool kept a slot active for 60 s")


def kernel_profile(torch, fn) -> dict:
    """Kernels ``fn`` runs on the card under torch.profiler: name -> (count,
    device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            n, ms = table.get(evt.name, (0, 0.0))
            table[evt.name] = (n + 1, ms + (evt.time_range.end - evt.time_range.start) / 1e3)
    return table


def deployment(torch, flash, card: str, model, ckpt: str) -> dict:
    """Phase 12: phase 5's llama3-8b as deployments run it: quantized
    (int8, int4, w8a8) with the pool, an f8 KV cache, penalties and
    logit_bias, and booted from an HF safetensors checkpoint written into
    the empty directory ``ckpt``."""
    from gofr_tpu_torch.models.quant import quantize_params

    t0 = time.perf_counter()
    for c in (flash.launches, flash.launches_fwd_sm90, flash.launches_fwd_decode):
        c.reset()  # every count to 0 just before the path runs
    tally = {"sm90": 0, "decode": 0, "mma": 0}  # the served requests' launches
    cfg = model.cfg
    prompts4 = [text(300 + i, 120 + 90 * i) for i in range(4)]
    greedy = {"max_tokens": 32, "temperature": 0}
    bf16_bytes = model.weight_bytes()
    check(bf16_bytes == expected_weight_bytes(cfg, None), "deployment: bf16 weight bytes")
    out: dict = {"weight_gb": {"bf16": bf16_bytes / 1e9}, "serve": {}}
    pack_parity(torch, model)
    out["serve"]["bf16"] = serve_streams(torch, flash, card, model, "", prompts4, greedy, tally)
    int8_ids = None
    for mode in QUANT_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        tq = time.perf_counter()
        qmodel = quantize_params(model, mode)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - tq
        nbytes = qmodel.weight_bytes()
        out["weight_gb"][mode] = nbytes / 1e9
        print(f"deployment {mode}: packs built from the bf16 weights in {quant_s:.1f}s, weight "
              f"bytes {nbytes / 1e9:.3f} GB (bf16 {bf16_bytes / 1e9:.3f} GB), memory "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
        check(nbytes == expected_weight_bytes(cfg, mode),
              f"deployment {mode}: weight bytes differ from the shapes' reckoning")
        quant_logits(torch, mode, qmodel, out)
        out["serve"][mode] = serve_streams(torch, flash, card, qmodel, mode, prompts4, greedy,
                                           tally)
        if mode == "int8":
            int8_ids = out["serve"][mode].pop("ids")
            out["f8"] = serve_f8(torch, flash, card, qmodel, tally)
        out["serve"][mode].pop("ids", None)
        del qmodel
    out["serve"]["bf16"].pop("ids", None)
    gc.collect()
    torch.cuda.empty_cache()
    out["penalties"] = penalties(torch, flash, card, model, tally)
    out["model_path"] = from_checkpoint(torch, flash, card, model, prompts4, int8_ids, tally,
                                        ckpt)
    out["sm90"], out["decode"] = tally["sm90"], tally["decode"]
    print(f"deployment: forward launches of the served requests: sm90 {tally['sm90']}, decode "
          f"{tally['decode']}, mma {tally['mma']} (every count since phase 12 began: sm90 "
          f"{flash.launches_fwd_sm90.value}, decode {flash.launches_fwd_decode.value})",
          flush=True)
    check(tally["mma"] == 0 and tally["sm90"] > 0 and tally["decode"] > 0,
          "deployment: the served requests missed the sm90 or decode kernel")
    out["phase_s"] = time.perf_counter() - t0
    print(f"deployment-metrics [{card}]: {json.dumps(out)}", flush=True)
    return out


def pack_parity(torch, model) -> None:
    """The packs built on the card equal the CPU's, which the tests hold bit
    for bit to the JAX package's (layer 0's w_gate, every mode), and w8a8's
    product on the card equals the CPU's at decode's 8 rows (padded to 17
    for ``_int_mm``) and at 64 (unpadded)."""
    from gofr_tpu_torch.models import quant

    w = model.layers[0].w_gate
    packs = {}
    for mode in QUANT_MODES:
        card, host = quant.quantizer_for(mode)(w), quant.quantizer_for(mode)(w.cpu())
        unequal = [k for k in card if not torch.equal(card[k].cpu(), host[k])]
        check(not unequal, f"pack parity {mode}: {unequal} differ between the card and the CPU")
        packs[mode] = card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    worst = {}
    for rows in (8, 64):
        x = torch.randn(rows, w.shape[0], device="cuda", generator=gen).to(w.dtype)
        for mode in QUANT_MODES:
            got = quant.mm(x, packs[mode]).cpu().float()
            want = quant.mm(x.cpu(), {k: t.cpu() for k, t in packs[mode].items()}).float()
            if mode == "w8a8":
                check(torch.equal(got, want), f"pack parity: w8a8 mm at {rows} rows differs")
                continue
            atol, rtol = WEIGHT_ONLY_MM_TOL
            diff = (got - want).abs()
            worst[mode] = max(worst.get(mode, 0.0), float(diff.max()))
            check(bool((diff <= atol + rtol * want.abs()).all()),
                  f"pack parity: {mode} mm at {rows} rows differs from the CPU's beyond "
                  f"{atol} + 2^-7 |y|")
    print(f"deployment: int8/int4/w8a8 packs of a {tuple(w.shape)} weight built on the card "
          "equal the CPU's; w8a8 mm at 8 and 64 rows equal the CPU's bit for bit; int8/int4 mm "
          f"max |diff| {worst} (bound {WEIGHT_ONLY_MM_TOL[0]} + 2^-7 |y|)", flush=True)


def quant_logits(torch, mode: str, qmodel, out: dict) -> None:
    """First-token logits of the quantized model against its dequantized
    twin (a dense bf16 model of the packs' values) on one prompt."""
    import numpy as np

    ids = np.frombuffer(text(299, 100).encode(), np.uint8).astype(np.int64)
    tokens = torch.zeros((1, 128), dtype=torch.int64, device=qmodel.device)
    tokens[0, : ids.size] = torch.from_numpy(ids)
    lengths = torch.tensor([ids.size], dtype=torch.int32, device=qmodel.device)
    got, _ = qmodel.prefill(tokens, qmodel.init_cache(1, 128), lengths)
    deq = qmodel.dequantized()
    want, _ = deq.prefill(tokens, deq.init_cache(1, 128), lengths)
    del deq
    diff = float((got - want).abs().max())
    peak = float(want.abs().max())
    kind, tol = QUANT_LOGIT_TOL[mode]
    bound = tol if kind == "atol" else tol * peak
    same_top = int(got.argmax()) == int(want.argmax())
    print(f"deployment {mode}: first-token logits against the dequantized bf16 model: max |diff| "
          f"{diff:.4e} (bound {bound:.4e}: {kind} {tol}; max |logit| {peak:.3f}), argmax equal "
          f"{same_top} -> {'ok' if diff <= bound else 'FAIL'}", flush=True)
    out.setdefault("logit_max_diff", {})[mode] = diff
    check(diff <= bound, f"deployment {mode}: logits differ from the dequantized model's")


def serve_streams(torch, flash, card: str, model, mode: str, prompts: list, greedy: dict,
                  tally: dict) -> dict:
    """Phase 10's configuration on ``model`` under MODEL_QUANT=``mode``: the
    first prompt alone, then (the prefix cache emptied, so that every
    prompt prefills as it did alone: a prompt whose entry the 4-entry LRU
    dropped would take a partial hit, another computation order) the
    prompts streamed at once (aggregate tokens/s, TPOT); the first
    prompt's ids among the others must equal its ids alone. Both runs
    decode in the pool through the decode variant (``served``)."""
    label = mode or "bf16"
    app = boot_deployment(model, {"MODEL_QUANT": mode})
    try:
        dev = app.container.tpu
        check(dev.runner.model.quant == (mode or None), f"deployment {label}: not {label}")
        generations = recorded(dev)
        with served(flash, dev, tally, f"deployment {label} alone") as one:
            post(app.http_port, {"prompt": prompts[0], **greedy})
        alone = ids_for(dev, generations, prompts[0])[0]
        dev.kv_pool.cache_clear()
        stats = dict(dev.runner.prefix_stats)
        with served(flash, dev, tally, f"deployment {label} streams") as many:
            rate, tpot, counts = concurrent_streams(app.http_port, prompts, greedy)
        check(dev.runner.prefix_stats["misses"] == stats["misses"] + len(prompts),
              f"deployment {label}: a concurrent prompt hit the prefix cache")
        among = ids_for(dev, generations, prompts[0])[-1]
        print(f"deployment {label}: {len(prompts)} concurrent greedy streams ({counts} tokens): "
              f"aggregate {rate:.1f} tokens/s, TPOT {tpot:.2f} ms; served launches alone "
              f"{one}, streams {many}; prompt 0 alone equal to among {len(prompts) - 1} "
              f"co-tenants: {alone == among}", flush=True)
        check(one["dispatches"] > 0 and many["dispatches"] > 0,
              f"deployment {label}: a served request did not decode in the pool")
        check(alone == among, f"deployment {label}: prompt 0 alone gave other ids")
        ids = [ids_for(dev, generations, p)[-1] for p in prompts]
        step = step_profile(torch, model)  # off the served path: not in ``tally``
        print(f"deployment {label}: one decode step of 8 slots (kv_len 300) under "
              f"torch.profiler: {step['launches_a_step']} kernels, "
              f"{step['device_ms_a_step']:.3f} ms of device time", flush=True)
    finally:
        app.shutdown()
    return {"tokens_per_s": rate, "tpot_ms": tpot, "ids": ids, **step}


def step_profile(torch, model) -> dict:
    """Kernels and device time of one decode step over 8 slots of a
    2048-slot bf16 cache at kv_len 300 (the pool's step shape)."""
    tok = torch.randint(0, 200, (8, 1), dtype=torch.int32, device=model.device)
    cache = model.init_cache(8, model.cfg.max_seq)
    cache["lengths"].fill_(min(300, model.cfg.max_seq // 2))
    model.decode_step(tok, cache)  # warm
    table = kernel_profile(torch, lambda: model.decode_step(tok, cache))
    return {"launches_a_step": sum(n for n, _ in table.values()),
            "device_ms_a_step": sum(ms for _, ms in table.values())}


def serve_f8(torch, flash, card: str, qmodel, tally: dict) -> dict:
    """(b): int8 weights with MODEL_KV_DTYPE=f8: the pool's e4m3 cache at
    half the bf16 bytes, 8 streams, n_layers decode launches a step, and
    the upcast's device time a step."""
    app = boot_deployment(qmodel, {"MODEL_QUANT": "int8", "MODEL_KV_DTYPE": "f8"})
    try:
        dev = app.container.tpu
        pool = dev.decode_pool
        k = pool.cache["k"]
        f8_bytes = 2 * k.numel() * k.element_size()
        bf16_bytes = 2 * k.numel() * 2
        print(f"deployment f8: pool cache {k.dtype} {tuple(k.shape)}: {f8_bytes / 1e9:.3f} GB "
              f"(bf16 {bf16_bytes / 1e9:.3f} GB)", flush=True)
        check(str(k.dtype) == f"torch.{F8}" and str(pool.cache["v"].dtype) == f"torch.{F8}",
              "deployment f8: the pool's cache is not e4m3")
        check(2 * f8_bytes == bf16_bytes, "deployment f8: not half the bf16 bytes")
        prompts8 = [text(100 + i, n) for i, n in
                    enumerate((100, 170, 240, 310, 380, 450, 500, 600))]
        with served(flash, dev, tally, "deployment f8") as block:
            rate, tpot, counts = concurrent_streams(app.http_port, prompts8,
                                                    {"max_tokens": 32, "temperature": 0})
        n_layers = dev.runner.cfg.n_layers
        check(block["dispatches"] > 0, "deployment f8: the streams did not decode in the pool")
        a_step = block["in_pool"] / (block["dispatches"] * pool.chunk)
        print(f"deployment f8: 8 concurrent greedy streams ({counts} tokens): aggregate "
              f"{rate:.1f} tokens/s, TPOT {tpot:.2f} ms; decode launches {a_step} a step "
              f"(n_layers {n_layers})", flush=True)
        check(a_step == n_layers, "deployment f8: not n_layers decode launches a step")
        upcast = upcast_ms(torch, dev.runner.model)  # off the served path
    finally:
        app.shutdown()
    return {"tokens_per_s": rate, "tpot_ms": tpot, "cache_gb": f8_bytes / 1e9,
            "cache_gb_bf16": bf16_bytes / 1e9, "decode_launches_a_step": a_step, **upcast}


def upcast_ms(torch, model) -> dict:
    """The f8 cache's upcast to bf16 at the attention boundary, device time
    a decode step (torch.profiler): the conversion kernels of one step over
    8 slots of a 2048-slot e4m3 cache, against the same step on a bf16 cache."""
    import numpy as np

    tok = torch.randint(0, 200, (8, 1), dtype=torch.int32, device=model.device)
    rows = {}
    for dtype in (torch.float8_e4m3fn, torch.bfloat16):
        cache = model.init_cache(8, model.cfg.max_seq, dtype)
        cache["lengths"].copy_(torch.tensor([137, 410, 655, 900, 1530, 2000, 1200, 800],
                                            dtype=torch.int32) % model.cfg.max_seq)
        model.decode_step(tok, cache)  # warm
        table = kernel_profile(torch, lambda c=cache: model.decode_step(tok, c))
        convert = {n: v for n, v in table.items() if "copy" in n.lower()}
        rows[str(dtype).replace("torch.", "")] = {
            "step_device_ms": sum(ms for _, ms in table.values()),
            "copy_kernels": sum(n for n, _ in convert.values()),
            "copy_ms": sum(ms for _, ms in convert.values()),
        }
        del cache
    f8, bf = rows["float8_e4m3fn"], rows["bfloat16"]
    upcast = f8["copy_ms"] - bf["copy_ms"]
    print(f"deployment f8: one decode step (8 slots, kv_lens 137..2000) device time "
          f"{f8['step_device_ms']:.3f} ms on e4m3 against {bf['step_device_ms']:.3f} ms on bf16; "
          f"copy/convert kernels {f8['copy_kernels']} ({f8['copy_ms']:.3f} ms) against "
          f"{bf['copy_kernels']} ({bf['copy_ms']:.3f} ms): the upcast {upcast:.3f} ms a step",
          flush=True)
    check(np.isfinite(upcast) and f8["copy_kernels"] > bf["copy_kernels"],
          "deployment f8: no upcast kernels in the e4m3 step")
    return {"upcast_ms_a_step": upcast, "step_device_ms_f8": f8["step_device_ms"],
            "step_device_ms_bf16": bf["step_device_ms"]}


def penalties(torch, flash, card: str, model, tally: dict) -> dict:
    """(c): penalties and logit_bias on the bf16 model, the pool eager.
    The HTTP requests are the served path (``served``); the solo run they
    are held against and the launch profile are not."""
    from gofr_tpu_torch.ops.sampling import Sampler

    app = boot_deployment(model, {"DECODE_POOL_PENALTIES": "eager"})
    try:
        dev = app.container.tpu
        pool, port = dev.decode_pool, app.http_port
        check(pool._pen_ready, "penalties: the eager pool has no penalty state")
        generations = recorded(dev)
        prompt = text(400, 200)
        body = {"prompt": prompt, "max_tokens": 16, "temperature": 0}

        def ids(extra: dict) -> list:
            with served(flash, dev, tally, f"penalties {sorted(extra)}"):
                status, data, _, _ = post(port, {**body, **extra})
            check(status == 200, f"penalties: {status} {data}")
            return generations[-1][1]

        plain = ids({})
        forced_id = 4242 % dev.runner.cfg.vocab_size
        forced = ids({"logit_bias": {str(forced_id): 100}})
        banned = ids({"logit_bias": {str(plain[0]): -100}})
        print(f"penalties: plain {plain[:8]}...; logit_bias +100 on {forced_id} -> {forced[:8]}...;"
              f" -100 on {plain[0]} -> {banned[:8]}...", flush=True)
        check(forced == [forced_id] * len(forced) and len(forced) == 16,
              "penalties: +100 did not force its id at every step")
        check(plain[0] not in banned, "penalties: -100 did not ban the id")
        knobs = {"repetition_penalty": 1.3, "frequency_penalty": 1.0}
        rejects0 = dict(pool.rejects)
        d0 = pool.dispatches
        pooled = ids(knobs)
        check(pool.dispatches > d0 and pool.rejects == rejects0,
              "penalties: the penalized request did not pool")
        state_ids = dev.tokenizer.encode(prompt)
        solo = dev.runner.generate(state_ids, 16, sampler=Sampler(**knobs),
                                   stop_tokens=dev.default_stop_ids, decode_pool=None,
                                   prefill_batcher=dev.batcher)
        print(f"penalties: repetition 1.3 + frequency 1.0 pooled {pooled[:8]}... solo "
              f"{solo[:8]}... equal {pooled == solo}; differs from plain {pooled != plain}",
              flush=True)
        check(pooled == solo, "penalties: pooled and solo penalized ids differ")
        # a plain co-tenant beside a penalized one keeps its ids
        results: dict = {}

        def run(key, extra):
            status, _, _, _ = post(port, {**body, "prompt": prompt, **extra})
            results[key] = status

        threads = [threading.Thread(target=run, args=("plain", {})),
                   threading.Thread(target=run, args=("pen", knobs))]
        n0 = len(generations)
        with served(flash, dev, tally, "penalties co-tenants"):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        outs = [o for _, o in generations[n0:]]
        check(len(outs) == 2 and plain in outs and pooled in outs,
              f"penalties: co-tenants gave other ids ({outs})")
        print("penalties: a plain co-tenant beside a penalized one kept its ids; so did the "
              "penalized one", flush=True)
        # an out-of-vocab logit_bias is a 400 before the stream commits
        with served(flash, dev, tally, "penalties out-of-vocab") as refused:
            status, data, _, _ = post(port, {**body, "stream": True,
                                             "logit_bias": {str(dev.runner.cfg.vocab_size): 1}},
                                      stream=True)
        check(refused["prefills"] == 0 and refused["decode"] == 0,
              "penalties: the out-of-vocab request ran the model")
        check(status == 400, f"penalties: out-of-vocab logit_bias streamed {status}")
        print(f"penalties: an out-of-vocab logit_bias id on a stream -> {status} before the "
              "stream", flush=True)
        # launches a step of the penalized chunk against the plain chunk
        launches = penalized_launches(torch, dev.runner.model)
    finally:
        app.shutdown()
    return launches


def penalized_launches(torch, model) -> dict:
    """Kernels a decode step launches in the pool's chunk (8 slots, 8
    steps), plain and penalized (identity knobs on half the rows)."""
    dev = model.device
    tok = torch.randint(0, 200, (8, 1), dtype=torch.int32, device=dev)
    v = model.cfg.vocab_size
    rows = {}
    for kind in ("plain", "penalized"):
        cache = model.init_cache(8, model.cfg.max_seq)
        cache["lengths"].fill_(min(300, model.cfg.max_seq // 2))
        if kind == "plain":
            def fn(c=cache):
                model.decode_chunk_pool(tok, c, 8, None, 0.0, 0, 1.0, 0.0, all_greedy=True)
        else:
            pres = torch.zeros((8, v), dtype=torch.bool, device=dev)
            cnts = torch.zeros((8, v), device=dev)
            bias = torch.zeros((8, v), device=dev)
            rep = torch.tensor([1.3, 1.0] * 4, device=dev)
            pp = torch.zeros(8, device=dev)
            fp = torch.tensor([1.0, 0.0] * 4, device=dev)

            def fn(c=cache):
                model.decode_chunk_pool_penalized(tok, c, 8, None, 0.0, 0, 1.0, 0.0, pres, rep,
                                                  cnts, pp, fp, bias, all_greedy=True)
        fn()
        table = kernel_profile(torch, fn)
        rows[kind] = {"launches_a_step": sum(n for n, _ in table.values()) / 8,
                      "device_ms_a_step": sum(ms for _, ms in table.values()) / 8}
        del cache
    print(f"penalties: pool chunk (8 slots x 8 steps) kernels a step plain "
          f"{rows['plain']['launches_a_step']:.1f} ({rows['plain']['device_ms_a_step']:.3f} ms "
          f"device), penalized {rows['penalized']['launches_a_step']:.1f} "
          f"({rows['penalized']['device_ms_a_step']:.3f} ms device)", flush=True)
    return rows


def write_checkpoint(torch, model, path: str, layers_per_shard: int = 8) -> int:
    """An HF-layout safetensors checkpoint of ``model`` (bf16, [out, in]
    matmul weights) in shards of ``layers_per_shard`` layers with
    ``model.safetensors.index.json`` and a ``generation_config.json``
    listing EOS_IDS. The format: a little-endian u64 header length, the
    JSON header (names sorted, offsets into the data), the raw bytes.
    Returns the bytes written."""
    from gofr_tpu_torch.models.ingest import _LAYER_MAP

    def shard_tensors(lo: int, hi: int) -> dict:
        out = {}
        if lo == 0:
            out["model.embed_tokens.weight"] = model.embed
            out["model.norm.weight"] = model.norm_f
            out["lm_head.weight"] = model.lm_head.T
        for i in range(lo, hi):
            block = model.layers[i]
            for ours, (suffix, transpose) in _LAYER_MAP.items():
                t = getattr(block, ours)
                out[f"model.layers.{i}.{suffix}"] = t.T if transpose else t
        return out

    n, total, weight_map = model.cfg.n_layers, 0, {}
    bounds = list(range(0, n, layers_per_shard))
    for k, lo in enumerate(bounds):
        name = f"model-{k + 1:05d}-of-{len(bounds):05d}.safetensors"
        tensors = shard_tensors(lo, min(lo + layers_per_shard, n))
        header, offset = {}, 0
        for key in sorted(tensors):
            t = tensors[key]
            nbytes = t.numel() * t.element_size()
            header[key] = {"dtype": "BF16", "shape": list(t.shape),
                           "data_offsets": [offset, offset + nbytes]}
            offset += nbytes
            weight_map[key] = name
        raw = json.dumps(header, separators=(",", ":")).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(path, name), "wb") as f:
            f.write(len(raw).to_bytes(8, "little"))
            f.write(raw)
            for key in sorted(tensors):
                host = tensors[key].contiguous().cpu()
                f.write(host.view(torch.uint8).numpy().data)
        total += 8 + len(raw) + offset
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"bos_token_id": 128000, "eos_token_id": list(EOS_IDS)}, f)
    return total


def from_checkpoint(torch, flash, card: str, model, prompts: list, int8_ids: list,
                    tally: dict, path: str) -> dict:
    """(d): phase 5's weights written as a sharded HF checkpoint into the
    empty directory ``path`` (kept for phase 13's draft; the caller deletes
    it), a device booted through MODEL_PATH with MODEL_QUANT=int8: every
    tensor equal to (a)'s int8 packs, the same greedy ids, both EOS ids
    default stops."""
    from gofr_tpu_torch.tpu import device as device_mod

    free = shutil.disk_usage(path).free
    t = time.perf_counter()
    nbytes = write_checkpoint(torch, model, path)
    write_s = time.perf_counter() - t
    print(f"model_path: wrote {nbytes / 1e9:.2f} GB in {len(os.listdir(path)) - 2} shards "
          f"under {path} in {write_s:.1f}s ({free / 1e9:.1f} GB were free there)", flush=True)
    loads: list = []
    load_model = device_mod.load_model

    def timed_load(*args, **kwargs):
        t = time.perf_counter()
        loaded = load_model(*args, **kwargs)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t)
        return loaded

    device_mod.load_model = timed_load
    try:
        app = boot_deployment(None, {"MODEL_PATH": path, "MODEL_QUANT": "int8"})
    finally:
        device_mod.load_model = load_model
    try:
        dev = app.container.tpu
        load_s = loads[0]
        print(f"model_path: booted through MODEL_PATH with MODEL_QUANT=int8: load "
              f"{load_s:.2f}s, {nbytes / 1e9 / load_s:.2f} GB/s ({dev.describe()})", flush=True)
        check(dev.default_stop_ids == frozenset(EOS_IDS),
              f"model_path: default stops {dev.default_stop_ids}, want {EOS_IDS}")
        want = model.quantized("int8").state_dict()
        got = dev.runner.model.state_dict()
        check(got.keys() == want.keys(), "model_path: the loaded model's tensors differ")
        unequal = [k for k in want if not torch.equal(got[k], want[k])]
        print(f"model_path: {len(want)} tensors, bit-equal to (a)'s int8 packs: "
              f"{not unequal} {unequal[:3]}", flush=True)
        check(not unequal, "model_path: a loaded tensor differs from (a)'s int8 pack")
        del want, got
        generations = recorded(dev)
        for prompt, ids in zip(prompts, int8_ids):
            with served(flash, dev, tally, "model_path"):
                status, _, _, _ = post(app.http_port, {"prompt": prompt, "max_tokens": 32,
                                                       "temperature": 0})
            check(status == 200, f"model_path: {status}")
            cut = next((i for i, t in enumerate(ids) if t in EOS_IDS), len(ids))
            check(generations[-1][1] == ids[:cut],
                  "model_path: greedy ids differ from (a)'s int8 model")
        print(f"model_path: greedy ids of {len(prompts)} prompts equal (a)'s int8 model's; "
              f"default stops {sorted(dev.default_stop_ids)}", flush=True)
    finally:
        app.shutdown()
    return {"checkpoint_gb": nbytes / 1e9, "write_s": write_s, "load_s": load_s,
            "load_gb_per_s": nbytes / 1e9 / load_s, "free_gb": free / 1e9}


def pool_decode_kernel(torch, flash, gen) -> dict:
    """The pool's decode shape against its plain version, and its times:
    B = 8 slots of a 2048-slot cache, ragged kv_lens, two idle slots past
    the cache end (the kernel stops at Skv). Then 20 launches, each
    followed by a synchronize: a fault of this shape surfaces here, at its
    own launch, not in a later phase."""
    lens = [137, 410, 655, 900, 1530, 2047, 2300, 4096]
    case = make_case(torch, gen, 8, 1, 2048, 32, 8, 128, torch.bfloat16,
                     [n - 1 for n in lens], lens)
    check(flash.fwd_decode_splits(8, 8, 2048) == 5, "pool decode: not 5 splits")
    _, _, err = compare(torch, flash, "pool decode bf16 B=8 cache 2048 ragged, idle past the end",
                        case)
    row = time_shape(torch, flash, "pool decode B=8", case, 50)
    q, k, v, offs, lens_ = case
    for _ in range(20):
        flash.flash_attention_fwd(q, k, v, True, offs, lens_)
        torch.cuda.synchronize()
    print("pool decode B=8: 20 launches, a synchronize after each -> ok", flush=True)
    return {**row, "max_abs_err": err}


# -- phase 13: speculation ---------------------------------------------------------

# a divergence from plain greedy is allowed only where the plain path's
# top-2 f32 logits at that step are this close (a share of |max logit|):
# the verify's products run at [B, width] shapes, plain decode's at [B, 1]
NEAR_TIE = 2e-2
# the pool's ragged lengths before a verify: live rows, one ending at the
# cache end with width 5, two idle slots rolled back to 0 by a spec cycle
VERIFY_LENGTHS = [137, 410, 655, 900, 1530, 2043, 0, 0]


def verify_case(torch, gen, sq, lengths, max_seq=2048, layers=2):
    """A target verify's attention call: q [B, Sq, 32, 128] bf16 at each
    row's offset = its cache length, K/V the last layer of a [layers, B,
    max_seq, 8, 128] cache written up to kv_len = length + Sq, NaN past it."""
    dev, bf16, b = "cuda", torch.bfloat16, len(lengths)
    q = torch.randn(b, sq, 32, 128, device=dev, generator=gen).to(bf16)
    shape = (layers, b, max_seq, 8, 128)
    caches = [torch.randn(shape, device=dev, generator=gen).to(bf16) for _ in "kv"]
    for cache in caches:
        for i, n in enumerate(lengths):
            cache[:, i, n + sq:] = float("nan")
    offs = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, caches[0][-1], caches[1][-1], offs, offs + sq


def verify_kernels(torch, flash, gen) -> tuple:
    """The forward at the verify shapes against its plain version, with
    its route, device time, bound and SDPA's time: the pool's [8, w] verify
    over a 2048-slot cache at each width of SPEC_K_MAX=4's ladder, and the
    solo verify of DRAFT_TOKENS=4 (k + 1 = 5) at kv_len 1800.
    -> (max errors by variant, timing rows by name)."""
    errs = {"decode": [], "mma": []}
    cases = {f"verify B=8 Sq={w}": verify_case(torch, gen, w, VERIFY_LENGTHS) for w in (2, 4, 5)}
    cases["verify B=1 Sq=5 kv_len 1800"] = verify_case(torch, gen, 5, [1795])
    rows = {}
    for name, case in cases.items():
        out, _, _ = compare(torch, flash, name, case, errs=errs)
        check_tail_invisible(torch, flash, name, case, out)
        rows[name] = time_shape(torch, flash, name, case, 50, device=True)
    check([rows[f"verify B=8 Sq={w}"]["variant"] for w in (2, 4, 5)] == ["decode", "decode", "mma"],
          "verify: widths 2 and 4 must take the decode route, 5 the mma route")
    return errs, rows


def first_divergence(runner, prompt_ids: list, plain: list, other: list, label: str) -> dict:
    """``other`` against ``plain`` under the near-tie rule: equal ids, or,
    at the first position where they part, a plain path whose top-2 f32
    logits there (teacher-forced: the prompt's prefill, then decode steps
    on the plain ids) differ by less than NEAR_TIE x |max logit|. Prints
    every divergence, its gap, and the plain path's logit of the id taken
    here; a wider gap fails the run. Past the first divergence the contexts
    differ, so nothing further is compared."""
    import numpy as np
    import torch

    n = min(len(plain), len(other))
    j = next((i for i in range(n) if plain[i] != other[i]), None)
    if j is None and len(plain) == len(other):
        return {"diverged": False}
    if j is None:
        j = n  # one stopped (a stop token, unemitted) where the other went on
    with torch.no_grad():
        state = prefill_like_generate(runner, np.asarray(prompt_ids, np.int32))
        logits, cache = state["logits"].float()[None], state["cache"]
        tok = torch.zeros((1, 1), dtype=torch.int32, device=runner.device)
        for t in plain[:j]:
            tok.fill_(t)
            logits, cache = runner.model.decode_step(tok, cache)
        row = logits[0].float()
        top = torch.topk(row, 2).values.tolist()
        taken = float(row[other[j]]) if j < len(other) else None
    gap, limit = top[0] - top[1], NEAR_TIE * abs(top[0])
    at = lambda ids: ids[j] if j < len(ids) else "a stop"  # noqa: E731
    print(f"{label}: ids part at position {j} ({at(plain)} plain, {at(other)} here): the plain "
          f"path's top-2 logits {top[0]:.4f} / {top[1]:.4f}, gap {gap:.4f} against "
          f"{NEAR_TIE} x |max| = {limit:.4f}, its logit of the id taken here {taken} -> "
          f"{'near tie' if gap < limit else 'FAIL'}", flush=True)
    check(gap < limit, f"{label}: the ids part where the plain path has no near tie")
    return {"diverged": True, "position": j, "gap": gap, "limit": limit, "taken_logit": taken}


def prefill_like_generate(runner, ids):
    """The prompt's prefill by the route ``generate`` takes it (no prefix
    cache): sliced through the largest bucket, or the PREFILL_CHUNK_TOKENS
    one, when longer; else a batched prefill at its bucket (``run_batch``
    alone would keep only the last bucket's worth of a longer prompt)."""
    chunk_b = runner.prefill_chunk_bucket
    if ids.size > runner.buckets[-1] or (chunk_b is not None and ids.size > chunk_b):
        width = runner.buckets[-1] if chunk_b is None else min(runner.buckets[-1], chunk_b)
        return runner._chunked_prefill(ids, bucket=width)
    return runner.run_batch([ids])[0]


def solo_streams(port: int, prompts: list, body: dict) -> tuple:
    """``prompts`` streamed one at a time -> (mean TPOT ms, ids counts)."""
    tpots, counts = [], []
    for prompt in prompts:
        _, tpot, count = concurrent_streams(port, [prompt], body)
        tpots.append(tpot)
        counts += count
    return sum(tpots) / len(tpots), counts


def pooled_prompts() -> list:
    """Prompts that repeat a passage (edits and summaries: the traffic
    prompt-lookup drafting serves)."""
    passages = [text(500 + i, 120 + 20 * i) for i in range(8)]
    return [f"{p} | again: {p} | and again: {p[:60]}" for p in passages]


def verify_route(flash, cfg, width: int) -> str:
    """The forward's route for a bf16 verify of ``width`` tokens: the
    decode variant while width x groups fits one m16 tile (up to 4 at
    llama3-8b's groups of 4), else mma."""
    return "decode" if width * (cfg.n_heads // cfg.n_kv_heads) <= flash.FWD_DECODE_ROWS else "mma"


def verifies_of(flash, cfg, width: int, calls: int) -> dict:
    """``served_spec``'s verifies for ``calls`` verifies of ``width``:
    n_layers launches each, all on the width's route."""
    row = {"calls": calls, "decode": 0, "mma": 0}
    row[verify_route(flash, cfg, width)] = cfg.n_layers * calls
    return {width: row}


def spec_tally() -> dict:
    """Phase 13's launch counts of served requests: verifies by width
    (calls, decode-route and mma-route launches), draft-chunk, plain-chunk
    and prefill launches."""
    return {"verify": {}, "draft": 0, "plain": 0, "prefill_sm90": 0, "prefill_decode": 0}


@contextlib.contextmanager
def served_spec(flash, dev, tally: dict, label: str):
    """Phase 13's ``served``: counts the forward's launches of the served
    requests inside the block, and only those (the plain baselines, the
    near-tie reference and the boot warm-ups stay out), into ``tally`` by
    what launched them: the target's verifies by width, the draft's
    chunks, the pool's plain chunks, and the rest (the prefills). Holds
    each call to its work: a verify of width w launches the forward
    n_layers times, all on w's route (``verify_route``); a draft chunk the
    decode variant n_layers x k times; a plain pool chunk n_layers x
    DECODE_CHUNK times; the rest is prefill, n_layers launches a prefill
    at least (sm90, or the decode variant for a tail of a few tokens) and
    no mma. A prefill on another thread during a pool call adds only sm90
    launches (buckets >= 64): those stay the prefills'. Yields the block's
    verifies by width, drafts, plain chunks and prefills, filled when it
    ends."""
    runner, pool = dev.runner, dev.decode_pool
    cfg = runner.cfg
    counters = {"all": flash.launches, "sm90": flash.launches_fwd_sm90,
                "decode": flash.launches_fwd_decode}

    def snap() -> dict:
        n = {k: c.value for k, c in counters.items()}
        n["mma"] = n.pop("all") - n["sm90"] - n["decode"]
        return n

    calls: list = []  # (kind, width, launches by route)
    wrapped: list = []

    def wrap(obj, name: str, kind: str) -> None:
        fn = getattr(obj, name)

        def counted(*args, **kwargs):
            before = snap()
            result = fn(*args, **kwargs)
            after = snap()
            width = args[0].shape[1] if kind == "verify" else None
            calls.append((kind, width, {k: after[k] - before[k] for k in after}))
            return result

        wrapped.append((obj, name, fn if name in vars(obj) else None))
        setattr(obj, name, counted)

    if pool is not None:
        pool_idle(pool, label)
        wrap(pool, "_dispatch_chunk", "plain")
    for name in ("verify_chunk", "verify_chunk_sampled"):
        wrap(runner.model, name, "verify")
    if runner.spec is not None:
        for name in ("propose", "propose_sampled"):
            wrap(runner.spec, name, "draft")
    before, p0 = snap(), runner.prefills
    block: dict = {}
    try:
        yield block
        if pool is not None:
            # a cancelled row's last chunk is dispatched after its answer
            pool_idle(pool, label)
    finally:
        for obj, name, fn in wrapped:
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)
    total = {k: v - before[k] for k, v in snap().items()}
    verifies: dict = {}
    for kind, w, n in calls:
        if kind == "verify":
            route = verify_route(flash, cfg, w)
            other = "mma" if route == "decode" else "decode"
            check(n[route] == cfg.n_layers and n[other] == 0,
                  f"{label}: a verify of width {w} launched {n}, want n_layers = "
                  f"{cfg.n_layers} on the {route} route")
            row = verifies.setdefault(w, {"calls": 0, "decode": 0, "mma": 0})
            row["calls"] += 1
            row[route] += n[route]
        elif kind == "draft":
            want = runner.spec.cfg.n_layers * runner.spec.k
            check(n["decode"] == want and n["mma"] == n["sm90"] == 0,
                  f"{label}: a draft chunk launched {n}, want n_layers x k = {want} decode")
        else:
            check(n["decode"] == cfg.n_layers * pool.chunk and n["mma"] == 0,
                  f"{label}: a plain pool chunk launched {n}, want n_layers x DECODE_CHUNK = "
                  f"{cfg.n_layers * pool.chunk} decode")
    by_kind = {kind: sum(n["decode"] for k, _, n in calls if k == kind)
               for kind in ("draft", "plain")}
    rest = {"sm90": total["sm90"],
            "decode": total["decode"] - sum(n["decode"] for _, _, n in calls),
            "mma": total["mma"] - sum(n["mma"] for _, _, n in calls)}
    prefills = runner.prefills - p0
    check(rest["mma"] == 0, f"{label}: a served prefill took the mma kernel")
    check(prefills > 0 and rest["sm90"] + rest["decode"] >= cfg.n_layers * prefills,
          f"{label}: a prefill layer missed the forward kernels")
    for w, row in verifies.items():
        t = tally["verify"].setdefault(w, {"calls": 0, "decode": 0, "mma": 0})
        for k in t:
            t[k] += row[k]
    tally["draft"] += by_kind["draft"]
    tally["plain"] += by_kind["plain"]
    tally["prefill_sm90"] += rest["sm90"]
    tally["prefill_decode"] += rest["decode"]
    block.update(verifies=verifies, prefills=prefills, launches=total,
                 drafts=sum(k == "draft" for k, _, _ in calls),
                 plain=sum(k == "plain" for k, _, _ in calls))


def spec_solo(torch, flash, card: str, model, ckpt: str, body: dict, out: dict,
              tally: dict) -> None:
    """The solo latency mode against plain solo decode on the same weights:
    the checkpoint draft (then unseeded sampling) and the seeded draft.
    Each served request's launches go into ``tally`` (``served_spec``):
    every greedy cycle one draft chunk and one verify of k + 1 = 5 on the
    mma route."""
    solo_prompts = [text(400 + i, 150 + 60 * i) for i in range(4)]
    app = boot_deployment(model, {"DECODE_POOL": "off"})
    try:
        dev = app.container.tpu
        generations = recorded(dev)
        plain_tpot, _ = solo_streams(app.http_port, solo_prompts, body)
        plain_ids = [ids_for(dev, generations, p)[-1] for p in solo_prompts]
    finally:
        app.shutdown()
    print(f"spec solo: plain solo decode TPOT {plain_tpot:.2f} ms over {len(solo_prompts)} "
          f"requests of 32 tokens", flush=True)
    out["solo"] = {"plain_tpot_ms": plain_tpot}
    for label, env in (("checkpoint draft", {"DRAFT_MODEL_PATH": ckpt}), ("seeded draft", {})):
        tb = time.perf_counter()
        app = boot_deployment(model, {"DECODE_POOL": "off", "DRAFT_TOKENS": "4", **env,
                                      "DRAFT_MODEL_NAME": PHASE10_ENV["MODEL_NAME"]})
        try:
            dev = app.container.tpu
            runner = dev.runner
            check(runner.spec is not None and runner.spec.k == 4, f"spec solo {label}: no draft")
            print(f"spec solo {label}: booted in {time.perf_counter() - tb:.1f}s "
                  f"({dev.describe()}), memory {torch.cuda.memory_allocated() / 2**30:.1f} GiB",
                  flush=True)
            generations = recorded(dev)
            s0 = dict(runner.spec_stats)
            with served_spec(flash, dev, tally, f"spec solo {label}") as block:
                tpot, counts = solo_streams(app.http_port, solo_prompts, body)
            stats = {k: runner.spec_stats[k] - s0[k] for k in s0}
            check(stats["cycles"] > 0, f"spec solo {label}: no spec cycle ran")
            check(block["drafts"] == stats["cycles"] and block["verifies"] == verifies_of(
                      flash, runner.cfg, 5, stats["cycles"]),
                  f"spec solo {label}: verifies {block['verifies']} and {block['drafts']} draft "
                  f"chunks, want one each a cycle ({stats['cycles']}), of width 5")
            divergences = [
                first_divergence(runner, list(dev._encode(p)), want,
                                 ids_for(dev, generations, p)[-1], f"spec solo {label}")
                for p, want in zip(solo_prompts, plain_ids)
            ]
            tokens = sum(c - 1 for c in counts)
            row = {**stats, "accept_rate": stats["accepted"] / stats["drafted"],
                   "tokens_per_verify": tokens / stats["cycles"], "tpot_ms": tpot,
                   "plain_tpot_ms": plain_tpot, "divergences": divergences,
                   "launches": block["launches"]}
            print(f"spec solo {label}: {stats['cycles']} cycles, {stats['drafted']} drafted, "
                  f"{stats['accepted']} accepted ({row['accept_rate']:.3f}), "
                  f"{row['tokens_per_verify']:.2f} tokens a verify; TPOT {tpot:.2f} ms beside "
                  f"plain solo {plain_tpot:.2f} ms; ids equal to plain solo's or near ties; "
                  f"served launches {block['launches']}", flush=True)
            if label == "checkpoint draft":
                check(row["accept_rate"] > 0.5, f"spec solo {label}: the target's own weights "
                      f"accepted {row['accept_rate']:.3f} of their drafts")
                out["sampled"] = spec_sampled(flash, app, dev, generations, solo_prompts[:2],
                                              tally)
            out["solo"][label] = row
        finally:
            app.shutdown()
            gc.collect()
            torch.cuda.empty_cache()


def spec_sampled(flash, app, dev, generations: list, prompts: list, tally: dict) -> dict:
    """Unseeded speculative sampling at temperature 0.8: valid ids, the
    acceptance rate; each cycle one draft chunk and one verify of k = 4
    (k - 1 drafts tested) on the decode route."""
    runner = dev.runner
    s0 = dict(runner.spec_stats)
    sampled = []
    with served_spec(flash, dev, tally, "spec sampled") as block:
        for p in prompts:
            status, _, _, _ = post(app.http_port, {"prompt": p, "max_tokens": 32,
                                                   "temperature": 0.8})
            check(status == 200, f"spec sampled: {status}")
            sampled.append(ids_for(dev, generations, p)[-1])
    vocab = runner.cfg.vocab_size
    check(all(ids and all(0 <= t < vocab for t in ids) for ids in sampled),
          "spec sampled: invalid ids")
    st = {k: runner.spec_stats[k] - s0[k] for k in s0}
    check(st["cycles"] > 0, "spec sampled: no spec cycle ran")
    check(block["drafts"] == st["cycles"]
          and block["verifies"] == verifies_of(flash, runner.cfg, 4, st["cycles"]),
          f"spec sampled: verifies {block['verifies']} and {block['drafts']} draft chunks, want "
          f"one each a cycle ({st['cycles']}), of width 4")
    row = {**st, "accept_rate": st["accepted"] / st["drafted"], "tokens": [len(x) for x in sampled]}
    print(f"spec sampled (temperature 0.8, unseeded, checkpoint draft): {st['cycles']} cycles, "
          f"acceptance {row['accept_rate']:.3f} ({st['accepted']} of {st['drafted']}), ids "
          f"valid: {row['tokens']} tokens", flush=True)
    return row


@contextlib.contextmanager
def answers_in_context(pool, answers: dict):
    """Each pooled request's draft context starts with ``answers[its prompt
    ids]`` (the prompt, then the plain pool's ids for it) ahead of the
    prompt itself, as in an edit whose answer the prompt holds: the n-gram
    drafter then proposes the plain continuation, 4 tokens a cycle, and
    the pool verifies at width 5. Output never depends on the drafts."""
    arm = pool._spec_arm

    def seeded(spec_ctx, *args):
        state = arm(spec_ctx, *args)
        if state is not None:
            state.draft.context[:0] = answers[tuple(int(t) for t in spec_ctx)]
        return state

    pool._spec_arm = seeded
    try:
        yield
    finally:
        pool._spec_arm = arm


def spec_pooled(torch, flash, model, body: dict, out: dict, tally: dict) -> None:
    """Pooled n-gram speculation against the plain pool on the same weights
    (phase 10's configuration), 1, 4 and 8 concurrent streams: ids, verify
    dispatches and drafts, acceptance, tokens a row a verify, tokens/s and
    TPOT; each served request's launches go into ``tally``
    (``served_spec``). Random weights' output repeats in short cycles, so
    its own n-gram drafts stay under 4 tokens; then 8 streams whose draft
    contexts hold the plain pool's answer (``answers_in_context``) verify
    at width 5, the ladder's widest rung (the mma route), which must run."""
    prompts = pooled_prompts()
    plain: dict = {}
    app = boot_deployment(model, {})
    try:
        dev = app.container.tpu
        generations = recorded(dev)
        for k in (1, 4, 8):
            rate, tpot, _ = concurrent_streams(app.http_port, prompts[:k], body)
            plain[k] = (rate, tpot, [ids_for(dev, generations, p)[-1] for p in prompts[:k]])
        answers = {tuple(dev._encode(p)): list(dev._encode(p)) + ids
                   for p, ids in zip(prompts, plain[8][2])}
    finally:
        app.shutdown()
    app = boot_deployment(model, {"SPEC_POOLED": "on", "SPEC_K_MAX": "4"})
    try:
        dev = app.container.tpu
        pool, runner = dev.decode_pool, dev.runner
        check(pool.spec_cfg is not None and pool.spec_cfg.k_max == 4, "spec pool: not armed")
        generations = recorded(dev)
        pooled: dict = {}
        runs = [(f"{k} streams", k, contextlib.nullcontext()) for k in (1, 4, 8)]
        runs.append(("8 streams, answer in context", 8, answers_in_context(pool, answers)))
        for name, k, drafts in runs:
            label = f"spec pool {name}"
            s0 = {**pool.spec_stats, "widths": dict(pool.spec_stats["widths"])}
            d0 = pool.dispatches
            with drafts, served_spec(flash, dev, tally, label) as block:
                rate, tpot, _ = concurrent_streams(app.http_port, prompts[:k], body)
            st = {key: pool.spec_stats[key] - s0[key]
                  for key in ("cycles", "rows", "drafted", "accepted", "emitted")}
            widths = {w: n - s0["widths"].get(w, 0) for w, n in pool.spec_stats["widths"].items()}
            check({w: v["calls"] for w, v in block["verifies"].items()}
                  == {w: n for w, n in widths.items() if n}
                  and block["plain"] == pool.dispatches - d0,
                  f"{label}: verifies {block['verifies']} and {block['plain']} plain chunks "
                  f"counted, the pool ran {widths} and {pool.dispatches - d0}")
            divergences = [
                first_divergence(runner, list(dev._encode(p)), want,
                                 ids_for(dev, generations, p)[-1], label)
                for p, want in zip(prompts[:k], plain[k][2])
            ]
            pooled[name] = {**st, "plain_chunks": block["plain"], "verifies": block["verifies"],
                            "accept_rate": st["accepted"] / max(st["drafted"], 1),
                            "tokens_per_row_verify": st["emitted"] / max(st["rows"], 1),
                            "tokens_per_s": rate, "tpot_ms": tpot,
                            "plain_tokens_per_s": plain[k][0], "plain_tpot_ms": plain[k][1],
                            "divergences": divergences, "launches": block["launches"]}
            print(f"{label}: {st['cycles']} verify dispatches ({st['rows']} rows), "
                  f"{block['plain']} plain chunks, accepted/drafted {st['accepted']}/"
                  f"{st['drafted']} ({pooled[name]['accept_rate']:.3f}), "
                  f"{pooled[name]['tokens_per_row_verify']:.2f} tokens a row a verify, verifies "
                  f"by width {block['verifies']}; aggregate {rate:.1f} tokens/s, TPOT "
                  f"{tpot:.2f} ms beside the plain pool's {plain[k][0]:.1f} tokens/s, "
                  f"{plain[k][1]:.2f} ms; served launches {block['launches']}", flush=True)
        ngram = [pooled[f"{k} streams"] for k in (1, 4, 8)]
        check(sum(r["cycles"] for r in ngram) > 0 and sum(r["drafted"] for r in ngram) > 0,
              "spec pool: no verify cycle or no draft")
        widest = pooled["8 streams, answer in context"]["verifies"].get(5, {"calls": 0})
        check(widest["calls"] > 0, "spec pool: no verify of width 5 ran with the answer in "
              "context")
        out["by_streams"] = pooled
    finally:
        app.shutdown()


def spec_tiny_f32(torch, flash) -> dict:
    """The tiny f32 model on the card, pooled speculation against the plain
    pool and the solo draft mode (the target as its own draft) against
    plain solo: at f32 the ids must be equal exactly, so what the bf16
    near-tie rule lets pass cannot hide a fault of the pool's logic."""
    from gofr_tpu_torch.models.llama import TINY
    from gofr_tpu_torch.models.transformer import Transformer

    from gofr_tpu_torch.training import checkpoint

    tiny = Transformer.random(TINY, PHASE10_ENV["TORCH_DEVICE"], seed=0)
    draft_dir = tempfile.mkdtemp(prefix="gofr_tiny_")
    checkpoint.save_params(draft_dir, tiny.state_dict())  # the target as its own draft
    env = {"MODEL_NAME": "tiny", "MODEL_MAX_SEQ": "128", "MODEL_BUCKETS": "64",
           "PREFILL_CHUNK_TOKENS": "0", "PREFIX_CACHE": "0"}
    body = {"max_tokens": 24, "temperature": 0}
    prompts = [text(600 + i, 14 + 3 * i) for i in range(8)]
    prompts = [f"{p}|{p}|{p[:8]}" for p in prompts]
    ids: dict = {}
    for label, extra in (("plain", {}), ("spec", {"SPEC_POOLED": "on", "SPEC_K_MAX": "4"}),
                         ("solo", {"DECODE_POOL": "off"}),
                         ("solo spec", {"DECODE_POOL": "off", "DRAFT_MODEL_NAME": "tiny",
                                        "DRAFT_MODEL_PATH": draft_dir, "DRAFT_TOKENS": "4"})):
        try:
            app = boot_deployment(tiny, {**env, **extra})
        finally:
            if label == "solo spec":
                shutil.rmtree(draft_dir, ignore_errors=True)
        try:
            dev = app.container.tpu
            generations = recorded(dev)
            if label.startswith("solo"):
                solo_streams(app.http_port, prompts, body)
            else:
                concurrent_streams(app.http_port, prompts, body)
            ids[label] = [ids_for(dev, generations, p)[-1] for p in prompts]
            if label == "spec":
                st = dev.decode_pool.spec_stats
                check(st["cycles"] > 0 and st["accepted"] > 0, f"tiny f32 spec pool: {st}")
            if label == "solo spec":
                st = dev.runner.spec_stats
                check(st["cycles"] > 0 and st["accepted"] == st["drafted"],
                      f"tiny f32 solo spec: {st}")
        finally:
            app.shutdown()
    check(ids["spec"] == ids["plain"], "tiny f32: pooled speculation's ids differ from the "
          "plain pool's")
    check(ids["solo spec"] == ids["solo"], "tiny f32: the solo draft mode's ids differ from "
          "plain solo decode's")
    print("spec tiny f32 on the card: 8 concurrent streams pooled with speculation and the "
          "solo draft mode give the plain pool's and plain solo's ids exactly -> ok", flush=True)
    return {"streams": len(prompts), "tokens": [len(x) for x in ids["spec"]]}


def speculation(torch, flash, card: str, model, ckpt: str, gen) -> dict:
    """Phase 13: speculative decoding on phase 5's llama3-8b in phase 10's
    configuration: the forward at the verify shapes; the tiny f32 model's
    pooled and solo speculation, ids exactly; the solo latency mode
    (DECODE_POOL=off, DRAFT_MODEL_NAME=llama3-8b, DRAFT_TOKENS=4) with the
    target's own weights from phase 12's checkpoint as DRAFT_MODEL_PATH
    (acceptance near k-1 a cycle) and with the seeded draft (near 0),
    greedy ids against plain solo's, then unseeded sampling; pooled n-gram
    speculation (SPEC_POOLED=on, SPEC_K_MAX=4) at 1, 4 and 8 streams of
    prompts that repeat a passage, then 8 with the answer in the draft
    context (width 5), ids against the plain pool's. The launch counts are
    those of the served speculative requests alone (``served_spec``)."""
    t0 = time.perf_counter()
    errs, rows = verify_kernels(torch, flash, gen)
    out: dict = {"kernel_rows": rows, "tiny_f32": spec_tiny_f32(torch, flash)}
    gc.collect()
    torch.cuda.empty_cache()
    body = {"max_tokens": 32, "temperature": 0}
    tallies = {"solo": spec_tally(), "pool": spec_tally()}
    spec_solo(torch, flash, card, model, ckpt, body, out, tallies["solo"])
    pooled: dict = {}
    spec_pooled(torch, flash, model, body, pooled, tallies["pool"])
    out["pooled"] = pooled
    out["tallies"] = tallies
    n_layers = model.cfg.n_layers
    for mode, t in tallies.items():
        for w, n in sorted(t["verify"].items()):
            print(f"spec {mode}: width {w}: {n['calls']} verifies, {n['decode']} decode-route and "
                  f"{n['mma']} mma-route launches ({verify_route(flash, model.cfg, w)} route, "
                  f"{n_layers} a verify)", flush=True)
    verify = [n for t in tallies.values() for n in t["verify"].values()]
    out["launches"] = {
        "verify_decode": sum(n["decode"] for n in verify),
        "verify_mma": sum(n["mma"] for n in verify),
        "pool_width_5": tallies["pool"]["verify"].get(5, {}).get("mma", 0),
        "draft": tallies["solo"]["draft"],
        "plain": tallies["pool"]["plain"],
        "prefill_sm90": sum(t["prefill_sm90"] for t in tallies.values()),
        "prefill_decode": sum(t["prefill_decode"] for t in tallies.values()),
    }
    out["max_abs_err"] = {k: max(v) for k, v in errs.items()}
    print(f"spec: forward launches of the served speculative requests {out['launches']}",
          flush=True)
    check(all(out["launches"][k] > 0 for k in ("verify_decode", "verify_mma", "pool_width_5",
                                               "draft", "prefill_sm90")),
          "spec: a forward route of the phase never ran")
    out["phase_s"] = time.perf_counter() - t0
    print(f"spec-metrics [{card}]: {json.dumps(out)}", flush=True)
    return out


# -- phase 14: multi-LoRA --------------------------------------------------------

# rank 8 over all eight keys of llama3-8b: (in + out) x 8 for each of 7 x 32
# layer weights and the lm_head (4096 + 128256)
LORA_RANK, LORA_ALPHA, LORA_LR = 8, 16.0, 1e-2
LORA_PARAMS = 22_030_336
LORA_STEPS = 4
LORA_SEQ = 2049  # phase 9's crops: the model sees 2048
MIXED_MODELS = (None, "calm", "wild", None, "calm", "wild", None, "calm")


def host_snapshot(model) -> list:
    """Every tensor of ``model`` (parameters and packs) copied to the host."""
    return [t.detach().to("cpu") for t in (*model.parameters(), *model.buffers())]


def unchanged(torch, model, snap: list) -> bool:
    tensors = [*model.parameters(), *model.buffers()]
    return len(tensors) == len(snap) and all(
        torch.equal(t.detach().to("cpu"), s) for t, s in zip(tensors, snap))


def lora_train(torch, flash, card: str, base, name: str, seed: int, path: str) -> dict:
    """``make_lora_train_step`` over ``base`` (bf16, or int8 packs: QLoRA)
    at phase 9's shape: rank 8, alpha 16, remat, batch 1 of 2049-token crops
    of a seeded corpus, LORA_STEPS steps; the adapter exported to ``path``
    with ``save_params(path, export_adapter(state))``. Every forward, dQ and
    dK/dV call on sm90, finite losses, the base bit-identical, the
    optimizer's state the adapters' alone."""
    import numpy as np

    from gofr_tpu_torch.models import lora
    from gofr_tpu_torch.training import trainer
    from gofr_tpu_torch.training.checkpoint import save_params
    from gofr_tpu_torch.training.data import TokenDataset

    cfg = base.cfg
    snap = host_snapshot(base)
    wrapped = lora.add_lora(base, seed=seed, rank=LORA_RANK, alpha=LORA_ALPHA)
    opt = trainer.default_optimizer(LORA_LR)
    state = lora.init_lora_train_state(wrapped, opt)
    step = lora.make_lora_train_step(cfg, opt, remat=True)
    adapters = state["adapters"]
    mu = state["opt_state"][1]["mu"]
    n_adapter = sum(p.numel() for p in adapters)
    check(n_adapter == LORA_PARAMS, f"lora {name}: {n_adapter} adapter parameters")
    check(len(mu) == len(adapters) == 2 * (7 * cfg.n_layers + 1)
          and all(m.shape == p.shape for m, p in zip(mu, adapters)),
          f"lora {name}: the optimizer holds more than the adapters")
    corpus = np.random.default_rng(seed).integers(0, cfg.vocab_size, 1 << 20, dtype=np.uint32)
    batch = torch.as_tensor(
        TokenDataset(corpus, seq_len=LORA_SEQ, batch_size=1, seed=seed).batch(0),
        device=base.device)
    torch.cuda.synchronize()
    before_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    counters = (flash.launches, flash.launches_dq, flash.launches_dkv,
                flash.launches_fwd_sm90, flash.launches_dq_sm90, flash.launches_dkv_sm90)
    losses, times, totals = [], [], [0] * 6
    for i in range(LORA_STEPS):
        for c in counters:
            c.reset()
        t = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        counts = [c.value for c in counters]
        totals = [a + b for a, b in zip(totals, counts)]
        losses.append(loss)
        print(f"lora train {name} step {i + 1}: loss {loss:.4f} grad_norm "
              f"{float(m['grad_norm']):.4f} {times[-1] * 1e3:.1f} ms, launches "
              f"fwd/dq/dkv/fwd sm90/dq sm90/dkv sm90 {counts}", flush=True)
        check(counts[1] >= cfg.n_layers and counts[2] >= cfg.n_layers
              and counts[0] >= 2 * cfg.n_layers, f"lora {name}: a layer's attention missed a kernel")
        check(counts[3] == counts[0] and counts[4] == counts[1] and counts[5] == counts[2],
              f"lora {name}: a forward, dQ or dK/dV call missed its sm90 variant")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)), f"lora {name}: a non-finite loss")
    moved = max(float(w.lora_b.detach().abs().max()) for _, _, w in lora.wrapped_weights(wrapped))
    check(moved > 0, f"lora {name}: B never moved off zero")
    check(unchanged(torch, base, snap), f"lora {name}: a base tensor changed")
    save_params(path, lora.export_adapter(state))
    # the adapter optimizer's update alone (clipped AdamW, one tensor at a
    # time) on copies of the adapters: its kernels, device ms and wall ms
    copies = [p.detach().clone() for p in adapters]
    grads = [torch.full_like(p, 1e-3) for p in copies]
    opt_copy = trainer.default_optimizer(LORA_LR)
    opt_state = opt_copy.init(copies)
    table = kernel_profile(torch, lambda: opt_copy.update(grads, opt_state, copies))
    torch.cuda.synchronize()
    t = time.perf_counter()
    opt_copy.update(grads, opt_state, copies)
    torch.cuda.synchronize()
    optimizer = {"kernels": sum(n for n, _ in table.values()),
                 "device_ms": sum(ms for _, ms in table.values()),
                 "wall_ms": (time.perf_counter() - t) * 1e3}
    del copies, grads, opt_state
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    out = {"base": base.quant or "bf16", "step_ms": step_s * 1e3, "step_ms_all":
           [t * 1e3 for t in times], "tokens_per_s": (LORA_SEQ - 1) / step_s, "peak_memory_gib": peak,
           "memory_before_gib": before_gib, "losses": losses, "adapter_params": n_adapter,
           "adapter_tensors": len(adapters), "max_abs_b": moved, "optimizer": optimizer,
           "launches": dict(zip(("fwd", "dq", "dkv", "fwd_sm90", "dq_sm90", "dkv_sm90"),
                                totals))}
    print(f"lora-train-metrics {name} [{card}]: {json.dumps(out)}", flush=True)
    del state, wrapped, snap
    return out


def mixed_streams(port: int, prompts: list, models: tuple, body: dict) -> tuple:
    """``prompts`` streamed at once, stream i under ``models[i]`` (None: the
    base; the adapters by ``model``, or by ``adapter`` for odd i) ->
    stream_rate's (tokens/s, TPOT ms, counts)."""
    results, starts = [None] * len(prompts), [None] * len(prompts)

    def run(i):
        extra = {}
        if models[i] is not None:
            extra = {"model" if i % 2 == 0 else "adapter": models[i]}
        starts[i] = time.perf_counter()
        results[i] = post(port, {"prompt": prompts[i], "stream": True, **body, **extra},
                          stream=True)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return stream_rate(starts, results)


def pool_step_profile(torch, model, stack) -> dict:
    """One decode step of 8 slots of a 2048-slot cache (phase 13's ragged
    lengths): the plain model's, and the bank's with slot 0 on adapter 1
    (its rows gathered once, as a chunk does): kernel launches under
    torch.profiler and device time by ``graph_ms``."""
    from gofr_tpu_torch.models.lora import attach_lora_ids
    from gofr_tpu_torch.timing import graph_ms

    dev = model.device
    cache = model.init_cache(8, 2048)
    cache["lengths"].copy_(torch.tensor([137, 410, 655, 900, 1530, 1800, 300, 50],
                                        dtype=torch.int32, device=dev))
    tok = torch.ones((8, 1), dtype=torch.int32, device=dev)
    ids = torch.tensor([1, 0, 0, 0, 0, 0, 0, 0], device=dev)
    rows = attach_lora_ids(stack, ids)
    out = {}
    with torch.no_grad():
        for label, m in (("base", model), ("adapter_slot", rows)):
            table = kernel_profile(torch, lambda m=m: m.decode_step(tok, cache))
            out[label] = {"launches": sum(n for n, _ in table.values()),
                          "graph_ms": graph_ms(lambda m=m: m.decode_step(tok, cache), launches=5)}
        gather = kernel_profile(torch, lambda: attach_lora_ids(stack, ids))
        out["gather_launches"] = sum(n for n, _ in gather.values())
    return out


def lora_serve(torch, flash, card: str, model, paths: dict) -> tuple:
    """Phase 14's serving half: phase 10's configuration with
    LORA_ADAPTERS=calm=...,wild=... on phase 5's weights. -> (metrics, what
    the merged-weights check needs: the adapter models, ids, scores)."""
    from gofr_tpu_torch.models import lora
    from gofr_tpu_torch.training.checkpoint import restore_params

    out: dict = {}
    spec = ",".join(f"{n}={p}" for n, p in paths.items())
    app = boot_deployment(model, {"LORA_ADAPTERS": spec, "ADMIN_TOKEN": "phase14"})
    keep: dict = {}
    try:
        dev = app.container.tpu
        pool, port, n_layers = dev.decode_pool, app.http_port, model.cfg.n_layers
        check(sorted(dev.list_adapters()) == ["calm", "wild"] and pool._lora_ready,
              "lora: the adapters or their bank did not load")
        generations = recorded(dev)
        prompts = [text(700 + i, 150 + 40 * i) for i in range(8)]
        greedy = {"max_tokens": 32, "temperature": 0}
        tally = {"sm90": 0, "decode": 0, "mma": 0}
        # greedy requests: the base, "model": "calm", "adapter": "wild"
        ids: dict = {}
        with served(flash, dev, tally, "lora greedy"):
            for label, extra in ((None, {}), ("calm", {"model": "calm"}),
                                 ("wild", {"adapter": "wild"})):
                status, data, _, _ = post(port, {"prompt": prompts[0], **greedy, **extra})
                check(status == 200 and data["model"] == (label or "llama3-8b"),
                      f"lora greedy {label}: {status} {data.get('model')}")
                ids[label] = generations[-1][1]
        check(ids["calm"] != ids[None] or ids["wild"] != ids[None],
              "lora: neither adapter changed the base's ids")
        out["differs_from_base"] = {n: ids[n] != ids[None] for n in ("calm", "wild")}
        # 8 concurrent streams mixing base, calm and wild, then 8 base-only
        mixed: list = []
        dispatch = pool._dispatch_chunk

        def seen(*args, **kwargs):
            mixed.append((pool._chunk_lora is not None, len(pool._lora_slots), len(pool._active)))
            return dispatch(*args, **kwargs)

        pool._dispatch_chunk = seen
        lora_before = pool.lora_chunks
        try:
            with served(flash, dev, tally, "lora mixed"):
                rate, tpot, counts = mixed_streams(port, prompts, MIXED_MODELS, greedy)
        finally:
            pool._dispatch_chunk = dispatch
        out["mixed"] = {"tokens_per_s": rate, "tpot_ms": tpot, "tokens": counts,
                        "lora_chunks": pool.lora_chunks - lora_before,
                        "mixed_chunks": sum(1 for lo, n, a in mixed if lo and 0 < n < a),
                        "dispatches": len(mixed)}
        check(out["mixed"]["lora_chunks"] > 0, "lora: no adapter chunk ran")
        check(out["mixed"]["mixed_chunks"] > 0, "lora: adapter and base slots never shared a chunk")
        with served(flash, dev, tally, "lora base-only"):
            rate, tpot, counts = concurrent_streams(port, prompts, greedy)
        out["base_only"] = {"tokens_per_s": rate, "tpot_ms": tpot, "tokens": counts}
        print(f"lora: 8 mixed streams {out['mixed']['tokens_per_s']:.1f} tokens/s TPOT "
              f"{out['mixed']['tpot_ms']:.2f} ms ({out['mixed']['lora_chunks']} adapter chunks, "
              f"{out['mixed']['mixed_chunks']} with base rows), 8 base-only "
              f"{rate:.1f} tokens/s TPOT {tpot:.2f} ms [{card}]", flush=True)
        out["served"] = dict(tally)
        check(tally["mma"] == 0 and tally["sm90"] > 0 and tally["decode"] > 0,
              "lora: the served requests missed the sm90 or decode kernel")
        out["step"] = pool_step_profile(torch, model, pool._lora_model)
        print(f"lora: one pool step of 8 slots {json.dumps(out['step'])} [{card}]", flush=True)
        # an adapter's own device memory against the shapes' reckoning
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        probe = lora.apply_adapter(model, restore_params(paths["calm"], model.device))
        torch.cuda.synchronize()
        added = torch.cuda.memory_allocated() - m0
        del probe
        reckoned = LORA_PARAMS * 2
        out["adapter_bytes"] = {"added": added, "reckoned": reckoned,
                                "bank_bytes": sum(t.numel() * t.element_size()
                                                  for t in pool._lora_model.buffers()
                                                  if t is not model.freqs)}
        print(f"lora: loading an adapter added {added / 1e6:.2f} MB of device memory, "
              f"reckoned {reckoned / 1e6:.2f} MB (rank {LORA_RANK}, eight keys); the bank "
              f"{out['adapter_bytes']['bank_bytes'] / 1e6:.2f} MB", flush=True)
        check(reckoned <= added <= reckoned + (1 << 20), "lora: an adapter is not its own bytes")
        out.update(lora_admin(torch, dev, port, paths, prompts))
        # echo + logprobs scoring under calm, and the base's, for the merged check
        score_ids = list(dev.tokenizer.encode(prompts[1]))
        scored = {}
        for label, extra in (("calm", {"adapter": "calm"}), (None, {})):
            status, data, _, _ = post(port, {"prompt": score_ids, "max_tokens": 0, "echo": True,
                                             "logprobs": 1, **extra})
            check(status == 200, f"lora scoring {label}: {status}")
            scored[label] = data["choices"][0]["logprobs"]["token_logprobs"][1:]
        check(scored["calm"] != scored[None], "lora: scoring under calm equals the base's")
        keep = {"adapters": dict(dev.runner.adapters), "prompt_ids": list(
            dev.tokenizer.encode(prompts[0])), "ids": ids, "score_ids": score_ids,
            "scored": scored["calm"]}
    finally:
        app.shutdown()
    return out, keep


def lora_admin(torch, dev, port: int, paths: dict, prompts: list) -> dict:
    """The admin surface under ADMIN_TOKEN during adapter traffic (the
    bank's deferred swap), /v1/models, an unknown adapter's 400, and the
    pool's rejects of a penalized adapter request and of a penalized
    request beside a live adapter slot."""
    pool = dev.decode_pool
    auth = {"Authorization": "Bearer phase14"}

    def admin(method: str, route: str, body=None, headers=auth):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request(method, route, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json", **headers})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        conn.close()
        return resp.status, data

    out: dict = {}
    check(admin("GET", "/admin/adapters", headers={})[0] == 401, "lora admin: no 401")
    # a long adapter stream holds a slot while the third adapter loads
    result: list = []
    long = threading.Thread(target=lambda: result.append(post(
        port, {"prompt": prompts[2], "max_tokens": 256, "temperature": 0, "adapter": "calm",
               "stream": True}, stream=True)))
    long.start()
    for _ in range(600):
        if pool.occupancy()["lora_slots"]:
            break
        time.sleep(0.01)
    check(pool.occupancy()["lora_slots"] > 0, "lora admin: the adapter stream never pooled")
    t = time.perf_counter()
    status, data = admin("POST", "/admin/adapters", {"name": "third", "path": paths["calm"]})
    out["load_ms"] = (time.perf_counter() - t) * 1e3
    deferred = pool._lora_pending is not None
    check(status == 200 and data["data"]["adapters"] == ["calm", "third", "wild"],
          f"lora admin: load {status} {data}")
    check(deferred, "lora admin: the bank swapped under a live adapter slot")
    # the penalized request beside the live adapter slot: adapter_mix, solo
    rejects = dict(pool.occupancy()["rejects"])
    status, _, _, _ = post(port, {"prompt": prompts[3], "max_tokens": 16, "temperature": 0,
                                  "repetition_penalty": 1.3})
    check(status == 200, f"lora: penalized request {status}")
    long.join(timeout=600)
    check(result and result[0][0] == 200, "lora admin: the adapter stream failed")
    pool_idle(pool, "lora admin")
    check(pool._lora_pending is None and "third" in pool._lora_index,
          "lora admin: the deferred bank never installed")
    status, data = admin("GET", "/admin/adapters")
    check(data["data"]["adapters"] == ["calm", "third", "wild"], f"lora admin: list {data}")
    status, data = admin("DELETE", "/admin/adapters/third")
    check(status == 200 and data["data"]["adapters"] == ["calm", "wild"],
          f"lora admin: unload {status} {data}")
    status, data, _, _ = post(port, {"prompt": prompts[4], "max_tokens": 16, "temperature": 0,
                                     "adapter": "calm", "repetition_penalty": 1.3})
    check(status == 200, f"lora: penalized adapter request {status}")
    after = pool.occupancy()["rejects"]
    out["rejects"] = {k: after.get(k, 0) - rejects.get(k, 0)
                      for k in ("adapter_mix", "penalized_adapter")}
    check(out["rejects"]["adapter_mix"] >= 1 and out["rejects"]["penalized_adapter"] >= 1,
          f"lora: the pool's rejects {out['rejects']}")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/v1/models")
    models = [m["id"] for m in json.loads(conn.getresponse().read())["data"]]
    conn.close()
    check(models == ["llama3-8b", "calm", "wild"], f"lora: /v1/models {models}")
    status, _, _, _ = post(port, {"prompt": prompts[0], "max_tokens": 4, "adapter": "ghost"})
    check(status == 400, f"lora: an unknown adapter gave {status}")
    out["deferred_swap"] = deferred
    print(f"lora admin: third adapter loaded in {out['load_ms']:.0f} ms during a live adapter "
          f"slot (deferred swap), listed, unloaded; /v1/models {models}; pool rejects "
          f"{out['rejects']}", flush=True)
    return out


def lora_merged(torch, keep: dict) -> dict:
    """Each adapter's pooled greedy ids against a plain ``generate`` (solo)
    on ``merge_lora`` weights under the near-tie rule, and calm's echo
    scoring against the merged weights' within phase 10's tolerance."""
    import numpy as np

    from gofr_tpu_torch.models import lora

    out: dict = {}
    for name in ("calm", "wild"):
        merged = lora.merge_lora(keep["adapters"][name])
        app = boot_deployment(merged, {"DECODE_POOL": "off", "KV_PAGED": "off",
                                       "PREFIX_CACHE": "0"})
        try:
            dev = app.container.tpu
            plain = dev.generate(keep["prompt_ids"], 32)
            out[name] = first_divergence(dev.runner, keep["prompt_ids"], plain,
                                         keep["ids"][name], f"lora {name} vs merged")
            if name == "calm":
                want = np.asarray(dev.score(keep["score_ids"]))
                got = np.asarray(keep["scored"])
                err = float(np.abs(got - want).max())
                atol, rtol = POOL_LP_TOL
                check(bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want))),
                      f"lora: calm's scoring against the merged weights' (max err {err})")
                out["score_max_abs_err"] = err
        finally:
            app.shutdown()
        del merged, app
        gc.collect()
        torch.cuda.empty_cache()
    print(f"lora: pooled ids against the merged weights' {json.dumps(out)}", flush=True)
    return out


def multi_lora(torch, flash, card: str, model) -> dict:
    """Phase 14: LoRA on phase 5's llama3-8b: two adapters trained on the
    card (calm over the bf16 base, wild as QLoRA over its int8 packs),
    exported, then served over the shared base in phase 10's configuration
    with the admin surface."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="gofr_lora_")
    out: dict = {}
    try:
        paths = {"calm": os.path.join(tmp, "calm"), "wild": os.path.join(tmp, "wild")}
        out["train"] = {"calm": lora_train(torch, flash, card, model, "calm", 1, paths["calm"])}
        gc.collect()
        torch.cuda.empty_cache()
        qmodel = model.quantized("int8")
        out["train"]["wild"] = lora_train(torch, flash, card, qmodel, "wild", 2, paths["wild"])
        del qmodel
        gc.collect()
        torch.cuda.empty_cache()
        for c in (flash.launches, flash.launches_fwd_sm90, flash.launches_fwd_decode):
            c.reset()  # every count to 0 just before the served path runs
        served_out, keep = lora_serve(torch, flash, card, model, paths)
        out.update(served_out)
        gc.collect()
        torch.cuda.empty_cache()
        out["merged"] = lora_merged(torch, keep)
        del keep
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"lora-metrics [{card}]: {json.dumps(out)}", flush=True)
    return out


# -- phase 16: host services ---------------------------------------------------------

ECHO_PROMPT = "host services, echo"
ECHO_SCHEDULE = "3,1,0,2"


@contextlib.contextmanager
def environment(env: dict):
    """Exactly ``env`` of the port's settings for the block (the keys
    earlier phases set are cleared), every key restored after: nothing
    leaks in from an earlier phase or out to a later one."""
    from gofr_tpu_torch.config import DECLARED_KEYS, UNHONORED_KEYS

    keys = set(DECLARED_KEYS) | set(UNHONORED_KEYS) | set(env)
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def host_services(torch, flash, card: str, model) -> dict:
    """Phase 16 (after phase 14, on phase 5's model): TPU_BOOT=background
    readiness from the moment the server listens, with the kernels'
    library unloaded first so the boot loads it; the echo runner under
    SPEC_POOLED with a SPEC_FAKE_ACCEPT schedule; /favicon.ico and
    /.well-known/ready; a refused key stopping the boot."""
    import gofr_tpu_torch
    from gofr_tpu_torch.tpu.device import TPUDevice

    t0 = time.perf_counter()
    out: dict = {}
    stages: list = []
    progress = TPUDevice._boot_progress

    def recording_progress(self, detail, **kw):
        stages.append(detail)
        progress(self, detail, **kw)

    builds = {"loads": 0}
    build = flash.build

    def counted_build():
        if flash._built is None:
            builds["loads"] += 1  # a real build or load, not the cached library
        return build()

    env = {"MODEL_NAME": "llama3-8b", "MODEL_MAX_SEQ": "2048", "BATCH_MAX_SIZE": "4",
           "BATCH_TIMEOUT_MS": "50", "TOKENIZER": "byte", "DECODE_CHUNK": "8",
           "TORCH_DEVICE": "cuda", "DECODE_POOL": "off", "KV_PAGED": "off",
           "TPU_BOOT": "background", "HTTP_PORT": str(free_port())}
    TPUDevice._boot_progress = recording_progress
    flash.build = counted_build
    flash._built = None  # the boot must load the library, as a fresh process does
    try:
        with environment(env):
            app = gofr_tpu_torch.new(model=model)
        gofr_tpu_torch.register_openai_routes(app)
        app.start()
        try:
            port = app.http_port
            seen = []
            deadline = time.perf_counter() + 300
            while True:
                check(time.perf_counter() < deadline, "host: the background boot never ended")
                status, _, body = get_raw(port, "/.well-known/ready")
                seen.append((status, json.loads(body)))
                if status == 200:
                    break
                check(status == 503 and seen[-1][1]["state"] in ("booting", "warming"),
                      f"host: readiness {status} {seen[-1][1]} during the boot")
                time.sleep(0.005)
            warming = [b["detail"] for st, b in seen if st == 503 and b.get("detail")]
            print(f"host: background boot, readiness polled {len(seen)} times: "
                  f"{len(warming)} x 503 with a stage ({sorted(set(warming))[:4]}...), then "
                  f"200 {seen[-1][1]}; stages {stages}; library loads in the boot "
                  f"{builds['loads']}", flush=True)
            check(warming, "host: no 503 with a stage before the 200")
            check(any("CUDA kernels" in d for d in stages) and builds["loads"] == 1,
                  "host: the boot did not build the kernels' library")
            loads = builds["loads"]
            status, data, first_s, _ = post(port, {"prompt": ECHO_PROMPT, "max_tokens": 8,
                                                   "temperature": 0})
            check(status == 200 and data["usage"]["completion_tokens"] >= 1,
                  f"host: first request after ready: {status} {data}")
            check(builds["loads"] == loads, "host: the first request after 200 built the kernels")
            print(f"host: first request after ready in {first_s * 1e3:.1f} ms, no build",
                  flush=True)
            out["background_first_request_ms"] = first_s * 1e3
            out["readiness_503s"] = len(warming)
        finally:
            app.shutdown()
    finally:
        TPUDevice._boot_progress = progress
        flash.build = build

    # the echo runner: pooled speculation on the scripted source; no card
    echo_env = {"MODEL_NAME": "echo", "TOKENIZER": "byte", "SPEC_POOLED": "on",
                "SPEC_FAKE_ACCEPT": ECHO_SCHEDULE, "HTTP_PORT": str(free_port())}
    with environment(echo_env):
        app = gofr_tpu_torch.new()
    gofr_tpu_torch.register_openai_routes(app)
    app.start()
    try:
        port, dev = app.http_port, app.container.tpu
        check(dev.device is None, "host: the echo runner took a device")
        n = 40
        status, data, _, _ = post(port, {"prompt": ECHO_PROMPT, "max_tokens": n})
        want = (ECHO_PROMPT * 3)[:n]
        got = data["choices"][0]["text"] if status == 200 else None
        stats = dict(dev.runner.spec_stats)
        print(f"host: echo, SPEC_FAKE_ACCEPT={ECHO_SCHEDULE}: {n} ids the prompt's cycle: "
              f"{got == want}; spec {stats}", flush=True)
        check(got == want, f"host: echo gave {got!r}, want {want!r}")
        check(stats["cycles"] > 0 and stats["accepted"] > 0 and stats["drafted"] > stats["accepted"],
              "host: the scripted schedule accepted and rejected nothing")
        status, headers, icon = get_raw(port, "/favicon.ico")
        check(status == 200 and headers.get("Content-Type") == "image/x-icon"
              and len(icon) == 1150 and icon[:4] == b"\x00\x00\x01\x00",
              f"host: /favicon.ico {status} {len(icon)} bytes")
        status, _, body = get_raw(port, "/.well-known/ready")
        check(status == 200 and json.loads(body)["state"] == "ready",
              f"host: echo readiness {status} {body}")
        out["echo_spec"] = stats
    finally:
        app.shutdown()

    # a key the port refuses stops the boot with its name
    with environment({"MODEL_NAME": "echo", "TPU_MESH": "tp=2"}):
        try:
            gofr_tpu_torch.new()
            refused = ""
        except ValueError as exc:
            refused = str(exc)
    print(f"host: TPU_MESH=tp=2 refused: {refused}", flush=True)
    check("TPU_MESH" in refused, "host: TPU_MESH did not stop the boot")
    out["phase_s"] = time.perf_counter() - t0
    print(f"host-metrics [{card}]: {json.dumps(out)}", flush=True)
    check(out["phase_s"] < 60, f"host: phase 16 took {out['phase_s']:.1f}s")
    return out


# -- phase 17: observability -----------------------------------------------------------

# PERF.md §6's predictions for PR 12 (H100 80GB HBM3, 700 W)
PREDICTED = {"decode_mbu": (0.09, 0.11), "decode_mbu_device": 0.51, "prefill_mfu": 0.57}
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# the traffic's sizes in bytes (one token a byte): the single stream's and
# the 8 streams' prompts
# (one bucket, one prefill cohort), the long prompt (3 slices of the chunk
# bucket) and the full batch's prompts (the largest bucket)
OBS_SIZES = {"one": 120, "streams": (300, 25), "long": 1500, "full": 512, "slices": 3}


def admin(port: int, path: str):
    status, data = get_json(port, path)
    check(status == 200, f"obs: GET {path}: HTTP {status} {data}")
    return data["data"]


def marked_chunks(pool) -> tuple:
    """Wrap the pool's chunk (on this instance, for the profiled window
    only: the package has no such hook) so each dispatch first launches a
    one-cycle ``torch.cuda._sleep`` marker on the pool's thread: in the
    trace, the worker's launches between two markers are one chunk's.
    -> (the dispatch ids in order, the restore)."""
    import torch

    ids: list = []
    run = pool._run_executable

    def marked():
        drec = pool._pending_drec
        ids.append(drec.dispatch_id if drec is not None else 0)
        torch.cuda._sleep(1)
        return run()

    pool._run_executable = marked
    return ids, lambda: vars(pool).pop("_run_executable", None)


def chunk_kernel_us(trace_path: str, ids: list) -> tuple:
    """A Chrome trace -> ({dispatch id: the chunk's kernel microseconds},
    busy microseconds of every kernel, the window from the first kernel's
    start to the last one's end). A chunk's kernels are those whose launch
    (a runtime event, by correlation id) the pool's thread made between its
    marker's launch and the next marker's."""
    with open(trace_path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    check(kernels, "obs: the trace holds no kernel (CUDA activity not recorded)")
    by_corr = {e.get("args", {}).get("correlation"): e for e in kernels}
    marker_corrs = {c for c, e in by_corr.items() if "spin" in e["name"]}
    if len(marker_corrs) != len(ids):
        names: dict = {}
        for e in kernels:
            names[e["name"][:60]] = names.get(e["name"][:60], 0) + 1
        print("obs: kernels in the trace " + json.dumps(sorted(names.items(),
              key=lambda kv: -kv[1])[:12]), flush=True)
    check(len(marker_corrs) == len(ids),
          f"obs: {len(marker_corrs)} chunk markers in the trace, {len(ids)} chunks dispatched")
    launches = sorted((e for e in events if e.get("cat") in RUNTIME_CATS
                       and e.get("args", {}).get("correlation") in by_corr),
                      key=lambda e: e["ts"])
    worker = {e["tid"] for e in launches if e["args"]["correlation"] in marker_corrs}
    check(len(worker) == 1, f"obs: the markers came from threads {worker}")
    per_chunk: dict = {}
    k = -1
    for e in launches:
        if e["tid"] not in worker:
            continue
        corr = e["args"]["correlation"]
        if corr in marker_corrs:
            k += 1
            per_chunk[ids[k]] = 0.0
        elif k >= 0:
            per_chunk[ids[k]] += by_corr[corr]["dur"]
    busy = sum(e["dur"] for e in kernels)
    window = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    return per_chunk, busy, window


def timeline_idle(pool, timeline) -> None:
    """Wait until no pool slot is active and no dispatch record is open:
    the chunks the worker dispatched ahead are fetched and closed too."""
    pool_idle(pool, "obs")
    for _ in range(1200):
        if timeline.stats()["in_flight"] == 0:
            return
        time.sleep(0.05)
    check(False, "obs: a dispatch record stayed open for 60 s")


def concurrent_posts(port: int, bodies: list) -> list:
    results = [None] * len(bodies)

    def run(i):
        results[i] = post(port, bodies[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for status, data, _, _ in results:
        check(status == 200, f"obs: {status} {data}")
    return results


def observability(torch, flash, card: str, model) -> dict:
    """Phase 17 (after phase 16, on phase 5's model): the flight recorder,
    the dispatch timeline, the engine state and watchdog, the cost model,
    the profiler and the MFU / MBU gauges in phase 10's configuration."""
    import numpy as np

    import gofr_tpu_torch
    from gofr_tpu_torch.tpu.costcal import fit, join_records

    t0 = time.perf_counter()
    out: dict = {}
    profile_dir = tempfile.mkdtemp(prefix="gofr_profile_")
    env = {**PHASE10_ENV, "HTTP_PORT": str(free_port()), "PROFILE_DIR": profile_dir}
    try:
        with environment(env):
            app = gofr_tpu_torch.new(model=model)
        gofr_tpu_torch.register_openai_routes(app)
        app.start()
        try:
            out.update(healthy_window(torch, flash, card, app, fit, join_records, np))
        finally:
            app.shutdown()
        out["stall"] = stalled_prefill(torch, model)
    finally:
        shutil.rmtree(profile_dir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"obs-metrics [{card}]: {json.dumps(out)}", flush=True)
    check(out["phase_s"] < 90, f"obs: phase 17 took {out['phase_s']:.1f}s")
    return out


def healthy_window(torch, flash, card: str, app, fit, join_records, np) -> dict:
    """Phase 17's traffic on the auto-armed watchdog: 1 and 8 streams of 32
    greedy tokens (the 8 under the profiler), a 1,500-byte prompt (3 slices)
    and one full prefill batch (8 x 512 tokens); every request recorded,
    every dispatch id resolving, the timeline's counts the batcher's and the
    pool's, zero anomalies on a fitted row, the gauges beside the
    predictions, and the row this run's records fit."""
    out: dict = {}
    port, dev = app.http_port, app.container.tpu
    pool, runner, batcher = dev.decode_pool, dev.runner, dev.batcher
    n_layers, chunk = runner.cfg.n_layers, pool.chunk
    engine = admin(port, "/admin/engine")
    wd = engine["watchdog"]
    print(f"obs: engine {engine['engine']['state']}, watchdog enabled {wd['enabled']} at "
          f"{wd['timeout_s']}s ({wd['on_stall']}); platform {engine['platform']} "
          f"{engine['device_kind']}; compiles {engine['compiles']}", flush=True)
    check(engine["engine"]["state"] == "serving" and wd["enabled"] and wd["timeout_s"] == 120.0,
          "obs: the engine is not serving with the watchdog armed at 120 s")
    calibration = admin(port, "/admin/costmodel")["calibration"]
    fitted_row = str(calibration.get("row_source") or "").startswith("fit")
    print(f"obs: cost model calibration {calibration['source']} matched "
          f"{calibration['matched']} row {calibration['row_source']}: eff_flops "
          f"{calibration['eff_flops']:.4g} eff_bw {calibration['eff_bw']:.4g} overhead "
          f"{calibration['overhead_ms']:.4g} ms", flush=True)
    ids0 = dev.timeline.records(limit=1)[0]["dispatch_id"]
    by_kind0 = dict(dev.timeline.stats()["by_kind"])
    b0, d0, p0 = batcher.dispatches, pool.dispatches, runner.prefills
    posted0 = POSTED.get(port, 0)
    greedy = {"max_tokens": 32, "temperature": 0}
    # every count to 0 just before the main path runs
    for c in (flash.launches, flash.launches_fwd_sm90, flash.launches_fwd_decode):
        c.reset()
    rate1, tpot1, _ = concurrent_streams(port, [text(170, OBS_SIZES["one"])], greedy)
    timeline_idle(pool, dev.timeline)
    mbu_1 = [r["mbu"] for r in dev.timeline.records(limit=100, kind="decode_chunk")
             if r["dispatch_id"] > ids0 and r["mbu"] is not None]
    check(mbu_1, "obs: no decode chunk carried an MBU")
    # 8 streams in one bucket (one prefill cohort), under the profiler
    ids, restore = marked_chunks(pool)
    status, started, _, _ = post(port, {}, path="/admin/profiler/start")
    check(status == 200 and started["data"]["state"] == "tracing", f"obs: start {started}")
    try:
        ids_before = dev.timeline.records(limit=1)[0]["dispatch_id"]
        base, step = OBS_SIZES["streams"]
        prompts = [text(180 + i, base + step * i) for i in range(8)]
        rate8, tpot8, _ = concurrent_streams(port, prompts, greedy)
        timeline_idle(pool, dev.timeline)
    finally:
        restore()
        status, stopped, _, _ = post(port, {}, path="/admin/profiler/stop")
    check(status == 200 and stopped["data"]["artifacts"] == ["trace.json"],
          f"obs: stop {stopped}")
    trace = os.path.join(stopped["data"]["dir"], "trace.json")
    size_mb = os.path.getsize(trace) / 1e6
    per_chunk, busy_us, window_us = chunk_kernel_us(trace, ids)
    os.remove(trace)
    records = {r["dispatch_id"]: r for r in admin(port, "/admin/dispatches?limit=512")
               ["dispatches"]}
    over = [(i, us, records[i]["duration_s"] * 1e6) for i, us in per_chunk.items()
            if us > records[i]["duration_s"] * 1e6]
    mbu_8 = [records[i]["mbu"] for i in per_chunk if records[i]["mbu"] is not None]
    step_ms = [us / 1e3 / chunk for i, us in per_chunk.items()
               if records[i]["batch_size"] == 8 and us > 0]
    weights = float(runner.weight_bytes)
    device_mbu = [weights / (ms / 1e3) / PEAK_BYTES_PER_S for ms in step_ms]
    idle = 1.0 - busy_us / window_us
    print(f"obs: profiler trace {size_mb:.1f} MB: {len(per_chunk)} pool chunks, kernel time a "
          f"chunk {min(per_chunk.values()) / 1e3:.2f}-{max(per_chunk.values()) / 1e3:.2f} ms "
          f"against record durations {min(records[i]['duration_s'] for i in per_chunk) * 1e3:.1f}"
          f"-{max(records[i]['duration_s'] for i in per_chunk) * 1e3:.1f} ms; busy "
          f"{busy_us / 1e3:.1f} of {window_us / 1e3:.1f} ms, idle share {idle:.3f}", flush=True)
    check(not over, f"obs: a chunk's kernel time exceeds its record's duration: {over}")
    check(all(i > ids_before for i in per_chunk), "obs: a profiled chunk predates the window")
    # the 1,500-byte prompt: 3 slices of 512
    status, data, ttft_long, _ = post(port, {"prompt": text(190, OBS_SIZES["long"]),
                                             "max_tokens": 8, "temperature": 0})
    check(status == 200, f"obs: long prompt {status} {data}")
    # one full prefill batch: 8 x 512 tokens, one token each (no decode);
    # sent again (other prompts) if the 20 ms window split the cohort
    full_batch: list = []
    for attempt in range(3):
        width = OBS_SIZES["full"]
        concurrent_posts(port, [{"prompt": text(200 + 10 * attempt + i, width),
                                 "max_tokens": 1, "temperature": 0} for i in range(8)])
        full_batch = [r for r in dev.timeline.records(limit=16, kind="prefill")
                      if r["batch_size"] == 8 and r["bucket"] == width
                      and r["dispatch_id"] > ids0 and r["tokens"] == 8 * width]
        if full_batch:
            break
    check(full_batch, "obs: no full batch of 8 x 512 tokens in 3 tries (the cohort split)")
    timeline_idle(pool, dev.timeline)
    series = scrape(port)
    prefill_gauge = sample_sum(series, "gofr_tpu_mfu", 'op="prefill"')
    decode_mbu_gauge = sample_sum(series, "gofr_tpu_mbu", 'op="decode"')
    dispatches = admin(port, "/admin/dispatches?limit=512")["dispatches"]
    by_id = {r["dispatch_id"]: r for r in dispatches}
    prefill_mfu = full_batch[0]["mfu"]
    n_params = runner.n_params
    gauge_mfu = 2.0 * n_params * full_batch[0]["tokens"] / full_batch[0]["duration_s"] / 989e12
    print(f"obs: prefill of 8 x {OBS_SIZES['full']}: {full_batch[0]['duration_s'] * 1e3:.2f} ms, record MFU "
          f"(analytic sheet) {prefill_mfu:.3f}, 2*N*tokens {gauge_mfu:.3f} (predicted "
          f"~{PREDICTED['prefill_mfu']}); gauge gofr_tpu_mfu{{op=prefill}} {prefill_gauge:.3f}",
          flush=True)
    print(f"obs: decode MBU, 1 stream: records {np.median(mbu_1):.3f} (min {min(mbu_1):.3f}, "
          f"max {max(mbu_1):.3f}); 8 streams under the profiler {np.median(mbu_8):.3f}; gauge "
          f"{decode_mbu_gauge:.3f} (predicted {PREDICTED['decode_mbu'][0]}-"
          f"{PREDICTED['decode_mbu'][1]}); on device time {np.median(device_mbu):.3f} from "
          f"{np.median(step_ms):.3f} ms a step (predicted ~{PREDICTED['decode_mbu_device']})",
          flush=True)
    # every request recorded, its dispatch ids resolving
    posted = POSTED.get(port, 0) - posted0
    flights = admin(port, "/admin/requests?limit=100")["requests"]
    mine = [r for r in flights if r["endpoint"] == "/v1/completions"]
    check(len(mine) == posted, f"obs: {len(mine)} flight records for {posted} requests")
    check(all(r["status"] == "ok" and r["dispatch_ids"] for r in mine),
          "obs: a request failed or rode no dispatch")
    missing = [d for r in mine for d in r["dispatch_ids"] if d not in by_id]
    check(not missing, f"obs: dispatch ids that resolve to nothing: {missing[:8]}")
    # the timeline's counts are the batcher's, the pool's and the slices'
    by_kind = dev.timeline.stats()["by_kind"]
    delta = {k: by_kind.get(k, 0) - by_kind0.get(k, 0) for k in by_kind}
    slices = runner.prefills - p0 - (batcher.dispatches - b0)
    print(f"obs: dispatches {delta}; batcher {batcher.dispatches - b0}, pool chunks "
          f"{pool.dispatches - d0}, other prefill forwards {slices}", flush=True)
    check(delta.get("prefill", 0) == batcher.dispatches - b0, "obs: prefill records != batcher")
    check(delta.get("decode_chunk", 0) == pool.dispatches - d0, "obs: chunk records != pool")
    # the long prompt's slices, and any prefix-cache tail prefill (a record
    # with its detail), each a prefill forward outside the batcher
    cut = [r for r in dispatches if r["kind"] == "prefill_chunk" and r["dispatch_id"] > ids0
           and not r["detail"]]
    check(delta.get("prefill_chunk", 0) == slices and len(cut) == OBS_SIZES["slices"],
          f"obs: {len(cut)} slice records for the long prompt's {OBS_SIZES['slices']}")
    # launches: sm90 for every prefill forward's layers, decode for every
    # pool step's, none on mma
    sm90, decode = flash.launches_fwd_sm90.value, flash.launches_fwd_decode.value
    mma = flash.launches.value - sm90 - decode
    chunks = pool.dispatches - d0
    print(f"obs: launches sm90 {sm90}, decode {decode} = n_layers x DECODE_CHUNK x chunks "
          f"{n_layers * chunk * chunks}, mma {mma}", flush=True)
    check(mma == 0 and decode == n_layers * chunk * chunks
          and sm90 >= n_layers * (runner.prefills - p0), "obs: a launch off its route")
    # the cost model: zero anomalies on a fitted row; the fit of this run
    anomalies = admin(port, "/admin/anomalies")
    costmodel = admin(port, "/admin/costmodel")
    residuals = {f: round(v["ema"], 4) for f, v in costmodel["residuals"].items()}
    print(f"obs: anomalies {anomalies['count']} {anomalies['stats']['by']}; residual EMAs "
          f"{residuals}", flush=True)
    if fitted_row:
        check(anomalies["count"] == 0, f"obs: healthy traffic raised {anomalies['anomalies']}")
    samples = join_records([r for r in dispatches if r["dispatch_id"] > ids0],
                           costmodel["sheets"])
    row = fit(samples, dev.device_kind)
    row["source"] = f"fit: chip_smoke.py phase 17, {card}"
    ratios: dict = {}
    for s in samples:
        predicted = (max(s["flops"] / row["eff_flops"], s["bytes_accessed"] / row["eff_bw"]) * 1e3
                     + row["overhead_ms"])
        ratios.setdefault(f"{s['kind']}/{s['bucket']}", []).append(s["duration_s"] * 1e3 / predicted)
    print("obs: fitted row " + json.dumps({k: row[k] for k in (
        "eff_flops", "eff_bw", "overhead_ms", "eff_flops_source", "eff_bw_source",
        "n_compute_bound", "n_bandwidth_bound", "source")}), flush=True)
    print("obs: residual ratios on the fitted row, by family (min/median/max) "
          + json.dumps({f: [round(min(v), 3), round(float(np.median(v)), 3), round(max(v), 3)]
                        for f, v in sorted(ratios.items())}), flush=True)
    out.update({
        "tokens_per_s": {"1": rate1, "8": rate8}, "tpot_ms": {"1": tpot1, "8": tpot8},
        "long_prompt_ttft_ms": ttft_long * 1e3,
        "prefill_mfu_record": prefill_mfu, "prefill_mfu_2n": gauge_mfu,
        "decode_mbu": float(np.median(mbu_1)), "decode_mbu_gauge": decode_mbu_gauge,
        "decode_mbu_device": float(np.median(device_mbu)), "idle_share": idle,
        "profiled_chunks": len(per_chunk), "anomalies": anomalies["count"],
        "calibration": calibration["row_source"], "fitted_row": row,
    })
    return out


def stalled_prefill(torch, model) -> dict:
    """A prefill slowed on the card by ``torch.cuda._sleep`` (~1 s) inside
    a wrapper this phase installs on the runner (the package has no such
    hook), with WATCHDOG_DISPATCH_TIMEOUT_S=0.5: degraded, readiness 503
    with the watchdog's evidence, back to serving when the wait returns,
    one stall counted, one slow_dispatch."""
    import gofr_tpu_torch

    # cycles a second of the card's clock, measured
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    cycles_per_s = 100_000_000 / (start.elapsed_time(end) / 1e3)
    env = {**PHASE10_ENV, "HTTP_PORT": str(free_port()), "WATCHDOG_DISPATCH_TIMEOUT_S": "0.5"}
    with environment(env):
        app = gofr_tpu_torch.new(model=model)
    gofr_tpu_torch.register_openai_routes(app)
    app.start()
    try:
        port, dev = app.http_port, app.container.tpu
        run_batch = dev.runner.run_batch

        def slowed(payloads):
            vars(dev.runner).pop("run_batch")  # one prefill only
            torch.cuda._sleep(int(cycles_per_s * 1.0))
            return run_batch(payloads)

        dev.runner.run_batch = slowed
        before = len(dev.engine.snapshot()["history"])
        result: list = []
        worker = threading.Thread(target=lambda: result.append(
            post(port, {"prompt": "slow prefill", "max_tokens": 4,
                        "temperature": 0})))
        t0 = time.perf_counter()
        worker.start()
        bodies = []
        while worker.is_alive():
            status, _, body = get_raw(port, "/.well-known/ready")
            if status == 503:
                bodies.append(json.loads(body))
            time.sleep(0.05)
        worker.join()
        wall = time.perf_counter() - t0
        deadline = time.perf_counter() + 5
        while dev.engine.state != "serving" and time.perf_counter() < deadline:
            time.sleep(0.02)
        states = [h["state"] for h in dev.engine.snapshot()["history"][before:]]
        check(result and result[0][0] == 200, f"obs stall: the request {result}")
        series = scrape(port)
        stalls = sample_sum(series, "gofr_tpu_device_stalls_total", 'kind="prefill"')
        anomalies = admin(port, "/admin/anomalies?cause=slow_dispatch")["anomalies"]
        status, _, body = get_raw(port, "/.well-known/ready")
        print(f"obs stall: {wall:.2f}s request, engine {states}, {len(bodies)} readiness 503s "
              f"(first {bodies[:1]}), then {status}; stalls {stalls}; slow_dispatch "
              f"{[(a['kind'], a['observed_ms'], a['predicted_ms']) for a in anomalies]}",
              flush=True)
        check(states[:1] == ["degraded"] and states[-1:] == ["serving"],
              f"obs stall: engine walked {states}")
        check(bodies and all(b["state"] in ("degraded", "wedged") and b["watchdog"]["watching"]
                             for b in bodies), "obs stall: readiness without the evidence")
        check(status == 200, "obs stall: readiness did not come back")
        check(stalls == 1, f"obs stall: {stalls} stalls counted")
        slowed_ones = [a for a in anomalies if a["kind"] == "prefill"]
        check(len(slowed_ones) == 1, f"obs stall: prefill anomalies {slowed_ones}")
        row = admin(port, "/admin/costmodel")["calibration"]["row_source"] or ""
        if row.startswith("fit"):
            check(len(anomalies) == 1, f"obs stall: other anomalies {anomalies}")
        return {"states": states, "ready_503s": len(bodies), "stalls": stalls,
                "observed_ms": slowed_ones[0]["observed_ms"]}
    finally:
        app.shutdown()


# -- phase 18: overload and failure ------------------------------------------------------

# phase 18's settings on top of phase 10's: the journal on a WAL, recovery,
# SLO objectives, a timebase a second, and a watchdog whose wedge (3 x 1 s)
# a healthy chunk or prefill never reaches; a rebuild may take two minutes
OVERLOAD_ENV = {
    "JOURNAL": "on", "RECOVERY_ENABLED": "on", "RECOVERY_ATTEMPT_TIMEOUT_S": "120",
    "SLO_TARGETS": "availability=0.99;ttft_p95_ms=2000;tpot_p99_ms=1000;shed_rate=0.5",
    "TIMEBASE_INTERVAL_S": "1", "WATCHDOG_DISPATCH_TIMEOUT_S": "1.0",
}
WEDGE_SLEEP_S = 5.0  # the slowed chunk: past the 3 s wedge, under the attempt timeout
RESUME_TOKENS = 64


def cycles_per_second(torch) -> float:
    """The card's ``torch.cuda._sleep`` cycles a second, measured."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    return 100_000_000 / (start.elapsed_time(end) / 1e3)


def id_recorder(dev) -> list:
    """Every ``generate`` call on ``dev`` (the handlers', the stream
    producers', the resume's): its prompt ids, journal arguments and the ids
    it emitted, in order, kept even when it fails (a wrapper this phase
    installs on the instance)."""
    calls: list = []
    inner = dev.generate

    def generate(tokens, max_new_tokens=32, on_token=None, **kw):
        rec = {"tokens": list(dev._encode(tokens)), "ids": [], "max": max_new_tokens,
               "journal_key": kw.get("journal_key"), "error": None}
        calls.append(rec)

        def emit(item):
            rec["ids"].append(item[0] if isinstance(item, tuple) else item)
            if on_token is not None:
                on_token(item)

        try:
            return inner(tokens, max_new_tokens, on_token=emit, **kw)
        except Exception as exc:
            rec["error"] = repr(exc)
            raise

    dev.generate = generate
    return calls


def token_frames(frames: list) -> tuple:
    """A completions stream's frames -> (token frames before any error, the
    error message or None, whether it ended with [DONE])."""
    n, error = 0, None
    for frame in frames:
        if frame == "[DONE]":
            continue
        data = json.loads(frame)
        if "error" in data:
            error = data["error"]["message"]
            break
        if data["choices"] and data["choices"][0]["finish_reason"] is None:
            n += 1
    return n, error, bool(frames) and frames[-1] == "[DONE]"


def counter_values(port: int, name: str) -> dict:
    """A labelled counter's samples off /metrics: {labels: value}."""
    return {k[len(name):]: v for k, v in scrape(port).items()
            if k == name or k.startswith(name + "{")}


def wait_free(dev, free, label: str) -> float:
    """Seconds until no pool row is active and the block pool's ledger holds
    no reservation (and, with ``free``, its free count is back to it)."""
    t0 = time.perf_counter()
    for _ in range(2000):
        stats = dev.kv_pool.stats()
        if (dev.decode_pool.occupancy()["active"] == 0 and stats["reserved"] == 0
                and (free is None or stats["free"] == free)):
            return time.perf_counter() - t0
        time.sleep(0.005)
    check(False, f"{label}: blocks not back ({dev.kv_pool.stats()}, {free} free before)")


def overload(torch, flash, card: str, model) -> dict:
    """Phase 18 (after phase 17, on phase 5's model): deadlines, client
    aborts, brownout, a wedge with its recovery and resume, a restart from
    the WAL, the SLO engine and timebase, and the journal's cost, in phase
    10's configuration with the journal on a WAL, recovery and SLO targets."""
    import gofr_tpu_torch

    t0 = time.perf_counter()
    out: dict = {"card": card}
    journal_dir = tempfile.mkdtemp(prefix="gofr_journal_")
    pm_dir = tempfile.mkdtemp(prefix="gofr_postmortem_")
    cps = cycles_per_second(torch)
    try:
        env = {**PHASE10_ENV, **OVERLOAD_ENV, "HTTP_PORT": str(free_port()),
               "JOURNAL_DIR": journal_dir}
        with environment(env):
            app = gofr_tpu_torch.new(model=model)
        gofr_tpu_torch.register_openai_routes(app)
        # a directory of this phase's own (POSTMORTEM_DIR would also arm the
        # process-wide crash hooks for every later phase)
        app.container.postmortem.directory = pm_dir
        app.start()
        for c in (flash.launches, flash.launches_fwd_sm90, flash.launches_fwd_decode):
            c.reset()  # every count to 0 just before the path runs
        try:
            dev = app.container.tpu
            calls = id_recorder(dev)
            out["deadlines"] = overload_deadlines(flash, app, calls)
            out["aborts"] = overload_aborts(app, calls)
            out["wedge"], wedged = overload_wedge(torch, flash, app, calls, cps, model)
            out["slo"] = overload_slo(app)
        finally:
            app.shutdown()
        env.update({"BROWNOUT_QUEUE_DEPTH": "1", "BROWNOUT_KV_UTIL": "0.5"})
        with environment(env):
            app = gofr_tpu_torch.new(model=model)
        gofr_tpu_torch.register_openai_routes(app)
        app.container.postmortem.directory = pm_dir
        app.start()
        try:
            calls = id_recorder(app.container.tpu)
            out["restart"] = overload_restart(app, calls, wedged)
            out["brownout"] = overload_brownout(app)
            out["journal_cost"] = overload_journal_cost(app)
        finally:
            app.shutdown()
    finally:
        shutil.rmtree(journal_dir, ignore_errors=True)
        shutil.rmtree(pm_dir, ignore_errors=True)
    checked = out["wedge"]["check_launches"]
    launches = {"all": flash.launches.value - checked["all"],
                "sm90": flash.launches_fwd_sm90.value - checked["sm90"],
                "decode": flash.launches_fwd_decode.value - checked["decode"]}
    check(launches["sm90"] > 0 and launches["decode"] > 0,
          f"overload: a forward route never ran {launches}")
    check(launches["all"] == launches["sm90"] + launches["decode"],
          f"overload: a forward took another route than sm90 or decode {launches}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    print(f"overload-metrics [{card}]: {json.dumps(out)}", flush=True)
    check(out["phase_s"] < 180, f"overload: phase 18 took {out['phase_s']:.1f}s")
    return out


def overload_deadlines(flash, app, calls: list) -> dict:
    """(1) A 1.5 s budget with max_tokens 256 expires mid-decode (a 504
    error frame after the tokens it got, a prefix of the same request's
    greedy ids; its blocks come back); meanwhile, rows decoding, a budget
    under one chunk is refused at admission with no prefill."""
    port, dev = app.http_port, app.container.tpu
    prompt = text(181, 200)
    ref_n = 48  # the greedy ids the cut one must prefix: more than 1.5 s decodes
    status, _, _, _ = post(port, {"prompt": prompt, "max_tokens": ref_n, "temperature": 0})
    check(status == 200, f"deadline: the reference {status}")
    reference = calls[-1]["ids"]
    pool_idle(dev.decode_pool, "deadline")
    free = dev.kv_pool.stats()["free"]  # the prompt's prefix-cache entries are in it
    result: list = []
    first_frames = threading.Event()

    def cut_stream():
        result.append(post(port, {"prompt": prompt, "max_tokens": 256, "temperature": 0,
                                  "stream": True}, stream=True,
                           headers={"X-Request-Deadline-Ms": "1500"}))

    worker = threading.Thread(target=cut_stream)
    start = len(calls)
    worker.start()
    for _ in range(1000):  # the first pooled chunk delivered: a cadence measured
        if len(calls) > start and len(calls[start]["ids"]) > 9:
            first_frames.set()
            break
        time.sleep(0.005)
    check(first_frames.is_set(), "deadline: the cut stream never decoded a chunk")
    cadence = dev.decode_pool.occupancy()["chunk_cadence_s"]
    sm90 = flash.launches_fwd_sm90.value
    t_refuse = time.perf_counter()
    status, body, _, _ = post(port, {"prompt": text(183, 120), "max_tokens": 16},
                              headers={"X-Request-Deadline-Ms": "20"})
    refuse_ms = (time.perf_counter() - t_refuse) * 1e3
    check(status == 504, f"deadline: a 20 ms budget got {status} {body}")
    check(flash.launches_fwd_sm90.value == sm90,
          "deadline: the refused request ran a prefill")
    worker.join(timeout=60)
    status, frames, _, _ = result[0]
    got, error, done = token_frames(frames)
    cut = calls[start]["ids"]
    check(status == 200 and error and "deadline" in error and not done,
          f"deadline: the 1.5 s stream ended {status} {error} done={done}")
    check(got == len(cut) and 0 < len(cut) < ref_n and cut == reference[:len(cut)],
          f"deadline: the cut stream's {len(cut)} ids are not a prefix of the greedy ids")
    back_s = wait_free(dev, free, "deadline")
    stages = counter_values(port, "gofr_tpu_deadline_exceeded_total")
    rejects = counter_values(port, "gofr_tpu_pool_reject_total")
    check(stages == {'{stage="admission"}': 1.0, '{stage="decode"}': 1.0},
          f"deadline: stages {stages}")
    check(rejects.get('{reason="deadline"}') == 1.0, f"deadline: pool rejects {rejects}")
    records = admin(port, "/admin/requests?limit=3")["requests"]
    sheds = sorted((r["shed_stage"], r["deadline_s"], r["status"]) for r in records
                   if r["shed_stage"])
    check(sheds == [("admission", 0.02, "deadline_exceeded"),
                    ("decode", 1.5, "deadline_exceeded")], f"deadline: records {sheds}")
    out = {"cut_tokens": len(cut), "cadence_ms": cadence * 1e3, "refuse_ms": refuse_ms,
           "blocks_back_ms": back_s * 1e3, "stages": stages}
    print(f"overload deadlines: {json.dumps(out)}", flush=True)
    return out


def overload_aborts(app, calls: list) -> dict:
    """(2) 8 streams; 4 clients close after their first tokens: 4 client
    aborts counted, their rows and blocks freed (the close-to-free time
    against the chunk cadence), the other 4 equal to their solo greedy
    ids."""
    port, dev = app.http_port, app.container.tpu
    pool = dev.decode_pool
    prompts = [text(190 + i, 160 + 9 * i) for i in range(8)]
    body = {"max_tokens": 40, "temperature": 0}
    solo = []
    for i in range(4):  # the survivors' ids alone, each a fresh prefill
        post(port, {**body, "prompt": prompts[i]})
        solo.append(calls[-1]["ids"])
    # emptied, so that every prompt prefills as it did alone (a cached
    # prompt's hit, or an LRU-dropped one's partial hit, computes another way)
    dev.kv_pool.cache_clear()
    pool_idle(pool, "aborts")
    aborts0 = counter_values(port, "gofr_tpu_cancellations_total").get(
        '{cause="client_abort"}', 0.0)
    results: list = [None] * 4
    start = len(calls)

    def survivor(i):
        results[i] = post(port, {**body, "prompt": prompts[i], "stream": True}, stream=True)

    threads = [threading.Thread(target=survivor, args=(i,)) for i in range(4)]
    closers: list = [None] * 4

    def closer(i):
        closers[i] = stream_then_close(port, {**body, "prompt": prompts[4 + i]}, 3)

    threads += [threading.Thread(target=closer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads[4:]:
        t.join(timeout=120)
    t_close = time.perf_counter()
    close_to_free = None
    for _ in range(4000):
        if pool.occupancy()["active"] <= 4 or all(r is not None for r in results):
            close_to_free = time.perf_counter() - t_close
            break
        time.sleep(0.002)
    cadence = pool.occupancy()["chunk_cadence_s"]
    for t in threads[:4]:
        t.join(timeout=120)
    wait_free(dev, None, "aborts")  # the survivors' conversations entered the cache
    aborts = counter_values(port, "gofr_tpu_cancellations_total").get(
        '{cause="client_abort"}', 0.0) - aborts0
    check(aborts == 4, f"aborts: {aborts} client aborts counted")
    got = {}
    for rec in calls[start:]:
        for i in range(4):
            if rec["tokens"] == list(dev._encode(prompts[i])):
                got[i] = rec["ids"]
    for i in range(4):
        status, frames, _, _ = results[i]
        n, error, done = token_frames(frames)
        check(status == 200 and done and error is None and n == 40,
              f"aborts: survivor {i} {status} {n} {error}")
    check([got[i] for i in range(4)] == solo, "aborts: a survivor's ids are not its solo ids")
    out = {"client_aborts": aborts, "closed_after_frames": closers,
           "close_to_free_ms": None if close_to_free is None else close_to_free * 1e3,
           "cadence_ms": cadence * 1e3}
    print(f"overload aborts: {json.dumps(out)}", flush=True)
    return out


def overload_wedge(torch, flash, app, calls: list, cps: float, model) -> tuple:
    """(4) The ids of an uninterrupted greedy stream of 64 tokens; then,
    beside a long stream keeping the pool busy, the same request twice at
    once (prefix-cache hits, so both rows join the same chunk), and the
    pool's fifth chunk with both rows slowed on the card past the wedge
    (``torch.cuda._sleep`` in a wrapper this phase installs on the pool;
    behind it the chunk's launches fill the CUDA queue and block the
    worker: the streams stop at token 17): serving -> degraded -> wedged -> recovering ->
    warming -> serving, a postmortem bundle, the weights in place, the MTTR
    and peak memory; then ``X-Resume-From`` for one stream returns the rest
    under the resume rule. -> (numbers, the other stream's resume point and
    the ids to hold it to)."""
    port, dev = app.http_port, app.container.tpu
    prompt = text(211, 40)
    body = {"prompt": prompt, "max_tokens": RESUME_TOKENS, "temperature": 0, "stream": True}
    status, frames, _, _ = post(port, body, stream=True)
    check(status == 200 and token_frames(frames)[0] == RESUME_TOKENS,
          f"wedge: the uninterrupted stream {status}")
    reference = calls[-1]["ids"]
    prompt_ids = list(dev._encode(prompt))
    ptrs = [p.data_ptr() for p in model.parameters()]
    pool = dev.decode_pool
    pool_idle(pool, "wedge")
    run = pool._run_executable
    dispatches = {"n": 0}

    def slowed():
        if len(pool._active) >= 3:  # the busy row and both streams
            dispatches["n"] += 1
            # the fifth chunk of both streams: the worker dispatches 3 ahead
            # and fetches the oldest between dispatches, so the streams hold
            # 1 + 2 x 8 = 17 tokens when this dispatch's launches block
            if dispatches["n"] == 5:
                vars(pool).pop("_run_executable")
                torch.cuda._sleep(int(cps * WEDGE_SLEEP_S))
        return run()

    busy: list = []
    busy_thread = threading.Thread(target=lambda: busy.append(post(
        port, {"prompt": text(212, 150), "max_tokens": 400, "temperature": 0, "stream": True},
        stream=True)))
    busy_thread.start()
    for _ in range(2000):  # the busy row decoding: the worker issues chunk after chunk
        if pool.occupancy()["active"] == 1 and pool.dispatches > 2:
            break
        time.sleep(0.005)
    pool._run_executable = slowed
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    before = len(dev.engine.snapshot()["history"])
    results: list = [None, None]
    start = len(calls)

    def stream(i):
        results[i] = post(port, body, stream=True)

    threads = [threading.Thread(target=stream, args=(i,)) for i in range(2)]
    t_wedge = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    busy_thread.join(timeout=300)
    for _ in range(6000):
        if dev.engine.state == "serving" and dev.recovery.snapshot()["last_outcome"]:
            break
        time.sleep(0.02)
    walk = [h["state"] for h in dev.engine.snapshot()["history"][before:]]
    recovery = dev.recovery.snapshot()
    peak = torch.cuda.max_memory_allocated()
    check(walk == ["degraded", "wedged", "recovering", "warming", "serving"],
          f"wedge: the engine walked {walk}")
    check(recovery["recoveries"] == {"recovered": 1}, f"wedge: recovery {recovery}")
    check(dev.runner.model is model and [p.data_ptr() for p in model.parameters()] == ptrs,
          "wedge: the rebuild did not keep the weights")
    got = [token_frames(results[i][1]) for i in range(2)]
    check(all(r[0] == 200 for r in results) and all(g[1] and not g[2] for g in got),
          f"wedge: the streams ended {[(r[0], g) for r, g in zip(results, got)]}")
    wedged = [rec for rec in calls[start:] if rec["error"] and rec["tokens"] == prompt_ids]
    check(len(wedged) == 2 and all(rec["ids"] == reference[:len(rec["ids"])]
                                   for rec in wedged),
          "wedge: the interrupted streams' ids are not a prefix of the reference")
    k = got[0][0]
    check(k == len(wedged[0]["ids"]) == got[1][0] == len(wedged[1]["ids"]),
          f"wedge: tokens received {got}, journalled {[len(r['ids']) for r in wedged]}")
    bundles = admin(port, "/admin/postmortem")["bundles"]
    check(bundles, "wedge: no postmortem bundle")
    with open(os.path.join(app.container.postmortem.directory, bundles[0]["file"])) as f:
        bundle = json.load(f)
    versions = bundle["versions"]
    check(versions["torch"] and versions["cuda"] and versions["card"],
          f"wedge: the bundle's versions {versions}")
    # the resume: the client received k ids of each stream
    sm90 = flash.launches_fwd_sm90.value
    start = len(calls)
    status, frames, _, _ = post(port, body, stream=True, headers={"X-Resume-From": str(k)})
    n, error, done = token_frames(frames)
    check(status == 200 and done and error is None and n == RESUME_TOKENS - k,
          f"wedge: the resumed stream {status} {n} {error}")
    continuation = calls[start]["ids"]
    check(calls[start]["tokens"] == prompt_ids + wedged[0]["ids"],
          "wedge: the resume did not re-prefill prompt + the journalled ids")
    resumed = wedged[0]["ids"][k:] + continuation
    check(len(resumed) == RESUME_TOKENS - k, "wedge: the resumed ids' count")
    resume_sm90 = flash.launches_fwd_sm90.value - sm90
    check(resume_sm90 > 0, "wedge: the teacher-forced re-prefill launched no sm90 kernel")
    # the near-tie check's own forward (a teacher-forced prefill and decode
    # steps) is no served work: its launches leave the phase's count
    check0 = {"all": flash.launches.value, "sm90": flash.launches_fwd_sm90.value,
              "decode": flash.launches_fwd_decode.value}
    rule = first_divergence(dev.runner, prompt_ids, reference, wedged[0]["ids"][:k] + resumed,
                            "wedge resume")
    checked = {"all": flash.launches.value - check0["all"],
               "sm90": flash.launches_fwd_sm90.value - check0["sm90"],
               "decode": flash.launches_fwd_decode.value - check0["decode"]}
    modes = counter_values(port, "gofr_tpu_journal_resumes_total")
    check(modes == {'{mode="teacher_forced"}': 1.0}, f"wedge: resume modes {modes}")
    out = {"tokens_received": k, "walk": walk, "mttr_s": recovery["last_mttr_s"],
           "peak_gib": peak / 2**30, "before_gib": mem0 / 2**30,
           "bundle": bundles[0]["file"],
           "versions": {key: versions[key] for key in
                        ("torch", "cuda", "driver", "card", "power_limit")},
           "resume": rule, "resume_sm90": resume_sm90, "resumes": modes,
           "wedge_to_serving_s": time.perf_counter() - t_wedge,
           "busy_stream": token_frames(busy[0][1])[:2] if busy else None,
           "check_launches": checked}
    print(f"overload wedge: {json.dumps(out)}", flush=True)
    return out, {"k": k, "body": body, "reference": reference, "prompt_ids": prompt_ids,
                 "interrupted": wedged[1]["ids"], "resumed": resumed}


def overload_slo(app) -> dict:
    """(6) The SLO engine's per-objective burn over this phase's records,
    a token-rate series from the timebase, the overview, and the cost
    model's anomaly trend."""
    port = app.http_port
    app.container.timebase.sample_now()
    budget = admin(port, "/admin/slo/budget")
    rows = {r["objective"]: {w: (s["bad"], s["total"], s["burn"]) for w, s in
                             r["windows"].items() if w in ("5m", "1h")}
            for r in budget["objectives"]}
    check({"availability", "ttft_p95_ms", "tpot_p99_ms", "shed_rate"} == set(rows),
          f"slo: objectives {sorted(rows)}")
    check(rows["availability"]["5m"][1] > 0, "slo: no record in the 5 m window")
    series = admin(port, "/admin/timeseries?metric=gofr_tpu_tokens_total")["series"]
    rates = [v for s in series for _, v in s["rate"]]
    check(rates and max(rates) > 0, "slo: the token-rate series is empty")
    overview = admin(port, "/admin/overview")
    check(overview["engine"]["state"] == "serving", f"slo: overview {overview['engine']}")
    cost = admin(port, "/admin/costmodel")
    check("anomalies_per_sec" in cost, "slo: /admin/costmodel without anomalies_per_sec")
    out = {"objectives": rows, "alerting": budget["objectives"] and
           [r["objective"] for r in budget["objectives"] if any(r["alerting"].values())],
           "alerts_total": budget["alerts_total"], "token_rate_points": len(rates),
           "token_rate_max": max(rates), "anomalies_per_sec": cost["anomalies_per_sec"]["now"]}
    print(f"overload slo: {json.dumps(out)}", flush=True)
    return out


def overload_restart(app, calls: list, wedged: dict) -> dict:
    """(5) A new app over the same weights and JOURNAL_DIR rehydrates the
    other interrupted stream and serves its X-Resume-From, equal to (4)'s
    resumed ids."""
    port, dev = app.http_port, app.container.tpu
    stats = dev.journal.stats()
    check(stats["rehydrated"] >= 1 and stats["wal"]["recovered_entries"] >= 1,
          f"restart: nothing rehydrated {stats}")
    k = wedged["k"]
    start = len(calls)
    status, frames, _, _ = post(port, wedged["body"], stream=True,
                                headers={"X-Resume-From": str(k)})
    n, error, done = token_frames(frames)
    check(status == 200 and done and error is None and n == RESUME_TOKENS - k,
          f"restart: the resumed stream {status} {n} {error}")
    resumed = wedged["interrupted"][k:] + calls[start]["ids"]
    modes = counter_values(port, "gofr_tpu_journal_resumes_total")
    check(modes.get('{mode="teacher_forced"}') == 1.0, f"restart: resume modes {modes}")
    check(resumed == wedged["resumed"], "restart: the resumed ids differ from (4)'s")
    out = {"rehydrated": stats["rehydrated"], "wal": stats["wal"], "equal_to_4": True,
           "resumed_tokens": n}
    print(f"overload restart: {json.dumps(out)}", flush=True)
    return out


def post_raw(port: int, body: dict, headers: dict) -> tuple:
    """POST -> (status, Retry-After, json body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json", **headers})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, resp.getheader("Retry-After"), data


def hold_stream(port: int, body: dict, opened: threading.Event,
                release: threading.Event) -> None:
    """A stream read until ``release``, then dropped (a client leaving)."""
    data = json.dumps({**body, "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=600)
    sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                 b"Content-Type: application/json\r\nX-Priority: 9\r\nContent-Length: "
                 + str(len(data)).encode() + b"\r\n\r\n" + data)
    sock.settimeout(0.05)
    while not release.is_set():
        try:
            if sock.recv(65536):
                opened.set()
        except socket.timeout:
            pass
    sock.close()


def overload_brownout(app) -> dict:
    """(3) BROWNOUT_QUEUE_DEPTH=1 and BROWNOUT_KV_UTIL=0.5: 8 long streams
    (priority 9) reserve the paged-KV ledger past half, the level rises;
    then 16 concurrent requests at priorities 2 and 8: priority 2 is shed
    with 429 and Retry-After, priority 8 is served; the gauge and
    /admin/engine show the level, and it falls back to 0 once the streams
    leave and the burst drains. The queue-depth signal is read beside."""
    port, dev = app.http_port, app.container.tpu
    release = threading.Event()
    opened = [threading.Event() for _ in range(8)]
    holders = [threading.Thread(target=hold_stream, args=(
        port, {"prompt": text(280 + i, 100), "max_tokens": 1900, "temperature": 0},
        opened[i], release)) for i in range(8)]
    for t in holders:
        t.start()
    levels, depths = [], []
    try:
        for e in opened:
            check(e.wait(120), "brownout: a long stream never started")
        for _ in range(250):
            snap = admin(port, "/admin/engine")["brownout"]
            levels.append(snap["level"])
            if snap["level"] >= 1:
                break
            time.sleep(0.02)
        check(levels[-1] >= 1, f"brownout: the level never rose {snap}")
        gauge_peak = sample_sum(scrape(port), "gofr_tpu_brownout_level")
        peak_signals = snap["signals"]
        results: list = [None] * 16

        def send(i):
            priority = "2" if i % 2 else "8"
            results[i] = (priority, *post_raw(port, {"prompt": text(300 + i, 60),
                                                     "max_tokens": 4, "temperature": 0},
                                              {"X-Priority": priority}))

        senders = [threading.Thread(target=send, args=(i,)) for i in range(16)]
        for t in senders:
            t.start()
        for t in senders:
            t.join(timeout=300)
        depths.append(admin(port, "/admin/engine")["brownout"]["signals"].get("queue_depth"))
    finally:
        release.set()
        for t in holders:
            t.join(timeout=60)
    shed = [r for r in results if r[1] == 429]
    check(len(shed) == 8 and all(r[0] == "2" and r[2] == "1"
                                 and "brownout" in r[3]["error"]["message"] for r in shed),
          f"brownout: the sheds {[(r[0], r[1], r[2]) for r in results]}")
    check(all(r[1] == 200 for r in results if r[0] == "8"),
          f"brownout: a priority-8 request was refused {results}")
    for _ in range(1000):
        snap = admin(port, "/admin/engine")["brownout"]
        if snap["level"] == 0:
            break
        time.sleep(0.02)
    gauge = sample_sum(scrape(port), "gofr_tpu_brownout_level")
    check(snap["level"] == 0 and gauge == 0, f"brownout: the level stayed {snap} {gauge}")
    out = {"peak_level": max(levels), "gauge_at_peak": gauge_peak, "signals_at_peak": peak_signals,
           "queue_depth_after_burst": depths, "shed": len(shed), "sheds": snap["sheds"],
           "level_after": snap["level"], "gauge_after": gauge}
    print(f"overload brownout: {json.dumps(out)}", flush=True)
    return out


def overload_journal_cost(app) -> dict:
    """(7) TPOT of 8 concurrent streams with the journal off, in memory, and
    on disk (the WAL, JOURNAL_FSYNC=interrupt), each twice, in turns on one
    app (the journal object swapped between runs)."""
    from gofr_tpu_torch.telemetry import GenerationJournal

    port, dev = app.http_port, app.container.tpu
    disk = dev.journal
    memory = GenerationJournal(capacity=disk.capacity, max_tokens=disk.max_tokens)
    modes = {"off": None, "memory": memory, "disk": disk}
    prompts = [text(260 + i, 300 + 25 * i) for i in range(8)]
    body = {"max_tokens": 24, "temperature": 0, "stream": True}
    tpots: dict = {m: [] for m in modes}
    try:
        for mode in ("off", "memory", "disk", "disk", "memory", "off"):
            dev.journal = modes[mode]
            starts, results = [None] * 8, [None] * 8

            def run(i):
                starts[i] = time.perf_counter()
                results[i] = post(port, {**body, "prompt": prompts[i]}, stream=True,
                                  headers={"X-Priority": "9"})

            threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            _, tpot, _ = stream_rate(starts, results)
            tpots[mode].append(tpot)
            pool_idle(dev.decode_pool, "journal cost")
    finally:
        dev.journal = disk
    out = {m: {"tpot_ms": v, "mean_ms": sum(v) / len(v)} for m, v in tpots.items()}
    print(f"overload journal cost (TPOT at 8 streams): {json.dumps(out)}", flush=True)
    return out


# -- phase 15: the encoder and MLP families ------------------------------------------

ENCODER_ENV = {"TOKENIZER": "byte", "BATCH_MAX_SIZE": "8", "BATCH_TIMEOUT_MS": "5",
               "MODEL_SEED": "0", "TORCH_DEVICE": "cuda"}
EMBED_TOL = 2e-2  # bf16 (tests/test_flash.py's), card against the CPU's plain path
QUANT_EMBED_TOL = 0.05  # tests/test_models.py's bound of a quantized BERT
MLP_TOL = 2e-5  # f32 with TF32 off
BATCH8_LENS = (1, 17, 33, 50, 64, 90, 127, 128)
CONCURRENT_LENS = (3, 12, 25, 40, 60, 80, 100, 120)


def make_infer_handler(http_error):
    """``examples/http-server/main.py``'s ``/infer`` handler (a user's
    route, not the package's), raising ``http_error``."""
    import numpy as np

    async def infer_handler(ctx):
        if ctx.tpu is None:
            raise http_error(503, "tpu not configured (set MODEL_NAME)")
        payload = ctx.bind() if ctx.request.body else {"x": [0.0] * 64}
        if not isinstance(payload, dict):
            raise http_error(400, 'request body must be a JSON object like {"tokens": [...]}')
        data = payload.get("x") or payload.get("tokens")
        if not data:
            raise http_error(400, 'missing "x" (features) or "tokens" (ids) in body')
        result = await ctx.tpu.infer_async(data)
        if isinstance(result, dict):  # transformer prefill state -> next token
            return {"next_token": result["next_token"]}
        return {"y": np.asarray(result).tolist()}

    return infer_handler


def boot_encoder(env: dict):
    """A fresh app under ``env`` alone (every key the port reads cleared
    first), with the OpenAI routes and the example's ``/infer``."""
    import gofr_tpu_torch
    from gofr_tpu_torch.config import DECLARED_KEYS
    from gofr_tpu_torch.errors import HTTPError

    for key in DECLARED_KEYS:
        os.environ.pop(key, None)
    os.environ.update({**env, "HTTP_PORT": str(free_port())})
    app = gofr_tpu_torch.new()
    gofr_tpu_torch.register_openai_routes(app)
    app.post("/infer", make_infer_handler(HTTPError))
    app.start()
    return app


def item_ids(n: int, salt: int) -> list:
    """``n`` token ids of bert-base's vocabulary, spread by ``salt``."""
    return [(j * 7919 + salt * 131 + 1) % 30522 for j in range(n)]


def concurrently(port: int, bodies: list, path: str) -> tuple:
    """POST each body at once from its own thread -> (results in order,
    wall seconds from the first start to the last answer)."""
    results: list = [None] * len(bodies)

    def run(i):
        results[i] = post(port, bodies[i], path=path)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results, time.perf_counter() - t0


def embed_rows(port: int, body: dict) -> tuple:
    status, data, secs, _ = post(port, body, path="/v1/embeddings")
    check(status == 200, f"encoder: /v1/embeddings {status} {data}")
    return [r["embedding"] for r in data["data"]], data, secs


def encoder_serving(torch, flash, card: str) -> dict:
    """Phase 15: bert-base (bf16, full width and depth, seeded) over
    ``POST /v1/embeddings``, then int8, then the MLP behind ``/infer``."""
    import numpy as np

    from gofr_tpu_torch.models.bert import BERT_BASE, Bert, bert_embed
    from gofr_tpu_torch.models.mlp import MLP, mlp_forward
    from gofr_tpu_torch.tpu.device import _BertRunner
    from gofr_tpu_torch.tpu.flops import bert_param_count

    out: dict = {}
    t0 = time.perf_counter()
    app = boot_encoder({**ENCODER_ENV, "MODEL_NAME": "bert-base"})
    try:
        dev = app.container.tpu
        port, model, n_layers = app.http_port, dev.runner.model, BERT_BASE.n_layers
        reckoned = bert_param_count(BERT_BASE) * 2
        out["weight_bytes"] = model.weight_bytes()
        print(f"encoder: bert-base booted in {time.perf_counter() - t0:.1f}s ({dev.describe()}); "
              f"weights on the card {out['weight_bytes']:,} bytes, bert_param_count x 2 = "
              f"{reckoned:,} [{card}]", flush=True)
        check(out["weight_bytes"] == reckoned, "encoder: weight bytes differ from the count")
        text = "Sentence embeddings from the card, pooled over the valid tokens."
        single = item_ids(50, 0)
        batch8 = [item_ids(n, i) for i, n in enumerate(BATCH8_LENS)]
        conc = [item_ids(n, 10 + i) for i, n in enumerate(CONCURRENT_LENS)]

        # the main path: every count to 0 just before, read just after
        for c in (flash.launches, flash.launches_fwd_sm90, flash.launches_fwd_decode):
            c.reset()
        dispatches0 = dev.batcher.dispatches
        served: dict = {}
        served["single"], data, _ = embed_rows(port, {"input": single})
        check(data["usage"] == {"prompt_tokens": 50, "total_tokens": 50}, f"usage {data['usage']}")
        served["text"], data, _ = embed_rows(port, {"input": text})
        check(data["usage"]["prompt_tokens"] == len(dev.tokenizer.encode(text)), "text usage")
        b1 = [embed_rows(port, {"input": single})[2] for _ in range(5)]
        served["batch8"], data, _ = embed_rows(port, {"input": batch8})
        check([r["index"] for r in data["data"]] == list(range(8)), "batch of 8: indices")
        b8 = [embed_rows(port, {"input": batch8})[2] for _ in range(3)]
        walls, results = [], None
        for _ in range(3):
            results, wall = concurrently(port, [{"input": x} for x in conc], "/v1/embeddings")
            walls.append(wall)
        for status, data, _, _ in results:
            check(status == 200, f"encoder: a concurrent request got {status} {data}")
        served["concurrent"] = [data["data"][0]["embedding"] for _, data, _, _ in results]
        status, data, _, _ = post(port, {"input": [item_ids(129, 99)]}, path="/v1/embeddings")
        want_400 = "input item is 129 tokens; this encoder accepts at most 128"
        check(status == 400 and data["error"]["message"] == want_400,
              f"encoder: 129 tokens gave {status} {data}")
        launches, sm90 = flash.launches.value, flash.launches_fwd_sm90.value
        decode = flash.launches_fwd_decode.value
        dispatches = dev.batcher.dispatches - dispatches0
        mma = launches - sm90 - decode
        print(f"encoder: forward launches {launches} over {dispatches} dispatches: mma {mma} "
              f"(n_layers x dispatches = {n_layers * dispatches}), sm90 {sm90}, decode {decode}",
              flush=True)
        check(sm90 == 0 and decode == 0, "encoder: a call left the mma kernel")
        check(mma == n_layers * dispatches, "encoder: a layer's attention missed the mma kernel")
        out.update(launches=mma, dispatches=dispatches, per_dispatch=mma / dispatches)
        out["latency_b1_ms"] = sorted(b1)[2] * 1e3
        out["latency_b8_ms"] = sorted(b8)[1] * 1e3
        out["embeddings_per_s"] = [len(conc) / w for w in walls]
        print(f"encoder-metrics [{card}]: latency a request, batch 1 (50 tokens) "
              f"{out['latency_b1_ms']:.2f} ms (of {[round(x * 1e3, 2) for x in b1]}), batch 8 "
              f"{out['latency_b8_ms']:.2f} ms (of {[round(x * 1e3, 2) for x in b8]}); 8 "
              f"concurrent single-item requests {[round(x, 1) for x in out['embeddings_per_s']]} "
              f"embeddings/s", flush=True)

        # one dispatch of 8 under the profiler: its kernels and device time
        payloads = [dev.runner.prepare({"tokens": x}) for x in batch8]
        table = kernel_profile(torch, lambda: dev.runner.run_batch(payloads))
        out["kernels_per_dispatch"] = sum(n for n, _ in table.values())
        out["device_ms_per_dispatch"] = sum(ms for _, ms in table.values())
        t = time.perf_counter()
        dev.runner.run_batch(payloads)
        out["dispatch_wall_ms"] = (time.perf_counter() - t) * 1e3
        top = sorted(table.items(), key=lambda kv: -kv[1][1])[:4]
        print(f"encoder-profile [{card}]: a dispatch of 8 x 128 tokens runs "
              f"{out['kernels_per_dispatch']} kernels, {out['device_ms_per_dispatch']:.3f} ms of "
              f"device time in {out['dispatch_wall_ms']:.3f} ms of wall time; the longest: "
              f"{[(name[:60], n, round(ms, 3)) for name, (n, ms) in top]}", flush=True)

        # the card against the CPU's plain path, on the same weights
        cpu_model = Bert(BERT_BASE, "cpu")
        cpu_model.load_state_dict(model.state_dict())
        ref = _BertRunner("bert-base", torch.device("cpu"), model=cpu_model)
        items = [single, dev.tokenizer.encode(text), *batch8, *conc]
        got = np.asarray([served["single"][0], served["text"][0], *served["batch8"],
                          *served["concurrent"]])
        want = np.concatenate([np.stack(ref.run_batch([ref.prepare(x) for x in items[i:i + 8]]))
                               for i in range(0, len(items), 8)])
        diff = float(np.abs(got - want).max())
        cos = float((np.sum(got * want, axis=-1) / (np.linalg.norm(got, axis=-1)
                                                    * np.linalg.norm(want, axis=-1))).min())
        print(f"encoder: {len(items)} embeddings, card vs the CPU's plain path: max|d| "
              f"{diff:.3e}, smallest cosine {cos:.6f}, tol {EMBED_TOL} -> "
              f"{'ok' if diff <= EMBED_TOL else 'FAIL'}", flush=True)
        check(diff <= EMBED_TOL, "encoder: the card's embeddings differ from the CPU's")
        out.update(max_abs_err=diff, min_cos=cos)
        del cpu_model, ref

        # the padding's content moves no embedding, bit for bit
        tokens = np.zeros((8, 128), np.int32)
        mask = np.zeros((8, 128), np.int32)
        for i, x in enumerate(batch8):
            tokens[i, :len(x)], mask[i, :len(x)] = x, 1
        noisy = np.where(mask == 1, tokens, np.random.default_rng(0).integers(0, 30522, (8, 128)))
        on_card = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()  # noqa: E731
        with torch.no_grad():
            clean = bert_embed(model, on_card(tokens), on_card(mask))
            dirty = bert_embed(model, on_card(noisy), on_card(mask))
        check(torch.equal(clean, dirty), "encoder: the padding's content moved an embedding")
        print("encoder: other ids in the padding -> the same embeddings, bit for bit", flush=True)
        bf16_rows = np.asarray(served["batch8"])
    finally:
        app.shutdown()

    app = boot_encoder({**ENCODER_ENV, "MODEL_NAME": "bert-base", "MODEL_QUANT": "int8"})
    try:
        dev = app.container.tpu
        rows, _, _ = embed_rows(app.http_port, {"input": batch8})
        out["int8_weight_bytes"] = dev.runner.model.weight_bytes()
        out["int8_max_abs"] = float(np.abs(np.asarray(rows) - bf16_rows).max())
        print(f"encoder int8: weights {out['int8_weight_bytes']:,} bytes; against bf16 max|d| "
              f"{out['int8_max_abs']:.4f} (bound {QUANT_EMBED_TOL}) [{card}]", flush=True)
        check(out["int8_max_abs"] < QUANT_EMBED_TOL, "encoder int8: too far from bf16")
    finally:
        app.shutdown()

    torch.backends.cuda.matmul.allow_tf32 = False
    app = boot_encoder({**ENCODER_ENV, "MODEL_NAME": "mlp"})
    try:
        dev = app.container.tpu
        x = np.random.default_rng(1).standard_normal((8, 64)).astype(np.float32)
        results, wall = concurrently(app.http_port, [{"x": row.tolist()} for row in x], "/infer")
        for status, data, _, _ in results:
            check(status == 200, f"mlp: /infer {status} {data}")
        got = np.asarray([data["data"]["y"] for _, data, _, _ in results])
        cpu = MLP(dev.runner.cfg, "cpu")
        cpu.load_state_dict(dev.runner.model.state_dict())
        want = mlp_forward(cpu, torch.from_numpy(x)).numpy()
        out["mlp_max_abs"] = float(np.abs(got - want).max())
        status, data, _, _ = post(app.http_port, {"x": [0.0] * 63}, path="/infer")
        want_400 = "'1' invalid parameter input must have 64 features"
        check(status == 400 and data["error"]["message"] == want_400,
              f"mlp: a 63-wide input gave {status} {data}")
        print(f"mlp: 8 concurrent /infer in {wall * 1e3:.1f} ms, y vs the CPU max|d| "
              f"{out['mlp_max_abs']:.3e} (tol {MLP_TOL}, TF32 off); 63 features -> 400 "
              f"[{card}]", flush=True)
        check(out["mlp_max_abs"] <= MLP_TOL, "mlp: the card's y differs from the CPU's")
    finally:
        app.shutdown()
    return out


# -- phase 6/7: the backward kernels ----------------------------------------------

def bwd_case(torch, flash, gen, b, sq, skv, hq, hkv, d, dtype, offsets, kv_lens, causal=True,
             poison=True, kv=None):
    """Inputs of one backward call: q, k, v (poisoned past kv_len, see
    ``make_case``; ``kv`` = (k, v) given instead, e.g. a cache slice), dO,
    and the forward kernel's out and lse."""
    q, k, v, offs, lens = make_case(torch, gen, b, sq, skv, hq, hkv, d, dtype, offsets, kv_lens,
                                    poison=poison)
    if kv is not None:
        k, v = kv
    do = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    return {"q": q, "k": k, "v": v, "offs": offs, "lens": lens, "out": out, "lse": lse,
            "do": do, "causal": causal}


def compare_bwd(torch, flash, name, c):
    """Both backward kernels against their plain version, each on the
    variant its shape picks, and bit-identical across two launches. ->
    (max |dq err|, max |dk, dv err|, (dq, dk, dv), variant)."""
    scale = c["q"].shape[-1] ** -0.5
    args = (c["q"], c["k"], c["v"], c["offs"], c["lens"], c["out"], c["lse"], c["do"],
            c["causal"], scale)
    before = (flash.launches_dq_sm90.value, flash.launches_dkv_sm90.value)
    got = flash._launch_bwd(*args)
    torch.cuda.synchronize()
    ran = ["sm90" if c_.value > b_ else "mma"
           for c_, b_ in zip((flash.launches_dq_sm90, flash.launches_dkv_sm90), before)]
    check(ran[0] == flash.dq_variant(c["q"]), f"{name}: dQ ran the {ran[0]} variant")
    check(ran[1] == flash.dkv_variant(c["q"]), f"{name}: dK/dV ran the {ran[1]} variant")
    check(ran[0] == ran[1], f"{name}: dQ ran {ran[0]}, dK/dV {ran[1]}")
    variant = ran[0]
    again = flash._launch_bwd(*args)
    same = all(torch.equal(a, g) for a, g in zip(again, got))
    want = flash.flash_attention_bwd_ref(*args)
    atol, rtol = BWD_TOL[str(c["q"].dtype).split(".")[-1]]
    errs, ok = [], True
    for a, w in zip(got, want):
        a, w = a.float(), w.float()
        err = (a - w).abs()
        ok = ok and bool(torch.isfinite(a).all()) and bool((err <= atol + rtol * w.abs()).all())
        errs.append(float(err.max()))
    tail = (torch.arange(c["k"].shape[1], device="cuda")[None, :] >= c["lens"][:, None])
    tail_zero = all(bool((g[tail] == 0).all()) for g in got[1:])
    print(f"bwd-kernel-vs-plain {name} [dQ, dK/dV {variant}]: max|err| dq {errs[0]:.3e} dk "
          f"{errs[1]:.3e} dv {errs[2]:.3e} tol {atol} + {rtol}*|ref|, dK/dV past kv_len "
          f"exactly 0: {tail_zero}, bit-identical twice: {same} -> "
          f"{'ok' if ok and tail_zero and same else 'FAIL'}", flush=True)
    check(ok, f"{name}: backward kernels disagree with their plain version")
    check(tail_zero, f"{name}: dK/dV rows past kv_len are not exactly 0")
    check(same, f"{name}: dQ or dK/dV differ between two launches")
    return errs[0], max(errs[1:]), got, variant


def visible_pairs(c) -> int:
    b, sq = c["q"].shape[:2]
    lens = [int(x) for x in c["lens"].tolist()]
    offs = [int(x) for x in c["offs"].tolist()]
    pairs = 0
    for bi in range(b):
        for r in range(sq):
            vis = min(lens[bi], offs[bi] + r + 1) if c["causal"] else lens[bi]
            pairs += max(vis, 0)
    return pairs


def bwd_bound(c, which: str):
    """Least time of one backward kernel on the card: each input read once
    (K/V up to kv_len), each output written once, over HBM rate; 6 (dQ) or
    8 (dK/dV) x D x Hq operations per visible (query, key) pair over the
    peak of the inputs' type."""
    q, k = c["q"], c["k"]
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    es = q.element_size()
    kv = sum(int(x) for x in c["lens"].tolist()) * hkv * d * es
    reads = 2 * q.numel() * es + 2 * kv + 2 * b * hq * sq * 4 + 2 * b * 4
    writes = q.numel() * es if which == "dq" else 2 * kv
    flops = (6 if which == "dq" else 8) * d * hq * visible_pairs(c)
    t_bytes = (reads + writes) / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_backward_ms(torch, c, iters):
    """scaled_dot_product_attention's backward at the same shape (causal,
    GQA), timed as forward + backward minus forward."""
    import torch.nn.functional as F

    from gofr_tpu_torch.timing import event_ms

    qt, kt, vt = (c[n].transpose(1, 2).detach().requires_grad_() for n in ("q", "k", "v"))
    g = c["do"].transpose(1, 2)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (qt, kt, vt), g)

    return event_ms(fwd_bwd, iters) - event_ms(fwd, iters)


def time_bwd(torch, flash, c, iters):
    """Phase 7 at the training shape: per kernel ms, bound, plain ms (the
    whole plain backward) and SDPA's backward; the forward kernel too."""
    from gofr_tpu_torch.timing import event_ms

    scale = c["q"].shape[-1] ** -0.5
    do = c["do"].contiguous()
    dvec = (do.float() * c["out"].float()).sum(-1).transpose(1, 2).contiguous()
    kargs = (c["q"], c["k"], c["v"], do, c["lse"], dvec, c["offs"], c["lens"], c["causal"], scale)
    dq_ms = event_ms(lambda: flash.launch_dq(*kargs), iters)
    dq_mma_ms = event_ms(lambda: flash.launch_dq(*kargs, variant="mma"), iters)
    dkv_ms = event_ms(lambda: flash.launch_dkv(*kargs), iters)
    dkv_mma_ms = event_ms(lambda: flash.launch_dkv(*kargs, variant="mma"), iters)
    plain_ms = event_ms(lambda: flash.flash_attention_bwd_ref(
        c["q"], c["k"], c["v"], c["offs"], c["lens"], c["out"], c["lse"], c["do"], c["causal"],
        scale), 3)
    library_ms = sdpa_backward_ms(torch, c, iters)
    rows = {}
    for name, ms, mma_ms, variant in (("dq", dq_ms, dq_mma_ms, flash.dq_variant(c["q"])),
                                      ("dkv", dkv_ms, dkv_mma_ms, flash.dkv_variant(c["q"]))):
        bound_ms, bound_by = bwd_bound(c, name)
        rows[name] = {"variant": variant, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms, "mma_ms": mma_ms}
        print(f"bwd-kernel-time {name} training shape {tuple(c['q'].shape)}: "
              f"{json.dumps(rows[name])}", flush=True)
    fwd = time_shape(torch, flash, "training forward", (c["q"], c["k"], c["v"], c["offs"],
                                                         c["lens"]), iters, is_causal=True)
    no_host_sync(torch, "dQ", lambda: flash.launch_dq(*kargs))
    return rows, fwd


# -- phase 8: f32 training parity ----------------------------------------------------

def f32_training(torch, flash):
    import numpy as np

    from gofr_tpu_torch.models.llama import TINY
    from gofr_tpu_torch.models.transformer import Transformer
    from gofr_tpu_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt_card, opt_cpu = trainer.default_optimizer(1e-3), trainer.default_optimizer(1e-3)
    card = trainer.init_train_state(TINY, opt_card, device="cuda", seed=11)
    plain = Transformer(TINY, "cpu")
    plain.load_state_dict(card["model"].state_dict())
    cpu = trainer.init_train_state_from(plain, opt_cpu)
    step_card = trainer.make_train_step(TINY, opt_card)
    step_cpu = trainer.make_train_step(TINY, opt_cpu)
    rng = np.random.default_rng(11)
    tol = 1e-4  # relative: f32 sums in other orders, three Adam steps
    totals = [0, 0, 0]
    for i in range(3):
        tokens = rng.integers(0, TINY.vocab_size, (2, 33)).astype("int32")
        for c in (flash.launches, flash.launches_dq, flash.launches_dkv):
            c.reset()
        card, m_card = step_card(card, tokens)
        loss_card = float(m_card["loss"])
        counts = [c.value for c in (flash.launches, flash.launches_dq, flash.launches_dkv)]
        totals = [a + b for a, b in zip(totals, counts)]
        cpu, m_cpu = step_cpu(cpu, tokens)
        loss_cpu = float(m_cpu["loss"])
        rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        print(f"f32-train step {i + 1}: loss card {loss_card:.7f} cpu {loss_cpu:.7f} "
              f"(rel {rel:.2e}, tol {tol}); grad_norm card {float(m_card['grad_norm']):.6f} "
              f"cpu {float(m_cpu['grad_norm']):.6f}; launches fwd/dq/dkv {counts}", flush=True)
        check(rel <= tol, "f32 training: card and CPU losses differ")
        n = TINY.n_layers
        check(counts[0] >= 2 * n and counts[1] >= n and counts[2] >= n,
              "f32 training: a layer's attention missed a kernel")
    return totals


# -- phase 9: train llama3-8b ---------------------------------------------------------

def train_llama(torch, flash, card: str):
    import numpy as np

    from gofr_tpu_torch.models.llama import LLAMA3_8B
    from gofr_tpu_torch.training import trainer
    from gofr_tpu_torch.training.data import TokenDataset, prefetch_to_device

    cfg, seq, steps = LLAMA3_8B, 2049, 4
    t0 = time.perf_counter()
    opt = trainer.default_optimizer(3e-4)
    state = trainer.init_train_state(cfg, opt, device="cuda", seed=0)
    n_params = sum(p.numel() for p in state["model"].parameters())
    step_fn = trainer.make_train_step(cfg, opt, remat=True)
    corpus = np.random.default_rng(0).integers(0, cfg.vocab_size, 1 << 20, dtype=np.uint32)
    batch = TokenDataset(corpus, seq_len=seq, batch_size=1, seed=0).batch(0)
    torch.cuda.synchronize()
    print(f"train: llama3-8b {n_params / 1e9:.3f} B parameters, optimizer state built in "
          f"{time.perf_counter() - t0:.1f}s, memory "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times, totals = [], [], [], [0] * 6
    for i, tokens in enumerate(prefetch_to_device(iter([batch] * steps), size=2, device="cuda")):
        counters = (flash.launches, flash.launches_dq, flash.launches_dkv,
                    flash.launches_fwd_sm90, flash.launches_dq_sm90, flash.launches_dkv_sm90)
        for c in counters:
            c.reset()
        t = time.perf_counter()
        state, m = step_fn(state, tokens)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        counts = [c.value for c in counters]
        totals = [a + b for a, b in zip(totals, counts)]
        losses.append(loss)
        norms.append(norm)
        print(f"train step {i + 1}: loss {loss:.4f} grad_norm {norm:.4f} "
              f"{times[-1] * 1e3:.1f} ms, launches fwd/dq/dkv/fwd sm90/dq sm90/dkv sm90 {counts}",
              flush=True)
        check(counts[1] >= cfg.n_layers and counts[2] >= cfg.n_layers and
              counts[0] >= 2 * cfg.n_layers, "train: a layer's attention missed a kernel")
        # S = 2048, bf16, D = 128: every forward, dQ and dK/dV call is sm90
        check(counts[3] == counts[0] and counts[4] == counts[1] and counts[5] == counts[2],
              "train: a forward, dQ or dK/dV call missed its sm90 variant")
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)), "train: non-finite loss or norm")
    check(losses[-1] < losses[0], "train: the loss did not fall")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    tokens_per_step = seq - 1
    pairs = tokens_per_step * (tokens_per_step + 1) // 2
    attn_flops = 12 * cfg.head_dim * cfg.n_heads * pairs * cfg.n_layers  # fwd + bwd, no recompute
    mfu = (6 * n_params * tokens_per_step + attn_flops) / step_s / PEAK_FLOPS["bfloat16"]
    metrics = {"step_ms": step_s * 1e3, "tokens_per_s": tokens_per_step / step_s, "mfu": mfu,
               "peak_memory_gib": peak / 2**30, "losses": losses, "launches": totals}
    print(f"train-metrics [{card}]: {json.dumps(metrics)}", flush=True)
    return metrics


def print_build(flash, built) -> None:
    """Each redesigned kernel's registers, spills and shared memory, from
    ptxas (-v) and the library (dynamic shared memory is set at launch);
    a kernel that spills fails the run."""
    report = flash.build_report(built)
    check(set(report) == set(flash.SMEM_QUERIES), f"ptxas reported {sorted(report)}")
    for name, r in report.items():
        print(f"  ptxas {name}: {r['ptxas']}; dynamic shared memory {r['smem']} bytes", flush=True)
        check(not r["spills"], f"{name} spills registers")


def forward_phases(torch, flash, gen):
    """Phases 2 and 3. -> (max errors by variant, timing rows by shape)."""
    bf16, f32, nan = torch.bfloat16, torch.float32, float("nan")
    errs = {"sm90": [], "decode": [], "mma": []}
    prefill = make_case(torch, gen, 2, 512, 1024, 32, 8, 128, bf16, [0, 300], [512, 812],
                        poison=True)
    decode = make_case(torch, gen, 4, 1, 2048, 32, 8, 128, bf16, [0, 699, 1499, 2047],
                       [1, 700, 1500, 2048])
    # run_batch pads the batch to 4 rows and runs the whole bucket against
    # the fresh 2048-slot cache; solo decode runs one row
    served = {
        "served prefill bf16 B=4 bucket 1024": served_case(torch, gen, 4, 1024, 0, 1024),
        "served prefill bf16 B=4 bucket 128": served_case(torch, gen, 4, 128, 0, 128),
        "served decode bf16 B=1 kv_len 616": served_case(torch, gen, 1, 1, 615, 616),
        "served decode bf16 B=1 kv_len 1800": served_case(torch, gen, 1, 1, 1799, 1800),
        "served decode bf16 B=1 kv_len 1000 NaN tail": served_case(torch, gen, 1, 1, 999, 1000,
                                                                   poison=(nan, nan)),
        "cache slice bf16 B=2 Sq=256 NaN tail": served_case(torch, gen, 2, 256, 44, 300,
                                                            poison=(nan, nan)),
        # phase 10's chunked prefill (slices of 512 at offsets 512 and
        # 1024, the last one ragged) and a prefix-cache tail (bucket 64
        # after 256 shared tokens), each one row of a 2048-slot cache
        "chunk slice bf16 B=1 Sq=512 offset 512": served_case(torch, gen, 1, 512, 512, 1024,
                                                              poison=(nan, nan)),
        "chunk slice bf16 B=1 Sq=512 offset 1024 kv_len 1500": served_case(
            torch, gen, 1, 512, 1024, 1500, poison=(nan, nan)),
        "prefix tail bf16 B=1 Sq=64 offset 256 kv_len 312": served_case(
            torch, gen, 1, 64, 256, 312, poison=(nan, nan)),
    }
    poisoned = {"prefill bf16 B=2 Sq=512 ragged poisoned": prefill,
                "ragged 300/1024 NaN tail": make_case(torch, gen, 2, 300, 1024, 32, 8, 128, bf16,
                                                      [0, 500], [300, 800], poison=nan),
                **served}
    for name, case in poisoned.items():
        out, _, _ = compare(torch, flash, name, case, errs=errs)
        check_tail_invisible(torch, flash, name, case, out)
    plain = {
        "training shape bf16 B=1 S=2048": make_case(torch, gen, 1, 2048, 2048, 32, 8, 128, bf16,
                                                     [0], [2048]),
        "tiles cut bf16 130/200": make_case(torch, gen, 2, 130, 200, 32, 8, 128, bf16, [0, 70],
                                            [130, 200]),
        "GQA groups 1": make_case(torch, gen, 1, 256, 256, 8, 8, 128, bf16, [0], [256]),
        "GQA groups 2": make_case(torch, gen, 1, 256, 256, 16, 8, 128, bf16, [0], [256]),
        "GQA groups 8": make_case(torch, gen, 1, 256, 256, 32, 4, 128, bf16, [0], [256]),
        "decode bf16 B=4 cache 2048": decode,
        "decode GQA groups 1": make_case(torch, gen, 2, 1, 512, 8, 8, 128, bf16, [99, 400],
                                         [100, 401]),
        "decode GQA groups 2": make_case(torch, gen, 2, 1, 512, 16, 8, 128, bf16, [99, 400],
                                         [100, 401]),
        "decode GQA groups 8": make_case(torch, gen, 2, 1, 512, 32, 4, 128, bf16, [99, 400],
                                         [100, 401]),
        "decode Sq=4 (the largest the variant packs at groups 4)": make_case(
            torch, gen, 2, 4, 512, 32, 8, 128, bf16, [96, 290], [100, 294]),
        "prefill f32 D=16": make_case(torch, gen, 2, 40, 128, 4, 2, 16, f32, [0, 20], [40, 60]),
    }
    for name, case in plain.items():
        compare(torch, flash, name, case, errs=errs)
    # teacher-forced scoring's call (phase 11): B=1, Sq=Skv=512 (the largest
    # bucket), no cache, causal; the full bucket, and 300 real tokens in it
    # with other keys and values in the pad past them, which no real row may see
    scoring = make_case(torch, gen, 1, 512, 512, 32, 8, 128, bf16, [0], [512])
    _, _, e_full = compare(torch, flash, "scoring bucket 512 bf16 B=1 Sq=Skv=512", scoring,
                           errs=errs)
    q, k, v, offs, lens = scoring
    pad_k, pad_v = k.clone(), v.clone()
    for t in (pad_k, pad_v):
        t[:, 300:] = torch.randn(t[:, 300:].shape, device="cuda", generator=gen).to(bf16)
    out, _, e_pad = compare(torch, flash, "scoring 300 real tokens in bucket 512, other pad",
                            (q, pad_k, pad_v, offs, lens), errs=errs)
    clean, _ = flash.flash_attention_fwd(q, k, v, True, offs, lens)
    check(torch.equal(out[:, :300], clean[:, :300]), "scoring: the pad moved a real row's output")
    print("scoring: the 300 real rows bit-identical whatever the pad holds -> ok", flush=True)
    for name, sq in (("decode bf16 kv_lens=0 row", 1), ("prefill bf16 kv_lens=0 row", 64)):
        case = make_case(torch, gen, 2, sq, 2048, 32, 8, 128, bf16, [0, 899], [0, 900])
        out, lse, _ = compare(torch, flash, name, case, errs=errs)
        check(bool((out[0] == 0).all()) and bool(torch.isinf(lse[0]).all()),
              f"{name}: not zero/+inf")

    shapes = {
        "served_prefill_1024": time_shape(torch, flash, "served prefill bucket 1024",
                                          served["served prefill bf16 B=4 bucket 1024"], 20),
        "served_prefill_128": time_shape(torch, flash, "served prefill bucket 128",
                                         served["served prefill bf16 B=4 bucket 128"], 50),
        "served_decode": time_shape(torch, flash, "served decode",
                                    served["served decode bf16 B=1 kv_len 616"], 50),
        "served_decode_long": time_shape(torch, flash, "served decode long cache",
                                         served["served decode bf16 B=1 kv_len 1800"], 50),
        "prefill": time_shape(torch, flash, "prefill", prefill, 20),
        "decode": time_shape(torch, flash, "decode", decode, 50),
        "prefill_f32": time_shape(torch, flash, "tiny model prefill f32", plain["prefill f32 D=16"],
                                  50),
        "scoring_512": {**time_shape(torch, flash, "scoring bucket 512", scoring, 50,
                                     is_causal=True, device=True),
                        "max_abs_err": max(e_full, e_pad)},
    }
    no_host_sync(torch, "decode", lambda: flash.flash_attention_fwd(*decode[:3], True, *decode[3:]))
    return errs, shapes


def backward_phases(torch, flash, gen):
    """Phases 6 and 7. -> (dQ errors, dK/dV errors by variant, dQ and dK/dV
    timing rows, the forward's timing row at the training shape)."""
    bf16, f32, nan = torch.bfloat16, torch.float32, float("nan")
    # K/V one layer of a [2, 2, 2048, 8, 128] cache, NaN past kv_len
    lens_ = [300, 800]
    caches = [torch.randn(2, 2, 2048, 8, 128, device="cuda", generator=gen).to(bf16)
              for _ in "kv"]
    for cache in caches:
        for i, n in enumerate(lens_):
            cache[:, i, n:] = nan
    train_case = bwd_case(torch, flash, gen, 1, 2048, 2048, 32, 8, 128, bf16, [0], [2048])
    bwd_cases = {
        "training shape bf16 B=1 S=2048 causal": train_case,
        "ragged GQA bf16 B=2 Sq=300 Skv=1024 poisoned": bwd_case(
            torch, flash, gen, 2, 300, 1024, 32, 8, 128, bf16, [0, 500], [300, 800]),
        "ragged GQA bf16 Sq=300, K/V a cache slice with a NaN tail": bwd_case(
            torch, flash, gen, 2, 300, 2048, 32, 8, 128, bf16, [0, 500], lens_, poison=False,
            kv=(caches[0][-1], caches[1][-1])),
        "tiles cut bf16 130/200": bwd_case(torch, flash, gen, 2, 130, 200, 32, 8, 128, bf16,
                                           [0, 70], [130, 200]),
        "GQA groups 1": bwd_case(torch, flash, gen, 1, 256, 256, 8, 8, 128, bf16, [0], [256]),
        "GQA groups 2": bwd_case(torch, flash, gen, 1, 256, 256, 16, 8, 128, bf16, [0], [256]),
        "GQA groups 8": bwd_case(torch, flash, gen, 1, 256, 256, 32, 4, 128, bf16, [0], [256]),
        "bf16 kv_lens=0 row": bwd_case(torch, flash, gen, 2, 64, 128, 32, 8, 128, bf16,
                                       [0, 64], [0, 128]),
        "non-causal bf16 B=1 S=512": bwd_case(torch, flash, gen, 1, 512, 512, 32, 8, 128, bf16,
                                              [0], [512], causal=False),
        "f32 D=16 tiny shapes": bwd_case(torch, flash, gen, 2, 40, 128, 4, 2, 16, f32,
                                         [0, 20], [40, 60]),
    }
    dq_errs, dkv_errs = {"sm90": [], "mma": []}, {"sm90": [], "mma": []}
    for name, c in bwd_cases.items():
        e_dq, e_dkv, grads, variant = compare_bwd(torch, flash, name, c)
        dq_errs[variant].append(e_dq)
        dkv_errs[variant].append(e_dkv)
        if "kv_lens=0" in name:
            check(all(bool((g[0] == 0).all()) for g in grads), "kv_lens=0 row: grads not exactly 0")
    bwd_rows, fwd_row = time_bwd(torch, flash, train_case, 20)
    return dq_errs, dkv_errs, bwd_rows, fwd_row


def kernels_line(errs, shapes, served, train, tiny, dq_errs, dkv_errs, bwd_rows, default,
                 pool_row, openai, deploy, spec, loras, overload_run) -> dict:
    """The kernels of the main path (serving, training) with their counts
    from its runs and the numbers phases 3, 7 and 10 measured. The mma
    forward is on the tiny f32 model's path (phases 4 and 8) alone; its
    count is from those runs. At decode the kernel's ``ms`` and
    ``library_ms`` are device times (CUDA graph), the CUDA-event times
    beside them. The decode variant at the pool's shape (phase 10) has its
    own entry, with its launches from phase 10's run, and the sm90 variant
    at teacher-forced scoring's shape (bucket 512) its own, with its
    launches from phase 11's scoring requests (a short kernel: its ``ms``
    and ``library_ms`` are device times too). Phase 12's deployment (the
    quantized models, the f8 cache, penalties, MODEL_PATH) runs both
    variants at phase 10's shapes: its served requests' decode launches
    stand on an entry with the pool shape's numbers, their prefill
    launches on one with the ragged B=2 Sq=512 prefill's. With an f8 cache the kernel reads the
    bf16 upcast, so its shapes and times are the same. Phase 13's served
    speculative requests have an entry per route of their verifies: the
    decode variant at widths 2 and 4 (the pool's verifies and the solo
    sampled ones of k = 4; the numbers of the pool's [8, 4] verify), the
    mma kernel at width 5 (the solo verify of k + 1 = 5 and the pool's
    widest; the numbers of the pool's [8, 5] verify, the solo B=1 row
    beside them), device times as at decode; and one for the draft's
    chunks, B=1 decode steps, with the served B=1 decode shape's numbers
    (kv_len 616). Phase 14's (LoRA) launches join the rows of the kernels
    they ran on, each also under ``lora_launches``: the adapter training's
    forward, dQ and dK/dV calls (LoRA and QLoRA, all sm90) and its served
    requests' prefill (sm90) and pooled decode (the decode variant). Phase
    18's (overload and failure) launches join the sm90 row (its prefills and
    the resume's re-prefill) and the pool row (its pooled decode), each also
    under ``overload_launches``."""
    over = overload_run["launches"]
    fwd = {"route": "cuda", "source": "gofr_tpu_torch/csrc/flash_fwd.cu",
           "replaces": "gofr_tpu/ops/flash.py:224"}
    bwd = {"route": "cuda", "source": "gofr_tpu_torch/csrc/flash_bwd.cu"}
    sm90_train = train["launches"][3]
    lora_train = {k: sum(t["launches"][k] for t in loras["train"].values())
                  for k in ("fwd_sm90", "dq_sm90", "dkv_sm90")}
    lora_served = loras["served"]
    long = shapes["served_decode_long"]
    decode_row = {**long, "ms": long["device_ms"], "event_ms": long["ms"],
                  "library_ms": long["library_device_ms"], "library_event_ms": long["library_ms"]}
    score = shapes["scoring_512"]
    return {"kernels": [
        {"name": "flash_fwd_sm90", **fwd,
         "launches": served["sm90"] + sm90_train + lora_train["fwd_sm90"] + lora_served["sm90"]
         + over["sm90"],
         "serve_launches": served["sm90"], "training_launches": sm90_train,
         "overload_launches": over["sm90"],
         "lora_launches": {"train": lora_train["fwd_sm90"], "served": lora_served["sm90"]},
         "max_abs_err": max(errs["sm90"]), **shapes["training_forward"],
         "by_shape": {k: v for k, v in shapes.items() if v["variant"] == "sm90"}},
        {"name": "flash_fwd_decode", **fwd, "launches": served["decode"] + lora_served["decode"],
         "lora_launches": {"served": lora_served["decode"]},
         "max_abs_err": max(errs["decode"]), **decode_row,
         "by_shape": {k: v for k, v in shapes.items() if v["variant"] == "decode"}},
        {"name": "flash_fwd_decode (pool, 8 slots)", **fwd,
         "launches": default["decode"] + over["decode"], "overload_launches": over["decode"],
         "launches_per_chunk": default["per_chunk"], "max_abs_err": pool_row["max_abs_err"],
         **pool_row, "ms": pool_row["device_ms"], "event_ms": pool_row["ms"],
         "library_ms": pool_row["library_device_ms"], "library_event_ms": pool_row["library_ms"]},
        {"name": "flash_fwd_sm90 (scoring, bucket 512)", **fwd,
         "launches": openai["score_launches"], **score,
         "ms": score["device_ms"], "event_ms": score["ms"],
         "library_ms": score["library_device_ms"], "library_event_ms": score["library_ms"]},
        {"name": "flash_fwd_decode (deployment, phase 12)", **fwd, "launches": deploy["decode"],
         "max_abs_err": pool_row["max_abs_err"], **pool_row, "ms": pool_row["device_ms"],
         "event_ms": pool_row["ms"], "library_ms": pool_row["library_device_ms"],
         "library_event_ms": pool_row["library_ms"]},
        {"name": "flash_fwd_sm90 (deployment prefill, phase 12)", **fwd,
         "launches": deploy["sm90"], "max_abs_err": max(errs["sm90"]), **shapes["prefill"]},
        {"name": "flash_fwd_decode (verify, widths 2 and 4, phase 13)", **fwd,
         "launches": spec["launches"]["verify_decode"],
         "max_abs_err": spec["max_abs_err"]["decode"],
         **device_row(spec["kernel_rows"]["verify B=8 Sq=4"]),
         "width_2": device_row(spec["kernel_rows"]["verify B=8 Sq=2"])},
        {"name": "flash_fwd_mma (verify, width 5, phase 13)", **fwd,
         "launches": spec["launches"]["verify_mma"],
         "pool_width_5_launches": spec["launches"]["pool_width_5"],
         "max_abs_err": spec["max_abs_err"]["mma"],
         **device_row(spec["kernel_rows"]["verify B=8 Sq=5"]),
         "solo_B1": device_row(spec["kernel_rows"]["verify B=1 Sq=5 kv_len 1800"])},
        {"name": "flash_fwd_decode (draft steps, phase 13)", **fwd,
         "launches": spec["launches"]["draft"], "max_abs_err": max(errs["decode"]),
         **device_row(shapes["served_decode"])},
        {"name": "flash_fwd_mma", **fwd, "launches": tiny, "path": "tiny f32 model (phases 4, 8)",
         "max_abs_err": max(errs["mma"]), **shapes["prefill_f32"]},
        {"name": "flash_bwd_dq", **bwd, "replaces": "gofr_tpu/ops/flash.py:477",
         "launches": train["launches"][4] + lora_train["dq_sm90"],
         "lora_launches": {"train": lora_train["dq_sm90"]}, "max_abs_err": max(dq_errs["sm90"]),
         "mma_max_abs_err": max(dq_errs["mma"]),
         "shape": "B=1 S=2048 Hq=32 Hkv=8 D=128 bf16 causal", **bwd_rows["dq"]},
        {"name": "flash_bwd_dkv", **bwd, "replaces": "gofr_tpu/ops/flash.py:521",
         "launches": train["launches"][5] + lora_train["dkv_sm90"],
         "lora_launches": {"train": lora_train["dkv_sm90"]},
         "max_abs_err": max(dkv_errs["sm90"]),
         "mma_max_abs_err": max(dkv_errs["mma"]),
         "shape": "B=1 S=2048 Hq=32 Hkv=8 D=128 bf16 causal", **bwd_rows["dkv"]},
    ]}


def encoder_entry(err: float, rows: dict, served: dict) -> dict:
    """The mma forward at bert-base's attention (phase 15's path): its
    launches from phase 15's served requests, its numbers from phase 3's
    B = 8 row (device times as ``ms`` and ``library_ms``), the other
    encoder shapes beside them."""
    return {"name": "flash_fwd_mma (encoder, bert-base, phase 15)", "route": "cuda",
            "source": "gofr_tpu_torch/csrc/flash_fwd.cu", "replaces": "gofr_tpu/ops/flash.py:224",
            "launches": served["launches"], "launches_per_dispatch": served["per_dispatch"],
            "max_abs_err": err, **device_row(rows["encoder_B8"]),
            "by_shape": {k: device_row(v) for k, v in rows.items() if k != "encoder_B8"}}


def device_row(row: dict) -> dict:
    """A timing row with the device times as ``ms`` and ``library_ms``
    (the CUDA-event times beside them)."""
    return {**row, "ms": row["device_ms"], "event_ms": row["ms"],
            "library_ms": row["library_device_ms"], "library_event_ms": row["library_ms"]}


def repeat_serve_train(torch, flash, card: str, n: int) -> dict:
    """``--repeat-serve-train N``: phase 10, the pool's decode kernel and
    phase 9, N times in one process, on a fresh llama3-8b each time (phase
    5's shape: MODEL_MAX_SEQ 2048, seed 0), under CUDA_LAUNCH_BLOCKING=1 and
    the debug build (every launch waits for its kernel, and the kernels'
    device-side index checks are compiled in), so a device fault stops the
    launch that made it, with the check that failed. -> a summary."""
    import dataclasses

    from gofr_tpu_torch.models.llama import LLAMA3_8B
    from gofr_tpu_torch.models.transformer import Transformer

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cfg = dataclasses.replace(LLAMA3_8B, max_seq=2048)
    seconds = []
    for i in range(n):
        t0 = time.perf_counter()
        model = Transformer.random(cfg, "cuda", seed=0)
        serve_default(torch, flash, card, model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        pool_decode_kernel(torch, flash, gen)
        train_llama(torch, flash, card)
        gc.collect()
        torch.cuda.empty_cache()
        seconds.append(time.perf_counter() - t0)
        print(f"repeat {i + 1}/{n}: phase 10, the pool decode kernel and phase 9 clean in "
              f"{seconds[-1]:.1f}s, memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
              flush=True)
    return {"clean_repeats": n, "seconds": seconds, "launch_blocking": True,
            "debug_build": flash.debug_build()}


# one tree's phases 5 and 10 in a child process (``--serve-ab``): only
# functions both the parent's chip_smoke.py and this one have
AB_CHILD = """
import gc, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
cs.SCRAPE_8 = sys.argv[1] == "on"  # read by this tree's phase 10 only
from gofr_tpu_torch.ops import flash
flash.build()
card = cs.card_line()
ttfts = []
post = cs.post
def timed_post(port, body, stream=False, path="/v1/completions"):
    out = post(port, body, stream, path)
    if stream:
        ttfts.append(out[2])
    return out
cs.post = timed_post
served, model = cs.serve(torch, flash, card)
gc.collect(); torch.cuda.empty_cache()
ttfts.clear()  # phase 10's streams: 1, then 4, then 8 at once
default = cs.serve_default(torch, flash, card, model)
groups = {1: ttfts[0:1], 4: ttfts[1:5], 8: ttfts[5:13]}
m = default["metrics"]
print("AB " + json.dumps({"card": card, "decode_launches": default["decode"],
      "per_chunk": default["per_chunk"], "phase5": served,
      "aggregate_tokens_per_s": m["aggregate_tokens_per_s"], "tpot_ms": m["tpot_ms"],
      "ttft_ms": {k: sum(v) / len(v) * 1e3 for k, v in groups.items()},
      "chunk_ms": m["chunk_ms"]}), flush=True)
"""


def host_cost(n: int = 2000, blocks: int = 10) -> dict:
    """The host time this tree adds to a request and to a pool chunk,
    each measured alone on this host: the middleware chain (``chain_us``:
    a trivial sync handler at /v1/completions dispatched in-process with
    the App's chain and through a bare Router, in alternating blocks of
    ``n``, the access lines written to a file), the device's per-request
    metric updates (``request_metrics_us``: the request counter, a TTFT
    observation, a token count) and a chunk's (``chunk_metrics_us``: the
    slot gauge and the decode token count). Medians over the blocks."""
    import asyncio
    import statistics
    import tempfile

    import gofr_tpu_torch
    from gofr_tpu_torch.handler import make_endpoint
    from gofr_tpu_torch.http.request import Request
    from gofr_tpu_torch.http.router import Router

    for key in ("MODEL_NAME", "TPU_ENABLED", "TPU_BOOT"):
        os.environ.pop(key, None)
    os.environ["HTTP_PORT"] = str(free_port())
    app = gofr_tpu_torch.new()

    def handler(ctx):
        return "x"

    app.get("/v1/completions", handler)
    bare = Router()
    bare.add("GET", "/v1/completions", make_endpoint(handler, app.container))
    arms = {"chain": app.router.dispatcher(), "bare": bare.dispatcher()}

    async def per_request_us(dispatch) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            request = Request("GET", "/v1/completions", {"user-agent": "smoke"}, b"",
                              "127.0.0.1")
            response = await dispatch(request)
        check(response.status == 200, f"host cost: HTTP {response.status}")
        return (time.perf_counter() - t0) / n * 1e6

    times: dict = {"chain": [], "bare": []}
    try:
        with tempfile.TemporaryFile("w") as sink, contextlib.redirect_stdout(sink):
            for _ in range(blocks):
                for arm, dispatch in arms.items():
                    times[arm].append(asyncio.run(per_request_us(dispatch)))
    finally:
        app.shutdown()
    # the App's registry: its exemplar provider as in serving
    registry = app.container.metrics
    requests = registry.counter("gofr_tpu_requests_total", "", labels=("model", "op", "status"))
    ttft = registry.histogram("gofr_tpu_ttft_seconds", "", labels=("model", "op"))
    tokens = registry.counter("gofr_tpu_tokens_total", "", labels=("model", "op"))
    slots = registry.gauge("gofr_tpu_decode_slots_active", "")

    def per_call_us(fn) -> float:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        return (time.perf_counter() - t0) / n * 1e6

    def request_updates(i):
        requests.inc(model="llama3-8b", op="generate", status="ok")
        ttft.observe(0.08, model="llama3-8b", op="generate")
        tokens.inc(100, model="llama3-8b", op="prefill")

    def chunk_updates(i):
        slots.set(8)
        tokens.inc(256, model="llama3-8b", op="decode")

    request_us = statistics.median(per_call_us(request_updates) for _ in range(blocks))
    chunk_us = statistics.median(per_call_us(chunk_updates) for _ in range(blocks))
    chain, bare_us = statistics.median(times["chain"]), statistics.median(times["bare"])
    return {"requests_a_block": n, "blocks": blocks, "chain_dispatch_us": chain,
            "bare_dispatch_us": bare_us, "chain_us": chain - bare_us,
            "chain_blocks_us": times["chain"], "bare_blocks_us": times["bare"],
            "request_metrics_us": request_us, "chunk_metrics_us": chunk_us}


def serve_ab(parent: str) -> int:
    """Phases 5 and 10 from the parent tree ``parent`` and from this one,
    each run in its own process on the same card, in three arms taken in
    turns (parent, this without phase 10's /metrics scrapes, this with
    them, then back, three times); prints each run's ``AB`` line, each
    arm's median and range, and ``host_cost``."""
    import statistics

    here = os.path.dirname(os.path.abspath(__file__))
    arms = (("parent", parent, "off"), ("this", here, "off"), ("this+scrape", here, "on"))
    runs = []
    for label, tree, scrape_8 in (arms + arms[::-1]) * 3:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", AB_CHILD, scrape_8], cwd=tree,
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"serve-ab: the {label} run failed ({proc.returncode})", file=sys.stderr)
            return 1
        run = {"tree": label, "seconds": time.perf_counter() - t0, **json.loads(lines[-1][3:])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {}
    for label, _, _ in arms:
        mine = [r for r in runs if r["tree"] == label]
        summary[label] = {
            metric: {k: {"median": statistics.median(r[metric][k] for r in mine),
                         "min": min(r[metric][k] for r in mine),
                         "max": max(r[metric][k] for r in mine)} for k in ("1", "4", "8")}
            for metric in ("aggregate_tokens_per_s", "tpot_ms", "ttft_ms")}
        summary[label]["decode_launches"] = sorted({r["decode_launches"] for r in mine})
    print(json.dumps({"serve_ab": summary}), flush=True)
    proc = subprocess.run([sys.executable, "-c", "import json, chip_smoke as cs; "
                           "print('HC ' + json.dumps(cs.host_cost()))"],
                          cwd=here, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("HC ")]
    if proc.returncode != 0 or not lines:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        print(f"serve-ab: host_cost failed ({proc.returncode})", file=sys.stderr)
        return 1
    print(json.dumps({"host_cost": json.loads(lines[-1][3:]), "card": card_line()}), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeat-serve-train", type=int, default=0, metavar="N",
                        help="repeat phase 10 -> the pool decode kernel -> phase 9 N times "
                             "under CUDA_LAUNCH_BLOCKING=1 and the debug build, nothing else")
    parser.add_argument("--serve-ab", metavar="PARENT_TREE", default="",
                        help="phases 5 and 10 from PARENT_TREE and from this tree with and "
                             "without phase 10's /metrics scrapes, in turns, each in its own "
                             "process, and the chain's host cost alone; nothing else")
    args = parser.parse_args(argv)
    if args.repeat_serve_train:
        # read when CUDA starts and when the kernels build: set before either
        os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
        os.environ["FLASH_DEBUG_BUILD"] = "1"
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from gofr_tpu_torch.ops import flash
    except ImportError as e:
        print(f"chip_smoke: {e}: run it from a checkout of the repository, where "
              "gofr_tpu_torch/ lies beside it", file=sys.stderr)
        return 3

    if args.serve_ab:
        return serve_ab(args.serve_ab)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}", flush=True)

    t0 = time.perf_counter()
    built = flash.build()
    print(f"build: {built.path.name} in {time.perf_counter() - t0:.1f}s", flush=True)
    if args.repeat_serve_train:
        # the debug build's checks may cost registers: its spills are reported, not fatal
        for name, r in flash.build_report(built).items():
            print(f"  ptxas (debug build) {name}: {r['ptxas']}", flush=True)
        summary = repeat_serve_train(torch, flash, card, args.repeat_serve_train)
        print(json.dumps({"repeat_serve_train": summary}), flush=True)
        print(card, flush=True)
        return 0
    print_build(flash, built)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs, shapes = forward_phases(torch, flash, gen)
    encoder_err, encoder_rows = encoder_kernels(torch, flash, gen)
    torch.cuda.empty_cache()
    tiny = f32_path(torch, flash)
    served, model = serve(torch, flash, card)
    gc.collect()
    torch.cuda.empty_cache()
    default = serve_default(torch, flash, card, model)
    gc.collect()
    torch.cuda.empty_cache()
    openai = serve_openai(torch, flash, card, model)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 12 writes phase 5's weights here; phase 13 drafts from them
    ckpt = tempfile.mkdtemp(prefix="gofr_ckpt_")
    try:
        deploy = deployment(torch, flash, card, model, ckpt)
        gc.collect()
        torch.cuda.empty_cache()
        spec = speculation(torch, flash, card, model, ckpt, gen)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(not os.path.exists(ckpt), "model_path: the checkpoint directory is still there")
    gc.collect()
    torch.cuda.empty_cache()
    loras = multi_lora(torch, flash, card, model)
    gc.collect()
    torch.cuda.empty_cache()
    host_services(torch, flash, card, model)
    gc.collect()
    torch.cuda.empty_cache()
    observability(torch, flash, card, model)
    gc.collect()
    torch.cuda.empty_cache()
    overload_run = overload(torch, flash, card, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve: shut down, memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    pool_row = pool_decode_kernel(torch, flash, gen)

    dq_errs, dkv_errs, bwd_rows, shapes["training_forward"] = backward_phases(torch, flash, gen)
    torch.cuda.empty_cache()
    tiny += f32_training(torch, flash)[0]
    train = train_llama(torch, flash, card)
    gc.collect()
    torch.cuda.empty_cache()
    encoders = encoder_serving(torch, flash, card)

    kernels = kernels_line(errs, shapes, served, train, tiny, dq_errs, dkv_errs, bwd_rows,
                           default, pool_row, openai, deploy, spec, loras, overload_run)
    kernels["kernels"].insert(-2, encoder_entry(encoder_err, encoder_rows, encoders))
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)  # name, power limit as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
