#!/usr/bin/env python3
"""Drive gofr_tpu_torch on one NVIDIA GPU end to end.

    python3 chip_smoke.py        # from the repository root, one card
    python3 chip_smoke.py --repeat-serve-train N   # hunting a device fault (below)
    python3 chip_smoke.py --serve-ab PARENT_TREE   # phases 5 and 10 against a parent tree
    python3 chip_smoke.py --mesh-cards   # phases 21 and 22 over distinct cards (two or more)

Phases, each fatal on failure (no phase is skipped or caught):

1. build: compile every ``gofr_tpu_torch/csrc/*.cu`` (the flash forward and
   the backward's dQ and dK/dV kernels) with nvcc for sm_90a, in parallel,
   and print each redesigned kernel's registers, spills (there must be
   none) and shared memory;
2. kernel vs plain: the flash forward (three variants: sm90 for bf16 D=128
   or 64 and Sq >= 64, decode for bf16 D=128 Sq x groups <= 32 (one m16 row
   tile up to 16 rows, two past them), mma for the rest)
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
   the tiny model's f32 D=16 and a bf16 tail of 63 rows (mma's route),
   tolerances as in tests/test_flash.py (bf16
   2e-2, f32 2e-5, atol + rtol*|ref|); each case must run the variant its
   shape picks (the launch counters say which ran), and the decode variant
   must give the same bits twice; and at the encoder's attention (phase
   15): bert-base's 12 and bert-tiny's 2 heads of D=64, bf16, non-causal,
   B=8, S=128, ragged kv_lens with 1 and 128, K/V poisoned past kv_len
   (+-300, NaN), q/k/v strided views of one [B, S, 3, H, 64] product: each
   one launch of the sm90 forward's D = 64 instance (the counters say so),
   the tail invisible bit for bit, and the mma kernel forced through the
   override at the same cases, held the same way (phase 13 does so too at
   the verify shapes);
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
   ``gofr_tpu_ttft_seconds`` count equal the phase's requests; one
   prefill batch's pack of 8 x 512 (``pack_token_rows``, numpy) timed
   beside the native library's ``gofr_pack_rows`` (the JAX package's
   pack), the arrays equal;
10b. phase 10's server as a process (``python -m
   gofr_tpu_torch.devtools.replica_proc``, llama3-8b from phase 5's seed on
   the card) under ``GOFR_SANITIZE=1 GOFR_POOL_DEBUG=1``: phase 10's 8
   prompts as 8 concurrent streams of 32 greedy tokens, their ids against
   phase 10's (equal, or parting at a near tie); at the process's end the
   sanitizer's report (no lock-order cycle, no leaked thread; its hold
   warnings printed with their sites) and one ``[pool] chunk`` stderr line
   a pool chunk, their medians, TPOT beside phase 10's;
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
   3, which stops that request there. The served tokenizer's backend is the
   native library's, and every text the phase encoded gives the same ids
   native and in Python (each timed);
12. a deployment (run right after phase 11, on its model): for each of
   ``MODEL_QUANT`` int8, int4 and w8a8 the packs built from the bf16 weights
   with ``quantize_params`` (the previous mode freed first), their weight
   bytes against the shapes' reckoning (bf16 16.1 GB, int8 and w8a8 8.6 GB,
   int4 5.0 GB), the first-token logits against the dequantized twin (the
   packs' values in a dense bf16 model: int4 within atol 1e-2, int8 within
   a twentieth and w8a8 within a tenth of the largest |logit|), each
   weight-only product on the card within one bf16 rounding of the CPU's,
   phase 10's configuration serving
   4 concurrent greedy streams of 16 tokens (aggregate tokens/s and TPOT,
   beside the bf16 model's) and the first prompt alone equal to its ids
   among 3 co-tenants; int8 weights with ``MODEL_KV_DTYPE=f8`` (the pool's
   e4m3 cache at half the bf16 bytes, 8 streams of 16 tokens, n_layers decode launches
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
   directory kept for phases 13, 18 and 19, then deleted. The phase's launch counts
   are those of its served requests alone (the deltas around each), each
   pool dispatch checked at n_layers x DECODE_CHUNK decode launches. Every
   leg's app, before it shuts down, holds its healthy traffic to zero
   cost-model anomalies (``healthy_costs``: its serving path, e.g. ``int8``
   or ``int8+f8kv``, judged on its fitted row in ``tpu/cost_profile.json``,
   a path with no fitted row predicted and not judged), as every leg of
   phases 13, 14 and 21 does; after phase 14 the run prints each path's
   row fitted from these legs' records (``print_cost_fits``);
13. speculation (run right after phase 12, on its model, phase 12's
   checkpoint kept for it): the forward at the verify shapes against its
   plain version (the pool's [8, w] verify at w = 2, 4, 5, 8 over a
   2048-slot cache at offsets = lengths, ragged, one row ending at the cache
   end, two idle; the solo verify B=1 Sq=5 at kv_len 1800; NaN past
   kv_len), with route, device time, bound, SDPA's and the mma kernel's
   time (2 and 4 on the decode variant's one-row-tile instance, 5 and 8 on
   its two-row-tile instance); the tiny f32 model's pooled and solo
   speculation on the card against plain decode, ids exactly (8 streams;
   the solo mode with the target as its own draft); the solo latency mode
   (DECODE_POOL=off, DRAFT_MODEL_NAME=llama3-8b, DRAFT_TOKENS=4) with the
   checkpoint as DRAFT_MODEL_PATH (the target's own weights: acceptance
   above half) and
   with the seeded draft, 4 prompts of 32 greedy tokens one at a time (the
   seeded draft the first 2), ids
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
   verify n_layers launches on its width's route (the decode variant: its
   one-row-tile instance at 2 and 4, its two-row-tile instance at 5; none
   on mma), every draft chunk n_layers x k decode launches,
   every plain pool chunk n_layers x DECODE_CHUNK;
14. multi-LoRA (run right after phase 13, on its model, before the model
   is freed): two rank-8 adapters (alpha 16) over all eight weight keys
   (22,030,336 parameters) trained with ``make_lora_train_step`` at phase
   9's shape (B=1, 2049-token crops of a seeded corpus, remat, 2 steps,
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
   loaded during a live adapter stream of 96 tokens, its bank swap deferred until the
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
   ``TPU_MESH`` set stops the boot with its name; the tiny model on the
   card under ``TPU_BOOT=background`` with its build made to fail once:
   readiness 503 ``failed``, then ``health_check()`` rebuilds it (UP,
   ``reinitialized``, its seconds), readiness 200 and a completion served
   through the kernel; a ``ValueError`` boot stays DOWN and is never
   rebuilt;
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
   ``/admin/anomalies`` shows the ``slow_dispatch``. The profiler's stop
   (its export) and the trace's reading (then one collection) run with no
   request in flight, and ``host phase 17`` marks each long collection
   inside or outside those windows. One more request through an in-memory
   span exporter: ``tpu-batch`` descends from the HTTP server span through
   ``tpu-llama3-8b-generate``, its ``tpu.device_time_us`` above 0 and not
   below its dispatch's duration less 10 %, ``tpu.tokens_out`` the
   completion's;
18. overload and failure (run right after phase 17, on its model, ~90 s), in
   phase 10's configuration with ``JOURNAL=on`` on a WAL (``JOURNAL_DIR``,
   a temporary directory), ``RECOVERY_ENABLED=on``, ``SLO_TARGETS`` and
   ``WATCHDOG_DISPATCH_TIMEOUT_S=1``; its forward launches (sm90 and the
   decode variant only) counted from 0: (1) deadlines: a stream with 1.5 s
   of budget (5 of the reference request's chunk walls on a host slower
   than that) and 256
   tokens to go expires mid-decode (an error frame, stage
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
   journal off, in memory and on disk, in turns on one app. After (4)'s
   recovery ``health_check()`` probes the card (a round trip on its own
   stream: its ms); (8) an app booted from phase 12's checkpoint
   (``MODEL_PATH``) serves 4 greedy prompts one at a time (the probe's ms
   under that load), then ``reinit()`` loads the weights again, the old
   ones freed first: its seconds, the peak memory across it (under the
   memory before it plus half a model), the engine's states, the same ids
   and health UP;
15. the encoder and MLP families (run last, after phase 9): ``new()`` with
   MODEL_NAME=bert-base (bf16, full width and depth, MODEL_SEED=0, the byte
   tokenizer): its weight bytes on the card equal to ``bert_param_count``
   x 2 (217,706,496); ``POST /v1/embeddings`` with an id list, a string,
   8 items of 1-128 tokens in one request, 8 concurrent single-item
   requests, and a 129-token item (its 400); the launch counts of those
   requests (every dispatch exactly n_layers = 12 launches of the sm90
   forward's D = 64 instance, none on mma or decode); latency at batch 1
   and 8, embeddings/s under the 8 concurrent requests; one dispatch of 8
   under ``torch.profiler`` (its kernels and device time); the 18
   embeddings against the same weights' on the CPU
   (plain path; bf16 2e-2, max |d| and the smallest cosine printed); other
   ids in the padding give the same embeddings bit for bit. Then
   MODEL_QUANT=int8 (within 0.05 of bf16, tests/test_models.py's bound),
   and MODEL_NAME=mlp (f32, TF32 off) behind a copy of
   ``examples/http-server/main.py``'s ``/infer``: 8 concurrent requests
   equal to the CPU's within 2e-5, a 63-wide input's 400.
19. the fleet (last, after phase 15; the first 8 layers of phase 5's
   weights, llama3-8b's widths at a cut depth: phase 12's checkpoint's
   first shard, kept until here, served as ``llama3-8b-l8``, a name the
   replicas' sitecustomize registers): the parent's model is gone; a block's
   parts at llama3-8b's geometry (the arena's export, ``zlib.crc32``, the
   decoder's framing, the ingest); two replica processes (``python -m
   gofr_tpu_torch.devtools.replica_proc`` under ``devtools/supervise``,
   ``FLEET_ROLE=prefill`` and ``decode``) booted through ``MODEL_PATH`` in
   phase 10's configuration with ``KV_HBM_BUDGET_MB=2048`` and the donor
   hint trusted, behind a router in this process (``wire_fleet``,
   ``FLEET_RESUME=on``); each process's peak memory from ``nvidia-smi``.
   (1) the 1,024- and ~1,900-token prompts warmed on the prefill replica,
   then streamed through the router to the decode replica, which pulls
   them: outcome ``ok``, both ledgers on the request id, the fleet trace
   whole, no sm90 launch on the receiver; the pull's blocks, bytes, ms and
   GB/s, TTFT beside a local prefill of the same prompt, ids equal (or
   parting at a near tie), the donor's refcounts back after each pull; (2)
   a bit flip, a slow donor, an evicted entry and a donor cut mid-pull
   (through a chaos proxy before the donor) fall back with the local ids,
   the outcome counters moved, the donor's refcounts back; before a fault
   is armed, what the donor's cache holds prints (read from its
   ``/admin/engine`` without touching the cache: whether an entry hashes
   to the prompt, its LRU place, every entry's hash and length, the
   evictions), again at a count that moved otherwise; (3) ``kill -9`` of
   the decode replica mid-stream: the
   router resumes the stream on the prefill replica, the client's gap, the
   respawn to ready and back into rotation; (4) a sticky device fault in
   the decode replica's process (its site hook: the card slept, then a
   device-side assert): ``failed`` with a restart verdict, killed,
   respawned, MTTR; the parent's own decode kernel after; (5) the router's
   legs before stub replicas (the remaining deadline across retries, a
   quota shed, a breaker opening and closing) and the drain (readiness 503,
   the in-flight stream completing).
20. GoFr's transports (last, after phase 19): the port's MiniRedis and
   MiniMySQL in this process; ``python -m gofr_tpu_torch.examples.sample_cmd``
   as a process (``hello --name=x`` and an unknown command's exit 1); the
   ``lora_finetune`` example's ``finetune`` through ``new_cmd`` and
   ``run_cmd`` in this process (llama3-8b's widths at 8 layers,
   ``llama3-8b-l8``, registered in this process and in the example
   processes' sitecustomize; seeded init, the demo ramp
   corpus at B=4 S=64, rank 8, 4 steps): each step's loss and ms, the
   forward, dQ and dK/dV launches (sm90 only), the merge's and the write's
   seconds, peak memory; the sm90 forward at that shape against its plain
   version, its bound and SDPA. Then the merged checkpoint (``MODEL_PATH``)
   behind two example processes in phase 10's configuration without a
   tokenizer, booted one after the other: A, ``http_server`` with redis and
   mysql wired; B, ``grpc_server`` with ``BATCH_COHORT=off``. Three prompts
   at once: A's ``/generate``, A's ``/v1/completions`` and B's
   ``LLMService/Generate`` stream give equal ids (or part at a near tie, as
   in phase 19); ``hello.Hello/SayHello`` (stub) and ``HelloService/SayHello``
   (JSON); A's ``/hello``, ``/redis``, ``/mysql`` (``SELECT 2+2``) and
   ``/trace`` (through ``get_http_service``); health with redis, sql and the
   device UP, then redis DOWN after the MiniRedis stops while ``/generate``
   serves; each process's kernel launches (sm90 and decode, no mma) and
   prefill dispatches; 1 and 8 concurrent streams of 32 tokens over B's
   gRPC stream beside A's SSE ``/generate?stream=true`` (TPOT, tokens/s).
   Without grpcio or protobuf on the machine B serves the ``http_server``
   example and a line names the package and the legs that did not run.
   Everything it started is stopped and the merged checkpoint deleted.

21. the serving mesh (after phase 10b, on phase 5's weights, in phase
   10's configuration; two tp shards on the one card): the forward at one
   shard's shapes against its plain version (the ragged prefill B=2 at
   bucket 512 and the pool's decode B=8, Hq=16 Hkv=4), with device time,
   bound, plain time and SDPA's; (a) ``ShardedTransformer`` over
   ``make_mesh(devices=[cuda:0, cuda:0])`` against the unsharded model: a
   ragged prefill B=2 at bucket 512 (top-5 logprobs within phase 10's
   pooled-vs-solo tolerance: each row-parallel product sums two f32
   partials where the unsharded one accumulates once, bf16 through 32
   layers) and 32 decode steps of the pool's chunk, ids under the near-tie
   rule, exactly 2 x n_layers sm90 launches and 2 x n_layers decode
   launches a step; (b) ``TPU_MESH=tp=2`` served through
   ``/v1/completions`` over the harness's fake ``visible_devices`` ([cuda:0,
   cuda:0], restored after): phase 10's 1 and 8 streams of 32 greedy
   tokens, the 1,500-byte prompt (3 slices) and its exact repeat (a prefix
   hit), 11 generations against phase 10's ids under the near-tie rule,
   2 x n_layers x DECODE_CHUNK decode launches a pool chunk, no mma,
   ``/admin/engine``'s ``mesh`` and the pool's ``mesh_axes``, the
   ``gofr_tpu_mesh_axis_size`` gauge, no ``gofr_tpu_mesh_degrade_total``,
   every flight record's ``mesh_axes``, zero cost-model anomalies on its
   ``bf16/tp2`` path (phase 12's ``healthy_costs``); TPOT and tokens/s beside phase
   10's (two shards sharing one card's host-bound path, not a two-GPU
   mesh's speed); (c) with the real enumeration the boot fails "needs 2
   devices, have 1" and the device ends ``failed``. One ``mesh`` line.
22. training over a mesh (right after phase 9, whose step-1 numbers it
   reads; two shards on the one card, ``make_mesh(devices=[cuda:0,
   cuda:0])``): (a) llama3-8b at full width and depth, tp = 2, from phase
   9's seed-0 state placed by ``place_train_state(release=True)`` (the
   unsharded tensors freed as their shards land: the placed state holds no
   more than the unsharded one did), two steps on phase 9's batch: step 1's
   loss within 1e-2 and grad_norm within 5e-2 of phase 9's step 1
   (relative; the split reorders bf16 sums), exactly tp x phase 9's
   launches a step (128 forward, 64 dQ, 64 dK/dV, all sm90), peak memory;
   (b) ring attention at sp = 2 and (c) Ulysses at sp = 2 on llama3-8b's
   widths at 4 layers, B = 1, S = 4096, and (d) the GPipe pipeline at pp =
   2, n_micro = 2, B = 2 crops of 2049: each a loss and its gradients
   against the unsharded model's on the same card from the same weights
   (loss within 1e-2 relative, each leaf's max |grad difference| within
   2e-2 of its max |grad|; Ulysses' loss against the ring's too), with
   exact launches: the ring sp(sp+1)/2 = 3 forward (x2: remat), 3 dQ and 3
   dK/dV a layer, Ulysses sp a layer each, the pipeline n_micro x n_layers
   each (no drain replays), and each one's wall ms beside the unsharded
   4-layer loss and gradients; (e) the kernels at those shapes against
   their plain versions with device time, bound, plain and SDPA: the tp
   shard's training call (B=1 S=2048 Hq=16 Hkv=4: forward, dQ, dK/dV),
   the ring's off-diagonal pair (B=1 Sq=Skv=2048 Hq=32 Hkv=8, non-causal;
   its backward at the global out and LSE of two chunks) and Ulysses' head
   group (B=1 S=4096 Hq=16 Hkv=4); (f) the JAX package's refusals word for
   word: Ulysses at sp = 8 over 4 heads, a pipeline over a batch of 3 in 2
   microbatches. One ``mesh-train`` line.
23. MoE over the ep axis and the multihost runtime (after phase 22):
   ``MoEConfig()`` at its own widths (Mixtral-8x7B's: dim 4096, 32 heads,
   8 KV heads, hidden 14336, vocab 32000, 8 experts, top-2, bf16, seed 0)
   cut to 4 layers (32 take 93.4 GB), B = 2 crops of 2049: (a) the dense
   forward: finite logits, ``load_balance`` >= 0.99, 4 sm90 launches; an
   f32 copy's loss and gradients (aux_weight 0, remat; its f32 attention
   the reference's, uncounted); (c) the dense bf16 loss and gradients (4
   forward, dQ and dK/dV launches, all sm90); then ep = 2 over two shards
   of the one card (``place_moe_params``): (b) the ep forward at capacity
   factor 4 (no drops; one sm90 forward a shard a layer, B=1 S=2048)
   against (a)'s logits (max |diff| / max |logit| <= 2e-2); (d) at 0.25:
   finite, the dropped assignments counted (> 0); (c) the ep loss and
   gradients (remat: 16 forward, 8 dQ, 8 dK/dV launches): the loss within
   1e-3 of the dense one, ``w_gate``, ``w_down``, ``router`` and ``wq``
   within 2e-2 (max |diff| / max |grad|), each leg's gap to the f32 copy
   beside; (e) int8: experts dense, attention and ``lm_head`` packed, a
   finite forward; the three kernels at the dense model's attention (B=2
   S=2048) against their plain versions with device time, bound and SDPA;
   (f) ``new()`` of the tiny model on the card with ``TPU_COORDINATOR``,
   ``TPU_NUM_PROCESSES=1``, ``TPU_PROCESS_ID=0``: the boot joins an
   NCCL-backed group, ``process_info`` {0, 1, 1, 1}, ``global_psum_check``
   None, a CUDA all-reduce, one request served, the group destroyed at
   shutdown. One ``moe`` line with each leg's ms, the peak memory and the
   phase's seconds.

Prints a ``{"kernels": [...]}`` line (phase 21's launches under each
entry's ``mesh_launches``, its two shard rows beside them; phase 22's
pipeline launches under ``mesh_train_launches`` and its nine rows at its
legs' shapes; phase 23's ep shards' launches under ``moe_launches`` and
its three rows at the dense MoE model's shape), the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Each phase's seconds
print as ``phase N: X s``.

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

``--mesh-cards`` (a machine with two or more cards) runs instead phases 5
and 10 on cuda:0, then phase 21's direct leg over [cuda:0, cuda:1] and
over every card, and its served leg with ``TPU_MESH=tp=<cards>`` over the
real enumeration: the serving mesh across distinct cards, each shard's
weights and KV on its own card; then phase 9 and phase 22's legs over
[cuda:0, cuda:1]; then two ranks, one card each, join a process group
over NCCL and run the multihost worker's checks (the CPU tests' over
gloo); it prints one ``mesh-cards`` line.

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

import atexit
import contextlib
import gc
import http.client
import json
import os
import re
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


@contextlib.contextmanager
def host_pauses(label: str):
    """Prints, when the block ends (failed or not), the interpreter's
    garbage collections inside it (count, wall time in all, the longest)
    and the process's peak resident memory, then each collection of 100 ms
    or more: its wall-clock start (to set beside the log's times), length,
    generation, objects collected, and whether it fell in a window the
    phase marked as having no request in flight (the block yields the
    context manager that marks one). A host stall in a phase's timed
    checks can then be told from a collection."""
    import datetime
    import resource

    pauses: list = []
    started: list = []
    quiet: list = []  # [start, end] wall times with no request in flight

    @contextlib.contextmanager
    def no_request_in_flight():
        window = [time.time(), float("inf")]
        quiet.append(window)
        try:
            yield
        finally:
            window[1] = time.time()

    def timed(phase: str, info: dict) -> None:
        if phase == "start":
            started[:] = [time.time(), time.perf_counter()]
        elif started:
            wall, t0 = started
            started.clear()
            pauses.append((time.perf_counter() - t0, wall, info["generation"], info["collected"]))

    gc.callbacks.append(timed)
    try:
        yield no_request_in_flight
    finally:
        gc.callbacks.remove(timed)
        longest = max(pauses, default=(0.0, 0.0, None, 0))
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        long = [{"at": datetime.datetime.fromtimestamp(w, datetime.timezone.utc).isoformat(),
                 "ms": round(d * 1e3, 1), "generation": g, "collected": n,
                 "no_request_in_flight": any(a <= w <= b for a, b in quiet)}
                for d, w, g, n in pauses if d >= 0.1]
        serving = sum(not c["no_request_in_flight"] for c in long)
        print(f"host {label}: {len(pauses)} GC collections, {sum(p[0] for p in pauses) * 1e3:.1f} "
              f"ms in all, the longest {longest[0] * 1e3:.1f} ms (generation {longest[2]}); "
              f"peak RSS {rss:.2f} GiB; collections of 100 ms or more {json.dumps(long)}; "
              f"{serving} of them outside the windows with no request in flight", flush=True)


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


def forward(flash, case, causal=True, variant=None):
    """The forward on ``case``: the kernel its shape picks, or ``variant``
    through the override (the mma kernel at another route's shape)."""
    q, k, v, offs, lens = case
    if variant is None:
        return flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    return flash._launch(q, k, v, offs, lens, causal, q.shape[-1] ** -0.5, variant=variant)


def check_tail_invisible(torch, flash, name, case, out, causal=True, variant=None):
    """The kernel's output is bit-identical with the tail past kv_len zeroed."""
    q, k, v, offs, lens = case
    tail = (torch.arange(k.shape[1], device="cuda")[None, :] >= lens[:, None])[:, :, None, None]
    out2, _ = forward(flash, (q, k.masked_fill(tail, 0), v.masked_fill(tail, 0), offs, lens),
                      causal, variant)
    check(torch.equal(out, out2), f"{name}: the poisoned tail moved the kernel's output")


def fwd_counters(flash) -> tuple:
    """The forward's launch counters, each variant's and each instance's:
    a phase sets them all to 0 just before the path it reads them over."""
    return (flash.launches, flash.launches_fwd_sm90, flash.launches_fwd_decode,
            *flash.launches_fwd_instance.values())


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


def compare(torch, flash, name, case, causal=True, errs=None, variant=None):
    """The forward against its plain version; the max error goes into
    ``errs[variant]``. The call takes its shape's kernel, or ``variant``
    through the override; the instance counters must show one launch of
    that instance (``flash.fwd_instance``)."""
    q, k, v, offs, lens = case
    counters = flash.launches_fwd_instance
    before = {n: c.value for n, c in counters.items()}
    out, lse = forward(flash, case, causal, variant)
    torch.cuda.synchronize()
    ran = {n: c.value - before[n] for n, c in counters.items() if c.value != before[n]}
    instance = flash.fwd_instance(q, k, variant)
    check(ran == {instance: 1}, f"{name}: launched {ran}, not the {instance} instance once")
    variant = variant or flash.fwd_variant(q, k)
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
    print(f"kernel-vs-plain {name} [{instance}]: max|out err| {e_out:.3e} max|lse err| "
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
    row = {"variant": variant, "instance": flash.fwd_instance(q, k), "ms": event_ms(kernel, iters)}
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
    one product. Each case runs the sm90 forward's D = 64 instance (the
    counters say so: one launch a call, none on mma or decode) and holds
    to the plain version at tests/test_flash.py's bf16 tolerance; the
    poisoned tail must not move a bit of the output. The mma kernel (its
    predecessor, still the route of bf16 tails under 64 rows) is held the
    same way on each case through the override. Then the times at B = 1,
    2, 8 (bert-base) and B = 8 (bert-tiny), CUDA events and device time,
    each beside the mma kernel's. -> (max errors by variant, timing rows
    by name)."""
    errs = {"sm90": [], "decode": [], "mma": []}
    cases = {}
    for label, heads in (("bert-base", 12), ("bert-tiny", 2)):
        cases[f"{label} B=8 ragged"] = bert_case(torch, gen, 8, heads, ENCODER_LENS)
        cases[f"{label} B=8 +-300 tail"] = bert_case(torch, gen, 8, heads, ENCODER_LENS,
                                                     poison=True)
        cases[f"{label} B=8 NaN tail"] = bert_case(torch, gen, 8, heads, ENCODER_LENS,
                                                   poison=float("nan"))
    counters = (flash.launches, flash.launches_fwd_sm90, flash.launches_fwd_instance["sm90_d64"],
                flash.launches_fwd_decode)
    for name, case in cases.items():
        q, k = case[:2]
        check(flash.fwd_instance(q, k) == "sm90_d64" and not q.is_contiguous(),
              f"encoder {name}: not the sm90 D = 64 instance on strided views")
        before = [c.value for c in counters]
        out, _, _ = compare(torch, flash, f"encoder {name}", case, causal=False, errs=errs)
        after = [c.value for c in counters]
        check([a - b for a, b in zip(after, before)] == [1, 1, 1, 0],
              f"encoder {name}: the counters saw {after} after {before}, not one sm90 D = 64 "
              "launch")
        mma, _, _ = compare(torch, flash, f"encoder {name} (mma)", case, causal=False,
                            errs=errs, variant="mma")
        if "tail" in name:
            check_tail_invisible(torch, flash, f"encoder {name}", case, out, causal=False)
            check_tail_invisible(torch, flash, f"encoder {name} (mma)", case, mma,
                                 causal=False, variant="mma")
    rows = {
        f"encoder_B{b}": time_shape(torch, flash, f"encoder bert-base B={b}",
                                    bert_case(torch, gen, b, 12, ENCODER_LENS[:b]), 50,
                                    device=True, causal=False)
        for b in (1, 2, 8)
    }
    rows["encoder_tiny_B8"] = time_shape(torch, flash, "encoder bert-tiny B=8",
                                         cases["bert-tiny B=8 ragged"], 50, device=True,
                                         causal=False)
    return errs, rows


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
        for c in fwd_counters(flash):
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
    from gofr_tpu_torch.tpu import batcher as tb
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
        for c in fwd_counters(flash):
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
        if SCRAPE_8:
            # the slot gauge on /metrics once 8 streams share the pool: the
            # 8 above need not (each decodes faster than the 8 prefills spread)
            held_seen, done = [], threading.Event()

            def held_scraper():
                while not done.is_set():
                    held_seen.append(scrape(port).get("gofr_tpu_decode_slots_active", 0.0))
                    done.wait(0.05)

            watcher = threading.Thread(target=held_scraper, name="smoke-held-scrape")
            watcher.start()
            try:
                with admitted_together(pool, 8):
                    concurrent_streams(port, prompts8, greedy)
            finally:
                done.set()
                watcher.join(timeout=60)
            print(f"default: 8 streams admitted together: /metrics scraped {len(held_seen)} "
                  f"times, decode slots active at most {max(held_seen, default=0):g}", flush=True)
            check(max(held_seen, default=0) == 8,
                  "default: /metrics during 8 streams admitted together never showed 8 active "
                  "decode slots")
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
        pack = pack_times(tb)

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
            "pack_us": pack,
        }
        print(f"default-metrics [{card}]: {json.dumps(metrics)}", flush=True)
        # the 8 prompts' greedy ids, the sanitized leg's reference
        reference = {"prompts": prompts8, "ids": [ids_of(p)[0] for p in prompts8],
                     "stop_ids": sorted(dev.default_stop_ids),
                     # every prompt's first generation (phase 21's reference)
                     "by_tokens": {}}
        for tokens, out in generations:
            reference["by_tokens"].setdefault(tuple(int(t) for t in tokens), list(out))
    finally:
        app.shutdown()
    # the pool's worker is joined: nothing of the pool runs beside training
    check(not pool._thread.is_alive(), "default: the pool's worker outlived app.shutdown()")
    return {"decode": decode, "per_chunk": per_chunk, "metrics": metrics, "reference": reference}


def pack_times(tb, reps: int = 200) -> dict:
    """One prefill batch's pack at 8 x 512 (8 rows of 300-700 seeded ids,
    the longer ones keeping their last 512): ``pack_token_rows`` (numpy,
    the port's) beside the native library's ``gofr_pack_rows`` through its
    C ABI (the JAX package's pack), mean us a call over ``reps``, the
    arrays equal."""
    import ctypes

    import numpy as np

    from gofr_tpu_torch import native

    lib = native.load()
    check(lib is not None, "pack: the native library did not load on this machine")
    rng = np.random.default_rng(10)
    rows = [rng.integers(0, 128256, int(n), dtype=np.int32) for n in rng.integers(300, 700, 8)]
    i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)

    def library():
        out, lens = np.zeros((8, 512), np.int32), np.zeros(8, np.int32)
        flat = np.concatenate(rows)
        sizes = np.asarray([r.size for r in rows], np.int64)
        lib.gofr_pack_rows(flat.ctypes.data_as(i32), sizes.ctypes.data_as(i64), len(rows), 512,
                           0, out.ctypes.data_as(i32), lens.ctypes.data_as(i32))
        return out, lens

    check(all(bool((a == b).all()) for a, b in zip(tb.pack_token_rows(rows, 8, 512), library())),
          "pack: pack_token_rows and gofr_pack_rows differ at 8 x 512")
    out = {}
    for name, fn in (("numpy", lambda: tb.pack_token_rows(rows, 8, 512)), ("native", library)):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t) / reps * 1e6
    print(f"default: one pack of 8 x 512 (rows of {[r.size for r in rows]} ids): "
          f"pack_token_rows {out['numpy']:.2f} us, the native gofr_pack_rows "
          f"{out['native']:.2f} us a call over {reps}, arrays equal", flush=True)
    return out


# -- phase 10b: phase 10's server as a process, on the lock sanitizer ----------------

# the JAX pool's format; `` graphed`` ends the line of a chunk replayed from its CUDA graph
POOL_DEBUG_LINE = re.compile(
    r"^\[pool\] chunk active=(\d+) dispatch->fetch (\d+)ms fetch-wait (\d+)ms deliver (\d+)ms"
    r"( graphed)?$")


def sanitized_server(torch, card: str, default: dict) -> dict:
    """Phase 10b: a server process of llama3-8b in phase 10's configuration
    (``python -m gofr_tpu_torch.devtools.replica_proc``, phase 5's seeded
    init drawn again on the card) under ``GOFR_SANITIZE=1`` and
    ``GOFR_POOL_DEBUG=1``: phase 10's 8 prompts as 8 concurrent streams of
    32 greedy tokens. Their ids equal phase 10's; the sanitizer's report at
    the process's end holds no lock-order cycle and no leaked thread (its
    hold warnings print with their sites); one ``[pool] chunk`` stderr line
    a pool chunk, each a replay of the pool's graph, their medians, and TPOT
    beside phase 10's."""
    import statistics

    from gofr_tpu_torch.config import DECLARED_KEYS, UNHONORED_KEYS

    ref = default["reference"]
    workdir = tempfile.mkdtemp(prefix="gofr_sanitized_")
    report_path = os.path.join(workdir, "sanitizer-report.jsonl")
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in DECLARED_KEYS and k not in UNHONORED_KEYS}
    env.update({k: v for k, v in PHASE10_ENV.items() if k != "TOKENIZER"})
    # no tokenizer (frames carry ids) and phase 10's stop ids explicitly
    env.update({"HTTP_PORT": str(port), "MODEL_SEED": "0", "LOG_LEVEL": "ERROR",
                "GOFR_SANITIZE": "1", "GOFR_POOL_DEBUG": "1",
                "GOFR_SANITIZE_REPORT": report_path,
                "PYTHONPATH": os.pathsep.join([os.path.dirname(os.path.abspath(__file__)),
                                               os.environ.get("PYTHONPATH", "")])})
    if ref["stop_ids"]:
        env["GEN_STOP_TOKENS"] = ",".join(map(str, ref["stop_ids"]))
    else:
        env["GEN_STOP_EOS"] = "off"
    stderr = open(os.path.join(workdir, "stderr.log"), "w+b")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "gofr_tpu_torch.devtools.replica_proc"],
                            env=env, cwd=workdir, stdout=subprocess.DEVNULL, stderr=stderr)
    address = f"http://127.0.0.1:{port}"
    try:
        while True:
            check(proc.poll() is None, f"sanitized: the server exited {proc.returncode}")
            check(time.perf_counter() - t0 < 600, "sanitized: the server never became ready")
            try:
                if get_body(address, "/.well-known/ready", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        boot_s = time.perf_counter() - t0
        prompts = [list(p.encode()) for p in ref["prompts"]]
        results = [None] * len(prompts)

        def run(i):
            results[i] = stream_ids(port, {"prompt": prompts[i], "max_tokens": 32,
                                           "temperature": 0})

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        divergences = []
        for i, r in enumerate(results):
            check(r is not None and r["status"] == 200 and r["done"] and not r["error"],
                  f"sanitized: stream {i} {r and (r['status'], r['error'])}")
            # equal, or parting at a near tie (phase 19's rule across processes)
            divergences.append(fleet_divergence(address, prompts[i], ref["ids"][i], r["ids"],
                                                f"sanitized: prompt {i} against phase 10"))
        tpots = [(r["seconds"] - r["ttft_s"]) / (len(r["ids"]) - 1) * 1e3 for r in results]
        t_end = time.perf_counter()
        while True:  # the last chunks' deliveries, after the streams' ends
            status, engine = get_body(address, "/admin/engine")
            if engine["decode_pool"]["active"] == 0 or time.perf_counter() - t_end > 30:
                break
            time.sleep(0.1)
        chunks = engine["decode_pool"]["dispatches"]
    finally:
        proc.send_signal(15)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    stderr.seek(0)
    log = stderr.read().decode("utf-8", "replace").splitlines()
    stderr.close()
    lines = [m for m in map(POOL_DEBUG_LINE.match, log) if m]
    try:
        with open(report_path) as f:
            report = json.loads(f.read().splitlines()[-1])
    except (OSError, IndexError, ValueError) as exc:
        check(False, f"sanitized: no sanitizer report ({exc}); stderr {log[-20:]}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check(proc.returncode == 0, f"sanitized: the server exited {proc.returncode}: {log[-20:]}")
    medians = {k: statistics.median(int(m.group(j)) for m in lines) if lines else None
               for j, k in ((2, "dispatch_fetch_ms"), (3, "fetch_wait_ms"), (4, "deliver_ms"))}
    out = {"boot_s": boot_s, "tpot_ms": sum(tpots) / len(tpots),
           "ids_equal": sum(not d["diverged"] for d in divergences),
           "phase10_tpot_ms": default["metrics"]["tpot_ms"][8], "chunks": chunks,
           "pool_debug_lines": len(lines), "pool_debug_medians": medians,
           "graphed_lines": sum(bool(m.group(5)) for m in lines),
           "cycles": len(report["violations"]), "leaked_threads": report["leaked_threads"],
           "hold_warnings": len(report["hold_warnings"]), "edges": report["edges"]}
    for w in report["hold_warnings"]:
        print(f"sanitized: hold warning: {w['lock']} held {w['seconds'] * 1e3:.1f} ms on "
              f"{w['thread']}, taken at {w['stack'][0] if w['stack'] else '?'}", flush=True)
    for v in report["violations"]:
        print(f"sanitized: SANITIZER: {v.get('summary')}", flush=True)
    print(f"sanitized: a llama3-8b server process under GOFR_SANITIZE=1 GOFR_POOL_DEBUG=1, "
          f"ready in {boot_s:.1f}s: 8 streams of 32 greedy tokens, {out['ids_equal']} of 8 with "
          f"phase 10's ids (the rest part at a near tie); "
          f"TPOT {out['tpot_ms']:.2f} ms (phase 10's 8 streams {out['phase10_tpot_ms']:.2f} ms); "
          f"{len(lines)} [pool] chunk lines for {chunks} pool chunks "
          f"({out['graphed_lines']} graphed), medians "
          f"{json.dumps(medians)}; "
          f"sanitizer: {out['cycles']} cycles, leaked threads {out['leaked_threads']}, "
          f"{out['hold_warnings']} hold warnings, {out['edges']} lock-order edges [{card}]",
          flush=True)
    check(len(lines) == chunks, f"sanitized: {len(lines)} [pool] chunk lines, {chunks} chunks")
    check(out["graphed_lines"] == chunks,
          f"sanitized: {out['graphed_lines']} of {chunks} greedy chunks replayed a graph")
    check(out["cycles"] == 0, "sanitized: the sanitizer found a lock-order cycle")
    check(not out["leaked_threads"], f"sanitized: leaked threads {out['leaked_threads']}")
    return out


# -- phase 21: the serving mesh (TPU_MESH=tp=2, two shards on the one card) ---------

# the tp = 2 model against the unsharded one: each row-parallel product sums
# two f32 partials and rounds to bf16 once, where the unsharded product
# accumulates in one f32 and rounds once; a reduction order apart, bf16
# activations through 32 layers: phase 10's pooled-vs-solo tolerance, on
# the unsharded top-5 logprobs, (atol, rtol)
MESH_LP_TOL = POOL_LP_TOL
# the pool's ragged lengths for the shard-shape decode check
MESH_POOL_LENGTHS = [137, 410, 655, 900, 1530, 2046, 33, 1024]


def shard_case(torch, gen, b, sq, offsets, kv_lens, max_seq=2048, layers=2):
    """One tp shard's attention call at llama3-8b's width: q [B, Sq, 16,
    128] bf16, K/V the last layer of a [layers, B, max_seq, 4, 128] shard
    cache (the ShardedKV shard's layout), +-300 past each row's kv_len."""
    dev, bf16 = "cuda", torch.bfloat16
    q = torch.randn(b, sq, 16, 128, device=dev, generator=gen).to(bf16)
    shape = (layers, b, max_seq, 4, 128)
    caches = [torch.randn(shape, device=dev, generator=gen).to(bf16) for _ in "kv"]
    for cache, poison in zip(caches, (300.0, -300.0)):
        for i, n in enumerate(kv_lens):
            cache[:, i, n:] = poison
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    return q, caches[0][-1], caches[1][-1], offs, lens


def mesh_kernels(torch, flash, gen) -> tuple:
    """The forward at one tp = 2 shard's shapes against its plain version,
    with its device time, bound, plain time and SDPA's: the ragged prefill
    at bucket 512 (B = 2, 512 and 300 real tokens) on the sm90 variant and
    the pool's decode (B = 8 over a 2048-slot cache) on the decode variant.
    -> (max errors by variant, timing rows)."""
    errs = {"sm90": [], "decode": []}
    cases = {
        "tp shard prefill B=2 Sq=512": shard_case(torch, gen, 2, 512, [0, 0], [512, 300]),
        "tp shard pool decode B=8": shard_case(
            torch, gen, 8, 1, MESH_POOL_LENGTHS, [n + 1 for n in MESH_POOL_LENGTHS]),
    }
    rows = {}
    for name, case in cases.items():
        out, _, _ = compare(torch, flash, name, case, errs=errs)
        check_tail_invisible(torch, flash, name, case, out)
        rows[name] = device_row(time_shape(torch, flash, name, case, 50, device=True))
    check(rows["tp shard prefill B=2 Sq=512"]["instance"] == "sm90"
          and rows["tp shard pool decode B=8"]["instance"] == "decode",
          "mesh: the shard shapes must take the sm90 and the decode instances")
    return errs, rows


def mesh_tie(plain: list, other: list, top2: list, label: str) -> dict:
    """``other`` against ``plain`` (one row's ids) under the near-tie rule:
    equal, or parting first where the plain path's top-2 logits (``top2``,
    one pair a position) differ by less than NEAR_TIE x |max logit|."""
    j = next((i for i, (a, b) in enumerate(zip(plain, other)) if a != b), None)
    if j is None:
        return {"diverged": False}
    hi, lo = top2[j]
    gap, limit = hi - lo, NEAR_TIE * abs(hi)
    print(f"{label}: ids part at position {j} ({plain[j]} unsharded, {other[j]} tp=2): the "
          f"unsharded top-2 logits {hi:.4f} / {lo:.4f}, gap {gap:.4f} against {NEAR_TIE} x |max| "
          f"= {limit:.4f} -> {'near tie' if gap < limit else 'FAIL'}", flush=True)
    check(gap < limit, f"{label}: the ids part where the unsharded path has no near tie")
    return {"diverged": True, "position": j, "gap": gap, "limit": limit}


def mesh_direct(torch, flash, model, devices: list) -> dict:
    """Phase 21 (a): the tp = len(devices) model built through
    ``make_mesh(devices=)`` and ``ShardedTransformer.from_model`` on phase
    5's weights (phase 21: [cuda:0, cuda:0]), a ragged prefill (B = 2 at
    bucket 512) and 32 decode steps of the pool's chunk (4 x 8), against
    the unsharded model on the same ids: logprobs within MESH_LP_TOL, ids
    under the near-tie rule, and exactly tp x n_layers sm90 launches for
    the prefill and tp x n_layers a decode step (each shard's attention,
    each a launch)."""
    from gofr_tpu_torch.parallel.mesh import make_mesh
    from gofr_tpu_torch.parallel.serving import ShardedTransformer

    cfg = model.cfg
    tp = len(devices)
    t0 = time.perf_counter()
    mesh = make_mesh({"tp": tp}, devices=devices)
    sharded = ShardedTransformer.from_model(model, mesh)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    held = {str(d): torch.cuda.memory_allocated(d) / 2**30 for d in sorted(set(devices), key=str)}
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=g, device="cuda",
                           dtype=torch.int32)
    lengths = torch.tensor([512, 300], dtype=torch.int32, device="cuda")
    steps = 32
    with torch.no_grad():
        logits, cache = model.prefill(tokens, model.init_cache(2, 2048), lengths)
        plain_first = logits.float()
        top2, plain_ids = [], []
        for _ in range(steps + 1):
            top2.append(torch.topk(logits.float(), 2).values.tolist())
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            plain_ids.append(tok[:, 0].tolist())
            if len(plain_ids) <= steps:
                logits, cache = model.decode_step(tok, cache)
        del cache
        # every count to 0 just before the sharded path runs
        for c in fwd_counters(flash):
            c.reset()
        logits, cache = sharded.prefill(tokens, sharded.init_cache(2, 2048), lengths)
        for d in set(devices):
            torch.cuda.synchronize(d)
        prefill_sm90 = flash.launches_fwd_sm90.value
        first = logits.float()
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        sh_ids = [tok[:, 0].tolist()]
        t1 = time.perf_counter()
        for _ in range(steps // 8):
            out = sharded.decode_chunk_pool(tok, cache, 8)
            tok, cache = out[4], out[5]
            sh_ids += out[0].t().tolist()
        for d in set(devices):
            torch.cuda.synchronize(d)
        decode_s = time.perf_counter() - t1
        launches = {"sm90": flash.launches_fwd_sm90.value,
                    "decode": flash.launches_fwd_decode.value,
                    "all": flash.launches.value,
                    "decode_r2": flash.launches_fwd_instance["decode_r2"].value}
        top = torch.topk(plain_first, 5, dim=-1).indices
        lp_p = torch.log_softmax(plain_first, -1).gather(1, top)
        lp_s = torch.log_softmax(first, -1).gather(1, top)
        lp_diff = (lp_s - lp_p).abs()
        atol, rtol = MESH_LP_TOL
        lp_ok = bool((lp_diff <= atol + rtol * lp_p.abs()).all())
        logit_diff = float((first - plain_first).abs().max())
    n = cfg.n_layers
    print(f"mesh (a): tp={tp} over {[str(d) for d in devices]} placed in {place_s:.2f}s "
          f"(GiB allocated after: {held}); prefill B=2 at "
          f"bucket 512 (512 and 300 tokens): max |logit diff| {logit_diff:.4e}, the unsharded "
          f"top-5 logprobs max |diff| {float(lp_diff.max()):.4e} (tol {atol} + {rtol}*|lp|) -> "
          f"{'ok' if lp_ok else 'FAIL'}; {steps} decode steps (4 pool chunks of 8) in "
          f"{decode_s * 1e3:.1f} ms; launches {launches} (want sm90 {tp * n}, decode "
          f"{tp * n * steps})", flush=True)
    check(lp_ok, f"mesh (a): the tp={tp} prefill's logprobs disagree with the unsharded model")
    check(prefill_sm90 == tp * n and launches["sm90"] == tp * n,
          f"mesh (a): {launches['sm90']} sm90 launches, want one a shard a layer ({tp * n})")
    check(launches["decode"] == tp * n * steps and launches["all"] == tp * n * (steps + 1),
          "mesh (a): the decode steps missed the decode kernel on a shard")
    ties = []
    for r in range(2):
        plain_row = [ids[r] for ids in plain_ids]
        sh_row = [ids[r] for ids in sh_ids]
        ties.append(mesh_tie(plain_row, sh_row, [t[r] for t in top2], f"mesh (a) row {r}"))
    same = sum(not t["diverged"] for t in ties)
    print(f"mesh (a): greedy ids over {steps + 1} positions equal to the unsharded model's in "
          f"{same} of 2 rows", flush=True)
    del sharded, cache
    return {"tp": tp, "devices": [str(d) for d in devices], "gib_allocated": held,
            "place_s": place_s, "logit_max_diff": logit_diff,
            "lp_max_diff": float(lp_diff.max()), "ties": ties, "launches": launches,
            "decode_ms_per_step": decode_s * 1e3 / steps}


@contextlib.contextmanager
def two_shard_enumeration(torch):
    """The harness's fake: ``visible_devices("cuda")`` gives [cuda:0,
    cuda:0], the counterpart of the forced CPU device count the JAX tests
    run on; the real enumeration is restored on exit."""
    from gofr_tpu_torch.parallel import mesh as mesh_mod

    real = mesh_mod.visible_devices

    def two_shards(platform: str) -> list:
        return [torch.device("cuda", 0)] * 2 if platform == "cuda" else real(platform)

    mesh_mod.visible_devices = two_shards
    print("mesh (b): the harness replaces parallel/mesh.py::visible_devices with [cuda:0, "
          "cuda:0] (a fake of the harness: two tp shards on one card, not a two-GPU mesh)",
          flush=True)
    try:
        yield
    finally:
        mesh_mod.visible_devices = real
    check(len(mesh_mod.visible_devices("cuda")) == torch.cuda.device_count(),
          "mesh: the real enumeration was not restored")


def mesh_served(torch, flash, card: str, model, default: dict, tp: int = 2,
                fake: bool = True) -> dict:
    """Phase 21 (b): ``TPU_MESH=tp=2`` boots llama3-8b in phase 10's
    configuration over the harness's two shards (``fake``; else ``tp`` of
    the real cards) and serves phase 10's 1 and 8 streams of 32 greedy
    tokens, one prompt past PREFILL_CHUNK_TOKENS and its exact repeat (a
    prefix hit): ids equal phase 10's (or part at a near tie), the mesh on
    every surface, no degrade counted."""
    import gofr_tpu_torch
    from gofr_tpu_torch.parallel.serving import ShardedTransformer

    ref = default["reference"]["by_tokens"]
    env = {**PHASE10_ENV, "TPU_MESH": f"tp={tp}", "HTTP_PORT": str(free_port())}
    for key in ("DECODE_POOL", "KV_PAGED", "KV_BLOCKS", "KV_BLOCK_TOKENS", "DECODE_PIPELINE",
                "SCHED_POLICY", "SCHED_MAX_DEFER_MS", "TPU_BOOT"):
        os.environ.pop(key, None)
    os.environ.update(env)
    t0 = time.perf_counter()
    app = None
    try:
        with two_shard_enumeration(torch) if fake else contextlib.nullcontext():
            app = gofr_tpu_torch.new(model=model)
            gofr_tpu_torch.register_openai_routes(app)
            app.start()
        boot_s = time.perf_counter() - t0
        dev = app.container.tpu
        pool, runner = dev.decode_pool, dev.runner
        n_layers, chunk = runner.cfg.n_layers, pool.chunk
        port = app.http_port
        print(f"mesh (b): booted in {boot_s:.1f}s ({dev.describe()}), memory "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
        check(isinstance(runner.model, ShardedTransformer), "mesh (b): the runner is unsharded")
        check(pool is not None and dev.kv_pool is not None and runner.prefill_chunk_bucket == 512,
              f"mesh (b): the pool, paged KV or chunked prefill is off under tp={tp}")
        held = {str(d): torch.cuda.memory_allocated(d) / 2**30
                for d in sorted(set(runner.model.mesh.devices), key=str)}
        print(f"mesh (b): GiB allocated by device {held}", flush=True)
        generations: list = []
        inner = dev.generate

        def recording_generate(tokens, *args, **kwargs):
            out = inner(tokens, *args, **kwargs)
            generations.append(([int(t) for t in tokens], out))
            return out

        dev.generate = recording_generate
        in_pool = {"decode": 0, "dispatches": 0}
        dispatch = pool._dispatch_chunk

        def counted_dispatch(*args, **kwargs):
            before = flash.launches_fwd_decode.value
            out = dispatch(*args, **kwargs)
            in_pool["decode"] += flash.launches_fwd_decode.value - before
            in_pool["dispatches"] += 1
            return out

        pool._dispatch_chunk = counted_dispatch
        greedy = {"max_tokens": 32, "temperature": 0}
        prompts8 = default["reference"]["prompts"]
        # every count to 0 just before the served traffic
        for c in fwd_counters(flash):
            c.reset()
        p0 = runner.prefills
        rates, tpots = {}, {}
        for k, prompts in ((1, [text(10, 100)]), (8, prompts8)):
            results, starts = [None] * k, [None] * k

            def run(i, prompts=prompts, results=results, starts=starts):
                starts[i] = time.perf_counter()
                results[i] = post(port, {"prompt": prompts[i], "stream": True, **greedy},
                                  stream=True)

            threads = [threading.Thread(target=run, args=(i,)) for i in range(k)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            rates[k], tpots[k], counts = stream_rate(starts, results)
            print(f"mesh (b): {k} concurrent greedy streams ({counts}): aggregate "
                  f"{rates[k]:.1f} tokens/s, TPOT {tpots[k]:.2f} ms (phase 10 unsharded: "
                  f"{default['metrics']['aggregate_tokens_per_s'][k]:.1f} tokens/s, TPOT "
                  f"{default['metrics']['tpot_ms'][k]:.2f} ms); two shards on one card double "
                  "the launches of a host-bound path: not a two-GPU mesh's speed", flush=True)
        p1 = runner.prefills
        long = text(7, 1500)
        status, frames, _, _ = post(port, {"prompt": long, "stream": True, **greedy}, stream=True)
        check(status == 200 and frames[-1] == "[DONE]", f"mesh (b): chunked prompt {status}")
        check(runner.prefills - p1 == 3, "mesh (b): the 1,500-byte prompt was not 3 slices")
        hits = runner.prefix_stats["hits"]
        status, _, _, _ = post(port, {"prompt": long, **greedy})
        check(status == 200 and runner.prefix_stats["hits"] == hits + 1,
              "mesh (b): the repeat missed the prefix cache")
        launches = {"sm90": flash.launches_fwd_sm90.value,
                    "decode": flash.launches_fwd_decode.value,
                    "all": flash.launches.value,
                    "prefill_dispatches": runner.prefills - p0,
                    "pool_dispatches": in_pool["dispatches"]}
        pool._dispatch_chunk = dispatch
        per_chunk = in_pool["decode"] / max(in_pool["dispatches"], 1)
        print(f"mesh (b): launches {launches}, decode {per_chunk} a pool chunk ({tp} shards x "
              f"n_layers x DECODE_CHUNK = {tp * n_layers * chunk})", flush=True)
        check(per_chunk == tp * n_layers * chunk, "mesh (b): a pool chunk missed a shard's kernel")
        check(launches["sm90"] >= tp * n_layers * launches["prefill_dispatches"],
              "mesh (b): a prefill shard missed the sm90 kernel")
        check(launches["all"] == launches["sm90"] + launches["decode"],
              "mesh (b): a call took the mma kernel")
        ties, compared = [], 0
        for tokens, out in generations:
            want = ref.get(tuple(tokens))
            if want is None:
                continue
            compared += 1
            label = f"mesh (b) {len(tokens)}-token prompt"
            tie = mesh_tie_served(runner, tokens, want, out, label)
            ties.append(tie)
        same = sum(not t["diverged"] for t in ties)
        print(f"mesh (b): {compared} generations against phase 10's ids: {same} equal, "
              f"{compared - same} parting at a near tie", flush=True)
        check(compared == len(generations) == 11, f"mesh (b): {compared} of "
              f"{len(generations)} generations had phase 10's reference")
        engine = admin(port, "/admin/engine")
        print(f"mesh (b): /admin/engine mesh {engine['mesh']}, decode_pool mesh_axes "
              f"{engine['decode_pool']['mesh_axes']}, kv_blocks total "
              f"{engine['kv_blocks']['total']}", flush=True)
        check(engine["mesh"] == {"axes": {"tp": tp}, "devices": tp},
              f"mesh (b): /admin/engine mesh {engine['mesh']}")
        check(engine["decode_pool"]["mesh_axes"] == {"tp": tp} and engine["kv_blocks"]["total"] > 0,
              "mesh (b): the pool's mesh_axes or kv_blocks")
        series = scrape(port)
        gauge = series.get('gofr_tpu_mesh_axis_size{axis="tp"}')
        degrades = sample_sum(series, "gofr_tpu_mesh_degrade_total")
        check(gauge == tp and series.get('gofr_tpu_mesh_axis_size{axis="dp"}') == 1.0,
              f"mesh (b): gofr_tpu_mesh_axis_size tp {gauge}")
        check(degrades == 0, f"mesh (b): gofr_tpu_mesh_degrade_total {degrades}")
        flights = admin(port, "/admin/requests?limit=20")["requests"]
        stamped = [f for f in flights if f.get("mesh_axes") == {"tp": tp}]
        print(f"mesh (b): gofr_tpu_mesh_axis_size tp {gauge:g}, degrades {degrades:g}, "
              f"{len(stamped)} of {len(flights)} flight records carry mesh_axes {{'tp': {tp}}}",
              flush=True)
        check(flights and len(stamped) == len(flights), "mesh (b): a flight record lacks mesh_axes")
    finally:
        if app is not None:
            close_leg(app, f"mesh (b) tp={tp}")
        os.environ.pop("TPU_MESH", None)
    check(not pool._thread.is_alive(), "mesh (b): the pool's worker outlived app.shutdown()")
    return {"tp": tp, "gib_allocated": held, "boot_s": boot_s,
            "aggregate_tokens_per_s": rates, "tpot_ms": tpots,
            "launches": launches, "per_chunk": per_chunk, "ties": ties}


def mesh_tie_served(runner, tokens: list, want: list, got: list, label: str) -> dict:
    """A served generation against phase 10's ids for the same prompt under
    the near-tie rule, the gap read off the tp = 2 runner teacher-forced on
    phase 10's ids (``first_divergence``)."""
    if got == want:
        return {"diverged": False}
    return first_divergence(runner, tokens, want, got, label)


def mesh_refusal(torch, model) -> dict:
    """Phase 21 (c): with the real enumeration (one card) ``TPU_MESH=tp=2``
    fails its boot with the JAX package's message, and the device ends
    ``failed``."""
    import gofr_tpu_torch

    env = {**PHASE10_ENV, "TPU_MESH": "tp=2", "HTTP_PORT": str(free_port()),
           "TPU_BOOT": "background"}
    os.environ.update(env)
    try:
        app = gofr_tpu_torch.new(model=model)
        dev = app.container.tpu
        try:
            try:
                dev.wait_ready(120)
                refused = None
            except Exception as exc:  # the boot's error, as a request sees it
                refused = repr(exc.__cause__ or exc)
            status = dict(dev.boot_status)
        finally:
            app.shutdown()
    finally:
        for key in ("TPU_MESH", "TPU_BOOT"):
            os.environ.pop(key, None)
    want = "needs 2 devices, have 1"
    print(f"mesh (c): TPU_MESH=tp=2 with the real enumeration ({torch.cuda.device_count()} "
          f"card): boot {status['state']}, {refused}", flush=True)
    check(status["state"] == "failed" and refused is not None and want in refused,
          f"mesh (c): the one-card boot did not fail with '{want}'")
    return {"state": status["state"], "error": refused}


def mesh_cards(torch, flash, card: str) -> int:
    """``--mesh-cards``: phase 21's legs over distinct cards (a machine
    with two or more): phases 5 and 10 on cuda:0 for the weights and the
    reference ids, then (a) tp = 2 over [cuda:0, cuda:1] and tp = every
    card, (b) ``TPU_MESH=tp=<cards>`` served over the real enumeration;
    then phase 9 and phase 22's legs over [cuda:0, cuda:1]. Prints one
    ``mesh-cards`` line."""
    n = torch.cuda.device_count()
    check(n >= 2, f"--mesh-cards needs two or more cards, have {n}")
    cards = [torch.device("cuda", i) for i in range(n)]
    _, model = serve(torch, flash, card)
    gc.collect()
    torch.cuda.empty_cache()
    default = serve_default(torch, flash, card, model)
    gc.collect()
    torch.cuda.empty_cache()
    legs = {"direct_tp2": mesh_direct(torch, flash, model, cards[:2])}
    if n > 2:
        legs[f"direct_tp{n}"] = mesh_direct(torch, flash, model, cards)
    gc.collect()
    torch.cuda.empty_cache()
    legs["served"] = mesh_served(torch, flash, card, model, default, tp=n, fake=False)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    train = train_llama(torch, flash, card)
    gc.collect()
    torch.cuda.empty_cache()
    legs["train"] = mesh_training(torch, flash, card, train, gen, cards[:2])
    legs["multihost"] = multihost_cards()
    print(f"mesh-cards [{card}] x {n}: {json.dumps(legs)}", flush=True)
    return 0


# the CPU tests' multihost worker (tests/test_torch_multihost.py) on a card
MULTIHOST_WORKER = """
from gofr_tpu_torch.config import EnvFileConfig
from gofr_tpu_torch.parallel import multihost

cfg = EnvFileConfig()
assert multihost.init_from_config(cfg) is True
assert multihost.init_from_config(cfg) is True
info = multihost.process_info()
assert info["process_count"] == 2 and info["global_devices"] == 2 * info["local_devices"], info
total = multihost.global_psum_check()
assert total == info["global_devices"], (total, info)
print(f"rank {info['process_id']} OK total={total}", flush=True)
multihost.shutdown()
"""


def multihost_cards() -> dict:
    """Two ranks, one card each (``CUDA_VISIBLE_DEVICES``), join a process
    group over NCCL on localhost and run the multihost worker's checks;
    each is killed after 120 s."""
    from gofr_tpu_torch.config import DECLARED_KEYS

    port, here = free_port(), os.path.dirname(os.path.abspath(__file__))
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in DECLARED_KEYS}
        env.update(TPU_COORDINATOR=f"127.0.0.1:{port}", TPU_NUM_PROCESSES="2",
                   TPU_PROCESS_ID=str(rank), TORCH_DEVICE="cuda", CUDA_VISIBLE_DEVICES=str(rank),
                   PYTHONPATH=os.pathsep.join([here, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen([sys.executable, "-c", MULTIHOST_WORKER], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    for rank, (p, text_out) in enumerate(zip(procs, outputs)):
        print(f"multihost rank {rank} over NCCL: exit {p.returncode}: {text_out[-500:]}",
              flush=True)
        check(p.returncode == 0 and f"rank {rank} OK total=2.0" in text_out,
              f"multihost: rank {rank} failed")
    return {"ranks": 2, "ok": True}


def serving_mesh(torch, flash, card: str, model, default: dict, gen) -> dict:
    """Phase 21: the serving mesh on phase 5's weights in phase 10's
    configuration: the kernels at one tp shard's shapes, (a) the sharded
    model direct, (b) served over the harness's two shards of the card,
    (c) the one-card refusal. Prints one ``mesh`` line."""
    t0 = time.perf_counter()
    errs, rows = mesh_kernels(torch, flash, gen)
    direct = mesh_direct(torch, flash, model, [torch.device("cuda", 0)] * 2)
    gc.collect()
    torch.cuda.empty_cache()
    served_run = mesh_served(torch, flash, card, model, default)
    gc.collect()
    torch.cuda.empty_cache()
    refusal = mesh_refusal(torch, model)
    line = {"phase_s": time.perf_counter() - t0, "direct": direct, "served": served_run,
            "refusal": refusal, "kernel_rows": rows,
            "max_abs_err": {k: max(v) for k, v in errs.items()}}
    print(f"mesh [{card}]: {json.dumps(line)}", flush=True)
    return line


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
    check(tok.backend == "native", f"openai: the tokenizer's backend is {tok.backend}")
    # every text the phase encodes, for the native-against-Python check
    encoded: list = []
    native_encode = tok.encode

    def recording_encode(text_in):
        encoded.append(text_in)
        return native_encode(text_in)

    tok.encode = recording_encode
    generations: list = []
    inner = dev.generate

    def recording_generate(tokens, *args, **kwargs):
        out = inner(tokens, *args, **kwargs)
        generations.append((list(tokens), out, kwargs.get("sampler")))
        return out

    dev.generate = recording_generate
    for c in fwd_counters(flash):
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
    del tok.encode
    encode = native_python_encode(tok, encoded)
    return {"encode_ms": encode, "chat_ttft_ms": chat_ttft * 1e3, "chat_s": chat_s,
            "score_512_ms": score_s[0] * 1e3,
            "score_300_in_512_ms": score_s[1] * 1e3, "score_launches": score_launches,
            "score_lp_max_diff": float(diff.max()), "fanout_n4_s": fan_s,
            "pool_peak_active": peak["active"], "sm90": sm90, "decode": decode,
            "greedy_prompt": greedy[-1][0], "greedy_ids": greedy[-1][1]}


def native_python_encode(tok, texts: list) -> dict:
    """Phase 11's encoded texts through the served tokenizer's native
    backend and through its Python twin (the same merges): equal ids, and
    each backend's ms for all of them."""
    from gofr_tpu_torch.tokenizer import Tokenizer

    python = Tokenizer(tok.merges, tok.n_special)
    python._native = None
    out, ids = {}, {}
    for name, t in (("native", tok), ("python", python)):
        start = time.perf_counter()
        ids[name] = [t.encode(x) for x in texts]
        out[name] = (time.perf_counter() - start) * 1e3
    check(bool(texts) and ids["native"] == ids["python"],
          "openai: native and Python encodes of the phase's texts differ")
    print(f"openai: the phase's {len(texts)} encoded texts ({sum(map(len, texts))} chars, "
          f"{sum(map(len, ids['native']))} ids): native {out['native']:.3f} ms, Python "
          f"{out['python']:.3f} ms, ids equal", flush=True)
    return out


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
# greedy tokens a request of phase 12's streams (each mode's, the f8
# cache's, MODEL_PATH's): every check holds at any length
DEPLOY_TOKENS = 16
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


# the joined dispatch records (costcal.join_records) of every healthy leg
# of phases 12-14 and 21 at full width, for the run's per-path fit
# (print_cost_fits): the rows tpu/cost_profile.json commits under the
# card's ``paths``
COST_RECORDS: list = []


def healthy_costs(dev, label: str) -> dict:
    """A healthy leg's cost model, read before its app shuts down: its
    serving path, each path's dispatches (judged: the path has a fitted row
    in tpu/cost_profile.json, and those contending work shared are judged
    against their prediction plus the contenders'; unfitted: predicted,
    never judged), the anomalies with each one's path, prediction and
    observation, and its joined records kept for the run's fit (the tiny
    model's stay out: its host-bound rates would price a full-width
    deployment on the same path). Fails on any anomaly, and on a dispatch
    of a fitted path that went unjudged."""
    from gofr_tpu_torch.tpu.costcal import join_records

    costmodel = dev.costmodel
    snap = costmodel.snapshot()
    records = dev.timeline.records(limit=1 << 20)
    if dev.model_name != "tiny":
        COST_RECORDS.extend(join_records(records, snap["sheets"]))
    by_path: dict = {}
    unjudged = []
    largest = {"alone": 0.0, "shared": 0.0}  # the largest residual ratio of each
    for r in records:
        if r.get("cost_path") is not None and r["status"] == "ok":
            verdict = ("unfitted" if not r["cost_judged"] else
                       "judged shared" if r["cost_shared_ms"] else "judged")
            key = f"{r['cost_path']} {verdict}"
            by_path[key] = by_path.get(key, 0) + 1
            if r["cost_judged"] and r["residual_ratio"] is None:
                unjudged.append(r["dispatch_id"])
            elif r["cost_judged"]:
                side = "shared" if r["cost_shared_ms"] else "alone"
                largest[side] = max(largest[side], r["residual_ratio"])
    # the ring is shared with the SLO engine's burn alerts (as in the JAX
    # package): the cost model's verdicts are the dispatch causes
    ring = costmodel.ring.events(limit=costmodel.ring.capacity)
    events = [e for e in ring if e["cause"] in ("slow_dispatch", "ema_drift")]
    others = sorted({e["cause"] for e in ring} - {"slow_dispatch", "ema_drift"})
    print(f"cost [{label}]: path {snap['path']}, dispatches {by_path}, unfitted "
          f"{snap['unfitted']}, anomalies {len(events)}, largest ratio alone "
          f"{largest['alone']:.3f}, shared {largest['shared']:.3f}; other ring events "
          f"{len(ring) - len(events)} {others}", flush=True)
    for e in events:
        print(f"cost [{label}]: anomaly {e['cause']} {e['kind']}/{e['bucket']} batch "
              f"{e['batch_size']} path {e.get('path')}: {e['observed_ms']} ms against "
              f"{e['predicted_ms']} predicted ({e.get('shared_ms')} of it contending work; "
              f"x{e['residual_ratio']}, EMA {e['ema']})", flush=True)
    check(not unjudged, f"{label}: dispatches {unjudged} of a fitted path went unjudged")
    check(not events, f"{label}: healthy traffic raised {len(events)} cost-model anomalies")
    return {"path": snap["path"], "dispatches": by_path, "anomalies": len(events)}


def close_leg(app, label: str) -> None:
    """Shut a leg's app down; when the leg ended cleanly, first hold its
    healthy traffic to zero anomalies (``healthy_costs``)."""
    try:
        if sys.exc_info()[0] is None:
            healthy_costs(app.container.tpu, label)
    finally:
        app.shutdown()


def print_cost_fits(card: str) -> dict:
    """The per-path fit (``costcal.fit_paths``) of every healthy leg's
    records this run (``COST_RECORDS``), each row with its residual ratios
    by family (min / median / max): the rows tpu/cost_profile.json commits
    under the card's ``paths`` (bf16 keeps phase 17's)."""
    import numpy as np

    from gofr_tpu_torch.tpu.costcal import fit_paths

    rows = fit_paths(COST_RECORDS, card.split(",")[0])
    for path, row in rows.items():
        ratios: dict = {}
        for rec in COST_RECORDS:
            if rec.get("path") != path:
                continue
            predicted = (max(rec["flops"] / row["eff_flops"],
                             rec["bytes_accessed"] / row["eff_bw"]) * 1e3 + row["overhead_ms"])
            ratios.setdefault(f"{rec['kind']}/{rec['bucket']}", []).append(
                rec["duration_s"] * 1e3 / predicted)
        row["source"] = (f"fit: chip_smoke.py phases 12-14 and 21 at full width, contending "
                         f"dispatches left out, {card}")
        print(f"cost: fitted row {path} " + json.dumps({k: row[k] for k in (
            "eff_flops", "eff_bw", "overhead_ms", "eff_flops_source", "eff_bw_source",
            "n_compute_bound", "n_bandwidth_bound", "source")}), flush=True)
        print(f"cost: residual ratios of {path} on its fitted row (min/median/max) "
              + json.dumps({f: [round(min(v), 3), round(float(np.median(v)), 3),
                                round(max(v), 3)] for f, v in sorted(ratios.items())}),
              flush=True)
    return rows


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
def admitted_together(pool, n: int, timeout_s: float = 60.0):
    """Hold the pool worker's first admission inside the block until ``n``
    requests hold slots (or ``timeout_s``), so the next chunk carries all
    ``n``: a replayed chunk decodes a stream's 32 tokens in under half a
    second, less than the spread of ``n`` prefills, so streams sent
    together need not share the pool otherwise. The worker waits on the
    pool's own condition, which releases the lock to the submits."""
    admit = pool._admit_pending
    held = [True]

    def gated():
        t0 = time.monotonic()
        while held[0] and len(pool._active) < n and time.monotonic() - t0 < timeout_s:
            pool._work.wait(0.05)
        held[0] = False
        admit()

    pool._admit_pending = gated
    try:
        yield
    finally:
        vars(pool).pop("_admit_pending", None)


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
    for c in fwd_counters(flash):
        c.reset()  # every count to 0 just before the path runs
    tally = {"sm90": 0, "decode": 0, "mma": 0}  # the served requests' launches
    cfg = model.cfg
    prompts4 = [text(300 + i, 120 + 90 * i) for i in range(4)]
    greedy = {"max_tokens": DEPLOY_TOKENS, "temperature": 0}
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
        close_leg(app, f"deployment {label}")
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
                                                    {"max_tokens": DEPLOY_TOKENS, "temperature": 0})
        n_layers = dev.runner.cfg.n_layers
        check(block["dispatches"] > 0, "deployment f8: the streams did not decode in the pool")
        a_step = block["in_pool"] / (block["dispatches"] * pool.chunk)
        print(f"deployment f8: 8 concurrent greedy streams ({counts} tokens): aggregate "
              f"{rate:.1f} tokens/s, TPOT {tpot:.2f} ms; decode launches {a_step} a step "
              f"(n_layers {n_layers})", flush=True)
        check(a_step == n_layers, "deployment f8: not n_layers decode launches a step")
        upcast = upcast_ms(torch, dev.runner.model)  # off the served path
    finally:
        close_leg(app, "deployment f8")
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
        close_leg(app, "penalties")
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
                status, _, _, _ = post(app.http_port, {"prompt": prompt,
                                                       "max_tokens": DEPLOY_TOKENS,
                                                       "temperature": 0})
            check(status == 200, f"model_path: {status}")
            cut = next((i for i, t in enumerate(ids) if t in EOS_IDS), len(ids))
            check(generations[-1][1] == ids[:cut],
                  "model_path: greedy ids differ from (a)'s int8 model")
        print(f"model_path: greedy ids of {len(prompts)} prompts equal (a)'s int8 model's; "
              f"default stops {sorted(dev.default_stop_ids)}", flush=True)
    finally:
        close_leg(app, "model_path int8")
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
    its route and instance, device time, bound, SDPA's time and the mma
    kernel's (the widths past 4 ran on it before the decode variant's two
    row tiles): the pool's [8, w] verify over a 2048-slot cache at each
    width of SPEC_K_MAX=4's ladder and at SPEC_K_MAX=7's widest (8), and
    the solo verify of DRAFT_TOKENS=4 (k + 1 = 5) at kv_len 1800. The mma
    kernel is held to the plain version at each shape too, through the
    override. -> (max errors by variant, timing rows by name)."""
    errs = {"decode": [], "mma": []}
    widths = (2, 4, 5, 8)
    cases = {f"verify B=8 Sq={w}": verify_case(torch, gen, w, VERIFY_LENGTHS) for w in widths}
    cases["verify B=1 Sq=5 kv_len 1800"] = verify_case(torch, gen, 5, [1795])
    rows = {}
    for name, case in cases.items():
        out, _, _ = compare(torch, flash, name, case, errs=errs)
        check_tail_invisible(torch, flash, name, case, out)
        mma, _, _ = compare(torch, flash, f"{name} (mma)", case, errs=errs, variant="mma")
        check_tail_invisible(torch, flash, f"{name} (mma)", case, mma, variant="mma")
        rows[name] = time_shape(torch, flash, name, case, 50, device=True)
    check([rows[f"verify B=8 Sq={w}"]["instance"] for w in widths]
          == ["decode", "decode", "decode_r2", "decode_r2"]
          and rows["verify B=1 Sq=5 kv_len 1800"]["instance"] == "decode_r2",
          "verify: widths 2 and 4 must take the decode variant's one-tile instance, 5 and 8 "
          "its two-tile instance")
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
    decode variant while width x groups fits its two m16 row tiles (up to
    8 at llama3-8b's groups of 4), else mma."""
    return "decode" if width * (cfg.n_heads // cfg.n_kv_heads) <= flash.FWD_DECODE_ROWS else "mma"


def verifies_of(flash, cfg, width: int, calls: int) -> dict:
    """``served_spec``'s verifies for ``calls`` verifies of ``width``:
    n_layers launches each, all on the width's route (and its instance)."""
    row = {"calls": calls, "decode": 0, "decode_r2": 0, "mma": 0}
    route = verify_route(flash, cfg, width)
    row[route] = cfg.n_layers * calls
    groups = cfg.n_heads // cfg.n_kv_heads
    if route == "decode" and flash.fwd_decode_row_tiles(width, groups) == 2:
        row["decode_r2"] = cfg.n_layers * calls
    return {width: row}


def spec_tally() -> dict:
    """Phase 13's launch counts of served requests: verifies by width
    (calls, decode-route launches and of them the two-row-tile instance's,
    mma-route launches), draft-chunk, plain-chunk and prefill launches."""
    return {"verify": {}, "draft": 0, "plain": 0, "prefill_sm90": 0, "prefill_decode": 0}


VERIFY_ROW = ("calls", "decode", "decode_r2", "mma")  # a width's tally


@contextlib.contextmanager
def served_spec(flash, dev, tally: dict, label: str):
    """Phase 13's ``served``: counts the forward's launches of the served
    requests inside the block, and only those (the plain baselines, the
    near-tie reference and the boot warm-ups stay out), into ``tally`` by
    what launched them: the target's verifies by width, the draft's
    chunks, the pool's plain chunks, and the rest (the prefills). Holds
    each call to its work: a verify of width w launches the forward
    n_layers times, all on w's route (``verify_route``) and, on the decode
    route, on w's instance (``fwd_decode_row_tiles``); a draft chunk the
    decode variant n_layers x k times; a plain pool chunk n_layers x
    DECODE_CHUNK times; the rest is prefill, n_layers launches a prefill
    at least (sm90, or the decode variant for a tail of a few tokens) and
    no mma. A prefill on another thread during a pool call adds only sm90
    launches (buckets >= 64): those stay the prefills'. Yields the block's
    verifies by width, drafts, plain chunks and prefills, filled when it
    ends."""
    runner, pool = dev.runner, dev.decode_pool
    cfg = runner.cfg
    groups = cfg.n_heads // cfg.n_kv_heads
    counters = {"all": flash.launches, "sm90": flash.launches_fwd_sm90,
                "decode": flash.launches_fwd_decode,
                "decode_r2": flash.launches_fwd_instance["decode_r2"]}

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
            wide = route == "decode" and flash.fwd_decode_row_tiles(w, groups) == 2
            check(n[route] == cfg.n_layers and n[other] == 0
                  and n["decode_r2"] == (cfg.n_layers if wide else 0),
                  f"{label}: a verify of width {w} launched {n}, want n_layers = "
                  f"{cfg.n_layers} on the {route} route"
                  f"{' (its two-row-tile instance)' if wide else ''}")
            row = verifies.setdefault(w, dict.fromkeys(VERIFY_ROW, 0))
            row["calls"] += 1
            row[route] += n[route]
            row["decode_r2"] += n["decode_r2"]
        elif kind == "draft":
            want = runner.spec.cfg.n_layers * runner.spec.k
            check(n["decode"] == want and n["mma"] == n["sm90"] == n["decode_r2"] == 0,
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
        t = tally["verify"].setdefault(w, dict.fromkeys(VERIFY_ROW, 0))
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
    decode route's two-row-tile instance."""
    solo_prompts = [text(400 + i, 150 + 60 * i) for i in range(4)]
    app = boot_deployment(model, {"DECODE_POOL": "off"})
    try:
        dev = app.container.tpu
        generations = recorded(dev)
        plain_tpot, _ = solo_streams(app.http_port, solo_prompts, body)
        plain_ids = [ids_for(dev, generations, p)[-1] for p in solo_prompts]
    finally:
        close_leg(app, "spec solo plain")
    print(f"spec solo: plain solo decode TPOT {plain_tpot:.2f} ms over {len(solo_prompts)} "
          f"requests of 32 tokens", flush=True)
    out["solo"] = {"plain_tpot_ms": plain_tpot}
    # the seeded draft accepts nearly nothing, so each token costs a verify
    # and a full-size draft chunk (~5x plain solo's TPOT): two prompts
    for label, env, prompts in (("checkpoint draft", {"DRAFT_MODEL_PATH": ckpt}, solo_prompts),
                                ("seeded draft", {}, solo_prompts[:2])):
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
                tpot, counts = solo_streams(app.http_port, prompts, body)
            stats = {k: runner.spec_stats[k] - s0[k] for k in s0}
            check(stats["cycles"] > 0, f"spec solo {label}: no spec cycle ran")
            check(block["drafts"] == stats["cycles"] and block["verifies"] == verifies_of(
                      flash, runner.cfg, 5, stats["cycles"]),
                  f"spec solo {label}: verifies {block['verifies']} and {block['drafts']} draft "
                  f"chunks, want one each a cycle ({stats['cycles']}), of width 5")
            divergences = [
                first_divergence(runner, list(dev._encode(p)), want,
                                 ids_for(dev, generations, p)[-1], f"spec solo {label}")
                for p, want in zip(prompts, plain_ids)
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
            close_leg(app, f"spec solo {label}")
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
    at width 5, the ladder's widest rung (the decode route's two-row-tile
    instance), which must run."""
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
        close_leg(app, "spec pooled plain")
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
        close_leg(app, "spec pooled")


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
            close_leg(app, f"tiny f32 {label}")
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
            print(f"spec {mode}: width {w}: {n['calls']} verifies, {n['decode']} decode-route "
                  f"({n['decode_r2']} on its two-row-tile instance) and {n['mma']} mma-route "
                  f"launches ({verify_route(flash, model.cfg, w)} route, {n_layers} a verify)",
                  flush=True)
    verify = [n for t in tallies.values() for n in t["verify"].values()]
    out["launches"] = {
        "verify_decode": sum(n["decode"] - n["decode_r2"] for n in verify),
        "verify_decode_r2": sum(n["decode_r2"] for n in verify),
        "verify_mma": sum(n["mma"] for n in verify),
        "pool_width_5": tallies["pool"]["verify"].get(5, {}).get("decode_r2", 0),
        "draft": tallies["solo"]["draft"],
        "plain": tallies["pool"]["plain"],
        "prefill_sm90": sum(t["prefill_sm90"] for t in tallies.values()),
        "prefill_decode": sum(t["prefill_decode"] for t in tallies.values()),
    }
    out["max_abs_err"] = {k: max(v) for k, v in errs.items()}
    print(f"spec: forward launches of the served speculative requests {out['launches']}",
          flush=True)
    check(all(out["launches"][k] > 0 for k in ("verify_decode", "verify_decode_r2",
                                               "pool_width_5", "draft", "prefill_sm90")),
          "spec: a forward route of the phase never ran")
    check(out["launches"]["verify_mma"] == 0, "spec: a served verify took the mma kernel")
    out["phase_s"] = time.perf_counter() - t0
    print(f"spec-metrics [{card}]: {json.dumps(out)}", flush=True)
    return out


# -- phase 14: multi-LoRA --------------------------------------------------------

# rank 8 over all eight keys of llama3-8b: (in + out) x 8 for each of 7 x 32
# layer weights and the lm_head (4096 + 128256)
LORA_RANK, LORA_ALPHA, LORA_LR = 8, 16.0, 1e-2
LORA_PARAMS = 22_030_336
LORA_STEPS = 2
# the adapter stream that holds a slot while a third adapter loads (its
# deferred bank swap): 96 tokens outlast the load and the penalized request
# beside it many times over
LORA_LIVE_TOKENS = 96
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
        if not out["mixed"]["mixed_chunks"]:
            # the 8 mixed streams need not overlap in the pool (a base row's
            # replayed chunks outrun the adapter rows' solo prefill): the same
            # 8 again, admitted together
            pool._dispatch_chunk = seen
            try:
                mixed.clear()
                with served(flash, dev, tally, "lora mixed together"), \
                        admitted_together(pool, len(prompts)):
                    mixed_streams(port, prompts, MIXED_MODELS, greedy)
            finally:
                pool._dispatch_chunk = dispatch
            out["mixed"]["mixed_chunks_together"] = sum(1 for lo, n, a in mixed
                                                        if lo and 0 < n < a)
            out["mixed"]["mixed_chunks"] = out["mixed"]["mixed_chunks_together"]
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
        # an adapter's own device memory against the shapes' reckoning, both
        # allocator readings with the pool quiesced: no slot active (so no
        # chunk in flight), the batcher's queue empty, the card drained
        out["adapter_bytes"] = adapter_bytes(
            torch, dev, pool, model, lora,
            lambda: restore_params(paths["calm"], model.device))
        ab = out["adapter_bytes"]
        check(ab["reckoned"] <= ab["requested"] <= ab["reckoned"] + (1 << 20)
              and ab["allocations"] == ab["storages"], "lora: an adapter is not its own bytes")
        # the allocator's blocks past what the allocations asked for: at most
        # one large block's unsplit remainder (<= 1 MiB) and the rounding of
        # the rest (48,252 B at rank 8 on the H100), within 64 KiB
        check(ab["added"] - ab["requested"] <= (1 << 20) + (64 << 10),
              f"lora: the allocator holds {ab['added'] - ab['requested']} B past the adapter's "
              f"{ab['requested']} requested, more than one block's remainder and the rounding")
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
        close_leg(app, "lora serve")
    return out, keep


def adapter_bytes(torch, dev, pool, model, lora, load) -> dict:
    """An adapter's device bytes: the allocator's readings across its load
    onto the card (``load()``) and ``apply_adapter``, taken with the pool
    and the batcher idle, beside the adapter's own tensor bytes (the
    storages its A, B and scale tensors hold: A and B are ``reckoned``
    exactly) and the allocation count's change, so a reading past them
    names another allocation, not the adapter. ``requested`` is what the
    allocations asked for; ``added`` also holds the allocator's blocks
    around them (512-byte rounding, and a large block's remainder of up to
    1 MiB that the allocator keeps unsplit, whether it does depending on
    what its cache held)."""
    pool_idle(pool, "lora adapter bytes")
    for _ in range(200):
        if dev.batcher._depth() == 0:
            break
        time.sleep(0.05)
    check(dev.batcher._depth() == 0, "lora adapter bytes: the batcher never drained")
    torch.cuda.synchronize()
    stats0 = torch.cuda.memory_stats()
    probe = lora.apply_adapter(model, load())
    torch.cuda.synchronize()
    stats1 = torch.cuda.memory_stats()
    storages: dict = {}
    for _, _, w in lora.wrapped_weights(probe):
        for name, t in (("ab", w.lora_a), ("ab", w.lora_b), ("scale", w.lora_scale)):
            st = t.untyped_storage()
            storages[st.data_ptr()] = (name, st.nbytes())
    del probe
    own = {k: sum(n for kind, n in storages.values() if kind == k) for k in ("ab", "scale")}
    out = {
        "added": stats1["allocated_bytes.all.current"] - stats0["allocated_bytes.all.current"],
        "requested": (stats1["requested_bytes.all.current"]
                      - stats0["requested_bytes.all.current"]),
        "reckoned": LORA_PARAMS * 2, "own_ab_bytes": own["ab"], "own_scale_bytes": own["scale"],
        "storages": len(storages),
        "allocations": stats1["allocation.all.current"] - stats0["allocation.all.current"],
        "bank_bytes": sum(t.numel() * t.element_size() for t in pool._lora_model.buffers()
                          if t is not model.freqs),
    }
    out["unexplained"] = out["added"] - own["ab"] - own["scale"]
    print(f"lora: loading an adapter added {out['added'] / 1e6:.2f} MB of device memory "
          f"({out['requested']} B requested; pool and batcher idle), reckoned "
          f"{out['reckoned'] / 1e6:.2f} MB (rank {LORA_RANK}, "
          f"eight keys); its own A and B {own['ab']} B, scales {own['scale']} B in "
          f"{len(storages)} storages, {out['allocations']} allocations, {out['unexplained']} B "
          f"besides; the bank {out['bank_bytes'] / 1e6:.2f} MB", flush=True)
    check(own["ab"] == out["reckoned"], f"lora: the adapter's A and B hold {own['ab']} B, "
          f"not the reckoned {out['reckoned']}")
    return out


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
        port, {"prompt": prompts[2], "max_tokens": LORA_LIVE_TOKENS, "temperature": 0,
               "adapter": "calm",
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
            close_leg(app, "lora merged")
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
        for c in fwd_counters(flash):
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
    library unloaded first so the boot loads it; a failed background boot
    rebuilt by the health check (``failed_boot``); the echo runner under
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

    out["failed_boot"] = failed_boot(torch, flash)

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


def failed_boot(torch, flash) -> dict:
    """Phase 16 (b): the tiny model on the card with TPU_BOOT=background,
    its build made to fail once (as gofr_tpu's
    test_failed_background_boot_recovers makes it): readiness 503
    ``failed``, then a health check that rebuilds (UP, ``reinitialized``)
    and flips readiness to 200, and a completion served on the card
    through the forward kernel. Then a ValueError boot: DOWN, and the
    health check never rebuilds it."""
    import gofr_tpu_torch
    from gofr_tpu_torch.tpu.device import TPUDevice

    build = TPUDevice._build_stack
    calls = {"n": 0}

    def flaky(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient init failure (chip_smoke.py phase 16)")
        return build(self, *args, **kwargs)

    def bad_config(self, *args, **kwargs):
        calls["n"] += 1
        raise ValueError("a configuration error (chip_smoke.py phase 16)")

    env = {"MODEL_NAME": "tiny", "TOKENIZER": "byte", "TORCH_DEVICE": "cuda",
           "TPU_BOOT": "background"}
    out: dict = {}
    try:
        TPUDevice._build_stack = flaky
        with environment({**env, "HTTP_PORT": str(free_port())}):
            app = gofr_tpu_torch.new()
        gofr_tpu_torch.register_openai_routes(app)
        app.start()
        try:
            port, dev = app.http_port, app.container.tpu
            check(dev._ready.wait(120), "failed boot: the boot never ended")
            status, _, body = get_raw(port, "/.well-known/ready")
            check(status == 503 and json.loads(body)["state"] == "failed",
                  f"failed boot: readiness {status} {body}")
            t = time.perf_counter()
            health = dev.health_check()
            out["rebuild_s"] = time.perf_counter() - t
            status, _, body = get_raw(port, "/.well-known/ready")
            check(health["status"] == "UP" and health["details"].get("reinitialized") is True
                  and status == 200, f"failed boot: health {health}, readiness {status} {body}")
            launches = flash.launches.value
            status, data, _, _ = post(port, {"prompt": ECHO_PROMPT, "max_tokens": 4,
                                             "temperature": 0})
            check(status == 200 and data["usage"]["completion_tokens"] >= 1
                  and dev.device.type == "cuda" and flash.launches.value > launches,
                  f"failed boot: the completion after the rebuild: {status} {data}")
            out["after"] = dev.health_check()["details"]
        finally:
            app.shutdown()
        print(f"host: a failed background boot rebuilt by the health check in "
              f"{out['rebuild_s']:.2f}s (builds {calls['n']}), readiness 200, a completion "
              f"served on {dev.device}; probe {out['after']['probe_ms']:.3f} ms", flush=True)
        calls["n"] = 0
        TPUDevice._build_stack = bad_config
        with environment({**env, "HTTP_PORT": str(free_port())}):
            app = gofr_tpu_torch.new()
        try:
            dev = app.container.tpu
            check(dev._ready.wait(120), "failed boot: the ValueError boot never ended")
            verdicts = [dev.health_check()["status"] for _ in range(2)]
            check(verdicts == ["DOWN", "DOWN"] and calls["n"] == 1 and dev._boot_error_permanent,
                  f"failed boot: a ValueError boot answered {verdicts} after {calls['n']} builds")
        finally:
            app.shutdown()
        print(f"host: a ValueError boot stays DOWN, never rebuilt ({calls['n']} build)",
              flush=True)
    finally:
        TPUDevice._build_stack = build
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
    marker's launch and the next marker's; a CUDA graph's replay is one
    launch, every kernel of the graph under its correlation id."""
    with open(trace_path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    check(kernels, "obs: the trace holds no kernel (CUDA activity not recorded)")
    by_corr: dict = {}
    for e in kernels:
        by_corr.setdefault(e.get("args", {}).get("correlation"), []).append(e)
    marker_corrs = {c for c, es in by_corr.items() if any("spin" in e["name"] for e in es)}
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
            per_chunk[ids[k]] += sum(e["dur"] for e in by_corr[corr])
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


def observability(torch, flash, card: str, model, no_request_in_flight=contextlib.nullcontext
                  ) -> dict:
    """Phase 17 (after phase 16, on phase 5's model): the flight recorder,
    the dispatch timeline, the engine state and watchdog, the cost model,
    the profiler and the MFU / MBU gauges in phase 10's configuration.
    ``no_request_in_flight`` marks the profiler's stop and the trace's
    reading (``host_pauses``), which no served request overlaps."""
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
            out.update(healthy_window(torch, flash, card, app, fit, join_records, np,
                                      no_request_in_flight))
            out["spans"] = span_tree(app)
        finally:
            app.shutdown()
        out["stall"] = stalled_prefill(torch, model)
    finally:
        shutil.rmtree(profile_dir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"obs-metrics [{card}]: {json.dumps(out)}", flush=True)
    check(out["phase_s"] < 90, f"obs: phase 17 took {out['phase_s']:.1f}s")
    return out


class SpanList:
    """An in-memory span exporter (``tracing.Tracer``'s)."""

    def __init__(self):
        self.spans: list = []

    def export(self, span) -> None:
        self.spans.append(span)

    def shutdown(self) -> None:
        pass


def span_tree(app) -> dict:
    """Phase 17's trace: one served request through an in-memory exporter.
    ``tpu-batch`` (the prefill's dispatch) descends from the HTTP server
    span through the device's ``tpu-<model>-generate``; its
    ``tpu.device_time_us`` is above 0 and not below the dispatch's duration
    in the timeline less 10 %; the generate span's ``tpu.tokens_out`` is
    the completion's."""
    from gofr_tpu_torch import tracing

    port, dev = app.http_port, app.container.tpu
    exporter, previous = SpanList(), tracing.get_tracer()
    tracing.set_global_tracer(tracing.Tracer(exporter))
    try:
        status, data, _, _ = post(port, {"prompt": text(191, 300), "max_tokens": 8,
                                         "temperature": 0})
    finally:
        tracing.set_global_tracer(previous)
    check(status == 200, f"spans: {status} {data}")
    servers = [x for x in exporter.spans if x.name == "POST /v1/completions"]
    check(len(servers) == 1, f"spans: {len(servers)} server spans for one request")
    server = servers[0]
    trace = {x.span_id: x for x in exporter.spans if x.trace_id == server.trace_id}
    batch = [x for x in trace.values() if x.name == "tpu-batch"]
    generate = [x for x in trace.values() if x.name == f"tpu-{dev.model_name}-generate"]
    check(len(batch) == 1 and len(generate) == 1,
          f"spans: the trace holds {sorted(x.name for x in trace.values())}")
    batch, generate = batch[0], generate[0]
    chain, cursor = [batch.name], batch
    while cursor.parent_id in trace:
        cursor = trace[cursor.parent_id]
        chain.append(cursor.name)
    check(cursor is server and generate.name in chain,
          f"spans: tpu-batch's chain {chain} does not reach the server span")
    flight = [r for r in admin(port, "/admin/requests?limit=50")["requests"]
              if r["trace_id"] == server.trace_id]
    check(len(flight) == 1, "spans: no flight record for the traced request")
    dispatches = {r["dispatch_id"]: r for r in
                  admin(port, "/admin/dispatches?limit=512&kind=prefill")["dispatches"]}
    prefill = [dispatches[i] for i in flight[0]["dispatch_ids"] if i in dispatches]
    check(len(prefill) == 1, f"spans: the request's prefill dispatches {prefill}")
    device_us = int(batch.tags["tpu.device_time_us"])
    duration_us = prefill[0]["duration_s"] * 1e6
    out = {"chain": chain, "tags": batch.tags, "duration_us": duration_us,
           "tokens_out": generate.tags.get("tpu.tokens_out")}
    print(f"spans: {json.dumps(out)}", flush=True)
    check(device_us > 0 and device_us >= 0.9 * duration_us,
          f"spans: tpu.device_time_us {device_us} against the dispatch's {duration_us:.0f} us")
    check(batch.tags["tpu.model"] == dev.model_name and batch.tags["tpu.batch_size"] == "1",
          f"spans: tpu-batch's tags {batch.tags}")
    check(generate.tags.get("tpu.tokens_out") == str(data["usage"]["completion_tokens"]),
          f"spans: tpu.tokens_out {generate.tags}")
    return out


def healthy_window(torch, flash, card: str, app, fit, join_records, np,
                   no_request_in_flight) -> dict:
    """Phase 17's traffic on the auto-armed watchdog: 1 and 8 streams of 32
    greedy tokens (the 8 under the profiler), a 1,500-byte prompt (3 slices)
    and one full prefill batch (8 x 512 tokens); every request recorded,
    every dispatch id resolving, the timeline's counts the batcher's and the
    pool's, the dispatches under the profiler held out of the cost model and
    every other judged, zero anomalies on a fitted row, the gauges beside the
    predictions, and the row this run's records fit. ``no_request_in_flight``
    marks the profiler's stop and the trace's reading."""
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
    for c in fwd_counters(flash):
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
        with no_request_in_flight():
            status, stopped, stop_s, _ = post(port, {}, path="/admin/profiler/stop")
    ids_traced = dev.timeline.records(limit=1)[0]["dispatch_id"]
    check(status == 200 and stopped["data"]["artifacts"] == ["trace.json"],
          f"obs: stop {stopped}")
    trace = os.path.join(stopped["data"]["dir"], "trace.json")
    size_mb = os.path.getsize(trace) / 1e6
    with no_request_in_flight():
        t_parse = time.perf_counter()
        per_chunk, busy_us, window_us = chunk_kernel_us(trace, ids)
        # json.load builds the trace's millions of objects in one C call,
        # and the collector walks them all at its next young collection;
        # that and a full one run here, before the next request
        gc.collect()
        parse_s = time.perf_counter() - t_parse
    os.remove(trace)
    print(f"obs: the profiler's stop took {stop_s:.2f}s (its export); "
          f"reading its trace and a collection {parse_s:.2f}s, no request in flight", flush=True)
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
    # the cost model judges every clean dispatch but those the profiler's
    # trace slowed (its host cost is not in the model)
    judged = [r for r in dispatches if r["dispatch_id"] > ids0 and r["status"] == "ok"
              and r["predicted_ms"] is not None]
    traced = [r for r in judged if ids_before < r["dispatch_id"] <= ids_traced]
    untraced = [r for r in judged if not ids_before < r["dispatch_id"] <= ids_traced]
    # those that contending work shared (introspect.contends) are judged
    # against their prediction plus the contenders'
    shared = sum(1 for r in untraced if r.get("cost_shared_ms"))
    print(f"obs: {len(traced)} dispatches under the profiler held out of the cost model, "
          f"{len(untraced)} judged ({shared} priced with contending work)", flush=True)
    check(traced and all(r["residual_ratio"] is None for r in traced),
          "obs: a dispatch under the profiler was judged by the cost model")
    check(untraced and all(r["residual_ratio"] is not None for r in untraced),
          "obs: a dispatch with no trace on went unjudged by the cost model")
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
# a cut stream's budget in the reference request's wall time a chunk, where
# 1.5 s is shorter: the pool pipelines its chunks, so a new stream's second
# chunk (its 17th id) arrives ~3.5 of those after the request (~1.9 s at
# ~0.55 s a chunk on a loaded host); 5 hold at most 5 chunks (41 ids), under
# the 64-id reference
DEADLINE_CHUNKS = 5
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


def overload(torch, flash, card: str, model, ckpt: str) -> dict:
    """Phase 18 (after phase 17, on phase 5's model): deadlines, client
    aborts, brownout, a wedge with its recovery and resume, the device's
    probe after it, a restart from the WAL, the SLO engine and timebase,
    and the journal's cost, in phase 10's configuration with the journal on
    a WAL, recovery and SLO targets; then ``reinit`` from phase 12's
    checkpoint ``ckpt`` (``overload_reinit``)."""
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
        for c in fwd_counters(flash):
            c.reset()  # every count to 0 just before the path runs
        try:
            dev = app.container.tpu
            calls = id_recorder(dev)
            out["deadlines"] = overload_deadlines(flash, app, calls)
            out["aborts"] = overload_aborts(app, calls)
            out["wedge"], wedged = overload_wedge(torch, flash, app, calls, cps, model)
            # the device's probe after the wedge's recovery: a round trip on the card
            health = dev.health_check()
            out["health_after_recovery"] = health
            print(f"overload: health after the recovery {health['status']}, the probe's round "
                  f"trip {health['details'].get('probe_ms', 0):.3f} ms", flush=True)
            check(health["status"] == "UP" and health["details"]["probe_ms"] > 0,
                  f"overload: health after the recovery {health}")
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
        out["reinit"] = overload_reinit(torch, ckpt)
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


def overload_reinit(torch, ckpt: str) -> dict:
    """(8) The rebuild on device loss, from MODEL_PATH: an app in phase 10's
    configuration booted from phase 12's checkpoint serves 4 greedy
    prompts one at a time (the device probed meanwhile, under load), then
    ``reinit()`` tears the stack down and loads the weights again, the old
    ones freed first: the same 4 prompts give the same ids, the engine
    walks back to serving, health is UP, and the card's peak memory across
    the rebuild stays under one more half a model's."""
    app = boot_deployment(None, {"MODEL_PATH": ckpt})
    try:
        port, dev = app.http_port, app.container.tpu
        generations = recorded(dev)
        prompts = [text(700 + i, 100 + 90 * i) for i in range(4)]
        greedy = {"max_tokens": DEPLOY_TOKENS, "temperature": 0}

        def serve_all() -> list:
            for p in prompts:
                status, data, _, _ = post(port, {"prompt": p, **greedy})
                check(status == 200, f"reinit: {status} {data}")
            return [ids_for(dev, generations, p)[-1] for p in prompts]

        loaded: list = []
        runner = threading.Thread(target=lambda: loaded.append(serve_all()))
        runner.start()
        time.sleep(0.5)
        under_load = dev.health_check()
        runner.join(timeout=600)
        check(loaded and under_load["status"] == "UP",
              f"reinit: the probe under load {under_load}")
        before = loaded[0]
        weights = dev.runner.weight_bytes
        dev.runner.model.reinit_marker = True  # gone with the old model
        history0 = len(dev.engine.snapshot()["history"])
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        dev.reinit()
        reinit_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        states = [f"{h['state']} ({h['detail']})" if h.get("detail") else h["state"]
                  for h in dev.engine.snapshot()["history"][history0:]]
        check(not hasattr(dev.runner.model, "reinit_marker"), "reinit: the old model was kept")
        after = serve_all()
        health = dev.health_check()
        out = {"reinit_s": reinit_s, "memory_before_gib": mem0 / 2**30,
               "peak_gib": peak / 2**30, "weights_gib": weights / 2**30, "states": states,
               "probe_ms_under_load": under_load["details"]["probe_ms"],
               "probe_ms": health["details"].get("probe_ms"), "ids_equal": after == before}
        print(f"overload reinit: {json.dumps(out)}", flush=True)
        check(after == before, "reinit: the rebuilt stack gave other ids")
        check(health["status"] == "UP" and dev.engine.state == "serving",
              f"reinit: health {health}, engine {dev.engine.state}")
        check(peak < mem0 + weights / 2,
              f"reinit: peak {peak / 2**30:.2f} GiB across the rebuild from "
              f"{mem0 / 2**30:.2f} GiB: the old weights were not freed first")
    finally:
        app.shutdown()
    return out


def overload_deadlines(flash, app, calls: list) -> dict:
    """(1) A budget with max_tokens 256 expires mid-decode (a 504 error
    frame after the tokens it got, a prefix of the same request's greedy
    ids; its blocks come back); meanwhile, rows decoding, a budget under one
    chunk is refused at admission with no prefill. The budget is 1.5 s, or
    DEADLINE_CHUNKS of the reference request's wall time a chunk where the
    host runs slower than that: the cut must come after the stream's first
    pooled chunk and before the reference's end (on a loaded host the whole
    script's phase 18 ran at ~560 ms a chunk, where 1.5 s holds a single
    chunk)."""
    port, dev = app.http_port, app.container.tpu
    prompt = text(181, 200)
    # the greedy ids the cut one must prefix: the same request's whole answer,
    # more than the budget decodes (a replayed pool chunk decodes ~145 in 1.5 s)
    ref_n = 256
    t_ref = time.perf_counter()
    status, _, _, _ = post(port, {"prompt": prompt, "max_tokens": ref_n, "temperature": 0})
    ref_chunk_s = (time.perf_counter() - t_ref) / -(-ref_n // dev.decode_pool.chunk)
    check(status == 200, f"deadline: the reference {status}")
    reference = calls[-1]["ids"]
    pool_idle(dev.decode_pool, "deadline")
    budget_ms = max(1500, int(DEADLINE_CHUNKS * ref_chunk_s * 1000))
    free = dev.kv_pool.stats()["free"]  # the prompt's prefix-cache entries are in it
    result: list = []
    first_frames = threading.Event()

    def cut_stream():
        result.append(post(port, {"prompt": prompt, "max_tokens": 256, "temperature": 0,
                                  "stream": True}, stream=True,
                           headers={"X-Request-Deadline-Ms": str(budget_ms)}))

    worker = threading.Thread(target=cut_stream)
    start = len(calls)
    worker.start()
    waited = time.perf_counter() + budget_ms / 1000 + 3.5
    while time.perf_counter() < waited:  # the first pooled chunk delivered: a cadence measured
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
          f"deadline: the {budget_ms} ms stream ended {status} {error} done={done}")
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
                    ("decode", budget_ms / 1000.0, "deadline_exceeded")],
          f"deadline: records {sheds}")
    out = {"cut_tokens": len(cut), "budget_ms": budget_ms, "ref_chunk_ms": ref_chunk_s * 1e3,
           "cadence_ms": cadence * 1e3, "refuse_ms": refuse_ms, "blocks_back_ms": back_s * 1e3,
           "stages": stages}
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
        for c in fwd_counters(flash):
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
        d64 = flash.launches_fwd_instance["sm90_d64"].value
        dispatches = dev.batcher.dispatches - dispatches0
        mma = launches - sm90 - decode
        print(f"encoder: forward launches {launches} over {dispatches} dispatches: sm90 {sm90}, "
              f"its D = 64 instance {d64} (n_layers x dispatches = {n_layers * dispatches}), "
              f"mma {mma}, decode {decode}", flush=True)
        check(mma == 0 and decode == 0, "encoder: a call left the sm90 kernel")
        check(sm90 == d64 == n_layers * dispatches,
              "encoder: a layer's attention missed the sm90 kernel's D = 64 instance")
        out.update(launches=d64, dispatches=dispatches, per_dispatch=d64 / dispatches)
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
    """scaled_dot_product_attention's backward at the same shape (GQA,
    causal as ``c`` is), timed as forward + backward minus forward."""
    import torch.nn.functional as F

    from gofr_tpu_torch.timing import event_ms

    qt, kt, vt = (c[n].transpose(1, 2).detach().requires_grad_() for n in ("q", "k", "v"))
    g = c["do"].transpose(1, 2)
    causal = c["causal"]

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
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
    from gofr_tpu_torch.training.data import prefetch_to_device

    cfg, seq, steps = LLAMA3_8B, TRAIN_SEQ, 4
    t0 = time.perf_counter()
    opt = trainer.default_optimizer(3e-4)
    state = trainer.init_train_state(cfg, opt, device="cuda", seed=0)
    n_params = sum(p.numel() for p in state["model"].parameters())
    step_fn = trainer.make_train_step(cfg, opt, remat=True)
    batch = train_batch(cfg, seq, 1)
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
               "peak_memory_gib": peak / 2**30, "losses": losses, "grad_norms": norms,
               "launches": totals}
    print(f"train-metrics [{card}]: {json.dumps(metrics)}", flush=True)
    return metrics


TRAIN_SEQ = 2049  # phase 9's crops: the model sees 2048


def train_batch(cfg, seq: int, batch_size: int):
    """Phase 9's data: crops of ``seq`` tokens from a TokenDataset over a
    seeded uint32 corpus, batch 0."""
    import numpy as np

    from gofr_tpu_torch.training.data import TokenDataset

    corpus = np.random.default_rng(0).integers(0, cfg.vocab_size, 1 << 20, dtype=np.uint32)
    return TokenDataset(corpus, seq_len=seq, batch_size=batch_size, seed=0).batch(0)


# -- phase 22: training over a mesh (two shards on the one card) ---------------------

# (a) step 1 of tp = 2 against phase 9's step 1, relative: the split reorders
# the bf16 sums (each row-parallel product sums two f32 partials and rounds
# once; the norm weights' gradients sum two shards' parts)
MESH_TRAIN_LOSS_RTOL = 1e-2
MESH_TRAIN_NORM_RTOL = 5e-2
# (b)-(d) against the unsharded model on the same card from the same
# weights: the loss, relative; each leaf's max |grad difference| against
# that leaf's max |grad| (the merge of the ring's chunks rounds the output
# once more, in another order)
SP_LOSS_RTOL = 1e-2
SP_GRAD_RTOL = 2e-2
SP_LAYERS = 4  # llama3-8b's widths at this depth
SP_SEQ = 4096  # the ring's and Ulysses' sequence: 2 shards of 2048
# the JAX package's refusals, word for word
ULYSSES_HEADS_MSG = ("n_heads=4 not divisible by sp=8 — Ulysses shards the head axis; use "
                     "ring attention for this shard count")
PIPELINE_MICRO_MSG = "local batch 3 not divisible by n_micro=2"


def train_counters(flash) -> tuple:
    """forward, dQ, dK/dV launches, then each one's sm90 variant alone."""
    return (flash.launches, flash.launches_dq, flash.launches_dkv,
            flash.launches_fwd_sm90, flash.launches_dq_sm90, flash.launches_dkv_sm90)


def counted(torch, flash, fn) -> tuple:
    """``fn()`` with every training counter set to 0 just before it and read
    just after: (its result, the counts, its wall ms to a synchronize)."""
    counters = train_counters(flash)
    for c in counters:
        c.reset()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, [c.value for c in counters], (time.perf_counter() - t) * 1e3


def mesh_train_tp(torch, flash, card: str, phase9: dict, devices: list) -> dict:
    """(a) llama3-8b at full width and depth, tp = 2 over ``devices``: a
    seed-0 state (phase 9's) placed with ``release`` (the unsharded tensors
    freed as their shards land), two steps on phase 9's batch."""
    import numpy as np

    from gofr_tpu_torch.models.llama import LLAMA3_8B
    from gofr_tpu_torch.parallel.mesh import make_mesh
    from gofr_tpu_torch.training import trainer

    cfg, steps = LLAMA3_8B, 2
    opt = trainer.default_optimizer(3e-4)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_train_state(cfg, opt, device="cuda", seed=0)
    torch.cuda.synchronize()
    unsharded = torch.cuda.memory_allocated()
    mesh = make_mesh({"tp": 2}, devices=devices)
    t = time.perf_counter()
    state = trainer.place_train_state(state, mesh, release=True)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t
    placed = torch.cuda.memory_allocated()
    # the placed state holds what the unsharded one held, plus the norm
    # weights' copies on the second shard (and their moments)
    check(placed <= unsharded + 2**20 * 64, f"tp train: {placed / 2**30:.2f} GiB placed against "
          f"{unsharded / 2**30:.2f} GiB unsharded: an unsharded tensor stayed")
    step_fn = trainer.make_train_step(cfg, opt, mesh=mesh, remat=True)
    batch = train_batch(cfg, TRAIN_SEQ, 1)
    want = [2 * 2 * cfg.n_layers, 2 * cfg.n_layers, 2 * cfg.n_layers]  # tp x phase 9's
    rows = []
    for i in range(steps):
        (state, m), counts, ms = counted(torch, flash, lambda: step_fn(state, batch))
        rows.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "ms": ms,
                     "launches": counts})
        print(f"tp-train step {i + 1}: loss {rows[-1]['loss']:.4f} grad_norm "
              f"{rows[-1]['grad_norm']:.4f} {ms:.1f} ms, launches fwd/dq/dkv/fwd sm90/dq sm90/"
              f"dkv sm90 {counts}", flush=True)
        check(counts == want + want, f"tp train: launches {counts}, want {want + want} "
              "(tp x phase 9's, every call on sm90)")
        check(state["step"] == i + 1, "tp train: the step count")
    peak = torch.cuda.max_memory_allocated()
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    loss_gap = abs(rows[0]["loss"] - phase9["losses"][0]) / abs(phase9["losses"][0])
    norm_gap = abs(rows[0]["grad_norm"] - phase9["grad_norms"][0]) / abs(phase9["grad_norms"][0])
    print(f"tp-train step 1 against phase 9's: loss {rows[0]['loss']:.6f} / "
          f"{phase9['losses'][0]:.6f} (gap {loss_gap:.3e}, tol {MESH_TRAIN_LOSS_RTOL}), "
          f"grad_norm {rows[0]['grad_norm']:.6f} / {phase9['grad_norms'][0]:.6f} (gap "
          f"{norm_gap:.3e}, tol {MESH_TRAIN_NORM_RTOL}); peak {peak / 2**30:.2f} GiB, placed "
          f"in {place_s:.2f} s", flush=True)
    check(all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in rows),
          "tp train: a non-finite loss or norm")
    check(loss_gap <= MESH_TRAIN_LOSS_RTOL, "tp train: step 1's loss parts from phase 9's")
    check(norm_gap <= MESH_TRAIN_NORM_RTOL, "tp train: step 1's grad_norm parts from phase 9's")
    return {"steps": rows, "loss_gap": loss_gap, "norm_gap": norm_gap, "place_s": place_s,
            "unsharded_gib": unsharded / 2**30, "placed_gib": placed / 2**30,
            "peak_memory_gib": peak / 2**30, "phase9_step_ms": phase9["step_ms"],
            "launches": [sum(r["launches"][j] for r in rows) for j in range(6)]}


def loss_and_grads(torch, flash, fn, params: list) -> dict:
    """``fn()``'s loss and its gradients for ``params``, twice; the second
    pass's counts and wall ms (the first warms the allocator)."""
    def run():
        loss = fn()
        return loss.detach(), torch.autograd.grad(loss, params)

    run()
    (loss, grads), counts, ms = counted(torch, flash, run)
    return {"loss": float(loss), "grads": grads, "launches": counts, "ms": ms}


def grad_gaps(names: list, got, want) -> dict:
    """Each leaf's max |difference| over its max |reference|."""
    return {n: float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30))
            for n, g, w in zip(names, got, want)}


def mesh_train_sp_pp(torch, flash, devices: list) -> dict:
    """(b) ring attention and (c) Ulysses at sp = 2, (d) the GPipe pipeline
    at pp = 2, on llama3-8b's widths at SP_LAYERS layers, each a loss and
    its gradients against the unsharded model's on the same card from the
    same weights. Beside each gap, the gap of the leg and of the unsharded
    bf16 model to an f32 copy of the same weights (the bf16 noise floor)."""
    import dataclasses

    from gofr_tpu_torch.models.llama import LLAMA3_8B
    from gofr_tpu_torch.models.transformer import Transformer
    from gofr_tpu_torch.parallel import (
        make_mesh,
        make_pipeline_loss,
        make_ring_loss,
        make_ulysses_loss,
        place_pipeline_params,
    )
    from gofr_tpu_torch.training.trainer import cross_entropy_loss

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=SP_LAYERS)
    layers = cfg.n_layers
    model = Transformer.random(cfg, devices[0], seed=0)
    truth_model = model.dequantized(torch.float32)
    names = [n for n, _ in model.named_parameters()]
    for m in (model, truth_model):
        for p in m.parameters():
            p.requires_grad_(True)
    params, truth_params = list(model.parameters()), list(truth_model.parameters())
    sp_mesh, pp_mesh = make_mesh({"sp": 2}, devices=devices), make_mesh({"pp": 2}, devices=devices)
    staged = place_pipeline_params(model, pp_mesh)
    tokens = torch.as_tensor(train_batch(cfg, SP_SEQ, 1), device=devices[0])
    batch = torch.as_tensor(train_batch(cfg, TRAIN_SEQ, 2), device=devices[0])
    legs = {
        # the ring: sp(sp+1)/2 = 3 pairs a layer a pass (the diagonal causal,
        # one non-causal), remat's recompute doubling the forward's
        "ring": (lambda: make_ring_loss(cfg, sp_mesh, remat=True)(model, tokens), params,
                 tokens, [2 * 3 * layers, 3 * layers, 3 * layers]),
        # Ulysses: one full-sequence call a head group (sp) a layer
        "ulysses": (lambda: make_ulysses_loss(cfg, sp_mesh)(model, tokens), params, tokens,
                    [2 * layers, 2 * layers, 2 * layers]),
        # two microbatches of one 2049-token crop through two stages:
        # n_micro x n_layers a pass, no drain replays
        "pipeline": (lambda: make_pipeline_loss(cfg, pp_mesh, n_micro=2)(staged, batch),
                     list(staged.parameters()), batch, [2 * layers, 2 * layers, 2 * layers]),
    }
    out, refs = {}, {}
    for name, (fn, leg_params, toks, want) in legs.items():
        key = tuple(toks.shape)
        if key not in refs:  # the unsharded bf16 model, and its f32 copy
            plain = loss_and_grads(torch, flash, lambda: cross_entropy_loss(model, toks), params)
            truth = loss_and_grads(torch, flash, lambda: cross_entropy_loss(truth_model, toks),
                                   truth_params)
            plain["truth_gaps"] = grad_gaps(names, plain["grads"], truth["grads"])
            refs[key] = (plain, truth)
        plain, truth = refs[key]
        leg = loss_and_grads(torch, flash, fn, leg_params)
        grads = leg.pop("grads")
        leg.update(want=want + want, loss_gap=abs(leg["loss"] - plain["loss"]) / abs(plain["loss"]),
                   grad_gaps=grad_gaps(names, grads, plain["grads"]),
                   truth_gaps=grad_gaps(names, grads, truth["grads"]))
        del grads
        out[name] = leg
    for key, (plain, truth) in refs.items():
        worst = max(plain["truth_gaps"], key=plain["truth_gaps"].get)
        print(f"sp/pp unsharded {key}: loss {plain['loss']:.6f} (f32 copy {truth['loss']:.6f}), "
              f"{plain['ms']:.1f} ms a loss and its grads, its worst grad gap to the f32 copy "
              f"{plain['truth_gaps'][worst]:.3e} at {worst}", flush=True)
    out["plain"] = {str(k): {"loss": p["loss"], "ms": p["ms"], "f32_loss": t["loss"],
                             "truth_gap": max(p["truth_gaps"].values())}
                    for k, (p, t) in refs.items()}
    out["ulysses_vs_ring"] = abs(out["ulysses"]["loss"] - out["ring"]["loss"]) / abs(
        out["ring"]["loss"])
    del refs, truth_model, staged
    for name in ("ring", "ulysses", "pipeline"):
        leg = out[name]
        worst = max(leg["grad_gaps"], key=leg["grad_gaps"].get)
        print(f"sp/pp {name}: loss {leg['loss']:.6f} (gap {leg['loss_gap']:.3e}, tol "
              f"{SP_LOSS_RTOL}), worst grad gap {leg['grad_gaps'][worst]:.3e} at {worst} (tol "
              f"{SP_GRAD_RTOL}; to the f32 copy {max(leg['truth_gaps'].values()):.3e}), "
              f"{leg['ms']:.1f} ms a loss and its grads, launches {leg['launches']}", flush=True)
    print(f"sp/pp ulysses against ring: {out['ulysses_vs_ring']:.3e}", flush=True)
    for name in ("ring", "ulysses", "pipeline"):
        leg = out[name]
        check(leg["launches"] == leg["want"],
              f"{name}: launches {leg['launches']}, want {leg['want']} (all sm90)")
        check(leg["loss_gap"] <= SP_LOSS_RTOL, f"{name}: the loss parts from the unsharded one")
        check(max(leg["grad_gaps"].values()) <= SP_GRAD_RTOL, f"{name}: a gradient parts")
    check(out["ulysses_vs_ring"] <= SP_LOSS_RTOL, "ulysses: the loss parts from the ring's")
    return out


def mesh_train_refusals(torch, devices: list) -> dict:
    """(f) the JAX package's refusals: Ulysses at sp = 8 over the tiny
    model's 4 heads, and a pipeline over a batch its microbatches do not
    divide."""
    from gofr_tpu_torch.models.llama import TINY
    from gofr_tpu_torch.models.transformer import Transformer
    from gofr_tpu_torch.parallel import make_mesh, make_pipeline_loss, make_ulysses_forward

    tiny = Transformer.random(TINY, devices[0], seed=0)
    out = {}
    for name, fn, want in (
        ("ulysses", lambda: make_ulysses_forward(TINY, make_mesh({"sp": 8}, [devices[0]] * 8),
                                                 batch_axes=())(tiny, [[1] * 64] * 2),
         ULYSSES_HEADS_MSG),
        ("pipeline", lambda: make_pipeline_loss(TINY, make_mesh({"pp": 2}, devices), n_micro=2)(
            tiny, [[1] * 17] * 3), PIPELINE_MICRO_MSG),
    ):
        try:
            with torch.no_grad():
                fn()
            got = None
        except ValueError as exc:
            got = str(exc)
        print(f"refusal {name}: {got!r}", flush=True)
        check(got == want, f"{name}: refused with {got!r}, not the JAX package's {want!r}")
        out[name] = got
    return out


def bwd_device_rows(torch, flash, c, iters: int = 20) -> dict:
    """The dQ and dK/dV kernels on ``c``: device time (a CUDA graph of
    launches), the CUDA-event time, the bound, the whole plain backward and
    SDPA's backward at the same masking."""
    from gofr_tpu_torch.timing import event_ms, graph_ms

    scale = c["q"].shape[-1] ** -0.5
    do = c["do"].contiguous()
    dvec = (do.float() * c["out"].float()).sum(-1).transpose(1, 2).contiguous()
    kargs = (c["q"], c["k"], c["v"], do, c["lse"], dvec, c["offs"], c["lens"], c["causal"], scale)
    plain_ms = event_ms(lambda: flash.flash_attention_bwd_ref(
        c["q"], c["k"], c["v"], c["offs"], c["lens"], c["out"], c["lse"], c["do"], c["causal"],
        scale), 3)
    library_ms = sdpa_backward_ms(torch, c, iters)
    rows = {}
    for name, fn in (("dq", lambda: flash.launch_dq(*kargs)),
                     ("dkv", lambda: flash.launch_dkv(*kargs))):
        bound_ms, bound_by = bwd_bound(c, name)
        rows[name] = {"variant": (flash.dq_variant if name == "dq" else flash.dkv_variant)(c["q"]),
                      "ms": graph_ms(fn), "event_ms": event_ms(fn, iters), "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    return rows


def mesh_train_kernels(torch, flash, gen) -> dict:
    """(e) the kernels at phase 22's new shapes, each against its plain
    version (bf16 2e-2), with device time, bound, plain and SDPA: the tp
    shard's training call (B=1 S=2048 Hq=16 Hkv=4 causal: forward, dQ,
    dK/dV), the ring's off-diagonal pair (B=1 Sq=Skv=2048 Hq=32 Hkv=8,
    non-causal, the backward with the GLOBAL out and LSE of a query chunk
    over two K/V chunks), Ulysses' head group (B=1 S=4096 Hq=16 Hkv=4 causal:
    forward, dQ, dK/dV). -> {row name: {"fwd", "dq", "dkv"} rows}."""
    from gofr_tpu_torch.parallel.ring import merge_chunks

    bf16 = torch.bfloat16
    out = {}
    for name, (b, s, hq, hkv) in (("tp shard", (1, 2048, 16, 4)),
                                  ("ulysses", (1, SP_SEQ, 16, 4))):
        c = bwd_case(torch, flash, gen, b, s, s, hq, hkv, 128, bf16, [0], [s], poison=False)
        case = (c["q"], c["k"], c["v"], c["offs"], c["lens"])
        _, _, e_fwd = compare(torch, flash, f"{name} training forward", case)
        e_dq, e_dkv, _, variant = compare_bwd(torch, flash, f"{name} training backward", c)
        check(variant == "sm90", f"{name}: the backward took {variant}")
        row = device_row(time_shape(torch, flash, f"{name} training forward", case, 20,
                                    is_causal=True, device=True))
        out[name] = {"fwd": {**row, "max_abs_err": e_fwd}, **bwd_device_rows(torch, flash, c)}
        out[name]["dq"]["max_abs_err"], out[name]["dkv"]["max_abs_err"] = e_dq, e_dkv
    # the ring's off-diagonal pair: query chunk 1 against K/V chunk 0 (every
    # key visible), its backward at the global softmax of chunks 0 and 1
    c = bwd_case(torch, flash, gen, 1, 2048, 2048, 32, 8, 128, bf16, [0], [2048], causal=False,
                 poison=False)
    case = (c["q"], c["k"], c["v"], c["offs"], c["lens"])
    _, _, e_fwd = compare(torch, flash, "ring off-diagonal forward", case, causal=False)
    k_own = torch.randn(c["k"].shape, device="cuda", generator=gen).to(bf16)
    v_own = torch.randn(c["v"].shape, device="cuda", generator=gen).to(bf16)
    c["out"], c["lse"] = merge_chunks(
        [flash.flash_attention_fwd(c["q"], c["k"], c["v"], causal=False),
         flash.flash_attention_fwd(c["q"], k_own, v_own, causal=True)])
    e_dq, e_dkv, _, variant = compare_bwd(torch, flash, "ring off-diagonal backward, global LSE", c)
    check(variant == "sm90", f"ring: the backward took {variant}")
    row = device_row(time_shape(torch, flash, "ring off-diagonal forward", case, 20, device=True,
                                causal=False))
    out["ring"] = {"fwd": {**row, "max_abs_err": e_fwd}, **bwd_device_rows(torch, flash, c)}
    out["ring"]["dq"]["max_abs_err"], out["ring"]["dkv"]["max_abs_err"] = e_dq, e_dkv
    for name, rows in out.items():
        print(f"mesh-train-kernels {name}: {json.dumps(rows)}", flush=True)
    return out


def mesh_training(torch, flash, card: str, phase9: dict, gen, devices: list = None) -> dict:
    """Phase 22: training over a mesh, its legs over ``devices`` (two
    shards on the one card by default): (a) tp = 2 llama3-8b, (b)-(d) ring,
    Ulysses and the pipeline, (f) the refusals; then (e) the kernels at the
    legs' shapes. Prints one ``mesh-train`` line."""
    t0 = time.perf_counter()
    devices = devices or [torch.device("cuda", 0)] * 2
    line = {"devices": [str(d) for d in devices],
            "tp": mesh_train_tp(torch, flash, card, phase9, devices)}
    line.update(mesh_train_sp_pp(torch, flash, devices))
    gc.collect()
    torch.cuda.empty_cache()
    line["refusals"] = mesh_train_refusals(torch, devices)
    line["kernel_rows"] = mesh_train_kernels(torch, flash, gen)
    gc.collect()
    torch.cuda.empty_cache()
    line["phase_s"] = time.perf_counter() - t0
    print(f"mesh-train [{card}]: {json.dumps(line)}", flush=True)
    return line


# -- phase 23: MoE over the ep axis and the multihost runtime -----------------------

# MoEConfig()'s own widths (Mixtral-8x7B's published ones: dim 4096, 32 heads,
# 8 KV heads, hidden 14336, vocab 32000, 8 experts, top-2) at this depth: all
# 32 layers take 32 x 2.90 GB + 0.52 GB = 93.4 GB of bf16 weights, more than
# the card holds; 4 take 12.1 GB
MOE_LAYERS = 4
MOE_SEQ = 2049  # phase 9's crops: the model sees 2048
# the ep = 2 path against the dense one: the logits' max |difference| over
# their max |value| (bf16, 2e-2); the loss, relative; each gradient leaf's max
# |difference| over its max |value| (phase 22's measure and bound)
MOE_LOGIT_GAP = 2e-2
MOE_LOSS_RTOL = 1e-3
MOE_GRAD_GAP = 2e-2
MOE_GRAD_KEYS = ("w_gate", "w_down", "router", "wq")


def moe_grad_gaps(got: dict, want: dict) -> dict:
    """Each MOE_GRAD_KEYS weight's worst layer: max |got - want| over max
    |want|. ``got`` a gradient a layer, or the ep placement's blocks a
    layer (a list over the shards: an expert stack's E/ep slices, a
    replicated weight's copies, their gradients summed); ``want`` dense
    gradients."""
    gaps = {}
    for key in MOE_GRAD_KEYS:
        worst = 0.0
        for li, ref in enumerate(want[key]):
            blocks = got[key][li]
            if isinstance(blocks, list):
                if key in ("w_gate", "w_up", "w_down"):
                    per = ref.shape[0] // len(blocks)
                    diff = max(float((b.grad.float() - ref[j * per:(j + 1) * per].float())
                                     .abs().max()) for j, b in enumerate(blocks))
                else:
                    total = sum(b.grad.float() for b in blocks)
                    diff = float((total - ref.float()).abs().max())
            else:
                diff = float((blocks.float() - ref.float()).abs().max())
            worst = max(worst, diff / max(float(ref.float().abs().max()), 1e-30))
        gaps[key] = worst
    return gaps


def moe_ep(torch, flash) -> dict:
    """Phase 23 (a)-(e): MoEConfig() at MOE_LAYERS layers, seed 0, B = 2
    crops of MOE_SEQ. (a) the dense forward; then an f32 copy's loss and
    gradients (aux_weight 0, remat; the bf16 floor's reference, its f32
    attention uncounted), (c) the dense bf16 loss and gradients, then ep = 2
    over two shards of the one card: (b) the ep forward at capacity factor 4
    (no drops), (d) at 0.25 (drops counted), (c) the ep loss and gradients
    (remat); (e) the int8 model."""
    import dataclasses

    from gofr_tpu_torch.models import moe
    from gofr_tpu_torch.models.quant import Pack, quantize_params
    from gofr_tpu_torch.parallel import expert
    from gofr_tpu_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(moe.MoEConfig(), n_layers=MOE_LAYERS)
    check(cfg.dim == 4096 and cfg.n_heads == 32 and cfg.n_kv_heads == 8 and
          cfg.hidden_dim == 14336 and cfg.vocab_size == 32000 and cfg.n_experts == 8 and
          cfg.top_k == 2 and cfg.dtype == torch.bfloat16, f"moe: MoEConfig() is {cfg}")
    ample = dataclasses.replace(cfg, capacity_factor=4.0)  # C = T_local: nothing drops
    no_aux = dataclasses.replace(ample, aux_weight=0.0)
    tight = dataclasses.replace(cfg, capacity_factor=0.25)
    out: dict = {"layers": MOE_LAYERS, "batch": [2, MOE_SEQ - 1]}
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = moe.MoETransformer.random(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    out["weight_gb"] = model.weight_bytes() / 1e9
    tokens = torch.as_tensor(train_batch(cfg, MOE_SEQ, 2), device="cuda")
    inputs = tokens[:, :-1]
    # (a) the dense forward, twice (the first warms the allocator)
    with torch.no_grad():
        moe.moe_forward(model, inputs)
        (logits, aux), counts, ms = counted(torch, flash, lambda: moe.moe_forward(model, inputs))
    out["dense_forward"] = {"ms": ms, "launches": counts,
                            "load_balance": float(aux["load_balance"]),
                            "router_z": float(aux["router_z"])}
    print(f"moe (a) dense forward B=2 S={MOE_SEQ - 1}: {ms:.1f} ms, launches fwd/dq/dkv/fwd "
          f"sm90/dq sm90/dkv sm90 {counts}, load_balance {out['dense_forward']['load_balance']:.4f}"
          f", router_z {out['dense_forward']['router_z']:.2f}", flush=True)
    check(bool(torch.isfinite(logits).all()), "moe (a): non-finite logits")
    check(tuple(logits.shape) == (2, MOE_SEQ - 1, cfg.vocab_size), "moe (a): logits shape")
    check(out["dense_forward"]["load_balance"] >= 0.99, "moe (a): load_balance under 0.99")
    check(counts == [MOE_LAYERS, 0, 0, MOE_LAYERS, 0, 0],
          f"moe (a): launches {counts}, want {MOE_LAYERS} sm90 forwards and nothing else")
    # the f32 copy's gradients: the reference each bf16 leg's gap is read beside
    truth_model = model.dequantized(torch.float32)
    truth_params = [getattr(layer, k) for layer in truth_model.layers for k in MOE_GRAD_KEYS]
    for p in truth_params:
        p.requires_grad_(True)
    t = time.perf_counter()
    truth_loss = moe.moe_loss(truth_model, tokens, no_aux, remat=True)
    grads = torch.autograd.grad(truth_loss, truth_params)
    torch.cuda.synchronize()
    out["f32_ms"] = (time.perf_counter() - t) * 1e3
    n_k = len(MOE_GRAD_KEYS)
    truth = {k: [grads[li * n_k + j] for li in range(MOE_LAYERS)]
             for j, k in enumerate(MOE_GRAD_KEYS)}
    del truth_model, truth_params, grads
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the dense bf16 loss and gradients
    dense_params = [getattr(layer, k) for layer in model.layers for k in MOE_GRAD_KEYS]
    for p in dense_params:
        p.requires_grad_(True)
    dense = loss_and_grads(torch, flash, lambda: moe.moe_loss(model, tokens, no_aux),
                           dense_params)
    dense_grads = {k: [dense["grads"][li * n_k + j] for li in range(MOE_LAYERS)]
                   for j, k in enumerate(MOE_GRAD_KEYS)}
    del dense["grads"]
    for p in dense_params:
        p.requires_grad_(False)
    dense["truth_gaps"] = moe_grad_gaps(dense_grads, truth)
    # (b) and (d): ep = 2 over two shards of the one card
    mesh = make_mesh({"ep": 2}, devices=[torch.device("cuda", 0)] * 2)
    t = time.perf_counter()
    placed = expert.place_moe_params(model, mesh)
    torch.cuda.synchronize()
    out["place_s"] = time.perf_counter() - t
    ep_fwd = expert.make_moe_forward(ample, mesh)
    with torch.no_grad():
        ep_fwd(placed, inputs)
        (ep_logits, ep_aux), counts, ms = counted(torch, flash, lambda: ep_fwd(placed, inputs))
    gap = float((ep_logits - logits).abs().max() / logits.abs().max())
    out["ep_forward"] = {"ms": ms, "launches": counts, "logit_gap": gap,
                         "load_balance": float(ep_aux["load_balance"])}
    print(f"moe (b) ep=2 forward (2 shards of B=1 S={MOE_SEQ - 1}, capacity factor 4): "
          f"{ms:.1f} ms, launches {counts}, logits max |diff| / max |logit| against (a) "
          f"{gap:.3e} (tol {MOE_LOGIT_GAP}), dense argmax equal "
          f"{float((ep_logits.argmax(-1) == logits.argmax(-1)).float().mean()):.4f}", flush=True)
    check(bool(torch.isfinite(ep_logits).all()), "moe (b): non-finite logits")
    check(counts == [2 * MOE_LAYERS, 0, 0, 2 * MOE_LAYERS, 0, 0],
          f"moe (b): launches {counts}, want one sm90 forward a shard a layer")
    check(gap <= MOE_LOGIT_GAP, "moe (b): the ep logits part from the dense ones")
    del ep_logits, logits
    stats: dict = {}
    with torch.no_grad():
        (tight_logits, _), counts, ms = counted(torch, flash, lambda: expert.make_moe_forward(
            tight, mesh, stats=stats)(placed, inputs))
    out["overflow"] = {"ms": ms, "launches": counts, **stats,
                       "capacity": expert._capacity(MOE_SEQ - 1, tight)}
    print(f"moe (d) capacity factor 0.25 (C = {out['overflow']['capacity']} a shard): "
          f"{stats['dropped']} of {stats['assignments']} expert assignments dropped, their "
          f"tokens on the residual stream; logits finite "
          f"{bool(torch.isfinite(tight_logits).all())}; {ms:.1f} ms", flush=True)
    check(bool(torch.isfinite(tight_logits).all()), "moe (d): non-finite logits")
    check(stats["dropped"] > 0, "moe (d): nothing dropped at capacity factor 0.25")
    check(counts[3] == 2 * MOE_LAYERS and counts[0] == counts[3], f"moe (d): launches {counts}")
    del tight_logits
    # (c) the ep loss and gradients (remat: the forward's launches doubled)
    ep_params = [b for li in range(MOE_LAYERS) for k in MOE_GRAD_KEYS
                 for b in placed.blocks(k, li)]
    for p in ep_params:
        p.requires_grad_(True)
    ep_loss = expert.make_moe_loss(no_aux, mesh, remat=True)
    ep = loss_and_grads(torch, flash, lambda: ep_loss(placed, tokens), ep_params)
    for p, g in zip(ep_params, ep.pop("grads")):
        p.grad = g
    ep_blocks = {k: [placed.blocks(k, li) for li in range(MOE_LAYERS)] for k in MOE_GRAD_KEYS}
    ep["gaps"] = moe_grad_gaps(ep_blocks, dense_grads)
    ep["truth_gaps"] = moe_grad_gaps(ep_blocks, truth)
    ep["loss_gap"] = abs(ep["loss"] - dense["loss"]) / abs(dense["loss"])
    out["loss"] = {"dense": {k: v for k, v in dense.items()}, "ep": ep,
                   "f32": float(truth_loss)}
    print(f"moe (c) loss aux_weight 0: dense {dense['loss']:.6f} ({dense['ms']:.1f} ms a loss and "
          f"its gradients, launches {dense['launches']}), ep=2 {ep['loss']:.6f} ({ep['ms']:.1f} ms, "
          f"launches {ep['launches']}), f32 copy {float(truth_loss):.6f}; loss gap "
          f"{ep['loss_gap']:.3e} (tol {MOE_LOSS_RTOL}); worst gradient gaps ep to dense "
          f"{json.dumps(ep['gaps'])} (tol {MOE_GRAD_GAP}); to the f32 copy: ep "
          f"{json.dumps(ep['truth_gaps'])}, dense {json.dumps(dense['truth_gaps'])}", flush=True)
    check(dense["launches"] == [MOE_LAYERS] * 6,
          f"moe (c): the dense loss and gradients launched {dense['launches']}")
    check(ep["launches"] == [4 * MOE_LAYERS, 2 * MOE_LAYERS, 2 * MOE_LAYERS] * 2,
          f"moe (c): the ep loss and gradients launched {ep['launches']}")
    check(ep["loss_gap"] <= MOE_LOSS_RTOL, "moe (c): the ep loss parts from the dense one")
    check(max(ep["gaps"].values()) <= MOE_GRAD_GAP, "moe (c): an ep gradient parts")
    del placed, ep_params, ep_blocks, dense_grads, truth, dense_params
    gc.collect()
    torch.cuda.empty_cache()
    # (e) int8: attention and lm_head packed, the experts dense
    q = quantize_params(model, "int8")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    experts_dense = all(isinstance(getattr(layer, k), torch.nn.Parameter)
                        for layer in q.layers for k in moe.EXPERT_KEYS)
    attn_packed = all(isinstance(getattr(layer, k), Pack)
                      for layer in q.layers for k in ("wq", "wk", "wv", "wo"))
    with torch.no_grad():
        (q_logits, _), counts, ms = counted(torch, flash, lambda: moe.moe_forward(q, inputs))
    out["int8"] = {"weight_gb": q.weight_bytes() / 1e9, "ms": ms, "launches": counts,
                   "finite": bool(torch.isfinite(q_logits).all())}
    print(f"moe (e) int8: experts dense {experts_dense}, attention packed {attn_packed}, lm_head "
          f"packed {isinstance(q.lm_head, Pack)}; weight bytes {out['int8']['weight_gb']:.3f} GB "
          f"(bf16 {out['weight_gb']:.3f} GB); forward {ms:.1f} ms, launches {counts}, finite "
          f"{out['int8']['finite']}", flush=True)
    check(experts_dense and attn_packed and isinstance(q.lm_head, Pack),
          "moe (e): int8 must pack attention and lm_head and keep the experts dense")
    check(out["int8"]["finite"], "moe (e): non-finite int8 logits")
    check(counts == [MOE_LAYERS, 0, 0, MOE_LAYERS, 0, 0], f"moe (e): launches {counts}")
    del q, q_logits
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # each kernel's launches at the ep shards' shape (B=1 S=2048, phase 9's)
    # and at the dense model's (B=2 S=2048)
    out["launches"] = {
        "shard": [out["ep_forward"]["launches"][3] + out["overflow"]["launches"][3]
                  + ep["launches"][3], ep["launches"][4], ep["launches"][5]],
        "dense": [out["dense_forward"]["launches"][3] + dense["launches"][3]
                  + out["int8"]["launches"][3], dense["launches"][4], dense["launches"][5]]}
    return out


def moe_kernels(torch, flash, gen) -> dict:
    """The forward, dQ and dK/dV at the dense MoE model's attention (B=2
    S=2048 Hq=32 Hkv=8 D=128 bf16 causal) against their plain versions,
    with device time, bound, plain and SDPA (is_causal)."""
    c = bwd_case(torch, flash, gen, 2, 2048, 2048, 32, 8, 128, torch.bfloat16, [0, 0],
                 [2048, 2048], poison=False)
    case = (c["q"], c["k"], c["v"], c["offs"], c["lens"])
    _, _, e_fwd = compare(torch, flash, "MoE B=2 S=2048 forward", case)
    e_dq, e_dkv, _, variant = compare_bwd(torch, flash, "MoE B=2 S=2048 backward", c)
    check(variant == "sm90", f"moe: the backward at B=2 S=2048 took {variant}")
    row = device_row(time_shape(torch, flash, "MoE B=2 S=2048 forward", case, 20,
                                is_causal=True, device=True))
    rows = {"fwd": {**row, "max_abs_err": e_fwd}, **bwd_device_rows(torch, flash, c)}
    rows["dq"]["max_abs_err"], rows["dkv"]["max_abs_err"] = e_dq, e_dkv
    print(f"moe-kernels B=2 S=2048: {json.dumps(rows)}", flush=True)
    return rows


def moe_multihost(torch, flash, card: str) -> dict:
    """Phase 23 (f): ``new()`` of the tiny model on the card with
    TPU_COORDINATOR (a free local port), TPU_NUM_PROCESSES=1 and
    TPU_PROCESS_ID=0: the boot joins an NCCL-backed process group, one
    request is served, a CUDA tensor's all-reduce at world size 1 returns
    its value, and the shutdown leaves the group. Two ranks cannot share
    the one card (NCCL refuses two ranks on one device): the CPU tests run
    two ranks over gloo."""
    import torch.distributed as dist

    import gofr_tpu_torch
    from gofr_tpu_torch.parallel import multihost

    env = {"MODEL_NAME": "tiny", "TOKENIZER": "byte", "TORCH_DEVICE": "cuda",
           "LOG_LEVEL": "ERROR", "HTTP_PORT": str(free_port()), "TIMEBASE_ENABLED": "off",
           "TPU_COORDINATOR": f"127.0.0.1:{free_port()}", "TPU_NUM_PROCESSES": "1",
           "TPU_PROCESS_ID": "0"}
    out: dict = {}
    t = time.perf_counter()
    with environment(env):
        app = gofr_tpu_torch.new()
    try:
        out["boot_s"] = time.perf_counter() - t
        gofr_tpu_torch.register_openai_routes(app)
        app.start()
        dev = app.container.tpu
        stages = [s["stage"] for s in dev.boot_timeline]
        out["backend"] = str(dist.get_backend())
        out["process_info"] = multihost.process_info()
        out["psum"] = multihost.global_psum_check()
        x = torch.full((4,), 3.0, device="cuda")
        dist.all_reduce(x)
        out["all_reduce"] = x.tolist()
        before = flash.launches.value
        status, data, _, _ = post(app.http_port, {"prompt": "multihost", "max_tokens": 8,
                                                  "temperature": 0})
        out["request_launches"] = flash.launches.value - before
        out["status"] = status
        print(f"moe (f) multihost: booted in {out['boot_s']:.1f}s through "
              f"{[s for s in stages if 'multi-host' in s]}, backend {out['backend']}, "
              f"process_info {out['process_info']}, global_psum_check {out['psum']}, CUDA "
              f"all_reduce of 3.0 at world size 1 -> {out['all_reduce'][0]}; /v1/completions "
              f"{status}", flush=True)
        check("joining multi-host runtime" in stages, f"multihost: no join in {stages}")
        check(dist.is_initialized() and dist.get_world_size() == 1, "multihost: not joined")
        check("nccl" in out["backend"], f"multihost: backend {out['backend']}, not NCCL")
        check(out["process_info"] == {"process_id": 0, "process_count": 1, "local_devices": 1,
                                      "global_devices": 1},
              f"multihost: process_info {out['process_info']}")
        check(out["psum"] is None, "multihost: global_psum_check at one process")
        check(out["all_reduce"] == [3.0] * 4, "multihost: the all-reduce changed its value")
        check(status == 200 and data["usage"]["completion_tokens"] >= 1,
              f"multihost: {status} {data}")
    finally:
        app.shutdown()
    out["left"] = not dist.is_initialized()
    print(f"moe (f) multihost: after shutdown the process group is destroyed: {out['left']}",
          flush=True)
    check(out["left"], "multihost: the process group outlived the app")
    return out


def moe_multihost_phase(torch, flash, card: str, gen) -> dict:
    """Phase 23: MoE over the ep axis (a)-(e), its kernels at the dense
    model's shape, and the multihost runtime (f). Prints one ``moe``
    line."""
    t0 = time.perf_counter()
    line = {"card": card, **moe_ep(torch, flash)}
    gc.collect()
    torch.cuda.empty_cache()
    line["kernel_rows"] = moe_kernels(torch, flash, gen)
    line["multihost"] = moe_multihost(torch, flash, card)
    line["phase_s"] = time.perf_counter() - t0
    print(f"moe [{card}]: {json.dumps(line)}", flush=True)
    return line


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
        # a bf16 tail past two row tiles and under 64 rows: the mma kernel's route
        "short tail bf16 Sq=63 groups 4": make_case(torch, gen, 2, 63, 256, 32, 8, 128, bf16,
                                                    [0, 100], [63, 163]),
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


# -- phase 19: the fleet ------------------------------------------------------------------

# phase 19's replica settings on top of phase 10's: the router's X-KV-Donor
# hint trusted, the paged arena bounded to 2 GiB (two replicas share the
# card), a pull budget of 10 s, the journal, and phase 18's watchdog (a
# 3 x 1 s wedge) with recovery of 2 attempts (a sticky fault's rebuilds
# fail fast into a restart verdict)
FLEET_REPLICA_ENV = {
    "KV_TRANSFER_TRUST_HINT": "on", "KV_HBM_BUDGET_MB": "2048", "KV_TRANSFER_TIMEOUT_S": "10",
    "JOURNAL": "on", "RECOVERY_ENABLED": "on", "RECOVERY_MAX_ATTEMPTS": "2",
    "RECOVERY_BACKOFF_S": "0.2", "WATCHDOG_DISPATCH_TIMEOUT_S": "1.0",
    "TIMEBASE_ENABLED": "off", "LOG_LEVEL": "ERROR",
}
# the router before them: probes every 0.2 s, streams resumed on failover
FLEET_ROUTER_ENV = {
    "FLEET_RESUME": "on", "FLEET_PROBE_INTERVAL_S": "0.2", "FLEET_PROBE_TIMEOUT_S": "2",
    "FLEET_READ_TIMEOUT_S": "120", "FLEET_DEADLINE_S": "300", "FLEET_CONNECT_TIMEOUT_S": "2",
    "LOG_LEVEL": "FATAL", "TIMEBASE_ENABLED": "off",
}
# ids against ids of another process under the near-tie rule, from the
# replica's own top-2 logprobs there (a logit gap): one bf16 spacing at
# |logit| 16, where llama3-8b's top logits sit
FLEET_NEAR_TIE = 0.125
# the sticky fault's site hook: a child whose trigger file appears sleeps the
# card FAULT_SLEEP_S (a pool chunk or prefill behind it wedges the watchdog)
# and then writes out of bounds: a device-side assert, sticky for the context
FAULT_HOOK = '''import os, threading, time

_trigger = os.environ.get("CHIP_SMOKE_FAULT_FILE")


def _fault():
    while not os.path.exists(_trigger):
        time.sleep(0.05)
    import torch

    torch.cuda._sleep(int(os.environ["CHIP_SMOKE_FAULT_CYCLES"]))
    x = torch.zeros(4, device="cuda")
    x[torch.tensor([1 << 20], device="cuda")] = 1.0


if _trigger:
    threading.Thread(target=_fault, name="chip-smoke-fault", daemon=True).start()
'''
FAULT_SLEEP_S = 5.0
# phases 19 and 20 serve llama3-8b's widths at a cut depth: the replica and
# example processes, the CLI fine-tune and its merged checkpoint hold its
# first CUT_LAYERS layers under the name CUT_MODEL, registered in the script
# (``cut_depth``) and in the children (CUT_HOOK, their sitecustomize)
CUT_LAYERS = 8
CUT_MODEL = "llama3-8b-l8"
CUT_HOOK = f'''
from dataclasses import replace as _replace

from gofr_tpu_torch.models import llama as _llama

_llama.CONFIGS[{CUT_MODEL!r}] = _replace(_llama.LLAMA3_8B, n_layers={CUT_LAYERS})
'''


@contextlib.contextmanager
def cut_depth():
    """CUT_MODEL registered in this process for the block."""
    from gofr_tpu_torch.models import llama

    exec(CUT_HOOK, {})
    try:
        yield
    finally:
        llama.CONFIGS.pop(CUT_MODEL, None)


def cut_checkpoint(ckpt: str, path: str) -> int:
    """A CUT_MODEL checkpoint in the empty directory ``path`` from phase
    12's (``write_checkpoint``: 8 layers a shard, the first shard with the
    embedding, the final norm and lm_head): its first shard linked, an
    index of its tensors, the generation config copied. -> its bytes."""
    with open(os.path.join(ckpt, "model.safetensors.index.json")) as f:
        weight_map = json.load(f)["weight_map"]
    first = sorted(set(weight_map.values()))[0]
    keep = {k: v for k, v in weight_map.items() if v == first}
    check(f"model.layers.{CUT_LAYERS - 1}.mlp.down_proj.weight" in keep
          and f"model.layers.{CUT_LAYERS}.mlp.down_proj.weight" not in keep,
          f"fleet: {first} does not hold layers 0..{CUT_LAYERS - 1}")
    os.symlink(os.path.join(ckpt, first), os.path.join(path, first))
    nbytes = os.path.getsize(os.path.join(ckpt, first))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": nbytes}, "weight_map": keep}, f)
    shutil.copy(os.path.join(ckpt, "generation_config.json"), path)
    return nbytes


def get_body(address: str, path: str, timeout: float = 30.0) -> tuple:
    """GET -> (status, parsed JSON body, its "data" when enveloped)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(address + path, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as err:
        status, raw = err.code, err.read()
    body = json.loads(raw) if raw else None
    data = body.get("data", body) if isinstance(body, dict) else body
    return status, data


def stream_ids(port: int, body: dict, headers: dict = None, kill_after: int = 0,
               on_kill=None) -> dict:
    """One streamed completion of token ids through ``port``: its ids in
    order, the seconds to the first token, the widest gap between two token
    frames and where it fell; ``kill_after`` frames in, ``on_kill()`` runs
    (the stream goes on reading)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/completions", json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    ids, times, buf, error, done = [], [], b"", None, False
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            for line in frame.split(b"\n"):
                if not line.startswith(b"data: "):
                    continue
                data = line[6:].decode()
                if data == "[DONE]":
                    done = True
                    continue
                doc = json.loads(data)
                if "error" in doc:
                    error = doc["error"]
                    continue
                choice = doc["choices"][0] if doc.get("choices") else None
                if choice and choice.get("tokens"):
                    ids.extend(choice["tokens"])
                    times.append(time.perf_counter() - t0)
                    if kill_after and len(times) == kill_after and on_kill is not None:
                        on_kill()
    conn.close()
    gaps = [b - a for a, b in zip(times, times[1:])]
    widest = max(range(len(gaps)), key=gaps.__getitem__) if gaps else None
    return {"status": resp.status, "ids": ids, "ttft_s": times[0] if times else None,
            "error": error, "done": done, "seconds": times[-1] if times else None,
            "gap_s": gaps[widest] if gaps else None, "gap_after": widest,
            "request_id": resp.getheader("X-Gofr-Request-Id")}


def fleet_divergence(address: str, prompt: list, want: list, got: list, label: str) -> dict:
    """``got`` against ``want`` (ids of another process) under the near-tie
    rule: equal, or parting where the replica at ``address`` gives the
    context ``prompt + want[:j]`` top-2 logprobs closer than FLEET_NEAR_TIE."""
    n = min(len(want), len(got))
    j = next((i for i in range(n) if want[i] != got[i]), None)
    if j is None and len(want) == len(got):
        return {"diverged": False}
    j = n if j is None else j
    status, doc, _, _ = post(int(address.rsplit(":", 1)[1]), {
        "prompt": prompt + want[:j], "max_tokens": 1, "temperature": 0, "logprobs": 2})
    check(status == 200, f"{label}: the near-tie check's request failed ({status})")
    top = sorted(doc["choices"][0]["logprobs"]["top_logprobs"][0].values(), reverse=True)
    gap = top[0] - top[1]
    print(f"{label}: ids part at position {j} ({want[j] if j < len(want) else 'a stop'} / "
          f"{got[j] if j < len(got) else 'a stop'}): top-2 logprobs {top[0]:.4f} / "
          f"{top[1]:.4f}, gap {gap:.4f} against {FLEET_NEAR_TIE} -> "
          f"{'near tie' if gap < FLEET_NEAR_TIE else 'FAIL'}", flush=True)
    check(gap < FLEET_NEAR_TIE, f"{label}: the ids part where there is no near tie")
    return {"diverged": True, "position": j, "gap": gap}


class _Replica:
    """One supervised replica process (``python -m
    gofr_tpu_torch.devtools.replica_proc`` under ``devtools/supervise``)."""

    def __init__(self, name: str, role: str, env: dict, workdir: str):
        from gofr_tpu_torch.devtools.supervise import Supervisor

        self.name, self.role, self.port = name, role, free_port()
        self.address = f"http://127.0.0.1:{self.port}"
        self.fault_file = os.path.join(workdir, f"fault-{name}")
        child_env = {**env, "HTTP_PORT": str(self.port), "FLEET_ROLE": role,
                     "CHIP_SMOKE_FAULT_FILE": self.fault_file}
        self.log = open(os.path.join(workdir, f"{name}.log"), "ab")
        self.supervisor = Supervisor(
            [sys.executable, "-m", "gofr_tpu_torch.devtools.replica_proc"], env=child_env,
            backoff_s=0.5, backoff_max_s=2.0, max_restarts_in_window=5,
            stdout=self.log, stderr=self.log,
        )

    def wait_ready(self, timeout_s: float = 600.0) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout_s:
            try:
                status, _ = get_body(self.address, "/.well-known/ready", timeout=5)
                if status == 200:
                    return time.perf_counter() - t0
            except OSError:
                pass
            check(self.supervisor.verdict is None,
                  f"fleet: {self.name} stopped ({self.supervisor.snapshot()})")
            time.sleep(0.2)
        check(False, f"fleet: {self.name} never became ready; its log: {self.tail()}")

    def engine(self) -> dict:
        status, data = get_body(self.address, "/admin/engine")
        check(status == 200, f"fleet: {self.name} /admin/engine {status}")
        return data

    def tail(self) -> str:
        self.log.flush()
        with open(self.log.name, "rb") as f:
            return f.read()[-3000:].decode("utf-8", "replace")


class _MemorySampler:
    """The card's used memory as ``nvidia-smi --query-gpu=memory.used``
    reports it (every process's allocations and CUDA contexts together),
    sampled every 0.25 s: its peak while two replicas and this script share
    the card."""

    def __init__(self):
        self.peak_mib, self._stop = 0, threading.Event()
        self._thread = threading.Thread(target=self._run, name="fleet-mem", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(0.25):
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits",
                     "--id=0"], capture_output=True, text=True, timeout=10).stdout.strip()
            except (OSError, subprocess.SubprocessError):
                return
            if out.isdigit():
                self.peak_mib = max(self.peak_mib, int(out))

    def stop(self) -> float:
        self._stop.set()
        self._thread.join(15)
        return round(self.peak_mib / 1024, 2)


def kv_chaos_proxy(donor: str):
    """An HTTP server in this process that answers ``GET /admin/kv/{hash}``
    by relaying the donor's stream, behind ``devtools/chaos.py``'s chaos
    middleware: the donor's transfer with failures injected on the wire (a
    flipped bit, a stall, a cut body). -> (server, its address, controller)."""
    import asyncio

    from gofr_tpu_torch.devtools.chaos import ChaosController, chaos_middleware
    from gofr_tpu_torch.http.response import Response
    from gofr_tpu_torch.http.router import Router
    from gofr_tpu_torch.http.server import HTTPServer
    from gofr_tpu_torch.logging import Level, Logger
    from gofr_tpu_torch.service import HTTPService

    controller = ChaosController(seed=19)
    quiet = Logger(Level.FATAL)
    router = Router()
    router.use(chaos_middleware(controller))

    async def relay(request):
        headers = {k: request.header(k) for k in ("X-Request-Deadline-Ms", "X-Gofr-Request-Id")
                   if request.header(k)}
        loop = asyncio.get_running_loop()
        upstream = await loop.run_in_executor(None, lambda: HTTPService(
            donor, quiet, name="kv-chaos").stream("GET", request.path, headers=headers))
        if upstream.status_code != 200:
            body = await loop.run_in_executor(None, upstream.read)
            upstream.close()
            return Response(status=upstream.status_code, body=body,
                            headers={"Content-Type": "application/json"})
        it = upstream.iter_chunks(1 << 20)

        async def chunks():
            try:
                while True:
                    chunk = await loop.run_in_executor(None, next, it, None)
                    if chunk is None:
                        return
                    yield chunk
            finally:
                upstream.close()

        return Response(status=200, headers={"Content-Type": "application/x-gofr-kv"},
                        stream=chunks())

    router.add("GET", "/admin/kv/{hash}", relay)
    server = HTTPServer(router, free_port()).run_in_thread()
    return server, f"http://127.0.0.1:{server.port}", controller


def transfer_costs(torch) -> dict:
    """The pull's parts on the card and the host, per 8 MiB llama3-8b block:
    the arena's export (device-to-host copy), ``zlib.crc32``, the wire
    decoder's framing of one block, and the ingest (host-to-device copy),
    over 16 blocks of a TorchKVArena of the served geometry."""
    import statistics
    import zlib

    from gofr_tpu_torch.fleet import kvwire
    from gofr_tpu_torch.models.llama import CONFIGS
    from gofr_tpu_torch.tpu.kv_blocks import BlockTable, TorchKVArena

    cfg = CONFIGS["llama3-8b"]
    arena = TorchKVArena(cfg, 17, 64, max_seq=2048, device="cuda", dtype=torch.bfloat16)
    arena.k.normal_()
    arena.v.normal_()
    table = BlockTable(list(range(1, 17)), 1024)
    times = {"export_ms": [], "crc32_ms": [], "decode_ms": [], "ingest_ms": []}
    for j in range(16):
        torch.cuda.synchronize()
        t = time.perf_counter()
        payload = arena.export_block_payload(table, j)
        times["export_ms"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        zlib.crc32(payload)
        times["crc32_ms"].append((time.perf_counter() - t) * 1e3)
        frame = kvwire.encode_block(0, payload)
        dec = kvwire.WireDecoder()
        dec.feed(kvwire.encode_header({"n_blocks": 1}))
        t = time.perf_counter()
        for i in range(0, len(frame), 65536):
            dec.feed(frame[i:i + 65536])
        times["decode_ms"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        arena.ingest_block_payload(table, (j + 1) % 16, payload)
        torch.cuda.synchronize()
        times["ingest_ms"].append((time.perf_counter() - t) * 1e3)
    check(arena.export_block_payload(table, 1) == payload, "fleet: an ingested block differs")
    out = {k: statistics.median(v) for k, v in times.items()}
    out["block_bytes"] = len(payload)
    del arena
    torch.cuda.empty_cache()
    return out


def fleet(torch, flash, card: str, ckpt: str, gen) -> dict:
    """Phase 19 (last; phase 5's weights from phase 12's checkpoint): a
    prefill and a decode replica process of llama3-8b in phase 10's
    configuration, each under ``devtools/supervise``, behind a router in
    this process: a KV pull against a local prefill, the pull's failures
    falling back, a failover by ``kill -9`` with the stream resumed, a
    sticky device fault restarted, and the router's own legs."""
    import gofr_tpu_torch
    from gofr_tpu_torch.config import DECLARED_KEYS, UNHONORED_KEYS
    from gofr_tpu_torch.fleet import kvwire, wire_fleet

    t0 = time.perf_counter()
    out: dict = {"card": card}
    out["transfer_costs"] = transfer_costs(torch)
    print(f"fleet: a block's parts (ms, 8 MiB): {json.dumps(out['transfer_costs'])}", flush=True)
    workdir = tempfile.mkdtemp(prefix="gofr_fleet_")
    with open(os.path.join(workdir, "sitecustomize.py"), "w") as f:
        f.write(FAULT_HOOK + CUT_HOOK)
    cut = os.path.join(workdir, "cut")
    os.mkdir(cut)
    out["checkpoint_gb"] = cut_checkpoint(ckpt, cut) / 1e9
    here = os.path.dirname(os.path.abspath(__file__))
    base_env = {k: v for k, v in os.environ.items()
                if k not in DECLARED_KEYS and k not in UNHONORED_KEYS}
    # no tokenizer: the prompts are id lists, and every choice and stream
    # frame then carries its token ids
    base_env.update({
        **{k: v for k, v in PHASE10_ENV.items() if k != "TOKENIZER"}, **FLEET_REPLICA_ENV,
        "MODEL_NAME": CUT_MODEL, "MODEL_PATH": cut,
        "PYTHONPATH": os.pathsep.join([workdir, here, os.environ.get("PYTHONPATH", "")]),
        "CHIP_SMOKE_FAULT_CYCLES": str(int(cycles_per_second(torch) * FAULT_SLEEP_S)),
    })
    pre = _Replica("pre", "prefill", base_env, workdir)
    dec = _Replica("dec", "decode", base_env, workdir)
    replicas = {"pre": pre, "dec": dec}
    sampler = _MemorySampler()
    torch.cuda.reset_peak_memory_stats()
    app = proxy = None
    try:
        boot_t = time.perf_counter()
        pre.supervisor.start()
        dec.supervisor.start()
        booted: dict = {}
        for n, r in replicas.items():
            threading.Thread(target=lambda n=n, r=r: booted.update({n: r.wait_ready()}),
                             daemon=True).start()
        while len(booted) < 2 and time.perf_counter() - boot_t < 600:
            check(all(r.supervisor.verdict is None for r in replicas.values()),
                  f"fleet: a replica stopped booting; logs: {pre.tail()} {dec.tail()}")
            time.sleep(0.1)
        check(len(booted) == 2, f"fleet: the replicas did not boot ({booted}); "
              f"logs: {pre.tail()} {dec.tail()}")
        out["boot_s"] = {**booted, "both": time.perf_counter() - boot_t}
        engines = {n: r.engine() for n, r in replicas.items()}
        # a 64-token block of CUT_LAYERS layers' K and V (8 heads of 128, bf16)
        block_bytes = CUT_LAYERS * 64 * 8 * 128 * 2 * 2
        for n, e in engines.items():
            check(e["role"] == {"pre": "prefill", "dec": "decode"}[n], f"fleet: {n} role {e['role']}")
            check(e["kv_blocks"]["block_bytes"] == block_bytes
                  and e["kv_blocks"]["ledger"] == (2 << 30) // block_bytes
                  and e["kv_blocks"]["hbm_budget_bytes"] == 2 << 30,
                  f"fleet: {n} arena {e['kv_blocks']}")
        print(f"fleet: two replica processes of {CUT_MODEL} ready in {out['boot_s']['both']:.1f}s "
              f"(prefill {out['boot_s']['pre']:.1f}s, decode {out['boot_s']['dec']:.1f}s); "
              f"arena ledger {(2 << 30) // block_bytes} blocks of "
              f"{engines['dec']['kv_blocks']['block_bytes']} B, "
              f"{engines['dec']['kv_blocks']['total']} data blocks", flush=True)
        env = {**FLEET_ROUTER_ENV, "HTTP_PORT": str(free_port()),
               "FLEET_REPLICAS": f"pre={pre.address},dec={dec.address}"}
        with environment(env):  # wire_fleet reads the FLEET_* keys
            app = gofr_tpu_torch.new()
            router = wire_fleet(app)
        check(app.container.tpu is None, "fleet: the router booted a device")
        app.start()
        rset = router.replica_set

        def rotation(names, timeout_s=60.0) -> float:
            t = time.perf_counter()
            while time.perf_counter() - t < timeout_s:
                snap = {r.name: r for r in rset.replicas}
                if all(snap[n] in rset.in_rotation() and snap[n].role == replicas[n].role
                       for n in names):
                    return time.perf_counter() - t
                time.sleep(0.05)
            check(False, f"fleet: {names} not in rotation ({rset.snapshot()})")

        rotation(("pre", "dec"))
        out["pull"] = fleet_pull(app, pre, dec)
        peaks = {n: r.engine()["hbm"] for n, r in replicas.items()}
        proxy, proxy_addr, chaos = kv_chaos_proxy(pre.address)
        out["fallbacks"] = fleet_fallbacks(pre, dec, proxy_addr, chaos)
        out["failover"] = fleet_failover(app, pre, dec, out["pull"]["reference"], rotation)
        peaks["dec (respawned)"] = dec.engine()["hbm"]
        out["fault"] = fleet_fault(app, dec, rotation)
        for n, r in replicas.items():
            peaks[n if n == "pre" else "dec (second respawn)"] = r.engine()["hbm"]
        out["replica_peak_gib"] = {
            n: {"allocated": round(h["peak_bytes_in_use"] / 2**30, 2),
                "reserved": round(h["peak_bytes_reserved"] / 2**30, 2)} for n, h in peaks.items()}
        print(f"fleet: peak device memory a replica process (allocated / reserved, GiB): "
              f"{json.dumps(out['replica_peak_gib'])}", flush=True)
        out["router_legs"] = fleet_router_legs()
        out["drain"] = fleet_drain(app, out["pull"]["reference"])
        app = None
    finally:
        if proxy is not None:
            proxy.shutdown()
        if app is not None:
            app.shutdown()
        for r in replicas.values():
            r.supervisor.stop()
            r.log.close()
        out["card_peak_used_gib"] = sampler.stop()
        shutil.rmtree(workdir, ignore_errors=True)
    out["script_peak_gib"] = round(torch.cuda.max_memory_reserved() / 2**30, 2)
    print(f"fleet: the card's peak used memory {out['card_peak_used_gib']} GiB (nvidia-smi, "
          f"every process), this script's reserve {out['script_peak_gib']} GiB", flush=True)
    # the parent's own context after the children's faults and kills
    out["parent_decode"] = pool_decode_kernel(torch, flash, gen)
    out["phase_s"] = time.perf_counter() - t0
    print(f"fleet-metrics [{card}]: {json.dumps(out)}", flush=True)
    return out


def _launch_delta(after: dict, before: dict) -> dict:
    return {k: after["kernel_launches"][k] - before["kernel_launches"][k]
            for k in ("flash_fwd", "flash_fwd_sm90", "flash_fwd_decode")}


def fleet_pull(app, pre, dec) -> dict:
    """Leg 1: two 1,024- and two 1,900-token id prompts, each warmed on the
    prefill replica directly, then streamed through the router to the
    decode replica, which pulls the donor's blocks (``X-KV-Donor``): outcome
    ``ok``, the two ledgers joined on the request id, a whole fleet trace,
    no prefill on the receiver. Then the same prompt prefilled locally on
    the receiver (its entries evicted by four short prompts, no donor hint:
    what ``KV_TRANSFER=off`` does): TTFT beside TTFT, ids against ids."""
    import statistics

    out: dict = {"prompts": {}}
    start = {"pre": pre.engine(), "dec": dec.engine()}
    rows: dict = {1024: [], 1900: []}
    # two prompts a length; the first 1,024-token stream, 64 tokens long,
    # is the later legs' uninterrupted reference
    for n, seed, max_tokens in [(n, 1901 + 10 * k + (n == 1900), 64 if n + k == 1024 else 16)
                                for k in range(2) for n in (1024, 1900)]:
        prompt = list(text(seed, n).encode())
        body = {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0}
        pins = pre.engine()["kv_blocks"]
        status, doc, _, _ = post(pre.port, body)
        check(status == 200, f"fleet: warming the donor: {status}")
        donor_ids = doc["choices"][0]["tokens"]
        before = {"pre": pre.engine(), "dec": dec.engine()}
        rid = f"pull-{n}-{seed}"
        pulled = stream_ids(app.http_port, body, headers={"X-Request-ID": rid})
        after = {"pre": pre.engine(), "dec": dec.engine()}
        check(pulled["status"] == 200 and pulled["done"] and not pulled["error"],
              f"fleet: the pulled stream {pulled['status']} {pulled['error']}")
        x0, x1 = before["dec"]["kv_transfer"], after["dec"]["kv_transfer"]
        check(x1["ok"] == x0["ok"] + 1 and x1["fallback"] == x0["fallback"],
              f"fleet: the pull was not ok ({x1})")
        pull, served = x1["pulls_recent"][-1], after["pre"]["kv_transfer"]["served_recent"][-1]
        check(pull["outcome"] == "ok" and pull["request_id"] == rid == served["request_id"],
              f"fleet: the ledgers do not join on {rid}: {pull} / {served}")
        launches = _launch_delta(after["dec"], before["dec"])
        check(launches["flash_fwd_sm90"] == 0 and launches["flash_fwd_decode"] > 0,
              f"fleet: the receiver prefilled a pulled prompt ({launches})")
        status, trace = get_body(f"http://127.0.0.1:{app.http_port}", f"/admin/fleet/trace/{rid}")
        check(status == 200 and trace["partial"] is False,
              f"fleet: the fleet trace of {rid}: {status} {trace}")
        block_bytes = after["dec"]["kv_blocks"]["block_bytes"]
        nbytes = served["n_blocks"] * block_bytes
        # the local prefill of the same prompt on the receiver
        for i in range(4):
            status, _, _, _ = post(dec.port, {"prompt": list(text(seed * 10 + i, 64).encode()),
                                              "max_tokens": 2, "temperature": 0})
            check(status == 200, f"fleet: a filler request {status}")
        b = dec.engine()
        local = stream_ids(dec.port, body)
        a = dec.engine()
        check(local["status"] == 200 and local["done"], f"fleet: the local run {local['status']}")
        local_launches = _launch_delta(a, b)
        check(local_launches["flash_fwd_sm90"] >= CUT_LAYERS * -(-n // 512),
              f"fleet: the local run did not prefill the whole prompt ({local_launches})")
        check(a["kv_transfer"]["ok"] == b["kv_transfer"]["ok"], "fleet: the local run pulled")
        row = {
            "blocks": served["n_blocks"], "bytes": nbytes, "pull_ms": pull["elapsed_ms"],
            "pull_gb_per_s": nbytes / 1e9 / (pull["elapsed_ms"] / 1e3),
            "ttft_pull_ms": pulled["ttft_s"] * 1e3, "ttft_local_ms": local["ttft_s"] * 1e3,
            "receiver_launches_pull": launches, "receiver_launches_local": local_launches,
            "vs_local": fleet_divergence(dec.address, prompt, local["ids"], pulled["ids"],
                                         f"fleet pull {n}"),
            "vs_donor": fleet_divergence(pre.address, prompt, donor_ids, pulled["ids"],
                                         f"fleet pull {n} vs donor"),
        }
        rows[n].append(row)
        print(f"fleet pull {n} tokens (seed {seed}): {row['blocks']} blocks, {nbytes / 2**20:.0f} MiB in "
              f"{row['pull_ms']:.1f} ms ({row['pull_gb_per_s']:.3f} GB/s); TTFT with the pull "
              f"{row['ttft_pull_ms']:.1f} ms, local prefill {row['ttft_local_ms']:.1f} ms; "
              f"receiver launches pulled {launches}, local {local_launches}", flush=True)
        if n == 1024 and "reference" not in out:
            out["reference"] = {"body": body, "ids": pulled["ids"], "prompt": prompt}
        # the export's pin released: the donor's blocks as before this prompt
        _pins_back(pre, pins, f"fleet pull {n}")
    for n, runs in rows.items():
        summary = {k: statistics.median(r[k] for r in runs)
                   for k in ("pull_ms", "pull_gb_per_s", "ttft_pull_ms", "ttft_local_ms")}
        out["prompts"][str(n)] = {"blocks": runs[0]["blocks"], "bytes": runs[0]["bytes"],
                                  "median": summary, "runs": runs}
        print(f"fleet pull {n} tokens, median of {len(runs)}: {json.dumps(summary)}", flush=True)
    end = {"pre": pre.engine(), "dec": dec.engine()}
    out["launches"] = {
        "sm90": sum(_launch_delta(end[k], start[k])["flash_fwd_sm90"] for k in end),
        "decode": sum(_launch_delta(end[k], start[k])["flash_fwd_decode"] for k in end),
        "all": sum(_launch_delta(end[k], start[k])["flash_fwd"] for k in end),
    }
    check(out["launches"]["all"] == out["launches"]["sm90"] + out["launches"]["decode"],
          f"fleet: a forward took another route than sm90 or decode {out['launches']}")
    return out


def donor_entry(pre, prompt: list) -> dict:
    """What the donor holds for ``prompt``, read from its ``/admin/engine``
    without touching its cache (a ``GET /admin/kv/<hash>`` would refresh
    the entry's LRU place and hide an eviction): whether a cached entry
    hashes to the prompt and its place, LRU first; every entry's hash
    prefix and length; its block pool's counters and its engine state."""
    from gofr_tpu_torch.fleet.kvwire import prompt_hash

    engine = pre.engine()
    want, kv = prompt_hash(prompt), engine["kv_blocks"]
    cached = engine["kv_transfer"]["cached"]
    places = [i for i, e in enumerate(cached) if e["prompt_hash"] == want]
    return {"held": bool(places), "place": places[0] if places else None,
            "entries": [f"{e['prompt_hash'][:8]}:{e['length']}" for e in cached],
            **{k: kv.get(k) for k in ("free", "cached", "active", "reserved", "evictions")},
            "prefix": engine["caches"].get("prefix"), "state": engine["engine"]["state"],
            "recoveries": engine["recovery"]["incidents"], "boot_id": engine["boot_id"]}


def _idle_pins(pre, timeout_s: float = 20.0) -> dict:
    """The donor's block counts once none is active or reserved: a request
    it just answered may still hold its blocks for a moment after the
    answer (read too soon, the baseline kept the warm-up's 8 active blocks,
    which then never came "back")."""
    t = time.perf_counter()
    kv = pre.engine()["kv_blocks"]
    while (kv["active"] or kv["reserved"]) and time.perf_counter() - t < timeout_s:
        time.sleep(0.1)
        kv = pre.engine()["kv_blocks"]
    return kv


def _pins_back(pre, before: dict, label: str) -> float:
    t = time.perf_counter()
    while time.perf_counter() - t < 20:
        kv = pre.engine()["kv_blocks"]
        if kv["active"] == before["active"] and kv["reserved"] == before["reserved"]:
            return time.perf_counter() - t
        time.sleep(0.1)
    check(False, f"{label}: the donor's blocks stay pinned ({kv}, before {before})")


def fleet_fallbacks(pre, dec, proxy: str, chaos) -> dict:
    """Leg 2: a pull that fails falls back to a local prefill with the same
    ids: a bit flipped in a block (``corrupt``), a donor slowed past the
    budget (``slow_loris``: ``timeout``), an entry the donor never held
    (404: ``evicted``), and a donor stopped mid-pull (the body cut after
    half its blocks, no trailer: ``corrupt``). The receiver names the chaos
    proxy before the donor as its donor; the pull's budget is half an 8 s
    deadline. After each, the donor's block refcounts are back."""
    out = {}
    half = 4 * pre.engine()["kv_blocks"]["block_bytes"]  # 4 of the prompt's 8 blocks
    for k, (case, outcome) in enumerate((("bit flip", "corrupt"), ("slow donor", "timeout"),
                                         ("evicted", "evicted"), ("donor stopped", "corrupt"))):
        prompt = list(text(1910 + k, 512).encode())
        body = {"prompt": prompt, "max_tokens": 16, "temperature": 0}
        want = None
        held = None
        if case != "evicted":
            status, doc, _, _ = post(pre.port, body)
            check(status == 200, f"fleet fallback {case}: warming the donor {status}")
            want = doc["choices"][0]["tokens"]
            # what the donor holds before a fault is armed, its cache untouched
            held = donor_entry(pre, prompt)
            print(f"fleet fallback {case}: the donor before the pull: {json.dumps(held)}",
                  flush=True)
        pins = _idle_pins(pre)
        if case == "bit flip":
            chaos.corrupting_proxy("flip", n=1, after_bytes=1024)  # past the header
        elif case == "slow donor":
            chaos.slow_loris(0.5, paths=("/admin/kv/",))
        elif case == "donor stopped":
            chaos.corrupting_proxy("truncate", n=1, after_bytes=half)
        x0 = dec.engine()["kv_transfer"]
        t = time.perf_counter()
        got = stream_ids(dec.port, body, headers={"X-KV-Donor": proxy,
                                                  "X-Request-Deadline-Ms": "8000"})
        seconds = time.perf_counter() - t
        chaos.clear()
        x1 = dec.engine()["kv_transfer"]
        check(got["status"] == 200 and got["done"] and not got["error"],
              f"fleet fallback {case}: {got['status']} {got['error']}")
        moved = {o: x1[o] - x0[o] for o in ("ok", "timeout", "corrupt", "evicted", "fallback")}
        if moved != {**dict.fromkeys(moved, 0), outcome: 1, "fallback": 1}:
            print(f"fleet fallback {case}: the donor after the pull: "
                  f"{json.dumps(donor_entry(pre, prompt))}, before it: {json.dumps(held)}; "
                  f"the receiver's pull {json.dumps(x1['pulls_recent'][-1:])}", flush=True)
        check(moved == {**dict.fromkeys(moved, 0), outcome: 1, "fallback": 1},
              f"fleet fallback {case}: counters moved {moved}")
        if want is None:
            status, doc, _, _ = post(pre.port, body)
            want = doc["choices"][0]["tokens"]
        div = fleet_divergence(pre.address, prompt, want, got["ids"], f"fleet fallback {case}")
        back = _pins_back(pre, pins, f"fleet fallback {case}")
        out[case] = {"outcome": outcome, "moved": moved, "seconds": seconds,
                     "pull_ms": x1["pulls_recent"][-1]["elapsed_ms"], "ids": div,
                     "pins_back_s": back}
        print(f"fleet fallback {case}: {outcome} + fallback, completed in {seconds:.2f}s "
              f"(pull {out[case]['pull_ms']} ms) with the local ids ({div}); donor refcounts "
              f"back in {back:.2f}s", flush=True)
    return out


def fleet_failover(app, pre, dec, reference: dict, rotation) -> dict:
    """Leg 3: ``kill -9`` of the decode replica 8 frames into a stream
    through the router: the router resumes it on the prefill replica
    (``X-Resume-From``); the spliced ids against the uninterrupted run's.
    The supervisor respawns the decode replica, the prober walks its new
    boot id back through probation into rotation."""
    killed: list = []

    def kill():
        killed.append(time.perf_counter())
        dec.supervisor.kill9()

    restarts0 = {r.name: r.restarts for r in app.container.fleet.replica_set.replicas}["dec"]
    got = stream_ids(app.http_port, reference["body"], headers={"X-Request-ID": "failover"},
                     kill_after=8, on_kill=kill)
    check(bool(killed), "fleet failover: the stream ended before the kill")
    check(got["status"] == 200 and got["done"] and not got["error"],
          f"fleet failover: {got['status']} {got['error']}")
    record = app.container.fleet.records(request_id="failover", limit=1)[0]
    check(record["resumes"] >= 1, f"fleet failover: no resume in the route record {record}")
    div = fleet_divergence(pre.address, reference["prompt"], reference["ids"], got["ids"],
                           "fleet failover")
    ready_s = dec.wait_ready()
    ready_at = time.perf_counter()
    rotation_s = rotation(("dec",), timeout_s=120)
    restarts = {r.name: r.restarts for r in app.container.fleet.replica_set.replicas}["dec"]
    check(restarts == restarts0 + 1, f"fleet failover: restarts {restarts0} -> {restarts}")
    out = {"gap_s": got["gap_s"], "gap_after_frame": got["gap_after"],
           "resumes": record["resumes"], "ids": div,
           "respawn_to_ready_s": ready_at - killed[0], "rotation_after_ready_s": rotation_s,
           "restarts": restarts}
    print(f"fleet failover: killed the decode replica 8 frames in; the client's widest gap "
          f"{got['gap_s']:.3f}s after frame {got['gap_after']}, {record['resumes']} resume(s), "
          f"ids {div}; respawn to ready {out['respawn_to_ready_s']:.1f}s, back in rotation "
          f"{rotation_s:.2f}s later (restarts {restarts})", flush=True)
    return out


def fleet_fault(app, dec, rotation) -> dict:
    """Leg 4: a sticky device fault in the decode replica's process alone
    (its site hook: the card slept 5 s, then an out-of-bounds write's
    device-side assert) while a request decodes: the watchdog wedges, both
    rebuilds fail on the faulted context, the engine ends ``failed`` with a
    restart verdict; this script, as the orchestrator that reads it, kills
    the process, the supervisor respawns it and the router takes it back.
    MTTR from the fault to the first 200."""
    check(dec.engine()["engine"]["state"] == "serving", "fleet fault: not serving before")
    replica = {r.name: r for r in app.container.fleet.replica_set.replicas}["dec"]
    restarts0, left_rotation = replica.restarts, []
    answered: list = []

    def request():
        try:
            answered.append(post(dec.port, {"prompt": list(text(1920, 256).encode()),
                                            "max_tokens": 32, "temperature": 0})[0])
        except Exception as exc:  # the faulted process may drop the connection
            answered.append(repr(exc))

    t_fault = time.perf_counter()
    open(dec.fault_file, "w").close()
    time.sleep(0.2)
    worker = threading.Thread(target=request)
    worker.start()
    state, detail = "serving", ""
    while time.perf_counter() - t_fault < 120:
        if replica not in app.container.fleet.replica_set.in_rotation():
            left_rotation.append(time.perf_counter() - t_fault)
        try:
            snap = dec.engine()["engine"]
            state, detail = snap["state"], snap["detail"]
        except Exception:
            pass
        if state == "failed":
            break
        time.sleep(0.2)
    t_failed = time.perf_counter()
    check(state == "failed" and "restart" in detail,
          f"fleet fault: the engine is {state} ({detail}); log: {dec.tail()}")
    status, ready = get_body(dec.address, "/.well-known/ready")
    check(status == 503, f"fleet fault: readiness {status} on a failed engine")
    os.remove(dec.fault_file)
    dec.supervisor.kill9()
    worker.join(60)
    dec.wait_ready()
    t_ready = time.perf_counter()
    status, _, _, _ = post(dec.port, {"prompt": list(text(1921, 64).encode()), "max_tokens": 4,
                                      "temperature": 0})
    t_200 = time.perf_counter()
    check(status == 200, f"fleet fault: the respawned replica answered {status}")
    rotation_s = rotation(("dec",), timeout_s=120)
    check(replica.restarts == restarts0 + 1 and left_rotation,
          f"fleet fault: the router saw restarts {restarts0} -> {replica.restarts}, out of "
          f"rotation {bool(left_rotation)}")
    out = {"failed_after_s": t_failed - t_fault, "left_rotation_after_s": left_rotation[0], "detail": detail, "ready_body": ready,
           "faulted_request": answered, "respawn_ready_s": t_ready - t_failed,
           "mttr_s": t_200 - t_fault, "rotation_after_200_s": rotation_s}
    print(f"fleet fault: failed {out['failed_after_s']:.1f}s after the fault ({detail}); "
          f"killed, ready again {out['respawn_ready_s']:.1f}s later; MTTR (fault to the first "
          f"200) {out['mttr_s']:.1f}s; back in rotation {rotation_s:.2f}s after", flush=True)
    return out


def fleet_router_legs() -> dict:
    """Leg 5a: the router's own legs, before two device-free stub replicas
    in this process (each records the deadline header it receives and
    answers its first request 503): the REMAINING budget forwarded across
    retries, a tenant's quota shed with ``Retry-After``, and a breaker
    opening on a refused connection and closing on its half-open probe."""
    import gofr_tpu_torch
    from gofr_tpu_torch.errors import HTTPError
    from gofr_tpu_torch.fleet import wire_fleet
    from gofr_tpu_torch.fleet.replica import affinity_order
    from gofr_tpu_torch.http.response import Raw
    from gofr_tpu_torch.http.server import HTTPServer

    seen: list = []  # the deadline header of every attempt, in arrival order
    fail_first = {"s0": True, "s1": True}

    def handler_for(name):
        def handler(ctx):
            seen.append(ctx.request.header("X-Request-Deadline-Ms"))
            if fail_first[name]:
                fail_first[name] = False
                time.sleep(0.2)  # spends visible budget before failing
                raise HTTPError(503, "warming up")
            return Raw({"served_by": name})
        return handler

    stubs, out = {}, {}
    router = None
    try:
        for name in ("s0", "s1"):
            port = free_port()
            with environment({"HTTP_PORT": str(port), "LOG_LEVEL": "FATAL",
                              "TIMEBASE_ENABLED": "off"}):
                stub = gofr_tpu_torch.new()
            stub.post("/v1/completions", handler_for(name))
            stub.start()
            stubs[name] = (stub, port)
        env = {"HTTP_PORT": str(free_port()), "LOG_LEVEL": "FATAL", "TIMEBASE_ENABLED": "off",
               "FLEET_REPLICAS": ",".join(f"{n}=http://127.0.0.1:{p}" for n, (_, p) in
                                          stubs.items()),
               "FLEET_RETRIES": "2", "FLEET_PROBE_INTERVAL_S": "5", "FLEET_QUOTA_RPS": "0.2",
               "FLEET_QUOTA_BURST": "1", "FLEET_BREAKER_THRESHOLD": "2",
               "FLEET_BREAKER_COOLDOWN_S": "1"}
        with environment(env):  # wire_fleet reads the FLEET_* keys
            router = gofr_tpu_torch.new()
            fleet_router = wire_fleet(router)
        router.start()
        port = router.http_port
        # deadline forwarding
        status, _, _, _ = post(port, {"prompt": [1], "max_tokens": 1},
                               headers={"X-Request-Deadline-Ms": "5000",
                                        "Authorization": "t-deadline"})
        budgets = [int(v) for v in seen if v]
        check(status == 200 and len(budgets) >= 2, f"fleet router: deadline leg {status} {seen}")
        check(budgets[0] <= 5000 and budgets[-1] <= budgets[0] - 150 and budgets[-1] >= 1,
              f"fleet router: forwarded budgets {budgets}")
        out["deadline_budgets_ms"] = budgets
        # quota
        first = post(port, {"prompt": [1], "max_tokens": 1}, headers={"Authorization": "t-q"})
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/v1/completions", json.dumps({"prompt": [1], "max_tokens": 1}),
                     {"Content-Type": "application/json", "Authorization": "t-q"})
        resp = conn.getresponse()
        shed_body, retry_after = json.loads(resp.read()), resp.getheader("Retry-After")
        conn.close()
        check(first[0] == 200 and resp.status == 429 and retry_after,
              f"fleet router: quota {first[0]} then {resp.status} Retry-After {retry_after}")
        out["quota"] = {"status": resp.status, "retry_after": retry_after,
                        "reason": shed_body["error"].get("reason")}
        # breaker: pinned to s1 by a session key, s1's listener gone
        names = [r.name for r in fleet_router.replica_set.replicas]
        key = next(f"sess-{i}" for i in range(1000) if affinity_order(f"sess-{i}", names)[0] == "s1")
        stub1, port1 = stubs["s1"]
        stub1.http_server.shutdown()
        stub1.http_server = None
        breaker = {r.name: r for r in fleet_router.replica_set.replicas}["s1"].breaker
        states = [breaker.state]
        for i in range(2):
            status, _, _, _ = post(port, {"prompt": [1], "max_tokens": 1},
                                   headers={"X-Session-ID": key, "Authorization": f"tb{i}"})
            check(status == 200, f"fleet router: a request around the dead s1 {status}")
        states.append(breaker.state)
        stub1.http_server = HTTPServer(stub1.router, port1, stub1.logger).run_in_thread()
        time.sleep(1.1)
        status, doc, _, _ = post(port, {"prompt": [1], "max_tokens": 1},
                                 headers={"X-Session-ID": key, "Authorization": "tb-probe"})
        states.append(breaker.state)
        check(status == 200 and states == ["closed", "open", "closed"],
              f"fleet router: breaker states {states} ({status} {doc})")
        out["breaker"] = {"states": states, "transitions": breaker.snapshot()["transitions"]}
        print(f"fleet router legs: budgets forwarded {budgets} ms; quota shed {resp.status} "
              f"Retry-After {retry_after}; breaker {states}", flush=True)
    finally:
        if router is not None:
            router.shutdown()
        for stub, _ in stubs.values():
            stub.shutdown()
    return out


def fleet_drain(app, reference: dict) -> dict:
    """Leg 5b: the router's drain at shutdown: with a stream in flight,
    readiness answers 503 ``draining`` and the stream still completes."""
    first = threading.Event()
    result: dict = {}
    streamer = threading.Thread(target=lambda: result.update(stream_ids(
        app.http_port, reference["body"], kill_after=1, on_kill=first.set)))
    streamer.start()
    check(first.wait(120), "fleet drain: the stream never started")
    stopper = threading.Thread(target=app.shutdown)
    t = time.perf_counter()
    stopper.start()
    ready = None
    while time.perf_counter() - t < 10 and ready is None:
        try:
            status, body = get_body(f"http://127.0.0.1:{app.http_port}", "/.well-known/ready",
                                    timeout=2)
            if status == 503:
                ready = body
        except OSError:
            break
        time.sleep(0.02)
    streamer.join(120)
    stopper.join(60)
    check(ready is not None and ready.get("state") == "draining",
          f"fleet drain: readiness during the drain {ready}")
    check(result.get("status") == 200 and result.get("done") and not result.get("error"),
          f"fleet drain: the in-flight stream {result.get('status')} {result.get('error')}")
    check(result["ids"] == reference["ids"], "fleet drain: the drained stream's ids differ")
    out = {"ready_body": ready, "stream_s": result["seconds"],
           "shutdown_s": time.perf_counter() - t}
    print(f"fleet drain: readiness {ready}; the in-flight stream completed ({len(result['ids'])} "
          f"tokens, the reference ids), shutdown {out['shutdown_s']:.2f}s", flush=True)
    return out


# -- phase 20: GoFr's transports on the card ------------------------------------------

# three prompts in three prefill buckets (64, 256, 512 of phase 10's ladder):
# sent together, cohorts split them and FIFO pads them into one batch
TRANSPORT_LENGTHS = (24, 150, 400)
TRANSPORT_TOKENS = 32
TRANSPORT_COST_LENGTH = 150  # the 1- and 8-stream legs' prompts, in bytes
# the fine-tune: the lora_finetune example's CLI at llama3-8b's widths
# (CUT_MODEL: its first CUT_LAYERS layers), its demo corpus (B=4 crops of 65
# ids: the model sees S=64) and seeded init
FINETUNE_ARGV = ("finetune", f"--model={CUT_MODEL}", "--steps=4", "--rank=8")


def _counters(flash) -> dict:
    """The kernel counters of this process: every variant of each kernel."""
    return {"fwd": flash.launches.value, "fwd_sm90": flash.launches_fwd_sm90.value,
            "fwd_decode": flash.launches_fwd_decode.value, "dq": flash.launches_dq.value,
            "dq_sm90": flash.launches_dq_sm90.value, "dkv": flash.launches_dkv.value,
            "dkv_sm90": flash.launches_dkv_sm90.value}


def _example_process(name: str, module: str, env: dict, workdir: str) -> dict:
    """``python -m gofr_tpu_torch.examples.<module>`` under ``env``, its
    output in a log file."""
    log = open(os.path.join(workdir, f"{name}.log"), "ab")
    proc = subprocess.Popen([sys.executable, "-m", f"gofr_tpu_torch.examples.{module}"],
                            env=env, cwd=workdir, stdout=log, stderr=log)
    return {"name": name, "proc": proc, "log": log,
            "address": f"http://127.0.0.1:{env['HTTP_PORT']}", "port": int(env["HTTP_PORT"])}


def _example_ready(server: dict, timeout_s: float = 600.0) -> float:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        check(server["proc"].poll() is None, f"transports: {server['name']} exited "
              f"({server['proc'].returncode}): {_example_tail(server)}")
        try:
            status, _ = get_body(server["address"], "/.well-known/ready", timeout=5)
            if status == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.2)
    check(False, f"transports: {server['name']} never became ready: {_example_tail(server)}")


def _example_tail(server: dict) -> str:
    server["log"].flush()
    with open(server["log"].name, "rb") as f:
        return f.read()[-3000:].decode("utf-8", "replace")


def _example_stop(server: dict) -> None:
    proc = server["proc"]
    if proc.poll() is None:
        proc.terminate()  # SIGTERM: the app's own shutdown
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
    server["log"].close()


def _sse_generate(port: int, prompt: list) -> dict:
    """One ``POST /generate?stream=true`` of the http example: its ids and
    each token frame's time from the send."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/generate?stream=true",
                 json.dumps({"tokens": prompt, "max_new_tokens": TRANSPORT_TOKENS}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    ids, times, buf, error = [], [], b"", None
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            for line in frame.split(b"\n"):
                if not line.startswith(b"data: ") or line[6:] == b"[DONE]":
                    continue
                event = json.loads(line[6:])
                if "token" in event:
                    ids.append(event["token"])
                    times.append(time.perf_counter() - t0)
                error = event.get("error", error)
    conn.close()
    check(resp.status == 200 and error is None, f"transports SSE: {resp.status} {error}")
    return {"ids": ids, "times": times, "start": t0}


def _grpc_generate(grpc_port: int, prompt: list) -> dict:
    """One ``LLMService/Generate`` server stream of the grpc example: its
    ids and each message's time from the call."""
    import grpc

    with grpc.insecure_channel(f"127.0.0.1:{grpc_port}") as channel:
        call = channel.unary_stream("/LLMService/Generate")
        t0 = time.perf_counter()
        ids, times = [], []
        for message in call(json.dumps({"tokens": prompt, "max_new_tokens": TRANSPORT_TOKENS})
                            .encode(), timeout=600):
            event = json.loads(message)
            if "token" in event:
                ids.append(event["token"])
                times.append(time.perf_counter() - t0)
    return {"ids": ids, "times": times, "start": t0}


def _streams(fn, target, prompts: list) -> tuple:
    """``fn(target, prompt)`` for each prompt at once -> (the results in
    order, aggregate decode tokens/s as ``stream_rate`` reckons it, mean
    TPOT ms)."""
    results: list = [None] * len(prompts)

    def one(i: int) -> None:
        results[i] = fn(target, prompts[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(all(r is not None and len(r["times"]) >= 2 for r in results),
          "transports: a stream gave fewer than 2 tokens")
    firsts = [r["start"] + r["times"][0] for r in results]
    lasts = [r["start"] + r["times"][-1] for r in results]
    tpots = [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) * 1e3 for r in results]
    tokens = sum(len(r["times"]) - 1 for r in results)
    return results, tokens / (max(lasts) - min(firsts)), sum(tpots) / len(tpots)


def _sample_cmd(base_env: dict, workdir: str) -> dict:
    """The CLI example as its own process: a known command's stdout and
    exit 0, an unknown one's exit 1 and message."""
    def run(*args):
        return subprocess.run([sys.executable, "-m", "gofr_tpu_torch.examples.sample_cmd", *args],
                              env=base_env, cwd=workdir, capture_output=True, text=True,
                              timeout=120)

    ok, missing = run("hello", "--name=x"), run("nope")
    check(ok.returncode == 0 and ok.stdout == "Hello x!\n",
          f"transports CLI: {ok.returncode} {ok.stdout!r} {ok.stderr[-500:]}")
    check(missing.returncode == 1 and "No Command Found!" in missing.stderr,
          f"transports CLI: an unknown command gave {missing.returncode} {missing.stderr!r}")
    print("transports: sample_cmd 'hello --name=x' -> 'Hello x!' exit 0; 'nope' -> "
          "'No Command Found!' exit 1", flush=True)
    return {"hello": ok.stdout.strip(), "unknown_exit": missing.returncode}


def _finetune(torch, flash, card: str, merged: str) -> dict:
    """The lora_finetune example's ``finetune`` through ``new_cmd`` and
    ``run_cmd`` in this process (its counters readable here): the steps'
    losses and ms, the kernels' launches, the merge and the write."""
    from gofr_tpu_torch.cmd import run_cmd
    from gofr_tpu_torch.examples import lora_finetune
    from gofr_tpu_torch.testutil import stdout_output_for

    out: dict = {}
    with environment({"TORCH_DEVICE": "cuda", "LOG_LEVEL": "INFO", "TIMEBASE_ENABLED": "off",
                      "SLO": "off"}), cut_depth():
        app = lora_finetune.build()
        check(app.container.tpu is None, "transports: the CLI app booted a device")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _counters(flash)
        t0 = time.perf_counter()
        codes: list = []
        text_out = stdout_output_for(
            lambda: codes.append(run_cmd(app, [*FINETUNE_ARGV, f"--out={merged}"])))
        out["cli_s"] = time.perf_counter() - t0
        after = _counters(flash)
        out["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
        app.container.close()
    check(codes == [0], f"transports fine-tune: exit {codes}: {text_out[-2000:]}")
    steps = []
    for line in text_out.splitlines():
        if line.startswith("{"):
            msg = json.loads(line)["message"]
            if isinstance(msg, str) and msg.startswith("step "):
                parts = msg.split()
                steps.append({"loss": float(parts[3]), "ms": float(parts[4].strip("("))})
    result = next(line for line in text_out.splitlines() if line.startswith("trained "))
    check(len(steps) == 4 and all(s["loss"] == s["loss"] for s in steps),
          f"transports fine-tune: steps {steps}")
    out["steps"] = steps
    out["merge_s"] = float(result.split("merged in ")[1].split(" s")[0])
    out["write_s"] = float(result.split("written in ")[1].split(" s")[0])
    d = {k: after[k] - before[k] for k in after}
    out["launches"] = {"fwd_sm90": d["fwd_sm90"], "dq_sm90": d["dq_sm90"],
                       "dkv_sm90": d["dkv_sm90"], "fwd_decode": d["fwd_decode"],
                       "mma": (d["fwd"] - d["fwd_sm90"] - d["fwd_decode"]) + (d["dq"] - d["dq_sm90"])
                       + (d["dkv"] - d["dkv_sm90"])}
    check(out["launches"]["fwd_sm90"] > 0 and out["launches"]["dq_sm90"] > 0
          and out["launches"]["dkv_sm90"] > 0 and out["launches"]["mma"] == 0
          and out["launches"]["fwd_decode"] == 0,
          f"transports fine-tune: launches {out['launches']}")
    size = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(merged) for f in fs)
    out["checkpoint_gb"] = round(size / 1e9, 3)
    print(f"transports: CLI fine-tune {' '.join(FINETUNE_ARGV[1:])} (B=4 S=64): loss "
          f"{steps[0]['loss']:.4f} -> "
          f"{steps[-1]['loss']:.4f}, step ms {[s['ms'] for s in steps]}, launches "
          f"{json.dumps(out['launches'])}, merge {out['merge_s']:.2f}s, write "
          f"{out['checkpoint_gb']} GB in {out['write_s']:.2f}s, peak {out['peak_gib']} GiB "
          f"[{card}]", flush=True)
    return out


def _finetune_kernel(torch, flash, gen) -> dict:
    """The three kernels at the fine-tune's attention (B=4 Sq=Skv=64 Hq=32
    Hkv=8 D=128 bf16 causal) against their plain versions: the sm90
    forward, timed beside its bound and SDPA (device times: a short
    kernel), and the sm90 dQ and dK/dV."""
    bf16 = torch.bfloat16
    case = make_case(torch, gen, 4, 64, 64, 32, 8, 128, bf16, [0] * 4, [64] * 4)
    check(flash.fwd_variant(case[0], case[1]) == "sm90", "transports: B=4 S=64 is not sm90")
    _, _, err = compare(torch, flash, "fine-tune B=4 S=64", case)
    row = time_shape(torch, flash, "fine-tune B=4 S=64", case, 200, is_causal=True, device=True)
    e_dq, e_dkv, _, variant = compare_bwd(
        torch, flash, "fine-tune B=4 S=64",
        bwd_case(torch, flash, gen, 4, 64, 64, 32, 8, 128, bf16, [0] * 4, [64] * 4))
    check(variant == "sm90", f"transports: the backward at B=4 S=64 ran {variant}, not sm90")
    return {**row, "max_abs_err": err, "dq_max_abs_err": e_dq, "dkv_max_abs_err": e_dkv}


def transports(torch, flash, card: str, gen) -> dict:
    """Phase 20: GoFr's transports on the card. The port's MiniRedis and
    MiniMySQL in this process; the sample_cmd example as a process; the
    lora_finetune example's CLI fine-tune of llama3-8b in this process;
    then its merged checkpoint behind the http_server example (A, redis and
    mysql wired) and the grpc_server example (B, BATCH_COHORT=off), each
    its own process on the card: equal greedy ids through A's /generate and
    /v1/completions and B's LLMService/Generate, both Hello forms, the
    example routes, health with redis UP then DOWN, each process's kernel
    launches, and TPOT over gRPC beside SSE at 1 and 8 streams."""
    from gofr_tpu_torch.config import DECLARED_KEYS, UNHONORED_KEYS
    from gofr_tpu_torch.datasource.minimysql import MiniMySQL
    from gofr_tpu_torch.datasource.miniredis import MiniRedis
    from gofr_tpu_torch.datasource.redis import new_client
    from gofr_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    out: dict = {"card": card}
    try:
        import google.protobuf  # noqa: F401
        import grpc  # noqa: F401

        missing = None
    except ImportError as exc:
        missing = exc.name
    out["grpc_missing"] = missing
    workdir = tempfile.mkdtemp(prefix="gofr_transports_")
    merged = os.path.join(workdir, "merged")
    here = os.path.dirname(os.path.abspath(__file__))
    base_env = {k: v for k, v in os.environ.items()
                if k not in DECLARED_KEYS and k not in UNHONORED_KEYS}
    # the example processes register CUT_MODEL at start (their sitecustomize)
    with open(os.path.join(workdir, "sitecustomize.py"), "w") as f:
        f.write(CUT_HOOK)
    base_env["PYTHONPATH"] = os.pathsep.join([workdir, here, os.environ.get("PYTHONPATH", "")])
    redis = MiniRedis().run()
    mysql = MiniMySQL(user="gofr", password="phase20")
    seed = new_client("127.0.0.1", redis.port)
    seed.set("test", "phase 20")
    seed.close()
    servers: dict = {}
    try:
        out["cli"] = _sample_cmd(base_env, workdir)
        out["finetune"] = _finetune(torch, flash, card, merged)
        gc.collect()
        torch.cuda.empty_cache()
        out["script_gib_after_finetune"] = round(torch.cuda.memory_allocated() / 2**30, 3)
        check(out["script_gib_after_finetune"] < 1.0,
              f"transports: the trained model still holds {out['script_gib_after_finetune']} GiB")
        out["finetune_kernel"] = _finetune_kernel(torch, flash, gen)
        # no tokenizer: the prompts are id lists, and /v1/completions then
        # answers with its ids (phase 19's id-only deployment)
        serve_env = {**base_env, **{k: v for k, v in PHASE10_ENV.items() if k != "TOKENIZER"},
                     "MODEL_NAME": CUT_MODEL, "MODEL_PATH": merged, "LOG_LEVEL": "ERROR",
                     "TIMEBASE_ENABLED": "off"}
        a_env = {**serve_env, "HTTP_PORT": str(free_port()), "REDIS_HOST": "127.0.0.1",
                 "REDIS_PORT": str(redis.port), "DB_DIALECT": "mysql", "DB_HOST": "127.0.0.1",
                 "DB_PORT": str(mysql.port), "DB_USER": "gofr", "DB_PASSWORD": "phase20",
                 "DB_NAME": "phase20"}
        grpc_port = free_port()
        b_env = {**serve_env, "HTTP_PORT": str(free_port()), "GRPC_PORT": str(grpc_port),
                 "BATCH_COHORT": "off"}
        # one after the other: a boot holds an empty model and the restored
        # state dict at once
        servers["A"] = _example_process("A", "http_server", a_env, workdir)
        out["boot_s"] = {"A": _example_ready(servers["A"])}
        servers["B"] = _example_process("B", "grpc_server" if missing is None else "http_server",
                                        b_env, workdir)
        out["boot_s"]["B"] = _example_ready(servers["B"])
        print(f"transports: A (http_server, cohorts) ready in {out['boot_s']['A']:.1f}s, B "
              f"({'grpc_server' if missing is None else 'http_server'}, BATCH_COHORT=off) in "
              f"{out['boot_s']['B']:.1f}s, from the merged checkpoint", flush=True)
        if missing is not None:
            print(f"transports: {missing} is not installed on this machine: B serves the "
                  f"http_server example instead; the gRPC legs (LLMService/Generate, "
                  f"HelloService both ways, TPOT over gRPC) did not run", flush=True)
        a, b = servers["A"], servers["B"]
        engines0 = {n: get_body(s["address"], "/admin/engine")[1] for n, s in servers.items()}
        tok = Tokenizer.byte_level()
        prompts = [list(tok.encode(text(2000 + i, n))) for i, n in enumerate(TRANSPORT_LENGTHS)]
        # greedy ids: A's /generate, A's /v1/completions, B's gRPC stream
        gen_a = [None] * 3
        threads = [threading.Thread(target=lambda i=i: gen_a.__setitem__(i, post(
            a["port"], {"tokens": prompts[i], "max_new_tokens": TRANSPORT_TOKENS},
            path="/generate"))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        ids_a = []
        for status, data, _, _ in gen_a:
            check(status == 200, f"transports A /generate: {status} {data}")
            ids_a.append(data["data"]["tokens"])
        completions = []
        for p in prompts:
            status, data, _, _ = post(a["port"], {"prompt": p, "max_tokens": TRANSPORT_TOKENS,
                                                  "temperature": 0})
            check(status == 200, f"transports A /v1/completions: {status}")
            completions.append(data["choices"][0]["tokens"])
        check(completions == ids_a, "transports: A's /v1/completions ids are not its /generate's")
        if missing is None:
            ids_b = [r["ids"] for r in _streams(_grpc_generate, grpc_port, prompts)[0]]
        else:
            ids_b = [r["ids"] for r in _streams(_sse_generate, b["port"], prompts)[0]]
        out["ids"] = {"A": ids_a, "B": ids_b, "parted": [
            fleet_divergence(a["address"], p, wa, wb, f"transports ids {i}")
            for i, (p, wa, wb) in enumerate(zip(prompts, ids_a, ids_b))]}
        equal = sum(wa == wb for wa, wb in zip(ids_a, ids_b))
        print(f"transports: greedy ids of 3 prompts ({', '.join(map(str, TRANSPORT_LENGTHS))} "
              f"bytes, {TRANSPORT_TOKENS} tokens): A /generate = A /v1/completions; "
              f"A = B {'(gRPC)' if missing is None else '(SSE)'}: {equal} of 3 equal", flush=True)
        if missing is None:
            out["hello"] = _hello_both_ways(grpc_port)
        out["routes"] = _example_routes(a)
        out["health"] = _health_walk(a, redis, prompts[0])
        engines = {n: get_body(s["address"], "/admin/engine")[1] for n, s in servers.items()}
        out["launches"], out["dispatches"] = {}, {}
        for n in servers:
            k1, k0 = engines[n]["kernel_launches"], engines0[n]["kernel_launches"]
            launches = {"sm90": k1["flash_fwd_sm90"], "decode": k1["flash_fwd_decode"],
                        "mma": k1["flash_fwd"] - k1["flash_fwd_sm90"] - k1["flash_fwd_decode"],
                        "sm90_traffic": k1["flash_fwd_sm90"] - k0["flash_fwd_sm90"],
                        "decode_traffic": k1["flash_fwd_decode"] - k0["flash_fwd_decode"]}
            check(launches["sm90_traffic"] > 0 and launches["decode_traffic"] > 0
                  and launches["mma"] == 0, f"transports {n}: launches {launches}")
            out["launches"][n] = launches
            out["dispatches"][n] = {
                "prefill": engines[n]["dispatches"]["by_kind"].get("prefill", 0)
                - engines0[n]["dispatches"]["by_kind"].get("prefill", 0),
                "by_kind": engines[n]["dispatches"]["by_kind"]}
        print(f"transports: launches a process (boot's warm-up included; the traffic's "
              f"beside) {json.dumps(out['launches'])}; prefill dispatches of the traffic "
              f"A (cohorts) {out['dispatches']['A']['prefill']}, B (FIFO) "
              f"{out['dispatches']['B']['prefill']}", flush=True)
        out["cost"] = _transport_cost(a, b, grpc_port, missing, card)
    finally:
        for s in servers.values():
            _example_stop(s)
        redis.close()
        mysql.close()
        shutil.rmtree(workdir, ignore_errors=True)
    check(not os.path.exists(merged), "transports: the merged checkpoint is still there")
    out["phase_s"] = time.perf_counter() - t0
    print(f"transports-metrics [{card}]: {json.dumps(out)}", flush=True)
    return out


def _hello_both_ways(grpc_port: int) -> dict:
    import grpc

    from gofr_tpu_torch.examples.pb import hello_pb2, hello_pb2_grpc

    with grpc.insecure_channel(f"127.0.0.1:{grpc_port}") as channel:
        stub = hello_pb2_grpc.HelloStub(channel).SayHello(hello_pb2.HelloRequest(name="H100"),
                                                          timeout=30).message
        as_json = json.loads(channel.unary_unary("/HelloService/SayHello")(
            b'{"name": "H100"}', timeout=30))
    check(stub == "Hello H100!" and as_json == {"data": "Hello H100!"},
          f"transports Hello: {stub!r} {as_json}")
    print(f"transports: hello.Hello/SayHello (stub) {stub!r}; HelloService/SayHello (JSON) "
          f"{as_json}", flush=True)
    return {"stub": stub, "json": as_json}


def _example_routes(a: dict) -> dict:
    """The http example's own routes: hello, redis, mysql (SELECT 2+2),
    trace (through get_http_service("anotherService"), this same app)."""
    got = {path: get_body(a["address"], path) for path in ("/hello", "/redis", "/mysql",
                                                            "/trace")}
    want = {"/hello": "Hello World!", "/redis": "phase 20", "/mysql": 4, "/trace": "ok"}
    check(all(got[p] == (200, want[p]) for p in want), f"transports routes: {got}")
    print(f"transports: A's routes {json.dumps({p: v[1] for p, v in got.items()})}", flush=True)
    return {p: v[1] for p, v in got.items()}


def _health_walk(a: dict, redis, prompt: list) -> dict:
    """Health lists redis, sql and the device UP; after the MiniRedis
    stops, redis is DOWN (and so is the whole) while /generate serves."""
    status, body = get_body(a["address"], "/.well-known/health")
    up = {k: v["status"] for k, v in body["details"].items()}
    check(status == 200 and body["status"] == "UP"
          and up == {"redis": "UP", "sql": "UP", "tpu": "UP"}, f"transports health: {body}")
    redis.close()
    t = time.perf_counter()
    while True:
        _, body = get_body(a["address"], "/.well-known/health")
        if body["details"]["redis"]["status"] == "DOWN" or time.perf_counter() - t > 10:
            break
        time.sleep(0.05)
    down_s = time.perf_counter() - t
    after = {k: v["status"] for k, v in body["details"].items()}
    check(body["status"] == "DOWN" and after == {"redis": "DOWN", "sql": "UP", "tpu": "UP"},
          f"transports health after the redis stop: {body}")
    status, data, _, _ = post(a["port"], {"tokens": prompt, "max_new_tokens": 8},
                              path="/generate")
    check(status == 200 and len(data["data"]["tokens"]) > 0,
          f"transports: /generate after the redis stop: {status}")
    print(f"transports: health {up} -> {after} {down_s * 1000:.1f} ms after MiniRedis stopped; "
          f"/generate still 200", flush=True)
    return {"up": up, "down": after, "down_after_ms": down_s * 1000}


def _transport_cost(a: dict, b: dict, grpc_port: int, missing, card: str) -> dict:
    """1 and 8 concurrent streams of TRANSPORT_TOKENS greedy tokens over
    B's gRPC stream beside A's SSE /generate?stream=true, one after the
    other: TPOT and aggregate tokens/s."""
    from gofr_tpu_torch.tokenizer import Tokenizer

    out: dict = {}
    for n in (1, 8):
        ps = [list(Tokenizer.byte_level().encode(text(3000 + 10 * n + i, TRANSPORT_COST_LENGTH)))
              for i in range(n)]
        row = {}
        _, rate, tpot = _streams(_sse_generate, a["port"], ps)
        row["sse"] = {"tokens_per_s": rate, "tpot_ms": tpot}
        if missing is None:
            _, rate, tpot = _streams(_grpc_generate, grpc_port, ps)
            row["grpc"] = {"tokens_per_s": rate, "tpot_ms": tpot}
        out[n] = row
        grpc_part = (f"gRPC {row['grpc']['tokens_per_s']:.2f} tokens/s TPOT "
                     f"{row['grpc']['tpot_ms']:.2f} ms" if missing is None
                     else f"gRPC not run ({missing} missing)")
        print(f"transports: {n} stream(s) of {TRANSPORT_TOKENS}: SSE "
              f"{row['sse']['tokens_per_s']:.2f} tokens/s TPOT {row['sse']['tpot_ms']:.2f} ms; "
              f"{grpc_part} [{card}]", flush=True)
    return out


def kernels_line(errs, shapes, served, train, tiny, dq_errs, dkv_errs, bwd_rows, default,
                 pool_row, openai, deploy, spec, loras, overload_run, fleet_run,
                 transports_run) -> dict:
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
    speculative requests have an entry per instance of their verifies:
    the decode variant's one-row-tile instance at widths 2 and 4 (the
    pool's verifies and the solo sampled ones of k = 4; the numbers of the
    pool's [8, 4] verify), its two-row-tile instance at width 5 (the solo
    verify of k + 1 = 5 and the pool's widest; the numbers of the pool's
    [8, 5] verify, the [8, 8] and solo B=1 rows beside them; the mma
    kernel, which took these widths before, in each row's ``mma_*``),
    device times as at decode; and one for the draft's
    chunks, B=1 decode steps, with the served B=1 decode shape's numbers
    (kv_len 616). Phase 14's (LoRA) launches join the rows of the kernels
    they ran on, each also under ``lora_launches``: the adapter training's
    forward, dQ and dK/dV calls (LoRA and QLoRA, all sm90) and its served
    requests' prefill (sm90) and pooled decode (the decode variant). Phase
    18's (overload and failure) launches join the sm90 row (its prefills and
    the resume's re-prefill) and the pool row (its pooled decode), each also
    under ``overload_launches``. Phase 19's (the fleet) launches, read off
    the two replica processes' ``/admin/engine`` counters over its pull leg
    (the donors' and the local runs' prefills, both replicas' pooled
    decode), join the same rows under ``fleet_launches``. Phase 20's (GoFr's
    transports): the CLI fine-tune's dQ and dK/dV calls (read in this
    process) and the two example servers' prefill and pooled decode (each
    process's ``/admin/engine`` counters from its start, the boot's warm-up
    included) join the rows under ``transports_launches``; the fine-tune's
    forward calls stand on the entry of its own shape alone, and its dQ and
    dK/dV errors at that shape join those rows' ``max_abs_err``."""
    over = overload_run["launches"]
    fleet_l = fleet_run["pull"]["launches"]
    ft = transports_run["finetune"]["launches"]
    served_l = transports_run["launches"]
    tr_sm90 = {n: v["sm90"] for n, v in served_l.items()}
    ft_errs = transports_run["finetune_kernel"]
    tr_decode = {n: v["decode"] for n, v in served_l.items()}
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
         + over["sm90"] + fleet_l["sm90"] + sum(tr_sm90.values()),
         "serve_launches": served["sm90"], "training_launches": sm90_train,
         "overload_launches": over["sm90"], "fleet_launches": fleet_l["sm90"],
         "transports_launches": tr_sm90,
         "lora_launches": {"train": lora_train["fwd_sm90"], "served": lora_served["sm90"]},
         "max_abs_err": max(errs["sm90"]), **shapes["training_forward"],
         "by_shape": {k: v for k, v in shapes.items() if v["variant"] == "sm90"}},
        {"name": "flash_fwd_sm90 (fine-tune, B=4 S=64, phase 20)", **fwd,
         "launches": ft["fwd_sm90"], **device_row(transports_run["finetune_kernel"])},
        {"name": "flash_fwd_decode", **fwd, "launches": served["decode"] + lora_served["decode"],
         "lora_launches": {"served": lora_served["decode"]},
         "max_abs_err": max(errs["decode"]), **decode_row,
         "by_shape": {k: v for k, v in shapes.items() if v["variant"] == "decode"}},
        {"name": "flash_fwd_decode (pool, 8 slots)", **fwd,
         "launches": default["decode"] + over["decode"] + fleet_l["decode"]
         + sum(tr_decode.values()),
         "overload_launches": over["decode"], "fleet_launches": fleet_l["decode"],
         "transports_launches": tr_decode,
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
        {"name": "flash_fwd_decode_r2 (verify, widths 5-8, phase 13)", **fwd,
         "launches": spec["launches"]["verify_decode_r2"],
         "pool_width_5_launches": spec["launches"]["pool_width_5"],
         "mma_launches": spec["launches"]["verify_mma"],
         "max_abs_err": spec["max_abs_err"]["decode"],
         "mma_max_abs_err": spec["max_abs_err"]["mma"],
         **device_row(spec["kernel_rows"]["verify B=8 Sq=5"]),
         "width_8": device_row(spec["kernel_rows"]["verify B=8 Sq=8"]),
         "solo_B1": device_row(spec["kernel_rows"]["verify B=1 Sq=5 kv_len 1800"])},
        {"name": "flash_fwd_decode (draft steps, phase 13)", **fwd,
         "launches": spec["launches"]["draft"], "max_abs_err": max(errs["decode"]),
         **device_row(shapes["served_decode"])},
        {"name": "flash_fwd_mma", **fwd, "launches": tiny, "path": "tiny f32 model (phases 4, 8)",
         "max_abs_err": max(errs["mma"] + [spec["max_abs_err"]["mma"]]),
         "verify_max_abs_err": spec["max_abs_err"]["mma"], **shapes["prefill_f32"]},
        {"name": "flash_bwd_dq", **bwd, "replaces": "gofr_tpu/ops/flash.py:477",
         "launches": train["launches"][4] + lora_train["dq_sm90"] + ft["dq_sm90"],
         "lora_launches": {"train": lora_train["dq_sm90"]},
         "transports_launches": {"finetune": ft["dq_sm90"]},
         "max_abs_err": max(dq_errs["sm90"] + [ft_errs["dq_max_abs_err"]]),
         "transports_max_abs_err": ft_errs["dq_max_abs_err"],
         "mma_max_abs_err": max(dq_errs["mma"]),
         "shape": "B=1 S=2048 Hq=32 Hkv=8 D=128 bf16 causal", **bwd_rows["dq"]},
        {"name": "flash_bwd_dkv", **bwd, "replaces": "gofr_tpu/ops/flash.py:521",
         "launches": train["launches"][5] + lora_train["dkv_sm90"] + ft["dkv_sm90"],
         "lora_launches": {"train": lora_train["dkv_sm90"]},
         "transports_launches": {"finetune": ft["dkv_sm90"]},
         "max_abs_err": max(dkv_errs["sm90"] + [ft_errs["dkv_max_abs_err"]]),
         "transports_max_abs_err": ft_errs["dkv_max_abs_err"],
         "mma_max_abs_err": max(dkv_errs["mma"]),
         "shape": "B=1 S=2048 Hq=32 Hkv=8 D=128 bf16 causal", **bwd_rows["dkv"]},
    ]}


def mesh_entries(entries: list, mesh: dict) -> None:
    """Phase 21 in the kernels line: each entry's ``mesh_launches`` (the
    phase's sm90 launches on the sm90 entry, its direct decode steps' on
    the decode entry, its served pool decode on the pool's; 0 elsewhere),
    and the two tp shard rows, whose ``launches`` are the phase's: the sm90 forward
    at the shard's prefill (B = 2, bucket 512, Hq = 16, Hkv = 4) and the
    decode variant at the shard's pool decode (B = 8), device times as
    ``ms`` and ``library_ms``."""
    direct, served_l = mesh["direct"]["launches"], mesh["served"]["launches"]
    counts = {"flash_fwd_sm90": direct["sm90"] + served_l["sm90"],
              "flash_fwd_decode": direct["decode"],
              "flash_fwd_decode (pool, 8 slots)": served_l["decode"]}
    for entry in entries:
        entry["mesh_launches"] = counts.get(entry["name"], 0)
    decode = direct["decode"] + served_l["decode"]
    fwd = {"route": "cuda", "source": "gofr_tpu_torch/csrc/flash_fwd.cu",
           "replaces": "gofr_tpu/ops/flash.py:224"}
    rows = mesh["kernel_rows"]
    entries.insert(-2, {
        "name": "flash_fwd_sm90 (tp shard prefill, B=2 bucket 512 Hq=16 Hkv=4, phase 21)",
        **fwd, "launches": counts["flash_fwd_sm90"], "mesh_launches": counts["flash_fwd_sm90"],
        "direct_launches": direct["sm90"], "served_launches": served_l["sm90"],
        "max_abs_err": mesh["max_abs_err"]["sm90"], **rows["tp shard prefill B=2 Sq=512"]})
    entries.insert(-2, {
        "name": "flash_fwd_decode (tp shard pool decode, B=8 Hq=16 Hkv=4, phase 21)",
        **fwd, "launches": decode, "mesh_launches": decode,
        "direct_launches": direct["decode"], "served_launches": served_l["decode"],
        "max_abs_err": mesh["max_abs_err"]["decode"], **rows["tp shard pool decode B=8"]})


def mesh_train_entries(entries: list, run: dict) -> None:
    """Phase 22 in the kernels line: the pipeline's launches (two stages,
    each microbatch at phase 9's training shape) join the sm90 forward, dQ
    and dK/dV entries, each also under ``mesh_train_launches`` (0
    elsewhere); then the forward, dQ and dK/dV at each leg's own shape with
    that leg's launches: the tp shard's training call ((a), two steps), the
    ring's pairs ((b), one counted loss and its gradients; the numbers of
    its off-diagonal non-causal pair, the backward at the global LSE) and
    Ulysses' head groups ((c), the same)."""
    pipe = run["pipeline"]["launches"]
    counts = {"flash_fwd_sm90": pipe[0], "flash_bwd_dq": pipe[1], "flash_bwd_dkv": pipe[2]}
    for entry in entries:
        entry["mesh_train_launches"] = counts.get(entry["name"], 0)
        entry["launches"] += entry["mesh_train_launches"]
    kinds = (("fwd", "flash_fwd_sm90", "gofr_tpu_torch/csrc/flash_fwd.cu", "flash.py:224", 0),
             ("dq", "flash_bwd_dq", "gofr_tpu_torch/csrc/flash_bwd.cu", "flash.py:477", 1),
             ("dkv", "flash_bwd_dkv", "gofr_tpu_torch/csrc/flash_bwd.cu", "flash.py:521", 2))
    legs = (("tp shard", "tp shard training, B=1 S=2048 Hq=16 Hkv=4", run["tp"]["launches"]),
            ("ring", "ring pairs, B=1 Sq=Skv=2048 Hq=32 Hkv=8; row: the off-diagonal "
             "non-causal pair, its backward at the global LSE", run["ring"]["launches"]),
            ("ulysses", f"Ulysses head groups, B=1 S={SP_SEQ} Hq=16 Hkv=4",
             run["ulysses"]["launches"]))
    for key, label, launches in legs:
        for kind, name, source, replaces, j in kinds:
            entries.append({"name": f"{name} ({label}, phase 22)", "route": "cuda",
                            "source": source, "replaces": f"gofr_tpu/ops/{replaces}",
                            "launches": launches[j], "mesh_train_launches": launches[j],
                            **run["kernel_rows"][key][kind]})


def moe_entries(entries: list, run: dict) -> None:
    """Phase 23 in the kernels line: the ep shards' forward, dQ and dK/dV
    launches (B=1 S=2048, phase 9's training shape) join the sm90 entries,
    each also under ``moe_launches`` (0 elsewhere); then the three kernels
    at the dense MoE model's shape (B=2 S=2048) with the dense legs'
    launches and the phase's own rows (device times as ``ms``)."""
    shard, dense = run["launches"]["shard"], run["launches"]["dense"]
    counts = {"flash_fwd_sm90": shard[0], "flash_bwd_dq": shard[1], "flash_bwd_dkv": shard[2]}
    for entry in entries:
        entry["moe_launches"] = counts.get(entry["name"], 0)
        entry["launches"] += entry["moe_launches"]
    for kind, name, source, replaces, j in (
            ("fwd", "flash_fwd_sm90", "gofr_tpu_torch/csrc/flash_fwd.cu", "flash.py:224", 0),
            ("dq", "flash_bwd_dq", "gofr_tpu_torch/csrc/flash_bwd.cu", "flash.py:477", 1),
            ("dkv", "flash_bwd_dkv", "gofr_tpu_torch/csrc/flash_bwd.cu", "flash.py:521", 2)):
        entries.append({"name": f"{name} (MoE dense, B=2 S=2048 Hq=32 Hkv=8, phase 23)",
                        "route": "cuda", "source": source, "replaces": f"gofr_tpu/ops/{replaces}",
                        "launches": dense[j], "moe_launches": dense[j],
                        **run["kernel_rows"][kind]})


def encoder_entry(errs: dict, rows: dict, served: dict) -> dict:
    """The sm90 forward's D = 64 instance at bert-base's attention (phase
    15's path): its launches from phase 15's served requests, its numbers
    from phase 3's B = 8 row (device times as ``ms`` and ``library_ms``;
    the mma kernel, its predecessor there, as ``mma_*``, with its error at
    the encoder's cases), the other encoder shapes beside them."""
    return {"name": "flash_fwd_sm90_d64 (encoder, bert-base, phase 15)", "route": "cuda",
            "source": "gofr_tpu_torch/csrc/flash_fwd.cu", "replaces": "gofr_tpu/ops/flash.py:224",
            "launches": served["launches"], "launches_per_dispatch": served["per_dispatch"],
            "max_abs_err": max(errs["sm90"]), "mma_max_abs_err": max(errs["mma"]),
            **device_row(rows["encoder_B8"]),
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


@contextlib.contextmanager
def timed(label: str):
    """``phase <label>: <seconds> s`` once the block ends (or fails)."""
    t = time.perf_counter()
    try:
        yield
    finally:
        print(f"phase {label}: {time.perf_counter() - t:.1f} s", flush=True)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeat-serve-train", type=int, default=0, metavar="N",
                        help="repeat phase 10 -> the pool decode kernel -> phase 9 N times "
                             "under CUDA_LAUNCH_BLOCKING=1 and the debug build, nothing else")
    parser.add_argument("--mesh-cards", action="store_true",
                        help="phase 21's legs over distinct cards (two or more): phases 5 and "
                             "10, tp=2 and tp=<cards> direct, TPU_MESH=tp=<cards> served; "
                             "nothing else")
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
    if args.mesh_cards:
        print_build(flash, built)
        return mesh_cards(torch, flash, card)
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
    with timed("2-3"):
        errs, shapes = forward_phases(torch, flash, gen)
        encoder_errs, encoder_rows = encoder_kernels(torch, flash, gen)
        errs["mma"] += encoder_errs["mma"]
        torch.cuda.empty_cache()
    with timed("4"):
        tiny = f32_path(torch, flash)
    with timed("5"):
        served, model = serve(torch, flash, card)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("10"):
        default = serve_default(torch, flash, card, model)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("10b"):
        sanitized = sanitized_server(torch, card, default)
    with timed("21"):
        mesh = serving_mesh(torch, flash, card, model, default, gen)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("11"):
        openai = serve_openai(torch, flash, card, model)
        gc.collect()
        torch.cuda.empty_cache()
    # phase 12 writes phase 5's weights here; phase 13 drafts from them and
    # phase 19's replicas boot from them (deleted after phase 19, or at exit)
    ckpt = tempfile.mkdtemp(prefix="gofr_ckpt_")
    atexit.register(shutil.rmtree, ckpt, True)
    with timed("12"):
        deploy = deployment(torch, flash, card, model, ckpt)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("13"):
        spec = speculation(torch, flash, card, model, ckpt, gen)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("14"):
        loras = multi_lora(torch, flash, card, model)
        gc.collect()
        torch.cuda.empty_cache()
    print_cost_fits(card)  # phases 12-14 and 21's paths, each fitted from its own records
    with timed("16"):
        host_services(torch, flash, card, model)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("17"), host_pauses("phase 17") as no_request_in_flight:
        observability(torch, flash, card, model, no_request_in_flight)
    gc.collect()
    torch.cuda.empty_cache()
    with timed("18"), host_pauses("phase 18"):
        overload_run = overload(torch, flash, card, model, ckpt)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve: shut down, memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    pool_row = pool_decode_kernel(torch, flash, gen)

    with timed("6-8"):
        dq_errs, dkv_errs, bwd_rows, shapes["training_forward"] = backward_phases(torch, flash,
                                                                                  gen)
        torch.cuda.empty_cache()
        tiny += f32_training(torch, flash)[0]
    with timed("9"):
        train = train_llama(torch, flash, card)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("22"):
        mesh_train = mesh_training(torch, flash, card, train, gen)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("23"):
        moe_run = moe_multihost_phase(torch, flash, card, gen)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("15"):
        encoders = encoder_serving(torch, flash, card)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("19"):
        try:
            fleet_run = fleet(torch, flash, card, ckpt, gen)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        check(not os.path.exists(ckpt), "fleet: the checkpoint directory is still there")
        gc.collect()
        torch.cuda.empty_cache()
    with timed("20"):
        transports_run = transports(torch, flash, card, gen)

    kernels = kernels_line(errs, shapes, served, train, tiny, dq_errs, dkv_errs, bwd_rows,
                           default, pool_row, openai, deploy, spec, loras, overload_run,
                           fleet_run, transports_run)
    kernels["kernels"].insert(-2, encoder_entry(encoder_errs, encoder_rows, encoders))
    mesh_entries(kernels["kernels"], mesh)
    mesh_train_entries(kernels["kernels"], mesh_train)
    moe_entries(kernels["kernels"], moe_run)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)  # name, power limit as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
