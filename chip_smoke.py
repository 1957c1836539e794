#!/usr/bin/env python3
"""Drive gofr_tpu_torch on one NVIDIA GPU end to end.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure (no phase is skipped or caught):

1. build: compile every ``gofr_tpu_torch/csrc/*.cu`` (the flash forward and
   the backward's dQ and dK/dV kernels) with nvcc for sm_90a, in parallel;
2. kernel vs plain: the flash kernel against ``flash_attention_ref`` at
   llama3-8b head shapes (bf16, Hq=32, Hkv=8, D=128: ragged causal prefill
   with a poisoned cache tail, decode over a 2048-slot cache, a kv_lens=0
   row; and the serving run's own calls: batch-4 prefill at buckets 128 and
   1024 and batch-1 decode, K/V one layer of a [L, B, 2048, 8, 128] cache
   poisoned past kv_len) and at the tiny model's f32 D=16, tolerances as in
   tests/test_flash.py (bf16 2e-2, f32 2e-5, atol + rtol*|ref|);
3. kernel times at the prefill and decode shapes: the kernel, its bound on
   the card, the plain version, and scaled_dot_product_attention as a
   yardstick (never called by the port);
4. f32 path: the tiny f32 model, built on the card from a seed, greedy-
   decodes 16 tokens through the kernel; the same weights on the CPU
   (plain path) must give the same ids;
5. serve: ``new()`` with MODEL_NAME=llama3-8b (full width and depth, bf16,
   random weights from MODEL_SEED), four /v1/completions requests (two
   concurrent prompts in two buckets, one streamed, one sampled), the
   launch count of the kernel over that run, TTFT and decode tokens/s;
6. backward kernels vs plain: the dQ and dK/dV kernels against
   ``flash_attention_bwd_ref`` at the training shape (B=1, S=2048, Hq=32,
   Hkv=8, D=128, bf16, causal), a ragged GQA case with a poisoned cache
   tail whose dK/dV rows must be exactly 0, a kv_lens=0 row (all grads
   exactly 0), a non-causal case and f32 D=16 at the tiny model's shapes
   (bf16 2e-2 + 2e-2*|ref|, f32 1e-4 + 2e-5*|ref|, as tests/test_flash.py's
   gradient tests);
7. backward kernel times at the training shape: each kernel, its bound,
   the plain backward, and the backward of scaled_dot_product_attention
   (forward + backward minus forward) as a yardstick; the forward kernel at
   the same shape;
8. f32 training parity: the tiny f32 model, built on the card from a seed,
   takes 3 ``make_train_step`` steps through the kernels; a CPU copy with
   the same weights takes them through the plain versions; the losses
   agree and every layer of every step launched all three kernels;
9. train llama3-8b: full width and depth, bf16, random weights from a
   seed, AdamW, remat, batch 1 of 2049-token crops (the model sees 2048)
   from a TokenDataset over a uint32 corpus made with numpy, 4 steps on one
   batch through ``prefetch_to_device``: finite and falling loss, every
   layer's attention through the kernels in every step, step time,
   tokens/s, MFU and peak memory.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA
device or without the gofr_tpu_torch package beside it.
"""

from __future__ import annotations

import gc
import http.client
import json
import os
import socket
import subprocess
import sys
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


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2/3: the kernel against its plain version ------------------------

def make_case(torch, gen, b, sq, skv, hq, hkv, d, dtype, offsets, kv_lens, poison=False):
    dev = "cuda"
    q = torch.randn(b, sq, hq, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, skv, hkv, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, skv, hkv, d, device=dev, generator=gen).to(dtype)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    if poison:
        # finite garbage in the unwritten tail: must not move the output
        tail = torch.arange(skv, device=dev)[None, :] >= lens[:, None]
        k = k.masked_fill(tail[:, :, None, None], 300.0)
        v = v.masked_fill(tail[:, :, None, None], -300.0)
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
    return q, k, v, offs, lens


def served_case(torch, gen, b, sq, offset, kv_len, max_seq=2048, layers=2):
    """A call as the serving path makes it: q [B, Sq, 32, 128] bf16, K/V
    the last layer of a [layers, B, max_seq, 8, 128] cache (the runner's
    layout, so the slice starts mid-allocation), every row at the same
    offset and kv_len, finite garbage past kv_len."""
    dev, bf16 = "cuda", torch.bfloat16
    q = torch.randn(b, sq, 32, 128, device=dev, generator=gen).to(bf16)
    shape = (layers, b, max_seq, 8, 128)
    k_cache = torch.randn(shape, device=dev, generator=gen).to(bf16)
    v_cache = torch.randn(shape, device=dev, generator=gen).to(bf16)
    k_cache[:, :, kv_len:] = 300.0
    v_cache[:, :, kv_len:] = -300.0
    offs = torch.full((b,), offset, dtype=torch.int32, device=dev)
    lens = torch.full((b,), kv_len, dtype=torch.int32, device=dev)
    return q, k_cache[-1], v_cache[-1], offs, lens


def check_tail_invisible(torch, flash, name, case, out):
    """The kernel's output is bit-identical with the tail past kv_len zeroed."""
    q, k, v, offs, lens = case
    clean = (torch.arange(k.shape[1], device="cuda")[None, :] < lens[:, None])[:, :, None, None]
    out2, _ = flash.flash_attention_fwd(q, k * clean, v * clean, True, offs, lens)
    check(torch.equal(out, out2), f"{name}: the poisoned tail moved the kernel's output")


def compare(torch, flash, name, case, causal=True):
    q, k, v, offs, lens = case
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    torch.cuda.synchronize()
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
    print(f"kernel-vs-plain {name}: max|out err| {e_out:.3e} max|lse err| {e_lse:.3e} "
          f"tol {tol} (atol + rtol*|ref|) -> {'ok' if ok_out and ok_lse else 'FAIL'}", flush=True)
    check(ok_out and ok_lse, f"{name}: kernel disagrees with its plain version")
    return out, lse, max(e_out, e_lse)


def bound(q, k, offsets, kv_lens, causal):
    """Least time for the call on the card: bytes each input read once and
    each output written once (K/V only up to kv_len, what this data needs)
    over HBM rate, and the operations of the visible (query, key) pairs
    over the peak rate of the inputs' type. Returns (ms, 'bytes'|'operations')."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    es = q.element_size()
    lens = [int(x) for x in kv_lens.tolist()]
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


def library_call(torch, q, k, v, offsets, kv_lens):
    """scaled_dot_product_attention over the same inputs and masking."""
    import torch.nn.functional as F

    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    k_pos = torch.arange(skv, device=q.device)
    q_pos = offsets[:, None] + torch.arange(sq, device=q.device)[None, :]
    mask = (k_pos[None, None, :] < kv_lens[:, None, None]) & (k_pos[None, None, :] <= q_pos[:, :, None])
    mask = mask[:, None]  # [B, 1, Sq, Skv]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def time_shape(torch, flash, name, case, iters):
    q, k, v, offs, lens = case
    ms = time_ms(torch, lambda: flash.flash_attention_fwd(q, k, v, True, offs, lens), iters)
    plain_ms = time_ms(torch, lambda: flash.flash_attention_ref(q, k, v, True, offs, lens), iters)
    library_ms = time_ms(torch, library_call(torch, q, k, v, offs, lens), iters)
    bound_ms, bound_by = bound(q, k, offs, lens, True)
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    print(f"kernel-time {name} {tuple(q.shape)} kv {tuple(k.shape)}: {json.dumps(row)}", flush=True)
    return row


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
        rest, _ = m.decode_chunk(first, cache, 15)
        return [int(first[0, 0])] + [int(t) for t in rest[0].tolist()]

    before = flash.launches.value
    on_card = greedy(model)
    launched = flash.launches.value - before
    on_cpu = greedy(plain)
    print(f"f32-path tiny greedy: card {on_card} cpu {on_cpu} kernel launches {launched}", flush=True)
    check(on_card == on_cpu, "f32 path: kernel greedy ids differ from the plain path")
    check(launched >= TINY.n_layers * 16, f"f32 path: only {launched} kernel launches")


# -- phase 5: serve llama3-8b --------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post(port: int, body: dict, stream: bool = False):
    """-> (status, response json or SSE frames, seconds to first frame, [frame times])."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/completions", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
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
            if frame.startswith(b"data: "):
                frames.append(frame[6:].decode())
                times.append(time.perf_counter() - t0)
    conn.close()
    return resp.status, frames, times[0] if times else None, times


def serve(torch, flash, card: str):
    os.environ.update({
        "MODEL_NAME": "llama3-8b", "MODEL_MAX_SEQ": "2048", "BATCH_MAX_SIZE": "4",
        "BATCH_TIMEOUT_MS": "50", "TOKENIZER": "byte", "MODEL_SEED": "0",
        "DECODE_CHUNK": "8", "TORCH_DEVICE": "cuda", "HTTP_PORT": str(free_port()),
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
        flash.launches.reset()
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
        # every prefill dispatch and every decode step runs each layer's
        # attention through the kernel
        steps = sum(len(ids) - 1 for _, ids in generations)
        need = n_layers * (dispatches + steps)
        print(f"serve: kernel launches {launches} >= n_layers x (prefill dispatches "
              f"{dispatches} + decode steps {steps}) = {need}", flush=True)
        check(launches >= need, "serve: the kernel was not launched on every layer")
        decode_tps = (n_stream - 1) / (times[n_stream - 1] - ttft) if n_stream > 1 else 0.0
        print(f"serve-metrics [{card}]: stream TTFT {ttft * 1e3:.1f} ms, decode "
              f"{decode_tps:.1f} tokens/s (batch 1), concurrent pair {pair_s:.3f}s", flush=True)
        return launches
    finally:
        app.shutdown()


# -- phase 6/7: the backward kernels ----------------------------------------------

def bwd_case(torch, flash, gen, b, sq, skv, hq, hkv, d, dtype, offsets, kv_lens, causal=True):
    """Inputs of one backward call: q, k, v (poisoned past kv_len), dO, and
    the forward kernel's out and lse."""
    q, k, v, offs, lens = make_case(torch, gen, b, sq, skv, hq, hkv, d, dtype, offsets, kv_lens,
                                    poison=True)
    do = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    return {"q": q, "k": k, "v": v, "offs": offs, "lens": lens, "out": out, "lse": lse,
            "do": do, "causal": causal}


def compare_bwd(torch, flash, name, c):
    """Both backward kernels against their plain version. -> (max |dq err|,
    max |dk, dv err|, (dq, dk, dv))."""
    scale = c["q"].shape[-1] ** -0.5
    args = (c["q"], c["k"], c["v"], c["offs"], c["lens"], c["out"], c["lse"], c["do"],
            c["causal"], scale)
    got = flash._launch_bwd(*args)
    torch.cuda.synchronize()
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
    print(f"bwd-kernel-vs-plain {name}: max|err| dq {errs[0]:.3e} dk {errs[1]:.3e} "
          f"dv {errs[2]:.3e} tol {atol} + {rtol}*|ref|, dK/dV past kv_len exactly 0: "
          f"{tail_zero} -> {'ok' if ok and tail_zero else 'FAIL'}", flush=True)
    check(ok, f"{name}: backward kernels disagree with their plain version")
    check(tail_zero, f"{name}: dK/dV rows past kv_len are not exactly 0")
    return errs[0], max(errs[1:]), got


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

    qt, kt, vt = (c[n].transpose(1, 2).detach().requires_grad_() for n in ("q", "k", "v"))
    g = c["do"].transpose(1, 2)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (qt, kt, vt), g)

    return time_ms(torch, fwd_bwd, iters) - time_ms(torch, fwd, iters)


def time_bwd(torch, flash, c, iters):
    """Phase 7 at the training shape: per kernel ms, bound, plain ms (the
    whole plain backward) and SDPA's backward; the forward kernel too."""
    scale = c["q"].shape[-1] ** -0.5
    do = c["do"].contiguous()
    dvec = (do.float() * c["out"].float()).sum(-1).transpose(1, 2).contiguous()
    kargs = (c["q"], c["k"], c["v"], do, c["lse"], dvec, c["offs"], c["lens"], c["causal"], scale)
    dq_ms = time_ms(torch, lambda: flash.launch_dq(*kargs), iters)
    dkv_ms = time_ms(torch, lambda: flash.launch_dkv(*kargs), iters)
    plain_ms = time_ms(torch, lambda: flash.flash_attention_bwd_ref(
        c["q"], c["k"], c["v"], c["offs"], c["lens"], c["out"], c["lse"], c["do"], c["causal"],
        scale), 3)
    library_ms = sdpa_backward_ms(torch, c, iters)
    rows = {}
    for name, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
        bound_ms, bound_by = bwd_bound(c, name)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
        print(f"bwd-kernel-time {name} training shape {tuple(c['q'].shape)}: "
              f"{json.dumps(rows[name])}", flush=True)
    fwd = time_shape(torch, flash, "training forward", (c["q"], c["k"], c["v"], c["offs"],
                                                         c["lens"]), iters)
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
    for i in range(3):
        tokens = rng.integers(0, TINY.vocab_size, (2, 33)).astype("int32")
        for c in (flash.launches, flash.launches_dq, flash.launches_dkv):
            c.reset()
        card, m_card = step_card(card, tokens)
        loss_card = float(m_card["loss"])
        counts = [c.value for c in (flash.launches, flash.launches_dq, flash.launches_dkv)]
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
    losses, norms, times, totals = [], [], [], [0, 0, 0]
    for i, tokens in enumerate(prefetch_to_device(iter([batch] * steps), size=2, device="cuda")):
        counters = (flash.launches, flash.launches_dq, flash.launches_dkv)
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
              f"{times[-1] * 1e3:.1f} ms, launches fwd/dq/dkv {counts}", flush=True)
        check(counts[1] >= cfg.n_layers and counts[2] >= cfg.n_layers and
              counts[0] >= 2 * cfg.n_layers, "train: a layer's attention missed a kernel")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from gofr_tpu_torch.ops import flash  # fails outside a checkout

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}", flush=True)

    t0 = time.perf_counter()
    built = flash.build()
    print(f"build: {built.path.name} in {time.perf_counter() - t0:.1f}s", flush=True)
    for line in built.log.splitlines():
        if "Used" in line and "registers" in line:
            print(f"  ptxas: {line.split(':', 1)[-1].strip()}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    prefill = make_case(torch, gen, 2, 512, 1024, 32, 8, 128, bf16, [0, 300], [512, 812], poison=True)
    decode = make_case(torch, gen, 4, 1, 2048, 32, 8, 128, bf16, [0, 699, 1499, 2047], [1, 700, 1500, 2048])
    empty = make_case(torch, gen, 2, 1, 2048, 32, 8, 128, bf16, [0, 899], [0, 900])
    tiny = make_case(torch, gen, 2, 40, 128, 4, 2, 16, f32, [0, 20], [40, 60])
    # run_batch pads the batch to 4 rows and runs the whole bucket against
    # the fresh 2048-slot cache; solo decode runs one row
    served = {
        "served prefill bf16 B=4 bucket 1024": served_case(torch, gen, 4, 1024, 0, 1024),
        "served prefill bf16 B=4 bucket 128": served_case(torch, gen, 4, 128, 0, 128),
        "served decode bf16 B=1 kv_len 616": served_case(torch, gen, 1, 1, 615, 616),
    }
    errs = []
    out, _, e = compare(torch, flash, "prefill bf16 B=2 Sq=512 ragged poisoned", prefill)
    errs.append(e)
    check_tail_invisible(torch, flash, "prefill", prefill, out)
    for name, case in served.items():
        out, _, e = compare(torch, flash, name, case)
        errs.append(e)
        check_tail_invisible(torch, flash, name, case, out)
    errs.append(compare(torch, flash, "decode bf16 B=4 cache 2048", decode)[2])
    out, lse, e = compare(torch, flash, "decode bf16 kv_lens=0 row", empty)
    check(bool((out[0] == 0).all()) and bool(torch.isinf(lse[0]).all()), "kv_lens=0 row not zero/+inf")
    errs.append(e)
    errs.append(compare(torch, flash, "prefill f32 D=16", tiny)[2])

    shapes = {
        "served_prefill_1024": time_shape(
            torch, flash, "served prefill bucket 1024", served["served prefill bf16 B=4 bucket 1024"], 20),
        "served_prefill_128": time_shape(
            torch, flash, "served prefill bucket 128", served["served prefill bf16 B=4 bucket 128"], 50),
        "served_decode": time_shape(
            torch, flash, "served decode", served["served decode bf16 B=1 kv_len 616"], 50),
        "prefill": time_shape(torch, flash, "prefill", prefill, 20),
        "decode": time_shape(torch, flash, "decode", decode, 50),
    }
    del served, prefill, decode, empty, tiny
    torch.cuda.empty_cache()
    f32_path(torch, flash)
    launches = serve(torch, flash, card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve: shut down, memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    train_case = bwd_case(torch, flash, gen, 1, 2048, 2048, 32, 8, 128, bf16, [0], [2048])
    bwd_cases = {
        "training shape bf16 B=1 S=2048 causal": train_case,
        "ragged GQA bf16 B=2 Sq=300 Skv=1024 poisoned": bwd_case(
            torch, flash, gen, 2, 300, 1024, 32, 8, 128, bf16, [0, 500], [300, 800]),
        "bf16 kv_lens=0 row": bwd_case(torch, flash, gen, 2, 64, 128, 32, 8, 128, bf16,
                                       [0, 64], [0, 128]),
        "non-causal bf16 B=1 S=512": bwd_case(torch, flash, gen, 1, 512, 512, 32, 8, 128, bf16,
                                              [0], [512], causal=False),
        "f32 D=16 tiny shapes": bwd_case(torch, flash, gen, 2, 40, 128, 4, 2, 16, f32,
                                         [0, 20], [40, 60]),
    }
    dq_errs, dkv_errs = [], []
    for name, c in bwd_cases.items():
        e_dq, e_dkv, grads = compare_bwd(torch, flash, name, c)
        dq_errs.append(e_dq)
        dkv_errs.append(e_dkv)
        if "kv_lens=0" in name:
            check(all(bool((g[0] == 0).all()) for g in grads), "kv_lens=0 row: grads not exactly 0")
    bwd_rows, shapes["training_forward"] = time_bwd(torch, flash, train_case, 20)
    del bwd_cases, train_case
    torch.cuda.empty_cache()
    f32_training(torch, flash)
    train = train_llama(torch, flash, card)

    kernels = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "gofr_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "gofr_tpu/ops/flash.py:224",
        "launches": launches,
        "training_launches": train["launches"][0],
        "max_abs_err": max(errs),
        **shapes["served_prefill_1024"],
        "by_shape": shapes,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "gofr_tpu_torch/csrc/flash_bwd.cu",
        "replaces": replaces,
        "launches": train["launches"][i],
        "max_abs_err": max(e),
        "shape": "B=1 S=2048 Hq=32 Hkv=8 D=128 bf16 causal",
        **bwd_rows[key],
    } for name, replaces, i, e, key in (
        ("flash_bwd_dq", "gofr_tpu/ops/flash.py:477", 1, dq_errs, "dq"),
        ("flash_bwd_dkv", "gofr_tpu/ops/flash.py:521", 2, dkv_errs, "dkv"),
    )]}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)  # name, power limit as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
