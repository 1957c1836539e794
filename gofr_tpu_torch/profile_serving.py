"""Where the serving time goes on the card: llama3-8b (full width and
depth, bf16, random weights from a seed) prefill and decode through the
port's runner, and pooled decode through the ``DecodePool`` (8 slots,
chunks of 8 steps) with 1, 4 and 8 active slots, under ``torch.profiler``.

    python3 -m gofr_tpu_torch.profile_serving

For each phase it prints one JSON line: the host wall time (ending in a
device synchronize), the device busy time (the sum of CUDA kernel
durations; one stream, so kernels do not overlap), the device's idle
share of the wall time, kernel launches, the flash forward's device time
and the kernels that took the most device time; a pooled phase also
gives its chunks, launches a chunk, the flash forward's share of busy
time and the decoded tokens a second of wall time. Solo decode phases run
16 steps, pooled ones 64 tokens a slot; weights and prompts come from
seed 0. Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

STEPS = 16
SEED = 0
POOL_SLOTS = 8
POOL_TOKENS = 64


def _kernel_table(prof) -> tuple[float, int, float, list]:
    from torch.autograd import DeviceType

    per_name: dict = defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        dur_ms = (evt.time_range.end - evt.time_range.start) / 1e3
        per_name[evt.name][0] += 1
        per_name[evt.name][1] += dur_ms
    busy = sum(v[1] for v in per_name.values())
    launches = sum(v[0] for v in per_name.values())
    flash_ms = sum(ms for name, (_, ms) in per_name.items() if "flash_fwd" in name)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]
    return busy, launches, flash_ms, [
        {"kernel": name[:90], "count": n, "ms": ms} for name, (n, ms) in top
    ]


def _profiled(label: str, fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    busy, launches, flash_ms, top = _kernel_table(prof)
    row = {
        "phase": label,
        "wall_ms": wall_ms,
        "device_busy_ms": busy if launches else None,
        "device_idle_share": (1 - busy / wall_ms) if launches else None,
        "kernel_launches": launches,
        "flash_fwd_ms": flash_ms,
        "top_kernels": top,
    }
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device visible", file=sys.stderr)
        return 2
    from gofr_tpu_torch.tpu.device import _TransformerRunner

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    runner = _TransformerRunner(
        "llama3-8b", dev, max_batch=4, decode_chunk=8, max_seq=2048, seed=SEED
    )
    model = runner.model
    rng = np.random.default_rng(SEED)
    short = rng.integers(0, 256, 100).astype(np.int32)
    long = rng.integers(0, 256, 600).astype(np.int32)
    longest = rng.integers(0, 256, 1800).astype(np.int32)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"profile_serving: {card or torch.cuda.get_device_name(0)}, llama3-8b bf16, "
          f"buckets {runner.buckets}", flush=True)

    # warm every shape once (cuBLAS heuristics, allocator, kernel build)
    state = runner.run_batch([short])[0]
    runner.run_batch([long])
    cache = state["cache"]
    token = torch.tensor([[state["next_token"]]], device=dev)
    model.decode_chunk_pool(token, cache, 2)

    _profiled("prefill bucket 128, batch 4 (1 real row)", lambda: runner.run_batch([short]))
    _profiled("prefill bucket 1024, batch 4 (1 real row)", lambda: runner.run_batch([long]))
    state = runner.run_batch([short])[0]
    cache = state["cache"]
    token = torch.tensor([[state["next_token"]]], device=dev)
    row = _profiled(
        f"decode {STEPS} steps, batch 1, cache ~{len(short)} tokens",
        lambda: model.decode_chunk_pool(token, cache, STEPS),
    )
    print(f"decode: {row['wall_ms'] / STEPS:.2f} ms/step wall, "
          f"{row['kernel_launches'] / STEPS:.0f} kernel launches/step", flush=True)
    state = runner.run_batch([longest])[0]
    cache = state["cache"]
    token = torch.tensor([[state["next_token"]]], device=dev)
    model.decode_chunk_pool(token, cache, 1)  # warm the longer attention shape
    row = _profiled(
        f"decode {STEPS} steps, batch 1, cache ~{len(longest)} tokens",
        lambda: model.decode_chunk_pool(token, cache, STEPS),
    )
    print(f"decode long cache: {row['wall_ms'] / STEPS:.2f} ms/step wall", flush=True)
    pooled(runner, rng)
    return 0


def pooled(runner, rng) -> None:
    """Pooled decode with 1, 4 and 8 of 8 slots active, each request
    decoding POOL_TOKENS tokens; prefill runs before the window."""
    from gofr_tpu_torch.ops.sampling import Sampler
    from gofr_tpu_torch.tpu.decode_pool import DONE, DecodePool
    from gofr_tpu_torch.tpu.device import _row_of

    pool = DecodePool(runner.model, n_slots=POOL_SLOTS, chunk=8)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in
               (100, 300, 500, 150, 450, 250, 400, 200)]

    def decode(states, tokens):
        queues = [pool.submit(_row_of(s), s["length"], s["next_token"], tokens, Sampler())
                  for s in states]
        n = 0
        for q in queues:
            while (item := q.get()) is not DONE:
                n += len(item)
        return n

    try:
        decode([runner.run_batch([p])[0] for p in prompts], 16)  # warm every slot
        for active in (1, 4, 8):
            states = [runner.run_batch([p])[0] for p in prompts[:active]]
            chunks0 = pool.dispatches
            delivered = []
            row = _profiled(f"pooled decode, {active} of {POOL_SLOTS} slots active, "
                            f"{POOL_TOKENS} tokens each",
                            lambda: delivered.append(decode(states, POOL_TOKENS - 1)))
            chunks = pool.dispatches - chunks0
            summary = {
                "active": active, "chunks": chunks,
                "launches_per_chunk": row["kernel_launches"] / chunks,
                "flash_fwd_share": row["flash_fwd_ms"] / row["device_busy_ms"],
                "tokens": delivered[0], "tokens_per_s": delivered[0] / row["wall_ms"] * 1e3,
                "wall_ms_per_chunk": row["wall_ms"] / chunks,
            }
            print(f"pooled: {json.dumps(summary)}", flush=True)
    finally:
        pool.close()


if __name__ == "__main__":
    sys.exit(main())
