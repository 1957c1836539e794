"""Where the training time goes on the card: llama3-8b (full width and
depth, bf16, random weights from a seed) takes AdamW steps at B=1, S=2048
with remat through the port's trainer, under ``torch.profiler``.

    python3 -m gofr_tpu_torch.profile_training

After one warm-up step it prints one JSON line for a whole step (host wall
time ending in a device synchronize, device busy time as the sum of CUDA
kernel durations on the one stream, the device's idle share, launches,
and device time by kind: the three flash kernels, matrix products, and
everything else) and one for the optimizer's update alone (grad norm,
clip and AdamW over grads of the next batch). Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

SEED = 0
SEQ = 2049  # the model sees 2048 tokens


def _kind(name: str) -> str:
    for key in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"):
        if key in name:
            return key
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    return "other"


def _profiled(label: str, fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_kind: dict = defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        row = by_kind[_kind(evt.name)]
        row[0] += 1
        row[1] += (evt.time_range.end - evt.time_range.start) / 1e3
    busy = sum(v[1] for v in by_kind.values())
    launches = sum(v[0] for v in by_kind.values())
    out = {
        "phase": label,
        "wall_ms": wall_ms,
        "device_busy_ms": busy if launches else None,
        "device_idle_share": (1 - busy / wall_ms) if launches else None,
        "kernel_launches": launches,
        "by_kind": {k: {"count": n, "ms": ms} for k, (n, ms) in sorted(by_kind.items())},
    }
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device visible", file=sys.stderr)
        return 2
    from gofr_tpu_torch.models.llama import LLAMA3_8B
    from gofr_tpu_torch.training import optim, trainer
    from gofr_tpu_torch.training.data import TokenDataset

    cfg = LLAMA3_8B
    opt = trainer.default_optimizer(3e-4)
    state = trainer.init_train_state(cfg, opt, device="cuda", seed=SEED)
    step = trainer.make_train_step(cfg, opt, remat=True)
    corpus = np.random.default_rng(SEED).integers(0, cfg.vocab_size, 1 << 20, dtype=np.uint32)
    data = TokenDataset(corpus, seq_len=SEQ, batch_size=1, seed=SEED)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"profile_training: {card or torch.cuda.get_device_name(0)}, llama3-8b bf16, "
          f"B=1 S={SEQ - 1}, remat", flush=True)

    state, _ = step(state, data.batch(0))  # warm-up: cuBLAS heuristics, allocator, build
    _profiled("train step", lambda: step(state, data.batch(1)))

    model = state["model"]
    params = list(model.parameters())
    tokens = torch.as_tensor(data.batch(2), device="cuda")
    grads = list(torch.autograd.grad(trainer.cross_entropy_loss(model, tokens, remat=True),
                                     params))

    def update():
        optim.global_norm(grads)
        opt.update(grads, state["opt_state"], params)

    _profiled("optimizer update (grad norm, clip, AdamW)", update)
    return 0


if __name__ == "__main__":
    sys.exit(main())
