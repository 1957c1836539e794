"""The sm90 flash kernels alone, quickly: build, check against the plain
versions, and time each beside its mma predecessor at the training shape.

    python3 -m gofr_tpu_torch.check_sm90

The short loop for work on ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``
(about 30 s on one H100, the build included) before ``chip_smoke.py``
drives the whole port. It prints the card's name and power limit, each
sm90 kernel's registers and spills from ptxas, one line per case with the
max errors (forward: out and LSE; backward: dQ, dK, dV, dK/dV exactly 0
past kv_len, and for the training shape bit-identical twice), and last
one JSON line of times in ms (CUDA events, 20 launches after 3 warm-up
launches): the forward's sm90 and mma variants, and dK/dV's. Exits
non-zero without a CUDA card or when a case fails its tolerance (bf16
2e-2 + 2e-2 * |ref|).
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from gofr_tpu_torch.ops import flash

TOL = 2e-2
NAN = float("nan")


def _case(b, sq, skv, hq, hkv, offs, lens, poison=None, seed=0):
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, 128, device=dev, generator=gen).to(torch.bfloat16)
                   for s, h in ((sq, hq), (skv, hkv), (skv, hkv), (sq, hq)))
    offs = torch.tensor(offs, dtype=torch.int32, device=dev)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    if poison is not None:
        tail = (torch.arange(skv, device=dev)[None] >= lens[:, None])[:, :, None, None]
        k, v = k.masked_fill(tail, poison), v.masked_fill(tail, poison)
    return q, k, v, do, offs, lens


def _close(got, want) -> tuple[float, bool]:
    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= TOL + TOL * want.float().abs()).all())
    return float(err.max()), ok


def check_forward(name, c, causal=True) -> bool:
    q, k, v, _, offs, lens = c
    before = flash.launches_fwd_sm90.value
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    torch.cuda.synchronize()
    ran = flash.launches_fwd_sm90.value - before
    ref_out, ref_lse = flash.flash_attention_ref(q, k, v, causal, offs, lens)
    e_out, ok_out = _close(out, ref_out)
    live = torch.isfinite(ref_lse)
    e_lse, ok_lse = _close(lse[live], ref_lse[live])
    ok = ok_out and ok_lse and bool((torch.isinf(lse) == ~live).all()) and ran == 1
    print(f"forward {name}: sm90 launches {ran}, max|out err| {e_out:.3e}, max|lse err| "
          f"{e_lse:.3e} -> {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def check_backward(name, c, causal=True, twice=False) -> bool:
    q, k, v, do, offs, lens = c
    scale = 128 ** -0.5
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    before = flash.launches_dkv_sm90.value
    got = flash._launch_bwd(q, k, v, offs, lens, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    ran = flash.launches_dkv_sm90.value - before
    want = flash.flash_attention_bwd_ref(q, k, v, offs, lens, out, lse, do, causal, scale)
    errs = [_close(a, w) for a, w in zip(got, want)]
    tail = torch.arange(k.shape[1], device=k.device)[None] >= lens[:, None]
    zeros = all(bool((g[tail] == 0).all()) for g in got[1:])
    same = True
    if twice:
        again = flash._launch_bwd(q, k, v, offs, lens, out, lse, do, causal, scale)
        same = torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
    ok = all(o for _, o in errs) and zeros and same and ran == 1
    print(f"backward {name}: dK/dV sm90 launches {ran}, max|err| dq {errs[0][0]:.3e} dk "
          f"{errs[1][0]:.3e} dv {errs[2][0]:.3e}, zeros past kv_len {zeros}, bit-identical "
          f"twice {same} -> {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def times_at_training_shape() -> dict:
    q, k, v, do, offs, lens = _case(1, 2048, 2048, 32, 8, [0], [2048])
    scale = 128 ** -0.5
    out, lse = flash.flash_attention_fwd(q, k, v, True, offs, lens)
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, dvec, offs, lens, True, scale)
    return {
        "fwd_sm90_ms": time_ms(lambda: flash._launch(q, k, v, offs, lens, True, scale)),
        "fwd_mma_ms": time_ms(lambda: flash._launch(q, k, v, offs, lens, True, scale, "mma")),
        "dkv_sm90_ms": time_ms(lambda: flash.launch_dkv(*args)),
        "dkv_mma_ms": time_ms(lambda: flash.launch_dkv(*args, variant="mma")),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("check_sm90: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"check_sm90: {card or torch.cuda.get_device_name(0)}", flush=True)
    built = flash.build()
    lines = built.log.splitlines()
    for i, line in enumerate(lines):
        for name in ("flash_fwd_sm90", "flash_bwd_dkv_sm90"):
            if f"{name}_kernel" in line and "Compiling entry" in line:
                props = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                         if "spill" in x or "registers" in x]
                print(f"ptxas {name}: {'; '.join(props)}", flush=True)
    ok = all([
        check_forward("1x128 non-causal", _case(1, 128, 128, 1, 1, [0], [128]), causal=False),
        check_forward("training shape", _case(1, 2048, 2048, 32, 8, [0], [2048])),
        check_forward("130/200 ragged", _case(2, 130, 200, 8, 2, [0, 70], [130, 200])),
        check_forward("300/1024 NaN tail", _case(2, 300, 1024, 8, 2, [0, 500], [300, 800],
                                                 poison=NAN)),
        check_forward("kv_lens=0 row", _case(2, 64, 128, 4, 2, [0, 64], [0, 128])),
        check_backward("1x128 non-causal", _case(1, 128, 128, 1, 1, [0], [128]), causal=False),
        check_backward("training shape", _case(1, 2048, 2048, 32, 8, [0], [2048]), twice=True),
        check_backward("300/1024 NaN tail", _case(2, 300, 1024, 8, 2, [0, 500], [300, 800],
                                                  poison=NAN)),
        check_backward("groups 8", _case(1, 256, 256, 16, 2, [0], [256])),
        check_backward("groups 16", _case(1, 256, 256, 16, 1, [0], [256])),
        check_backward("kv_lens=0 row", _case(2, 64, 128, 4, 2, [0, 64], [0, 128])),
    ])
    print(json.dumps(times_at_training_shape()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
