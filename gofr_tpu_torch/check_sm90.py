"""The redesigned flash kernels alone, quickly: build, check against the
plain versions, and time each beside its mma predecessor.

    python3 -m gofr_tpu_torch.check_sm90

The short loop for work on ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``
(about 40 s on one H100, the build included) before ``chip_smoke.py``
drives the whole port. It prints the card's name and power limit, each
redesigned kernel's registers, spills and shared memory from ptxas, one
line per case with the max errors (forward: out and LSE; backward: dQ,
dK, dV, dK/dV exactly 0 past kv_len, and for the training shape dQ and
dK/dV bit-identical twice) and the variant the launch counters saw, and
last one JSON line of times in ms: at the training shape the forward's
sm90 and mma variants, dQ's and dK/dV's (CUDA events, 20 launches after 3
warm-up launches); at two decode shapes the decode variant, the mma
kernel and SDPA, each by CUDA events and by device time (``graph_ms``: 20
launches in one CUDA graph, replayed). Exits non-zero without a CUDA card,
when a kernel spills, or when a case fails its tolerance (bf16 2e-2 +
2e-2 * |ref|).
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from gofr_tpu_torch.ops import flash
from gofr_tpu_torch.timing import event_ms, graph_ms

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
    return float(err.max()) if err.numel() else 0.0, ok


def check_forward(name, c, causal=True) -> bool:
    q, k, v, _, offs, lens = c
    want = flash.fwd_variant(q, k)
    counter = {"sm90": flash.launches_fwd_sm90, "decode": flash.launches_fwd_decode}[want]
    before = counter.value
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    torch.cuda.synchronize()
    ran = counter.value - before
    ref_out, ref_lse = flash.flash_attention_ref(q, k, v, causal, offs, lens)
    e_out, ok_out = _close(out, ref_out)
    live = torch.isfinite(ref_lse)
    e_lse, ok_lse = _close(lse[live], ref_lse[live])
    again, _ = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    same = torch.equal(again, out)
    ok = ok_out and ok_lse and bool((torch.isinf(lse) == ~live).all()) and ran == 1 and same
    print(f"forward {name}: {want} launches {ran}, max|out err| {e_out:.3e}, max|lse err| "
          f"{e_lse:.3e}, bit-identical twice {same} -> {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def check_backward(name, c, causal=True, twice=False) -> bool:
    q, k, v, do, offs, lens = c
    scale = 128 ** -0.5
    out, lse = flash.flash_attention_fwd(q, k, v, causal, offs, lens)
    before = (flash.launches_dq_sm90.value, flash.launches_dkv_sm90.value)
    got = flash._launch_bwd(q, k, v, offs, lens, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    ran = (flash.launches_dq_sm90.value - before[0], flash.launches_dkv_sm90.value - before[1])
    want = flash.flash_attention_bwd_ref(q, k, v, offs, lens, out, lse, do, causal, scale)
    errs = [_close(a, w) for a, w in zip(got, want)]
    tail = torch.arange(k.shape[1], device=k.device)[None] >= lens[:, None]
    zeros = all(bool((g[tail] == 0).all()) for g in got[1:])
    same = True
    if twice:
        again = flash._launch_bwd(q, k, v, offs, lens, out, lse, do, causal, scale)
        same = all(torch.equal(a, g) for a, g in zip(again, got))
    ok = all(o for _, o in errs) and zeros and same and ran == (1, 1)
    print(f"backward {name}: dQ/dK-dV sm90 launches {ran}, max|err| dq {errs[0][0]:.3e} dk "
          f"{errs[1][0]:.3e} dv {errs[2][0]:.3e}, zeros past kv_len {zeros}, bit-identical "
          f"twice {same} -> {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def sdpa_masked(q, k, v, offs, lens):
    """scaled_dot_product_attention over the same visible keys (a boolean
    mask): the yardstick, never called by the port."""
    skv = k.shape[1]
    k_pos = torch.arange(skv, device=q.device)
    q_pos = offs[:, None] + torch.arange(q.shape[1], device=q.device)[None, :]
    mask = ((k_pos[None, None, :] < lens[:, None, None])
            & (k_pos[None, None, :] <= q_pos[:, :, None]))[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def decode_times(c) -> dict:
    """The decode variant, the mma kernel and SDPA at one decode shape, by
    CUDA events (20 launches) and by device time (a CUDA graph)."""
    q, k, v, _, offs, lens = c
    scale = 128 ** -0.5
    fns = {
        "decode": lambda: flash._launch(q, k, v, offs, lens, True, scale),
        "mma": lambda: flash._launch(q, k, v, offs, lens, True, scale, "mma"),
        "sdpa_mask": sdpa_masked(q, k, v, offs, lens),
    }
    row = {}
    for name, fn in fns.items():
        row[f"{name}_ms"] = event_ms(fn, 20)
        row[f"{name}_device_ms"] = graph_ms(fn)
    return row


def times() -> dict:
    q, k, v, do, offs, lens = _case(1, 2048, 2048, 32, 8, [0], [2048])
    scale = 128 ** -0.5
    out, lse = flash.flash_attention_fwd(q, k, v, True, offs, lens)
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, dvec, offs, lens, True, scale)
    return {
        "fwd_sm90_ms": event_ms(lambda: flash._launch(q, k, v, offs, lens, True, scale), 20),
        "fwd_mma_ms": event_ms(lambda: flash._launch(q, k, v, offs, lens, True, scale, "mma"), 20),
        "dq_sm90_ms": event_ms(lambda: flash.launch_dq(*args), 20),
        "dq_mma_ms": event_ms(lambda: flash.launch_dq(*args, variant="mma"), 20),
        "dkv_sm90_ms": event_ms(lambda: flash.launch_dkv(*args), 20),
        "dkv_mma_ms": event_ms(lambda: flash.launch_dkv(*args, variant="mma"), 20),
        "decode_b4_cache2048": decode_times(
            _case(4, 1, 2048, 32, 8, [0, 699, 1499, 2047], [1, 700, 1500, 2048])),
        "decode_b1_kv1800": decode_times(_case(1, 1, 2048, 32, 8, [1799], [1800])),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("check_sm90: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"check_sm90: {card or torch.cuda.get_device_name(0)}", flush=True)
    report = flash.build_report(flash.build())
    for name, r in report.items():
        print(f"ptxas {name}: {r['ptxas']}; dynamic shared memory {r['smem']} bytes", flush=True)
    ok = all([
        len(report) == len(flash.SMEM_QUERIES) and not any(r["spills"] for r in report.values()),
        check_forward("1x128 non-causal", _case(1, 128, 128, 1, 1, [0], [128]), causal=False),
        check_forward("training shape", _case(1, 2048, 2048, 32, 8, [0], [2048])),
        check_forward("130/200 ragged", _case(2, 130, 200, 8, 2, [0, 70], [130, 200])),
        check_forward("300/1024 NaN tail", _case(2, 300, 1024, 8, 2, [0, 500], [300, 800],
                                                 poison=NAN)),
        check_forward("kv_lens=0 row", _case(2, 64, 128, 4, 2, [0, 64], [0, 128])),
        check_forward("decode B=4 cache 2048", _case(4, 1, 2048, 32, 8, [0, 699, 1499, 2047],
                                                     [1, 700, 1500, 2048])),
        check_forward("decode B=1 kv 1800 NaN tail", _case(1, 1, 2048, 32, 8, [1799], [1800],
                                                           poison=NAN)),
        check_forward("decode groups 1", _case(2, 1, 512, 8, 8, [99, 400], [100, 401])),
        check_forward("decode groups 8 kv_lens=0 row", _case(2, 1, 512, 32, 4, [0, 300], [0, 301],
                                                             poison=300.0)),
        check_forward("decode Sq=4 groups 4", _case(2, 4, 512, 32, 8, [96, 290], [100, 294])),
        check_backward("1x128 non-causal", _case(1, 128, 128, 1, 1, [0], [128]), causal=False),
        check_backward("training shape", _case(1, 2048, 2048, 32, 8, [0], [2048]), twice=True),
        check_backward("300/1024 NaN tail", _case(2, 300, 1024, 8, 2, [0, 500], [300, 800],
                                                  poison=NAN)),
        check_backward("groups 8", _case(1, 256, 256, 16, 2, [0], [256])),
        check_backward("groups 16", _case(1, 256, 256, 16, 1, [0], [256])),
        check_backward("kv_lens=0 row", _case(2, 64, 128, 4, 2, [0, 64], [0, 128])),
    ])
    print(json.dumps(times()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
