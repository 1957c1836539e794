"""Find the highest rate an open-loop cell sustains: one boot, then a
window at each offered rate in turn, each reporting the share of its
requests that completed and the backlog (requests due and not finished)
at the window's middle and end. The knee is the highest rate at which at
least 97 % complete and the backlog at the end is no larger than at the
middle; a cell runs at 0.8 x the knee, written into its traffic file.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 2,4,6
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import serve, spec, stats  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    os.environ.setdefault("LOG_LEVEL", "ERROR")
    cell = spec.load_cell(args.workload)
    app, _ = serve.boot(cell, args.seed, "cuda", {})
    gen = spec.generator(cell.traffic["kind"])
    try:
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            traffic = dict(cell.traffic, rate_per_s=rate, warm_s=0)
            plan = gen.plan(traffic, int(cell.config["vocab_size"]), args.seed + k, args.seconds)
            t0, _, client, _ = serve.drive(cell, plan, args.seconds, app.container.tpu, False)
            recs = client["records"]
            window = stats.in_window(recs, t0, args.seconds, closed=False)
            done = sum(1 for r in window if stats.ok(r))
            m = stats.serving_metrics(recs, t0, args.seconds, closed=False)
            print(json.dumps({
                "rate": rate, "sent": len(window), "completed_share": done / max(len(window), 1),
                "backlog_mid": stats.backlog(recs, t0 + args.seconds / 2),
                "backlog_end": stats.backlog(recs, t0 + args.seconds),
                "ttft_p95_ms": m.get("ttft_p95_ms"), "tpot_p95_ms": m.get("tpot_p95_ms"),
                "failures": sorted({r["status"][:120] for r in window if not stats.ok(r)})[:3],
            }), flush=True)
            if done < 0.5 * len(window):
                break  # far past the knee: higher rates only wedge the card
            time.sleep(2.0)
    finally:
        app.shutdown()
        serve.stop_children()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
