"""One serving run of a cell: the cell's model, with weights made from the
seed on the card, behind the port's app and its OpenAI routes on
127.0.0.1 at a free port, in this process; the traffic from the mix's
generator, sent by ``loadgen.py`` in a process of its own. The window's
counters are read from the program (the batcher, the runner, the prefix
store, the decode pool), the device from ``torch.profiler`` in a traced
run, and correctness from the plain reference once the program is freed.

The deployment's settings are the mix's ``serving`` keys, given to the
port as its environment (``MODEL_NAME`` is the configuration's name: the
configuration is registered under it in the port's table of decoder
configurations before the app is built)."""

from __future__ import annotations

import gc
from collections import Counter
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import correct, spec, stats, weights
from portbench.devtrace import DeviceTrace

LEAD_S = 1.0  # from the load generator's start to its first request
WAIT_S = 60.0  # how long requests in flight at the close are waited for
SAMPLE_EVERY_S = 0.25  # the pool's occupancy, read through the window


_children: list = []


def stop_children() -> None:
    """Stop the load generator if it still runs, and wait for it."""
    for proc in _children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_model(cell: spec.Cell, seed: int, device: str, setup: dict):
    """The cell's model in the port's ``Transformer``, registered under the
    configuration's name in the port's table of decoder configurations
    (where ``MODEL_NAME`` is looked up), with the seed's weights; the
    kernels built. -> (model, sizes)."""
    from gofr_tpu_torch.models.llama import CONFIGS
    from gofr_tpu_torch.models.transformer import Transformer, TransformerConfig

    m = weights.dims(cell.config)
    cfg = TransformerConfig(
        vocab_size=m["vocab_size"], dim=m["dim"], n_layers=m["n_layers"], n_heads=m["n_heads"],
        n_kv_heads=m["n_kv_heads"], hidden_dim=m["hidden_dim"], max_seq=m["max_seq"],
        rope_theta=m["rope_theta"], norm_eps=m["norm_eps"],
        dtype=getattr(torch, cell.config["torch_dtype"]),
    )
    CONFIGS[cell.config_name] = cfg
    t = time.monotonic()
    model = Transformer(cfg, device)
    weights.fill(model, m, seed)
    nvcc = 0.0
    if device == "cuda":
        from gofr_tpu_torch.ops import flash

        torch.cuda.synchronize()
        t_nvcc = time.monotonic()
        flash.build()
        nvcc = setup["nvcc_s"] = time.monotonic() - t_nvcc
    setup["weights_s"] = time.monotonic() - t - nvcc
    return model, m


def _counters(dev) -> dict:
    runner, pool = dev.runner, dev.decode_pool
    out = {
        "batcher_dispatches": dev.batcher.dispatches if dev.batcher is not None else 0,
        "prefills": runner.prefills,
        "prefix": dict(runner.prefix_stats),
    }
    if pool is not None:
        occ = pool.occupancy()
        out.update(pool_dispatches=occ["dispatches"], pool_active=occ["active"])
    return out


def boot(cell: spec.Cell, seed: int, device: str, setup: dict):
    """The app serving the cell's model, booted and warm (kernels built,
    the runner's shapes warmed)."""
    os.environ.update({k: str(v) for k, v in cell.traffic["serving"].items()})
    os.environ.update({"MODEL_NAME": cell.config_name, "TORCH_DEVICE": device,
                       "HTTP_PORT": str(_free_port()), "GEN_STOP_EOS": "off"})
    for key in ("TOKENIZER", "TOKENIZER_PATH", "MODEL_PATH"):
        os.environ.pop(key, None)
    model, m = build_model(cell, seed, device, setup)
    import gofr_tpu_torch

    t = time.monotonic()
    app = gofr_tpu_torch.new(configs_dir=str(Path(cell.root) / spec.HERE.name / "configs"),
                             model=model)
    gofr_tpu_torch.register_openai_routes(app)
    app.start()
    setup["boot_s"] = time.monotonic() - t
    if device == "cuda":
        setup["booted_bytes"] = torch.cuda.memory_allocated()
    return app, m


def drive(cell: spec.Cell, plan: dict, seconds: float, dev, trace: bool) -> tuple:
    """Send ``plan`` through the load generator against the running app
    and watch the window. -> (t0, the window's readings, the client's
    records and lateness, when the load generator started)."""
    tracer = DeviceTrace() if trace else None
    if tracer is not None:
        tracer.arm()
    t_lg = time.monotonic()
    t0 = t_lg + LEAD_S + plan["warm_s"]
    request = {"port": int(os.environ["HTTP_PORT"]), "model": cell.config_name, "t0": t0,
               "seconds": seconds, "wait_s": WAIT_S, "plan": plan}
    loadgen = subprocess.Popen(
        [sys.executable, str(Path(__file__).with_name("loadgen.py"))],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    _children.append(loadgen)
    loadgen.stdin.write(json.dumps(request))
    loadgen.stdin.close()
    window = _watch(dev, t0, seconds, tracer)
    out_text = loadgen.stdout.read()
    if loadgen.wait() != 0:
        raise RuntimeError(f"the load generator exited with {loadgen.returncode}")
    if tracer is not None:
        # read once no request is left in flight: turning the trace's
        # events into Python objects holds the interpreter for seconds
        t = time.monotonic()
        window["trace"] = tracer.read()
        window["trace"].update(start=tracer.start_t, end=tracer.stop_t, stop_s=tracer.stop_s,
                               read_s=time.monotonic() - t)
    return t0, window, json.loads(out_text), t_lg


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", control: bool = False) -> dict:
    setup: dict = {}
    plan = spec.generator(cell.traffic["kind"], cell.root).plan(
        cell.traffic, int(cell.config["vocab_size"]), seed, seconds)
    app, m = boot(cell, seed, device, setup)
    closed = plan["mode"] == "closed"
    try:
        t0, window, client, t_lg = drive(cell, plan, seconds, app.container.tpu,
                                         trace and device == "cuda")
        setup["warm_s"] = t0 - t_lg
        setup["setup_s"] = t0 - t_start
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    finally:
        app.shutdown()
    del app
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    records = client["records"]
    prompts = _prompts(plan, records)
    e2e = stats.serving_metrics(records, t0, seconds, closed)
    picked = correct.sample(stats.in_window(records, t0, seconds, closed), seed,
                            int(cell.traffic["check_tokens"]))
    found = correct.readings(cell, m, seed, picked, prompts, torch.device(device),
                             control=control)
    run_data = {
        "cell": cell.name, "model": m, "traffic": cell.traffic, "records": records,
        "closed": closed, "t0": t0, "window_s": seconds, "counters": window["counters"],
        "pool_samples": window["pool_samples"], "trace": window.get("trace"),
        "prefill_width": dev_prefill_width(cell),
    }
    failures = Counter(r["status"][:300] for r in records if r["status"] != "ok")
    e2e["backlog_mid"] = stats.backlog(records, t0 + seconds / 2)
    e2e["backlog_end"] = stats.backlog(records, t0 + seconds)
    window_recs = stats.in_window(records, t0, seconds, closed)
    e2e["slowest"] = [[round(stats.ttft_s(r, closed), 3), r["prompt_len"], r.get("q")]
                      for r in sorted(window_recs, key=lambda r: -stats.ttft_s(r, closed))[:3]]
    return {"e2e": e2e, "setup": setup, "peak": peak, "found": found, "run": run_data,
            "late_s": client["late_s"], "sample": len(picked),
            "failures": dict(failures.most_common(5))}


def dev_prefill_width(cell: spec.Cell) -> int:
    """The width of a chunked prefill's slices: the largest bucket within
    ``PREFILL_CHUNK_TOKENS`` (the port's rule), or the longest bucket."""
    s = cell.traffic["serving"]
    buckets = [int(b) for b in str(s["MODEL_BUCKETS"]).split(",")]
    budget = int(s.get("PREFILL_CHUNK_TOKENS", 0))
    fitting = [b for b in buckets if not budget or b <= budget]
    return fitting[-1] if fitting else buckets[0]


def _prompts(plan: dict, records: list) -> dict:
    """Record index -> the prompt it sent."""
    if plan["mode"] == "open":
        return {r["i"]: plan["requests"][r["i"]]["prompt"] for r in records}
    out = {}
    for r in records:
        session = plan["workers"][r["worker"]][r["session"]]
        out[r["i"]] = session["doc"] + session["questions"][r["q"]]["suffix"]
    return out


def _watch(dev, t0: float, seconds: float, tracer: "DeviceTrace | None") -> dict:
    """Through the window: the counters at its start and end, the pool's
    occupancy every ``SAMPLE_EVERY_S``; the device trace starts and stops
    with it."""
    _sleep_until(t0)
    if tracer is not None:
        tracer.start()
    start = _counters(dev)
    samples = []
    end_t = t0 + seconds
    while time.monotonic() < end_t:
        c = _counters(dev)
        if "pool_dispatches" in c:
            samples.append((c["pool_dispatches"], c["pool_active"]))
        time.sleep(min(SAMPLE_EVERY_S, max(0.0, end_t - time.monotonic())))
    end = _counters(dev)
    if tracer is not None:
        tracer.stop()
    return {"counters": {"start": start, "end": end}, "pool_samples": samples}


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))
