"""One training run of a cell: the cell's model, with weights made from
the seed on the card, trained through the port's own step
(``training.trainer.make_train_step`` with remat and
``default_optimizer``) on the mix's packed batches.

Set-up builds the one training state and drives it through the mix's
``checked_steps`` (what the reference follows: each step's loss, the first
gradient's norm a leaf as the optimizer holds it after one step, and the
parameters' change a leaf after the last) and ``warm_steps`` more; the
same state then trains through the window, step after step, each step's
loss read on the host. Once the window has closed and the state is freed,
the plain reference follows the checked steps from the seed.

In a traced run a marker kernel goes to the card before and after each
optimizer update, so that the trace can tell the optimizer's kernels."""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench import flops, spec, weights
from portbench.devtrace import DeviceTrace
from portbench.serve import build_model

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


class _Marked:
    """The optimizer with a marker kernel on each side of its update."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params, norm=None):
        torch.cuda._sleep(1)
        self.inner.update(grads, state, params, norm=norm)
        torch.cuda._sleep(1)


def _opt_params(traffic: dict) -> dict:
    """default_optimizer's settings: clip 1.0, AdamW b1 0.9, b2 0.95,
    eps 1e-8, weight decay 0.1, and the mix's rate."""
    return {"lr": float(traffic["lr"]), "b1": 0.9, "b2": 0.95, "eps": 1e-8, "wd": 0.1,
            "clip": 1.0}


@torch.no_grad()
def _change(model, m: dict, seed: int) -> dict:
    """{leaf: norm of (now - the seed's initial value)}, float32."""
    from portbench.references.decoder import NORMS

    out = {}
    for index, kind, layer in weights.groups(m):
        owner = model if layer is None else model.layers[layer]
        prefix = "" if layer is None else f"layers.{layer}."
        init = weights.draw_group(m, seed, index, kind, model.embed.device)
        if kind == "head":
            init["norm_f"] = None
        if kind == "layer":
            init.update({n: None for n in NORMS})
        for name, w0 in init.items():
            p = getattr(owner, name).float()
            out[prefix + name] = float((p - (1.0 if w0 is None else w0)).norm())
        del init
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", control: bool = False) -> dict:
    from gofr_tpu_torch.training.trainer import (
        default_optimizer,
        init_train_state_from,
        make_train_step,
    )

    tr = cell.traffic
    opt_p = _opt_params(tr)
    setup: dict = {}
    model, m = build_model(cell, seed, device, setup)
    cfg = model.cfg
    gen = spec.generator(tr["kind"], cell.root)
    batches = gen.plan(tr, m["vocab_size"], seed, seconds)["batches"]
    traced = trace and device == "cuda"
    optimizer = default_optimizer(opt_p["lr"])
    if traced:
        optimizer = _Marked(optimizer)
    state = init_train_state_from(model, optimizer)
    step = make_train_step(cfg, optimizer, remat=True)
    names = [n for n, _ in model.named_parameters()]
    prog: dict = {"loss": []}
    k = 0
    t = time.monotonic()
    for k in range(int(tr["checked_steps"])):
        state, out = step(state, batches.batch(k))
        prog["loss"].append(float(out["loss"]))
        if k == 0:  # the first moment after one step is (1 - b1) times the clipped gradient
            prog["grad_norm"] = {n: float(x.float().norm()) / (1 - opt_p["b1"])
                                 for n, x in zip(names, state["opt_state"][1]["mu"])}
    prog["change"] = _change(model, m, seed)
    for _ in range(int(tr["warm_steps"])):
        k += 1
        state, out = step(state, batches.batch(k))
        float(out["loss"])
    setup["warm_s"] = time.monotonic() - t
    tracer = DeviceTrace() if traced else None
    if tracer is not None:
        tracer.arm()
        k += 1
        state, out = step(state, batches.batch(k))  # the profiler's own start-up, untimed
        float(out["loss"])
    t0 = time.monotonic()
    setup["setup_s"] = t0 - t_start
    if tracer is not None:
        tracer.start()
    steps, bad = 0, 0
    while True:
        k += 1
        state, out = step(state, batches.batch(k))
        bad += not math.isfinite(float(out["loss"]))
        steps += 1
        if time.monotonic() - t0 >= seconds:
            break
    window = time.monotonic() - t0
    run_trace = None
    if tracer is not None:
        tracer.stop()
        run_trace = tracer.read(marker=MARKER)
        run_trace["start"], run_trace["end"] = tracer.start_t, tracer.stop_t
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    del state, model, step, optimizer, out
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    tokens = steps * batches.rows * (batches.seq - 1)
    e2e = {"attempted": steps, "failed": bad, "train_tokens_per_s": tokens / window}
    checked = [batches.batch(i) for i in range(int(tr["checked_steps"]))]
    ref_mod = spec.reference(cell.config["reference"], cell.root)
    ref = ref_mod.train_steps(m, seed, checked, opt_p, torch.device(device))
    found = compare(prog, ref)
    if control:
        ctl = ref_mod.train_steps(m, seed, checked, opt_p, torch.device(device), weights="fp8")
        found.update({f"control_{k}": v for k, v in compare(ctl, ref).items()})
    run_data = {"cell": cell.name, "model": m, "traffic": tr, "window_s": window,
                "steps": steps, "batch": batches.rows, "seq": batches.seq - 1,
                "trace": run_trace, "train_flops": flops.train_flops(m, batches.rows,
                                                                     batches.seq - 1)}
    return {"e2e": e2e, "setup": setup, "peak": peak, "found": found, "run": run_data,
            "late_s": 0.0, "sample": len(checked), "failures": {}}


def compare(prog: dict, ref: dict) -> dict:
    """The gaps between a run's readings and the reference's:
    ``loss_gap`` the widest relative gap of a step's loss; ``grad_gap`` and
    ``change_gap`` the widest gap of a leaf's norm, against the larger of
    that leaf's reference norm and the median leaf's. Leaves whose first
    reference gradient is under a thousandth of the median leaf's (nought
    to rounding: they move under AdamW by round-off alone) are left out of
    the change."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))}
    g_ref = ref["grad_norm"]
    g_med = sorted(g_ref.values())[len(g_ref) // 2]
    out["grad_gap"] = max(abs(prog["grad_norm"][k] - v) / max(v, g_med)
                          for k, v in g_ref.items())
    c_ref = ref["change"]
    kept = [k for k in c_ref if g_ref[k] >= 1e-3 * g_med]
    c_med = sorted(c_ref[k] for k in kept)[len(kept) // 2]
    out["change_gap"] = max(abs(prog["change"][k] - c_ref[k]) / max(c_ref[k], c_med)
                            for k in kept)
    out["leaves_left_out"] = len(c_ref) - len(kept)
    return out
