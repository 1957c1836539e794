"""Run one cell of ``BENCHMARK.json`` once and print its result as the last
line of standard output:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run makes the cell's weights and traffic from ``--seed``, sets up and
warms the port's serving or training path for the cell's shapes (that is
``setup_s``), measures for ``--seconds``, and then judges what the timed
path produced against the plain reference (``correct``). With ``--trace 0``
the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from the program's counters and the device trace.
The numbers compared for ``correct`` end standard error and the result's
line. ``--control 1`` also reads the control (the reference in a lower
precision) on the same requests: what the limits are set from.
``--program-control 1`` serves with the program's own lower-precision
path switched on (the ``program_control`` keys of the cell's limits
file), which has to come out not correct.

Every run also carries, under ``layers``, the per-layer readings that
need no trace (the program's counters), so untraced runs report them too.

Exits non-zero, printing no result, without as many CUDA cards as the cell
asks for, or when JAX or the JAX package is loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LIMIT_S = 345  # a run that has not ended by then dumps its threads and stops
if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)  # run as a script: import the folder as a package
FORBIDDEN = ("jax", "jaxlib", "flax", "gofr_tpu")


def _environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout; no JAX through any
    library that would load it by itself."""
    cache = root / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("LOG_LEVEL", "ERROR")


def _watchdog(limit_s: float) -> None:
    """End a wedged run: after ``limit_s`` dump every thread's stack to
    standard error, stop the load generator, and exit with code 5."""
    import faulthandler
    import threading

    def fire() -> None:
        from portbench import serve

        print(f"portbench: no result after {limit_s} s; the threads:", file=sys.stderr)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        serve.stop_children()
        sys.stderr.flush()
        os._exit(5)

    timer = threading.Timer(limit_s - (time.monotonic() - T_START), fire)
    timer.daemon = True
    timer.start()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole (``gofr_tpu_torch`` is not ``gofr_tpu``)."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result_line(cell, out: dict, trace: bool, device_kind: str, count: int) -> dict:
    """The contract's JSON object from a driver's output."""
    from portbench import spec

    layers = {}
    for entry in cell.per_layer:
        value = spec.reader(entry["name"], cell.root).read(out["run"])
        if value is not None:
            layers[entry["name"]] = {"value": value, "unit": entry["unit"]}
    if trace:
        metrics = layers
    else:
        values = {**out["e2e"], "setup_s": out["setup"]["setup_s"]}
        metrics = {e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
                   for e in cell.end_to_end if e["name"] in values}
    dev = {"platform": "gpu", "kind": device_kind, "count": count,
           "memory_peak_bytes": int(out["peak"])}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    tr = out.get("run", {}).get("trace")
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    if not trace:
        line["layers"] = layers
    line["setup"] = out["setup"]
    line["checked"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                       for k, v in out["checked"].items()}
    return line


def execute(cell_name: str, seed: int, seconds: float, trace: bool, root: Path = ROOT,
            device: str = "cuda", control: bool = False, program_control: bool = False) -> dict:
    """A run without the look for a card: the driver's output with
    ``correct``, ``attempted``, ``failed`` and ``checked`` added."""
    from portbench import correct, spec

    cell = spec.load_cell(cell_name, root)
    if program_control:
        keys = correct.program_control(cell)
        cell.traffic = {**cell.traffic, "serving": {**cell.traffic["serving"], **keys}}
    driver = spec.generator(cell.traffic["kind"], root).DRIVER
    if driver == "serve":
        from portbench import serve as mod
    else:
        from portbench import train as mod
    environ = dict(os.environ)  # the deployment's keys stay with this run
    try:
        out = mod.run(cell, seed, seconds, trace, T_START, device=device, control=control)
    finally:
        os.environ.clear()
        os.environ.update(environ)
    ok, checked = correct.verdict(out["found"], correct.limits(cell))
    out.update(correct=ok and out["sample"] > 0, checked=checked,
               attempted=out["e2e"]["attempted"], failed=out["e2e"]["failed"])
    out["cell"] = cell
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--program-control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment(ROOT)
    _watchdog(LIMIT_S)
    from portbench import spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace), ROOT,
                  control=bool(args.control), program_control=bool(args.program_control))
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    line = result_line(cell, out, bool(args.trace), torch.cuda.get_device_name(0), cell.chips)
    tr = out["run"].get("trace") or {}
    print(json.dumps({"readings": out["found"], "setup": out["setup"], "late_s": out["late_s"],
                      "sample": out["sample"], "e2e": out["e2e"],
                      "failures": out.get("failures", {}),
                      "trace_s": {k: tr[k] for k in ("stop_s", "read_s") if k in tr}}),
          file=sys.stderr)
    for name, c in line["checked"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the app's threads are shut down; one the program left wedged must not
    # hold the process past its result
    os._exit(code)
