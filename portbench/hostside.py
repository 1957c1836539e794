"""The host's side of one serving run of a cell, beside its device trace:
where a decode-pool chunk's wall time goes on the host, and what the host
was doing while the card sat idle.

    python3 portbench/hostside.py --workload deepseek-7b.docqa --seed 12345 --seconds 51 --trace 1

The run is ``run.py``'s (the same set-up, traffic, window and check), with
two readers added around it and nothing of the run changed: a poller that
reads the program's dispatch records with their host phase marks
(``DispatchTimeline.since``, every ``serve.SAMPLE_EVERY_S``) and the OpenAI
handlers' host seconds, and, with ``--trace 1``, the device trace's busy
intervals on the host's clock. It prints one JSON line:

- ``pool_issue_ms``, ``pool_wait_ms``, ``pool_finish_ms``: the host phases
  (``introspect.PHASES``) of the window's decode chunks, each over the
  chunks closed in the window; ``pool_chunk_ms`` as its metric reads it,
  and ``pool_rest_ms``, the pool worker's time outside those phases; the
  chunks' issue split by whether a prefill was issuing beside it
  (``issue_beside_prefill``); ``pool_empty_share``, the window's share
  with no chunk between its dispatch and its close;
- ``prefill_queue_ms``: the queue phase of the window's prefill dispatches
  (batcher prefills, chunked slices, tail prefills) over their count;
- ``http_busy_share``: the OpenAI handlers' host seconds over the window, %;
- ``prefix_token_share``: prompt tokens the prefix cache gave over all the
  window's prompt tokens, %;
- traced: ``idle_s`` (the window's seconds with no operation on the card)
  and its split: ``idle_in_issue`` (some dispatch, on any thread, in its
  issue phase), ``idle_in_wait`` (none in issue, some in its wait) and
  ``idle_outside_dispatch`` (none in either), each % of ``idle_s``;
  ``clock_drift_ns``, how far the wall clock moved against the monotonic
  one from the trace's start to its stop.

The device trace (kineto) stamps its events on the wall clock (ns since
the epoch); the program's marks and the harness's window are on the
monotonic clock. ``clock_pair`` reads both back to back at the trace's
start and stop, and ``to_monotonic`` maps a wall stamp through the start
pair; the stop pair bounds the mapping's error over the window.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)  # run as a script: import the folder as a package

from portbench.devtrace import DeviceTrace, _span_ns  # noqa: E402

PREFILL_KINDS = ("prefill", "prefill_chunk")
MARKS = ("t_queued", "t_running", "t_issued", "t_wait", "t_synced", "t_done")


def clock_pair() -> tuple:
    """(wall ns, monotonic ns) read back to back: the wall clock read on
    both sides of the monotonic one, their midpoint kept."""
    w0 = time.time_ns()
    m = time.monotonic_ns()
    w1 = time.time_ns()
    return (w0 + w1) // 2, m


def to_monotonic(wall_ns: int, pair: tuple) -> float:
    """A wall-clock stamp in ns as monotonic seconds, through ``pair``."""
    return (wall_ns - pair[0] + pair[1]) / 1e9


def drift_ns(start: tuple, stop: tuple) -> int:
    """How far the wall clock moved against the monotonic one between two
    pairs (an NTP slew or step), in ns: the mapping's error at the stop."""
    return (stop[0] - start[0]) - (stop[1] - start[1])


def merge(intervals) -> list:
    """Sorted, overlapping or touching intervals merged into their union."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def _overlap(a: list, b: list) -> float:
    """Seconds two unions of intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def gaps(busy: list, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] outside the union ``busy``."""
    out, t = [], lo
    for a, b in merge(_clip(busy, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def phase_spans(records: list, phase: str) -> list:
    """Each record's ``issue`` (t_running to t_issued) or ``wait`` (t_wait
    to its sync, or its close) interval, where marked."""
    out = []
    for r in records:
        if phase == "issue" and r.get("t_issued") is not None:
            out.append((r["t_running"], r["t_issued"]))
        elif phase == "wait" and r.get("t_wait") is not None:
            out.append((r["t_wait"], r["t_synced"] if r.get("t_synced") is not None
                        else r["t_done"]))
    return out


def idle_split(busy: list, lo: float, hi: float, records: list) -> dict:
    """The card's idle seconds in [lo, hi] (outside the union ``busy``)
    and how they split by what the host was doing: some dispatch in its
    issue phase; else some in its wait; else neither."""
    idle = gaps(busy, lo, hi)
    issue = merge(_clip(phase_spans(records, "issue"), lo, hi))
    either = merge(issue + _clip(phase_spans(records, "wait"), lo, hi))
    idle_s = sum(b - a for a, b in idle)
    in_issue = _overlap(idle, issue)
    in_either = _overlap(idle, either)
    return {"idle_s": idle_s, "in_issue_s": in_issue, "in_wait_s": in_either - in_issue,
            "outside_s": idle_s - in_either}


def window_phases(records: list, lo: float, hi: float, kinds: tuple) -> tuple:
    """(records of ``kinds`` closed in [lo, hi), the sums of each of their
    phases: queue, issue, between, wait, finish)."""
    from gofr_tpu_torch.tpu.introspect import phase_seconds

    picked = [p for r in records if r["kind"] in kinds and r["status"] == "ok"
              and lo <= r["t_done"] < hi
              for p in [phase_seconds(*(r[k] for k in MARKS))] if p is not None]
    return len(picked), [sum(p[i] for p in picked) for i in range(5)]


def issue_beside_prefill(records: list, lo: float, hi: float) -> dict:
    """The issue phase of the decode chunks closed in [lo, hi), split by
    whether a prefill dispatch (on another thread) was issuing at the same
    time: each group's mean in ms and its count, and the share of the
    chunks' issue seconds that a prefill's issue overlapped, in %."""
    prefill = merge(phase_spans([r for r in records if r["kind"] in PREFILL_KINDS], "issue"))
    groups: dict = {"alone": [], "beside_prefill": []}
    shared = total = 0.0
    for r in records:
        if (r["kind"] != "decode_chunk" or r["status"] != "ok" or r.get("t_issued") is None
                or not lo <= r["t_done"] < hi):
            continue
        span = [(r["t_running"], r["t_issued"])]
        overlap = _overlap(span, prefill)
        groups["beside_prefill" if overlap > 0 else "alone"].append(r["t_issued"] - r["t_running"])
        shared += overlap
        total += r["t_issued"] - r["t_running"]
    out: dict = {}
    for name, spans in groups.items():
        out[f"chunks_{name}"] = len(spans)
        if spans:
            out[f"pool_issue_ms_{name}"] = 1e3 * sum(spans) / len(spans)
    if total > 0:
        out["pool_issue_beside_prefill_share"] = 100.0 * shared / total
    return out


def _at(samples: list, t: float) -> float:
    """The last sampled value at or before ``t`` (the first sample before any)."""
    value = samples[0][1]
    for ts, v in samples:
        if ts > t:
            break
        value = v
    return value


def readings(run: dict, host: dict) -> dict:
    """The host-side numbers of a run (``run.py``'s run dict) and what the
    poller saw (``host``: the dispatch records, the handler seconds sampled,
    and in a traced run the device's busy intervals and clock pairs)."""
    lo, hi = run["t0"], run["t0"] + run["window_s"]
    recs = host["records"]
    out: dict = {}
    chunks, pool = window_phases(recs, lo, hi, ("decode_chunk",))
    c = run["counters"]
    if chunks:
        out["pool_issue_ms"], out["pool_wait_ms"], out["pool_finish_ms"] = (
            1e3 * pool[1] / chunks, 1e3 * pool[3] / chunks, 1e3 * pool[4] / chunks)
        dispatched = c["end"].get("pool_dispatches", 0) - c["start"].get("pool_dispatches", 0)
        if dispatched > 0:
            out["pool_chunk_ms"] = 1e3 * run["window_s"] / dispatched
            out["pool_rest_ms"] = out["pool_chunk_ms"] - sum(
                out[k] for k in ("pool_issue_ms", "pool_wait_ms", "pool_finish_ms"))
        out["pool_chunks_closed"] = chunks
        out.update(issue_beside_prefill(recs, lo, hi))
        # the window's share with no decode chunk between its dispatch and its
        # close: the pool had no active row (or had not dispatched again)
        open_ = merge(_clip([(r["t_running"], r["t_done"]) for r in recs
                             if r["kind"] == "decode_chunk" and r.get("t_done") is not None],
                            lo, hi))
        out["pool_empty_share"] = 100.0 * (1.0 - sum(b - a for a, b in open_) / (hi - lo))
    prefills, pre = window_phases(recs, lo, hi, PREFILL_KINDS)
    if prefills:
        out["prefill_queue_ms"] = 1e3 * pre[0] / prefills
        out["prefills_closed"] = prefills
    if host["handler"]:
        out["http_busy_share"] = 100.0 * (_at(host["handler"], hi) - _at(host["handler"], lo)) \
            / run["window_s"]
    s, e = c["start"]["prefix"], c["end"]["prefix"]
    if "prefix_tokens" in e:
        got = e["prefix_tokens"] - s["prefix_tokens"]
        computed = e["prefill_tokens"] - s["prefill_tokens"]
        if got + computed:
            out["prefix_token_share"] = 100.0 * got / (got + computed)
    if host.get("busy") is not None:
        tr = run["trace"]
        split = idle_split(host["busy"], tr["start"], tr["end"], recs)
        out["idle_s"] = split["idle_s"]
        if split["idle_s"] > 0:
            for key, part in (("idle_in_issue", "in_issue_s"), ("idle_in_wait", "in_wait_s"),
                              ("idle_outside_dispatch", "outside_s")):
                out[key] = 100.0 * split[part] / split["idle_s"]
        out["device_idle_s"] = tr["window_s"] - tr["busy_s"]
        out["clock_drift_ns"] = drift_ns(host["start_pair"], host["stop_pair"])
    return out


class ClockedTrace(DeviceTrace):
    """The harness's device trace, with a clock pair read at its start and
    its stop, and its busy intervals kept on the monotonic clock."""

    def start(self) -> None:
        super().start()
        self.start_pair = clock_pair()

    def stop(self) -> None:
        self.stop_pair = clock_pair()
        super().stop()

    def read(self, *args, **kwargs) -> dict:
        from torch.autograd import DeviceType

        out = super().read(*args, **kwargs)
        spans = [_span_ns(evt) for evt in self._prof.profiler.kineto_results.events()
                 if evt.device_type() == DeviceType.CUDA]
        out["busy_intervals"] = merge((to_monotonic(a, self.start_pair),
                                       to_monotonic(b, self.start_pair)) for a, b in spans)
        return out


class Poller:
    """Reads the program's closed dispatch records (with their marks) and
    the handlers' host seconds every ``every`` seconds until stopped."""

    def __init__(self, dev, recorder, every: float) -> None:
        self.dev, self.recorder, self.every = dev, recorder, every
        self.records: list = []
        self.handler: list = []
        self._last = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="hostside-poller", daemon=True)

    def poll(self) -> None:
        timeline = getattr(self.dev, "timeline", None)
        if timeline is not None and hasattr(timeline, "since"):
            got = timeline.since(self._last)
            if got:
                self.records.extend(got)
                self._last = got[-1]["dispatch_id"]
        if self.recorder is not None and hasattr(self.recorder, "handler_seconds"):
            self.handler.append((time.monotonic(), self.recorder.handler_seconds()))

    def _loop(self) -> None:
        while not self._stop.wait(self.every):
            self.poll()

    def start(self) -> None:
        self.poll()
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
        self.poll()


def execute(cell: str, seed: int, seconds: float, trace: bool, root: Path = ROOT,
            device: str = "cuda") -> tuple:
    """``run.execute`` with the poller around the window (and the clocked
    trace when traced). -> (run.py's output, the host-side readings)."""
    from portbench import run, serve

    host: dict = {}
    boot, drive, trace_cls = serve.boot, serve.drive, serve.DeviceTrace
    traces: list = []

    def booted(*args, **kwargs):
        app, m = boot(*args, **kwargs)
        host["recorder"] = getattr(app.container, "telemetry", None)
        return app, m

    def driven(cell_, plan, seconds_, dev, trace_):
        poller = Poller(dev, host.get("recorder"), serve.SAMPLE_EVERY_S)
        poller.start()
        try:
            return drive(cell_, plan, seconds_, dev, trace_)
        finally:
            poller.stop()
            host["records"], host["handler"] = poller.records, poller.handler

    def clocked():
        tr = ClockedTrace()
        traces.append(tr)
        return tr

    serve.boot, serve.drive, serve.DeviceTrace = booted, driven, clocked
    try:
        out = run.execute(cell, seed, seconds, trace, root, device=device)
    finally:
        serve.boot, serve.drive, serve.DeviceTrace = boot, drive, trace_cls
    tr = out["run"].get("trace")
    if tr is not None and traces:
        host.update(busy=tr.pop("busy_intervals"), start_pair=traces[0].start_pair,
                    stop_pair=traces[0].stop_pair)
    return out, readings(out["run"], host)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import run

    run._environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("hostside: needs a CUDA card", file=sys.stderr)
        return 3
    out, host = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    line = run.result_line(out["cell"], out, bool(args.trace), torch.cuda.get_device_name(0),
                           out["cell"].chips)
    print(json.dumps({"host": host, "e2e": out["e2e"], "setup": out["setup"],
                      "correct": out["correct"], "metrics": line["metrics"],
                      "layers": line.get("layers"), "device": line["device"],
                      "trace_s": {k: (out["run"].get("trace") or {}).get(k)
                                  for k in ("stop_s", "read_s")}}))
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    import os

    os._exit(code)
