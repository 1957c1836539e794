"""The device's side of a traced window: ``torch.profiler`` on the card
(CUPTI), read back as each device operation's count and seconds, the
seconds in which any operation ran (the union of their intervals), and
the longest idle stretches with the operation that ended each."""

from __future__ import annotations

import time
from collections import defaultdict


def _span_ns(evt) -> tuple:
    """(start, end) of a kineto event in ns, across profiler versions."""
    if hasattr(evt, "start_ns"):
        start = evt.start_ns()
        return start, start + evt.duration_ns()
    start = evt.start_us() * 1000
    return start, start + evt.duration_us() * 1000


class DeviceTrace:
    """A CUDA-only profile: ``arm()`` during set-up (the profiler's own
    start-up, seconds long, stalls the process, so it must not fall in the
    window), ``start()`` at the window's start (what came before is
    dropped), ``stop()`` at its end, then ``read()``."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.start_t = self.stop_t = self.stop_s = 0.0

    def arm(self) -> None:
        self._prof.start()

    def start(self) -> None:
        self._prof.step()
        self.start_t = time.monotonic()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.stop_t = time.monotonic()
        self._prof.stop()
        self.stop_s = time.monotonic() - self.stop_t

    def read(self, top: int = 10, marker: str = "") -> dict:
        """{"window_s", "busy_s", "ops": {name: [count, seconds]},
        "device_ops": top operations by seconds, "idle_gaps": the longest
        idle stretches by the operation that ended them, "marked_s": the
        seconds of operations between each odd and even occurrence of an
        operation whose name holds ``marker``}."""
        from torch.autograd import DeviceType

        ops: dict = defaultdict(lambda: [0, 0.0])
        spans = []
        for evt in self._prof.profiler.kineto_results.events():
            if evt.device_type() != DeviceType.CUDA:
                continue
            start, end = _span_ns(evt)
            name = evt.name()
            ops[name][0] += 1
            ops[name][1] += (end - start) / 1e9
            spans.append((start, end, name))
        spans.sort()
        marked_ns, inside = 0, False
        for start, end, name in spans if marker else ():
            if marker in name:
                inside = not inside
            elif inside:
                marked_ns += end - start
        busy_ns, gaps = 0, defaultdict(float)
        cur_start = cur_end = None
        for start, end, name in spans:
            if cur_end is None or start > cur_end:
                if cur_end is not None:
                    busy_ns += cur_end - cur_start
                    gaps[f"idle before {name[:100]}"] += (start - cur_end) / 1e9
                cur_start, cur_end = start, end
            else:
                cur_end = max(cur_end, end)
        if cur_end is not None:
            busy_ns += cur_end - cur_start
        window = self.stop_t - self.start_t
        return {
            "window_s": window,
            "busy_s": busy_ns / 1e9,
            "ops": dict(ops),
            "device_ops": [[n[:120], s] for n, (_, s) in
                           sorted(ops.items(), key=lambda kv: -kv[1][1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
            "marked_s": marked_ns / 1e9,
        }


def seconds_of(trace: dict, *needles: str) -> float:
    """Device seconds of the operations whose name holds any of ``needles``."""
    return sum(s for name, (_, s) in trace["ops"].items() if any(n in name for n in needles))
