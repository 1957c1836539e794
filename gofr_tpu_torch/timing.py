"""Kernel times on the card, two ways.

- ``event_ms``: CUDA events around many launches from the host. Where a
  launch's device time is shorter than the host's cost to issue it (the
  Python wrapper, ctypes, the launch itself: decode-sized calls), this
  reads the host's issue rate, not the kernel.
- ``graph_ms``: the same launches captured once in a CUDA graph and
  replayed under CUDA events: the host issues one replay for many
  launches, so this reads the device's time per launch (the kernel plus
  the gap between two kernels of a graph).

Both warm up first and return milliseconds per launch. Needs a CUDA card.
"""

from __future__ import annotations

from typing import Callable

import torch


def event_ms(fn: Callable[[], object], iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], launches: int = 20, replays: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)
