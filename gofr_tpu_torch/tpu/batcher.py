"""Deadline-based dynamic batcher in front of a runner's batched forward
(a decoder's prefill, the encoder's embeddings, the MLP).

Trimmed copy of ``gofr_tpu/tpu/batcher.py::DynamicBatcher``: requests
enqueue (payload, Future) on a bounded queue (overflow is a 429); a worker
thread takes the first request and drains more until ``max_batch`` or
``timeout_ms`` past the FIRST request's arrival; with a ``bucket_fn`` the
drained batch splits into per-bucket cohorts and the fullest dispatches
(the rest wait for the next round; ``cohort=False`` dispatches the drained
batch whole, mixed lengths padded to its largest bucket); dispatches run on a small pool so one
batch's host work overlaps the next. With a ``scheduler``
(``tpu/scheduler.py``) each dispatch first waits for its turn between
pooled decode chunks. ``infer`` blocks (60 s by default, as in the JAX
package); ``infer_async`` awaits. With ``metrics`` it keeps the JAX batcher's
families, labelled ``model``: ``gofr_tpu_batch_size`` and
``gofr_tpu_queue_wait_seconds`` (each dispatch), ``gofr_tpu_queue_depth``
(each submit and dispatch), ``gofr_tpu_prefill_padded_tokens_total``
(bucket width minus true length, with a ``bucket_fn``) and
``gofr_tpu_deadline_exceeded_total{stage="queue"}``: an item carries the
request's deadline (``deadline.current_deadline`` at submit), and one that
expired while queued is shed at dequeue (and again just before its
dispatch) with a 504 ``DeadlineExceeded``, never dispatched; an item whose
future was cancelled is skipped there. With a ``timeline``
(``tpu/introspect.py``) each dispatch is a ``prefill`` record, queued at
its oldest item's arrival, running from the scheduler's gate, done when
``run_batch`` returns (a runner on the card ends it with its host sync,
so the record covers the card's work), and active on the dispatch thread
(``current_dispatch``) so the runner can stamp its MFU; each item's flight
record (captured at submit) gets its enqueue and dispatch marks, the cohort,
the dispatch id, the prefill chunk and the scheduler's defer. With a
``watchdog`` the call runs under its deadline. Tracing spans of the JAX
package are not ported yet. ``verify_width`` and its ladder
cohort pooled speculation's verify widths.
"""

from __future__ import annotations

import asyncio
import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from typing import Any, Callable, Optional, Sequence

import numpy as np

from gofr_tpu_torch.deadline import current_deadline, deadline_exceeded_counter
from gofr_tpu_torch.errors import DeadlineExceeded, TooManyRequestsError
from gofr_tpu_torch.telemetry import current_record
from gofr_tpu_torch.tpu.introspect import activate_dispatch


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def verify_width(max_k: int, k_max: int) -> int:
    """A pooled-spec verify's token width on the pow2 ladder: the dispatch
    carries ``max_k`` drafts + 1 pending token per row; the width rounds up
    to the next power of two (clamped at ``k_max + 1``, the widest a cycle
    can need), so the pool runs a handful of shapes. Rows with shorter
    drafts pad to it; their surplus positions verify as garbage, masked by
    the per-row acceptance as bucket padding is masked by lengths."""
    if max_k < 0:
        raise ValueError(f"max_k must be >= 0, got {max_k}")
    return min(next_pow2(max_k + 1), k_max + 1)


def verify_width_ladder(k_max: int) -> tuple[int, ...]:
    """Every width a dispatched spec cycle can need for ``k_max``, the
    shapes the pool warms at construction. Starts at 2: the worker never
    dispatches a zero-draft cycle (it falls back to the plain chunk)."""
    widths = []
    w = 2
    while w < k_max + 1:
        widths.append(w)
        w *= 2
    widths.append(k_max + 1)
    return tuple(sorted(set(widths)))


def pad_rows(rows: list[np.ndarray], target: int) -> np.ndarray:
    """Stack [n, ...] rows and pad the batch dim to ``target`` by repeating
    the last row (a padded batch does the work of a real one of its size)."""
    stacked = np.stack(rows)
    if len(rows) < target:
        pad = np.repeat(stacked[-1:], target - len(rows), axis=0)
        stacked = np.concatenate([stacked, pad], axis=0)
    return stacked


def pack_token_rows(
    rows: Sequence[np.ndarray], n_rows: int, width: int, pad_id: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length id rows into [n_rows, width] plus per-row kept
    lengths. Overlong rows keep their LAST tokens."""
    out = np.full((n_rows, width), pad_id, np.int32)
    out_lens = np.zeros(n_rows, np.int32)
    for i, row in enumerate(rows):
        ids = np.asarray(row, np.int32).reshape(-1)[-width:]
        out[i, : ids.size] = ids
        out_lens[i] = ids.size
    return out, out_lens


class _Item:
    __slots__ = ("payload", "future", "arrival", "record", "deadline")

    def __init__(self, payload: Any):
        self.payload = payload
        self.future: Future = Future()
        self.arrival = time.perf_counter()
        # the caller's flight record and deadline ride the item to the
        # worker and the dispatch thread
        self.record = current_record()
        self.deadline = current_deadline()
        if self.record is not None:
            self.record.mark_enqueue()


class DynamicBatcher:
    """Batches ``run_batch(list_of_payloads) -> list_of_results`` calls;
    ``run_batch`` pads internally and returns one result per payload."""

    def __init__(
        self,
        run_batch: Callable[[list[Any]], Sequence[Any]],
        max_batch: int = 8,
        timeout_ms: float = 5.0,
        max_queue: int = 256,
        name: str = "default",
        pipeline_depth: int = 2,
        bucket_fn: Optional[Callable[[Any], int]] = None,
        scheduler: Any = None,
        cohort: bool = True,
        metrics: Any = None,
        timeline: Any = None,
        watchdog: Any = None,
    ):
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.pipeline_depth = max(1, pipeline_depth)
        self.timeout_s = timeout_ms / 1000.0
        self.bucket_fn = bucket_fn
        self.scheduler = scheduler
        self.cohort = cohort
        self.timeline = timeline
        self.watchdog = watchdog
        self.dispatches = 0  # batches handed to run_batch
        self._count_lock = threading.Lock()
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=max(1, pipeline_depth), thread_name_prefix=f"gofr-dispatch-{name}"
        )
        self._queue: "queue.Queue[Optional[_Item]]" = queue.Queue(maxsize=max_queue)
        self._pending: "deque[_Item]" = deque()
        self._closed = False
        self.name = name
        self._batch_hist = self._queue_gauge = self._wait_hist = None
        self._padded_counter = self._deadline_counter = None
        if metrics is not None:
            self._batch_hist = metrics.histogram(
                "gofr_tpu_batch_size", "dispatched batch sizes",
                labels=("model",), buckets=(1, 2, 4, 8, 16, 32, 64, 128),
            )
            self._queue_gauge = metrics.gauge(
                "gofr_tpu_queue_depth", "requests waiting for a batch", labels=("model",)
            )
            self._wait_hist = metrics.histogram(
                "gofr_tpu_queue_wait_seconds", "time from enqueue to dispatch",
                labels=("model",),
            )
            if bucket_fn is not None:
                self._padded_counter = metrics.counter(
                    "gofr_tpu_prefill_padded_tokens_total",
                    "pad tokens dispatched in prefill batches "
                    "(bucket width minus true length, summed per cohort)",
                    labels=("model",),
                )
            self._deadline_counter = deadline_exceeded_counter(metrics)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"gofr-batcher-{name}"
        )
        self._thread.start()

    def submit(self, payload: Any) -> Future:
        if self._closed:
            raise RuntimeError("batcher is closed")
        item = _Item(payload)
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            raise TooManyRequestsError("inference queue is full") from None
        if self._queue_gauge is not None:
            self._queue_gauge.set(self._depth(), model=self.name)
        return item.future

    def infer(self, payload: Any, timeout: float = 60.0) -> Any:
        """Blocking call for sync handlers."""
        return self.submit(payload).result(timeout=timeout)

    async def infer_async(self, payload: Any) -> Any:
        """Awaitable call for async handlers."""
        return await asyncio.wrap_future(self.submit(payload))

    def _run(self) -> None:
        pending = self._pending
        while True:
            if pending:
                first = pending.popleft()
            else:
                try:
                    first = self._queue.get(timeout=0.5)
                except queue.Empty:
                    if self._closed:
                        return
                    continue
                if first is None:
                    return
            if not self._viable(first):
                continue  # shed or skipped at dequeue: it holds no batch open
            batch = [first]
            deadline = first.arrival + self.timeout_s
            closing = False
            while len(batch) < self.max_batch:
                if pending:
                    item = pending.popleft()
                    if self._viable(item):
                        batch.append(item)
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    closing = True
                    break
                if self._viable(item):
                    batch.append(item)
            # an item can expire (or be cancelled) during the drain wait:
            # it must not take a cohort slot or pad tokens
            batch = [item for item in batch if self._viable(item)]
            if batch:
                cohort, rest = self._form_cohort(batch)
                pending.extend(rest)
                self._dispatch_pool.submit(self._dispatch, cohort)
            if closing:
                while pending:
                    cohort, rest = self._form_cohort(list(pending))
                    pending.clear()
                    pending.extend(rest)
                    self._dispatch_pool.submit(self._dispatch, cohort)
                return

    def _viable(self, item: _Item) -> bool:
        """The dequeue gate: False for an item that must not dispatch. A
        cancelled or resolved future is skipped; an item whose deadline
        expired while queued is shed: its future fails with
        ``DeadlineExceeded`` (stage ``queue``), the stage counter and its
        flight record learn it, and the device never sees it."""
        future = item.future
        if future.cancelled() or future.done():
            return False
        if item.deadline is not None and item.deadline.expired():
            if item.record is not None:
                item.record.note_shed("queue")
            if self._deadline_counter is not None:
                self._deadline_counter.inc(stage="queue")
            waited = time.perf_counter() - item.arrival
            try:
                future.set_exception(DeadlineExceeded(
                    f"deadline expired after {waited * 1000:.0f} ms in the batch queue "
                    f"(budget {item.deadline.budget_s * 1000:.0f} ms)", stage="queue",
                ))
            except InvalidStateError:
                pass  # cancelled meanwhile: it must not dispatch either way
            return False
        return True

    def _form_cohort(self, batch: list[_Item]) -> tuple[list[_Item], list[_Item]]:
        """Split a drained batch by bucket and pick the fullest cohort (ties
        go to the one holding the oldest item). Returns (cohort, displaced);
        with ``cohort`` off the whole batch dispatches in FIFO order."""
        if self.bucket_fn is None or not self.cohort or len(batch) <= 1:
            return batch, []
        groups: dict[int, list[_Item]] = {}
        for item in batch:
            groups.setdefault(self.bucket_fn(item.payload), []).append(item)
        if len(groups) <= 1:
            return batch, []
        chosen = max(groups.values(), key=lambda g: (len(g), -min(i.arrival for i in g)))
        keep = set(map(id, chosen))
        return chosen, [i for i in batch if id(i) not in keep]

    def _depth(self) -> int:
        """Requests waiting for a batch: the queue plus the items cohort
        formation displaced into the worker's pending buffer."""
        return self._queue.qsize() + len(self._pending)

    def _note_dispatch(self, batch: list[_Item]) -> tuple[int, Any]:
        """The dispatch's metrics (batch size, queue depth, each item's
        wait, the pad tokens its bucket burns), its timeline record (queued
        at the oldest item's arrival) and the items' dispatch marks; returns
        (bucket, record): bucket 0 without a ``bucket_fn``, record None
        without a timeline."""
        now = time.perf_counter()
        if self._batch_hist is not None:
            self._batch_hist.observe(len(batch), model=self.name)
            self._queue_gauge.set(self._depth(), model=self.name)
            for item in batch:
                self._wait_hist.observe(now - item.arrival, model=self.name)
        bucket = padded = 0
        if self.bucket_fn is not None:
            bucket = max(self.bucket_fn(item.payload) for item in batch)
            padded = sum(
                max(bucket - min(int(getattr(i.payload, "size", 0) or 0), bucket), 0)
                for i in batch
            )
            if padded and self._padded_counter is not None:
                self._padded_counter.inc(padded, model=self.name)
        drec = None
        if self.timeline is not None:
            drec = self.timeline.begin(
                "prefill", bucket=bucket, batch_size=len(batch), padded_tokens=padded,
                queued_at=min(item.arrival for item in batch),
            )
        for item in batch:
            if item.record is not None:
                item.record.mark_dispatch(len(batch))
                if drec is not None:
                    item.record.note_dispatch_id(drec.dispatch_id)
        return bucket, drec

    def _dispatch(self, batch: list[_Item]) -> None:
        # the last shed before the card: a batch can wait for a dispatch
        # thread long enough for a member to expire
        batch = [item for item in batch if self._viable(item)]
        if not batch:
            return
        with self._count_lock:
            self.dispatches += 1
        drec = None
        try:
            bucket, drec = self._note_dispatch(batch)
            if self.bucket_fn is not None:
                # one batched prefill is one bounded-compute chunk: wait
                # for its turn between pooled decode chunks
                defer = (
                    self.scheduler.admit_prefill(bucket * len(batch))
                    if bucket and self.scheduler is not None else 0.0
                )
                for item in batch:
                    if item.record is not None:
                        item.record.note_prefill_chunk(bucket=bucket)
                        if defer:
                            item.record.note_sched_defer(defer)
            if drec is not None:
                # running from the scheduler's gate; the runner stamps the
                # record it finds active on this thread
                drec.mark_running()
                activate_dispatch(drec)
            with self._watch(drec):
                results = self.run_batch([item.payload for item in batch])
            self._finish_record(drec)
        except Exception as exc:
            self._finish_record(drec, status="error")
            for item in batch:
                if not item.future.cancelled():
                    item.future.set_exception(exc)
            return
        finally:
            # a record left active on this reused pool thread would label
            # later work; finish is idempotent, so this only closes a record
            # a BaseException left running
            if drec is not None:
                activate_dispatch(None)
                self._finish_record(drec, status="error")
        for item, result in zip(batch, results):
            if drec is not None and drec.anomaly and item.record is not None:
                # the cost model flagged this dispatch at finish
                item.record.note_anomaly(drec.dispatch_id)
            if not item.future.cancelled():
                item.future.set_result(result)

    def _finish_record(self, drec: Any, status: str = "ok") -> None:
        if drec is not None:
            self.timeline.finish(drec, status=status)

    def _watch(self, drec: Any) -> Any:
        """The stall watchdog's deadline over one batched forward (a no-op
        without a watchdog)."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.watch("prefill", drec.dispatch_id if drec is not None else 0)

    def close(self) -> None:
        self._closed = True
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=2.0)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(RuntimeError("batcher closed"))
        self._dispatch_pool.shutdown(wait=False)
