"""Engine introspection: the dispatch timeline, the engine state machine
and the stall watchdog (port of ``gofr_tpu/tpu/introspect.py``), the
device-level mirror of the request flight recorder (``telemetry.py``).

- ``DispatchTimeline``: every dispatch (a batched prefill, a chunked
  prefill slice, a pooled decode chunk or verify, a boot warm-up stage, the
  device probe) gets a monotonic ``dispatch_id`` and a ``DispatchRecord``
  (kind, bucket, batch size, padded tokens, queued/running/done marks,
  MFU/MBU, the cost model's prediction and residual) in a bounded ring
  behind ``GET /admin/dispatches``. Flight records carry the ids they rode.
  The serving dispatchers also mark the host's side of each dispatch
  (``PHASES``), and the timeline keeps running totals of those phases by
  kind (``stats()``, ``GET /admin/engine``) and hands its closed records
  with their marks to a reader that polls (``since``).
- ``EngineState``: booting -> warming -> serving, degraded and wedged
  while a watched wait outlives its deadline, failed and closed; on
  ``GET /admin/engine``, in the readiness body (503 while degraded or
  wedged) and in the ``gofr_tpu_engine_state{state}`` gauge; and
  ``recovering`` while the recovery supervisor (``tpu/recovery.py``)
  rebuilds the stack. Listeners (the postmortem store, the supervisor) hear
  every transition.
- ``StallWatchdog``: a heartbeat thread over the watched waits
  (``WATCHDOG_DISPATCH_TIMEOUT_S``; armed at 120 s on its own when the
  device is ``cuda``). Past the deadline it counts
  ``gofr_tpu_device_stalls_total{kind}``, logs the stuck thread's stack and
  degrades the engine (wedged past ``timeout x wedge_factor``); the wait
  returning brings it back.

CUDA is asynchronous: a launch returns at once and the card's time shows
where the host waits for it (``HostFetch.wait``, a prefill's first-token
fetch). So the dispatchers watch, and close their records at, that wait:
a record's duration is the launches plus the card's work, and a kernel
that never ends hangs the watched wait, where the watchdog sees it.

Everything here runs without a card under ``MODEL_NAME=echo`` (the echo
runner's ``stall_hook`` wedges a prefill on purpose).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Iterator, Optional

DISPATCH_KINDS = (
    "prefill",          # one batched prefill dispatch (DynamicBatcher)
    "prefill_chunk",    # one bounded-compute chunked-prefill slice
    "decode_chunk",     # one pooled decode chunk (DecodePool)
    "warmup_compile",   # one boot-time warmup compile stage
    "device_probe",     # the boot's first touch of the card
)

ENGINE_STATES = (
    "booting",     # constructed; runtime not probed yet
    "warming",     # probe done / warmup compiles running
    "serving",     # ready; dispatches completing inside their deadline
    "degraded",    # >=1 dispatch past WATCHDOG_DISPATCH_TIMEOUT_S
    "wedged",      # a stalled dispatch outlived timeout x wedge_factor
    "recovering",  # the recovery supervisor quarantining and rebuilding the stack
    "failed",      # boot/recovery failed terminally (reinit may still fix)
    "closed",      # device closed
)

# the contextvar lets device code deep below a dispatcher (e.g. the
# device's run_batch under the batcher's dispatch thread) decorate the
# CURRENT dispatch record with values only it knows (per-dispatch MFU)
_current_dispatch: contextvars.ContextVar[Optional["DispatchRecord"]] = (
    contextvars.ContextVar("gofr_dispatch_record", default=None)
)


# the host's side of a dispatch, between its marks: ``queue`` t_queued ->
# t_running (the batcher's queue, the scheduler's gate), ``issue`` t_running
# -> t_issued (the launches: the host returned from the last), ``between``
# t_issued -> t_wait (the host at other work), ``wait`` t_wait -> t_synced
# (the host waits on the card's result), ``finish`` t_synced -> t_done (the
# delivery). A record with no host wait of its own (a prefill slice before
# the last) has no wait and no finish: its between runs to its close
PHASES = ("queue", "issue", "between", "wait", "finish")


def phase_seconds(t_queued: float, t_running: Optional[float], t_issued: Optional[float],
                  t_wait: Optional[float], t_synced: Optional[float],
                  t_done: Optional[float]) -> Optional[tuple]:
    """Seconds of each of ``PHASES`` from a record's marks, for a closed
    record whose dispatcher marked its issue; None otherwise. An unmarked
    wait (or sync) falls on the close."""
    if t_done is None or t_issued is None or t_running is None:
        return None
    wait = t_wait if t_wait is not None else t_done
    synced = t_synced if t_synced is not None else t_done
    return (t_running - t_queued, t_issued - t_running, wait - t_issued, synced - wait,
            t_done - synced)


def current_dispatch() -> Optional["DispatchRecord"]:
    """The dispatch record of the dispatch executing on this thread."""
    return _current_dispatch.get()


def activate_dispatch(record: Optional["DispatchRecord"]) -> Any:
    """Bind ``record`` as the thread's current dispatch (None clears —
    dispatch pool threads are reused, a leak would mislabel later work)."""
    return _current_dispatch.set(record)


class DispatchRecord:
    """One device dispatch's flight data. Single-writer (the dispatching
    thread); readers see monotonic set-once fields."""

    __slots__ = (
        "dispatch_id", "kind", "bucket", "batch_size", "padded_tokens",
        "tokens", "detail", "status", "wall_start", "t_queued", "t_running",
        "t_issued", "t_wait", "t_synced", "t_done", "mfu", "mbu", "predicted_ms", "residual_ratio",
        "cost_source", "anomaly", "adapter", "cost_path", "cost_judged", "cost_shared_ms",
        "graphed",
    )

    def __init__(
        self,
        dispatch_id: int,
        kind: str,
        bucket: int = 0,
        batch_size: int = 0,
        padded_tokens: int = 0,
        tokens: int = 0,
        detail: str = "",
        queued_at: Optional[float] = None,
        adapter: bool = False,
    ):
        self.dispatch_id = dispatch_id
        self.kind = kind
        self.bucket = bucket
        self.batch_size = batch_size
        self.padded_tokens = padded_tokens
        self.tokens = tokens
        self.detail = detail
        self.status = "running"
        # gofrlint: wall-clock — /admin/dispatches display ts (durations use t_*)
        self.wall_start = time.time()
        now = time.perf_counter()
        self.t_queued = queued_at if queued_at is not None else now
        # no external queue mark -> execution starts now (dispatchers
        # with a real queue phase pass queued_at and mark_running later)
        self.t_running: Optional[float] = None if queued_at is not None else now
        # the host's phase marks (``PHASES``), set once by the dispatchers
        # that mark them; a record without ``t_issued`` has no phases
        self.t_issued: Optional[float] = None
        self.t_wait: Optional[float] = None
        self.t_synced: Optional[float] = None
        self.t_done: Optional[float] = None
        self.mfu: Optional[float] = None
        self.mbu: Optional[float] = None
        # cost-model fields (tpu/costmodel.py): the roofline prediction
        # stamped at begin, the observed/predicted residual stamped at
        # finish, the sheet source behind them (analytic |
        # synthetic), and
        # the anomaly cause when this dispatch was flagged
        self.predicted_ms: Optional[float] = None
        self.residual_ratio: Optional[float] = None
        self.cost_source: Optional[str] = None
        self.anomaly: Optional[str] = None
        # the port's serving paths (costmodel.serving_path): whether the
        # dispatch carried an adapter slot, the path its sheet priced,
        # whether that path has a fitted row (an unfitted path is
        # predicted, never judged), and the predicted ms of the contending
        # dispatches that shared its run (``contends``): it is judged
        # against its own prediction plus theirs, the work it waits behind
        self.adapter = adapter
        self.cost_path: Optional[str] = None
        self.cost_judged = True
        self.cost_shared_ms = 0.0
        # a pool chunk: whether it was a replay of the captured CUDA graph
        # (None on every other dispatch)
        self.graphed: Optional[bool] = None

    def mark_running(self) -> None:
        """Device execution begins (after any scheduler-interleave wait)."""
        if self.t_running is None:
            self.t_running = time.perf_counter()

    def mark_issued(self) -> None:
        """The host returned from the dispatch's last launch."""
        if self.t_issued is None:
            self.t_issued = time.perf_counter()

    def mark_wait(self) -> None:
        """The host begins to wait on the card's result."""
        if self.t_wait is None:
            self.t_wait = time.perf_counter()

    def mark_synced(self) -> None:
        """The host's wait on the card's result ended."""
        if self.t_synced is None:
            self.t_synced = time.perf_counter()

    def phases(self) -> Optional[tuple]:
        """Seconds of each of ``PHASES`` (``phase_seconds``)."""
        return phase_seconds(self.t_queued, self.t_running, self.t_issued, self.t_wait,
                             self.t_synced, self.t_done)

    def marks(self) -> dict[str, Any]:
        """The record's raw ``perf_counter`` marks (None where unset)."""
        return {"dispatch_id": self.dispatch_id, "kind": self.kind, "status": self.status,
                "t_queued": self.t_queued, "t_running": self.t_running,
                "t_issued": self.t_issued, "t_wait": self.t_wait,
                "t_synced": self.t_synced, "t_done": self.t_done}

    @property
    def queue_wait(self) -> Optional[float]:
        if self.t_running is None:
            return None
        return self.t_running - self.t_queued

    @property
    def duration(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - (self.t_running or self.t_queued)

    def to_dict(self) -> dict[str, Any]:
        out = {
            "dispatch_id": self.dispatch_id,
            "kind": self.kind,
            "status": self.status,
            "bucket": self.bucket or None,
            "batch_size": self.batch_size or None,
            "padded_tokens": self.padded_tokens,
            "tokens": self.tokens,
            "detail": self.detail or None,
            "start_ts": self.wall_start,
            "queue_wait_s": self.queue_wait,
            "duration_s": self.duration,
            "mfu": self.mfu,
            "mbu": self.mbu,
            "predicted_ms": self.predicted_ms,
            "residual_ratio": self.residual_ratio,
            "cost_source": self.cost_source,
            "anomaly": self.anomaly,
        }
        if self.cost_path is not None:
            # the port's own fields, present only when a path's sheet priced it
            out["cost_path"] = self.cost_path
            out["cost_judged"] = self.cost_judged
            out["cost_shared_ms"] = self.cost_shared_ms
        if self.graphed is not None:
            out["graphed"] = self.graphed  # the port's own, on pool chunks
        phases = self.phases()
        if phases is not None:
            # the port's own fields, present once a marking dispatcher closed it
            out["issue_s"], out["wait_s"], out["finish_s"] = phases[1], phases[3], phases[4]
        return out


@contextlib.contextmanager
def host_wait(record: Optional[DispatchRecord]) -> Iterator[None]:
    """Mark the block as ``record``'s host wait on the card's result: its
    wait begins on entry and its sync when the block ends (a wait that
    raises leaves no sync). A no-op without a record."""
    if record is None:
        yield
        return
    record.mark_wait()
    yield
    record.mark_synced()


PREFILL_KINDS = ("prefill", "prefill_chunk")


def contends(a: DispatchRecord, b: DispatchRecord) -> bool:
    """Whether two dispatches priced on serving paths, in flight at once,
    spend each other's time: a prefill (a batch, a request's slice or
    tail) beside any other dispatch. Each record's wall time runs until
    its host sync, which waits for all the work enqueued ahead of it on
    the one stream (a pool chunk or verify behind a prefill's forward, a
    prefill behind the pipelined chunks), and their launches share the
    host. Pool dispatches overlap each other by design (pipelining), and
    a path's row is fitted on that. Each of two that contend adds the
    other's prediction to its ``cost_shared_ms``."""
    if a.cost_path is None or b.cost_path is None:
        return False
    return a.kind in PREFILL_KINDS or b.kind in PREFILL_KINDS


class DispatchTimeline:
    """Bounded, thread-safe ring of DispatchRecords with monotonic ids.

    Records land in the ring at ``begin`` (status "running"), so an
    in-flight — including a WEDGED — dispatch is visible on
    ``/admin/dispatches`` while it hangs; ``finish`` stamps the terminal
    mark in place and is idempotent (error paths and success paths may
    both reach it)."""

    def __init__(
        self, capacity: int = 512, metrics: Any = None, costmodel: Any = None
    ):
        # the dispatch cost model (tpu/costmodel.py), when wired: begin
        # stamps each record's roofline prediction, finish runs residual
        # and anomaly accounting — this timeline is the SINGLE
        # predict→observe chokepoint every dispatcher already flows
        # through (batcher, chunked prefill, decode pool, spec verify)
        self.costmodel = costmodel
        self._ids = itertools.count(1)
        self._ring: "deque[DispatchRecord]" = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._by_kind: dict[str, int] = {}
        self._in_flight: dict[int, DispatchRecord] = {}
        # kind -> [closed marked records, then seconds of each of PHASES]
        self._phase_totals: dict[str, list] = {}
        if metrics is not None:
            self._count = metrics.counter(
                "gofr_tpu_dispatches_total",
                "device dispatches by kind (prefill, prefill_chunk, "
                "decode_chunk, warmup_compile, device_probe)",
                labels=("kind",),
            )
            self._dur = metrics.histogram(
                "gofr_tpu_dispatch_seconds",
                "device dispatch duration (running -> done)",
                labels=("kind",),
            )
        else:
            self._count = self._dur = None

    def begin(
        self,
        kind: str,
        bucket: int = 0,
        batch_size: int = 0,
        padded_tokens: int = 0,
        tokens: int = 0,
        detail: str = "",
        queued_at: Optional[float] = None,
        adapter: bool = False,
    ) -> DispatchRecord:
        record = DispatchRecord(
            next(self._ids), kind, bucket=bucket, batch_size=batch_size,
            padded_tokens=padded_tokens, tokens=tokens, detail=detail,
            queued_at=queued_at, adapter=adapter,
        )
        if self.costmodel is not None:
            self.costmodel.annotate(record)
        with self._lock:
            for other in self._in_flight.values():
                if contends(record, other):
                    record.cost_shared_ms += other.predicted_ms
                    other.cost_shared_ms += record.predicted_ms
            self._ring.append(record)
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            self._in_flight[record.dispatch_id] = record
        if self._count is not None:
            self._count.inc(kind=kind)
        return record

    def finish(self, record: DispatchRecord, status: str = "ok") -> None:
        if record.t_done is not None:
            return  # idempotent: first finish wins
        record.mark_running()  # a dispatch that never ran still closes
        record.t_done = time.perf_counter()
        record.status = status
        phases = record.phases()
        with self._lock:
            self._in_flight.pop(record.dispatch_id, None)
            if phases is not None:
                totals = self._phase_totals.get(record.kind)
                if totals is None:
                    totals = self._phase_totals[record.kind] = [0] + [0.0] * len(PHASES)
                totals[0] += 1
                for i, seconds in enumerate(phases, 1):
                    totals[i] += seconds
        if self._dur is not None:
            self._dur.observe(record.duration or 0.0, kind=record.kind)
        if self.costmodel is not None:
            self.costmodel.observe(record)

    # -- read side (admin API) ------------------------------------------------
    def records(
        self, limit: int = 100, kind: Optional[str] = None
    ) -> list[dict[str, Any]]:
        """Most-recent-first record dicts, optionally filtered by kind."""
        with self._lock:
            snapshot = list(self._ring)
        out: list[dict[str, Any]] = []
        for record in reversed(snapshot):
            if kind is not None and record.kind != kind:
                continue
            out.append(record.to_dict())
            if len(out) >= limit:
                break
        return out

    def since(self, dispatch_id: int) -> list[dict[str, Any]]:
        """The closed records newer than ``dispatch_id``, oldest first,
        with their marks (``DispatchRecord.marks``), up to the first that
        still runs: a reader that passes the last id it got misses none
        that the ring still held."""
        with self._lock:
            newer = [r for r in self._ring if r.dispatch_id > dispatch_id]
        out = []
        for record in newer:
            if record.t_done is None:
                break
            out.append(record.marks())
        return out

    def stats(self) -> dict[str, Any]:
        with self._lock:
            out: dict[str, Any] = {
                "total": sum(self._by_kind.values()),
                "by_kind": dict(self._by_kind),
                "in_flight": len(self._in_flight),
            }
            if self._phase_totals:
                # the port's own totals, present once a marked record closed:
                # per kind, the closed marked records and each phase's seconds
                out["phases"] = {
                    kind: {"n": t[0], **{f"{p}_s": t[i] for i, p in enumerate(PHASES, 1)}}
                    for kind, t in self._phase_totals.items()
                }
            return out


class EngineState:
    """Explicit engine state machine, mirrored into the
    ``gofr_tpu_engine_state{state}`` gauge (1 for the current state) and
    a bounded transition history for ``/admin/engine``."""

    def __init__(self, metrics: Any = None, logger: Any = None):
        self._lock = threading.Lock()
        self.state = "booting"
        self._detail = ""
        # gofrlint: wall-clock — /admin/engine "since"/history ts (display)
        self._since = time.time()
        self._history: "deque[dict[str, Any]]" = deque(maxlen=64)
        self._logger = logger
        self._listeners: list[Any] = []
        self._gauge = (
            metrics.gauge(
                "gofr_tpu_engine_state",
                "engine state machine (1 for the current state): booting, "
                "warming, serving, degraded, wedged, recovering, failed, "
                "closed",
                labels=("state",),
            )
            if metrics is not None else None
        )
        self._history.append(
            {"state": "booting", "ts": self._since, "detail": ""}
        )
        self._set_gauge("booting")

    def _set_gauge(self, state: str) -> None:
        if self._gauge is None:
            return
        for s in ENGINE_STATES:
            self._gauge.set(1.0 if s == state else 0.0, state=s)

    def add_listener(self, fn: Any) -> None:
        """Register ``fn(state, detail)``, called after every completed
        transition outside the engine lock. A listener must be quick (the
        postmortem store hands its write to a thread); one that raises is
        logged and skipped."""
        with self._lock:
            self._listeners.append(fn)

    def transition(self, state: str, detail: str = "") -> None:
        if state not in ENGINE_STATES:
            raise ValueError(
                f"engine state '{state}' unknown — one of {ENGINE_STATES}"
            )
        with self._lock:
            if state == self.state:
                self._detail = detail or self._detail
                return
            self.state = state
            self._detail = detail
            # gofrlint: wall-clock — /admin/engine "since"/history ts (display)
            self._since = time.time()
            self._history.append(
                {"state": state, "ts": self._since, "detail": detail}
            )
            # inside the lock: two racing transitions must not interleave
            # their per-state gauge writes (the metric lock is a leaf)
            self._set_gauge(state)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(state, detail)
            except Exception as exc:
                if self._logger is not None:
                    self._logger.warnf("engine state listener failed on -> %s: %r", state, exc)
        if self._logger is not None:
            log = (
                self._logger.warnf if state in ("degraded", "wedged", "failed")
                else self._logger.infof
            )
            log("engine state -> %s%s", state, f" ({detail})" if detail else "")

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "state": self.state,
                "detail": self._detail or None,
                "since": self._since,
                "history": list(self._history),
            }


class _Watch:
    __slots__ = ("kind", "dispatch_id", "thread_ident", "thread_name",
                 "started", "flagged", "wedged")

    def __init__(self, kind: str, dispatch_id: int):
        self.kind = kind
        self.dispatch_id = dispatch_id
        thread = threading.current_thread()
        self.thread_ident = thread.ident
        self.thread_name = thread.name
        self.started = time.perf_counter()
        self.flagged = False
        self.wedged = False


class StallWatchdog:
    """Deadline heartbeat over in-flight dispatches.

    Dispatchers wrap device work in ``watch(kind, dispatch_id)``; a
    daemon thread scans the registered entries every ``poll`` interval.
    Past ``timeout_s`` a dispatch is a STALL: the stall counter
    increments, the stuck thread's stack is dumped to the log (the data
    that explains a wedged wait), and the engine flips to
    ``degraded`` — then ``wedged`` once the stall outlives
    ``timeout_s x wedge_factor``. The dispatch completing (however late)
    flips the engine back to the state it held before the stall.

    ``timeout_s <= 0`` disables: ``watch`` degrades to a no-op context
    manager and no thread runs. ``arm`` enables later (the device arms
    itself after probing a ``cuda`` device when the operator set no
    ``WATCHDOG_DISPATCH_TIMEOUT_S``)."""

    def __init__(
        self,
        engine: EngineState,
        metrics: Any = None,
        logger: Any = None,
        timeout_s: float = 0.0,
        wedge_factor: float = 3.0,
    ):
        if wedge_factor < 1.0:
            raise ValueError("wedge_factor must be >= 1.0")
        self.engine = engine
        self.logger = logger
        self.timeout_s = float(timeout_s)
        self.wedge_factor = wedge_factor
        self._entries: dict[int, _Watch] = {}
        # the last recovery's quarantined entries: evidence that outlives
        # the quarantine
        self._quarantined: list[dict[str, Any]] = []
        self._tokens = itertools.count(1)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pre_stall_state = "serving"
        # plain counts next to the Prometheus counter so snapshots and
        # tests read stall history without scraping the registry
        self.stall_counts: dict[str, int] = {}
        self._stalls = (
            metrics.counter(
                "gofr_tpu_device_stalls_total",
                "dispatches that exceeded WATCHDOG_DISPATCH_TIMEOUT_S "
                "(the engine degrades/wedges while one is in flight)",
                labels=("kind",),
            )
            if metrics is not None else None
        )
        if self.timeout_s > 0:
            self._start()

    # -- lifecycle ------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0 and not self._stop.is_set()

    def _poll_interval(self) -> float:
        return max(0.01, min(self.timeout_s / 4.0, 1.0))

    def _start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gofr-watchdog", daemon=True
        )
        self._thread.start()

    def arm(self, timeout_s: float) -> None:
        """Enable (or retune) the deadline; idempotent."""
        if timeout_s <= 0:
            return
        self.timeout_s = float(timeout_s)
        self._start()

    def close(self) -> None:
        self._stop.set()

    # -- dispatch side --------------------------------------------------------
    @contextlib.contextmanager
    def watch(self, kind: str, dispatch_id: int = 0) -> Iterator[None]:
        """Register the calling thread's dispatch for deadline scanning
        for the duration of the with-block."""
        if not self.enabled:
            yield
            return
        entry = _Watch(kind, dispatch_id)
        token = next(self._tokens)
        with self._lock:
            self._entries[token] = entry
        try:
            yield
        finally:
            self._unwatch(token, entry)

    def _unwatch(self, token: int, entry: _Watch) -> None:
        # pop, flag-check, AND the recovery transition all under the
        # watchdog lock: the scanner serializes on the same lock before
        # flagging, so a completing dispatch either wins the pop (never
        # flagged) or observes its flag here and recovers the engine —
        # no interleaving can strand the engine in degraded. Lock order
        # is watchdog -> engine; the engine lock is a leaf.
        elapsed = time.perf_counter() - entry.started
        recovered = False
        with self._lock:
            self._entries.pop(token, None)
            if entry.flagged:
                recovered = True
                still_stalled = any(
                    e.flagged for e in self._entries.values()
                )
                if not still_stalled and self.engine.state in (
                    "degraded", "wedged"
                ):
                    self.engine.transition(
                        self._pre_stall_state,
                        f"{entry.kind} dispatch {entry.dispatch_id} "
                        f"recovered after {elapsed:.1f}s",
                    )
        if recovered and self.logger is not None:
            self.logger.warnf(
                "watchdog: %s dispatch %d recovered after %.1fs",
                entry.kind, entry.dispatch_id, elapsed,
            )

    def quarantine(self) -> list[dict[str, Any]]:
        """The recovery supervisor's step: forget every flagged (stalled)
        entry and return their descriptions. The stuck thread may never
        return, but its entry must not hold the rebuilt engine degraded;
        when it does return, its ``_unwatch`` pops nothing and moves the
        engine only if it still reads degraded or wedged."""
        quarantined: list[dict[str, Any]] = []
        with self._lock:
            for token, entry in list(self._entries.items()):
                if entry.flagged:
                    quarantined.append({
                        "kind": entry.kind,
                        "dispatch_id": entry.dispatch_id,
                        "thread": entry.thread_name,
                        "elapsed_s": round(time.perf_counter() - entry.started, 3),
                    })
                    self._entries.pop(token, None)
            if quarantined:
                self._quarantined = quarantined
        return quarantined

    # -- heartbeat ------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self._poll_interval()):
            self._scan()

    def _scan(self) -> None:
        now = time.perf_counter()
        with self._lock:
            entries = list(self._entries.items())
            timeout = self.timeout_s
        for token, entry in entries:
            elapsed = now - entry.started
            if not entry.flagged and elapsed > timeout:
                if self._flag_stall(token, entry, elapsed):
                    self._log_stall(entry, elapsed)
            elif (
                entry.flagged and not entry.wedged
                and elapsed > timeout * self.wedge_factor
            ):
                self._flag_wedge(token, entry, elapsed, timeout)

    def _flag_stall(self, token: int, entry: _Watch, elapsed: float) -> bool:
        """Flag one overdue entry. The membership re-check and the
        engine transition happen under the watchdog lock: a dispatch
        that completed since the scan snapshot was popped by _unwatch
        (membership fails, nothing flagged) — flagging a finished
        dispatch would degrade the engine with nothing left to recover
        it. Returns True when the stall was recorded."""
        with self._lock:
            if self._entries.get(token) is not entry:
                return False  # completed between snapshot and flag
            entry.flagged = True
            self.stall_counts[entry.kind] = (
                self.stall_counts.get(entry.kind, 0) + 1
            )
            if self.engine.state not in ("degraded", "wedged"):
                self._pre_stall_state = self.engine.state
            self.engine.transition(
                "degraded",
                f"{entry.kind} dispatch {entry.dispatch_id} stalled "
                f"{elapsed:.1f}s (deadline {self.timeout_s:.1f}s)",
            )
        if self._stalls is not None:
            self._stalls.inc(kind=entry.kind)
        return True

    def _flag_wedge(
        self, token: int, entry: _Watch, elapsed: float, timeout: float
    ) -> None:
        with self._lock:
            if self._entries.get(token) is not entry:
                return  # completed: _unwatch already recovered the engine
            entry.wedged = True
            self.engine.transition(
                "wedged",
                f"{entry.kind} dispatch {entry.dispatch_id} stalled "
                f"{elapsed:.1f}s (> {self.wedge_factor:.0f}x the "
                f"{timeout:.1f}s deadline)",
            )

    def _log_stall(self, entry: _Watch, elapsed: float) -> None:
        """The stuck thread's stack — outside the lock (formatting a
        deep stack is not watchdog-critical-path work)."""
        if self.logger is None:
            return
        self.logger.errorf(
            "watchdog: %s dispatch %d stalled %.1fs on thread %s:\n%s",
            entry.kind, entry.dispatch_id, elapsed, entry.thread_name,
            self._stack_of(entry.thread_ident),
        )

    @staticmethod
    def _stack_of(thread_ident: Optional[int]) -> str:
        """The stuck thread's current stack — what turns 'it hangs' into
        'it hangs inside THIS call'."""
        frame = sys._current_frames().get(thread_ident or -1)
        if frame is None:
            return "<thread gone>"
        return "".join(traceback.format_stack(frame))

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            watching = [
                {
                    "kind": e.kind,
                    "dispatch_id": e.dispatch_id,
                    "elapsed_s": round(time.perf_counter() - e.started, 3),
                    "stalled": e.flagged,
                }
                for e in self._entries.values()
            ]
            counts = dict(self.stall_counts)
            quarantined = list(self._quarantined)
        return {
            "enabled": self.enabled,
            "timeout_s": self.timeout_s if self.enabled else None,
            "wedge_factor": self.wedge_factor,
            "stalls": counts,
            "watching": watching,
            # the last recovery's quarantined dispatches
            "quarantined": quarantined,
        }
