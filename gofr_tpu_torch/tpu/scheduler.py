"""Prefill/decode interference scheduler: the policy between the two
dispatchers that share one card.

Port of ``gofr_tpu/tpu/scheduler.py`` (``InterferenceScheduler``,
``POLICIES``). Without it the prefill ``DynamicBatcher`` and the
``DecodePool`` dispatch independently, and one long prompt's prefill stalls
every pooled stream behind it. Prompts over ``PREFILL_CHUNK_TOKENS``
prefill in bucket-sized slices (``device.py::_chunked_prefill``), and every
prefill dispatch (a batcher cohort or one slice) calls ``admit_prefill``,
which under load waits until decode has taken its turn. Decode is never
throttled: the pool only notes each chunk it dispatches. The card runs its
stream in issue order, so one bounded prefill per decode-chunk interval
bounds the gap between two decode chunks at about one prefill slice.

Policies (``SCHED_POLICY``): ``fair`` (default) admits at most one prefill
per decode-chunk interval while decode is busy; ``decode-first`` one per
two intervals; ``prefill-first`` never defers. Every wait is bounded by
``SCHED_MAX_DEFER_MS`` and by a decode-idleness horizon, so a stalled or
drained pool never starves prefill.

Telemetry: ``gofr_tpu_prefill_chunks_total`` counts admitted prefill
dispatches and ``gofr_tpu_sched_defer_seconds`` observes each one's wait
(``metrics``, labelled ``model``); the plain ``stats`` keep the same counts.
"""

from __future__ import annotations

import threading
import time
from typing import Any

POLICIES = ("decode-first", "prefill-first", "fair")


class InterferenceScheduler:
    """The small shared object both dispatchers consult.

    Decode side: ``note_decode_chunk(active)`` per pool dispatch and
    ``note_decode_idle()`` when the pool drains; cheap, never blocks.
    Prefill side: ``admit_prefill()`` before each bounded prefill dispatch;
    blocks (bounded) for a decode turn under load and returns the seconds
    deferred.
    """

    def __init__(
        self,
        policy: str = "fair",
        max_defer_ms: float = 1000.0,
        idle_after_s: float = 0.5,
        metrics: Any = None,
        model: str = "",
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"scheduler policy '{policy}' not supported — use one of {POLICIES}"
            )
        if max_defer_ms <= 0:
            raise ValueError("max_defer_ms must be > 0")
        self.policy = policy
        self._max_defer_s = max_defer_ms / 1000.0
        self._idle_after_s = idle_after_s
        self._cond = threading.Condition()
        self._decode_seq = 0  # decode chunk dispatches seen
        self._decode_active = 0  # active pool slots at the last note
        self._last_decode_t = 0.0
        self._last_admit_seq = 0  # decode seq at the last admitted prefill
        self._interval_ema = 0.0  # smoothed decode chunk cadence
        self.stats = {"prefill_chunks": 0, "deferred_chunks": 0, "decode_chunks": 0}
        self.model = model
        self._chunks_counter = self._defer_hist = None
        if metrics is not None:
            self._chunks_counter = metrics.counter(
                "gofr_tpu_prefill_chunks_total",
                "bounded-compute prefill dispatches admitted by the "
                "interference scheduler",
                labels=("model",),
            )
            self._defer_hist = metrics.histogram(
                "gofr_tpu_sched_defer_seconds",
                "time a prefill chunk waited for its decode-interleave turn",
                labels=("model",),
            )

    def snapshot(self) -> dict:
        """Policy, bound, decode cadence and the plain counters."""
        with self._cond:
            return {
                "policy": self.policy,
                "max_defer_ms": self._max_defer_s * 1000.0,
                "decode_active": self._decode_active,
                "decode_interval_ema_s": round(self._interval_ema, 6),
                **dict(self.stats),
            }

    # -- decode side (never blocks) ------------------------------------------
    def note_decode_chunk(self, active: int) -> None:
        """One pooled decode chunk dispatched with ``active`` live slots."""
        now = time.perf_counter()
        with self._cond:
            self._decode_seq += 1
            self.stats["decode_chunks"] += 1
            if self._last_decode_t:
                interval = now - self._last_decode_t
                self._interval_ema = (
                    interval if not self._interval_ema
                    else 0.8 * self._interval_ema + 0.2 * interval
                )
            self._last_decode_t = now
            self._decode_active = max(int(active), 0)
            self._cond.notify_all()

    def note_decode_idle(self) -> None:
        """The pool drained (or died): release any waiting prefill now."""
        with self._cond:
            self._decode_active = 0
            self._cond.notify_all()

    def _decode_busy(self, now: float) -> bool:
        """Under ``_cond``: is decode actively dispatching? A cadence older
        than the idleness horizon counts as quiet (a wedged pool must not
        starve prefill)."""
        if self._decode_active <= 0:
            return False
        horizon = max(self._idle_after_s, 8.0 * self._interval_ema)
        return (now - self._last_decode_t) < horizon

    # -- prefill side ---------------------------------------------------------
    def admit_prefill(self, tokens: int = 0) -> float:
        """Gate one bounded-compute prefill dispatch; returns the seconds
        it was deferred (0.0 when decode is idle or the policy never
        defers). ``tokens`` is accounting detail only."""
        start = time.perf_counter()
        if self.policy != "prefill-first":
            need = 2 if self.policy == "decode-first" else 1
            deadline = start + self._max_defer_s
            with self._cond:
                while True:
                    now = time.perf_counter()
                    if not self._decode_busy(now):
                        break
                    if self._decode_seq >= self._last_admit_seq + need:
                        break
                    remaining = deadline - now
                    if remaining <= 0:
                        break  # defer bound: prefill must keep progressing
                    # short poll cap: an idle transition without a
                    # note_decode_idle (pool wedged) must still release us
                    self._cond.wait(min(remaining, 0.05))
                self._last_admit_seq = self._decode_seq
        deferred = time.perf_counter() - start
        with self._cond:
            self.stats["prefill_chunks"] += 1
            if deferred > 0.0005:
                self.stats["deferred_chunks"] += 1
        if self._chunks_counter is not None:
            self._chunks_counter.inc(model=self.model)
            self._defer_hist.observe(deferred, model=self.model)
        return deferred
