"""End-to-end request deadlines and overload brownout (port of
``gofr_tpu/deadline.py``).

- **Deadlines.** ``X-Request-Deadline-Ms`` (default ``REQUEST_DEADLINE_S``)
  becomes a ``Deadline`` on a contextvar the batcher item and the decode
  pool's request capture at submit, so every stage reads one absolute
  monotonic budget and sheds work that can no longer succeed: the batcher
  at dequeue (stage ``queue``), the pool's admission when the budget cannot
  cover one chunk at the observed cadence (``admission``), and the decode
  loop at each chunk boundary (``decode``). A shed raises
  ``errors.DeadlineExceeded`` (504) and counts on
  ``gofr_tpu_deadline_exceeded_total{stage}``.
- **Priorities and brownout.** ``X-Priority`` (0 sheddable .. 9 protected,
  default ``PRIORITY_DEFAULT``) rides its own contextvar; the
  ``BrownoutController`` grades the queue depth and the committed KV blocks
  into a level (0, 1, 2) and sheds the lowest tiers first with a 429.
- **Cancellations.** ``gofr_tpu_cancellations_total{cause}`` counts a
  client abort (the SSE hook) and a mid-decode deadline expiry.

``clamp_spec_k`` is pooled speculation's draft width under the brownout
level and the deadline. Stdlib and ``errors`` only.
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Any, Callable, Optional

from gofr_tpu_torch.errors import HTTPError

# priority tiers: 0 (most sheddable) .. 9 (most protected)
PRIORITY_MIN = 0
PRIORITY_MAX = 9
PRIORITY_DEFAULT = 5

_current_deadline: contextvars.ContextVar[Optional["Deadline"]] = (
    contextvars.ContextVar("gofr_request_deadline", default=None)
)
# the tier rides its own var: a request can carry X-Priority without a
# deadline, and its flight record must still show the tier it sheds by
_current_priority: contextvars.ContextVar[Optional[int]] = (
    contextvars.ContextVar("gofr_request_priority", default=None)
)


def current_deadline() -> Optional["Deadline"]:
    """The in-flight request's deadline, if one is active."""
    return _current_deadline.get()


def activate_deadline(deadline: Optional["Deadline"]) -> Any:
    """Bind ``deadline`` as the current one (None clears); returns the
    reset token."""
    return _current_deadline.set(deadline)


def current_priority() -> Optional[int]:
    """The in-flight request's shed tier, if admission parsed one."""
    return _current_priority.get()


def activate_priority(priority: Optional[int]) -> Any:
    """Bind ``priority`` as the current tier (None clears)."""
    return _current_priority.set(priority)


class Deadline:
    """One request's absolute completion deadline and its shed priority,
    anchored on the monotonic clock (a wall-clock step never moves it)."""

    __slots__ = ("budget_s", "t_deadline", "priority")

    def __init__(self, budget_s: float, priority: int = PRIORITY_DEFAULT) -> None:
        self.budget_s = float(budget_s)
        self.t_deadline = time.perf_counter() + self.budget_s
        self.priority = int(priority)

    def remaining(self) -> float:
        """Seconds of budget left (negative once expired)."""
        return self.t_deadline - time.perf_counter()

    def expired(self) -> bool:
        return time.perf_counter() >= self.t_deadline

    def __repr__(self) -> str:
        return (f"Deadline(budget_s={self.budget_s:.3f}, "
                f"remaining_s={self.remaining():.3f}, priority={self.priority})")


def deadline_exceeded_counter(metrics: Any) -> Any:
    """The ONE registration of ``gofr_tpu_deadline_exceeded_total`` (every
    stage registers through here; the registry dedupes by name)."""
    return metrics.counter(
        "gofr_tpu_deadline_exceeded_total",
        "requests shed because their end-to-end deadline expired, by "
        "stage (queue: batcher dequeue; admission: pool/paged-KV "
        "submit; decode: mid-generation)",
        labels=("stage",),
    )


def cancellations_counter(metrics: Any) -> Any:
    """The ONE registration of ``gofr_tpu_cancellations_total``: the SSE
    abort hook, the decode pool and the echo runner."""
    return metrics.counter(
        "gofr_tpu_cancellations_total",
        "mid-flight generation cancellations by cause (client_abort: "
        "the SSE consumer vanished; deadline: the request's budget "
        "expired mid-decode)",
        labels=("cause",),
    )


def pool_reject_counter(metrics: Any) -> Any:
    """The ONE registration of ``gofr_tpu_pool_reject_total``: the decode
    pool's submit rejections by reason (each falls back to solo decode,
    but ``deadline``, which answers 504)."""
    return metrics.counter(
        "gofr_tpu_pool_reject_total",
        "decode-pool submit rejections (most reasons fall back to solo "
        "decode; deadline sheds with a 504)",
        labels=("reason",),
    )


def parse_priority(raw: Optional[str], default: int = PRIORITY_DEFAULT) -> int:
    """``X-Priority`` -> a 0-9 tier, clamped. A malformed value is a 400:
    a gateway stamping garbage must hear about it."""
    if raw is None or raw == "":
        return default
    try:
        priority = int(raw)
    except ValueError:
        raise HTTPError(
            400, '"X-Priority" must be an integer 0 (sheddable) to 9 (protected)'
        ) from None
    return max(PRIORITY_MIN, min(PRIORITY_MAX, priority))


def parse_deadline(raw_ms: Optional[str], default_s: float,
                   priority: int = PRIORITY_DEFAULT) -> Optional[Deadline]:
    """``X-Request-Deadline-Ms`` -> a ``Deadline``. The header wins; without
    it ``default_s`` (``REQUEST_DEADLINE_S``) applies, and 0 there means no
    deadline. A header of ``0`` opts one request out of the default."""
    if raw_ms is not None and raw_ms != "":
        try:
            ms = int(raw_ms)
        except ValueError:
            raise HTTPError(
                400, '"X-Request-Deadline-Ms" must be an integer millisecond budget '
                "(0 disables the deadline)"
            ) from None
        if ms < 0:
            raise HTTPError(400, '"X-Request-Deadline-Ms" must be >= 0')
        if ms == 0:
            return None
        return Deadline(ms / 1000.0, priority=priority)
    if default_s and default_s > 0:
        return Deadline(float(default_s), priority=priority)
    return None


def clamp_spec_k(
    k: int,
    brownout_level: int = 0,
    deadline: Optional[Any] = None,
    cadence_s: float = 0.0,
) -> int:
    """A request's adaptive draft width ``k`` under the serving clamps:

    - **brownout**: level 1 caps k at 1, level >= 2 turns speculation off
      (k = 0, plain decode): rejected drafts are wasted target compute, and
      overload is when that waste hurts co-tenants;
    - **deadline** (anything with ``remaining()`` seconds): a verify costs
      about one chunk at the observed ``cadence_s`` whatever k is, but a
      cycle under rejection emits one token, so a request whose budget
      covers fewer than ``k + 1`` cadence units speculates less: k is
      capped at ``remaining / cadence - 1`` (never below 0). No deadline,
      or no cadence sample yet, keeps the adaptive k."""
    if k <= 0:
        return 0
    if brownout_level >= 2:
        return 0
    if brownout_level >= 1:
        k = min(k, 1)
    if deadline is not None and cadence_s > 0:
        budget_chunks = int(deadline.remaining() / cadence_s)
        k = min(k, max(budget_chunks - 1, 0))
    return k


class BrownoutController:
    """Graded overload response from host-side signals, each armed when its
    threshold is > 0: the queue depth (the batcher's queue and displaced
    cohort items) against ``queue_hi``, and the COMMITTED paged-KV blocks
    (active rows and admission reservations over the ledger budget; cached
    prefix blocks evict on demand, so a warm idle server reads near 0)
    against ``kv_hi``, a fraction.

    A signal's level is 0 below its threshold, 1 at it, 2 at the hard mark
    (2 x ``queue_hi``; halfway from ``kv_hi`` to full for KV). The level is
    the max over the armed signals, re-read at most every ``refresh_s``.
    At level 1 a priority below ``shed_priority`` is shed (429); at level 2
    a priority at or below it is, and ``max_tokens`` clamps to
    ``clamp_tokens`` when set. Every threshold 0 = inert."""

    def __init__(
        self,
        metrics: Any = None,
        queue_hi: int = 0,
        kv_hi: float = 0.0,
        shed_priority: int = PRIORITY_DEFAULT,
        clamp_tokens: int = 0,
        queue_depth_fn: Optional[Callable[[], int]] = None,
        kv_util_fn: Optional[Callable[[], float]] = None,
        refresh_s: float = 0.2,
    ) -> None:
        self.queue_hi = int(queue_hi)
        self.kv_hi = float(kv_hi)
        self.shed_priority = int(shed_priority)
        self.clamp_tokens = int(clamp_tokens)
        self._queue_depth_fn = queue_depth_fn
        self._kv_util_fn = kv_util_fn
        self.refresh_s = refresh_s
        self._lock = threading.Lock()
        self._level = 0
        self._signals: dict[str, float] = {}
        self._evaluated_at = 0.0  # perf_counter mark of the last read
        self.sheds = 0  # brownout 429s
        self._level_gauge = self._shed_counter = None
        if metrics is not None:
            self._level_gauge = metrics.gauge(
                "gofr_tpu_brownout_level",
                "active overload-brownout level (0 normal, 1 shedding "
                "below-default-priority work, 2 shedding default-and-"
                "below + clamping max_tokens)",
            )
            self._shed_counter = metrics.counter(
                "gofr_tpu_brownout_shed_total",
                "requests 429d by the brownout controller, by the "
                "request's priority tier",
                labels=("priority",),
            )
            self._level_gauge.set(0.0)

    @property
    def armed(self) -> bool:
        return self.queue_hi > 0 or self.kv_hi > 0

    def _signal_levels(self) -> dict[str, float]:
        signals: dict[str, float] = {}
        if self.queue_hi > 0 and self._queue_depth_fn is not None:
            try:
                signals["queue_depth"] = float(self._queue_depth_fn())
            except Exception:
                pass  # a torn-down batcher mid-recovery: the signal is absent
        if self.kv_hi > 0 and self._kv_util_fn is not None:
            try:
                signals["kv_util"] = float(self._kv_util_fn())
            except Exception:
                pass
        return signals

    def level(self) -> int:
        """The current level (cached for ``refresh_s``)."""
        if not self.armed:
            return 0
        now = time.perf_counter()
        with self._lock:
            if now - self._evaluated_at < self.refresh_s:
                return self._level
            # marked before the reads: concurrent callers reuse this one
            self._evaluated_at = now
        signals = self._signal_levels()
        level = 0
        depth = signals.get("queue_depth")
        if depth is not None:
            if depth >= 2 * self.queue_hi:
                level = 2
            elif depth >= self.queue_hi:
                level = 1
        util = signals.get("kv_util")
        if util is not None:
            if util >= self.kv_hi + (1.0 - self.kv_hi) / 2.0:
                level = max(level, 2)
            elif util >= self.kv_hi:
                level = max(level, 1)
        with self._lock:
            self._level = level
            self._signals = signals
        if self._level_gauge is not None:
            self._level_gauge.set(float(level))
        return level

    def admit(self, priority: int, max_tokens: Optional[int] = None,
              ) -> tuple[bool, Optional[int], int]:
        """One request's verdict: ``(admitted, max_tokens, level)``;
        ``max_tokens`` is clamped only at level 2 with ``clamp_tokens``."""
        level = self.level()
        if level <= 0:
            return True, max_tokens, level
        floor = self.shed_priority
        if priority < floor if level == 1 else priority <= floor:
            with self._lock:
                self.sheds += 1
            if self._shed_counter is not None:
                self._shed_counter.inc(priority=str(priority))
            return False, max_tokens, level
        if level >= 2 and self.clamp_tokens and max_tokens is not None:
            max_tokens = min(max_tokens, self.clamp_tokens)
        return True, max_tokens, level

    def snapshot(self) -> dict[str, Any]:
        """``/admin/engine``'s brownout block: the level, the signals behind
        it, the thresholds and the sheds."""
        level = self.level()
        with self._lock:
            signals = dict(self._signals)
            sheds = self.sheds
        return {
            "armed": self.armed,
            "level": level,
            "signals": signals,
            "thresholds": {"queue_hi": self.queue_hi or None, "kv_hi": self.kv_hi or None},
            "shed_priority": self.shed_priority,
            "clamp_tokens": self.clamp_tokens or None,
            "sheds": sheds,
        }
