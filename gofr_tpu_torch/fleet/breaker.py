"""Per-replica circuit breaker: consecutive-failure open, timed
half-open probe, close on probe success.

The breaker answers a different question than the health prober
(``fleet/replica.py``): the prober asks "does the replica SAY it is
ready", the breaker asks "did it actually SERVE when we last tried".
A replica can pass readiness probes while failing real requests (a
wedged device tunnel still answers host-side HTTP), so rotation
membership requires both signals.

States and transitions (the classic three-state machine):

- ``closed`` — traffic flows; ``failure_threshold`` CONSECUTIVE
  failures trip it to ``open`` (one success resets the streak).
- ``open`` — traffic is refused locally for ``cooldown_s``; the first
  :meth:`try_acquire` after the cooldown flips to ``half_open`` and is
  admitted as the single probe request.
- ``half_open`` — exactly one in-flight probe; success closes the
  breaker, failure re-opens it (and restarts the cooldown).

All clocks are monotonic; all state is lock-guarded and the lock is
never held across I/O (gofrlint GFL002/GFL004).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# the truthy grant try_acquire returns when admitting the caller AS the
# half-open probe — only a success reported with ``probe=True`` may
# close the breaker (a stale success from a request dispatched before
# the trip must not)
PROBE = "probe"

# numeric gauge encoding for gofr_tpu_router_breaker_state{replica}
STATE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_s: float = 5.0,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ):
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0  # monotonic mark of the last trip
        self._probe_in_flight = False
        self._transitions = 0

    # -- admission ------------------------------------------------------------
    def try_acquire(self) -> Any:
        """May a request be dispatched through this breaker right now?
        Returns ``False`` (refused), ``True`` (normal traffic), or the
        truthy :data:`PROBE` grant — the caller was admitted as the ONE
        half-open probe and must report its outcome with
        ``record_success(probe=True)`` / :meth:`record_failure`."""
        notify: Optional[tuple[str, str]] = None
        with self._lock:
            allowed: Any = False
            if self._state == CLOSED:
                allowed = True
            elif self._state == OPEN:
                if time.monotonic() - self._opened_at >= self.cooldown_s:
                    notify = self._transition_locked(HALF_OPEN)
                    self._probe_in_flight = True
                    allowed = PROBE
            else:  # HALF_OPEN: one probe at a time
                if not self._probe_in_flight:
                    self._probe_in_flight = True
                    allowed = PROBE
        self._notify(notify)
        return allowed

    # -- outcomes -------------------------------------------------------------
    def record_success(self, probe: bool = False) -> None:
        """``probe=True`` only from the caller whose ``try_acquire``
        returned :data:`PROBE`. Successes without the probe grant reset
        the failure streak but never close an OPEN or HALF_OPEN breaker
        — they are from requests dispatched BEFORE the trip (or long
        streams finishing), and letting stale evidence bypass the
        cooldown + single-probe discipline would flood traffic back
        onto a replica whose recent failures are fresher truth."""
        notify: Optional[tuple[str, str]] = None
        with self._lock:
            self._consecutive_failures = 0
            if probe:
                self._probe_in_flight = False
                if self._state == HALF_OPEN:
                    notify = self._transition_locked(CLOSED)
        self._notify(notify)

    def record_failure(self) -> None:
        notify: Optional[tuple[str, str]] = None
        with self._lock:
            self._consecutive_failures += 1
            self._probe_in_flight = False
            if self._state == HALF_OPEN or (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                notify = self._transition_locked(OPEN)
                self._opened_at = time.monotonic()
        self._notify(notify)

    # -- introspection --------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            out = {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "cooldown_s": self.cooldown_s,
                "transitions": self._transitions,
            }
            if self._state == OPEN:
                out["cooldown_remaining_s"] = round(max(
                    0.0,
                    self.cooldown_s - (time.monotonic() - self._opened_at),
                ), 3)
            return out

    # -- internals ------------------------------------------------------------
    def _transition_locked(self, to: str) -> tuple[str, str]:
        was = self._state
        self._state = to
        self._transitions += 1
        return was, to

    def _notify(self, edge: Optional[tuple[str, str]]) -> None:
        """Run the transition callback OUTSIDE the lock (it increments
        metrics, which take their own locks — GFL004)."""
        if edge is not None and self._on_transition is not None:
            try:
                self._on_transition(*edge)
            except Exception:  # gofrlint: disable=GFL006 — metrics callback must never poison breaker state
                pass
