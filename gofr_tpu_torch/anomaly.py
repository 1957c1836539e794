"""The anomaly vocabulary and its bounded evidence ring (host-side).

Copy of ``gofr_tpu/anomaly.py``: ``ANOMALY_CAUSES`` and ``AnomalyRing``,
the store behind ``GET /admin/anomalies``. The dispatch cost model
(``tpu/costmodel.py``) records its ``slow_dispatch`` and ``ema_drift``
verdicts here, and the SLO engine (``slo.py``) its burn alerts: one anomaly
surface. Every postmortem bundle carries the ring.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Optional

# anomaly causes (the `cause` label of gofr_tpu_dispatch_anomalies_total
# and the `?cause=` filter of GET /admin/anomalies)
ANOMALY_CAUSES = (
    "slow_dispatch",  # one dispatch exceeded COSTMODEL_ANOMALY_FACTOR x prediction
    "ema_drift",      # a family's residual EMA drifted past COSTMODEL_EMA_BAND
    "slo_fast_burn",  # an SLO objective burned past SLO_BURN_FAST_RATE on both fast windows
    "slo_slow_burn",  # an SLO objective burned past SLO_BURN_SLOW_RATE on both slow windows
)


class AnomalyRing:
    """Bounded, thread-safe ring of typed anomaly events with monotonic
    sequence numbers — the evidence store behind ``GET /admin/anomalies``."""

    def __init__(self, capacity: int = 256):
        self._ring: "deque[dict[str, Any]]" = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._by: dict[tuple, int] = {}  # (kind, cause) -> count
        self._total = 0
        self._last_ts: Optional[float] = None

    def record(self, **event: Any) -> dict[str, Any]:
        ts = time.time()  # gofrlint: wall-clock — anomaly event display/correlation ts
        entry = {"seq": next(self._seq), "ts": ts, **event}
        key = (event.get("kind", ""), event.get("cause", ""))
        with self._lock:
            self._ring.append(entry)
            self._by[key] = self._by.get(key, 0) + 1
            self._total += 1
            self._last_ts = ts
        return entry

    def events(
        self,
        limit: int = 100,
        kind: Optional[str] = None,
        cause: Optional[str] = None,
    ) -> list[dict[str, Any]]:
        """Most-recent-first events, optionally filtered."""
        with self._lock:
            snapshot = list(self._ring)
        out: list[dict[str, Any]] = []
        for entry in reversed(snapshot):
            if kind is not None and entry.get("kind") != kind:
                continue
            if cause is not None and entry.get("cause") != cause:
                continue
            out.append(dict(entry))
            if len(out) >= limit:
                break
        return out

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def total(self) -> int:
        """Events recorded since construction (retained or not)."""
        with self._lock:
            return self._total

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "total": self._total,
                "retained": len(self._ring),
                "capacity": self._ring.maxlen,
                "by": {"/".join(k): v for k, v in sorted(self._by.items())},
                "last_ts": self._last_ts,
            }
