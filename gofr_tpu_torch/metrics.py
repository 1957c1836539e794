"""Metrics: counters, gauges and histograms with Prometheus text
exposition (copy of ``gofr_tpu/metrics.py``), served at ``/metrics``.

Besides classic Prometheus text 0.0.4, the registry speaks **OpenMetrics
1.0** (``Registry.expose(openmetrics=True)``; the handler negotiates on
``Accept: application/openmetrics-text``): the same series, plus per-bucket
**exemplars** on histograms, the ``trace_id`` (and, below a dispatch, the
``dispatch_id``) of the last observation that landed in each bucket.
``COMPILE_BUCKETS`` is the boot stages' ladder.

The cardinality guard: ``Registry(max_series=N)`` (``METRICS_MAX_SERIES``,
default 1000) caps the label-sets any one metric may mint; overflow
increments ``gofr_tpu_metrics_dropped_series_total{metric}`` instead of
growing the scrape. ``Registry.collect()`` returns a structured snapshot
of every series.

Metric updates read host values only: a count of ids already on the
host, a length, a clock. None reads a device tensor.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Iterable, Optional, Sequence

DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# boot "compiles" run seconds to minutes (the kernels' nvcc build, the
# warm-up prefill per bucket): the latency ladder would put them all in +Inf
COMPILE_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0, 600.0,
)

# OpenMetrics caps an exemplar's label-set (every name + value) at 128
# UTF-8 chars; a 32-hex trace_id plus a dispatch_id fits comfortably,
# but the cap is enforced so a creative provider can never emit an
# exposition that strict parsers reject.
EXEMPLAR_MAX_RUNES = 128

# An exemplar provider returns the correlating labels of the CURRENT
# observation ({"trace_id": ..., "dispatch_id": ...}) or None. It runs
# inside Histogram.observe on the hot path, so it must be O(1) —
# contextvar reads, no locks, no I/O.
ExemplarProvider = Callable[[], Optional[dict]]


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _fmt_le_openmetrics(v: float) -> str:
    """OpenMetrics requires canonical FLOAT `le` values ("1.0", never
    "1") — the one place the two text formats disagree on numbers."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return f"{int(v)}.0"
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP text escaping (both formats): backslash and newline only."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _help_line(family: str, help_: str) -> str:
    """`# HELP family text` — without the trailing space an empty help
    string would otherwise leave behind (strict parsers flag it)."""
    if not help_:
        return f"# HELP {family}"
    return f"# HELP {family} {_escape_help(help_)}"


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class Exemplar:
    """One histogram-bucket exemplar: the correlating labels of the last
    observation that landed in the bucket, the observed value, and the
    unix timestamp. Immutable once stored (readers never see it torn)."""

    __slots__ = ("labels", "value", "ts")

    def __init__(self, labels: dict, value: float, ts: float):
        self.labels = labels
        self.value = value
        self.ts = ts

    def format(self) -> str:
        """OpenMetrics exemplar suffix: `# {labels} value timestamp`."""
        inner = ",".join(
            f'{n}="{_escape_label(str(v))}"' for n, v in self.labels.items()
        )
        return f"# {{{inner}}} {_fmt_value(self.value)} {self.ts:.3f}"


def _clamp_exemplar_labels(labels: dict) -> Optional[dict]:
    """Enforce the OpenMetrics 128-rune label-set budget by dropping
    whole trailing labels (a truncated trace_id resolves to nothing)."""
    out: dict = {}
    runes = 0
    for name, value in labels.items():
        value = str(value)
        runes += len(name) + len(value)
        if runes > EXEMPLAR_MAX_RUNES:
            break
        out[name] = value
    return out or None


class _Metric:
    def __init__(
        self,
        name: str,
        help_: str,
        label_names: Sequence[str] = (),
        max_series: Optional[int] = None,
        on_drop: Optional[Callable[[str], None]] = None,
    ):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.max_series = max_series
        self._on_drop = on_drop
        self._lock = threading.Lock()

    def _key(self, labels: dict[str, str]) -> tuple[str, ...]:
        return tuple(str(labels.get(n, "")) for n in self.label_names)

    def _admit(self, store: dict, key: tuple) -> bool:
        """Cardinality guard (call under the metric lock): an existing
        series always updates; a NEW series is admitted only below
        ``max_series``. The caller reports a rejection via ``_dropped``
        AFTER releasing the lock (the drop counter takes its own)."""
        if key in store:
            return True
        return self.max_series is None or len(store) < self.max_series

    def _note_drop(self) -> None:
        if self._on_drop is not None:
            try:
                self._on_drop(self.name)
            except Exception:
                # overflow-drop callback: accounting must never take a
                # request down
                pass


class Counter(_Metric):
    kind = "counter"

    def __init__(
        self,
        name: str,
        help_: str,
        label_names: Sequence[str] = (),
        max_series: Optional[int] = None,
        on_drop: Optional[Callable[[str], None]] = None,
    ):
        super().__init__(name, help_, label_names, max_series, on_drop)
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            if self._admit(self._values, key):
                self._values[key] = self._values.get(key, 0.0) + amount
                return
        self._note_drop()

    def value(self, **labels: str) -> float:
        # same lock as the write path: exposition/readers during heavy
        # concurrent writes must never see torn dict state
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def data(self) -> dict[tuple[str, ...], float]:
        """Point-in-time series snapshot."""
        with self._lock:
            return dict(self._values)

    def _family(self, openmetrics: bool) -> str:
        """OpenMetrics counter families drop the `_total` suffix from
        HELP/TYPE lines; the samples keep it."""
        if openmetrics and self.kind == "counter" and self.name.endswith("_total"):
            return self.name[: -len("_total")]
        return self.name

    def expose(self, openmetrics: bool = False) -> Iterable[str]:
        family = self._family(openmetrics)
        yield _help_line(family, self.help)
        yield f"# TYPE {family} {self.kind}"
        with self._lock:
            items = list(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, val in items:
            yield f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt_value(val)}"


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            if self._admit(self._values, key):
                self._values[key] = float(value)
                return
        self._note_drop()

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        max_series: Optional[int] = None,
        on_drop: Optional[Callable[[str], None]] = None,
        exemplar_provider: Optional[ExemplarProvider] = None,
    ):
        super().__init__(name, help_, label_names, max_series, on_drop)
        self.buckets = tuple(sorted(buckets))
        self.exemplar_provider = exemplar_provider
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}
        # one slot per bucket PLUS the +Inf overflow, per series: the
        # last exemplar wins (an O(1) store, nothing on the hot path
        # beyond one list write)
        self._exemplars: dict[tuple[str, ...], list[Optional[Exemplar]]] = {}

    def observe(
        self,
        value: float,
        exemplar: Optional[dict] = None,
        **labels: str,
    ) -> None:
        """Record one observation. ``exemplar`` optionally attaches the
        correlating labels of THIS observation (e.g. ``{"trace_id": ...}``)
        to the bucket it lands in; when omitted, the histogram's
        ``exemplar_provider`` (if any) is consulted — it reads the
        current span's contextvar, so request-path
        observations self-correlate with zero caller changes."""
        key = self._key(labels)
        if exemplar is None and self.exemplar_provider is not None:
            try:
                exemplar = self.exemplar_provider()
            except Exception:
                exemplar = None  # telemetry must never take a request down
        ex = None
        if exemplar:
            clamped = _clamp_exemplar_labels(exemplar)
            if clamped:
                # OpenMetrics exemplar timestamps are epoch seconds
                # gofrlint: wall-clock — OpenMetrics exemplar timestamps are epoch seconds by spec
                ex = Exemplar(clamped, float(value), time.time())
        with self._lock:
            if not self._admit(self._totals, key):
                dropped = True
            else:
                dropped = False
                counts = self._counts.setdefault(key, [0] * len(self.buckets))
                slot = len(self.buckets)  # +Inf overflow by default
                for i, b in enumerate(self.buckets):
                    if value <= b:
                        counts[i] += 1
                        slot = i
                        break
                self._sums[key] = self._sums.get(key, 0.0) + value
                self._totals[key] = self._totals.get(key, 0) + 1
                if ex is not None:
                    slots = self._exemplars.setdefault(
                        key, [None] * (len(self.buckets) + 1)
                    )
                    slots[slot] = ex
        if dropped:
            self._note_drop()

    def percentile(
        self, q: float, interpolate: bool = False, **labels: str
    ) -> float:
        """Approximate percentile from bucket counts.

        Default (``interpolate=False``): the UPPER BOUND of the bucket
        containing the q-quantile — a conservative estimate (the true
        sample quantile is <= the returned value, by up to one bucket
        width). ``interpolate=True`` instead linearly interpolates the
        rank's position inside the containing bucket ``(lower, upper]``
        (lower = 0 for the first bucket), which assumes observations
        spread uniformly within a bucket. Either way, observations past
        the largest finite bucket are clamped to ``buckets[-1]`` — a
        histogram cannot say more about its +Inf overflow."""
        key = self._key(labels)
        with self._lock:
            counts = list(self._counts.get(key, []))
            total = self._totals.get(key, 0)
        if not total:
            return 0.0
        rank = q * total
        acc = 0
        for i, c in enumerate(counts):
            prev_acc = acc
            acc += c
            if acc >= rank:
                if not interpolate:
                    return self.buckets[i]
                lower = self.buckets[i - 1] if i > 0 else 0.0
                frac = (rank - prev_acc) / c if c else 1.0
                return lower + frac * (self.buckets[i] - lower)
        return self.buckets[-1]

    def data(self) -> dict[tuple[str, ...], dict[str, Any]]:
        """Point-in-time series snapshot: per series
        the non-cumulative bucket counts, sum, and total count."""
        with self._lock:
            return {
                key: {
                    "counts": list(self._counts[key]),
                    "sum": self._sums[key],
                    "count": self._totals[key],
                }
                for key in self._totals
            }

    def expose(self, openmetrics: bool = False) -> Iterable[str]:
        yield _help_line(self.name, self.help)
        yield f"# TYPE {self.name} {self.kind}"
        fmt_le = _fmt_le_openmetrics if openmetrics else _fmt_value
        with self._lock:
            keys = list(self._totals)
            snap = {
                k: (
                    list(self._counts[k]),
                    self._sums[k],
                    self._totals[k],
                    list(self._exemplars.get(k) or ()),
                )
                for k in keys
            }
        for key, (counts, sum_, total, exemplars) in snap.items():
            acc = 0
            for i, b in enumerate(self.buckets):
                acc += counts[i]
                lab = _fmt_labels(self.label_names + ("le",), key + (fmt_le(b),))
                line = f"{self.name}_bucket{lab} {acc}"
                if openmetrics and i < len(exemplars) and exemplars[i] is not None:
                    line += f" {exemplars[i].format()}"
                yield line
            lab = _fmt_labels(self.label_names + ("le",), key + ("+Inf",))
            line = f"{self.name}_bucket{lab} {total}"
            inf_slot = len(self.buckets)
            if (
                openmetrics
                and inf_slot < len(exemplars)
                and exemplars[inf_slot] is not None
            ):
                line += f" {exemplars[inf_slot].format()}"
            yield line
            yield f"{self.name}_sum{_fmt_labels(self.label_names, key)} {_fmt_value(sum_)}"
            yield f"{self.name}_count{_fmt_labels(self.label_names, key)} {total}"


class Registry:
    """Thread-safe metric registry with text exposition.

    ``max_series`` is the per-metric cardinality cap (overflow lands in
    ``gofr_tpu_metrics_dropped_series_total{metric}``);
    ``exemplar_provider`` is handed to every histogram so request-path
    observations carry trace exemplars in the OpenMetrics
    exposition."""

    def __init__(
        self,
        max_series: Optional[int] = 1000,
        exemplar_provider: Optional[ExemplarProvider] = None,
    ) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self.max_series = max_series
        self.exemplar_provider = exemplar_provider
        self._dropped = self.counter(
            "gofr_tpu_metrics_dropped_series_total",
            "label-sets rejected by the per-metric cardinality cap "
            "(METRICS_MAX_SERIES)",
            labels=("metric",),
        )
        # the guard ledger itself must never trip the guard (its own
        # cardinality is bounded by the number of metric NAMES)
        self._dropped.max_series = None

    def _note_dropped(self, metric: str) -> None:
        self._dropped.inc(metric=metric)

    def counter(self, name: str, help_: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(
            name,
            Counter,
            lambda: Counter(
                name, help_, labels,
                max_series=self.max_series, on_drop=self._note_dropped,
            ),
        )

    def gauge(self, name: str, help_: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(
            name,
            Gauge,
            lambda: Gauge(
                name, help_, labels,
                max_series=self.max_series, on_drop=self._note_dropped,
            ),
        )

    def histogram(
        self,
        name: str,
        help_: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            name,
            Histogram,
            lambda: Histogram(
                name, help_, labels, buckets,
                max_series=self.max_series, on_drop=self._note_dropped,
                exemplar_provider=self.exemplar_provider,
            ),
        )

    def _get_or_create(self, name: str, cls: type, factory: Any) -> Any:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = factory()
                self._metrics[name] = metric
            if type(metric) is not cls:
                raise TypeError(f"metric {name} already registered as {type(metric).__name__}")
            return metric

    def collect(self) -> dict[str, dict[str, Any]]:
        """Structured point-in-time snapshot of every registered series —
        what a sampler reads on its interval.
        Counters/gauges snapshot to floats; histograms to
        ``{"counts": [...], "sum": s, "count": n}`` per label-set."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict[str, dict[str, Any]] = {}
        for m in metrics:
            out[m.name] = {
                "kind": m.kind,
                "label_names": m.label_names,
                "buckets": getattr(m, "buckets", None),
                "series": m.data(),
            }
        return out

    def expose(self, openmetrics: bool = False) -> str:
        """Text exposition. Default: classic Prometheus text 0.0.4.
        ``openmetrics=True``: OpenMetrics 1.0 — counter families drop
        their ``_total`` suffix from HELP/TYPE, `le` values are
        canonical floats, histogram buckets carry exemplars, and the
        body ends with the mandatory ``# EOF``."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.expose(openmetrics=openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


class Timer:
    """Context manager observing elapsed seconds into a histogram."""

    def __init__(self, hist: Histogram, **labels: str):
        self.hist = hist
        self.labels = labels

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.hist.observe(time.perf_counter() - self._start, **self.labels)
