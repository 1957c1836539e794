"""Dispatch cost model and residual watchtower (port of
``gofr_tpu/tpu/costmodel.py``).

- **CostSheet**: a family's cost, per (kind, bucket, batch, width): flops
  and bytes reckoned from the model's shapes (``transformer_sheet``, source
  ``analytic``: the port compiles nothing per shape, so there is no compiled
  cost analysis to read), or a direct per-dispatch cost for the echo
  runner (source ``synthetic``).
- **Roofline prediction**: ``max(flops/eff_flops, bytes/eff_bw) * 1e3 +
  overhead_ms``, with per-card coefficients from the committed
  ``cost_profile.json`` beside this module (an ``H100`` row fitted by
  ``tpu/costcal.py`` from the card's dispatch records, and the ``cpu`` row
  for the echo path), else ``NOMINAL_EFFICIENCY`` x the data-sheet peaks,
  labeled ``nominal``. ``DispatchTimeline.begin`` stamps each record's
  ``predicted_ms``, ``finish`` its ``residual_ratio`` (observed/predicted).
- **Anomalies**: per-family (kind, bucket) residual EMAs on
  ``gofr_tpu_dispatch_residual_ratio{kind,bucket}``; a dispatch past
  ``COSTMODEL_ANOMALY_FACTOR`` x its prediction (``slow_dispatch``) or a
  family EMA past ``COSTMODEL_EMA_BAND`` (``ema_drift``, latched until it
  re-enters the band) lands in the ``ANOMALY_RING_SIZE`` ring behind
  ``GET /admin/anomalies`` and on ``gofr_tpu_dispatch_anomalies_total``.
  Every verdict also needs the absolute excess past
  ``COSTMODEL_MIN_ANOMALY_MS``, so healthy traffic raises none.

Host-side only: a dict lookup and a few float ops a dispatch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

from gofr_tpu_torch.anomaly import AnomalyRing
from gofr_tpu_torch.tpu.flops import device_peaks

__all__ = [
    "CostModel", "CostSheet",
    "UNPRICED_KINDS", "transformer_sheet",
]

# dispatch kinds that never get a prediction: boot-time work has no
# steady-state cost truth (a warmup compile's duration IS the compile)
UNPRICED_KINDS = ("warmup_compile", "device_probe")

# committed per-card roofline coefficients (tpu/costcal.py fits them
# from dispatch records)
DEFAULT_PROFILE_PATH = os.path.join(os.path.dirname(__file__), "cost_profile.json")

# a family EMA is meaningless over a couple of samples — drift verdicts
# wait for this many observed dispatches per (kind, bucket) family
EMA_MIN_SAMPLES = 8

# when no profile row matches the probed card, predictions fall back to
# this fraction of the NOMINAL peak (flops.py's table), labeled
# "nominal" in the calibration provenance so an uncalibrated replica is
# visible on /admin/costmodel, not silently trusted
NOMINAL_EFFICIENCY = 0.5


class CostSheet:
    """One dispatch family's cost (immutable after install)."""

    __slots__ = (
        "kind", "bucket", "batch", "width", "flops", "bytes_accessed",
        "peak_memory_bytes", "base_ms", "source",
    )

    def __init__(
        self,
        kind: str,
        bucket: int = 0,
        batch: int = 0,
        width: int = 0,
        flops: float = 0.0,
        bytes_accessed: float = 0.0,
        peak_memory_bytes: int = 0,
        base_ms: Optional[float] = None,
        source: str = "analytic",
    ):
        self.kind = kind
        self.bucket = int(bucket)
        self.batch = int(batch)
        self.width = int(width)
        self.flops = float(flops or 0.0)
        self.bytes_accessed = float(bytes_accessed or 0.0)
        self.peak_memory_bytes = int(peak_memory_bytes or 0)
        # synthetic sheets (echo) carry a direct per-dispatch cost in ms
        # instead of flops/bytes — the roofline terms don't apply
        self.base_ms = base_ms
        self.source = source  # "analytic" | "synthetic"

    def key(self) -> tuple:
        return (self.kind, self.bucket, self.batch, self.width)

    def to_dict(self) -> dict[str, Any]:
        return {
            "kind": self.kind,
            "bucket": self.bucket or None,
            "batch": self.batch or None,
            "width": self.width or None,
            "flops": self.flops or None,
            "bytes_accessed": self.bytes_accessed or None,
            "peak_memory_bytes": self.peak_memory_bytes or None,
            "base_ms": self.base_ms,
            "source": self.source,
        }


class CostModel:
    """Cost sheets + calibrated roofline prediction + residual/anomaly
    accounting. Wired into :class:`DispatchTimeline` as the single
    predict→observe chokepoint: ``annotate(record)`` at ``begin``,
    ``observe(record)`` at ``finish`` — one integration point covers the
    batcher, chunked prefill, the decode pool, and spec verifies."""

    def __init__(
        self,
        metrics: Any = None,
        logger: Any = None,
        profile_path: Optional[str] = None,
        anomaly_factor: float = 4.0,
        min_anomaly_ms: float = 50.0,
        ema_alpha: float = 0.2,
        ema_band: float = 2.5,
        ring_size: int = 256,
    ):
        if anomaly_factor <= 1.0:
            raise ValueError("COSTMODEL_ANOMALY_FACTOR must be > 1")
        if min_anomaly_ms < 0:
            raise ValueError("COSTMODEL_MIN_ANOMALY_MS must be >= 0")
        if not (0.0 < ema_alpha <= 1.0):
            raise ValueError("COSTMODEL_EMA_ALPHA must be in (0, 1]")
        if ema_band <= 1.0:
            raise ValueError("COSTMODEL_EMA_BAND must be > 1")
        self.logger = logger
        self.anomaly_factor = float(anomaly_factor)
        self.min_anomaly_ms = float(min_anomaly_ms)
        self.ema_alpha = float(ema_alpha)
        self.ema_band = float(ema_band)
        self.ring = AnomalyRing(ring_size)
        self._lock = threading.Lock()
        # sheets: exact key -> sheet, plus two fallback indexes — the
        # compiled shape (bucket x padded batch) determines the cost, so
        # a record whose batch_size is below the padded warm batch still
        # resolves to its bucket's sheet; kind-wide wildcards are how the
        # echo runner's synthetic table covers every echo dispatch
        self._sheets: dict[tuple, CostSheet] = {}
        self._by_bucket: dict[tuple, CostSheet] = {}
        self._wildcard: dict[str, CostSheet] = {}
        # residual families: (kind, bucket) -> EMA state
        self._families: dict[tuple, dict[str, Any]] = {}
        # calibration: profile rows + the resolved coefficients
        self._profile_path = profile_path or DEFAULT_PROFILE_PATH
        self._profile_rows: dict[str, dict[str, Any]] = {}
        self._profile_meta: dict[str, Any] = {}
        self._load_profile()
        self.eff_flops: Optional[float] = None
        self.eff_bw: Optional[float] = None
        self.overhead_ms: float = 0.0
        self.calibration: dict[str, Any] = {"source": "uncalibrated"}
        if metrics is not None:
            self._residual_gauge = metrics.gauge(
                "gofr_tpu_dispatch_residual_ratio",
                "per-family EMA of observed/predicted dispatch latency "
                "(1.0 = the calibrated roofline holds; the anomaly band "
                "is COSTMODEL_EMA_BAND)",
                labels=("kind", "bucket"),
            )
            self._anomaly_counter = metrics.counter(
                "gofr_tpu_dispatch_anomalies_total",
                "dispatch cost-model anomalies by kind and cause "
                "(slow_dispatch, ema_drift)",
                labels=("kind", "cause"),
            )
        else:
            self._residual_gauge = self._anomaly_counter = None

    # -- calibration ----------------------------------------------------------
    def _load_profile(self) -> None:
        """Load the committed cost-profile JSON. A missing or corrupt
        profile leaves the rows empty (calibration then resolves to the
        labeled ``nominal`` fallback) — never a boot failure."""
        try:
            with open(self._profile_path, "r", encoding="utf-8") as fh:
                profile = json.load(fh)
            rows = profile.get("device_kinds") or {}
            if not isinstance(rows, dict):
                raise ValueError("device_kinds must be an object")
            self._profile_rows = {
                str(k).lower(): dict(v) for k, v in rows.items()
            }
            self._profile_meta = {
                k: v for k, v in profile.items() if k != "device_kinds"
            }
        except FileNotFoundError:
            self._profile_rows = {}
            self._profile_meta = {"error": f"missing: {self._profile_path}"}
        except Exception as exc:
            self._profile_rows = {}
            self._profile_meta = {"error": f"unreadable: {exc!r}"}
            if self.logger is not None:
                self.logger.warnf(
                    "costmodel: cost profile %s unreadable (%r) — "
                    "predictions fall back to nominal coefficients",
                    self._profile_path, exc,
                )

    def calibrate(self, device_kind: str, platform: str) -> None:
        """Resolve roofline coefficients for the probed device kind:
        ordered substring match over the committed profile rows (the
        flops.py table discipline), else ``NOMINAL_EFFICIENCY`` x the
        nominal peaks — labeled so /admin/costmodel shows whether this
        replica predicts from a real fit or a guess."""
        kind = (device_kind or "").lower()
        row = None
        matched = None
        for needle, candidate in self._profile_rows.items():
            if needle in kind or needle == platform:
                row = candidate
                matched = needle
                break
        if row is not None:
            eff_flops = float(row.get("eff_flops") or 0.0)
            eff_bw = float(row.get("eff_bw") or 0.0)
            overhead = float(row.get("overhead_ms") or 0.0)
            source = "profile"
        else:
            peak_flops, peak_bw, _ = device_peaks(device_kind, platform)
            eff_flops = peak_flops * NOMINAL_EFFICIENCY
            eff_bw = peak_bw * NOMINAL_EFFICIENCY
            overhead = 0.2
            source = "nominal"
        with self._lock:
            self.eff_flops = eff_flops if eff_flops > 0 else None
            self.eff_bw = eff_bw if eff_bw > 0 else None
            self.overhead_ms = overhead
            self.calibration = {
                "source": source,
                "matched": matched,
                "device_kind": str(device_kind),
                "platform": platform,
                "eff_flops": eff_flops,
                "eff_bw": eff_bw,
                "overhead_ms": overhead,
                "profile_path": self._profile_path,
                "profile": dict(self._profile_meta),
                # the matched row's own provenance (nominal, or the fit's
                # card, power limit and run)
                "row_source": row.get("source") if row is not None else None,
            }

    # -- sheet install / lookup ----------------------------------------------
    def install(self, sheet: CostSheet) -> None:
        with self._lock:
            self._sheets[sheet.key()] = sheet
            if sheet.bucket or sheet.batch or sheet.width:
                self._by_bucket[(sheet.kind, sheet.bucket)] = sheet
            else:
                self._wildcard[sheet.kind] = sheet

    def install_synthetic(self, kind: str, base_ms: float) -> None:
        """Kind-wide synthetic sheet (echo runner): one dispatch of
        ``kind`` costs ``base_ms`` regardless of bucket/batch — the
        compile-free cost truth tier-1 drives the whole loop with."""
        self.install(CostSheet(kind, base_ms=float(base_ms), source="synthetic"))

    def install_analytic(
        self, kind: str, bucket: int, batch: int, flops: float,
        bytes_accessed: float, width: int = 0,
    ) -> CostSheet:
        """Install a family's sheet reckoned from the model's shapes
        (``transformer_sheet``): the port compiles nothing, so there is no
        compiled cost analysis to harvest (source ``analytic``)."""
        sheet = CostSheet(
            kind, bucket=bucket, batch=batch, width=width, flops=flops,
            bytes_accessed=bytes_accessed, source="analytic",
        )
        self.install(sheet)
        return sheet

    def sheet_for(
        self, kind: str, bucket: int = 0, batch: int = 0, width: int = 0
    ) -> Optional[CostSheet]:
        """Exact key, else the bucket's sheet (the compiled shape pads
        every batch to it), else the kind-wide wildcard (synthetic)."""
        with self._lock:
            sheet = self._sheets.get((kind, bucket, batch, width))
            if sheet is None:
                sheet = self._by_bucket.get((kind, bucket))
            if sheet is None:
                sheet = self._wildcard.get(kind)
            return sheet

    def sheet_flops(self, kind: str, bucket: int = 0, batch: int = 0) -> Optional[float]:
        """The family's analytic flops, or None: the MFU upgrade hook
        (the 2·N·tokens floor stays the fallback, source labeled)."""
        sheet = self.sheet_for(kind, bucket=bucket, batch=batch)
        if sheet is not None and sheet.source == "analytic" and sheet.flops > 0:
            return sheet.flops
        return None

    # -- prediction (DispatchTimeline.begin hook) -----------------------------
    def predict_ms(
        self, kind: str, bucket: int = 0, batch: int = 0, width: int = 0
    ) -> tuple[Optional[float], Optional[str]]:
        """Calibrated roofline latency for one dispatch of the family:
        ``max(flops/eff_flops, bytes/eff_bw)*1e3 + overhead_ms`` (analytic
        sheets), or ``base_ms + overhead_ms`` (synthetic). Returns
        ``(None, None)`` for unpriced kinds and families with no sheet."""
        if kind in UNPRICED_KINDS:
            return None, None
        sheet = self.sheet_for(kind, bucket=bucket, batch=batch, width=width)
        if sheet is None:
            return None, None
        if sheet.base_ms is not None:
            return sheet.base_ms + self.overhead_ms, sheet.source
        flops_s = (
            sheet.flops / self.eff_flops
            if self.eff_flops and sheet.flops > 0 else 0.0
        )
        bw_s = (
            sheet.bytes_accessed / self.eff_bw
            if self.eff_bw and sheet.bytes_accessed > 0 else 0.0
        )
        roofline = max(flops_s, bw_s)
        if roofline <= 0.0:
            return None, None
        return roofline * 1e3 + self.overhead_ms, sheet.source

    def annotate(self, record: Any) -> None:
        """``DispatchTimeline.begin`` hook: stamp the prediction (and its
        source) onto the record before the dispatch runs."""
        predicted, source = self.predict_ms(
            record.kind, bucket=record.bucket, batch=record.batch_size,
        )
        if predicted is not None:
            record.predicted_ms = predicted
            record.cost_source = source

    # -- residual / anomaly accounting (DispatchTimeline.finish hook) ---------
    def observe(self, record: Any) -> None:
        """``DispatchTimeline.finish`` hook: compute the residual, update
        the family EMA (and its gauge), and run both anomaly verdicts.
        Only clean dispatches count — an errored dispatch is a failure,
        not a latency anomaly, and would poison the EMA."""
        predicted = getattr(record, "predicted_ms", None)
        duration = record.duration
        if predicted is None or predicted <= 0 or duration is None:
            return
        if record.status != "ok":
            return
        observed_ms = duration * 1e3
        ratio = observed_ms / predicted
        record.residual_ratio = ratio
        excess_ms = observed_ms - predicted
        family = (record.kind, record.bucket)
        verdicts: list[tuple[str, float]] = []
        with self._lock:
            fam = self._families.get(family)
            if fam is None:
                fam = {
                    "ema": ratio, "ema_excess_ms": excess_ms, "n": 1,
                    "last_ratio": ratio, "drift_latched": False,
                }
                self._families[family] = fam
            else:
                a = self.ema_alpha
                fam["ema"] += a * (ratio - fam["ema"])
                fam["ema_excess_ms"] += a * (excess_ms - fam["ema_excess_ms"])
                fam["n"] += 1
                fam["last_ratio"] = ratio
            ema = fam["ema"]
            # single-dispatch verdict: factor breach AND absolute floor
            # (the floor is the no-false-positive guarantee for
            # microsecond dispatches whose ratios are pure noise)
            if ratio >= self.anomaly_factor and excess_ms >= self.min_anomaly_ms:
                verdicts.append(("slow_dispatch", self.anomaly_factor))
            # family-drift verdict: EMA past the band with a real
            # absolute excess, latched until the family re-enters the
            # band (one event per excursion, not one per dispatch)
            drifting = (
                fam["n"] >= EMA_MIN_SAMPLES
                and ema >= self.ema_band
                and fam["ema_excess_ms"] >= self.min_anomaly_ms
            )
            if drifting and not fam["drift_latched"]:
                fam["drift_latched"] = True
                verdicts.append(("ema_drift", self.ema_band))
            elif not drifting and fam["drift_latched"] and ema < self.ema_band:
                fam["drift_latched"] = False
        # metric/ring/log work OUTSIDE the family lock (lock discipline:
        # never call into another subsystem while holding it)
        if self._residual_gauge is not None:
            self._residual_gauge.set(
                ema, kind=record.kind, bucket=str(record.bucket or 0)
            )
        for cause, threshold in verdicts:
            record.anomaly = cause
            self.ring.record(
                dispatch_id=record.dispatch_id,
                kind=record.kind,
                bucket=record.bucket or 0,
                batch_size=record.batch_size or 0,
                cause=cause,
                predicted_ms=round(predicted, 4),
                observed_ms=round(observed_ms, 4),
                residual_ratio=round(ratio, 4),
                ema=round(ema, 4),
                threshold=threshold,
                source=getattr(record, "cost_source", None),
                detail=record.detail or None,
            )
            if self._anomaly_counter is not None:
                self._anomaly_counter.inc(kind=record.kind, cause=cause)
            if self.logger is not None:
                self.logger.warnf(
                    "dispatch anomaly (%s): %s bucket=%s dispatch=%d "
                    "observed=%.2fms predicted=%.2fms ratio=%.1fx",
                    cause, record.kind, record.bucket, record.dispatch_id,
                    observed_ms, predicted, ratio,
                )

    # -- read side ------------------------------------------------------------
    def residuals(self) -> dict[str, Any]:
        """Per-family residual rollup for /admin/costmodel."""
        with self._lock:
            return {
                f"{kind}/{bucket}": {
                    "ema": round(fam["ema"], 4),
                    "ema_excess_ms": round(fam["ema_excess_ms"], 4),
                    "n": fam["n"],
                    "last_ratio": round(fam["last_ratio"], 4),
                    "drift_latched": fam["drift_latched"],
                }
                for (kind, bucket), fam in sorted(self._families.items())
            }

    def sheets(self) -> list[dict[str, Any]]:
        with self._lock:
            listed = list(self._sheets.values())
        return [s.to_dict() for s in sorted(listed, key=lambda s: s.key())]

    def snapshot(self) -> dict[str, Any]:
        """The full /admin/costmodel shape: sheets,
        calibration provenance, residual rollups, anomaly stats."""
        with self._lock:
            calibration = dict(self.calibration)
        return {
            "calibration": calibration,
            "thresholds": {
                "anomaly_factor": self.anomaly_factor,
                "min_anomaly_ms": self.min_anomaly_ms,
                "ema_alpha": self.ema_alpha,
                "ema_band": self.ema_band,
                "ema_min_samples": EMA_MIN_SAMPLES,
            },
            "sheets": self.sheets(),
            "residuals": self.residuals(),
            "anomalies": self.ring.stats(),
        }

    def overview(self) -> dict[str, Any]:
        """The small block that rides ``engine_snapshot()`` (and the
        fleet prober's /admin/engine scrape): enough to headline a
        fleet-overview row without the full sheet dump."""
        with self._lock:
            source = self.calibration.get("source")
            n_sheets = len(self._sheets)
            worst = 0.0
            for fam in self._families.values():
                if fam["n"] >= EMA_MIN_SAMPLES and fam["ema"] > worst:
                    worst = fam["ema"]
        ring = self.ring.stats()
        return {
            "calibration": source,
            "sheets": n_sheets,
            "worst_residual_ema": round(worst, 4) if worst else None,
            "anomalies_total": ring["total"],
            "last_anomaly_ts": ring["last_ts"],
        }



def transformer_sheet(
    cfg: Any,
    weight_bytes: float,
    kv_bytes_per_token: float,
    rows: int,
    tokens: int,
    pairs: float,
    kv_read: float,
    steps: int = 1,
    logit_positions: int = 1,
) -> tuple[float, float]:
    """(flops, bytes) of a decoder dispatch reckoned from its shapes:
    ``rows`` sequences of ``tokens`` new positions each, for ``steps``
    steps (a decode chunk); ``pairs`` the (query, key) pairs one row's
    attention computes a step (``tokens * (tokens + 1) / 2`` for a causal
    prefill from position 0, the kv length for a decode step), ``kv_read``
    the cached positions one row reads a step, and ``logit_positions`` the
    positions a row takes logits at.

    - flops: 2 x the layers' matmul weights x each new position, 2 x
      dim x vocab x each logit position (the lm_head), and 4 x head_dim x
      n_heads x n_layers x each (query, key) pair (QK^T and PV); norms,
      RoPE, softmax and sampling are not counted (a floor, as MFU's);
    - bytes: every weight once a step (the stream decode pays), the KV of
      each position read, and the KV each new position writes."""
    d, f = cfg.dim, cfg.hidden_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    layer_mm = d * d + 2 * d * kv_dim + d * d + 3 * d * f
    mm = 2.0 * cfg.n_layers * layer_mm * rows * tokens
    head = 2.0 * d * cfg.vocab_size * rows * logit_positions
    attn = 4.0 * cfg.head_dim * cfg.n_heads * cfg.n_layers * rows * pairs
    flops = steps * (mm + head + attn)
    nbytes = steps * (weight_bytes + kv_bytes_per_token * rows * (kv_read + tokens))
    return flops, nbytes
