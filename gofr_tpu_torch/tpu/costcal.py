"""Fit the cost model's roofline coefficients from dispatch records (port
of ``tools/costcal.py``'s ``fit`` and ``_ols``).

The cost model (``tpu/costmodel.py``) predicts a dispatch's latency as
``max(flops/eff_flops, bytes/eff_bw) * 1e3 + overhead_ms``. ``fit`` turns
a card's dispatch records into one ``cost_profile.json`` row: each record
(its family's analytic flops and bytes, and the time it took) is classed
compute- or bandwidth-bound by the card's NOMINAL peaks (``flops.py``),
then each class is fitted by ordinary least squares, ``ms`` against
``flops`` (or ``bytes``): ``eff = 1e3 / slope``, and ``overhead_ms`` is
the record-weighted mean of the intercepts (clipped at 0).

One case the reference's fit leaves to its labelled default: a class
whose records barely differ in size (every pooled decode chunk streams the
same weights) gives OLS no spread to read a slope from. There the row
takes the class's mean rate through the origin (``eff = mean(x) / mean(ms)
* 1e3``, labelled ``mean``), so its predictions still sit on the records.

    records = join_records(dispatches, sheets)   # /admin/dispatches + /admin/costmodel
    row = fit(records, "NVIDIA H100 80GB HBM3", "gpu")
"""

from __future__ import annotations

from typing import Any, Optional

from gofr_tpu_torch.tpu.costmodel import UNPRICED_KINDS
from gofr_tpu_torch.tpu.flops import device_peaks

# a class whose largest record is less than this many times its smallest
# has no spread for a slope: it takes the mean rate instead
MIN_SPREAD = 1.5


def _observed_ms(record: dict[str, Any]) -> Optional[float]:
    if record.get("observed_ms") is not None:
        return float(record["observed_ms"])
    if record.get("duration_s") is not None:
        return float(record["duration_s"]) * 1e3
    return None


def _ols(points: list[tuple[float, float]]) -> Optional[tuple[float, float]]:
    """Least-squares (slope, intercept) of y on x; None when degenerate."""
    n = len(points)
    if n < 2:
        return None
    sx = sum(x for x, _ in points)
    sy = sum(y for _, y in points)
    sxx = sum(x * x for x, _ in points)
    sxy = sum(x * y for x, y in points)
    denom = n * sxx - sx * sx
    if denom <= 0:
        return None
    slope = (n * sxy - sx * sy) / denom
    return slope, (sy - slope * sx) / n


def join_records(dispatches: list[dict], sheets: list[dict]) -> list[dict[str, Any]]:
    """Dispatch records (``/admin/dispatches``) that finished ok, each
    with its family's sheet flops and bytes (``/admin/costmodel``'s
    ``sheets``: the exact key, else the bucket's sheet, as the cost model
    resolves them)."""
    exact = {(s["kind"], s["bucket"] or 0, s["batch"] or 0): s for s in sheets}
    by_bucket = {(s["kind"], s["bucket"] or 0): s for s in sheets}
    out = []
    for rec in dispatches:
        if rec.get("status") != "ok" or rec["kind"] in UNPRICED_KINDS:
            continue
        key = (rec["kind"], rec.get("bucket") or 0)
        sheet = exact.get((*key, rec.get("batch_size") or 0)) or by_bucket.get(key)
        if sheet is None or rec.get("duration_s") is None:
            continue
        out.append({
            "kind": rec["kind"], "bucket": key[1], "batch_size": rec.get("batch_size"),
            "flops": sheet["flops"] or 0.0, "bytes_accessed": sheet["bytes_accessed"] or 0.0,
            "duration_s": rec["duration_s"],
        })
    return out


def fit(records: list[dict[str, Any]], device_kind: str, platform: str = "gpu") -> dict[str, Any]:
    """One profile row fitted from ``records`` (dicts with ``flops``,
    ``bytes_accessed`` and ``observed_ms`` or ``duration_s``)."""
    peak_flops, peak_bw, _ = device_peaks(device_kind, platform)
    compute: list[tuple[float, float]] = []
    bandwidth: list[tuple[float, float]] = []
    skipped = 0
    for record in records:
        ms = _observed_ms(record)
        flops = float(record.get("flops") or 0.0)
        nbytes = float(record.get("bytes_accessed") or 0.0)
        if ms is None or ms <= 0 or (flops <= 0 and nbytes <= 0):
            skipped += 1
            continue
        # which side of the roofline a shape sits on is a property of the
        # card's ratio, not of the efficiencies being fitted
        if flops / peak_flops >= nbytes / peak_bw:
            compute.append((flops, ms))
        else:
            bandwidth.append((nbytes, ms))
    row: dict[str, Any] = {
        "device_kind": device_kind,
        "platform": platform,
        "n_records": len(records) - skipped,
        "n_skipped": skipped,
        "n_compute_bound": len(compute),
        "n_bandwidth_bound": len(bandwidth),
    }
    intercepts: list[tuple[float, int]] = []
    for name, points, nominal in (
        ("eff_flops", compute, peak_flops),
        ("eff_bw", bandwidth, peak_bw),
    ):
        if not points:
            row[name] = nominal * 0.5
            row[f"{name}_source"] = "default"
            continue
        xs = [x for x, _ in points]
        fitted = _ols(points) if max(xs) >= MIN_SPREAD * min(xs) else None
        if fitted is None or fitted[0] <= 0:
            mean_x = sum(xs) / len(xs)
            mean_ms = sum(ms for _, ms in points) / len(points)
            row[name] = mean_x / mean_ms * 1e3
            row[f"{name}_source"] = "mean"
            continue
        slope, intercept = fitted
        row[name] = 1e3 / slope
        row[f"{name}_source"] = "fit"
        intercepts.append((max(0.0, intercept), len(points)))
    total = sum(n for _, n in intercepts)
    row["overhead_ms"] = sum(c * n for c, n in intercepts) / total if total else 0.0
    return row
