"""Fleet-wide trace assembly: one request's causal timeline across
processes.

PRs 1/3/4 built deep single-process observability; the fleet then grew
routers, failover attempts, KV donors, and mid-stream resume hunts —
and no surface could show one request's PATH across those processes.
This module joins the evidence the hop-correlation layer leaves behind:

- the router's route record (``FleetRouter.records``) keyed by the
  fleet-wide ``X-Gofr-Request-Id``;
- each attempt's replica-side FlightRecord, whose ``origin`` block
  (router id, attempt index, resume-from event id — stamped off the
  ``X-Gofr-Hop`` header at admission) says exactly which route-record
  attempt caused it;
- the KV-transfer ledgers on both ends (the donor's ``served_recent``
  and the receiver's ``pulls_recent`` rings on ``/admin/engine``),
  stamped with the same id.

:func:`assemble` is PURE — dicts in, dict out, no I/O, no clock — so
bench.py can measure it and tests can drive it with fuzzed garbage.
:func:`gather_evidence` does the scraping (each attempt replica's
``/admin/requests?request_id=`` and the involved replicas'
``/admin/engine`` ledgers, over the same unauthenticated replica
clients the prober uses). Every scrape failure degrades the trace to
``partial: true`` with the gap named in ``evidence_gaps`` — a trace
assembled while a replica is mid-restart is partial WITH evidence,
never a 500.

The latency decomposition answers the triage question directly: of the
end-to-end ``elapsed_ms`` the router measured, how much was router
overhead (admission + selection + failed attempts), replica queue wait,
device TTFT, and stream delivery. The same stages back the
``gofr_tpu_router_hop_seconds{stage}`` histogram in aggregate.
"""

from __future__ import annotations

from typing import Any, Optional

# bounded scrape page: a trace joins at most this many flight records
# per replica (a request causes one record per attempt it landed there)
_FLIGHTS_PER_REPLICA = 10


def assemble(
    request_id: str,
    route_record: dict[str, Any],
    flights: Optional[dict[str, list]] = None,
    transfers: Optional[list] = None,
    evidence_gaps: Optional[list] = None,
) -> dict[str, Any]:
    """Join one route record with its replica-side evidence into the
    causal timeline ``GET /admin/fleet/trace/<id>`` serves.

    ``flights`` maps replica name -> that replica's flight-record dicts
    for this request id (newest first, as ``/admin/requests`` returns
    them); ``transfers`` is the merged KV-ledger evidence;
    ``evidence_gaps`` names every scrape that failed. All three default
    to empty — an offline assembly over just the route record is valid
    (and is what the microbench measures)."""
    flights = flights or {}
    transfers = transfers or []
    gaps = list(evidence_gaps or [])
    attempts_in = route_record.get("attempts")
    if not isinstance(attempts_in, list):
        attempts_in = []
        gaps.append("route record carries no attempts list")
    attempts: list[dict[str, Any]] = []
    for index, entry in enumerate(attempts_in):
        if not isinstance(entry, dict):
            gaps.append(f"attempt {index}: malformed route entry")
            continue
        replica = entry.get("replica")
        merged = {
            "index": index,
            "kind": "resume" if entry.get("resume_from") is not None
            else "attempt",
            "flight": _match_flight(
                flights.get(replica) or [], route_record, index
            ),
        }
        merged.update(
            {k: v for k, v in entry.items() if not str(k).startswith("_")}
        )
        attempts.append(merged)
    served = next(
        (a for a in attempts if a.get("status") == 200 and a["flight"]),
        None,
    )
    for attempt in attempts:
        if attempt.get("status") == 200 and attempt["flight"] is None:
            replica = attempt.get("replica") or "?"
            gaps.append(
                f"attempt {attempt['index']}: no flight record scraped "
                f"from {replica} (ring evicted, replica restarted, or "
                "scrape failed)"
            )
    return {
        "request_id": request_id,
        "router": {
            k: route_record.get(k)
            for k in (
                "router_id", "ts", "method", "path", "tenant", "status",
                "outcome", "retries", "resumes", "stream", "resumable",
                "role", "kv_donor", "elapsed_ms",
            )
        },
        "attempts": attempts,
        "transfers": transfers,
        "latency": _decompose(route_record, served),
        "partial": bool(gaps),
        "evidence_gaps": gaps,
    }


def _match_flight(candidates: list, route_record: dict[str, Any],
                  index: int) -> Optional[dict[str, Any]]:
    """The flight record this route-record attempt caused: its origin
    block names this router and this attempt index (the hop stamp,
    round-tripped through the replica's contextvar). Fuzz-safe: any
    malformed candidate is skipped, never raised on."""
    router_id = route_record.get("router_id")
    fallback = None
    for flight in candidates:
        if not isinstance(flight, dict):
            continue
        origin = flight.get("origin")
        if not isinstance(origin, dict):
            continue
        if router_id is not None and origin.get("router") != router_id:
            continue
        if origin.get("attempt") == index:
            return flight
        if fallback is None:
            fallback = flight
    # a single-candidate scrape with a mismatched/absent attempt index
    # is still far better evidence than nothing — but only when the
    # route record has exactly one attempt to confuse it with
    if fallback is not None and len(route_record.get("attempts") or []) == 1:
        return fallback
    return None


def _decompose(route_record: dict[str, Any],
               served: Optional[dict[str, Any]]) -> dict[str, Any]:
    """Per-stage latency split of the router's end-to-end elapsed:
    router overhead (admission, selection, failed attempts, resume
    hunts), replica queue wait, device TTFT net of queue, and stream
    delivery (the remainder). Fields are None when the evidence that
    would pin them is missing — a partial trace decomposes partially,
    it does not invent numbers."""
    total = route_record.get("elapsed_ms")
    out: dict[str, Any] = {
        "total_ms": total,
        "router_overhead_ms": None,
        "replica_queue_ms": None,
        "device_ttft_ms": None,
        "stream_ms": None,
    }
    if not isinstance(total, (int, float)):
        return out
    upstream = 0.0
    for entry in route_record.get("attempts") or []:
        if isinstance(entry, dict) and isinstance(
            entry.get("elapsed_ms"), (int, float)
        ):
            upstream += entry["elapsed_ms"]
    out["router_overhead_ms"] = round(max(0.0, total - upstream), 1)
    flight = (served or {}).get("flight") or {}
    queue_s = flight.get("queue_wait_s")
    ttft_s = flight.get("ttft_s")
    if isinstance(queue_s, (int, float)):
        out["replica_queue_ms"] = round(queue_s * 1000, 1)
    if isinstance(ttft_s, (int, float)):
        net = ttft_s - (queue_s if isinstance(queue_s, (int, float)) else 0.0)
        out["device_ttft_ms"] = round(max(0.0, net) * 1000, 1)
        consumed = out["router_overhead_ms"] + (
            out["replica_queue_ms"] or 0.0
        ) + out["device_ttft_ms"]
        out["stream_ms"] = round(max(0.0, total - consumed), 1)
    return out


def gather_evidence(fleet: Any, request_id: str,
                    route_record: dict[str, Any],
                    timeout_s: float = 1.0) -> dict[str, Any]:
    """Scrape the replica-side evidence for one route record: flight
    records from every replica the attempts name, KV-transfer ledger
    entries from those replicas plus the named donor. Uses the same
    unauthenticated replica admin clients the prober uses (the fleet
    runs on a trusted segment). Returns the ``assemble`` keyword set;
    every failure becomes an ``evidence_gaps`` entry, never an
    exception — partial-with-evidence is the contract."""
    by_name = {r.name: r for r in fleet.replica_set.replicas}
    names: list[str] = []
    for entry in route_record.get("attempts") or []:
        if isinstance(entry, dict):
            replica = entry.get("replica")
            if replica and replica not in names:
                names.append(replica)
    donor = route_record.get("kv_donor")
    ledger_names = list(names)
    if donor and donor not in ledger_names:
        ledger_names.append(donor)
    flights: dict[str, list] = {}
    transfers: list[dict[str, Any]] = []
    gaps: list[str] = []
    for name in names:
        replica = by_name.get(name)
        if replica is None:
            gaps.append(f"{name}: replica no longer in the fleet")
            continue
        try:
            flights[name] = _scrape_flights(replica, request_id, timeout_s)
        except Exception as exc:
            gaps.append(f"{name}: flight scrape failed ({exc})")
    for name in ledger_names:
        replica = by_name.get(name)
        if replica is None:
            if name == donor:
                gaps.append(f"{name}: donor no longer in the fleet")
            continue
        try:
            transfers.extend(
                _scrape_transfers(replica, request_id, timeout_s)
            )
        except Exception as exc:
            gaps.append(f"{name}: transfer-ledger scrape failed ({exc})")
    return {
        "flights": flights, "transfers": transfers, "evidence_gaps": gaps,
    }


def _scrape_flights(replica: Any, request_id: str,
                    timeout_s: float) -> list[dict[str, Any]]:
    data = _admin_get(
        replica,
        f"/admin/requests?request_id={request_id}"
        f"&limit={_FLIGHTS_PER_REPLICA}",
        timeout_s,
    )
    requests = data.get("requests")
    return requests if isinstance(requests, list) else []


def _scrape_transfers(replica: Any, request_id: str,
                      timeout_s: float) -> list[dict[str, Any]]:
    data = _admin_get(replica, "/admin/engine", timeout_s)
    ledgers = data.get("kv_transfer")
    if not isinstance(ledgers, dict):
        return []
    out: list[dict[str, Any]] = []
    for side, key in (("donor", "served_recent"), ("receiver", "pulls_recent")):
        for entry in ledgers.get(key) or []:
            if (
                isinstance(entry, dict)
                and entry.get("request_id") == request_id
            ):
                out.append({"replica": replica.name, "side": side, **entry})
    return out


def _admin_get(replica: Any, target: str, timeout_s: float) -> dict[str, Any]:
    """One bounded replica admin GET, unwrapping the framework's
    ``{"data": ...}`` envelope (same shape the prober's engine scrape
    handles). Raises on any non-200/parse failure — the caller turns
    that into an evidence gap."""
    import json

    resp = replica.client.request(
        "GET", target,
        connect_timeout=timeout_s, read_timeout=timeout_s, retries=0,
    )
    if resp.status_code != 200:
        raise RuntimeError(f"HTTP {resp.status_code}")
    data = json.loads(resp.body.decode("utf-8"))
    if isinstance(data, dict) and isinstance(data.get("data"), dict):
        data = data["data"]
    if not isinstance(data, dict):
        raise RuntimeError("unexpected response shape")
    return data
