"""Trace capture: production traffic becomes a regression suite.

The fleet already records what it served — the router's route records
(``/admin/fleet``) and each replica's flight records
(``/admin/requests``), correlated by the fleet-wide request id the
hop layer stamps. This module (a copy of
``gofr_tpu/devtools/trace_capture.py``) converts that evidence into the
EXACT event schema the JAX package's ``devtools/fleetsim.py::build_trace``
emits, so a window captured from a port fleet replays through that
harness (``--replay FILE``) under the same absolute SLO gate as the
synthetic trace. The port's own fleetsim is ROADMAP §A5's remainder.

Anonymization contract (seeded, deterministic — the same capture
scraped twice yields byte-identical events and digest):

- **tenants** are replaced by ``t-<sha256(seed:tenant)[:8]>`` — stable
  within a capture (quota/Zipf structure survives), unlinkable across
  captures with different seeds;
- **sessions** come from the route record's already-hashed affinity
  key (the router never stores the raw key because it can be prompt
  text) — prefix-reuse structure survives as ``s-<hash[:8]>``;
- **prompts are shapes only**: a synthetic token list of the SAME
  length as the served prompt, drawn from ``random.Random`` seeded by
  ``(seed, index, length)``. No prompt content ever leaves the fleet —
  the flight record never stored it and the capture never sees it.

What replays faithfully: arrival times, tenant mix, session/prefix
reuse, priorities, stream vs unary vs mid-stream-abort mix, prompt
lengths, output budgets. What does not: token CONTENT (shapes only,
by design) and upstream faults (replay layers its own scenario).
"""

from __future__ import annotations

import hashlib
import json
import random
import urllib.request
from typing import Any, Optional



def _digest(payload: Any) -> str:
    """Canonical-JSON sha256 (fleetsim's replayability witness): same
    events, byte-identical digest."""
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()

CAPTURE_SCHEMA = 1

# fleetsim's echo vocabulary: synthetic prompt tokens must stay inside
# it so replayed prefixes hash/alias exactly like built ones
_VOCAB = 997


def anonymize_tenant(tenant: str, seed: int) -> str:
    digest = hashlib.sha256(f"{seed}:{tenant}".encode("utf-8")).hexdigest()
    return f"t-{digest[:8]}"


def synthetic_prompt(seed: int, index: int, length: int) -> list[int]:
    """Shape-preserving prompt replacement: deterministic in
    ``(seed, index, length)`` so capture runs are byte-identical, same
    length as the served prompt so KV block counts and chunked-prefill
    behavior replay faithfully."""
    rng = random.Random(f"trace-capture|{seed}|{index}|{length}")
    return [rng.randint(1, _VOCAB) for _ in range(length)]


def build_events(
    routes: list[dict[str, Any]],
    flights: list[dict[str, Any]],
    seed: int,
) -> tuple[list[dict[str, Any]], dict[str, int]]:
    """Join route records with flight records (on request id) and emit
    fleetsim-schema events, oldest first. Returns ``(events, dropped)``
    where ``dropped`` counts every record excluded and why — a capture
    must say what it did NOT keep, or a thin capture reads as a quiet
    fleet."""
    by_id: dict[str, dict[str, Any]] = {}
    for flight in flights:
        rid = isinstance(flight, dict) and flight.get("request_id")
        if rid and rid not in by_id:
            by_id[rid] = flight  # newest-first scrape: first wins
    dropped = {"shed": 0, "no_timestamp": 0, "malformed": 0}
    joined: list[tuple[float, dict[str, Any], Optional[dict[str, Any]]]] = []
    for route in routes:
        if not isinstance(route, dict):
            dropped["malformed"] += 1
            continue
        outcome = str(route.get("outcome") or "")
        if outcome.startswith("shed:"):
            # shed before forwarding: no prompt evidence exists anywhere
            # (by design — the request never reached a replica). The
            # replay regenerates pressure from the kept arrivals.
            dropped["shed"] += 1
            continue
        ts = route.get("ts")
        if not isinstance(ts, (int, float)):
            dropped["no_timestamp"] += 1
            continue
        joined.append((float(ts), route, by_id.get(route.get("request_id"))))
    joined.sort(key=lambda item: item[0])
    t0 = joined[0][0] if joined else 0.0
    events: list[dict[str, Any]] = []
    rng = random.Random(f"trace-capture-seeds|{seed}")
    for ts, route, flight in joined:
        index = len(events)
        flight = flight or {}
        tokens_in = flight.get("tokens_in")
        length = tokens_in if isinstance(tokens_in, int) and tokens_in > 0 else 8
        kind = "stream" if route.get("stream") else "unary"
        abort_after = None
        if kind == "stream" and route.get("outcome") == "aborted":
            kind = "abort_stream"
            tokens_out = flight.get("tokens_out")
            abort_after = max(
                1, min(8, tokens_out if isinstance(tokens_out, int) else 2)
            )
        max_tokens = flight.get("tokens_out")
        if not isinstance(max_tokens, int) or max_tokens < 1:
            max_tokens = 16
        affinity = route.get("affinity_key")
        events.append({
            "at_s": round(ts - t0, 4),
            "phase": "captured",
            "tenant": anonymize_tenant(str(route.get("tenant") or "-"), seed),
            "session": (
                f"s-{str(affinity)[:8]}" if affinity else f"s-solo{index:03d}"
            ),
            "priority": (
                flight.get("priority")
                if isinstance(flight.get("priority"), int) else 5
            ),
            "kind": kind,
            "abort_after": abort_after,
            "prompt": synthetic_prompt(seed, index, length),
            "max_tokens": max_tokens,
            "seed": rng.randint(1, 10_000),
            "i": index,
        })
    return events, dropped


def capture_artifact(
    routes: list[dict[str, Any]],
    flights: list[dict[str, Any]],
    seed: int,
    source: Optional[dict[str, Any]] = None,
) -> dict[str, Any]:
    """The TRACE_CAPTURE artifact ``--replay`` consumes: events in the
    fleetsim schema plus the digest that witnesses determinism (the
    same fleet state captured twice with the same seed produces the
    same digest, byte for byte)."""
    events, dropped = build_events(routes, flights, seed)
    return {
        "kind": "TRACE_CAPTURE",
        "schema": CAPTURE_SCHEMA,
        "seed": seed,
        "source": source or {},
        "requests": len(events),
        "dropped": dropped,
        "digest": _digest(events),
        "events": events,
    }


def load_capture(path: str) -> dict[str, Any]:
    """Read + validate a TRACE_CAPTURE file for ``--replay``. Raises
    ``ValueError`` with a directly actionable message on shape or
    digest mismatch — replaying a hand-edited capture silently would
    void the determinism witness."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("kind") != "TRACE_CAPTURE":
        raise ValueError(
            f"{path}: not a TRACE_CAPTURE artifact "
            "(expected trace_capture output)"
        )
    events = data.get("events")
    if not isinstance(events, list) or not events:
        raise ValueError(f"{path}: capture has no events to replay")
    actual = _digest(events)
    if actual != data.get("digest"):
        raise ValueError(
            f"{path}: digest mismatch (file says {data.get('digest')}, "
            f"events hash to {actual}) — the capture was edited or "
            "truncated; re-capture instead of patching events by hand"
        )
    return data


# -- live scraping (the CLI path; fleetsim captures in-process) --------------

def _get_json(url: str, timeout: float = 10.0) -> Any:
    with urllib.request.urlopen(
        urllib.request.Request(url), timeout=timeout
    ) as resp:
        data = json.loads(resp.read().decode("utf-8"))
    if isinstance(data, dict) and isinstance(data.get("data"), dict):
        return data["data"]  # the framework envelope
    return data


def scrape_routes(router_base: str, limit: int = 1000) -> list[dict[str, Any]]:
    data = _get_json(f"{router_base}/admin/fleet?limit={limit}")
    routes = data.get("routes") if isinstance(data, dict) else None
    return routes if isinstance(routes, list) else []


def scrape_flights(replica_base: str,
                   limit: int = 1000) -> list[dict[str, Any]]:
    data = _get_json(f"{replica_base}/admin/requests?limit={limit}")
    flights = data.get("requests") if isinstance(data, dict) else None
    return flights if isinstance(flights, list) else []


def main(argv: Optional[list] = None) -> int:
    """The CLI: ``python -m gofr_tpu_torch.devtools.trace_capture --router
    URL [--replica URL ...] [--seed N] [--limit N] [--out FILE]`` prints
    the artifact (and writes it to ``--out``); exit 1 when nothing was
    captured."""
    import argparse
    import sys
    import time

    parser = argparse.ArgumentParser(description="capture a live fleet's traffic")
    parser.add_argument("--router", required=True, help="router base URL (route records)")
    parser.add_argument("--replica", action="append", default=[],
                        help="replica base URL (flight records); repeatable")
    parser.add_argument("--seed", type=int, default=20260807, help="anonymization seed")
    parser.add_argument("--limit", type=int, default=1000,
                        help="max records scraped per endpoint")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    routes = scrape_routes(args.router, limit=args.limit)
    flights: list = []
    for base in args.replica:
        try:
            flights.extend(scrape_flights(base, limit=args.limit))
        except Exception as exc:
            print(f"trace_capture: {base}: flight scrape failed ({exc}) — "
                  "capturing without its evidence", file=sys.stderr)
    artifact = capture_artifact(
        routes, flights, args.seed,
        # gofrlint: wall-clock — capture timestamp (display)
        source={"router": args.router, "replicas": args.replica, "captured_at": time.time()},
    )
    blob = json.dumps(artifact, indent=2, sort_keys=True)
    print(blob)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    print(f"trace_capture: {artifact['requests']} events (dropped {artifact['dropped']}), "
          f"digest {artifact['digest'][:16]}…", file=sys.stderr)
    return 0 if artifact["requests"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
