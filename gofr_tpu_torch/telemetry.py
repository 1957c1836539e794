"""Request flight recorder: per-request end-to-end inference telemetry,
and the generation journal (port of ``gofr_tpu/telemetry.py``).

The metrics registry says how the server is doing; the flight recorder
says what happened to ONE request. It keeps one ``FlightRecord`` per
inference request (enqueue, dispatch, first-token and last-token marks,
queue wait, TTFT, TPOT, token counts, batch cohort, the dispatch ids it
rode) in a bounded ring, plus an always-keep side buffer for slow and
errored requests, and emits each finished record as one wide-event log
line. ``GET /admin/requests`` serves the records, ``GET /admin/slo``
exact rolling-window TTFT/TPOT percentiles computed from them, and
``GET /admin/tenants`` the bounded per-tenant ledger they meter into.

The record travels with the request as a contextvar: the OpenAI handlers
start it (``flight``), the batcher stamps queue timing and the cohort on
the queue item's captured record, the decode pool the pool cohort and its
chunks' dispatch ids, the device the token timing. Thread boundaries
(handler pool, batcher dispatch, stream producer) carry it with
``contextvars.copy_context()``.

The generation journal answers what the recorder cannot: which tokens an
interrupted generation already emitted. ``GenerationJournal`` keeps one
``JournalEntry`` a generation (keyed by ``request_key``: the prompt's hash,
the sampling knobs with the seed, the budget and the stop set), retires it
at a clean finish and keeps it, bounded, when the generation dies mid-flight
(a pool failure, a recovery teardown), so a resume (``X-Resume-From``)
re-prefills the prompt plus those tokens instead of truncating the stream.
With a ``journal_wal.JournalWAL`` every transition and token also goes to
disk, and ``rehydrate`` reinstates a killed process's entries at boot. The
entry rides its own contextvar (``current_journal_entry``) so the decode
pool can stamp where the stream was interrupted.
"""

from __future__ import annotations

import contextvars
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Optional

from gofr_tpu_torch.deadline import current_deadline, current_priority
from gofr_tpu_torch.errors import DeadlineExceeded
from gofr_tpu_torch.http.response import Stream
from gofr_tpu_torch.tpu.introspect import current_dispatch
from gofr_tpu_torch.tracing import current_trace_id

# process identity, regenerated on every interpreter start: the fleet
# prober compares it across probes to tell "the same process recovered"
# from "a NEW process answers at this address" — the supervisor-restart
# signature a reborn replica walks probation under (fleet/replica.py).
# Served on the ready 200 body and /admin/engine.
BOOT_ID = uuid.uuid4().hex[:16]

_current_record: contextvars.ContextVar[Optional["FlightRecord"]] = (
    contextvars.ContextVar("gofr_flight_record", default=None)
)

def current_record() -> Optional["FlightRecord"]:
    """The in-flight request's FlightRecord, if one is active."""
    return _current_record.get()


_current_journal_entry: contextvars.ContextVar[Optional["JournalEntry"]] = (
    contextvars.ContextVar("gofr_journal_entry", default=None)
)


def current_journal_entry() -> Optional["JournalEntry"]:
    """The in-flight generation's journal entry, if journaling is on."""
    return _current_journal_entry.get()


def activate_journal_entry(entry: Optional["JournalEntry"]) -> Any:
    """Bind ``entry`` as the current one (None clears); returns the reset
    token. The device binds it around each generation, so the pool request
    captures it at submit."""
    return _current_journal_entry.set(entry)


# -- fleet-wide request origin (cross-process hop correlation) ---------------
#
# The fleet router stamps every forward with ``X-Gofr-Request-Id`` (the
# fleet-wide correlation id, minted once — or honored from a sanitized
# client ``X-Request-ID``) and ``X-Gofr-Hop`` (which router, which
# failover attempt, which resume continuation). Replicas parse both at
# admission into a contextvar — the same pattern the deadline and the
# KV-donor hint ride — and every FlightRecord born under it carries an
# ``origin`` block, so ``GET /admin/fleet/trace/<id>`` can join the
# router's route record with the replica-side flight records it caused.

# request ids are operator-facing correlation keys that end up in log
# lines, URLs and admin queries: bound length, restrict charset, and
# treat anything else as absent (garbage degrades to a minted id, never
# to a 4xx — same discipline as parse_kv_hint)
REQUEST_ID_MAX_LEN = 64
_REQUEST_ID_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)

_current_origin: contextvars.ContextVar[Optional[dict]] = (
    contextvars.ContextVar("gofr_request_origin", default=None)
)


def sanitize_request_id(raw: Any) -> Optional[str]:
    """Validate a request id off the wire: non-empty, at most
    ``REQUEST_ID_MAX_LEN`` chars, charset ``[A-Za-z0-9._-]``. Returns
    the id or None — callers mint their own on None, never reject."""
    if not raw or not isinstance(raw, str):
        return None
    value = raw.strip()
    if not value or len(value) > REQUEST_ID_MAX_LEN:
        return None
    if not all(c in _REQUEST_ID_CHARS for c in value):
        return None
    return value


def format_hop(router_id: str, attempt: int, resume_from: int = 0) -> str:
    """The ``X-Gofr-Hop`` wire value the router stamps per forward."""
    return f"router={router_id};attempt={int(attempt)};resume={int(resume_from)}"


def parse_hop(raw: Any) -> Optional[dict]:
    """Parse an ``X-Gofr-Hop`` header (``router=<id>;attempt=<n>;
    resume=<n>``) into ``{"router", "attempt", "resume_from"}``.
    Malformed input returns None — hop metadata is telemetry, never a
    reason to fail a request."""
    if not raw or not isinstance(raw, str) or len(raw) > 256:
        return None
    fields: dict[str, str] = {}
    for part in raw.strip().split(";"):
        key, sep, value = part.partition("=")
        if sep:
            fields[key.strip()] = value.strip()
    router = sanitize_request_id(fields.get("router", ""))
    if router is None:
        return None
    try:
        attempt = int(fields.get("attempt", ""))
        resume_from = int(fields.get("resume", "0"))
    except ValueError:
        return None
    if attempt < 0 or resume_from < 0:
        return None
    return {"router": router, "attempt": attempt, "resume_from": resume_from}


def activate_origin(origin: Optional[dict]) -> Any:
    """Bind the request's fleet origin (``{"request_id", "router",
    "attempt", "resume_from"}``; None clears) so the FlightRecord born
    downstream stamps it. Returns the contextvar reset token."""
    return _current_origin.set(origin)


def current_origin() -> Optional[dict]:
    """The in-flight request's fleet origin block, if the router
    stamped one (None on direct, router-less requests)."""
    return _current_origin.get()


def origin_from_headers(request_id_raw: Any, hop_raw: Any) -> Optional[dict]:
    """Build the origin block from the two router-stamped headers.
    Either header alone still yields a (partial) origin; both absent or
    garbage yields None."""
    request_id = sanitize_request_id(request_id_raw)
    hop = parse_hop(hop_raw)
    if request_id is None and hop is None:
        return None
    origin: dict[str, Any] = {"request_id": request_id or ""}
    if hop is not None:
        origin.update(hop)
    return origin


# -- tenant identity (bounded-cardinality usage metering) --------------------
#
# The admission gate resolves the request's HASHED tenant id
# (fleet/admission.py::tenant_of: sha256 of the Authorization value — never
# raw key material) and binds it here, the same contextvar ride the
# deadline, the KV-donor hint, and the fleet origin take. The
# FlightRecord born downstream stamps it, the recorder's TenantLedger
# meters it, and /admin/requests?tenant= joins a support ticket to the
# flight records that carried it.

_current_tenant: contextvars.ContextVar[Optional[str]] = (
    contextvars.ContextVar("gofr_request_tenant", default=None)
)


def activate_tenant(tenant: Optional[str]) -> Any:
    """Bind the request's hashed tenant id (None/"" clears); returns the
    contextvar reset token."""
    return _current_tenant.set(tenant or None)


def current_tenant() -> Optional[str]:
    """The in-flight request's hashed tenant id, if admission bound one
    (None on paths that never ran the admission gate)."""
    return _current_tenant.get()


def exemplar_provider() -> Optional[dict]:
    """Default metrics exemplar provider (metrics.py Histogram): the
    correlating ids of the CURRENT observation — the active request's
    trace_id (flight record first, else the live span) and, below the
    dispatch layer, the executing dispatch_id. Contextvar reads only:
    O(1), no locks, safe on the hot path. Returns None outside any
    request/dispatch context (boot-time observations stay exemplar-free)."""
    labels: dict[str, str] = {}
    record = _current_record.get()
    trace_id = record.trace_id if record is not None else ""
    if not trace_id:
        trace_id = current_trace_id() or ""
    if trace_id:
        labels["trace_id"] = trace_id
    dispatch = current_dispatch()
    if dispatch is not None:
        labels["dispatch_id"] = str(dispatch.dispatch_id)
    return labels or None


def activate_record(record: Optional["FlightRecord"]) -> Any:
    """Bind ``record`` as the current one; returns the reset token.
    Handlers run inside a per-request copied context (handler.py), so
    not resetting leaks nothing past the request."""
    return _current_record.set(record)


class FlightRecord:
    """One request's flight data. Marks are ``time.perf_counter`` values
    anchored to ``wall_start`` (``time.time`` at creation) for display.
    Single-shot marks are set-once attribute assignments (atomic under
    the GIL); the accumulating fields (``tokens_out``, ``pool_cohort``)
    take the record's lock — an n>1 fan-out runs candidates concurrently
    against ONE record, and ``+=`` is a read-modify-write."""

    __slots__ = (
        "trace_id", "request_id", "origin",
        "model", "endpoint", "status", "error", "stream",
        "tokens_in", "tokens_out", "batch_size", "pool_cohort",
        "prefill_chunks", "prefill_bucket", "sched_defer_s",
        "pool_reject_reason", "dispatch_ids", "anomalous_dispatches",
        "spec_drafted", "spec_accepted", "spec_dispatches", "spec_emitted",
        "kv_blocks", "kv_aliased_blocks", "mesh_axes",
        "tenant", "deadline_s", "priority", "shed_stage",
        "wall_start", "t_start", "t_enqueue", "t_dispatch",
        "t_first_token", "t_last_token", "t_done", "wall_done", "_lock",
        "__weakref__",  # the recorder's in-flight map holds records weakly
    )

    # device dispatches linked per record: enough to cover a prefill, its
    # chunks, and the first pooled decode chunks without letting a
    # 10k-token generation grow the record unboundedly
    MAX_DISPATCH_IDS = 32

    def __init__(
        self,
        model: str,
        endpoint: str,
        trace_id: str = "",
        tokens_in: int = 0,
        stream: bool = False,
    ):
        self.trace_id = trace_id
        # fleet origin: the router-stamped request id + hop block, read
        # off the origin contextvar exactly like the deadline below —
        # this is what lets /admin/fleet/trace/<id> find the replica
        # flight records one routed request caused
        origin = current_origin()
        self.request_id = origin.get("request_id", "") if origin else ""
        self.origin = None
        if origin and "router" in origin:
            self.origin = {
                "router": origin.get("router"),
                "attempt": origin.get("attempt"),
                "resume_from": origin.get("resume_from"),
            }
        self.model = model
        self.endpoint = endpoint
        self.status = "in_flight"
        self.error = ""
        self.stream = stream
        self.tokens_in = tokens_in
        self.tokens_out = 0
        self.batch_size = 0  # prefill batch cohort (batcher dispatch)
        self.pool_cohort = 0  # active decode-pool slots when this joined
        self.prefill_chunks = 0  # bounded-compute prefill dispatches
        self.prefill_bucket = 0  # widest compiled bucket the prefill rode
        self.sched_defer_s = 0.0  # total interference-scheduler defer
        self.pool_reject_reason = ""  # why the decode pool refused (solo'd)
        self.dispatch_ids: list[int] = []  # device dispatches this rode
        # of those, the ones the cost model flagged anomalous
        # (tpu/costmodel.py): a slow request's wide event names the
        # exact dispatch that blew its prediction
        self.anomalous_dispatches: list[int] = []
        # pooled speculative decoding (tpu/spec_pool.py): draft tokens
        # proposed/accepted and the verify dispatches + tokens they
        # emitted — tokens_per_dispatch is THE number speculation exists
        # to raise (1.0 = plain decode), percentiled on /admin/slo
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_dispatches = 0
        self.spec_emitted = 0
        self.kv_blocks = 0  # paged-KV blocks reserved for this request
        self.kv_aliased_blocks = 0  # of those, admitted copy-free (prefix share)
        # serving-mesh axes this request ran on ({"tp": 2, ...}; None =
        # single chip) — latency is only comparable within one topology
        self.mesh_axes: Optional[dict] = None
        # hashed tenant id (admission gate via the tenant contextvar —
        # same ride as the origin above); None on paths that never ran
        # admission (bare test containers, internal probes)
        self.tenant = current_tenant()
        # deadline-aware serving: the request's total budget and priority
        # tier, read off the admission gate's contextvars (the tier rides
        # its own var, so a request with X-Priority and no deadline still
        # records it), and where an exceeded deadline shed it (queue |
        # admission | decode; "" = never)
        deadline = current_deadline()
        self.deadline_s: Optional[float] = deadline.budget_s if deadline is not None else None
        self.priority: Optional[int] = (
            deadline.priority if deadline is not None else current_priority()
        )
        self.shed_stage = ""
        self.wall_start = time.time()
        self.t_start = time.perf_counter()
        self.t_enqueue: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.wall_done: Optional[float] = None
        self._lock = threading.Lock()

    # -- marks (called from batcher / pool / device) -------------------------
    def mark_enqueue(self) -> None:
        if self.t_enqueue is None:
            self.t_enqueue = time.perf_counter()

    def mark_dispatch(self, cohort: int) -> None:
        """First prefill dispatch: stamps the batch cohort this request
        rode with (later dispatches — chunked prefill — keep the first)."""
        if self.t_dispatch is None:
            self.t_dispatch = time.perf_counter()
            self.batch_size = cohort

    def mark_first_token(self) -> None:
        if self.t_first_token is None:
            self.t_first_token = time.perf_counter()

    def mark_pooled(self, cohort: int) -> None:
        """Decode joined the continuous-batching pool with ``cohort``
        active slots (keeps the max seen across fan-out candidates)."""
        with self._lock:
            if cohort > self.pool_cohort:
                self.pool_cohort = cohort

    def note_prefill_chunk(self, n: int = 1, bucket: int = 0) -> None:
        """Prefill dispatch accounting: ``n`` bounded-compute chunks
        landed, each through a ``bucket``-wide compiled shape (the widest
        seen is kept — bucket vs. ``tokens_in`` shows the padding a
        request paid)."""
        with self._lock:
            self.prefill_chunks += n
            if bucket > self.prefill_bucket:
                self.prefill_bucket = bucket

    def note_sched_defer(self, seconds: float) -> None:
        """Interference-scheduler defer: time this request's prefill
        chunks waited for their decode-interleave turn (accumulates
        across chunks)."""
        if seconds and seconds > 0:
            with self._lock:
                self.sched_defer_s += seconds

    def note_dispatch_id(self, dispatch_id: int) -> None:
        """Link a device dispatch (tpu/introspect.py DispatchTimeline)
        this request rode — `/admin/requests` entries then resolve
        directly to the `/admin/dispatches` records that carried them.
        Bounded at MAX_DISPATCH_IDS (the decode pool stamps every chunk a
        pooled stream shares)."""
        with self._lock:
            if len(self.dispatch_ids) < self.MAX_DISPATCH_IDS:
                self.dispatch_ids.append(dispatch_id)

    def note_anomaly(self, dispatch_id: int) -> None:
        """The cost model flagged a dispatch this request rode as
        anomalous (observed blew past predicted, tpu/costmodel.py) —
        the wide event then pins the slow request to the exact
        `/admin/anomalies` entry. Same bound as the id list."""
        with self._lock:
            if (
                dispatch_id not in self.anomalous_dispatches
                and len(self.anomalous_dispatches) < self.MAX_DISPATCH_IDS
            ):
                self.anomalous_dispatches.append(dispatch_id)

    def note_pool_reject(self, reason: str) -> None:
        """The decode pool refused this request (it decoded solo); the
        FIRST rejection reason is kept — later fan-out candidates may
        see a different pool state."""
        if not self.pool_reject_reason:
            self.pool_reject_reason = reason

    def note_spec(self, drafted: int, accepted: int, emitted: int,
                  dispatches: int = 1) -> None:
        """One pooled-spec delivery this request rode: ``drafted``
        draft tokens proposed, ``accepted`` of them matched the target,
        ``emitted`` tokens delivered. ``dispatches`` is the
        weight-stream count of the delivery — 1 for a verify cycle
        (ONE forward whatever the width: the spec win), the pool's
        chunk size for a plain chunk a spec-armed row rode (one stream
        per scan step) — so tokens_per_dispatch reads 1.0 for plain
        decode on every producer and >1.0 only for real speculation."""
        with self._lock:
            self.spec_drafted += drafted
            self.spec_accepted += accepted
            self.spec_dispatches += dispatches
            self.spec_emitted += emitted

    def note_kv(self, blocks: int, aliased: int = 0) -> None:
        """Paged-KV admission accounting: ``blocks`` reserved for this
        request, ``aliased`` of them shared copy-free with the prefix
        cache. Keeps the max seen (fan-out candidates admit separately)."""
        with self._lock:
            if blocks > self.kv_blocks:
                self.kv_blocks = blocks
            if aliased > self.kv_aliased_blocks:
                self.kv_aliased_blocks = aliased

    def note_tokens(self, n: int = 1) -> None:
        with self._lock:
            self.tokens_out += n
        self.t_last_token = time.perf_counter()

    def note_shed(self, stage: str) -> None:
        """The FIRST stage that gave up on the request's deadline wins."""
        if not self.shed_stage:
            self.shed_stage = stage

    def note_error(self, exc: BaseException) -> None:
        """Device-layer failure: remembered even if the transport still
        manages a response (a stream that already committed its 200). A
        deadline shed keeps its own status: a spent budget and a broken
        device stay apart on /admin/requests and in the SLO error rate."""
        if isinstance(exc, DeadlineExceeded):
            self.status = "deadline_exceeded"
            if exc.stage:
                self.note_shed(exc.stage)
        else:
            self.status = "error"
        self.error = f"{type(exc).__name__}: {exc}"

    # -- derived -------------------------------------------------------------
    @property
    def queue_wait(self) -> Optional[float]:
        if self.t_enqueue is None or self.t_dispatch is None:
            return None
        return self.t_dispatch - self.t_enqueue

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_start

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token AFTER the first (decode cadence)."""
        if (
            self.t_first_token is None or self.t_last_token is None
            or self.tokens_out < 2
        ):
            return None
        return (self.t_last_token - self.t_first_token) / (self.tokens_out - 1)

    @property
    def duration(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_start

    @property
    def tokens_per_dispatch(self) -> Optional[float]:
        """Tokens emitted per target weight-stream while spec-armed
        (1.0 = plain decode; None = never rode the spec path)."""
        if self.spec_dispatches < 1:
            return None
        return self.spec_emitted / self.spec_dispatches

    def to_dict(self) -> dict[str, Any]:
        """The wide-event shape: every field, one flat dict. Durations in
        seconds (floats); wall timestamps in unix seconds."""

        def _offset(mark: Optional[float]) -> Optional[float]:
            if mark is None:
                return None
            return self.wall_start + (mark - self.t_start)

        return {
            "event": "request_flight",
            "trace_id": self.trace_id,
            "request_id": self.request_id or None,
            "origin": self.origin,
            "model": self.model,
            "endpoint": self.endpoint,
            "status": self.status,
            "error": self.error or None,
            "stream": self.stream,
            "tokens_in": self.tokens_in,
            "tokens_out": self.tokens_out,
            "batch_size": self.batch_size,
            "pool_cohort": self.pool_cohort,
            "prefill_chunks": self.prefill_chunks,
            "prefill_bucket": self.prefill_bucket or None,
            "sched_defer_s": self.sched_defer_s or None,
            "pool_reject_reason": self.pool_reject_reason or None,
            "dispatch_ids": list(self.dispatch_ids),
            "anomalous_dispatches": list(self.anomalous_dispatches) or None,
            "spec_drafted": self.spec_drafted or None,
            "spec_accepted": self.spec_accepted or None,
            "tokens_per_dispatch": self.tokens_per_dispatch,
            "kv_blocks": self.kv_blocks or None,
            "kv_aliased_blocks": self.kv_aliased_blocks or None,
            "mesh_axes": self.mesh_axes,
            "tenant": self.tenant,
            "deadline_s": self.deadline_s,
            "priority": self.priority,
            "shed_stage": self.shed_stage or None,
            "start_ts": self.wall_start,
            "enqueue_ts": _offset(self.t_enqueue),
            "dispatch_ts": _offset(self.t_dispatch),
            "first_token_ts": _offset(self.t_first_token),
            "done_ts": self.wall_done,
            "queue_wait_s": self.queue_wait,
            "ttft_s": self.ttft,
            "tpot_s": self.tpot,
            "duration_s": self.duration,
        }



def request_key(model: str, prompt_ids: Any, max_new_tokens: int,
                sampler: Any = None, stop_tokens: Any = None) -> str:
    """Deterministic identity of one generation request: the journal
    key interrupted entries are claimed back by at resume time. Hashes
    the prompt (never stores it raw — prompts are user data, the
    journal serves on no endpoint but its key could leak into logs),
    the sampling knobs INCLUDING the seed, the budget, and the stop
    set: two requests that could produce different streams must never
    share a key."""
    import hashlib

    parts = [model, str(int(max_new_tokens))]
    if sampler is not None:
        parts.append(
            f"t={getattr(sampler, 'temperature', 0)}"
            f"|k={getattr(sampler, 'top_k', 0)}"
            f"|p={getattr(sampler, 'top_p', 1.0)}"
            f"|m={getattr(sampler, 'min_p', 0.0)}"
            f"|r={getattr(sampler, 'repetition_penalty', 1.0)}"
            f"|pp={getattr(sampler, 'presence_penalty', 0.0)}"
            f"|fp={getattr(sampler, 'frequency_penalty', 0.0)}"
            # an unseeded request draws a random seed of its own: the key
            # must not carry it, or no resume would find its entry
            f"|s={getattr(sampler, 'seed', None) if getattr(sampler, 'seeded', True) else None}"
        )
    if stop_tokens:
        parts.append(",".join(str(t) for t in sorted(stop_tokens)))
    digest = hashlib.sha256()
    for part in parts:
        digest.update(part.encode("utf-8"))
        digest.update(b"\x00")
    digest.update(
        ",".join(str(int(t)) for t in (prompt_ids or ())).encode("ascii")
    )
    return digest.hexdigest()[:32]


class JournalEntry:
    """One generation's durable record. Single-writer append (the
    emitting thread); ``tokens`` reads take a snapshot copy under the
    GIL (list slicing is atomic). Status walks
    active → done | interrupted → resumed."""

    __slots__ = (
        "key", "model", "max_new_tokens", "seeded", "deterministic",
        "tokens", "status", "reason", "t_start", "t_interrupted",
        "prior", "truncated", "max_tokens", "wal_id", "_wal",
    )

    def __init__(self, key: str, model: str, max_new_tokens: int,
                 seeded: bool, deterministic: bool, max_tokens: int,
                 prior: Optional[list] = None):
        self.key = key
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.seeded = seeded
        # greedy or seeded: replaying the request reproduces the stream
        # bit-identically — the precondition for resume
        self.deterministic = deterministic
        self.max_tokens = max_tokens
        # a RESUMED request's entry pre-seeds the tokens the interrupted
        # incarnation already produced, so a second wedge resumes from
        # the union, not from the resume point
        self.tokens: list[int] = list(prior or ())
        self.truncated = False
        self.status = "active"
        self.reason = ""
        self.t_start = time.perf_counter()
        self.t_interrupted: Optional[float] = None
        # write-ahead log attachment (journal_wal.py): when the journal
        # runs durable, every append streams through to disk so a
        # SIGKILLed process rehydrates this entry at next boot
        self.wal_id = 0
        self._wal: Any = None

    def append(self, token: int) -> None:
        if len(self.tokens) >= self.max_tokens:
            # a bounded record can no longer prove bit-identity past its
            # cap — the entry stays for forensics but refuses resume
            if not self.truncated and self._wal is not None:
                # retire the on-disk record too: a rehydrated truncated
                # entry could not prove the tokens past its cap either
                self._wal.retire(self.wal_id)
            self.truncated = True
            return
        self.tokens.append(int(token))
        if self._wal is not None:
            self._wal.append_tokens(self.wal_id, (token,))

    def note_interrupted(self, reason: str) -> None:
        """Stamp WHY (pool failure, batcher close, recovery teardown);
        the first cause wins — later layers see consequences."""
        if not self.reason:
            self.reason = reason

    def snapshot(self) -> dict[str, Any]:
        return {
            "key": self.key,
            "model": self.model,
            "status": self.status,
            "tokens": len(self.tokens),
            "max_new_tokens": self.max_new_tokens,
            "deterministic": self.deterministic,
            "reason": self.reason or None,
        }


class GenerationJournal:
    """Bounded store of :class:`JournalEntry` records keyed by
    :func:`request_key`.

    Completed entries retire immediately (their tokens already reached
    the client); INTERRUPTED entries are the valuable ones — they wait,
    bounded by ``capacity`` (oldest evicted first), for a resume to
    :meth:`claim` them. The journal never initiates anything: the
    device consults it on a resume request (``X-Resume-From`` /
    ``generate_stream(resume_from=...)``) and the fleet router decides
    WHEN to resume."""

    def __init__(self, capacity: int = 256, max_tokens: int = 8192,
                 metrics: Any = None, wal: Any = None):
        self.capacity = max(1, capacity)
        self.max_tokens = max(1, max_tokens)
        self._lock = threading.Lock()
        # key -> list of entries (concurrent identical seeded requests
        # are legal; each gets its own entry, claims pop one)
        self._interrupted: "dict[str, list[JournalEntry]]" = {}
        self._interrupted_order: "deque[JournalEntry]" = deque()
        self._active = 0
        self.interruptions = 0
        self.completions = 0
        # optional write-ahead log (journal_wal.JournalWAL): every
        # lifecycle transition and emitted token streams to disk, and
        # rehydrate() reinstates a SIGKILLed process's resumable entries
        self.wal = wal
        self.rehydrated = 0
        self._resumes = (
            metrics.counter(
                "gofr_tpu_journal_resumes_total",
                "interrupted generations resumed from the journal by "
                "mode: teacher_forced (prefill over prompt+emitted, "
                "paged-KV aliased) or replayed (full deterministic "
                "regeneration, first tokens suppressed)",
                labels=("mode",),
            )
            if metrics is not None else None
        )

    # -- lifecycle (device-side) ----------------------------------------------
    def start(self, key: str, model: str, max_new_tokens: int,
              seeded: bool, deterministic: bool,
              prior: Optional[list] = None) -> JournalEntry:
        entry = JournalEntry(
            key, model, max_new_tokens, seeded, deterministic,
            max_tokens=self.max_tokens, prior=prior,
        )
        if self.wal is not None:
            entry._wal = self.wal
            entry.wal_id = self.wal.open_entry(
                key, model, max_new_tokens, seeded, deterministic,
                prior=prior,
            )
        with self._lock:
            self._active += 1
        return entry

    def rehydrate(self) -> int:
        """Reinstate the WAL's recovered entries as interrupted,
        resumable ones — called once at boot, before serving. Returns
        the count (also on :attr:`rehydrated` and ``stats()``). The
        restarted process then serves ``X-Resume-From`` for its own
        pre-crash streams exactly as if the engine had merely wedged."""
        if self.wal is None:
            return 0
        count = 0
        for state in self.wal.recover():
            entry = JournalEntry(
                state["key"], state["model"], int(state["mnt"]),
                seeded=bool(state["seeded"]),
                deterministic=bool(state["det"]),
                max_tokens=self.max_tokens,
                prior=state.get("tokens") or (),
            )
            entry.wal_id = int(state["id"])
            entry._wal = self.wal
            self.wal.adopt(entry.wal_id, state)
            self.interrupt(entry, state.get("reason") or "process death")
            count += 1
        # interrupt() counted these as live interruptions; recovery
        # evidence must stay distinguishable from in-process failures
        with self._lock:
            self.interruptions -= count
        self.rehydrated = count
        return count

    def finish(self, entry: JournalEntry) -> None:
        """Clean completion: the entry retires (its stream reached the
        client; nothing to resume)."""
        if entry.status != "active":
            return
        entry.status = "done"
        if entry._wal is not None and not entry.truncated:
            entry._wal.finish(entry.wal_id)
        with self._lock:
            self._active = max(0, self._active - 1)
            self.completions += 1

    def interrupt(self, entry: JournalEntry, reason: str) -> None:
        """The generation died mid-flight: retain the entry for resume
        (idempotent — the first interruption wins)."""
        if entry.status != "active":
            return
        entry.status = "interrupted"
        entry.note_interrupted(reason)
        entry.t_interrupted = time.perf_counter()
        if entry._wal is not None and not entry.truncated:
            entry._wal.interrupt(entry.wal_id, entry.reason)
        evictions: list[JournalEntry] = []
        with self._lock:
            self._active = max(0, self._active - 1)
            self.interruptions += 1
            self._interrupted.setdefault(entry.key, []).append(entry)
            self._interrupted_order.append(entry)
            while len(self._interrupted_order) > self.capacity:
                evicted = self._interrupted_order.popleft()
                bucket = self._interrupted.get(evicted.key)
                if bucket is not None:
                    try:
                        bucket.remove(evicted)
                    except ValueError:
                        pass  # already claimed
                    if not bucket:
                        self._interrupted.pop(evicted.key, None)
                evictions.append(evicted)
        for evicted in evictions:
            if evicted._wal is not None and evicted.status == "interrupted":
                # capacity eviction: the on-disk record retires too, or
                # recovery would resurrect an entry the live journal
                # already refused to keep. OUTSIDE the journal lock: a
                # WAL write is disk I/O (fsync on rotation), and the
                # lock sits on the per-token serving path
                evicted._wal.retire(evicted.wal_id)

    # -- resume (device-side, driven by the router/client) ---------------------
    def claim(self, key: str, min_tokens: int = 0) -> Optional[JournalEntry]:
        """Pop one interrupted entry for ``key`` holding at least
        ``min_tokens`` journaled tokens (the client already received
        that many — a shorter record cannot prove them). Returns None
        when nothing matches; the caller then falls back to full
        deterministic replay."""
        claimed: Optional[JournalEntry] = None
        with self._lock:
            bucket = self._interrupted.get(key)
            if not bucket:
                return None
            for i, entry in enumerate(bucket):
                if entry.truncated or len(entry.tokens) < min_tokens:
                    continue
                del bucket[i]
                if not bucket:
                    self._interrupted.pop(key, None)
                try:
                    self._interrupted_order.remove(entry)
                except ValueError:
                    pass
                entry.status = "resumed"
                claimed = entry
                break
        if claimed is not None and claimed._wal is not None:
            # the resumed CONTINUATION opens its own entry (the resume
            # generate passes journal_key/journal_prior), so this record
            # retires — a second crash resumes from the continuation's
            # entry, which holds the union of tokens. OUTSIDE the
            # journal lock: the WAL write is disk I/O
            claimed._wal.claim(claimed.wal_id)
        return claimed

    def note_resume(self, mode: str) -> None:
        """Count one resume by mode (teacher_forced | replayed)."""
        if self._resumes is not None:
            self._resumes.inc(mode=mode)

    # -- read side -------------------------------------------------------------
    def interrupted(self) -> list[dict[str, Any]]:
        with self._lock:
            return [e.snapshot() for e in self._interrupted_order]

    def stats(self) -> dict[str, Any]:
        with self._lock:
            out = {
                "active": self._active,
                "interrupted": len(self._interrupted_order),
                "capacity": self.capacity,
                "max_tokens_per_entry": self.max_tokens,
                "interruptions": self.interruptions,
                "completions": self.completions,
                "rehydrated": self.rehydrated,
            }
        out["wal"] = self.wal.stats() if self.wal is not None else None
        return out


def _percentiles(samples: list[float]) -> dict[str, float]:
    """Exact nearest-rank p50/p95/p99 from raw samples."""
    import math

    ordered = sorted(samples)
    n = len(ordered)

    def rank(q: float) -> float:
        # nearest-rank: smallest value with cumulative fraction >= q
        return ordered[max(0, min(n - 1, math.ceil(q * n) - 1))]

    return {"p50": rank(0.50), "p95": rank(0.95), "p99": rank(0.99)}


class Flight:
    """Handler-side record lifecycle, shared by every endpoint (the
    chat/completions copies drifted once in review). Use as a context
    manager around the generation: a clean exit finishes the record ok;
    an exception finishes it as errored — UNLESS it is a pre-inference
    parameter rejection (a 4xx raised before any device work touched the
    record), which is dropped: records describe actual inference
    attempts, and a client retrying a malformed request must not inflate
    the model's SLO error rate. Streaming handlers call ``defer(result)``
    to hand completion to the stream's end instead."""

    def __init__(self, recorder: Optional["FlightRecorder"],
                 record: Optional[FlightRecord]):
        self.recorder = recorder
        self.record = record
        self._deferred = False

    def defer(self, result: Any) -> Any:
        """Wrap a Stream result: the record completes when the stream
        ends (or the client disconnects), not when the handler returns."""
        self._deferred = True
        if self.recorder is None:
            return result
        return self.recorder.finish_stream(result, self.record)

    def __enter__(self) -> "Flight":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        if self.recorder is None or self.record is None or self._deferred:
            return False
        if exc is None:
            self.recorder.finish(self.record)
            return False
        status_code = getattr(exc, "status_code", None)
        if (
            self.record.status != "error"  # the device never noted a failure
            and isinstance(status_code, int) and status_code < 500
        ):
            return False  # parameter rejection before inference: no record
        self.recorder.finish(self.record, error=exc)
        return False


def flight(
    recorder: Optional["FlightRecorder"],
    model: str,
    endpoint: str,
    trace_id: str = "",
    tokens_in: int = 0,
    stream: bool = False,
) -> Flight:
    """Start (and contextvar-activate) a FlightRecord under a ``Flight``
    lifecycle guard; recorder None (bare test containers) yields an
    inert guard whose ``defer`` passes results through untouched."""
    record = None
    if recorder is not None:
        record = recorder.start(
            model=model, endpoint=endpoint, trace_id=trace_id,
            tokens_in=tokens_in, stream=stream,
        )
    return Flight(recorder, record)


class TenantLedger:
    """Bounded per-tenant usage metering: a space-saving heavy-hitter
    sketch over hashed tenant ids.

    Exactly ``size`` tenants are tracked at a time (``TENANT_LEDGER_SIZE``,
    default 256). Per tracked tenant the ledger keeps exact counters —
    requests, tokens in/out, sheds, deadline misses, errors — from the
    moment the tenant entered the table. When a new tenant arrives at a
    full table, the minimum-weight slot (weight = requests + sheds) is
    evicted: its counters roll into the ``~other`` aggregate (sum
    conservation — fleet totals never lose a request), and the newcomer
    starts fresh carrying ``err`` = the evicted weight, the classic
    space-saving undercount bound ("this tenant may have had up to err
    earlier requests attributed to ~other"). Heavy hitters therefore
    stay exact: once a tenant's weight exceeds the churn floor it is
    never the minimum, so 10k distinct scanners can never evict a real
    workload — and, critically, NO per-tenant Prometheus series is ever
    minted (bounded cardinality is the point; the only /metrics surface
    is the tracked-entries gauge and the overflow counter).

    Lock-guarded dict arithmetic only — the feed point is
    ``FlightRecorder.finish`` plus the shed paths, i.e. the request hot
    path (bench.py's slo_microbench keeps the cost honest)."""

    OTHER = "~other"
    FIELDS = (
        "requests", "tokens_in", "tokens_out", "sheds",
        "deadline_misses", "errors",
    )

    def __init__(self, size: int = 256, metrics: Any = None):
        if size < 1:
            raise ValueError("TENANT_LEDGER_SIZE must be >= 1")
        self.size = int(size)
        self._slots: dict[str, dict[str, int]] = {}
        self._other: dict[str, int] = {f: 0 for f in self.FIELDS}
        self._evictions = 0
        self._lock = threading.Lock()
        self._tracked_gauge = (
            metrics.gauge(
                "gofr_tpu_tenants_tracked_entries",
                "tenants currently tracked exactly by the ledger "
                "(bounded by TENANT_LEDGER_SIZE; the rest aggregate "
                "into ~other)",
            )
            if metrics is not None else None
        )
        self._overflow_counter = (
            metrics.counter(
                "gofr_tpu_tenant_overflow_total",
                "tenant slots evicted into the ~other aggregate "
                "(space-saving overflow)",
            )
            if metrics is not None else None
        )

    @staticmethod
    def _weight(slot: dict[str, int]) -> int:
        return slot["requests"] + slot["sheds"]

    def observe(
        self,
        tenant: str,
        requests: int = 0,
        tokens_in: int = 0,
        tokens_out: int = 0,
        sheds: int = 0,
        deadline_misses: int = 0,
        errors: int = 0,
    ) -> None:
        """Add one observation to ``tenant``'s slot (admitting it into
        the table, evicting the minimum-weight slot if full)."""
        if not tenant:
            return
        evicted = False
        with self._lock:
            slot = self._slots.get(tenant)
            if slot is None:
                err = 0
                if len(self._slots) >= self.size:
                    victim = min(self._slots, key=lambda t: self._weight(self._slots[t]))
                    old = self._slots.pop(victim)
                    for field in self.FIELDS:
                        self._other[field] += old[field]
                    err = self._weight(old)
                    self._evictions += 1
                    evicted = True
                slot = {f: 0 for f in self.FIELDS}
                slot["err"] = err
                self._slots[tenant] = slot
            slot["requests"] += requests
            slot["tokens_in"] += tokens_in
            slot["tokens_out"] += tokens_out
            slot["sheds"] += sheds
            slot["deadline_misses"] += deadline_misses
            slot["errors"] += errors
            tracked = len(self._slots)
        # metric writes OUTSIDE the ledger lock (registry has its own)
        if evicted and self._overflow_counter is not None:
            self._overflow_counter.inc()
        if self._tracked_gauge is not None:
            self._tracked_gauge.set(float(tracked))

    def shed(self, tenant: str) -> None:
        """Meter one shed (a brownout 429): sheds make no flight record, so
        the shed site feeds the ledger directly."""
        self.observe(tenant, sheds=1)

    # -- read side (admin API) -----------------------------------------------
    def get(self, tenant: str) -> Optional[dict[str, Any]]:
        """One tenant's exact counters (None = not currently tracked —
        it may still have history inside ``~other``)."""
        with self._lock:
            slot = self._slots.get(tenant)
            if slot is None:
                return None
            return dict(slot, tenant=tenant)

    def top(self, k: int = 50) -> list[dict[str, Any]]:
        """Top-``k`` tracked tenants by total tokens (in + out), ties
        broken by weight — the '/admin/tenants' default page."""
        with self._lock:
            rows = [dict(slot, tenant=t) for t, slot in self._slots.items()]
        rows.sort(
            key=lambda r: (
                r["tokens_in"] + r["tokens_out"],
                r["requests"] + r["sheds"],
                r["tenant"],
            ),
            reverse=True,
        )
        return rows[: max(0, k)]

    def totals(self) -> dict[str, int]:
        """Exact fleet-wide counters: tracked slots + ~other summed (sum
        conservation — eviction moves counts, never drops them)."""
        with self._lock:
            out = dict(self._other)
            for slot in self._slots.values():
                for field in self.FIELDS:
                    out[field] += slot[field]
        return out

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "tracked": len(self._slots),
                "size": self.size,
                "evictions": self._evictions,
                "other": dict(self._other),
            }

    def snapshot(self, k: int = 50) -> dict[str, Any]:
        """The ``/admin/tenants`` shape: stats + totals + the top-``k``
        page."""
        return dict(self.stats(), totals=self.totals(), tenants=self.top(k))

    def overview(self, k: int = 3) -> dict[str, Any]:
        """Compact headline for /admin/overview and the /admin/engine
        scrape: tracked count, eviction pressure, the top-``k`` heavy
        hitters by tokens."""
        stats = self.stats()
        return {
            "tracked": stats["tracked"],
            "size": stats["size"],
            "evictions": stats["evictions"],
            "top": [
                {
                    "tenant": r["tenant"],
                    "requests": r["requests"],
                    "tokens": r["tokens_in"] + r["tokens_out"],
                    "sheds": r["sheds"],
                }
                for r in self.top(k)
            ],
        }


class FlightRecorder:
    """Thread-safe bounded store of completed FlightRecords.

    ``capacity`` bounds the main ring (most recent completions);
    ``keep`` bounds the side buffer that always retains slow/errored
    requests even after the ring evicts them. ``slow_threshold_s``
    classifies slow: total duration or TTFT past it. ``tenants`` is the
    optional :class:`TenantLedger` every finished record meters into."""

    def __init__(
        self,
        capacity: int = 512,
        keep: int = 128,
        slow_threshold_s: float = 2.0,
        logger: Any = None,
        tenants: Optional["TenantLedger"] = None,
    ):
        self.capacity = capacity
        self.slow_threshold_s = slow_threshold_s
        self.logger = logger
        self.tenants = tenants
        self._ring: "deque[FlightRecord]" = deque(maxlen=max(1, capacity))
        self._notable: "deque[FlightRecord]" = deque(maxlen=max(1, keep))
        # started, not finished: the requests in flight (a postmortem's
        # most useful records: those riding a wedged dispatch never land)
        self._active: "weakref.WeakValueDictionary[int, FlightRecord]" = (
            weakref.WeakValueDictionary()
        )
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    def start(
        self,
        model: str,
        endpoint: str,
        trace_id: str = "",
        tokens_in: int = 0,
        stream: bool = False,
        activate: bool = True,
    ) -> FlightRecord:
        record = FlightRecord(
            model=model, endpoint=endpoint, trace_id=trace_id,
            tokens_in=tokens_in, stream=stream,
        )
        with self._lock:
            self._active[id(record)] = record
        if activate:
            activate_record(record)
        return record

    def finish(
        self,
        record: Optional[FlightRecord],
        status: str = "ok",
        error: Optional[BaseException] = None,
    ) -> None:
        """Complete a record: stamps done, lands it in the buffers, and
        emits the wide-event log line. Idempotent — the first finish
        wins (a stream wrapper and an error path may both reach it)."""
        if record is None or record.t_done is not None:
            return
        record.t_done = time.perf_counter()
        record.wall_done = time.time()
        if error is not None:
            record.note_error(error)
        elif record.status == "in_flight":
            record.status = status
        with self._lock:
            self._active.pop(id(record), None)
            self._ring.append(record)
            if self.is_slow(record) or record.status != "ok":
                self._notable.append(record)
        # per-tenant usage metering: every completed flight lands in the
        # bounded ledger (sheds never reach here — the shed sites feed
        # the ledger directly). Cancelled still counts as a request: the
        # tenant consumed admission + tokens up to the abort.
        if self.tenants is not None and record.tenant:
            self.tenants.observe(
                record.tenant,
                requests=1,
                tokens_in=record.tokens_in,
                tokens_out=record.tokens_out,
                deadline_misses=(
                    1 if record.status == "deadline_exceeded" else 0
                ),
                errors=1 if record.status == "error" else 0,
            )
        if self.logger is not None:
            try:
                self.logger.info(record.to_dict())
            except Exception:
                # telemetry must never take a request down
                pass

    def is_slow(self, record: FlightRecord) -> bool:
        duration = record.duration or 0.0
        ttft = record.ttft or 0.0
        return max(duration, ttft) >= self.slow_threshold_s

    def finish_stream(self, result: Any, record: Optional[FlightRecord]) -> Any:
        """Wrap a handler's Stream result so ``record`` completes when
        the stream ends — normal exhaustion, an error, or the client
        disconnecting (generator close). Non-Stream results pass
        through untouched (the caller finishes synchronously)."""
        if record is None or not isinstance(result, Stream):
            return result
        events = result.events

        def guarded() -> Any:
            try:
                yield from events
            except GeneratorExit:
                self.finish(record, status="cancelled")
                raise
            except BaseException as exc:
                self.finish(record, error=exc)
                raise
            else:
                self.finish(record)

        result.events = guarded()
        return result

    # -- read side (admin API, postmortem, SLO engine) -------------------------
    def active_count(self) -> int:
        """Requests in flight (the rollup's number)."""
        with self._lock:
            return len(self._active)

    def active_records(self) -> list[dict[str, Any]]:
        """The records started and not finished, oldest first."""
        with self._lock:
            active = sorted(self._active.values(), key=lambda r: r.t_start)
        return [r.to_dict() for r in active]

    def finished_since(self, horizon: float) -> list[FlightRecord]:
        """Finished records with ``t_done >= horizon`` (a perf_counter
        mark), the SLO engine's windowed scan: the live objects, read-only."""
        with self._lock:
            return [r for r in self._ring if r.t_done is not None and r.t_done >= horizon]

    def records(
        self,
        slow: Optional[bool] = None,
        errored: Optional[bool] = None,
        limit: int = 100,
        request_id: Optional[str] = None,
        trace_id: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> list[dict[str, Any]]:
        """Most-recent-first record dicts. ``slow=True``/``errored=True``
        filter; ``request_id``/``trace_id``/``tenant`` match exactly
        (the jump from an id in a log line — or a hashed tenant id off a
        429 body — to the records that carried it); the side buffer is
        merged in so flagged requests stay visible after ring
        eviction."""
        with self._lock:
            merged: list[FlightRecord] = list(self._ring)
            seen = {id(r) for r in merged}
            merged.extend(r for r in self._notable if id(r) not in seen)
        merged.sort(key=lambda r: r.t_done or r.t_start)
        out = []
        for record in reversed(merged):
            if slow is not None and self.is_slow(record) != slow:
                continue
            if errored is not None and (record.status != "ok") != errored:
                continue
            if request_id is not None and record.request_id != request_id:
                continue
            if trace_id is not None and record.trace_id != trace_id:
                continue
            if tenant is not None and record.tenant != tenant:
                continue
            out.append(record.to_dict())
            if len(out) >= limit:
                break
        return out

    def slo(self, window_s: float = 300.0) -> dict[str, Any]:
        """Rolling-window per-model SLO view: exact p50/p95/p99 of TTFT
        and TPOT over requests completed in the last ``window_s``
        seconds, computed from the raw records (a cumulative histogram
        cannot express a rolling window and only knows bucket bounds)."""
        # monotonic window: wall-clock steps (NTP, suspend) must never
        # grow or shrink the SLO window
        horizon = time.perf_counter() - window_s
        with self._lock:
            recent = [
                r for r in self._ring
                if r.t_done is not None and r.t_done >= horizon
            ]
        models: dict[str, Any] = {}
        for model in sorted({r.model for r in recent}):
            rows = [r for r in recent if r.model == model]
            ttfts = [r.ttft for r in rows if r.ttft is not None]
            tpots = [r.tpot for r in rows if r.tpot is not None]
            entry: dict[str, Any] = {
                "count": len(rows),
                "errors": sum(1 for r in rows if r.status != "ok"),
            }
            if ttfts:
                entry["ttft_s"] = _percentiles(ttfts)
            if tpots:
                entry["tpot_s"] = _percentiles(tpots)
            # interference-scheduler visibility: how often prefills were
            # chunked and how much their chunks waited for decode turns
            defers = [r.sched_defer_s for r in rows if r.sched_defer_s]
            if defers:
                entry["sched_defer_s"] = _percentiles(defers)
            chunked = sum(1 for r in rows if r.prefill_chunks > 1)
            if chunked:
                entry["chunked_prefills"] = chunked
            # pooled speculative decoding: emitted tokens per verify
            # dispatch across the window's spec-riding requests (1.0 =
            # plain decode; the fleet SLO the spec bench gates on)
            tpds = [
                r.tokens_per_dispatch for r in rows
                if r.tokens_per_dispatch is not None
            ]
            if tpds:
                entry["tokens_per_dispatch"] = _percentiles(tpds)
            models[model] = entry
        return {"window_s": window_s, "models": models}

