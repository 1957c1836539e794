"""Admission control for the fleet front door: per-tenant token-bucket
quotas (redis-backed when the container has redis, in-memory otherwise)
and the shed decisions that keep the router's queue bounded.

Every deny carries a ``Retry-After`` hint so well-behaved clients back
off instead of hammering: for quota denials it is the exact refill time
of the next token; for saturation/in-flight sheds it is the configured
``retry_after_s`` coarse hint.

The redis backing makes quotas FLEET-WIDE: N router processes fronting
the same replicas share one bucket per tenant (key
``fleet:quota:<tenant>``, a hash of ``tokens`` + ``ts``). The
read-modify-write is not atomic across routers — a race can admit one
extra request per colliding pair — which is the right trade for a
quota (a rate hint, not a ledger); redis failures fail OPEN to the
in-memory bucket so a cache outage never takes admission down with it.

The redis path is hot-key protected by a short-TTL local lease cache
(``cache_ttl_s`` > 0, ``FLEET_QUOTA_CACHE_TTL_S``): instead of two
pipelined redis round trips per request per tenant, the table leases a
small batch of tokens (≈ ``rate * ttl``) from the shared bucket once
per TTL window and admits locally from the lease; a denial verdict is
likewise cached for the window. Leased-but-unused tokens from an
expired lease are credited back on the tenant's next sync, so the
fleet-wide accounting error is bounded by one lease per router per TTL
— while a Zipf-skewed tenant mix (one tenant dominating traffic) stops
hammering one redis key once per request. The fleetsim harness
measured one redis sync (= two pipelined round trips) per request
without the cache and a small fraction of that with it (FLEETSIM
artifact, ``hardening.quota.syncs_per_request``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

# bounded tenant map: beyond this, new tenants share one overflow bucket
# (same rationale as METRICS_MAX_SERIES — scanner traffic must not grow
# resident memory unboundedly)
MAX_TENANTS = 10_000
OVERFLOW_TENANT = "_overflow"


class TokenBucket:
    """Classic token bucket on the monotonic clock: ``rate`` tokens/s
    refill toward ``capacity``; :meth:`take` is lock-guarded arithmetic
    only (admission sits on the hot path)."""

    def __init__(self, rate: float, capacity: float):
        self.rate = rate
        self.capacity = capacity
        self._tokens = capacity
        self._updated = time.monotonic()
        self._lock = threading.Lock()

    def take(self, n: float = 1.0) -> tuple[bool, float]:
        """(admitted, retry_after_s). ``retry_after_s`` is 0 when
        admitted, else the time until ``n`` tokens will exist."""
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.capacity, self._tokens + (now - self._updated) * self.rate
            )
            self._updated = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            needed = n - self._tokens
            return False, needed / self.rate if self.rate > 0 else 60.0

    def peek(self) -> float:
        with self._lock:
            now = time.monotonic()
            return min(
                self.capacity, self._tokens + (now - self._updated) * self.rate
            )


class _Lease:
    """One tenant's short-lived local slice of the fleet-wide redis
    bucket: ``tokens`` admits locally until ``expires`` (monotonic);
    a lease with no tokens is a CACHED DENIAL (``retry_after`` is the
    hint minted at sync time, counted down as the window ages)."""

    __slots__ = ("tokens", "expires", "retry_after")

    def __init__(self, tokens: float, expires: float,
                 retry_after: float = 0.0):
        self.tokens = tokens
        self.expires = expires
        self.retry_after = retry_after


class QuotaTable:
    """Per-tenant buckets. ``rate_rps`` <= 0 disables quotas entirely
    (every take admits)."""

    def __init__(self, rate_rps: float, burst: float,
                 redis: Optional[Any] = None, logger: Optional[Any] = None,
                 metrics: Optional[Any] = None, cache_ttl_s: float = 0.0):
        self.rate_rps = rate_rps
        self.burst = burst if burst > 0 else max(1.0, 2 * rate_rps)
        self._redis = redis
        self._logger = logger
        # hot-key protection (module docstring): 0 = off, every take is
        # a redis round trip (the pre-cache behavior, and the unit-test
        # baseline the fleetsim A/B measures against)
        self.cache_ttl_s = max(0.0, cache_ttl_s)
        self._leases: dict[str, _Lease] = {}
        self._credit: dict[str, float] = {}  # expired-lease give-back
        self._redis_syncs = 0
        self._cache_hits = 0
        # outage-window tracking: the first failure of an outage logs
        # (once — a dead redis must not flood the log at request rate),
        # recovery logs the all-clear and RE-ARMS the next outage's
        # first-failure log. Every fail-open take also counts on
        # gofr_tpu_router_quota_fallback_total, so a silent redis
        # outage — quotas quietly per-process instead of fleet-wide —
        # is visible on /admin/fleet and alertable, not just a single
        # log line scrolled away days ago.
        self._redis_down = False
        self._fallbacks = 0
        self._fallback_counter = (
            metrics.counter(
                "gofr_tpu_router_quota_fallback_total",
                "quota decisions that failed open to the per-process "
                "bucket because the redis backend was unavailable",
            )
            if metrics is not None else None
        )
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self._denied = 0
        self._admitted = 0

    @property
    def enabled(self) -> bool:
        return self.rate_rps > 0

    def take(self, tenant: str) -> tuple[bool, float]:
        if not self.enabled:
            return True, 0.0
        if self._redis is not None:
            verdict = self._take_lease(tenant)
            if verdict is None:
                verdict = self._take_redis(tenant)
            if verdict is not None:
                self._count(verdict[0])
                return verdict
            self._note_fallback()
        ok, retry_after = self._bucket(tenant).take()
        self._count(ok)
        return ok, retry_after

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "rate_rps": self.rate_rps,
                "burst": self.burst,
                "backend": "redis" if self._redis is not None else "memory",
                "redis_down": self._redis_down,
                "fallbacks": self._fallbacks,
                "tenants": len(self._buckets),
                "admitted": self._admitted,
                "denied": self._denied,
                "cache_ttl_s": self.cache_ttl_s,
                "redis_syncs": self._redis_syncs,
                "cache_hits": self._cache_hits,
            }

    # -- internals ------------------------------------------------------------
    def _count(self, admitted: bool) -> None:
        with self._lock:
            if admitted:
                self._admitted += 1
            else:
                self._denied += 1

    def _bucket(self, tenant: str) -> TokenBucket:
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                if len(self._buckets) >= MAX_TENANTS:
                    tenant = OVERFLOW_TENANT
                    bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = TokenBucket(self.rate_rps, self.burst)
                    self._buckets[tenant] = bucket
            return bucket

    def _take_lease(self, tenant: str) -> Optional[tuple[bool, float]]:
        """Serve a take from the tenant's local lease when one is live
        (no redis round trip); ``None`` = no usable lease, sync with
        redis. Lock-guarded arithmetic only. An EXPIRED lease moves its
        unused tokens into the credit ledger so the next sync gives
        them back to the fleet-wide bucket."""
        if self.cache_ttl_s <= 0:
            return None
        with self._lock:
            lease = self._leases.get(tenant)
            if lease is None:
                return None
            now = time.monotonic()
            if now >= lease.expires:
                del self._leases[tenant]
                if lease.tokens > 0:
                    self._credit[tenant] = (
                        self._credit.get(tenant, 0.0) + lease.tokens
                    )
                    if len(self._credit) > MAX_TENANTS:
                        # bounded like the bucket/lease maps: a churning
                        # tenant population must not grow the credit
                        # ledger forever (the popped sliver refills via
                        # the rate)
                        self._credit.pop(next(iter(self._credit)))
                return None
            if lease.tokens >= 1.0:
                lease.tokens -= 1.0
                self._cache_hits += 1
                return True, 0.0
            if lease.retry_after > 0:
                # cached denial: the hint counts DOWN as the window ages
                # (re-serving the sync-time value would push well-behaved
                # clients ever further out)
                self._cache_hits += 1
                remaining = lease.retry_after - (
                    self.cache_ttl_s - (lease.expires - now)
                )
                return False, max(0.05, remaining)
            return None

    def _lease_target(self) -> float:
        """Tokens to lease per sync: a TTL window's worth at the full
        rate — but AT LEAST one token (at realistic per-tenant rates
        ``rate * ttl`` is fractional and a sub-1.0 lease can never
        admit, which silently disabled the cache in the first fleetsim
        runs) — bounded so one router can never hoard the whole
        burst. The hoard bound gets the same ≥1 floor: clamping below
        a whole token (tiny bursts) would re-open the fractional-lease
        hole the floor exists to close."""
        want = max(1.0, self.rate_rps * self.cache_ttl_s)
        return min(want, max(1.0, self.burst / 2.0))

    def _take_redis(self, tenant: str) -> Optional[tuple[bool, float]]:
        """Fleet-wide bucket in redis; ``None`` = backend unavailable
        (caller falls back to the in-memory bucket: fail open). Two
        pipelined round trips per take (read both fields, write both +
        TTL) — this sits on the admission hot path, so five sequential
        RTTs would tax every admitted request. One RTT would need
        server-side scripting (EVAL), which the in-tree miniredis does
        not speak. With ``cache_ttl_s`` > 0 this sync also LEASES a
        batch of tokens into the local cache (debited here, admitted
        locally by :meth:`_take_lease`) and credits back any expired
        lease's unused remainder."""
        key = f"fleet:quota:{tenant}"
        with self._lock:
            credit = self._credit.pop(tenant, 0.0)
        try:
            # wall clock ON PURPOSE: the timestamp is shared across
            # router processes, whose monotonic clocks are unrelated
            now = time.time()  # gofrlint: wall-clock — cross-process bucket refill timestamp
            raw_tokens, raw_ts = self._redis.pipeline().hget(
                key, "tokens"
            ).hget(key, "ts").execute()
            with self._lock:
                self._redis_syncs += 1
            tokens = _as_float(raw_tokens, self.burst)
            ts = _as_float(raw_ts, now)
            tokens = min(
                self.burst,
                tokens + max(0.0, now - ts) * self.rate_rps + credit,
            )
            leased = 0.0
            if tokens >= 1.0:
                admitted, tokens, retry_after = True, tokens - 1.0, 0.0
                if self.cache_ttl_s > 0:
                    leased = min(tokens, self._lease_target())
                    tokens -= leased
            else:
                admitted = False
                retry_after = (1.0 - tokens) / self.rate_rps
            ttl = max(60, int(self.burst / max(self.rate_rps, 0.001)) + 60)
            # idle tenants expire instead of accreting forever
            self._redis.pipeline().hset(key, "tokens", repr(tokens)).hset(
                key, "ts", repr(now)
            ).expire(key, ttl).execute()
            # the lease installs only AFTER the write-back landed: a
            # redis failure between read and write falls open (caller
            # gets None), and a lease installed early would be PHANTOM
            # tokens — admitted locally for a whole TTL window but
            # never debited fleet-wide, over-admitting past the
            # documented one-per-colliding-pair bound (and the except
            # path's credit restore would double-count whatever had
            # already flowed into it)
            if self.cache_ttl_s > 0:
                with self._lock:
                    prev = self._leases.get(tenant)
                    if prev is not None and prev.tokens > 0:
                        # a concurrent sync for the SAME tenant landed
                        # while this one round-tripped: both debited a
                        # lease batch from the shared bucket, so an
                        # overwrite would strand the loser's tokens —
                        # debited in redis, never admitted, never
                        # credited. Merge instead: the combined lease
                        # is bounded by one extra batch, and every
                        # debited token stays spendable.
                        leased += prev.tokens
                    self._leases[tenant] = _Lease(
                        leased, time.monotonic() + self.cache_ttl_s,
                        retry_after=retry_after if not admitted else 0.0,
                    )
                    if len(self._leases) > MAX_TENANTS:
                        # same bound rationale as the bucket map: scanner
                        # traffic must not grow resident memory forever —
                        # but an evicted lease's unused tokens were
                        # debited from the shared bucket, so they move
                        # to the credit ledger, never into the void
                        evicted = next(iter(self._leases))
                        old = self._leases.pop(evicted)
                        if old.tokens > 0:
                            self._credit[evicted] = (
                                self._credit.get(evicted, 0.0) + old.tokens
                            )
                        if len(self._credit) > MAX_TENANTS:
                            # the credit ledger gets the same cap; the
                            # popped sliver of tokens refills via the
                            # rate anyway — bounded memory wins over
                            # perfect accounting at scanner scale
                            self._credit.pop(next(iter(self._credit)))
            if self._redis_down:
                self._redis_down = False
                if self._logger is not None:
                    self._logger.infof(
                        "fleet quota redis backend recovered; quotas are "
                        "fleet-wide again"
                    )
            return admitted, retry_after
        except Exception as exc:
            if credit > 0:
                # the give-back never happened; keep it for the next sync
                with self._lock:
                    self._credit[tenant] = (
                        self._credit.get(tenant, 0.0) + credit
                    )
            if not self._redis_down and self._logger is not None:
                self._logger.errorf(
                    "fleet quota redis backend failed (%r); failing open "
                    "to per-process buckets until it recovers", exc
                )
            self._redis_down = True
            return None

    def _note_fallback(self) -> None:
        with self._lock:
            self._fallbacks += 1
        if self._fallback_counter is not None:
            self._fallback_counter.inc()


def _as_float(value: Any, default: float) -> float:
    """Redis replies arrive as str/bytes/None depending on the client
    path; the bucket math wants a float either way."""
    if value is None:
        return default
    if isinstance(value, bytes):
        value = value.decode("utf-8", "replace")
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


def tenant_of(request: Any, trust_tenant_header: bool = False) -> str:
    """The quota subject of a request: the API key (``Authorization``
    value, HASHED — the tenant string lands in route records,
    ``/admin/fleet``, and redis keys, none of which may carry secret
    material), else a shared anonymous bucket.

    The client-supplied ``X-Tenant`` header is honored only when the
    operator opted in (``FLEET_TRUST_TENANT_HEADER=on``, for routers
    behind an authenticating gateway that STAMPS the header): trusted
    by default it would let any rate-limited client mint a fresh full
    bucket per request by randomizing the header."""
    if trust_tenant_header:
        tenant = request.header("X-Tenant")
        if tenant:
            return tenant
    auth = request.header("Authorization")
    if auth:
        import hashlib

        digest = hashlib.sha256(auth.encode("utf-8")).hexdigest()
        return "key-" + digest[:16]
    return "anonymous"
