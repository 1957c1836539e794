"""Pooled speculative decoding: per-request draft state, the draft
sources, the adaptive-k controller and the two spec gauges.

Copy of ``gofr_tpu/tpu/spec_pool.py``. ``SPEC_POOLED`` speculates through
the continuous-batching pool: every eligible pooled request carries a
:class:`SpecRequestState`; each spec cycle drafts up to k tokens per
active row, the pool verifies every row's pending token and drafts in ONE
``[slots, width]`` target dispatch, and rejected tokens roll back by
length (the slot cache's masked-lengths convention; the echo runner's
host paged KV: ``HostPagedKV.rollback``).

Draft sources (``PoolSpecConfig``): zero-weight n-gram lookup in the
request's own context (``SPEC_NGRAM``, the pool's only source), where the
most recent earlier occurrence of the trailing n-gram proposes its
continuation (prompt-lookup decoding); and, on the echo runner alone, the
scripted :class:`FakeDraft` (``SPEC_FAKE_ACCEPT``: per-cycle accept
counts), which makes every accept/reject/rollback branch deterministic.
:class:`AdaptiveK` keeps a per-request EMA of the acceptance rate and
scales k with it: poor acceptance degrades k to 0 (plain pooled decode,
with a periodic 1-token probe), good acceptance runs at ``SPEC_K_MAX``.
The serving clamps (``gofr_tpu_torch/deadline.py``) sit on top. Each cycle
publishes ``gofr_tpu_spec_accept_ratio`` and
``gofr_tpu_spec_tokens_per_dispatch`` (``note_cycle``). Stdlib only.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

# floor of the adaptive controller: below this EMA acceptance the
# request stops speculating (k=0 = plain decode) except for probes
DEGRADE_BELOW = 0.25
# after degrading, try a 1-token draft every Nth cycle so a request
# whose content turned repetitive can climb back out
PROBE_EVERY = 8


def spec_accept_ratio_gauge(metrics: Any) -> Any:
    """The ONE registration of ``gofr_tpu_spec_accept_ratio`` — shared
    by the decode pool and the echo runner's compile-free mirror (the
    registry dedupes by name, first wins; the pre-existing solo-path
    ``gofr_tpu_spec_acceptance`` gauge keeps its lifetime semantics)."""
    return metrics.gauge(
        "gofr_tpu_spec_accept_ratio",
        "pooled speculative decoding: accepted draft tokens / drafted, "
        "over the recent window (EMA)",
        labels=("model",),
    )


def spec_tokens_per_dispatch_gauge(metrics: Any) -> Any:
    """The ONE registration of ``gofr_tpu_spec_tokens_per_dispatch``:
    emitted tokens per target dispatch — the number speculation exists
    to raise (1.0 = plain decode; k accepted drafts + the bonus = k+1)."""
    return metrics.gauge(
        "gofr_tpu_spec_tokens_per_dispatch",
        "pooled speculative decoding: tokens emitted per target "
        "weight-stream, per row, over the recent window (EMA; 1.0 = "
        "plain decode — batched verifies report the per-row mean so "
        "cohort size never reads as speculation win)",
        labels=("model",),
    )


def parse_fake_accept(raw: str) -> tuple[int, ...]:
    """``SPEC_FAKE_ACCEPT`` -> a cyclic schedule of per-cycle accept
    counts (echo runner only): "3,1,0" means cycle 0 drafts 3 correct
    tokens, cycle 1 one, cycle 2 none (full rollback), repeating. The
    schedule makes every control-flow branch — full accept, partial,
    total reject — deterministic in tier-1."""
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        n = int(part)
        if n < 0:
            raise ValueError(
                f"SPEC_FAKE_ACCEPT entries must be >= 0, got {n}"
            )
        out.append(n)
    if not out:
        raise ValueError("SPEC_FAKE_ACCEPT must list at least one count")
    return tuple(out)


class NgramDraft:
    """Prompt-lookup drafting over one request's own context.

    ``propose(k)`` matches the longest trailing n-gram (``n_max`` down
    to ``n_min`` tokens) against earlier context and proposes the ``k``
    tokens that followed its most recent earlier occurrence. A miss at
    every n returns an empty draft (the row decodes plain this cycle).
    The scan is a backwards linear walk over a context bounded by
    ``max_seq``."""

    __slots__ = ("context", "n_max", "n_min")

    def __init__(self, context: list, n_max: int = 3, n_min: int = 1):
        if n_max < n_min or n_min < 1:
            raise ValueError(
                f"need n_max >= n_min >= 1, got n_max={n_max} n_min={n_min}"
            )
        self.context = list(context)
        self.n_max = n_max
        self.n_min = n_min

    def extend(self, tokens: list) -> None:
        self.context.extend(tokens)

    def propose(self, k: int) -> list:
        ctx = self.context
        size = len(ctx)
        if k <= 0 or size < self.n_min + 1:
            return []
        for n in range(min(self.n_max, size - 1), self.n_min - 1, -1):
            tail = ctx[size - n:]
            # most recent earlier occurrence: j is the index AFTER the
            # candidate n-gram (the continuation start)
            for j in range(size - 1, n - 1, -1):
                if ctx[j - n:j] == tail:
                    return ctx[j:j + k]
        return []


class FakeDraft:
    """Deterministic echo-runner draft source (``SPEC_FAKE_ACCEPT``):
    the caller supplies the TRUE continuation per cycle and the
    schedule dictates how many drafted tokens match it — the rest are
    deliberately wrong (bit-flipped), so the verify rejects exactly
    where the schedule says and every rollback branch is exercised on
    a fixed script."""

    __slots__ = ("schedule", "cycle")

    def __init__(self, schedule: tuple):
        self.schedule = tuple(schedule)
        self.cycle = 0

    def propose_against(self, truth: list, k: int) -> list:
        """``k`` drafts given the true next-``k`` tokens ``truth``."""
        accept = self.schedule[self.cycle % len(self.schedule)]
        self.cycle += 1
        out = []
        for j in range(min(k, len(truth))):
            t = int(truth[j])
            # past the scripted accept count, propose a provably-wrong
            # token (true token + 1 stays in-vocab for echo's id space)
            out.append(t if j < accept else t + 1)
        return out


class AdaptiveK:
    """Per-request draft-width controller: an EMA of the acceptance
    rate scales k between 0 (plain decode) and ``k_max``. Starts
    optimistic (EMA 1.0 — the first cycles measure, they don't guess);
    below ``DEGRADE_BELOW`` the request stops speculating except for a
    1-token probe every ``PROBE_EVERY`` cycles."""

    __slots__ = ("k_max", "alpha", "ema", "cycles", "_degraded_cycles")

    def __init__(self, k_max: int, alpha: float = 0.3):
        if k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        self.k_max = k_max
        self.alpha = alpha
        self.ema = 1.0
        self.cycles = 0
        self._degraded_cycles = 0

    def observe(self, drafted: int, accepted: int) -> None:
        """Fold one verify cycle's outcome into the EMA (cycles that
        drafted nothing teach nothing)."""
        self.cycles += 1
        if drafted <= 0:
            return
        rate = accepted / drafted
        self.ema = (1 - self.alpha) * self.ema + self.alpha * rate

    def current(self) -> int:
        """The EMA-scaled draft width for the next cycle (serving
        clamps — brownout, deadline — apply on top, see
        :func:`gofr_tpu_torch.deadline.clamp_spec_k`)."""
        if self.ema < DEGRADE_BELOW:
            self._degraded_cycles += 1
            if self._degraded_cycles % PROBE_EVERY == 0:
                return 1  # probe: has the content turned draftable?
            return 0
        self._degraded_cycles = 0
        # round up: EMA 1.0 -> k_max, EMA just above the floor -> 1
        return max(1, min(self.k_max, round(self.ema * self.k_max)))


class SpecRequestState:
    """One pooled request's speculative state: its draft source, its
    adaptive-k controller, and its accept accounting. Host-side only;
    lives on the pool's ``_Request`` or the echo generate frame, always
    touched under the owner's serialization (pool lock / the single
    generate thread)."""

    __slots__ = (
        "draft", "fake", "ngram", "adaptive", "pending", "drafted",
        "accepted", "dispatches", "emitted",
    )

    def __init__(self, context: list, pending: int, k_max: int,
                 fake: Optional[FakeDraft] = None, ngram: bool = True,
                 n_max: int = 3, n_min: int = 1):
        # context includes the pending (not-yet-verified) token: drafts
        # must continue THROUGH it. The context is tracked even with
        # ngram drafting off — a config flip mid-deployment must not
        # start from a hole — but propose() then only drafts through
        # the fake schedule (or not at all).
        self.draft = NgramDraft(list(context) + [int(pending)],
                                n_max=n_max, n_min=n_min)
        self.ngram = ngram
        self.fake = fake
        self.adaptive = AdaptiveK(k_max)
        self.pending = int(pending)
        self.drafted = 0
        self.accepted = 0
        self.dispatches = 0
        self.emitted = 0

    def propose(self, k: int, truth: Optional[list] = None) -> list:
        """Draft up to ``k`` tokens (may return fewer, or none). The
        echo runner passes the true continuation for the fake-schedule
        source; the n-gram source ignores it."""
        if k <= 0:
            return []
        if self.fake is not None:
            return self.fake.propose_against(truth or [], k)
        if not self.ngram:
            return []  # no draft source configured for this request
        out = self.draft.propose(k)
        if not out:
            # a draft-source MISS teaches the controller too: free-form
            # context that never matches an n-gram must degrade k to 0
            # (plain decode, cheap probes) instead of paying the
            # context scan per cycle forever on a pinned-at-1.0 EMA
            self.adaptive.observe(1, 0)
        return out

    def commit(self, tokens: list, drafted: int, accepted: int) -> None:
        """One verify cycle landed: ``tokens`` were emitted (accepted
        drafts + the bonus/correction; the last becomes the new pending
        token), ``accepted`` of ``drafted`` draft tokens matched."""
        self.dispatches += 1
        self.drafted += drafted
        self.accepted += accepted
        self.emitted += len(tokens)
        if tokens:
            self.pending = int(tokens[-1])
            self.draft.extend([int(t) for t in tokens])
        self.adaptive.observe(drafted, accepted)

    def note_plain(self, tokens: list) -> None:
        """A plain (non-spec) pool chunk delivered ``tokens`` for this
        request: keep the draft context and pending token coherent so a
        later spec cycle drafts from the real stream."""
        self.dispatches += 1
        self.emitted += len(tokens)
        if tokens:
            self.pending = int(tokens[-1])
            self.draft.extend([int(t) for t in tokens])

    @property
    def tokens_per_dispatch(self) -> float:
        return self.emitted / self.dispatches if self.dispatches else 0.0


class PoolSpecConfig:
    """Deployment-level pooled-spec settings, built once by the device
    and attached to the decode pool / echo runner: draft width bound,
    draft source selection, the brownout probe (``brownout_level``, the
    device's ``BrownoutController.level``), and the two EMA gauges
    (shared registration homes above). ``ema`` state is guarded by a
    lock: the echo runner sets gauges from concurrent request threads."""

    __slots__ = (
        "k_max", "ngram", "fake_schedule", "brownout_level",
        "accept_gauge", "tpd_gauge", "model", "_ema_accept", "_ema_tpd",
        "_lock",
    )

    def __init__(
        self,
        k_max: int = 4,
        ngram: bool = True,
        fake_schedule: Optional[tuple] = None,
        brownout_level: Optional[Callable[[], int]] = None,
        metrics: Any = None,
        model: str = "",
    ):
        if k_max < 1:
            raise ValueError(f"SPEC_K_MAX must be >= 1, got {k_max}")
        self.k_max = k_max
        self.ngram = ngram
        self.fake_schedule = fake_schedule
        self.brownout_level = brownout_level
        self.model = model
        self.accept_gauge = (
            spec_accept_ratio_gauge(metrics) if metrics is not None else None
        )
        self.tpd_gauge = (
            spec_tokens_per_dispatch_gauge(metrics)
            if metrics is not None else None
        )
        self._ema_accept: Optional[float] = None
        self._ema_tpd: Optional[float] = None
        self._lock = threading.Lock()

    def new_state(self, context: list, pending: int) -> SpecRequestState:
        fake = (
            FakeDraft(self.fake_schedule)
            if self.fake_schedule is not None else None
        )
        return SpecRequestState(context, pending, self.k_max, fake=fake,
                                ngram=self.ngram)

    def level(self) -> int:
        """The live brownout level (0 when no controller is wired)."""
        if self.brownout_level is None:
            return 0
        return self.brownout_level()

    def note_cycle(self, drafted: int, accepted: int, emitted: int,
                   dispatches: int = 1) -> None:
        """Publish one verify cycle (or a batched pool cycle's totals)
        onto the two EMA gauges."""
        with self._lock:
            if drafted > 0:
                rate = accepted / drafted
                self._ema_accept = (
                    rate if self._ema_accept is None
                    else 0.8 * self._ema_accept + 0.2 * rate
                )
            if dispatches > 0:
                tpd = emitted / dispatches
                self._ema_tpd = (
                    tpd if self._ema_tpd is None
                    else 0.8 * self._ema_tpd + 0.2 * tpd
                )
            ema_accept, ema_tpd = self._ema_accept, self._ema_tpd
        if self.accept_gauge is not None and ema_accept is not None:
            self.accept_gauge.set(ema_accept, model=self.model)
        if self.tpd_gauge is not None and ema_tpd is not None:
            self.tpd_gauge.set(ema_tpd, model=self.model)
