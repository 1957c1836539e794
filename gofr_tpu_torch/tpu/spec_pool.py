"""Pooled speculative decoding: per-request draft state, zero-weight
n-gram drafting, and the adaptive-k controller.

Trimmed copy of ``gofr_tpu/tpu/spec_pool.py``. ``SPEC_POOLED`` speculates
through the continuous-batching pool: every eligible pooled request
carries a :class:`SpecRequestState`; each spec cycle drafts up to k tokens
per active row, the pool verifies every row's pending token and drafts in
ONE ``[slots, width]`` target dispatch, and rejected tokens roll back by
length (the slot cache's masked-lengths convention).

Drafting is zero-weight, the only draft source of the port
(``SPEC_NGRAM`` is validated at boot and must stay on): a request's
draft is looked up in its own context (prompt + emitted tokens), where the most recent
earlier occurrence of the trailing n-gram proposes its continuation
(prompt-lookup decoding). :class:`AdaptiveK` keeps a per-request EMA of
the acceptance rate and scales k with it: poor acceptance degrades k to 0
(plain pooled decode, with a periodic 1-token probe), good acceptance runs
at ``SPEC_K_MAX``. The serving clamps (``gofr_tpu_torch/deadline.py``) sit
on top.

Not ported yet: the echo runner's scripted draft source
(``FakeDraft``, ``SPEC_FAKE_ACCEPT``) and the accept-ratio and
tokens-per-dispatch gauges; they come with the echo runner and
``/metrics``. Stdlib only.
"""

from __future__ import annotations


# floor of the adaptive controller: below this EMA acceptance the
# request stops speculating (k=0 = plain decode) except for probes
DEGRADE_BELOW = 0.25
# after degrading, try a 1-token draft every Nth cycle so a request
# whose content turned repetitive can climb back out
PROBE_EVERY = 8


class NgramDraft:
    """Prompt-lookup drafting over one request's own context.

    ``propose(k)`` matches the longest trailing n-gram (``n_max`` down to
    ``n_min`` tokens) against earlier context and proposes the ``k``
    tokens that followed its most recent earlier occurrence. A miss at
    every n returns an empty draft (the row decodes plain this cycle). The
    scan is a backwards linear walk over a context bounded by ``max_seq``."""

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


class AdaptiveK:
    """Per-request draft-width controller: an EMA of the acceptance rate
    scales k between 0 (plain decode) and ``k_max``. Starts optimistic
    (EMA 1.0: the first cycles measure); below ``DEGRADE_BELOW`` the
    request stops speculating except for a 1-token probe every
    ``PROBE_EVERY`` cycles."""

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
        """The EMA-scaled draft width for the next cycle (the serving
        clamps apply on top: ``deadline.clamp_spec_k``)."""
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
    adaptive-k controller and its accept accounting. Host-side only; lives
    on the pool's request and is touched under the pool lock."""

    __slots__ = (
        "draft", "adaptive", "pending", "drafted", "accepted",
        "dispatches", "emitted",
    )

    def __init__(self, context: list, pending: int, k_max: int, n_max: int = 3,
                 n_min: int = 1):
        # context includes the pending (not yet verified) token: drafts
        # continue THROUGH it
        self.draft = NgramDraft(list(context) + [int(pending)], n_max=n_max, n_min=n_min)
        self.adaptive = AdaptiveK(k_max)
        self.pending = int(pending)
        self.drafted = 0
        self.accepted = 0
        self.dispatches = 0
        self.emitted = 0

    def propose(self, k: int) -> list:
        """Draft up to ``k`` tokens (may return fewer, or none)."""
        if k <= 0:
            return []
        out = self.draft.propose(k)
        if not out:
            # a miss teaches the controller too: context that never
            # matches an n-gram degrades k to 0 (plain decode, cheap
            # probes) instead of paying the scan every cycle
            self.adaptive.observe(1, 0)
        return out

    def commit(self, tokens: list, drafted: int, accepted: int) -> None:
        """One verify cycle landed: ``tokens`` were emitted (accepted drafts
        + the bonus/correction; the last becomes the new pending token),
        ``accepted`` of ``drafted`` draft tokens matched."""
        self.dispatches += 1
        self.drafted += drafted
        self.accepted += accepted
        self.emitted += len(tokens)
        if tokens:
            self.pending = int(tokens[-1])
            self.draft.extend([int(t) for t in tokens])
        self.adaptive.observe(drafted, accepted)

    def note_plain(self, tokens: list) -> None:
        """A plain pool chunk delivered ``tokens`` for this request: keep
        the draft context and pending token coherent so a later spec cycle
        drafts from the real stream."""
        self.dispatches += 1
        self.emitted += len(tokens)
        if tokens:
            self.pending = int(tokens[-1])
            self.draft.extend([int(t) for t in tokens])

    @property
    def tokens_per_dispatch(self) -> float:
        return self.emitted / self.dispatches if self.dispatches else 0.0


class PoolSpecConfig:
    """Deployment-level pooled-spec settings, built once by the device and
    attached to the decode pool: the draft width bound. (The JAX config's
    draft-source switch comes with a second source, ``FakeDraft``, and its
    brownout probe with the brownout controller; until then the pool
    drafts by n-gram and clamps at level 0.)"""

    __slots__ = ("k_max",)

    def __init__(self, k_max: int = 4):
        if k_max < 1:
            raise ValueError(f"SPEC_K_MAX must be >= 1, got {k_max}")
        self.k_max = k_max

    def new_state(self, context: list, pending: int) -> SpecRequestState:
        return SpecRequestState(context, pending, self.k_max)
