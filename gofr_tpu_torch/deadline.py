"""Serving clamps over pooled speculation's draft width, and the
overload counters' registrations.

Trimmed copy of ``gofr_tpu/deadline.py``: ``clamp_spec_k`` and the ONE
registration of each of ``gofr_tpu_deadline_exceeded_total``,
``gofr_tpu_cancellations_total`` and ``gofr_tpu_pool_reject_total``. The
port has no deadlines or brownout controller yet, so the decode pool calls
``clamp_spec_k`` with level 0 and no deadline, as the JAX pool does when
neither is wired, and of the three counters only the pool reject moves
(the pool's rejects, echo's paged-KV admission); the arguments and the
families stay so the two packages cannot drift when the rest comes.
"""

from __future__ import annotations

from typing import Any, Optional


def clamp_spec_k(
    k: int,
    brownout_level: int = 0,
    deadline: Optional[Any] = None,
    cadence_s: float = 0.0,
) -> int:
    """A request's adaptive draft width ``k`` under the serving clamps:

    - **brownout**: level 1 caps k at 1, level >= 2 turns speculation off
      (k = 0, plain decode): rejected drafts are wasted target compute, and
      overload is when that waste hurts co-tenants;
    - **deadline** (anything with ``remaining()`` seconds): a verify costs
      about one chunk at the observed ``cadence_s`` whatever k is, but a
      cycle under rejection emits one token, so a request whose budget
      covers fewer than ``k + 1`` cadence units speculates less: k is
      capped at ``remaining / cadence - 1`` (never below 0). No deadline,
      or no cadence sample yet, keeps the adaptive k."""
    if k <= 0:
        return 0
    if brownout_level >= 2:
        return 0
    if brownout_level >= 1:
        k = min(k, 1)
    if deadline is not None and cadence_s > 0:
        budget_chunks = int(deadline.remaining() / cadence_s)
        k = min(k, max(budget_chunks - 1, 0))
    return k


def deadline_exceeded_counter(metrics: Any) -> Any:
    """The ONE registration of ``gofr_tpu_deadline_exceeded_total``
    (every stage registers through here; the registry dedupes by name)."""
    return metrics.counter(
        "gofr_tpu_deadline_exceeded_total",
        "requests shed because their end-to-end deadline expired, by "
        "stage (queue: batcher dequeue; admission: pool/paged-KV "
        "submit; decode: mid-generation)",
        labels=("stage",),
    )


def cancellations_counter(metrics: Any) -> Any:
    """The ONE registration of ``gofr_tpu_cancellations_total``."""
    return metrics.counter(
        "gofr_tpu_cancellations_total",
        "mid-flight generation cancellations by cause (client_abort: "
        "the SSE consumer vanished; deadline: the request's budget "
        "expired mid-decode)",
        labels=("cause",),
    )


def pool_reject_counter(metrics: Any) -> Any:
    """The ONE registration of ``gofr_tpu_pool_reject_total``: the decode
    pool's submit rejections by reason (each falls back to solo decode)."""
    return metrics.counter(
        "gofr_tpu_pool_reject_total",
        "decode-pool submit rejections (most reasons fall back to solo "
        "decode; deadline sheds with a 504)",
        labels=("reason",),
    )
