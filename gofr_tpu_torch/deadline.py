"""Serving clamps over pooled speculation's draft width.

Trimmed copy of ``gofr_tpu/deadline.py``: only ``clamp_spec_k``. The port
has no deadlines or brownout controller yet, so the decode pool calls it
with level 0 and no deadline, as the JAX pool does when neither is wired;
the arguments stay so the two cannot drift when they come.
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
