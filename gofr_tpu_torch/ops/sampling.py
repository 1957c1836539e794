"""Token sampling: temperature, top-k, nucleus (top-p) and min-p.

Port of ``gofr_tpu/ops/sampling.py`` (the filters, ``warped_probs``,
``sample_logits_rows`` and ``Sampler``). Logits are temperature-scaled,
then top-k, nucleus and min-p filtered with ONE full-vocab sort, then
sampled; ``temperature == 0`` takes the argmax. Random draws come from an
explicit ``torch.Generator`` seeded per request: the port cannot
reproduce ``jax.random``'s bits, so parity with the JAX package is greedy
ids exactly and warped distributions within tolerance. Repetition,
presence and frequency penalties and ``logit_bias`` are not ported yet.
"""

from __future__ import annotations

import secrets
from typing import Optional

import torch

_NEG_INF = -1e30


def _filter_top_k_top_p(
    scaled: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    min_p: "torch.Tensor | float" = 0.0,
) -> torch.Tensor:
    """Top-k, nucleus and min-p filtering of temperature-scaled logits.
    ``scaled`` [B, V]; ``top_k`` [B] int (0 = off); ``top_p`` [B, 1]
    (1 = off); ``min_p`` [B, 1] or scalar (0 = off). One sort serves all
    three; nucleus drops tokens whose EXCLUSIVE cumulative probability has
    reached top_p, so the argmax always survives."""
    b, v = scaled.shape
    min_p = _rows(min_p, b, torch.float32, scaled.device)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(torch.where(top_k > 0, top_k, v) - 1, 0, v - 1).long()
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    sorted_k = torch.where(sorted_desc < kth, torch.full_like(sorted_desc, _NEG_INF), sorted_desc)

    probs = torch.softmax(sorted_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs  # exclusive
    inf = torch.full_like(sorted_k, float("inf"))
    cutoff_logit = torch.min(torch.where(cum < top_p, sorted_k, inf), dim=-1, keepdim=True).values
    keep_mp = probs >= min_p * probs[:, :1]
    cutoff_mp = torch.min(torch.where(keep_mp, sorted_k, inf), dim=-1, keepdim=True).values
    cutoff = torch.maximum(kth, torch.maximum(cutoff_logit, cutoff_mp))
    return torch.where(scaled < cutoff, torch.full_like(scaled, _NEG_INF), scaled)


def _rows(x, n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A knob as an [n] tensor on ``device``. A Python number becomes a fill
    on the device: copying it from the host would wait for the stream on
    every decode step."""
    if isinstance(x, (int, float)):
        return torch.full((n,), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(-1).expand(n)


def warped_probs(
    logits: torch.Tensor,
    temperature,
    top_k=0,
    top_p=1.0,
    min_p=0.0,
) -> torch.Tensor:
    """[N, V] logits -> the warped distribution the sampler draws from
    (temperature, then the filters, then softmax). Call with
    temperature > 0."""
    logits = logits.float()
    n, dev = logits.shape[0], logits.device
    temperature = _rows(temperature, n, torch.float32, dev)[:, None]
    scaled = logits / torch.clamp(temperature, min=1e-6)
    filtered = _filter_top_k_top_p(
        scaled,
        _rows(top_k, n, torch.int32, dev),
        _rows(top_p, n, torch.float32, dev)[:, None],
        _rows(min_p, n, torch.float32, dev)[:, None],
    )
    return torch.softmax(filtered, dim=-1)


def sample_logits_rows(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature,
    top_k=0,
    top_p=1.0,
    min_p=0.0,
    all_greedy: Optional[bool] = None,
) -> torch.Tensor:
    """Per-row sampling: logits [B, V] and knobs (scalars or [B]) -> [B]
    int64 ids. Rows with temperature 0 take their argmax; an all-greedy
    batch skips the sort entirely. ``all_greedy`` states that from the
    host (the decode pool keeps its knobs' host copies): without it, a
    device ``temperature`` is read back, a host sync."""
    logits = logits.float()
    b, dev = logits.shape[0], logits.device
    greedy = torch.argmax(logits, dim=-1)
    if all_greedy is None:
        if isinstance(temperature, (int, float)):
            all_greedy = temperature <= 0.0  # decided on the host: no sync
        else:
            all_greedy = bool(torch.all(torch.as_tensor(temperature) <= 0.0))
    if all_greedy:
        return greedy
    temp = _rows(temperature, b, torch.float32, dev)
    probs = warped_probs(logits, temp, top_k, top_p, min_p)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temp <= 0.0, greedy, sampled)


class Sampler:
    """Per-request sampling state: the knobs plus a seeded generator
    (made on the logits' device at first draw)."""

    def __init__(
        self,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        seed: Optional[int] = None,
    ):
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        if top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if not 0.0 <= min_p < 1.0:
            raise ValueError("min_p must be in [0, 1)")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.min_p = float(min_p)
        self.seeded = seed is not None
        # unseeded requests must be genuinely random, not seed 0
        self.seed = int(seed) if seed is not None else secrets.randbits(63)
        self._generator: Optional[torch.Generator] = None

    @classmethod
    def from_body(cls, body: dict) -> "Sampler":
        """Build from a request body's sampling keys; an explicit JSON null
        means the default. Raises ValueError/TypeError on bad values."""

        def get(key: str, default):
            value = body.get(key)
            return default if value is None else value

        return cls(
            temperature=float(get("temperature", 0.0)),
            top_k=int(get("top_k", 0)),
            top_p=float(get("top_p", 1.0)),
            min_p=float(get("min_p", 0.0)),
            seed=body.get("seed"),
        )

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def generator(self, device: torch.device) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator(device=device)
            self._generator.manual_seed(self.seed)
        return self._generator

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, V] logits -> [B] ids under this request's knobs."""
        if self.greedy:
            return torch.argmax(logits.float(), dim=-1)
        return sample_logits_rows(
            logits, self.generator(logits.device), self.temperature,
            self.top_k, self.top_p, self.min_p,
        )

    def pick(self, logits: torch.Tensor) -> int:
        """[V] or [1, V] logits -> one token id."""
        if logits.ndim == 1:
            logits = logits[None, :]
        return int(self.sample(logits)[0])
