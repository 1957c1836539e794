"""Token sampling: penalties and logit bias, temperature, top-k, nucleus
(top-p) and min-p.

Port of ``gofr_tpu/ops/sampling.py`` (the penalties, the filters,
``warped_probs``, ``sample_logits_rows`` and ``Sampler``). Penalties apply
first (``apply_penalties``: the CTRL repetition penalty over the context,
the additive OpenAI presence/frequency penalties over generated tokens,
then the ``logit_bias`` row); logits are then temperature-scaled, top-k,
nucleus and min-p filtered with ONE full-vocab sort, and sampled;
``temperature == 0`` takes the argmax. Random draws come from an explicit
``torch.Generator`` seeded per request: the port cannot reproduce
``jax.random``'s bits, so parity with the JAX package is greedy ids
exactly and warped distributions within tolerance.
"""

from __future__ import annotations

import functools
import secrets
from typing import Any, Optional

import numpy as np
import torch

_NEG_INF = -1e30


def apply_repetition_penalty(
    logits: torch.Tensor, presence: torch.Tensor, penalty: "torch.Tensor | float"
) -> torch.Tensor:
    """CTRL-style repetition penalty: tokens in the context (``presence``
    [B, V] bool, prompt plus generated) have positive logits divided by
    ``penalty`` and negative ones multiplied by it. ``penalty`` is a
    scalar or a per-row [B, 1] tensor (1 = off)."""
    logits = logits.float()
    penalty = _knob(penalty, logits.device)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def apply_penalties(
    logits: torch.Tensor,
    presence: torch.Tensor,
    repetition_penalty: "torch.Tensor | float",
    counts: torch.Tensor,
    presence_penalty: "torch.Tensor | float" = 0.0,
    frequency_penalty: "torch.Tensor | float" = 0.0,
    bias: "torch.Tensor | float" = 0.0,
) -> torch.Tensor:
    """Every sampling penalty in one place. ``presence`` [B, V] bool covers
    the whole context and drives the CTRL repetition penalty; ``counts``
    [B, V] f32 counts GENERATED tokens only and drives the additive OpenAI
    penalties (``presence_penalty`` once for any token already generated,
    ``frequency_penalty`` once per occurrence); ``bias`` [B, V] f32, the
    ``logit_bias`` row, is added last (±100 bans or forces a token
    whatever the other penalties say). Knobs are scalars or [B, 1]."""
    logits = apply_repetition_penalty(logits, presence, repetition_penalty)
    counts = counts.float()
    return (
        logits
        - _knob(presence_penalty, logits.device) * (counts > 0).float()
        - _knob(frequency_penalty, logits.device) * counts
        + bias
    )


def _knob(x: Any, device: torch.device) -> Any:
    """A penalty knob on ``device``: a Python number through
    ``device_scalar``, a tensor as f32. Callers in a decode loop pass
    tensors."""
    if isinstance(x, (int, float)):
        return device_scalar(x, device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def device_scalar(value: float, device: torch.device) -> Any:
    """``value`` as an f32 operand on ``device``. A Python number stays one
    on the CPU. On the card it is a 0-d tensor filled there (no upload:
    that would wait for the stream), because the card divides by a Python
    number as a multiply by its reciprocal, a last-bit difference from the
    JAX package's division."""
    if device.type == "cpu":
        return float(value)
    return _card_scalar(device, float(value))


@functools.lru_cache(maxsize=64)
def _card_scalar(device: torch.device, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def check_bias_ids(logit_bias: dict, vocab_size: int) -> None:
    """Raise ValueError for a ``logit_bias`` id outside the vocab (a 400:
    a silently dropped ban is worse than a refusal). The one home of the
    rule: the row builder and the stream's eager check both call it."""
    for tok in logit_bias:
        if not 0 <= tok < vocab_size:
            raise ValueError(
                f'"logit_bias" token id {tok} outside vocab [0, {vocab_size})'
            )


def bias_row_from_map(
    logit_bias: dict, vocab_size: int, device: "torch.device | str" = "cpu"
) -> torch.Tensor:
    """[1, V] f32 additive-bias row on ``device`` from a validated
    ``{token_id: bias}`` map (built on the host, one upload)."""
    check_bias_ids(logit_bias, vocab_size)
    row = np.zeros((1, vocab_size), np.float32)
    for tok, bias in logit_bias.items():
        row[0, tok] = bias
    return torch.from_numpy(row).to(device)


def presence_from_tokens(
    ids: Any, vocab_size: int, device: "torch.device | str" = "cpu"
) -> torch.Tensor:
    """[1, V] bool presence row of a prompt on ``device`` (built on the
    host, one upload)."""
    row = np.zeros((1, vocab_size), bool)
    row[0, np.asarray(ids, np.int64)] = True
    return torch.from_numpy(row).to(device)


def update_presence(presence: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mark freshly sampled ``tokens`` [B] in ``presence`` [B, V], in place
    (one scatter a step)."""
    rows = torch.arange(presence.shape[0], device=presence.device)
    presence[rows, tokens.long()] = True
    return presence


def update_counts(counts: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Count freshly sampled ``tokens`` [B] into ``counts`` [B, V] f32, in
    place (one scatter-add a step)."""
    counts.scatter_add_(1, tokens.long()[:, None], torch.ones_like(counts[:, :1]))
    return counts


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


def stop_tokens_from_body(body: dict) -> Optional[list[int]]:
    """A request body's ``stop_tokens``: ids that end generation (the stop
    id is not emitted), or None. Raises ValueError on a malformed value (a
    400 at the handler)."""
    stop_tokens = body.get("stop_tokens")
    if stop_tokens is None:
        return None
    if not isinstance(stop_tokens, list) or not all(
        isinstance(t, int) and not isinstance(t, bool) for t in stop_tokens
    ):
        raise ValueError('"stop_tokens" must be a list of token ids')
    return stop_tokens


class Sampler:
    """Per-request sampling state: the knobs plus a seeded generator
    (made on the logits' device at first draw)."""

    def __init__(
        self,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        repetition_penalty: float = 1.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        logit_bias: Optional[dict] = None,
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
        if repetition_penalty <= 0.0:
            raise ValueError("repetition_penalty must be > 0")
        # the OpenAI documented range of both additive penalties
        if not -2.0 <= presence_penalty <= 2.0:
            raise ValueError("presence_penalty must be in [-2, 2]")
        if not -2.0 <= frequency_penalty <= 2.0:
            raise ValueError("frequency_penalty must be in [-2, 2]")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.min_p = float(min_p)
        self.repetition_penalty = float(repetition_penalty)
        self.presence_penalty = float(presence_penalty)
        self.frequency_penalty = float(frequency_penalty)
        self.logit_bias: Optional[dict] = _parse_logit_bias(logit_bias) if logit_bias else None
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
            repetition_penalty=float(get("repetition_penalty", 1.0)),
            presence_penalty=float(get("presence_penalty", 0.0)),
            frequency_penalty=float(get("frequency_penalty", 0.0)),
            logit_bias=get("logit_bias", None),
            seed=body.get("seed"),
        )

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def penalized(self) -> bool:
        """True when a penalty or a logit bias is active: the request then
        threads presence/counts/bias state through decode (the pool's
        per-slot rows, or the penalized chunk at B = 1 solo)."""
        return (
            self.repetition_penalty != 1.0
            or self.presence_penalty != 0.0
            or self.frequency_penalty != 0.0
            or bool(self.logit_bias)
        )

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


def _parse_logit_bias(logit_bias: Any) -> dict:
    """``{token id: bias}`` from the request's map (OpenAI clients send
    string keys), each bias in [-100, 100]."""
    if not isinstance(logit_bias, dict):
        raise ValueError('"logit_bias" must be a map of token id to bias')
    parsed: dict = {}
    for k, v in logit_bias.items():
        try:
            tok = int(k)
            val = float(v)
        except (TypeError, ValueError):
            raise ValueError('"logit_bias" must map token ids to numbers') from None
        if not -100.0 <= val <= 100.0:
            raise ValueError('"logit_bias" values must be in [-100, 100]')
        parsed[tok] = val
    return parsed
