"""Request parsing for ``/v1/completions`` (trimmed from
``gofr_tpu/openai/parse.py``): prompts, stops (device ids plus host-matched
strings) and sampling knobs. Knobs this port cannot honor yet are a clear
400, never a silent ignore."""

from __future__ import annotations

from typing import Any

from gofr_tpu_torch.errors import HTTPError

# OpenAI knobs the JAX package serves that this port does not yet
_NOT_PORTED = (
    "suffix", "logprobs", "top_logprobs", "echo", "presence_penalty",
    "frequency_penalty", "repetition_penalty", "logit_bias", "stream_options",
    "adapter", "tools", "tool_choice", "functions", "function_call",
)


def prompt_tokens(ctx: Any, prompt: Any) -> list[int]:
    if isinstance(prompt, str):
        tok = ctx.tpu.tokenizer
        if tok is None:
            raise HTTPError(
                400, "string prompt needs a tokenizer (set TOKENIZER=byte); "
                "token-id lists work without one",
            )
        ids = tok.encode(prompt)
        if not ids:
            raise HTTPError(400, "prompt encoded to zero tokens")
        return ids
    if isinstance(prompt, list) and prompt and all(
        isinstance(t, int) and not isinstance(t, bool) for t in prompt
    ):
        return prompt
    raise HTTPError(400, '"prompt" must be a non-empty string or list of token ids')


def parse_stops(ctx: Any, body: dict) -> tuple[frozenset, list]:
    """(device stop ids, host-matched stop strings). A stop string that
    encodes to one token also stops on the device."""
    ids = set()
    raw_ids = body.get("stop_token_ids")
    if raw_ids is not None:
        if not isinstance(raw_ids, list) or not all(isinstance(t, int) for t in raw_ids):
            raise HTTPError(400, '"stop_token_ids" must be a list of ints')
        ids.update(raw_ids)
    stop = body.get("stop")
    if stop is None:
        return frozenset(ids), []
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list) or not all(isinstance(s, str) and s for s in stop):
        raise HTTPError(400, '"stop" must be a non-empty string or list of them')
    if len(stop) > 4:
        raise HTTPError(400, '"stop" accepts at most 4 sequences (OpenAI limit)')
    tok = ctx.tpu.tokenizer
    if tok is None:
        raise HTTPError(400, '"stop" strings need a tokenizer; use "stop_token_ids"')
    for s in stop:
        encoded = tok.encode(s)
        if len(encoded) == 1:
            ids.add(encoded[0])
    return frozenset(ids), list(stop)


class StopScanner:
    """Incremental multi-token stop matching with hold-back: ``feed``
    returns (emit, done) where ``emit`` never holds a stop string nor a
    tail that could still grow into one."""

    def __init__(self, stops: list):
        self.stops = stops
        self.buf = ""

    def feed(self, text: str) -> tuple[str, bool]:
        self.buf += text
        hits = [p for p in (self.buf.find(s) for s in self.stops) if p >= 0]
        if hits:
            return self.buf[: min(hits)], True
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.buf)), 0, -1):
                if self.buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        cut = len(self.buf) - hold
        emit, self.buf = self.buf[:cut], self.buf[cut:]
        return emit, False

    def flush(self) -> str:
        emit, self.buf = self.buf, ""
        return emit


def parse_request(ctx: Any, default_max: int) -> tuple:
    """(body, max_tokens, sampler, stop_ids, stop_strs)."""
    from gofr_tpu_torch.ops.sampling import Sampler

    if ctx.tpu is None:
        raise HTTPError(503, "no model configured (set MODEL_NAME)")
    body = ctx.bind() if ctx.request.body else {}
    if not isinstance(body, dict):
        raise HTTPError(400, "request body must be a JSON object")
    for key in _NOT_PORTED:
        value = body.get(key)
        if value in (None, False) or (key == "tool_choice" and value == "none"):
            continue
        raise HTTPError(400, f'"{key}" is not supported by this server yet')
    for key in ("n", "best_of"):
        if body.get(key) not in (None, 1):
            raise HTTPError(400, f'"{key}" other than 1 is not supported by this server yet')
    requested = body.get("model")
    if isinstance(requested, str) and requested != ctx.tpu.model_name:
        raise HTTPError(404, f"model '{requested}' not found (serving: {ctx.tpu.model_name})")
    max_tokens = body.get("max_tokens")
    if max_tokens is None:
        max_tokens = default_max
    if not isinstance(max_tokens, int) or isinstance(max_tokens, bool) or max_tokens < 1:
        raise HTTPError(400, '"max_tokens" must be a positive integer')
    try:
        # OpenAI semantics default to temperature 1.0; explicit nulls mean
        # the default
        sampler = Sampler.from_body({
            "temperature": 1.0, "top_p": 1.0,
            **{k: v for k, v in body.items() if v is not None},
        })
    except (TypeError, ValueError) as exc:
        raise HTTPError(400, f"invalid sampling params: {exc}") from None
    stop_ids, stop_strs = parse_stops(ctx, body)
    return body, max_tokens, sampler, stop_ids, stop_strs

