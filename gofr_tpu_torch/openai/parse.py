"""Request parsing shared by the OpenAI endpoints (trimmed from
``gofr_tpu/openai/parse.py``): prompts, stops (device ids plus host-matched
strings), sampling knobs, logprobs and top-logprobs, ``stream_options`` and
the n/best_of/echo fan-out constraints, and the LoRA adapter a request
selects (the ``adapter`` key, or a ``model`` naming a loaded adapter), and
the admission gate: the request's identity for its flight record (the
fleet origin, ``X-Gofr-Request-Id`` and ``X-Gofr-Hop``, and the hashed
tenant), the KV-donor hint (``X-KV-Donor``), its deadline (``X-Request-Deadline-Ms``, default
``REQUEST_DEADLINE_S``) and priority (``X-Priority``, default
``PRIORITY_DEFAULT``), and the brownout's verdict (a 429 with
``Retry-After``); and ``abortable``, a stream's client-abort wiring. Knobs
this server cannot honor are a clear 400, never a silent ignore."""

from __future__ import annotations

import threading
from typing import Any

from gofr_tpu_torch.deadline import (
    PRIORITY_DEFAULT,
    activate_deadline,
    activate_priority,
    cancellations_counter,
    parse_deadline,
    parse_priority,
)
from gofr_tpu_torch.errors import HTTPError, TooManyRequestsError
from gofr_tpu_torch.fleet.admission import tenant_of
from gofr_tpu_torch.fleet.kvwire import activate_kv_hint, parse_kv_hint
from gofr_tpu_torch.telemetry import (
    activate_origin,
    activate_tenant,
    current_record,
    origin_from_headers,
)

# knobs that would change what the model is ASKED to do: silently ignoring
# them serves wrong output to a client that believes its tools were offered
_REFUSED = ("tools", "tool_choice", "functions", "function_call", "modalities", "audio",
            "prediction")

FANOUT_CAP = 16  # pool-slot-scale bound on n/best_of; beyond it is a 400


def prompt_tokens(ctx: Any, prompt: Any) -> list[int]:
    if isinstance(prompt, str):
        tok = ctx.tpu.tokenizer
        if tok is None:
            raise HTTPError(
                400, "string prompt needs a tokenizer (set TOKENIZER_PATH or "
                "TOKENIZER=byte); token-id lists work without one",
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
    encodes to one token stops on the device too; every string is also
    matched on the host, since the same text can arrive through another
    tokenization."""
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
    tail that could still grow into one. ``match_pos`` is the absolute
    character offset of the matched stop."""

    def __init__(self, stops: list):
        self.stops = stops
        self.buf = ""
        self.consumed = 0  # characters fed in all
        self.match_pos = None

    def feed(self, text: str) -> tuple[str, bool]:
        self.buf += text
        self.consumed += len(text)
        hits = [p for p in (self.buf.find(s) for s in self.stops) if p >= 0]
        if hits:
            idx = min(hits)
            self.match_pos = self.consumed - len(self.buf) + idx
            return self.buf[:idx], True
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
        """End of stream: held-back text can no longer become a stop."""
        emit, self.buf = self.buf, ""
        return emit


def sampler_from_body(body: dict) -> Any:
    """The request's Sampler with OpenAI's defaults (temperature 1.0):
    the sampling knobs, the repetition/presence/frequency penalties and
    ``logit_bias``; explicit JSON nulls mean the default."""
    from gofr_tpu_torch.ops.sampling import Sampler

    try:
        return Sampler.from_body({
            "temperature": 1.0, "top_p": 1.0,
            **{k: v for k, v in body.items() if v is not None},
        })
    except (TypeError, ValueError) as exc:
        raise HTTPError(400, f"invalid sampling params: {exc}") from None


def bind_identity(ctx: Any) -> str:
    """Bind the request's identity for the flight record born downstream:
    the router-stamped origin (garbage headers degrade to none, never a
    4xx) and the hashed tenant the ledger meters. Returns the tenant."""
    activate_origin(origin_from_headers(
        ctx.request.header("X-Gofr-Request-Id"), ctx.request.header("X-Gofr-Hop"),
    ))
    # the router's derivation: X-Tenant only under FLEET_TRUST_TENANT_HEADER,
    # else a sha256 of the Authorization credential
    tenant = tenant_of(
        ctx.request,
        ctx.config.get_or_default("FLEET_TRUST_TENANT_HEADER", "").lower()
        in ("on", "1", "true", "yes"),
    )
    activate_tenant(tenant)
    return tenant


def admit_request(ctx: Any, max_tokens: int) -> int:
    """The admission gate both endpoints share (the JAX package's
    ``_admit_request``). It binds, for the stages and the flight record
    born downstream, the priority (``X-Priority``, a malformed one is a
    400), the deadline (``X-Request-Deadline-Ms``, else
    ``REQUEST_DEADLINE_S``; 0 = none) and the identity
    (``bind_identity``); then asks the device's
    brownout: a shed is a 429 with ``Retry-After`` (metered on the tenant
    ledger, the body naming the hashed tenant), and level 2 may clamp
    ``max_tokens``. Returns the (possibly clamped) ``max_tokens``."""
    config = ctx.config
    priority = parse_priority(
        ctx.request.header("X-Priority"),
        default=int(config.get_or_default("PRIORITY_DEFAULT", str(PRIORITY_DEFAULT))),
    )
    activate_priority(priority)
    activate_deadline(parse_deadline(
        ctx.request.header("X-Request-Deadline-Ms"),
        float(config.get_or_default("REQUEST_DEADLINE_S", "0")), priority=priority,
    ))
    # the KV-donor hint the router stamps (disaggregated prefill/decode):
    # read once by generate before admission; a malformed hint degrades to
    # local prefill, and the device acts on it only under
    # KV_TRANSFER_TRUST_HINT=on
    activate_kv_hint(parse_kv_hint(ctx.request.header("X-KV-Donor")))
    tenant = bind_identity(ctx)
    brownout = getattr(ctx.tpu, "brownout", None)
    if brownout is not None:
        admitted, max_tokens, level = brownout.admit(priority, max_tokens)
        if not admitted:
            ctx.container.tenants.shed(tenant)
            exc = TooManyRequestsError(
                f"shed by overload brownout (level {level}, request priority {priority}); "
                "retry later or raise X-Priority"
            )
            exc.retry_after_s = 1.0
            exc.tenant = tenant
            raise exc
    return max_tokens


def abortable(ctx: Any) -> tuple:
    """One streaming generation's client-abort wiring: a fresh cancel event
    (passed to ``generate_stream`` and every fan-out candidate) and the
    ``Stream.on_abort`` callable. The responder calls it when a write fails
    or the connection task is cancelled: it trips the event (the pool frees
    the row's slot and blocks at its next chunk boundary), counts
    ``gofr_tpu_cancellations_total{cause="client_abort"}`` and finishes the
    flight record as cancelled. A server shutting down closes every stream
    too: that still frees the work but counts no client abort. Returns
    ``(cancel, on_abort)``."""
    cancel = threading.Event()
    container = ctx.container
    counter = cancellations_counter(container.metrics)
    record = current_record()

    def on_abort() -> None:
        cancel.set()
        if getattr(container, "closing", False):
            return
        counter.inc(cause="client_abort")
        if record is not None:
            container.telemetry.finish(record, status="cancelled")

    return cancel, on_abort


def parse_request(ctx: Any, default_max: int) -> tuple:
    """The parse both endpoints share: (body, max_tokens, sampler,
    stop_ids, stop_strs, want_logprobs, top_n, adapter)."""
    from gofr_tpu_torch.models.transformer import TOP_LOGPROBS

    if ctx.tpu is None:
        raise HTTPError(503, "no model configured (set MODEL_NAME)")
    body = ctx.bind() if ctx.request.body else {}
    if not isinstance(body, dict):
        raise HTTPError(400, "request body must be a JSON object")
    if body.get("suffix") is not None:
        raise HTTPError(400, '"suffix" is not supported by this server')
    for key in _REFUSED:
        value = body.get(key)
        if value is None or (key == "tool_choice" and value == "none"):
            continue  # "none" is the documented no-tools default
        raise HTTPError(400, f'"{key}" is not supported by this server')
    rf = body.get("response_format")
    if rf is not None and not (isinstance(rf, dict) and rf.get("type") == "text"):
        # {"type": "text"} is the default; constrained JSON output is not
        # implemented, and a client trusting it would parse free text
        raise HTTPError(
            400, '"response_format" types other than "text" are not supported by this '
            "server (no constrained decoding)"
        )
    # max_tokens=0 is legal only with echo: pure prompt scoring
    max_tokens = body.get("max_tokens")
    if max_tokens is None:
        max_tokens = default_max
    floor = 0 if body.get("echo") is True else 1
    if not isinstance(max_tokens, int) or isinstance(max_tokens, bool) or max_tokens < floor:
        raise HTTPError(
            400, '"max_tokens" must be a positive integer'
            + (" (0 allowed with echo)" if floor == 0 else ""),
        )
    # after max_tokens validates: a level-2 brownout may clamp it
    max_tokens = admit_request(ctx, max_tokens)
    sampler = sampler_from_body(body)
    stop_ids, stop_strs = parse_stops(ctx, body)
    # alternatives: an integer logprobs >= 2 (the completions form) or the
    # chat-style "top_logprobs" key, which wins when both are present;
    # logprobs 1/true stays chosen-token-only
    lp_req = body.get("logprobs")
    want_logprobs = lp_req not in (None, False, 0)
    top_n = 0
    if isinstance(lp_req, int) and not isinstance(lp_req, bool) and lp_req >= 2:
        top_n = lp_req
    tl = body.get("top_logprobs")
    if tl is not None:
        if not isinstance(tl, int) or isinstance(tl, bool) or tl < 0:
            raise HTTPError(400, '"top_logprobs" must be an integer >= 0')
        top_n = tl
        if tl > 0:
            want_logprobs = True
    if top_n > TOP_LOGPROBS:
        raise HTTPError(
            400, f'the maximum value for "logprobs"/"top_logprobs" is {TOP_LOGPROBS}'
        )
    return (body, max_tokens, sampler, stop_ids, stop_strs, want_logprobs, top_n,
            parse_adapter(ctx, body))


def parse_adapter(ctx: Any, body: dict) -> Any:
    """The LoRA adapter a request selects, or None for the base model: the
    ``adapter`` extension key, else a ``model`` naming a loaded adapter
    (stock OpenAI clients cannot send ``adapter``, but they set model). Any
    other ``model`` is a 404, as in the OpenAI API: a client routed to an
    adapter that is not loaded must never get the base model's output.
    ``OPENAI_ACCEPT_UNKNOWN_MODEL`` (1 | true | on) serves the base model
    instead."""
    adapter = body.get("adapter")
    if adapter is not None and not isinstance(adapter, str):
        raise HTTPError(400, '"adapter" must be a string')
    requested = body.get("model")
    if adapter is None and isinstance(requested, str) and requested != ctx.tpu.model_name:
        loaded = ctx.tpu.list_adapters()
        if requested in loaded:
            return requested
        if ctx.config.get_or_default("OPENAI_ACCEPT_UNKNOWN_MODEL", "") in ("1", "true", "on"):
            # clients with a hardcoded model string: serve the base model
            # whatever "model" says
            return None
        raise HTTPError(
            404, f"model '{requested}' not found (serving: {[ctx.tpu.model_name, *loaded]})"
        )
    return adapter


def stream_usage_opt(body: dict) -> bool:
    """OpenAI ``stream_options``: {"include_usage": true} asks for ONE
    final pre-[DONE] frame with empty choices and the usage object (and
    "usage": null on every other frame). Only legal with stream."""
    so = body.get("stream_options")
    if so is None:
        return False
    if not isinstance(so, dict):
        raise HTTPError(400, '"stream_options" must be an object')
    if not body.get("stream"):
        raise HTTPError(400, '"stream_options" is only allowed with "stream": true')
    unknown = set(so) - {"include_usage"}
    if unknown:
        # a misspelled include_usage must not stream without its usage frame
        raise HTTPError(400, f'unknown "stream_options" keys: {sorted(unknown)}')
    inc = so.get("include_usage", False)
    if not isinstance(inc, bool):
        raise HTTPError(400, '"stream_options.include_usage" must be a boolean')
    return inc


def parse_fanout(body: dict, allow_best_of: bool) -> tuple[int, int, bool]:
    """(n, best_of, echo) with OpenAI's constraints: best_of >= n, both
    capped at ``FANOUT_CAP``, best_of and echo completions-only."""

    def positive(key: str, default: int) -> int:
        value = body.get(key)
        if value is None:
            return default
        if not isinstance(value, int) or isinstance(value, bool) or value < 1:
            raise HTTPError(400, f'"{key}" must be a positive integer')
        if value > FANOUT_CAP:
            raise HTTPError(400, f'"{key}" is capped at {FANOUT_CAP} on this server')
        return value

    n = positive("n", 1)
    best_of = positive("best_of", 1)  # type- and range-checked on both endpoints
    if not allow_best_of and best_of != 1:
        raise HTTPError(400, '"best_of" is a completions-only parameter')
    if body.get("best_of") is not None and best_of < n:
        raise HTTPError(400, '"best_of" must be >= "n"')
    best_of = max(n, best_of)
    echo = body.get("echo")
    if echo is None:
        echo = False
    elif not isinstance(echo, bool):
        # bool("false") is True: a loud 400 beats echoing against the ask
        raise HTTPError(400, '"echo" must be a boolean')
    if not allow_best_of and echo:
        raise HTTPError(400, '"echo" is a completions-only parameter')
    return n, best_of, echo
