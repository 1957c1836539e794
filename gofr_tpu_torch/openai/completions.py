"""POST /v1/completions: prompt in, text out; SSE chunks when streaming.

Port of ``gofr_tpu/openai/completions.py`` for one candidate (n = 1)
without echo or logprobs. The response bodies have the JAX package's
shape: a top-level ``text_completion`` object (no ``{"data": ...}``
envelope) with ``choices`` and ``usage``; without a tokenizer each choice
also carries its ``tokens``. Streaming frames are ``data: {...}`` chunks
ending in ``data: [DONE]``.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Any

from gofr_tpu_torch.errors import HTTPError
from gofr_tpu_torch.http.response import Raw, Stream
from gofr_tpu_torch.openai.parse import StopScanner, parse_request, prompt_tokens


def _generate_with_stops(
    ctx: Any, prompt_ids: list, max_tokens: int, sampler: Any, stop_ids: Any,
    stop_strs: list,
) -> tuple[list, str, str]:
    """Generate through the stream bridge, matching stop strings host-side
    and cancelling the decode at the first match. Returns (tokens, text
    cut before the stop, finish_reason)."""
    dec = ctx.tpu.tokenizer.stream_decoder()
    scan = StopScanner(stop_strs)
    it = ctx.tpu.generate_stream(prompt_ids, max_tokens, sampler=sampler, stop_tokens=stop_ids)
    toks: list = []
    parts: list = []
    finish = None
    try:
        for t in it:
            toks.append(t)
            emit, done = scan.feed(dec.feed(t))
            parts.append(emit)
            if done:
                finish = "stop"
                break
        if finish is None:
            emit, done = scan.feed(dec.flush())
            parts.append(emit)
            if done:
                finish = "stop"
            else:
                parts.append(scan.flush())
                finish = "length" if len(toks) >= max_tokens else "stop"
    finally:
        it.close()
    return toks, "".join(parts), finish


def _stream_completion(
    ctx: Any, prompt_ids: list, max_tokens: int, sampler: Any, stop_ids: Any,
    stop_strs: list, cmpl_id: str, created: int, model: str,
) -> Stream:
    tok = ctx.tpu.tokenizer

    def chunk(text: str, finish: Any = None, token: Any = None) -> str:
        choice: dict[str, Any] = {"text": text, "index": 0, "finish_reason": finish}
        if token is not None:
            choice["tokens"] = [token]  # id-only deployments
        return json.dumps({
            "id": cmpl_id, "object": "text_completion", "created": created,
            "model": model, "choices": [choice],
        })

    # built outside events(): a bad parameter 400s before the SSE 200
    cancel = threading.Event()
    stream_iter = ctx.tpu.generate_stream(
        prompt_ids, max_tokens, sampler=sampler, stop_tokens=stop_ids, cancel=cancel
    )

    def events():
        emitted = 0
        finish = None
        dec = tok.stream_decoder() if tok is not None else None
        scan = StopScanner(stop_strs) if stop_strs else None
        try:
            for token in stream_iter:
                emitted += 1
                if dec is None:
                    yield chunk("", token=token)
                    continue
                text = dec.feed(token)
                if scan is not None:
                    text, done = scan.feed(text)
                    if done:
                        yield chunk(text)
                        finish = "stop"
                        break
                yield chunk(text)
            tail = dec.flush() if dec is not None else ""
            if finish is None:
                if scan is not None:
                    tail, done = scan.feed(tail)
                    if done:
                        finish = "stop"
                    else:
                        tail += scan.flush()
                if finish is None:
                    finish = "length" if emitted >= max_tokens else "stop"
            else:
                tail = ""
            yield chunk(tail, finish)
            yield "[DONE]"
        except Exception as exc:
            yield json.dumps({"error": {"message": str(exc)}})
        finally:
            stream_iter.close()

    return Stream(events(), on_abort=cancel.set)


def completions(ctx: Any) -> Any:
    body, max_tokens, sampler, stop_ids, stop_strs = parse_request(ctx, default_max=16)
    if "prompt" not in body:
        # almost always a misspelled key: a default prompt would 200 on garbage
        raise HTTPError(400, 'missing "prompt"')
    prompt_ids = prompt_tokens(ctx, body["prompt"])
    model = ctx.tpu.model_name
    created = int(time.time())  # OpenAI `created` is epoch seconds
    cmpl_id = f"cmpl-{uuid.uuid4().hex[:24]}"
    tok = ctx.tpu.tokenizer
    if body.get("stream"):
        return _stream_completion(
            ctx, prompt_ids, max_tokens, sampler, stop_ids, stop_strs, cmpl_id, created, model
        )
    if stop_strs:
        out, text, finish = _generate_with_stops(
            ctx, prompt_ids, max_tokens, sampler, stop_ids, stop_strs
        )
    else:
        out = ctx.tpu.generate(prompt_ids, max_tokens, sampler=sampler, stop_tokens=stop_ids)
        text = tok.decode(out) if tok is not None else ""
        finish = "length" if len(out) >= max_tokens else "stop"
    choice: dict[str, Any] = {"text": text, "index": 0, "finish_reason": finish, "logprobs": None}
    if tok is None:
        choice["tokens"] = out
    return Raw({
        "id": cmpl_id,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [choice],
        "usage": {
            "prompt_tokens": len(prompt_ids),
            "completion_tokens": len(out),
            "total_tokens": len(prompt_ids) + len(out),
        },
    })

