"""POST /v1/chat/completions: messages in, assistant message out (port of
``gofr_tpu/openai/chat.py``; each request is a flight record). The same generation
core as completions, LoRA adapters included (the response's ``model`` is
the adapter's name); only the prompt (the chat template) and the response
shapes (``chat.completion``, and ``chat.completion.chunk`` frames with
deltas when streaming) differ. A streamed chat is cancelled when its client
hangs up (``parse.abortable``), and a single stream numbers its frames (SSE
``id:``)."""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Any

from gofr_tpu_torch.errors import HTTPError
from gofr_tpu_torch.http.response import Raw, Stream
from gofr_tpu_torch.openai.fanout import (
    drive_stream_fanout,
    error_frame,
    fanout_generate,
    index_feed_text,
    index_tail_text,
    stream_candidates,
    usage_chunk,
)
from gofr_tpu_torch.openai.logprobs import chat_logprobs_obj, chat_lp_entry
from gofr_tpu_torch.openai.parse import (
    StopScanner,
    abortable,
    parse_fanout,
    parse_request,
    stream_usage_opt,
)
from gofr_tpu_torch.openai.template import render_chat_prompt
from gofr_tpu_torch.telemetry import flight


def _stream_chat(
    ctx: Any, body: dict, prompt_ids: list, max_tokens: int, sampler: Any, stop_ids: Any,
    stop_strs: list, want_logprobs: bool, top_n: int, n: int, chat_id: str, created: int,
    model: str, include_usage: bool, adapter: Any = None,
) -> Stream:
    """The SSE branch: the role first, then content deltas with host-side
    stop matching, a finish frame, ``[DONE]``. ``n`` > 1 interleaves the
    candidates' frames by ``index`` (greedy requests replicate one
    stream)."""
    if top_n:
        raise HTTPError(
            400, "top-logprob alternatives are not supported when streaming; drop "
            '"stream" or request chosen-token logprobs only'
        )
    tok = ctx.tpu.tokenizer

    def chunk(delta: dict, finish: Any = None, lp: Any = None, token_id: Any = None,
              index: int = 0) -> str:
        choice: dict[str, Any] = {"index": index, "delta": delta, "finish_reason": finish}
        if want_logprobs:
            if lp is not None and token_id is not None:
                e = chat_lp_entry(tok, token_id, lp)
                e["top_logprobs"] = []  # alternatives are refused with stream
                choice["logprobs"] = {"content": [e], "token_logprobs": [lp]}
            else:
                choice["logprobs"] = None
        frame = {"id": chat_id, "object": "chat.completion.chunk", "created": created,
                 "model": model, "choices": [choice]}
        if include_usage:
            frame["usage"] = None
        return json.dumps(frame)

    def usage_frame(completion_tokens: int) -> str:
        return usage_chunk("chat.completion.chunk", chat_id, created, model, len(prompt_ids),
                           completion_tokens)

    cancel, on_abort = abortable(ctx)
    if n > 1:
        return _stream_chat_fanout(
            ctx, body, prompt_ids, max_tokens, sampler, stop_ids, stop_strs, want_logprobs,
            n, chunk, usage_frame if include_usage else None, cancel, on_abort, adapter,
        )
    stream_iter = ctx.tpu.generate_stream(
        prompt_ids, max_tokens, sampler=sampler, stop_tokens=stop_ids, cancel=cancel,
        logprobs=want_logprobs, adapter=adapter,
    )

    def events():
        emitted = 0
        finish = None
        dec = tok.stream_decoder()
        scan = StopScanner(stop_strs) if stop_strs else None
        yield chunk({"role": "assistant"})  # the role arrives first
        try:
            for item in stream_iter:
                token, lp = item if want_logprobs else (item, None)
                emitted += 1
                text = dec.feed(token)
                if scan is not None:
                    text, done = scan.feed(text)
                    if done:
                        if text:  # no lp: the matched token's text is cut
                            yield chunk({"content": text})
                        finish = "stop"
                        break
                if text or lp is not None:
                    yield chunk({"content": text}, lp=lp, token_id=token)
            tail = dec.flush()
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
            if tail:
                yield chunk({"content": tail})
            yield chunk({}, finish)
            if include_usage:
                yield usage_frame(emitted)
            yield "[DONE]"
        except Exception as exc:
            yield error_frame(exc)
        finally:
            stream_iter.close()

    return Stream(events(), ids=True, on_abort=on_abort)


def _stream_chat_fanout(
    ctx: Any, body: dict, prompt_ids: list, max_tokens: int, sampler: Any, stop_ids: Any,
    stop_strs: list, want_logprobs: bool, n: int, chunk: Any, usage_frame: Any,
    cancel: threading.Event, on_abort: Any, adapter: Any = None,
) -> Stream:
    """Interleaved multi-index chat SSE: every index opens with its own
    role frame and closes with its own finish frame; the shared driver owns
    the loops, stop cancellation and cleanup."""
    tok = ctx.tpu.tokenizer
    replicate = sampler.greedy
    iters = stream_candidates(ctx, body, prompt_ids, max_tokens, sampler, stop_ids,
                              want_logprobs, 1 if replicate else n, cancel=cancel,
                              adapter=adapter)
    decs = [tok.stream_decoder() for _ in range(n)]
    scans = [StopScanner(stop_strs) if stop_strs else None for _ in range(n)]
    emitted = [0] * n
    finish: list = [None] * n

    def open_frames():
        for i in range(n):
            yield chunk({"role": "assistant"}, index=i)

    def feed(i, token, lp):
        text, stopped = index_feed_text(decs[i], scans[i], finish, i, emitted, token)
        if stopped:  # the matched token's lp is cut with its text
            return [chunk({"content": text}, index=i)] if text else []
        if text or lp is not None:
            return [chunk({"content": text}, lp=lp, token_id=token, index=i)]
        return []

    def tail(i):
        t = index_tail_text(decs[i], scans[i], finish, i, emitted, max_tokens)
        frames = [chunk({"content": t}, index=i)] if t else []
        frames.append(chunk({}, finish[i], index=i))
        return frames

    usage_frames = (lambda: [usage_frame(sum(emitted))]) if usage_frame is not None else None
    return Stream(
        drive_stream_fanout(iters, replicate, n, finish, want_logprobs, open_frames, feed,
                            tail, usage_frames),
        on_abort=on_abort,
    )


def chat_completions(ctx: Any) -> Any:
    (body, max_tokens, sampler, stop_ids, stop_strs, want_logprobs, top_n,
     adapter) = parse_request(ctx, default_max=64)
    tok = ctx.tpu.tokenizer
    if tok is None:
        raise HTTPError(
            400, "chat completions need a tokenizer (set TOKENIZER_PATH or TOKENIZER=byte)"
        )
    prompt_ids = tok.encode(render_chat_prompt(ctx, body.get("messages")))
    if not prompt_ids:
        raise HTTPError(400, "messages encoded to zero tokens")
    model = adapter or ctx.tpu.model_name  # an adapter serves under its name
    created = int(time.time())  # OpenAI `created` is epoch seconds
    chat_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
    n, _, _ = parse_fanout(body, allow_best_of=False)
    if top_n and stop_strs:
        raise HTTPError(
            400, "top-logprob alternatives with multi-token stop sequences are not "
            'supported; use "stop_token_ids"'
        )
    include_usage = stream_usage_opt(body)  # validated even without stream
    # the flight record, as in completions
    with flight(
        ctx.container.telemetry, model=model, endpoint="/v1/chat/completions",
        trace_id=ctx.trace_id or "", tokens_in=len(prompt_ids),
        stream=bool(body.get("stream")),
    ) as fl:
        if body.get("stream"):
            return fl.defer(_stream_chat(
                ctx, body, prompt_ids, max_tokens, sampler, stop_ids, stop_strs,
                want_logprobs, top_n, n, chat_id, created, model, include_usage, adapter,
            ))
        results, generated = fanout_generate(
            ctx, body, prompt_ids, max_tokens, sampler, stop_ids, stop_strs, want_logprobs,
            top_n, n, n, adapter,
        )
    choices = [
        {
            "index": i,
            "message": {
                "role": "assistant",
                "content": text if text is not None else tok.decode(out),
            },
            "finish_reason": (
                finish if finish is not None
                else ("length" if len(out) >= max_tokens else "stop")
            ),
            "logprobs": (
                chat_logprobs_obj(tok, logprobs, out, tops, top_n)
                if logprobs is not None else None
            ),
        }
        for i, (out, logprobs, tops, text, finish) in enumerate(results)
    ]
    return Raw({
        "id": chat_id,
        "object": "chat.completion",
        "created": created,
        "model": model,
        "choices": choices,
        "usage": {
            "prompt_tokens": len(prompt_ids),
            "completion_tokens": generated,
            "total_tokens": len(prompt_ids) + generated,
        },
    })
