"""POST /v1/completions: prompt in, text out; SSE frames when streaming;
echo, and echo + logprobs teacher-forced scoring; logprobs objects; the
n/best_of fan-out and its interleaved multi-index SSE; the
``stream_options.include_usage`` frame.

Port of ``gofr_tpu/openai/completions.py``. Each request is a flight record
(``telemetry.flight``): a streamed one finishes when its stream ends, or is
cancelled when its client hangs up (``parse.abortable``: the decode frees
its slot within a chunk). A single stream numbers its frames (SSE ``id:``
from the resume offset) and resumes: ``X-Resume-From: k`` continues an
interrupted greedy or seeded stream at token k (``generate_stream``). An
expired deadline answers 504. A LoRA adapter (``adapter``, or ``model`` naming one)
serves every path, echo scoring included, and names the response's
``model``. The response bodies have the JAX package's
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
from gofr_tpu_torch.telemetry import flight
from gofr_tpu_torch.openai.fanout import (
    drive_stream_fanout,
    error_frame,
    fanout_generate,
    index_feed_text,
    index_tail_text,
    stream_candidates,
    usage_chunk,
)
from gofr_tpu_torch.openai.logprobs import logprobs_obj
from gofr_tpu_torch.openai.parse import (
    StopScanner,
    abortable,
    parse_fanout,
    parse_request,
    prompt_tokens,
    stream_usage_opt,
)


def _stream_completion(
    ctx: Any, body: dict, prompt_ids: list, max_tokens: int, sampler: Any, stop_ids: Any,
    stop_strs: list, want_logprobs: bool, top_n: int, n: int, best_of: int, echo: bool,
    cmpl_id: str, created: int, model: str, include_usage: bool, adapter: Any = None,
    resume_from: int = 0,
) -> Stream:
    """The SSE branch: per-token text frames with host-side stop matching,
    ending in ``data: [DONE]``. ``n`` > 1 streams the candidates at once as
    interleaved frames carrying their ``index``; greedy requests replicate
    one stream across every index (as the non-stream fan-out does). A
    single stream's frames are numbered from ``resume_from``, the position
    it resumes at (clamped to the budget: a client cut off between the last
    token and ``[DONE]`` resumes into the tail)."""
    if best_of > n:
        raise HTTPError(
            400, '"best_of" > "n" is not supported when streaming (candidates cannot be '
            "ranked and discarded mid-stream)"
        )
    if max_tokens == 0:
        raise HTTPError(
            400, 'streaming needs "max_tokens" >= 1 (use the non-stream form for pure echo '
            "scoring)"
        )
    if top_n:
        raise HTTPError(
            400, "top-logprob alternatives are not supported when streaming; drop "
            '"stream" or request chosen-token logprobs only'
        )
    tok = ctx.tpu.tokenizer

    def chunk(text: str, lp: Any = None, finish: Any = None, token: Any = None,
              index: int = 0) -> str:
        choice: dict[str, Any] = {"text": text, "index": index, "finish_reason": finish}
        if token is not None:
            choice["tokens"] = [token]  # id-only deployments
        if want_logprobs:
            choice["logprobs"] = {"token_logprobs": [lp]} if lp is not None else None
        frame = {"id": cmpl_id, "object": "text_completion", "created": created,
                 "model": model, "choices": [choice]}
        if include_usage:
            frame["usage"] = None
        return json.dumps(frame)

    def usage_frame(completion_tokens: int) -> str:
        return usage_chunk("text_completion", cmpl_id, created, model, len(prompt_ids),
                           completion_tokens)

    # built outside the generator: a bad parameter 400s before the SSE 200
    cancel, on_abort = abortable(ctx)
    if n > 1:
        return _stream_completion_fanout(
            ctx, body, prompt_ids, max_tokens, sampler, stop_ids, stop_strs, want_logprobs,
            n, echo, chunk, usage_frame if include_usage else None, cancel, on_abort, adapter,
        )
    resume_from = min(resume_from, max_tokens)
    stream_iter = ctx.tpu.generate_stream(
        prompt_ids, max_tokens, sampler=sampler, stop_tokens=stop_ids, cancel=cancel,
        logprobs=want_logprobs, adapter=adapter, resume_from=resume_from,
    )

    def events():
        # a resumed stream starts at the resume position: emitted counts
        # absolute positions, so finish_reason matches the uninterrupted run
        emitted = resume_from
        finish = None
        dec = tok.stream_decoder() if tok is not None else None
        scan = StopScanner(stop_strs) if stop_strs else None
        try:
            if echo:  # the prompt first, as the non-stream shape has it
                if dec is not None:
                    yield chunk(tok.decode(prompt_ids))
                else:
                    for t in prompt_ids:
                        yield chunk("", token=t)
            for item in stream_iter:
                token, lp = item if want_logprobs else (item, None)
                emitted += 1
                if dec is None:
                    yield chunk("", lp, token=token)
                    continue
                text = dec.feed(token)
                if scan is not None:
                    text, done = scan.feed(text)
                    if done:
                        # the matched token's text is cut, and its lp with it
                        yield chunk(text)
                        finish = "stop"
                        break
                yield chunk(text, lp)
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
            yield chunk(tail, None, finish)
            if include_usage:
                yield usage_frame(emitted)
            yield "[DONE]"
        except Exception as exc:
            yield error_frame(exc)
        finally:
            stream_iter.close()

    return Stream(events(), ids=True, id_offset=resume_from, on_abort=on_abort)


def _stream_completion_fanout(
    ctx: Any, body: dict, prompt_ids: list, max_tokens: int, sampler: Any, stop_ids: Any,
    stop_strs: list, want_logprobs: bool, n: int, echo: bool, chunk: Any, usage_frame: Any,
    cancel: threading.Event, on_abort: Any, adapter: Any = None,
) -> Stream:
    """Interleaved multi-index SSE: the shared driver
    (``drive_stream_fanout``) owns the replicate/multiplex loops, the
    stop cancellation and the cleanup; this supplies the frame shapes."""
    tok = ctx.tpu.tokenizer
    replicate = sampler.greedy
    iters = stream_candidates(ctx, body, prompt_ids, max_tokens, sampler, stop_ids,
                              want_logprobs, 1 if replicate else n, cancel=cancel,
                              adapter=adapter)
    decs = [tok.stream_decoder() if tok is not None else None for _ in range(n)]
    scans = [StopScanner(stop_strs) if stop_strs else None for _ in range(n)]
    emitted = [0] * n
    finish: list = [None] * n

    def open_frames():
        if not echo:
            return
        for i in range(n):
            if tok is not None:
                yield chunk(tok.decode(prompt_ids), index=i)
            else:
                for t in prompt_ids:
                    yield chunk("", token=t, index=i)

    def feed(i, token, lp):
        text, stopped = index_feed_text(decs[i], scans[i], finish, i, emitted, token)
        if text is None:  # id-only deployment: the tokens extension
            return [chunk("", lp, token=token, index=i)]
        if stopped:  # the matched token's lp is cut with its text
            return [chunk(text, None, index=i)]
        return [chunk(text, lp, index=i)]

    def tail(i):
        t = index_tail_text(decs[i], scans[i], finish, i, emitted, max_tokens)
        return [chunk(t, None, finish[i], index=i)]

    usage_frames = (lambda: [usage_frame(sum(emitted))]) if usage_frame is not None else None
    return Stream(
        drive_stream_fanout(iters, replicate, n, finish, want_logprobs, open_frames, feed,
                            tail, usage_frames),
        on_abort=on_abort,
    )


def completions(ctx: Any) -> Any:
    (body, max_tokens, sampler, stop_ids, stop_strs, want_logprobs, top_n,
     adapter) = parse_request(ctx, default_max=16)
    n, best_of, echo = parse_fanout(body, allow_best_of=True)
    if echo and want_logprobs and body.get("stream"):
        raise HTTPError(400, '"echo" with "logprobs" is not supported when streaming')
    if top_n and stop_strs:
        raise HTTPError(
            400, "top-logprob alternatives with multi-token stop sequences are not "
            'supported; use "stop_token_ids"'
        )
    if "prompt" not in body:
        # almost always a misspelled key: a default prompt would 200 on garbage
        raise HTTPError(400, 'missing "prompt"')
    prompt_ids = prompt_tokens(ctx, body["prompt"])
    model = adapter or ctx.tpu.model_name  # an adapter serves under its name
    created = int(time.time())  # OpenAI `created` is epoch seconds
    cmpl_id = f"cmpl-{uuid.uuid4().hex[:24]}"
    tok = ctx.tpu.tokenizer
    include_usage = stream_usage_opt(body)  # validated even without stream
    # the flight record rides a contextvar: the batcher, the pool and the
    # device stamp it downstream; the guard owns ok/error/drop
    with flight(
        ctx.container.telemetry, model=model, endpoint="/v1/completions",
        trace_id=ctx.trace_id or "", tokens_in=len(prompt_ids),
        stream=bool(body.get("stream")),
    ) as fl:
        if body.get("stream"):
            # X-Resume-From: a client (or the fleet router) holding frames
            # 0..k-1 of an interrupted stream asks for the rest
            resume_from = 0
            raw_resume = ctx.request.header("X-Resume-From")
            if raw_resume:
                try:
                    resume_from = int(raw_resume)
                except ValueError:
                    raise HTTPError(400, '"X-Resume-From" must be an integer frame offset') \
                        from None
                if resume_from < 0:
                    raise HTTPError(400, '"X-Resume-From" must be >= 0')
            # the record completes when the stream ends
            return fl.defer(_stream_completion(
                ctx, body, prompt_ids, max_tokens, sampler, stop_ids, stop_strs,
                want_logprobs, top_n, n, best_of, echo, cmpl_id, created, model,
                include_usage, adapter, resume_from,
            ))
        prompt_lps = None
        if echo and want_logprobs:
            # teacher-forced prompt scoring, null for the first token (no
            # conditional): the OpenAI convention and the eval-harness
            # loglikelihood pattern; an adapter's request scores under it
            # (and an unknown adapter 400s)
            prompt_lps = [None] + ctx.tpu.score(prompt_ids, adapter=adapter)
        elif (max_tokens == 0 and adapter is not None
              and adapter not in ctx.tpu.list_adapters()):
            # pure echo without logprobs runs no model, yet the adapter it
            # names must still exist
            raise HTTPError(400, f"adapter '{adapter}' (loaded: {ctx.tpu.list_adapters()})")
        if max_tokens == 0:  # pure scoring (echo only, enforced at parse)
            results = [([], [] if want_logprobs else None, [] if top_n else None, None,
                        "length")] * n
            generated = 0
        else:
            results, generated = fanout_generate(
                ctx, body, prompt_ids, max_tokens, sampler, stop_ids, stop_strs,
                want_logprobs, top_n, n, best_of, adapter,
            )
    choices = []
    for i, (out, logprobs, tops, text, finish) in enumerate(results):
        if text is None:
            text_ids = (prompt_ids + out) if echo else out
            text_val = tok.decode(text_ids) if tok is not None else ""
            finish = "length" if len(out) >= max_tokens else "stop"
        else:
            # the stop scanner's text IS the completion; echo prepends the prompt
            text_val = (tok.decode(prompt_ids) + text) if echo else text
        lp_list, lp_ids = logprobs, out
        if prompt_lps is not None:
            lp_list = prompt_lps + (logprobs or [])
            lp_ids = prompt_ids + out
        lp_obj = None
        if lp_list is not None:
            lp_obj = logprobs_obj(
                tok, lp_list, lp_ids, tops, top_n,
                prompt_positions=len(prompt_ids) if prompt_lps is not None else 0,
            )
        choice: dict[str, Any] = {"text": text_val, "index": i, "finish_reason": finish,
                                  "logprobs": lp_obj}
        if tok is None:
            choice["tokens"] = (prompt_ids + out) if echo else out
        choices.append(choice)
    return Raw({
        "id": cmpl_id,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": choices,
        "usage": {
            "prompt_tokens": len(prompt_ids),
            "completion_tokens": generated,
            "total_tokens": len(prompt_ids) + generated,
        },
    })
