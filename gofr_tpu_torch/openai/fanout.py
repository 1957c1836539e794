"""Generation fan-out (port of ``gofr_tpu/openai/fanout.py``): the streaming
consumer with host-side stop matching, n/best_of candidate generation with
mean-logprob ranking, and the interleaved multi-index SSE driver both
endpoints share. Every path passes the request's LoRA ``adapter`` (None:
the base model) to the device."""

from __future__ import annotations

import contextvars
import json
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from gofr_tpu_torch.errors import HTTPError
from gofr_tpu_torch.openai.parse import StopScanner, sampler_from_body

STREAM_END = object()  # per-index end marker on the multiplex queue


class LinkedCancel:
    """Event-like stop for ONE fan-out candidate: set when the shared
    client-abort event or this candidate's own teardown tripped. ``set()``
    marks the local side only: a finished candidate's generator close must
    never cancel its siblings, while a client abort cancels them all. The
    decode paths only ever call ``is_set()``."""

    __slots__ = ("_shared", "_local")

    def __init__(self, shared: Any):
        self._shared = shared
        self._local = threading.Event()

    def set(self) -> None:
        self._local.set()

    def is_set(self) -> bool:
        return self._local.is_set() or (self._shared is not None and self._shared.is_set())


def candidate_samplers(body: dict, count: int) -> list:
    """Per-candidate samplers, seed + index for a seeded request: the
    reproducibility contract the stream and non-stream fan-outs share."""
    seed = body.get("seed")
    if seed is not None:
        try:
            seed = int(seed)
        except (TypeError, ValueError):
            raise HTTPError(400, '"seed" must be an integer') from None
    return [
        sampler_from_body({**body, "seed": seed + i} if seed is not None else body)
        for i in range(count)
    ]


def fanout_workers_override(ctx: Any) -> Any:
    """OPENAI_FANOUT_WORKERS, validated (None when unset): the operator's
    fan-out concurrency bound, obeyed in both directions."""
    raw = ctx.config.get_or_default("OPENAI_FANOUT_WORKERS", "")
    if not raw:
        return None
    try:
        return max(1, int(raw))
    except ValueError:
        raise HTTPError(500, "OPENAI_FANOUT_WORKERS must be an integer") from None


def fanout_workers(ctx: Any, default_slots: int = 4) -> int:
    """Candidates generated at once: about 3/4 of the decode pool's slots
    (one wide request must not take every slot, nor spawn that many solo
    seeded decodes); OPENAI_FANOUT_WORKERS overrides."""
    override = fanout_workers_override(ctx)
    if override is not None:
        return override
    slots = getattr(ctx.tpu.decode_pool, "n_slots", None) or default_slots
    return max(1, (slots * 3) // 4 or 1)


def stream_candidates(
    ctx: Any, body: dict, prompt_ids: list, max_tokens: int, sampler: Any, stop_ids: Any,
    want_logprobs: bool, n: int, cancel: Any = None, adapter: Any = None,
) -> list:
    """The n candidate stream iterators of an interleaved SSE response,
    built before the 200 commits (a parameter error must 400 first). Every
    index must progress, so candidates cannot serialize: n above the
    pool's slot count (or OPENAI_FANOUT_WORKERS) is a 400. The caller owns
    closing every iterator."""
    if n == 1:
        return [ctx.tpu.generate_stream(
            prompt_ids, max_tokens, sampler=sampler, stop_tokens=stop_ids,
            cancel=cancel, logprobs=want_logprobs, adapter=adapter,
        )]
    override = fanout_workers_override(ctx)
    bound = override if override is not None else (
        getattr(ctx.tpu.decode_pool, "n_slots", None) or 4
    )
    if n > bound:
        raise HTTPError(
            400, f'"n" is capped at {bound} when streaming on this deployment (candidates '
            "stream concurrently and cannot be serialized; raise DECODE_SLOTS or "
            "OPENAI_FANOUT_WORKERS)"
        )
    iters = []
    try:
        for s in candidate_samplers(body, n):
            # a client abort frees every candidate's slot; one candidate
            # finishing first must not cancel the rest
            iters.append(ctx.tpu.generate_stream(
                prompt_ids, max_tokens, sampler=s, stop_tokens=stop_ids,
                cancel=LinkedCancel(cancel), logprobs=want_logprobs, adapter=adapter,
            ))
    except BaseException:
        for it in iters:  # a late candidate failing frees the early ones
            it.close()
        raise
    return iters


def usage_chunk(object_name: str, resp_id: str, created: int, model: str,
                prompt_tokens: int, completion_tokens: int) -> str:
    """The ONE pre-[DONE] usage frame both endpoints emit under
    stream_options.include_usage: empty choices and the usage object."""
    return json.dumps({
        "id": resp_id, "object": object_name, "created": created, "model": model,
        "choices": [],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        },
    })


def error_frame(exc: BaseException) -> str:
    """The one frame a stream that failed after its 200 ends with."""
    return json.dumps({"error": {"message": str(exc)}})


def index_feed_text(dec: Any, scan: Any, finish: list, i: int, emitted: list,
                    token: int) -> tuple:
    """Decode one token of candidate ``i`` through its stop scanner.
    Returns (text or None, stopped): None means an id-only deployment (the
    caller emits the tokens extension); stopped means the stop matched
    (finish set; the text is what came before it)."""
    emitted[i] += 1
    if dec is None:
        return None, False
    text = dec.feed(token)
    if scan is not None:
        text, done = scan.feed(text)
        if done:
            finish[i] = "stop"
            return text, True
    return text, False


def index_tail_text(dec: Any, scan: Any, finish: list, i: int, emitted: list,
                    max_tokens: int) -> str:
    """Flush candidate ``i``'s decoder through its stop scanner and settle
    its finish reason. Returns the tail text ('' when already finished)."""
    t = dec.flush() if dec is not None else ""
    if finish[i] is not None:
        return ""
    if scan is not None:
        t, done = scan.feed(t)
        if done:
            finish[i] = "stop"
        else:
            t += scan.flush()
    if finish[i] is None:
        finish[i] = "length" if emitted[i] >= max_tokens else "stop"
    return t


def drive_stream_fanout(
    iters: list, replicate: bool, n: int, finish: list, want_logprobs: bool,
    open_frames: Any, feed: Any, tail: Any, usage_frames: Any = None,
) -> Any:
    """The interleaved-SSE driver both endpoints share: replicate mode
    consumes one iterator and fans its frames across the indexes (greedy
    requests); multiplex mode merges n pump threads. ``feed`` and ``tail``
    update ``finish``; once an index is finished (a stop matched) its
    decode is cancelled and anything more it produces, an error of the
    cancellation included, is dropped. An error of an unfinished index
    ends the whole stream with one error frame (a committed 200 cannot be
    re-statused)."""
    cancels: list = []
    try:
        yield from open_frames()
        if replicate:
            for item in iters[0]:
                token, lp = item if want_logprobs else (item, None)
                for i in range(n):
                    if finish[i] is None:
                        yield from feed(i, token, lp)
                if all(f is not None for f in finish):
                    break
            for i in range(n):
                yield from tail(i)
        else:
            q, cancels_ = multiplex(iters)
            cancels.extend(cancels_)
            active = n
            while active:
                i, item = q.get()
                if item is STREAM_END:
                    active -= 1
                    yield from tail(i)
                    continue
                if finish[i] is not None:
                    continue  # stop-matched: drop tokens and late errors
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "error":
                    raise item[1]
                token, lp = item if want_logprobs else (item, None)
                yield from feed(i, token, lp)
                if finish[i] is not None:
                    cancels[i].set()  # stop matched: free its decode early
        if usage_frames is not None:
            yield from usage_frames()
        yield "[DONE]"
    except Exception as exc:
        yield error_frame(exc)
    finally:
        if replicate:
            iters[0].close()  # driven by this thread: legal
        else:
            for ev in cancels:
                ev.set()  # the pump threads close their own iterators


def multiplex(iters: list) -> tuple:
    """Merge n token iterators into ONE queue of (index, item) pairs; each
    stream's end posts (index, STREAM_END), an error (index, ("error",
    exc)) then STREAM_END. Returns (queue, cancels): the pump thread owns
    its iterator (a generator cannot be closed from another thread while it
    runs), so the consumer cancels index i by setting cancels[i]."""
    out: "queue.Queue" = queue.Queue()
    cancels = [threading.Event() for _ in iters]

    def pump(i: int, it: Any) -> None:
        try:
            for item in it:
                if cancels[i].is_set():
                    break
                out.put((i, item))
        except Exception as exc:  # surfaced as an SSE error frame
            out.put((i, ("error", exc)))
        finally:
            # STREAM_END posts even if close() raises: a lost sentinel would
            # wedge the consumer in q.get() for ever
            try:
                it.close()
            except Exception:
                pass  # the index already ended; nothing left to deliver
            finally:
                out.put((i, STREAM_END))

    for i, it in enumerate(iters):
        threading.Thread(target=pump, args=(i, it), daemon=True,
                         name=f"gofr-sse-fanout-{i}").start()
    return out, cancels


def consume_stream(
    ctx: Any, prompt_ids: list, max_tokens: int, sampler: Any, stop_ids: Any,
    stop_strs: list, need_lp: bool, adapter: Any = None,
) -> tuple[list, Any, str, str]:
    """Generate through the streaming bridge, matching stop strings on the
    host and cancelling the decode at the first match (closing the
    iterator frees the pool slot). Returns (tokens, logprobs or None, text
    cut before the stop, finish_reason); tokens cover everything generated
    (usage), logprobs the tokens whose text starts before the match."""
    tok = ctx.tpu.tokenizer  # parse_stops guarantees one for stop strings
    dec = tok.stream_decoder()
    scan = StopScanner(stop_strs)
    it = ctx.tpu.generate_stream(
        prompt_ids, max_tokens, sampler=sampler, stop_tokens=stop_ids, logprobs=need_lp,
        adapter=adapter,
    )
    toks: list = []
    lps: list = []
    parts: list = []
    starts: list = []  # where each token's text began in the decoded text
    decoded = 0
    finish = None
    try:
        for item in it:
            t, lp = item if need_lp else (item, None)
            toks.append(t)
            if lp is not None:
                lps.append(lp)
            piece = dec.feed(t)
            starts.append(decoded)
            decoded += len(piece)
            emit, done = scan.feed(piece)
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
    if need_lp and scan.match_pos is not None:
        lps = lps[: sum(1 for s in starts if s < scan.match_pos)]
    return toks, (lps if need_lp else None), "".join(parts), finish


def fanout_generate(
    ctx: Any, body: dict, prompt_ids: list, max_tokens: int, sampler: Any, stop_ids: Any,
    stop_strs: list, want_logprobs: bool, top_n: int, n: int, best_of: int,
    adapter: Any = None,
) -> tuple[list, int]:
    """Generate ``best_of`` candidates and keep the ``n`` best. Returns
    ([(tokens, logprobs or None, tops or None, text or None, finish or
    None)] * n, the tokens generated by ALL candidates: usage bills the
    discarded best_of candidates too, as OpenAI does). ``text`` and
    ``finish`` are set on the stop-string path only.

    - Greedy requests give identical candidates: ONE generation is
      replicated, and billed once per replica.
    - Sampled candidates run concurrently (``fanout_workers`` at once):
      unseeded ones decode together in the pool; a seeded request derives
      seed + index per candidate and decodes solo.
    - best_of > n ranks by mean token logprob (generated with logprobs,
      stripped from the response unless asked for)."""
    score = best_of > n
    need_lp = want_logprobs or score

    def one(s: Any) -> tuple:
        if stop_strs:
            toks, lps, text, finish = consume_stream(
                ctx, prompt_ids, max_tokens, s, stop_ids, stop_strs, need_lp, adapter,
            )
            return toks, lps, None, text, finish
        if top_n:
            toks, lps, tops = ctx.tpu.generate(
                prompt_ids, max_tokens, sampler=s, stop_tokens=stop_ids, logprobs=True,
                top_logprobs=True, adapter=adapter,
            )
            return toks, lps, tops, None, None
        out = ctx.tpu.generate(
            prompt_ids, max_tokens, sampler=s, stop_tokens=stop_ids, logprobs=need_lp,
            adapter=adapter,
        )
        toks, lps = out if need_lp else (out, None)
        return toks, lps, None, None, None

    if sampler.greedy:
        toks, lps, tops, text, finish = one(sampler)
        if not want_logprobs:
            lps = None
        return [(toks, lps, tops, text, finish)] * n, len(toks) * n

    samplers = candidate_samplers(body, best_of)
    if best_of == 1:
        results = [one(samplers[0])]
    else:
        # candidates past the bound serialize through map; one context copy
        # each, taken here in the handler thread
        snapshots = [contextvars.copy_context() for _ in samplers]
        with ThreadPoolExecutor(max_workers=min(best_of, fanout_workers(ctx))) as pool:
            results = list(pool.map(lambda pair: pair[0].run(one, pair[1]),
                                    zip(snapshots, samplers)))
    generated = sum(len(r[0]) for r in results)
    if score:
        def mean_lp(item: tuple) -> float:
            lps = item[1]
            return sum(lps) / len(lps) if lps else float("-inf")

        results = sorted(results, key=mean_lp, reverse=True)[:n]
    if not want_logprobs:
        results = [(toks, None, tops, text, finish) for toks, _, tops, text, finish in results]
    return results, generated
