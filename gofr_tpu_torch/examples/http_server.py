"""The HTTP serving example (copy of ``examples/http-server/main.py``):
hello, error, redis, mysql and trace routes with a registered downstream
service (``anotherService``, this same app), and, when ``MODEL_NAME`` is
set, ``/infer``, ``/generate`` (``?stream=true`` streams over SSE) and the
OpenAI routes over the device.

    MODEL_NAME=tiny TORCH_DEVICE=cpu python -m gofr_tpu_torch.examples.http_server
"""

import os

import gofr_tpu_torch
from gofr_tpu_torch.errors import HTTPError
from gofr_tpu_torch.examples import CONFIGS


def hello(ctx):
    name = ctx.param("name")
    return f"Hello {name}!" if name else "Hello World!"


def error_route(ctx):
    raise HTTPError(500, "some error occurred")


def redis_handler(ctx):
    if ctx.redis is None:
        raise HTTPError(503, "redis not configured")
    return ctx.redis.get("test")


def mysql_handler(ctx):
    if ctx.db is None:
        raise HTTPError(503, "sql not configured")
    return ctx.db.select_value("SELECT 2+2")


def trace_handler(ctx):
    with ctx.trace("some-sample-work"):
        pass
    svc = ctx.get_http_service("anotherService")
    if svc is not None:
        svc.get("redis")
    return "ok"


async def infer_handler(ctx):
    """Dynamic-batched forward pass (north star: GET/POST /infer)."""
    if ctx.tpu is None:
        raise HTTPError(503, "tpu not configured (set MODEL_NAME)")
    payload = ctx.bind() if ctx.request.body else {"x": [0.0] * 64}
    if not isinstance(payload, dict):
        raise HTTPError(400, 'request body must be a JSON object like {"tokens": [...]}')
    data = payload.get("x") or payload.get("tokens")
    if not data:
        raise HTTPError(400, 'missing "x" (features) or "tokens" (ids) in body')
    result = await ctx.tpu.infer_async(data)
    import numpy as np

    if isinstance(result, dict):  # transformer prefill state -> next token
        return {"next_token": result["next_token"]}
    return {"y": np.asarray(result).tolist()}


def generate_handler(ctx):
    """Greedy generation; ?stream=true streams tokens over SSE. Accepts
    {"tokens": [...]} or, with a tokenizer configured, {"text": "..."}."""
    if ctx.tpu is None:
        raise HTTPError(503, "tpu not configured (set MODEL_NAME)")
    body = ctx.bind() if ctx.request.body else {}
    if not isinstance(body, dict):
        raise HTTPError(400, 'request body must be a JSON object like {"tokens": [...]}')
    tokens = _prompt_from(body)
    max_new = int(body.get("max_new_tokens") or 16)
    sampler = _sampler_from(body)
    stop_tokens = _stop_tokens_from(body)
    adapter = body.get("adapter")  # multi-LoRA: named adapter selection
    if adapter is not None and not isinstance(adapter, str):
        raise HTTPError(400, '"adapter" must be a string')
    want_logprobs = bool(body.get("logprobs"))
    tok = ctx.tpu.tokenizer
    if ctx.param("stream") == "true":
        from gofr_tpu_torch.http.response import Stream

        # called OUTSIDE events(): parameter validation (e.g. an unknown
        # adapter) must 400 before the SSE response commits its 200
        stream_iter = ctx.tpu.generate_stream(
            tokens, max_new, sampler=sampler, stop_tokens=stop_tokens,
            adapter=adapter, logprobs=want_logprobs,
        )

        def events():
            # incremental decode: multi-byte UTF-8 split across tokens
            # buffers until the character completes
            dec = tok.stream_decoder() if tok is not None else None
            try:
                for item in stream_iter:
                    # with logprobs, items are (token, logprob) pairs
                    token, lp = item if want_logprobs else (item, None)
                    event = {"token": token}
                    if lp is not None:
                        event["logprob"] = lp
                    if dec is not None:
                        event["text"] = dec.feed(token)
                    yield event
                if dec is not None:
                    tail = dec.flush()  # bytes still buffered at stream end
                    if tail:
                        yield {"text": tail}
            except Exception as exc:  # surfaced as an SSE error event
                yield {"error": str(exc)}

        return Stream(events())
    out = ctx.tpu.generate(
        tokens, max_new, sampler=sampler, stop_tokens=stop_tokens,
        adapter=adapter, logprobs=want_logprobs,
    )
    if want_logprobs:
        out, logprobs = out
    result = {"tokens": out}
    if want_logprobs:
        result["logprobs"] = logprobs
    if tok is not None:
        result["text"] = tok.decode(out)
    return result


def _stop_tokens_from(body):
    from gofr_tpu_torch.ops.sampling import stop_tokens_from_body

    try:
        return stop_tokens_from_body(body)
    except ValueError as exc:
        raise HTTPError(400, str(exc))


def _sampler_from(body):
    """Sampling params from the request body: temperature (default 0 =
    greedy), top_k, top_p, seed."""
    from gofr_tpu_torch.ops.sampling import Sampler

    try:
        return Sampler.from_body(body)
    except (TypeError, ValueError) as exc:
        raise HTTPError(400, f"invalid sampling params: {exc}")


def _prompt_from(body):
    """Prompt from "text" (non-empty str) or "tokens" (non-empty list);
    explicit-but-empty values are a 400, absent values fall back to the
    demo prompt."""
    if "text" in body:
        text = body["text"]
        if not isinstance(text, str) or not text:
            raise HTTPError(400, '"text" must be a non-empty string')
        return text
    if "tokens" in body:
        tokens = body["tokens"]
        if not isinstance(tokens, list) or not tokens:
            raise HTTPError(400, '"tokens" must be a non-empty list of ids')
        return tokens
    return [1, 2, 3]  # demo prompt


def build(model=None):
    """The app with every route registered, not started (``model``: weights
    to serve instead of ``MODEL_PATH`` or the seeded init)."""
    app = gofr_tpu_torch.new(configs_dir=os.path.join(CONFIGS, "http_server"), model=model)
    app.add_http_service("anotherService", f"http://localhost:{app.http_port}")
    app.get("/hello", hello)
    app.get("/error", error_route)
    app.get("/redis", redis_handler)
    app.get("/mysql", mysql_handler)
    app.get("/trace", trace_handler)
    app.post("/infer", infer_handler)
    app.post("/generate", generate_handler)
    # OpenAI-compatible surface (/v1/completions, /v1/models): clients
    # speaking the de-facto completions protocol hit the same datasource
    from gofr_tpu_torch.openai import register_openai_routes

    register_openai_routes(app)
    return app


def main():
    build().run()


if __name__ == "__main__":
    main()
