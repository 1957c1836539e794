"""The gRPC serving example (copy of ``examples/grpc-server/main.py``): a
Hello service registered both ways, through the generated stubs
(``app.register_service`` with ``pb/hello_pb2*``) and as a JSON service
(``HelloService/SayHello``), and ``LLMService`` with the unary ``Embed``
and the server-streaming ``Generate`` over the device. It listens on
``GRPC_PORT`` (9000) beside HTTP on ``HTTP_PORT`` (8001).

    MODEL_NAME=tiny TORCH_DEVICE=cpu python -m gofr_tpu_torch.examples.grpc_server
"""

import os

import gofr_tpu_torch
from gofr_tpu_torch.examples import CONFIGS
from gofr_tpu_torch.examples.pb import hello_pb2, hello_pb2_grpc


class HelloServicer(hello_pb2_grpc.HelloServicer):
    """The generated-stub Hello service."""

    def SayHello(self, request, context):
        name = request.name or "World"
        return hello_pb2.HelloResponse(message=f"Hello {name}!")


def say_hello(ctx):
    name = ctx.param("name") or "World"
    return f"Hello {name}!"


def _model_body(ctx):
    from gofr_tpu_torch.errors import HTTPError

    if ctx.tpu is None:
        raise HTTPError(503, "tpu not configured (set MODEL_NAME)")
    body = ctx.bind()
    if body is not None and not isinstance(body, dict):
        raise HTTPError(400, 'request body must be a JSON object like {"tokens": [...]}')
    return body or {}


def _prompt_from(body):
    from gofr_tpu_torch.errors import HTTPError

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
    return None


def embed(ctx):
    """Unary model RPC (an encoder's embedding, a decoder's next token). Accepts
    {"tokens": [...]} or, with a tokenizer configured, {"text": "..."}."""
    body = _model_body(ctx)
    prompt = _prompt_from(body)
    if prompt is None:
        from gofr_tpu_torch.errors import HTTPError

        raise HTTPError(400, 'missing "tokens" or "text" in body')
    out = ctx.tpu.infer(body if isinstance(prompt, list) else {"text": prompt})
    import numpy as np

    if isinstance(out, dict):  # transformer prefill state
        return {"next_token": out["next_token"]}
    return {"embedding": np.asarray(out).tolist()}


def generate_stream(ctx):
    """Server-streaming token decode: one JSON message per token."""
    body = _model_body(ctx)
    tokens = _prompt_from(body)
    if tokens is None:
        tokens = [1, 2, 3]  # demo prompt
    max_new = int(body.get("max_new_tokens") or 16)
    from gofr_tpu_torch.errors import HTTPError
    from gofr_tpu_torch.ops.sampling import Sampler

    try:
        sampler = Sampler.from_body(body)
    except (TypeError, ValueError) as exc:
        raise HTTPError(400, f"invalid sampling params: {exc}")
    from gofr_tpu_torch.ops.sampling import stop_tokens_from_body

    try:
        stop_tokens = stop_tokens_from_body(body)
    except ValueError as exc:
        raise HTTPError(400, str(exc))
    adapter = body.get("adapter")  # multi-LoRA: named adapter selection
    if adapter is not None and not isinstance(adapter, str):
        raise HTTPError(400, '"adapter" must be a string')
    want_logprobs = bool(body.get("logprobs"))
    tok = ctx.tpu.tokenizer
    dec = tok.stream_decoder() if tok is not None else None
    for item in ctx.tpu.generate_stream(
        tokens, max_new, sampler=sampler, stop_tokens=stop_tokens,
        adapter=adapter, logprobs=want_logprobs,
    ):
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


def build(model=None):
    """The app with both Hello registrations and LLMService, not started
    (``model``: weights to serve instead of ``MODEL_PATH`` or the seeded
    init)."""
    app = gofr_tpu_torch.new(configs_dir=os.path.join(CONFIGS, "grpc_server"), model=model)
    # generated-stub registration
    app.register_service(
        hello_pb2_grpc.add_HelloServicer_to_server, HelloServicer()
    )
    app.register_json_service(
        "HelloService",
        {"SayHello": say_hello},
    )
    app.register_json_service(
        "LLMService",
        {"Embed": embed},
        stream_methods={"Generate": generate_stream},
    )
    return app


def main():
    build().run()


if __name__ == "__main__":
    main()
