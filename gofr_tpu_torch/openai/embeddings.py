"""``POST /v1/embeddings`` over the encoder models and ``GET /v1/models``
(the served base model, then every loaded LoRA adapter: a request's
``model`` naming one selects it). Port of ``gofr_tpu/openai/embeddings.py``;
unlike the JAX handler, an embeddings request is a flight record too
(``/admin/requests`` endpoint ``/v1/embeddings``: its prefill dispatches and
cohort, no tokens out)."""

from __future__ import annotations

import asyncio
from typing import Any

import numpy as np

from gofr_tpu_torch.errors import HTTPError
from gofr_tpu_torch.http.response import Raw
from gofr_tpu_torch.openai.parse import bind_identity
from gofr_tpu_torch.telemetry import flight


async def embeddings(ctx: Any) -> Any:
    """The OpenAI embeddings shape over an encoder model (``MODEL_NAME=
    bert-*``). ``input`` is a string, a list of strings, an id list or a
    list of id lists; the items go through the dynamic batcher at once, so
    a multi-item request packs into one dispatch."""
    if ctx.tpu is None:
        raise HTTPError(503, "tpu not configured (set MODEL_NAME)")
    if not ctx.tpu.model_name.startswith("bert"):
        # before any inference: a decoder deployment answers 400 for free
        raise HTTPError(
            400,
            "embeddings need an encoder model (MODEL_NAME=bert-tiny or "
            f"bert-base); '{ctx.tpu.model_name}' is a decoder",
        )
    body = ctx.bind() if ctx.request.body else {}
    if not isinstance(body, dict):
        raise HTTPError(400, "request body must be a JSON object")
    raw = body.get("input")
    if isinstance(raw, str) or (
        isinstance(raw, list) and raw and all(isinstance(t, int) for t in raw)
    ):
        items = [raw]
    elif isinstance(raw, list) and raw:
        items = raw
    else:
        raise HTTPError(400, '"input" must be a string, list of strings, or token-id list(s)')
    tok = ctx.tpu.tokenizer
    # the encoder pads to one bucket: an item over it is a 400 (OpenAI's
    # behaviour), never a truncated embedding with the full count in usage
    ctx.tpu.wait_ready(60.0)
    bucket = getattr(ctx.tpu.runner, "bucket", None)

    def tokenize_items() -> tuple[int, list]:
        """The tokenizer over possibly many strings, in the executor: the
        event loop only enqueues."""
        n = 0
        payloads = []
        for item in items:
            if isinstance(item, str):
                if tok is None:
                    raise HTTPError(400, "string input needs a tokenizer (set TOKENIZER_PATH)")
                ids = tok.encode(item)
            elif isinstance(item, list) and item and all(isinstance(t, int) for t in item):
                ids = item
            else:
                raise HTTPError(400, f"invalid input item: {item!r:.80}")
            if not ids:
                raise HTTPError(400, "input item encoded to zero tokens")
            if bucket is not None and len(ids) > bucket:
                raise HTTPError(
                    400, f"input item is {len(ids)} tokens; this encoder accepts at most {bucket}"
                )
            n += len(ids)
            payloads.append({"tokens": ids})
        return n, payloads

    loop = asyncio.get_running_loop()
    n_tokens, payloads = await loop.run_in_executor(None, tokenize_items)
    bind_identity(ctx)
    with flight(ctx.container.telemetry, model=ctx.tpu.model_name, endpoint="/v1/embeddings",
                trace_id=ctx.trace_id or "", tokens_in=n_tokens):
        results = await asyncio.gather(*(ctx.tpu.infer_async(p) for p in payloads))

    def to_rows() -> list:
        return [{"object": "embedding", "index": i,
                 "embedding": np.asarray(out).reshape(-1).tolist()}
                for i, out in enumerate(results)]

    data = await loop.run_in_executor(None, to_rows)
    return Raw({
        "object": "list",
        "model": ctx.tpu.model_name,
        "data": data,
        "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
    })


def list_models(ctx: Any) -> Any:
    if ctx.tpu is None:
        raise HTTPError(503, "no model configured (set MODEL_NAME)")
    entries = [{"id": ctx.tpu.model_name, "object": "model", "owned_by": "gofr_tpu"}]
    # a snapshot read without waiting for the device: discovery answers at once
    adapters = getattr(getattr(ctx.tpu, "runner", None), "adapters", None) or {}
    for name in sorted(adapters):
        entries.append({"id": name, "object": "model", "owned_by": "gofr_tpu",
                        "root": ctx.tpu.model_name})  # the base it adapts
    return Raw({"object": "list", "data": entries})
