"""``GET /v1/models`` (the ``list_models`` of ``gofr_tpu/openai/
embeddings.py``): the served base model, then every loaded LoRA adapter
(a request's ``model`` naming one selects it). ``/v1/embeddings`` waits
for the encoder models."""

from __future__ import annotations

from typing import Any

from gofr_tpu_torch.errors import HTTPError
from gofr_tpu_torch.http.response import Raw


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
