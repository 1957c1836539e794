"""``GET /v1/models`` (the ``list_models`` of ``gofr_tpu/openai/
embeddings.py``): the served base model. ``/v1/embeddings`` waits for the
encoder models; LoRA adapters, which the JAX package lists beside the base
model, for the LoRA slice."""

from __future__ import annotations

from typing import Any

from gofr_tpu_torch.errors import HTTPError
from gofr_tpu_torch.http.response import Raw


def list_models(ctx: Any) -> Any:
    if ctx.tpu is None:
        raise HTTPError(503, "no model configured (set MODEL_NAME)")
    return Raw({"object": "list", "data": [
        {"id": ctx.tpu.model_name, "object": "model", "owned_by": "gofr_tpu"},
    ]})
