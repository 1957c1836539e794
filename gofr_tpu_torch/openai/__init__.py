"""OpenAI-compatible ``POST /v1/completions`` over the inference device
(port of ``gofr_tpu/openai/``; chat, embeddings and models wait for a
later slice)."""

from __future__ import annotations

from typing import Any

from gofr_tpu_torch.openai.completions import completions

__all__ = ["register_openai_routes", "completions"]


def register_openai_routes(app: Any) -> None:
    app.post("/v1/completions", completions)
