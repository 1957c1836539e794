"""OpenAI-compatible routes over the inference device (port of
``gofr_tpu/openai/``). ``register_openai_routes(app)`` adds:

- ``POST /v1/completions``: prompt in, text out; ``"stream": true``
  switches to SSE frames ending in ``data: [DONE]``; logprobs and
  top-logprobs, echo (with teacher-forced prompt scoring), n/best_of;
- ``POST /v1/chat/completions``: messages in, assistant message out,
  through the chat template (``openai/template.py``);
- ``POST /v1/embeddings``: an encoder model's (``MODEL_NAME=bert-*``)
  sentence embeddings; a multi-item input packs into one batcher dispatch;
- ``GET /v1/models``: the served model and its loaded LoRA adapters.

Modules: ``parse`` (request knobs, stops, fan-out constraints),
``template`` (chat prompts), ``logprobs`` (response logprob objects),
``fanout`` (candidate generation and the multi-index SSE driver),
``completions``, ``chat`` and ``embeddings`` (the endpoints). Both
completion endpoints take the repetition/presence/frequency penalties and
``logit_bias`` and a LoRA adapter (``adapter``, or ``model`` naming a
loaded one).
"""

from __future__ import annotations

from typing import Any

from gofr_tpu_torch.openai.chat import chat_completions
from gofr_tpu_torch.openai.completions import completions
from gofr_tpu_torch.openai.embeddings import embeddings, list_models
from gofr_tpu_torch.openai.template import render_chat_prompt

__all__ = [
    "register_openai_routes", "completions", "chat_completions", "embeddings", "list_models",
    "render_chat_prompt",
]


def register_openai_routes(app: Any) -> None:
    app.post("/v1/completions", completions)
    app.post("/v1/chat/completions", chat_completions)
    app.post("/v1/embeddings", embeddings)
    app.get("/v1/models", list_models)
