"""Back-compat shim (port of ``gofr_tpu/openai_compat.py``): the OpenAI
surface lives in the ``gofr_tpu_torch.openai`` package; code written
against the JAX package's single module imports the same names from here.
The port's helpers dropped the leading underscore, so the private names
the JAX shim re-exports map onto them; new code imports from
``gofr_tpu_torch.openai``.
"""

from __future__ import annotations

from gofr_tpu_torch.openai import (  # noqa: F401
    chat_completions,
    completions,
    embeddings,
    list_models,
    register_openai_routes,
    render_chat_prompt,
)
from gofr_tpu_torch.openai.fanout import consume_stream as _consume_stream  # noqa: F401
from gofr_tpu_torch.openai.fanout import fanout_generate as _fanout_generate  # noqa: F401
from gofr_tpu_torch.openai.logprobs import (  # noqa: F401
    chat_logprobs_obj as _chat_logprobs_obj,
)
from gofr_tpu_torch.openai.logprobs import chat_lp_entry as _chat_lp_entry  # noqa: F401
from gofr_tpu_torch.openai.logprobs import logprobs_obj as _logprobs_obj  # noqa: F401
from gofr_tpu_torch.openai.parse import FANOUT_CAP as _FANOUT_CAP  # noqa: F401
from gofr_tpu_torch.openai.parse import StopScanner as _StopScanner  # noqa: F401
from gofr_tpu_torch.openai.parse import parse_fanout as _parse_fanout  # noqa: F401
from gofr_tpu_torch.openai.parse import parse_request as _parse_request  # noqa: F401
from gofr_tpu_torch.openai.parse import parse_stops as _parse_stops  # noqa: F401
from gofr_tpu_torch.openai.parse import prompt_tokens as _prompt_tokens  # noqa: F401
from gofr_tpu_torch.openai.parse import sampler_from_body as _sampler  # noqa: F401
from gofr_tpu_torch.openai.template import (  # noqa: F401
    DEFAULT_CHAT_TEMPLATE,
    _chat_template,
    _compiled_jinja,
    _jinja_template_source,
    _render_jinja,
    _resolve_jinja_source,
)

__all__ = [
    "register_openai_routes",
    "completions",
    "chat_completions",
    "embeddings",
    "list_models",
    "render_chat_prompt",
    "DEFAULT_CHAT_TEMPLATE",
]
