"""Chat prompt construction (copy of ``gofr_tpu/openai/template.py``): the
simple {role}/{content} ``CHAT_TEMPLATE`` form with its assistant-turn
opener, and jinja templates (``CHAT_TEMPLATE_JINJA``, or the checkpoint's
own ``tokenizer_config.json`` chat_template next to ``TOKENIZER_PATH``)."""

from __future__ import annotations

import functools
import json
import os
from typing import Any

from gofr_tpu_torch.errors import HTTPError

DEFAULT_CHAT_TEMPLATE = "[{role}]: {content}\n"

_SENTINEL = "\x00GOFR_CONTENT\x00"


def _chat_template(ctx: Any) -> tuple[str, str]:
    """(template, assistant opener), both validated: a broken operator
    template is a clear error, not a per-request 500 from str.format. The
    opener is everything the template renders BEFORE the content slot for
    role=assistant; CHAT_TEMPLATE_OPENER overrides it."""
    template = ctx.config.get_or_default("CHAT_TEMPLATE", DEFAULT_CHAT_TEMPLATE)
    try:
        probe = template.format(role="assistant", content=_SENTINEL)
    except (KeyError, IndexError, ValueError) as exc:
        raise HTTPError(
            500, f"CHAT_TEMPLATE is invalid ({exc!r}) — it must use only {{role}} and "
            "{content} placeholders",
        ) from None
    if _SENTINEL not in probe:
        raise HTTPError(500, "CHAT_TEMPLATE must contain a {content} placeholder")
    opener = ctx.config.get_or_default("CHAT_TEMPLATE_OPENER", probe.split(_SENTINEL)[0])
    return template, opener


def _jinja_template_source(ctx: Any) -> Any:
    """The jinja chat template, or None for the simple form. Precedence:
    CHAT_TEMPLATE_JINJA (a file path or the template itself) > an explicit
    CHAT_TEMPLATE or CHAT_TEMPLATE_OPENER (the operator chose the simple
    form) > the tokenizer_config.json chat_template next to TOKENIZER_PATH
    (a real instruct checkpoint served through the wrong template silently
    degrades)."""
    return _resolve_jinja_source(
        ctx.config.get("CHAT_TEMPLATE_JINJA") or "",
        bool(ctx.config.get("CHAT_TEMPLATE")) or bool(ctx.config.get("CHAT_TEMPLATE_OPENER")),
        ctx.config.get("TOKENIZER_PATH") or "",
    )


@functools.lru_cache(maxsize=8)
def _resolve_jinja_source(explicit: str, simple_form: bool, tok_path: str) -> Any:
    """Cached: config is static per process, and the file reads must not
    run on every chat request."""
    if explicit:
        if os.path.isfile(explicit):
            with open(explicit, encoding="utf-8") as fh:
                return fh.read()
        return explicit
    if simple_form or not tok_path.endswith(".json"):
        return None
    cfg_path = os.path.join(os.path.dirname(tok_path), "tokenizer_config.json")
    if not os.path.isfile(cfg_path):
        return None
    try:
        with open(cfg_path, encoding="utf-8") as fh:
            template = json.load(fh).get("chat_template")
    except (OSError, ValueError) as exc:
        # a corrupt sidecar silently falling back to the generic template is
        # the degradation this discovery exists to prevent
        raise HTTPError(
            500, f"cannot read {cfg_path}: {exc} — fix the checkpoint or set CHAT_TEMPLATE "
            "explicitly"
        ) from None
    if template is None:
        return None
    if isinstance(template, str):
        return template
    if isinstance(template, list):
        # HF multi-template form: only an entry NAMED "default" is safe to adopt
        for entry in template:
            if (isinstance(entry, dict) and entry.get("name") == "default"
                    and isinstance(entry.get("template"), str)):
                return entry["template"]
    raise HTTPError(
        500, f"unrecognized chat_template form in {cfg_path} — set CHAT_TEMPLATE or "
        "CHAT_TEMPLATE_JINJA explicitly"
    )


@functools.lru_cache(maxsize=8)
def _compiled_jinja(source: str) -> Any:
    """Compiled once per template source, in an immutable sandboxed
    environment (the HF convention: checkpoint templates are data, not
    trusted code)."""
    try:
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError:
        raise HTTPError(
            500, "jinja chat templates need the jinja2 package — or set CHAT_TEMPLATE to "
            "use the simple template form"
        ) from None

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)

    def raise_exception(message: str) -> None:
        from jinja2.exceptions import TemplateError

        raise TemplateError(message)

    env.globals["raise_exception"] = raise_exception
    return env.from_string(source)


def _render_jinja(ctx: Any, source: str, messages: list) -> str:
    from jinja2.exceptions import TemplateError

    tok = ctx.tpu.tokenizer if ctx.tpu is not None else None
    specials = {"bos_token": "", "eos_token": ""}
    if tok is not None:
        for content, ext_id in tok._token_ids.items():
            for name in ("bos", "eos"):
                if tok._special_ids.get(name) == ext_id:
                    specials[f"{name}_token"] = content
    try:
        return _compiled_jinja(source).render(
            messages=messages, add_generation_prompt=True, **specials
        )
    except TemplateError as exc:
        raise HTTPError(500, f"chat template failed to render: {exc}") from None


def render_chat_prompt(ctx: Any, messages: Any) -> str:
    """Messages -> prompt text: a jinja template with the HF conventions
    (``messages``, ``add_generation_prompt``, ``bos_token``/``eos_token``,
    a sandboxed environment), else the simple CHAT_TEMPLATE per message
    plus the assistant-turn opener."""
    if not isinstance(messages, list) or not messages:
        raise HTTPError(400, '"messages" must be a non-empty list')
    for m in messages:
        if (not isinstance(m, dict) or not isinstance(m.get("role"), str)
                or not isinstance(m.get("content"), str)):
            raise HTTPError(400, 'each message must be {"role": str, "content": str}')
    jinja_src = _jinja_template_source(ctx)
    if jinja_src is not None:
        return _render_jinja(ctx, jinja_src, messages)
    template, opener = _chat_template(ctx)
    return "".join(template.format(role=m["role"], content=m["content"])
                   for m in messages) + opener
