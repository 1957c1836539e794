"""The port's package surface against the JAX package's.

- ``gofr_tpu_torch.openai_compat``: the same ``__all__`` as
  ``gofr_tpu.openai_compat`` and every name the JAX shim exports (the
  private helpers map onto the port's renamed ones: ``_sampler`` is
  ``openai.parse.sampler_from_body``, and so on).
- The top level: ``__all__`` covers the JAX package's (``Context`` and
  ``__version__`` included), each name resolves, and ``__version__`` is the
  JAX package's.
- The verify skill's echo recipe, through the shim, on both packages: the
  same completion.
- ``comm -23`` of the two packages' modules is empty: MoE
  (``models/moe.py``, ``parallel/expert.py``) and multihost
  (``parallel/multihost.py``) were the last.
"""

import json
import socket
import urllib.request
from pathlib import Path

import pytest

import gofr_tpu
import gofr_tpu.openai_compat as jax_compat
import gofr_tpu_torch
import gofr_tpu_torch.openai_compat as compat
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu_torch.config import DECLARED_KEYS
from gofr_tpu_torch.openai import fanout, logprobs, parse, template

REPO = Path(__file__).resolve().parents[1]


def _exported(mod) -> set:
    return {name for name in vars(mod) if not name.startswith("__")
            and name not in ("annotations",)}


def test_openai_compat_exports_the_jax_names():
    assert compat.__all__ == jax_compat.__all__
    missing = _exported(jax_compat) - _exported(compat)
    assert not missing, missing
    assert {n for n in _exported(jax_compat) if n.startswith("_")} == {
        "_consume_stream", "_fanout_generate", "_chat_logprobs_obj", "_chat_lp_entry",
        "_logprobs_obj", "_FANOUT_CAP", "_StopScanner", "_parse_fanout", "_parse_request",
        "_parse_stops", "_prompt_tokens", "_sampler", "_chat_template", "_compiled_jinja",
        "_jinja_template_source", "_render_jinja", "_resolve_jinja_source",
    }


@pytest.mark.parametrize("name,target", [
    ("_sampler", parse.sampler_from_body), ("_parse_request", parse.parse_request),
    ("_FANOUT_CAP", parse.FANOUT_CAP), ("_StopScanner", parse.StopScanner),
    ("_parse_fanout", parse.parse_fanout), ("_parse_stops", parse.parse_stops),
    ("_prompt_tokens", parse.prompt_tokens), ("_consume_stream", fanout.consume_stream),
    ("_fanout_generate", fanout.fanout_generate), ("_logprobs_obj", logprobs.logprobs_obj),
    ("_chat_lp_entry", logprobs.chat_lp_entry),
    ("_chat_logprobs_obj", logprobs.chat_logprobs_obj),
    ("_render_jinja", template._render_jinja),
    ("DEFAULT_CHAT_TEMPLATE", template.DEFAULT_CHAT_TEMPLATE),
])
def test_openai_compat_maps_onto_the_ports_helpers(name, target):
    assert getattr(compat, name) is target
    assert name in vars(jax_compat)


def test_fanout_cap_and_default_template_equal_jax():
    assert compat._FANOUT_CAP == jax_compat._FANOUT_CAP
    assert compat.DEFAULT_CHAT_TEMPLATE == jax_compat.DEFAULT_CHAT_TEMPLATE


def test_top_level_covers_the_jax_package():
    assert set(gofr_tpu.__all__) <= set(gofr_tpu_torch.__all__)
    for name in gofr_tpu_torch.__all__:
        assert getattr(gofr_tpu_torch, name) is not None
    assert gofr_tpu_torch.__version__ == gofr_tpu.__version__ == "0.1.0"
    from gofr_tpu_torch.context import Context

    assert gofr_tpu_torch.Context is Context
    with pytest.raises(AttributeError):
        gofr_tpu_torch.not_a_name  # noqa: B018


def test_only_moe_and_parallel_are_left_to_port():
    """Nothing is left: every module of the JAX package has its port, MoE
    (``models/moe.py``, ``parallel/expert.py``) and multihost
    (``parallel/multihost.py``) the last."""

    def modules(pkg: str) -> set:
        root = REPO / pkg
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
                if "__pycache__" not in p.parts}

    left = modules("gofr_tpu") - modules("gofr_tpu_torch")
    assert left == set()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def env(monkeypatch, tmp_path):
    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    return monkeypatch


def test_the_echo_recipe_through_the_shim(env):
    """The verify skill's recipe (MODEL_NAME=echo TOKENIZER=byte, the
    OpenAI routes registered through ``openai_compat``) on both packages:
    the same completion."""
    env.setenv("MODEL_NAME", "echo")
    env.setenv("TOKENIZER", "byte")
    env.setenv("LOG_LEVEL", "FATAL")
    body = {"model": "echo", "prompt": "hi", "max_tokens": 4}
    got = []
    for pkg, shim in ((gofr_tpu, jax_compat), (gofr_tpu_torch, compat)):
        env.setenv("HTTP_PORT", str(_free_port()))
        app = pkg.new()
        shim.register_openai_routes(app)
        app.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{app.http_port}/v1/completions",
                data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                doc = json.loads(resp.read())
        finally:
            app.shutdown()
        doc.pop("id")
        doc.pop("created")
        got.append(doc)
    assert got[0] == got[1]
    assert got[1]["choices"][0]["text"] and got[1]["usage"]["completion_tokens"] == 4
