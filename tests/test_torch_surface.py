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
- Name by name: an AST walk of every module of ``gofr_tpu/`` lists its
  public top-level functions, classes, their public methods, its UPPER
  module constants and an ``__init__``'s ``__all__``. Each resolves in the
  port under the same module path, or is in ``RENAMED`` (the JAX name ->
  the port's, which must resolve) or ``KEPT`` (with the reason the port
  has no counterpart). Neither map may hold a name that resolves. One
  test walks every module (its failure lists each module's unaccounted
  names).
"""

import ast
import importlib
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

# JAX name (module path under the package, ":" the name) -> the port's
# counterpart, in the same form, one line each
RENAMED = {
    "models:__all__:init_transformer": "models:Transformer.random",
    "models:__all__:transformer_forward": "models:Transformer.transformer_forward",
    "models:__all__:prefill": "models:Transformer.prefill",
    "models:__all__:decode_step": "models:Transformer.decode_step",
    "models:__all__:init_cache": "models:Transformer.init_cache",
    "models.transformer:init_transformer": "models.transformer:Transformer.random",
    "models.transformer:transformer_forward": "models.transformer:Transformer.transformer_forward",
    "models.transformer:init_cache": "models.transformer:Transformer.init_cache",
    "models.transformer:prefill": "models.transformer:Transformer.prefill",
    "models.transformer:decode_step": "models.transformer:Transformer.decode_step",
    "models.transformer:verify_chunk": "models.transformer:Transformer.verify_chunk",
    "models.transformer:verify_chunk_sampled": "models.transformer:Transformer.verify_chunk_sampled",
    "models.transformer:draft_chunk_sampled": "models.transformer:Transformer.draft_chunk_sampled",
    "models.transformer:score_tokens": "models.transformer:Transformer.score_tokens",
    "models.transformer:decode_chunk_pool": "models.transformer:Transformer.decode_chunk_pool",
    "models.transformer:decode_chunk_pool_lora":
        "models.transformer:Transformer.decode_chunk_pool_lora",
    "models.transformer:decode_chunk_pool_penalized":
        "models.transformer:Transformer.decode_chunk_pool_penalized",
    # solo decode runs the pool's chunk at B = 1
    "models.transformer:decode_chunk": "models.transformer:Transformer.decode_chunk_pool",
    "models.moe:init_moe": "models.moe:MoETransformer.random",
    "tpu.costmodel:CostModel.hlo_flops": "tpu.costmodel:CostModel.sheet_flops",
    "tpu.kv_blocks:JaxKVArena": "tpu.kv_blocks:TorchKVArena",
    "tpu.kv_blocks:JaxKVArena.scatter_row": "tpu.kv_blocks:TorchKVArena.scatter_row",
    "tpu.kv_blocks:JaxKVArena.gather_row": "tpu.kv_blocks:TorchKVArena.gather_row",
    "tpu.kv_blocks:JaxKVArena.wire_spec": "tpu.kv_blocks:TorchKVArena.wire_spec",
    "tpu.kv_blocks:JaxKVArena.export_block_payload":
        "tpu.kv_blocks:TorchKVArena.export_block_payload",
    "tpu.kv_blocks:JaxKVArena.ingest_block_payload":
        "tpu.kv_blocks:TorchKVArena.ingest_block_payload",
    "tpu.kv_blocks:JaxKVArena.read": "tpu.kv_blocks:TorchKVArena.read",
}

# JAX names the port keeps no counterpart of, each with its reason
KEPT = {
    "models.transformer:TransformerConfig.cache_dtype":
        "the KV dtype is a serving option (MODEL_KV_DTYPE, the runner's cache_dtype), "
        "not the model config's",
    "ops.flash:DEFAULT_BLOCK_Q": "a Pallas tile size: the CUDA kernels pick their own tiles "
                                 "(ops/flash.py::fwd_sm90_grid, fwd_decode_row_tiles)",
    "ops.flash:DEFAULT_BLOCK_KV": "a Pallas tile size: the CUDA kernels pick their own tiles",
    "ops.flash:BWD_BLOCK_Q": "a Pallas tile size: dq_sm90_grid and dkv_sm90_geometry pick "
                             "the backward's",
    "ops.flash:FUSED_BWD": "the Pallas fused-backward switch: the port always runs its dQ "
                           "and dK/dV kernels",
    "ops.sampling:Sampler.take_key": "JAX's PRNG key split: a port Sampler holds a "
                                     "torch.Generator",
    "tpu.costmodel:CostModel.harvest": "reads a compiled program's HLO cost analysis "
                                       "(COSTMODEL_HLO, unhonored): the port's sheets are "
                                       "analytic",
    "tpu.costmodel:CostModel.hlo_bytes": "COSTMODEL_HLO (unhonored): an analytic sheet's bytes "
                                         "are sheet_for(...).bytes_accessed",
}


def _public_names(path: Path) -> list:
    """A JAX module's public top-level functions and classes, their public
    methods, its UPPER constants and (an ``__init__``'s) ``__all__``."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{item.name}" for item in node.body
                        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not item.name.startswith("_")]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                if not isinstance(target, ast.Name):
                    continue
                if target.id == "__all__" and path.name == "__init__.py":
                    out += [f"__all__:{elt.value}" for elt in node.value.elts]
                elif target.id.isupper() and not target.id.startswith("_"):
                    out.append(target.id)
    return out


def _jax_modules() -> list:
    root = REPO / "gofr_tpu"
    mods = []
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        parts = path.relative_to(root).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def _source(module: str) -> Path:
    base = REPO / "gofr_tpu" / Path(*module.split(".")) if module else REPO / "gofr_tpu"
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _resolves(target: str) -> bool:
    """Whether ``module:dotted.name`` resolves in ``gofr_tpu_torch``: the
    module imported, then the name's attributes."""
    module, name = target.split(":", 1)
    obj = importlib.import_module("gofr_tpu_torch" + (f".{module}" if module else ""))
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _port_has(module: str, name: str) -> bool:
    if name.startswith("__all__:"):
        mod = importlib.import_module("gofr_tpu_torch" + (f".{module}" if module else ""))
        return name.split(":", 1)[1] in getattr(mod, "__all__", ())
    return _resolves(f"{module}:{name}")


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


def test_every_public_name_resolves_in_the_port():
    """Each public name of every JAX module resolves in the port under the
    same module path, or is renamed (its target resolves) or kept with a
    reason; the failure lists every unaccounted name by module."""
    unaccounted: dict = {}
    for module in _jax_modules():
        for name in _public_names(_source(module)):
            key = f"{module}:{name}"
            if _port_has(module, name) or key in KEPT:
                continue
            if key in RENAMED:
                assert _resolves(RENAMED[key]), f"{key} -> {RENAMED[key]} does not resolve"
                continue
            unaccounted.setdefault(f"gofr_tpu.{module}", []).append(name)
    assert len(_jax_modules()) > 100 and not unaccounted, f"no port counterpart: {unaccounted}"


def test_the_maps_hold_only_names_the_port_lacks():
    """A renamed or kept entry is a public JAX name with no same-named port
    counterpart (an entry the port came to resolve must go), and every
    kept entry says why."""
    for key in (*RENAMED, *KEPT):
        module, name = key.split(":", 1)
        assert name in _public_names(_source(module)), key
        assert not _port_has(module, name), f"{key} resolves in the port: drop its entry"
    assert all(reason.strip() for reason in KEPT.values())
    assert not set(RENAMED) & set(KEPT)


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
