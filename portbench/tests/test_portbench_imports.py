"""No module of the benchmark imports JAX, jaxlib, flax or the JAX
package, compared by whole top-level names (``gofr_tpu_torch`` is not
``gofr_tpu``); the plain reference imports nothing of the program either."""

from __future__ import annotations

import ast

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "gofr_tpu"}


def _top_levels(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    found = {(str(p.relative_to(BENCH)), name) for p in BENCH.rglob("*.py")
             for name in _top_levels(p) if name in FORBIDDEN}
    assert not found


def test_the_whole_name_is_compared():
    names = {"gofr_tpu_torch", "gofr_tpu_torch.ops", "jaxtyping"}
    assert not {n.split(".")[0] for n in names} & FORBIDDEN
    assert {"gofr_tpu.models".split(".")[0]} & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in [*(BENCH / "references").glob("*.py"), BENCH / "weights.py"]:
        assert not set(_top_levels(path)) & (FORBIDDEN | {"gofr_tpu_torch"}), path


def test_a_run_holds_no_jax():
    import sys

    from portbench import run

    assert run.forbidden_modules() == sorted(
        n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
