"""The control on the card at each cell's own size: a short window of the
cell's load, the program's readings and the control's (the reference with
float8 weights) on the same requests or steps. The program passes every
limit; the control fails at least one. Where the program has a
lower-precision path of its own (``program_control`` in the cell's limits
file), the program served with it switched on comes out not correct. Run
on the card:

    python -m pytest portbench/tests -q -m cuda
"""

from __future__ import annotations

import json

import pytest

from conftest import REPO

from portbench import run

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
PROGRAM_CONTROLLED = [c for c in CELLS if "program_control" in json.loads(
    (REPO / "portbench" / "limits" / f"{c}.json").read_text())]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    out = run.execute(cell, 2**33 + 77, 20.0, False, REPO, control=True)
    assert out["correct"], out["checked"]
    lims = {k: v["limit"] for k, v in out["checked"].items()}
    assert any(out["found"][f"control_{k}"] > lim for k, lim in lims.items()), out["found"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", PROGRAM_CONTROLLED)
def test_the_programs_lower_precision_path_is_not_correct(card, cell):
    out = run.execute(cell, 2**33 + 78, 20.0, False, REPO, program_control=True)
    assert out["sample"] > 0
    assert not out["correct"], out["checked"]
