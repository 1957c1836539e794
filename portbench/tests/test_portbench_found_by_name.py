"""A configuration, a traffic mix and a per-layer metric are picked up
from new files alone: no file of the benchmark is edited."""

from __future__ import annotations

import json

from conftest import BENCH, make_checkout

from portbench import spec

METRIC = '''
def read(run):
    return 42.0 if run["records"] else None
'''


def test_new_files_make_a_cell(tmp_path):
    root = make_checkout(tmp_path, metric="dropped_in.share", metric_source=METRIC)
    cell = spec.load_cell("tiny.cell", root)
    assert cell.config["hidden_size"] == 64
    assert cell.traffic["kind"] == "open_poisson"
    assert [m["name"] for m in cell.per_layer] == ["dropped_in.share"]
    assert {m["name"] for m in cell.end_to_end} == {"tpot_p50_ms", "setup_s"}
    assert spec.reader("dropped_in.share", root).read({"records": [1]}) == 42.0
    assert spec.generator("open_poisson", root).DRIVER == "serve"
    # the copy's files are the benchmark's own, unedited
    for path in BENCH.rglob("*"):
        if path.is_file() and "tests" not in path.parts and "__pycache__" not in path.parts:
            copy = root / BENCH.name / path.relative_to(BENCH)
            assert copy.read_bytes() == path.read_bytes(), path


def test_every_named_part_has_its_file():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for work in bench["workloads"]:
        cell = spec.load_cell(work["name"])
        spec.generator(cell.traffic["kind"])
        spec.reference(cell.config["reference"])
        assert (BENCH / "limits" / f"{cell.name}.json").is_file()
    for metric in bench["per_layer"]:
        assert callable(spec.reader(metric["name"]).read)


def test_a_run_reads_the_dropped_in_metric(tmp_path):
    from portbench import run

    root = make_checkout(tmp_path, metric="dropped_in.share", metric_source=METRIC)
    out = run.execute("tiny.cell", 7, 2.0, True, root, device="cpu")
    line = run.result_line(out["cell"], out, True, "cpu", 1)
    assert line["metrics"]["dropped_in.share"] == {"value": 42.0, "unit": "%"}
    assert out["correct"]
    assert list(line)[-1] == "checked"
    # an untraced run's line reports what needs no trace under "layers"
    untraced = run.result_line(out["cell"], out, False, "cpu", 1)
    assert set(untraced["metrics"]) == {"tpot_p50_ms", "setup_s"}
    assert untraced["layers"]["dropped_in.share"] == {"value": 42.0, "unit": "%"}
    assert list(untraced)[-1] == "checked"


def test_a_metric_of_a_new_cell_finds_the_reader_of_its_quantity(tmp_path):
    """``mfu.<cell>`` with no reader of its own is read by ``metrics/mfu.py``;
    a reader of the metric's own name comes first."""
    root = make_checkout(tmp_path, metric="mfu.tiny", metric_source=METRIC)
    assert spec.reader("mfu.tiny", root).read({"records": [1]}) == 42.0
    assert spec.reader("mfu.other", root).__file__.endswith("metrics/mfu.py")
    assert spec.reader("device_idle.other", root).read({"trace": None}) is None
