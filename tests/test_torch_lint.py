"""gofrlint over the port: ``python tools/gofrlint.py gofr_tpu_torch/``
exits 0 under the port's own suppression ledger
(``gofr_tpu_torch/gofrlint_ledger.json``, the per-rule count of
``# gofrlint: disable=`` comments it may carry), and
``tools/lockgraph_check.py`` finds no cycle in the static lock-order graph
that run proves. The JAX tree's lint (``tools/gofrlint_ledger.json``, the
CI step) is another run, untouched by this one.

Wall-clock reads (``time.time()``, GFL002) carry the JAX copies'
``# gofrlint: wall-clock — <why>`` annotations; durations read
``time.monotonic()`` or ``time.perf_counter()``.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
LEDGER = REPO / "gofr_tpu_torch" / "gofrlint_ledger.json"


def _gofrlint(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "tools/gofrlint.py", *args, "gofr_tpu_torch/"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)


def test_the_port_lints_clean_under_its_ledger(tmp_path):
    static = tmp_path / "static.json"
    run = _gofrlint("--ledger-check", str(LEDGER), "--emit-lock-graph", str(static))
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-2000:]
    assert "gofrlint: clean" in run.stdout
    graph = json.loads(static.read_text())
    assert graph["source"] == "static" and graph["edges"]
    check = subprocess.run([sys.executable, "tools/lockgraph_check.py", str(static)],
                           cwd=REPO, capture_output=True, text=True, timeout=60)
    assert check.returncode == 0, check.stdout + check.stderr
    assert "no cycles" in check.stdout


def test_the_ledger_is_the_port_count():
    """The committed ledger equals what the tree carries today: a new
    suppression raises the count (and fails the check above), and one
    taken out lowers it here first."""
    run = _gofrlint("--ledger")
    assert run.returncode == 0
    assert json.loads(run.stdout) == json.loads(LEDGER.read_text())
