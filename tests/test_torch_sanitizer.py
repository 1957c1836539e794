"""The port's lock sanitizer (``gofr_tpu_torch/devtools/sanitizer.py``)
against the JAX package's (``gofr_tpu/devtools/sanitizer.py``).

- ``tests/test_sanitizer.py``'s cases, case for case, on the port's module:
  lock-order cycles with both stacks, reentrancy, Condition compatibility,
  hold-time warnings, install/uninstall, the thread-leak detector and its
  allowlist, the observed graph's export.
- One scripted sequence of acquisitions through both modules: the same
  graph document, apart from the path labels.
- The port's own parts: the project scope (``gofr_tpu_torch/`` and
  ``tests/``, not ``gofr_tpu/``), an install nested inside the JAX
  sanitizer's, ``write_report``, and fleetsim under ``GOFR_SANITIZE=1
  --emit-graph`` with ``tools/lockgraph_check.py`` over gofrlint's static
  graph and the observed one.

No test leaves ``threading.Lock`` rebound: an autouse fixture restores the
factories it found and fails the test that changed them.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from gofr_tpu.devtools import sanitizer as jax_sanitizer
from gofr_tpu_torch.devtools import sanitizer

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_sanitizer_state():
    """Fresh findings and graphs in both modules, and the lock factories
    exactly as found (the suite may run under the JAX sanitizer)."""
    lock, rlock = threading.Lock, threading.RLock
    port_installed = sanitizer.installed()
    sanitizer.reset()
    jax_sanitizer.reset()
    yield
    sanitizer.reset()
    jax_sanitizer.reset()
    changed = (threading.Lock, threading.RLock) != (lock, rlock)
    threading.Lock, threading.RLock = lock, rlock
    sanitizer._installed = port_installed
    assert not changed, "a test left threading.Lock rebound"


# -- lock-order graph ---------------------------------------------------------

def test_opposite_order_acquisition_is_a_potential_deadlock():
    a = sanitizer.sanitized_lock("lockA")
    b = sanitizer.sanitized_lock("lockB")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    report = sanitizer.drain()
    assert len(report["violations"]) == 1
    v = report["violations"][0]
    assert v["kind"] == "lock-order-cycle"
    assert "lockA" in v["summary"] and "lockB" in v["summary"]
    assert v["this_edge"]["acquire_stack"]
    assert v["reverse_edge"]["acquire_stack"]
    assert any("test_torch_sanitizer" in f for f in v["this_edge"]["acquire_stack"])


def test_consistent_order_is_clean():
    a = sanitizer.sanitized_lock("A")
    b = sanitizer.sanitized_lock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert sanitizer.drain()["violations"] == []


def test_indirect_cycle_through_a_third_lock():
    a = sanitizer.sanitized_lock("A")
    b = sanitizer.sanitized_lock("B")
    c = sanitizer.sanitized_lock("C")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with a:
            pass  # closes A -> B -> C -> A
    report = sanitizer.drain()
    assert len(report["violations"]) == 1
    assert report["violations"][0]["reverse_edge"] is None  # indirect


def test_cross_thread_opposite_order_is_detected():
    a = sanitizer.sanitized_lock("A")
    b = sanitizer.sanitized_lock("B")

    def forward():
        with a:
            with b:
                pass

    t = threading.Thread(target=forward, name="san-forward")
    t.start()
    t.join()
    with b:
        with a:
            pass
    assert sanitizer.drain()["violations"]


def test_rlock_reentrancy_adds_no_edges():
    r = sanitizer.sanitized_rlock("R")
    with r:
        with r:
            with r:
                pass
    report = sanitizer.drain()
    assert report["violations"] == []
    assert report["edges"] == 0


def test_drain_clears_violations_but_keeps_the_graph():
    a = sanitizer.sanitized_lock("A")
    b = sanitizer.sanitized_lock("B")
    with a:
        with b:
            pass
    assert sanitizer.drain()["edges"] == 1
    with b:
        with a:
            pass  # the edge from before drain still closes the cycle
    assert len(sanitizer.drain()["violations"]) == 1


# -- Condition compatibility --------------------------------------------------

@pytest.mark.parametrize("factory", [sanitizer.sanitized_lock, sanitizer.sanitized_rlock])
def test_condition_wait_notify_on_sanitized_locks(factory):
    cond = threading.Condition(factory("condlock"))
    hits = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            hits.append(1)

    t = threading.Thread(target=waiter, name="san-cond-wait")
    t.start()
    # notify until the waiter wakes: one notify before its wait() is lost
    deadline = time.monotonic() + 5.0
    while not hits and time.monotonic() < deadline:
        with cond:
            cond.notify()
        time.sleep(0.005)
    t.join(timeout=5)
    assert hits == [1]
    assert sanitizer.drain()["violations"] == []


# -- hold-time tracking -------------------------------------------------------

def test_long_hold_records_a_warning(monkeypatch):
    monkeypatch.setenv("GOFR_SANITIZE_HOLD_MS", "20")
    lock = sanitizer.sanitized_lock("slow-lock")
    with lock:
        time.sleep(0.05)
    warnings = sanitizer.drain()["hold_warnings"]
    w = next(w for w in warnings if w["lock"] == "slow-lock")
    assert w["seconds"] >= 0.02 and w["stack"]


def test_fast_hold_is_silent(monkeypatch):
    monkeypatch.setenv("GOFR_SANITIZE_HOLD_MS", "500")
    lock = sanitizer.sanitized_lock("fast-lock")
    with lock:
        pass
    assert sanitizer.drain()["hold_warnings"] == []


# -- install / uninstall ------------------------------------------------------

def test_install_rebinds_threading_lock_factories():
    sanitizer.install()
    try:
        lk = threading.Lock()
        rlk = threading.RLock()
        assert isinstance(lk, sanitizer.SanitizedLock)
        assert isinstance(rlk, sanitizer.SanitizedRLock)
        with lk:
            pass
        with rlk:
            with rlk:
                pass
        # the creation label points at this file (project-scoped tracking)
        assert "test_torch_sanitizer" in lk._label and lk._project
    finally:
        sanitizer.uninstall()
    assert not isinstance(threading.Lock(), sanitizer.SanitizedLock)
    sanitizer.drain()


def test_install_nests_inside_the_jax_sanitizer():
    """``tests/conftest.py`` arms the JAX sanitizer process-wide under
    GOFR_SANITIZE=1: the port's install wraps raw locks (never the JAX
    wrappers), its uninstall gives the JAX factories back, and an
    uninstall out of order refuses."""
    jax_was = jax_sanitizer.installed()
    jax_sanitizer.install()
    try:
        jax_lock = threading.Lock
        sanitizer.install()
        lk = threading.Lock()
        assert isinstance(lk, sanitizer.SanitizedLock)
        assert not isinstance(lk._inner, jax_sanitizer.SanitizedLock)
        sanitizer.uninstall()
        assert threading.Lock is jax_lock
        # out of order: the JAX sanitizer undone under the port's
        sanitizer.install()
        jax_sanitizer.uninstall()
        with pytest.raises(RuntimeError, match="uninstall that one first"):
            sanitizer.uninstall()
    finally:
        if jax_was:
            jax_sanitizer.install()


def test_scope_is_the_port_and_the_tests():
    assert sanitizer._in_project("/x/repo/gofr_tpu_torch/tpu/device.py")
    assert sanitizer._in_project("/x/repo/tests/test_torch_pool.py")
    assert not sanitizer._in_project("/x/repo/gofr_tpu/tpu/device.py")
    assert not sanitizer._in_project("/usr/lib/python3.12/threading.py")
    assert jax_sanitizer._in_project("/x/repo/gofr_tpu/tpu/device.py")


# -- thread-leak detection ----------------------------------------------------

def test_leaked_nondaemon_thread_is_reported():
    before = set(threading.enumerate())
    release = threading.Event()
    t = threading.Thread(target=release.wait, name="san-leaky")
    t.start()
    try:
        assert t in sanitizer.leaked_threads(before, grace_s=0.1)
    finally:
        release.set()
        t.join(timeout=5)


def test_joined_and_daemon_threads_are_not_leaks():
    before = set(threading.enumerate())
    t = threading.Thread(target=lambda: None, name="san-quick")
    t.start()
    t.join()
    d = threading.Thread(target=time.sleep, args=(0.5,), name="san-d", daemon=True)
    d.start()
    assert sanitizer.leaked_threads(before, grace_s=0.1) == []


def test_allowlisted_singletons_pass():
    before = set(threading.enumerate())
    release = threading.Event()
    t = threading.Thread(target=release.wait, name="gofr-timebase-sampler")
    t.start()
    try:
        assert sanitizer.leaked_threads(before, grace_s=0.0) == []
        assert sanitizer.is_allowlisted(t)
    finally:
        release.set()
        t.join(timeout=5)


def test_grace_period_tolerates_winding_down_threads():
    before = set(threading.enumerate())
    t = threading.Thread(target=time.sleep, args=(0.2,), name="san-slowstop")
    t.start()
    assert sanitizer.leaked_threads(before, grace_s=2.0) == []
    t.join()


# -- observed lock-order graph export -----------------------------------------

def test_export_graph_schema_and_determinism(tmp_path):
    a = sanitizer.sanitized_lock("graphA")
    b = sanitizer.sanitized_lock("graphB")
    with a:
        with b:
            pass
    out = tmp_path / "graph.json"
    graph = sanitizer.export_graph(str(out))
    assert graph["version"] == 1 and graph["source"] == "runtime"
    assert [n["id"] for n in graph["nodes"]] == ["graphA", "graphB"]
    assert len(graph["edges"]) == 1
    edge = graph["edges"][0]
    assert edge["from"] == "graphA" and edge["to"] == "graphB"
    assert set(edge) == {"from", "to", "site", "thread"}
    # the site in the static graph's spelling: repo-relative for a test
    assert edge["site"].startswith("tests/test_torch_sanitizer.py:")
    assert json.loads(out.read_text()) == graph
    assert sanitizer.export_graph() == graph
    sanitizer.drain()


def test_export_graph_survives_drain_and_empties_on_reset():
    a = sanitizer.sanitized_lock("keepA")
    b = sanitizer.sanitized_lock("keepB")
    with a:
        with b:
            pass
    sanitizer.drain()
    assert len(sanitizer.export_graph()["edges"]) == 1
    sanitizer.reset()
    assert sanitizer.export_graph() == {"version": 1, "source": "runtime", "nodes": [],
                                        "edges": []}


# -- against the JAX module ---------------------------------------------------

def _scripted(mod) -> tuple:
    """One sequence of acquisitions, with locks created by the module's
    factories (labelled by creation site) and by name, on two threads:
    an ordered chain, a reentrant hold, and one opposite-order pair.
    -> (the drained findings, the exported graph)."""
    x = mod.sanitized_lock()
    y = mod.sanitized_rlock()
    z = mod.sanitized_lock("named-z")
    with x:
        with y:
            with y:
                with z:
                    pass

    def other():
        with z:
            with x:  # closes x -> y -> z -> x
                pass

    t = threading.Thread(target=other, name="san-scripted")
    t.start()
    t.join()
    return mod.drain(), mod.export_graph()


def _strip_paths(doc):
    """Every creation or acquisition site down to its line number."""
    if isinstance(doc, dict):
        return {k: _strip_paths(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_strip_paths(v) for v in doc]
    if isinstance(doc, str) and ".py:" in doc:
        return "<site>:" + doc.rsplit(".py:", 1)[1].split(" ")[0]
    return doc


def test_export_graph_equals_jax_apart_from_paths():
    port_report, port_graph = _scripted(sanitizer)
    jax_report, jax_graph = _scripted(jax_sanitizer)
    assert len(port_report["violations"]) == len(jax_report["violations"]) == 1
    assert port_report["edges"] == jax_report["edges"] == 4
    # the same document once the paths go (the sort order follows the labels)
    port_doc, jax_doc = _strip_paths(port_graph), _strip_paths(jax_graph)
    for doc in (port_doc, jax_doc):
        for key in ("nodes", "edges"):
            doc[key] = sorted(doc[key], key=lambda e: json.dumps(e, sort_keys=True))
    assert port_doc == jax_doc
    # the port's labels: relative, as gofrlint's static graph spells them
    assert all(n["id"] == "named-z" or n["id"].startswith("tests/test_torch_sanitizer.py:")
               for n in port_graph["nodes"])
    assert any(n["id"].startswith("/") for n in jax_graph["nodes"])


def test_write_report_names_findings_and_leaks(tmp_path, monkeypatch):
    report, graph = tmp_path / "report.jsonl", tmp_path / "graph.json"
    monkeypatch.setenv("GOFR_SANITIZE_REPORT", str(report))
    monkeypatch.setenv("GOFR_SANITIZE_GRAPH", str(graph))
    before = set(threading.enumerate())
    a, b = sanitizer.sanitized_lock("ra"), sanitizer.sanitized_lock("rb")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    release = threading.Event()
    t = threading.Thread(target=release.wait, name="san-report-leak")
    t.start()
    try:
        doc = sanitizer.write_report(before, grace_s=0.1)
    finally:
        release.set()
        t.join(timeout=5)
    line = json.loads(report.read_text().splitlines()[-1])
    assert line == json.loads(json.dumps(doc))
    assert len(line["violations"]) == 1 and line["leaked_threads"] == ["san-report-leak"]
    assert json.loads(graph.read_text())["edges"][0]["from"] == "ra"


# -- fleetsim under the sanitizer, and the static ∪ observed graph -------------

def test_fleetsim_under_the_sanitizer_has_no_cycle(tmp_path):
    """A short port fleetsim run with GOFR_SANITIZE=1 --emit-graph: no
    lock-order cycle (exit 0), an observed graph of the port's locks, and
    ``tools/lockgraph_check.py`` over gofrlint's static graph of
    ``gofr_tpu_torch/`` and the observed one exits 0."""
    observed, static = tmp_path / "observed.json", tmp_path / "static.json"
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "GOFR_SANITIZE": "1",
           "PYTHONPATH": str(REPO), "HOME": str(tmp_path)}
    run = subprocess.run(
        [sys.executable, "-m", "gofr_tpu_torch.devtools.fleetsim", "--replicas", "4",
         "--prefill", "1", "--requests", "24", "--workers", "4", "--no-hardening",
         "--emit-graph", str(observed), "--out", str(tmp_path / "fleetsim.json")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240,
    )
    assert run.returncode == 0, run.stderr[-3000:]
    assert "SANITIZER" not in run.stderr
    graph = json.loads(observed.read_text())
    assert graph["source"] == "runtime" and graph["edges"]
    assert all(not e["from"].startswith("/") for e in graph["edges"]
               if "gofr_tpu_torch" in e["site"] or e["site"].startswith(("fleet/", "tpu/")))
    lint = subprocess.run(
        [sys.executable, "tools/gofrlint.py", "--emit-lock-graph", str(static),
         "gofr_tpu_torch/"], cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert lint.returncode == 0, lint.stdout[-3000:]
    check = subprocess.run(
        [sys.executable, "tools/lockgraph_check.py", str(static), str(observed)],
        cwd=REPO, capture_output=True, text=True, timeout=60,
    )
    assert check.returncode == 0, check.stdout + check.stderr
    assert "no cycles" in check.stdout
