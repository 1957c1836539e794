"""Runtime concurrency sanitizer (copy of ``gofr_tpu/devtools/sanitizer.py``):
lock-order, hold-time and thread-leak checking for the threaded engine,
active only under ``GOFR_SANITIZE=1``.

The engine is Python threads around one card: the batcher, the decode
pool's worker, the scheduler, the watchdog, the timebase sampler, the
postmortem writer and the fleet's prober. This module checks their
locking at run time:

- **Lock-order graph / potential-deadlock detection.** ``install()``
  rebinds ``threading.Lock``/``threading.RLock`` to factories that
  return :class:`SanitizedLock` wrappers. Every wrapper acquisition
  while other wrappers are held records ``held -> acquired`` edges in a
  process-global graph; an edge that closes a cycle is a POTENTIAL
  DEADLOCK (two code paths take the same locks in opposite orders —
  whether it hangs today is only a scheduling accident) and is recorded
  with both acquisition stacks. Reentrant acquisitions never add edges.
- **Hold-time tracking.** A wrapper held longer than
  ``GOFR_SANITIZE_HOLD_MS`` (default 150) records a warning with the
  acquisition site — the static half of this rule is gofrlint GFL004
  (no blocking calls under a lock); this is the dynamic half.
- **Thread-leak detection.** :func:`leaked_threads` diffs live threads
  against a pre-test snapshot and reports alive non-daemon leftovers,
  minus the allowlisted long-lived singletons. The conftest fixture
  fails the test that leaked.

Scope: edges are recorded only between locks CREATED by project code
(``gofr_tpu_torch/`` + ``tests/``; the JAX package's own sanitizer
scopes to ``gofr_tpu/``, a path this one leaves out) — lock ordering
inside torch and the stdlib is not ours to gate, and false positives
there would teach people to ignore the sanitizer. Set
``GOFR_SANITIZE_ALL=1`` to widen to every lock.

Two sanitizers in one process nest: :func:`install` saves whatever
factory ``threading.Lock`` holds (the JAX package's sanitizer's, when
``tests/conftest.py`` armed it) and :func:`uninstall` puts it back; each
wrapper wraps a raw ``_thread`` lock, never another wrapper. Processes
arm it at their entry: ``devtools/fleetsim.py`` and
``devtools/replica_proc.py`` under ``GOFR_SANITIZE=1``; each writes
:func:`write_report` (``GOFR_SANITIZE_REPORT``) and the observed graph
(``GOFR_SANITIZE_GRAPH``, or fleetsim's ``--emit-graph``) as it ends.

The wrappers stay Condition-compatible: ``threading.Condition`` built
on a sanitized lock delegates ``_release_save``/``_acquire_restore``/
``_is_owned`` through the wrapper (tracking stays consistent across
``wait()``'s release/reacquire).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Optional

from gofr_tpu_torch.config import env_flag, get_env

# the sanitizer's own mutual exclusion uses the RAW primitive so its
# bookkeeping never recurses into itself
import _thread

_state_lock = _thread.allocate_lock()
_tls = threading.local()

_installed = False
_orig_lock: Any = None
_orig_rlock: Any = None
_node_seq = 0

# node -> {node -> edge dict}; nodes are unique per wrapper instance
# (a monotonically increasing id — never reused, so a gc'd lock's edges
# can never alias a new lock)
_edges: dict[int, dict[int, dict[str, Any]]] = {}
_violations: list[dict[str, Any]] = []
_hold_warnings: list[dict[str, Any]] = []
_MAX_RECORDS = 200

# long-lived singletons the thread-leak check must tolerate (they are
# daemons, but the allowlist also covers a future non-daemon variant
# and documents intent)
THREAD_ALLOWLIST_PREFIXES = (
    "gofr-timebase", "gofr-decode-pool", "gofr-watchdog",
    "pytest_timeout",
)


def enabled() -> bool:
    """True when the suite runs under ``GOFR_SANITIZE=1``."""
    return env_flag("GOFR_SANITIZE")


def hold_threshold_s() -> float:
    try:
        return float(get_env("GOFR_SANITIZE_HOLD_MS", "150")) / 1000.0
    except ValueError:
        return 0.150


def _project_scoped() -> bool:
    return not env_flag("GOFR_SANITIZE_ALL")


_SELF_FILE = __file__


def _site(depth: int, limit: int = 12) -> list[str]:
    """Cheap stack capture (no linecache reads): outermost-last frames
    above ``depth``, this module's own frames skipped."""
    out: list[str] = []
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return out
    while frame is not None and len(out) < limit:
        code = frame.f_code
        if code.co_filename != _SELF_FILE:
            out.append(f"{code.co_filename}:{frame.f_lineno} in {code.co_name}")
        frame = frame.f_back
    return out


def _in_project(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return "gofr_tpu_torch" in parts or "tests" in parts


def _graph_label(label: str) -> str:
    """A creation or acquisition site as gofrlint's static graph of
    ``gofr_tpu_torch/`` spells it: relative to the package directory
    (``tpu/device.py:3658``), a test relative to the repo
    (``tests/test_x.py:12``), anything else as it is."""
    parts = label.replace("\\", "/").split("/")
    for root, keep in (("gofr_tpu_torch", False), ("tests", True)):
        if root in parts:
            i = len(parts) - 1 - parts[::-1].index(root)
            return "/".join(parts[i if keep else i + 1:])
    return label


class _Held:
    __slots__ = ("node", "count", "t_acquired", "stack", "lock")

    def __init__(self, node: int, stack: list[str], lock: "SanitizedLock"):
        self.node = node
        self.count = 1
        self.t_acquired = time.monotonic()
        self.stack = stack
        self.lock = lock


def _held_list() -> list[_Held]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _path_exists(start: int, goal: int) -> bool:
    """DFS over the edge graph (caller holds ``_state_lock``)."""
    seen = {start}
    stack = [start]
    while stack:
        node = stack.pop()
        if node == goal:
            return True
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


def _note_acquire(lock: "SanitizedLock") -> None:
    held = _held_list()
    for entry in held:
        if entry.node == lock._node:
            entry.count += 1  # reentrant: no edges, no fresh hold clock
            return
    stack = _site(3)
    entry = _Held(lock._node, stack, lock)
    if held:  # edge recording only matters under nested acquisition —
        # never serialize the (overwhelmingly common) un-nested case
        # through the global graph lock
        scoped = _project_scoped()
        with _state_lock:
            for holder in held:
                if scoped and not (
                    holder.lock._project and lock._project
                ):
                    continue
                _add_edge_locked(holder, entry)
    held.append(entry)


def _add_edge_locked(holder: _Held, entry: _Held) -> None:
    out = _edges.setdefault(holder.node, {})
    if entry.node in out:
        return
    out[entry.node] = {
        "from": holder.lock._label,
        "to": entry.lock._label,
        "held_stack": holder.stack,
        "acquire_stack": entry.stack,
        "thread": threading.current_thread().name,
    }
    # does acquiring `entry` while holding `holder` close a cycle — is
    # there already a path entry -> ... -> holder from another site?
    if _path_exists(entry.node, holder.node) and \
            len(_violations) < _MAX_RECORDS:
        reverse = _edges.get(entry.node, {}).get(holder.node)
        _violations.append({
            "kind": "lock-order-cycle",
            "summary": (
                f"potential deadlock: {holder.lock._label} -> "
                f"{entry.lock._label} here, but an opposite-order path "
                "already exists"
            ),
            "this_edge": out[entry.node],
            "reverse_edge": reverse,  # None when the path is indirect
            "thread": threading.current_thread().name,
        })


def _note_release(lock: "SanitizedLock", full: bool = False) -> None:
    held = _held_list()
    for i, entry in enumerate(held):
        if entry.node == lock._node:
            entry.count = 0 if full else entry.count - 1
            if entry.count <= 0:
                held.pop(i)
                dt = time.monotonic() - entry.t_acquired
                if dt >= hold_threshold_s() and \
                        len(_hold_warnings) < _MAX_RECORDS:
                    with _state_lock:
                        _hold_warnings.append({
                            "kind": "long-hold",
                            "lock": lock._label,
                            "seconds": round(dt, 4),
                            "stack": entry.stack,
                            "thread": threading.current_thread().name,
                        })
            return


class SanitizedLock:
    """Instrumented wrapper over a primitive lock. Deliberately does
    NOT define the RLock protocol (``_release_save`` & co.):
    ``threading.Condition`` probes for it with getattr and must fall
    back to its generic acquire/release path for plain locks."""

    def __init__(self, inner: Any, label: str, project: bool):
        global _node_seq
        self._inner = inner
        with _state_lock:
            _node_seq += 1
            self._node = _node_seq
        self._label = label
        self._project = project

    # -- lock protocol --------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self)
        return got

    acquire_lock = acquire  # ancient alias some libraries still use

    def release(self) -> None:
        self._inner.release()
        _note_release(self)

    release_lock = release

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self._label} node={self._node}>"

    def __getattr__(self, name: str) -> Any:
        # delegate what we don't wrap (e.g. _at_fork_reinit); missing
        # attrs raise AttributeError from the inner lock, which is what
        # Condition's protocol probing relies on
        inner = object.__getattribute__(self, "__dict__").get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)


class SanitizedRLock(SanitizedLock):
    """Reentrant variant: adds the RLock protocol so a Condition built
    on it keeps sanitizer bookkeeping consistent across ``wait()``'s
    full release/reacquire."""

    def _release_save(self):
        state = self._inner._release_save()
        _note_release(self, full=True)
        return state

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        _note_acquire(self)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def sanitized_lock(label: Optional[str] = None) -> SanitizedLock:
    """A fresh instrumented plain lock (direct-construction seam for
    unit tests; ``install()`` is the fleet-wide path)."""
    return _make_lock(label, depth=2)


def sanitized_rlock(label: Optional[str] = None) -> SanitizedLock:
    return _make_rlock(label, depth=2)


def _creation_label(depth: int) -> tuple[str, bool]:
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return "<unknown>", False
    while frame is not None and frame.f_code.co_filename == _SELF_FILE:
        frame = frame.f_back
    if frame is None:
        return "<unknown>", False
    path = frame.f_code.co_filename
    return f"{path}:{frame.f_lineno}", _in_project(path)


def _make_lock(label: Optional[str] = None, depth: int = 2) -> SanitizedLock:
    site, project = _creation_label(depth)
    return SanitizedLock(_thread.allocate_lock(), label or site, project)


def _make_rlock(label: Optional[str] = None, depth: int = 2) -> SanitizedRLock:
    site, project = _creation_label(depth)
    # the C RLock straight from _thread: never the (possibly patched)
    # threading.RLock factory
    return SanitizedRLock(_thread.RLock(), label or site, project)


# -- install / report ---------------------------------------------------------
def install() -> None:
    """Rebind ``threading.Lock``/``threading.RLock`` to the sanitizing
    factories. Idempotent; ``uninstall()`` restores what they were (the
    originals, or another sanitizer's factories this one nests in)."""
    global _installed, _orig_lock, _orig_rlock
    if _installed:
        return
    _orig_lock = threading.Lock
    _orig_rlock = threading.RLock
    threading.Lock = _make_lock  # type: ignore[assignment]
    threading.RLock = _make_rlock  # type: ignore[assignment]
    _installed = True


def uninstall() -> None:
    """Put back the factories :func:`install` found. Refuses (RuntimeError)
    when something rebound ``threading.Lock`` after this install: undoing
    it out of order would leave that other rebinding in place forever."""
    global _installed
    if not _installed:
        return
    if threading.Lock is not _make_lock or threading.RLock is not _make_rlock:
        raise RuntimeError(
            f"threading.Lock was rebound after this sanitizer's install "
            f"({threading.Lock!r}); uninstall that one first"
        )
    threading.Lock = _orig_lock  # type: ignore[assignment]
    threading.RLock = _orig_rlock  # type: ignore[assignment]
    _installed = False


def installed() -> bool:
    return _installed


def drain() -> dict[str, Any]:
    """The accumulated findings, cleared on read (per-test consumption:
    the conftest fixture fails the test that produced them). The edge
    graph itself persists — opposite-order acquisitions in two
    DIFFERENT tests of the same process are still a real finding."""
    with _state_lock:
        out = {
            "violations": list(_violations),
            "hold_warnings": list(_hold_warnings),
            "edges": sum(len(v) for v in _edges.values()),
        }
        _violations.clear()
        _hold_warnings.clear()
    return out


def reset() -> None:
    """Full reset (unit-test seam): findings AND the edge graph."""
    with _state_lock:
        _violations.clear()
        _hold_warnings.clear()
        _edges.clear()


def export_graph(path: Optional[str] = None) -> dict[str, Any]:
    """Snapshot of the OBSERVED lock-order graph, in the same schema as
    the static exporter (``tools/gofrlint.py --emit-lock-graph``) so
    ``tools/lockgraph_check.py`` can union the two: node ids are lock
    creation labels (``file:lineno``, absolute here — the checker
    normalizes paths), each edge is "``to`` was acquired while ``from``
    was held", ``site`` is the innermost acquiring frame. Deterministic:
    nodes and edges are sorted, and re-exporting an unchanged graph
    yields an identical document. Wired to ``GOFR_SANITIZE_GRAPH`` by
    ``write_report`` and to ``--emit-graph`` by devtools/fleetsim.py.
    Labels are relative (``_graph_label``), in the spelling of
    ``tools/gofrlint.py --emit-lock-graph ... gofr_tpu_torch/``."""
    nodes: set[str] = set()
    edges: dict[tuple[str, str], dict[str, Any]] = {}
    with _state_lock:
        for out in _edges.values():
            for info in out.values():
                a, b = _graph_label(info["from"]), _graph_label(info["to"])
                nodes.add(a)
                nodes.add(b)
                site = info["acquire_stack"][0] if info["acquire_stack"] else ""
                edges.setdefault((a, b), {
                    "from": a, "to": b,
                    "site": _graph_label(site.split(" in ")[0]),
                    "thread": info["thread"],
                })
    graph: dict[str, Any] = {
        "version": 1,
        "source": "runtime",
        "nodes": [{"id": n} for n in sorted(nodes)],
        "edges": [edges[k] for k in sorted(edges)],
    }
    if path:
        import json

        with open(path, "w", encoding="utf-8") as f:
            json.dump(graph, f, indent=2, sort_keys=True)
            f.write("\n")
    return graph


def is_allowlisted(thread: threading.Thread) -> bool:
    return any(
        thread.name.startswith(p) for p in THREAD_ALLOWLIST_PREFIXES
    )


def leaked_threads(
    before: "set[threading.Thread]", grace_s: float = 2.0
) -> list[threading.Thread]:
    """Alive non-daemon threads that appeared since ``before`` and are
    not allowlisted. Waits up to ``grace_s`` for stragglers (executor
    workers unwinding a ``shutdown(wait=False)``) before reporting."""
    deadline = time.monotonic() + grace_s
    while True:
        leaked = [
            t for t in threading.enumerate()
            if t not in before and t.is_alive() and not t.daemon
            and not is_allowlisted(t)
        ]
        if not leaked or time.monotonic() >= deadline:
            return leaked
        for t in leaked:
            t.join(timeout=0.05)


def write_report(before: "set[threading.Thread]", grace_s: float = 2.0) -> dict[str, Any]:
    """A process's verdict as it ends: its findings (:func:`drain`) and the
    threads it leaked since ``before``, appended as one JSON line to
    ``GOFR_SANITIZE_REPORT`` (default ``sanitizer-report.jsonl``); the
    observed graph goes to ``GOFR_SANITIZE_GRAPH`` when that is set.
    Returns the line's document."""
    import json
    import os

    leaked = leaked_threads(before, grace_s)
    doc: dict[str, Any] = {"pid": os.getpid(), **drain(),
                           "leaked_threads": sorted(t.name for t in leaked)}
    with open(get_env("GOFR_SANITIZE_REPORT") or "sanitizer-report.jsonl", "a",
              encoding="utf-8") as f:
        f.write(json.dumps(doc) + "\n")
    graph = get_env("GOFR_SANITIZE_GRAPH")
    if graph:
        export_graph(graph)
    return doc
