"""Finding a cell's parts by name: ``BENCHMARK.json`` names the cell, its
configuration and its traffic mix; each is a file of its own under this
folder (``configs/``, ``traffic/``), and each per-layer metric is read by
a module with ``read(run) -> float | None``: ``metrics/<name>.py``, or,
where there is none, the reader of its quantity, ``metrics/<q>.py`` for a
metric named ``<q>.<cell or path>`` (one reader serves ``mfu.docqa`` and
``mfu.rag``). A traffic
file's ``kind`` names its generator module, ``generators/<kind>.py``, and
a configuration's ``reference`` its plain reference, ``references/<name>.py``.
Nothing here knows a cell, a mix or a metric by name."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names loaded."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)  # metric entries this cell reports
    per_layer: list = field(default_factory=list)
    root: Path = REPO


def _load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``: its configuration is
    the file its entry names, its traffic ``portbench/traffic/<mix>.json``."""
    root = Path(root) if root is not None else REPO
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[work["config"]]
    config_path = root / entry["file"]
    traffic_name = work["traffic"]
    if not _NAME.match(traffic_name):
        raise ValueError(f"traffic name {traffic_name!r} is not a plain name")
    traffic = _load_json(root / HERE.name / "traffic" / f"{traffic_name}.json")
    return Cell(
        name=name, chips=int(work["chips"]), config_name=entry["name"],
        config=_load_json(config_path), traffic_name=traffic_name, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root,
    )


def _module(folder: str, name: str, root: Optional[Path] = None) -> ModuleType:
    """``<folder>/<name>.py`` of the benchmark loaded as a module (names
    with dots, such as a metric's, are not importable by ``import``)."""
    if not _NAME.match(name):
        raise ValueError(f"{name!r} is not a plain name")
    base = (Path(root) / HERE.name) if root is not None else HERE
    path = base / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} module {path}")
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator(kind: str, root: Optional[Path] = None) -> ModuleType:
    return _module("generators", kind, root)


def reader(metric: str, root: Optional[Path] = None) -> ModuleType:
    base = (Path(root) / HERE.name) if root is not None else HERE
    own = base / "metrics" / f"{metric}.py"
    return _module("metrics", metric if own.is_file() else metric.split(".")[0], root)


def reference(name: str, root: Optional[Path] = None) -> ModuleType:
    return _module("references", name, root)
