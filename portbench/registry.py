"""Cells, configurations, traffic, limits and metric readers, by name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
the configurations and the metrics. A cell names its configuration, whose
entry names its file, and its traffic, ``portbench/traffic/<traffic>.json``;
its limits are ``portbench/limits/<cell>.json``. A metric applies to a
cell when its entry lists the cell under ``workloads`` or lists none. A
per-layer metric's reader is ``portbench/metrics/<metric>.py``, whose
``read(obs)`` returns the value or ``None`` when there is nothing to read.
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Tuple

ROOT = Path(__file__).resolve().parent.parent
PKG = "portbench"


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: Tuple[Metric, ...]
    per_layer: Tuple[Metric, ...]
    limits: dict
    root: Path


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return _load(Path(root) / "BENCHMARK.json")


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    m = manifest(root)
    w = _named(m["workloads"], name, "workload")
    c = _named(m["configs"], w["config"], "config")
    return Cell(
        name=name, chips=int(w["chips"]), config=_load(root / c["file"]),
        traffic=_load(root / PKG / "traffic" / f"{w['traffic']}.json"),
        end_to_end=tuple(Metric(e["name"], e["unit"])
                         for e in m["end_to_end"] if _applies(e, name)),
        per_layer=tuple(Metric(e["name"], e["unit"])
                        for e in m["per_layer"] if _applies(e, name)),
        limits=_load(root / PKG / "limits" / f"{name}.json")["limits"],
        root=root)


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of ``portbench/metrics/<metric>.py`` (a file
    name may hold dots, so it is loaded by path)."""
    path = Path(root) / PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PKG}_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
