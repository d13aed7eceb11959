"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` takes ``configs/<config>.json`` (through
the configuration's ``file``), ``traffic/<traffic>.json`` and
``limits/<cell>.json``; a mix's ``entry`` is driven by
``drivers/<entry>.py``; a metric ``<name>`` is read by
``metrics/<name>.py``'s ``read(record)``. Nothing here lists them: a new
cell, mix, kind of traffic or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HARNESS = "portbench"  # the benchmark's folder in a checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # BENCHMARK.json entries of the metrics this run reports


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, trace: bool) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    here = root / HARNESS
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, limits, metrics)


def _load(root: Path, folder: str, name: str):
    path = root / HARNESS / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load(root, "metrics", name).read


def driver(root: Path, entry: str):
    """The module ``drivers/<entry>.py``: its ``plan`` and ``build``."""
    return _load(root, "drivers", entry)
