"""Everything a cell is made of, found by name from ``BENCHMARK.json``:

- ``configs/<config>.json``: the configuration as it is run; its
  ``problem`` names the reference problem ``reference/problems/<problem>.py``
  (a module with ``make(config)``);
- ``traffic/<traffic>.json``: the traffic mix's parameters; its ``kind``
  names the code that drives that kind of traffic, ``kinds/<kind>.py``
  (a ``Job`` class and the ``KEYS`` its mixes may set);
- ``limits/<workload>.json``: the numbers the output check compares, each
  with its limit; each number is read by ``checks/<number>.py``;
- ``metrics/<metric>.py``: one reader per metric, end-to-end or
  per-layer, with a function ``read(run)`` that returns a number or None.

A later cell, mix, kind, problem, check or metric is new files and new
entries; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: Path


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_dir: Path = BENCH_DIR,
              root: Path | None = None) -> Cell:
    """The cell named ``workload`` of ``<root>/BENCHMARK.json``."""
    root = root or bench_dir.parent
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(bench_dir / "limits" / f"{workload}.json")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
        bench_dir=bench_dir)


def load_module(folder: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<bench_dir>/<folder>/<name>.py``."""
    path = bench_dir / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {folder}/{name}.py under {bench_dir}")
    tag = "".join(c if c.isalnum() else "_" for c in f"{folder}_{name}")
    spec = importlib.util.spec_from_file_location(f"bench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    return load_module("metrics", name, bench_dir).read


def check_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``checks/<name>.py``."""
    return load_module("checks", name, bench_dir).read


def kind(name: str, bench_dir: Path = BENCH_DIR):
    """The traffic kind ``kinds/<name>.py``."""
    return load_module("kinds", name, bench_dir)


def problem(config: dict, bench_dir: Path = BENCH_DIR):
    """The reference's own operator of a configuration."""
    return load_module("reference/problems", config["problem"],
                       bench_dir).make(config)
