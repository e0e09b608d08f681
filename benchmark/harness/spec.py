"""Where the benchmark finds its parts, by the names in BENCHMARK.json:

  benchmark/configs/<config>.json   a deployment: monomer set, array, CLI settings
  benchmark/traffic/<traffic>.json  a mix: loop, clients, jobs, warm-up, check sample
  benchmark/metrics/<metric>.py     a reader: `read(run)` -> number or None

A later change adds a configuration, a mix or a metric by adding its file
and its entry in BENCHMARK.json; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH_DIR = ROOT / "benchmark"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"known: {', '.join(w['name'] for w in bench['workloads'])}")


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those that list the cell, or list no cells."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """The `read` function of benchmark/metrics/<name>.py."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"sdbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
