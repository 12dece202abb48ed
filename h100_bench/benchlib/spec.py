"""Finding a cell's files by name.

    BENCHMARK.json               the cells, configurations and metrics
    h100_bench/workloads/<cell>.json    config, traffic, driver, limits
    h100_bench/configs/<config>.json    the program's config overlay
    h100_bench/traffic/<traffic>.json   the traffic mix's parameters
    h100_bench/drivers/<driver>.py      one per kind of entry point
    h100_bench/metrics/<metric>.py      one reader per per-layer metric
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from benchlib.env import BENCH_DIR, ROOT


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def import_file(path: Path, name: Optional[str] = None):
    """A module loaded from a file path (names may hold dots)."""
    name = name or "hb_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict          # the BENCHMARK.json workload entry
    workload: dict       # workloads/<name>.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json

    @property
    def driver_path(self) -> Path:
        return BENCH_DIR / "drivers" / f"{self.workload['driver']}.py"

    @property
    def limits(self) -> dict:
        return self.workload.get("limits", {})


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell of that name: its BENCHMARK.json entry and its files."""
    bench = bench if bench is not None else benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"BENCHMARK.json lists no cell {name!r}")
    entry = entries[name]
    wl = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips", "why"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: workload file's {key} {wl[key]!r} "
                             f"!= BENCHMARK.json's {entry[key]!r}")
    return Cell(name, entry, wl,
                load_json(BENCH_DIR / "configs" / f"{entry['config']}.json"),
                load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"))


def end_to_end(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics this cell reports: those listing it, and
    those without a list that move an end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def metric_reader(name: str):
    return import_file(BENCH_DIR / "metrics" / f"{name}.py")
