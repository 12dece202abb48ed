"""BENCHMARK.json against the benchmark's contract, and every file a
cell names found by name."""

import json
import re

import pytest

from benchlib import spec
from benchlib.env import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.benchmark()


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") \
            and ".." not in word
    files = [w for w in BENCH["command"] if "/" in w]
    assert all(f.startswith("h100_bench/") for f in files)
    assert all((ROOT / f).exists() for f in files)


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in BENCH["end_to_end"]:
        allowed |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert LINE.match(m["layer"])
    assert set(m) <= allowed
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells


def test_setup_is_reported_by_every_cell():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and LINE.match(w["why"])
    cell = spec.cell(w["name"], BENCH)
    assert cell.driver_path.exists()
    assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
    for m in spec.per_layer(BENCH, w["name"]):
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert hasattr(spec.metric_reader(m["name"]), "read")
    e2e = [m["name"] for m in spec.end_to_end(BENCH, w["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(BENCH, w["name"])


def test_cells_are_unique_pairs_on_one_chip():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_by_every_listed_cell(m):
    for cell in m["workloads"]:
        names = [e["name"] for e in spec.end_to_end(BENCH, cell)]
        assert m["moves"] in names, (m["name"], cell)


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert LINE.match(c["source"]) and len(c["reduced"]) <= 16
    assert c["file"].startswith("h100_bench/configs/")
    data = json.loads((ROOT / c["file"]).read_text())
    assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    files = [x["file"] for x in BENCH["configs"]]
    assert len(files) == len(set(files))
