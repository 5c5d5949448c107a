"""BENCHMARK.json against the benchmark's contract, and the files it
names.  CPU only."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from portbench.harness import spec

BENCH = os.path.join(spec.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "lrcn_tpu"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(BENCH) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == TOP_KEYS
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert os.path.getsize(BENCH) <= 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in bench[group]]
        assert len(group_names) == len(set(group_names)), group
    for text in ([w["why"] for w in bench["workloads"] + bench["configs"]]
                 + [m["layer"] for m in bench["per_layer"]]
                 + [c["source"] for c in bench["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_another_and_a_layer(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer


def test_per_layer_metrics_list_cells_that_report_what_they_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["workloads"], m["name"]
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)


def test_files_exist_and_configs_are_used(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            config = json.load(f)
        for key in c["reduced"]:
            assert key in config
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        driver = spec.driver(cell.traffic["driver"])
        assert callable(driver.setup)
        assert cell.limits


def test_run_seconds_fit_a_full_check_of_24_cells(bench):
    s = bench["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    return found


def _sources(sub: str = ""):
    top = os.path.join(spec.BENCH_DIR, sub)
    for dirpath, _, files in os.walk(top):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert not _imports(path) & (FORBIDDEN | {"lrcn_tpu_torch"}), path


def test_a_run_loads_no_jax(tmp_path):
    """A tiny run of every cell in a fresh interpreter, then
    ``sys.modules`` by whole top-level names."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {spec.ROOT!r})\n"
        "from portbench.tiny import tiny_cell\n"
        "from portbench.harness.main import measure, forbidden_modules\n"
        "for name in ('coco-fc7-generate', 'coco-fc7-train'):\n"
        "    measure(tiny_cell(name), 3, 0.0, False, 'cpu', time.time())\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=tmp_path,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout.strip().splitlines()[-1] == "[]"
