"""What a cell is: its entry in ``BENCHMARK.json`` and the files it names.

A cell (a ``workloads`` entry) names a configuration and a traffic mix;
``configs/<config>.json`` and ``traffic/<traffic>.json`` hold them, and
the mix names its driver, ``drivers/<driver>.py``.  The limits of the
numbers its check compares are ``limits/<cell>.json``.  The metrics a run
reports are the ``end_to_end`` ones (``--trace 0``) or the ``per_layer``
ones (``--trace 1``) that list the cell under ``workloads``, or list no
cells, each read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    def metrics(self, trace: bool) -> list[dict]:
        return self.per_layer if trace else self.end_to_end


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, benchmark: str | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` at the checkout's root."""
    bench = _read_json(benchmark or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = _read_json(os.path.join(BENCH_DIR, "traffic",
                                      f"{cell['traffic']}.json"))
    return Cell(name=name, chips=cell["chips"], config=config,
                traffic=traffic, limits=limits(name),
                end_to_end=[m for m in bench["end_to_end"]
                            if _for_cell(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _for_cell(m, name)])


def limits(cell: str) -> dict:
    """The limit of each number that the cell's check compares,
    ``limits/<cell>.json`` (``{"<number>": {"limit": ...}}``)."""
    data = _read_json(os.path.join(BENCH_DIR, "limits", f"{cell}.json"))
    return {name: entry["limit"] for name, entry in data.items()}


def driver(name: str):
    """The module ``drivers/<name>.py``."""
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str):
    """The ``read(run)`` of ``metrics/<name>.py`` (names may hold dots,
    so the file is loaded by its path)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
