"""One run of one cell: set up, measure for ``--seconds``, check, report.

1. The driver builds the program's objects from the seed and warms up
   every shape the window uses (``setup``).  ``setup_s`` runs from the
   process's start to here.
2. The window: the driver's ``unit()`` over and over, until ``--seconds``
   have passed at the end of one; each unit ends in a synchronize.  With
   ``--trace 1`` the window is profiled.
3. ``memory_peak_bytes`` is read, the program's state freed
   (``release()``), and the driver's ``check()`` compares what the window
   produced with the plain reference: each number beside its limit.
4. The metrics of the cell are read by their files, and one JSON line is
   printed last.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

from portbench.harness import spec as specs
from portbench.harness import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "lrcn_tpu")
OUT_DIR = os.path.join(specs.ROOT, "build", "portbench")


@dataclasses.dataclass
class Context:
    """What a driver's ``setup`` gets: the cell's files and the seed."""
    seed: int
    device: object
    config: dict
    traffic: dict
    limits: dict
    started: float = 0.0

    def note(self, what: str) -> None:
        """Print to stderr how far into the set-up ``what`` is done."""
        print(f"setup: {what} by {time.time() - self.started:.2f} s",
              file=sys.stderr)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a metric's ``read(run)`` gets."""
    config: dict
    traffic: dict
    counts: dict
    window_s: float
    setup_s: float
    timeline: tracing.Timeline | None
    peaks: dict


def process_start() -> float:
    """This process's start on ``time.time()``'s clock (from /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - started)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def measure(cell: specs.Cell, seed: int, seconds: float, trace: bool,
            device, started: float) -> dict:
    """Run the cell once on ``device``; returns the result's fields."""
    import torch

    from portbench import work

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    driver = specs.driver(cell.traffic["driver"])
    ctx = Context(seed=seed, device=torch.device(device),
                  config=cell.config, traffic=cell.traffic,
                  limits=cell.limits, started=started)
    ctx.note("imports")
    work_ = driver.setup(ctx)
    sync()
    setup_s = time.time() - started

    card = _card_state() if cuda else None
    ends = []
    with tracing.profiled(trace, OUT_DIR) as timeline:
        with tracing.window_span():
            t0 = time.perf_counter()
            while True:
                work_.unit()
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
            sync()
            window_s = time.perf_counter() - t0
    units = [b - a for a, b in zip([0.0] + ends, ends)]
    print(f"window: {len(units)} units in {window_s:.4f} s, unit s min "
          f"{min(units):.4f} median {sorted(units)[len(units) // 2]:.4f} "
          f"max {max(units):.4f}; card before {card}, after "
          f"{_card_state() if cuda else None}", file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    counts = work_.counts()
    work_.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = work_.check()

    run = Run(config=cell.config, traffic=cell.traffic, counts=counts,
              window_s=window_s, setup_s=setup_s,
              timeline=timeline[0] if timeline else None,
              peaks=work.peaks())
    metrics = {}
    for m in cell.metrics(trace):
        value = specs.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c.passed for c in checks),
        "attempted": counts["attempted"],
        "failed": counts["failed"],
        "metrics": metrics,
        "device": _device(cuda, memory_peak, run.timeline),
    }
    if run.timeline is not None:
        result["breakdown"] = run.timeline.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def _card_state() -> str | None:
    """The card's SM clock, temperature and power (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,"
             "power.draw,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def _device(cuda: bool, memory_peak: int, timeline) -> dict:
    import torch

    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    if timeline is not None:
        out["busy_s"] = timeline.busy_s
        out["window_s"] = timeline.window_s
    return out


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str]) -> int:
    started = process_start()
    args = parse(argv)
    cell = specs.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = measure(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
