"""Profiling and step timing (counterpart of
``lrcn_tpu/utils/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` around the enclosed block, its
  Chrome trace written into ``logdir`` (viewable in Perfetto or
  ``chrome://tracing``);
- ``device_time_ms(trace_dir)``: the device's busy milliseconds in the
  newest trace there: the union of the CUDA kernels' intervals;
- ``sync(tree)``: wait for the CUDA devices that a nested container of
  tensors lives on;
- ``measure_device_time_ms``: busy milliseconds per call of a function;
- ``StepTimer``: wall-clock step statistics, synchronized only at the
  edges of a step.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    else:
        yield tree


def _cuda_devices(tree) -> set[torch.device]:
    return {leaf.device for leaf in _leaves(tree)
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace (``<ns>.trace.json``) into ``logdir``.  The ops of every
    thread of the process are recorded (a server's threads launch its
    work, not the caller's), and the CUDA device's kernels unless
    ``device`` is the CPU.  Raises for a CUDA device where there is none:
    the trace never leaves the device out in silence."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False: no "
                               "CUDA device to trace")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"{time.time_ns()}.trace.json"))


def sync(tree) -> None:
    """Wait for all work queued on every CUDA device that a tensor among
    the leaves of ``tree`` (nested dicts, lists and tuples) lives on.
    CPU tensors and numpy arrays are ready already.  (The JAX package
    pulls a scalar per leaf, a workaround for TPU runtimes that report
    completion early; CUDA's synchronize does not need it.)"""
    for device in _cuda_devices(tree):
        torch.cuda.synchronize(device)


def _union_us(spans) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def device_time_ms(trace_dir: str) -> float:
    """Busy milliseconds of the device in the newest trace under
    ``trace_dir``: the union of the intervals of its CUDA kernels, so that
    kernels that overlap count once and idle gaps not at all.  A trace
    without CUDA kernels (the CPU's) gives a stand-in: the union of the
    intervals of its CPU ops.  0.0 when no trace file is found.

    Usage::

        with trace("/tmp/t"):
            run(); sync(out)
        ms = device_time_ms("/tmp/t")
    """
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                             recursive=True), key=os.path.basename)
    if not files:
        return 0.0
    with open(files[-1]) as f:
        events = json.load(f).get("traceEvents", [])

    def spans(cat: str) -> list[tuple[float, float]]:
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == cat and e.get("ph") == "X"]

    kernels = spans("kernel")
    return _union_us(kernels if kernels else spans("cpu_op")) / 1e3


def measure_device_time_ms(fn, *args, iters: int = 3,
                           trace_dir: str | None = None) -> float:
    """Busy milliseconds per call of ``fn(*args)``: one warm-up call, then
    a trace of ``iters`` back-to-back calls; the device traced is the CUDA
    device of the arguments or the result, else the CPU."""
    logdir = trace_dir or tempfile.mkdtemp(prefix="lrcn_trace_")
    out = fn(*args)
    sync(out)
    devices = _cuda_devices((args, out))
    with trace(logdir, device=next(iter(devices), "cpu")):
        for _ in range(iters):
            out = fn(*args)
        sync(out)
    return device_time_ms(logdir) / iters


@dataclass
class StepTimer:
    """Accumulates per-step wall times; sync only at measurement edges."""

    _times: list = field(default_factory=list)
    _t0: float | None = None

    def start(self, outputs=None) -> None:
        if outputs is not None:
            sync(outputs)
        self._t0 = time.perf_counter()

    def stop(self, outputs=None) -> float:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        if outputs is not None:
            sync(outputs)
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        self._t0 = None
        return dt

    @property
    def count(self) -> int:
        return len(self._times)

    def mean(self) -> float:
        return float(np.mean(self._times)) if self._times else 0.0

    def percentile(self, p: float) -> float:
        return float(np.percentile(self._times, p)) if self._times else 0.0

    def throughput(self, items_per_step: int) -> float:
        m = self.mean()
        return items_per_step / m if m else 0.0

    def summary(self) -> dict:
        return {
            "steps": self.count,
            "mean_s": round(self.mean(), 6),
            "p50_s": round(self.percentile(50), 6),
            "p95_s": round(self.percentile(95), 6),
        }
