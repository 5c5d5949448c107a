"""Profiling (counterpart of ``lrcn_tpu/utils/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` around the enclosed block, its
  Chrome trace written into ``logdir`` (viewable in Perfetto or
  ``chrome://tracing``);
- ``span(name)``: a named range of the program's host work in that
  trace, on the clock of the device's kernels and copies; nothing while
  no profiler records;
- ``device_time_ms(trace_dir)``: the device's busy milliseconds in the
  newest trace there: the union of the CUDA kernels' intervals;
- ``sync(tree)``: wait for the CUDA devices that a nested container of
  tensors lives on.

The program's spans are named ``lrcn.<layer>.<phase>`` and nest on each
thread:

- ``lrcn.generate`` (``decode/writer.py:generate_captions``) holds
  ``.table``, ``.enqueue``, ``.fetch`` and ``.detokenize``;
- ``lrcn.extract`` (``data/images.py:extract_features``) holds
  ``.wait_decode``, ``.upload``, ``.readback`` and ``.store``;
- ``lrcn.graph.eager``, ``.capture`` and ``.replay``
  (``utils/graphs.py:run`` and ``step``) sit inside whatever calls them;
- ``lrcn.train.epoch`` (both trainers' ``train_epoch``) holds
  ``lrcn.train.batch``, ``.wait_data``, ``.log`` and ``.sync``.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """A context manager that marks the enclosed host work as ``name``
    (``lrcn.<layer>.<phase>``) in a ``torch.profiler`` trace: while a
    profile records, ``torch.profiler.record_function(name)``, a
    ``user_annotation`` event on the clock of the trace's kernels and
    copies, whose parent is the span that encloses it on the thread;
    else one shared no-op context, which makes no ``RecordFunction`` and
    calls no op.

    "Records" is the profiler's own process-wide flag, set from a
    profile's start to its stop: the thread-local one reads False on
    every thread under ``profile_all_threads`` (:func:`trace`).  On a
    thread that a profile does not record the range records nothing.
    Never open one inside a body that a CUDA graph captures or
    ``torch.export`` traces."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
