"""The device's timeline over the window, from ``torch.profiler``.

The window is the host span ``portbench.window``; device operations are
the trace's kernels, copies and sets, clipped to it.  ``busy_s`` is the
union of their intervals (overlapping operations count once; the
arithmetic of ``lrcn_tpu_torch/utils/profiling.py:device_time_ms``, with
copies and sets counted as the device's work too).  An idle gap is named
by the innermost host operation running at its middle: what the host was
doing while the device waited.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
NAME_CHARS = 64          # a breakdown entry's name, cut to this length


class Timeline:
    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("ph") == "X"]
        window = [e for e in spans if e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation"]
        if not window:
            raise RuntimeError(f"the trace has no {WINDOW} span")
        self.t0 = float(window[0]["ts"])
        self.t1 = self.t0 + float(window[0]["dur"])
        self.window_s = (self.t1 - self.t0) / 1e6
        self.device = []          # (start, end, name) in us, clipped
        for e in spans:
            if e.get("cat") not in DEVICE_CATS:
                continue
            start = max(float(e["ts"]), self.t0)
            end = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if end > start:
                self.device.append((start, end, e.get("name", "")))
        self.device.sort()
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in spans if e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW)
        self._host_starts = [h[0] for h in self.host]
        self.busy_s, self.gaps = self._union()

    def _union(self) -> tuple[float, list[tuple[float, float]]]:
        busy, gaps, end = 0.0, [], self.t0
        for start, stop, _ in self.device:
            if start > end:
                gaps.append((end, start))
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        if self.t1 > end:
            gaps.append((end, self.t1))
        return busy / 1e6, gaps

    def kernel_s(self, patterns) -> float:
        """Device seconds of the kernels whose names hold any of
        ``patterns``."""
        return sum(end - start for start, end, name in self.device
                   if any(p in name for p in patterns)) / 1e6

    def _host_at(self, t: float) -> str:
        i = bisect.bisect_right(self._host_starts, t)
        for start, stop, name in reversed(self.host[max(0, i - 256):i]):
            if stop >= t:
                return name
        return "host outside traced ops"

    def breakdown(self, top: int = 10) -> dict:
        ops: dict[str, float] = {}
        for start, end, name in self.device:
            key = name[:NAME_CHARS]
            ops[key] = ops.get(key, 0.0) + (end - start) / 1e6
        idle: dict[str, float] = {}
        for start, end in self.gaps:
            key = self._host_at((start + end) / 2)[:NAME_CHARS]
            idle[key] = idle.get(key, 0.0) + (end - start) / 1e6
        ranked = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


@contextlib.contextmanager
def profiled(enabled: bool, out_dir: str):
    """Profile the block (CPU ops and, with a card, the CUDA device) when
    ``enabled``;
    yields a list that holds the ``Timeline`` once the block has ended.
    The Chrome trace is written under ``out_dir`` and deleted once read."""
    holder: list[Timeline] = []
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield holder
    finally:
        prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "window.trace.json")
    prof.export_chrome_trace(path)
    del prof
    try:
        with open(path) as f:
            holder.append(Timeline(json.load(f).get("traceEvents", [])))
    finally:
        os.remove(path)


def window_span():
    return torch.profiler.record_function(WINDOW)
