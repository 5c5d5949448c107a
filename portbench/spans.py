"""The device's idle time under the program's spans.

The program marks its host loops and graph dispatch with spans named
``lrcn.<layer>.<phase>`` (``lrcn_tpu_torch/utils/profiling.py:span``),
``user_annotation`` events of the window's trace on the clock of its
kernels and copies.  For each instant of each idle gap of the window
(``Timeline.gaps``) the innermost program span is the latest-started
``lrcn.*`` event that holds the instant (of two that start together, the
shorter).  Torch's own ops are left out, and an enclosing span counts
however many events started between it and the gap: the split is an
exact sweep over the spans' intervals, not the breakdown's look-back.
A trace of a program without spans gives no split, and no share.
"""

from __future__ import annotations

import bisect
import heapq

PREFIX = "lrcn."


def _innermost(spans: list[tuple[float, float, str]]
               ) -> list[tuple[float, float, str | None]]:
    """Consecutive pieces of time, each with its innermost span (None
    where no span runs)."""
    points = sorted({p for start, end, _ in spans for p in (start, end)})
    spans = sorted(spans)
    active: list = []        # (-start, end, name): the innermost on top
    pieces, i = [], 0
    for a, b in zip(points, points[1:]):
        while i < len(spans) and spans[i][0] <= a:
            start, end, name = spans[i]
            heapq.heappush(active, (-start, end, name))
            i += 1
        while active and active[0][1] <= a:
            heapq.heappop(active)
        pieces.append((a, b, active[0][2] if active else None))
    return pieces


def idle_by_span(timeline) -> dict[str | None, float]:
    """Idle seconds of the window by innermost program span: a key for
    every program span that ran inside the window (0.0 where the device
    never idled under it), and None for the idle time under no span.
    Empty when no program span ran inside the window."""
    spans = [(max(start, timeline.t0), min(end, timeline.t1), name)
             for start, end, name in timeline.host
             if name.startswith(PREFIX) and end > timeline.t0
             and start < timeline.t1 and end > start]
    if not spans:
        return {}
    idle = dict.fromkeys((name for *_, name in spans), 0.0)
    idle[None] = 0.0
    pieces = _innermost(spans)
    starts = [p[0] for p in pieces]
    for g0, g1 in timeline.gaps:
        covered = 0.0
        j = max(0, bisect.bisect_right(starts, g0) - 1)
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            overlap = min(b, g1) - max(a, g0)
            if overlap > 0:
                idle[name] += overlap / 1e6
                covered += overlap
            j += 1
        idle[None] += (g1 - g0 - covered) / 1e6
    return idle


def idle_share(run, names: tuple[str, ...]) -> float | None:
    """The share of the window (%) in which the device was idle and the
    innermost program span was one of ``names``; None without a trace or
    where none of ``names`` ran inside the window."""
    if run.timeline is None:
        return None
    idle = idle_by_span(run.timeline)
    if not any(n in idle for n in names):
        return None
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / (
        run.timeline.window_s)
