"""The kernel wrappers' launch counters, and their accounting when a
launch runs inside a captured CUDA graph.

Every wrapper (``fused_lstm_step``, ``topk_logsumexp``,
``fused_conv3x3_relu``) carries ``.launches`` and ``.launches_by_route``,
and its CUDA implementation calls :func:`count` once where it launches
its kernel.  A graph replay runs no Python, so a captured call is counted
from the graph instead (``utils/graphs.py``): its warm-up and its capture
run inside :func:`recording`, which keeps their launches out of the
counters, and each replay adds what the capture recorded with
:func:`add`.  Either way one call counts each kernel it launches once.
"""

from __future__ import annotations

import contextlib
import threading

_lock = threading.Lock()
_local = threading.local()


def count(wrapper, route: str) -> None:
    """One launch of ``wrapper``'s kernel on ``route``: into this thread's
    recording where one is open, else into the wrapper's counters."""
    record = getattr(_local, "record", None)
    if record is not None:
        record[wrapper, route] = record.get((wrapper, route), 0) + 1
        return
    with _lock:
        wrapper.launches += 1
        wrapper.launches_by_route[route] += 1


@contextlib.contextmanager
def recording():
    """Count this thread's launches into the dict yielded, ``{(wrapper,
    route): n}``, and not into the counters, until the block ends."""
    outer = getattr(_local, "record", None)
    _local.record = record = {}
    try:
        yield record
    finally:
        _local.record = outer


def add(record: dict) -> None:
    """Add a recording's launches to the counters (a graph's replay)."""
    with _lock:
        for (wrapper, route), n in record.items():
            wrapper.launches += n
            wrapper.launches_by_route[route] += n
