"""Operations and bytes of each layer, computed from shapes alone.

Each module counts the work its layer needs for given shapes, whatever
computes it: ``cost(...) -> (bytes, operations, kind)``, with ``kind``
the peak rate the operations run at (``peaks.json``).  ``bound_s`` is the
least time the card could take: the larger of bytes over the memory rate
and operations over the peak rate of their kind.
"""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def peaks() -> dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def bound_s(nbytes: float, ops: float, kind: str, peak: dict) -> float:
    return max(nbytes / peak["bytes_s"], ops / peak["flops_s"][kind])
