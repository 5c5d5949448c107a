"""Structured metrics logging: a copy of ``lrcn_tpu.train.metrics``, kept
here so that this package loads nothing of ``lrcn_tpu`` (the JAX
module is plain Python, but ``lrcn_tpu/train/__init__.py`` imports JAX).

Replaces the reference's append-only datasheet file with a hard-coded name
(``coco_e750_h700750_p_0.0.out``, lrcn.jl:237-239) with a JSONL writer:
one JSON object per line, flushed on every write so logs survive crashes.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, TextIO


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = True):
        self._file: TextIO | None = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.time()

    def log(self, **values: Any) -> dict[str, Any]:
        record = {"time": round(time.time() - self._t0, 3)}
        record.update(values)
        line = json.dumps(record, default=float)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        if self._echo:
            print(line, file=sys.stderr)
        return record

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
