"""The port's profiling module (``lrcn_tpu_torch/utils/profiling.py``),
on the CPU: its exports, ``sync`` takes nested containers, and ``trace``
writes a Chrome trace that ``device_time_ms`` reads.  Its spans are in
``tests/test_torch_spans.py``."""

import time

import numpy as np
import pytest
import torch

from lrcn_tpu_torch import utils
from lrcn_tpu_torch.utils import profiling


def test_exports_match_jax():
    """The port exports its own profiling surface: ``span`` and
    ``trace``.  The JAX package's step timers have no counterpart here,
    as nothing of the port reads them."""
    assert utils.__all__ == ["span", "trace"]
    assert utils.span is profiling.span and utils.trace is profiling.trace
    for gone in ("StepTimer", "measure_device_time_ms"):
        assert not hasattr(profiling, gone)
        assert not hasattr(utils, gone)


def test_sync_takes_nested_containers():
    profiling.sync({"a": torch.ones(4), "b": [torch.zeros(2, 2),
                                               (np.ones(3), 5)]})
    profiling.sync(np.ones(3))
    profiling.sync([])
    assert profiling._cuda_devices({"a": [torch.ones(1)]}) == set()


def test_device_time_ms_of_an_empty_directory_is_zero(tmp_path):
    assert profiling.device_time_ms(str(tmp_path)) == 0.0


def test_trace_unions_overlapping_kernels(tmp_path):
    """device_time_ms reads the newest trace and counts a span covered by
    two kernels once; the record_function ranges and CPU ops of a trace
    with kernels are not device time."""
    import json

    events = [{"ph": "X", "cat": "kernel", "ts": 100.0, "dur": 50.0},
              {"ph": "X", "cat": "kernel", "ts": 120.0, "dur": 50.0},
              {"ph": "X", "cat": "kernel", "ts": 300.0, "dur": 10.0},
              {"ph": "X", "cat": "gpu_user_annotation", "ts": 0.0,
               "dur": 1000.0},
              {"ph": "X", "cat": "cpu_op", "ts": 0.0, "dur": 1000.0}]
    (tmp_path / "1.trace.json").write_text(json.dumps(
        {"traceEvents": [events[0]]}))
    (tmp_path / "2.trace.json").write_text(json.dumps(
        {"traceEvents": events}))
    assert profiling.device_time_ms(str(tmp_path)) == pytest.approx(0.08)


def test_trace_records_the_ops_of_other_threads(tmp_path):
    """A server's threads launch its work, not the thread that traces: a
    window in which only another thread computes is busy."""
    import threading

    stop = threading.Event()

    def work():
        x = torch.ones(128, 128)
        while not stop.is_set():
            (x @ x).sum()

    worker = threading.Thread(target=work)
    worker.start()
    try:
        time.sleep(0.05)
        t0 = time.perf_counter()
        with profiling.trace(str(tmp_path), device="cpu"):
            time.sleep(0.2)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        stop.set()
        worker.join(timeout=30)
    assert not worker.is_alive()
    assert 0.0 < profiling.device_time_ms(str(tmp_path)) < wall_ms


def test_trace_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        with profiling.trace(str(tmp_path)):
            pass
    with profiling.trace(str(tmp_path), device="cpu"):
        torch.ones(8).sum()
    assert len(list(tmp_path.glob("*.trace.json"))) == 1
