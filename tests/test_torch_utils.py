"""The port's profiling module (``lrcn_tpu_torch/utils/profiling.py``)
against the JAX package's (``lrcn_tpu/utils/profiling.py``), on the CPU:
``StepTimer`` gives the same statistics for the same clock readings,
``sync`` takes nested containers, ``trace`` writes a Chrome trace that
``device_time_ms`` reads, and ``measure_device_time_ms`` is above 0 and
below the traced wall window."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.utils import profiling as jax_profiling
from lrcn_tpu_torch import utils
from lrcn_tpu_torch.utils import profiling


def test_exports_match_jax():
    import lrcn_tpu.utils as jax_utils

    assert utils.__all__ == jax_utils.__all__ == ["StepTimer", "trace"]
    assert utils.StepTimer is profiling.StepTimer


@pytest.mark.parametrize("steps", [0, 1, 4, 7])
def test_step_timer_matches_jax(monkeypatch, steps):
    """Both timers read the same patched ``perf_counter`` sequence: equal
    ``summary()``, ``mean()``, ``percentile()`` and ``throughput()``."""
    rng = np.random.default_rng(steps)
    ticks = np.cumsum(rng.uniform(0.001, 0.2, 2 * steps + 1)).tolist()
    timers = {}
    for name, module, leaf in (("port", profiling, torch.ones(2)),
                               ("jax", jax_profiling, jnp.ones(2))):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = module.StepTimer()
        for _ in range(steps):
            timer.start(leaf)
            timer.stop({"out": [leaf]})
        timers[name] = timer
    port, ref = timers["port"], timers["jax"]
    assert port.count == ref.count == steps
    assert port.summary() == ref.summary()
    assert port.mean() == ref.mean()
    for p in (0, 50, 90, 95, 100):
        assert port.percentile(p) == ref.percentile(p)
    assert port.throughput(256) == ref.throughput(256)


def test_step_timer_stop_without_start_raises():
    with pytest.raises(RuntimeError, match="without start"):
        profiling.StepTimer().stop()


def test_sync_takes_nested_containers():
    profiling.sync({"a": torch.ones(4), "b": [torch.zeros(2, 2),
                                               (np.ones(3), 5)]})
    profiling.sync(np.ones(3))
    profiling.sync([])
    assert profiling._cuda_devices({"a": [torch.ones(1)]}) == set()


def test_device_time_ms_of_an_empty_directory_is_zero(tmp_path):
    assert profiling.device_time_ms(str(tmp_path)) == 0.0


def test_measure_device_time_of_a_cpu_matmul(tmp_path):
    """On the CPU the busy time is the stated stand-in (the union of the
    CPU ops' intervals): above 0 and below the traced wall window, as
    tests/test_utils.py requires of the JAX package's."""
    x = torch.ones(256, 256)
    t0 = time.perf_counter()
    ms = profiling.measure_device_time_ms(lambda a: (a @ a).sum(), x,
                                          iters=4, trace_dir=str(tmp_path))
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert 0.0 < ms < wall_ms / 4
    assert len(list(tmp_path.glob("*.trace.json"))) == 1


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
