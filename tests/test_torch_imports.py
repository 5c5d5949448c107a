"""The port loads nothing of JAX or of ``lrcn_tpu``: the machine with the
card has no JAX.  Checked in a fresh interpreter, since this test process
imports JAX (tests/conftest.py)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "lrcn_tpu_torch",
    "lrcn_tpu_torch.config",
    "lrcn_tpu_torch.core.vocab",
    "lrcn_tpu_torch.ops.lstm",
    "lrcn_tpu_torch.ops.kernels.build",
    "lrcn_tpu_torch.ops.kernels.lstm_step",
    "lrcn_tpu_torch.ops.kernels.topk_lse",
    "lrcn_tpu_torch.models.lrcn",
    "lrcn_tpu_torch.decode.beam",
    "lrcn_tpu_torch.decode.writer",
    "lrcn_tpu_torch.data.feature_store",
    "lrcn_tpu_torch.train.checkpoint",
    "lrcn_tpu_torch.serve.batcher",
    "lrcn_tpu_torch.serve.service",
]


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_loads_no_jax_and_no_lrcn_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'lrcn_tpu.'))\n"
        "             or m == 'lrcn_tpu')\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    """chip_smoke.py exits nonzero and prints no result without CUDA."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
