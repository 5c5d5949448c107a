"""The port loads nothing of JAX or of ``lrcn_tpu``, and nothing of PIL,
h5py or scipy when it is imported: the machine with the card has neither
JAX nor PIL nor h5py, and the modules that read .mat or .jld files import
scipy or h5py inside the functions that need them.
Checked in a fresh interpreter, since this test process imports JAX
(tests/conftest.py).  Importing needs no ``nvcc`` and no GPU either."""

import ast
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
    "lrcn_tpu_torch.ops.kernels.conv3x3",
    "lrcn_tpu_torch.models.lrcn",
    "lrcn_tpu_torch.models.vgg",
    "lrcn_tpu_torch.data.images",
    "lrcn_tpu_torch.train.joint",
    "lrcn_tpu_torch.decode.beam",
    "lrcn_tpu_torch.decode.writer",
    "lrcn_tpu_torch.data.feature_store",
    "lrcn_tpu_torch.train.checkpoint",
    "lrcn_tpu_torch.serve.batcher",
    "lrcn_tpu_torch.serve.service",
    "lrcn_tpu_torch.core.tokenizer",
    "lrcn_tpu_torch.data.batcher",
    "lrcn_tpu_torch.data.pipeline",
    "lrcn_tpu_torch.decode.sample",
    "lrcn_tpu_torch.train.metrics",
    "lrcn_tpu_torch.train.trainer",
    "lrcn_tpu_torch.models.joint",
    "lrcn_tpu_torch.native",
    "lrcn_tpu_torch.evaluation",
    "lrcn_tpu_torch.evaluation.bleu",
    "lrcn_tpu_torch.evaluation.references",
    "lrcn_tpu_torch.core",
    "lrcn_tpu_torch.data",
    "lrcn_tpu_torch.decode",
    "lrcn_tpu_torch.models",
    "lrcn_tpu_torch.ops",
    "lrcn_tpu_torch.train",
    "lrcn_tpu_torch.cli",
    "lrcn_tpu_torch.data.karpathy",
    "lrcn_tpu_torch.data.jld",
    "lrcn_tpu_torch.data.download",
    "lrcn_tpu_torch.serve.http",
    "lrcn_tpu_torch.serve.native_http",
    "lrcn_tpu_torch.utils",
    "lrcn_tpu_torch.utils.profiling",
]


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


PORT_FORBIDDEN = ("jax", "jaxlib", "lrcn_tpu", "PIL", "h5py", "scipy")
# chip_smoke.py writes a .mat file with scipy (the card's machine has it)
SCRIPT_FORBIDDEN = ("jax", "jaxlib", "lrcn_tpu", "PIL", "h5py")


def _imports_nothing_forbidden(modules: list[str],
                               forbidden=PORT_FORBIDDEN) -> str:
    """Code that imports ``modules`` and fails if a package of
    ``forbidden`` (by default JAX, ``lrcn_tpu``, PIL, h5py and scipy) was
    loaded."""
    return (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {forbidden!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n")


def test_port_loads_no_jax_and_no_lrcn_tpu():
    proc = _run(_imports_nothing_forbidden(SLICE_MODULES))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax_and_no_pil():
    """Every module that chip_smoke.py imports, at top level or inside its
    phases (phase 14's C++ front end, load generator and profiling module
    among them), loads nothing of JAX, ``lrcn_tpu`` or PIL."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    modules = sorted({alias.name for node in ast.walk(tree)
                      if isinstance(node, ast.Import)
                      for alias in node.names}
                     | {node.module for node in ast.walk(tree)
                        if isinstance(node, ast.ImportFrom)
                        and node.level == 0 and node.module != "__future__"})
    assert {"lrcn_tpu_torch.models.vgg", "lrcn_tpu_torch.native",
            "lrcn_tpu_torch.utils.profiling"} <= set(modules)
    # phase 14's front end, which ``serve.native_frontend`` loads at call
    proc = _run(_imports_nothing_forbidden(
        modules + ["lrcn_tpu_torch.serve.native_http", "chip_smoke"],
        SCRIPT_FORBIDDEN))
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


@pytest.mark.parametrize("first", ["lrcn_tpu_torch.models.joint",
                                   "lrcn_tpu_torch.train.joint",
                                   "lrcn_tpu_torch.train.checkpoint"])
def test_joint_modules_import_in_any_order(first):
    """The joint step imports the trainer's package, whose checkpoint
    reader loads the joint trainer lazily: no import cycle, whichever
    module comes first; ``lrcn_tpu_torch.train.JointTrainer`` resolves."""
    proc = _run(f"import {first}\n"
                "import lrcn_tpu_torch.train as t\n"
                "from lrcn_tpu_torch.models.joint import JointTrainStep\n"
                "assert t.JointTrainer.__module__ == "
                "'lrcn_tpu_torch.train.joint'\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
