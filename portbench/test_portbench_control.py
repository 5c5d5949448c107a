"""The control and the planted faults must fail the cells' limits.

On the CPU at the tiny size (``tiny.py``) the planted faults are read
through ``control.py`` and must each fail one of the cell's numbers.  On
the card (marker ``card``) the control itself runs at each cell's own
size: the fp8 reference, and every fault, must each fail one number."""

from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench.harness import spec
from portbench.tiny import tiny_cell

CELLS = ("coco-fc7-generate", "vgg16-coco-caption", "coco-fc7-train",
         "vgg16-coco-joint-train")
SEED = 3_100_000_019


def fails(readings: dict, limits: dict) -> bool:
    return any(value > limits[name] for name, value in readings.items()
               if name in limits)


@pytest.mark.parametrize("name", CELLS)
def test_planted_faults_fail_a_number_at_the_tiny_size(name):
    cell = tiny_cell(name)
    found = control.readings(cell, SEED, "cpu")
    assert "control_fp8" in found
    faults = {k: v for k, v in found.items() if k.startswith("fault_")}
    assert faults
    for fault, readings in faults.items():
        assert fails(readings, cell.limits), (fault, readings)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    cell = spec.load_cell(name)
    found = control.readings(cell, SEED, "cuda")
    for key, readings in found.items():
        if key.startswith(("control_", "fault_")):
            assert fails(readings, cell.limits), (key, readings)
