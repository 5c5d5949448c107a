"""Joint-checkpoint helpers (counterpart of the two helpers at
``lrcn_tpu/train/joint.py:294-301``).

A joint (CNN + decoder) checkpoint, as the JAX package's joint trainer
writes it, holds its parameters under ``cnn/...`` and ``decoder/...``
and its mean image in ``average_image.npy``.  The joint trainer itself
is not ported yet.
"""

from __future__ import annotations

import numpy as np


def is_joint_checkpoint(raw_params: dict) -> bool:
    return isinstance(raw_params, dict) and set(raw_params) >= {
        "cnn", "decoder"}


def identity_average_image() -> np.ndarray:
    """Zero mean image for training without the MatConvNet .mat file."""
    return np.zeros((224, 224, 3), np.float32)
