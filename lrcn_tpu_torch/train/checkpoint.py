"""Read a checkpoint that the JAX package wrote (counterpart of the reading
half of ``lrcn_tpu/train/checkpoint.py``).

Format, as written by ``lrcn_tpu.train.checkpoint.save_checkpoint``:

    ckpt_dir/
      params.npz     flattened param pytree, keys are '/'-joined paths
      opt_state.npz  optional optimizer-state leaves (not read here)
      vocab.json
      config.json    LRCNConfig fields + step/epoch metadata
      average_image.npy  joint checkpoints only: the encoder's mean image

A joint (CNN + decoder) checkpoint keeps its parameters under ``cnn/``
and ``decoder/``; the reader builds the decoder from the second and the
VGG encoder from the first.

This reader never writes: it does not roll a crashed save forward (the
JAX package's ``recover_checkpoint`` does).  Saving and optimizer state
come with training.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.models.lrcn import params_from_numpy
from lrcn_tpu_torch.models.vgg import vgg_params_from_numpy
from lrcn_tpu_torch.train.joint import (identity_average_image,
                                        is_joint_checkpoint)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _compute_dtype(cfg: LRCNConfig) -> torch.dtype:
    """The torch dtype named by ``cfg.compute_dtype``."""
    try:
        return _DTYPES[str(cfg.compute_dtype)]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype "
                         f"{cfg.compute_dtype!r}") from None


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    """'/'-joined keys -> nested dicts (``_unflatten_params`` of the JAX
    checkpoint module)."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_checkpoint(path: str, device,
                    compute_dtype: torch.dtype | None = None
                    ) -> dict[str, Any]:
    """Load a checkpoint directory onto ``device``.

    Returns a dict with 'decoder' (an ``LRCNDecoder`` on ``device`` in
    ``compute_dtype``, by default the config's), 'vgg' (a ``VGGEncoder``
    likewise, or None for a decoder-only checkpoint), 'average_image'
    (the joint checkpoint's ``average_image.npy``, zeros if it has none;
    None for a decoder-only checkpoint), 'params' (the flat numpy tree),
    'vocab', 'cfg', 'step' and 'epoch'.
    """
    if not os.path.exists(os.path.join(path, "config.json")):
        raise FileNotFoundError(
            f"{path} is not a complete checkpoint (no config.json)")
    with np.load(os.path.join(path, "params.npz")) as z:
        params = {k: z[k] for k in z.files}
    vocab = Vocab.load(os.path.join(path, "vocab.json"))
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    field_names = {f.name for f in dataclasses.fields(LRCNConfig)}
    cfg = LRCNConfig(**{k: v for k, v in meta.items() if k in field_names})
    if compute_dtype is None:
        compute_dtype = _compute_dtype(cfg)
    tree = _unflatten(params)
    vgg = average_image = None
    if is_joint_checkpoint(tree):
        vgg = vgg_params_from_numpy(tree["cnn"], device, compute_dtype)
        avg_path = os.path.join(path, "average_image.npy")
        average_image = (np.load(avg_path).astype(np.float32)
                         if os.path.exists(avg_path)
                         else identity_average_image())
        tree = tree["decoder"]
    return {"decoder": params_from_numpy(tree, device, compute_dtype),
            "vgg": vgg, "average_image": average_image, "params": params,
            "vocab": vocab, "cfg": cfg, "step": meta.get("step", 0), "epoch": meta.get("epoch", 0)}
