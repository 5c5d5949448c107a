"""Read a checkpoint that the JAX package wrote (counterpart of the reading
half of ``lrcn_tpu/train/checkpoint.py``).

Format, as written by ``lrcn_tpu.train.checkpoint.save_checkpoint``:

    ckpt_dir/
      params.npz     flattened param pytree, keys are '/'-joined paths
      opt_state.npz  optional optimizer-state leaves (not read here)
      vocab.json
      config.json    LRCNConfig fields + step/epoch metadata

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

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _compute_dtype(cfg: LRCNConfig) -> torch.dtype:
    """The torch dtype named by ``cfg.compute_dtype``."""
    try:
        return _DTYPES[str(cfg.compute_dtype)]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype "
                         f"{cfg.compute_dtype!r}") from None


def load_checkpoint(path: str, device,
                    compute_dtype: torch.dtype | None = None
                    ) -> dict[str, Any]:
    """Load a checkpoint directory onto ``device``.

    Returns a dict with 'decoder' (an ``LRCNDecoder`` on ``device`` in
    ``compute_dtype``, by default the config's), 'params' (the flat numpy
    tree), 'vocab', 'cfg', 'step' and 'epoch'.
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
    return {"decoder": params_from_numpy(params, device, compute_dtype),
            "params": params, "vocab": vocab, "cfg": cfg,
            "step": meta.get("step", 0), "epoch": meta.get("epoch", 0)}
