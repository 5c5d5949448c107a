"""Checkpoints in the JAX package's format (counterpart of
``lrcn_tpu/train/checkpoint.py``): either package resumes the other's.

    ckpt_dir/
      params.npz     flattened param tree, keys are '/'-joined paths
      opt_state.npz  optional optimizer-state leaves, keys 'leaf_<i>'
      vocab.json
      config.json    LRCNConfig fields + step/epoch metadata (+ position)
      average_image.npy  joint checkpoints only: the encoder's mean image

``opt_state.npz`` holds optax's leaves of ``chain([clip_by_global_norm,]
adam)``, in optax's order: ``leaf_0`` the step count (int32 scalar),
``leaf_1..9`` Adam's first moments and ``leaf_10..18`` its second
moments, each over the parameters in sorted key order (``OPT_KEYS``).  A
joint checkpoint holds the joint optimizer's 80 leaves (the CNN's Adam,
then the decoder's; ``models/joint.py``), or 19 with the CNN frozen.

``save_checkpoint`` writes a complete snapshot to ``path.tmp``, then swaps
it into place (``path`` -> ``path.old``, ``path.tmp`` -> ``path``), with
``config.json`` written last to mark it complete; ``load_checkpoint``
first rolls a crashed save forward (``recover_checkpoint``), as the JAX
package does.  A mid-epoch position keeps numpy's shuffle state, which
both packages draw from alike, and this package's own epoch key (a 64-bit
integer stored as two uint32 words, the shape of a JAX key): a position
resumes bit-exactly in the package that wrote it.

A joint (CNN + decoder) checkpoint keeps its parameters under ``cnn/``
and ``decoder/``; the reader builds the decoder from the second and the
VGG encoder from the first.  A checkpoint whose ``config.json`` has
``"decoder": "moe_text"`` holds the MoE text decoder
(``models/moe_text.py``, a ``MoETextConfig``), for generation only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Mapping

import numpy as np
import torch

from lrcn_tpu_torch.config import LRCNConfig, MoETextConfig
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.models.lrcn import (PARAM_KEYS, flat_tree,
                                        params_from_numpy)
from lrcn_tpu_torch.models.moe_text import MoETextDecoder
from lrcn_tpu_torch.models.vgg import vgg_params_from_numpy

# optax's flattening order of a parameter dict: sorted keys
OPT_KEYS = tuple(sorted(PARAM_KEYS))

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype_of(cfg: LRCNConfig) -> torch.dtype:
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


def _complete(path: str) -> bool:
    return os.path.exists(os.path.join(path, "config.json"))


def _write_checkpoint(path: str, params: dict[str, np.ndarray], vocab: Vocab,
                      cfg: LRCNConfig, opt_leaves: list | None, step: int,
                      epoch: int, position: dict | None,
                      extra_files: dict[str, np.ndarray]) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **params)
    if opt_leaves is not None:
        np.savez(os.path.join(path, "opt_state.npz"),
                 **{f"leaf_{i}": np.asarray(l)
                    for i, l in enumerate(opt_leaves)})
    vocab.save(os.path.join(path, "vocab.json"))
    for name, arr in extra_files.items():
        np.save(os.path.join(path, name), arr)
    meta = dataclasses.asdict(cfg)
    meta.update(step=step, epoch=epoch)
    if position is not None:
        meta["position"] = position
    # config.json is written LAST: its presence marks a complete save
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta, f, default=str)


def save_checkpoint(path: str, params: Mapping, vocab: Vocab,
                    cfg: LRCNConfig, opt_state: Any = None, step: int = 0,
                    epoch: int = 0, position: dict | None = None) -> None:
    """Crash-safe checkpoint save: write a complete snapshot to
    ``path.tmp``, then swap it into place, so that a kill at any instant
    leaves a loadable checkpoint (``load_checkpoint`` rolls it forward).

    ``params``: an ``LRCNParams``, a ``JointParams`` (saved under
    ``cnn/`` and ``decoder/``) or any nested or flat mapping of tensors or
    arrays.  ``opt_state``: the trainer's ``Optimizer``, the joint
    trainer's optimizer state, or a list of optax-ordered leaves.
    ``position``: the mid-epoch resume marker of a step-interval save
    (``make_position``); absent on epoch-complete saves, which is what
    marks the epoch finished.  ``*.npy`` files already in ``path`` (e.g.
    ``average_image.npy``) are kept.
    """
    path = os.path.normpath(path)   # "ck/" + ".tmp" would land inside ck
    flat = {k: np.asarray(v, np.float32) for k, v in flat_tree(params).items()}
    opt_leaves = None
    if opt_state is not None:
        opt_leaves = (opt_state.state_leaves()
                      if hasattr(opt_state, "state_leaves")
                      else list(opt_state))
    extra_files = {}
    if os.path.isdir(path):
        for name in os.listdir(path):
            if name.endswith(".npy"):
                extra_files[name] = np.load(os.path.join(path, name))

    tmp, old = path + ".tmp", path + ".old"
    shutil.rmtree(tmp, ignore_errors=True)
    _write_checkpoint(tmp, flat, vocab, cfg, opt_leaves, step, epoch,
                      position, extra_files)
    if _complete(path):
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    elif os.path.isdir(path):   # partial non-atomic leftovers: discard
        shutil.rmtree(path)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def recover_checkpoint(path: str) -> str | None:
    """Roll a crashed ``save_checkpoint`` forward; returns the loadable
    path or None.  Precedence: complete ``path.tmp`` (strictly newer) >
    intact ``path`` > ``path.old`` (crash mid-swap)."""
    path = os.path.normpath(path)
    tmp, old = path + ".tmp", path + ".old"
    for candidate in (tmp, path, old):
        if _complete(candidate):
            if candidate != path:
                if os.path.isdir(path):
                    shutil.rmtree(path)
                os.rename(candidate, path)
            break
    for leftover in (tmp, old):
        shutil.rmtree(leftover, ignore_errors=True)
    return path if _complete(path) else None


def load_checkpoint(path: str, device,
                    compute_dtype: torch.dtype | None = None,
                    opt_state: bool = True) -> dict[str, Any]:
    """Load a checkpoint directory onto ``device``, first rolling a crashed
    save forward.

    Returns a dict with 'decoder' (an ``LRCNDecoder`` on ``device`` in
    ``compute_dtype``, by default the config's), 'vgg' (a ``VGGEncoder``
    likewise, or None for a decoder-only checkpoint), 'average_image'
    (the joint checkpoint's ``average_image.npy``, zeros if it has none;
    None for a decoder-only checkpoint), 'params' (the flat numpy tree;
    ``LRCNParams.from_numpy`` makes it trainable), 'vocab', 'cfg', 'step',
    'epoch', 'opt_leaves' (list or None; not read with ``opt_state=False``,
    which inference passes: a joint checkpoint's optimizer leaves are twice
    its parameters) and 'position' (a mid-epoch resume marker or None).
    """
    # the joint trainer's module imports this one: import it here
    from lrcn_tpu_torch.train.joint import (identity_average_image,
                                            is_joint_checkpoint)

    if recover_checkpoint(path) is None:
        raise FileNotFoundError(
            f"{path} is not a complete checkpoint (no config.json)")
    with np.load(os.path.join(path, "params.npz")) as z:
        params = {k: z[k] for k in z.files}
    vocab = Vocab.load(os.path.join(path, "vocab.json"))
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    if meta.get("decoder") == MoETextConfig.decoder:
        return _load_moe_text(params, vocab, meta, device, compute_dtype)
    field_names = {f.name for f in dataclasses.fields(LRCNConfig)}
    cfg = LRCNConfig(**{k: v for k, v in meta.items() if k in field_names})
    if compute_dtype is None:
        compute_dtype = compute_dtype_of(cfg)
    opt_leaves = None
    opt_path = os.path.join(path, "opt_state.npz")
    if opt_state and os.path.exists(opt_path):
        with np.load(opt_path) as z:
            opt_leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
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
            "vocab": vocab, "cfg": cfg, "step": meta.get("step", 0),
            "epoch": meta.get("epoch", 0), "opt_leaves": opt_leaves,
            "position": meta.get("position")}


def _load_moe_text(params: dict[str, np.ndarray], vocab: Vocab, meta: dict,
                   device, compute_dtype: torch.dtype | None
                   ) -> dict[str, Any]:
    """A checkpoint of the MoE text decoder (``config.json`` names it by
    ``decoder``; ``save_checkpoint`` writes one from its flat parameters
    and a ``MoETextConfig``): inference only."""
    cfg = MoETextConfig.from_dict(meta)
    if compute_dtype is None:
        compute_dtype = _DTYPES[cfg.compute_dtype]
    decoder = MoETextDecoder(
        cfg, lambda key: torch.from_numpy(np.asarray(params[key],
                                                     np.float32)),
        compute_dtype).to(torch.device(device))
    return {"decoder": decoder, "vgg": None, "average_image": None,
            "params": params, "vocab": vocab, "cfg": cfg,
            "step": meta.get("step", 0), "epoch": meta.get("epoch", 0),
            "opt_leaves": None, "position": meta.get("position")}


# --- step-interval resume positions ---


def key_words(key: int) -> np.ndarray:
    """A 64-bit epoch key as two uint32 words (high, low)."""
    return np.array([(key >> 32) & 0xFFFFFFFF, key & 0xFFFFFFFF], np.uint32)


def key_from_words(words) -> int:
    """The inverse of :func:`key_words`."""
    hi, lo = (int(w) for w in np.asarray(words, np.uint64).reshape(2))
    return (hi << 32) | lo


def make_position(epoch: int, dispatch: int, shuffle_state: dict,
                  epoch_key: int, geometry: dict) -> dict:
    """The mid-epoch resume marker a step-interval save carries.

    ``geometry`` records whatever determines the dispatch stream
    (steps_per_dispatch, batch count): a resume under a different
    geometry would reinterpret the dispatch index as a different batch
    stream, so ``resume_start`` refuses it."""
    return {"epoch": int(epoch), "dispatch": int(dispatch),
            "shuffle_state": shuffle_state,
            "epoch_key": key_words(epoch_key).tolist(),
            "geometry": dict(geometry)}


def resume_start(resume_position: dict | None,
                 shuffle_rng: np.random.Generator, rng_key: int,
                 geometry: dict) -> tuple[int, int, int]:
    """Unpack (and validate) a resume position into
    ``(start_epoch, start_dispatch, rng_key)``; restores the shuffle
    generator's state in place.  No position -> ``(1, 0, rng_key)``."""
    if not resume_position:
        return 1, 0, rng_key
    saved = resume_position.get("geometry", {})
    if saved and saved != geometry:
        raise ValueError(
            f"resume: the checkpoint's mid-epoch position was recorded "
            f"under dispatch geometry {saved}, but this run has "
            f"{geometry}: the dispatch index would address a different "
            f"batch stream. Re-run with the original settings (or train "
            f"from the last epoch-complete checkpoint).")
    shuffle_rng.bit_generator.state = resume_position["shuffle_state"]
    rng_key = key_from_words(resume_position["epoch_key"])
    start_epoch = int(resume_position["epoch"])
    start_dispatch = int(resume_position["dispatch"])
    print(f"resume: continuing epoch {start_epoch} from dispatch "
          f"{start_dispatch}")
    return start_epoch, start_dispatch, rng_key
