"""Joint CNN+LSTM fine-tune loop on one device (counterpart of
``lrcn_tpu/train/joint.py``).

The epoch loop around ``models/joint.py``'s end-to-end step, with the JAX
package's semantics:

- caption batches come from the same length-bucketed batcher as decoder
  training; each batch's image ids resolve to image files, decoded on the
  host (``data/images.py:load_images``: the native JPEG loader, PIL for
  the rest) and fed as uint8, the mean subtraction running on the device;
- host decode overlaps with device work through a prefetch pool
  (``prefetch_depth`` loads in flight);
- ``steps_per_dispatch = K > 1`` stacks K same-shape batches
  (``chunk_same_shape`` order, then the per-shape tail, as in JAX) and
  runs K steps with no host synchronisation;
- per-step dropout keys derive from (epoch key, step index) through
  ``fold_in``, so a run resumed from a mid-epoch checkpoint
  (``ckpt_every``, ``resume_position``) replays the uninterrupted one;
- per-epoch checkpoints carry BOTH parameter sets (``cnn/`` and
  ``decoder/`` keys in ``params.npz``) and the joint optimizer's optax
  leaves, so either package resumes them.

A joint checkpoint's mean image lives in ``average_image.npy``, which
``save_checkpoint`` keeps when it rewrites a checkpoint.

With a ``mesh`` (one rank per entry) the step is data parallel
(``models/joint.py``): each rank decodes and feeds only its rows of every
batch, the shuffle seed is ``shared_seed``'s, and rank 0 alone writes the
checkpoints (both parameter sets are replicated).
"""

from __future__ import annotations

import copy
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.data.batcher import Batch, chunk_same_shape, iterate_epoch
from lrcn_tpu_torch.models.joint import (JointOptState, JointParams,
                                         JointTrainStep, make_joint_optimizer)
from lrcn_tpu_torch.models.lrcn import LRCNParams, flat_tree
from lrcn_tpu_torch.models.vgg import VGGParams
from lrcn_tpu_torch.train.checkpoint import (make_position, resume_start,
                                             save_checkpoint)
from lrcn_tpu_torch.train.metrics import MetricsLogger
from lrcn_tpu_torch.train.trainer import fold_in
from lrcn_tpu_torch.utils.profiling import span


class JointTrainer:
    """Epoch loop for end-to-end (images -> captions) fine-tuning on one
    device (``"cuda"`` unless the caller passes another)."""

    def __init__(self, cfg: LRCNConfig, vocab: Vocab,
                 image_paths: dict[int, str], average_image: np.ndarray,
                 metrics: MetricsLogger | None = None,
                 cnn_lr: float | None = None, freeze_cnn: bool = False,
                 steps_per_dispatch: int = 1, prefetch_depth: int = 2,
                 remat_cnn: bool = True, device="cuda", mesh=None):
        self.cfg = cfg
        self.vocab = vocab
        self.image_paths = image_paths
        self.average_image = np.asarray(average_image, np.float32)
        self.metrics = metrics or MetricsLogger()
        self.opt = make_joint_optimizer(cfg, cnn_lr=cnn_lr,
                                        freeze_cnn=freeze_cnn)
        self.mesh = mesh
        self.step = JointTrainStep(cfg, self.opt, remat_cnn=remat_cnn,
                                   average_image=self.average_image,
                                   device=device, mesh=mesh)
        self._data_size = 1 if mesh is None else mesh.shape["data"]
        self.device = self.step.device
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        self.prefetch_depth = max(1, prefetch_depth)

    def init(self, generator: torch.Generator | int, vgg_params=None,
             decoder_params=None) -> tuple[JointParams, JointOptState]:
        """Fresh parameters (``JointTrainStep.init``); ``decoder_params``
        (an ``LRCNParams`` or a numpy tree) replaces the random decoder."""
        params, opt_state = self.step.init(generator, vgg_params=vgg_params)
        if decoder_params is not None:
            if not isinstance(decoder_params, LRCNParams):
                decoder_params = LRCNParams.from_numpy(decoder_params, "cpu")
            params = JointParams(params.cnn, decoder_params.to(self.device))
            opt_state = self.opt.init(params)
        return params, opt_state

    def restore(self, raw_params, opt_leaves=None
                ) -> tuple[JointParams, JointOptState]:
        """Both parameter sets from a joint checkpoint's ``params`` (flat
        or nested numpy), and the optimizer with its ``opt_leaves``, if
        any."""
        params = load_joint_params(raw_params, self.device)
        opt_state = self.opt.init(params)
        if opt_leaves is not None:
            opt_state.load_leaves(opt_leaves)
        return params, opt_state

    # --- host image feed ---

    def _load_images(self, batch: Batch) -> np.ndarray:
        """Decode the batch's images -> (B, 224, 224, 3) uint8 pixels.

        Padded rows (length -1, data/batcher.py) repeat the last real
        image id, so every id in ``batch.image_ids`` resolves."""
        from lrcn_tpu_torch.data.images import load_images

        return load_images(
            [self.image_paths[int(i)] for i in batch.image_ids])

    def _local(self, batch: Batch) -> Batch:
        """This rank's rows of a batch (the batch itself without a mesh):
        each rank decodes only the images it feeds."""
        if self.mesh is None:
            return batch
        rows = self.step.local_rows(batch.batch_size)
        return Batch(batch.image_ids[rows], batch.tokens[rows],
                     batch.lengths[rows])

    def _load_local(self, batch: Batch) -> tuple:
        """Host arrays of this rank's rows of a batch: (B, 224, 224, 3) u8,
        tokens and lengths."""
        local = self._local(batch)
        return self._load_images(local), local.tokens, local.lengths

    def _load_chunk(self, chunk: list[Batch]) -> tuple:
        """Host arrays for this rank's rows of K stacked batches:
        (K,B,224,224,3) u8 + tokens."""
        parts = [self._load_local(b) for b in chunk]
        return tuple(np.stack(p) for p in zip(*parts))

    def _prefetched(self, items: list, load, transform):
        """Decode up to ``prefetch_depth`` items ahead of the device."""
        with ThreadPoolExecutor(max_workers=self.prefetch_depth) as pool:
            futures = deque(pool.submit(load, it)
                            for it in items[:self.prefetch_depth])
            for i in range(len(items)):
                with span("lrcn.train.wait_data"):
                    # drop the ref: a kept future pins its decoded
                    # (B,224,224,3) array for the epoch
                    host = futures.popleft().result()
                if i + self.prefetch_depth < len(items):
                    futures.append(
                        pool.submit(load, items[i + self.prefetch_depth]))
                with span("lrcn.train.batch"):
                    dev = transform(host)
                yield dev

    # --- loops ---

    def train_epoch(self, params: JointParams, opt_state: JointOptState,
                    batches: Sequence[Batch], rng_key: int,
                    shuffle_rng: np.random.Generator | None,
                    log_every: int = 50, start_dispatch: int = 0,
                    ckpt_every: int | None = None, on_checkpoint=None
                    ) -> tuple[JointParams, JointOptState, int]:
        """One fine-tune epoch; returns the next epoch's key with the
        updated parameters and optimizer.  ``start_dispatch`` skips
        completed dispatches (no image decode for them); step keys derive
        from (epoch key, index); ``on_checkpoint(dispatch, params,
        opt_state)`` fires every ``ckpt_every`` dispatches.

        Spans (``utils/profiling.py:span``): ``lrcn.train.epoch`` around
        the call; inside it, from the prefetch feed,
        ``lrcn.train.wait_data`` (a decode future's ``result()``) and
        ``lrcn.train.batch`` (``put_local``), then ``lrcn.train.log``
        (``metrics.log`` with its loss readback) and ``lrcn.train.sync``
        (the closing synchronize)."""
        with span("lrcn.train.epoch"):
            t0 = time.time()
            seen = 0
            n_chunks = 0

            def images_per_sec():
                return round(seen / (time.time() - t0), 1)

            def maybe_ckpt(dispatch, p, o):
                if ckpt_every and on_checkpoint and dispatch % ckpt_every == 0:
                    on_checkpoint(dispatch, p, o)

            if self.steps_per_dispatch == 1:
                single = list(iterate_epoch(batches, shuffle_rng))
            else:
                chunks, tail = chunk_same_shape(
                    batches, self.steps_per_dispatch, shuffle_rng)
                n_chunks = len(chunks)
                skip = min(start_dispatch, n_chunks)
                offset = sum(len(c) for c in chunks[:skip])
                feed = self._prefetched(
                    chunks[skip:], self._load_chunk,
                    lambda host: self.step.put_local(*host))
                for ci, (images_k, tokens_k, lengths_k) in enumerate(feed):
                    params, opt_state, losses = self.step.multi_step(
                        params, opt_state, images_k, tokens_k, lengths_k,
                        rng_key, offset)
                    k = images_k.shape[0]
                    offset += k
                    seen += k * images_k.shape[1] * self._data_size
                    gi = skip + ci
                    if log_every and (gi * k) % log_every < k:
                        with span("lrcn.train.log"):
                            self.metrics.log(event="joint_train", batch=gi * k,
                                             loss=round(float(losses[-1]), 4),
                                             images_per_sec=images_per_sec())
                    maybe_ckpt(gi + 1, params, opt_state)
                rng_key = fold_in(rng_key, offset + 1)
                single = tail   # per-shape remainders, already shuffled
            skip_single = max(0, start_dispatch - n_chunks)
            single_base = rng_key
            feed = self._prefetched(single[skip_single:], self._load_local,
                                    lambda host: self.step.put_local(*host))
            for i, dev in enumerate(feed):
                j = skip_single + i
                params, opt_state, loss = self.step(
                    params, opt_state, *dev, fold_in(single_base, j))
                seen += dev[0].shape[0] * self._data_size
                if log_every and j % log_every == 0:
                    with span("lrcn.train.log"):
                        self.metrics.log(event="joint_train", batch=j,
                                         loss=round(float(loss), 4),
                                         images_per_sec=images_per_sec())
                maybe_ckpt(n_chunks + j + 1, params, opt_state)
            rng_key = fold_in(single_base, len(single) + 1)
            if self.device.type == "cuda":
                with span("lrcn.train.sync"):
                    torch.cuda.synchronize(self.device)
            return params, opt_state, rng_key

    def average_loss(self, params: JointParams, batches: Sequence[Batch]
                     ) -> float:
        """Mean per-token NLL over a split, images decoded on the fly.

        At most ``2 * prefetch_depth`` batches are in flight: each queued
        batch pins its uint8 images (19 MB at B=128) in device memory
        until it has run, so an unbounded queue would hold a whole
        validation split whenever host decode outpaces the device."""
        total, count = 0.0, 0.0
        feed = self._prefetched(list(batches), self._load_local,
                                lambda host: self.step.put_local(*host))
        partials: deque = deque()
        max_inflight = 2 * self.prefetch_depth
        for dev in feed:
            partials.append(self.step.eval_batch(params, *dev))
            while len(partials) > max_inflight:
                t, c = partials.popleft()
                total += float(t)
                count += float(c)
        for t, c in partials:
            total += float(t)
            count += float(c)
        return total / max(count, 1.0)

    def _save(self, path: str, params, opt_state, **kwargs) -> None:
        """``save_checkpoint``; under a mesh rank 0 alone writes (both
        parameter sets and the optimizer are replicated) and every rank
        returns after the write."""
        from lrcn_tpu_torch.parallel.distributed import barrier, is_primary
        if is_primary():
            save_checkpoint(path, params, self.vocab, self.cfg,
                            opt_state=opt_state, **kwargs)
        barrier("lrcn_ckpt_save")

    def fit(self, params: JointParams, opt_state: JointOptState,
            train_batches: Sequence[Batch],
            val_batches: Sequence[Batch] | None, rng_key: int, *,
            epochs: int | None = None, savefile: str | None = None,
            bestfile: str | None = None, ckpt_every: int | None = None,
            resume_position: dict | None = None,
            completed_epochs: int = 0) -> tuple[JointParams, JointOptState]:
        """Epoch loop; ``ckpt_every``/``resume_position`` give the same
        crash-safe mid-epoch checkpointing as the decoder trainer, and on
        any resume ``epochs`` is the total budget."""
        from lrcn_tpu_torch.parallel.distributed import shared_seed

        epochs = epochs if epochs is not None else self.cfg.epochs
        shuffle_rng = np.random.default_rng(
            shared_seed(self.cfg.seed if self.cfg.seed > 0 else None))
        best_val = float("inf")
        geometry = {"steps_per_dispatch": self.steps_per_dispatch,
                    "n_batches": len(train_batches)}
        start_epoch, start_dispatch, rng_key = resume_start(
            resume_position, shuffle_rng, rng_key, geometry)
        if not resume_position and completed_epochs:
            start_epoch = completed_epochs + 1
        resumed = bool(resume_position) or completed_epochs > 0
        end_epoch = epochs if resumed else start_epoch + epochs - 1
        if start_epoch > end_epoch:
            print(f"train --joint: checkpoint already covers "
                  f"{completed_epochs} of the {epochs}-epoch budget — "
                  f"nothing to do (raise --epochs to continue)")
            return params, opt_state
        for epoch in range(start_epoch, end_epoch + 1):
            epoch_state = copy.deepcopy(shuffle_rng.bit_generator.state)
            epoch_key = rng_key

            def on_ckpt(dispatch, p, o, _epoch=epoch, _state=epoch_state,
                        _key=epoch_key):
                self._save(
                    savefile, p, o, epoch=_epoch - 1,
                    position=make_position(_epoch, dispatch, _state, _key,
                                           geometry))
                self.metrics.log(event="ckpt", epoch=_epoch,
                                 dispatch=dispatch)

            params, opt_state, rng_key = self.train_epoch(
                params, opt_state, train_batches, rng_key, shuffle_rng,
                start_dispatch=start_dispatch if epoch == start_epoch else 0,
                ckpt_every=ckpt_every if savefile else None,
                on_checkpoint=on_ckpt if savefile else None)
            if savefile:
                self._save(savefile, params, opt_state, epoch=epoch)
            record = {"event": "epoch", "epoch": epoch}
            if val_batches is not None:
                val_loss = self.average_loss(params, val_batches)
                record["val_loss"] = round(val_loss, 4)
                if bestfile and val_loss < best_val:
                    best_val = val_loss
                    self._save(bestfile, params, opt_state, epoch=epoch)
                    record["best"] = True
            self.metrics.log(**record)
        return params, opt_state


def load_joint_params(raw_params, device="cuda") -> JointParams:
    """Both parameter sets on ``device`` from a joint checkpoint's params
    (flat ``cnn/...`` and ``decoder/...`` keys, or nested)."""
    flat = flat_tree(raw_params)
    part = lambda prefix: {k[len(prefix):]: v for k, v in flat.items()
                           if k.startswith(prefix)}
    return JointParams(cnn=VGGParams.from_numpy(part("cnn/"), device),
                       decoder=LRCNParams.from_numpy(part("decoder/"),
                                                     device))


def is_joint_checkpoint(raw_params: dict) -> bool:
    return isinstance(raw_params, dict) and set(raw_params) >= {
        "cnn", "decoder"}


def identity_average_image() -> np.ndarray:
    """Zero mean image for training without the MatConvNet .mat file."""
    return np.zeros((224, 224, 3), np.float32)


__all__ = [
    "JointTrainer",
    "load_joint_params",
    "is_joint_checkpoint",
    "identity_average_image",
]
