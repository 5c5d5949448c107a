"""Joint fine-tuning of VGG-16 and the decoder on images, as ``lrcn-torch
train --joint`` runs it: ``train/joint.py:JointTrainer.train_epoch``,
``steps_per_dispatch`` steps a dispatch, with rematerialisation.

The configuration bypasses the host's JPEG decode: a pool of
``image_pool`` decoded uint8 images in host memory, from the seed, which
the trainer's image loader indexes by id instead of decoding files (its
prefetch threads still stack and hand over each chunk).

Set-up: the pool, both parameter sets (VGG-16's random initialization
and the decoder's, from the seed) and the joint Adam, then the check's
dispatches (``training.py``), which also warm up the window's graph.  A
unit of the window is one epoch of ``epoch_batches`` batches of one
shape.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.drivers import captions, training


class Work:
    def __init__(self, ctx):
        from lrcn_tpu_torch.models.joint import JointParams
        from lrcn_tpu_torch.models.lrcn import PARAM_KEYS, LRCNParams
        from lrcn_tpu_torch.models.vgg import PARAM_KEYS as VGG_KEYS
        from lrcn_tpu_torch.models.vgg import VGGParams
        from lrcn_tpu_torch.train.joint import JointTrainer

        cfg, tr = ctx.config, ctx.traffic
        self.ctx = ctx
        pool = inputs.pixels(tr["image_pool"], cfg["image_size"], ctx.seed,
                             ctx.device).cpu().numpy()

        class PoolTrainer(JointTrainer):
            def _load_images(self, batch):
                return pool[batch.image_ids]

        ids = np.arange(tr["image_pool"])
        self.log = training.logger()
        self.trainer = PoolTrainer(
            training.port_config(ctx), captions.program_vocab(cfg),
            image_paths={int(i): str(i) for i in ids},
            average_image=inputs.mean_image(cfg), metrics=self.log,
            cnn_lr=tr["cnn_lr"], steps_per_dispatch=tr["steps_per_dispatch"],
            remat_cnn=tr["remat"], device=ctx.device)
        dec = inputs.decoder_weights(cfg, ctx.seed, ctx.device, "train")
        cnn = inputs.vgg_weights(cfg, ctx.seed, ctx.device)
        self.params = JointParams(
            VGGParams({k: cnn[k] for k in VGG_KEYS}),
            LRCNParams({k: dec[k] for k in PARAM_KEYS}))
        self.opt = self.trainer.opt.init(self.params)
        rng = inputs.host_rng(ctx.seed, inputs.CAPTIONS)
        self.shuffle = training.shuffle_rng(ctx)
        self.check_epochs = check_epochs(ctx, rng)
        self.epoch = training.port_batches(training.make_batches(
            rng, tr["epoch_batches"], ids, ctx))
        self.key = inputs.stream_seed(ctx.seed, inputs.CHECK)
        self.steps = 0
        ctx.note("image pool and trainer")
        before = {f"cnn/{k}": v for k, v in cnn.items()}
        before.update({f"decoder/{k}": v for k, v in dec.items()})
        self.readings = training.first_dispatches(self, before,
                                                  "joint_train")
        ctx.note("the check's dispatches")

    def leaves(self) -> dict[str, tuple]:
        """Leaf name -> (parameter, its Adam)."""
        out = {f"cnn/{k}": (p, self.opt.cnn_adam)
               for k, p in self.params.cnn.items()}
        out.update({f"decoder/{k}": (p, self.opt.decoder_adam)
                    for k, p in self.params.decoder.items()})
        return out

    def train(self, batches) -> None:
        self.params, self.opt, self.key = self.trainer.train_epoch(
            self.params, self.opt, batches, self.key, self.shuffle)

    def unit(self) -> None:
        self.train(self.epoch)
        self.steps += len(self.epoch)

    def counts(self) -> dict:
        tr = self.ctx.traffic
        return {"attempted": self.steps, "failed": 0, "steps": self.steps,
                "batch": tr["batch"], "positions": tr["max_len"] + 1}

    def release(self) -> None:
        self.trainer = self.params = self.opt = None

    def check(self):
        return training.check(self.ctx, self.readings,
                              *reference_inputs(self.ctx, self.check_epochs))


def check_epochs(ctx, rng) -> list[list]:
    return training.check_epochs(ctx, rng,
                                 np.arange(ctx.traffic["image_pool"]))


def reference_inputs(ctx, epochs=None) -> tuple[dict, list[list]]:
    """What the reference's steps take, made again from the seed: both
    weight sets (``cnn/...``, ``decoder/...``) and the check's epochs of
    batches as device tensors with their pixels and the mean image."""
    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    if epochs is None:
        epochs = check_epochs(ctx, inputs.host_rng(ctx.seed,
                                                   inputs.CAPTIONS))
    pool = inputs.pixels(tr["image_pool"], cfg["image_size"], ctx.seed,
                         device)
    mean = torch.from_numpy(inputs.mean_image(cfg)).to(device)
    tensors = [[{"tokens": torch.from_numpy(b.tokens).to(device),
                 "lengths": torch.from_numpy(b.lengths).to(device),
                 "images": pool[torch.from_numpy(b.image_ids).to(device)],
                 "mean": mean}
                for b in epoch] for epoch in epochs]
    del pool
    params = {f"cnn/{k}": v for k, v in
              inputs.vgg_weights(cfg, ctx.seed, device).items()}
    params.update({f"decoder/{k}": v for k, v in inputs.decoder_weights(
        cfg, ctx.seed, device, "train").items()})
    return params, tensors


def setup(ctx) -> Work:
    """The trainer and the check's dispatches: the first runs eagerly, the
    second captures the graph the window replays, the third replays it."""
    return Work(ctx)
