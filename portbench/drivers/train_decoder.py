"""Decoder training on stored fc7 features, as ``lrcn-torch train`` runs
it: ``train/trainer.py:Trainer.train_epoch`` with the feature table
resident on the card, ``steps_per_dispatch`` steps a dispatch.

Set-up: the table (``table_rows`` fc7 rows from the seed), the decoder's
parameters (the reference's initialization, from the seed) and Adam,
then the check's dispatches (``training.py``), which also warm up the
window's graph.  A unit of the window is one epoch of ``epoch_batches``
batches, all of one shape, so every dispatch runs ``steps_per_dispatch``
steps.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.drivers import captions, training

PREFIX = "decoder/"


class Work:
    def __init__(self, ctx):
        from lrcn_tpu_torch.data.feature_store import FeatureStore
        from lrcn_tpu_torch.models.lrcn import PARAM_KEYS, LRCNParams
        from lrcn_tpu_torch.train.trainer import Optimizer, Trainer

        cfg, tr = ctx.config, ctx.traffic
        self.ctx = ctx
        n = tr["table_rows"]
        rows = inputs.fc7_rows(n, cfg["cnn_feature_dim"], ctx.seed,
                               ctx.device).cpu().numpy()
        self.store = FeatureStore(dim=cfg["cnn_feature_dim"], normalized=True)
        for i, row in enumerate(rows):
            self.store.add(i, row)
        del rows
        ctx.note("feature store")
        port_cfg = training.port_config(ctx)
        self.log = training.logger()
        self.trainer = Trainer(port_cfg, captions.program_vocab(cfg),
                               metrics=self.log, device=ctx.device,
                               steps_per_dispatch=tr["steps_per_dispatch"])
        weights = inputs.decoder_weights(cfg, ctx.seed, ctx.device, "train")
        self.params = LRCNParams({k: weights[k] for k in PARAM_KEYS})
        self.opt = Optimizer(self.params, port_cfg)
        rng = inputs.host_rng(ctx.seed, inputs.CAPTIONS)
        self.shuffle = training.shuffle_rng(ctx)
        self.check_epochs = check_epochs(ctx, rng)
        self.epoch = training.port_batches(training.make_batches(
            rng, tr["epoch_batches"], np.arange(n), ctx))
        self.key = inputs.stream_seed(ctx.seed, inputs.CHECK)
        self.steps = 0
        ctx.note("trainer")
        self.readings = training.first_dispatches(
            self, {PREFIX + k: weights[k] for k in self.params}, "train")
        ctx.note("the check's dispatches")

    def leaves(self) -> dict[str, tuple]:
        """Leaf name -> (parameter, its Adam)."""
        return {PREFIX + k: (p, self.opt.adam)
                for k, p in self.params.items()}

    def train(self, batches) -> None:
        self.params, self.opt, self.key = self.trainer.train_epoch(
            self.params, self.opt, batches, self.store, self.key,
            self.shuffle)

    def unit(self) -> None:
        self.train(self.epoch)
        self.steps += len(self.epoch)

    def counts(self) -> dict:
        tr = self.ctx.traffic
        return {"attempted": self.steps, "failed": 0, "steps": self.steps,
                "batch": tr["batch"], "positions": tr["max_len"] + 1}

    def release(self) -> None:
        self.trainer = self.params = self.opt = self.store = None

    def check(self):
        return training.check(self.ctx, self.readings,
                              *reference_inputs(self.ctx, self.check_epochs))


def check_epochs(ctx, rng) -> list[list]:
    return training.check_epochs(ctx, rng,
                                 np.arange(ctx.traffic["table_rows"]))


def reference_inputs(ctx, epochs=None) -> tuple[dict, list[list]]:
    """What the reference's steps take, made again from the seed: the
    weights (``decoder/...``) and the check's epochs of batches as device
    tensors with their fc7 rows."""
    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    if epochs is None:
        epochs = check_epochs(ctx, inputs.host_rng(ctx.seed,
                                                   inputs.CAPTIONS))
    table = inputs.fc7_rows(tr["table_rows"], cfg["cnn_feature_dim"],
                            ctx.seed, device)
    tensors = [[{"tokens": torch.from_numpy(b.tokens).to(device),
                 "lengths": torch.from_numpy(b.lengths).to(device),
                 "feats": table[torch.from_numpy(b.image_ids).to(device)]}
                for b in epoch] for epoch in epochs]
    del table
    weights = inputs.decoder_weights(cfg, ctx.seed, device, "train")
    return {PREFIX + k: v for k, v in weights.items()}, tensors


def setup(ctx) -> Work:
    """The trainer and the check's dispatches: the first runs eagerly, the
    second captures the graph the window replays, the third replays it."""
    return Work(ctx)
