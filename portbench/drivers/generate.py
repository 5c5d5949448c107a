"""Bulk caption generation over stored fc7 features, as ``lrcn-torch
generate`` runs it: ``decode/writer.py:generate_captions`` over every id
of the split, at the geometry ``cli.decode_geometry`` picks for the run.

Set-up: the served decoder and a feature store of the split's rows (both
from the seed), then two passes that warm up every shape the window
uses (the first search of a shape runs eagerly, the second captures its
graph).  A unit of the window is one pass over the split: its captions
are what the window returns.
"""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.drivers import captions


class Work:
    def __init__(self, ctx):
        from lrcn_tpu_torch.cli import decode_geometry
        from lrcn_tpu_torch.data.feature_store import FeatureStore

        cfg, tr = ctx.config, ctx.traffic
        self.ctx = ctx
        self.n = tr["images"]
        self.ids = [int(i) for i in inputs.image_ids(self.n, ctx.seed)]
        rows = inputs.fc7_rows(self.n, cfg["cnn_feature_dim"], ctx.seed,
                               ctx.device).cpu().numpy()
        self.store = FeatureStore(dim=cfg["cnn_feature_dim"], normalized=True)
        for image_id, row in zip(self.ids, rows):
            self.store.add(image_id, row)
        self.decoder = captions.program_decoder(ctx)
        self.vocab = captions.program_vocab(cfg)
        self.batch, self.depth = decode_geometry(self.n, None, None)
        self.passes: list[list[str]] = []
        ctx.note("store and decoder")

    def run_pass(self) -> list[str]:
        from lrcn_tpu_torch.decode.writer import generate_captions

        tr = self.ctx.traffic
        return generate_captions(
            self.decoder, self.vocab, self.store, self.ids,
            device=self.ctx.device, beam_width=tr["beam_width"],
            max_words=tr["max_words"], batch_size=self.batch,
            scan_depth=self.depth)

    def unit(self) -> None:
        self.passes.append(self.run_pass())

    def counts(self) -> dict:
        return captions.pass_counts(self.passes, self.n, self.ctx.traffic)

    def release(self) -> None:
        self.decoder = self.store = None

    def check(self):
        lines = self.passes[-1]
        picked = captions.sample(lines, self.ctx.traffic["check_captions"],
                                 self.ctx.seed)
        return captions.check(self.ctx, reference_feats(self.ctx, picked),
                              [lines[i] for i in picked],
                              sum(self.n - len(p) for p in self.passes))


def reference_feats(ctx, picked, quant=None):
    """The stored fc7 rows at ``picked``, made again from the seed (they
    are the cell's input: no precision applies)."""
    return inputs.fc7_rows(ctx.traffic["images"],
                           ctx.config["cnn_feature_dim"], ctx.seed,
                           ctx.device)[torch.as_tensor(picked)]


def setup(ctx) -> Work:
    work = Work(ctx)
    for _ in range(2):
        work.run_pass()
    ctx.note("warm-up")
    return work
