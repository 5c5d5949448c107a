"""The LRCN-2f evaluation chain over images: fc7 extraction as
``lrcn-torch extract-features`` runs it (``data/images.py:
extract_features``: groups of ``extract_scan_depth`` batches of
``extract_batch`` images, normalized on the card, L1-normalized and read
back into a feature store), then ``generate_captions`` over the new store
at the geometry ``cli.decode_geometry`` picks.

The configuration bypasses the host's JPEG decode: the split's images
are uint8 arrays in host memory, made from the seed, and
``extract_features``'s loader hands them over by path instead of
decoding files (each pass uploads them again inside the window).

Set-up: the encoder and the decoder (from the seed), then two passes
that warm up every shape (a full group and the last, shorter one; the
search).  A unit is one pass: extraction and captions of the split.
The check compares the sampled captions (``captions.py``), and the
sampled stored fc7 rows with the reference's VGG-16 on the same pixels
(``fc7_gap``: the largest relative L2 distance of a row).  It does not
compare ``beam_mismatch``: random VGG-16 weights on random pixels give
the 5,000 images nearly one caption, so the share flips with that
caption's near-ties, 0.9-29% by seed, within 2.5x of fp8's.
"""

from __future__ import annotations

import contextlib

import torch

from portbench import inputs
from portbench.drivers import captions
from portbench.harness.main import Check
from portbench.reference import vgg16 as ref_vgg
from portbench.reference.precision import strict_float32


class Work:
    def __init__(self, ctx):
        from lrcn_tpu_torch.cli import decode_geometry
        from lrcn_tpu_torch.models.vgg import VGGEncoder

        cfg, tr = ctx.config, ctx.traffic
        self.ctx = ctx
        self.n = tr["images"]
        self.ids = [int(i) for i in inputs.image_ids(self.n, ctx.seed)]
        self.pixels = inputs.pixels(self.n, cfg["image_size"], ctx.seed,
                                    ctx.device).cpu().numpy()
        self.paths = {image_id: str(row)
                      for row, image_id in enumerate(self.ids)}
        self.mean = inputs.mean_image(cfg)
        dtype = getattr(torch, cfg["compute_dtype"])
        self.encoder = VGGEncoder(
            inputs.vgg_weights(cfg, ctx.seed, ctx.device), dtype)
        self.decoder = captions.program_decoder(ctx)
        self.vocab = captions.program_vocab(cfg)
        self.batch, self.depth = decode_geometry(self.n, None, None)
        self.passes: list[list[str]] = []
        self.store = None
        ctx.note("images, encoder and decoder")

    @contextlib.contextmanager
    def decoded_images(self):
        """``extract_features`` reads its images through
        ``data.images.load_images``; here a path is a row of the pixels."""
        from lrcn_tpu_torch.data import images

        def load_images(paths):
            return self.pixels[[int(p) for p in paths]]

        saved = images.load_images
        images.load_images = load_images
        try:
            yield
        finally:
            images.load_images = saved

    def run_pass(self) -> list[str]:
        from lrcn_tpu_torch.data.images import extract_features
        from lrcn_tpu_torch.decode.writer import generate_captions

        tr = self.ctx.traffic
        with self.decoded_images():
            self.store = extract_features(
                self.paths, self.encoder, self.mean,
                batch_size=tr["extract_batch"],
                scan_depth=tr["extract_scan_depth"])
        return generate_captions(
            self.decoder, self.vocab, self.store, self.ids,
            device=self.ctx.device, beam_width=tr["beam_width"],
            max_words=tr["max_words"], batch_size=self.batch,
            scan_depth=self.depth)

    def unit(self) -> None:
        self.passes.append(self.run_pass())

    def counts(self) -> dict:
        counts = captions.pass_counts(self.passes, self.n, self.ctx.traffic)
        counts["images"] = self.n * len(self.passes)
        return counts

    def release(self) -> None:
        self.encoder = self.decoder = None

    def check(self):
        lines = self.passes[-1]
        picked = captions.sample(lines, self.ctx.traffic["check_captions"],
                                 self.ctx.seed)
        stored = torch.from_numpy(self.store.gather(
            [self.ids[i] for i in picked])).to(self.ctx.device)
        feats = reference_feats(self.ctx, picked)
        fc7_gap = float(((stored - feats).norm(dim=1)
                         / feats.norm(dim=1)).max())
        return captions.check(self.ctx, feats, [lines[i] for i in picked],
                              sum(self.n - len(p) for p in self.passes)
                              ) + [Check("fc7_gap", fc7_gap,
                                         self.ctx.limits["fc7_gap"])]


def reference_feats(ctx, picked, quant=None) -> torch.Tensor:
    """The reference's L1-normalized fc7 rows of the split's images at
    ``picked``, from the pixels and weights made again from the seed."""
    cfg, device = ctx.config, ctx.device
    images = inputs.pixels(ctx.traffic["images"], cfg["image_size"],
                           ctx.seed, device)[torch.as_tensor(picked)]
    mean = torch.from_numpy(inputs.mean_image(cfg)).to(device)
    weights = inputs.vgg_weights(cfg, ctx.seed, device)
    with strict_float32():
        return torch.cat([
            ref_vgg.l1_normalize(ref_vgg.fc7(weights, block, mean, quant))
            for block in images.split(16)])


def setup(ctx) -> Work:
    work = Work(ctx)
    for _ in range(2):
        work.run_pass()
    ctx.note("warm-up")
    return work
