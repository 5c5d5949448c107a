"""mfu.caption (%, host clock): the model operations of the captions
returned in the window, over the window's seconds and the card's bf16
peak.  A caption counts its beam's hypotheses over the steps it needs
(its words and EOS; ``max_words + 1`` where it never ended) and its
image's projection, and, where the cell encodes images, 2 operations per
multiply-add of VGG-16's forward for each real image.  Padding rows and
steps past a caption's end count nothing."""

from portbench.work import decoder, vgg16


def read(run):
    counts = run.counts
    if "caption_steps" not in counts:
        return None
    cfg = run.config
    ops = decoder.caption_flops(cfg, counts["captions"],
                                counts["caption_steps"],
                                run.traffic["beam_width"])
    if counts.get("images"):
        ops += 2 * counts["images"] * vgg16.forward_macs(cfg)
    return 100.0 * ops / run.window_s / run.peaks["flops_s"]["bf16"]
