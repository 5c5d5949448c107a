"""mfu.train (%, host clock): the model operations of the optimizer steps
in the window, over the window's seconds and the card's bf16 peak.  A
step counts the decoder's products at every position of its padded
batch, forward and backward (3 forwards); the joint step adds 3 VGG-16
forwards an image (forward and backward).  The recompute of
rematerialisation is the hardware's work, not the model's, and counts
nothing."""

from portbench.work import decoder, vgg16


def read(run):
    counts = run.counts
    if "steps" not in counts:
        return None
    cfg = run.config
    per_step = decoder.train_step_flops(cfg, counts["batch"],
                                        counts["positions"])
    if "vgg_widths" in cfg:
        per_step += 3 * 2 * counts["batch"] * vgg16.forward_macs(cfg)
    ops = per_step * counts["steps"]
    return 100.0 * ops / run.window_s / run.peaks["flops_s"]["bf16"]
