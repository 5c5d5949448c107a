"""conv3x3_roofline (%, device trace): the least time the card needs for
VGG-16's 13 convolutions over the window's real images, over the device
time of the kernels named below.  Counted per pass over the split's
images at bf16 (``work/conv3x3.py``; operations bound it); padding images
are work the kernel does and the count leaves out."""

from portbench.work import bound_s, conv3x3, vgg16

KERNELS = ("conv3x3_",)


def read(run):
    counts = run.counts
    if run.timeline is None or not counts.get("images"):
        return None
    kernel_s = run.timeline.kernel_s(KERNELS)
    if kernel_s <= 0:
        return None
    per_pass = run.traffic["images"]
    passes = counts["images"] // per_pass
    need = passes * sum(
        bound_s(*conv3x3.cost(per_pass, side, side, c, f), run.peaks)
        for side, c, f in vgg16.conv_shapes(run.config))
    return 100.0 * need / kernel_s
