"""One fused 3x3 convolution with bias and ReLU (``lrcn::conv3x3_relu``):
``b`` images of ``h x w``, ``c`` channels in, ``f`` out, padding 1.

x, the weights and the bias are read once and y written once (``elem``
bytes an element, float32 bias); 2 operations per multiply-add.  The
operations bound it at every VGG-16 layer at batches of 8 or more.
(Copied from ``chip_smoke.py``'s ``conv_bound``.)
"""

from __future__ import annotations


def cost(b: int, h: int, w: int, c: int, f: int, elem: int = 2
         ) -> tuple[float, float, str]:
    nbytes = elem * (b * h * w * (c + f) + 9 * c * f) + 4 * f
    ops = 2 * b * h * w * 9 * c * f
    return nbytes, ops, "bf16" if elem == 2 else "f32"
