"""VGG-16's layers from a configuration: the 13 convolutions' shapes and
the multiply-adds of one forward to fc7 (15.47 G at 224 x 224)."""

from __future__ import annotations


def conv_shapes(cfg: dict) -> list[tuple[int, int, int]]:
    """(side, c_in, c_out) of each 3x3 convolution, in order."""
    side, c_in, out = cfg["image_size"], 3, []
    for entry in cfg["vgg_widths"]:
        if entry == "pool":
            side //= 2
            continue
        out.append((side, c_in, entry))
        c_in = entry
    return out


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one image's forward to fc7."""
    convs = sum(9 * c * f * side * side for side, c, f in conv_shapes(cfg))
    last = conv_shapes(cfg)[-1][2]
    side = cfg["image_size"] // 32
    return (convs + side * side * last * cfg["fc6_dim"]
            + cfg["fc6_dim"] * cfg["cnn_feature_dim"])
