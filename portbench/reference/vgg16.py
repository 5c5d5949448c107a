"""VGG-16 to fc7 in plain float32 PyTorch (arXiv:1409.1556; the MatConvNet
walk of lrcn.jl:696-748).

Thirteen 3x3 convolutions (padding 1) each with ReLU, 2x2 max pools after
blocks of 2, 2, 3, 3, 3, then fc6 with ReLU and fc7, which the reference
takes before relu7.  Weights under the checkpoint keys: convs HWIO, fc6
``(7, 7, C, F6)`` applied to the NHWC flatten, fc7 ``(F6, F7)``.  The
input is uint8 pixels minus the mean image (lrcn.jl:771).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.precision import cast, product

BLOCKS = (("conv1_1", "conv1_2"), ("conv2_1", "conv2_2"),
          ("conv3_1", "conv3_2", "conv3_3"),
          ("conv4_1", "conv4_2", "conv4_3"),
          ("conv5_1", "conv5_2", "conv5_3"))


def fc7(p: dict, images_u8: torch.Tensor, mean: torch.Tensor,
        quant=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, F7) float32, no relu7."""
    x = (images_u8.float() - mean).permute(0, 3, 1, 2)
    for block in BLOCKS:
        for name in block:
            w = p[f"{name}/w"].permute(3, 2, 0, 1)            # HWIO -> OIHW
            x = torch.relu(product(F.conv2d(cast(x, quant), cast(w, quant),
                                            p[f"{name}/b"], padding=1),
                                   quant))
        x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    w6 = p["fc6/w"].reshape(-1, p["fc6/w"].shape[-1])
    x = torch.relu(product(cast(x, quant) @ cast(w6, quant), quant)
                   + p["fc6/b"])
    return product(cast(x, quant) @ cast(p["fc7/w"], quant), quant) + p[
        "fc7/b"]


def l1_normalize(x: torch.Tensor) -> torch.Tensor:
    """Each row over its sum (``input/sum(input)``, lrcn.jl:597)."""
    return x / x.sum(dim=-1, keepdim=True)
