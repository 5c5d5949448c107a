"""VGG-16 image encoder to fc7 on PyTorch (counterpart of
``lrcn_tpu/models/vgg.py``).

Same network, layout and numerics as the JAX package (reference
MatConvNet walk, lrcn.jl:696-748): 13 3x3 convolutions (pad 1,
cross-correlation), each followed by ReLU, 2x2/2 max pools after blocks of
2, 2, 3, 3, 3 convs, then fc6 (7*7*512 -> 4096) + ReLU and fc7 (4096 ->
4096).  The reference stops at fc7, so **relu7 is not applied**.

Activations are NHWC and conv weights HWIO, as in JAX.  ``VGGEncoder``
keeps every matmul and conv weight in the compute dtype, cast once at
load; biases stay float32.  Each conv runs through the fused
conv + bias + ReLU CUDA kernel (``ops/kernels/conv3x3.py``); the pools and
fc6/fc7 are plain ``torch`` ops, as the JAX package leaves them to XLA.
fc6 is held as a ``(7*7*C, 4096)`` matrix, the NHWC flatten of its
``(7, 7, C, 4096)`` filters, which is the JAX einsum
``bhwc,hwcf->bf`` (``vgg.py:144-147``) as one matmul.  On a card,
``vgg16_fc7`` and ``vgg16_fc7_grouped`` run each call, from the second
of a shape on, as one replay of the CUDA graph captured for that shape
(``utils/graphs.py``), as JAX jits ``vgg16_fc7`` and ``vgg16_fc7_scan``;
``vgg16_fc7_fn`` is the eager body.

Training (the joint fine-tune, ``models/joint.py``): ``VGGParams`` holds
the same weights as float32 ``nn.Parameter``s under the checkpoint keys
(``conv1_1/w`` ... ``fc7/b``, fc6 kept ``(7, 7, C, F)``), and
``vgg16_fc7_train`` is the differentiable counterpart of the JAX
package's ``vgg16_fc7_fn(..., use_pallas=False)``: each conv is
``F.conv2d`` (cuDNN on the card, the counterpart of XLA's
``conv_general_dilated``) with its output in the compute dtype, then the
bias added in the compute dtype, then ReLU, as XLA's path rounds.  The
conv kernel has no backward, as the Pallas kernel has no VJP, so the
joint loss never reaches it.  ``init_vgg_params`` draws the JAX package's
random initialization (He-normal convs, 0.01-normal fc6/fc7, zero biases)
on the CPU from a ``torch.Generator``.

``load_matconvnet`` and its helpers are copied from the JAX module
(scipy and numpy only).
"""

from __future__ import annotations

import functools
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lrcn_tpu_torch.models.lrcn import flat_tree
from lrcn_tpu_torch.ops.kernels import (conv3x3_relu_reference,
                                        fused_conv3x3_relu)
from lrcn_tpu_torch.ops.lstm import matmul
from lrcn_tpu_torch.utils import graphs

# (name, out_channels) for the 13 conv layers; 'pool' marks 2x2/2 max pools.
# Mirrors the MatConvNet layer list walked at lrcn.jl:701-718.
VGG16_LAYOUT: tuple = (
    ("conv1_1", 64), ("conv1_2", 64), "pool",
    ("conv2_1", 128), ("conv2_2", 128), "pool",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "pool",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "pool",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), "pool",
)
CONV_NAMES = tuple(e[0] for e in VGG16_LAYOUT if e != "pool")

FC6_DIM = 4096
FC7_DIM = 4096


class VGGEncoder(nn.Module):
    """The encoder's weights on one device, ready for ``vgg16_fc7``.

    Build it with :func:`vgg_params_from_numpy`.  Conv weights are
    ``<name>_w`` (3, 3, C, F) HWIO and ``<name>_b`` (F,); ``fc6_w`` is
    (7*7*C, F6), ``fc7_w`` (F6, F7).  The weights are buffers: the encoder
    computes no gradient.
    """

    def __init__(self, params: Mapping[str, torch.Tensor],
                 compute_dtype: torch.dtype):
        super().__init__()
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, "
                             f"got {compute_dtype}")
        self.compute_dtype = compute_dtype
        fc6 = params["fc6/w"]
        if fc6.dim() != 4 or tuple(fc6.shape[:2]) != (7, 7):
            raise ValueError(f"fc6/w {tuple(fc6.shape)}: want (7, 7, C, F)")
        weights = {f"{n}/w": params[f"{n}/w"] for n in CONV_NAMES}
        weights["fc6/w"] = fc6.reshape(-1, fc6.shape[-1])
        weights["fc7/w"] = params["fc7/w"]
        for key, value in weights.items():
            self.register_buffer(key.replace("/", "_"),
                                 value.to(compute_dtype).contiguous())
        for name in (*CONV_NAMES, "fc6", "fc7"):
            self.register_buffer(f"{name}_b",
                                 params[f"{name}/b"].float().contiguous())

    @property
    def device(self) -> torch.device:
        return self.fc7_b.device

    @property
    def feature_dim(self) -> int:
        return self.fc7_b.shape[0]


def vgg_params_from_numpy(tree: Mapping, device, compute_dtype: torch.dtype
                          ) -> VGGEncoder:
    """Build an encoder on ``device`` from the JAX VGG parameter pytree.

    ``tree`` holds numpy arrays, nested (``{"conv1_1": {"w": ...}}``, as
    ``init_vgg_params`` and ``load_matconvnet`` return) or flat with
    '/'-joined keys (``"conv1_1/w"``).
    """
    flat = flat_tree(tree)
    missing = [k for k in PARAM_KEYS if k not in flat]
    if missing:
        raise KeyError(f"VGG parameter tree lacks {missing}")
    params = {k: torch.tensor(np.asarray(flat[k], np.float32))
              for k in PARAM_KEYS}
    return VGGEncoder(params, compute_dtype).to(torch.device(device))


PARAM_KEYS = tuple(f"{n}/{p}" for n in (*CONV_NAMES, "fc6", "fc7")
                   for p in "wb")


class VGGParams(nn.ParameterDict):
    """The encoder's trainable float32 parameters, keyed by checkpoint key
    (``PARAM_KEYS``: ``conv1_1/w`` (3, 3, C, F) HWIO ... ``fc6/w`` (7, 7,
    C, F6), ``fc7/w`` (F6, F7) and the biases); the counterpart of the JAX
    VGG parameter pytree."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        missing = [k for k in PARAM_KEYS if k not in params]
        if missing:
            raise KeyError(f"VGG parameter tree lacks {missing}")
        fc6 = params["fc6/w"]
        if fc6.dim() != 4 or tuple(fc6.shape[:2]) != (7, 7):
            raise ValueError(f"fc6/w {tuple(fc6.shape)}: want (7, 7, C, F)")
        super().__init__({k: nn.Parameter(torch.as_tensor(
            params[k], dtype=torch.float32).detach().clone())
            for k in PARAM_KEYS})

    @classmethod
    def from_numpy(cls, tree: Mapping, device) -> "VGGParams":
        """From a nested or flat numpy tree (see
        :func:`vgg_params_from_numpy`)."""
        flat = flat_tree(tree)
        return cls({k: torch.tensor(np.asarray(flat[k], np.float32))
                    for k in PARAM_KEYS if k in flat}).to(torch.device(device))

    @property
    def device(self) -> torch.device:
        return self["fc7/b"].device

    def encoder(self, compute_dtype: torch.dtype) -> VGGEncoder:
        """A ``VGGEncoder`` on the same device holding a copy of the
        current weights, for extraction and serving through the conv
        kernel (no host round trip)."""
        return VGGEncoder({k: self[k].detach().clone() for k in PARAM_KEYS},
                          compute_dtype)


def init_vgg_params(generator: torch.Generator,
                    width_multiplier: float = 1.0,
                    fc_dim: int | None = None) -> VGGParams:
    """Random VGG-16 parameters on the CPU (for tests and benchmarks
    without the .mat file), with the JAX package's shapes and scales
    (``lrcn_tpu/models/vgg.py:55-89``): conv weights He-normal,
    ``N(0, 2 / (9 C_in))``, at ``max(8, int(width * width_multiplier))``
    channels; fc6 and fc7 ``N(0, 0.01^2)`` at ``fc_dim`` (default 4096);
    biases zero.  Drawn from ``generator`` in layer order (this package's
    own stream, not ``jax.random``'s).  Move them with ``.to``."""
    params: dict[str, torch.Tensor] = {}
    normal = lambda *shape: torch.randn(shape, generator=generator)
    c_in = 3
    for entry in VGG16_LAYOUT:
        if entry == "pool":
            continue
        name, c_out = entry
        c_out = max(8, int(c_out * width_multiplier))
        params[f"{name}/w"] = normal(3, 3, c_in, c_out) * float(
            np.sqrt(2.0 / (9 * c_in)))
        params[f"{name}/b"] = torch.zeros(c_out)
        c_in = c_out
    fc6_dim = fc_dim or FC6_DIM
    fc7_dim = fc_dim or FC7_DIM
    params["fc6/w"] = normal(7, 7, c_in, fc6_dim) * 0.01
    params["fc6/b"] = torch.zeros(fc6_dim)
    params["fc7/w"] = normal(fc6_dim, fc7_dim) * 0.01
    params["fc7/b"] = torch.zeros(fc7_dim)
    return VGGParams(params)


def vgg_param_count(params: Mapping[str, torch.Tensor] | VGGParams) -> int:
    return sum(int(params[k].numel()) for k in PARAM_KEYS)


def vgg16_fc7_train(params: VGGParams, images: torch.Tensor,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """images (B, 224, 224, 3) preprocessed, NHWC -> fc7 (B, F7) float32,
    NO relu7; differentiable in ``params`` and ``images``.

    The XLA path's numerics (``vgg16_fc7_fn(..., use_pallas=False)``):
    each conv runs in ``compute_dtype`` and outputs ``compute_dtype``,
    then ``+ b`` in ``compute_dtype``, then ReLU (two roundings in bf16);
    fc6 is the ``bhwc,hwcf->bf`` product with a float32 result, plus the
    float32 bias, plus ReLU; fc7 a float32-result product plus its bias.
    The activations run as NCHW views of NHWC memory (channels-last), the
    layout cuDNN's fast kernels take.
    """
    cd = compute_dtype
    x = images.permute(0, 3, 1, 2)          # NCHW view, channels-last
    for entry in VGG16_LAYOUT:
        if entry == "pool":
            x = F.max_pool2d(x, 2, 2)        # 'VALID': an odd edge drops
            continue
        name = entry[0]
        w = params[f"{name}/w"].permute(3, 2, 0, 1).to(
            cd, memory_format=torch.channels_last)      # HWIO -> OIHW
        y = F.conv2d(x.to(cd), w, padding=1)
        x = torch.relu(y + params[f"{name}/b"].to(cd)[:, None, None])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
    w6 = params["fc6/w"]
    x = torch.relu(matmul(x, w6.reshape(-1, w6.shape[-1]), cd)
                   + params["fc6/b"].float())
    # fc7 linear: the reference breaks before relu7 (lrcn.jl:717)
    return matmul(x, params["fc7/w"], cd) + params["fc7/b"].float()


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool on NHWC (Knet ``pool`` defaults,
    lrcn.jl:726); an odd last row or column is dropped, as JAX's
    'VALID' window does."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def vgg16_fc7(encoder: VGGEncoder, images: torch.Tensor,
              use_kernels: bool = True) -> torch.Tensor:
    """images (B, 224, 224, 3) preprocessed, NHWC -> fc7 (B, F7) float32,
    NO relu7.

    ``use_kernels=False`` runs every conv through the kernel's plain
    version even on CUDA tensors (the plain path that the kernel is held
    against on the card); the default runs the fused kernel, whose wrapper
    itself takes the plain version for CPU tensors, and on a card runs
    the call as one replay of the graph captured for this shape.
    """
    return graphs.run(encoder, ("fc7",),
                      functools.partial(vgg16_fc7_fn, encoder,
                                        use_kernels=use_kernels),
                      (images,), graph=use_kernels)


def vgg16_fc7_fn(encoder: VGGEncoder, images: torch.Tensor,
                 use_kernels: bool = True) -> torch.Tensor:
    """The eager body of :func:`vgg16_fc7`."""
    cd = encoder.compute_dtype
    x = images
    for entry in VGG16_LAYOUT:
        if entry == "pool":
            x = max_pool(x)
            continue
        w = getattr(encoder, f"{entry[0]}_w")
        b = getattr(encoder, f"{entry[0]}_b")
        x = (fused_conv3x3_relu(x, w, b) if use_kernels
             else conv3x3_relu_reference(x, w, b, cd))
    x = torch.relu(matmul(x.reshape(x.shape[0], -1), encoder.fc6_w, cd)
                   + encoder.fc6_b)
    # fc7 linear: the reference breaks before relu7 (lrcn.jl:717)
    return matmul(x, encoder.fc7_w, cd) + encoder.fc7_b


def vgg16_fc7_grouped(encoder: VGGEncoder, images: torch.Tensor,
                      use_kernels: bool = True) -> torch.Tensor:
    """(K, B, 224, 224, 3) -> (K, B, F7): the counterpart of
    ``vgg16_fc7_scan``, K batches back to back with no host sync; on a
    card one graph replay for all K."""
    def body(images):
        return torch.stack([vgg16_fc7_fn(encoder, batch, use_kernels)
                            for batch in images])

    return graphs.run(encoder, ("fc7_grouped",), body, (images,),
                      graph=use_kernels)


def l1_normalize(feats: torch.Tensor) -> torch.Tensor:
    """The reference's live-image normalization: x / sum(x) (lrcn.jl:597).

    It divides by the plain sum (not the abs-sum), as the JAX package
    does."""
    return feats / feats.sum(dim=-1, keepdim=True)


# --- MatConvNet import (copied from lrcn_tpu/models/vgg.py) ---


def _layer_weights(layer: dict) -> tuple[np.ndarray, np.ndarray] | None:
    """(filters, biases) from a MatConvNet layer struct, or None.

    Handles both release layouts: the beta16+ ``weights`` 1x2 cell (what
    the reference's Knet loader reads, lrcn.jl:706-712) and the original
    2014 release's separate ``filters``/``biases`` fields.  scipy's
    ``simplify_cells`` turns the cell into a list/object-array either way.
    """
    if layer.get("weights") is not None and len(layer["weights"]) >= 2:
        pair = layer["weights"]
        return np.asarray(pair[0]), np.asarray(pair[1])
    if layer.get("filters") is not None:
        return np.asarray(layer["filters"]), np.asarray(layer["biases"])
    return None


def _fc6_weight(w: np.ndarray) -> np.ndarray:
    """fc6 filters -> (7, 7, 512, D).

    The .mat stores fc6 as a (7,7,512,4096) conv (kept as-is; any 4-D
    shape passes through so width-scaled test fixtures work).  If a
    release stores it pre-flattened to 2-D, the flatten was MATLAB
    column-major (the ``mat()`` order the reference relies on,
    lrcn.jl:712,728): row = h + 7*w + 49*c, undone below.
    """
    if w.ndim == 4:
        return w
    if w.ndim == 2 and w.shape[0] == 7 * 7 * 512:
        return w.reshape(512, 7, 7, -1).transpose(2, 1, 0, 3)
    raise ValueError(f"unexpected fc6 weight shape {w.shape}")


def _average_image(mat: dict) -> np.ndarray:
    """normalization.averageImage from either release layout.

    beta16+ nests it under ``meta`` (what the reference reads,
    lrcn.jl:113); the 2014 release keeps ``normalization`` top-level.
    Stored as a (224,224,3) image or a per-channel mean ((3,) / (1,1,3),
    squeezed to (3,) by simplify_cells) — broadcast to the full image.
    """
    norm = None
    meta = mat.get("meta")
    if isinstance(meta, dict):
        norm = meta.get("normalization")
    if norm is None:
        norm = mat.get("normalization")
    if not isinstance(norm, dict) or "averageImage" not in norm:
        raise ValueError(
            "no normalization.averageImage in the .mat (looked under "
            "'meta' and top-level)")
    avg = np.asarray(norm["averageImage"], np.float32)
    avg = avg.reshape(-1) if avg.size == 3 else avg
    if avg.ndim == 1:
        avg = np.broadcast_to(avg, (224, 224, 3)).copy()
    if avg.ndim != 3 or avg.shape[-1] != 3:
        raise ValueError(f"unexpected averageImage shape {avg.shape}")
    return avg


def load_matconvnet(path: str) -> tuple[dict, np.ndarray]:
    """Import ``imagenet-vgg-verydeep-16.mat`` -> (params, average_image).

    ``params`` is the nested numpy tree of the JAX package's
    ``load_matconvnet``: walk the layer list in order, collect weights for
    conv/fc layers, stop at fc7 inclusive (lrcn.jl:697-721).  fc6 keeps its
    (7,7,512,4096) conv structure; fc7 ((1,1,4096,4096), squeezed by scipy
    to 2-D) becomes a dense (4096,4096).  Both MatConvNet release layouts
    load (see ``_layer_weights`` / ``_average_image``).
    """
    from scipy.io import loadmat

    mat = loadmat(path, simplify_cells=True)
    layers = mat["layers"]
    if isinstance(layers, dict):   # single-layer cell squeezed to a struct
        layers = [layers]
    params: dict = {}
    for layer in layers:
        name = str(layer["name"])
        if not (name.startswith("conv") or name.startswith("fc")):
            continue
        pair = _layer_weights(layer)
        if pair is None:
            raise ValueError(f"layer {name!r} has no weights/filters")
        w, b = pair
        b = np.asarray(b, np.float32).reshape(-1)
        w = np.asarray(w, np.float32)
        if name == "fc6":
            w = _fc6_weight(w)
        elif name.startswith("fc"):
            w = w.reshape(-1, w.shape[-1])
        params[name] = {"w": w, "b": b}
        if name == "fc7":
            break
    if "fc7" not in params:
        raise ValueError("no fc7 layer found — not a VGG-16 MatConvNet "
                         "file?")
    return params, _average_image(mat)
