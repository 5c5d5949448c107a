"""Inputs made from ``--seed``: weights, feature rows, images, captions.

Both sides take their inputs from here: the program under test and the
plain reference get the same tensors for the same seed, and neither gets
anything that the other made.  Weights and pixels are drawn on the
device with a ``torch.Generator`` there, in a few large calls, in float32
(the program casts them to its compute dtype itself).  Host-side choices
(ids, lengths, words) come from numpy's generator.

Every draw has a stream number of its own, mixed with the seed, so that
adding a draw never shifts another.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.keys import fold_in, step_seed

_MASK64 = (1 << 64) - 1

# stream numbers
DECODER, VGG, FC7, PIXELS, IDS, CAPTIONS, CHECK = range(1, 8)

# reserved word ids of the vocabulary: EOS, BOS, UNK
EOS_ID, BOS_ID = 0, 1
N_RESERVED = 3


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of run seed ``seed`` (splitmix64)."""
    return step_seed(fold_in(seed & _MASK64, stream))


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def decoder_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The decoder's weights under the checkpoint keys, packed LSTM
    weights ``(X+H, 4H)`` with gates [forget, ingate, outgate, change]."""
    h1, h2 = cfg["hidden"]
    e, f, v, c = (cfg["embed"], cfg["factor_dim"], cfg["vocab_size"],
                  cfg["cnn_feature_dim"])
    return {"lstm1/w": (e + h1, 4 * h1), "lstm1/b": (4 * h1,),
            "lstm2/w": (2 * f + h2, 4 * h2), "lstm2/b": (4 * h2,),
            "w_factor": (h1, f), "w_cnn": (c, f), "embedding": (v, e),
            "w_out": (h2, v), "b_out": (v,)}


def decoder_weights(cfg: dict, seed: int, device, recipe: str
                    ) -> dict[str, torch.Tensor]:
    """The decoder's float32 weights on ``device``.

    ``"train"``: the reference's initialization (lrcn.jl:489-510): every
    matrix Xavier-uniform, forget-gate biases 1, the rest 0.

    ``"serve"``: a stand-in for a trained decoder, from the config's
    ``serving_init`` (what each number does is written there): the same
    draw with gains on the image, word and output matrices, so that
    captions depend on the image and the softmax is not flat, and one
    unit of LSTM-2 that counts steps and raises EOS, so that captions end
    at trained lengths rather than at ``max_words``.
    """
    shapes = decoder_shapes(cfg)
    mats = [k for k, s in shapes.items() if len(s) == 2]
    sizes = [math.prod(shapes[k]) for k in mats]
    draw = torch.empty(sum(sizes), device=device).uniform_(
        -1.0, 1.0, generator=device_generator(seed, DECODER, device))
    gains = cfg["serving_init"]["gains"] if recipe == "serve" else {}
    out = {}
    for key, part in zip(mats, torch.split(draw, sizes)):
        rows, cols = shapes[key]
        limit = math.sqrt(6.0 / (rows + cols)) * gains.get(key, 1.0)
        out[key] = (part * limit).view(rows, cols)
    for key in ("lstm1/b", "lstm2/b"):
        b = torch.zeros(shapes[key], device=device)
        b[:shapes[key][0] // 4] = 1.0
        out[key] = b
    out["b_out"] = torch.zeros(shapes["b_out"], device=device)
    if recipe == "serve":
        _counter_unit(cfg, out)
    return out


def _counter_unit(cfg: dict, w: dict[str, torch.Tensor]) -> None:
    """Unit 0 of LSTM-2 ignores its inputs and integrates a constant:
    its cell grows by about ``rate`` a step, so its output rises from 0
    towards 1 over the caption, and it feeds only the EOS logit."""
    init = cfg["serving_init"]["eos_counter"]
    h2 = cfg["hidden"][1]
    gates = [g * h2 for g in range(4)]   # forget, ingate, outgate, change
    w["lstm2/w"][:, gates] = 0.0
    for g, value in zip(gates, (init["gate_bias"], init["gate_bias"],
                                init["gate_bias"], init["rate"])):
        w["lstm2/b"][g] = value
    w["w_out"][0, :] = 0.0
    w["w_out"][0, EOS_ID] = init["eos_weight"]
    w["b_out"][EOS_ID] = init["eos_bias"]


CONV_NAMES = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1",
              "conv3_2", "conv3_3", "conv4_1", "conv4_2", "conv4_3",
              "conv5_1", "conv5_2", "conv5_3")


def vgg_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """VGG-16's weights under the checkpoint keys: convs HWIO, fc6
    ``(7, 7, C, F6)``, fc7 ``(F6, F7)``."""
    widths = [w for w in cfg["vgg_widths"] if w != "pool"]
    shapes, c_in = {}, 3
    for name, c_out in zip(CONV_NAMES, widths):
        shapes[f"{name}/w"] = (3, 3, c_in, c_out)
        shapes[f"{name}/b"] = (c_out,)
        c_in = c_out
    side = cfg["image_size"] // 32
    f6, f7 = cfg["fc6_dim"], cfg["cnn_feature_dim"]
    shapes.update({"fc6/w": (side, side, c_in, f6), "fc6/b": (f6,),
                   "fc7/w": (f6, f7), "fc7/b": (f7,)})
    return shapes


def vgg_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """VGG-16's float32 weights on ``device``: convs He-normal
    ``N(0, 2 / (9 C_in))``, fc6 and fc7 ``N(0, 0.01^2)``, conv and fc6
    biases 0 (the JAX package's random VGG), and fc7's bias the config's
    ``fc7_bias``: fc7 is taken before relu7 and normalized by its signed
    sum, which a zero-mean random fc7 would bring near 0."""
    shapes = vgg_shapes(cfg)
    mats = [k for k in shapes if k.endswith("/w")]
    sizes = [math.prod(shapes[k]) for k in mats]
    draw = torch.empty(sum(sizes), device=device).normal_(
        generator=device_generator(seed, VGG, device))
    out = {}
    for key, part in zip(mats, torch.split(draw, sizes)):
        shape = shapes[key]
        std = (math.sqrt(2.0 / (9 * shape[2])) if len(shape) == 4
               and shape[0] == 3 else 0.01)
        out[key] = (part * std).view(shape)
    for key in shapes:
        if key.endswith("/b"):
            out[key] = torch.zeros(shapes[key], device=device)
    out["fc7/b"].fill_(cfg["fc7_bias"])
    return out


def fc7_rows(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """``n`` stored fc7 rows, float32 on ``device``: positive, each
    divided by its sum, as the reference's ``featsn`` files hold them."""
    z = torch.empty((n, dim), device=device).normal_(
        generator=device_generator(seed, FC7, device)).abs_()
    return z / z.sum(dim=1, keepdim=True)


def pixels(n: int, size: int, seed: int, device) -> torch.Tensor:
    """``n`` decoded RGB images (n, size, size, 3) uint8 on ``device``."""
    return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8,
                         device=device,
                         generator=device_generator(seed, PIXELS, device))


def mean_image(cfg: dict) -> np.ndarray:
    """The (size, size, 3) float32 mean image subtracted before VGG."""
    size = cfg["image_size"]
    return np.broadcast_to(np.asarray(cfg["mean_rgb"], np.float32),
                           (size, size, 3)).copy()


def image_ids(n: int, seed: int) -> np.ndarray:
    """``n`` distinct image ids in a COCO-like range, in a seeded order."""
    rng = host_rng(seed, IDS)
    return rng.choice(600_000, size=n, replace=False).astype(np.int64)


def vocab_words(cfg: dict) -> list[str]:
    """The non-reserved words, in id order: ``w3`` ... ``w<V-1>``."""
    return [f"w{i}" for i in range(N_RESERVED, cfg["vocab_size"])]


def caption_rows(rng: np.random.Generator, n: int, cfg: dict,
                 traffic: dict) -> tuple[np.ndarray, np.ndarray]:
    """``n`` training captions padded to ``max_len``: (tokens (n, L)
    int32, lengths (n,) int32).  Lengths are uniform in
    ``[min_len, max_len]``; words follow a Zipf law over the vocabulary
    (rank r drawn with weight 1/r), as caption words do."""
    lo, hi = traffic["min_len"], traffic["max_len"]
    lengths = rng.integers(lo, hi + 1, n).astype(np.int32)
    ranks = np.arange(1, cfg["vocab_size"] - N_RESERVED + 1)
    p = 1.0 / ranks
    words = rng.choice(ranks.size, size=(n, hi), p=p / p.sum())
    tokens = (words + N_RESERVED).astype(np.int32)
    tokens[np.arange(hi)[None, :] >= lengths[:, None]] = 0
    return tokens, lengths
