"""The LRCN caption decoder on PyTorch (counterpart of
``lrcn_tpu/models/lrcn.py``).

Same architecture, shapes and gate order as the JAX package (reference
lrcn.jl:489-551): word embedding (V, E); LSTM-1 over embeddings; factor
projection h1 -> F; CNN projection fc7 -> F computed once per batch and
concatenated with the factor output every step; LSTM-2 over the (2F,)
concat; output projection H2 -> V plus bias.  LSTM weights stay packed
``(X+H, 4H)`` with gate order [forget, ingate, outgate, change].

Inference: ``LRCNDecoder`` owns the weights on one device.  It keeps each
matmul weight in the compute dtype, cast once at load (bf16 operands with
f32 accumulation, as in JAX); biases and the embedding stay float32, and
so does the recurrent state.  ``decode_step`` runs both LSTM cells through
the fused CUDA kernel and leaves the embedding gather, the factor and CNN
projections and the output projection to plain ``torch`` ops, as the JAX
package leaves them to XLA.

Training: ``LRCNParams`` holds the same weights as float32
``nn.Parameter``s under the checkpoint keys (``PARAM_KEYS``).  The
teacher-forced loss (``loss_total_count``, ``loss_fn``) is plain PyTorch
with autograd: the fused LSTM kernel has no backward, as the Pallas kernel
has no VJP, so ``unroll_h2`` runs the cells as matmuls and elementwise ops.
Layer 1's input projection is hoisted out of the time loop into one
``(T*B, E) @ (E, 4H1)`` product, as in JAX.  Functions that take
``params`` accept either an ``LRCNParams`` or an ``LRCNDecoder`` (both
index by checkpoint key).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.vocab import BOS_ID, EOS_ID
from lrcn_tpu_torch.ops.kernels import fused_lstm_step, lstm_step_reference
from lrcn_tpu_torch.ops.lstm import (lstm_cell_update, lstm_recurrent_gates,
                                     matmul)

# params.npz keys of the JAX checkpoint format (train/checkpoint.py:9-16)
PARAM_KEYS = ("lstm1/w", "lstm1/b", "lstm2/w", "lstm2/b", "w_factor",
              "w_cnn", "embedding", "w_out", "b_out")
# the weights the decoder keeps in the compute dtype
_COMPUTE_KEYS = ("lstm1/w", "lstm2/w", "w_factor", "w_cnn", "w_out")


class LSTMState(NamedTuple):
    """Recurrent state of the 2-layer decoder (reference: lrcn.jl:512-526),
    each (B, H) float32."""
    h1: torch.Tensor
    c1: torch.Tensor
    h2: torch.Tensor
    c2: torch.Tensor


class LRCNDecoder(nn.Module):
    """The decoder's weights on one device, ready for ``decode_step``.

    Build it with :func:`params_from_numpy` or :meth:`LRCNParams.decoder`.
    The weights are buffers: decoding computes no gradient.
    """

    def __init__(self, params: Mapping[str, torch.Tensor],
                 compute_dtype: torch.dtype):
        super().__init__()
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, "
                             f"got {compute_dtype}")
        self.compute_dtype = compute_dtype
        for key in PARAM_KEYS:
            dtype = (compute_dtype if key in _COMPUTE_KEYS
                     else torch.float32)
            self.register_buffer(key.replace("/", "_"),
                                 params[key].to(dtype).contiguous())

    def __getitem__(self, key: str) -> torch.Tensor:
        """The weight under checkpoint key ``key`` (e.g. ``"lstm1/w"``)."""
        return getattr(self, key.replace("/", "_"))

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @property
    def hidden(self) -> tuple[int, int]:
        return self.lstm1_b.shape[0] // 4, self.lstm2_b.shape[0] // 4


class LRCNParams(nn.ParameterDict):
    """The decoder's trainable float32 parameters, keyed by checkpoint key
    (``PARAM_KEYS``); the counterpart of the JAX parameter pytree."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        missing = [k for k in PARAM_KEYS if k not in params]
        if missing:
            raise KeyError(f"parameter tree lacks {missing}")
        super().__init__({k: nn.Parameter(torch.as_tensor(
            params[k], dtype=torch.float32).detach().clone())
            for k in PARAM_KEYS})

    @classmethod
    def from_numpy(cls, tree: Mapping, device) -> "LRCNParams":
        """From a nested or flat numpy tree (see :func:`params_from_numpy`)."""
        flat = flat_tree(tree)
        return cls({k: torch.tensor(np.asarray(flat[k], np.float32))
                    for k in PARAM_KEYS if k in flat}).to(torch.device(device))

    @property
    def device(self) -> torch.device:
        return self["embedding"].device

    def decoder(self, compute_dtype: torch.dtype) -> LRCNDecoder:
        """An ``LRCNDecoder`` on the same device holding a copy of the
        current weights, for evaluation and serving (no host round trip)."""
        return LRCNDecoder({k: self[k].detach().clone() for k in PARAM_KEYS},
                           compute_dtype)


def _is_tree(value) -> bool:
    return (isinstance(value, (Mapping, nn.ParameterDict))
            or hasattr(value, "_asdict"))


def flat_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested or flat parameter tree (numpy arrays or tensors, e.g. an
    ``LRCNParams``, or a NamedTuple of such, e.g. a ``JointParams``) as
    '/'-joined keys -> numpy, a host copy."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if _is_tree(value):
            out.update(flat_tree(value, name + "/"))
        elif isinstance(value, torch.Tensor):
            out[name] = value.detach().cpu().numpy()
        else:
            out[name] = np.asarray(value)
    return out


def params_from_numpy(tree: Mapping, device, compute_dtype: torch.dtype
                      ) -> LRCNDecoder:
    """Build a decoder on ``device`` from the JAX parameter pytree.

    ``tree`` holds numpy arrays, either nested (``{"lstm1": {"w": ...}}``,
    as ``lrcn_tpu.models.lrcn.init_params`` returns after ``np.asarray``)
    or flat with the checkpoint's '/'-joined keys (``"lstm1/w"``).
    """
    flat = flat_tree(tree)
    missing = [k for k in PARAM_KEYS if k not in flat]
    if missing:
        raise KeyError(f"parameter tree lacks {missing}")
    device = torch.device(device)
    params = {k: torch.tensor(np.asarray(flat[k], np.float32))
              for k in PARAM_KEYS}
    return LRCNDecoder(params, compute_dtype).to(device)


def xavier_uniform(shape: tuple[int, int], generator: torch.Generator
                   ) -> torch.Tensor:
    """Xavier/Glorot uniform, matching Knet's ``xavier`` (lrcn.jl:490)."""
    scale = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape).uniform_(-scale, scale, generator=generator)


def init_params(cfg: LRCNConfig, generator: torch.Generator) -> LRCNParams:
    """Initialize the decoder's parameters on the CPU (reference:
    lrcn.jl:489-510), drawn from ``generator`` in the JAX package's order;
    forget-gate biases are 1 (lrcn.jl:501).  Move them with ``.to``."""
    if cfg.vocab_size <= 0:
        raise ValueError("cfg.vocab_size must be set before init_params")
    h1, h2 = cfg.hidden
    e, f, v, c = cfg.embed, cfg.factor_dim, cfg.vocab_size, cfg.cnn_feature_dim

    def bias(h):
        b = torch.zeros(4 * h)
        b[:h] = 1.0
        return b

    params = {"lstm1/w": xavier_uniform((e + h1, 4 * h1), generator),
              "lstm1/b": bias(h1),
              "lstm2/w": xavier_uniform((2 * f + h2, 4 * h2), generator),
              "lstm2/b": bias(h2)}
    params["w_factor"] = xavier_uniform((h1, f), generator)
    params["w_cnn"] = xavier_uniform((c, f), generator)
    params["embedding"] = xavier_uniform((v, e), generator)
    params["w_out"] = xavier_uniform((h2, v), generator)
    params["b_out"] = torch.zeros(v)
    return LRCNParams(params)


def param_count(params: Mapping[str, torch.Tensor]) -> int:
    return sum(int(params[k].numel()) for k in PARAM_KEYS)


def _dtype(params, compute_dtype: torch.dtype | None) -> torch.dtype:
    """``compute_dtype``, or by default a decoder's own."""
    if compute_dtype is None:
        return params.compute_dtype
    return compute_dtype


def init_state(decoder: LRCNDecoder, batch: int, device) -> LSTMState:
    """Zero recurrent state (reference: initstate lrcn.jl:512-526)."""
    h1, h2 = decoder.hidden
    z = lambda d: torch.zeros((batch, d), dtype=torch.float32, device=device)
    return LSTMState(z(h1), z(h1), z(h2), z(h2))


def cnn_projection(params, feats: torch.Tensor,
                   compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Project fc7 features once per batch (reference: lrcn.jl:558,611).
    ``compute_dtype`` defaults to a decoder's own."""
    return matmul(feats, params["w_cnn"], _dtype(params, compute_dtype))


def output_logits(params, h2: torch.Tensor,
                  compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """h2 -> vocabulary logits, float32 (reference: lrcn.jl:550)."""
    return (matmul(h2, params["w_out"], _dtype(params, compute_dtype))
            + params["b_out"].float())


def unroll_h2(params: Mapping[str, torch.Tensor],
              input_embeds: torch.Tensor, cnn_proj: torch.Tensor,
              drop_mask2: torch.Tensor | None = None,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Teacher-forced unroll returning the layer-2 hidden sequence.

    Args:
      input_embeds: (T, B, E) time-major embedded inputs (dropout, if any,
        already applied by the caller).
      cnn_proj: (B, F) CNN factor, injected every step (lrcn.jl:546).
      drop_mask2: optional (T, B, 2F) inverted-dropout mask for the LSTM-2
        input concat (lrcn.jl:547).

    Returns: (T, B, H2) float32 hidden states of LSTM-2.
    """
    t_dim, b_dim, e_dim = input_embeds.shape
    w1, b1 = params["lstm1/w"], params["lstm1/b"]
    w2, b2 = params["lstm2/w"], params["lstm2/b"]
    h1_dim, h2_dim = b1.shape[-1] // 4, b2.shape[-1] // 4
    f_dim = params["w_factor"].shape[-1]

    # one (T*B, E) @ (E, 4H1) product instead of T small ones
    x1_proj = matmul(input_embeds.reshape(t_dim * b_dim, e_dim), w1[:e_dim],
                     compute_dtype).reshape(t_dim, b_dim, 4 * h1_dim)
    # the weights' halves each step reads, sliced once: one autograd node
    # each, whose gradient sums the T steps' before flowing back (a slice
    # inside the loop would scatter T full-size gradients).  They stay in
    # the parameters' dtype and ``matmul`` casts them inside the loop, as
    # JAX does in its scan body, so each step's bf16 gradient goes back
    # through its cast and the T steps are summed in float32.
    w1h = w1[e_dim:]
    w2x, w2h = w2[:2 * f_dim], w2[2 * f_dim:]
    b1, b2 = b1.float(), b2.float()

    zeros = lambda d: cnn_proj.new_zeros((b_dim, d), dtype=torch.float32)
    h1, c1, h2, c2 = zeros(h1_dim), zeros(h1_dim), zeros(h2_dim), zeros(h2_dim)
    h2_seq = []
    for t in range(t_dim):
        gates1 = lstm_recurrent_gates(w1h, b1, h1, x1_proj[t],
                                      compute_dtype=compute_dtype)
        h1, c1 = lstm_cell_update(gates1, c1)
        h1f = matmul(h1, params["w_factor"], compute_dtype)   # lrcn.jl:545
        x2 = torch.cat([h1f, cnn_proj], dim=-1)               # lrcn.jl:546
        if drop_mask2 is not None:
            x2 = x2 * drop_mask2[t]                           # lrcn.jl:547
        gates2 = (matmul(x2, w2x, compute_dtype)
                  + matmul(h2, w2h, compute_dtype) + b2)
        h2, c2 = lstm_cell_update(gates2, c2)
        h2_seq.append(h2)
    return torch.stack(h2_seq)


def build_teacher_forcing(tokens: torch.Tensor, lengths: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Build (inputs, targets, mask) for teacher-forced training.

    ``tokens`` is (B, L) padded token ids; ``lengths`` is (B,).  Produces
    T = L+1 steps: inputs = [BOS, tok_0..tok_{L-1}], targets =
    [tok_0..tok_{L-1}, *] with EOS written at position ``lengths[b]`` (the
    reference's extra EOS-prediction step, lrcn.jl:572-579), and a mask
    selecting positions <= lengths[b]; a filler row (length -1) has none.
    """
    b_dim, l_dim = tokens.shape
    bos = torch.full((b_dim, 1), BOS_ID, dtype=tokens.dtype,
                     device=tokens.device)
    inputs = torch.cat([bos, tokens], dim=1)                   # (B, L+1)
    targets = torch.cat([tokens, torch.zeros_like(bos)], dim=1)
    pos = torch.arange(l_dim + 1, device=tokens.device)[None, :]
    targets = targets.masked_fill(pos == lengths[:, None], EOS_ID)
    mask = pos <= lengths[:, None]
    return inputs, targets, mask


def dropout_masks(shape1: tuple[int, ...], shape2: tuple[int, ...],
                  pdrop: float, generator: torch.Generator
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverted-dropout multipliers (0 or 1/keep), float32, on the
    generator's device: ``shape1`` for the embeddings, ``shape2`` for the
    LSTM-2 input (Knet's dropout scaling, lrcn.jl:542,547)."""
    keep = 1.0 - pdrop
    device = generator.device
    return tuple(
        (torch.rand(shape, generator=generator, device=device) < keep
         ).float() / keep
        for shape in (shape1, shape2))


def loss_total_count(params: Mapping[str, torch.Tensor],
                     tokens: torch.Tensor, lengths: torch.Tensor,
                     feats: torch.Tensor, *, pdrop: float = 0.0,
                     generator: torch.Generator | None = None,
                     drop_masks: tuple[torch.Tensor, torch.Tensor] | None
                     = None,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed teacher-forced NLL and prediction count for one batch (the
    building block of the per-batch mean loss and of the dataset-level
    ``average_loss``, lrcn.jl:407-486).

    With ``pdrop > 0`` the dropout multipliers are ``drop_masks`` (a
    (T, B, E) and a (T, B, 2F) tensor of 0 and 1/keep, e.g. the ones the
    JAX package draws) or, if that is None, drawn from ``generator``.
    """
    inputs, targets, mask = build_teacher_forcing(tokens, lengths)
    b_dim, t_dim = inputs.shape

    embeds = F.embedding(inputs.t(), params["embedding"])   # (T, B, E)
    drop_mask2 = None
    if pdrop > 0.0:
        if drop_masks is None:
            if generator is None:
                raise ValueError("dropout requires a generator or "
                                 "drop_masks")
            f2 = 2 * params["w_factor"].shape[-1]
            drop_masks = dropout_masks(tuple(embeds.shape),
                                       (t_dim, b_dim, f2), pdrop, generator)
        embeds = embeds * drop_masks[0]
        drop_mask2 = drop_masks[1]

    cnn_proj = cnn_projection(params, feats, compute_dtype)
    h2_seq = unroll_h2(params, embeds, cnn_proj, drop_mask2, compute_dtype)

    # one output product over all timesteps (T*B, H2) @ (H2, V)
    logits = output_logits(params, h2_seq.reshape(t_dim * b_dim, -1),
                           compute_dtype)
    # -log_softmax at the gold token (lrcn.jl:562)
    nll = F.cross_entropy(logits, targets.t().reshape(-1).long(),
                          reduction="none")
    mask_flat = mask.t().reshape(-1).float()
    return (nll * mask_flat).sum(), mask_flat.sum()


def loss_fn(params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
            lengths: torch.Tensor, feats: torch.Tensor, **kwargs
            ) -> torch.Tensor:
    """Mean per-token teacher-forced NLL, including the EOS step (the
    reference's ``loss``, lrcn.jl:553-581, with padding masked out).
    Keyword arguments as :func:`loss_total_count`."""
    total, count = loss_total_count(params, tokens, lengths, feats, **kwargs)
    return total / count


def decode_step(decoder: LRCNDecoder, state: LSTMState,
                token_ids: torch.Tensor, cnn_proj: torch.Tensor,
                use_kernels: bool = True
                ) -> tuple[LSTMState, torch.Tensor]:
    """Single generation step: last token ids -> next-token logits.

    ``use_kernels=False`` runs both cells through the kernel's plain
    version even on CUDA tensors (the plain path that the kernels are held
    against on the card); the default runs the fused kernel, whose wrapper
    itself takes the plain version for CPU tensors.
    """
    cell = fused_lstm_step if use_kernels else lstm_step_reference
    x = decoder.embedding[token_ids]                              # (B, E)
    h1, c1 = cell(decoder.lstm1_w, decoder.lstm1_b, state.h1, state.c1, x)
    h1f = matmul(h1, decoder.w_factor, decoder.compute_dtype)
    x2 = torch.cat([h1f, cnn_proj], dim=-1)
    h2, c2 = cell(decoder.lstm2_w, decoder.lstm2_b, state.h2, state.c2, x2)
    return LSTMState(h1, c1, h2, c2), output_logits(decoder, h2)
