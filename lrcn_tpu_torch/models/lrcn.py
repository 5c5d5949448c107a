"""The LRCN caption decoder on PyTorch (counterpart of
``lrcn_tpu/models/lrcn.py``), inference side.

Same architecture, shapes and gate order as the JAX package (reference
lrcn.jl:489-551): word embedding (V, E); LSTM-1 over embeddings; factor
projection h1 -> F; CNN projection fc7 -> F computed once per batch and
concatenated with the factor output every step; LSTM-2 over the (2F,)
concat; output projection H2 -> V plus bias.  LSTM weights stay packed
``(X+H, 4H)`` with gate order [forget, ingate, outgate, change].

``LRCNDecoder`` owns the weights on one device.  It keeps each matmul
weight in the compute dtype, cast once at load (bf16 operands with f32
accumulation, as in JAX); biases and the embedding stay float32, and so
does the recurrent state.  ``decode_step`` runs both LSTM cells through the
fused CUDA kernel and leaves the embedding gather, the factor and CNN
projections and the output projection to plain ``torch`` ops, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from lrcn_tpu_torch.ops.kernels import fused_lstm_step, lstm_step_reference
from lrcn_tpu_torch.ops.lstm import matmul

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

    Build it with :func:`params_from_numpy`.  The weights are buffers: the
    serving slice computes no gradient.
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

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @property
    def hidden(self) -> tuple[int, int]:
        return self.lstm1_b.shape[0] // 4, self.lstm2_b.shape[0] // 4


def flat_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested or flat parameter tree as '/'-joined keys -> numpy."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flat_tree(value, name + "/"))
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


def init_state(decoder: LRCNDecoder, batch: int, device) -> LSTMState:
    """Zero recurrent state (reference: initstate lrcn.jl:512-526)."""
    h1, h2 = decoder.hidden
    z = lambda d: torch.zeros((batch, d), dtype=torch.float32, device=device)
    return LSTMState(z(h1), z(h1), z(h2), z(h2))


def cnn_projection(decoder: LRCNDecoder, feats: torch.Tensor
                   ) -> torch.Tensor:
    """Project fc7 features once per batch (reference: lrcn.jl:558,611)."""
    return matmul(feats, decoder.w_cnn, decoder.compute_dtype)


def output_logits(decoder: LRCNDecoder, h2: torch.Tensor) -> torch.Tensor:
    """h2 -> vocabulary logits, float32 (reference: lrcn.jl:550)."""
    return matmul(h2, decoder.w_out, decoder.compute_dtype) + decoder.b_out


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
