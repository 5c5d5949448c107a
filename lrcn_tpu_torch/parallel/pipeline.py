"""Pipeline parallelism for the LRCN decoder over ``torch.distributed``
(counterpart of ``lrcn_tpu/parallel/pipeline.py``).

Teacher forcing makes every LSTM-1 input known up front, so the
recurrence pipelines: **stage 0 computes h1(t) while stage 1 computes
h2(t-1)**, each on its own rank, every tick.  The pipeline's microbatch is
the timestep; the fill/drain bubble is one tick whatever the length.

Mesh layout ``("data", "model")`` with a ``model`` axis of exactly 2:

- during the recurrence it is the stage axis: each rank holds one LSTM
  layer's weights (the stacked ``lstm_pp`` leaf, sharded over ``model``),
  and h1 hops from stage 0 to stage 1 every tick;
- at the ends it is the vocabulary axis, as in ``parallel/train.py``: the
  embedding table and the output projection shard their vocabulary over
  it, h2 goes back from stage 1 to stage 0 so that both join the
  log-softmax over the sharded vocabulary.

The recurrence is one ``torch.autograd.Function`` (``_Recurrence``).  Its
forward runs the ticks, each rank building the autograd graph of its own
stage; its backward sums the two ranks' cotangents of h2, runs stage 1's
graph, sends the cotangents of h1 back to stage 0 in one message, and runs
stage 0's graph.  So every collective of the backward is issued by one
node in one order on both ranks, whatever autograd's schedule (a hop per
tick written with autograd functions would leave stage 0's hops out of
its backward graph: it uses nothing it receives).

A hop is an ``all_reduce`` over the 2-rank ``model`` group in which the
receiver adds zeros (gloo runs only ``broadcast`` and ``all_reduce`` on
CUDA tensors).  Shape requirements, as in JAX: H1 == H2 == E with H2
even, so both stages run the same (2H, 4H) cell.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.models import lrcn
from lrcn_tpu_torch.models.lrcn import PARAM_KEYS, flat_tree
from lrcn_tpu_torch.ops.lstm import (lstm_cell_update, lstm_recurrent_gates,
                                     matmul)
from lrcn_tpu_torch.parallel.distributed import gather_to_host
from lrcn_tpu_torch.parallel.mesh import Mesh
from lrcn_tpu_torch.parallel.train import (MeshStep, _all_reduce,
                                           param_sharding, reduce_both,
                                           shard_tree, sum_over_data,
                                           vocab_parallel_embedding,
                                           vocab_parallel_nll)

N_STAGES = 2  # the factored LRCN decoder has exactly 2 LSTM layers

PIPELINE_PARAM_SPECS: dict[str, tuple] = {
    "lstm_pp/w": ("model", None, None), "lstm_pp/b": ("model", None),
    "w_factor": (), "w_cnn": (),
    "embedding": ("model", None),
    "w_out": (None, "model"),
    "b_out": ("model",),
}
# optax's flattening order of the pipeline tree: sorted keys
PIPELINE_OPT_KEYS = tuple(sorted(PIPELINE_PARAM_SPECS))


def validate_pipeline_config(cfg: LRCNConfig, mesh: Mesh) -> None:
    h1, h2 = cfg.hidden
    if mesh.shape.get("model", 1) != N_STAGES:
        raise ValueError(
            f"pipeline parallelism uses a 'model' mesh axis of exactly "
            f"{N_STAGES} (one device group per LSTM layer); got "
            f"{mesh.shape.get('model', 1)}")
    if not (h1 == h2 == cfg.embed and h2 % 2 == 0):
        raise ValueError(
            f"pipeline parallelism requires hidden1 == hidden2 == embed "
            f"with an even hidden size so both stages run one uniform cell "
            f"program; got hidden={cfg.hidden}, embed={cfg.embed} "
            f"(the reference defaults 1000/1000/1000 qualify)")
    if cfg.vocab_size % N_STAGES:
        raise ValueError(
            f"vocab_size={cfg.vocab_size} must be divisible by {N_STAGES} "
            f"for the vocab-TP softmax on the same axis")


def _as_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_pipeline_params(params) -> dict[str, np.ndarray]:
    """Decoder tree (nested JAX layout or flat checkpoint keys, numpy or
    tensors) -> the pipeline layout, flat keys, the two cells stacked."""
    flat = flat_tree(params)
    out = {k: _as_array(v) for k, v in flat.items()
           if not k.startswith(("lstm1/", "lstm2/"))}
    for leaf in ("w", "b"):
        out[f"lstm_pp/{leaf}"] = np.stack([_as_array(flat[f"lstm1/{leaf}"]),
                                           _as_array(flat[f"lstm2/{leaf}"])])
    return out


def from_pipeline_params(pp_params) -> dict[str, np.ndarray]:
    """Pipeline layout (nested or flat) -> the decoder tree, flat
    checkpoint keys (for checkpoints and decoding)."""
    flat = flat_tree(pp_params)
    out = {k: _as_array(v) for k, v in flat.items()
           if not k.startswith("lstm_pp/")}
    for leaf in ("w", "b"):
        stacked = _as_array(flat[f"lstm_pp/{leaf}"])
        out[f"lstm1/{leaf}"], out[f"lstm2/{leaf}"] = stacked[0], stacked[1]
    return out


def _hop(x: torch.Tensor, group, sender: bool) -> torch.Tensor:
    """``x`` from the sending rank of a 2-rank group to the other, as an
    ``all_reduce`` in which the receiver adds zeros; the sender gets zeros
    back."""
    buf = x.detach().clone() if sender else torch.zeros_like(x)
    dist.all_reduce(buf, group=group)
    return torch.zeros_like(x) if sender else buf


class _Recurrence(torch.autograd.Function):
    """The pipelined two-layer recurrence: (T, B, E) embeddings (after
    dropout) -> (T, B, H) h2, on both stages.  See the module docstring."""

    @staticmethod
    def forward(ctx, embeds, cnn_proj, w_factor, w, b, mask2, group, stage,
                compute_dtype):
        t_dim, b_dim, e_dim = embeds.shape
        h_dim = w.shape[-1] // 4
        f2 = 2 * w_factor.shape[-1]
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in (embeds, cnn_proj, w_factor, w, b)]
        embeds_, cnn_proj_, w_factor_, w_, b_ = inputs
        zeros = embeds.new_zeros((b_dim, h_dim), dtype=torch.float32)
        outs, bufs = [], []
        with torch.enable_grad():
            h, c = zeros, zeros
            if stage == 0:
                x_proj = matmul(embeds_.reshape(t_dim * b_dim, e_dim),
                                w_[:e_dim], compute_dtype
                                ).reshape(t_dim, b_dim, 4 * h_dim)
                w_h = w_[e_dim:]
            else:
                w_x, w_h = w_[:f2], w_[f2:]
            b32 = b_.float()
            buf = zeros
            for k in range(t_dim + 1):
                # a stage's recurrence starts at tick == stage: during the
                # fill tick stage 1 stays at the zero state (lrcn.jl:512)
                if stage == 0 and k < t_dim:
                    h, c = lstm_cell_update(lstm_recurrent_gates(
                        w_h, b32, h, x_proj[k], compute_dtype=compute_dtype),
                        c)
                    outs.append(h)
                elif stage == 1 and k >= 1:
                    # stage 1's input: h1 of the previous tick through the
                    # factor projection, with the CNN projection
                    # (lrcn.jl:545-547); the dropout mask shifted one tick
                    x2 = torch.cat([matmul(buf, w_factor_, compute_dtype),
                                    cnn_proj_], dim=-1)
                    if mask2 is not None:
                        x2 = x2 * mask2[k - 1]
                    gates = (matmul(x2, w_x, compute_dtype)
                             + matmul(h, w_h, compute_dtype) + b32)
                    h, c = lstm_cell_update(gates, c)
                    outs.append(h)
                if k < t_dim:   # h1(k) hops to stage 1
                    buf = _hop(h, group, sender=stage == 0)
                    if stage == 1:
                        buf.requires_grad_()
                        bufs.append(buf)
            seq = torch.stack(outs)
        # stage 1's h2 goes to stage 0: both join the vocab-TP softmax
        h2 = _hop(seq if stage == 1 else seq.new_zeros(seq.shape), group,
                  sender=stage == 1)
        ctx.group, ctx.stage = group, stage
        ctx.graph = (inputs, seq, bufs)
        return (seq.detach() if stage == 1 else h2)

    @staticmethod
    def backward(ctx, grad_h2):
        group, stage = ctx.group, ctx.stage
        inputs, seq, bufs = ctx.graph
        ctx.graph = None
        # h2's cotangent sums both ranks' shares of the softmax
        grad_h2 = _all_reduce(grad_h2.contiguous(), group)
        wanted = [t for t in inputs if t.requires_grad]
        if stage == 1:
            grads = torch.autograd.grad(seq, wanted + bufs, grad_h2,
                                        allow_unused=True)
            grad_h1 = torch.stack([
                g if g is not None else torch.zeros_like(b)
                for g, b in zip(grads[len(wanted):], bufs)])
            grads = grads[:len(wanted)]
            _hop(grad_h1, group, sender=True)
        else:
            grad_h1 = _hop(seq.new_zeros(seq.shape), group, sender=False)
            grads = torch.autograd.grad(seq, wanted, grad_h1,
                                        allow_unused=True)
        by_input = dict(zip(map(id, wanted), grads))
        out = []
        for t in inputs:
            g = by_input.get(id(t))
            if g is None and t.requires_grad:
                g = torch.zeros_like(t)   # this stage does not read it
            out.append(g)
        return (*out, None, None, None, None)


def pipeline_loss_total_count(pp_params: Mapping[str, torch.Tensor],
                              tokens: torch.Tensor, lengths: torch.Tensor,
                              feats: torch.Tensor, mesh: Mesh, *,
                              drop_masks: tuple | None = None,
                              compute_dtype: torch.dtype = torch.bfloat16
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's NLL sum (with gradient) over its rows and the GLOBAL
    token count, pipelined over the mesh.  Semantics identical to
    ``lrcn.loss_total_count`` (teacher forcing with the extra EOS step,
    masked padding).  ``drop_masks``: this rank's rows of the (T, B, E)
    and (T, B, 2F) dropout masks."""
    group, stage = mesh.group("model"), mesh.coord("model")
    if group is None:
        raise ValueError("the pipelined loss runs in a process group of "
                         "one rank per mesh entry")
    inputs, targets, mask = lrcn.build_teacher_forcing(tokens, lengths)
    b_dim, t_dim = inputs.shape
    # both stages look up their vocabulary shard; the sum goes forward
    # to stage 0, and its cotangent back from stage 0 to both
    partial = vocab_parallel_embedding(inputs.t(), pp_params["embedding"],
                                       None, stage)
    embeds = reduce_both(partial, group)
    mask2 = None
    if drop_masks is not None:
        embeds = embeds * drop_masks[0]
        mask2 = drop_masks[1]
    cnn_proj = lrcn.cnn_projection(pp_params, feats, compute_dtype)
    h2_seq = _Recurrence.apply(embeds, cnn_proj, pp_params["w_factor"],
                               pp_params["lstm_pp/w"][0],
                               pp_params["lstm_pp/b"][0], mask2, group,
                               stage, compute_dtype)
    logits = lrcn.output_logits(pp_params, h2_seq.reshape(t_dim * b_dim, -1),
                                compute_dtype)
    nll = vocab_parallel_nll(logits, targets.t().reshape(-1).long(), group,
                             stage)
    mask_flat = mask.t().reshape(-1).float()
    return (nll * mask_flat).sum(), sum_over_data(mask_flat.sum(), mesh)


def pipeline_loss_fn(pp_params, tokens, lengths, feats, mesh: Mesh, *,
                     drop_masks: tuple | None = None,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """This rank's share of the global mean NLL: its NLL sum over the
    global token count.  Its gradient, summed over ``data``
    (``PipelinedTrainStep``'s optimizer), is the global loss's."""
    total, count = pipeline_loss_total_count(
        pp_params, tokens, lengths, feats, mesh, drop_masks=drop_masks,
        compute_dtype=compute_dtype)
    return total / count


class PipelinedTrainStep(MeshStep):
    """A DP x (PP + vocabulary TP) train step, one rank per mesh entry.

    Same host-facing API as ``ShardedTrainStep``; parameters live in the
    pipeline layout (``shard_params`` takes the standard decoder tree,
    ``unshard_params`` gives it back, gathered; collective)."""

    specs = PIPELINE_PARAM_SPECS
    opt_keys = PIPELINE_OPT_KEYS
    # only stage 1 reads these replicated weights: their gradients sum
    # over both axes (stage 0's share is zero)
    reduce_axes = {"w_factor": ("data", "model"),
                   "w_cnn": ("data", "model")}
    # eager even on NCCL: its model axis of 2 needs two ranks, which one
    # card gives only over gloo, so no graph of it has been checked
    capturable = False

    def __init__(self, cfg: LRCNConfig, mesh: Mesh):
        validate_pipeline_config(cfg, mesh)
        super().__init__(cfg, mesh)

    def loss_total_count(self, pp_params, tokens, lengths, feats, *,
                         drop_masks=None):
        return pipeline_loss_total_count(
            pp_params, tokens, lengths, feats, self.mesh,
            drop_masks=drop_masks, compute_dtype=self.compute_dtype)

    def shard_params(self, params) -> nn.ParameterDict:
        local = shard_tree(to_pipeline_params(params),
                           param_sharding(self.mesh, self.specs),
                           self.device)
        return nn.ParameterDict({k: nn.Parameter(v)
                                 for k, v in local.items()})

    def unshard_params(self, pp_params) -> dict[str, np.ndarray]:
        full = gather_to_host({k: pp_params[k] for k in self.specs},
                              self.mesh, self.specs)
        out = from_pipeline_params(full)
        return {k: out[k] for k in PARAM_KEYS}


__all__ = [
    "N_STAGES", "PIPELINE_PARAM_SPECS", "PIPELINE_OPT_KEYS",
    "validate_pipeline_config", "to_pipeline_params",
    "from_pipeline_params", "pipeline_loss_total_count",
    "pipeline_loss_fn", "PipelinedTrainStep",
]
