"""Sharded training step: data parallel over ``data``, vocabulary tensor
parallel over ``model`` (counterpart of ``lrcn_tpu/parallel/train.py``).

JAX runs one jitted program over the mesh and lets GSPMD place the
collectives.  Here each rank of a ``torch.distributed`` group runs its own
step on its device and the collectives are written out:

- the batch is split over ``data``: each rank computes the loss of its
  rows.  The loss differentiated is the GLOBAL mean: the local NLL sum
  over the global token count (an ``all_reduce`` with no gradient), and
  the gradients are summed over ``data``.  Averaging per-rank means would
  weight ranks with fewer tokens up;
- the embedding table (V, E) is row-sharded and the output projection
  (H2, V) and its bias column-sharded over ``model`` (``PARAM_SPECS``);
  the rest is replicated.  The lookup over a row shard sums over
  ``model`` in the forward only (``reduce_forward``); ``h2`` enters the
  column shard through the conjugate operator (``reduce_backward``); the
  log-softmax over the sharded vocabulary takes the max, the exp-sum and
  the gold logit over ``model`` (``vocab_parallel_nll``), as
  ``lrcn_tpu/parallel/pipeline.py:155-174`` does;
- the optimizer holds each rank's shards (Adam is elementwise); the
  clip's global norm sums the squared norms of the sharded leaves over
  ``model`` and counts the replicated ones once, which is optax's norm of
  the global arrays; checkpoints gather the parameters and the moments to
  their global shapes (``gather_to_host``), the 19 optax leaves.

Dropout draws the GLOBAL masks from the step's generator on every rank and
keeps this rank's rows, so a mesh run equals the one-device run; tests
inject JAX's masks (``drop_masks=``) and they are sliced the same way.

Every collective is an ``all_reduce`` (``parallel/distributed.py``).

As JAX jits its sharded step, on NCCL groups each ``step`` and each
``eval_batch`` is one CUDA graph replay (``utils/graphs.py``): a
signature's first call runs the eager body (``step_fn``, ``eval_fn``) and
makes the groups' communicators, the second captures it with its
``all_reduce``s, every later one replays it.  The step's dropout
generator is one that ``graphs.step`` seeds from the step key before each
call.  Under gloo (the CPU, or two ranks on one card) the bodies run
eagerly: gloo's collectives run on the host, out of a capture's reach.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.models import lrcn
from lrcn_tpu_torch.models.lrcn import PARAM_KEYS, LRCNParams, flat_tree
from lrcn_tpu_torch.parallel.distributed import gather_to_host
from lrcn_tpu_torch.parallel.mesh import Mesh
from lrcn_tpu_torch.train.checkpoint import OPT_KEYS, compute_dtype_of
from lrcn_tpu_torch.train.trainer import (adam_leaves, adam_state,
                                          load_adam_leaves, make_adam,
                                          step_generator, step_seed)
from lrcn_tpu_torch.utils import graphs

# shard rule per decoder parameter: one mesh axis name (or None) per
# dimension; () is replicated.  The vocabulary dimension shards over
# "model": at LRCN scale (~30M parameters) only the V-sized tensors are
# worth sharding.
PARAM_SPECS: dict[str, tuple] = {
    "lstm1/w": (), "lstm1/b": (), "lstm2/w": (), "lstm2/b": (),
    "w_factor": (), "w_cnn": (),
    "embedding": ("model", None),
    "w_out": (None, "model"),
    "b_out": ("model",),
}


# --- collectives with autograd ---


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, op=op, group=group)
    return x


class _ReduceForward(torch.autograd.Function):
    """Sum over ``group`` in the forward, identity in the backward: for a
    partial result (a lookup over a row shard, a partial exp-sum) whose
    sum every rank of the group then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceBackward(torch.autograd.Function):
    """Identity in the forward, sum over ``group`` in the backward: where
    a replicated tensor enters a sharded product (``h2`` into the column
    shard of ``w_out``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceBoth(torch.autograd.Function):
    """Sum over ``group`` in both directions: for a partial result whose
    sum only some ranks use (the pipeline's first stage reads the
    embeddings, the second does not)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def reduce_forward(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceForward.apply(x, group)


def reduce_backward(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceBackward.apply(x, group)


def reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceBoth.apply(x, group)


def vocab_parallel_embedding(ids: torch.Tensor, table: torch.Tensor,
                             group, index: int) -> torch.Tensor:
    """Rows of an embedding table sharded by rows over ``group`` (this
    rank holds shard ``index``): each rank looks up the ids in its shard,
    zeros elsewhere, and the shards' lookups are summed."""
    v_local = table.shape[0]
    local = ids - index * v_local
    inside = (local >= 0) & (local < v_local)
    rows = F.embedding(local.clamp(0, v_local - 1), table)
    return reduce_forward(rows * inside[..., None], group)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       group, index: int) -> torch.Tensor:
    """``-log_softmax(logits)[target]`` per row over a vocabulary sharded
    over ``group`` (this rank holds columns shard ``index``): the shift
    is the max over the group (no gradient), the normalizer sums the
    shards' exp-sums and the gold logit comes from the shard that holds
    the target."""
    with torch.no_grad():
        m = logits.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    z = reduce_forward(torch.exp(logits - m[:, None]).sum(dim=-1), group)
    logz = torch.log(z) + m
    v_local = logits.shape[-1]
    local = targets - index * v_local
    inside = (local >= 0) & (local < v_local)
    gold_local = logits.gather(1, local.clamp(0, v_local - 1)[:, None])[:, 0]
    gold = reduce_forward(torch.where(inside, gold_local,
                                      torch.zeros_like(gold_local)), group)
    return logz - gold


# --- placement ---


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A shard rule on a mesh (the counterpart of ``NamedSharding``):
    ``shard`` takes this rank's slice of a global array."""
    mesh: Mesh
    spec: tuple

    def shard(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = self.mesh.shape[axis]
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of size {x.shape[dim]} "
                                 f"does not split over '{axis}' ({n})")
            size = x.shape[dim] // n
            x = x.narrow(dim, self.mesh.coord(axis) * size, size)
        return x


def param_sharding(mesh: Mesh, specs: Mapping[str, tuple] = PARAM_SPECS
                   ) -> dict[str, Sharding]:
    """A ``Sharding`` per parameter key."""
    return {k: Sharding(mesh, spec) for k, spec in specs.items()}


def batch_sharding(mesh: Mesh) -> Sharding:
    """Batch-dimension sharding along the ``data`` axis."""
    return Sharding(mesh, ("data",))


def shard_tree(tree, shardings: Mapping[str, Sharding], device
               ) -> dict[str, torch.Tensor]:
    """This rank's float32 slice of every leaf of a full tree (nested or
    flat, numpy or tensors), on ``device``."""
    flat = flat_tree(tree)
    return {k: sh.shard(np.asarray(flat[k], np.float32)).contiguous()
            .to(device) for k, sh in shardings.items()}


def shard_params(params, mesh: Mesh) -> LRCNParams:
    """This rank's slices of a full decoder tree (an ``LRCNParams`` or a
    numpy tree), as trainable parameters on its device."""
    return LRCNParams(shard_tree(params, param_sharding(mesh),
                                 mesh.local_device()))


def place_opt_state(leaves: Sequence[np.ndarray],
                    shardings: Mapping[str, Sharding],
                    keys: Sequence[str]) -> list[np.ndarray]:
    """Slice optax's global leaves [count, mu..., nu...] over ``keys`` to
    this rank's shards (the counterpart of placing an optimizer state on
    the mesh)."""
    n = len(keys)
    if len(leaves) != 1 + 2 * n:
        return list(leaves)   # the loader reports the mismatch
    out = [np.asarray(leaves[0])]
    for j in range(2):
        for i, key in enumerate(keys):
            out.append(shardings[key].shard(
                np.asarray(leaves[1 + j * n + i], np.float32)).numpy())
    return out


def data_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` rows."""
    d = mesh.shape["data"]
    if n % d:
        raise ValueError(f"batch of {n} rows does not split over the "
                         f"mesh's data axis ({d})")
    size = n // d
    return slice(mesh.coord("data") * size, (mesh.coord("data") + 1) * size)


def put_batch(mesh: Mesh, tokens, lengths, feats) -> tuple:
    """This rank's rows of one global (tokens, lengths, feats) batch, on
    its device."""
    rows = data_rows(mesh, len(tokens))
    device = mesh.local_device()
    return tuple(torch.from_numpy(np.ascontiguousarray(np.asarray(a)[rows]))
                 .to(device) for a in (tokens, lengths,
                                       np.asarray(feats, np.float32)))


def check_training_mesh(mesh: Mesh) -> None:
    """A training mesh has one rank per entry."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh.size != world:
        raise ValueError(
            f"training over a mesh of {mesh.size} entries needs {mesh.size} "
            f"processes, one per device (this run has {world}): start them "
            f"with --coordinator/--num-processes/--process-id or torchrun")


# --- the optimizer ---


def sum_grads(params: Sequence[torch.Tensor], group) -> None:
    """Sum the ``.grad`` of ``params`` over ``group`` in place, in one
    ``all_reduce`` (a missing gradient counts as zeros)."""
    if group is None:
        return
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


class ShardedOptimizer:
    """``optax.chain(clip_by_global_norm(gclip), adam(lr))`` over this
    rank's shards: ``zero_grad``, backward, then ``step``.

    ``step`` first sums each gradient over its ``reduce_axes`` (the data
    axis; the pipeline adds the model axis for the replicated weights that
    only one stage reads), then clips by the norm of the global arrays
    and steps Adam.  ``state_leaves`` gathers the moments to their global
    shapes (collective: every rank calls it); ``load_leaves`` takes global
    leaves and keeps this rank's slices."""

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: LRCNConfig,
                 mesh: Mesh, specs: Mapping[str, tuple],
                 keys: Sequence[str] = OPT_KEYS,
                 reduce_axes: Mapping[str, tuple] | None = None):
        self.mesh = mesh
        self.keys = tuple(keys)
        self.specs = dict(specs)
        self.params = [params[k] for k in self.keys]
        self.gclip = float(cfg.gclip or 0.0)
        self.adam = make_adam(self.params, cfg.lr)
        reduce_axes = reduce_axes or {}
        self.reduce_axes = {k: reduce_axes.get(k, ("data",))
                            for k in self.keys}
        self.sharded = [any(a == "model" for a in self.specs[k])
                        for k in self.keys]

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def reduce_grads(self) -> None:
        """Sum each gradient over its reduce axes (in place)."""
        if not self.mesh.distributed:
            return
        buckets: dict[tuple, list[torch.Tensor]] = {}
        for k, p in zip(self.keys, self.params):
            buckets.setdefault(self.reduce_axes[k], []).append(p)
        for axes, params in sorted(buckets.items()):
            for axis in axes:
                sum_grads(params, self.mesh.group(axis))

    def _clip(self) -> None:
        grads = [p.grad for p in self.params]
        sq = [torch.sum(g * g) for g in grads]
        replicated = sum(s for s, sh in zip(sq, self.sharded) if not sh)
        sharded = sum(s for s, sh in zip(sq, self.sharded) if sh)
        if isinstance(sharded, torch.Tensor):
            group = self.mesh.group("model")
            if group is not None:
                sharded = _all_reduce(sharded, group)
        norm = torch.sqrt(replicated + sharded)
        below = norm < self.gclip
        for g in grads:
            g.copy_(torch.where(below, g, g / norm * self.gclip))

    def apply(self) -> None:
        """Clip the summed gradients and step Adam."""
        if self.gclip > 0:
            self._clip()
        self.adam.step()

    def step(self) -> None:
        self.reduce_grads()
        self.apply()

    def tensors(self) -> list[torch.Tensor]:
        """This rank's parameter shards and Adam's state, as a captured
        step reads them."""
        return self.params + adam_state(self.adam)

    def state_leaves(self) -> list[np.ndarray]:
        """Adam's state as optax's leaves at global shapes: [count, mu...,
        nu...].  Collective."""
        leaves = adam_leaves(self.adam, self.params)
        n = len(self.keys)
        device = self.params[0].device
        out = [leaves[0]]
        for j in range(2):
            for i, key in enumerate(self.keys):
                local = torch.from_numpy(leaves[1 + j * n + i]).to(device)
                out.append(gather_to_host({key: local}, self.mesh,
                                          self.specs)[key])
        return out

    def load_leaves(self, leaves: Sequence[np.ndarray]) -> None:
        """Restore Adam's state from optax's global leaves (a checkpoint's
        ``opt_leaves``, written by either package)."""
        local = place_opt_state(leaves, param_sharding(self.mesh,
                                                       self.specs),
                                self.keys)
        load_adam_leaves(self.adam, self.params, self.keys, local,
                         "the decoder")
        graphs.forget(self)


# --- the step ---


def global_drop_masks(cfg: LRCNConfig, t_dim: int, b_local: int,
                      mesh: Mesh, generator: torch.Generator | None,
                      drop_masks, device) -> tuple | None:
    """This rank's rows of the step's dropout masks: the global masks
    (``drop_masks``, or drawn from ``generator`` at the global batch, as
    the one-device step draws them) sliced to the data shard."""
    if cfg.dropout <= 0:
        return None
    b_global = b_local * mesh.shape["data"]
    if drop_masks is None:
        if generator is None:
            raise ValueError("dropout requires a generator or drop_masks")
        drop_masks = lrcn.dropout_masks(
            (t_dim, b_global, cfg.embed), (t_dim, b_global,
                                           2 * cfg.factor_dim),
            cfg.dropout, generator)
    rows = data_rows(mesh, b_global)
    return tuple(torch.as_tensor(m)[:, rows].to(device) for m in drop_masks)


def sum_over_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x``'s sum over the data axis, with no gradient (the global token
    count, or the global NLL sum that is reported)."""
    group = mesh.group("data")
    x = x.detach()
    return x if group is None else _all_reduce(x, group)


def tp_loss_total_count(params: Mapping[str, torch.Tensor],
                        tokens: torch.Tensor, lengths: torch.Tensor,
                        feats: torch.Tensor, mesh: Mesh, *,
                        drop_masks: tuple | None = None,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's NLL sum (with gradient) over its rows, and the GLOBAL
    token count, with the embedding and the output projection sharded
    over ``model`` (``lrcn.loss_total_count`` where ``model`` is 1)."""
    tp = mesh.shape.get("model", 1)
    model_group, index = mesh.group("model"), mesh.coord("model")
    inputs, targets, mask = lrcn.build_teacher_forcing(tokens, lengths)
    b_dim, t_dim = inputs.shape
    if tp > 1:
        embeds = vocab_parallel_embedding(inputs.t(), params["embedding"],
                                          model_group, index)
    else:
        embeds = F.embedding(inputs.t(), params["embedding"])
    drop_mask2 = None
    if drop_masks is not None:
        embeds = embeds * drop_masks[0]
        drop_mask2 = drop_masks[1]
    cnn_proj = lrcn.cnn_projection(params, feats, compute_dtype)
    h2_seq = lrcn.unroll_h2(params, embeds, cnn_proj, drop_mask2,
                            compute_dtype)
    h2 = h2_seq.reshape(t_dim * b_dim, -1)
    tgt = targets.t().reshape(-1).long()
    if tp > 1:
        logits = lrcn.output_logits(params, reduce_backward(h2, model_group),
                                    compute_dtype)
        nll = vocab_parallel_nll(logits, tgt, model_group, index)
    else:
        nll = F.cross_entropy(lrcn.output_logits(params, h2, compute_dtype),
                              tgt, reduction="none")
    mask_flat = mask.t().reshape(-1).float()
    return (nll * mask_flat).sum(), sum_over_data(mask_flat.sum(), mesh)


class MeshStep:
    """What the sharded and the pipelined steps share: the batch and the
    dropout masks of this rank, the optimizer, the step and the eval
    step.  A subclass gives ``specs``, ``opt_keys``, ``reduce_axes``,
    ``loss_total_count``, ``shard_params`` and ``unshard_params``.

    ``step`` and ``eval_batch`` run their eager bodies (``step_fn``,
    ``eval_fn``) as graphs where ``graphs.capturable`` holds for the
    mesh's groups and ``capturable`` for the step.  Every rank captures
    and replays at the same calls: each takes its rows of the same global
    batches, so the ranks' signatures change at the same calls."""

    specs: dict[str, tuple]
    opt_keys: tuple[str, ...]
    reduce_axes: dict[str, tuple] = {}
    capturable = True

    def __init__(self, cfg: LRCNConfig, mesh: Mesh):
        check_training_mesh(mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.local_device()
        self.compute_dtype = compute_dtype_of(cfg)

    def init_opt(self, params) -> ShardedOptimizer:
        return ShardedOptimizer(params, self.cfg, self.mesh, self.specs,
                                self.opt_keys, self.reduce_axes)

    def shard_batch(self, tokens, lengths, feats) -> tuple:
        return put_batch(self.mesh, tokens, lengths, feats)

    def _value_and_grad(self, params, opt: ShardedOptimizer, tokens,
                        lengths, feats, generator, drop_masks=None
                        ) -> torch.Tensor:
        opt.zero_grad()
        masks = None
        if self.cfg.dropout > 0:
            masks = global_drop_masks(self.cfg, tokens.shape[1] + 1,
                                      tokens.shape[0], self.mesh, generator,
                                      drop_masks, self.device)
        total, count = self.loss_total_count(params, tokens, lengths, feats,
                                             drop_masks=masks)
        (total / count).backward()
        opt.reduce_grads()
        return sum_over_data(total, self.mesh) / count

    def value_and_grad(self, params, opt: ShardedOptimizer, tokens, lengths,
                       feats, key: int = 0, drop_masks=None) -> torch.Tensor:
        """The global mean loss, with the gradient of the global loss in
        every parameter's ``.grad`` (summed over the mesh; no update);
        eager.  Dropout: the global ``drop_masks``, or drawn from the step
        generator of ``key``."""
        generator = (step_generator(key, self.device)
                     if self.cfg.dropout > 0 and drop_masks is None
                     else None)
        return self._value_and_grad(params, opt, tokens, lengths, feats,
                                    generator, drop_masks)

    def step_fn(self, params, opt: ShardedOptimizer, generator, tokens,
                lengths, feats, drop_masks=None) -> torch.Tensor:
        """The eager body of one step, dropout drawn from ``generator`` (or
        the global ``drop_masks``): updates in place and returns the
        global mean loss; leaves no gradient behind."""
        loss = self._value_and_grad(params, opt, tokens, lengths, feats,
                                    generator, drop_masks)
        opt.apply()
        opt.zero_grad()
        return loss.detach()

    def _step_body(self, params, opt, generators, tokens, lengths, feats,
                   *drop_masks) -> torch.Tensor:
        return self.step_fn(params, opt,
                            generators[0] if generators else None, tokens,
                            lengths, feats, drop_masks or None)

    def step(self, params, opt: ShardedOptimizer, tokens, lengths, feats,
             key: int = 0, drop_masks=None) -> torch.Tensor:
        """One optimizer step in place; returns the global mean loss on
        the device.  On NCCL groups one graph replay (eager at a
        signature's first call)."""
        masks = () if drop_masks is None else tuple(
            torch.as_tensor(m).to(self.device) for m in drop_masks)
        seeds = ([step_seed(key)] if self.cfg.dropout > 0 and not masks
                 else [])
        return graphs.step(
            opt, ("mesh_step", self.cfg.dropout, self.compute_dtype),
            functools.partial(self._step_body, params, opt),
            (tokens, lengths, feats, *masks), reads=opt.tensors(),
            seeds=seeds, graph=self.capturable, groups=self.mesh.groups())

    def __call__(self, params, opt, tokens, lengths, feats, key: int = 0,
                 drop_masks=None):
        loss = self.step(params, opt, tokens, lengths, feats, key,
                         drop_masks)
        return params, opt, loss

    def eval_fn(self, params, tokens, lengths, feats
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The eager body of ``eval_batch``."""
        total, count = self.loss_total_count(params, tokens, lengths, feats)
        return sum_over_data(total, self.mesh), count

    @torch.no_grad()
    def eval_batch(self, params, tokens, lengths, feats
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(global NLL sum, global token count), no dropout; on NCCL
        groups one graph replay."""
        return graphs.run(
            params, ("mesh_eval", self.compute_dtype),
            functools.partial(self.eval_fn, params), (tokens, lengths, feats),
            graph=self.capturable, groups=self.mesh.groups())


class ShardedTrainStep(MeshStep):
    """A train step and an eval step for the decoder over a mesh, one rank
    per entry.

    Usage (on every rank)::

        mesh = make_mesh((dp, tp))
        step = ShardedTrainStep(cfg, mesh)
        params = step.shard_params(tree)        # the full tree
        opt = step.init_opt(params)
        params, opt, loss = step(params, opt,
                                 *step.shard_batch(tok, lens, feats), key)

    ``shard_batch`` takes the GLOBAL batch and keeps this rank's rows.
    The global batch must split over the ``data`` axis, and the
    vocabulary over the ``model`` axis.  ``key`` seeds the step's dropout
    generator, as in ``Trainer``.
    """

    specs = PARAM_SPECS
    opt_keys = OPT_KEYS

    def __init__(self, cfg: LRCNConfig, mesh: Mesh):
        tp = mesh.shape.get("model", 1)
        if cfg.vocab_size % tp:
            raise ValueError(
                f"vocab_size={cfg.vocab_size} must be divisible by the "
                f"'model' mesh axis ({tp}): the embedding table and output "
                f"projection shard their vocabulary dimension across it")
        super().__init__(cfg, mesh)

    def loss_total_count(self, params, tokens, lengths, feats, *,
                         drop_masks=None):
        return tp_loss_total_count(params, tokens, lengths, feats,
                                   self.mesh, drop_masks=drop_masks,
                                   compute_dtype=self.compute_dtype)

    def shard_params(self, params) -> LRCNParams:
        return shard_params(params, self.mesh)

    def unshard_params(self, params) -> dict[str, np.ndarray]:
        """The full tree on the host, flat checkpoint keys.  Collective."""
        return gather_to_host({k: params[k] for k in PARAM_KEYS},
                              self.mesh, self.specs)


__all__ = [
    "PARAM_SPECS", "Sharding", "param_sharding", "batch_sharding",
    "shard_params", "place_opt_state", "put_batch", "data_rows",
    "sum_grads", "sum_over_data", "ShardedOptimizer", "MeshStep",
    "ShardedTrainStep", "tp_loss_total_count",
    "reduce_forward", "reduce_backward", "reduce_both",
    "vocab_parallel_embedding", "vocab_parallel_nll",
]
