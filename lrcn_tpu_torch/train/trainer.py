"""Decoder training on one device (counterpart of
``lrcn_tpu/train/trainer.py``, single device).

Replaces the reference's host-driven training (``train!``/``train1``,
lrcn.jl:223-405) with the JAX package's semantics: the same batches in the
same order from the same numpy generator, the same masked loss, and
optax's update rules, so that either package resumes the other's
checkpoints:

- ``Optimizer`` is ``optax.chain(clip_by_global_norm(gclip), adam(lr))``:
  the gradients are multiplied by ``gclip / norm`` only when the global
  norm reaches ``gclip`` (optax's rule; ``torch.nn.utils.clip_grad_norm_``
  divides by ``norm + 1e-6``, a different update), then Adam with optax's
  defaults (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), which is
  ``torch.optim.Adam``'s formula (fused on CUDA);
- a step is one forward and backward of ``models.lrcn.loss_fn``, plain
  PyTorch with autograd: the training path runs no hand-written kernel,
  as the JAX package's reaches no Pallas kernel;
- the feature table stays on the device (cached by weak reference) and
  every step gathers its rows there by index (a COCO-size store, ~123k
  fc7 rows, is 2 GB); with ``steps_per_dispatch = K > 1`` batches run in
  ``chunk_same_shape`` order, then the per-shape tail, as in JAX, the K
  steps are enqueued with no host synchronisation, and the losses are
  read at most once a dispatch, at a log point.  K sets the batch order,
  which JAX parity needs, and how often the host waits;
- on a card each dispatch of K steps (and each single step, and each
  K-batch evaluation) is one CUDA graph replay, as JAX jits its
  ``_multi_step`` and ``_multi_eval`` (``utils/graphs.py``): a shape's
  first dispatch runs eagerly, its second captures, every later one
  replays; the graph gathers the features from the table, and the fused
  Adam is capturable.  A new optimizer, restored leaves or new
  parameters capture anew;
- per-step dropout draws from a ``torch.Generator`` seeded from (epoch key,
  step index) through ``fold_in``, so a resumed run replays the same
  stream; the epoch key is a 64-bit integer (this package's own stream:
  it does not reproduce ``jax.random``'s bits);
- per-epoch and every-``ckpt_every``-dispatch checkpoints, ``bestfile``,
  train/val average loss and words/s, logged as JSONL.

With a ``mesh`` (``parallel/mesh.py``, one rank per entry) the steps run
through ``parallel.ShardedTrainStep`` (data x vocabulary parallel), or
``parallel.PipelinedTrainStep`` with ``pipeline=True``, which runs one
step a dispatch as in JAX.  Every rank holds the feature table and takes
its rows of every stacked batch; the shuffle seed is ``shared_seed``'s;
checkpoints gather the parameters and the optimizer's moments to their
global shapes on every rank, and rank 0 alone writes them.  On NCCL
groups each dispatch of K sharded steps and each K-batch evaluation is
one graph replay with its ``all_reduce``s, as JAX jits its mesh
``_multi_step``; under gloo, and for the pipeline, the same bodies run
eagerly (``graphs.capturable``, ``PipelinedTrainStep.capturable``).
"""

from __future__ import annotations

import copy
import functools
import time
import warnings
import weakref
from typing import Sequence

import numpy as np
import torch

from lrcn_tpu_torch import as_device
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.data.batcher import Batch, chunk_same_shape, iterate_epoch
from lrcn_tpu_torch.data.feature_store import FeatureStore, device_table
from lrcn_tpu_torch.models import lrcn
from lrcn_tpu_torch.models.lrcn import LRCNParams
from lrcn_tpu_torch.train.checkpoint import (OPT_KEYS, compute_dtype_of,
                                             make_position, resume_start,
                                             save_checkpoint)
from lrcn_tpu_torch.train.metrics import MetricsLogger
from lrcn_tpu_torch.utils import graphs
from lrcn_tpu_torch.utils.profiling import span

_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new 64-bit key from ``key`` and ``data`` (splitmix64 of their
    mix): the counterpart of ``jax.random.fold_in`` for this package's
    integer keys."""
    z = (key ^ ((data + 1) * 0x9E3779B97F4A7C15)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_seed(key: int) -> int:
    """The seed of the dropout generator of the step with key ``key``."""
    return key & (_MASK64 >> 1)


def step_generator(key: int, device: torch.device) -> torch.Generator:
    """The dropout generator of the step with key ``key``, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(key))
    return gen


def make_adam(params: list[torch.Tensor], lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s defaults (b1 0.9, b2 0.999, eps 1e-8), with
    its state made now, as ``optax.adam(lr).init`` makes it (zero
    moments, count 0), so that a captured step finds it at fixed
    addresses.  Where a step may be captured (``graphs.enabled``: on a
    card) it is the fused kernel, capturable on a card, in the eager and
    the captured calls alike, so that both run one kernel."""
    fused = graphs.enabled(params[0])
    capturable = params[0].is_cuda
    adam = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            fused=fused or None, capturable=capturable)
    for p in params:        # what Adam's first step would make
        adam.state[p] = {
            "step": torch.zeros((), dtype=torch.float32,
                                device=p.device if fused or capturable
                                else "cpu"),
            "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
    return adam


def adam_state(adam: torch.optim.Adam) -> list[torch.Tensor]:
    """Adam's moments and counts, which its step writes in place (part of a
    captured step's signature)."""
    return [t for state in adam.state.values()
            for t in (state["exp_avg"], state["exp_avg_sq"], state["step"])]


def clip_by_global_norm_(grads: list[torch.Tensor], gclip: float) -> None:
    """``optax.clip_by_global_norm(gclip)`` in place: the global norm,
    then optax's select (``norm < gclip`` keeps the gradients, else
    ``g / norm * gclip``)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    below = norm < gclip
    for g in grads:
        g.copy_(torch.where(below, g, g / norm * gclip))


def adam_leaves(adam: torch.optim.Adam, params: list[torch.Tensor]
                ) -> list[np.ndarray]:
    """Adam's state over ``params`` as optax's leaves: [count, mu...,
    nu...] (zeros before the first step)."""
    count, mu, nu = 0, [], []
    for p in params:
        state = adam.state.get(p)
        if state:
            count = int(state["step"])
            mu.append(state["exp_avg"].detach().cpu().numpy())
            nu.append(state["exp_avg_sq"].detach().cpu().numpy())
        else:
            zeros = np.zeros(tuple(p.shape), np.float32)
            mu.append(zeros)
            nu.append(zeros)
    return [np.asarray(count, np.int32)] + mu + nu


def load_adam_leaves(adam: torch.optim.Adam, params: list[torch.Tensor],
                     keys: Sequence[str], leaves: Sequence[np.ndarray],
                     what: str) -> None:
    """Restore Adam's state over ``params`` (named ``keys``) from optax's
    leaves [count, mu..., nu...] of ``optax.adam`` over ``what``."""
    n = len(params)
    if len(leaves) != 1 + 2 * n:
        raise ValueError(f"{len(leaves)} optimizer leaves; optax's Adam "
                         f"over {what} has {1 + 2 * n}")
    count = float(np.asarray(leaves[0]))
    state = {}
    for i, p in enumerate(params):
        mu, nu = (np.asarray(leaves[1 + j * n + i], np.float32)
                  for j in (0, 1))
        if mu.shape != tuple(p.shape) or nu.shape != tuple(p.shape):
            raise ValueError(f"optimizer leaf for {keys[i]} has shape "
                             f"{mu.shape}, the parameter {tuple(p.shape)}")
        state[i] = {"step": torch.tensor(count),
                    "exp_avg": torch.from_numpy(mu),
                    "exp_avg_sq": torch.from_numpy(nu)}
    sd = adam.state_dict()
    sd["state"] = state
    adam.load_state_dict(sd)


class Optimizer:
    """``optax.chain(clip_by_global_norm(gclip), adam(lr))`` over an
    ``LRCNParams``: ``zero_grad``, backward, then ``step``.

    ``state_leaves``/``load_leaves`` convert Adam's state from and to
    optax's 19 leaves (count, then the moments in sorted key order), the
    checkpoint format of both packages.
    """

    def __init__(self, params: LRCNParams, cfg: LRCNConfig):
        self.params = [params[k] for k in OPT_KEYS]
        self.gclip = float(cfg.gclip or 0.0)
        self.adam = make_adam(self.params, cfg.lr)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.gclip > 0:
            clip_by_global_norm_([p.grad for p in self.params], self.gclip)
        self.adam.step()

    def tensors(self) -> list[torch.Tensor]:
        """The parameters and Adam's state, as a captured step reads
        them."""
        return self.params + adam_state(self.adam)

    def state_leaves(self) -> list[np.ndarray]:
        """Adam's state as optax's leaves: [count, mu..., nu...]."""
        return adam_leaves(self.adam, self.params)

    def load_leaves(self, leaves: Sequence[np.ndarray]) -> None:
        """Restore Adam's state from optax's leaves (a checkpoint's
        ``opt_leaves``, written by either package)."""
        load_adam_leaves(self.adam, self.params, OPT_KEYS, leaves,
                         "the decoder")
        graphs.forget(self)


class Trainer:
    """Trains the decoder on fc7 features on one device (``"cuda"`` unless
    the caller passes another).  ``init``/``restore`` give the parameters
    and optimizer that ``train_epoch`` and ``fit`` update in place and
    return."""

    def __init__(self, cfg: LRCNConfig, vocab: Vocab,
                 metrics: MetricsLogger | None = None, device="cuda",
                 steps_per_dispatch: int = 1, mesh=None,
                 pipeline: bool = False):
        self.cfg = cfg
        self.vocab = vocab
        self.metrics = metrics or MetricsLogger()
        self.compute_dtype = compute_dtype_of(cfg)
        self.mesh = mesh
        self.pipeline = pipeline and mesh is not None
        self._sharded = None
        if self.pipeline:
            from lrcn_tpu_torch.parallel.pipeline import PipelinedTrainStep
            if steps_per_dispatch > 1:
                warnings.warn(
                    "steps_per_dispatch > 1 is not supported with pipeline "
                    "parallelism; running 1 step per dispatch",
                    stacklevel=2)
                steps_per_dispatch = 1
            self._sharded = PipelinedTrainStep(cfg, mesh)
        elif mesh is not None:
            from lrcn_tpu_torch.parallel.train import ShardedTrainStep
            self._sharded = ShardedTrainStep(cfg, mesh)
        self.device = (as_device(device) if self._sharded is None
                       else self._sharded.device)
        # graphs.step/run's say over a mesh: the groups of its collectives,
        # and whether its step may be captured at all
        self._graphs = ({} if self._sharded is None else
                        {"groups": mesh.groups(),
                         "graph": self._sharded.capturable})
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        self._table_cache = None   # (weakref to store, device table)

    # --- parameters and optimizer ---

    def init(self, generator: torch.Generator | int
             ) -> tuple[LRCNParams, Optimizer]:
        """Fresh parameters (``lrcn.init_params``, drawn on the CPU from
        ``generator`` or a seed) on the device, and a fresh optimizer."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        params = lrcn.init_params(self.cfg, generator)
        if self._sharded is not None:
            params = self._sharded.shard_params(params)
            return params, self._sharded.init_opt(params)
        params = params.to(self.device)
        return params, Optimizer(params, self.cfg)

    def restore(self, tree, opt_leaves=None
                ) -> tuple[LRCNParams, Optimizer]:
        """Parameters from a numpy tree (a checkpoint's ``params``) and an
        optimizer with the checkpoint's ``opt_leaves``, if any (global
        leaves; under a mesh each rank keeps its slices)."""
        if self._sharded is not None:
            params = self._sharded.shard_params(tree)
            opt = self._sharded.init_opt(params)
        else:
            params = LRCNParams.from_numpy(tree, self.device)
            opt = Optimizer(params, self.cfg)
        if opt_leaves is not None:
            opt.load_leaves(opt_leaves)
        return params, opt

    # --- one step ---

    def _step_fn(self, params: LRCNParams, opt: Optimizer, tokens, lengths,
                 feats, generator) -> torch.Tensor:
        """One optimizer step, dropout drawn from ``generator``; returns the
        batch's loss on the device and leaves no gradient behind.  Under a
        mesh, the mesh step's body (the global loss)."""
        if self._sharded is not None:
            return self._sharded.step_fn(params, opt, generator, tokens,
                                         lengths, feats)
        opt.zero_grad()
        loss = lrcn.loss_fn(params, tokens, lengths, feats,
                            pdrop=self.cfg.dropout, generator=generator,
                            compute_dtype=self.compute_dtype)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.detach()

    def _dispatch_fn(self, params, opt, table, generators, tokens_k,
                     lengths_k, rows_k) -> torch.Tensor:
        """The eager body of :meth:`_dispatch`: K steps, step i's dropout
        from ``generators[i]`` (none without dropout)."""
        return torch.stack([
            self._step_fn(params, opt, tokens_k[i], lengths_k[i],
                          table[rows_k[i]],
                          generators[i] if generators else None)
            for i in range(tokens_k.shape[0])])

    def _dispatch(self, params, opt, tokens_k, lengths_k, rows_k, table,
                  base_key: int, offset: int) -> torch.Tensor:
        """K steps over stacked same-shape batches, features gathered from
        the device-resident ``table`` by row; the step keys derive from
        (base_key, offset + i).  On a card one graph replay (eager at a
        shape's first dispatch; under a mesh, on NCCL groups).  Returns
        the K losses, not read."""
        keys = [fold_in(base_key, offset + i)
                for i in range(tokens_k.shape[0])]
        return graphs.step(
            opt, ("dispatch", self.cfg.dropout, self.compute_dtype),
            functools.partial(self._dispatch_fn, params, opt, table),
            (tokens_k, lengths_k, rows_k), reads=(*opt.tensors(), table),
            seeds=([step_seed(k) for k in keys] if self.cfg.dropout > 0
                   else ()), **self._graphs)

    # --- host loop ---

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _put(self, *arrays: np.ndarray) -> tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True) for a in arrays)

    def _stacked(self, chunk: Sequence[Batch], store: FeatureStore):
        """A chunk's host lengths (the global batches'), and its stacked
        tokens, lengths and table rows on the device (under a mesh, this
        rank's rows of each batch)."""
        tokens_k = np.stack([b.tokens for b in chunk])
        lengths_k = np.stack([b.lengths for b in chunk])
        rows_k = np.stack([store.rows(b.image_ids) for b in chunk]
                          ).astype(np.int64)
        if self.mesh is None:
            return lengths_k, self._put(tokens_k, lengths_k, rows_k)
        from lrcn_tpu_torch.parallel.train import data_rows
        mine = data_rows(self.mesh, tokens_k.shape[1])
        return lengths_k, self._put(tokens_k[:, mine], lengths_k[:, mine],
                                    rows_k[:, mine])

    def _save(self, path: str, params, opt, **kwargs) -> None:
        """``save_checkpoint`` of the full parameters and optimizer state.
        Under a mesh every rank gathers them (collective) and rank 0
        alone writes; every rank returns after the write."""
        if self._sharded is None:
            save_checkpoint(path, params, self.vocab, self.cfg,
                            opt_state=opt, **kwargs)
            return
        from lrcn_tpu_torch.parallel.distributed import barrier, is_primary
        tree = self._sharded.unshard_params(params)
        leaves = opt.state_leaves()
        if is_primary():
            save_checkpoint(path, tree, self.vocab, self.cfg,
                            opt_state=leaves, **kwargs)
        barrier("lrcn_ckpt_save")

    def _device_table(self, store: FeatureStore) -> torch.Tensor:
        """The store's feature table on the device, cached by a weak
        reference (an ``id(store)`` key could keep a dead store's table or
        serve a stale one when CPython reuses the address)."""
        cached = self._table_cache
        if cached is None or cached[0]() is not store:
            table = device_table(store, self.device, torch.float32)
            self._table_cache = (weakref.ref(store), table)
        return self._table_cache[1]

    def train_epoch(self, params: LRCNParams, opt: Optimizer,
                    batches: Sequence[Batch], store: FeatureStore,
                    rng_key: int, shuffle_rng: np.random.Generator,
                    log_every: int = 200, start_dispatch: int = 0,
                    ckpt_every: int | None = None, on_checkpoint=None
                    ) -> tuple[LRCNParams, Optimizer, int]:
        """One epoch over shuffled batches (reference: train1,
        lrcn.jl:330-397); returns the next epoch's key with the updated
        parameters and optimizer.

        ``start_dispatch`` resumes mid-epoch: the batch order derives from
        ``shuffle_rng``'s epoch-start state and every step key from (epoch
        key, index), so the first N dispatches are skipped and the rest
        replays the uninterrupted run.  ``on_checkpoint(dispatch, params,
        opt)`` fires every ``ckpt_every`` dispatches.

        Spans (``utils/profiling.py:span``): ``lrcn.train.epoch`` around
        the call; inside it ``lrcn.train.batch`` (a dispatch's
        ``_stacked``), ``lrcn.train.log`` (``metrics.log`` with its loss
        readback) and ``lrcn.train.sync`` (the closing synchronize).
        """
        with span("lrcn.train.epoch"):
            t0 = time.time()
            tokens_seen = 0
            single_batches, single_rng, n_chunks = batches, shuffle_rng, 0

            def words_per_sec():
                return round(tokens_seen / (time.time() - t0), 1)

            def maybe_ckpt(dispatch):
                if ckpt_every and on_checkpoint and dispatch % ckpt_every == 0:
                    on_checkpoint(dispatch, params, opt)

            k = self.steps_per_dispatch
            table = self._device_table(store)
            if k > 1:
                chunks, tail = chunk_same_shape(batches, k, shuffle_rng)
                n_chunks = len(chunks)
                offset = 0
                for ci, chunk in enumerate(chunks):
                    if ci < start_dispatch:     # resumed: already trained
                        offset += len(chunk)
                        continue
                    with span("lrcn.train.batch"):
                        lengths_k, dev = self._stacked(chunk, store)
                    losses = self._dispatch(params, opt, *dev, table,
                                            rng_key, offset)
                    offset += len(chunk)
                    tokens_seen += int(np.sum(np.maximum(lengths_k, 0)))
                    batch = ci * len(chunk)
                    if log_every and batch % log_every < len(chunk):
                        with span("lrcn.train.log"):
                            self.metrics.log(event="train", batch=batch,
                                             loss=round(float(losses[-1]), 4),
                                             words_per_sec=words_per_sec())
                    maybe_ckpt(ci + 1)
                rng_key = fold_in(rng_key, offset + 1)
                single_batches, single_rng = tail, None   # already shuffled
            # single steps: materialize the (possibly shuffled) order so
            # that a resume can slice past completed batches
            order = list(iterate_epoch(single_batches, single_rng))
            skip = max(0, start_dispatch - n_chunks)
            base = rng_key
            for j in range(skip, len(order)):
                with span("lrcn.train.batch"):
                    _, dev = self._stacked([order[j]], store)
                loss = self._dispatch(params, opt, *dev, table, base, j)[0]
                tokens_seen += int(np.sum(np.maximum(order[j].lengths, 0)))
                if log_every and j % log_every == 0:
                    with span("lrcn.train.log"):
                        self.metrics.log(event="train", batch=j,
                                         loss=round(float(loss), 4),
                                         words_per_sec=words_per_sec())
                maybe_ckpt(n_chunks + j + 1)
            rng_key = fold_in(base, len(order) + 1)
            with span("lrcn.train.sync"):
                self._sync()
            with span("lrcn.train.log"):
                self.metrics.log(event="epoch_train_done",
                                 batches=len(batches),
                                 words_per_sec=words_per_sec())
            return params, opt, rng_key

    def _eval_fn(self, params, table, tokens_k, lengths_k, rows_k
                 ) -> torch.Tensor:
        """(NLL sum, token count) over K stacked batches, one batch after
        another (under a mesh, of the global batches)."""
        part = torch.zeros(2, device=tokens_k.device)
        for i in range(tokens_k.shape[0]):
            feats = table[rows_k[i]]
            part = part + torch.stack(
                lrcn.loss_total_count(params, tokens_k[i], lengths_k[i],
                                      feats, compute_dtype=self.compute_dtype)
                if self._sharded is None else
                self._sharded.eval_fn(params, tokens_k[i], lengths_k[i],
                                      feats))
        return part

    def _eval(self, params, tokens_k, lengths_k, rows_k, table
              ) -> torch.Tensor:
        """(NLL sum, token count) of K stacked batches, over the mesh's
        global batches under a mesh; on a card one graph replay (under a
        mesh, on NCCL groups)."""
        return graphs.run(
            params, ("eval", self.compute_dtype),
            functools.partial(self._eval_fn, params, table),
            (tokens_k, lengths_k, rows_k), reads=(table,), **self._graphs)

    @torch.no_grad()
    def average_loss(self, params: LRCNParams, batches: Sequence[Batch],
                     store: FeatureStore) -> float:
        """Dataset-level mean NLL (reference: average_loss,
        lrcn.jl:407-486).  With ``steps_per_dispatch > 1`` same-shape
        batches evaluate K at a time, the per-shape remainders one at a
        time, all from the device-resident table; every partial sum is
        fetched after all are queued."""
        table = self._device_table(store)
        chunks = [[b] for b in batches]
        if self.steps_per_dispatch > 1:
            chunks, single = chunk_same_shape(batches,
                                              self.steps_per_dispatch, None)
            chunks += [[b] for b in single]
        partials = []
        for chunk in chunks:
            _, dev = self._stacked(chunk, store)
            partials.append(self._eval(params, *dev, table))
        total, count = 0.0, 0.0
        for t, c in (p.tolist() for p in partials):
            total += t
            count += c
        return total / max(count, 1.0)

    def fit(self, params: LRCNParams, opt: Optimizer,
            train_batches: Sequence[Batch],
            val_batches: Sequence[Batch] | None, train_store: FeatureStore,
            val_store: FeatureStore | None, rng_key: int, *,
            epochs: int | None = None, savefile: str | None = None,
            bestfile: str | None = None, eval_train_loss: bool = True,
            ckpt_every: int | None = None,
            resume_position: dict | None = None,
            completed_epochs: int = 0) -> tuple[LRCNParams, Optimizer]:
        """Full training loop (reference: train!, lrcn.jl:223-246), with
        the JAX package's semantics.

        ``bestfile``: also checkpoint whenever the epoch's validation loss
        improves.  ``ckpt_every``: also checkpoint every N dispatches
        within an epoch, with a resume position; passing it back as
        ``resume_position`` replays the interrupted epoch from that
        dispatch, bit-exact with the uninterrupted run.  On any resume
        ``epochs`` is the total budget: a mid-epoch position carries its
        epoch, an epoch-complete checkpoint passes its ``epoch`` as
        ``completed_epochs``.
        """
        from lrcn_tpu_torch.parallel.distributed import shared_seed

        epochs = epochs if epochs is not None else self.cfg.epochs
        # multi-process: unseeded runs take rank 0's entropy, so that every
        # rank shuffles alike
        shuffle_rng = np.random.default_rng(
            shared_seed(self.cfg.seed if self.cfg.seed > 0 else None))
        best_val = float("inf")
        geometry = {"steps_per_dispatch": self.steps_per_dispatch,
                    "n_batches": len(train_batches)}
        start_epoch, start_dispatch, rng_key = resume_start(
            resume_position, shuffle_rng, rng_key, geometry)
        if not resume_position and completed_epochs:
            start_epoch = completed_epochs + 1
        resumed = bool(resume_position) or completed_epochs > 0
        end_epoch = epochs if resumed else start_epoch + epochs - 1
        if start_epoch > end_epoch:
            print(f"train: checkpoint already covers {completed_epochs} "
                  f"of the {epochs}-epoch budget — nothing to do "
                  f"(raise --epochs to continue training)")
            return params, opt
        for epoch in range(start_epoch, end_epoch + 1):
            epoch_state = copy.deepcopy(shuffle_rng.bit_generator.state)
            epoch_key = rng_key

            def on_ckpt(dispatch, p, o, _epoch=epoch, _state=epoch_state,
                        _key=epoch_key):
                self._save(
                    savefile, p, o, epoch=_epoch - 1,
                    position=make_position(_epoch, dispatch, _state, _key,
                                           geometry))
                self.metrics.log(event="ckpt", epoch=_epoch,
                                 dispatch=dispatch)

            params, opt, rng_key = self.train_epoch(
                params, opt, train_batches, train_store, rng_key,
                shuffle_rng,
                start_dispatch=start_dispatch if epoch == start_epoch else 0,
                ckpt_every=ckpt_every if savefile else None,
                on_checkpoint=on_ckpt if savefile else None)
            if savefile:
                self._save(savefile, params, opt, epoch=epoch)
            record = {"event": "epoch", "epoch": epoch}
            if eval_train_loss:
                record["train_loss"] = round(
                    self.average_loss(params, train_batches, train_store), 4)
            if val_batches is not None and val_store is not None:
                val_loss = self.average_loss(params, val_batches, val_store)
                record["val_loss"] = round(val_loss, 4)
                if bestfile and val_loss < best_val:
                    best_val = val_loss
                    self._save(bestfile, params, opt, epoch=epoch)
                    record["best"] = True
            self.metrics.log(**record)
        return params, opt

