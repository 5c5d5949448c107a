"""Joint CNN+LSTM fine-tuning: end-to-end gradients through VGG-16
(counterpart of ``lrcn_tpu/models/joint.py``).

The paper's strongest configuration (LRCN-2f, 1411.4389.pdf Table 6)
fine-tunes the vision encoder with the decoder.  One step:

- uint8 (or 255-scale float) images, minus the mean image on the device;
- VGG-16 to fc7 (``vgg16_fc7_train``: ``F.conv2d``, no hand-written
  kernel, as JAX's joint loss runs XLA's conv), rematerialised with
  ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint``: the
  13 convs' activations at 224x224 otherwise dominate memory);
- L1-normalize (the plain sum, lrcn.jl:597), then the decoder's
  teacher-forced loss (``models/lrcn.py:loss_fn``);
- one backward over BOTH parameter sets and the joint optimizer.

The optimizer has optax's semantics (``make_joint_optimizer``):
``chain([clip_by_global_norm(gclip),] multi_transform({"cnn":
adam(cnn_lr) or set_to_zero(), "decoder": adam(lr)}))``.  The clip comes
first and spans both sets, so with ``gclip > 0`` a frozen CNN's gradient
still enters the global norm: the step computes it whenever the clip is
on.  Its state reads and writes optax's leaves, so a joint checkpoint
resumes in either package.

``JointTrainStep`` runs on one device (``"cuda"`` unless the caller asks
for another); ``multi_step`` runs K steps with the step keys
``fold_in(base_key, offset + i)``, with no host synchronisation.  On a
card each step, each ``multi_step`` and each ``eval_batch`` is one CUDA
graph replay, as JAX jits them (``utils/graphs.py``): a shape's first
call runs eagerly, its second captures, every later one replays.
With a ``mesh`` (one rank per entry) it is data parallel, as in JAX: both
parameter sets are replicated, each rank takes its rows of the global
batch, the loss differentiated is the global mean (the local NLL sum over
the global token count) and the gradients are summed over ``data`` before
the clip; the dropout masks are the global batch's, sliced.  Its steps
and ``eval_batch`` are graphs there too where the mesh's groups are NCCL
(``graphs.capturable``), with their ``all_reduce``s; under gloo they run
eagerly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from lrcn_tpu_torch import as_device
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.models import lrcn
from lrcn_tpu_torch.models.lrcn import LRCNParams
from lrcn_tpu_torch.models.vgg import (PARAM_KEYS as VGG_KEYS, VGGParams,
                                       init_vgg_params, l1_normalize,
                                       vgg16_fc7_train)
from lrcn_tpu_torch.train.checkpoint import OPT_KEYS, compute_dtype_of
from lrcn_tpu_torch.train.trainer import (adam_leaves, adam_state,
                                          clip_by_global_norm_, fold_in,
                                          load_adam_leaves, make_adam,
                                          step_generator, step_seed)
from lrcn_tpu_torch.utils import graphs

# optax's flattening order of the VGG parameter dict: sorted keys
CNN_OPT_KEYS = tuple(sorted(VGG_KEYS))


class JointParams(NamedTuple):
    cnn: VGGParams        # VGG-16 (models/vgg.py)
    decoder: LRCNParams   # the LRCN decoder (models/lrcn.py)


def joint_loss_total_count(params: JointParams, images: torch.Tensor,
                           tokens: torch.Tensor, lengths: torch.Tensor, *,
                           pdrop: float = 0.0,
                           generator: torch.Generator | None = None,
                           drop_masks: tuple[torch.Tensor, torch.Tensor]
                           | None = None,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           remat_cnn: bool = True
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed NLL and token count of captions given preprocessed images
    (B, 224, 224, 3).

    Dropout as :func:`lrcn.loss_total_count` (``drop_masks`` injected, or
    drawn from ``generator``).  With ``remat_cnn`` the VGG forward keeps
    only its input for the backward and runs again there."""
    def fwd(x):
        return vgg16_fc7_train(params.cnn, x, compute_dtype)

    if remat_cnn and torch.is_grad_enabled():
        # the forward draws no random numbers, so there is no RNG state to
        # restore for its recompute (and none may be read under capture)
        feats = checkpoint(fwd, images, use_reentrant=False,
                           preserve_rng_state=False)
    else:
        feats = fwd(images)
    feats = l1_normalize(feats)       # live-path normalization, lrcn.jl:597
    return lrcn.loss_total_count(params.decoder, tokens, lengths, feats,
                                 pdrop=pdrop, generator=generator,
                                 drop_masks=drop_masks,
                                 compute_dtype=compute_dtype)


def joint_loss(params: JointParams, images: torch.Tensor,
               tokens: torch.Tensor, lengths: torch.Tensor,
               **kwargs) -> torch.Tensor:
    """Mean NLL of captions given preprocessed images; keyword arguments
    as :func:`joint_loss_total_count`."""
    total, count = joint_loss_total_count(params, images, tokens, lengths,
                                          **kwargs)
    return total / count


@dataclasses.dataclass(frozen=True)
class JointOptimizer:
    """The joint optimizer's rule (what ``make_joint_optimizer`` returns);
    ``init(params)`` gives the state that steps ``params`` in place, as
    ``optax``'s ``init`` gives the state its ``update`` takes."""
    lr: float
    cnn_lr: float
    gclip: float
    freeze_cnn: bool

    def init(self, params: JointParams) -> "JointOptState":
        return JointOptState(self, params)


def make_joint_optimizer(cfg: LRCNConfig, cnn_lr: float | None = None,
                         freeze_cnn: bool = False) -> JointOptimizer:
    """Adam with a separate (usually smaller) CNN learning rate.

    ``cnn_lr`` defaults to ``cfg.lr / 10`` (fine-tuning convention);
    ``freeze_cnn`` zeroes the CNN's updates and keeps no state for it
    (optax's ``set_to_zero``)."""
    if cnn_lr is None:
        cnn_lr = cfg.lr / 10.0
    return JointOptimizer(lr=float(cfg.lr), cnn_lr=float(cnn_lr),
                          gclip=float(cfg.gclip or 0.0),
                          freeze_cnn=bool(freeze_cnn))


class JointOptState:
    """Adam's state over a ``JointParams``: ``zero_grad``, backward into
    ``grad_params()``, then ``step``.

    ``state_leaves``/``load_leaves`` convert it from and to optax's
    leaves of ``make_joint_optimizer(cfg).init(params)``: the CNN's Adam
    (count, 30 first moments, 30 second moments, in sorted key order),
    then the decoder's (count, 9, 9): 80 leaves; 19 with the CNN frozen.
    The clip adds none.
    """

    def __init__(self, opt: JointOptimizer, params: JointParams):
        self.opt = opt
        self.cnn = [params.cnn[k] for k in CNN_OPT_KEYS]
        self.decoder = [params.decoder[k] for k in OPT_KEYS]
        self.cnn_adam = (None if opt.freeze_cnn
                         else make_adam(self.cnn, opt.cnn_lr))
        self.decoder_adam = make_adam(self.decoder, opt.lr)

    def grad_params(self) -> list[torch.Tensor]:
        """The parameters whose gradients a step needs: the CNN's unless
        it is frozen with the clip off (then nothing reads them)."""
        if self.opt.freeze_cnn and self.opt.gclip <= 0:
            return list(self.decoder)
        return self.cnn + self.decoder

    def zero_grad(self) -> None:
        for p in self.cnn + self.decoder:
            p.grad = None

    def step(self) -> None:
        if self.opt.gclip > 0:   # over both sets, before the split
            clip_by_global_norm_([p.grad for p in self.grad_params()],
                                 self.opt.gclip)
        if self.cnn_adam is not None:
            self.cnn_adam.step()
        self.decoder_adam.step()

    def tensors(self) -> list[torch.Tensor]:
        """Both parameter sets and both Adams' state, as a captured step
        reads them."""
        return self.cnn + self.decoder + [
            t for a in (self.cnn_adam, self.decoder_adam) if a is not None
            for t in adam_state(a)]

    def state_leaves(self) -> list[np.ndarray]:
        leaves = [] if self.cnn_adam is None else adam_leaves(self.cnn_adam,
                                                              self.cnn)
        return leaves + adam_leaves(self.decoder_adam, self.decoder)

    def load_leaves(self, leaves: Sequence[np.ndarray]) -> None:
        """Restore both Adams from optax's leaves (a joint checkpoint's
        ``opt_leaves``, written by either package)."""
        n_cnn = 0 if self.cnn_adam is None else 1 + 2 * len(self.cnn)
        want = n_cnn + 1 + 2 * len(self.decoder)
        if len(leaves) != want:
            raise ValueError(f"{len(leaves)} optimizer leaves; the joint "
                             f"optimizer{' (CNN frozen)' if not n_cnn else ''}"
                             f" has {want}")
        if n_cnn:
            load_adam_leaves(self.cnn_adam, self.cnn, CNN_OPT_KEYS,
                             leaves[:n_cnn], "the CNN")
        load_adam_leaves(self.decoder_adam, self.decoder, OPT_KEYS,
                         leaves[n_cnn:], "the decoder")
        graphs.forget(self)


class JointTrainStep:
    """End-to-end train step on one device.

    Images are fed raw, uint8 pixels (or 255-scale float32): the
    mean-image subtraction runs on the device inside the step, so the host
    ships a quarter of the bytes of a float32 feed.  ``multi_step`` runs K
    optimizer steps over stacked same-shape batches, enqueued with no host
    synchronisation.  Parameters and optimizer state are updated in place
    and returned, as the JAX step returns its new ones.
    """

    def __init__(self, cfg: LRCNConfig, opt: JointOptimizer,
                 remat_cnn: bool = True, average_image=None, device="cuda",
                 mesh=None):
        self.cfg = cfg
        self.opt = opt
        self.mesh = mesh
        if mesh is not None:
            from lrcn_tpu_torch.parallel.train import check_training_mesh
            check_training_mesh(mesh)
            device = mesh.local_device()
        self.device = as_device(device)
        # graphs.step/run's say over a mesh: the groups of its collectives
        self._graphs = {} if mesh is None else {"groups": mesh.groups()}
        self.compute_dtype = compute_dtype_of(cfg)
        self.remat_cnn = remat_cnn
        avg = (np.zeros((224, 224, 3), np.float32) if average_image is None
               else np.asarray(average_image, np.float32))
        self._avg = torch.from_numpy(avg).to(self.device)

    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """uint8/float raw pixels -> float32 mean-subtracted (lrcn.jl:771)."""
        return images.float() - self._avg

    def value_and_grad(self, params: JointParams, opt_state: JointOptState,
                       images, tokens, lengths, key: int = 0,
                       drop_masks=None) -> torch.Tensor:
        """The batch's (global) mean loss, with its gradient in the
        ``.grad`` of ``opt_state.grad_params()`` (summed over ``data``
        under a mesh); no update.  ``drop_masks``: the global batch's
        dropout masks, injected in the place of the step generator's."""
        generator = (step_generator(key, self.device)
                     if self.cfg.dropout > 0 and drop_masks is None
                     else None)
        return self._value_and_grad(params, opt_state, images, tokens,
                                    lengths, generator, drop_masks)

    def _value_and_grad(self, params, opt_state, images, tokens, lengths,
                        generator, drop_masks=None) -> torch.Tensor:
        pdrop = self.cfg.dropout
        opt_state.zero_grad()
        if self.mesh is not None and pdrop > 0:
            from lrcn_tpu_torch.parallel.train import global_drop_masks
            drop_masks = global_drop_masks(
                self.cfg, tokens.shape[1] + 1, tokens.shape[0], self.mesh,
                generator, drop_masks, self.device)
        total, count = joint_loss_total_count(
            params, self._preprocess(images), tokens, lengths, pdrop=pdrop,
            generator=generator, drop_masks=drop_masks,
            compute_dtype=self.compute_dtype, remat_cnn=self.remat_cnn)
        if self.mesh is not None:
            from lrcn_tpu_torch.parallel.train import (sum_grads,
                                                       sum_over_data)
            count = sum_over_data(count, self.mesh)
            (total / count).backward(inputs=opt_state.grad_params())
            sum_grads(opt_state.grad_params(), self.mesh.group("data"))
            return sum_over_data(total, self.mesh) / count
        loss = total / count
        loss.backward(inputs=opt_state.grad_params())
        return loss.detach()

    def _steps_fn(self, params, opt_state, generators, images_k, tokens_k,
                  lengths_k) -> torch.Tensor:
        """The eager body of :meth:`_steps`: K optimizer steps, step i's
        dropout from ``generators[i]``; leaves no gradient behind."""
        losses = []
        for i in range(tokens_k.shape[0]):
            losses.append(self._value_and_grad(
                params, opt_state, images_k[i], tokens_k[i], lengths_k[i],
                generators[i] if generators else None))
            opt_state.step()
        opt_state.zero_grad()
        return torch.stack(losses)

    def _steps(self, params, opt_state, images_k, tokens_k, lengths_k,
               keys: Sequence[int]) -> torch.Tensor:
        """K steps with the step keys ``keys``: on a card one graph replay
        (under a mesh, on NCCL groups)."""
        return graphs.step(
            opt_state, ("joint", self.cfg.dropout, self.compute_dtype,
                        self.remat_cnn),
            functools.partial(self._steps_fn, params, opt_state),
            (images_k, tokens_k, lengths_k),
            reads=(*opt_state.tensors(), self._avg),
            seeds=([step_seed(k) for k in keys] if self.cfg.dropout > 0
                   else ()), **self._graphs)

    def __call__(self, params, opt_state, images, tokens, lengths, key: int
                 ) -> tuple[JointParams, JointOptState, torch.Tensor]:
        losses = self._steps(params, opt_state, images[None], tokens[None],
                             lengths[None], [key])
        return params, opt_state, losses[0]

    def multi_step(self, params, opt_state, images_k, tokens_k, lengths_k,
                   base_key: int, offset: int
                   ) -> tuple[JointParams, JointOptState, torch.Tensor]:
        """K steps over (K, B, ...) stacked batches; step i's dropout key is
        ``fold_in(base_key, offset + i)``.  Returns the K losses, not
        read."""
        keys = [fold_in(base_key, offset + i)
                for i in range(tokens_k.shape[0])]
        losses = self._steps(params, opt_state, images_k, tokens_k,
                             lengths_k, keys)
        return params, opt_state, losses

    def _eval_fn(self, params: JointParams, images, tokens, lengths
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        feats = l1_normalize(vgg16_fc7_train(
            params.cnn, self._preprocess(images), self.compute_dtype))
        total, count = lrcn.loss_total_count(params.decoder, tokens, lengths,
                                             feats,
                                             compute_dtype=self.compute_dtype)
        if self.mesh is not None:
            from lrcn_tpu_torch.parallel.train import sum_over_data
            total = sum_over_data(total, self.mesh)
            count = sum_over_data(count, self.mesh)
        return total, count

    @torch.no_grad()
    def eval_batch(self, params: JointParams, images, tokens, lengths
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(total NLL, token count) of one batch (under a mesh, of the
        global batch), no dropout, on the device; on a card one graph
        replay (under a mesh, on NCCL groups)."""
        return graphs.run(
            params.cnn, ("joint_eval", self.compute_dtype),
            functools.partial(self._eval_fn, params),
            (images, tokens, lengths),
            reads=(*params.decoder.values(), self._avg), **self._graphs)

    def init(self, generator: torch.Generator | int, vgg_params=None
             ) -> tuple[JointParams, JointOptState]:
        """Fresh parameters on the device and a fresh optimizer state.

        Two seeds drawn from ``generator`` (or a seed) give the VGG and the
        decoder their own streams, as JAX splits its key; ``vgg_params``
        (a ``VGGParams`` or a numpy tree) replaces the random VGG."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        seeds = torch.randint(0, 2 ** 62, (2,), generator=generator).tolist()
        if vgg_params is None:
            vgg_params = init_vgg_params(
                torch.Generator().manual_seed(seeds[0]))
        elif not isinstance(vgg_params, VGGParams):
            vgg_params = VGGParams.from_numpy(vgg_params, "cpu")
        decoder = lrcn.init_params(self.cfg,
                                   torch.Generator().manual_seed(seeds[1]))
        params = JointParams(vgg_params.to(self.device),
                             decoder.to(self.device))
        return params, self.opt.init(params)

    def _put(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            self.device, non_blocking=True)

    def _as_image_array(self, images) -> np.ndarray:
        images = np.asarray(images)
        if images.dtype != np.uint8:   # already-scaled float pixels
            images = images.astype(np.float32)
        return images

    def put_local(self, images, tokens, lengths):
        """This rank's raw image pixels (uint8 preferred) + tokens ->
        device tensors; uint8 stays uint8."""
        return (self._put(self._as_image_array(images)),
                self._put(np.asarray(tokens, np.int32)),
                self._put(np.asarray(lengths, np.int32)))

    def local_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows (all of them
        without a mesh)."""
        if self.mesh is None:
            return slice(0, n)
        from lrcn_tpu_torch.parallel.train import data_rows
        return data_rows(self.mesh, n)

    def shard_batch(self, images, tokens, lengths):
        """A global batch of raw image pixels + tokens -> this rank's rows
        as device tensors (every row without a mesh)."""
        rows = self.local_rows(len(tokens))
        return self.put_local(np.asarray(images)[rows],
                              np.asarray(tokens)[rows],
                              np.asarray(lengths)[rows])

    def shard_chunk(self, images_k, tokens_k, lengths_k):
        """K stacked global batches for ``multi_step`` (leading step
        axis) -> this rank's rows of each."""
        rows = self.local_rows(np.shape(tokens_k)[1])
        return self.put_local(np.asarray(images_k)[:, rows],
                              np.asarray(tokens_k)[:, rows],
                              np.asarray(lengths_k)[:, rows])
