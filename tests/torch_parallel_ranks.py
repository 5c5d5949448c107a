"""What each rank of the port's multi-rank CPU tests runs (through
``lrcn_tpu_torch.parallel.dryrun.spawn``).  Imports nothing of JAX: every
rank is a fresh interpreter that loads the port alone; the tests hold the
returned numpy results against the JAX package in the pytest process."""

from __future__ import annotations

import numpy as np
import torch

from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.parallel import distributed as pdist
from lrcn_tpu_torch.parallel import make_mesh
from lrcn_tpu_torch.parallel.distributed import gather_to_host
from lrcn_tpu_torch.parallel.pipeline import PipelinedTrainStep
from lrcn_tpu_torch.parallel.train import ShardedTrainStep
from lrcn_tpu_torch.train.trainer import adam_leaves


def train_steps(cfg_kwargs: dict, tree: dict, batches: list, masks: list,
                mesh_shape: tuple, pipeline: bool = False) -> dict:
    """Steps of the sharded (or pipelined) step from the full ``tree``
    over the GLOBAL ``batches``, with the GLOBAL ``masks`` (a pair or None
    per step) injected.  Returns the losses, the gradients of the first
    step (gathered, the step's own layout), the parameters after the last
    (gathered, the decoder's layout), the optimizer's 19 (or 15) global
    leaves, and this rank's parameter and leaf shapes."""
    torch.manual_seed(0)
    cfg = LRCNConfig(**cfg_kwargs)
    mesh = make_mesh(mesh_shape)
    step = (PipelinedTrainStep if pipeline else ShardedTrainStep)(cfg, mesh)
    params = step.shard_params(tree)
    opt = step.init_opt(params)
    out = {"losses": [], "coords": (mesh.coord("data"),
                                    mesh.coord("model"))}
    for i, batch in enumerate(batches):
        dev = step.shard_batch(*batch)
        m = None if masks[i] is None else tuple(map(torch.from_numpy,
                                                    masks[i]))
        loss = step.value_and_grad(params, opt, *dev, drop_masks=m)
        if i == 0:
            out["grads"] = gather_to_host(
                {k: params[k].grad for k in step.specs}, mesh, step.specs)
        opt.apply()
        out["losses"].append(float(loss))
    out["params"] = step.unshard_params(params)
    out["opt_leaves"] = opt.state_leaves()
    out["local_shapes"] = {k: tuple(params[k].shape) for k in step.specs}
    out["local_leaf_shapes"] = [np.shape(x) for x in
                                adam_leaves(opt.adam, opt.params)]
    with torch.no_grad():
        total, count = step.eval_batch(params, *step.shard_batch(
            *batches[0]))
    out["eval"] = (float(total), float(count))
    return out


def train_runs(runs: list[dict]) -> list[dict]:
    """:func:`train_steps` for each run's keyword arguments, in one
    group (the ranks start once)."""
    return [train_steps(**run) for run in runs]


def helpers(values: list) -> dict:
    """``host_local_batch``, ``gather_to_host``, ``shared_seed``,
    ``is_primary`` and ``barrier`` on this rank: each rank holds rows of
    ``rank + 1``; the sum over ranks sees every rank's rows."""
    import torch.distributed as dist

    rank = pdist.process_index()
    mesh = make_mesh((pdist.process_count(), 1))
    local = pdist.host_local_batch(mesh, {"x": np.full((3, 4), rank + 1.0,
                                                       np.float32)})
    total = local["x"].sum()
    dist.all_reduce(total)
    shard = torch.arange(4, dtype=torch.float32) + 10 * rank
    gathered = gather_to_host({"w": shard[None, :]}, make_mesh((1, 2)),
                              {"w": (None, "model")})
    pdist.barrier("helpers")
    return {"total": float(total), "gathered": gathered["w"],
            "seed": pdist.shared_seed(None), "explicit": pdist.shared_seed(41),
            "primary": pdist.is_primary(), "values": values[rank]}


def fit(cfg_kwargs: dict, words: list, captions: list, feats: dict,
        tree: dict, mesh_shape: tuple, savefile: str,
        pipeline: bool = False, steps_per_dispatch: int = 1) -> dict:
    """``Trainer.fit`` for one epoch from the full ``tree`` over a mesh of
    ranks (``captions``: (image id, words) pairs; ``feats``: id -> fc7
    row), checkpointing to ``savefile`` (rank 0 writes)."""
    import warnings

    from lrcn_tpu_torch.core.tokenizer import Caption
    from lrcn_tpu_torch.core.vocab import Vocab
    from lrcn_tpu_torch.data import FeatureStore, bucket_batches
    from lrcn_tpu_torch.train.metrics import MetricsLogger
    from lrcn_tpu_torch.train.trainer import Trainer

    cfg = LRCNConfig(**cfg_kwargs)
    vocab = Vocab(words)
    caps = [Caption(i, tuple(w)) for i, w in captions]
    store = FeatureStore.from_dict(feats)
    batches = bucket_batches(caps, vocab, cfg.batch_size,
                             apply_small_dataset_rule=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = Trainer(cfg, vocab, MetricsLogger(echo=False),
                          device="cpu", mesh=make_mesh(mesh_shape),
                          pipeline=pipeline,
                          steps_per_dispatch=steps_per_dispatch)
    params, opt = trainer.restore(tree)
    trainer.fit(params, opt, batches, None, store, None, 1, epochs=1,
                savefile=savefile, eval_train_loss=False)
    return {"steps_per_dispatch": trainer.steps_per_dispatch,
            "warned": [str(w.message) for w in caught],
            "primary": pdist.is_primary()}
