"""What the training drivers share: the port's configuration object, the
caption batches, the readings of the first dispatches, and their check.

Set-up builds one trainer with its parameters and optimizer state and
drives it from the seed through ``check_dispatches`` epochs of the
window's own call (``train_epoch``), each of ``steps_per_dispatch``
batches of the window's shape, so that each is one dispatch of the
window's K steps: the first runs eagerly, the second captures the graph
the window replays, the third replays it.  The rows of all of them
differ.  It reads the first gradient as Adam got it (its first moment
after the first step of the eager dispatch, over ``1 - b1``), Adam's
bias-corrected first moment after that dispatch's K steps, the
parameters' change after the last dispatch, and the losses the trainer
logs (the last of each dispatch); then it hands the same objects to the
window.

The reference runs the same steps from the same weights, batches, batch
order and dropout keys in float32 (``reference/keys.py``).  Each number
is a gap between the port's reading and the reference's:

- ``grad_gap`` and ``change_gap``: over the leaves, the largest gap
  between the port's norm and the reference's, over the reference's norm
  of that leaf or of the median leaf, whichever is larger;
- ``grad_diff``: the same of the norm of the first gradient's difference
  from the reference's.  A norm moves only at second order under
  unbiased rounding, so a lower precision can leave ``grad_gap`` where
  bf16 has it; the difference moves at first order;
- ``moment_diff``: the median over the leaves of the norm of the first
  moment's difference after the first dispatch, over the reference's
  norm of the leaf.  The worst leaf's swings by seed: Adam's first step
  moves every element by the learning rate with its gradient's sign,
  which rounding sets where a gradient is near 0, and the later steps'
  gradients follow.

The losses are printed, not compared: at the init every token's loss is
near ln V, and neither the control nor a fault moves them above rounding.
A leaf whose reference gradient at the first step is under a thousandth
of the median leaf's is left out: round-off alone moves it under Adam,
and its gradient sums cotangents that cancel (VGG-16's biases).  Which
numbers a cell compares is its ``limits/<cell>.json``; each leaf's
readings are printed on stderr.
"""

from __future__ import annotations

import contextlib
import json
import sys
from typing import NamedTuple

import numpy as np
import torch

from portbench import inputs
from portbench.harness.main import Check
from portbench.reference import train as ref_train
from portbench.reference.keys import dispatch_keys, epoch_order
from portbench.reference.precision import strict_float32

BETA1 = 0.9
EXCLUDE_BELOW = 1e-3
SHUFFLE = inputs.CAPTIONS + 100     # the stream of the epochs' shuffles


def port_config(ctx):
    from lrcn_tpu_torch.config import LRCNConfig

    cfg, tr = ctx.config, ctx.traffic
    return LRCNConfig(hidden=tuple(cfg["hidden"]), embed=cfg["embed"],
                      cnn_feature_dim=cfg["cnn_feature_dim"],
                      vocab_size=cfg["vocab_size"], dropout=tr["dropout"],
                      lr=tr["lr"], gclip=tr["gclip"],
                      compute_dtype=cfg["compute_dtype"])


def logger():
    """The trainer's metrics logger, keeping its records (the losses it
    logs) instead of printing them."""
    from lrcn_tpu_torch.train.metrics import MetricsLogger

    class Kept(MetricsLogger):
        def __init__(self):
            super().__init__(echo=False)
            self.records = []

        def log(self, **values):
            record = super().log(**values)
            self.records.append(record)
            return record

    return Kept()


class Captions(NamedTuple):
    image_ids: np.ndarray     # (B,) int64
    tokens: np.ndarray        # (B, L) int32
    lengths: np.ndarray       # (B,) int32


def make_batches(rng: np.random.Generator, n: int, ids: np.ndarray,
                 ctx, distinct: bool = False) -> list[Captions]:
    """``n`` caption batches of the traffic's size over image ids drawn
    from ``ids`` (no id twice in a batch; with ``distinct``, none twice
    across the batches)."""
    b = ctx.traffic["batch"]
    if distinct:
        drawn = rng.choice(ids, size=n * b, replace=False).reshape(n, b)
    else:
        drawn = np.stack([rng.choice(ids, size=b, replace=False)
                          for _ in range(n)])
    out = []
    for row_ids in drawn:
        tokens, lengths = inputs.caption_rows(rng, b, ctx.config,
                                              ctx.traffic)
        out.append(Captions(row_ids.astype(np.int64), tokens, lengths))
    return out


def port_batches(batches: list[Captions]) -> list:
    """The same batches as the port's ``Batch`` objects."""
    from lrcn_tpu_torch.data.batcher import Batch

    return [Batch(*b) for b in batches]


def shuffle_rng(ctx) -> np.random.Generator:
    """The generator the trainer shuffles its epochs with."""
    return np.random.default_rng(inputs.stream_seed(ctx.seed, SHUFFLE))


def check_epochs(ctx, rng, ids: np.ndarray) -> list[list[Captions]]:
    """The check's ``check_dispatches`` epochs of ``steps_per_dispatch``
    batches each, no row twice among them."""
    tr = ctx.traffic
    k = tr["steps_per_dispatch"]
    batches = make_batches(rng, tr["check_dispatches"] * k, ids, ctx,
                           distinct=True)
    return [batches[i:i + k] for i in range(0, len(batches), k)]


class Readings:
    """The port's readings of the first dispatches."""

    def __init__(self):
        self.grads: dict[str, torch.Tensor] = {}
        self.moments: dict[str, torch.Tensor] = {}
        self.change_norms: dict[str, float] = {}
        self.losses: list[float] = []

    @staticmethod
    def first_moment(leaves: dict[str, tuple], steps: int
                     ) -> dict[str, torch.Tensor]:
        """Adam's bias-corrected first moment after ``steps`` steps, on
        the host; ``leaves``: name -> (parameter, its Adam).  A leaf with
        no state (never stepped) reads 0."""
        out = {}
        for name, (param, adam) in leaves.items():
            m = adam.state.get(param, {}).get("exp_avg")
            m = torch.zeros_like(param) if m is None else m
            out[name] = (m.float() / (1 - BETA1 ** steps)).cpu()
        return out

    def changes(self, now: dict[str, torch.Tensor],
                before: dict[str, torch.Tensor]) -> None:
        for name, value in now.items():
            self.change_norms[name] = float((value.detach()
                                             - before[name]).norm())


@contextlib.contextmanager
def after_first_step(opt, read):
    """``opt.step`` wrapped on the instance to call ``read()`` once,
    after its first call; unwrapped on exit."""
    step, done = opt.step, []

    def once():
        step()
        if not done:
            done.append(True)
            read()

    opt.step = once
    try:
        yield
    finally:
        del opt.step


def first_dispatches(work, before: dict[str, torch.Tensor], event: str
                     ) -> Readings:
    """Drive ``work`` through its check's epochs (``work.check_epochs``)
    with ``work.train``, reading ``work.leaves()`` (name -> (parameter,
    its Adam)) through the optimizer ``work.opt``; ``before``: the
    initial weights by leaf name; ``event``: the trainer's log event of a
    dispatch's loss."""
    k = work.ctx.traffic["steps_per_dispatch"]
    readings = Readings()

    def first_grad():
        readings.grads = Readings.first_moment(work.leaves(), 1)

    with after_first_step(work.opt, first_grad):
        work.train(port_batches(work.check_epochs[0]))
    readings.moments = Readings.first_moment(work.leaves(), k)
    for epoch in work.check_epochs[1:]:
        work.train(port_batches(epoch))
    readings.changes({name: p for name, (p, _) in work.leaves().items()},
                     before)
    readings.losses = [r["loss"] for r in work.log.records
                       if r.get("event") == event]
    return readings


def _worst(values: dict[str, float], ref: dict[str, float],
           keep: list[str]) -> tuple[float, str]:
    """The largest of ``values[k]`` over ``max(ref[k], median ref)``."""
    median = float(np.median([ref[k] for k in keep]))
    return max((values[k] / max(ref[k], median), k) for k in keep)


def schedule(ctx, epochs: list[list]) -> tuple[list, list[int]]:
    """The check's batches in the order they run, and their step keys,
    worked out again from the seed."""
    k = ctx.traffic["steps_per_dispatch"]
    rng = shuffle_rng(ctx)
    ordered = [epoch[i] for epoch in epochs for i in epoch_order(rng, k)]
    keys = dispatch_keys(inputs.stream_seed(ctx.seed, inputs.CHECK), k,
                         len(epochs))
    return ordered, keys


def reference_readings(ctx, ref_params: dict, epochs: list[list],
                       quant=None, half_batch: bool = False) -> dict:
    """The reference's readings of the same steps (``quant``: the
    control's precision; ``half_batch``: a fault planted in the
    reference), as the port's are read."""
    k = ctx.traffic["steps_per_dispatch"]
    batches, keys = schedule(ctx, epochs)
    with strict_float32():
        ref = ref_train.run_steps(ref_params, batches, keys, ctx.config,
                                  ctx.traffic, (k,), quant, half_batch)
    return {"losses": [ref["losses"][s - 1]
                       for s in range(k, len(batches) + 1, k)],
            "grads": ref["first_grad"], "moments": ref["moments"][k],
            "change_norms": {n: float((ref["params"][n]
                                       - ref_params[n]).norm())
                             for n in ref_params}}


def gaps(port: Readings | dict, ref: dict, log=None, label: str = "program"
         ) -> dict[str, float]:
    """The numbers compared: each a gap between ``port`` (the program's
    readings, or the reference's at another precision) and ``ref``.
    ``log``: a stream for the losses, the worst leaves and each leaf's
    readings (under ``label``)."""
    if isinstance(port, Readings):
        port = vars(port)
    norm = lambda t: float(t.norm())
    diff = lambda a, b: float((a.to(b.device) - b).norm())
    grad_norms = {n: norm(v) for n, v in ref["grads"].items()}
    median = float(np.median(list(grad_norms.values())))
    keep = [n for n, v in grad_norms.items() if v >= EXCLUDE_BELOW * median]
    leaves = {n: {
        "grad": grad_norms[n],
        "grad_gap": abs(norm(port["grads"][n]) - grad_norms[n]),
        "grad_diff": diff(port["grads"][n], ref["grads"][n]),
        "moment": norm(ref["moments"][n]),
        "moment_diff": diff(port["moments"][n], ref["moments"][n]),
        "change": ref["change_norms"][n],
        "change_gap": abs(port["change_norms"][n] - ref["change_norms"][n])}
        for n in keep}
    column = lambda key: {n: leaves[n][key] for n in keep}
    out, worst = {}, {}
    for name, of in (("grad_gap", "grad"), ("grad_diff", "grad"),
                     ("change_gap", "change")):
        out[name], worst[name] = _worst(column(name), column(of), keep)
    out["moment_diff"] = float(np.median([
        leaves[n]["moment_diff"] / leaves[n]["moment"] for n in keep]))
    if log is not None:
        print(f"training check: losses {port['losses']}, reference "
              f"{ref['losses']}; worst leaves {worst}; left out: "
              f"{sorted(set(grad_norms) - set(keep))}", file=log)
        print(f"training leaves {label}: {json.dumps(leaves)}", file=log)
    return out


def check(ctx, readings: Readings, ref_params: dict, epochs: list[list]
          ) -> list[Check]:
    ref = reference_readings(ctx, ref_params, epochs)
    found = gaps(readings, ref, log=sys.stderr)
    return [Check(name, found[name], limit)
            for name, limit in ctx.limits.items()]
