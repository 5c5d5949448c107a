"""Run a function on every rank of a fresh gloo process group on the CPU,
and the multi-device dry run built on it (the counterpart of
``__graft_entry__.py:dryrun_multichip``).

    python -m lrcn_tpu_torch.parallel.dryrun 4      # the dry run, 4 ranks

``spawn("module:function", n, *args)`` starts ``n`` fresh interpreters,
joins them in one gloo group (a ``file://`` rendezvous in a temporary
directory), calls the function with ``args`` on each, and returns the
ranks' return values in rank order.  A rank that fails or outlives
``timeout`` fails the call, and every rank is ended: a hung rank cannot
hold its caller.  The CPU tests run their multi-rank checks through it.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np


def _child(target: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from lrcn_tpu_torch.parallel.distributed import initialize

    initialize(f"file://{os.path.join(workdir, 'rendezvous')}", world, rank,
               backend="gloo")
    with open(os.path.join(workdir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    module, name = target.split(":")
    result = getattr(importlib.import_module(module), name)(*args)
    with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn(target: str, n: int, *args, timeout: float = 120.0,
          env: dict | None = None) -> list:
    """Call ``target`` (``"module:function"``) with ``args`` on ``n`` gloo
    CPU ranks; returns their results in rank order."""
    with tempfile.TemporaryDirectory(prefix="lrcn_spawn_") as workdir:
        with open(os.path.join(workdir, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        child_env = dict(os.environ if env is None else env)
        child_env["PYTHONPATH"] = os.pathsep.join(
            p for p in sys.path if p)
        child_env.pop("WORLD_SIZE", None)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "lrcn_tpu_torch.parallel.dryrun",
             "--child", target, str(rank), str(n), workdir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=child_env) for rank in range(n)]
        deadline = time.monotonic() + timeout
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            raise RuntimeError(f"{target} on {n} ranks outlived "
                               f"{timeout} s") from None
        failed = [(r, p.returncode, err[-1500:]) for r, (p, (_, err))
                  in enumerate(zip(procs, outs)) if p.returncode]
        if failed:
            raise RuntimeError(f"{target} failed on ranks "
                               f"{[r for r, _, _ in failed]}:\n"
                               + "\n".join(e for _, _, e in failed))
        results = []
        for rank in range(n):
            with open(os.path.join(workdir, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def dryrun_step(n_devices: int) -> dict:
    """ONE full sharded train step on this rank (run under ``spawn``):
    2-way vocabulary tensor parallelism where the count allows, the rest
    data parallel; with TP also the pipelined step."""
    import torch

    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.models import lrcn
    from lrcn_tpu_torch.parallel import (PipelinedTrainStep,
                                         ShardedTrainStep, make_mesh)

    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh((n_devices // tp, tp))
    cfg = LRCNConfig(hidden=(64, 64), embed=48, cnn_feature_dim=128,
                     vocab_size=64, dropout=0.4, gclip=5.0,
                     compute_dtype="float32")
    step = ShardedTrainStep(cfg, mesh)
    params = step.shard_params(
        lrcn.init_params(cfg, torch.Generator().manual_seed(0)))
    opt = step.init_opt(params)
    rng = np.random.default_rng(0)
    batch, length = 2 * n_devices, 9
    host = (rng.integers(3, cfg.vocab_size, (batch, length)).astype(np.int32),
            rng.integers(3, length + 1, (batch,)).astype(np.int32),
            rng.standard_normal((batch, cfg.cnn_feature_dim)
                                ).astype(np.float32))
    params, opt, loss = step(params, opt, *step.shard_batch(*host), 1)
    out = {"mesh": (n_devices // tp, tp), "loss": float(loss)}
    if tp == 2:
        pp_cfg = LRCNConfig(hidden=(64, 64), embed=64, cnn_feature_dim=128,
                            vocab_size=64, dropout=0.4, gclip=5.0,
                            compute_dtype="float32")
        pp_step = PipelinedTrainStep(pp_cfg, mesh)
        pp_params = pp_step.shard_params(
            lrcn.init_params(pp_cfg, torch.Generator().manual_seed(2)))
        pp_opt = pp_step.init_opt(pp_params)
        _, _, pp_loss = pp_step(pp_params, pp_opt,
                                *pp_step.shard_batch(*host), 3)
        out["pipeline_loss"] = float(pp_loss)
    return out


def dryrun_multichip(n_devices: int, timeout: float = 120.0) -> dict:
    """Run one full sharded train step (and the pipelined one where TP is
    2) over ``n_devices`` gloo CPU ranks; every rank's loss must be finite
    and the same.  Returns rank 0's losses."""
    results = spawn("lrcn_tpu_torch.parallel.dryrun:dryrun_step", n_devices,
                    n_devices, timeout=timeout)
    for key in results[0]:
        if key == "mesh":
            continue
        values = [r[key] for r in results]
        if not all(np.isfinite(values)) or len(set(values)) != 1:
            raise RuntimeError(f"{key} by rank: {values}")
    return results[0]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        _child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
