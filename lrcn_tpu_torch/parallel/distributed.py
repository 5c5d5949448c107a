"""Multi-process runtime helpers over ``torch.distributed`` (counterpart
of ``lrcn_tpu/parallel/distributed.py``).

One process drives one device: a mesh of DP x TP entries is DP x TP
ranks of one process group, and ``--num-processes`` counts ranks.  These
helpers wrap the host-side jobs around the sharded steps:

- joining the group (``initialize``): NCCL for CUDA tensors, gloo for CPU
  tensors; gloo on CUDA tensors only where the caller names it (two ranks
  on one card: NCCL refuses a GPU twice), never as a fallback;
- this rank's rows of a batch (``host_local_batch``), the full tree on
  the host (``gather_to_host``), a shuffle seed every rank agrees on
  (``shared_seed``), the rank that owns side effects (``is_primary``) and
  a barrier.

Every collective here and in the sharded steps is a ``broadcast`` or an
``all_reduce``, the two that gloo runs on CUDA tensors: a gather is an
``all_reduce`` of a zero-filled full buffer with each shard in its slot.
So one code path runs under gloo on the CPU, gloo on one card and NCCL.
"""

from __future__ import annotations

import datetime
import os
import secrets
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from lrcn_tpu_torch.utils import graphs

# the torch launcher's variables (torchrun, torch.distributed.launch), in
# the place of JAX's coordinator variables
_LAUNCHER_ENV_VARS = ("WORLD_SIZE",)
_COUNT_ENV_VARS = ("SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE")

# a rank that does not arrive fails its peers' collectives after this long
TIMEOUT = datetime.timedelta(seconds=600)


def _cluster_environment() -> bool:
    """True when environment variables describe a MULTI-process run.

    Presence alone is not enough: single-worker setups set e.g.
    ``WORLD_SIZE=1`` (torchrun with one process) or
    ``SLURM_JOB_NUM_NODES=1``, and must stay single-process."""
    for count_var in _LAUNCHER_ENV_VARS + _COUNT_ENV_VARS:
        try:
            if int(os.environ.get(count_var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def default_backend(device=None) -> str:
    """NCCL for a CUDA device (``"cuda"`` when ``device`` is None and a
    card is present), gloo for the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None) -> None:
    """Join the process group (``init_process_group`` with
    ``init_method="tcp://HOST:PORT"``, the world size and the rank; an
    address with a scheme, e.g. ``file:///tmp/x``, is passed as it is).

    A no-op when every argument is None and no cluster environment
    variable is set (single-process), decided from the environment alone;
    in a cluster environment (``torchrun``) the group forms from the
    launcher's ``env://`` variables.  Errors propagate: a run that fell
    back to one process would train on a fraction of the data while
    looking healthy, and a failure to start NCCL is not met with gloo.

    ``backend``: ``"nccl"`` or ``"gloo"``; by default NCCL where a card is
    present.  Under NCCL the rank's card (``LOCAL_RANK``, else the rank
    modulo the cards) becomes the current device.
    """
    if dist.is_initialized():
        return
    explicit = not (coordinator_address is None and num_processes is None
                    and process_id is None)
    if not explicit and not _cluster_environment():
        return   # no cluster environment: stay single-process
    backend = backend or default_backend()
    kwargs: dict[str, Any] = {"backend": backend, "timeout": TIMEOUT}
    if explicit:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "multi-process runs need all of --coordinator, "
                "--num-processes and --process-id (or none of them under "
                "a launcher such as torchrun)")
        kwargs.update(init_method=(coordinator_address
                                   if "://" in coordinator_address
                                   else f"tcp://{coordinator_address}"),
                      world_size=int(num_processes), rank=int(process_id))
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        rank = int(process_id if explicit else os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(**kwargs)


def shutdown() -> None:
    """Leave the process group, if this process joined one, after
    dropping the captured graphs that replay its communicators."""
    if dist.is_initialized():
        graphs.forget_collectives()
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def collective_device() -> torch.device:
    """The device the group's collectives take tensors on: the current
    card under NCCL, the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_local_batch(mesh, batch_shard: Any) -> Any:
    """This rank's rows of a batch, as tensors on its mesh device.

    One process drives one device, so the rows a rank loaded are the rows
    its device computes on: the counterpart of assembling a global array
    from per-host shards is placing them (``put_batch`` slices a global
    batch instead)."""
    device = mesh.local_device()

    def one(x):
        if isinstance(x, Mapping):
            return {k: one(v) for k, v in x.items()}
        return torch.as_tensor(np.asarray(x)).to(device)
    return one(batch_shard)


def all_gather_shard(x: torch.Tensor, dim: int, group, n: int, index: int
                     ) -> torch.Tensor:
    """The full tensor of which ``x`` is shard ``index`` of ``n`` along
    ``dim`` over ``group``: an ``all_reduce`` of a zero-filled buffer that
    holds ``x`` in its slot (gloo's CUDA tensors take no all_gather)."""
    if n == 1:
        return x
    shape = list(x.shape)
    size = shape[dim]
    shape[dim] = size * n
    full = x.new_zeros(shape)
    full.narrow(dim, index * size, size).copy_(x)
    dist.all_reduce(full, group=group)
    return full


def gather_to_host(tree: Any, mesh=None, specs: Mapping | None = None
                   ) -> Any:
    """A tree of tensors as host numpy, each leaf at its global shape.

    COLLECTIVE whenever ``specs`` shards a leaf over a mesh axis of more
    than one rank: every rank must call it.  ``specs`` maps a leaf's key
    to its shard rule, a tuple of one mesh axis name (or None) per
    dimension (``parallel/train.py:PARAM_SPECS``); other leaves are
    replicated and read as they are."""
    specs = specs or {}

    def one(key, x):
        if isinstance(x, Mapping) or hasattr(x, "items"):
            return {k: one(f"{key}/{k}" if key else k, v)
                    for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return np.asarray(x)
        x = x.detach()
        spec = specs.get(key, ())
        for dim, axis in enumerate(spec):
            if axis is not None and mesh is not None:
                x = all_gather_shard(x, dim, mesh.group(axis),
                                     mesh.shape[axis], mesh.coord(axis))
        return x.cpu().numpy().copy()   # a host copy, even of a CPU leaf
    return one("", tree)


def shared_seed(seed: int | None) -> int | None:
    """A shuffle seed every rank agrees on.

    Seeded runs already agree.  Unseeded multi-process runs must not each
    draw their own entropy: the shuffle orders would diverge while the
    collectives still "work".  Rank 0 draws 31 bits and broadcasts them.
    Single-process, None stays None (the reference's unseeded runs)."""
    if seed is not None or process_count() == 1:
        return seed
    local = torch.tensor([secrets.randbits(31)], dtype=torch.int64,
                         device=collective_device())
    dist.broadcast(local, src=0)
    return int(local.item())


def is_primary() -> bool:
    """True on the rank that owns cluster-wide side effects (checkpoints,
    metrics files): rank 0, or any single-process run."""
    return process_index() == 0


def barrier(name: str) -> None:
    """Block until every rank reaches this point (single-process: no-op).
    ``name`` documents the meeting point; every rank passes the same."""
    del name
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
