"""Device meshes for multi-device LRCN runs (counterpart of
``lrcn_tpu/parallel/mesh.py`` and of ``jax.sharding.Mesh``).

A ``Mesh`` is a grid of ``torch.device``s with axis names, 2-D
``("data", "model")`` by default:

- axis ``data``: data parallelism, the batch dimension is split over it;
- axis ``model``: tensor parallelism over the vocabulary (the embedding
  table and the output projection; ``parallel/train.py``), or the two
  pipeline stages (``parallel/pipeline.py``).

Where the devices come from:

- in a process group (``parallel/distributed.py:initialize``), one entry
  per rank in row-major order: rank r sits at ``divmod(r, shape[1])``;
  the mesh then also holds this rank's ``data`` and ``model`` subgroups;
- outside one, the local CUDA devices (the CPU where there is no card);
- a caller may list one device several times: each entry is then a shard
  of its own (two serving shards, or two gloo ranks, on one card; the
  CPU tests' meshes of 2-8 CPU entries).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from lrcn_tpu_torch.config import LRCNConfig


def _rank_device(rank: int) -> torch.device:
    """The device a rank drives by default: its card under NCCL, the CPU
    under gloo."""
    if dist.get_backend() == "nccl":
        if rank == dist.get_rank():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return torch.device("cpu")


def available_devices() -> list[torch.device]:
    """One device per rank in a process group; else the local CUDA
    devices, or the CPU where there is no card."""
    if dist.is_initialized():
        return [_rank_device(r) for r in range(dist.get_world_size())]
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class Mesh:
    """A grid of devices with named axes; ``mesh.shape["data"]`` reads as
    in JAX.  In a process group it also knows this rank's coordinates and
    the subgroup along each axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.distributed = dist.is_initialized()
        self._coords: dict[str, int] = dict.fromkeys(self.axis_names, 0)
        self._groups: dict[str, object] = {}
        if self.distributed:
            self._join_groups()

    def _join_groups(self) -> None:
        """Create the subgroup along every axis (each rank enters every
        ``new_group`` call, in the same order) and keep this rank's."""
        rank = dist.get_rank()
        ranks = np.arange(self.size).reshape(self.devices.shape)
        if rank < self.size:
            coords = np.unravel_index(rank, self.devices.shape)
            self._coords = {a: int(c) for a, c in zip(self.axis_names,
                                                      coords)}
        for i, axis in enumerate(self.axis_names):
            rows = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
            for row in rows:
                group = dist.new_group([int(r) for r in row])
                if rank in row:
                    self._groups[axis] = group

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 outside a process group)."""
        return self._coords[axis]

    def group(self, axis: str):
        """This rank's subgroup along ``axis``, or None outside a process
        group."""
        return self._groups.get(axis)

    def groups(self) -> tuple:
        """This rank's subgroups, in axis order (none outside a process
        group): every group a mesh step's collectives run over."""
        return tuple(self._groups[a] for a in self.axis_names
                     if a in self._groups)

    def local_device(self) -> torch.device:
        """The device this rank drives (the first entry outside a process
        group)."""
        if self.distributed:
            return torch.device(self.devices[tuple(
                self._coords[a] for a in self.axis_names)])
        return torch.device(self.devices.flat[0])

    def data_devices(self) -> list[torch.device]:
        """The device of each data shard (the first entry along the other
        axes), in order: where a single-process search runs each slice."""
        grid = np.moveaxis(self.devices, self.axis_names.index("data"), 0)
        return [torch.device(d) for d in grid.reshape(grid.shape[0], -1)[:, 0]]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(shape: Sequence[int] = (-1, 1),
              axis_names: Sequence[str] = ("data", "model"),
              devices: Sequence | None = None) -> Mesh:
    """Build a mesh over the available devices (``available_devices``) or
    the ``devices`` given.

    A single ``-1`` entry in ``shape`` absorbs all remaining devices (so
    ``(-1, 1)`` is "pure DP over everything")."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else available_devices())]
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError(f"at most one -1 wildcard allowed, got {shape}")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if len(devices) % known:
            raise ValueError(
                f"{len(devices)} devices not divisible by fixed mesh dims "
                f"{known}")
        shape[shape.index(-1)] = len(devices) // known
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n} devices, have "
            f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(shape), tuple(axis_names))


def mesh_from_config(cfg: LRCNConfig, devices: Sequence | None = None
                     ) -> Mesh:
    return make_mesh(cfg.mesh_shape, cfg.mesh_axis_names, devices)
