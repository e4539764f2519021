"""Meshes of ranks.

A ``Mesh`` here is a named grid of process ranks: it exists without a
process group, so the elastic mesh math (``distributed/elastic.py``) and the
sharding rules (``models/sharding.py``, ``launch/shardings.py``) run on rank
lists anywhere, the tests included.  ``Mesh.device_mesh`` turns it into a
``torch.distributed`` ``DeviceMesh`` once a process group holds its ranks.

Meshes:
    single-pod : (16, 16)    = ("data", "model")            256 ranks
    multi-pod  : (2, 16, 16) = ("pod", "data", "model")     512 ranks

The ``pod`` axis composes with ``data`` for gradient reduction; the
``model`` axis stays inside one pod.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


class Mesh:
    """``ranks`` (an integer array, one dim per axis) named by
    ``axis_names``."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        ranks = np.array(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"ranks of shape {ranks.shape} cannot take the "
                             f"axes {axis_names}")
        ranks.flags.writeable = False
        self.ranks = ranks
        self.axis_names = axis_names
        self._device_meshes: dict = {}

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self):
        return f"Mesh({self.shape})"

    def device_mesh(self, device_type: str = "cuda"):
        """This mesh as a ``DeviceMesh`` over the default process group,
        which must hold every rank of it.  Built once per device type and
        process group (building one is a collective call on every rank)."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(f"{self}: no process group holds its ranks; "
                               f"init_process_group first")
        if int(self.ranks.max()) >= dist.get_world_size():
            raise RuntimeError(f"{self}: rank {int(self.ranks.max())} is "
                               f"outside the world of "
                               f"{dist.get_world_size()}")
        world = dist.group.WORLD
        cached = self._device_meshes.get(device_type)
        if cached is not None and cached[0] is world:
            return cached[1]
        from torch.distributed.device_mesh import DeviceMesh
        dm = DeviceMesh(device_type, torch.from_numpy(self.ranks.copy()),
                        mesh_dim_names=self.axis_names)
        self._device_meshes[device_type] = (world, dm)
        return dm


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Ranks ``0..n-1`` in the grid ``shape`` (row-major)."""
    return Mesh(np.arange(math.prod(shape)).reshape(shape), axes)


def single_device_mesh() -> Mesh:
    return make_mesh((1, 1), ("data", "model"))
