"""Elastic mesh management: shrink/grow the data axis on host failure.

Model-parallel shards are the unit of survival: losing a host removes one
or more full data-parallel replicas (the ``model`` axis must stay intact, so
we drop the whole data rows containing failed hosts).  ``shrink_mesh``
computes the largest valid mesh from the surviving ranks; the trainer then
restores the latest checkpoint onto the new mesh (checkpoint/ is
mesh-independent) and resumes.

Ranks stand where the JAX package has devices: the lists come from the
process group after it re-initialises, or, in tests, are given.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.launch.mesh import Mesh


def elastic_mesh_shapes(n_devices: int, model_parallel: int,
                        pods: int = 1) -> Optional[tuple[int, ...]]:
    """Largest (pod, data, model) / (data, model) shape fitting n_devices.

    The model axis is fixed (parameter shards must stay whole); the data
    axis absorbs the loss.  Returns None if not even one replica fits.
    """
    per_pod = n_devices // pods
    data = per_pod // model_parallel
    if data < 1:
        return None
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)


def shrink_mesh(ranks: Sequence[int], model_parallel: int,
                axis_names: tuple[str, ...] = ("data", "model")
                ) -> Optional[Mesh]:
    """Build the largest valid mesh from surviving ranks.

    Drops the remainder so every data row has a full ``model_parallel``
    worth of ranks."""
    data = len(ranks) // model_parallel
    if data < 1:
        return None
    usable = np.array(ranks[:data * model_parallel]).reshape(
        data, model_parallel)
    return Mesh(usable, axis_names)


def survivors(ranks: Sequence, failed_hosts: Sequence[int],
              devices_per_host: int) -> list:
    """Rank list with failed hosts' ranks removed (host h owns the
    contiguous block [h*dph, (h+1)*dph))."""
    failed = set(failed_hosts)
    return [d for i, d in enumerate(ranks)
            if i // devices_per_host not in failed]
