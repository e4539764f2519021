"""Sharded, asynchronous checkpointing with elastic restore.

Layout (mesh-independent, so restore works onto any mesh), the same on disk
as the JAX package's, so that a checkpoint written by either package
restores in the other:

    <dir>/step_<N>/
        manifest.json        # leaf key -> {shape, dtype, shard}
        shard_<k>.npz        # leaves bin-packed by bytes into n_shards files
        COMMIT               # written last

* **Leaf keys** are the other package's ``keystr`` of each leaf's path in
  the whole tree: ``.params['blocks']['0']['attn']['wq']``, ``.opt.step``;
  a ``QTensor`` moment is two leaves, ``...[<flat index 0>]`` (``q``) and
  ``...[<flat index 1>]`` (``scale``); ``None`` (no error feedback) is no
  leaf.  Leaves come in that package's flatten order (named-tuple fields in
  order, dict keys sorted), so the bin-packing and the manifest come out
  the same.
* **bfloat16 and fp8** leaves are stored as their raw ``uint16`` / ``uint8``
  bits, with the dtype's numpy name in the manifest.
* **Async save**: every leaf is copied to host memory when ``save`` is
  called (a later step cannot change what is written); the file writes
  run on a background thread and ``wait()`` joins.  A ``COMMIT`` marker is
  written last and the step's ``.tmp`` directory renamed after it, so a
  partly written checkpoint is never restored (crash-consistent).
* **Elastic restore**: the manifest holds logical arrays only.  Restore
  takes keys, shapes and dtypes from a template (its leaves may lie on the
  ``meta`` device) and places each leaf where ``sharding_fn(key)`` says,
  else on ``device``: a device, or the placements of a DTensor over
  ``device_mesh`` (each rank reads the logical array and keeps its part,
  so a state saved on one mesh restores onto another).
* **DTensor state** (training over a mesh of ranks): every rank gathers
  each leaf with ``full_tensor`` (a collective call), and the process of
  global rank 0 alone writes and collects old steps.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models.common import is_dtensor, resolve_device
from repro_torch.optim.optimizers import QTensor

PyTree = Any

# dtypes npz cannot store natively: persisted as raw bits + manifest dtype.
# numpy name -> (torch dtype, the stored bits' numpy dtype, an integer dtype
# of the same width in numpy and in torch to view the bits through)
_BITCAST = {
    "bfloat16": (torch.bfloat16, np.uint16, np.int16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8, torch.uint8)}
_NAME_OF = {v[0]: name for name, v in _BITCAST.items()}


def _flatten(tree: PyTree, prefix: str = "") -> dict:
    """{key: leaf} in the other package's flatten order, each key that
    package's ``keystr`` of the leaf's path."""
    out: dict = {}
    if tree is None:
        return out
    if isinstance(tree, QTensor):
        out[f"{prefix}[<flat index 0>]"] = tree.q
        out[f"{prefix}[<flat index 1>]"] = tree.scale
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(_flatten(getattr(tree, f), f"{prefix}.{f}"))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}[{k!r}]"))
    else:
        out[prefix] = tree
    return out


def _unflatten(template: PyTree, leaves) -> PyTree:
    """``leaves`` (an iterator, in ``_flatten`` order) in the structure of
    ``template``; a ``QTensor`` keeps the template's ``shape``."""
    if template is None:
        return None
    if isinstance(template, QTensor):
        return QTensor(next(leaves), next(leaves), template.shape)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory as a storable numpy array, and the
    logical dtype's numpy name."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True).contiguous()
    name = _NAME_OF.get(t.dtype)
    if name is None:
        arr = t.numpy()
        return arr, str(arr.dtype)
    _, bits, _, as_int = _BITCAST[name]
    return t.view(as_int).numpy().view(bits), name


def _is_writer() -> bool:
    """Whether this process writes checkpoints: the only process, or global
    rank 0 of a process group."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _from_storable(arr: np.ndarray, dtype: str) -> torch.Tensor:
    enc = _BITCAST.get(dtype)
    if enc is None:
        return torch.from_numpy(arr)
    tdtype, _, np_int, _ = enc
    return torch.from_numpy(arr.view(np_int)).view(tdtype)


def save_checkpoint(tree: PyTree, directory: str, step: int, *,
                    n_shards: int = 4, async_write: bool = True
                    ) -> "SaveHandle":
    """Write ``tree`` under ``directory/step_<step>``; returns a handle
    whose ``wait()`` blocks until the COMMIT marker is on disk."""
    host = {}
    dtypes = {}
    for k, v in _flatten(tree).items():           # fetch now
        host[k], dtypes[k] = _to_host(v)
    stepdir = os.path.join(directory, f"step_{step}")
    tmpdir = stepdir + ".tmp"

    def write():
        os.makedirs(tmpdir, exist_ok=True)
        # bin-pack leaves into shards by bytes (largest first)
        order = sorted(host, key=lambda k: -host[k].nbytes)
        bins: list[tuple[int, list[str]]] = [(0, []) for _ in range(n_shards)]
        for k in order:
            i = min(range(n_shards), key=lambda j: bins[j][0])
            bins[i] = (bins[i][0] + host[k].nbytes, bins[i][1] + [k])
        manifest = {}
        for i, (_, keys) in enumerate(bins):
            if not keys:
                continue
            fname = f"shard_{i}.npz"
            np.savez(os.path.join(tmpdir, fname), **{k: host[k] for k in keys})
            for k in keys:
                manifest[k] = {"shape": list(host[k].shape),
                               "dtype": dtypes[k], "shard": fname}
        with open(os.path.join(tmpdir, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        open(os.path.join(tmpdir, "COMMIT"), "w").close()
        if os.path.isdir(stepdir):
            shutil.rmtree(stepdir)
        os.rename(tmpdir, stepdir)
        handle.committed = True

    handle = SaveHandle(stepdir)
    if not _is_writer():
        handle.committed = True            # the writer's to report
        return handle
    if async_write:
        handle.start(write)
    else:
        write()
    return handle


class SaveHandle:
    def __init__(self, path: str):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.path = path
        self.committed = False

    def start(self, write: Callable[[], None]) -> None:
        def run():
            try:
                write()
            except Exception as e:    # re-raised by wait() in the caller
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise RuntimeError(f"checkpoint {self.path} did not commit"
                               ) from self._error
        # the committed dir may have been GC'd (keep-last-k) by a later
        # save; the flag records that the write itself succeeded
        if not self.committed:
            raise RuntimeError(f"checkpoint {self.path} did not commit")


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return [int(n.split("_", 1)[1]) for n in os.listdir(directory)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(directory, n, "COMMIT"))]


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(template: PyTree, directory: str,
                       step: Optional[int] = None, *,
                       sharding_fn: Optional[Callable[[str], Any]] = None,
                       device=None, device_mesh=None) -> PyTree:
    """Restore into the structure of ``template`` (keys, shapes and dtypes;
    its leaves may lie on the ``meta`` device), each leaf cast to the
    template's dtype.  ``sharding_fn(key)`` may name a device per leaf, or
    the placements (a tuple) of a DTensor over ``device_mesh``: elastic
    re-placement onto the current mesh.  A leaf it gives neither goes to
    ``device`` (None: the GPU)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    stepdir = os.path.join(directory, f"step_{step}")
    with open(os.path.join(stepdir, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]

    keys_tmpl = _flatten(template)
    missing = set(keys_tmpl) - set(manifest)
    extra = set(manifest) - set(keys_tmpl)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
    if extra:
        raise ValueError(f"checkpoint has extra leaves: {sorted(extra)[:5]}")
    default = resolve_device(device)

    out = []
    with contextlib.ExitStack() as stack:
        shards: dict[str, Any] = {}
        for key, tmpl_leaf in keys_tmpl.items():
            meta = manifest[key]
            if meta["shard"] not in shards:
                shards[meta["shard"]] = stack.enter_context(
                    np.load(os.path.join(stepdir, meta["shard"])))
            arr = shards[meta["shard"]][key]
            if tuple(arr.shape) != tuple(tmpl_leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"template {tuple(tmpl_leaf.shape)}")
            dev = sharding_fn(key) if sharding_fn is not None else None
            if isinstance(dev, (tuple, list)):
                from torch.distributed.tensor import distribute_tensor
                out.append(distribute_tensor(
                    _from_storable(arr, meta["dtype"]).to(
                        default, dtype=tmpl_leaf.dtype),
                    device_mesh, dev, src_data_rank=None))
                continue
            out.append(_from_storable(arr, meta["dtype"]).to(
                dev if dev is not None else default, dtype=tmpl_leaf.dtype))
    return _unflatten(template, iter(out))


class CheckpointManager:
    """keep-last-k rotation + convenience save/restore for TrainState."""

    def __init__(self, directory: str, keep: int = 3, n_shards: int = 4):
        self.directory = directory
        self.keep = keep
        self.n_shards = n_shards
        self._handles: list[SaveHandle] = []

    def save(self, tree: PyTree, step: int, async_write: bool = True):
        # one outstanding async save: a new snapshot waits for the previous
        # write to commit (bounds host-memory staging and avoids GC races)
        if self._handles:
            self._handles[-1].wait()
        h = save_checkpoint(tree, self.directory, step,
                            n_shards=self.n_shards, async_write=async_write)
        self._handles.append(h)
        self._gc()
        return h

    def wait_all(self):
        for h in self._handles:
            h.wait()
        self._handles.clear()
        self._gc()          # async commits may land after save-time GC

    def restore(self, template: PyTree, step: Optional[int] = None,
                sharding_fn=None, device=None, device_mesh=None) -> PyTree:
        return restore_checkpoint(template, self.directory, step,
                                  sharding_fn=sharding_fn, device=device,
                                  device_mesh=device_mesh)

    def _gc(self):
        if not _is_writer():
            return
        for s in sorted(_committed_steps(self.directory))[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
