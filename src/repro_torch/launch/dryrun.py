"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on ``meta``
tensors over a fake process group of 256 (``pod16x16``) or 512
(``pod2x16x16``) ranks.

The JAX package lowers and compiles each cell for its production mesh.
The port's counterpart runs the cell's step once, as this process's rank
(rank 0) of the fake group: the state is DTensors on ``meta`` at
``launch/shardings.py``'s placements, so nothing is allocated, and every
op goes through DTensor's sharding rules, which issue the collectives a
real mesh would.  The step is the full production step function:
``train_step`` (train shapes), ``serve_prefill`` (prefill shapes) or
``serve_decode`` (decode shapes), at the configs' full widths.  Recorded
per cell:

  * memory: the per-device bytes of the arguments (state and inputs), of
    the outputs, and the peak of what the step allocates (``temp``, its
    outputs included, which XLA's temp excludes);
  * cost: FLOPs and bytes per device (``roofline/cost.py``), the
    hand-written kernels charged with their own work;
  * collective bytes per device by kind (``roofline/comm.py``);
  * op counts, and the trace's wall time (``t_lower_s``; nothing is
    compiled, so ``t_compile_s`` is null).

Results are JSON under ``reports/dryrun_torch/<mesh>/`` (the reference's
``reports/dryrun/`` is its own).  No GPU is needed: nothing executes.  One
process holds one default process group, so a program that has one (or
needs another world size) runs the dry-run in a subprocess.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.configs.registry import (ALL_SHAPES, ARCH_IDS, get_config,
                                          get_shape)
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.train import place_state
from repro_torch.models import transformer
from repro_torch.models.registry import init_model, serve_decode, serve_prefill
from repro_torch.models.sharding import data_axes, placements, use_mesh
from repro_torch.roofline.analysis import derive_terms
from repro_torch.roofline.comm import CommRecorder, collective_bytes, count_ops
from repro_torch.roofline.cost import CostCounter
from repro_torch.train.step import TrainConfig, make_train_step

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")
DEVICE_TYPE = "cpu"       # the fake group's mesh device; tensors on meta


def _n_micro(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Microbatch so ~2 batch rows are live per device per microstep (4 for
    the configs above 100 B params); ``REPRO_NMICRO`` overrides, as in the
    reference."""
    if os.environ.get("REPRO_NMICRO"):
        return int(os.environ["REPRO_NMICRO"])
    dp = 1
    for a in data_axes(mesh):
        dp *= mesh.shape[a]
    rows_per_dev = max(1, shape.global_batch // dp)
    divisor = 4 if cfg.param_count() > 100e9 else 2
    return int(min(16, max(1, rows_per_dev // divisor)))


def init_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (a
    second call with the same size is a no-op)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"this process already holds a group of "
                               f"{dist.get_world_size()} ranks; a dry-run "
                               f"of {world} needs a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _distribute(tree, shardings, mesh):
    """Each leaf of a nested dict as a DTensor at its sharding's placements
    (``meta`` leaves stay on ``meta``)."""
    from torch.distributed.tensor import distribute_tensor
    dm = mesh.device_mesh(DEVICE_TYPE)
    if isinstance(tree, dict):
        return {k: _distribute(v, shardings[k], mesh)
                for k, v in tree.items()}
    return distribute_tensor(tree, dm, placements(shardings.spec, mesh),
                             src_data_rank=None)


def _inputs(cfg, shape, mesh, labels: bool):
    batch = make_batch_specs(cfg, shape, dtype=torch.int64)
    if not labels:
        batch.pop("labels", None)
    return _distribute(batch, sh.batch_shardings(batch, mesh), mesh)


def build_train(cfg: ArchConfig, shape: ShapeConfig, mesh, tc=None):
    tc = tc or TrainConfig(remat="dots", n_micro=_n_micro(cfg, shape, mesh),
                           moment_dtype=cfg.moment_dtype, loss_chunk=512)
    init_state, train_step = make_train_step(cfg, tc, device="meta")
    template = init_state(seed=0)
    state = place_state(template, cfg, mesh, template, DEVICE_TYPE)
    batch = _inputs(cfg, shape, mesh, labels=True)
    return (lambda: train_step(state, batch)), (state, batch)


def _params(cfg, mesh):
    params = init_model(cfg, device="meta")
    return _distribute(params, sh.params_shardings(params, cfg, mesh), mesh)


def _caches(cfg, mesh, B: int, S: int):
    caches = transformer.init_caches(cfg, B, S, device="meta")
    return _distribute(caches, sh.cache_shardings(caches, cfg, mesh, B),
                       mesh)


def build_prefill(cfg: ArchConfig, shape: ShapeConfig, mesh, tc=None):
    S, B = cfg.effective_seq(shape), shape.global_batch
    params = _params(cfg, mesh)
    batch = _inputs(cfg, shape, mesh, labels=False)
    if cfg.is_encoder_decoder:
        # the enc-dec prefill builds its own caches
        return (lambda: serve_prefill(params, cfg, batch, max_len=S)), (
            params, batch)
    caches = _caches(cfg, mesh, B, S)
    return (lambda: serve_prefill(params, cfg, batch, max_len=S,
                                  caches=caches)), (params, batch, caches)


def build_decode(cfg: ArchConfig, shape: ShapeConfig, mesh, tc=None):
    S, B = cfg.effective_seq(shape), shape.global_batch
    params = _params(cfg, mesh)
    tok = torch.empty((B,), dtype=torch.int64, device="meta")
    tok = _distribute(tok, sh.batch_shardings({"t": tok}, mesh)["t"], mesh)
    if cfg.is_encoder_decoder:
        from repro_torch.models import encdec
        frames = make_batch_specs(cfg, shape)["frames"]
        frames = _distribute(frames, sh.batch_shardings(
            {"f": frames}, mesh)["f"], mesh)
        enc = encdec.encode(params, cfg, frames)
        caches = encdec.init_dec_caches(params, cfg, enc, B, S)
    else:
        caches = _caches(cfg, mesh, B, S)
    pos = S - 1                       # the step at the end of the context
    return (lambda: serve_decode(params, cfg, tok, pos, caches)), (
        params, tok, caches)


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor leaf in ``tree``."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    from repro_torch.optim.optimizers import QTensor
    total = 0
    for t in tree_leaves(tree):
        for x in ((t.q, t.scale) if isinstance(t, QTensor) else (t,)):
            if isinstance(x, DTensor):
                x = x.to_local()
            if isinstance(x, torch.Tensor):
                total += x.numel() * x.element_size()
    return total


def mesh_for(name: str):
    """The production meshes by name, and ``d<D>m<M>`` for a (D, M) mesh
    of data x model ranks (small meshes for the tests)."""
    if name == "pod16x16":
        return make_production_mesh(multi_pod=False)
    if name == "pod2x16x16":
        return make_production_mesh(multi_pod=True)
    d, m = name[1:].split("m")
    return make_mesh((int(d), int(m)), ("data", "model"))


_MESHES: dict = {}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             cfg: ArchConfig | None = None, mesh_name: str | None = None,
             shape: ShapeConfig | None = None,
             tc: TrainConfig | None = None) -> dict:
    """One cell's record.  ``cfg``, ``mesh_name``, ``shape`` and ``tc``
    override the registry's config, the production mesh, the named shape
    and a train cell's ``TrainConfig`` (the tests run reduced configs on
    small meshes; a measured run's own shape goes through it too)."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    mesh_name = mesh_name or ("pod2x16x16" if multi_pod else "pod16x16")
    ok, reason = cfg.shape_applicable(shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    if mesh_name not in _MESHES:
        _MESHES[mesh_name] = mesh_for(mesh_name)
    mesh = _MESHES[mesh_name]
    chips = mesh.size
    init_fake_group(chips)
    from torch.distributed.tensor.experimental import implicit_replication

    with use_mesh(mesh, DEVICE_TYPE), implicit_replication():
        fn, args = BUILDERS[shape.kind](cfg, shape, mesh, tc)
        arg_bytes = _local_bytes(args)
        with CommRecorder() as comm, CostCounter() as cost:
            t0 = time.time()
            out = fn()
            t_lower = time.time() - t0
        out_bytes = _local_bytes(out)
        del out

    coll = collective_bytes(comm.collectives)
    coll.setdefault("total", 0.0)
    dots = sum(n for op, n in cost.ops.items()
               if op in ("mm", "bmm", "addmm", "baddbmm", "_scaled_mm"))
    terms = derive_terms(cfg, shape, mesh_name, chips,
                         hlo_flops=cost.flops * chips,
                         hlo_bytes=cost.bytes * chips,
                         collective_bytes_per_chip=coll["total"])
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": chips, "kind": shape.kind,
        "t_lower_s": round(t_lower, 2), "t_compile_s": None,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": cost.peak, "code_bytes": None},
        "cost": {"flops_per_device": cost.flops,
                 "dot_flops_per_device": cost.dot_flops,
                 "bytes_per_device": cost.bytes,
                 "xla_flops_per_device": None,
                 "xla_bytes_per_device": None,
                 "kernel_calls": dict(cost.kernels)},
        "collectives": coll,
        "hlo_ops": count_ops(comm.collectives, dots=dots,
                             kernels=sum(cost.kernels.values())),
        "roofline": terms.row(),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }


def cell_path(arch: str, shape_name: str, multi_pod: bool) -> str:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    os.makedirs(os.path.join(REPORT_DIR, mesh_name), exist_ok=True)
    return os.path.join(REPORT_DIR, mesh_name, f"{arch}__{shape_name}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = ([(args.arch, args.shape)] if not args.all else
             [(a, s.name) for a in ARCH_IDS for s in ALL_SHAPES])
    failures = 0
    for arch, shape_name in cells:
        path = cell_path(arch, shape_name, args.multi_pod)
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                prev = json.load(f)
            if prev.get("status") in ("ok", "skipped"):
                print(f"[cached] {arch} x {shape_name}")
                continue
        print(f"[dryrun] {arch} x {shape_name} "
              f"({'multi' if args.multi_pod else 'single'}-pod) ...",
              flush=True)
        try:
            res = run_cell(arch, shape_name, args.multi_pod)
        except Exception as e:                         # noqa: BLE001
            res = {"arch": arch, "shape": shape_name, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-3000:]}
            failures += 1
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        status = res["status"]
        extra = ""
        if status == "ok":
            r = res["roofline"]
            extra = (f" dom={r['dominant']}"
                     f" frac={r['roofline_fraction']:.3f}"
                     f" lower={res['t_lower_s']}s")
        elif status == "error":
            extra = " " + res["error"][:120]
        print(f"  -> {status}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
