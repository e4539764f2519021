"""One rank of a gloo job of the mesh tests (``_torch_ranks.run_ranks``).

    python tests/_torch_mesh_worker.py <job.json>

The job's ``cases`` run in order, each ``launch.train.train`` over a
``launch.mesh.Mesh`` of every rank of the world, on the CPU, f32 reduced
configs.  A case starts from ``params`` (an ``.npz`` of the reference's
init) or restores ``ckpt_dir``; rank 0 writes its losses and its gathered
parameters under ``out``.  A case of ``kind`` "decode" serves instead: the
prompt's prefill on each rank alone, then ``steps`` greedy
``models/registry.serve_decode`` steps over the mesh with the parameters
and caches laid out by ``launch/shardings``; rank 0 writes the logits, the
tokens, each step's collectives (``roofline/comm.CommRecorder``) and the
bytes of one layer's local cache (``ruleset`` names the parameters'
sharding rules, default ``launch/shardings.default_ruleset``).  Imports the port only.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_ranks import load_params, save_tree  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.common import tree_paths  # noqa: E402
from repro_torch.train.step import TrainConfig  # noqa: E402


def main(path: str) -> None:
    with open(path) as f:
        job = json.load(f)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    try:
        for case in job["cases"]:
            run = run_decode_case if case.get("kind") == "decode" else run_case
            run(case, job["out"], rank, world)
    finally:
        dist.destroy_process_group()


def run_case(case: dict, out: str, rank: int, world: int) -> None:
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              dtype="float32")
    mesh = Mesh(np.arange(world).reshape(case["mesh"]), case["axes"])
    params = (load_params(case["params"], cfg) if case.get("params")
              else None)
    state, losses = train(
        cfg, steps=case["steps"], batch=case["batch"], seq=case["seq"],
        tc=TrainConfig(**case["tc"]), mesh=mesh, seed=case.get("seed", 0),
        params=params, ckpt_dir=case.get("ckpt_dir"),
        ckpt_every=case.get("ckpt_every", 50), device="cpu", verbose=False)
    full = [(p, x.full_tensor().numpy()) for p, x in tree_paths(state.params)]
    kinds = sorted({type(x).__name__ for _, x in tree_paths(state.params)})
    if rank == 0:
        name = case["name"]
        save_tree(os.path.join(out, f"{name}.npz"), full)
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump({"losses": losses, "leaf_types": kinds}, f)


def run_decode_case(case: dict, out: str, rank: int, world: int) -> None:
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import shardings as sh
    from repro_torch.models import registry
    from repro_torch.models.sharding import placements, use_mesh
    from repro_torch.roofline.comm import CommRecorder
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              dtype="float32", **case.get("fields", {}))
    mesh = Mesh(np.arange(world).reshape(case["mesh"]), case["axes"])
    params = load_params(case["params"], cfg)
    tokens = torch.tensor(case["tokens"])
    B, S = tokens.shape
    logits, caches = registry.serve_prefill(params, cfg, {"tokens": tokens},
                                            max_len=case["max_len"])

    def laid_out(tree, shardings):
        # every rank holds the whole tree: each takes its own blocks
        if isinstance(tree, dict):
            return {k: laid_out(v, shardings[k]) for k, v in tree.items()}
        return distribute_tensor(tree, mesh.device_mesh("cpu"),
                                 placements(shardings.spec, mesh),
                                 src_data_rank=None)

    rec = {"logits": [], "tokens": [], "collectives": []}
    with use_mesh(mesh, "cpu"), implicit_replication():
        params = laid_out(params, sh.params_shardings(
            params, cfg, mesh, case.get("ruleset")))
        caches = laid_out(caches, sh.cache_shardings(caches, cfg, mesh, B))
        # the largest layer's local cache (a stacked group's leaves hold
        # one layer a leading index)
        def layer_bytes(blk, n):
            return sum(t.to_local().nbytes for t in blk.values()) // n
        per_layer = ([layer_bytes(b, next(iter(b.values())).shape[0])
                      for b in caches["groups"].values()]
                     + [layer_bytes(b, 1) for b in caches["rem"].values()])
        rec["layer_cache_bytes"] = max(per_layer)
        tok = logits.argmax(-1)
        for step in range(case["steps"]):
            tok_d = laid_out(tok, sh.batch_shardings({"t": tok}, mesh)["t"])
            with CommRecorder() as comm:
                logits, caches = registry.serve_decode(params, cfg, tok_d,
                                                       S + step, caches)
            logits = logits.full_tensor()
            tok = logits.argmax(-1)
            rec["logits"].append(logits.tolist())
            rec["tokens"].append(tok.tolist())
            rec["collectives"].append([[op.kind, op.result_bytes,
                                        op.group_size]
                                       for op in comm.collectives])
    if rank == 0:
        with open(os.path.join(out, f"{case['name']}.json"), "w") as f:
            json.dump(rec, f)


if __name__ == "__main__":
    main(sys.argv[1])
