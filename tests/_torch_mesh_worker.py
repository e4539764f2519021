"""One rank of a gloo job of the mesh tests (``_torch_ranks.run_ranks``).

    python tests/_torch_mesh_worker.py <job.json>

The job's ``cases`` run in order, each ``launch.train.train`` over a
``launch.mesh.Mesh`` of every rank of the world, on the CPU, f32 reduced
configs.  A case starts from ``params`` (an ``.npz`` of the reference's
init) or restores ``ckpt_dir``; rank 0 writes its losses and its gathered
parameters under ``out``.  Imports the port only.
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
            run_case(case, job["out"], rank, world)
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


if __name__ == "__main__":
    main(sys.argv[1])
