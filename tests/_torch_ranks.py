"""Runs a job in N processes joined by one gloo process group (one rank
each), for the tests of the port's execution over a mesh of ranks.

``run_ranks(n, job)`` writes ``job`` (a dict) to a JSON file, starts
``_torch_mesh_worker.py`` once per rank with ``RANK``, ``WORLD_SIZE`` and
``MASTER_PORT`` (a free port on localhost) and ``OMP_NUM_THREADS=1``, and
returns when every rank has exited 0.  The worker writes its results under
``job["out"]``.  Parameter trees cross as ``.npz`` files keyed by their
``tree_paths``.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORKER = os.path.join(HERE, "_torch_mesh_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def start_ranks(n: int, job: dict, path: str) -> list:
    """The ``n`` worker processes of ``job`` (written to ``path``)."""
    with open(path, "w") as f:
        json.dump(job, f)
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, WORKER, path],
        env=rank_env(RANK=r, WORLD_SIZE=n, MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]


def wait_ranks(procs: list, timeout: float = 240) -> list[str]:
    """Every rank's standard output; raises if one fails or times out (and
    then stops them all)."""
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                     f"{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_ranks(n: int, job: dict, path: str, timeout: float = 240):
    return wait_ranks(start_ranks(n, job, path), timeout)


def save_tree(path: str, paths_and_leaves) -> None:
    """(path, numpy leaf) pairs -> ``.npz``."""
    np.savez(path, **{p: np.asarray(x) for p, x in paths_and_leaves})


def load_params(path: str, cfg):
    """``.npz`` of ``save_tree`` -> the port's parameter tree of ``cfg`` (on
    the CPU; its nesting, empty dicts included, from a ``meta`` init)."""
    import torch
    from repro_torch.models.common import tree_paths, tree_unflatten
    from repro_torch.models.registry import init_model
    like = init_model(cfg, device="meta")
    with np.load(path) as z:
        return tree_unflatten(like, [torch.from_numpy(z[p].copy())
                                     for p, _ in tree_paths(like)])
