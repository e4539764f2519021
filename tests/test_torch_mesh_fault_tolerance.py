"""Fault-tolerance over real ranks: the JAX package's
``tests/test_fault_tolerance.py`` (train on a 4 x 2 mesh -> hosts 6 and 7
fail -> elastic re-mesh to 3 x 2 -> restore -> resume), with the port's
``launch.train.train`` in gloo processes, one rank each.

Phase 1 runs 8 ranks on the 4 x 2 mesh and checkpoints at step 4 (every
rank gathers, rank 0 writes).  The coordinator and the elastic mesh math
find the survivors' 3 x 2 mesh, and phase 3 runs 6 ranks on it: the 4 x 2
checkpoint restores through ``sharding_fn`` onto the new mesh and 3 more
steps run on another data stream.  The reference's own script runs beside
it in a subprocess on 8 logical XLA devices, with two edits: f32 (the
port's runs are held to 1e-5 relative, which bf16 on two CPU stacks does
not give) and its two losses printed in full.  Its last loss of each phase
is the port's, to 1e-5 relative.
"""
import dataclasses
import json
import re
import subprocess
import sys

import jax
import numpy as np

from _torch_ranks import SRC, rank_env, run_ranks, save_tree
from repro.configs.registry import get_config as jax_get_config
from repro.models.registry import init_model as jax_init_model
from repro_torch.distributed import (Coordinator, CoordinatorConfig,
                                     shrink_mesh, survivors)
import test_fault_tolerance as reference_test

LOSS = dict(rtol=1e-5, atol=1e-6)
TC = dict(total_steps=20, warmup_steps=2)


def _reference_script() -> str:
    """The reference test's script in f32, printing its losses in full."""
    edits = [('cfg = get_config("olmo-1b").reduced()',
              'cfg = dataclasses.replace(get_config("olmo-1b").reduced(), '
              'dtype="float32")'),
             ("import sys\n", "import sys, dataclasses\n"),
             ("loss1={loss1:.4f} loss2={loss2:.4f}",
              "loss1={loss1!r} loss2={loss2!r}")]
    script = reference_test.SCRIPT
    for old, new in edits:
        assert script.count(old) == 1, old
        script = script.replace(old, new)
    return script


def test_remesh_4x2_to_3x2_restores_and_resumes_over_gloo_ranks(tmp_path):
    ref = subprocess.Popen(
        [sys.executable, "-c", _reference_script(), str(tmp_path / "ref")],
        env=rank_env(PYTHONPATH=SRC), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    cfg = dataclasses.replace(jax_get_config("olmo-1b").reduced(),
                              dtype="float32")
    init = str(tmp_path / "init.npz")
    save_tree(init, [(jax.tree_util.keystr(p, simple=True, separator="/"), x)
                     for p, x in jax.tree_util.tree_flatten_with_path(
                         jax_init_model(cfg, jax.random.PRNGKey(0)))[0]])
    ckpt = str(tmp_path / "ckpt")
    case = dict(arch="olmo-1b", axes=["data", "model"], seq=32, tc=TC,
                ckpt_dir=ckpt)

    # phase 1: 4 data x 2 model, 8 ranks, checkpoint at step 4
    run_ranks(8, {"out": str(tmp_path), "cases": [dict(
        case, name="phase1", mesh=[4, 2], steps=4, batch=8, seed=0,
        params=init, ckpt_every=4)]}, str(tmp_path / "job1.json"))

    # phase 2: hosts 6, 7 fail -> the coordinator finds them -> 3 x 2
    clock = [0.0]
    coord = Coordinator(8, CoordinatorConfig(suspect_after=5, fail_after=10),
                        clock=lambda: clock[0])
    for t in range(0, 16, 2):
        clock[0] = float(t)
        for h in range(6):
            coord.heartbeat(h)
        coord.check()
    assert sorted(coord.alive()) == [0, 1, 2, 3, 4, 5]
    mesh2 = shrink_mesh(survivors(list(range(8)), failed_hosts=[6, 7],
                                  devices_per_host=1), model_parallel=2)
    assert mesh2.shape == {"data": 3, "model": 2}

    # phase 3: the survivors restart as 6 ranks on 3 x 2 and resume from
    # the 4 x 2 checkpoint on another data stream
    run_ranks(6, {"out": str(tmp_path), "cases": [dict(
        case, name="phase3", mesh=list(mesh2.ranks.shape), steps=7,
        batch=6, seed=1)]}, str(tmp_path / "job3.json"))

    runs = {}
    for name in ("phase1", "phase3"):
        with open(tmp_path / f"{name}.json") as f:
            runs[name] = json.load(f)
        assert runs[name]["leaf_types"] == ["DTensor"]
    assert len(runs["phase1"]["losses"]) == 4
    assert len(runs["phase3"]["losses"]) == 3      # steps 4, 5, 6

    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    m = re.search(r"RECOVERY_OK loss1=(\S+) loss2=(\S+)", out)
    assert m, out[-2000:]
    np.testing.assert_allclose(
        [runs["phase1"]["losses"][-1], runs["phase3"]["losses"][-1]],
        [float(m.group(1)), float(m.group(2))], **LOSS)
