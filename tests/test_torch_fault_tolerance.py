"""Fault-tolerance integration on one process: train -> fail hosts ->
elastic re-mesh -> restore from checkpoint -> resume, the port's
``tests/test_fault_tolerance.py``.

The reference's test runs on 8 logical XLA devices in a subprocess; here
both packages run on the one CPU device, and the meshes are the port's
meshes of ranks: each phase resolves the whole train state's shardings on
its mesh (4 x 2, then the survivors' 3 x 2, against the reference's rules on
an ``AbstractMesh`` of the same shape) and steps on the CPU.  Parameters
cross by conversion; every loss of the port's run is held to the same run of
the reference to 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding

from _torch_port import make_pair
from repro.checkpoint.sharded import CheckpointManager as JaxManager
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch import shardings as jax_sh
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.sharded import _flatten
from repro_torch.convert import from_jax_train_state
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import (Coordinator, CoordinatorConfig,
                                     shrink_mesh, survivors)
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import state_template, to_device
from repro_torch.train.step import TrainConfig, make_train_step

LOSS = dict(rtol=1e-5, atol=1e-6)


def _specs_match(state_shapes, jstate_shapes, tcfg, jcfg, mesh):
    got = {k: tuple(s.spec) for k, s in _flatten(
        sh.train_state_shardings(state_shapes, tcfg, mesh)).items()}
    jmesh = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
    want = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jax_sh.train_state_shardings(jstate_shapes, jcfg, jmesh),
                is_leaf=lambda x: isinstance(x, JaxNamedSharding))[0]}
    assert got == want
    assert set(got) == set(_flatten(state_shapes))


def test_failure_recovery_elastic_resume(tmp_path):
    jcfg, _, tcfg, _ = make_pair("olmo-1b")
    kw = dict(total_steps=20, warmup_steps=2)
    jinit, jstep = jax_make_train_step(jcfg, JaxTrainConfig(**kw))
    jstep = jax.jit(jstep)
    tinit, tstep = make_train_step(tcfg, TrainConfig(**kw), device="cpu")
    jshapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    template = state_template(tcfg, TrainConfig(**kw))

    def data(batch, seed):
        dk = dict(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=batch,
                  seed=seed)
        return (JaxSyntheticLM(JaxDataConfig(**dk)).batches(),
                SyntheticLM(DataConfig(**dk)).batches())

    def run_steps(mesh, jstate, tstate, streams, n):
        _specs_match(template, jshapes, tcfg, jcfg, mesh)
        jl, tl = [], []
        for _ in range(n):
            jb, tb = next(streams[0]), next(streams[1])
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in jb.items()})
            tstate, tm = tstep(tstate, to_device(tb, "cpu"))
            jl.append(float(jm["loss"]))
            tl.append(float(tm["loss"]))
        return jstate, tstate, jl, tl

    # phase 1: 4 data x 2 model mesh (8 "hosts" of 1 rank each)
    ranks = list(range(8))
    mesh1 = Mesh(np.array(ranks).reshape(4, 2), ("data", "model"))
    jstate = jinit(jax.random.PRNGKey(0))
    tstate = from_jax_train_state(jstate, device="cpu")
    jstate, tstate, jl1, tl1 = run_steps(mesh1, jstate, tstate,
                                         data(8, 0), 4)
    mgr, jmgr = CheckpointManager(str(tmp_path / "port")), JaxManager(
        str(tmp_path / "ref"))
    mgr.save(tstate, step=4, async_write=False)
    jmgr.save(jstate, step=4, async_write=False)

    # phase 2: hosts 6,7 fail -> coordinator detects -> shrink to 3x2
    clock = [0.0]
    coord = Coordinator(8, CoordinatorConfig(suspect_after=5, fail_after=10),
                        clock=lambda: clock[0])
    for t in range(0, 16, 2):
        clock[0] = float(t)
        for h in range(6):
            coord.heartbeat(h)
        coord.check()
    assert sorted(coord.alive()) == [0, 1, 2, 3, 4, 5], coord.alive()
    assert [e[1:] for e in coord.events] == [
        ("suspect", 6), ("suspect", 7), ("failed", 6), ("failed", 7)]

    surv = survivors(ranks, failed_hosts=[6, 7], devices_per_host=1)
    mesh2 = shrink_mesh(surv, model_parallel=2)
    assert mesh2.shape == {"data": 3, "model": 2}, mesh2.shape
    assert mesh2.ranks.tolist() == [[0, 1], [2, 3], [4, 5]]

    # phase 3: restore the 4x2 checkpoint onto the 3x2 mesh and resume
    restored = mgr.restore(template, device="cpu")
    jrestored = jmgr.restore(jshapes)
    assert int(restored.opt.step) == int(np.asarray(jrestored.opt.step)) == 4
    _, _, jl2, tl2 = run_steps(mesh2, jrestored, restored, data(6, 1), 3)
    assert all(np.isfinite(tl2))
    np.testing.assert_allclose(tl1 + tl2, jl1 + jl2, **LOSS)
