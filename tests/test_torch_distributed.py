"""The port's fault-tolerance coordinator, elastic mesh math and meshes of
ranks against the JAX package's, on the CPU: the same inputs on the same
simulated clock give the same ``events`` and host states in both packages
(the ports of ``test_substrates.py``'s coordinator and elastic tests)."""
import socket

import jax
import numpy as np
import pytest
import torch

from repro.distributed.coordinator import Coordinator as JaxCoordinator
from repro.distributed.coordinator import \
    CoordinatorConfig as JaxCoordinatorConfig
from repro.distributed.elastic import elastic_mesh_shapes as jax_shapes
from repro.distributed.elastic import shrink_mesh as jax_shrink_mesh
from repro.distributed.elastic import survivors as jax_survivors
from repro_torch.distributed import (Coordinator, CoordinatorConfig,
                                     HostState, elastic_mesh_shapes,
                                     shrink_mesh, survivors)
from repro_torch.launch.mesh import (Mesh, make_mesh, make_production_mesh,
                                     single_device_mesh)


def _both(n_hosts, **cfg):
    """(port coordinator, reference coordinator, clock) on one clock."""
    clock = [0.0]
    return (Coordinator(n_hosts, CoordinatorConfig(**cfg),
                        clock=lambda: clock[0]),
            JaxCoordinator(n_hosts, JaxCoordinatorConfig(**cfg),
                           clock=lambda: clock[0]), clock)


def _states(coord) -> dict:
    return {h: s.value for h, s in coord.check().items()}


def _assert_same(port, ref):
    assert port.events == ref.events
    assert ({h.hid: h.state.value for h in port.hosts.values()}
            == {h.hid: h.state.value for h in ref.hosts.values()})
    assert port.alive() == ref.alive() and port.fleet_ok() == ref.fleet_ok()


def test_coordinator_failure_state_machine():
    port, ref, clock = _both(4, suspect_after=10, fail_after=30)
    failed = {"port": [], "ref": []}
    port.on_fail = failed["port"].extend
    ref.on_fail = failed["ref"].extend
    for t in range(0, 50, 5):
        clock[0] = float(t)
        for c in (port, ref):
            for h in (0, 1, 2):                 # host 3 goes silent
                c.heartbeat(h)
        assert _states(port) == _states(ref)
    assert port.hosts[3].state == HostState.FAILED
    assert failed["port"] == failed["ref"] == [3]
    assert sorted(port.alive()) == [0, 1, 2]
    assert [e[1] for e in port.events] == ["suspect", "failed"]
    _assert_same(port, ref)


def test_coordinator_suspect_host_recovers():
    port, ref, clock = _both(3, suspect_after=10, fail_after=30)
    for t in range(0, 40, 4):
        clock[0] = float(t)
        for c in (port, ref):
            for h in range(3):
                if not (h == 1 and 8 <= t <= 20):   # host 1 silent a while
                    c.heartbeat(h)
            c.check()
    assert [e[1] for e in port.events] == ["suspect", "recovered"]
    assert port.hosts[1].state == HostState.HEALTHY
    _assert_same(port, ref)


def test_coordinator_straggler_detection_and_recovery():
    port, ref, clock = _both(4, straggler_factor=1.5)
    flagged = {"port": [], "ref": []}
    port.on_straggler = flagged["port"].append
    ref.on_straggler = flagged["ref"].append
    for step in range(6):
        clock[0] += 1.0
        for c in (port, ref):
            for h in range(4):
                c.report_step(h, 1.0 if h != 2 else 2.5)
        assert _states(port) == _states(ref)
    assert port.hosts[2].state == HostState.STRAGGLER
    assert flagged["port"] == flagged["ref"] == [2]
    for step in range(8):                   # host 2 recovers
        clock[0] += 1.0
        for c in (port, ref):
            for h in range(4):
                c.report_step(h, 1.0)
        assert _states(port) == _states(ref)
    assert port.hosts[2].state == HostState.HEALTHY
    assert [e[1] for e in port.events] == ["straggler", "destraggled"]
    _assert_same(port, ref)


def test_coordinator_fleet_ok_counts_the_living():
    port, ref, clock = _both(2, suspect_after=1, fail_after=2, min_hosts=2)
    clock[0] = 5.0
    for c in (port, ref):
        c.heartbeat(0)
    assert _states(port) == _states(ref)
    assert not port.fleet_ok()
    _assert_same(port, ref)


def test_elastic_mesh_shapes():
    assert elastic_mesh_shapes(256, 16) == (16, 16)
    assert elastic_mesh_shapes(240, 16) == (15, 16)     # lost one host row
    assert elastic_mesh_shapes(8, 16) is None           # no full replica
    assert elastic_mesh_shapes(512, 16, pods=2) == (2, 16, 16)
    ranks = list(range(32))
    surv = survivors(ranks, failed_hosts=[1], devices_per_host=8)
    assert len(surv) == 24 and 8 not in surv


@pytest.mark.parametrize("pods", [1, 2, 4])
def test_elastic_mesh_shapes_match_reference(pods):
    for n in range(0, 520, 7):
        for mp in (1, 2, 4, 8, 16):
            assert (elastic_mesh_shapes(n, mp, pods)
                    == jax_shapes(n, mp, pods)), (n, mp, pods)


@pytest.mark.parametrize("failed,dph", [([6, 7], 1), ([1], 8), ([0, 3], 2),
                                        ([], 4)])
def test_survivors_and_shrink_mesh_on_rank_lists(failed, dph):
    ranks = list(range(16))
    surv = survivors(ranks, failed_hosts=failed, devices_per_host=dph)
    assert surv == jax_survivors(ranks, failed, dph)
    for mp in (1, 2, 4):
        mesh = shrink_mesh(surv, mp)
        data = len(surv) // mp
        assert mesh.shape == {"data": data, "model": mp}
        assert mesh.shape == dict(zip(("data", "model"),
                                      elastic_mesh_shapes(len(surv), mp)))
        assert mesh.ranks.tolist() == np.array(
            surv[:data * mp]).reshape(data, mp).tolist()
    assert shrink_mesh(surv[:1], 2) is None


def test_shrink_mesh_of_one_matches_reference():
    """On the one device here the reference builds a real mesh: the same
    shape and axes as the port's mesh of ranks."""
    ref = jax_shrink_mesh(jax.devices(), model_parallel=1)
    port = shrink_mesh([0], model_parallel=1)
    assert dict(ref.shape) == port.shape and ref.axis_names == port.axis_names
    assert jax_shrink_mesh(jax.devices(), 2) is None


def test_meshes_of_ranks():
    m = make_mesh((4, 2), ("data", "model"))
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert m.ranks.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert single_device_mesh().shape == {"data": 1, "model": 1}
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    big = make_production_mesh(multi_pod=True)
    assert big.shape == {"pod": 2, "data": 16, "model": 16}
    assert big.axis_names == ("pod", "data", "model") and big.size == 512
    with pytest.raises(ValueError, match="cannot take"):
        Mesh(np.arange(4), ("data", "model"))


def test_device_mesh_needs_a_process_group_holding_the_ranks():
    m = single_device_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        m.device_mesh("cpu")
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        dm = m.device_mesh("cpu")
        assert dm.mesh_dim_names == ("data", "model")
        assert dm.mesh.tolist() == [[0]]
        with pytest.raises(RuntimeError, match="outside the world"):
            make_mesh((2, 1), ("data", "model")).device_mesh("cpu")
    finally:
        dist.destroy_process_group()
    assert not torch.cuda.is_available()
