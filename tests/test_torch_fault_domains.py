"""Fault domains in the port (device death, slice retirement, transient
stalls; evacuation across the node and cluster tiers) against the
reference's, on the CPU.

Each reference check of ``tests/test_fault_domains.py`` on the simulator
side is made on the port's result, which is held equal (``==``) to the
reference's under the same ``FaultPlan``.  The heavy scenarios run at a
shorter horizon than the reference's own (its tests stay as they are).  The
control plane's side of device loss is in ``test_torch_ctl_daemon.py``."""
import numpy as np
import pytest

from _torch_tiers import (ENGINES, PKGS, PORT, REF, be_train, both, cluster,
                          cluster_result, device, hp_app, node, node_result,
                          sim_result)

pytestmark = pytest.mark.fault

DEV = device(PORT)


def four(pkg):
    return [hp_app(pkg, "hp0"), hp_app(pkg, "hp1", seed=1),
            be_train(pkg, "be0"), be_train(pkg, "be1", seed=1)]


def plan(pkg, *events):
    """A ``FaultPlan`` of ``(t, kind, member, extra)`` tuples."""
    return pkg.types.FaultPlan(events=tuple(
        pkg.types.FaultEvent(t=t, kind=kind, member=m, **extra)
        for t, kind, m, extra in events))


def run_node(pkg, engine="ref", faults=None, horizon=1.5):
    return pkg.lithos.evaluate(
        "lithos", node(pkg, 2), four(pkg), horizon=horizon, seed=0,
        placement=[0, 1, 0, 1], engine=engine,
        faults=None if faults is None else plan(pkg, *faults),
        node_config=pkg.types.NodeConfig(migration=True, validate=True))


def kernel_sig(res):
    return [(r.task.kid, r.task.queue_id, r.task.ordinal, r.t_submit,
             r.t_start, r.t_end, r.slices, r.freq) for r in res.records]


# -- FaultPlan / fault_schedule ----------------------------------------------

@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_fault_event_validation(pkg):
    FE = pkg.types.FaultEvent
    for kw in (dict(t=1.0, kind="meteor_strike"),
               dict(t=-1.0, kind="device_dead"),
               dict(t=1.0, kind="slice_retired"),
               dict(t=1.0, kind="transient_stall")):
        with pytest.raises(ValueError):
            FE(**kw)


def test_fault_plan_routing():
    p = plan(PORT, (2.0, "device_dead", 1, {}),
             (1.0, "slice_retired", 1, {"slice_id": 3}),
             (0.5, "transient_stall", 0, {"duration": 1e-3}))
    assert p.dead_members == (1,)
    assert [f.t for f in p.events_for(1)] == [1.0, 2.0]
    assert p.events_for(2) == ()


@pytest.mark.parametrize("profile", ["a100_like", "h100_like"])
def test_fault_schedule_equals_reference(profile):
    n = device(PORT, profile).n_slices
    for seed in (7, 8, 123):
        kw = dict(n_device_dead=1, n_slice_retired=2, n_transient=2,
                  slices_per_device=n)
        got = PORT.workloads.fault_schedule(4, 10.0, seed=seed, **kw)
        want = REF.workloads.fault_schedule(4, 10.0, seed=seed, **kw)
        assert ([(e.t, e.kind, e.member, e.slice_id, e.duration)
                 for e in got.events]
                == [(e.t, e.kind, e.member, e.slice_id, e.duration)
                    for e in want.events])
        assert len(got.events) == 5
        for f in got.events:
            if f.kind != "device_dead":
                assert f.member not in got.dead_members
            assert 2.0 <= f.t <= 8.0


# -- injection: golden + parity ----------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_no_fault_golden(engine):
    """An empty plan is bit-for-bit the no-plan run in the port, and both
    equal the reference's."""
    PORT.types.reset_kernel_ids()
    empty = run_node(PORT, engine, faults=())
    want, got = both(lambda pkg: node_result(run_node(pkg, engine)))
    assert got == want
    assert kernel_sig(empty) == [r[:1] + r[2:4] + r[4:9] for r in
                                 got["records"]]


FAULTS = ((0.9, "device_dead", 0, {}),
          (0.5, "slice_retired", 1, {"slice_id": 5}),
          (0.75, "transient_stall", 1, {"duration": 10e-3}))


def test_engine_parity_with_faults():
    runs = {}
    for pkg in (REF, PORT):
        for engine in ENGINES:
            pkg.types.reset_kernel_ids()
            runs[pkg.name, engine] = node_result(run_node(pkg, engine,
                                                          FAULTS))
    assert runs["port", "ref"] == runs["ref", "ref"]
    assert runs["port", "vec"] == runs["ref", "vec"]
    assert (runs["port", "ref"]["records"]
            == runs["port", "vec"]["records"])
    assert (runs["port", "ref"]["coordinator"]
            == runs["port", "vec"]["coordinator"])
    assert runs["port", "ref"]["coordinator"]["failed_members"] == [0]


@pytest.mark.parametrize("engine", ENGINES)
def test_transient_stall_delays_only_the_future(engine):
    t_stall = 1.0
    stall = ((t_stall, "transient_stall", 0, {"duration": 50e-3}),)
    PORT.types.reset_kernel_ids()
    base = kernel_sig(run_node(PORT, engine, horizon=2.0))
    ref_hit, hit = both(lambda pkg: run_node(pkg, engine, stall,
                                             horizon=2.0))
    assert node_result(hit) == node_result(ref_hit)
    hit = kernel_sig(hit)
    assert ([r for r in base if r[5] <= t_stall]
            == [r for r in hit if r[5] <= t_stall])
    assert base != hit
    b_end = {r[0]: r[5] for r in base}
    h_end = {r[0]: r[5] for r in hit}
    common = set(b_end) & set(h_end)
    assert all(h_end[k] >= b_end[k] - 1e-12 for k in common)
    assert any(h_end[k] > b_end[k] for k in common)


# -- slice retirement --------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_slice_retired_shrinks_live_capacity(engine):
    retire = ((0.5, "slice_retired", 0, {"slice_id": 0}),
              (0.75, "slice_retired", 0, {"slice_id": 7}))

    def go(pkg):
        return pkg.lithos.evaluate(
            "lithos", device(pkg), [hp_app(pkg), be_train(pkg)], horizon=1.5,
            seed=0, engine=engine, faults=plan(pkg, *retire))
    ref_res, res = both(go)
    assert sim_result(res) == sim_result(ref_res)
    sm = res.policy.slices
    assert sm.retired == ref_res.policy.slices.retired == {0, 7}
    assert sm.counts()["retired"] == 2
    sm.check()
    assert sum(q.slices for q in res.policy.quotas.values()) <= DEV.n_slices - 2
    assert len(res.records) > 0


@pytest.mark.parametrize("cls", ("SliceMap", "VecSliceMap"))
def test_retire_held_slice_waits_for_release(cls):
    out = []
    for pkg in (PORT, REF):
        sm = getattr(pkg.slices, cls)(8)
        sm.assign_owner(0, cid=1)
        sm.acquire([0, 1], kid=42, borrower=1, now=0.0, eta=1.0)
        steps = [sm.retire(1), sm.retire(2), sorted(sm.retired)]
        sm.release(42, 1.0)
        steps += [sorted(sm.retired), sm.counts(), list(sm.idle_pool())]
        sm.check()
        out.append(steps)
    assert out[0] == out[1]
    assert out[0][:3] == [False, True, [2]]
    assert out[0][3] == [1, 2] and out[0][4]["retired"] == 2
    assert set(out[0][5]).isdisjoint({1, 2})


# -- device death: evacuation across the hierarchy ---------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_device_dead_evacuates_all_tenants(engine):
    t_dead = 0.75
    ref_res, res = both(lambda pkg: run_node(
        pkg, engine, ((t_dead, "device_dead", 0, {}),)))
    assert node_result(res) == node_result(ref_res)
    coord = res.coordinator
    assert coord.failed_members == {0}
    assert coord.fault_log and coord.fault_log[0][1] == 0
    assert not coord.stranded
    assert all(d == 1 for d in coord.ledger.current.values())
    moved = {cid for _, cid, src, _ in coord.migration_log if src == 0}
    assert moved == {0, 2}
    for cid in moved:
        assert any(r.task.queue_id == cid and r.t_end > t_dead
                   for r in res.records)
    quotas = coord.policies[1].quotas
    assert quotas[0].slices == quotas[1].slices == DEV.n_slices // 2
    assert not coord.policies[1]._pending_reown


def test_device_dead_with_no_destination_strands():
    def go(pkg):
        return pkg.lithos.evaluate(
            "lithos", node(pkg, 1), [hp_app(pkg), be_train(pkg)],
            horizon=1.5, seed=0, placement=[0, 0],
            faults=plan(pkg, (1.0, "device_dead", 0, {})),
            node_config=pkg.types.NodeConfig(migration=True))
    ref_res, res = both(go)
    assert node_result(res) == node_result(ref_res)
    assert res.coordinator.failed_members == {0}
    assert res.coordinator.stranded == {0, 1}


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_evacuation_respects_kv_floor(pkg):
    pkg.types.reset_kernel_ids()
    coord = pkg.node.build_node(
        "lithos", node(pkg, 2), [hp_app(pkg), hp_app(pkg, "hp1", seed=1)],
        [0, 1], horizon=1.0, seed=0, engine="ref",
        node_config=pkg.types.NodeConfig(migration=True))
    m = coord.members[1]

    class _C:
        def __init__(self, kv_bytes):
            self.spec = hp_app(pkg)
            self.kv_bytes = kv_bytes

    dev = device(pkg)
    assert m.can_host(_C(0.0))
    assert pkg.workloads.kv_floor_slices(pkg.get_config("olmo-1b"), dev,
                                         1e18) == dev.n_slices
    assert m.can_host(_C(1e18))
    m.sim.n_retired = 1
    assert not m.can_host(_C(1e18))
    m.sim.n_retired = 0
    m.sim.dead = True
    assert not m.can_host(_C(0.0))


# -- fault plans on a cluster: invariants, and equality with the reference --

def _cluster_under_plan(pkg, seed, n_dead, n_ret, n_tr, horizon=2.0):
    """The reference's property scenario (``_check_cluster_under_plan``) at
    a shorter horizon: returns the result after checking its invariants."""
    pkg.types.reset_kernel_ids()
    faults = pkg.workloads.fault_schedule(
        4, horizon, seed=seed, n_device_dead=n_dead, n_slice_retired=n_ret,
        n_transient=n_tr, slices_per_device=DEV.n_slices)
    res = pkg.lithos.evaluate(
        "lithos", cluster(pkg, 2, 2), four(pkg), horizon=horizon, seed=0,
        placement=[(0, 0), (1, 0), (0, 1), (1, 1)], faults=faults,
        cluster_config=pkg.types.ClusterConfig(
            migration=True, validate=True,
            node_config=pkg.types.NodeConfig(migration=True,
                                             validate=True)))
    top = res.coordinator
    for cid, n in top.ledger.current.items():
        assert n not in top.failed_members or cid in top.stranded
    for nm in top.members:
        inner = nm.coord
        for cid, d in inner.ledger.current.items():
            assert d not in inner.failed_members or cid in inner.stranded
        for d, p in enumerate(inner.policies):
            sm = getattr(p, "slices", None)
            if sm is not None and d not in inner.failed_members:
                sm.check()
    return res


def _drawn_plans(n):
    """Plan parameters drawn from a seeded generator, standing in for the
    reference's hypothesis search over the same ranges."""
    rng = np.random.default_rng(2024)
    return [(int(rng.integers(0, 1_000_000)), int(rng.integers(0, 3)),
             int(rng.integers(0, 4)), int(rng.integers(0, 4)))
            for _ in range(n)]


@pytest.mark.parametrize("seed,n_dead,n_ret,n_tr",
                         [(0, 1, 2, 1), (1, 2, 1, 0), (2, 0, 3, 3)]
                         + _drawn_plans(3))
def test_fault_plans_on_a_cluster_equal_reference(seed, n_dead, n_ret, n_tr):
    want = cluster_result(_cluster_under_plan(REF, seed, n_dead, n_ret, n_tr))
    got = cluster_result(_cluster_under_plan(PORT, seed, n_dead, n_ret,
                                             n_tr))
    assert got == want
