"""The port's cluster tier (``repro_torch.core.cluster``) against the
reference's, on the CPU: ``evaluate`` over a ``ClusterSpec`` under both
engines, on ``a100_like`` and on ``h100_like``'s values, every
``ClusterResult`` field equal (``==``): records, clients, energy, both
tiers' ledgers and migration logs, the fragmentation series and the power
log.

Each reference check of ``tests/test_cluster.py`` is made on the port's
result, which is held equal to the reference's.  Horizons are shorter than
the reference's own (its tests stay as they are)."""
import pytest

from _torch_tiers import (ENGINES, PORT, PROFILES, REF, be_train, both,
                          cluster, cluster_result, device, hp_app, node,
                          node_result)


def steal_node(pkg):
    return pkg.types.NodeConfig(migration=True, epoch=0.1,
                                migration_cost=0.02, cooldown=5.0,
                                validate=True)


def steal_cluster(pkg, **kw):
    return pkg.types.ClusterConfig(migration=True, epoch=0.2,
                                   migration_cost=0.05, cooldown=5.0,
                                   hp_depth_hi=2, validate=True, **kw)


def saturated_apps(pkg):
    return [hp_app(pkg, "hp0", rps=40.0), hp_app(pkg, "hp1", rps=30.0),
            be_train(pkg, "be0"), be_train(pkg, "be1", arch="olmo-1b")]


SATURATED = [(0, 0), (0, 1), (0, 0), (0, 1)]


def run_saturated(pkg, *, profile="a100_like", horizon=2.0, engine="ref",
                  **kw):
    """Every tenant pinned on node 0 of two, node 1 idle."""
    return pkg.cluster.evaluate_cluster(
        "lithos", cluster(pkg, 2, 2, profile), saturated_apps(pkg),
        horizon=horizon, seed=7, placement=SATURATED, engine=engine, **kw)


# -- 1-node parity (the reference's contract, one level up) ------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("system", ["lithos", "mps"])
def test_one_node_cluster_is_the_node(engine, system):
    def apps(pkg):
        return [hp_app(pkg), hp_app(pkg, "hp2", rps=10.0), be_train(pkg)]

    def go(pkg):
        pkg.types.reset_kernel_ids()
        a = pkg.node.evaluate_node(system, node(pkg, 2), apps(pkg),
                                   horizon=1.0, seed=3, engine=engine)
        pkg.types.reset_kernel_ids()
        b = pkg.cluster.evaluate_cluster(
            system, pkg.types.ClusterSpec(nodes=(node(pkg, 2),)), apps(pkg),
            horizon=1.0, seed=3, router="least_loaded", engine=engine)
        return a, b
    (ra, rb), (pa, pb) = go(REF), go(PORT)
    assert cluster_result(pb) == cluster_result(rb)
    assert node_result(pa) == node_result(ra)
    assert pa.records == pb.records and pa.energy == pb.energy
    assert pa.busy_slice_seconds == pb.busy_slice_seconds
    assert ([(c.name, c.cid, c.latencies) for c in pa.clients]
            == [(c.name, c.cid, c.latencies) for c in pb.clients])
    assert pb.placement == [(0, d) for d in pa.placement]


@pytest.mark.parametrize("engine", ENGINES)
def test_one_node_cluster_with_intra_node_stealing(engine):
    def apps(pkg):
        return [hp_app(pkg, "hp0", rps=40.0), be_train(pkg, "be0"),
                be_train(pkg, "be1", arch="olmo-1b")]

    def go(pkg):
        pkg.types.reset_kernel_ids()
        a = pkg.node.evaluate_node(
            "lithos", node(pkg, 2), apps(pkg), horizon=1.0, seed=7,
            node_config=steal_node(pkg), placement=[0, 0, 0], engine=engine)
        pkg.types.reset_kernel_ids()
        b = pkg.cluster.evaluate_cluster(
            "lithos", pkg.types.ClusterSpec(nodes=(node(pkg, 2),)),
            apps(pkg), horizon=1.0, seed=7,
            cluster_config=pkg.types.ClusterConfig(
                node_config=steal_node(pkg)),
            placement=[(0, 0)] * 3, engine=engine)
        return node_result(a), cluster_result(b)
    want, got = go(REF), go(PORT)
    assert got == want
    node_sig, cluster_sig = got
    assert node_sig["records"] == cluster_sig["records"]
    assert node_sig["migrations"] == cluster_sig["per_node"][0]["migrations"]


@pytest.mark.parametrize("profile", PROFILES)
def test_cluster_through_evaluate_equals_reference(profile):
    """``evaluate``'s cluster arm, each cluster router, and its refusals."""
    def apps(pkg):
        return [hp_app(pkg), be_train(pkg), hp_app(pkg, "hp2", rps=10.0)]
    for router in PORT.cluster.CLUSTER_ROUTERS:
        want, got = both(lambda pkg: cluster_result(pkg.lithos.evaluate(
            "lithos", pkg.types.ClusterSpec.uniform(
                2, node(pkg, 1, profile)), apps(pkg), horizon=0.4, seed=0,
            router=router)))
        assert got == want
    cl = PORT.types.ClusterSpec.uniform(2, node(PORT, 1, profile))
    res = PORT.lithos.evaluate("lithos", cl, apps(PORT), horizon=0.4, seed=0,
                               router="round_robin")
    assert res.cluster is cl and len(res.clients) == 3
    assert res.client("hp").n_completed > 0
    with pytest.raises(ValueError):
        PORT.lithos.evaluate("lithos", device(PORT, profile), apps(PORT),
                             horizon=0.4,
                             cluster_config=PORT.types.ClusterConfig())
    with pytest.raises(ValueError):
        PORT.lithos.evaluate("lithos", cl, apps(PORT), horizon=0.4,
                             node_config=PORT.types.NodeConfig())


# -- cross-node stealing + cluster-wide conservation -------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_cross_node_stealing_equals_reference_and_conserves(engine):
    ref_res, res = both(lambda pkg: run_saturated(
        pkg, engine=engine, cluster_config=steal_cluster(pkg)))
    assert cluster_result(res) == cluster_result(ref_res)
    assert res.migrations > 0
    led = res.ledger
    hosted = {}
    for ni, nc in enumerate(res.coordinator.node_coords):
        for sim in nc.sims:
            for c in sim.clients:
                assert c.cid not in hosted
                hosted[c.cid] = ni
    assert hosted == led.current
    res.coordinator.check()
    off_home = {cid for cid, n in led.current.items() if n != led.home[cid]}
    assert {r.cid for r in led.ledger if r.open} == off_home
    assert led.donated_seconds(res.horizon) > 0
    be = {i for i, a in enumerate(saturated_apps(PORT))
          if a.priority == PORT.types.Priority.BEST_EFFORT}
    assert {cid for _, cid, _, _ in res.coordinator.migration_log} <= be
    assert len(res.coordinator.migration_log) == res.migrations


def test_cross_node_stealing_helps_the_starved_trainers():
    PORT.types.reset_kernel_ids()
    static = run_saturated(PORT, horizon=3.0)
    PORT.types.reset_kernel_ids()
    steal = run_saturated(PORT, horizon=3.0,
                          cluster_config=steal_cluster(PORT))
    be_jobs = [sum(r.client(n).n_completed for n in ("be0", "be1"))
               for r in (static, steal)]
    assert steal.migrations > 0 and be_jobs[1] > be_jobs[0]


def test_two_tier_stealing_equals_reference_on_h100():
    """Intra-node and cross-node lending together, on ``h100_like``."""
    ref_res, res = both(lambda pkg: run_saturated(
        pkg, profile="h100_like", horizon=1.0,
        cluster_config=steal_cluster(pkg, node_config=steal_node(pkg))))
    assert cluster_result(res) == cluster_result(ref_res)
    assert res.migrations + res.node_migrations > 0
    res.coordinator.check()
    for nc in res.coordinator.node_coords:
        nc.check()


# -- heterogeneous capacity + fragmentation ----------------------------------

@pytest.mark.parametrize("second", ["l4_like", "h100_like"])
def test_heterogeneous_cluster_samples_fragmentation(second):
    def go(pkg):
        cl = pkg.types.ClusterSpec(nodes=(node(pkg, 1, "a100_like"),
                                          node(pkg, 1, second)),
                                   name="hetero")
        apps = [hp_app(pkg, "a", quota=40),
                hp_app(pkg, "b", quota=20, rps=10.0), be_train(pkg, "c")]
        return pkg.cluster.evaluate_cluster(
            "lithos", cl, apps, horizon=1.0, seed=1, router="frag_aware",
            cluster_config=pkg.types.ClusterConfig(epoch=0.25))
    ref_res, res = both(go)
    assert cluster_result(res) == cluster_result(ref_res)
    assert res.client("a").n_completed > 0
    assert len(res.frag_series) >= 3
    assert all(0.0 <= f <= 1.0 for _, f in res.frag_series)
    assert 0.0 <= res.frag_mean <= 1.0


# -- power capping -----------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
def test_power_cap_equals_reference(profile):
    """A cap of 80 % of the uncapped run's mean draw: the manager runs every
    epoch, lowers energy and never lets a device below the ladder."""
    PORT.types.reset_kernel_ids()
    free = run_saturated(PORT, profile=profile, horizon=1.0)
    cap = 0.8 * free.energy / free.horizon
    ref_res, res = both(lambda pkg: run_saturated(
        pkg, profile=profile, horizon=1.0,
        cluster_config=pkg.types.ClusterConfig(power_cap=cap)))
    assert cluster_result(res) == cluster_result(ref_res)
    assert res.power_log and res.energy < free.energy
    f0 = device(PORT, profile).f_states[0]
    for _, before, after, min_f in res.power_log:
        assert after <= max(cap, before) + 1e-6
        assert min_f >= f0 - 1e-9


def test_power_cap_respects_hp_floor():
    ref_res, res = both(lambda pkg: run_saturated(
        pkg, horizon=1.0, cluster_config=pkg.types.ClusterConfig(
            power_cap=1.0, power_hp_floor=0.8)))
    assert cluster_result(res) == cluster_result(ref_res)
    pm = res.coordinator.power_manager
    fs = PORT.dvfs.plan_power_budget(pm.specs, [s.n_slices for s in pm.specs],
                                     [True] * len(pm.specs), 1.0,
                                     hp_floor=0.8)
    assert all(f >= 0.8 - 1e-9 for f in fs)
