"""The port's level-agnostic hierarchy (``repro_torch.core.hierarchy``), the
node and cluster placement routers and the cluster power-budget planner,
against the reference's on the same inputs, on the CPU.

Each reference check of ``tests/test_hierarchy.py`` is made on the port, and
the port's answer is held equal (``==``) to the reference's."""
import dataclasses

import numpy as np
import pytest

from _torch_tiers import (PKGS, PORT, PROFILES, REF, be_train, cluster,
                          device, hp_app, node)

P_ROUTERS = PORT.hierarchy.ROUTERS


def _mixed_apps(pkg):
    return [hp_app(pkg, "a"), hp_app(pkg, "b", arch="whisper-small"),
            be_train(pkg, "c"), be_train(pkg, "d", arch="olmo-1b"),
            hp_app(pkg, "e", rps=5.0), hp_app(pkg, "f", quota=30),
            be_train(pkg, "g", quota=8)]


def test_router_names_equal_reference():
    assert PORT.hierarchy.ROUTERS == REF.hierarchy.ROUTERS
    assert PORT.node.ROUTERS == REF.node.ROUTERS
    assert PORT.cluster.CLUSTER_ROUTERS == REF.cluster.CLUSTER_ROUTERS


# -- generic routing ---------------------------------------------------------

CAPS = ([54], [54, 54], [60, 30], [27, 54], [54, 54, 54], [66, 29, 54, 7])


@pytest.mark.parametrize("router", P_ROUTERS)
@pytest.mark.parametrize("caps", CAPS, ids=str)
def test_route_equals_reference(router, caps):
    rng = np.random.default_rng(len(caps) * 7 + P_ROUTERS.index(router))
    for n_apps in (1, 3, 7):
        demands = [float(x) for x in rng.uniform(0.05, 1.0, n_apps)]
        got, want = [pkg.hierarchy.route(caps, _mixed_apps(pkg)[:n_apps],
                                         router, demands=demands)
                     for pkg in (PORT, REF)]
        assert got == want
        assert all(0 <= m < len(caps) for m in got)


def test_route_single_member_short_circuits():
    apps = [hp_app(PORT, "a"), hp_app(PORT, "b")]
    for router in P_ROUTERS:
        assert PORT.hierarchy.route([54], apps, router) == [0, 0]


def test_route_round_robin_and_least_loaded():
    apps = [hp_app(PORT, f"a{i}") for i in range(6)]
    route = PORT.hierarchy.route
    assert route([54, 54, 54], apps[:5], "round_robin") == [0, 1, 2, 0, 1]
    pl = route([60, 30], apps, "least_loaded", demands=[1.0] * 6)
    assert pl.count(0) == 4 and pl.count(1) == 2


def test_route_quota_aware_respects_member_capacity():
    apps = [hp_app(PORT, "big", quota=50), hp_app(PORT, "small", quota=20)]
    assert PORT.hierarchy.route([27, 54], apps, "quota_aware")[0] == 1


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_route_refuses_what_the_reference_refuses(pkg):
    with pytest.raises(ValueError):
        pkg.hierarchy.route([54, 54], [hp_app(pkg, "a")], "nope")
    with pytest.raises(AssertionError):
        pkg.hierarchy.route([54, 54], [hp_app(pkg, "a")], "least_loaded")


# -- fragmentation metric ----------------------------------------------------

def test_fragmentation_equals_reference_on_random_snapshots():
    rng = np.random.default_rng(11)
    for _ in range(300):
        free = [int(x) for x in rng.integers(0, 70, rng.integers(0, 6))]
        demands = [int(x) for x in rng.integers(0, 60, rng.integers(0, 5))]
        got = PORT.hierarchy.fragmentation(free, demands)
        assert got == REF.hierarchy.fragmentation(free, demands)
        assert 0.0 <= got <= 1.0


def test_fragmentation_cases():
    frag = PORT.hierarchy.fragmentation
    assert frag([54, 54], [10, 20, 30]) == 0.0
    assert frag([5, 3], [10, 20]) == 1.0
    assert frag([], [10]) == frag([0, 0], [10]) == frag([54], []) == 0.0
    assert frag([10, 2], [5, 8]) == pytest.approx(2.0 / 12.0)
    assert frag([9, 1], [10]) == 1.0 and frag([20, 1], [10]) < 1.0


def test_pressure_equals_reference():
    assert ([f.name for f in dataclasses.fields(PORT.hierarchy.Pressure)]
            == [f.name for f in dataclasses.fields(REF.hierarchy.Pressure)])
    assert (dataclasses.astuple(PORT.hierarchy.Pressure(3, 0.25, 2))
            == dataclasses.astuple(REF.hierarchy.Pressure(3, 0.25, 2)))


# -- cluster power-budget planner -------------------------------------------

@pytest.mark.parametrize("profile", PROFILES + ("l4_like",))
def test_power_budget_equals_reference(profile):
    """``plan_power_budget`` on random active counts, priorities, caps and
    floors, on mixed device lists."""
    rng = np.random.default_rng(5)
    for _ in range(60):
        n = int(rng.integers(1, 5))
        kinds = [profile if k else "a100_like" for k in rng.integers(0, 2, n)]
        active = [int(rng.integers(0, 67)) for _ in range(n)]
        hp = [bool(x) for x in rng.integers(0, 2, n)]
        floor = float(rng.choice([0.5, 0.75, 0.9]))
        devs = [device(PORT, k) for k in kinds]
        active = [min(a, d.n_slices) for a, d in zip(active, devs)]
        cap = float(sum(d.power(a, 1.0) for a, d in zip(active, devs))
                    * rng.uniform(0.0, 1.2))
        got, want = [pkg.dvfs.plan_power_budget(
            [device(pkg, k) for k in kinds], active, hp, cap, hp_floor=floor)
            for pkg in (PORT, REF)]
        assert got == want


def _plan(active, hp, cap, profile="a100_like", hp_floor=0.75):
    dev = device(PORT, profile)
    return dev, PORT.dvfs.plan_power_budget([dev] * len(active), active, hp,
                                            cap, hp_floor=hp_floor)


@pytest.mark.parametrize("profile", PROFILES)
def test_power_budget_properties(profile):
    n = device(PORT, profile).n_slices
    dev, fs = _plan([n] * 3, [True] * 3, 1e9, profile)
    assert fs == [1.0, 1.0, 1.0]
    full = 3 * dev.power(n, 1.0)
    _, fs = _plan([n] * 3, [True, True, False], full - 100.0, profile)
    assert fs[0] == fs[1] == 1.0 and fs[2] < 1.0
    _, fs = _plan([n] * 3, [True] * 3, 0.0, profile)
    assert all(f >= 0.75 - 1e-9 for f in fs)
    _, fs = _plan([n] * 3, [False] * 3, 0.0, profile)
    assert all(f == dev.f_states[0] for f in fs)
    floor = 3 * dev.power(n, dev.f_states[0])
    cap = (full + floor) / 2
    _, fs = _plan([n] * 3, [False] * 3, cap, profile)
    assert sum(dev.power(n, f) for f in fs) <= cap + 1e-6
    _, fs = _plan([0, n, n], [False] * 3, 0.0, profile)
    assert fs[0] == 1.0 and fs[1] == fs[2] == dev.f_states[0]


# -- node and cluster placement ----------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
def test_demand_estimate_and_place_equal_reference(profile):
    for n_dev in (1, 2, 3):
        for router in P_ROUTERS:
            got, want = [pkg.node.place(node(pkg, n_dev, profile),
                                        _mixed_apps(pkg), router)
                         for pkg in (PORT, REF)]
            assert got == want
    for p_app, r_app in zip(_mixed_apps(PORT), _mixed_apps(REF)):
        got = PORT.node.demand_estimate(p_app, device(PORT, profile))
        assert got == REF.node.demand_estimate(r_app, device(REF, profile))
        assert 0.0 < got <= 1.0


def test_place_properties():
    place = PORT.node.place
    a100 = device(PORT)
    two = node(PORT, 2)
    assert sorted(place(two, [be_train(PORT, "t1"), be_train(PORT, "t2")],
                        "least_loaded")) == [0, 1]
    big = a100.n_slices - 10
    p = place(two, [hp_app(PORT, "a", quota=big), hp_app(PORT, "b", quota=big),
                    be_train(PORT, "c"), be_train(PORT, "d")], "quota_aware")
    assert p[0] != p[1] and sorted(p[2:]) == [0, 1]
    small = dataclasses.replace(a100, n_slices=27)
    hetero = PORT.types.NodeSpec(devices=(small, a100))
    assert place(hetero, [hp_app(PORT, "big", quota=50),
                          hp_app(PORT, "q", quota=20)], "quota_aware")[0] == 1
    p = place(two, [hp_app(PORT, "a"), hp_app(PORT, "b", arch="whisper-small"),
                    hp_app(PORT, "c", rps=5.0)], "affinity")
    assert p[0] == p[2] != p[1]
    assert PORT.node.demand_estimate(be_train(PORT), a100) == 1.0
    with pytest.raises(ValueError):
        place(two, [hp_app(PORT)], "random")


def _hetero_cluster(pkg, second="l4_like"):
    return pkg.types.ClusterSpec(
        nodes=(node(pkg, 2, "a100_like"), node(pkg, 2, second)),
        name="hetero")


@pytest.mark.parametrize("second", ["l4_like", "h100_like"])
def test_place_cluster_equals_reference(second):
    for router in PORT.cluster.CLUSTER_ROUTERS:
        for shape in ("hetero", "uniform"):
            got, want = [
                pkg.cluster.place_cluster(
                    _hetero_cluster(pkg, second) if shape == "hetero"
                    else cluster(pkg, 2, 2, second), _mixed_apps(pkg), router)
                for pkg in (PORT, REF)]
            assert got == want
            assert len(got) == 7


def test_frag_aware_placement_fits_guarantees_to_capacity():
    apps = [hp_app(PORT, "big0", quota=40), hp_app(PORT, "big1", quota=40),
            hp_app(PORT, "small0", quota=20), hp_app(PORT, "small1", quota=20),
            be_train(PORT, "be0"), be_train(PORT, "be1", arch="olmo-1b")]
    cl = _hetero_cluster(PORT)
    pl = PORT.cluster.place_cluster(cl, apps, "frag_aware")
    assert pl[0][0] == 0 and pl[1][0] == 0 and pl[0] != pl[1]
    assert pl[4] != pl[5]
    for ni, di in pl:
        assert 0 <= ni < cl.n_nodes and 0 <= di < cl.nodes[ni].n_devices
    with pytest.raises(ValueError):
        PORT.cluster.place_cluster(cl, apps, "random")
