"""The port's node tier (``repro_torch.core.node``) against the reference's,
on the CPU: ``evaluate`` over a ``NodeSpec`` under both engines, on
``a100_like`` and on ``h100_like``'s values, every ``NodeResult`` field equal
(``==``); the 1-device contract; the routers end to end; the quota clamp.

Each reference check of ``tests/test_node.py`` is made on the port's
result, which is held equal to the reference's.  Horizons are shorter than
the reference's own (its tests stay as they are)."""
import pytest

from _torch_tiers import (ENGINES, PORT, PROFILES, REF, be_train, both,
                          device, hp_app, node, node_result, sim_result)

SYSTEMS = ("lithos", "mps", "mig", "limits", "reef", "timeslice")


def four_apps(pkg):
    return [hp_app(pkg, "hpA"), hp_app(pkg, "hpB", rps=10.0,
                                       arch="whisper-small"),
            be_train(pkg, "beA"), be_train(pkg, "beB", arch="olmo-1b")]


def run_node(pkg, system="lithos", *, profile="a100_like", n=2, engine="ref",
             horizon=1.0, seed=1, router="least_loaded", apps=four_apps,
             **kw):
    return pkg.lithos.evaluate(system, node(pkg, n, profile), apps(pkg),
                               horizon=horizon, seed=seed, router=router,
                               engine=engine, **kw)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("system", ["lithos", "mps", "mig", "reef"])
def test_node_evaluate_equals_reference(system, engine, profile):
    want, got = both(lambda pkg: node_result(run_node(
        pkg, system, profile=profile, engine=engine, horizon=0.6)))
    assert len(want["records"]) > 0
    assert got == want


@pytest.mark.parametrize("router", PORT.node.ROUTERS)
def test_node_routers_equal_reference_on_h100(router):
    """Three ``h100_like`` devices, five tenants, each router."""
    def apps(pkg):
        return four_apps(pkg) + [hp_app(pkg, "e", rps=5.0)]
    want, got = both(lambda pkg: node_result(run_node(
        pkg, profile="h100_like", n=3, router=router, apps=apps,
        horizon=0.5, seed=2)))
    assert got == want
    assert len(set(got["placement"])) > 1


@pytest.mark.parametrize("system", SYSTEMS)
def test_one_device_node_is_the_device_path(system):
    """A 1-device node reproduces the ``DeviceSpec`` path bit for bit in the
    port, as in the reference, and equals the reference's node run."""
    def apps(pkg):
        return [hp_app(pkg), be_train(pkg)]
    PORT.types.reset_kernel_ids()
    a = PORT.lithos.evaluate(system, device(PORT), apps(PORT), horizon=1.0,
                             seed=3)
    want, got = both(lambda pkg: node_result(run_node(
        pkg, system, n=1, apps=apps, seed=3)))
    assert got == want
    single = sim_result(a)
    assert [c[:7] for c in got["clients"]] == [c[:7] for c in
                                               single["clients"]]
    assert got["energy"] == single["energy"]
    assert got["busy"] == single["busy"]
    assert [r[1:] for r in got["records"]] == [r[1:] for r in
                                              single["records"]]


def test_node_result_properties():
    res = run_node(PORT, horizon=1.0, seed=1)
    assert {c.name for c in res.clients} == {"hpA", "hpB", "beA", "beB"}
    assert res.client("hpA").n_completed > 0
    assert 0.0 < res.utilization <= 1.0 and res.energy > 0
    for d, r in enumerate(res.per_device):
        here = {i for i, p in enumerate(res.placement) if p == d}
        assert {rec.task.client_id for rec in r.records} <= here
    assert [c.cid for c in res.clients] == [0, 1, 2, 3]
    assert res.device_of("beB") == res.placement[3]


def test_client_keeps_workload_stream_across_placements():
    r1 = run_node(PORT, router="round_robin", seed=5)
    r2 = run_node(PORT, router="affinity", seed=5)
    a1 = sorted(r1.client("hpA").arrivals)
    a2 = sorted(r2.client("hpA").arrivals)
    common = min(len(a1), len(a2))
    assert common > 0 and a1[:common] == a2[:common]


def test_mig_on_node_still_strands_be():
    res = run_node(PORT, "mig", seed=0, horizon=0.6)
    assert res.client("beA").n_completed == 0
    assert res.client("beB").n_completed == 0
    assert res.client("hpA").n_completed > 0


# -- quota derivation (shared with the device path) -------------------------

@pytest.mark.parametrize("profile", PROFILES)
def test_quotas_from_apps_equal_reference(profile):
    def cases(pkg):
        n = device(pkg, profile).n_slices
        return [
            [hp_app(pkg, "a", quota=n + 40), hp_app(pkg, "b"),
             be_train(pkg, "c")],
            [hp_app(pkg, "a"), hp_app(pkg, "b"), be_train(pkg, "c")],
            [hp_app(pkg, f"d{i}") for i in range(5)]
            + [hp_app(pkg, "explicit", quota=50)]]
    for i in range(3):
        got, want = [
            {cid: (q.slices, int(q.priority)) for cid, q in
             pkg.lithos.quotas_from_apps(device(pkg, profile),
                                         cases(pkg)[i]).items()}
            for pkg in (PORT, REF)]
        assert got == want
    q = PORT.lithos.quotas_from_apps(device(PORT, profile),
                                     [hp_app(PORT, "a"), be_train(PORT, "c")],
                                     cids=[7, 42])
    assert set(q) == {7, 42} and q[7].priority == PORT.types.Priority.HIGH
    dev = device(PORT, profile)
    q = PORT.lithos.quotas_from_apps(dev, cases(PORT)[0])
    assert q[0].slices == dev.n_slices and q[1].slices == q[2].slices == 0
