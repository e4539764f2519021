"""The port's node-level lending protocol (cross-device slice stealing)
against the reference's, on the CPU.

The adversarial mix of ``tests/test_node_stealing.py`` (every tenant pinned
on device 0, device 1 idle) runs in both packages with and without
migration; every ``NodeResult`` field must be equal (``==``), and each
reference check of the lending protocol is made on the port's result."""
import os
import sys

import pytest

from _torch_tiers import (ENGINES, PORT, REF, be_train, both, device, hp_app,
                          node, node_result)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks.scenarios import frac_throughput  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402


def hp25(pkg, name="hp0"):
    return hp_app(pkg, name, rps=25.0, slo=0.08)


def olmo_train(pkg, name, quota=0):
    return be_train(pkg, name, arch="olmo-1b", seq=512, quota=quota)


def adversarial(pkg):
    return [hp25(pkg), olmo_train(pkg, "be0"), olmo_train(pkg, "be1")]


def steal_cfg(pkg, **kw):
    base = dict(migration=True, epoch=0.1, migration_cost=0.02,
                cooldown=5.0, free_hi=0.5, free_lo=0.2, hp_depth_hi=3,
                validate=True)
    return pkg.types.NodeConfig(**{**base, **kw})


def run(pkg, apps=adversarial, placement=(0, 0, 0), horizon=3.0, seed=7,
        profile="a100_like", engine="ref", **kw):
    return pkg.node.evaluate_node("lithos", node(pkg, 2, profile), apps(pkg),
                                  horizon=horizon, seed=seed,
                                  placement=list(placement), engine=engine,
                                  **kw)


@pytest.fixture(scope="module")
def steal_runs():
    """(static, steal) in the reference, then in the port."""
    out = {}
    for pkg in (REF, PORT):
        pkg.types.reset_kernel_ids()
        static = run(pkg, node_config=pkg.types.NodeConfig(migration=False))
        pkg.types.reset_kernel_ids()
        out[pkg.name] = (static, run(pkg, node_config=steal_cfg(pkg)))
    return out


def test_steal_runs_equal_reference(steal_runs):
    for i in (0, 1):
        assert (node_result(steal_runs["port"][i])
                == node_result(steal_runs["ref"][i]))
    assert steal_runs["port"][1].migrations >= 1


def test_stealing_migrates_a_be_client(steal_runs):
    _, steal = steal_runs["port"]
    moved = [cid for cid, d in steal.ledger.current.items()
             if d != steal.ledger.home[cid]]
    assert moved and all(cid in (1, 2) for cid in moved)
    assert steal.final_placement[0] == 0


def test_conservation_across_devices_after_migration(steal_runs):
    _, steal = steal_runs["port"]
    assert steal.coordinator.check()
    led = steal.ledger
    off_home = {cid for cid, d in led.current.items() if d != led.home[cid]}
    assert {r.cid for r in led.ledger if r.open} == off_home
    assert led.donated_seconds(steal.horizon) > 0
    assert sorted(c.cid for r in steal.per_device for c in r.clients) == [
        0, 1, 2]


def test_stealing_improves_be_throughput_without_hurting_hp(steal_runs):
    static, steal = steal_runs["port"]
    h = static.horizon
    be = [sum(frac_throughput(r, n, h) for n in ("be0", "be1"))
          for r in (static, steal)]
    assert be[1] > 1.2 * be[0], be
    hp_s, hp_m = static.client("hp0"), steal.client("hp0")
    assert hp_m.n_completed >= hp_s.n_completed
    assert hp_m.slo_attainment(0.08) >= hp_s.slo_attainment(0.08) - 1e-9


def test_predictor_warm_started_on_target(steal_runs):
    _, steal = steal_runs["port"]
    _, cid, src, dst = steal.coordinator.migration_log[0]
    src_keys = [k for k in steal.policies[src].predictor.nodes if k[0] == cid]
    dst_keys = [k for k in steal.policies[dst].predictor.nodes if k[0] == cid]
    assert not src_keys and dst_keys
    assert any(steal.policies[dst].predictor.nodes[k].count > 0
               for k in dst_keys)


def test_migration_cost_delays_first_dispatch(steal_runs):
    _, steal = steal_runs["port"]
    t0, cid, _, dst = steal.coordinator.migration_log[0]
    starts = [r.t_start for r in steal.per_device[dst].records
              if r.task.client_id == cid]
    assert starts and min(starts) >= t0 + 0.02 - 1e-9


@pytest.mark.parametrize("system", ["lithos", "mps", "reef"])
def test_migration_off_is_the_sequential_runs(system):
    """With migration off, the interleaved node equals each device's
    simulator run on its own (the reference's contract), in the port, and
    equals the reference's node run."""
    def apps(pkg):
        return [hp_app(pkg, "hpA"), hp_app(pkg, "hpB", arch="whisper-small",
                                           rps=10.0),
                olmo_train(pkg, "beA"), olmo_train(pkg, "beB")]
    placement = [0, 1, 0, 1]
    want, got = both(lambda pkg: node_result(pkg.node.evaluate_node(
        system, node(pkg, 2), apps(pkg), horizon=1.0, seed=3,
        placement=placement,
        node_config=pkg.types.NodeConfig(migration=False))))
    assert got == want and got["migrations"] == 0
    dev = device(PORT)
    for d in (0, 1):
        idx = [i for i, p in enumerate(placement) if p == d]
        dev_apps = [apps(PORT)[i] for i in idx]
        policy = PORT.lithos.make_policy(system, dev, dev_apps, cids=idx)
        alone = Simulator(dev, dev_apps, policy, horizon=1.0, seed=3,
                          cids=idx).run()
        mine = got["per_device"][d]
        assert alone.energy == mine["energy"]
        assert alone.busy_slice_seconds == mine["busy"]
        assert ([(r.t_submit, r.t_start, r.t_end, r.slices, r.freq)
                 for r in alone.records]
                == [r[4:9] for r in mine["records"]])
        assert ([(c.cid, c.name, c.latencies, c.slice_seconds)
                 for c in alone.clients]
                == [(c[1], c[0], c[4], c[6]) for c in mine["clients"]])


def test_default_node_config_is_migration_off():
    res = run(PORT, horizon=1.0, seed=0)
    assert res.migrations == 0 and res.final_placement == [0, 0, 0]


@pytest.mark.parametrize("engine", ENGINES)
def test_open_loop_migrant_equals_reference(engine):
    """A best-effort open-loop tenant that may migrate: its arrivals stay
    one stream (no duplicates), in both packages alike."""
    def apps(pkg):
        be_inf = pkg.workloads.AppSpec(
            "be_inf", pkg.get_config("olmo-1b"), "fwd_infer",
            priority=pkg.types.Priority.BEST_EFFORT, rps=20.0,
            prompt_mix=((128, 1.0),), batch=4, fusion=8)
        return [hp25(pkg), olmo_train(pkg, "be0"), be_inf]
    ref_res, res = both(lambda pkg: run(pkg, apps, horizon=2.0,
                                        engine=engine,
                                        node_config=steal_cfg(pkg)))
    assert node_result(res) == node_result(ref_res)
    cm = res.client("be_inf")
    assert len(set(cm.arrivals)) == len(cm.arrivals)
    if 2 in (cid for _, cid, _, _ in res.coordinator.migration_log):
        assert len(cm.arrivals) == cm.n_completed


def test_be_client_with_explicit_quota_is_pinned():
    def apps(pkg):
        return [hp25(pkg), olmo_train(pkg, "qbe", quota=8),
                olmo_train(pkg, "be1")]
    ref_res, res = both(lambda pkg: run(pkg, apps, horizon=1.5,
                                        node_config=steal_cfg(pkg)))
    assert node_result(res) == node_result(ref_res)
    assert res.final_placement[1] == 0
    assert all(cid != 1 for _, cid, _, _ in res.coordinator.migration_log)


def test_max_migrations_cap_and_facade_on_h100():
    """The migration cap, through ``evaluate``'s node arm, on
    ``h100_like``'s values."""
    def go(pkg):
        return node_result(pkg.lithos.evaluate(
            "lithos", node(pkg, 2, "h100_like"), adversarial(pkg),
            horizon=0.6, seed=7, placement=[0, 0, 0],
            node_config=steal_cfg(pkg, cooldown=0.0, max_migrations=1)))
    want, got = both(go)
    assert got == want and got["migrations"] <= 1


def test_holds_are_counted_not_boolean():
    app = olmo_train(PORT, "be")
    dev = device(PORT)
    policy = PORT.lithos.make_policy("lithos", dev, [app])
    Simulator(dev, [app], policy, horizon=0.1, seed=0)
    policy.hold_client(0)
    policy.hold_client(0)
    policy.release_hold(0)
    assert 0 in policy._held
    policy.release_hold(0)
    assert 0 not in policy._held
    policy.release_hold(0)
    assert 0 not in policy._held


def test_single_device_rejects_node_kwargs():
    dev = device(PORT)
    app = olmo_train(PORT, "be")
    with pytest.raises(ValueError):
        PORT.lithos.evaluate("lithos", dev, [app], horizon=0.1,
                             node_config=PORT.types.NodeConfig(
                                 migration=True))
    with pytest.raises(ValueError):
        PORT.lithos.evaluate("lithos", dev, [app], horizon=0.1,
                             placement=[0])
