"""The port's LithOS control plane (``repro_torch.core``) against the
reference's (``repro.core``), on the CPU.

The simulator is host code that schedules descriptions of kernels, so the
two packages must agree bit for bit: the same ``CompletionRecord`` streams,
client latencies, energy and event counts for every configuration of
``scripts/parity_check.py`` under both engines, on ``a100_like`` and on a
reference ``DeviceSpec`` with ``h100_like``'s field values; and equal outputs
of the components (atomizer, cost model, predictor, right-sizer, DVFS
governor, workload traces) on the same inputs.  Both packages' kernel-id
streams are reset before each run.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs.registry import get_config as ref_get_config
from repro.core import atomizer as r_atomizer
from repro.core import costmodel as r_costmodel
from repro.core import dvfs as r_dvfs
from repro.core import lithos as r_lithos
from repro.core import predictor as r_predictor
from repro.core import rightsizer as r_rightsizer
from repro.core import scheduler as r_scheduler
from repro.core import simulator as r_simulator
from repro.core import types as r_types
from repro.core import workloads as r_workloads
from repro_torch.configs.registry import get_config as port_get_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core import atomizer as p_atomizer
from repro_torch.core import costmodel as p_costmodel
from repro_torch.core import dvfs as p_dvfs
from repro_torch.core import lithos as p_lithos
from repro_torch.core import predictor as p_predictor
from repro_torch.core import rightsizer as p_rightsizer
from repro_torch.core import scheduler as p_scheduler
from repro_torch.core import simulator as p_simulator
from repro_torch.core import types as p_types
from repro_torch.core import workloads as p_workloads

HORIZON = 1.0


@dataclasses.dataclass(frozen=True)
class Pkg:
    types: object
    workloads: object
    lithos: object
    scheduler: object
    simulator: object
    get_config: object


REF = Pkg(r_types, r_workloads, r_lithos, r_scheduler, r_simulator,
          ref_get_config)
PORT = Pkg(p_types, p_workloads, p_lithos, p_scheduler, p_simulator,
           port_get_config)


def ref_device(port_dev):
    """The reference's ``DeviceSpec`` with a port profile's field values."""
    return r_types.DeviceSpec(**dataclasses.asdict(port_dev))


def devices(name):
    """(reference device, port device) of one profile."""
    if name == "a100_like":
        return r_types.DeviceSpec.a100_like(), p_types.DeviceSpec.a100_like()
    dev = p_types.DeviceSpec.h100_like()
    return ref_device(dev), dev


# -- the mixes of scripts/parity_check.py, built in either package ----------

def hp_app(pkg, rps=20.0, name="hp"):
    return pkg.workloads.AppSpec(
        name, pkg.get_config("olmo-1b"), "fwd_infer",
        priority=pkg.types.Priority.HIGH, rps=rps, prompt_mix=((128, 1.0),),
        batch=4, fusion=8)


def be_train(pkg, name="be"):
    return pkg.workloads.AppSpec(
        name, pkg.get_config("llama3-8b"), "train",
        priority=pkg.types.Priority.BEST_EFFORT, train_batch=2,
        train_seq=2048, fusion=8)


def cont_app(pkg, name="cont", rps=40.0):
    return pkg.workloads.AppSpec(
        name, pkg.get_config("olmo-1b"), "llm_continuous",
        priority=pkg.types.Priority.HIGH, rps=rps, max_batch=4,
        decode_tokens=8, fusion=8, prompt_mix=((256, 0.7), (1024, 0.3)),
        seed=5)


SYSTEMS = ("lithos", "mps", "mig", "limits", "timeslice", "priority",
           "reef", "tgs", "orion")
CONFIGS = SYSTEMS + ("lithos-full", "lithos-llm", "mps-llm",
                     "lithos-full-llm")


def scenario(pkg, label):
    """(system, apps, LithOSConfig or None) of one parity_check config."""
    system = label.split("-")[0]
    cfg = (pkg.scheduler.LithOSConfig(rightsize=True, dvfs=True)
           if "full" in label else None)
    apps = ([cont_app(pkg), be_train(pkg)] if label.endswith("-llm")
            else [hp_app(pkg), be_train(pkg)])
    return system, apps, cfg


def run(pkg, label, engine, device, horizon=HORIZON):
    """One run through the same calls as ``evaluate``, keeping the
    simulator for its event count."""
    system, apps, cfg = scenario(pkg, label)
    pkg.types.reset_kernel_ids()
    policy = pkg.lithos.make_policy(system, device, apps, lithos_config=cfg)
    sim = pkg.simulator.make_simulator(device, apps, policy, engine=engine,
                                       horizon=horizon, seed=0)
    return sim.run(), sim.events


def signature(res, events):
    """Everything a run reports, as plain values compared with ``==``."""
    return {
        "records": [(r.task.kid, r.task.queue_id, r.task.ordinal, r.t_submit,
                     r.t_start, r.t_end, r.slices, r.freq, r.task.op_name,
                     r.task.atom_of, r.task.phase, r.task.work.n_blocks,
                     r.task.work.flops, r.task.work.bytes)
                    for r in res.records],
        "energy": res.energy,
        "busy_slice_seconds": res.busy_slice_seconds,
        "events": events,
        "clients": [(c.name, int(c.priority), c.n_completed, c.throughput,
                     c.latencies, c.req_latencies, c.slice_seconds,
                     c.arrivals, c.kernels_per_job, c.kv_peak_bytes)
                    for c in res.clients],
    }


@pytest.mark.parametrize("profile", ["a100_like", "h100_like"])
@pytest.mark.parametrize("engine", ["ref", "vec"])
@pytest.mark.parametrize("label", CONFIGS)
def test_simulation_equals_reference(label, engine, profile):
    r_dev, p_dev = devices(profile)
    want = signature(*run(REF, label, engine, r_dev))
    got = signature(*run(PORT, label, engine, p_dev))
    assert len(want["records"]) > 0 and want["events"] > 0
    assert got == want


@pytest.mark.parametrize("system", ["lithos", "mps"])
def test_evaluate_entry_point_equals_reference_on_h100(system):
    """``evaluate`` itself, on ``h100_like``, under both engines."""
    r_dev, p_dev = devices("h100_like")
    sigs = []
    for pkg, dev in ((REF, r_dev), (PORT, p_dev)):
        for engine in ("ref", "vec"):
            pkg.types.reset_kernel_ids()
            res = pkg.lithos.evaluate(system, dev,
                                      [hp_app(pkg), be_train(pkg)],
                                      horizon=HORIZON, seed=0, engine=engine)
            sigs.append(signature(res, None))
    assert sigs[0] == sigs[1] == sigs[2] == sigs[3]


def test_evaluate_refuses_node_and_cluster_specs():
    """``evaluate``'s node and cluster arms equal the reference's on
    ``h100_like``, and it refuses what the reference refuses, in the same
    order: ``node_config`` on a ClusterSpec, ``cluster_config`` without
    one, ``node_config`` or ``placement`` on a bare DeviceSpec."""
    def specs(pkg, dev):
        node = pkg.types.NodeSpec.uniform(2, dev)
        return node, pkg.types.ClusterSpec.uniform(2, node)

    r_dev, p_dev = devices("h100_like")
    for i in (0, 1):
        sigs = []
        for pkg, dev in ((REF, r_dev), (PORT, p_dev)):
            pkg.types.reset_kernel_ids()
            res = pkg.lithos.evaluate("lithos", specs(pkg, dev)[i],
                                      [hp_app(pkg), be_train(pkg)],
                                      horizon=0.3, seed=0)
            sigs.append((signature(res, None), list(res.placement),
                         res.migrations))
        assert sigs[1] == sigs[0]
        assert len(sigs[0][0]["records"]) > 0
    node, cluster = specs(PORT, p_dev)
    apps = [hp_app(PORT), be_train(PORT)]
    for pkg_types, lithos, (n, c), dev in (
            (r_types, r_lithos, specs(REF, r_dev), r_dev),
            (p_types, p_lithos, (node, cluster), p_dev)):
        with pytest.raises(ValueError, match="cluster_config.node_config"):
            lithos.evaluate("lithos", c, apps, horizon=0.1,
                            node_config=pkg_types.NodeConfig(),
                            cluster_config=pkg_types.ClusterConfig())
        for spec in (n, dev):
            with pytest.raises(ValueError, match="requires a ClusterSpec"):
                lithos.evaluate("lithos", spec, apps, horizon=0.1,
                                cluster_config=pkg_types.ClusterConfig(),
                                placement=[0, 0])
        with pytest.raises(ValueError, match="require a NodeSpec"):
            lithos.evaluate("lithos", dev, apps, horizon=0.1,
                            node_config=pkg_types.NodeConfig())
        with pytest.raises(ValueError, match="require a NodeSpec"):
            lithos.evaluate("lithos", dev, apps, horizon=0.1,
                            placement=[0, 0])


def test_default_engine_reads_the_same_variable(monkeypatch):
    monkeypatch.delenv("REPRO_SIM_ENGINE", raising=False)
    assert p_lithos.default_engine() == r_lithos.default_engine() == "ref"
    monkeypatch.setenv("REPRO_SIM_ENGINE", "vec")
    assert p_lithos.default_engine() == r_lithos.default_engine() == "vec"


def test_profiles_equal_reference():
    for name in ("a100_like", "l4_like"):
        assert (dataclasses.asdict(getattr(p_types.DeviceSpec, name)())
                == dataclasses.asdict(getattr(r_types.DeviceSpec, name)()))
    assert (dataclasses.asdict(p_types.DeviceSpec())
            == dataclasses.asdict(r_types.DeviceSpec()))


def test_h100_profile_power_model():
    """Idle draw at no active slice, loaded draw at every slice at f_max,
    and the idle draw split between host and slices as ``a100_like``'s."""
    d = p_types.DeviceSpec.h100_like()
    a = p_types.DeviceSpec.a100_like()
    assert d.n_slices == 66 == p_types.H100_SMS // 2
    assert d.power(0, 1.0) == pytest.approx(p_types.H100_IDLE_W, rel=1e-12)
    assert d.power(66, 1.0) == pytest.approx(p_types.H100_LOADED_W,
                                             rel=1e-12)
    assert (d.p_static_host / (d.n_slices * d.p_idle)
            == pytest.approx(a.p_static_host / (a.n_slices * a.p_idle),
                             rel=1e-12))
    assert d.hbm_capacity * 66 == pytest.approx(p_types.H100_MEMORY,
                                                rel=1e-12)
    assert d.launch_overhead == p_types.H100_K1_FIXED_S
    assert d.occupancy == 2 * p_types.H100_DECODE_CTAS_PER_SM
    assert d.f_states == p_types.DeviceSpec().f_states


# -- workloads ----------------------------------------------------------------

def _ops(trace):
    return [(o.name, o.flops, o.bytes, o.n_blocks, o.phase) for o in trace]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_traces_equal_reference(arch):
    """Forward, train-step, prefill and decode traces, fused and not, and
    the KV model, from the port's configs against the reference's."""
    rc, pc = ref_get_config(arch), port_get_config(arch)
    for fn, args in (("forward_trace", (2, 128)), ("train_step_trace", (2, 64)),
                     ("prefill_trace", (1, 300)),
                     ("decode_step_trace", (4, 700))):
        want = getattr(r_workloads, fn)(rc, *args)
        got = getattr(p_workloads, fn)(pc, *args)
        assert _ops(got) == _ops(want), fn
        assert (_ops(p_workloads.fuse_trace(got, 8))
                == _ops(r_workloads.fuse_trace(want, 8))), fn
    assert p_workloads.kv_bytes(pc, 3, 1000) == r_workloads.kv_bytes(rc, 3,
                                                                    1000)
    r_dev, p_dev = devices("h100_like")
    assert (p_workloads.kv_floor_slices(pc, p_dev, 3e10)
            == r_workloads.kv_floor_slices(rc, r_dev, 3e10))


@pytest.mark.parametrize("kind", ["train", "fwd_infer", "llm_infer",
                                  "llm_prefill", "llm_decode",
                                  "llm_continuous"])
def test_job_traces_and_draws_equal_reference(kind):
    """Seeded job traces and arrivals of every kind: the same ops and the
    same generator state after every job (the draw-order contract)."""
    specs = []
    for pkg in (REF, PORT):
        specs.append(pkg.workloads.AppSpec(
            "x", pkg.get_config("olmo-1b"), kind, rps=30.0, decode_tokens=8,
            prompt_mix=((256, 0.7), (1024, 0.3)), max_batch=4, batch=2,
            train_batch=2, train_seq=256, fusion=4, seed=5))
    rngs = [np.random.default_rng(42), np.random.default_rng(42)]
    assert specs[1].arrivals(2.0, rngs[1]) == specs[0].arrivals(2.0, rngs[0])
    if kind == "llm_continuous":
        return           # its draws are made at arrival, by the client
    for _ in range(4):
        want = specs[0].job_trace(rngs[0])
        got = specs[1].job_trace(rngs[1])
        assert _ops(got) == _ops(want)
        assert rngs[1].bit_generator.state == rngs[0].bit_generator.state


def test_fault_schedule_equals_reference():
    for seed in (0, 3):
        want = r_workloads.fault_schedule(4, 2.0, seed=seed)
        got = p_workloads.fault_schedule(4, 2.0, seed=seed)
        assert ([dataclasses.astuple(e) for e in got.events]
                == [dataclasses.astuple(e) for e in want.events])


# -- components on the same inputs -------------------------------------------

def _task(types, rng_row):
    flops, byts, blocks, q, k = rng_row
    return types.KernelTask("op", types.KernelWork(flops, byts, int(blocks)),
                            client_id=int(q), queue_id=int(q),
                            ordinal=int(k))


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return list(zip(10.0 ** rng.uniform(8, 13, n), 10.0 ** rng.uniform(5, 10, n),
                    rng.integers(1, 20_000, n), rng.integers(0, 3, n),
                    rng.integers(0, 6, n)))


def test_atom_ranges_and_plans_equal_reference():
    for nb in (1, 2, 7, 64, 255, 256, 1000, 4096, 14336):
        for n in (1, 2, 3, 8, 32, 100):
            assert (p_atomizer.atom_ranges(nb, n)
                    == r_atomizer.atom_ranges(nb, n))
    rows = _rows(0, 300)
    lat = np.random.default_rng(1).uniform(0.0, 20e-3, len(rows))
    for cfg in ({}, {"atom_duration": 0.5e-3, "large_grid_blocks": 1000}):
        out = []
        for types, mod in ((r_types, r_atomizer), (p_types, p_atomizer)):
            types.reset_kernel_ids()
            at = mod.KernelAtomizer(mod.AtomizerConfig(**cfg))
            got = []
            for i, row in enumerate(rows):
                t = _task(types, row)
                t.phase = ("decode", "prefill", "")[i % 3]
                pred = None if i % 7 == 0 else float(lat[i])
                n = at.plan(t, pred, unseen_conservative=(i % 2 == 0))
                got.append([(a.kid, a.atom_of, a.work.n_blocks, a.work.flops,
                             a.work.bytes) for a in at.split(t, n)])
            out.append((got, at.atomized, at.passed_through))
        assert out[1] == out[0]


@pytest.mark.parametrize("profile", ["default", "a100_like", "h100_like"])
def test_costmodel_equals_reference(profile):
    if profile == "default":
        r_dev, p_dev = r_types.DeviceSpec(), p_types.DeviceSpec()
    else:
        r_dev, p_dev = devices(profile)
    rc, pc = r_costmodel.CostModel(r_dev), p_costmodel.CostModel(p_dev)
    for row in _rows(2, 100):
        rw = r_types.KernelWork(row[0], row[1], int(row[2]))
        pw = p_types.KernelWork(row[0], row[1], int(row[2]))
        assert (dataclasses.astuple(pc.phases(pw))
                == dataclasses.astuple(rc.phases(rw)))
        for t in (1, 7, p_dev.n_slices):
            for f in (0.4, 0.85, 1.0):
                assert pc.latency(pw, t, f) == rc.latency(rw, t, f)
                assert pc.energy(pw, t, f) == rc.energy(rw, t, f)
        assert pc.is_compute_bound(pw) == rc.is_compute_bound(rw)


def _records(types, seed, n, full):
    """Completion records of a few operator nodes at varied slices and
    frequencies, some of them atoms."""
    rng = np.random.default_rng(seed)
    out = []
    for i, row in enumerate(_rows(seed, n)):
        t = _task(types, row)
        if i % 5 == 0:
            t.atom_of = (t.kid, 0, 4)
        slices = int(rng.choice([1, 2, full // 2, full]))
        f = float(rng.choice([0.6, 0.8, 1.0]))
        lat = float(rng.uniform(1e-4, 1e-2))
        out.append(types.CompletionRecord(task=t, t_submit=0.1 * i,
                                          t_start=0.1 * i,
                                          t_end=0.1 * i + lat,
                                          slices=slices, freq=f))
    return out


def test_predictor_equals_reference():
    outs = []
    for types, mod in ((r_types, r_predictor), (p_types, p_predictor)):
        types.reset_kernel_ids()
        p = mod.LatencyPredictor(launch_overhead=4e-6)
        recs = _records(types, 3, 200, 54)
        got = []
        for r in recs:
            got.append((p.known(r.task), p.predict(r.task, 27),
                        p.predict(r.task, 54, f=0.8, n_atoms=4),
                        p.runtime_weight(r.task)))
            p.observe(r)
            p.record_outcome(got[-1][1], r.latency)
        got.append((p.predictions, p.mispredictions, p.errors))
        p.seed_node(9, 3, 54, 1.0, 2e-3)
        got.append(p.predict(types.KernelTask(
            "s", types.KernelWork(1.0, 1.0, 8), queue_id=9, ordinal=3), 54))
        outs.append(got)
    assert outs[1] == outs[0]


def test_rightsizer_equals_reference():
    outs = []
    for types, mod in ((r_types, r_rightsizer), (p_types, p_rightsizer)):
        types.reset_kernel_ids()
        rs = mod.RightSizer(full_slices=54, occupancy=8, slip=1.1)
        rs.set_memory_floor(1, 3)
        got = []
        for r in _records(types, 4, 200, 54):
            got.append((rs.probe_allocation(r.task, 54),
                        rs.occupancy_bound(r.task), rs.decide(r.task, 54)))
            rs.observe(r)
        got.append(rs.weighted_r2())
        outs.append(got)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("profile", ["a100_like", "h100_like"])
def test_dvfs_governor_equals_reference(profile):
    r_dev, p_dev = devices(profile)
    outs = []
    for types, mod, dev in ((r_types, r_dvfs, r_dev), (p_types, p_dvfs, p_dev)):
        types.reset_kernel_ids()
        gov = mod.DVFSGovernor(dev, slip=1.1)
        got = []
        for i, r in enumerate(_records(types, 5, 200, dev.n_slices)):
            gov.observe(r)
            got.append((gov.unseen(r.task), gov.aggregate_sensitivity(),
                        gov.aggregate_sensitivity(r.task.queue_id),
                        gov.target_frequency(),
                        gov.maybe_switch(0.01 * i)))
        outs.append(got)
    assert outs[1] == outs[0]


# -- the slice ledger (the reference's per-event invariant, kept cheap) -----

def _ledger_run(pkg, engine):
    """The reference's seed-3 steal scenario (``test_slices.py``), to the
    end of its 2 s horizon."""
    dev = pkg.types.DeviceSpec.a100_like()
    apps = [hp_app(pkg), be_train(pkg)]
    pkg.types.reset_kernel_ids()
    policy = pkg.lithos.make_policy("lithos", dev, apps)
    sim = pkg.simulator.make_simulator(dev, apps, policy, engine=engine,
                                       horizon=2.0, seed=3)
    return sim.run(), policy


@pytest.mark.parametrize("engine", ["ref", "vec"])
def test_slice_ledger_equals_reference(engine):
    """After the same seed-3 run both packages hold the same lends:
    ``lent_slice_seconds``, ``stolen_slice_seconds`` and, for the scalar
    ``SliceMap`` (the vectorized map keeps no ledger), every entry."""
    (r_res, r_pol), (p_res, p_pol) = (_ledger_run(REF, engine),
                                      _ledger_run(PORT, engine))
    assert p_pol.slices.lent_slice_seconds == r_pol.slices.lent_slice_seconds
    assert p_pol.stolen_slice_seconds == r_pol.stolen_slice_seconds
    assert r_pol.stolen_slice_seconds > 0
    assert type(p_pol.slices).__name__ == type(r_pol.slices).__name__
    if engine == "ref":
        assert ([dataclasses.astuple(e) for e in p_pol.slices.ledger]
                == [dataclasses.astuple(e) for e in r_pol.slices.ledger])
        assert len(r_pol.slices.ledger) > 0
    p_pol.slices.check()


def test_slice_conservation_every_event_short_horizon():
    """The port's ``SliceMap.check()`` and partition count after every
    allocation change.  The reference runs this over a 2 s horizon
    (``test_slices.py::test_lithos_conservation_every_event``, minutes on
    one CPU); here 0.2 s keeps it to seconds, and
    ``test_slice_ledger_equals_reference`` holds the whole 2 s run's ledger
    equal to the reference's instead."""
    dev = p_types.DeviceSpec.a100_like()
    apps = [hp_app(PORT), be_train(PORT)]
    p_types.reset_kernel_ids()
    policy = p_lithos.make_policy("lithos", dev, apps)
    sim = p_simulator.Simulator(dev, apps, policy, horizon=0.2, seed=3)
    orig = sim._apply_allocations
    n_checks = [0]

    def checked():
        out = orig()
        policy.slices.check()
        c = policy.slices.counts()
        assert c["owned_idle"] + c["pool_idle"] + c["held"] == dev.n_slices
        n_checks[0] += 1
        return out

    sim._apply_allocations = checked
    res = sim.run()
    assert n_checks[0] > 0
    assert res.client("hp").n_completed > 0
    assert policy.slices.lent_slice_seconds > 0
    policy.slices.check()
