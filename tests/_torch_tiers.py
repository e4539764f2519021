"""Shared pieces of the parity tests of the port's node, cluster and online
tiers (``repro_torch.core.hierarchy / node / cluster``, ``repro_torch.ctl``)
against the reference's: the same tenants, specs and configs built in either
package, and a run's results as plain values compared with ``==``.

The tiers are host code that schedules descriptions of kernels, so the two
packages must agree bit for bit.  ``h100_like`` exists only in the port; the
reference side takes a ``DeviceSpec`` with its field values."""
import dataclasses

from repro.configs.registry import get_config as r_get_config
from repro.core import cluster as r_cluster
from repro.core import dvfs as r_dvfs
from repro.core import hierarchy as r_hierarchy
from repro.core import lithos as r_lithos
from repro.core import node as r_node
from repro.core import slices as r_slices
from repro.core import types as r_types
from repro.core import workloads as r_workloads
from repro_torch.configs.registry import get_config as p_get_config
from repro_torch.core import cluster as p_cluster
from repro_torch.core import dvfs as p_dvfs
from repro_torch.core import hierarchy as p_hierarchy
from repro_torch.core import lithos as p_lithos
from repro_torch.core import node as p_node
from repro_torch.core import slices as p_slices
from repro_torch.core import types as p_types
from repro_torch.core import workloads as p_workloads


@dataclasses.dataclass(frozen=True)
class Pkg:
    name: str
    types: object
    workloads: object
    lithos: object
    node: object
    cluster: object
    hierarchy: object
    dvfs: object
    slices: object
    get_config: object


REF = Pkg("ref", r_types, r_workloads, r_lithos, r_node, r_cluster,
          r_hierarchy, r_dvfs, r_slices, r_get_config)
PORT = Pkg("port", p_types, p_workloads, p_lithos, p_node, p_cluster,
           p_hierarchy, p_dvfs, p_slices, p_get_config)
PKGS = (REF, PORT)
PROFILES = ("a100_like", "h100_like")
ENGINES = ("ref", "vec")


def device(pkg, profile="a100_like", **changes):
    """``pkg``'s ``DeviceSpec`` of a profile; ``h100_like`` is the port's
    field values on either side."""
    if profile == "h100_like":
        dev = pkg.types.DeviceSpec(
            **dataclasses.asdict(p_types.DeviceSpec.h100_like()))
    else:
        dev = getattr(pkg.types.DeviceSpec, profile)()
    return dataclasses.replace(dev, **changes) if changes else dev


def node(pkg, n=2, profile="a100_like"):
    return pkg.types.NodeSpec.uniform(n, device(pkg, profile))


def cluster(pkg, n_nodes=2, n_devices=2, profile="a100_like"):
    return pkg.types.ClusterSpec.uniform(n_nodes, node(pkg, n_devices,
                                                       profile))


def hp_app(pkg, name="hp", rps=20.0, arch="olmo-1b", quota=0, seed=0,
           slo=0.0):
    return pkg.workloads.AppSpec(
        name, pkg.get_config(arch), "fwd_infer",
        priority=pkg.types.Priority.HIGH, rps=rps, prompt_mix=((128, 1.0),),
        batch=4, fusion=8, quota_slices=quota, seed=seed, slo_latency=slo)


def be_train(pkg, name="be", arch="llama3-8b", seq=2048, quota=0, seed=0):
    return pkg.workloads.AppSpec(
        name, pkg.get_config(arch), "train",
        priority=pkg.types.Priority.BEST_EFFORT, train_batch=2,
        train_seq=seq, fusion=8, quota_slices=quota, seed=seed)


def both(fn):
    """``fn(pkg)`` for the reference, then for the port, each after its
    package's kernel-id stream is reset."""
    out = []
    for pkg in PKGS:
        pkg.types.reset_kernel_ids()
        out.append(fn(pkg))
    return out


# -- a run's results as plain values -----------------------------------------

def records(res):
    return [(r.task.kid, r.task.client_id, r.task.queue_id, r.task.ordinal,
             r.t_submit, r.t_start, r.t_end, r.slices, r.freq,
             r.task.op_name, r.task.atom_of, r.task.phase,
             r.task.work.n_blocks, r.task.work.flops, r.task.work.bytes)
            for r in res.records]


def clients(res):
    return [(c.name, c.cid, int(c.priority), c.n_completed, c.latencies,
             c.req_latencies, c.slice_seconds, c.arrivals, c.kernels_per_job,
             c.kv_peak_bytes) for c in res.clients]


def ledger(led):
    if led is None:
        return None
    return {"home": sorted(led.home.items()),
            "current": sorted(led.current.items()),
            "records": [dataclasses.astuple(r) for r in led.ledger],
            "lent_client_seconds": led.lent_client_seconds,
            "n_migrations": led.n_migrations}


def coordinator(coord):
    if coord is None:
        return None
    return {"ledger": ledger(coord.ledger),
            "migration_log": list(coord.migration_log),
            "failed_members": sorted(coord.failed_members),
            "fault_log": list(coord.fault_log),
            "stranded": sorted(coord.stranded)}


def sim_result(res):
    return {"records": records(res), "clients": clients(res),
            "energy": res.energy, "busy": res.busy_slice_seconds}


def node_result(res):
    """Every field of a ``NodeResult``: its records, clients, energy,
    placements, migrations, ledger and coordinator logs, and each device's
    own result."""
    return {**sim_result(res), "router": res.router,
            "placement": list(res.placement),
            "final_placement": list(res.final_placement),
            "migrations": res.migrations, "horizon": res.horizon,
            "utilization": res.utilization,
            "per_device": [sim_result(r) for r in res.per_device],
            "coordinator": coordinator(res.coordinator)}


def cluster_result(res):
    """Every field of a ``ClusterResult``: as ``node_result``, plus each
    node's ``NodeResult``, the fragmentation series and the power log."""
    return {**sim_result(res), "router": res.router,
            "placement": [tuple(p) for p in res.placement],
            "migrations": res.migrations,
            "node_migrations": res.node_migrations,
            "utilization": res.utilization,
            "frag_series": list(res.frag_series),
            "frag_mean": res.frag_mean, "power_log": list(res.power_log),
            "per_node": [node_result(r) for r in res.per_node],
            "coordinator": coordinator(res.coordinator),
            "node_coordinators": [coordinator(c) for c in
                                  res.coordinator.node_coords]}
