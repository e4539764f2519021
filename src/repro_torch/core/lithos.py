"""LithOS facade: wire apps, quotas, policies, and the simulator together.

``evaluate(system, device, apps, ...)`` runs any of the nine systems
(lithos + 8 baselines) over the same workload mix and returns a SimResult —
the single entry point used by the benchmarks.
"""
from __future__ import annotations

import math
import os
from dataclasses import replace
from typing import Optional

from repro_torch.core import baselines
from repro_torch.core.scheduler import LithOSConfig, LithOSScheduler
from repro_torch.core.simulator import (Policy, SimResult, Simulator,
                                        make_simulator)
from repro_torch.core.types import (ClusterConfig, ClusterSpec, DeviceSpec,
                                    NodeConfig, NodeSpec, Priority, Quota)
from repro_torch.core.workloads import AppSpec

SYSTEMS = ("lithos", "mps", "mig", "limits", "timeslice", "priority",
           "reef", "tgs", "orion")


def quotas_from_apps(device: DeviceSpec, apps: list[AppSpec],
                     cids: Optional[list[int]] = None) -> dict[int, Quota]:
    """Derive per-client quotas: explicit quota_slices if given, else split
    the device proportionally among HP apps (BE gets 0 — it runs on steal).

    Quotas are guarantees, so they must be *coverable*: the running total
    never exceeds ``device.n_slices``.  Explicit quotas are reserved first
    (clamped to the device, in list order), then derived HP shares are
    handed out from whatever remains — an explicit request that fits on its
    own is never degraded to cover a derived share, and an oversubscribed
    request degrades to what is left rather than silently promising
    capacity that does not exist.
    """
    if cids is None:
        cids = list(range(len(apps)))
    cap = device.n_slices
    hp = [a for a in apps if a.priority == Priority.HIGH]
    slices: dict[int, int] = {}
    total = 0
    for cid, a in zip(cids, apps):        # pass 1: explicit guarantees
        if a.quota_slices > 0:
            s = min(a.quota_slices, cap - total)
            slices[cid] = s
            total += s
    left = cap - total
    share = max(1, left // len(hp)) if (hp and left > 0) else 0
    for cid, a in zip(cids, apps):        # pass 2: derived HP shares
        if cid in slices:
            continue
        s = share if a.priority == Priority.HIGH else 0
        s = min(s, cap - total)
        slices[cid] = s
        total += s
    return {cid: Quota(slices[cid], a.priority)
            for cid, a in zip(cids, apps)}


def partitions_from_apps(device: DeviceSpec, apps: list[AppSpec],
                         gpc_granularity: int = 0,
                         cids: Optional[list[int]] = None) -> dict[int, int]:
    """MIG-style partitions: HP apps only, rounded to GPC boundaries."""
    if cids is None:
        cids = list(range(len(apps)))
    quotas = quotas_from_apps(device, apps, cids=cids)
    prio = {cid: a.priority for cid, a in zip(cids, apps)}
    parts = {}
    for cid, q in quotas.items():
        if prio[cid] != Priority.HIGH:
            continue
        s = q.slices
        if gpc_granularity > 1:
            s = max(gpc_granularity,
                    int(math.floor(s / gpc_granularity)) * gpc_granularity)
        parts[cid] = s
    # MIG cannot oversubscribe: shrink to fit
    total = sum(parts.values())
    while total > device.n_slices and parts:
        big = max(parts, key=parts.get)
        parts[big] -= gpc_granularity if gpc_granularity > 1 else 1
        total = sum(parts.values())
    return parts


def make_policy(system: str, device: DeviceSpec, apps: list[AppSpec], *,
                lithos_config: Optional[LithOSConfig] = None,
                cids: Optional[list[int]] = None) -> Policy:
    if system == "lithos":
        return LithOSScheduler(device, quotas_from_apps(device, apps,
                                                        cids=cids),
                               lithos_config or LithOSConfig())
    if system == "mig":
        return baselines.MIGPolicy(
            partitions_from_apps(device, apps,
                                 gpc_granularity=device.n_slices // 8,
                                 cids=cids))
    if system == "limits":
        return baselines.LimitsPolicy(
            partitions_from_apps(device, apps, cids=cids))
    return baselines.make_baseline(system)


def default_engine() -> str:
    """Simulator engine unless callers say otherwise: the scalar reference
    ("ref"), overridable via the REPRO_SIM_ENGINE environment variable
    (parity CI legs run the whole suite under "vec" this way)."""
    return os.environ.get("REPRO_SIM_ENGINE", "ref")


def evaluate(system: str, device, apps: list[AppSpec], *,
             horizon: float = 30.0, seed: int = 0,
             lithos_config: Optional[LithOSConfig] = None,
             router: str = "least_loaded",
             node_config: Optional[NodeConfig] = None,
             cluster_config: Optional[ClusterConfig] = None,
             placement: Optional[list] = None,
             engine: Optional[str] = None,
             collect_records: bool = True,
             faults=None):
    """Run one system over one workload mix.

    ``device`` may be a :class:`DeviceSpec` (single-device path, returns a
    :class:`SimResult`), a :class:`NodeSpec` (multi-device path: the node
    layer routes tenants across devices with ``router`` and returns a
    ``NodeResult``; a 1-device node reproduces the DeviceSpec path
    bit-for-bit), or a :class:`ClusterSpec` (the cluster tier routes
    tenants across nodes — ``router`` additionally accepts ``frag_aware``
    — and returns a ``ClusterResult``; a 1-node cluster reproduces the
    NodeSpec path bit-for-bit).  ``node_config`` tunes the node-level
    lending protocol (cross-device TPC stealing); ``cluster_config`` the
    cluster tier (cross-node stealing + power cap, with its own
    ``node_config`` field for the member nodes); ``placement`` pins tenants
    to devices (or (node, device) pairs), bypassing the routers.

    ``engine`` picks the simulator core ("ref" | "vec"; default from
    :func:`default_engine`) — results are bit-for-bit identical, "vec" is
    faster.  ``collect_records=False`` drops per-kernel records (throughput
    benchmarks on huge traces).

    ``faults`` is a :class:`~repro_torch.core.types.FaultPlan`; its ``member``
    indices address flat device positions (0 for a bare DeviceSpec).
    ``faults=None`` is bit-for-bit the fault-free run."""
    if engine is None:
        engine = default_engine()
    if isinstance(device, ClusterSpec):
        from repro_torch.core.cluster import evaluate_cluster
        if node_config is not None:
            raise ValueError("pass node_config for a ClusterSpec via "
                             "cluster_config.node_config")
        return evaluate_cluster(system, device, apps, horizon=horizon,
                                seed=seed, lithos_config=lithos_config,
                                router=router,
                                cluster_config=cluster_config,
                                placement=placement, engine=engine,
                                collect_records=collect_records,
                                faults=faults)
    if cluster_config is not None:
        raise ValueError("cluster_config requires a ClusterSpec")
    if isinstance(device, NodeSpec):
        from repro_torch.core.node import evaluate_node
        return evaluate_node(system, device, apps, horizon=horizon,
                             seed=seed, lithos_config=lithos_config,
                             router=router, node_config=node_config,
                             placement=placement, engine=engine,
                             collect_records=collect_records,
                             faults=faults)
    if node_config is not None or placement is not None:
        raise ValueError("node_config/placement require a NodeSpec — a bare "
                         "DeviceSpec has no node layer to apply them to")
    policy = make_policy(system, device, apps, lithos_config=lithos_config)
    sim = make_simulator(device, apps, policy, engine=engine,
                         horizon=horizon, seed=seed,
                         collect_records=collect_records,
                         faults=(faults.events_for(0)
                                 if faults is not None else ()))
    res = sim.run()
    res.policy = policy               # expose learned state to benchmarks
    return res


def run_alone(device: DeviceSpec, app: AppSpec, *, horizon: float = 30.0,
              seed: int = 0, system: str = "lithos",
              lithos_config: Optional[LithOSConfig] = None,
              engine: Optional[str] = None) -> SimResult:
    """Solo run of one app — the normalization baseline the paper uses for
    'ideal' latency and throughput-alone."""
    solo = replace(app, quota_slices=device.n_slices)
    return evaluate(system, device, [solo], horizon=horizon, seed=seed,
                    lithos_config=lithos_config, engine=engine)
