"""Cluster tier: the node machinery instantiated one level up.

A :class:`~repro_torch.core.types.ClusterSpec` is N nodes behind one
placement and power plane.  Everything the node tier built — pressure
sampling, placement routing, the drain/export/admit migration pipeline,
ledger conservation — is reused verbatim from
:mod:`repro_torch.core.hierarchy`; the only new code here is the
:class:`NodeMember` adapter (a whole
:class:`~repro_torch.core.node.NodeCoordinator` as one member), the
fragmentation-aware placement policy, and the cluster power manager.

Three cluster-level mechanisms compose:

* **Placement** (:func:`place_cluster`) — the four node routers generalize
  to nodes (capacities = node slice totals), plus ``frag_aware``:
  best-fit-decreasing of HP guarantees onto the flat device list, which
  minimizes the FRAG-style stranded-free-capacity score
  (:func:`~repro_torch.core.hierarchy.fragmentation`) and consolidates load so
  whole devices stay idle (the power win feeds the cap below).
* **Cross-node stealing** — the node tier's lending protocol, at node
  granularity: node pressure is the aggregate of its devices', and a
  saturated node's best-effort tenant migrates to an idle node through the
  exact export/import path devices use, charged a (larger)
  ``migration_cost``.  Intra-node stealing keeps running underneath; the
  coordinator's frozen set keeps the two tiers off the same client.
* **Power capping** (:class:`ClusterPowerManager`) — at every cluster
  epoch, per-device DVFS f-states are planned against
  ``ClusterConfig.power_cap`` with
  :func:`~repro_torch.core.dvfs.plan_power_budget` (best-effort-only devices
  throttle first; HP devices keep ``power_hp_floor``), applied through the
  simulator's f-switch machinery and pinned via the governor's ``f_cap``.

A 1-node cluster with no cluster-level mechanisms is bit-for-bit
``evaluate_node`` — the same parity contract the node tier keeps with the
bare device, one level up (DESIGN.md §7).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.dvfs import plan_power_budget
from repro_torch.core.hierarchy import (ROUTERS, HierarchyCoordinator,
                                        Member, Pressure, fragmentation,
                                        route)
from repro_torch.core.node import (NodeCoordinator, NodeResult, SimResult,
                                   build_node, demand_estimate, place)
from repro_torch.core.slices import MemberLedger
from repro_torch.core.types import (ClusterConfig, ClusterSpec, FaultPlan,
                                    Priority)
from repro_torch.core.workloads import AppSpec

CLUSTER_ROUTERS = ROUTERS + ("frag_aware",)


class NodeMember(Member):
    """One node as a hierarchy member: a whole :class:`NodeCoordinator`.

    The recursion that makes the hierarchy level-agnostic — a node's
    coordinator already exposes the event-stream interface
    (``start``/``peek_time``/``step_event``) its own device members do, so
    adapting it is aggregation plus routing protocol calls to the device
    currently hosting the client (the node ledger knows)."""

    def __init__(self, coord: NodeCoordinator):
        self.coord = coord
        self.capacity = coord.node.total_slices

    # -- event stream -------------------------------------------------------

    @property
    def horizon(self) -> float:
        return self.coord.sims[0].horizon

    def start(self):
        self.coord.start()

    def peek_time(self):
        return self.coord.peek_time()

    def step_event(self) -> bool:
        return self.coord.step_event()

    @property
    def done(self) -> bool:
        return self.coord.done

    def invalidate_peeks(self):
        self.coord.invalidate_peeks()

    # -- fault domain --------------------------------------------------------

    def failed(self) -> bool:
        """A node is dead only when every device below it is."""
        ms = self.coord.members
        return bool(ms) and all(m.failed() for m in ms)

    def has_faults(self) -> bool:
        return any(m.has_faults() for m in self.coord.members)

    def can_host(self, client) -> bool:
        return any(not m.failed() and m.can_host(client)
                   for m in self.coord.members)

    # -- pressure / placement ----------------------------------------------

    def pressure(self) -> Pressure:
        hp_depth = active = free = decode_depth = 0
        for m in self.coord.members:
            p = m.pressure()
            hp_depth += p.hp_depth
            active += p.active
            decode_depth += p.decode_depth
            free += m._free()
        return Pressure(hp_depth, free / self.capacity, active, decode_depth)

    def free_snapshot(self) -> list[int]:
        return [f for m in self.coord.members for f in m.free_snapshot()]

    # -- migration protocol -------------------------------------------------

    def _host(self, cid: int):
        """Device member currently hosting ``cid`` (per the node ledger)."""
        return self.coord.members[self.coord.ledger.current[cid]]

    def supports_migration(self) -> bool:
        return all(m.supports_migration() for m in self.coord.members)

    def migration_candidates(self) -> list[int]:
        """Union of the devices' candidates, minus any client the node's
        own coordinator is mid-drain on."""
        busy = ({self.coord._pending.cid}
                if self.coord._pending is not None else set())
        out = set()
        for m in self.coord.members:
            out.update(m.migration_candidates())
        return sorted(out - busy - self.coord.frozen)

    def begin_drain(self, cid: int):
        self.coord.frozen.add(cid)      # keep the node tier off this client
        self._host(cid).begin_drain(cid)

    def abort_drain(self, cid: int):
        self._host(cid).abort_drain(cid)
        self.coord.frozen.discard(cid)

    def drain_dead(self, cid: int) -> bool:
        return self._host(cid).drain_dead(cid)

    def drained(self, cid: int) -> bool:
        return self._host(cid).drained(cid)

    def clock(self, cid: int) -> float:
        return self._host(cid).clock(cid)

    def export_client(self, cid: int):
        host = self._host(cid)
        now = host.clock(cid)
        out = host.export_client(cid)
        self.coord.ledger.drop(cid, now)    # left this node's scope
        self.coord.frozen.discard(cid)
        return out

    def admit_client(self, client, priority, state, *, after: float,
                     release_at: float):
        ms = self.coord.members
        # dead devices never receive admits; among the survivors, prefer
        # one whose capacity can hold the client's KV floor (can_host),
        # then the most free (capacity-normalized), ties to the lowest id
        live = [i for i in range(len(ms)) if not ms[i].failed()]
        assert live, "admit_client on a fully dead node"
        fit = [i for i in live if ms[i].can_host(client)]
        cands = fit or live
        d = min(cands, key=lambda i: (-ms[i]._free() / ms[i].capacity, i))
        ms[d].admit_client(client, priority, state, after=after,
                           release_at=release_at)
        self.coord.ledger.adopt(client.cid, d)

    # -- invariants ---------------------------------------------------------

    def hosted_cids(self) -> list[int]:
        return [cid for m in self.coord.members for cid in m.hosted_cids()]

    def check(self):
        return self.coord.check()


# ---------------------------------------------------------------------------
# Cluster placement
# ---------------------------------------------------------------------------

def _slice_requests(cluster: ClusterSpec, apps: list[AppSpec]) -> list[int]:
    """Placement-time slice request per app: explicit quotas exact, derived
    HP shares estimated against the modal device, BE = 0 (stolen capacity).
    These are the 'tenant demand distribution' the fragmentation metric
    scores free-lists against."""
    caps = [d.n_slices for node in cluster.nodes for d in node.devices]
    n_hp = sum(1 for a in apps if a.priority == Priority.HIGH)
    n_dev = len(caps)
    ref = max(caps)
    per_dev_hp = max(1, -(-n_hp // n_dev))          # ceil: HP per device
    out = []
    for a in apps:
        if a.priority != Priority.HIGH:
            out.append(0)
        elif a.quota_slices > 0:
            out.append(min(a.quota_slices, ref))
        else:
            out.append(max(1, ref // per_dev_hp))
    return out


def place_cluster(cluster: ClusterSpec, apps: list[AppSpec],
                  router: str = "frag_aware",
                  node_router: str = "least_loaded"
                  ) -> list[tuple[int, int]]:
    """Return (node, device) for each app.  Deterministic.

    The four node routers generalize verbatim (members = nodes, capacities
    = node slice totals; demand priced on ``nodes[0].devices[0]``), then
    ``node_router`` places within each node.  ``frag_aware`` instead works
    on the flat device list: best-fit-decreasing of HP guarantees — each
    guarantee goes to the device with the *least* free capacity that still
    fits it whole, so large contiguous blocks survive for large tenants
    (minimizing :func:`~repro_torch.core.hierarchy.fragmentation`) and load
    consolidates onto few devices (idle devices stay cheap under the power
    cap).  BE tenants are spread by count, least-loaded-node first."""
    if router not in CLUSTER_ROUTERS:
        raise ValueError(f"unknown cluster router {router!r} "
                         f"(choose from {CLUSTER_ROUTERS})")
    n_apps = len(apps)
    if cluster.n_nodes == 1 and router != "frag_aware":
        node_pl = [0] * n_apps
    elif router != "frag_aware":
        caps = [node.total_slices for node in cluster.nodes]
        demands = None
        if router in ("least_loaded", "affinity"):
            ref = cluster.nodes[0].devices[0]
            demands = [demand_estimate(a, ref) for a in apps]
        node_pl = route(caps, apps, router, demands=demands)
    else:
        return _place_frag_aware(cluster, apps)
    out: list[tuple[int, int]] = [(0, 0)] * n_apps
    for ni, node in enumerate(cluster.nodes):
        sel = [i for i in range(n_apps) if node_pl[i] == ni]
        dev_pl = place(node, [apps[i] for i in sel], node_router)
        for i, d in zip(sel, dev_pl):
            out[i] = (ni, d)
    return out


def _place_frag_aware(cluster: ClusterSpec,
                      apps: list[AppSpec]) -> list[tuple[int, int]]:
    devs = [(ni, di, dev.n_slices)
            for ni, node in enumerate(cluster.nodes)
            for di, dev in enumerate(node.devices)]
    free = [cap for _, _, cap in devs]
    requests = _slice_requests(cluster, apps)
    out: list[tuple[int, int]] = [(0, 0)] * len(apps)
    hp_order = sorted((i for i, a in enumerate(apps)
                       if a.priority == Priority.HIGH),
                      key=lambda i: (-requests[i], i))
    for i in hp_order:
        fits = [d for d in range(len(devs)) if free[d] >= requests[i]]
        if fits:                            # best fit: tightest hole
            d = min(fits, key=lambda d: (free[d], d))
        else:                               # nothing fits whole: most free
            d = min(range(len(devs)), key=lambda d: (-free[d], d))
        out[i] = devs[d][:2]
        free[d] = max(0, free[d] - requests[i])
    # BE: spread by count (one per device beats two on one — they live on
    # stolen capacity), preferring devices with the most residual free
    be_count = [0] * len(devs)
    for i, a in enumerate(apps):
        if a.priority == Priority.HIGH:
            continue
        d = min(range(len(devs)),
                key=lambda d: (be_count[d], -free[d], d))
        out[i] = devs[d][:2]
        be_count[d] += 1
    return out


# ---------------------------------------------------------------------------
# Cluster power manager (per-device DVFS under one budget)
# ---------------------------------------------------------------------------

class ClusterPowerManager:
    """Coordinates per-device DVFS f-states under ``power_cap`` watts.

    An epoch hook on the cluster coordinator: at each epoch it snapshots
    every device's busy-slice count and HP backlog, plans per-device
    frequency caps with :func:`~repro_torch.core.dvfs.plan_power_budget`, and
    applies them — through the governor's ``f_cap`` where a policy runs its
    own DVFS (the local governor keeps optimizing underneath the cap), and
    directly through the simulator's f-switch machinery otherwise.  Mutates
    members, so its presence forces the interleaved run loop."""

    def __init__(self, device_members, cap: float, hp_floor: float):
        self.members = list(device_members)     # flat SimMembers
        self.specs = [m.sim.device for m in self.members]
        self.cap = cap
        self.hp_floor = hp_floor
        #: (t, projected_watts_before, projected_watts_after, min_f) per epoch
        self.log: list[tuple[float, float, float, float]] = []

    def __call__(self, now: float):
        active = [m.sim.held_slices() for m in self.members]
        hp = [m.pressure().hp_depth > 0 for m in self.members]
        before = sum(s.power(a, m.sim.freq) for s, a, m in
                     zip(self.specs, active, self.members))
        fs = plan_power_budget(self.specs, active, hp, self.cap,
                               hp_floor=self.hp_floor)
        for m, f in zip(self.members, fs):
            gov = getattr(m.policy, "governor", None)
            drives_dvfs = (gov is not None
                           and getattr(m.policy, "cfg", None) is not None
                           and getattr(m.policy.cfg, "dvfs", False))
            if gov is not None:
                gov.f_cap = f
            if not drives_dvfs:
                m.sim.set_frequency(f)
        after = sum(s.power(a, f) for s, a, f in
                    zip(self.specs, active, fs))
        self.log.append((now, before, after, min(fs)))


# ---------------------------------------------------------------------------
# Fragmentation sampling
# ---------------------------------------------------------------------------

class FragSampler:
    """Samples cluster-wide free-lists on the epoch grid and scores them
    with :func:`~repro_torch.core.hierarchy.fragmentation`.

    Registered as a read-only *member hook*: in the interleaved loop every
    member is sampled at each global epoch; in the sequential fast path
    each member is sampled as its own run crosses the same epoch grid —
    identical values either way, because uncoupled members share no
    state."""

    def __init__(self, members, demands: list[int], epoch: float):
        self.members = list(members)
        self.demands = [d for d in demands if d > 0]
        self.epoch = epoch
        self._free: dict[int, dict[int, list[int]]] = {}

    def hook(self, mi: int, t: float):
        k = round(t / self.epoch)
        self._free.setdefault(k, {})[mi] = self.members[mi].free_snapshot()

    def series(self) -> list[tuple[float, float]]:
        out = []
        for k in sorted(self._free):
            row = self._free[k]
            if len(row) != len(self.members):
                continue                    # incomplete epoch (run edge)
            free = [f for mi in range(len(self.members)) for f in row[mi]]
            out.append((k * self.epoch, fragmentation(free, self.demands)))
        return out

    @property
    def mean(self) -> float:
        s = self.series()
        return sum(f for _, f in s) / len(s) if s else 0.0


# ---------------------------------------------------------------------------
# Coordinator + result + entry point
# ---------------------------------------------------------------------------

class ClusterCoordinator(HierarchyCoordinator):
    """The cluster tier: member nodes as interleaved event streams plus
    cross-node stealing, cluster power capping and fragmentation sampling.

    All mechanism is inherited from :class:`HierarchyCoordinator`; this
    class binds it to :class:`NodeMember`s and registers the power/frag
    hooks."""

    def __init__(self, cluster: ClusterSpec, placement: dict,
                 node_coords: list[NodeCoordinator],
                 config: Optional[ClusterConfig] = None):
        self.cluster = cluster
        self.node_coords = node_coords
        cfg = config or ClusterConfig()
        super().__init__([NodeMember(c) for c in node_coords], cfg,
                         MemberLedger(cluster.n_nodes, placement))
        self.device_members = [m for c in node_coords for m in c.members]
        self.power_manager: Optional[ClusterPowerManager] = None
        self.frag_sampler: Optional[FragSampler] = None
        if cfg.power_cap > 0:
            self.power_manager = ClusterPowerManager(
                self.device_members, cfg.power_cap, cfg.power_hp_floor)
            self.epoch_hooks.append(self.power_manager)

    def enable_frag_sampling(self, demands: list[int]):
        self.frag_sampler = FragSampler(self.members, demands,
                                        self.config.epoch)
        self.member_hooks.append(self.frag_sampler.hook)


class ClusterResult:
    """Aggregated result of one cluster run: per-node :class:`NodeResult`s
    plus cluster-level metrics with the familiar read surface
    (``client(name)``, ``clients``, ``energy``, ``utilization``,
    ``records``) and the cluster-only ones (``frag_series``,
    ``power_log``, cluster vs intra-node migration counts)."""

    def __init__(self, cluster: ClusterSpec, router: str,
                 placement: list[tuple[int, int]],
                 per_node: list[NodeResult],
                 coordinator: ClusterCoordinator):
        self.cluster = cluster
        self.router = router
        self.placement = placement
        self.per_node = per_node
        self.coordinator = coordinator
        self.ledger = coordinator.ledger
        self.migrations = self.ledger.n_migrations          # cross-node
        self.node_migrations = sum(r.migrations for r in per_node)
        self.horizon = per_node[0].horizon
        self.energy = sum(r.energy for r in per_node)
        self.busy_slice_seconds = sum(r.busy_slice_seconds
                                      for r in per_node)
        self.records = [rec for r in per_node for rec in r.records]
        self.clients = sorted((c for r in per_node for c in r.clients),
                              key=lambda c: c.cid)
        fs = coordinator.frag_sampler
        self.frag_series = fs.series() if fs else []
        self.frag_mean = fs.mean if fs else 0.0
        pm = coordinator.power_manager
        self.power_log = pm.log if pm else []

    @property
    def utilization(self) -> float:
        return self.busy_slice_seconds / (self.horizon
                                          * self.cluster.total_slices)

    def client(self, name: str):
        return next(c for c in self.clients if c.name == name)

    def node_of(self, name: str) -> int:
        """Node a named client was *initially* placed on (the cluster
        ledger's ``current`` has where migration left it)."""
        cid = self.client(name).cid
        return self.placement[cid][0]


def evaluate_cluster(system: str, cluster: ClusterSpec,
                     apps: list[AppSpec], *,
                     horizon: float = 30.0, seed: int = 0,
                     lithos_config=None, router: str = "frag_aware",
                     node_router: str = "least_loaded",
                     cluster_config: Optional[ClusterConfig] = None,
                     placement: Optional[list[tuple[int, int]]] = None,
                     engine: str = "ref",
                     collect_records: bool = True,
                     frag_sample: bool = True,
                     faults: Optional[FaultPlan] = None) -> ClusterResult:
    """Place ``apps`` across the cluster and run one
    :class:`NodeCoordinator` per node under a
    :class:`ClusterCoordinator`.

    Client ids are cluster-global (the original app order), so a tenant
    keeps the same workload random stream under every placement — exactly
    the node tier's contract, one level up.  ``placement`` pins
    (node, device) per app, bypassing both routers.  With no cluster-level
    mechanisms enabled (migration off, no power cap) member nodes are
    uncoupled and run sequentially — bit-for-bit the per-node evaluation;
    a 1-node cluster then reproduces ``evaluate_node`` exactly.

    ``faults`` addresses devices by *flat* index across the cluster
    (node 0's devices first, then node 1's, ...)."""
    cfg = cluster_config or ClusterConfig()
    if placement is None:
        placement = place_cluster(cluster, apps, router, node_router)
    assert len(placement) == len(apps)
    node_coords = []
    fault_base = 0
    for ni, node in enumerate(cluster.nodes):
        sel = [i for i, (n, _) in enumerate(placement) if n == ni]
        coord = build_node(system, node, [apps[i] for i in sel],
                           [placement[i][1] for i in sel],
                           horizon=horizon, seed=seed,
                           lithos_config=lithos_config,
                           node_config=cfg.node_config, engine=engine,
                           collect_records=collect_records, cids=sel,
                           faults=faults, fault_base=fault_base)
        fault_base += node.n_devices
        node_coords.append(coord)
    coord = ClusterCoordinator(
        cluster, {i: n for i, (n, _) in enumerate(placement)},
        node_coords, cfg)
    if frag_sample:
        coord.enable_frag_sampling(_slice_requests(cluster, apps))
    coord.run_loop()
    per_node = [NodeResult(node, node_router, nc.placement,
                           [SimResult(s) for s in nc.sims], nc.policies,
                           coordinator=nc)
                for node, nc in zip(cluster.nodes, node_coords)]
    return ClusterResult(cluster, router, list(placement), per_node, coord)
