"""Node layer: placement/routing of tenants across a multi-device node.

The paper's control plane manages one GPU; production serving runs fleets.
This layer generalizes the timing plane to a :class:`NodeSpec` of N devices:
each device runs its *own* policy instance (own SliceMap, quotas, predictor,
governor — no hidden cross-device state), and a router decides which device
each tenant's launch queue is pinned to.  Placement is per-client, not
per-job: a client's stream lives on one device for the simulation, matching
how serving frameworks pin model replicas (cross-device migration is the
opt-in lending protocol below, ``NodeConfig(migration=True)``).

Router policies (the algorithms live in
:func:`repro_torch.core.hierarchy.route`, shared with the cluster tier, which
routes tenants onto *nodes* with the same four policies):

* ``round_robin``   — arrival-order striping; the no-information baseline.
* ``least_loaded``  — greedy bin-packing of estimated demand (service
  seconds/second from the cost model; closed-loop trainers count as a full
  device since they soak whatever they are given), largest first, onto the
  device with the lowest capacity-normalized load.
* ``quota_aware``   — place by guarantee headroom: HP tenants go where their
  quota still fits un-oversubscribed (largest quota first); BE tenants are
  spread by count (they run on stolen capacity, so one per device beats two
  on one).
* ``affinity``      — tenants sharing a model architecture co-locate
  (predictor/right-sizer state is per-(queue, ordinal): co-located replicas
  of one model warm the same operating regime), groups balanced by load.

Client ids are node-global (the original app order), so a tenant keeps the
same workload random stream under every placement — router comparisons see
identical arrivals, not resampled ones.

Cross-device TPC stealing (the node-level lending protocol) is one
instantiation of the level-agnostic
:class:`~repro_torch.core.hierarchy.HierarchyCoordinator`: each device is a
:class:`SimMember` (simulator + policy), the coordinator interleaves their
event streams in global time order, samples per-device pressure at a fixed
epoch, and lends an idle device's capacity to a saturated one by hosting a
best-effort tenant's launch queue (drained at a kernel boundary, charged a
migration cost, predictor warmed from the source device's observations).
Every donation is recorded in a :class:`~repro_torch.core.slices.MemberLedger`
mirroring the SliceMap lend ledger, so conservation invariants extend
across devices.  With ``NodeConfig.migration=False`` (default) the
coordinator never intervenes and the run is bit-for-bit the historical
independent per-device evaluation.  The whole node is itself a member one
level up: :mod:`repro_torch.core.cluster` wraps a NodeCoordinator's stepping
interface to build clusters of nodes.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.hierarchy import (ROUTERS, HierarchyCoordinator, Member,
                                  Pressure, route)
from repro_torch.core.simulator import (Policy, SimResult, Simulator,
                                  make_simulator)
from repro_torch.core.slices import MemberLedger
from repro_torch.core.types import FaultPlan, NodeConfig, NodeSpec, Priority
from repro_torch.core.workloads import AppSpec, kv_floor_slices, mean_demand

_Pressure = Pressure                # historical name


_demand_cache: dict[tuple, float] = {}


def demand_estimate(app: AppSpec, device) -> float:
    """Expected device-utilization fraction of one tenant (cost-model based,
    the same calibration the benchmarks use).  Load-based routers price
    demand on ``devices[0]`` and normalize loads by each device's capacity
    (`_argmin_load`), which is exact for homogeneous nodes and proportional
    for heterogeneous ones.  Memoized: mean_demand samples whole job traces
    through the cost model and is invariant per (workload, device)."""
    if app.kind == "train" or app.rps <= 0:
        return 1.0                       # closed loop: soaks a device
    key = (app.name, app.cfg.name, app.kind, app.batch, app.fusion,
           tuple(app.prompt_mix), app.decode_tokens, app.seed, app.rps,
           device)            # DeviceSpec is frozen: full profile, not just
                              # n_slices (cost model prices flops/bw too)
    if key not in _demand_cache:
        _demand_cache[key] = min(1.0, app.rps * mean_demand(app, device))
    return _demand_cache[key]


def place(node: NodeSpec, apps: list[AppSpec],
          router: str = "least_loaded") -> list[int]:
    """Return the device index for each app.  Deterministic.  Thin wrapper
    over the level-agnostic :func:`repro_torch.core.hierarchy.route`: the node
    prices demand on ``devices[0]`` and hands the router plain capacities."""
    if router not in ROUTERS:
        raise ValueError(f"unknown router {router!r} (choose from {ROUTERS})")
    caps = [dev.n_slices for dev in node.devices]
    demands = None
    if router in ("least_loaded", "affinity") and node.n_devices > 1:
        demands = [demand_estimate(a, node.devices[0]) for a in apps]
    return route(caps, apps, router, demands=demands)


class SimMember(Member):
    """One device as a hierarchy member: a simulator plus its policy.

    The leaf adapter — pressure comes from the live client queues and the
    policy's SliceMap free-list, and the migration protocol maps straight
    onto the single-device plumbing (policy hold/drain/export + simulator
    detach/admit/release)."""

    def __init__(self, sim: Simulator, policy: Policy):
        self.sim = sim
        self.policy = policy
        self.capacity = sim.device.n_slices

    # -- event stream -------------------------------------------------------

    @property
    def horizon(self) -> float:
        return self.sim.horizon

    def start(self):
        self.sim.start()

    def peek_time(self):
        return self.sim.peek_time()

    def step_event(self) -> bool:
        return self.sim.step_event()

    @property
    def done(self) -> bool:
        return self.sim.done

    # -- fault domain --------------------------------------------------------

    def failed(self) -> bool:
        return getattr(self.sim, "dead", False)

    def has_faults(self) -> bool:
        return bool(getattr(self.sim, "_fault_events", ()))

    def can_host(self, client) -> bool:
        """A decode tenant's KV memory floor must fit on the surviving
        (non-retired) capacity — evacuation never lands a tenant where its
        live cache cannot."""
        if self.failed():
            return False
        surviving = self.sim.device.n_slices - self.sim.n_retired
        floor = kv_floor_slices(client.spec.cfg, self.sim.device,
                                getattr(client, "kv_bytes", 0.0))
        return floor <= surviving

    # -- pressure / placement ----------------------------------------------

    def _free(self) -> int:
        if self.failed():
            return 0                    # a dead device lends nothing
        sm = getattr(self.policy, "slices", None)
        if sm is not None:
            cnt = sm.counts()
            return cnt["owned_idle"] + cnt["pool_idle"]
        return self.sim.free_slices()

    def pressure(self) -> Pressure:
        sim = self.sim
        hp_depth = 0
        active = 0
        decode_depth = 0
        for c in sim.clients:
            cbs = c.cbs
            busy = (c.current is not None or bool(c.pending)
                    or c.outstanding > 0
                    or (cbs is not None and cbs.has_work))
            if busy or c.closed_loop:
                active += 1
            if c.priority == Priority.HIGH:
                depth = len(c.pending) + (1 if c.current is not None else 0)
                hp_depth += depth
                # decode HP backlog is latency-critical (per-token TBT):
                # continuous tenants' waiting requests + in-flight
                # iteration, and disaggregated-decode tenants' queues
                if cbs is not None:
                    decode_depth += len(cbs.waiting) + (
                        1 if c.current is not None else 0)
                elif c.spec.kind == "llm_decode":
                    decode_depth += depth
        return Pressure(hp_depth, self._free() / sim.device.n_slices, active,
                        decode_depth)

    def free_snapshot(self) -> list[int]:
        return [self._free()]

    # -- migration protocol -------------------------------------------------

    def supports_migration(self) -> bool:
        return self.policy.supports_migration

    def migration_candidates(self) -> list[int]:
        """BE clients eligible to move: have work and own no slices —
        ownership is static for a simulation, so a BE tenant with an
        *explicit* quota (legitimately granted by ``quotas_from_apps``) is
        pinned like an HP tenant.  Ascending cid — deterministic."""
        sm = getattr(self.policy, "slices", None)
        out = []
        for c in self.sim.clients:
            if c.priority == Priority.HIGH:
                continue
            if sm is not None and sm.owned_by(c.cid) > 0:
                continue
            if not (c.closed_loop or c.current is not None or c.pending):
                continue
            out.append(c.cid)
        return sorted(out)

    def begin_drain(self, cid: int):
        self.policy.hold_client(cid)

    def abort_drain(self, cid: int):
        self.policy.release_hold(cid)

    def drain_dead(self, cid: int) -> bool:
        return self.sim.done                # horizon beat the drain

    def drained(self, cid: int) -> bool:
        return self.policy.client_drained(cid)

    def clock(self, cid: int) -> float:
        return self.sim.now

    def export_client(self, cid: int):
        state = self.policy.export_client_state(cid)
        client = self.sim.detach_client(cid)
        return client, client.priority, state

    def admit_client(self, client, priority, state, *, after: float,
                     release_at: float):
        self.policy.import_client_state(client.cid, priority, state)
        self.sim.admit_client(client, after=after)
        self.policy.hold_client(client.cid)
        self.sim.schedule_release(client.cid, release_at)

    # -- invariants ---------------------------------------------------------

    def hosted_cids(self) -> list[int]:
        return [c.cid for c in self.sim.clients]

    def check(self):
        sm = getattr(self.policy, "slices", None)
        if sm is not None:
            sm.check()
        return True


class NodeCoordinator(HierarchyCoordinator):
    """The node tier: per-device simulators as interleaved event streams
    plus the node-level lending protocol (cross-device TPC stealing).

    All mechanism — the globally-earliest-event loop, epoch pressure
    sampling, hold -> drain -> export -> admit migration, ledger
    conservation — lives in :class:`HierarchyCoordinator`; this class binds
    it to devices and keeps the node-tier construction/read surface
    (``sims``, ``policies``, ``run() -> [SimResult]``).
    """

    def __init__(self, node: NodeSpec, placement, sims: list[Simulator],
                 policies: list[Policy],
                 config: Optional[NodeConfig] = None):
        self.node = node
        self.placement = placement
        self.sims = sims
        self.policies = policies
        super().__init__([SimMember(s, p) for s, p in zip(sims, policies)],
                         config or NodeConfig(),
                         MemberLedger(node.n_devices, placement))

    def run(self) -> list[SimResult]:
        self.run_loop()
        return [SimResult(sim) for sim in self.sims]


class NodeResult:
    """Aggregated result of one node run: per-device :class:`SimResult`s
    plus node-level metrics with the same read surface as a SimResult
    (``client(name)``, ``clients``, ``energy``, ``utilization``,
    ``records``)."""

    def __init__(self, node: NodeSpec, router: str, placement,
                 results: list[SimResult], policies: list,
                 coordinator: Optional[NodeCoordinator] = None):
        self.node = node
        self.router = router
        self.placement = placement
        self.per_device = results
        self.policies = policies
        self.policy = policies[0] if policies else None
        self.coordinator = coordinator
        self.ledger = coordinator.ledger if coordinator else None
        self.migrations = self.ledger.n_migrations if self.ledger else 0
        self.final_placement = (
            [self.ledger.current[cid] for cid in sorted(self.ledger.current)]
            if self.ledger else list(placement))
        self.horizon = results[0].horizon
        self.policy_name = results[0].policy_name
        self.energy = sum(r.energy for r in results)
        self.busy_slice_seconds = sum(r.busy_slice_seconds for r in results)
        self.records = [rec for r in results for rec in r.records]
        self.clients = sorted((c for r in results for c in r.clients),
                              key=lambda c: c.cid)

    @property
    def utilization(self) -> float:
        return self.busy_slice_seconds / (self.horizon
                                          * self.node.total_slices)

    def client(self, name: str):
        return next(c for c in self.clients if c.name == name)

    def device_of(self, name: str) -> int:
        """Device index a named client was *initially* placed on (see
        ``final_placement`` for where migration left it)."""
        cid = self.client(name).cid
        return self.placement[cid]


def build_node(system: str, node: NodeSpec, apps: list[AppSpec],
               placement: list[int], *, horizon: float, seed: int = 0,
               lithos_config=None, node_config: Optional[NodeConfig] = None,
               engine: str = "ref", collect_records: bool = True,
               cids: Optional[list[int]] = None,
               faults: Optional[FaultPlan] = None,
               fault_base: int = 0) -> NodeCoordinator:
    """Construct one node's simulators + policies and wrap them in a
    :class:`NodeCoordinator` (not yet run).

    ``cids`` optionally assigns each app a global client id (the cluster
    tier passes cluster-global ids so tenants keep their workload streams
    under any node assignment); default is app order, the node-global ids
    ``evaluate_node`` has always used.  With explicit cids the coordinator's
    ledger is keyed by those ids (a dict placement).

    ``faults`` is a :class:`FaultPlan` whose ``member`` indices address
    flat device positions; ``fault_base`` is this node's offset into that
    flat numbering (the cluster tier passes the device count of the nodes
    before it)."""
    from repro_torch.core.lithos import make_policy

    assert len(placement) == len(apps) and \
        all(0 <= d < node.n_devices for d in placement)
    ids = list(range(len(apps))) if cids is None else list(cids)
    sims: list[Simulator] = []
    policies = []
    for d, dev in enumerate(node.devices):
        on_d = [i for i, p in enumerate(placement) if p == d]
        idx = [ids[i] for i in on_d]
        dev_apps = [apps[i] for i in on_d]
        policy = make_policy(system, dev, dev_apps,
                             lithos_config=lithos_config, cids=idx)
        sim = make_simulator(dev, dev_apps, policy, engine=engine,
                             horizon=horizon, seed=seed, cids=idx,
                             collect_records=collect_records,
                             faults=(faults.events_for(fault_base + d)
                                     if faults is not None else ()))
        sims.append(sim)
        policies.append(policy)
    ledger_placement = (list(placement) if cids is None else
                        {ids[i]: placement[i] for i in range(len(apps))})
    return NodeCoordinator(node, ledger_placement, sims, policies,
                           config=node_config)


def evaluate_node(system: str, node: NodeSpec, apps: list[AppSpec], *,
                  horizon: float = 30.0, seed: int = 0,
                  lithos_config=None, router: str = "least_loaded",
                  node_config: Optional[NodeConfig] = None,
                  placement: Optional[list[int]] = None,
                  engine: str = "ref",
                  collect_records: bool = True,
                  faults: Optional[FaultPlan] = None) -> NodeResult:
    """Route ``apps`` across the node and run one simulator + policy
    instance per device as interleaved event streams under a
    :class:`NodeCoordinator`.  With migration disabled (the default
    ``node_config``) devices share nothing, so the interleaved run is
    exactly the historical independent per-device evaluation; with
    ``node_config.migration=True`` the coordinator lends idle devices'
    capacity to saturated ones by migrating best-effort launch queues.

    ``placement`` overrides the router's decision (benchmarks pin
    adversarial placements with it)."""
    if placement is None:
        placement = place(node, apps, router)
    coord = build_node(system, node, apps, list(placement), horizon=horizon,
                       seed=seed, lithos_config=lithos_config,
                       node_config=node_config, engine=engine,
                       collect_records=collect_records, faults=faults)
    results = coord.run()
    return NodeResult(node, router, list(placement), results,
                      coord.policies, coordinator=coord)
