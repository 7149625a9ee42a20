"""Preemption planner: cheapest victim set that schedules the blocked
high-priority demand onto existing capacity — or a proof none exists.

The kube-scheduler's preemption loop (pkg/scheduler/framework/preemption)
picks victims per pod, node by node. Scoped to the capacity the
autoscaler already owns, the question batches: candidate victim sets are
PREFIXES of one deterministic ascending (priority, cost, namespace,
name) victim order, and every prefix is evaluated in ONE device call
(``CUDASolver.dispatch_preempt``: scheduling/preempt_torch.py, the K8
kernel on the card) — consolidation's absorption scan with usage
refunded into the tables instead of nodes masked out of them. The first
feasible prefix is the cheapest: it evicts the fewest, lowest-priority,
smallest pods.

A copy of the reference package's ``scheduling/preempt.py`` with one
change of routing: every search runs on the solver's
``dispatch_preempt``, which runs or raises. The reference's numpy twin
and its host fallback are not copied, so a failed or missing launch is
never turned into a host verdict. ``PreemptionPlanner()`` builds a
``CUDASolver()`` (cuda by default); ``CUDASolver(device="cpu")``
answers from the plain K8.

Hard gates (never victims, never over-promise):

- daemonset pods and ``is_critical`` pods are never victims;
- victims must rank strictly below the LOWEST blocked demand priority;
- PDB allowances are consumed cumulatively in victim order — a pod
  whose eviction would breach a budget is skipped, and everything the
  chosen prefix evicts fits the budgets by construction;
- demand pods with ``preemptionPolicy: Never`` never trigger a search;
- demand pods carrying required topology constraints are excluded (the
  greedy fill cannot honor spread, so a verdict including them could
  evict victims without scheduling the pod).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

# the solver package first: it imports models.delta, which imports it
# back (the cycle closes only in this order)
from ..solver.types import SchedulingSnapshot  # isort: skip
from ..apis.objects import Pod, is_critical
from ..controllers.pdb import pdb_state, take_allowance
from ..models.delta import full_existing_encode
from ..models.encoding import encode_snapshot

log = logging.getLogger(__name__)

#: candidate-prefix cap per search — one device lane each. Deeper
#: preemption (65+ victims in one round) is out of scope by design; the
#: truncation is logged, never silent, and the next reconcile retries
#: with the survivors.
MAX_LANES = 64

@dataclass(frozen=True)
class PreemptCommand:
    """The canonical applied form of a feasible verdict — what the
    provisioner executes, and the byte string the cross-backend fuzz
    compares. Evictions keep victim order (= eviction order); demand is
    name-sorted (the solve decides placement, not the command)."""
    #: (namespace, name, node_name) per victim, in eviction order
    evictions: Tuple[Tuple[str, str, str], ...]
    #: full names of the demand pods the evictions unblock
    demand: Tuple[str, ...]

    def to_bytes(self) -> bytes:
        return repr((self.evictions, self.demand)).encode("utf-8")


@dataclass
class PreemptionVerdict:
    feasible: bool
    #: chosen victim prefix (empty unless feasible)
    victims: Tuple[Pod, ...] = ()
    #: demand pods the search ran for
    demand: Tuple[Pod, ...] = ()
    #: candidate prefixes evaluated
    lanes: int = 0
    #: per-lane leftover demand pods (parity evidence)
    leftovers: Tuple[int, ...] = ()
    #: "device" (the lanes ran on the solver) | "none" (skipped)
    backend: str = "none"
    #: why the search was skipped (empty when it ran)
    reason: str = ""
    command: Optional[PreemptCommand] = None


def victim_sort_key(pod: Pod) -> Tuple:
    """Ascending eviction preference: lowest priority first, then the
    smallest footprint (cheapest disruption), then name — equal-priority
    ties are deterministic by construction."""
    r = pod.effective_requests()
    return (getattr(pod, "priority", 0), r.get("cpu", 0),
            r.get("memory", 0), pod.metadata.namespace, pod.metadata.name)


class PreemptionPlanner:
    """One search per provisioning round, consulted AFTER the base solve
    leaves priority-bearing pods unschedulable and BEFORE the controller
    gives up on them. Owns no kube writes — it returns a verdict; the
    provisioner applies it (evict, re-solve, nominate, requeue)."""

    def __init__(self, solver=None, metrics=None):
        if solver is None:
            from ..solver.cuda import CUDASolver
            solver = CUDASolver()
        self.solver = solver
        #: optional metrics registry (anything with ``inc``)
        self.metrics = metrics
        self.max_lanes = MAX_LANES
        #: wall ms of the last search that ran its lanes: victims (the
        #: demand and victim walk, PDB budgets), encode (the demand
        #: encoding and the existing tables), freed (the refund stack),
        #: device (the lane batch: h2d, launch, d2h) and verdict
        self.last_phase_stats: dict = {}

    def _inc(self, name: str, value: float = 1.0, **labels) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, value=value, labels=labels or None)

    def _skip(self, reason: str, demand: Tuple[Pod, ...] = ()) \
            -> PreemptionVerdict:
        self._inc("karpenter_solver_preempt_verdicts_total",
                  verdict="skipped")
        return PreemptionVerdict(feasible=False, demand=demand,
                                 reason=reason)

    # ------------------------------------------------------------------
    def plan(self, snapshot: SchedulingSnapshot,
             unschedulable: Sequence[str], state) -> PreemptionVerdict:
        """``unschedulable``: full names the base solve could not place.
        ``state``: the ClusterState (bound pods + PDB universe)."""
        t_in = time.perf_counter()
        blocked = set(unschedulable)
        demand: List[Pod] = []
        for pod in snapshot.pods:
            if pod.full_name() not in blocked:
                continue
            if getattr(pod, "priority", 0) <= 0:
                continue
            if getattr(pod, "preemption_policy", "") == "Never":
                continue
            if pod.topology_spread or pod.pod_affinity:
                log.info("preempt: %s excluded from demand (required "
                         "topology constraints)", pod.full_name())
                continue
            demand.append(pod)
        if not demand:
            return self._skip("no eligible demand")
        demand.sort(key=lambda p: p.full_name())
        floor = min(getattr(p, "priority", 0) for p in demand)

        existing = list(snapshot.existing_nodes)
        npos = {node.name: ei for ei, node in enumerate(existing)}
        if not npos:
            return self._skip("no existing nodes", tuple(demand))

        bound = state.bound_pods_by_node()
        candidates: List[Pod] = []
        for node_name, pods in bound.items():
            if node_name not in npos:
                continue
            for pod in pods:
                if not pod.node_name:
                    continue  # nominated, not bound: nothing to evict
                if pod.owner_kind == "DaemonSet" or is_critical(pod):
                    continue
                if getattr(pod, "priority", 0) >= floor:
                    continue
                candidates.append(pod)
        candidates.sort(key=victim_sort_key)

        # cumulative PDB budgets, consumed in victim order: the chosen
        # prefix can never over-draw a budget
        pdbs = pdb_state(state.kube)
        victims = [p for p in candidates if take_allowance(pdbs, p)]
        if not victims:
            return self._skip("no eligible victims", tuple(demand))
        if len(victims) > self.max_lanes:
            log.info("preempt: victim list truncated to %d lanes "
                     "(%d candidates dropped)", self.max_lanes,
                     len(victims) - self.max_lanes)
            victims = victims[:self.max_lanes]

        # one demand-only encoding shares the base solver's derivation
        # (canonical group order, existing tables)
        t0 = time.perf_counter()
        demand_snap = SchedulingSnapshot(
            pods=demand, nodepools=snapshot.nodepools,
            existing_nodes=existing,
            daemon_overheads=snapshot.daemon_overheads,
            zones=snapshot.zones,
            priority_classes=getattr(snapshot, "priority_classes", ()))
        enc = encode_snapshot(demand_snap)
        ex_alloc, ex_used, ex_compat = full_existing_encode(enc, existing)

        t1 = time.perf_counter()
        dpos = {d: i for i, d in enumerate(enc.dims)}
        B = len(victims)
        freed = np.zeros((B, len(existing), len(enc.dims)), dtype=np.int64)
        refund = np.zeros_like(freed[0])
        for b, pod in enumerate(victims):
            ei = npos[pod.node_name]
            for key, qty in pod.effective_requests().items():
                di = dpos.get(key)
                if di is not None:
                    refund[ei, di] += qty
            freed[b] = refund

        t2 = time.perf_counter()
        leftovers = self.solver.dispatch_preempt(
            ex_alloc=ex_alloc, ex_used=ex_used, ex_compat=ex_compat,
            R=enc.R, n=enc.n, freed=freed)
        t3 = time.perf_counter()

        chosen: Tuple[Pod, ...] = ()
        for b in range(B):
            if leftovers[b] == 0:
                chosen = tuple(victims[:b + 1])
                break
        feasible = bool(chosen)
        self._inc("karpenter_solver_preempt_verdicts_total",
                  verdict="feasible" if feasible else "infeasible")
        command = None
        if feasible:
            self._inc("karpenter_solver_preempt_victims_total",
                      value=float(len(chosen)))
            command = PreemptCommand(
                evictions=tuple((p.metadata.namespace, p.metadata.name,
                                 p.node_name) for p in chosen),
                demand=tuple(p.full_name() for p in demand))
        verdict = PreemptionVerdict(
            feasible=feasible, victims=chosen, demand=tuple(demand),
            lanes=B, leftovers=tuple(int(v) for v in leftovers),
            backend="device", command=command)
        t4 = time.perf_counter()
        self.last_phase_stats = dict(
            victims_ms=(t0 - t_in) * 1e3,
            encode_ms=(t1 - t0) * 1e3, freed_ms=(t2 - t1) * 1e3,
            device_ms=(t3 - t2) * 1e3, verdict_ms=(t4 - t3) * 1e3)
        return verdict
