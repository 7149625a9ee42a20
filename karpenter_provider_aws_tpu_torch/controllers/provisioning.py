"""Provisioning controller: pending pods -> Solver -> NodeClaims.

The core ``provisioning.Provisioner`` (SURVEY §3.2): batch pending pods,
build the scheduling snapshot (nodepool specs with resolved instance types,
existing capacity from cluster state, daemonset overheads), run the
pluggable Solver, create NodeClaim CRs, and nominate pods to their planned
nodes so the next round doesn't double-provision.
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from ..apis import labels as L
from ..apis.objects import NodeClaim, NodePool, Pod, resolve_pod_priorities
from ..apis.requirements import Requirements
from ..apis.resources import Resources
from ..cloudprovider.provider import CloudProvider
from ..fake.kube import FakeKube
from ..solver.types import (DaemonOverhead, NewNodeClaim, NodePoolSpec,
                            SchedulingSnapshot, Solver, SolveResult)
from ..state.cluster import ClusterState

log = logging.getLogger(__name__)
_claim_seq = itertools.count(1)


@dataclass
class ProvisioningResult:
    created_claims: List[NodeClaim] = field(default_factory=list)
    nominated: Dict[str, str] = field(default_factory=dict)
    unschedulable: Dict[str, str] = field(default_factory=dict)
    solve_duration_s: float = 0.0
    #: victim full_name -> node it was evicted from (preemption applied
    #: this round); empty when no search ran or the verdict was negative
    preempted: Dict[str, str] = field(default_factory=dict)
    #: the round's PreemptionVerdict (None = search not consulted)
    preempt: object = None


class Provisioner:
    def __init__(self, kube: FakeKube, state: ClusterState,
                 cloudprovider: CloudProvider, solver: Solver,
                 metrics=None, clock=time.time,
                 batch_window_s: float = 0.0,
                 preempt_planner=None):
        self.kube = kube
        self.state = state
        self.cloudprovider = cloudprovider
        self.solver = solver
        self.metrics = metrics
        self.clock = clock
        #: optional scheduling.PreemptionPlanner — consulted when a
        #: solve leaves priority-bearing pods unschedulable, BEFORE the
        #: round gives up on them (None = preemption disabled)
        self.preempt_planner = preempt_planner
        # batching window (core batchIdleDuration): pods arriving within
        # the window ride the same solve. With a delta-capable solver the
        # window isn't dead time — we hand it the snapshot up front so it
        # can encode/pack speculatively while we wait for stragglers.
        self.batch_window_s = batch_window_s

    def reconcile(self) -> ProvisioningResult:
        """One provisioning round (core Provisioner.Schedule)."""
        pods = self.state.pending_pods()
        result = ProvisioningResult()
        if self.metrics is not None:
            # scheduler queue depth = pending pods entering this round
            # (metrics.md:191-197)
            self.metrics.set_gauge("karpenter_scheduler_queue_depth",
                                   float(len(pods)))
        if not pods:
            return result
        # pods whose PVCs don't exist yet are held out of the solve
        # (volumetopology.go errors and skips the pod: scheduling before
        # the claim materializes could pin it to the wrong zone)
        held = self._pods_awaiting_claims(pods)
        if held:
            for p in held:
                result.unschedulable[p.full_name()] = \
                    "awaiting PersistentVolumeClaim creation"
            pods = [p for p in pods if p.full_name()
                    not in result.unschedulable]
            if not pods:
                return result
        snapshot = self.build_snapshot(pods)
        if self.batch_window_s > 0 and hasattr(self.solver, "speculate"):
            # speculative pre-encode: the solver starts its delta-encoder
            # walk against the provisional snapshot while the batch window
            # soaks up stragglers. If the pod set didn't move, the solve
            # below consumes the finished prep (same snapshot object); if
            # it did, we rebuild and the solver discards the speculation
            # via its state-token check — never a stale solve.
            self.solver.speculate(snapshot)
            time.sleep(self.batch_window_s)
            fresh = self.state.pending_pods()
            for p in self._pods_awaiting_claims(fresh):
                result.unschedulable.setdefault(
                    p.full_name(), "awaiting PersistentVolumeClaim creation")
            fresh = [p for p in fresh
                     if p.full_name() not in result.unschedulable]
            if {p.full_name() for p in fresh} != \
                    {p.full_name() for p in pods}:
                pods = fresh
                snapshot = self.build_snapshot(pods)
        t0 = time.perf_counter()
        solved = self.solver.solve(snapshot)
        result.solve_duration_s = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.observe("karpenter_scheduler_scheduling_duration_seconds",
                                 result.solve_duration_s)
        result.unschedulable.update(solved.unschedulable)

        pods_by_name = {p.full_name(): p for p in pods}
        # pods onto existing capacity -> nominate
        for pod_name, node_name in solved.existing_assignments.items():
            self.state.nominate(pod_name, node_name)
            result.nominated[pod_name] = node_name
        # new nodes -> NodeClaim CRs
        for plan in solved.new_nodes:
            claim = self._create_nodeclaim(plan, pods_by_name)
            result.created_claims.append(claim)
            for pod_name in plan.pod_names:
                self.state.nominate(pod_name, claim.name)
                result.nominated[pod_name] = claim.name
        # leftovers with priority: consult the preemption search before
        # the round gives up on them
        if result.unschedulable and self.preempt_planner is not None:
            self._maybe_preempt(snapshot, result)
        return result

    def _maybe_preempt(self, snapshot: SchedulingSnapshot,
                       result: ProvisioningResult) -> None:
        """Preemption verdict -> applied Command: evict the victim
        prefix (unbind — the pods requeue at their own priority next
        round), re-solve ONLY the unblocked demand against the refunded
        capacity, and nominate the assignments. The planner guarantees
        existing-capacity placement; the solve stays the authority that
        picks nodes."""
        verdict = self.preempt_planner.plan(
            snapshot, list(result.unschedulable), self.state)
        result.preempt = verdict
        if not verdict.feasible:
            return
        for pod in verdict.victims:
            result.preempted[pod.full_name()] = pod.node_name
            self.state.clear_nomination(pod.full_name())
            pod.node_name = ""
            pod.phase = "Pending"
            self.kube.update(pod)
        demand = list(verdict.demand)
        solved = self.solver.solve(self.build_snapshot(demand))
        for pod_name, node_name in solved.existing_assignments.items():
            self.state.nominate(pod_name, node_name)
            result.nominated[pod_name] = node_name
            result.unschedulable.pop(pod_name, None)
        if solved.new_nodes:
            # contradicts the verdict's zero-new-nodes guarantee (only
            # reachable if the cluster moved between plan and re-solve):
            # never mint off a preemption round — the pods stay pending
            # and the next reconcile handles them with fresh state
            log.warning(
                "preemption re-solve wanted %d new node(s); ignoring "
                "(verdict promised existing capacity only)",
                len(solved.new_nodes))

    def _pods_awaiting_claims(self, pods: Sequence[Pod]) -> List[Pod]:
        """Pods referencing a PVC that doesn't exist (yet)."""
        out = []
        for pod in pods:
            for claim_name in getattr(pod, "volume_claims", ()) or ():
                if self.kube.try_get("PersistentVolumeClaim", claim_name,
                                     namespace=pod.metadata.namespace) is None:
                    out.append(pod)
                    break
        return out

    def _resolve_volume_topology(self, pods: Sequence[Pod]) -> None:
        """Core scheduling/volumetopology.go: pods mounting PVCs inherit
        zone constraints from their bound PV's node affinity (or the
        StorageClass's allowedTopologies for unbound claims), and consume
        one EBS attachment slot per claim (CSINode limit accounting)."""
        from ..apis.requirements import IN, Requirement, Requirements
        for pod in pods:
            claims = getattr(pod, "volume_claims", None)
            ephemeral = getattr(pod, "ephemeral_volumes", None)
            if not claims and not ephemeral:
                continue
            terms = []
            n_volumes = 0

            def _claim_constraints(pvc, fallback_class=""):
                """One claim's zone terms (bound PV wins; else the
                class's allowedTopologies)."""
                if pvc is not None and pvc.bound:
                    pv = self.kube.try_get("PersistentVolume",
                                           pvc.volume_name)
                    if pv is not None and pv.zone:
                        terms.append(Requirement.new(L.ZONE, IN, [pv.zone]))
                    return
                sc_name = pvc.storage_class if pvc is not None \
                    else fallback_class
                sc = self.kube.try_get("StorageClass", sc_name) \
                    if sc_name else None
                if sc is not None and sc.allowed_topology_zones:
                    terms.append(Requirement.new(
                        L.ZONE, IN, list(sc.allowed_topology_zones)))

            for claim_name in claims or ():
                pvc = self.kube.try_get("PersistentVolumeClaim", claim_name,
                                        namespace=pod.metadata.namespace)
                if pvc is None:
                    continue
                n_volumes += 1
                _claim_constraints(pvc)
            # generic ephemeral volumes: the PVC (`<pod>-<volume>`) is
            # created by the kubelet at bind time, so an absent PVC does
            # NOT skip the volume — it still takes an attachment slot and
            # its class's allowed topologies apply (core
            # volumetopology.go treats the templated claim the same way)
            for vol_name, sc_name in ephemeral or ():
                n_volumes += 1
                pvc = self.kube.try_get(
                    "PersistentVolumeClaim",
                    f"{pod.metadata.name}-{vol_name}",
                    namespace=pod.metadata.namespace)
                _claim_constraints(pvc, fallback_class=sc_name)
            pod.apply_volume_constraints(Requirements(terms), n_volumes)

    def build_snapshot(self, pods: Sequence[Pod]) -> SchedulingSnapshot:
        self._resolve_volume_topology(pods)
        # resolve priorityClassName -> numeric priority against the live
        # PriorityClass table (unconditional: a deleted class must reset
        # its pods to the default). With no PriorityClass objects every
        # pod stays at 0 and the solve is byte-identical to a
        # priority-free build (tests/test_preempt.py fingerprint gate).
        priority_classes = self.kube.list("PriorityClass")
        resolve_pod_priorities(pods, priority_classes)
        usage = self.state.nodepool_usage()
        specs: List[NodePoolSpec] = []
        for np in self.kube.list("NodePool"):
            try:
                types = self.cloudprovider.get_instance_types(np)
            except Exception as e:  # NodeClass missing/not ready
                log.warning("nodepool %s skipped: %s", np.name, e)
                continue
            if not types:
                continue
            specs.append(NodePoolSpec(
                nodepool=np, instance_types=types,
                in_use=usage.get(np.name, Resources())))
        daemons = self._daemon_overheads()
        zones = {}
        for spec in specs:
            for it in spec.instance_types:
                for o in it.offerings:
                    zones.setdefault(o.zone, o.zone_id)
        return SchedulingSnapshot(
            pods=list(pods), nodepools=specs,
            existing_nodes=self.state.existing_nodes(),
            daemon_overheads=daemons, zones=zones,
            priority_classes=priority_classes)

    def _daemon_overheads(self) -> List[DaemonOverhead]:
        """Daemonset pods: every new node admitting them pays their requests."""
        out = []
        for pod in self.kube.list("Pod"):
            if pod.owner_kind == "DaemonSet":
                out.append(DaemonOverhead(
                    requests=pod.effective_requests(),
                    requirements=pod.scheduling_requirements()))
        return out

    def _create_nodeclaim(self, plan: NewNodeClaim,
                          pods_by_name: Dict[str, Pod]) -> NodeClaim:
        nodepool = self.kube.get("NodePool", plan.nodepool)
        labels = dict(nodepool.template.labels)
        labels[L.NODEPOOL] = plan.nodepool
        # single-valued requirements become labels (core nodeclaim template)
        for k, v in plan.requirements.single_values().items():
            labels.setdefault(k, v)
        claim = NodeClaim(
            name=f"{plan.nodepool}-{next(_claim_seq):05d}",
            requirements=plan.requirements,
            node_class_ref=nodepool.template.node_class_ref,
            resources_requested=plan.requests,
            taints=plan.taints,
            startup_taints=nodepool.template.startup_taints,
            labels=labels,
            annotations={
                # user template annotations ride onto the claim (and the
                # node via the kubelet's registration)
                **nodepool.template.annotations,
                L.NODEPOOL_HASH_ANNOTATION: nodepool.hash(),
                L.NODEPOOL_HASH_VERSION_ANNOTATION: L.NODEPOOL_HASH_VERSION,
            },
            expire_after=nodepool.template.expire_after,
            termination_grace_period=(
                nodepool.template.termination_grace_period))
        claim.metadata.finalizers.append("karpenter.sh/termination")
        claim.instance_type_options = list(plan.instance_type_names)
        self.kube.create(claim)
        if self.metrics is not None:
            self.metrics.inc("karpenter_nodeclaims_created_total",
                             labels={"nodepool": plan.nodepool})
        return claim
