"""In-memory cluster state cache (the core library's ``state.Cluster``).

Tracks nodes, nodeclaims, and pod bindings/nominations, and produces the
solver's view of existing capacity. Mirrors what main.go:40 constructs and
the provisioner consumes; nomination prevents double-provisioning between
the solve that planned a pod and the kube-scheduler binding it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

from ..apis import labels as L
from ..apis.objects import Node, NodeClaim, Pod
from ..apis.resources import Resources, sum_resources
from ..fake.kube import FakeKube
from ..solver.types import ExistingNode

NOMINATION_TTL = 20.0  # core nomination window


@dataclass
class Nomination:
    node_name: str
    expires: float


class ClusterState:
    def __init__(self, kube: FakeKube, clock=time.time):
        self.kube = kube
        self.clock = clock
        self._mu = threading.Lock()
        self._nominations: Dict[str, Nomination] = {}  # pod full_name -> node

    # -- nominations ---------------------------------------------------
    def nominate(self, pod_full_name: str, node_name: str) -> None:
        with self._mu:
            self._nominations[pod_full_name] = Nomination(
                node_name, self.clock() + NOMINATION_TTL)

    def nomination_for(self, pod_full_name: str) -> Optional[str]:
        with self._mu:
            nom = self._nominations.get(pod_full_name)
            if nom is None:
                return None
            if self.clock() >= nom.expires:
                del self._nominations[pod_full_name]
                return None
            return nom.node_name

    def clear_nomination(self, pod_full_name: str) -> None:
        with self._mu:
            self._nominations.pop(pod_full_name, None)

    def clear_nominations_to(self, node_name: str) -> None:
        """Release every pod nominated toward ``node_name`` — called when
        the target claim dies before joining (failed launch), so its pods
        reappear in pending_pods() immediately instead of after TTL."""
        with self._mu:
            self._nominations = {
                pod: nom for pod, nom in self._nominations.items()
                if nom.node_name != node_name}

    def nomination_targets(self) -> Set[str]:
        """Node/claim names with pods in flight toward them — such nodes are
        off-limits to disruption (core's nominated-node protection)."""
        now = self.clock()
        with self._mu:
            return {n.node_name for n in self._nominations.values()
                    if now < n.expires}

    # -- views ---------------------------------------------------------
    def pending_pods(self) -> List[Pod]:
        """Unscheduled pods with no live nomination."""
        out = []
        for pod in self.kube.list("Pod"):
            if not pod.is_pending_unscheduled():
                continue
            if self.nomination_for(pod.full_name()) is not None:
                continue
            out.append(pod)
        return out

    def bound_pods_by_node(self) -> Dict[str, List[Pod]]:
        out: Dict[str, List[Pod]] = {}
        for pod in self.kube.list("Pod"):
            if pod.phase in ("Succeeded", "Failed"):
                continue  # terminal pods hold no resources
            target = pod.node_name or self.nomination_for(pod.full_name())
            if target:
                out.setdefault(target, []).append(pod)
        return out

    def existing_nodes(self) -> List[ExistingNode]:
        """Solver view: registered nodes + launched-but-unregistered
        NodeClaims, each with committed resources."""
        by_node = self.bound_pods_by_node()
        out: List[ExistingNode] = []
        seen_provider_ids = set()
        # nodes whose claim is deleting are mid-drain: they must not be
        # scheduling targets (core MarkForDeletion semantics) or the
        # solver re-binds just-evicted pods onto the doomed node
        deleting = {c.node_name for c in self.kube.list("NodeClaim")
                    if c.metadata.deletion_timestamp is not None
                    and c.node_name}
        for node in self.kube.list("Node"):
            if not node.ready:
                continue
            if node.name in deleting \
                    or node.metadata.deletion_timestamp is not None:
                continue
            pods = by_node.get(node.name, [])
            out.append(ExistingNode(
                name=node.name,
                labels=dict(node.metadata.labels),
                allocatable=node.allocatable,
                taints=list(node.taints),
                used=sum_resources(p.effective_requests() for p in pods),
                pod_groups=[p.scheduling_group for p in pods
                            if p.scheduling_group],
                nodepool=node.metadata.labels.get(L.NODEPOOL, ""),
                instance_type=node.metadata.labels.get(L.INSTANCE_TYPE, ""),
            ))
            seen_provider_ids.add(node.provider_id)
        for claim in self.kube.list("NodeClaim"):
            if not claim.launched or claim.provider_id in seen_provider_ids:
                continue
            if claim.metadata.deletion_timestamp is not None:
                continue
            pods = by_node.get(claim.name, [])
            out.append(ExistingNode(
                name=claim.name,
                labels=dict(claim.metadata.labels),
                allocatable=claim.allocatable,
                taints=list(claim.taints),
                used=sum_resources(p.effective_requests() for p in pods),
                pod_groups=[p.scheduling_group for p in pods
                            if p.scheduling_group],
                nodepool=claim.nodepool or "",
                instance_type=claim.metadata.labels.get(L.INSTANCE_TYPE, ""),
            ))
        return out

    def nodepool_usage(self) -> Dict[str, Resources]:
        """Aggregate requested capacity per nodepool (limits enforcement)."""
        usage: Dict[str, Resources] = {}
        for claim in self.kube.list("NodeClaim"):
            pool = claim.nodepool
            if not pool or claim.metadata.deletion_timestamp is not None:
                continue
            cap = claim.capacity if not claim.capacity.is_zero() \
                else claim.resources_requested
            usage[pool] = usage.get(pool, Resources()) + cap
        return usage
