"""Solver contract: snapshot in, decisions out.

The provisioning controller builds a :class:`SchedulingSnapshot` and
calls ``Solver.solve``; the implementation here is
``cuda`` (solver/cuda.py, the packed group scan on the GPU) and ``cpu``
(solver/cpu.py, the sequential FFD oracle). Decisions must be identical
to the reference package's CPU oracle — tests/test_torch_pipeline.py
enforces it.

The solve semantics mirror the core scheduler the reference drives
(designs/bin-packing.md:17-42): sort pending pods by descending size,
first-fit onto open in-flight nodes (whose candidate instance-type sets
narrow as pods land), open a new node from the highest-weight admitting
NodePool otherwise, honoring requirements, taints/tolerations, topology
spread, pod (anti-)affinity, and NodePool resource limits.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence, Tuple

from ..apis.objects import NodePool, Pod, Taint
from ..apis.requirements import Requirements
from ..apis.resources import Resources
from ..cloudprovider.types import InstanceTypes


@dataclass
class ExistingNode:
    """A live node (or in-flight NodeClaim from a previous round) the solver
    may keep packing onto."""
    name: str
    labels: Mapping[str, str]
    allocatable: Resources
    taints: Sequence[Taint] = ()
    #: resources already committed (pods bound + daemonsets)
    used: Resources = field(default_factory=Resources)
    #: scheduling-group identities of pods already on the node (for topology
    #: spread / anti-affinity bookkeeping)
    pod_groups: Sequence[str] = ()
    nodepool: str = ""
    instance_type: str = ""

    def remaining(self) -> Resources:
        return (self.allocatable - self.used).clamp_nonnegative()


@dataclass
class NodePoolSpec:
    """A NodePool plus its resolved instance-type catalog."""
    nodepool: NodePool
    instance_types: InstanceTypes
    #: resources already provisioned under this pool (for limits)
    in_use: Resources = field(default_factory=Resources)


@dataclass
class DaemonOverhead:
    """Aggregate daemonset requests that land on every new node whose
    requirements admit the daemonset's pods."""
    requests: Resources = field(default_factory=Resources)
    requirements: Requirements = field(default_factory=Requirements)


@dataclass
class SchedulingSnapshot:
    pods: Sequence[Pod]
    nodepools: Sequence[NodePoolSpec]
    existing_nodes: Sequence[ExistingNode] = ()
    daemon_overheads: Sequence[DaemonOverhead] = ()
    #: zone -> zone_id for topology bookkeeping
    zones: Mapping[str, str] = field(default_factory=dict)
    #: PriorityClass objects in effect when the snapshot was built; the
    #: pods' .priority attrs are already resolved against this table.
    #: Folded into the delta encoder's structural key (value changes
    #: must force a full re-encode) and read by the preemption planner.
    priority_classes: Sequence = ()


@dataclass
class NewNodeClaim:
    """A node the solver decided to create."""
    nodepool: str
    requirements: Requirements
    pod_names: List[str]
    #: candidate types, cheapest-first; launcher truncates to 60
    instance_type_names: List[str]
    requests: Resources
    taints: Sequence[Taint] = ()


@dataclass
class SolveResult:
    new_nodes: List[NewNodeClaim]
    #: pod name -> existing node name
    existing_assignments: Dict[str, str]
    #: pod name -> human-readable reason
    unschedulable: Dict[str, str]

    def summary(self) -> str:
        return (f"{len(self.new_nodes)} new nodes, "
                f"{len(self.existing_assignments)} pods onto existing, "
                f"{len(self.unschedulable)} unschedulable")

    def decision_fingerprint(self) -> Tuple:
        """A canonical, order-independent encoding of every decision — two
        solvers are 'identical' iff fingerprints match."""
        new = tuple(sorted(
            (n.nodepool, tuple(sorted(n.pod_names)),
             tuple(n.instance_type_names))
            for n in self.new_nodes))
        existing = tuple(sorted(self.existing_assignments.items()))
        unsched = tuple(sorted(self.unschedulable))
        return (new, existing, unsched)


class Solver(abc.ABC):
    name: str = "abstract"
    #: optional metrics registry; the operator injects its own. Oracle
    #: routes and relax rounds are latency cliffs it counts, never silent
    metrics = None
    #: wall ms of the canonical grouping walk of the last solve
    last_group_ms: float = 0.0

    def solve(self, snapshot: SchedulingSnapshot) -> SolveResult:
        """Solve with upstream's preference-relaxation semantics: soft
        constraints (preferred affinity, ScheduleAnyway spread) are
        hardened to required and relaxed per pod only when they block it
        (solver/preferences.py). Engines implement _solve_core. The
        wrapper's first grouping walk is timed here (``last_group_ms``)."""
        import time

        from ..models.encoding import canonical_pod_groups
        from .preferences import solve_with_preferences
        t0 = time.perf_counter()
        groups = canonical_pod_groups(snapshot.pods)
        self.last_group_ms = (time.perf_counter() - t0) * 1e3
        return solve_with_preferences(self._solve_core, snapshot,
                                      metrics=self.metrics,
                                      raw_groups=groups)

    @abc.abstractmethod
    def _solve_core(self, snapshot: SchedulingSnapshot,
                    pod_groups=None) -> SolveResult:
        """pod_groups: optional canonical [(sig, members)] grouping the
        preference wrapper already computed — engines that encode by
        group reuse it instead of re-walking every pod; the oracle
        ignores it (its independent sort is part of being the oracle)."""
        ...
