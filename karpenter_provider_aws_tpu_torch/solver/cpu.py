"""The CPU solver: reference-equivalent FFD bin-packing, the correctness
oracle the CUDA solver must match decision-for-decision.

Algorithm (designs/bin-packing.md:17-42 + core scheduler behavior):

1. Sort pending pods by descending (cpu, memory) request, name ascending —
   a deterministic total order shared with the CUDA solver.
2. For each pod, first-fit in a fixed order: existing cluster nodes (name
   order), then open in-flight nodes (creation order), else open a new node
   from the first admitting NodePool (weight-descending, name ascending).
3. An open node carries a *set* of candidate instance types that narrows as
   pods land (aggregate requests must fit at least one candidate's
   allocatable; pod requirements intersect away incompatible types). The
   launcher later picks the cheapest viable types (Truncate(60),
   instance.go:106).
4. Topology spread / pod (anti-)affinity are enforced per placement with
   domain counters; an open node's undecided zone narrows to the chosen
   domain (min-count, lexicographic tie-break — deterministic).
5. NodePool limits gate adding pods (pool usage includes planned nodes).

Performance machinery (none of it changes any decision):

- Resource fit is vectorized: each open node keeps an int64 allocatable
  matrix over the solve's resource-dimension universe; fit = one numpy
  compare instead of a per-type Python loop.
- Requirement merging is skipped for pod-group signatures a node has
  already absorbed (union is idempotent).
- Rejections are cached per (pod-group signature, target, node version) —
  sound because a node's viable-type set and free resources only shrink.
  Topology-dependent rejections additionally key on the monotone counters
  that could flip them (per-constraint eligible-domain min counts,
  occupancy-set sizes): counts only grow, so a cached rejection stands
  until one of those counters moves.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from ..apis import labels as L
from ..apis.objects import Pod
from ..apis.requirements import IN, Requirement, Requirements
from ..apis.resources import Resources
from ..cloudprovider.types import InstanceType, InstanceTypes
from .types import (
    ExistingNode,
    NewNodeClaim,
    NodePoolSpec,
    SchedulingSnapshot,
    SolveResult,
    Solver)


def pod_sig_digest(pod: Pod) -> str:
    """Digest of the pod-group signature — THE canonical tie-break shared
    by pod_sort_key and models.encoding.canonical_pod_groups. Both solvers'
    decision-identity depends on this being the single implementation."""
    dig = getattr(pod, "_sig_digest", None)
    if dig is None:
        dig = hashlib.md5(repr(pod_group_signature(pod)).encode()).hexdigest()
        pod._sig_digest = dig
    return dig


def pod_sort_key(pod: Pod) -> Tuple:
    """Canonical FFD order, shared verbatim by CPU and TPU solvers:
    descending resolved priority first (higher-priority pods pack before
    any lower tier can claim capacity — Kubernetes scheduling-queue
    semantics as a *packing order*, restriction-stable for subset
    gathers), then descending (cpu, memory), then *pod-group signature
    digest* so identical pods are contiguous within a size class
    (group-batched processing is then exactly per-pod FFD), then
    namespace/name. Priority is 0 unless PriorityClass objects exist,
    so priority-free clusters keep the historical order bit-for-bit."""
    r = pod.effective_requests()
    return (-getattr(pod, "priority", 0), -r["cpu"], -r["memory"],
            pod_sig_digest(pod), pod.metadata.namespace, pod.metadata.name)


def pod_group_signature(pod: Pod) -> Tuple:
    """Pods with equal signatures make identical scheduling demands.
    Memoized per pod (hot path: called in sort keys and group dedup)."""
    cached = getattr(pod, "_sig_cache", None)
    if cached is not None:
        return cached
    pod._sig_cache = sig = (
        tuple(sorted(pod.node_selector.items())),
        tuple(tuple(sorted(_term_items(t).items())) for t in pod.required_affinity_terms),
        tuple(sorted(pod.effective_requests().items())),
        tuple((t.key, t.operator, t.value, t.effect) for t in pod.tolerations),
        tuple((c.max_skew, c.topology_key, c.when_unsatisfiable, c.group)
              for c in pod.topology_spread),
        tuple((a.topology_key, a.group, a.anti, a.required) for a in pod.pod_affinity),
        pod.scheduling_group,
        # volume-topology constraints differ per pod even when selectors
        # match (each PVC pins its own zone)
        tuple(r for r in (getattr(pod, "_volume_reqs", None) or ())),
    )
    # resolved priority splits groups ONLY when nonzero: appended (never
    # inserted — positional consumers index sig[0..7]) so priority-free
    # clusters keep byte-identical signatures, digests, and fingerprints
    prio = getattr(pod, "priority", 0)
    if prio:
        pod._sig_cache = sig = sig + (("priority", prio),)
    return sig


def _term_items(term: Mapping) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in term.items()}


def _min_values_floors(spec: NodePoolSpec) -> Dict[str, int]:
    """Pool-level minValues cardinality floors, memoized on the spec
    (karpenter.sh_nodepools.yaml:284; pods cannot carry minValues)."""
    fl = getattr(spec, "_mv_floors", None)
    if fl is None:
        fl = {r.key: r.min_values
              for r in spec.nodepool.scheduling_requirements()
              if r.min_values is not None}
        spec._mv_floors = fl
    return fl


def _mv_satisfied(types: Sequence[InstanceType], keep,
                  floors: Mapping[str, int]) -> bool:
    """True when the kept candidate types span >= floor distinct values for
    every floored key — core nodeclaim.Add's SatisfiesMinValues check; a
    placement that narrows candidates below a floor must be rejected."""
    card: Dict[str, Set[str]] = {k: set() for k in floors}
    for i, t in enumerate(types):
        if keep is not None and not keep[i]:
            continue
        for r in t.requirements:
            s = card.get(r.key)
            if s is not None and not r.complement:
                s.update(r.values)
    return all(len(card[k]) >= f for k, f in floors.items())


class _ResourceIndex:
    """Fixed resource-dimension universe for one solve."""

    def __init__(self, dims: Sequence[str]):
        self.dims = sorted(dims)
        self.pos = {d: i for i, d in enumerate(self.dims)}

    def vec(self, r: Resources) -> np.ndarray:
        v = np.zeros(len(self.dims), dtype=np.int64)
        for k, q in r.items():
            i = self.pos.get(k)
            if i is not None:
                v[i] = q
        return v

    def alloc_matrix(self, types: Sequence[InstanceType]) -> np.ndarray:
        m = np.zeros((len(types), len(self.dims)), dtype=np.int64)
        for row, t in enumerate(types):
            m[row] = self.vec(t.allocatable())
        return m


class _TopologyState:
    """Domain counters for spread + occupancy for (anti-)affinity. All
    counters are monotone non-decreasing within a solve."""

    def __init__(self, zones: Sequence[str]):
        self.zones = sorted(zones)
        self.spread: Dict[Tuple[str, str], Dict[str, int]] = {}
        self.occupancy: Dict[Tuple[str, str], Set[str]] = {}

    def count(self, group: str, key: str, domain: str) -> int:
        return self.spread.get((group, key), {}).get(domain, 0)

    def min_count(self, group: str, key: str, eligible: Sequence[str]) -> int:
        counts = self.spread.get((group, key), {})
        if not eligible:
            return 0
        return min(counts.get(d, 0) for d in eligible)

    def record(self, group: str, key: str, domain: str) -> None:
        bucket = self.spread.setdefault((group, key), {})
        bucket[domain] = bucket.get(domain, 0) + 1
        self.occupancy.setdefault((group, key), set()).add(domain)

    def occupied(self, group: str, key: str) -> Set[str]:
        return self.occupancy.get((group, key), set())


class _OpenNode:
    """A NodeClaim being built this round."""

    __slots__ = ("index", "spec", "requirements", "taints", "types", "alloc",
                 "pods", "requests", "requests_vec", "domains", "version",
                 "daemon_requests", "seen_sigs")

    def __init__(self, index: int, spec: NodePoolSpec,
                 requirements: Requirements, types: List[InstanceType],
                 alloc: np.ndarray, daemon_requests: Resources,
                 daemon_vec: np.ndarray):
        self.index = index
        self.spec = spec
        self.requirements = requirements
        self.taints = list(spec.nodepool.template.taints)
        self.types = types
        self.alloc = alloc
        self.pods: List[Pod] = []
        self.daemon_requests = daemon_requests
        self.requests = daemon_requests
        self.requests_vec = daemon_vec.copy()
        self.domains: Dict[str, str] = {}
        self.version = 0
        self.seen_sigs: Set[Tuple] = set()

    def hostname_domain(self) -> str:
        return f"new-node-{self.index}"


@dataclass
class _Placement:
    """A validated placement, ready to commit."""
    keep: Optional[np.ndarray] = None          # candidate-type row mask
    requirements: Optional[Requirements] = None
    types_override: Optional[List[InstanceType]] = None
    alloc_override: Optional[np.ndarray] = None
    fixed_domains: Dict[str, str] = field(default_factory=dict)
    records: List[Tuple[str, str, str]] = field(default_factory=list)


class _PodCtx:
    """Per-pod precomputed scheduling context (one per group signature)."""

    __slots__ = ("sig", "reqs", "requests", "vec", "topo_terms", "has_topo")

    def __init__(self, pod: Pod, rindex: _ResourceIndex):
        self.sig = pod_group_signature(pod)
        self.reqs = pod.scheduling_requirements()
        self.requests = pod.effective_requests()
        self.vec = rindex.vec(self.requests)
        self.has_topo = bool(pod.topology_spread) or bool(pod.pod_affinity) \
            or bool(pod.scheduling_group)


class CPUSolver(Solver):
    name = "cpu"

    def _solve_core(self, snapshot: SchedulingSnapshot,
                    pod_groups=None) -> SolveResult:
        # pod_groups intentionally unused: the oracle's own sort is its
        # independence from the grouped encoder it validates
        pods = sorted(snapshot.pods, key=pod_sort_key)
        zones = sorted(snapshot.zones) if snapshot.zones else \
            sorted({o.zone for np_ in snapshot.nodepools
                    for it in np_.instance_types for o in it.offerings})
        topo = _TopologyState(zones)

        dims = {"cpu", "memory", "pods"}
        for p in snapshot.pods:
            # effective requests carry derived dims too (the EBS
            # attachment slots from volume claims)
            dims.update(p.effective_requests().nonzero_keys())
        for d in snapshot.daemon_overheads:
            dims.update(d.requests.nonzero_keys())
        rindex = _ResourceIndex(dims)

        ctx_cache: Dict[Tuple, _PodCtx] = {}

        existing = sorted(snapshot.existing_nodes, key=lambda n: n.name)
        ex_used: Dict[str, Resources] = {n.name: n.used for n in existing}
        ex_version: Dict[str, int] = {n.name: 0 for n in existing}
        for node in existing:
            for group in node.pod_groups:
                zone = node.labels.get(L.ZONE)
                if zone:
                    topo.record(group, L.ZONE, zone)
                topo.record(group, L.HOSTNAME, node.name)

        nodepools = sorted(
            snapshot.nodepools,
            key=lambda s: (-s.nodepool.weight, s.nodepool.metadata.name))
        pool_usage: Dict[str, Resources] = {
            s.nodepool.metadata.name: s.in_use for s in nodepools}
        # (pool, sig) -> requirement-level admission (computed once per group)
        pool_admit: Dict[Tuple[str, Tuple], object] = {}

        open_nodes: List[_OpenNode] = []
        assignments: Dict[str, str] = {}
        unschedulable: Dict[str, str] = {}
        reject: Dict[Tuple, bool] = {}

        for pod in pods:
            ctx = ctx_cache.get(pod_group_signature(pod))
            if ctx is None:
                ctx = _PodCtx(pod, rindex)
                ctx_cache[ctx.sig] = ctx

            placed = False
            # 1) existing cluster nodes -----------------------------------
            for node in existing:
                ck = (ctx.sig, 0, node.name, ex_version[node.name],
                      self._topo_state_key(pod, topo) if ctx.has_topo else ())
                if ck in reject:
                    continue
                plan = self._try_existing(pod, ctx, node, ex_used[node.name], topo)
                if plan is None:
                    reject[ck] = True
                    continue
                ex_used[node.name] = ex_used[node.name] + ctx.requests
                ex_version[node.name] += 1
                for rec in plan.records:
                    topo.record(*rec)
                assignments[pod.full_name()] = node.name
                placed = True
                break
            if placed:
                continue
            # 2) open in-flight nodes -------------------------------------
            for node in open_nodes:
                ck = (ctx.sig, 1, node.index, node.version,
                      self._topo_state_key(pod, topo) if ctx.has_topo else ())
                if ck in reject:
                    continue
                plan = self._try_open(pod, ctx, node, topo, pool_usage)
                if plan is None:
                    reject[ck] = True
                    continue
                self._commit_open(node, pod, ctx, plan, topo, pool_usage)
                placed = True
                break
            if placed:
                continue
            # 3) a new node -----------------------------------------------
            reasons: List[str] = []
            for spec in nodepools:
                name = spec.nodepool.metadata.name
                reason = self._pool_blocked(spec, pool_usage, ctx)
                if reason:
                    reasons.append(f"{name}: {reason}")
                    continue
                node = self._try_new(pod, ctx, spec, len(open_nodes), snapshot,
                                     topo, pool_usage, pool_admit, rindex)
                if isinstance(node, str):
                    reasons.append(f"{name}: {node}")
                    continue
                open_nodes.append(node)
                placed = True
                break
            if not placed:
                unschedulable[pod.full_name()] = "; ".join(reasons) or "no nodepools"

        new_nodes = [self._finalize(n) for n in open_nodes]
        return SolveResult(new_nodes=new_nodes,
                           existing_assignments=assignments,
                           unschedulable=unschedulable)

    # -- rejection-cache topology key ----------------------------------
    def _topo_state_key(self, pod: Pod, topo: _TopologyState) -> Tuple:
        """The monotone counters a cached topology rejection depends on."""
        parts: List = []
        for c in pod.topology_spread:
            g = c.group or pod.scheduling_group
            if c.topology_key == L.HOSTNAME:
                parts.append(0)
            else:
                eligible = self._eligible_domains(c.topology_key, pod, topo)
                parts.append(topo.min_count(g, c.topology_key, eligible))
        for a in pod.pod_affinity:
            parts.append(len(topo.occupied(a.group, a.topology_key)))
        return tuple(parts)

    # ------------------------------------------------------------------
    def _try_existing(self, pod: Pod, ctx: _PodCtx, node: ExistingNode,
                      used: Resources, topo: _TopologyState) -> Optional[_Placement]:
        if not ctx.reqs.satisfied_by_labels(node.labels):
            return None
        if not all(t.tolerated_by(pod.tolerations) for t in node.taints):
            return None
        remaining = (node.allocatable - used).clamp_nonnegative()
        if not ctx.requests.fits(remaining):
            return None
        plan = _Placement()
        domain_of = {L.ZONE: node.labels.get(L.ZONE, ""), L.HOSTNAME: node.name}
        if not self._topology_ok_fixed(pod, domain_of, topo, plan):
            return None
        return plan

    def _try_open(self, pod: Pod, ctx: _PodCtx, node: _OpenNode,
                  topo: _TopologyState,
                  pool_usage: Dict[str, Resources]) -> Optional[_Placement]:
        limits = node.spec.nodepool.limits
        if limits is not None:
            used = pool_usage[node.spec.nodepool.metadata.name] + ctx.requests
            if any(used[res] > lim for res, lim in limits.items()):
                return None
        if not all(t.tolerated_by(pod.tolerations) for t in node.taints):
            return None

        if ctx.sig in node.seen_sigs:
            merged = node.requirements
            types, alloc = node.types, node.alloc
        else:
            merged = node.requirements.union(ctx.reqs)
            if any(r.unsatisfiable() for r in merged):
                return None
            if node.requirements.compatible(ctx.reqs):
                return None
            if merged == node.requirements:
                types, alloc = node.types, node.alloc
            else:
                keep_rows = [i for i, t in enumerate(node.types)
                             if not t.requirements.conflicts(merged)
                             and t.offerings.available().compatible(merged)]
                if not keep_rows:
                    return None
                types = [node.types[i] for i in keep_rows]
                alloc = node.alloc[keep_rows]

        new_vec = node.requests_vec + ctx.vec
        fit = (new_vec <= alloc).all(axis=1)
        if not fit.any():
            return None
        plan = _Placement(
            keep=fit,
            requirements=merged if merged is not node.requirements else None,
            types_override=types if types is not node.types else None,
            alloc_override=alloc if alloc is not node.alloc else None,
        )
        if not self._topology_ok_open(pod, node, merged, types, fit, topo, plan):
            return None
        floors = _min_values_floors(node.spec)
        if floors and not _mv_satisfied(types, plan.keep, floors):
            return None
        return plan

    def _try_new(self, pod: Pod, ctx: _PodCtx, spec: NodePoolSpec, index: int,
                 snapshot: SchedulingSnapshot, topo: _TopologyState,
                 pool_usage: Dict[str, Resources],
                 pool_admit: Dict[Tuple, object], rindex: _ResourceIndex):
        """Returns an _OpenNode or a string reason."""
        np_obj = spec.nodepool
        name = np_obj.metadata.name
        admit_key = (name, ctx.sig)
        admit = pool_admit.get(admit_key)
        if admit is None:
            admit = self._requirement_admission(pod, ctx, spec, snapshot, rindex)
            pool_admit[admit_key] = admit
        if isinstance(admit, str):
            return admit
        merged, types, alloc, daemon, daemon_vec = admit

        requests_vec = daemon_vec + ctx.vec
        fit = (requests_vec <= alloc).all(axis=1)
        if not fit.any():
            return "no instance types fit"
        node = _OpenNode(index, spec, merged,
                         [t for t, k in zip(types, fit) if k],
                         alloc[fit], daemon, daemon_vec)
        plan = _Placement(keep=np.ones(len(node.types), dtype=bool))
        if not self._topology_ok_open(pod, node, merged, node.types,
                                      plan.keep, topo, plan):
            return "topology constraints unsatisfiable"
        floors = _min_values_floors(spec)
        if floors and not _mv_satisfied(node.types, plan.keep, floors):
            return "minValues floors violated"
        self._commit_open(node, pod, ctx, plan, topo, pool_usage)
        return node

    def _requirement_admission(self, pod: Pod, ctx: _PodCtx,
                               spec: NodePoolSpec,
                               snapshot: SchedulingSnapshot,
                               rindex: _ResourceIndex):
        """Requirement-level admission of a pod group by a nodepool —
        everything about a (pool, group) pair that doesn't depend on counts."""
        np_obj = spec.nodepool
        base = np_obj.scheduling_requirements()
        offending = base.compatible(ctx.reqs)
        if offending:
            return f"incompatible requirements {offending}"
        if not all(t.tolerated_by(pod.tolerations)
                   for t in np_obj.template.taints):
            return "untolerated taints"
        merged = base.union(ctx.reqs)
        if any(r.unsatisfiable() for r in merged):
            return "empty requirement intersection"
        types = [t for t in spec.instance_types
                 if not t.requirements.conflicts(merged)
                 and t.offerings.available().compatible(merged)]
        if not types:
            return "no compatible instance types"
        daemon = self._daemon_requests(snapshot, merged)
        return (merged, types, rindex.alloc_matrix(types), daemon,
                rindex.vec(daemon))

    def _commit_open(self, node: _OpenNode, pod: Pod, ctx: _PodCtx,
                     plan: _Placement, topo: _TopologyState,
                     pool_usage: Dict[str, Resources]) -> None:
        node.version += 1
        node.pods.append(pod)
        node.requests = node.requests + ctx.requests
        node.requests_vec = node.requests_vec + ctx.vec
        types = plan.types_override if plan.types_override is not None else node.types
        alloc = plan.alloc_override if plan.alloc_override is not None else node.alloc
        if plan.keep is not None and not plan.keep.all():
            types = [t for t, k in zip(types, plan.keep) if k]
            alloc = alloc[plan.keep]
        node.types, node.alloc = types, alloc
        if plan.requirements is not None:
            # tightening preserves earlier sigs' idempotence (their reqs are
            # already absorbed into any superset)
            node.requirements = plan.requirements
        node.seen_sigs.add(ctx.sig)
        node.domains.update(plan.fixed_domains)
        for rec in plan.records:
            topo.record(*rec)
        pool = node.spec.nodepool.metadata.name
        pool_usage[pool] = pool_usage[pool] + ctx.requests

    # -- topology ------------------------------------------------------
    def _topology_ok_fixed(self, pod: Pod, domain_of: Mapping[str, str],
                           topo: _TopologyState, plan: _Placement) -> bool:
        group = pod.scheduling_group
        for c in pod.topology_spread:
            if c.when_unsatisfiable != "DoNotSchedule":
                continue
            domain = domain_of.get(c.topology_key, "")
            if not domain:
                return False
            g = c.group or group
            if c.topology_key == L.HOSTNAME:
                min_count = 0  # a fresh node is always a hypothetical domain
            else:
                eligible = self._eligible_domains(c.topology_key, pod, topo)
                min_count = topo.min_count(g, c.topology_key, eligible)
            if topo.count(g, c.topology_key, domain) + 1 - min_count > c.max_skew:
                return False
        for a in pod.pod_affinity:
            if not a.required:
                continue
            domain = domain_of.get(a.topology_key, "")
            occupied = topo.occupied(a.group, a.topology_key)
            if a.anti:
                if domain in occupied:
                    return False
            else:
                if occupied:
                    if domain not in occupied:
                        return False
                elif a.group != group:
                    return False  # required affinity to a group with no pods
        for c in pod.topology_spread:
            g = c.group or group
            d = domain_of.get(c.topology_key, "")
            if g and d:
                plan.records.append((g, c.topology_key, d))
        if group:
            self._record_membership(pod, domain_of, plan)
        return True

    def _topology_ok_open(self, pod: Pod, node: _OpenNode,
                          merged: Requirements, types: Sequence[InstanceType],
                          fit: np.ndarray, topo: _TopologyState,
                          plan: _Placement) -> bool:
        group = pod.scheduling_group
        zone_needed = any(c.topology_key == L.ZONE for c in pod.topology_spread) \
            or any(a.topology_key == L.ZONE for a in pod.pod_affinity if a.required)
        domain_of: Dict[str, str] = {L.HOSTNAME: node.hostname_domain()}
        if L.ZONE in node.domains:
            domain_of[L.ZONE] = node.domains[L.ZONE]
        elif zone_needed:
            fit_types = [t for t, k in zip(types, fit) if k]
            chosen = self._choose_zone(pod, merged, fit_types, topo)
            if chosen is None:
                return False
            domain_of[L.ZONE] = chosen
            plan.fixed_domains[L.ZONE] = chosen
            narrowed_reqs = (plan.requirements or merged).add(
                Requirement.new(L.ZONE, IN, [chosen]))
            keep = np.array([
                bool(k) and not t.requirements.conflicts(narrowed_reqs)
                and bool(t.offerings.available().compatible(narrowed_reqs))
                for t, k in zip(types, fit)], dtype=bool)
            if not keep.any():
                return False
            plan.keep = keep
            plan.requirements = narrowed_reqs
        return self._topology_ok_fixed(pod, domain_of, topo, plan)

    def _choose_zone(self, pod: Pod, merged: Requirements,
                     types: Sequence[InstanceType],
                     topo: _TopologyState) -> Optional[str]:
        """Min-count eligible zone, lexicographic tie-break (deterministic)."""
        zone_req = merged.get(L.ZONE)
        candidates = sorted({
            o.zone for t in types for o in t.offerings.available()
            if zone_req is None or zone_req.has(o.zone)})
        group = pod.scheduling_group
        best, best_key = None, None
        for z in candidates:
            ok = True
            score = 0
            for c in pod.topology_spread:
                if c.topology_key != L.ZONE or c.when_unsatisfiable != "DoNotSchedule":
                    continue
                g = c.group or group
                eligible = self._eligible_domains(L.ZONE, pod, topo)
                if topo.count(g, L.ZONE, z) + 1 \
                        - topo.min_count(g, L.ZONE, eligible) > c.max_skew:
                    ok = False
                    break
                score += topo.count(g, L.ZONE, z)
            if not ok:
                continue
            for a in pod.pod_affinity:
                if not a.required or a.topology_key != L.ZONE:
                    continue
                occupied = topo.occupied(a.group, L.ZONE)
                if a.anti and z in occupied:
                    ok = False
                    break
                if not a.anti and occupied and z not in occupied:
                    ok = False
                    break
                if not a.anti and not occupied and a.group != group:
                    ok = False
                    break
            if not ok:
                continue
            key = (score, z)
            if best_key is None or key < best_key:
                best, best_key = z, key
        return best

    def _eligible_domains(self, key: str, pod: Pod,
                          topo: _TopologyState) -> List[str]:
        if key == L.ZONE:
            zone_req = pod.scheduling_requirements().get(L.ZONE)
            return [z for z in topo.zones if zone_req is None or zone_req.has(z)]
        return []

    def _record_membership(self, pod: Pod, domain_of: Mapping[str, str],
                           plan: _Placement) -> None:
        group = pod.scheduling_group
        if not group:
            return
        seen = {(g, k) for (g, k, _) in plan.records}
        for key in (L.ZONE, L.HOSTNAME):
            d = domain_of.get(key, "")
            if d and (group, key) not in seen:
                plan.records.append((group, key, d))

    # -- pools / daemons / finalize ------------------------------------
    @staticmethod
    def _pool_blocked(spec: NodePoolSpec, usage: Dict[str, Resources],
                      ctx: _PodCtx) -> str:
        limits = spec.nodepool.limits
        if limits is None:
            return ""
        used = usage[spec.nodepool.metadata.name] + ctx.requests
        for res, lim in limits.items():
            if used[res] > lim:
                return f"limit reached for {res}"
        return ""

    def _daemon_requests(self, snapshot: SchedulingSnapshot,
                         node_reqs: Requirements) -> Resources:
        total = Resources()
        for d in snapshot.daemon_overheads:
            if not node_reqs.compatible(d.requirements):
                total = total + d.requests
        return total

    @staticmethod
    def _finalize(node: _OpenNode) -> NewNodeClaim:
        reqs = node.requirements
        ordered = InstanceTypes(node.types).order_by_price(reqs)
        return NewNodeClaim(
            nodepool=node.spec.nodepool.metadata.name,
            requirements=reqs,
            pod_names=sorted(p.full_name() for p in node.pods),
            instance_type_names=[t.name for t in ordered],
            requests=node.requests,
            taints=node.taints,
        )


def reqs_satisfied_by_node_labels(reqs: Requirements,
                                  labels: Mapping[str, str]) -> bool:
    return reqs.satisfied_by_labels(labels)
