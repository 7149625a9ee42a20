"""Preference relaxation: soft scheduling constraints honored when
possible, dropped when they block a pod.

Upstream core treats preferred scheduling terms as REQUIRED and, when a
pod cannot schedule, relaxes one preference and retries (the scheduler's
preference-relaxation loop; consumed by this provider per SURVEY §3.2).
This module is that loop for the batch solvers:

- a pod's *preference chain* is its preferred (anti-)affinity terms in
  declaration order, then its ScheduleAnyway topology-spread constraints
  in declaration order;
- at relax level L the first L preferences are REMOVED and the rest are
  HARDENED (required=True / DoNotSchedule);
- the wrapper solves with every preference-bearing pod hardened at its
  current level, bumps the level of exactly the pods that came back
  unschedulable and still have something to relax, and re-solves; the
  loop ends when nothing bumps (bounded by the total relaxation budget).

The wrapper works at GROUP granularity: it computes the canonical pod
grouping once (the same grouping the encoder needs — handed down so the
50k-pod walk happens exactly once per solve), reads the preference chain
off each group representative (the chain is a function of the scheduling
signature, which all members share), and in relax rounds rebuilds only
the partitions of soft groups whose levels moved — pods with no
preferences are never walked again. Hardened clones are cached on the
pod object, so steady-state re-solves reuse them. Both solver engines
share this wrapper, which keeps CPU/CUDA decision equality by
construction.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Tuple

from ..apis.objects import Pod, PodAffinityTerm, TopologySpreadConstraint
from ..models.encoding import canonical_group_order, canonical_pod_groups
from .types import SchedulingSnapshot, SolveResult

#: per-pod memo key for preference_count; the apis layer owns it so the
#: invalidator (invalidate_scheduling_caches) and both lookup sites here
#: can never silently disagree
from ..apis.objects import PREF_COUNT_MEMO  # noqa: E402


def preference_count(pod: Pod) -> int:
    """Length of the pod's preference chain (0 = nothing to relax).
    A function of the pod's scheduling signature, so one call per GROUP
    representative covers every member
    (invalidate_scheduling_caches clears the memo)."""
    n = pod.__dict__.get(PREF_COUNT_MEMO)
    if n is None:
        n = sum(1 for a in pod.pod_affinity if not a.required) \
            + sum(1 for c in pod.topology_spread
                  if c.when_unsatisfiable != "DoNotSchedule")
        pod.__dict__[PREF_COUNT_MEMO] = n
    return n


def harden(pod: Pod, level: int) -> Pod:
    """A clone of `pod` with the first `level` preferences removed and the
    remaining ones promoted to required. level=0 hardens everything."""
    cache = pod.__dict__.setdefault("_hardened", {})
    hit = cache.get(level)
    if hit is not None:
        return hit
    clone = copy.copy(pod)  # shallow: shares metadata (same identity)
    # caches that depend on the (changed) topology fields must not leak:
    # a stale signature would group a hardened clone with the raw pod and
    # make relaxation a no-op (the attribute list lives with Pod)
    from ..apis.objects import invalidate_scheduling_caches
    invalidate_scheduling_caches(clone)
    dropped = 0
    aff: List[PodAffinityTerm] = []
    for a in pod.pod_affinity:
        if a.required:
            aff.append(a)
        elif dropped < level:
            dropped += 1  # relaxed away
        else:
            aff.append(PodAffinityTerm(topology_key=a.topology_key,
                                       group=a.group, anti=a.anti,
                                       required=True))
    spread: List[TopologySpreadConstraint] = []
    for c in pod.topology_spread:
        if c.when_unsatisfiable == "DoNotSchedule":
            spread.append(c)
        elif dropped < level:
            dropped += 1
        else:
            spread.append(TopologySpreadConstraint(
                max_skew=c.max_skew, topology_key=c.topology_key,
                when_unsatisfiable="DoNotSchedule", group=c.group))
    clone.pod_affinity = aff
    clone.topology_spread = spread
    cache[level] = clone
    return clone


def _group_signature_of(pod: Pod) -> Tuple:
    from ..models.encoding import pod_group_signature
    return pod_group_signature(pod)


def solve_with_preferences(
        solve_core: Callable[..., SolveResult],
        snapshot: SchedulingSnapshot, metrics=None,
        raw_groups=None) -> SolveResult:
    """``raw_groups``: the snapshot's canonical grouping when the caller
    already walked it (``Solver.solve`` times that walk)."""
    if raw_groups is None:
        raw_groups = canonical_pod_groups(snapshot.pods)
    #: group position -> chain length (>0 only for soft groups)
    chains: Dict[int, int] = {}
    for gi, (_sig, plist) in enumerate(raw_groups):
        n = preference_count(plist[0])
        if n:
            chains[gi] = n
    if not chains:
        return solve_core(snapshot, pod_groups=raw_groups)
    #: per-pod relaxation level (pods of one group can diverge: only the
    #: members that came back unschedulable bump)
    level: Dict[int, int] = {id(p): 0 for gi in chains
                             for p in raw_groups[gi][1]}
    # relaxing one pod can newly block another (e.g. a relaxed pod lands
    # on a node and its group-membership counter now repels a hardened
    # anti-affinity pod), so the loop bound is the TOTAL relaxation
    # budget, not the longest single chain — every round that doesn't
    # terminate bumps at least one pod's level
    max_rounds = 1 + sum(chains[gi] * len(raw_groups[gi][1])
                         for gi in chains)
    result: SolveResult = None  # type: ignore[assignment]
    rounds = 0

    def partitions_of(gi: int) -> List[Tuple[Tuple, List[Pod]]]:
        """Split one soft group into per-level partitions of hardened
        clones (partition preserves the (ns, name) member order)."""
        parts: Dict[int, List[Pod]] = {}
        for p in raw_groups[gi][1]:
            parts.setdefault(level[id(p)], []).append(p)
        return [(_group_signature_of(h0 := harden(members[0], lv)),
                 [h0] + [harden(p, lv) for p in members[1:]])
                for lv, members in parts.items()]

    #: gi -> current partitions; recomputed only when the group's levels
    #: moved (the bump loop below): steady-state rounds walk only the
    #: pods of groups that actually changed, not all 50k
    soft_parts: Dict[int, List[Tuple[Tuple, List[Pod]]]] = {
        gi: partitions_of(gi) for gi in chains}
    for _ in range(max_rounds):
        # group-level assembly: hard groups pass through untouched; soft
        # groups contribute their current hardened partitions
        assembled: List[Tuple[Tuple, List[Pod]]] = []
        for gi, (sig, plist) in enumerate(raw_groups):
            if gi in chains:
                assembled.extend(soft_parts[gi])
            else:
                assembled.append((sig, plist))
        groups = canonical_group_order(assembled)
        from itertools import chain as _chain
        pods = list(_chain.from_iterable(pl for _, pl in groups))
        result = solve_core(SchedulingSnapshot(
            pods=pods, nodepools=snapshot.nodepools,
            existing_nodes=snapshot.existing_nodes,
            daemon_overheads=snapshot.daemon_overheads,
            zones=snapshot.zones), pod_groups=groups)
        bumped = False
        if result.unschedulable:
            for gi in chains:
                cap = chains[gi]
                moved = False
                for p in raw_groups[gi][1]:
                    if level[id(p)] < cap and \
                            p.full_name() in result.unschedulable:
                        level[id(p)] += 1
                        moved = True
                if moved:
                    soft_parts[gi] = partitions_of(gi)
                    bumped = True
        if not bumped:
            break
        rounds += 1
    if rounds:
        # each extra round is a FULL re-solve — a latency cliff that must
        # never be silent (same stance as the oracle-fallback counter)
        import logging
        logging.getLogger(__name__).info(
            "preference relaxation took %d extra solve round(s) across %d "
            "soft group(s)", rounds, len(chains))
        if metrics is not None:
            metrics.inc("karpenter_solver_preference_relaxation_rounds_total",
                        value=float(rounds))
    return result
