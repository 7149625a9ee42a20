"""Consolidation's evaluator contract: a trimmed copy of the reference
package's ``controllers/disruption.py``.

The disruption controller (designs/consolidation.md) asks, per
candidate node, whether its pods are absorbed by the remaining nodes
(deletion) or by the remaining nodes plus ONE strictly cheaper new node
(single-node replacement), and binary-searches the largest ascending-cost
prefix of candidates that one cheaper node can replace (multi-node).
That inner loop is delegated to a pluggable :class:`ConsolidationEvaluator`
so a batched device evaluator (solver/consolidation.py
``CUDAConsolidationEvaluator``) can answer every candidate at once; its
decisions stay identical to the sequential oracle below.

Kept: ``ReplacementQuery``, ``SubsetVerdict``, ``ConsolidationEvaluator``
(the sequential oracle over ``solver.solve``) and
``MIN_SPOT_FLEXIBILITY``. The controller itself (``DisruptionController``,
candidates, budgets, commands) is not here: it needs the cluster state,
the fake kube and cloud provider and the provisioner, which this package
does not carry yet (ROADMAP.md queue 1 item 13). ``examples.py`` drives
the controller's consolidation walks over a base snapshot instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Set

from ..apis.objects import Pod
from ..solver.types import SchedulingSnapshot, Solver

#: spot→spot single-node replacement needs this much cheaper-type
#: flexibility, or consolidation would chase churn for pennies.
MIN_SPOT_FLEXIBILITY = 15


@dataclass
class ReplacementQuery:
    """One hypothetical disruption: the pods that would go pending, the
    node/claim names that would vanish, and the strict price bound on
    any replacement type (0: no new node at all)."""
    pods: List[Pod]
    gone: Set[str]
    price_cap: int


@dataclass(frozen=True)
class SubsetVerdict:
    """One lane's answer from the whole-fleet search
    (``CUDAConsolidationEvaluator.subset_solve``): the EXACT outcome of
    the FFD re-solve of "cluster minus this subset" under the query's
    price cap. ``feasible`` (every pod absorbed) and ``n_new`` are
    decision gates, so the controller walks the same candidates the
    sequential oracle would; ``flex``/``min_price``/``savings`` are the
    on-device evidence for the winning lane."""
    feasible: bool
    n_new: int
    flex: int = 0
    min_price: int = 0
    savings: int = 0


class ConsolidationEvaluator:
    """Answers "can these pods be absorbed by existing capacity alone?"
    for a batch of deletion candidates. This base implementation runs
    the solver sequentially (the oracle); the CUDA evaluator batches all
    candidates into one device call."""

    def __init__(self, solver: Solver):
        self.solver = solver

    def deletions_feasible(
            self, snapshots: Sequence[SchedulingSnapshot]) -> List[bool]:
        out = []
        for snap in snapshots:
            res = self.solver.solve(snap)
            out.append(not res.new_nodes and not res.unschedulable)
        return out

    def replacements_prescreen(
            self, base: SchedulingSnapshot,
            queries: Sequence[ReplacementQuery]) -> List[bool]:
        """Exact-NO/maybe-YES per query: can the pods fit the surviving
        nodes plus at most one new node cheaper than the cap? False must
        be PROOF the replacement simulate would fail; True means "run
        the authoritative simulate". The base implementation prunes
        nothing."""
        return [True] * len(queries)

    def subset_solve(
            self, base: SchedulingSnapshot,
            queries: Sequence[ReplacementQuery],
    ) -> Optional[List[SubsetVerdict]]:
        """EXACT per-query verdicts for one stacked batch of "cluster
        minus subset" re-solves (both False and True are proofs), or
        None when the batch is not eligible; the caller then runs the
        sequential walk. The base implementation always defers."""
        return None
