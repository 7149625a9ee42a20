"""PodDisruptionBudget evaluation shared by the disruption controller
(candidate filtering: a node whose pod is covered by an exhausted PDB is
not a voluntary-disruption candidate) and the terminator (drain rounds
evict at most the remaining allowance per PDB; the claim's
terminationGracePeriod bypasses blocked PDBs the same way it bypasses
do-not-disrupt, karpenter.sh_nodepools.yaml:411)."""

from __future__ import annotations

from typing import List, Tuple


def pdb_state(kube) -> List[Tuple[object, int]]:
    """[(pdb, disruptions currently allowed)] — healthy = bound Running
    matching pods, the policy/v1 controller's healthy count."""
    pods = kube.list("Pod")
    out = []
    for pdb in kube.list("PodDisruptionBudget"):
        matching = [p for p in pods if pdb.matches(p)]
        healthy = sum(1 for p in matching
                      if p.node_name and p.phase == "Running")
        out.append((pdb, pdb.disruptions_allowed(matching, healthy)))
    return out


def blocking_pdb(state: List[Tuple[object, int]], pod):
    """The first exhausted PDB covering ``pod`` (None if evictable)."""
    for pdb, allowed in state:
        if allowed <= 0 and pdb.matches(pod):
            return pdb
    return None


def take_allowance(state: List[Tuple[object, int]], pod) -> bool:
    """Consume one eviction from every PDB covering ``pod``; False (and
    consume nothing) if any covering PDB is exhausted."""
    covering = [i for i, (pdb, _a) in enumerate(state) if pdb.matches(pod)]
    if any(state[i][1] <= 0 for i in covering):
        return False
    for i in covering:
        state[i] = (state[i][0], state[i][1] - 1)
    return True
