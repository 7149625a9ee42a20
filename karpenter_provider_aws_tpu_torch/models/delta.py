"""Incremental (dirty-set) snapshot encoding: resident arenas patched
between solves.

A copy of the reference package's models/delta.py on the port's own
classes. Where the reference may call its native ``deltawalk`` library
(host C++, still to port: ROADMAP.md), this copy runs the reference's
numpy branch; the metrics registry is not carried.

Reconcile ticks re-solve snapshots that are ~99% identical to the last
one (a few pods bound, one node launched). The ``DeltaEncoder`` keeps
the last solve's ``SnapshotEncoding`` (and existing-node tables)
RESIDENT and classifies each new snapshot against it:

- ``hit``    — nothing the tensors depend on changed: the resident
  encoding is returned as-is.
- ``rows``   — same signature set, same structure: only per-group pod
  membership/counts, pool in-use/limit vectors, or existing-node tables
  moved. The resident arrays are patched IN PLACE; every signature-
  derived tensor is untouched.
- ``groups`` — the signature SET changed: the group axis is rebuilt via
  ``encode_snapshot``, and existing-node compat rows are REMAPPED by
  signature from the resident matrix when the node set is unchanged.
- ``full``   — structural change (catalog/pool/daemon/zone objects,
  priority classes): the resident state is rebuilt from scratch and
  ``epoch`` bumps.

Oracle discipline: every returned encoding is ARRAY-FOR-ARRAY identical
to a from-scratch ``encode_snapshot`` of the same snapshot (and the
existing tables to ``full_existing_encode``); tests/test_torch_delta.py
holds it to that and to the reference encoder.

Staleness discipline: catalog/pool/daemon changes arrive as NEW objects,
so structure is diffed by OBJECT IDENTITY (the residency pins them, so
a recycled id never aliases a live key), while pods and existing nodes
are diffed by content. Pool in-use and limit vectors are recomputed and
compared every solve via ``pool_dynamic_vecs``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..solver.types import ExistingNode, SchedulingSnapshot
from .encoding import (SnapshotEncoding, canonical_pod_groups,
                       encode_snapshot, pool_dynamic_vecs)


@dataclass
class SnapshotDelta:
    """What changed vs the last-encoded snapshot — and how the encode
    was served. ``tier`` is the solver's honesty marker
    (``last_phase_stats["cache"]``); the dirty flags drive the packed-
    arena patch (solver/cuda.py ``_patch_pack_cache``: a clean flag
    means the resident packed section is still valid)."""
    tier: str                      # hit | rows | groups | full
    reason: str = ""               # full only: cold|structural-*
    #: group rows + existing-node columns patched/recomputed this encode
    patched_rows: int = 0
    groups_changed: int = 0
    pods_added: int = 0
    pods_removed: int = 0
    nodes_added: int = 0
    nodes_removed: int = 0
    nodes_changed: int = 0
    n_dirty: bool = False          # enc.n moved
    pools_dirty: bool = False      # pool limit/in-use vectors moved
    ex_rows_dirty: bool = False    # ex_alloc/ex_used moved (or E changed)
    ex_compat_dirty: bool = False  # ex_compat moved (or E changed)
    prio_dirty: bool = False       # enc.prio moved (group priorities)
    #: minimum canonical group index whose ROW moved this encode — the
    #: incremental-solve resume bound: the scan carry entering group i
    #: depends only on groups < i. 0 whenever anything OUTSIDE the group
    #: axis moved (pools, existing rows/compat, node set) or the tier is
    #: not rows. G (nothing moved) is possible on hit-tier encodes.
    dirty_frontier: int = 0

    def dirty_fields(self) -> Tuple[List[str], List[str]]:
        """The dirty flags as kernel-input field names, (int64 fields,
        bool fields) in arena layout order. A field NOT listed is
        byte-identical to the previous encode."""
        d64: List[str] = []
        db: List[str] = []
        if self.n_dirty:
            d64.append("n")
        if self.pools_dirty:
            d64 += ["pool_limit", "pool_used0"]
        if self.ex_rows_dirty:
            d64 += ["ex_alloc", "ex_used0"]
        if self.prio_dirty:
            d64.append("prio")
        if self.ex_compat_dirty:
            db.append("ex_compat")
        return d64, db


def structural_key(snapshot: SchedulingSnapshot) -> Tuple:
    """Identity key of everything that shapes the encoding's universe:
    nodepool objects + their resolved catalogs IN SNAPSHOT ORDER, daemon
    overhead objects, the zone map, and PriorityClass CONTENT."""
    return (
        tuple((id(spec.nodepool),) + tuple(id(t) for t in spec.instance_types)
              for spec in snapshot.nodepools),
        tuple(id(d) for d in snapshot.daemon_overheads),
        tuple(sorted(snapshot.zones.items())),
        tuple(sorted(
            (pc.metadata.name, pc.value, pc.global_default,
             pc.preemption_policy)
            for pc in getattr(snapshot, "priority_classes", ()))),
    )


def _skey_diff(old: Tuple, new: Tuple) -> str:
    for part, name in zip(range(4),
                          ("pools", "daemons", "zones", "priority")):
        if part < len(old) and part < len(new) and old[part] != new[part]:
            return name
    return "pools"


def _ex_rows(enc: SnapshotEncoding, existing: Sequence[ExistingNode]):
    """[E, D] allocatable / used tables. O(E x D) — always recomputed
    fresh (node ``used`` moves every tick); the delta path only diffs
    the RESULT to decide whether the packed arena section is dirty."""
    E, D = len(existing), len(enc.dims)
    dpos = {d: i for i, d in enumerate(enc.dims)}
    ex_alloc = np.zeros((E, D), dtype=np.int64)
    ex_used = np.zeros((E, D), dtype=np.int64)
    for ei, node in enumerate(existing):
        for k, q in node.allocatable.items():
            i = dpos.get(k)
            if i is not None:
                ex_alloc[ei, i] = q
        for k, q in node.used.items():
            i = dpos.get(k)
            if i is not None:
                ex_used[ei, i] = q
    return ex_alloc, ex_used


def _compat_col(groups, node: ExistingNode) -> np.ndarray:
    """[G] bool — which groups may land on this node (labels + taints).
    A pure function of (signature, node labels/taints): the delta path
    caches these columns per node and recomputes only when the node's
    token (labels + taints content) moves."""
    col = np.zeros(len(groups), dtype=bool)
    for g in groups:
        pod = g.pods[0]
        col[g.index] = (g.reqs.satisfied_by_labels(node.labels)
                        and all(t.tolerated_by(pod.tolerations)
                                for t in node.taints))
    return col


def full_existing_encode(enc: SnapshotEncoding,
                         existing: Sequence[ExistingNode]):
    """From-scratch (ex_alloc, ex_used, ex_compat) — the existing-node
    oracle every delta path must match byte-for-byte."""
    ex_alloc, ex_used = _ex_rows(enc, existing)
    ex_compat = np.zeros((len(enc.groups), len(existing)), dtype=bool)
    for ei, node in enumerate(existing):
        ex_compat[:, ei] = _compat_col(enc.groups, node)
    return ex_alloc, ex_used, ex_compat


def _node_token(node: ExistingNode) -> Tuple:
    """Content token guarding compat-column reuse. COPIES, not
    references: a caller mutating a reused node object in place must
    invalidate the column, which an aliased dict could never detect."""
    return (dict(node.labels), tuple(node.taints))


class DeltaEncoder:
    """Resident-arena incremental encoder (see module docstring).

    One instance per solver; not thread-safe. ``encode`` is a drop-in
    for ``encode_snapshot`` + ``full_existing_encode`` that additionally
    returns the ``SnapshotDelta`` classification."""

    def __init__(self):
        #: resident state: the last encoding and its derivation inputs
        self._enc: Optional[SnapshotEncoding] = None
        self._sigs: Tuple = ()
        self._skey: Optional[Tuple] = None
        #: pins for the id()-keyed structural diff
        self._pins: Tuple = ()
        self._dpos: Dict[str, int] = {}
        self._ex_names: List[str] = []
        self._ex_tok: Dict[str, Tuple] = {}
        self._ex_alloc: Optional[np.ndarray] = None
        self._ex_used: Optional[np.ndarray] = None
        self._ex_compat: Optional[np.ndarray] = None
        #: bumps on every STRUCTURAL rebuild
        self.epoch = 0
        #: bumps whenever the returned arrays differ from the previous
        #: encode's (any dirty flag, or a new encoding object). The
        #: packed-arena cache (solver/cuda.py) records the version its
        #: buffer reflects; lagging more than one version forces a
        #: re-pack instead of a patch
        self.version = 0
        self.last_delta: Optional[SnapshotDelta] = None

    # -- public entry --------------------------------------------------
    def state_token(self) -> Tuple[int, int]:
        """(epoch, version): equal tokens mean the encoder's arrays are
        exactly the ones a caller captured."""
        return (self.epoch, self.version)

    def encode(self, snapshot: SchedulingSnapshot, pod_groups,
               existing: Sequence[ExistingNode]):
        """(enc, (ex_alloc, ex_used, ex_compat), SnapshotDelta) for this
        snapshot. ``existing`` must be the name-sorted node list the
        solver decodes against."""
        if pod_groups is None:
            pod_groups = canonical_pod_groups(snapshot.pods)
        if self._enc is None:
            return self._full(snapshot, pod_groups, existing, "cold", False)
        skey = structural_key(snapshot)
        if skey != self._skey:
            reason = "structural-" + _skey_diff(self._skey, skey)
            return self._full(snapshot, pod_groups, existing, reason, True)
        sigs = tuple(s for s, _ in pod_groups)
        if sigs != self._sigs:
            return self._tier_groups(snapshot, pod_groups, existing)
        return self._tier_rows(snapshot, pod_groups, existing)

    # -- tiers ---------------------------------------------------------
    def _full(self, snapshot, pod_groups, existing, reason: str,
              structural: bool):
        enc = encode_snapshot(snapshot, pod_groups=pod_groups)
        ex = full_existing_encode(enc, existing)
        self._adopt(snapshot, enc, pod_groups, existing, ex)
        if structural:
            self.epoch += 1
        self.version += 1
        d = SnapshotDelta(tier="full", reason=reason, n_dirty=True,
                          pools_dirty=True, ex_rows_dirty=True,
                          ex_compat_dirty=True,
                          prio_dirty=enc.prio is not None)
        self.last_delta = d
        return enc, ex, d

    def _tier_groups(self, snapshot, pod_groups, existing):
        """Signature set changed under a stable structural universe: the
        group axis is rebuilt, and resident existing-compat ROWS are
        remapped by signature when the node set is unchanged."""
        old_enc, old_compat = self._enc, self._ex_compat
        old_row = {g.sig: g.index for g in old_enc.groups}
        enc = encode_snapshot(snapshot, pod_groups=pod_groups)
        ex_alloc, ex_used = _ex_rows(enc, existing)
        names = [n.name for n in existing]
        E, G = len(existing), len(enc.groups)
        remap_ok = (old_compat is not None and names == self._ex_names
                    and all(self._ex_tok.get(n.name) == _node_token(n)
                            for n in existing))
        ex_compat = np.zeros((G, E), dtype=bool)
        new_rows = 0
        if remap_ok:
            for g in enc.groups:
                oi = old_row.get(g.sig)
                if oi is None:
                    if E:
                        for ei, node in enumerate(existing):
                            pod = g.pods[0]
                            ex_compat[g.index, ei] = (
                                g.reqs.satisfied_by_labels(node.labels)
                                and all(t.tolerated_by(pod.tolerations)
                                        for t in node.taints))
                    new_rows += 1
                else:
                    ex_compat[g.index] = old_compat[oi]
        else:
            for ei, node in enumerate(existing):
                ex_compat[:, ei] = _compat_col(enc.groups, node)
            new_rows = G
        self._adopt(snapshot, enc, pod_groups, existing,
                    (ex_alloc, ex_used, ex_compat))
        self.version += 1
        d = SnapshotDelta(tier="groups", patched_rows=new_rows,
                          groups_changed=abs(G - len(old_row)) or 1,
                          n_dirty=True, pools_dirty=True,
                          ex_rows_dirty=True, ex_compat_dirty=True,
                          prio_dirty=enc.prio is not None)
        self.last_delta = d
        return enc, (ex_alloc, ex_used, ex_compat), d

    def _tier_rows(self, snapshot, pod_groups, existing):
        """Same signature set, same structural universe: group positions
        align with the resident encoding and every signature-derived
        tensor is already correct. Patch what can move: pod membership/
        counts, pool dynamic vectors, existing-node tables."""
        enc = self._enc
        d = SnapshotDelta(tier="hit", dirty_frontier=len(pod_groups))
        n = enc.n
        for i, (_sig, plist) in enumerate(pod_groups):
            g = enc.groups[i]
            old = g.pods
            if old is plist:
                continue
            if len(old) == len(plist) and \
                    all(a is b for a, b in zip(old, plist)):
                # same members behind a rebuilt list: adopt silently so
                # the identity fast path stays warm next tick
                g.pods = plist
                continue
            # the loop ascends canonical order, so the FIRST dirty group
            # is the min — membership churn counts even when the count
            # is unchanged
            d.dirty_frontier = min(d.dirty_frontier, i)
            d.groups_changed += 1
            d.pods_added += max(0, len(plist) - len(old))
            d.pods_removed += max(0, len(old) - len(plist))
            g.pods = plist
            if n[i] != len(plist):
                n[i] = len(plist)
                d.n_dirty = True
        # pool dynamic vectors: recomputed every tick through the SAME
        # derivation encode_snapshot uses, then diffed
        dpos = self._dpos
        D = len(enc.dims)
        ordered = sorted(
            snapshot.nodepools,
            key=lambda s: (-s.nodepool.weight, s.nodepool.metadata.name))
        for pe, spec in zip(enc.pools, ordered):
            lim, iu = pool_dynamic_vecs(spec, D, dpos)
            if not np.array_equal(iu, pe.in_use_vec):
                pe.in_use_vec = iu
                d.pools_dirty = True
            if (lim is None) != (pe.limit_vec is None) or (
                    lim is not None
                    and not np.array_equal(lim, pe.limit_vec)):
                pe.limit_vec = lim
                d.pools_dirty = True
            pe.spec = spec
        self._patch_existing(enc, existing, d)
        d.patched_rows = (d.groups_changed + d.nodes_added
                          + d.nodes_changed)
        if (d.pools_dirty or d.ex_rows_dirty or d.ex_compat_dirty
                or d.nodes_added or d.nodes_removed or d.nodes_changed):
            # node-side dirtiness feeds the scan's initial carry (pool
            # vectors, existing rows) or every step (compat): no prefix
            # checkpoint survives it
            d.dirty_frontier = 0
        if (d.groups_changed or d.n_dirty or d.pools_dirty
                or d.ex_rows_dirty or d.ex_compat_dirty
                or d.nodes_added or d.nodes_removed or d.nodes_changed):
            d.tier = "rows"
        if (d.n_dirty or d.pools_dirty or d.ex_rows_dirty
                or d.ex_compat_dirty):
            self.version += 1
        self.last_delta = d
        return enc, (self._ex_alloc, self._ex_used, self._ex_compat), d

    # -- existing-node residency ---------------------------------------
    def _patch_existing(self, enc, existing, d: SnapshotDelta):
        ex_alloc, ex_used = _ex_rows(enc, existing)
        if not (np.array_equal(ex_alloc, self._ex_alloc)
                and np.array_equal(ex_used, self._ex_used)):
            d.ex_rows_dirty = True
        self._ex_alloc, self._ex_used = ex_alloc, ex_used
        names = [n.name for n in existing]
        tok = self._ex_tok
        if names == self._ex_names:
            for ei, node in enumerate(existing):
                if tok.get(node.name) == _node_token(node):
                    continue
                self._ex_compat[:, ei] = _compat_col(enc.groups, node)
                tok[node.name] = _node_token(node)
                d.nodes_changed += 1
                d.ex_compat_dirty = True
            return
        # node set moved: rebuild the matrix, reusing unchanged columns
        old_idx = {nm: i for i, nm in enumerate(self._ex_names)}
        G, E = len(enc.groups), len(existing)
        new_compat = np.zeros((G, E), dtype=bool)
        new_tok: Dict[str, Tuple] = {}
        for ei, node in enumerate(existing):
            oi = old_idx.get(node.name)
            t = _node_token(node)
            if oi is not None and tok.get(node.name) == t:
                new_compat[:, ei] = self._ex_compat[:, oi]
            else:
                new_compat[:, ei] = _compat_col(enc.groups, node)
                if oi is None:
                    d.nodes_added += 1
                else:
                    d.nodes_changed += 1
            new_tok[node.name] = t
        d.nodes_removed = sum(1 for nm in self._ex_names
                              if nm not in new_tok)
        self._ex_compat, self._ex_tok = new_compat, new_tok
        self._ex_names = names
        d.ex_compat_dirty = True

    # -- residency bookkeeping -----------------------------------------
    def _adopt(self, snapshot, enc, pod_groups, existing, ex):
        self._enc = enc
        self._sigs = tuple(s for s, _ in pod_groups)
        self._skey = structural_key(snapshot)
        self._pins = (tuple(s.nodepool for s in snapshot.nodepools),
                      tuple(tuple(s.instance_types)
                            for s in snapshot.nodepools),
                      tuple(snapshot.daemon_overheads))
        self._dpos = {dd: i for i, dd in enumerate(enc.dims)}
        self._ex_names = [n.name for n in existing]
        self._ex_tok = {n.name: _node_token(n) for n in existing}
        self._ex_alloc, self._ex_used, self._ex_compat = ex
