"""The CUDA consolidation evaluator: every candidate of a consolidation
round in one device call (the reference package's
``solver/consolidation.py`` ``TPUConsolidationEvaluator``).

Three questions, three batched answers (ops/consolidation_torch.py):

- ``deletions_feasible``: one deletion-check snapshot per candidate
  (pools price-filtered to nothing, existing = cluster minus the
  candidate). The shared-table fast path encodes the node tensors and
  per-signature compatibility rows ONCE and each candidate as index
  vectors (``consol_absorb`` "deletions"); a heterogeneous batch (one
  node name, different node objects) takes the dense path (per-lane
  tables, "dense").
- ``replacements_prescreen``: exact-NO/maybe-YES for "the pods fit the
  survivors plus ONE cheaper node" ("prescreen").
- ``subset_solve``: the whole-fleet search. ONE union arena over the base
  cluster plus every queried pod (its own delta encoder, so a stable
  cluster pays patches, not re-encodes), and one lane per query: its
  group rows, its dead nodes, its price-capped types. ``CUDASolver.
  dispatch_subsets`` answers every lane with the whole FFD scan; the
  verdict gates are exact.

There is no router, host twin or fallback: on ``cuda`` (the default;
it raises without a card) every batch runs the kernels, and an error in
a dispatch propagates. ``device="cpu"`` runs the plain versions.
``subset_solve`` returns None only for the reference's eligibility
reasons (topology, no_types, minvalues, group_cap, preferences,
no_pods), each counted in ``fallbacks``. A topology candidate in
``deletions_feasible`` goes to ``solver.solve``, which answers it on the
host pour (ops/topo.py): a deletion snapshot has existing nodes and no
instance types, both outside the device pour's envelope.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import device as _device
from ..controllers.disruption import ConsolidationEvaluator, SubsetVerdict
from ..models.delta import DeltaEncoder
from ..models.encoding import canonical_pod_groups
from ..ops import consolidation_torch as ct
from .cuda import CUDASolver
from .preferences import preference_count
from .types import ExistingNode, SchedulingSnapshot, Solver

BIG = np.int64(1) << 60


def _pow2(x: int) -> int:
    return max(1, 1 << (x - 1).bit_length())


class _GroupTables:
    """Shared batch-encoding of pod lists into signature/profile tables:
    the one implementation of constraint-profile identity for the
    deletion kernel and the replacement pre-screen (a profile = selector,
    affinity terms, tolerations, volume reqs: everything
    scheduling_requirements/taint-compat can see — sig indices 0,1,3,7)."""

    __slots__ = ("sig_groups", "ckeys", "ckey_groups", "sig_ckey",
                 "per_rows", "dims", "dpos", "G")

    def __init__(self, pod_lists):
        dims_set = {"cpu", "memory", "pods"}
        sig_of: Dict[Tuple, int] = {}
        ckey_of: Dict[Tuple, int] = {}
        self.sig_groups: List = []   # representative pod per signature
        self.ckeys: List[Tuple] = []  # profile key per profile index
        self.ckey_groups: List = []  # representative pod per profile
        self.sig_ckey: List[int] = []
        self.per_rows: List[List[Tuple[int, int]]] = []
        self.G = 1
        for pods in pod_lists:
            rows: List[Tuple[int, int]] = []
            for sig, plist in canonical_pod_groups(pods):
                p = plist[0]
                dims_set.update(p.effective_requests().nonzero_keys())
                si = sig_of.get(sig)
                if si is None:
                    si = sig_of[sig] = len(self.sig_groups)
                    self.sig_groups.append(p)
                    ck = (sig[0], sig[1], sig[3], sig[7])
                    ci = ckey_of.get(ck)
                    if ci is None:
                        ci = ckey_of[ck] = len(self.ckey_groups)
                        self.ckeys.append(ck)
                        self.ckey_groups.append(p)
                    self.sig_ckey.append(ci)
                rows.append((si, len(plist)))
            self.per_rows.append(rows)
            self.G = max(self.G, len(rows))
        self.dims = sorted(dims_set)
        self.dpos = {d: i for i, d in enumerate(self.dims)}

    def vec(self, r) -> np.ndarray:
        v = np.zeros(len(self.dims), dtype=np.int64)
        for k, q in r.items():
            i = self.dpos.get(k)
            if i is not None:
                v[i] = q
        return v

    def r_tab(self, Sp: int, Dp: int) -> np.ndarray:
        R = np.zeros((Sp, Dp), dtype=np.int64)
        D = len(self.dims)
        for si, rep in enumerate(self.sig_groups):
            R[si, :D] = self.vec(rep.effective_requests())
        return R

    def node_compat(self, Scp: int, Ep: int, by_name, npos) -> np.ndarray:
        compat = np.zeros((Scp, Ep), dtype=bool)
        for ci, rep in enumerate(self.ckey_groups):
            reqs = rep.scheduling_requirements()
            for name, node in by_name.items():
                compat[ci, npos[name]] = (
                    reqs.satisfied_by_labels(node.labels)
                    and all(t.tolerated_by(rep.tolerations)
                            for t in node.taints))
        return compat


class CUDAConsolidationEvaluator(ConsolidationEvaluator):
    #: slot bucket of the subset lanes: every gate the controller reads
    #: (feasible, n_new in {0, 1}) is decided exactly at two new-node
    #: slots — a re-solve needing more than 2 nodes either strands pods
    #: or mints a second node, and both read as "gate false", which is
    #: exactly the oracle's skip
    SUBSET_N_MAX = 2

    def __init__(self, solver: Optional[Solver] = None, device=None):
        self.device = _device.resolve(device)
        super().__init__(solver if solver is not None
                         else CUDASolver(device=self.device))
        #: eligibility reason -> subset_solve rounds that returned None
        self.fallbacks: Dict[str, int] = {}
        #: catalog-derived pre-screen tables, reused while the pools'
        #: resolved InstanceTypes lists are unchanged: a small LRU
        #: (multi-nodepool reconciles interleave distinct bases). Values
        #: hold strong refs (_refs) to the nodepools + type lists their
        #: key ids point at, so an id is never recycled while its entry
        #: lives
        self._base_cache: "OrderedDict[Tuple, dict]" = OrderedDict()
        self._base_cache_cap = 4
        #: last-seen ``solver.arena_epoch()``: a move means the inner
        #: solver's encoder rebuilt its structural universe, and the
        #: identity-keyed cache drops its entries with it
        self._base_epoch = None
        #: resident union-arena encoder of the subset search
        self._sub_delta = DeltaEncoder()
        #: (enc, version, arrays, stt, tprice) of the last subset round,
        #: reused verbatim while the encoder's version is unchanged
        self._sub_prep: Optional[Tuple] = None
        #: wall split of the LAST subset round (ms): encode (delta
        #: encode + pad), lanes (lane stacks), device (dispatch_subsets:
        #: copies, launches, the rows back), decode (verdicts)
        self.last_phase_stats: dict = {}

    # ------------------------------------------------------------------
    def deletions_feasible(
            self, snapshots: Sequence[SchedulingSnapshot]) -> List[bool]:
        if not snapshots:
            return []
        out: List[Optional[bool]] = [None] * len(snapshots)
        batch_idx: List[int] = []
        for i, snap in enumerate(snapshots):
            if any(p.topology_spread or p.pod_affinity for p in snap.pods):
                # the solver's own path for topology: the host pour
                res = self.solver.solve(snap)
                out[i] = not res.new_nodes and not res.unschedulable
            elif not snap.pods:
                out[i] = True
            elif not snap.existing_nodes:
                out[i] = False
            else:
                batch_idx.append(i)
        if batch_idx:
            batch = [snapshots[i] for i in batch_idx]
            flags = self._evaluate_shared(batch)
            if flags is None:
                flags = self._evaluate_dense(batch)
            for i, ok in zip(batch_idx, flags):
                out[i] = bool(ok)
        return out  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # replacement pre-screen (batched "± one cheaper node" search)
    # ------------------------------------------------------------------
    def replacements_prescreen(self, base, queries) -> List[bool]:
        """Batched exact-NO/maybe-YES for the replacement search. Queries
        whose pods carry topology/affinity constraints are never pruned
        (the authoritative simulate decides); everything else is one
        ``replacements_prescreen`` call."""
        if not queries:
            return []
        out: List[Optional[bool]] = [None] * len(queries)
        batch_idx: List[int] = []
        for i, q in enumerate(queries):
            if not q.pods:
                out[i] = True
            elif any(p.topology_spread or p.pod_affinity for p in q.pods):
                out[i] = True
            else:
                batch_idx.append(i)
        if batch_idx:
            flags = self._prescreen_batch(
                base, [queries[i] for i in batch_idx])
            for i, ok in zip(batch_idx, flags):
                out[i] = bool(ok)
        return out  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # whole-fleet search (subset lanes over one union arena)
    # ------------------------------------------------------------------
    def subset_solve(self, base, queries):
        """EXACT per-query verdicts for the whole-fleet replacement
        search: ONE union arena over the base cluster plus every queried
        pod, one lane per query (deletion checks at price_cap=0 and
        cheaper-replacement queries alike), one ``dispatch_subsets``.
        Returns None for an ineligible round (``fallbacks`` counts the
        reason); the caller then runs the sequential walk."""
        if not queries:
            return []
        for q in queries:
            for p in q.pods:
                if p.topology_spread or p.pod_affinity:
                    return self._subset_fallback("topology")
        # union pod set: every queried pod once (prefix queries overlap)
        union_pods: List = []
        seen = set()
        for q in queries:
            for p in q.pods:
                if id(p) not in seen:
                    seen.add(id(p))
                    union_pods.append(p)
        if not union_pods:
            return self._subset_fallback("no_pods")
        pod_groups = canonical_pod_groups(union_pods)
        if any(preference_count(plist[0]) for _sig, plist in pod_groups):
            # preference relaxation is an outer host loop: a subset lane
            # cannot iterate it
            return self._subset_fallback("preferences")
        return self._subset_dispatch(base, queries, union_pods, pod_groups)

    def _subset_fallback(self, reason: str):
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        return None

    def _subset_dispatch(self, base, queries, union_pods, pod_groups):
        solver = self.solver
        t0 = time.perf_counter()
        existing = sorted(base.existing_nodes, key=lambda n: n.name)
        union = SchedulingSnapshot(
            pods=union_pods, nodepools=base.nodepools,
            existing_nodes=existing,
            daemon_overheads=base.daemon_overheads, zones=base.zones)
        enc, (ex_alloc, ex_used, ex_compat), _d = \
            self._sub_delta.encode(union, pod_groups, existing)
        if enc.topo_any:
            return self._subset_fallback("topology")
        if not enc.types:
            return self._subset_fallback("no_types")
        if enc.mv_K:
            # minValues floors couple lanes to pool-level argmin state;
            # the per-prefix simulate handles them exactly
            return self._subset_fallback("minvalues")
        if len(enc.groups) > solver.dev_max_groups:
            return self._subset_fallback("group_cap")

        # padded union arena, reused verbatim while the encoder's version
        # is unchanged (a version bump means some returned array moved);
        # unfused: the subset lanes scan F = 1, as the reference's
        # ndev=2 call here skips its fuse plan
        ver = self._sub_delta.version
        if (self._sub_prep is not None and self._sub_prep[0] is enc
                and self._sub_prep[1] == ver):
            arrays, stt, tprice = self._sub_prep[2:]
        else:
            arrays, stt = solver._prep_device_inputs(enc, ex_alloc, ex_used,
                                                     ex_compat, fuse=False)
            tprice = np.full(len(enc.types), BIG, dtype=np.int64)
            for ti, it in enumerate(enc.types):
                p = it.cheapest_price()
                if p is not None:
                    tprice[ti] = p
            self._sub_prep = (enc, ver, arrays, stt, tprice)
        t_enc = time.perf_counter()

        # lane stacks: gid/n gather each query's groups out of the union
        # tables (canonical group order is restriction-stable, so the
        # gathered rows ARE the query's own canonical encoding order)
        sig_row = {g.sig: g.index for g in enc.groups}
        npos = {n.name: i for i, n in enumerate(existing)}
        B = len(queries)
        per_rows = [[(sig_row[s], len(plist))
                     for s, plist in canonical_pod_groups(q.pods)]
                    for q in queries]
        Gq = _pow2(max((len(r) for r in per_rows), default=1))
        Bp = _pow2(B)
        E, T = stt["E"], len(enc.types)
        gid = np.zeros((Bp, Gq), dtype=np.int32)
        nq = np.zeros((Bp, Gq), dtype=np.int64)
        dead = np.zeros((Bp, E), dtype=bool)
        keep = np.zeros((Bp, T), dtype=bool)
        rprice = np.zeros(Bp, dtype=np.int64)
        for b, q in enumerate(queries):
            for j, (si, cnt) in enumerate(per_rows[b]):
                gid[b, j] = si
                nq[b, j] = cnt
            for name in q.gone:
                ei = npos.get(name)  # claim names are not node rows
                if ei is not None:
                    dead[b, ei] = True
            # the simulate's price filter: strictly cheaper, priced
            keep[b] = tprice < q.price_cap
            rprice[b] = q.price_cap
        t_lanes = time.perf_counter()
        out = solver.dispatch_subsets(
            arrays, tprice=tprice, gid=gid, n=nq, dead=dead, keep=keep,
            removed_price=rprice, n_max=self.SUBSET_N_MAX, E=E, P=stt["P"])
        t_dev = time.perf_counter()
        verdicts = [SubsetVerdict(feasible=int(r[0]) == 0, n_new=int(r[1]),
                                  flex=int(r[2]), min_price=int(r[3]),
                                  savings=int(r[4]))
                    for r in out[:B]]
        self.last_phase_stats = dict(
            encode_ms=(t_enc - t0) * 1e3, lanes_ms=(t_lanes - t_enc) * 1e3,
            device_ms=(t_dev - t_lanes) * 1e3,
            decode_ms=(time.perf_counter() - t_dev) * 1e3,
            lanes=B, padded_lanes=Bp, groups=Gq, cache=_d.tier)
        return verdicts

    def _base_tables(self, base) -> dict:
        """Catalog-derived tables (unique types, dense allocatable,
        cheapest prices, lazily filled per-profile compat rows). Cached
        on the identity of the pools' resolved type lists + nodepool
        hashes + requirement tuples (NodePool.hash() does not cover
        template.requirements, and padmit rows depend on both); the
        entry holds strong refs so ids cannot be recycled, and the cache
        drops whole when the inner solver's ``arena_epoch()`` moves."""
        tok = self.solver.arena_epoch() \
            if hasattr(self.solver, "arena_epoch") else None
        if tok is not None and tok != self._base_epoch:
            if self._base_epoch is not None:
                self._base_cache.clear()
            self._base_epoch = tok
        key = tuple(
            x for spec in base.nodepools
            for x in (spec.nodepool.hash(),
                      tuple((r.key, r.complement, r.values,
                             r.greater_than, r.less_than)
                            for r in spec.nodepool.scheduling_requirements()),
                      id(spec.instance_types)))
        hit = self._base_cache.get(key)
        if hit is not None:
            self._base_cache.move_to_end(key)
            return hit
        types: List = []
        tpos: Dict[int, int] = {}
        pool_rows: List[List[int]] = []
        for spec in base.nodepools:
            rows = []
            for it in spec.instance_types:
                ti = tpos.get(id(it))
                if ti is None:
                    ti = tpos[id(it)] = len(types)
                    types.append(it)
                rows.append(ti)
            pool_rows.append(rows)
        T = len(types)
        cdims = sorted({k for it in types
                        for k in it.allocatable().nonzero_keys()})
        cpos = {d: j for j, d in enumerate(cdims)}
        alloc = np.zeros((T, len(cdims)), dtype=np.int64)
        price = np.full(T, BIG, dtype=np.int64)
        for ti, it in enumerate(types):
            for k, q in it.allocatable().items():
                j = cpos.get(k)
                if j is not None:
                    alloc[ti, j] = q
            p = it.cheapest_price()
            if p is not None:
                price[ti] = p
        tab = dict(types=types, pool_rows=pool_rows, cdims=cdims,
                   alloc=alloc, price=price, tcompat={}, padmit={},
                   _refs=[(s.nodepool, s.instance_types)
                          for s in base.nodepools])
        self._base_cache[key] = tab
        while len(self._base_cache) > self._base_cache_cap:
            self._base_cache.popitem(last=False)
        return tab

    def _prescreen_batch(self, base, queries) -> np.ndarray:
        node_names = sorted(n.name for n in base.existing_nodes)
        npos = {name: i for i, name in enumerate(node_names)}
        by_name = {n.name: n for n in base.existing_nodes}
        E = len(node_names)

        tab = self._base_tables(base)
        types, pool_rows = tab["types"], tab["pool_rows"]
        T, P = len(types), len(base.nodepools)

        gt = _GroupTables([q.pods for q in queries])
        D = len(gt.dims)
        S, Sc = len(gt.sig_groups), len(gt.ckey_groups)

        B = len(queries)
        Bp, Gp, Ep = _pow2(B), _pow2(gt.G), _pow2(max(1, E))
        Sp, Scp, Tp, Pp, Dp = (_pow2(S), _pow2(Sc), _pow2(max(1, T)),
                               _pow2(max(1, P)), max(8, D))

        ex_alloc = np.zeros((Ep, Dp), dtype=np.int64)
        ex_used = np.zeros((Ep, Dp), dtype=np.int64)
        for name, node in by_name.items():
            ei = npos[name]
            ex_alloc[ei, :D] = gt.vec(node.allocatable)
            ex_used[ei, :D] = gt.vec(node.used)

        compat_tab = np.zeros((Scp, Ep), dtype=bool)
        compat_tab[:Sc, :E] = gt.node_compat(Sc, E, by_name, npos)
        tcompat = np.zeros((Scp, Tp), dtype=bool)
        padmit = np.zeros((Pp, Scp), dtype=bool)
        # the per-profile memos live as long as the catalog cache entry;
        # churning workloads can mint unbounded distinct profiles
        if len(tab["tcompat"]) > 4096:
            tab["tcompat"].clear()
            tab["padmit"].clear()
        for ci, (ck, rep) in enumerate(zip(gt.ckeys, gt.ckey_groups)):
            reqs = rep.scheduling_requirements()
            trow = tab["tcompat"].get(ck)
            if trow is None:
                trow = np.fromiter(
                    (not it.requirements.conflicts(reqs)
                     and bool(it.offerings.available().compatible(reqs))
                     for it in types), dtype=bool, count=T)
                tab["tcompat"][ck] = trow
            tcompat[ci, :T] = trow
            prow = tab["padmit"].get(ck)
            if prow is None:
                prow = np.fromiter(
                    (not spec.nodepool.scheduling_requirements()
                     .compatible(reqs)
                     and all(t.tolerated_by(rep.tolerations)
                             for t in spec.nodepool.template.taints)
                     for spec in base.nodepools), dtype=bool, count=P)
                tab["padmit"][ck] = prow
            padmit[:P, ci] = prow

        type_alloc = np.zeros((Tp, Dp), dtype=np.int64)
        for i, d in enumerate(gt.dims):
            if d in tab["cdims"]:
                type_alloc[:T, i] = tab["alloc"][:, tab["cdims"].index(d)]
        type_price = np.full(Tp, BIG, dtype=np.int64)
        type_price[:T] = tab["price"]
        pool_types = np.zeros((Pp, Tp), dtype=bool)
        for pi, rows in enumerate(pool_rows):
            pool_types[pi, rows] = True

        R_tab = gt.r_tab(Sp, Dp)

        gid = np.zeros((Bp, Gp), dtype=np.int32)
        cid = np.zeros((Bp, Gp), dtype=np.int32)
        n = np.zeros((Bp, Gp), dtype=np.int64)
        alive = np.zeros((Bp, Ep), dtype=bool)
        price_cap = np.zeros(Bp, dtype=np.int64)
        for bi, q in enumerate(queries):
            for gi, (si, cnt) in enumerate(gt.per_rows[bi]):
                gid[bi, gi] = si
                cid[bi, gi] = gt.sig_ckey[si]
                n[bi, gi] = cnt
            for name, ei in npos.items():
                alive[bi, ei] = name not in q.gone
            price_cap[bi] = q.price_cap

        t = _device.upload(dict(
            ex_alloc=ex_alloc, ex_used0=ex_used, compat_tab=compat_tab,
            R_tab=R_tab, type_alloc=type_alloc, type_price=type_price,
            tcompat=tcompat, padmit=padmit, pool_types=pool_types, gid=gid,
            cid=cid, n=n, alive=alive, price_cap=price_cap), self.device)
        return ct.replacements_prescreen(**t).cpu().numpy()[:B]

    # ------------------------------------------------------------------
    # shared-table fast path
    # ------------------------------------------------------------------
    def _evaluate_shared(
            self, snaps: List[SchedulingSnapshot]) -> Optional[np.ndarray]:
        """Encode against one shared node table; None if the batch is not
        table-shaped (same node name, different node object contents)."""
        by_name: Dict[str, ExistingNode] = {}
        for snap in snaps:
            for node in snap.existing_nodes:
                prev = by_name.setdefault(node.name, node)
                if prev is not node:
                    return None  # heterogeneous batch -> dense path
        node_names = sorted(by_name)
        npos = {name: i for i, name in enumerate(node_names)}
        E = len(node_names)

        gt = _GroupTables([snap.pods for snap in snaps])
        D = len(gt.dims)
        S, Sc = len(gt.sig_groups), len(gt.ckey_groups)

        B = len(snaps)
        Bp, Gp, Ep = _pow2(B), _pow2(gt.G), _pow2(E)
        Sp, Scp, Dp = _pow2(S), _pow2(Sc), max(8, D)

        ex_alloc = np.zeros((Ep, Dp), dtype=np.int64)
        ex_used = np.zeros((Ep, Dp), dtype=np.int64)
        for name, node in by_name.items():
            ei = npos[name]
            ex_alloc[ei, :D] = gt.vec(node.allocatable)
            ex_used[ei, :D] = gt.vec(node.used)

        compat_tab = np.zeros((Scp, Ep), dtype=bool)
        compat_tab[:Sc, :E] = gt.node_compat(Sc, E, by_name, npos)
        R_tab = gt.r_tab(Sp, Dp)

        gid = np.zeros((Bp, Gp), dtype=np.int32)
        cid = np.zeros((Bp, Gp), dtype=np.int32)
        n = np.zeros((Bp, Gp), dtype=np.int64)
        alive = np.zeros((Bp, Ep), dtype=bool)
        for bi, snap in enumerate(snaps):
            for gi, (si, cnt) in enumerate(gt.per_rows[bi]):
                gid[bi, gi] = si
                cid[bi, gi] = gt.sig_ckey[si]
                n[bi, gi] = cnt
            for node in snap.existing_nodes:
                alive[bi, npos[node.name]] = True

        t = _device.upload(dict(ex_alloc=ex_alloc, ex_used0=ex_used,
                                compat_tab=compat_tab, R_tab=R_tab, gid=gid,
                                cid=cid, n=n, alive=alive), self.device)
        return ct.deletions_feasible(**t).cpu().numpy()[:B]

    # ------------------------------------------------------------------
    # dense path (heterogeneous batches)
    # ------------------------------------------------------------------
    def _evaluate_dense(self, snaps: List[SchedulingSnapshot]) -> np.ndarray:
        B = len(snaps)
        dims_set = {"cpu", "memory", "pods"}
        for snap in snaps:
            for p in snap.pods:
                dims_set.update(p.effective_requests().nonzero_keys())
        dims = sorted(dims_set)
        dpos = {d: i for i, d in enumerate(dims)}
        D = len(dims)
        E = max(len(snap.existing_nodes) for snap in snaps)

        def vec(r) -> np.ndarray:
            v = np.zeros(D, dtype=np.int64)
            for k, q in r.items():
                i = dpos.get(k)
                if i is not None:
                    v[i] = q
            return v

        per_snap_groups = []
        G = 1
        for snap in snaps:
            groups = [(plist[0], plist)
                      for _sig, plist in canonical_pod_groups(snap.pods)]
            per_snap_groups.append(groups)
            G = max(G, len(groups))

        Bp, Gp, Ep, Dp = _pow2(B), _pow2(G), _pow2(E), max(8, D)
        ex_alloc = np.zeros((Bp, Ep, Dp), dtype=np.int64)
        ex_used = np.zeros((Bp, Ep, Dp), dtype=np.int64)
        ex_compat = np.zeros((Bp, Gp, Ep), dtype=bool)
        R = np.zeros((Bp, Gp, Dp), dtype=np.int64)
        n = np.zeros((Bp, Gp), dtype=np.int64)

        for bi, snap in enumerate(snaps):
            nodes = sorted(snap.existing_nodes, key=lambda x: x.name)
            for ei, node in enumerate(nodes):
                ex_alloc[bi, ei, :D] = vec(node.allocatable)
                ex_used[bi, ei, :D] = vec(node.used)
            for gi, (rep, pods) in enumerate(per_snap_groups[bi]):
                R[bi, gi, :D] = vec(rep.effective_requests())
                n[bi, gi] = len(pods)
                reqs = rep.scheduling_requirements()
                for ei, node in enumerate(nodes):
                    ex_compat[bi, gi, ei] = (
                        reqs.satisfied_by_labels(node.labels)
                        and all(t.tolerated_by(rep.tolerations)
                                for t in node.taints))

        t = _device.upload(dict(ex_alloc=ex_alloc, ex_used0=ex_used,
                                ex_compat=ex_compat, R=R, n=n), self.device)
        return ct.deletions_feasible_dense(**t).cpu().numpy()[:B]
