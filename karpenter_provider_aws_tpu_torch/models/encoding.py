"""Constraint-tensor encoding: SchedulingSnapshot -> dense arrays.

This is the lowering from the requirements algebra (apis/requirements.py)
to the tensors the device kernels consume — the "model" of this framework.

Encoding scheme
---------------
- Pods dedup to **groups** (equal ``pod_group_signature``), ordered by the
  canonical FFD order (solver/cpu.py::pod_sort_key). Group-batched FFD is
  exactly per-pod FFD because the canonical order keeps groups contiguous
  within a size class.
- The **label universe** interns every (key, value) pair appearing in
  instance-type requirements (minus zone / zone-id / capacity-type, which
  ride the offerings tensors). Each type stores one value id per key
  (ABSENT when undefined); each group stores a boolean allow-mask per key
  (complement sets and Gt/Lt bounds evaluated against the interned values
  at encode time). Type-level feasibility is then K gathered mask lookups:
      F[g, t] = AND_k mask[g, k, type_val[t, k]]
- Zones and capacity types are tiny enumerations: offering availability is
  ``avail[T, Z, C]`` with fixed-point prices ``price[T, Z, C]`` (int64
  micro-USD; unavailable = PRICE_INF). Group/pool zone and capacity-type
  requirements become allow-vectors ``agz[*, Z]`` / ``agc[*, C]``.
- Resources are exact int64 (millicores / bytes) — the fit comparison is
  bit-identical to the CPU oracle's, by construction.

Everything host-side here is numpy; the packed arena reaches the device
in solver/cuda.py. A copy of the reference package's encoder on its numpy
path, with its grouping walk in C (native/groupwalk.c, a host helper).
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

import threading

from ..apis import labels as L
from ..apis.objects import Pod
from ..apis.requirements import Requirement, Requirements
from ..apis.resources import Resources
from ..cloudprovider.types import InstanceType
from ..solver.cpu import pod_group_signature, pod_sig_digest
from ..solver.types import NodePoolSpec, SchedulingSnapshot

PRICE_INF = np.int64(1) << 60
ABSENT = 0  # value id 0 of every key means "label absent on the type"

CAPACITY_TYPES = (L.CAPACITY_TYPE_ON_DEMAND, L.CAPACITY_TYPE_SPOT,
                  L.CAPACITY_TYPE_RESERVED)

#: keys that ride the offerings tensors instead of the label universe
_OFFERING_KEYS = frozenset({L.ZONE, L.ZONE_ID, L.CAPACITY_TYPE})


class LabelUniverse:
    """Interns (key, value) pairs from instance-type requirement sets."""

    def __init__(self, types: Sequence[InstanceType]):
        keys: Set[str] = set()
        for t in types:
            for r in t.requirements:
                if r.key not in _OFFERING_KEYS:
                    keys.add(r.key)
        self.keys: List[str] = sorted(keys)
        self.key_pos = {k: i for i, k in enumerate(self.keys)}
        # value id 0 reserved for ABSENT
        self.values: List[Dict[str, int]] = [dict() for _ in self.keys]
        self.value_names: List[List[str]] = [["<absent>"] for _ in self.keys]
        for t in types:
            for r in t.requirements:
                ki = self.key_pos.get(r.key)
                if ki is None:
                    continue
                for v in r.values:
                    self._intern(ki, v)
        # numeric value per (key, id) for Gt/Lt evaluation (None -> NaN)
        self.numeric: List[np.ndarray] = []
        for ki in range(len(self.keys)):
            arr = np.full(len(self.value_names[ki]), np.nan)
            for v, vid in self.values[ki].items():
                try:
                    arr[vid] = int(v)
                except ValueError:
                    pass
            self.numeric.append(arr)

    def _intern(self, ki: int, v: str) -> int:
        vid = self.values[ki].get(v)
        if vid is None:
            vid = len(self.value_names[ki])
            self.values[ki][v] = vid
            self.value_names[ki].append(v)
        return vid

    def n_values(self, ki: int) -> int:
        return len(self.value_names[ki])

    def type_value_ids(self, types: Sequence[InstanceType]) -> np.ndarray:
        """[T, K] int32 — each type's value id per key (ABSENT if undefined
        or if the type's requirement on the key isn't a single concrete
        value; DoesNotExist maps to ABSENT)."""
        out = np.zeros((len(types), len(self.keys)), dtype=np.int32)
        for ti, t in enumerate(types):
            for r in t.requirements:
                ki = self.key_pos.get(r.key)
                if ki is None:
                    continue
                if not r.complement and len(r.values) == 1:
                    out[ti, ki] = self.values[ki][next(iter(r.values))]
                # DoesNotExist (empty, non-complement) stays ABSENT
        return out

    def requirement_mask(self, req: Requirement) -> np.ndarray:
        """Allow-mask over the key's value ids (index 0 = ABSENT)."""
        ki = self.key_pos[req.key]
        n = self.n_values(ki)
        mask = np.zeros(n, dtype=bool)
        for vid in range(1, n):
            if req.has(self.value_names[ki][vid]):
                mask[vid] = True
        mask[ABSENT] = req.satisfied_by_absence()
        return mask

    def group_masks(self, reqs: Requirements) -> Dict[int, np.ndarray]:
        """key index -> allow-mask, only for keys the reqs constrain."""
        out = {}
        for r in reqs:
            if r.key in _OFFERING_KEYS:
                continue
            ki = self.key_pos.get(r.key)
            if ki is not None:
                out[ki] = self.requirement_mask(r)
        return out


class PodGroup:
    """One scheduling-signature group (plain __slots__ class: the
    constructor runs once per group per solve — 10k times at the G-axis
    envelope — so dataclass/default-factory overhead is measurable)."""
    __slots__ = ("index", "sig", "pods", "reqs", "requests", "masks")

    def __init__(self, index: int, sig: Tuple, pods: List[Pod],
                 reqs: Requirements, requests: Resources,
                 masks: Optional[Dict[int, np.ndarray]] = None):
        self.index = index
        self.sig = sig
        self.pods = pods                 # canonical order
        self.reqs = reqs
        self.requests = requests
        #: ki -> allow mask over interned values (only constrained keys)
        self.masks = masks if masks is not None else {}

    @property
    def count(self) -> int:
        return len(self.pods)

    def __repr__(self):
        return f"PodGroup(index={self.index}, n={len(self.pods)})"


@dataclass
class PoolEncoding:
    index: int
    spec: NodePoolSpec
    type_rows: np.ndarray        # [T] bool — types in this pool's catalog
    agz: np.ndarray              # [Z] bool — allowed zones
    agc: np.ndarray              # [C] bool — allowed capacity types
    masks: Dict[int, np.ndarray]  # label-universe constraints of the pool
    limit_vec: Optional[np.ndarray]  # [D] int64, -1 = unlimited dim
    in_use_vec: np.ndarray       # [D] int64


@dataclass
class SnapshotEncoding:
    """Everything the kernels need, all numpy, all deterministic."""
    universe: LabelUniverse
    dims: List[str]                      # resource dimension names
    zones: List[str]                     # zone names (sorted)
    zone_ids: Dict[str, str]
    types: List[InstanceType]            # the union catalog, name-sorted
    type_names: List[str]
    # tensors
    type_val: np.ndarray                 # [T, K] int32
    A: np.ndarray                        # [T, D] int64 allocatable
    avail: np.ndarray                    # [T, Z, C] bool
    price: np.ndarray                    # [T, Z, C] int64 (PRICE_INF = n/a)
    groups: List[PodGroup]
    R: np.ndarray                        # [G, D] int64 per-pod requests
    n: np.ndarray                        # [G] int64 pod counts
    F: np.ndarray                        # [G, T] bool type-level feasibility
    agz: np.ndarray                      # [G, Z] bool
    agc: np.ndarray                      # [G, C] bool
    pools: List[PoolEncoding]
    admit: np.ndarray                    # [G, P] bool (reqs ∧ taints ∧ residual)
    daemon: np.ndarray                   # [G, P, D] int64 daemon overhead
    # minValues floors (nodepool requirements with a minValues cardinality
    # floor — karpenter.sh_nodepools.yaml:284; enforced per node the way the
    # core scheduler's SatisfiesMinValues check in nodeclaim.Add is). K keys
    # across all pools; each key's (type, value-id) membership pairs drive a
    # segment-max — sharding-friendly (pairs localize per type shard).
    mv_keys: List[str] = field(default_factory=list)
    mv_V: int = 0                        # value-id universe size (max over keys)
    mv_floor: Optional[np.ndarray] = None    # [P, K] int64 (0 = no floor)
    mv_pairs_t: Optional[np.ndarray] = None  # [K, M] int64 type index of pair
    mv_pairs_v: Optional[np.ndarray] = None  # [K, M] int64 value id (V = pad)
    #: any group carries required topology constraints (spread or
    #: required (anti-)affinity) — a pure function of the signatures,
    #: computed from the bank so the solver skips a per-group python scan
    topo_any: bool = False
    #: [G] bool — lazy cache of independent_runs(admit); see fused_runs()
    fuse_prev: Optional[np.ndarray] = None
    #: [G] int64 resolved scheduling priority per group (None when every
    #: pod is priority 0 — the wire then stays Q=0 / prio-free). The
    #: kernel's DECISIONS never read it (canonical order already encodes
    #: priority); it feeds per-tier leftover reporting and the
    #: preemption search's demand selection
    prio: Optional[np.ndarray] = None

    def fused_runs(self) -> np.ndarray:
        """[G] bool ``same_run_as_prev`` over the ADMIT axis: True at g
        means group g's admit row is disjoint from every admit row of
        the greedy run containing g-1, so steps 1-4 of the device scan
        can batch g with that run (ops/ffd_torch.py fused scan). Pure
        function of ``admit``, computed once per encoding on first use.
        A rows-tier delta keeps the encoding and never moves ``admit``,
        so the cache stays valid across warm ticks."""
        if self.fuse_prev is None:
            self.fuse_prev = independent_runs(self.admit)
        return self.fuse_prev

    @property
    def mv_K(self) -> int:
        return len(self.mv_keys)

    @property
    def mv_M(self) -> int:
        return 0 if self.mv_pairs_t is None else self.mv_pairs_t.shape[1]


def independent_runs(rows: np.ndarray) -> np.ndarray:
    """Greedy maximal runs of pairwise-disjoint boolean rows.

    Returns ``same_run_as_prev`` [G] bool: True at g means row g shares
    no True column with ANY row of the run containing g-1 (tracked as
    the running OR of the current run), so g joins that run; False
    starts a new run at g. Any two rows inside one run are therefore
    pairwise disjoint — the exactness precondition of the fused device
    scan (two groups admitting disjoint pool sets cannot contend for a
    slot, an existing node, or a pool budget, so their fill phases
    commute). An all-False row is disjoint from everything and joins
    any run, which is right for the padded tail groups (n=0, admit
    all-False).

    Greedy maximal is not optimal run-partitioning, but it is O(G*P),
    deterministic, and order-preserving — the scan order IS the FFD
    decision order and must not be permuted."""
    G = rows.shape[0]
    out = np.zeros(G, dtype=bool)
    if G == 0:
        return out
    acc = rows[0].copy()
    for g in range(1, G):
        r = rows[g]
        if not (r & acc).any():
            out[g] = True
            acc |= r
        else:
            acc = r.copy()
    return out


#: C-speed sort key over Pod._nskey (set eagerly in Pod.__init__)
_NSKEY_GET = operator.attrgetter("_nskey")

#: C-accelerated grouping walk (native/groupwalk.c); None -> pure python.
#: The walk reads each pod's cached (epoch, sig-id) pair and buckets by
#: sig id — six C-API calls per pod, the largest host layer of a 50k-pod
#: solve as bytecode. The one-shot compile sits neither on the import
#: path nor mid-solve: CUDASolver's constructor calls _groupwalk() to pay
#: it up front, and the first grouping builds it only if no solver was
#: constructed first. A host without a C compiler keeps the Python loop.
_GROUPWALK = None
_GROUPWALK_TRIED = False


def _groupwalk():
    global _GROUPWALK, _GROUPWALK_TRIED
    if not _GROUPWALK_TRIED:
        _GROUPWALK_TRIED = True
        from ..native._build import build_ext_and_import
        _GROUPWALK = build_ext_and_import("karpgroupwalk", "groupwalk.c")
    return _GROUPWALK

#: process-wide signature intern table: sig tuple -> (small id, sig).
#: Grouping then hashes one cached int per pod instead of a deep tuple.
#: Bounded: past _SIG_CAP distinct signatures the table resets and the
#: epoch bumps, invalidating ids cached on pods (a long-lived operator
#: watching churning workloads must not grow memory monotonically).
_SIG_IDS: Dict[Tuple, int] = {}
_SIG_BY_ID: List[Tuple] = []
#: lazily-filled canonical FFD key (-cpu, -mem, digest) per sig id —
#: saves recomputing effective_requests/digest per group per solve
_SIG_KEY_BY_ID: List[Optional[Tuple]] = []
_SIG_EPOCH = 0
_SIG_CAP = 1 << 16
_SIG_MU = threading.Lock()  # two unlocked misses could hand one id to two sigs


def _sig_id(pod: Pod) -> int:
    global _SIG_EPOCH
    ent = pod.__dict__.get("_sig_id")
    if ent is not None and ent[0] == _SIG_EPOCH:
        return ent[1]
    sig = pod_group_signature(pod)
    with _SIG_MU:
        sid = _SIG_IDS.get(sig)
        if sid is None:
            if len(_SIG_BY_ID) >= _SIG_CAP:
                _SIG_IDS.clear()
                _SIG_BY_ID.clear()
                _SIG_KEY_BY_ID.clear()
                _SIG_EPOCH += 1
            sid = len(_SIG_BY_ID)
            _SIG_IDS[sig] = sid
            _SIG_BY_ID.append(sig)
            _SIG_KEY_BY_ID.append(None)
        epoch = _SIG_EPOCH
    pod.__dict__["_sig_id"] = (epoch, sid)
    return sid


def canonical_pod_groups(pods: Sequence[Pod]) -> List[Tuple[Tuple, List[Pod]]]:
    """Group pods by scheduling signature in canonical FFD order.

    Equivalent to ``sorted(pods, key=pod_sort_key)`` followed by dedup —
    but O(n) grouping plus small sorts instead of one n·log(n) sort with
    expensive tuple keys (the 50k-pod sort dominated encode time). Valid
    because pod_sort_key = (-prio, -cpu, -mem, sig_digest, ns, name): all
    members of a group share the leading components (priority is part of
    the signature when nonzero), so sorting groups by the
    representative's key prefix and members by (ns, name) reproduces the
    exact canonical order.
    """
    gw = _groupwalk()
    for _attempt in range(3):
        epoch = _SIG_EPOCH
        by_sid: "Optional[Dict[int, List[Pod]]]" = None
        if gw is not None:
            by_sid, misses = gw.walk(pods, epoch)
            if by_sid is None:
                # cold/stale entries: intern them (computes signatures),
                # then redo the walk — the second pass sees every entry
                # warm unless the table reset mid-way (epoch check below)
                for p in misses:
                    _sig_id(p)
                by_sid, misses = gw.walk(pods, epoch)
        if by_sid is None:
            by_sid = {}
            prev_sid = -1
            bucket: List[Pod] = []
            for p in pods:
                ent = p.__dict__.get("_sig_id")
                sid = ent[1] if (ent is not None and ent[0] == epoch) \
                    else _sig_id(p)
                if sid != prev_sid:  # pods arrive in same-sig runs: skip
                    prev_sid = sid   # the bucket lookup inside a run
                    bucket = by_sid.get(sid)
                    if bucket is None:
                        by_sid[sid] = bucket = []
                bucket.append(p)
        # ids assigned before an intern-table reset collide with ids after
        # it; resolve ids back to sig tuples under the lock, and only if
        # the epoch never moved mid-loop — otherwise the grouping is
        # suspect and we retry (the fresh table now holds this snapshot's
        # sigs, so one retry suffices unless the snapshot alone overflows)
        entries = None
        misses = []
        with _SIG_MU:
            if _SIG_EPOCH == epoch:
                # per-sid FFD keys are cached alongside the intern table:
                # a recurring signature costs one list index instead of
                # effective_requests + digest per solve. Misses are only
                # COLLECTED here — the md5-digest computation runs after
                # the lock drops, so a cold table never serializes
                # concurrent solves on the process-wide intern mutex
                entries = []
                for sid, plist in by_sid.items():
                    key = _SIG_KEY_BY_ID[sid]
                    if key is None:
                        misses.append((len(entries), sid))
                    entries.append((key, _SIG_BY_ID[sid], plist))
        if entries is not None and misses:
            computed = []
            for pos, sid in misses:
                rep = entries[pos][2][0]
                r = rep.effective_requests()
                key = (-getattr(rep, "priority", 0), -r["cpu"],
                       -r["memory"], pod_sig_digest(rep))
                entries[pos] = (key, entries[pos][1], entries[pos][2])
                computed.append((sid, key))
            with _SIG_MU:
                # write-back is idempotent (the key is a pure function of
                # the signature); skip if the table reset meanwhile
                if _SIG_EPOCH == epoch:
                    for sid, key in computed:
                        _SIG_KEY_BY_ID[sid] = key
        if entries is not None:
            # sids are unique within an epoch-stable pass, so no
            # duplicate-signature merge is possible here (the
            # canonical_group_order fallback handles that case)
            for _k, _sig, plist in entries:
                plist.sort(key=_NSKEY_GET)
            entries.sort(key=operator.itemgetter(0))
            return [(sig, plist) for _, sig, plist in entries]
    raw: Dict[Tuple, List[Pod]] = {}
    for p in pods:  # degenerate fallback: group by the raw sig tuple
        raw.setdefault(pod_group_signature(p), []).append(p)
    sig_groups = list(raw.items())
    for _sig, plist in sig_groups:
        plist.sort(key=_NSKEY_GET)
    return canonical_group_order(sig_groups)


def canonical_group_order(
        raw: List[Tuple[Tuple, List[Pod]]]) -> List[Tuple[Tuple, List[Pod]]]:
    """Order (sig, members) groups canonically — by the representative's
    (-prio, -cpu, -mem, sig-digest) FFD key — merging duplicate signatures
    (member lists must each already be (ns, name)-sorted). Shared by the
    full grouping above and the preference wrapper's group-level
    reassembly, so both produce the oracle's exact processing order."""
    by_sig: Dict[Tuple, List[Pod]] = {}
    for sig, plist in raw:
        cur = by_sig.get(sig)
        if cur is None:
            by_sig[sig] = plist
        else:
            # two partitions converged on one signature (e.g. a hardened
            # chain meeting another group's raw spec): the oracle would
            # interleave them by (ns, name) — merge and re-sort
            merged = cur + plist
            merged.sort(key=_NSKEY_GET)
            by_sig[sig] = merged
    entries = []
    for sig, plist in by_sig.items():
        rep = plist[0]
        r = rep.effective_requests()
        entries.append(((-getattr(rep, "priority", 0), -r["cpu"],
                         -r["memory"], pod_sig_digest(rep)), sig, plist))
    entries.sort(key=lambda e: e[0])
    return [(sig, plist) for _, sig, plist in entries]


@dataclass
class _CatalogEncoding:
    """Catalog-side tensors, reused while the catalog objects are stable.

    Everything here derives from the instance-type objects + the zone map
    alone — not from pods — and the instancetype provider hands out the
    SAME objects until a catalog/offerings seqnum bump rebuilds them
    (instancetype.go:119-130 cache-key discipline). Caching by object
    identity therefore invalidates exactly when the provider does, and
    removes the O(T x requirements) interning + O(T x Z x C) offerings
    assembly from the per-solve hot path (at ~850 types that was most of
    encode time)."""
    universe: LabelUniverse
    types: List[InstanceType]
    type_names: List[str]
    #: id(resolved InstanceType) -> column (names repeat across variants)
    type_pos: Dict[int, int]
    type_val: np.ndarray
    A: np.ndarray
    avail: np.ndarray
    price: np.ndarray
    zones: List[str]
    zid_of: Dict[str, str]


_CATALOG_CACHE: Dict[Tuple, _CatalogEncoding] = {}
_CATALOG_CACHE_CAP = 8
_CATALOG_MU = threading.Lock()
#: per-catalog-encoding signature->group-row cache bound (a long-lived
#: operator watching churning workloads must not grow memory monotonically)
_GROUP_ROW_CACHE_CAP = 1 << 16


class _RowBank:
    """Signature-keyed per-group row store with contiguous bank matrices.

    ``idx`` maps a scheduling signature to its row in the banks; warm
    encode assembly is then one fancy-index gather per tensor instead of
    a python loop of per-row copies. Banks double geometrically; rows are
    immutable once written.

    Lifetime contract with RESIDENT encodings (models/delta.py): every
    per-group tensor an encoding carries is a fancy-index GATHER — a
    copy — and ``g.masks`` holds the mask dict by reference, so neither
    ``reset()`` (which clears ``idx``/``masks``/``size`` but keeps the
    matrices and ``pins``, letting later adds overwrite rows from 0) nor
    ``_grow()`` (which copies the filled prefix into doubled matrices,
    preserving row order) can mutate an encoding that has already been
    assembled. ``add()`` writes every bank column of its row, so a
    recycled post-reset row can never leak a stale field. The regression
    suite in tests/test_delta_encoding.py pins all three properties."""

    def __init__(self, T: int, Z: int, C: int, P: int, D: int, pins=()):
        self.idx: Dict[Tuple, int] = {}
        self.size = 0
        self.masks: List[Dict[int, np.ndarray]] = []
        self.pins = pins
        cap = 256
        self.R = np.zeros((cap, D), dtype=np.int64)
        self.F = np.zeros((cap, T), dtype=bool)
        self.agz = np.zeros((cap, Z), dtype=bool)
        self.agc = np.zeros((cap, C), dtype=bool)
        self.admit = np.zeros((cap, P), dtype=bool)
        self.daemon = np.zeros((cap, P, D), dtype=np.int64)
        self.topo = np.zeros(cap, dtype=bool)

    def _grow(self):
        for name in ("R", "F", "agz", "agc", "admit", "daemon", "topo"):
            a = getattr(self, name)
            b = np.zeros((a.shape[0] * 2,) + a.shape[1:], dtype=a.dtype)
            b[:a.shape[0]] = a
            setattr(self, name, b)

    def reset(self):
        self.idx.clear()
        self.masks.clear()
        self.size = 0

    def add(self, sig: Tuple, Rrow, masks, Frow, agzrow, agcrow,
            admit_row, daemon_rows, topo_flag: bool) -> int:
        i = self.size
        if i >= self.R.shape[0]:
            self._grow()
        self.R[i] = Rrow
        self.F[i] = Frow
        self.agz[i] = agzrow
        self.agc[i] = agcrow
        self.admit[i] = admit_row
        self.daemon[i] = daemon_rows
        self.topo[i] = topo_flag
        self.masks.append(masks)
        self.idx[sig] = i
        self.size = i + 1
        return i


def _encode_catalog(seen: Dict[Tuple[str, int], InstanceType],
                    snapshot_zones: Tuple[Tuple[str, str], ...],
                    dims: Tuple[str, ...]) -> _CatalogEncoding:
    types = [seen[k] for k in sorted(seen)]
    key = (tuple(id(t) for t in types), snapshot_zones, dims)
    with _CATALOG_MU:
        hit = _CATALOG_CACHE.get(key)
        if hit is not None:
            return hit
    universe = LabelUniverse(types)
    type_val = universe.type_value_ids(types)
    dpos = {d: i for i, d in enumerate(dims)}
    zone_set: Set[str] = {z for z, _ in snapshot_zones}
    zid_of: Dict[str, str] = dict(snapshot_zones)
    for t in types:
        for o in t.offerings:
            zone_set.add(o.zone)
            if o.zone_id:
                zid_of.setdefault(o.zone, o.zone_id)
    zones = sorted(zone_set)
    zpos = {z: i for i, z in enumerate(zones)}
    Z, C, T, D = len(zones), len(CAPACITY_TYPES), len(types), len(dims)
    cpos = {c: i for i, c in enumerate(CAPACITY_TYPES)}
    avail = np.zeros((T, Z, C), dtype=bool)
    price = np.full((T, Z, C), PRICE_INF, dtype=np.int64)
    A = np.zeros((T, D), dtype=np.int64)
    for ti, t in enumerate(types):
        for k, q in t.allocatable().items():
            i = dpos.get(k)
            if i is not None:
                A[ti, i] = q
        for o in t.offerings:
            zi, ci = zpos[o.zone], cpos[o.capacity_type]
            price[ti, zi, ci] = o.price
            if o.available:
                avail[ti, zi, ci] = True
    enc = _CatalogEncoding(
        universe=universe, types=types,
        type_names=[t.name for t in types],
        type_pos={id(t): i for i, t in enumerate(types)},
        type_val=type_val, A=A, avail=avail, price=price,
        zones=zones, zid_of=zid_of)
    with _CATALOG_MU:
        if len(_CATALOG_CACHE) >= _CATALOG_CACHE_CAP:
            _CATALOG_CACHE.clear()  # tiny cache; staleness-by-identity only
        _CATALOG_CACHE[key] = enc
    return enc


def resource_vec(r: Resources, D: int, dpos: Mapping[str, int]) -> np.ndarray:
    """[D] int64 of one ``Resources`` over the encoding's dim order."""
    v = np.zeros(D, dtype=np.int64)
    for k, q in r.items():
        i = dpos.get(k)
        if i is not None:
            v[i] = q
    return v


def pool_dynamic_vecs(spec: NodePoolSpec, D: int, dpos: Mapping[str, int]):
    """(limit_vec, in_use_vec) of one pool — the per-tick-DYNAMIC half of
    ``PoolEncoding``: ``in_use`` moves every reconcile round and limits
    can be edited, while everything else in the pool row is stable for
    as long as the nodepool/catalog objects are. One derivation shared
    by ``encode_snapshot`` and the incremental patcher (models/delta.py)
    so the resident arena and a from-scratch encode can never disagree
    on the pool tensors."""
    limits = spec.nodepool.limits
    lim_vec = None
    if limits is not None:
        lim_vec = np.full(D, -1, dtype=np.int64)
        for k, q in limits.items():
            if k in dpos:
                lim_vec[dpos[k]] = q
    return lim_vec, resource_vec(spec.in_use, D, dpos)


def encode_snapshot(snapshot: SchedulingSnapshot,
                    pod_groups: Optional[List[Tuple[Tuple, List[Pod]]]] = None
                    ) -> SnapshotEncoding:
    # --- groups (canonical FFD order, O(n) grouping) ----------------------
    # the preference wrapper already walked every pod to group them; when
    # it hands the grouping down, the second 50k-pod walk disappears
    groups: List[PodGroup] = []
    dims_set = {"cpu", "memory", "pods"}
    for sig, plist in (pod_groups if pod_groups is not None
                       else canonical_pod_groups(snapshot.pods)):
        rep = plist[0]
        req = rep.effective_requests()
        dims_set.update(req.nonzero_keys())
        groups.append(PodGroup(len(groups), sig, plist,
                               rep.scheduling_requirements(), req))

    # --- union catalog --------------------------------------------------
    # Dedup by RESOLVED OBJECT, not by name: the same type name resolves
    # differently under different NodeClasses (windows vs linux OS
    # labels, kubelet-dependent allocatable), and a name-keyed union lets
    # one pool's variant poison another's requirements/capacity. Pools
    # sharing a NodeClass share the provider's cached objects, so the
    # common case still dedups to one column. Variant indices follow
    # first-seen order (snapshot pool order) — deterministic.
    seen: Dict[Tuple[str, int], InstanceType] = {}
    seen_ids: Set[int] = set()
    _variant_count: Dict[str, int] = {}
    for spec in snapshot.nodepools:
        for t in spec.instance_types:
            if id(t) in seen_ids:
                continue
            v = _variant_count.get(t.name, 0)
            _variant_count[t.name] = v + 1
            seen[(t.name, v)] = t
            seen_ids.add(id(t))

    # --- dims (group keys folded in during the grouping walk above) ------
    for d in snapshot.daemon_overheads:
        dims_set.update(d.requests.nonzero_keys())
    for spec in snapshot.nodepools:
        if spec.nodepool.limits is not None:
            dims_set.update(spec.nodepool.limits.nonzero_keys())
    dims = sorted(dims_set)
    dpos = {d: i for i, d in enumerate(dims)}

    def vec(r: Resources) -> np.ndarray:
        return resource_vec(r, len(dims), dpos)

    # --- catalog tensors (cached while the type objects are stable) ------
    cenc = _encode_catalog(
        seen, tuple(sorted(snapshot.zones.items())), tuple(dims))
    types, type_pos = cenc.types, cenc.type_pos
    universe, type_val = cenc.universe, cenc.type_val
    zones, zid_of = cenc.zones, cenc.zid_of
    A, avail, price = cenc.A, cenc.avail, cenc.price
    Z, C, T, D = len(zones), len(CAPACITY_TYPES), len(types), len(dims)

    # --- pools ----------------------------------------------------------
    pools: List[PoolEncoding] = []
    ordered_specs = sorted(
        snapshot.nodepools,
        key=lambda s: (-s.nodepool.weight, s.nodepool.metadata.name))
    for pi, spec in enumerate(ordered_specs):
        rows = np.zeros(T, dtype=bool)
        for t in spec.instance_types:
            rows[type_pos[id(t)]] = True
        preqs = spec.nodepool.scheduling_requirements()
        # the pool's own label requirements restrict the type axis, exactly
        # like the oracle's merged-requirement conflict check does
        for ki, mask in universe.group_masks(preqs).items():
            rows &= mask[type_val[:, ki]]
        lim_vec, iu_vec = pool_dynamic_vecs(spec, D, dpos)
        pools.append(PoolEncoding(
            index=pi, spec=spec, type_rows=rows,
            agz=_zone_allow(preqs, zones, zid_of),
            agc=_ct_allow(preqs),
            masks=universe.group_masks(preqs),
            limit_vec=lim_vec,
            in_use_vec=iu_vec))
    P = len(pools)

    # --- group tensors (signature-keyed row bank) ------------------------
    # Everything per-group here is a pure function of (scheduling
    # signature, catalog encoding, pool set, daemon set, dims): cache the
    # rows on the catalog encoding so recurring signatures — steady-state
    # reconcile rounds, preference-relaxation re-solves, and the
    # high-cardinality G axis — skip the requirements algebra entirely.
    # Keyed by object identity for pools/daemons (the same staleness
    # discipline as _CATALOG_CACHE: providers hand out stable objects
    # until a seqnum bump rebuilds them). Rows live in contiguous bank
    # matrices so warm assembly is G fancy-index gathers, not a
    # G-iteration python loop of row copies (at 10k signatures the loop
    # was most of encode time).
    banks = getattr(cenc, "_row_banks", None)
    if banks is None:
        banks = cenc._row_banks = {}
    pkey = (tuple(id(spec.nodepool) for spec in ordered_specs),
            tuple(id(d) for d in snapshot.daemon_overheads),
            tuple(dims))
    bank = banks.get(pkey)
    if bank is not None and bank.size >= _GROUP_ROW_CACHE_CAP:
        # cap enforcement happens BETWEEN encodes only: a mid-encode
        # reset would let later adds overwrite bank rows this encode's
        # gather indices already reference
        bank.reset()
    if bank is None:
        if sum(b.size for b in banks.values()) >= _GROUP_ROW_CACHE_CAP:
            banks.clear()
        # the pins hold the id()-keyed pool/daemon objects alive for the
        # bank's lifetime: a GC'd pool whose address CPython recycles for
        # a NEW pool must never alias an old key (same discipline as
        # _CATALOG_CACHE pinning its types)
        bank = banks[pkey] = _RowBank(
            T=T, Z=Z, C=C, P=P, D=D,
            pins=(tuple(spec.nodepool for spec in ordered_specs),
                  tuple(snapshot.daemon_overheads)))
    G = len(groups)
    n = np.empty(G, dtype=np.int64)
    idxs = np.empty(G, dtype=np.int64)
    bank_idx = bank.idx
    for g in groups:
        n[g.index] = g.count
        bi = bank_idx.get(g.sig)
        if bi is None:
            Rrow = vec(g.requests)
            masks = universe.group_masks(g.reqs)
            Frow = np.ones(T, dtype=bool)
            for ki, mask in masks.items():
                Frow &= mask[type_val[:, ki]]
            agzrow = _zone_allow(g.reqs, zones, zid_of)
            agcrow = _ct_allow(g.reqs)
            admit_row = np.zeros(P, dtype=bool)
            daemon_rows = np.zeros((P, D), dtype=np.int64)
            pod = g.pods[0]
            for pe in pools:
                np_obj = pe.spec.nodepool
                base = np_obj.scheduling_requirements()
                if base.compatible(g.reqs):
                    continue
                if not all(t.tolerated_by(pod.tolerations)
                           for t in np_obj.template.taints):
                    continue
                merged = base.union(g.reqs)
                if any(r.unsatisfiable() for r in merged):
                    continue
                admit_row[pe.index] = True
                total = Resources()
                for d in snapshot.daemon_overheads:
                    if not merged.compatible(d.requirements):
                        total = total + d.requests
                daemon_rows[pe.index] = vec(total)
            topo_flag = bool(pod.topology_spread) or \
                any(a.required for a in pod.pod_affinity)
            bi = bank.add(g.sig, Rrow, masks, Frow, agzrow, agcrow,
                          admit_row, daemon_rows, topo_flag)
        g.masks = bank.masks[bi]
        idxs[g.index] = bi
    R = bank.R[idxs]
    F = bank.F[idxs]
    agz = bank.agz[idxs]
    agc = bank.agc[idxs]
    admit = bank.admit[idxs]
    daemon = bank.daemon[idxs]
    topo_any = bool(bank.topo[idxs].any())

    mv_keys, mv_V, mv_floor, mv_pairs_t, mv_pairs_v = \
        _encode_min_values(pools, types, P)

    # per-group resolved priority: None while every pod is priority 0 so
    # priority-free snapshots stay wire-identical (statics Q=0, no prio
    # section). Priority is part of the signature when nonzero, so the
    # representative speaks for the whole group.
    prio = None
    if any(getattr(g.pods[0], "priority", 0) for g in groups):
        prio = np.zeros(G, dtype=np.int64)
        for g in groups:
            prio[g.index] = getattr(g.pods[0], "priority", 0)

    return SnapshotEncoding(
        universe=universe, dims=dims, zones=zones, zone_ids=zid_of,
        types=types, type_names=cenc.type_names,
        type_val=type_val, A=A, avail=avail, price=price,
        groups=groups, R=R, n=n, F=F, agz=agz, agc=agc,
        pools=pools, admit=admit, daemon=daemon,
        mv_keys=mv_keys, mv_V=mv_V, mv_floor=mv_floor,
        mv_pairs_t=mv_pairs_t, mv_pairs_v=mv_pairs_v,
        topo_any=topo_any, prio=prio)


def _encode_min_values(pools: List[PoolEncoding],
                       types: Sequence[InstanceType], P: int):
    """Pool-level minValues floors + per-key (type, value) membership pairs.

    Value ids are interned per key over the values each type's requirement
    carries (multi-valued requirements contribute one pair per value — the
    same union-cardinality the launch-path truncation counts). Pairs are
    padded with value id V, a dump segment sliced off by the kernels.
    """
    keys = sorted({r.key for pe in pools
                   for r in pe.spec.nodepool.scheduling_requirements()
                   if r.min_values is not None})
    if not keys:
        return [], 0, None, None, None
    K = len(keys)
    mv_floor = np.zeros((P, K), dtype=np.int64)
    for pe in pools:
        for r in pe.spec.nodepool.scheduling_requirements():
            if r.min_values is not None:
                mv_floor[pe.index, keys.index(r.key)] = r.min_values
    pairs: List[List[Tuple[int, int]]] = []
    V = 0
    for key in keys:
        vids: Dict[str, int] = {}
        kp: List[Tuple[int, int]] = []
        for ti, t in enumerate(types):
            r = t.requirements.get(key)
            if r is None or r.complement:
                continue
            for v in sorted(r.values):
                vid = vids.setdefault(v, len(vids))
                kp.append((ti, vid))
        pairs.append(kp)
        V = max(V, len(vids))
    M = max((len(kp) for kp in pairs), default=0)
    mv_pairs_t = np.zeros((K, M), dtype=np.int64)
    mv_pairs_v = np.full((K, M), V, dtype=np.int64)  # pad -> dump segment
    for ki, kp in enumerate(pairs):
        for mi, (ti, vid) in enumerate(kp):
            mv_pairs_t[ki, mi] = ti
            mv_pairs_v[ki, mi] = vid
    return keys, V, mv_floor, mv_pairs_t, mv_pairs_v


def _zone_allow(reqs: Requirements, zones: List[str],
                zid_of: Mapping[str, str]) -> np.ndarray:
    mask = np.ones(len(zones), dtype=bool)
    zr = reqs.get(L.ZONE)
    if zr is not None:
        mask &= np.array([zr.has(z) for z in zones])
    zir = reqs.get(L.ZONE_ID)
    if zir is not None:
        mask &= np.array([zir.has(zid_of.get(z, "")) for z in zones])
    return mask


def _ct_allow(reqs: Requirements) -> np.ndarray:
    mask = np.ones(len(CAPACITY_TYPES), dtype=bool)
    ctr = reqs.get(L.CAPACITY_TYPE)
    if ctr is not None:
        mask &= np.array([ctr.has(c) for c in CAPACITY_TYPES])
    return mask
