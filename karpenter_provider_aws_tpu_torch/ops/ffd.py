"""The host FFD engine: a copy of the reference package's ``ops/ffd.py``.

Two engines over the same math, decision-identical by construction:

- :func:`fill_group_closed_form` — the host (numpy) engine: one call per
  pod group in canonical order, mutating :class:`NodeState`. It serves
  the solves the device kernels do not take (``solver/cuda.py``
  ``_run_host``: no instance types, group counts past the device caps, a
  priority arena past the base cap); a pruned solve that bailed is
  solved again on the device with every slot selected, not here. The
  host topology pour (``ops/topo.py``) goes through ``_run_host`` too,
  with this engine's closed form for its groups without topology.
- ``ops/ffd_torch.py`` ``solve_scan`` / ``solve_scan_packed1_pruned`` —
  the device engines: one scan over pod groups whose carry is the
  open-node state (candidate-type masks, zone/capacity-type masks, int64
  request vectors, pool budgets); each step does the vectorized headroom
  + prefix-sum greedy fill + closed-form new-node creation.

The group fill math (identical in both engines)
-----------------------------------------------
For group g with per-pod request vector R and n pods:

1. slot admission: alive ∧ (existing-node compat OR pool-level admission of
   the group by the slot's pool)
2. candidate types per open slot: node_types ∧ F[g] ∧ "has an available
   offering inside the slot's merged (zone × capacity-type) allow-masks"
3. headroom k[slot] = max over candidate types of
   min_d floor((A[t,d] − used[slot,d]) / R[d])   (dims with R[d]=0 ignored),
   capped by the slot's pool limit budget
4. greedy FFD prefix fill: take[slot] = clip(n − cumsum_excl(k), 0, k)
5. leftovers open new nodes pool-by-pool (weight order): capacity per new
   node = max over admitted types of floor((A − daemon)/R); the final type
   mask of a node holding m pods is {t : headroom_t ≥ m} — exactly the
   narrowing the per-pod oracle produces.

Equivalence to the per-pod CPU oracle holds because the canonical pod order
keeps groups contiguous (solver/cpu.py::pod_sort_key) and all the above
counters are the closed forms of the oracle's per-pod loop.

The reference also runs a native twin of the whole fill
(``native/fastfill.cpp``); this copy runs the interpreted path, which
makes the same decisions. The functions below are the reference's,
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.encoding import SnapshotEncoding

BIG = np.int64(1) << 60


@dataclass
class NodeState:
    """Mutable open-node state for the numpy engine. Slots [0, E) are
    existing cluster nodes; slots [E, N) are (potential) new nodes."""
    E: int
    N: int
    T: int
    D: int
    Z: int
    C: int
    used: np.ndarray          # [N, D] int64
    types: np.ndarray         # [N, T] bool (all-False rows for existing/free)
    zones: np.ndarray         # [N, Z] bool
    ct: np.ndarray            # [N, C] bool
    pool: np.ndarray          # [N] int32, -1 free, -2 existing
    alive: np.ndarray         # [N] bool
    num_nodes: int = 0        # new nodes created (slots E..E+num_nodes)
    ex_alloc: Optional[np.ndarray] = None   # [E, D]
    ex_compat: Optional[np.ndarray] = None  # [G, E] bool
    #: pods-per-slot per group: filled by the engines
    takes: List[np.ndarray] = field(default_factory=list)
    leftover: List[int] = field(default_factory=list)
    #: per-slot count of pods of the currently-processed scheduling group
    #: (topology bookkeeping, host engine only)
    pool_used: Optional[np.ndarray] = None  # [P, D]
    #: R-signature -> [N] bool "proven zero headroom for this request
    #: vector". Slot usage only grows within a solve, so fullness under an
    #: identical R transfers across pod groups — later groups skip the
    #: exact per-slot headroom recompute (topo._Pour lazy ensure).
    full_for: Dict[bytes, np.ndarray] = field(default_factory=dict)
    #: [N, D] per-slot capacity UPPER BOUND: max allocatable over the
    #: slot's candidate types at the last tightening. Safe to be stale
    #: HIGH (type masks only ever narrow, usage only grows), so mutation
    #: sites may skip updating it — the high-cardinality fast path
    #: (_fill_group_fast) just probes a few extra slots. BIG = unknown.
    cap_hint: Optional[np.ndarray] = None

    @staticmethod
    def create(enc: SnapshotEncoding, n_max: int,
               ex_alloc: np.ndarray, ex_used: np.ndarray,
               ex_compat: np.ndarray) -> "NodeState":
        E = ex_alloc.shape[0]
        T, D = enc.A.shape
        Z, C = len(enc.zones), enc.avail.shape[2]
        N = E + n_max
        st = NodeState(
            E=E, N=N, T=T, D=D, Z=Z, C=C,
            used=np.zeros((N, D), dtype=np.int64),
            types=np.zeros((N, T), dtype=bool),
            zones=np.zeros((N, Z), dtype=bool),
            ct=np.zeros((N, C), dtype=bool),
            pool=np.full(N, -1, dtype=np.int32),
            alive=np.zeros(N, dtype=bool),
            ex_alloc=ex_alloc, ex_compat=ex_compat,
            pool_used=np.stack([p.in_use_vec for p in enc.pools])
            if enc.pools else np.zeros((0, D), dtype=np.int64),
        )
        st.used[:E] = ex_used
        st.pool[:E] = -2
        st.alive[:E] = True
        st.cap_hint = np.full((N, D), BIG, dtype=np.int64)
        st.cap_hint[:E] = ex_alloc
        return st


def snapshot_state(st: NodeState) -> dict:
    """Checkpoint of everything a group fill mutates — the host twin of
    the device kernel's carry bank (solver/incremental.py). ``ex_alloc``
    / ``ex_compat`` are read-only inputs and deliberately not captured:
    any tick on which they move invalidates every checkpoint (dirty
    frontier 0) before a restore could alias them. ``full_for`` and
    ``cap_hint`` ARE captured — both are monotone caches whose state at
    group *i* depends on the fill history, and a resumed suffix must
    probe exactly what the from-scratch solve would have."""
    return dict(
        used=st.used.copy(), types=st.types.copy(),
        zones=st.zones.copy(), ct=st.ct.copy(), pool=st.pool.copy(),
        alive=st.alive.copy(), num_nodes=st.num_nodes,
        pool_used=st.pool_used.copy(),
        full_for={k: v.copy() for k, v in st.full_for.items()},
        cap_hint=None if st.cap_hint is None else st.cap_hint.copy())


def restore_state(st: NodeState, snap: dict) -> None:
    """Rewind ``st`` to a ``snapshot_state`` checkpoint, leaving the
    checkpoint pristine for future restores."""
    st.used[:] = snap["used"]
    st.types[:] = snap["types"]
    st.zones[:] = snap["zones"]
    st.ct[:] = snap["ct"]
    st.pool[:] = snap["pool"]
    st.alive[:] = snap["alive"]
    st.num_nodes = snap["num_nodes"]
    st.pool_used[:] = snap["pool_used"]
    st.full_for = {k: v.copy() for k, v in snap["full_for"].items()}
    if snap["cap_hint"] is None:
        st.cap_hint = None
    else:
        if st.cap_hint is None:
            st.cap_hint = snap["cap_hint"].copy()
        else:
            st.cap_hint[:] = snap["cap_hint"]


def _headroom(A_eff: np.ndarray, used: np.ndarray, R: np.ndarray) -> np.ndarray:
    """min_d floor((A_eff - used)/R) over dims with R>0; shapes broadcast.
    Result clipped at 0."""
    sel = R > 0
    if not sel.any():
        return np.full(np.broadcast_shapes(A_eff.shape[:-1], used.shape[:-1]),
                       BIG, dtype=np.int64)
    diff = A_eff[..., sel] - used[..., sel]
    q = np.floor_divide(diff, R[sel])
    return np.clip(q.min(axis=-1), 0, BIG)


def _mv_value_headroom(enc: SnapshotEncoding, cand: np.ndarray,
                       hr: np.ndarray) -> np.ndarray:
    """[..., K, V]: 1 + max headroom over candidate types carrying each
    minValues (key, value); 0 when no candidate type carries the value.
    Segment-max over the encoding's (type, value-id) pairs."""
    K, M = enc.mv_pairs_t.shape
    V = enc.mv_V
    hr1 = np.where(cand, hr + 1, 0)
    lead = hr1.shape[:-1]
    flat = hr1.reshape(-1, hr1.shape[-1])
    B = flat.shape[0]
    out = np.zeros((B, K, V + 1), dtype=np.int64)  # col V = pad dump
    rows = np.arange(B)[:, None]
    for k in range(K):
        contrib = flat[:, enc.mv_pairs_t[k]]           # [B, M]
        np.maximum.at(out[:, k, :], (rows, enc.mv_pairs_v[k][None, :]),
                      contrib)
    return out[:, :, :V].reshape(lead + (K, V))


def min_values_cap(enc: SnapshotEncoding, pi: int, cand: np.ndarray,
                   hr: np.ndarray) -> np.ndarray:
    """Max pods a node may take while its surviving candidate-type mask
    ``{t in cand : hr_t >= m}`` keeps every minValues floor of pool ``pi``
    (the closed form of core nodeclaim.Add's SatisfiesMinValues check):
    for floor f on a key, the cap is the f-th largest per-value max
    headroom. cand/hr: [..., T]; returns [...] int64 (BIG = no floors)."""
    lead = np.asarray(hr).shape[:-1]
    if enc.mv_floor is None or not enc.mv_floor[pi].any():
        return np.full(lead, BIG, dtype=np.int64)
    floors = enc.mv_floor[pi]
    h1 = _mv_value_headroom(enc, cand, hr)         # [..., K, V]
    S = -np.sort(-h1, axis=-1)
    cap = np.full(lead, BIG, dtype=np.int64)
    for k in range(enc.mv_K):
        f = int(floors[k])
        if f <= 0:
            continue
        if f > enc.mv_V:
            capk = np.full(lead, -1, dtype=np.int64)
        else:
            capk = S[..., k, f - 1] - 1
        cap = np.minimum(cap, capk)
    return np.maximum(cap, 0)


def _pool_budget(enc: SnapshotEncoding, pool_used: np.ndarray,
                 pi: int, R: np.ndarray) -> int:
    """Max additional pods of per-pod vector R pool pi's limits allow."""
    lim = enc.pools[pi].limit_vec
    if lim is None:
        return int(BIG)
    budget = int(BIG)
    for d in range(len(R)):
        if lim[d] >= 0 and R[d] > 0:
            budget = min(budget, max(0, (lim[d] - pool_used[pi, d])) // R[d])
    return budget


def slot_candidates(st: NodeState, enc: SnapshotEncoding, g: int,
                    agz: np.ndarray) -> np.ndarray:
    """[N, T] candidate types per open slot for group g (steps 1-2).
    Computed on the alive prefix only — slots beyond E+num_nodes have
    all-False type rows, and a solve with many groups would otherwise pay
    O(G * N * T) for dead slots."""
    n_act = st.E + st.num_nodes
    cand = np.zeros((st.N, enc.A.shape[0]), dtype=bool)
    if n_act == 0:
        return cand
    act = slice(0, n_act)
    c = st.types[act] & enc.F[g][None, :]
    zc = (st.zones[act] & agz[None, :])[:, :, None] \
        & (st.ct[act] & enc.agc[g][None, :])[:, None, :]     # [act, Z, C]
    off = np.tensordot(zc.reshape(n_act, -1),
                       enc.avail.reshape(enc.avail.shape[0], -1).T, axes=1) > 0
    cand[act] = c & off
    return cand


def slot_headroom(st: NodeState, enc: SnapshotEncoding, g: int,
                  cand: np.ndarray):
    """([N] max pods each slot can still absorb, per-type headroom info for
    the open rows) — step 3, before budgets. The second element is
    ``(open_mask[N], hr[open, T])`` (or None), reused by the minValues cap
    so the O(rows*T*D) headroom matrix is computed once."""
    R = enc.R[g]
    k = np.zeros(st.N, dtype=np.int64)
    hr_info = None
    # open slots: max over candidate types
    open_rows = cand.any(axis=1)
    if open_rows.any():
        hr = _headroom(enc.A[None, :, :], st.used[open_rows][:, None, :], R)
        k[open_rows] = np.where(cand[open_rows], hr, 0).max(axis=1)
        hr_info = (open_rows, hr)
    # existing slots: concrete allocatable + compat
    E = st.E
    if E:
        ex_ok = st.alive[:E] & st.ex_compat[g]
        if ex_ok.any():
            he = _headroom(st.ex_alloc[ex_ok], st.used[:E][ex_ok], R)
            k[:E][ex_ok] = he
    return k, hr_info


def admission(st: NodeState, enc: SnapshotEncoding, g: int) -> np.ndarray:
    """[N] bool — slot-level admission of group g (step 1)."""
    adm = st.alive.copy()
    E = st.E
    if E:
        adm[:E] &= st.ex_compat[g]
    open_sel = st.pool >= 0
    adm[open_sel] &= enc.admit[g][st.pool[open_sel]]
    return adm


def greedy_fill(k: np.ndarray, n: int) -> Tuple[np.ndarray, int]:
    """FFD prefix fill (step 4)."""
    cum = np.cumsum(k) - k
    take = np.clip(n - cum, 0, k)
    return take.astype(np.int64), int(n - take.sum())


def _off_any(enc: SnapshotEncoding, zmask: np.ndarray,
             cmask: np.ndarray) -> np.ndarray:
    """[T] has-an-available-offering under the (zone, ct) masks; cached on
    the encoding by mask bytes (slots share few distinct patterns)."""
    cache = getattr(enc, "_off_any_cache", None)
    if cache is None:
        cache = enc._off_any_cache = {}
    key = zmask.tobytes() + cmask.tobytes()
    off = cache.get(key)
    if off is None:
        off = cache[key] = (enc.avail & zmask[None, :, None]
                            & cmask[None, None, :]).any(axis=(1, 2))
    return off


def _fill_group_fast(st: NodeState, enc: SnapshotEncoding, g: int
                     ) -> Tuple[np.ndarray, int]:
    """The high-cardinality (G-axis) fast path of the closed form:
    identical decisions, O(probed slots) instead of O(N x T) per group.

    The full [N, T] candidate/headroom pass recomputes near-identical
    tensors for every group; at ~10k distinct pod signatures that O(G x
    N x T) dominates the solve (BASELINE config 7). FFD only ever
    consumes per-slot headroom in slot order until the group is placed,
    so this walk (a) prunes slots whose conservative capacity bound
    (cap_hint, stale-high-safe) cannot fit even one pod — provably k=0 —
    and (b) computes the exact [T] candidate/headroom row only for the
    few surviving probe slots, committing in the same slot order the
    prefix fill uses. Guards in fill_group_closed_form keep every
    override/minValues/pool-limit shape on the exact full pass."""
    n_rem = int(enc.n[g])
    R = enc.R[g]
    sel = R > 0
    Rsel = R[sel]
    take = np.zeros(st.N, dtype=np.int64)
    agz_g = enc.agz[g]
    agc_g = enc.agc[g]
    n_act = st.E + st.num_nodes
    if n_act and n_rem:
        adm = st.alive[:n_act].copy()
        if st.E:
            adm[:st.E] &= st.ex_compat[g]
        open_sel = st.pool[:n_act] >= 0
        adm[open_sel] &= enc.admit[g][st.pool[:n_act][open_sel]]
        if sel.any():
            room = (st.cap_hint[:n_act][:, sel]
                    - st.used[:n_act][:, sel]) >= Rsel[None, :]
            adm &= room.all(axis=1)
        for slot in np.nonzero(adm)[0]:
            slot = int(slot)
            if slot < st.E:
                k = int(_headroom(st.ex_alloc[slot], st.used[slot], R))
                crow = None
            else:
                crow = st.types[slot] & enc.F[g]
                if not crow.any():
                    continue
                crow = crow & _off_any(enc, st.zones[slot] & agz_g,
                                       st.ct[slot] & agc_g)
                if not crow.any():
                    continue
                hr = _headroom(enc.A, st.used[slot][None, :], R)
                k = int(np.where(crow, hr, 0).max())
            if k <= 0:
                continue
            m = min(k, n_rem)
            take[slot] = m
            n_rem -= m
            st.used[slot] += m * R
            if crow is not None:  # open slot: narrow + tighten the bound
                fit = (st.used[slot][None, :] <= enc.A).all(axis=1)
                st.types[slot] = crow & fit
                st.zones[slot] &= agz_g
                st.ct[slot] &= agc_g
                st.cap_hint[slot] = np.where(
                    st.types[slot][:, None], enc.A, 0).max(axis=0)
                pi = int(st.pool[slot])
                st.pool_used[pi] += m * R
            if n_rem == 0:
                return take, 0
    return _open_new_nodes(st, enc, g, n_rem, R, agz_g, agc_g, take)


def _open_new_nodes(st: NodeState, enc: SnapshotEncoding, g: int,
                    n_rem: int, R: np.ndarray, agz_g: np.ndarray,
                    agc_g: np.ndarray, take: np.ndarray
                    ) -> Tuple[np.ndarray, int]:
    """Step 5 — open new nodes pool-by-pool (weight order). The single
    Python implementation shared by the fast walk and the full closed
    form (the C twin in native/fastfill.cpp is the third copy and is
    fuzz-pinned to this one). Candidate masks are cached per
    (constraint-bytes, pool) on the encoding."""
    if not enc.pools:
        return take, n_rem
    cache = getattr(enc, "_cand_new_cache", None)
    if cache is None:
        cache = enc._cand_new_cache = {}
    for pe in enc.pools:
        if n_rem == 0:
            break
        pi = pe.index
        if not enc.admit[g, pi]:
            continue
        daemon = enc.daemon[g, pi]
        key = (enc.F[g].tobytes() + agz_g.tobytes() + agc_g.tobytes(), pi)
        ent = cache.get(key)
        if ent is None:
            agz_p = agz_g & pe.agz
            agc_p = agc_g & pe.agc
            if not agz_p.any() or not agc_p.any():
                cand_new = None
            else:
                cand_new = enc.F[g] & pe.type_rows \
                    & _off_any(enc, agz_p, agc_p)
                if not cand_new.any():
                    cand_new = None
            ent = cache[key] = (cand_new,
                                agz_p if cand_new is not None else None,
                                agc_p if cand_new is not None else None)
        cand_new, agz_p, agc_p = ent
        if cand_new is None:
            continue
        hr = _headroom(enc.A, daemon[None, :], R)
        hr = np.where(cand_new, hr, 0)
        cap = int(hr.max())
        if enc.mv_floor is not None and enc.mv_floor[pi].any():
            cap = min(cap, int(min_values_cap(enc, pi, cand_new, hr)))
        if cap < 1:
            continue
        budget = _pool_budget(enc, st.pool_used, pi, R)
        can_place = min(n_rem, budget)
        if can_place < 1:
            continue
        while can_place > 0 and st.num_nodes < st.N - st.E:
            slot = st.E + st.num_nodes
            m = min(cap, can_place)
            st.num_nodes += 1
            st.alive[slot] = True
            st.pool[slot] = pi
            st.used[slot] = daemon + m * R
            st.types[slot] = cand_new & (hr >= m)
            st.zones[slot] = agz_p
            st.ct[slot] = agc_p
            if st.cap_hint is not None:
                st.cap_hint[slot] = np.where(
                    st.types[slot][:, None], enc.A, 0).max(axis=0)
            take[slot] = m
            st.pool_used[pi] += m * R
            can_place -= m
            n_rem -= m
    return take, n_rem


def fill_group_closed_form(st: NodeState, enc: SnapshotEncoding, g: int,
                           n_override: Optional[int] = None,
                           agz_override: Optional[np.ndarray] = None,
                           slot_cap: Optional[np.ndarray] = None,
                           forbid_slots: Optional[np.ndarray] = None,
                           ) -> Tuple[np.ndarray, int]:
    """Steps 1-5 for one topology-free (sub)group. Mutates ``st``; returns
    (take[N], leftover). Overrides support the topology pre-pass: zone-
    restricted subgroups, per-slot pod caps (hostname spread), forbidden
    slots (hostname anti-affinity)."""
    if (n_override is None and agz_override is None and slot_cap is None
            and forbid_slots is None and enc.mv_floor is None
            and st.cap_hint is not None
            and all(pe.limit_vec is None for pe in enc.pools)):
        return _fill_group_fast(st, enc, g)
    n_rem = int(enc.n[g]) if n_override is None else n_override
    R = enc.R[g]
    agz_g = enc.agz[g] if agz_override is None else agz_override

    # ---- fill open + existing slots -----------------------------------
    cand = slot_candidates(st, enc, g, agz_g)
    adm = admission(st, enc, g)
    cand &= adm[:, None]
    k, hr_info = slot_headroom(st, enc, g, cand)
    k = np.where(adm, k, 0)
    # minValues floors cap per-slot takes BEFORE the budget prefix caps
    # (same order as the device kernel — min-composition order matters
    # because the budget caps are prefix sums over earlier slots' k)
    if enc.mv_floor is not None and hr_info is not None:
        open_mask, hr_open = hr_info
        pos = np.cumsum(open_mask) - 1  # slot index -> row in hr_open
        for pi in range(len(enc.pools)):
            if not enc.mv_floor[pi].any():
                continue
            rows = np.where((st.pool == pi) & open_mask & (k > 0))[0]
            if rows.size == 0:
                continue
            k[rows] = np.minimum(
                k[rows], min_values_cap(enc, pi, cand[rows],
                                        hr_open[pos[rows]]))
    # pool limit budgets cap fills pool-by-pool (node order preserved)
    for pi, pe in enumerate(enc.pools):
        if pe.limit_vec is None:
            continue
        rows = st.pool == pi
        if not rows.any():
            continue
        budget = _pool_budget(enc, st.pool_used, pi, R)
        kp = k[rows]
        cum = np.cumsum(kp) - kp
        k[rows] = np.clip(np.minimum(kp, budget - cum), 0, None)
    if slot_cap is not None:
        k = np.minimum(k, slot_cap)
    if forbid_slots is not None:
        k = np.where(forbid_slots, 0, k)
    take, n_rem = greedy_fill(k, n_rem)

    # commit fills
    filled = take > 0
    if filled.any():
        st.used[filled] += take[filled, None] * R[None, :]
        rows = np.where(filled & (st.pool >= 0))[0]
        for i in rows:
            # narrow: requirement intersection (cand) + refit vs new aggregate
            fit = (st.used[i][None, :] <= enc.A).all(axis=1)
            st.types[i] = cand[i] & fit
            st.zones[i] &= agz_g
            st.ct[i] &= enc.agc[g]
            pi = int(st.pool[i])
            st.pool_used[pi] += int(take[i]) * R
    if n_rem == 0 or not enc.pools:
        return take, n_rem
    return _open_new_nodes(st, enc, g, n_rem, R, agz_g, enc.agc[g], take)
