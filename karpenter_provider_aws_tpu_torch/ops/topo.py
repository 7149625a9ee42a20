"""Topology-aware FFD: exact oracle semantics for topology-spread and pod
(anti-)affinity on the tensor path.

The CPU oracle (solver/cpu.py) enforces, per placement:

- zone topology-spread: ``count(group, zone) + 1 - min_eligible <= maxSkew``
  with min over the pod's *own* zone-requirement-filtered zone universe
  (``_eligible_domains``), and min-count/lexicographic zone choice for
  nodes whose zone is still undecided (``_choose_zone``);
- hostname topology-spread: a fresh node is always a hypothetical domain,
  so ``min_count == 0`` and the constraint degrades to a per-node cap of
  ``maxSkew`` pods per counter group;
- pod (anti-)affinity over zone/hostname occupancy sets (required terms
  only), with the self-affinity seeding rule (an unoccupied required
  affinity to the pod's own scheduling group admits anywhere);
- membership recording for pods with a ``scheduling_group`` (zone domain
  recorded only when the node's zone is *fixed* — an existing node's label
  or a domain decided by ``_choose_zone`` — mirroring ``node.domains``).

This module lowers those semantics onto the slot/tensor state of
:mod:`ops.ffd`: counters become dense arrays (``cz[GZ, Z]`` zone counts per
counter group, ``ch[GH, N]`` per-slot counts per counter group), and the
per-pod loop is an exact *pour* over slots in oracle order (existing by
name, then open by creation, then new nodes pool-by-pool).

Unsupported shapes (spread/affinity over keys other than zone/hostname,
zone-id requirements mixed with topology) are detected at build time —
``TopoEncoding.supported`` is False. ``solver/cuda.py`` then sends the
snapshot to the CPU oracle (solver/cpu.py), as the reference's solver
does, before any launch.

A copy of the reference package's ``ops/topo.py``, whole: in this package
it is the host pour of ``CUDASolver._run_host`` (snapshots outside the
device pour's envelope) and the layout ``ops/topo_torch.py`` reads.

Reference behavior being mirrored: upstream core's topology handling as
consumed by the provider (SURVEY §3.2); the reference's scheduling universe
of well-known topology labels is pkg/apis/v1/labels.go:31-54.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..apis import labels as L
from ..models.encoding import SnapshotEncoding
from . import ffd

BIG = np.int64(1) << 60


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

@dataclass
class TopoEncoding:
    """Topology constraint structure per pod group, with counter groups
    interned to dense indices (zone counters and hostname counters are
    separate index spaces)."""
    GZ: int
    GH: int
    #: per pod-group constraint lists, aligned with enc.groups
    zspread: List[List[Tuple[int, int, bool]]]   # (gz, skew, enforce)
    hspread: List[List[Tuple[int, int, bool]]]   # (gh, skew, enforce)
    zaff: List[List[Tuple[int, bool, bool]]]     # (gz, anti, own)
    haff: List[List[Tuple[int, bool, bool]]]     # (gh, anti, own)
    member_z: List[int]                          # gz or -1
    member_h: List[int]                          # gh or -1
    zone_needed: List[bool]
    has_topo: List[bool]                         # any constraint (not just sg)
    #: [G, Z] eligible-zone mask for min-count (own ZONE requirement over
    #: the oracle's zone universe)
    min_mask: Optional[np.ndarray]
    #: [E] zone index of each existing slot (-1 = no zone label)
    ex_zone: np.ndarray
    supported: bool = True
    reason: str = ""
    #: counter-group name -> index tables (for state seeding from existing
    #: nodes' pod_groups)
    gz_names: Dict[str, int] = field(default_factory=dict)
    gh_names: Dict[str, int] = field(default_factory=dict)


def _intern(table: Dict[str, int], name: str) -> int:
    i = table.get(name)
    if i is None:
        i = table[name] = len(table)
    return i


def build_topo_encoding(enc: SnapshotEncoding, snapshot,
                        existing: Sequence) -> TopoEncoding:
    """Compile per-group topology constraints to dense counter indices.

    ``existing`` must be the name-sorted ExistingNode list the solver uses
    for slots [0, E) — counter seeding is positional."""
    G = len(enc.groups)
    Z = len(enc.zones)
    zpos = {z: i for i, z in enumerate(enc.zones)}
    gz_of: Dict[str, int] = {}
    gh_of: Dict[str, int] = {}

    zspread: List[List[Tuple[int, int, bool]]] = [[] for _ in range(G)]
    hspread: List[List[Tuple[int, int, bool]]] = [[] for _ in range(G)]
    zaff: List[List[Tuple[int, bool, bool]]] = [[] for _ in range(G)]
    haff: List[List[Tuple[int, bool, bool]]] = [[] for _ in range(G)]
    member_z = [-1] * G
    member_h = [-1] * G
    zone_needed = [False] * G
    has_topo = [False] * G
    supported, reason = True, ""

    # the oracle's zone universe: snapshot.zones if non-empty else offering
    # zones (solver/cpu.py::solve) — both are subsets of enc.zones
    if snapshot.zones:
        universe = np.array([z in dict(snapshot.zones) for z in enc.zones], dtype=bool)
    else:
        universe = np.ones(Z, dtype=bool)
    min_mask = np.zeros((G, Z), dtype=bool)

    for g in enc.groups:
        pod = g.pods[0]
        sg = pod.scheduling_group
        constrained = bool(pod.topology_spread) or any(
            a.required for a in pod.pod_affinity)
        has_topo[g.index] = constrained
        if not (constrained or sg):
            continue
        # eligible zones for min-count: the pod's OWN zone requirement
        # (not merged with pool/node), over the oracle universe
        zr = pod.scheduling_requirements().get(L.ZONE)
        min_mask[g.index] = universe & np.array(
            [zr is None or zr.has(z) for z in enc.zones], dtype=bool)
        if pod.scheduling_requirements().get(L.ZONE_ID) is not None \
                and constrained:
            supported, reason = False, "zone-id requirement with topology"
        for c in pod.topology_spread:
            grp = c.group or sg
            if not grp:
                continue  # unreadable counters: oracle no-op for skew>=1
            enforce = c.when_unsatisfiable == "DoNotSchedule"
            if c.topology_key == L.ZONE:
                zspread[g.index].append((_intern(gz_of, grp), c.max_skew,
                                         enforce))
                zone_needed[g.index] = True
            elif c.topology_key == L.HOSTNAME:
                hspread[g.index].append((_intern(gh_of, grp), c.max_skew,
                                         enforce))
            else:
                supported, reason = False, \
                    f"spread key {c.topology_key} unsupported"
        for a in pod.pod_affinity:
            if not a.required:
                continue
            own = a.group == sg
            if a.topology_key == L.ZONE:
                zaff[g.index].append((_intern(gz_of, a.group), a.anti, own))
                zone_needed[g.index] = True
            elif a.topology_key == L.HOSTNAME:
                haff[g.index].append((_intern(gh_of, a.group), a.anti, own))
            else:
                supported, reason = False, \
                    f"affinity key {a.topology_key} unsupported"
        if sg:
            member_z[g.index] = _intern(gz_of, sg)
            member_h[g.index] = _intern(gh_of, sg)

    ex_zone = np.full(len(existing), -1, dtype=np.int32)
    for ei, node in enumerate(existing):
        zi = zpos.get(node.labels.get(L.ZONE, ""))
        if zi is not None:
            ex_zone[ei] = zi

    return TopoEncoding(
        GZ=len(gz_of), GH=len(gh_of),
        zspread=zspread, hspread=hspread, zaff=zaff, haff=haff,
        member_z=member_z, member_h=member_h,
        zone_needed=zone_needed, has_topo=has_topo,
        min_mask=min_mask, ex_zone=ex_zone,
        supported=supported, reason=reason,
        gz_names=gz_of, gh_names=gh_of,
    )


@dataclass
class TopoState:
    """Dense counter state; mutated by the pour."""
    cz: np.ndarray     # [GZ, Z] int64 zone counts per counter group
    ch: np.ndarray     # [GH, N] int64 per-slot counts per counter group
    zfix: np.ndarray   # [N] int32 fixed zone per slot (-1 undecided)

    @staticmethod
    def create(tenc: TopoEncoding, Z: int, N: int, E: int,
               existing: Sequence) -> "TopoState":
        ts = TopoState(
            cz=np.zeros((tenc.GZ, Z), dtype=np.int64),
            ch=np.zeros((tenc.GH, N), dtype=np.int64),
            zfix=np.full(N, -1, dtype=np.int32),
        )
        ts.zfix[:E] = tenc.ex_zone
        # seed counters from pods already on existing nodes — the oracle
        # records (group, ZONE, label) and (group, HOSTNAME, name) per
        # pod_groups entry (solver/cpu.py::solve)
        for ei, node in enumerate(existing):
            for grp in node.pod_groups:
                zi = ts.zfix[ei]
                gzi = tenc.gz_names.get(grp)
                if gzi is not None and zi >= 0:
                    ts.cz[gzi, zi] += 1
                ghi = tenc.gh_names.get(grp)
                if ghi is not None:
                    ts.ch[ghi, ei] += 1
        return ts


# ---------------------------------------------------------------------------
# the pour (host engine)
# ---------------------------------------------------------------------------

class _Pour:
    """Per-group pour: places the group's pods one decision at a time in
    exact oracle order, with closed-form *runs* batching consecutive
    identical placements."""

    def __init__(self, st: ffd.NodeState, enc: SnapshotEncoding,
                 tenc: TopoEncoding, ts: TopoState, g: int):
        self.st, self.enc, self.tenc, self.ts, self.g = st, enc, tenc, ts, g
        self.R = enc.R[g]
        self.agz = enc.agz[g]
        self.agc = enc.agc[g]
        self.zsp = tenc.zspread[g]
        self.hsp = tenc.hspread[g]
        self.zaf = tenc.zaff[g]
        self.haf = tenc.haff[g]
        self.member_z = tenc.member_z[g]
        self.member_h = tenc.member_h[g]
        self.zone_needed = tenc.zone_needed[g]
        self.min_mask = tenc.min_mask[g]
        #: zones with any available offering per type (_choose_zone scans
        #: zones of available offerings regardless of capacity type);
        #: computed once per encoding, not once per pour
        self.avail_anyct = getattr(enc, "_avail_anyct", None)
        if self.avail_anyct is None:
            self.avail_anyct = enc.avail.any(axis=2)           # [T, Z]
            enc._avail_anyct = self.avail_anyct

        # Slot admission is eager (cheap); candidate types and headroom per
        # slot are LAZY — first-fit only ever inspects a handful of slots
        # per event, and an eager [N, T] pass per group dominated pour time
        adm = ffd.admission(st, enc, g)
        #: cross-group full-slot mask for identical request vectors: a
        #: slot proven at zero headroom for this R stays full (usage only
        #: grows), so later same-R groups skip the exact recompute
        self._full_shared = st.full_for.get(self.R.tobytes())
        if self._full_shared is None:
            self._full_shared = st.full_for[self.R.tobytes()] = \
                np.zeros(st.N, dtype=bool)
        adm = adm & ~self._full_shared
        self.adm = adm
        self.cand = np.zeros((st.N, enc.A.shape[0]), dtype=bool)
        self._slot_ready = np.zeros(st.N, dtype=bool)
        #: BIG = "not yet evaluated" sentinel (admissibility treats it >0)
        self.rem = np.where(adm, BIG, 0).astype(np.int64)
        self.take = np.zeros(st.N, dtype=np.int64)
        self.touched: Set[int] = set()
        #: placement order: (slot, count) runs — pods of the group are
        #: assigned to slots in THIS order (the oracle stripes pods across
        #: zones, so slot-order chunking would mis-assign identities).
        #: A committed periodic jump is compressed to one
        #: ("cyc", pattern, k) entry = `pattern` repeated k times (decode
        #: expands it with strided slices instead of k*len(pattern) runs).
        self.runs: List[Tuple] = []
        self._enforced_z = any(e for _, _, e in self.zsp)
        #: per-pool static open-a-node arrays (see _open_new)
        self._open_cache: Dict[int, object] = {}
        #: (zones-mask, ct-mask) -> [T] any-available-offering mask; slots
        #: opened by the same pool share few distinct patterns, so the
        #: [T, Z, C] reduction in _ensure_slot runs once per pattern
        self._off_cache: Dict[bytes, np.ndarray] = {}
        #: headroom fast path: R's nonzero dims and A restricted to them,
        #: computed once per group (ffd._headroom re-slices per call)
        self._sel = self.R > 0
        self._Rsel = self.R[self._sel]
        self._Asel = enc.A[:, self._sel] if self._sel.any() else None
        #: (slot, zone, len, kind) event log for periodic-cycle detection
        self.event_log: List[Tuple[int, Optional[int], int, str]] = []
        #: generation replay (see _maybe_replay): tracks the nodes opened
        #: since the last time every generation slot filled. Disabled for
        #: affinity groups (the anti ladder has its own fast path and
        #: occupancy semantics the replay proof doesn't cover).
        self._gen_track = not self.zaf and not self.haf
        self._gen_slots: List[int] = []
        self._gen_opens: List[Tuple[int, Optional[int]]] = []
        self._gen_runs_start = 0
        self._gen_ztot: Dict[int, int] = {}
        #: validated previous generation: (opens, normalized runs, slots)
        self._gen_template: Optional[Tuple] = None
        #: slot-index vector reused by _slot_admissible (two fresh aranges
        #: per event added up at 50k-pod scale)
        self._idx = np.arange(st.N)

    def _hr_new(self, used: np.ndarray) -> np.ndarray:
        """[T] headroom of a slot with per-dim usage `used` (== ffd._headroom
        for the A=[T,D] case, minus the per-call slicing of A)."""
        if self._Asel is None:
            return np.full(self.enc.A.shape[0], BIG, dtype=np.int64)
        q = (self._Asel - used[self._sel]) // self._Rsel
        return np.clip(q.min(axis=1), 0, BIG)

    def _mv_cap(self, pi: int, cand: np.ndarray, hr: np.ndarray) -> int:
        """minValues floor cap for taking pods on a pool-`pi` node whose
        candidate types are `cand` with per-type headroom `hr` — the pour's
        analog of the closed form's min_values_cap application
        (ffd.fill_group_closed_form; core nodeclaim.Add SatisfiesMinValues).
        Existing nodes (pi < 0) are exempt, as in the oracle."""
        if pi < 0 or self.enc.mv_floor is None \
                or not self.enc.mv_floor[pi].any():
            return int(BIG)
        return int(ffd.min_values_cap(self.enc, pi, cand, hr))

    def _ensure_slot(self, slot: int) -> None:
        """Materialize candidate types + headroom for one slot."""
        if self._slot_ready[slot]:
            return
        self._slot_ready[slot] = True
        st, enc, g = self.st, self.enc, self.g
        if not self.adm[slot]:
            self.rem[slot] = 0
            return
        if slot < st.E:
            hr = int(ffd._headroom(st.ex_alloc[slot], st.used[slot], self.R))
            self.rem[slot] = max(hr - int(self.take[slot]), 0)
            if hr <= 0:
                # group-independent resource fullness: transfers to every
                # later same-R group (usage only grows within a solve)
                self._full_shared[slot] = True
            return
        cand = st.types[slot] & enc.F[g]
        zmask = st.zones[slot] & self.agz
        cmask = st.ct[slot] & self.agc
        ck = zmask.tobytes() + cmask.tobytes()
        off = self._off_cache.get(ck)
        if off is None:
            off = self._off_cache[ck] = (
                enc.avail & zmask[None, :, None]
                & cmask[None, None, :]).any(axis=(1, 2))
        cand &= off
        self.cand[slot] = cand
        if not cand.any():
            self.rem[slot] = 0
            return
        hr = self._hr_new(st.used[slot])
        hrc = np.where(cand, hr, 0)
        rem = max(int(hrc.max()) - int(self.take[slot]), 0)
        if rem > 0:
            rem = min(rem, self._mv_cap(int(st.pool[slot]), cand, hrc))
        elif self.take[slot] == 0 \
                and int(np.where(st.types[slot], hr, 0).max()) <= 0:
            # zero headroom over the slot's OWN type set (not the
            # group-masked subset): group-independent, safe to share
            self._full_shared[slot] = True
        self.rem[slot] = rem

    # -- dynamic topology predicates ------------------------------------
    def _zone_ok(self) -> np.ndarray:
        """[Z] zones admissible under enforced zone spread + zone affinity."""
        ts, enc = self.ts, self.enc
        ok = np.ones(len(enc.zones), dtype=bool)
        for gz, s, enforce in self.zsp:
            if not enforce:
                continue
            elig = self.min_mask
            mn = int(ts.cz[gz][elig].min()) if elig.any() else 0
            ok &= (ts.cz[gz] + 1 - mn) <= s
        for gz, anti, own in self.zaf:
            occ = ts.cz[gz] > 0
            if anti:
                ok &= ~occ
            else:
                if occ.any():
                    ok &= occ
                elif not own:
                    ok &= False
        return ok

    def _host_cap(self, slot: int) -> int:
        """Max further pods this pod group may put on `slot` under hostname
        spread (min_count==0 rule) and hostname affinity."""
        ts = self.ts
        cap = int(BIG)
        for gh, s, enforce in self.hsp:
            if enforce:
                cap = min(cap, s - int(ts.ch[gh, slot]))
        for gh, anti, own in self.haf:
            occ_here = ts.ch[gh, slot] > 0
            if anti:
                if occ_here:
                    return 0
                if own:
                    cap = min(cap, 1)  # own placement occupies the domain
            else:
                occ_any = (ts.ch[gh] > 0).any()
                if occ_any:
                    if not occ_here:
                        return 0
                elif not own:
                    return 0
        return max(cap, 0)

    def _host_cap_new(self) -> int:
        """Cap for a brand-new node (fresh hostname domain)."""
        cap = int(BIG)
        for gh, s, enforce in self.hsp:
            if enforce:
                cap = min(cap, s)
        for gh, anti, own in self.haf:
            if not anti:
                occ_any = (self.ts.ch[gh] > 0).any()
                if occ_any or not own:
                    return 0  # required affinity to an occupied/foreign set
            elif own:
                cap = min(cap, 1)
        return max(cap, 0)

    # -- zone choice (oracle _choose_zone) ------------------------------
    def _choose_zone(self, zcand: np.ndarray) -> Optional[int]:
        """Min-score (sum of enforced spread counts), lexicographic
        tie-break, among candidate zones that pass skew + affinity."""
        ts = self.ts
        zok = self._zone_ok()
        best = None
        best_key = None
        for zi in np.nonzero(zcand)[0]:
            if not zok[zi]:
                continue
            score = 0
            for gz, s, enforce in self.zsp:
                if enforce:
                    score += int(ts.cz[gz, zi])
            key = (score, self.enc.zones[zi])
            if best_key is None or key < best_key:
                best, best_key = int(zi), key
        return best

    # -- records (oracle _topology_ok_fixed tail + _record_membership) --
    def _record(self, slot: int, zi: Optional[int], count: int) -> None:
        if self._gen_track and zi is not None:
            self._gen_ztot[zi] = self._gen_ztot.get(zi, 0) + count
        ts = self.ts
        seen_z: Set[int] = set()
        seen_h: Set[int] = set()
        for gz, s, enforce in self.zsp:
            if zi is not None:
                ts.cz[gz, zi] += count
                seen_z.add(gz)
        for gh, s, enforce in self.hsp:
            ts.ch[gh, slot] += count
            seen_h.add(gh)
        if self.member_z >= 0 and self.member_z not in seen_z \
                and zi is not None:
            ts.cz[self.member_z, zi] += count
        if self.member_h >= 0 and self.member_h not in seen_h:
            ts.ch[self.member_h, slot] += count

    # -- slot zone status -----------------------------------------------
    def _slot_zone(self, slot: int) -> Tuple[Optional[int], bool]:
        """(zone index or None, decided). Existing slots use their label;
        open slots use zfix; undecided open slots return (None, False)."""
        if slot < self.st.E:
            zi = int(self.ts.zfix[slot])
            return (zi if zi >= 0 else None), True
        zi = int(self.ts.zfix[slot])
        if zi >= 0:
            return zi, True
        return None, False

    # -- run length under zone dynamics ---------------------------------
    def _zone_run_room(self, zi: int) -> int:
        """How many pods may pour consecutively into zone `zi` before an
        enforced-skew or occupancy-driven admissibility flip could change
        any slot's eligibility. Always >= 1 when the zone is admissible."""
        ts = self.ts
        room = int(BIG)
        for gz, s, enforce in self.zsp:
            if not enforce:
                continue
            elig = self.min_mask
            mn = int(ts.cz[gz][elig].min()) if elig.any() else 0
            c = int(ts.cz[gz, zi])
            if elig.any() and c == mn:
                # pouring may raise the global min -> earlier slots flip
                room = min(room, 1)
            else:
                room = min(room, mn + s - c)
        for gz, anti, own in self.zaf:
            if anti:
                room = min(room, 1)  # occupancy flips after one placement
            elif own and not (ts.cz[gz] > 0).any():
                room = min(room, 1)  # seeding flips occupancy
        # recording flips occupancy of the membership counter too, which
        # other constraints of THIS group never read twice wrongly (reads
        # happen per event), but conservative is fine:
        return max(room, 1)

    # -- the pour -------------------------------------------------------
    def run(self) -> Tuple[np.ndarray, int, List[Tuple[int, int]]]:
        st, enc, g = self.st, self.enc, self.g
        n_rem = int(enc.n[g])
        guard = 0
        max_events = n_rem * 4 + st.N + 16
        while n_rem > 0:
            guard += 1
            if guard > max_events:  # pragma: no cover - safety net
                break
            placed = self._place_run(n_rem)
            if placed == 0:
                break
            n_rem -= placed
        self._commit_narrowing()
        return self.take, n_rem, self.runs

    # -- periodic-cycle jump --------------------------------------------
    # The steady state of a spread pour is a staggered ladder: the event
    # sequence (slot, zone, run-length) becomes periodic (e.g. one pod per
    # zone's first slot, in slot order, per min-increment). Rather than
    # predict the cycle shape (it depends on slot arrangement and skew),
    # detect it: when the last 2p events form two identical halves of pure
    # placements AND the per-period counter deltas are uniform across every
    # eligible zone (so all (count - min) staggers are exactly restored),
    # the next k periods are provably identical — commit them in one shot,
    # bounded by slot headroom, hostname caps, pool budgets, pod count,
    # and the re-admission horizon of untouched zones.
    _MAX_PERIOD = 64

    def _try_jump(self, n_rem: int) -> int:
        log = self.event_log
        L_ = len(log)
        period = 0
        for p in range(1, min(self._MAX_PERIOD, L_ // 2) + 1):
            if log[L_ - 2 * p:L_ - p] == log[L_ - p:]:
                period = p
                break
        if not period:
            return 0
        ev = log[L_ - period:]
        if any(kind != "place" for _, _, _, kind in ev):
            return 0
        # per-period aggregates
        d_take: Dict[int, int] = {}
        d_zone: Dict[int, int] = {}
        d_n = 0
        for slot, zi, ln, _ in ev:
            d_take[slot] = d_take.get(slot, 0) + ln
            if zi is not None:
                d_zone[zi] = d_zone.get(zi, 0) + ln
            d_n += ln
        if d_n == 0:
            return 0
        ts, st, enc = self.ts, self.st, self.enc
        # uniform zone delta over the eligible universe (staggers periodic)
        deltas = set(d_zone.values())
        if len(deltas) != 1:
            return 0
        delta = deltas.pop()
        touched_z = set(d_zone)
        k = n_rem // d_n
        for zi in range(st.Z):
            if self.min_mask.any() and self.min_mask[zi] \
                    and zi not in touched_z:
                # an untouched eligible zone: its count must not pin the
                # min (delta>0 requires every eligible zone to advance)
                if self._enforced_z:
                    return 0
        if k < 1:
            return 0
        # re-admission horizon of untouched zones with usable slots: their
        # (count - min) shrinks by delta per period
        for gz, s, enforce in self.zsp:
            if not enforce:
                continue
            elig = self.min_mask
            if not elig.any():
                return 0
            mn = int(ts.cz[gz][elig].min())
            for zi in range(st.Z):
                if zi in touched_z:
                    continue
                c = int(ts.cz[gz, zi])
                has_usable = bool(((self.rem > 0)
                                   & (ts.zfix == zi)).any())
                if has_usable:
                    k = min(k, max(0, (c - s - mn) // delta))
        # occupancy-driven masks stay stable only for already-occupied
        # zones/slots; the repeated period proves transitions are done for
        # touched entries, but a zero-count untouched reader could flip —
        # zaff/haff read counts>0 which never DECREASE, so untouched masks
        # are static. Safe.
        # slot-capacity bounds
        for slot, dt in d_take.items():
            k = min(k, int(self.rem[slot]) // dt)
            for gh, s, enforce in self.hsp:
                if enforce:
                    room = s - int(ts.ch[gh, slot])
                    k = min(k, room // dt)
            for gh, anti, own in self.haf:
                if anti and own:
                    return 0  # cap-1 slots cannot repeat in a period anyway
        if enc.pools:
            d_pool: Dict[int, int] = {}
            for slot, dt in d_take.items():
                pi = int(st.pool[slot])
                if pi >= 0:
                    d_pool[pi] = d_pool.get(pi, 0) + dt
            for pi, dp in d_pool.items():
                budget = ffd._pool_budget(enc, st.pool_used, pi, self.R)
                k = min(k, int(budget) // dp)
        if k < 1:
            return 0
        # ---- commit k whole periods -----------------------------------
        pattern = [(slot, ln) for slot, _, ln, _ in ev]
        self.runs.append(("cyc", pattern, k))
        for slot, zi, ln, _ in ev:
            total = ln * k
            self.take[slot] += total
            self.rem[slot] -= total
            st.used[slot] += total * self.R
            pi = int(st.pool[slot])
            if pi >= 0:
                st.pool_used[pi] += total * self.R
            self.touched.add(slot)
            self._record(slot, zi, total)
        self.event_log.extend(ev * (k if k < 3 else 2))  # keep periodicity
        return d_n * k

    def _slot_admissible(self, zok: np.ndarray) -> np.ndarray:
        """[n_act] bool — vectorized slot admissibility (rem, hostname
        caps, pool budget, zone admissibility for decided slots; undecided
        open slots pass here and get their zone chosen on selection)."""
        st = self.st
        n_act = st.E + st.num_nodes
        ts = self.ts
        ok = self.rem[:n_act] > 0
        # hostname caps
        for gh, s, enforce in self.hsp:
            if enforce:
                ok &= ts.ch[gh, :n_act] < s
        for gh, anti, own in self.haf:
            occ_here = ts.ch[gh, :n_act] > 0
            if anti:
                ok &= ~occ_here
            else:
                if (ts.ch[gh] > 0).any():
                    ok &= occ_here
                elif not own:
                    ok &= False
        # pool budgets (>= 1 pod)
        if self.enc.pools:
            budgets = np.array(
                [ffd._pool_budget(self.enc, st.pool_used, pi, self.R)
                 for pi in range(len(self.enc.pools))], dtype=np.int64)
            open_sel = st.pool[:n_act] >= 0
            ok[open_sel] &= budgets[st.pool[:n_act][open_sel]] > 0
        # zone admissibility
        zfix = ts.zfix[:n_act]
        dec = zfix >= 0
        enforced_z = self._enforced_z
        need_zone = enforced_z or bool(self.zaf)
        if need_zone:
            zmask = np.zeros(n_act, dtype=bool)
            zmask[dec] = zok[zfix[dec]]
            # zone-label-less existing slots: enforced spread rejects;
            # affinity evaluates the empty domain (anti passes, positive
            # fails when occupied elsewhere or foreign)
            nolab = ~dec & (self._idx[:n_act] < st.E)
            if nolab.any() and not enforced_z:
                empty_ok = True
                for gz, anti, own in self.zaf:
                    occ_any = (self.ts.cz[gz] > 0).any()
                    if not anti and (occ_any or not own):
                        empty_ok = False
                zmask[nolab] = empty_ok
            und = ~dec & (self._idx[:n_act] >= st.E)
            zmask[und] = True  # zone chosen on selection; may still fail
            ok &= zmask
        return ok

    def _place_run(self, n_rem: int) -> int:
        """Place one run (>=1 pods on one target); 0 = unschedulable."""
        st, enc = self.st, self.enc
        placed = self._try_jump(n_rem)
        if placed:
            return placed
        zok = self._zone_ok()
        # one admissibility scan per event; disqualified slots are cleared
        # in place (nothing else about the state changes on a skip)
        ok = self._slot_admissible(zok)
        while True:
            idx = np.nonzero(ok)[0]
            if len(idx) == 0:
                break
            slot = int(idx[0])
            self._ensure_slot(slot)
            if self.rem[slot] <= 0:
                ok[slot] = False
                continue  # lazy evaluation found no real headroom
            pi = int(st.pool[slot])
            budget = ffd._pool_budget(enc, st.pool_used, pi, self.R) \
                if pi >= 0 else int(BIG)
            hcap = self._host_cap(slot)
            zi, decided = self._slot_zone(slot)
            enforced_z = self._enforced_z
            need_zone = enforced_z or bool(self.zaf)
            if decided:
                room_z = self._zone_run_room(zi) \
                    if (need_zone and zi is not None) else int(BIG)
                run = min(self.rem[slot], hcap, budget, n_rem, room_z)
                if run < 1:
                    ok[slot] = False
                    continue
                self._commit(slot, zi, int(run))
                return int(run)
            # undecided open slot — the zone decision must only stick if a
            # pod actually lands (the oracle discards the plan, and the
            # node's domains, on any failure)
            if self.zone_needed:
                zi = self._choose_slot_zone(slot)
                if zi is None:
                    ok[slot] = False
                    continue
                keep, rem_new = self._narrow_for_zone(slot, zi)
                room_z = self._zone_run_room(zi)
                run = min(rem_new, hcap, budget, n_rem, room_z)
                if run < 1:
                    ok[slot] = False
                    continue
                self._fix_slot_zone(slot, zi, keep, rem_new)
                self._commit(slot, zi, int(run), kind="fix")
                return int(run)
            run = min(self.rem[slot], hcap, budget, n_rem)
            if run < 1:
                ok[slot] = False
                continue
            self._commit(slot, None, int(run))
            return int(run)
        # ---- new node pool-by-pool ------------------------------------
        return self._open_new(n_rem)

    def _choose_slot_zone(self, slot: int) -> Optional[int]:
        """_choose_zone over the slot's fit types' available offerings."""
        st, enc = self.st, self.enc
        # fit for ONE more pod group member
        new_used = st.used[slot] + self.R
        hr_fit = (new_used[None, :] <= enc.A).all(axis=1)
        fit_types = self.cand[slot] & hr_fit
        if not fit_types.any():
            return None
        zcand = (self.avail_anyct[fit_types].any(axis=0)
                 & st.zones[slot] & self.agz)
        return self._choose_zone(zcand)

    def _narrow_for_zone(self, slot: int, zi: int) -> Tuple[np.ndarray, int]:
        """Candidate narrowing + headroom if `zi` were fixed. Pure — no
        state mutation (the decision may still fail)."""
        ct_mask = self.st.ct[slot] & self.agc
        keep = self.cand[slot] & (self.enc.avail[:, zi, :]
                                  & ct_mask[None, :]).any(axis=1)
        if not keep.any():
            return keep, 0
        hr = self._hr_new(self.st.used[slot])
        hr = np.where(keep, hr, 0)
        rem_new = max(int(hr.max()) - int(self.take[slot]), 0)
        if rem_new > 0:
            rem_new = min(rem_new, self._mv_cap(int(self.st.pool[slot]),
                                                keep, hr))
        return keep, rem_new

    def _fix_slot_zone(self, slot: int, zi: int, keep: np.ndarray,
                       rem_new: int) -> None:
        st = self.st
        self.ts.zfix[slot] = zi
        onehot = np.zeros(st.Z, dtype=bool)
        onehot[zi] = True
        st.zones[slot] &= onehot
        self.cand[slot] = keep
        self.rem[slot] = rem_new

    def _open_pool_static(self, pi: int):
        """Static (within one group's pour) open-a-node arrays for pool
        `pi`: admission, zone/ct masks, candidate types, per-type headroom.
        False = the pool can never open a node for this group."""
        ent = self._open_cache.get(pi)
        if ent is not None:
            return ent
        enc, g = self.enc, self.g
        pe = enc.pools[pi]
        ent = False
        if enc.admit[g, pi]:
            daemon = enc.daemon[g, pi]
            agz_p = self.agz & pe.agz
            agc_p = self.agc & pe.agc
            if agz_p.any() and agc_p.any():
                off_p = (enc.avail & agz_p[None, :, None]
                         & agc_p[None, None, :]).any(axis=(1, 2))
                cand_new = enc.F[g] & pe.type_rows & off_p
                if cand_new.any():
                    hr = self._hr_new(daemon)
                    hr = np.where(cand_new, hr, 0)
                    if int(hr.max()) >= 1:
                        ent = (daemon, agz_p, agc_p, cand_new, hr)
        self._open_cache[pi] = ent
        return ent

    # -- generation replay ----------------------------------------------
    # A spread ladder advances in *generations*: a set of fresh nodes
    # (typically one per eligible zone) opens, stripes full under the
    # cycle jump, and the next set opens. Event costs concentrate in the
    # ~9 open/redetect events per generation. Once two consecutive
    # generations are IDENTICAL up to slot renaming — same pool/zone open
    # sequence, same run pattern, no foreign-slot or existing-node
    # placements — and (for enforced spread) every zone in the group's
    # eligible/allowed universe advanced by the same per-generation delta
    # (so every count-vs-min and score relation is restored exactly), the
    # sequential pour provably repeats the generation verbatim: replay k
    # of them in one commit, bounded by pod count, pool budgets and slot
    # space. Decisions are bit-identical to the event loop
    # (tests/test_topology_equivalence.py fuzzes this path).

    def _gen_close(self) -> Optional[Tuple]:
        """Validate + normalize the just-finished generation; None if it
        can't serve as a replay template."""
        slots = self._gen_slots
        spos = {s: i for i, s in enumerate(slots)}
        runs = self.runs[self._gen_runs_start:]
        norm: List[Tuple] = []
        for entry in runs:
            if entry[0] == "cyc":
                _, pattern, kk = entry
                pat = []
                for s, ln in pattern:
                    if s not in spos:
                        return None  # foreign slot -> not periodic
                    pat.append((spos[s], ln))
                norm.append(("cyc", tuple(pat), kk))
            else:
                s, ln = entry
                if s not in spos:
                    return None
                norm.append((spos[s], ln))
        if self._enforced_z:
            # every zone the group could place into or that gates its
            # min-count must advance uniformly, or staggers shift and a
            # later generation could diverge from the template
            elig = self.min_mask | self.agz
            deltas = {self._gen_ztot.get(zi, 0)
                      for zi in np.nonzero(elig)[0]}
            if len(deltas) != 1 or deltas == {0}:
                return None
        return (tuple(self._gen_opens), tuple(norm), tuple(slots))

    def _maybe_replay(self, n_rem: int) -> int:
        """At a generation boundary (every current-gen slot full and the
        pour wants a new node): close the generation; if it matches the
        previous one, commit as many whole copies as fit."""
        if not self._gen_track or not self._gen_slots:
            return 0
        if any(self.rem[s] > 0 for s in self._gen_slots):
            return 0  # mid-generation open (zone set growing): no boundary
        closed = self._gen_close()
        template, self._gen_template = self._gen_template, closed
        self._gen_slots = []
        self._gen_opens = []
        self._gen_ztot = {}
        if closed is None or template is None \
                or closed[:2] != template[:2]:
            return 0
        st, enc = self.st, self.enc
        opens, norm, slots = closed
        takes = [int(self.take[s]) for s in slots]
        total = sum(takes)
        if total <= 0:
            return 0
        k = n_rem // total
        k = min(k, (st.N - st.E - st.num_nodes) // len(slots))
        if enc.pools:
            pool_pods: Dict[int, int] = {}
            for (pi, _zi), t in zip(opens, takes):
                pool_pods[pi] = pool_pods.get(pi, 0) + t
            for pi, dp in pool_pods.items():
                budget = ffd._pool_budget(enc, st.pool_used, pi, self.R)
                k = min(k, int(budget) // dp)
        if k < 1:
            return 0
        for _ in range(k):
            new_slots = [self._clone_slot(tsl, pi, zi, take)
                         for (pi, zi), tsl, take in
                         zip(opens, slots, takes)]
            for entry in norm:
                if entry[0] == "cyc":
                    _, pat, kk = entry
                    self.runs.append((
                        "cyc", [(new_slots[j], ln) for j, ln in pat], kk))
                else:
                    j, ln = entry
                    self.runs.append((new_slots[j], ln))
        # the template stays armed: the NEXT boundary compares against it
        return total * k

    def _open_new(self, n_rem: int) -> int:
        st, enc, g = self.st, self.enc, self.g
        placed = self._maybe_replay(n_rem)
        if placed:
            return placed
        hcap = self._host_cap_new()
        if hcap < 1:
            return 0
        for pe in enc.pools:
            pi = pe.index
            ent = self._open_pool_static(pi)
            if ent is False:
                continue
            budget = ffd._pool_budget(enc, st.pool_used, pi, self.R)
            if budget < 1:
                continue
            if st.num_nodes >= st.N - st.E:
                continue
            daemon, agz_p, agc_p, cand_new, hr = ent
            zi = None
            if self.zone_needed:
                fit_types = cand_new & (hr >= 1)
                zcand = self.avail_anyct[fit_types].any(axis=0) & agz_p
                zi = self._choose_zone(zcand)
                if zi is None:
                    continue  # topology unsatisfiable in this pool
            slot = st.E + st.num_nodes
            st.num_nodes += 1
            st.alive[slot] = True
            st.pool[slot] = pi
            if zi is not None:
                onehot = np.zeros(st.Z, dtype=bool)
                onehot[zi] = True
                st.zones[slot] = onehot
                self.ts.zfix[slot] = zi
                keep = cand_new & (enc.avail[:, zi, :]
                                   & agc_p[None, :]).any(axis=1)
            else:
                st.zones[slot] = agz_p
                keep = cand_new
            st.ct[slot] = agc_p
            st.used[slot] = daemon.copy()
            hr2 = np.where(keep, hr, 0)
            cap = int(hr2.max())
            if cap >= 1:
                # minValues floors bound the take exactly as in the closed
                # form (a node whose surviving candidates can't keep the
                # floors is unsatisfiable in this pool — core nodeclaim.Add)
                cap = min(cap, self._mv_cap(pi, keep, hr2))
            if cap < 1:
                # chosen zone has no capacity: the oracle would have failed
                # fit first; treat as unsatisfiable in this pool
                st.num_nodes -= 1
                st.alive[slot] = False
                st.pool[slot] = -1
                st.used[slot] = 0
                self.ts.zfix[slot] = -1
                continue
            self.cand[slot] = keep
            self.adm[slot] = True
            self.rem[slot] = cap
            self._slot_ready[slot] = True
            run_z = self._zone_run_room(zi) if (zi is not None and (
                self._enforced_z or self.zaf)) else int(BIG)
            run = min(cap, hcap, budget, n_rem, run_z)
            run = max(run, 1)
            if self._gen_track:
                if not self._gen_slots:
                    self._gen_runs_start = len(self.runs)
                    self._gen_ztot = {}
                self._gen_slots.append(slot)
                self._gen_opens.append((pi, zi))
            self._commit(slot, zi, int(run), kind="new")
            if (run == 1 and hcap == 1 and zi is None
                    and not self.zsp and not self.zaf and not self.hsp
                    and all(anti and own for _gh, anti, own in self.haf)
                    and n_rem > 1):
                # cap-1 hostname-anti ladder (the one-pod-per-node
                # deployment pattern): every subsequent pod provably
                # repeats this exact decision — no slot readmits (anti
                # occupancy and full slots are monotone, zone state is
                # untouched), earlier pools keep failing for their static
                # reasons, this pool's budget only decreases — so clone
                # the fresh-node state instead of re-running the event
                # loop once per pod
                return int(run) + self._bulk_anti_clones(slot, pi,
                                                         n_rem - 1)
            return int(run)
        return 0

    def _clone_slot(self, template: int, pi: int, zi: Optional[int],
                    take: int) -> int:
        """Open a new node whose state copies `template` (a same-pour slot
        whose open parameters are proven identical), committing `take`
        pods on it. Shared by the cap-1 anti ladder and the generation
        replay so open-slot bookkeeping lives in one place."""
        st = self.st
        slot = st.E + st.num_nodes
        st.num_nodes += 1
        st.alive[slot] = True
        st.pool[slot] = pi
        st.zones[slot] = st.zones[template].copy()
        st.ct[slot] = st.ct[template].copy()
        st.used[slot] = st.used[template].copy()
        self.cand[slot] = self.cand[template]
        self.adm[slot] = True
        self.rem[slot] = self.rem[template]
        self._slot_ready[slot] = True
        if zi is not None:
            self.ts.zfix[slot] = zi
        self.take[slot] = take
        st.pool_used[pi] += take * self.R
        self.touched.add(slot)
        self._record(slot, zi, take)
        return slot

    def _bulk_anti_clones(self, template: int, pi: int, want: int) -> int:
        """Open `want` more one-pod nodes identical to `template`
        (post-commit state copied), bounded by slot space and pool
        budget. Exactly the sequential pour's decisions, minus the
        per-event admissibility scans."""
        st, enc = self.st, self.enc
        placed = 0
        while placed < want:
            if st.num_nodes >= st.N - st.E:
                break
            if ffd._pool_budget(enc, st.pool_used, pi, self.R) < 1:
                break
            slot = self._clone_slot(template, pi, None, 1)
            self.runs.append((slot, 1))
            self.event_log.append((slot, None, 1, "new"))
            placed += 1
        return placed

    def _commit(self, slot: int, zi: Optional[int], count: int,
                kind: str = "place") -> None:
        st = self.st
        self.take[slot] += count
        if self.runs and self.runs[-1][0] == slot:
            self.runs[-1] = (slot, self.runs[-1][1] + count)
        else:
            self.runs.append((slot, count))
        self.event_log.append((slot, zi, count, kind))
        self.rem[slot] -= count
        st.used[slot] += count * self.R
        pi = int(st.pool[slot])
        if pi >= 0:
            st.pool_used[pi] += count * self.R
        self.touched.add(slot)
        self._record(slot, zi, count)

    def _commit_narrowing(self) -> None:
        """Mirror the closed-form commit: candidate-intersection + refit
        against final aggregate usage, zone/ct mask narrowing."""
        st, enc = self.st, self.enc
        open_slots = np.array(
            [s for s in sorted(self.touched) if st.pool[s] >= 0],
            dtype=np.int64)
        if not len(open_slots):
            return
        # one [S, T, D] comparison instead of S separate [T, D] passes
        fit = (st.used[open_slots][:, None, :]
               <= enc.A[None, :, :]).all(axis=2)
        st.types[open_slots] = self.cand[open_slots] & fit
        for slot in open_slots:
            if self.ts.zfix[slot] < 0:
                st.zones[slot] &= self.agz
            st.ct[slot] &= self.agc


def record_plain_fill(tenc: TopoEncoding, ts: TopoState, st: ffd.NodeState,
                      g: int, take: np.ndarray) -> None:
    """Membership recording for a scheduling_group'd pod group placed via
    the topology-free closed form (the oracle records membership for every
    pod with a scheduling_group even when it has no constraints)."""
    mz, mh = tenc.member_z[g], tenc.member_h[g]
    if mz < 0 and mh < 0:
        return
    for slot in np.nonzero(take > 0)[0]:
        cnt = int(take[slot])
        if mh >= 0:
            ts.ch[mh, slot] += cnt
        if mz >= 0:
            zi = int(ts.zfix[slot])
            if zi >= 0:
                ts.cz[mz, zi] += cnt


def fill_group_topo(st: ffd.NodeState, enc: SnapshotEncoding,
                    tenc: TopoEncoding, ts: TopoState,
                    g: int) -> Tuple[np.ndarray, int, List[Tuple[int, int]]]:
    """Pour group ``g``'s pods with full topology semantics. Mutates
    ``st`` and ``ts``; returns (take[N], leftover, placement runs)."""
    return _Pour(st, enc, tenc, ts, g).run()
