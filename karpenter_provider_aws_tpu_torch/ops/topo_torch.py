"""K9, the topology group scan: plain PyTorch versions and the dispatch.

The port of the reference package's ``ops/topo_jax.py``
(``solve_scan_topo`` via ``dispatch_topo``): a scan over pod groups whose
carry is the open-node state of the base scan (``ops/ffd_torch.py``
``Carry``) plus the topology counters ``cz`` [GZ, Z] (pods per zone of
each zone counter group), ``ch`` [GH, N] (pods per slot of each hostname
counter group) and ``zfix`` [N] (the zone a slot was pinned to, -1
undecided). Per group:

- a group WITHOUT topology runs the base group step (K2) and then records
  its membership counters (``_topo_record_plain_ref``);
- a group WITH topology computes its group-start state
  (``_topo_group_start_ref``): candidates and per-slot room
  (``_topo_slot_start_ref``), and the per-pool statics of opening a node,
  which read no carry and are computed ahead for a chunk of topology
  groups at a time (``_topo_pool_statics_ref``); it then pours its pods
  event by event
  (``_topo_pour_ref``): the periodic-cycle jump over the ring of the last
  2·PMAX events, else the first admissible slot whose run is viable
  (fixing an undecided slot's zone on the way), else a new node, with the
  cap-1 hostname-anti ladder committed in bulk. Each event is appended to
  the group's row of the event log; more than EVCAP events set the
  group's bail flag and stop its loop. The group ends with the narrowing
  of the slots it touched.

Every quantity is int64 with the reference's floor division; every
function here runs on CPU and CUDA tensors alike (the event loop reads
its scalars back with ``int()``). ``solve_scan_topo`` and
``dispatch_topo`` dispatch on the tensors' device: the plain versions
below for CPU tensors, the CUDA kernels of ``ops/topo_cuda.py`` for CUDA
tensors; nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import device as _device
from .ffd_torch import (BIG, Carry, KernelInputs, _group_step_ref, _headroom,
                        carry0, kernel_inputs_from_numpy)

#: event log kinds (the solver expands them into placement runs)
K_PLACE = 0    # run on a zone-decided (or zone-free) slot
K_FIX = 1      # run that also fixed an undecided slot's zone
K_OPEN = 2     # run on a freshly opened node
K_CYC = 3      # periodic jump: len = period p, aux = k whole periods
K_ANTIRUN = 4  # cap-1 anti ladder: len = m fresh one-pod nodes from slot

#: ring sentinel that can never equal a real event (antirun poisoning)
_RB_INVALID = -9

#: fill values of an unused event-log entry: slot, zone, len, kind, aux
EV_FILL = dict(slot=0, zone=-1, len=0, kind=-1, aux=0)

_I64 = torch.int64


class TopoGroupRows(NamedTuple):
    """Per-group dense topology structure (the reference's field set). GZ
    and GH are the interned zone / hostname counter spaces of
    ``ops/topo.py``'s TopoEncoding."""
    has_topo: torch.Tensor     # [G] bool
    zone_needed: torch.Tensor  # [G] bool
    min_mask: torch.Tensor     # [G, Z] bool  eligible zones for min-count
    zs_any: torch.Tensor       # [G, GZ] bool  spread records into counter
    zs_skew: torch.Tensor      # [G, GZ] i64   min enforced skew (BIG = none)
    hs_any: torch.Tensor       # [G, GH] bool
    hs_skew: torch.Tensor      # [G, GH] i64
    za_any: torch.Tensor       # [G, GZ] bool  required zone affinity
    za_anti: torch.Tensor      # [G, GZ] bool
    za_own: torch.Tensor       # [G, GZ] bool
    ha_any: torch.Tensor       # [G, GH] bool
    ha_anti: torch.Tensor      # [G, GH] bool
    ha_own: torch.Tensor       # [G, GH] bool
    member_z: torch.Tensor     # [G] i32  counter to record membership into
    member_h: torch.Tensor     # [G] i32  (-1, or already covered above)


_ROW_DTYPES = dict(zs_skew=_I64, hs_skew=_I64, member_z=torch.int32,
                   member_h=torch.int32)


def topo_rows_from_numpy(rows: dict, device) -> TopoGroupRows:
    """The reference's topology rows, as numpy arrays, on ``device``."""
    dev = _device.resolve(device)
    return TopoGroupRows(**{
        nm: torch.from_numpy(np.array(rows[nm])).to(
            device=dev, dtype=_ROW_DTYPES.get(nm, torch.bool))
        for nm in TopoGroupRows._fields})


class GroupStart(NamedTuple):
    """The group-start state of one topology group (``topo_group_start``)."""
    cand: torch.Tensor       # [N, T] bool  candidate types per slot
    rem0: torch.Tensor       # [N] i64      per-slot room
    cand_new: torch.Tensor   # [P, T] bool  candidates of a new node per pool
    hr_new: torch.Tensor     # [P, T] i64   headroom over each pool's daemon
    open_ok0: torch.Tensor   # [P] bool
    availz_p: torch.Tensor   # [P, T, Z] bool
    cap_pz: torch.Tensor     # [P, Z] i64
    cap_any: torch.Tensor    # [P] i64
    zcand_pz: torch.Tensor   # [P, Z] bool
    anti_bulk: torch.Tensor  # [] bool     the group's cap-1 ladder gate


class PoolStatics(NamedTuple):
    """The carry-free half of the group starts of some topology groups
    (``topo_pool_statics``): GroupStart's per-pool fields with a leading
    group axis [n]."""
    cand_new: torch.Tensor   # [n, P, T] bool
    hr_new: torch.Tensor     # [n, P, T] i64
    open_ok0: torch.Tensor   # [n, P] bool
    availz_p: torch.Tensor   # [n, P, T, Z] bool
    cap_pz: torch.Tensor     # [n, P, Z] i64
    cap_any: torch.Tensor    # [n, P] i64
    zcand_pz: torch.Tensor   # [n, P, Z] bool
    anti_bulk: torch.Tensor  # [n] bool


#: the most topology groups one ``topo_pool_statics`` launch serves (its
#: chunk), and the most bytes its tables may take
STATICS_CHUNK = 64
STATICS_BYTES = 64 << 20

#: the most zone x capacity-type pairs an offering word holds
OFFER_BITS = 64


def statics_chunk(P: int, T: int, Z: int) -> int:
    """The topology groups a chunk of pool statics holds: at most
    ``STATICS_CHUNK``, and at most ``STATICS_BYTES`` of tables (P·T·(9 +
    Z) + P·(9·Z + 9) + 1 bytes a group), at least one."""
    per = P * T * (9 + Z) + P * (9 * Z + 9) + 1
    return max(1, min(STATICS_CHUNK, STATICS_BYTES // per))


# ---------------------------------------------------------------------------
# helpers (the reference's names, topo_jax.py:108-184)
# ---------------------------------------------------------------------------

def _min_count(cz, min_mask):
    """[GZ] min over the eligible zones of each counter (0 when no zone is
    eligible)."""
    masked = torch.where(min_mask[None, :], cz, torch.full_like(cz, BIG))
    return torch.where(min_mask.any(), masked.amin(dim=1),
                       torch.zeros_like(cz[:, 0]))


def _zone_ok(cz, min_mask, zs_skew, za_any, za_anti, za_own):
    """[Z] zones admissible under enforced spread + zone affinity."""
    GZ, Z = cz.shape
    mn = _min_count(cz, min_mask)
    ok = ((cz + 1 - mn[:, None]) <= zs_skew[:, None]).all(dim=0)
    occ = cz > 0
    occ_any = occ.any(dim=1)
    aff_ok = torch.where(za_anti[:, None], ~occ,
                         torch.where(occ_any[:, None], occ,
                                     za_own[:, None].expand(GZ, Z)))
    aff_ok = torch.where(za_any[:, None], aff_ok, torch.ones_like(aff_ok))
    return ok & aff_ok.all(dim=0)


def _zone_score(cz, zs_skew):
    """[Z] zone-choice score: the sum of the enforced-spread counts."""
    return torch.where((zs_skew < BIG)[:, None], cz,
                       torch.zeros_like(cz)).sum(dim=0)


def _choose_zone(zcand, zok, cz, zs_skew) -> int:
    """The min-(score, index) zone among zcand & zok; -1 if none."""
    ok = zcand & zok
    if not bool(ok.any()):
        return -1
    Z = ok.shape[0]
    key = torch.where(ok, _zone_score(cz, zs_skew) * Z
                      + torch.arange(Z, device=cz.device),
                      torch.full_like(cz[0], BIG))
    return int(key.argmin())


def _zone_run_room(zi: int, cz, min_mask, zs_skew, za_any, za_anti,
                   za_own) -> int:
    """Consecutive-pour room in zone ``zi`` (>= 0)."""
    mn = _min_count(cz, min_mask)
    c = cz[:, zi]
    at_min = min_mask.any() & (c == mn)
    per = torch.where(zs_skew < BIG,
                      torch.where(at_min, torch.ones_like(c),
                                  mn + zs_skew - c),
                      torch.full_like(c, BIG))
    occ_any = (cz > 0).any(dim=1)
    za_room = torch.where(za_any & (za_anti | (za_own & ~occ_any)),
                          torch.ones_like(c), torch.full_like(c, BIG))
    return max(min(int(per.amin()), int(za_room.amin())), 1)


def _host_cap_slots(ch, hs_skew, ha_any, ha_anti, ha_own):
    """[N] max further pods per slot under hostname spread/affinity."""
    big = torch.full_like(ch, BIG)
    cap = torch.where((hs_skew < BIG)[:, None], hs_skew[:, None] - ch,
                      big).amin(dim=0)
    occ_here = ch > 0
    occ_any = occ_here.any(dim=1)
    zero = torch.zeros_like(ch)
    anti_cap = torch.where(occ_here, zero,
                           torch.where(ha_own[:, None],
                                       torch.ones_like(ch), big))
    pos_cap = torch.where(occ_any[:, None],
                          torch.where(occ_here, big, zero),
                          torch.where(ha_own[:, None], big, zero))
    ha_cap = torch.where(ha_anti[:, None], anti_cap, pos_cap)
    cap = torch.minimum(cap, torch.where(ha_any[:, None], ha_cap,
                                         big).amin(dim=0))
    return cap.clamp(0, BIG)


def _host_cap_new(ch, hs_skew, ha_any, ha_anti, ha_own) -> int:
    """Cap for a brand-new node."""
    big = torch.full_like(hs_skew, BIG)
    cap = int(torch.where(hs_skew < BIG, hs_skew, big).amin())
    occ_any = (ch > 0).any(dim=1)
    per = torch.where(ha_anti,
                      torch.where(ha_own, torch.ones_like(big), big),
                      torch.where(occ_any | ~ha_own, torch.zeros_like(big),
                                  big))
    cap = min(cap, int(torch.where(ha_any, per, big).amin()))
    return min(max(cap, 0), BIG)


def _budgets(pool_limit, pool_used, R):
    """[P] max additional pods each pool's limits allow (BIG if
    unlimited)."""
    active = (pool_limit >= 0) & (R > 0)[None, :]
    Rsafe = torch.where(R > 0, R, torch.ones_like(R))
    per = torch.div((pool_limit - pool_used).clamp(min=0), Rsafe[None, :],
                    rounding_mode="floor")
    return torch.where(active, per, torch.full_like(per, BIG)).amin(dim=1)


def _row(rows: TopoGroupRows, g: int) -> TopoGroupRows:
    return TopoGroupRows(*[f[g] for f in rows])


# ---------------------------------------------------------------------------
# the three parts the kernels replace
# ---------------------------------------------------------------------------

def _offer_words_ref(avail_zc, Z: int, C: int):
    """[T] int64: each type's offerings as one word, bit z*C + c (Z*C <=
    ``OFFER_BITS``; bit 63 is the sign bit)."""
    ZC = Z * C
    if ZC > OFFER_BITS:
        raise ValueError(f"{ZC} zone x capacity-type pairs exceed the "
                         f"{OFFER_BITS}-bit word")
    bit = torch.ones((), dtype=_I64, device=avail_zc.device) \
        << torch.arange(ZC, device=avail_zc.device)
    return torch.where(avail_zc, bit, torch.zeros_like(bit)).sum(dim=1)


def _topo_slot_start_ref(inp: KernelInputs, carry: Carry, g: int, *,
                         P: int):
    """The slot half of topology group g's start (topo_jax.py:281-291;
    the kernel ``topo_group_start``): (cand [N, T], rem0 [N]). ``off_ok``
    is a boolean any-reduction, never an integer matmul."""
    R, F, agz, agc = inp.R[g], inp.F[g], inp.agz[g], inp.agc[g]
    admit = inp.admit[g]
    Z, C = agz.shape[0], agc.shape[0]
    N = carry.used.shape[0]
    zc = ((carry.zones & agz)[:, :, None]
          & (carry.ct & agc)[:, None, :]).reshape(N, Z * C)
    off_ok = (zc[:, None, :] & inp.avail_zc[None, :, :]).any(dim=-1)
    pool = carry.pool.long()
    adm_open = (pool >= 0) & admit[pool.clamp(0, P - 1)]
    cand = carry.types & F[None, :] & off_ok & adm_open[:, None]
    hr = _headroom(inp.A[None, :, :], carry.used[:, None, :], R)  # [N, T]
    rem0 = torch.where(cand, hr, torch.zeros_like(hr)).amax(dim=1)
    return cand, rem0


def _topo_pool_statics_ref(inp: KernelInputs, rows: TopoGroupRows,
                           groups, *, P: int) -> PoolStatics:
    """The per-pool statics of opening a node and the cap-1 anti-ladder
    gate of each topology group in ``groups`` (a list or a [n] tensor of
    group ids; topo_jax.py:292-315; the kernel ``topo_pool_statics``):
    they read the groups' rows and the static arena, never the carry."""
    g = torch.as_tensor(groups, dtype=_I64, device=inp.A.device)
    R, F, agz, agc = inp.R[g], inp.F[g], inp.agz[g], inp.agc[g]
    admit, daemon = inp.admit[g], inp.daemon[g]
    T, D = inp.A.shape
    Z, C = agz.shape[1], agc.shape[1]
    avail_tzc = inp.avail_zc.reshape(T, Z, C)
    availz_anyct = avail_tzc.any(dim=2)                          # [T, Z]
    agz_p = agz[:, None, :] & inp.pool_agz[None]                 # [n, P, Z]
    agc_p = agc[:, None, :] & inp.pool_agc[None]                 # [n, P, C]
    off_p = (avail_tzc[None, None] & agz_p[:, :, None, :, None]
             & agc_p[:, :, None, None, :]).flatten(3).any(dim=3)
    cand_new = F[:, None, :] & inp.pool_types[None] & off_p      # [n, P, T]
    hr_new = _headroom(inp.A[None, None], daemon[:, :, None, :],
                       R[:, None, None, :])                      # [n, P, T]
    hrc_new = torch.where(cand_new, hr_new, torch.zeros_like(hr_new))
    cap_any = hrc_new.amax(dim=2)
    open_ok0 = (admit & agz_p.any(dim=2) & agc_p.any(dim=2)
                & (cap_any >= 1))
    availz_p = (avail_tzc[None, None]
                & agc_p[:, :, None, None, :]).any(dim=4)         # [n,P,T,Z]
    cap_pz = torch.where(availz_p & cand_new[..., None], hr_new[..., None],
                         torch.zeros_like(hr_new[..., None])).amax(dim=2)
    zcand_pz = ((cand_new & (hr_new >= 1))[..., None]
                & availz_anyct[None, None]).any(dim=2) & agz_p
    anti_bulk = (~rows.zs_any[g].any(dim=1) & ~rows.za_any[g].any(dim=1)
                 & ~rows.hs_any[g].any(dim=1)
                 & torch.where(rows.ha_any[g], rows.ha_anti[g]
                               & rows.ha_own[g],
                               torch.ones_like(rows.ha_any[g])).all(dim=1)
                 & rows.ha_any[g].any(dim=1))
    return PoolStatics(cand_new=cand_new, hr_new=hr_new, open_ok0=open_ok0,
                       availz_p=availz_p, cap_pz=cap_pz, cap_any=cap_any,
                       zcand_pz=zcand_pz, anti_bulk=anti_bulk)


def group_start_of(cand, rem0, tab: PoolStatics, j: int) -> GroupStart:
    """The GroupStart of a slot half and row ``j`` of pool statics."""
    return GroupStart(cand, rem0, *[f[j] for f in tab])


def _topo_group_start_ref(inp: KernelInputs, carry: Carry, g: int,
                          rows: TopoGroupRows, *, P: int) -> GroupStart:
    """The group-start state of topology group g (topo_jax.py:281-315):
    its slot half (``_topo_slot_start_ref``) and its pool statics
    (``_topo_pool_statics_ref``)."""
    cand, rem0 = _topo_slot_start_ref(inp, carry, g, P=P)
    return group_start_of(cand, rem0,
                          _topo_pool_statics_ref(inp, rows, [g], P=P), 0)


class PourResult(NamedTuple):
    carry: Carry
    cz: torch.Tensor        # [GZ, Z] i64
    ch: torch.Tensor        # [GH, N] i64
    zfix: torch.Tensor      # [N] i32
    take: torch.Tensor      # [N] i64
    n_rem: torch.Tensor     # [] i64 (the leftover)
    ev: dict                # slot/zone/len/kind/aux: [EVCAP] i64
    ev_n: torch.Tensor      # [] i64, clipped to EVCAP
    bail: torch.Tensor      # [] bool


def _topo_pour_ref(inp: KernelInputs, carry: Carry, cz, ch, zfix, g: int,
                   rows: TopoGroupRows, gs: GroupStart, *, P: int,
                   EVCAP: int = 128, PMAX: int = 8) -> PourResult:
    """The event loop of topology group g from its group-start state,
    then the group-end narrowing (topo_jax.py:335-683; the kernel
    ``topo_pour``). Nothing passed in is modified."""
    R, n, agz, agc = inp.R[g], inp.n[g], inp.agz[g], inp.agc[g]
    daemon = inp.daemon[g]
    gx = _row(rows, g)
    T, D = inp.A.shape
    Z, C = agz.shape[0], agc.shape[0]
    N = carry.used.shape[0]
    dev = inp.A.device
    RB = 2 * PMAX
    avail_tzc = inp.avail_zc.reshape(T, Z, C)
    availz_anyct = avail_tzc.any(dim=2)
    zs_enf = gx.zs_skew < BIG
    hs_enf = gx.hs_skew < BIG
    enforced_z = bool(zs_enf.any())
    elig_any = bool(gx.min_mask.any())
    needz = enforced_z or bool(gx.za_any.any())
    need_zone = bool(gx.zone_needed)
    ha_veto = bool((gx.ha_any & gx.ha_anti & gx.ha_own).any())
    anti_bulk = bool(gs.anti_bulk)
    mz, mh = int(gx.member_z), int(gx.member_h)
    agz_p = agz[None, :] & inp.pool_agz
    agc_p = agc[None, :] & inp.pool_agc
    zrange = torch.arange(Z, device=dev)

    used, types = carry.used.clone(), carry.types.clone()
    zones, ct = carry.zones.clone(), carry.ct.clone()
    pool, alive = carry.pool.clone(), carry.alive.clone()
    pool_used = carry.pool_used.clone()
    num_nodes = int(carry.num_nodes.reshape(-1)[0])
    cz, ch, zfix = cz.clone(), ch.clone(), zfix.clone()
    take = torch.zeros(N, dtype=_I64, device=dev)
    rem = gs.rem0.clone()
    cand = gs.cand.clone()
    s = dict(n_rem=int(n), L=0, ev_n=0, bail=False, stuck=False,
             num_nodes=num_nodes)
    log = {k: [] for k in EV_FILL}
    rb = [(_RB_INVALID,) * 4] * RB

    def budgets():
        return _budgets(inp.pool_limit, pool_used, R)

    def room(zi):
        return _zone_run_room(zi, cz, gx.min_mask, gx.zs_skew, gx.za_any,
                              gx.za_anti, gx.za_own)

    def log_event(slot, zi, ln, kind, aux=0, ring=True):
        nonlocal rb
        if s["ev_n"] >= EVCAP:
            s["bail"] = True
        else:
            for k, v in zip(EV_FILL, (slot, zi, ln, kind, aux)):
                log[k].append(v)
        s["ev_n"] += 1
        if ring:
            rb = rb[1:] + [(slot, zi, ln, kind)]
            s["L"] += 1

    def commit(slot, zi, count, kind):
        take[slot] += count
        rem[slot] -= count
        used[slot] += count * R
        pi = int(pool[slot])
        if pi >= 0:
            pool_used[pi] += count * R
        s["n_rem"] -= count
        # spread counters (zone ones only with a decided zone), then the
        # membership counters not covered by them
        if zi >= 0:
            cz[:, zi] += torch.where(gx.zs_any, count, 0)
            if mz >= 0:
                cz[mz, zi] += count
        ch[:, slot] += torch.where(gx.hs_any, count, 0)
        if mh >= 0:
            ch[mh, slot] += count
        log_event(slot, zi, count, kind)

    def try_jump() -> bool:
        """The periodic-cycle jump (topo_jax.py:341-441): commit k whole
        periods of the ring's tail pattern when it is safe."""
        p = next((q for q in range(1, PMAX + 1)
                  if s["L"] >= 2 * q and rb[RB - 2 * q:RB - q] == rb[RB - q:]),
                 0)
        if not p:
            return False
        pat = rb[RB - p:]
        if any(e[3] != K_PLACE for e in pat):
            return False
        d_n = sum(e[2] for e in pat)
        d_take: dict = {}
        for e in pat:
            d_take[e[0]] = d_take.get(e[0], 0) + e[2]
        d_zone = [0] * Z
        for e in pat:
            if e[1] >= 0:
                d_zone[min(e[1], Z - 1)] += e[2]
        touched = [d > 0 for d in d_zone]
        delta = max(d if t else -1 for d, t in zip(d_zone, touched))
        uniform = delta > 0 and all(d == delta for d, t in
                                    zip(d_zone, touched) if t)
        mm = gx.min_mask.tolist()
        untouched_elig = any(m and not t for m, t in zip(mm, touched))
        if not (d_n > 0 and uniform and not ha_veto
                and not (enforced_z and elig_any and untouched_elig)
                and not (enforced_z and not elig_any)):
            return False
        k = s["n_rem"] // max(d_n, 1)
        # re-admission horizon of untouched zones with usable slots
        usable = [bool(((rem > 0) & (zfix == z)).any()) for z in range(Z)]
        cols = [z for z in range(Z) if usable[z] and not touched[z]]
        if enforced_z and cols:
            mn = _min_count(cz, gx.min_mask)
            hz = torch.div(cz - gx.zs_skew[:, None] - mn[:, None],
                           max(delta, 1), rounding_mode="floor").clamp(0, BIG)
            k = min(k, int(hz[zs_enf][:, cols].amin()))
        # per-slot capacity and hostname-spread bounds
        for sl, dt in d_take.items():
            if dt > 0:
                k = min(k, int(rem[sl]) // dt)
                if bool(hs_enf.any()):
                    k = min(k, int(torch.div(gx.hs_skew[hs_enf]
                                             - ch[hs_enf, sl], dt,
                                             rounding_mode="floor").amin()))
        # pool budgets
        d_pool = [0] * P
        for sl, dt in d_take.items():
            pl = int(pool[sl])
            if pl >= 0:
                d_pool[pl] += dt
        bud = budgets().tolist()
        for pl in range(P):
            if d_pool[pl] > 0:
                k = min(k, bud[pl] // d_pool[pl])
        if k < 1:
            return False
        for sl, dt in d_take.items():
            take[sl] += dt * k
            rem[sl] -= dt * k
            used[sl] += dt * k * R
        for pl in range(P):
            if d_pool[pl] > 0:
                pool_used[pl] += d_pool[pl] * k * R
        s["n_rem"] -= d_n * k
        tz = torch.tensor([d * k for d in d_zone], dtype=_I64, device=dev)
        cz.add_(torch.where(gx.zs_any[:, None], tz[None, :], 0))
        if mz >= 0:
            cz[mz] += tz
        for sl, dt in d_take.items():
            ch[:, sl] += torch.where(gx.hs_any, dt * k, 0)
            if mh >= 0:
                ch[mh, sl] += dt * k
        # the host appends the pattern k (k < 3) or 2 more times; the
        # ring tail is the pattern either way, so only the count moves
        s["L"] += p * min(k, 2)
        log_event(0, -1, p, K_CYC, aux=k, ring=False)
        return True

    def place_event():
        zok = _zone_ok(cz, gx.min_mask, gx.zs_skew, gx.za_any, gx.za_anti,
                       gx.za_own)
        # vectorized admissibility (ops/topo.py:_slot_admissible)
        ok = rem > 0
        ok &= (ch < gx.hs_skew[:, None]).all(dim=0)
        occ_here = ch > 0
        occ_any = occ_here.any(dim=1)
        ha_ok = torch.where(gx.ha_anti[:, None], ~occ_here,
                            torch.where(occ_any[:, None], occ_here,
                                        gx.ha_own[:, None].expand_as(ch)))
        ok &= torch.where(gx.ha_any[:, None], ha_ok,
                          torch.ones_like(ha_ok)).all(dim=0)
        bud = budgets()
        pl = pool.long()
        ok &= (pl >= 0) & (bud[pl.clamp(0, P - 1)] > 0)
        if needz:
            ok &= torch.where(zfix >= 0, zok[zfix.long().clamp(0, Z - 1)],
                              torch.ones_like(ok))
        hcaps = _host_cap_slots(ch, gx.hs_skew, gx.ha_any, gx.ha_anti,
                                gx.ha_own)
        # the first admissible slot whose run is viable; a slot that is
        # not is cleared and the selection retries
        pick = None
        for slot in torch.nonzero(ok).flatten().tolist():
            zi_d = int(zfix[slot])
            hcap = int(hcaps[slot])
            budget = int(bud[max(int(pool[slot]), 0)])
            if zi_d < 0 and needz:
                fit1 = ((used[slot] + R)[None, :] <= inp.A).all(dim=1)
                fit_types = cand[slot] & fit1
                zcand = ((availz_anyct & fit_types[:, None]).any(dim=0)
                         & zones[slot] & agz)
                zi = _choose_zone(zcand, zok, cz, gx.zs_skew)
                if zi < 0:
                    continue
                keep = cand[slot] & (avail_tzc[:, zi, :]
                                     & (ct[slot] & agc)[None, :]).any(dim=1)
                hr_slot = _headroom(inp.A, used[slot][None, :], R)
                remnew = min(max(int(torch.where(
                    keep, hr_slot, torch.zeros_like(hr_slot)).amax())
                    - int(take[slot]), 0), BIG)
                run = min(remnew, hcap, budget, s["n_rem"], room(zi))
                if run >= 1:
                    pick = (slot, zi, run, True, keep, remnew)
                    break
            else:
                roomz = room(zi_d) if (needz and zi_d >= 0) else BIG
                run = min(int(rem[slot]), hcap, budget, s["n_rem"], roomz)
                if run >= 1:
                    pick = (slot, zi_d, run, False, None, None)
                    break
        if pick is not None:
            slot, zi, run, fix, keep, remnew = pick
            if fix:
                zfix[slot] = zi
                zones[slot] = zrange == zi
                cand[slot] = keep
                rem[slot] = remnew
            commit(slot, zi, run, K_FIX if fix else K_PLACE)
            return
        open_new(zok)

    def open_new(zok):
        """Open a new node (ops/topo.py:_open_new), then the cap-1 anti
        ladder's bulk commit."""
        nonlocal rb
        hcap_new = _host_cap_new(ch, gx.hs_skew, gx.ha_any, gx.ha_anti,
                                 gx.ha_own)
        bud2 = budgets()
        free = N - s["num_nodes"]
        candz = gs.zcand_pz & zok[None, :]
        key = torch.where(candz, _zone_score(cz, gx.zs_skew)[None, :] * Z
                          + zrange[None, :],
                          torch.full_like(gs.cap_pz, BIG))
        zi_p = key.argmin(dim=1)                                 # [P]
        zvalid = candz.any(dim=1)
        capz = gs.cap_pz.gather(1, zi_p[:, None])[:, 0]
        cap = capz if need_zone else gs.cap_any
        valid = gs.open_ok0 & (bud2 >= 1) & (cap >= 1)
        if need_zone:
            valid &= zvalid
        if not (free > 0 and hcap_new >= 1 and bool(valid.any())):
            s["stuck"] = True
            return
        pi = int(torch.nonzero(valid)[0, 0])
        zi = int(zi_p[pi]) if need_zone else -1
        zc = max(zi, 0)
        slot = s["num_nodes"]
        keep = gs.cand_new[pi] & gs.availz_p[pi, :, zc] if need_zone \
            else gs.cand_new[pi]
        capn = int(gs.cap_pz[pi, zc]) if need_zone else int(gs.cap_any[pi])
        zmask = (zrange == zi) if need_zone else agz_p[pi]
        roomz = room(zc) if (need_zone and needz) else BIG
        run = max(min(capn, hcap_new, int(bud2[pi]), s["n_rem"], roomz), 1)
        s["num_nodes"] += 1
        alive[slot] = True
        pool[slot] = pi
        zones[slot] = zmask
        ct[slot] = agc_p[pi]
        used[slot] = daemon[pi]
        zfix[slot] = zi if need_zone else -1
        cand[slot] = keep
        rem[slot] = capn
        commit(slot, zi, run, K_OPEN)
        if (run == 1 and hcap_new == 1 and zi < 0 and anti_bulk
                and s["n_rem"] > 0):
            m = min(s["n_rem"], int(budgets()[pi]), N - s["num_nodes"])
            s0 = s["num_nodes"]
            sl = slice(s0, s0 + m)
            alive[sl] = True
            pool[sl] = pi
            zones[sl] = zmask
            ct[sl] = agc_p[pi]
            used[sl] = daemon[pi] + R
            cand[sl] = keep
            rem[sl] = 0
            take[sl] = 1
            pool_used[pi] += m * R
            s["n_rem"] -= m
            if mh >= 0:
                ch[mh, sl] += 1
            # distinct fresh slots never form a periodic pattern
            rb = [(_RB_INVALID,) * 4] * RB
            s["L"] += m
            s["num_nodes"] += m
            log_event(s0, -1, m, K_ANTIRUN, ring=False)

    while s["n_rem"] > 0 and not s["stuck"] and not s["bail"]:
        if not try_jump():
            place_event()

    # group-end narrowing (ops/topo.py:_commit_narrowing)
    touched = (take > 0) & (pool >= 0)
    fit = (used[:, None, :] <= inp.A[None, :, :]).all(dim=2)
    types = torch.where(touched[:, None], cand & fit, types)
    zones = torch.where((touched & (zfix < 0))[:, None], zones & agz[None, :],
                        zones)
    ct = torch.where(touched[:, None], ct & agc[None, :], ct)
    new = Carry(used=used, types=types, zones=zones, ct=ct, pool=pool,
                alive=alive,
                num_nodes=torch.tensor([s["num_nodes"]], dtype=torch.int32,
                                       device=dev),
                pool_used=pool_used)
    ev = {}
    for k, fill in EV_FILL.items():
        row = torch.full((EVCAP,), fill, dtype=_I64, device=dev)
        if log[k]:
            row[:len(log[k])] = torch.tensor(log[k], dtype=_I64, device=dev)
        ev[k] = row
    return PourResult(
        carry=new, cz=cz, ch=ch, zfix=zfix, take=take,
        n_rem=torch.tensor(s["n_rem"], dtype=_I64, device=dev), ev=ev,
        ev_n=torch.tensor(min(s["ev_n"], EVCAP), dtype=_I64, device=dev),
        bail=torch.tensor(s["bail"], device=dev))


def _topo_record_plain_ref(cz, ch, zfix, take, member_z, member_h):
    """The membership recording of a group without topology after its
    base step (topo_jax.py:685-702; the kernel ``topo_record_plain``):
    (cz, ch), new tensors."""
    mz, mh = int(member_z), int(member_h)
    Z = cz.shape[1]
    ch = ch.clone()
    if mh >= 0:
        ch[mh] += take
    dz = torch.zeros(Z, dtype=_I64, device=cz.device).index_add(
        0, zfix.long().clamp(0, Z - 1),
        torch.where((zfix >= 0) & (take > 0), take, torch.zeros_like(take)))
    cz = cz.clone()
    if mz >= 0:
        cz[mz] += dz
    return cz, ch


# ---------------------------------------------------------------------------
# the whole scan
# ---------------------------------------------------------------------------

def empty_events(G: int, EVCAP: int, device) -> dict:
    """An event log of G unused rows (every entry at its fill value)."""
    ev = {k: torch.full((G, EVCAP), v, dtype=_I64, device=device)
          for k, v in EV_FILL.items()}
    ev["n"] = torch.zeros(G, dtype=_I64, device=device)
    return ev


def _solve_scan_topo_ref(inp: KernelInputs, rows: TopoGroupRows, cz0, ch0,
                         n_max: int, P: int, EVCAP: int = 128,
                         PMAX: int = 8):
    """Plain version of the whole topology scan (E = 0): returns (takes
    [G, N] i64, leftover [G], events dict, zfix [N] i32, bail [G], final
    Carry), the reference's ``solve_scan_topo`` outputs. Ordered as the
    kernels are: the pool statics of each chunk of topology groups
    (``statics_chunk``'s rule) before its first group."""
    G = inp.R.shape[0]
    N = n_max
    dev = inp.A.device
    carry = carry0(inp, N, 0)
    cz, ch = cz0.clone(), ch0.clone()
    zfix = torch.full((N,), -1, dtype=torch.int32, device=dev)
    takes = torch.zeros((G, N), dtype=_I64, device=dev)
    leftover = torch.zeros(G, dtype=_I64, device=dev)
    ev = empty_events(G, EVCAP, dev)
    bail = torch.zeros(G, dtype=torch.bool, device=dev)
    flags = rows.has_topo.tolist()
    topo_groups = [g for g, topo in enumerate(flags) if topo]
    T, Z = inp.A.shape[0], inp.agz.shape[1]
    chunk = statics_chunk(P, T, Z)
    rank = 0
    for g, topo in enumerate(flags):
        if topo:
            # the pool statics of the chunk's groups, before its first
            j = rank % chunk
            if j == 0:
                tab = _topo_pool_statics_ref(
                    inp, rows, topo_groups[rank:rank + chunk], P=P)
            rank += 1
            gs = group_start_of(*_topo_slot_start_ref(inp, carry, g, P=P),
                                tab, j)
            r = _topo_pour_ref(inp, carry, cz, ch, zfix, g, rows, gs, P=P,
                               EVCAP=EVCAP, PMAX=PMAX)
            carry, cz, ch, zfix = r.carry, r.cz, r.ch, r.zfix
            take, n_rem = r.take, r.n_rem
            for k in EV_FILL:
                ev[k][g] = r.ev[k]
            ev["n"][g] = r.ev_n
            bail[g] = r.bail
        else:
            carry, take, n_rem = _group_step_ref(inp, carry, g, E=0, P=P,
                                                 V=0)
            cz, ch = _topo_record_plain_ref(cz, ch, zfix, take,
                                            rows.member_z[g],
                                            rows.member_h[g])
        takes[g] = take
        leftover[g] = n_rem
    return takes, leftover, ev, zfix, bail, carry


def solve_scan_topo(inp: KernelInputs, rows: TopoGroupRows, cz0, ch0, *,
                    n_max: int, P: int, EVCAP: int = 128, PMAX: int = 8):
    """The topology scan on the inputs' device: the CUDA kernels for CUDA
    tensors (``ops/topo_cuda.py``), the plain version for CPU tensors.
    Returns (takes, leftover, events, zfix, bail, final Carry)."""
    if inp.A.is_cuda:
        from .topo_cuda import solve_scan_topo_cuda
        return solve_scan_topo_cuda(inp, rows, cz0, ch0, n_max=n_max, P=P,
                                    EVCAP=EVCAP, PMAX=PMAX)
    return _solve_scan_topo_ref(inp, rows, cz0, ch0, n_max, P, EVCAP, PMAX)


def dispatch_topo(arrays: dict, rows: dict, statics: dict, device=None,
                  cache: Optional[dict] = None) -> dict:
    """The reference's ``dispatch_topo``: numpy dicts in (KernelInputs
    fields, TopoGroupRows fields; statics Z/P/GZ/GH/n_max/EVCAP/PMAX), a
    dict of tensors on ``device`` out (takes, leftover, zfix, bail, the
    carry fields, num_nodes [1], ev_slot/zone/len/kind/aux/n). ``cache``
    keeps the placed inputs across the slot-bucket retries of one solve."""
    dev = _device.resolve(device)
    if cache is not None and "inp" in cache:
        inp, trows = cache["inp"], cache["rows"]
    else:
        inp = kernel_inputs_from_numpy(arrays, dev)
        trows = topo_rows_from_numpy(rows, dev)
        if cache is not None:
            cache.update(inp=inp, rows=trows)
    cz0 = torch.zeros((statics["GZ"], statics["Z"]), dtype=_I64, device=dev)
    ch0 = torch.zeros((statics["GH"], statics["n_max"]), dtype=_I64,
                      device=dev)
    takes, leftover, ev, zfix, bail, carry = solve_scan_topo(
        inp, trows, cz0, ch0, n_max=statics["n_max"], P=statics["P"],
        EVCAP=statics["EVCAP"], PMAX=statics["PMAX"])
    out = dict(takes=takes, leftover=leftover, zfix=zfix, bail=bail,
               used=carry.used, types=carry.types, zones=carry.zones,
               ct=carry.ct, pool=carry.pool, alive=carry.alive,
               num_nodes=carry.num_nodes.reshape(1))
    for k, v in ev.items():
        out[f"ev_{k}"] = v
    return out
