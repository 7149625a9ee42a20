"""The topology group kernels (K9) as their redesigned kernels compute
them, held against the plain parts on the CPU.

The group start is two launches: ``topo_pool_statics`` computes the
carry-free per-pool statics of a chunk of topology groups (the tables'
row j the group of rank r0 + j) once before the chunk's first group, and
packs each type's offerings into one Z*C-bit word; ``topo_group_start``
takes a slot row a CTA, two types a thread (the row's bytes cut at its
2-byte boundaries, pairs at a 4-byte boundary stored with the next
lane's as one 4-byte word), each type's offering test one AND of its
word with the slot's pair word (the loop past 64 pairs), its headroom
quotients by the request's reciprocal. Here: the pool statics of every
topology group, whole and in chunks of 1, 2, 3 groups, against each
group's ``_topo_group_start_ref``; the word test against
``offering_ok``'s loop (Z*C = 64, where bit 63 is the sign bit, and past
the word); the reciprocal quotient against the floor division; a model
of the slot CTA (rows at every alignment, T not a multiple of 4, two
passes, D past the staged rows) against ``_topo_slot_start_ref``.

``csrc/topo.cu`` ``topo_pour`` runs a topology group's events in one
block: it lists the counter rows the group reads or writes and walks only
those, keeps them and the event's state in shared memory (the ring
circular, from a head index), sized by the rows a group lists, and finds
an event's slot in one pass over the slots (the first viable zone-decided
slot by a block min, the admissible undecided slots as ballot bits, then
the undecided ones below the decided one in order, each with one
zone-choice pass over the types). A slot's used row moves
at the group's end by its take. Here, a plain model of each of those
steps, and of the whole pour built from them, against
``ops/topo_torch.py``'s ``_topo_pour_ref``:

- the one-pass search against the plain pour's serial walk, on seeded
  fuzzed admissibility states (undecided slots whose zone choice fails,
  or whose run is < 1, below a viable decided slot; hostname spread and
  affinity rows; budgets at 0) and at every event of every
  ``examples.TOPO_CASES`` case (the model pour's events are the plain
  pour's);
- the compacted rows: every per-event walk over the listed rows (min
  counts, occupancy, zone admissibility, score, run room, host caps,
  admissibility) against the plain walks over the padded rows, with the
  constraining rows at the last padded index and counts in unrelated
  rows;
- the circular ring against the shifted ring: the same period at every
  step of random event sequences with anti-run invalidations and jumps;
- the whole model pour against ``_topo_pour_ref`` at every topology
  group's entry state of every ``TOPO_CASES`` case (the carry, counters,
  zfix, take, leftover, event log, ev_n, bail) at EVCAP 128, and at
  EVCAP 2 (a bail) on ``EVCAP2_CASES``;
- the listed rows' counts, which size the pour's shared memory, the same
  whether the counter axes are padded to 8 rows or to 4,096.

A group without topology has no K9 launch: its ``ffd_group_commit``
(``csrc/ffd_scan.cu``) records its membership where it writes each
slot's take (``TakeRecord``, ``csrc/ffd_step.cuh``): the int32 take,
sign-extended, into ``ch[member_h, s]`` by the slot's one writer, and into
the CTA's shared zone sums, which each CTA adds into ``cz[member_z, :]``
by 64-bit atomics. A model of that record on 1, 2 and 8 CTAs, the CTAs'
atomics applied in shuffled orders, against ``_topo_record_plain_ref`` and
the reference's recording (``topo_jax.py:690-696``) on the same takes:
takes that wrap negative as int32, ``member_z`` / ``member_h`` of -1,
``zfix`` of -1, counters near the int64 limits; and at every plain group
of the ``TOPO_CASES`` scans.

Tolerance: exact (int64 and bool).
"""

import functools
import random

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
from karpenter_provider_aws_tpu_torch.ops import topo_cuda as tc
from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt

BIG = tt.BIG
INV = tt._RB_INVALID
ANY, ANTI, OWN = 1, 2, 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _w(x: int) -> int:
    """x wrapped to int64, as the kernel's unsigned adds and products."""
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


# ---------------------------------------------------------------------------
# the kernel's steps, plainly
# ---------------------------------------------------------------------------

def listed_rows(skew, a_any, a_anti, a_own, s_any, member):
    """The rows a group lists, ascending: (index, skew, flags, records)
    of each row with an enforced skew, an affinity term, a spread record
    or the membership (``topo_pour``'s entry on warp 0)."""
    out = []
    for r in range(len(skew)):
        f = (ANY if a_any[r] else 0) | (ANTI if a_anti[r] else 0) \
            | (OWN if a_own[r] else 0)
        mul = int(bool(s_any[r])) + int(r == member)
        if skew[r] < BIG or f & ANY or mul:
            out.append((r, int(skew[r]), f, mul))
    return out


def zone_stats(czs, zl, mmask, elig):
    """The event's reductions over the listed zone rows (``event_start``):
    (mn, occz per listed row; zok, score, room per zone)."""
    Z = len(mmask)
    mn, occz = [], []
    for j in range(len(zl)):
        m = min([czs[j][z] for z in range(Z) if mmask[z]], default=BIG)
        mn.append(m if elig else 0)
        occz.append(any(c > 0 for c in czs[j]))
    zok, score, room = [], [], []
    for z in range(Z):
        ok, sc, rm, za = True, 0, BIG, BIG
        for j, (_, skew, f, _) in enumerate(zl):
            c = czs[j][z]
            if c + 1 - mn[j] > skew:
                ok = False
            if skew < BIG:
                sc += c
                rm = min(rm, 1 if (elig and c == mn[j]) else mn[j] + skew - c)
            if f & ANY:
                occ = c > 0
                aff = (not occ) if f & ANTI else (occ if occz[j]
                                                  else bool(f & OWN))
                ok &= aff
                if f & ANTI or (f & OWN and not occz[j]):
                    za = 1
        zok.append(ok)
        score.append(sc)
        room.append(max(min(rm, za), 1))
    return mn, occz, zok, score, room


def host_slot(c_col, hl, occh):
    """(admissible under the listed hostname rows, host cap) of a slot
    whose counters in the listed rows are ``c_col``."""
    ok, cap = True, BIG
    for j, (_, skew, f, _) in enumerate(hl):
        c = c_col[j]
        if not c < skew:
            ok = False
        if skew < BIG:
            cap = min(cap, skew - c)
        if f & ANY:
            occ = c > 0
            ok &= (not occ) if f & ANTI else (occ if occh[j]
                                              else bool(f & OWN))
            anti_cap = 0 if occ else (1 if f & OWN else BIG)
            pos_cap = (BIG if occ else 0) if occh[j] else \
                (BIG if f & OWN else 0)
            cap = min(cap, anti_cap if f & ANTI else pos_cap)
    return ok, min(max(cap, 0), BIG)


def host_cap_new(hl, occh):
    cap = BIG
    for j, (_, skew, f, _) in enumerate(hl):
        cap = min(cap, skew)
        if f & ANY:
            per = ((1 if f & OWN else BIG) if f & ANTI
                   else (0 if (occh[j] or not f & OWN) else BIG))
            cap = min(cap, per)
    return min(max(cap, 0), BIG)


def one_pass(N, rem, zfix, pool, chs, hl, occh, bud, zok, room, nrem,
             needz, P):
    """The slot pass: (the first viable decided slot, or N; the
    admissible undecided slots, ascending; each slot's host cap)."""
    best, und, hcaps = N, [], []
    for s in range(N):
        ok, hcap = host_slot([chs[j][s] for j in range(len(hl))], hl, occh)
        hcaps.append(hcap)
        ok = ok and rem[s] > 0
        pl = pool[s]
        ok = ok and pl >= 0 and bud[min(pl, P - 1)] > 0
        zf = zfix[s]
        if needz and zf >= 0:
            ok = ok and zok[zf]
        undecided = zf < 0 and needz
        if ok and not undecided:
            roomz = room[zf] if (needz and zf >= 0) else BIG
            run = min(rem[s], hcap, bud[max(pl, 0)], nrem, roomz)
            if run >= 1:
                best = min(best, s)
        if ok and undecided:
            und.append(s)
    return best, und, hcaps


def search(N, rem, zfix, pool, chs, hl, occh, bud, zok, room, nrem, needz,
           P, choose):
    """The kernel's pick: the undecided slots below the first viable
    decided one, in order, through ``choose(slot) -> (zi, remnew)``
    (its zone-choice pass), else the decided slot; (slot, zone, run,
    fixed) or None. Returns also the number of zone-choice passes."""
    best, und, hcaps = one_pass(N, rem, zfix, pool, chs, hl, occh, bud, zok,
                                room, nrem, needz, P)
    passes = 0
    for u in und:
        if u >= best:
            break
        passes += 1
        zi, remnew = choose(u)
        if zi < 0:
            continue
        run = min(remnew, hcaps[u], bud[max(pool[u], 0)], nrem, room[zi])
        if run >= 1:
            return (u, zi, run, True), passes
    if best < N:
        zf = zfix[best]
        roomz = room[zf] if (needz and zf >= 0) else BIG
        run = min(rem[best], hcaps[best], bud[max(pool[best], 0)], nrem,
                  roomz)
        return (best, zf, run, False), passes
    return None, passes


def serial_walk(N, rem, zfix, pool, chs, hl, occh, bud, zok, room, nrem,
                needz, P, choose):
    """The plain pour's walk (topo_torch.py ``place_event``): every
    admissible slot in order, the first whose run is viable."""
    for s in range(N):
        ok, hcap = host_slot([chs[j][s] for j in range(len(hl))], hl, occh)
        ok = ok and rem[s] > 0 and pool[s] >= 0 \
            and bud[min(pool[s], P - 1)] > 0
        if needz and zfix[s] >= 0:
            ok = ok and zok[zfix[s]]
        if not ok:
            continue
        budget = bud[max(pool[s], 0)]
        if zfix[s] < 0 and needz:
            zi, remnew = choose(s)
            if zi < 0:
                continue
            run = min(remnew, hcap, budget, nrem, room[zi])
            if run >= 1:
                return s, zi, run, True
        else:
            roomz = room[zfix[s]] if (needz and zfix[s] >= 0) else BIG
            run = min(rem[s], hcap, budget, nrem, roomz)
            if run >= 1:
                return s, zfix[s], run, False
    return None


class Ring:
    """The circular ring of the last RB events: ``head`` the oldest."""

    def __init__(self, RB):
        self.RB, self.head = RB, 0
        self.e = [[INV] * 4 for _ in range(RB)]

    def push(self, ev):
        self.e[self.head] = list(ev)
        self.head = (self.head + 1) % self.RB

    def invalidate(self):
        self.e = [[INV] * 4 for _ in range(self.RB)]

    def at(self, i):
        """Logical entry i (0 the oldest)."""
        return self.e[(self.head + i) % self.RB]

    def period(self, L, PMAX):
        """The shortest q <= PMAX whose last two repeats match (lanes over
        q: the least lane that matches), 0 if none."""
        RB = self.RB
        for q in range(1, PMAX + 1):
            if L >= 2 * q and all(self.at(RB - 2 * q + j) == self.at(RB - q + j)
                                  for j in range(q)):
                return q
        return 0


# ---------------------------------------------------------------------------
# the whole pour from those steps
# ---------------------------------------------------------------------------

def pour_model(inp, carry, cz, ch, zfix, g, rows, gs, *, P, EVCAP=128,
               PMAX=8, trace=None):
    """``topo_pour`` step by step: the listed rows, the per-event
    reductions, the jump over the circular ring, the one-pass search, the
    new node and anti ladder, the group end (used rows by take, the
    touched slots' narrowing). Returns ``tt.PourResult``; ``trace``
    collects one (undecided passes, pick) a search."""
    A = inp.A.numpy()
    T, D = A.shape
    R = [int(x) for x in inp.R[g]]
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    N = carry.used.shape[0]
    avail = inp.avail_zc.numpy().reshape(T, Z, C)
    agz = inp.agz[g].tolist()
    agc = inp.agc[g].tolist()
    gx = tt._row(rows, g)
    mmask = gx.min_mask.tolist()
    mz, mh = int(gx.member_z), int(gx.member_h)
    zl = listed_rows(gx.zs_skew.tolist(), gx.za_any.tolist(),
                     gx.za_anti.tolist(), gx.za_own.tolist(),
                     gx.zs_any.tolist(), mz)
    hl = listed_rows(gx.hs_skew.tolist(), gx.ha_any.tolist(),
                     gx.ha_anti.tolist(), gx.ha_own.tolist(),
                     gx.hs_any.tolist(), mh)
    jmh = next((j for j, h in enumerate(hl) if h[0] == mh), -1)
    enf = any(s < BIG for _, s, _, _ in zl)
    zaa = any(f & ANY for _, _, f, _ in zl)
    elig = any(mmask)
    needz, need_zone = enf or zaa, bool(gx.zone_needed)
    veto = any(f == ANY | ANTI | OWN for _, _, f, _ in hl)
    antib = bool(gs.anti_bulk)

    used = carry.used.numpy().copy()
    types, zones = carry.types.numpy().copy(), carry.zones.numpy().copy()
    ct, alive = carry.ct.numpy().copy(), carry.alive.numpy().copy()
    pool = carry.pool.tolist()
    pu = carry.pool_used.numpy().copy()
    plim = inp.pool_limit.numpy()
    cand = gs.cand.numpy().copy()
    rem = gs.rem0.tolist()
    take = [0] * N
    zf_ = zfix.tolist()
    czs = [cz[r].tolist() for r, *_ in zl]
    chs = [ch[h].tolist() for h, *_ in hl]
    occh = [any(c > 0 for c in row) for row in chs]
    zcnt = [0] * Z
    for s in range(N):
        if zf_[s] >= 0 and rem[s] > 0:
            zcnt[zf_[s]] += 1
    cand_new, availz_p = gs.cand_new.numpy(), gs.availz_p.numpy()
    cap_pz, cap_any = gs.cap_pz.tolist(), gs.cap_any.tolist()
    zcand_pz, open_ok0 = gs.zcand_pz.tolist(), gs.open_ok0.tolist()
    daemon = inp.daemon[g].numpy()

    def budget(q):
        m = BIG
        for d in range(D):
            if plim[q, d] >= 0 and R[d] > 0:
                m = min(m, max(int(plim[q, d]) - int(pu[q, d]), 0) // R[d])
        return m

    bud = [budget(q) for q in range(P)]
    RB = 2 * PMAX
    ring = Ring(RB)
    s = dict(nrem=int(inp.n[g]), L=0, evn=0, bail=False, stuck=False,
             nn=int(carry.num_nodes[0]))
    log = {k: [] for k in tt.EV_FILL}

    def set_slot(sl, zf, r):
        if zf_[sl] >= 0 and rem[sl] > 0:
            zcnt[zf_[sl]] -= 1
        if zf >= 0 and r > 0:
            zcnt[zf] += 1
        zf_[sl], rem[sl] = zf, r

    def add_pool(q, pods):
        for d in range(D):
            pu[q, d] = _w(int(pu[q, d]) + _w(pods * R[d]))
        bud[q] = budget(q)

    def add_rows(sl, zi, count):
        if zi >= 0:
            for j, (_, _, _, mul) in enumerate(zl):
                czs[j][zi] += count * mul
        for j, (_, _, _, mul) in enumerate(hl):
            if mul:
                chs[j][sl] += count * mul
                occh[j] = occh[j] or count > 0

    def log_event(slot, zi, ln, kind, aux=0, push=True):
        if s["evn"] >= EVCAP:
            s["bail"] = True
        else:
            for k, v in zip(tt.EV_FILL, (slot, zi, ln, kind, aux)):
                log[k].append(v)
        s["evn"] += 1
        if push:
            ring.push((slot, zi, ln, kind))
            s["L"] += 1

    def commit(slot, zi, count, kind):
        take[slot] = _w(take[slot] + count)
        set_slot(slot, zf_[slot], rem[slot] - count)
        if pool[slot] >= 0:
            add_pool(pool[slot], count)
        s["nrem"] -= count
        add_rows(slot, zi, count)
        log_event(slot, zi, count, kind)

    def jump(mn):
        p = ring.period(s["L"], PMAX)
        if not p:
            return False
        pat = [ring.at(RB - p + e) for e in range(p)]
        if any(e[3] != tt.K_PLACE for e in pat):
            return False
        d_n = sum(e[2] for e in pat)
        dzone = [0] * Z
        for e in pat:
            if e[1] >= 0:
                dzone[min(e[1], Z - 1)] += e[2]
        delta = max([d for d in dzone if d > 0], default=-1)
        uniform = delta > 0 and all(d == delta for d in dzone if d > 0)
        untouched = any(mmask[z] and dzone[z] <= 0 for z in range(Z))
        if not (d_n > 0 and uniform and not (enf and elig and untouched)
                and not veto and not (enf and not elig)):
            return False
        k = s["nrem"] // max(d_n, 1)
        if enf:
            for j, (_, skew, _, _) in enumerate(zl):
                if skew >= BIG:
                    continue
                for z in range(Z):
                    if dzone[z] > 0 or not zcnt[z]:
                        continue
                    k = min(k, min(max((czs[j][z] - skew - mn[j])
                                       // max(delta, 1), 0), BIG))
        dpool = [0] * P
        for i, e in enumerate(pat):
            if any(pat[j][0] == e[0] for j in range(i)):
                continue
            dt = sum(x[2] for x in pat if x[0] == e[0])
            k = min(k, rem[e[0]] // dt)
            for j, (_, skew, _, _) in enumerate(hl):
                if skew < BIG:
                    k = min(k, (skew - chs[j][e[0]]) // dt)
            if pool[e[0]] >= 0:
                dpool[pool[e[0]]] += dt
        for q in range(P):
            if dpool[q] > 0:
                k = min(k, bud[q] // dpool[q])
        if k < 1:
            return False
        for e in pat:
            tot = e[2] * k
            take[e[0]] = _w(take[e[0]] + tot)
            set_slot(e[0], zf_[e[0]], rem[e[0]] - tot)
            add_rows(e[0], -1, tot)
        for q in range(P):
            if dpool[q] > 0:
                add_pool(q, dpool[q] * k)
        s["nrem"] -= d_n * k
        for j, (_, _, _, mul) in enumerate(zl):
            for z in range(Z):
                czs[j][z] += dzone[z] * k * mul
        s["L"] += p * min(k, 2)
        log_event(0, -1, p, tt.K_CYC, aux=k, push=False)
        return True

    def choose(u, zok, score):
        """The zone-choice pass over T of undecided slot u: (zone, the
        room over the types that keep an offering there, less take)."""
        cur = [_w(int(used[u, d]) + _w(take[u] * R[d])) for d in range(D)]
        zflag, lm = [False] * Z, [0] * Z
        for t_ in np.nonzero(cand[u])[0]:
            fit = all(cur[d] + R[d] <= A[t_, d] for d in range(D))
            hr = min([(int(A[t_, d]) - cur[d]) // R[d] for d in range(D)
                      if R[d] > 0], default=BIG)
            hr = max(hr, 0)
            for z in range(Z):
                any_ = bool(avail[t_, z].any())
                kp = bool((avail[t_, z] & ct[u] & np.array(agc)).any())
                zflag[z] |= fit and any_
                if kp:
                    lm[z] = max(lm[z], hr)
        keys = [(score[z] * Z + z, z) for z in range(Z)
                if zflag[z] and zones[u, z] and agz[z] and zok[z]]
        if not keys:
            return -1, 0
        zi = min(keys)[1]
        return zi, min(max(lm[zi] - take[u], 0), BIG)

    while s["nrem"] > 0 and not s["stuck"] and not s["bail"]:
        mn, _, zok, score, room = zone_stats(czs, zl, mmask, elig)
        if jump(mn):
            continue
        memo = {}

        def choose_u(u):
            memo[u] = choose(u, zok, score)
            return memo[u]
        pick, passes = search(N, rem, zf_, pool, chs, hl, occh, bud, zok,
                              room, s["nrem"], needz, P, choose_u)
        if trace is not None:
            trace.append((passes, pick))
        if pick is not None:
            slot, zi, run, fix = pick
            if fix:
                zok_keep = [bool((avail[t_, zi] & ct[slot] & np.array(agc))
                                 .any()) for t_ in range(T)]
                cand[slot] &= np.array(zok_keep)
                zones[slot] = np.arange(Z) == zi
                set_slot(slot, zi, memo[slot][1])
            commit(slot, zi, run, tt.K_FIX if fix else tt.K_PLACE)
            continue
        # a new node (warp 0: the lanes over the pools)
        hcap_new = host_cap_new(hl, occh)
        nn, pi, zsel = s["nn"], -1, 0
        for q in range(P):
            keys = [(score[z] * Z + z, z) for z in range(Z)
                    if zcand_pz[q][z] and zok[z]]
            best = min(keys)[1] if keys else 0
            cap = cap_pz[q][best] if need_zone else cap_any[q]
            if open_ok0[q] and bud[q] >= 1 and N - nn > 0 and cap >= 1 \
                    and hcap_new >= 1 and (not need_zone or keys):
                pi, zsel = q, best
                break
        if pi < 0:
            s["stuck"] = True
            continue
        zi = zsel if need_zone else -1
        zc = max(zi, 0)
        capn = cap_pz[pi][zc] if need_zone else cap_any[pi]
        roomz = room[zc] if (need_zone and needz) else BIG
        run = max(min(capn, hcap_new, bud[pi], s["nrem"], roomz), 1)
        slot = nn
        s["nn"] = nn + 1
        alive[slot] = True
        pool[slot] = pi
        zmask = (np.arange(Z) == zi) if need_zone else \
            (np.array(agz) & inp.pool_agz[pi].numpy())
        zones[slot] = zmask
        ct[slot] = np.array(agc) & inp.pool_agc[pi].numpy()
        used[slot] = daemon[pi]
        set_slot(slot, zi if need_zone else -1, capn)
        commit(slot, zi, run, tt.K_OPEN)
        keep = cand_new[pi] & (availz_p[pi, :, zc] if need_zone else True)
        cand[slot] = keep
        if run == 1 and hcap_new == 1 and zi < 0 and antib and s["nrem"] > 0:
            s0 = s["nn"]
            m = min(s["nrem"], bud[pi], N - s0)
            add_pool(pi, m)
            s["nrem"] -= m
            s["nn"] = s0 + m
            s["L"] += m
            ring.invalidate()
            for sl in range(s0, s0 + m):
                alive[sl] = True
                pool[sl] = pi
                zones[sl] = zmask
                ct[sl] = ct[slot]
                used[sl] = daemon[pi]     # its base row: + take R at the end
                rem[sl] = 0
                take[sl] = 1
                cand[sl] = keep
                if jmh >= 0:
                    chs[jmh][sl] += 1
            if m > 0 and jmh >= 0:
                occh[jmh] = True
            log_event(s0, -1, m, tt.K_ANTIRUN, push=False)

    # the group end: the touched slots' used rows, zones, types
    for sl in range(N):
        if take[sl] > 0 and pool[sl] >= 0:
            used[sl] = [_w(int(used[sl, d]) + _w(take[sl] * R[d]))
                        for d in range(D)]
            if zf_[sl] < 0:
                zones[sl] &= np.array(agz)
            ct[sl] &= np.array(agc)
            types[sl] = cand[sl] & (used[sl][None, :] <= A).all(axis=1)
    cz_out, ch_out = cz.clone(), ch.clone()
    for j, (r, *_) in enumerate(zl):
        cz_out[r] = torch.tensor(czs[j])
    for j, (h, *_) in enumerate(hl):
        ch_out[h] = torch.tensor(chs[j])
    new = ft.Carry(
        used=torch.from_numpy(used), types=torch.from_numpy(types),
        zones=torch.from_numpy(zones), ct=torch.from_numpy(ct),
        pool=torch.tensor(pool, dtype=torch.int32),
        alive=torch.from_numpy(alive),
        num_nodes=torch.tensor([s["nn"]], dtype=torch.int32),
        pool_used=torch.from_numpy(pu))
    ev = {}
    for k, fill in tt.EV_FILL.items():
        row = torch.full((EVCAP,), fill, dtype=torch.int64)
        if log[k]:
            row[:len(log[k])] = torch.tensor(log[k], dtype=torch.int64)
        ev[k] = row
    return tt.PourResult(
        carry=new, cz=cz_out, ch=ch_out,
        zfix=torch.tensor(zf_, dtype=torch.int32),
        take=torch.tensor(take, dtype=torch.int64),
        n_rem=torch.tensor(s["nrem"], dtype=torch.int64), ev=ev,
        ev_n=torch.tensor(min(s["evn"], EVCAP), dtype=torch.int64),
        bail=torch.tensor(s["bail"]))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _group_states(name, EVCAP=128):
    """(inp, rows, P, [(g, carry, cz, ch, zfix, gs, plain pour)]) of a
    kernel case's topology groups, the plain parts carrying the state
    (kept for the module's tests; nothing modifies them)."""
    arrays, rows, st = examples.topo_case(name)
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    trows = tt.topo_rows_from_numpy(rows, "cpu")
    P, N, Z = st["P"], st["n_max"], st["Z"]
    carry = ft.carry0(inp, N, 0)
    cz = torch.zeros((st["GZ"], Z), dtype=torch.int64)
    ch = torch.zeros((st["GH"], N), dtype=torch.int64)
    zfix = torch.full((N,), -1, dtype=torch.int32)
    out = []
    for g, topo in enumerate(rows["has_topo"]):
        if topo:
            gs = tt._topo_group_start_ref(inp, carry, g, trows, P=P)
            r = tt._topo_pour_ref(inp, carry, cz, ch, zfix, g, trows, gs,
                                  P=P, EVCAP=EVCAP, PMAX=8)
            out.append((g, carry, cz, ch, zfix, gs, r))
            carry, cz, ch, zfix = r.carry, r.cz, r.ch, r.zfix
        else:
            carry, take, _ = ft._group_step_ref(inp, carry, g, E=0, P=P,
                                                V=0)
            cz, ch = tt._topo_record_plain_ref(cz, ch, zfix, take,
                                               trows.member_z[g],
                                               trows.member_h[g])
    return inp, trows, P, out


def _assert_pour_equal(got, want, label):
    for f, a, b in zip(ft.Carry._fields, got.carry, want.carry):
        assert a.dtype == b.dtype and torch.equal(a, b), (label, f)
    for f in ("cz", "ch", "zfix", "take", "n_rem", "ev_n", "bail"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), (label, f)
    for k in tt.EV_FILL:
        assert torch.equal(got.ev[k], want.ev[k]), (label, k)


@functools.lru_cache(maxsize=None)
def _traces(name):
    """Each topology group's searches in the model pour of a case:
    [(zone-choice passes, pick)]."""
    inp, rows, P, states = _group_states(name)
    out = []
    for g, carry, cz, ch, zfix, gs, r in states:
        trace = []
        got = pour_model(inp, carry, cz, ch, zfix, g, rows, gs, P=P,
                         trace=trace)
        out.append((g, got, trace))
    return out


#: the cases whose pours are also held at EVCAP 2 (a bail mid-pour: a
#: jump, a zone fix, the anti ladder, an undecided pick, pool limits)
EVCAP2_CASES = ("config3_small", "fix_zones", "anti_slots", "und_first",
                "two_pools_limits")


@pytest.mark.parametrize("name", examples.TOPO_CASES)
def test_model_pour_matches_plain(name):
    """At every topology group's entry state the model pour equals the
    plain pour, at EVCAP 128 and (``EVCAP2_CASES``) at EVCAP 2, a
    bail."""
    states = _group_states(name)[3]
    assert states
    for (g, *_, r), (_, got, _) in zip(states, _traces(name)):
        _assert_pour_equal(got, r, (name, 128, g))
    if name not in EVCAP2_CASES:
        return
    inp, rows, P, states = _group_states(name, 2)
    for g, carry, cz, ch, zfix, gs, r in states:
        got = pour_model(inp, carry, cz, ch, zfix, g, rows, gs, P=P, EVCAP=2)
        _assert_pour_equal(got, r, (name, 2, g))


def test_cases_reach_the_search_hazards():
    """Across the kernel cases the model's searches reach zone-choice
    passes that fail before the pick, a pick among several undecided
    slots and a decided pick with undecided slots above it; the
    constraining rows sit at the last padded index in ``rows_last``."""
    seen = dict(failed_pass=False, fix=False, decided=False, opened=False)
    for name in examples.TOPO_CASES:
        for _, _, trace in _traces(name):
            for passes, pick in trace:
                seen["opened"] |= pick is None
                if pick is None:
                    continue
                seen["fix"] |= pick[3]
                seen["decided"] |= not pick[3]
                seen["failed_pass"] |= passes > int(pick[3])
    assert all(seen.values()), seen
    _, rows, _ = examples.topo_case("rows_last")
    topo = rows["has_topo"]
    assert (rows["zs_skew"][topo, -1] < BIG).any()
    assert (rows["ha_any"][topo, -1] | (rows["hs_skew"][topo, -1] < BIG)).any()


def _fuzz_state(rng: random.Random):
    """A random admissibility state: slots with room or not, pinned to a
    zone or not, in a pool or free; hostname spread and affinity rows;
    budgets; zone admissibility and room; and each undecided slot's
    zone-choice outcome (a failed choice, a run < 1, or a room)."""
    N, Z, P = rng.randint(1, 40), rng.randint(1, 4), rng.randint(1, 3)
    rem = [rng.choice([0, 0, 1, 2, 5, BIG]) for _ in range(N)]
    zfix = [rng.choice([-1, -1] + list(range(Z))) for _ in range(N)]
    pool = [rng.choice([-1] + list(range(P))) for _ in range(N)]
    hl = []
    for h in range(rng.randint(0, 3)):
        kind = rng.choice(["spread", "anti", "own_anti", "aff", "own_aff"])
        skew = rng.randint(1, 4) if kind == "spread" else BIG
        f = {"spread": 0, "anti": ANY | ANTI, "own_anti": ANY | ANTI | OWN,
             "aff": ANY, "own_aff": ANY | OWN}[kind]
        hl.append((h, skew, f, rng.randint(0, 1)))
    chs = [[rng.choice([0, 0, 1, 2, 3]) for _ in range(N)] for _ in hl]
    occh = [any(c > 0 for c in row) or rng.random() < 0.2 for row in chs]
    bud = [rng.choice([0, 1, 3, BIG]) for _ in range(P)]
    zok = [rng.random() < 0.7 for _ in range(Z)]
    room = [rng.choice([1, 2, BIG]) for _ in range(Z)]
    outcome = {s: (rng.choice([-1] + list(range(Z))),
                   rng.choice([0, 1, 4])) for s in range(N)}
    return (N, rem, zfix, pool, chs, hl, occh, bud, zok, room,
            rng.choice([1, 3, 50]), rng.random() < 0.8, P), outcome


def test_one_pass_search_matches_serial_walk():
    """On 3,000 fuzzed states the one-pass search picks the serial
    walk's slot, zone and run; the states reach undecided slots whose
    zone choice fails or whose run is < 1 below a viable decided slot."""
    rng = random.Random(14)
    below = 0
    for _ in range(3000):
        args, outcome = _fuzz_state(rng)
        choose = outcome.__getitem__
        want = serial_walk(*args, choose)
        got, passes = search(*args, choose)
        assert got == want, (args, outcome)
        below += bool(got) and not got[3] and passes > 0
    assert below > 50


def test_compacted_rows_match_padded_walks():
    """The walks over the listed rows equal the plain walks over the
    padded rows: the constraining rows at the last padded index,
    counts in unrelated rows (no term, BIG skew)."""
    rng = random.Random(7)
    for _ in range(300):
        GZ, GH, Z, N = 8, 8, rng.randint(1, 4), rng.randint(1, 12)
        cz = torch.tensor([[rng.randint(0, 5) for _ in range(Z)]
                           for _ in range(GZ)], dtype=torch.int64)
        ch = torch.tensor([[rng.randint(0, 3) for _ in range(N)]
                           for _ in range(GH)], dtype=torch.int64)
        zs_skew = torch.full((GZ,), BIG, dtype=torch.int64)
        hs_skew = torch.full((GH,), BIG, dtype=torch.int64)
        flags = {nm: torch.zeros(GZ if nm[0] == "z" else GH,
                                 dtype=torch.bool)
                 for nm in ("za_any", "za_anti", "za_own", "zs_any",
                            "ha_any", "ha_anti", "ha_own", "hs_any")}
        # the group's own rows at the end of the padded axes
        zs_skew[GZ - 1] = rng.randint(1, 3)
        flags["zs_any"][GZ - 1] = True
        if rng.random() < 0.5:
            flags["za_any"][GZ - 2] = True
            flags["za_anti"][GZ - 2] = rng.random() < 0.5
            flags["za_own"][GZ - 2] = rng.random() < 0.5
        if rng.random() < 0.7:
            hs_skew[GH - 1] = rng.randint(1, 4)
        if rng.random() < 0.7:
            flags["ha_any"][GH - 2] = True
            flags["ha_anti"][GH - 2] = rng.random() < 0.5
            flags["ha_own"][GH - 2] = rng.random() < 0.5
        mmask = torch.tensor([rng.random() < 0.8 for _ in range(Z)])
        mz = rng.choice([-1, GZ - 1, GZ - 3])
        mh = rng.choice([-1, GH - 1, GH - 3])
        zl = listed_rows(zs_skew.tolist(), flags["za_any"].tolist(),
                         flags["za_anti"].tolist(), flags["za_own"].tolist(),
                         flags["zs_any"].tolist(), mz)
        hl = listed_rows(hs_skew.tolist(), flags["ha_any"].tolist(),
                         flags["ha_anti"].tolist(), flags["ha_own"].tolist(),
                         flags["hs_any"].tolist(), mh)
        assert [r for r, *_ in zl] == sorted(r for r, *_ in zl)
        assert zl[-1][0] == GZ - 1
        czs = [cz[r].tolist() for r, *_ in zl]
        elig = bool(mmask.any())
        mn, occz, zok, score, room = zone_stats(czs, zl, mmask.tolist(),
                                                elig)
        pad_mn = tt._min_count(cz, mmask)
        assert mn == [int(pad_mn[r]) for r, *_ in zl]
        assert zok == tt._zone_ok(cz, mmask, zs_skew, flags["za_any"],
                                  flags["za_anti"], flags["za_own"]).tolist()
        assert score == tt._zone_score(cz, zs_skew).tolist()
        for z in range(Z):
            assert room[z] == tt._zone_run_room(
                z, cz, mmask, zs_skew, flags["za_any"], flags["za_anti"],
                flags["za_own"])
        chs = [ch[h].tolist() for h, *_ in hl]
        occh = [any(c > 0 for c in row) for row in chs]
        caps = tt._host_cap_slots(ch, hs_skew, flags["ha_any"],
                                  flags["ha_anti"], flags["ha_own"])
        occ_here = ch > 0
        ha_ok = torch.where(flags["ha_anti"][:, None], ~occ_here,
                            torch.where(occ_here.any(1)[:, None], occ_here,
                                        flags["ha_own"][:, None]
                                        .expand_as(ch)))
        adm = (ch < hs_skew[:, None]).all(0) & torch.where(
            flags["ha_any"][:, None], ha_ok, torch.ones_like(ha_ok)).all(0)
        for s in range(N):
            ok, cap = host_slot([row[s] for row in chs], hl, occh)
            assert (ok, cap) == (bool(adm[s]), int(caps[s]))
        assert host_cap_new(hl, occh) == tt._host_cap_new(
            ch, hs_skew, flags["ha_any"], flags["ha_anti"], flags["ha_own"])
        # the kernel's layout sizing counts the same rows
        rows = tt.TopoGroupRows(
            has_topo=torch.ones(1, dtype=torch.bool),
            zone_needed=torch.ones(1, dtype=torch.bool),
            min_mask=mmask[None], zs_any=flags["zs_any"][None],
            zs_skew=zs_skew[None], hs_any=flags["hs_any"][None],
            hs_skew=hs_skew[None], za_any=flags["za_any"][None],
            za_anti=flags["za_anti"][None], za_own=flags["za_own"][None],
            ha_any=flags["ha_any"][None], ha_anti=flags["ha_anti"][None],
            ha_own=flags["ha_own"][None],
            member_z=torch.tensor([mz], dtype=torch.int32),
            member_h=torch.tensor([mh], dtype=torch.int32))
        nz, nh = tc.listed_rows(rows)
        assert (int(nz[0]), int(nh[0])) == (len(zl), len(hl))


def test_circular_ring_finds_the_shifted_rings_periods():
    """Random event sequences (short periodic runs, anti-run
    invalidations, jumps that only move the event count): at every step
    the circular ring finds the shifted ring's period."""
    rng = random.Random(3)
    for PMAX in (1, 2, 8):
        RB = 2 * PMAX
        for _ in range(40):
            ring, shifted, L = Ring(RB), [(INV,) * 4] * RB, 0
            base = [(rng.randint(0, 3), rng.randint(-1, 2), rng.randint(1, 2),
                     rng.choice([tt.K_PLACE, tt.K_PLACE, tt.K_FIX]))
                    for _ in range(rng.randint(1, PMAX + 1))]
            for step in range(60):
                x = rng.random()
                if x < 0.08:
                    ring.invalidate()
                    shifted = [(INV,) * 4] * RB
                    L += rng.randint(0, 3)
                elif x < 0.15:
                    L += rng.randint(1, 2) * len(base)
                else:
                    ev = base[step % len(base)] if rng.random() < 0.8 else \
                        (rng.randint(0, 3), -1, 1, tt.K_PLACE)
                    ring.push(ev)
                    shifted = shifted[1:] + [tuple(ev)]
                    L += 1
                want = next((q for q in range(1, PMAX + 1)
                             if L >= 2 * q and shifted[RB - 2 * q:RB - q]
                             == shifted[RB - q:]), 0)
                assert ring.period(L, PMAX) == want
                assert [tuple(ring.at(i)) for i in range(RB)] == shifted


def test_layout_sizes():
    """The pour's shared memory holds the rows a group lists
    (``topo_cuda.listed_rows``, the most over the topology groups): a
    case whose counter axes are padded to 4,096 rows (its rows at the
    last index) lists what it lists at 8 rows, a row per term."""
    from karpenter_provider_aws_tpu_torch.fake.environment import Environment
    env = Environment()
    for name in ("rows_last", "config3_small", "zone_plus_hostname"):
        counts = []
        for counters in (None, examples.TOPO_WIDE_COUNTERS):
            _, rows, st = examples.topo_case(name, env, counters=counters)
            assert st["GZ"] == (counters or examples.TOPO_BUCKET["GZp"])
            trows = tt.topo_rows_from_numpy(rows, "cpu")
            nz, nh = tc.listed_rows(trows)
            topo = trows.has_topo
            counts.append((nz[topo].tolist(), nh[topo].tolist()))
        assert counts[0] == counts[1], name
        assert max(counts[0][0]) <= 2 and max(counts[0][1]) <= 2, name


# ---------------------------------------------------------------------------
# the group start: the pool statics, the offering words, the slot CTA
# ---------------------------------------------------------------------------

def statics_rows(has_topo, chunk):
    """Each group's row of the pool statics (its rank among the topology
    groups mod ``chunk``; -1 for the others) and the chunks' groups, as
    ``topo_cuda.TopoScanState`` lays them out (``srow``, ``tgid``)."""
    groups = [g for g, t in enumerate(has_topo) if t]
    srow = [-1] * len(has_topo)
    for r, g in enumerate(groups):
        srow[g] = r % chunk
    return srow, [groups[r:r + chunk] for r in range(0, len(groups), chunk)]


@pytest.mark.parametrize("name", examples.TOPO_CASES)
def test_pool_statics_match_group_start(name):
    """The pool statics of every topology group at once, and in chunks of
    1, 2 and 3 groups and of the card's rule: each group's row equals the
    per-pool fields of its ``_topo_group_start_ref``."""
    arrays, rows_np, st = examples.topo_case(name)
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    rows = tt.topo_rows_from_numpy(rows_np, "cpu")
    P, N = st["P"], st["n_max"]
    T, Z = inp.A.shape[0], inp.agz.shape[1]
    carry = ft.carry0(inp, N, 0)
    has_topo = rows_np["has_topo"].tolist()
    topo = [g for g, t in enumerate(has_topo) if t]
    want = {g: tt._topo_group_start_ref(inp, carry, g, rows, P=P)
            for g in topo}
    for chunk in sorted({1, 2, 3, len(topo), tt.statics_chunk(P, T, Z)}):
        srow, chunks = statics_rows(has_topo, chunk)
        assert sum(map(len, chunks)) == len(topo)
        for groups in chunks:
            tab = tt._topo_pool_statics_ref(inp, rows, groups, P=P)
            for f in tt.PoolStatics._fields:
                assert getattr(tab, f).shape[0] == len(groups), f
            for g in groups:
                for f in tt.PoolStatics._fields:
                    got, w = getattr(tab, f)[srow[g]], getattr(want[g], f)
                    assert got.dtype == w.dtype and torch.equal(got, w), \
                        (name, chunk, g, f)


def test_pool_statics_cases_reach_both_gates():
    """Some topology group of the cases takes the cap-1 anti ladder and
    some does not; some (group, pool) can open a node and some cannot."""
    gates, opens = set(), set()
    for name in examples.TOPO_CASES:
        arrays, rows_np, st = examples.topo_case(name)
        inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
        rows = tt.topo_rows_from_numpy(rows_np, "cpu")
        topo = np.nonzero(rows_np["has_topo"])[0].tolist()
        tab = tt._topo_pool_statics_ref(inp, rows, topo, P=st["P"])
        gates |= set(tab.anti_bulk.tolist())
        opens |= set(tab.open_ok0.reshape(-1).tolist())
    assert gates == {True, False} and opens == {True, False}


def test_statics_chunk_rule():
    """At most 64 groups a chunk, at most 64 MiB of tables, at least one
    group."""
    assert tt.statics_chunk(1, 812, 4) == tt.STATICS_CHUNK == 64
    per = 64 * 812 * (9 + 64) + 64 * (9 * 64 + 9) + 1
    assert tt.statics_chunk(64, 812, 64) == tt.STATICS_BYTES // per == 17
    assert tt.statics_chunk(4096, 100_000, 64) == 1


def offering_loop(zones, ct, agz, agc, avail_zc, Z, C):
    """[T] ``offering_ok`` of one slot for every type (ffd_common.cuh):
    an offered (zone, capacity type) of the slot narrowed by the group."""
    out = []
    for t in range(avail_zc.shape[0]):
        out.append(any(zones[z] and agz[z] and ct[c] and agc[c]
                       and avail_zc[t, z * C + c]
                       for z in range(Z) for c in range(C)))
    return out


def offering_bits(zones, ct, agz, agc, words, avail_zc, Z, C):
    """The slot CTA's test: the slot's admitted pairs as one word (bit
    z*C + c, warp 0's ballots), ANDed with each type's offering word;
    offering_ok's loop past ``OFFER_BITS`` pairs."""
    if Z * C > tt.OFFER_BITS:
        return offering_loop(zones, ct, agz, agc, avail_zc, Z, C)
    zm = 0
    for i in range(Z * C):
        z, c = divmod(i, C)
        if zones[z] and agz[z] and ct[c] and agc[c]:
            zm |= 1 << i
    return [(int(w) & zm) != 0 for w in words]


@pytest.mark.parametrize("Z,C", [(4, 3), (1, 1), (16, 4), (8, 8), (22, 3)])
def test_offer_words_match_offering_loop(Z, C):
    """The offering words (``_offer_words_ref``, what the statics launch
    packs) and the slot's pair word give offering_ok's answer for every
    slot and type: Z*C = 64 sets the sign bit, 66 pairs take the loop."""
    rng = np.random.RandomState(Z * 100 + C)
    T = 57
    avail = rng.rand(T, Z * C) < 0.15
    avail[0] = False
    avail[1, -1] = True                      # the last pair (bit 63 at 64)
    if Z * C <= tt.OFFER_BITS:
        words = tt._offer_words_ref(torch.from_numpy(avail), Z, C).tolist()
        for t in range(T):
            assert [bool(int(words[t]) >> i & 1) for i in range(Z * C)] \
                == avail[t].tolist()
    else:
        with pytest.raises(ValueError):
            tt._offer_words_ref(torch.from_numpy(avail), Z, C)
        words = None
    hits = 0
    for _ in range(40):
        zones, ct = rng.rand(Z) < 0.6, rng.rand(C) < 0.7
        agz, agc = rng.rand(Z) < 0.8, rng.rand(C) < 0.8
        want = offering_loop(zones, ct, agz, agc, avail, Z, C)
        assert offering_bits(zones, ct, agz, agc, words, avail, Z, C) \
            == want
        hits += sum(want)
    assert hits


def floordiv_rcp(a: int, b: int, rb: float) -> int:
    """csrc/ffd_common.cuh ``floordiv_rcp``: below 2^52 the fp64 product
    of a and rb = 1 / b (IEEE, rounded) floored, then one correction each
    way by the remainder; the integer floor division otherwise."""
    lim = 1 << 52
    if a <= -lim or a >= lim or b >= lim:
        return a // b
    q = int(np.floor(np.float64(a) * np.float64(rb)))
    r = a - q * b
    return q - (r < 0) + (r >= b)


def test_fp64_reciprocal_quotient_is_exact():
    """The slot CTA's quotient by the request's reciprocal equals the floor
    division on random and edge operands: multiples of b and one either
    side, negative numerators (over-committed rows), b = 1, 2 and 3,
    operands near 2^52 and past it (the integer path)."""
    rng = np.random.RandomState(7)
    cases = [(int(a), int(b)) for a, b in zip(
        rng.randint(-(1 << 52) + 1, 1 << 52, size=20000, dtype=np.int64),
        rng.randint(1, 1 << 40, size=20000, dtype=np.int64))]
    cases += [(int(a), int(b)) for a, b in zip(
        rng.randint(-(1 << 52) + 1, 1 << 52, size=20000, dtype=np.int64),
        rng.randint(1, 8, size=20000, dtype=np.int64))]
    for _ in range(20000):
        b = int(rng.randint(1, 1 << 26))
        q = int(rng.randint(-(1 << 25), 1 << 25))
        for d in (-1, 0, 1):
            cases.append((q * b + d, b))
    lim = 1 << 52
    cases += [(lim - 1, 1), (-lim + 1, 1), (lim - 1, 2), (lim - 2, 2),
              (lim - 1, 3), (-lim + 1, 7), (lim, 3), (-lim, 3),
              ((1 << 62) + 5, 7), (5, lim + 1), (0, 1), (-1, 1 << 51),
              (1 << 51, (1 << 51) - 1), (lim - 1, (1 << 51) + 1)]
    for a, b in cases:
        assert floordiv_rcp(a, b, 1.0 / b) == a // b, (a, b)


def slot_items(base: int, T: int, nth: int = 512):
    """The slot CTA's cut of a candidate row at byte address ``base``:
    item 0 the type before its first 2-byte boundary, items 1 .. nw pairs
    of types, item nw + 1 the type after the last pair; thread w % nth of
    pass w // nth takes item w. A pair at a 4-byte boundary whose next
    item (the next lane's: lanes 0-30 of a warp) is a pair stores both as
    one 4-byte word, and that next lane stores nothing; other pairs store
    2-byte words, single types bytes. Returns [(types, [(first type,
    bytes stored)])]: each item's types and the stores its lane makes."""
    head = min(base % 2, T)
    nw = (T - head) // 2
    n_of = [head] + [2] * nw + [T - head - 2 * nw]
    items = []
    for w, n in enumerate(n_of):
        t0 = 0 if w == 0 else head + 2 * (w - 1)
        lane = (w % nth) % 32
        nxt = n_of[w + 1] if w + 1 < len(n_of) and (w + 1) % nth else 0
        prv = n_of[w - 1] if w > 0 else 0
        at4 = (base + t0) % 4 == 0
        stores = []
        if n == 2 and at4 and lane < 31 and nxt == 2:
            stores.append((t0, 4))
        elif n == 2 and not (not at4 and lane > 0 and prv == 2):
            stores.append((t0, 2))
        elif n == 1:
            stores.append((t0, 1))
        for t, k in stores:
            assert (base + t) % k == 0
        items.append((list(range(t0, t0 + n)), stores))
    return items


@pytest.mark.parametrize("T,D", [(37, 5), (812, 8), (3, 11), (1, 5),
                                 (1032, 8), (1030, 8)])
def test_slot_cta_model_matches_plain(T, D):
    """A model of ``topo_group_start``'s CTA (rows at each of the four
    byte alignments; a free slot, an existing one and a pool the group
    does not admit take the zero row by 16-byte stores and room 0; an
    open one its items of two types, each type's candidate by the word
    test and its headroom by the reciprocal quotients (D = 11: the global
    rows), the candidate bytes stored as 4-byte words where two pairs
    meet at a 4-byte boundary, else as 2-byte words and bytes, each byte
    once, the room the max over the candidates) against
    ``_topo_slot_start_ref`` on random carries, over-committed rows too;
    T = 1,030 and 1,032 take two passes of the block."""
    rng = np.random.RandomState(T + D)
    Z, C, P, N = 3, 2, 3, 9
    arrays, _ = examples.example_arrays(n_groups=4, n_types=T, P=P, Z=Z,
                                        C=C, D=D)
    arrays["admit"] = rng.rand(4, P) < 0.7
    arrays["agz"] = rng.rand(4, Z) < 0.8
    arrays["agc"] = rng.rand(4, C) < 0.8
    arrays["R"][:, 1] = 0                    # a dimension no group requests
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    words = tt._offer_words_ref(inp.avail_zc, Z, C).tolist()
    A, R = inp.A.numpy(), inp.R.numpy()
    for trial in range(4):
        carry = ft.Carry(
            used=torch.from_numpy(rng.randint(0, 1 << 21, (N, D))),
            types=torch.from_numpy(rng.rand(N, T) < 0.6),
            zones=torch.from_numpy(rng.rand(N, Z) < 0.6),
            ct=torch.from_numpy(rng.rand(N, C) < 0.7),
            pool=torch.from_numpy(rng.choice([-2, -1, 0, 1, 2], N)
                                  .astype(np.int32)),
            alive=torch.ones(N, dtype=torch.bool),
            num_nodes=torch.zeros(1, dtype=torch.int32),
            pool_used=torch.zeros((P, D), dtype=torch.int64))
        used = carry.used.numpy()
        for g in range(4):
            cand, rem0 = tt._topo_slot_start_ref(inp, carry, g, P=P)
            for s in range(N):
                base = (s * T + trial) % 4       # the row's byte address
                pool = int(carry.pool[s])
                if pool < 0 or not arrays["admit"][g, min(pool, P - 1)]:
                    assert not cand[s].any() and int(rem0[s]) == 0
                    continue
                c_of, written = {}, [0] * T
                k = 0
                for types, stores in slot_items(base, T):
                    for t in types:
                        off = offering_bits(
                            carry.zones[s].tolist(), carry.ct[s].tolist(),
                            arrays["agz"][g], arrays["agc"][g], [words[t]],
                            None, Z, C)[0]
                        c = bool(carry.types[s, t]) and \
                            bool(arrays["F"][g, t]) and off
                        assert t not in c_of
                        c_of[t] = c
                        if not c:
                            continue
                        m = BIG
                        for d in range(D):
                            if R[g, d] <= 0:
                                continue
                            x = _w(int(A[t, d]) - int(used[s, d]))
                            m = min(m, floordiv_rcp(x, int(R[g, d]),
                                                    1.0 / int(R[g, d]))
                                    if D <= 8 else x // int(R[g, d]))
                        k = max(k, max(m, 0))
                    for t, nb in stores:
                        for i in range(nb):
                            written[t + i] += 1
                assert written == [1] * T
                assert [c_of[t] for t in range(T)] == cand[s].tolist(), \
                    (T, trial, g, s)
                assert k == int(rem0[s]), (T, trial, g, s)


# ---------------------------------------------------------------------------
# the plain group's membership record, kept by its commit
# ---------------------------------------------------------------------------

M64 = (1 << 64) - 1


def _signed64(x: int) -> int:
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def _take32(k: int) -> int:
    """The int32 the commit writes for a slot's int64 take, read back
    sign-extended."""
    k &= (1 << 32) - 1
    return k - (1 << 32) if k >> 31 else k


def record_model(cz, ch, zfix, k, mz, mh, ctas, order):
    """The commit's record on ``ctas`` CTAs (CTA r writes the takes of
    the slots [r*ceil(N/ctas), ...); the one-CTA minValues form is 1):
    each slot's take into ch[mh, s] by its writer; each CTA's zone sums
    dz [Z] (u64), added into cz[mz, :] by the CTAs in ``order``. New
    (cz, ch) lists."""
    N, Z = len(k), len(cz[0]) if cz else 0
    cz = [list(r) for r in cz]
    ch = [list(r) for r in ch]
    chunk = -(-N // ctas)
    dzs = []
    for r in range(ctas):
        dz = [0] * Z
        for s in range(r * chunk, min(N, (r + 1) * chunk)):
            t = _take32(k[s])
            if mh >= 0:
                ch[mh][s] = _signed64(ch[mh][s] + t)
            if zfix[s] >= 0 and t > 0:
                dz[zfix[s]] = (dz[zfix[s]] + t) & M64
        dzs.append(dz)
    if mz >= 0:
        for r in order:
            for z in range(Z):
                if dzs[r][z]:
                    cz[mz][z] = _signed64(cz[mz][z] + dzs[r][z])
    return cz, ch


def _jax_record(cz, ch, zfix, take, mz, mh):
    """The reference's recording of a plain group (topo_jax.py:690-696,
    the scan's ``plain_group``) on numpy inputs, in the reference
    package's 64-bit mode."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    Z = cz.shape[1]
    take, zfix = jnp.asarray(take), jnp.asarray(zfix)
    chv = jnp.asarray(ch).at[max(mh, 0)].add(jnp.where(mh >= 0, take, 0))
    zi = jnp.clip(zfix, 0, Z - 1)
    dz = jnp.zeros((Z,), jnp.int64).at[zi].add(
        jnp.where((zfix >= 0) & (take > 0), take, 0))
    czv = jnp.asarray(cz).at[max(mz, 0)].add(jnp.where(mz >= 0, dz, 0))
    return np.asarray(czv), np.asarray(chv)


def _check_record(cz, ch, zfix, k, mz, mh, rng):
    """The model on 1, 2 and 8 CTAs, three shuffled orders each, against
    the plain record and the reference's, all on the int32 takes."""
    take = np.array([_take32(int(x)) for x in k], np.int64)
    want = tt._topo_record_plain_ref(
        torch.from_numpy(cz), torch.from_numpy(ch),
        torch.from_numpy(zfix.astype(np.int32)), torch.from_numpy(take),
        torch.tensor(mz, dtype=torch.int32),
        torch.tensor(mh, dtype=torch.int32))
    ref = _jax_record(cz, ch, zfix, take, mz, mh)
    for w, r in zip(want, ref):
        assert np.array_equal(w.numpy(), r)
    for ctas in (1, 2, 8):
        for _ in range(3):
            order = list(range(ctas))
            rng.shuffle(order)
            got = record_model(cz.tolist(), ch.tolist(), zfix.tolist(),
                               [int(x) for x in k], mz, mh, ctas, order)
            for g, w in zip(got, want):
                assert np.array_equal(np.array(g, np.int64).reshape(
                    w.shape), w.numpy()), (ctas, order)


@pytest.mark.parametrize("N,Z", [(1, 3), (13, 3), (64, 1), (300, 5)])
@pytest.mark.parametrize("seed", range(4))
def test_commit_record_model_matches_plain(N, Z, seed):
    """Seeded states: takes that wrap negative as int32 (and past 2^32),
    zero and negative takes, zfix of -1, member rows of -1, counters near
    the int64 limits (the sums wrap)."""
    rng = random.Random(seed * 1000 + N)
    nrng = np.random.RandomState(seed * 1000 + N)
    GZ, GH = 3, 4
    k = nrng.randint(0, 50, N).astype(np.int64)
    for s in nrng.choice(N, size=max(1, N // 5), replace=False):
        k[s] = int(nrng.choice([(1 << 31) + 7, (1 << 32) - 3, (1 << 32) + 9,
                                (1 << 31) - 1, 0, -5]))
    zfix = nrng.randint(-1, Z, N).astype(np.int32)
    big = (1 << 63) - 40
    cz = nrng.randint(0, 1000, (GZ, Z)).astype(np.int64)
    ch = nrng.randint(0, 1000, (GH, N)).astype(np.int64)
    cz[seed % GZ, 0] = big
    ch[seed % GH, 0] = big
    for mz, mh in ((seed % GZ, seed % GH), (-1, 1), (2, -1), (-1, -1)):
        _check_record(cz, ch, zfix, k, mz, mh, rng)


@functools.lru_cache(maxsize=None)
def _plain_group_states(name):
    """[(cz, ch, zfix, take, member_z, member_h)] at each group without
    topology of a kernel case's plain scan (numpy)."""
    arrays, rows, st = examples.topo_case(name)
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    trows = tt.topo_rows_from_numpy(rows, "cpu")
    P, N, Z = st["P"], st["n_max"], st["Z"]
    carry = ft.carry0(inp, N, 0)
    cz = torch.zeros((st["GZ"], Z), dtype=torch.int64)
    ch = torch.zeros((st["GH"], N), dtype=torch.int64)
    zfix = torch.full((N,), -1, dtype=torch.int32)
    out = []
    for g, topo in enumerate(rows["has_topo"]):
        if topo:
            gs = tt._topo_group_start_ref(inp, carry, g, trows, P=P)
            r = tt._topo_pour_ref(inp, carry, cz, ch, zfix, g, trows, gs,
                                  P=P, EVCAP=128, PMAX=8)
            carry, cz, ch, zfix = r.carry, r.cz, r.ch, r.zfix
            continue
        carry, take, _ = ft._group_step_ref(inp, carry, g, E=0, P=P, V=0)
        mz, mh = int(rows["member_z"][g]), int(rows["member_h"][g])
        out.append((cz.numpy().copy(), ch.numpy().copy(),
                    zfix.numpy().copy(), take.numpy().copy(), mz, mh))
        cz, ch = tt._topo_record_plain_ref(cz, ch, zfix, take,
                                           trows.member_z[g],
                                           trows.member_h[g])
    return out


#: kernel cases whose plain groups are members of a counter row (the
#: first two add takes of zone-fixed slots to a zone row)
RECORD_CASES = ("config3_small", "mixed_topo_plain",
                "cross_group_zone_affinity", "und_first")


@pytest.mark.parametrize("name", RECORD_CASES)
def test_commit_record_model_on_the_scans(name):
    """At every plain group of a kernel case's scan, from its entry
    counters: the model against the plain record and the reference's."""
    rng = random.Random(len(name))
    states = _plain_group_states(name)
    for cz, ch, zfix, take, mz, mh in states:
        _check_record(cz, ch, zfix, take, mz, mh, rng)
    assert any(mz >= 0 and mh >= 0 for *_, mz, mh in states)
    if name in RECORD_CASES[:2]:
        assert any(mz >= 0 and ((zfix >= 0) & (take > 0)).any()
                   for cz, ch, zfix, take, mz, mh in states)
