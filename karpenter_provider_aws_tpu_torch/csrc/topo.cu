// K9, the topology group scan: the three kernels of a topology group.
//
// Replaces karpenter_provider_aws_tpu/ops/topo_jax.py:solve_scan_topo
// (dispatched by :730 dispatch_topo): a lax.scan over pod groups whose
// topology groups run the pour's event loop in a lax.while_loop. Groups
// without topology run the K2 kernels (ffd_scan.cu) and then
// topo_record_plain; a topology group runs topo_group_start and then
// topo_pour. All of them read and update one carry in device memory
// (FfdArgs: used/types/zones/ct/pool/alive/num_nodes/pool_used) plus the
// topology counters (TopoArgs: cz [GZ, Z], ch [GH, N], zfix [N]); the host
// enqueues the launches of a whole scan with no synchronisation between
// them.
//
// topo_group_start (topo_jax.py:281-315): N + P blocks of 256 threads.
//   Block s < N is slot row s: the candidate mask cand[s, :] (a boolean
//   any-reduction over zone x capacity-type offerings, never an integer
//   matmul) and the room rem[s] = max over candidates of the headroom,
//   as ffd_slot_headroom. Block N + p is pool p's statics of opening a
//   node: cand_new, hr_new (headroom over the pool's daemon row),
//   availz_p, cap_pz, cap_any, zcand_pz, open_ok0; block N also writes
//   the group's cap-1 anti-ladder gate. Bound: a launch costs its
//   latency (one wave, ~0.3 MB at config 3's N = 256, T = 812).
//
// topo_pour (topo_jax.py:335-683): ONE block of 1024 threads for the
//   group, which loops over its events until no pod is left, the group is
//   stuck or the event log overflows (bail). Each event: the per-event
//   reductions (min counts, occupancy, budgets, usable zones, zone
//   admissibility and scores), the periodic-cycle jump over the ring of
//   the last 2 PMAX events, else the admissible slots, the first slot
//   whose run is viable (an undecided slot chooses its zone from its
//   one-more-pod fit types), else a new node and the cap-1 anti ladder's
//   bulk commit; the event goes to the group's row of the log. The ring,
//   the per-event scalars and the small per-zone / per-counter vectors
//   live in shared memory; cand [N, T], ch [GH, N], used, take and rem
//   stay in device memory (L2-resident at config 3). Vector work (slots,
//   types, counter rows) is spread over the block; the serial decisions
//   of an event (the jump's bounds, the zone choice, the pool choice,
//   the commit) run on thread 0 between barriers. The reference paid
//   one device loop iteration per event; here an event costs a few
//   dozen block barriers. Bound: latency, not bytes or operations.
//   The group-end narrowing of the touched slots closes the kernel.
//
// topo_record_plain (topo_jax.py:685-702): one block after a group
//   without topology: ch[member_h, :] += take and cz[member_z, zfix[s]]
//   += take[s] where zfix[s] >= 0 and take[s] > 0.
//
// Integers are int64 with the reference's floor division (floordiv,
// ffd_common.cuh); a negative numerator (a hostname counter above this
// group's skew, a slot past its room) floors toward -inf and makes the
// jump's k small, never wraps.
#include <cuda_runtime.h>

#include "ffd_common.cuh"

// The topology rows of the scan, its counters, the per-group scratch and
// the outputs. 8-byte fields throughout, mirrored by ops/topo_cuda.py.
struct TopoArgs {
    // rows [G, ...]
    const u8* has_topo;     // [G]
    const u8* zone_needed;  // [G]
    const u8* min_mask;     // [G, Z]
    const u8* zs_any;       // [G, GZ]
    const i64* zs_skew;     // [G, GZ]
    const u8* hs_any;       // [G, GH]
    const i64* hs_skew;     // [G, GH]
    const u8* za_any;       // [G, GZ]
    const u8* za_anti;
    const u8* za_own;
    const u8* ha_any;       // [G, GH]
    const u8* ha_anti;
    const u8* ha_own;
    const int* member_z;    // [G]
    const int* member_h;    // [G]
    // counters, carried across groups
    i64* cz;                // [GZ, Z]
    i64* ch;                // [GH, N]
    int* zfix;              // [N]
    // per-group scratch
    i64* take;              // [N]
    i64* rem;               // [N]
    u8* ok;                 // [N]
    u8* keep;               // [T]
    // the group-start statics (topo_group_start -> topo_pour)
    u8* cand_new;           // [P, T]
    i64* hr_new;            // [P, T]
    u8* open_ok0;           // [P]
    u8* availz_p;           // [P, T, Z]
    i64* cap_pz;            // [P, Z]
    i64* cap_any;           // [P]
    u8* zcand_pz;           // [P, Z]
    u8* anti_bulk;          // [1]
    // outputs
    i64* ev_slot;           // [G, EVCAP]
    i64* ev_zone;
    i64* ev_len;
    i64* ev_kind;
    i64* ev_aux;
    i64* ev_n;              // [G]
    u8* bail;               // [G]
    // statics
    i64 GZ, GH, EVCAP, PMAX;
};

namespace {

constexpr int kStartThreads = 256;
constexpr int kPourThreads = 1024;
constexpr int kRecordThreads = 256;

constexpr i64 kPlace = 0, kFix = 1, kOpen = 2, kCyc = 3, kAntiRun = 4;
constexpr i64 kRbInvalid = -9;

__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }
__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }
__device__ __forceinline__ i64 clip_big(i64 x) {
    return x < 0 ? 0 : (x > KARP_BIG ? KARP_BIG : x);
}

// any capacity type offers type t in zone z
__device__ __forceinline__ bool avail_any_ct(const FfdArgs& a, i64 t,
                                             i64 z) {
    const i64 C = a.C;
    for (i64 c = 0; c < C; ++c)
        if (a.avail_zc[t * a.Z * C + z * C + c]) return true;
    return false;
}

// ---------------------------------------------------------------------------
// topo_group_start
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kStartThreads)
topo_group_start_kernel(FfdArgs a, TopoArgs t, i64 g) {
    __shared__ i64 red[33];
    const i64 T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P, N = a.N;
    const i64* R = a.R + g * D;
    const int tid = threadIdx.x;
    if ((i64)blockIdx.x < N) {
        const i64 s = blockIdx.x;
        const int pool = a.pool[s];
        const i64 pc = pool < 0 ? 0 : (pool > P - 1 ? P - 1 : pool);
        const bool adm_open = pool >= 0 && a.admit[g * P + pc];
        i64 kmax = 0;
        for (i64 tt = tid; tt < T; tt += blockDim.x) {
            const bool c = adm_open && a.types[s * T + tt]
                && a.F[g * T + tt] && offering_ok(a, g, s, tt);
            a.cand[s * T + tt] = c;
            if (c) kmax = imax(kmax, headroom(a.A + tt * D,
                                              a.used + s * D, R, D));
        }
        const i64 k = block_max(kmax, red);
        if (tid == 0) t.rem[s] = k;
        return;
    }
    const i64 p = blockIdx.x - N;
    const i64* dmn = a.daemon + (g * P + p) * D;
    i64 cmax = 0;
    for (i64 tt = tid; tt < T; tt += blockDim.x) {
        bool off = false;
        for (i64 z = 0; z < Z && !off; ++z) {
            if (!(a.agz[g * Z + z] && a.pool_agz[p * Z + z])) continue;
            for (i64 c = 0; c < C; ++c) {
                if (a.agc[g * C + c] && a.pool_agc[p * C + c]
                    && a.avail_zc[tt * Z * C + z * C + c]) {
                    off = true;
                    break;
                }
            }
        }
        const bool cn = a.F[g * T + tt] && a.pool_types[p * T + tt] && off;
        const i64 hr = headroom(a.A + tt * D, dmn, R, D);
        t.cand_new[p * T + tt] = cn;
        t.hr_new[p * T + tt] = hr;
        for (i64 z = 0; z < Z; ++z) {
            bool az = false;
            for (i64 c = 0; c < C; ++c)
                az |= a.avail_zc[tt * Z * C + z * C + c]
                    && a.agc[g * C + c] && a.pool_agc[p * C + c];
            t.availz_p[(p * T + tt) * Z + z] = az;
        }
        if (cn) cmax = imax(cmax, hr);
    }
    const i64 cap_any = block_max(cmax, red);
    for (i64 z = 0; z < Z; ++z) {
        i64 m = 0, zc = 0;
        // each thread reads back the rows it wrote above
        for (i64 tt = tid; tt < T; tt += blockDim.x) {
            if (!t.cand_new[p * T + tt]) continue;
            const i64 hr = t.hr_new[p * T + tt];
            if (t.availz_p[(p * T + tt) * Z + z]) m = imax(m, hr);
            if (hr >= 1 && avail_any_ct(a, tt, z)) zc = 1;
        }
        const i64 mm = block_max(m, red);
        const i64 zz = block_max(zc, red);
        if (tid == 0) {
            t.cap_pz[p * Z + z] = mm;
            t.zcand_pz[p * Z + z] = zz && a.agz[g * Z + z]
                && a.pool_agz[p * Z + z];
        }
    }
    if (tid == 0) {
        bool az = false, ac = false;
        for (i64 z = 0; z < Z; ++z) az |= a.agz[g * Z + z] && a.pool_agz[p * Z + z];
        for (i64 c = 0; c < C; ++c) ac |= a.agc[g * C + c] && a.pool_agc[p * C + c];
        t.cap_any[p] = cap_any;
        t.open_ok0[p] = a.admit[g * P + p] && az && ac && cap_any >= 1;
        if (p == 0) {
            // the cap-1 hostname-anti ladder: no zone spread, no zone
            // affinity, no hostname spread, every hostname term a self
            // anti-affinity, at least one
            const i64 GZ = t.GZ, GH = t.GH;
            bool ok = true, any_ha = false;
            for (i64 r = 0; r < GZ; ++r)
                ok &= !t.zs_any[g * GZ + r] && !t.za_any[g * GZ + r];
            for (i64 h = 0; h < GH; ++h) {
                const i64 o = g * GH + h;
                ok &= !t.hs_any[o];
                if (t.ha_any[o]) {
                    any_ha = true;
                    ok &= t.ha_anti[o] && t.ha_own[o];
                }
            }
            t.anti_bulk[0] = ok && any_ha;
        }
    }
}

// ---------------------------------------------------------------------------
// topo_pour
// ---------------------------------------------------------------------------

// per-event and per-group scalars of the pour, in shared memory
enum {
    V_NREM, V_L, V_EVN, V_BAIL, V_STUCK, V_NN, V_CONT, V_JUMP, V_SLOT,
    V_ZI, V_RUN, V_FIX, V_FOUND, V_REMNEW, V_UND, V_HCAP, V_BUDGET, V_PI,
    V_M, V_S0, V_ZC, V_ENF, V_ELIG, V_NEEDZ, V_NEEDZONE, V_HAVETO, V_ANTIB,
    V_MZ, V_MH, V_COUNT
};

// the pour's shared arrays (carved from dynamic shared memory)
struct Sh {
    i64* rb;      // [2 PMAX, 4] ring of the last events: slot, zone, len, kind
    i64* mn;      // [GZ] min count over the eligible zones
    i64* occz;    // [GZ] the counter has a pod in some zone
    i64* occh;    // [GH] the counter has a pod on some slot
    i64* zok;     // [Z] zone admissible
    i64* score;   // [Z] zone-choice score
    i64* zflag;   // [Z] zone candidates of the evaluated slot
    i64* usable;  // [Z] a slot with room is pinned to the zone
    i64* dzone;   // [Z] the jump pattern's pods per zone
    i64* bud;     // [P] pool budgets at the event's start
    i64* dpool;   // [P] the jump pattern's pods per pool
    i64* v;       // [V_COUNT]
};

__device__ void log_event(const TopoArgs& t, const Sh& sh, i64 g, i64 slot,
                          i64 zi, i64 ln, i64 kind, i64 aux, bool ring) {
    i64* v = sh.v;
    const i64 i = v[V_EVN];
    if (i >= t.EVCAP) {
        v[V_BAIL] = 1;
    } else {
        const i64 o = g * t.EVCAP + i;
        t.ev_slot[o] = slot;
        t.ev_zone[o] = zi;
        t.ev_len[o] = ln;
        t.ev_kind[o] = kind;
        t.ev_aux[o] = aux;
    }
    v[V_EVN] = i + 1;
    if (ring) {
        const i64 RB = 2 * t.PMAX;
        for (i64 j = 0; j < (RB - 1) * 4; ++j) sh.rb[j] = sh.rb[j + 4];
        i64* e = sh.rb + (RB - 1) * 4;
        e[0] = slot;
        e[1] = zi;
        e[2] = ln;
        e[3] = kind;
        v[V_L] += 1;
    }
}

// place `count` pods on `slot` (topo_jax.py _commit + _record_scatter)
__device__ void commit(const FfdArgs& a, const TopoArgs& t, const Sh& sh,
                       i64 g, i64 slot, i64 zi, i64 count, i64 kind) {
    const i64 N = a.N, D = a.D, Z = a.Z, GZ = t.GZ, GH = t.GH;
    const i64* R = a.R + g * D;
    t.take[slot] += count;
    t.rem[slot] -= count;
    for (i64 d = 0; d < D; ++d)
        a.used[slot * D + d] = wadd(a.used[slot * D + d], wmul(count, R[d]));
    const int pi = a.pool[slot];
    if (pi >= 0)
        for (i64 d = 0; d < D; ++d)
            a.pool_used[pi * D + d] = wadd(a.pool_used[pi * D + d],
                                           wmul(count, R[d]));
    sh.v[V_NREM] -= count;
    const i64 mz = sh.v[V_MZ], mh = sh.v[V_MH];
    if (zi >= 0) {
        for (i64 r = 0; r < GZ; ++r)
            if (t.zs_any[g * GZ + r]) t.cz[r * Z + zi] += count;
        if (mz >= 0) t.cz[mz * Z + zi] += count;
    }
    for (i64 h = 0; h < GH; ++h)
        if (t.hs_any[g * GH + h]) t.ch[h * N + slot] += count;
    if (mh >= 0) t.ch[mh * N + slot] += count;
    log_event(t, sh, g, slot, zi, count, kind, 0, true);
}

// consecutive-pour room in zone zi >= 0 (topo_jax.py _zone_run_room)
__device__ i64 zone_run_room(const FfdArgs& a, const TopoArgs& t,
                             const Sh& sh, i64 g, i64 zi) {
    const i64 Z = a.Z, GZ = t.GZ;
    const bool elig = sh.v[V_ELIG];
    i64 room = KARP_BIG, za_room = KARP_BIG;
    for (i64 r = 0; r < GZ; ++r) {
        const i64 o = g * GZ + r;
        const i64 skew = t.zs_skew[o];
        if (skew < KARP_BIG) {
            const i64 c = t.cz[r * Z + zi], mn = sh.mn[r];
            room = imin(room, (elig && c == mn) ? 1 : mn + skew - c);
        }
        if (t.za_any[o] && (t.za_anti[o] || (t.za_own[o] && !sh.occz[r])))
            za_room = 1;
    }
    return imax(imin(room, za_room), 1);
}

// max further pods on slot s under hostname spread / affinity
__device__ i64 host_cap_slot(const FfdArgs& a, const TopoArgs& t,
                             const Sh& sh, i64 g, i64 s) {
    const i64 N = a.N, GH = t.GH;
    i64 cap = KARP_BIG;
    for (i64 h = 0; h < GH; ++h) {
        const i64 o = g * GH + h;
        const i64 c = t.ch[h * N + s];
        const i64 skew = t.hs_skew[o];
        if (skew < KARP_BIG) cap = imin(cap, skew - c);
        if (t.ha_any[o]) {
            const bool occ = c > 0;
            const i64 anti_cap = occ ? 0 : (t.ha_own[o] ? 1 : KARP_BIG);
            const i64 pos_cap = sh.occh[h] ? (occ ? KARP_BIG : 0)
                                           : (t.ha_own[o] ? KARP_BIG : 0);
            cap = imin(cap, t.ha_anti[o] ? anti_cap : pos_cap);
        }
    }
    return clip_big(cap);
}

// cap of a brand-new node under hostname spread / affinity
__device__ i64 host_cap_new(const TopoArgs& t, const Sh& sh, i64 g) {
    const i64 GH = t.GH;
    i64 cap = KARP_BIG;
    for (i64 h = 0; h < GH; ++h) {
        const i64 o = g * GH + h;
        cap = imin(cap, t.hs_skew[o]);
        if (t.ha_any[o]) {
            const i64 per = t.ha_anti[o]
                ? (t.ha_own[o] ? 1 : KARP_BIG)
                : ((sh.occh[h] || !t.ha_own[o]) ? 0 : KARP_BIG);
            cap = imin(cap, per);
        }
    }
    return clip_big(cap);
}

// the periodic-cycle jump (topo_jax.py:341-441), on thread 0: commits k
// whole periods of the ring's tail pattern when that is safe
__device__ bool try_jump(const FfdArgs& a, const TopoArgs& t, const Sh& sh,
                         i64 g) {
    const i64 N = a.N, D = a.D, Z = a.Z, P = a.P, GZ = t.GZ, GH = t.GH;
    const i64 PMAX = t.PMAX, RB = 2 * PMAX;
    const i64* R = a.R + g * D;
    i64* v = sh.v;
    const i64* rb = sh.rb;
    const i64 L = v[V_L];
    i64 p = 0;
    for (i64 q = 1; q <= PMAX && !p; ++q) {
        if (L < 2 * q) continue;
        bool eq = true;
        for (i64 j = 0; j < 4 * q && eq; ++j)
            eq = rb[(RB - 2 * q) * 4 + j] == rb[(RB - q) * 4 + j];
        if (eq) p = q;
    }
    if (!p) return false;
    const i64* pat = rb + (RB - p) * 4;
    i64 d_n = 0;
    for (i64 e = 0; e < p; ++e) {
        if (pat[e * 4 + 3] != kPlace) return false;
        d_n += pat[e * 4 + 2];
    }
    for (i64 z = 0; z < Z; ++z) sh.dzone[z] = 0;
    for (i64 e = 0; e < p; ++e) {
        const i64 zone = pat[e * 4 + 1];
        if (zone >= 0) sh.dzone[zone < Z - 1 ? zone : Z - 1] += pat[e * 4 + 2];
    }
    i64 delta = -1;
    for (i64 z = 0; z < Z; ++z)
        if (sh.dzone[z] > 0) delta = imax(delta, sh.dzone[z]);
    bool uniform = delta > 0, untouched_elig = false;
    for (i64 z = 0; z < Z; ++z) {
        if (sh.dzone[z] > 0 && sh.dzone[z] != delta) uniform = false;
        if (t.min_mask[g * Z + z] && sh.dzone[z] <= 0)
            untouched_elig = true;
    }
    const bool enf = v[V_ENF], elig = v[V_ELIG];
    if (!(d_n > 0 && uniform && !(enf && elig && untouched_elig)
          && !v[V_HAVETO] && !(enf && !elig)))
        return false;
    i64 k = floordiv(v[V_NREM], d_n > 1 ? d_n : 1);
    // re-admission horizon of untouched zones with usable slots
    if (enf) {
        const i64 dl = delta > 1 ? delta : 1;
        for (i64 r = 0; r < GZ; ++r) {
            const i64 skew = t.zs_skew[g * GZ + r];
            if (skew >= KARP_BIG) continue;
            for (i64 z = 0; z < Z; ++z) {
                if (sh.dzone[z] > 0 || !sh.usable[z]) continue;
                k = imin(k, clip_big(floordiv(
                    t.cz[r * Z + z] - skew - sh.mn[r], dl)));
            }
        }
    }
    // per-slot room and hostname-spread bounds over the pattern's slots
    for (i64 q = 0; q < P; ++q) sh.dpool[q] = 0;
    for (i64 e = 0; e < p; ++e) {
        const i64 s = pat[e * 4];
        bool first = true;
        i64 dt = 0;
        for (i64 j = 0; j < p; ++j) {
            if (pat[j * 4] != s) continue;
            if (j < e) first = false;
            dt += pat[j * 4 + 2];
        }
        if (!first) continue;
        k = imin(k, floordiv(t.rem[s], dt));
        for (i64 h = 0; h < GH; ++h) {
            const i64 skew = t.hs_skew[g * GH + h];
            if (skew < KARP_BIG)
                k = imin(k, floordiv(skew - t.ch[h * N + s], dt));
        }
        const int pl = a.pool[s];
        if (pl >= 0) sh.dpool[pl] += dt;
    }
    for (i64 q = 0; q < P; ++q)
        if (sh.dpool[q] > 0) k = imin(k, floordiv(sh.bud[q], sh.dpool[q]));
    if (k < 1) return false;

    // commit k periods
    const i64 mz = v[V_MZ], mh = v[V_MH];
    for (i64 e = 0; e < p; ++e) {
        const i64 s = pat[e * 4];
        const i64 tot = wmul(pat[e * 4 + 2], k);
        t.take[s] += tot;
        t.rem[s] -= tot;
        for (i64 d = 0; d < D; ++d)
            a.used[s * D + d] = wadd(a.used[s * D + d], wmul(tot, R[d]));
        for (i64 h = 0; h < GH; ++h)
            if (t.hs_any[g * GH + h]) t.ch[h * N + s] += tot;
        if (mh >= 0) t.ch[mh * N + s] += tot;
    }
    for (i64 q = 0; q < P; ++q) {
        if (sh.dpool[q] <= 0) continue;
        const i64 pods = wmul(sh.dpool[q], k);
        for (i64 d = 0; d < D; ++d)
            a.pool_used[q * D + d] = wadd(a.pool_used[q * D + d],
                                          wmul(pods, R[d]));
    }
    v[V_NREM] -= wmul(d_n, k);
    for (i64 r = 0; r < GZ; ++r) {
        if (!t.zs_any[g * GZ + r]) continue;
        for (i64 z = 0; z < Z; ++z) t.cz[r * Z + z] += wmul(sh.dzone[z], k);
    }
    if (mz >= 0)
        for (i64 z = 0; z < Z; ++z) t.cz[mz * Z + z] += wmul(sh.dzone[z], k);
    // the host appends the pattern k (k < 3) or 2 more times; the ring's
    // tail is the pattern either way, so only the event count moves
    v[V_L] = L + p * (k < 2 ? k : 2);
    log_event(t, sh, g, 0, -1, p, kCyc, k, false);
    return true;
}

// the min-(score, index) admissible zone among the evaluated slot's zone
// candidates (zflag); -1 when there is none
__device__ i64 choose_slot_zone(const FfdArgs& a, const Sh& sh, i64 g,
                                i64 slot) {
    const i64 Z = a.Z;
    i64 best = -1, bestkey = KARP_BIG;
    for (i64 z = 0; z < Z; ++z) {
        if (!(sh.zflag[z] && a.zones[slot * Z + z] && a.agz[g * Z + z]
              && sh.zok[z]))
            continue;
        const i64 key = sh.score[z] * Z + z;
        if (key < bestkey) {
            bestkey = key;
            best = z;
        }
    }
    return best;
}

// open a new node (topo_jax.py:558-612) and, for the cap-1 anti ladder,
// commit the whole one-pod-per-node run (:614-653); on thread 0. The
// cand rows of the new slots are written by the block afterwards.
__device__ void open_new(const FfdArgs& a, const TopoArgs& t, const Sh& sh,
                         i64 g) {
    const i64 N = a.N, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const i64* R = a.R + g * D;
    i64* v = sh.v;
    const bool need_zone = v[V_NEEDZONE];
    const i64 hcap_new = host_cap_new(t, sh, g);
    const i64 nn = v[V_NN];
    i64 pi = -1, zsel = 0;
    for (i64 q = 0; q < P && pi < 0; ++q) {
        i64 best = 0, bestkey = KARP_BIG;
        bool zvalid = false;
        for (i64 z = 0; z < Z; ++z) {
            if (!(t.zcand_pz[q * Z + z] && sh.zok[z])) continue;
            zvalid = true;
            const i64 key = sh.score[z] * Z + z;
            if (key < bestkey) {
                bestkey = key;
                best = z;
            }
        }
        const i64 cap = need_zone ? t.cap_pz[q * Z + best] : t.cap_any[q];
        if (t.open_ok0[q] && sh.bud[q] >= 1 && N - nn > 0 && cap >= 1
            && hcap_new >= 1 && (!need_zone || zvalid)) {
            pi = q;
            zsel = best;
        }
    }
    if (pi < 0) {
        v[V_STUCK] = 1;
        return;
    }
    const i64 zi = need_zone ? zsel : -1;
    const i64 zc = zi < 0 ? 0 : zi;
    const i64 slot = nn;
    const i64 capn = need_zone ? t.cap_pz[pi * Z + zc] : t.cap_any[pi];
    const i64 roomz = (need_zone && v[V_NEEDZ])
        ? zone_run_room(a, t, sh, g, zc) : KARP_BIG;
    const i64 run = imax(imin(imin(capn, hcap_new),
                              imin(sh.bud[pi], imin(v[V_NREM], roomz))), 1);
    v[V_NN] = nn + 1;
    a.alive[slot] = 1;
    a.pool[slot] = (int)pi;
    for (i64 z = 0; z < Z; ++z)
        a.zones[slot * Z + z] = need_zone
            ? (z == zi) : (a.agz[g * Z + z] && a.pool_agz[pi * Z + z]);
    for (i64 c = 0; c < C; ++c)
        a.ct[slot * C + c] = a.agc[g * C + c] && a.pool_agc[pi * C + c];
    for (i64 d = 0; d < D; ++d)
        a.used[slot * D + d] = a.daemon[(g * P + pi) * D + d];
    t.zfix[slot] = need_zone ? (int)zi : -1;
    t.rem[slot] = capn;
    commit(a, t, sh, g, slot, zi, run, kOpen);
    i64 m = 0;
    const i64 s0 = v[V_NN];
    if (run == 1 && hcap_new == 1 && zi < 0 && v[V_ANTIB] && v[V_NREM] > 0) {
        const i64 b = pool_budget(a.pool_limit + pi * D,
                                  a.pool_used + pi * D, R, D);
        m = imin(v[V_NREM], imin(b, N - s0));
        for (i64 d = 0; d < D; ++d)
            a.pool_used[pi * D + d] = wadd(a.pool_used[pi * D + d],
                                           wmul(m, R[d]));
        v[V_NREM] -= m;
        v[V_NN] = s0 + m;
        v[V_L] += m;
        // distinct fresh slots never form a periodic pattern
        for (i64 j = 0; j < 2 * t.PMAX * 4; ++j) sh.rb[j] = kRbInvalid;
        log_event(t, sh, g, s0, -1, m, kAntiRun, 0, false);
    }
    v[V_PI] = pi;
    v[V_ZC] = zc;
    v[V_SLOT] = slot;
    v[V_M] = m;
    v[V_S0] = s0;
}

__global__ void __launch_bounds__(kPourThreads)
topo_pour_kernel(FfdArgs a, TopoArgs t, i64 g) {
    extern __shared__ i64 dyn[];
    __shared__ i64 red[33];
    __shared__ int first_ok;
    const i64 N = a.N, T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const i64 GZ = t.GZ, GH = t.GH, EVCAP = t.EVCAP, RB = 2 * t.PMAX;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
    const i64* R = a.R + g * D;
    Sh sh;
    sh.rb = dyn;
    sh.mn = sh.rb + RB * 4;
    sh.occz = sh.mn + GZ;
    sh.occh = sh.occz + GZ;
    sh.zok = sh.occh + GH;
    sh.score = sh.zok + Z;
    sh.zflag = sh.score + Z;
    sh.usable = sh.zflag + Z;
    sh.dzone = sh.usable + Z;
    sh.bud = sh.dzone + Z;
    sh.dpool = sh.bud + P;
    sh.v = sh.dpool + P;
    i64* v = sh.v;

    // ---- group entry: scratch, the group's log row, the ring ------------
    for (i64 s = tid; s < N; s += nth) t.take[s] = 0;
    for (i64 i = tid; i < EVCAP; i += nth) {
        const i64 o = g * EVCAP + i;
        t.ev_slot[o] = 0;
        t.ev_zone[o] = -1;
        t.ev_len[o] = 0;
        t.ev_kind[o] = -1;
        t.ev_aux[o] = 0;
    }
    for (i64 i = tid; i < RB * 4; i += nth) sh.rb[i] = kRbInvalid;
    if (tid == 0) {
        bool enf = false, zaa = false, elig = false, veto = false;
        for (i64 r = 0; r < GZ; ++r) {
            enf |= t.zs_skew[g * GZ + r] < KARP_BIG;
            zaa |= t.za_any[g * GZ + r];
        }
        for (i64 z = 0; z < Z; ++z) elig |= t.min_mask[g * Z + z];
        for (i64 h = 0; h < GH; ++h) {
            const i64 o = g * GH + h;
            veto |= t.ha_any[o] && t.ha_anti[o] && t.ha_own[o];
        }
        v[V_NREM] = a.n[g];
        v[V_L] = 0;
        v[V_EVN] = 0;
        v[V_BAIL] = 0;
        v[V_STUCK] = 0;
        v[V_NN] = a.num_nodes[0];
        v[V_ENF] = enf;
        v[V_ELIG] = elig;
        v[V_NEEDZ] = enf || zaa;
        v[V_NEEDZONE] = t.zone_needed[g];
        v[V_HAVETO] = veto;
        v[V_ANTIB] = t.anti_bulk[0];
        v[V_MZ] = t.member_z[g];
        v[V_MH] = t.member_h[g];
    }
    __syncthreads();
    const bool needz = v[V_NEEDZ], need_zone = v[V_NEEDZONE];
    const bool elig = v[V_ELIG];
    const i64 mh = v[V_MH];

    for (;;) {
        if (tid == 0) v[V_CONT] = v[V_NREM] > 0 && !v[V_STUCK] && !v[V_BAIL];
        __syncthreads();
        if (!v[V_CONT]) break;

        // ---- per-event reductions ----------------------------------------
        for (i64 r = tid; r < GZ; r += nth) {
            i64 m = KARP_BIG;
            bool occ = false;
            for (i64 z = 0; z < Z; ++z) {
                const i64 c = t.cz[r * Z + z];
                if (t.min_mask[g * Z + z]) m = imin(m, c);
                occ |= c > 0;
            }
            sh.mn[r] = elig ? m : 0;
            sh.occz[r] = occ;
        }
        for (i64 z = tid; z < Z; z += nth) sh.usable[z] = 0;
        for (i64 q = tid; q < P; q += nth)
            sh.bud[q] = pool_budget(a.pool_limit + q * D,
                                    a.pool_used + q * D, R, D);
        for (i64 h = warp; h < GH; h += nwarps) {
            bool any = false;
            for (i64 s = lane; s < N; s += 32) any |= t.ch[h * N + s] > 0;
            any = __any_sync(0xffffffffu, any);
            if (lane == 0) sh.occh[h] = any;
        }
        __syncthreads();
        for (i64 s = tid; s < N; s += nth) {
            const int zf = t.zfix[s];
            if (zf >= 0 && t.rem[s] > 0)
                atomicOr((unsigned long long*)&sh.usable[zf], 1ull);
        }
        for (i64 z = tid; z < Z; z += nth) {
            bool ok = true;
            i64 score = 0;
            for (i64 r = 0; r < GZ; ++r) {
                const i64 o = g * GZ + r;
                const i64 c = t.cz[r * Z + z];
                const i64 skew = t.zs_skew[o];
                if (c + 1 - sh.mn[r] > skew) ok = false;
                if (skew < KARP_BIG) score += c;
                if (t.za_any[o]) {
                    const bool occ = c > 0;
                    const bool aff = t.za_anti[o] ? !occ
                        : (sh.occz[r] ? occ : (bool)t.za_own[o]);
                    if (!aff) ok = false;
                }
            }
            sh.zok[z] = ok;
            sh.score[z] = score;
        }
        __syncthreads();

        // ---- the periodic-cycle jump --------------------------------------
        if (tid == 0) v[V_JUMP] = try_jump(a, t, sh, g);
        __syncthreads();
        if (v[V_JUMP]) continue;

        // ---- admissible slots (topo_jax.py:451-469) ------------------------
        for (i64 s = tid; s < N; s += nth) {
            bool o = t.rem[s] > 0;
            for (i64 h = 0; h < GH && o; ++h) {
                const i64 oo = g * GH + h;
                const i64 c = t.ch[h * N + s];
                if (!(c < t.hs_skew[oo])) o = false;
                if (t.ha_any[oo]) {
                    const bool occ = c > 0;
                    const bool hok = t.ha_anti[oo] ? !occ
                        : (sh.occh[h] ? occ : (bool)t.ha_own[oo]);
                    if (!hok) o = false;
                }
            }
            const int pl = a.pool[s];
            o = o && pl >= 0 && sh.bud[pl < P - 1 ? pl : P - 1] > 0;
            const int zf = t.zfix[s];
            if (needz && zf >= 0) o = o && sh.zok[zf];
            t.ok[s] = o;
        }
        __syncthreads();

        // ---- the first slot whose run is viable (:476-542) -----------------
        bool found = false;
        for (;;) {
            if (tid == 0) first_ok = (int)N;
            __syncthreads();
            for (i64 s = tid; s < N; s += nth)
                if (t.ok[s]) atomicMin(&first_ok, (int)s);
            __syncthreads();
            const i64 slot = first_ok;
            if (slot >= N) break;
            if (tid == 0) {
                const i64 zi_d = t.zfix[slot];
                const i64 hcap = host_cap_slot(a, t, sh, g, slot);
                const int pl = a.pool[slot];
                const i64 budget = sh.bud[pl < 0 ? 0 : pl];
                const bool und = zi_d < 0 && needz;
                v[V_UND] = und;
                v[V_HCAP] = hcap;
                v[V_BUDGET] = budget;
                v[V_FOUND] = 0;
                for (i64 z = 0; z < Z; ++z) sh.zflag[z] = 0;
                if (!und) {
                    const i64 roomz = (needz && zi_d >= 0)
                        ? zone_run_room(a, t, sh, g, zi_d) : KARP_BIG;
                    const i64 run = imin(imin(t.rem[slot], hcap),
                                         imin(budget, imin(v[V_NREM], roomz)));
                    if (run >= 1) {
                        v[V_FOUND] = 1;
                        v[V_SLOT] = slot;
                        v[V_ZI] = zi_d;
                        v[V_RUN] = run;
                        v[V_FIX] = 0;
                    } else {
                        t.ok[slot] = 0;
                    }
                }
            }
            __syncthreads();
            if (v[V_UND]) {
                // the slot's one-more-pod fit types and their zones
                for (i64 tt = tid; tt < T; tt += nth) {
                    if (!a.cand[slot * T + tt]) continue;
                    bool fit = true;
                    for (i64 d = 0; d < D && fit; ++d)
                        fit = wadd(a.used[slot * D + d], R[d])
                            <= a.A[tt * D + d];
                    if (!fit) continue;
                    for (i64 z = 0; z < Z; ++z)
                        if (!sh.zflag[z] && avail_any_ct(a, tt, z))
                            atomicOr((unsigned long long*)&sh.zflag[z], 1ull);
                }
                __syncthreads();
                if (tid == 0) v[V_ZI] = choose_slot_zone(a, sh, g, slot);
                __syncthreads();
                const i64 zi = v[V_ZI];
                if (zi >= 0) {
                    // the types that keep an offering in zone zi, and the
                    // slot's room over them
                    i64 lm = 0;
                    for (i64 tt = tid; tt < T; tt += nth) {
                        bool kp = false;
                        if (a.cand[slot * T + tt]) {
                            for (i64 c = 0; c < C && !kp; ++c)
                                kp = a.avail_zc[tt * Z * C + zi * C + c]
                                    && a.ct[slot * C + c] && a.agc[g * C + c];
                        }
                        t.keep[tt] = kp;
                        if (kp) lm = imax(lm, headroom(a.A + tt * D,
                                                       a.used + slot * D, R, D));
                    }
                    const i64 m = block_max(lm, red);
                    if (tid == 0) {
                        const i64 remnew = clip_big(m - t.take[slot]);
                        const i64 run = imin(
                            imin(remnew, v[V_HCAP]),
                            imin(v[V_BUDGET],
                                 imin(v[V_NREM],
                                      zone_run_room(a, t, sh, g, zi))));
                        if (run >= 1) {
                            v[V_FOUND] = 1;
                            v[V_SLOT] = slot;
                            v[V_RUN] = run;
                            v[V_FIX] = 1;
                            v[V_REMNEW] = remnew;
                        } else {
                            t.ok[slot] = 0;
                        }
                    }
                } else if (tid == 0) {
                    t.ok[slot] = 0;
                }
                __syncthreads();
            }
            if (v[V_FOUND]) {
                found = true;
                break;
            }
        }

        if (found) {
            // commit on the chosen slot, fixing its zone first (:544-555)
            const i64 slot = v[V_SLOT];
            const bool fix = v[V_FIX];
            if (fix)
                for (i64 tt = tid; tt < T; tt += nth)
                    a.cand[slot * T + tt] = t.keep[tt];
            if (tid == 0) {
                const i64 zi = v[V_ZI];
                if (fix) {
                    t.zfix[slot] = (int)zi;
                    for (i64 z = 0; z < Z; ++z) a.zones[slot * Z + z] = z == zi;
                    t.rem[slot] = v[V_REMNEW];
                }
                commit(a, t, sh, g, slot, zi, v[V_RUN], fix ? kFix : kPlace);
            }
            __syncthreads();
            continue;
        }

        // ---- a new node ----------------------------------------------------
        if (tid == 0) open_new(a, t, sh, g);
        __syncthreads();
        if (!v[V_STUCK]) {
            const i64 pi = v[V_PI], zc = v[V_ZC], slot = v[V_SLOT];
            const i64 m = v[V_M], s0 = v[V_S0];
            for (i64 tt = tid; tt < T; tt += nth) {
                const bool kp = t.cand_new[pi * T + tt]
                    && (!need_zone || t.availz_p[(pi * T + tt) * Z + zc]);
                a.cand[slot * T + tt] = kp;
                for (i64 j = 0; j < m; ++j) a.cand[(s0 + j) * T + tt] = kp;
            }
            for (i64 j = tid; j < m; j += nth) {
                const i64 s = s0 + j;
                a.alive[s] = 1;
                a.pool[s] = (int)pi;
                for (i64 z = 0; z < Z; ++z)
                    a.zones[s * Z + z] = a.agz[g * Z + z]
                        && a.pool_agz[pi * Z + z];
                for (i64 c = 0; c < C; ++c)
                    a.ct[s * C + c] = a.agc[g * C + c] && a.pool_agc[pi * C + c];
                for (i64 d = 0; d < D; ++d)
                    a.used[s * D + d] = wadd(a.daemon[(g * P + pi) * D + d],
                                             R[d]);
                t.rem[s] = 0;
                t.take[s] = 1;
                if (mh >= 0) t.ch[mh * N + s] += 1;
            }
        }
        __syncthreads();
    }

    // ---- group-end narrowing of the touched slots (:671-683) ---------------
    for (i64 s = 0; s < N; ++s) {            // uniform branch per slot
        if (!(t.take[s] > 0 && a.pool[s] >= 0)) continue;
        const i64* us = a.used + s * D;
        for (i64 tt = tid; tt < T; tt += nth) {
            bool fit = true;
            for (i64 d = 0; d < D; ++d) fit &= us[d] <= a.A[tt * D + d];
            a.types[s * T + tt] = a.cand[s * T + tt] && fit;
        }
    }
    for (i64 s = tid; s < N; s += nth) {
        if (t.take[s] > 0 && a.pool[s] >= 0) {
            if (t.zfix[s] < 0)
                for (i64 z = 0; z < Z; ++z) a.zones[s * Z + z] &= a.agz[g * Z + z];
            for (i64 c = 0; c < C; ++c) a.ct[s * C + c] &= a.agc[g * C + c];
        }
        a.takes[(g - a.G0) * N + s] = (int)t.take[s];
    }
    if (tid == 0) {
        a.leftover[g - a.G0] = v[V_NREM];
        t.ev_n[g] = imin(v[V_EVN], EVCAP);
        t.bail[g] = v[V_BAIL] != 0;
        a.num_nodes[0] = (int)v[V_NN];
    }
}

// ---------------------------------------------------------------------------
// topo_record_plain
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRecordThreads)
topo_record_plain_kernel(FfdArgs a, TopoArgs t, i64 g) {
    extern __shared__ i64 dyn[];     // dz [Z]
    i64* dz = dyn;
    const i64 N = a.N, Z = a.Z;
    const int tid = threadIdx.x;
    const i64 mz = t.member_z[g], mh = t.member_h[g];
    for (i64 z = tid; z < Z; z += blockDim.x) dz[z] = 0;
    __syncthreads();
    for (i64 s = tid; s < N; s += blockDim.x) {
        const i64 take = a.takes[(g - a.G0) * N + s];
        if (mh >= 0) t.ch[mh * N + s] = wadd(t.ch[mh * N + s], take);
        const int zf = t.zfix[s];
        if (zf >= 0 && take > 0)
            atomicAdd((unsigned long long*)&dz[zf], (unsigned long long)take);
    }
    __syncthreads();
    if (mz >= 0)
        for (i64 z = tid; z < Z; z += blockDim.x)
            t.cz[mz * Z + z] = wadd(t.cz[mz * Z + z], dz[z]);
}

int set_smem(const void* fn, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

int karp_topo_group_start(const FfdArgs* a, const TopoArgs* t, long long g,
                          void* stream) {
    topo_group_start_kernel<<<(unsigned)(a->N + a->P), kStartThreads, 0,
                              (cudaStream_t)stream>>>(*a, *t, g);
    return (int)cudaGetLastError();
}

int karp_topo_pour(const FfdArgs* a, const TopoArgs* t, long long g,
                   void* stream) {
    const size_t smem = (size_t)(2 * t->PMAX * 4 + 2 * t->GZ + t->GH
                                 + 5 * a->Z + 2 * a->P + V_COUNT)
        * sizeof(i64);
    int err = set_smem((const void*)topo_pour_kernel, smem);
    if (err) return err;
    topo_pour_kernel<<<1, kPourThreads, smem, (cudaStream_t)stream>>>(
        *a, *t, g);
    return (int)cudaGetLastError();
}

int karp_topo_record_plain(const FfdArgs* a, const TopoArgs* t, long long g,
                           void* stream) {
    topo_record_plain_kernel<<<1, kRecordThreads, a->Z * sizeof(i64),
                               (cudaStream_t)stream>>>(*a, *t, g);
    return (int)cudaGetLastError();
}

}  // extern "C"
