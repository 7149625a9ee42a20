// K9, the topology group scan: the three kernels of a topology scan.
//
// Replaces karpenter_provider_aws_tpu/ops/topo_jax.py:solve_scan_topo
// (dispatched by :730 dispatch_topo): a lax.scan over pod groups whose
// topology groups run the pour's event loop in a lax.while_loop. Groups
// without topology run the K2 kernels (ffd_scan.cu), whose commit also
// records their membership (topo_jax.py:685-702: ch[member_h, :] +=
// take, cz[member_z, zfix[s]] += take[s] where zfix[s] >= 0 and take[s]
// > 0; RecordArgs, ffd_common.cuh, which points at this scan's counters);
// a topology group runs topo_group_start and then
// topo_pour, after the launch of topo_pool_statics for its chunk of
// topology groups (one a chunk, before the chunk's first group). The
// group kernels read and update one carry in device memory
// (FfdArgs: used/types/zones/ct/pool/alive/num_nodes/pool_used) plus the
// topology counters (TopoArgs: cz [GZ, Z], ch [GH, N], zfix [N]); the host
// enqueues the launches of a whole scan with no synchronisation between
// them.
//
// topo_pool_statics (topo_jax.py:292-315): the carry-free half of a
//   topology group's start, the per-pool statics of opening a node
//   (cand_new, hr_new over the pool's daemon row, availz_p, cap_pz,
//   cap_any, zcand_pz, open_ok0) and the group's cap-1 anti-ladder gate
//   (anti_bulk). They read only the group's rows and the static arena, so
//   one launch before a chunk's first group computes them for up to CH
//   topology groups at once (one block of 512 threads a (group, pool),
//   table row j of the chunk = the group's rank among the scan's topology
//   groups mod CH; a type's loads issued at once, its quotients by
//   floordiv_fp); the chunk's first launch also packs each type's
//   offerings into one Z*C-bit word (offw [T], bit z*C + c) when Z*C <=
//   64. The pour reads its group's row (srow [G]). Off the group chain;
//   bound: bytes (a chunk writes P*T*(9 + Z) bytes a group).
//
// topo_group_start (topo_jax.py:281-291): N blocks of 512 threads, block
//   s slot row s: the candidate mask cand[s, :] (a boolean any-reduction
//   over zone x capacity-type offerings, never an integer matmul) and the
//   room rem[s] = max over candidates of the headroom. A slot that is
//   free, existing or of a pool the group does not admit stores its zero
//   row with 16-byte stores and rem 0. In an open slot's block warp 0
//   folds (zones & agz) x (ct & agc) into one Z*C-bit word by two ballots
//   (each lane's four loads at once) and warp 1 stages the used row, R
//   and 1 / R in shared memory; after the one barrier a thread takes two
//   types (the row's type before its first 2-byte boundary and the one
//   after its last pair apart): their types and F bytes and offering
//   words, each type's offering test one AND of its word (offw) with the
//   slot's, a candidate's headroom by fp64 reciprocal quotients with one
//   int64 correction each way (floordiv_rcp, exact) over its allocatable
//   row; a pair at a 4-byte boundary stores the next lane's pair with its
//   own as one 4-byte word. A warp-shuffle max and one barrier give rem.
//   Z*C past 64 keeps offering_ok's loop, D past 8 the global rows.
//   Measured against other shapes in one call (PERF.md): four types a
//   thread, a tile of the rows staged in shared memory a type a thread,
//   eight lanes a type, two slots a block, all four types' rows loaded at
//   once were each slower; the candidates' rows, read a candidate after
//   another, pace the block. Bound: bytes (N*T + 8 N written); it costs
//   its launch latency and its rounds of loads.
//
// topo_pour (topo_jax.py:335-683): ONE block of 512 threads for the
//   group, which loops over its events until no pod is left, the group is
//   stuck or the event log overflows (bail). Bound: latency, not bytes or
//   operations (config 3: 284 events over 21 groups, a few KB each). The
//   design keeps an event's dependent steps in shared memory and its
//   serial decisions on warp 0 (512 threads keep the kernel unspilled):
//   - entry: the zone and hostname counter rows the group reads or writes
//     (an enforced skew, an affinity term, a spread record, the
//     membership row) are listed in ascending order with their flags,
//     skews and record counts; every walk loops over the list (one row at
//     config 3), not the GZ / GH padded rows. A row off the list has skew
//     BIG and no term, and its counts stay below BIG, so it changes no
//     sum, min or any. The listed rows, their flags, skews and zone
//     counters (written back at the end), the pool usage and budgets, the
//     ring and the scalars live in shared memory, sized at launch by the
//     most rows a topology group lists (`NZ`, `NH`, counted by the host),
//     never by the padded axes. The per-slot state (rem, take, zfix, pool,
//     the undecided words, the listed hostname rows' counters, read in
//     place through the row list) stays in the global scratch: a shared
//     copy of it timed the same at config 3 (PERF.md). The hostname
//     occupancy is computed once (commits only add) and set on commit;
//     only a pool with a limit on a requested resource moves its usage and
//     budget on commit (the others add their takes at the end); the usable
//     zones (a slot pinned there with room) are a count kept on every
//     change of room or pin.
//   - an event starts on warp 0 (lanes over zones): min counts,
//     occupancy, zone admissibility, score and the run room of every zone;
//     the jump: the lanes test 32 periods of the circular ring at once
//     (its newest entry against the one a period back), compare the
//     candidates' entries, and take the pattern's entries, zones and
//     pools to bound and commit k periods, which ends the event;
//   - else ONE pass over the slots (a thread a slot): the admissibility
//     and, for a zone-decided slot, its run min(rem, host cap, budget,
//     n_rem, zone room); a block min gives the first viable decided slot,
//     ballots the undecided admissible slots as bits. The undecided slots
//     below it, in order, each run the zone-choice pass over T (its fit
//     types' zones and, per choosable zone, the best headroom of the types
//     that keep an offering there, in one pass); the first that yields a
//     run wins, else the decided slot (thread 0 commits), else a new node
//     (warp 0: lanes over pools) and the cap-1 anti ladder's bulk commit,
//     its rows written by the block. A place event costs two block
//     barriers.
//   - commits move rem, take and the counters; a slot's used row moves at
//     the group's end by its take (used + take R, the same wrapped sum):
//     the zone-choice pass reads used + take R.
//   - group end: an anti ladder's run narrows as one row (its slots share
//     their candidates and used row, and no later event touches them),
//     stored down the run; the other touched slots are compacted into a
//     list and narrowed 16 at a time (their final used rows staged in
//     shared memory, a thread a type, cand loaded before types stored).
//   The layout: 8 (V_COUNT + 8 PMAX + 17 D + 4 Z + 5 P + 2 P D + 2) + 7 Z
//   + C + P bytes, plus NZ (26 + 8 Z) + 18 NH for the listed rows (config
//   3: NZ = NH = 1, about 2.3 KB), whatever N, GZ and GH are. It passes
//   the card's 227 KB only where one group lists thousands of rows (at Z
//   = 4, D = 8, P = 1: about 3,800 zone rows, or 12,000 hostname rows);
//   the entry then returns kLayoutTooLarge, as it does for Z > 64 (zone
//   bit masks), and the wrapper raises TopoLayoutError.
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
    unsigned* und;          // [2, ceil(N / 32)] the pour's undecided words
    // the pool statics of a chunk of CH topology groups (topo_pool_statics
    // -> topo_pour), table row j the group of rank r0 + j
    u8* cand_new;           // [CH, P, T]
    i64* hr_new;            // [CH, P, T]
    u8* open_ok0;           // [CH, P]
    u8* availz_p;           // [CH, P, T, Z]
    i64* cap_pz;            // [CH, P, Z]
    i64* cap_any;           // [CH, P]
    u8* zcand_pz;           // [CH, P, Z]
    u8* anti_bulk;          // [CH]
    // outputs
    i64* ev_slot;           // [G, EVCAP]
    i64* ev_zone;
    i64* ev_len;
    i64* ev_kind;
    i64* ev_aux;
    i64* ev_n;              // [G]
    u8* bail;               // [G]
    // a topology group's table row (its rank mod CH; -1 for the others),
    // the group of each rank, and the types' offering words (Z*C <= 64)
    const int* srow;        // [G]
    const int* tgid;        // [n_topo]
    u64* offw;              // [T]
    // statics; NZ / NH: the most zone / hostname counter rows a topology
    // group lists (the pour's shared memory holds that many listed rows);
    // CH: the table rows of a chunk
    i64 GZ, GH, EVCAP, PMAX, NZ, NH, CH;
};

namespace {

constexpr int kStaticsThreads = 512;
// topo_group_start's block (two types a thread: 1,024 types a pass)
constexpr int kStartThreads = 512;
constexpr int kPourThreads = 512;
// the pour's rows of D held in registers (D beyond is read in place), and
// the touched slots its narrowing stages at a time
constexpr int kRegD = 8;
constexpr int kNarrowRows = 16;
// the pour's static shared memory (its search words and counters) and the
// code its entry returns when its layout exceeds the card's shared memory
constexpr int kPourStaticSmem = 64;
constexpr int kLayoutTooLarge = -1;

constexpr i64 kPlace = 0, kFix = 1, kOpen = 2, kCyc = 3, kAntiRun = 4;
constexpr i64 kRbInvalid = -9;

__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }
__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }
// floor(a / b) for b > 0 with one 64-bit division (floordiv's quotient
// and remainder are two)
__device__ __forceinline__ i64 floordiv1(i64 a, i64 b) {
    const i64 q = a / b;
    return (a < 0 && q * b != a) ? q - 1 : q;
}
__device__ __forceinline__ i64 clip_big(i64 x) {
    return x < 0 ? 0 : (x > KARP_BIG ? KARP_BIG : x);
}

// ---------------------------------------------------------------------------
// topo_pool_statics
// ---------------------------------------------------------------------------

// Block j * P + p < nr * P: pool p's statics for the chunk's table row j
// (the topology group of rank r0 + j); the blocks after them, on the
// chunk at rank 0 with Z*C <= kOfferBits, pack a type's offerings a
// thread. Dynamic shared memory: the zone maxima [Z] (u64), R [D], the
// daemon row [D], the zone flags [Z] (u32), the zones [Z] and capacity
// types [C] the group and the pool both take (bytes).
__global__ void __launch_bounds__(kStaticsThreads)
topo_pool_statics_kernel(const __grid_constant__ FfdArgs a,
                         const __grid_constant__ TopoArgs t, i64 r0,
                         i64 nr) {
    extern __shared__ unsigned long long sdyn[];
    __shared__ i64 red[kStaticsThreads / 32];
    const i64 T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const int tid = threadIdx.x, nth = blockDim.x;
    const i64 nb = nr * P;
    if ((i64)blockIdx.x >= nb) {
        const i64 tt = ((i64)blockIdx.x - nb) * nth + tid;
        if (tt < T) {
            t.offw[tt] = offer_word(a.avail_zc + tt * Z * C, Z * C);
        }
        return;
    }
    const i64 j = (i64)blockIdx.x / P, p = (i64)blockIdx.x - j * P;
    const i64 g = t.tgid[r0 + j];
    const i64 row = j * P + p;      // the (group, pool) row of the tables
    unsigned long long* scap = sdyn;
    i64* sR = reinterpret_cast<i64*>(sdyn + Z);
    i64* sdm = sR + D;
    unsigned* szc = reinterpret_cast<unsigned*>(sdm + D);
    u8* sgz = reinterpret_cast<u8*>(szc + Z);
    u8* sgc = sgz + Z;
    for (i64 z = tid; z < Z; z += nth) {
        scap[z] = 0;
        szc[z] = 0;
        sgz[z] = a.agz[g * Z + z] && a.pool_agz[p * Z + z];
    }
    for (i64 c = tid; c < C; c += nth)
        sgc[c] = a.agc[g * C + c] && a.pool_agc[p * C + c];
    for (i64 d = tid; d < D; d += nth) {
        sR[d] = a.R[g * D + d];
        sdm[d] = a.daemon[(g * P + p) * D + d];
    }
    __syncthreads();
    const bool staged = D <= kHeadDims;
    i64 cmax = 0;
    for (i64 tt = tid; tt < T; tt += nth) {
        // the type's loads at once: its F and pool bytes, its allocatable
        // row, its offerings (each zone's capacity types the group and the
        // pool both take, by bitwise ORs: no branch between the loads)
        const u8* av = a.avail_zc + tt * Z * C;
        u8* az = t.availz_p + (row * T + tt) * Z;
        const unsigned fp = ld_pin_u8(a.F + g * T + tt)
            & ld_pin_u8(a.pool_types + p * T + tt);
        i64 ar[kHeadDims];
#pragma unroll
        for (int d = 0; d < kHeadDims; ++d)
            ar[d] = staged && d < D ? ld_pin_i64(a.A + tt * D + d) : 0;
        unsigned off = 0;
        for (i64 z = 0; z < Z; ++z) {
            unsigned azz = 0;
            for (i64 c = 0; c < C; ++c)
                azz |= (ld_pin_u8(av + z * C + c) != 0) & sgc[c];
            az[z] = (u8)azz;
            off |= azz & sgz[z];
        }
        const bool cn = fp && off;
        const i64 hr = staged ? head_staged(ar, sdm, sR, D)
                              : headroom(a.A + tt * D, sdm, sR, D);
        t.cand_new[row * T + tt] = cn;
        t.hr_new[row * T + tt] = hr;
        if (!cn) continue;
        cmax = imax(cmax, hr);
        for (i64 z = 0; z < Z; ++z) {
            unsigned any = 0, azz = 0;
            for (i64 c = 0; c < C; ++c) {
                const unsigned v = ld_pin_u8(av + z * C + c) != 0;
                any |= v;
                azz |= v & sgc[c];
            }
            // hr is clipped to [0, BIG]: its unsigned max is its max
            if (azz) atomicMax(&scap[z], (unsigned long long)hr);
            if (any && hr >= 1) szc[z] = 1;
        }
    }
    for (int o = 16; o > 0; o >>= 1)
        cmax = imax(cmax, __shfl_xor_sync(~0u, cmax, o));
    if ((tid & 31) == 0) red[tid >> 5] = cmax;
    // the group's cap-1 hostname-anti ladder gate, on its pool-0 block: no
    // zone spread, no zone affinity, no hostname spread, every hostname
    // term a self anti-affinity, at least one
    bool ok = true, any_ha = false;
    if (p == 0) {
        const i64 GZ = t.GZ, GH = t.GH;
        for (i64 r = tid; r < GZ; r += nth)
            ok &= !t.zs_any[g * GZ + r] && !t.za_any[g * GZ + r];
        for (i64 h = tid; h < GH; h += nth) {
            const i64 o = g * GH + h;
            ok &= !t.hs_any[o];
            if (t.ha_any[o]) {
                any_ha = true;
                ok &= t.ha_anti[o] && t.ha_own[o];
            }
        }
    }
    ok = __syncthreads_and(ok);     // and the barrier of red, scap, szc
    any_ha = __syncthreads_or(any_ha);
    for (i64 z = tid; z < Z; z += nth) {
        t.cap_pz[row * Z + z] = (i64)scap[z];
        t.zcand_pz[row * Z + z] = szc[z] && sgz[z];
    }
    if (tid == 0) {
        i64 cap = 0;
        for (int w = 0; w < nth / 32; ++w) cap = imax(cap, red[w]);
        bool az = false, ac = false;
        for (i64 z = 0; z < Z; ++z) az |= sgz[z] != 0;
        for (i64 c = 0; c < C; ++c) ac |= sgc[c] != 0;
        t.cap_any[row] = cap;
        t.open_ok0[row] = a.admit[g * P + p] && az && ac && cap >= 1;
        if (p == 0) t.anti_bulk[j] = ok && any_ha;
    }
}

// ---------------------------------------------------------------------------
// topo_group_start
// ---------------------------------------------------------------------------

// Zeroes the n bytes at p on the block: single bytes up to the first
// 16-byte boundary, 16-byte stores over the middle, single bytes after
// it (a candidate row of T = 812 starts at every 4-byte offset mod 16 as
// s moves).
__device__ __forceinline__ void zero_bytes_block(u8* p, i64 n) {
    const int tid = threadIdx.x;
    i64 head = (i64)((16 - ((size_t)p & 15)) & 15);
    head = head < n ? head : n;
    const i64 nv = (n - head) >> 4;
    if (tid < head) p[tid] = 0;
    uint4* v = reinterpret_cast<uint4*>(p + head);
    for (i64 i = tid; i < nv; i += blockDim.x)
        v[i] = make_uint4(0u, 0u, 0u, 0u);
    const i64 t0 = head + (nv << 4);
    if (t0 + tid < n) p[t0 + tid] = 0;
}

__global__ void __launch_bounds__(kStartThreads)
topo_group_start_kernel(const __grid_constant__ FfdArgs a,
                        const __grid_constant__ TopoArgs t, i64 g) {
    __shared__ u64 s_zm;            // the slot's admitted pairs, bit z*C + c
    __shared__ i64 su[kHeadDims], sr[kHeadDims];
    __shared__ double srb[kHeadDims];
    __shared__ i64 red[kStartThreads / 32];
    const i64 T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const i64 s = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    u8* crow = a.cand + s * T;
    const int pool = a.pool[s];
    const i64 pc = pool < 0 ? 0 : (pool > P - 1 ? P - 1 : pool);
    if (!(pool >= 0 && a.admit[g * P + pc])) {   // uniform over the block
        zero_bytes_block(crow, T);
        if (tid == 0) t.rem[s] = 0;
        return;
    }
    const i64 ZC = Z * C;
    const bool bits = ZC <= kOfferBits;
    const bool staged = D <= kHeadDims;
    if (warp == 0 && bits) {        // lanes over the pairs, two ballots
        u64 m = 0;
        for (int h = 0; h < 2; ++h) {
            const int i = lane + 32 * h;
            bool on = false;
            if (i < ZC) {           // the four loads at once
                const int z = i / (int)C, c = i - z * (int)C;
                on = (a.zones[s * Z + z] & a.agz[g * Z + z]
                      & a.ct[s * C + c] & a.agc[g * C + c]) != 0;
            }
            m |= (u64)__ballot_sync(~0u, on) << (32 * h);
        }
        if (lane == 0) s_zm = m;
    } else if (warp == 1 && staged && lane < D) {
        const i64 r = a.R[g * D + lane];
        su[lane] = a.used[s * D + lane];
        sr[lane] = r;
        srb[lane] = r > 0 ? 1.0 / (double)r : 0.0;
    }
    __syncthreads();
    const u64 zm = bits ? s_zm : 0;
    const u8* trow = a.types + s * T;
    const u8* frow = a.F + g * T;
    // item 0: the row's type before its first 2-byte boundary; items 1 ..
    // nw: pairs of types; item nw + 1: the type after the last pair
    const i64 head = imin((i64)((size_t)crow & 1), T);
    const i64 nw = (T - head) >> 1;
    const bool tyw = (((size_t)trow ^ (size_t)crow) & 1) == 0;
    i64 kmax = 0;
    for (i64 w0 = 0; w0 < nw + 2; w0 += blockDim.x) {
        const i64 w = w0 + tid;
        const i64 t0 = w == 0 ? 0 : head + 2 * (w - 1);
        const int n = w >= nw + 2 ? 0
            : (int)(w == 0 ? head : (w <= nw ? 2 : T - t0));
        unsigned word = 0;
        if (n > 0) {
            unsigned ty = 0, fw = 0;
            if (n == 2 && tyw) {
                ty = *reinterpret_cast<const unsigned short*>(trow + t0);
            } else {
                ty = trow[t0];
            }
            fw = frow[t0] | (n == 2 ? (unsigned)frow[t0 + 1] << 8 : 0u);
            const u64 ow0 = bits ? t.offw[t0] : 0;
            const u64 ow1 = bits && n == 2 ? t.offw[t0 + 1] : 0;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                if (j >= n) break;
                const i64 tt = t0 + j;
                const bool c = ((ty >> (8 * j)) & 0xffu)
                    && ((fw >> (8 * j)) & 0xffu)
                    && (bits ? ((j ? ow1 : ow0) & zm) != 0
                             : offering_ok(a, g, s, tt));
                if (!c) continue;
                word |= 1u << (8 * j);
                const i64 m = staged
                    ? head_staged(a.A + tt * D, su, sr, D, srb)
                    : headroom(a.A + tt * D, a.used + s * D, a.R + g * D, D);
                kmax = imax(kmax, m);
            }
        }
        // a pair at a 4-byte boundary takes the next lane's pair into one
        // 4-byte word (the lanes of a warp hold consecutive items)
        const unsigned up = __shfl_down_sync(~0u, word, 1);
        const int nup = __shfl_down_sync(~0u, n, 1);
        const int ndown = __shfl_up_sync(~0u, n, 1);
        const bool at4 = ((size_t)(crow + t0) & 3) == 0;
        if (n == 2 && at4 && lane < 31 && nup == 2) {
            *reinterpret_cast<unsigned*>(crow + t0) = word | up << 16;
        } else if (n == 2 && !(!at4 && lane > 0 && ndown == 2)) {
            *reinterpret_cast<unsigned short*>(crow + t0) =
                (unsigned short)word;
        } else if (n == 1) {
            crow[t0] = word & 1u;
        }
    }
    for (int o = 16; o > 0; o >>= 1)
        kmax = imax(kmax, __shfl_xor_sync(~0u, kmax, o));
    if (lane == 0) red[warp] = kmax;
    __syncthreads();
    if (tid == 0) {
        i64 k = 0;
        for (int w = 0; w < kStartThreads / 32; ++w) k = imax(k, red[w]);
        t.rem[s] = k;
    }
}

// ---------------------------------------------------------------------------
// topo_pour
// ---------------------------------------------------------------------------

// per-group scalars of the pour, in shared memory: warp 0 writes them, the
// block reads them after a barrier. The fields of one event that the whole
// block reads after a barrier (cont, jump) sit in two copies by the event's
// parity: warp 0 may start the next event before a slow warp has read them.
enum {
    V_NREM, V_L, V_HEAD, V_EVN, V_BAIL, V_STUCK, V_NN, V_NZ, V_NH, V_JMH,
    V_ENF, V_ELIG, V_NEEDZ, V_NEEDZONE, V_HAVETO, V_ANTIB, V_CONT0, V_CONT1,
    V_JUMP0, V_JUMP1, V_FOUND, V_SLOT, V_ZI, V_RUN, V_REMNEW, V_PI, V_ZC,
    V_OSLOT, V_M, V_S0, V_NRUN, V_COUNT
};

// listed-row flags (the affinity terms of a counter row)
constexpr u8 kAny = 1, kAnti = 2, kOwn = 4;

// The pour's shared memory, carved from one dynamic block by pour_carve:
// the listed rows (NZ zone and NH hostname rows at most) and the state of
// an event. The per-slot state (rem, take, zfix, pool, the undecided
// words) stays in the global scratch: its pointers are set after the carve.
struct PourSmem {
    i64* v;        // [V_COUNT]
    i64* rb;       // [RB, 4] ring of the last events (slot, zone, len,
                   //   kind), circular from v[V_HEAD] (the oldest)
    i64* R;        // [D]
    i64* room;     // [Z] consecutive-pour room of each zone, this event
    i64* score;    // [Z] zone-choice score, this event
    i64* lm;       // [Z] the candidate's best headroom over its keep types
    i64* dzone;    // [Z] the jump pattern's pods per zone
    i64* bud;      // [P] pool budgets, kept current
    i64* dpool;    // [P] the jump pattern's pods per pool
    i64* pu;       // [P, D] pool usage, written back at the end
    i64* plim;     // [P, D]
    i64* zskew;    // [NZ] listed zone rows: enforced skew (BIG = none)
    i64* mn;       // [NZ] their min count over the eligible zones
    i64* czs;      // [NZ, Z] their counters, written back at the end
    i64* hskew;    // [NH] listed hostname rows: enforced skew
    i64* fu;       // [kNarrowRows, D] the narrowing's staged used rows
    i64* arun;     // [P + 1, 2] the anti ladder's runs: first slot, length
    unsigned long long* psum;  // [P] takes into pools without a limit
    i64* rem;      // [N] room (after the loop: the touched-slot list); global
    i64* take;     // [N] global
    int* zrow;     // [NZ] the listed zone rows' indices, ascending
    int* hrow;     // [NH] the listed hostname rows' indices, ascending
    int* zcnt;     // [Z] slots pinned to zone z with room (usable zones)
    int* occz;     // [NZ] the listed zone row has a pod in some zone
    int* occh;     // [NH] the listed hostname row has a pod on some slot
    int* zfix;     // [N] global
    int* pool;     // [N] global
    unsigned* und; // [2, W] admissible undecided slots, by event parity;
                   //   global
    u8* zfl;       // [NZ] kAny | kAnti | kOwn of the zone affinity term
    u8* zmul;      // [NZ] times a commit adds to the row (zs_any + member)
    u8* hfl;       // [NH]
    u8* hmul;      // [NH]
    u8* zok;       // [Z] zone admissible, this event
    u8* agz;       // [Z]
    u8* agc;       // [C]
    u8* mmask;     // [Z] the eligible zones of the min count
    u8* plimd;     // [P] a limit binds one of the group's resources
};

__host__ __device__ inline size_t pour_bump(size_t* off, size_t bytes,
                                            size_t align) {
    const size_t at = (*off + align - 1) / align * align;
    *off = at + bytes;
    return at;
}

// Lay out the pour's shared memory at `base` (the host passes any
// address, for the size); returns its bytes. The pointers are `base` plus
// offsets, so that the compiler sees shared memory in them (an integer
// cast would make every access generic).
__host__ __device__ inline size_t pour_carve(unsigned char* base, i64 D,
                                             i64 Z, i64 C, i64 P, i64 NZ,
                                             i64 NH, i64 RB, PourSmem* m) {
    size_t off = 0;
#define KARP_CARVE(field, type, n) \
    m->field = (type*)(base + pour_bump(&off, (size_t)(n) * sizeof(type), \
                                        sizeof(type)))
    KARP_CARVE(v, i64, V_COUNT);
    KARP_CARVE(rb, i64, RB * 4);
    KARP_CARVE(R, i64, D);
    KARP_CARVE(room, i64, Z);
    KARP_CARVE(score, i64, Z);
    KARP_CARVE(lm, i64, Z);
    KARP_CARVE(dzone, i64, Z);
    KARP_CARVE(bud, i64, P);
    KARP_CARVE(dpool, i64, P);
    KARP_CARVE(pu, i64, P * D);
    KARP_CARVE(plim, i64, P * D);
    KARP_CARVE(zskew, i64, NZ);
    KARP_CARVE(mn, i64, NZ);
    KARP_CARVE(czs, i64, NZ * Z);
    KARP_CARVE(hskew, i64, NH);
    KARP_CARVE(fu, i64, kNarrowRows * D);
    KARP_CARVE(arun, i64, 2 * (P + 1));
    KARP_CARVE(psum, unsigned long long, P);
    KARP_CARVE(zrow, int, NZ);
    KARP_CARVE(hrow, int, NH);
    KARP_CARVE(zcnt, int, Z);
    KARP_CARVE(occz, int, NZ);
    KARP_CARVE(occh, int, NH);
    KARP_CARVE(zfl, u8, NZ);
    KARP_CARVE(zmul, u8, NZ);
    KARP_CARVE(hfl, u8, NH);
    KARP_CARVE(hmul, u8, NH);
    KARP_CARVE(zok, u8, Z);
    KARP_CARVE(agz, u8, Z);
    KARP_CARVE(agc, u8, C);
    KARP_CARVE(mmask, u8, Z);
    KARP_CARVE(plimd, u8, P);
#undef KARP_CARVE
    return (off + 15) / 16 * 16;
}

__device__ __forceinline__ i64 warp_min(i64 x) {
    for (int o = 16; o > 0; o >>= 1) x = imin(x, __shfl_xor_sync(~0u, x, o));
    return x;
}
__device__ __forceinline__ i64 warp_sum(i64 x) {
    for (int o = 16; o > 0; o >>= 1) x = wadd(x, __shfl_xor_sync(~0u, x, o));
    return x;
}
__device__ __forceinline__ i64 warp_max(i64 x) {
    for (int o = 16; o > 0; o >>= 1) x = imax(x, __shfl_xor_sync(~0u, x, o));
    return x;
}

// The pour's state as one view: the arguments, the shared carve and the
// group.
struct Pour {
    const FfdArgs& a;
    const TopoArgs& t;
    PourSmem m;
    i64 g;
    i64 sr;         // the group's row of the pool statics (srow[g])

    __device__ __forceinline__ i64 N() const { return a.N; }
    __device__ __forceinline__ i64 D() const { return a.D; }
    __device__ __forceinline__ i64 Z() const { return a.Z; }
    __device__ __forceinline__ i64 C() const { return a.C; }
    __device__ __forceinline__ i64 P() const { return a.P; }
    __device__ __forceinline__ i64 RB() const { return 2 * t.PMAX; }
    // pool p's (group, pool) row of the pool statics
    __device__ __forceinline__ i64 pr(i64 p) const { return sr * a.P + p; }
    // the listed hostname row j's counters over the slots
    __device__ __forceinline__ i64* ch(int j) const {
        return t.ch + (i64)m.hrow[j] * a.N;
    }
};

// a slot's room and zone pin, keeping the usable-zone counts (slots pinned
// to a zone with room left); thread 0
__device__ __forceinline__ void set_slot(const Pour& q, i64 s, int zf,
                                         i64 rem) {
    const int zo = q.m.zfix[s];
    if (zo >= 0 && q.m.rem[s] > 0) q.m.zcnt[zo] -= 1;
    if (zf >= 0 && rem > 0) q.m.zcnt[zf] += 1;
    q.m.zfix[s] = zf;
    q.m.rem[s] = rem;
}

// `count` pods off slot s's room, keeping the usable-zone counts
__device__ __forceinline__ void sub_rem(const Pour& q, i64 s, i64 count) {
    const int zo = q.m.zfix[s];
    const i64 ro = q.m.rem[s], rn = wsub(ro, count);
    if (zo >= 0 && ro > 0 && rn <= 0) atomicSub(&q.m.zcnt[zo], 1);
    q.m.rem[s] = rn;
}

__device__ void log_event(const Pour& q, i64 slot, i64 zi, i64 ln, i64 kind,
                          i64 aux, bool ring) {
    i64* v = q.m.v;
    const TopoArgs& t = q.t;
    const i64 i = v[V_EVN];
    if (i >= t.EVCAP) {
        v[V_BAIL] = 1;
    } else {
        const i64 o = q.g * t.EVCAP + i;
        t.ev_slot[o] = slot;
        t.ev_zone[o] = zi;
        t.ev_len[o] = ln;
        t.ev_kind[o] = kind;
        t.ev_aux[o] = aux;
    }
    v[V_EVN] = i + 1;
    if (ring) {
        // the oldest entry makes room for the newest
        i64* e = q.m.rb + v[V_HEAD] * 4;
        e[0] = slot;
        e[1] = zi;
        e[2] = ln;
        e[3] = kind;
        v[V_HEAD] = v[V_HEAD] + 1 == q.RB() ? 0 : v[V_HEAD] + 1;
        v[V_L] += 1;
    }
}

// `pods` more pods in pool pl: its usage and budget. A pool whose budget
// no usage moves (no limit on a requested resource) adds its pods at the
// group's end instead, from the takes.
__device__ __forceinline__ void add_pool(const Pour& q, i64 pl, i64 pods) {
    if (!q.m.plimd[pl]) return;
    const i64 D = q.D();
    i64* pu = q.m.pu + pl * D;
    for (i64 d = 0; d < D; ++d) pu[d] = wadd(pu[d], wmul(pods, q.m.R[d]));
    q.m.bud[pl] = pool_budget(q.m.plim + pl * D, pu, q.m.R, D);
}

// the counter rows a commit of `count` pods on slot s (zone zi) adds to
__device__ __forceinline__ void add_rows(const Pour& q, i64 s, i64 zi,
                                         i64 count) {
    const PourSmem& m = q.m;
    const int nz = (int)m.v[V_NZ], nh = (int)m.v[V_NH];
    if (zi >= 0)
        for (int j = 0; j < nz; ++j)
            for (int k = 0; k < m.zmul[j]; ++k)
                m.czs[j * q.Z() + zi] = wadd(m.czs[j * q.Z() + zi], count);
    for (int j = 0; j < nh; ++j) {
        if (!m.hmul[j]) continue;
        i64* c = q.ch(j) + s;
        for (int k = 0; k < m.hmul[j]; ++k) *c = wadd(*c, count);
        if (count > 0) m.occh[j] = 1;
    }
}

// place `count` pods on `slot` (topo_jax.py _commit + _record_scatter);
// thread 0. The slot's used row moves at the group's end (used + take R).
__device__ void commit(const Pour& q, i64 slot, i64 zi, i64 count,
                       i64 kind) {
    const PourSmem& m = q.m;
    m.take[slot] = wadd(m.take[slot], count);
    sub_rem(q, slot, count);
    const int pi = m.pool[slot];
    if (pi >= 0) add_pool(q, pi, count);
    m.v[V_NREM] = wsub(m.v[V_NREM], count);
    add_rows(q, slot, zi, count);
    log_event(q, slot, zi, count, kind, 0, true);
}

// max further pods on slot s under the listed hostname rows
__device__ i64 host_cap_slot(const Pour& q, i64 s) {
    const PourSmem& m = q.m;
    const int nh = (int)m.v[V_NH];
    i64 cap = KARP_BIG;
    for (int j = 0; j < nh; ++j) {
        const i64 c = q.ch(j)[s];
        const i64 skew = m.hskew[j];
        const u8 f = m.hfl[j];
        if (skew < KARP_BIG) cap = imin(cap, skew - c);
        if (f & kAny) {
            const bool occ = c > 0;
            const i64 anti_cap = occ ? 0 : ((f & kOwn) ? 1 : KARP_BIG);
            const i64 pos_cap = m.occh[j] ? (occ ? KARP_BIG : 0)
                                          : ((f & kOwn) ? KARP_BIG : 0);
            cap = imin(cap, (f & kAnti) ? anti_cap : pos_cap);
        }
    }
    return clip_big(cap);
}

// cap of a brand-new node under the listed hostname rows
__device__ i64 host_cap_new(const Pour& q) {
    const PourSmem& m = q.m;
    const int nh = (int)m.v[V_NH];
    i64 cap = KARP_BIG;
    for (int j = 0; j < nh; ++j) {
        const u8 f = m.hfl[j];
        cap = imin(cap, m.hskew[j]);
        if (f & kAny) {
            const i64 per = (f & kAnti)
                ? ((f & kOwn) ? 1 : KARP_BIG)
                : ((m.occh[j] || !(f & kOwn)) ? 0 : KARP_BIG);
            cap = imin(cap, per);
        }
    }
    return clip_big(cap);
}

// the rest of the periodic-cycle jump (topo_jax.py:341-441) once the ring's
// tail repeats with period p, on warp 0: the lanes take the pattern's
// entries, its zones, the zone rows and the pools; commits k whole periods
// when safe (each distinct slot once with its pods in the pattern: the sum
// of the per-event adds)
__device__ bool jump_warp(const Pour& q, i64 p) {
    const PourSmem& m = q.m;
    i64* v = m.v;
    const int lane = threadIdx.x & 31;
    const i64 Z = q.Z(), P = q.P(), RB = q.RB();
    const int nz = (int)v[V_NZ], nh = (int)v[V_NH];
    const i64 e0 = RB - p;          // the pattern: logical e0 .. RB - 1
    const i64 head = v[V_HEAD];
    auto ring = [&](i64 e, int w) -> i64 {
        const i64 x = head + e;
        return m.rb[(x >= RB ? x - RB : x) * 4 + w];
    };
    // the pods of the pattern's distinct slot at entry e (0 where an
    // earlier entry holds the slot)
    auto slot_pods = [&](i64 e) -> i64 {
        const i64 s = ring(e0 + e, 0);
        i64 dt = 0;
        for (i64 j = 0; j < p; ++j) {
            if (ring(e0 + j, 0) != s) continue;
            if (j < e) return 0;
            dt += ring(e0 + j, 2);
        }
        return dt;
    };
    i64 dn = 0;
    bool place = true;
    for (i64 e = lane; e < p; e += 32) {
        place &= ring(e0 + e, 3) == kPlace;
        dn += ring(e0 + e, 2);
    }
    if (!__all_sync(~0u, place)) return false;
    const i64 d_n = warp_sum(dn);
    i64 dmax = -1;
    bool untouched = false;
    for (i64 z = lane; z < Z; z += 32) {
        i64 dz = 0;
        for (i64 e = 0; e < p; ++e) {
            const i64 zone = ring(e0 + e, 1);
            if (zone >= 0 && (zone < Z - 1 ? zone : Z - 1) == z)
                dz += ring(e0 + e, 2);
        }
        m.dzone[z] = dz;
        if (dz > 0) dmax = imax(dmax, dz);
        untouched |= m.mmask[z] && dz <= 0;
    }
    __syncwarp();
    const i64 delta = warp_max(dmax);
    bool mixed = false;
    for (i64 z = lane; z < Z; z += 32)
        mixed |= m.dzone[z] > 0 && m.dzone[z] != delta;
    const bool uniform = delta > 0 && !__any_sync(~0u, mixed);
    const bool untouched_elig = __any_sync(~0u, untouched);
    const bool enf = v[V_ENF], elig = v[V_ELIG];
    if (!(d_n > 0 && uniform && !(enf && elig && untouched_elig)
          && !v[V_HAVETO] && !(enf && !elig)))
        return false;
    i64 k = floordiv1(v[V_NREM], d_n > 1 ? d_n : 1);
    // re-admission horizon of untouched zones with usable slots
    if (enf) {
        const i64 dl = delta > 1 ? delta : 1;
        for (i64 i = lane; i < nz * Z; i += 32) {
            const i64 j = i / Z, z = i - j * Z, skew = m.zskew[j];
            if (skew >= KARP_BIG || m.dzone[z] > 0 || !m.zcnt[z]) continue;
            k = imin(k, clip_big(floordiv1(m.czs[i] - skew - m.mn[j], dl)));
        }
    }
    // per-slot room and hostname-spread bounds over the pattern's slots
    for (i64 x = lane; x < P; x += 32) m.dpool[x] = 0;
    __syncwarp();
    for (i64 e = lane; e < p; e += 32) {
        const i64 dt = slot_pods(e);
        if (!dt) continue;
        const i64 s = ring(e0 + e, 0);
        k = imin(k, floordiv1(m.rem[s], dt));
        for (int j = 0; j < nh; ++j)
            if (m.hskew[j] < KARP_BIG)
                k = imin(k, floordiv1(m.hskew[j] - q.ch(j)[s], dt));
        const int pl = m.pool[s];
        if (pl >= 0)
            atomicAdd((unsigned long long*)&m.dpool[pl],
                      (unsigned long long)dt);
    }
    __syncwarp();
    for (i64 x = lane; x < P; x += 32)
        if (m.dpool[x] > 0) k = imin(k, floordiv1(m.bud[x], m.dpool[x]));
    k = warp_min(k);
    if (k < 1) return false;

    // commit k periods
    for (i64 e = lane; e < p; e += 32) {
        const i64 dt = slot_pods(e);
        if (!dt) continue;
        const i64 s = ring(e0 + e, 0), tot = wmul(dt, k);
        m.take[s] = wadd(m.take[s], tot);
        sub_rem(q, s, tot);
        add_rows(q, s, -1, tot);
    }
    for (i64 x = lane; x < P; x += 32)
        if (m.dpool[x] > 0) add_pool(q, x, wmul(m.dpool[x], k));
    for (i64 i = lane; i < nz * Z; i += 32) {
        const i64 j = i / Z, z = i - j * Z;
        for (int r = 0; r < m.zmul[j]; ++r)
            m.czs[i] = wadd(m.czs[i], wmul(m.dzone[z], k));
    }
    __syncwarp();
    if (lane == 0) {
        v[V_NREM] = wsub(v[V_NREM], wmul(d_n, k));
        // the host appends the pattern k (k < 3) or 2 more times; the
        // ring's tail is the pattern either way, so only the count moves
        v[V_L] = v[V_L] + p * (k < 2 ? k : 2);
        log_event(q, 0, -1, p, kCyc, k, false);
    }
    __syncwarp();
    return true;
}

// An event's start on warp 0: the continue flag, the per-event reductions
// over the listed zone rows (lanes over zones) and the jump (lanes over the
// periods, then over the pattern). Writes the event's parity copies of
// cont and jump and resets its search word.
__device__ void event_start(const Pour& q, int par, int* best) {
    const PourSmem& m = q.m;
    i64* v = m.v;
    const int lane = threadIdx.x & 31;
    const i64 Z = q.Z();
    __syncwarp();
    const bool cont = v[V_NREM] > 0 && !v[V_STUCK] && !v[V_BAIL];
    bool jumped = false;
    if (cont) {
        const int nz = (int)v[V_NZ];
        const bool elig = v[V_ELIG];
        for (int j = 0; j < nz; ++j) {
            i64 mn = KARP_BIG;
            bool occ = false;
            for (i64 z = lane; z < Z; z += 32) {
                const i64 c = m.czs[j * Z + z];
                if (m.mmask[z]) mn = imin(mn, c);
                occ |= c > 0;
            }
            mn = warp_min(mn);
            occ = __any_sync(~0u, occ);
            if (lane == 0) {
                m.mn[j] = elig ? mn : 0;
                m.occz[j] = occ;
            }
        }
        __syncwarp();
        for (i64 z = lane; z < Z; z += 32) {
            bool ok = true;
            i64 score = 0, room = KARP_BIG, za_room = KARP_BIG;
            for (int j = 0; j < nz; ++j) {
                const i64 c = m.czs[j * Z + z], mn = m.mn[j];
                const i64 skew = m.zskew[j];
                if (c + 1 - mn > skew) ok = false;
                if (skew < KARP_BIG) {
                    score += c;
                    room = imin(room, (elig && c == mn) ? 1 : mn + skew - c);
                }
                const u8 f = m.zfl[j];
                if (f & kAny) {
                    const bool occ = c > 0;
                    const bool aff = (f & kAnti) ? !occ
                        : (m.occz[j] ? occ : (bool)(f & kOwn));
                    if (!aff) ok = false;
                    if ((f & kAnti) || ((f & kOwn) && !m.occz[j]))
                        za_room = 1;
                }
            }
            m.zok[z] = ok;
            m.score[z] = score;
            m.room[z] = imax(imin(room, za_room), 1);
        }
        __syncwarp();
        // the shortest period q <= PMAX whose last two repeats match
        const i64 L = v[V_L], PMAX = q.t.PMAX, RB = q.RB(), head = v[V_HEAD];
        auto same = [&](i64 e1, i64 e2) {    // logical entries e1, e2
            i64 x = head + e1, y = head + e2;
            x = x >= RB ? x - RB : x;
            y = y >= RB ? y - RB : y;
            const i64* rx = m.rb + x * 4;
            const i64* ry = m.rb + y * 4;
            return (rx[0] == ry[0]) & (rx[1] == ry[1]) & (rx[2] == ry[2])
                & (rx[3] == ry[3]);
        };
        i64 p = 0;
        for (i64 q0 = 1; q0 <= PMAX && 2 * q0 <= L && !p; q0 += 32) {
            // a period can repeat only if the newest entry equals the one
            // a period back: the lanes test 32 periods at once
            const i64 per = q0 + lane;
            const bool c = per <= PMAX && 2 * per <= L
                && same(RB - 1, RB - 1 - per);
            for (unsigned b = __ballot_sync(~0u, c); b && !p; b &= b - 1) {
                const i64 cq = q0 + __ffs(b) - 1;
                bool eq = true;
                for (i64 e = lane; e < cq; e += 32)
                    eq &= same(RB - 2 * cq + e, RB - cq + e);
                if (__all_sync(~0u, eq)) p = cq;
            }
        }
        if (p) jumped = jump_warp(q, p);
    }
    if (lane == 0) {
        v[V_CONT0 + par] = cont;
        v[V_JUMP0 + par] = jumped;
        best[par] = (int)q.N();
    }
    __syncwarp();
}

// the first set bit of the undecided words `und` in [from, lim); -1 if
// none. Every lane of the calling warp takes part and gets the answer.
__device__ i64 next_und(const unsigned* und, i64 from, i64 lim) {
    const int lane = threadIdx.x & 31;
    if (from >= lim) return -1;
    const i64 w1 = from >> 5, w2 = (lim - 1) >> 5;
    for (i64 w0 = w1; w0 <= w2; w0 += 32) {
        const i64 w = w0 + lane;
        unsigned bits = 0;
        if (w <= w2) {
            bits = und[w];
            if (w == w1) bits &= ~0u << (from & 31);
            if (w == w2) bits &= (2u << ((lim - 1) & 31)) - 1u;
        }
        const unsigned b = __ballot_sync(~0u, bits != 0);
        if (b) {
            const int src = __ffs(b) - 1;
            const unsigned sb = __shfl_sync(~0u, bits, src);
            return ((w0 + src) << 5) + __ffs(sb) - 1;
        }
    }
    return -1;
}

// open a new node (topo_jax.py:558-612) and, for the cap-1 anti ladder,
// commit the whole one-pod-per-node run's scalars (:614-653); warp 0 (the
// lanes over the pools, then thread 0). The block writes the new rows.
__device__ void open_new(const Pour& q) {
    const PourSmem& m = q.m;
    const FfdArgs& a = q.a;
    const TopoArgs& t = q.t;
    i64* v = m.v;
    const int lane = threadIdx.x & 31;
    const i64 N = q.N(), D = q.D(), Z = q.Z(), C = q.C(), P = q.P(), g = q.g;
    const bool need_zone = v[V_NEEDZONE];
    const i64 hcap_new = host_cap_new(q);
    const i64 nn = v[V_NN];
    i64 pi = -1, zsel = 0;
    for (i64 q0 = 0; q0 < P && pi < 0; q0 += 32) {
        const i64 x = q0 + lane;
        bool valid = false;
        i64 best = 0;
        if (x < P) {
            i64 bestkey = KARP_BIG;
            bool zvalid = false;
            for (i64 z = 0; z < Z; ++z) {
                if (!(t.zcand_pz[q.pr(x) * Z + z] && m.zok[z])) continue;
                zvalid = true;
                const i64 key = m.score[z] * Z + z;
                if (key < bestkey) {
                    bestkey = key;
                    best = z;
                }
            }
            const i64 cap = need_zone ? t.cap_pz[q.pr(x) * Z + best]
                                    : t.cap_any[q.pr(x)];
            valid = t.open_ok0[q.pr(x)] && m.bud[x] >= 1 && N - nn > 0
                && cap >= 1 && hcap_new >= 1 && (!need_zone || zvalid);
        }
        const unsigned b = __ballot_sync(~0u, valid);
        if (b) {
            const int src = __ffs(b) - 1;
            pi = q0 + src;
            zsel = __shfl_sync(~0u, best, src);
        }
    }
    if (lane != 0) return;
    if (pi < 0) {
        v[V_STUCK] = 1;
        return;
    }
    const i64 zi = need_zone ? zsel : -1;
    const i64 zc = zi < 0 ? 0 : zi;
    const i64 slot = nn;
    const i64 capn = need_zone ? t.cap_pz[q.pr(pi) * Z + zc]
                                : t.cap_any[q.pr(pi)];
    const i64 roomz = (need_zone && v[V_NEEDZ]) ? m.room[zc] : KARP_BIG;
    const i64 run = imax(imin(imin(capn, hcap_new),
                              imin(m.bud[pi], imin(v[V_NREM], roomz))), 1);
    v[V_NN] = nn + 1;
    a.alive[slot] = 1;
    a.pool[slot] = (int)pi;
    for (i64 z = 0; z < Z; ++z)
        a.zones[slot * Z + z] = need_zone
            ? (z == zi) : (m.agz[z] && a.pool_agz[pi * Z + z]);
    for (i64 c = 0; c < C; ++c)
        a.ct[slot * C + c] = m.agc[c] && a.pool_agc[pi * C + c];
    for (i64 d = 0; d < D; ++d)
        a.used[slot * D + d] = a.daemon[(g * P + pi) * D + d];
    set_slot(q, slot, need_zone ? (int)zi : -1, capn);
    commit(q, slot, zi, run, kOpen);
    i64 mm = 0;
    const i64 s0 = v[V_NN];
    if (run == 1 && hcap_new == 1 && zi < 0 && v[V_ANTIB] && v[V_NREM] > 0) {
        mm = imin(v[V_NREM], imin(m.bud[pi], N - s0));
        add_pool(q, pi, mm);
        v[V_NREM] = wsub(v[V_NREM], mm);
        v[V_NN] = s0 + mm;
        v[V_L] += mm;
        // distinct fresh slots never form a periodic pattern
        for (i64 j = 0; j < q.RB() * 4; ++j) m.rb[j] = kRbInvalid;
        if (mm > 0 && v[V_JMH] >= 0) m.occh[v[V_JMH]] = 1;
        // a run's slots keep their rows to the end (no room: no later
        // event touches them), so the end narrows them as one row; every
        // run but the last spends its pool's budget, so at most P + 1
        if (mm > 0 && v[V_NRUN] <= q.P()) {
            m.arun[2 * v[V_NRUN]] = s0;
            m.arun[2 * v[V_NRUN] + 1] = mm;
            v[V_NRUN] += 1;
        }
        log_event(q, s0, -1, mm, kAntiRun, 0, false);
    }
    v[V_PI] = pi;
    v[V_ZC] = zc;
    v[V_OSLOT] = slot;
    v[V_M] = mm;
    v[V_S0] = s0;
}

__global__ void __launch_bounds__(kPourThreads)
topo_pour_kernel(const __grid_constant__ FfdArgs a,
                 const __grid_constant__ TopoArgs t, i64 g) {
    extern __shared__ __align__(16) unsigned char pour_dyn[];
    __shared__ int s_best[2];
    __shared__ int s_nt;
    __shared__ unsigned long long s_zflag;
    const i64 N = a.N, T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const i64 GZ = t.GZ, GH = t.GH, EVCAP = t.EVCAP, RB = 2 * t.PMAX;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    const i64 W = (N + 31) / 32;
    PourSmem s_m;
    pour_carve(pour_dyn, D, Z, C, P, t.NZ, t.NH, RB, &s_m);
    s_m.rem = t.rem;
    s_m.take = t.take;
    s_m.zfix = t.zfix;
    s_m.pool = a.pool;
    s_m.und = t.und;
    const Pour q{a, t, s_m, g, (i64)t.srow[g]};
    const PourSmem& m = q.m;
    i64* v = m.v;

    // ---- group entry: scratch, the group's log row, the ring, the lists --
    for (i64 i = tid; i < EVCAP; i += nth) {
        const i64 o = g * EVCAP + i;
        t.ev_slot[o] = 0;
        t.ev_zone[o] = -1;
        t.ev_len[o] = 0;
        t.ev_kind[o] = -1;
        t.ev_aux[o] = 0;
    }
    for (i64 i = tid; i < RB * 4; i += nth) m.rb[i] = kRbInvalid;
    for (i64 d = tid; d < D; d += nth) m.R[d] = a.R[g * D + d];
    for (i64 z = tid; z < Z; z += nth) {
        m.agz[z] = a.agz[g * Z + z];
        m.mmask[z] = t.min_mask[g * Z + z];
        m.zcnt[z] = 0;
        m.lm[z] = 0;
    }
    for (i64 c = tid; c < C; c += nth) m.agc[c] = a.agc[g * C + c];
    for (i64 i = tid; i < P * D; i += nth) {
        m.pu[i] = a.pool_used[i];
        m.plim[i] = a.pool_limit[i];
    }
    for (i64 h = tid; h < t.NH; h += nth) m.occh[h] = 0;
    for (i64 s = tid; s < N; s += nth) m.take[s] = 0;
    if (warp == 0) {
        // the rows the group reads or writes, ascending
        const i64 mz = t.member_z[g], mh = t.member_h[g];
        int nz = 0, nh = 0, jmh = -1;
        bool enf = false, zaa = false, elig = false, veto = false;
        for (i64 r0 = 0; r0 < GZ; r0 += 32) {
            const i64 r = r0 + lane;
            bool in = false;
            i64 skew = KARP_BIG;
            u8 f = 0, mu = 0;
            if (r < GZ) {
                const i64 o = g * GZ + r;
                skew = t.zs_skew[o];
                f = (t.za_any[o] ? kAny : 0) | (t.za_anti[o] ? kAnti : 0)
                    | (t.za_own[o] ? kOwn : 0);
                mu = (t.zs_any[o] ? 1 : 0) + (r == mz ? 1 : 0);
                in = skew < KARP_BIG || (f & kAny) || mu;
                enf |= skew < KARP_BIG;
                zaa |= (f & kAny) != 0;
            }
            const unsigned b = __ballot_sync(~0u, in);
            const int j = nz + __popc(b & ((1u << lane) - 1u));
            if (in && j < t.NZ) {
                m.zrow[j] = (int)r;
                m.zskew[j] = skew;
                m.zfl[j] = f;
                m.zmul[j] = mu;
            }
            nz += __popc(b);
        }
        for (i64 h0 = 0; h0 < GH; h0 += 32) {
            const i64 h = h0 + lane;
            bool in = false;
            i64 skew = KARP_BIG;
            u8 f = 0, mu = 0;
            if (h < GH) {
                const i64 o = g * GH + h;
                skew = t.hs_skew[o];
                f = (t.ha_any[o] ? kAny : 0) | (t.ha_anti[o] ? kAnti : 0)
                    | (t.ha_own[o] ? kOwn : 0);
                mu = (t.hs_any[o] ? 1 : 0) + (h == mh ? 1 : 0);
                in = skew < KARP_BIG || (f & kAny) || mu;
                veto |= f == (kAny | kAnti | kOwn);
            }
            const unsigned b = __ballot_sync(~0u, in);
            const int j = nh + __popc(b & ((1u << lane) - 1u));
            if (in && j < t.NH) {
                m.hrow[j] = (int)h;
                m.hskew[j] = skew;
                m.hfl[j] = f;
                m.hmul[j] = mu;
                if (h == mh) jmh = j;
            }
            nh += __popc(b);
        }
        for (i64 z = lane; z < Z; z += 32) elig |= t.min_mask[g * Z + z] != 0;
        enf = __any_sync(~0u, enf);
        zaa = __any_sync(~0u, zaa);
        veto = __any_sync(~0u, veto);
        elig = __any_sync(~0u, elig);
        jmh = __reduce_max_sync(~0u, jmh);
        // the layout was sized by the host's count of the listed rows
        if (nz > t.NZ || nh > t.NH) __trap();
        if (lane == 0) {
            v[V_NREM] = a.n[g];
            v[V_L] = 0;
            v[V_HEAD] = 0;
            v[V_EVN] = 0;
            v[V_BAIL] = 0;
            v[V_STUCK] = 0;
            v[V_NN] = a.num_nodes[0];
            v[V_NZ] = nz;
            v[V_NH] = nh;
            v[V_JMH] = jmh;
            v[V_ENF] = enf;
            v[V_ELIG] = elig;
            v[V_NEEDZ] = enf || zaa;
            v[V_NEEDZONE] = t.zone_needed[g];
            v[V_HAVETO] = veto;
            v[V_ANTIB] = t.anti_bulk[q.sr];
            v[V_NRUN] = 0;
            s_nt = 0;
            s_zflag = 0;
        }
    }
    __syncthreads();
    const int nz = (int)v[V_NZ], nh = (int)v[V_NH];
    for (i64 i = tid; i < nz * Z; i += nth)
        m.czs[i] = t.cz[m.zrow[i / Z] * Z + i % Z];
    for (i64 i = tid; i < nh * N; i += nth) {
        const i64 j = i / N, s = i - j * N;
        if (t.ch[m.hrow[j] * N + s] > 0) m.occh[j] = 1;
    }
    for (i64 s = tid; s < N; s += nth) {
        const int zf = m.zfix[s];
        if (zf >= 0 && m.rem[s] > 0) atomicAdd(&m.zcnt[zf], 1);
    }
    for (i64 x = tid; x < P; x += nth) {
        m.bud[x] = pool_budget(m.plim + x * D, m.pu + x * D, m.R, D);
        bool lim = false;
        for (i64 d = 0; d < D; ++d)
            lim |= m.plim[x * D + d] >= 0 && m.R[d] > 0;
        m.plimd[x] = lim;
        m.psum[x] = 0;
    }
    __syncthreads();
    const bool needz = v[V_NEEDZ], need_zone = v[V_NEEDZONE];

    for (int par = 0;; par ^= 1) {
        if (warp == 0) event_start(q, par, s_best);
        __syncthreads();
        if (!v[V_CONT0 + par]) break;
        if (v[V_JUMP0 + par]) continue;

        // ---- one pass over the slots: admissibility, and for a decided
        // slot its run; the first viable decided slot, the undecided words
        const i64 nrem = v[V_NREM];
        unsigned* und = m.und + par * W;
        int best = (int)N;
        for (i64 b0 = 0; b0 < N; b0 += nth) {
            const i64 s = b0 + tid;
            bool cand_und = false;
            if (s < N) {
                const i64 rem = m.rem[s];
                bool o = rem > 0;
                i64 hcap = KARP_BIG;
                for (int j = 0; j < nh; ++j) {
                    const i64 c = q.ch(j)[s];
                    const i64 skew = m.hskew[j];
                    const u8 f = m.hfl[j];
                    if (!(c < skew)) o = false;
                    if (skew < KARP_BIG) hcap = imin(hcap, skew - c);
                    if (f & kAny) {
                        const bool occ = c > 0;
                        const bool hok = (f & kAnti) ? !occ
                            : (m.occh[j] ? occ : (bool)(f & kOwn));
                        if (!hok) o = false;
                        const i64 anti_cap = occ ? 0
                            : ((f & kOwn) ? 1 : KARP_BIG);
                        const i64 pos_cap = m.occh[j]
                            ? (occ ? KARP_BIG : 0)
                            : ((f & kOwn) ? KARP_BIG : 0);
                        hcap = imin(hcap, (f & kAnti) ? anti_cap : pos_cap);
                    }
                }
                const int pl = m.pool[s];
                o = o && pl >= 0 && m.bud[pl < P - 1 ? pl : P - 1] > 0;
                const int zf = m.zfix[s];
                if (needz && zf >= 0) o = o && m.zok[zf];
                const bool und_s = zf < 0 && needz;
                if (o && !und_s) {
                    const i64 roomz = (needz && zf >= 0) ? m.room[zf]
                                                         : KARP_BIG;
                    const i64 run = imin(imin(rem, clip_big(hcap)),
                                         imin(m.bud[pl < 0 ? 0 : pl],
                                              imin(nrem, roomz)));
                    if (run >= 1 && s < best) best = (int)s;
                }
                cand_und = o && und_s;
            }
            const unsigned wbits = __ballot_sync(~0u, cand_und);
            if (lane == 0 && b0 + warp * 32 < N) und[(b0 >> 5) + warp] = wbits;
        }
        best = __reduce_min_sync(~0u, best);
        if (lane == 0 && best < N) atomicMin(&s_best[par], best);
        __syncthreads();

        // ---- the undecided slots below it, in order (topo_jax.py:476-542)
        const i64 bst = s_best[par];
        bool found = false;
        for (i64 u = next_und(und, 0, bst); u >= 0;
             u = next_und(und, u + 1, bst)) {
            // the slot's one-more-pod fit types (their zones) and, for each
            // zone, its best headroom over the types that keep an offering
            // there
            // the slot's take and capacity types narrowed by the group's;
            // a type's loads are issued before its tests
            const i64 tk = m.take[u];
            unsigned ctm = 0;
            for (i64 c = 0; c < C; ++c)
                ctm |= (a.ct[u * C + c] && m.agc[c]) ? 1u << c : 0u;
            // the zones the choice can take: the rest need no headroom
            unsigned long long zc = 0;
            for (i64 z = 0; z < Z; ++z)
                zc |= (a.zones[u * Z + z] && m.agz[z] && m.zok[z])
                    ? 1ull << z : 0ull;
            unsigned long long zf = 0;
            for (i64 b0 = 0; b0 < T; b0 += nth) {
                const i64 tt = b0 + tid;
                unsigned long long kz = 0;
                i64 hr = 0;
                if (tt < T) {
                    const bool cd = a.cand[u * T + tt] != 0;
                    const i64* At = a.A + tt * D;
                    const u8* av = a.avail_zc + tt * Z * C;
                    unsigned long long anyz = 0;
                    for (i64 z = 0; z < Z; ++z) {
                        unsigned cm = 0;
                        for (i64 c = 0; c < C; ++c)
                            cm |= av[z * C + c] ? 1u << c : 0u;
                        anyz |= cm ? 1ull << z : 0ull;
                        kz |= (cm & ctm) ? 1ull << z : 0ull;
                    }
                    kz &= zc;
                    bool fit = cd;
                    hr = KARP_BIG;
                    for (i64 d = 0; d < D; ++d) {
                        const i64 r = m.R[d];
                        const i64 cur = wadd(a.used[u * D + d], wmul(tk, r));
                        fit &= wadd(cur, r) <= At[d];
                        if (r > 0 && cd && kz)
                            hr = imin(hr, floordiv1(wsub(At[d], cur), r));
                    }
                    hr = hr < 0 ? 0 : hr;
                    if (fit) zf |= anyz;
                    if (!cd) kz = 0;
                }
                for (i64 z = 0; z < Z; ++z) {
                    const bool has = (kz >> z) & 1;
                    if (!((zc >> z) & 1) || !__any_sync(~0u, has)) continue;
                    const i64 x = warp_max(has ? hr : 0);
                    if (lane == 0 && x > 0)
                        atomicMax((long long*)&m.lm[z], (long long)x);
                }
            }
            const unsigned lo = __reduce_or_sync(~0u, (unsigned)zf);
            const unsigned hi = __reduce_or_sync(~0u, (unsigned)(zf >> 32));
            if (lane == 0 && (lo | hi))
                atomicOr(&s_zflag, ((unsigned long long)hi << 32) | lo);
            __syncthreads();
            if (tid == 0) {
                // the min-(score, index) admissible zone among them
                const unsigned long long zflag = s_zflag;
                i64 zi = -1, bestkey = KARP_BIG;
                for (i64 z = 0; z < Z; ++z) {
                    if (!(((zflag >> z) & 1) && a.zones[u * Z + z] && m.agz[z]
                          && m.zok[z]))
                        continue;
                    const i64 key = m.score[z] * Z + z;
                    if (key < bestkey) {
                        bestkey = key;
                        zi = z;
                    }
                }
                v[V_FOUND] = 0;
                if (zi >= 0) {
                    const i64 remnew = clip_big(m.lm[zi] - m.take[u]);
                    const int pl = m.pool[u];
                    const i64 run = imin(
                        imin(remnew, host_cap_slot(q, u)),
                        imin(m.bud[pl < 0 ? 0 : pl],
                             imin(v[V_NREM], m.room[zi])));
                    if (run >= 1) {
                        v[V_FOUND] = 1;
                        v[V_SLOT] = u;
                        v[V_ZI] = zi;
                        v[V_RUN] = run;
                        v[V_REMNEW] = remnew;
                    }
                }
                for (i64 z = 0; z < Z; ++z) m.lm[z] = 0;
                s_zflag = 0;
            }
            __syncthreads();
            if (v[V_FOUND]) {
                found = true;
                break;
            }
        }

        if (found) {
            // fix the slot's zone (:544-555): its candidates narrow to the
            // types that keep an offering in the zone, then the commit
            const i64 u = v[V_SLOT], zi = v[V_ZI];
            for (i64 tt = tid; tt < T; tt += nth) {
                bool kp = false;
                if (a.cand[u * T + tt])
                    for (i64 c = 0; c < C && !kp; ++c)
                        kp = a.avail_zc[tt * Z * C + zi * C + c]
                            && a.ct[u * C + c] && m.agc[c];
                a.cand[u * T + tt] = kp;
            }
            if (tid == 0) {
                for (i64 z = 0; z < Z; ++z) a.zones[u * Z + z] = z == zi;
                set_slot(q, u, (int)zi, v[V_REMNEW]);
                commit(q, u, zi, v[V_RUN], kFix);
            }
            continue;
        }
        if (bst < N) {
            // the first viable decided slot
            if (tid == 0) {
                const int zf = m.zfix[bst], pl = m.pool[bst];
                const i64 roomz = (needz && zf >= 0) ? m.room[zf] : KARP_BIG;
                const i64 run = imin(imin(m.rem[bst], host_cap_slot(q, bst)),
                                     imin(m.bud[pl < 0 ? 0 : pl],
                                          imin(v[V_NREM], roomz)));
                commit(q, bst, zf, run, kPlace);
            }
            continue;
        }

        // ---- a new node ----------------------------------------------------
        if (warp == 0) open_new(q);
        __syncthreads();
        if (!v[V_STUCK]) {
            const i64 pi = v[V_PI], zc = v[V_ZC], slot = v[V_OSLOT];
            const i64 mm = v[V_M], s0 = v[V_S0];
            // the new rows' candidates, row by row, coalesced over T
            for (i64 tt = tid; tt < T; tt += nth) {
                const bool kp = t.cand_new[q.pr(pi) * T + tt]
                    && (!need_zone
                        || t.availz_p[(q.pr(pi) * T + tt) * Z + zc]);
                for (i64 r = 0; r <= mm; ++r) a.cand[(slot + r) * T + tt] = kp;
            }
            const i64 jmh = v[V_JMH];
            for (i64 j = tid; j < mm; j += nth) {
                const i64 s = s0 + j;
                a.alive[s] = 1;
                a.pool[s] = (int)pi;
                for (i64 z = 0; z < Z; ++z)
                    a.zones[s * Z + z] = m.agz[z] && a.pool_agz[pi * Z + z];
                for (i64 c = 0; c < C; ++c)
                    a.ct[s * C + c] = m.agc[c] && a.pool_agc[pi * C + c];
                // its base row; the group's end adds the take (one pod)
                for (i64 d = 0; d < D; ++d)
                    a.used[s * D + d] = a.daemon[(g * P + pi) * D + d];
                m.rem[s] = 0;
                m.take[s] = 1;
                if (jmh >= 0) {
                    i64* c = q.ch((int)jmh) + s;
                    *c = wadd(*c, 1);
                }
            }
        }
    }

    // ---- group end: the touched slots, their used rows and narrowing ------
    __syncthreads();
    int* list = (int*)m.rem;          // rem is dead from here on
    const int nrun = (int)v[V_NRUN];
    for (i64 b0 = 0; b0 < N; b0 += nth) {
        const i64 s = b0 + tid;
        bool tch = false;
        int mine = (int)P;          // a pool without a limit this slot adds to
        i64 tk = 0;
        if (s < N) {
            tk = m.take[s];
            a.takes[(g - a.G0) * N + s] = (int)tk;
            const int pl = m.pool[s];
            tch = tk > 0 && pl >= 0;
            if (tch && !m.plimd[pl]) mine = pl;
            for (int k = 0; k < nrun; ++k)
                tch &= !(s >= m.arun[2 * k]
                         && s < m.arun[2 * k] + m.arun[2 * k + 1]);
        }
        // the takes into pools without a limit, a warp's summed per pool
        for (int x = __reduce_min_sync(~0u, mine); x < P;) {
            const i64 sum = warp_sum(mine == x ? tk : 0);
            if (lane == 0) atomicAdd(&m.psum[x], (unsigned long long)sum);
            x = __reduce_min_sync(~0u, mine > x ? mine : (int)P);
        }
        const unsigned b = __ballot_sync(~0u, tch);
        int at = 0;
        if (lane == 0 && b) at = atomicAdd(&s_nt, __popc(b));
        at = __shfl_sync(~0u, at, 0);
        if (tch) list[at + __popc(b & ((1u << lane) - 1u))] = (int)s;
    }
    __syncthreads();
    const i64 nt = s_nt;
    for (i64 i = tid; i < nt; i += nth) {
        const i64 s = list[i];
        if (m.zfix[s] < 0)
            for (i64 z = 0; z < Z; ++z) a.zones[s * Z + z] &= m.agz[z];
        for (i64 c = 0; c < C; ++c) a.ct[s * C + c] &= m.agc[c];
    }
    for (i64 i = tid; i < nz * Z; i += nth)
        t.cz[m.zrow[i / Z] * Z + i % Z] = m.czs[i];
    for (i64 i = tid; i < P * D; i += nth) {
        const i64 x = i / D;
        a.pool_used[i] = m.plimd[x] ? m.pu[i]
            : wadd(m.pu[i], wmul((i64)m.psum[x], m.R[i % D]));
    }
    // the anti ladder's runs: one row each (its candidates and used row
    // are every slot's), its types stored down the run, coalesced over T
    for (int k = 0; k < nrun; ++k) {
        const i64 s0 = m.arun[2 * k], mm = m.arun[2 * k + 1];
        for (i64 d = tid; d < D; d += nth)
            m.fu[d] = wadd(a.used[s0 * D + d], wmul(m.take[s0], m.R[d]));
        __syncthreads();
        for (i64 i = tid; i < mm * D; i += nth) {
            a.used[(s0 + i / D) * D + i % D] = m.fu[i % D];
        }
        for (i64 i = tid; i < mm; i += nth) {
            const i64 s = s0 + i;
            for (i64 z = 0; z < Z; ++z) a.zones[s * Z + z] &= m.agz[z];
            for (i64 c = 0; c < C; ++c) a.ct[s * C + c] &= m.agc[c];
        }
        for (i64 tt = tid; tt < T; tt += nth) {
            bool fit = a.cand[s0 * T + tt] != 0;
            for (i64 d = 0; d < D; ++d) fit &= m.fu[d] <= a.A[tt * D + d];
            for (i64 r = 0; r < mm; ++r) a.types[(s0 + r) * T + tt] = fit;
        }
        __syncthreads();
    }
    // the touched slots' used rows (+ take R) and types, kNarrowRows
    // slots at a time: the chunk's final used rows staged in shared
    // memory, then a thread a type loads the chunk's candidate bytes
    // before it stores any type (loads and stores coalesced over T)
    for (i64 r0 = 0; r0 < nt; r0 += kNarrowRows) {
        const int nr = (int)imin(kNarrowRows, nt - r0);
        for (i64 i = tid; i < nr * D; i += nth) {
            const i64 s = list[r0 + i / D], d = i % D;
            const i64 u = wadd(a.used[s * D + d], wmul(m.take[s], m.R[d]));
            m.fu[i] = u;
            a.used[s * D + d] = u;
        }
        __syncthreads();
        for (i64 tt = tid; tt < T; tt += nth) {
            const i64* At = a.A + tt * D;
            i64 ar[kRegD];
#pragma unroll
            for (int d = 0; d < kRegD; ++d) ar[d] = d < D ? At[d] : 0;
            unsigned cm = 0;
#pragma unroll
            for (int r = 0; r < kNarrowRows; ++r)
                if (r < nr && a.cand[list[r0 + r] * T + tt]) cm |= 1u << r;
#pragma unroll
            for (int r = 0; r < kNarrowRows; ++r) {
                if (r >= nr) break;
                const i64* us = m.fu + r * D;
                bool fit = (cm >> r) & 1;
#pragma unroll
                for (int d = 0; d < kRegD; ++d)
                    fit &= (d < D ? us[d] : 0) <= ar[d];
                for (i64 d = kRegD; d < D; ++d) fit &= us[d] <= At[d];
                a.types[list[r0 + r] * T + tt] = fit;
            }
        }
        __syncthreads();
    }
    if (tid == 0) {
        a.leftover[g - a.G0] = v[V_NREM];
        t.ev_n[g] = imin(v[V_EVN], EVCAP);
        t.bail[g] = v[V_BAIL] != 0;
        a.num_nodes[0] = (int)v[V_NN];
    }
}

int set_smem(const void* fn, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// the pool statics of the topology groups of ranks [r0, r0 + nr), table
// rows 0 .. nr - 1, and at r0 == 0 the offering words
int karp_topo_pool_statics(const FfdArgs* a, const TopoArgs* t,
                           long long r0, long long nr, void* stream) {
    const bool words = r0 == 0 && a->Z * a->C <= kOfferBits;
    const i64 nb = nr * a->P
        + (words ? (a->T + kStaticsThreads - 1) / kStaticsThreads : 0);
    if (nb <= 0) return 0;
    const size_t smem = (size_t)(8 * (a->Z + 2 * a->D) + 5 * a->Z + a->C);
    int err = set_smem((const void*)topo_pool_statics_kernel, smem);
    if (err) return err;
    topo_pool_statics_kernel<<<(unsigned)nb, kStaticsThreads, smem,
                               (cudaStream_t)stream>>>(*a, *t, r0, nr);
    return (int)cudaGetLastError();
}

int karp_topo_group_start(const FfdArgs* a, const TopoArgs* t, long long g,
                          void* stream) {
    if (a->N <= 0) return 0;
    topo_group_start_kernel<<<(unsigned)a->N, kStartThreads, 0,
                              (cudaStream_t)stream>>>(*a, *t, g);
    return (int)cudaGetLastError();
}

// the pour's dynamic shared memory for the listed rows in `t` (NZ, NH),
// and the card's limit for one block
int karp_topo_pour_smem(const FfdArgs* a, const TopoArgs* t,
                        long long* bytes, long long* limit) {
    PourSmem m;
    static unsigned char any[16];
    *bytes = (long long)pour_carve(any, a->D, a->Z, a->C, a->P, t->NZ,
                                   t->NH, 2 * t->PMAX, &m);
    int dev = 0, lim = 0;
    int err = (int)cudaGetDevice(&dev);
    if (!err)
        err = (int)cudaDeviceGetAttribute(
            &lim, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    *limit = lim - kPourStaticSmem;
    return err;
}

int karp_topo_pour(const FfdArgs* a, const TopoArgs* t, long long g,
                   void* stream) {
    long long smem = 0, limit = 0;
    int err = karp_topo_pour_smem(a, t, &smem, &limit);
    if (err) return err;
    if (smem > limit || a->Z > 64) return kLayoutTooLarge;
    err = set_smem((const void*)topo_pour_kernel, (size_t)smem);
    if (err) return err;
    topo_pour_kernel<<<1, kPourThreads, (size_t)smem,
                       (cudaStream_t)stream>>>(*a, *t, g);
    return (int)cudaGetLastError();
}

}  // extern "C"
