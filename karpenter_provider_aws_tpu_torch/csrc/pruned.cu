// K6, the pruned scan (the G-axis kernel), as two kernels per group step.
//
// Replaces karpenter_provider_aws_tpu/ops/ffd_jax.py:solve_scan_packed1_pruned
// and solve_scan_packed1_pruned_many (_packed1_pruned_body, _solve_pruned,
// pruned_group_step, CarryP). The base step (ffd_scan.cu) pays O(N*T*D)
// per group for the full [N, T] candidate/headroom pass; this step keeps
// a per-slot capacity UPPER BOUND cap_hint [N, D] in the carry (the max
// allocatable over the slot's pool candidates when it opened, stale-high
// after narrowing), proves most slots full with an O(N*D) bound pass, and
// computes exact candidates and headroom only for the first S
// bound-positive compatible slots in slot order. When pods remain after
// the fill while more than S slots were bound-positive, a sticky bail flag
// tells the caller to re-solve on the host engine, so decisions never
// depend on the pruning.
//
// The lane axis (FfdArgs.L and lane_bytes, plus the five pruned fields'
// own strides): L independent pruned solves of one shape in each launch,
// each lane with its own carry, selection and bail flag.
//
// ffd_pruned_probe (ffd_jax.py:910-946: the bound pass, the compatibility
//   screen, the first S slots in slot order, their exact candidates and
//   headroom; and the group's new-node table): thread-block clusters of
//   CS CTAs of 1,024 threads, NR selecting clusters and TC table
//   clusters a lane (grid x = CS * (NR + TC), the lane on grid y and z by
//   lane_grid, launched by cudaLaunchKernelEx with a cluster dimension of
//   CS). Every pointer comes from the __grid_constant__ parameter moved
//   by the lane's stride; no thread copies the argument struct. Each
//   selecting cluster:
//   - screens every slot: CTA c owns the slot chunk [c*ceil(N/CS), ...),
//     one warp a slot (N = 256 on 8 CTAs: one slot for each of the 32
//     warps). What a lane reads of the group is loaded once before the
//     slots (its admit entry, request value, zone x capacity-type pair,
//     eight F words); a slot's loads are split over the warp's lanes and
//     issued together (pool, alive, one (cap_hint, used) pair a lane per
//     resource, one zone x capacity-type pair a lane, the types & F
//     overlap in 4-byte words when the rows are 4-byte aligned, as
//     T = 812 is). floor((cap_hint - used) / R) >= 1 is cap_hint - used
//     >= R for R > 0, so the bound pass divides nothing. The slot's value,
//     its zone x capacity-type mask when it is flagged and 0 when not, is
//     stored into every CTA of the cluster over distributed shared memory
//     (map_shared_rank), after a split cluster barrier begun at entry has
//     shown that every CTA of the cluster started; one cluster.sync()
//     then publishes them, and no CTA touches another's shared memory
//     after it;
//   - selects in every CTA at once: each warp counts the flags of its
//     words of 32 slots by ballots, then ranks them after the lower
//     warps' counts. Cluster r keeps the ranks i = r (mod NR) below S,
//     kProbeRows a pass, with each row's mask; its rows past n_sel get
//     -1; its CTA 0 writes those entries of sel and, in cluster 0, cnt;
//   - computes its rows: the types in chunks of 32 (chunk k: CTA k mod
//     CS), a warp a (row, chunk), a lane a type whose loads are issued
//     together (the slot's type, F, the offerings as 4-byte words, the
//     allocatable row), cand [S, T] = types & F & an offering in the
//     narrowed zone x capacity-type product, and the exact headroom
//     (headroom() of ffd_common.cuh, each floor quotient from the fp64
//     product with 1 / R, corrected by one and proven by its int64
//     remainder, else floordiv); the warp's maximum goes into ks [S] by a
//     global atomicMax (its cluster's rows zeroed before the barrier).
//     Rows past n_sel write False and 0. (An earlier build took the
//     maxima by 64-bit atomicMax into another CTA's shared memory, before
//     the start barrier below existed, and lost maxima on the card; they
//     go to ks.)
//   The TC = ceil(P * table_blocks(T) / CS) table clusters write the
//   group's new-node table, one chunk of 256 types of one pool a CTA, by
//   ffd_step.cuh new_node_table_block (the code K5's table blocks run):
//   candn/hrn [P, T], the partial caps capn and the opened rows' partial
//   cap_hint rows cap_row, from one shared copy of the lane's arguments.
//   None of it reads the carry, so it runs on other SMs while the
//   selecting clusters screen; they never reach a cluster barrier. CS
//   and NR follow a fixed rule (karp_ffd_pruned_cluster): the first of
//   (8, 4), (8, 2), (8, 1), (4, 1), (2, 1) whose L * (NR + TC) clusters
//   the card holds at once, else (1, 1).
// ffd_pruned_commit: one block per lane, the base commit without
//   minValues floors, with one copy of the lane's arguments in shared
//   memory. k from the selection and the existing rows; the pool-limit
//   caps of the limited pools the group admits and the greedy fill by
//   warp-shuffle scans of several components at once (ffd_step.cuh
//   fill_groups; an all-zero request row gives k = BIG on every selected
//   slot, and eight of them wrap int64 as the reference does), the take
//   total by one warp-reduced sum; the bail flag; the narrowing of the
//   selected takers (no other open slot can take) as one flat pass over
//   the (taker, type) cells after compacting them; the pool accounting;
//   then the new nodes from the table: the inputs staged in shared
//   memory, the pool budgets at once, thread 0's walk over the pools
//   (ffd_step.cuh new_node_scalars) and one pass over every opened row
//   and its cap_hint row. cap_hint is never refreshed from a narrowed
//   mask: that would change which slots the bound pass proves full, and
//   so the bail pattern. Block size: 1,024 threads. At config 7 (N = 256,
//   S <= 64) a 256-thread block has one thread a slot, but the narrowing's
//   flat pass over up to 64 takers x 812 types wants more. On the H100
//   80GB HBM3 (700 W) the two sizes take the same time a launch (19.0 and
//   19.1 us, each build timed twice) and config 7's solves spent less in
//   the kernel on 1,024 (PERF.md, section 6).
//
// What bounds them on this card: at config 7 (N = 256, T = 812, D = 8,
//   S = 64) a step moves ~0.3 MB (types read by the probe's screen, the
//   selected rows' candidates, the table) and does ~1e5 integer
//   operations, a fraction of a microsecond at the card's rates; each
//   launch costs its latency, and each kernel the latency of its chains
//   of dependent loads and barriers and, on 1,024-thread CTAs, its
//   instruction count (clock stamps of an instrumented build found the
//   screen and the rows issue-bound, not waiting on memory). The probe
//   pays one chain a slot, one cluster barrier and few divisions where
//   the two kernels it replaced paid eight chains a warp, a second
//   launch and an int64 division a (type, resource); PERF.md has the
//   times. A later PR would run the G steps as one persistent launch or
//   one CUDA graph.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ffd_step.cuh"

namespace cg = cooperative_groups;

// Outside the unnamed namespace: the exported entry points take it, and a
// type of that namespace would give them internal linkage.
struct PrunedArgs {
    FfdArgs f;        // the base scan's fields; f.cand is [S, T], f.k [N],
                      // f.candn / f.hrn the table's [P, T]
    i64* cap_hint;    // [N, D]
    u8* bail;         // [1]
    int* sel;         // [S] selected slots, slot order, -1 past n_sel
    int* cnt;         // [2] n_sel, n_pos
    i64* ks;          // [S] exact headroom of the selected rows
    i64* capn;        // [P, table_blocks(T)] the table's partial caps
    i64* cap_row;     // [P, table_blocks(T), D] its partial cap_hint rows
    i64 S;
    i64 lane_bytes[7];   // lane strides of cap_hint .. cap_row
    i64 cluster;      // CTAs a cluster in ffd_pruned_probe (1, 2, 4, 8)
    i64 rows;         // its selecting clusters a lane (1, 2, 4)
};

namespace {

constexpr int kProbeThreads = 1024;
constexpr int kProbeRows = 256;  // selected rows a probe pass takes
constexpr int kCommitThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// The arguments of lane `lane`: the base fields by lane_view, the seven
// pruned pointers (consecutive 8-byte members) by their own strides.
__device__ __forceinline__ PrunedArgs pruned_view(const PrunedArgs& p,
                                                  unsigned lane) {
    PrunedArgs v = p;
    v.f = lane_view(p.f, lane);
    unsigned char** q = reinterpret_cast<unsigned char**>(&v.cap_hint);
#pragma unroll
    for (int i = 0; i < 7; ++i)
        if (q[i]) q[i] += lane * p.lane_bytes[i];
    return v;
}

// Lane `lane`'s pointer of an FfdArgs or PrunedArgs field, computed
// from the kernel's __grid_constant__ parameter (read in place, no copy):
// the field moved by its lane stride (a field the lanes share has
// stride 0).
template <typename T>
__device__ __forceinline__ T* lane_ptr(T* p, i64 stride, unsigned lane) {
    return reinterpret_cast<T*>(reinterpret_cast<size_t>(p)
                                + (size_t)(lane * stride));
}
#define LANE_F(x, field, i) lane_ptr(x.f.field, x.f.lane_bytes[i], lane)
#define LANE_P(x, field, i) lane_ptr(x.field, x.lane_bytes[i], lane)

// Positions of the FfdArgs pointer fields the probe reads (their order in
// ffd_common.cuh), and of PrunedArgs' own.
enum : int {
    kA = 0, kAvailZC = 1, kR = 2, kF = 4, kAgz = 5, kAgc = 6,
    kAdmit = 7, kDaemon = 8, kPoolTypes = 9, kPoolAgz = 10, kPoolAgc = 11,
    kUsed = 18, kTypes = 19, kZones = 20, kCt = 21, kPool = 22, kAlive = 23,
    kCand = 26, kHrn = 28, kCandn = 29
};
enum : int { kCapHint = 0, kSel = 2, kCnt = 3, kKs = 4, kCapn = 5,
             kCapRow = 6 };

// The headroom's registers: up to kDR resources of a type's allocatable
// row are loaded at once; a wider D takes the rest in a loop.
constexpr int kDR = 8;
// Offering bytes of a type loaded at once (Z*C beyond it: a loop).
constexpr int kZCR = 16;
// F words (4 types each) a lane of the screen holds: T <= 32 * 4 * kFW
// reads the overlap by words, a wider T by bytes.
constexpr int kFW = 8;

// floor(n / r) for r > 0, exact, with rinv = 1.0 / r: the fp64 product
// n * rinv, floored and moved by one if its int64 remainder says so,
// kept when that remainder then lies in [0, r), else floordiv. With
// r < 2^52 and |n * rinv| < 2^62 the fp64 floor is off by at most ~2^10,
// so (q* - q) * r cannot wrap int64 and a remainder in [0, r) proves
// q = q*; the one step corrects the usual error of one.
__device__ __forceinline__ i64 floordiv_recip(i64 n, i64 r, double rinv) {
    if (r < (1LL << 52)) {
        const double z = floor((double)n * rinv);
        if (fabs(z) < 4.0e18) {
            i64 q = (i64)z;
            i64 rem = wsub(n, wmul(q, r));
            if (rem < 0) {
                --q;
                rem = wadd(rem, r);
            } else if (rem >= r) {
                ++q;
                rem = wsub(rem, r);
            }
            if (rem >= 0 && rem < r) return q;
        }
    }
    return floordiv(n, r);
}

// headroom() of ffd_common.cuh with the first kDR allocatable values in
// `av` (loaded by the caller, the rest from `cap`), on floordiv_recip
// (rinv[d] = 1.0 / R[d] where R[d] > 0): the same value.
__device__ __forceinline__ i64 headroom_regs(const i64* av, const i64* cap,
                                             const i64* base, const i64* R,
                                             const double* rinv, int D) {
    i64 m = KARP_BIG;
#pragma unroll
    for (int d = 0; d < kDR; ++d) {
        if (d < D && R[d] > 0) {
            const i64 q = floordiv_recip(wsub(av[d], base[d]), R[d],
                                         rinv[d]);
            m = q < m ? q : m;
        }
    }
    for (int d = kDR; d < D; ++d) {
        if (R[d] > 0) {
            const i64 q = floordiv_recip(wsub(cap[d], base[d]), R[d],
                                         rinv[d]);
            m = q < m ? q : m;
        }
    }
    return m < 0 ? 0 : m;
}

// Whether the offerings row `row` [ZC] has an available offering among
// the zone x capacity-type pairs of `mask` (bit z*C + c; ZC <= 64); its
// first kZCR bytes are in `ab` (loaded by the caller).
__device__ __forceinline__ bool offer_regs(const u8* ab, const u8* row,
                                           u64 mask, i64 ZC) {
    unsigned hit = 0;
#pragma unroll
    for (int q = 0; q < kZCR; ++q) hit |= (unsigned)((mask >> q) & 1) & ab[q];
    for (i64 q = kZCR; q < ZC; ++q)
        hit |= (unsigned)((mask >> q) & 1) & row[q];
    return hit != 0;
}

// The zone x capacity-type mask (bit z*C + c) of rows x and y, one pair a
// lane: zx[z] & zy[z] & cx[c] & cy[c] (ZC <= 64). Warp-collective.
__device__ __forceinline__ u64 zc_mask(const u8* zx, const u8* zy,
                                       const u8* cx, const u8* cy, i64 Z,
                                       i64 C) {
    const int wl = threadIdx.x & 31;
    u64 mask = 0;
    for (i64 q0 = 0; q0 < Z * C; q0 += 32) {
        const i64 q = q0 + wl;
        bool b = false;
        if (q < Z * C) {
            const i64 z = q / C, c = q % C;
            b = (zx[z] & zy[z] & cx[c] & cy[c]) != 0;
        }
        mask |= (u64)__ballot_sync(kFull, b) << q0;
    }
    return mask;
}

// The probe's dynamic shared memory: R [D], the table's column maxima
// [D], the reciprocals 1.0 / R [D] (doubles), then the selecting CTAs'
// per-slot values fl [N]
// (each slot's zone x capacity-type mask when it is flagged, else 0;
// every CTA of the cluster holds all N), a pass's zone x capacity-type
// masks zcm [kProbeRows] (in a table CTA: new_node_table_block's 33
// reduction words) and the same as byte lanes zcb [kProbeRows, 4] (bit q
// of the mask as byte q, for Z*C <= 16), and its slots rows [kProbeRows].
struct ProbeSmem {
    i64 *R, *colmax;
    double* rinv;
    u64 *fl, *zcm;
    unsigned* zcb;
    int* rows;
};

__host__ __device__ __forceinline__ size_t probe_smem(i64 N, i64 D) {
    return (size_t)(3 * D + N + kProbeRows) * sizeof(i64)
        + (size_t)kProbeRows * (4 * sizeof(unsigned) + sizeof(int));
}

__device__ __forceinline__ ProbeSmem probe_at(i64* w, int N, int D) {
    ProbeSmem m;
    m.R = w;
    m.colmax = m.R + D;
    m.rinv = (double*)(m.colmax + D);
    m.fl = (u64*)(m.rinv + D);
    m.zcm = m.fl + N;
    m.zcb = (unsigned*)(m.zcm + kProbeRows);
    m.rows = (int*)(m.zcb + 4 * kProbeRows);
    return m;
}

// ffd_pruned_probe (file comment). The lane's first NR = args.rows
// clusters of CS CTAs each screen every slot and select; cluster r then
// computes the selected rows i = r (mod NR). The lane's further clusters
// write the table, one chunk a CTA.
__global__ void __launch_bounds__(kProbeThreads)
ffd_pruned_probe_kernel(const __grid_constant__ PrunedArgs args, i64 g64) {
    extern __shared__ i64 pdyn[];
    __shared__ FfdArgs ta;                    // a table CTA's lane view
    __shared__ int npos_sh[1];
    __shared__ int wcnt[kProbeThreads / 32];   // flags a warp's words hold
    const unsigned lane = grid_lane();
    // The (y, z) grid's spare lanes. A cluster spans grid x only, so all
    // its CTAs share one lane and leave together: the cluster barrier
    // below is never reached by part of a cluster.
    if (lane >= args.f.L) return;
    cg::cluster_group cl = cg::this_cluster();
    const int CS = (int)cl.num_blocks(), NR = (int)args.rows;
    const int g = (int)g64;
    const int N = (int)args.f.N, T = (int)args.f.T, D = (int)args.f.D;
    const int Z = (int)args.f.Z, C = (int)args.f.C, P = (int)args.f.P;
    const int E = (int)args.f.E, S = (int)args.S, ZC = Z * C;
    const int tid = threadIdx.x, wl = tid & 31, warp = tid >> 5;
    constexpr int nwarps = kProbeThreads / 32;
    const ProbeSmem m = probe_at(pdyn, N, D);
    const int ci = (int)blockIdx.x / CS;   // the cluster of the lane
    if (ci >= NR) {                        // a table cluster: chunk j
        const int TB = (int)table_blocks(T), j = blockIdx.x - NR * CS;
        if (j >= P * TB) return;
        if (tid == 0) ta = lane_view(args.f, lane);
        __syncthreads();
        new_node_table_block(ta, g, j / TB, j % TB, ta.candn + j / TB * T,
                             ta.hrn + j / TB * T,
                             LANE_P(args, capn, kCapn) + j,
                             LANE_P(args, cap_row, kCapRow) + j * D,
                             (i64*)m.zcm, (long long*)m.colmax);
        return;
    }
    // Distributed shared memory may be written only once every CTA of the
    // cluster has started: arrive here, wait just before the screen's
    // first store into another CTA (the group's loads run in between).
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    const int rank = (int)cl.block_rank();
    const i64* R = LANE_F(args, R, kR) + g * D;
    const u8* Fg = LANE_F(args, F, kF) + g * T;
    const u8* agz = LANE_F(args, agz, kAgz) + g * Z;
    const u8* agc = LANE_F(args, agc, kAgc) + g * C;
    const u8* admit = LANE_F(args, admit, kAdmit) + g * P;
    const i64* used = LANE_F(args, used, kUsed);
    const u8* types = LANE_F(args, types, kTypes);
    const u8* zones = LANE_F(args, zones, kZones);
    const u8* ct = LANE_F(args, ct, kCt);
    const int* poolv = LANE_F(args, pool, kPool);
    const u8* alivev = LANE_F(args, alive, kAlive);
    const i64* cap_hint = LANE_P(args, cap_hint, kCapHint);
    i64* ks = LANE_P(args, ks, kKs);
    if (rank == 0)   // this cluster's rows of ks, for the atomics below
        for (int i = ci + NR * tid; i < S; i += NR * kProbeThreads) ks[i] = 0;

    // ---- bound pass + compatibility screen: one warp a slot -------------
    // What a lane reads of the group is loaded once: its admit entry,
    // request value, zone x capacity-type pair and F words. A slot's
    // loads are split over the warp's lanes and issued together, then
    // reduced; `ok` is warp-uniform. floor((cap_hint - used) / R) >= 1 is
    // cap_hint - used >= R for R > 0: no division. The slot's value (its
    // zone x capacity-type mask when flagged, else 0) goes to every CTA
    // of the cluster.
    const int cchunk = (N + CS - 1) / CS;
    const int c0 = rank * cchunk < N ? rank * cchunk : N;
    const int c1 = c0 + cchunk < N ? c0 + cchunk : N;
    const int zq = ZC <= 32 && wl < ZC ? wl / C : 0;
    const int cq = ZC <= 32 && wl < ZC ? wl % C : 0;
    const u8 adm = wl < P ? admit[wl] : 0;
    const i64 r = wl < D ? R[wl] : 0;
    const bool gpair = ZC <= 32 && wl < ZC && (agz[zq] & agc[cq]) != 0;
    const bool words = (T & 3) == 0 && ((size_t)types & 3) == 0
        && ((size_t)Fg & 3) == 0 && T <= 32 * 4 * kFW;
    unsigned fw[kFW];
#pragma unroll
    for (int k = 0; k < kFW; ++k)
        fw[k] = words && (wl + 32 * k) * 4 < T
            ? ((const unsigned*)Fg)[wl + 32 * k] : 0;
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    for (int s = c0 + warp; s < c1; s += nwarps) {
        const int pool = poolv[s];
        const bool alive = alivev[s];
        const i64 ch = wl < D ? cap_hint[s * D + wl] : 0;
        const i64 us = wl < D ? used[s * D + wl] : 0;
        const u8 zs = gpair ? zones[s * Z + zq] : 0;
        const u8 cs = gpair ? ct[s * C + cq] : 0;
        bool hit = false;
        if (words) {   // 4 types a load: the rows' bytes are 0 or 1
            const unsigned* tw = (const unsigned*)(types + s * T);
#pragma unroll
            for (int k = 0; k < kFW; ++k)
                if ((wl + 32 * k) * 4 < T)
                    hit |= (tw[wl + 32 * k] & fw[k]) != 0;
        } else {
            for (int t = wl; t < T; t += 32)
                hit |= (types[s * T + t] & Fg[t]) != 0;
        }
        bool pos = !(r > 0 && wsub(ch, us) < r);
        for (int d = wl + 32; d < D; d += 32)
            pos &= !(R[d] > 0
                     && wsub(cap_hint[s * D + d], used[s * D + d]) < R[d]);
        u64 mk;
        if (ZC <= 32) {
            mk = __ballot_sync(kFull, gpair && (zs & cs) != 0);
        } else if (ZC <= 64) {
            mk = zc_mask(zones + s * Z, agz, ct + s * C, agc, Z, C);
        } else {   // the any-overlaps alone; the rows take offering_ok
            bool zo = false, co = false;
            for (int z = wl; z < Z; z += 32)
                zo |= (zones[s * Z + z] & agz[z]) != 0;
            for (int c = wl; c < C; c += 32)
                co |= (ct[s * C + c] & agc[c]) != 0;
            mk = __any_sync(kFull, zo) & __any_sync(kFull, co);
        }
        const int pc = pool > P - 1 ? P - 1 : (pool < 0 ? 0 : pool);
        const u8 adm_p = __shfl_sync(kFull, adm, pc & 31);
        const bool ok = (__all_sync(kFull, pos) & __any_sync(kFull, hit))
            && mk && s >= E && alive && pool >= 0
            && (P <= 32 ? adm_p : admit[pc]);
        if (wl < CS)
            cl.map_shared_rank(m.fl, (unsigned)wl)[s] = ok ? mk : 0;
    }
    for (int d = tid; d < D; d += kProbeThreads) {
        m.R[d] = R[d];
        m.rinv[d] = R[d] > 0 ? 1.0 / (double)R[d] : 0.0;
    }
    cl.sync();   // every slot's value is in every CTA of the cluster; its
                 // rows of ks are 0. No CTA touches another's shared
                 // memory after this barrier.

    // ---- the selection and this cluster's rows, in passes ---------------
    // the flagged slots ranked by ballots and popcounts over the values;
    // cluster ci takes the rows i = ci + NR * jj, kProbeRows of them (jj)
    // a pass. A row's candidates and headroom are split over the cluster
    // in chunks of 32 types (chunk k: CTA k mod CS), a warp a (row,
    // chunk), the row's maximum into ks by global atomics.
    u8* candv = LANE_F(args, cand, kCand);
    int* sel = LANE_P(args, sel, kSel);
    const u8* avail = LANE_F(args, avail_zc, kAvailZC);
    const i64* A = LANE_F(args, A, kA);
    const int nk = (T + 31) / 32;                              // chunks
    const int nu = nk > rank ? (nk - rank + CS - 1) / CS : 0;   // this CTA's
    const int nrow = ci < S ? (S - ci + NR - 1) / NR : 0;     // its rows
    const bool zwords = ZC <= 16 && (ZC & 3) == 0 && ((size_t)avail & 3) == 0;
    const int nwd = (N + 31) / 32;                         // slot words
    const int wpw = (nwd + nwarps - 1) / nwarps;           // a warp's
    const int lgNR = NR == 4 ? 2 : NR == 2 ? 1 : 0;
    for (int q0 = 0; q0 < nrow; q0 += kProbeRows) {
        const int nb = nrow - q0 < kProbeRows ? nrow - q0 : kProbeRows;
        // each warp counts its contiguous words of 32 slots, then ranks
        // their flags after the lower warps' counts
        const int wa = warp * wpw;
        const int wb = wa + wpw < nwd ? wa + wpw : nwd;
        int cnt = 0;
        for (int w = wa; w < wb; ++w) {
            const int s = 32 * w + wl;
            cnt += __popc(__ballot_sync(kFull, s < N && m.fl[s] != 0));
        }
        if (wl == 0) wcnt[warp] = cnt;
        __syncthreads();
        int before = wl < warp ? wcnt[wl] : 0, all = wcnt[wl];
        for (int off = 16; off > 0; off >>= 1) {
            before += __shfl_xor_sync(kFull, before, off);
            all += __shfl_xor_sync(kFull, all, off);
        }
        for (int w = wa; w < wb; ++w) {
            const int s = 32 * w + wl;
            const u64 v = s < N ? m.fl[s] : 0;
            const unsigned bal = __ballot_sync(kFull, v != 0);
            const int rk = before + __popc(bal & ((1u << wl) - 1));
            const int jj = (rk >> lgNR) - q0;
            if (v && rk < S && (rk & (NR - 1)) == ci && jj >= 0 && jj < nb) {
                m.rows[jj] = s;
                m.zcm[jj] = v;
                unsigned* zb = m.zcb + 4 * jj;   // the mask as byte lanes
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    unsigned x = 0;
#pragma unroll
                    for (int b = 0; b < 4; ++b)
                        x |= (unsigned)((v >> (4 * k + b)) & 1) << (8 * b);
                    zb[k] = x;
                }
            }
            before += __popc(bal);
        }
        if (tid == 0) npos_sh[0] = all;
        for (int jj = tid; jj < nb; jj += kProbeThreads)   // past n_sel
            if (ci + NR * (q0 + jj) >= all) m.rows[jj] = -1;
        __syncthreads();
        const int npos = npos_sh[0], nsel = npos < S ? npos : S;
        if (rank == 0) {
            for (int jj = tid; jj < nb; jj += kProbeThreads)
                sel[ci + NR * (q0 + jj)] = m.rows[jj];
            if (tid == 0 && ci == 0 && q0 == 0) {
                int* cnt = LANE_P(args, cnt, kCnt);
                cnt[0] = nsel;
                cnt[1] = npos;
            }
        }
        for (int u = warp; u < nb * nu; u += nwarps) {
            const int jj = u / nu;
            const int t = (rank + (u - jj * nu) * CS) * 32 + wl;
            const bool in = t < T;
            const int s = m.rows[jj];              // warp-uniform
            const int i = ci + NR * (q0 + jj);
            u8* cand = candv + (size_t)i * T;
            if (s < 0) {                           // past the selection
                if (in) cand[t] = 0;
                continue;
            }
            // every load of the cell at once: the slot's type, F, the
            // offerings, the allocatable
            u8 tf = 0, ab[kZCR];
            unsigned aw[4];
            i64 av[kDR];
            if (in) tf = types[s * T + t] & Fg[t];
            if (zwords) {
#pragma unroll
                for (int w = 0; w < 4; ++w)
                    aw[w] = in && 4 * w < ZC
                        ? ((const unsigned*)(avail + t * ZC))[w] : 0;
            } else {
#pragma unroll
                for (int q = 0; q < kZCR; ++q)
                    ab[q] = in && q < ZC ? avail[t * ZC + q] : 0;
            }
#pragma unroll
            for (int d = 0; d < kDR; ++d)
                av[d] = in && d < D ? A[t * D + d] : 0;
            i64 km = 0;
            if (in) {
                bool c = tf != 0;
                if (c) {
                    if (zwords) {
                        const unsigned* zb = m.zcb + 4 * jj;
                        c = ((aw[0] & zb[0]) | (aw[1] & zb[1])
                             | (aw[2] & zb[2]) | (aw[3] & zb[3])) != 0;
                    } else if (ZC <= 64) {
                        c = offer_regs(ab, avail + t * ZC, m.zcm[jj], ZC);
                    } else {
                        c = offering_ok(lane_view(args.f, lane), g, s, t);
                    }
                }
                cand[t] = c;
                if (c)
                    km = headroom_regs(av, A + t * D, used + s * D, m.R,
                                       m.rinv, D);
            }
            for (int off = 16; off > 0; off >>= 1) {
                const i64 o = __shfl_xor_sync(kFull, km, off);
                km = o > km ? o : km;
            }
            if (wl == 0 && km > 0)
                atomicMax((long long*)&ks[i], (long long)km);
        }
        __syncthreads();   // the next pass rewrites the rows
    }
}

// Dynamic shared words of the commit: new_node_scalars' output and its
// staged inputs, the per-pool takes, the takers' staged used rows, then
// ints: the takers' selected rows and slots, the pool-cap components.
__host__ __device__ __forceinline__ size_t pruned_commit_smem(i64 P, i64 D,
                                                              i64 S) {
    return (size_t)(nn_words(P) + nn_stage_words(P, D, 1) + P
                    + kNarrowRows * D) * sizeof(i64)
        + (size_t)(2 * S + P) * sizeof(int);
}

__global__ void __launch_bounds__(kCommitThreads)
ffd_pruned_commit_kernel(PrunedArgs args, i64 g) {
    extern __shared__ i64 dyn[];
    __shared__ u64 scan[33 * kScanW];
    __shared__ i64 bud[kScanW];
    __shared__ unsigned long long taken[1];
    __shared__ int counts[2];      // pool-cap components, takers
    __shared__ PrunedArgs sp;      // the lane's view, one copy a block
    if (threadIdx.x == 0) sp = pruned_view(args, blockIdx.x);
    __syncthreads();
    const PrunedArgs& p = sp;
    const FfdArgs& a = p.f;
    const i64 N = a.N, T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const i64 E = a.E, S = p.S;
    const i64* R = a.R + g * D;
    const int tid = threadIdx.x;
    const i64 chunk = (N + kCommitThreads - 1) / kCommitThreads;
    const i64 lo = tid * chunk < N ? tid * chunk : N;
    const i64 hi = lo + chunk < N ? lo + chunk : N;
    const i64 nsel = p.cnt[0];
    i64* sc = dyn;
    const NewNodeStage stage = nn_stage_at(sc + nn_words(P), P, D, 1);
    unsigned long long* tbp = (unsigned long long*)(
        sc + nn_words(P) + nn_stage_words(P, D, 1));
    i64* tu = (i64*)(tbp + P);                    // [kNarrowRows, D]
    int* tk = (int*)(tu + kNarrowRows * D);       // takers' selected rows
    int* tks = tk + S;                            // and their slots
    int* comp = tks + S;                          // pool-cap components

    // ---- k: the existing rows' headroom, then the selected rows' --------
    for (i64 s = tid; s < N; s += kCommitThreads) {
        a.k[s] = (s < E && a.alive[s] && a.ex_compat[g * E + s])
            ? headroom(a.ex_alloc + s * D, a.used + s * D, R, D) : 0;
    }
    for (i64 q = tid; q < P; q += kCommitThreads) tbp[q] = 0;
    cap_components(a, g, 1, comp, &counts[0]);
    if (tid == 0) {
        counts[1] = 0;
        taken[0] = 0;
    }
    __syncthreads();
    for (i64 i = tid; i < nsel; i += kCommitThreads) a.k[p.sel[i]] = p.ks[i];
    __syncthreads();

    // ---- pool caps and the greedy fill; k[s] becomes take[s] ------------
    BlockExchange none;
    fill_groups<kScanW, 1>(a, g, 0, 1, lo, hi, comp, counts[0], scan, bud,
                           none, taken);
    const i64 n_rem = wsub(a.n[g], (i64)taken[0]);
    // pruning was insufficient: pods remain and an unselected bound-
    // positive slot existed (the scan would have consulted it next)
    if (tid == 0 && p.cnt[1] > S && n_rem > 0) p.bail[0] = 1;

    // ---- narrowing of the selected takers + pool accounting -------------
    for (i64 s = tid; s < N; s += kCommitThreads) {      // a zero take changes nothing
        const i64 t = a.k[s];
        if (t)
            for (i64 d = 0; d < D; ++d)
                a.used[s * D + d] = wadd(a.used[s * D + d], wmul(t, R[d]));
    }
    for (i64 i = tid; i < nsel; i += kCommitThreads) {
        const i64 s = p.sel[i];
        if (!(a.k[s] > 0)) continue;
        for (i64 z = 0; z < Z; ++z) a.zones[s * Z + z] &= a.agz[g * Z + z];
        for (i64 c = 0; c < C; ++c) a.ct[s * C + c] &= a.agc[g * C + c];
        const int pool = a.pool[s];
        atomicAdd(&tbp[pool > P - 1 ? P - 1 : pool],
                  (unsigned long long)a.k[s]);
        const int j = atomicAdd(&counts[1], 1);
        tk[j] = (int)i;
        tks[j] = (int)s;
    }
    __syncthreads();
    nn_stage(a, g, 1, p.capn, (const i64*)tbp, (const i64*)taken, stage);
    narrow_cells(a, counts[1], [&](int j) { return (i64)tks[j]; },
                 [&](int j, i64, i64 t) {
                     return __ldg(&a.cand[tk[j] * T + t]) != 0;
                 }, tu);

    // ---- new nodes from the table: the scalars, then one pass -----------
    new_node_scalars(stage, 1, P, D, N, E, sc, a.leftover + (g - a.G0));
    new_node_rows(a, g, sc, a.candn, a.hrn, p.cap_row, p.cap_hint, 0, N,
                  tid, kCommitThreads);
    for (i64 s = tid; s < N; s += kCommitThreads) new_node_take(a, a.k, g, sc, s);
    for (i64 i = tid; i < P * D; i += kCommitThreads) a.pool_used[i] = stage.pu[i];
    if (tid == 0) a.num_nodes[0] = (int)stage.nn[0];
}

int set_smem(const void* fn, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Clusters of one lane in the probe: nr selecting ones, then the table's
// P * table_blocks(T) chunks on cs CTAs each.
i64 probe_clusters(const PrunedArgs* p, i64 cs, i64 nr) {
    return nr + (p->f.P * table_blocks(p->f.T) + cs - 1) / cs;
}

// The probe's launch on clusters of cs CTAs, nr of them selecting a lane;
// `attr` holds the cluster dimension the configuration points at.
cudaLaunchConfig_t probe_config(const PrunedArgs* p, i64 cs, i64 nr,
                                cudaLaunchAttribute* attr,
                                cudaStream_t stream) {
    dim3 grid((unsigned)(cs * probe_clusters(p, cs, nr)));
    lane_grid(p->f.L, &grid);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kProbeThreads, 1, 1);
    cfg.dynamicSmemBytes = probe_smem(p->f.N, p->f.D);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

}  // namespace

extern "C" {

int karp_ffd_pruned_probe(const PrunedArgs* p, long long g, void* stream) {
    const i64 cs = p->cluster, nr = p->rows;
    if ((cs != 1 && cs != 2 && cs != 4 && cs != 8)
        || (nr != 1 && nr != 2 && nr != 4))
        return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = probe_config(p, cs, nr, attr,
                                                (cudaStream_t)stream);
    int err = set_smem((const void*)ffd_pruned_probe_kernel,
                       cfg.dynamicSmemBytes);
    if (err) return err;
    err = (int)cudaLaunchKernelEx(&cfg, ffd_pruned_probe_kernel, *p, (i64)g);
    if (err) return err;
    return (int)cudaGetLastError();
}

// The probe's shape for the lanes of `p`, as cs + 16 * nr: the first of
// (8, 4), (8, 2), (8, 1), (4, 1), (2, 1) CTAs a cluster and selecting
// clusters a lane whose L * probe_clusters clusters the card holds at
// once; (1, 1) when none does. Negative: a CUDA error, negated.
int karp_ffd_pruned_cluster(const PrunedArgs* p) {
    const int shapes[5][2] = {{8, 4}, {8, 2}, {8, 1}, {4, 1}, {2, 1}};
    for (const auto& sh : shapes) {
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t cfg = probe_config(p, sh[0], sh[1], attr,
                                                    0);
        int err = set_smem((const void*)ffd_pruned_probe_kernel,
                           cfg.dynamicSmemBytes);
        if (err) return -err;
        int n = 0;
        err = (int)cudaOccupancyMaxActiveClusters(
            &n, (const void*)ffd_pruned_probe_kernel, &cfg);
        if (err) return -err;
        if (n >= p->f.L * probe_clusters(p, sh[0], sh[1]))
            return sh[0] + 16 * sh[1];
    }
    return 1 + 16;
}

int karp_ffd_pruned_commit(const PrunedArgs* p, long long g, void* stream) {
    const size_t smem = pruned_commit_smem(p->f.P, p->f.D, p->S);
    const unsigned L = (unsigned)p->f.L;
    cudaStream_t st = (cudaStream_t)stream;
    const int err = set_smem((const void*)ffd_pruned_commit_kernel, smem);
    if (err) return err;
    ffd_pruned_commit_kernel<<<L, kCommitThreads, smem, st>>>(*p, g);
    return (int)cudaGetLastError();
}


}  // extern "C"
