// K10, the sharded FFD scan: the per-rank kernels of one step, launched
// between torch.distributed collectives (parallel/mesh.py drives them).
//
// Replaces karpenter_provider_aws_tpu/ops/ffd_jax.py:_solve with axis="tp"
// (the type-parallel mesh, parallel/mesh.py:614 solve_scan_sharded) and
// _solve_dp / dp_group_step / _fill_phase_dp (:571, :534, :488; the pods x
// types mesh, parallel/mesh.py:377 solve_scan_sharded2), with their
// collectives _axis_max (:109), _dp_prefix (:469) and _dp_sum (:482). On
// the TPU one shard_map program runs every shard and XLA inserts pmax,
// all_gather and psum inside it; here each rank is a process that runs
// these kernels on its own shard and the collectives run between launches
// on torch.distributed (NCCL, or gloo).
//
// A rank holds the types [tp*Tl, (tp+1)*Tl) and the slots [dp*Nl,
// (dp+1)*Nl) (global slot id = slot0 + local row). MeshArgs.f is the
// shard's FfdArgs: T = Tl, N = Nl, E = 0 (the existing-row overlay is
// mesh_fill's, by global slot id), the existing tables cut to the local
// rows (ex_alloc [Nl, D], ex_compat [G, Nl]) and the minValues pairs
// localized to the shard's types (a pair of another shard's type points
// at the dump value V). The step bodies are ffd_step.cuh's and
// ffd_cluster.cuh's, reused with the shard's type window and a global
// slot window (SlotWindow); nothing here repeats them.
//
// mesh_new_caps (once per solve): the local new-node cap of every (group,
//   pool) over the rank's types, and with minValues floors the per-value
//   maxima h1n [G, P, K, V]. The caps read only A, daemon, R, F,
//   pool_types and the offerings (ffd_jax.py:388-400), never the carry,
//   so ONE tp all_reduce(MAX) of this [G, P(1 + K*V)] buffer per solve
//   replaces the reference's P pmax (and P h1n pmax) of every step. A
//   (group, pool) is a thread-block cluster of X CTAs of 128 threads
//   (karp_mesh_caps_cluster: 8 at Tl = 812, 4 at 406, 2 at 203), CTA r
//   over a chunk of ceil(Tl / X) types, a type a thread: R, the daemon
//   row, R's reciprocals and the (group, pool) zone x capacity-type pair
//   word staged once a CTA; each type's loads issued at once (the first
//   pass's before the staging barrier) and its
//   offering test one AND of its word (offer_word) with the pair word
//   (new_node_cand's loops past kOfferBits pairs), its quotients by the
//   reciprocals (head_staged, exact); the partial maxima meet in CTA 0's
//   shared memory over the cluster (distributed shared memory), so one
//   launch writes caps with no memset and no second pass. With floors one
//   CTA a (group, pool) (X = 1): the per-value maxima by atomicMax in its
//   shared memory over the pairs.
// mesh_slot_headroom (per step), K == 0: steps 1-3 on the shard on warp
//   rows (ffd_step.cuh slot_headroom_warps, K2's k2_layout at one lane
//   of Nl rows: 8 warps a row at Nl = 256 and 1,024, 4 at K11's 2,112),
//   and on the same grid P * table_blocks(Tl) CTAs writing the group's
//   new-node table over the rank's types (new_node_table_block: candn /
//   hrn [P, Tl] and each block's partial cap in capn [P, TB]), which
//   reads no carry; the commit reads the table, and its caps are the
//   tp-reduced ones of mesh_new_caps, so the partial caps are scratch (a
//   check holds their max to the rank's own cap). k [Nl] is then the max
//   over the local types, and ONE tp all_reduce(MAX) of it replaces the
//   reference's pmax of k (:309). K > 0: one CTA a slot row
//   (slot_headroom_block), then h1 [Nl, K, V] after k in one buffer, so
//   the same all_reduce also replaces the pmax of h1 (:319); no table.
// mesh_fill (per step, one CTA of fill_threads(Nl) threads, `phase`): (a)
//   the existing-row overlay by global slot id (slots < E, :511-514), the
//   minValues cap of the reduced h1, and the rank's per-pool sums of k
//   (one dp all_gather of [P] gives every pool's earlier-shard prefix:
//   the P pool prefixes of :516-523 sit on disjoint rows and read only the
//   step's starting pool_used); (b) the pool caps (the limited pools the
//   group admits, listed by each warp's lanes with a ballot, their
//   prefixes from one W-wide scan plus those earlier prefixes) and the
//   rank's sum of the capped k (the second dp all_gather); (c) the greedy fill and the rank's [P + 1] take-by-pool
//   sums, whose dp all_reduce(SUM) replaces the reference's two psums
//   (:556 and :560; the pods placed are the sum of all P + 1). `phase` 3
//   runs (a)-(c) in one launch with no earlier shards (ndp == 1). A
//   thread holds a contiguous run of rows in registers (fill_rows(Nl),
//   up to kFillRows a tile; a build of the kernel for each count), loaded
//   once a launch; each phase is one pass over them (its prefixes by
//   W-wide scans of one barrier each, the last tile's totals carried
//   into the next), k is stored once, and the sums go through warp
//   shuffles into each warp's shared partials and one barrier.
// mesh_commit (per step), K == 0: the base group commit's cluster form
//   (ffd_scan.cu, ffd_cluster.cuh) over the rank's slot window, on a
//   cluster of CS CTAs of NT threads (K2's rule at one lane,
//   karp_ffd_k2_cluster: 8 x 512 at these shapes), CTA r owning the
//   local rows [r*ceil(Nl/CS), ...): each CTA's slot pass of the
//   narrowing (narrow_slots: used, zones, capacity types, its takers
//   compacted); after a cluster barrier the takers' (slot, type) cells
//   dealt round-robin over the cluster (deal_takers, narrow_cells); then
//   the new nodes from the table (commit_tail with a SlotWindow): CTA 0
//   stages the inputs with the tp-reduced caps, pool_used plus the
//   dp-reduced take by pool times R and n minus its sum, its thread 0
//   walks the pools at global slot ids with the true N and E, and the
//   whole cluster writes the opened rows that fall in the window; then
//   the group's takes row and leftover. K > 0: one CTA runs the block
//   bodies: each pool's cap min(the reduced cap, the minValues cap of the
//   reduced h1n) (the reference's per-pool cap, :400-404), the narrowing
//   slot by slot (commit_narrow with the reduced take by pool) and the
//   new-node phase with its T-pass pool by pool (commit_new_nodes with a
//   SlotWindow; row 0 of the table's buffers is its scratch).
//
// So a step costs the reference 1 + P tp pmax, P + 1 dp all_gather and 2
// dp psum; here 1 tp all_reduce, 2 dp all_gathers and 1 dp all_reduce
// (tp mesh: 1 tp all_reduce), with the same bytes out.
//
// What bounds them on this card: the shard's bytes over 3.35 TB/s are a
// fraction of a microsecond (about one for the headroom's candidate rows
// at Nl = 4,224); each launch costs its latency, and a step's collectives
// cost more than its kernels. The fill reads and writes a few words a
// row: its cost is its launch, its first loads and its barriers (one to
// three a phase; a 1,024-thread block running P block reductions in phase
// (a), one block scan a limited pool in (b) and a global atomic a row in
// (c) took 7-50 us; PERF.md has the stamps). The commit's cost is its
// chain of cluster barriers and dependent loads and, with many takers,
// the dealt cells:
// clock stamps at the 500k cell (Nl = 1,024, 571 takers) put about 48 us
// of its ~117 in each CTA's cells and 33 in the new-node tail (PERF.md).
// The headroom's warp rows take 80 registers a thread (one CTA a row took
// 48), so an SM holds three of its CTAs, not five, and at Nl = 1,024 and
// 4,224 its rows take more waves than one CTA a row did (17.1 against
// 12.6 us, 32.6 against 16.1); capped at 64 registers it spills and was
// slower still (PERF.md).
#include <cuda_runtime.h>

#include "ffd_cluster.cuh"

// The arguments of the four kernels (mirrored by ops/mesh_cuda.py
// _MeshArgs; every field 8 bytes wide). f.candn / f.hrn are the group's
// new-node table [P, Tl] (K > 0: row 0 is the commit's scratch).
struct MeshArgs {
    FfdArgs f;            // the rank's shard (see above)
    i64* h1;              // [Nl, K, V] per-value maxima of headroom + 1
    i64* caps;            // [G, P] caps, then [G, P, K, V] h1n (max over
                          // the type shards in place between launches)
    i64* red;             // [P + 1] the rank's sums of a fill phase
    const i64* before;    // [P + 1] earlier shards' sums: pools, then fill
    const i64* tbp;       // [P + 1] take-by-pool summed over the shards
    i64 slot0;            // global id of local row 0
    i64 N;                // true slot count E + n_max
    i64 E;                // existing rows
    i64* capn;            // [P, table_blocks(Tl)] the table's partial caps
    i64 cluster;          // CTAs of mesh_commit (1, 2, 4, 8; K > 0: 1)
    i64 threads;          // its threads a CTA (256, 512)
};

namespace {

namespace cg = cooperative_groups;

// mesh_new_caps: threads a CTA (a type a thread a pass) and the most
// CTAs of a (group, pool), a thread-block cluster over the type axis
constexpr int kCapsThreads = 128;
constexpr int kCapsCluster = 8;
constexpr int kPhaseAll = 3;

int set_smem(const void* fn, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The value at rank f-1 (descending) of h1[0..V); 1 <= f <= V.
__device__ __forceinline__ i64 fth_value(const i64* h1, i64 V, i64 f) {
    for (i64 v = 0; v < V; ++v) {
        i64 x = h1[v], gt = 0, ge = 0;
        for (i64 u = 0; u < V; ++u) {
            gt += h1[u] > x;
            ge += h1[u] >= x;
        }
        if (gt <= f - 1 && f - 1 < ge) return x;
    }
    return 0;
}

// The minValues cap of per-value maxima h1 [K, V] under floors f[K], on
// one thread (mv_cap_from over fth_value).
__device__ __forceinline__ i64 mv_cap_serial(const i64* h1, const i64* f,
                                             i64 K, i64 V) {
    i64 cap = KARP_BIG;
    for (i64 kk = 0; kk < K; ++kk) {
        const i64 fk = f[kk];
        const i64 c = fk <= 0 ? KARP_BIG : fk > V ? -1
            : fth_value(h1 + kk * V, V, fk) - 1;
        cap = c < cap ? c : cap;
    }
    return cap < 0 ? 0 : cap;
}

// What the new-node test of type t reads for group g in pool pi, loaded
// with every load issued before its first use: its F and pool bytes
// (ANDed), its allocatable row (D <= kHeadDims) and its offering word
// (offer_word; Z*C <= kOfferBits).
struct TypeRow {
    i64 t;
    unsigned fp;
    u64 ow;
    i64 av[kHeadDims];
};

__device__ __forceinline__ TypeRow type_row(const FfdArgs& a, i64 g, i64 pi,
                                            i64 t) {
    TypeRow r;
    const i64 T = a.T, D = a.D, ZC = a.Z * a.C;
    const bool staged = D <= kHeadDims;
    r.t = t;
    r.fp = ld_pin_u8(a.F + g * T + t) & ld_pin_u8(a.pool_types + pi * T + t);
#pragma unroll
    for (int d = 0; d < kHeadDims; ++d)
        r.av[d] = staged && d < D ? ld_pin_i64(a.A + t * D + d) : 0;
    r.ow = ZC <= kOfferBits ? offer_word(a.avail_zc + t * ZC, ZC) : 0;
    return r;
}

// The new-node headroom of a TypeRow, or -1 where its type is no
// candidate (new_node_cand): the offering test one AND of the type's
// word with the (group, pool) pair word zm (new_node_cand past
// kOfferBits pairs); the quotients by the CTA's reciprocals of R
// (head_staged) for D <= kHeadDims, the global rows otherwise.
__device__ __forceinline__ i64 type_hr(const FfdArgs& a, i64 g, i64 pi,
                                       const TypeRow& r, u64 zm,
                                       const i64* sR, const i64* sdm,
                                       const double* srb) {
    const i64 D = a.D, t = r.t;
    const bool off = a.Z * a.C <= kOfferBits ? (r.ow & zm) != 0
                                             : new_node_cand(a, g, pi, t);
    if (!(r.fp && off)) return -1;
    return D <= kHeadDims ? head_staged(r.av, sdm, sR, D, srb)
                          : headroom(a.A + t * D, a.daemon + (g * a.P + pi) * D,
                                     a.R + g * D, D);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Block r of (group, pool) gp = blockIdx.x / X, a cluster of X CTAs
// (caps_cluster): the partial cap over its chunk of ceil(T / X) types,
// stored into rank 0's shared memory after the cluster barrier that
// every CTA arrived at on entry (all have started); after a second
// barrier rank 0 writes the max. X == 1 (minValues floors, or T <= one
// CTA's threads) writes it directly, with the floors' per-value maxima
// h1n (atomicMax in shared memory over the pairs).
__global__ void __launch_bounds__(kCapsThreads)
mesh_new_caps_kernel(MeshArgs m, i64 X) {
    extern __shared__ i64 dyn[];   // h1n [K*V] (X == 1)
    __shared__ i64 red[33];
    __shared__ i64 sR[kHeadDims], sdm[kHeadDims];
    __shared__ double srb[kHeadDims];
    __shared__ u64 s_zm;
    __shared__ i64 part[kCapsCluster];   // rank 0's: each CTA's partial
    const FfdArgs& a = m.f;
    const i64 T = a.T, D = a.D, P = a.P, K = a.K, V = a.V, M = a.M;
    const i64 Z = a.Z, C = a.C, ZC = Z * C;
    const i64 gp = blockIdx.x / X, r = blockIdx.x - gp * X;
    const i64 g = gp / P, pi = gp - g * P;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (X > 1) cluster_arrive_relaxed();
    const i64 tc = (T + X - 1) / X;
    const i64 t0 = r * tc, t1 = t0 + tc < T ? t0 + tc : T;
    // the first pass's type: its loads in flight across the staging
    TypeRow first;
    if (t0 + tid < t1) first = type_row(a, g, pi, t0 + tid);
    if (warp == 0 && ZC <= kOfferBits) {   // lanes over the pairs
        u64 zm = 0;
        for (int h = 0; h < 2; ++h) {
            const int i = lane + 32 * h;
            bool on = false;
            if (i < ZC) {
                const int z = i / (int)C, c = i - z * (int)C;
                on = (a.agz[g * Z + z] & a.pool_agz[pi * Z + z]
                      & a.agc[g * C + c] & a.pool_agc[pi * C + c]) != 0;
            }
            zm |= (u64)__ballot_sync(~0u, on) << (32 * h);
        }
        if (lane == 0) s_zm = zm;
    } else if (warp == 1 && lane < D && D <= kHeadDims) {
        const i64 rr = a.R[g * D + lane];
        sR[lane] = rr;
        sdm[lane] = a.daemon[(g * P + pi) * D + lane];
        srb[lane] = rr > 0 ? 1.0 / (double)rr : 0.0;
    }
    for (i64 i = tid; i < K * V; i += blockDim.x) dyn[i] = 0;
    __syncthreads();
    const u64 zm = ZC <= kOfferBits ? s_zm : 0;
    if (K > 0) {   // X == 1
        for (i64 kk = 0; kk < K; ++kk) {
            for (i64 j = tid; j < M; j += blockDim.x) {
                const i64 v = a.mv_pairs_v[kk * M + j];
                const i64 t = a.mv_pairs_t[kk * M + j];
                if (v < 0 || v >= V || t < 0 || t >= T) continue;
                const i64 hr = type_hr(a, g, pi, type_row(a, g, pi, t), zm,
                                       sR, sdm, srb);
                if (hr >= 0)
                    atomicMax((long long*)&dyn[kk * V + v],
                              (long long)(hr + 1));
            }
        }
    }
    i64 cmax = 0;
    for (i64 t = t0 + tid; t < t1; t += blockDim.x) {
        const i64 hr = type_hr(a, g, pi, t == t0 + tid ? first
                                              : type_row(a, g, pi, t),
                               zm, sR, sdm, srb);
        cmax = hr > cmax ? hr : cmax;
    }
    const i64 cap = block_max(cmax, red);   // its barriers publish dyn
    if (X == 1) {
        if (tid == 0) m.caps[gp] = cap;
        i64* h1n = m.caps + a.G * P + gp * K * V;
        for (i64 i = tid; i < K * V; i += blockDim.x) h1n[i] = dyn[i];
        return;
    }
    cg::cluster_group cl = cg::this_cluster();
    cluster_wait();   // every CTA of the cluster has started
    if (tid == 0) *cl.map_shared_rank(&part[r], 0) = cap;
    cl.sync();
    if (r == 0 && tid == 0) {
        i64 c = part[0];
        for (i64 q = 1; q < X; ++q) c = part[q] > c ? part[q] : c;
        m.caps[gp] = c;
    }
}

__global__ void __launch_bounds__(kRowThreads)
mesh_slot_headroom_kernel(const __grid_constant__ MeshArgs m, i64 g,
                          RowLayout lay) {
    extern __shared__ i64 dyn[];   // K > 0: h1 [K*V] of this slot
    __shared__ i64 red[33];
    __shared__ FfdArgs sa;         // K > 0: the arguments with K = 0
    const i64 K = m.f.K, V = m.f.V, M = m.f.M, T = m.f.T, D = m.f.D;
    const i64 N = m.f.N;
    if (K == 0) {
        const FfdArgs& a = m.f;    // read in place
        const i64 rb = block_rows(lay), nrb = (N + rb - 1) / rb;
        if (blockIdx.x >= nrb) {   // chunk c of the table of pool pi
            const i64 TB = table_blocks(T), j = blockIdx.x - nrb;
            const i64 pi = j / TB, c = j % TB;
            new_node_table_block(a, g, pi, c, a.candn + pi * T,
                                 a.hrn + pi * T, m.capn + j, nullptr, red,
                                 nullptr);
            return;
        }
        const i64 lo = blockIdx.x * rb, hi = lo + rb < N ? lo + rb : N;
        slot_headroom_warps(a, g, a.cand, a.k, lo, hi, (int)lay.warps);
        return;
    }
    lane_view_block(m.f, 0, &sa);
    __syncthreads();
    if (threadIdx.x == 0) sa.K = 0;   // the minValues cap waits for the max
    __syncthreads();
    const FfdArgs& a = sa;
    const i64 s = blockIdx.x;
    slot_headroom_block(a, g, s, red, nullptr);
    for (i64 i = threadIdx.x; i < K * V; i += blockDim.x) dyn[i] = 0;
    __syncthreads();                // also publishes cand[s, :]
    const i64* R = a.R + g * D;
    for (i64 kk = 0; kk < K; ++kk) {
        for (i64 j = threadIdx.x; j < M; j += blockDim.x) {
            i64 v = a.mv_pairs_v[kk * M + j];
            i64 t = a.mv_pairs_t[kk * M + j];
            if (v < 0 || v >= V || t < 0 || t >= T) continue;
            if (!a.cand[s * T + t]) continue;
            atomicMax((long long*)&dyn[kk * V + v],
                      (long long)(headroom(a.A + t * D, a.used + s * D, R, D)
                                  + 1));
        }
    }
    __syncthreads();
    for (i64 i = threadIdx.x; i < K * V; i += blockDim.x)
        m.h1[s * K * V + i] = dyn[i];
}

// Most rows a thread of mesh_fill holds in registers: the rank's rows go
// in tiles of blockDim.x * R, a thread taking a contiguous run of at most
// R rows of a tile, R = fill_rows(Nl) (one tile up to 4,096 rows; 16 rows
// a thread spilled registers under the 512-thread CTA's 128 and took the
// 4,224-row fill from 12-13 us to 11-25).
constexpr int kFillRows = 8;

// Most warps of the fill's CTA, and the scan components it posts at once.
constexpr int kFillWarps = 16;

// mesh_fill's threads for Nl rows (one CTA): 256 up to 2,048 rows (at
// most 8 a thread), else 512.
__host__ __device__ __forceinline__ int fill_threads(i64 N) {
    return N <= 2048 ? 256 : 512;
}

// Rows a thread of mesh_fill holds for Nl rows: the power of two at or
// above Nl / fill_threads(Nl), at most kFillRows (more rows take tiles).
// Each count is its own build of the kernel, so a thread of a small rank
// runs no predicated-off rows.
__host__ __device__ __forceinline__ int fill_rows(i64 N) {
    const i64 nt = fill_threads(N);
    int r = 1;
    while (r < kFillRows && (i64)r * nt < N) r <<= 1;
    return r;
}

// Dynamic shared bytes of mesh_fill with nt threads, P pools and nex
// existing rows in a tile: each warp's partial sums by segment [P + 1],
// the pools' carried prefixes [P], the overlay's k of the existing rows.
__host__ __device__ __forceinline__ size_t fill_smem(int nt, i64 P,
                                                     i64 nex) {
    return (size_t)((nt / 32) * (P + 1) + P + nex) * 8;
}

// One thread's rows of a fill tile: the local rows [lo, lo + n), their k
// and pool in registers.
template <int R>
struct FillRows {
    i64 k[R];
    int pool[R];
    i64 lo;
    int n;
};

// Issues the loads of this thread's contiguous rows of the tile [t0, t1).
template <int R>
__device__ __forceinline__ void fill_load(const FfdArgs& a, i64 t0, i64 t1,
                                          FillRows<R>& r) {
    const int len = (int)(t1 - t0), nt = (int)blockDim.x;
    const int per = (len + nt - 1) / nt;
    const int lo = (int)threadIdx.x * per;
    r.lo = t0 + (lo < len ? lo : len);
    r.n = (lo + per < len ? lo + per : len) - (lo < len ? lo : len);
#pragma unroll
    for (int j = 0; j < R; ++j) {
        if (j < r.n) {
            r.k[j] = a.k[r.lo + j];
            r.pool[j] = a.pool[r.lo + j];
        }
    }
}

// The rows of the tile [t0, t1) that are existing nodes: [t0, fill_ex_end).
__device__ __forceinline__ i64 fill_ex_end(const MeshArgs& m, i64 t0,
                                           i64 t1) {
    const i64 ex1 = m.E - m.slot0;
    return ex1 < t0 ? t0 : (ex1 > t1 ? t1 : ex1);
}

// Phase (a)'s k of existing row s: its allocatable's headroom under group
// g when alive and compatible, else 0; the row's loads issued at once and
// its quotients by floordiv_fp (the global rows past kFillDims).
constexpr int kFillDims = 8;
__device__ __forceinline__ i64 fill_ex_k(const FfdArgs& a, i64 g, i64 s) {
    const i64 D = a.D;
    const u8 alive = a.alive[s], compat = a.ex_compat[g * a.N + s];
    if (D > kFillDims)
        return alive && compat
            ? headroom(a.ex_alloc + s * D, a.used + s * D, a.R + g * D, D)
            : 0;
    i64 al[kFillDims], us[kFillDims], rq[kFillDims];
#pragma unroll
    for (int d = 0; d < kFillDims; ++d) {
        al[d] = d < D ? a.ex_alloc[s * D + d] : 0;
        us[d] = d < D ? a.used[s * D + d] : 0;
        rq[d] = d < D ? a.R[g * D + d] : 0;
    }
    i64 m = KARP_BIG;
#pragma unroll
    for (int d = 0; d < kFillDims; ++d) {
        if (rq[d] <= 0) continue;
        const i64 q = floordiv_fp(wsub(al[d], us[d]), rq[d]);
        m = q < m ? q : m;
    }
    return alive && compat ? (m < 0 ? 0 : m) : 0;
}

// Phase (a) with minValues floors (the type mesh's one-launch fill): an
// open row's k capped by its per-value maxima. Out of line: rare.
__device__ __noinline__ i64 fill_mv_k(const MeshArgs& m, i64 s, int pool,
                                      i64 k) {
    const FfdArgs& a = m.f;
    const i64 P = a.P, K = a.K, V = a.V;
    const i64 pc = pool > P - 1 ? P - 1 : pool;
    const i64 cap = mv_cap_serial(m.h1 + s * K * V, a.mv_floor + pc * K, K,
                                  V);
    return cap < k ? cap : k;
}

// Phase (a)'s overlay of the tile [t0, t1), a row a thread striding over
// the rows it changes, so a shard's existing rows are spread over the CTA:
// the existing rows' k into `ovk` [the tile's existing rows] (their owners
// take it after the barrier), and with minValues floors every open row's
// capped k into k itself before the owners load it. Returns whether it
// wrote anything (then the CTA has passed a barrier).
__device__ __forceinline__ bool fill_overlay(const MeshArgs& m, i64 g,
                                             i64 t0, i64 t1, i64* ovk) {
    const FfdArgs& a = m.f;
    const i64 ex1 = fill_ex_end(m, t0, t1);
    if (ex1 == t0 && a.K == 0) return false;   // uniform over the CTA
    for (i64 s = t0 + threadIdx.x; s < ex1; s += blockDim.x)
        ovk[s - t0] = fill_ex_k(a, g, s);
    if (a.K > 0)
        for (i64 s = ex1 + threadIdx.x; s < t1; s += blockDim.x) {
            const int pool = a.pool[s];
            if (pool >= 0) a.k[s] = fill_mv_k(m, s, pool, a.k[s]);
        }
    __syncthreads();
    return true;
}

// A W-wide exclusive scan over the CTA with one barrier: lane 31 of each
// warp posts its warp's totals into one half of `tmp` (the halves by
// turns, so a scan's posts never meet the reads of the one before it,
// which a barrier between them has ended), and each thread adds up the
// warps before its own. v becomes the sum over the threads before this
// one, tot[w] component w's total. `tmp` holds 2 * kFillWarps * kScanW
// shared entries.
template <int W>
__device__ __forceinline__ void fill_scan(u64 (&v)[W], u64 (&tot)[W],
                                          u64* tmp, int& turn) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    u64* t = tmp + (turn & 1) * kFillWarps * kScanW;
    ++turn;
    u64 own[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        own[w] = v[w];
        for (int off = 1; off < 32; off <<= 1) {
            const u64 o = __shfl_up_sync(0xffffffffu, v[w], off);
            if (lane >= off) v[w] += o;
        }
        if (lane == 31) t[warp * W + w] = v[w];
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < W; ++w) {
        u64 before = 0, all = 0;
        for (int i = 0; i < nwarps; ++i) {
            const u64 x = t[i * W + w];
            before += i < warp ? x : 0;
            all += x;
        }
        v[w] = before + v[w] - own[w];
        tot[w] = all;
    }
}

// Phase (b) on a tile for the pools of `pj` [W] (-9: none) whose budgets
// are `bud` and whose prefixes before the tile `base` (the earlier
// shards' and tiles'): one W-wide scan of each pool's k over the CTA's
// rows, then each row of the pool capped at the budget left before it.
// tot[w] gets pool pj[w]'s k over the tile.
template <int W, int R>
__device__ __forceinline__ void fill_caps(FillRows<R>& r, const int (&pj)[8],
                                          const i64 (&bud)[8],
                                          const u64 (&base)[8],
                                          u64 (&tot)[W], u64* scan,
                                          int& turn) {
    u64 v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        if (i >= r.n) continue;
#pragma unroll
        for (int j = 0; j < W; ++j)
            if (r.pool[i] == pj[j]) v[j] += (u64)r.k[i];
    }
    fill_scan(v, tot, scan, turn);
#pragma unroll
    for (int j = 0; j < W; ++j) {
        if (pj[j] < 0) continue;
        i64 cum = (i64)(v[j] + base[j]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            if (i >= r.n || r.pool[i] != pj[j]) continue;
            const i64 kp = r.k[i];
            const i64 room = wsub(bud[j], cum);
            const i64 c = kp < room ? kp : room;
            cum = wadd(cum, kp);
            r.k[i] = c < 0 ? 0 : c;
        }
    }
}

// Phase (b)'s pool caps on a tile, the pools to every warp's lanes 32 at a
// time with no barrier: lane q tests pool base + q (a limit, and group g
// admits it: a pool it does not admit has k = 0 on every row, so its cap
// changes nothing) and takes its budget against pool_used as it stands,
// its loads issued at once; a ballot lists the limited pools, eight a
// scan, each pool's budget shuffled from its lane. A pool's prefix before
// the tile is before[pool] on the first tile (0 without) and then its
// carry in cb [P], which thread 0 keeps.
template <int R>
__device__ __forceinline__ void fill_pool_caps(const FfdArgs& a, i64 g,
                                               FillRows<R>& r,
                                               const i64* before, u64* cb,
                                               bool first, u64* scan,
                                               int& turn) {
    const int lane = threadIdx.x & 31;
    const i64 P = a.P, D = a.D;
    const i64* Rg = a.R + g * D;
    for (i64 base = 0; base < P; base += 32) {
        const i64 q = base + lane;
        bool has = false;
        i64 bq = KARP_BIG;
        if (q < P) {
            const bool adm = a.admit[g * P + q];
            const i64* lim = a.pool_limit + q * D;
            const i64* used = a.pool_used + q * D;
            for (i64 d0 = 0; d0 < D; d0 += kFillDims) {
                i64 lv[kFillDims], uv[kFillDims], rv[kFillDims];
#pragma unroll
                for (int j = 0; j < kFillDims; ++j) {
                    const bool in = d0 + j < D;
                    lv[j] = in ? lim[d0 + j] : -1;
                    uv[j] = in ? used[d0 + j] : 0;
                    rv[j] = in ? Rg[d0 + j] : 0;
                }
#pragma unroll
                for (int j = 0; j < kFillDims; ++j) {
                    has |= lv[j] >= 0;
                    if (lv[j] >= 0 && rv[j] > 0) {   // pool_budget's quotient
                        const i64 room = wsub(lv[j], uv[j]);
                        const i64 qd = floordiv_fp(room < 0 ? 0 : room, rv[j]);
                        bq = qd < bq ? qd : bq;
                    }
                }
            }
            has &= adm;
        }
        unsigned lim = __ballot_sync(0xffffffffu, has);
        while (lim) {                       // uniform over the CTA
            int pj[8];
            i64 bud[8];
            u64 cbase[8];
            int nb = 0;
#pragma unroll
            for (int w = 0; w < 8; ++w) {
                const int b = lim ? __ffs(lim) - 1 : 0;
                bud[w] = __shfl_sync(0xffffffffu, bq, b);
                pj[w] = lim ? (int)(base + b) : -9;
                cbase[w] = !lim ? 0 : !first ? cb[pj[w]]
                    : (before ? (u64)before[pj[w]] : 0);
                nb += lim != 0;
                lim &= lim - 1;
            }
            if (nb == 1) {
                u64 tot[1];
                fill_caps<1, R>(r, pj, bud, cbase, tot, scan, turn);
                if (threadIdx.x == 0) cb[pj[0]] = cbase[0] + tot[0];
            } else {
                u64 tot[8];
                fill_caps<8, R>(r, pj, bud, cbase, tot, scan, turn);
                if (threadIdx.x == 0)
                    for (int w = 0; w < nb; ++w)
                        cb[pj[w]] = cbase[w] + tot[w];
            }
        }
    }
}

// Phase (c) on a tile: the greedy prefix fill of n pods; k becomes take.
// `cc` is the fill's prefix before the tile (the earlier shards' and
// tiles'); returns it past the tile.
template <int R>
__device__ __forceinline__ u64 fill_greedy(FillRows<R>& r, i64 n, u64 cc,
                                           u64* scan, int& turn) {
    u64 v[1] = {0}, tot[1];
#pragma unroll
    for (int j = 0; j < R; ++j)
        if (j < r.n) v[0] += (u64)r.k[j];
    fill_scan(v, tot, scan, turn);
    i64 cum = (i64)(v[0] + cc);
#pragma unroll
    for (int j = 0; j < R; ++j) {
        if (j >= r.n) continue;
        const i64 kk = r.k[j];
        i64 x = wsub(n, cum);
        x = x < 0 ? 0 : x;
        cum = wadd(cum, kk);
        r.k[j] = x < kk ? x : kk;
    }
    return cc + tot[0];
}

// The segment of a row of pool `pool`: its pool (clamped to P - 1), P for
// rows of no pool; every row in segment 0 without by_pool.
__device__ __forceinline__ int fill_seg(int pool, i64 P, bool by_pool) {
    return !by_pool ? 0 : pool < 0 ? (int)P
        : (pool > P - 1 ? (int)P - 1 : pool);
}

// Adds this thread's rows' k of the segments s0 .. s0+ns-1 (ns <= W) to
// its warp's partials `wp`: summed over the warp by shuffles, then added
// by lane 0 (the warp's own row: no atomics).
template <int W, int R>
__device__ __forceinline__ void fill_sums(const FillRows<R>& r, int s0, int ns,
                                          i64 P, bool by_pool, u64* wp) {
    u64 v[W];
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
        if (j >= r.n) continue;
        const int seg = fill_seg(r.pool[j], P, by_pool) - s0;
#pragma unroll
        for (int w = 0; w < W; ++w)
            if (seg == w) v[w] += (u64)r.k[j];
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
        if (w >= ns) continue;
        for (int off = 16; off > 0; off >>= 1)
            v[w] += __shfl_xor_sync(0xffffffffu, v[w], off);
        if ((threadIdx.x & 31) == 0) wp[s0 + w] += v[w];
    }
}

// One phase of group g's fill (or all three: kPhaseAll) on one CTA of
// fill_threads(Nl) threads. Each tile's rows are loaded once, phase (a)'s
// overlay computed beside the loads a row a thread and handed to the rows'
// owners; every phase asked for runs on the rows in registers (each
// reads only prefixes over earlier rows, which the scans' carries hold),
// then k is stored once and the rows' sums go into the warps' partials;
// after one barrier thread e writes red[e], the sum over the warps. A
// phase waits at one barrier a scan, one for the overlay where the tile
// holds existing rows, and the last. (Staging each tile through shared
// memory for coalesced loads and stores cost more barriers than it saved.)
template <int R>
__global__ void __launch_bounds__(512)
mesh_fill_kernel(const __grid_constant__ MeshArgs m, i64 g, int phase) {
    extern __shared__ u64 fdyn[];
    __shared__ u64 scan[2 * kFillWarps * kScanW];
    const FfdArgs& a = m.f;
    const i64 N = a.N, P = a.P, nseg = P + 1;
    const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
    const bool do_a = phase == 0 || phase == kPhaseAll;
    const bool do_b = phase == 1 || phase == kPhaseAll;
    const bool do_c = phase == 2 || phase == kPhaseAll;
    const i64* before = phase == kPhaseAll ? nullptr : m.before;
    const i64 n = do_c ? a.n[g] : 0;
    u64 cc = do_c && before ? (u64)before[P] : 0;
    u64* part = fdyn;                            // [nwarps, P + 1]
    u64* cb = part + nwarps * nseg;              // [P]
    i64* ovk = (i64*)(cb + P);                   // [a tile's existing rows]
    u64* wp = part + warp * nseg;
    for (i64 e = threadIdx.x & 31; e < nseg; e += 32) wp[e] = 0;
    __syncwarp();
    const i64 tile = (i64)blockDim.x * R;
    const int nsum = phase == 0 ? (int)P : (phase == 1 ? 1 : (int)nseg);
    int turn = 0;
    for (i64 t0 = 0; t0 < N; t0 += tile) {
        const i64 t1 = t0 + tile < N ? t0 + tile : N;
        if (t0) __syncthreads();   // the last tile's cb and ovk are read
        FillRows<R> r;
        bool ov = false;
        if (do_a && a.K > 0) ov = fill_overlay(m, g, t0, t1, ovk);
        fill_load(a, t0, t1, r);
        if (do_a && a.K == 0) ov = fill_overlay(m, g, t0, t1, ovk);
        if (ov) {
            const i64 ex1 = fill_ex_end(m, t0, t1);
#pragma unroll
            for (int j = 0; j < R; ++j)
                if (j < r.n && r.lo + j < ex1) r.k[j] = ovk[r.lo + j - t0];
        }
        if (do_b) fill_pool_caps<R>(a, g, r, before, cb, t0 == 0, scan, turn);
        if (do_c) cc = fill_greedy(r, n, cc, scan, turn);
#pragma unroll
        for (int j = 0; j < R; ++j)
            if (j < r.n) a.k[r.lo + j] = r.k[j];
        if (nsum == 1)
            fill_sums<1, R>(r, 0, 1, P, phase != 1, wp);
        else if (nsum == 2)
            fill_sums<2, R>(r, 0, 2, P, true, wp);
        else
            for (int s0 = 0; s0 < nsum; s0 += kScanW)
                fill_sums<kScanW, R>(r, s0, nsum - s0 < kScanW ? nsum - s0
                                                            : kScanW,
                                     P, true, wp);
    }
    __syncthreads();
    for (i64 e = threadIdx.x; e < nsum; e += blockDim.x) {
        u64 t = 0;
        for (int w = 0; w < nwarps; ++w) t += part[w * nseg + e];
        m.red[e] = (i64)t;
    }
}

// Dynamic shared bytes of the commit on clusters of cs CTAs: the cluster
// commit's layout at K == 0; take_by_pool [P] and the caps [P] at K > 0.
size_t commit_smem(const FfdArgs& f, i64 cs) {
    if (f.K > 0) return (size_t)(2 * f.P) * sizeof(i64);
    return cluster_commit_smem(1, f.P, f.D, (f.N + cs - 1) / cs);
}

template <int NT>
__global__ void __launch_bounds__(NT)
mesh_commit_kernel(const __grid_constant__ MeshArgs m, i64 g) {
    extern __shared__ i64 dyn[];
    __shared__ i64 tmp[33];
    __shared__ i64 sc[8];
    __shared__ int pre[9];         // the CTAs' taker counts, as a prefix
    const FfdArgs& a = m.f;        // read in place
    const i64 N = a.N, P = a.P, K = a.K, V = a.V;
    const int tid = threadIdx.x;
    if (K > 0) {                   // one CTA (karp_mesh_commit)
        i64* cap = dyn + P;        // take_by_pool [P], then the caps [P]
        for (i64 pi = tid; pi < P; pi += NT) {
            i64 c = m.caps[g * P + pi];
            const i64* h1n = m.caps + a.G * P + (g * P + pi) * K * V;
            const i64 mc = mv_cap_serial(h1n, a.mv_floor + pi * K, K, V);
            cap[pi] = mc < c ? mc : c;   // commit_narrow's barriers
        }                                // publish it
        i64 taken = 0;
        for (i64 p = 0; p <= P; ++p) taken = wadd(taken, m.tbp[p]);
        i64 n_rem = wsub(a.n[g], taken);
        commit_narrow(a, g, 1, dyn, m.tbp);                     // step 6
        const SlotWindow w{m.slot0, N, m.N, m.E, cap, m.tbp};
        n_rem = commit_new_nodes(a, g, n_rem, tmp, sc, nullptr, nullptr, &w);
        commit_outputs(a, g, n_rem);
        return;
    }
    cg::cluster_group cl = cg::this_cluster();
    const i64 CS = cl.num_blocks(), rank = cl.block_rank();
    // the CTA's local rows [c0, c1)
    const i64 cchunk = (N + CS - 1) / CS;
    const i64 c0 = rank * cchunk < N ? rank * cchunk : N;
    const i64 c1 = c0 + cchunk < N ? c0 + cchunk : N;
    CommitSmem cm = commit_smem_at(dyn, 1, P, a.D, cchunk);
    for (i64 w = tid; w < P + 1; w += NT) cm.tbp[w] = 0;   // tbp, tks
    if (tid == 0) cm.ntk[0] = 0;
    __syncthreads();
    narrow_slots(a, g, 0, 1, c0, c1, cm.tk, cm.tkm, cm.ntk, cm.tbp);
    int* mine = reinterpret_cast<int*>(cm.tkm);
    const int nmine = deal_takers(cm.tk, cm.ntk, mine, pre, NT);
    const i64 T = a.T;
    narrow_cells(a, nmine, [&](int jj) { return (i64)mine[jj]; },
                 [&](int, i64 s, i64 t) {
                     return __ldg(&a.cand[s * T + t]) != 0;
                 }, cm.tu);
    const SlotWindow w{m.slot0, N, m.N, m.E, m.caps + g * P, m.tbp};
    commit_tail(a, g, 0, 1, 1, c0, c1, nullptr, cm.tbp, cm.xch, cm.stage,
                cm.sc, true, &w);
    cl.sync();   // no CTA leaves while another may read its shared memory
}

// mesh_fill's build for R rows a thread (fill_rows) on nt threads.
template <int R>
int launch_fill(const MeshArgs* m, i64 g, int phase, int nt, size_t smem,
                cudaStream_t stream) {
    int err = set_smem((const void*)mesh_fill_kernel<R>, smem);
    if (err) return err;
    mesh_fill_kernel<R><<<1, nt, smem, stream>>>(*m, g, phase);
    return (int)cudaGetLastError();
}

const void* commit_fn(i64 threads) {
    return threads == 512 ? (const void*)mesh_commit_kernel<512>
                          : (const void*)mesh_commit_kernel<256>;
}

}  // namespace

extern "C" {

// mesh_new_caps' CTAs a (group, pool) for Tl types (ops/mesh_cuda.py
// mirrors it): one with minValues floors (its per-value maxima stay on
// one CTA), else the power of two of CTAs at or above Tl / kCapsThreads,
// at most kCapsCluster.
long long karp_mesh_caps_cluster(long long T, long long K) {
    long long x = 1;
    while (K == 0 && x < kCapsCluster && x * kCapsThreads < T) x *= 2;
    return x;
}

int karp_mesh_new_caps(const MeshArgs* m, void* stream) {
    const i64 GP = m->f.G * m->f.P;
    if (GP <= 0) return (int)cudaGetLastError();
    const i64 X = karp_mesh_caps_cluster(m->f.T, m->f.K);
    size_t smem = (size_t)(m->f.K * m->f.V) * sizeof(i64);
    int err = set_smem((const void*)mesh_new_caps_kernel, smem);
    if (err) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(GP * X));
    cfg.blockDim = dim3(kCapsThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)X;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = (int)cudaLaunchKernelEx(&cfg, mesh_new_caps_kernel, *m, X);
    if (err) return err;
    return (int)cudaGetLastError();
}

int karp_mesh_slot_headroom(const MeshArgs* m, long long g, void* stream) {
    const FfdArgs& f = m->f;
    size_t smem = (size_t)(f.K * f.V) * sizeof(i64);
    int err = set_smem((const void*)mesh_slot_headroom_kernel, smem);
    if (err) return err;
    const RowLayout lay = k2_layout(1, f.N);
    const i64 rb = block_rows(lay);
    const unsigned grid = (unsigned)(f.K > 0 ? f.N
                                     : (f.N + rb - 1) / rb
                                       + f.P * table_blocks(f.T));
    mesh_slot_headroom_kernel<<<grid, kRowThreads, smem,
                                (cudaStream_t)stream>>>(*m, (i64)g, lay);
    return (int)cudaGetLastError();
}

int karp_mesh_fill(const MeshArgs* m, long long g, int phase, void* stream) {
    const int nt = fill_threads(m->f.N);
    const i64 tile = (i64)nt * fill_rows(m->f.N), ex = m->E - m->slot0;
    const i64 nex = ex < 0 ? 0 : (ex < tile ? ex : tile);
    const size_t smem = fill_smem(nt, m->f.P, nex < m->f.N ? nex : m->f.N);
    cudaStream_t st = (cudaStream_t)stream;
    switch (fill_rows(m->f.N)) {
    case 1: return launch_fill<1>(m, g, phase, nt, smem, st);
    case 2: return launch_fill<2>(m, g, phase, nt, smem, st);
    case 4: return launch_fill<4>(m, g, phase, nt, smem, st);
    default: return launch_fill<kFillRows>(m, g, phase, nt, smem, st);
    }
}

// mesh_fill's threads and rows a thread for a rank of n rows
// (ops/mesh_cuda.py mirrors both).
int karp_mesh_fill_threads(long long n) { return fill_threads(n); }
int karp_mesh_fill_rows(long long n) { return fill_rows(n); }

int karp_mesh_commit(const MeshArgs* m, long long g, void* stream) {
    const i64 cs = m->cluster, nt = m->threads;
    if ((cs != 1 && cs != 2 && cs != 4 && cs != 8) || (nt != 256 && nt != 512)
        || (m->f.K > 0 && cs != 1))
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cs);
    cfg.blockDim = dim3((unsigned)nt, 1, 1);
    cfg.dynamicSmemBytes = commit_smem(m->f, cs);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int err = set_smem(commit_fn(nt), cfg.dynamicSmemBytes);
    if (err) return err;
    err = nt == 512
        ? (int)cudaLaunchKernelEx(&cfg, mesh_commit_kernel<512>, *m, (i64)g)
        : (int)cudaLaunchKernelEx(&cfg, mesh_commit_kernel<256>, *m, (i64)g);
    if (err) return err;
    return (int)cudaGetLastError();
}

}  // extern "C"
