// K6, the pruned scan (the G-axis kernel), as three kernels per group step.
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
// ffd_pruned_select: one block of 1024 threads per lane. One warp per slot
//   tests the slot (not existing, alive, open and admitted, k_bound =
//   min_d floor((cap_hint - used) / R) > 0 with BIG where R = 0, and an
//   overlap of types & F, zones & agz and ct & agc); the flags go to
//   k [N] as scratch, then a block-wide exclusive scan over contiguous
//   slot chunks compacts the first S into sel [S] in slot order (-1
//   past them) and writes cnt = (n_sel, n_pos).
// ffd_pruned_headroom: one block of 256 threads per (selected row, lane),
//   the lane on grid y and z (lane_grid). Threads stride over T and write
//   the candidate row cand [S, T] (types & F & an offering in the narrowed
//   zone x capacity-type product) and reduce the exact headroom ks [S]
//   with ffd_common.cuh's headroom(); rows past n_sel write False and 0.
//   P * table_blocks(T) more blocks per lane write the group's new-node
//   table, a chunk of 256 types of one pool each (ffd_step.cuh
//   new_node_table_block): candn/hrn [P, T], the partial caps capn and
//   the opened rows' partial cap_hint rows cap_row. None of it reads the
//   carry, so it rides this launch beside the selected rows.
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
//   S = 64) a step moves ~0.3 MB (types read by the select's screen, the
//   selected rows' candidates, the table) and does ~1e5 integer
//   operations, a fraction of a microsecond at the card's rates; each
//   launch costs its latency, and the commit the latency of one block
//   walking its barriers (about ten now; PERF.md has the times). A later
//   PR would run the G steps as one persistent launch or one CUDA graph.
#include <cuda_runtime.h>

#include "ffd_step.cuh"

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
};

namespace {

constexpr int kSelectThreads = 1024;
constexpr int kHeadroomThreads = 256;
constexpr int kCommitThreads = 1024;

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

__global__ void __launch_bounds__(kSelectThreads)
ffd_pruned_select_kernel(PrunedArgs args, i64 g) {
    __shared__ i64 tmp[33];
    const PrunedArgs p = pruned_view(args, blockIdx.x);
    const FfdArgs& a = p.f;
    const i64 N = a.N, T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const i64 E = a.E, S = p.S;
    const i64* R = a.R + g * D;
    const int tid = threadIdx.x, wl = tid & 31;
    const int warp = tid >> 5, nwarps = blockDim.x >> 5;

    // ---- bound pass + compatibility screen: one warp per slot ----------
    // every lane of a warp reads the same slot, so `ok` is warp-uniform
    for (i64 s = warp; s < N; s += nwarps) {
        const int pool = a.pool[s];
        bool ok = s >= E && a.alive[s] && pool >= 0
            && a.admit[g * P + (pool > P - 1 ? P - 1 : pool)];
        if (ok) {
            i64 m = KARP_BIG;
            for (i64 d = 0; d < D; ++d) {
                const i64 r = R[d];
                if (r > 0) {
                    i64 q = floordiv(wsub(p.cap_hint[s * D + d],
                                          a.used[s * D + d]), r);
                    if (q < m) m = q;
                }
            }
            ok = m > 0;
        }
        if (ok) {
            bool zo = false, co = false;
            for (i64 z = 0; z < Z; ++z)
                zo |= a.zones[s * Z + z] && a.agz[g * Z + z];
            for (i64 c = 0; c < C; ++c)
                co |= a.ct[s * C + c] && a.agc[g * C + c];
            ok = zo && co;
        }
        if (ok) {
            bool hit = false;
            for (i64 t = wl; t < T; t += 32)
                hit |= a.types[s * T + t] && a.F[g * T + t];
            ok = __any_sync(0xffffffffu, hit);
        }
        if (wl == 0) a.k[s] = ok;
    }
    __syncthreads();

    // ---- the first S flagged slots, in slot order ------------------------
    const i64 chunk = (N + blockDim.x - 1) / blockDim.x;
    const i64 lo = tid * chunk, hi = lo + chunk < N ? lo + chunk : N;
    i64 local = 0;
    for (i64 s = lo; s < hi; ++s) local += a.k[s];
    i64 total;
    i64 rank = block_excl_scan(local, tmp, &total);
    for (i64 s = lo; s < hi; ++s) {
        if (!a.k[s]) continue;
        if (rank < S) p.sel[rank] = (int)s;
        ++rank;
    }
    const i64 nsel = total < S ? total : S;
    for (i64 i = nsel + tid; i < S; i += blockDim.x) p.sel[i] = -1;
    if (tid == 0) {
        p.cnt[0] = (int)nsel;
        p.cnt[1] = (int)total;
    }
}

__global__ void __launch_bounds__(kHeadroomThreads)
ffd_pruned_headroom_kernel(PrunedArgs args, i64 g) {
    extern __shared__ long long colmax[];   // [D] of a table block
    __shared__ i64 red[33];
    const unsigned lane = grid_lane();
    if (lane >= args.f.L) return;   // the (y, z) grid's spare lanes
    const PrunedArgs p = pruned_view(args, lane);
    const FfdArgs& a = p.f;
    const i64 i = blockIdx.x, T = a.T, D = a.D;
    if (i >= p.S) {                 // chunk c of the table of pool pi
        const i64 TB = table_blocks(T), pi = (i - p.S) / TB;
        const i64 c = (i - p.S) % TB;
        new_node_table_block(a, g, pi, c, a.candn + pi * T, a.hrn + pi * T,
                             p.capn + pi * TB + c,
                             p.cap_row + (pi * TB + c) * D, red, colmax);
        return;
    }
    u8* cand = a.cand + i * T;
    if (i >= p.cnt[0]) {            // past the selection: an empty row
        for (i64 t = threadIdx.x; t < T; t += blockDim.x) cand[t] = 0;
        if (threadIdx.x == 0) p.ks[i] = 0;
        return;
    }
    const i64 s = p.sel[i];
    const i64* R = a.R + g * D;
    const i64* used = a.used + s * D;
    i64 kmax = 0;
    for (i64 t = threadIdx.x; t < T; t += blockDim.x) {
        const bool c = a.types[s * T + t] && a.F[g * T + t]
            && offering_ok(a, g, s, t);
        cand[t] = c;
        if (c) {
            const i64 hr = headroom(a.A + t * D, used, R, D);
            kmax = hr > kmax ? hr : kmax;
        }
    }
    const i64 k = block_max(kmax, red);
    if (threadIdx.x == 0) p.ks[i] = k;
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

}  // namespace

extern "C" {

int karp_ffd_pruned_select(const PrunedArgs* p, long long g, void* stream) {
    ffd_pruned_select_kernel<<<(unsigned)p->f.L, kSelectThreads, 0,
                               (cudaStream_t)stream>>>(*p, g);
    return (int)cudaGetLastError();
}

int karp_ffd_pruned_headroom(const PrunedArgs* p, long long g,
                             void* stream) {
    // S rows, then the table: table_blocks(T) blocks for each of P pools
    dim3 grid((unsigned)(p->S + p->f.P * table_blocks(p->f.T)));
    lane_grid(p->f.L, &grid);
    const size_t smem = (size_t)p->f.D * sizeof(i64);
    int err = set_smem((const void*)ffd_pruned_headroom_kernel, smem);
    if (err) return err;
    ffd_pruned_headroom_kernel<<<grid, kHeadroomThreads, smem,
                                 (cudaStream_t)stream>>>(*p, g);
    return (int)cudaGetLastError();
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
