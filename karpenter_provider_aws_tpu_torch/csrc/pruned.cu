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
// ffd_pruned_commit: one block of 1024 threads per lane, the base commit
//   (ffd_group_commit) without minValues floors: k from the selection and
//   the existing rows, pool caps and the greedy fill by block scans with
//   wrapping 64-bit sums (an all-zero request row gives k = BIG on every
//   selected slot, and eight of them wrap int64 as the reference does),
//   the bail flag, the narrowing of the selected takers only (no other
//   open slot can take), the pool accounting, and new nodes pool by pool,
//   each opened slot's cap_hint row the pool's candidate column max of A.
//   cap_hint is never refreshed from a narrowed mask: that would change
//   which slots the bound pass proves full, and so the bail pattern.
//
// What bounds them on this card: at config 7 (N = 256, T = 812, D = 8,
//   S = 64) a step moves ~0.3 MB (types read by the select's screen, the
//   selected rows' candidates) and does ~1e5 integer operations, a
//   fraction of a microsecond at the card's rates; each launch costs its
//   latency, and the commit the latency of one block walking its barriers
//   (PERF.md has the times). A later PR would run the G steps as one
//   persistent launch or one CUDA graph.
#include <cuda_runtime.h>

#include "ffd_common.cuh"

// Outside the unnamed namespace: the exported entry points take it, and a
// type of that namespace would give them internal linkage.
struct PrunedArgs {
    FfdArgs f;        // the base scan's fields; f.cand is [S, T], f.k [N]
    i64* cap_hint;    // [N, D]
    u8* bail;         // [1]
    int* sel;         // [S] selected slots, slot order, -1 past n_sel
    int* cnt;         // [2] n_sel, n_pos
    i64* ks;          // [S] exact headroom of the selected rows
    i64 S;
    i64 lane_bytes[5];   // lane strides of cap_hint, bail, sel, cnt, ks
};

namespace {

constexpr int kSelectThreads = 1024;
constexpr int kHeadroomThreads = 256;
constexpr int kCommitThreads = 1024;
constexpr i64 kI64Min = -9223372036854775807LL - 1;

// The arguments of lane `lane`: the base fields by lane_view, the five
// pruned pointers (consecutive 8-byte members) by their own strides.
__device__ __forceinline__ PrunedArgs pruned_view(const PrunedArgs& p,
                                                  unsigned lane) {
    PrunedArgs v = p;
    v.f = lane_view(p.f, lane);
    unsigned char** q = reinterpret_cast<unsigned char**>(&v.cap_hint);
#pragma unroll
    for (int i = 0; i < 5; ++i)
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
    __shared__ i64 red[33];
    const unsigned lane = grid_lane();
    if (lane >= args.f.L) return;   // the (y, z) grid's spare lanes
    const PrunedArgs p = pruned_view(args, lane);
    const FfdArgs& a = p.f;
    const i64 i = blockIdx.x, T = a.T, D = a.D;
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

__global__ void __launch_bounds__(kCommitThreads)
ffd_pruned_commit_kernel(PrunedArgs args, i64 g) {
    extern __shared__ i64 dyn[];   // take_by_pool [P]
    __shared__ i64 tmp[33];
    __shared__ i64 sc[8];          // broadcast scalars of the new-node phase
    const PrunedArgs p = pruned_view(args, blockIdx.x);
    const FfdArgs& a = p.f;
    const i64 N = a.N, T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const i64 E = a.E, S = p.S;
    const i64* R = a.R + g * D;
    const int tid = threadIdx.x;
    const i64 chunk = (N + blockDim.x - 1) / blockDim.x;
    const i64 lo = tid * chunk, hi = lo + chunk < N ? lo + chunk : N;
    const i64 nsel = p.cnt[0];
    i64* tbp = dyn;

    // ---- k: the selected rows' exact headroom, then the existing rows' --
    for (i64 s = tid; s < N; s += blockDim.x) a.k[s] = 0;
    __syncthreads();
    for (i64 i = tid; i < nsel; i += blockDim.x) a.k[p.sel[i]] = p.ks[i];
    for (i64 s = tid; s < E; s += blockDim.x) {
        a.k[s] = (a.alive[s] && a.ex_compat[g * E + s])
            ? headroom(a.ex_alloc + s * D, a.used + s * D, R, D) : 0;
    }
    __syncthreads();

    // ---- pool-limit caps over each pool's slot prefix -------------------
    for (i64 pi = 0; pi < P; ++pi) {
        const i64* lim = a.pool_limit + pi * D;
        bool has_limit = false;
        for (i64 d = 0; d < D; ++d) has_limit |= lim[d] >= 0;
        if (!has_limit) continue;
        const i64 budget = pool_budget(lim, a.pool_used + pi * D, R, D);
        i64 local = 0;
        for (i64 s = lo; s < hi; ++s)
            if (a.pool[s] == pi) local = wadd(local, a.k[s]);
        i64 tot;
        i64 cum = block_excl_scan(local, tmp, &tot);
        for (i64 s = lo; s < hi; ++s) {
            if (a.pool[s] != pi) continue;
            i64 kp = a.k[s];
            i64 room = wsub(budget, cum);
            i64 c = kp < room ? kp : room;
            cum = wadd(cum, kp);
            a.k[s] = c < 0 ? 0 : c;
        }
        __syncthreads();
    }

    // ---- greedy prefix fill; k[s] becomes take[s] -----------------------
    i64 n_rem = a.n[g];
    {
        i64 local = 0;
        for (i64 s = lo; s < hi; ++s) local = wadd(local, a.k[s]);
        i64 tot;
        i64 cum = block_excl_scan(local, tmp, &tot);
        i64 tsum = 0;
        for (i64 s = lo; s < hi; ++s) {
            i64 kk = a.k[s];
            i64 x = wsub(n_rem, cum);
            x = x < 0 ? 0 : x;
            i64 take = x < kk ? x : kk;
            cum = wadd(cum, kk);
            a.k[s] = take;
            tsum = wadd(tsum, take);
        }
        i64 taken;
        block_excl_scan(tsum, tmp, &taken);
        n_rem = wsub(n_rem, taken);
    }
    // pruning was insufficient: pods remain and an unselected bound-
    // positive slot existed (the scan would have consulted it next)
    if (tid == 0 && p.cnt[1] > S && n_rem > 0) p.bail[0] = 1;

    // ---- narrowing of the selected takers + pool accounting -------------
    for (i64 i = tid; i < N * D; i += blockDim.x) {
        i64 s = i / D, d = i % D;
        a.used[i] = wadd(a.used[i], wmul(a.k[s], R[d]));
    }
    for (i64 q = tid; q < P; q += blockDim.x) tbp[q] = 0;
    __syncthreads();
    for (i64 i = 0; i < nsel; ++i) {         // uniform branch per row
        const i64 s = p.sel[i];
        if (!(a.k[s] > 0)) continue;
        const i64* us = a.used + s * D;
        for (i64 t = tid; t < T; t += blockDim.x) {
            bool fit = true;
            for (i64 d = 0; d < D; ++d) fit &= us[d] <= a.A[t * D + d];
            a.types[s * T + t] = a.cand[i * T + t] && fit;
        }
    }
    for (i64 i = tid; i < nsel; i += blockDim.x) {
        const i64 s = p.sel[i];
        if (!(a.k[s] > 0)) continue;
        for (i64 z = 0; z < Z; ++z) a.zones[s * Z + z] &= a.agz[g * Z + z];
        for (i64 c = 0; c < C; ++c) a.ct[s * C + c] &= a.agc[g * C + c];
        const int pool = a.pool[s];
        const i64 pc = pool > P - 1 ? P - 1 : pool;
        atomicAdd((unsigned long long*)&tbp[pc], (unsigned long long)a.k[s]);
    }
    __syncthreads();
    for (i64 i = tid; i < P * D; i += blockDim.x) {
        i64 q = i / D, d = i % D;
        a.pool_used[i] = wadd(a.pool_used[i], wmul(tbp[q], R[d]));
    }
    __syncthreads();

    // ---- new nodes, pool by pool, with their cap_hint rows --------------
    for (i64 pi = 0; pi < P; ++pi) {
        const i64* dmn = a.daemon + (g * P + pi) * D;
        i64 cmax = 0;
        for (i64 t = tid; t < T; t += blockDim.x) {
            bool c = a.F[g * T + t] && a.pool_types[pi * T + t];
            if (c) {
                bool off = false;
                for (i64 z = 0; z < Z && !off; ++z) {
                    if (!(a.agz[g * Z + z] && a.pool_agz[pi * Z + z]))
                        continue;
                    for (i64 cc = 0; cc < C; ++cc) {
                        if (a.agc[g * C + cc] && a.pool_agc[pi * C + cc]
                            && a.avail_zc[t * Z * C + z * C + cc]) {
                            off = true;
                            break;
                        }
                    }
                }
                c = off;
            }
            i64 hr = c ? headroom(a.A + t * D, dmn, R, D) : 0;
            a.candn[t] = c;
            a.hrn[t] = hr;
            cmax = hr > cmax ? hr : cmax;
        }
        const i64 cap = block_max(cmax, tmp);   // publishes hrn/candn
        if (tid == 0) {
            const i64 budget = pool_budget(a.pool_limit + pi * D,
                                           a.pool_used + pi * D, R, D);
            i64 can_place = 0;
            if (a.admit[g * P + pi] && cap >= 1)
                can_place = n_rem < budget ? n_rem : budget;
            i64 q = can_place > 0 ? ceildiv(can_place, cap > 1 ? cap : 1) : 0;
            const i64 nn = a.num_nodes[0];
            const i64 free_slots = N - E - nn;
            q = q < free_slots ? q : free_slots;
            i64 qc = wmul(q, cap);
            const i64 placed = can_place < qc ? can_place : qc;
            sc[0] = q;
            sc[1] = E + nn;                                   // start
            sc[2] = wsub(placed, wmul(cap, q - 1));           // last slot
            sc[3] = placed;
            sc[4] = cap;
            a.num_nodes[0] = (int)(nn + q);
        }
        __syncthreads();
        const i64 q = sc[0], start = sc[1], last = sc[2], placed = sc[3];
        const i64 cp = sc[4];
        if (q > 0) {   // uniform: the opened slots' bound, column by column
            for (i64 d = 0; d < D; ++d) {
                i64 m = kI64Min;
                for (i64 t = tid; t < T; t += blockDim.x) {
                    const i64 v = a.candn[t] ? a.A[t * D + d] : 0;
                    m = v > m ? v : m;
                }
                const i64 cm = block_max(m, tmp);
                for (i64 s = start + tid; s < start + q; s += blockDim.x)
                    p.cap_hint[s * D + d] = cm;
            }
        }
        for (i64 s = start + tid; s < start + q; s += blockDim.x) {
            const i64 m_slot = (s - start == q - 1) ? last : cp;
            a.k[s] = wadd(a.k[s], m_slot);
            for (i64 d = 0; d < D; ++d)
                a.used[s * D + d] = wadd(a.used[s * D + d],
                                         wadd(wmul(m_slot, R[d]), dmn[d]));
            for (i64 z = 0; z < Z; ++z)
                a.zones[s * Z + z] = a.agz[g * Z + z] && a.pool_agz[pi * Z + z];
            for (i64 c = 0; c < C; ++c)
                a.ct[s * C + c] = a.agc[g * C + c] && a.pool_agc[pi * C + c];
            a.pool[s] = (int)pi;
            a.alive[s] = 1;
        }
        for (i64 i = tid; i < q * T; i += blockDim.x) {
            const i64 s = start + i / T, t = i % T;
            const i64 m_slot = (s - start == q - 1) ? last : cp;
            a.types[s * T + t] = a.candn[t] && a.hrn[t] >= m_slot;
        }
        for (i64 d = tid; d < D; d += blockDim.x)
            a.pool_used[pi * D + d] = wadd(a.pool_used[pi * D + d],
                                           wmul(placed, R[d]));
        n_rem = wsub(n_rem, placed);
        __syncthreads();
    }

    // ---- outputs ---------------------------------------------------------
    for (i64 s = tid; s < N; s += blockDim.x)
        a.takes[(g - a.G0) * N + s] = (int)a.k[s];
    if (tid == 0) a.leftover[g - a.G0] = n_rem;
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
    dim3 grid((unsigned)p->S);
    lane_grid(p->f.L, &grid);
    ffd_pruned_headroom_kernel<<<grid, kHeadroomThreads, 0,
                                 (cudaStream_t)stream>>>(*p, g);
    return (int)cudaGetLastError();
}

int karp_ffd_pruned_commit(const PrunedArgs* p, long long g, void* stream) {
    size_t smem = (size_t)p->f.P * sizeof(i64);
    int err = set_smem((const void*)ffd_pruned_commit_kernel, smem);
    if (err) return err;
    ffd_pruned_commit_kernel<<<(unsigned)p->f.L, kCommitThreads, smem,
                               (cudaStream_t)stream>>>(*p, g);
    return (int)cudaGetLastError();
}

}  // extern "C"
