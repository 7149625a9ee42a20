// The steps of one FFD group fill as device functions, shared by the K2
// kernels (ffd_scan.cu), the fused block kernels (fused.cu) and the
// per-rank kernels of the sharded scan (mesh.cu).
//
// Each function reads the group's scratch through the FfdArgs it is
// given: cand [N, T] and k [N] (headroom, then take). A caller that keeps
// several groups' scratch side by side passes a view whose cand and k
// point at that group's rows (group_view). The commit functions run on
// one whole block of threads and end at a barrier; the headroom functions
// need no barrier between slots.
#pragma once

#include "ffd_common.cuh"

// The arguments with the candidate and headroom scratch moved to row
// block i: cand + i*N*T, k + i*N.
__device__ __forceinline__ FfdArgs group_view(const FfdArgs& a, i64 i) {
    FfdArgs v = a;
    v.cand = a.cand + i * a.N * a.T;
    v.k = a.k + i * a.N;
    return v;
}

// Steps 1-3 of group g for slot s on one block: the candidate row
// cand[s, :] and k[s] (existing rows: their own allocatable's headroom;
// K > 0: the minValues cap). `red` holds 33 shared entries; `dyn` the
// K*V + K shared entries of the minValues select.
__device__ __forceinline__ void slot_headroom_block(const FfdArgs& a, i64 g,
                                                    i64 s, i64* red,
                                                    i64* dyn) {
    const i64 T = a.T, D = a.D, P = a.P, K = a.K, V = a.V, M = a.M;
    const i64* R = a.R + g * D;
    const i64* used = a.used + s * D;
    const int pool = a.pool[s];
    const i64 pc = pool < 0 ? 0 : (pool > P - 1 ? P - 1 : pool);
    const bool adm_open = pool >= 0 && a.admit[g * P + pc];

    i64 kmax = 0;
    for (i64 t = threadIdx.x; t < T; t += blockDim.x) {
        bool c = adm_open && a.types[s * T + t] && a.F[g * T + t]
            && offering_ok(a, g, s, t);
        a.cand[s * T + t] = c;
        if (c) {
            i64 hr = headroom(a.A + t * D, used, R, D);
            kmax = hr > kmax ? hr : kmax;
        }
    }
    i64 k = block_max(kmax, red);
    if (s < a.E) {
        k = (a.alive[s] && a.ex_compat[g * a.E + s])
            ? headroom(a.ex_alloc + s * D, used, R, D) : 0;
    }
    if (K > 0) {
        i64* h1 = dyn;
        i64* sel = dyn + K * V;
        for (i64 i = threadIdx.x; i < K * V; i += blockDim.x) h1[i] = 0;
        __syncthreads();   // also publishes cand[s, :] to the block
        for (i64 kk = 0; kk < K; ++kk) {
            for (i64 m = threadIdx.x; m < M; m += blockDim.x) {
                i64 v = a.mv_pairs_v[kk * M + m];
                i64 t = a.mv_pairs_t[kk * M + m];
                if (v < 0 || v >= V || t < 0 || t >= T) continue;
                if (!a.cand[s * T + t]) continue;
                i64 hr1 = headroom(a.A + t * D, used, R, D) + 1;
                atomicMax((long long*)&h1[kk * V + v], (long long)hr1);
            }
        }
        __syncthreads();
        if (pool >= 0) {
            const i64* f = a.mv_floor + pc * K;
            for (i64 kk = 0; kk < K; ++kk) {
                if (f[kk] >= 1 && f[kk] <= V)
                    fth_largest(h1 + kk * V, V, f[kk], &sel[kk]);
            }
            __syncthreads();
            i64 cap = mv_cap_from(f, sel, K, V);
            k = cap < k ? cap : k;
        }
    }
    if (threadIdx.x == 0) a.k[s] = k;
}

// Steps 1-3 of group g for every slot on one block, one warp per slot
// (no minValues floors: K == 0). The same cand and k as
// slot_headroom_block; the caller puts a barrier before reading them.
__device__ __forceinline__ void slot_headroom_warps(const FfdArgs& a,
                                                    i64 g) {
    const i64 T = a.T, D = a.D, P = a.P;
    const i64* R = a.R + g * D;
    const int wl = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    for (i64 s = threadIdx.x >> 5; s < a.N; s += nwarps) {
        const i64* used = a.used + s * D;
        const int pool = a.pool[s];
        const i64 pc = pool < 0 ? 0 : (pool > P - 1 ? P - 1 : pool);
        const bool adm_open = pool >= 0 && a.admit[g * P + pc];
        i64 kmax = 0;
        for (i64 t = wl; t < T; t += 32) {
            bool c = adm_open && a.types[s * T + t] && a.F[g * T + t]
                && offering_ok(a, g, s, t);
            a.cand[s * T + t] = c;
            if (c) {
                i64 hr = headroom(a.A + t * D, used, R, D);
                kmax = hr > kmax ? hr : kmax;
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            i64 o = __shfl_xor_sync(0xffffffffu, kmax, off);
            kmax = o > kmax ? o : kmax;
        }
        if (wl == 0) {
            if (s < a.E)
                kmax = (a.alive[s] && a.ex_compat[g * a.E + s])
                    ? headroom(a.ex_alloc + s * D, used, R, D) : 0;
            a.k[s] = kmax;
        }
    }
}

// Step 4 of group g on one block: the pool-limit caps over each pool's
// slot prefix; k[s] of a capped pool's slot becomes its capped value.
// Reads the carry's pool and pool_used as they stand. Each thread owns the
// slot chunk [lo, hi). `before` (nullable) holds, per pool, the sum of k
// over the slots ahead of this block's (a slot-sharded mesh's earlier
// shards, parallel/mesh.py); null means none.
__device__ __forceinline__ void commit_pool_caps(const FfdArgs& a, i64 g,
                                                 i64 lo, i64 hi, i64* tmp,
                                                 const i64* before = nullptr) {
    const i64 D = a.D, P = a.P;
    const i64* R = a.R + g * D;
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
        if (before) cum = wadd(cum, before[pi]);
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
}

// Step 5 of group g on one block: the greedy prefix fill; k[s] becomes
// take[s]. `before` is the sum of k over the slots ahead of this block's
// (0 on one device). Returns the block's total take to every thread.
__device__ __forceinline__ i64 commit_greedy(const FfdArgs& a, i64 g, i64 lo,
                                             i64 hi, i64* tmp,
                                             i64 before = 0) {
    const i64 n_rem = a.n[g];
    i64 local = 0;
    for (i64 s = lo; s < hi; ++s) local = wadd(local, a.k[s]);
    i64 tot;
    i64 cum = wadd(block_excl_scan(local, tmp, &tot), before);
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
    return taken;
}

// Steps 4-5 of group g on one block: the pool-limit caps, then the greedy
// prefix fill; k[s] becomes take[s]. Returns n_rem to every thread. Each
// thread owns the slot chunk [lo, hi).
__device__ __forceinline__ i64 commit_fill(const FfdArgs& a, i64 g, i64 lo,
                                           i64 hi, i64* tmp) {
    commit_pool_caps(a, g, lo, hi, tmp);
    return wsub(a.n[g], commit_greedy(a, g, lo, hi, tmp));
}

// Step 6 for the nf groups g0 .. g0+nf-1 whose takes are the row blocks
// of k (group_view) and whose candidates those of cand, on one block:
// used += the sum of the takes times R; each open slot that some group
// filled narrows its types to (the filling groups' candidates) & fit,
// its zones and capacity types to the AND of the filling groups'; the
// per-pool take sums go into pool_used. nf == 1 is one plain group.
// `tbp` holds nf * P shared entries. `tbp_in` (nullable) replaces the
// block's own per-pool sums in the pool_used update: a slot-sharded mesh
// passes the sums reduced over every shard (parallel/mesh.py).
__device__ __forceinline__ void commit_narrow(const FfdArgs& a, i64 g0,
                                              i64 nf, i64* tbp,
                                              const i64* tbp_in = nullptr) {
    const i64 N = a.N, T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const int tid = threadIdx.x;
    for (i64 i = tid; i < N * D; i += blockDim.x) {
        const i64 s = i / D, d = i % D;
        i64 u = a.used[i];
        for (i64 f = 0; f < nf; ++f)
            u = wadd(u, wmul(a.k[f * N + s], a.R[(g0 + f) * D + d]));
        a.used[i] = u;
    }
    for (i64 p = tid; p < nf * P; p += blockDim.x) tbp[p] = 0;
    __syncthreads();
    for (i64 s = 0; s < N; ++s) {           // uniform branch per slot
        if (a.pool[s] < 0) continue;
        bool any = false;
        for (i64 f = 0; f < nf; ++f) any |= a.k[f * N + s] > 0;
        if (!any) continue;
        const i64* us = a.used + s * D;
        for (i64 t = tid; t < T; t += blockDim.x) {
            bool fit = true;
            for (i64 d = 0; d < D; ++d) fit &= us[d] <= a.A[t * D + d];
            bool c = false;
            for (i64 f = 0; f < nf; ++f)
                c |= a.k[f * N + s] > 0 && a.cand[(f * N + s) * T + t];
            a.types[s * T + t] = c && fit;
        }
    }
    for (i64 s = tid; s < N; s += blockDim.x) {
        const int pool = a.pool[s];
        if (pool < 0) continue;
        const i64 pc = pool > P - 1 ? P - 1 : pool;
        for (i64 f = 0; f < nf; ++f) {
            const i64 take = a.k[f * N + s];
            if (take <= 0) continue;
            const i64 g = g0 + f;
            for (i64 z = 0; z < Z; ++z) a.zones[s * Z + z] &= a.agz[g * Z + z];
            for (i64 c = 0; c < C; ++c) a.ct[s * C + c] &= a.agc[g * C + c];
            atomicAdd((unsigned long long*)&tbp[f * P + pc],
                      (unsigned long long)take);
        }
    }
    __syncthreads();
    const i64* sums = tbp_in ? tbp_in : tbp;
    for (i64 i = tid; i < P * D; i += blockDim.x) {
        const i64 p = i / D, d = i % D;
        i64 u = a.pool_used[i];
        for (i64 f = 0; f < nf; ++f)
            u = wadd(u, wmul(sums[f * P + p], a.R[(g0 + f) * D + d]));
        a.pool_used[i] = u;
    }
    __syncthreads();
}

// Whether type t is a fresh-node candidate of group g in pool pi: allowed
// by the group and the pool, with an available offering in their shared
// zones x capacity types.
__device__ __forceinline__ bool new_node_cand(const FfdArgs& a, i64 g, i64 pi,
                                              i64 t) {
    const i64 Z = a.Z, C = a.C;
    if (!(a.F[g * a.T + t] && a.pool_types[pi * a.T + t])) return false;
    for (i64 z = 0; z < Z; ++z) {
        if (!(a.agz[g * Z + z] && a.pool_agz[pi * Z + z])) continue;
        for (i64 cc = 0; cc < C; ++cc) {
            if (a.agc[g * C + cc] && a.pool_agc[pi * C + cc]
                && a.avail_zc[t * Z * C + z * C + cc])
                return true;
        }
    }
    return false;
}

// A slot-sharded mesh's view of the new-node phase (parallel/mesh.py):
// the block holds the local slot rows [lo, lo + rows) of N slots whose
// first E are existing nodes, and `caps` [P] are the group's new-node caps
// already reduced over the type shards (minValues caps included).
struct SlotWindow {
    i64 lo, rows, N, E;
    const i64* caps;
};

// Step 7 of group g on one block: new nodes, pool by pool, at slots
// E + num_nodes onward (ordinal in num_nodes); k[s] (the take) gains each
// opened slot's pods. Returns n_rem to every thread. `tmp` holds 33
// shared entries, `sc` 8; `h1`/`sel` the K*V + K entries of the
// minValues select (unused when K == 0 or with a window). With `w` the
// slot ids are global, rows outside the window are another shard's, and
// the caps come from the window.
__device__ __forceinline__ i64 commit_new_nodes(const FfdArgs& a, i64 g,
                                                i64 n_rem, i64* tmp, i64* sc,
                                                i64* h1, i64* sel,
                                                const SlotWindow* w = nullptr) {
    const i64 T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const i64 K = a.K, V = a.V, M = a.M;
    const i64 N = w ? w->N : a.N, E = w ? w->E : a.E;
    const i64 lo = w ? w->lo : 0, hi = w ? w->lo + w->rows : a.N;
    const i64* R = a.R + g * D;
    const int tid = threadIdx.x;
    for (i64 pi = 0; pi < P; ++pi) {
        const i64* dmn = a.daemon + (g * P + pi) * D;
        i64 cmax = 0;
        for (i64 t = tid; t < T; t += blockDim.x) {
            const bool c = new_node_cand(a, g, pi, t);
            i64 hr = c ? headroom(a.A + t * D, dmn, R, D) : 0;
            a.candn[t] = c;
            a.hrn[t] = hr;
            cmax = hr > cmax ? hr : cmax;
        }
        i64 cap = block_max(cmax, tmp);   // its barriers publish hrn/candn
        if (w) {
            cap = w->caps[pi];
        } else if (K > 0) {
            for (i64 i = tid; i < K * V; i += blockDim.x) h1[i] = 0;
            __syncthreads();
            for (i64 kk = 0; kk < K; ++kk) {
                for (i64 m = tid; m < M; m += blockDim.x) {
                    i64 v = a.mv_pairs_v[kk * M + m];
                    i64 t = a.mv_pairs_t[kk * M + m];
                    if (v < 0 || v >= V || t < 0 || t >= T) continue;
                    if (!a.candn[t]) continue;
                    atomicMax((long long*)&h1[kk * V + v],
                              (long long)(a.hrn[t] + 1));
                }
            }
            __syncthreads();
            const i64* f = a.mv_floor + pi * K;
            for (i64 kk = 0; kk < K; ++kk) {
                if (f[kk] >= 1 && f[kk] <= V)
                    fth_largest(h1 + kk * V, V, f[kk], &sel[kk]);
            }
            __syncthreads();
            i64 mc = mv_cap_from(f, sel, K, V);
            cap = mc < cap ? mc : cap;
        }
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
        // this block's opened rows: global slots [s0, s1), row s - lo
        const i64 s0 = start > lo ? start : lo;
        const i64 s1 = start + q < hi ? start + q : hi;
        for (i64 s = s0 + tid; s < s1; s += blockDim.x) {
            const i64 m_slot = (s - start == q - 1) ? last : cp;
            const i64 r = s - lo;
            a.k[r] = wadd(a.k[r], m_slot);
            for (i64 d = 0; d < D; ++d)
                a.used[r * D + d] = wadd(a.used[r * D + d],
                                         wadd(wmul(m_slot, R[d]), dmn[d]));
            for (i64 z = 0; z < Z; ++z)
                a.zones[r * Z + z] =
                    a.agz[g * Z + z] && a.pool_agz[pi * Z + z];
            for (i64 c = 0; c < C; ++c)
                a.ct[r * C + c] = a.agc[g * C + c] && a.pool_agc[pi * C + c];
            a.pool[r] = (int)pi;
            a.alive[r] = 1;
        }
        for (i64 i = tid; i < (s1 - s0) * T; i += blockDim.x) {
            const i64 s = s0 + i / T, t = i % T;
            const i64 m_slot = (s - start == q - 1) ? last : cp;
            a.types[(s - lo) * T + t] = a.candn[t] && a.hrn[t] >= m_slot;
        }
        for (i64 d = tid; d < D; d += blockDim.x)
            a.pool_used[pi * D + d] = wadd(a.pool_used[pi * D + d],
                                           wmul(placed, R[d]));
        n_rem = wsub(n_rem, placed);
        __syncthreads();
    }
    return n_rem;
}

// The outputs of group g: takes[g - G0, :] = k as int32, leftover.
__device__ __forceinline__ void commit_outputs(const FfdArgs& a, i64 g,
                                               i64 n_rem) {
    for (i64 s = threadIdx.x; s < a.N; s += blockDim.x)
        a.takes[(g - a.G0) * a.N + s] = (int)a.k[s];
    if (threadIdx.x == 0) a.leftover[g - a.G0] = n_rem;
}
