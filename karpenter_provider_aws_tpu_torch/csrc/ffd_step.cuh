// The steps of one FFD group fill as device functions, shared by the K2
// kernels (ffd_scan.cu), the fused block kernels (fused.cu), the pruned
// scan's kernels (pruned.cu) and the per-rank kernels of the sharded scan
// (mesh.cu).
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

// Zeroes the n bytes at p on one warp: single bytes up to the first
// 16-byte boundary, 16-byte stores over the aligned middle, single bytes
// after it (a candidate row of T = 812 starts at every 4-byte offset
// mod 16 as s moves, so each row takes its own head and tail).
__device__ __forceinline__ void zero_bytes_warp(u8* p, i64 n) {
    const int wl = threadIdx.x & 31;
    i64 head = (i64)((16 - ((size_t)p & 15)) & 15);
    head = head < n ? head : n;
    const i64 nv = (n - head) >> 4;
    if (wl < head) p[wl] = 0;
    uint4* v = reinterpret_cast<uint4*>(p + head);
    for (i64 i = wl; i < nv; i += 32) v[i] = make_uint4(0u, 0u, 0u, 0u);
    const i64 t0 = head + (nv << 4);
    if (t0 + wl < n) p[t0 + wl] = 0;
}

// Steps 1-3 of group g for the slots [lo, hi) on one block (no minValues
// floors: K == 0), into the group's rows cand [N, T] and k [N]; the
// caller puts a barrier before reading them. `wr` (1, 2, 4 or 8,
// dividing the block's warps) warps take a slot row together, splitting
// its types; with wr > 1 the block zeroes its rows of k, waits at a
// barrier, and each warp's maximum goes in by a 64-bit atomicMax. A row
// whose pool does not take the group (an existing node, a free slot, a
// pool the group does not admit) skips the type loop: its first warp
// zeroes the candidate row by wide stores and, on an existing row,
// computes its allocatable's headroom across its lanes from loads issued
// with the row's first ones (D <= 32; a wider D loops).
__device__ __forceinline__ void slot_headroom_warps(const FfdArgs& a, i64 g,
                                                    u8* cand, i64* k,
                                                    i64 lo, i64 hi,
                                                    int wr = 1) {
    const i64 T = a.T, D = a.D, P = a.P, E = a.E;
    const i64* R = a.R + g * D;
    const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int sub = warp % wr, ngrp = (blockDim.x >> 5) / wr;
    const i64 rl = wl < D ? R[wl] : 0;       // this lane's request value
    if (wr > 1) {
        for (i64 s = lo + threadIdx.x; s < hi; s += blockDim.x) k[s] = 0;
        __syncthreads();
    }
    for (i64 s = lo + warp / wr; s < hi; s += ngrp) {
        const i64* used = a.used + s * D;
        const bool ex = s < E;               // warp-uniform
        const int pool = a.pool[s];
        i64 ul = 0, al = 0;
        u8 ok = 0;
        if (ex && sub == 0) {
            ok = a.alive[s] & a.ex_compat[g * E + s];
            if (wl < D) {
                ul = used[wl];
                al = a.ex_alloc[s * D + wl];
            }
        }
        const i64 pc = pool < 0 ? 0 : (pool > P - 1 ? P - 1 : pool);
        const bool adm_open = pool >= 0 && a.admit[g * P + pc];
        i64 kmax = 0;
        if (!adm_open) {
            if (sub == 0) zero_bytes_warp(cand + s * T, T);
        } else {
            for (i64 t = sub * 32 + wl; t < T; t += 32 * wr) {
                bool c = a.types[s * T + t] && a.F[g * T + t]
                    && offering_ok(a, g, s, t);
                cand[s * T + t] = c;
                if (c) {
                    i64 hr = headroom(a.A + t * D, used, R, D);
                    kmax = hr > kmax ? hr : kmax;
                }
            }
            for (int off = 16; off > 0; off >>= 1) {
                i64 o = __shfl_xor_sync(0xffffffffu, kmax, off);
                kmax = o > kmax ? o : kmax;
            }
        }
        if (ex && sub == 0) {                // the allocatable's headroom
            i64 m = rl > 0 ? floordiv(wsub(al, ul), rl) : KARP_BIG;
            for (i64 d = wl + 32; d < D; d += 32)
                if (R[d] > 0) {
                    const i64 q = floordiv(
                        wsub(a.ex_alloc[s * D + d], used[d]), R[d]);
                    m = q < m ? q : m;
                }
            for (int off = 16; off > 0; off >>= 1) {
                const i64 o = __shfl_xor_sync(0xffffffffu, m, off);
                m = o < m ? o : m;
            }
            kmax = ok ? (m < 0 ? 0 : m) : 0;
        }
        if (wl == 0) {
            if (wr == 1)
                k[s] = kmax;
            else if (kmax > 0 && (sub == 0 || !ex))
                atomicMax((long long*)&k[s], (long long)kmax);
        }
    }
}

// Threads of a CTA of the warp-row headroom (ffd_scan.cu and mesh.cu
// launch it).
constexpr int kRowThreads = 256;

// How the headroom's warps take the slot rows: `rows` rows a warp, or
// `warps` warps a row (1, 2, 4 or 8) splitting its types.
struct RowLayout {
    i64 rows, warps;
};

// Slot rows a CTA of the headroom takes under layout l.
__host__ __device__ __forceinline__ i64 block_rows(RowLayout l) {
    return l.warps > 1 ? (kRowThreads / 32) / l.warps
                       : l.rows * (kRowThreads / 32);
}

// The headroom's layout for L lanes of N slots, about two waves of the
// card's resident warps (the H100 holds 8,448 at once) over the L * N
// rows: with more rows than 16,384, rows a warp (at most 16); with fewer,
// as many warps a row (at most 8) as keep within the same count.
inline RowLayout k2_layout(i64 L, i64 N) {
    const i64 n = L * N, r = (n + 16383) / 16384;
    RowLayout l{r < 1 ? 1 : (r > 16 ? 16 : r), 1};
    while (l.warps < 8 && n * 2 * l.warps <= 16384) l.warps *= 2;
    return l;
}

// Step 4 of group g on one block: the pool-limit caps over each pool's
// slot prefix; k[s] of a capped pool's slot becomes its capped value.
// Reads the carry's pool and pool_used as they stand. Each thread owns the
// slot chunk [lo, hi).
__device__ __forceinline__ void commit_pool_caps(const FfdArgs& a, i64 g,
                                                 i64 lo, i64 hi, i64* tmp) {
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
// take[s]. Returns the block's total take to every thread.
__device__ __forceinline__ i64 commit_greedy(const FfdArgs& a, i64 g, i64 lo,
                                             i64 hi, i64* tmp) {
    const i64 n_rem = a.n[g];
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
// the launch holds the local slot rows [lo, lo + rows) of N slots whose
// first E are existing nodes (global id = lo + local row), `caps` [P] are
// the group's new-node caps already reduced over the type shards
// (minValues caps included) and `tbp` [P + 1] its take by pool (the last
// entry: rows of no pool) summed over the slot shards.
struct SlotWindow {
    i64 lo, rows, N, E;
    const i64* caps;
    const i64* tbp;
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

// The membership record of group g, a group without topology in the
// topology scan (topo_jax.py:685-702), kept by the commit that writes the
// group's takes (RecordArgs, ffd_common.cuh): the thread that writes slot
// s's take adds it into ch[mh, s] (one writer a slot: no atomics) and,
// where zfix[s] >= 0 and the take is positive, into the CTA's shared zone
// sums dz [Z]; after a barrier the CTA adds dz into cz[mz, :] by 64-bit
// atomics, wrapping sums that commute, so the bytes do not depend on the
// CTAs' order. The take is the int32 written to `takes`, sign-extended.
struct TakeRecord {
    i64* cz;
    i64* ch;
    const int* zfix;
    i64 mz, mh, Z, N;
    u64* dz;                // [Z] shared, zeroed before the CTA's first take
};

__device__ __forceinline__ void record_take(const TakeRecord* r, i64 s,
                                            int take32) {
    if (!r) return;
    const i64 take = (i64)take32;
    if (r->mh >= 0)
        r->ch[r->mh * r->N + s] = wadd(r->ch[r->mh * r->N + s], take);
    const int zf = r->zfix[s];
    if (zf >= 0 && take > 0)
        atomicAdd((unsigned long long*)&r->dz[zf], (unsigned long long)take);
}

// The CTA's zone sums into cz[mz, :], after a barrier over its takes.
__device__ __forceinline__ void record_flush(const TakeRecord* r) {
    if (!r) return;
    __syncthreads();
    if (r->mz < 0) return;
    for (i64 z = threadIdx.x; z < r->Z; z += blockDim.x)
        if (r->dz[z])
            atomicAdd((unsigned long long*)&r->cz[r->mz * r->Z + z],
                      (unsigned long long)r->dz[z]);
}

// The outputs of group g: takes[g - G0, :] = k as int32, leftover (and
// the membership record `rec`, when given).
__device__ __forceinline__ void commit_outputs(const FfdArgs& a, i64 g,
                                               i64 n_rem,
                                               const TakeRecord* rec =
                                                   nullptr) {
    for (i64 s = threadIdx.x; s < a.N; s += blockDim.x) {
        const int t = (int)a.k[s];
        a.takes[(g - a.G0) * a.N + s] = t;
        record_take(rec, s, t);
    }
    if (threadIdx.x == 0) a.leftover[g - a.G0] = n_rem;
    record_flush(rec);
}

// ---------------------------------------------------------------------------
// The new-node table (the fused and pruned scans, no minValues floors)
// ---------------------------------------------------------------------------
//
// What step 7 reads that no carry changes: for group g and pool pi, the
// fresh-node candidates candn [T], their headroom hrn [T] over the
// daemon overhead (0 elsewhere), the cap (the max of hrn) and, for the
// pruned scan, the opened rows' cap_hint row (the candidates' column max
// of A, 0-floored). The wide launch before each commit writes it, with
// table_blocks(T) blocks per (group, pool), each over kTableTypes types
// and each writing its partial cap and cap_hint row (the max over the
// partials is the table's, as every chunk holds a type); the commit's
// step 7 is then its scalars (one thread's walk over the pools) and one
// parallel pass over the opened rows, with no T-pass and no reduction
// over types.

// Words of new_node_scalars' output for P pools: the first opened slot,
// the number opened, then (q, start, last, cap) per pool.
__host__ __device__ __forceinline__ i64 nn_words(i64 P) { return 2 + 4 * P; }

// Types a table block covers, and the table blocks of one (group, pool).
constexpr i64 kTableTypes = 256;
__host__ __device__ __forceinline__ i64 table_blocks(i64 T) {
    return (T + kTableTypes - 1) / kTableTypes;
}

// Chunk c of the table of group g, pool pi on one block: candn/hrn over
// the chunk's types, the partial cap *cap and, when cap_row is non-null,
// the partial cap_hint row cap_row [D]. `red` holds 33 shared entries,
// `colmax` D (only with cap_row).
__device__ __forceinline__ void new_node_table_block(const FfdArgs& a, i64 g,
                                                     i64 pi, i64 c, u8* candn,
                                                     i64* hrn, i64* cap,
                                                     i64* cap_row, i64* red,
                                                     long long* colmax) {
    constexpr i64 kMin = -9223372036854775807LL - 1;
    const i64 T = a.T, D = a.D;
    const i64 t0 = c * kTableTypes;
    const i64 t1 = t0 + kTableTypes < T ? t0 + kTableTypes : T;
    const i64* R = a.R + g * D;
    const i64* dmn = a.daemon + (g * a.P + pi) * D;
    if (cap_row)
        for (i64 d = threadIdx.x; d < D; d += blockDim.x) colmax[d] = kMin;
    i64 kmax = 0;
    for (i64 t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
        const bool ok = new_node_cand(a, g, pi, t);
        const i64 hr = ok ? headroom(a.A + t * D, dmn, R, D) : 0;
        candn[t] = ok;
        hrn[t] = hr;
        kmax = hr > kmax ? hr : kmax;
    }
    const i64 m = block_max(kmax, red);   // its barriers order colmax's init
    if (threadIdx.x == 0) *cap = m;
    if (!cap_row) return;
    for (i64 d0 = 0; d0 < D; d0 += 8) {   // eight columns a pass
        i64 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = kMin;
        for (i64 t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
            const bool ok = candn[t];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const i64 x = d0 + j < D ? (ok ? a.A[t * D + d0 + j] : 0)
                                         : kMin;
                v[j] = x > v[j] ? x : v[j];
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            for (int off = 16; off > 0; off >>= 1) {
                const i64 o = __shfl_xor_sync(0xffffffffu, v[j], off);
                v[j] = o > v[j] ? o : v[j];
            }
            if ((threadIdx.x & 31) == 0 && d0 + j < D)
                atomicMax(&colmax[d0 + j], (long long)v[j]);
        }
    }
    __syncthreads();
    for (i64 d = threadIdx.x; d < D; d += blockDim.x) cap_row[d] = colmax[d];
}

// The shared inputs and scratch of new_node_scalars for the groups
// g0 .. g0+nf-1: pool usage pu [P, D] (updated in place), limits lim
// [P, D], the limited-pool flags [P], the request rows rq [nf, D], admit
// [nf, P], the caps [nf, P] (the max over the table blocks' partials),
// the remaining counts nrem [nf], num_nodes nn [1], and a group's budgets
// bud [P] and placed counts placed [P]. Staging them with every thread's
// loads at once leaves the one thread that walks the pools no global load.
struct NewNodeStage {
    i64 *pu, *lim, *limited, *rq, *adm, *cap, *nrem, *nn, *bud, *placed;
};

__host__ __device__ __forceinline__ i64 nn_stage_words(i64 P, i64 D,
                                                       i64 nf) {
    return 2 * P * D + 3 * P + nf * D + 2 * nf * P + nf + 1;
}

__device__ __forceinline__ NewNodeStage nn_stage_at(i64* w, i64 P, i64 D,
                                                    i64 nf) {
    NewNodeStage st;
    st.pu = w;
    st.lim = st.pu + P * D;
    st.limited = st.lim + P * D;
    st.rq = st.limited + P;
    st.adm = st.rq + nf * D;
    st.cap = st.adm + nf * P;
    st.nrem = st.cap + nf * P;
    st.nn = st.nrem + nf;
    st.bud = st.nn + 1;
    st.placed = st.bud + P;
    return st;
}

// Stage the new-node inputs of groups g0 .. g0+nf-1 (all threads of the
// block; the caller puts a barrier after): pu = pool_used plus, with
// `takes` [nf, P] (the groups' takes by pool), the sum of takes times R;
// `capn` [nf, P, table_blocks(T)] the groups' partial caps; nrem = n minus
// `taken` [nf] (the groups' fills). With a slot window `w` (one group:
// a slot-sharded mesh) the caps are the window's and nrem is n minus the
// sum of its take by pool; `capn` and `taken` are not read. Each thread
// starts its loads before its stores.
__device__ __forceinline__ void nn_stage(const FfdArgs& a, i64 g0, i64 nf,
                                         const i64* capn, const i64* takes,
                                         const i64* taken,
                                         const NewNodeStage& st,
                                         const SlotWindow* w = nullptr) {
    const i64 P = a.P, D = a.D, TB = table_blocks(a.T);
    i64 n_all = P * D > nf * P ? P * D : nf * P;
    n_all = n_all > nf * D ? n_all : nf * D;
    for (i64 i = threadIdx.x; i < n_all; i += blockDim.x) {
        i64 pu = 0, lim = 0, rq = 0, adm = 0, cap = 0, nr = 0;
        bool has = false;
        if (i < P * D) {
            const int q = (int)i / (int)D, d = (int)i - q * (int)D;
            pu = a.pool_used[i];
            lim = __ldg(&a.pool_limit[i]);
            if (takes)
                for (i64 f = 0; f < nf; ++f)
                    pu = wadd(pu, wmul(takes[f * P + q],
                                       __ldg(&a.R[(g0 + f) * D + d])));
        }
        if (i < nf * D) rq = __ldg(&a.R[g0 * D + i]);
        if (i < nf * P) {
            adm = __ldg(&a.admit[g0 * P + i]);
            if (w) {
                cap = w->caps[i];
            } else {
                for (i64 b = 0; b < TB; ++b) {
                    const i64 c = __ldg(&capn[i * TB + b]);
                    cap = c > cap ? c : cap;
                }
            }
        }
        if (i < P)
            for (i64 d = 0; d < D; ++d)
                has |= __ldg(&a.pool_limit[i * D + d]) >= 0;
        if (i < nf) {
            i64 t = 0;
            if (w)
                for (i64 p = 0; p <= P; ++p) t = wadd(t, w->tbp[p]);
            else
                t = taken[i];
            nr = wsub(__ldg(&a.n[g0 + i]), t);
        }
        if (i < P * D) {
            st.pu[i] = pu;
            st.lim[i] = lim;
        }
        if (i < nf * D) st.rq[i] = rq;
        if (i < nf * P) {
            st.adm[i] = adm;
            st.cap[i] = cap;
        }
        if (i < P) st.limited[i] = has;
        if (i < nf) st.nrem[i] = nr;
    }
    if (threadIdx.x == 0) st.nn[0] = a.num_nodes[0];
}

// The scalars of step 7 of the staged groups 0 .. nf-1 in order, on all
// threads of the block: per group, every pool's budget at once (a pool's
// budget reads only its own usage, which no other pool of the group
// changes), then thread 0's walk over the pools (can_place, q, placed, the
// opened run's start and last slot, num_nodes, n_rem; a negative
// can_place places a negative count, as the reference's wrapping int64
// does), then the placed pods' usage at once. Writes nn_words(P) words a
// group to sc, each group's remaining count to left[f] and num_nodes to
// st.nn (thread 0); ends at a barrier.
__device__ __forceinline__ void new_node_scalars(const NewNodeStage& st,
                                                 i64 nf, i64 P, i64 D, i64 N,
                                                 i64 E, i64* sc, i64* left) {
    for (i64 f = 0; f < nf; ++f) {
        const i64* R = st.rq + f * D;
        for (i64 pi = threadIdx.x; pi < P; pi += blockDim.x)
            st.bud[pi] = st.limited[pi]
                ? pool_budget(st.lim + pi * D, st.pu + pi * D, R, D)
                : KARP_BIG;
        __syncthreads();
        if (threadIdx.x == 0) {
            i64 n_rem = st.nrem[f], nn = st.nn[0];
            i64* w0 = sc + f * nn_words(P);
            w0[0] = E + nn;
            for (i64 pi = 0; pi < P; ++pi) {
                const i64 cap = st.cap[f * P + pi], budget = st.bud[pi];
                i64 can_place = 0;
                if (st.adm[f * P + pi] && cap >= 1)
                    can_place = n_rem < budget ? n_rem : budget;
                i64 q = can_place > 0
                    ? ceildiv(can_place, cap > 1 ? cap : 1) : 0;
                const i64 free_slots = N - E - nn;
                q = q < free_slots ? q : free_slots;
                const i64 qc = wmul(q, cap);
                const i64 placed = can_place < qc ? can_place : qc;
                i64* w = w0 + 2 + 4 * pi;
                w[0] = q;
                w[1] = E + nn;
                w[2] = wsub(placed, wmul(cap, q - 1));   // the last slot
                w[3] = cap;                                 // every other
                st.placed[pi] = placed;
                nn += q;
                n_rem = wsub(n_rem, placed);
            }
            w0[1] = E + nn - w0[0];
            st.nn[0] = nn;
            left[f] = n_rem;
        }
        __syncthreads();
        for (i64 i = threadIdx.x; i < P * D; i += blockDim.x) {
            const int pi = (int)i / (int)D;
            const i64 placed = st.placed[pi];
            if (placed)
                st.pu[i] = wadd(st.pu[i], wmul(placed, R[i - pi * D]));
        }
        __syncthreads();
    }
}

// The pods slot s takes from step 7 (0 when it was not opened), and its
// pool in *pool.
__device__ __forceinline__ i64 opened_pods(const i64* sc, i64 P, i64 s,
                                           i64* pool) {
    if (s < sc[0] || s >= sc[0] + sc[1]) return 0;
    for (i64 pi = 0; pi < P; ++pi) {
        const i64* w = sc + 2 + 4 * pi;
        if (s >= w[1] && s < w[1] + w[0]) {
            *pool = pi;
            return s - w[1] == w[0] - 1 ? w[2] : w[3];
        }
    }
    return 0;   // unreachable: the runs tile [sc[0], sc[0] + sc[1])
}

// The opened rows of step 7 of group g inside the row window [lo, hi),
// from new_node_scalars' output sc and the table candn/hrn [P, T] (and,
// with cap_hint, the partial rows cap_row [P, table_blocks(T), D]): used,
// types, zones, ct, pool, alive (and cap_hint). Row s is slot slot0 + s
// (a slot-sharded mesh's global ids; 0 elsewhere). Threads tid of nthr
// stride over the rows and over the (row, type) cells. k and takes are
// the caller's (new_node_take).
__device__ __forceinline__ void new_node_rows(const FfdArgs& a, i64 g,
                                              const i64* sc, const u8* candn,
                                              const i64* hrn,
                                              const i64* cap_row,
                                              i64* cap_hint, i64 lo, i64 hi,
                                              int tid, int nthr,
                                              i64 slot0 = 0) {
    const i64 T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const i64 o0 = sc[0] - slot0, o1 = sc[0] + sc[1] - slot0;
    const i64 s0 = o0 > lo ? o0 : lo;
    const i64 s1 = o1 < hi ? o1 : hi;
    if (s0 >= s1) return;
    const i64* R = a.R + g * D;
    for (i64 s = s0 + tid; s < s1; s += nthr) {
        i64 pi = 0;
        const i64 m = opened_pods(sc, P, slot0 + s, &pi);
        const i64* dmn = a.daemon + (g * P + pi) * D;
        for (i64 d = 0; d < D; ++d) {
            a.used[s * D + d] = wadd(a.used[s * D + d],
                                     wadd(wmul(m, R[d]), dmn[d]));
            if (!cap_hint) continue;
            const i64 TB = table_blocks(T);
            i64 v = cap_row[pi * TB * D + d];
            for (i64 c = 1; c < TB; ++c) {
                const i64 x = cap_row[(pi * TB + c) * D + d];
                v = x > v ? x : v;
            }
            cap_hint[s * D + d] = v;
        }
        for (i64 z = 0; z < Z; ++z)
            a.zones[s * Z + z] = a.agz[g * Z + z] && a.pool_agz[pi * Z + z];
        for (i64 c = 0; c < C; ++c)
            a.ct[s * C + c] = a.agc[g * C + c] && a.pool_agc[pi * C + c];
        a.pool[s] = (int)pi;
        a.alive[s] = 1;
    }
    for (i64 i = tid; i < (s1 - s0) * T; i += nthr) {
        const i64 s = s0 + i / T, t = i % T;
        i64 pi = 0;
        const i64 m = opened_pods(sc, P, slot0 + s, &pi);
        a.types[s * T + t] = candn[pi * T + t] && hrn[pi * T + t] >= m;
    }
}

// Row s's final take of group g: k[s] (the group's k row) plus what
// step 7 opened at slot slot0 + s, written back to k and to the takes row
// (and recorded by `rec`, when given).
__device__ __forceinline__ void new_node_take(const FfdArgs& a, i64* k,
                                              i64 g, const i64* sc, i64 s,
                                              i64 slot0 = 0,
                                              const TakeRecord* rec =
                                                  nullptr) {
    i64 pi = 0;
    const i64 v = wadd(k[s], opened_pods(sc, a.P, slot0 + s, &pi));
    k[s] = v;
    a.takes[(g - a.G0) * a.N + s] = (int)v;
    record_take(rec, s, (int)v);
}

// ---------------------------------------------------------------------------
// Steps 4-5 with few barriers (the fused and pruned commits)
// ---------------------------------------------------------------------------

// Most components a scan carries at once (the shared scratch's width).
constexpr int kScanW = 8;

// Block-wide exclusive scans of W <= kScanW wrapping sums at once: v
// holds this thread's values and becomes the sum over the threads before
// it; tmp[32 * kScanW + w] gets component w's block total. Warp shuffles
// and two barriers; the caller puts a barrier before tmp is used again.
template <int W>
__device__ __forceinline__ void block_scan_w(u64 (&v)[W], u64* tmp) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    u64 own[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        own[w] = v[w];
        for (int off = 1; off < 32; off <<= 1) {
            const u64 o = __shfl_up_sync(0xffffffffu, v[w], off);
            if (lane >= off) v[w] += o;
        }
        if (lane == 31) tmp[warp * kScanW + w] = v[w];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
            const u64 x = lane < nwarps ? tmp[lane * kScanW + w] : 0;
            u64 xi = x;
            for (int off = 1; off < 32; off <<= 1) {
                const u64 o = __shfl_up_sync(0xffffffffu, xi, off);
                if (lane >= off) xi += o;
            }
            if (lane < nwarps) tmp[lane * kScanW + w] = xi - x;
            if (lane == 31) tmp[32 * kScanW + w] = xi;
        }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < W; ++w)
        v[w] = tmp[warp * kScanW + w] + v[w] - own[w];
}

// A one-block commit's exchange of scan totals: nothing comes before the
// block (fused.cu's cluster exchange adds the earlier CTAs' totals).
struct BlockExchange {
    template <int W>
    __device__ __forceinline__ void add_before(u64 (&)[W], const u64*, int) {
    }
};

// Steps 4-5 of the groups i0 .. i0+nf-1 of a block (group i's k row at
// a.k + i*N: group_view's layout; a plain step is nf = 1, i0 = 0) over
// each thread's slot chunk [lo, hi), every group against the pool state
// as it stands: the pool-limit caps of the (group, limited pool) pairs
// in `comp` [ncomp] (f * P + pi, the groups counted from i0), then the
// greedy fills, WC and WG components a scan; k becomes take. The take
// total of group i is added to tks[i] (shared, zeroed by the caller).
// `scan` holds 33 * kScanW shared entries, `bud` kScanW. `X` adds the
// totals of the slots before this block (a cluster's earlier CTAs). Ends
// at a barrier.
template <int WC, int WG, class X>
__device__ __forceinline__ void fill_groups(const FfdArgs& a, i64 g0, i64 i0,
                                            i64 nf, i64 lo, i64 hi,
                                            const int* comp, int ncomp,
                                            u64* scan, i64* bud, X& xch,
                                            unsigned long long* tks) {
    const i64 N = a.N, D = a.D, P = a.P;
    for (i64 b = 0; b < ncomp; b += WC) {      // pool-limit caps
        const i64 nb = ncomp - b < WC ? ncomp - b : WC;
        if (threadIdx.x < nb) {
            const int c = comp[b + threadIdx.x], pi = c % (int)P;
            bud[threadIdx.x] = pool_budget(a.pool_limit + pi * D,
                                           a.pool_used + pi * D,
                                           a.R + (g0 + i0 + c / P) * D, D);
        }
        u64 v[WC];
#pragma unroll
        for (int j = 0; j < WC; ++j) {
            v[j] = 0;
            if (j < nb) {
                const int c = comp[b + j], pi = c % (int)P;
                const i64* k = a.k + (i0 + c / P) * N;
                for (i64 s = lo; s < hi; ++s)
                    if (a.pool[s] == pi) v[j] += (u64)k[s];
            }
        }
        block_scan_w(v, scan);                      // publishes bud
        xch.add_before(v, scan + 32 * kScanW, (int)nb);
#pragma unroll
        for (int j = 0; j < WC; ++j) {
            if (j >= nb) continue;
            const int c = comp[b + j], pi = c % (int)P;
            i64* k = a.k + (i0 + c / P) * N;
            i64 cum = (i64)v[j];
            for (i64 s = lo; s < hi; ++s) {
                if (a.pool[s] != pi) continue;
                const i64 kp = k[s];
                const i64 room = wsub(bud[j], cum);
                const i64 c2 = kp < room ? kp : room;
                cum = wadd(cum, kp);
                k[s] = c2 < 0 ? 0 : c2;
            }
        }
        __syncthreads();
    }
    for (i64 b = 0; b < nf; b += WG) {         // greedy prefix fills
        const i64 nb = nf - b < WG ? nf - b : WG;
        u64 v[WG];
#pragma unroll
        for (int j = 0; j < WG; ++j) {
            v[j] = 0;
            if (j < nb) {
                const i64* k = a.k + (i0 + b + j) * N;
                for (i64 s = lo; s < hi; ++s) v[j] += (u64)k[s];
            }
        }
        block_scan_w(v, scan);
        xch.add_before(v, scan + 32 * kScanW, (int)nb);
#pragma unroll
        for (int j = 0; j < WG; ++j) {
            if (j >= nb) continue;
            i64* k = a.k + (i0 + b + j) * N;
            const i64 n_rem = a.n[g0 + i0 + b + j];
            i64 cum = (i64)v[j];
            u64 tsum = 0;
            for (i64 s = lo; s < hi; ++s) {
                const i64 kk = k[s];
                i64 x = wsub(n_rem, cum);
                x = x < 0 ? 0 : x;
                const i64 take = x < kk ? x : kk;
                cum = wadd(cum, kk);
                k[s] = take;
                tsum += (u64)take;
            }
            for (int off = 16; off > 0; off >>= 1)
                tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
            if ((threadIdx.x & 31) == 0 && tsum)
                atomicAdd(&tks[i0 + b + j], tsum);
        }
        __syncthreads();
    }
}

// The pool-cap components of the groups g0 .. g0+nf-1: the pairs
// (group f, pool pi), as f * P + pi in pool order within each group, of a
// limited pool (a limit in some dimension) that the group admits. A pool
// the group does not admit has k = 0 on every one of its slots, so its
// caps change nothing. Warp 0 tests 32 pools at once and compacts them by
// ballot into comp; it writes their number to *ncomp. Other threads
// return.
__device__ __forceinline__ void cap_components(const FfdArgs& a, i64 g0,
                                               i64 nf, int* comp,
                                               int* ncomp) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int n = 0;
    for (i64 f = 0; f < nf; ++f) {
        for (i64 base = 0; base < a.P; base += 32) {
            const i64 q = base + lane;
            bool has = false;
            if (q < a.P && __ldg(&a.admit[(g0 + f) * a.P + q]))
                for (i64 d = 0; d < a.D; ++d)
                    has |= __ldg(&a.pool_limit[q * a.D + d]) >= 0;
            const unsigned m = __ballot_sync(0xffffffffu, has);
            if (has)
                comp[n + __popc(m & ((1u << lane) - 1))] = (int)(f * a.P + q);
            n += __popc(m);
        }
    }
    if (lane == 0) *ncomp = n;
}

// Takers a narrowing pass stages at once.
constexpr int kNarrowRows = 64;

// Step 6's flat pass over the takers' (slot, type) cells: for taker j of
// ntk, at slot slot_of(j), types[s, t] = cand_of(j, s, t) && the taker's
// used row fits A[t]. A thread per type holds A's row in registers (D <=
// 8) and walks the takers, whose used rows are staged kNarrowRows at a
// time in `tu` [kNarrowRows * D] of shared memory. Ends at a barrier,
// also with no taker.
template <class SlotOf, class CandOf>
__device__ __forceinline__ void narrow_cells(const FfdArgs& a, int ntk,
                                             SlotOf slot_of, CandOf cand_of,
                                             i64* tu) {
    const i64 T = a.T, D = a.D;
    for (int b0 = 0; b0 < ntk; b0 += kNarrowRows) {
        const int nb = ntk - b0 < kNarrowRows ? ntk - b0 : kNarrowRows;
        for (i64 i = threadIdx.x; i < nb * D; i += blockDim.x) {
            const int j = (int)i / (int)D;
            tu[i] = a.used[slot_of(b0 + j) * D + (i - j * D)];
        }
        __syncthreads();
        for (i64 t = threadIdx.x; t < T; t += blockDim.x) {
            if (D <= 8) {
                i64 av[8];
#pragma unroll
                for (int d = 0; d < 8; ++d)
                    av[d] = d < D ? __ldg(&a.A[t * D + d]) : 0;
                for (int j = 0; j < nb; ++j) {
                    bool fit = true;
#pragma unroll
                    for (int d = 0; d < 8; ++d)
                        fit &= d >= D || tu[j * D + d] <= av[d];
                    const i64 s = slot_of(b0 + j);
                    a.types[s * T + t] = fit && cand_of(b0 + j, s, t);
                }
            } else {
                for (int j = 0; j < nb; ++j) {
                    bool fit = true;
                    for (i64 d = 0; d < D; ++d)
                        fit &= tu[j * D + d] <= a.A[t * D + d];
                    const i64 s = slot_of(b0 + j);
                    a.types[s * T + t] = fit && cand_of(b0 + j, s, t);
                }
            }
        }
        __syncthreads();
    }
    if (ntk == 0) __syncthreads();
}
