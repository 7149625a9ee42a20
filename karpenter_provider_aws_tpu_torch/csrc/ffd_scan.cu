// K2, the base FFD group scan, as two kernels launched once per group.
//
// Replaces karpenter_provider_aws_tpu/ops/ffd_jax.py:_solve (the lax.scan
// over plain_group_step; _fill_phase, _new_nodes_phase, _headroom_matrix,
// _headroom_vec, _mv_h1, _mv_cap, _pool_budget_jax, _cumsum). The carry
// (used/types/zones/ct/pool/alive/num_nodes/pool_used) stays in device
// memory for the whole scan; the host enqueues 2*G launches on one stream
// with no synchronisation in between.
//
// The lane axis (FfdArgs.L, lane_bytes; ffd_common.cuh): L independent
// solves of one shape in each launch. The lane rides grid y and z of the
// headroom grid (lane_grid; y alone holds 65,535 blocks) and grid x of
// the commit grid. The kernel bodies read the lane's own view of the
// arguments and are otherwise those of a single solve; a consolidation
// subset round (consolidation.cu) runs its B lanes this way, 2*G
// launches whatever B is.
//
// ffd_slot_headroom (steps 1-3): one block per slot row. The block's
//   threads stride over the T instance types, compute the candidate mask
//   (a boolean any-reduction over zone x capacity-type offerings, never an
//   integer matmul) and the headroom min_d floor((A - used) / R), write
//   cand[s, :] and reduce k[s] as a block max. Existing rows (s < E) take
//   their own allocatable's headroom. With minValues floors (K > 0) the
//   block also runs the per-(key, value) segment max in shared memory
//   (64-bit atomicMax) and the f-th-largest select.
//   What bounds it on this card: at the 50k-pod, 812-type shape a launch
//   moves about 0.5 MB and divides only on candidate cells and on dims
//   with R > 0 (3 of the 8 padded dims), so neither bytes nor the
//   emulated 64-bit divides (Hopper has no hardware one) come near the
//   measured time: a launch costs its latency, one wave of N blocks
//   (PERF.md has the times). The design keeps every slot row in one
//   block so the k[s] max needs no second pass.
//
// ffd_group_commit (steps 4-7): one block of 1024 threads per lane.
//   Pool-limit caps and the greedy fill use block-wide exclusive scans
//   over the N slots (each thread owns a contiguous chunk; wrapping
//   64-bit sums); then the narrowing of filled slots over N x T, the
//   per-pool accounting, and the
//   new-node phase pool by pool (block max over T, q, slot writes). It
//   writes takes[g - G0, :] as int32 and leftover[g - G0] (G0 is the
//   first group of the scanned window: 0 for a full scan, the resume
//   group of a suffix re-solve, csrc/ckpt.cu). One block is a serial
//   section by design: the scan's order is the decision order. What
//   bounds it: the latency of one block walking a few dozen barriers and
//   the N-slot loop of the narrowing, not bytes or operations (PERF.md).
//
// A later PR would: compute the quotient in fp64 and correct it with one
//   int64 multiply-compare (exact, and off the emulated divide); and fuse
//   the scan into one persistent launch per solve (a cluster or a grid
//   barrier between the phases) instead of 2*G launches.
#include <cuda_runtime.h>

#include "ffd_common.cuh"

namespace {

constexpr int kHeadroomThreads = 256;
constexpr int kCommitThreads = 1024;

__global__ void __launch_bounds__(kHeadroomThreads)
ffd_slot_headroom_kernel(FfdArgs args, i64 g) {
    extern __shared__ i64 dyn[];   // h1 [K*V], sel [K]
    __shared__ i64 red[33];
    const unsigned lane = grid_lane();
    if (lane >= args.L) return;   // the (y, z) grid's spare lanes
    const FfdArgs a = lane_view(args, lane);
    const i64 s = blockIdx.x;
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

__global__ void __launch_bounds__(kCommitThreads)
ffd_group_commit_kernel(FfdArgs args, i64 g) {
    extern __shared__ i64 dyn[];   // take_by_pool [P], h1 [K*V], sel [K]
    const FfdArgs a = lane_view(args, blockIdx.x);
    __shared__ i64 tmp[33];
    __shared__ i64 sc[8];          // broadcast scalars of the new-node phase
    const i64 N = a.N, T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const i64 E = a.E, K = a.K, V = a.V, M = a.M;
    const i64* R = a.R + g * D;
    const int tid = threadIdx.x;
    const i64 chunk = (N + blockDim.x - 1) / blockDim.x;
    const i64 lo = tid * chunk, hi = lo + chunk < N ? lo + chunk : N;
    i64* tbp = dyn;
    i64* h1 = dyn + P;
    i64* sel = h1 + K * V;

    // ---- step 4: pool-limit caps over each pool's slot prefix ----------
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

    // ---- step 5: greedy prefix fill; k[s] becomes take[s] --------------
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

    // ---- step 6: narrowing of the filled open slots + pool accounting --
    for (i64 i = tid; i < N * D; i += blockDim.x) {
        i64 s = i / D, d = i % D;
        a.used[i] = wadd(a.used[i], wmul(a.k[s], R[d]));
    }
    for (i64 p = tid; p < P; p += blockDim.x) tbp[p] = 0;
    __syncthreads();
    for (i64 s = 0; s < N; ++s) {           // uniform branch per slot
        if (!(a.k[s] > 0 && a.pool[s] >= 0)) continue;
        const i64* us = a.used + s * D;
        for (i64 t = tid; t < T; t += blockDim.x) {
            bool fit = true;
            for (i64 d = 0; d < D; ++d) fit &= us[d] <= a.A[t * D + d];
            a.types[s * T + t] = a.cand[s * T + t] && fit;
        }
    }
    for (i64 s = tid; s < N; s += blockDim.x) {
        const int pool = a.pool[s];
        if (!(a.k[s] > 0 && pool >= 0)) continue;
        for (i64 z = 0; z < Z; ++z) a.zones[s * Z + z] &= a.agz[g * Z + z];
        for (i64 c = 0; c < C; ++c) a.ct[s * C + c] &= a.agc[g * C + c];
        const i64 pc = pool > P - 1 ? P - 1 : pool;
        atomicAdd((unsigned long long*)&tbp[pc], (unsigned long long)a.k[s]);
    }
    __syncthreads();
    for (i64 i = tid; i < P * D; i += blockDim.x) {
        i64 p = i / D, d = i % D;
        a.pool_used[i] = wadd(a.pool_used[i], wmul(tbp[p], R[d]));
    }
    __syncthreads();

    // ---- step 7: new nodes, pool by pool --------------------------------
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
        i64 cap = block_max(cmax, tmp);   // its barriers publish hrn/candn
        if (K > 0) {
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

int karp_ffd_slot_headroom(const FfdArgs* a, long long g, void* stream) {
    size_t smem = (size_t)(a->K * a->V + a->K) * sizeof(i64);
    int err = set_smem((const void*)ffd_slot_headroom_kernel, smem);
    if (err) return err;
    dim3 grid((unsigned)a->N);
    lane_grid(a->L, &grid);
    ffd_slot_headroom_kernel<<<grid, kHeadroomThreads, smem,
                               (cudaStream_t)stream>>>(*a, g);
    return (int)cudaGetLastError();
}

int karp_ffd_group_commit(const FfdArgs* a, long long g, void* stream) {
    size_t smem = (size_t)(a->P + a->K * a->V + a->K) * sizeof(i64);
    int err = set_smem((const void*)ffd_group_commit_kernel, smem);
    if (err) return err;
    ffd_group_commit_kernel<<<(unsigned)a->L, kCommitThreads, smem,
                              (cudaStream_t)stream>>>(*a, g);
    return (int)cudaGetLastError();
}

}  // extern "C"
