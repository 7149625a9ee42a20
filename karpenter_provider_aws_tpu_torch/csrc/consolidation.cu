// K7, consolidation's batched search: the absorption scans of the
// deletion check and the replacement pre-screen, and the gather and
// summary around the subset lanes.
//
// Replaces karpenter_provider_aws_tpu/ops/consolidation_jax.py:
//
// consol_absorb (deletions_feasible_kernel :43, replacements_prescreen_
//   kernel :75, deletions_feasible_dense :142): per lane, a scan over its
//   G pod groups; each group fills the lane's surviving existing nodes by
//   a greedy prefix in name order: k[e] = min_d floor((alloc - used)/R)
//   (BIG over dims with R == 0, clipped to [0, BIG], 0 on incompatible or
//   dead rows), take = clip(n - exclusive_prefix(k), 0, k), used += take*R,
//   leftover = n - sum(take). One kernel, templated on the table layout
//   (shared node/signature tables indexed by gid/cid/alive, or per-lane
//   tables: the dense mode) and on the pre-screen tail (one admitted,
//   priced type that holds the aggregate leftover). One block per lane;
//   the loop over groups runs inside the block. The lane's used [E, D]
//   carry sits in dynamic shared memory when it fits (the wrapper
//   decides; above 48 KB after cudaFuncSetAttribute), else in a global
//   scratch. Each thread owns a contiguous chunk of node rows for the
//   whole scan, so the carry needs no barrier between groups; the
//   exclusive prefix over E is the block-wide chunked scan of
//   ffd_group_commit. The prefix and every sum wrap in unsigned 64-bit
//   like the reference's int64 cumsum: k reaches BIG = 1 << 60 on a group
//   whose R is 0 on every dim, and 8 such rows overflow int64.
//   What bounds it on this card: at the consolidation shapes (256 lanes,
//   256 nodes, one group) a launch reads well under a megabyte and does a
//   few million 64-bit divides, microseconds of work: it costs its launch
//   latency and the serial group loop of one block (PERF.md).
//   A fourth mode is K8, the preemption victim-set search
//   (karpenter_provider_aws_tpu/scheduling/preempt_jax.py:39
//   preempt_solve_kernel): the node and group tables are shared rows (no
//   gid/cid lookup, every node alive), each lane (one candidate victim
//   prefix) starts from its own refund, used = max(ex_used0 - freed[b],
//   0), and its answer is the wrapping int64 sum of every group's
//   leftover pods.
//
// subset_gather (the lane body of subset_solve_kernel :232-251):
//   materialises every lane's KernelInputs from the one union arena,
//   lane-major: R, F & keep, agz, agc, admit, daemon and ex_compat & ~dead
//   gathered by the lane's group rows gid; avail_zc & keep; ex_alloc and
//   ex_used0 zeroed on the lane's dead rows. Grid (x: chunks, y: lane),
//   threads stride over each output field. The lanes then run the K2
//   kernels on their lane axis (ffd_scan.cu). Bound: bytes (the lane
//   tensors are written once).
//
// subset_summary (:253-262): per lane the [5] row: total leftover, new
//   nodes, and over the first new slot's type mask t0 = types[E] & keep
//   (E the padded count of existing rows) the flexibility popcount(t0)
//   and the cheapest price min(t0 ? tprice : BIG) when a node was
//   minted, and savings = removed_price - (nodes == 1 ? min_price : 0).
//   One block per lane. Bound: bytes; it costs its launch.
#include <cuda_runtime.h>

#include "ffd_common.cuh"

// Mirror of ops/consolidation_cuda.py _AbsorbArgs (8-byte fields).
struct AbsorbArgs {
    const i64* ex_alloc;     // shared [E, D] | dense [B, E, D]
    const i64* ex_used0;     // shared [E, D] | dense [B, E, D]
    const u8* compat;        // shared compat_tab [Sc, E] | dense [B, G, E]
    const i64* R;            // shared R_tab [S, D] | dense [B, G, D]
    const int* gid;          // [B, G] -> S (shared layouts)
    const int* cid;          // [B, G] -> Sc (shared layouts)
    const i64* n;            // [B, G]
    const u8* alive;         // [B, E] (shared layouts)
    const i64* type_alloc;   // [T, D]   (pre-screen)
    const i64* type_price;   // [T]
    const u8* tcompat;       // [Sc, T]
    const u8* padmit;        // [P, Sc]
    const u8* pool_types;    // [P, T]
    const i64* price_cap;    // [B]
    i64* used_scratch;       // [B, E, D] when the carry is not in shared
    i64* leftover;           // [B, G]
    u8* out;                 // [B]
    const i64* freed;        // [B, E, D] refunds (preempt)
    i64* total;              // [B] leftover pods (preempt)
    i64 B, G, E, D, Sc, T, P;
    i64 used_in_smem;        // 1: the carry sits in dynamic shared memory
};

// Mirror of ops/consolidation_cuda.py _GatherArgs.
struct GatherArgs {
    const u8* avail_zc;      // [T, ZC]     union arena, shared
    const i64* R;            // [Gu, D]
    const u8* F;             // [Gu, T]
    const u8* agz;           // [Gu, Z]
    const u8* agc;           // [Gu, C]
    const u8* admit;         // [Gu, P]
    const i64* daemon;       // [Gu, P, D]
    const u8* ex_compat;     // [Gu, E]
    const i64* ex_alloc;     // [E, D]
    const i64* ex_used0;     // [E, D]
    const int* gid;          // [B, Gq] lanes
    const u8* dead;          // [B, E]
    const u8* keep;          // [B, T]
    u8* o_avail_zc;          // [B, T, ZC]  outputs, lane-major
    i64* o_R;                // [B, Gq, D]
    u8* o_F;                 // [B, Gq, T]
    u8* o_agz;               // [B, Gq, Z]
    u8* o_agc;               // [B, Gq, C]
    u8* o_admit;             // [B, Gq, P]
    i64* o_daemon;           // [B, Gq, P, D]
    u8* o_ex_compat;         // [B, Gq, E]
    i64* o_ex_alloc;         // [B, E, D]
    i64* o_ex_used0;         // [B, E, D]
    i64 B, Gq, T, ZC, D, Z, C, P, E;
};

// Mirror of ops/consolidation_cuda.py _SummaryArgs.
struct SummaryArgs {
    const i64* leftover;     // [B, Gq]
    const int* num_nodes;    // [B, 1]
    const u8* types;         // [B, N, T]
    const u8* keep;          // [B, T]
    const i64* tprice;       // [T]
    const i64* removed_price;  // [B]
    i64* out;                // [B, 5]
    i64 B, Gq, N, T, E;
};

namespace {

constexpr int kAbsorbThreads = 256;
constexpr int kGatherThreads = 256;
constexpr int kSummaryThreads = 256;

// k of node row e for the current group (R in shared memory `Rg`);
// ALIVE: the lane's alive row masks the node too
template <bool ALIVE>
__device__ __forceinline__ i64 absorb_k(const AbsorbArgs& a, i64 b,
                                        const u8* crow, const i64* alloc,
                                        const i64* used, const i64* Rg,
                                        i64 e) {
    const bool c = crow[e] && (!ALIVE || a.alive[b * a.E + e]);
    return c ? headroom(alloc + e * a.D, used + e * a.D, Rg, a.D) : 0;
}

// DENSE: per-lane tables; PRESCREEN: the one-new-node tail; PREEMPT: the
// group rows shared, a per-lane refund at load and the summed leftover
// out (K8). Otherwise the shared tables through gid/cid/alive.
template <bool DENSE, bool PRESCREEN, bool PREEMPT>
__global__ void __launch_bounds__(kAbsorbThreads)
consol_absorb_kernel(AbsorbArgs a) {
    constexpr bool ALIVE = !DENSE && !PREEMPT;
    extern __shared__ i64 dyn[];   // Rg [D], agg [D], pok [P], used [E*D]
    __shared__ i64 tmp[33];
    __shared__ int any_active;
    const i64 b = blockIdx.x;
    const i64 E = a.E, D = a.D, G = a.G;
    const int tid = threadIdx.x;
    i64* Rg = dyn;
    i64* agg = dyn + D;
    i64* pok = agg + D;
    i64* used = a.used_in_smem ? pok + a.P : a.used_scratch + b * E * D;
    const i64* alloc = DENSE ? a.ex_alloc + b * E * D : a.ex_alloc;
    const i64* used0 = DENSE ? a.ex_used0 + b * E * D : a.ex_used0;
    const i64 chunk = (E + blockDim.x - 1) / blockDim.x;
    const i64 lo = tid * chunk < E ? tid * chunk : E;
    const i64 hi = lo + chunk < E ? lo + chunk : E;
    if (PREEMPT) {
        const i64* fr = a.freed + b * E * D;
        for (i64 i = lo * D; i < hi * D; ++i) {
            const i64 u = wsub(used0[i], fr[i]);
            used[i] = u < 0 ? 0 : u;
        }
    } else {
        for (i64 i = lo * D; i < hi * D; ++i) used[i] = used0[i];
    }
    i64 total = 0;                     // thread 0's sum of leftovers (K8)

    for (i64 g = 0; g < G; ++g) {
        const i64 bg = b * G + g;
        const i64 ng = PREEMPT ? a.n[g] : a.n[bg];
        const i64* Rrow = DENSE ? a.R + bg * D
                        : PREEMPT ? a.R + g * D
                                  : a.R + (i64)a.gid[bg] * D;
        const u8* crow = DENSE ? a.compat + bg * E
                       : PREEMPT ? a.compat + g * E
                                 : a.compat + (i64)a.cid[bg] * E;
        __syncthreads();               // the last group's reads of Rg
        for (i64 d = tid; d < D; d += blockDim.x) Rg[d] = Rrow[d];
        __syncthreads();
        i64 local = 0;
        for (i64 e = lo; e < hi; ++e)
            local = wadd(local, absorb_k<ALIVE>(a, b, crow, alloc, used, Rg,
                                                e));
        i64 tot;
        i64 cum = block_excl_scan(local, tmp, &tot);
        i64 tsum = 0;
        for (i64 e = lo; e < hi; ++e) {
            const i64 k = absorb_k<ALIVE>(a, b, crow, alloc, used, Rg, e);
            i64 x = wsub(ng, cum);
            x = x < 0 ? 0 : x;
            const i64 take = x < k ? x : k;
            cum = wadd(cum, k);
            for (i64 d = 0; d < D; ++d)
                used[e * D + d] = wadd(used[e * D + d], wmul(take, Rg[d]));
            tsum = wadd(tsum, take);
        }
        i64 taken;
        block_excl_scan(tsum, tmp, &taken);
        if (tid == 0) {
            if (PREEMPT) total = wadd(total, wsub(ng, taken));
            else a.leftover[bg] = wsub(ng, taken);
        }
    }
    if (PREEMPT) {
        if (tid == 0) a.total[b] = total;
        return;
    }
    __syncthreads();                   // leftover rows are visible
    const i64* left = a.leftover + b * G;

    if (!PRESCREEN) {
        if (tid == 0) {
            bool ok = true;
            for (i64 g = 0; g < G; ++g) ok &= left[g] == 0;
            a.out[b] = ok;
        }
        return;
    }
    // ---- the one-new-node relaxation (consolidation_jax.py:126-136) ----
    const i64 T = a.T, P = a.P, Sc = a.Sc;
    const int* cids = a.cid + b * G;
    const int* gids = a.gid + b * G;
    if (tid == 0) {
        int act = 0;
        for (i64 g = 0; g < G; ++g) act |= left[g] > 0;
        any_active = act;
    }
    for (i64 d = tid; d < D; d += blockDim.x) {
        i64 s = 0;   // over every group: inactive rows add leftover*R too
        for (i64 g = 0; g < G; ++g)
            s = wadd(s, wmul(left[g], a.R[(i64)gids[g] * D + d]));
        agg[d] = s;
    }
    for (i64 p = tid; p < P; p += blockDim.x) {
        bool ok = true;
        for (i64 g = 0; g < G; ++g)
            ok &= !(left[g] > 0) || a.padmit[p * Sc + cids[g]];
        pok[p] = ok;
    }
    __syncthreads();
    const i64 cap = a.price_cap[b];
    int found = 0;
    for (i64 t = tid; t < T; t += blockDim.x) {
        bool ok = a.type_price[t] < cap;
        for (i64 g = 0; g < G && ok; ++g)
            ok = !(left[g] > 0) || a.tcompat[(i64)cids[g] * T + t];
        for (i64 d = 0; d < D && ok; ++d)
            ok = agg[d] <= a.type_alloc[t * D + d];
        bool pool = false;
        for (i64 p = 0; p < P && ok && !pool; ++p)
            pool = pok[p] && a.pool_types[p * T + t];
        found |= ok && pool;
    }
    found = __syncthreads_or(found);
    if (tid == 0) a.out[b] = found || !any_active;
}

__global__ void __launch_bounds__(kGatherThreads)
subset_gather_kernel(GatherArgs a) {
    const unsigned lane = grid_lane();
    if (lane >= a.B) return;   // the (y, z) grid's spare lanes
    const i64 b = lane;
    const i64 i0 = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    const i64 step = (i64)gridDim.x * blockDim.x;
    const i64 Gq = a.Gq, T = a.T, ZC = a.ZC, D = a.D, Z = a.Z, C = a.C;
    const i64 P = a.P, E = a.E;
    const int* gid = a.gid + b * Gq;
    const u8* keep = a.keep + b * T;
    const u8* dead = a.dead + b * E;
    for (i64 i = i0; i < T * ZC; i += step)
        a.o_avail_zc[b * T * ZC + i] = a.avail_zc[i] && keep[i / ZC];
    for (i64 i = i0; i < Gq * D; i += step)
        a.o_R[b * Gq * D + i] = a.R[(i64)gid[i / D] * D + i % D];
    for (i64 i = i0; i < Gq * T; i += step)
        a.o_F[b * Gq * T + i] = a.F[(i64)gid[i / T] * T + i % T]
            && keep[i % T];
    for (i64 i = i0; i < Gq * Z; i += step)
        a.o_agz[b * Gq * Z + i] = a.agz[(i64)gid[i / Z] * Z + i % Z];
    for (i64 i = i0; i < Gq * C; i += step)
        a.o_agc[b * Gq * C + i] = a.agc[(i64)gid[i / C] * C + i % C];
    for (i64 i = i0; i < Gq * P; i += step)
        a.o_admit[b * Gq * P + i] = a.admit[(i64)gid[i / P] * P + i % P];
    for (i64 i = i0; i < Gq * P * D; i += step)
        a.o_daemon[b * Gq * P * D + i] =
            a.daemon[(i64)gid[i / (P * D)] * P * D + i % (P * D)];
    for (i64 i = i0; i < Gq * E; i += step)
        a.o_ex_compat[b * Gq * E + i] =
            a.ex_compat[(i64)gid[i / E] * E + i % E] && !dead[i % E];
    for (i64 i = i0; i < E * D; i += step) {
        const bool gone = dead[i / D];
        a.o_ex_alloc[b * E * D + i] = gone ? 0 : a.ex_alloc[i];
        a.o_ex_used0[b * E * D + i] = gone ? 0 : a.ex_used0[i];
    }
}

__global__ void __launch_bounds__(kSummaryThreads)
subset_summary_kernel(SummaryArgs a) {
    __shared__ unsigned long long flex;
    __shared__ long long minp;
    const i64 b = blockIdx.x, T = a.T;
    if (threadIdx.x == 0) {
        flex = 0;
        minp = 0x7fffffffffffffffLL;
    }
    __syncthreads();
    const u8* t0 = a.types + (b * a.N + a.E) * T;
    const u8* keep = a.keep + b * T;
    unsigned long long cnt = 0;
    long long mp = 0x7fffffffffffffffLL;
    for (i64 t = threadIdx.x; t < T; t += blockDim.x) {
        const bool on = t0[t] && keep[t];
        cnt += on;
        const long long p = on ? a.tprice[t] : KARP_BIG;
        mp = p < mp ? p : mp;
    }
    atomicAdd(&flex, cnt);
    atomicMin(&minp, mp);
    __syncthreads();
    if (threadIdx.x == 0) {
        i64 left = 0;
        for (i64 g = 0; g < a.Gq; ++g)
            left = wadd(left, a.leftover[b * a.Gq + g]);
        const i64 nn = a.num_nodes[b];
        const bool minted = nn > 0;
        const i64 min_price = minted ? (i64)minp : 0;
        i64* o = a.out + b * 5;
        o[0] = left;
        o[1] = nn;
        o[2] = minted ? (i64)flex : 0;
        o[3] = min_price;
        o[4] = wsub(a.removed_price[b], nn == 1 ? min_price : 0);
    }
}

int set_smem(const void* fn, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool DENSE, bool PRESCREEN, bool PREEMPT>
int launch_absorb(const AbsorbArgs* a, void* stream) {
    size_t smem = (size_t)(2 * a->D + a->P) * sizeof(i64);
    if (a->used_in_smem) smem += (size_t)(a->E * a->D) * sizeof(i64);
    auto fn = consol_absorb_kernel<DENSE, PRESCREEN, PREEMPT>;
    int err = set_smem((const void*)fn, smem);
    if (err) return err;
    fn<<<(unsigned)a->B, kAbsorbThreads, smem, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 0: deletions (shared tables), 1: pre-screen (shared tables + the
// one-new-node tail), 2: dense (per-lane tables), 3: preempt (K8: shared
// group rows, per-lane refunds)
int karp_consol_absorb(const AbsorbArgs* a, int mode, void* stream) {
    switch (mode) {
        case 0: return launch_absorb<false, false, false>(a, stream);
        case 1: return launch_absorb<false, true, false>(a, stream);
        case 2: return launch_absorb<true, false, false>(a, stream);
        case 3: return launch_absorb<false, false, true>(a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

int karp_subset_gather(const GatherArgs* a, void* stream) {
    i64 most = a->T * a->ZC;
    const i64 sizes[] = {a->Gq * a->D, a->Gq * a->T, a->Gq * a->P * a->D,
                         a->Gq * a->E, a->E * a->D};
    for (i64 s : sizes) most = s > most ? s : most;
    i64 bx = (most + kGatherThreads - 1) / kGatherThreads;
    bx = bx < 1 ? 1 : (bx > 64 ? 64 : bx);
    dim3 grid((unsigned)bx);
    lane_grid(a->B, &grid);
    subset_gather_kernel<<<grid, kGatherThreads, 0, (cudaStream_t)stream>>>(
        *a);
    return (int)cudaGetLastError();
}

int karp_subset_summary(const SummaryArgs* a, void* stream) {
    subset_summary_kernel<<<(unsigned)a->B, kSummaryThreads, 0,
                            (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // extern "C"
