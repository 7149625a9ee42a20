// K7, consolidation's batched search: the absorption scans of the
// deletion check and the replacement pre-screen, and the gather before
// the subset lanes.
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
//   ex_used0 zeroed on the lane's dead rows. Bound: bytes (the lane
//   tensors are written once; ex_alloc / ex_used0 are ~90% of them). Grid
//   (x: X CTAs a lane, y/z: the lane); X by bytes (karp_subset_gather_
//   grid: about four waves of the card's resident CTAs, each CTA writing
//   at least kGatherCtaBytes), each field's rows cut into X contiguous
//   slices. Every store is 16 bytes where the row allows it: a row is cut
//   at its destination's 16-byte boundaries (single bytes or 8-byte words
//   before the first and after the last), and its sources are read as 16-
//   or 4-byte words where they share the destination's alignment, as
//   bytes otherwise (a row of T = 812 bytes starts at every 4-byte offset
//   mod 16). The byte fields AND words of the source with words of the
//   mask (keep, or the complement of dead); avail_zc's mask is keep of the
//   row's type, walked with a counter. The group rows go a warp a row, the
//   gid loaded once; the existing rows 16 bytes a thread, the dead flag
//   by the 32-bit row index. No 64-bit division per element: each lane's
//   sizes are far below 2^31. The lanes then run the K2 kernels on their
//   lane axis (ffd_scan.cu).
//
// The lanes' summary rows (:253-262) are written by the round's last
//   ffd_group_commit launch (ffd_scan.cu, SummaryArgs in ffd_common.cuh).
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

namespace {

constexpr int kAbsorbThreads = 256;
constexpr int kGatherThreads = 256;
// the least bytes one CTA of the gather writes (its stores in flight), and
// the waves of resident CTAs the grid aims at
constexpr i64 kGatherCtaBytes = 16 * 1024;
constexpr i64 kGatherWaves = 4;

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

// 16 bytes at p, read as one 16-byte word (al 16), four 4-byte words (al
// 4) or sixteen bytes (al 1): p's alignment
__device__ __forceinline__ uint4 ld16(const u8* p, int al) {
    if (al == 16) return *reinterpret_cast<const uint4*>(p);
    uint4 v;
    unsigned* w = reinterpret_cast<unsigned*>(&v);
    if (al == 4) {
        const unsigned* q = reinterpret_cast<const unsigned*>(p);
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = q[i];
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            w[i] = (unsigned)p[4 * i] | (unsigned)p[4 * i + 1] << 8
                | (unsigned)p[4 * i + 2] << 16 | (unsigned)p[4 * i + 3] << 24;
    }
    return v;
}

// the alignment ld16 reads src with, where dst is 16-byte aligned at the
// same offset
__device__ __forceinline__ int rel_align(const void* src, const void* dst) {
    const size_t d = ((size_t)src - (size_t)dst) & 15;
    return d == 0 ? 16 : ((d & 3) == 0 ? 4 : 1);
}

// The cut of a row of n bytes at dst: `head` bytes up to dst's first
// 16-byte boundary, nv 16-byte words, then the tail.
struct RowCut {
    i64 head, nv, tail;
};
__device__ __forceinline__ RowCut row_cut(const void* dst, i64 n) {
    RowCut c;
    c.head = (i64)((16 - ((size_t)dst & 15)) & 15);
    c.head = c.head < n ? c.head : n;
    c.nv = (n - c.head) >> 4;
    c.tail = n - c.head - (c.nv << 4);
    return c;
}

// dst[i] = src[i] & mask[i] (inv: & ~mask[i]) for the n bytes of a row
// on one warp; the bytes are 0 or 1, so the complement's 0xfe clears a 1.
__device__ __forceinline__ void and_row_warp(u8* dst, const u8* src,
                                             const u8* mask, bool inv,
                                             i64 n) {
    const int wl = threadIdx.x & 31;
    const RowCut c = row_cut(dst, n);
    const u8 flip = inv ? 0xff : 0;
    if (wl < c.head) dst[wl] = src[wl] & (mask[wl] ^ flip);
    const int as = rel_align(src + c.head, dst + c.head);
    const int am = rel_align(mask + c.head, dst + c.head);
    const unsigned fw = inv ? ~0u : 0u;
    for (i64 k = wl; k < c.nv; k += 32) {
        const i64 o = c.head + (k << 4);
        const uint4 v = ld16(src + o, as), m = ld16(mask + o, am);
        *reinterpret_cast<uint4*>(dst + o) = make_uint4(
            v.x & (m.x ^ fw), v.y & (m.y ^ fw), v.z & (m.z ^ fw),
            v.w & (m.w ^ fw));
    }
    const i64 t0 = c.head + (c.nv << 4);
    if (wl < c.tail) dst[t0 + wl] = src[t0 + wl] & (mask[t0 + wl] ^ flip);
}

// dst[i] = src[i] for the n bytes of a short row on one warp
__device__ __forceinline__ void copy_bytes_warp(u8* dst, const u8* src,
                                                i64 n) {
    for (i64 i = threadIdx.x & 31; i < n; i += 32) dst[i] = src[i];
}

// dst[i] = src[i] for the n 8-byte words of a row on one warp: 16-byte
// words where dst and src share their alignment mod 16, a single word
// before and after them
__device__ __forceinline__ void copy_i64_warp(i64* dst, const i64* src,
                                              i64 n) {
    const int wl = threadIdx.x & 31;
    if ((((size_t)dst ^ (size_t)src) & 15) != 0) {
        for (i64 i = wl; i < n; i += 32) dst[i] = src[i];
        return;
    }
    const i64 h = ((size_t)dst & 15) && n > 0 ? 1 : 0;
    const i64 nv = (n - h) >> 1;
    if (wl == 0 && h) dst[0] = src[0];
    const uint4* s = reinterpret_cast<const uint4*>(src + h);
    uint4* d = reinterpret_cast<uint4*>(dst + h);
    for (i64 k = wl; k < nv; k += 32) d[k] = s[k];
    if (wl == 0 && h + 2 * nv < n) dst[n - 1] = src[n - 1];
}

// [lo, hi) of slice x of X over n units
__device__ __forceinline__ void slice(i64 n, i64 x, i64 X, i64* lo,
                                      i64* hi) {
    *lo = n * x / X;
    *hi = n * (x + 1) / X;
}

__global__ void __launch_bounds__(kGatherThreads)
subset_gather_kernel(const __grid_constant__ GatherArgs a) {
    const unsigned lane = grid_lane();
    if (lane >= a.B) return;   // the (y, z) grid's spare lanes
    const i64 b = lane, x = blockIdx.x, X = gridDim.x;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int warp = tid >> 5, nwarp = nth >> 5;
    const i64 Gq = a.Gq, T = a.T, ZC = a.ZC, D = a.D, Z = a.Z, C = a.C;
    const i64 P = a.P, E = a.E;
    const u8* keep = a.keep + b * T;
    const u8* dead = a.dead + b * E;
    i64 lo, hi;

    // avail_zc & keep[type]: the lane's T*ZC bytes cut at the
    // destination's 16-byte boundaries; CTA x takes a slice of the 16-byte
    // words, CTA 0 the head and the tail bytes
    {
        const i64 n = T * ZC;
        u8* dst = a.o_avail_zc + b * n;
        const RowCut c = row_cut(dst, n);
        const unsigned zc = (unsigned)ZC;
        if (x == 0) {
            if (tid < c.head)
                dst[tid] = a.avail_zc[tid] & keep[(unsigned)tid / zc];
            const i64 t0 = c.head + (c.nv << 4);
            if (tid < c.tail) {
                const unsigned i = (unsigned)(t0 + tid);
                dst[i] = a.avail_zc[i] & keep[i / zc];
            }
        }
        const int as = rel_align(a.avail_zc + c.head, dst + c.head);
        slice(c.nv, x, X, &lo, &hi);
        for (i64 k = lo + tid; k < hi; k += nth) {
            const unsigned o = (unsigned)(c.head + (k << 4));
            const uint4 v = ld16(a.avail_zc + o, as);
            // keep of each byte's type: a counter from o's type
            unsigned t = o / zc, r = o - t * zc;
            unsigned m[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                if (keep[t]) m[j >> 2] |= 0xffu << (8 * (j & 3));
                if (++r == zc) {
                    r = 0;
                    ++t;
                }
            }
            *reinterpret_cast<uint4*>(dst + o) =
                make_uint4(v.x & m[0], v.y & m[1], v.z & m[2], v.w & m[3]);
        }
    }

    // the group rows of slice x: a warp a row, its gid loaded once
    slice(Gq, x, X, &lo, &hi);
    for (i64 q = lo + warp; q < hi; q += nwarp) {
        const i64 r = b * Gq + q;
        const i64 g = a.gid[r];
        copy_i64_warp(a.o_R + r * D, a.R + g * D, D);
        and_row_warp(a.o_F + r * T, a.F + g * T, keep, false, T);
        copy_bytes_warp(a.o_agz + r * Z, a.agz + g * Z, Z);
        copy_bytes_warp(a.o_agc + r * C, a.agc + g * C, C);
        copy_bytes_warp(a.o_admit + r * P, a.admit + g * P, P);
        copy_i64_warp(a.o_daemon + r * P * D, a.daemon + g * P * D, P * D);
        and_row_warp(a.o_ex_compat + r * E, a.ex_compat + g * E, dead, true,
                     E);
    }

    // the existing rows of slice x: ex_alloc and ex_used0, 0 on the lane's
    // dead rows; 16 bytes (two words) a thread where the lane's table and
    // the arena's share their alignment mod 16, the row of a word by 32-bit
    // division
    slice(E, x, X, &lo, &hi);
    {
        const i64 w0 = lo * D, w1 = hi * D;      // the slice's words
        i64* da = a.o_ex_alloc + b * E * D;
        i64* du = a.o_ex_used0 + b * E * D;
        const unsigned d = (unsigned)D;
        if (((((size_t)da ^ (size_t)a.ex_alloc)
              | ((size_t)du ^ (size_t)a.ex_used0)
              | ((size_t)da ^ (size_t)du)) & 15) == 0) {
            // a first word before the 16-byte boundary, pairs, a last word
            const i64 h = (((size_t)(da + w0) & 15) && w1 > w0) ? 1 : 0;
            const i64 np = (w1 - w0 - h) >> 1;
            if (tid == 0 && h) {
                const bool gone = dead[(unsigned)w0 / d];
                da[w0] = gone ? 0 : a.ex_alloc[w0];
                du[w0] = gone ? 0 : a.ex_used0[w0];
            }
            const i64 p0 = w0 + h;
#pragma unroll 4
            for (i64 k = tid; k < np; k += nth) {
                const unsigned i = (unsigned)(p0 + 2 * k);
                const unsigned e = i / d;
                const bool g0 = dead[e], g1 = dead[(i + 1 - e * d) == d
                                                   ? e + 1 : e];
                uint4 va = *reinterpret_cast<const uint4*>(a.ex_alloc + i);
                uint4 vu = *reinterpret_cast<const uint4*>(a.ex_used0 + i);
                if (g0) va.x = va.y = vu.x = vu.y = 0u;
                if (g1) va.z = va.w = vu.z = vu.w = 0u;
                *reinterpret_cast<uint4*>(da + i) = va;
                *reinterpret_cast<uint4*>(du + i) = vu;
            }
            const i64 wl = p0 + 2 * np;
            if (tid == 0 && wl < w1) {
                const bool gone = dead[(unsigned)wl / d];
                da[wl] = gone ? 0 : a.ex_alloc[wl];
                du[wl] = gone ? 0 : a.ex_used0[wl];
            }
        } else {
            for (i64 i = w0 + tid; i < w1; i += nth) {
                const bool gone = dead[(unsigned)i / d];
                da[i] = gone ? 0 : a.ex_alloc[i];
                du[i] = gone ? 0 : a.ex_used0[i];
            }
        }
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

// The gather's CTAs a lane (X) and the card's resident CTAs of the kernel
// (slots): X = ceil(kGatherWaves * slots / B), at most the lane's bytes
// over kGatherCtaBytes, at least 1 (ops/consolidation_cuda.py
// gather_ctas is its mirror).
int karp_subset_gather_grid(const GatherArgs* a, long long* X,
                            long long* slots) {
    // the resident CTAs of each device, asked once
    static long long cached[64] = {0};
    int dev = 0, sms = 0, per = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (dev >= 64 || cached[dev] == 0) {
        err = (int)cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev);
        if (!err)
            err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per, subset_gather_kernel, kGatherThreads, 0);
        if (err) return err;
        if (dev < 64) cached[dev] = (long long)sms * per;
    }
    const i64 s = dev < 64 ? cached[dev] : (i64)sms * per;
    const i64 lane_bytes = a->T * a->ZC + 16 * a->E * a->D
        + a->Gq * (8 * a->D + a->T + a->Z + a->C + a->P + 8 * a->P * a->D
                   + a->E);
    const i64 B = a->B > 1 ? a->B : 1;
    i64 x = (kGatherWaves * s + B - 1) / B;
    const i64 most = lane_bytes / kGatherCtaBytes;
    x = x < most ? x : most;
    *X = x < 1 ? 1 : x;
    *slots = s;
    return 0;
}

int karp_subset_gather(const GatherArgs* a, void* stream) {
    long long X = 1, slots = 0;
    const int err = karp_subset_gather_grid(a, &X, &slots);
    if (err) return err;
    dim3 grid((unsigned)X);
    lane_grid(a->B, &grid);
    subset_gather_kernel<<<grid, kGatherThreads, 0, (cudaStream_t)stream>>>(
        *a);
    return (int)cudaGetLastError();
}

}  // extern "C"
