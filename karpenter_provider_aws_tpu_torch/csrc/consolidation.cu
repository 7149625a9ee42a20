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
//   tables: the dense mode), on the pre-screen tail (one admitted, priced
//   type that holds the aggregate leftover) and on the form. A lane is one
//   CTA of 256 threads; the group loop runs inside it. Each thread owns a
//   contiguous chunk of the lane's rows in name order and keeps their
//   slack alloc - used (and the compat bytes of the next group) to itself:
//   in registers at up to 4 rows of 8 dims (form 0; as fp64, exact, while
//   every slack lies in (-2^51, 2^51)), else in shared memory or a global
//   scratch, a warp's threads on neighbouring words (forms 1, 2; the
//   wrapper picks by E and D). Per group: k of each owned row once (fp64
//   rows: every row and dim at once, without a branch or a 64-bit
//   division, the nearest integer of the slack times the staged 1 / R,
//   corrected by the exact remainder; int64 rows: floordiv_rcp), kept for
//   the takes; a warp scan; ONE CTA barrier after which each thread adds
//   the earlier warps' totals (double-buffered by group parity); the
//   takes. The group's R row, its reciprocals and fp64 copy are staged a
//   group ahead in one of three buffers, its n and compat bytes loaded a
//   group ahead. The take sums ride the next group's barrier (K7's
//   leftover[g - 1]) or are summed by each thread over the whole scan
//   (K8: sum n - sum taken); the end sums each warp's partial. The
//   pre-screen tail reads the leftovers with all threads (block votes,
//   shared atomics for the aggregate), then a thread a type. The prefix
//   and every sum wrap in unsigned 64-bit like the reference's int64
//   cumsum: k reaches BIG = 1 << 60 on a group whose R is 0 on every dim,
//   and 8 such rows overflow int64.
//   What bounds it on this card: latency. Clock stamps of the earlier
//   form (one CTA a lane, k computed twice a group by 64-bit divisions,
//   two block scans) put 90% of a group's ~28,000 cycles at K8's G = 256
//   (64 lanes, 1,000 nodes, D = 6) in the two k passes' divisions and
//   7% in the two block scans; this form's stamps and times are in
//   PERF.md. At round (c) (256 lanes, 256 nodes, one group) a
//   launch is its own latency and the serial group body.
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
    i64* scratch;            // [B, absorb_row_words] the rows (form 2)
    i64* leftover;           // [B, G]
    u8* out;                 // [B]
    const i64* freed;        // [B, E, D] refunds (preempt)
    i64* total;              // [B] leftover pods (preempt)
    i64 B, G, E, D, Sc, T, P;
    i64 form;                // where a thread keeps its rows: 0 registers,
                             //   1 shared memory, 2 the global scratch
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
constexpr int kAbsorbWarps = kAbsorbThreads / 32;
// rows a thread keeps in registers (form 0), each of at most kHeadDims
// dims
constexpr int kAbsorbRegRows = 4;
constexpr int kGatherThreads = 256;
// the least bytes one CTA of the gather writes (its stores in flight), and
// the waves of resident CTAs the grid aims at
constexpr i64 kGatherCtaBytes = 16 * 1024;
constexpr i64 kGatherWaves = 4;

// The rows a thread owns: chunk = ceil(E / threads of the lane).
__host__ __device__ __forceinline__ i64 absorb_chunk(i64 E) {
    return (E + kAbsorbThreads - 1) / kAbsorbThreads;
}

// Words of one lane's rows in forms 1 and 2: each thread's `chunk` rows of
// D slack words and the row's k, thread t's word w of row r at
// ((r * (D + 1) + w) * kAbsorbThreads + t), so a warp's threads read
// neighbouring words.
__host__ __device__ __forceinline__ i64 absorb_row_words(i64 E, i64 D) {
    return absorb_chunk(E) * (D + 1) * kAbsorbThreads;
}

// The stride of a staged R row: at least kHeadDims words, so form 0
// reads every one of its kHeadDims dims in bounds (those past D masked).
__host__ __device__ __forceinline__ i64 absorb_stage_stride(i64 D) {
    return D > kHeadDims ? D : kHeadDims;
}

// Dynamic shared words: the three staged R rows with their reciprocals
// and fp64 copies, the pre-screen's aggregate [D] and pool flags [P], and
// in form 1 the rows.
__host__ __device__ __forceinline__ i64 absorb_smem_words(i64 E, i64 D,
                                                          i64 P, i64 form) {
    return 9 * absorb_stage_stride(D) + D + P
        + (form == 1 ? absorb_row_words(E, D) : 0);
}

// The shared words of the scan: each warp's k total of the group, and of
// the group before each warp's take sum, by group parity (one barrier a
// group orders a buffer's reuse after its readers); the end's per-warp
// partials.
struct AbsorbShared {
    u64 wk[2][kAbsorbWarps];
    u64 wt[2][kAbsorbWarps];
    u64 fin[kAbsorbWarps];
};

// The nr <= 4 bytes at p, loaded now and read later (row_word): the one
// or two aligned 4-byte words that hold them, each by a pinned load, so
// the load is in flight over the arithmetic between (no load when nr is
// 0). The words lie inside the row's allocation, whose base is aligned.
struct RowBytes {
    unsigned w0, w1;
    int sh, nr;
};
__device__ __forceinline__ RowBytes row_load(const u8* p, int nr) {
    RowBytes r = {0u, 0u, (int)((size_t)p & 3), nr};
    if (nr == 0) return r;
    const unsigned* w = reinterpret_cast<const unsigned*>(p - r.sh);
    r.w0 = ld_pin_u32(w);
    if (r.sh + nr > 4) r.w1 = ld_pin_u32(w + 1);
    return r;
}
// byte r at bits 8r, the bytes past nr zero
__device__ __forceinline__ unsigned row_word(const RowBytes& r) {
    const unsigned v = __funnelshift_r(r.w0, r.w1, 8 * r.sh);
    return r.nr >= 4 ? v : v & ((1u << (8 * r.nr)) - 1u);
}

// Quotients without 64-bit division. Integers of magnitude below 2^51
// move between int64 and fp64 through the bias 2^52 + 2^51 (an integer
// add and an fp64 add each way, exact there; no conversion instruction).
// A group's R row is staged with rb = 1 / R (rounded) for 0 < R < 2^52,
// rb = 0 otherwise (floordiv_rcp's reciprocal), and rf = R as fp64.
constexpr i64 kLim51 = 1LL << 51;
constexpr i64 kLim52 = 1LL << 52;
constexpr i64 kBias = 0x4338000000000000LL;         // the bits of 2^52+2^51
constexpr double kBiasF = 6755399441055744.0;
constexpr double kBigF = 1152921504606846976.0;     // BIG = 2^60, exact

__device__ __forceinline__ double to_fp(i64 a) {
    return __longlong_as_double(kBias + a) - kBiasF;
}
__device__ __forceinline__ i64 to_int(double x) {
    return __double_as_longlong(x + kBiasF) - kBias;
}

// k of each of a thread's NR rows (form 0: D <= kHeadDims words a row in
// registers; rows past nr are the lane's padding; bit r of `on`: row r is
// the lane's, compatible and alive) over the staged R row: min over the
// dims with R > 0 of floor(s / R) (BIG when none), clipped to [0, BIG], 0
// where `on` is clear. NR is the lane's chunk (at most kAbsorbRegRows).
// FP: the rows are fp64 (exact integers in (-2^51, 2^51); the bits in
// s): every row's quotient of a dim at once, without a branch (dims with
// R <= 0 masked), and with one row every dim's (the staged rows hold
// kHeadDims words; dims past D masked): the nearest integer of s * rb
// (within one of s / R; rb = 0 past 2^52 gives 0), the remainder
// fma(-q, rf, s) (exact) and one correction each way, all in fp64. Else
// the int64 rows by floordiv_rcp, dims outer.
template <bool FP, int NR>
__device__ __forceinline__ void absorb_k_rows(
        const i64 (&s)[kAbsorbRegRows][kHeadDims],
        i64 (&k)[kAbsorbRegRows], unsigned on, const i64* R,
        const double* rb, const double* rf, i64 D) {
    if constexpr (FP) {
        double mf[kAbsorbRegRows];
#pragma unroll
        for (int r = 0; r < kAbsorbRegRows; ++r) mf[r] = kBigF;
#pragma unroll
        for (int d = 0; d < kHeadDims; ++d) {
            if constexpr (NR > 1) {    // the rows' quotients overlap
                if (d >= D) break;
            }
            const bool use = d < D && R[d] > 0;
            const double rbd = rb[d], rfd = rf[d];
#pragma unroll
            for (int r = 0; r < NR; ++r) {
                const double x = __longlong_as_double(s[r][d]);
                double q = __fma_rn(x, rbd, kBiasF) - kBiasF;
                const double e = __fma_rn(-q, rfd, x);
                q += e >= rfd ? 1.0 : 0.0;
                q -= e < 0.0 ? 1.0 : 0.0;
                mf[r] = use && q < mf[r] ? q : mf[r];
            }
        }
#pragma unroll
        for (int r = 0; r < kAbsorbRegRows; ++r) {
            const i64 m = mf[r] >= kBigF ? KARP_BIG
                        : mf[r] <= 0.0 ? 0 : to_int(mf[r]);
            k[r] = (on >> r) & 1u ? m : 0;
        }
    } else {
#pragma unroll
        for (int r = 0; r < kAbsorbRegRows; ++r) k[r] = KARP_BIG;
#pragma unroll
        for (int d = 0; d < kHeadDims; ++d) {
            if (d >= D) break;
            const i64 Rd = R[d];
            if (Rd <= 0) continue;
#pragma unroll
            for (int r = 0; r < NR; ++r) {
                const i64 q = floordiv_rcp(s[r][d], Rd, rb[d]);
                k[r] = q < k[r] ? q : k[r];
            }
        }
#pragma unroll
        for (int r = 0; r < kAbsorbRegRows; ++r) {
            const i64 m = r < NR && k[r] > 0 ? k[r] : 0;
            k[r] = (on >> r) & 1u ? m : 0;
        }
    }
}

// absorb_k_rows at the lane's chunk of rows a thread (1 to 4: the same
// for every thread of the lane).
template <bool FP>
__device__ __forceinline__ void absorb_k_chunk(
        const i64 (&s)[kAbsorbRegRows][kHeadDims],
        i64 (&k)[kAbsorbRegRows], i64 chunk, unsigned on, const i64* R,
        const double* rb, const double* rf, i64 D) {
    switch (chunk) {
        case 1: absorb_k_rows<FP, 1>(s, k, on, R, rb, rf, D); break;
        case 2: absorb_k_rows<FP, 2>(s, k, on, R, rb, rf, D); break;
        case 3: absorb_k_rows<FP, 3>(s, k, on, R, rb, rf, D); break;
        default: absorb_k_rows<FP, 4>(s, k, on, R, rb, rf, D); break;
    }
}

// The same k of a row of forms 1 and 2 (any D; word d at p[d * stride])
// by floordiv_rcp.
__device__ __forceinline__ i64 absorb_head_mem(const i64* p, i64 stride,
                                               const i64* R,
                                               const double* rb, i64 D) {
    i64 m = KARP_BIG;
    for (i64 d = 0; d < D; ++d) {
        if (R[d] <= 0) continue;
        const i64 q = floordiv_rcp(p[d * stride], R[d], rb[d]);
        m = q < m ? q : m;
    }
    return m < 0 ? 0 : m;
}

// DENSE: per-lane tables; PRESCREEN: the one-new-node tail; PREEMPT: the
// group rows shared, a per-lane refund at load and the summed leftover
// out (K8). Otherwise the shared tables through gid/cid/alive.
// REG: a thread's rows (at most kAbsorbRegRows) in registers; else in
// shared memory or the global scratch (a.form). Each thread owns a
// contiguous chunk of the lane's rows in name order for the whole scan;
// only it reads or writes their slack and k, so the rows need no barrier.
// Per group: k of each owned row once (kept for the takes), a warp scan,
// one barrier, the prefix from the earlier warps' totals, the takes. The
// take sums ride the next group's barrier (K7: leftover[g - 1]) or are
// summed by each thread over the whole scan (K8: sum n - sum taken,
// wrapping).
// At most 128 registers, so two CTAs share an SM (round (c)'s 256 lanes
// in one wave).
template <bool DENSE, bool PRESCREEN, bool PREEMPT, bool REG>
__global__ void __launch_bounds__(kAbsorbThreads, 2)
consol_absorb_kernel(const __grid_constant__ AbsorbArgs a) {
    constexpr bool ALIVE = !DENSE && !PREEMPT;
    constexpr int NT = kAbsorbThreads, RR = kAbsorbRegRows;
    extern __shared__ i64 dyn[];   // Rs, Rb, Rf [3][DS], agg [D], pok [P],
                                   //   rows (form 1)
    __shared__ AbsorbShared sh;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const i64 b = blockIdx.x;
    const i64 E = a.E, D = a.D, G = a.G;
    const i64 DS = absorb_stage_stride(D);
    i64* Rs = dyn;
    double* Rb = reinterpret_cast<double*>(dyn + 3 * DS);
    double* Rf = reinterpret_cast<double*>(dyn + 6 * DS);
    i64* agg = dyn + 9 * DS;
    i64* pok = agg + D;
    const i64 chunk = absorb_chunk(E);
    const i64 lo = tid * chunk < E ? tid * chunk : E;
    const i64 hi = lo + chunk < E ? lo + chunk : E;
    const int nr = (int)(hi - lo);
    const i64* alloc = DENSE ? a.ex_alloc + b * E * D : a.ex_alloc;
    const i64* used0 = DENSE ? a.ex_used0 + b * E * D : a.ex_used0;
    // the row offsets of group g's R row and compat row, and its n
    auto r_off = [&](i64 g) -> i64 {
        return DENSE ? (b * G + g) * D
             : PREEMPT ? g * D : (i64)a.gid[b * G + g] * D;
    };
    auto c_off = [&](i64 g) -> i64 {
        return DENSE ? (b * G + g) * E
             : PREEMPT ? g * E : (i64)a.cid[b * G + g] * E;
    };
    auto n_of = [&](i64 g) -> i64 {
        return PREEMPT ? a.n[g] : a.n[b * G + g];
    };
    // the slack alloc - used of node row e, dim d, at the scan's start
    // (K8: used = max(used0 - freed[b], 0))
    auto slack0 = [&](i64 e, i64 d) -> i64 {
        const i64 i = e * D + d;
        i64 u = used0[i];
        if constexpr (PREEMPT) {
            u = wsub(u, a.freed[b * E * D + i]);
            u = u < 0 ? 0 : u;
        }
        return wsub(alloc[i], u);
    };

    // the thread's rows: REG in s / k, else word w of row r at rows[...].
    // REG keeps them as fp64 (fp: the bits in s) while every slack lies in
    // (-2^51, 2^51), where the takes keep them (take * R <= slack), until a
    // take meets a negative R; else as int64.
    i64 s[RR][kHeadDims], k[RR];
    unsigned live = 0;                 // REG: bit r, row r is the lane's
    bool fp = REG;
    i64* rows = nullptr;
    if constexpr (REG) {
#pragma unroll
        for (int r = 0; r < RR; ++r) {
            k[r] = 0;
#pragma unroll
            for (int d = 0; d < kHeadDims; ++d) {
                s[r][d] = r < nr && d < D ? slack0(lo + r, d) : 0;
                fp &= s[r][d] > -kLim51 && s[r][d] < kLim51;
            }
        }
        if (fp) {
#pragma unroll
            for (int r = 0; r < RR; ++r)
#pragma unroll
                for (int d = 0; d < kHeadDims; ++d)
                    s[r][d] = __double_as_longlong(to_fp(s[r][d]));
        }
        live = (1u << nr) - 1u;
        if constexpr (ALIVE)
            live &= nz4(row_word(row_load(a.alive + b * E + lo, nr)));
    } else {
        rows = (a.form == 1 ? pok + a.P
                            : a.scratch + b * absorb_row_words(E, D)) + tid;
        for (int r = 0; r < nr; ++r)
            for (i64 d = 0; d < D; ++d)
                rows[(r * (D + 1) + d) * NT] = slack0(lo + r, d);
    }

    // group 0's R row staged; group g + 1's staged at the start of group
    // g, in buffer (g + 1) % 3; its n and the thread's compat bytes loaded
    // a group ahead, its R row two
    auto stage = [&](int buf, i64 r) {
        Rs[buf * DS + tid] = r;
        Rb[buf * DS + tid] = r > 0 && r < kLim52 ? __drcp_rn((double)r)
                                                 : 0.0;
        Rf[buf * DS + tid] = (double)r;
    };
    i64 rnext = 0;
    if (G > 0 && tid < D) {
        stage(0, a.R[r_off(0) + tid]);
        if (G > 1) rnext = a.R[r_off(1) + tid];
    }
    i64 ng = G > 0 ? n_of(0) : 0, nprev = 0;
    RowBytes cw = {0u, 0u, 0, 0};
    if (REG && G > 0) cw = row_load(a.compat + c_off(0) + lo, nr);
    __syncthreads();                   // group 0's R row is staged
    u64 tprev = 0, ttot = 0, nsum = 0;

    int cur = 0;                       // group g's buffer, g % 3
    for (i64 g = 0; g < G; ++g) {
        const int par = (int)(g & 1), nxt = cur == 2 ? 0 : cur + 1;
        const i64* Rg = Rs + cur * DS;
        const double* rb = Rb + cur * DS;
        const double* rf = Rf + cur * DS;
        // the next group's n, compat bytes and (staging threads) the R row
        // after it, in flight over this group's arithmetic
        const bool more = g + 1 < G;
        i64 nn = 0, rn2 = 0;
        RowBytes cwn = {0u, 0u, 0, 0};
        if (more) {
            nn = ld_pin_i64(PREEMPT ? a.n + g + 1 : a.n + b * G + g + 1);
            if constexpr (REG) cwn = row_load(a.compat + c_off(g + 1) + lo,
                                              nr);
            if (tid < D && g + 2 < G)
                rn2 = ld_pin_i64(a.R + r_off(g + 2) + tid);
            // the next group's R row into buffer (g + 1) % 3: its readers
            // start after this group's barrier, its last ones (group g -
            // 2) were done before the barrier of g - 1
            if (tid < D) stage(nxt, rnext);
        }
        // k of each owned row, once
        u64 local = 0;
        if constexpr (REG) {
            const unsigned on = nz4(row_word(cw)) & live;
            if (fp) absorb_k_chunk<true>(s, k, chunk, on, Rg, rb, rf, D);
            else absorb_k_chunk<false>(s, k, chunk, on, Rg, rb, rf, D);
#pragma unroll
            for (int r = 0; r < RR; ++r) local += (u64)k[r];
        } else {
            const u8* crow = a.compat + c_off(g);
            for (int r = 0; r < nr; ++r) {
                const i64 e = lo + r;
                i64* row = rows + r * (D + 1) * NT;
                const i64 m = crow[e] && (!ALIVE || a.alive[b * E + e])
                    ? absorb_head_mem(row, NT, Rg, rb, D) : 0;
                row[D * NT] = m;
                local += (u64)m;
            }
        }
        // the warp's inclusive prefix; K7: the warp's take sum of g - 1
        const u64 incl = warp_scan_u64(local);
        const u64 wtk = PREEMPT ? 0 : warp_sum_u64(tprev);
        if (lane == 31) {
            sh.wk[par][warp] = incl;
            if constexpr (!PREEMPT) sh.wt[par][warp] = wtk;
        }
        __syncthreads();
        // the prefix before this thread: the earlier warps', then its own
        u64 cum = incl - local;
        for (int i = 0; i < warp; ++i) cum += sh.wk[par][i];
        if (!PREEMPT && g > 0 && tid == NT - 32) {
            u64 t = 0;
#pragma unroll
            for (int i = 0; i < kAbsorbWarps; ++i) t += sh.wt[par][i];
            a.leftover[b * G + g - 1] = wsub(nprev, (i64)t);
        }
        // the takes: clip(n - cum, 0, k) in name order
        u64 tsum = 0;
        if constexpr (REG) {
#pragma unroll
            for (int r = 0; r < RR; ++r) {
                i64 x = wsub(ng, (i64)cum);
                x = x < 0 ? 0 : x;
                const i64 take = x < k[r] ? x : k[r];
                cum += (u64)k[r];
                if (take) {
                    bool neg = false;
#pragma unroll
                    for (int d = 0; d < kHeadDims; ++d)
                        neg |= d < D && Rg[d] < 0;
                    if (fp && neg) {       // the rows to int64, for good
                        fp = false;
#pragma unroll
                        for (int q = 0; q < RR; ++q)
#pragma unroll
                            for (int d = 0; d < kHeadDims; ++d)
                                s[q][d] = to_int(__longlong_as_double(
                                    s[q][d]));
                    }
                    if (fp) {              // take < 2^51 where some R > 0
                        const double tf = take < kLim51 ? to_fp(take) : 0.0;
#pragma unroll
                        for (int d = 0; d < kHeadDims; ++d)
                            if (d < D && Rg[d] > 0)
                                s[r][d] = __double_as_longlong(__fma_rn(
                                    -tf, rf[d],
                                    __longlong_as_double(s[r][d])));
                    } else {
#pragma unroll
                        for (int d = 0; d < kHeadDims; ++d)
                            if (d < D)
                                s[r][d] = wsub(s[r][d], wmul(take, Rg[d]));
                    }
                }
                tsum += (u64)take;
            }
        } else {
            for (int r = 0; r < nr; ++r) {
                i64* row = rows + r * (D + 1) * NT;
                const i64 kr = row[D * NT];
                i64 x = wsub(ng, (i64)cum);
                x = x < 0 ? 0 : x;
                const i64 take = x < kr ? x : kr;
                cum += (u64)kr;
                if (take)
                    for (i64 d = 0; d < D; ++d)
                        row[d * NT] = wsub(row[d * NT], wmul(take, Rg[d]));
                tsum += (u64)take;
            }
        }
        if constexpr (PREEMPT) {
            ttot += tsum;
            nsum += (u64)ng;
        } else {
            tprev = tsum;
        }
        nprev = ng;
        ng = nn;
        cw = cwn;
        rnext = rn2;
        cur = nxt;
    }

    // the end's partials: K8 each warp's takes over the scan, K7 each
    // warp's takes of the last group
    {
        const u64 v = warp_sum_u64(PREEMPT ? ttot : tprev);
        if (lane == 31) sh.fin[warp] = v;
    }
    __syncthreads();
    u64 fin = 0;
    if (tid == NT - 32) {
#pragma unroll
        for (int i = 0; i < kAbsorbWarps; ++i) fin += sh.fin[i];
    }
    if constexpr (PREEMPT) {
        if (tid == NT - 32) a.total[b] = wsub((i64)nsum, (i64)fin);
        return;
    }
    if (G > 0 && tid == NT - 32) a.leftover[b * G + G - 1] = wsub(nprev,
                                                                  (i64)fin);
    __syncthreads();                   // the leftover row is visible
    const i64* left = a.leftover + b * G;

    if constexpr (!PRESCREEN) {        // every group's leftover is 0
        int ok = 1;
        for (i64 g = tid; g < G; g += NT) ok &= left[g] == 0;
        ok = __syncthreads_and(ok);
        if (tid == 0) a.out[b] = ok;
        return;
    }
    // ---- the one-new-node relaxation (consolidation_jax.py:126-136) ----
    const i64 T = a.T, P = a.P, Sc = a.Sc;
    const int* cids = a.cid + b * G;
    const int* gids = a.gid + b * G;
    for (i64 d = tid; d < D; d += NT) agg[d] = 0;
    for (i64 p = tid; p < P; p += NT) pok[p] = 1;
    int act = 0;
    for (i64 g = tid; g < G; g += NT) act |= left[g] > 0;
    const int any_active = __syncthreads_or(act);
    // agg over every group (inactive rows add leftover * R too), and the
    // pools that admit every active group, a thread a group
    for (i64 g = tid; g < G; g += NT) {
        const i64 lg = left[g];
        if (lg == 0) continue;
        for (i64 d = 0; d < D; ++d) {
            const i64 v = wmul(lg, a.R[(i64)gids[g] * D + d]);
            if (v) atomicAdd(reinterpret_cast<u64*>(agg + d), (u64)v);
        }
        if (lg > 0)
            for (i64 p = 0; p < P; ++p)
                if (!a.padmit[p * Sc + cids[g]]) pok[p] = 0;
    }
    __syncthreads();
    const i64 cap = a.price_cap[b];
    int found = 0;
    for (i64 t = tid; t < T; t += NT) {
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

// One launch of a lane's B CTAs; B = 0 launches nothing. A form the
// shapes do not take is refused.
template <bool DENSE, bool PRESCREEN, bool PREEMPT>
int launch_absorb(const AbsorbArgs* a, void* stream) {
    const bool reg = a->form == 0;
    if (a->form < 0 || a->form > 2 || a->D > kAbsorbThreads
        || (reg && (a->D > kHeadDims
                    || absorb_chunk(a->E) > kAbsorbRegRows)))
        return (int)cudaErrorInvalidValue;
    if (a->B <= 0) return 0;
    const size_t smem =
        (size_t)absorb_smem_words(a->E, a->D, a->P, a->form) * sizeof(i64);
    auto fn = reg ? consol_absorb_kernel<DENSE, PRESCREEN, PREEMPT, true>
                  : consol_absorb_kernel<DENSE, PRESCREEN, PREEMPT, false>;
    const int err = set_smem((const void*)fn, smem);
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
