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
// solves of one shape in each launch, the lane on grid y and z of both
// kernels (lane_grid; y alone holds 65,535 blocks). Every CTA reads its
// lane's arguments from the __grid_constant__ parameter once, into one
// shared copy (no thread copies the argument struct). A consolidation
// subset round (consolidation.cu) runs its B lanes this way, 2*G
// launches whatever B is. Each lane has its own new-node table
// (ScanArgs.capn, FfdArgs.candn / hrn [P, T]): a subset lane's F carries
// its own `keep` mask.
//
// Both kernels branch once per launch on the minValues floors, uniformly:
//
// ffd_slot_headroom, K == 0: the slot rows on warps (ffd_step.cuh
//   slot_headroom_warps), CTAs of 256 threads, in the layout k2_layout
//   picks from L * N: with few rows (one lane) up to 8 warps a row split
//   its types, with many (a round of 2,048 lanes) each warp takes up to
//   16 rows. A row whose pool does not take the group (existing nodes,
//   free slots) skips the type loop: its first warp zeroes the candidate
//   row by 16-byte stores over the row's aligned middle (T = 812 rows
//   start at every 4-byte offset mod 16) and, on an existing row, takes
//   its allocatable's headroom across its lanes, loaded with the row's
//   first loads. An admitted open row's warps stride over the types (the
//   candidate test, an any-reduction over zone x capacity-type
//   offerings, and the headroom min_d floor((A - used) / R)); with
//   several warps a row their maxima meet in k by 64-bit atomicMax. The
//   same launch's further P * table_blocks(T) CTAs a lane write the
//   group's new-node table (ffd_step.cuh new_node_table_block, the code
//   K5's and K6's table blocks run): candn / hrn [P, T] and the partial
//   caps capn [P, table_blocks(T)]; they read no carry.
// ffd_slot_headroom, K > 0: one CTA a slot row (slot_headroom_block):
//   the block max over the types, then the per-(key, value) segment max
//   in shared memory and the f-th-largest select; no table (the commit's
//   minValues caps need the pool's h1, which it computes).
//
// ffd_group_commit, K == 0: a thread-block cluster of CS CTAs of NT
//   threads a lane, composed from the pieces the fused commit runs with
//   Fu = 1 (ffd_cluster.cuh, ffd_step.cuh), CTA r owning the slot chunk
//   [r*ceil(N/CS), ...): the pool-limit caps of the limited pools the
//   group admits and the greedy fill by warp-shuffle scans (fill_groups,
//   the CTAs' totals exchanged over distributed shared memory); each
//   CTA's slot pass of the narrowing (narrow_slots: used, zones, capacity
//   types, per-pool takes, its takers compacted); then, after a cluster
//   barrier, the takers' (slot, type) cells dealt round-robin to the
//   CTAs (narrow_cells); then the new nodes from the table: CTA 0 stages
//   the inputs, takes the pool budgets at once and its thread 0 walks the
//   pools (new_node_scalars), and the opened rows are written by the
//   whole cluster (commit_tail, spread). The filled and opened slots sit
//   in one or two CTAs' chunks (new nodes open at E + num_nodes onward),
//   so both passes run on every CTA instead of those. It writes takes[g -
//   G0, :] as int32 and leftover[g - G0] (G0 is the first group of the
//   scanned window: 0 for a full scan, the resume group of a suffix
//   re-solve, ops/ffd_cuda.py).
// ffd_group_commit, K > 0: one CTA a lane (CS = 1) runs the block
//   commit with the minValues caps: the block-wide scans of the fill
//   (commit_fill), the narrowing slot by slot (commit_narrow) and the
//   new-node phase pool by pool with its T-pass (commit_new_nodes, on
//   row 0 of the table's buffers).
//
// Both kernels also do the work of a step that would otherwise take a
// launch of its own beside them on the same stream (one lane only; the
// entries refuse more):
// - K3's bank store at a chunk entry (ffd_jax.py:795, the carry entering
//   every CK-th group): ffd_slot_headroom given a bank row j copies the
//   carry into it with all its CTAs (BankCopy, ffd_common.cuh: 16-byte
//   words where the carry and the row share their address mod 16, bytes
//   elsewhere), each thread's first unit loaded before its CTA's work. It
//   reads the carry and writes none of it, so the copy is commit g - 1's
//   carry: the chunk entry's.
// - K9's membership record of a plain group (topo_jax.py:685-702):
//   ffd_group_commit given a RecordArgs adds each slot's take, as the
//   int32 it writes to `takes`, into the hostname counter row where it
//   writes it (new_node_take at K == 0, commit_outputs at K > 0), and the
//   zone sums by shared then global 64-bit atomics (TakeRecord,
//   ffd_step.cuh).
// - K7d's summary row of a consolidation subset lane
//   (consolidation_jax.py:253-262): the round's last ffd_group_commit
//   given a SummaryArgs (any lane count, K == 0) writes each lane's [5]
//   row after its final cluster barrier, on the lane's rank-0 CTA
//   (summary_row): the leftover summed over the window's rows as a
//   wrapping sum (exact in any order), the flex count and the cheapest
//   price over t0 = types[E] & keep, the first new slot's row read a
//   16-byte span a thread (the row cut at its own 16-byte boundaries, a
//   full span by one uint4 load; keep's span by one uint4 load where it
//   shares the row's address mod 16, four 4-byte loads where it shares it
//   mod 4, as T = 812 rows do, bytes otherwise), tprice read only for the
//   types that are on, every load of a thread in flight at once, the sums
//   and minima by warp reductions (the least price as two 32-bit
//   reductions of an order-preserving key); the lane's keep row is
//   prefetched into L2 when the launch starts. The barrier makes what the
//   lane's CTAs wrote in this launch visible to it (the last leftover,
//   num_nodes, the opened rows' types; earlier groups' leftovers come
//   from earlier launches): a cluster-scope release and acquire, or, on
//   a cluster of one CTA (the rounds' shapes), a CTA barrier, which took
//   ~0.6 us a CTA off the tail on the H100
//   (hack/k7_summary_variants.py). The launch adds no block; the tail's
//   latency counts once a wave of the round's CTAs (about 8 at 2,048
//   lanes).
//
// The commit's shape follows a fixed rule on the lane count
// (karp_ffd_k2_cluster): the first of (CS, NT) = (8, 512), (4, 512),
// (2, 512), (1, 512) whose L clusters the card holds at once and whose
// shared memory fits, else (1, 256); K > 0 takes only CS = 1. One lane
// gets a cluster of 8 CTAs; a round of thousands of lanes one CTA of 256
// threads each. A refused launch returns its error; nothing retries at
// another size.
//
// What bounds them on this card (PERF.md has the times): at one lane,
// latency: each launch's own cost (~5 us of the commit's) and the
// commit's chain of barriers and of loads each used as soon as it
// arrives (clock stamps of an instrumented build: before the cluster
//   took the narrowing and the opened rows, the CTA holding 32 takers
//   spent 25-30 us on their cells and the one holding 23 opened rows
//   16-19 us on theirs, while the other six waited); on thousands of
// lanes the headroom's bytes, the candidate rows (N x T a lane) it must
// write.
#include <cuda_runtime.h>

#include "ffd_cluster.cuh"

// Outside the unnamed namespace: the exported entry points take it, and a
// type of that namespace would give them internal linkage.
struct ScanArgs {
    FfdArgs f;              // the scan's fields; f.candn / f.hrn the new-
                            // node table [P, T] a lane (K > 0: row 0 is
                            // the commit's scratch)
    i64* capn;              // [P, table_blocks(T)] the table's partial caps
    i64 capn_lane_bytes;    // its lane stride
    i64 cluster;            // CTAs a lane of ffd_group_commit (1, 2, 4, 8)
    i64 threads;            // its threads a CTA (256, 512)
    i64 rows;               // slot rows a warp of ffd_slot_headroom at
                            // K == 0, or
    i64 warps;              // its warps a slot row (0 and 0: the rule,
                            // k2_layout)
};

namespace {

namespace cg = cooperative_groups;

// The headroom's row layout (RowLayout, block_rows, k2_layout) is
// ffd_step.cuh's: mesh.cu's headroom takes it too.

// The headroom's work on one CTA: a slot row (K > 0), a chunk of a pool's
// new-node table, or a CTA of slot rows.
__device__ __forceinline__ void slot_headroom_cta(const ScanArgs& args,
                                                  i64 g, RowLayout lay,
                                                  i64* dyn, i64* red,
                                                  FfdArgs* sa) {
    const unsigned lane = grid_lane();
    if (lane >= args.f.L) return;  // the (y, z) grid's spare lanes
    lane_view_block(args.f, lane, sa);
    __syncthreads();
    const FfdArgs& a = *sa;
    if (a.K > 0) {
        slot_headroom_block(a, g, blockIdx.x, red, dyn);
        return;
    }
    const i64 N = a.N, T = a.T;
    const i64 rb = block_rows(lay), nrb = (N + rb - 1) / rb;
    if (blockIdx.x >= nrb) {       // chunk c of the table of pool pi
        const i64 TB = table_blocks(T), j = blockIdx.x - nrb;
        const i64 pi = j / TB, c = j % TB;
        i64* capn = (i64*)((unsigned char*)args.capn
                           + lane * args.capn_lane_bytes);
        new_node_table_block(a, g, pi, c, a.candn + pi * T, a.hrn + pi * T,
                             capn + j, nullptr, red, nullptr);
        return;
    }
    const i64 lo = blockIdx.x * rb, hi = lo + rb < N ? lo + rb : N;
    slot_headroom_warps(a, g, a.cand, a.k, lo, hi, (int)lay.warps);
}

__global__ void __launch_bounds__(kRowThreads)
ffd_slot_headroom_kernel(const __grid_constant__ ScanArgs args, i64 g,
                         RowLayout lay) {
    extern __shared__ i64 dyn[];   // h1 [K*V], sel [K]
    __shared__ i64 red[33];
    __shared__ FfdArgs sa;         // the lane's view, one copy a CTA
    slot_headroom_cta(args, g, lay, dyn, red, &sa);
}

// The same launch at a chunk entry of the checkpointed or suffix scan
// (one lane): every thread also copies its units of the carry into the
// bank row, the first loaded before the CTA's work and stored after it.
// The launch writes no carry field, so the copy reads the carry that
// commit g - 1 left. (A kernel of its own: the other launches keep no
// copy registers live across their work, nor its parameters.)
__global__ void __launch_bounds__(kRowThreads)
ffd_slot_headroom_bank_kernel(const __grid_constant__ ScanArgs args, i64 g,
                              RowLayout lay,
                              const __grid_constant__ BankCopy bc) {
    extern __shared__ i64 dyn[];
    __shared__ i64 red[33];
    __shared__ FfdArgs sa;
    const i64 u0 = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    const CopyUnit first = bank_copy_load(bc, u0);
    slot_headroom_cta(args, g, lay, dyn, red, &sa);
    bank_copy_store(first);
    bank_copy_rest(bc, u0, (i64)gridDim.x * blockDim.x);
}

// Dynamic shared bytes of the commit on clusters of cs CTAs: the cluster
// commit's layout at K == 0; take_by_pool [P], h1 [K*V] and sel [K] at K
// > 0.
__host__ __device__ __forceinline__ size_t commit_smem_base(const FfdArgs& f,
                                                            i64 cs) {
    return f.K > 0 ? (size_t)(f.P + f.K * f.V + f.K) * sizeof(i64)
                   : cluster_commit_smem(1, f.P, f.D, (f.N + cs - 1) / cs);
}

// Where the membership record's zone sums dz [Z] start: after that layout,
// on an 8-byte boundary.
__host__ __device__ __forceinline__ size_t record_dz_at(const FfdArgs& f,
                                                        i64 cs) {
    return (commit_smem_base(f, cs) + 7) & ~(size_t)7;
}

size_t commit_smem(const FfdArgs& f, i64 cs, bool rec) {
    return rec ? record_dz_at(f, cs) + (size_t)f.Z * sizeof(u64)
               : commit_smem_base(f, cs);
}

// The summary row of lane `lane` (SummaryArgs) after its commit of group
// g, the last of the window, by every thread of one CTA: a is the lane's
// view, part 3 * NT / 32 words of shared memory no other CTA reads any
// more (the warps' leftover sums, flex counts and minimum prices). It
// runs after the commit on each CTA, so its latency counts once a wave
// of the round's CTAs: every load a thread makes is issued before any is
// used (unrolled, predicated), two round trips in all (the t0 and keep
// spans, then the prices of the types that are on).
template <int NT>
__device__ __forceinline__ void summary_row(const FfdArgs& a, i64 g,
                                            const SummaryArgs& sm,
                                            i64 lane, u64* part) {
    constexpr int kWarps = NT / 32;
    const int tid = threadIdx.x, ln = tid & 31, w = tid >> 5;
    const i64 T = a.T;
    // thread 0's scalars, in flight beside the rest
    const i64 nn = tid == 0 ? (i64)a.num_nodes[0] : 0;
    const i64 removed = tid == 0 ? __ldg(sm.removed_price + lane) : 0;
    // the leftover over rows [0, g - G0]: a wrapping sum
    u64 left = 0;
    for (i64 r = tid; r <= g - a.G0; r += NT) left += (u64)a.leftover[r];
    // t0 = types[E] & keep, a 16-byte span of the types row a unit: the
    // head (bytes before its first 16-byte boundary), then full spans,
    // read by one 16-byte load; keep's span by one 16-byte load where it
    // shares the row's address mod 16, four 4-byte loads where it shares
    // it mod 4 (T = 812 rows start at every 4-byte offset), bytes else
    const u8* t0 = a.types + a.E * T;
    const u8* kp = sm.keep + lane * T;
    i64 h = (i64)((16 - ((uintptr_t)t0 & 15)) & 15);
    h = h < T ? h : T;
    const unsigned kal = (unsigned)(((uintptr_t)kp + h) & 15);
    unsigned cnt = 0;
    i64 mp = 0x7fffffffffffffffLL;
    for (i64 u = tid; u < T / 16 + 2; u += NT) {
        const i64 lo = u == 0 ? 0 : h + 16 * (u - 1);
        const i64 hi = u == 0 ? h : (lo + 16 < T ? lo + 16 : T);
        if (lo >= hi) continue;
        unsigned on = 0;           // bit i: type lo + i is on
        if (hi - lo == 16) {
            const uint4 x = *reinterpret_cast<const uint4*>(t0 + lo);
            uint4 y;
            if (kal == 0) {
                y = __ldg(reinterpret_cast<const uint4*>(kp + lo));
            } else if ((kal & 3) == 0) {
                const unsigned* k4 =
                    reinterpret_cast<const unsigned*>(kp + lo);
                y = make_uint4(__ldg(k4), __ldg(k4 + 1), __ldg(k4 + 2),
                               __ldg(k4 + 3));
            } else {
                unsigned kw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int b = 0; b < 16; ++b)
                    kw[b >> 2] |= (unsigned)__ldg(kp + lo + b)
                        << (8 * (b & 3));
                y = make_uint4(kw[0], kw[1], kw[2], kw[3]);
            }
            on = (nz4(x.x) & nz4(y.x)) | ((nz4(x.y) & nz4(y.y)) << 4)
                | ((nz4(x.z) & nz4(y.z)) << 8)
                | ((nz4(x.w) & nz4(y.w)) << 12);
        } else {
#pragma unroll
            for (int b = 0; b < 16; ++b)
                if (lo + b < hi)
                    on |= (unsigned)((t0[lo + b] != 0)
                                     & (__ldg(kp + lo + b) != 0)) << b;
        }
        cnt += __popc(on);
        i64 pr[16];
#pragma unroll
        for (int b = 0; b < 16; ++b)
            pr[b] = (on >> b) & 1u ? __ldg(sm.tprice + lo + b)
                                   : 0x7fffffffffffffffLL;
#pragma unroll
        for (int b = 0; b < 16; ++b) mp = pr[b] < mp ? pr[b] : mp;
    }
    cnt = __reduce_add_sync(~0u, cnt);
    {   // the least price as an order-preserving unsigned key, high word
        // first, by two 32-bit reductions
        const u64 key = (u64)mp ^ (1ull << 63);
        const unsigned kh = (unsigned)(key >> 32);
        const unsigned mh = __reduce_min_sync(~0u, kh);
        const unsigned ml = __reduce_min_sync(~0u, kh == mh ? (unsigned)key
                                                             : ~0u);
        mp = (i64)((((u64)mh << 32) | ml) ^ (1ull << 63));
    }
    if (g > a.G0)           // more than one leftover row
        for (int off = 16; off > 0; off >>= 1)
            left += __shfl_xor_sync(~0u, left, off);
    if (ln == 0) {
        part[w] = left;
        part[kWarps + w] = cnt;
        part[2 * kWarps + w] = (u64)mp;
    }
    __syncthreads();
    if (tid != 0) return;
    u64 flex = 0;
    for (int i = 0; i < kWarps; ++i) {
        if (i) left += part[i];
        flex += part[kWarps + i];
        const i64 o = (i64)part[2 * kWarps + i];
        mp = o < mp ? o : mp;
    }
    // a type that is off counts BIG, as the reference's where(t0, ., BIG)
    if (flex < (u64)T && KARP_BIG < mp) mp = KARP_BIG;
    const bool minted = nn > 0;
    const i64 min_price = minted ? mp : 0;
    i64* o = sm.out + lane * 5;
    o[0] = (i64)left;
    o[1] = nn;
    o[2] = minted ? (i64)flex : 0;
    o[3] = min_price;
    o[4] = wsub(removed, nn == 1 ? min_price : 0);
}

// With a membership record (kRec: a plain group of the topology scan, one
// lane) the thread that writes a slot's take records it (TakeRecord,
// ffd_step.cuh); with a summary (kSum: a subset round's last group, K ==
// 0) the lane's rank-0 CTA writes its summary row (summary_row) after the
// final cluster barrier. Without them (every other launch) their code is
// compiled out.
template <int NT, bool kRec, bool kSum>
__global__ void __launch_bounds__(NT)
ffd_group_commit_kernel(const __grid_constant__ ScanArgs args, i64 g,
                        const __grid_constant__ RecordArgs rec,
                        const __grid_constant__ SummaryArgs sum) {
    extern __shared__ i64 dyn[];
    __shared__ u64 scan[33 * kScanW];
    __shared__ i64 bud[kScanW];
    __shared__ FfdArgs sa;         // the lane's view, one copy a CTA
    const unsigned lane = grid_lane();
    // The (y, z) grid's spare lanes. A cluster spans grid x only, so all
    // its CTAs share one lane and leave together: no cluster.sync() below
    // is reached by part of a cluster.
    if (lane >= args.f.L) return;
    const int tid = threadIdx.x;
    if constexpr (kSum) {   // the lane's keep row into L2, 128 B a thread
        if (blockIdx.x == 0 && tid * 128 < args.f.T)
            asm volatile("prefetch.global.L2 [%0];" :: "l"(
                sum.keep + (i64)lane * args.f.T + 128 * tid));
    }
    TakeRecord tr;
    const TakeRecord* rp = nullptr;
    if constexpr (kRec) {
        tr = TakeRecord{rec.cz, rec.ch, rec.zfix, (i64)rec.member_z[g],
                        (i64)rec.member_h[g], args.f.Z, args.f.N,
                        reinterpret_cast<u64*>(
                            reinterpret_cast<unsigned char*>(dyn)
                            + record_dz_at(args.f, gridDim.x))};
        for (i64 z = tid; z < args.f.Z; z += NT) tr.dz[z] = 0;
        rp = &tr;
    }
    lane_view_block(args.f, lane, &sa);
    __syncthreads();
    const FfdArgs& a = sa;
    const i64 N = a.N, P = a.P;
    if (a.K > 0) {                 // one CTA a lane (karp_ffd_group_commit)
        const i64 chunk = (N + NT - 1) / NT;
        const i64 lo = tid * chunk < N ? tid * chunk : N;
        const i64 hi = lo + chunk < N ? lo + chunk : N;
        i64* tbp = dyn;
        i64* h1 = dyn + P;
        i64* sel = h1 + a.K * a.V;
        i64* tmp = (i64*)scan;     // 33 entries
        i64 n_rem = commit_fill(a, g, lo, hi, tmp);                // 4-5
        commit_narrow(a, g, 1, tbp);                               // 6
        n_rem = commit_new_nodes(a, g, n_rem, tmp, bud, h1, sel);  // 7
        commit_outputs(a, g, n_rem, rp);
        return;
    }
    cg::cluster_group cl = cg::this_cluster();
    const i64 CS = cl.num_blocks(), rank = cl.block_rank();
    // the CTA's slots [c0, c1), and the thread's chunk of them [lo, hi)
    const i64 cchunk = (N + CS - 1) / CS;
    const i64 c0 = rank * cchunk < N ? rank * cchunk : N;
    const i64 c1 = c0 + cchunk < N ? c0 + cchunk : N;
    const i64 tchunk = (c1 - c0 + NT - 1) / NT;
    const i64 lo = c0 + tid * tchunk < c1 ? c0 + tid * tchunk : c1;
    const i64 hi = lo + tchunk < c1 ? lo + tchunk : c1;
    CommitSmem m = commit_smem_at(dyn, 1, P, a.D, cchunk);
    const i64* capn = (const i64*)((const unsigned char*)args.capn
                                   + lane * args.capn_lane_bytes);
    __shared__ int pre[9];         // the CTAs' taker counts, as a prefix
    for (i64 w = tid; w < P + 1; w += NT) m.tbp[w] = 0;   // tbp, tks
    if (tid == 0) m.ntk[0] = 0;
    cap_components(a, g, 1, m.comp, m.ncomp);
    __syncthreads();
    fill_groups<kScanW, 1>(a, g, 0, 1, lo, hi, m.comp, m.ncomp[0], scan,
                           bud, m.xch, m.tks);
    narrow_slots(a, g, 0, 1, c0, c1, m.tk, m.tkm, m.ntk, m.tbp);
    // the takers' cells dealt over the cluster (into tkm's words: one
    // group, no masks)
    int* mine = reinterpret_cast<int*>(m.tkm);
    const int nmine = deal_takers(m.tk, m.ntk, mine, pre, NT);
    const i64 T = a.T;
    narrow_cells(a, nmine, [&](int jj) { return (i64)mine[jj]; },
                 [&](int, i64 s, i64 t) {
                     return __ldg(&a.cand[s * T + t]) != 0;
                 }, m.tu);
    commit_tail(a, g, 0, 1, 1, c0, c1, capn, m.tbp, m.xch, m.stage, m.sc,
                true, nullptr, rp);
    if (kSum && CS == 1)    // one CTA: its own writes, visible at CTA scope
        __syncthreads();
    else
        cl.sync();   // no CTA leaves while another may read its shared memory
    if constexpr (kSum) {   // its partial sums in the CTA's scan words
        static_assert(3 * NT / 32 <= 33 * kScanW, "scan holds the parts");
        if (rank == 0) summary_row<NT>(a, g, sum, lane, scan);
    }
}

int set_smem(const void* fn, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

const void* commit_fn(i64 threads, bool rec = false, bool sum = false) {
    if (rec)
        return threads == 512
            ? (const void*)ffd_group_commit_kernel<512, true, false>
            : (const void*)ffd_group_commit_kernel<256, true, false>;
    if (sum)
        return threads == 512
            ? (const void*)ffd_group_commit_kernel<512, false, true>
            : (const void*)ffd_group_commit_kernel<256, false, true>;
    return threads == 512
        ? (const void*)ffd_group_commit_kernel<512, false, false>
        : (const void*)ffd_group_commit_kernel<256, false, false>;
}

// The commit's launch on clusters of cs CTAs of `threads`; `attr` holds
// the cluster dimension the configuration points at.
cudaLaunchConfig_t commit_config(const ScanArgs* a, i64 cs, i64 threads,
                                 bool rec, cudaLaunchAttribute* attr,
                                 cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cs);   // the lane on y and z
    lane_grid(a->f.L, &cfg.gridDim);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = commit_smem(a->f, cs, rec);
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

// With `bank` non-null and j >= 0 (one lane only) the launch also copies
// the carry into bank row j of `bank` (BankCopy, ffd_common.cuh).
int karp_ffd_slot_headroom(const ScanArgs* a, long long g,
                           const BankArgs* bank, long long j, void* stream) {
    const FfdArgs& f = a->f;
    BankCopy bc = {};
    if (bank && j >= 0) {
        if (f.L != 1) return (int)cudaErrorInvalidValue;
        bank_copy_plan(*bank, j, &bc, true);
    }
    const size_t smem = f.K > 0 ? (size_t)(f.K * f.V + f.K) * sizeof(i64)
                                : 0;
    const bool copy = bc.end[7] > 0;
    const void* fn = copy ? (const void*)ffd_slot_headroom_bank_kernel
                          : (const void*)ffd_slot_headroom_kernel;
    int err = set_smem(fn, smem);
    if (err) return err;
    RowLayout lay = k2_layout(f.L, f.N);
    if (a->rows > 0 || a->warps > 0)
        lay = RowLayout{a->rows > 0 ? a->rows : 1,
                        a->warps > 0 ? a->warps : 1};
    if (lay.rows > 1 && lay.warps > 1) return (int)cudaErrorInvalidValue;
    const i64 rb = block_rows(lay);
    dim3 grid((unsigned)(f.K > 0 ? f.N
                         : (f.N + rb - 1) / rb + f.P * table_blocks(f.T)));
    lane_grid(f.L, &grid);
    if (copy)
        ffd_slot_headroom_bank_kernel<<<grid, kRowThreads, smem,
                                        (cudaStream_t)stream>>>(*a, (i64)g,
                                                                lay, bc);
    else
        ffd_slot_headroom_kernel<<<grid, kRowThreads, smem,
                                   (cudaStream_t)stream>>>(*a, (i64)g, lay);
    return (int)cudaGetLastError();
}

// With `rec` non-null (one lane only) the commit also records the group's
// membership (RecordArgs, ffd_common.cuh); with `sum` non-null (K == 0, no
// record; g the window's last group) it also writes each lane's summary
// row (SummaryArgs, ffd_common.cuh).
int karp_ffd_group_commit(const ScanArgs* a, long long g,
                          const RecordArgs* rec, const SummaryArgs* sum,
                          void* stream) {
    const i64 cs = a->cluster, nt = a->threads;
    if ((cs != 1 && cs != 2 && cs != 4 && cs != 8) || (nt != 256 && nt != 512)
        || (a->f.K > 0 && cs != 1) || (rec && a->f.L != 1)
        || (sum && (a->f.K > 0 || rec)))
        return (int)cudaErrorInvalidValue;
    RecordArgs r = rec ? *rec : RecordArgs{};
    SummaryArgs sm = sum ? *sum : SummaryArgs{};
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = commit_config(a, cs, nt, rec != nullptr,
                                                 attr, (cudaStream_t)stream);
    const void* fn = commit_fn(nt, rec != nullptr, sum != nullptr);
    int err = set_smem(fn, cfg.dynamicSmemBytes);
    if (err) return err;
    i64 gg = (i64)g;
    void* params[] = {const_cast<ScanArgs*>(a), &gg, &r, &sm};
    err = (int)cudaLaunchKernelExC(&cfg, fn, params);
    if (err) return err;
    return (int)cudaGetLastError();
}

// The commit's shape for the lanes of `a`, as cs + 16 * (threads == 512):
// the first of (8, 512), (4, 512), (2, 512), (1, 512) whose L clusters
// the card holds at once and whose shared memory fits a CTA; (1, 256)
// when none does. K > 0 takes CS = 1 only. Negative: a CUDA error,
// negated.
int karp_ffd_k2_cluster(const ScanArgs* a) {
    const int shapes[4][2] = {{8, 512}, {4, 512}, {2, 512}, {1, 512}};
    int dev = 0, optin = 0, nsm = 0;
    int err = (int)cudaGetDevice(&dev);
    if (!err)
        err = (int)cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (!err)
        err = (int)cudaDeviceGetAttribute(
            &nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err) return -err;
    for (const auto& sh : shapes) {
        if (a->f.K > 0 && sh[0] != 1) continue;
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t cfg = commit_config(a, sh[0], sh[1], false,
                                                     attr, 0);
        if (cfg.dynamicSmemBytes > (size_t)optin) continue;
        err = set_smem(commit_fn(sh[1]), cfg.dynamicSmemBytes);
        if (err) return -err;
        int n = 0;
        if (sh[0] == 1) {
            err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, commit_fn(sh[1]), sh[1], cfg.dynamicSmemBytes);
            n *= nsm;
        } else {
            err = (int)cudaOccupancyMaxActiveClusters(
                &n, commit_fn(sh[1]), &cfg);
        }
        if (err) return -err;
        if (n >= a->f.L) return sh[0] + 16 * (sh[1] == 512);
    }
    return 1;
}

}  // extern "C"
