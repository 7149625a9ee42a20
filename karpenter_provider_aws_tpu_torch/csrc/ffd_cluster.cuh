// The commit of one or more groups on a thread-block cluster of CTAs a
// lane, shared by the fused block commit (fused.cu, Fu groups a block),
// the base group commit (ffd_scan.cu, one group) and the sharded scan's
// commit (mesh.cu, one group on a rank's slot window): the cluster's
// exchange of scan totals over distributed shared memory, the narrowing
// of a CTA's slot chunk, the dealing of the takers over the cluster, the
// new-node tail from the table, and the layout of the commit's dynamic
// shared memory.
//
// CTA r of a cluster of CS owns the slot chunk [r*ceil(N/CS), ...): its
// slots' fills and narrowing and the opened rows that fall there.
// Cross-CTA prefixes and totals go through distributed shared memory:
// each CTA publishes its partials, then cluster.sync(), then reads the
// others' with map_shared_rank. pool_used, num_nodes and the new-node
// scalars are CTA 0's, read by the others after a cluster.sync().
//
// Two forms of the narrowing's cells and the opened rows. The base and
// mesh commits (one group a launch, ffd_scan.cu and mesh.cu) deal the
// cluster's takers round-robin to its CTAs after one more cluster
// barrier and writes the opened rows with the whole cluster (commit_tail
// `spread`): its fills land in one or two CTAs' chunks, and at config 2
// on one lane dealing took it from 40.4 to 27.6 us on the H100. The
// fused commit keeps each CTA's own takers and rows (narrow_groups, no
// `spread`): the dealt form costs it a cluster barrier a narrowing and,
// between a sequential block's groups, another for the rows other CTAs
// wrote, and at the striped cluster's shapes (a few takers a group) it
// read 114.9-115.2 us against 104.4-104.6 a sequential block, 51.4
// against 50.3-50.5 a vectorized one, and 16.72-16.79 against 15.11 ms
// of device time a packed solve (H100 80GB HBM3, 700 W; PERF.md).
#pragma once

#include <cooperative_groups.h>

#include "ffd_step.cuh"

// Words a CTA publishes at once: the scans' kScanW totals, or the per-
// (group, pool) takes and the per-group take totals.
__host__ __device__ __forceinline__ i64 cluster_xw(i64 Fu, i64 P) {
    return Fu * P + Fu > kScanW ? Fu * P + Fu : kScanW;
}

// Dynamic shared bytes of a cluster commit of Fu groups whose CTAs own
// `chunk` slots each: the new-node scalars of Fu groups and their staged
// inputs, the takes by (group, pool) and the take totals, two publish
// buffers and the offsets and totals read back, the narrowing's staged
// used rows, then ints: the CTA's takers and their groups' masks, the
// pool-cap components and their counts, the takers' counts.
__host__ __device__ __forceinline__ size_t cluster_commit_smem(i64 Fu, i64 P,
                                                               i64 D,
                                                               i64 chunk) {
    return (size_t)(Fu * nn_words(P) + nn_stage_words(P, D, Fu) + Fu * P
                    + Fu + 4 * cluster_xw(Fu, P) + kNarrowRows * D)
        * sizeof(i64) + (size_t)(2 * chunk + Fu * P + 2 * Fu) * sizeof(int);
}

// The cluster's exchange: each CTA publishes n words, then cluster.sync(),
// then every CTA reads every rank's words: off[w] the sum over the ranks
// before it, tot[w] over all. Two publish buffers alternate, so one
// cluster.sync() per exchange orders a buffer's reuse after its readers.
struct ClusterExchange {
    i64* buf[2];
    i64* off;
    i64* tot;
    int u;

    __device__ void run(int n) {
        namespace cg = cooperative_groups;
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        const unsigned r = cl.block_rank(), cs = cl.num_blocks();
        for (int w = threadIdx.x; w < n; w += blockDim.x) {
            u64 o = 0, t = 0;
            for (unsigned q = 0; q < cs; ++q) {
                const u64 v = (u64)cl.map_shared_rank(buf[u], q)[w];
                t += v;
                if (q < r) o += v;
            }
            off[w] = (i64)o;
            tot[w] = (i64)t;
        }
        __syncthreads();
        u ^= 1;
    }

    // fill_groups' hook: the CTA's scan totals in, the earlier CTAs'
    // totals added to each thread's prefixes
    template <int W>
    __device__ void add_before(u64 (&v)[W], const u64* totals, int n) {
        for (int w = threadIdx.x; w < n; w += blockDim.x)
            buf[u][w] = (i64)totals[w];
        run(n);
#pragma unroll
        for (int j = 0; j < W; ++j)
            if (j < n) v[j] += (u64)off[j];
    }
};

// The commit's dynamic shared memory (cluster_commit_smem), carved.
struct CommitSmem {
    i64* sc;                      // [Fu, nn_words(P)] new-node scalars
    NewNodeStage stage;           // their staged inputs
    unsigned long long* tbp;      // [Fu, P] takes by (group, pool)
    unsigned long long* tks;      // [Fu] take totals
    ClusterExchange xch;
    i64* tu;                      // [kNarrowRows, D] staged used rows
    int* tk;                      // [chunk] the CTA's takers
    unsigned* tkm;                // [chunk] their filling groups' masks
    int* comp;                    // [Fu, P] pool-cap components
    int* ncomp;                   // [Fu] their counts
    int* ntk;                     // [Fu] the takers' counts
};

__device__ __forceinline__ CommitSmem commit_smem_at(i64* dyn, i64 Fu, i64 P,
                                                     i64 D, i64 chunk) {
    CommitSmem m;
    m.sc = dyn;
    m.stage = nn_stage_at(m.sc + Fu * nn_words(P), P, D, Fu);
    m.tbp = (unsigned long long*)(m.sc + Fu * nn_words(P)
                                  + nn_stage_words(P, D, Fu));
    m.tks = m.tbp + Fu * P;
    i64* x = (i64*)(m.tks + Fu);
    const i64 xw = cluster_xw(Fu, P);
    m.xch = ClusterExchange{{x, x + xw}, x + 2 * xw, x + 3 * xw, 0};
    m.tu = x + 4 * xw;
    m.tk = (int*)(m.tu + kNarrowRows * D);
    m.tkm = (unsigned*)(m.tk + chunk);
    m.comp = (int*)(m.tkm + chunk);
    m.ncomp = m.comp + Fu * P;
    m.ntk = m.ncomp + Fu;
    return m;
}

// Step 6's slot pass for the groups i0 .. i0+nf-1 (k rows: takes) on the
// CTA's slots [c0, c1): used += the takes times R; each open slot that
// some group filled is compacted into tk (and the mask of its filling
// groups into tkm), its zones and capacity types ANDed with the filling
// groups', its take added to tbp [Fu, P]. `ntk` is a shared counter at
// 0. Ends at a barrier.
__device__ __forceinline__ void narrow_slots(const FfdArgs& a, i64 g0,
                                             i64 i0, i64 nf, i64 c0, i64 c1,
                                             int* tk, unsigned* tkm,
                                             int* ntk,
                                             unsigned long long* tbp) {
    const i64 N = a.N, D = a.D, Z = a.Z, C = a.C, P = a.P;
    const int tid = threadIdx.x, nthr = blockDim.x;
    for (i64 s = c0 + tid; s < c1; s += nthr) {
        bool nonzero = false;                // a zero take changes nothing
        for (i64 f = i0; f < i0 + nf; ++f) nonzero |= a.k[f * N + s] != 0;
        if (!nonzero) continue;
        for (i64 d = 0; d < D; ++d) {
            i64 u = a.used[s * D + d];
            for (i64 f = i0; f < i0 + nf; ++f)
                u = wadd(u, wmul(a.k[f * N + s], a.R[(g0 + f) * D + d]));
            a.used[s * D + d] = u;
        }
        const int pool = a.pool[s];
        if (pool < 0) continue;
        const i64 pc = pool > P - 1 ? P - 1 : pool;
        unsigned mask = 0;
        for (i64 f = i0; f < i0 + nf; ++f) {
            const i64 take = a.k[f * N + s];
            if (take <= 0) continue;
            mask |= 1u << (f - i0);
            const i64 g = g0 + f;
            for (i64 z = 0; z < Z; ++z) a.zones[s * Z + z] &= a.agz[g * Z + z];
            for (i64 c = 0; c < C; ++c) a.ct[s * C + c] &= a.agc[g * C + c];
            atomicAdd(&tbp[f * P + pc], (unsigned long long)take);
        }
        if (mask) {
            const int j = atomicAdd(ntk, 1);
            tk[j] = (int)s;
            tkm[j] = mask;
        }
    }
    __syncthreads();
}

// Step 6 of the groups i0 .. i0+nf-1 on the CTA's slots [c0, c1): the
// slot pass (narrow_slots), then one flat pass over the takers' (slot,
// type) cells narrows types to (the filling groups' candidates) & fit.
// `tu` holds the pass's staged used rows.
__device__ __forceinline__ void narrow_groups(const FfdArgs& a, i64 g0,
                                              i64 i0, i64 nf, i64 c0, i64 c1,
                                              int* tk, unsigned* tkm,
                                              int* ntk, i64* tu,
                                              unsigned long long* tbp) {
    const i64 N = a.N, T = a.T;
    narrow_slots(a, g0, i0, nf, c0, c1, tk, tkm, ntk, tbp);
    narrow_cells(a, *ntk, [&](int j) { return (i64)tk[j]; },
                 [&](int j, i64 s, i64 t) {
                     bool c = false;
                     for (unsigned m = tkm[j]; m; m &= m - 1) {
                         const i64 f = i0 + __ffs((int)m) - 1;
                         c |= __ldg(&a.cand[(f * N + s) * T + t]) != 0;
                     }
                     return c;
                 }, tu);
}

// The takers' cells over the whole cluster (the base and mesh commits:
// their filled slots sit in a few CTAs' chunks, and the header says why
// the fused commit does not deal them): after a cluster barrier (every
// CTA's narrow_slots done: its takers `tk`, their count `ntk` and their
// used rows), CTA r takes the cluster's takers r, r + CS, ... in CTA
// order from their CTAs' lists into its own `mine`, and returns their
// number. `pre` holds CS + 1 shared ints; `nthr` is the CTA's threads.
// Ends at a barrier. The owners' lists must stay readable until every CTA
// has passed a later cluster barrier (commit_tail's).
__device__ __forceinline__ int deal_takers(int* tk, int* ntk, int* mine,
                                           int* pre, int nthr) {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    const i64 CS = cl.num_blocks(), rank = cl.block_rank();
    const int tid = threadIdx.x;
    cl.sync();
    if (tid == 0) {
        int acc = 0;
        for (int q = 0; q < (int)CS; ++q) {
            pre[q] = acc;
            acc += *cl.map_shared_rank(ntk, (unsigned)q);
        }
        pre[CS] = acc;
    }
    __syncthreads();
    const int nmine = pre[CS] > rank
        ? (int)((pre[CS] - rank + CS - 1) / CS) : 0;
    for (int jj = tid; jj < nmine; jj += nthr) {
        const int j = (int)(rank + CS * jj);
        int q = 0;
        while (j >= pre[q + 1]) ++q;
        mine[jj] = cl.map_shared_rank(tk, (unsigned)q)[j - pre[q]];
    }
    __syncthreads();
    return nmine;
}

// After the fills and the narrowing of groups i0 .. i0+nf-1 (of Fu whose
// tables are candn/hrn [Fu*P, T] and partial caps capn [Fu, P,
// table_blocks(T)]): the cluster's takes by (group, pool) and take
// totals; on CTA 0, the staged new-node inputs (pool_used plus the takes
// times R), its thread 0's new-node scalars (into sc, num_nodes and
// leftover) and the pool_used write-back; then every CTA's opened rows
// and takes rows on [c0, c1). With `spread` (the last step of a launch:
// no CTA reads another's carry rows afterwards) the opened rows are
// written by the whole cluster, its threads striding over all N slots.
// With a slot window `w` (a slot-sharded mesh, nf == 1; spread) the
// launch's N rows are the global slots [w->lo, w->lo + N) of w->N, the
// first w->E existing: the caps, the take by pool and the take total
// are the window's (reduced over the shards), not the cluster's, so no
// exchange runs and `capn` and `tbp` are not read; new nodes open at
// global ids and only those inside the window are written. With `rec`
// (the base commit of the topology scan's plain groups, nf == 1) each
// take written is recorded (TakeRecord, ffd_step.cuh).
__device__ __forceinline__ void commit_tail(const FfdArgs& a, i64 g0, i64 i0,
                                            i64 nf, i64 Fu, i64 c0, i64 c1,
                                            const i64* capn,
                                            unsigned long long* tbp,
                                            ClusterExchange& xch,
                                            const NewNodeStage& stage,
                                            i64* sc, bool spread = false,
                                            const SlotWindow* w = nullptr,
                                            const TakeRecord* rec = nullptr) {
    namespace cg = cooperative_groups;
    const i64 N = a.N, P = a.P, D = a.D, T = a.T, W = Fu * P + Fu;
    const int tid = threadIdx.x, nthr = blockDim.x;
    cg::cluster_group cl = cg::this_cluster();
    const unsigned rank = cl.block_rank();
    if (!w) {
        for (i64 i = tid; i < W; i += nthr) xch.buf[xch.u][i] = (i64)tbp[i];
        xch.run((int)W);  // xch.tot: the cluster's tbp [Fu, P], totals [Fu]
    }
    if (rank == 0) {
        if (w)
            nn_stage(a, g0 + i0, nf, nullptr, w->tbp, nullptr, stage, w);
        else
            nn_stage(a, g0 + i0, nf, capn + i0 * P * table_blocks(T),
                     xch.tot + i0 * P, xch.tot + Fu * P + i0, stage);
        __syncthreads();
        new_node_scalars(stage, nf, P, D, w ? w->N : N, w ? w->E : a.E,
                         sc + i0 * nn_words(P),
                         a.leftover + (g0 + i0 - a.G0));
        for (i64 i = tid; i < P * D; i += nthr) a.pool_used[i] = stage.pu[i];
        if (tid == 0) a.num_nodes[0] = (int)stage.nn[0];
    }
    cl.sync();           // CTA 0's scalars, pool_used and num_nodes
    const i64 nw = nf * nn_words(P);
    if (rank != 0) {
        const i64* src = cl.map_shared_rank(sc, 0);
        for (i64 i = i0 * nn_words(P) + tid; i < i0 * nn_words(P) + nw;
             i += nthr)
            sc[i] = src[i];
        __syncthreads();
    }
    const i64 slot0 = w ? w->lo : 0;
    for (i64 f = i0; f < i0 + nf; ++f) {
        const i64* sf = sc + f * nn_words(P);
        const unsigned cs = cl.num_blocks();
        new_node_rows(a, g0 + f, sf, a.candn + f * P * T, a.hrn + f * P * T,
                      nullptr, nullptr, spread ? 0 : c0, spread ? N : c1,
                      spread ? (int)(rank * nthr) + tid : tid,
                      spread ? (int)(cs * nthr) : nthr, slot0);
        for (i64 s = c0 + tid; s < c1; s += nthr)
            new_node_take(a, a.k + f * N, g0 + f, sf, s, slot0, rec);
    }
    record_flush(rec);
}
