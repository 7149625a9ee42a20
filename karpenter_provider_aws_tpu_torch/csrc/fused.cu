// K5, the fused block scan, as two kernels launched once per block of Fu
// groups.
//
// Replaces karpenter_provider_aws_tpu/ops/ffd_jax.py:_solve_fused (the
// lax.scan over G/Fu blocks whose lax.cond picks vec_block or seq_block;
// under solve_scan_packed1_many's vmap the cond is a select, so every
// lane of a batch takes its own branch). The carry stays in device memory
// for the whole scan; the host enqueues 2*G/Fu launches on one stream
// with no synchronisation in between and reads nothing back per block.
//
// ffd_fused_headroom (steps 1-3 of the block's Fu groups): one block of
//   256 threads per (group of the block, slot), grid x = Fu*N, the lane
//   on grid y and z (lane_grid). Every group reads the BLOCK-START carry;
//   the body is ffd_slot_headroom's (ffd_step.cuh slot_headroom_block)
//   with the group's own cand [N, T] and k [N] rows (group_view).
//   Fu*P*table_blocks(T) more blocks write the new-node table of each
//   (group, pool), a chunk of 256 types each (ffd_step.cuh
//   new_node_table_block: candn/hrn [Fu, P, T], the partial caps capn),
//   which reads no carry.
//
// ffd_fused_commit (the block): one thread-block cluster of CS CTAs of
//   512 threads per lane (grid x = CS, the lane on grid y and z by
//   lane_grid, so any L launches; by cudaLaunchKernelEx with a cluster
//   dimension; 1,024 threads spilled registers, and each
//   CTA holds one copy of the lane's arguments in shared memory, not one
//   per thread). CTA r owns the slot chunk [r*ceil(N/CS),
//   ...): its slots' recomputed headroom, fills and narrowing and the
//   opened rows that fall there. Cross-CTA prefixes and totals go through
//   distributed shared memory: each CTA publishes its partials, then
//   cluster.sync(), then reads the others' with map_shared_rank. The
//   carry stays in device memory (L2-resident: types is N x T = 208 KB at
//   the striped shapes); a CTA's own rows need only its own barriers,
//   and pool_used, num_nodes and the new-node scalars are CTA 0's, read
//   by the others after a cluster.sync(). It reads the lane's flags from
//   the unpacked fuse bits on the card: blk_indep = fuse[g0+1] & ... &
//   fuse[g0+Fu-1] (the first flag is not read; the pad tail's flags are
//   all True).
//   - vectorized lane: steps 4-5 (pool caps, greedy prefix) of every
//     group at once against the block-start pool state (ffd_step.cuh
//     fill_groups: the (group, limited pool) pairs whose group admits
//     the pool, and every group's fill, eight and four a scan), the merge
//     (used += the sum of the takes times R; a filled open slot's types
//     = OR of the filling groups' candidates & fit under the merged used,
//     one flat pass over the compacted takers' cells; zones and capacity
//     types ANDed with each filling group's; pool_used += the per-pool
//     sums), then step 7 of each group in group order, each from its own
//     remaining count: CTA 0 stages the inputs in shared memory, takes
//     each group's pool budgets at once and its thread 0 walks the pools
//     (new_node_scalars); every CTA writes its opened rows from the
//     table: the reference's vec_block, exactly.
//   - sequential lane: group 0 commits from the headroom the first
//     launch computed (its entry carry is the block-start carry); groups
//     1..Fu-1 recompute steps 1-3 of the CTA's slots, one warp per slot
//     (ffd_step.cuh slot_headroom_warps), and commit in turn: the
//     reference's seq_block, Fu plain steps.
//   The cluster size CS follows a fixed rule on the lane count L
//   (karp_ffd_fused_cluster): the largest of 8, 4, 2, 1 whose L clusters
//   the card holds at once (cudaOccupancyMaxActiveClusters), so 8 while a
//   few lanes leave most SMs idle and fewer as lanes fill the card. A
//   refused launch returns its error; nothing retries at another size.
//
// What bounds them on this card: like K2 (ffd_scan.cu), latency, not
//   bytes or operations. The headroom launch is one wave of Fu*N +
//   Fu*P*table_blocks(T) blocks; the commit walks about five cluster
//   barriers a group, each CTA starting its loads before its stores, and a
//   sequential lane's recomputed N x T headroom passes spread over the
//   cluster's SMs. The design buys 2*G/Fu launches per solve in place of
//   K2's 2*G and keeps both branches on the card with no host read of
//   the flags. PERF.md has the times.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ffd_step.cuh"

namespace cg = cooperative_groups;

// Outside the unnamed namespace: the exported entry points take it, and a
// type of that namespace would give them internal linkage.
struct FusedArgs {
    FfdArgs f;              // the scan's fields; f.cand [Fu*N, T], f.k
                            // [Fu*N], f.candn / f.hrn the tables [Fu*P, T]
    const u8* fuse;         // [G] same_run_as_prev flags
    i64* capn;              // [Fu*P, table_blocks(T)] the partial caps
    i64 Fu;                 // groups per block
    i64 fuse_lane_bytes;    // lane stride of fuse
    i64 capn_lane_bytes;    // lane stride of capn
    i64 cluster;            // CTAs per lane in ffd_fused_commit
};

namespace {

constexpr int kHeadroomThreads = 256;
constexpr int kCommitThreads = 512;
constexpr int kFillW = 4;   // greedy scan components: a block's Fu groups

__global__ void __launch_bounds__(kHeadroomThreads)
ffd_fused_headroom_kernel(FusedArgs args, i64 g0) {
    __shared__ i64 red[33];
    const unsigned lane = grid_lane();
    if (lane >= args.f.L) return;   // the (y, z) grid's spare lanes
    const FfdArgs a = lane_view(args.f, lane);
    const i64 Fu = args.Fu, N = a.N, P = a.P, T = a.T;
    if (blockIdx.x >= Fu * N) {     // chunk c of the table of (i, pi)
        const i64 TB = table_blocks(T), j = blockIdx.x - Fu * N;
        const i64 ip = j / TB, c = j % TB;   // ip = i * P + pi
        i64* capn = (i64*)((unsigned char*)args.capn
                           + lane * args.capn_lane_bytes);
        new_node_table_block(a, g0 + ip / P, ip % P, c, a.candn + ip * T,
                             a.hrn + ip * T, capn + j, nullptr, red,
                             nullptr);
        return;
    }
    const i64 i = blockIdx.x / N, s = blockIdx.x % N;
    slot_headroom_block(group_view(a, i), g0 + i, s, red, nullptr);
}

// Words a CTA publishes at once: the scans' kScanW totals, or the per-
// (group, pool) takes and the per-group take totals.
__host__ __device__ __forceinline__ i64 fused_xw(i64 Fu, i64 P) {
    return Fu * P + Fu > kScanW ? Fu * P + Fu : kScanW;
}

// Dynamic shared bytes of the commit: the new-node scalars of Fu groups
// and their staged inputs, the takes by (group, pool) and the take
// totals, two publish buffers and the offsets and totals read back, the
// narrowing's staged used rows, then ints: the CTA's takers and their
// groups' masks, the pool-cap components and their counts, the takers'
// counts.
__host__ __device__ __forceinline__ size_t fused_commit_smem(i64 Fu, i64 P,
                                                             i64 D,
                                                             i64 chunk) {
    return (size_t)(Fu * nn_words(P) + nn_stage_words(P, D, Fu) + Fu * P
                    + Fu + 4 * fused_xw(Fu, P) + kNarrowRows * D)
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

// Step 6 of the groups i0 .. i0+nf-1 (k rows: takes) on the CTA's slots
// [c0, c1): used += the takes times R; each open slot that some group
// filled is compacted into tk (and the mask of its filling groups into
// tkm), its zones and capacity types ANDed with the filling groups', its
// take added to tbp [Fu, P]; then one flat pass over the takers' (slot,
// type) cells narrows types to (the filling groups' candidates) & fit.
// `ntk` is a shared counter at 0; `tu` the pass's staged used rows.
__device__ __forceinline__ void narrow_groups(const FfdArgs& a, i64 g0,
                                              i64 i0, i64 nf, i64 c0, i64 c1,
                                              int* tk, unsigned* tkm,
                                              int* ntk, i64* tu,
                                              unsigned long long* tbp) {
    const i64 N = a.N, T = a.T, D = a.D, Z = a.Z, C = a.C, P = a.P;
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

// After the fills and the narrowing of groups i0 .. i0+nf-1: the
// cluster's takes by (group, pool) and take totals; on CTA 0, the staged
// new-node inputs (pool_used plus the takes times R), its thread 0's
// new-node scalars (into sc, num_nodes and leftover) and the pool_used
// write-back; then every CTA's opened rows and takes rows on [c0, c1).
__device__ __forceinline__ void commit_tail(const FfdArgs& a, i64 g0, i64 i0,
                                            i64 nf, i64 Fu, i64 c0, i64 c1,
                                            const i64* capn,
                                            unsigned long long* tbp,
                                            ClusterExchange& xch,
                                            const NewNodeStage& stage,
                                            i64* sc) {
    const i64 N = a.N, P = a.P, D = a.D, T = a.T, W = Fu * P + Fu;
    const int tid = threadIdx.x, nthr = blockDim.x;
    cg::cluster_group cl = cg::this_cluster();
    const unsigned rank = cl.block_rank();
    for (i64 w = tid; w < W; w += nthr) xch.buf[xch.u][w] = (i64)tbp[w];
    xch.run((int)W);     // xch.tot: the cluster's tbp [Fu, P], totals [Fu]
    if (rank == 0) {
        nn_stage(a, g0 + i0, nf, capn + i0 * P * table_blocks(T),
                 xch.tot + i0 * P, xch.tot + Fu * P + i0, stage);
        __syncthreads();
        new_node_scalars(stage, nf, P, D, N, a.E, sc + i0 * nn_words(P),
                         a.leftover + (g0 + i0 - a.G0));
        for (i64 i = tid; i < P * D; i += nthr) a.pool_used[i] = stage.pu[i];
        if (tid == 0) a.num_nodes[0] = (int)stage.nn[0];
    }
    cl.sync();           // CTA 0's scalars, pool_used and num_nodes
    const i64 nw = nf * nn_words(P);
    if (rank != 0) {
        const i64* src = cl.map_shared_rank(sc, 0);
        for (i64 w = i0 * nn_words(P) + tid; w < i0 * nn_words(P) + nw;
             w += nthr)
            sc[w] = src[w];
        __syncthreads();
    }
    for (i64 f = i0; f < i0 + nf; ++f) {
        const i64* sf = sc + f * nn_words(P);
        new_node_rows(a, g0 + f, sf, a.candn + f * P * T, a.hrn + f * P * T,
                      nullptr, nullptr, c0, c1, tid, nthr);
        for (i64 s = c0 + tid; s < c1; s += nthr)
            new_node_take(a, a.k + f * N, g0 + f, sf, s);
    }
}

__global__ void __launch_bounds__(kCommitThreads)
ffd_fused_commit_kernel(FusedArgs args, i64 g0) {
    extern __shared__ i64 dyn[];
    __shared__ u64 scan[33 * kScanW];
    __shared__ i64 bud[kScanW];
    __shared__ FfdArgs sa;         // the lane's view, one copy a CTA
    const unsigned lane = grid_lane();
    // The (y, z) grid's spare lanes. A cluster spans grid x only, so all
    // its CTAs share one lane and leave together: no cluster.sync() below
    // is reached by part of a cluster.
    if (lane >= args.f.L) return;
    cg::cluster_group cl = cg::this_cluster();
    const i64 CS = cl.num_blocks(), rank = cl.block_rank();
    if (threadIdx.x == 0) sa = lane_view(args.f, lane);
    __syncthreads();
    const FfdArgs& a = sa;
    const u8* fuse = args.fuse + (i64)lane * args.fuse_lane_bytes;
    const i64* capn = (const i64*)((const unsigned char*)args.capn
                                   + lane * args.capn_lane_bytes);
    const i64 Fu = args.Fu, N = a.N, P = a.P;
    const int tid = threadIdx.x;
    // the CTA's slots [c0, c1), and the thread's chunk of them [lo, hi)
    const i64 cchunk = (N + CS - 1) / CS;
    const i64 c0 = rank * cchunk < N ? rank * cchunk : N;
    const i64 c1 = c0 + cchunk < N ? c0 + cchunk : N;
    const i64 tchunk = (c1 - c0 + kCommitThreads - 1) / kCommitThreads;
    const i64 lo = c0 + tid * tchunk < c1 ? c0 + tid * tchunk : c1;
    const i64 hi = lo + tchunk < c1 ? lo + tchunk : c1;
    i64* sc = dyn;                                     // [Fu, nn_words(P)]
    const NewNodeStage stage = nn_stage_at(sc + Fu * nn_words(P), P, a.D,
                                           Fu);
    unsigned long long* tbp = (unsigned long long*)(
        sc + Fu * nn_words(P) + nn_stage_words(P, a.D, Fu));  // [Fu, P], [Fu]
    unsigned long long* tks = tbp + Fu * P;
    const i64 xw = fused_xw(Fu, P);
    ClusterExchange xch{{(i64*)(tks + Fu), (i64*)(tks + Fu) + xw},
                        (i64*)(tks + Fu) + 2 * xw, (i64*)(tks + Fu) + 3 * xw,
                        0};
    i64* tu = (i64*)(tks + Fu) + 4 * xw;               // [kNarrowRows, D]
    int* tk = (int*)(tu + kNarrowRows * a.D);          // [cchunk]
    unsigned* tkm = (unsigned*)(tk + cchunk);          // [cchunk]
    int* comp = (int*)(tkm + cchunk);                  // [Fu, P] pool caps
    int* ncomp = comp + Fu * P;                        // [Fu]
    int* ntk = ncomp + Fu;                             // [Fu]
    for (i64 w = tid; w < Fu * P + Fu; w += kCommitThreads) tbp[w] = 0;
    for (i64 w = tid; w < Fu; w += kCommitThreads) ntk[w] = 0;
    bool indep = true;
    for (i64 i = 1; i < Fu; ++i) indep &= fuse[g0 + i] != 0;
    if (indep) {
        cap_components(a, g0, Fu, comp, ncomp);
    } else {
        for (i64 i = 0; i < Fu; ++i)
            cap_components(a, g0 + i, 1, comp + i * P, ncomp + i);
    }
    __syncthreads();

    if (indep) {
        fill_groups<kScanW, kFillW>(a, g0, 0, Fu, lo, hi, comp, ncomp[0],
                                    scan, bud, xch, tks);
        narrow_groups(a, g0, 0, Fu, c0, c1, tk, tkm, ntk, tu, tbp);
        __syncthreads();
        commit_tail(a, g0, 0, Fu, Fu, c0, c1, capn, tbp, xch, stage, sc);
    } else {
        for (i64 i = 0; i < Fu; ++i) {
            if (i) {
                slot_headroom_warps(a, g0 + i, a.cand + i * N * a.T,
                                    a.k + i * N, c0, c1);
                __syncthreads();
            }
            fill_groups<kScanW, 1>(a, g0, i, 1, lo, hi, comp + i * P,
                                   ncomp[i], scan, bud, xch, tks);
            narrow_groups(a, g0, i, 1, c0, c1, tk, tkm, ntk + i, tu, tbp);
            __syncthreads();
            commit_tail(a, g0, i, 1, Fu, c0, c1, capn, tbp, xch, stage, sc);
            __syncthreads();   // the CTA's rows are the next group's entry
        }
    }
    cl.sync();   // no CTA leaves while another may read its shared memory
}

int set_smem(const void* fn, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t commit_smem(const FusedArgs* a, i64 cs) {
    return fused_commit_smem(a->Fu, a->f.P, a->f.D, (a->f.N + cs - 1) / cs);
}

}  // namespace

extern "C" {

int karp_ffd_fused_headroom(const FusedArgs* a, long long g0, void* stream) {
    dim3 grid((unsigned)(a->Fu * a->f.N
                         + a->Fu * a->f.P * table_blocks(a->f.T)));
    lane_grid(a->f.L, &grid);
    ffd_fused_headroom_kernel<<<grid, kHeadroomThreads, 0,
                                (cudaStream_t)stream>>>(*a, g0);
    return (int)cudaGetLastError();
}

// The commit's cluster size for L lanes: the largest of 8, 4, 2, 1 whose
// L clusters the card holds at once; 1 when none does. Negative: a CUDA
// error, negated.
int karp_ffd_fused_cluster(const FusedArgs* a) {
    for (int cs = 8; cs > 1; cs >>= 1) {
        const size_t smem = commit_smem(a, cs);
        int err = set_smem((const void*)ffd_fused_commit_kernel, smem);
        if (err) return -err;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((unsigned)cs);
        lane_grid(a->f.L, &cfg.gridDim);
        cfg.blockDim = dim3(kCommitThreads, 1, 1);
        cfg.dynamicSmemBytes = smem;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = (unsigned)cs;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int n = 0;
        err = (int)cudaOccupancyMaxActiveClusters(
            &n, (const void*)ffd_fused_commit_kernel, &cfg);
        if (err) return -err;
        if (n >= a->f.L) return cs;
    }
    return 1;
}

int karp_ffd_fused_commit(const FusedArgs* a, long long g0, void* stream) {
    const i64 cs = a->cluster;
    if (cs < 1 || cs > 8) return (int)cudaErrorInvalidValue;
    const size_t smem = commit_smem(a, cs);
    int err = set_smem((const void*)ffd_fused_commit_kernel, smem);
    if (err) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cs);   // the lane on y and z, as lane_grid
    lane_grid(a->f.L, &cfg.gridDim);
    cfg.blockDim = dim3(kCommitThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = (int)cudaLaunchKernelEx(&cfg, ffd_fused_commit_kernel, *a,
                                  (i64)g0);
    if (err) return err;
    return (int)cudaGetLastError();
}


}  // extern "C"
