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
//   The cluster's exchange, the narrowing and the new-node tail are
//   ffd_cluster.cuh's, which the base group commit (ffd_scan.cu) runs too.
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

#include "ffd_cluster.cuh"

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
    CommitSmem m = commit_smem_at(dyn, Fu, P, a.D, cchunk);
    i64* sc = m.sc;
    const NewNodeStage& stage = m.stage;
    unsigned long long* tbp = m.tbp;                   // [Fu, P], [Fu]
    unsigned long long* tks = m.tks;
    ClusterExchange& xch = m.xch;
    i64* tu = m.tu;
    int* tk = m.tk;
    unsigned* tkm = m.tkm;
    int* comp = m.comp;
    int* ncomp = m.ncomp;
    int* ntk = m.ntk;
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
    return cluster_commit_smem(a->Fu, a->f.P, a->f.D,
                               (a->f.N + cs - 1) / cs);
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
