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
//   256 threads per (group of the block, slot), grid x = Fu*N, the lane on
//   grid y and z (lane_grid). Every group reads the BLOCK-START carry;
//   the body is ffd_slot_headroom's (ffd_step.cuh slot_headroom_block)
//   with the group's own cand [N, T] and k [N] rows (group_view).
//
// ffd_fused_commit (the block): one block of 1024 threads per lane. It
//   reads the lane's flags from the unpacked fuse bits on the card:
//   blk_indep = fuse[g0+1] & ... & fuse[g0+Fu-1] (the first flag is not
//   read; the pad tail's flags are all True).
//   - vectorized lane: steps 4-5 (pool caps, greedy prefix) of each group
//     against the block-start pool state, the merge (used += the sum of
//     the takes times R; a filled open slot's types = OR of the filling
//     groups' candidates & fit under the merged used, zones and capacity
//     types ANDed with each filling group's; pool_used += the per-pool
//     sums), then step 7 (new nodes) of each group in group order, each
//     from its own remaining count: the reference's vec_block, exactly.
//   - sequential lane: group 0 commits from the headroom the first
//     launch computed (its entry carry is the block-start carry); groups
//     1..Fu-1 recompute steps 1-3 inside the block, one warp per slot
//     (ffd_step.cuh slot_headroom_warps), and commit in turn: the
//     reference's seq_block, Fu plain steps.
//
// What bounds them on this card: like K2 (ffd_scan.cu), latency, not
//   bytes or operations. The headroom launch is one wave of Fu*N blocks
//   (about Fu times the bytes of ffd_slot_headroom); the commit is one
//   block walking its barriers, and on a sequential lane it also walks
//   the Fu-1 recomputed N x T headroom passes on 32 warps, which is where
//   a sequential block costs more than Fu K2 pairs would. The design buys
//   2*G/Fu launches per solve in place of K2's 2*G and keeps both
//   branches on the card with no host read of the flags. PERF.md has the
//   times.
#include <cuda_runtime.h>

#include "ffd_step.cuh"

// Outside the unnamed namespace: the exported entry points take it, and a
// type of that namespace would give them internal linkage.
struct FusedArgs {
    FfdArgs f;              // the scan's fields; f.cand [Fu*N, T], f.k [Fu*N]
    const u8* fuse;         // [G] same_run_as_prev flags
    i64 Fu;                 // groups per block
    i64 fuse_lane_bytes;    // lane stride of fuse
};

namespace {

constexpr int kHeadroomThreads = 256;
constexpr int kCommitThreads = 1024;

__global__ void __launch_bounds__(kHeadroomThreads)
ffd_fused_headroom_kernel(FusedArgs args, i64 g0) {
    __shared__ i64 red[33];
    const unsigned lane = grid_lane();
    if (lane >= args.f.L) return;   // the (y, z) grid's spare lanes
    const FfdArgs a = lane_view(args.f, lane);
    const i64 i = blockIdx.x / a.N, s = blockIdx.x % a.N;
    slot_headroom_block(group_view(a, i), g0 + i, s, red, nullptr);
}

__global__ void __launch_bounds__(kCommitThreads)
ffd_fused_commit_kernel(FusedArgs args, i64 g0) {
    extern __shared__ i64 dyn[];   // take_by_pool [Fu*P], n_rem [Fu]
    __shared__ i64 tmp[33];
    __shared__ i64 sc[8];
    const FfdArgs a = lane_view(args.f, blockIdx.x);
    const u8* fuse = args.fuse + (i64)blockIdx.x * args.fuse_lane_bytes;
    const i64 Fu = args.Fu, N = a.N;
    const i64 chunk = (N + blockDim.x - 1) / blockDim.x;
    const i64 lo = threadIdx.x * chunk, hi = lo + chunk < N ? lo + chunk : N;
    i64* tbp = dyn;
    i64* nrem = dyn + Fu * a.P;
    bool indep = true;
    for (i64 i = 1; i < Fu; ++i) indep &= fuse[g0 + i] != 0;

    if (indep) {
        for (i64 i = 0; i < Fu; ++i) {
            const i64 r = commit_fill(group_view(a, i), g0 + i, lo, hi, tmp);
            if (threadIdx.x == 0) nrem[i] = r;
        }
        commit_narrow(a, g0, Fu, tbp);     // its barriers publish nrem
        for (i64 i = 0; i < Fu; ++i) {
            const FfdArgs ai = group_view(a, i);
            const i64 r = commit_new_nodes(ai, g0 + i, nrem[i], tmp, sc,
                                           nullptr, nullptr);
            commit_outputs(ai, g0 + i, r);
        }
        return;
    }
    for (i64 i = 0; i < Fu; ++i) {
        const FfdArgs ai = group_view(a, i);
        if (i) {
            slot_headroom_warps(ai, g0 + i);
            __syncthreads();
        }
        i64 r = commit_fill(ai, g0 + i, lo, hi, tmp);
        commit_narrow(ai, g0 + i, 1, tbp);
        r = commit_new_nodes(ai, g0 + i, r, tmp, sc, nullptr, nullptr);
        commit_outputs(ai, g0 + i, r);
        __syncthreads();   // the carry is the next group's entry state
    }
}

int set_smem(const void* fn, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

int karp_ffd_fused_headroom(const FusedArgs* a, long long g0, void* stream) {
    dim3 grid((unsigned)(a->Fu * a->f.N));
    lane_grid(a->f.L, &grid);
    ffd_fused_headroom_kernel<<<grid, kHeadroomThreads, 0,
                                (cudaStream_t)stream>>>(*a, g0);
    return (int)cudaGetLastError();
}

int karp_ffd_fused_commit(const FusedArgs* a, long long g0, void* stream) {
    size_t smem = (size_t)(a->Fu * a->f.P + a->Fu) * sizeof(i64);
    int err = set_smem((const void*)ffd_fused_commit_kernel, smem);
    if (err) return err;
    ffd_fused_commit_kernel<<<(unsigned)a->f.L, kCommitThreads, smem,
                              (cudaStream_t)stream>>>(*a, g0);
    return (int)cudaGetLastError();
}

}  // extern "C"
