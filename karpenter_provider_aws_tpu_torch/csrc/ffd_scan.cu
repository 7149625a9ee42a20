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
// The step bodies live in ffd_step.cuh, shared with the fused block
// kernels (fused.cu).
//
// A later PR would: compute the quotient in fp64 and correct it with one
//   int64 multiply-compare (exact, and off the emulated divide); and fuse
//   the scan into one persistent launch per solve (a cluster or a grid
//   barrier between the phases) instead of 2*G launches.
#include <cuda_runtime.h>

#include "ffd_step.cuh"

namespace {

constexpr int kHeadroomThreads = 256;
constexpr int kCommitThreads = 1024;

__global__ void __launch_bounds__(kHeadroomThreads)
ffd_slot_headroom_kernel(FfdArgs args, i64 g) {
    extern __shared__ i64 dyn[];   // h1 [K*V], sel [K]
    __shared__ i64 red[33];
    const unsigned lane = grid_lane();
    if (lane >= args.L) return;   // the (y, z) grid's spare lanes
    slot_headroom_block(lane_view(args, lane), g, blockIdx.x, red, dyn);
}

__global__ void __launch_bounds__(kCommitThreads)
ffd_group_commit_kernel(FfdArgs args, i64 g) {
    extern __shared__ i64 dyn[];   // take_by_pool [P], h1 [K*V], sel [K]
    const FfdArgs a = lane_view(args, blockIdx.x);
    __shared__ i64 tmp[33];
    __shared__ i64 sc[8];          // broadcast scalars of the new-node phase
    const i64 N = a.N;
    const i64 chunk = (N + blockDim.x - 1) / blockDim.x;
    const i64 lo = threadIdx.x * chunk, hi = lo + chunk < N ? lo + chunk : N;
    i64* tbp = dyn;
    i64* h1 = dyn + a.P;
    i64* sel = h1 + a.K * a.V;

    i64 n_rem = commit_fill(a, g, lo, hi, tmp);          // steps 4-5
    commit_narrow(a, g, 1, tbp);                         // step 6
    n_rem = commit_new_nodes(a, g, n_rem, tmp, sc, h1, sel);   // step 7
    commit_outputs(a, g, n_rem);
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
