// K3, the checkpoint bank of the incremental scan: carry -> bank rows.
//
// Replaces the bank half of karpenter_provider_aws_tpu/ops/ffd_jax.py
// solve_scan_packed1_ckpt (_chunked_scan at :795 emits the carry entering
// every CK-th group as a scan output) and solve_scan_suffix (:1296: the
// select of bank row jr, the splice of the suffix's entry carries over
// rows jr.., and the re-stamp of the pad chunks with the final carry).
// The group steps themselves are the K2 kernels (ffd_scan.cu) run over a
// group window; ops/ffd_cuda.py drives both.
//
// The bank is eight device tensors, one per carry field, each with a
// leading row axis of G/CK: used [., N, D] i64, types [., N, T] u8,
// zones [., N, Z] u8, ct [., N, C] u8, pool [., N] i32, alive [., N] u8,
// num_nodes [.] i32, pool_used [., P, D] i64. One row holds one carry
// (BankArgs, ffd_common.cuh).
//
// Neither the entry carry of a chunk nor the suffix's resume row moves
// here: the chunk entry's ffd_slot_headroom launch, which reads that
// carry and writes none of it, copies it into its bank row with every one
// of its threads (BankCopy, ffd_common.cuh; ffd_scan.cu), and the suffix
// re-solve's first launch, unpack_bits_load (packed_io.cu), copies bank
// row jr into the working carry beside the arena's unpack. A checkpointed
// solve therefore launches no kernel of this file, and a suffix re-solve
// one at most:
// ffd_bank_store: the working carry into bank rows [j, j + count), all
//   eight fields in one launch (the suffix's re-stamp of its pad chunks
//   with the final carry, count >= 1).
// Grid: x strides over a field's row bytes, y is the field, z the bank
//   row. A field whose pointers and row size are 8-byte aligned moves in
//   64-bit words, any other (the bool planes of odd widths) bytewise.
// What bounds it on this card: bytes, one carry read and one written
//   per row; at the warm-tick shape a carry is ~12 KB, nanoseconds of
//   HBM time, so a launch costs its latency (PERF.md has the times).
#include <cuda_runtime.h>

#include <cstdint>

#include "ffd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 8;

__global__ void bank_copy_kernel(BankArgs a, i64 j) {
    const int f = blockIdx.y;
    const i64 rb = a.row_bytes[f];
    unsigned char* dst = a.bank[f] + (j + (i64)blockIdx.z) * rb;
    const unsigned char* src = a.carry[f];
    const i64 stride = (i64)gridDim.x * blockDim.x;
    const i64 i0 = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if ((((uintptr_t)src | (uintptr_t)dst | (uintptr_t)rb) & 7) == 0) {
        const u64* s = (const u64*)src;
        u64* d = (u64*)dst;
        for (i64 i = i0; i < rb / 8; i += stride) d[i] = s[i];
    } else {
        for (i64 i = i0; i < rb; i += stride) dst[i] = src[i];
    }
}

}  // namespace

extern "C" {

int karp_ffd_bank_store(const BankArgs* a, long long j, long long count,
                        void* stream) {
    i64 most = 0;
    for (int f = 0; f < kFields; ++f)
        most = a->row_bytes[f] > most ? a->row_bytes[f] : most;
    if (most == 0 || count <= 0) return 0;
    // enough blocks for one 64-bit word a thread on the widest field
    i64 bx = (most / 8 + kThreads - 1) / kThreads;
    bx = bx < 1 ? 1 : (bx > 1024 ? 1024 : bx);
    dim3 grid((unsigned)bx, kFields, (unsigned)count);
    bank_copy_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(*a, j);
    return (int)cudaGetLastError();
}

}  // extern "C"
