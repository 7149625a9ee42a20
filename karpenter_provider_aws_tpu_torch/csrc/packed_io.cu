// K1, the packed arena in and out of the FFD scan.
//
// Replaces karpenter_provider_aws_tpu/ops/ffd_jax.py:_words_to_bits (the
// bool section of the input arena) and _bits_to_words / _i32_to_words
// inside _pack_solve_outputs (the int32-pair takes and the bit-packed
// types/zones/ct/alive of the output buffer). The i64 section of the
// output is a plain cat of views in the wrapper (ops/ffd_cuda.py).
//
// unpack_bits: one thread per bool of the plane. The word is read as an
//   unsigned 64-bit value and shifted unsigned: a signed right shift
//   would smear bit 63, the sign bit, into the result.
// pack_outputs: one thread per output word. A takes word holds two int32
//   lanes, the lower index in the low half; a bool word holds 64 bools,
//   little-endian, read across the four carry segments in order.
// The lane axis (solve_scan_packed1_many, the pruned scan's _many): L
//   arenas of one statics bucket in one launch. The lane rides grid y
//   and z (lane_grid, a 32-bit index as in the scan kernels); lane l
//   reads its words l * w_stride words past the first lane's and writes
//   its bools l * nbits past; pack_outputs reads each lane's takes and
//   segments at their own strides and writes its output row at
//   l * out_stride words. With L == 1 both kernels compute exactly what
//   a lane-free launch computes.
// What bounds them on this card: bytes in principle, but at the 50k-pod,
//   812-type shape the input plane is ~13 k bits and the output ~208 k
//   bits plus G*N takes, nanoseconds of memory traffic, so a launch
//   costs its latency (PERF.md has the times). A later PR would fold
//   both into the scan's persistent launch.
#include <cuda_runtime.h>

#include "ffd_common.cuh"

namespace {

constexpr int kThreads = 256;

struct BoolSegments {
    const u8* ptr[4];
    i64 len[4];
    i64 lane_stride[4];   // bytes between lanes of each segment
};

__global__ void unpack_bits_kernel(const i64* words, i64 nbits, u8* out,
                                   i64 L, i64 w_stride) {
    const unsigned lane = grid_lane();
    if (lane >= L) return;   // the (y, z) grid's spare lanes
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nbits) return;
    const u64 w = (u64)words[lane * w_stride + (i >> 6)];
    out[lane * nbits + i] = (u8)((w >> (i & 63)) & 1ull);
}

__global__ void pack_outputs_kernel(const int* takes, i64 n32, i64 w32,
                                    BoolSegments segs, i64 nbits, i64 nwb,
                                    i64* out, i64 L, i64 takes_stride,
                                    i64 out_stride) {
    const unsigned lane = grid_lane();
    if (lane >= L) return;
    const i64 w = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= w32 + nwb) return;
    takes += lane * takes_stride;
    out += lane * out_stride;
    for (int j = 0; j < 4; ++j) segs.ptr[j] += lane * segs.lane_stride[j];
    if (w < w32) {
        const u64 lo = (u64)(unsigned int)takes[2 * w];
        const u64 hi = 2 * w + 1 < n32
            ? (u64)(unsigned int)takes[2 * w + 1] : 0ull;
        out[w] = (i64)(lo | (hi << 32));
        return;
    }
    const i64 b0 = (w - w32) * 64;
    u64 word = 0;
    int seg = 0;
    i64 base = 0;
    for (int b = 0; b < 64; ++b) {
        const i64 i = b0 + b;
        if (i >= nbits) break;
        while (seg < 3 && i - base >= segs.len[seg]) {
            base += segs.len[seg];
            ++seg;
        }
        if (segs.ptr[seg][i - base]) word |= 1ull << b;
    }
    out[w] = (i64)word;
}

unsigned blocks_for(i64 n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* karp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// L lanes: lane l's words start l * w_stride words past `words`, its
// bools l * nbits past `out`.
int karp_unpack_bits(const long long* words, long long nbits,
                     unsigned char* out, long long L, long long w_stride,
                     void* stream) {
    if (nbits > 0 && L > 0) {
        dim3 grid(blocks_for(nbits));
        lane_grid(L, &grid);
        unpack_bits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            words, nbits, out, L, w_stride);
    }
    return (int)cudaGetLastError();
}

// L lanes: lane l's takes start l * takes_stride ints past `takes`, its
// segment j l * seg_stride[j] bytes past seg_ptr[j], its output row
// l * out_stride words past `out`.
int karp_pack_outputs(const int* takes, long long n32,
                      const unsigned char* const* seg_ptr,
                      const long long* seg_len, long long* out, long long L,
                      long long takes_stride, const long long* seg_stride,
                      long long out_stride, void* stream) {
    BoolSegments segs;
    i64 nbits = 0;
    for (int j = 0; j < 4; ++j) {
        segs.ptr[j] = seg_ptr[j];
        segs.len[j] = seg_len[j];
        segs.lane_stride[j] = seg_stride[j];
        nbits += seg_len[j];
    }
    const i64 w32 = (n32 + 1) / 2, nwb = (nbits + 63) / 64;
    if (w32 + nwb > 0 && L > 0) {
        dim3 grid(blocks_for(w32 + nwb));
        lane_grid(L, &grid);
        pack_outputs_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            takes, n32, w32, segs, nbits, nwb, out, L, takes_stride,
            out_stride);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
