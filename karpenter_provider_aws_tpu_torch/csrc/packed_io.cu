// K1, the packed arena in and out of the FFD scan.
//
// Replaces karpenter_provider_aws_tpu/ops/ffd_jax.py:_words_to_bits (the
// bool section of the input arena; on the suffix re-solve together with
// solve_scan_suffix's select of bank row jr, :1329) and
// _pack_solve_outputs with its _bits_to_words / _i32_to_words (the whole
// output buffer: the i64 section, the int32-pair takes and the
// bit-packed types/zones/ct/alive; on the suffix re-solve together with
// solve_scan_suffix's re-stamp of the pad chunks with the final carry,
// :1311-1322).
//
// K3's checkpoint bank (solve_scan_packed1_ckpt, :1280: _chunked_scan at
// :795 emits the carry entering every CK-th group; solve_scan_suffix,
// :1296: the select of bank row jr, the splice of the suffix's entry
// carries over rows jr.., the re-stamp of the pad chunks) is eight device
// tensors, one per carry field, each with a leading row axis of G/CK:
// used [., N, D] i64, types [., N, T] u8, zones [., N, Z] u8, ct [., N, C]
// u8, pool [., N] i32, alive [., N] u8, num_nodes [.] i32, pool_used
// [., P, D] i64. One row holds one carry (BankArgs, ffd_common.cuh). No
// launch of its own moves a row: a chunk entry's ffd_slot_headroom
// (ffd_scan.cu) stores its entry carry, the suffix's unpack_bits_load
// below loads row jr, and the suffix's pack_outputs re-stamps the pad
// rows; each of those launches reads what it copies and writes none of
// it. ops/ffd_cuda.py drives them.
//
// unpack_bits: a thread takes one unit of a lane's bool row. Lane l's
//   row starts l * nbits bytes past `out`, so at any offset mod 16; the
//   row is cut at its own 16-byte boundaries: unit 0 is the head (the
//   bytes before the first boundary), units 1 .. nv the row's 16-byte
//   words, unit nv + 1 the tail (the bytes after them). A word is written
//   by one uint4 store, the head and tail byte by byte, every byte of the
//   row once. The unit's bits [s, s + 16) lie in word s >> 6, and also in
//   the next one when s & 63 > 48: two 8-byte loads (the bool section is
//   8-byte aligned, not 16), the next only where it is one of the lane's
//   nwords(nbits) words (past them lie the next lane's words or the end
//   of the allocation), joined by an unsigned funnel shift (a signed shift
//   would smear bit 63, the sign bit). The 16 bits become 16 bytes in
//   registers, four at a time by one multiply (expand4).
// unpack_bits_load: the suffix re-solve's prologue, one lane, one launch:
//   blocks [0, Bu) unpack as above, blocks [Bu, Bu + Bc) copy bank row j
//   into the working carry (K3's load, ffd_jax.py:1329; BankCopy out of
//   the row, ffd_common.cuh), each block wholly one or the other. The
//   two sets of units touch disjoint memory (arena words -> bool plane,
//   row j -> carry) and nothing in the launch reads what it writes; the
//   next launch on the stream, the first headroom, reads both after it.
// pack_outputs: one launch writes every word of each lane's output row
//   [i64 section | takes | bit words | bail]. Warps [0, ws) take the
//   scalar words, one a thread: the i64 section's fields (leftover, used,
//   pool, num_nodes, pool_used) read through their own pointers, lengths
//   and lane strides, int32 fields widened here; a takes word of two
//   int32 lanes, the lower index in the low half, by one 8-byte load where
//   the pair is aligned (an odd count pads the last high half with 0);
//   the optional bail word (the pruned scan's, a bool a lane). The warps
//   after them take the bit words, kBitWords a warp: lane j reads bools
//   16j .. 16j + 15 of each 512-bool pass as one 16-byte load where the
//   16 lie in one segment at a 16-byte boundary (byte loads otherwise),
//   packs them into 16 bits in registers, and lane 4q gathers its three
//   neighbours' halves into word q by shuffles. A bool's segment is found
//   by comparing its index with the segments' prefix lengths; bits past
//   the last segment are 0.
// pack_outputs with a store range [j, j + count) (the suffix re-solve's
//   last launch, one lane): blocks [0, Bp) pack as above, blocks [Bp, Bp
//   + Bs) copy the final carry into bank rows j .. j + count - 1 (the pad
//   chunks; the store direction of bank_copy_plan), each block wholly
//   one or the other. Row j + r starts (j + r) * row_bytes past the
//   field's row 0, so its cut moves from row to row: every row takes
//   the same units a field (row_units: the bytes before the row's first
//   16-byte boundary, then a unit a 16-byte span, n / 16 + 2 in all, the
//   spare ones empty), and each unit finds its row's head from the row's
//   address. A full span moves by one uint4 load and store where the
//   carry and the row share their address mod 16, byte by byte
//   otherwise, as the head and the tail do. The pack reads the carry and
//   writes the output row, the copy reads the carry and writes bank rows
//   the launch does not read.
// The lane axis (solve_scan_packed1_many, the pruned scan's _many): L
//   arenas of one statics bucket in one launch. The lane rides grid y
//   and z (lane_grid, a 32-bit index as in the scan kernels); lane l
//   reads its words l * w_stride words past the first lane's and writes
//   its bools l * nbits past; pack_outputs reads each lane's fields at
//   their own lane strides and writes its output row at l * out_stride
//   words. With L == 1 both kernels compute exactly what a lane-free
//   launch computes.
// What bounds them on this card: bytes. At the 50k-pod, 812-type shape
//   the input plane is ~13 k bits and the output ~208 k bools read plus
//   ~5.6 k words written, nanoseconds of memory traffic, so one launch
//   costs its latency (hence the suffix's load rides the unpack's launch
//   and its pad re-stamp, a ~12 KB carry a row at the warm tick, the
//   pack's); at B = 64 lanes (8.5 MB unpacked, 34 MB packed) and on
//   config 7's pruned pack (4.2 M takes) the bytes are the bound, which
//   the 16-byte bool stores and loads (512 bytes a warp instruction) and
//   the 8-byte takes loads serve.
#include <cuda_runtime.h>

#include <cstdint>

#include "ffd_common.cuh"

// The output buffer's sources (mirrored by ops/ffd_cuda.py _PackArgs;
// every field 8 bytes wide). Lengths and strides count elements.
struct PackArgs {
    const void* f_ptr[5];   // leftover, used, pool, num_nodes, pool_used
    i64 f_len[5];
    i64 f_stride[5];
    i64 f_i32;              // bit j: field j is int32 (else int64)
    const int* takes;
    i64 n32;
    i64 takes_stride;
    const u8* seg_ptr[4];   // types, zones, ct, alive
    i64 seg_len[4];
    i64 seg_stride[4];
    const u8* bail;         // [L] bools at bail_stride, or null
    i64 bail_stride;
    i64* out;
    i64 out_stride;
    i64 L;
};

namespace {

constexpr int kThreads = 256;
// pack_outputs: bit words a warp (two passes of 32 lanes x 16 bools)
constexpr int kBitWords = 16;
constexpr int kPackWarps = kThreads / 32;

// Bits 0-3 of x as bytes 0-3 of the result, each 0 or 1: the multiply
// puts bit k at bit 8k (the four shifted copies do not overlap).
__device__ __forceinline__ unsigned expand4(unsigned x) {
    return ((x & 15u) * 0x00204081u) & 0x01010101u;
}

// Units a lane's row of nbits bytes is cut into, at most: the head, the
// 16-byte words and the tail.
inline i64 unpack_units(i64 nbits) { return nbits / 16 + 2; }

// Unit u of one lane's row: `words` its nwords(nbits) words, `row` its
// nbits bytes.
__device__ __forceinline__ void unpack_unit(const i64* words, i64 nbits,
                                            u8* row, i64 u) {
    i64 h = (i64)((16 - ((uintptr_t)row & 15)) & 15);
    h = h < nbits ? h : nbits;
    const i64 nv = (nbits - h) >> 4;
    if (u > nv + 1) return;
    const i64 s = u == 0 ? 0 : h + 16 * (u - 1);
    const i64 e = u == 0 ? h : (u <= nv ? s + 16 : nbits);
    if (s >= e) return;
    const i64 q = s >> 6;
    const unsigned sh = (unsigned)(s & 63);
    u64 x = (u64)__ldg(words + q) >> sh;
    if (sh > 48 && q + 1 < (nbits + 63) >> 6)
        x |= (u64)__ldg(words + q + 1) << (64 - sh);
    const unsigned b = (unsigned)x & 0xffffu;
    if (u > 0 && u <= nv) {
        *reinterpret_cast<uint4*>(row + s) = make_uint4(
            expand4(b), expand4(b >> 4), expand4(b >> 8), expand4(b >> 12));
        return;
    }
    for (int k = 0; k < (int)(e - s); ++k)
        row[s + k] = (u8)((b >> k) & 1u);
}

__global__ void __launch_bounds__(kThreads)
unpack_bits_kernel(const i64* words, i64 nbits, u8* out, i64 L,
                   i64 w_stride) {
    const unsigned lane = grid_lane();
    if (lane >= L) return;   // the (y, z) grid's spare lanes
    unpack_unit(words + lane * w_stride, nbits, out + lane * nbits,
                (i64)blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void __launch_bounds__(kThreads)
unpack_bits_load_kernel(const i64* words, i64 nbits, u8* out,
                        const __grid_constant__ BankCopy bc, unsigned bu) {
    if (blockIdx.x < bu) {   // block-uniform: an unpack block
        unpack_unit(words, nbits, out,
                    (i64)blockIdx.x * blockDim.x + threadIdx.x);
        return;
    }
    bank_copy_store(bank_copy_load(
        bc, (i64)(blockIdx.x - bu) * blockDim.x + threadIdx.x));
}

// Segment j's bools of lane `lane` (constant j: a parameter load, no
// copy of the argument block to local memory).
template <int J>
__device__ __forceinline__ const u8* seg_base(const PackArgs& a, i64 lane) {
    return a.seg_ptr[J] + lane * a.seg_stride[J];
}

// The byte of bool x of lane `lane` (x < nbits): its segment by the
// prefix lengths p1 <= p2 <= p3.
__device__ __forceinline__ const u8* bool_at(const PackArgs& a, i64 lane,
                                             i64 x, i64 p1, i64 p2, i64 p3) {
    if (x < p1) return seg_base<0>(a, lane) + x;
    if (x < p2) return seg_base<1>(a, lane) + (x - p1);
    if (x < p3) return seg_base<2>(a, lane) + (x - p2);
    return seg_base<3>(a, lane) + (x - p3);
}

// One scalar word s of lane `lane`'s row: an i64-section field, a takes
// pair or the bail word.
__device__ __forceinline__ void pack_scalar(const PackArgs& a, i64 lane,
                                            i64 s, i64 n64, i64 w32,
                                            i64 nwb, i64* out) {
    if (s < n64) {
        const i64 e0 = a.f_len[0], e1 = e0 + a.f_len[1];
        const i64 e2 = e1 + a.f_len[2], e3 = e2 + a.f_len[3];
        const void* p;
        i64 at;
        int f;
        if (s < e0) {
            p = a.f_ptr[0]; at = lane * a.f_stride[0] + s; f = 0;
        } else if (s < e1) {
            p = a.f_ptr[1]; at = lane * a.f_stride[1] + (s - e0); f = 1;
        } else if (s < e2) {
            p = a.f_ptr[2]; at = lane * a.f_stride[2] + (s - e1); f = 2;
        } else if (s < e3) {
            p = a.f_ptr[3]; at = lane * a.f_stride[3] + (s - e2); f = 3;
        } else {
            p = a.f_ptr[4]; at = lane * a.f_stride[4] + (s - e3); f = 4;
        }
        out[s] = (a.f_i32 >> f) & 1
            ? (i64)__ldg(static_cast<const int*>(p) + at)
            : __ldg(static_cast<const i64*>(p) + at);
        return;
    }
    if (s < n64 + w32) {
        const i64 w = s - n64;
        const int* tk = a.takes + lane * a.takes_stride + 2 * w;
        unsigned lo, hi = 0;
        if (2 * w + 1 < a.n32 && ((size_t)tk & 7) == 0) {
            const int2 v = __ldg(reinterpret_cast<const int2*>(tk));
            lo = (unsigned)v.x;
            hi = (unsigned)v.y;
        } else {
            lo = (unsigned)__ldg(tk);
            if (2 * w + 1 < a.n32) hi = (unsigned)__ldg(tk + 1);
        }
        out[s] = (i64)((u64)lo | ((u64)hi << 32));
        return;
    }
    // the bail word, after the bit words
    out[s + nwb] = __ldg(a.bail + lane * a.bail_stride) != 0;
}

// 16 bools from bool i of lane `lane`'s segments as bits 0-15: one
// 16-byte load where they lie in one segment at a 16-byte boundary,
// byte loads otherwise (bools past nbits are 0).
__device__ __forceinline__ unsigned pack16(const PackArgs& a, i64 lane,
                                           i64 i, i64 nbits, i64 p1,
                                           i64 p2, i64 p3) {
    const i64 end = i < p1 ? p1 : i < p2 ? p2 : i < p3 ? p3 : nbits;
    const u8* p = bool_at(a, lane, i, p1, p2, p3);
    if (i + 16 <= end && ((size_t)p & 15) == 0) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        return nz4(v.x) | (nz4(v.y) << 4) | (nz4(v.z) << 8)
            | (nz4(v.w) << 12);
    }
    unsigned m = 0;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
        const i64 x = i + b;
        if (x >= nbits) break;
        m |= (unsigned)(__ldg(bool_at(a, lane, x, p1, p2, p3)) != 0) << b;
    }
    return m;
}

// The pad re-stamp's rows: bank rows [j, j + count) of a BankArgs, and
// the units of one row, end[f] counting those of fields 0 .. f
// (row_units).
struct RowStore {
    i64 j, count;
    i64 end[8];
};

// Units of one field of n bytes in any row: its head (the bytes before
// the row's first 16-byte boundary, at most 15) and a unit a 16-byte
// span after it; the spans past the row's end are empty.
inline i64 row_units(i64 n) { return n / 16 + 2; }

// Unit u of the re-stamp: row u / end[7], then a field and a unit of it
// (ffd_common.cuh bank_copy_plan's cut, taken at this row's address).
__device__ __forceinline__ void store_unit(const BankArgs& b,
                                           const RowStore& rs, i64 u) {
    const i64 R = rs.end[7];
    const i64 r = u / R;
    if (r >= rs.count) return;
    const i64 x = u - r * R;
    int f = 0;
    while (rs.end[f] <= x) ++f;
    const i64 k = x - (f ? rs.end[f - 1] : 0);
    const i64 n = b.row_bytes[f];
    unsigned char* d = b.bank[f] + (rs.j + r) * n;
    const unsigned char* s = b.carry[f];
    i64 h = (i64)((16 - ((uintptr_t)d & 15)) & 15);
    h = h < n ? h : n;
    const i64 lo = k == 0 ? 0 : h + 16 * (k - 1);
    const i64 hi = k == 0 ? h : (lo + 16 < n ? lo + 16 : n);
    if (lo >= hi) return;      // a spare unit of this row
    if (hi - lo == 16 && (((uintptr_t)d - (uintptr_t)s) & 15) == 0) {
        *reinterpret_cast<uint4*>(d + lo) =
            __ldg(reinterpret_cast<const uint4*>(s + lo));
        return;
    }
    // bytes: every load issued before the first store
    u8 v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b)
        if (lo + b < hi) v[b] = __ldg(s + lo + b);
#pragma unroll
    for (int b = 0; b < 16; ++b)
        if (lo + b < hi) d[lo + b] = v[b];
}

// With kStore (the suffix's last launch, one lane) blocks pb.. re-stamp
// the bank rows of `rs`; without, that code is compiled out.
template <bool kStore>
__global__ void __launch_bounds__(kThreads)
pack_outputs_kernel(const __grid_constant__ PackArgs a, i64 n64, i64 w32,
                    i64 nwb, i64 nbits, i64 ws,
                    const __grid_constant__ BankArgs bk,
                    const __grid_constant__ RowStore rs, unsigned pb) {
    if constexpr (kStore) {
        if (blockIdx.x >= pb) {   // block-uniform: a re-stamp block
            store_unit(bk, rs,
                       (i64)(blockIdx.x - pb) * blockDim.x + threadIdx.x);
            return;
        }
    }
    const unsigned lane = grid_lane();
    if (lane >= a.L) return;
    const int ln = threadIdx.x & 31;
    const i64 gw = (i64)blockIdx.x * kPackWarps + (threadIdx.x >> 5);
    i64* out = a.out + lane * a.out_stride;
    if (gw < ws) {           // warp-uniform: the scalar words
        const i64 s = gw * 32 + ln;
        if (s < n64 + w32 + (a.bail != nullptr))
            pack_scalar(a, lane, s, n64, w32, nwb, out);
        return;
    }
    const i64 w0 = (gw - ws) * kBitWords;
    if (w0 >= nwb) return;   // warp-uniform
    const i64 p1 = a.seg_len[0], p2 = p1 + a.seg_len[1];
    const i64 p3 = p2 + a.seg_len[2];
    unsigned m[kBitWords / 8];
#pragma unroll
    for (int h = 0; h < kBitWords / 8; ++h) {
        const i64 i = (w0 + 8 * h) * 64 + 16 * ln;
        m[h] = i < nbits ? pack16(a, lane, i, nbits, p1, p2, p3) : 0u;
    }
#pragma unroll
    for (int h = 0; h < kBitWords / 8; ++h) {
        const unsigned m1 = __shfl_down_sync(~0u, m[h], 1);
        const unsigned m2 = __shfl_down_sync(~0u, m[h], 2);
        const unsigned m3 = __shfl_down_sync(~0u, m[h], 3);
        const i64 w = w0 + 8 * h + (ln >> 2);
        if ((ln & 3) == 0 && w < nwb)
            out[n64 + w32 + w] = (i64)((u64)(m[h] | (m1 << 16))
                                       | ((u64)(m2 | (m3 << 16)) << 32));
    }
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
        dim3 grid(blocks_for(unpack_units(nbits)));
        lane_grid(L, &grid);
        unpack_bits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            words, nbits, out, L, w_stride);
    }
    return (int)cudaGetLastError();
}

// One lane's unpack_bits and bank row j of `a` into its working carry, in
// one launch: one unit a thread of each, the unpack's blocks first.
int karp_unpack_bits_load(const long long* words, long long nbits,
                          unsigned char* out, const BankArgs* a,
                          long long j, void* stream) {
    BankCopy bc;
    const i64 units = bank_copy_plan(*a, j, &bc, false);
    const unsigned bu = nbits > 0 ? blocks_for(unpack_units(nbits)) : 0;
    const unsigned blocks = bu + blocks_for(units);
    if (blocks > 0)
        unpack_bits_load_kernel<<<blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(words, nbits, out,
                                                          bc, bu);
    return (int)cudaGetLastError();
}

// One launch for the whole output row of every lane (PackArgs); the row
// is out_stride words: n64 + w32 + nwb (+ 1 with a bail pointer). With
// `bank` non-null and count > 0 (one lane only) the launch also copies
// the carry of `bank` into its rows [j, j + count) (RowStore).
int karp_pack_outputs(const PackArgs* a, const BankArgs* bank, long long j,
                      long long count, void* stream) {
    const bool store = bank != nullptr && count > 0;
    if (store && (a->L != 1 || j < 0)) return (int)cudaErrorInvalidValue;
    i64 n64 = 0, nbits = 0;
    for (int f = 0; f < 5; ++f) n64 += a->f_len[f];
    for (int f = 0; f < 4; ++f) nbits += a->seg_len[f];
    const i64 w32 = (a->n32 + 1) / 2, nwb = (nbits + 63) / 64;
    const i64 ns = n64 + w32 + (a->bail != nullptr);
    const i64 ws = (ns + 31) / 32;
    const i64 warps = ws + (nwb + kBitWords - 1) / kBitWords;
    const unsigned pb = warps > 0 && a->L > 0
        ? (unsigned)((warps + kPackWarps - 1) / kPackWarps) : 0;
    RowStore rs = {};
    BankArgs bk = {};
    unsigned sb = 0;
    if (store) {
        bk = *bank;
        rs.j = j;
        rs.count = count;
        i64 acc = 0;
        for (int f = 0; f < 8; ++f) {
            acc += row_units(bk.row_bytes[f]);
            rs.end[f] = acc;
        }
        sb = blocks_for(count * acc);
    }
    if (pb + sb == 0) return (int)cudaGetLastError();
    dim3 grid(pb + sb);
    if (store) {
        pack_outputs_kernel<true><<<grid, kThreads, 0,
                                    (cudaStream_t)stream>>>(
            *a, n64, w32, nwb, nbits, ws, bk, rs, pb);
    } else {
        lane_grid(a->L, &grid);
        pack_outputs_kernel<false><<<grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
            *a, n64, w32, nwb, nbits, ws, bk, rs, pb);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
