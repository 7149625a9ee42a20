// Shared definitions of the FFD group-scan kernels (ffd_scan.cu), the
// packed-arena kernels (packed_io.cu, which also move the checkpoint
// bank's rows), the consolidation kernels (consolidation.cu) and the
// pruned scan's kernels (pruned.cu).
//
// Integer rules, carried over from the reference kernel
// (karpenter_provider_aws_tpu/ops/ffd_jax.py): every resource, headroom,
// budget and prefix is a 64-bit integer (BIG = 1 << 60 and byte-scale
// quantities overflow int32). Sums and products wrap like the reference's
// int64 arithmetic, so they are done in unsigned 64-bit and cast back
// (signed overflow is undefined in C++). C `/` truncates toward zero:
// `floordiv` and `ceildiv` below give the reference's floor semantics.
#pragma once

#include <cstdint>

typedef long long i64;
typedef unsigned long long u64;
typedef unsigned char u8;

#define KARP_BIG (1LL << 60)

// A lane axis on grid y and z: y holds at most 65,535 blocks, so more
// lanes take z = ceil(L / 65,535) layers of y = ceil(L / z) blocks, and a
// block whose lane is past L returns. With L <= 65,535, z = 1 and the
// lane is blockIdx.y.
inline void lane_grid(i64 L, dim3* grid) {
    const i64 z = L > 65535 ? (L + 65534) / 65535 : 1;
    grid->y = (unsigned)((L + z - 1) / z);
    grid->z = (unsigned)z;
}

__device__ __forceinline__ unsigned grid_lane() {
    return blockIdx.z * gridDim.y + blockIdx.y;
}

// Number of pointer fields at the head of FfdArgs (A .. leftover).
#define KARP_FFD_PTRS 32

// Pointers and statics of one solve, or of L independent solves (lanes).
// Every field is 8 bytes wide, so the ctypes mirror in ops/ffd_cuda.py
// (_FfdArgs) has no padding to agree on.
//
// The lane axis: lane l of pointer field i starts lane_bytes[i] * l bytes
// past the field's pointer; a stride of 0 means the lanes share the field
// (the catalog and pool tables of a consolidation subset round). With
// L == 1 and every stride 0 the kernels read exactly what they read
// without a lane axis.
struct FfdArgs {
    // catalog
    const i64* A;           // [T, D]
    const u8* avail_zc;     // [T, Z*C]
    // groups
    const i64* R;           // [G, D]
    const i64* n;           // [G]
    const u8* F;            // [G, T]
    const u8* agz;          // [G, Z]
    const u8* agc;          // [G, C]
    const u8* admit;        // [G, P]
    const i64* daemon;      // [G, P, D]
    // pools
    const u8* pool_types;   // [P, T]
    const u8* pool_agz;     // [P, Z]
    const u8* pool_agc;     // [P, C]
    const i64* pool_limit;  // [P, D]
    // existing nodes
    const i64* ex_alloc;    // [E, D]
    const u8* ex_compat;    // [G, E]
    // minValues floors (unused when K == 0)
    const i64* mv_floor;    // [P, K]
    const i64* mv_pairs_t;  // [K, M]
    const i64* mv_pairs_v;  // [K, M]
    // carry: device resident across the whole scan, updated in place
    i64* used;              // [N, D]
    u8* types;              // [N, T]
    u8* zones;              // [N, Z]
    u8* ct;                 // [N, C]
    int* pool;              // [N]   (-1 free, -2 existing)
    u8* alive;              // [N]
    int* num_nodes;         // [1]
    i64* pool_used;         // [P, D]
    // per-group scratch
    u8* cand;               // [N, T]
    i64* k;                 // [N]   headroom, then take
    i64* hrn;               // [P, T] the group's new-node table: fresh-
    u8* candn;              // [P, T] node headroom and candidates (row 0
                            //   the one-pool scratch of commit_new_nodes)
    // outputs, over the scanned group window [G0, G0 + rows)
    int* takes;             // [rows, N]
    i64* leftover;          // [rows]
    // statics; G0 is the window's first group (row 0 of takes/leftover)
    i64 T, D, Z, C, G, E, P, N, K, M, V, G0;
    // lanes, and the byte stride between lanes of each pointer field
    i64 L;
    i64 lane_bytes[KARP_FFD_PTRS];
};

// The arguments of lane `lane`: every pointer moved by its lane stride.
// The pointers are the struct's first KARP_FFD_PTRS members, all 8 bytes.
__device__ __forceinline__ FfdArgs lane_view(const FfdArgs& a, i64 lane) {
    FfdArgs v = a;
    unsigned char** p = reinterpret_cast<unsigned char**>(&v);
#pragma unroll
    for (int i = 0; i < KARP_FFD_PTRS; ++i)
        if (p[i]) p[i] += lane * a.lane_bytes[i];
    return v;
}

// lane_view(a, lane) into *out (shared memory) by the whole block, one
// 8-byte word a thread (every field is 8 bytes wide); the caller puts a
// barrier before reading it.
__device__ __forceinline__ void lane_view_block(const FfdArgs& a, i64 lane,
                                                FfdArgs* out) {
    constexpr int kWords = sizeof(FfdArgs) / sizeof(i64);
    const i64* src = reinterpret_cast<const i64*>(&a);
    i64* dst = reinterpret_cast<i64*>(out);
    for (int i = threadIdx.x; i < kWords; i += blockDim.x) {
        i64 v = src[i];
        if (i < KARP_FFD_PTRS && v) v += lane * a.lane_bytes[i];
        dst[i] = v;
    }
}

__device__ __forceinline__ i64 wadd(i64 a, i64 b) {
    return (i64)((u64)a + (u64)b);
}
__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
    return (i64)((u64)a - (u64)b);
}
__device__ __forceinline__ i64 wmul(i64 a, i64 b) {
    return (i64)((u64)a * (u64)b);
}

// floor(a / b) for b > 0
__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
    i64 q = a / b;
    if ((a % b != 0) && (a < 0)) --q;
    return q;
}

// floordiv(a, b) for b > 0 by an fp64 quotient and one int64 correction
// where |a| and b are below 2^52 (the rounded quotient is then within one
// of the floor, which the remainder's sign and size fix); the integer
// division otherwise. Exact either way.
__device__ __forceinline__ i64 floordiv_fp(i64 a, i64 b) {
    constexpr i64 kLim = 1LL << 52;
    if (a <= -kLim || a >= kLim || b >= kLim) return floordiv(a, b);
    i64 q = (i64)floor((double)a / (double)b);
    const i64 r = a - q * b;
    q -= r < 0;
    q += r >= b;
    return q;
}

// floordiv(a, b) for b > 0 by an fp64 product with rb = 1 / b (rounded;
// the caller computes it once for many numerators) and one int64
// correction each way, where |a| and b are below 2^52: the product is
// then within one of the quotient (b = 1 is exact, b >= 2 leaves
// |a / b| <= 2^51 and an error below 1/2), which the remainder's sign and
// size fix. The integer division otherwise. Exact either way.
__device__ __forceinline__ i64 floordiv_rcp(i64 a, i64 b, double rb) {
    constexpr i64 kLim = 1LL << 52;
    if (a <= -kLim || a >= kLim || b >= kLim) return floordiv(a, b);
    i64 q = (i64)floor((double)a * rb);
    const i64 r = a - q * b;
    q -= r < 0;
    q += r >= b;
    return q;
}

// Bits 0-3: which bytes of x are not zero.
__device__ __forceinline__ unsigned nz4(unsigned x) {
    const unsigned m = __vcmpne4(x, 0u);   // 0xff a non-zero byte
    return (m & 1u) | ((m >> 7) & 2u) | ((m >> 14) & 4u) | ((m >> 21) & 8u);
}

// Widest request row a slot CTA stages in shared memory (its quotients
// then read a type's allocatable row from registers); wider rows read
// the global rows (fused.cu, topo.cu).
constexpr int kHeadDims = 8;

// Read-only loads issued where they are written (volatile): left to
// itself the compiler sank a type's loads next to their uses, so each
// waited for the one before it.
__device__ __forceinline__ unsigned ld_pin_u8(const u8* p) {
    unsigned v;
    asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}
__device__ __forceinline__ unsigned ld_pin_u32(const unsigned* p) {
    unsigned v;
    asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}
__device__ __forceinline__ i64 ld_pin_i64(const i64* p) {
    i64 v;
    asm volatile("ld.global.nc.s64 %0, [%1];" : "=l"(v) : "l"(p));
    return v;
}

// headroom() of an allocatable row av [D] (D <= kHeadDims: registers, or
// a global row) over a used row u and a request row r in shared memory,
// its quotients in fp64 with one int64 correction: floordiv_fp, or by
// the reciprocals rb[d] = 1 / r[d] (rounded; staged once a CTA for many
// rows) floordiv_rcp, which costs no division (a type loop's 64-bit
// divisions were most of a candidate type's time).
template <typename Row>
__device__ __forceinline__ i64 head_staged(const Row& av, const i64* u,
                                           const i64* r, i64 D,
                                           const double* rb = nullptr) {
    i64 m = KARP_BIG;
#pragma unroll
    for (int d = 0; d < kHeadDims; ++d) {
        if (d >= D || r[d] <= 0) continue;
        const i64 x = wsub(av[d], u[d]);
        const i64 q = rb ? floordiv_rcp(x, r[d], rb[d]) : floordiv_fp(x, r[d]);
        m = q < m ? q : m;
    }
    return m < 0 ? 0 : m;
}

// The most zone x capacity-type pairs an offering word holds (bit z*C +
// c; bit 63 is the sign bit); more pairs take the byte loops.
constexpr int kOfferBits = 64;

// A type's offerings avail_zc[t] (its row of zc <= kOfferBits bytes) as
// one word, bit i the pair i: the row's loads issued 16 at a time before
// their uses.
__device__ __forceinline__ u64 offer_word(const u8* row, i64 zc) {
    u64 w = 0;
    for (i64 i0 = 0; i0 < zc; i0 += 16) {
        unsigned v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
            v[j] = i0 + j < zc ? ld_pin_u8(row + i0 + j) : 0u;
#pragma unroll
        for (int j = 0; j < 16; ++j)
            if (i0 + j < zc) w |= (u64)(v[j] != 0) << (i0 + j);
    }
    return w;
}

// ceil(a / b) for b > 0, as the reference's -(-a // b)
__device__ __forceinline__ i64 ceildiv(i64 a, i64 b) {
    return -floordiv(-a, b);
}

// min_d floor((cap[d] - base[d]) / R[d]) over dims with R[d] > 0 (BIG
// when none), clipped to [0, BIG]
__device__ __forceinline__ i64 headroom(const i64* cap, const i64* base,
                                        const i64* R, i64 D) {
    i64 m = KARP_BIG;
    for (i64 d = 0; d < D; ++d) {
        i64 r = R[d];
        if (r > 0) {
            i64 q = floordiv(wsub(cap[d], base[d]), r);
            if (q < m) m = q;
        }
    }
    return m < 0 ? 0 : m;
}

// Candidate test of (slot s, type t) for group g: an available offering
// in the slot's zones x capacity types narrowed by the group's. The
// caller has already checked types[s, t], F[g, t] and the slot's pool
// admission. (ffd_scan.cu, pruned.cu)
__device__ __forceinline__ bool offering_ok(const FfdArgs& a, i64 g, i64 s,
                                            i64 t) {
    const i64 Z = a.Z, C = a.C;
    for (i64 z = 0; z < Z; ++z) {
        if (!(a.zones[s * Z + z] && a.agz[g * Z + z])) continue;
        for (i64 c = 0; c < C; ++c) {
            if (a.ct[s * C + c] && a.agc[g * C + c]
                && a.avail_zc[t * Z * C + z * C + c])
                return true;
        }
    }
    return false;
}

// Max additional pods a pool's limits allow (BIG if unlimited).
__device__ __forceinline__ i64 pool_budget(const i64* limit, const i64* used,
                                           const i64* R, i64 D) {
    i64 m = KARP_BIG;
    for (i64 d = 0; d < D; ++d) {
        if (limit[d] >= 0 && R[d] > 0) {
            i64 room = wsub(limit[d], used[d]);
            i64 q = floordiv(room < 0 ? 0 : room, R[d]);
            if (q < m) m = q;
        }
    }
    return m;
}

// Block-wide max of one value per thread; every thread gets the result.
// `red` holds at least 33 entries of shared memory.
__device__ __forceinline__ i64 block_max(i64 v, i64* red) {
    for (int off = 16; off > 0; off >>= 1) {
        i64 o = __shfl_down_sync(0xffffffffu, v, off);
        v = o > v ? o : v;
    }
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int nwarps = (blockDim.x + 31) >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < nwarps ? red[lane] : red[0];
        for (int off = 16; off > 0; off >>= 1) {
            i64 o = __shfl_down_sync(0xffffffffu, v, off);
            v = o > v ? o : v;
        }
        if (lane == 0) red[32] = v;
    }
    __syncthreads();
    return red[32];
}

// The fth-largest select of the minValues cap: for one key, the value of
// h1[0..V) at rank f-1 in descending order. Threads of the block stride
// over V; the thread(s) holding that value write it to *out. Needs
// 1 <= f <= V; equal values write the same number.
__device__ __forceinline__ void fth_largest(const i64* h1, i64 V, i64 f,
                                            i64* out) {
    for (i64 v = threadIdx.x; v < V; v += blockDim.x) {
        i64 x = h1[v], gt = 0, ge = 0;
        for (i64 u = 0; u < V; ++u) {
            gt += h1[u] > x;
            ge += h1[u] >= x;
        }
        if (gt <= f - 1 && f - 1 < ge) *out = x;
    }
}

// The cap a set of per-value maxima h1 [K, V] allows under floors f[K]:
// min over keys of (f <= 0 ? BIG : f > V ? -1 : fth_largest - 1), at
// least 0. `sel` [K] holds the fth_largest results.
__device__ __forceinline__ i64 mv_cap_from(const i64* f, const i64* sel,
                                           i64 K, i64 V) {
    i64 cap = KARP_BIG;
    for (i64 k = 0; k < K; ++k) {
        i64 c = f[k] <= 0 ? KARP_BIG : (f[k] > V ? -1 : sel[k] - 1);
        if (c < cap) cap = c;
    }
    return cap < 0 ? 0 : cap;
}

// Block-wide exclusive scan with wrapping 64-bit adds. `local` is this
// thread's chunk total; returns the sum of the chunks before it and
// writes the block total to *total. Needs 33 shared entries in `tmp`.
__device__ __forceinline__ i64 block_excl_scan(i64 local, i64* tmp,
                                               i64* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    u64 incl = (u64)local;
    for (int off = 1; off < 32; off <<= 1) {
        u64 o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
    }
    __syncthreads();
    if (lane == 31) tmp[warp] = (i64)incl;
    __syncthreads();
    if (warp == 0) {
        u64 w = lane < nwarps ? (u64)tmp[lane] : 0;
        u64 wi = w;
        for (int off = 1; off < 32; off <<= 1) {
            u64 o = __shfl_up_sync(0xffffffffu, wi, off);
            if (lane >= off) wi += o;
        }
        if (lane < nwarps) tmp[lane] = (i64)(wi - w);   // exclusive
        if (lane == 31) tmp[32] = (i64)wi;
    }
    __syncthreads();
    i64 before = (i64)((u64)tmp[warp] + incl - (u64)local);
    *total = tmp[32];
    __syncthreads();
    return before;
}

// The inclusive prefix of v over a warp's lanes, wrapping (no barrier).
__device__ __forceinline__ u64 warp_scan_u64(u64 v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const u64 o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
    }
    return v;
}

// The wrapping sum of v over a warp's lanes, on every lane.
__device__ __forceinline__ u64 warp_sum_u64(u64 v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// ---------------------------------------------------------------------------
// The checkpoint bank (K3): the carry's eight fields and their bank rows
// ---------------------------------------------------------------------------

// Mirror of ops/ffd_cuda.py _BankArgs (8-byte fields throughout). Outside
// any unnamed namespace: exported entry points take it (packed_io.cu,
// ffd_scan.cu), and a type of such a namespace would give them internal
// linkage.
struct BankArgs {
    unsigned char* carry[8];   // the working carry, field by field
    unsigned char* bank[8];    // row 0 of each bank field
    i64 row_bytes[8];          // bytes of one carry field
};

// A copy between the working carry and one bank row, made by every
// thread of a launch that does not write what it reads: into the row
// (to_bank: ffd_slot_headroom at a chunk entry, ffd_scan.cu, which reads
// the carry and writes none of it) or out of the row into the carry (the
// suffix re-solve's load, unpack_bits_load in packed_io.cu; the suffix's
// pad re-stamp, several rows, is pack_outputs' own, packed_io.cu). Each field
// is cut into units: where its carry and its bank row share their address
// mod 16, the bytes before the destination's first 16-byte boundary
// (head; the source's too), its 16-byte words (nv) and the bytes after
// them; any other field (a bool plane of odd width in a row j > 0) byte
// by byte (head = its bytes, nv = 0). end[f] counts the units of fields
// 0 .. f; thread i of S takes units i, i + S, ...
struct BankCopy {
    const unsigned char* src[8];
    unsigned char* dst[8];
    i64 head[8];
    i64 nv[8];
    i64 end[8];
};

// The copy of the carry of `a` into bank row j (to_bank), or of row j
// into the carry; returns its units.
inline i64 bank_copy_plan(const BankArgs& a, i64 j, BankCopy* c,
                          bool to_bank) {
    i64 acc = 0;
    for (int f = 0; f < 8; ++f) {
        const i64 n = a.row_bytes[f];
        unsigned char* row = a.bank[f] + j * n;
        unsigned char* d = to_bank ? row : a.carry[f];
        const unsigned char* s = to_bank ? a.carry[f] : row;
        i64 h = n, nv = 0;
        if ((((uintptr_t)d - (uintptr_t)s) & 15) == 0) {
            h = (i64)((16 - ((uintptr_t)d & 15)) & 15);
            h = h < n ? h : n;
            nv = (n - h) / 16;
        }
        c->src[f] = s;
        c->dst[f] = d;
        c->head[f] = h;
        c->nv[f] = nv;
        acc += n - 15 * nv;      // head + nv + the bytes after
        c->end[f] = acc;
    }
    return acc;
}

// One unit of a BankCopy, loaded: its destination, its width (16, 1, or 0
// past the copy's end) and its bytes.
struct CopyUnit {
    unsigned char* d;
    uint4 v;
    int w;
};

__device__ __forceinline__ CopyUnit bank_copy_load(const BankCopy& c, i64 u) {
    CopyUnit x;
    x.d = nullptr;
    x.w = 0;
    if (u >= c.end[7]) return x;
    int f = 0;
    while (c.end[f] <= u) ++f;
    const i64 r = u - (f ? c.end[f - 1] : 0);
    const i64 h = c.head[f], nv = c.nv[f];
    if (r >= h && r < h + nv) {
        const i64 off = h + 16 * (r - h);
        x.v = *reinterpret_cast<const uint4*>(c.src[f] + off);
        x.d = c.dst[f] + off;
        x.w = 16;
    } else {
        const i64 off = r < h ? r : r + 15 * nv;   // head, or the bytes after
        x.v.x = c.src[f][off];
        x.d = c.dst[f] + off;
        x.w = 1;
    }
    return x;
}

__device__ __forceinline__ void bank_copy_store(const CopyUnit& x) {
    if (x.w == 16)
        *reinterpret_cast<uint4*>(x.d) = x.v;
    else if (x.w == 1)
        *x.d = (unsigned char)x.v.x;
}

// The thread's units after its first, u0: u0 + S, u0 + 2S, ...
__device__ __forceinline__ void bank_copy_rest(const BankCopy& c, i64 u0,
                                               i64 S) {
    for (i64 u = u0 + S; u < c.end[7]; u += S)
        bank_copy_store(bank_copy_load(c, u));
}

// ---------------------------------------------------------------------------
// The membership record of a group without topology (K9's plain groups)
// ---------------------------------------------------------------------------

// Mirror of ops/ffd_cuda.py _RecordArgs (8-byte fields): the topology
// scan's counters and the groups' membership rows, which
// ffd_group_commit updates with the takes it writes (topo_jax.py:685-702).
// zfix == nullptr: no record (cz or ch may be null where no group names
// one of their rows).
struct RecordArgs {
    i64* cz;                // [GZ, Z] zone counters
    i64* ch;                // [GH, N] hostname counters
    const int* zfix;        // [N] each slot's zone, -1 undecided
    const int* member_z;    // [G] the group's zone counter row, -1 none
    const int* member_h;    // [G] its hostname counter row, -1 none
};

// ---------------------------------------------------------------------------
// The summary row of a consolidation subset lane (K7d)
// ---------------------------------------------------------------------------

// Mirror of ops/consolidation_cuda.py _SummaryArgs (8-byte fields): what
// the subset round's last ffd_group_commit reads besides its own scan to
// write each lane's [5] row (consolidation_jax.py:253-262). The lane's
// leftover, num_nodes and new-node types come from the commit's own lane
// view, so they are the scan's.
struct SummaryArgs {
    const u8* keep;            // [L, T] each lane's kept types
    const i64* tprice;         // [T]
    const i64* removed_price;  // [L]
    i64* out;                  // [L, 5] the rows (SUBSET_OUT_COLS)
};
