// K10, the sharded FFD scan: the per-rank kernels of one step, launched
// between torch.distributed collectives (parallel/mesh.py drives them).
//
// Replaces karpenter_provider_aws_tpu/ops/ffd_jax.py:_solve with axis="tp"
// (the type-parallel mesh, parallel/mesh.py:614 solve_scan_sharded) and
// _solve_dp / dp_group_step / _fill_phase_dp (:571, :534, :488; the pods x
// types mesh, parallel/mesh.py:377 solve_scan_sharded2), with their
// collectives _axis_max (:109), _dp_prefix (:469) and _dp_sum (:482). On
// the TPU one shard_map program runs every shard and XLA inserts pmax,
// all_gather and psum inside it; here each rank is a process that runs
// these kernels on its own shard and the collectives run between launches
// on torch.distributed (NCCL, or gloo).
//
// A rank holds the types [tp*Tl, (tp+1)*Tl) and the slots [dp*Nl,
// (dp+1)*Nl) (global slot id = slot0 + local row). MeshArgs.f is the
// shard's FfdArgs: T = Tl, N = Nl, E = 0 (the existing-row overlay is
// mesh_fill's, by global slot id), the existing tables cut to the local
// rows (ex_alloc [Nl, D], ex_compat [G, Nl]) and the minValues pairs
// localized to the shard's types (a pair of another shard's type points
// at the dump value V). The step bodies are ffd_step.cuh's and
// ffd_cluster.cuh's, reused with the shard's type window and a global
// slot window (SlotWindow); nothing here repeats them.
//
// mesh_new_caps (once per solve, G x P blocks): the local new-node cap of
//   every (group, pool) over the rank's types, and with minValues floors
//   the per-value maxima h1n [G, P, K, V]. The caps read only A, daemon,
//   R, F, pool_types and the offerings (ffd_jax.py:388-400), never the
//   carry, so ONE tp all_reduce(MAX) of this [G, P(1 + K*V)] buffer per
//   solve replaces the reference's P pmax (and P h1n pmax) of every step.
// mesh_slot_headroom (per step), K == 0: steps 1-3 on the shard on warp
//   rows (ffd_step.cuh slot_headroom_warps, K2's k2_layout at one lane
//   of Nl rows: 8 warps a row at Nl = 256 and 1,024, 4 at K11's 2,112),
//   and on the same grid P * table_blocks(Tl) CTAs writing the group's
//   new-node table over the rank's types (new_node_table_block: candn /
//   hrn [P, Tl] and each block's partial cap in capn [P, TB]), which
//   reads no carry; the commit reads the table, and its caps are the
//   tp-reduced ones of mesh_new_caps, so the partial caps are scratch (a
//   check holds their max to the rank's own cap). k [Nl] is then the max
//   over the local types, and ONE tp all_reduce(MAX) of it replaces the
//   reference's pmax of k (:309). K > 0: one CTA a slot row
//   (slot_headroom_block), then h1 [Nl, K, V] after k in one buffer, so
//   the same all_reduce also replaces the pmax of h1 (:319); no table.
// mesh_fill (per step, one block, `phase`): (a) the existing-row overlay
//   by global slot id (slots < E, :511-514), the minValues cap of the
//   reduced h1, and the rank's per-pool sums of k (one dp all_gather of
//   [P] gives every pool's earlier-shard prefix: the P pool prefixes of
//   :516-523 sit on disjoint rows and read only the step's starting
//   pool_used); (b) the pool caps (commit_pool_caps with those prefixes)
//   and the rank's sum of the capped k (the second dp all_gather); (c)
//   the greedy fill (commit_greedy) and the rank's [P + 1] take-by-pool
//   sums, whose dp all_reduce(SUM) replaces the reference's two psums
//   (:556 and :560; the pods placed are the sum of all P + 1). `phase`
//   3 runs (a)-(c) in one launch with no earlier shards (ndp == 1).
// mesh_commit (per step), K == 0: the base group commit's cluster form
//   (ffd_scan.cu, ffd_cluster.cuh) over the rank's slot window, on a
//   cluster of CS CTAs of NT threads (K2's rule at one lane,
//   karp_ffd_k2_cluster: 8 x 512 at these shapes), CTA r owning the
//   local rows [r*ceil(Nl/CS), ...): each CTA's slot pass of the
//   narrowing (narrow_slots: used, zones, capacity types, its takers
//   compacted); after a cluster barrier the takers' (slot, type) cells
//   dealt round-robin over the cluster (deal_takers, narrow_cells); then
//   the new nodes from the table (commit_tail with a SlotWindow): CTA 0
//   stages the inputs with the tp-reduced caps, pool_used plus the
//   dp-reduced take by pool times R and n minus its sum, its thread 0
//   walks the pools at global slot ids with the true N and E, and the
//   whole cluster writes the opened rows that fall in the window; then
//   the group's takes row and leftover. K > 0: one CTA runs the block
//   bodies: each pool's cap min(the reduced cap, the minValues cap of the
//   reduced h1n) (the reference's per-pool cap, :400-404), the narrowing
//   slot by slot (commit_narrow with the reduced take by pool) and the
//   new-node phase with its T-pass pool by pool (commit_new_nodes with a
//   SlotWindow; row 0 of the table's buffers is its scratch).
//
// So a step costs the reference 1 + P tp pmax, P + 1 dp all_gather and 2
// dp psum; here 1 tp all_reduce, 2 dp all_gathers and 1 dp all_reduce
// (tp mesh: 1 tp all_reduce), with the same bytes out.
//
// What bounds them on this card: the shard's bytes over 3.35 TB/s are a
// fraction of a microsecond (about one for the headroom's candidate rows
// at Nl = 4,224); each launch costs its latency, and a step's collectives
// cost more than its kernels. The commit's cost is its chain of cluster
// barriers and dependent loads and, with many takers, the dealt cells:
// clock stamps at the 500k cell (Nl = 1,024, 571 takers) put about 48 us
// of its ~117 in each CTA's cells and 33 in the new-node tail (PERF.md).
// The headroom's warp rows take 80 registers a thread (one CTA a row took
// 48), so an SM holds three of its CTAs, not five, and at Nl = 1,024 and
// 4,224 its rows take more waves than one CTA a row did (17.1 against
// 12.6 us, 32.6 against 16.1); capped at 64 registers it spills and was
// slower still (PERF.md).
#include <cuda_runtime.h>

#include "ffd_cluster.cuh"

// The arguments of the four kernels (mirrored by ops/mesh_cuda.py
// _MeshArgs; every field 8 bytes wide). f.candn / f.hrn are the group's
// new-node table [P, Tl] (K > 0: row 0 is the commit's scratch).
struct MeshArgs {
    FfdArgs f;            // the rank's shard (see above)
    i64* h1;              // [Nl, K, V] per-value maxima of headroom + 1
    i64* caps;            // [G, P] caps, then [G, P, K, V] h1n (max over
                          // the type shards in place between launches)
    i64* red;             // [P + 1] the rank's sums of a fill phase
    const i64* before;    // [P + 1] earlier shards' sums: pools, then fill
    const i64* tbp;       // [P + 1] take-by-pool summed over the shards
    i64 slot0;            // global id of local row 0
    i64 N;                // true slot count E + n_max
    i64 E;                // existing rows
    i64* capn;            // [P, table_blocks(Tl)] the table's partial caps
    i64 cluster;          // CTAs of mesh_commit (1, 2, 4, 8; K > 0: 1)
    i64 threads;          // its threads a CTA (256, 512)
};

namespace {

namespace cg = cooperative_groups;

constexpr int kWideThreads = 256;
constexpr int kBlockThreads = 1024;
constexpr int kPhaseAll = 3;

int set_smem(const void* fn, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The value at rank f-1 (descending) of h1[0..V); 1 <= f <= V.
__device__ __forceinline__ i64 fth_value(const i64* h1, i64 V, i64 f) {
    for (i64 v = 0; v < V; ++v) {
        i64 x = h1[v], gt = 0, ge = 0;
        for (i64 u = 0; u < V; ++u) {
            gt += h1[u] > x;
            ge += h1[u] >= x;
        }
        if (gt <= f - 1 && f - 1 < ge) return x;
    }
    return 0;
}

// The minValues cap of per-value maxima h1 [K, V] under floors f[K], on
// one thread (mv_cap_from over fth_value).
__device__ __forceinline__ i64 mv_cap_serial(const i64* h1, const i64* f,
                                             i64 K, i64 V) {
    i64 cap = KARP_BIG;
    for (i64 kk = 0; kk < K; ++kk) {
        const i64 fk = f[kk];
        const i64 c = fk <= 0 ? KARP_BIG : fk > V ? -1
            : fth_value(h1 + kk * V, V, fk) - 1;
        cap = c < cap ? c : cap;
    }
    return cap < 0 ? 0 : cap;
}

// The rank's sum of k over its slot chunk [lo, hi) whose pool is `pool`
// (any pool when pool < -2), as a block total.
__device__ __forceinline__ i64 block_k_sum(const FfdArgs& a, i64 lo, i64 hi,
                                           i64 pool, i64* tmp) {
    i64 local = 0;
    for (i64 s = lo; s < hi; ++s)
        if (pool < -2 || a.pool[s] == pool) local = wadd(local, a.k[s]);
    i64 tot;
    block_excl_scan(local, tmp, &tot);
    return tot;
}

__global__ void __launch_bounds__(kWideThreads)
mesh_new_caps_kernel(MeshArgs m) {
    extern __shared__ i64 dyn[];   // h1n [K*V]
    __shared__ i64 red[33];
    const FfdArgs& a = m.f;
    const i64 T = a.T, D = a.D, P = a.P, K = a.K, V = a.V, M = a.M;
    const i64 g = blockIdx.x / P, pi = blockIdx.x % P;
    const i64* R = a.R + g * D;
    const i64* dmn = a.daemon + (g * P + pi) * D;
    if (K > 0) {
        for (i64 i = threadIdx.x; i < K * V; i += blockDim.x) dyn[i] = 0;
        __syncthreads();
        for (i64 kk = 0; kk < K; ++kk) {
            for (i64 j = threadIdx.x; j < M; j += blockDim.x) {
                i64 v = a.mv_pairs_v[kk * M + j];
                i64 t = a.mv_pairs_t[kk * M + j];
                if (v < 0 || v >= V || t < 0 || t >= T) continue;
                if (!new_node_cand(a, g, pi, t)) continue;
                atomicMax((long long*)&dyn[kk * V + v],
                          (long long)(headroom(a.A + t * D, dmn, R, D) + 1));
            }
        }
    }
    i64 cmax = 0;
    for (i64 t = threadIdx.x; t < T; t += blockDim.x) {
        if (!new_node_cand(a, g, pi, t)) continue;
        i64 hr = headroom(a.A + t * D, dmn, R, D);
        cmax = hr > cmax ? hr : cmax;
    }
    const i64 cap = block_max(cmax, red);   // its barriers publish dyn
    if (threadIdx.x == 0) m.caps[blockIdx.x] = cap;
    i64* h1n = m.caps + a.G * P + blockIdx.x * K * V;
    for (i64 i = threadIdx.x; i < K * V; i += blockDim.x) h1n[i] = dyn[i];
}

__global__ void __launch_bounds__(kRowThreads)
mesh_slot_headroom_kernel(const __grid_constant__ MeshArgs m, i64 g,
                          RowLayout lay) {
    extern __shared__ i64 dyn[];   // K > 0: h1 [K*V] of this slot
    __shared__ i64 red[33];
    __shared__ FfdArgs sa;         // K > 0: the arguments with K = 0
    const i64 K = m.f.K, V = m.f.V, M = m.f.M, T = m.f.T, D = m.f.D;
    const i64 N = m.f.N;
    if (K == 0) {
        const FfdArgs& a = m.f;    // read in place
        const i64 rb = block_rows(lay), nrb = (N + rb - 1) / rb;
        if (blockIdx.x >= nrb) {   // chunk c of the table of pool pi
            const i64 TB = table_blocks(T), j = blockIdx.x - nrb;
            const i64 pi = j / TB, c = j % TB;
            new_node_table_block(a, g, pi, c, a.candn + pi * T,
                                 a.hrn + pi * T, m.capn + j, nullptr, red,
                                 nullptr);
            return;
        }
        const i64 lo = blockIdx.x * rb, hi = lo + rb < N ? lo + rb : N;
        slot_headroom_warps(a, g, a.cand, a.k, lo, hi, (int)lay.warps);
        return;
    }
    lane_view_block(m.f, 0, &sa);
    __syncthreads();
    if (threadIdx.x == 0) sa.K = 0;   // the minValues cap waits for the max
    __syncthreads();
    const FfdArgs& a = sa;
    const i64 s = blockIdx.x;
    slot_headroom_block(a, g, s, red, nullptr);
    for (i64 i = threadIdx.x; i < K * V; i += blockDim.x) dyn[i] = 0;
    __syncthreads();                // also publishes cand[s, :]
    const i64* R = a.R + g * D;
    for (i64 kk = 0; kk < K; ++kk) {
        for (i64 j = threadIdx.x; j < M; j += blockDim.x) {
            i64 v = a.mv_pairs_v[kk * M + j];
            i64 t = a.mv_pairs_t[kk * M + j];
            if (v < 0 || v >= V || t < 0 || t >= T) continue;
            if (!a.cand[s * T + t]) continue;
            atomicMax((long long*)&dyn[kk * V + v],
                      (long long)(headroom(a.A + t * D, a.used + s * D, R, D)
                                  + 1));
        }
    }
    __syncthreads();
    for (i64 i = threadIdx.x; i < K * V; i += blockDim.x)
        m.h1[s * K * V + i] = dyn[i];
}

__global__ void __launch_bounds__(kBlockThreads)
mesh_fill_kernel(MeshArgs m, i64 g, int phase) {
    __shared__ i64 tmp[33];
    const FfdArgs& a = m.f;
    const i64 N = a.N, D = a.D, P = a.P, K = a.K, V = a.V;
    const i64* R = a.R + g * D;
    const i64 chunk = (N + blockDim.x - 1) / blockDim.x;
    const i64 lo = threadIdx.x * chunk, hi = lo + chunk < N ? lo + chunk : N;
    if (phase == 0 || phase == kPhaseAll) {
        for (i64 s = threadIdx.x; s < N; s += blockDim.x) {
            i64 k = a.k[s];
            const int pool = a.pool[s];
            if (m.slot0 + s < m.E) {
                k = (a.alive[s] && a.ex_compat[g * N + s])
                    ? headroom(a.ex_alloc + s * D, a.used + s * D, R, D) : 0;
            } else if (K > 0 && pool >= 0) {
                const i64 pc = pool > P - 1 ? P - 1 : pool;
                const i64 cap = mv_cap_serial(m.h1 + s * K * V,
                                              a.mv_floor + pc * K, K, V);
                k = cap < k ? cap : k;
            }
            a.k[s] = k;
        }
        __syncthreads();
        if (phase == 0) {
            for (i64 pi = 0; pi < P; ++pi) {
                const i64 tot = block_k_sum(a, lo, hi, pi, tmp);
                if (threadIdx.x == 0) m.red[pi] = tot;
            }
            return;
        }
    }
    if (phase == 1 || phase == kPhaseAll) {
        commit_pool_caps(a, g, lo, hi, tmp,
                         phase == kPhaseAll ? nullptr : m.before);
        if (phase == 1) {
            const i64 tot = block_k_sum(a, lo, hi, -3, tmp);
            if (threadIdx.x == 0) m.red[0] = tot;
            return;
        }
    }
    commit_greedy(a, g, lo, hi, tmp, phase == kPhaseAll ? 0 : m.before[P]);
    for (i64 p = threadIdx.x; p <= P; p += blockDim.x) m.red[p] = 0;
    __syncthreads();
    for (i64 s = threadIdx.x; s < N; s += blockDim.x) {
        const int pool = a.pool[s];
        const i64 seg = pool < 0 ? P : (pool > P - 1 ? P - 1 : pool);
        atomicAdd((unsigned long long*)&m.red[seg],
                  (unsigned long long)a.k[s]);
    }
}

// Dynamic shared bytes of the commit on clusters of cs CTAs: the cluster
// commit's layout at K == 0; take_by_pool [P] and the caps [P] at K > 0.
size_t commit_smem(const FfdArgs& f, i64 cs) {
    if (f.K > 0) return (size_t)(2 * f.P) * sizeof(i64);
    return cluster_commit_smem(1, f.P, f.D, (f.N + cs - 1) / cs);
}

template <int NT>
__global__ void __launch_bounds__(NT)
mesh_commit_kernel(const __grid_constant__ MeshArgs m, i64 g) {
    extern __shared__ i64 dyn[];
    __shared__ i64 tmp[33];
    __shared__ i64 sc[8];
    __shared__ int pre[9];         // the CTAs' taker counts, as a prefix
    const FfdArgs& a = m.f;        // read in place
    const i64 N = a.N, P = a.P, K = a.K, V = a.V;
    const int tid = threadIdx.x;
    if (K > 0) {                   // one CTA (karp_mesh_commit)
        i64* cap = dyn + P;        // take_by_pool [P], then the caps [P]
        for (i64 pi = tid; pi < P; pi += NT) {
            i64 c = m.caps[g * P + pi];
            const i64* h1n = m.caps + a.G * P + (g * P + pi) * K * V;
            const i64 mc = mv_cap_serial(h1n, a.mv_floor + pi * K, K, V);
            cap[pi] = mc < c ? mc : c;   // commit_narrow's barriers
        }                                // publish it
        i64 taken = 0;
        for (i64 p = 0; p <= P; ++p) taken = wadd(taken, m.tbp[p]);
        i64 n_rem = wsub(a.n[g], taken);
        commit_narrow(a, g, 1, dyn, m.tbp);                     // step 6
        const SlotWindow w{m.slot0, N, m.N, m.E, cap, m.tbp};
        n_rem = commit_new_nodes(a, g, n_rem, tmp, sc, nullptr, nullptr, &w);
        commit_outputs(a, g, n_rem);
        return;
    }
    cg::cluster_group cl = cg::this_cluster();
    const i64 CS = cl.num_blocks(), rank = cl.block_rank();
    // the CTA's local rows [c0, c1)
    const i64 cchunk = (N + CS - 1) / CS;
    const i64 c0 = rank * cchunk < N ? rank * cchunk : N;
    const i64 c1 = c0 + cchunk < N ? c0 + cchunk : N;
    CommitSmem cm = commit_smem_at(dyn, 1, P, a.D, cchunk);
    for (i64 w = tid; w < P + 1; w += NT) cm.tbp[w] = 0;   // tbp, tks
    if (tid == 0) cm.ntk[0] = 0;
    __syncthreads();
    narrow_slots(a, g, 0, 1, c0, c1, cm.tk, cm.tkm, cm.ntk, cm.tbp);
    int* mine = reinterpret_cast<int*>(cm.tkm);
    const int nmine = deal_takers(cm.tk, cm.ntk, mine, pre, NT);
    const i64 T = a.T;
    narrow_cells(a, nmine, [&](int jj) { return (i64)mine[jj]; },
                 [&](int, i64 s, i64 t) {
                     return __ldg(&a.cand[s * T + t]) != 0;
                 }, cm.tu);
    const SlotWindow w{m.slot0, N, m.N, m.E, m.caps + g * P, m.tbp};
    commit_tail(a, g, 0, 1, 1, c0, c1, nullptr, cm.tbp, cm.xch, cm.stage,
                cm.sc, true, &w);
    cl.sync();   // no CTA leaves while another may read its shared memory
}

const void* commit_fn(i64 threads) {
    return threads == 512 ? (const void*)mesh_commit_kernel<512>
                          : (const void*)mesh_commit_kernel<256>;
}

}  // namespace

extern "C" {

int karp_mesh_new_caps(const MeshArgs* m, void* stream) {
    size_t smem = (size_t)(m->f.K * m->f.V) * sizeof(i64);
    int err = set_smem((const void*)mesh_new_caps_kernel, smem);
    if (err) return err;
    mesh_new_caps_kernel<<<(unsigned)(m->f.G * m->f.P), kWideThreads, smem,
                           (cudaStream_t)stream>>>(*m);
    return (int)cudaGetLastError();
}

int karp_mesh_slot_headroom(const MeshArgs* m, long long g, void* stream) {
    const FfdArgs& f = m->f;
    size_t smem = (size_t)(f.K * f.V) * sizeof(i64);
    int err = set_smem((const void*)mesh_slot_headroom_kernel, smem);
    if (err) return err;
    const RowLayout lay = k2_layout(1, f.N);
    const i64 rb = block_rows(lay);
    const unsigned grid = (unsigned)(f.K > 0 ? f.N
                                     : (f.N + rb - 1) / rb
                                       + f.P * table_blocks(f.T));
    mesh_slot_headroom_kernel<<<grid, kRowThreads, smem,
                                (cudaStream_t)stream>>>(*m, (i64)g, lay);
    return (int)cudaGetLastError();
}

int karp_mesh_fill(const MeshArgs* m, long long g, int phase, void* stream) {
    mesh_fill_kernel<<<1, kBlockThreads, 0, (cudaStream_t)stream>>>(*m, g,
                                                                    phase);
    return (int)cudaGetLastError();
}

int karp_mesh_commit(const MeshArgs* m, long long g, void* stream) {
    const i64 cs = m->cluster, nt = m->threads;
    if ((cs != 1 && cs != 2 && cs != 4 && cs != 8) || (nt != 256 && nt != 512)
        || (m->f.K > 0 && cs != 1))
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cs);
    cfg.blockDim = dim3((unsigned)nt, 1, 1);
    cfg.dynamicSmemBytes = commit_smem(m->f, cs);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int err = set_smem(commit_fn(nt), cfg.dynamicSmemBytes);
    if (err) return err;
    err = nt == 512
        ? (int)cudaLaunchKernelEx(&cfg, mesh_commit_kernel<512>, *m, (i64)g)
        : (int)cudaLaunchKernelEx(&cfg, mesh_commit_kernel<256>, *m, (i64)g);
    if (err) return err;
    return (int)cudaGetLastError();
}

}  // extern "C"
