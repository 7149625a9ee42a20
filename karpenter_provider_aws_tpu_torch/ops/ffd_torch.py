"""The packed FFD group scan: plain PyTorch versions and the dispatch.

This is the port of the reference package's ``ops/ffd_jax.py`` base path
(``solve_scan`` and ``solve_scan_packed1`` with F=1): one scan over pod
groups whose carry is the whole open-node state. Per group g:

1. candidates ``cand[s,t] = types ∧ F[g] ∧ off_ok ∧ admitted(pool[s])``,
   where ``off_ok`` is a boolean any-reduction over (zone, capacity type)
   offerings — never an integer matmul, which CUDA does not offer;
2. headroom ``k[s] = max_t cand ? min_d floor((A-used)/R) : 0`` (masked
   dims count as BIG; existing rows use their own allocatable);
3. the minValues cap (f-th largest per-value max of headroom+1);
4. per-pool limit caps over an exclusive prefix of ``k``;
5. the greedy prefix fill ``take = clip(n - prefix(k), 0, k)``;
6. narrowing of the filled slots and the pool accounting;
7. new nodes, pool by pool: ``q = ceil(min(n_rem, budget) / cap)``.

All decision arithmetic is int64 (BIG = 1 << 60 and byte quantities
overflow int32); only ``takes`` leaves as int32. Every function here is
written with operations that run on the CPU and on CUDA alike: floor
division through ``torch.div(..., rounding_mode="floor")``, bit packing
through int64 arithmetic (torch has no uint64 shifts), segment maxima
through ``scatter_reduce("amax")``.

K3, the incremental solve (``solve_scan_packed1_ckpt`` and
``solve_scan_suffix``, the reference's functions of the same names):
the full scan also records a bank of the carry entering every CK-th
group; a warm tick restores one bank row and re-scans only the suffix of
groups up to the live bound, splicing its own entry carries over the
bank's tail.

K4, ``solve_scan_packed1_many``: B arenas of one statics bucket in one
dispatch (the reference's vmap; a lane axis on the kernels). K5, the
fused block scan (``solve_scan_packed1`` and ``_many`` with F > 1, the
reference's ``_solve_fused``): G/F blocks of F groups; a block whose
``fuse`` flags prove its groups pairwise disjoint runs every fill from
the block-start carry, merges them, then opens new nodes group by group,
and any other block runs F plain steps. K6, the
pruned scan (``solve_scan_packed1_pruned`` and ``_many``): the G-axis
variant of the scan, with a per-slot capacity bound in the carry and
exact work only for the first S bound-positive slots; a trailing bail
word marks the inputs where the pruning could have mattered.

K10, the sharded scan (the reference's ``_solve`` with ``axis="tp"`` and
``_solve_dp``): the plain versions of a mesh rank's whole scan, with the
reference's collectives one by one through a ``MeshComm``
(parallel/mesh.py): ``_solve_scan_ref(comm=)`` on a type shard and
``_solve_dp_ref`` on a (slot, type) shard. The per-rank kernels and
their plain parts are in ``ops/mesh_cuda.py``.

``solve_scan`` / ``solve_scan_packed1`` / ``solve_scan_packed1_ckpt`` /
``solve_scan_suffix`` / ``solve_scan_packed1_many`` /
``solve_scan_packed1_pruned`` / ``_many`` dispatch on the tensor's
device: the plain versions below for a CPU tensor, the CUDA kernels of
``ops/ffd_cuda.py`` for a CUDA tensor. Nothing on the CUDA path calls a
plain version, and nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from .hostpack import (DEV_PRUNED_SLOTS, in_layout_bool, in_layout_i64,
                       layout_sizes, nwords, split)

BIG = 1 << 60

_I64 = torch.int64


class KernelInputs(NamedTuple):
    """Static-shape tensors of one solve (the reference's field set)."""
    A: torch.Tensor          # [T, D] int64 allocatable
    avail_zc: torch.Tensor   # [T, Z*C] bool
    R: torch.Tensor          # [G, D] int64
    n: torch.Tensor          # [G] int64
    F: torch.Tensor          # [G, T] bool
    agz: torch.Tensor        # [G, Z] bool
    agc: torch.Tensor        # [G, C] bool
    admit: torch.Tensor      # [G, P] bool
    daemon: torch.Tensor     # [G, P, D] int64
    pool_types: torch.Tensor  # [P, T] bool
    pool_agz: torch.Tensor    # [P, Z] bool
    pool_agc: torch.Tensor    # [P, C] bool
    pool_limit: torch.Tensor  # [P, D] int64 (-1 = unlimited)
    pool_used0: torch.Tensor  # [P, D] int64
    ex_alloc: torch.Tensor    # [E, D] int64
    ex_used0: torch.Tensor    # [E, D] int64
    ex_compat: torch.Tensor   # [G, E] bool
    mv_floor: Optional[torch.Tensor] = None    # [P, K] int64
    mv_pairs_t: Optional[torch.Tensor] = None  # [K, M] int64
    mv_pairs_v: Optional[torch.Tensor] = None  # [K, M] int64 (pad = V)
    #: [G] bool same_run_as_prev flags of a fused arena (F > 1), else None
    fuse: Optional[torch.Tensor] = None


class Carry(NamedTuple):
    used: torch.Tensor       # [N, D] int64
    types: torch.Tensor      # [N, T] bool
    zones: torch.Tensor      # [N, Z] bool
    ct: torch.Tensor         # [N, C] bool
    pool: torch.Tensor       # [N] int32 (-1 free, -2 existing)
    alive: torch.Tensor      # [N] bool
    num_nodes: torch.Tensor  # [1] int32
    pool_used: torch.Tensor  # [P, D] int64


_BOOL_FIELDS = frozenset(("avail_zc", "F", "agz", "agc", "admit",
                          "pool_types", "pool_agz", "pool_agc", "ex_compat",
                          "fuse"))


def kernel_inputs_from_numpy(arrays: dict, device) -> KernelInputs:
    """The reference's kernel inputs, as numpy arrays, on ``device``."""
    dev = _device.resolve(device)
    vals = {}
    for nm in KernelInputs._fields:
        if arrays.get(nm) is None:
            continue
        dt = torch.bool if nm in _BOOL_FIELDS else _I64
        vals[nm] = torch.from_numpy(np.array(arrays[nm])).to(device=dev,
                                                             dtype=dt)
    return KernelInputs(**vals)


#: dtype of every carry (and bank) field
CARRY_DTYPES = dict(used=_I64, types=torch.bool, zones=torch.bool,
                    ct=torch.bool, pool=torch.int32, alive=torch.bool,
                    num_nodes=torch.int32, pool_used=_I64)


def carry_from_numpy(d: dict, device) -> Carry:
    """A reference carry, as a dict of numpy arrays, on ``device``."""
    dev = _device.resolve(device)
    out = {}
    for nm, dt in CARRY_DTYPES.items():
        a = np.array(d[nm])                 # a writable, contiguous copy
        if nm == "num_nodes":
            a = a.reshape(1)
        out[nm] = torch.from_numpy(a).to(device=dev, dtype=dt)
    return Carry(**out)


def carry0(inp: KernelInputs, N: int, E: int, lanes: Optional[int] = None
           ) -> Carry:
    """The scan's initial node state: existing rows [0, E) alive with
    their used vectors, every other slot free. ``lanes=L`` stacks L such
    states (every field gains a leading lane axis; ``ex_used0`` and
    ``pool_used0`` may be per lane or shared)."""
    lead = () if lanes is None else (lanes,)
    T, D = inp.A.shape[-2:]
    Z, C = inp.agz.shape[-1], inp.agc.shape[-1]
    dev = inp.A.device
    used = torch.zeros(lead + (N, D), dtype=_I64, device=dev)
    used[..., :E, :] = inp.ex_used0
    pool = torch.full(lead + (N,), -1, dtype=torch.int32, device=dev)
    pool[..., :E] = -2
    alive = torch.zeros(lead + (N,), dtype=torch.bool, device=dev)
    alive[..., :E] = True
    pool_used = inp.pool_used0.expand(
        lead + tuple(inp.pool_used0.shape[-2:])).clone(
            memory_format=torch.contiguous_format)
    return Carry(used=used,
                 types=torch.zeros(lead + (N, T), dtype=torch.bool,
                                   device=dev),
                 zones=torch.zeros(lead + (N, Z), dtype=torch.bool,
                                   device=dev),
                 ct=torch.zeros(lead + (N, C), dtype=torch.bool, device=dev),
                 pool=pool, alive=alive,
                 num_nodes=torch.zeros(lead + (1,), dtype=torch.int32,
                                       device=dev),
                 pool_used=pool_used)


# ---------------------------------------------------------------------------
# plain versions of the K2 group step
# ---------------------------------------------------------------------------

def _headroom(A_eff: torch.Tensor, base: torch.Tensor,
              R: torch.Tensor) -> torch.Tensor:
    """[...] min_d floor((A_eff - base) / R) over dims with R > 0 (BIG
    when none), clipped to [0, BIG]; broadcasts over leading axes."""
    pos = R > 0
    Rsafe = torch.where(pos, R, torch.ones_like(R))
    q = torch.div(A_eff - base, Rsafe, rounding_mode="floor")
    q = torch.where(pos, q, torch.full_like(q, BIG))
    return q.amin(dim=-1).clamp(0, BIG)


def _pool_budget(limit: torch.Tensor, used: torch.Tensor,
                 R: torch.Tensor) -> torch.Tensor:
    """Max additional pods the pool's limits allow (BIG if unlimited)."""
    active = (limit >= 0) & (R > 0)
    Rsafe = torch.where(R > 0, R, torch.ones_like(R))
    per_dim = torch.div((limit - used).clamp(min=0), Rsafe,
                        rounding_mode="floor")
    return torch.where(active, per_dim, torch.full_like(per_dim, BIG)).amin()


def _mv_h1(hr1: torch.Tensor, pairs_t: torch.Tensor, pairs_v: torch.Tensor,
           V: int) -> torch.Tensor:
    """[..., K, V] per-value max of ``hr1`` (headroom+1 over candidates,
    0 elsewhere) by a segment max over the (type, value) pairs; the pad
    value V is a dump segment, and an empty segment reads 0."""
    K, M = pairs_t.shape
    lead = hr1.shape[:-1]
    cols = []
    for k in range(K):
        gathered = hr1[..., pairs_t[k]]                           # [..., M]
        seg = torch.zeros(lead + (V + 1,), dtype=_I64, device=hr1.device)
        idx = pairs_v[k].expand(lead + (M,))
        seg = seg.scatter_reduce(-1, idx, gathered, reduce="amax",
                                 include_self=True)
        cols.append(seg[..., :V])
    return torch.stack(cols, dim=-2)


def _mv_cap(h1: torch.Tensor, f: torch.Tensor, V: int) -> torch.Tensor:
    """[...] max take keeping, per key, at least f distinct values with
    per-value headroom >= the take: the f-th largest per-value max."""
    big = torch.full_like(f, BIG)
    if V == 0:
        capk = torch.where(f <= 0, big, torch.full_like(f, -1))
    else:
        S = torch.sort(h1, dim=-1, descending=True).values
        idx = (f - 1).clamp(0, V - 1)
        val = torch.gather(S, -1, idx.unsqueeze(-1)).squeeze(-1)
        capk = torch.where(f <= 0, big,
                           torch.where(f > V, torch.full_like(f, -1),
                                       val - 1))
    return capk.amin(dim=-1).clamp(min=0)


def _axis_max(x: torch.Tensor, comm) -> torch.Tensor:
    """The max over the type shards of a mesh (the reference's
    ``_axis_max``): ``comm.axis_max``, the identity without a mesh."""
    return x if comm is None else comm.axis_max(x)


def _slot_headroom_ref(inp: KernelInputs, carry: Carry, g: int, *, E: int,
                       P: int, V: int, comm=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-3 for group g: (cand [N, T] bool, k [N] int64). The plain
    version of the ``ffd_slot_headroom`` kernel. With ``comm`` (a type-
    sharded mesh, parallel/mesh.py) the types are the rank's shard and
    k and the minValues maxima are maxed over the shards."""
    R, F, agz, agc = inp.R[g], inp.F[g], inp.agz[g], inp.agc[g]
    N = carry.used.shape[0]
    zc = ((carry.zones & agz)[:, :, None]
          & (carry.ct & agc)[:, None, :]).reshape(N, -1)          # [N, ZC]
    off_ok = (zc[:, None, :] & inp.avail_zc[None, :, :]).any(dim=-1)
    pool = carry.pool.long()
    open_ = pool >= 0
    pool_clipped = pool.clamp(0, P - 1)
    adm_open = open_ & inp.admit[g][pool_clipped]
    cand = carry.types & F[None, :] & off_ok & adm_open[:, None]
    hr = _headroom(inp.A[None, :, :], carry.used[:, None, :], R)  # [N, T]
    k = _axis_max(torch.where(cand, hr, torch.zeros_like(hr)).amax(dim=1),
                  comm)
    if E:
        ex_ok = carry.alive[:E] & inp.ex_compat[g]
        k_ex = _headroom(inp.ex_alloc, carry.used[:E], R)
        k = torch.cat([torch.where(ex_ok, k_ex, torch.zeros_like(k_ex)),
                       k[E:]])
    if inp.mv_floor is not None:
        hr1 = torch.where(cand, hr + 1, torch.zeros_like(hr))
        h1 = _axis_max(_mv_h1(hr1, inp.mv_pairs_t, inp.mv_pairs_v, V), comm)
        f = torch.where(open_[:, None], inp.mv_floor[pool_clipped],
                        torch.zeros_like(inp.mv_floor[pool_clipped]))
        cap = _mv_cap(h1, f, V)
        k = torch.minimum(k, torch.where(open_, cap,
                                         torch.full_like(cap, BIG)))
    return cand, k


def _prefix_fill_ref(inp: KernelInputs, carry: Carry, g: int, k, *,
                     P: int):
    """Steps 4-5: the per-pool limit caps over each pool's slot prefix,
    then the greedy prefix fill of ``k`` [N]: (take [N], n_rem)."""
    R, n_rem = inp.R[g], inp.n[g]
    for pi in range(P):
        has_limit = bool((inp.pool_limit[pi] >= 0).any())
        if not has_limit:
            continue
        budget = _pool_budget(inp.pool_limit[pi], carry.pool_used[pi], R)
        rows = carry.pool == pi
        kp = torch.where(rows, k, torch.zeros_like(k))
        cum = torch.cumsum(kp, 0) - kp
        capped = torch.minimum(kp, budget - cum).clamp(min=0)
        k = torch.where(rows, capped, k)
    cum = torch.cumsum(k, 0) - k
    take = torch.minimum((n_rem - cum).clamp(min=0), k)
    return take, n_rem - take.sum()


def _fill_phase_ref(inp: KernelInputs, carry: Carry, g: int, *, E: int,
                    P: int, V: int, comm=None):
    """Steps 1-5 of one group fill, without touching the carry: returns
    (take [N], n_rem, cand [N, T])."""
    cand, k = _slot_headroom_ref(inp, carry, g, E=E, P=P, V=V, comm=comm)
    take, n_rem = _prefix_fill_ref(inp, carry, g, k, P=P)
    return take, n_rem, cand


class NewNodeTable(NamedTuple):
    """The new-node table of one group (with a leading axis, of several):
    per pool, what depends on no carry. The fused and pruned scans' wide
    launches write it; their commits read it."""
    candn: torch.Tensor              # [P, T] bool fresh-node candidates
    hrn: torch.Tensor                # [P, T] int64 their headroom, 0 elsewhere
    cap: torch.Tensor                # [P] int64 max of hrn
    cap_row: Optional[torch.Tensor]  # [P, D] int64 candidates' column max of
    #                                  A, 0-floored (the pruned scan's bound)


def _new_node_table_ref(inp: KernelInputs, g: int, *, P: int,
                        cap_row: bool = False) -> NewNodeTable:
    """The new-node table of group g over the P pools: the reference's
    ``cand_new``, ``hr`` and ``cap`` of ``_new_nodes_phase``
    (ops/ffd_jax.py:393-404, no minValues floors) and, with ``cap_row``,
    the pruned scan's ``cap_row`` (:1033). The plain version of the
    table blocks of ``ffd_pruned_probe`` / ``ffd_fused_headroom``."""
    R, F, agz, agc = inp.R[g], inp.F[g], inp.agz[g], inp.agc[g]
    agz_p = agz[None, :] & inp.pool_agz[:P]                        # [P, Z]
    agc_p = agc[None, :] & inp.pool_agc[:P]                        # [P, C]
    zc_p = (agz_p[:, :, None] & agc_p[:, None, :]).reshape(P, -1)
    off_p = (inp.avail_zc[None, :, :] & zc_p[:, None, :]).any(dim=-1)
    candn = F[None, :] & inp.pool_types[:P] & off_p                # [P, T]
    hr = _headroom(inp.A[None, :, :], inp.daemon[g][:P, None, :], R)
    hrn = torch.where(candn, hr, torch.zeros_like(hr))
    row = None
    if cap_row:
        row = torch.where(candn[:, :, None], inp.A[None, :, :],
                          torch.zeros_like(inp.A)[None]).amax(dim=1)
    return NewNodeTable(candn, hrn, hrn.amax(dim=1), row)


def _table_row(tab: NewNodeTable, i: int) -> NewNodeTable:
    """Row i of a table with a leading group axis."""
    return NewNodeTable(*[None if x is None else x[i] for x in tab])


def _new_nodes_phase_ref(inp: KernelInputs, g: int, take, used, types,
                         zones, ct, pool, alive, num_nodes, pool_used,
                         n_rem, *, E: int, P: int, V: int, cap_hint=None,
                         comm=None, slots=None, N: Optional[int] = None,
                         caps=None, table: Optional[NewNodeTable] = None):
    """Step 7 of one group fill: open new nodes pool by pool (slot
    indices are ordinal in ``num_nodes``). With ``cap_hint`` [N, D] (the
    pruned scan) each opened slot's row becomes the pool's candidate
    column max of A (0 when nothing is a candidate); it is returned last
    (None without it). A mesh rank (parallel/mesh.py) passes ``comm``
    (each pool's cap is maxed over the type shards), ``slots`` (the
    global ids of its slot rows) and the true slot count ``N``; ``caps``
    [P] gives the caps already reduced (the per-rank kernels' form).
    ``table`` (the fused and pruned scans, no minValues floors) gives
    each pool's candidates, headroom, cap and cap_hint row as the wide
    launches wrote them; without it the phase computes the table
    (``_new_node_table_ref``), then each pool's cap over the shards, the
    given ``caps`` and the minValues caps."""
    R = inp.R[g]
    agz, agc, admit, daemon = inp.agz[g], inp.agc[g], inp.admit[g], \
        inp.daemon[g]
    N = used.shape[0] if N is None else N
    slot = torch.arange(N, device=used.device) if slots is None else slots
    computed = table is None
    if computed:
        table = _new_node_table_ref(inp, g, P=P,
                                    cap_row=cap_hint is not None)
    for pi in range(P):
        agz_p = agz & inp.pool_agz[pi]
        agc_p = agc & inp.pool_agc[pi]
        cand_new, hr, cap = table.candn[pi], table.hrn[pi], table.cap[pi]
        if computed:
            cap = caps[pi] if caps is not None else _axis_max(cap, comm)
            if inp.mv_floor is not None and caps is None:
                h1n = _axis_max(_mv_h1(torch.where(cand_new, hr + 1,
                                                   torch.zeros_like(hr)),
                                       inp.mv_pairs_t, inp.mv_pairs_v, V),
                                comm)
                cap = torch.minimum(cap, _mv_cap(h1n, inp.mv_floor[pi], V))
        budget = _pool_budget(inp.pool_limit[pi], pool_used[pi], R)
        zero = torch.zeros_like(cap)
        can_place = torch.where(admit[pi] & (cap >= 1),
                                torch.minimum(n_rem, budget), zero)
        q = torch.where(can_place > 0,
                        -torch.div(-can_place, cap.clamp(min=1),
                                   rounding_mode="floor"), zero)
        free = N - E - num_nodes[0].long()
        q = torch.minimum(q, free)
        placed = torch.minimum(can_place, q * cap)
        start = E + num_nodes[0].long()
        is_new = (slot >= start) & (slot < start + q)
        offset = slot - start
        m_slot = torch.where(
            is_new, torch.where(offset == q - 1, placed - cap * (q - 1), cap),
            torch.zeros_like(slot))
        take = take + m_slot
        used = used + m_slot[:, None] * R[None, :] \
            + is_new[:, None].long() * daemon[pi][None, :]
        hr_fit = (hr[None, :] >= m_slot[:, None]) & cand_new[None, :]
        types = torch.where(is_new[:, None], hr_fit, types)
        zones = torch.where(is_new[:, None], agz_p[None, :], zones)
        ct = torch.where(is_new[:, None], agc_p[None, :], ct)
        if cap_hint is not None:
            cap_hint = torch.where(is_new[:, None],
                                   table.cap_row[pi][None, :], cap_hint)
        pool = torch.where(is_new, torch.full_like(pool, pi), pool)
        alive = alive | is_new
        num_nodes = num_nodes + q.to(torch.int32)
        pool_used = pool_used.clone()
        pool_used[pi] = pool_used[pi] + placed * R
        n_rem = n_rem - placed
    return (take, used, types, zones, ct, pool, alive, num_nodes, pool_used,
            n_rem, cap_hint)


def _group_step_ref(inp: KernelInputs, carry: Carry, g: int, *, E: int,
                    P: int, V: int, comm=None):
    """One whole group step (steps 1-7): (new carry, take [N], n_rem).
    The plain version of ``ffd_slot_headroom`` then ``ffd_group_commit``;
    with ``comm``, of a type-sharded mesh rank's step."""
    take, n_rem, cand = _fill_phase_ref(inp, carry, g, E=E, P=P, V=V,
                                        comm=comm)
    new, take, n_rem, _ = _commit_ref(inp, carry, g, take, n_rem, cand,
                                      E=E, P=P, V=V, comm=comm)
    return new, take, n_rem


def _narrow_ref(inp: KernelInputs, carry: Carry, g: int, take, cand, *,
                P: int):
    """Step 6 after the fill: used += take * R; each filled open slot's
    types narrowed to ``cand`` [N, T] and the new aggregate's fit, its
    zones and capacity types ANDed with the group's; the per-pool takes
    into pool_used. (used, types, zones, ct, pool_used); the plain version
    of the commits' narrowing (``commit_narrow``, ``narrow_groups``)."""
    R = inp.R[g]
    used = carry.used + take[:, None] * R[None, :]
    filled_open = (take > 0) & (carry.pool >= 0)
    fit_all = (used[:, None, :] <= inp.A[None, :, :]).all(dim=-1)
    types = torch.where(filled_open[:, None], cand & fit_all, carry.types)
    zones = torch.where(filled_open[:, None], carry.zones & inp.agz[g][None],
                        carry.zones)
    ct = torch.where(filled_open[:, None], carry.ct & inp.agc[g][None],
                     carry.ct)
    pool = carry.pool.long()
    seg = torch.where(pool >= 0, pool.clamp(0, P - 1),
                      torch.full_like(pool, P))
    take_by_pool = torch.zeros(P + 1, dtype=_I64, device=take.device)
    take_by_pool = take_by_pool.index_add(0, seg, take)[:P]
    pool_used = carry.pool_used + take_by_pool[:, None] * R[None, :]
    return used, types, zones, ct, pool_used


def _commit_ref(inp: KernelInputs, carry: Carry, g: int, take, n_rem, cand,
                *, E: int, P: int, V: int, cap_hint=None, comm=None,
                table: Optional[NewNodeTable] = None):
    """Steps 6-7 after the fill: the narrowing of the filled open slots
    (``_narrow_ref``), the pool accounting and the new nodes (from
    ``table`` when given, as the K2 commit reads the table its headroom
    launch wrote): (new carry, take [N], n_rem, cap_hint)."""
    used, types, zones, ct, pool_used = _narrow_ref(inp, carry, g, take,
                                                    cand, P=P)
    (take, used, types, zones, ct, pool_arr, alive, num_nodes, pool_used,
     n_rem, cap_hint) = _new_nodes_phase_ref(
        inp, g, take, used, types, zones, ct, carry.pool, carry.alive,
        carry.num_nodes, pool_used, n_rem, E=E, P=P, V=V, cap_hint=cap_hint,
        comm=comm, table=table)
    return (Carry(used=used, types=types, zones=zones, ct=ct, pool=pool_arr,
                  alive=alive, num_nodes=num_nodes, pool_used=pool_used),
            take, n_rem, cap_hint)


def _solve_scan_ref(inp: KernelInputs, n_max: int, E: int, P: int,
                    V: int = 0, comm=None):
    """Plain version of the whole scan: a Python loop over groups. With
    ``comm`` it is a rank of the type-sharded mesh (the reference's
    ``_solve`` with ``axis="tp"``): ``inp`` holds the rank's type shard
    (A, avail_zc, F, pool_types; the minValues pairs localized to it),
    the slots are replicated, and the four maxima over types (k, its
    minValues maxima h1, each pool's new-node cap and its h1n) ride
    ``comm.axis_max``."""
    G = inp.R.shape[0]
    carry = carry0(inp, E + n_max, E)
    takes, lefts = [], []
    for g in range(G):
        carry, take, n_rem = _group_step_ref(inp, carry, g, E=E, P=P, V=V,
                                             comm=comm)
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
    N = E + n_max
    dev = inp.A.device
    takes_t = torch.stack(takes) if takes else \
        torch.zeros((0, N), dtype=torch.int32, device=dev)
    left_t = torch.cat(lefts) if lefts else \
        torch.zeros(0, dtype=_I64, device=dev)
    return takes_t, left_t, carry


# ---------------------------------------------------------------------------
# plain versions of K10: the pods x types sharded scan
# ---------------------------------------------------------------------------
#
# The reference's ``_fill_phase_dp``, ``dp_group_step`` and ``_solve_dp``
# (ops/ffd_jax.py), line for line, on one rank of a ("dp", "tp") mesh
# (parallel/mesh.py ``MeshComm``): the types are the rank's tp shard, the
# slots its dp shard (global ids ``slots``), the existing tables cut to
# those slots. The ``[:E]`` updates are ``slots < E`` masks, exclusive
# prefixes are the local cumsum plus the earlier shards' totals
# (``comm.dp_before``) and totals are sums over dp (``comm.dp_sum``).
# No minValues floors (the reference's callers take the type mesh).

def _dp_prefix(x: torch.Tensor, comm) -> torch.Tensor:
    """Exclusive prefix of a dp-sharded [Nl] vector in global slot order
    (the reference's ``_dp_prefix``): local exclusive cumsum plus the
    summed totals of the earlier shards."""
    local = torch.cumsum(x, 0) - x
    return local if comm is None else local + comm.dp_before(
        x.sum().reshape(1))[0]


def _dp_sum(x: torch.Tensor, comm) -> torch.Tensor:
    """Sum over the dp shards (the reference's ``_dp_sum``)."""
    return x if comm is None else comm.dp_sum(x)


def _fill_phase_dp_ref(inp: KernelInputs, carry: Carry, g: int, comm, *,
                       P: int, E: int, slots: torch.Tensor):
    """``_fill_phase`` on a dp slot shard: (take [Nl], n_rem, cand
    [Nl, Tl])."""
    R, n_rem = inp.R[g], inp.n[g]
    # steps 1-3 over the local types; k maxed over the type shards
    cand, k = _slot_headroom_ref(inp, carry, g, E=0, P=P, V=0, comm=comm)
    is_ex = slots < E
    ex_ok = is_ex & carry.alive & inp.ex_compat[g]
    k_ex = torch.where(ex_ok, _headroom(inp.ex_alloc, carry.used, R),
                       torch.zeros_like(k))
    k = torch.where(is_ex, k_ex, k)
    # pool limit budgets: cap per-pool prefix fills
    for pi in range(P):
        has_limit = bool((inp.pool_limit[pi] >= 0).any())
        budget = _pool_budget(inp.pool_limit[pi], carry.pool_used[pi], R)
        rows = carry.pool == pi
        kp = torch.where(rows, k, torch.zeros_like(k))
        cum = _dp_prefix(kp, comm)
        capped = torch.minimum(kp, budget - cum).clamp(min=0)
        k = torch.where(rows & has_limit, capped, k)
    # greedy prefix fill
    cum = _dp_prefix(k, comm)
    take = torch.minimum((n_rem - cum).clamp(min=0), k)
    n_rem = n_rem - _dp_sum(take.sum().reshape(1), comm)[0]
    return take, n_rem, cand


def _dp_group_step_ref(inp: KernelInputs, carry: Carry, g: int, comm, *,
                       P: int, E: int, N: int, slots: torch.Tensor):
    """One step of the 2-D sharded fill (the reference's
    ``dp_group_step``): (new carry, take [Nl], n_rem)."""
    R = inp.R[g]
    take, n_rem, cand = _fill_phase_dp_ref(inp, carry, g, comm, P=P, E=E,
                                           slots=slots)
    used = carry.used + take[:, None] * R[None, :]
    filled_open = (take > 0) & (carry.pool >= 0)
    fit_all = (used[:, None, :] <= inp.A[None, :, :]).all(dim=-1)
    types = torch.where(filled_open[:, None], cand & fit_all, carry.types)
    zones = torch.where(filled_open[:, None], carry.zones & inp.agz[g][None],
                        carry.zones)
    ct = torch.where(filled_open[:, None], carry.ct & inp.agc[g][None],
                     carry.ct)
    pool = carry.pool.long()
    seg = torch.where(pool >= 0, pool.clamp(0, P - 1),
                      torch.full_like(pool, P))
    take_by_pool = torch.zeros(P + 1, dtype=_I64, device=take.device)
    take_by_pool = _dp_sum(take_by_pool.index_add(0, seg, take)[:P], comm)
    pool_used = carry.pool_used + take_by_pool[:, None] * R[None, :]
    (take, used, types, zones, ct, pool_arr, alive, num_nodes, pool_used,
     n_rem, _) = _new_nodes_phase_ref(
        inp, g, take, used, types, zones, ct, carry.pool, carry.alive,
        carry.num_nodes, pool_used, n_rem, E=E, P=P, V=0, comm=comm,
        slots=slots, N=N)
    return (Carry(used=used, types=types, zones=zones, ct=ct, pool=pool_arr,
                  alive=alive, num_nodes=num_nodes, pool_used=pool_used),
            take, n_rem)


def carry0_dp(inp: KernelInputs, slots: torch.Tensor, E: int) -> Carry:
    """A dp shard's initial state (the reference's ``_solve_dp`` carry0):
    the rows whose global id is below E are existing nodes with their
    used vectors, every other row free."""
    is_ex = slots < E
    Nl = slots.shape[0]
    T, D = inp.A.shape
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    dev = inp.A.device
    return Carry(
        used=torch.where(is_ex[:, None], inp.ex_used0,
                         torch.zeros_like(inp.ex_used0)),
        types=torch.zeros((Nl, T), dtype=torch.bool, device=dev),
        zones=torch.zeros((Nl, Z), dtype=torch.bool, device=dev),
        ct=torch.zeros((Nl, C), dtype=torch.bool, device=dev),
        pool=torch.where(is_ex, -2, -1).to(torch.int32),
        alive=is_ex.clone(),
        num_nodes=torch.zeros(1, dtype=torch.int32, device=dev),
        pool_used=inp.pool_used0.clone())


def _solve_dp_ref(inp: KernelInputs, comm, n_max: int, E: int, P: int,
                  slot0: int):
    """The 2-D sharded scan on one rank (the reference's ``_solve_dp``):
    ``inp`` is the rank's shard (types over tp; ``ex_alloc`` /
    ``ex_used0`` [Nl, D] and ``ex_compat`` [G, Nl] the rank's slot rows
    of the slot-padded tables), ``slot0`` the global id of its first
    slot. Returns (takes [G, Nl] int32, leftover [G], the shard's final
    carry)."""
    if inp.mv_floor is not None:
        raise ValueError("the 2-D mesh scan takes no minValues floors")
    Nl = inp.ex_used0.shape[0]
    slots = slot0 + torch.arange(Nl, device=inp.A.device)
    carry = carry0_dp(inp, slots, E)
    takes, lefts = [], []
    for g in range(inp.R.shape[0]):
        carry, take, n_rem = _dp_group_step_ref(inp, carry, g, comm, P=P,
                                                E=E, N=E + n_max,
                                                slots=slots)
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
    return torch.stack(takes), torch.cat(lefts), carry


# ---------------------------------------------------------------------------
# plain versions of K5: the fused block scan
# ---------------------------------------------------------------------------
#
# The reference's ``_solve_fused`` (ops/ffd_jax.py) in two parts, one per
# CUDA kernel (csrc/fused.cu):
#
# - headroom: steps 1-3 of each of the block's Fu groups, all from the
#   block-start carry (``_slot_headroom_ref`` per group), and the new-node
#   table of each (group, pool), which reads no carry
#   (``_fused_table_ref``);
# - commit: the block, its new nodes read from the table. A block whose
#   last Fu-1 ``fuse`` flags are all True (``blk_indep``; the first flag
#   is ignored) is vectorized: each group's pool caps and greedy fill
#   against the block-start state, the merge of the Fu fills (sums of
#   used and pool_used, the narrowing of each slot by the groups that
#   filled it), then the new nodes of each group in group order, each
#   from its own remaining count. Any other block runs Fu plain group
#   steps.

def block_indep(fuse: torch.Tensor, Fu: int) -> torch.Tensor:
    """[..., G/Fu] bool: the blocks that take the vectorized branch."""
    return fuse.reshape(fuse.shape[:-1] + (-1, Fu))[..., 1:].all(dim=-1)


def _fused_headroom_ref(inp: KernelInputs, carry: Carry, g0: int, Fu: int,
                        *, E: int, P: int, V: int = 0):
    """Steps 1-3 of groups [g0, g0 + Fu) from ``carry``: (cand [Fu, N, T],
    k [Fu, N]). With ``_fused_table_ref``, the plain version of
    ``ffd_fused_headroom``."""
    parts = [_slot_headroom_ref(inp, carry, g, E=E, P=P, V=V)
             for g in range(g0, g0 + Fu)]
    return (torch.stack([c for c, _ in parts]),
            torch.stack([k for _, k in parts]))


def _fused_table_ref(inp: KernelInputs, g0: int, Fu: int, *,
                     P: int) -> NewNodeTable:
    """The new-node tables of groups [g0, g0 + Fu): candn / hrn [Fu, P, T],
    cap [Fu, P], no cap_row. The table blocks of ``ffd_fused_headroom``."""
    tabs = [_new_node_table_ref(inp, g, P=P) for g in range(g0, g0 + Fu)]
    return NewNodeTable(*[torch.stack(x) for x in list(zip(*tabs))[:3]],
                        None)


def _vec_block_ref(inp: KernelInputs, carry: Carry, g0: int, Fu: int,
                   tab: NewNodeTable, *, E: int, P: int, V: int = 0):
    """The vectorized branch (the reference's ``vec_block``): (new carry,
    takes [Fu, N], n_rem [Fu])."""
    fills = [_fill_phase_ref(inp, carry, g, E=E, P=P, V=V)
             for g in range(g0, g0 + Fu)]
    take_f = torch.stack([f[0] for f in fills])                  # [Fu, N]
    cand_f = torch.stack([f[2] for f in fills])                  # [Fu, N, T]
    R = inp.R[g0:g0 + Fu]
    used = carry.used + (take_f[:, :, None] * R[:, None, :]).sum(dim=0)
    open_ = carry.pool >= 0
    filled_f = (take_f > 0) & open_[None, :]
    any_filled = filled_f.any(dim=0)
    fit_all = (used[:, None, :] <= inp.A[None, :, :]).all(dim=-1)
    cand_sel = (filled_f[:, :, None] & cand_f).any(dim=0)
    types = torch.where(any_filled[:, None], cand_sel & fit_all,
                        carry.types)
    agz_keep = torch.where(filled_f[:, :, None],
                           inp.agz[g0:g0 + Fu][:, None, :], True).all(dim=0)
    zones = torch.where(any_filled[:, None], carry.zones & agz_keep,
                        carry.zones)
    agc_keep = torch.where(filled_f[:, :, None],
                           inp.agc[g0:g0 + Fu][:, None, :], True).all(dim=0)
    ct = torch.where(any_filled[:, None], carry.ct & agc_keep, carry.ct)
    pool = carry.pool.long()
    seg = torch.where(open_, pool.clamp(0, P - 1), torch.full_like(pool, P))
    pool_used = carry.pool_used
    for i in range(Fu):
        tbp = torch.zeros(P + 1, dtype=_I64, device=take_f.device)
        tbp = tbp.index_add(0, seg, take_f[i])[:P]
        pool_used = pool_used + tbp[:, None] * R[i][None, :]
    pool_arr, alive, num_nodes = carry.pool, carry.alive, carry.num_nodes
    takes, lefts = [], []
    for i in range(Fu):
        (tk, used, types, zones, ct, pool_arr, alive, num_nodes, pool_used,
         lf, _) = _new_nodes_phase_ref(
            inp, g0 + i, take_f[i], used, types, zones, ct, pool_arr, alive,
            num_nodes, pool_used, fills[i][1], E=E, P=P, V=V,
            table=_table_row(tab, i))
        takes.append(tk)
        lefts.append(lf.reshape(1))
    return (Carry(used=used, types=types, zones=zones, ct=ct, pool=pool_arr,
                  alive=alive, num_nodes=num_nodes, pool_used=pool_used),
            torch.stack(takes), torch.cat(lefts))


def _fused_block_ref(inp: KernelInputs, carry: Carry, g0: int, Fu: int,
                     indep: bool, tab: NewNodeTable, *, E: int, P: int,
                     V: int = 0):
    """One block of Fu groups with its new-node tables ``tab``
    (``_fused_table_ref``): (new carry, takes [Fu, N] int32, n_rem
    [Fu]). The plain version of ``ffd_fused_commit``."""
    if indep:
        carry, takes, lefts = _vec_block_ref(inp, carry, g0, Fu, tab, E=E,
                                             P=P, V=V)
        return carry, takes.to(torch.int32), lefts
    takes, lefts = [], []
    for i, g in enumerate(range(g0, g0 + Fu)):
        take, n_rem, cand = _fill_phase_ref(inp, carry, g, E=E, P=P, V=V)
        carry, take, n_rem, _ = _commit_ref(inp, carry, g, take, n_rem, cand,
                                            E=E, P=P, V=V,
                                            table=_table_row(tab, i))
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
    return carry, torch.stack(takes), torch.cat(lefts)


def _solve_fused_ref(inp: KernelInputs, n_max: int, E: int, P: int,
                     Fu: int, V: int = 0):
    """Plain version of the fused block scan (the reference's
    ``_solve_fused``): (takes [G, N] int32, leftover [G], final carry).
    ``inp.fuse`` holds the flags; G is a multiple of Fu."""
    G = inp.R.shape[0]
    carry = carry0(inp, E + n_max, E)
    indep = block_indep(inp.fuse, Fu).tolist()
    takes, lefts = [], []
    for b in range(G // Fu):
        carry, tk, lf = _fused_block_ref(
            inp, carry, b * Fu, Fu, indep[b],
            _fused_table_ref(inp, b * Fu, Fu, P=P), E=E, P=P, V=V)
        takes.append(tk)
        lefts.append(lf)
    return torch.cat(takes), torch.cat(lefts), carry


# ---------------------------------------------------------------------------
# plain versions of K3: the checkpointed scan and the suffix re-solve
# ---------------------------------------------------------------------------

def bank_row(bank: Carry, j: int) -> Carry:
    """Bank row ``j`` as a working carry (a copy; num_nodes as [1])."""
    return Carry(*[f[j:j + 1].clone() if nm == "num_nodes"
                   else f[j].clone()
                   for nm, f in zip(Carry._fields, bank)])


def _bank_store_ref(bank: Carry, carry: Carry, j: int, count: int = 1
                    ) -> None:
    """Plain version of the bank stores (a chunk entry's headroom, the
    suffix's pad re-stamp in ``pack_outputs``): the carry into bank rows
    [j, j + count), every field, in place."""
    for nm, b, c in zip(Carry._fields, bank, carry):
        b[j:j + count] = c.reshape(-1) if nm == "num_nodes" else c


def _chunked_scan_ref(inp: KernelInputs, carry: Carry, s0: int, s1: int,
                      *, E: int, P: int, V: int, CK: int):
    """Scan groups [s0, s1) from ``carry`` (s1 - s0 divisible by CK),
    recording the carry entering every CK-th group of the window: the
    reference's ``_chunked_scan``. Returns (takes [s1-s0, N] int32,
    leftover [s1-s0], final carry, bank) where ``bank`` is a Carry of
    [(s1-s0)/CK, ...] stacked entry states."""
    entries, takes, lefts = [], [], []
    for g in range(s0, s1):
        if (g - s0) % CK == 0:
            entries.append(carry)
        carry, take, n_rem = _group_step_ref(inp, carry, g, E=E, P=P, V=V)
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
    bank = Carry(*[torch.stack(f) for f in zip(*entries)])
    bank = bank._replace(num_nodes=bank.num_nodes.reshape(-1))
    return torch.stack(takes), torch.cat(lefts), carry, bank


def _solve_ckpt_ref(inp: KernelInputs, n_max: int, E: int, P: int, V: int,
                    CK: int):
    """Full solve that also records the checkpoint bank; decisions are
    those of ``_solve_scan_ref`` (same steps, same order)."""
    return _chunked_scan_ref(inp, carry0(inp, E + n_max, E), 0,
                             inp.R.shape[0], E=E, P=P, V=V, CK=CK)


def _solve_suffix_ref(inp: KernelInputs, bank: Carry, n_max: int, E: int,
                      P: int, V: int, CK: int, SUF: int, GL: int):
    """Resume from bank row ``jr = GL/CK - SUF``, scan groups
    [GL - SUF*CK, GL), splice the window's entry carries over rows
    [jr, GL/CK) and re-stamp the pad chunks [GL/CK, G/CK) with the final
    carry (groups past the live bound GL are empty, so their entry
    carries equal the final carry). The bank is updated in place.
    Returns (takes [SUF*CK, N], leftover [SUF*CK], final carry, bank)."""
    G = inp.R.shape[0]
    jr = GL // CK - SUF
    takes, left, carry, mini = _chunked_scan_ref(
        inp, bank_row(bank, jr), GL - SUF * CK, GL, E=E, P=P, V=V, CK=CK)
    for b, m in zip(bank, mini):
        b[jr:jr + SUF] = m
    if G // CK > GL // CK:
        _bank_store_ref(bank, carry, GL // CK, G // CK - GL // CK)
    return takes, left, carry, bank


def _packed_inputs_ref(buf, T, D, Z, C, G, E, P, K, M, Q, F=1):
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, K, M, F, Q))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, K, M, F, Q))
    bool_flat = _unpack_bits_ref(buf[n_i64:n_i64 + nwords(n_bits)], n_bits)
    return _unpack_inputs(buf[:n_i64], bool_flat, T, D, Z, C, G, E, P, K, M,
                          F, Q)


def _as_arena(buf, device):
    if isinstance(buf, torch.Tensor) and device is None:
        dev = _device.resolve(buf.device)
    else:
        dev = _device.resolve(device)
    return torch.as_tensor(buf).to(device=dev, dtype=_I64).contiguous()


def solve_scan_packed1_ckpt(buf, *, T: int, D: int, Z: int, C: int, G: int,
                            E: int, P: int, n_max: int, K: int = 0,
                            V: int = 0, M: int = 0, Q: int = 0, CK: int = 4,
                            device=None) -> Tuple[torch.Tensor, Carry]:
    """The checkpoint-recording full solve (the reference's
    ``solve_scan_packed1_ckpt``): the packed output buffer PLUS a
    [G/CK, ...] bank of the carry entering every CK-th group, left on
    the solve's device. CUDA runs the hand-written kernels; the CPU runs
    the plain versions."""
    buf = _as_arena(buf, device)
    if buf.is_cuda:
        from .ffd_cuda import solve_scan_packed1_ckpt_cuda
        return solve_scan_packed1_ckpt_cuda(buf, T=T, D=D, Z=Z, C=C, G=G,
                                            E=E, P=P, n_max=n_max, K=K, V=V,
                                            M=M, Q=Q, CK=CK)
    inp = _packed_inputs_ref(buf, T, D, Z, C, G, E, P, K, M, Q)
    takes, leftover, carry, bank = _solve_ckpt_ref(inp, n_max, E, P, V, CK)
    return _pack_outputs_ref(takes, leftover, carry), bank


def solve_scan_suffix(buf, bank: Carry, *, T: int, D: int, Z: int, C: int,
                      G: int, E: int, P: int, n_max: int, K: int = 0,
                      V: int = 0, M: int = 0, Q: int = 0, CK: int = 4,
                      SUF: int = 1, GL: Optional[int] = None, device=None
                      ) -> Tuple[torch.Tensor, Carry]:
    """Suffix-only re-solve from the resident ``bank`` (the reference's
    ``solve_scan_suffix``): scans the SUF*CK groups below the live bound
    GL (None means G) of the same packed arena. The output buffer has
    the three-section layout with a group axis of SUF*CK covering groups
    [GL - SUF*CK, GL); the bank is spliced IN PLACE (no second bank is
    allocated) and returned. ``bank`` must lie on the arena's device."""
    buf = _as_arena(buf, device)
    GL = G if GL is None else GL
    if bank.used.device != buf.device:
        raise ValueError(f"bank on {bank.used.device}, arena on "
                         f"{buf.device}")
    if buf.is_cuda:
        from .ffd_cuda import solve_scan_suffix_cuda
        return solve_scan_suffix_cuda(buf, bank, T=T, D=D, Z=Z, C=C, G=G,
                                      E=E, P=P, n_max=n_max, K=K, V=V, M=M,
                                      Q=Q, CK=CK, SUF=SUF, GL=GL)
    inp = _packed_inputs_ref(buf, T, D, Z, C, G, E, P, K, M, Q)
    takes, leftover, carry, bank = _solve_suffix_ref(
        inp, bank, n_max, E, P, V, CK, SUF, GL)
    return _pack_outputs_ref(takes, leftover, carry), bank


def solve_scan(inp: KernelInputs, n_max: int, E: int, P: int, V: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
    """Returns (takes [G, N] int32, leftover [G] int64, final carry) on
    the inputs' device: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if inp.A.is_cuda:
        from .ffd_cuda import solve_scan_cuda
        return solve_scan_cuda(inp, n_max, E, P, V)
    return _solve_scan_ref(inp, n_max, E, P, V)


# ---------------------------------------------------------------------------
# K1: the packed arena in and out (plain versions)
# ---------------------------------------------------------------------------

def _unpack_bits_ref(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """int64 words -> flat bool [nbits], little-endian. An arithmetic
    right shift followed by ``& 1`` reads bit 63 correctly."""
    shifts = torch.arange(64, dtype=_I64, device=words.device)
    bits = (words[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:nbits].bool()


def _bits_to_words_ref(bits: torch.Tensor) -> torch.Tensor:
    """flat bool -> int64 words, little-endian; the bits of a word are
    distinct powers of two, so a wrapping int64 sum is their OR."""
    nb = bits.shape[0]
    pad = nwords(nb) * 64 - nb
    b = torch.cat([bits.reshape(-1).long(),
                   torch.zeros(pad, dtype=_I64, device=bits.device)])
    shifts = torch.arange(64, dtype=_I64, device=bits.device)
    return (b.reshape(-1, 64) << shifts[None, :]).sum(dim=1)


def _i32_to_words_ref(x: torch.Tensor) -> torch.Tensor:
    """int32 lanes -> int64 words, two lanes a word, low lane first."""
    v = x.reshape(-1).long()
    if v.shape[0] % 2:
        v = torch.cat([v, torch.zeros(1, dtype=_I64, device=v.device)])
    mask = 0xFFFFFFFF
    return (v[0::2] & mask) | ((v[1::2] & mask) << 32)


def _out_i64(leftover, carry: Carry, lanes: Optional[int] = None
             ) -> torch.Tensor:
    """The i64 section of the output buffer (a plain cat of views); with
    ``lanes=L`` every field has a leading lane axis and the section is
    [L, n]."""
    lead = () if lanes is None else (lanes,)
    return torch.cat([f.reshape(lead + (-1,)).long() for f in
                      (leftover, carry.used, carry.pool, carry.num_nodes,
                       carry.pool_used)], dim=-1)


def _out_bools(carry: Carry):
    return (carry.types.reshape(-1), carry.zones.reshape(-1),
            carry.ct.reshape(-1), carry.alive.reshape(-1))


def _pack_outputs_ref(takes, leftover, carry: Carry) -> torch.Tensor:
    """[i64 section | int32-pair takes | bitpacked types/zones/ct/alive]:
    the device half of hostpack.out_layout's three-section contract."""
    return torch.cat([_out_i64(leftover, carry), _i32_to_words_ref(takes),
                      _bits_to_words_ref(torch.cat(_out_bools(carry)))])


def _unpack_inputs(buf_i64: torch.Tensor, bool_flat: torch.Tensor,
                   T, D, Z, C, G, E, P, K=0, M=0, F=1, Q=0) -> KernelInputs:
    """Views of the arena by the hostpack layouts, the ``fuse`` flags
    included when F > 1. The Q>0 priority section is dropped: decisions
    never read it (canonical group order already encodes priority)."""
    vals = split(buf_i64, in_layout_i64(T, D, Z, C, G, E, P, K, M, F, Q))
    vals.update(split(bool_flat, in_layout_bool(T, D, Z, C, G, E, P, K, M,
                                                F, Q)))
    if K == 0:
        for nm in ("mv_floor", "mv_pairs_t", "mv_pairs_v"):
            vals.pop(nm, None)
    vals.pop("prio", None)
    return KernelInputs(**vals)


def _check_fuse(F: int, G: int, K: int) -> None:
    """A fused arena (F > 1): G a multiple of F and no minValues floors
    (the solver packs F = 1 when K > 0)."""
    if F < 1 or G % F:
        raise ValueError(f"fusion width F={F} does not divide G={G}")
    if F > 1 and K:
        raise ValueError(f"a fused arena (F={F}) carries no minValues "
                         f"floors; got K={K}")


def solve_scan_packed1(buf, *, T: int, D: int, Z: int, C: int, G: int,
                       E: int, P: int, n_max: int, K: int = 0, V: int = 0,
                       M: int = 0, F: int = 1, Q: int = 0,
                       device=None) -> torch.Tensor:
    """One int64 arena in, one int64 output buffer out (the reference's
    ``solve_scan_packed1``; F > 1 is the fused block scan, K5). ``buf``
    is a numpy array or a tensor; it runs on ``device`` (default: the
    tensor's device, else cuda). CUDA runs the hand-written kernels; the
    CPU runs the plain versions."""
    _check_fuse(F, G, K)
    buf = _as_arena(buf, device)
    if buf.is_cuda:
        if F > 1:
            from .ffd_cuda import solve_scan_packed1_fused_cuda
            return solve_scan_packed1_fused_cuda(
                buf, T=T, D=D, Z=Z, C=C, G=G, E=E, P=P, n_max=n_max, Q=Q,
                F=F)
        from .ffd_cuda import solve_scan_packed1_cuda
        return solve_scan_packed1_cuda(buf, T=T, D=D, Z=Z, C=C, G=G, E=E,
                                       P=P, n_max=n_max, K=K, V=V, M=M, Q=Q)
    inp = _packed_inputs_ref(buf, T, D, Z, C, G, E, P, K, M, Q, F)
    if F > 1:
        takes, leftover, carry = _solve_fused_ref(inp, n_max, E, P, F)
    else:
        takes, leftover, carry = _solve_scan_ref(inp, n_max, E, P, V)
    return _pack_outputs_ref(takes, leftover, carry)


# ---------------------------------------------------------------------------
# K4: B packed solves of one statics bucket in one dispatch
# ---------------------------------------------------------------------------

def _as_arenas(bufs, device):
    """A [B, W] stack of arenas (numpy or tensor) as one int64 tensor."""
    t = _as_arena(bufs, device)
    if t.dim() != 2:
        raise ValueError(f"expected a [B, W] stack of arenas, got shape "
                         f"{tuple(t.shape)}")
    return t


def split_lanes(buf2d: torch.Tensor, layout) -> dict:
    """``hostpack.split`` along the last axis of a [B, W] stack: every
    field a [B, ...] view whose lanes are ``buf2d.stride(0)`` apart."""
    vals = {}
    off = 0
    for nm, shp in layout:
        sz = 1
        for s in shp:
            sz *= s
        vals[nm] = buf2d[:, off:off + sz].reshape((buf2d.shape[0],)
                                                  + tuple(shp))
        off += sz
    return vals


def _unpack_inputs_lanes(bufs_i64: torch.Tensor, bools: torch.Tensor,
                         T, D, Z, C, G, E, P, K=0, M=0, Q=0,
                         F=1) -> KernelInputs:
    """``_unpack_inputs`` over a lane axis: [B, ...] views of the i64
    rows of a [B, W] stack and of the [B, nbits] bool planes."""
    vals = split_lanes(bufs_i64, in_layout_i64(T, D, Z, C, G, E, P, K, M,
                                               F, Q))
    vals.update(split_lanes(bools, in_layout_bool(T, D, Z, C, G, E, P, K, M,
                                                  F, Q)))
    if K == 0:
        for nm in ("mv_floor", "mv_pairs_t", "mv_pairs_v"):
            vals.pop(nm, None)
    vals.pop("prio", None)
    return KernelInputs(**vals)


def solve_scan_packed1_many(bufs, *, T: int, D: int, Z: int, C: int, G: int,
                            E: int, P: int, n_max: int, K: int = 0,
                            V: int = 0, M: int = 0, F: int = 1, Q: int = 0,
                            device=None) -> torch.Tensor:
    """B packed solves of one statics bucket in one dispatch (the
    reference's ``solve_scan_packed1_many``, a vmap of the packed body):
    a [B, W] stack of arenas in, a [B, Wout] stack of output buffers
    out, row b the output of ``solve_scan_packed1`` on arena b. CUDA
    runs one lane-axis unpack, 2*G lane-axis scan launches (2*G/F at
    F > 1, each lane taking its own branch per block) and one lane-axis
    pack whatever B is; the CPU runs the plain packed solve lane by
    lane."""
    _check_fuse(F, G, K)
    bufs = _as_arenas(bufs, device)
    st = dict(T=T, D=D, Z=Z, C=C, G=G, E=E, P=P, n_max=n_max, K=K, V=V,
              M=M, F=F, Q=Q)
    if bufs.is_cuda:
        from .ffd_cuda import solve_scan_packed1_many_cuda
        return solve_scan_packed1_many_cuda(bufs, **st)
    return torch.stack([solve_scan_packed1(b, **st) for b in bufs])


# ---------------------------------------------------------------------------
# K6: the pruned scan (the G-axis kernel), plain versions and dispatch
# ---------------------------------------------------------------------------
#
# The reference's ``pruned_group_step`` (ops/ffd_jax.py) in three parts;
# select and headroom (with the table) are the probe kernel's
# (``_pruned_probe_ref``), commit the commit kernel's (csrc/pruned.cu):
#
# - select: the bound pass over each slot's stale-high ``cap_hint``
#   (k_bound = min_d floor((cap_hint - used) / R), BIG where R = 0), the
#   compatibility screen (types & F, zones & agz, ct & agc each any), the
#   count n_pos of bound-positive compatible open slots (existing rows
#   excluded) and the first S of them in slot order. Only valid rows are
#   selected: the reference's argsort pads its selection with
#   non-candidate rows, whose k it sets to 0, which it never narrows,
#   and whose existing-row k it overwrites afterwards, so they change no
#   output.
# - headroom: the exact candidate row and headroom of each selected slot.
#   With it, the group's new-node table over the pools
#   (``_new_node_table_ref`` with ``cap_row``), which reads no carry.
# - commit: k of the selected rows, then of the existing rows; the base
#   step's pool caps, greedy fill, narrowing (only selected slots can
#   take) and new nodes read from the table, each opened slot's cap_hint
#   row the pool's candidate column max of A; the sticky bail flag when
#   pods remain after the fill while more than S slots were
#   bound-positive.

class CarryP(NamedTuple):
    """The pruned scan's carry: ``Carry``'s fields plus the bound."""
    used: torch.Tensor       # [N, D] int64
    types: torch.Tensor      # [N, T] bool
    zones: torch.Tensor      # [N, Z] bool
    ct: torch.Tensor         # [N, C] bool
    pool: torch.Tensor       # [N] int32 (-1 free, -2 existing)
    alive: torch.Tensor      # [N] bool
    num_nodes: torch.Tensor  # [1] int32
    pool_used: torch.Tensor  # [P, D] int64
    cap_hint: torch.Tensor   # [N, D] int64 stale-high capacity bound
    bail: torch.Tensor       # [1] bool: the pruning was insufficient


def carry0_pruned(inp: KernelInputs, N: int, E: int,
                  lanes: Optional[int] = None) -> CarryP:
    """``carry0`` plus the bound: existing rows hold their allocatable,
    every other row 0; no bail."""
    base = carry0(inp, N, E, lanes=lanes)
    lead = () if lanes is None else (lanes,)
    D = inp.A.shape[-1]
    cap_hint = torch.zeros(lead + (N, D), dtype=_I64, device=inp.A.device)
    cap_hint[..., :E, :] = inp.ex_alloc
    bail = torch.zeros(lead + (1,), dtype=torch.bool, device=inp.A.device)
    return CarryP(*base, cap_hint=cap_hint, bail=bail)


def _pruned_select_ref(inp: KernelInputs, carry: CarryP, g: int, *, E: int,
                       P: int, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The select part: (sel [S] int32, the first min(n_pos, S)
    bound-positive compatible open slots in slot order and -1 past them;
    cnt [2] int32, (n_sel, n_pos))."""
    R, F, agz, agc = inp.R[g], inp.F[g], inp.agz[g], inp.agc[g]
    pool = carry.pool.long()
    adm_open = (pool >= 0) & inp.admit[g][pool.clamp(0, P - 1)]
    pos = R > 0
    Rsafe = torch.where(pos, R, torch.ones_like(R))
    qb = torch.div(carry.cap_hint - carry.used, Rsafe, rounding_mode="floor")
    qb = torch.where(pos, qb, torch.full_like(qb, BIG))
    k_bound = qb.amin(dim=-1).clamp(0, BIG)
    compat = ((carry.types & F).any(dim=1) & (carry.zones & agz).any(dim=1)
              & (carry.ct & agc).any(dim=1))
    open_cand = adm_open & (k_bound > 0) & carry.alive & compat
    open_cand[:E] = False
    idx = torch.nonzero(open_cand).reshape(-1)
    n_pos = idx.numel()
    n_sel = min(n_pos, S)
    sel = torch.full((S,), -1, dtype=torch.int32, device=idx.device)
    sel[:n_sel] = idx[:n_sel].to(torch.int32)
    cnt = torch.tensor([n_sel, n_pos], dtype=torch.int32, device=idx.device)
    return sel, cnt


def _pruned_headroom_ref(inp: KernelInputs, carry: CarryP, g: int,
                         sel: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The headroom part: (cand_s [S, T] bool, k_s [S] int64) of the
    selected rows, all False / 0 on rows past n_sel."""
    R, F, agz, agc = inp.R[g], inp.F[g], inp.agz[g], inp.agc[g]
    S = sel.shape[0]
    valid = sel >= 0
    rows = sel.clamp(min=0).long()
    zc = ((carry.zones[rows] & agz)[:, :, None]
          & (carry.ct[rows] & agc)[:, None, :]).reshape(S, -1)
    off_ok = (zc[:, None, :] & inp.avail_zc[None, :, :]).any(dim=-1)
    cand_s = carry.types[rows] & F[None, :] & off_ok & valid[:, None]
    hr_s = _headroom(inp.A[None, :, :], carry.used[rows][:, None, :], R)
    k_s = torch.where(cand_s, hr_s, torch.zeros_like(hr_s)).amax(dim=1)
    return cand_s, k_s


def _pruned_probe_ref(inp: KernelInputs, carry: CarryP, g: int, *, E: int,
                      P: int, S: int):
    """The probe part, what ``ffd_pruned_probe`` writes: the select part,
    then the headroom part of its selection, then the group's new-node
    table: (sel [S], cnt [2], cand_s [S, T], k_s [S], the table)."""
    sel, cnt = _pruned_select_ref(inp, carry, g, E=E, P=P, S=S)
    cand_s, k_s = _pruned_headroom_ref(inp, carry, g, sel)
    return (sel, cnt, cand_s, k_s,
            _new_node_table_ref(inp, g, P=P, cap_row=True))


def _pruned_commit_ref(inp: KernelInputs, carry: CarryP, g: int,
                       sel: torch.Tensor, cnt: torch.Tensor,
                       cand_s: torch.Tensor, k_s: torch.Tensor,
                       tab: NewNodeTable, *, E: int, P: int, S: int):
    """The commit part, its new nodes read from the group's table ``tab``
    (``_new_node_table_ref`` with ``cap_row``): (new CarryP, take [N],
    n_rem)."""
    N, T = carry.types.shape
    R = inp.R[g]
    rows = sel[sel >= 0].long()
    n_sel = rows.numel()
    k = torch.zeros(N, dtype=_I64, device=carry.used.device)
    k[rows] = k_s[:n_sel]
    if E:
        ex_ok = carry.alive[:E] & inp.ex_compat[g]
        k_ex = _headroom(inp.ex_alloc, carry.used[:E], R)
        k[:E] = torch.where(ex_ok, k_ex, torch.zeros_like(k_ex))
    cand = torch.zeros((N, T), dtype=torch.bool, device=k.device)
    cand[rows] = cand_s[:n_sel]
    base = Carry(*carry[:8])
    take, n_rem = _prefix_fill_ref(inp, base, g, k, P=P)
    bail = carry.bail | ((cnt[1] > S) & (n_rem > 0))
    # cap_hint stays stale-high for narrowed slots (the host discipline)
    new, take, n_rem, cap_hint = _commit_ref(inp, base, g, take, n_rem,
                                             cand, E=E, P=P, V=0,
                                             cap_hint=carry.cap_hint,
                                             table=tab)
    return CarryP(*new, cap_hint=cap_hint, bail=bail), take, n_rem


def _pruned_group_step_ref(inp: KernelInputs, carry: CarryP, g: int, *,
                           E: int, P: int, S: int):
    """One pruned group step (the reference's ``pruned_group_step``):
    (new CarryP, take [N], n_rem)."""
    return _pruned_commit_ref(inp, carry, g, *_pruned_probe_ref(
        inp, carry, g, E=E, P=P, S=S), E=E, P=P, S=S)


def _solve_pruned_ref(inp: KernelInputs, n_max: int, E: int, P: int,
                      S: int):
    """Plain version of the whole pruned scan: (takes [G, N] int32,
    leftover [G], final CarryP). The selection never exceeds the slot
    count: S = min(S, N), and S == N selects every slot (exact, no
    bail)."""
    N = E + n_max
    S = min(S, N)
    carry = carry0_pruned(inp, N, E)
    takes, lefts = [], []
    for g in range(inp.R.shape[0]):
        carry, take, n_rem = _pruned_group_step_ref(inp, carry, g, E=E, P=P,
                                                    S=S)
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
    return torch.stack(takes), torch.cat(lefts), carry


def _pack_pruned_outputs_ref(takes, leftover, carry: CarryP) -> torch.Tensor:
    """The base output buffer plus one trailing int64: the bail word."""
    return torch.cat([_pack_outputs_ref(takes, leftover, Carry(*carry[:8])),
                      carry.bail.reshape(1).long()])


def solve_scan_packed1_pruned(buf, *, T: int, D: int, Z: int, C: int,
                              G: int, E: int, P: int, n_max: int,
                              S: int = DEV_PRUNED_SLOTS,
                              device=None) -> torch.Tensor:
    """The pruned G-axis scan behind the base kernel's single-buffer
    wire (the reference's ``solve_scan_packed1_pruned``): the packed
    outputs plus ONE trailing int64, the bail word (1: the pruning was
    insufficient; the caller discards the output and re-solves with
    S = N, which selects every slot and cannot bail). The arena is the
    K = M = 0, Q = 0 layout (no minValues floors, no priority section).
    The one-lane call of ``solve_scan_packed1_pruned_many``."""
    buf = _as_arena(buf, device)
    return solve_scan_packed1_pruned_many(
        buf[None], T=T, D=D, Z=Z, C=C, G=G, E=E, P=P, n_max=n_max, S=S)[0]


def solve_scan_packed1_pruned_many(bufs, *, T: int, D: int, Z: int, C: int,
                                   G: int, E: int, P: int, n_max: int,
                                   S: int = DEV_PRUNED_SLOTS,
                                   device=None) -> torch.Tensor:
    """B pruned solves of one statics bucket in one dispatch (the
    reference's ``solve_scan_packed1_pruned_many``): [B, W] in, [B,
    Wout + 1] out, each lane with its OWN trailing bail word. CUDA runs
    the hand-written kernels (two lane-axis launches per group step);
    the CPU runs the plain versions lane by lane."""
    bufs = _as_arenas(bufs, device)
    S = min(S, E + n_max)
    if bufs.is_cuda:
        from .ffd_cuda import solve_scan_packed1_pruned_many_cuda
        return solve_scan_packed1_pruned_many_cuda(
            bufs, T=T, D=D, Z=Z, C=C, G=G, E=E, P=P, n_max=n_max, S=S)
    return torch.stack([
        _pack_pruned_outputs_ref(*_solve_pruned_ref(
            _packed_inputs_ref(b, T, D, Z, C, G, E, P, 0, 0, 0), n_max, E,
            P, S))
        for b in bufs])
