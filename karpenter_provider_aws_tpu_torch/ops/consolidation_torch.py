"""Consolidation's batched search (K7): plain PyTorch versions and the
dispatch.

The port of the reference package's ``ops/consolidation_jax.py``:

- ``deletions_feasible`` (its ``deletions_feasible_kernel``): per lane
  (one deletion candidate), a scan over the lane's pod groups; each
  group fills the surviving existing nodes by a greedy prefix in name
  order. Feasible iff every group's leftover is 0. The node and
  signature tables are shared; a lane carries only index vectors
  (``gid``, ``cid``, ``n``, ``alive``).
- ``replacements_prescreen`` (``replacements_prescreen_kernel``): the
  same absorption scan, then the one-new-node relaxation: some admitted,
  strictly cheaper type holds the aggregate leftover. False is proof
  the replacement simulate fails.
- ``deletions_feasible_dense`` (``deletions_feasible_dense``): the
  absorption scan on per-lane tables (heterogeneous batches).
- ``subset_solve`` (``subset_solve_kernel``): per lane, the whole FFD
  scan (K2) on a gathered, masked view of one union arena, summarised
  as the ``SUBSET_OUT_COLS`` row.

All arithmetic is int64 and wraps like the reference's: the exclusive
prefix ``cumsum(k) - k`` reaches past 2**63 when a group's request row is
all zero (k = BIG = 1 << 60 on every node), and the decisions follow
the wrapped values. Every function is written with operations that run
on the CPU and on CUDA alike (floor division through ``torch.div``, no
integer matmul).

The public functions dispatch on the tensors' device: the plain versions
below for CPU tensors, the CUDA kernels of ``ops/consolidation_cuda.py``
(``consol_absorb``, ``subset_gather``, the K2 kernels on their lane axis,
whose last commit writes the summary rows) for CUDA tensors. Nothing
falls back from one to the other.
"""

from __future__ import annotations

import torch

from .ffd_torch import BIG, KernelInputs, _solve_scan_ref

_I64 = torch.int64

#: subset_solve summary columns, one row per lane
SUBSET_OUT_COLS = ("leftover", "num_nodes", "flex", "min_price", "savings")

#: KernelInputs fields that a subset lane gathers for itself; the rest
#: (catalog allocatable, pool tables) every lane shares
LANE_FIELDS = ("avail_zc", "R", "n", "F", "agz", "agc", "admit", "daemon",
               "ex_alloc", "ex_used0", "ex_compat")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _absorb_scan(ex_alloc: torch.Tensor, used: torch.Tensor,
                 compat: torch.Tensor, R: torch.Tensor,
                 n: torch.Tensor) -> torch.Tensor:
    """The absorption scan of every lane: ex_alloc [B or 1, E, D], used
    [B, E, D] (the entry carry), compat [B, G, E] bool (compatible and
    alive), R [B, G, D], n [B, G]. Returns leftover [B, G]."""
    lefts = []
    for g in range(R.shape[1]):
        Rg = R[:, g]                                           # [B, D]
        pos = Rg > 0
        Rsafe = torch.where(pos, Rg, torch.ones_like(Rg))
        q = torch.div(ex_alloc - used, Rsafe[:, None, :],
                      rounding_mode="floor")                   # [B, E, D]
        q = torch.where(pos[:, None, :], q, torch.full_like(q, BIG))
        k = q.amin(dim=-1).clamp(0, BIG)                       # [B, E]
        k = torch.where(compat[:, g], k, torch.zeros_like(k))
        cum = torch.cumsum(k, dim=1) - k
        take = torch.minimum((n[:, g:g + 1] - cum).clamp(min=0), k)
        used = used + take[:, :, None] * Rg[:, None, :]
        lefts.append(n[:, g] - take.sum(dim=1))
    if not lefts:   # no group: the reference's scan of none, [B, 0]
        return n.new_zeros((n.shape[0], 0))
    return torch.stack(lefts, dim=1)


def _shared_leftover(ex_alloc, ex_used0, compat_tab, R_tab, gid, cid, n,
                     alive) -> torch.Tensor:
    B = gid.shape[0]
    compat = compat_tab[cid.long()] & alive[:, None, :]
    used = ex_used0[None].expand((B,) + tuple(ex_used0.shape))
    return _absorb_scan(ex_alloc[None], used, compat, R_tab[gid.long()], n)


def _deletions_feasible_ref(ex_alloc, ex_used0, compat_tab, R_tab, gid, cid,
                            n, alive) -> torch.Tensor:
    """[B] bool: every pod of the lane absorbed by its surviving nodes."""
    left = _shared_leftover(ex_alloc, ex_used0, compat_tab, R_tab, gid, cid,
                            n, alive)
    return (left == 0).all(dim=1)


def _replacements_prescreen_ref(ex_alloc, ex_used0, compat_tab, R_tab,
                                type_alloc, type_price, tcompat, padmit,
                                pool_types, gid, cid, n, alive,
                                price_cap) -> torch.Tensor:
    """[B] bool: False iff no admitted type under the lane's price cap
    holds the aggregate leftover of the absorption scan."""
    left = _shared_leftover(ex_alloc, ex_used0, compat_tab, R_tab, gid, cid,
                            n, alive)                           # [B, G]
    c = cid.long()
    active = left > 0
    agg = (left[:, :, None] * R_tab[gid.long()]).sum(dim=1)    # [B, D]
    g_ok = (tcompat[c] | ~active[:, :, None]).all(dim=1)       # [B, T]
    pad = padmit[:, c].permute(1, 2, 0)                        # [B, G, P]
    p_ok = (pad | ~active[:, :, None]).all(dim=1)              # [B, P]
    from_pools = (p_ok[:, :, None] & pool_types[None]).any(dim=1)
    fits = (agg[:, None, :] <= type_alloc[None]).all(dim=-1)   # [B, T]
    priced = type_price[None, :] < price_cap[:, None]
    ok = (g_ok & from_pools & fits & priced).any(dim=1)
    return ok | ~active.any(dim=1)


def _deletions_feasible_dense_ref(ex_alloc, ex_used0, ex_compat, R,
                                  n) -> torch.Tensor:
    """[B] bool on per-lane tables."""
    return (_absorb_scan(ex_alloc, ex_used0, ex_compat, R, n) == 0).all(
        dim=1)


def _subset_gather_ref(arena: KernelInputs, gid, n, dead,
                       keep) -> KernelInputs:
    """Every lane's KernelInputs from the union arena, lane-major (the
    ``LANE_FIELDS`` gain a leading lane axis; the rest stay shared):
    the lane's group rows, its price-capped types (``keep``) and its
    deleted node rows (``dead``) masked out."""
    g = gid.long()
    zero = torch.zeros((), dtype=_I64, device=arena.A.device)
    return arena._replace(
        avail_zc=arena.avail_zc[None] & keep[:, :, None],
        R=arena.R[g], n=n, F=arena.F[g] & keep[:, None, :],
        agz=arena.agz[g], agc=arena.agc[g], admit=arena.admit[g],
        daemon=arena.daemon[g],
        ex_alloc=torch.where(dead[:, :, None], zero, arena.ex_alloc[None]),
        ex_used0=torch.where(dead[:, :, None], zero, arena.ex_used0[None]),
        ex_compat=arena.ex_compat[g] & ~dead[:, None, :])


def lane_inputs(lanes: KernelInputs, b: int) -> KernelInputs:
    """Lane ``b`` of lane-stacked inputs, as the inputs of one solve."""
    return lanes._replace(**{f: getattr(lanes, f)[b] for f in LANE_FIELDS})


def _subset_summary_ref(leftover, num_nodes, types, keep, tprice,
                        removed_price, E: int) -> torch.Tensor:
    """[B, 5] int64 rows of SUBSET_OUT_COLS from the lanes' leftover
    [B, Gq], num_nodes [B, 1] and types [B, N, T]; ``E`` is the padded
    count of existing rows, so slot E is the first new node."""
    nn = num_nodes.reshape(-1).long()
    t0 = types[:, E] & keep
    minted = nn > 0
    zero = torch.zeros_like(nn)
    flex = torch.where(minted, t0.sum(dim=1), zero)
    big = torch.full_like(t0, BIG, dtype=_I64)
    min_price = torch.where(
        minted, torch.where(t0, tprice[None, :], big).amin(dim=1), zero)
    savings = removed_price - torch.where(nn == 1, min_price, zero)
    return torch.stack([leftover.sum(dim=1), nn, flex, min_price, savings],
                       dim=1)


def _subset_solve_ref(arena: KernelInputs, tprice, gid, n, dead, keep,
                      removed_price, *, n_max: int, E: int,
                      P: int) -> torch.Tensor:
    """[B, 5]: per lane, the gather, the whole scan (``_solve_scan_ref``)
    and the summary."""
    lanes = _subset_gather_ref(arena, gid, n, dead, keep)
    lefts, finals = [], []
    for b in range(lanes.R.shape[0]):
        _, left, final = _solve_scan_ref(lane_inputs(lanes, b), n_max, E, P)
        lefts.append(left)
        finals.append(final)
    return _subset_summary_ref(
        torch.stack(lefts), torch.stack([f.num_nodes for f in finals]),
        torch.stack([f.types for f in finals]), keep, tprice, removed_price,
        E)


# ---------------------------------------------------------------------------
# dispatch: plain versions for CPU tensors, kernels for CUDA tensors
# ---------------------------------------------------------------------------

def deletions_feasible(ex_alloc, ex_used0, compat_tab, R_tab, gid, cid, n,
                       alive) -> torch.Tensor:
    """ex_alloc/ex_used0 [E, D] int64, compat_tab [Sc, E] bool, R_tab
    [S, D] int64, gid/cid [B, G] int32, n [B, G] int64, alive [B, E]
    bool -> [B] bool, on the tensors' device."""
    if ex_alloc.is_cuda:
        from .consolidation_cuda import consol_absorb
        return consol_absorb("deletions", ex_alloc=ex_alloc,
                             ex_used0=ex_used0, compat=compat_tab, R=R_tab,
                             n=n, gid=gid, cid=cid, alive=alive)
    return _deletions_feasible_ref(ex_alloc, ex_used0, compat_tab, R_tab,
                                   gid, cid, n, alive)


def replacements_prescreen(ex_alloc, ex_used0, compat_tab, R_tab,
                           type_alloc, type_price, tcompat, padmit,
                           pool_types, gid, cid, n, alive,
                           price_cap) -> torch.Tensor:
    """The deletion inputs plus type_alloc [T, D], type_price [T],
    tcompat [Sc, T], padmit [P, Sc], pool_types [P, T] and price_cap [B]
    -> [B] bool (False: no one-new-node replacement exists)."""
    if ex_alloc.is_cuda:
        from .consolidation_cuda import consol_absorb
        return consol_absorb("prescreen", ex_alloc=ex_alloc,
                             ex_used0=ex_used0, compat=compat_tab, R=R_tab,
                             n=n, gid=gid, cid=cid, alive=alive,
                             type_alloc=type_alloc, type_price=type_price,
                             tcompat=tcompat, padmit=padmit,
                             pool_types=pool_types, price_cap=price_cap)
    return _replacements_prescreen_ref(ex_alloc, ex_used0, compat_tab, R_tab,
                                       type_alloc, type_price, tcompat,
                                       padmit, pool_types, gid, cid, n, alive,
                                       price_cap)


def deletions_feasible_dense(ex_alloc, ex_used0, ex_compat, R,
                             n) -> torch.Tensor:
    """ex_alloc/ex_used0 [B, E, D], ex_compat [B, G, E], R [B, G, D],
    n [B, G] -> [B] bool."""
    if ex_alloc.is_cuda:
        from .consolidation_cuda import consol_absorb
        return consol_absorb("dense", ex_alloc=ex_alloc, ex_used0=ex_used0,
                             compat=ex_compat, R=R, n=n)
    return _deletions_feasible_dense_ref(ex_alloc, ex_used0, ex_compat, R, n)


def subset_solve(arena: KernelInputs, tprice, gid, n, dead, keep,
                 removed_price, *, n_max: int, E: int,
                 P: int) -> torch.Tensor:
    """Whole-fleet replacement search: ``arena`` is one padded union
    arena (KernelInputs, no minValues), tprice [T] int64 (BIG for types
    without an offering), and per lane gid [B, Gq] int32 union group
    rows, n [B, Gq] int64 (0 pads), dead [B, E] bool, keep [B, T] bool,
    removed_price [B] int64. Returns [B, 5] int64 (SUBSET_OUT_COLS)."""
    if arena.A.is_cuda:
        from .consolidation_cuda import subset_solve_cuda
        return subset_solve_cuda(arena, tprice, gid, n, dead, keep,
                                 removed_price, n_max=n_max, E=E, P=P)
    return _subset_solve_ref(arena, tprice, gid, n, dead, keep,
                             removed_price, n_max=n_max, E=E, P=P)
