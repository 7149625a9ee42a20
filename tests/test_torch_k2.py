"""The base group step (K2) as its redesigned kernels compute it, held
against the reference package on the CPU.

The headroom launch (csrc/ffd_scan.cu ``ffd_slot_headroom``) writes, with
no minValues floors, each lane's new-node table beside the candidate
rows; the commit (``ffd_group_commit``) reads it, narrows the filled
open slots on a cluster of CTAs and opens new nodes. Here:

- the plain table (``ffd_torch._new_node_table_ref``, what the headroom
  launch must write) against the reference's ``cand_new``, ``hr`` and
  ``cap`` of ``_new_nodes_phase`` (ops/ffd_jax.py:393-404) on every arena
  case without floors, and on every consolidation hazard's subset lanes,
  whose ``keep`` masks give each lane its own table;
- the scan whose steps read that table (``_commit_ref(table=...)``)
  against the reference's ``solve_scan``;
- a plain model of the commit's narrowing (each CTA's slot pass over its
  chunk compacts its filled open slots; after a cluster barrier the
  cluster's takers are dealt round-robin to the CTAs, each taking one
  pass over its takers' cells) against ``_narrow_ref`` and, through the
  whole scan, the reference, where filled slots straddle CTA chunks, N is
  not a multiple of the chunk, and a step fills no slot.

Tolerance: exact (int64 and bool).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_arrays
from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


K0_CASES = [c for c in examples.CASES if c != "min_values"]


def _case(name, **kw):
    return examples.example_case(name, base=_example_arrays, **kw)


def _jax_inputs(arrays):
    return ffd_jax.KernelInputs(**{k: jnp.asarray(arrays[k]) for k in
                                   ffd_jax.KernelInputs._fields
                                   if k in arrays})


def _jax_table(arrays, g: int, P: int):
    """The reference's per-pool ``cand_new``, ``hr`` and ``cap`` of group
    g, as ops/ffd_jax.py:393-404 compute them."""
    inp = _jax_inputs(arrays)
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    R, F, agz, agc = inp.R[g], inp.F[g], inp.agz[g], inp.agc[g]
    out = []
    for pi in range(P):
        zc_p = ((agz & inp.pool_agz[pi])[:, None]
                & (agc & inp.pool_agc[pi])[None, :]).reshape(Z * C)
        cand_new = F & inp.pool_types[pi] & (inp.avail_zc
                                             & zc_p[None, :]).any(axis=1)
        hr = jnp.where(cand_new, ffd_jax._headroom_vec(
            inp.A, inp.daemon[g][pi][None, :], R), 0)
        out.append((np.asarray(cand_new), np.asarray(hr),
                    np.asarray(hr.max())))
    return [np.stack(x) for x in zip(*out)]


def _assert_table(arrays, inp, g, P, what):
    tab = ft._new_node_table_ref(inp, g, P=P)
    for got, want, nm in zip(tab[:3], _jax_table(arrays, g, P),
                             ("candn", "hrn", "cap")):
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{what} g={g} {nm}")
    return tab


def _assert_scan(arrays, st, takes, lefts, carry):
    ref = _jax_inputs(arrays)
    t1, l1, c1 = ffd_jax.solve_scan(ref, n_max=st["n_max"], E=st["E"],
                                    P=st["P"], V=st["V"])
    np.testing.assert_array_equal(torch.stack(takes).numpy(), np.asarray(t1))
    np.testing.assert_array_equal(torch.stack(lefts).numpy(),
                                  np.asarray(l1))
    for f in ft.Carry._fields:
        np.testing.assert_array_equal(
            getattr(carry, f).numpy().reshape(-1),
            np.asarray(getattr(c1, f)).reshape(-1), err_msg=f)


@pytest.mark.parametrize("case", K0_CASES)
def test_table_and_table_step_match_reference(case):
    """Every group's table against the reference's; the scan whose
    commits read the tables equals the reference's scan."""
    arrays, st = _case(case)
    E, P, V = st["E"], st["P"], st["V"]
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    carry = ft.carry0(inp, E + st["n_max"], E)
    takes, lefts = [], []
    for g in range(st["G"]):
        tab = _assert_table(arrays, inp, g, P, case)
        take, n_rem, cand = ft._fill_phase_ref(inp, carry, g, E=E, P=P, V=V)
        carry, take, n_rem, _ = ft._commit_ref(inp, carry, g, take, n_rem,
                                               cand, E=E, P=P, V=V,
                                               table=tab)
        takes.append(take.to(torch.int32))
        lefts.append(n_rem)
    _assert_scan(arrays, st, takes, lefts, carry)


@pytest.mark.parametrize("hazard", examples.SUBSET_HAZARDS)
def test_lane_tables_match_reference(hazard):
    """Each subset lane's table (its F narrowed by its own keep mask)
    against the reference's on that lane's arrays; lanes whose keep masks
    differ get tables that differ."""
    arena, _, lanes, st = examples.subset_case(hazard, seed=4)
    inp = ft.kernel_inputs_from_numpy(arena, "cpu")
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    sub = ct._subset_gather_ref(inp, t["gid"], t["n"], t["dead"], t["keep"])
    B, Gq = t["gid"].shape
    P = st["P"]
    seen = {}
    for b in range(B):
        one = ct.lane_inputs(sub, b)
        arrays = {f: getattr(one, f).numpy() for f in ft.KernelInputs._fields
                  if getattr(one, f) is not None}
        for g in range(Gq):
            tab = _assert_table(arrays, one, g, P, f"{hazard} lane {b}")
            key = (bytes(lanes["keep"][b]), int(lanes["gid"][b, g]))
            seen.setdefault(key, tab.candn)
    by_gid = {}
    for (keep, gid), candn in seen.items():
        by_gid.setdefault(gid, set()).add(candn.numpy().tobytes())
    distinct_keeps = len({k for k, _ in seen})
    if distinct_keeps > 1:
        assert any(len(v) > 1 for v in by_gid.values()), hazard


def _flat_narrow(inp, carry, g, take, cand, *, P, CS):
    """A plain model of the K2 commit's narrowing on CS CTAs: CTA r's
    slot pass over its chunk [r*ceil(N/CS), ...) (used += take * R where
    the take is nonzero; a filled open slot's zones and capacity types
    ANDed with the group's, its take added to its pool's, the slot
    appended to the CTA's takers), then the cluster's takers in CTA order
    dealt round-robin (CTA r: takers r, r + CS, ...), each taker's row
    narrowed in one pass to cand & fit. Returns (used, types, zones, ct,
    pool_used) and the CTAs' taker lists."""
    N = take.shape[0]
    chunk = -(-N // CS)
    R, agz, agc = inp.R[g], inp.agz[g], inp.agc[g]
    used, types = carry.used.clone(), carry.types.clone()
    zones, cts = carry.zones.clone(), carry.ct.clone()
    tbp = torch.zeros(P, dtype=torch.int64)
    lists = []
    for r in range(CS):
        mine = []
        for s in range(r * chunk, min(N, (r + 1) * chunk)):
            k = int(take[s])
            if k == 0:
                continue
            used[s] += k * R
            pool = int(carry.pool[s])
            if pool < 0 or k <= 0:
                continue
            zones[s] &= agz
            cts[s] &= agc
            tbp[min(pool, P - 1)] += k
            mine.append(s)
        lists.append(mine)
    takers = [s for mine in lists for s in mine]
    for r in range(CS):
        for s in takers[r::CS]:
            types[s] = cand[s] & (used[s][None, :] <= inp.A).all(dim=-1)
    return (used, types, zones, cts,
            carry.pool_used + tbp[:, None] * R[None, :]), lists


@pytest.mark.parametrize("case,n_max,CS", [("wrap_n_rem", 38, 8),
                                           ("wrap_n_rem", 38, 4),
                                           ("wrap_n_rem", 27, 2),
                                           ("wrap_n_rem", 33, 8)])
def test_flat_narrowing_model(case, n_max, CS):
    """The model's narrowing equals ``_narrow_ref`` at every step of the
    scan, and the scan built on it (new nodes from each group's table)
    equals the reference's, on the arena whose fills spread over the most
    slots (the fused scan's ``wrap_n_rem``, its fuse flags unused).
    N = E + n_max is not a multiple of the chunk; some step fills slots
    in two CTAs' chunks and some fills none."""
    arrays, st = examples.fused_case(case, n_max=n_max)
    arrays = {k: v for k, v in arrays.items() if k != "fuse"}
    st = dict(st, V=0)
    E, P, V = st["E"], st["P"], st["V"]
    N = E + st["n_max"]
    assert N % -(-N // CS)
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    carry = ft.carry0(inp, N, E)
    takes, lefts = [], []
    straddle = empty = False
    for g in range(st["G"]):
        take, n_rem, cand = ft._fill_phase_ref(inp, carry, g, E=E, P=P, V=V)
        got, lists = _flat_narrow(inp, carry, g, take, cand, P=P, CS=CS)
        want = ft._narrow_ref(inp, carry, g, take, cand, P=P)
        for nm, a, b in zip(("used", "types", "zones", "ct", "pool_used"),
                            got, want):
            assert torch.equal(a, b), (g, nm)
        straddle |= sum(1 for mine in lists if mine) > 1
        empty |= not any(lists)
        used, types, zones, cts, pool_used = got
        (take, used, types, zones, cts, pool, alive, num_nodes, pool_used,
         n_rem, _) = ft._new_nodes_phase_ref(
            inp, g, take, used, types, zones, cts, carry.pool, carry.alive,
            carry.num_nodes, pool_used, n_rem, E=E, P=P, V=V,
            table=ft._new_node_table_ref(inp, g, P=P))
        carry = ft.Carry(used, types, zones, cts, pool, alive, num_nodes,
                         pool_used)
        takes.append(take.to(torch.int32))
        lefts.append(n_rem)
    assert straddle and empty
    _assert_scan(arrays, st, takes, lefts, carry)
