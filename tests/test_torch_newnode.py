"""The new-node table of the fused (K5) and pruned (K6) scans held against
the reference package on the CPU.

The fused and pruned scans' wide launches write, for each (group, pool),
what the new-node phase reads but no carry changes: the fresh-node
candidates and their headroom over the types, the cap, and for the
pruned scan the opened rows' ``cap_hint`` row. The commits then read
that table. Here:

- the plain table (``ffd_torch._new_node_table_ref``) against the
  reference's ``cand_new``, ``hr``, ``cap`` and ``cap_row`` of
  ``_new_nodes_phase`` and the pruned step (ops/ffd_jax.py:393-404,
  :1033) on seeded inputs with P >= 3, a pool with no candidate (an
  all-zero ``cap_row``) and request rows with zero columns;
- the table-reading new-node phase against the reference's
  ``_new_nodes_phase`` on states where n_rem is negative or a pool's
  limit is already exceeded, so that a negative count is placed;
- the ``wrap_n_rem`` arenas reach a negative n_rem when the phase runs,
  in the pruned scan and in both branches of the fused scan (their
  whole scans are held byte for byte by ``test_torch_pruned.py`` and
  ``test_torch_fused.py``);
- the striped case at the slot counts of the card's cluster tests fills
  and opens slots on both sides of a CTA chunk boundary.

Tolerance: exact (int64 and bool).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft


def _arrays(seed: int, P: int = 4, T: int = 40, D: int = 5, Z: int = 3,
            C: int = 2, G: int = 6, n_max: int = 12):
    """Seeded kernel inputs: pool 1 has no candidate type, pool 2 shares
    no zone with half the groups, every request row has a zero column
    and group 0's is all zero; daemon overheads exceed some types'
    allocatable (headroom 0 there)."""
    rng = np.random.RandomState(seed)
    R = rng.randint(1, 1 << 10, size=(G, D)).astype(np.int64)
    R[:, rng.randint(D)] = 0
    R[0] = 0
    pool_types = rng.rand(P, T) < 0.6
    pool_types[1] = False
    pool_agz = rng.rand(P, Z) < 0.7
    pool_agz[2] = [True] + [False] * (Z - 1)
    agz = np.ones((G, Z), bool)
    agz[::2, 0] = False
    return dict(
        A=rng.randint(1, 1 << 20, size=(T, D)).astype(np.int64),
        avail_zc=rng.rand(T, Z * C) < 0.7,
        R=R, n=rng.randint(1, 200, size=G).astype(np.int64),
        F=rng.rand(G, T) < 0.7, agz=agz, agc=rng.rand(G, C) < 0.8,
        admit=rng.rand(G, P) < 0.8,
        daemon=rng.randint(0, 1 << 19, size=(G, P, D)).astype(np.int64),
        pool_types=pool_types, pool_agz=pool_agz,
        pool_agc=np.ones((P, C), bool),
        pool_limit=np.full((P, D), -1, np.int64),
        pool_used0=np.zeros((P, D), np.int64),
        ex_alloc=np.zeros((0, D), np.int64),
        ex_used0=np.zeros((0, D), np.int64),
        ex_compat=np.zeros((G, 0), bool)), n_max


def _jax_inputs(arrays):
    return ffd_jax.KernelInputs(**{k: jnp.asarray(v) for k, v in
                                   arrays.items()})


def _jax_table(arrays, g: int, P: int):
    """The reference's per-pool ``cand_new``, ``hr``, ``cap`` and
    ``cap_row`` of group g, as ops/ffd_jax.py:393-404 and :1033 write
    them."""
    inp = _jax_inputs(arrays)
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    R, F, agz, agc = inp.R[g], inp.F[g], inp.agz[g], inp.agc[g]
    out = []
    for pi in range(P):
        agz_p = agz & inp.pool_agz[pi]
        agc_p = agc & inp.pool_agc[pi]
        zc_p = (agz_p[:, None] & agc_p[None, :]).reshape(Z * C)
        off_p = (inp.avail_zc & zc_p[None, :]).any(axis=1)
        cand_new = F & inp.pool_types[pi] & off_p
        hr = ffd_jax._headroom_vec(inp.A, inp.daemon[g][pi][None, :], R)
        hr = jnp.where(cand_new, hr, 0)
        cap_row = jnp.where(cand_new[:, None], inp.A,
                            jnp.int64(0)).max(axis=0)
        out.append(tuple(np.asarray(x) for x in
                         (cand_new, hr, hr.max(), cap_row)))
    return [np.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("seed", range(4))
def test_table_matches_reference(seed):
    arrays, _ = _arrays(seed)
    P = arrays["pool_types"].shape[0]
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    for g in range(arrays["R"].shape[0]):
        tab = ft._new_node_table_ref(inp, g, P=P, cap_row=True)
        want = _jax_table(arrays, g, P)
        for got, w, nm in zip(tab, want, ft.NewNodeTable._fields):
            np.testing.assert_array_equal(got.numpy(), w, err_msg=f"{g} {nm}")
        # pool 1 has no candidate: no cap, an all-zero cap_row
        assert not tab.candn[1].any() and int(tab.cap[1]) == 0
        assert not tab.cap_row[1].any()
        assert tab.hrn.dtype == torch.int64 and tab.candn.dtype == torch.bool
    # without cap_row (the fused scan's table) the rest is the same
    tab = ft._new_node_table_ref(inp, 1, P=P)
    assert tab.cap_row is None
    np.testing.assert_array_equal(tab.hrn.numpy(), _jax_table(arrays, 1,
                                                              P)[1])


def test_fused_table_stacks_the_groups():
    arrays, _ = _arrays(5)
    P = arrays["pool_types"].shape[0]
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    tab = ft._fused_table_ref(inp, 2, 4, P=P)
    assert tab.candn.shape == (4, P, arrays["A"].shape[0])
    assert tab.cap.shape == (4, P) and tab.cap_row is None
    for i in range(4):
        want = _jax_table(arrays, 2 + i, P)
        np.testing.assert_array_equal(tab.candn[i].numpy(), want[0])
        np.testing.assert_array_equal(tab.hrn[i].numpy(), want[1])
        np.testing.assert_array_equal(tab.cap[i].numpy(), want[2])


# n_rem entering the phase: positive, negative (a wrapped fill), and at
# the int64 edge; pool limits: none, and pool 3's already exceeded
@pytest.mark.parametrize("n_rem", [37, -5, -(1 << 62), (1 << 62) + 3])
@pytest.mark.parametrize("exceeded", [False, True])
def test_new_nodes_phase_from_table_matches_reference(n_rem, exceeded):
    arrays, n_max = _arrays(7)
    P, D = arrays["pool_limit"].shape
    G, T = arrays["F"].shape
    if exceeded:
        arrays["pool_limit"][3, :] = 1 << 12
        arrays["pool_used0"][3, :] = (1 << 12) + 9
    arrays["R"][3, 2] = -7          # a negative entry moves pool_used
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    jinp = _jax_inputs(arrays)
    N, E = n_max, 0
    rng = np.random.RandomState(11)
    state = dict(take=rng.randint(0, 9, size=N).astype(np.int64),
                 used=rng.randint(0, 1 << 16, size=(N, D)).astype(np.int64),
                 types=rng.rand(N, T) < 0.5,
                 zones=rng.rand(N, arrays["agz"].shape[1]) < 0.5,
                 ct=rng.rand(N, arrays["agc"].shape[1]) < 0.5,
                 pool=np.where(np.arange(N) < 3, 0, -1).astype(np.int32),
                 alive=np.arange(N) < 3)
    for g in range(G):
        tab = ft._new_node_table_ref(inp, g, P=P, cap_row=True)
        cap_hint = torch.full((N, D), 5, dtype=torch.int64)
        got = ft._new_nodes_phase_ref(
            inp, g, *[torch.from_numpy(state[k]) for k in
                      ("take", "used", "types", "zones", "ct", "pool",
                       "alive")],
            torch.tensor([3], dtype=torch.int32), inp.pool_used0.clone(),
            torch.tensor(n_rem), E=E, P=P, V=0, cap_hint=cap_hint,
            table=tab)
        plain = ft._new_nodes_phase_ref(
            inp, g, *[torch.from_numpy(state[k]) for k in
                      ("take", "used", "types", "zones", "ct", "pool",
                       "alive")],
            torch.tensor([3], dtype=torch.int32), inp.pool_used0.clone(),
            torch.tensor(n_rem), E=E, P=P, V=0, cap_hint=cap_hint)
        want = ffd_jax._new_nodes_phase(
            jinp, *[jnp.asarray(state[k]) for k in
                    ("take", "used", "types", "zones", "ct", "pool",
                     "alive")],
            jnp.int32(3), jinp.pool_used0, jnp.int64(n_rem), jinp.R[g],
            jinp.F[g], jinp.agz[g], jinp.agc[g], jinp.admit[g],
            jinp.daemon[g], axis=None, P=P, E=E, N=N, V=0,
            slot_idx=jnp.arange(N), sum_only=False)
        for i, (a, w) in enumerate(zip(got[:10], want)):
            np.testing.assert_array_equal(np.asarray(a).reshape(-1),
                                          np.asarray(w).reshape(-1),
                                          err_msg=f"g={g} output {i}")
        for a, b in zip(got, plain):
            assert torch.equal(a, b), g
    if n_rem < 0:
        # a negative count was placed: n_rem moved back toward 0
        assert int(got[9]) != n_rem or not inp.admit[G - 1].any()


def _pruned_fill_n_rem(arrays, st, S):
    """n_rem after each pruned step's fill, before its new-node phase."""
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    E, P, N = st["E"], st["P"], st["E"] + st["n_max"]
    carry = ft.carry0_pruned(inp, N, E)
    out = []
    for g in range(st["G"]):
        sel, cnt = ft._pruned_select_ref(inp, carry, g, E=E, P=P, S=S)
        cand_s, k_s = ft._pruned_headroom_ref(inp, carry, g, sel)
        rows = sel[sel >= 0].long()
        k = torch.zeros(N, dtype=torch.int64)
        k[rows] = k_s[:rows.numel()]
        out.append(int(ft._prefix_fill_ref(inp, ft.Carry(*carry[:8]), g, k,
                                           P=P)[1]))
        carry, _, _ = ft._pruned_commit_ref(
            inp, carry, g, sel, cnt, cand_s, k_s,
            ft._new_node_table_ref(inp, g, P=P, cap_row=True), E=E, P=P,
            S=S)
    return out


def test_wrap_cases_reach_a_negative_n_rem():
    arrays, st = examples.pruned_case("wrap_n_rem")
    assert min(_pruned_fill_n_rem(arrays, st, 64)) < 0
    arrays, st = examples.fused_case("wrap_n_rem")
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    E, P, Fu = st["E"], st["P"], st["F"]
    carry = ft.carry0(inp, E + st["n_max"], E)
    indep = ft.block_indep(inp.fuse, Fu).tolist()
    negative = set()
    for b in range(st["G"] // Fu):
        g0 = b * Fu
        tab = ft._fused_table_ref(inp, g0, Fu, P=P)
        if indep[b]:
            for g in range(g0, g0 + Fu):
                if ft._fill_phase_ref(inp, carry, g, E=E, P=P, V=0)[1] < 0:
                    negative.add(True)
            carry, _, _ = ft._fused_block_ref(inp, carry, g0, Fu, True, tab,
                                              E=E, P=P)
            continue
        for i, g in enumerate(range(g0, g0 + Fu)):
            take, n_rem, cand = ft._fill_phase_ref(inp, carry, g, E=E, P=P,
                                                   V=0)
            if n_rem < 0:
                negative.add(False)
            carry, _, _, _ = ft._commit_ref(inp, carry, g, take, n_rem, cand,
                                            E=E, P=P, V=0,
                                            table=ft._table_row(tab, i))
    assert negative == {True, False}


# the slot counts of the card's cluster tests (tests/test_torch_cuda.py
# test_fused_cluster_chunks_straddle): N = E + n_max over `cluster` CTAs
@pytest.mark.parametrize("n_max,cluster", [(6, 2), (6, 8), (14, 8), (38, 8)])
def test_striped_fills_and_opens_straddle_cta_chunks(n_max, cluster):
    """On the striped case at these slot counts, which do not split
    evenly over the cluster, some sequential block fills slots of two
    CTAs' chunks and some block opens a run of new nodes across a chunk
    boundary (the plain fused scan, which the card's kernels equal)."""
    arrays, st = examples.fused_case("striped", n_max=n_max)
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    E, P, Fu = st["E"], st["P"], st["F"]
    N = E + n_max
    chunk = -(-N // cluster)
    assert N % cluster
    carry = ft.carry0(inp, N, E)
    indep = ft.block_indep(inp.fuse, Fu).tolist()
    fill = opened_across = False
    for b in range(st["G"] // Fu):
        entry = carry
        carry, takes, _ = ft._fused_block_ref(
            inp, carry, b * Fu, Fu, indep[b],
            ft._fused_table_ref(inp, b * Fu, Fu, P=P), E=E, P=P)
        filled = torch.nonzero((takes > 0).any(0)).reshape(-1)
        if not indep[b] and filled.numel():
            fill |= len({int(s) // chunk for s in filled}) > 1
        opened = torch.nonzero((entry.pool == -1) & (carry.pool >= 0))
        opened_across |= len({int(s) // chunk for s in opened}) > 1
    assert fill and opened_across
