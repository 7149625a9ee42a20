"""The sharded scan's group step (K10) as its redesigned kernels compute
it, held against the reference package on the CPU, with no spawned ranks:
every rank of a layout runs in this process, step by step, and the
collectives between the launches are done here by hand (the max over the
type shards, the earlier slot shards' prefixes and the sum over them).

Without minValues floors the headroom launch (csrc/mesh.cu
``mesh_slot_headroom``) writes, beside the candidate rows, the group's
new-node table over the rank's types; the commit (``mesh_commit``)
narrows the filled open slots on a cluster of CTAs and opens new nodes
from the table at global slot ids, with the caps reduced over the type
shards and the take by pool reduced over the slot shards. Here:

- the table the plain headroom writes (``mesh_cuda._slot_headroom_mesh_ref``)
  against the reference's ``cand_new`` and ``hr`` of ``_new_nodes_phase``
  (ops/ffd_jax.py:393-404) on its padded types (``_pad_types``), cut to
  each rank's type shard, on every ``examples.MESH_CASES`` case without
  floors (a shard of pad types alone in ``few_types``, the ``hazards``
  rows) on the 1 x 4, 2 x 2 and 4 x 1 layouts; the max of each rank's
  partial caps equals its own cap from ``_new_caps_ref``;
- a plain model of the windowed cluster commit on CS = 1, 2, 4 and 8
  CTAs (each CTA's slot pass compacts its takers, the takers' cells are
  dealt round-robin over the cluster, new nodes open at global ids and
  only the rows inside the rank's window are written) against
  ``_commit_mesh_ref`` at every step of every rank, and the whole scan
  built on it against the reference's JAX mesh (``solve_scan_sharded2``
  on ``solve_mesh2(4, dp)``): later slot shards (slot0 > 0), opened runs
  across a CTA chunk's edge and the shard's, Nl not a multiple of CS, a
  shard with no taker, and the zero request row whose prefixes wrap.

Tolerance: exact (int64 and bool).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu.ops.ffd_jax import KernelInputs as RefInputs
from karpenter_provider_aws_tpu.parallel import mesh as ref_mesh
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
from karpenter_provider_aws_tpu_torch.parallel import mesh as pm


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: (ndp, ntp) of four ranks: the type mesh, pods x types, the slot split
LAYOUTS = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
TABLE_CASES = [c for c in examples.MESH_CASES if c != "min_values"]
FIELDS = ("takes", "leftover", "used", "types", "zones", "ct", "pool",
          "alive", "num_nodes", "pool_used")


# ---------------------------------------------------------------------------
# every rank of a layout in one process
# ---------------------------------------------------------------------------

def _rank_states(arrays, st, ndp, ntp):
    """{(dp, tp): MeshState} of every rank's shard, cut as the dispatch
    cuts it (types padded to a multiple of ntp, slots to one of ndp)."""
    E, P, N = st["E"], st["P"], st["E"] + st["n_max"]
    Np = -(-N // ndp) * ndp
    T = np.asarray(arrays["A"]).shape[0]
    Tp = -(-T // ntp) * ntp
    names = [f for f in pm.FIELDS if arrays.get(f) is not None]
    out = {}
    for dp in range(ndp):
        for tp in range(ntp):
            lay = examples.ShardStub(ndp, dp, [0] * (P + 1), ntp=ntp,
                                     tp_idx=tp)
            inp = ft.KernelInputs(**pm._shard_inputs(
                arrays, lay, names, Tp, Np, Np if ndp > 1 else None, 0,
                torch.device("cpu")))
            out[(dp, tp)] = mc.MeshState(inp, E=E, P=P, V=0, N=N,
                                         slot0=dp * (Np // ndp))
    return out


def _tp_max(states, ndp, ntp, get):
    """The max over each slot row's type shards of ``get(state)``, in
    place (``MeshComm.axis_max``)."""
    for dp in range(ndp):
        xs = [get(states[(dp, tp)]) for tp in range(ntp)]
        m = torch.stack(xs).amax(0)
        for x in xs:
            x.copy_(m)


def _dp_before(states, ndp, ntp, get, put):
    """Each rank's sum of ``get`` over the earlier slot shards of its type
    column, into ``put`` (``MeshComm.dp_before``; int64 sums wrap)."""
    for tp in range(ntp):
        acc = torch.zeros_like(get(states[(0, tp)]))
        for dp in range(ndp):
            s = states[(dp, tp)]
            x = get(s).clone()
            put(s).copy_(acc)
            acc = acc + x


def _dp_sum(states, ndp, ntp, get):
    """The sum over each type column's slot shards, in place."""
    for tp in range(ntp):
        xs = [get(states[(dp, tp)]) for dp in range(ndp)]
        tot = torch.stack(xs).sum(0)
        for x in xs:
            x.copy_(tot)


def _lockstep_scan(states, ndp, ntp, commit):
    """The step loop of ``parallel/mesh.py`` ``_mesh_scan`` over every
    rank at once, on the plain parts, with ``commit(state, g)`` as each
    rank's commit."""
    ranks = list(states.values())
    P, G = ranks[0].P, ranks[0].G
    for s in ranks:
        mc._new_caps_ref(s)
    _tp_max(states, ndp, ntp, lambda s: s.caps)
    for g in range(G):
        for s in ranks:
            mc._slot_headroom_mesh_ref(s, g)
        _tp_max(states, ndp, ntp, lambda s: s.kh)
        if ndp == 1:
            for s in ranks:
                mc._fill_ref(s, g, mc.PHASE_ALL)
        else:
            for s in ranks:
                mc._fill_ref(s, g, mc.PHASE_A)
            _dp_before(states, ndp, ntp, lambda s: s.red[:P],
                       lambda s: s.before[:P])
            for s in ranks:
                mc._fill_ref(s, g, mc.PHASE_B)
            _dp_before(states, ndp, ntp, lambda s: s.red[:1],
                       lambda s: s.before[P:])
            for s in ranks:
                mc._fill_ref(s, g, mc.PHASE_C)
            _dp_sum(states, ndp, ntp, lambda s: s.red)
        for s in ranks:
            commit(s, g)


def _gathered(states, ndp, ntp, T, N):
    """The layout's outputs as one solve's: ``types`` over the type
    shards, then every slot-indexed output over the slot shards; padding
    stripped."""
    rows = []
    for dp in range(ndp):
        s = states[(dp, 0)]
        types = torch.cat([states[(dp, tp)].carry.types
                           for tp in range(ntp)], 1)
        rows.append(dict(takes=s.takes, used=s.carry.used, types=types,
                         zones=s.carry.zones, ct=s.carry.ct,
                         pool=s.carry.pool, alive=s.carry.alive))
    s0 = states[(0, 0)]
    out = {k: torch.cat([r[k] for r in rows], 1 if k == "takes" else 0)
           for k in rows[0]}
    out["takes"] = out["takes"][:, :N]
    out["types"] = out["types"][:N, :T]
    for k in ("used", "zones", "ct", "pool", "alive"):
        out[k] = out[k][:N]
    out.update(leftover=s0.leftover, num_nodes=s0.carry.num_nodes,
               pool_used=s0.carry.pool_used)
    return {k: v.numpy().reshape(1) if k == "num_nodes" else v.numpy()
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tables(case: str):
    """The reference's per-(group, pool) ``cand_new`` and ``hr`` of
    ``_new_nodes_phase`` (ops/ffd_jax.py:393-404) on the case's types
    padded for four type shards by the reference's ``_pad_types`` (a
    padding for fewer shards is a prefix of it): [(candn [P, Tp], hrn
    [P, Tp])] a group."""
    arrays, st = examples.mesh_case(case)
    inp, _ = ref_mesh._pad_types(
        RefInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}), 4)
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    out = []
    for g in range(inp.R.shape[0]):
        R, F, agz, agc = inp.R[g], inp.F[g], inp.agz[g], inp.agc[g]
        cands, hrs = [], []
        for pi in range(st["P"]):
            zc_p = ((agz & inp.pool_agz[pi])[:, None]
                    & (agc & inp.pool_agc[pi])[None, :]).reshape(Z * C)
            cand_new = F & inp.pool_types[pi] & (inp.avail_zc
                                                 & zc_p[None, :]).any(axis=1)
            hr = jnp.where(cand_new, ffd_jax._headroom_vec(
                inp.A, inp.daemon[g][pi][None, :], R), 0)
            cands.append(np.asarray(cand_new))
            hrs.append(np.asarray(hr))
        out.append((np.stack(cands), np.stack(hrs)))
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", TABLE_CASES)
def test_mesh_table_matches_reference(case, layout):
    """Every rank's table of every group equals the reference's cut to
    the rank's types (pad types: no candidate, headroom 0), and the max
    of its partial caps is the rank's own cap."""
    arrays, st = examples.mesh_case(case)
    ndp, ntp = LAYOUTS[layout]
    P = st["P"]
    want = _jax_tables(case)
    states = _rank_states(arrays, st, ndp, ntp)
    pad_shard = False
    for (dp, tp), s in states.items():
        mc._new_caps_ref(s)
        Tl = s.T
        cols = slice(tp * Tl, (tp + 1) * Tl)
        pad_shard |= not bool(s.inp.A.any())
        for g in range(s.G):
            mc._slot_headroom_mesh_ref(s, g)
            candn, hrn, cap, _ = s.table()
            label = f"{case} {layout} rank ({dp}, {tp}) g={g}"
            np.testing.assert_array_equal(candn.numpy(), want[g][0][:, cols],
                                          err_msg=f"{label} candn")
            np.testing.assert_array_equal(hrn.numpy(), want[g][1][:, cols],
                                          err_msg=f"{label} hrn")
            assert torch.equal(cap, s.caps[g * P:(g + 1) * P]), label
            assert not bool(hrn[~candn].any()), label
    # two of the four type shards of few_types hold pad types alone
    assert pad_shard == (case == "few_types" and ntp == 4)


# ---------------------------------------------------------------------------
# the windowed cluster commit
# ---------------------------------------------------------------------------

def _window_commit_model(st, g, CS, seen):
    """A plain model of ``mesh_commit`` at K == 0 on CS CTAs: CTA r's slot
    pass over its local rows [r*ceil(Nl/CS), ...) (used += take * R where
    the take is nonzero; a filled open slot's zones and capacity types
    ANDed with the group's and the slot appended to the CTA's takers);
    the cluster's takers in CTA order dealt round-robin (CTA r: takers r,
    r + CS, ...), each taker's row narrowed to cand & fit; then CTA 0's
    thread 0 walks the pools with the window's caps (reduced over the
    type shards), pool usage plus the take by pool reduced over the slot
    shards, n minus its sum, the true N and E, opening runs at global
    ids; the opened rows inside [slot0, slot0 + Nl) are written. Updates
    ``st`` in place and records in ``seen`` what the step reached."""
    inp, c, P, Nl, slot0 = st.inp, st.carry, st.P, st.Nl, st.slot0
    R, daemon = inp.R[g], inp.daemon[g]
    take = st.k
    chunk = -(-Nl // CS)
    lists = []
    for r in range(CS):
        mine = []
        for s in range(r * chunk, min(Nl, (r + 1) * chunk)):
            if int(take[s]) == 0:
                continue
            c.used[s] += take[s] * R
            if int(c.pool[s]) < 0 or int(take[s]) <= 0:
                continue
            c.zones[s] &= inp.agz[g]
            c.ct[s] &= inp.agc[g]
            mine.append(s)
        lists.append(mine)
    takers = [s for mine in lists for s in mine]
    for r in range(CS):
        for s in takers[r::CS]:
            c.types[s] = st.cand[s] & (c.used[s][None, :] <= inp.A).all(-1)
    seen["no_taker"] |= not takers
    seen["takers_in_two_ctas"] |= sum(1 for m in lists if m) > 1
    # the new-node scalars
    zero = torch.zeros((), dtype=torch.int64)
    tbp, caps = st.red, st.caps[g * P:(g + 1) * P]
    pu = c.pool_used + tbp[:P, None] * R[None, :]
    n_rem = inp.n[g] - tbp.sum()
    nn = c.num_nodes[0].long()
    runs = []
    for pi in range(P):
        cap = caps[pi]
        budget = ft._pool_budget(inp.pool_limit[pi], pu[pi], R)
        can_place = torch.minimum(n_rem, budget) \
            if bool(inp.admit[g, pi]) and int(cap) >= 1 else zero
        q = -torch.div(-can_place, cap.clamp(min=1), rounding_mode="floor") \
            if int(can_place) > 0 else zero
        q = torch.minimum(q, st.N - st.E - nn)
        placed = torch.minimum(can_place, q * cap)
        runs.append((pi, int(q), int(st.E + nn), placed - cap * (q - 1), cap))
        pu[pi] += placed * R
        nn = nn + q
        n_rem = n_rem - placed
    c.pool_used.copy_(pu)
    c.num_nodes[0] = nn.to(torch.int32)
    # the opened rows inside the window
    for pi, q, start, last, cap in runs:
        if q <= 0:
            continue
        lo, hi = start - slot0, start + q - slot0
        if lo < Nl and hi > 0:
            seen["opened"] |= True
            seen["run_across_ctas"] |= (max(lo, 0) // chunk
                                        != (min(hi, Nl) - 1) // chunk)
            seen["run_across_shards"] |= lo < 0 or hi > Nl
        for s in range(max(lo, 0), min(hi, Nl)):
            m = last if s == hi - 1 else cap
            c.used[s] += m * R + daemon[pi]
            c.types[s] = st.candn[pi] & (st.hrn[pi] >= m)
            c.zones[s] = inp.agz[g] & inp.pool_agz[pi]
            c.ct[s] = inp.agc[g] & inp.pool_agc[pi]
            c.pool[s] = pi
            c.alive[s] = True
            take[s] += m
    st.takes[g] = take.to(torch.int32)
    st.leftover[g] = n_rem
    # the zero request row's prefixes wrap: takes near BIG, negative as
    # int32
    seen["wrapped"] |= bool((st.takes[g] < 0).any())
    seen["later_shard"] |= slot0 > 0
    seen["ragged"] |= Nl % CS != 0


@functools.lru_cache(maxsize=None)
def _jax_mesh(case: str, ndp: int):
    arrays, st = examples.mesh_case(case)
    inp = RefInputs(**{k: jnp.asarray(v) for k, v in arrays.items()})
    takes, leftover, carry = ref_mesh.solve_scan_sharded2(
        inp, n_max=st["n_max"], E=st["E"], P=st["P"],
        mesh=ref_mesh.solve_mesh2(4, dp=ndp))
    out = dict(takes=takes, leftover=leftover, **carry._asdict())
    return {k: np.asarray(v).reshape(1) if k == "num_nodes"
            else np.asarray(v) for k, v in out.items()}


MODEL_CASES = [(c, lay, cs) for c in ("hazards", "existing_split")
               for lay in ("2x2", "4x1") for cs in (1, 2, 4, 8)]


def _must_reach(case, layout, CS):
    """What a model case's scan must reach besides a later slot shard, a
    step where a shard has no taker and opened rows: on ``hazards`` the
    wrapping zero request row, opened runs across the slot shards' edge
    and, on a cluster, across a CTA chunk's and takers in two CTAs' chunks
    (Nl = 28 and 14: not a multiple of 8, nor 14 of 4); on
    ``existing_split`` (a later shard starts inside the existing rows)
    the limited pool's runs across the 4 x 1 shards' edges, and on 4 or
    8 CTAs across a CTA chunk's."""
    if case == "hazards":
        out = {"wrapped", "run_across_shards"}
        if CS > 1:
            out |= {"run_across_ctas", "takers_in_two_ctas"}
        if CS == 8 or (CS == 4 and layout == "4x1"):
            out.add("ragged")
        return out
    out = set()
    if layout == "4x1":
        out.add("run_across_shards")
        if CS >= 4:
            out.add("run_across_ctas")
    return out


@pytest.mark.parametrize("case,layout,CS", MODEL_CASES)
def test_window_commit_model(case, layout, CS):
    """At every step of every rank the model's commit equals
    ``_commit_mesh_ref`` on the same entry state (every buffer the kernel
    writes), and the scan built on it equals the reference's JAX mesh on
    the same layout; the cases reach the window's hazards."""
    arrays, st = examples.mesh_case(case)
    ndp, ntp = LAYOUTS[layout]
    states = _rank_states(arrays, st, ndp, ntp)
    seen = dict(no_taker=False, takers_in_two_ctas=False, opened=False,
                run_across_ctas=False, run_across_shards=False,
                wrapped=False, later_shard=False, ragged=False)

    def commit(s, g):
        ref = s.clone()
        mc._commit_mesh_ref(ref, g)
        _window_commit_model(s, g, CS, seen)
        for nm, t in s.buffers().items():
            assert torch.equal(t, ref.buffers()[nm]), (g, s.slot0, nm)

    _lockstep_scan(states, ndp, ntp, commit)
    got = _gathered(states, ndp, ntp, np.asarray(arrays["A"]).shape[0],
                    st["E"] + st["n_max"])
    want = _jax_mesh(case, ndp)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert seen.pop("later_shard") and seen.pop("no_taker") \
        and seen.pop("opened")
    assert _must_reach(case, layout, CS) <= {k for k, v in seen.items()
                                              if v}


# ---------------------------------------------------------------------------
# the one-CTA fill (mesh_fill) as the kernel runs it
# ---------------------------------------------------------------------------

def _w64(x: int) -> int:
    """x wrapped to int64, as the kernel's unsigned sums wrap."""
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


def _fill_model(st, g, phase, nt, rows, seen=None):
    """``mesh_fill`` as csrc/mesh.cu runs it on one CTA of ``nt`` threads
    holding up to ``rows`` rows each: the rows in tiles of nt * rows, a
    thread a contiguous chunk of ceil(tile / nt) rows; phase (a)'s overlay
    row by row; phase (b) over the limited pools the group admits, eight
    a scan (each thread's chunk sums, an exclusive scan over the threads,
    plus the pool's carried prefix: the earlier shards' and tiles'), phase
    (c) over one scan with the fill's carried prefix; k stored once a
    tile, the sums by segment over every row. Writes ``st.k`` and the
    entries of ``st.red`` the kernel writes."""
    inp, c, P, N = st.inp, st.carry, st.P, st.Nl
    do_a = phase in (mc.PHASE_A, mc.PHASE_ALL)
    do_b = phase in (mc.PHASE_B, mc.PHASE_ALL)
    do_c = phase in (mc.PHASE_C, mc.PHASE_ALL)
    before = None if phase == mc.PHASE_ALL else st.before.tolist()
    R = inp.R[g]
    if do_a:   # the overlay is row by row: the plain part's own formula
        ref = st.clone()
        mc._fill_ref(ref, g, mc.PHASE_A)
        k_a = ref.k.tolist()
    k = st.k.tolist()
    pool = c.pool.tolist()
    lp = [q for q in range(P) if do_b and bool(inp.admit[g, q])
          and bool((inp.pool_limit[q] >= 0).any())]
    lb = [int(ft._pool_budget(inp.pool_limit[q], c.pool_used[q], R))
          for q in lp]
    cb = [before[q] if before else 0 for q in lp]
    cc = before[P] if do_c and before else 0
    n = int(inp.n[g])
    sums = [0] * (P + 1)
    tile = nt * rows
    for t0 in range(0, N, tile):
        t1 = min(t0 + tile, N)
        per = -(-(t1 - t0) // nt)
        chunks = [range(min(t0 + i * per, t1), min(t0 + (i + 1) * per, t1))
                  for i in range(nt)]
        assert all(len(ch) <= rows for ch in chunks)
        if seen is not None:
            seen["tiles"] = max(seen.get("tiles", 0), t0 // tile + 1)
        if do_a:
            for s in range(t0, t1):
                k[s] = k_a[s]
        for b0 in range(0, len(lp), 8):
            comps = range(b0, min(b0 + 8, len(lp)))
            if seen is not None and b0:
                seen["scans"] = True
            for j in comps:
                local = [sum(k[s] for s in ch if pool[s] == lp[j])
                         for ch in chunks]
                excl = 0
                for ch, v in zip(chunks, local):
                    cum = _w64(excl + cb[j])
                    for s in ch:
                        if pool[s] != lp[j]:
                            continue
                        kp = k[s]
                        room = _w64(lb[j] - cum)
                        cum = _w64(cum + kp)
                        k[s] = max(min(kp, room), 0)
                    excl += v
                cb[j] = _w64(cb[j] + excl)
        if do_c:
            excl = 0
            for ch in chunks:
                v = sum(k[s] for s in ch)
                cum = _w64(excl + cc)
                for s in ch:
                    x = max(_w64(n - cum), 0)
                    cum = _w64(cum + k[s])
                    k[s] = min(x, k[s])
                excl += v
            cc = _w64(cc + excl)
        for s in range(t0, t1):
            seg = 0 if phase == mc.PHASE_B else (
                P if pool[s] < 0 else min(pool[s], P - 1))
            sums[seg] = _w64(sums[seg] + k[s])
    st.k.copy_(torch.tensor(k, dtype=torch.int64))
    nout = P if phase == mc.PHASE_A else (1 if phase == mc.PHASE_B
                                          else P + 1)
    st.red[:nout] = torch.tensor(sums[:nout], dtype=torch.int64)


#: (rows of the rank, pools, state options) of the model's states
FILL_MODEL_STATES = (
    [(nl, p, dict(E=e)) for nl, p, e in examples.FILL_SHAPES]
    + [(1, 1, {}), (33, 8, {}), (33, 3, dict(limited=False)),
       (300, 8, dict(E=100, slot0=50, before="wrap")),
       (300, 8, dict(E=40, slot0=100, before="small")),
       (100, 20, {}), (9000, 2, dict(before="small"))])

#: every phase of each state; with minValues floors only the one-launch
#: fill (floors ride the type mesh, ndp == 1)
FILL_MODEL_CASES = (
    [(nl, p, kw, ph) for nl, p, kw in FILL_MODEL_STATES
     for ph in (mc.PHASE_A, mc.PHASE_B, mc.PHASE_C, mc.PHASE_ALL)]
    + [(64, 3, dict(K=2, V=3), mc.PHASE_ALL)])


def test_fill_threads_rule():
    """The fill's CTA: 256 threads up to 2,048 rows (at most 8 a thread),
    512 past them; a thread's rows the power of two at or above the rows
    over the threads, at most 8, so one tile holds the rank's rows up to
    4,096, the world-1 ceiling's 4,224 take two tiles and 9,000 three."""
    ns = (1, 256, 257, 512, 2048, 2049, 2112, 4096, 4224, 9000)
    assert [mc.fill_threads(n) for n in ns] \
        == [256] * 5 + [512] * 5
    assert [mc.fill_rows(n) for n in ns] == [1, 1, 2, 2, 8, 8, 8, 8, 8, 8]
    assert [-(-n // (mc.fill_threads(n) * mc.fill_rows(n))) for n in ns] \
        == [1] * 8 + [2, 3]
    for n in ns:
        r = mc.fill_rows(n)
        assert r == 1 or (r // 2) * mc.fill_threads(n) < n


@pytest.mark.parametrize("nl,P,kw,phase", FILL_MODEL_CASES)
def test_fill_model_matches_plain(nl, P, kw, phase):
    """The model of the one-CTA fill equals ``_fill_ref`` on the same
    entry state (k and red) at the card's CTA for the rank's rows and on
    small CTAs whose tiles split the rows (the carried prefixes across
    tiles); limited and unlimited pools, a shard starting inside the
    existing rows, wrapping prefixes, minValues floors (the type mesh's
    one-launch fill)."""
    st, g = examples.fill_state(nl, P, seed=nl + P, **kw)
    want = st.clone()
    mc._fill_ref(want, g, phase)
    shapes = [(mc.fill_threads(nl), mc.fill_rows(nl)), (4, 2), (32, 3)]
    seen = {}
    for nt, rows in shapes:
        got = st.clone()
        _fill_model(got, g, phase, nt, rows, seen)
        assert torch.equal(got.k, want.k), (nt, rows)
        assert torch.equal(got.red, want.red), (nt, rows)
    if nl >= 33:
        assert seen["tiles"] > 1
    if P == 20 and phase in (mc.PHASE_B, mc.PHASE_ALL):
        assert seen.get("scans")   # ten limited pools: two scans


# ---------------------------------------------------------------------------
# mesh_new_caps: the type axis over a cluster of CTAs
# ---------------------------------------------------------------------------

def _floordiv_rcp(a, b):
    """csrc/ffd_common.cuh ``floordiv_rcp`` with rb = 1 / b, elementwise:
    below 2^52 the fp64 product floored and one correction each way by
    the remainder; the integer floor division otherwise."""
    a = np.asarray(a, np.int64)
    b = np.broadcast_to(np.asarray(b, np.int64), a.shape)
    lim = 1 << 52
    big = (a <= -lim) | (a >= lim) | (b >= lim)
    with np.errstate(invalid="ignore", over="ignore"):
        rb = 1.0 / b.astype(np.float64)
        q = np.floor(a.astype(np.float64) * rb)
        q = np.where(big, 0, q).astype(np.int64)
    r = a - q * b
    q = q - (r < 0) + (r >= b)
    return np.where(big, a // b, q)


def _cand_loop(F, pool_types, avail, agz, pagz, agc, pagc, Z, C):
    """[T] ``new_node_cand`` (csrc/ffd_step.cuh) of one (group, pool) for
    every type: its byte loops."""
    T = avail.shape[0]
    out = np.zeros(T, bool)
    for t in range(T):
        if not (F[t] and pool_types[t]):
            continue
        out[t] = any(agz[z] and pagz[z] and agc[c] and pagc[c]
                     and avail[t, z * C + c]
                     for z in range(Z) for c in range(C))
    return out


def _offer_word(row) -> int:
    """A type's offering word (bit z*C + c) as ``offer_word`` builds it
    from the row's bytes."""
    return sum(1 << i for i in range(len(row)) if row[i])


def _cand_words(F, pool_types, avail, agz, pagz, agc, pagc, Z, C):
    """[T] the kernel's candidate test (``type_hr``): each type's
    offering word (``offer_word``) ANDed with the (group, pool) pair word
    (warp 0's ballots); ``_cand_loop`` past 64 pairs."""
    ZC = Z * C
    if ZC > 64:
        return _cand_loop(F, pool_types, avail, agz, pagz, agc, pagc, Z, C)
    zm = 0
    for i in range(ZC):
        z, c = divmod(i, C)
        if agz[z] and pagz[z] and agc[c] and pagc[c]:
            zm |= 1 << i
    words = [_offer_word(avail[t]) for t in range(avail.shape[0])]
    return F & pool_types & np.array([(w & zm) != 0 for w in words], bool)


def _hr_model(A, dmn, R):
    """[T] the kernel's headroom of every type over the daemon row: the
    quotients by reciprocals (``head_staged`` with ``rb``) at D <= 8, the floor
    division past it; min over requested dims (BIG if none), clipped."""
    D = A.shape[1]
    m = np.full(A.shape[0], ft.BIG, np.int64)
    with np.errstate(over="ignore"):
        for d in range(D):
            if R[d] <= 0:
                continue
            x = A[:, d] - dmn[d]                 # int64, wraps
            q = _floordiv_rcp(x, R[d]) if D <= 8 else x // R[d]
            m = np.minimum(m, q)
    return np.maximum(m, 0)


def caps_model(st):
    """``mesh_new_caps`` as the kernel decomposes it, into a copy of
    ``st.caps``: for each (group, pool) X = ``caps_cluster(T, K)`` CTAs,
    CTA r over the types [r * ceil(T / X), ...), each type's candidate
    and headroom as above, each CTA's partial max (0 over no candidate),
    rank 0's max of the partials; with floors (X == 1) the per-value
    maxima of headroom + 1 over the pairs (skipping v outside [0, V) and
    t outside [0, T))."""
    inp = {k: (v.numpy() if v is not None else None)
           for k, v in st.inp._asdict().items()}
    T, G, P, K, V = st.T, st.G, st.P, st.K, st.V
    Z, C = inp["agz"].shape[1], inp["agc"].shape[1]
    X = mc.caps_cluster(T, K)
    assert K == 0 or X == 1
    tc = -(-T // X) if T else 0
    caps = np.zeros(G * P * (1 + K * V), np.int64)
    for g in range(G):
        for pi in range(P):
            cand = _cand_words(inp["F"][g], inp["pool_types"][pi],
                               inp["avail_zc"], inp["agz"][g],
                               inp["pool_agz"][pi], inp["agc"][g],
                               inp["pool_agc"][pi], Z, C)
            hr = np.where(cand, _hr_model(inp["A"], inp["daemon"][g, pi],
                                          inp["R"][g]), -1)
            parts = [max(0, int(hr[r * tc:(r + 1) * tc].max(initial=-1)))
                     for r in range(X)]
            gp = g * P + pi
            caps[gp] = max(parts)
            if not K:
                continue
            h1 = np.zeros((K, V), np.int64)
            for kk in range(K):
                for t, v in zip(inp["mv_pairs_t"][kk], inp["mv_pairs_v"][kk]):
                    if 0 <= v < V and 0 <= t < T and hr[t] >= 0:
                        h1[kk, v] = max(h1[kk, v], hr[t] + 1)
            caps[G * P + gp * K * V:G * P + (gp + 1) * K * V] = h1.reshape(-1)
    return torch.from_numpy(caps)


def test_caps_cluster_rule():
    """The CTAs of a (group, pool) at the main paths' shapes (8 at T =
    812, 2 at the tp cell's gloo rank of 203, 4 at 406), one with floors,
    and every type in exactly one CTA's chunk of at most one pass of the
    CTA's threads up to 1,024 types."""
    want = dict(tp=8, tp_rank=2, dp2_rank=4, k11=4, ceiling=8)
    for name, T, G, P, *_ in examples.CAPS_SHAPES:
        assert mc.caps_cluster(T, 0) == want[name], name
        assert mc.caps_cluster(T, 2) == 1
    for T in (0, 1, 127, 128, 129, 203, 406, 812, 1024, 1025, 5000):
        X = mc.caps_cluster(T, 0)
        assert X in (1, 2, 4, 8)
        tc = -(-T // X) if T else 0
        cover = [t for r in range(X) for t in range(r * tc,
                                                    min(T, (r + 1) * tc))]
        assert cover == list(range(T))
        if T <= 8 * mc.CAPS_THREADS:
            assert tc <= mc.CAPS_THREADS


CAPS_CASES = examples.CAPS_CASES


@pytest.mark.parametrize("name,shape,K", CAPS_CASES,
                         ids=[c[0] for c in CAPS_CASES])
def test_caps_model_matches_plain(name, shape, K):
    """The model of the kernel's decomposition equals ``_new_caps_ref`` at
    the main paths' shapes (``examples.CAPS_SHAPES``), with floors, past
    eight dimensions, past the 64-bit offering word and at exactly 64
    pairs (bit 63 the sign bit)."""
    st = examples.caps_state(**shape, seed=len(name), K=K, V=5 if K else 0)
    mc._new_caps_ref(st)
    got = caps_model(st)
    assert torch.equal(got, st.caps), name
    GP = st.G * st.P
    assert bool((st.caps[:GP] > 0).any())
    if K:
        assert bool((st.caps[GP:] > 0).any())
    if shape["G"] > 2:
        assert int(st.caps[st.P]) == ft.BIG       # group 1 requests nothing


def _case_ranks(case, ntp):
    """Every rank of the type mesh of ``ntp`` shards of a ``MESH_CASES``
    case, its minValues pairs localized with the case's V."""
    arrays, st = examples.mesh_case(case)
    E, P, V, N = st["E"], st["P"], st["V"], st["E"] + st["n_max"]
    T = np.asarray(arrays["A"]).shape[0]
    Tp = -(-T // ntp) * ntp
    names = [f for f in pm.FIELDS if arrays.get(f) is not None]
    out = []
    for tp in range(ntp):
        lay = examples.ShardStub(1, 0, [0] * (P + 1), ntp=ntp, tp_idx=tp)
        inp = ft.KernelInputs(**pm._shard_inputs(
            arrays, lay, names, Tp, N, None, V, torch.device("cpu")))
        out.append(mc.MeshState(inp, E=E, P=P, V=V, N=N, slot0=0))
    return out


@pytest.mark.parametrize("ntp", [1, 4])
@pytest.mark.parametrize("case", examples.MESH_CASES)
def test_caps_model_on_mesh_cases(case, ntp):
    """Every rank's caps (floors included) by the model equal
    ``_new_caps_ref``'s, at world size 1 and on four type shards."""
    for s in _case_ranks(case, ntp):
        mc._new_caps_ref(s)
        assert torch.equal(caps_model(s), s.caps), (case, ntp)


@pytest.mark.parametrize("Z,C", [(4, 3), (3, 2), (16, 4), (22, 3), (1, 1)])
def test_offer_words_match_new_node_cand(Z, C):
    """The kernel's word test equals ``new_node_cand``'s loops for random
    group and pool narrowings: Z*C = 64 sets bit 63, 66 pairs take the
    loops."""
    rng = np.random.RandomState(Z * 10 + C)
    T = 61
    avail = rng.rand(T, Z * C) < 0.2
    avail[3, -1] = True
    hits = 0
    for _ in range(30):
        F, pt = rng.rand(T) < 0.8, rng.rand(T) < 0.9
        agz, pagz = rng.rand(Z) < 0.7, rng.rand(Z) < 0.8
        agc, pagc = rng.rand(C) < 0.8, rng.rand(C) < 0.8
        want = _cand_loop(F, pt, avail, agz, pagz, agc, pagc, Z, C)
        got = _cand_words(F, pt, avail, agz, pagz, agc, pagc, Z, C)
        assert np.array_equal(got, want)
        hits += int(want.sum())
    assert hits


def test_rcp_quotients_are_exact():
    """The elementwise reciprocal quotient used by the model equals the
    floor division, and the K9 test's scalar model of ``floordiv_rcp``, on
    random and edge operands (one either side of multiples, negative
    numerators, b = 1, operands at and past 2^52)."""
    import test_torch_k9 as k9
    rng = np.random.RandomState(3)
    a = rng.randint(-(1 << 52) + 1, 1 << 52, size=4000, dtype=np.int64)
    b = rng.randint(1, 1 << 40, size=4000, dtype=np.int64)
    bs = rng.randint(1, 1 << 20, size=4000, dtype=np.int64)
    q = rng.randint(-(1 << 30), 1 << 30, size=4000, dtype=np.int64)
    lim = 1 << 52
    edges = [(lim - 1, 1), (-lim + 1, 1), (lim - 1, 3), (lim, 3), (-lim, 7),
             ((1 << 62) + 5, 7), (5, lim + 1), (0, 1), (-1, 1 << 51)]
    A = np.concatenate([a, q * bs - 1, q * bs, q * bs + 1,
                        [e[0] for e in edges]])
    B = np.concatenate([b, bs, bs, bs, [e[1] for e in edges]])
    got = _floordiv_rcp(A, B)
    assert np.array_equal(got, A // B)
    for x, y, z in zip(A[::97], B[::97], got[::97]):
        assert k9.floordiv_rcp(int(x), int(y), 1.0 / int(y)) == int(z)
