"""The CUDA kernels of the port held against their plain PyTorch versions
on the card, at small shapes. Tolerance: exact (integer math). K1-K3
(the packed scan, the bank; K2's new-node table too, its commit forced
onto every shape of its rule and its headroom onto several row
layouts), the K1 and K2 kernels on their lane axis (2,048 lanes, the
minValues branch included) and the batched packed solve (K4), the fused block scan's kernels (K5;
block by block with the commit on 1, 2 and 8 CTAs, slot chunks that
straddle CTA boundaries, tables of several blocks, whole solves, B = 3,
8 and 64 lanes that branch differently, the solver), the pruned scan's
kernels (K6, the new-node tables included, the commit at 256 and 1,024
threads), the
K7 consolidation kernels (the gather at odd shapes and past grid y),
the K9 topology kernels (the pool statics by chunk) and K8, the
preemption search (its hazard tables and a round through
``Provisioner.reconcile``; a snapshot past the pour's layout routed to
the host pour), the K10 mesh kernels (``mesh_fill``'s phases from 1 to
9,000 rows, ``mesh_new_caps`` at the main paths' shapes), K1's one-launch
pack at odd shapes, on 65,552 lanes and with the bail word, K1's unpack
at ``examples.UNPACK_WIDTHS`` on up to 64 lanes and on 65,552, the
suffix's first launch (the unpack that loads a bank row; one CUDA
kernel) and its last (the pack that re-stamps the pad rows: rows at
every offset, one CUDA kernel), the subset round's last commit with the
summary rows (every commit shape, one lane on a cluster of 8), the
folded entries' refusals, and K11's distributed dispatch at 1 x 1 (a shard cut from its
host's slab).

Every test here needs a CUDA card: the ``cuda_device`` fixture skips
otherwise, so the CPU suite collects the same tests and skips them. On a
machine with a card (and without jax, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Imports nothing of jax or of the reference package.
"""

import pytest
import torch

from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
from karpenter_provider_aws_tpu_torch.ops.hostpack import (in_layout_bool,
                                                           in_layout_i64,
                                                           layout_sizes,
                                                           nwords,
                                                           pack_inputs1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain scan is thousands of small tensor ops: one intra-op
    thread runs them fastest, and several test workers on one host then
    do not oversubscribe the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _arena(case, dev, **kw):
    arrays, st = examples.example_case(case, **kw)
    buf = torch.from_numpy(pack_inputs1(arrays, *examples.pack_statics(st)))
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, st["K"],
                                       st["M"], 1, st["Q"]))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, st["K"],
                                         st["M"], 1, st["Q"]))
    return buf.to(dev), st, n_i64, n_bits


def _inputs(buf, st, n_i64, n_bits):
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    bits = ft._unpack_bits_ref(buf[n_i64:n_i64 + nwords(n_bits)], n_bits)
    return ft._unpack_inputs(buf[:n_i64], bits, T, D, Z, C, G, E, P,
                             st["K"], st["M"], 1, st["Q"])


@pytest.mark.parametrize("case", examples.CASES)
def test_unpack_bits(cuda_device, case):
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    buf, st, n_i64, n_bits = _arena(case, cuda_device)
    words = buf[n_i64:n_i64 + nwords(n_bits)]
    assert torch.equal(ffd_cuda.unpack_bits(words, n_bits),
                       ft._unpack_bits_ref(words, n_bits))


def _unpack_rows_ref(words, nbits):
    """The plain version's bool rows of a [L, nwords] words view."""
    return torch.stack([ft._unpack_bits_ref(w, nbits) for w in words])


@pytest.mark.parametrize("L", [1, 3, 17, 64])
@pytest.mark.parametrize("nbits", examples.UNPACK_WIDTHS)
def test_unpack_bits_odd_widths(cuda_device, nbits, L):
    """``unpack_bits_lanes`` at ``examples.UNPACK_WIDTHS`` (heads, tails,
    units straddling two words, bit 63 set) on lanes whose rows start at
    every offset mod 16 (the last lane's last word ends the tensor, or the
    lanes lie a word further apart), one launch a call; the one-lane
    wrapper too."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    for pad in (0, 1):
        words = examples.unpack_case(nbits, L, seed=nbits + L + pad,
                                     pad=pad, device=cuda_device)
        before = ffd_cuda.LAUNCHES["unpack_bits"]
        got = ffd_cuda.unpack_bits_lanes(words, nbits)
        assert ffd_cuda.LAUNCHES["unpack_bits"] == before + 1
        assert torch.equal(got, _unpack_rows_ref(words, nbits)), pad
        assert torch.equal(ffd_cuda.unpack_bits(words[0].contiguous(),
                                                nbits), got[0])


def test_unpack_bits_wide_lanes(cuda_device):
    """65,552 lanes (grid z > 1) of an odd width (333 bits), sixteen
    distinct lanes repeated: every row equals its source lane's plain
    row."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    words = examples.unpack_case(333, 16, seed=3, device=cuda_device)
    reps = 65_552 // 16
    got = ffd_cuda.unpack_bits_lanes(words.repeat(reps, 1), 333)
    assert got.shape == (65_552, 333)
    want = _unpack_rows_ref(words, 333)
    assert torch.equal(got.view(reps, 16, -1),
                       want[None].expand(reps, -1, -1))


@pytest.mark.parametrize("case", examples.CASES)
def test_group_kernels_step_by_step(cuda_device, case):
    """Each group's two kernels from the plain carry, against the plain
    step: cand, k and (no minValues floors) the new-node table after
    phase 1; carry, takes, leftover after 2."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    buf, st, n_i64, n_bits = _arena(case, cuda_device)
    inp = _inputs(buf, st, n_i64, n_bits)
    E, P, V = st["E"], st["P"], st["V"]
    carry = ft.carry0(inp, E + st["n_max"], E)
    state = ffd_cuda.ScanState(inp, ft.Carry(*[t.clone() for t in carry]),
                               E=E, P=P, V=V)
    for g in range(st["G"]):
        for dst, src in zip(state.carry, carry):
            dst.copy_(src)
        cand, k = ft._slot_headroom_ref(inp, carry, g, E=E, P=P, V=V)
        ffd_cuda.ffd_slot_headroom(state, g)
        assert torch.equal(state.cand, cand), g
        assert torch.equal(state.k, k), g
        if not st["K"]:
            _assert_table(state.table(), ft._new_node_table_ref(inp, g, P=P),
                          g)
        carry, take, n_rem = ft._group_step_ref(inp, carry, g, E=E, P=P,
                                                V=V)
        ffd_cuda.ffd_group_commit(state, g)
        for f, got, want in zip(ft.Carry._fields, state.carry, carry):
            assert torch.equal(got, want), (g, f)
        assert torch.equal(state.takes[g], take.to(torch.int32)), g
        assert int(state.leftover[g]) == int(n_rem), g


def _assert_table(got, want, what):
    """The headroom launch's new-node table (candn, hrn, cap) against
    the plain table."""
    for nm, a, b in zip(("candn", "hrn", "cap"), got, want):
        assert torch.equal(a, b), (what, nm)


@pytest.mark.parametrize("case", ["base", "two_pools", "slots_run_out"])
def test_pack_outputs(cuda_device, case):
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    buf, st, n_i64, n_bits = _arena(case, cuda_device)
    takes, left, carry = ft._solve_scan_ref(
        _inputs(buf, st, n_i64, n_bits), st["n_max"], st["E"], st["P"],
        st["V"])
    assert torch.equal(ffd_cuda.pack_outputs(takes, left, carry),
                       ft._pack_outputs_ref(takes, left, carry))


@pytest.mark.parametrize("case", examples.CASES)
@pytest.mark.parametrize("width", [dict(), dict(T=300, G=16, n_max=48,
                                                D=8)])
def test_packed_solve(cuda_device, case, width):
    """The whole packed solve on the card equals the plain packed solve
    on the CPU, word for word, and launches every kernel."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    arrays, st = examples.example_case(case, **width)
    buf = pack_inputs1(arrays, *examples.pack_statics(st))
    ffd_cuda.reset_launches()
    got = ft.solve_scan_packed1(buf, device=cuda_device,
                                **examples.solve_statics(st))
    assert got.is_cuda
    want = ft.solve_scan_packed1(buf, device="cpu",
                                 **examples.solve_statics(st))
    assert torch.equal(got.cpu(), want)
    assert ffd_cuda.LAUNCHES == dict(dict.fromkeys(ffd_cuda.LAUNCHES, 0),
                                     unpack_bits=1,
                                     ffd_slot_headroom=st["G"],
                                     ffd_group_commit=st["G"],
                                     pack_outputs=1)


@pytest.mark.parametrize("case", ["base", "existing", "min_values"])
def test_bank_kernels(cuda_device, case):
    """The pack's re-stamp (one row and a run of rows, from every group's
    carry of a real scan) against the plain store and the plain pack, and
    the suffix's prologue (``unpack_bits_load``: the arena's bool plane
    and bank row j into the working carry, one launch) against the plain
    unpack and bank_row."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    buf, st, n_i64, n_bits = _arena(case, cuda_device, T=37)
    inp = _inputs(buf, st, n_i64, n_bits)
    E, P, V, G = st["E"], st["P"], st["V"], st["G"]
    carry = ft.carry0(inp, E + st["n_max"], E)
    bank = ffd_cuda.empty_bank(carry, G)
    want = ft.Carry(*[torch.zeros_like(b) for b in bank])
    for b in bank:
        b.zero_()
    bs = ffd_cuda.BankState(carry, bank)
    takes, lefts = [], []
    for g in range(G):
        carry, take, n_rem = ft._group_step_ref(inp, carry, g, E=E, P=P,
                                                V=V)
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
        for dst, src in zip(bs.carry, carry):
            dst.copy_(src)
        count = G - g if g == G // 2 else 1
        tk, lf = torch.stack(takes), torch.cat(lefts)
        out = ffd_cuda.pack_outputs(tk, lf, bs.carry, store=(bs, g, count))
        assert torch.equal(out, ft._pack_outputs_ref(tk, lf, carry)), g
        ft._bank_store_ref(want, carry, g, count)
        for nm, got, w in zip(ft.Carry._fields, bank, want):
            assert torch.equal(got, w), (g, nm)
    words = buf[n_i64:]
    for j in range(G):
        before = dict(ffd_cuda.LAUNCHES)
        bits = ffd_cuda.unpack_bits_load(words, n_bits, bs, j)
        assert ffd_cuda.LAUNCHES == dict(
            before, unpack_bits=before["unpack_bits"] + 1)
        assert torch.equal(bits, ft._unpack_bits_ref(words, n_bits)), j
        for nm, got, w in zip(ft.Carry._fields, bs.carry,
                              ft.bank_row(want, j)):
            assert torch.equal(got, w), (j, nm)
        for nm, got, w in zip(ft.Carry._fields, bank, want):
            assert torch.equal(got, w), (j, nm)
    with pytest.raises(ValueError):
        ffd_cuda.unpack_bits_load(words, n_bits, bs, G)


@pytest.mark.parametrize("case", ["base", "existing", "min_values"])
@pytest.mark.parametrize("T", [37, 813, 812, 9])
def test_headroom_stores_bank_rows(cuda_device, case, T):
    """``ffd_slot_headroom`` given a bank row, at odd widths (T = 813, 37
    and 9 with Z = 3: bool planes whose rows j > 0 are not 16-byte
    aligned; D = 7; minValues floors run the one-CTA-a-row form): the
    row equals ``_bank_store_ref`` of the same carry, every other row
    stays as it was, and cand, k and the new-node table equal those of
    the launch without a row."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    buf, st, n_i64, n_bits = _arena(case, cuda_device, T=T, n_max=13, D=7)
    inp = _inputs(buf, st, n_i64, n_bits)
    E, P, V, G = st["E"], st["P"], st["V"], st["G"]
    carry = ft.carry0(inp, E + st["n_max"], E)
    state = ffd_cuda.ScanState(inp, ft.Carry(*[t.clone() for t in carry]),
                               E=E, P=P, V=V)
    rows = 5
    bs = ffd_cuda.BankState(state.carry, ffd_cuda.empty_bank(carry, rows))
    for b in bs.bank:
        b.fill_(7)
    want = ft.Carry(*[b.clone() for b in bs.bank])
    for g in range(G):
        for dst, src in zip(state.carry, carry):
            dst.copy_(src)
        ffd_cuda.ffd_slot_headroom(state, g)
        plain = (state.cand.clone(), state.k.clone(),
                 *[t.clone() for t in state.table()])
        j = g % rows
        ffd_cuda.reset_launches()
        ffd_cuda.ffd_slot_headroom(state, g, bank=bs, j=j)
        assert ffd_cuda.LAUNCHES["ffd_slot_headroom"] == 1
        assert sum(ffd_cuda.LAUNCHES.values()) == 1
        ft._bank_store_ref(want, carry, j)
        for nm, got, w in zip(ft.Carry._fields, bs.bank, want):
            assert torch.equal(got, w), (g, j, nm)
        for x, y in zip((state.cand, state.k, *state.table()), plain):
            assert torch.equal(x, y), g
        carry, _, _ = ft._group_step_ref(inp, carry, g, E=E, P=P, V=V)
    with pytest.raises(ValueError):
        ffd_cuda.ffd_slot_headroom(state, 0, bank=bs, j=rows)


@pytest.mark.parametrize("case", ["base", "existing", "min_values"])
def test_ckpt_and_suffix_on_card(cuda_device, case):
    """The checkpointed solve and every (SUF, GL) suffix of a G=8, CK=2
    arena on the card equal the plain versions on the CPU (output buffer
    and bank), and each suffix equals the rows of the full solve. The
    chunk entries' headroom launches store the bank rows and a suffix's
    pack re-stamps its pad chunks (no ``ffd_bank_store`` exists), and row
    jr keeps its bytes. A suffix loads row jr in its one ``unpack_bits``
    launch (no ``ffd_bank_load`` exists)."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.ops.hostpack import \
        unpack_outputs1
    CK, G = 2, 8
    for GL in range(CK, G + 1, CK):
        arrays, st = examples.example_case(case, G=G)
        arrays["n"][GL:] = 0
        buf = pack_inputs1(arrays, *examples.pack_statics(st))
        ss = examples.solve_statics(st)
        ffd_cuda.reset_launches()
        out, bank = ft.solve_scan_packed1_ckpt(buf, CK=CK,
                                               device=cuda_device, **ss)
        assert "ffd_bank_store" not in ffd_cuda.LAUNCHES
        assert ffd_cuda.LAUNCHES["pack_outputs"] == 1
        want, want_bank = ft.solve_scan_packed1_ckpt(buf, CK=CK,
                                                     device="cpu", **ss)
        assert torch.equal(out.cpu(), want)
        for nm, got, w in zip(ft.Carry._fields, bank, want_bank):
            assert torch.equal(got.cpu(), w), nm
        full = unpack_outputs1(want.numpy(), st["T"], st["D"], st["Z"],
                               st["C"], G, st["E"], st["P"], st["n_max"])
        for SUF in range(1, GL // CK + 1):
            d_bank = ft.Carry(*[b.clone() for b in bank])
            c_bank = ft.Carry(*[b.clone() for b in want_bank])
            ffd_cuda.reset_launches()
            got, d_bank = ft.solve_scan_suffix(buf, d_bank, CK=CK, SUF=SUF,
                                               GL=GL, device=cuda_device,
                                               **ss)
            assert "ffd_bank_load" not in ffd_cuda.LAUNCHES
            assert ffd_cuda.LAUNCHES["unpack_bits"] == 1
            assert ffd_cuda.LAUNCHES["ffd_group_commit"] == SUF * CK
            assert ffd_cuda.LAUNCHES["pack_outputs"] == 1
            jr = GL // CK - SUF
            for nm, g, b in zip(ft.Carry._fields, d_bank, bank):
                assert torch.equal(g[jr], b[jr]), (GL, SUF, nm)
            plain, c_bank = ft.solve_scan_suffix(buf, c_bank, CK=CK,
                                                 SUF=SUF, GL=GL,
                                                 device="cpu", **ss)
            assert torch.equal(got.cpu(), plain), (GL, SUF)
            for nm, g, w in zip(ft.Carry._fields, d_bank, c_bank):
                assert torch.equal(g.cpu(), w), (GL, SUF, nm)
            sv = unpack_outputs1(got.cpu().numpy(), st["T"], st["D"],
                                 st["Z"], st["C"], SUF * CK, st["E"],
                                 st["P"], st["n_max"])
            s0 = GL - SUF * CK
            assert (sv["takes"] == full["takes"][s0:GL]).all()
            assert (sv["used"] == full["used"]).all()


def test_solver_on_card_matches_plain(cuda_device):
    from karpenter_provider_aws_tpu_torch.apis import labels as L
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    env = fenv.Environment()
    pods = (fenv.make_pods(300, cpu="250m", memory="512Mi", prefix="s")
            + fenv.make_pods(40, cpu="2", memory="4Gi", prefix="a",
                             node_selector={L.ARCH: "arm64"}))
    snap = env.snapshot(pods, [env.nodepool("p", limits={"cpu": "200"})])
    gpu = CUDASolver()
    got = gpu.solve(snap)
    assert sum(gpu.last_dispatch_stats["launches"].values()) > 0
    assert got.decision_fingerprint() == \
        CUDASolver(device="cpu").solve(snap).decision_fingerprint()


def test_warm_ticks_on_card_match_from_scratch(cuda_device):
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    snapshot, tick = examples.warm_cluster(pods=2000)
    warm, cold = CUDASolver(), CUDASolver(device="cpu", incremental=False)
    modes = []
    for t in range(16):
        tick(binds=t < 12)
        snap = snapshot()
        assert warm.solve(snap).decision_fingerprint() == \
            cold.solve(snap).decision_fingerprint(), t
        modes.append(warm.last_phase_stats["solve"])
    assert modes[12:] == ["suffix@3"] * 4
    launches = warm.last_dispatch_stats["launches"]
    assert launches["unpack_bits"] == launches["pack_outputs"] == 1
    assert launches.get("ffd_bank_load", 0) == 0
    assert launches.get("ffd_bank_store", 0) == 0


# ---------------------------------------------------------------------------
# K2 on its lane axis, and the K7 consolidation kernels
# ---------------------------------------------------------------------------

def _t(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.parametrize("case", ["base", "existing", "min_values",
                                  "two_pools"])
def test_lane_axis_one_lane_is_the_plain_scan(cuda_device, case):
    """lanes=1 (every field per lane, stride of one solve) gives the
    bytes of the scan without a lane axis, and the same new-node table
    after each headroom launch."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    buf, st, n_i64, n_bits = _arena(case, cuda_device)
    inp = _inputs(buf, st, n_i64, n_bits)
    E, P, V = st["E"], st["P"], st["V"]
    one = ffd_cuda.ScanState(inp, ft.carry0(inp, E + st["n_max"], E),
                             E=E, P=P, V=V)
    lane_inp = inp._replace(**{f: getattr(inp, f)[None] for f in (
        "avail_zc", "R", "n", "F", "agz", "agc", "admit", "daemon",
        "ex_alloc", "ex_compat")})
    lanes = ffd_cuda.ScanState(
        lane_inp, ft.carry0(inp, E + st["n_max"], E, lanes=1), E=E, P=P,
        V=V, lanes=1)
    for g in range(st["G"]):
        for s in (one, lanes):
            ffd_cuda.ffd_slot_headroom(s, g)
        if not st["K"]:
            _assert_table([x[0] for x in lanes.table()], one.table(), g)
        for s in (one, lanes):
            ffd_cuda.ffd_group_commit(s, g)
    for a, b in zip(one.carry, lanes.carry):
        assert torch.equal(a, b[0])
    assert torch.equal(one.takes, lanes.takes[0])
    assert torch.equal(one.leftover, lanes.leftover[0])


# every shape the commit's rule can pick, and the headroom's rows a warp
K2_SHAPES = [(8, 512), (4, 512), (2, 512), (1, 512), (1, 256)]
LAYOUTS = [dict(rows=1), dict(warps=8), dict(rows=3), dict(warps=2),
           dict(rows=16)]


def test_k2_shape_rule_by_lane_count(cuda_device):
    """The commit's rule: a cluster of 8 CTAs of 512 threads at one lane,
    one CTA of 256 threads a lane at 2,048 lanes, one CTA a lane with
    minValues floors; asked once a shape and device."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    assert ffd_cuda.k2_shape(1, 0, 0, 1, 8, 256, cuda_device) == (8, 512)
    assert ffd_cuda.k2_shape(2048, 0, 0, 2, 8, 1026, cuda_device) == (1, 256)
    assert ffd_cuda.k2_shape(1, 2, 3, 1, 8, 256, cuda_device)[0] == 1


@pytest.mark.parametrize("case", ["existing", "min_values", "pool_limits",
                                  "slots_run_out", "two_pools"])
def test_k2_commit_shapes_agree(cuda_device, case):
    """The whole scan step by step with the commit forced onto every
    (CTAs, threads) shape of the rule (one CTA only with minValues
    floors) and the headroom at 1, 3 and 16 rows a warp and at 2 and 8
    warps a row: every launch equals the plain step. n_max = 37 slots do
    not split evenly over 2, 4 or 8 CTAs."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    inp = _inputs(*_arena(case, cuda_device, n_max=37))
    st = _arena(case, "cpu", n_max=37)[1]
    E, P, V, G = st["E"], st["P"], st["V"], st["G"]
    N = E + st["n_max"]
    shapes = [(1, 512), (1, 256)] if st["K"] else K2_SHAPES
    for i, (cs, nt) in enumerate(shapes):
        carry = ft.carry0(inp, N, E)
        state = ffd_cuda.ScanState(inp, ft.carry0(inp, N, E), E=E, P=P, V=V,
                                   cluster=cs, threads=nt,
                                   **LAYOUTS[i % len(LAYOUTS)])
        for g in range(G):
            ffd_cuda.ffd_slot_headroom(state, g)
            ffd_cuda.ffd_group_commit(state, g)
            assert (state.cluster, state.threads) == (cs, nt)
            carry, take, n_rem = ft._group_step_ref(inp, carry, g, E=E,
                                                    P=P, V=V)
            for f, got, want in zip(ft.Carry._fields, state.carry, carry):
                assert torch.equal(got, want), (cs, nt, g, f)
            assert torch.equal(state.takes[g], take.to(torch.int32))
            assert int(state.leftover[g]) == int(n_rem), (cs, nt, g)


@pytest.mark.parametrize("case", ["existing", "min_values", "two_pools"])
def test_k2_round_of_2048_lanes(cuda_device, case):
    """2,048 lanes of one arena whose pod counts differ lane by lane
    (seven patterns), through the rule's own shapes (one CTA of 256
    threads a lane at this lane count, several rows a warp): each lane's
    takes, leftover and carry equal the plain scan of its pattern; the
    minValues case takes the K > 0 branch of both kernels."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    B, npat = 2048, 7
    buf, st, n_i64, n_bits = _arena(case, cuda_device, n_max=24)
    inp = _inputs(buf, st, n_i64, n_bits)
    E, P, V, G = st["E"], st["P"], st["V"], st["G"]
    N = E + st["n_max"]
    pat = torch.arange(B, device=cuda_device) % npat
    n_l = (inp.n[None, :] * (pat[:, None] + 1)) // 3
    fields = ("avail_zc", "R", "F", "agz", "agc", "admit", "daemon",
              "ex_alloc", "ex_compat")
    lane_inp = inp._replace(n=n_l.contiguous(), **{
        f: getattr(inp, f)[None].expand((B,) + getattr(inp, f).shape)
        .contiguous() for f in fields})
    state = ffd_cuda.ScanState(lane_inp, ft.carry0(inp, N, E, lanes=B),
                               E=E, P=P, V=V, lanes=B)
    ffd_cuda.k2_steps(state, 0, G)
    assert state.cluster == 1
    for p in range(npat):
        takes, left, carry = ft._solve_scan_ref(
            inp._replace(n=n_l[p]), st["n_max"], E, P, V)
        idx = torch.nonzero(pat == p).reshape(-1)
        assert torch.equal(state.takes[idx],
                           takes.to(torch.int32)[None].expand(
                               (idx.numel(),) + takes.shape)), p
        assert torch.equal(state.leftover[idx],
                           left[None].expand(idx.numel(), -1)), p
        for f, got, want in zip(ft.Carry._fields, state.carry, carry):
            assert torch.equal(got[idx], want[None].expand(
                (idx.numel(),) + want.shape)), (p, f)


@pytest.mark.parametrize("hazard", examples.SUBSET_HAZARDS)
def test_subset_kernels_match_plain(cuda_device, hazard):
    """subset_gather, five lanes of the K2 kernels step by step (the last
    commit with the summary rows) and the whole subset round against the
    plain versions."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    arena, tprice, lanes, st = examples.subset_case(hazard, seed=4)
    inp = ft.kernel_inputs_from_numpy(arena, cuda_device)
    tp = torch.from_numpy(tprice).to(cuda_device)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in lanes.items()}
    g_k = cc.subset_gather(inp, t["gid"], t["n"], t["dead"], t["keep"])
    g_p = ct._subset_gather_ref(inp, t["gid"], t["n"], t["dead"], t["keep"])
    for f in ct.LANE_FIELDS:
        assert torch.equal(getattr(g_k, f), getattr(g_p, f)), f
    E, P, N = st["E"], st["P"], st["E"] + st["n_max"]
    B = 5
    sub = g_k._replace(**{f: getattr(g_k, f)[:B].contiguous()
                          for f in ct.LANE_FIELDS})
    state = ffd_cuda.ScanState(sub, ft.carry0(sub, N, E, lanes=B), E=E,
                               P=P, lanes=B)
    carries = [ft.carry0(ct.lane_inputs(sub, b), N, E) for b in range(B)]
    keep5, rp5 = t["keep"][:B].contiguous(), t["removed_price"][:B]
    args, rows = cc.summary_args(state, keep5, tp, rp5)
    Gq = sub.R.shape[1]
    for g in range(Gq):
        ffd_cuda.ffd_slot_headroom(state, g)
        tab = state.table()
        for b in range(B):
            cand, k = ft._slot_headroom_ref(ct.lane_inputs(sub, b),
                                            carries[b], g, E=E, P=P, V=0)
            assert torch.equal(state.cand[b], cand), (g, b)
            assert torch.equal(state.k[b], k), (g, b)
            _assert_table([x[b] for x in tab], ft._new_node_table_ref(
                ct.lane_inputs(sub, b), g, P=P), (g, b))
        ffd_cuda.ffd_group_commit(state, g,
                                  summary=args if g == Gq - 1 else None)
        for b in range(B):
            carries[b], take, n_rem = ft._group_step_ref(
                ct.lane_inputs(sub, b), carries[b], g, E=E, P=P, V=0)
            for f, got, want in zip(ft.Carry._fields, state.carry,
                                    carries[b]):
                assert torch.equal(got[b], want), (g, b, f)
            assert torch.equal(state.takes[b, g], take.to(torch.int32))
            assert int(state.leftover[b, g]) == int(n_rem)
    want = ct._subset_summary_ref(state.leftover, state.carry.num_nodes,
                                  state.carry.types, keep5, tp, rp5, E)
    assert torch.equal(rows, want)
    ffd_cuda.reset_launches()
    whole = ct.subset_solve(inp, tp, t["gid"], t["n"], t["dead"], t["keep"],
                            t["removed_price"], **st)
    assert {k: v for k, v in ffd_cuda.LAUNCHES.items() if v} == dict(
        subset_gather=1, ffd_slot_headroom=Gq, ffd_group_commit=Gq)
    plain = ct._subset_solve_ref(inp, tp, t["gid"], t["n"], t["dead"],
                                 t["keep"], t["removed_price"], **st)
    assert torch.equal(whole, plain)


def test_subset_round_past_grid_y(cuda_device):
    """65,552 lanes (16 tiled 4,097 times), more than grid y's 65,535
    blocks (subset_gather and ffd_slot_headroom spread the lane over grid
    y and z): the gathered lanes and the rows equal the plain versions'
    on the 16 lanes, tiled the same way."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    arena, tprice, lanes, st = examples.subset_case("dead_nodes", seed=5)
    reps = 4097
    inp = ft.kernel_inputs_from_numpy(arena, cuda_device)
    tp = torch.from_numpy(tprice).to(cuda_device)
    order = ("gid", "n", "dead", "keep", "removed_price")
    one = [torch.from_numpy(lanes[k]).to(cuda_device) for k in order]
    tiled = examples.tile_lanes(lanes, reps)
    many = [torch.from_numpy(tiled[k]).to(cuda_device) for k in order]

    def rep(x):
        return x.repeat((reps,) + (1,) * (x.dim() - 1))
    g_k = cc.subset_gather(inp, *many[:4])
    g_p = ct._subset_gather_ref(inp, *one[:4])
    for f in ct.LANE_FIELDS:
        assert torch.equal(getattr(g_k, f), rep(getattr(g_p, f))), f
    del g_k
    assert torch.equal(ct.subset_solve(inp, tp, *many, **st),
                       rep(ct._subset_solve_ref(inp, tp, *one, **st)))


def _summary_commit(cc, ffd_cuda, inp, tp, t, st, B, cs=None, nt=None):
    """The first B lanes of a subset round gathered and scanned on the
    card up to the last group's headroom, on ``cs`` CTAs of ``nt``
    threads a lane (default the rule's); then the last commit without and
    with the summary rows from the same state: (the rows, their plain
    version from the scan's own leftover, num_nodes and types, whether
    the carry, takes and leftover of the two commits agree)."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    E, P = st["E"], st["P"]
    g_k = cc.subset_gather(inp, *(t[k][:B].contiguous() for k in
                                  ("gid", "n", "dead", "keep")))
    state = ffd_cuda.ScanState(g_k, ft.carry0(g_k, E + st["n_max"], E,
                                              lanes=B), E=E, P=P, lanes=B,
                               cluster=cs, threads=nt)
    Gq = t["gid"].shape[1]
    ffd_cuda.k2_steps(state, 0, Gq - 1)
    ffd_cuda.ffd_slot_headroom(state, Gq - 1)
    scratch = list(state.carry) + [state.k, state.cand]
    before = [x.clone() for x in scratch]

    def restore():
        for dst, src in zip(scratch, before):
            dst.copy_(src)
    ffd_cuda.ffd_group_commit(state, Gq - 1)
    plain = [x.clone() for x in state.carry] + [state.takes.clone(),
                                                 state.leftover.clone()]
    restore()
    keep, rp = t["keep"][:B].contiguous(), t["removed_price"][:B]
    args, rows = cc.summary_args(state, keep, tp, rp)
    n0 = dict(ffd_cuda.LAUNCHES)
    ffd_cuda.ffd_group_commit(state, Gq - 1, summary=args)
    assert ffd_cuda.LAUNCHES == dict(
        n0, ffd_group_commit=n0["ffd_group_commit"] + 1)
    same = all(torch.equal(a, b) for a, b in zip(
        list(state.carry) + [state.takes, state.leftover], plain))
    want = ct._subset_summary_ref(state.leftover, state.carry.num_nodes,
                                  state.carry.types, keep, tp, rp, E)
    return rows, want, same, (state.cluster, state.threads)


@pytest.mark.parametrize("hazard", examples.SUBSET_HAZARDS)
def test_commit_summary_rows_on_every_shape(cuda_device, hazard):
    """The subset round's last ``ffd_group_commit`` with the summary rows
    at T = 813 and E = 37 (the lanes' t0 rows at many offsets mod 16), on
    every commit shape (1, 2, 4, 8 CTAs of 256 and 512 threads) and on
    the rule's at 16 lanes and at one lane (a cluster of 8): the rows
    equal ``_subset_summary_ref`` of the scan's own leftover, num_nodes
    and types, and the commit's carry, takes and leftover equal those of
    the commit without them."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    arena, tprice, lanes, st = examples.subset_case(
        hazard, examples.SUBSET_HAZARDS.index(hazard), T=813, Ep=37)
    inp = ft.kernel_inputs_from_numpy(arena, cuda_device)
    tp = torch.from_numpy(tprice).to(cuda_device)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in lanes.items()}
    B = lanes["gid"].shape[0]
    shapes = [(cs, nt) for cs in (1, 2, 4, 8) for nt in (256, 512)]
    for B_, cs, nt in [(B, cs, nt) for cs, nt in shapes] + [(B, None, None),
                                                            (1, None, None)]:
        rows, want, same, shape = _summary_commit(cc, ffd_cuda, inp, tp, t,
                                                  st, B_, cs, nt)
        assert torch.equal(rows, want), (B_, shape)
        assert same, (B_, shape)
        if B_ == 1 and cs is None:
            assert shape == (8, 512)


def test_commit_summary_round_widths(cuda_device):
    """Round (a)'s lanes and widths (2,048 lanes, T = 812, E = 1,024,
    one group; the rule's one CTA of 256 threads a lane) and round (b)'s
    (128 lanes of 128 groups): the summary rows equal the plain version's
    of the scan's own outputs, the commit's outputs those without them."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    for shp, B in ((dict(examples.GATHER_SHAPES[5], B=2048), 2048),
                   (dict(examples.GATHER_SHAPES[4], B=128), 128)):
        arena, tprice, lanes, st = examples.subset_case("dead_nodes", 5,
                                                        **shp)
        inp = ft.kernel_inputs_from_numpy(arena, cuda_device)
        tp = torch.from_numpy(tprice).to(cuda_device)
        t = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in lanes.items()}
        rows, want, same, shape = _summary_commit(cc, ffd_cuda, inp, tp, t,
                                                  st, B)
        assert torch.equal(rows, want), shape
        assert same, shape
        del inp, t
        torch.cuda.empty_cache()


def test_folded_entries_refuse_on_card(cuda_device):
    """The C entries refuse what the folds do not take, before any launch:
    a pack's store range at two lanes, a summary on a commit with
    minValues floors or with a membership record."""
    import ctypes
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    lib = ffd_cuda._lib()
    stream = torch.cuda.current_stream().cuda_stream
    takes, left, carry, _ = examples.pack_case(*examples.PACK_SHAPES[0], 2,
                                               seed=3, device=cuda_device)
    one = ft.Carry(*[f[0].contiguous() for f in carry])
    bs = ffd_cuda.BankState(one, ffd_cuda.empty_bank(one, 3))
    src = ffd_cuda.pack_sources(takes, left, carry)
    args = ffd_cuda._PackArgs(
        f_ptr=(ctypes.c_void_p * 5)(*[f[0].data_ptr()
                                      for f in src["fields"]]),
        f_len=(ctypes.c_longlong * 5)(*[f[1] for f in src["fields"]]),
        f_stride=(ctypes.c_longlong * 5)(*[f[2] for f in src["fields"]]),
        takes=src["takes"][0].data_ptr(), n32=src["takes"][1],
        takes_stride=src["takes"][2],
        seg_ptr=(ctypes.c_void_p * 4)(*[x[0].data_ptr()
                                        for x in src["segs"]]),
        seg_len=(ctypes.c_longlong * 4)(*[x[1] for x in src["segs"]]),
        seg_stride=(ctypes.c_longlong * 4)(*[x[2] for x in src["segs"]]),
        out=torch.empty((2, src["W"]), dtype=torch.int64,
                        device=cuda_device).data_ptr(),
        out_stride=src["W"], L=2)
    assert lib.karp_pack_outputs(ctypes.byref(args), ctypes.byref(bs.args),
                                 0, 1, stream) != 0
    arrays, mst = examples.example_case("min_values")
    minp = ft.kernel_inputs_from_numpy(arrays, cuda_device)
    st = ffd_cuda.ScanState(minp, ft.carry0(minp, mst["E"] + mst["n_max"],
                                            mst["E"]), E=mst["E"],
                            P=mst["P"], V=mst["V"])
    sm = cc._SummaryArgs()
    assert lib.karp_ffd_group_commit(ctypes.byref(st.kargs), 0, None,
                                     ctypes.byref(sm), stream) != 0
    arena, tprice, lanes, sst = examples.subset_case("plain", 0)
    inp = ft.kernel_inputs_from_numpy(arena, cuda_device)
    st0 = ffd_cuda.ScanState(inp, ft.carry0(inp, sst["E"] + sst["n_max"],
                                            sst["E"]), E=sst["E"],
                             P=sst["P"])
    assert lib.karp_ffd_group_commit(ctypes.byref(st0.kargs), 0,
                                     ctypes.byref(ffd_cuda._RecordArgs()),
                                     ctypes.byref(sm), stream) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("T", [813, 37, 9])
def test_pack_restamp_rows_at_odd_offsets(cuda_device, T):
    """The pack with a store range of one to four rows of a bank of
    seven, at odd widths (T = 813, 37 and 9 with Z = 3, D = 7, N odd: the
    rows start at every offset mod 16, the carry's fields at their own):
    the output row equals the plain pack, rows [j, j + count) the plain
    store, the other rows keep their bytes; one CUDA kernel a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    buf, st, n_i64, n_bits = _arena("existing", cuda_device, T=T, n_max=13,
                                    D=7)
    inp = _inputs(buf, st, n_i64, n_bits)
    E, P, V, G = st["E"], st["P"], st["V"], st["G"]
    takes, left, carry = ft._solve_scan_ref(inp, st["n_max"], E, P, V)
    rows = 7
    bs = ffd_cuda.BankState(carry, ffd_cuda.empty_bank(carry, rows))
    for j, count in ((0, 1), (1, 3), (3, 4), (6, 1), (2, 2)):
        for b in bs.bank:
            b.random_(0, 2)
        want = ft.Carry(*[b.clone() for b in bs.bank])
        ft._bank_store_ref(want, carry, j, count)
        out = ffd_cuda.pack_outputs(takes, left, carry,
                                    store=(bs, j, count))
        assert torch.equal(out, ft._pack_outputs_ref(takes, left, carry))
        for nm, got, w in zip(ft.Carry._fields, bs.bank, want):
            assert torch.equal(got, w), (j, count, nm)

    def fn():
        return ffd_cuda.pack_outputs(takes, left, carry, store=(bs, 1, 3))
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace with no device event at all: again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if dev:
            break
    assert len(dev) == 1 and "pack_outputs" in dev[0], dev


@pytest.mark.parametrize("hazard", examples.SUBSET_HAZARDS)
@pytest.mark.parametrize("shape", range(len(examples.GATHER_SHAPES)))
def test_subset_gather_odd_shapes(cuda_device, shape, hazard):
    """subset_gather at ``GATHER_SHAPES``' odd shapes (rows of T and E not
    multiples of 16, D odd, Gq = 1 and 128, round (a)'s widths) against
    the plain gather, and its grid the rule of ``gather_ctas``."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    shp = examples.GATHER_SHAPES[shape]
    arena, _, lanes, _ = examples.subset_case(hazard, shape, **shp)
    inp = ft.kernel_inputs_from_numpy(arena, cuda_device)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in lanes.items()}
    g_k = cc.subset_gather(inp, t["gid"], t["n"], t["dead"], t["keep"])
    g_p = ct._subset_gather_ref(inp, t["gid"], t["n"], t["dead"], t["keep"])
    for f in ct.LANE_FIELDS:
        assert torch.equal(getattr(g_k, f), getattr(g_p, f)), f
    args, _ = cc.gather_args(inp, t["gid"], t["dead"], t["keep"])
    X, slots = cc.subset_gather_grid(args)
    B, Gq = lanes["gid"].shape
    assert slots > 0 and X == cc.gather_ctas(B, cc.gather_lane_bytes(
        shp["T"], shp["Z"] * shp["C"], shp["D"], shp["Z"], shp["C"],
        shp["P"], shp["Ep"], Gq), slots)


def test_subset_gather_odd_shape_past_grid_y(cuda_device):
    """65,552 lanes of the first odd shape (T = 813, D = 7, E = 37): the
    gathered lanes equal the plain gather's, lane chunk by chunk."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    arena, _, lanes, _ = examples.subset_case(
        "dead_nodes", 7, **examples.GATHER_SHAPES[0])
    inp = ft.kernel_inputs_from_numpy(arena, cuda_device)
    reps = -(-65_552 // lanes["gid"].shape[0])
    tiled = examples.tile_lanes(lanes, reps)
    t = {k: torch.from_numpy(v[:65_552]).to(cuda_device)
         for k, v in tiled.items()}
    g_k = cc.subset_gather(inp, t["gid"], t["n"], t["dead"], t["keep"])
    for b0 in range(0, 65_552, 8_192):
        sl = {k: v[b0:b0 + 8_192] for k, v in t.items()}
        g_p = ct._subset_gather_ref(inp, sl["gid"], sl["n"], sl["dead"],
                                    sl["keep"])
        for f in ct.LANE_FIELDS:
            assert torch.equal(getattr(g_k, f)[b0:b0 + 8_192],
                               getattr(g_p, f)), (b0, f)


@pytest.mark.parametrize("hazard", examples.ABSORB_HAZARDS)
@pytest.mark.parametrize("E", [32, 4096])
def test_consol_absorb_matches_plain(cuda_device, hazard, E):
    """The three modes against the plain versions; E=4096 puts the used
    carry (256 KB) in the global scratch instead of shared memory."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    a = _t(cuda_device, *examples.absorb_case(hazard, 3, E=E))
    ps = _t(cuda_device, *examples.prescreen_tables(3))
    dn = _t(cuda_device, *examples.dense_case(hazard, 3, E=E))
    ffd_cuda.reset_launches()
    assert torch.equal(ct.deletions_feasible(*a),
                       ct._deletions_feasible_ref(*a))
    assert torch.equal(ct.replacements_prescreen(*a[:4], *ps[:5], *a[4:],
                                                 ps[5]),
                       ct._replacements_prescreen_ref(*a[:4], *ps[:5],
                                                      *a[4:], ps[5]))
    assert torch.equal(ct.deletions_feasible_dense(*dn),
                       ct._deletions_feasible_dense_ref(*dn))
    assert {k: v for k, v in ffd_cuda.LAUNCHES.items() if v} == dict(
        consol_absorb_deletions=1, consol_absorb_prescreen=1,
        consol_absorb_dense=1)


#: the absorption scan's forms forced by shape: E with the form that
#: gives (csrc/consolidation.cu; D = 8)
ABSORB_FORM_SHAPES = {"registers": 1000, "registers_full": 1024,
                      "shared": 1100, "shared_wide": 2048, "global": 4096}


@pytest.mark.parametrize("shape", list(ABSORB_FORM_SHAPES))
@pytest.mark.parametrize("hazard", examples.ABSORB_HAZARDS)
def test_consol_absorb_forms_match_plain(cuda_device, hazard, shape):
    """The three K7 modes in each form of the redesigned scan (rows in
    registers, in shared memory, in the global scratch) against the plain
    versions, one launch each."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    E = ABSORB_FORM_SHAPES[shape]
    want = {"registers": 0, "registers_full": 0, "shared": 1,
            "shared_wide": 1, "global": 2}[shape]
    assert cc.absorb_form(E, 8) == want
    a = _t(cuda_device, *examples.absorb_case(hazard, 5, E=E, G=6))
    ps = _t(cuda_device, *examples.prescreen_tables(5))
    dn = _t(cuda_device, *examples.dense_case(hazard, 5, E=E, G=6))
    names = ("ex_alloc", "ex_used0", "compat", "R", "gid", "cid", "n",
             "alive")
    kw = dict(zip(names, a))
    ffd_cuda.reset_launches()
    assert torch.equal(cc.consol_absorb("deletions", **kw),
                       ct._deletions_feasible_ref(*a))
    pkw = dict(kw, **dict(zip(("type_alloc", "type_price", "tcompat",
                               "padmit", "pool_types", "price_cap"), ps)))
    assert torch.equal(cc.consol_absorb("prescreen", **pkw),
                       ct._replacements_prescreen_ref(*a[:4], *ps[:5],
                                                      *a[4:], ps[5]))
    assert torch.equal(cc.consol_absorb(
        "dense", **dict(zip(("ex_alloc", "ex_used0", "compat", "R", "n"),
                            dn))),
        ct._deletions_feasible_dense_ref(*dn))
    assert {k: v for k, v in ffd_cuda.LAUNCHES.items() if v} == dict(
        consol_absorb_deletions=1, consol_absorb_prescreen=1,
        consol_absorb_dense=1)


@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("hazard", ["plain", "zero_r_row", "overcommitted"])
def test_consol_absorb_lane_counts(cuda_device, hazard, B):
    """One lane and 256 lanes (rows in registers at 200 and 1,000 nodes,
    in shared memory at 1,500), every K7 mode against the plain
    versions."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    for E in (200, 1000, 1500):
        a = _t(cuda_device, *examples.absorb_case(hazard, 6, B=B, E=E))
        ps = _t(cuda_device, *examples.prescreen_tables(6, B=B))
        dn = _t(cuda_device, *examples.dense_case(hazard, 6, B=B, E=E))
        assert torch.equal(ct.deletions_feasible(*a),
                           ct._deletions_feasible_ref(*a))
        pa = (*a[:4], *ps[:5], *a[4:], ps[5])
        assert torch.equal(ct.replacements_prescreen(*pa),
                           ct._replacements_prescreen_ref(*pa))
        assert torch.equal(ct.deletions_feasible_dense(*dn),
                           ct._deletions_feasible_dense_ref(*dn))


@pytest.mark.parametrize("G", [2, 16, 64, 256])
def test_preempt_wide_waves_match_plain(cuda_device, G):
    """K8 at the preemption round's width (64 lanes, 1,000 nodes, D = 6)
    for the waves of G groups against the plain version; one launch."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch
    for hazard in ("plain", "zero_r_row", "overcommitted"):
        t = _t(cuda_device, *examples.preempt_case(hazard, 2, E=1000, G=G,
                                                   D=6, B=64))
        ffd_cuda.reset_launches()
        got = cc.preempt_absorb(*t)
        assert dict(ffd_cuda.LAUNCHES)["consol_absorb_preempt"] == 1
        assert torch.equal(got, preempt_torch._preempt_solve_ref(*t)), hazard


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_preempt_wide_values(cuda_device, seed, small):
    """K8 where the scan's quotients leave their fp64 range: slacks past
    2^51 (floordiv_rcp), or small slacks (rows kept as fp64) with R past
    2^51 and a group with a negative R (the rows back to int64), in
    registers (45 and 700 nodes) and in shared memory (1,100), against the
    plain version."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch
    for E in (45, 700, 1100):
        t = _t(cuda_device, *examples.preempt_wide_values(seed, E=E,
                                                           small=small))
        want = preempt_torch._preempt_solve_ref(*t)
        assert torch.equal(cc.preempt_absorb(*t), want), E


@pytest.mark.parametrize("B", [1, 200])
def test_preempt_lane_counts(cuda_device, B):
    """K8 on one lane and on 200 (rows in registers, in shared memory at
    1,500 nodes, in the global scratch at 4,096), against the plain
    version."""
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch
    for E in (32, 1000, 1500, 4096):
        t = _t(cuda_device, *examples.preempt_case("refund_above_used", 3,
                                                   E=E, G=8, B=B))
        assert torch.equal(preempt_torch.preempt_solve(*t),
                           preempt_torch._preempt_solve_ref(*t)), E


def test_absorb_no_lanes_and_no_groups(cuda_device):
    """B = 0: every mode launches nothing and answers an empty [0] (the
    plain versions' answer; a launch of no blocks is refused by CUDA). G =
    0 at B >= 1: one launch each, equal to the plain versions (every lane
    feasible, no leftover pods)."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch
    a = _t(cuda_device, *examples.absorb_case("plain", 7))
    ps = _t(cuda_device, *examples.prescreen_tables(7))
    dn = _t(cuda_device, *examples.dense_case("plain", 7))
    pr = _t(cuda_device, *examples.preempt_case("plain", 7))
    cuts = {
        "B=0": (lambda x: x[:0], lambda x: x[:0]),
        "G=0": (lambda x: x, lambda x: x[:, :0]),
    }
    for what, (lanes, groups) in cuts.items():
        sa = [*a[:4], *(groups(lanes(x)) for x in a[4:7]), lanes(a[7])]
        pa = (*sa[:4], *ps[:5], *sa[4:], lanes(ps[5]))
        sd = [lanes(x) for x in dn[:2]] + [groups(lanes(x)) for x in dn[2:]]
        gp = (lambda x: x[:0]) if what == "G=0" else (lambda x: x)
        sp = [*pr[:2], *(gp(x) for x in pr[2:5]), lanes(pr[5])]
        ffd_cuda.reset_launches()
        got = [ct.deletions_feasible(*sa), ct.replacements_prescreen(*pa),
               ct.deletions_feasible_dense(*sd),
               preempt_torch.preempt_solve(*sp)]
        torch.cuda.synchronize()
        want = [ct._deletions_feasible_ref(*sa),
                ct._replacements_prescreen_ref(*pa),
                ct._deletions_feasible_dense_ref(*sd),
                preempt_torch._preempt_solve_ref(*sp)]
        for x, y in zip(got, want):
            assert x.device.type == "cuda" and torch.equal(x, y), what
        n = sum(v for k, v in ffd_cuda.LAUNCHES.items()
                if k.startswith("consol_absorb"))
        assert n == (0 if what == "B=0" else 4), what


def test_absorb_refuses_a_form_its_shapes_do_not_take(cuda_device):
    """Rows in registers past 4 a thread (E = 2,000): the C entry refuses
    the launch with an error, runs nothing and writes nothing."""
    import ctypes
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    t = _t(cuda_device, *examples.preempt_case("plain", 8, E=2000, B=2))
    total = torch.full((2,), -7, dtype=torch.int64, device=cuda_device)
    args = cc._AbsorbArgs(
        ex_alloc=cc._ptr(t[0]), ex_used0=cc._ptr(t[1]), compat=cc._ptr(t[2]),
        R=cc._ptr(t[3]), n=cc._ptr(t[4]), freed=cc._ptr(t[5]),
        total=cc._ptr(total), B=2, G=t[3].shape[0], E=2000, D=t[0].shape[1],
        form=0)
    err = ffd_cuda._lib().karp_consol_absorb(ctypes.byref(args), 3, None)
    torch.cuda.synchronize()
    assert err != 0
    assert total.tolist() == [-7, -7]


@pytest.mark.parametrize("B", [0, 4])
def test_subset_round_of_no_groups(cuda_device, B):
    """A subset round of zero groups (Gq = 0) launches nothing and
    answers the plain version's rows, [0, 0, 0, 0, removed_price] a lane;
    with no lanes an empty [0, 5]."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    arena, tprice, lanes, st = examples.subset_case("dead_nodes", 4, B=4)
    inp = ft.kernel_inputs_from_numpy(arena, cuda_device)
    tp = torch.from_numpy(tprice).to(cuda_device)
    t = {k: torch.from_numpy(v[:B]).to(cuda_device)
         for k, v in lanes.items()}
    t["gid"], t["n"] = t["gid"][:, :0], t["n"][:, :0]
    order = ("gid", "n", "dead", "keep", "removed_price")
    # a freed block of -1s where the rows' allocation may land
    del_me = torch.full((max(B, 1), 5), -1, dtype=torch.int64,
                        device=cuda_device)
    del del_me
    ffd_cuda.reset_launches()
    got = ct.subset_solve(inp, tp, *(t[k] for k in order), **st)
    torch.cuda.synchronize()
    assert not any(ffd_cuda.LAUNCHES.values())
    want = ct._subset_solve_ref(inp, tp, *(t[k] for k in order), **st) \
        if B else torch.zeros((0, 5), dtype=torch.int64, device=cuda_device)
    assert got.shape == (B, 5) and torch.equal(got, want)
    assert torch.equal(got[:, 4], t["removed_price"])
    assert not got[:, :4].any()


def test_consolidation_evaluator_on_card_matches_plain(cuda_device):
    """config 4 at 24 nodes: the three walks on the card equal the plain
    versions' walks, and the subset rows are equal lane for lane."""
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.solver.consolidation import \
        CUDAConsolidationEvaluator
    fenv.reset_pod_counter()
    base, cands = examples.config4(fenv.Environment(), n_nodes=24)
    gpu = CUDAConsolidationEvaluator()
    cpu = CUDAConsolidationEvaluator(device="cpu")
    rows = {}
    for ev in (gpu, cpu):
        inner = ev.solver.dispatch_subsets

        def keep(arrays, ev=ev, inner=inner, **kw):
            rows[ev.device.type] = inner(arrays, **kw)
            return rows[ev.device.type]
        ev.solver.dispatch_subsets = keep
    want = examples.single_consolidation_device(cpu, base, cands)
    assert examples.single_consolidation_device(gpu, base, cands) == want
    assert (rows["cuda"] == rows["cpu"]).all()
    assert examples.single_consolidation_batched(
        gpu, gpu.solver, base, cands) == want
    assert examples.multi_consolidation(gpu, gpu.solver, base,
                                        cands[-8:]) == \
        examples.multi_consolidation(cpu, cpu.solver, base, cands[-8:])


# ---------------------------------------------------------------------------
# K1 on the lane axis and the batched packed solve (K4)
# ---------------------------------------------------------------------------

def _stack(arenas, st, dev):
    return torch.stack([torch.from_numpy(pack_inputs1(
        a, *examples.pack_statics(st))) for a in arenas]).to(dev)


def test_k1_lane_axis_matches_plain(cuda_device):
    """One lane is the lane-free launch; three lanes of different
    contents, read out of a [B, W] stack (lanes W words apart), are the
    plain versions lane by lane; pack_outputs over lane stacks likewise."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    lanes, st = examples.pruned_lanes()
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    bufs = _stack(lanes, st, cuda_device)
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P))
    one = ffd_cuda.unpack_bits_lanes(bufs[:1, n_i64:], n_bits)
    assert torch.equal(one[0], ffd_cuda.unpack_bits(bufs[0, n_i64:],
                                                    n_bits))
    got = ffd_cuda.unpack_bits_lanes(bufs[:, n_i64:], n_bits)
    for b in range(3):
        assert torch.equal(got[b], ft._unpack_bits_ref(bufs[b, n_i64:],
                                                       n_bits))
    outs = []
    for b in range(3):
        inp = ft._packed_inputs_ref(bufs[b], T, D, Z, C, G, E, P, 0, 0, 0)
        outs.append(ft._solve_scan_ref(inp, st["n_max"], E, P))
    takes = torch.stack([o[0] for o in outs])
    lefts = torch.stack([o[1] for o in outs])
    carry = ft.Carry(*[torch.stack(f) for f in zip(*[o[2] for o in outs])])
    packed = ffd_cuda.pack_outputs_lanes(takes, lefts, carry)
    for b in range(3):
        assert torch.equal(packed[b], ft._pack_outputs_ref(*outs[b]))
    assert torch.equal(ffd_cuda.pack_outputs_lanes(takes[:1], lefts[:1],
                                                   ft.Carry(*[f[:1] for f in
                                                              carry]))[0],
                       ffd_cuda.pack_outputs(*outs[0]))


def _pack_rows(takes, left, carry, bail, lanes):
    """The plain version's rows of ``lanes`` (each with its bail word)."""
    rows = []
    for b in lanes:
        row = ft._pack_outputs_ref(takes[b], left[b],
                                   ft.Carry(*[f[b] for f in carry]))
        if bail is not None:
            row = torch.cat([row, bail[b].reshape(1).long()])
        rows.append(row)
    return torch.stack(rows)


@pytest.mark.parametrize("bail", [False, True])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("shape", examples.PACK_SHAPES)
def test_pack_outputs_odd_shapes(cuda_device, shape, L, bail):
    """``pack_outputs_lanes`` at ``examples.PACK_SHAPES`` (segments that
    straddle words, odd G*N, config 2's widths) on 1 and 3 lanes, with
    the pruned scan's bail word set and clear: lane by lane equal to the
    plain version; one launch a call; the one-lane wrapper too."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    takes, left, carry, bl = examples.pack_case(
        *shape, L, seed=sum(shape) + L, bail=bail, device=cuda_device)
    before = ffd_cuda.LAUNCHES["pack_outputs"]
    got = ffd_cuda.pack_outputs_lanes(takes, left, carry, bail=bl)
    assert ffd_cuda.LAUNCHES["pack_outputs"] == before + 1
    assert torch.equal(got, _pack_rows(takes, left, carry, bl, range(L)))
    one = ffd_cuda.pack_outputs(takes[0], left[0],
                                ft.Carry(*[f[0] for f in carry]))
    assert torch.equal(one, _pack_rows(takes, left, carry, None, [0])[0])


def test_pack_outputs_wide_lanes(cuda_device):
    """65,552 lanes (grid z > 1), sixteen distinct lanes repeated, with the
    bail word: every row equals its source lane's plain row."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    takes, left, carry, bl = examples.pack_case(37, 3, 2, 5, 3, 2, 3, 16,
                                                seed=4, bail=True,
                                                device=cuda_device)
    reps = 65_552 // 16

    def rep(t):
        return t.repeat((reps,) + (1,) * (t.dim() - 1))
    got = ffd_cuda.pack_outputs_lanes(rep(takes), rep(left),
                                      ft.Carry(*[rep(f) for f in carry]),
                                      bail=rep(bl))
    assert got.shape[0] == 65_552
    want = _pack_rows(takes, left, carry, bl, range(16))
    assert torch.equal(got.view(reps, 16, -1),
                       want[None].expand(reps, -1, -1))


def test_unpack_bits_load_is_one_kernel(cuda_device):
    """One call of the suffix's prologue (``unpack_bits_load``) at the
    catalog's width issues exactly one CUDA kernel, which unpacks the
    arena and loads the bank row: the profiler's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    buf, st, n_i64, n_bits = _arena("existing", cuda_device, T=813, G=4)
    inp = _inputs(buf, st, n_i64, n_bits)
    carry = ft.carry0(inp, st["E"] + st["n_max"], st["E"])
    bank = ffd_cuda.empty_bank(carry, 2)
    for b in bank:
        b.random_(0, 2)
    bs = ffd_cuda.BankState(carry, bank)
    words = buf[n_i64:]

    def fn():
        return ffd_cuda.unpack_bits_load(words, n_bits, bs, 1)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace with no device event at all: again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if dev:
            break
    assert len(dev) == 1 and "unpack_bits_load" in dev[0], dev
    for nm, got, w in zip(ft.Carry._fields, carry, ft.bank_row(bank, 1)):
        assert torch.equal(got, w), nm


def test_pack_outputs_is_one_kernel(cuda_device):
    """One call of ``pack_outputs`` and of ``pack_outputs_lanes`` with the
    bail word issues exactly one CUDA kernel (no casts, cat or copies):
    the profiler's device events of each call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    takes, left, carry, bl = examples.pack_case(*examples.PACK_SHAPES[-1], 2,
                                                seed=1, bail=True,
                                                device=cuda_device)
    one = ft.Carry(*[f[0] for f in carry])
    calls = (lambda: ffd_cuda.pack_outputs(takes[0], left[0], one),
             lambda: ffd_cuda.pack_outputs_lanes(takes, left, carry,
                                                 bail=bl))
    for fn in calls:
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a trace with no device event at all: again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            dev = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            if dev:
                break
        assert len(dev) == 1 and "pack_outputs" in dev[0], dev


@pytest.mark.parametrize("B", [1, 3])
def test_packed_many_on_card(cuda_device, B):
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    cases = [examples.example_case(c) for c in ("base", "daemon",
                                                "pool_limits")][:B]
    st = cases[0][1]
    bufs = _stack([a for a, _ in cases], st, cuda_device)
    ffd_cuda.reset_launches()
    got = ft.solve_scan_packed1_many(bufs, **examples.solve_statics(st))
    assert ffd_cuda.LAUNCHES["unpack_bits"] == 1
    assert ffd_cuda.LAUNCHES["pack_outputs"] == 1
    assert ffd_cuda.LAUNCHES["ffd_group_commit"] == st["G"]
    for b in range(B):
        plain = ft.solve_scan_packed1(bufs[b].cpu(),
                                      **examples.solve_statics(st))
        assert torch.equal(got[b].cpu(), plain)


# ---------------------------------------------------------------------------
# K5: the fused block scan
# ---------------------------------------------------------------------------

def _fused_inputs(arrays, st, dev):
    """(arena on ``dev``, its KernelInputs with the fuse flags)."""
    buf = torch.from_numpy(pack_inputs1(arrays, *examples.pack_statics(st)))
    buf = buf.to(dev)
    return buf, ft._packed_inputs_ref(
        buf, *(st[k] for k in "T D Z C G E P K M Q F".split()))


def _fused_blocks_on_card(dev, arrays, st, cluster, lanes=None):
    """Both K5 kernels of every block from the plain block-start carry of
    every lane, on ``cluster`` CTAs a lane (None: the card's rule): the
    per-group candidates, headroom and new-node tables after the first,
    the carry, takes and leftover of the block after the second.
    ``arrays`` is one arena's (or, with ``lanes``, a list of them).
    Returns, per block, (whether lane 0 took the vectorized branch, lane
    0's plain entry and exit carries and takes)."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    E, P, Fu = st["E"], st["P"], st["F"]
    N = E + st["n_max"]
    per = [_fused_inputs(a, st, dev)[1]
           for a in (arrays if lanes else [arrays])]
    carries = [ft.carry0(x, N, E) for x in per]
    inp = per[0] if lanes is None else ft.KernelInputs(*[
        None if f[0] is None else torch.stack(f) for f in zip(*per)])
    fs = ffd_cuda.FusedState(inp, ft.carry0(inp, N, E, lanes=lanes), E=E,
                             P=P, Fu=Fu, lanes=lanes, cluster=cluster)
    assert cluster is None or fs.cluster == cluster
    indep = [ft.block_indep(x.fuse, Fu).tolist() for x in per]

    def lane(t, b):
        return t if lanes is None else t[b]
    seen = []
    for g0 in range(0, st["G"], Fu):
        for b, c in enumerate(carries):
            for dst, src in zip(fs.carry, c):
                lane(dst, b).copy_(src)
        ffd_cuda.ffd_fused_headroom(fs, g0)
        got_cand, got_k = fs.block_cand().clone(), fs.block_k().clone()
        got_tab = [t.clone() for t in fs.block_table()]
        ffd_cuda.ffd_fused_commit(fs, g0)
        for b, x in enumerate(per):
            what = (g0, b)
            cand, k = ft._fused_headroom_ref(x, carries[b], g0, Fu, E=E,
                                             P=P)
            tab = ft._fused_table_ref(x, g0, Fu, P=P)
            assert torch.equal(lane(got_cand, b), cand), what
            assert torch.equal(lane(got_k, b), k), what
            for got, want in zip(got_tab, tab[:3]):
                assert torch.equal(lane(got, b), want), what
            entry = carries[b]
            carries[b], takes, lefts = ft._fused_block_ref(
                x, entry, g0, Fu, indep[b][g0 // Fu], tab, E=E, P=P)
            for f, got, want in zip(ft.Carry._fields, fs.carry, carries[b]):
                assert torch.equal(lane(got, b), want), (what, f)
            assert torch.equal(lane(fs.takes, b)[g0:g0 + Fu], takes), what
            assert torch.equal(lane(fs.leftover, b)[g0:g0 + Fu], lefts), what
            if b == 0:
                seen.append((indep[0][g0 // Fu], entry, carries[0], takes))
    return seen


@pytest.mark.parametrize("cluster", [1, 2, 8])
@pytest.mark.parametrize("case", examples.FUSED_CASES)
def test_fused_kernels_block_by_block(cuda_device, case, cluster):
    """Both K5 kernels of each block from the plain block-start carry,
    with the commit on 1, 2 and 8 CTAs: the per-group candidates,
    headroom and new-node tables after the first, the carry, takes and
    leftover of the block after the second; both branches."""
    arrays, st = examples.fused_case(case)
    seen = _fused_blocks_on_card(cuda_device, arrays, st, cluster)
    branches = {v for v, *_ in seen}
    assert branches == {True, False}


@pytest.mark.parametrize("case", ["striped", "wrap_n_rem"])
def test_fused_kernels_wide_table(cuda_device, case):
    """600 types: three table blocks a (group, pool), whose partial caps
    the commit reduces; the commit on 8 CTAs."""
    arrays, st = examples.fused_case(case, T=600)
    _fused_blocks_on_card(cuda_device, arrays, st, 8)


@pytest.mark.parametrize("n_max,cluster", [(6, 2), (6, 8), (14, 8), (38, 8)])
def test_fused_cluster_chunks_straddle(cuda_device, n_max, cluster):
    """N = E + n_max slots that do not split evenly over the cluster's
    CTAs (8 CTAs of 3 or 5 slots, the last CTAs short or empty): some
    sequential block fills slots on both sides of a CTA boundary, and
    some block opens a run of new nodes across one; every launch equals
    its plain part (both properties are the plain scan's, which
    tests/test_torch_newnode.py checks on the CPU)."""
    arrays, st = examples.fused_case("striped", n_max=n_max)
    N = st["E"] + n_max
    chunk = -(-N // cluster)
    assert N % cluster
    seen = _fused_blocks_on_card(cuda_device, arrays, st, cluster)
    straddle_fill = straddle_open = False
    for vec, entry, out, takes in seen:
        filled = torch.nonzero((takes > 0).any(0)).reshape(-1)
        if not vec and filled.numel():
            straddle_fill |= len({int(s) // chunk for s in filled}) > 1
        opened = torch.nonzero((entry.pool == -1) & (out.pool >= 0))
        if opened.numel():
            straddle_open |= len({int(s) // chunk for s in opened}) > 1
    assert straddle_fill and straddle_open


@pytest.mark.parametrize("case", examples.FUSED_CASES)
@pytest.mark.parametrize("width", [dict(), dict(T=300, G=32, n_max=48,
                                                D=8)])
def test_fused_packed_solve(cuda_device, case, width):
    """The fused packed solve on the card equals the plain one on the
    CPU, word for word, in 1 + 2*G/F + 1 launches."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    arrays, st = examples.fused_case(case, **width)
    buf = pack_inputs1(arrays, *examples.pack_statics(st))
    ffd_cuda.reset_launches()
    got = ft.solve_scan_packed1(buf, device=cuda_device,
                                **examples.solve_statics(st))
    blocks = st["G"] // st["F"]
    assert ffd_cuda.LAUNCHES == dict(dict.fromkeys(ffd_cuda.LAUNCHES, 0),
                                     unpack_bits=1, ffd_fused_headroom=blocks,
                                     ffd_fused_commit=blocks, pack_outputs=1)
    want = ft.solve_scan_packed1(buf, device="cpu",
                                 **examples.solve_statics(st))
    assert torch.equal(got.cpu(), want)


def _mixed_lanes(B):
    """B striped lanes whose blocks branch differently: every lane flips
    one block's flags (or none) and rolls the counts."""
    return examples.fused_mixed_lanes(B)


@pytest.mark.parametrize("B", [3, 8, 64])
def test_fused_many_on_card(cuda_device, B):
    """B striped lanes whose blocks branch differently, in one lane-axis
    dispatch (the cluster size by the card's rule): each row the plain
    single solve of its arena."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    lanes, st = _mixed_lanes(B)
    bufs = _stack(lanes, st, cuda_device)
    ind = torch.stack([ft.block_indep(torch.from_numpy(a["fuse"]), st["F"])
                       for a in lanes])
    assert (ind.any(0) & ~ind.all(0)).any()
    ffd_cuda.reset_launches()
    got = ft.solve_scan_packed1_many(bufs, **examples.solve_statics(st))
    assert ffd_cuda.LAUNCHES["ffd_fused_commit"] == st["G"] // st["F"]
    assert ffd_cuda.LAUNCHES["ffd_group_commit"] == 0
    for b in range(B):
        plain = ft.solve_scan_packed1(bufs[b].cpu(),
                                      **examples.solve_statics(st))
        assert torch.equal(got[b].cpu(), plain), b


def test_fused_round_past_grid_y(cuda_device):
    """65,552 lanes (16 mixed striped lanes repeated 4,097 times), more
    than grid y's 65,535 blocks: the fused commit's clusters spread the
    lane over grid y and z, and the cluster rule answers for the real
    lane count (hazard 57). One dispatch; each lane equals the plain
    solve of its arena."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    lanes, st = _mixed_lanes(16)
    small = _stack(lanes, st, "cpu")
    reps = examples.FUSED_WIDE_REPS
    ffd_cuda.reset_launches()
    got = ft.solve_scan_packed1_many(small.repeat(reps, 1).to(cuda_device),
                                     **examples.solve_statics(st))
    assert ffd_cuda.LAUNCHES["ffd_fused_commit"] == st["G"] // st["F"]
    plain = torch.stack([ft.solve_scan_packed1(
        small[b], **examples.solve_statics(st)) for b in range(16)])
    assert got.shape[0] == 16 * reps > 65535
    assert torch.equal(got.cpu(), plain.repeat(reps, 1))


@pytest.mark.parametrize("B", [8, 64])
def test_fused_mixed_lanes_block_by_block(cuda_device, B):
    """The B = 8 and 64 lanes of mixed branches block by block at the
    cluster size the card's rule picks for them."""
    lanes, st = _mixed_lanes(B)
    _fused_blocks_on_card(cuda_device, lanes, st, None, lanes=B)


def _headroom_rows_seen(inp, carry, g0, Fu, P, lanes=None):
    """Which kinds of slot rows a block's headroom meets: no group takes
    the row's pool, some do, all do; existing rows."""
    out = set()
    pools = carry.pool if lanes is None else carry.pool.reshape(-1)
    admit = inp.admit if lanes is None else inp.admit[0]
    for s, pool in enumerate(pools.tolist()):
        pc = min(max(pool, 0), P - 1)
        adm = [pool >= 0 and bool(admit[g0 + i, pc]) for i in range(Fu)]
        out.add("none" if not any(adm) else "all" if all(adm) else "some")
    return out


@pytest.mark.parametrize("shape", ["striped-812", "odd-n", "wide-zc"])
def test_fused_headroom_slot_ctas(cuda_device, shape):
    """``ffd_fused_headroom`` (one CTA a slot covering the block's Fu
    groups) block by block against ``_fused_headroom_ref`` and the tables
    against ``_fused_table_ref``, from the plain block-start carries of
    the plain scan: the striped shape at 812 types, N = E + 37 slots (no
    multiple of anything the launch splits by), 22 zones x 3 capacity
    types (the offering test without the 64-bit masks); rows no group
    takes (free, existing, an unadmitted pool) and rows some take."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    kw = {"striped-812": dict(T=812, D=8, G=32, n_max=64),
          "odd-n": dict(n_max=37), "wide-zc": dict(Z=22, C=3)}[shape]
    arrays, st = examples.fused_case("striped", **kw)
    _, inp = _fused_inputs(arrays, st, cuda_device)
    E, P, Fu, N = st["E"], st["P"], st["F"], st["E"] + st["n_max"]
    cpu = inp   # the plain parts on the same card tensors
    carry = ft.carry0(cpu, N, E)
    fs = ffd_cuda.FusedState(inp, ft.carry0(inp, N, E), E=E, P=P, Fu=Fu)
    indep = ft.block_indep(cpu.fuse, Fu).tolist()
    kinds = set()
    for g0 in range(0, st["G"], Fu):
        for dst, src in zip(fs.carry, carry):
            dst.copy_(src)
        ffd_cuda.ffd_fused_headroom(fs, g0)
        cand, k = ft._fused_headroom_ref(cpu, carry, g0, Fu, E=E, P=P)
        tab = ft._fused_table_ref(cpu, g0, Fu, P=P)
        assert torch.equal(fs.block_cand(), cand), g0
        assert torch.equal(fs.block_k(), k), g0
        for got, want in zip(fs.block_table(), tab[:3]):
            assert torch.equal(got, want), g0
        kinds |= _headroom_rows_seen(cpu, carry, g0, Fu, P)
        carry, _, _ = ft._fused_block_ref(cpu, carry, g0, Fu,
                                          indep[g0 // Fu], tab, E=E, P=P)
    assert {"none", "some"} <= kinds and E > 0


@pytest.mark.parametrize("Fu", [2, 8, 16])
def test_fused_headroom_group_chunks(cuda_device, Fu):
    """The headroom launch at 2, 8 and 16 groups a block (one pass over a
    slot's types covers up to 4; 8 take two, 16 four) against
    ``_fused_headroom_ref`` from the plain carry after 16 groups."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    arrays, st = examples.fused_case("striped", G=32)
    _, inp = _fused_inputs(arrays, st, cuda_device)
    E, P, N = st["E"], st["P"], st["E"] + st["n_max"]
    cpu = inp   # the plain parts on the same card tensors
    carry = ft.carry0(cpu, N, E)
    tab = None
    for g0 in range(0, 16, st["F"]):
        tab = ft._fused_table_ref(cpu, g0, st["F"], P=P)
        carry, _, _ = ft._fused_block_ref(
            cpu, carry, g0, st["F"],
            ft.block_indep(cpu.fuse, st["F"]).tolist()[g0 // st["F"]], tab,
            E=E, P=P)
    fs = ffd_cuda.FusedState(inp, ft.carry0(inp, N, E), E=E, P=P, Fu=Fu)
    for dst, src in zip(fs.carry, carry):
        dst.copy_(src)
    ffd_cuda.ffd_fused_headroom(fs, 16)
    cand, k = ft._fused_headroom_ref(cpu, carry, 16, Fu, E=E, P=P)
    assert torch.equal(fs.block_cand(), cand)
    assert torch.equal(fs.block_k(), k)
    assert "none" in _headroom_rows_seen(cpu, carry, 16, Fu, P)


def test_fused_headroom_blocks_rule_matches_the_card(cuda_device):
    """The headroom grid's Python mirror equals the C rule."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    for shape in ((256, 4, 8, 812), (37, 4, 2, 48), (64, 16, 1, 257)):
        assert ffd_cuda._lib().karp_ffd_fused_headroom_blocks(*shape) \
            == ffd_cuda.fused_headroom_blocks(*shape)


def test_fused_solver_on_card(cuda_device):
    """The striped cluster at 2,000 pods through ``CUDASolver()``: the
    fused kernels serve it, and the decisions equal the plain versions'
    and the unfused solve's on the card."""
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    snap = examples.striped_cluster(fenv.Environment(), n_pods=2000)
    gpu = CUDASolver(incremental=False)
    got = gpu.solve(snap)
    ds = gpu.last_dispatch_stats
    assert (ds["kernel"], ds["fuse"]) == ("fused", 4)
    assert ds["fused_blocks"] >= 22
    assert ds["launches"]["ffd_fused_commit"] == ds["scan_steps"]
    unfused = CUDASolver(incremental=False)
    unfused.dev_fuse = 1
    assert got.decision_fingerprint() == \
        unfused.solve(snap).decision_fingerprint()
    assert got.decision_fingerprint() == CUDASolver(
        device="cpu", incremental=False).solve(snap).decision_fingerprint()


# ---------------------------------------------------------------------------
# K6: the pruned scan
# ---------------------------------------------------------------------------

def _pruned_steps_on_card(dev, arrays, st, S, cluster=None, lanes=None,
                          rows=None):
    """Both K6 kernels against their plain parts, group by group from
    the plain carry: the probe (selection, candidates, headroom and the
    new-node table) against ``_pruned_probe_ref``, then the commit, the
    probe on ``rows`` selecting clusters of ``cluster`` CTAs a lane
    (None: the card's rule). ``arrays``
    is one arena's (or, with ``lanes``, a list of them, each lane from
    its own plain carry). Returns the probe's outputs of every step of
    lane 0, for comparing cluster sizes."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    N = E + st["n_max"]
    S = min(S, N)
    per = []
    for a in (arrays if lanes else [arrays]):
        buf = torch.from_numpy(pack_inputs1(a, *examples.pack_statics(
            st))).to(dev)
        per.append(ft._packed_inputs_ref(buf, T, D, Z, C, G, E, P, 0, 0, 0))
    inp = per[0] if lanes is None else ft.KernelInputs(*[
        None if f[0] is None else torch.stack(f) for f in zip(*per)])
    carries = [ft.carry0_pruned(x, N, E) for x in per]
    ps = ffd_cuda.PrunedState(inp, ft.carry0_pruned(inp, N, E, lanes=lanes),
                              E=E, P=P, S=S, lanes=lanes, cluster=cluster,
                              rows=rows)
    assert cluster is None or ps.cluster == cluster
    assert rows is None or ps.rows == rows

    def lane(t, b):
        return t if lanes is None else t[b]
    seen = []
    for g in range(G):
        for b, c in enumerate(carries):
            for dst, src in zip(ps.carry, c):
                lane(dst, b).copy_(src)
        ffd_cuda.ffd_pruned_probe(ps, g)
        got = [ps.sel.clone(), ps.cnt.clone(), ps.cand.clone(),
               ps.ks.clone()] + [t.clone() for t in ps.table()]
        seen.append([lane(x, 0) for x in got])
        ffd_cuda.ffd_pruned_commit(ps, g)
        for b, x in enumerate(per):
            sel, cnt, cand_s, k_s, tab = ft._pruned_probe_ref(
                x, carries[b], g, E=E, P=P, S=S)
            for i, want in enumerate((sel, cnt, cand_s, k_s) + tuple(tab)):
                assert torch.equal(lane(got[i], b), want), (g, b, i)
            carries[b], take, n_rem = ft._pruned_commit_ref(
                x, carries[b], g, sel, cnt, cand_s, k_s, tab, E=E, P=P, S=S)
            for f, kg, want in zip(ft.CarryP._fields, ps.carry, carries[b]):
                assert torch.equal(lane(kg, b), want), (g, b, f)
            assert torch.equal(lane(ps.takes, b)[g], take.to(torch.int32))
            assert torch.equal(lane(ps.leftover, b)[g:g + 1],
                               n_rem.reshape(1)), (g, b)
    return seen


@pytest.mark.parametrize("S", [1, 2, 64])
@pytest.mark.parametrize("case", examples.PRUNED_CASES)
def test_pruned_kernels_step_by_step(cuda_device, case, S):
    """Both kernels against their plain parts, group by group from the
    plain carry: the probe's selection, candidates, headroom and
    new-node table, then the commit."""
    arrays, st = examples.pruned_case(case)
    _pruned_steps_on_card(cuda_device, arrays, st, S)


@pytest.mark.parametrize("S", [1, 4, 64])
@pytest.mark.parametrize("case", examples.PRUNED_CASES)
def test_pruned_probe_cluster_sizes_agree(cuda_device, case, S):
    """The probe on 1, 2 and 8 CTAs a cluster with one selecting cluster
    a lane, and on 8 and 2 CTAs with 4 (the slots' chunks, the selected
    rows and the type chunks split several ways; hazard 59), writes
    identical outputs at every step, each equal to the plain part."""
    arrays, st = examples.pruned_case(case)
    seen = [_pruned_steps_on_card(cuda_device, arrays, st, S, cluster=cs,
                                  rows=nr)
            for cs, nr in ((1, 1), (2, 1), (8, 1), (8, 4), (2, 4))]
    for other in seen[1:]:
        for a, b in zip(seen[0], other):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", examples.PRUNED_CASES)
def test_pruned_probe_unaligned_rows(cuda_device, case):
    """27 types: a slot's type row is not 4-byte aligned, so the probe's
    screen reads it byte by byte; on 1 and 8 CTAs."""
    arrays, st = examples.pruned_case(case, T=27)
    for cs, nr in ((1, 1), (8, 4)):
        _pruned_steps_on_card(cuda_device, arrays, st, 4, cluster=cs,
                              rows=nr)


@pytest.mark.parametrize("shape", [dict(D=10, Z=5, C=4), dict(Z=9, C=4),
                                   dict(D=3, Z=13, C=5), dict(T=1030)])
@pytest.mark.parametrize("case", ["plain", "pool_limits", "zero_r_row"])
def test_pruned_probe_wide_rows(cuda_device, case, shape):
    """Rows wider than the probe's registers: 10 resources (the headroom's
    loop past eight) with 20 zone x capacity-type pairs (the offerings'
    bytes past sixteen); 36 pairs (two ballots a mask); 65 pairs (the
    masks give way to the any-overlaps and offering_ok); 1,030 types
    (the screen's overlap by bytes past 1,024). On the card's rule and on
    2 CTAs with 4 selecting clusters."""
    arrays, st = examples.pruned_case(case, **shape)
    for cs, nr in ((None, None), (2, 4)):
        _pruned_steps_on_card(cuda_device, arrays, st, 64, cluster=cs,
                              rows=nr)


@pytest.mark.parametrize("case", ["plain", "existing", "wrap_n_rem"])
def test_pruned_probe_passes(cuda_device, case):
    """S = N = 300 + E slots on one selecting cluster: its rows take two
    passes of 256; on 2 selecting clusters, one pass each."""
    arrays, st = examples.pruned_case(case, n_max=300)
    for cs, nr in ((8, 1), (2, 2)):
        _pruned_steps_on_card(cuda_device, arrays, st, st["E"] + 300,
                              cluster=cs, rows=nr)


def test_pruned_kernels_on_lanes(cuda_device):
    """Three lanes of different contents (``examples.pruned_lanes``) step
    by step, each lane from its own plain carry, at the card's cluster
    size and on 8 CTAs."""
    lanes, st = examples.pruned_lanes()
    for cs in (None, 8):
        _pruned_steps_on_card(cuda_device, lanes, st,
                              examples.PRUNED_LANES_S, cluster=cs,
                              lanes=len(lanes))


@pytest.mark.parametrize("case", ["pool_limits", "wrap_n_rem"])
def test_pruned_kernels_wide_table(cuda_device, case):
    """600 types: three table blocks a pool, whose partial caps and
    cap_hint rows the commit reduces; 150 type words a slot row in the
    probe's screen."""
    arrays, st = examples.pruned_case(case, T=600)
    _pruned_steps_on_card(cuda_device, arrays, st, 64)


@pytest.mark.parametrize("S", [1, 64])
@pytest.mark.parametrize("case", examples.PRUNED_CASES)
def test_pruned_packed_solve_on_card(cuda_device, case, S):
    arrays, st = examples.pruned_case(case)
    buf = torch.from_numpy(pack_inputs1(arrays, *examples.pack_statics(st)))
    got = ft.solve_scan_packed1_pruned(buf.to(cuda_device), S=S,
                                       **examples.pruned_statics(st))
    plain = ft.solve_scan_packed1_pruned(buf, S=S,
                                         **examples.pruned_statics(st))
    assert torch.equal(got.cpu(), plain)


def test_pruned_many_on_card(cuda_device):
    """Three lanes of different contents: each lane's own answer and
    bail word (only the first bails), as the single solves give them."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    lanes, st = examples.pruned_lanes()
    S = examples.PRUNED_LANES_S
    bufs = _stack(lanes, st, cuda_device)
    ffd_cuda.reset_launches()
    got = ft.solve_scan_packed1_pruned_many(bufs, S=S,
                                            **examples.pruned_statics(st))
    assert ffd_cuda.LAUNCHES["ffd_pruned_commit"] == st["G"]
    assert got[:, -1].tolist() == [1, 0, 0]
    for b in range(3):
        plain = ft.solve_scan_packed1_pruned(bufs[b].cpu(), S=S,
                                             **examples.pruned_statics(st))
        assert torch.equal(got[b].cpu(), plain)


def test_pruned_many_past_grid_y(cuda_device):
    """65,553 lanes (the three ``pruned_lanes`` arenas repeated 21,851
    times), more than grid y's 65,535 blocks: the probe's clusters take
    the lane on grid y and z (hazard 60). One dispatch; each lane equals
    the plain solve of its arena, bail word included."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    lanes, st = examples.pruned_lanes()
    S = examples.PRUNED_LANES_S
    small = _stack(lanes, st, "cpu")
    reps = 21851
    ffd_cuda.reset_launches()
    got = ft.solve_scan_packed1_pruned_many(
        small.repeat(reps, 1).to(cuda_device), S=S,
        **examples.pruned_statics(st))
    assert ffd_cuda.LAUNCHES["ffd_pruned_probe"] == st["G"]
    plain = torch.stack([ft.solve_scan_packed1_pruned(
        small[b], S=S, **examples.pruned_statics(st)) for b in range(3)])
    assert got.shape[0] == 3 * reps > 65535
    assert torch.equal(got.cpu(), plain.repeat(reps, 1))


def test_pruned_bail_resolves_on_card(cuda_device):
    """S = 1 on fills that spill: the pruned solve bails, and the same
    arena is solved again on the card with every slot selected (two
    pruned scans' launches, no host engine), deciding as the plain
    versions on the CPU do."""
    from karpenter_provider_aws_tpu_torch.apis import labels as L
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    env = fenv.Environment()
    pods = []
    for i in range(60):
        pods += fenv.make_pods(3, cpu=f"{100 + i}m", memory="256Mi",
                               prefix=f"dg{i:05d}")
    snap = env.snapshot(pods, [env.nodepool("highg", requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "In", "values": ["m5"]},
        {"key": L.INSTANCE_SIZE, "operator": "In",
         "values": ["large", "xlarge", "2xlarge"]}])])
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    results = []
    for dev in (None, "cpu"):
        s = CUDASolver(n_max=16, device=dev)
        s.dev_max_groups, s.dev_pruned_slots = 8, 1
        results.append(s.solve(snap))
        st = s.last_dispatch_stats
        assert (st["kernel"], st["reason"], st["bails"]) == \
            ("pruned", "pruned_bail", 1)
        if dev is None:
            assert st["launches"]["ffd_pruned_commit"] == 2 * st["groups"]
    assert results[0].decision_fingerprint() == \
        results[1].decision_fingerprint()


# ---------------------------------------------------------------------------
# K9: the topology scan
# ---------------------------------------------------------------------------

def _topo_inputs(case, dev):
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    arrays, rows, st = examples.topo_case(case)
    return (arrays, rows, st, ft.kernel_inputs_from_numpy(arrays, dev),
            tt.topo_rows_from_numpy(rows, dev))


@pytest.mark.parametrize("case", examples.TOPO_CASES)
def test_topo_kernels_step_by_step(cuda_device, case):
    """Each K9 kernel from each group's entry state (the plain parts carry
    the state): group start, the whole pour of a topology group, and the
    others' commit with its membership record (carry, take, and the
    counters after every plain group)."""
    _, _, st, inp, rows = _topo_inputs(case, cuda_device)
    n = 0
    for kernel, what, got, want in examples.topo_kernel_steps(
            inp, rows, n_max=st["n_max"], P=st["P"]):
        assert got.dtype == want.dtype and torch.equal(got, want), \
            (kernel, what)
        n += 1
    torch.cuda.synchronize()
    assert n


@pytest.mark.parametrize("evcap", [2, 128])
@pytest.mark.parametrize("case", ["rows_last", "config3_small"])
def test_topo_pour_wide_counter_axes(cuda_device, case, evcap):
    """A kernel case with its counter axes padded to 4,096 rows (past
    2,048: ``rows_last`` keeps its rows at the last index): every K9
    kernel equal to its plain part from each group's entry state, and
    the pour's shared memory that of the case at 8 rows (it follows the
    rows a group lists, not the padded axes)."""
    import ctypes

    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import topo_cuda as tc
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    smem = []
    for counters in (None, examples.TOPO_WIDE_COUNTERS):
        arrays, rows_np, st = examples.topo_case(case, counters=counters)
        inp = ft.kernel_inputs_from_numpy(arrays, cuda_device)
        rows = tt.topo_rows_from_numpy(rows_np, cuda_device)
        if counters:
            assert (st["GZ"], st["GH"]) == (counters, counters)
            n = 0
            for kernel, what, got, want in examples.topo_kernel_steps(
                    inp, rows, n_max=st["n_max"], P=st["P"], EVCAP=evcap):
                assert got.dtype == want.dtype and torch.equal(got, want), \
                    (kernel, what)
                n += 1
            assert n
        ts = tc.topo_state(
            inp, rows, torch.zeros((st["GZ"], st["Z"]), dtype=torch.int64,
                                   device=cuda_device),
            torch.zeros((st["GH"], st["n_max"]), dtype=torch.int64,
                        device=cuda_device),
            n_max=st["n_max"], P=st["P"], EVCAP=evcap, PMAX=8)
        nbytes, limit = ctypes.c_longlong(), ctypes.c_longlong()
        assert fc._lib().karp_topo_pour_smem(
            ctypes.byref(ts.st.args), ctypes.byref(ts.args),
            ctypes.byref(nbytes), ctypes.byref(limit)) == 0
        assert nbytes.value < 16_000 <= limit.value
        smem.append((ts.nz, ts.nh, nbytes.value))
    assert smem[0] == smem[1]


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("case", ["config3_small", "two_deployments",
                                  "rows_last", "fix_zones", "und_first"])
def test_topo_kernels_by_statics_chunk(cuda_device, case, chunk,
                                      monkeypatch):
    """The K9 kernels step by step with the pool statics launched a chunk
    of one or two topology groups at a time (``STATICS_CHUNK`` set; each
    chunk's rows and the offering words against the plain statics), and
    the whole scan at that chunk: one ``topo_pool_statics`` a chunk,
    outputs equal to the plain scan's on the CPU at the rule's chunk."""
    from karpenter_provider_aws_tpu_torch.ops import topo_cuda as tc
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    arrays, rows_np, st, inp, rows = _topo_inputs(case, cuda_device)
    n_topo = int(rows_np["has_topo"].sum())
    monkeypatch.setattr(tt, "STATICS_CHUNK", chunk)
    seen = set()
    for kernel, what, got, want in examples.topo_kernel_steps(
            inp, rows, n_max=st["n_max"], P=st["P"], EVCAP=128):
        assert got.dtype == want.dtype and torch.equal(got, want), \
            (kernel, what)
        seen.add(kernel)
    assert {"topo_pool_statics", "topo_group_start", "topo_pour"} <= seen
    before = dict(tc.LAUNCHES)
    got = tc.solve_scan_topo_cuda(
        inp, rows, torch.zeros((st["GZ"], st["Z"]), dtype=torch.int64,
                               device=cuda_device),
        torch.zeros((st["GH"], st["n_max"]), dtype=torch.int64,
                    device=cuda_device),
        n_max=st["n_max"], P=st["P"])
    assert tc.LAUNCHES["topo_pool_statics"] \
        - before["topo_pool_statics"] == -(-n_topo // chunk)
    monkeypatch.undo()
    want = tt._solve_scan_topo_ref(
        ft.kernel_inputs_from_numpy(arrays, "cpu"),
        tt.topo_rows_from_numpy(rows_np, "cpu"),
        torch.zeros((st["GZ"], st["Z"]), dtype=torch.int64),
        torch.zeros((st["GH"], st["n_max"]), dtype=torch.int64),
        st["n_max"], st["P"])
    for i, (g, w) in enumerate(zip(got[:2] + got[3:5], want[:2] + want[3:5])):
        assert torch.equal(g.cpu(), w), i
    for k in tt.EV_FILL:
        assert torch.equal(got[2][k].cpu(), want[2][k]), k
    for f, g, w in zip(ft.Carry._fields, got[5], want[5]):
        assert torch.equal(g.cpu(), w), f


def test_topo_pour_layout_too_large_raises(cuda_device):
    """A layout past the card's shared memory for one block (the listed
    zone rows set past what the host counted) raises TopoLayoutError and
    launches nothing."""
    from karpenter_provider_aws_tpu_torch.ops import topo_cuda as tc
    _, _, st, inp, rows = _topo_inputs("config3_small", cuda_device)
    ts = tc.topo_state(inp, rows, torch.zeros((st["GZ"], st["Z"]),
                                              dtype=torch.int64,
                                              device=cuda_device),
                       torch.zeros((st["GH"], st["n_max"]),
                                   dtype=torch.int64, device=cuda_device),
                       n_max=st["n_max"], P=st["P"], EVCAP=128, PMAX=8)
    ts.args.NZ = 1 << 16
    g = ts.has_topo.index(True)
    before = tc.LAUNCHES["topo_pour"]
    with pytest.raises(tc.TopoLayoutError):
        tc.topo_pour(ts, g)
    assert tc.LAUNCHES["topo_pour"] == before


def test_topo_layout_past_the_card_serves_host_pour(cuda_device):
    """A topology group listing more zone rows than one block's shared
    memory holds (``examples.TOPO_LAYOUT_ROWS`` zone-spread constraints of
    distinct selectors): ``CUDASolver()`` answers it on the host pour
    (``reason="topo_layout"``, no pour launched), with the decisions of
    the plain pour on the CPU; config 3's small scenario still fits."""
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    snap = examples.topo_wide_rows(fenv.Environment())
    gpu = CUDASolver()
    ffd_cuda.reset_launches()
    got = gpu.solve(snap)
    d = gpu.last_dispatch_stats
    assert (d["kernel"], d["reason"]) == ("host", "topo_layout")
    assert ffd_cuda.LAUNCHES["topo_pour"] == 0
    assert not got.unschedulable
    assert got.decision_fingerprint() == CUDASolver(
        device="cpu").solve(snap).decision_fingerprint()
    small = examples.topo_scenario(fenv.Environment(), "config3_small")
    gpu.solve(small)
    assert gpu.last_dispatch_stats["kernel"] == "topo"


@pytest.mark.parametrize("evcap", [1, 2, 128])
@pytest.mark.parametrize("case", ["config3_small", "two_pools_limits",
                                  "anti_budget", "anti_slots", "und_first",
                                  "rows_last", "wide_slots"])
def test_topo_scan_on_card(cuda_device, case, evcap):
    """The whole scan on the card against the plain scan on the CPU, every
    output, at the reference's EVCAP and at the two bailing ones."""
    from karpenter_provider_aws_tpu_torch.ops import topo_cuda as tc
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    arrays, rows, st, _, _ = _topo_inputs(case, cuda_device)
    statics = dict(st, EVCAP=evcap, PMAX=8)
    before = dict(tc.LAUNCHES)
    got = tt.dispatch_topo(arrays, rows, statics, device=cuda_device)
    want = tt.dispatch_topo(arrays, rows, statics, device="cpu")
    n_topo = int(rows["has_topo"].sum())
    assert tc.LAUNCHES["topo_pour"] - before["topo_pour"] == n_topo
    assert tc.LAUNCHES["topo_pool_statics"] \
        - before["topo_pool_statics"] == 1
    assert "topo_record_plain" not in tc.LAUNCHES
    assert tc.LAUNCHES["ffd_group_commit"] \
        - before["ffd_group_commit"] == len(rows["has_topo"]) - n_topo
    for k, w in want.items():
        assert torch.equal(got[k].cpu(), w), k


def test_topo_solver_on_card(cuda_device):
    """Config 3 at 2,000 pods through ``CUDASolver()`` on the card: the
    topology kernels serve it as the plain versions decide; a forced bail
    (EVCAP 1) is solved again on the card."""
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    fenv.reset_pod_counter()
    snap = examples.config3(fenv.Environment(), 2000)
    want = CUDASolver(device="cpu").solve(snap).decision_fingerprint()
    for evcap, reason, bails in ((128, None, 0), (1, "topo_bail", 1)):
        s = CUDASolver()
        s.TOPO_EVCAP = evcap
        got = s.solve(snap)
        d = s.last_dispatch_stats
        assert (d["kernel"], d["reason"], d["bails"]) == \
            ("topo", reason, bails)
        assert d["launches"]["topo_pour"] == 21 * (1 + bails)
        assert d["launches"]["topo_pool_statics"] == 1 + bails
        assert got.decision_fingerprint() == want


# ---------------------------------------------------------------------------
# K8: the preemption victim-set search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hazard", examples.PREEMPT_HAZARDS)
def test_preempt_kernel_matches_plain(cuda_device, hazard):
    """The fourth mode of consol_absorb against the plain K8, one launch
    a batch; "wide_e" keeps the lane carry in the global scratch."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch
    for seed in (0, 1):
        t = _t(cuda_device, *examples.preempt_case(hazard, seed))
        ffd_cuda.reset_launches()
        got = preempt_torch.preempt_solve(*t)
        assert {k: v for k, v in ffd_cuda.LAUNCHES.items() if v} == \
            dict(consol_absorb_preempt=1)
        assert torch.equal(got, preempt_torch._preempt_solve_ref(*t))


def test_preempt_round_on_card(cuda_device):
    """A preemption round through Provisioner.reconcile on the card: the
    planner's one K8 launch and its dispatch record, and the result of
    the round equal to the same round on the plain versions."""
    from karpenter_provider_aws_tpu_torch.cloudprovider.provider import \
        CloudProvider
    from karpenter_provider_aws_tpu_torch.controllers.provisioning import \
        Provisioner
    from karpenter_provider_aws_tpu_torch.scheduling import \
        PreemptionPlanner
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.state.cluster import ClusterState
    out = []
    for device in ("cuda", "cpu"):
        c = examples.preempt_cluster(examples.preempt_api(), 24, 12, 1)
        solver = CUDASolver(device=device)
        planner = PreemptionPlanner(solver=solver)
        records = []
        inner = solver.dispatch_preempt

        def spy(inner=inner, solver=solver, **kw):
            got = inner(**kw)
            records.append(dict(solver.last_dispatch_stats))
            return got
        solver.dispatch_preempt = spy
        prov = Provisioner(c.kube, ClusterState(c.kube, clock=lambda: 0.0),
                           CloudProvider(c.kube, c.env.instance_types),
                           solver, clock=lambda: 0.0,
                           preempt_planner=planner)
        res = prov.reconcile()
        v = res.preempt
        assert v.feasible and v.backend == "device" and len(records) == 1
        rec = records[0]
        assert (rec["kernel"], rec["batch"], rec["fuse"],
                rec["device"]) == ("preempt", v.lanes, 1, str(solver.device))
        if device == "cuda":
            assert rec["launches"]["consol_absorb_preempt"] == 1
        out.append((sorted(res.unschedulable), sorted(res.nominated.items()),
                    sorted(res.preempted.items()), v.leftovers,
                    [p.full_name() for p in v.victims]))
    assert out[0] == out[1]


def _seen(records, names):
    """``examples.mesh_kernel_check`` that also collects the names of the
    buffers it compares."""
    chk = examples.mesh_kernel_check(0, records)

    def check(name, args, st, ref):
        names.update(st.buffers())
        chk(name, args, st, ref)
    return check


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("case", examples.MESH_CASES)
def test_mesh_kernels_step_by_step(cuda_device, case, split):
    """K10 at world size 1: every kernel launch of the first four group
    steps (and the caps) against its plain part from the same entry
    state, every buffer a kernel writes (the headroom's new-node table
    included), the fill in one launch and in its three phases; the whole
    solve against the single-device plain scan."""
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.parallel import mesh as pm
    arrays, st = examples.mesh_case(case)
    records = []
    got = examples.mesh_outputs(*pm.solve_scan_sharded(
        arrays, None, st["n_max"], st["E"], st["P"], st["V"],
        device=cuda_device, check=_seen(records, names := set()),
        split_fill=split))
    assert {r[0] for r in records} == set(mc.KERNELS)
    assert {"candn", "hrn", "capn"} <= names   # the new-node table too
    bad = [r for r in records if r[2]]
    assert not bad, bad[:3]
    want = examples.mesh_outputs(*ft._solve_scan_ref(
        ft.kernel_inputs_from_numpy(arrays, "cpu"), st["n_max"], st["E"],
        st["P"], st["V"]))
    for k in want:
        assert (got[k] == want[k]).all(), k


#: mesh_fill states on the card: (rows, pools, ``examples.fill_state``
#: options): 1 to 9,000 rows (two tiles of the 512-thread CTA), one and
#: eight pools, limited or not, a shard starting inside the existing rows,
#: earlier-shard prefixes small and wrapping, minValues floors
FILL_CARD_STATES = (
    [(nl, p, dict(limited=lim)) for nl in (1, 33, 256, 2112, 4224, 9000)
     for p in (1, 8) for lim in (True, False)]
    + [(512, 8, {}), (100, 20, {}),
       (300, 8, dict(E=100, slot0=50, before="wrap")),
       (300, 8, dict(E=40, slot0=100, before="small")),
       (2112, 8, dict(E=128, slot0=0, before="wrap")),
       (256, 3, dict(K=2, V=3))])


@pytest.mark.parametrize("nl,P,kw", FILL_CARD_STATES)
def test_mesh_fill_phases_on_card(cuda_device, nl, P, kw):
    """Each ``mesh_fill`` phase (a, b, c and all three in one launch)
    against ``_fill_ref`` from the same entry state: every buffer, bytes
    equal; the launch count one a call."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    for phase in (mc.PHASE_A, mc.PHASE_B, mc.PHASE_C, mc.PHASE_ALL):
        st, g = examples.fill_state(nl, P, seed=nl + P + phase,
                                    device=cuda_device, **kw)
        want = st.clone()
        mc._fill_ref(want, g, phase)
        before = ffd_cuda.LAUNCHES["mesh_fill"]
        mc.mesh_fill(st, g, phase)
        assert ffd_cuda.LAUNCHES["mesh_fill"] == before + 1
        for nm, t in st.buffers().items():
            assert torch.equal(t, want.buffers()[nm]), (phase, nm)


def test_mesh_fill_threads_rule_matches_the_card(cuda_device):
    """The fill's CTA size and rows a thread: the Python mirrors equal the
    C rules."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    for n in (1, 256, 257, 2048, 2049, 2112, 4224, 9000):
        assert ffd_cuda._lib().karp_mesh_fill_threads(n) \
            == mc.fill_threads(n)
        assert ffd_cuda._lib().karp_mesh_fill_rows(n) == mc.fill_rows(n)


@pytest.mark.parametrize("name,shape,K", examples.CAPS_CASES,
                         ids=[c[0] for c in examples.CAPS_CASES])
def test_mesh_new_caps_shapes(cuda_device, name, shape, K):
    """``mesh_new_caps`` at the main paths' shapes (``examples.CAPS_SHAPES``:
    T = 812, 406 and 203 types on a cluster of 8, 4 and 2 CTAs, G = 4 and
    64), with minValues floors, past eight dimensions and past the 64-bit
    offering word: one launch, every cap and per-value maximum equal to
    ``_new_caps_ref`` on the same state."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    st = examples.caps_state(**shape, seed=len(name), K=K, V=5 if K else 0,
                             device=cuda_device)
    want = st.clone()
    mc._new_caps_ref(want)
    before = ffd_cuda.LAUNCHES["mesh_new_caps"]
    mc.mesh_new_caps(st)
    assert ffd_cuda.LAUNCHES["mesh_new_caps"] == before + 1
    assert torch.equal(st.caps, want.caps), name


def test_mesh_caps_cluster_rule_matches_the_card(cuda_device):
    """The caps' CTAs a (group, pool): the Python mirror equals the C
    rule."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    for T in (0, 1, 128, 129, 203, 406, 812, 1025, 5000):
        for K in (0, 2):
            assert ffd_cuda._lib().karp_mesh_caps_cluster(T, K) \
                == mc.caps_cluster(T, K)


@pytest.mark.parametrize("before", sorted(examples.MESH_BEFORES))
@pytest.mark.parametrize("case,ndp,dp_idx", examples.MESH_LATER_SHARDS)
def test_mesh_kernels_on_a_later_slot_shard(cuda_device, case, ndp, dp_idx,
                                            before):
    """K10 on a later slot shard (slot0 > 0) with earlier-shard prefixes,
    small and wrapping: every launch of the first four group steps against
    its plain part (the pool caps and greedy fill after a prefix, the
    new-node window at lo > 0, the existing-row overlay by global slot
    id), the new-node table among the buffers compared."""
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    records, st = examples.mesh_shard_check(case, ndp, dp_idx, before,
                                            device=cuda_device)
    assert st.slot0 > 0
    assert {r[0] for r in records} == set(mc.KERNELS)
    assert {"candn", "hrn", "capn"} <= set(st.buffers())
    bad = [r for r in records if r[2]]
    assert not bad, bad[:3]


MESH_SHAPES = [(1, 256), (1, 512), (2, 512), (4, 512), (8, 256), (8, 512)]


@pytest.mark.parametrize("case,ndp,dp_idx",
                         [("hazards", 1, 0), ("existing_split", 1, 0)]
                         + list(examples.MESH_LATER_SHARDS))
def test_mesh_commit_shapes_agree(cuda_device, case, ndp, dp_idx):
    """The K10 commit forced onto every cluster shape (CTAs, threads),
    at world size 1 and on later slot shards: every launch of the first
    four group steps equals its plain part, and every shape's whole scan
    writes the same outputs and carry as the rule's (8 x 512 here)."""
    outs = []
    for cs, nt in [(None, None)] + MESH_SHAPES:
        kw = {} if cs is None else dict(cluster=cs, threads=nt)
        records, st = examples.mesh_shard_check(case, ndp, dp_idx, "small",
                                                device=cuda_device, **kw)
        bad = [r for r in records if r[2]]
        assert not bad, (cs, nt, bad[:3])
        if cs is None:
            assert (st.cluster, st.threads) == (8, 512)
        outs.append([st.takes, st.leftover, *st.carry])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_mesh_min_values_commit_takes_the_block_branch(cuda_device):
    """With minValues floors the K10 commit runs the block bodies on one
    CTA: the rule gives a cluster of one, a forced larger cluster is
    refused, and every launch of the first steps equals its plain part
    (the commit's scratch row of the table included)."""
    import numpy as np
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.parallel import mesh as pm
    arrays, st = examples.mesh_case("min_values")
    N = st["E"] + st["n_max"]
    lay = pm.MeshComm()
    T = np.asarray(arrays["A"]).shape[0]
    names = [f for f in pm.FIELDS if arrays.get(f) is not None]
    inp = ft.KernelInputs(**pm._shard_inputs(arrays, lay, names, T, N, None,
                                             st["V"], cuda_device))
    with pytest.raises(ValueError, match="one CTA"):
        mc.MeshState(inp, E=st["E"], P=st["P"], V=st["V"], N=N, slot0=0,
                     cluster=2)
    state = mc.MeshState(inp, E=st["E"], P=st["P"], V=st["V"], N=N, slot0=0)
    records = []
    pm._mesh_scan(state, lay, check=examples.mesh_kernel_check(0, records))
    assert state.K > 0 and state.cluster == 1
    assert {r[0] for r in records} == set(mc.KERNELS)
    bad = [r for r in records if r[2]]
    assert not bad, bad[:3]


def test_mesh_solver_on_card_matches_k2(cuda_device):
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.parallel import MeshComm
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    env = fenv.Environment()
    for seed in (0, 3, 7):
        fenv.reset_pod_counter()
        snap = examples.fuzz_scenario(examples.pipeline_api(), env, seed)
        want = CUDASolver().solve(snap).decision_fingerprint()
        s = CUDASolver(mesh=MeshComm(), force_mesh=True)
        assert s.solve(snap).decision_fingerprint() == want
        st = s.last_dispatch_stats
        assert (st["kernel"], st["mesh_kernel"]) == ("mesh", "tp")
        assert all(st["launches"][k] > 0 for k in (
            "mesh_new_caps", "mesh_slot_headroom", "mesh_fill",
            "mesh_commit"))


@pytest.mark.parametrize("shape", ["smoke", "canary"])
def test_dist_dispatch_on_card(cuda_device, shape):
    """K11 at 1 x 1 on the card: the rank's shard cut from its host's
    slab and placed on the card, the fill in its three phases, every K10
    launch of the first four group steps against its plain part, and the
    ticks (full, patch) equal to the plain versions' dispatch on the CPU;
    a slab that does not cover the rank's rows raises."""
    from karpenter_provider_aws_tpu_torch.fleet.canary import \
        MESH_CANARY_SHAPE
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.parallel import distmesh as dm
    sh = examples.DIST_SMOKE_SHAPE if shape == "smoke" else MESH_CANARY_SHAPE
    comm = dm.dist_mesh2()
    Np, lo, hi = dm.slab_rows(sh["n_max"], sh["E"], comm.ndp)
    cache, records = {}, []
    for tick in (0, 1):
        arrays, st = dm.tick_arrays(sh, 7, tick, slab=(lo, hi, Np))
        fc.reset_launches()
        out = dm.dispatch_dist(
            arrays, comm=comm, cache=cache, device=cuda_device,
            dirty=None if tick == 0 else list(dm.DIRTY_FIELDS),
            check=examples.mesh_kernel_check(0, records) if tick == 0
            else None, **st)
        assert cache["last_placement"]["mode"] == ("patch" if tick
                                                   else "full")
        G = sh["G"]
        assert {k: fc.LAUNCHES[k] for k in mc.KERNELS} == dict(
            mesh_new_caps=1, mesh_slot_headroom=G, mesh_fill=3 * G,
            mesh_commit=G)
        res = cache["resident"]["dev"]
        assert res["ex_used0"].is_cuda and res["ex_used0"].shape[0] == Np
        plain, _ = dm.tick_arrays(sh, 7, tick)
        want = dm.oracle_out(plain, device="cpu", **st)
        assert dm.result_fingerprint(out) == dm.result_fingerprint(want)
    assert {r[0] for r in records} == set(mc.KERNELS)
    bad = [r for r in records if r[2]]
    assert not bad, bad[:3]
    half, st = dm.tick_arrays(sh, 7, 0, slab=(0, Np // 2, Np))
    with pytest.raises(ValueError, match="outside local slab"):
        dm.dispatch_dist(half, comm=comm, cache={}, device=cuda_device, **st)
