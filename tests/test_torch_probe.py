"""The pruned step's probe (K6, ``ffd_pruned_probe``) and the launch
device of every kernel wrapper, on the CPU.

- The probe's plain part: ``ffd_torch._pruned_probe_ref`` (what the
  kernel writes: the selection, the counts, the selected rows'
  candidates and headroom, the new-node table) against the reference's
  pruned step (ops/ffd_jax.py:910-946, its expressions written out below
  on the reference's own helpers) on every ``examples.PRUNED_CASES``
  arena at S = 1, 4, 64 and N, step by step along the reference's carry;
  and the port's whole step (probe then commit) against the reference's
  ``pruned_group_step`` itself, carry and takes.
- The probe's selection across a thread-block cluster: a plain model of
  what csrc/pruned.cu computes (per-CTA chunks, per-thread sub-chunks, a
  block-wide exclusive scan, the prefix over the CTAs' counts, the global
  ranks, each CTA's row list) held equal to ``_pruned_select_ref`` for
  1, 2, 8 and 16 CTAs when flagged slots straddle chunk ends, when a
  chunk is empty, when more than S slots are flagged and at S = N.
- The launch device: with ``torch.cuda`` and the kernel library stubbed,
  every wrapper family (K1/K2, fused, pruned, checkpoint, suffix,
  consolidation, topology, mesh) launches on the device of its tensors
  (cuda:1 while cuda:0 is current) on that device's stream; a scan enters
  the device's guard once (the suffix's first launch, the unpack that
  loads its resume row, inside it); the cluster rules key on the state's
  device; and a spawned CUDA rank makes its card current.

Tolerance: exact (int64 and bool).
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
from karpenter_provider_aws_tpu_torch.ops import topo_cuda as tc
from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
from karpenter_provider_aws_tpu_torch.ops.hostpack import pack_inputs1
from karpenter_provider_aws_tpu_torch.parallel import mesh as pm
from karpenter_provider_aws_tpu_torch.parallel import ranks


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the probe's plain part against the reference's step
# ---------------------------------------------------------------------------

def _jax_inputs(arrays):
    return ffd_jax.KernelInputs(**{
        f: None if arrays.get(f) is None else jnp.asarray(arrays[f])
        for f in ffd_jax.KernelInputs._fields})


def _jax_probe(inp, carry, g, *, P, E, N, S):
    """The reference's bound pass, screen, selection and exact rows of
    group g (ops/ffd_jax.py:910-946, as written there): (sel [S], its
    validity, n_pos, cand_s [S, T], k_exact_s [S])."""
    R, F, agz, agc, admit = (inp.R[g], inp.F[g], inp.agz[g], inp.agc[g],
                             inp.admit[g])
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    pool_clipped = jnp.clip(carry.pool, 0, P - 1)
    adm_open = jnp.where(carry.pool >= 0, admit[pool_clipped], False)
    Rsafe = jnp.where(R > 0, R, 1)
    qb = (carry.cap_hint - carry.used) // Rsafe[None, :]
    qb = jnp.where((R > 0)[None, :], qb, ffd_jax.BIG)
    k_bound = jnp.clip(qb.min(axis=-1), 0, ffd_jax.BIG)
    compat = (carry.types & F[None, :]).any(axis=1) \
        & (carry.zones & agz[None, :]).any(axis=1) \
        & (carry.ct & agc[None, :]).any(axis=1)
    open_cand = adm_open & (k_bound > 0) & carry.alive & compat
    if E:
        open_cand = open_cand.at[:E].set(False)
    n_pos = open_cand.sum()
    sel_rank = jnp.where(open_cand, jnp.arange(N), N + 1)
    sel = jnp.argsort(sel_rank)[:S]
    sel_valid = open_cand[sel]
    zc_s = ((carry.zones[sel] & agz[None, :])[:, :, None]
            & (carry.ct[sel] & agc[None, :])[:, None, :]).reshape(S, Z * C)
    off_ok_s = (zc_s.astype(jnp.int32)
                @ inp.avail_zc.T.astype(jnp.int32)) > 0
    cand_s = carry.types[sel] & F[None, :] & off_ok_s & sel_valid[:, None]
    hr_s = ffd_jax._headroom_matrix(inp.A, carry.used[sel], R)
    k_exact_s = jnp.where(cand_s, hr_s, 0).max(axis=1)
    return sel, sel_valid, n_pos, cand_s, k_exact_s


def _port_carry(jcarry):
    return ft.CarryP(*[torch.from_numpy(np.array(f)).reshape(-1)
                       if nm in ("num_nodes", "bail")
                       else torch.from_numpy(np.array(f))
                       for nm, f in zip(ft.CarryP._fields, jcarry)])


@pytest.mark.parametrize("S", [1, 4, 64, "N"])
@pytest.mark.parametrize("case", examples.PRUNED_CASES)
def test_probe_ref_matches_reference_step(case, S):
    """Along the reference's carry, every step: the probe's plain part
    equals the reference's selection (the first n_sel slots, -1 where
    the reference pads with slots it marks invalid), counts, candidate
    rows and exact headroom, and its table the plain table; the port's
    whole step equals ``pruned_group_step``'s new carry and takes."""
    arrays, st = examples.pruned_case(case)
    E, P, G = st["E"], st["P"], st["G"]
    N = E + st["n_max"]
    S = N if S == "N" else min(S, N)
    jinp = _jax_inputs(arrays)
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    jcarry = ffd_jax.CarryP(
        used=jnp.zeros((N, st["D"]), jnp.int64).at[:E].set(jinp.ex_used0),
        types=jnp.zeros((N, st["T"]), bool),
        zones=jnp.zeros((N, st["Z"]), bool),
        ct=jnp.zeros((N, st["C"]), bool),
        pool=jnp.full((N,), -1, jnp.int32).at[:E].set(-2),
        alive=jnp.zeros((N,), bool).at[:E].set(True),
        num_nodes=jnp.int32(0), pool_used=jinp.pool_used0,
        cap_hint=jnp.zeros((N, st["D"]), jnp.int64).at[:E].set(
            jinp.ex_alloc),
        bail=jnp.asarray(False))
    selected = bailed = 0
    for g in range(G):
        carry = _port_carry(jcarry)
        sel, cnt, cand_s, k_s, tab = ft._pruned_probe_ref(inp, carry, g, E=E,
                                                          P=P, S=S)
        jsel, jvalid, jpos, jcand, jk = _jax_probe(jinp, jcarry, g, P=P,
                                                   E=E, N=N, S=S)
        n_sel = min(int(jpos), S)
        assert cnt.tolist() == [n_sel, int(jpos)], g
        assert np.asarray(jvalid)[:n_sel].all()
        assert not np.asarray(jvalid)[n_sel:].any()
        np.testing.assert_array_equal(sel[:n_sel].numpy(),
                                      np.asarray(jsel)[:n_sel])
        assert (sel[n_sel:] == -1).all()
        np.testing.assert_array_equal(cand_s.numpy(), np.asarray(jcand))
        np.testing.assert_array_equal(k_s.numpy(), np.asarray(jk))
        for got, want in zip(tab, ft._new_node_table_ref(inp, g, P=P,
                                                         cap_row=True)):
            assert torch.equal(got, want), g
        new, take, _ = ft._pruned_group_step_ref(inp, carry, g, E=E, P=P,
                                                 S=S)
        xs = tuple(getattr(jinp, f)[g] for f in (
            "R", "n", "F", "agz", "agc", "admit", "daemon", "ex_compat"))
        jcarry, (jtake, _) = ffd_jax.pruned_group_step(
            jinp, jcarry, xs, P=P, E=E, N=N, S=S, slot_idx=jnp.arange(N))
        for nm, a, b in zip(ft.CarryP._fields, new, _port_carry(jcarry)):
            assert torch.equal(a, b), (g, nm)
        np.testing.assert_array_equal(take.numpy(), np.asarray(jtake))
        selected += n_sel
        bailed = int(new.bail)
    assert selected
    if S == N:
        assert not bailed


# ---------------------------------------------------------------------------
# the cluster's selection: a plain model of csrc/pruned.cu
# ---------------------------------------------------------------------------

#: the probe's constants (csrc/pruned.cu kProbeThreads / 32, kProbeRows)
PROBE_WARPS = 1024 // 32
PROBE_ROWS = 256


def _cluster_select_model(flags, S, CS, NR, T):
    """``ffd_pruned_probe``'s screen and selection as its NR selecting
    clusters of CS CTAs compute them. The screen: CTA c owns the slots
    [c*ceil(N/CS), ...) and stores each slot's value into every CTA of
    its cluster. The selection, in each cluster ci, in passes of
    PROBE_ROWS rows: warp w counts the flags of its words of 32 slots
    (words [w*wpw, ...), wpw = ceil(ceil(N/32) / PROBE_WARPS)) by
    ballots, then ranks each flag after the lower warps' counts and the
    lower lanes of its word; a flag of rank rk < S with rk & (NR-1) == ci
    is row jj = (rk >> log2 NR) - q0 of the pass, rows whose index
    ci + NR*(q0 + jj) is past n_pos become -1, and the cluster's CTA 0
    writes them to sel (cluster 0 also cnt). A row's type chunks of 32
    go to CTA k mod CS. Returns (sel, (n_sel, n_pos), the screen's slot
    chunks, each CTA's type chunks, the passes each cluster took)."""
    N = len(flags)
    lg = NR.bit_length() - 1
    cchunk = -(-N // CS)
    fl = [[None] * N for _ in range(CS)]
    chunks = []
    for c in range(CS):
        c0 = min(c * cchunk, N)
        c1 = min(c0 + cchunk, N)
        chunks.append((c0, c1))
        for s in range(c0, c1):
            for dst in range(CS):
                assert fl[dst][s] is None   # one owner a slot
                fl[dst][s] = bool(flags[s])
    assert all(None not in f for f in fl)
    v = fl[0]
    nwd = -(-N // 32)
    wpw = -(-nwd // PROBE_WARPS)
    words = [range(w * wpw, min(w * wpw + wpw, nwd))
             for w in range(PROBE_WARPS)]

    def ballot(word):
        return [32 * word + ln < N and v[32 * word + ln] for ln in range(32)]
    sel, cnt, passes = [None] * S, None, []
    for ci in range(NR):
        nrow = -(-(S - ci) // NR) if ci < S else 0
        passes.append(-(-nrow // PROBE_ROWS))
        for q0 in range(0, nrow, PROBE_ROWS):
            nb = min(nrow - q0, PROBE_ROWS)
            rows = [None] * nb
            wcnt = [sum(sum(ballot(x)) for x in words[w])
                    for w in range(PROBE_WARPS)]
            n_pos = sum(wcnt)
            for w in range(PROBE_WARPS):
                before = sum(wcnt[:w])
                for x in words[w]:
                    bal = ballot(x)
                    for ln in range(32):
                        rk = before + sum(bal[:ln])
                        jj = (rk >> lg) - q0
                        if (bal[ln] and rk < S and (rk & (NR - 1)) == ci
                                and 0 <= jj < nb):
                            assert rows[jj] is None
                            rows[jj] = 32 * x + ln
                    before += sum(bal)
            for jj in range(nb):
                if ci + NR * (q0 + jj) >= n_pos:
                    rows[jj] = -1
            for jj, s in enumerate(rows):
                i = ci + NR * (q0 + jj)
                assert sel[i] is None   # each row written by one cluster
                sel[i] = s
            if ci == 0 and q0 == 0:
                cnt = (min(n_pos, S), n_pos)
    assert None not in sel
    nk = -(-T // 32)
    tchunks = [[rank + u * CS for u in range(-(-(nk - rank) // CS))]
               if nk > rank else [] for rank in range(CS)]
    return sel, cnt, chunks, tchunks, passes


def _flags(scenario, N, CS):
    """Flag patterns: around every chunk end, one whole chunk empty,
    dense, and random."""
    rng = np.random.RandomState(CS * 7 + N)
    cchunk = -(-N // CS)
    f = np.zeros(N, bool)
    if scenario == "straddle":
        for c in range(1, CS):
            f[max(c * cchunk - 1, 0):min(c * cchunk + 1, N)] = True
        f[0] = f[N - 1] = True
    elif scenario == "empty_chunk":
        f[:] = rng.rand(N) < 0.6
        c = min(1, CS - 1)
        f[c * cchunk:(c + 1) * cchunk] = False
    else:
        f[:] = rng.rand(N) < 0.5
    return f


def _select_inputs(flags):
    """A one-group, one-pool input whose open slots are exactly
    ``flags`` (every other condition of the screen holds)."""
    N = len(flags)
    T, D = 4, 2
    inp = ft.KernelInputs(*[None] * len(ft.KernelInputs._fields))._replace(
        R=torch.ones((1, D), dtype=torch.int64),
        F=torch.ones((1, T), dtype=torch.bool),
        agz=torch.ones((1, 1), dtype=torch.bool),
        agc=torch.ones((1, 1), dtype=torch.bool),
        admit=torch.ones((1, 1), dtype=torch.bool))
    carry = ft.CarryP(
        used=torch.zeros((N, D), dtype=torch.int64),
        types=torch.ones((N, T), dtype=torch.bool),
        zones=torch.ones((N, 1), dtype=torch.bool),
        ct=torch.ones((N, 1), dtype=torch.bool),
        pool=torch.zeros(N, dtype=torch.int32),
        alive=torch.from_numpy(flags.copy()),
        num_nodes=torch.zeros(1, dtype=torch.int32),
        pool_used=torch.zeros((1, D), dtype=torch.int64),
        cap_hint=torch.full((N, D), 5, dtype=torch.int64),
        bail=torch.zeros(1, dtype=torch.bool))
    return inp, carry


# (scenario, N, S): N is not a multiple of CS * 32 for any CS here; 5,003
# slots give each warp several words of 32 slots; S = N = 300 at one
# selecting cluster, and 5,003 at up to four, take several passes
SELECT_CASES = [("straddle", 300, 64), ("empty_chunk", 300, 64),
                ("over_S", 300, 4), ("S_is_N", 300, 300),
                ("warp_words", 5003, 64), ("warp_words", 5003, 5003)]


@pytest.mark.parametrize("NR", [1, 2, 4])
@pytest.mark.parametrize("CS", [1, 2, 8, 16])
@pytest.mark.parametrize("scenario,N,S", SELECT_CASES)
def test_cluster_selection_model_matches_select_ref(scenario, N, S, CS, NR):
    """The model of the probe's screen and selection equals
    ``_pruned_select_ref`` (hazard 59): every slot screened by one CTA,
    every row of sel written by one cluster, every type chunk taken by
    one CTA."""
    flags = _flags(scenario, N, CS)
    T = 812 if N < 1000 else 27
    sel, cnt, chunks, tchunks, passes = _cluster_select_model(
        flags, S, CS, NR, T)
    inp, carry = _select_inputs(flags)
    want_sel, want_cnt = ft._pruned_select_ref(inp, carry, 0, E=0, P=1, S=S)
    assert sel == want_sel.tolist()
    assert list(cnt) == want_cnt.tolist()
    assert sorted(k for ks in tchunks for k in ks) == list(range(-(-T // 32)))
    ends = {b for _, b in chunks[:-1]}
    if scenario == "straddle":
        # flagged slots on both sides of every chunk boundary
        assert all(flags[e - 1] and flags[e] for e in ends if 0 < e < N)
    if scenario == "empty_chunk" and CS > 1:
        a, b = chunks[1]
        assert b > a and not flags[a:b].any()
    if scenario == "over_S":
        assert cnt[1] > S
    if scenario == "warp_words":
        assert -(-(-(-N // 32)) // PROBE_WARPS) > 1
    if S > PROBE_ROWS * NR:
        assert passes[0] > 1


# ---------------------------------------------------------------------------
# the launch device (torch.cuda and the kernel library stubbed)
# ---------------------------------------------------------------------------

class _Card:
    """A stand-in for two cards: cuda:0 current, every tensor the
    wrappers see on cuda:1. Records the device guards entered, the
    devices whose current stream was asked for, and each C entry called
    with the stream it was given (stream handle 100 + device index) and,
    in ``args``, with all its arguments."""

    def __init__(self):
        self.current = 0
        self.guards, self.streams, self.calls = [], [], []
        self.args = []

    def device(self, dev):
        card = self

        @contextlib.contextmanager
        def guard():
            dev_ = torch.device(dev)
            card.guards.append(dev_)
            prev, card.current = card.current, dev_.index
            try:
                yield
            finally:
                card.current = prev
        return guard()

    def current_stream(self, dev=None):
        dev = torch.device("cuda", self.current) if dev is None \
            else torch.device(dev)
        self.streams.append(dev)
        return types.SimpleNamespace(cuda_stream=100 + dev.index)

    def lib(self):
        card = self

        class Lib:
            def __getattr__(self, name):
                def entry(*args):
                    if name.endswith("_cluster"):   # an occupancy rule
                        card.calls.append((name, card.current))
                        # the probe's answer also holds its row clusters
                        return 2 + 16 * ("pruned" in name)
                    card.calls.append((name, args[-1]))
                    card.args.append((name, args))
                    return 0
                return entry
        return Lib()

    def launches(self):
        return [c for c in self.calls if not c[0].endswith("_cluster")]


def _need_shape(t, name, dtype, shape=None, lanes=False):
    """``_need`` without the CUDA check (the tensors here are the CPU's)."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")


@pytest.fixture
def card(monkeypatch):
    c = _Card()
    lib = c.lib()
    monkeypatch.setattr(torch.cuda, "current_device", lambda: c.current)
    monkeypatch.setattr(torch.cuda, "device", c.device)
    monkeypatch.setattr(torch.cuda, "current_stream", c.current_stream)
    monkeypatch.setattr(fc, "_device", lambda t: torch.device("cuda", 1))
    for mod in (fc, cc, tc, mc):
        monkeypatch.setattr(mod, "_lib", lambda: lib)
        monkeypatch.setattr(mod, "_need", _need_shape)
    monkeypatch.setattr(fc, "_CLUSTERS", {})
    monkeypatch.setattr(fc, "_PROBE_CLUSTERS", {})
    fc.reset_launches()
    yield c
    fc.reset_launches()


CUDA1 = torch.device("cuda", 1)


def _on_card1(card, n_guards):
    """Every C entry got cuda:1's stream, every stream asked for was
    cuda:1's, and the guard of cuda:1 was entered ``n_guards`` times."""
    assert card.launches() and all(s == 101 for _, s in card.launches())
    assert card.streams and set(card.streams) == {CUDA1}
    assert card.guards == [CUDA1] * n_guards


def _pruned_inputs(case="plain"):
    arrays, st = examples.pruned_case(case)
    return ft.kernel_inputs_from_numpy(arrays, "cpu"), st


def test_k1_k2_launch_on_their_tensors_device(card):
    """A wrapper alone enters the guard; the K2 scan enters it once for
    its 2*G launches."""
    inp, st = _pruned_inputs()
    fc.unpack_bits(torch.zeros(2, dtype=torch.int64), 100)
    _on_card1(card, 1)
    card.guards.clear()
    fc.solve_scan_cuda(inp, st["n_max"], st["E"], st["P"])
    assert fc.LAUNCHES["ffd_group_commit"] == st["G"]
    _on_card1(card, 1)


def test_checkpoint_solve_launches_on_its_device(card):
    """unpack_bits, the checkpointed scan (K2 under one guard, the chunk
    entries' headroom launches storing the bank rows: no bank store) and
    pack_outputs: three guards of cuda:1."""
    arrays, st = examples.example_case("base")
    buf = torch.from_numpy(pack_inputs1(arrays, *examples.pack_statics(st)))
    G = st["G"]
    fc.solve_scan_packed1_ckpt_cuda(buf, CK=2, **examples.solve_statics(st))
    assert "ffd_bank_store" not in fc.LAUNCHES
    names = [n for n, _ in card.launches()]
    assert names == ["karp_unpack_bits"] + ["karp_ffd_slot_headroom",
                                            "karp_ffd_group_commit"] * G \
        + ["karp_pack_outputs"]
    assert card.args[-1][1][1:4] == (None, 0, 0)   # no store range
    assert fc.LAUNCHES["ffd_slot_headroom"] == G
    rows = [a[3] for n, a in card.args if n == "karp_ffd_slot_headroom"]
    assert rows == [g // 2 if g % 2 == 0 else -1 for g in range(G)]
    _on_card1(card, 3)


def test_suffix_launches_on_its_device(card):
    """The suffix re-solve enters cuda:1's guard once for all its
    launches: the loading unpack (``karp_unpack_bits_load`` of row jr,
    counted as ``unpack_bits``; no ``karp_ffd_bank_load``), the window's
    K2 launches (the later chunk entry's headroom storing its row) and
    the pack, whose arguments carry the pad chunks' row range [GL/CK,
    G/CK) (no ``karp_ffd_bank_store``)."""
    arrays, st = examples.example_case("base", G=8)
    CK, SUF, GL = 2, 2, 6
    arrays["n"][GL:] = 0
    buf = torch.from_numpy(pack_inputs1(arrays, *examples.pack_statics(st)))
    ss = examples.solve_statics(st)
    _, bank = ft.solve_scan_packed1_ckpt(buf, CK=CK, device="cpu", **ss)
    fc.solve_scan_suffix_cuda(buf, bank, CK=CK, SUF=SUF, GL=GL, **ss)
    names = [n for n, _ in card.launches()]
    assert names == ["karp_unpack_bits_load"] \
        + ["karp_ffd_slot_headroom", "karp_ffd_group_commit"] * SUF * CK \
        + ["karp_pack_outputs"]
    jr, s0 = GL // CK - SUF, GL - SUF * CK
    assert card.args[0][1][4] == jr
    rows = [a[3] for n, a in card.args if n == "karp_ffd_slot_headroom"]
    assert rows == [fc.entry_row(g, s0, CK, jr, True)
                    for g in range(s0, GL)] == [-1, -1, 2, -1]
    name, args = card.args[-1]
    assert name == "karp_pack_outputs"
    assert args[1] is not None and args[2:4] == (GL // CK, 8 // CK - GL // CK)
    assert "ffd_bank_load" not in fc.LAUNCHES
    assert "ffd_bank_store" not in fc.LAUNCHES
    assert fc.LAUNCHES["unpack_bits"] == fc.LAUNCHES["pack_outputs"] == 1
    _on_card1(card, 1)
    # at GL = G there are no pad chunks: no range
    card.calls.clear()
    card.args.clear()
    arrays["n"][GL:] = 1
    buf = torch.from_numpy(pack_inputs1(arrays, *examples.pack_statics(st)))
    fc.solve_scan_suffix_cuda(buf, bank, CK=CK, SUF=SUF, GL=8, **ss)
    assert card.args[-1][0] == "karp_pack_outputs"
    assert card.args[-1][1][1:4] == (None, 0, 0)


def test_store_range_refusals(card):
    """The pack's store range: one lane only, inside the bank, over the
    bank's own working carry; the wrapper refuses before any launch."""
    arrays, st = examples.example_case("base", G=8)
    buf = torch.from_numpy(pack_inputs1(arrays, *examples.pack_statics(st)))
    ss = examples.solve_statics(st)
    _, bank = ft.solve_scan_packed1_ckpt(buf, CK=2, device="cpu", **ss)
    carry = ft.bank_row(bank, 1)
    bs = fc.BankState(carry, bank)
    N = carry.used.shape[0]
    takes = torch.zeros((2, N), dtype=torch.int32)
    left = torch.zeros(2, dtype=torch.int64)
    lanes2 = ft.Carry(*[torch.stack([f, f]) for f in carry])
    for bad in (
            lambda: fc.pack_outputs_lanes(takes[None].expand(2, 2, N),
                                          left[None].expand(2, 2), lanes2,
                                          store=(bs, 2, 1)),
            lambda: fc.pack_outputs(takes, left, carry, store=(bs, 3, 2)),
            lambda: fc.pack_outputs(takes, left, carry, store=(bs, -1, 1)),
            lambda: fc.pack_outputs(takes, left, carry, store=(bs, 2, 0)),
            lambda: fc.pack_outputs(takes, left, ft.Carry(
                *[f.clone() for f in carry]), store=(bs, 2, 1))):
        with pytest.raises(ValueError):
            bad()
    assert card.launches() == []
    fc.pack_outputs(takes, left, carry, store=(bs, 2, 2))
    assert card.args[-1][1][2:4] == (2, 2)
    assert fc.LAUNCHES["pack_outputs"] == 1


def test_fused_launches_and_cluster_rule_on_the_states_device(card):
    """The fused state asks the cluster rule once, under cuda:1's guard,
    and keys it on cuda:1; the block scan enters the guard once; a
    launch alone enters it again."""
    lanes, st = examples.fused_mixed_lanes(2)
    inp = ft.kernel_inputs_from_numpy(lanes[0], "cpu")
    N = st["E"] + st["n_max"]
    fs = fc.FusedState(inp, ft.carry0(inp, N, st["E"]), E=st["E"],
                       P=st["P"], Fu=st["F"])
    assert fs.cluster == 2
    assert [k[0] for k in fc._CLUSTERS] == [1]
    assert card.calls == [("karp_ffd_fused_cluster", 1)]
    fc._fused_scan(fs)
    fc.ffd_fused_commit(fs, 0)
    assert fc.LAUNCHES["ffd_fused_commit"] == st["G"] // st["F"] + 1
    _on_card1(card, 3)


def test_pruned_launches_and_cluster_rule_on_the_states_device(card):
    """The probe's cluster rule under cuda:1's guard, keyed on cuda:1;
    the scan's 2*G launches under one guard; a probe alone under its
    own."""
    inp, st = _pruned_inputs("existing")
    N = st["E"] + st["n_max"]
    ps = fc.PrunedState(inp, ft.carry0_pruned(inp, N, st["E"]), E=st["E"],
                        P=st["P"], S=4)
    assert ps.cluster == ps.args.cluster == 2
    assert ps.rows == ps.args.rows == 1
    assert [k[0] for k in fc._PROBE_CLUSTERS] == [1]
    assert card.calls == [("karp_ffd_pruned_cluster", 1)]
    fc.pruned_steps(ps, 0, st["G"])
    assert fc.LAUNCHES["ffd_pruned_probe"] == \
        fc.LAUNCHES["ffd_pruned_commit"] == st["G"]
    fc.ffd_pruned_probe(ps, 3)
    _on_card1(card, 3)
    names = [n for n, _ in card.launches()]
    assert names[:4] == ["karp_ffd_pruned_probe", "karp_ffd_pruned_commit"] * 2


def test_consolidation_launches_on_its_device(card):
    """An absorb launch alone, and a subset round: its gather and 2*Gq K2
    launches under the round's one guard, the last commit carrying the
    summary rows' arguments (no ``karp_subset_summary``)."""
    arena, tprice, lanes, st = examples.subset_case("dead_nodes", 5)
    inp = ft.kernel_inputs_from_numpy(arena, "cpu")
    order = ("gid", "n", "dead", "keep", "removed_price")
    lane = [torch.from_numpy(lanes[k]) for k in order]
    rows = cc.subset_solve_cuda(inp, torch.from_numpy(tprice), *lane,
                                n_max=st["n_max"], E=st["E"], P=st["P"])
    Gq = lanes["gid"].shape[1]
    assert rows.shape == (lanes["gid"].shape[0], 5)
    names = [n for n, _ in card.launches()]
    assert names == ["karp_subset_gather"] + ["karp_ffd_slot_headroom",
                                              "karp_ffd_group_commit"] * Gq
    sums = [a[3] for n, a in card.args if n == "karp_ffd_group_commit"]
    assert [x is None for x in sums] == [True] * (Gq - 1) + [False]
    assert sums[-1]._obj.out == rows.data_ptr()
    assert "subset_summary" not in fc.LAUNCHES
    assert fc.LAUNCHES["subset_gather"] == 1
    assert fc.LAUNCHES["ffd_group_commit"] == Gq
    _on_card1(card, 1)
    E, D = inp.ex_alloc.shape
    B, G = 3, 2
    cc.consol_absorb(
        "deletions", ex_alloc=inp.ex_alloc, ex_used0=inp.ex_used0,
        compat=torch.ones((1, E), dtype=torch.bool),
        R=torch.ones((1, D), dtype=torch.int64),
        n=torch.ones((B, G), dtype=torch.int64),
        gid=torch.zeros((B, G), dtype=torch.int32),
        cid=torch.zeros((B, G), dtype=torch.int32),
        alive=torch.ones((B, E), dtype=torch.bool))
    _on_card1(card, 2)


def _absorb_kw(mode, B, E, G=3, D=8):
    """Inputs of ``consol_absorb(mode)`` at B lanes, E rows, G groups."""
    i64, b = torch.int64, torch.bool
    if mode == "dense":
        return dict(ex_alloc=torch.ones((B, E, D), dtype=i64),
                    ex_used0=torch.zeros((B, E, D), dtype=i64),
                    compat=torch.ones((B, G, E), dtype=b),
                    R=torch.ones((B, G, D), dtype=i64),
                    n=torch.ones((B, G), dtype=i64))
    kw = dict(ex_alloc=torch.ones((E, D), dtype=i64),
              ex_used0=torch.zeros((E, D), dtype=i64),
              compat=torch.ones((2, E), dtype=b),
              R=torch.ones((4, D), dtype=i64), n=torch.ones((B, G), dtype=i64),
              gid=torch.zeros((B, G), dtype=torch.int32),
              cid=torch.zeros((B, G), dtype=torch.int32),
              alive=torch.ones((B, E), dtype=b))
    if mode == "prescreen":
        T, P = 5, 2
        kw.update(type_alloc=torch.ones((T, D), dtype=i64),
                  type_price=torch.ones(T, dtype=i64),
                  tcompat=torch.ones((2, T), dtype=b),
                  padmit=torch.ones((P, 2), dtype=b),
                  pool_types=torch.ones((P, T), dtype=b),
                  price_cap=torch.ones(B, dtype=i64))
    return kw


@pytest.mark.parametrize("E,D,want_form", [
    (16, 8, 0), (1000, 8, 0), (1024, 8, 0), (1025, 8, 1), (1500, 6, 1),
    (100, 9, 1), (2100, 4, 1), (4096, 8, 2)])
@pytest.mark.parametrize("mode", ["deletions", "prescreen", "dense",
                                  "preempt"])
def test_absorb_one_launch_in_the_rules_form(card, mode, E, D, want_form):
    """Each mode is one ``karp_consol_absorb`` launch of its mode under one
    guard, whatever B or G; its form follows the rule (rows in registers at
    up to 4 of 8 dims a thread, else shared memory, else a global scratch
    of the lane's rows)."""
    B, G = 3, 4
    if mode == "preempt":
        out = cc.preempt_absorb(
            torch.ones((E, D), dtype=torch.int64),
            torch.zeros((E, D), dtype=torch.int64),
            torch.ones((G, E), dtype=torch.bool),
            torch.ones((G, D), dtype=torch.int64),
            torch.ones(G, dtype=torch.int64),
            torch.zeros((B, E, D), dtype=torch.int64))
    else:
        out = cc.consol_absorb(mode, **_absorb_kw(mode, B, E, G, D))
    assert out.shape == (B,)
    names = [n for n, _ in card.launches()]
    assert names == ["karp_consol_absorb"]
    args = card.args[-1][1]
    assert args[1] == {"deletions": 0, "prescreen": 1, "dense": 2,
                       "preempt": 3}[mode]
    a = args[0]._obj
    assert (a.B, a.G, a.E, a.D) == (B, G, E, D)
    assert a.form == want_form == cc.absorb_form(E, D)
    assert bool(a.scratch) == (want_form == 2)
    assert fc.LAUNCHES[f"consol_absorb_{mode}"] == 1
    assert sum(fc.LAUNCHES.values()) == 1
    _on_card1(card, 1)


@pytest.mark.parametrize("mode", ["deletions", "prescreen", "dense",
                                  "preempt"])
def test_absorb_no_lanes_launches_nothing(card, mode):
    """B = 0: an empty answer and no launch (CUDA refuses a grid of no
    blocks; the plain versions answer [0])."""
    E, G, D = 32, 3, 8
    if mode == "preempt":
        out = cc.preempt_absorb(
            torch.ones((E, D), dtype=torch.int64),
            torch.zeros((E, D), dtype=torch.int64),
            torch.ones((G, E), dtype=torch.bool),
            torch.ones((G, D), dtype=torch.int64),
            torch.ones(G, dtype=torch.int64),
            torch.zeros((0, E, D), dtype=torch.int64))
        assert out.dtype == torch.int64
    else:
        out = cc.consol_absorb(mode, **_absorb_kw(mode, 0, E, G, D))
        assert out.dtype == torch.bool
    assert out.shape == (0,)
    assert card.calls == [] and not any(fc.LAUNCHES.values())


@pytest.mark.parametrize("B", [0, 4])
def test_subset_round_of_no_groups_launches_nothing(card, B):
    """A subset round of Gq = 0 (or of no lanes) launches nothing and
    answers the reference's rows, [0, 0, 0, 0, removed_price] a lane, the
    plain version's on the same inputs."""
    arena, tprice, lanes, st = examples.subset_case("dead_nodes", 4, B=4)
    inp = ft.kernel_inputs_from_numpy(arena, "cpu")
    t = {k: torch.from_numpy(v[:B]) for k, v in lanes.items()}
    t["gid"], t["n"] = t["gid"][:, :0], t["n"][:, :0]
    order = ("gid", "n", "dead", "keep", "removed_price")
    rows = cc.subset_solve_cuda(inp, torch.from_numpy(tprice),
                                *(t[k] for k in order), **st)
    assert card.calls == [] and not any(fc.LAUNCHES.values())
    want = ct._subset_solve_ref(inp, torch.from_numpy(tprice),
                                *(t[k] for k in order), **st) if B else \
        torch.zeros((0, 5), dtype=torch.int64)
    assert rows.shape == (B, 5) and torch.equal(rows, want)
    assert torch.equal(rows[:, 4], t["removed_price"])


def test_topology_scan_launches_on_its_device(card):
    """Every K9 and K2 launch of a topology scan under one guard."""
    arrays, rows, st = examples.topo_case("config3_small")
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    trows = tt.topo_rows_from_numpy(rows, "cpu")
    tc.solve_scan_topo_cuda(
        inp, trows, torch.zeros((st["GZ"], st["Z"]), dtype=torch.int64),
        torch.zeros((st["GH"], st["n_max"]), dtype=torch.int64),
        n_max=st["n_max"], P=st["P"])
    assert fc.LAUNCHES["topo_pour"] > 0
    _on_card1(card, 1)
    card.guards.clear()
    ts = tc.topo_state(inp, trows, torch.zeros((st["GZ"], st["Z"]),
                                               dtype=torch.int64),
                       torch.zeros((st["GH"], st["n_max"]),
                                   dtype=torch.int64),
                       n_max=st["n_max"], P=st["P"], EVCAP=128, PMAX=8)
    tc.plain_commit(ts, ts.has_topo.index(False))
    assert card.launches()[-1][0] == "karp_ffd_group_commit"
    _on_card1(card, 1)


def test_mesh_step_loop_launches_on_its_device(card):
    """A mesh state on cuda:1: the step loop enters its guard once for
    every K10 launch; a launch alone enters it again."""
    arrays, st = examples.mesh_case("fixture")
    lay = pm.MeshComm.single()
    N = st["E"] + st["n_max"]
    T = np.asarray(arrays["A"]).shape[0]
    names = [f for f in pm.FIELDS if arrays.get(f) is not None]
    inp = ft.KernelInputs(**pm._shard_inputs(arrays, lay, names, T, N, N, 0,
                                             torch.device("cpu")))
    state = mc.MeshState(inp, E=st["E"], P=st["P"], V=0, N=N, slot0=0)

    class OnCard1(mc.MeshState):
        device = CUDA1
    state.__class__ = OnCard1
    pm._mesh_scan(state, lay)
    G = inp.R.shape[0]
    assert fc.LAUNCHES["mesh_commit"] == G and \
        fc.LAUNCHES["mesh_new_caps"] == 1
    mc.mesh_commit(state, 0)
    _on_card1(card, 2)


def test_fused_cluster_keys_on_the_given_device(card):
    assert fc.fused_cluster(3, 4, 2, 4, 16, device="cuda:1") == 2
    assert fc.fused_cluster(3, 4, 2, 4, 16, device="cuda:1") == 2
    assert list(fc._CLUSTERS) == [(1, 3, 4, 2, 4, 16)]
    assert card.calls == [("karp_ffd_fused_cluster", 1)]
    assert card.guards == [CUDA1]


def _rank_body(rank, world):
    return rank * 10 + world


@pytest.mark.parametrize("backend,device,want", [
    ("nccl", None, [1]), ("gloo", "cuda", [1]), ("gloo", "cpu", []),
    ("gloo", None, [])])
def test_rank_main_sets_a_cuda_ranks_device(monkeypatch, tmp_path, backend,
                                            device, want):
    """Rank 3 of 4 on two cards: a CUDA rank (nccl, or a CUDA device)
    makes cuda:{3 % 2} current before its body runs; a CPU rank does not
    touch the card."""
    seen = []
    monkeypatch.setattr(ranks.dist, "init_process_group",
                        lambda *a, **k: None)
    monkeypatch.setattr(ranks.dist, "destroy_process_group", lambda: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", seen.append)
    ranks._rank_main(3, _rank_body, 4, backend, str(tmp_path), 5.0, 0, (),
                     device)
    assert seen == want
    assert (tmp_path / "3.out").exists()


def test_summary_refusals(card):
    """A summary row rides only a lane-axis commit of the window's last
    group, without minValues floors or a membership record; the wrappers
    refuse before any launch."""
    arena, tprice, lanes, st = examples.subset_case("plain", 0)
    inp = ft.kernel_inputs_from_numpy(arena, "cpu")
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    g = cc.subset_gather(inp, t["gid"], t["n"], t["dead"], t["keep"])
    E, P, B = st["E"], st["P"], lanes["gid"].shape[0]
    Gq = lanes["gid"].shape[1]
    sub = fc.ScanState(g, ft.carry0(g, E + st["n_max"], E, lanes=B), E=E,
                       P=P, lanes=B)
    args, _ = cc.summary_args(sub, t["keep"], torch.from_numpy(tprice),
                              t["removed_price"])
    card.calls.clear()
    with pytest.raises(ValueError, match="last group"):
        fc.ffd_group_commit(sub, Gq - 2, summary=args)
    with pytest.raises(ValueError, match="record"):
        fc.ffd_group_commit(sub, Gq - 1, summary=args,
                            record=fc._RecordArgs())
    # minValues floors (K > 0)
    arrays, mst = examples.example_case("min_values")
    minp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    one = fc.ScanState(minp, ft.carry0(minp, mst["E"] + mst["n_max"],
                                       mst["E"]), E=mst["E"], P=mst["P"],
                       V=mst["V"])
    assert one.args.K > 0
    with pytest.raises(ValueError, match="minValues"):
        fc.ffd_group_commit(one, mst["G"] - 1, summary=cc._SummaryArgs())
    with pytest.raises(ValueError, match="lane axis"):
        cc.summary_args(one, t["keep"], torch.from_numpy(tprice),
                        t["removed_price"])
    assert card.launches() == []
    fc.ffd_group_commit(sub, Gq - 1, summary=args)
    assert card.args[-1][1][3] is not None
