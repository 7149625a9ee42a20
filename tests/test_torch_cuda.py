"""The CUDA kernels of the port held against their plain PyTorch versions
on the card, at small shapes. Tolerance: exact (integer math).

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


@pytest.mark.parametrize("case", examples.CASES)
def test_group_kernels_step_by_step(cuda_device, case):
    """Each group's two kernels from the plain carry, against the plain
    step: cand and k after phase 1; carry, takes, leftover after 2."""
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
        carry, take, n_rem = ft._group_step_ref(inp, carry, g, E=E, P=P,
                                                V=V)
        ffd_cuda.ffd_group_commit(state, g)
        for f, got, want in zip(ft.Carry._fields, state.carry, carry):
            assert torch.equal(got, want), (g, f)
        assert torch.equal(state.takes[g], take.to(torch.int32)), g
        assert int(state.leftover[g]) == int(n_rem), g


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
    assert ffd_cuda.LAUNCHES == {"unpack_bits": 1,
                                 "ffd_slot_headroom": st["G"],
                                 "ffd_group_commit": st["G"],
                                 "pack_outputs": 1,
                                 "ffd_bank_store": 0, "ffd_bank_load": 0}


@pytest.mark.parametrize("case", ["base", "existing", "min_values"])
def test_bank_kernels(cuda_device, case):
    """ffd_bank_store (one row and a run of rows) and ffd_bank_load
    against the plain store and bank_row, on carries of a real scan."""
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
    for g in range(G):
        carry, _, _ = ft._group_step_ref(inp, carry, g, E=E, P=P, V=V)
        for dst, src in zip(bs.carry, carry):
            dst.copy_(src)
        count = G - g if g == G // 2 else 1
        ffd_cuda.ffd_bank_store(bs, g, count)
        ft._bank_store_ref(want, carry, g, count)
        for nm, got, w in zip(ft.Carry._fields, bank, want):
            assert torch.equal(got, w), (g, nm)
    for j in range(G):
        ffd_cuda.ffd_bank_load(bs, j)
        for nm, got, w in zip(ft.Carry._fields, bs.carry,
                              ft.bank_row(want, j)):
            assert torch.equal(got, w), (j, nm)


@pytest.mark.parametrize("case", ["base", "existing", "min_values"])
def test_ckpt_and_suffix_on_card(cuda_device, case):
    """The checkpointed solve and every (SUF, GL) suffix of a G=8, CK=2
    arena on the card equal the plain versions on the CPU (output buffer
    and bank), and each suffix equals the rows of the full solve."""
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
        assert ffd_cuda.LAUNCHES["ffd_bank_store"] == G // CK
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
            assert ffd_cuda.LAUNCHES["ffd_bank_load"] == 1
            assert ffd_cuda.LAUNCHES["ffd_group_commit"] == SUF * CK
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
    assert warm.last_dispatch_stats["launches"]["ffd_bank_load"] == 1
