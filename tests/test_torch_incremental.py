"""The port's incremental-solve policy and the plain versions of K3 (the
checkpointed scan and the suffix re-solve) held against the reference
package on the CPU.

Tolerance: exact. The scan is integer math end to end, so one differing
output word or bank byte is a failure. Arenas come from a numpy seed
through the reference's own example arrays; for each case and each
live bound GL of a G=8, CK=2 arena (groups past GL emptied), every
(jr, SUF) the bound allows is run. Every one of them is held to the
reference's checkpointed full solve on the same arena (its output rows
and its bank, which a suffix on a clean arena must reproduce), and a
spread of (SUF, GL) pairs is held word for word to the reference's own
``solve_scan_suffix`` — enough static sets to cover every bucket and
bound while keeping the reference's compiles to twelve.
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _example_arrays
from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu.ops import hostpack as hp_jax
from karpenter_provider_aws_tpu.solver import incremental as inc_ref
from karpenter_provider_aws_tpu.tenancy.bucketing import _pow15 as ref_pow15
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import ffd_torch
from karpenter_provider_aws_tpu_torch.ops import hostpack as hp_torch
from karpenter_provider_aws_tpu_torch.solver import incremental as inc


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain scan is thousands of small tensor ops: one intra-op
    thread runs them fastest, and several test workers on one host then
    do not oversubscribe the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


CK = 2
G = 8

#: (SUF, GL) pairs held word for word to the reference's suffix, per case
JAX_SUFFIXES = {"base": ((1, 2), (2, 4), (4, 8)),
                "existing": ((3, 6), (1, 8), (1, 4)),
                "min_values": ((1, 6), (2, 8), (3, 8))}


def test_constants_match_reference():
    assert (inc.CKPT_CHUNK, inc.CKPT_MAX_GROUPS) == \
        (inc_ref.CKPT_CHUNK, inc_ref.CKPT_MAX_GROUPS)
    for v in range(0, 300):
        assert inc._pow15(v) == ref_pow15(v), v


@pytest.mark.parametrize("Gp", [1, 2, 4, 6, 8, 16, 32, 64, 512, 1024])
def test_planning_helpers_match_reference(Gp):
    for kw in (dict(), dict(ndev=2), dict(use_pruned=True), dict(Fu=2),
               dict(CK=4)):
        assert inc.ckpt_eligible(Gp, **kw) == \
            inc_ref.ckpt_eligible(Gp, **kw), kw
    if Gp % CK or Gp < CK:
        return
    for GL in range(CK, Gp + 1, CK):
        gl = None if GL == Gp else GL
        assert inc.suffix_buckets(Gp, CK, GL=gl) == \
            inc_ref.suffix_buckets(Gp, CK, GL=gl)
        for frontier in range(-1, Gp + 2):
            assert inc.suffix_plan(frontier, Gp, CK, GL=gl) == \
                inc_ref.suffix_plan(frontier, Gp, CK, GL=gl), \
                (frontier, GL)


def test_live_bound_matches_reference():
    rng = np.random.RandomState(5)
    T, D = 3, 4
    for Gp in (4, 8, 16):
        off = T * D + Gp * D
        for _ in range(20):
            buf = np.zeros(off + Gp, dtype=np.int64)
            live = rng.randint(0, Gp + 1)
            buf[off:off + live] = rng.randint(0, 3, size=live)
            for ck in (2, 4):
                assert inc.live_bound(buf, T=T, D=D, G=Gp, CK=ck) == \
                    inc_ref.live_bound(buf, T=T, D=D, G=Gp, CK=ck)


def _arena(case, GL):
    """(packed arena, statics) of one case with groups [GL, G) emptied."""
    arrays, st = examples.example_case(case, base=_example_arrays, G=G)
    arrays["n"] = arrays["n"].copy()
    arrays["n"][GL:] = 0
    return hp_jax.pack_inputs1(arrays, *examples.pack_statics(st)), st


def _bank_np(bank):
    return [np.asarray(f).reshape(-1) for f in bank]


def _port_bank(bank_np, like):
    """A port bank (Carry of tensors) from reference bank leaves."""
    return ffd_torch.Carry(*[torch.from_numpy(np.array(a)).to(t.dtype)
                             .reshape(t.shape)
                             for a, t in zip(bank_np, like)])


@pytest.mark.parametrize("case", ["base", "existing", "min_values"])
def test_k3_plain_versions_byte_identical(case):
    ss = examples.solve_statics(examples.example_case(
        case, base=_example_arrays, G=G)[1])
    for GL in range(CK, G + 1, CK):
        buf, st = _arena(case, GL)
        assert inc.live_bound(buf, T=st["T"], D=st["D"], G=G) == GL
        want_out, jax_bank = ffd_jax.solve_scan_packed1_ckpt(buf, CK=CK,
                                                             **ss)
        want_out = np.asarray(want_out)
        want_bank = _bank_np(jax_bank)
        got_out, got_bank = ffd_torch.solve_scan_packed1_ckpt(
            buf, CK=CK, device="cpu", **ss)
        np.testing.assert_array_equal(got_out.numpy(), want_out)
        assert got_bank.num_nodes.shape == (G // CK,)
        assert got_bank.pool.dtype == torch.int32
        for nm, g, w in zip(ffd_torch.Carry._fields, got_bank, want_bank):
            np.testing.assert_array_equal(g.numpy().reshape(-1), w,
                                          err_msg=f"{case} GL={GL} {nm}")
        full = hp_jax.unpack_outputs1(want_out.copy(), **{
            k: ss[k] for k in "T D Z C G E P n_max".split()})
        # the plain non-checkpointed solve agrees with the recorded one
        np.testing.assert_array_equal(
            ffd_torch.solve_scan_packed1(buf, device="cpu", **ss).numpy(),
            want_out)
        for SUF in range(1, GL // CK + 1):
            s0 = GL - SUF * CK
            bank = _port_bank(want_bank, got_bank)
            out, spliced = ffd_torch.solve_scan_suffix(
                buf, bank, CK=CK, SUF=SUF, GL=GL, device="cpu", **ss)
            assert spliced is bank            # spliced in place
            sv = hp_torch.unpack_outputs1(out.numpy(), st["T"], st["D"],
                                          st["Z"], st["C"], SUF * CK,
                                          st["E"], st["P"], st["n_max"])
            # the suffix equals the rows of the from-scratch full solve
            np.testing.assert_array_equal(sv["takes"],
                                          full["takes"][s0:GL])
            np.testing.assert_array_equal(sv["leftover"],
                                          full["leftover"][s0:GL])
            for nm in ("used", "pool", "num_nodes", "pool_used", "types",
                       "zones", "ct", "alive"):
                np.testing.assert_array_equal(sv[nm], full[nm],
                                              err_msg=f"{GL} {SUF} {nm}")
            # on a clean arena the spliced bank is the recorded bank
            for nm, g, w in zip(ffd_torch.Carry._fields, spliced,
                                want_bank):
                np.testing.assert_array_equal(
                    g.numpy().reshape(-1), w,
                    err_msg=f"bank {nm} GL={GL} SUF={SUF}")
            if (SUF, GL) not in JAX_SUFFIXES[case]:
                continue
            ref_out, ref_bank = ffd_jax.solve_scan_suffix(
                buf, jax_bank, CK=CK, SUF=SUF, GL=GL, **ss)
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
            for nm, g, w in zip(ffd_torch.Carry._fields, spliced,
                                _bank_np(ref_bank)):
                np.testing.assert_array_equal(g.numpy().reshape(-1), w,
                                              err_msg=f"jax bank {nm}")


def test_suffix_resumes_from_a_stale_bank():
    """The tick the suffix exists for: the bank was recorded on the
    previous arena, a group at or past the resume point changed, and the
    suffix gives the new arena's full solve and the new arena's bank."""
    arrays, st = examples.example_case("existing", base=_example_arrays,
                                       G=G)
    ss = examples.solve_statics(st)
    old = hp_torch.pack_inputs1(arrays, *examples.pack_statics(st))
    _, bank = ffd_torch.solve_scan_packed1_ckpt(old, CK=CK, device="cpu",
                                                **ss)
    arrays["n"] = arrays["n"].copy()
    arrays["n"][5] += 7
    new = hp_torch.pack_inputs1(arrays, *examples.pack_statics(st))
    want_out, want_bank = ffd_torch.solve_scan_packed1_ckpt(
        new, CK=CK, device="cpu", **ss)
    full = hp_torch.unpack_outputs1(want_out.numpy(), st["T"], st["D"],
                                    st["Z"], st["C"], G, st["E"], st["P"],
                                    st["n_max"])
    jr, SUF = inc.suffix_plan(5, G, CK)
    assert jr * CK <= 5
    out, bank = ffd_torch.solve_scan_suffix(new, bank, CK=CK, SUF=SUF,
                                            device="cpu", **ss)
    sv = hp_torch.unpack_outputs1(out.numpy(), st["T"], st["D"], st["Z"],
                                  st["C"], SUF * CK, st["E"], st["P"],
                                  st["n_max"])
    np.testing.assert_array_equal(sv["takes"], full["takes"][jr * CK:])
    np.testing.assert_array_equal(sv["used"], full["used"])
    for nm, g, w in zip(ffd_torch.Carry._fields, bank, want_bank):
        assert torch.equal(g, w), nm


def test_suffix_refuses_a_bank_on_another_device():
    arrays, st = examples.example_case("base", G=G)
    buf = hp_torch.pack_inputs1(arrays, *examples.pack_statics(st))
    ss = examples.solve_statics(st)
    _, bank = ffd_torch.solve_scan_packed1_ckpt(buf, CK=CK, device="cpu",
                                                **ss)
    bank = bank._replace(used=bank.used.to("meta"))
    with pytest.raises(ValueError, match="bank on"):
        ffd_torch.solve_scan_suffix(buf, bank, CK=CK, SUF=1, device="cpu",
                                    **ss)
