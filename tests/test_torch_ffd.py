"""The port's packed FFD scan (karpenter_provider_aws_tpu_torch.ops) held
against the reference JAX kernel (karpenter_provider_aws_tpu.ops.ffd_jax)
on the CPU.

Tolerance: exact. The scan is integer math end to end, so one differing
output word is a failure. The arenas come from a numpy seed through the
reference's own example builder (``__graft_entry__._example_arrays``);
each named case exercises one read path of the kernel.
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _example_arrays
from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu.native import pack_bits as ref_pack_bits
from karpenter_provider_aws_tpu.ops import hostpack as hp_jax
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import ffd_torch
from karpenter_provider_aws_tpu_torch.ops import hostpack as hp_torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain scan is thousands of small tensor ops: one intra-op
    thread runs them fastest, and several test workers on one host then
    do not oversubscribe the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _case(name):
    return examples.example_case(name, base=_example_arrays)


@pytest.mark.parametrize("case", examples.CASES)
def test_packed_solve_byte_identical(case):
    arrays, st = _case(case)
    buf = hp_jax.pack_inputs1(arrays, *examples.pack_statics(st))
    want = np.asarray(ffd_jax.solve_scan_packed1(
        buf, **examples.solve_statics(st)))
    got = ffd_torch.solve_scan_packed1(
        buf, device="cpu", **examples.solve_statics(st))
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_cases_exercise_their_read_paths():
    """Each case reaches what it names: existing takes, leftovers from
    binding limits and exhausted slots, two pools opening nodes."""
    def solved(name):
        arrays, st = _case(name)
        buf = hp_torch.pack_inputs1(arrays, *examples.pack_statics(st))
        out = ffd_torch.solve_scan_packed1(
            buf, device="cpu", **examples.solve_statics(st)).numpy()
        return hp_torch.unpack_outputs1(
            out, st["T"], st["D"], st["Z"], st["C"], st["G"], st["E"],
            st["P"], st["n_max"]), st
    out, st = solved("existing")
    assert out["takes"][:, :st["E"]].sum() > 0
    assert solved("pool_limits")[0]["leftover"].sum() > 0
    assert solved("slots_run_out")[0]["leftover"].sum() > 0
    assert set(np.unique(solved("two_pools")[0]["pool"])) >= {0, 1}


def test_example_builder_copy_matches_reference():
    for case in examples.CASES:
        a, sa = _case(case)
        b, sb = examples.example_case(case)
        assert sa == sb
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("case", ["existing", "min_values"])
def test_unpacked_scan_matches_reference(case):
    """solve_scan on KernelInputs built by kernel_inputs_from_numpy gives
    the reference's takes, leftover and final carry."""
    import jax.numpy as jnp
    arrays, st = _case(case)
    E, P, V, n_max = st["E"], st["P"], st["V"], st["n_max"]
    ref_inp = ffd_jax.KernelInputs(**{k: jnp.asarray(v)
                                      for k, v in arrays.items()})
    t1, l1, c1 = ffd_jax.solve_scan(ref_inp, n_max=n_max, E=E, P=P, V=V)
    inp = ffd_torch.kernel_inputs_from_numpy(arrays, "cpu")
    t2, l2, c2 = ffd_torch.solve_scan(inp, n_max, E, P, V)
    assert t2.dtype == torch.int32
    np.testing.assert_array_equal(t2.numpy(), np.asarray(t1))
    np.testing.assert_array_equal(l2.numpy(), np.asarray(l1))
    for f in ffd_torch.Carry._fields:
        np.testing.assert_array_equal(
            getattr(c2, f).numpy().reshape(-1),
            np.asarray(getattr(c1, f)).reshape(-1), err_msg=f)


def test_carry_resumes_from_reference_state():
    """State carried across: the reference's carry after the first half
    of the groups, moved into the port by carry_from_numpy, resumes to
    the reference's full-scan result."""
    import jax.numpy as jnp
    arrays, st = _case("daemon")
    E, P, n_max, G = st["E"], st["P"], st["n_max"], st["G"]
    half = {k: (v[:G // 2] if k in ("R", "n", "F", "agz", "agc", "admit",
                                    "daemon", "ex_compat") else v)
            for k, v in arrays.items()}
    ref_half = ffd_jax.KernelInputs(**{k: jnp.asarray(v)
                                       for k, v in half.items()})
    _, _, c_half = ffd_jax.solve_scan(ref_half, n_max=n_max, E=E, P=P)
    ref_full = ffd_jax.KernelInputs(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()})
    t_full, l_full, c_full = ffd_jax.solve_scan(ref_full, n_max=n_max, E=E,
                                                P=P)
    carry = ffd_torch.carry_from_numpy(
        {f: np.asarray(getattr(c_half, f)) for f in c_half._fields}, "cpu")
    assert carry.pool.dtype == torch.int32 and carry.num_nodes.shape == (1,)
    inp = ffd_torch.kernel_inputs_from_numpy(arrays, "cpu")
    for g in range(G // 2, G):
        carry, take, n_rem = ffd_torch._group_step_ref(inp, carry, g, E=E,
                                                       P=P, V=0)
        np.testing.assert_array_equal(take.to(torch.int32).numpy(),
                                      np.asarray(t_full)[g])
        assert int(n_rem) == int(np.asarray(l_full)[g])
    for f in ffd_torch.Carry._fields:
        np.testing.assert_array_equal(
            getattr(carry, f).numpy().reshape(-1),
            np.asarray(getattr(c_full, f)).reshape(-1), err_msg=f)


@pytest.mark.parametrize("case", ["base", "existing", "min_values",
                                  "two_pools", "priority"])
def test_hostpack_byte_identical(case):
    """The port's hostpack copy packs and unpacks exactly like the
    reference's (whose bit packer may be the native codec)."""
    arrays, st = _case(case)
    args = examples.pack_statics(st)
    b1, bl1 = hp_jax.pack_inputs1_state(arrays, *args)
    b2, bl2 = hp_torch.pack_inputs1_state(arrays, *args)
    assert b2.dtype == np.int64
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(bl1, bl2)
    out = np.asarray(ffd_jax.solve_scan_packed1(
        b1, **examples.solve_statics(st)))
    oargs = (st["T"], st["D"], st["Z"], st["C"], st["G"], st["E"], st["P"],
             st["n_max"])
    u1, u2 = hp_jax.unpack_outputs1(out, *oargs), \
        hp_torch.unpack_outputs1(out, *oargs)
    assert sorted(u1) == sorted(u2)
    for k in u1:
        np.testing.assert_array_equal(u1[k], u2[k], err_msg=k)
        assert u1[k].dtype == u2[k].dtype, k
    prio = arrays.get("prio")
    assert hp_jax.tier_leftovers(u1["leftover"], prio) == \
        hp_torch.tier_leftovers(u2["leftover"], prio)
    assert hp_jax.in_layout_i64(*args) == hp_torch.in_layout_i64(*args)
    assert hp_jax.in_layout_bool(*args) == hp_torch.in_layout_bool(*args)


def test_i32_words_and_bits_round_trip():
    rng = np.random.RandomState(3)
    vals = rng.randint(-(1 << 31), 1 << 31, size=101).astype(np.int64)
    w1, w2 = hp_jax.pack_i32_words(vals), hp_torch.pack_i32_words(vals)
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(hp_torch.unpack_i32_words(w2, 101), vals)
    np.testing.assert_array_equal(
        ffd_torch._i32_to_words_ref(torch.from_numpy(vals).to(torch.int32)
                                    ).numpy(), w1)
    bits = rng.rand(333) < 0.5
    bits[63] = bits[127] = True      # bit 63 is the sign bit of a word
    words = hp_torch.pack_bits(bits)
    np.testing.assert_array_equal(words, ref_pack_bits(bits))
    np.testing.assert_array_equal(
        ffd_torch._bits_to_words_ref(torch.from_numpy(bits)).numpy(), words)
    np.testing.assert_array_equal(
        ffd_torch._unpack_bits_ref(torch.from_numpy(words), 333).numpy(),
        bits)
    np.testing.assert_array_equal(hp_torch.unpack_bits(words, 333), bits)


def test_fused_arena_refused():
    """The fused scan (F > 1) runs now; what stays refused is a fused
    arena with minValues floors (the solver packs F = 1 when K > 0) and
    a width that does not divide G, on the single and the lane-axis
    entry point alike."""
    arrays, st = _case("min_values")
    buf = hp_torch.pack_inputs1(arrays, *examples.pack_statics(st))
    with pytest.raises(ValueError, match="minValues"):
        ffd_torch.solve_scan_packed1(buf, device="cpu", F=4,
                                     **examples.solve_statics(st))
    with pytest.raises(ValueError, match="minValues"):
        ffd_torch.solve_scan_packed1_many(buf[None], device="cpu", F=4,
                                          **examples.solve_statics(st))
    arrays, st = _case("base")
    buf = hp_torch.pack_inputs1(arrays, *examples.pack_statics(st))
    with pytest.raises(ValueError, match="divide"):
        ffd_torch.solve_scan_packed1(buf, device="cpu", F=3,
                                     **examples.solve_statics(st))
