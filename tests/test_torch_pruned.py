"""The port's pruned G-axis scan (K6) and its host engine held against the
reference package on the CPU.

- Scan parity: the plain ``solve_scan_packed1_pruned`` / ``_many`` of
  ``ops/ffd_torch.py`` against the reference's jitted kernels of the same
  names on the same numpy arenas, every output word and the trailing
  bail word included. The arenas (``examples.pruned_case``) carry
  existing nodes with one over-committed, two pools with binding limits,
  daemon overhead and an all-zero request row met by eight or more
  compatible slots (the prefix wraps int64), at S = 1, 2 and S >= N
  (the clamp: never a bail).
- Host engine: the port's copy of ``ops/ffd.py`` against the original,
  NodeState and every group's (take, leftover).
- Solver routing: ``CUDASolver(device="cpu")`` against the reference
  ``CPUSolver`` on a high-G snapshot routed onto the pruned path, a
  forced bail (host-served, recorded), and a snapshot with no instance
  types.

Tolerance: exact (int64 and bool).
"""

import numpy as np
import pytest
import torch

import karpenter_provider_aws_tpu.apis.labels as L_ref
import karpenter_provider_aws_tpu.apis.resources as res_ref
import karpenter_provider_aws_tpu.fake.environment as env_ref
import karpenter_provider_aws_tpu.solver.types as types_ref
import karpenter_provider_aws_tpu_torch.apis.labels as L_port
import karpenter_provider_aws_tpu_torch.apis.resources as res_port
import karpenter_provider_aws_tpu_torch.fake.environment as env_port
import karpenter_provider_aws_tpu_torch.solver.types as types_port
from __graft_entry__ import _example_arrays
from karpenter_provider_aws_tpu.models import delta as delta_ref
from karpenter_provider_aws_tpu.models import encoding as enc_ref
from karpenter_provider_aws_tpu.ops import ffd as ffd_ref
from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu.ops import hostpack as hp_jax
from karpenter_provider_aws_tpu.solver import CPUSolver
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.models import delta as delta_port
from karpenter_provider_aws_tpu_torch.models import encoding as enc_port
from karpenter_provider_aws_tpu_torch.ops import ffd as ffd_port
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
from karpenter_provider_aws_tpu_torch.ops import hostpack as hp_torch
from karpenter_provider_aws_tpu_torch.solver import CUDASolver


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain scan is thousands of small tensor ops: one intra-op
    thread runs them fastest, and several test workers on one host then
    do not oversubscribe the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def both_counters():
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()
    yield
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()


def _arena(name):
    arrays, st = examples.pruned_case(name, base=_example_arrays)
    return hp_jax.pack_inputs1(arrays, *examples.pack_statics(st)), st


@pytest.mark.parametrize("S", [1, 2, 64])
@pytest.mark.parametrize("case", examples.PRUNED_CASES)
def test_pruned_scan_byte_identical(case, S):
    buf, st = _arena(case)
    want = np.asarray(ffd_jax.solve_scan_packed1_pruned(
        buf, S=S, **examples.pruned_statics(st)))
    got = ft.solve_scan_packed1_pruned(buf, S=S, device="cpu",
                                       **examples.pruned_statics(st))
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    if S >= st["E"] + st["n_max"]:
        # the selection clamps to the slot count: exact, never a bail,
        # and the outputs are the base scan's
        assert want[-1] == 0
        base = np.asarray(ffd_jax.solve_scan_packed1(
            buf, **examples.solve_statics(st)))
        np.testing.assert_array_equal(got.numpy()[:-1], base)
    else:
        assert want[-1] == 1   # these arenas' fills outrun one or two slots


def test_cases_reach_their_hazards():
    """The zero-R row meets at least eight compatible selected slots,
    each with k = BIG (so the exclusive prefix wraps int64); the
    existing case has an over-committed node and existing takes; the
    pool-limit case leaves pods over."""
    buf, st = _arena("zero_r_row")
    E, P, N = st["E"], st["P"], st["E"] + st["n_max"]
    inp = ft._packed_inputs_ref(torch.from_numpy(buf), st["T"], st["D"],
                                st["Z"], st["C"], st["G"], E, P, 0, 0, 0)
    carry = ft.carry0_pruned(inp, N, E)
    for g in range(st["G"] - 1):
        carry, _, _ = ft._pruned_group_step_ref(inp, carry, g, E=E, P=P,
                                                S=N)
    sel, cnt = ft._pruned_select_ref(inp, carry, st["G"] - 1, E=E, P=P, S=N)
    _, k_s = ft._pruned_headroom_ref(inp, carry, st["G"] - 1, sel)
    assert int(cnt[0]) >= 8 and int((k_s == ft.BIG).sum()) >= 8

    arrays, st = examples.pruned_case("existing")
    assert (arrays["ex_used0"] > arrays["ex_alloc"]).any()
    out = ft.solve_scan_packed1_pruned(
        hp_torch.pack_inputs1(arrays, *examples.pack_statics(st)), S=64,
        device="cpu", **examples.pruned_statics(st)).numpy()
    dec = hp_torch.unpack_outputs1(out[:-1], st["T"], st["D"], st["Z"],
                                   st["C"], st["G"], st["E"], st["P"],
                                   st["n_max"])
    assert dec["takes"][:, :st["E"]].sum() > 0

    buf, st = _arena("pool_limits")
    out = ft.solve_scan_packed1_pruned(buf, S=64, device="cpu",
                                       **examples.pruned_statics(st)).numpy()
    dec = hp_torch.unpack_outputs1(out[:-1], st["T"], st["D"], st["Z"],
                                   st["C"], st["G"], st["E"], st["P"],
                                   st["n_max"])
    assert dec["leftover"].sum() > 0


def test_pruned_many_lanes_own_bail_words():
    """Three lanes of different contents in one dispatch: only the first
    bails, each row is the single solve of its arena, and the stack is
    the reference's ``_many`` byte for byte."""
    lanes, st = examples.pruned_lanes(base=_example_arrays)
    S = examples.PRUNED_LANES_S
    bufs = np.stack([hp_jax.pack_inputs1(a, *examples.pack_statics(st))
                     for a in lanes])
    want = np.asarray(ffd_jax.solve_scan_packed1_pruned_many(
        bufs, S=S, **examples.pruned_statics(st)))
    got = ft.solve_scan_packed1_pruned_many(bufs, S=S, device="cpu",
                                            **examples.pruned_statics(st))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:, -1].tolist() == [1, 0, 0]
    assert len({r.tobytes() for r in want}) == 3
    for b in range(3):
        one = ft.solve_scan_packed1_pruned(bufs[b], S=S, device="cpu",
                                           **examples.pruned_statics(st))
        np.testing.assert_array_equal(one.numpy(), want[b])


def test_lane_views_stride_over_the_arena_stack():
    """``_unpack_inputs_lanes`` on a [B, W] stack gives, lane by lane,
    the single arena's inputs, as views whose lanes are W words apart
    (the stride the kernels' lane axis takes, not the field's size)."""
    lanes, st = examples.pruned_lanes()
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    bufs = torch.from_numpy(np.stack(
        [hp_torch.pack_inputs1(a, *examples.pack_statics(st))
         for a in lanes]))
    n_i64 = hp_torch.layout_sizes(hp_torch.in_layout_i64(T, D, Z, C, G, E,
                                                         P))
    n_bits = hp_torch.layout_sizes(hp_torch.in_layout_bool(T, D, Z, C, G,
                                                           E, P))
    bools = torch.stack([ft._unpack_bits_ref(b[n_i64:], n_bits)
                         for b in bufs])
    inp = ft._unpack_inputs_lanes(bufs[:, :n_i64], bools, T, D, Z, C, G, E,
                                  P)
    W = bufs.shape[1]
    assert inp.n.stride(0) == W and inp.daemon.stride(0) == W
    assert inp.F.stride(0) == n_bits
    for b in range(3):
        one = ft._packed_inputs_ref(bufs[b], T, D, Z, C, G, E, P, 0, 0, 0)
        for nm, t in zip(ft.KernelInputs._fields, inp):
            if t is not None:
                assert torch.equal(t[b], getattr(one, nm)), (b, nm)
    assert not torch.equal(inp.n[0], inp.n[1])


def test_out_i64_lane_axis_is_each_lanes_section():
    """The output's i64 section on a lane axis (what the lane-axis
    ``pack_outputs`` writes) is, row by row, the one-lane section, which
    opens each lane's packed output buffer."""
    lanes, st = examples.pruned_lanes()
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    S = examples.PRUNED_LANES_S
    finals = []
    for a in lanes:
        buf = torch.from_numpy(hp_torch.pack_inputs1(
            a, *examples.pack_statics(st)))
        inp = ft._packed_inputs_ref(buf, T, D, Z, C, G, E, P, 0, 0, 0)
        takes, lefts, carry = ft._solve_pruned_ref(inp, st["n_max"], E, P, S)
        finals.append((lefts, ft.Carry(*carry[:8]), takes))
    stacked = ft.Carry(*[torch.stack([f[1][i] for f in finals])
                         for i in range(8)])
    sec = ft._out_i64(torch.stack([f[0] for f in finals]), stacked, lanes=3)
    for b, (lefts, carry, takes) in enumerate(finals):
        one = ft._out_i64(lefts, carry)
        assert torch.equal(sec[b], one)
        packed = ft._pack_outputs_ref(takes, lefts, carry)
        assert torch.equal(packed[:one.numel()], one)
    assert not torch.equal(sec[0], sec[1])


# ---------------------------------------------------------------------------
# the host engine copy
# ---------------------------------------------------------------------------

def _nodes(res, types, n=3):
    return [types.ExistingNode(
        name=f"he-node-{i}", labels={}, instance_type="m5.xlarge",
        allocatable=res.Resources({"cpu": 3900, "memory": 15 * 1024 ** 3,
                                   "pods": 58}),
        used=res.Resources({"cpu": 1000 * i, "memory": 1024 ** 3}))
        for i in range(n)]


def _host_snapshot(env_mod, L, res, types, limits):
    env = env_mod.Environment()
    pods = []
    for i in range(12):
        pods += env_mod.make_pods(
            1 + i % 4, cpu=f"{250 + 150 * (i % 5)}m",
            memory=f"{512 + 256 * (i % 3)}Mi", prefix=f"he{i:02d}",
            node_selector={L.INSTANCE_FAMILY: "c5"} if i % 4 == 3 else None)
    pool = env.nodepool("host-engine", limits=limits, requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "In",
         "values": ["m5", "c5"]}])
    snap = env.snapshot(pods, [pool])
    snap.existing_nodes = _nodes(res, types)
    return snap


@pytest.mark.parametrize("limits", [None, {"cpu": "4"}])
def test_host_engine_copy_matches_reference(both_counters, limits):
    states = []
    for env_mod, L, res, types, enc_mod, delta, ffd in (
            (env_ref, L_ref, res_ref, types_ref, enc_ref, delta_ref,
             ffd_ref),
            (env_port, L_port, res_port, types_port, enc_port, delta_port,
             ffd_port)):
        snap = _host_snapshot(env_mod, L, res, types, limits)
        enc = enc_mod.encode_snapshot(snap)
        existing = sorted(snap.existing_nodes, key=lambda n: n.name)
        st = ffd.NodeState.create(enc, 16,
                                  *delta.full_existing_encode(enc, existing))
        fills = [ffd.fill_group_closed_form(st, enc, g.index)
                 for g in enc.groups]
        states.append((st, fills))
    (a, fa), (b, fb) = states
    assert len(fa) == len(fb) > 8
    for (ta, la), (tb, lb) in zip(fa, fb):
        np.testing.assert_array_equal(ta, tb)
        assert la == lb
    for f in ("used", "types", "zones", "ct", "pool", "alive", "pool_used",
              "cap_hint"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.num_nodes == b.num_nodes > 0
    if limits:
        assert sum(la for _, la in fa) > 0   # the limit binds


# ---------------------------------------------------------------------------
# solver routing against the reference CPUSolver
# ---------------------------------------------------------------------------

def _high_g(env_mod, L, n_sigs=60, per=1):
    """The reference tests' high-G workload (``_high_g_snapshot``) over
    three small sizes, so fills spill across many slots."""
    env = env_mod.Environment()
    pods = []
    for i in range(n_sigs):
        pods += env_mod.make_pods(per, cpu=f"{100 + (i % 400)}m",
                                  memory=f"{256 + i // 400}Mi",
                                  prefix=f"dg{i:05d}")
    pool = env.nodepool(f"highg-{n_sigs}-{per}", requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "In", "values": ["m5"]},
        {"key": L.INSTANCE_SIZE, "operator": "In",
         "values": ["large", "xlarge", "2xlarge"]}])
    return env.snapshot(pods, [pool])


def _spy(solver, name):
    calls = []
    orig = getattr(solver, name)

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(out)
        return out
    setattr(solver, name, spy)
    return calls


def test_high_g_rides_the_pruned_kernel(both_counters):
    want = CPUSolver().solve(_high_g(env_ref, L_ref, per=5))
    s = CUDASolver(device="cpu", n_max=16)
    s.dev_max_groups = 8          # route this small G onto the pruned path
    calls = _spy(s, "_dispatch_pruned")
    got = s.solve(_high_g(env_port, L_port, per=5))
    assert calls and all(int(o[-1]) == 0 for o in calls)
    st = s.last_dispatch_stats
    assert (st["kernel"], st["reason"], st["bails"], st["batch"]) == \
        ("pruned", None, 0, 1)
    assert st["groups"] == 64
    assert got.decision_fingerprint() == want.decision_fingerprint()


def test_bail_serves_host_identically(both_counters):
    """S = 1: a fill that spills past the selected slot bails; the same
    arena is solved again on the solver's device with every slot
    selected (S = N, no bail), recorded, and decides as the reference's
    host-served solve does."""
    want = CPUSolver().solve(_high_g(env_ref, L_ref, per=3))
    s = CUDASolver(device="cpu", n_max=16)
    s.dev_max_groups = 8
    s.dev_pruned_slots = 1
    slots = []
    orig = s._dispatch_pruned
    s._dispatch_pruned = lambda buf, **k: (slots.append((k["S"], k["E"]
                                                         + k["n_max"])),
                                           orig(buf, **k))[1]
    calls = _spy(s, "_dispatch_pruned")
    got = s.solve(_high_g(env_port, L_port, per=3))
    assert [int(o[-1]) for o in calls] == [1, 0]
    assert slots[0][0] == 1 and slots[1][0] == slots[1][1]   # S = N
    st = s.last_dispatch_stats
    assert (st["kernel"], st["reason"], st["bails"]) == \
        ("pruned", "pruned_bail", 1)
    assert got.decision_fingerprint() == want.decision_fingerprint()


def test_no_instance_types_is_host_served(both_counters):
    """T == 0 (no pools: a deletion check's shape): pods land on the
    existing nodes through the host engine, or are reported."""
    port = CUDASolver(device="cpu")
    results = []
    for env_mod, res, types, solver in (
            (env_ref, res_ref, types_ref, CPUSolver()),
            (env_port, res_port, types_port, port)):
        pods = env_mod.make_pods(9, cpu="1500m", memory="1Gi",
                                 prefix="t0")
        snap = types.SchedulingSnapshot(pods=pods, nodepools=[],
                                        existing_nodes=_nodes(res, types))
        results.append(solver.solve(snap))
    want, got = results
    assert got.decision_fingerprint() == want.decision_fingerprint()
    assert got.existing_assignments and got.unschedulable
    assert not got.new_nodes
    st = port.last_dispatch_stats
    assert (st["kernel"], st["reason"], st["bails"]) == \
        ("host", "no_types", 0)


def test_group_cap_is_host_served(both_counters):
    want = CPUSolver().solve(_high_g(env_ref, L_ref, n_sigs=12, per=2))
    s = CUDASolver(device="cpu")
    s.dev_max_groups_pruned = 8
    got = s.solve(_high_g(env_port, L_port, n_sigs=12, per=2))
    assert (s.last_dispatch_stats["kernel"],
            s.last_dispatch_stats["reason"]) == ("host", "group_cap")
    assert got.decision_fingerprint() == want.decision_fingerprint()


def test_config7_copy_matches_reference_and_rides_pruned(both_counters):
    """``examples.config7`` builds the reference's ``bench.build_config7``
    snapshot; cut to 400 pods, routed onto the pruned path, it solves
    as the reference ``CPUSolver`` does."""
    import bench
    ref = bench.build_config7(env_ref.Environment(), 400, n_sigs=80)
    port = examples.config7(env_port.Environment(), n_pods=400, n_sigs=80)
    assert [(p.full_name(), dict(p.requests), p.node_selector)
            for p in ref.pods] == \
        [(p.full_name(), dict(p.requests), p.node_selector)
         for p in port.pods]
    want = CPUSolver().solve(ref)
    s = CUDASolver(device="cpu")
    s.dev_max_groups = 32
    got = s.solve(port)
    assert (s.last_dispatch_stats["kernel"], s.last_dispatch_stats["bails"],
            s.last_dispatch_stats["groups"]) == ("pruned", 0, 128)
    assert got.decision_fingerprint() == want.decision_fingerprint()
