"""The port's batched packed solve (K4) and ``CUDASolver.solve_batch``
held against the reference package on the CPU.

- Kernel parity: the plain ``solve_scan_packed1_many`` against the
  reference's jitted ``solve_scan_packed1_many`` on three arenas of one
  statics bucket with different contents, byte for byte; each row is
  the single packed solve of its arena.
- Solver parity: ``CUDASolver(device="cpu").solve_batch`` against the
  reference ``CPUSolver`` snapshot by snapshot: three batchable
  snapshots ride one ``_dispatch_many``, an ineligible one (minValues
  floors) and an empty one take the single path, and a lane that runs
  out of new-node slots is re-solved singly.

Tolerance: exact (int64 and bool).
"""

import numpy as np
import pytest
import torch

import karpenter_provider_aws_tpu.apis.labels as L_ref
import karpenter_provider_aws_tpu.fake.environment as env_ref
import karpenter_provider_aws_tpu_torch.apis.labels as L_port
import karpenter_provider_aws_tpu_torch.fake.environment as env_port
from __graft_entry__ import _example_arrays
from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu.ops import hostpack as hp_jax
from karpenter_provider_aws_tpu.solver import CPUSolver
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
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


#: three example cases of one statics bucket with different contents
LANE_CASES = ("base", "daemon", "pool_limits")


@pytest.fixture
def both_counters():
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()
    yield
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()


def test_packed_many_byte_identical():
    cases = [examples.example_case(c, base=_example_arrays)
             for c in LANE_CASES]
    st = cases[0][1]
    assert all(s == st for _, s in cases)
    bufs = np.stack([hp_jax.pack_inputs1(a, *examples.pack_statics(st))
                     for a, _ in cases])
    assert len({b.tobytes() for b in bufs}) == 3
    want = np.asarray(ffd_jax.solve_scan_packed1_many(
        bufs, **examples.solve_statics(st)))
    got = ft.solve_scan_packed1_many(bufs, device="cpu",
                                     **examples.solve_statics(st))
    assert got.shape == want.shape and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(3):
        one = ft.solve_scan_packed1(bufs[b], device="cpu",
                                    **examples.solve_statics(st))
        np.testing.assert_array_equal(one.numpy(), want[b])


def _minvalues_snapshot(env_mod, L):
    env = env_mod.Environment()
    pods = env_mod.make_pods(5, cpu="500m", memory="1Gi", prefix="mvb")
    return env.snapshot(pods, [env.nodepool("mv-batch", requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "Exists", "minValues": 2}])])


def _items(env_mod, L, n_sigs=12, per=2):
    env = env_mod.Environment()
    snaps = examples_batch(env, env_mod, n_sigs, per)
    empty = env.snapshot([], [env.nodepool("empty-batch")])
    return snaps[:2] + [_minvalues_snapshot(env_mod, L), snaps[2], empty]


def examples_batch(env, env_mod, n_sigs, per):
    """``examples.batch_snapshots`` on either package: the port's builder
    for the port, the reference's own (bench.py) for the reference."""
    if env_mod is env_port:
        return examples.batch_snapshots(env, batch=3, n_sigs=n_sigs,
                                        per=per)
    import bench
    return bench.build_batch_snapshots(env, batch=3, n_sigs=n_sigs, per=per)


def test_solve_batch_matches_cpu_solver(both_counters):
    want = [CPUSolver().solve(s) for s in _items(env_ref, L_ref)]
    s = CUDASolver(device="cpu")
    calls = []
    orig = s._dispatch_many

    def spy(bufs, **statics):
        calls.append(len(bufs))
        return orig(bufs, **statics)
    s._dispatch_many = spy
    snaps = _items(env_port, L_port)
    got = s.solve_batch(snaps)
    assert calls == [3]
    assert [g.decision_fingerprint() for g in got] == \
        [w.decision_fingerprint() for w in want]
    assert got[4].new_nodes == [] and not got[4].unschedulable
    assert all(g.new_nodes for g in got[:4])
    # the single solves ran while the items were prepared; the batch last
    st = s.last_dispatch_stats
    assert (st["kernel"], st["batch"], st["bails"]) == ("batch", 3, 0)


def test_batch_snapshots_copy_matches_reference(both_counters):
    import bench
    a = bench.build_batch_snapshots(env_ref.Environment(), batch=2,
                                    n_sigs=6, per=2)
    b = examples.batch_snapshots(env_port.Environment(), batch=2, n_sigs=6,
                                 per=2)
    for x, y in zip(a, b):
        assert [p.full_name() for p in x.pods] == \
            [p.full_name() for p in y.pods]
        assert [(dict(p.requests), p.node_selector) for p in x.pods] == \
            [(dict(p.requests), p.node_selector) for p in y.pods]


def test_exhausted_lane_is_solved_singly(both_counters):
    """A lane that runs out of the slot bucket comes back through the
    single path (its x4 retry), with the single path's decisions."""
    want = [CPUSolver().solve(s)
            for s in examples_batch(env_ref.Environment(), env_ref,
                                    n_sigs=24, per=4)]
    s = CUDASolver(device="cpu", n_max=64)
    s._bucket = 2
    singles = []
    orig = s.solve

    def spy(snap):
        singles.append(snap)
        return orig(snap)
    s.solve = spy
    got = s.solve_batch(examples_batch(env_port.Environment(), env_port,
                                       n_sigs=24, per=4))
    assert len(singles) == 3
    assert [g.decision_fingerprint() for g in got] == \
        [w.decision_fingerprint() for w in want]
