"""The port's sharded scan (K10) held against the reference package on the
CPU, on four ranks spawned by ``parallel/ranks.py`` over gloo (the
counterpart of the reference's eight virtual JAX devices).

- The ranks' sharded solves (the per-rank kernels' plain parts with the
  merged collectives, and the plain version with the reference's
  collectives one by one) equal the reference's JAX ``solve_scan_sharded``
  on ``solve_mesh(4)`` and ``solve_scan_sharded2`` on ``solve_mesh2(4,
  dp=2)`` byte for byte (takes, leftover, every carry field), on the
  ``examples.MESH_CASES`` (the reference's mesh test shapes, minValues
  floors on the type mesh, existing nodes, pool limits, an uneven T, n = 0
  groups, a zero request row whose prefixes wrap, shards all padding);
  on every layout (1 x 4, 2 x 2, 4 x 1) they equal the port's
  single-device ``_solve_scan_ref``.
- ``CUDASolver(device="cpu", mesh=comm)`` on the ranks decides like the
  reference ``CPUSolver`` and the single-rank port on 20 seeds of the
  pipeline fuzz, its minValues shape, a priority snapshot and a small
  pods x types snapshot, with its evidence in ``last_dispatch_stats``;
  warm ticks place the resident shard full, then patch, then reuse.
- The host helpers equal the reference's on a table of inputs, and a rank
  that raises mid-solve makes ``run_ranks`` raise within its deadline.

Each spawn is a module fixture shared by the parametrized cases. Every
rank pins one intra-op thread. Tolerance: exact (int64 and bool).
"""

import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import karpenter_provider_aws_tpu.apis.labels as L_ref
import karpenter_provider_aws_tpu.apis.objects as obj_ref
import karpenter_provider_aws_tpu.apis.resources as res_ref
import karpenter_provider_aws_tpu.fake.environment as env_ref
import karpenter_provider_aws_tpu.solver.types as types_ref
import karpenter_provider_aws_tpu_torch.fake.environment as env_port
from karpenter_provider_aws_tpu.ops.ffd_jax import KernelInputs as RefInputs
from karpenter_provider_aws_tpu.parallel import mesh as ref_mesh
from karpenter_provider_aws_tpu.solver import CPUSolver
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.models.encoding import encode_snapshot
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
from karpenter_provider_aws_tpu_torch.parallel import mesh as pm
from karpenter_provider_aws_tpu_torch.parallel import run_ranks
from karpenter_provider_aws_tpu_torch.parallel.ranks import RanksFailed
from karpenter_provider_aws_tpu_torch.solver import CUDASolver

REF = types.SimpleNamespace(L=L_ref, obj=obj_ref, res=res_ref, env=env_ref,
                            types=types_ref)
WORLD = 4
FIELDS = ("takes", "leftover", "used", "types", "zones", "ct", "pool",
          "alive", "num_nodes", "pool_used")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain scan is thousands of small tensor ops: one intra-op
    thread runs them fastest, and several test workers on one host then
    do not oversubscribe the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def case_runs():
    """Every rank's outputs of every case and layout: one spawn."""
    return run_ranks(examples.mesh_cases_rank, WORLD, "gloo", 60,
                     deadline_s=240)


@pytest.fixture(scope="module")
def solver_runs():
    """Every rank's solver decisions and evidence: one spawn."""
    return run_ranks(examples.mesh_solver_rank, WORLD, "gloo", 60,
                     deadline_s=300)


def _ref_outputs(takes, leftover, carry):
    out = dict(takes=takes, leftover=leftover, **carry._asdict())
    return {k: np.asarray(v).reshape(1) if k == "num_nodes"
            else np.asarray(v) for k, v in out.items()}


def _assert_same(got, want, label):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{label} {f}")


REF_CASES = [(c, lay) for c in examples.MESH_CASES
             for lay in ("tp", "dp2") if not (c == "min_values"
                                              and lay == "dp2")]


@pytest.mark.parametrize("case,layout", REF_CASES)
def test_ranks_match_reference_mesh(case_runs, case, layout):
    arrays, st = examples.mesh_case(case)
    inp = RefInputs(**{k: jnp.asarray(v) for k, v in arrays.items()})
    kw = dict(n_max=st["n_max"], E=st["E"], P=st["P"])
    if layout == "tp":
        want = ref_mesh.solve_scan_sharded(
            inp, mesh=ref_mesh.solve_mesh(WORLD), V=st["V"], **kw)
    else:
        want = ref_mesh.solve_scan_sharded2(
            inp, mesh=ref_mesh.solve_mesh2(WORLD, dp=2), **kw)
    want = _ref_outputs(*want)
    for rank, runs in enumerate(case_runs):
        for plain in (False, True):
            _assert_same(runs[(case, layout, plain)], want,
                         f"rank {rank} plain={plain}")


@pytest.mark.parametrize("case", examples.MESH_CASES)
def test_ranks_match_single_device(case_runs, case):
    arrays, st = examples.mesh_case(case)
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    want = examples.mesh_outputs(*ft._solve_scan_ref(
        inp, st["n_max"], st["E"], st["P"], st["V"]))
    keys = [k for k in case_runs[0] if k[0] == case]
    assert len(keys) == (2 if st["V"] else 6)
    for rank, runs in enumerate(case_runs):
        for key in keys:
            _assert_same(runs[key], want, f"rank {rank} {key}")


def test_cases_reach_their_hazards():
    """The hazards case wraps its prefixes (a zero request row takes its n
    again 16 BIG slots later) and the few_types case leaves two of the
    four type shards all padding."""
    arrays, st = examples.mesh_case("hazards")
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    takes, leftover, _ = ft._solve_scan_ref(inp, st["n_max"], st["E"],
                                            st["P"])
    assert int((takes[9] == arrays["n"][9]).sum()) >= 2
    assert int(takes[9].min()) < 0
    assert int(takes[3].abs().sum()) == int(takes[7].abs().sum()) == 0
    arrays, _ = examples.mesh_case("few_types")
    padded, T = pm._pad_types(arrays, WORLD)
    assert T == 2 and padded["A"].shape[0] == WORLD
    assert not padded["F"][:, T:].any() and not padded["A"][T:].any()


SOLVER_KEYS = ([("fuzz", s) for s in examples.MESH_FUZZ_SEEDS]
               + [("min_values", 0), ("min_values", 1), ("priority", 0),
                  ("dp2", 0)])
_BUILD = dict(fuzz=examples.fuzz_scenario,
              min_values=examples.min_values_scenario,
              priority=examples.priority_scenario,
              dp2=examples.mesh_dp2_snapshot)


@pytest.fixture(scope="module")
def envs():
    return env_ref.Environment(), env_port.Environment()


@pytest.mark.parametrize("key", SOLVER_KEYS, ids=lambda k: f"{k[0]}{k[1]}")
def test_mesh_solver_matches_oracle(solver_runs, envs, key):
    kind, seed = key
    build = _BUILD[kind]
    args = () if kind == "dp2" else (seed,)
    e_ref, e_port = envs
    env_ref.reset_pod_counter()
    want = CPUSolver().solve(build(REF, e_ref, *args)).decision_fingerprint()
    env_port.reset_pod_counter()
    snap = build(examples.pipeline_api(), e_port, *args)
    single = CUDASolver(device="cpu").solve(snap).decision_fingerprint()
    assert single == want
    if kind == "min_values":
        assert encode_snapshot(snap).mv_K > 0
    for rank, runs in enumerate(solver_runs):
        fp, stats = runs[key]
        assert fp == want, f"rank {rank}"
        assert stats["kernel"] == "mesh" and stats["reason"] is None
        assert stats["backend"] == "gloo"
        shape = ("dp2", 2, 2) if kind == "dp2" else ("tp", 1, WORLD)
        assert (stats["mesh_kernel"], stats["ndp"], stats["ntp"]) == shape


def test_warm_ticks_patch_the_resident_shard(solver_runs):
    for runs in solver_runs:
        ticks = runs["warm"]
        assert [t["cache"] for t in ticks] == ["full", "rows", "hit"]
        assert [t["placement"] for t in ticks] == ["full", "patch", "reuse"]
        assert all(t["same"] and t["kernel"] == "mesh" for t in ticks)


def test_failing_rank_raises_within_deadline():
    t0 = time.monotonic()
    with pytest.raises(RanksFailed, match="rank 1 fails mid-solve"):
        run_ranks(examples.mesh_fail_rank, WORLD, "gloo", 60,
                  deadline_s=120)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 6, 8, 12, 16])
def test_default_dp_matches_reference(monkeypatch, ndev):
    monkeypatch.delenv("KARP_MESH_DP", raising=False)
    assert pm._default_dp(ndev) == ref_mesh._default_dp(ndev)


def _ref_inputs(arrays):
    return RefInputs(**{k: np.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("case,shards", [("fixture", 4), ("fixture", 8),
                                         ("fuzz_e0", 4), ("few_types", 4),
                                         ("fuzz_wide", 1)])
def test_pad_helpers_match_reference(case, shards):
    arrays, st = examples.mesh_case(case)
    got, T = pm._pad_types(arrays, shards)
    want, T_ref = ref_mesh._pad_types(_ref_inputs(arrays), shards)
    assert T == T_ref
    for f in ("A", "avail_zc", "F", "pool_types"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
    got, N = pm._pad_slots(arrays, st["E"], st["n_max"], shards)
    want, N_ref = ref_mesh._pad_slots(_ref_inputs(arrays), st["E"],
                                      st["n_max"], shards)
    assert N == N_ref
    for f in ("ex_alloc", "ex_used0", "ex_compat"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
    Tp = -(-T // shards) * shards
    for Np in (None, -(-N // shards) * shards):
        for f, a in arrays.items():
            np.testing.assert_array_equal(
                pm._prep_field(f, a, Tp, Np),
                ref_mesh._prep_field(f, a, Tp, Np), err_msg=f)


def test_one_rank_is_the_identity_and_forced_mesh_decides_alike(envs):
    """Without a process group a MeshComm is one rank: every collective
    is the identity and a solver routes to the mesh only when forced."""
    comm = pm.MeshComm()
    assert (comm.world, comm.ndp, comm.ntp, comm.backend) == (1, 1, 1,
                                                              "none")
    x = torch.arange(3)
    assert comm.axis_max(x) is x and comm.dp_sum(x) is x
    assert torch.equal(comm.dp_before(x), torch.zeros(3, dtype=x.dtype))
    _, e_port = envs
    env_port.reset_pod_counter()
    snap = examples.fuzz_scenario(examples.pipeline_api(), e_port, 3)
    want = CUDASolver(device="cpu").solve(snap).decision_fingerprint()
    plain = CUDASolver(device="cpu", mesh=comm)
    assert not plain.on_mesh
    assert plain.solve(snap).decision_fingerprint() == want
    assert plain.last_dispatch_stats["kernel"] != "mesh"
    forced = CUDASolver(device="cpu", mesh=comm, force_mesh=True,
                        dp2_min_slots=0)
    assert forced.solve(snap).decision_fingerprint() == want
    s = forced.last_dispatch_stats
    assert (s["kernel"], s["mesh_kernel"], s["placement"]) == ("mesh", "tp",
                                                               "full")


def test_mesh_refusals(monkeypatch):
    """No fallback: a kernel launch refuses a CPU state before it builds
    anything, the 2-D shape refuses minValues floors, and without a card
    a mesh solver or a sharded solve on cuda raises."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.parallel import pick_backend
    arrays, st = examples.mesh_case("fixture")
    state = mc.MeshState(ft.kernel_inputs_from_numpy(arrays, "cpu"),
                         E=st["E"], P=st["P"], V=0, N=st["E"] + st["n_max"],
                         slot0=0)
    with pytest.raises(ValueError, match="CUDA state"):
        mc._launch("mesh_fill", state, 0, mc.PHASE_ALL)
    assert ffd_cuda._LIB is None
    assert pick_backend(4, "cpu") == "gloo"
    arrays, st = examples.mesh_case("min_values")
    with pytest.raises(ValueError, match="minValues"):
        pm.solve_scan_sharded2(arrays, None, st["n_max"], st["E"], st["P"],
                               device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CUDASolver(mesh=pm.MeshComm())
    with pytest.raises(RuntimeError, match="cuda"):
        pm.solve_scan_sharded(arrays, None, st["n_max"], st["E"], st["P"],
                              st["V"])


@pytest.mark.parametrize("case,ndp,dp_idx", examples.MESH_LATER_SHARDS)
def test_later_slot_shard_check(case, ndp, dp_idx):
    """The card's later-shard check on the CPU: the shard starts past
    slot 0, every kernel of the first steps is checked with the given
    prefixes in place, and the existing_split shards that start inside
    the existing rows hold some of them."""
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    for before in examples.MESH_BEFORES:
        records, st = examples.mesh_shard_check(case, ndp, dp_idx, before)
        assert st.slot0 == dp_idx * st.Nl > 0
        assert {r[0] for r in records} == set(mc.KERNELS)
        assert not [r for r in records if r[2]]
        want = examples.MESH_BEFORES[before](st.P)
        assert st.before.tolist() == want
        inside = (case, ndp, dp_idx) in (("existing_split", 2, 1),
                                         ("existing_split", 4, 2))
        assert (st.slot0 < st.E < st.slot0 + st.Nl) == inside


@pytest.mark.parametrize("case", examples.MESH_CASES)
def test_one_rank_three_phase_fill_and_check_hook(case):
    """At one rank the fill's three phases (the slot-split form, with no
    earlier shards) decide as its one launch does, and the check hook
    sees every kernel of the first steps."""
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    arrays, st = examples.mesh_case(case)
    want = examples.mesh_outputs(*ft._solve_scan_ref(
        ft.kernel_inputs_from_numpy(arrays, "cpu"), st["n_max"], st["E"],
        st["P"], st["V"]))
    records = []
    got = examples.mesh_outputs(*pm.solve_scan_sharded(
        arrays, None, st["n_max"], st["E"], st["P"], st["V"], device="cpu",
        check=examples.mesh_kernel_check(0, records), split_fill=True))
    _assert_same(got, want, case)
    assert {r[0] for r in records} == set(mc.KERNELS)
    assert not [r for r in records if r[2]]
    assert sum(r[0] == "mesh_fill" for r in records) == \
        3 * min(4, arrays["n"].shape[0])
