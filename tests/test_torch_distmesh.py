"""The port's multi-process mesh (K11) and its coordinator held against the
reference package on the CPU.

- The host helpers (``config_from_env``, ``dist_dp``, ``local_slot_rows``,
  ``slab_rows``, ``collective_bill``) equal the reference's on a table of
  inputs; ``tick_arrays``, whole and in slab mode for every (hosts,
  host), is byte-equal to the reference's; either package reads the
  other's frames.
- ``dispatch_dist`` on four gloo ranks spawned by ``parallel/ranks.py``,
  as 2 hosts x 2 ranks and as 4 hosts x 1 rank, each rank given only its
  host's slabs: ticks 0 (full), 1 and 2 (patch) and tick 2 again (reuse)
  give, on every rank, the reference's ``result_fingerprint`` hex of its
  single-device ``oracle_out`` and of its in-process ``dispatch_dist``;
  no rank places more slot rows than its shard, and a slab that does not
  cover a rank's rows raises.
- ``MeshGroup``: local mode and the degrade taxonomy (one full placement
  after a degrade), then real rank processes (``workers=1,
  local_devices=2``): ``solve_seeded`` and ``solve_frame`` equal the
  reference oracle, ``solve_batch`` lanes are byte-equal to the
  reference's ``solve_scan_packed1``, and a killed rank degrades to one
  full local solve, then patch, then refused batch routing.
- The self-heal scenarios of the reference's ``tests/test_selfheal.py``
  (epoch fence, wedge watchdog, regroup supervisor, port retry, the
  canary command), on socketpairs and stubbed formations.

Tolerance: exact (int64 and bool; fingerprints as hex strings). Every
torch solve here runs the plain versions on the CPU, one intra-op
thread.
"""

import os
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu.fleet import canary as ref_canary
from karpenter_provider_aws_tpu.fleet import meshgroup as ref_mg
from karpenter_provider_aws_tpu.ops.ffd_jax import solve_scan_packed1
from karpenter_provider_aws_tpu.ops.hostpack import \
    pack_inputs1 as ref_pack_inputs1
from karpenter_provider_aws_tpu.parallel import distmesh as ref
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.fleet import (CANARY_SEED,
                                                    MESH_CANARY_SHAPE)
from karpenter_provider_aws_tpu_torch.fleet import meshgroup as mg_mod
from karpenter_provider_aws_tpu_torch.fleet.meshgroup import MeshGroup
from karpenter_provider_aws_tpu_torch.ops.hostpack import pack_inputs1
from karpenter_provider_aws_tpu_torch.parallel import distmesh as dm
from karpenter_provider_aws_tpu_torch.parallel import mesh as pm
from karpenter_provider_aws_tpu_torch.parallel import run_ranks
from karpenter_provider_aws_tpu_torch.utils.metrics import Metrics

SHAPE = examples.DIST_SMOKE_SHAPE
#: the reference's self-heal workload (tests/test_selfheal.py)
HEAL_SHAPE = dict(G=4, T=7, n_max=32, E=12, P=2, Z=2, C=2, D=4,
                  pods_per_group=9)
#: the ceiling's widths at a reduced group count
CEILING_NARROW = dict(examples.DIST_CEILING_SHAPE, G=3)
DIRTY = list(dm.DIRTY_FIELDS)
WORLD = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_REF_FP: dict = {}


def ref_fp(shape, seed, tick):
    """The reference's single-device oracle fingerprint of a tick."""
    key = (tuple(sorted(shape.items())), seed, tick)
    if key not in _REF_FP:
        arrays, st = ref.tick_arrays(shape, seed, tick)
        _REF_FP[key] = ref.result_fingerprint(ref.oracle_out(arrays, **st))
    return _REF_FP[key]


# ---------------------------------------------------------------------------
# host helpers, generator, wire
# ---------------------------------------------------------------------------

ENV_CASES = [
    {},
    {ref.COORDINATOR_ENV: "10.0.0.1:52021", ref.PROCESSES_ENV: "3",
     ref.PROCESS_ID_ENV: "2", ref.LOCAL_DEVICES_ENV: "4"},
    {ref.COORDINATOR_ENV: "solver-0.solver:52021", ref.WORKERS_ENV: "2",
     "POD_NAME": "solver-mesh-1"},
    {ref.COORDINATOR_ENV: "c:1", ref.WORKERS_ENV: "1",
     "POD_NAME": "controller-abc"},
]


@pytest.mark.parametrize("env", ENV_CASES, ids=range(len(ENV_CASES)))
def test_config_from_env_matches_reference(monkeypatch, env):
    for k in (ref.COORDINATOR_ENV, ref.PROCESSES_ENV, ref.PROCESS_ID_ENV,
              ref.LOCAL_DEVICES_ENV, ref.WORKERS_ENV, "POD_NAME"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = ref.config_from_env()
    got = dm.config_from_env()
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want)
    assert dm.COORDINATOR_ENV == ref.COORDINATOR_ENV


@pytest.mark.parametrize("ndev,nproc,dp", [
    (8, 1, None), (16, 2, None), (4, 2, None), (4, 4, None), (4, 1, None),
    (2, 1, None), (16, 2, 8), (16, 2, 6), (16, 2, 1), (16, 4, 3),
    (8, 2, 4)])
def test_dist_dp_matches_reference(monkeypatch, ndev, nproc, dp):
    if dp is None:
        monkeypatch.delenv("KARP_DIST_DP", raising=False)
    else:
        monkeypatch.setenv("KARP_DIST_DP", str(dp))
    assert dm.dist_dp(ndev, nproc, dp) == ref.dist_dp(ndev, nproc)


def test_dist_dp_uneven_raises(monkeypatch):
    monkeypatch.delenv("KARP_DIST_DP", raising=False)
    with pytest.raises(ValueError):
        ref.dist_dp(9, 2)
    with pytest.raises(ValueError, match="evenly"):
        dm.dist_dp(9, 2)


@pytest.mark.parametrize("Np,nproc", [(96, 3), (88, 2), (88, 4), (4224, 2),
                                      (97, 3)])
def test_local_slot_rows_matches_reference(Np, nproc):
    for pid in range(nproc):
        try:
            want = ref.local_slot_rows(Np, nproc, pid)
        except ValueError:
            with pytest.raises(ValueError):
                dm.local_slot_rows(Np, nproc, pid)
            continue
        assert dm.local_slot_rows(Np, nproc, pid) == want


@pytest.mark.parametrize("ndp", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [SHAPE, MESH_CANARY_SHAPE,
                                   CEILING_NARROW], ids=["smoke", "canary",
                                                         "ceiling"])
def test_slab_rows_matches_reference(shape, ndp):
    """The reference reads the slab of its one process off its mesh; the
    port takes dp, hosts and host as arguments."""
    mesh = ref.dist_mesh2(devices=ref.global_devices()[:ndp], dp=ndp)
    want = ref.slab_rows(shape["n_max"], shape["E"], mesh)
    assert dm.slab_rows(shape["n_max"], shape["E"], ndp) == want
    Np = want[0]
    for nproc in (1, 2, 4):
        if ndp % nproc:
            continue
        for pid in range(nproc):
            assert dm.slab_rows(shape["n_max"], shape["E"], ndp, nproc,
                                pid)[1:] == ref.local_slot_rows(Np, nproc,
                                                                pid)


@pytest.mark.parametrize("P,dp,nproc,G", [(2, 4, 1, 10), (2, 4, 2, 10),
                                          (1, 2, 2, 64), (3, 8, 4, 7)])
def test_collective_bill_matches_reference(P, dp, nproc, G):
    assert dm.collective_bill(P, dp, nproc, G) == \
        ref.collective_bill(P, dp, nproc, G)


def _same_arrays(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, ref.LocalSlab):
            assert isinstance(g, pm.LocalSlab), k
            assert (g.lo, g.hi, g.axis, tuple(g.global_shape)) == \
                (w.lo, w.hi, w.axis, tuple(w.global_shape)), k
            g, w = g.array, w.array
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("shape", [SHAPE, MESH_CANARY_SHAPE,
                                   CEILING_NARROW], ids=["smoke", "canary",
                                                         "ceiling"])
def test_tick_arrays_byte_equal_reference(shape):
    for tick in (0, 1, 2):
        got, st = dm.tick_arrays(shape, 5, tick)
        want, st_ref = ref.tick_arrays(shape, 5, tick)
        assert st == st_ref
        _same_arrays(got, want)
        for nproc in (1, 2, 4):
            for pid in range(nproc):
                slab = dm.slab_rows(shape["n_max"], shape["E"], nproc,
                                    nproc, pid)
                slab = (slab[1], slab[2], slab[0])
                got, _ = dm.tick_arrays(shape, 5, tick, slab=slab)
                want, _ = ref.tick_arrays(shape, 5, tick, slab=slab)
                _same_arrays(got, want)


def test_only_dirty_fields_move_across_ticks():
    ticks = [dm.tick_arrays(SHAPE, 5, t)[0] for t in (0, 1, 2)]
    for a, b in zip(ticks, ticks[1:]):
        moved = {k for k in a if not np.array_equal(a[k], b[k])}
        assert moved == set(dm.DIRTY_FIELDS)


def test_wire_frames_cross_packages():
    arrays = {"x": np.arange(6).reshape(2, 3), "m": np.array([True, False])}
    for send, recv in ((ref, dm), (dm, ref)):
        a, b = socket.socketpair()
        try:
            send._send_msg(a, {"cmd": "t", "k": 1}, arrays)
            msg, got = recv._recv_msg(b)
            assert msg == {"cmd": "t", "k": 1}
            assert set(got) == {"x", "m"} and got["m"].dtype == np.bool_
            assert np.array_equal(got["x"], arrays["x"])
            send._send_msg(a, {"cmd": "halt"})
            assert recv._recv_msg(b) == ({"cmd": "halt"}, {})
            a.close()
            assert recv._recv_msg(b) == (None, {})
        finally:
            b.close()
    msg = {"slabs": {"ex_alloc": [2, 5, 0, [8, 4]]}}
    got = dm._slabs_from_frame(msg, {"ex_alloc": np.zeros((3, 4))})
    want = ref._slabs_from_frame(msg, {"ex_alloc": np.zeros((3, 4))})
    assert tuple(got["ex_alloc"])[1:] == tuple(want["ex_alloc"])[1:]


# ---------------------------------------------------------------------------
# dispatch_dist in one process, slabs, refusals
# ---------------------------------------------------------------------------

def test_dispatch_dist_one_rank_full_patch_reuse():
    comm = dm.dist_mesh2()
    assert (comm.world, comm.ndp, comm.ntp) == (1, 1, 1)
    cache, metrics = {}, Metrics()
    arrays, st = dm.tick_arrays(SHAPE, 9, 0)
    out = dm.dispatch_dist(arrays, comm=comm, cache=cache, device="cpu",
                           metrics=metrics, **st)
    assert cache["last_placement"]["mode"] == "full"
    assert cache["last_placement"]["kernel"] == "dist2"
    assert dm.result_fingerprint(out) == ref_fp(SHAPE, 9, 0)
    arrays1, _ = dm.tick_arrays(SHAPE, 9, 1)
    out = dm.dispatch_dist(arrays1, comm=comm, cache=cache, device="cpu",
                           dirty=DIRTY, **st)
    assert cache["last_placement"]["mode"] == "patch"
    assert sorted(cache["last_placement"]["fields"]) == sorted(DIRTY)
    assert dm.result_fingerprint(out) == ref_fp(SHAPE, 9, 1)
    out = dm.dispatch_dist(arrays1, comm=comm, cache=cache, device="cpu",
                           dirty=[], **st)
    assert cache["last_placement"]["mode"] == "reuse"
    assert dm.result_fingerprint(out) == ref_fp(SHAPE, 9, 1)
    assert set(cache["last_timing"]) == {"commit_s", "solve_s", "gather_s"}
    assert cache["last_mesh"]["kernel"] == "dist2"
    assert "tick_seq" not in cache  # one rank: no barrier
    assert metrics.gauge("karpenter_solver_distmesh_processes") == 1
    assert metrics.counter("karpenter_solver_distmesh_patch_total",
                           labels={"mode": "full"}) == 1


def test_one_rank_runs_the_three_phase_fill_with_the_check_hook():
    """At dp = 1 the distributed dispatch still runs the fill in its
    three phases (the reference always runs the 2-D program), and the
    check hook sees every kernel of the first steps."""
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    records = []
    arrays, st = dm.tick_arrays(SHAPE, 9, 0)
    dm.dispatch_dist(arrays, comm=dm.dist_mesh2(), cache={}, device="cpu",
                     check=examples.mesh_kernel_check(0, records), **st)
    assert {r[0] for r in records} == set(mc.KERNELS)
    fills = [r[1][1] for r in records if r[0] == "mesh_fill"]
    assert sorted(set(fills)) == [mc.PHASE_A, mc.PHASE_B, mc.PHASE_C]
    assert len(fills) == 3 * min(4, SHAPE["G"])
    assert not [r for r in records if r[2]]


def test_slab_placement_equals_whole_arrays_and_keys_the_resident():
    comm = dm.dist_mesh2()
    whole, st = dm.tick_arrays(SHAPE, 4, 0)
    Np, lo, hi = dm.slab_rows(SHAPE["n_max"], SHAPE["E"], 1)
    slabs, _ = dm.tick_arrays(SHAPE, 4, 0, slab=(lo, hi, Np))
    cache = {}
    a = dm.dispatch_dist(whole, comm=comm, cache=cache, device="cpu", **st)
    b = dm.dispatch_dist(slabs, comm=comm, cache=cache, device="cpu",
                         dirty=[], **st)
    # a slab is another resident key than the whole table: placed anew
    assert cache["last_placement"]["mode"] == "full"
    assert dm.result_fingerprint(a) == dm.result_fingerprint(b)
    res = cache["resident"]["dev"]
    assert res["ex_alloc"].shape[0] == res["ex_used0"].shape[0] == Np
    assert res["ex_compat"].shape[1] == Np


@pytest.mark.parametrize("field", ["ex_alloc", "ex_used0", "ex_compat"])
def test_slab_outside_ownership_refuses(field):
    """A slab that does not cover the rank's rows raises, on each slot
    field, as the reference's commit_global does; a slab whose logical
    shape does not span the padded slot range raises too (no silent
    padding)."""
    comm = dm.dist_mesh2()
    Np, lo, hi = dm.slab_rows(SHAPE["n_max"], SHAPE["E"], 1)
    half, _ = dm.tick_arrays(SHAPE, 4, 0, slab=(0, Np // 2, Np))
    arrays, st = dm.tick_arrays(SHAPE, 4, 0, slab=(lo, hi, Np))
    with pytest.raises(ValueError, match="outside local slab"):
        dm.dispatch_dist(dict(arrays, **{field: half[field]}), comm=comm,
                         cache={}, device="cpu", **st)
    short, _ = dm.tick_arrays(SHAPE, 4, 0, slab=(0, Np, Np + 2))
    with pytest.raises(ValueError, match="padded slot rows"):
        dm.dispatch_dist(dict(arrays, **{field: short[field]}), comm=comm,
                         cache={}, device="cpu", **st)


def test_slab_cut_rows_per_shard():
    """The cut of a later shard from its host's slab: global rows
    [dp*Nl, (dp+1)*Nl) remapped to slab-local rows, never more."""
    Np, lo, hi = dm.slab_rows(SHAPE["n_max"], SHAPE["E"], 4, 2, 1)
    assert (lo, hi) == (Np // 2, Np)
    slabs, _ = dm.tick_arrays(SHAPE, 4, 0, slab=(lo, hi, Np))
    whole, _ = dm.tick_arrays(SHAPE, 4, 0)
    Nl = Np // 4
    for dp_idx in (2, 3):
        lay = examples.ShardStub(4, dp_idx, [0] * 3)
        for f in ("ex_alloc", "ex_used0", "ex_compat"):
            got = pm._cut_slab(f, slabs[f], lay, Nl)
            want = pm._cut(f, pm._prep_field(f, whole[f], SHAPE["T"], Np),
                           lay, SHAPE["T"], Nl, whole, 0)
            assert got.shape == want.shape and np.array_equal(got, want)
    with pytest.raises(ValueError, match="outside local slab"):
        pm._cut_slab("ex_alloc", slabs["ex_alloc"],
                     examples.ShardStub(4, 1, [0] * 3), Nl)
    with pytest.raises(ValueError, match="not slot-sharded"):
        pm._cut_slab("A", slabs["ex_alloc"],
                     examples.ShardStub(4, 2, [0] * 3), Nl)


def test_min_values_floors_refused():
    arrays, st = dm.tick_arrays(SHAPE, 9, 0)
    arrays = dict(arrays, mv_floor=np.zeros(3, np.int64))
    with pytest.raises(ValueError, match="minValues"):
        dm.dispatch_dist(arrays, comm=dm.dist_mesh2(), cache={},
                         device="cpu", **st)


def test_modules_import_without_jax():
    code = ("import sys\n"
            "import karpenter_provider_aws_tpu_torch.parallel.distmesh\n"
            "import karpenter_provider_aws_tpu_torch.fleet.meshgroup\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'karpenter_provider_aws_tpu' or "
            "m.startswith('karpenter_provider_aws_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# ---------------------------------------------------------------------------
# dispatch_dist on four gloo ranks, each given only its host's slabs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tick_runs():
    """Every rank's ticks on 2 x 2 and on 4 x 1: one spawn."""
    return run_ranks(examples.dist_ticks_rank, WORLD, "gloo", 60,
                     deadline_s=240, args=(SHAPE, examples.DIST_SEED,
                                           examples.DIST_LAYOUTS,
                                           examples.DIST_TICKS, "cpu",
                                           (0, WORLD - 1)))


@pytest.fixture(scope="module")
def ref_dist_fps():
    """The reference's in-process dispatch_dist on its 2-D mesh over the
    same ticks."""
    mesh, cache, fps = ref.dist_mesh2(), {}, []
    for tick, dirty in examples.DIST_TICKS:
        arrays, st = ref.tick_arrays(SHAPE, examples.DIST_SEED, tick)
        out = ref.dispatch_dist(arrays, mesh=mesh, cache=cache,
                                dirty=None if dirty is None else list(dirty),
                                **st)
        fps.append((cache["last_placement"]["mode"],
                    ref.result_fingerprint(out)))
    return fps


@pytest.mark.parametrize("layout", examples.DIST_LAYOUTS,
                         ids=lambda x: f"{x[0]}x{x[1]}")
def test_ranks_match_reference_fingerprints(tick_runs, ref_dist_fps,
                                            layout):
    hosts, L = layout
    for rank, runs in enumerate(tick_runs):
        for (tick, dirty), run, (ref_mode, ref_dist) in zip(
                examples.DIST_TICKS, runs[layout], ref_dist_fps):
            want = ref_fp(SHAPE, examples.DIST_SEED, tick)
            assert run["fp"] == want == ref_dist, (rank, tick)
            assert run["mode"] == ref_mode, (rank, tick)
            if run["mode"] == "patch":
                assert run["fields"] == sorted(dm.DIRTY_FIELDS)
            assert run["timing"] == ["commit_s", "gather_s", "solve_s"]
            assert run["mesh"]["kernel"] == "dist2"
            assert run["mesh"]["backend"] == "gloo"
        ticks = [r["tick_seq"] for r in runs[layout]]
        assert ticks == list(range(1, len(examples.DIST_TICKS) + 1))
        for tick in (0, 1, 2):
            assert runs[("oracle", tick)] == ref_fp(SHAPE, examples.DIST_SEED,
                                                    tick)


@pytest.mark.parametrize("layout", examples.DIST_LAYOUTS,
                         ids=lambda x: f"{x[0]}x{x[1]}")
def test_ranks_place_only_their_host_slab(tick_runs, layout):
    """Each placed slot field holds the rank's Nl = Np / dp rows, inside
    its host's slab; the layout is dp = hosts (a host's ranks hold whole
    dp rows) and the four ranks tile the padded slot range."""
    hosts, L = layout
    ndp = dm.dist_dp(WORLD, hosts)
    covered = set()
    for rank, runs in enumerate(tick_runs):
        for run in runs[layout]:
            lo, hi, Np = run["slab"]
            Nl = Np // ndp
            assert (lo, hi) == dm.local_slot_rows(Np, hosts, rank // L)
            assert set(run["rows"].values()) == {Nl}
            assert lo <= run["slot0"] and run["slot0"] + Nl <= hi
            assert (run["mesh"]["ndp"], run["mesh"]["ntp"]) == \
                (ndp, WORLD // ndp)
            covered.add(run["slot0"])
    assert sorted(covered) == [i * Nl for i in range(ndp)]


def test_checked_ranks_hold_their_launches(tick_runs):
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    for rank in (0, WORLD - 1):
        for layout in examples.DIST_LAYOUTS:
            recs = tick_runs[rank][layout][0]["checks"]
            assert {r[0] for r in recs} == set(mc.KERNELS)
            assert not [r for r in recs if r[2]]
    assert tick_runs[1][examples.DIST_LAYOUTS[0]][0]["checks"] is None


# ---------------------------------------------------------------------------
# MeshGroup: local mode and the degrade taxonomy
# ---------------------------------------------------------------------------

def test_meshgroup_workers_zero_serves_locally():
    metrics = Metrics()
    mg = MeshGroup(workers=0, metrics=metrics, device="cpu").start()
    try:
        assert not mg.alive()
        r0 = mg.solve_seeded(SHAPE, seed=4, tick=0)
        assert r0["mode"] == "full" and not r0["distributed"]
        assert r0["fingerprint"] == mg.solve_oracle(SHAPE, 4, 0)[
            "fingerprint"] == ref_fp(SHAPE, 4, 0)
        r1 = mg.solve_seeded(SHAPE, seed=4, tick=1, dirty=DIRTY)
        assert r1["mode"] == "patch"
        assert r1["fingerprint"] == ref_fp(SHAPE, 4, 1)
        assert metrics.counter("karpenter_solver_distmesh_dispatch_total",
                               labels={"mode": "local"}) == 2
        assert metrics.gauge("karpenter_solver_distmesh_processes") == 1
    finally:
        mg.stop()


def test_meshgroup_degrade_spends_exactly_one_full():
    metrics = Metrics()
    mg = MeshGroup(workers=0, metrics=metrics, device="cpu").start()
    try:
        mg.solve_seeded(SHAPE, seed=4, tick=0)
        mg.degrade(reason="worker_lost")
        r = mg.solve_seeded(SHAPE, seed=4, tick=1, dirty=DIRTY)
        assert r["mode"] == "full"
        r2 = mg.solve_seeded(SHAPE, seed=4, tick=2, dirty=DIRTY)
        assert r2["mode"] == "patch"
        for tick, rr in ((1, r), (2, r2)):
            assert rr["fingerprint"] == ref_fp(SHAPE, 4, tick)
        assert metrics.counter("karpenter_solver_distmesh_degraded_total",
                               labels={"reason": "worker_lost"}) == 1
        mg.degrade(reason="worker_lost")
        assert metrics.counter("karpenter_solver_distmesh_degraded_total",
                               labels={"reason": "worker_lost"}) == 1
        assert mg.solve_batch(np.zeros((1, 4), np.int64), {}) is None
    finally:
        mg.stop()


def test_meshgroup_spawn_failure_degrades_not_raises():
    metrics = Metrics()
    mg = MeshGroup(workers=1, metrics=metrics, device="cpu",
                   python="/nonexistent/python").start()
    try:
        assert not mg.alive()
        assert metrics.counter("karpenter_solver_distmesh_degraded_total",
                               labels={"reason": "spawn_failed"}) == 1
        r = mg.solve_seeded(SHAPE, seed=4, tick=0)
        assert r["fingerprint"] == ref_fp(SHAPE, 4, 0)
    finally:
        mg.stop()


def test_meshgroup_fingerprint_split_degrades_once():
    metrics = Metrics()
    mg = MeshGroup(workers=1, metrics=metrics, device="cpu")
    replies = [({"fingerprint": "aaaa", "mode": "full"}, None),
               ({"fingerprint": "bbbb", "mode": "full"}, None)]
    with pytest.raises(RuntimeError, match="fingerprint mismatch"):
        mg._collect(replies, "seeded", False)
    assert mg._degraded and mg._regroup_at is not None
    assert metrics.counter("karpenter_solver_distmesh_degraded_total",
                           labels={"reason": "fingerprint_split"}) == 1
    r = mg.solve_seeded(SHAPE, seed=4, tick=0, dirty=DIRTY)
    assert r["mode"] == "full" and not r["distributed"]
    assert r["fingerprint"] == ref_fp(SHAPE, 4, 0)
    mg.degrade(reason="fingerprint_split")
    assert metrics.counter("karpenter_solver_distmesh_degraded_total",
                           labels={"reason": "fingerprint_split"}) == 1
    agree = [({"fingerprint": "cccc", "mode": "patch"}, None)] * 2
    mg2 = MeshGroup(workers=1, metrics=Metrics(), device="cpu")
    r = mg2._collect(agree, "seeded", False)
    assert r["fingerprint"] == "cccc" and r["distributed"]
    assert not mg2._degraded
    mg.stop()
    mg2.stop()


def test_meshgroup_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        MeshGroup(workers=0)


# ---------------------------------------------------------------------------
# MeshGroup with real rank processes: 2 hosts x 2 ranks on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group():
    mg = MeshGroup(workers=1, local_devices=2, device="cpu",
                   metrics=Metrics(), reply_timeout_s=120).start()
    assert mg.alive(), "the 2 x 2 mesh group did not form"
    yield mg
    mg.stop()


def test_group_layout(group):
    assert group.mesh_info == dict(nproc=2, world=4, ndev=4, dp=2, tp=2,
                                   backend="gloo")
    assert len(group._procs) == len(group._socks) == 4


def test_group_solve_seeded_matches_reference(group):
    r0 = group.solve_seeded(SHAPE, seed=7, tick=0)
    assert r0["distributed"] and r0["mode"] == "full"
    assert r0["fingerprint"] == ref_fp(SHAPE, 7, 0)
    r1 = group.solve_seeded(SHAPE, seed=7, tick=1, dirty=DIRTY)
    assert r1["mode"] == "patch"
    assert r1["fingerprint"] == ref_fp(SHAPE, 7, 1)
    assert set(r1["timing"]) == {"commit_s", "solve_s", "gather_s"}
    Nl = (SHAPE["E"] + SHAPE["n_max"]) // 2
    assert [rk["rank"] for rk in r1["ranks"]] == [0, 1, 2, 3]
    for rk in r1["ranks"]:
        assert set(rk["slot_rows"].values()) == {Nl}
        assert rk["mesh"]["collectives"] == 1 + 4 * SHAPE["G"]


def test_group_solve_frame_matches_reference(group):
    for tick, dirty in ((0, None), (1, DIRTY)):
        arrays, st = dm.tick_arrays(SHAPE, 11, tick)
        r = group.solve_frame(arrays, st, dirty=dirty,
                              want_arrays=tick == 1)
        assert r["distributed"]
        assert r["mode"] == ("patch" if dirty else "full")
        assert r["fingerprint"] == ref_fp(SHAPE, 11, tick)
    assert dm.result_fingerprint(r["out"]) == r["fingerprint"]


def test_group_solve_batch_matches_reference(group):
    dims = {k: SHAPE[k] for k in ("T", "D", "Z", "C", "G", "E", "P")}
    kv = dict(dims, n_max=SHAPE["n_max"])
    lanes = []
    for i in range(5):
        arrays, _ = dm.tick_arrays(SHAPE, seed=100 + i, tick=0)
        lane = pack_inputs1(arrays, **dims)
        assert lane.tobytes() == ref_pack_inputs1(arrays, **dims).tobytes()
        lanes.append(lane)
    stack = np.stack(lanes)
    got = group.solve_batch(stack, kv)
    assert got is not None and got.shape[0] == 5
    assert [b["span"] for b in group.last_batch] == [(0, 2), (2, 3), (3, 4),
                                                     (4, 5)]
    for i in range(5):
        want = np.asarray(solve_scan_packed1(jnp.asarray(stack[i]), **kv))
        assert got[i].dtype == want.dtype and np.array_equal(got[i], want)


def test_group_worker_kill_degrades_with_one_full(group):
    """Runs last in this module: it degrades the shared group."""
    group.solve_seeded(SHAPE, seed=7, tick=0)
    group._procs[-1].kill()
    group._procs[-1].wait(timeout=10)
    r = group.solve_seeded(SHAPE, seed=7, tick=1, dirty=DIRTY)
    assert not r["distributed"] and r["mode"] == "full"
    assert not group.alive()
    r2 = group.solve_seeded(SHAPE, seed=7, tick=2, dirty=DIRTY)
    assert r2["mode"] == "patch"
    for tick, rr in ((1, r), (2, r2)):
        assert rr["fingerprint"] == ref_fp(SHAPE, 7, tick)
    assert group.metrics.counter("karpenter_solver_distmesh_degraded_total",
                                 labels={"reason": "worker_lost"}) == 1
    assert group.solve_batch(np.zeros((1, 4), np.int64), {}) is None


# ---------------------------------------------------------------------------
# self-heal: the reference's tests/test_selfheal.py scenarios
# ---------------------------------------------------------------------------

def _count(metrics, name, **labels):
    total = 0.0
    for (n, lbl), v in metrics.counters.items():
        if n == name and all(dict(lbl).get(k) == want
                             for k, want in labels.items()):
            total += v
    return total


def _wired_group(metrics=None, epoch=5, timeout=2.0, **kw):
    """A MeshGroup whose one rank is OUR end of a socketpair: the test
    plays the rank by pre-writing reply frames."""
    mg = MeshGroup(workers=1, metrics=metrics, device="cpu", **kw)
    mg.epoch = epoch
    a, b = socket.socketpair()
    a.settimeout(timeout)
    mg._socks = {0: a}
    return mg, b


def _close(mg, peer):
    for s in list(mg._socks.values()) + [peer]:
        try:
            s.close()
        except Exception:
            pass
    mg._socks.clear()


def _stub_formed(mg):
    def fake_form():
        mg.epoch += 1
        a, b = socket.socketpair()
        mg._socks = {0: a}
        mg._stub_peer = b
    return fake_form


class TestEpochFence:
    def test_frames_carry_epoch_and_stale_replies_are_skipped(self):
        m = Metrics()
        mg, peer = _wired_group(metrics=m, epoch=5)
        try:
            dm._send_msg(peer, {"ok": True, "epoch": 4,
                                "fingerprint": "stale"})
            dm._send_msg(peer, {"ok": True, "epoch": 5,
                                "fingerprint": "fresh"})
            replies = mg._broadcast(lambda r: ({"cmd": "noop"}, None))
            assert replies[0][0]["fingerprint"] == "fresh"
            assert _count(
                m, "karpenter_solver_distmesh_stale_rejected_total") == 1
            sent, _ = dm._recv_msg(peer)
            assert sent["cmd"] == "noop" and sent["epoch"] == 5
        finally:
            _close(mg, peer)

    def test_epochless_reply_is_treated_as_current(self):
        m = Metrics()
        mg, peer = _wired_group(metrics=m, epoch=7)
        try:
            dm._send_msg(peer, {"ok": True, "fingerprint": "f"})
            replies = mg._broadcast(lambda r: ({"cmd": "noop"}, None))
            assert replies[0][0]["fingerprint"] == "f"
            assert _count(
                m, "karpenter_solver_distmesh_stale_rejected_total") == 0
        finally:
            _close(mg, peer)

    def test_stale_flood_poisons_the_socket_and_degrades(self):
        m = Metrics()
        mg, peer = _wired_group(metrics=m, epoch=9)
        try:
            for _ in range(mg_mod._STALE_REREADS + 1):
                dm._send_msg(peer, {"ok": True, "epoch": 3})
            with pytest.raises(RuntimeError, match="stale-epoch"):
                mg._broadcast(lambda r: ({"cmd": "noop"}, None))
            assert mg._degraded
            assert _count(m, "karpenter_solver_distmesh_degraded_total",
                          reason="worker_lost") == 1
            assert _count(
                m, "karpenter_solver_distmesh_stale_rejected_total") == \
                mg_mod._STALE_REREADS
        finally:
            _close(mg, peer)

    def test_formation_bumps_epoch(self):
        mg = MeshGroup(workers=1, device="cpu")
        before = mg.epoch

        def fake_start():
            mg.epoch += 1
        mg._start_distributed = fake_start
        mg._form()
        assert mg.epoch == before + 1


class TestWedgeWatchdog:
    def test_silent_worker_trips_reply_deadline(self):
        m = Metrics()
        mg, peer = _wired_group(metrics=m, epoch=2, timeout=0.2)
        try:
            with pytest.raises(socket.timeout):
                mg._broadcast(lambda r: ({"cmd": "noop"}, None))
            assert mg._degraded
            assert _count(m, "karpenter_solver_distmesh_degraded_total",
                          reason="worker_wedged") == 1
            assert mg._regroup_at is not None
            r = mg.solve_seeded(HEAL_SHAPE, seed=4, tick=0, dirty=DIRTY)
            assert r["mode"] == "full" and not r["distributed"]
            r2 = mg.solve_seeded(HEAL_SHAPE, seed=4, tick=1, dirty=DIRTY)
            assert r2["mode"] == "patch"
            for tick, rr in ((0, r), (1, r2)):
                assert rr["fingerprint"] == ref_fp(HEAL_SHAPE, 4, tick)
        finally:
            _close(mg, peer)

    def test_timeout_during_formation_does_not_degrade(self):
        m = Metrics()
        mg, peer = _wired_group(metrics=m, epoch=2, timeout=0.2)
        try:
            with pytest.raises(socket.timeout):
                mg._broadcast(lambda r: ({"cmd": "noop"}, None),
                              degrade_on_error=False)
            assert not mg._degraded
            assert _count(m, "karpenter_solver_distmesh_degraded_total") == 0
        finally:
            _close(mg, peer)


class TestRegroupSupervisor:
    def _mg(self, m, **kw):
        kw.setdefault("regroup_backoff_s", 0.01)
        kw.setdefault("regroup_attempts", 3)
        return MeshGroup(workers=1, metrics=m, device="cpu", **kw)

    def test_successful_regroup_clears_degraded_state(self):
        m = Metrics()
        mg = self._mg(m)
        mg.degrade(reason="worker_lost")
        assert mg._regroup_at is not None
        mg._form = _stub_formed(mg)
        mg._canary_group = lambda: True
        epoch0 = mg.epoch
        time.sleep(0.02)
        assert mg._maybe_regroup() is True
        assert not mg._degraded and mg.alive()
        assert mg.epoch == epoch0 + 1
        assert mg._regroup_at is None and mg._regroup_attempt == 0
        assert _count(m, "karpenter_solver_distmesh_recovered_total",
                      reason="worker_lost") == 1
        hist = m.histograms.get(("karpenter_solver_distmesh_regroup_ms", ()))
        assert hist and len(hist) == 1
        _close(mg, mg._stub_peer)

    def test_not_due_yet_is_a_noop(self):
        mg = self._mg(Metrics(), regroup_backoff_s=60.0)
        mg.degrade(reason="worker_lost")
        mg._form = _stub_formed(mg)
        mg._canary_group = lambda: True
        assert mg._maybe_regroup() is False
        assert mg._degraded

    def test_fake_clock_drives_the_backoff(self):
        """The clock seam: the regroup timers read the injected clock,
        so a fake clock moves the schedule without waiting."""
        now = [100.0]
        mg = self._mg(Metrics(), regroup_backoff_s=30.0, clock=lambda: now[0])
        mg._form = _stub_formed(mg)
        mg._canary_group = lambda: True
        mg.degrade(reason="worker_lost")
        assert mg._regroup_at == 130.0
        assert mg._maybe_regroup() is False
        now[0] = 130.0
        assert mg._maybe_regroup() is True
        _close(mg, mg._stub_peer)

    def test_capped_attempts_then_stay_degraded(self):
        m = Metrics()
        mg = self._mg(m, regroup_attempts=2)

        def always_fails():
            raise RuntimeError("formation exploded")
        mg._form = always_fails
        mg.degrade(reason="worker_lost")
        time.sleep(0.02)
        assert mg._maybe_regroup() is False
        assert mg._degraded and mg._regroup_at is not None
        time.sleep(0.05)
        assert mg._maybe_regroup() is False
        assert mg._regroup_at is None
        assert mg._maybe_regroup() is False
        assert mg._degraded
        assert _count(m, "karpenter_solver_distmesh_recovered_total") == 0
        r = mg.solve_seeded(HEAL_SHAPE, seed=4, tick=0)
        assert r["fingerprint"] == ref_fp(HEAL_SHAPE, 4, 0)

    def test_divergent_canary_blocks_readmission(self):
        m = Metrics()
        mg = self._mg(m, regroup_attempts=1)
        mg._form = _stub_formed(mg)
        mg._canary_group = lambda: False
        mg.degrade(reason="worker_lost")
        time.sleep(0.02)
        assert mg._maybe_regroup() is False
        assert mg._degraded and not mg._socks
        assert _count(m, "karpenter_solver_distmesh_recovered_total") == 0

    def test_heal_async_regroups_off_thread(self):
        m = Metrics()
        mg = self._mg(m)
        mg._form = _stub_formed(mg)
        mg._canary_group = lambda: True
        mg.heal_async()
        assert mg._regroup_at is None
        mg.degrade(reason="worker_lost")
        time.sleep(0.02)
        mg.heal_async()
        deadline = time.monotonic() + 5.0
        while mg._degraded and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not mg._degraded and mg.alive()
        assert _count(m, "karpenter_solver_distmesh_recovered_total",
                      reason="worker_lost") == 1
        _close(mg, mg._stub_peer)

    def test_stop_cancels_the_scheduled_regroup(self):
        mg = self._mg(Metrics())
        mg._form = _stub_formed(mg)
        mg._canary_group = lambda: True
        mg.degrade(reason="worker_lost")
        mg.stop()
        assert mg._regroup_at is None
        time.sleep(0.02)
        assert mg._maybe_regroup() is False
        assert mg._degraded

    def test_local_mode_never_schedules_regroup(self):
        mg = MeshGroup(workers=0, metrics=Metrics(), device="cpu").start()
        mg.degrade(reason="worker_lost")
        assert mg._regroup_at is None
        mg.stop()


class TestPortRetry:
    def test_raced_port_is_retried_with_a_fresh_one(self):
        m = Metrics()
        mg = MeshGroup(workers=1, metrics=m, device="cpu")
        calls = []

        def flaky_start():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("[Errno 98] Address already in use")
            _stub_formed(mg)()
        mg._start_distributed = flaky_start
        mg.start()
        assert len(calls) == 3
        assert not mg._degraded and mg.alive()
        assert _count(m, "karpenter_solver_distmesh_degraded_total") == 0
        _close(mg, mg._stub_peer)

    def test_non_port_error_fails_fast(self):
        m = Metrics()
        mg = MeshGroup(workers=1, metrics=m, device="cpu")
        calls = []

        def bad_start():
            calls.append(1)
            raise RuntimeError("worker exploded")
        mg._start_distributed = bad_start
        mg.start()
        assert len(calls) == 1
        assert mg._degraded
        assert _count(m, "karpenter_solver_distmesh_degraded_total",
                      reason="spawn_failed") == 1
        mg.stop()

    def test_exhausted_retries_degrade_spawn_failed(self):
        m = Metrics()
        mg = MeshGroup(workers=1, metrics=m, device="cpu")
        calls = []

        def always_races():
            calls.append(1)
            raise OSError("[Errno 98] Address already in use")
        mg._start_distributed = always_races
        mg.start()
        assert len(calls) == mg_mod._FORMATION_TRIES
        assert mg._degraded
        assert _count(m, "karpenter_solver_distmesh_degraded_total",
                      reason="spawn_failed") == 1
        mg.stop()

    def test_store_bind_error_reads_as_a_port_race(self):
        """torch's TCPStore reports a taken port with words the retry
        markers know."""
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = s.getsockname()[1]
        try:
            with pytest.raises(Exception) as e:
                torch.distributed.TCPStore("127.0.0.1", port, 1, True,
                                           wait_for_workers=False)
            assert any(mk in repr(e.value).lower()
                       for mk in mg_mod._PORT_RETRY_MARKERS)
        finally:
            s.close()


class TestArgs:
    """The reference's timeouts and regroup knobs, by argument only (the
    port reads no ``KARP_DISTMESH_*`` environment)."""

    def test_defaults_equal_the_reference(self):
        for k in ("_HELLO_TIMEOUT_S", "_REPLY_TIMEOUT_S", "_REGROUP_ATTEMPTS",
                  "_REGROUP_BACKOFF_S", "_REGROUP_BACKOFF_CAP_S",
                  "_FORMATION_TRIES", "_PORT_RETRY_MARKERS",
                  "_STALE_REREADS"):
            assert getattr(mg_mod, k) == getattr(ref_mg, k), k
        mg = MeshGroup(workers=0, device="cpu")
        assert (mg.hello_timeout_s, mg.reply_timeout_s,
                mg.regroup_attempts, mg.regroup_backoff_s) == (
            ref_mg._HELLO_TIMEOUT_S, ref_mg._REPLY_TIMEOUT_S,
            ref_mg._REGROUP_ATTEMPTS, ref_mg._REGROUP_BACKOFF_S)

    def test_args_win_and_env_is_not_read(self, monkeypatch):
        monkeypatch.setenv(ref_mg.HELLO_TIMEOUT_ENV, "9")
        monkeypatch.setenv(ref_mg.REPLY_TIMEOUT_ENV, "11")
        monkeypatch.setenv(ref_mg.REGROUP_ATTEMPTS_ENV, "5")
        mg = MeshGroup(workers=0, device="cpu")
        assert (mg.hello_timeout_s, mg.reply_timeout_s,
                mg.regroup_attempts) == (ref_mg._HELLO_TIMEOUT_S,
                                         ref_mg._REPLY_TIMEOUT_S,
                                         ref_mg._REGROUP_ATTEMPTS)
        mg2 = MeshGroup(workers=0, device="cpu", hello_timeout_s=3.0,
                        reply_timeout_s=4.0, regroup_attempts=2,
                        regroup_backoff_s=0.5)
        assert (mg2.hello_timeout_s, mg2.reply_timeout_s,
                mg2.regroup_attempts, mg2.regroup_backoff_s) == (
            3.0, 4.0, 2, 0.5)


class TestMeshCanaryCmd:
    def test_canary_shape_equals_the_reference(self):
        assert MESH_CANARY_SHAPE == ref_canary.MESH_CANARY_SHAPE
        assert CANARY_SEED == ref_canary.CANARY_SEED

    def test_canary_matches_oracle_and_spares_residency(self):
        cache = {"mesh": dm.dist_mesh2(), "device": torch.device("cpu")}
        arrays, statics = dm.tick_arrays(HEAL_SHAPE, 3, 0)
        dm.dispatch_dist(arrays, comm=cache["mesh"], cache=cache,
                         device="cpu", **statics)
        placed = dict(cache["last_placement"])
        reply, rarrays = dm._worker_cmd(
            {"cmd": "canary", "shape": MESH_CANARY_SHAPE,
             "seed": CANARY_SEED, "tick": 0}, {}, 0, cache)
        assert reply["ok"] and rarrays is None
        want = ref_mg.MeshGroup(workers=0).solve_oracle(
            ref_canary.MESH_CANARY_SHAPE, seed=ref_canary.CANARY_SEED,
            tick=0)["fingerprint"]
        assert reply["fingerprint"] == want
        assert MeshGroup(workers=0, device="cpu").solve_oracle(
            MESH_CANARY_SHAPE, CANARY_SEED, 0)["fingerprint"] == want
        assert cache["last_placement"] == placed

    def test_canary_requires_mesh(self):
        with pytest.raises(RuntimeError, match="mesh not initialized"):
            dm._worker_cmd({"cmd": "canary", "shape": MESH_CANARY_SHAPE,
                            "seed": CANARY_SEED, "tick": 0}, {}, 0,
                           {"device": torch.device("cpu")})

    def test_sleep_cmd_holds_then_acks(self):
        t0 = time.perf_counter()
        reply, _ = dm._worker_cmd({"cmd": "sleep", "s": 0.05}, {}, 0, {})
        assert reply["ok"] and time.perf_counter() - t0 >= 0.05

    def test_unknown_command_raises(self):
        with pytest.raises(ValueError, match="unknown command"):
            dm._worker_cmd({"cmd": "nope"}, {}, 0, {})
