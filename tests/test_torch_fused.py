"""The port's fused block scan (K5) held against the reference package on
the CPU.

- The run walk: ``independent_runs`` and ``SnapshotEncoding.fused_runs``
  equal the reference's on random bool matrices and on real encodings.
- Host packing at F = 4: ``pack_inputs1`` / ``patch_inputs1`` give the
  reference's bytes (existing nodes, a priority section, a patched
  ``fuse`` section).
- Kernel parity: the plain ``solve_scan_packed1(F=4)`` against the
  reference's jitted ``solve_scan_packed1(F=4)`` on every K == 0 arena
  case (each with a vectorized and a sequential block) and on a striped
  case whose flags are the solver's plan; the plain ``_many(F=4)``
  against the reference's on lanes whose blocks branch differently.
- Solver parity: ``CUDASolver(device="cpu")`` packs, routes and records
  like the reference ``TPUSolver`` (the ``fuse`` flags, the statics,
  ``fused_blocks`` / ``seq_blocks``), and decides like the reference
  ``CPUSolver``, on the scenarios of the reference's ``TestFusedKernel``
  (tests/test_solver_equivalence.py) and on ``solve_batch``; warm ticks
  on a fused arena patch the ``fuse`` section like a fresh pack.

The scenarios run over a catalog of the five striped families (both
packages build the same one), which keeps the plain scan fast. Tolerance:
exact (int64 and bool).
"""

import random
import types

import numpy as np
import pytest
import torch

import karpenter_provider_aws_tpu.apis.labels as L_ref
import karpenter_provider_aws_tpu.apis.resources as res_ref
import karpenter_provider_aws_tpu.fake.catalog as cat_ref
import karpenter_provider_aws_tpu.fake.environment as env_ref
import karpenter_provider_aws_tpu.solver.types as types_ref
import karpenter_provider_aws_tpu_torch.apis.labels as L_port
import karpenter_provider_aws_tpu_torch.apis.resources as res_port
import karpenter_provider_aws_tpu_torch.fake.catalog as cat_port
import karpenter_provider_aws_tpu_torch.fake.environment as env_port
import karpenter_provider_aws_tpu_torch.solver.types as types_port
from __graft_entry__ import _example_arrays
from karpenter_provider_aws_tpu.fake.ec2 import FakeEC2
from karpenter_provider_aws_tpu.models import delta as delta_ref
from karpenter_provider_aws_tpu.models import encoding as enc_ref
from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu.ops import hostpack as hp_ref
from karpenter_provider_aws_tpu.solver import CPUSolver
from karpenter_provider_aws_tpu.solver.tpu import TPUSolver
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.models import delta as delta_port
from karpenter_provider_aws_tpu_torch.models import encoding as enc_port
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
from karpenter_provider_aws_tpu_torch.ops import hostpack as hp_port
from karpenter_provider_aws_tpu_torch.solver import CUDASolver


def _env_ref():
    fams = [f for f in cat_ref.FAMILIES
            if f.family in examples.STRIPE_FAMILIES]
    return env_ref.Environment(ec2=FakeEC2(
        catalog=cat_ref.build_catalog(fams)))


def _env_port():
    fams = [f for f in cat_port.FAMILIES
            if f.family in examples.STRIPE_FAMILIES]
    return env_port.Environment(catalog=cat_port.build_catalog(fams))


REF = types.SimpleNamespace(L=L_ref, res=res_ref, env=env_ref,
                            types=types_ref, new_env=_env_ref,
                            zones=lambda e: e.ec2.zones,
                            enc=enc_ref, delta=delta_ref)
PORT = types.SimpleNamespace(L=L_port, res=res_port, env=env_port,
                             types=types_port, new_env=_env_port,
                             zones=lambda e: e.zones,
                             enc=enc_port, delta=delta_port)

FU = examples.FUSE


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


def _pack(hp, arrays, st):
    return hp.pack_inputs1_state(arrays, *examples.pack_statics(st))


def _indep(arrays):
    return ft.block_indep(torch.from_numpy(arrays["fuse"]), FU).tolist()


# ---------------------------------------------------------------------------
# the run walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,density", [((1, 3), 0.5), ((40, 2), 0.3),
                                           ((64, 5), 0.15), ((96, 9), 0.6),
                                           ((0, 4), 0.5)])
def test_independent_runs_matches_reference(shape, density):
    rng = np.random.RandomState(shape[0] * 7 + shape[1])
    rows = rng.rand(*shape) < density
    want = enc_ref.independent_runs(rows)
    got = enc_port.independent_runs(rows)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


def test_fused_runs_of_encodings_match_reference(both_counters):
    """``fused_runs`` on the encodings of the striped cluster and of a
    fuzz scenario, in both packages: equal flags, cached on the
    encoding."""
    runs = []
    for build in [lambda ns, e: examples.striped_cluster(
            e, n_pods=400, n_sigs=80, api=_api(ns))] + [
            (lambda ns, e, s=s: _fuzz(ns, e, s)) for s in range(4)]:
        snaps = [build(ns, ns.new_env()) for ns in (REF, PORT)]
        e_r = enc_ref.encode_snapshot(snaps[0])
        e_p = enc_port.encode_snapshot(snaps[1])
        np.testing.assert_array_equal(e_p.admit, e_r.admit)
        got = e_p.fused_runs()
        np.testing.assert_array_equal(got, e_r.fused_runs())
        assert e_p.fused_runs() is got
        runs.append(int(got.sum()))
    assert runs[0] and min(runs) < max(runs)


# ---------------------------------------------------------------------------
# host packing at F = 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", examples.FUSED_CASES)
def test_hostpack_fused_byte_identical(case):
    """``pack_inputs1_state`` at F = 4 and ``patch_inputs1`` of the
    ``fuse`` and ``ex_compat`` sections give the reference's bytes and
    equal a fresh pack of the patched arrays."""
    arrays, st = examples.fused_case(case)
    args = examples.pack_statics(st)
    assert args[9] == FU
    b_r, bl_r = _pack(hp_ref, arrays, st)
    b_p, bl_p = _pack(hp_port, arrays, st)
    np.testing.assert_array_equal(b_p, b_r)
    np.testing.assert_array_equal(bl_p, bl_r)
    assert hp_port.in_layout_bool(*args) == hp_ref.in_layout_bool(*args)
    new = {k: np.array(v) for k, v in arrays.items()}
    new["fuse"] = ~new["fuse"]
    dirtyb = ["fuse"]
    if st["E"]:
        new["ex_compat"][0] = ~new["ex_compat"][0]
        dirtyb.append("ex_compat")
    s_r = hp_ref.patch_inputs1(b_r, bl_r, new, [], dirtyb, *args)
    s_p = hp_port.patch_inputs1(b_p, bl_p, new, [], dirtyb, *args)
    assert s_p == s_r
    np.testing.assert_array_equal(b_p, b_r)
    np.testing.assert_array_equal(b_p, hp_port.pack_inputs1(new, *args))


# ---------------------------------------------------------------------------
# the plain fused scan against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", examples.FUSED_CASES)
def test_fused_scan_byte_identical(case):
    """The plain ``solve_scan_packed1(F=4)`` gives the reference's output
    buffer byte for byte; each case runs both branches."""
    arrays, st = examples.fused_case(case, base=_example_arrays)
    indep = _indep(arrays)
    assert True in indep and False in indep
    buf = hp_ref.pack_inputs1(arrays, *examples.pack_statics(st))
    want = np.asarray(ffd_jax.solve_scan_packed1(
        buf, **examples.solve_statics(st)))
    got = ft.solve_scan_packed1(buf, device="cpu",
                                **examples.solve_statics(st))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_parts_compose():
    """The two parts of a block (the plain versions of the two K5
    kernels) compose to the whole scan: the headroom part from the
    block-start carry is each group's own ``_slot_headroom_ref``, its
    table each group's own ``_new_node_table_ref``, and the block commit
    chains to ``_solve_fused_ref``'s result."""
    arrays, st = examples.fused_case("striped")
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    E, P, G = st["E"], st["P"], st["G"]
    carry = ft.carry0(inp, E + st["n_max"], E)
    indep = _indep(arrays)
    takes = []
    for b in range(G // FU):
        cand, k = ft._fused_headroom_ref(inp, carry, b * FU, FU, E=E, P=P)
        assert cand.shape == (FU,) + tuple(carry.types.shape)
        for i in range(FU):
            c1, k1 = ft._slot_headroom_ref(inp, carry, b * FU + i, E=E, P=P,
                                           V=0)
            assert torch.equal(cand[i], c1) and torch.equal(k[i], k1)
        tab = ft._fused_table_ref(inp, b * FU, FU, P=P)
        for i in range(FU):
            one = ft._new_node_table_ref(inp, b * FU + i, P=P)
            assert torch.equal(tab.candn[i], one.candn)
            assert torch.equal(tab.hrn[i], one.hrn)
            assert torch.equal(tab.cap[i], one.cap)
        carry, tk, _ = ft._fused_block_ref(inp, carry, b * FU, FU, indep[b],
                                           tab, E=E, P=P)
        takes.append(tk)
    t_all, _, final = ft._solve_fused_ref(inp, st["n_max"], E, P, FU)
    assert torch.equal(torch.cat(takes), t_all)
    for f, a, b in zip(ft.Carry._fields, carry, final):
        assert torch.equal(a, b), f


def _slot_cta_model(inp, carry, g0, Fu, *, E, P, seen):
    """``ffd_fused_headroom``'s slot CTA as csrc/fused.cu runs it
    (``fused_slot_headroom``): for each slot the groups that take its pool
    share one pass over the types, each with its own F row and zone x
    capacity-type mask (bit z*C + c) tested against the type's offering
    mask; the other groups' candidate rows are zero and their k 0; an
    existing row's k is its allocatable's headroom under each group's
    compatibility. Returns (cand [Fu, N, T], k [Fu, N])."""
    N, T = carry.types.shape
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    bit = 1 << torch.arange(Z * C, dtype=torch.int64)
    am = (inp.avail_zc.long() * bit).sum(-1)                        # [T]
    cand = torch.zeros((Fu, N, T), dtype=torch.bool)
    k = torch.zeros((Fu, N), dtype=torch.int64)
    for s in range(N):
        pool = int(carry.pool[s])
        pc = min(max(pool, 0), P - 1)
        adm = [pool >= 0 and bool(inp.admit[g0 + i, pc]) for i in range(Fu)]
        seen["skipped" if not any(adm) else
             "shared" if all(adm) else "partial"] = True
        for i in range(Fu):
            g = g0 + i
            if adm[i]:
                zc = ((carry.zones[s] & inp.agz[g])[:, None]
                      & (carry.ct[s] & inp.agc[g])[None, :]).reshape(-1)
                mask = int((zc.long() * bit).sum())
                cand[i, s] = carry.types[s] & inp.F[g] & ((am & mask) != 0)
                hr = ft._headroom(inp.A, carry.used[s][None, :], inp.R[g])
                k[i, s] = torch.where(cand[i, s], hr, 0).max()
            if s < E:
                seen["existing"] = True
                ok = bool(carry.alive[s] & inp.ex_compat[g, s])
                k[i, s] = int(ft._headroom(inp.ex_alloc[s], carry.used[s],
                                           inp.R[g])) if ok else 0
    return cand, k


def _floordiv_fp_model(a: int, b: int) -> int:
    """csrc/ffd_common.cuh ``floordiv_fp``: below 2^52 an fp64 quotient
    (IEEE division, as the card's) floored, then one correction by the
    remainder's sign and size; the integer floor division otherwise."""
    lim = 1 << 52
    if a <= -lim or a >= lim or b >= lim:
        return a // b
    q = int(np.floor(np.float64(a) / np.float64(b)))
    r = a - q * b
    return q - (r < 0) + (r >= b)


def test_fp64_quotient_is_exact():
    """The slot CTA's fp64 quotient equals the floor division on random
    and edge operands: multiples of b and one either side, negative
    numerators (over-committed rows), b = 1, operands near 2^52 and past
    it (the integer path)."""
    rng = np.random.RandomState(3)
    cases = [(int(a), int(b)) for a, b in zip(
        rng.randint(-(1 << 52) + 1, 1 << 52, size=20000, dtype=np.int64),
        rng.randint(1, 1 << 40, size=20000, dtype=np.int64))]
    for _ in range(20000):
        b = int(rng.randint(1, 1 << 26))
        q = int(rng.randint(-(1 << 25), 1 << 25))
        for d in (-1, 0, 1):
            cases.append((q * b + d, b))
    lim = 1 << 52
    cases += [(lim - 1, 1), (-lim + 1, 1), (lim - 1, 3), (-lim + 1, 7),
              (lim, 3), (-lim, 3), ((1 << 62) + 5, 7), (5, lim + 1),
              (0, 1), (-1, 1 << 51), (1 << 51, (1 << 51) - 1)]
    for a, b in cases:
        assert _floordiv_fp_model(a, b) == a // b, (a, b)


def test_fused_headroom_blocks_rule():
    """The headroom launch's blocks a lane: one CTA a slot for all Fu
    groups, then the tables' Fu * P * table_blocks(T) (the striped
    cluster: 256 + 128, one wave of the card's 132 SMs)."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    assert fc.fused_headroom_blocks(256, 4, 8, 812) == 256 + 128
    assert fc.fused_headroom_blocks(200, 4, 2, 48) == 200 + 8
    assert fc.fused_headroom_blocks(64, 8, 1, 257) == 64 + 16


@pytest.mark.parametrize("case", examples.FUSED_CASES)
def test_fused_slot_cta_model_matches_plain(case):
    """The model of the headroom's slot CTA equals ``_fused_headroom_ref``
    at every block start of the plain fused scan (each block from the
    plain block-start carry): slots no group takes (free, existing, a
    pool the block does not admit), slots some groups take, existing
    rows."""
    arrays, st = examples.fused_case(case)
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    E, P, G = st["E"], st["P"], st["G"]
    carry = ft.carry0(inp, E + st["n_max"], E)
    indep = _indep(arrays)
    seen = {}
    for b in range(G // FU):
        want = ft._fused_headroom_ref(inp, carry, b * FU, FU, E=E, P=P)
        got = _slot_cta_model(inp, carry, b * FU, FU, E=E, P=P, seen=seen)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        tab = ft._fused_table_ref(inp, b * FU, FU, P=P)
        carry, _, _ = ft._fused_block_ref(inp, carry, b * FU, FU, indep[b],
                                          tab, E=E, P=P)
    assert seen.get("skipped") and (seen.get("shared")
                                    or seen.get("partial"))
    if case == "striped":
        assert seen.get("partial") and seen.get("existing")


def test_fused_many_byte_identical():
    """The plain ``solve_scan_packed1_many(F=4)`` against the reference's
    vmap on three striped lanes whose blocks branch differently; each
    row is the single fused solve of its arena."""
    arrays, st = examples.fused_case("striped")
    lanes = []
    for flip in (None, 1, 5):
        a = {k: np.array(v) for k, v in arrays.items()}
        if flip is not None:
            a["fuse"][flip] = ~a["fuse"][flip]
            a["n"] = np.roll(a["n"], flip)
        lanes.append(a)
    indep = np.array([_indep(a) for a in lanes])
    assert (indep.min(axis=0) != indep.max(axis=0)).any()
    bufs = np.stack([hp_ref.pack_inputs1(a, *examples.pack_statics(st))
                     for a in lanes])
    ss = examples.solve_statics(st)
    want = np.asarray(ffd_jax.solve_scan_packed1_many(bufs, **ss))
    got = ft.solve_scan_packed1_many(bufs, device="cpu", **ss)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(),
            ft.solve_scan_packed1(bufs[b], device="cpu", **ss).numpy())


# ---------------------------------------------------------------------------
# the solver: routing, evidence and decisions against the reference
# ---------------------------------------------------------------------------

def _api(ns):
    return types.SimpleNamespace(make_pods=ns.env.make_pods, L=ns.L,
                                 Resources=ns.res.Resources,
                                 ExistingNode=ns.types.ExistingNode)


def _node(ns, env, name, cpu="16", mem="64Gi", zone=0, labels=None):
    lab = {ns.L.ARCH: "amd64", ns.L.OS: "linux",
           ns.L.ZONE: ns.zones(env)[zone].name}
    lab.update(labels or {})
    return ns.types.ExistingNode(name=name, labels=lab,
                                 allocatable=ns.res.Resources.parse(
                                     {"cpu": cpu, "memory": mem, "pods": 58}))


def _striped(ns, env, n_sigs=90, per=2, fams=("m5", "c5", "r5"),
             existing=()):
    """The reference test's ``_striped_snapshot``."""
    L = ns.L
    pods = []
    for i in range(n_sigs):
        pods += ns.env.make_pods(per, cpu=f"{100 + (i * 7) % 400}m",
                                 memory=f"{256 + (i * 13) % 700}Mi",
                                 prefix=f"st{i:03d}",
                                 node_selector={L.INSTANCE_FAMILY:
                                                fams[i % len(fams)]})
    pools = [env.nodepool(f"stripe-{n_sigs}-{per}-{f}", requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "In", "values": [f]}])
        for f in fams]
    return env.snapshot(pods, pools, existing_nodes=list(existing))


def _single_pool(ns, env):
    pods = []
    for i in range(70):
        pods += ns.env.make_pods(1, cpu=f"{100 + i}m", memory="256Mi",
                                 prefix=f"np{i:03d}")
    return env.snapshot(pods, [env.nodepool("norun")])


def _existing(ns, env):
    return _striped(ns, env, n_sigs=80, per=1,
                    existing=[_node(ns, env, "ex-fused-0")])


def _fuzz(ns, env, seed):
    """The reference test's ``test_fused_fuzz_identical`` scenario."""
    L = ns.L
    rng = random.Random(31000 + seed)
    fams = rng.sample(list(examples.STRIPE_FAMILIES), rng.randint(2, 4))
    pools = []
    for f in fams:
        limits = {"cpu": str(rng.randint(20, 200))} \
            if rng.random() < 0.3 else None
        pools.append(env.nodepool(
            f"fz{seed}-{f}", limits=limits, weight=rng.randint(0, 100),
            requirements=[{"key": L.INSTANCE_FAMILY, "operator": "In",
                           "values": [f]}]))
    if rng.random() < 0.4:   # a shared fallback pool breaks runs
        pools.append(env.nodepool(f"fz{seed}-any"))
    pods = []
    for i in range(rng.randint(24, 120)):
        sel = None
        if rng.random() < 0.85:
            sel = {L.INSTANCE_FAMILY: rng.choice(fams)}
        pods += ns.env.make_pods(
            rng.randint(1, 5), cpu=f"{rng.randint(50, 900)}m",
            memory=f"{rng.randint(128, 2048)}Mi", prefix=f"fz{seed}-{i:03d}",
            node_selector=sel)
    existing = []
    for e in range(rng.randint(0, 2)):
        zone = rng.randrange(len(ns.zones(env)))
        existing.append(_node(ns, env, f"fzex-{seed}-{e}",
                              cpu=str(rng.randint(4, 16)),
                              mem=f"{rng.randint(8, 64)}Gi", zone=zone))
    return env.snapshot(pods, pools, existing_nodes=existing)


SCENARIOS = dict(striped=(_striped, 64), single_pool=(_single_pool, 64),
                 existing=(_existing, 64),
                 **{f"fuzz{s}": ((lambda ns, e, s=s: _fuzz(ns, e, s)), 1)
                    for s in range(8)})


def _ref_plan(snap, min_groups):
    """The reference ``TPUSolver``'s padded arrays and statics for one
    device (its fuse plan), and its fused block count."""
    t = TPUSolver(backend="numpy", incremental=False)
    t.dev_fuse_min_groups = min_groups
    enc = enc_ref.encode_snapshot(snap)
    ex = delta_ref.full_existing_encode(
        enc, sorted(snap.existing_nodes, key=lambda n: n.name))
    arrays, stt = t._prep_device_inputs(enc, *ex, 1)
    fb = TPUSolver._fused_block_count(arrays["fuse"], stt["F"]) \
        if stt["F"] > 1 else 0
    return arrays, stt, fb


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_solver_routes_and_decides_like_reference(both_counters, name):
    """``CUDASolver(device="cpu")`` (incremental, as served) packs the
    reference's fused arena (the ``fuse`` flags and statics of
    ``TPUSolver._prep_device_inputs``), records ``kernel="fused"`` with
    the reference's block split, and decides like ``CPUSolver``."""
    build, min_groups = SCENARIOS[name]
    snap_r = build(REF, REF.new_env())
    snap_p = build(PORT, PORT.new_env())
    assert [p.name for p in snap_p.pods] == [p.name for p in snap_r.pods]
    arrays_r, stt_r, fb = _ref_plan(snap_r, min_groups)
    assert stt_r["F"] == FU
    solver = CUDASolver(device="cpu", n_max=192)
    solver.dev_fuse_min_groups = min_groups
    enc = enc_port.encode_snapshot(snap_p)
    ex = delta_port.full_existing_encode(
        enc, sorted(snap_p.existing_nodes, key=lambda n: n.name))
    arrays, stt = solver._prep_device_inputs(enc, *ex)
    assert stt == stt_r
    assert sorted(arrays) == sorted(arrays_r)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], arrays_r[k], err_msg=k)
    got = solver.solve(snap_p)
    ds = solver.last_dispatch_stats
    steps = stt["G"] // FU
    assert (ds["kernel"], ds["fuse"], ds["scan_steps"], ds["fused_blocks"],
            ds["seq_blocks"]) == ("fused", FU, steps, fb, steps - fb)
    if name == "single_pool":
        # no real group fuses: the blocks holding one are sequential
        assert ds["seq_blocks"] == -(-70 // FU)
    want = CPUSolver().solve(snap_r)
    assert got.decision_fingerprint() == want.decision_fingerprint(), name


def test_routing_edges(both_counters):
    """Gp = 32 stays unfused (the checkpointed scan when incremental);
    Gp = 64 fuses; past ``dev_max_groups`` the pruned scan runs at F = 1;
    minValues floors (K > 0) pack F = 1; ``dev_fuse = 1`` disables."""
    env = PORT.new_env()
    small = _striped(PORT, env, n_sigs=30, per=1)
    wide = _striped(PORT, env, n_sigs=64, per=1)
    s = CUDASolver(device="cpu", n_max=64)
    s.solve(small)
    assert (s.last_dispatch_stats["kernel"], s.last_dispatch_stats["fuse"]) \
        == ("ckpt", 1)
    res = s.solve(wide)
    assert (s.last_dispatch_stats["kernel"], s.last_dispatch_stats["fuse"]) \
        == ("fused", FU)
    for knob, kernel in (("dev_max_groups", "pruned"), ("dev_fuse", "base")):
        s = CUDASolver(device="cpu", n_max=64, incremental=False)
        setattr(s, knob, 32 if knob == "dev_max_groups" else 1)
        assert s.solve(wide).decision_fingerprint() == \
            res.decision_fingerprint()
        assert (s.last_dispatch_stats["kernel"],
                s.last_dispatch_stats["fuse"]) == (kernel, 1)
    s = CUDASolver(device="cpu", n_max=64)
    pool = env.nodepool("mv", requirements=[
        {"key": PORT.L.INSTANCE_FAMILY, "operator": "In",
         "values": list(examples.STRIPE_FAMILIES), "minValues": 2}])
    mv = env.snapshot(wide.pods, [pool])
    enc = enc_port.encode_snapshot(mv)
    assert enc.mv_K and len(enc.groups) == 64
    assert s._prep_device_inputs(enc, *delta_port.full_existing_encode(
        enc, []))[1]["F"] == 1


def test_gp_crossing_64_never_reuses_an_unfused_bank(both_counters):
    """An incremental solver whose padded group count crosses 64 between
    ticks: the fused tick runs full (no bank at F = 4), and the next
    Gp = 32 tick does not resume from the bank recorded before it; the
    bank key holds the statics (F included). Decisions equal a solve
    from scratch every tick."""
    env = PORT.new_env()
    snaps = [_striped(PORT, env, n_sigs=n, per=1) for n in (30, 40, 30)]
    s = CUDASolver(device="cpu", n_max=64)
    scratch = CUDASolver(device="cpu", n_max=64, incremental=False)
    kinds = []
    for snap in snaps:
        got = s.solve(snap)
        kinds.append(s.last_dispatch_stats["kernel"])
        assert got.decision_fingerprint() == \
            scratch.solve(snap).decision_fingerprint()
        key = dict(s._ckpt_bank["key"][0])
        assert key["F"] == 1 and key["G"] == 32
    assert kinds == ["ckpt", "fused", "ckpt"]


def test_solve_batch_fused(both_counters):
    """``solve_batch`` over striped snapshots of one statics bucket
    (Gp = 128) rides one fused dispatch, records the reference's
    ``fuse`` and per-lane mean of ``fused_blocks``, and decides like
    ``CPUSolver`` snapshot by snapshot."""
    def batch(ns):
        env = ns.new_env()
        return [_striped(ns, env, n_sigs=90 + b, per=1 + b % 2,
                         fams=examples.STRIPE_FAMILIES[:3 + b % 2])
                for b in range(3)]
    snaps_r, snaps_p = batch(REF), batch(PORT)
    fbs = [_ref_plan(x, 64)[2] for x in snaps_r]
    s = CUDASolver(device="cpu")
    calls = []
    orig = s._dispatch_many

    def spy(bufs, **st):
        calls.append(st)
        return orig(bufs, **st)
    s._dispatch_many = spy
    got = s.solve_batch(snaps_p)
    assert len(calls) == 1 and calls[0]["F"] == FU and calls[0]["G"] == 128
    ds = s.last_dispatch_stats
    assert (ds["kernel"], ds["batch"], ds["fuse"], ds["scan_steps"]) == \
        ("batch", 3, FU, 128 // FU)
    assert ds["fused_blocks"] == round(sum(fbs) / len(fbs))
    assert ds["seq_blocks"] == 128 // FU - ds["fused_blocks"]
    want = [CPUSolver().solve(x) for x in snaps_r]
    assert [r.decision_fingerprint() for r in got] == \
        [r.decision_fingerprint() for r in want]


def _warm_scenario(ns, env, node_labels):
    """Family-striped groups that allow their family through a NotIn over
    the others (a node without a family label satisfies it), with two
    existing nodes: unlabeled, every group can land on them and the
    existing-compat runs break at every group; labeled, they split by
    family and the runs follow the pools."""
    L = ns.L
    fams = examples.STRIPE_FAMILIES
    pods = []
    for i in range(70):
        f = fams[i % 5]
        pods += ns.env.make_pods(
            2, cpu=f"{100 + (i * 7) % 400}m",
            memory=f"{256 + (i * 13) % 700}Mi", prefix=f"wf{i:03d}",
            affinity_terms=[{"key": L.INSTANCE_FAMILY, "operator": "NotIn",
                             "values": [x for x in fams if x != f]}])
    pools = [env.nodepool(f"wf-{f}", requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "In", "values": [f]}])
        for f in fams]
    nodes = [_node(ns, env, f"wf-ex-{e}", cpu="4", mem="8Gi", zone=e,
                   labels=node_labels[e]) for e in range(2)]
    return env.snapshot(pods, pools, existing_nodes=nodes)


def test_warm_ticks_patch_the_fuse_section(both_counters):
    """Rows-tier ticks on a fused arena: relabeling the existing nodes
    dirties ``ex_compat``, the resident arena is patched (never
    re-packed) and equals a fresh pack byte for byte, its ``fuse`` flags
    moved, and every tick decides like ``CPUSolver`` and like a solve
    from scratch."""
    L = PORT.L
    ticks = [({}, {}), ({L.INSTANCE_FAMILY: "m5"}, {L.INSTANCE_FAMILY: "c5"}),
             ({}, {})]
    env_r, env_p = REF.new_env(), PORT.new_env()
    snap_p = _warm_scenario(PORT, env_p, ticks[0])
    snap_r = _warm_scenario(REF, env_r, ticks[0])
    s = CUDASolver(device="cpu", n_max=64)
    scratch = CUDASolver(device="cpu", n_max=64, incremental=False)
    prev = None
    for t, labels in enumerate(ticks):
        for snap, ns in ((snap_p, PORT), (snap_r, REF)):
            for node, lab in zip(snap.existing_nodes, labels):
                node.labels = {k: v for k, v in node.labels.items()
                               if k != ns.L.INSTANCE_FAMILY}
                node.labels.update({ns.L.INSTANCE_FAMILY: v
                                    for v in lab.values()})
        got = s.solve(snap_p)
        assert s.last_dispatch_stats["kernel"] == "fused"
        pc = s._pack_cache
        enc = enc_port.encode_snapshot(snap_p)
        fresh, _ = s.pack(enc, *delta_port.full_existing_encode(
            enc, sorted(snap_p.existing_nodes, key=lambda n: n.name)))
        np.testing.assert_array_equal(pc["buf"], fresh, err_msg=f"tick {t}")
        if t:
            assert s.last_phase_stats["cache"] == "rows"
            assert pc["buf"] is prev[0]
            assert not np.array_equal(pc["arrays"]["fuse"], prev[1])
        prev = (pc["buf"], pc["arrays"]["fuse"].copy())
        assert got.decision_fingerprint() == \
            scratch.solve(snap_p).decision_fingerprint()
        assert got.decision_fingerprint() == \
            CPUSolver().solve(snap_r).decision_fingerprint()


@pytest.mark.parametrize("module", ["models.encoding", "models.delta",
                                    "examples", "ops.ffd_torch"])
def test_port_modules_import_alone(module):
    """Each module imports first in a fresh interpreter: the encoder's
    import of ``solver.cpu`` no longer runs ``solver/cuda.py`` (which
    imports the encoder back) through the package's ``__init__``."""
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-c",
         f"import karpenter_provider_aws_tpu_torch.{module}"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
