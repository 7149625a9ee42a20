"""The port's topology scan (K9) held against the reference package on the
CPU.

- Scan parity: the plain ``dispatch_topo`` of ``ops/topo_torch.py``
  against the reference's ``ops/topo_jax.dispatch_topo`` (JAX on the CPU)
  on the same numpy inputs, every output (takes, leftover, every event-log
  array, zfix, bail, the final carry). The inputs are the kernel cases of
  ``examples.topo_case``, all in one shape bucket; between them they reach
  every event kind, an anti run of m = 0, the cap-1 ladder, a bail at
  EVCAP = 1 and 2, two pools with binding limits, hostname spread, zone
  affinity and zone anti-affinity (``test_cases_reach_their_hazards``).
- The plain parts: ``_topo_group_start_ref`` against the reference
  kernel's group-start expressions at each topology group's entry state
  (from the reference's own scan), and ``_topo_record_plain_ref`` against
  its membership recording; the plain scan with the pool statics
  computed a chunk of one or two topology groups ahead (the kernels'
  order) against the reference's scan.
- The slice: ``CUDASolver(device="cpu")`` against the reference
  ``CPUSolver`` by decision fingerprint on the equivalence scenarios, the
  fuzz generator of tests/test_topology_equivalence.py and BASELINE
  config 3 at 2,000 pods; the routing (host pour outside the envelope,
  the bail re-dispatch, the oracle route of an unsupported key); two
  warm ticks.
- The copies: ``ops/topo.py`` (encodings and host-pour outputs) and
  ``_runs_from_events`` against the originals.

Tolerance: exact (int64 and bool).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import karpenter_provider_aws_tpu.apis.labels as L_ref
import karpenter_provider_aws_tpu.fake.environment as env_ref
import karpenter_provider_aws_tpu_torch.fake.environment as env_port
from karpenter_provider_aws_tpu.apis.objects import (
    PodAffinityTerm as PAT_ref, TopologySpreadConstraint as TSC_ref)
from karpenter_provider_aws_tpu.apis.resources import Resources as Res_ref
from karpenter_provider_aws_tpu.models.encoding import \
    encode_snapshot as encode_ref
from karpenter_provider_aws_tpu.ops import ffd as ffd_ref
from karpenter_provider_aws_tpu.ops import topo as topo_ref
from karpenter_provider_aws_tpu.ops import topo_jax
from karpenter_provider_aws_tpu.ops.ffd_jax import (KernelInputs as KI_jax,
                                                    _headroom_matrix,
                                                    _headroom_vec)
from karpenter_provider_aws_tpu.solver import CPUSolver
from karpenter_provider_aws_tpu.solver import tpu as tpu_ref
from karpenter_provider_aws_tpu.solver.types import \
    ExistingNode as Existing_ref
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.apis import labels as L_port
from karpenter_provider_aws_tpu_torch.apis.objects import \
    TopologySpreadConstraint as TSC_port
from karpenter_provider_aws_tpu_torch.models.encoding import \
    encode_snapshot as encode_port
from karpenter_provider_aws_tpu_torch.ops import ffd as ffd_port
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
from karpenter_provider_aws_tpu_torch.ops import topo as topo_port
from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
from karpenter_provider_aws_tpu_torch.solver import CUDASolver
from karpenter_provider_aws_tpu_torch.solver import cuda as cuda_port


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain scan is thousands of small tensor ops: one intra-op
    thread runs them fastest, and several test workers on one host then
    do not oversubscribe the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


REF_API = types.SimpleNamespace(
    make_pods=env_ref.make_pods, L=L_ref, Resources=Res_ref,
    TopologySpreadConstraint=TSC_ref, PodAffinityTerm=PAT_ref,
    ExistingNode=Existing_ref)
PMAX = 8

#: jax outputs per (case, EVCAP): every case shares one shape bucket, so
#: the reference kernel compiles once per EVCAP
_JAX_RUNS: dict = {}


def _case(name):
    return examples.topo_case(name, env=_port_env())


_ENVS: dict = {}


def _port_env():
    if "port" not in _ENVS:
        _ENVS["port"] = env_port.Environment()
    return _ENVS["port"]


def _ref_env():
    if "ref" not in _ENVS:
        _ENVS["ref"] = env_ref.Environment()
    return _ENVS["ref"]


def _jax_run(name, evcap=128):
    key = (name, evcap)
    if key not in _JAX_RUNS:
        arrays, rows, stt = _case(name)
        st = dict(stt, EVCAP=evcap, PMAX=PMAX)
        out = topo_jax.dispatch_topo(arrays, rows, st)
        _JAX_RUNS[key] = (arrays, rows, st,
                          {k: np.asarray(v) for k, v in out.items()})
    return _JAX_RUNS[key]


def _assert_outputs_equal(got: dict, want: dict, label):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (label, k)
        assert np.array_equal(g, w), (label, k)


@pytest.fixture
def both_counters():
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()
    yield
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()


# ---------------------------------------------------------------------------
# the scan against the reference kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", examples.TOPO_CASES)
def test_scan_byte_identical(name):
    arrays, rows, st, want = _jax_run(name)
    got = tt.dispatch_topo(arrays, rows, st, device="cpu")
    _assert_outputs_equal(got, want, name)
    # the whole final carry (the dispatch dict leaves out pool_used)
    inp, trows = _jax_inputs(arrays, rows)
    *_, final = topo_jax.solve_scan_topo(
        inp, trows, jnp.zeros((st["GZ"], st["Z"]), jnp.int64),
        jnp.zeros((st["GH"], st["n_max"]), jnp.int64), n_max=st["n_max"],
        P=st["P"], EVCAP=st["EVCAP"], PMAX=PMAX)
    *_, carry = tt.solve_scan_topo(
        ft.kernel_inputs_from_numpy(arrays, "cpu"),
        tt.topo_rows_from_numpy(rows, "cpu"),
        torch.zeros((st["GZ"], st["Z"]), dtype=torch.int64),
        torch.zeros((st["GH"], st["n_max"]), dtype=torch.int64),
        n_max=st["n_max"], P=st["P"], EVCAP=st["EVCAP"], PMAX=PMAX)
    for f, w in final._asdict().items():
        g = getattr(carry, f).numpy().reshape(np.shape(w))
        assert np.array_equal(g, np.asarray(w)), (name, f)


@pytest.mark.parametrize("name,chunk", [
    ("two_deployments", 1), ("fix_zones", 1), ("cross_group_zone_anti", 1),
    ("rows_last", 1), ("rows_last", 2)])
def test_scan_byte_identical_by_statics_chunk(name, chunk, monkeypatch):
    """The plain scan in the kernels' order, its pool statics computed a
    chunk of ``chunk`` topology groups ahead (``STATICS_CHUNK`` set; these
    cases have two and three, so their scans cross chunk boundaries),
    against the reference kernel: every output."""
    arrays, rows, st, want = _jax_run(name)
    assert int(rows["has_topo"].sum()) > chunk
    monkeypatch.setattr(tt, "STATICS_CHUNK", chunk)
    takes, leftover, ev, zfix, bail, carry = tt._solve_scan_topo_ref(
        ft.kernel_inputs_from_numpy(arrays, "cpu"),
        tt.topo_rows_from_numpy(rows, "cpu"),
        torch.zeros((st["GZ"], st["Z"]), dtype=torch.int64),
        torch.zeros((st["GH"], st["n_max"]), dtype=torch.int64),
        st["n_max"], st["P"], st["EVCAP"], PMAX)
    got = dict(takes=takes, leftover=leftover, zfix=zfix, bail=bail,
               used=carry.used, types=carry.types, zones=carry.zones,
               ct=carry.ct, pool=carry.pool, alive=carry.alive,
               num_nodes=carry.num_nodes.reshape(1),
               **{f"ev_{k}": v for k, v in ev.items()})
    _assert_outputs_equal(got, want, (name, chunk))


@pytest.mark.parametrize("evcap", [1, 2])
def test_bail_byte_identical(evcap):
    arrays, rows, st, want = _jax_run("config3_small", evcap)
    assert want["bail"].any()
    got = tt.dispatch_topo(arrays, rows, st, device="cpu")
    _assert_outputs_equal(got, want, evcap)


def test_cases_reach_their_hazards():
    kinds, antirun_lens, dz_hit = set(), set(), False
    hazards = dict(two_pools_limits=False, hostname_spread=False,
                   zone_affinity=False, zone_anti=False)
    for name in examples.TOPO_CASES:
        arrays, rows, _, out = _jax_run(name)
        for g in range(out["ev_n"].shape[0]):
            for i in range(int(out["ev_n"][g])):
                kinds.add(int(out["ev_kind"][g, i]))
                if out["ev_kind"][g, i] == tt.K_ANTIRUN:
                    antirun_lens.add(int(out["ev_len"][g, i]))
        limited = (arrays["pool_limit"][:, 0] >= 0) & \
            arrays["pool_types"].any(axis=1)
        hazards["two_pools_limits"] |= int(limited.sum()) >= 2
        hazards["hostname_spread"] |= bool((rows["hs_skew"] < tt.BIG).any())
        hazards["zone_affinity"] |= bool(
            (rows["za_any"] & ~rows["za_anti"]).any())
        hazards["zone_anti"] |= bool(rows["za_anti"].any())
        dz_hit |= _record_steps(name)[1]
    assert kinds == {tt.K_PLACE, tt.K_FIX, tt.K_OPEN, tt.K_CYC, tt.K_ANTIRUN}
    assert 0 in antirun_lens and max(antirun_lens) > 1
    assert all(hazards.values()), hazards
    assert dz_hit  # a plain group lands pods on zone-pinned slots
    for evcap in (1, 2):
        assert _jax_run("config3_small", evcap)[3]["bail"].any()


# ---------------------------------------------------------------------------
# the plain parts against the reference kernel's steps
# ---------------------------------------------------------------------------

def _jax_inputs(arrays, rows):
    inp = KI_jax(**{k: jnp.asarray(v) for k, v in arrays.items()})
    trows = topo_jax.TopoGroupRows(**{k: jnp.asarray(v)
                                      for k, v in rows.items()})
    return inp, trows


def _jax_group_start(inp, trows, carry, g, P):
    """topo_jax.py:281-315 at group g from ``carry`` (the reference's own
    expressions)."""
    T = inp.A.shape[0]
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    N = carry.used.shape[0]
    R, F, agz, agc = inp.R[g], inp.F[g], inp.agz[g], inp.agc[g]
    admit, daemon = inp.admit[g], inp.daemon[g]
    gx = topo_jax.TopoGroupRows(*[f[g] for f in trows])
    avail_tzc = inp.avail_zc.reshape(T, Z, C)
    availz_anyct = avail_tzc.any(axis=2)
    zc = ((carry.zones & agz[None, :])[:, :, None]
          & (carry.ct & agc[None, :])[:, None, :]).reshape(N, Z * C)
    off_ok = (zc.astype(jnp.int32) @ inp.avail_zc.T.astype(jnp.int32)) > 0
    pool_clipped = jnp.clip(carry.pool, 0, P - 1)
    adm_open = jnp.where(carry.pool >= 0, admit[pool_clipped], False)
    cand = carry.types & F[None, :] & off_ok & adm_open[:, None]
    rem0 = jnp.where(cand, _headroom_matrix(inp.A, carry.used, R),
                     0).max(axis=1)
    agz_p = agz[None, :] & inp.pool_agz
    agc_p = agc[None, :] & inp.pool_agc
    off_p = (avail_tzc[None] & agz_p[:, None, :, None]
             & agc_p[:, None, None, :]).any(axis=(2, 3))
    cand_new = F[None, :] & inp.pool_types & off_p
    hr_new = jnp.stack([_headroom_vec(inp.A, daemon[p][None, :], R)
                        for p in range(P)])
    hrc_new = jnp.where(cand_new, hr_new, 0)
    open_ok0 = (admit & agz_p.any(axis=1) & agc_p.any(axis=1)
                & (hrc_new.max(axis=1) >= 1))
    availz_p = (avail_tzc[None] & agc_p[:, None, None, :]).any(axis=3)
    cap_pz = jnp.where(availz_p & cand_new[:, :, None], hr_new[:, :, None],
                       0).max(axis=1)
    zcand_pz = ((cand_new & (hr_new >= 1))[:, :, None]
                & availz_anyct[None]).any(axis=1) & agz_p
    anti_bulk = (~gx.zs_any.any()) & (~gx.za_any.any()) \
        & (~gx.hs_any.any()) \
        & jnp.where(gx.ha_any, gx.ha_anti & gx.ha_own, True).all() \
        & gx.ha_any.any()
    return dict(cand=cand, rem0=rem0, cand_new=cand_new, hr_new=hr_new,
                open_ok0=open_ok0, availz_p=availz_p, cap_pz=cap_pz,
                cap_any=hrc_new.max(axis=1), zcand_pz=zcand_pz,
                anti_bulk=anti_bulk)


@pytest.mark.parametrize("name", ["config3_small", "two_pools_limits",
                                  "zone_plus_hostname", "anti_budget",
                                  "cross_group_zone_anti"])
def test_group_start_matches_reference_step(name):
    """At each topology group's entry state, taken from the reference's
    scan (groups from g on emptied: n = 0 and no topology, which no step
    reads), the plain group start equals the reference kernel's."""
    arrays, rows, st, _ = _jax_run(name)
    P = st["P"]
    checked = 0
    for g in np.nonzero(rows["has_topo"])[0]:
        a_g = dict(arrays, n=np.where(np.arange(len(arrays["n"])) < g,
                                      arrays["n"], 0))
        r_g = dict(rows, has_topo=rows["has_topo"]
                   & (np.arange(len(rows["has_topo"])) < g))
        inp, trows = _jax_inputs(a_g, r_g)
        _, _, _, _, _, carry = topo_jax.solve_scan_topo(
            inp, trows, jnp.zeros((st["GZ"], st["Z"]), jnp.int64),
            jnp.zeros((st["GH"], st["n_max"]), jnp.int64),
            n_max=st["n_max"], P=P, EVCAP=128, PMAX=PMAX)
        want = _jax_group_start(*_jax_inputs(arrays, rows), carry, int(g),
                                P)
        c = ft.carry_from_numpy({k: np.asarray(v)
                                 for k, v in carry._asdict().items()}, "cpu")
        got = tt._topo_group_start_ref(
            ft.kernel_inputs_from_numpy(arrays, "cpu"), c, int(g),
            tt.topo_rows_from_numpy(rows, "cpu"), P=P)
        for f, w in want.items():
            gv = getattr(got, f).numpy()
            w = np.asarray(w)
            assert gv.dtype == w.dtype and np.array_equal(gv, w), (g, f)
        checked += 1
    assert checked


def _record_steps(name):
    """Walk the plain scan; at each group without topology compare
    ``_topo_record_plain_ref`` with the reference kernel's recording
    (topo_jax.py:690-696) on the same state. Returns (groups checked,
    whether some recording added to a zone counter)."""
    arrays, rows, st = _case(name)
    inp = ft.kernel_inputs_from_numpy(arrays, "cpu")
    trows = tt.topo_rows_from_numpy(rows, "cpu")
    P, N, Z = st["P"], st["n_max"], st["Z"]
    carry = ft.carry0(inp, N, 0)
    cz = torch.zeros((st["GZ"], Z), dtype=torch.int64)
    ch = torch.zeros((st["GH"], N), dtype=torch.int64)
    zfix = torch.full((N,), -1, dtype=torch.int32)
    checked, dz_hit = 0, False
    for g in range(len(rows["has_topo"])):
        if rows["has_topo"][g]:
            gs = tt._topo_group_start_ref(inp, carry, g, trows, P=P)
            r = tt._topo_pour_ref(inp, carry, cz, ch, zfix, g, trows, gs,
                                  P=P, PMAX=PMAX)
            carry, cz, ch, zfix = r.carry, r.cz, r.ch, r.zfix
            continue
        carry, take, _ = ft._group_step_ref(inp, carry, g, E=0, P=P, V=0)
        got_cz, got_ch = tt._topo_record_plain_ref(
            cz, ch, zfix, take, trows.member_z[g], trows.member_h[g])
        mz, mh = int(rows["member_z"][g]), int(rows["member_h"][g])
        take_j, zfix_j = jnp.asarray(take.numpy()), jnp.asarray(zfix.numpy())
        want_ch = jnp.asarray(ch.numpy()).at[max(mh, 0)].add(
            jnp.where(mh >= 0, take_j, 0))
        zi = jnp.clip(zfix_j, 0, Z - 1)
        dz = jnp.zeros((Z,), jnp.int64).at[zi].add(
            jnp.where((zfix_j >= 0) & (take_j > 0), take_j, 0))
        want_cz = jnp.asarray(cz.numpy()).at[max(mz, 0)].add(
            jnp.where(mz >= 0, dz, 0))
        assert np.array_equal(got_cz.numpy(), np.asarray(want_cz)), (name, g)
        assert np.array_equal(got_ch.numpy(), np.asarray(want_ch)), (name, g)
        dz_hit |= mz >= 0 and bool((np.asarray(dz) > 0).any())
        cz, ch = got_cz, got_ch
        checked += 1
    return checked, dz_hit


@pytest.mark.parametrize("name", ["config3_small", "mixed_topo_plain",
                                  "anti_slots", "two_deployments"])
def test_record_plain_matches_reference_step(name):
    checked, _ = _record_steps(name)
    assert checked


# ---------------------------------------------------------------------------
# the slice against the reference oracle
# ---------------------------------------------------------------------------

#: scenarios outside the device pour's envelope and the host reason
_HOST = {"existing_seeded": "topo_envelope",
         "anti_plus_positive": "topo_envelope",
         "min_values_zone_spread": "topo_envelope",
         "min_values_hostname_anti": "topo_envelope"}


def _pair(build):
    env_ref.reset_pod_counter()
    ref = build(_ref_env(), REF_API)
    env_port.reset_pod_counter()
    port = build(_port_env(), None)
    return ref, port


@pytest.mark.parametrize("name", examples.TOPO_SCENARIOS)
def test_scenarios_match_reference(name, both_counters):
    ref, port = _pair(lambda env, api: examples.topo_scenario(env, name,
                                                              api=api))
    solver = CUDASolver(device="cpu")
    got = solver.solve(port)
    want = CPUSolver().solve(ref)
    assert got.decision_fingerprint() == want.decision_fingerprint()
    d = solver.last_dispatch_stats
    if name in _HOST:
        assert (d["kernel"], d["reason"]) == ("host", _HOST[name])
    else:
        assert (d["kernel"], d["reason"], d["bails"]) == ("topo", None, 0)
    if name == "zone_pinned":
        by_pods = {tuple(sorted(n.pod_names)): n for n in want.new_nodes}
        for n in got.new_nodes:
            zr = n.requirements.get(L_port.ZONE)
            assert zr is not None and len(zr) == 1
            oz = by_pods[tuple(sorted(n.pod_names))].requirements.get(
                L_ref.ZONE)
            assert zr.any_value() == oz.any_value()


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_matches_reference(seed, both_counters):
    ref, port = _pair(lambda env, api: examples.topo_fuzz(env, seed,
                                                          api=api))
    got = CUDASolver(device="cpu").solve(port)
    assert got.decision_fingerprint() == \
        CPUSolver().solve(ref).decision_fingerprint()


def test_config3_reduced_matches_reference(both_counters):
    ref, port = _pair(lambda env, api: examples.config3(env, 2000,
                                                        api=api))
    solver = CUDASolver(device="cpu")
    got = solver.solve(port)
    assert got.decision_fingerprint() == \
        CPUSolver().solve(ref).decision_fingerprint()
    d = solver.last_dispatch_stats
    assert (d["kernel"], d["bails"], d["evcap"]) == ("topo", 0, 128)
    assert not got.unschedulable


def test_forced_bail_redispatches(both_counters):
    ref, port = _pair(lambda env, api: examples.topo_scenario(
        env, "config3_small", api=api))
    solver = CUDASolver(device="cpu")
    solver.TOPO_EVCAP = 1
    got = solver.solve(port)
    d = solver.last_dispatch_stats
    # the largest topology group holds 24 pods, one pool: 24 + 1 + 2 -> 32
    assert (d["kernel"], d["reason"], d["bails"], d["evcap"]) == \
        ("topo", "topo_bail", 1, 32)
    assert got.decision_fingerprint() == \
        CPUSolver().solve(ref).decision_fingerprint()


def test_group_cap_serves_host_pour(both_counters):
    ref, port = _pair(lambda env, api: examples.topo_scenario(
        env, "mixed_topo_plain", api=api))
    solver = CUDASolver(device="cpu")
    solver.dev_max_groups = 1
    got = solver.solve(port)
    assert (solver.last_dispatch_stats["kernel"],
            solver.last_dispatch_stats["reason"]) == ("host", "group_cap")
    assert got.decision_fingerprint() == \
        CPUSolver().solve(ref).decision_fingerprint()


def test_layout_past_the_pour_serves_host_pour(both_counters):
    """A snapshot whose listed counter rows the pour cannot lay out (the
    predicate forced false: the plain pour on the CPU has no layout) is
    answered by the host pour, ``reason="topo_layout"``, before any
    launch, with the reference's decisions; the predicate reads the
    padded host rows, and on the CPU the real one says the pour fits."""
    from karpenter_provider_aws_tpu_torch.ops import topo_cuda as tc
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    ref, port = _pair(lambda env, api: examples.config3(env, 600, api=api))
    solver = CUDASolver(device="cpu")
    asked = []

    def refuse(arrays, rows, stt):
        asked.append(tc.listed_max(tt.topo_rows_from_numpy(rows, "cpu")))
        return False
    real = solver._pour_fits
    solver._pour_fits = refuse
    before = dict(tc.LAUNCHES)
    got = solver.solve(port)
    d = solver.last_dispatch_stats
    assert (d["kernel"], d["reason"]) == ("host", "topo_layout")
    assert tc.LAUNCHES == before
    assert [(int(z), int(h)) for z, h in asked] == [(1, 1)]
    assert got.decision_fingerprint() == \
        CPUSolver().solve(ref).decision_fingerprint()
    solver._pour_fits = real
    solver.solve(port)
    assert solver.last_dispatch_stats["kernel"] == "topo"


def test_unsupported_topology_key_raises(both_counters):
    """A spread over a key the pour does not model no longer raises: the
    solver answers it on the CPU oracle, as the reference routes it
    (``_oracle_fallback``), before any launch."""
    def build(env, api):
        a = examples.topo_api(api)
        pods = a.make_pods(4, cpu="1", prefix="arch", topology_spread=[
            a.TopologySpreadConstraint(max_skew=1,
                                       topology_key=a.L.ARCH)])
        return env.snapshot(pods, [env.nodepool("d")])

    ref, port = _pair(build)
    solver = CUDASolver(device="cpu")
    got = solver.solve(port)
    d = solver.last_dispatch_stats
    assert (d["kernel"], d["reason"], d["topo_reason"]) == \
        ("oracle", "unsupported_topology",
         f"spread key {L_port.ARCH} unsupported")
    assert not any(d["launches"].values())
    assert got.decision_fingerprint() == \
        CPUSolver().solve(ref).decision_fingerprint()


def test_warm_ticks(both_counters):
    """The incremental solver over two warm ticks of a topology snapshot:
    the same snapshot again (a hit), then one with more pods in the
    spread groups."""
    solver = CUDASolver(device="cpu")
    for n in (400, 400, 480):
        ref, port = _pair(lambda env, api: examples.config3(env, n,
                                                            api=api))
        got = solver.solve(port)
        assert solver.last_dispatch_stats["kernel"] == "topo"
        assert got.decision_fingerprint() == \
            CPUSolver().solve(ref).decision_fingerprint()


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

def _host_pour(ffd_mod, topo_mod, enc, snap):
    tenc = topo_mod.build_topo_encoding(enc, snap, [])
    st = ffd_mod.NodeState.create(enc, 256, np.zeros((0, len(enc.dims)),
                                                     np.int64),
                                  np.zeros((0, len(enc.dims)), np.int64),
                                  np.zeros((len(enc.groups), 0), bool))
    ts = topo_mod.TopoState.create(tenc, st.Z, st.N, st.E, [])
    out = []
    for g in enc.groups:
        if tenc.has_topo[g.index]:
            out.append(topo_mod.fill_group_topo(st, enc, tenc, ts, g.index))
        else:
            take, rem = ffd_mod.fill_group_closed_form(st, enc, g.index)
            topo_mod.record_plain_fill(tenc, ts, st, g.index, take)
            out.append((take, rem))
    return tenc, out, ts


@pytest.mark.parametrize("name", ["config3_small", "two_pools_limits",
                                  "zone_plus_hostname", "anti_budget",
                                  "cross_group_zone_affinity",
                                  "anti_plus_positive", "existing_seeded"])
def test_topo_copy_matches_reference(name, both_counters):
    ref, port = _pair(lambda env, api: examples.topo_scenario(env, name,
                                                              api=api))
    t_ref, o_ref, s_ref = _host_pour(ffd_ref, topo_ref, encode_ref(ref), ref)
    t_port, o_port, s_port = _host_pour(ffd_port, topo_port,
                                        encode_port(port), port)
    for f in ("GZ", "GH", "zspread", "hspread", "zaff", "haff", "member_z",
              "member_h", "zone_needed", "has_topo", "supported", "reason",
              "gz_names", "gh_names"):
        assert getattr(t_ref, f) == getattr(t_port, f), f
    assert np.array_equal(t_ref.min_mask, t_port.min_mask)
    assert len(o_ref) == len(o_port)
    for a, b in zip(o_ref, o_port):
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
        assert a[2:] == b[2:]
    for f in ("cz", "ch", "zfix"):
        assert np.array_equal(getattr(s_ref, f), getattr(s_port, f)), f


@pytest.mark.parametrize("name", ["config3_small", "two_pools_limits",
                                  "anti_budget", "zone_skew2"])
def test_runs_from_events_matches_reference(name):
    _, rows, _, out = _jax_run(name)
    ev = {k[3:]: v for k, v in out.items() if k.startswith("ev_")}
    for g in np.nonzero(rows["has_topo"])[0]:
        assert cuda_port._runs_from_events(ev, int(g)) == \
            tpu_ref._runs_from_events(ev, int(g))
