"""The port's CPU oracle (solver/cpu.py ``CPUSolver``) and the route that
sends topology the pour does not model to it, held against the reference
package on the CPU.

- The copy: the port's ``CPUSolver`` against the reference's on BASELINE
  config 3 at 400 pods and on the pipeline fuzz (decision fingerprints).
- The route: a snapshot reaching each ``supported = False`` reason of
  ``ops/topo.py`` ``build_topo_encoding`` (a zone-id requirement with
  topology, a spread key and an affinity key other than zone or
  hostname), and one reaching it only inside a relax round (a soft arch
  spread, hardened), through ``CUDASolver(device="cpu")``: the
  reference ``CPUSolver``'s fingerprint, ``kernel="oracle"`` with the
  encoding's reason, no launch, the oracle handed the round's hardened
  snapshot, and the fallback and relaxation counters equal to the
  reference ``TPUSolver(backend="numpy")``'s. A failing launch on a
  supported snapshot raises: nothing gives way to the oracle.
- ROADMAP hazard 97: a warm sequence on one incremental solver (plain,
  plain, preferences, the oracle, plain, plain with more pods,
  preferences, plain), every tick the reference oracle's fingerprint.

Tolerance: exact (decision fingerprints, counter values).
"""

import types

import pytest
import torch

import karpenter_provider_aws_tpu.apis.labels as L_ref
import karpenter_provider_aws_tpu.apis.objects as obj_ref
import karpenter_provider_aws_tpu.apis.resources as res_ref
import karpenter_provider_aws_tpu.fake.environment as env_ref
import karpenter_provider_aws_tpu.solver.types as types_ref
import karpenter_provider_aws_tpu.utils.metrics as metrics_ref
import karpenter_provider_aws_tpu_torch.apis.labels as L_port
import karpenter_provider_aws_tpu_torch.apis.objects as obj_port
import karpenter_provider_aws_tpu_torch.apis.resources as res_port
import karpenter_provider_aws_tpu_torch.fake.environment as env_port
import karpenter_provider_aws_tpu_torch.solver.types as types_port
import karpenter_provider_aws_tpu_torch.utils.metrics as metrics_port
from karpenter_provider_aws_tpu.models.encoding import \
    encode_snapshot as encode_ref
from karpenter_provider_aws_tpu.ops import topo as topo_ref
from karpenter_provider_aws_tpu.solver import CPUSolver as CPUSolver_ref
from karpenter_provider_aws_tpu.solver.tpu import TPUSolver
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
from karpenter_provider_aws_tpu_torch.solver import CPUSolver, CUDASolver

ROUNDS = "karpenter_solver_preference_relaxation_rounds_total"
FALLBACK = "karpenter_solver_oracle_fallback_total"

REF = types.SimpleNamespace(L=L_ref, obj=obj_ref, res=res_ref, env=env_ref,
                            types=types_ref)
PORT = types.SimpleNamespace(L=L_port, obj=obj_port, res=res_port,
                             env=env_port, types=types_port)
REF_API = types.SimpleNamespace(
    make_pods=env_ref.make_pods, L=L_ref, Resources=res_ref.Resources,
    TopologySpreadConstraint=obj_ref.TopologySpreadConstraint,
    PodAffinityTerm=obj_ref.PodAffinityTerm,
    ExistingNode=types_ref.ExistingNode)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the plain scans are many small tensor ops."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_ENVS: dict = {}


def _env(ns):
    key = "ref" if ns is REF else "port"
    if key not in _ENVS:
        _ENVS[key] = ns.env.Environment()
    return _ENVS[key]


def _pair(build):
    """The same scenario on each package's objects, pod names equal."""
    env_ref.reset_pod_counter()
    ref = build(REF, _env(REF))
    env_port.reset_pod_counter()
    port = build(PORT, _env(PORT))
    return ref, port


def _counters(m) -> dict:
    return {ROUNDS: m.counter(ROUNDS),
            FALLBACK: m.counter(FALLBACK,
                                {"reason": "unsupported-topology"})}


# ---------------------------------------------------------------------------
# the copy
# ---------------------------------------------------------------------------

def test_oracle_copy_matches_reference_on_config3():
    ref, port = _pair(lambda ns, env: examples.config3(
        env, 400, api=REF_API if ns is REF else None))
    assert CPUSolver().solve(port).decision_fingerprint() == \
        CPUSolver_ref().solve(ref).decision_fingerprint()


@pytest.mark.parametrize("seed", range(8))
def test_oracle_copy_matches_reference_on_fuzz(seed):
    ref, port = _pair(lambda ns, env: examples.fuzz_scenario(
        examples.pipeline_api(REF if ns is REF else None), env, seed))
    assert CPUSolver().solve(port).decision_fingerprint() == \
        CPUSolver_ref().solve(ref).decision_fingerprint()


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def _plain(ns, n):
    mk = ns.env.make_pods
    return (mk(int(n * 0.6), cpu="250m", memory="512Mi", prefix="small")
            + mk(n - int(n * 0.6), cpu="1", memory="2Gi", prefix="med"))


def _unsupported(case):
    """A snapshot that reaches one ``supported = False`` reason."""
    def build(ns, env):
        L, mk = ns.L, ns.env.make_pods
        if case == "zone_id":
            pods = mk(6, cpu="1", prefix="zid", group="zid",
                      node_selector={L.ZONE_ID: "usw2-az1"},
                      topology_spread=[ns.obj.TopologySpreadConstraint(
                          max_skew=1, topology_key=L.ZONE,
                          when_unsatisfiable="DoNotSchedule", group="zid")])
        elif case == "spread_key":
            pods = mk(6, cpu="1", prefix="arch", group="arch",
                      topology_spread=[ns.obj.TopologySpreadConstraint(
                          max_skew=1, topology_key=L.ARCH,
                          when_unsatisfiable="DoNotSchedule", group="arch")])
        else:
            pods = mk(6, cpu="1", prefix="ct", group="ct",
                      pod_affinity=[ns.obj.PodAffinityTerm(
                          topology_key=L.CAPACITY_TYPE, group="ct",
                          anti=True, required=True)])
        return env.snapshot(pods + _plain(ns, 30), [env.nodepool("o")])
    return build


def _solve_counted(solver, port, ref):
    """Solve on ``solver`` and on the reference ``TPUSolver(backend=
    "numpy")``, each with a fresh registry; both answers must be the
    reference oracle's, the counters equal. Returns (result, counters)."""
    solver.metrics = m_port = metrics_port.Metrics()
    tpu = TPUSolver(backend="numpy")
    tpu.metrics = m_ref = metrics_ref.Metrics()
    got = solver.solve(port)
    want = CPUSolver_ref().solve(ref)
    assert got.decision_fingerprint() == want.decision_fingerprint()
    assert tpu.solve(ref).decision_fingerprint() == \
        want.decision_fingerprint()
    assert _counters(m_port) == _counters(m_ref)
    return got, _counters(m_port)


@pytest.mark.parametrize("case", ["zone_id", "spread_key", "affinity_key"])
def test_unsupported_topology_routes_to_oracle(case):
    ref, port = _pair(_unsupported(case))
    tenc = topo_ref.build_topo_encoding(encode_ref(ref), ref, [])
    assert not tenc.supported
    solver = CUDASolver(device="cpu")
    before = dict(ffd_cuda.LAUNCHES)
    _, c = _solve_counted(solver, port, ref)
    assert c == {ROUNDS: 0, FALLBACK: 1}
    d = solver.last_dispatch_stats
    assert (d["kernel"], d["reason"], d["topo_reason"]) == \
        ("oracle", "unsupported_topology", tenc.reason)
    assert not any(d["launches"].values())
    assert dict(ffd_cuda.LAUNCHES) == before
    ph = solver.last_phase_stats
    assert ph["solve"] == "full" and ph["cache"] == "full"
    assert {"group_ms", "encode_ms", "kernel_ms", "decode_ms"} <= set(ph)


def test_oracle_inside_a_relax_round():
    """ROADMAP hazard 99: a soft arch spread is supported until it is
    hardened; the hardened round goes to the oracle's full ``solve`` with
    exactly that round's snapshot, its pods come back unschedulable, and
    the relaxed round runs on the device path."""
    def build(ns, env):
        pods = ns.env.make_pods(
            6, cpu="1", prefix="sarch", group="sarch",
            topology_spread=[ns.obj.TopologySpreadConstraint(
                max_skew=1, topology_key=ns.L.ARCH,
                when_unsatisfiable="ScheduleAnyway", group="sarch")])
        return env.snapshot(pods + _plain(ns, 30), [env.nodepool("o")])

    ref, port = _pair(build)
    solver = CUDASolver(device="cpu")
    handed, kinds = [], []
    oracle_solve = solver._cpu_fallback.solve
    core = solver._solve_core

    def spy_oracle(snapshot):
        handed.append(snapshot)
        return oracle_solve(snapshot)

    def spy_core(snapshot, pod_groups=None):
        res = core(snapshot, pod_groups=pod_groups)
        kinds.append((solver.last_dispatch_stats["kernel"], snapshot))
        return res

    solver._cpu_fallback.solve = spy_oracle
    solver._solve_core = spy_core
    got, c = _solve_counted(solver, port, ref)
    assert c == {ROUNDS: 1, FALLBACK: 1}
    assert [k for k, _ in kinds] == ["oracle", "ckpt"]
    assert len(handed) == 1 and handed[0] is kinds[0][1]
    arch = [p for p in handed[0].pods if p.scheduling_group == "sarch"]
    assert len(arch) == 6 and all(
        [c.when_unsatisfiable for c in p.topology_spread] == ["DoNotSchedule"]
        for p in arch)
    assert not got.unschedulable


def test_failing_launch_does_not_give_way_to_the_oracle(monkeypatch):
    """The route is decided from the encoding: a supported topology
    snapshot whose device pour fails raises, and the oracle never runs."""
    _, port = _pair(lambda ns, env: examples.topo_scenario(
        env, "zone_skew1", api=REF_API if ns is REF else None))
    solver = CUDASolver(device="cpu")

    def boom(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(solver, "_run_topo", boom)
    monkeypatch.setattr(solver._cpu_fallback, "solve",
                        lambda s: pytest.fail("the oracle ran"))
    with pytest.raises(RuntimeError, match="launch failed"):
        solver.solve(port)


# ---------------------------------------------------------------------------
# ROADMAP hazard 97: the incremental solver across relax rounds and
# oracle ticks
# ---------------------------------------------------------------------------

def _prefs(ns, env):
    """A preferred zone anti-affinity of 8 pods (4 zones): one relax
    round, every round on the pour."""
    return env.snapshot(ns.env.make_pods(
        8, cpu="1", memory="2Gi", prefix="panti", group="panti",
        pod_affinity=[ns.obj.PodAffinityTerm(
            topology_key=ns.L.ZONE, group="panti", anti=True,
            required=False)]) + _plain(ns, 30), [env.nodepool("o")])


WARM_TICKS = (("plain", 200), ("plain", 200), ("prefs", None),
              ("oracle", None), ("plain", 200), ("plain", 240),
              ("prefs", None), ("plain", 240))


def test_warm_sequence_across_relax_rounds_and_the_oracle():
    solver = CUDASolver(device="cpu")
    solver.metrics = metrics_port.Metrics()
    routes = []
    for kind, n in WARM_TICKS:
        if kind == "plain":
            ref, port = _pair(lambda ns, env: env.snapshot(
                _plain(ns, n), [env.nodepool("o")]))
        elif kind == "prefs":
            ref, port = _pair(_prefs)
        else:
            ref, port = _pair(_unsupported("spread_key"))
        got = solver.solve(port)
        assert got.decision_fingerprint() == \
            CPUSolver_ref().solve(ref).decision_fingerprint(), (kind, n)
        routes.append(solver.last_dispatch_stats["kernel"])
    assert routes[3] == "oracle" and routes[2] == routes[6] == "topo"
    assert all(r in ("ckpt", "suffix", "base")
               for r, (k, _) in zip(routes, WARM_TICKS) if k == "plain")
    assert solver.metrics.counter(ROUNDS) == 2
    assert solver.metrics.counter(
        FALLBACK, {"reason": "unsupported-topology"}) == 1
