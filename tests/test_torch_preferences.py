"""The port's preference-relaxation wrapper (solver/preferences.py) held
against the reference package on the CPU.

The scenarios of the reference's tests/test_preferences.py
(``TestHarden``, ``TestRelaxationBehavior``,
``TestSignatureCacheIsolation``) built in both packages with the pod
counters reset: ``CUDASolver(device="cpu")`` must give the reference
``CPUSolver``'s decision fingerprint and the reference
``TPUSolver(backend="numpy")``'s, and its relaxation-round and
oracle-fallback counters must equal that solver's. BASELINE config 6 at
1,000 pods (``examples.config6`` against ``bench.build_config6``), slot
growth inside the wrapper's rounds, and the hardened clones' caches.

Tolerance: exact (decision fingerprints, counter values).
"""

import types

import pytest
import torch

import bench
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
from karpenter_provider_aws_tpu.solver import CPUSolver as CPUSolver_ref
from karpenter_provider_aws_tpu.solver import preferences as pref_ref
from karpenter_provider_aws_tpu.solver.cpu import \
    pod_group_signature as sig_ref
from karpenter_provider_aws_tpu.solver.tpu import TPUSolver
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.models.encoding import \
    canonical_pod_groups
from karpenter_provider_aws_tpu_torch.solver import CPUSolver, CUDASolver
from karpenter_provider_aws_tpu_torch.solver.cpu import (pod_group_signature,
                                                         pod_sig_digest)
from karpenter_provider_aws_tpu_torch.solver.preferences import (
    harden, preference_count)

ROUNDS = "karpenter_solver_preference_relaxation_rounds_total"
FALLBACK = "karpenter_solver_oracle_fallback_total"

REF = types.SimpleNamespace(L=L_ref, obj=obj_ref, res=res_ref, env=env_ref,
                            types=types_ref, metrics=metrics_ref)
PORT = types.SimpleNamespace(L=L_port, obj=obj_port, res=res_port,
                             env=env_port, types=types_port,
                             metrics=metrics_port)
#: examples.topo_api's namespace of the reference's objects
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


def counters(m) -> dict:
    return {ROUNDS: m.counter(ROUNDS),
            FALLBACK: m.counter(FALLBACK,
                                {"reason": "unsupported-topology"})}


def solve_both(ref, port, solver=None):
    """Solve ``port`` on ``CUDASolver(device="cpu")`` (or ``solver``) and
    ``ref`` on the reference ``CPUSolver`` and ``TPUSolver(backend=
    "numpy")``, each engine solver with a fresh metrics registry; assert
    the fingerprints and the two counters equal. Returns (solver, result,
    port counters)."""
    solver = solver or CUDASolver(device="cpu")
    solver.metrics = m_port = metrics_port.Metrics()
    tpu = TPUSolver(backend="numpy")
    tpu.metrics = m_ref = metrics_ref.Metrics()
    got = solver.solve(port)
    want = CPUSolver_ref().solve(ref)
    assert got.decision_fingerprint() == want.decision_fingerprint(), \
        f"{got.summary()} vs {want.summary()}"
    assert tpu.solve(ref).decision_fingerprint() == \
        want.decision_fingerprint()
    assert counters(m_port) == counters(m_ref)
    return solver, got, counters(m_port)


def soft_spread(ns, group):
    return ns.obj.TopologySpreadConstraint(
        max_skew=1, topology_key=ns.L.ZONE,
        when_unsatisfiable="ScheduleAnyway", group=group)


def rounds_of(solver):
    """Wrap ``solver._solve_core`` (on the instance) to record each call's
    [kernel, reason, n_max at entry], in the order the calls began: the
    relax rounds and, inside a round, a slot-growth re-solve."""
    seen = []
    core = solver._solve_core

    def wrapped(snapshot, pod_groups=None):
        rec = [None, None, solver.n_max]
        seen.append(rec)
        res = core(snapshot, pod_groups=pod_groups)
        d = solver.last_dispatch_stats
        rec[0], rec[1] = d.get("kernel"), d.get("reason")
        return res

    solver._solve_core = wrapped
    return seen


# ---------------------------------------------------------------------------
# TestHarden
# ---------------------------------------------------------------------------

def _chain_pod(ns):
    return ns.env.make_pods(
        1, cpu="1", prefix="h", group="h",
        topology_spread=[soft_spread(ns, "h")],
        pod_affinity=[ns.obj.PodAffinityTerm(
            topology_key=ns.L.HOSTNAME, group="h", anti=True,
            required=False)])[0]


def test_harden_chain_and_levels():
    ref, p = _pair(lambda ns, env: _chain_pod(ns))
    assert preference_count(p) == pref_ref.preference_count(ref) == 2
    h0 = harden(p, 0)
    assert all(a.required for a in h0.pod_affinity)
    assert all(c.when_unsatisfiable == "DoNotSchedule"
               for c in h0.topology_spread)
    h1 = harden(p, 1)   # drops the preferred affinity (first in the chain)
    assert not h1.pod_affinity and len(h1.topology_spread) == 1
    h2 = harden(p, 2)   # drops everything soft
    assert not h2.pod_affinity and not h2.topology_spread
    assert h1.full_name() == p.full_name()
    assert harden(p, 1) is h1
    for lv in range(3):
        assert pod_group_signature(harden(p, lv)) == \
            sig_ref(pref_ref.harden(ref, lv))


def test_harden_required_terms_untouched():
    p = env_port.make_pods(1, cpu="1", prefix="r", group="r", pod_affinity=[
        obj_port.PodAffinityTerm(topology_key=L_port.ZONE, group="r",
                                 required=True)])[0]
    assert preference_count(p) == 0


# ---------------------------------------------------------------------------
# TestRelaxationBehavior
# ---------------------------------------------------------------------------

def test_schedule_anyway_honored_when_possible():
    ref, port = _pair(lambda ns, env: env.snapshot(ns.env.make_pods(
        30, cpu="500m", memory="1Gi", prefix="soft", group="soft",
        topology_spread=[soft_spread(ns, "soft")]), [env.nodepool("sa")]))
    solver, got, c = solve_both(ref, port)
    assert not got.unschedulable and c[ROUNDS] == 0
    assert solver.last_dispatch_stats["kernel"] == "topo"
    zones = set()
    for n in got.new_nodes:
        zr = n.requirements.get(L_port.ZONE)
        if zr is not None:
            zones.update(zr.values)
    assert len(zones) >= 2, "soft spread should stripe zones"


def test_schedule_anyway_relaxed_when_blocking():
    ref, port = _pair(lambda ns, env: env.snapshot(ns.env.make_pods(
        12, cpu="500m", memory="1Gi", prefix="softpin", group="softpin",
        node_selector={ns.L.ZONE: "us-west-2a"},
        topology_spread=[soft_spread(ns, "softpin")]),
        [env.nodepool("sb")]))
    solver = CUDASolver(device="cpu")
    seen = rounds_of(solver)
    _, got, c = solve_both(ref, port, solver)
    assert not got.unschedulable, got.unschedulable
    # the pool's one zone is the spread's only eligible domain, so the
    # hardened spread holds: one round, on the pour
    assert c[ROUNDS] == 0 and [k for k, _, _ in seen] == ["topo"]


def _existing(ns):
    return [ns.types.ExistingNode(
        name=f"pref-node-{i}",
        labels={ns.L.ZONE: "us-west-2a", ns.L.ARCH: "amd64",
                ns.L.CAPACITY_TYPE: "on-demand",
                ns.L.INSTANCE_TYPE: "m5.xlarge"},
        allocatable=ns.res.Resources.parse(
            {"cpu": "3900m", "memory": "14Gi", "pods": "58"}),
        used=ns.res.Resources.parse({"cpu": "0", "memory": "0",
                                     "pods": "0"})) for i in range(2)]


def test_preferred_anti_affinity_relaxed_under_pressure():
    ref, port = _pair(lambda ns, env: env.snapshot(ns.env.make_pods(
        4, cpu="1", memory="2Gi", prefix="pref", group="pref",
        pod_affinity=[ns.obj.PodAffinityTerm(
            topology_key=ns.L.HOSTNAME, group="pref", anti=True,
            required=False)]), [], existing_nodes=_existing(ns)))
    solver, got, c = solve_both(ref, port)
    assert not got.unschedulable and not got.new_nodes
    assert c[ROUNDS] >= 1
    per_node: dict = {}
    for node in got.existing_assignments.values():
        per_node[node] = per_node.get(node, 0) + 1
    assert len(per_node) == 2 and max(per_node.values()) >= 2


def _mixed(ns, env):
    mk = ns.env.make_pods
    return env.snapshot(
        mk(40, cpu="500m", memory="1Gi", prefix="eqs", group="eqs",
           topology_spread=[soft_spread(ns, "eqs")])
        + mk(6, cpu="1", memory="2Gi", prefix="eqa", group="eqa",
             pod_affinity=[ns.obj.PodAffinityTerm(
                 topology_key=ns.L.HOSTNAME, group="eqa", anti=True,
                 required=False)])
        + mk(25, cpu="250m", memory="512Mi", prefix="eqp"),
        [env.nodepool("eq")])


def test_cpu_cuda_identical_on_preference_workloads():
    ref, port = _pair(_mixed)
    solver, _, _ = solve_both(ref, port)
    assert CPUSolver().solve(port).decision_fingerprint() == \
        solver.solve(port).decision_fingerprint()


# ---------------------------------------------------------------------------
# TestSignatureCacheIsolation (ROADMAP hazard 96)
# ---------------------------------------------------------------------------

SIG_CACHES = ("_sig_id", "_sig_cache", "_sig_digest", "_pref_count",
              "_hardened")


def _relaxing(ns, env):
    """8 pods of a preferred zone anti-affinity (4 zones: hardened, half
    of them cannot place, so a relax round follows) beside plain pods."""
    mk = ns.env.make_pods
    return env.snapshot(
        mk(8, cpu="1", memory="2Gi", prefix="sig", group="sig",
           pod_affinity=[ns.obj.PodAffinityTerm(
               topology_key=ns.L.ZONE, group="sig", anti=True,
               required=False)])
        + mk(20, cpu="250m", memory="512Mi", prefix="sigplain"),
        [env.nodepool("sigp")])


def test_hardened_clone_has_fresh_signature():
    """Every signature cache primed on the raw pods before the solve (the
    grouping walk's ``_sig_id``, ``_sig_cache``, ``_sig_digest``, the
    preference memo and the shared ``_hardened`` dict): the clone may
    inherit none of them, or relaxation is a no-op."""
    ref, port = _pair(_relaxing)
    canonical_pod_groups(port.pods)
    for p in port.pods:
        pod_group_signature(p)
        pod_sig_digest(p)
        preference_count(p)
    harden(port.pods[1], 0)   # the raw pod's _hardened dict now exists
    assert all(k in port.pods[1].__dict__ for k in SIG_CACHES)
    h0 = harden(port.pods[0], 0)
    assert not [k for k in SIG_CACHES if k in h0.__dict__]
    assert pod_group_signature(h0) != pod_group_signature(port.pods[0])
    assert preference_count(h0) == 0 and preference_count(port.pods[0]) == 1
    solver, got, c = solve_both(ref, port)
    assert not got.unschedulable and c[ROUNDS] >= 1
    # steady state: the cached clones serve the next solve, the same
    got2 = solver.solve(port)
    assert got2.decision_fingerprint() == got.decision_fingerprint()
    assert solver.metrics.counter(ROUNDS) == 2 * c[ROUNDS]


# ---------------------------------------------------------------------------
# config 6 and slot growth
# ---------------------------------------------------------------------------

def test_config6_builder_is_the_references():
    """``examples.config6`` on the reference's objects builds what
    ``bench.build_config6`` builds: names, signatures, the pool."""
    env_ref.reset_pod_counter()
    want = bench.build_config6(_env(REF), 1000)
    env_ref.reset_pod_counter()
    got = examples.config6(_env(REF), 1000, api=REF_API)
    assert [p.full_name() for p in got.pods] == \
        [p.full_name() for p in want.pods]
    assert [sig_ref(p) for p in got.pods] == [sig_ref(p) for p in want.pods]
    assert [s.nodepool.metadata.name for s in got.nodepools] == \
        [s.nodepool.metadata.name for s in want.nodepools]


def test_config6_reduced_matches_reference():
    ref, port = _pair(lambda ns, env: examples.config6(
        env, 1000, api=REF_API if ns is REF else None))
    solver = CUDASolver(device="cpu")
    seen = rounds_of(solver)
    _, got, c = solve_both(ref, port, solver)
    assert c[ROUNDS] >= 1 and c[FALLBACK] == 0
    assert len(seen) == c[ROUNDS] + 1
    assert {k for k, _, _ in seen} == {"topo"}
    placed = sum(len(n.pod_names) for n in got.new_nodes)
    assert placed + len(got.unschedulable) == len(port.pods)


def test_slot_growth_persists_across_relax_rounds():
    """ROADMAP hazard 98: the first round exhausts n_max = 4 and grows
    it; the next relax round starts at the grown width, and the solve's
    end restores 4."""
    ref, port = _pair(_relaxing)
    solver = CUDASolver(n_max=4, device="cpu")
    seen = rounds_of(solver)
    _, _, c = solve_both(ref, port, solver)
    rounds = int(c[ROUNDS])
    assert rounds >= 1
    entry = [n for _, _, n in seen]
    # round 1 at 4, its growth re-solve(s) wider, every later round wider
    assert len(entry) > rounds + 1
    assert entry[0] == 4 and all(n > 4 for n in entry[1:])
    assert solver.n_max == 4 and solver._bucket <= 4
