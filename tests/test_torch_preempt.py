"""The port's preemption slice (K8) held against the reference package on
the CPU.

- Kernel parity: the plain K8 (``scheduling/preempt_torch.py``) against
  the reference's ``preempt_solve_kernel`` (JAX on the CPU) and its numpy
  twin ``_lanes_numpy``, byte-equal int64, on the random tables of
  tests/test_preempt.py ``TestKernelTwinParity`` and on every
  ``examples.preempt_case`` hazard table (each hazard shown reached).
- The copies: ``FakeKube``, ``ClusterState``, ``pdb_state`` /
  ``take_allowance``, ``get_instance_types`` and the admission rules
  against the originals, on a seeded ``examples.preempt_cluster`` built
  in both packages.
- Planner verdicts: ``PreemptionPlanner(solver=CUDASolver(device="cpu"))``
  against the reference planner with ``backend="numpy"`` and with
  ``TPUSolver(backend="jax")``, over every gate (exhausted PDB, the PDB
  allowance, Never demand, critical and DaemonSet pods, topology demand,
  the 64-lane truncation).
- The round: ``Provisioner.reconcile`` over three rounds, the port on
  ``CUDASolver(device="cpu")`` against the reference on ``CPUSolver``.
- No fallback: without a card the dispatch raises, and the planner
  passes a dispatch error on to the caller.

Tolerance: exact (int64; decisions by name).
"""

import types

import numpy as np
import pytest
import torch

import karpenter_provider_aws_tpu.apis.labels as L_ref
import karpenter_provider_aws_tpu.apis.objects as O_ref
import karpenter_provider_aws_tpu.controllers.provisioning as prov_ref
from karpenter_provider_aws_tpu.apis import validation as val_ref
from karpenter_provider_aws_tpu.apis.requirements import \
    Requirements as Req_ref
from karpenter_provider_aws_tpu.apis.resources import Resources as Res_ref
from karpenter_provider_aws_tpu.cloudprovider.provider import \
    CloudProvider as Cloud_ref
from karpenter_provider_aws_tpu.controllers import pdb as pdb_ref
from karpenter_provider_aws_tpu.fake import kube as kube_ref
from karpenter_provider_aws_tpu.fake.environment import \
    Environment as Env_ref
from karpenter_provider_aws_tpu.scheduling import \
    PreemptionPlanner as Planner_ref
from karpenter_provider_aws_tpu.scheduling.preempt import \
    _lanes_numpy as lanes_ref
from karpenter_provider_aws_tpu.scheduling.preempt_jax import \
    preempt_solve_kernel
from karpenter_provider_aws_tpu.solver import CPUSolver
from karpenter_provider_aws_tpu.solver.tpu import TPUSolver
from karpenter_provider_aws_tpu.state.cluster import \
    ClusterState as State_ref
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.apis import validation as val_port
from karpenter_provider_aws_tpu_torch.cloudprovider.provider import \
    CloudProvider
from karpenter_provider_aws_tpu_torch.controllers import pdb as pdb_port
from karpenter_provider_aws_tpu_torch.controllers import \
    provisioning as prov_port
from karpenter_provider_aws_tpu_torch.fake import kube as kube_port
from karpenter_provider_aws_tpu_torch.scheduling import PreemptionPlanner
from karpenter_provider_aws_tpu_torch.scheduling.preempt_torch import \
    preempt_solve
from karpenter_provider_aws_tpu_torch.solver import CUDASolver
from karpenter_provider_aws_tpu_torch.state.cluster import ClusterState


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain scan is thousands of small tensor ops: one intra-op
    thread runs them fastest, and several test workers on one host then
    do not oversubscribe the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


REF = types.SimpleNamespace(O=O_ref, L=L_ref, Resources=Res_ref,
                            Requirements=Req_ref, FakeKube=kube_ref.FakeKube,
                            Environment=Env_ref)
PORT = examples.preempt_api()
#: one hydrated catalog per package, shared by every cluster built here
_ENVS = {}


def cluster(ns, n_nodes, per_node, seed, **kw):
    """``examples.preempt_cluster`` on the package's shared catalog."""
    if id(ns) not in _ENVS:
        _ENVS[id(ns)] = ns.Environment()
    return examples.preempt_cluster(ns, n_nodes, per_node, seed,
                                    env=_ENVS[id(ns)], **kw)

#: the gate scenarios: preempt_cluster keyword arguments at 24 nodes
GATES = {
    "base": dict(seed=1),
    "pdb_exhausted": dict(seed=1, pdb=0),
    "pdb_cap": dict(seed=2, pdb=1),
    "no_pdb": dict(seed=3, pdb=None, pools=2),
    "never_only": dict(seed=1, wave=0),
    "critical_everywhere": dict(seed=4, critical=1.0),
    "topology_demand": dict(seed=1, topo=True),
    "infeasible": dict(seed=1, wave_cpu=("4",)),
}


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------

def _three(tables):
    """(the reference kernel, its numpy twin, the port's plain K8)."""
    jax_out = np.asarray(preempt_solve_kernel(*tables))
    twin = lanes_ref(*tables)
    port = preempt_solve(*[torch.from_numpy(a) for a in tables]).numpy()
    return jax_out, twin, port


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_random_tables(seed):
    """The random tables of tests/test_preempt.py TestKernelTwinParity."""
    rng = np.random.RandomState(seed)
    E, D, G, B = (rng.randint(1, 6), rng.randint(1, 4),
                  rng.randint(1, 5), rng.randint(1, 9))
    tables = (rng.randint(0, 16, size=(E, D)).astype(np.int64),
              rng.randint(0, 16, size=(E, D)).astype(np.int64),
              rng.rand(G, E) < 0.7,
              rng.randint(0, 5, size=(G, D)).astype(np.int64),
              rng.randint(0, 6, size=G).astype(np.int64),
              rng.randint(0, 8, size=(B, E, D)).astype(np.int64))
    jax_out, twin, port = _three(tables)
    assert port.dtype == np.int64
    np.testing.assert_array_equal(port, jax_out)
    np.testing.assert_array_equal(port, twin)


def _reached(name, tables):
    """True iff the hazard table ``name`` reaches its hazard."""
    ex_alloc, ex_used, ex_compat, R, n, freed = tables
    used = ex_used[None] - freed
    if name == "zero_r_row":
        # k = BIG on every compatible node: the prefix wraps past 2**63
        k = np.where(ex_compat[0], 1 << 60, 0).astype(np.int64)
        with np.errstate(over="ignore"):
            cum = np.cumsum(k) - k
        return bool((R[0] == 0).all() and n[0] > 0 and (cum < 0).any())
    if name == "overcommitted":
        return bool(((ex_alloc[None] - np.maximum(used, 0)) < 0).any())
    if name == "refund_above_used":
        return bool((used < 0).any())
    if name == "n_zero":
        return bool((n == 0).any() and (n > 0).any())
    if name == "compat_nowhere":
        return bool((~ex_compat.any(axis=1)).any())
    if name == "one_lane":
        return freed.shape[0] == 1
    if name == "full_lanes":
        return freed.shape[0] == 64
    if name == "wide_e":      # the lane carry leaves shared memory
        return ex_alloc.size * 8 > 160 * 1024
    return name == "plain"


@pytest.mark.parametrize("name", examples.PREEMPT_HAZARDS)
def test_hazard_tables(name):
    for seed in (0, 1):
        tables = examples.preempt_case(name, seed)
        assert _reached(name, tables), name
        jax_out, twin, port = _three(tables)
        np.testing.assert_array_equal(port, jax_out)
        np.testing.assert_array_equal(port, twin)


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

def _kube_script(ns, kube_mod):
    """One sequence of FakeKube calls; returns what a caller observes."""
    O = ns.O
    kube = kube_mod.FakeKube(now=lambda: 5.0)
    events = kube.watch("Pod")
    seen = []
    a = kube.create(O.Pod("a", labels={"app": "x"}))
    kube.create(O.Pod("b", namespace="other"))
    kube.create(O.PriorityClass("high", value=1000))
    seen.append(a.metadata.resource_version)
    try:
        kube.create(O.Pod("a"))
    except ValueError as e:
        seen.append(str(e))
    a.node_name = "n1"
    kube.update(a)
    try:
        kube.update(a, expect_version=1)
    except kube_mod.Conflict as e:
        seen.append(str(e))
    try:
        kube.get("Pod", "zz")
    except kube_mod.NotFound as e:
        seen.append(str(e))
    a.metadata.finalizers.append("f")
    kube.delete("Pod", "a", namespace="default")
    seen.append((a.metadata.deletion_timestamp,
                 kube.try_get("Pod", "a", namespace="default") is a))
    kube.remove_finalizer(a, "f")
    seen.append(kube.try_get("Pod", "a", namespace="default"))
    seen.append([p.full_name() for p in kube.list("Pod")])
    seen.append([p.full_name() for p in kube.list("Pod", namespace="")])
    seen.append([o.metadata.name for o in kube.list("PriorityClass")])
    seen.append([p.full_name() for p in kube.list(
        "Pod", label_selector={"app": "x"})])
    while not events.empty():
        ev = events.get()
        seen.append((ev.type, ev.obj.full_name()))
    seen.append(kube._rv)
    return seen


def test_fake_kube_matches_reference():
    assert _kube_script(PORT, kube_port) == _kube_script(REF, kube_ref)


@pytest.mark.parametrize("spec", [
    dict(requirements=[{"key": L_ref.NODEPOOL, "operator": "In",
                        "values": ["x"]}]),
    dict(labels={"karpenter.sh/custom": "1"}),
    dict(requirements=[{"key": L_ref.INSTANCE_CPU, "operator": "Gt",
                        "values": ["-1"]}]),
    dict()])
def test_admission_matches_reference(spec):
    """The copied admission rules reject (with the same message) or
    accept the same NodePools."""
    out = []
    for ns, val in ((REF, val_ref), (PORT, val_port)):
        np_ = ns.O.NodePool("p", template=ns.O.NodePoolTemplate(
            node_class_ref=ns.O.NodeClassRef("c"),
            requirements=ns.Requirements.from_terms(
                spec.get("requirements", [])),
            labels=spec.get("labels", {})))
        try:
            val.validate(np_)
            out.append(None)
        except val.ValidationError as e:
            out.append(str(e))
    assert out[0] == out[1]


def _clusters(n_nodes=24, per_node=12, **kw):
    seed = kw.pop("seed", 1)
    return (cluster(REF, n_nodes, per_node, seed, **kw),
            cluster(PORT, n_nodes, per_node, seed, **kw))


def _existing_view(nodes):
    return [(n.name, sorted(n.labels.items()), sorted(n.allocatable.items()),
             sorted(n.used.items()), n.pod_groups, n.nodepool,
             n.instance_type) for n in nodes]


def test_cluster_state_matches_reference():
    ref, port = _clusters(pools=2)
    t = [0.0]
    s_ref = State_ref(ref.kube, clock=lambda: t[0])
    s_port = ClusterState(port.kube, clock=lambda: t[0])
    for s in (s_ref, s_port):
        s.nominate("default/hi-000", "node-0003")
    for _ in range(2):
        assert _existing_view(s_port.existing_nodes()) == \
            _existing_view(s_ref.existing_nodes())
        assert {k: [p.full_name() for p in v]
                for k, v in s_port.bound_pods_by_node().items()} == \
            {k: [p.full_name() for p in v]
             for k, v in s_ref.bound_pods_by_node().items()}
        assert {k: sorted(v.items())
                for k, v in s_port.nodepool_usage().items()} == \
            {k: sorted(v.items()) for k, v in s_ref.nodepool_usage().items()}
        assert [p.full_name() for p in s_port.pending_pods()] == \
            [p.full_name() for p in s_ref.pending_pods()]
        assert s_port.nomination_targets() == s_ref.nomination_targets()
        t[0] += 30.0          # past the nomination TTL


@pytest.mark.parametrize("pdb", [0, 1, 3, "50%"])
def test_pdb_matches_reference(pdb):
    ref, port = _clusters(pdb=pdb)
    st_ref, st_port = pdb_ref.pdb_state(ref.kube), \
        pdb_port.pdb_state(port.kube)
    assert [(b.metadata.name, a) for b, a in st_port] == \
        [(b.metadata.name, a) for b, a in st_ref]
    taken = []
    for p_ref, p_port in zip(ref.kube.list("Pod"), port.kube.list("Pod")):
        assert p_ref.full_name() == p_port.full_name()
        blocking = (pdb_ref.blocking_pdb(st_ref, p_ref),
                    pdb_port.blocking_pdb(st_port, p_port))
        assert (blocking[0] is None) == (blocking[1] is None)
        taken.append((pdb_ref.take_allowance(st_ref, p_ref),
                      pdb_port.take_allowance(st_port, p_port)))
    assert all(a == b for a, b in taken)
    assert any(not a for a, _ in taken), "some budget runs out"


def test_get_instance_types_matches_reference():
    ref, port = _clusters(pools=2)
    cp_ref = Cloud_ref(ref.kube, ref.env.instance_types, None)
    cp_port = CloudProvider(port.kube, port.env.instance_types)
    for np_ref, np_port in zip(ref.kube.list("NodePool"),
                               port.kube.list("NodePool")):
        a = cp_ref.get_instance_types(np_ref)
        b = cp_port.get_instance_types(np_port)
        assert [(t.name, sorted(t.allocatable().items()),
                 [(o.zone, o.capacity_type, o.price) for o in t.offerings])
                for t in b] == \
            [(t.name, sorted(t.allocatable().items()),
              [(o.zone, o.capacity_type, o.price) for o in t.offerings])
             for t in a]
    gone = port.kube.list("NodePool")[0]
    gone.template.node_class_ref.name = "missing"
    with pytest.raises(kube_port.NotFound):
        cp_port.get_instance_types(gone)


# ---------------------------------------------------------------------------
# planner verdicts and the round
# ---------------------------------------------------------------------------

def verdict_fingerprint(v):
    """tests/test_preempt.py ``verdict_fingerprint``: the decision, not
    the backend that computed it."""
    if v is None:
        return None
    return (v.feasible, v.lanes, v.leftovers,
            tuple(p.full_name() for p in v.victims),
            tuple(p.full_name() for p in v.demand),
            v.command.to_bytes() if v.command is not None else None)


class RefCloud:
    """The reference side's cloud provider: only ``get_instance_types``,
    the one method its provisioner calls."""

    def __init__(self, kube, instance_types):
        self.kube, self.instance_types = kube, instance_types

    def get_instance_types(self, nodepool):
        return self.instance_types.list(self.kube.get(
            "EC2NodeClass", nodepool.template.node_class_ref.name))


def _provisioner(side, cluster, clock):
    """(provisioner, planner) of one side: "port" (CUDASolver on the CPU
    for the solves and the planner), "numpy" or "jax" (the reference's
    CPUSolver, and its planner on that backend)."""
    kube = cluster.kube
    if side == "port":
        import itertools
        prov_port._claim_seq = itertools.count(1)
        solver = CUDASolver(device="cpu")
        planner = PreemptionPlanner(solver=solver)
        return prov_port.Provisioner(
            kube, ClusterState(kube, clock=clock),
            CloudProvider(kube, cluster.env.instance_types), solver,
            clock=clock, preempt_planner=planner), planner
    import itertools
    prov_ref._claim_seq = itertools.count(1)
    if side == "jax":
        from karpenter_provider_aws_tpu.solver.route import device_alive
        device_alive()
        planner = Planner_ref(solver=TPUSolver(backend="jax"))
    else:
        planner = Planner_ref(backend="numpy")
    return prov_ref.Provisioner(
        kube, State_ref(kube, clock=clock),
        RefCloud(kube, cluster.env.instance_types), CPUSolver(),
        clock=clock, preempt_planner=planner), planner


def _rounds(side, cluster, rounds):
    """``rounds`` reconciles; between them the nominated pods bind (the
    kube-scheduler's part) and the clock moves past the nomination TTL.
    Returns the trace of ProvisioningResult fields and the planner."""
    t = [0.0]
    prov, planner = _provisioner(side, cluster, lambda: t[0])
    trace = []
    for _ in range(rounds):
        res = prov.reconcile()
        # unschedulable by name: the reason strings are the engine's own
        # (the reference's TPUSolver words them as this port does, its
        # CPUSolver otherwise), as in the decision fingerprint
        trace.append((tuple(sorted(res.unschedulable)),
                      tuple(sorted(res.nominated.items())),
                      tuple(sorted(res.preempted.items())),
                      verdict_fingerprint(res.preempt),
                      [c.name for c in res.created_claims]))
        for name, node in sorted(res.nominated.items()):
            ns, pod = name.split("/")
            p = cluster.kube.get("Pod", pod, namespace=ns)
            p.node_name, p.phase = node, "Running"
            cluster.kube.update(p)
        t[0] += 30.0
    bound = sorted((p.full_name(), p.node_name)
                   for p in cluster.kube.list("Pod") if p.node_name)
    return trace, bound, res, planner


@pytest.mark.parametrize("gate", list(GATES))
def test_planner_verdicts_match_reference(gate):
    kw = dict(GATES[gate])
    seed = kw.pop("seed")
    out = {}
    for side in ("port", "numpy", "jax"):
        ns = PORT if side == "port" else REF
        built = cluster(ns, 24, 12, seed, **kw)
        trace, _bound, res, planner = _rounds(side, built, 1)
        out[side] = (trace, res, planner)
    assert out["port"][0] == out["numpy"][0] == out["jax"][0]
    v = out["port"][1].preempt
    assert v is not None
    victims = {p.full_name() for p in v.victims}
    # the gates, read off the port's verdict
    assert not any(n.startswith(("default/ds-", "default/crit-"))
                   for n in victims)
    if v.lanes:
        assert out["port"][2].solver.last_dispatch_stats["kernel"] in (
            "preempt", "base", "ckpt")
        assert v.backend == "device" and v.lanes == 64   # truncated
    guarded = [p for p in v.victims
               if p.metadata.labels.get("guarded") == "yes"]
    if gate == "base":
        assert v.feasible and len(v.victims) > 1 and v.leftovers[0] > 0
    elif gate == "pdb_exhausted":
        assert not guarded and v.feasible
    elif gate == "pdb_cap":
        assert len(guarded) <= 1 and v.feasible
    elif gate == "never_only":
        assert (v.feasible, v.reason) == (False, "no eligible demand")
        assert "default/nv-000" in out["port"][1].unschedulable
    elif gate == "critical_everywhere":
        assert v.feasible
    elif gate == "topology_demand":
        assert "default/tp-000" not in {p.full_name() for p in v.demand}
        assert v.demand
    elif gate == "infeasible":
        assert not v.feasible and all(x > 0 for x in v.leftovers)
        assert not out["port"][1].preempted


@pytest.mark.parametrize("seed", [1, 2])
def test_reconcile_rounds_match_reference(seed):
    port = cluster(PORT, 30, 12, seed)
    ref = cluster(REF, 30, 12, seed)
    tr_port, bound_port, _, planner = _rounds("port", port, 3)
    tr_ref, bound_ref, _, _ = _rounds("numpy", ref, 3)
    assert tr_port == tr_ref
    assert bound_port == bound_ref
    assert tr_port[0][2], "the first round preempts"
    assert not tr_port[0][4], "a preemption round mints no node"


def test_plan_records_its_split_and_dispatch():
    port = cluster(PORT, 24, 12, 1)
    t = [0.0]
    prov, planner = _provisioner("port", port, lambda: t[0])
    calls = []
    inner = planner.solver.dispatch_preempt

    def spy(**kw):
        out = inner(**kw)
        calls.append(dict(planner.solver.last_dispatch_stats))
        return out
    planner.solver.dispatch_preempt = spy
    res = prov.reconcile()
    assert res.preempt.feasible and res.preempt.backend == "device"
    assert len(calls) == 1
    rec = calls[0]
    assert (rec["kernel"], rec["batch"], rec["fuse"], rec["device"]) == \
        ("preempt", 64, 1, "cpu")
    assert set(planner.last_phase_stats) == {
        "victims_ms", "encode_ms", "freed_ms", "device_ms", "verdict_ms"}


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

def test_dispatch_without_a_card_raises(monkeypatch):
    tables = examples.preempt_case("plain", 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        from karpenter_provider_aws_tpu_torch.ops.consolidation_cuda import \
            preempt_absorb
        preempt_absorb(*[torch.from_numpy(a) for a in tables])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CUDASolver().dispatch_preempt(
            **dict(zip(("ex_alloc", "ex_used", "ex_compat", "R", "n",
                        "freed"), tables)))
    with pytest.raises(RuntimeError, match="cuda"):
        PreemptionPlanner()


def test_planner_passes_a_dispatch_error_on():
    class Failing:
        def dispatch_preempt(self, **kw):
            raise RuntimeError("CUDA kernel consol_absorb_preempt failed")

    port = cluster(PORT, 24, 12, 1)
    t = [0.0]
    prov, planner = _provisioner("port", port, lambda: t[0])
    planner.solver = Failing()
    with pytest.raises(RuntimeError, match="consol_absorb_preempt"):
        prov.reconcile()
