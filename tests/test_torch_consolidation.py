"""Consolidation's batched search in the port (K7) held against the
reference package on the CPU.

- Kernel parity: the plain versions of ``ops/consolidation_torch.py``
  against the four jitted kernels of the reference's
  ``ops/consolidation_jax.py``, on seeded numpy inputs, byte for byte
  (tolerance 0: int64 and bool). The cases carry the hazards: an
  all-zero request row (the exclusive prefix of BIG headrooms wraps
  int64), over-committed nodes (negative floor quotients), dead nodes,
  padded lanes and groups, lanes that keep no type, a lane that needs
  more than the two subset slots.
- Evaluator parity: ``CUDAConsolidationEvaluator(device="cpu")`` against
  the reference ``TPUConsolidationEvaluator(backend="numpy")``.
- Subset parity: the port's subset rows against the reference kernel on
  the same arrays, and its gates against the reference ``CPUSolver``'s
  solves of the per-query snapshots.
- Decision parity: the three consolidation walks of ``examples`` on
  config 4 against the reference's sequential walk.
- Refusals, the eligibility counts, and the lane-axis carry.
"""

import random
import types

import numpy as np
import pytest
import torch

import bench
import karpenter_provider_aws_tpu.apis.labels as L_ref
import karpenter_provider_aws_tpu.apis.objects as obj_ref
import karpenter_provider_aws_tpu.apis.resources as res_ref
import karpenter_provider_aws_tpu.fake.environment as env_ref
import karpenter_provider_aws_tpu.solver.types as types_ref
import karpenter_provider_aws_tpu_torch.apis.labels as L_port
import karpenter_provider_aws_tpu_torch.apis.objects as obj_port
import karpenter_provider_aws_tpu_torch.apis.resources as res_port
import karpenter_provider_aws_tpu_torch.fake.environment as env_port
import karpenter_provider_aws_tpu_torch.solver.types as types_port
from karpenter_provider_aws_tpu.controllers.disruption import \
    DisruptionController
from karpenter_provider_aws_tpu.controllers.disruption import \
    ReplacementQuery as RefQuery
from karpenter_provider_aws_tpu.ops import consolidation_jax as cj
from karpenter_provider_aws_tpu.solver import CPUSolver
from karpenter_provider_aws_tpu.solver.consolidation import \
    TPUConsolidationEvaluator
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.controllers.disruption import \
    ReplacementQuery
from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
from karpenter_provider_aws_tpu_torch.solver import CUDASolver
from karpenter_provider_aws_tpu_torch.solver.consolidation import \
    CUDAConsolidationEvaluator


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain scan is thousands of small tensor ops: one intra-op
    thread runs them fastest, and several test workers on one host then
    do not oversubscribe the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


REF = types.SimpleNamespace(L=L_ref, obj=obj_ref, res=res_ref, env=env_ref,
                            types=types_ref, Query=RefQuery)
PORT = types.SimpleNamespace(L=L_port, obj=obj_port, res=res_port,
                             env=env_port, types=types_port,
                             Query=ReplacementQuery)
ZONES = ["us-west-2a", "us-west-2b", "us-west-2c"]
BIG = 1 << 60


@pytest.fixture
def both_counters():
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()
    yield
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()


def _jax(fn, *arrays, **kw):
    import jax.numpy as jnp
    return np.asarray(fn(*map(jnp.asarray, arrays), **kw))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# kernel parity: seeded inputs at one shape per kernel (one jit each)
# ---------------------------------------------------------------------------

HAZARDS = examples.ABSORB_HAZARDS
SUBSET_HAZARDS = examples.SUBSET_HAZARDS
_absorb_case = examples.absorb_case
_prescreen_tables = examples.prescreen_tables
_subset_case = examples.subset_case


@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_deletions_feasible_matches_jax(hazard, seed):
    a = _absorb_case(hazard, seed)
    want = _jax(cj.deletions_feasible_kernel, *a)
    got = ct.deletions_feasible(*_torch(*a)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_replacements_prescreen_matches_jax(hazard, seed):
    ex_alloc, ex_used, compat, R, gid, cid, n, alive = \
        _absorb_case(hazard, seed)
    ta, tp, tc, pa, pt, cap = _prescreen_tables(seed)
    args = (ex_alloc, ex_used, compat, R, ta, tp, tc, pa, pt, gid, cid, n,
            alive, cap)
    want = _jax(cj.replacements_prescreen_kernel, *args)
    got = ct.replacements_prescreen(*_torch(*args)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_deletions_feasible_dense_matches_jax(hazard, seed):
    """Per-lane tables gathered from the shared case."""
    args = examples.dense_case(hazard, seed)
    want = _jax(cj.deletions_feasible_dense, *args)
    got = ct.deletions_feasible_dense(*_torch(*args)).numpy()
    assert np.array_equal(got, want)


def _subset_jax(arena, tprice, lanes, st):
    a = arena
    return _jax(cj.subset_solve_kernel, a["A"], a["avail_zc"], tprice,
                a["R"], a["n"], a["F"], a["agz"], a["agc"], a["admit"],
                a["daemon"], a["ex_compat"], a["pool_types"], a["pool_agz"],
                a["pool_agc"], a["pool_limit"], a["pool_used0"],
                a["ex_alloc"], a["ex_used0"], lanes["gid"], lanes["n"],
                lanes["dead"], lanes["keep"], lanes["removed_price"], **st)


def _subset_port(arena, tprice, lanes, st):
    inp = ft.kernel_inputs_from_numpy(arena, "cpu")
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    return ct.subset_solve(inp, torch.from_numpy(tprice), t["gid"], t["n"],
                           t["dead"], t["keep"], t["removed_price"],
                           **st).numpy()


@pytest.mark.parametrize("hazard", SUBSET_HAZARDS)
def test_subset_solve_matches_jax(hazard):
    case = _subset_case(hazard, seed=SUBSET_HAZARDS.index(hazard))
    want = _subset_jax(*case)
    got = _subset_port(*case)
    assert got.shape == want.shape == (16, 5)   # every padded lane too
    assert np.array_equal(got, want)
    if hazard == "padded_lanes":
        assert not got[8:].any()                # padded lanes read 0s
    if hazard == "three_nodes":
        assert got[0, 0] > 0 and got[0, 1] == 2


def test_subset_pieces_compose():
    """The gather, the lane-stacked carry and the summary: the gather of
    a lane equals the lane's own masked inputs, carry0 over lanes stacks
    the per-lane carries, and _subset_solve_ref over lane slices equals
    it whole (the lanes are independent)."""
    arena, tprice, lanes, st = _subset_case("dead_nodes", seed=3)
    inp = ft.kernel_inputs_from_numpy(arena, "cpu")
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    g = ct._subset_gather_ref(inp, t["gid"], t["n"], t["dead"], t["keep"])
    E, N = st["E"], st["E"] + st["n_max"]
    stacked = ft.carry0(g, N, E, lanes=16)
    for b in (0, 5, 15):
        one = ct.lane_inputs(g, b)
        assert torch.equal(one.F, inp.F[t["gid"][b].long()]
                           & t["keep"][b][None, :])
        assert not one.ex_alloc[t["dead"][b]].any()
        for x, y in zip(stacked, ft.carry0(one, N, E)):
            assert torch.equal(x[b], y)
    whole = ct._subset_solve_ref(inp, torch.from_numpy(tprice), t["gid"],
                                 t["n"], t["dead"], t["keep"],
                                 t["removed_price"], **st)
    chunked = torch.cat([ct._subset_solve_ref(
        inp, torch.from_numpy(tprice),
        *(t[k][b0:b0 + 5] for k in ("gid", "n", "dead", "keep",
                                    "removed_price")), **st)
        for b0 in range(0, 16, 5)])
    assert torch.equal(whole, chunked)


# ---------------------------------------------------------------------------
# evaluator parity on the reference's consolidation scenarios
# ---------------------------------------------------------------------------

def _random_snapshot(ns, rng):
    """tests/test_consolidation_equivalence.py ``random_snapshot`` on one
    package's classes: a candidate's pods against the remaining nodes,
    no pools."""
    L = ns.L
    nodes = []
    for i in range(rng.randint(0, 6)):
        cpu_alloc = rng.choice([2000, 4000, 8000])
        mem_alloc = cpu_alloc * rng.choice([2, 4]) * 1024 ** 2
        used_frac = rng.random() * 0.9
        taints = [ns.obj.Taint("dedicated", "NoSchedule", "x")] \
            if rng.random() < 0.2 else []
        nodes.append(ns.types.ExistingNode(
            name=f"node-{i:02d}",
            labels={L.ZONE: rng.choice(ZONES),
                    L.ARCH: rng.choice(["amd64", "arm64"]),
                    L.CAPACITY_TYPE: rng.choice(["spot", "on-demand"]),
                    L.INSTANCE_TYPE: f"t{i}"},
            allocatable=ns.res.Resources({"cpu": cpu_alloc,
                                          "memory": mem_alloc, "pods": 20}),
            used=ns.res.Resources({"cpu": int(cpu_alloc * used_frac),
                                   "memory": int(mem_alloc * used_frac),
                                   "pods": rng.randint(0, 5)}),
            taints=taints))
    pods = []
    for _ in range(rng.randint(1, 4)):
        sel = {}
        if rng.random() < 0.4:
            sel[L.ZONE] = rng.choice(ZONES)
        if rng.random() < 0.3:
            sel[L.ARCH] = rng.choice(["amd64", "arm64"])
        tol = [ns.obj.Toleration(key="dedicated", operator="Exists")] \
            if rng.random() < 0.3 else []
        pods.extend(ns.env.make_pods(
            rng.randint(1, 6),
            cpu=f"{rng.choice([100, 250, 500, 1000, 2000])}m",
            memory=f"{rng.choice([128, 512, 1024, 2048])}Mi",
            prefix=f"c{rng.randint(0, 999)}",
            node_selector=sel or None, tolerations=tol))
    return ns.types.SchedulingSnapshot(pods=pods, nodepools=[],
                                       existing_nodes=nodes)


def _replacement_base(ns, rng, env):
    """tests/test_consolidation_equivalence.py ``_replacement_base`` on
    one package's classes: a live cluster and one pool over the m5, c5
    and t3 families."""
    L = ns.L
    nodes, node_pods = [], {}
    for i in range(rng.randint(2, 6)):
        sel = {}
        if rng.random() < 0.5:
            sel[L.ZONE] = rng.choice(ZONES)
        if rng.random() < 0.4:
            sel[L.ARCH] = rng.choice(["amd64", "arm64"])
        if rng.random() < 0.3:
            sel[L.INSTANCE_FAMILY] = rng.choice(["m5", "c5"])
        tol = [ns.obj.Toleration(key="dedicated", operator="Exists")] \
            if rng.random() < 0.3 else []
        pods = ns.env.make_pods(
            rng.randint(1, 4), cpu=f"{rng.choice([500, 1200, 2500])}m",
            memory=f"{rng.choice([512, 2048])}Mi", prefix=f"rb{i}",
            node_selector=sel or None, tolerations=tol)
        node_pods[i] = pods
        used_cpu = sum(p.requests["cpu"] for p in pods)
        used_mem = sum(p.requests["memory"] for p in pods)
        nodes.append(ns.types.ExistingNode(
            name=f"rb-node-{i:02d}",
            labels={L.ZONE: rng.choice(ZONES),
                    L.ARCH: rng.choice(["amd64", "arm64"]),
                    L.CAPACITY_TYPE: "on-demand"},
            allocatable=ns.res.Resources({"cpu": rng.choice([3900, 7800]),
                                          "memory": 16 * 1024 ** 3,
                                          "pods": 58}),
            used=ns.res.Resources({"cpu": used_cpu, "memory": used_mem,
                                   "pods": len(pods)}),
            taints=[ns.obj.Taint("dedicated", "NoSchedule", "x")]
            if rng.random() < 0.25 else []))
    pool = env.nodepool("rb-pool", requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "In",
         "values": ["m5", "c5", "t3"]}])
    base = env.snapshot([], [pool])
    base.existing_nodes = nodes
    return base, nodes, node_pods


@pytest.fixture(scope="module")
def envs():
    return env_ref.Environment(), env_port.Environment()


@pytest.fixture(scope="module")
def port_ev():
    return CUDAConsolidationEvaluator(device="cpu")


def test_deletions_feasible_matches_reference(both_counters, port_ev):
    """Random deletion batches (same-named nodes differ between
    snapshots: the dense path), and one cluster's per-node deletion
    checks (shared node objects: the shared path)."""
    ref_ev = TPUConsolidationEvaluator(backend="numpy")
    rr, rp = random.Random(42), random.Random(42)
    for trial in range(6):
        k = rr.randint(1, 9)
        assert rp.randint(1, 9) == k
        a = [_random_snapshot(REF, rr) for _ in range(k)]
        b = [_random_snapshot(PORT, rp) for _ in range(k)]
        assert port_ev.deletions_feasible(b) == \
            ref_ev.deletions_feasible(a), trial
    # shared node objects: each candidate's snapshot drops one node
    rr, rp = random.Random(5), random.Random(5)
    e_ref, e_port = env_ref.Environment(), env_port.Environment()
    for _ in range(3):
        base_r, nodes_r, pods_r = _replacement_base(REF, rr, e_ref)
        base_p, nodes_p, pods_p = _replacement_base(PORT, rp, e_port)
        a = [types_ref.SchedulingSnapshot(
            pods=pods_r[i], nodepools=[],
            existing_nodes=[x for x in nodes_r if x is not nd])
            for i, nd in enumerate(nodes_r)]
        b = [types_port.SchedulingSnapshot(
            pods=pods_p[i], nodepools=[],
            existing_nodes=[x for x in nodes_p if x is not nd])
            for i, nd in enumerate(nodes_p)]
        assert port_ev._evaluate_shared(b) is not None
        assert port_ev.deletions_feasible(b) == ref_ev.deletions_feasible(a)


def test_topology_deletions_match_reference(both_counters, port_ev):
    """Deletion checks whose pods carry zone spread, hostname spread or
    anti-affinity (counters seeded from the surviving nodes' pod groups):
    the port answers each through the solver's host pour, as the
    reference evaluator does."""
    ref_ev = TPUConsolidationEvaluator(backend="numpy")
    rr, rp = random.Random(11), random.Random(11)
    e_ref, e_port = env_ref.Environment(), env_port.Environment()
    for trial in range(4):
        base_r, nodes_r, _ = _replacement_base(REF, rr, e_ref)
        base_p, nodes_p, _ = _replacement_base(PORT, rp, e_port)
        snaps = []
        for ns, nodes in ((REF, nodes_r), (PORT, nodes_p)):
            L = ns.L
            for j, n in enumerate(nodes):
                n.pod_groups = ["tsp"] * ((j + trial) % 3 == 0)
            terms = [
                dict(topology_spread=[ns.obj.TopologySpreadConstraint(
                    max_skew=3, topology_key=L.ZONE,
                    when_unsatisfiable="DoNotSchedule", group="tsp")]),
                dict(topology_spread=[ns.obj.TopologySpreadConstraint(
                    max_skew=2, topology_key=L.HOSTNAME,
                    when_unsatisfiable="DoNotSchedule", group="tsp")]),
                dict(pod_affinity=[ns.obj.PodAffinityTerm(
                    topology_key=L.HOSTNAME, group="tsp", anti=True)])]
            row = []
            for i, kw in enumerate(terms):
                pods = ns.env.make_pods(1 + trial, cpu="100m",
                                        memory="128Mi", prefix=f"td{i}",
                                        group="tsp", **kw)
                row.append(ns.types.SchedulingSnapshot(
                    pods=pods, nodepools=[], zones=base_r.zones,
                    existing_nodes=[x for j, x in enumerate(nodes)
                                    if j != i % len(nodes)]))
            snaps.append(row)
        assert port_ev.deletions_feasible(snaps[1]) == \
            ref_ev.deletions_feasible(snaps[0]), trial
        assert port_ev.solver.last_dispatch_stats["kernel"] == "host"


def test_replacements_prescreen_matches_reference(both_counters, port_ev):
    ref_ev = TPUConsolidationEvaluator(backend="numpy")
    rr, rp = random.Random(7), random.Random(7)
    e_ref, e_port = env_ref.Environment(), env_port.Environment()
    seen = set()
    for trial in range(6):
        base_r, nodes_r, pods_r = _replacement_base(REF, rr, e_ref)
        base_p, nodes_p, pods_p = _replacement_base(PORT, rp, e_port)
        caps = [rr.choice([0, 40_000, 120_000, 1 << 40]) for _ in nodes_r]
        assert [rp.choice([0, 40_000, 120_000, 1 << 40])
                for _ in nodes_p] == caps
        qa = [RefQuery(pods=pods_r[i], gone={n.name}, price_cap=c)
              for i, (n, c) in enumerate(zip(nodes_r, caps))]
        qb = [ReplacementQuery(pods=pods_p[i], gone={n.name}, price_cap=c)
              for i, (n, c) in enumerate(zip(nodes_p, caps))]
        got = port_ev.replacements_prescreen(base_p, qb)
        assert got == ref_ev.replacements_prescreen(base_r, qa), trial
        seen.update(got)
    assert seen == {True, False}


def test_base_tables_drop_on_epoch_move(both_counters):
    """The catalog tables are reused while the pools' type lists are the
    same objects and dropped when the inner solver's epoch moves."""
    ev = CUDAConsolidationEvaluator(device="cpu")
    rng = random.Random(3)
    base, _nodes, _pods = _replacement_base(PORT, rng,
                                            env_port.Environment())
    t1 = ev._base_tables(base)
    assert ev._base_tables(base) is t1
    ev.solver._delta.epoch += 1
    assert ev._base_tables(base) is not t1
    assert ev.solver.arena_epoch() == (ev.solver._delta.epoch, 0)


# ---------------------------------------------------------------------------
# subset parity: rows against the reference kernel, gates against the
# reference CPU oracle
# ---------------------------------------------------------------------------

def _subset_queries(ns, rng, nodes, node_pods):
    qs = [ns.Query(pods=node_pods[i], gone={nd.name}, price_cap=0)
          for i, nd in enumerate(nodes)]
    caps = [rng.choice([40_000, 120_000, 1 << 40]) for _ in nodes]
    qs += [ns.Query(pods=node_pods[i], gone={nd.name}, price_cap=c)
           for i, (nd, c) in enumerate(zip(nodes, caps))]
    return qs


def _ref_snapshot(base, q):
    """The reference controller's simulate snapshot of one query."""
    pools = []
    if q.price_cap > 0:
        from karpenter_provider_aws_tpu.cloudprovider.types import \
            InstanceTypes
        for spec in base.nodepools:
            kept = InstanceTypes(
                [it for it in spec.instance_types
                 if (p := it.cheapest_price()) is not None
                 and p < q.price_cap])
            if kept:
                pools.append(types_ref.NodePoolSpec(
                    nodepool=spec.nodepool, instance_types=kept,
                    in_use=spec.in_use))
    return types_ref.SchedulingSnapshot(
        pods=q.pods, nodepools=pools,
        existing_nodes=[n for n in base.existing_nodes
                        if n.name not in q.gone],
        daemon_overheads=base.daemon_overheads, zones=base.zones)


def test_subset_rows_and_gates_match_reference(both_counters):
    ev = CUDAConsolidationEvaluator(device="cpu")
    captured = []
    inner = ev.solver.dispatch_subsets

    def capture(arrays, **kw):
        out = inner(arrays, **kw)
        captured.append((arrays, kw, out))
        return out
    ev.solver.dispatch_subsets = capture
    cpu = CPUSolver()
    rr, rp = random.Random(11), random.Random(11)
    e_ref, e_port = env_ref.Environment(), env_port.Environment()
    gates = set()
    for trial in range(3):
        base_r, nodes_r, pods_r = _replacement_base(REF, rr, e_ref)
        base_p, nodes_p, pods_p = _replacement_base(PORT, rp, e_port)
        qa = _subset_queries(REF, rr, nodes_r, pods_r)
        qb = _subset_queries(PORT, rp, nodes_p, pods_p)
        verdicts = ev.subset_solve(base_p, qb)
        arrays, kw, out = captured[-1]
        a = arrays
        want = _jax(cj.subset_solve_kernel, a["A"], a["avail_zc"],
                    kw["tprice"], a["R"], a["n"], a["F"], a["agz"], a["agc"],
                    a["admit"], a["daemon"], a["ex_compat"], a["pool_types"],
                    a["pool_agz"], a["pool_agc"], a["pool_limit"],
                    a["pool_used0"], a["ex_alloc"], a["ex_used0"],
                    kw["gid"], kw["n"], kw["dead"], kw["keep"],
                    kw["removed_price"], n_max=kw["n_max"], E=kw["E"],
                    P=kw["P"])
        assert np.array_equal(out, want), trial     # every padded lane
        k = len(nodes_r)
        for i, (q, v) in enumerate(zip(qa, verdicts)):
            res = cpu.solve(_ref_snapshot(base_r, q))
            if i < k:
                oracle = not res.new_nodes and not res.unschedulable
                gate = v.feasible and v.n_new == 0
            else:
                oracle = not res.unschedulable and len(res.new_nodes) == 1
                gate = v.feasible and v.n_new == 1
            assert gate == oracle, (trial, i)
            gates.add((i < k, gate))
    assert len(gates) >= 3, gates


# ---------------------------------------------------------------------------
# decision parity on config 4
# ---------------------------------------------------------------------------

def _ref_multi_controller(solver, ev, base, cands):
    """The reference controller's own ``_multi_consolidation`` and
    ``_try_prefix`` (all-spot rule included) on config 4's candidates:
    budgets, age and volume topology stubbed to pass, every simulate by
    ``solver`` on the price-filtered snapshot."""
    ctype = {n.name: n.labels.get(L_ref.CAPACITY_TYPE, "")
             for n in base.existing_nodes}
    results = {}

    def simulate(cs, price_cap):
        names = tuple(c.name for c in cs)
        results[names] = res = solver.solve(bench._c4_replacement_snapshot(
            base, ("", [p for c in cs for p in c.pods], set(names),
                   price_cap)))
        return None if res.unschedulable else res
    ctl = types.SimpleNamespace(
        _consolidatable=lambda cs: cs, _budget_allows=lambda cs, why: True,
        provisioner=types.SimpleNamespace(
            _resolve_volume_topology=lambda pods: None),
        evaluator=ev, _round_base=base, _simulate=simulate)
    ctl._try_prefix = lambda cs: DisruptionController._try_prefix(ctl, cs)
    cmd = DisruptionController._multi_consolidation(ctl, [
        types.SimpleNamespace(name=c[0], node=types.SimpleNamespace(
            name=c[0]), pods=c[1], price=c[3], capacity_type=ctype[c[0]])
        for c in cands])
    if cmd is None:
        return ("none", (), "")
    names = tuple(c.name for c in cmd.candidates)
    return ("multi", names, results[names].decision_fingerprint())


def _to_spot(base, L):
    for n in base.existing_nodes:
        n.labels = dict(n.labels, **{L.CAPACITY_TYPE: L.CAPACITY_TYPE_SPOT})


def _config4_walks(capacity):
    """The three walks on config 4 at 24 nodes against the reference;
    returns the last multi-node decision."""
    n_nodes = 24
    base_r, cands_r = bench.build_config4(env_ref.Environment(),
                                          n_nodes=n_nodes)
    base_p, cands_p = examples.config4(env_port.Environment(),
                                       n_nodes=n_nodes)
    if capacity == "spot":
        _to_spot(base_r, L_ref)
        _to_spot(base_p, L_port)
    cpu = CPUSolver()
    want = bench._c4_decide_sequential(cpu, base_r, cands_r)
    assert want[0] == "replace"
    ev = CUDAConsolidationEvaluator(device="cpu")
    assert examples.single_consolidation_device(ev, base_p, cands_p) == want
    assert ev.last_phase_stats["lanes"] == 2 * n_nodes
    assert examples.single_consolidation_batched(
        ev, CUDASolver(device="cpu"), base_p, cands_p) == want
    # each candidate's pods are a signature of their own, so a prefix of
    # k candidates scans k groups: short prefixes keep the plain scans
    # small (unreplaceable only, then replaceable only)
    ref_ev = TPUConsolidationEvaluator(backend="numpy")
    for sl in (slice(0, 5), slice(n_nodes - 8, None)):
        got = examples.multi_consolidation(ev, ev.solver, base_p,
                                           cands_p[sl])
        assert got == _ref_multi_controller(cpu, ref_ev, base_r,
                                            cands_r[sl])
    assert ev.fallbacks == {}
    return got


def test_config4_decisions_match_reference(both_counters):
    got = _config4_walks("on-demand")
    assert got[0] == "multi" and len(got[1]) >= 2


def test_config4_all_spot_prefix_matches_reference(both_counters):
    """Every node spot: the multi-node prefixes meet the all-spot rule
    (no spot replacement for a merged prefix), which turns down the
    replaceable prefix that the on-demand fleet merges."""
    assert _config4_walks("spot") == ("none", (), "")


# ---------------------------------------------------------------------------
# refusals and eligibility
# ---------------------------------------------------------------------------

def test_refusals_and_eligibility_counts(both_counters, monkeypatch):
    L = L_port
    ev = CUDAConsolidationEvaluator(device="cpu")
    e = env_port.Environment()
    rng = random.Random(2)
    base, nodes, node_pods = _replacement_base(PORT, rng, e)
    spread = env_port.make_pods(3, prefix="tsc", topology_spread=[
        obj_port.TopologySpreadConstraint(
            max_skew=1, topology_key=L.ZONE,
            when_unsatisfiable="DoNotSchedule", group="tsc")])
    topo = types_port.SchedulingSnapshot(pods=spread, nodepools=[],
                                         existing_nodes=nodes)
    # a topology deletion check is answered, on the host pour (no types)
    assert [type(x) for x in ev.deletions_feasible([topo])] == [bool]
    assert (ev.solver.last_dispatch_stats["kernel"],
            ev.solver.last_dispatch_stats["reason"]) == ("host", "no_types")
    q = ReplacementQuery(pods=spread, gone=set(), price_cap=0)
    assert ev.replacements_prescreen(base, [q]) == [True]
    assert ev.subset_solve(base, [q]) is None
    assert ev.subset_solve(base, [ReplacementQuery(
        pods=[], gone=set(), price_cap=0)]) is None
    # a soft spread is a preference, but any spread term leaves the
    # lanes as "topology" first, as in the reference
    soft = env_port.make_pods(2, prefix="soft", topology_spread=[
        obj_port.TopologySpreadConstraint(
            max_skew=1, topology_key=L.ZONE,
            when_unsatisfiable="ScheduleAnyway", group="soft")])
    assert ev.subset_solve(base, [ReplacementQuery(
        pods=soft, gone=set(), price_cap=0)]) is None
    plain = ReplacementQuery(pods=node_pods[0], gone=set(), price_cap=0)
    nopools = types_port.SchedulingSnapshot(pods=[], nodepools=[],
                                            existing_nodes=nodes,
                                            zones=base.zones)
    assert ev.subset_solve(nopools, [plain]) is None
    mv = e.snapshot([], [e.nodepool("mv", requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "Exists", "minValues": 2}])])
    mv.existing_nodes = nodes
    assert ev.subset_solve(mv, [plain]) is None
    monkeypatch.setattr(ev.solver, "dev_max_groups", 0)
    assert ev.subset_solve(base, [plain]) is None
    assert ev.fallbacks == {"topology": 2, "no_pods": 1, "no_types": 1,
                            "minvalues": 1, "group_cap": 1}
    assert ev.deletions_feasible([]) == [] and \
        ev.replacements_prescreen(base, []) == [] and \
        ev.subset_solve(base, []) == []


def test_no_card_raises_and_wrappers_refuse_cpu(monkeypatch):
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    z = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc.consol_absorb("deletions", ex_alloc=z, ex_used0=z,
                         compat=z.bool(), R=z, n=z,
                         gid=z.int(), cid=z.int(), alive=z.bool())
    arena, tprice, lanes, st = _subset_case("plain", 0)
    inp = ft.kernel_inputs_from_numpy(arena, "cpu")
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc.subset_gather(inp, t["gid"], t["n"], t["dead"], t["keep"])
    g = ct._subset_gather_ref(inp, t["gid"], t["n"], t["dead"], t["keep"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        ffd_cuda.ScanState(g, ft.carry0(g, st["E"] + 2, st["E"], lanes=16),
                           E=st["E"], P=st["P"], lanes=16)
    assert ffd_cuda._LIB is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CUDAConsolidationEvaluator()
