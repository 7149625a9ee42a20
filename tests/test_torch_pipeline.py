"""The port's provisioning pipeline (karpenter_provider_aws_tpu_torch) held
against the reference package on the CPU: the resolved catalog, the
decisions of ``CUDASolver(device="cpu")`` against the reference's CPU
oracle (decision fingerprints, exact), the packed arena of a
config-2-shaped snapshot (bytes, exact), the import boundary and the
no-fallback device rule."""

import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

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
from karpenter_provider_aws_tpu.solver import CPUSolver
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


REF = types.SimpleNamespace(L=L_ref, obj=obj_ref, res=res_ref, env=env_ref,
                            types=types_ref)
PORT = types.SimpleNamespace(L=L_port, obj=obj_port, res=res_port,
                             env=env_port, types=types_port)


@pytest.fixture(scope="module")
def envs():
    return env_ref.Environment(), env_port.Environment()


@pytest.fixture
def both_counters():
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()
    yield
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()


def _resources(r):
    return dict(sorted(r.items()))


def test_catalog_resolves_identically(envs):
    e_ref, e_port = envs
    for alias in ("al2023@latest", "windows2022@latest"):
        a = e_ref.instance_types.list(e_ref.nodeclass(
            "cat", ami_selector_terms=(obj_ref.SelectorTerm(alias=alias),)))
        b = e_port.instance_types.list(e_port.nodeclass(
            "cat", ami_selector_terms=(obj_port.SelectorTerm(alias=alias),)))
        assert len(a) == len(b) > (800 if alias.startswith("al2023")
                                   else 400)
        for x, y in zip(a, b):
            assert x.name == y.name
            assert _resources(x.capacity) == _resources(y.capacity)
            assert _resources(x.allocatable()) == _resources(y.allocatable())
            for part in ("kube_reserved", "system_reserved",
                         "eviction_threshold"):
                assert _resources(getattr(x.overhead, part)) == \
                    _resources(getattr(y.overhead, part)), (x.name, part)
            assert [(o.capacity_type, o.zone, o.zone_id, o.price,
                     o.available) for o in x.offerings] == \
                [(o.capacity_type, o.zone, o.zone_id, o.price, o.available)
                 for o in y.offerings], x.name
            assert sorted(map(str, x.requirements)) == \
                sorted(map(str, y.requirements)), x.name


def _random_scenario(ns, env, seed):
    """tests/test_solver_equivalence.py's seeded generator, built from
    one package's classes (``ns``) so both packages see one scenario."""
    L = ns.L
    rng = random.Random(seed)
    pools = []
    for i in range(rng.randint(1, 3)):
        reqs = []
        if rng.random() < 0.4:
            reqs.append({"key": L.INSTANCE_CATEGORY, "operator": "In",
                         "values": rng.sample(["c", "m", "r", "t"], 2)})
        if rng.random() < 0.3:
            reqs.append({"key": L.CAPACITY_TYPE, "operator": "In",
                         "values": [rng.choice(["spot", "on-demand"])]})
        taints = [ns.obj.Taint("dedicated", "NoSchedule", "x")] \
            if rng.random() < 0.3 else []
        limits = {"cpu": str(rng.randint(8, 64))} \
            if rng.random() < 0.3 else None
        pools.append(env.nodepool(
            f"pool-{seed}-{i}", requirements=reqs, taints=taints,
            limits=limits, weight=rng.randint(0, 100)))
    pods = []
    for j in range(rng.randint(1, 5)):
        kw = {}
        if rng.random() < 0.4:
            kw["node_selector"] = rng.choice([
                {L.ARCH: "arm64"}, {L.ARCH: "amd64"},
                {L.ZONE: "us-west-2b"},
                {L.CAPACITY_TYPE: "spot"},
                {L.INSTANCE_SIZE: "2xlarge"},
            ])
        if rng.random() < 0.3:
            kw["tolerations"] = [ns.obj.Toleration(key="dedicated",
                                                   operator="Exists")]
        pods += ns.env.make_pods(
            rng.randint(1, 60),
            cpu=rng.choice(["100m", "250m", "500m", "1", "2", "7"]),
            memory=rng.choice(["128Mi", "1Gi", "4Gi", "30Gi"]),
            prefix=f"r{seed}-{j}", **kw)
    zones = [z.name for z in
             (env.ec2.zones if hasattr(env, "ec2") else env.zones)]
    existing = []
    for e in range(rng.randint(0, 3)):
        existing.append(ns.types.ExistingNode(
            name=f"ex-{seed}-{e}",
            labels={L.ARCH: rng.choice(["amd64", "arm64"]), L.OS: "linux",
                    L.ZONE: rng.choice(zones)},
            allocatable=ns.res.Resources.parse({
                "cpu": str(rng.randint(2, 16)),
                "memory": f"{rng.randint(4, 64)}Gi", "pods": 58})))
    return env.snapshot(pods, pools, existing_nodes=existing)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_decisions_match_oracle(envs, both_counters, seed):
    e_ref, e_port = envs
    want = CPUSolver().solve(_random_scenario(REF, e_ref, seed))
    got = CUDASolver(device="cpu").solve(_random_scenario(PORT, e_port,
                                                          seed))
    assert got.decision_fingerprint() == want.decision_fingerprint(), \
        f"{got.summary()} vs {want.summary()}"


def _config2(ns, env, n_pods):
    """bench.py build_config2: mixed pods, selectors, spot/OD, the full
    catalog under one pool."""
    L = ns.L
    n_small, n_med = int(n_pods * 0.60), int(n_pods * 0.25)
    n_spot = int(n_pods * 0.10)
    n_arm = n_pods - n_small - n_med - n_spot
    mk = ns.env.make_pods
    pods = (mk(n_small, cpu="250m", memory="512Mi", prefix="small")
            + mk(n_med, cpu="1", memory="2Gi", prefix="med")
            + mk(n_spot, cpu="2", memory="4Gi", prefix="spot",
                 node_selector={L.CAPACITY_TYPE: "spot"})
            + mk(n_arm, cpu="500m", memory="1Gi", prefix="arm",
                 node_selector={L.ARCH: "arm64"}))
    return env.snapshot(pods, [env.nodepool("bench-pool")])


def test_config2_fingerprint_and_arena(envs, both_counters):
    from karpenter_provider_aws_tpu.models.delta import \
        full_existing_encode as ref_existing
    from karpenter_provider_aws_tpu.models.encoding import \
        encode_snapshot as ref_encode
    from karpenter_provider_aws_tpu.ops.hostpack import \
        pack_inputs1 as ref_pack
    from karpenter_provider_aws_tpu.solver.tpu import TPUSolver
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    e_ref, e_port = envs
    s_ref, s_port = _config2(REF, e_ref, 2000), _config2(PORT, e_port, 2000)

    enc_r = ref_encode(s_ref)
    ex_r = ref_existing(enc_r, [])
    arrays, stt = TPUSolver(backend="numpy", incremental=False) \
        ._prep_device_inputs(enc_r, *ex_r, 1)
    assert stt["F"] == 1
    want = ref_pack(arrays, stt["T"], stt["D"], stt["Z"], stt["C"],
                    stt["G"], stt["E"], stt["P"], stt["K"], stt["M"],
                    stt["F"], stt["Q"])
    enc_p = encode_snapshot(s_port)
    solver = CUDASolver(device="cpu")
    got, stt_p = solver.pack(enc_p, *full_existing_encode(enc_p, []))
    assert stt_p == stt
    assert (stt["T"], stt["Z"], stt["C"], stt["G"], stt["P"]) == \
        (812, 4, 3, 4, 1)
    np.testing.assert_array_equal(got, want)

    res = solver.solve(s_port)
    assert res.decision_fingerprint() == \
        CPUSolver().solve(s_ref).decision_fingerprint()
    placed = sum(len(n.pod_names) for n in res.new_nodes)
    assert placed + len(res.existing_assignments) + \
        len(res.unschedulable) == 2000
    assert set(solver.last_phase_stats) == {"group_ms", "encode_ms",
                                            "kernel_ms", "decode_ms",
                                            "solve", "cache",
                                            "patched_rows"}
    assert solver.last_phase_stats["solve"] == "full"
    assert solver.last_phase_stats["cache"] == "full"
    assert solver.last_dispatch_stats["device"] == "cpu"
    assert solver.last_dispatch_stats["kernel"] == "ckpt"


def _priority_scenario(ns, env, seed):
    """Signatures spread over three PriorityClasses (one the global
    default) and a pool whose CPU limit binds, so priority decides which
    pods get the capacity; a few existing nodes. Returns the snapshot,
    its ``priority_classes`` set (Q = 1)."""
    L = ns.L
    rng = random.Random(seed)
    pcs = [ns.obj.PriorityClass("low", value=1),
           ns.obj.PriorityClass("mid", value=50, global_default=True),
           ns.obj.PriorityClass("high", value=1000)]
    pods = []
    for j in range(rng.randint(4, 8)):
        grp = ns.env.make_pods(
            rng.randint(1, 40), cpu=rng.choice(["250m", "500m", "1", "2"]),
            memory=rng.choice(["512Mi", "1Gi", "4Gi"]),
            prefix=f"q{seed}-{j}")
        cls = rng.choice(["low", "mid", "high", ""])
        for p in grp:
            p.priority_class_name = cls
        pods += grp
    ns.obj.resolve_pod_priorities(pods, pcs)
    existing = [ns.types.ExistingNode(
        name=f"qx-{seed}-{e}", labels={L.ARCH: "amd64", L.OS: "linux"},
        allocatable=ns.res.Resources.parse({
            "cpu": str(rng.randint(2, 8)), "memory": "16Gi", "pods": 58}))
        for e in range(rng.randint(0, 3))]
    snap = env.snapshot(pods, [env.nodepool(
        f"prio-{seed}", limits={"cpu": str(rng.randint(8, 40))})],
        existing_nodes=existing)
    snap.priority_classes = pcs
    return snap


@pytest.mark.parametrize("seed", range(4))
def test_priority_solve_matches_oracle(envs, both_counters, seed):
    """A solve that carries a priority section (Q = 1) on the kernels'
    plain versions, fingerprint-equal to the reference's CPUSolver."""
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    e_ref, e_port = envs
    want = CPUSolver().solve(_priority_scenario(REF, e_ref, seed))
    snap = _priority_scenario(PORT, e_port, seed)
    assert encode_snapshot(snap).prio is not None
    solver = CUDASolver(device="cpu")
    got = solver.solve(snap)
    assert got.decision_fingerprint() == want.decision_fingerprint()
    assert solver.last_dispatch_stats["kernel"] in ("ckpt", "suffix")


def test_priority_cap_routes_to_the_host_engine(envs, both_counters):
    """A priority arena past the base scan's group cap (Q > 0 and Gp >
    dev_max_groups: the pruned arena has no priority section) is solved
    by the host engine, recorded as ``priority_cap``, and still equals
    the oracle."""
    e_ref, e_port = envs
    want = CPUSolver().solve(_priority_scenario(REF, e_ref, 5))
    solver = CUDASolver(device="cpu")
    solver.dev_max_groups = 4
    got = solver.solve(_priority_scenario(PORT, e_port, 5))
    assert (solver.last_dispatch_stats["kernel"],
            solver.last_dispatch_stats["reason"]) == ("host", "priority_cap")
    assert got.decision_fingerprint() == want.decision_fingerprint()


def _config1(ns, env, n_pods):
    """bench.py build_config1: homogeneous cpu/mem pods, one pool over
    ~20 types (m5, c5, r5; large to 16xlarge)."""
    L = ns.L
    pods = ns.env.make_pods(n_pods, cpu="500m", memory="1Gi",
                            prefix="homog")
    pool = env.nodepool("bench-c1", requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "In",
         "values": ["m5", "c5", "r5"]},
        {"key": L.INSTANCE_SIZE, "operator": "In",
         "values": ["large", "xlarge", "2xlarge", "4xlarge",
                    "8xlarge", "12xlarge", "16xlarge"]}])
    return env.snapshot(pods, [pool])


def _config5(ns, env, n_pods):
    """bench.py build_config5: spot + on-demand across weighted pools,
    the on-demand pool with limits, and a fallback pool."""
    L = ns.L
    n_flex = int(n_pods * 0.7)
    mk = ns.env.make_pods
    pods = (mk(n_flex, cpu="500m", memory="1Gi", prefix="flex")
            + mk(n_pods - n_flex, cpu="1", memory="2Gi", prefix="spot5",
                 node_selector={L.CAPACITY_TYPE: "spot"}))
    spot = env.nodepool("bench-spot", weight=10, requirements=[
        {"key": L.CAPACITY_TYPE, "operator": "In", "values": ["spot"]}])
    od = env.nodepool("bench-od", weight=5, requirements=[
        {"key": L.CAPACITY_TYPE, "operator": "In", "values": ["on-demand"]}],
        limits={"cpu": "20000", "memory": "80000Gi"})
    return env.snapshot(pods, [spot, od, env.nodepool("bench-fallback")])


@pytest.mark.parametrize("config,n_pods", [(_config1, 1000),
                                           (_config5, 2000)])
def test_baseline_configs_1_and_5_match_oracle(envs, both_counters, config,
                                               n_pods):
    """BASELINE configs 1 (1,000 pods, as published) and 5 (cut from
    50,000 to 2,000 pods) on the kernels' plain versions against the
    reference's CPUSolver."""
    e_ref, e_port = envs
    want = CPUSolver().solve(config(REF, e_ref, n_pods))
    got = CUDASolver(device="cpu").solve(config(PORT, e_port, n_pods))
    assert got.decision_fingerprint() == want.decision_fingerprint()
    assert not got.unschedulable and got.new_nodes


def test_slot_growth_matches_oracle(envs, both_counters):
    """More new nodes than the slot bucket holds: the x4 bucket retry and
    the n_max growth both run and decisions still match."""
    e_ref, e_port = envs

    def snap(ns, env):
        return env.snapshot(ns.env.make_pods(40, cpu="7", memory="1Gi",
                                             prefix="big"),
                            [env.nodepool("grow", requirements=[
                                {"key": ns.L.INSTANCE_SIZE,
                                 "operator": "In", "values": ["2xlarge"]}])])
    solver = CUDASolver(n_max=4, device="cpu")
    got = solver.solve(snap(PORT, e_port))
    assert len(got.new_nodes) > 16 and solver.n_max == 4
    assert got.decision_fingerprint() == \
        CPUSolver().solve(snap(REF, e_ref)).decision_fingerprint()


def test_out_of_slice_snapshots_raise(envs, both_counters):
    """The shapes this test once saw refused are served now, each as the
    reference serves it: soft preferences through the relaxation wrapper
    (here on the topology pour), a required zone spread on the pour, a
    spread over a key the pour does not model on the CPU oracle."""
    e_ref, e_port = envs

    def pair(prefix, key, when):
        snaps = []
        for api, env in ((REF, e_ref), (PORT, e_port)):
            pods = api.env.make_pods(
                4, prefix=prefix,
                topology_spread=[api.obj.TopologySpreadConstraint(
                    max_skew=1, topology_key=getattr(api.L, key),
                    when_unsatisfiable=when, group=prefix)])
            snaps.append(env.snapshot(pods, [env.nodepool("p")]))
        return snaps

    for prefix, key, when, route in (
            ("soft", "ZONE", "ScheduleAnyway", ("topo", None)),
            ("hard", "ZONE", "DoNotSchedule", ("topo", None)),
            ("arch", "ARCH", "DoNotSchedule",
             ("oracle", "unsupported_topology"))):
        ref, port = pair(prefix, key, when)
        solver = CUDASolver(device="cpu")
        got = solver.solve(port)
        # the oracle reports the arch pods (a new node has no arch domain)
        assert bool(got.unschedulable) == (key == "ARCH")
        assert got.decision_fingerprint() == \
            CPUSolver().solve(ref).decision_fingerprint()
        assert (solver.last_dispatch_stats["kernel"],
                solver.last_dispatch_stats["reason"]) == route
    # a snapshot with no instance types is in the slice now: the host
    # engine serves it (no pools and no nodes: both pods are reported)
    empty = e_port.snapshot(env_port.make_pods(2), [])
    solver = CUDASolver(device="cpu")
    res = solver.solve(empty)
    assert not res.new_nodes and len(res.unschedulable) == 2
    assert (solver.last_dispatch_stats["kernel"],
            solver.last_dispatch_stats["reason"]) == ("host", "no_types")


def test_port_imports_no_jax():
    """The whole port and chip_smoke.py load without jax or the reference
    package (a subprocess: this test process already imported both)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import karpenter_provider_aws_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('models.delta', 'solver.incremental', 'ops.ffd_cuda',\n"
        "          'ops.hostpack', 'ops.ffd_torch', 'solver.cuda',\n"
        "          'ops.consolidation_torch', 'ops.consolidation_cuda',\n"
        "          'solver.consolidation', 'controllers.disruption',\n"
        "          'scheduling.preempt', 'scheduling.preempt_torch',\n"
        "          'controllers.provisioning', 'state.cluster',\n"
        "          'parallel.mesh', 'parallel.ranks', 'ops.mesh_cuda'):\n"
        "    assert pkg.__name__ + '.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m.split('.')[0].startswith('jax')\n"
        "       or m == 'karpenter_provider_aws_tpu'\n"
        "       or m.startswith('karpenter_provider_aws_tpu.')\n"
        "       or m == '__graft_entry__']\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules\n"
        "                 if m.startswith('karpenter_provider_aws_tpu_torch')]))\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("ok")


def test_no_cuda_raises(monkeypatch):
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch
    from karpenter_provider_aws_tpu_torch.ops.hostpack import pack_inputs1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CUDASolver()
    with pytest.raises(RuntimeError, match="cuda"):
        CUDASolver(device="cuda")
    arrays, st = examples.example_case("base")
    buf = pack_inputs1(arrays, *examples.pack_statics(st))
    with pytest.raises(RuntimeError, match="cuda"):
        ffd_torch.solve_scan_packed1(buf, **examples.solve_statics(st))
    with pytest.raises(RuntimeError, match="cuda"):
        ffd_torch.kernel_inputs_from_numpy(arrays, None)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper checks its tensors before it builds or launches: a CPU
    tensor is refused, never routed to a plain version."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda, ffd_torch
    with pytest.raises(ValueError, match="CUDA tensor"):
        ffd_cuda.unpack_bits(torch.zeros(1, dtype=torch.int64), 64)
    arrays, st = examples.example_case("base")
    inp = ffd_torch.kernel_inputs_from_numpy(arrays, "cpu")
    carry = ffd_torch.carry0(inp, st["n_max"], 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ffd_cuda.ScanState(inp, carry, E=0, P=st["P"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        ffd_cuda.pack_outputs(torch.zeros((1, 1), dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int64), carry)
    assert ffd_cuda._LIB is None
