"""The port's incremental encoder (models/delta.py ``DeltaEncoder``) and
resident-arena patch (ops/hostpack.py ``patch_inputs1``, solver/cuda.py
``_arena_for``) held against the reference package on the CPU.

One scenario is built from each package's own classes and driven
through the same mutation sequence (row churn, a count change, a new
signature, a node bind, a pool-limit change, a new node, a relabelled
node, a new pool). At every step the two encoders must agree on the
tier, the dirty frontier and fields, the counters and the (epoch,
version) token; every encoding array must equal the reference's and a
from-scratch encode; and the resident packed arena, patched in place,
must equal the reference's patched arena and a fresh pack. Tolerance:
exact (integers and booleans throughout).
"""

import types

import numpy as np
import pytest
import torch

import karpenter_provider_aws_tpu.apis.labels as L_ref
import karpenter_provider_aws_tpu.apis.resources as res_ref
import karpenter_provider_aws_tpu.fake.environment as env_ref
import karpenter_provider_aws_tpu.solver.types as types_ref
import karpenter_provider_aws_tpu_torch.apis.labels as L_port
import karpenter_provider_aws_tpu_torch.apis.resources as res_port
import karpenter_provider_aws_tpu_torch.fake.environment as env_port
import karpenter_provider_aws_tpu_torch.solver.types as types_port
from __graft_entry__ import _example_arrays
from karpenter_provider_aws_tpu.models import delta as delta_ref
from karpenter_provider_aws_tpu.models import encoding as encoding_ref
from karpenter_provider_aws_tpu.ops import hostpack as hp_ref
from karpenter_provider_aws_tpu.solver.tpu import TPUSolver
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.models import delta as delta_port
from karpenter_provider_aws_tpu_torch.models import encoding as encoding_port
from karpenter_provider_aws_tpu_torch.ops import hostpack as hp_port
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


REF = types.SimpleNamespace(L=L_ref, res=res_ref, env=env_ref,
                            types=types_ref, delta=delta_ref,
                            encoding=encoding_ref)
PORT = types.SimpleNamespace(L=L_port, res=res_port, env=env_port,
                             types=types_port, delta=delta_port,
                             encoding=encoding_port)


@pytest.fixture
def both_counters():
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()
    yield
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()


class Cluster:
    """A small cluster of one package's classes whose pod groups sort in
    build order (cpu strictly decreasing), with the mutations the
    sequence applies."""

    def __init__(self, ns):
        self.ns = ns
        self.env = ns.env.Environment()
        self.pool = self.env.nodepool("dp", limits={"cpu": "2000"})
        self.pools = [self.pool]
        self.sigs = [dict(cpu=f"{900 - 100 * i}m",
                          memory=f"{512 + 64 * i}Mi", group=f"dg{i}")
                     for i in range(6)]
        self.pods = {gi: self.mk(gi, 3) for gi in range(6)}
        self.nodes = [self.node(f"dn-{i}") for i in range(2)]

    def mk(self, gi, n=1):
        s = self.sigs[gi]
        return self.ns.env.make_pods(n, cpu=s["cpu"], memory=s["memory"],
                                     prefix=s["group"], group=s["group"])

    def node(self, name, cpu_used="500m", zone="us-west-2a"):
        L = self.ns.L
        return self.ns.types.ExistingNode(
            name=name, labels={L.ZONE: zone, L.CAPACITY_TYPE: "on-demand",
                               L.ARCH: "amd64"},
            allocatable=self.ns.res.Resources.parse(
                {"cpu": "8", "memory": "32Gi", "pods": "110"}),
            used=self.ns.res.Resources.parse({"cpu": cpu_used,
                                              "memory": "1Gi"}))

    def snapshot(self):
        flat = [p for gi in sorted(self.pods) for p in self.pods[gi]]
        return self.env.snapshot(flat, self.pools,
                                 existing_nodes=list(self.nodes))

    # -- the mutation sequence --------------------------------------------
    def churn(self):
        self.pods[3][0] = self.mk(3)[0]

    def quiet(self):
        pass

    def count(self):
        self.pods[5] = self.pods[5] + self.mk(5)

    def new_signature(self):
        self.sigs.append(dict(cpu="50m", memory="64Mi", group="dgX"))
        self.pods[6] = self.mk(6, 2)

    def bind(self):
        self.nodes[0] = self.node("dn-0", cpu_used="3")

    def pool_limit(self):
        self.pool[0].limits = self.ns.res.Resources.parse({"cpu": "900"})

    def new_node(self):
        self.nodes.append(self.node("dn-9", zone="us-west-2b"))

    def relabel(self):
        self.nodes[1] = self.node("dn-1", zone="us-west-2c")

    def new_pool(self):
        self.pools = [self.env.nodepool("dp2")]


STEPS = ("quiet", "churn", "quiet", "count", "new_signature", "churn",
         "bind", "pool_limit", "new_node", "relabel", "churn", "new_pool",
         "churn")

#: what the reference's encoder is expected to say at each step
TIERS = ("full", "rows", "hit", "rows", "groups", "rows", "rows", "rows",
         "rows", "rows", "rows", "full", "rows")


def _enc_arrays(enc):
    out = {k: v for k, v in vars(enc).items() if isinstance(v, np.ndarray)}
    for p in enc.pools:
        out[f"pool{p.index}.in_use"] = p.in_use_vec
        out[f"pool{p.index}.limit"] = (p.limit_vec if p.limit_vec is not None
                                       else np.zeros(0))
    return out


def _assert_same(a: dict, b: dict, what):
    """Every array of ``a`` (the port's) equals ``b``'s of the same name;
    the reference's encoding carries a few arrays the port does not."""
    assert set(a) <= set(b), (what, sorted(set(a) - set(b)))
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{what}: {k}")


def test_delta_encoder_and_arena_patch_match_reference(both_counters):
    ref, port = Cluster(REF), Cluster(PORT)
    ref_solver = TPUSolver(backend="numpy")
    port_solver = CUDASolver(device="cpu")
    prev_buf = None
    for step, tier in zip(STEPS, TIERS):
        getattr(ref, step)()
        getattr(port, step)()
        s_ref, s_port = ref.snapshot(), port.snapshot()
        ex_ref = sorted(s_ref.existing_nodes, key=lambda n: n.name)
        ex_port = sorted(s_port.existing_nodes, key=lambda n: n.name)
        enc_r, tabs_r, d_r = ref_solver._delta.encode(s_ref, None, ex_ref)
        enc_p, tabs_p, d_p = port_solver._delta.encode(s_port, None,
                                                       ex_port)
        assert d_r.tier == tier, step
        for f in ("tier", "reason", "dirty_frontier", "patched_rows",
                  "groups_changed", "pods_added", "pods_removed",
                  "nodes_added", "nodes_removed", "nodes_changed"):
            assert getattr(d_p, f) == getattr(d_r, f), (step, f)
        assert d_p.dirty_fields() == d_r.dirty_fields(), step
        assert port_solver._delta.state_token() == \
            ref_solver._delta.state_token(), step
        got = _enc_arrays(enc_p)
        got.update(zip(("ex_alloc", "ex_used", "ex_compat"), tabs_p))
        want = _enc_arrays(enc_r)
        want.update(zip(("ex_alloc", "ex_used", "ex_compat"), tabs_r))
        _assert_same(got, want, f"{step}: port vs reference")
        fresh = PORT.encoding.encode_snapshot(s_port)
        scratch = _enc_arrays(fresh)
        scratch.update(zip(("ex_alloc", "ex_used", "ex_compat"),
                           PORT.delta.full_existing_encode(fresh, ex_port)))
        _assert_same(got, scratch, f"{step}: delta vs from scratch")

        # the resident arena, patched (or re-packed) by each solver
        ref_solver._last_delta, port_solver._last_delta = d_r, d_p
        _, stt_r, buf_r, dirty_r = ref_solver._arena_for(enc_r, *tabs_r, 1)
        _, stt_p, buf_p, dirty_p = port_solver._arena_for(enc_p, *tabs_p)
        assert stt_p == stt_r, step
        assert dirty_p == dirty_r, step
        np.testing.assert_array_equal(buf_p, buf_r, err_msg=step)
        want_buf, _ = port_solver.pack(
            fresh, *PORT.delta.full_existing_encode(fresh, ex_port))
        np.testing.assert_array_equal(buf_p, want_buf, err_msg=step)
        if tier in ("hit", "rows") and step not in ("new_node",):
            assert buf_p is prev_buf, f"{step}: re-packed, not patched"
        prev_buf = buf_p


def test_bind_and_churn_frontiers():
    """A membership swap in group k puts the frontier at k; a node bind
    puts it at 0 (the initial carry moved); a quiet tick leaves G."""
    c = Cluster(PORT)
    denc = PORT.delta.DeltaEncoder()
    ex = lambda: sorted(c.nodes, key=lambda n: n.name)  # noqa: E731
    denc.encode(c.snapshot(), None, ex())
    for k in (4, 1, 5):
        c.pods[k][0] = c.mk(k)[0]
        _, _, d = denc.encode(c.snapshot(), None, ex())
        assert (d.tier, d.dirty_frontier) == ("rows", k)
    _, _, d = denc.encode(c.snapshot(), None, ex())
    assert (d.tier, d.dirty_frontier) == ("hit", 6)
    c.bind()
    _, _, d = denc.encode(c.snapshot(), None, ex())
    assert (d.tier, d.dirty_frontier) == ("rows", 0)
    assert d.dirty_fields() == (["ex_alloc", "ex_used0"], [])


@pytest.mark.parametrize("case", ["existing", "min_values", "priority"])
def test_patch_inputs1_matches_reference_and_fresh_pack(case):
    rng = np.random.RandomState(17)
    arrays, st = examples.example_case(case, base=_example_arrays)
    args = examples.pack_statics(st)
    fields64 = ["n", "pool_limit", "pool_used0", "ex_alloc", "ex_used0"] + \
        (["prio"] if st["Q"] else [])
    for trial in range(12):
        buf_p, bl_p = hp_port.pack_inputs1_state(arrays, *args)
        buf_r, bl_r = buf_p.copy(), bl_p.copy()
        new = {k: np.array(v) for k, v in arrays.items()}
        d64 = [f for f in fields64 if rng.rand() < 0.5 and new[f].size]
        db = ["ex_compat"] if rng.rand() < 0.5 and new["ex_compat"].size \
            else []
        for f in d64:
            new[f] = new[f] + rng.randint(0, 3, size=new[f].shape)
        for f in db:
            new[f] = rng.rand(*new[f].shape) < 0.5
        sec_p = hp_port.patch_inputs1(buf_p, bl_p, new, d64, db, *args)
        sec_r = hp_ref.patch_inputs1(buf_r, bl_r, new, d64, db, *args)
        np.testing.assert_array_equal(buf_p, buf_r)
        np.testing.assert_array_equal(buf_p, hp_port.pack_inputs1(new,
                                                                   *args))
        np.testing.assert_array_equal(bl_p, bl_r)
        assert sec_p == sec_r, trial
    assert hp_port.GROUP_MAJOR_FIELDS == hp_ref.GROUP_MAJOR_FIELDS


def test_warm_cluster_matches_reference_bench_cluster(both_counters):
    from bench import build_warm_cluster
    snap_r, tick_r = build_warm_cluster(pods=2000)
    snap_p, tick_p = examples.warm_cluster(pods=2000)
    ref_solver = TPUSolver(backend="numpy", incremental=False)
    port_solver = CUDASolver(device="cpu", incremental=False)
    for t in range(4):
        if t:
            assert tick_p(binds=t % 2 == 1) == tick_r(binds=t % 2 == 1)
        s_r, s_p = snap_r(), snap_p()
        assert [p.name for p in s_p.pods] == [p.name for p in s_r.pods]
        assert [(n.name, dict(n.used.items())) for n in s_p.existing_nodes] \
            == [(n.name, dict(n.used.items())) for n in s_r.existing_nodes]
        enc_r = encoding_ref.encode_snapshot(s_r)
        arrays, stt = ref_solver._prep_device_inputs(
            enc_r, *delta_ref.full_existing_encode(
                enc_r, sorted(s_r.existing_nodes, key=lambda n: n.name)), 1)
        want = hp_ref.pack_inputs1(arrays, stt["T"], stt["D"], stt["Z"],
                                   stt["C"], stt["G"], stt["E"], stt["P"],
                                   stt["K"], stt["M"], stt["F"], stt["Q"])
        enc_p = encoding_port.encode_snapshot(s_p)
        got, stt_p = port_solver.pack(enc_p, *delta_port.full_existing_encode(
            enc_p, sorted(s_p.existing_nodes, key=lambda n: n.name)))
        assert stt_p == stt
        assert (stt["G"], stt["E"], stt["T"], stt["Z"], stt["C"]) == \
            (32, 8, 9, 4, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"tick {t}")
