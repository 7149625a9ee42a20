"""The warm provisioning tick of ``CUDASolver(device="cpu")`` (incremental
by default): the staleness edges of the checkpoint bank, and the
warm-cluster tick stream, every tick fingerprint-equal to the reference
package's CPU oracle on the same scenario (both pod-name counters reset,
so names agree).

A port of the reference's tests/test_incremental_solve.py staleness
tests onto the port's solver: cold full, suffix resume depth, the
structural epoch bump, version lag, a node bind (frontier 0), and the
slot-bucket shrink and regrow, with the full-solve reasons the solver
records in ``last_dispatch_stats``. The reference's host-served tick
has no counterpart here: the port has no host twin.
"""

import types

import pytest
import torch

import karpenter_provider_aws_tpu.apis.resources as res_ref
import karpenter_provider_aws_tpu.fake.environment as env_ref
import karpenter_provider_aws_tpu.solver.types as types_ref
import karpenter_provider_aws_tpu_torch.apis.resources as res_port
import karpenter_provider_aws_tpu_torch.fake.environment as env_port
import karpenter_provider_aws_tpu_torch.solver.types as types_port
from karpenter_provider_aws_tpu.solver import CPUSolver
from karpenter_provider_aws_tpu_torch import examples
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


REF = types.SimpleNamespace(res=res_ref, env=env_ref, types=types_ref)
PORT = types.SimpleNamespace(res=res_port, env=env_port, types=types_port)

_ZONE_L = "topology.kubernetes.io/zone"
_CT_L = "karpenter.sh/capacity-type"


@pytest.fixture
def both_counters():
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()
    yield
    env_ref.reset_pod_counter()
    env_port.reset_pod_counter()


class Cluster:
    """The reference test's ``_decreasing_cpu_cluster`` on one package:
    group cpu strictly decreases with the build index, so canonical
    position == index and churning group k puts the frontier at k."""

    def __init__(self, ns, n_groups, per_group, prefix):
        self.ns, self.prefix = ns, prefix
        self.env = ns.env.Environment()
        self.pool = self.env.nodepool(prefix)
        self.sigs = [dict(cpu=f"{900 - 100 * i}m",
                          memory=f"{512 + 64 * i}Mi", group=f"{prefix}g{i}")
                     for i in range(n_groups)]
        self.pods = {gi: self.mk(gi, per_group) for gi in range(n_groups)}
        self.nodes = []

    def mk(self, gi, n=1):
        s = self.sigs[gi]
        return self.ns.env.make_pods(n, cpu=s["cpu"], memory=s["memory"],
                                     prefix=s["group"], group=s["group"])

    def node(self, name, cpu_used="500m"):
        return self.ns.types.ExistingNode(
            name=name, labels={_ZONE_L: "us-east-1a", _CT_L: "on-demand"},
            allocatable=self.ns.res.Resources.parse(
                {"cpu": "8", "memory": "32Gi", "pods": "110"}),
            used=self.ns.res.Resources.parse({"cpu": cpu_used,
                                              "memory": "1Gi"}))

    def snapshot(self):
        flat = [p for gi in sorted(self.pods) for p in self.pods[gi]]
        return self.env.snapshot(flat, [self.pool],
                                 existing_nodes=list(self.nodes))


class Pair:
    """The same cluster in both packages, mutated in step; ``tick``
    solves the port's snapshot with the solver under test and checks
    its fingerprint against the reference's CPU oracle."""

    def __init__(self, **kw):
        self.ref, self.port = Cluster(REF, **kw), Cluster(PORT, **kw)
        self.solver = CUDASolver(device="cpu")

    def both(self, fn):
        fn(self.ref)
        fn(self.port)

    def churn(self, k, i=0):
        self.both(lambda c: c.pods[k].__setitem__(i, c.mk(k)[0]))

    def tick(self) -> str:
        res = self.solver.solve(self.port.snapshot())
        want = CPUSolver().solve(self.ref.snapshot())
        assert res.decision_fingerprint() == want.decision_fingerprint()
        return self.solver.last_phase_stats["solve"]

    def reason(self):
        return self.solver.last_dispatch_stats["reason"]


def test_staleness_edges_force_full_then_suffix_resumes(both_counters):
    pr = Pair(n_groups=8, per_group=4, prefix="stale")
    pr.both(lambda c: c.nodes.extend([c.node("stale-n-1"),
                                      c.node("stale-n-2")]))
    # cold adopt: a full solve records the bank
    assert pr.tick() == "full" and pr.reason() == "tier"
    assert pr.solver.last_phase_stats["cache"] == "full"
    # let the slot bucket settle (256 -> 16) before probing the edges
    for _ in range(24):
        if pr.solver._bucket == 16:
            break
        pr.churn(7)
        pr.tick()
    assert pr.solver._bucket == 16
    pr.churn(7)
    pr.tick()                       # re-record at the settled bucket

    # warm churn in a deep group -> suffix, correct resume depth
    pr.churn(6)
    mode = pr.tick()
    assert mode.startswith("suffix@"), mode
    ds = pr.solver.last_dispatch_stats
    assert ds["resume_group"] <= 6 and ds["kernel"] == "suffix"
    assert ds["suffix_groups"] == ds["suffix_bucket"] * 2

    # structural transition (a NEW signature joins): the bank must not
    # serve, and the next warm tick resumes from the re-recorded bank
    def new_sig(c):
        c.sigs.append(dict(cpu="150m", memory="128Mi", group="stalegX"))
        c.pods[8] = c.mk(8, 2)
    pr.both(new_sig)
    assert pr.tick() == "full"
    assert pr.solver.last_phase_stats["cache"] == "groups"
    pr.churn(8)
    assert pr.tick().startswith("suffix@")

    # version lag: a bank whose token trails the arena by more than the
    # current delta must not serve
    bk = pr.solver._ckpt_bank
    bk["token"] = (bk["token"][0], bk["token"][1] - 1)
    pr.churn(5, 1)
    assert pr.tick() == "full" and pr.reason() == "version_lag"
    pr.churn(7)
    assert pr.tick().startswith("suffix@")

    # an epoch behind: as if a structural rebuild went unobserved
    bk = pr.solver._ckpt_bank
    bk["token"] = (bk["token"][0] - 1, bk["token"][1])
    pr.churn(6)
    assert pr.tick() == "full" and pr.reason() == "epoch"

    # mid-stream rebind: a node's used bump dirties the initial carry
    # -> frontier 0 -> full re-record, then resume
    pr.both(lambda c: c.nodes.__setitem__(0, c.node("stale-n-1", "3")))
    assert pr.tick() == "full" and pr.reason() == "frontier"
    pr.churn(6, 1)
    assert pr.tick().startswith("suffix@")


def test_bucket_shrink_and_regrow_rebuild_bank(both_counters):
    pr = Pair(n_groups=8, per_group=2, prefix="grow")
    assert pr.tick() == "full"
    pr.churn(7)
    assert pr.tick().startswith("suffix@")

    # slot-bucket SHRINK: each step changes the shape class, so the step
    # tick re-records and the streak resumes at the narrow bucket
    for _ in range(24):
        if pr.solver._bucket == 16:
            break
        pr.churn(7)
        mode = pr.tick()
        assert mode == "full" or mode.startswith("suffix@")
    assert pr.solver._bucket == 16
    pr.churn(7)
    assert pr.tick() == "full" and pr.reason() == "bucket"
    pr.churn(7)
    assert pr.tick().startswith("suffix@")

    # slot exhaustion: a burst in the cheapest (last) group floods past
    # the narrow bucket — the suffix serves first, overflows, and the
    # grown retry lands as a bank-rebuilding full ("exhausted")
    pr.both(lambda c: c.pods.__setitem__(7, c.pods[7] + c.mk(7, 25000)))
    assert pr.tick() == "full" and pr.reason() == "exhausted"
    assert pr.solver._bucket > 16
    pr.churn(7)
    assert pr.tick().startswith("suffix@")


def test_incremental_false_runs_from_scratch(both_counters):
    pr = Pair(n_groups=4, per_group=2, prefix="off")
    pr.solver = CUDASolver(device="cpu", incremental=False)
    for _ in range(3):
        assert pr.tick() == "full"
        ds = pr.solver.last_dispatch_stats
        assert (ds["kernel"], ds["reason"]) == ("base", "disabled")
        assert "cache" not in pr.solver.last_phase_stats
        pr.churn(3)


def test_warm_cluster_ticks_match_from_scratch():
    """The warm-cluster tick stream at 2,000 pods: warm-up ticks with
    binds, then binds-free ticks served by suffix@3 from group 20, each
    fingerprint-equal to the from-scratch solve."""
    snapshot, tick = examples.warm_cluster(pods=2000)
    warm = CUDASolver(device="cpu")
    cold = CUDASolver(device="cpu", incremental=False)
    modes = []
    for t in range(16):
        tick(binds=t < 12)
        snap = snapshot()
        res = warm.solve(snap)
        assert res.decision_fingerprint() == \
            cold.solve(snap).decision_fingerprint(), t
        modes.append(warm.last_phase_stats["solve"])
    assert modes[0] == "full"
    assert modes[12:] == ["suffix@3"] * 4
    ds = warm.last_dispatch_stats
    assert (ds["resume_group"], ds["suffix_groups"], ds["groups"]) == \
        (20, 6, 32)
