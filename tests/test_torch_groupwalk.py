"""The port's grouping walk in C (native/groupwalk.c through
native/_build.py) held against its Python loop and against the reference
package's grouping on the CPU (ROADMAP hazard 100).

- The same groups, in the same order, with the same members in the same
  order, from the C walk, from the Python loop (the extension off) and
  from the reference's ``canonical_pod_groups``, on the pipeline fuzz,
  config 2 and config 6 at small sizes.
- A cold pass (every pod a miss: intern, then walk again), a table reset
  in the middle of a grouping (``_SIG_CAP`` lowered, so the epoch bumps
  and the grouping retries), pods whose cached ``_sig_id`` holds a stale
  epoch.
- The extension is the port's own: built from the port's source into
  the port's ``_build/``, never the reference's ``native/``; a host whose
  build fails gets None and the Python loop.

Tolerance: exact (object identity of every member, signatures).
"""

import os
import types

import pytest

import karpenter_provider_aws_tpu.apis.labels as L_ref
import karpenter_provider_aws_tpu.apis.objects as obj_ref
import karpenter_provider_aws_tpu.apis.resources as res_ref
import karpenter_provider_aws_tpu.fake.environment as env_ref
import karpenter_provider_aws_tpu.models.encoding as enc_ref
import karpenter_provider_aws_tpu.solver.types as types_ref
import karpenter_provider_aws_tpu_torch.fake.environment as env_port
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.models import encoding as enc
from karpenter_provider_aws_tpu_torch.native import _build

REF = types.SimpleNamespace(L=L_ref, obj=obj_ref, res=res_ref, env=env_ref,
                            types=types_ref)
REF_API = types.SimpleNamespace(
    make_pods=env_ref.make_pods, L=L_ref, Resources=res_ref.Resources,
    TopologySpreadConstraint=obj_ref.TopologySpreadConstraint,
    PodAffinityTerm=obj_ref.PodAffinityTerm,
    ExistingNode=types_ref.ExistingNode)

_ENVS: dict = {}


def _env(key, mod):
    if key not in _ENVS:
        _ENVS[key] = mod.Environment()
    return _ENVS[key]


def _pair(build):
    env_ref.reset_pod_counter()
    ref = build(True, _env("ref", env_ref))
    env_port.reset_pod_counter()
    port = build(False, _env("port", env_port))
    return ref, port


SCENARIOS = {
    "fuzz3": lambda r, env: examples.fuzz_scenario(
        examples.pipeline_api(REF if r else None), env, 3),
    "fuzz7": lambda r, env: examples.fuzz_scenario(
        examples.pipeline_api(REF if r else None), env, 7),
    "config2": lambda r, env: examples.config2(env, 400) if not r else
    _ref_config2(env, 400),
    "config6": lambda r, env: examples.config6(
        env, 600, api=REF_API if r else None),
}


def _ref_config2(env, n):
    import bench
    return bench.build_config2(env, n)


def _shape(groups):
    """(signature, member identities) of each group, in order."""
    return [(sig, [id(p) for p in plist]) for sig, plist in groups]


def _named(groups):
    return [(sig, [p.full_name() for p in plist]) for sig, plist in groups]


@pytest.fixture
def walk():
    """The built extension (the test needs the host's C compiler, as the
    port's grouping does)."""
    gw = enc._groupwalk()
    assert gw is not None, "the grouping extension did not build"
    return gw


def _python_loop(monkeypatch, pods):
    monkeypatch.setattr(enc, "_GROUPWALK", None)
    monkeypatch.setattr(enc, "_GROUPWALK_TRIED", True)
    try:
        return enc.canonical_pod_groups(pods)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_walk_equals_python_loop_and_reference(name, walk, monkeypatch):
    ref, port = _pair(SCENARIOS[name])
    with_c = enc.canonical_pod_groups(port.pods)
    loop = _python_loop(monkeypatch, port.pods)
    assert _shape(with_c) == _shape(loop)
    assert _named(with_c) == _named(enc_ref.canonical_pod_groups(ref.pods))


class _Recorder:
    """The extension with its calls counted and their results kept."""

    def __init__(self, gw):
        self.gw, self.calls = gw, []

    def walk(self, pods, epoch):
        out = self.gw.walk(pods, epoch)
        self.calls.append((epoch, out[0] is None))
        return out


def test_cold_pass_interns_then_walks_again(walk, monkeypatch):
    _, port = _pair(SCENARIOS["config6"])
    rec = _Recorder(walk)
    monkeypatch.setattr(enc, "_GROUPWALK", rec)
    got = enc.canonical_pod_groups(port.pods)
    # cold: the first walk returns the misses, the second groups them
    assert [miss for _, miss in rec.calls] == [True, False]
    rec.calls.clear()
    again = enc.canonical_pod_groups(port.pods)
    assert [miss for _, miss in rec.calls] == [False]
    assert _shape(again) == _shape(got) == _shape(
        _python_loop(monkeypatch, port.pods))


def test_table_reset_mid_walk_retries(walk, monkeypatch):
    """The intern table fills while this snapshot's misses are interned:
    the epoch bumps mid-grouping, the ids of the first pass are void, and
    the grouping retries in the new epoch, where the snapshot fits."""
    fuzz, port = _pair(SCENARIOS["fuzz3"])[1], _pair(SCENARIOS["config6"])[1]
    enc.canonical_pod_groups(fuzz.pods)
    enc.canonical_pod_groups(port.pods)
    # fresh pod objects: config 6's signatures and three new ones
    env_port.reset_pod_counter()
    fresh = examples.config6(_env("port", env_port), 600).pods
    for k in range(3):
        fresh = env_port.make_pods(2, cpu=f"{7001 + k}m",
                                   prefix=f"new{k}") + fresh
    n_snap = len({enc.pod_group_signature(p) for p in fresh})
    # the table holds more than config 6's signatures, so interning the
    # new ones crosses a cap of exactly the snapshot's count
    assert len(enc._SIG_BY_ID) + 3 > n_snap
    epoch0 = enc._SIG_EPOCH
    monkeypatch.setattr(enc, "_SIG_CAP", n_snap)
    rec = _Recorder(walk)
    monkeypatch.setattr(enc, "_GROUPWALK", rec)
    got = enc.canonical_pod_groups(fresh)
    assert enc._SIG_EPOCH == epoch0 + 1
    epochs = [e for e, _ in rec.calls]
    assert epochs[0] == epoch0 and epochs[-1] == epoch0 + 1
    assert rec.calls[-1][1] is False   # the retry grouped in one walk
    assert len(got) == n_snap
    monkeypatch.setattr(enc, "_SIG_CAP", 1 << 16)
    assert _named(got) == _named(_python_loop(monkeypatch, fresh))


def test_stale_epoch_entries_are_misses(walk, monkeypatch):
    _, port = _pair(SCENARIOS["fuzz3"])
    want = _shape(enc.canonical_pod_groups(port.pods))
    for p in port.pods[::2]:
        e, sid = p.__dict__["_sig_id"]
        p.__dict__["_sig_id"] = (e - 1, sid)   # an older epoch's id
    by_sid, misses = walk.walk(port.pods, enc._SIG_EPOCH)
    assert by_sid is None and misses == port.pods[::2]
    rec = _Recorder(walk)
    monkeypatch.setattr(enc, "_GROUPWALK", rec)
    assert _shape(enc.canonical_pod_groups(port.pods)) == want
    assert [miss for _, miss in rec.calls] == [True, False]


def test_extension_is_the_ports_own(walk):
    path = os.path.realpath(walk.__file__)
    port_build = os.path.realpath(os.path.join(
        os.path.dirname(enc.__file__), os.pardir, "_build"))
    assert os.path.dirname(path) == port_build
    assert path == os.path.realpath(_build.ext_path("karpgroupwalk",
                                                    "groupwalk.c"))
    src = os.path.join(_build.NATIVE_DIR, "groupwalk.c")
    assert os.path.dirname(os.path.realpath(src)) == os.path.realpath(
        os.path.join(os.path.dirname(enc.__file__), os.pardir, "native"))
    ref_native = os.path.realpath(os.path.join(
        os.path.dirname(enc_ref.__file__), os.pardir, os.pardir, "native"))
    assert not path.startswith(ref_native + os.sep)


def test_failed_build_gives_the_python_loop(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "ext_path", lambda m, c: str(
        tmp_path / f"{m}.so"))
    monkeypatch.setenv("CC", "false")
    assert _build.build_ext_and_import("karpgroupwalk", "groupwalk.c") \
        is None
    assert not list(tmp_path.iterdir())
