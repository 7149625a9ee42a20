"""Time the absorption scan (``consol_absorb``: K7a-c and K8) of one
checkout of the port on a card.

With the given checkout's package and this tree's ``chip_smoke.py``
helpers, it reads, each by ``chip_smoke.time_launches`` (READINGS
readings of 20 calls, each beside the host's enqueue of its timed calls,
``k1_ab.watch_drain``: where the enqueue outlasts the sleep before them,
the queue drained and the reading is left out of the medians):

- K8 at the preemption round's own tables (64 lanes, 1,000 nodes, D = 6,
  G = 2) and at the wide waves' (``chip_smoke.P12_WIDE_G``: G = 16, 64,
  256), from ``chip_smoke.preempt_phase``, which also gives the
  ``PreemptionPlanner.plan`` p50 and the ``Provisioner.reconcile`` p50
  (and each reconcile's wall); each held to the plain version first;
- the three K7 modes at BASELINE config 4's round (c) (the deletion check
  and the pre-screen at 200 nodes) and round (d) (the same deletions as a
  dense batch), on the inputs captured from the evaluator's own calls,
  each held to the plain version first, and the rounds' p50
  (``chip_smoke.drive``);
- K8 on synthetic tables of 64 lanes of 2,048 nodes (G = 256), past
  what a thread keeps in registers (the redesigned scan's shared-memory
  form).

Prints one line ``AB <tag> {json}``. To compare two builds, run it on
both checkouts in one call to the card, in the order P N N P:

    for v in p n n p; do python3 hack/k7_k8_ab.py path/to/$v $v; done
"""
import copy
import importlib.util
import json
import os
import statistics
import sys

#: ``time_launches`` readings of each timed launch
READINGS = 5
#: nodes of the synthetic K8 tables past a thread's registers (8 rows a
#: thread on a CTA of 256)
WIDE_E = 2048


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    cs = _load("k7k8_smoke", os.path.join(here, "chip_smoke.py"))
    k1 = _load("k7k8_k1", os.path.join(here, "hack", "k1_ab.py"))

    import torch
    import karpenter_provider_aws_tpu_torch as pkg
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}, not "
                           f"from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    redesigned = hasattr(cc, "absorb_form")
    pt = fc.build_info()["ptxas"].splitlines()
    drain = k1.watch_drain(cs)
    out = dict(card=cs.smi_line(), redesigned=redesigned,
               sleep_ms=drain["sleep_ms"],
               ptxas=[" ".join(x.strip() for x in pt[i:i + 3])
                      for i, line in enumerate(pt)
                      if "Compiling entry" in line
                      and "consol_absorb" in line])

    def reads(fn, reps=20):
        """READINGS readings of ``fn``: the median µs of those whose
        enqueue fit in the sleep, and every (µs, enqueue ms)."""
        r = []
        for _ in range(READINGS):
            cs.time_launches(fn, reps=reps)
            r.append(drain["readings"][-1])
        kept = [us for us, enq in r if enq < drain["sleep_ms"]]
        return dict(us=statistics.median(kept) if kept else None,
                    kept=len(kept), readings=r)

    out["preempt"] = preempt(cs, reads)
    out["preempt_wide_e"] = wide_e(reads)
    out["k7"] = k7_rounds(cs, reads)
    out["readings_kept_rule"] = "enqueue ms < sleep_ms"
    print("AB", tag, json.dumps(out), flush=True)
    return 0


def preempt(cs, reads):
    """K8 at the round's and the wide waves' tables; the plan's and the
    reconcile's p50."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch as pt
    _, summary, tables, wide = cs.preempt_phase(cs.Compare())
    out = dict(plan_p50_ms=summary["plan"]["p50_ms"],
               plan_split_ms=summary["plan"]["median_split_ms"],
               reconcile_p50_ms=summary["reconcile_p50_ms"],
               reconcile_ms=summary["reconcile_ms"])
    for g, t in [(int(tables[3].shape[0]), tables)] + sorted(wide.items()):
        if not torch.equal(cc.preempt_absorb(*t),
                           pt._preempt_solve_ref(*t)):
            raise AssertionError(f"K8 at G = {g} != plain")
        B, E, D = t[5].shape
        out[f"G{g}"] = dict(B=B, E=E, D=D, **reads(
            lambda t=t: cc.preempt_absorb(*t)))
    return out


def wide_e(reads):
    """K8 on synthetic tables past one CTA's registers: 64 lanes of
    WIDE_E nodes (D = 6, G = 256; ``examples.preempt_case``), held to the
    plain version first."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch as pt
    t = [torch.from_numpy(a).to("cuda") for a in examples.preempt_case(
        "plain", 4, E=WIDE_E, G=256, D=6, B=64)]
    if not torch.equal(cc.preempt_absorb(*t), pt._preempt_solve_ref(*t)):
        raise AssertionError(f"K8 at E = {WIDE_E} != plain")
    return dict(B=64, E=WIDE_E, D=6, G=256,
                **reads(lambda: cc.preempt_absorb(*t)))


def k7_rounds(cs, reads):
    """Round (c)'s deletions and pre-screen, round (d)'s dense batch: the
    captured calls timed, the rounds' p50."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.solver.consolidation import \
        CUDAConsolidationEvaluator
    fenv.reset_pod_counter()
    base, cands = examples.config4(fenv.Environment(),
                                   n_nodes=cs.C4_BATCHED)
    ev, solver = CUDAConsolidationEvaluator(), CUDASolver()
    dl = cs.Captured(ct, "deletions_feasible")
    rp = cs.Captured(ct, "replacements_prescreen")
    _, rec_c = cs.drive("batched", lambda: examples.single_consolidation_batched(
        ev, solver, base, cands), cs.C4_ROUNDS)
    dl.restore()
    rp.restore()
    snaps = [examples.deletion_snapshot(base, c) for c in cands]
    for s_ in snaps:
        s_.existing_nodes = [copy.copy(n) for n in s_.existing_nodes]
    dn = cs.Captured(ct, "deletions_feasible_dense")
    _, rec_d = cs.drive("dense", lambda: ev.deletions_feasible(snaps),
                        cs.C4_DENSE_ROUNDS)
    dn.restore()
    out = dict(round_c_p50_ms=rec_c["p50_ms"], round_d_p50_ms=rec_d["p50_ms"],
               round_c_launches=rec_c["launches_per_round"],
               round_d_launches=rec_d["launches_per_round"])
    for mode, cap, ref in (
            ("deletions", dl, ct._deletions_feasible_ref),
            ("prescreen", rp, ct._replacements_prescreen_ref),
            ("dense", dn, ct._deletions_feasible_dense_ref)):
        kw = cap.last[1]
        if not torch.equal(cc.consol_absorb(mode, **_absorb_kw(mode, kw)),
                           ref(**kw)):
            raise AssertionError(f"{mode} != plain")
        B, G = kw["n"].shape
        out[mode] = dict(B=B, G=G, E=kw["ex_alloc"].shape[-2],
                         D=kw["ex_alloc"].shape[-1], **reads(
                             lambda mode=mode, kw=kw: cc.consol_absorb(
                                 mode, **_absorb_kw(mode, kw))))
    return out


def _absorb_kw(mode, kw):
    """A captured dispatch call's kwargs as ``consol_absorb``'s."""
    m = dict(kw)
    m["compat"] = m.pop("ex_compat" if mode == "dense" else "compat_tab")
    if mode != "dense":
        m["R"] = m.pop("R_tab")
    return m


if __name__ == "__main__":
    sys.exit(main())
