"""Time the consolidation gather (K7d ``subset_gather``) of one checkout
of the port on a card.

Runs, with the given checkout's package and this tree's ``chip_smoke.py``
(its helpers call only interfaces both trees have): BASELINE config 4's
subset rounds (a) (the whole-fleet round, 2,048 lanes, one group a lane)
and (b) (the prefix round, 128 lanes of 128 groups) through
``CUDAConsolidationEvaluator()``, ten rounds each after one warm-up (p50
and median split in ms), every lane of the last round held against the
plain versions on the card (``chip_smoke.subset_rows_check``), then the
gather on that round's inputs (``chip_smoke.gather_times``: µs a launch
by CUDA events, the plain gather's, and the bound from the bytes it must
move) and the round's device ms (``chip_smoke.solve_device_ms`` of one
``subset_solve``: gather, the K2 pairs, summary). Prints one line ``AB
<tag> {json}``. To compare two builds, run it on both checkouts in one
call to the card, in the order P N N P:

    for v in p n n p; do python3 hack/k7_ab.py path/to/$v $v; done
"""
import importlib.util
import json
import os
import sys


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    spec = importlib.util.spec_from_file_location(
        "k7_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    import karpenter_provider_aws_tpu_torch as pkg
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.solver.consolidation import \
        CUDAConsolidationEvaluator
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}, not "
                           f"from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    dev = torch.device("cuda")
    out = dict(card=cs.smi_line())
    fenv.reset_pod_counter()
    base, cands = examples.config4(fenv.Environment(), n_nodes=cs.C4_FLEET)
    pre = cands[:cs.C4_PREFIX]
    rounds = dict(
        fleet=lambda ev: examples.single_consolidation_device(
            ev, base, cands, examples.consolidation_queries(cands)),
        prefix=lambda ev: examples.multi_consolidation(
            ev, ev.solver, base, pre, examples.prefix_queries(pre)))
    cmp = cs.Compare()
    for key, fn in rounds.items():
        ev = CUDAConsolidationEvaluator()
        sub = cs.Captured(ev.solver, "dispatch_subsets")
        _, rec = cs.drive(key, lambda: fn(ev), cs.C4_ROUNDS,
                          split=lambda: dict(ev.last_phase_stats))
        sub.restore()
        _, cap = cs.subset_rows_check(key, sub, cmp, dev)
        arena, tp, t, kw = cap
        ms, pms, nbytes = cs.gather_times(cap)
        dev_ms = cs.solve_device_ms(lambda: ct.subset_solve(
            arena, tp, t["gid"], t["n"], t["dead"], t["keep"],
            t["removed_price"], n_max=kw["n_max"], E=kw["E"], P=kw["P"]),
            reps=5)
        out[key] = dict(
            p50_ms=rec["p50_ms"], split=rec.get("median_split_ms"),
            lanes=list(t["gid"].shape), E=kw["E"],
            gather_us=ms * 1e3, gather_plain_us=pms * 1e3,
            gather_bound_us=cs.bound_ms(nbytes, 0)[0] * 1e3,
            gather_bytes=nbytes, round_device_ms=dev_ms,
            launches_per_round=rec["launches_per_round"])
        del cap, sub, ev, arena, t
        torch.cuda.empty_cache()
    print("AB", tag, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
