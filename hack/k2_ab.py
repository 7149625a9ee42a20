"""Time the base group step (K2) of one checkout of the port on a card.

Runs, with the given checkout's package and this tree's ``chip_smoke.py``
(its timing helpers call only interfaces both trees have): config 2 at
50,000 pods (ten ``CUDASolver`` solves after one warm-up, then both K2
kernels at each group's entry carry, ``kernel_times``), and config 4's
subset rounds (a) (the whole-fleet round, 2,048 lanes) and (b) (the
prefix round), ten rounds each after one warm-up, every lane of the last
round held against the plain versions on the card
(``subset_rows_check``), then both K2 kernels on the lane axis at each
round's shape (``k2_lane_times``); then the striped cluster on the fused
scan (K5, whose commit runs the same ``csrc/ffd_cluster.cuh``): ten
solves after one warm-up, decisions held to the unfused solve's, one
packed solve's device ms, and both K5 kernels by branch at four
vectorized and four sequential blocks (``k5_times``, each block first
held against the plain parts by ``check_fused_blocks``), the K5 headroom
also at the batch cells' B = 8 and 64 lanes (``k5_batch_headroom_times``,
``ffd_fused_headroom B=8`` / ``B=64`` under ``striped.us``). A third
argument cuts the run to some of ``PARTS`` (``striped``: the K5 part
alone). Prints one line ``AB <tag> {json}``: microseconds a launch at
each shape, the rounds' and the striped solve's p50 and median split in
ms, config 2's p50. To compare two builds, run it on both checkouts in
one call to the card, in the order P N N P:

    for v in p n n p; do python3 hack/k2_ab.py path/to/$v $v; done
    for v in p n n p; do python3 hack/k2_ab.py path/to/$v $v striped; done
"""
import importlib.util
import json
import os
import statistics
import sys
import time

#: what a run can be cut to (a third argument, comma-separated): config 2
#: and config 4's rounds on K2, the striped cluster and batches on K5
PARTS = {"k2", "striped"}


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    spec = importlib.util.spec_from_file_location(
        "k2_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    import karpenter_provider_aws_tpu_torch as pkg
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops.hostpack import (
        in_layout_bool, in_layout_i64, layout_sizes, nwords)
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.solver.consolidation import \
        CUDAConsolidationEvaluator
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}, not "
                           f"from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    dev = torch.device("cuda")
    out = dict(card=cs.smi_line())
    parts = set(sys.argv[3].split(",")) if len(sys.argv) > 3 else PARTS
    if parts - PARTS:
        raise ValueError(f"unknown parts {sorted(parts - PARTS)}; of "
                         f"{sorted(PARTS)}")
    if "striped" in parts:
        out["striped"] = striped(cs, dev, cs.Compare())
    if "k2" not in parts:
        print("AB", tag, json.dumps(out), flush=True)
        return 0

    # config 2: solves, then both kernels at each group's entry carry
    fenv.reset_pod_counter()
    snap = cs.config2(fenv, fenv.Environment(), cs.PODS)
    solver = CUDASolver()
    solver.solve(snap)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        solver.solve(snap)
        times.append((time.perf_counter() - t0) * 1e3)
    out["config2_p50_ms"] = statistics.median(times)
    enc = encode_snapshot(snap)
    buf2, st2 = solver.pack(enc, *full_existing_encode(enc, []))
    st2 = dict(st2, n_max=solver._bucket)
    T, D, Z, C, G, E, P = (st2[k] for k in "T D Z C G E P".split())
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, 0, 0, 1,
                                       st2["Q"]))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, 0, 0, 1,
                                         st2["Q"]))
    d_buf = torch.from_numpy(buf2).to(dev)
    words = d_buf[n_i64:n_i64 + nwords(n_bits)]
    inp = ft._unpack_inputs(d_buf[:n_i64], ft._unpack_bits_ref(words, n_bits),
                            T, D, Z, C, G, E, P, 0, 0, 1, st2["Q"])
    carries, takes, lefts = [ft.carry0(inp, E + st2["n_max"], E)], [], []
    for g in range(G):
        c, take, n_rem = ft._group_step_ref(inp, carries[-1], g, E=E, P=P,
                                            V=0)
        carries.append(c)
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
    final = carries.pop()
    recs = cs.kernel_times((inp, st2, words, n_bits, carries,
                            torch.stack(takes), torch.cat(lefts), final),
                           dict.fromkeys(cs.KERNELS, 0))
    out["config2_us"] = {r["name"]: r["ms"] * 1e3 for r in recs
                         if r["name"] in ("ffd_slot_headroom",
                                          "ffd_group_commit")}
    out["config2_by_shape_us"] = by_shape(cs, inp, carries, E, P)
    del inp, carries, final, d_buf, words

    # config 4's subset rounds (a) and (b)
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
        Gq = cap[2]["gid"].shape[1]
        groups = (0,) if key == "fleet" else \
            sorted({0, Gq // 4, Gq // 2, 3 * Gq // 4})
        lane = cs.k2_lane_times(cap, groups)
        out[key] = dict(
            p50_ms=rec["p50_ms"], split=rec.get("median_split_ms"),
            lanes=lane["lanes"], groups=lane["groups"], N=lane["N"],
            shape=lane["commit_shape"],
            us={k: lane[k]["ms"] * 1e3 for k in ("ffd_slot_headroom",
                                                 "ffd_group_commit")},
            bound_us={k: lane[k]["bound_ms"][0] * 1e3
                      for k in ("ffd_slot_headroom", "ffd_group_commit")})
        del cap, sub, ev
        torch.cuda.empty_cache()
    print("AB", tag, json.dumps(out), flush=True)
    return 0


def striped(cs, dev, cmp):
    """The striped cluster (``examples.striped_cluster``, chip_smoke's
    phase 13 sizes) on the fused scan: solve p50 and median split over
    ten solves, one packed solve's device ms, the K5 kernels by branch."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    fenv.reset_pod_counter()
    snap = examples.striped_cluster(fenv.Environment(), n_pods=cs.S13_PODS,
                                    n_sigs=cs.S13_SIGS)
    solver = CUDASolver(incremental=False)
    res = solver.solve(snap)
    walls, splits = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        solver.solve(snap)
        walls.append((time.perf_counter() - t0) * 1e3)
        splits.append(dict(solver.last_phase_stats))
    ds = dict(solver.last_dispatch_stats)
    if ds["kernel"] != "fused":
        raise AssertionError(f"the striped solve ran {ds['kernel']}")
    unfused = CUDASolver(incremental=False)
    unfused.dev_fuse = 1
    if unfused.solve(snap).decision_fingerprint() != \
            res.decision_fingerprint():
        raise AssertionError("fused decisions differ from the unfused "
                             "solve's")
    enc = encode_snapshot(snap)
    buf, st = solver.pack(enc, *full_existing_encode(enc, []))
    st = dict(st, n_max=ds["slot_bucket"])
    d_buf = torch.from_numpy(buf).to(dev)
    dev_ms = cs.solve_device_ms(lambda: ft.solve_scan_packed1(
        d_buf, **examples.solve_statics(st)), reps=10)
    inp = ft._packed_inputs_ref(d_buf, *(st[k] for k in
                                         "T D Z C G E P K M Q F".split()))
    ind = ft.block_indep(inp.fuse, st["F"]).tolist()
    keep = [b for b, v in enumerate(ind) if v][:4] + \
        [b for b, v in enumerate(ind) if not v][:4]
    _, kept, cluster = cs.check_fused_blocks("striped", inp, st, cmp,
                                             keep=keep)
    _, branch = cs.k5_times((inp, st, kept),
                            (ds["fused_blocks"], ds["seq_blocks"]),
                            dict.fromkeys(cs.KERNELS, 0))
    keys = ("group_ms", "encode_ms", "kernel_ms", "decode_ms")
    return dict(p50_ms=statistics.median(walls),
                split={k: statistics.median(x[k] for x in splits)
                       for k in keys},
                device_ms=dev_ms, cluster=cluster,
                blocks=[ds["fused_blocks"], ds["seq_blocks"]],
                us={k: v["us"] for k, v in branch.items()})


def by_shape(cs, inp, carries, E, P):
    """Where the checkout's ScanState takes the K2 shapes: the headroom
    at each warps-a-row layout and the commit on each (CTAs, threads)
    shape, microseconds a launch, means over config 2's groups at their
    entry carries (None otherwise)."""
    import inspect
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    if "warps" not in inspect.signature(fc.ScanState).parameters:
        return None
    out = {}
    shapes = [dict(warps=w) for w in (1, 2, 4, 8)] + [
        dict(cluster=c, threads=t) for c, t in ((8, 512), (4, 512),
                                                 (2, 512), (1, 512),
                                                 (1, 256))]
    for kw in shapes:
        st = fc.ScanState(inp, ft.Carry(*[t.clone() for t in carries[0]]),
                          E=E, P=P, **kw)
        ms = []
        for g, cg in enumerate(carries):
            for dst, src in zip(st.carry, cg):
                dst.copy_(src)
            fc.ffd_slot_headroom(st, g)
            if "warps" in kw:
                ms.append(cs.time_launches(
                    lambda: fc.ffd_slot_headroom(st, g)))
                continue
            cand, k = st.cand.clone(), st.k.clone()

            def setup(cg=cg, cand=cand, k=k):
                for dst, src in zip(st.carry, cg):
                    dst.copy_(src)
                st.cand.copy_(cand)
                st.k.copy_(k)
            ms.append(cs.time_launches(lambda: fc.ffd_group_commit(st, g),
                                       setup=setup))
        name = ",".join(f"{k}={v}" for k, v in kw.items())
        out[name] = statistics.fmean(ms) * 1e3
    return out


if __name__ == "__main__":
    sys.exit(main())
