"""Time the launches that carry K3's pad re-stamp and K7d's summary rows,
of one checkout of the port on a card.

A checkout either re-stamps a suffix's pad rows with ``ffd_bank_store``
before its ``pack_outputs`` and writes a subset round's rows with
``subset_summary`` after its last ``ffd_group_commit`` (the separate
kernels), or folds both into those launches (``pack_outputs(...,
store=)``, ``ffd_group_commit(..., summary=)``). With the given
checkout's package and this tree's ``chip_smoke.py`` helpers, it reads,
each by ``chip_smoke.time_launches`` (READINGS readings of 20 calls,
each beside the host's enqueue of its timed calls, ``k1_ab.watch_drain``:
where the enqueue outlasts the sleep before them, the queue drained):

- at the 50,000-pod warm arena's suffix (SUF = 3, its pad rows): the
  pack alone, and the pack with the re-stamp (folded) or
  ``ffd_bank_store`` alone and then the pack (separate), the output and
  the rows checked against the plain pack and store first;
- at BASELINE config 4's subset rounds (a) (the whole-fleet round, 2,048
  lanes, one group) and (b) (the prefix round, 128 lanes of 128 groups):
  the last commit alone from the scan's state at its headroom, and the
  commit with the rows (folded) or ``subset_summary`` alone and the commit
  then the summary (separate), the rows checked against the plain
  summary first; each round's p50 over ten rounds after a warm-up (every
  lane of the last held to the plain versions) and its device ms
  (``chip_smoke.solve_device_ms`` of one ``subset_solve``);
- the warm phase (``chip_smoke.warm_tick_phase``: 60 suffix ticks, p50,
  launches a tick), the warm arena's device ms a suffix re-solve
  (``chip_smoke.warm_solve_times``) and the host's enqueue of one
  (``k3_k9_ab.suffix_enqueue_ms``).

Prints one line ``AB <tag> {json}``. To compare two builds, run it on
both checkouts in one call to the card, in the order P N N P:

    for v in p n n p; do python3 hack/k3_k7_ab.py path/to/$v $v; done

A third argument, a comma-separated subset of ``warm``, ``rounds`` and
``phase``, runs only those parts.
"""
import importlib.util
import json
import os
import sys

#: ``time_launches`` readings of each timed launch
READINGS = 5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    parts = sys.argv[3].split(",") if len(sys.argv) > 3 else (
        "warm", "rounds", "phase")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    cs = _load("k3k7_smoke", os.path.join(here, "chip_smoke.py"))
    k1 = _load("k3k7_k1", os.path.join(here, "hack", "k1_ab.py"))

    import torch
    import karpenter_provider_aws_tpu_torch as pkg
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}, not "
                           f"from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    folded = not hasattr(fc, "ffd_bank_store")
    pt = fc.build_info()["ptxas"].splitlines()
    drain = k1.watch_drain(cs)
    out = dict(card=cs.smi_line(), folded=folded,
               sleep_ms=drain["sleep_ms"],
               ptxas=[" ".join(x.strip() for x in pt[i:i + 3])
                      for i, line in enumerate(pt)
                      if "Compiling entry" in line and any(
                          k in line for k in ("pack_outputs",
                                              "ffd_group_commit",
                                              "bank_copy",
                                              "subset_summary"))])

    def reads(fn, setup=None, reps=50):
        """READINGS readings of ``fn``: [(µs, enqueue ms)]."""
        r = []
        for _ in range(READINGS):
            cs.time_launches(fn, reps=reps, setup=setup)
            r.append(drain["readings"][-1])
        return r

    if "warm" in parts:
        out.update(warm_pack(cs, reads, folded))
    if "rounds" in parts:
        out.update(subset_rounds(cs, reads, folded))
    if "phase" in parts:
        launches, summary = cs.warm_tick_phase()
        out["warm_phase"] = dict(
            p50_ms=summary["p50_ms"], p99_ms=summary["p99_ms"],
            modes=summary["modes"],
            launches_per_tick=summary["launches_per_tick"])
    out["readings_kept_rule"] = "enqueue ms < sleep_ms"
    print("AB", tag, json.dumps(out), flush=True)
    return 0


def warm_pack(cs, reads, folded):
    """The warm arena's suffix: its pack, and the re-stamp of its pad
    rows; the suffix's device ms and the host's enqueue of one."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.solver.incremental import \
        live_bound
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    k3k9 = _load("k3k7_k3k9", os.path.join(here, "hack", "k3_k9_ab.py"))
    dev = torch.device("cuda")
    out = {}
    wsnap, _ = examples.warm_cluster(pods=cs.WARM_PODS,
                                     pending_frac=cs.WARM_PENDING)
    wsnap = wsnap()
    enc = encode_snapshot(wsnap)
    bufw, stw = CUDASolver(incremental=False).pack(
        enc, *full_existing_encode(enc, sorted(
            wsnap.existing_nodes, key=lambda n: n.name)))
    stw = dict(stw, n_max=16)
    glw = live_bound(bufw, T=stw["T"], D=stw["D"], G=stw["G"], CK=cs.CK)
    dw = torch.from_numpy(bufw).to(dev)
    _, bank = ft.solve_scan_packed1_ckpt(dw, CK=cs.CK,
                                         **examples.solve_statics(stw))
    inp = ft._packed_inputs_ref(dw, *(stw[k] for k in
                                      "T D Z C G E P K M Q".split()))
    NC, SUF = stw["G"] // cs.CK, min(3, glw // cs.CK)
    tk, lf, cr, _ = ft._solve_suffix_ref(
        inp, ft.Carry(*[b.clone() for b in bank]), stw["n_max"], stw["E"],
        stw["P"], stw["V"], cs.CK, SUF, glw)
    final = ft.Carry(*[c.contiguous().clone() for c in cr])
    count = max(NC - glw // cs.CK, 1)
    j0 = NC - count
    bs = fc.BankState(final, ft.Carry(*[b.clone() for b in bank]))
    want = ft.Carry(*[b.clone() for b in bank])
    ft._bank_store_ref(want, final, j0, count)
    if folded:
        def restamp():
            return fc.pack_outputs(tk, lf, final, store=(bs, j0, count))
    else:
        def restamp():
            fc.ffd_bank_store(bs, j0, count)
            return fc.pack_outputs(tk, lf, final)
    if not torch.equal(restamp(), ft._pack_outputs_ref(tk, lf, final)) \
            or not all(torch.equal(a, b) for a, b in zip(bs.bank, want)):
        raise AssertionError("the pack or the re-stamped rows != plain")
    row = sum(c.numel() * c.element_size() for c in final)
    rec = dict(rows=count, first_row=j0, row_bytes=row,
               restamp_bound_us=cs.bound_ms(row + count * row, 0)[0] * 1e3,
               pack=reads(lambda: fc.pack_outputs(tk, lf, final), reps=20))
    if folded:
        rec["pack_restamp"] = reads(restamp, reps=20)
    else:
        rec["bank_store"] = reads(lambda: fc.ffd_bank_store(bs, j0, count),
                                  reps=20)
        rec["store_then_pack"] = reads(restamp, reps=20)
    out["warm_pack"] = rec
    out["warm_device_ms"] = cs.warm_solve_times(dw, stw, glw)
    out["warm_suffix_enqueue_ms"] = k3k9.suffix_enqueue_ms(dw, stw, glw)
    del dw, inp, bank, bs, want
    torch.cuda.empty_cache()
    return out


def subset_rounds(cs, reads, folded):
    """Config 4's subset rounds: p50, device ms, and the last commit
    without and with the summary rows (or then ``subset_summary``)."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.solver.consolidation import \
        CUDAConsolidationEvaluator
    dev = torch.device("cuda")
    out = {}
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
        _, drv = cs.drive(key, lambda: fn(ev), cs.C4_ROUNDS,
                          split=lambda: dict(ev.last_phase_stats))
        sub.restore()
        _, cap = cs.subset_rows_check(key, sub, cmp, dev)
        arena, tp, t, kw = cap
        B, Gq = t["gid"].shape
        dev_ms = cs.solve_device_ms(lambda: ct.subset_solve(
            arena, tp, t["gid"], t["n"], t["dead"], t["keep"],
            t["removed_price"], n_max=kw["n_max"], E=kw["E"], P=kw["P"]),
            reps=5)
        st, _ = cs.k2_lane_scan(cap, Gq - 1)
        fc.ffd_slot_headroom(st, Gq - 1)
        scratch = list(st.carry) + [st.k]
        before = [x.clone() for x in scratch]

        def restore(scratch=scratch, before=before):
            for dst, src in zip(scratch, before):
                dst.copy_(src)
        keep, rp = t["keep"], t["removed_price"]
        if folded:
            args, rows = cc.summary_args(st, keep, tp, rp)

            def last(st=st, args=args, rows=rows):
                fc.ffd_group_commit(st, Gq - 1, summary=args)
                return rows
        else:
            def last(st=st, keep=keep, rp=rp):
                fc.ffd_group_commit(st, Gq - 1)
                return cc.subset_summary(st.leftover, st.carry.num_nodes,
                                         st.carry.types, keep, tp, rp,
                                         kw["E"])
        got = last()
        if not torch.equal(got, ct._subset_summary_ref(
                st.leftover, st.carry.num_nodes, st.carry.types, keep, tp,
                rp, kw["E"])):
            raise AssertionError(f"{key}: the summary rows != plain")
        T = arena.A.shape[0]
        on = int((st.carry.types[:, kw["E"]] & keep).sum())
        nbytes = 8 * B * Gq + 4 * B + 2 * B * T + 8 * on + 8 * B + 40 * B
        r = dict(p50_ms=drv["p50_ms"], split=drv.get("median_split_ms"),
                 lanes=[B, Gq], shape=[st.cluster, st.threads],
                 round_device_ms=dev_ms,
                 launches_per_round=drv["launches_per_round"],
                 summary_bound_us=cs.bound_ms(nbytes, 2 * B * T)[0] * 1e3,
                 commit=reads(lambda: fc.ffd_group_commit(st, Gq - 1),
                              setup=restore, reps=20))
        if folded:
            r["commit_summary"] = reads(last, setup=restore, reps=20)
        else:
            args = (st.leftover, st.carry.num_nodes, st.carry.types, keep,
                    tp, rp, kw["E"])
            r["summary"] = reads(lambda: cc.subset_summary(*args), reps=20)
            r["commit_then_summary"] = reads(last, setup=restore, reps=20)
        out[key] = r
        del cap, sub, ev, arena, t, st, scratch, before
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
