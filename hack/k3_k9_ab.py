"""Time the launches that carry K3's chunk-entry bank store and K9's
plain-group record, of one checkout of the port on a card.

A checkout either launches ``ffd_bank_store`` before a chunk entry's
``ffd_slot_headroom`` and ``topo_record_plain`` after a plain group's
``ffd_group_commit`` (the separate kernels), or folds both into those K2
launches (``ffd_cuda.entry_row``, ``topo_cuda.plain_commit``). With the
given checkout's package and this tree's ``chip_smoke.py`` helpers, it
reads, each by ``chip_smoke.time_launches`` (READINGS readings, each
beside the host's enqueue of its timed calls, ``k1_ab.watch_drain``:
where the enqueue outlasts the sleep before them, the queue drained):

- ``ffd_slot_headroom`` at the chunk entries of BASELINE config 2 (50,000
  pods) and of the 50,000-pod warm arena, without a bank row, with one
  (folded checkouts), and ``ffd_bank_store`` of the same row (both);
- at every plain group of BASELINE config 3 (50,000 pods), from its entry
  state after its headroom: ``ffd_group_commit`` without the record, the
  commit with it (folded) or ``topo_record_plain`` after it (separate);
- the warm phase (``chip_smoke.warm_tick_phase``: 60 suffix ticks, p50,
  launches a tick) and the warm arena's device ms a suffix re-solve
  (``chip_smoke.warm_solve_times``) with the host's enqueue of one suffix
  re-solve's launches behind a sleep;
- config 3's solves (``chip_smoke.topo_phase``: p50, launches a solve)
  and the device ms of one scan's launches
  (``chip_smoke.topo_scan_device_ms``) at EVCAP 128 and at the bail's
  re-dispatch capacity.

Prints one line ``AB <tag> {json}``. To compare two builds, run it on both
checkouts in one call to the card, in the order P N N P:

    for v in p n n p; do python3 hack/k3_k9_ab.py path/to/$v $v; done

It times trees up to c0e7ebf: it calls ``ffd_bank_store``, which later
trees fold into the suffix's ``pack_outputs`` (``hack/k3_k7_ab.py`` times
that fold against a tree that still has it).
"""
import collections
import importlib.util
import json
import os
import statistics
import sys
import time

#: ``time_launches`` readings of each timed launch
READINGS = 3


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class AnyCompare:
    """``chip_smoke.Compare`` over whatever kernel names a checkout's
    step checks yield (``names`` counted from the start)."""

    def __init__(self, names):
        self.err = collections.defaultdict(int, dict.fromkeys(names, 0))
        self.checks = collections.defaultdict(int, dict.fromkeys(names, 0))

    def __call__(self, kernel, got, want, what):
        import torch
        self.checks[kernel] += 1
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{kernel} {what}: kernel != plain")


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    cs = _load("k3k9_smoke", os.path.join(here, "chip_smoke.py"))
    k1 = _load("k3k9_k1", os.path.join(here, "hack", "k1_ab.py"))

    import torch
    import karpenter_provider_aws_tpu_torch as pkg
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.solver.cuda import safe_evcap
    from karpenter_provider_aws_tpu_torch.solver.incremental import \
        live_bound
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}, not "
                           f"from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    folded = hasattr(fc, "entry_row")
    pt = fc.build_info()["ptxas"].splitlines()
    drain = k1.watch_drain(cs)
    out = dict(card=cs.smi_line(), folded=folded,
               sleep_ms=drain["sleep_ms"],
               ptxas=[" ".join(x.strip() for x in pt[i:i + 3])
                      for i, line in enumerate(pt)
                      if "Compiling entry" in line and any(
                          k in line for k in ("ffd_slot_headroom",
                                              "ffd_group_commit"))])

    def reads(fn, setup=None):
        """READINGS readings of ``fn``: [(µs, enqueue ms)]."""
        r = []
        for _ in range(READINGS):
            cs.time_launches(fn, setup=setup)
            r.append(drain["readings"][-1])
        return r

    def packed(snap, n_max=None):
        enc = encode_snapshot(snap)
        solver = CUDASolver(incremental=False)
        buf, st = solver.pack(enc, *full_existing_encode(enc, sorted(
            snap.existing_nodes, key=lambda n: n.name)))
        return buf, dict(st, n_max=n_max or solver._bucket)

    def chunk_entries(buf, st, groups=None):
        """The headroom at each chunk entry (at most ``groups`` of them)
        without and with its bank row, and the bank store of that row."""
        from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
        d = torch.from_numpy(buf).cuda()
        inp = ft._packed_inputs_ref(d, *(st[k] for k in
                                         "T D Z C G E P K M Q".split()))
        E, P, V, G = st["E"], st["P"], st["V"], st["G"]
        carry = ft.carry0(inp, E + st["n_max"], E)
        state = fc.ScanState(inp, ft.Carry(*[t.clone() for t in carry]),
                             E=E, P=P, V=V)
        bs = fc.BankState(state.carry, fc.empty_bank(carry, G // cs.CK))
        rec = collections.defaultdict(list)
        n = 0
        for g in range(G):
            if g % cs.CK == 0 and (groups is None or n < groups):
                n += 1
                for dst, src in zip(state.carry, carry):
                    dst.copy_(src)
                j = g // cs.CK
                rec["headroom"] += reads(
                    lambda: fc.ffd_slot_headroom(state, g))
                rec["bank_store"] += reads(
                    lambda: fc.ffd_bank_store(bs, j))
                if folded:
                    rec["headroom_bank_row"] += reads(
                        lambda: fc.ffd_slot_headroom(state, g, bank=bs,
                                                     j=j))
            carry = ft._group_step_ref(inp, carry, g, E=E, P=P, V=V)[0]
        row = sum(c.numel() * c.element_size() for c in carry)
        return dict(entries=n, row_bytes=row, **rec)

    fenv.reset_pod_counter()
    buf2, st2 = packed(cs.config2(fenv, fenv.Environment(), cs.PODS))
    out["config2_entries"] = chunk_entries(buf2, st2, groups=8)
    del buf2

    wsnap, _ = examples.warm_cluster(pods=cs.WARM_PODS,
                                     pending_frac=cs.WARM_PENDING)
    bufw, stw = packed(wsnap(), n_max=16)
    glw = live_bound(bufw, T=stw["T"], D=stw["D"], G=stw["G"], CK=cs.CK)
    out["warm_entries"] = chunk_entries(bufw, stw)
    d_bufw = torch.from_numpy(bufw).cuda()
    out["warm_device_ms"] = cs.warm_solve_times(d_bufw, stw, glw)
    out["warm_suffix_enqueue_ms"] = suffix_enqueue_ms(d_bufw, stw, glw)
    launches, summary = cs.warm_tick_phase()
    out["warm_phase"] = dict(
        p50_ms=summary["p50_ms"], p99_ms=summary["p99_ms"],
        modes=summary["modes"],
        launches_per_tick=summary["launches_per_tick"])

    launches, summary, c3 = cs.topo_phase(AnyCompare(
        list(cs.KERNELS) + ["topo_record_plain"]))
    out["config3"] = dict(p50_ms=summary["p50_ms"],
                          p99_ms=summary["p99_ms"],
                          launches_per_solve=summary["launches_per_solve"])
    out["config3_plain_commits"] = plain_commits(c3, reads, folded)
    inp, rows, st, _ = c3
    arrays = {"n": inp.n.cpu().numpy(),
              "pool_types": inp.pool_types.cpu().numpy()}
    ev_safe = safe_evcap(arrays, {"has_topo": rows.has_topo.cpu().numpy()})
    out["config3_scan_device_ms"] = {
        f"EVCAP={e}": cs.topo_scan_device_ms(c3, e) for e in
        (st["EVCAP"], ev_safe)}
    out["readings_kept_rule"] = "enqueue ms < sleep_ms"
    print("AB", tag, json.dumps(out), flush=True)
    return 0


def suffix_enqueue_ms(d_buf, st, gl, reps=20):
    """The host's ms to enqueue one suffix re-solve at the warm tick's
    bucket (SUF = 3 where the bound allows it) behind a sleep kernel, so
    that the card never waits for it: the median over ``reps`` calls."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    ss = examples.solve_statics(st)
    _, bank = ft.solve_scan_packed1_ckpt(d_buf, CK=2, **ss)
    SUF = min(3, gl // 2)
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        ft.solve_scan_suffix(d_buf, bank, CK=2, SUF=SUF, GL=gl, **ss)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if i:
            times.append((t1 - t0) * 1e3)
    return dict(SUF=SUF, median_ms=statistics.median(times),
                min_ms=min(times))


def plain_commits(c3, reads, folded):
    """Every plain group of config 3 from its entry state (the plain
    parts carry the scan): the commit without the record, and the commit
    with it (folded) or the record kernel after the commit (separate),
    each after the group's headroom."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops import topo_cuda as tc
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    inp, rows, st, _ = c3
    P, N, Z = st["P"], st["n_max"], st["Z"]
    dev = inp.A.device
    carry = ft.carry0(inp, N, 0)
    cz = torch.zeros((st["GZ"], Z), dtype=torch.int64, device=dev)
    ch = torch.zeros((st["GH"], N), dtype=torch.int64, device=dev)
    zfix = torch.full((N,), -1, dtype=torch.int32, device=dev)
    ts = tc.topo_state(inp, rows, cz.clone(), ch.clone(), n_max=N, P=P,
                       EVCAP=st["EVCAP"], PMAX=st["PMAX"])
    rec = collections.defaultdict(list)
    for g, topo in enumerate(rows.has_topo.tolist()):
        if topo:
            gs = tt._topo_group_start_ref(inp, carry, g, rows, P=P)
            r = tt._topo_pour_ref(inp, carry, cz, ch, zfix, g, rows, gs,
                                  P=P, EVCAP=st["EVCAP"], PMAX=st["PMAX"])
            carry, cz, ch, zfix = r.carry, r.cz, r.ch, r.zfix
            continue

        def restore(carry=carry, cz=cz, ch=ch, zfix=zfix, g=g):
            for dst, src in zip(ts.st.carry, carry):
                dst.copy_(src)
            ts.cz.copy_(cz)
            ts.ch.copy_(ch)
            ts.zfix.copy_(zfix)
            fc.ffd_slot_headroom(ts.st, g)
        rec["commit"] += reads(lambda: fc.ffd_group_commit(ts.st, g),
                               setup=restore)
        if folded:
            rec["commit_record"] += reads(lambda: tc.plain_commit(ts, g),
                                          setup=restore)
        else:
            def after_commit(restore=restore, g=g):
                restore()
                fc.ffd_group_commit(ts.st, g)
            rec["record_kernel"] += reads(
                lambda: tc.topo_record_plain(ts, g), setup=after_commit)
        nxt, take, _ = ft._group_step_ref(inp, carry, g, E=0, P=P, V=0)
        cz, ch = tt._topo_record_plain_ref(cz, ch, zfix, take,
                                           rows.member_z[g],
                                           rows.member_h[g])
        carry = nxt
    return dict(groups=len(rec["commit"]) // READINGS, **rec)


if __name__ == "__main__":
    sys.exit(main())
