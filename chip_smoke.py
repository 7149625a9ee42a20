#!/usr/bin/env python3
"""Drive the port's provisioning solve on one NVIDIA GPU and check it.

    python3 chip_smoke.py                    # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal    # plain versions, small, on CPU

Phases (any failure exits non-zero before the result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the CUDA kernels of ``karpenter_provider_aws_tpu_torch/csrc``
   from the sources in this checkout (one nvcc per source, all started
   together; sm_90a), with the build time and the ptxas register /
   shared-memory report;
3. kernels against their plain PyTorch versions, byte for byte: the K1
   and K2 kernels on the BASELINE config-2 arena (50,000 mixed pods x the
   full 812-type catalog) and on the synthetic arenas of
   ``karpenter_provider_aws_tpu_torch.examples`` (existing nodes,
   minValues floors, binding pool limits, daemon overhead, two pools, a
   priority section, exhausted slots, an all-zero R column); the K3 bank
   kernels, the checkpointed solve and every (jr, SUF, GL) suffix of
   G=8, CK=2 arenas with existing nodes and with minValues floors, and
   of the 50,000-pod warm-cluster arena;
4. the config-2 path: ``CUDASolver(incremental=False)`` solves config 2
   from scratch through ``Solver.solve`` (one warm-up, then timed rounds)
   with every launch counter set to 0 just before and read just after;
   the decisions must fingerprint-equal ``CUDASolver(device="cpu")`` (the
   plain versions) and every pod must be placed or reported;
5. the warm-tick path: ``CUDASolver()`` (incremental) on
   ``examples.warm_cluster(50_000, 0.01)``: a cold solve, 12 warm-up
   ticks with binds, then 60 measured ticks without binds with every
   launch counter set to 0 just before and read just after. Every
   measured tick must be served by a suffix re-solve and fingerprint-
   equal a from-scratch ``CUDASolver(incremental=False)`` solve on the
   card; the first five and the last also the plain versions' solve;
6. kernel times with CUDA events at the main paths' shapes, beside the
   plain versions' times, the bound the shapes allow and, for the bank
   kernels, ``Tensor.copy_`` of the same bytes; the suffix solve's device
   time beside the checkpointed full solve's on the warm arena.

The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``; a line before them holds the per-kernel
JSON record. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: the non-tensor-core scalar rate (float32, 67 TFLOP/s), used as the
#: peak for the kernels' integer and boolean operations
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

#: BASELINE config 2 at its published size, and the timed solve rounds
PODS = 50_000
ROUNDS = 10

#: the warm tick (reference bench.py --warm-tick): cluster size, pending
#: share, warm-up ticks (with binds) and measured ticks (without)
WARM_PODS = 50_000
WARM_PENDING = 0.01
WARM_WARMUP = 12
WARM_TICKS = 60
#: measured ticks also checked against the plain versions' solve
WARM_CPU_CHECKS = (0, 1, 2, 3, 4, WARM_TICKS - 1)
CK = 2

KERNELS = {
    "unpack_bits": dict(
        source="karpenter_provider_aws_tpu_torch/csrc/packed_io.cu",
        replaces="karpenter_provider_aws_tpu/ops/ffd_jax.py:1140"),
    "ffd_slot_headroom": dict(
        source="karpenter_provider_aws_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_provider_aws_tpu/ops/ffd_jax.py:279"),
    "ffd_group_commit": dict(
        source="karpenter_provider_aws_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_provider_aws_tpu/ops/ffd_jax.py:380"),
    "pack_outputs": dict(
        source="karpenter_provider_aws_tpu_torch/csrc/packed_io.cu",
        replaces="karpenter_provider_aws_tpu/ops/ffd_jax.py:1159"),
    "ffd_bank_store": dict(
        source="karpenter_provider_aws_tpu_torch/csrc/ckpt.cu",
        replaces="karpenter_provider_aws_tpu/ops/ffd_jax.py:795"),
    "ffd_bank_load": dict(
        source="karpenter_provider_aws_tpu_torch/csrc/ckpt.cu",
        replaces="karpenter_provider_aws_tpu/ops/ffd_jax.py:1296"),
}


def log(*a):
    print(*a, flush=True)


def config2(env_mod, env, n_pods: int):
    """bench.py build_config2: 60% small, 25% medium, 10% spot-pinned and
    5% arm64-pinned pods under one pool over the full catalog."""
    from karpenter_provider_aws_tpu_torch.apis import labels as L
    mk = env_mod.make_pods
    n_small, n_med = int(n_pods * 0.60), int(n_pods * 0.25)
    n_spot = int(n_pods * 0.10)
    n_arm = n_pods - n_small - n_med - n_spot
    pods = (mk(n_small, cpu="250m", memory="512Mi", prefix="small")
            + mk(n_med, cpu="1", memory="2Gi", prefix="med")
            + mk(n_spot, cpu="2", memory="4Gi", prefix="spot",
                 node_selector={L.CAPACITY_TYPE: "spot"})
            + mk(n_arm, cpu="500m", memory="1Gi", prefix="arm",
                 node_selector={L.ARCH: "arm64"}))
    return env.snapshot(pods, [env.nodepool("bench-pool")])


def smi_line() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if p.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against plain versions
# ---------------------------------------------------------------------------

class Compare:
    """Byte-identity bookkeeping per kernel."""

    def __init__(self):
        self.err = {k: 0 for k in KERNELS}
        self.checks = {k: 0 for k in KERNELS}

    def __call__(self, kernel, got, want, what):
        import torch
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{kernel} {what}: {got.dtype}{tuple(got.shape)}"
                                 f" vs {want.dtype}{tuple(want.shape)}")
        diff = (got.long() - want.long()).abs().max().item() \
            if got.numel() else 0
        self.err[kernel] = max(self.err[kernel], diff)
        self.checks[kernel] += 1
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} {what}: kernel != plain "
                                 f"(max abs diff {diff})")


def check_arena(label, buf_np, st, cmp, dev):
    """Every kernel against its plain version on one arena, group by
    group from the plain carry, then the whole packed solve."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops.hostpack import (
        in_layout_bool, in_layout_i64, layout_sizes, nwords)
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    K, M, V, Q, n_max = st["K"], st["M"], st["V"], st["Q"], st["n_max"]
    buf = torch.from_numpy(buf_np).to(dev)
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, K, M, 1, Q))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, K, M, 1, Q))
    words = buf[n_i64:n_i64 + nwords(n_bits)]
    bits = fc.unpack_bits(words, n_bits)
    cmp("unpack_bits", bits, ft._unpack_bits_ref(words, n_bits),
        f"{label} bool plane")
    inp = ft._unpack_inputs(buf[:n_i64], bits, T, D, Z, C, G, E, P, K, M,
                            1, Q)
    carry = ft.carry0(inp, E + n_max, E)
    state = fc.ScanState(inp, ft.Carry(*[t.clone() for t in carry]),
                         E=E, P=P, V=V)
    takes, lefts = [], []
    for g in range(G):
        for dst, src in zip(state.carry, carry):
            dst.copy_(src)
        cand, k = ft._slot_headroom_ref(inp, carry, g, E=E, P=P, V=V)
        fc.ffd_slot_headroom(state, g)
        cmp("ffd_slot_headroom", state.cand, cand, f"{label} g={g} cand")
        cmp("ffd_slot_headroom", state.k, k, f"{label} g={g} k")
        carry, take, n_rem = ft._group_step_ref(inp, carry, g, E=E, P=P,
                                                V=V)
        fc.ffd_group_commit(state, g)
        for f, got, want in zip(ft.Carry._fields, state.carry, carry):
            cmp("ffd_group_commit", got, want, f"{label} g={g} {f}")
        cmp("ffd_group_commit", state.takes[g], take.to(torch.int32),
            f"{label} g={g} takes")
        cmp("ffd_group_commit", state.leftover[g:g + 1], n_rem.reshape(1),
            f"{label} g={g} leftover")
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
    tk, lf = torch.stack(takes), torch.cat(lefts)
    cmp("pack_outputs", fc.pack_outputs(tk, lf, carry),
        ft._pack_outputs_ref(tk, lf, carry), f"{label} output buffer")
    whole = ft.solve_scan_packed1(buf, **examples.solve_statics(st))
    plain = ft._pack_outputs_ref(*ft._solve_scan_ref(
        ft._unpack_inputs(buf[:n_i64], ft._unpack_bits_ref(words, n_bits),
                          T, D, Z, C, G, E, P, K, M, 1, Q),
        n_max, E, P, V))
    if not torch.equal(whole, plain):
        raise AssertionError(f"{label}: packed solve on the card differs "
                             "from the plain packed solve")
    return inp, carry, tk, lf


def n_offset(st) -> int:
    """Word offset of the group-count vector ``n`` in a packed arena."""
    return st["T"] * st["D"] + st["G"] * st["D"]


def check_k3(label, buf_np, st, cmp, dev, gls=None):
    """The K3 kernels and solves against their plain versions on one
    arena: for each live bound GL (``gls``; default every multiple of CK
    up to G, the groups past GL emptied) the checkpointed solve's output
    and every bank field, ffd_bank_load of every bank row, then every
    SUF the bound allows: the suffix output and the spliced bank, each
    run from its own copy of the recorded bank."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    K, M, V, Q, n_max = st["K"], st["M"], st["V"], st["Q"], st["n_max"]
    ss = examples.solve_statics(st)
    off = n_offset(st)
    runs = 0
    for GL in (gls or range(CK, G + 1, CK)):
        b = buf_np.copy()
        b[off + GL:off + G] = 0
        d = torch.from_numpy(b).to(dev)
        out, bank = ft.solve_scan_packed1_ckpt(d, CK=CK, **ss)
        inp = ft._packed_inputs_ref(d, T, D, Z, C, G, E, P, K, M, Q)
        tk, lf, cr, pbank = ft._solve_ckpt_ref(inp, n_max, E, P, V, CK)
        cmp("pack_outputs", out, ft._pack_outputs_ref(tk, lf, cr),
            f"{label} GL={GL} ckpt output")
        for nm, g, w in zip(ft.Carry._fields, bank, pbank):
            cmp("ffd_bank_store", g, w, f"{label} GL={GL} ckpt bank.{nm}")
        work = ft.bank_row(pbank, 0)
        bs = fc.BankState(work, bank)
        for j in range(G // CK):
            fc.ffd_bank_load(bs, j)
            for nm, g, w in zip(ft.Carry._fields, work,
                                ft.bank_row(pbank, j)):
                cmp("ffd_bank_load", g, w, f"{label} row {j} {nm}")
        for SUF in range(1, GL // CK + 1):
            kb = ft.Carry(*[x.clone() for x in bank])
            pb = ft.Carry(*[x.clone() for x in pbank])
            o, kb = ft.solve_scan_suffix(d, kb, CK=CK, SUF=SUF, GL=GL, **ss)
            tk, lf, cr, pb = ft._solve_suffix_ref(inp, pb, n_max, E, P, V,
                                                  CK, SUF, GL)
            cmp("ffd_bank_load", o, ft._pack_outputs_ref(tk, lf, cr),
                f"{label} GL={GL} SUF={SUF} suffix output")
            for nm, g, w in zip(ft.Carry._fields, kb, pb):
                cmp("ffd_bank_store", g, w,
                    f"{label} GL={GL} SUF={SUF} spliced bank.{nm}")
            runs += 1
    return runs


# ---------------------------------------------------------------------------
# phase 5: the warm tick
# ---------------------------------------------------------------------------

def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def warm_tick_phase(pods=WARM_PODS, device=None):
    """Drive the warm tick on ``device`` (default cuda; the rehearsal
    passes cpu); returns (launches of the measured run, summary dict).
    Raises on any failed check."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    snapshot, tick = examples.warm_cluster(pods=pods,
                                           pending_frac=WARM_PENDING)
    solver = CUDASolver(device=device)
    t0 = time.perf_counter()
    solver.solve(snapshot())
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_modes = []
    for _ in range(WARM_WARMUP):
        tick(binds=True)
        solver.solve(snapshot())
        warm_modes.append((solver.last_phase_stats["solve"],
                           solver.last_dispatch_stats["reason"]))
    snaps, fps, walls, stats = [], [], [], []
    fc.reset_launches()
    for _ in range(WARM_TICKS):
        tick(binds=False)
        snap = snapshot()
        t0 = time.perf_counter()
        res = solver.solve(snap)
        walls.append((time.perf_counter() - t0) * 1e3)
        snaps.append(snap)
        fps.append(res.decision_fingerprint())
        stats.append((dict(solver.last_phase_stats),
                      dict(solver.last_dispatch_stats)))
    launches = dict(fc.LAUNCHES)
    log(f"[warm] {pods} pods, {len(snaps[0].pods)} pending, "
        f"{len(snaps[0].existing_nodes)} existing nodes; cold solve "
        f"{cold_ms:.1f} ms; warm-up (mode, full reason): {warm_modes}")
    log(f"[warm] launches in the measured run ({WARM_TICKS} ticks): "
        f"{launches}")
    # the from-scratch solves (on the card, and the plain versions) run
    # after the counters are read: their launches are not the main path's
    on_card = CUDASolver(device=device, incremental=False)
    plain = CUDASolver(device="cpu", incremental=False)
    for t, snap in enumerate(snaps):
        if on_card.solve(snap).decision_fingerprint() != fps[t]:
            raise AssertionError(f"warm tick {t}: incremental decisions "
                                 "differ from the from-scratch solve")
        if t in WARM_CPU_CHECKS and \
                plain.solve(snap).decision_fingerprint() != fps[t]:
            raise AssertionError(f"warm tick {t}: decisions differ from "
                                 "the plain versions' solve")
    full = [(t, ds["reason"]) for t, (ps, ds) in enumerate(stats)
            if ps["solve"] == "full"]
    modes = {}
    for ps, _ in stats:
        modes[ps["solve"]] = modes.get(ps["solve"], 0) + 1
    resume = {}
    for _, ds in stats:
        if "resume_group" in ds:
            resume[ds["resume_group"]] = resume.get(ds["resume_group"], 0) + 1
    split = {k: statistics.median(ps[k] for ps, _ in stats)
             for k in ("group_ms", "encode_ms", "kernel_ms", "decode_ms")}
    tiers = {}
    for ps, _ in stats:
        tiers[ps["cache"]] = tiers.get(ps["cache"], 0) + 1
    summary = dict(p50_ms=statistics.median(walls), p99_ms=pct(walls, 0.99),
                   modes=modes, full_ticks=full, resume_groups=resume,
                   tiers=tiers, median_split_ms=split,
                   slot_bucket=stats[-1][1]["slot_bucket"],
                   groups=stats[-1][1]["groups"],
                   launches_per_tick={k: v / WARM_TICKS
                                      for k, v in launches.items()})
    log(f"[warm] {WARM_TICKS} measured ticks: split (mode: ticks) {modes}; "
        f"full ticks (tick, reason): {full}; resume groups {resume}; "
        f"delta tiers {tiers}; slot bucket {summary['slot_bucket']}, "
        f"padded groups {summary['groups']}")
    log(f"[warm] tick p50 {summary['p50_ms']:.3f} ms p99 "
        f"{summary['p99_ms']:.3f} ms; median split {json.dumps(split)}; "
        f"fingerprints == from scratch on the card: {WARM_TICKS}/"
        f"{WARM_TICKS}, == plain versions: {len(WARM_CPU_CHECKS)} ticks")
    if full:
        raise AssertionError(f"measured warm ticks served by a full solve: "
                             f"{full}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing and solver.device.type == "cuda":
        raise AssertionError(f"kernels never launched on the warm-tick "
                             f"path: {missing}")
    return launches, summary


# ---------------------------------------------------------------------------
# phase 6: timing and bounds
# ---------------------------------------------------------------------------

def time_launches(fn, reps=50, setup=None):
    """Mean ms per call of ``fn`` on the current stream, from CUDA event
    pairs around each call. A sleep kernel first lets the host enqueue
    ahead, so the events time the device work, not the launch gaps."""
    import torch
    for _ in range(3):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(20_000_000)
    for i in range(reps):
        if setup:
            setup()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.fmean(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(nbytes: float, ops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_times(c2, launches):
    """Time every kernel at the config-2 shapes; returns the records."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    inp, st, words, n_bits, carries, takes, lefts, final = c2
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    N = E + st["n_max"]
    recs = {}

    # K1 unpack_bits: reads the words, writes one byte per bool
    ms = time_launches(lambda: fc.unpack_bits(words, n_bits))
    pms = time_launches(lambda: ft._unpack_bits_ref(words, n_bits))
    recs["unpack_bits"] = (ms, pms, words.numel() * 8 + n_bits,
                           2 * n_bits)

    # K2 phase 1 at each group's entry carry (the scan's real states)
    state = fc.ScanState(inp, ft.Carry(*[t.clone() for t in carries[0]]),
                         E=E, P=P)
    ms_l, pms_l, by_l, op_l = [], [], [], []
    for g in range(G):
        cg = carries[g]
        for dst, src in zip(state.carry, cg):
            dst.copy_(src)
        ms_l.append(time_launches(lambda: fc.ffd_slot_headroom(state, g)))
        pms_l.append(time_launches(
            lambda: ft._slot_headroom_ref(inp, cg, g, E=E, P=P, V=0),
            reps=10))
        cand, _ = ft._slot_headroom_ref(inp, cg, g, E=E, P=P, V=0)
        n_cand = int(cand.sum())
        # read: types, F, avail, A, used, zones, ct, pool, admit, R;
        # write: cand, k
        by_l.append(N * T + T + T * Z * C + T * D * 8 + N * D * 8
                    + N * (Z + C + 4) + P + D * 8 + N * T + N * 8)
        # one 64-bit quotient per (candidate cell, dim), one offering
        # test per (slot, type, zone, capacity type)
        op_l.append(n_cand * D + N * T * Z * C)
    recs["ffd_slot_headroom"] = (statistics.fmean(ms_l),
                                 statistics.fmean(pms_l),
                                 statistics.fmean(by_l),
                                 statistics.fmean(op_l))

    # K2 phase 2: restore the group's entry carry and its phase-1 result
    # before each launch (outside the timed events)
    ms_l, pms_l, by_l, op_l = [], [], [], []
    for g in range(G):
        cg = carries[g]
        cand, k = ft._slot_headroom_ref(inp, cg, g, E=E, P=P, V=0)

        def setup(cg=cg, cand=cand, k=k):
            for dst, src in zip(state.carry, cg):
                dst.copy_(src)
            state.cand.copy_(cand)
            state.k.copy_(k)
        ms_l.append(time_launches(lambda: fc.ffd_group_commit(state, g),
                                  setup=setup))
        pms_l.append(time_launches(
            lambda: ft._group_step_ref(inp, cg, g, E=E, P=P, V=0), reps=10))
        nxt = carries[g + 1] if g + 1 < G else final
        touched = int((nxt.types != cg.types).any(dim=1).sum()) \
            + int((takes[g] > 0).sum())
        # read: k, pool, used, A, F, pool_types, avail, daemon, R, the cand
        # rows of filled slots; write: used, the touched type rows,
        # zones/ct, takes, leftover
        by_l.append(N * 8 + N * 4 + N * D * 8 + T * D * 8 + T * (2 + Z * C)
                    + P * D * 8 + D * 8 + touched * T
                    + N * D * 8 + touched * (T + Z + C) + N * 4 + 8)
        op_l.append(touched * T * D + P * T * (D + Z * C) + 4 * N)
    recs["ffd_group_commit"] = (statistics.fmean(ms_l),
                                statistics.fmean(pms_l),
                                statistics.fmean(by_l),
                                statistics.fmean(op_l))

    # K1 pack_outputs on the final carry
    ms = time_launches(lambda: fc.pack_outputs(takes, lefts, final))
    pms = time_launches(lambda: ft._pack_outputs_ref(takes, lefts, final))
    nb = sum(t.numel() for t in ft._out_bools(final))
    n_out = (takes.numel() + 1) // 2 + (nb + 63) // 64
    i64 = ft._out_i64(lefts, final).numel()
    recs["pack_outputs"] = (ms, pms, takes.numel() * 4 + nb
                            + i64 * 16 + n_out * 8, nb + takes.numel())

    out = []
    for name, (ms, pms, nbytes, ops) in recs.items():
        b, by = bound_ms(nbytes, ops)
        out.append(dict(name=name, route="cuda", **KERNELS[name],
                        launches=launches[name], ms=ms, plain_ms=pms,
                        bound_ms=b, bound_by=by, library_ms=None,
                        bytes=nbytes, ops=ops))
    return out


def bank_times(d_buf, st, launches):
    """The bank kernels at the warm arena's carry, beside the plain
    versions and the eight ``Tensor.copy_`` calls that move the same
    bytes (the library yardstick; the port never calls it)."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    ss = examples.solve_statics(st)
    _, bank = ft.solve_scan_packed1_ckpt(d_buf, CK=CK, **ss)
    j = bank.used.shape[0] // 2
    carry = ft.bank_row(bank, j)
    bs = fc.BankState(carry, bank)
    row = sum(c.numel() * c.element_size() for c in carry)

    def copy_store():
        for b, c in zip(bank, carry):
            b[j].copy_(c.reshape(b[j].shape))

    def copy_load():
        for b, c in zip(bank, carry):
            c.copy_(b[j].reshape(c.shape))
    recs = {
        "ffd_bank_store": (time_launches(lambda: fc.ffd_bank_store(bs, j)),
                           time_launches(lambda: ft._bank_store_ref(
                               bank, carry, j)),
                           time_launches(copy_store)),
        "ffd_bank_load": (time_launches(lambda: fc.ffd_bank_load(bs, j)),
                          time_launches(lambda: ft.bank_row(bank, j)),
                          time_launches(copy_load)),
    }
    out = []
    for name, (ms, pms, lms) in recs.items():
        # one carry read and one written
        b, by = bound_ms(2 * row, 0)
        out.append(dict(name=name, route="cuda", **KERNELS[name],
                        launches=launches[name], ms=ms, plain_ms=pms,
                        bound_ms=b, bound_by=by, library_ms=lms,
                        bytes=2 * row, ops=0))
    return out


def solve_device_ms(fn, reps=20):
    """Mean device ms of one whole solve call: a sleep kernel ahead of
    each call lets the host enqueue all of its launches before the start
    event fires, so the events bracket the device work alone."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(20_000_000)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def warm_solve_times(d_buf, st, gl):
    """Device ms of the checkpointed full solve and of the suffix
    re-solves the warm tick runs (every SUF of the live bound), on the
    warm arena."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.solver.incremental import \
        suffix_buckets
    ss = examples.solve_statics(st)
    _, bank = ft.solve_scan_packed1_ckpt(d_buf, CK=CK, **ss)
    out = {"full_ckpt": solve_device_ms(
        lambda: ft.solve_scan_packed1_ckpt(d_buf, CK=CK, **ss))}
    for SUF in suffix_buckets(st["G"], CK, GL=gl):
        out[f"suffix@{SUF}"] = solve_device_ms(
            lambda: ft.solve_scan_suffix(d_buf, bank, CK=CK, SUF=SUF,
                                         GL=gl, **ss))
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 3-5 with the plain versions at a "
                         "small size on the CPU (never the default)")
    args = ap.parse_args()

    import torch
    sys.path.insert(0, ROOT)
    try:
        import karpenter_provider_aws_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the port package is not next to this script ({e})")
        return 2
    if args.cpu_rehearsal:
        return rehearsal(2000, 2)
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script "
            "needs a CUDA card (or --cpu-rehearsal)")
        return 1

    from karpenter_provider_aws_tpu_torch import device as pdev
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops.hostpack import (
        in_layout_bool, in_layout_i64, layout_sizes, nwords, pack_inputs1)
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.solver.incremental import \
        live_bound

    t_start = time.perf_counter()
    # ---- phase 1: device ------------------------------------------------
    smi = smi_line()
    dinfo = pdev.describe()
    log(f"[device] {smi} | torch {torch.__version__} | cuda "
        f"{torch.version.cuda} | {dinfo}")
    dev = torch.device("cuda")

    # ---- phase 2: build ---------------------------------------------------
    binfo = fc.build_info()
    log(f"[build] {binfo['seconds']:.2f} s, cached={binfo['cached']}, "
        f"{binfo['path']}")
    for line in binfo["ptxas"].splitlines():
        if any(w in line for w in ("registers", "smem", "spill",
                                   "Compiling entry")):
            log(f"[ptxas] {line.strip()}")

    # ---- phase 3: kernels against plain versions --------------------------
    fenv.reset_pod_counter()
    env = fenv.Environment()
    t0 = time.perf_counter()
    snap = config2(fenv, env, PODS)
    log(f"[config2] {PODS} pods built in "
        f"{time.perf_counter() - t0:.2f} s")
    enc = encode_snapshot(snap)
    solver_probe = CUDASolver()
    buf2, st2 = solver_probe.pack(enc, *full_existing_encode(enc, []))
    st2 = dict(st2, n_max=solver_probe._bucket)
    log(f"[config2] statics {st2}, arena {buf2.size} words")
    cmp = Compare()
    cases = [("config2", buf2, st2)]
    for name in examples.CASES:
        arrays, st = examples.example_case(name)
        cases.append((name, pack_inputs1(arrays, *examples.pack_statics(st)),
                      st))
    # a synthetic arena at the catalog's width, with every feature on
    arrays, st = examples.example_case("existing", T=812, G=16, n_max=64,
                                       D=8)
    cases.append(("existing-812", pack_inputs1(
        arrays, *examples.pack_statics(st)), st))
    arrays, st = examples.example_case("min_values", T=812, G=16, n_max=64,
                                       D=8)
    cases.append(("min_values-812", pack_inputs1(
        arrays, *examples.pack_statics(st)), st))
    c2 = None
    for label, buf, st in cases:
        inp, final, tk, lf = check_arena(label, buf, st, cmp, dev)
        if label == "config2":
            c2 = (inp, final, tk, lf)
    # K3 on G=8, CK=2 arenas: every live bound and every SUF it allows
    k3_runs = 0
    for name in ("existing", "min_values"):
        arrays, st = examples.example_case(name, G=8)
        k3_runs += check_k3(f"{name}-G8", pack_inputs1(
            arrays, *examples.pack_statics(st)), st, cmp, dev)
    # K3 on the 50,000-pod warm-cluster arena at the settled slot bucket
    wsnap, _ = examples.warm_cluster(pods=WARM_PODS,
                                     pending_frac=WARM_PENDING)
    wsnap = wsnap()
    wenc = encode_snapshot(wsnap)
    bufw, stw = CUDASolver(incremental=False).pack(
        wenc, *full_existing_encode(wenc, sorted(
            wsnap.existing_nodes, key=lambda n: n.name)))
    stw = dict(stw, n_max=16)
    glw = live_bound(bufw, T=stw["T"], D=stw["D"], G=stw["G"], CK=CK)
    log(f"[warm arena] statics {stw}, live bound {glw}, arena "
        f"{bufw.size} words")
    k3_runs += check_k3("warm50k", bufw, stw, cmp, dev,
                        gls=(glw, stw["G"]))
    torch.cuda.synchronize()
    log(f"[compare] tolerance exact (integer math; any differing word "
        f"fails): {cmp.checks} checks over "
        f"{len(cases)} K1/K2 arenas and {k3_runs} K3 suffix runs, "
        f"max_abs_err {cmp.err}")

    # ---- phase 4: the config-2 path -----------------------------------------
    solver = CUDASolver(incremental=False)
    fc.reset_launches()
    times, splits = [], []
    res = None
    for i in range(ROUNDS + 1):
        t0 = time.perf_counter()
        res = solver.solve(snap)
        dt = (time.perf_counter() - t0) * 1e3
        if i:  # round 0 is the warm-up
            times.append(dt)
            splits.append(solver.last_phase_stats)
    launches_c2 = dict(fc.LAUNCHES)
    log(f"[main] launches in the config-2 run ({ROUNDS + 1} solves): "
        f"{launches_c2}; per solve: "
        f"{solver.last_dispatch_stats['launches']}")
    missing = [k for k, v in launches_c2.items()
               if v <= 0 and k not in ("ffd_bank_store", "ffd_bank_load")]
    if missing:
        raise AssertionError(f"kernels never launched on the config-2 "
                             f"path: {missing}")
    want = CUDASolver(device="cpu", incremental=False).solve(snap)
    if res.decision_fingerprint() != want.decision_fingerprint():
        raise AssertionError("CUDA decisions differ from the plain "
                             "versions' decisions")
    placed = sum(len(n.pod_names) for n in res.new_nodes)
    accounted = placed + len(res.existing_assignments) + \
        len(res.unschedulable)
    if accounted != len(snap.pods):
        raise AssertionError(f"{accounted} of {len(snap.pods)} pods placed "
                             "or reported")
    times.sort()
    p50 = statistics.median(times)
    p99 = times[min(len(times) - 1, int(round(0.99 * (len(times) - 1))))]
    split = {k: statistics.median(s[k] for s in splits)
             for k in ("group_ms", "encode_ms", "kernel_ms", "decode_ms")}
    log(f"[main] config2 {PODS} pods: {res.summary()}; solve p50 "
        f"{p50:.3f} ms p99 {p99:.3f} ms over {len(times)} rounds; "
        f"median split {json.dumps(split)}; fingerprint == plain: True")

    # ---- phase 5: the warm-tick path ----------------------------------------
    launches_w, warm = warm_tick_phase()
    launches = {k: launches_c2[k] + launches_w[k] for k in launches_c2}

    # ---- phase 6: kernel times ---------------------------------------------
    inp, final, tk, lf = c2
    T, D, Z, C, G, E, P = (st2[k] for k in "T D Z C G E P".split())
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, 0, 0, 1,
                                       st2["Q"]))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, 0, 0, 1,
                                         st2["Q"]))
    d_buf = torch.from_numpy(buf2).to(dev)
    words = d_buf[n_i64:n_i64 + nwords(n_bits)]
    carries = [ft.carry0(inp, E + st2["n_max"], E)]
    for g in range(G - 1):
        carries.append(ft._group_step_ref(inp, carries[-1], g, E=E, P=P,
                                          V=0)[0])
    recs = kernel_times((inp, st2, words, n_bits, carries, tk, lf, final),
                        launches)
    d_bufw = torch.from_numpy(bufw).to(dev)
    recs += bank_times(d_bufw, stw, launches)
    for r in recs:
        r["max_abs_err"] = cmp.err[r["name"]]
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms'] * 1e3:.2f} us (Tensor.copy_ x8)"
        log(f"[time] {r['name']}: {r['ms'] * 1e3:.2f} us/launch, "
            f"{r['launches']} launches in the main-path runs (config 2: "
            f"{launches_c2[r['name']]}, warm tick: "
            f"{launches_w[r['name']]}, per warm tick "
            f"{warm['launches_per_tick'][r['name']]:.2f}), bound "
            f"{r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}, "
            f"{r['bytes']:.0f} B, {r['ops']:.0f} ops), plain "
            f"{r['plain_ms'] * 1e3:.1f} us, library {lib}")
    sol = warm_solve_times(d_bufw, stw, glw)
    log(f"[time] warm arena (n_max 16) solve device ms: "
        f"{json.dumps(sol)}")
    log(f"[wall] {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def rehearsal(n_pods: int, rounds: int) -> int:
    """Phases 3-5 with the plain versions on the CPU, at a small size."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops.hostpack import pack_inputs1
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    for name in examples.CASES:
        arrays, st = examples.example_case(name)
        buf = pack_inputs1(arrays, *examples.pack_statics(st))
        a = ft.solve_scan_packed1(buf, device="cpu",
                                  **examples.solve_statics(st))
        b = ft.solve_scan_packed1(torch.from_numpy(buf),
                                  **examples.solve_statics(st))
        if not torch.equal(a, b):
            raise AssertionError(name)
    fenv.reset_pod_counter()
    env = fenv.Environment()
    snap = config2(fenv, env, n_pods)
    solver = CUDASolver(device="cpu")
    for _ in range(rounds):
        res = solver.solve(snap)
    placed = sum(len(n.pod_names) for n in res.new_nodes)
    assert placed + len(res.unschedulable) == n_pods
    log(f"[rehearsal] {n_pods} pods: {res.summary()}; "
        f"{solver.last_phase_stats}")
    warm_tick_phase(pods=n_pods, device="cpu")
    log(json.dumps({"ok": True, "device": {"platform": "cpu",
                                           "kind": "cpu", "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
