"""Time variants of the summary tail of K2's ``ffd_group_commit`` (the
subset round's summary rows, ``csrc/ffd_scan.cu`` ``summary_row``) at
BASELINE config 4's subset rounds, on a card.

Builds, each alone into a temporary directory, copies of this tree's
``csrc/ffd_scan.cu`` with the tail patched (VARIANTS):

- ``tail``: the tail as it is;
- ``nn_only``: only num_nodes written (the launch's fixed cost of the
  flag);
- ``no_units``: no unit of the t0 row read; ``no_prices``: no price read;
  ``all_prices``: every price of a unit's span read beside the t0 span;
- ``shuffled``: the prices of a warp's on types read 32 consecutive types
  a load, each unit's mask passed over by shuffles, in place of a
  thread's own 16;
- ``no_prefetch``: the lane's keep row not prefetched into L2 at the
  launch's start; ``shuffle_reduce``: the least price and the leftover
  by 64-bit shuffles in place of two 32-bit reductions; ``cluster_sync``:
  the last barrier a cluster barrier on one-CTA clusters too;
  ``untuned``: all three (the tail before those three changes);

then drives the whole-fleet round (a) (2,048 lanes, one group) and the
prefix round (b) (128 lanes of 128 groups) through
``CUDAConsolidationEvaluator()`` to capture their inputs, runs the
kernels' scan up to the last group's headroom and times the last commit
from that state, restored before each launch: without the rows (this
tree's library), and with them in each variant, by
``chip_smoke.time_launches`` (READINGS readings, each beside the host's
enqueue, ``k1_ab.watch_drain``). The rows of the variants that write
them are checked against ``_subset_summary_ref`` first. Prints one line
``VARIANTS {json}``:

    python3 hack/k7_summary_variants.py [variant,variant,...]

(default: every variant).
"""
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

READINGS = 5
CALL = "        if (rank == 0) summary_row<NT>(a, g, sum, lane, scan);"
PRICE = """            pr[b] = (on >> b) & 1u ? __ldg(sm.tprice + lo + b)
                                   : 0x7fffffffffffffffLL;"""
SKIP = "        if (lo >= hi) continue;"
UNITS_HEAD = """    for (i64 u = tid; u < T / 16 + 2; u += NT) {
        const i64 lo = u == 0 ? 0 : h + 16 * (u - 1);
        const i64 hi = u == 0 ? h : (lo + 16 < T ? lo + 16 : T);
        if (lo >= hi) continue;
        unsigned on = 0;           // bit i: type lo + i is on
        if (hi - lo == 16) {"""
SHUFFLED_HEAD = """    for (i64 ub = tid - ln; ub < T / 16 + 2; ub += NT) {
        const i64 u = ub + ln;
        const i64 lo = u == 0 ? 0 : h + 16 * (u - 1);
        const i64 hi = u == 0 ? h : (lo + 16 < T ? lo + 16 : T);
        unsigned on = 0;           // bit i: type lo + i is on
        if (lo >= hi) {
        } else if (hi - lo == 16) {"""
SHUFFLED_PRICE = """#pragma unroll
        for (int b = 0; b < 16; ++b) {
            const int src = 2 * b + (ln >> 4);
            const unsigned m = __shfl_sync(~0u, on, src);
            const i64 us = ub + src;
            const i64 t = (us == 0 ? 0 : h + 16 * (us - 1)) + (ln & 15);
            pr[b] = (m >> (ln & 15)) & 1u ? __ldg(sm.tprice + t)
                                          : 0x7fffffffffffffffLL;
        }"""
PRICE_LOOP = """#pragma unroll
        for (int b = 0; b < 16; ++b)
            pr[b] = (on >> b) & 1u ? __ldg(sm.tprice + lo + b)
                                   : 0x7fffffffffffffffLL;"""
PREFETCH = (
    "    if constexpr (kSum) {   // the lane's keep row into L2, 128 B a "
    "thread\n"
    "        if (blockIdx.x == 0 && tid * 128 < args.f.T)\n"
    "            asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"(\n"
    "                sum.keep + (i64)lane * args.f.T + 128 * tid));\n"
    "    }\n")
REDUCE32 = (
    "    {   // the least price as an order-preserving unsigned key, high "
    "word\n"
    "        // first, by two 32-bit reductions\n"
    "        const u64 key = (u64)mp ^ (1ull << 63);\n"
    "        const unsigned kh = (unsigned)(key >> 32);\n"
    "        const unsigned mh = __reduce_min_sync(~0u, kh);\n"
    "        const unsigned ml = __reduce_min_sync(~0u, kh == mh ? "
    "(unsigned)key\n"
    "                                                             : ~0u);\n"
    "        mp = (i64)((((u64)mh << 32) | ml) ^ (1ull << 63));\n"
    "    }\n"
    "    if (g > a.G0)           // more than one leftover row\n"
    "        for (int off = 16; off > 0; off >>= 1)\n"
    "            left += __shfl_xor_sync(~0u, left, off);")
SHUFFLES = """    for (int off = 16; off > 0; off >>= 1) {
        left += __shfl_xor_sync(~0u, left, off);
        const i64 o = __shfl_xor_sync(~0u, mp, off);
        mp = o < mp ? o : mp;
    }"""
CLUSTER_SYNC = ("    cl.sync();   // no CTA leaves while another may read its "
                "shared memory")
CTA_SYNC = ("    if (kSum && CS == 1)    // one CTA: its own writes, visible "
            "at CTA scope\n"
            "        __syncthreads();\n"
            "    else\n" + CLUSTER_SYNC.replace("    ", "        ", 1))
#: name -> [(anchor, replacement)] on csrc/ffd_scan.cu; the rows of the
#: ``TIMING_ONLY`` variants are not the summary's
VARIANTS = {
    "tail": [],
    "nn_only": [(CALL, "        if (rank == 0 && threadIdx.x == 0) "
                       "sum.out[lane * 5 + 1] = a.num_nodes[0];")],
    "no_units": [(SKIP, "        continue;")],
    "no_prices": [(PRICE, "            pr[b] = 0x7fffffffffffffffLL;")],
    "all_prices": [(PRICE, """            {
                const i64 q = lo + b < T ? __ldg(sm.tprice + lo + b) : 0;
                pr[b] = (on >> b) & 1u ? q : 0x7fffffffffffffffLL;
            }""")],
    "shuffled": [(UNITS_HEAD, SHUFFLED_HEAD), (PRICE_LOOP, SHUFFLED_PRICE)],
    "no_prefetch": [(PREFETCH, "")],
    "shuffle_reduce": [(REDUCE32, SHUFFLES)],
    "cluster_sync": [(CTA_SYNC, CLUSTER_SYNC)],
}
VARIANTS["untuned"] = (VARIANTS["no_prefetch"] + VARIANTS["shuffle_reduce"]
                        + VARIANTS["cluster_sync"])
TIMING_ONLY = ("nn_only", "no_units", "no_prices")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(fc, csrc, name, subs):
    """The patched ffd_scan.cu built alone: its ctypes library."""
    with open(os.path.join(csrc, "ffd_scan.cu")) as f:
        src = f.read()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: ffd_scan.cu has no single {old!r}")
        src = src.replace(old, new)
    tmp = tempfile.mkdtemp()
    cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, "lib.so")
    with open(cu, "w") as f:
        f.write(src)
    p = subprocess.run([fc._nvcc(), *fc.NVCC_FLAGS, "-I", csrc, "-shared",
                        cu, "-o", so], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}\n{p.stderr}")
    lib = ctypes.CDLL(so)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.karp_ffd_group_commit.argtypes = [vp, ll, vp, vp, vp]
    lib.karp_ffd_group_commit.restype = ctypes.c_int
    return lib


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    cs = _load("k7v_smoke", os.path.join(here, "chip_smoke.py"))
    k1 = _load("k7v_k1", os.path.join(here, "hack", "k1_ab.py"))

    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.solver.consolidation import \
        CUDAConsolidationEvaluator
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    fc.build_info()
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(
            lambda n: build(fc, fc.CSRC, n, VARIANTS[n]), names)))
    drain = k1.watch_drain(cs)
    out = dict(card=cs.smi_line(), sleep_ms=drain["sleep_ms"])
    dev = torch.device("cuda")

    def reads(fn, setup):
        r = []
        for _ in range(READINGS):
            cs.time_launches(fn, reps=20, setup=setup)
            r.append(drain["readings"][-1])
        return r

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
        fn(ev)
        sub.restore()
        _, cap = cs.subset_rows_check(key, sub, cmp, dev)
        arena, tp, t, kw = cap
        B, Gq = t["gid"].shape
        st, _ = cs.k2_lane_scan(cap, Gq - 1)
        fc.ffd_slot_headroom(st, Gq - 1)
        scratch = list(st.carry) + [st.k]
        before = [x.clone() for x in scratch]

        def restore(scratch=scratch, before=before):
            for dst, src in zip(scratch, before):
                dst.copy_(src)
        args, rows = cc.summary_args(st, t["keep"], tp, t["removed_price"])
        rec = dict(lanes=[B, Gq], shape=[st.cluster, st.threads],
                   commit=reads(lambda: fc.ffd_group_commit(st, Gq - 1),
                                restore))
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            def launch(lib=lib):
                err = lib.karp_ffd_group_commit(
                    ctypes.byref(st.kargs), Gq - 1, None,
                    ctypes.byref(args), stream)
                if err:
                    raise RuntimeError(f"{name}: error {err}")
            restore()
            rows.fill_(-1)
            launch()
            if name not in TIMING_ONLY and not torch.equal(
                    rows, ct._subset_summary_ref(
                        st.leftover, st.carry.num_nodes, st.carry.types,
                        t["keep"], tp, t["removed_price"], kw["E"])):
                raise AssertionError(f"{key} {name}: rows != plain")
            rec[name] = reads(launch, restore)
        out[key] = rec
        del cap, sub, ev, arena, t, st, scratch, before
        torch.cuda.empty_cache()
    out["readings_kept_rule"] = "enqueue ms < sleep_ms"
    print("VARIANTS", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
