"""Stamp where the absorption scan (``consol_absorb``: K7a-c and K8) spends
a launch, in an instrumented copy of one checkout of the port on a card.

Copies the checkout's package into the git-ignored
``_archive_check/stamps_<tag>/``, patches its ``csrc/consolidation.cu``
with stamps (``%globaltimer`` at thread 0's start and end; thread 0's
``clock64`` cycles summed over the groups for each part of a group: the
R row's staging, the first k pass, the prefix scan, the take pass, the
take scan with the leftover's write; the prescreen tail's three parts;
the most cycles any thread spent in its k and take passes), builds the
copy and runs from it, with this tree's ``chip_smoke.py`` helpers:

- K8 on the preemption round's own tables (G = 2) and on the wide waves'
  (``chip_smoke.P12_WIDE_G``: 64 lanes, 1,000 nodes, G = 16, 64, 256),
  from ``chip_smoke.preempt_phase``;
- the three K7 modes on BASELINE config 4's round (c) (deletions and
  prescreen at 200 nodes) and round (d) (the dense batch), their inputs
  captured from the evaluator's own calls, with each capture's B, G, E,
  D, T and P.

It knows the parent kernel of the redesign (one CTA of 256 threads a
lane, k computed twice a group, two block scans) and the redesigned one
(thread 0 of a lane stamps the next group's loads issued, the k pass,
the warp scan and its totals published, the barrier, the prefix's
reads, the take pass). Each stamp
is the median over REPS launches (the first discarded), per lane, then
the median over the lanes. Prints one line ``STAMPS <tag> {json}``:

    python3 hack/k7_k8_stamps.py path/to/checkout tag
"""
import ctypes
import importlib.util
import json
import os
import shutil
import sys

REPS = 7
#: words a lane, and lanes, of the stamp buffer
PER = 16
LANES = 4096

_HEAD = r'''
// ---- stamps (hack/k7_k8_stamps.py) ----
__device__ unsigned long long karp_stamp_ab[{n}];
__device__ __forceinline__ unsigned long long stamp_gt_ab() {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}}
extern "C" int karp_stamp_ab_clear() {{
    void* p = nullptr;
    cudaGetSymbolAddress(&p, karp_stamp_ab);
    return (int)cudaMemset(p, 0, sizeof(karp_stamp_ab));
}}
extern "C" int karp_stamp_ab_read(void* dst) {{
    return (int)cudaMemcpyFromSymbol(dst, karp_stamp_ab,
                                     sizeof(karp_stamp_ab));
}}
#define KARP_ST(i) do {{ const long long _n = clock64(); \
    sc[i] += _n - st; st = _n; }} while (0)
'''

_FLUSH = f'''if (b < {LANES}) {{
            unsigned long long* sb = karp_stamp_ab + {PER} * b;
            atomicMax(sb + 10, (unsigned long long)skk);
            atomicMax(sb + 11, (unsigned long long)stk);
            if (tid == 0) {{
                sb[0] = sg0;
                sb[1] = stamp_gt_ab();
                for (int i = 0; i < 8; ++i) sb[2 + i] = sc[i];
                sb[12] = G;
                sb[13] = clock64() - s0;
            }}
        }}'''

#: (anchor, replacement); every anchor must occur exactly once
PATCH = [
    ('''    i64 total = 0;                     // thread 0's sum of leftovers (K8)
''', '''    i64 total = 0;                     // thread 0's sum of leftovers (K8)
    long long sc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    const long long s0 = clock64();
    long long st = s0, skk = 0, stk = 0;
    const unsigned long long sg0 = stamp_gt_ab();
'''),
    ('''        __syncthreads();
        i64 local = 0;
        for (i64 e = lo; e < hi; ++e)
            local = wadd(local, absorb_k<ALIVE>(a, b, crow, alloc, used, Rg,
                                                e));
        i64 tot;
''', '''        __syncthreads();
        KARP_ST(0);
        i64 local = 0;
        for (i64 e = lo; e < hi; ++e)
            local = wadd(local, absorb_k<ALIVE>(a, b, crow, alloc, used, Rg,
                                                e));
        { const long long _n = clock64(); skk += _n - st; sc[1] += _n - st;
          st = _n; }
        i64 tot;
'''),
    ('''        i64 cum = block_excl_scan(local, tmp, &tot);
''', '''        i64 cum = block_excl_scan(local, tmp, &tot);
        KARP_ST(2);
'''),
    ('''        i64 taken;
''', '''        { const long long _n = clock64(); stk += _n - st; sc[3] += _n - st;
          st = _n; }
        i64 taken;
'''),
    ('''            else a.leftover[bg] = wsub(ng, taken);
        }
''', '''            else a.leftover[bg] = wsub(ng, taken);
        }
        KARP_ST(4);
'''),
    ('''        if (tid == 0) a.total[b] = total;
        return;
''', f'''        if (tid == 0) a.total[b] = total;
        {_FLUSH}
        return;
'''),
    ('''    __syncthreads();                   // leftover rows are visible
''', '''    __syncthreads();                   // leftover rows are visible
    KARP_ST(5);
'''),
    ('''            a.out[b] = ok;
        }
        return;
''', f'''            a.out[b] = ok;
        }}
        {_FLUSH}
        return;
'''),
    ('''    __syncthreads();
    const i64 cap = a.price_cap[b];
''', '''    __syncthreads();
    KARP_ST(6);
    const i64 cap = a.price_cap[b];
'''),
    ('''    if (tid == 0) a.out[b] = found || !any_active;
}
''', f'''    if (tid == 0) a.out[b] = found || !any_active;
    KARP_ST(7);
    {_FLUSH}
}}
'''),
]
#: what each word of a lane holds
SLOTS = {2: "stage", 3: "k_pass", 4: "prefix_scan", 5: "take_pass",
         6: "take_scan", 7: "tail_barrier", 8: "tail_any_agg_pok",
         9: "tail_types", 10: "k_pass_max_thread", 11: "take_pass_max_thread",
         13: "total"}

_FLUSH_N = f'''if (b < {LANES}) {{
        unsigned long long* sb = karp_stamp_ab + {PER} * b;
        atomicMax(sb + 10, (unsigned long long)skk);
        atomicMax(sb + 11, (unsigned long long)stk);
        if (tid == 0) {{
            sb[0] = sg0;
            sb[1] = stamp_gt_ab();
            for (int i = 0; i < 8; ++i) sb[2 + i] = sc[i];
            sb[12] = G;
            sb[13] = clock64() - s0;
        }}
    }}'''

#: the redesigned kernel (one k pass, a warp scan and one barrier a
#: group): (anchor, replacement), thread 0 stamping
PATCH_REDESIGN = [
    ('''    u64 tprev = 0, ttot = 0, nsum = 0;
''', '''    u64 tprev = 0, ttot = 0, nsum = 0;
    long long sc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    const long long s0 = clock64();
    long long st = s0, skk = 0, stk = 0;
    const unsigned long long sg0 = stamp_gt_ab();
'''),
    ('''        // k of each owned row, once
''', '''        KARP_ST(0);
        // k of each owned row, once
'''),
    ('''        // the warp's inclusive prefix; K7: the warp's take sum of g - 1
''', '''        { const long long _n = clock64(); skk += _n - st; sc[1] += _n - st;
          st = _n; }
        // the warp's inclusive prefix; K7: the warp's take sum of g - 1
'''),
    ('''        __syncthreads();
        // the prefix before this thread: the earlier warps', then its own
''', '''        KARP_ST(2);
        __syncthreads();
        KARP_ST(3);
        // the prefix before this thread: the earlier warps', then its own
'''),
    ('''        // the takes: clip(n - cum, 0, k) in name order
''', '''        KARP_ST(4);
        // the takes: clip(n - cum, 0, k) in name order
'''),
    ('''        if constexpr (PREEMPT) {
            ttot += tsum;
''', '''        { const long long _n = clock64(); stk += _n - st; sc[5] += _n - st;
          st = _n; }
        if constexpr (PREEMPT) {
            ttot += tsum;
'''),
    ('''    __syncthreads();
    u64 fin = 0;
''', f'''    __syncthreads();
    KARP_ST(6);
    {_FLUSH_N}
    u64 fin = 0;
'''),
]
SLOTS_REDESIGN = {2: "prefetch_issue", 3: "k_pass", 4: "warp_scan_publish",
                  5: "barrier", 6: "prefix_reads", 7: "take_pass",
                  8: "end_barrier", 10: "k_pass_max_thread",
                  11: "take_pass_max_thread", 13: "total"}


def patch(src_dir):
    """Patch the copy's consolidation.cu with the patch whose anchors all
    occur once; returns its slots."""
    path = os.path.join(src_dir, "consolidation.cu")
    with open(path) as f:
        text = f.read()
    for subs, slots in ((PATCH, SLOTS), (PATCH_REDESIGN, SLOTS_REDESIGN)):
        if all(text.count(a) == 1 for a, _ in subs):
            break
    else:
        raise RuntimeError("consolidation.cu: no patch's anchors match")
    for a, b in subs:
        text = text.replace(a, b)
    at = text.index("namespace {")
    text = text[:at] + _HEAD.format(n=PER * LANES) + "\n" + text[at:]
    with open(path, "w") as f:
        f.write(text)
    return slots


def stamps(lib, fn, slots=SLOTS):
    """Run ``fn`` REPS + 1 times with the buffer cleared before each; per
    run and lane the slots; the median over the runs (the first dropped)
    per lane, then over the lanes: cycles a group for the loop's parts,
    cycles for the tail's, and the lanes' span (µs)."""
    import numpy as np
    import torch
    clear, read = lib.karp_stamp_ab_clear, lib.karp_stamp_ab_read
    read.argtypes = [ctypes.c_void_p]
    runs = []
    for _ in range(REPS + 1):
        torch.cuda.synchronize()
        if clear():
            raise RuntimeError("stamp clear failed")
        fn()
        torch.cuda.synchronize()
        buf = np.zeros(PER * LANES, np.uint64)
        if read(buf.ctypes.data):
            raise RuntimeError("stamp read failed")
        runs.append(buf.reshape(LANES, PER).astype(np.int64))
    b = np.median(np.stack(runs[1:]), axis=0)
    b = b[b[:, 0] > 0]
    G = max(int(b[0, 12]), 1)
    out = dict(lanes=int(len(b)), G=int(b[0, 12]),
               span_us=float(b[:, 1].max() - b[:, 0].min()) / 1e3,
               lane_us_median=float(np.median(b[:, 1] - b[:, 0])) / 1e3,
               ghz=float(np.median(b[:, 13] / np.maximum(b[:, 1] - b[:, 0],
                                                         1))))
    per = (2, 3, 4, 5, 6, 10, 11) if slots is SLOTS \
        else (2, 3, 4, 5, 6, 7, 10, 11)
    for k, name in slots.items():
        v = float(np.median(b[:, k]))
        out[name + ("_per_group" if k in per else "")] = v / G if k in per \
            else v
    return out


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k7_captures(cs):
    """Round (c)'s deletions and prescreen inputs and round (d)'s dense
    inputs at BASELINE config 4's 200 nodes, captured from the
    evaluator's calls: {mode: kwargs}."""
    import copy
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.solver.consolidation import \
        CUDAConsolidationEvaluator
    fenv.reset_pod_counter()
    base, cands = examples.config4(fenv.Environment(),
                                   n_nodes=cs.C4_BATCHED)
    ev = CUDAConsolidationEvaluator()
    dl = cs.Captured(ct, "deletions_feasible")
    rp = cs.Captured(ct, "replacements_prescreen")
    examples.single_consolidation_batched(ev, CUDASolver(), base, cands)
    dl.restore()
    rp.restore()
    snaps = [examples.deletion_snapshot(base, c) for c in cands]
    for s_ in snaps:
        s_.existing_nodes = [copy.copy(n) for n in s_.existing_nodes]
    dn = cs.Captured(ct, "deletions_feasible_dense")
    ev.deletions_feasible(snaps)
    dn.restore()
    return dict(deletions=dl.last[1], prescreen=rp.last[1],
                dense=dn.last[1])


def shape_of(kw):
    B, G = kw["n"].shape
    dense = "ex_compat" in kw
    E, D = kw["ex_alloc"].shape[-2:]
    s = dict(B=B, G=G, E=E, D=D)
    if "type_alloc" in kw:
        s.update(T=kw["type_alloc"].shape[0], P=kw["padmit"].shape[0],
                 Sc=kw["compat_tab"].shape[0])
    if not dense:
        s["live_groups"] = int((kw["n"] > 0).sum())
    return s


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    copy = os.path.join(here, "_archive_check", f"stamps_{tag}")
    shutil.rmtree(copy, ignore_errors=True)
    pkg_name = "karpenter_provider_aws_tpu_torch"
    shutil.copytree(os.path.join(root, pkg_name),
                    os.path.join(copy, pkg_name),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    slots = patch(os.path.join(copy, pkg_name, "csrc"))
    sys.path.insert(0, copy)
    os.chdir(copy)
    cs = _load("k7k8_stamps_smoke", os.path.join(here, "chip_smoke.py"))

    import torch
    import karpenter_provider_aws_tpu_torch as pkg
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch as pt
    if not os.path.abspath(pkg.__file__).startswith(copy + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    lib = fc._lib()
    out = dict(card=cs.smi_line())

    _, _, tables, wide = cs.preempt_phase(cs.Compare())
    for g, t in [(int(tables[3].shape[0]), tables)] + sorted(wide.items()):
        if not torch.equal(pt.preempt_solve(*t), pt._preempt_solve_ref(*t)):
            raise AssertionError(f"the instrumented K8 at G = {g} != plain")
        B, E, D = t[5].shape
        out[f"preempt_G{g}"] = dict(
            B=B, E=E, D=D, us_instrumented=cs.time_launches(
                lambda: pt.preempt_solve(*t), reps=10) * 1e3,
            stamps=stamps(lib, lambda: pt.preempt_solve(*t), slots))
    caps = k7_captures(cs)
    for mode, fn, ref in (
            ("deletions", ct.deletions_feasible, ct._deletions_feasible_ref),
            ("prescreen", ct.replacements_prescreen,
             ct._replacements_prescreen_ref),
            ("dense", ct.deletions_feasible_dense,
             ct._deletions_feasible_dense_ref)):
        kw = caps[mode]
        if not torch.equal(fn(**kw), ref(**kw)):
            raise AssertionError(f"the instrumented {mode} != plain")
        out[mode] = dict(shape=shape_of(kw), us_instrumented=cs.time_launches(
            lambda: fn(**kw)) * 1e3,
            stamps=stamps(lib, lambda: fn(**kw), slots))
    print("STAMPS", tag, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
