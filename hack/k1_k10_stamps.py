"""Stamp where K1's ``pack_outputs`` and K10's ``mesh_new_caps`` spend a
launch, in an instrumented copy of one checkout of the port on a card.

Copies the checkout's package into the git-ignored
``_archive_check/stamps_<tag>/``, patches its ``csrc/packed_io.cu`` and
``csrc/mesh.cu`` with stamps (``%globaltimer`` at each CTA's start and
end, thread 0's ``clock64`` at the kernel's phases, the most cycles any
thread spent in each part, into a ``__device__`` buffer that two added C
entries clear and read), builds the copy and runs from it, with this
tree's ``chip_smoke.py`` and ``hack/k10_ab.py`` helpers:

- the pack of BASELINE config 2 at 50,000 pods and of a batch of 64
  lanes (``examples.batch_snapshots``; each the solve's own pack call,
  captured and replayed): the stamps (every CTA of every lane), and each
  CUDA kernel that one call issues with its device time and start by
  ``torch.profiler``;
- the caps at the tp cell's shape (T = 812, G = 4) and at the ceiling's
  (T = 812, G = 64), on the states ``chip_smoke.caps_states`` cuts.

It knows the kernels of 9006dee (a thread an output word; G x P CTAs of
256 threads, a thread walking types in turn) and the one-launch pack and
the cluster caps that followed. Each stamp is the median over REPS
launches (the first discarded). Cycles are thread 0's own, from its
entry; a stamp after a load that only feeds a store does not wait for
it. Prints one line ``STAMPS <tag> {json}``:

    python3 hack/k1_k10_stamps.py path/to/checkout tag
"""
import ctypes
import importlib.util
import json
import os
import shutil
import statistics
import sys

REPS = 7
#: words of each file's stamp buffer
WORDS = 1 << 16

_HEAD = r'''
// ---- stamps (hack/k1_k10_stamps.py) ----
__device__ unsigned long long karp_stamp_{f}[{n}];
__device__ __forceinline__ unsigned long long stamp_gt_{f}() {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}}
extern "C" int karp_stamp_{f}_clear() {{
    void* p = nullptr;
    cudaGetSymbolAddress(&p, karp_stamp_{f});
    return (int)cudaMemset(p, 0, sizeof(karp_stamp_{f}));
}}
extern "C" int karp_stamp_{f}_read(void* dst) {{
    return (int)cudaMemcpyFromSymbol(dst, karp_stamp_{f},
                                     sizeof(karp_stamp_{f}));
}}
'''

# Each patch: (anchor, replacement); every anchor must occur exactly once.
# Slots a CTA: 8 words for the pack, 16 for the caps.
_STAMP_PK = f'''
    const long long sc0 = clock64();
    const size_t sx = ((size_t)blockIdx.z * gridDim.y + blockIdx.y)
        * gridDim.x + blockIdx.x;
    const bool sl = sx < {WORDS // 8};
    unsigned long long* sb = karp_stamp_pk + 8 * (sl ? sx : 0);
    if (sl && threadIdx.x == 0) sb[0] = stamp_gt_pk();
'''


def _exit_pk(k):
    return (f"if (sl) {{ atomicMax(sb + 1, stamp_gt_pk()); "
            f"atomicMax(sb + {k}, (unsigned long long)(clock64() - sc0)); }}")


PATCHES = {
    # 9006dee: a thread an output word
    "pack_parent": ("packed_io.cu", "pk", [
        (_W := '''    if (w >= w32 + nwb) return;''', _W + _STAMP_PK),
        ('''        out[w] = (i64)(lo | (hi << 32));
        return;''', f'''        out[w] = (i64)(lo | (hi << 32));
        {_exit_pk(2)}
        return;'''),
        ('''    out[w] = (i64)word;
}''', f'''    out[w] = (i64)word;
    {_exit_pk(3)}
}}'''),
    ]),
    # the one-launch pack: scalar warps, then bit warps
    "pack_one_launch": ("packed_io.cu", "pk", [
        (_L := '''    if (lane >= a.L) return;''', _L + _STAMP_PK),
        ('''            pack_scalar(a, lane, s, n64, w32, nwb, out);
        return;''', f'''            pack_scalar(a, lane, s, n64, w32, nwb, out);
        {_exit_pk(2)}
        return;'''),
        ('''                                       | ((u64)(m2 | (m3 << 16)) << 32));
    }
}''', f'''                                       | ((u64)(m2 | (m3 << 16)) << 32));
    }}
    {_exit_pk(3)}
}}'''),
    ]),
    # 9006dee: G x P CTAs of 256 threads, each thread types in turn
    "caps_parent": ("mesh.cu", "mc", [
        ('''    const i64* dmn = a.daemon + (g * P + pi) * D;
''', '''    const i64* dmn = a.daemon + (g * P + pi) * D;
    const long long sc0 = clock64();
    unsigned long long* sb = karp_stamp_mc + 16 * (size_t)blockIdx.x;
    if (threadIdx.x == 0) sb[0] = stamp_gt_mc();
'''),
        ('''    i64 cmax = 0;
    for (i64 t = threadIdx.x; t < T; t += blockDim.x) {
        if (!new_node_cand(a, g, pi, t)) continue;
        i64 hr = headroom(a.A + t * D, dmn, R, D);
        cmax = hr > cmax ? hr : cmax;
    }
    const i64 cap = block_max(cmax, red);   // its barriers publish dyn
''', '''    i64 cmax = 0;
    long long scc = 0, sch = 0;
    unsigned long long sn = 0;
    const long long sl0 = clock64();
    for (i64 t = threadIdx.x; t < T; t += blockDim.x) {
        const long long x0 = clock64();
        const bool cand = new_node_cand(a, g, pi, t);
        const long long x1 = clock64();
        scc += x1 - x0;
        if (!cand) continue;
        i64 hr = headroom(a.A + t * D, dmn, R, D);
        cmax = hr > cmax ? hr : cmax;
        sn += hr == 0;
        sch += clock64() - x1;
    }
    const long long sl1 = clock64();
    atomicMax(sb + 4, (unsigned long long)scc);
    atomicMax(sb + 5, (unsigned long long)sch);
    atomicMax(sb + 6, (unsigned long long)(sl1 - sl0));
    atomicAdd(sb + 7, sn);
    if (threadIdx.x == 0) sb[2] = sl1 - sc0;
    const i64 cap = block_max(cmax, red);   // its barriers publish dyn
    if (threadIdx.x == 0) {
        sb[3] = clock64() - sc0;
        sb[1] = stamp_gt_mc();
    }
'''),
    ]),
    # the cluster caps: X CTAs of 128 threads a (group, pool)
    "caps_cluster": ("mesh.cu", "mc", [
        ('''    if (X > 1) cluster_arrive_relaxed();
''', '''    if (X > 1) cluster_arrive_relaxed();
    const long long sc0 = clock64();
    unsigned long long* sb = karp_stamp_mc + 16 * (size_t)blockIdx.x;
    if (tid == 0) sb[0] = stamp_gt_mc();
'''),
        ('''    for (i64 i = tid; i < K * V; i += blockDim.x) dyn[i] = 0;
    __syncthreads();
''', '''    for (i64 i = tid; i < K * V; i += blockDim.x) dyn[i] = 0;
    __syncthreads();
    if (tid == 0) sb[2] = clock64() - sc0;
'''),
        ('''    i64 cmax = 0;
    for (i64 t = t0 + tid; t < t1; t += blockDim.x) {''', '''    i64 cmax = 0;
    const long long sl0 = clock64();
    for (i64 t = t0 + tid; t < t1; t += blockDim.x) {'''),
        ('''    const i64 cap = block_max(cmax, red);   // its barriers publish dyn
''', '''    atomicMax(sb + 7, (unsigned long long)(clock64() - sl0));
    if (tid == 0) sb[3] = clock64() - sc0;
    const i64 cap = block_max(cmax, red);   // its barriers publish dyn
    if (tid == 0) sb[4] = clock64() - sc0;
'''),
        ('''        for (i64 i = tid; i < K * V; i += blockDim.x) h1n[i] = dyn[i];
        return;''', '''        for (i64 i = tid; i < K * V; i += blockDim.x) h1n[i] = dyn[i];
        if (tid == 0) sb[1] = stamp_gt_mc();
        return;'''),
        ('''    cluster_wait();   // every CTA of the cluster has started
''', '''    cluster_wait();   // every CTA of the cluster has started
    if (tid == 0) sb[5] = clock64() - sc0;
'''),
        ('''    cl.sync();
''', '''    cl.sync();
    if (tid == 0) {
        sb[6] = clock64() - sc0;
        sb[1] = stamp_gt_mc();
    }
'''),
    ]),
}

#: what each slot holds, by patch
SLOTS = {
    "pack_parent": {2: "takes_thread_cycles_max",
                    3: "bit_thread_cycles_max"},
    "pack_one_launch": {2: "scalar_thread_cycles_max",
                        3: "bit_thread_cycles_max"},
    "caps_parent": {2: "t0_after_type_loop", 3: "t0_after_block_max",
                    4: "cand_cycles_max", 5: "headroom_cycles_max",
                    6: "loop_cycles_max", 7: "zero_headrooms"},
    "caps_cluster": {2: "t0_after_staging", 3: "t0_after_type_loop",
                     4: "t0_after_block_max", 5: "t0_after_cluster_wait",
                     6: "t0_after_cluster_sync", 7: "loop_cycles_max"},
}


def patch(src_dir):
    """Patch the copy's sources in place; returns the patches applied,
    one a file (the one whose anchors all occur once)."""
    applied = []
    for fname in ("packed_io.cu", "mesh.cu"):
        path = os.path.join(src_dir, fname)
        with open(path) as f:
            text = f.read()
        for name, (pf, tag, subs) in PATCHES.items():
            if pf != fname or not all(text.count(a) == 1 for a, _ in subs):
                continue
            for a, b in subs:
                text = text.replace(a, b)
            head = _HEAD.format(f=tag, n=WORDS)
            at = text.index("namespace {")
            text = text[:at] + head + "\n" + text[at:]
            applied.append(name)
            break
        else:
            raise RuntimeError(f"{fname}: no patch's anchors match")
        with open(path, "w") as f:
            f.write(text)
    return applied


def stamps(lib, tag, fn, slots):
    """Run ``fn`` REPS + 1 times with the ``tag`` buffer cleared before
    each; per run the CTAs' span (first start to last end, µs), the
    median CTA's duration and each slot's median over the CTAs that
    wrote it (and its max); the medians of those over the runs (the
    first dropped)."""
    import numpy as np
    import torch
    clear = getattr(lib, f"karp_stamp_{tag}_clear")
    read = getattr(lib, f"karp_stamp_{tag}_read")
    read.argtypes = [ctypes.c_void_p]
    per = 8 if tag == "pk" else 16
    runs = []
    for _ in range(REPS + 1):
        torch.cuda.synchronize()
        if clear():
            raise RuntimeError("stamp clear failed")
        fn()
        torch.cuda.synchronize()
        buf = np.zeros(WORDS, np.uint64)
        if read(buf.ctypes.data):
            raise RuntimeError("stamp read failed")
        b = buf.reshape(-1, per).astype(np.int64)
        b = b[b[:, 0] > 0]
        r = dict(ctas=int(len(b)),
                 span_us=float(b[:, 1].max() - b[:, 0].min()) / 1e3,
                 start_spread_us=float(b[:, 0].max() - b[:, 0].min()) / 1e3,
                 cta_us_median=float(np.median(b[:, 1] - b[:, 0])) / 1e3)
        for k, name in slots.items():
            v = b[:, k][b[:, k] > 0]
            r[name] = float(np.median(v)) if len(v) else 0.0
            r[name + "_max"] = float(v.max()) if len(v) else 0.0
        runs.append(r)
    runs = runs[1:]
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def profile_kernels(fn):
    """Each CUDA kernel of one call of ``fn`` by ``torch.profiler``: name,
    start (µs after the first kernel's) and device µs; the median of
    REPS traces that show device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(3 * REPS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        if ev:
            t0 = ev[0].time_range.start
            traces.append([(e.name, e.time_range.start - t0,
                            e.time_range.elapsed_us()) for e in ev])
        if len(traces) == REPS:
            break
    if not traces:
        raise AssertionError("no profiler trace showed a device event")
    out = []
    for i, (name, _, _) in enumerate(traces[0]):
        out.append(dict(name=name[:80],
                        start_us=statistics.median(t[i][1] for t in traces),
                        us=statistics.median(t[i][2] for t in traces)))
    return out


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    copy = os.path.join(here, "_archive_check", f"stamps_{tag}")
    shutil.rmtree(copy, ignore_errors=True)
    pkg_name = "karpenter_provider_aws_tpu_torch"
    shutil.copytree(os.path.join(root, pkg_name),
                    os.path.join(copy, pkg_name),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    applied = patch(os.path.join(copy, pkg_name, "csrc"))
    sys.path.insert(0, copy)
    os.chdir(copy)

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    cs = load("stamps_smoke", os.path.join(here, "chip_smoke.py"))
    ab = load("stamps_k10ab", os.path.join(here, "hack", "k10_ab.py"))
    k1 = load("stamps_k1ab", os.path.join(here, "hack", "k1_ab.py"))

    import torch
    import karpenter_provider_aws_tpu_torch as pkg
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    if not os.path.abspath(pkg.__file__).startswith(copy + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    ab.here_examples(here)
    lib = fc._lib()
    out = dict(card=cs.smi_line(), patches=applied)
    pk = next(p for p in applied if p.startswith("pack"))
    cp = next(p for p in applied if p.startswith("caps"))

    def pack(solve):
        """The stamps of the last pack call of ``solve()``, replayed."""
        _, packs = cs.capture_pack(solve)
        a, kw = packs[-1]
        kw, fn = k1.replay(a, kw)
        if fn is None:
            def fn():
                return fc.pack_outputs_lanes(*a, **kw)
        if not torch.equal(fn(), cs.pack_plain(a, kw)):
            raise AssertionError("the instrumented pack != the plain rows")
        return dict(lanes=int(a[0].shape[0]),
                    us_instrumented=cs.time_launches(fn) * 1e3,
                    kernels=profile_kernels(fn),
                    stamps=stamps(lib, "pk", fn, SLOTS[pk]))
    fenv.reset_pod_counter()
    snap = examples.config2(fenv.Environment(), 50_000)
    out["pack_config2"] = pack(
        lambda: CUDASolver(incremental=False).solve(snap))
    fenv.reset_pod_counter()
    snaps = examples.batch_snapshots(fenv.Environment(), batch=64,
                                     n_sigs=96)
    out["pack_batch64"] = pack(
        lambda: CUDASolver(incremental=False).solve_batch(snaps))
    del snap, snaps

    c2 = ab.config2_arrays()
    dev = torch.device("cuda")
    states = cs.caps_states({"tp": c2}, ab.ceiling_slab(), dev)
    for name in ("tp", "ceiling"):
        st = states[name]
        want = st.clone()
        mc._new_caps_ref(want)
        mc.mesh_new_caps(st)
        if not torch.equal(st.caps, want.caps):
            raise AssertionError(f"the instrumented caps at {name} != plain")
        X = mc.caps_cluster(st.T, st.K) if cp == "caps_cluster" else 1
        out[f"caps_{name}"] = dict(
            T=st.T, G=st.G, P=st.P, ctas=st.G * st.P * X,
            us_instrumented=cs.time_launches(
                lambda: mc.mesh_new_caps(st)) * 1e3,
            stamps=stamps(lib, "mc", lambda: mc.mesh_new_caps(st),
                          SLOTS[cp]))
    print("STAMPS", tag, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
