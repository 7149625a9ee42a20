"""Time K1's unpack (``unpack_bits``) and the suffix re-solve's first
launches, of one checkout of the port on a card.

A checkout either unpacks the arena and then loads the suffix's resume row
with ``ffd_bank_load`` (two launches) or does both in one launch
(``ffd_cuda.unpack_bits_load``). With the given checkout's package and
this tree's ``chip_smoke.py`` helpers, it reads, each by
``chip_smoke.time_launches`` (READINGS readings, each beside the host's
enqueue of its timed calls, ``k1_ab.watch_drain``: where the enqueue
outlasts the sleep before them, the queue drained):

- ``unpack_bits`` at one lane on the arenas of BASELINE config 2 (50,000
  pods), config 7 (50,000 pods, 10,000 signatures; the pruned scan's) and
  the 50,000-pod warm cluster, and ``unpack_bits_lanes`` on the batches'
  stacks at B = 8 and 64 (``examples.batch_snapshots``), each with its
  bound from the bytes it must move;
- the suffix's first launches at the warm arena and at config 2's shape
  (a bank of its carry): the unpack alone, and the loading unpack (one
  launch) or the unpack then ``ffd_bank_load`` (the parent's two);
- where the checkout has the loading unpack: the lane-axis unpack with a
  16-entry table in shared memory in place of ``expand4``'s multiply (a
  copy of its ``csrc/packed_io.cu`` built alone into a temporary
  directory), its rows checked against the checkout's;
- the warm phase (``chip_smoke.warm_tick_phase``: 60 suffix ticks, p50,
  launches a tick), the warm arena's device ms a suffix re-solve
  (``chip_smoke.warm_solve_times``) and the host's enqueue of one
  (``k3_k9_ab.suffix_enqueue_ms``).

Prints one line ``AB <tag> {json}``. To compare two builds, run it on
both checkouts in one call to the card, in the order P N N P:

    for v in p n n p; do python3 hack/k1_k3_ab.py path/to/$v $v; done
"""
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

#: ``time_launches`` readings of each timed launch
READINGS = 5
#: the batch widths and config 7's size (chip_smoke's phases 8 and 9)
BATCHES = (8, 64)
C7 = dict(n_pods=50_000, n_sigs=10_000)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sections(st):
    """(i64 words, bools) of an arena at the statics ``st``."""
    from karpenter_provider_aws_tpu_torch.ops.hostpack import (
        in_layout_bool, in_layout_i64, layout_sizes)
    args = [st.get(k, 0) for k in "T D Z C G E P K M".split()]
    F, Q = st.get("F", 1), st.get("Q", 0)
    return (layout_sizes(in_layout_i64(*args, F, Q)),
            layout_sizes(in_layout_bool(*args, F, Q)))


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    cs = _load("k1k3_smoke", os.path.join(here, "chip_smoke.py"))
    k1 = _load("k1k3_k1", os.path.join(here, "hack", "k1_ab.py"))
    k3k9 = _load("k1k3_k3k9", os.path.join(here, "hack", "k3_k9_ab.py"))

    import numpy as np
    import torch
    import karpenter_provider_aws_tpu_torch as pkg
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.solver.incremental import \
        live_bound
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}, not "
                           f"from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    folded = hasattr(fc, "unpack_bits_load")
    pt = fc.build_info()["ptxas"].splitlines()
    drain = k1.watch_drain(cs)
    out = dict(card=cs.smi_line(), folded=folded,
               sleep_ms=drain["sleep_ms"],
               ptxas=[" ".join(x.strip() for x in pt[i:i + 3])
                      for i, line in enumerate(pt)
                      if "Compiling entry" in line and "unpack" in line])
    lut = lut_unpack(root) if folded else None

    def reads(fn):
        """READINGS readings of ``fn``: [(µs, enqueue ms)]."""
        r = []
        for _ in range(READINGS):
            cs.time_launches(fn)
            r.append(drain["readings"][-1])
        return r

    def unpack_rec(bufs, st):
        """The unpack of a [B, W] stack (B = 1: the one-lane wrapper)."""
        n_i64, nbits = sections(st)
        words = bufs[:, n_i64:]
        B = words.shape[0]
        nbytes = B * (words.shape[1] * 8 + nbits)
        rec = dict(lanes=B, nbits=nbits,
                   bound_us=cs.bound_ms(nbytes, 0)[0] * 1e3)
        if B == 1:
            w = words[0]
            rec["unpack"] = reads(lambda: fc.unpack_bits(w, nbits))
        else:
            rec["unpack"] = reads(lambda: fc.unpack_bits_lanes(words,
                                                               nbits))
        if lut is not None:
            if not torch.equal(lut(words, nbits),
                               fc.unpack_bits_lanes(words, nbits)):
                raise AssertionError("the table unpack != the unpack")
            rec["unpack_table"] = reads(lambda: lut(words, nbits))
        return rec

    def first_launches(buf, st, bs, j):
        """The suffix's first launches on ``buf`` with row j of ``bs``."""
        n_i64, nbits = sections(st)
        words = buf[n_i64:]
        rec = dict(row_bytes=sum(c.numel() * c.element_size()
                                 for c in bs.carry),
                   unpack=reads(lambda: fc.unpack_bits(words, nbits)))
        if folded:
            rec["unpack_load"] = reads(
                lambda: fc.unpack_bits_load(words, nbits, bs, j))
        else:
            def both():
                fc.unpack_bits(words, nbits)
                fc.ffd_bank_load(bs, j)
            rec["bank_load"] = reads(lambda: fc.ffd_bank_load(bs, j))
            rec["unpack_then_load"] = reads(both)
        return rec

    def packed(snap, n_max=None):
        enc = encode_snapshot(snap)
        solver = CUDASolver(incremental=False)
        buf, st = solver.pack(enc, *full_existing_encode(enc, sorted(
            snap.existing_nodes, key=lambda n: n.name)))
        return buf, dict(st, n_max=n_max or solver._bucket)

    def spied(solver, method):
        calls, orig = [], getattr(solver, method)

        def spy(*a, **kw):
            calls.append((a, kw))
            return orig(*a, **kw)
        setattr(solver, method, spy)
        return calls

    fenv.reset_pod_counter()
    buf2, st2 = packed(cs.config2(fenv, fenv.Environment(), cs.PODS))
    d2 = torch.from_numpy(buf2).cuda()
    out["config2"] = unpack_rec(d2[None], st2)
    n_i64, nbits = sections(st2)
    inp = ft._packed_inputs_ref(d2, *(st2[k] for k in
                                      "T D Z C G E P K M Q".split()))
    c2 = ft.carry0(inp, st2["E"] + st2["n_max"], st2["E"])
    bank2 = fc.empty_bank(c2, 2)
    for b in bank2:
        b.zero_()
    out["config2_first_launches"] = first_launches(
        d2, st2, fc.BankState(c2, bank2), 1)
    del d2, inp

    fenv.reset_pod_counter()
    solver = CUDASolver()
    calls = spied(solver, "_dispatch_pruned")
    solver.solve(examples.config7(fenv.Environment(), **C7))
    (buf7,), st7 = calls[-1]
    out["config7"] = unpack_rec(torch.from_numpy(buf7).cuda()[None], st7)
    del solver, buf7

    for B in BATCHES:
        fenv.reset_pod_counter()
        snaps = examples.batch_snapshots(fenv.Environment(), batch=B,
                                         n_sigs=96)
        solver = CUDASolver(incremental=False)
        calls = spied(solver, "_dispatch_many")
        solver.solve_batch(snaps)
        (bufs,), st = calls[-1]
        out[f"batch{B}"] = unpack_rec(
            torch.from_numpy(np.stack(bufs)).cuda(), st)
        del snaps, solver

    wsnap, _ = examples.warm_cluster(pods=cs.WARM_PODS,
                                     pending_frac=cs.WARM_PENDING)
    bufw, stw = packed(wsnap(), n_max=16)
    glw = live_bound(bufw, T=stw["T"], D=stw["D"], G=stw["G"], CK=cs.CK)
    dw = torch.from_numpy(bufw).cuda()
    out["warm"] = unpack_rec(dw[None], stw)
    _, bankw = ft.solve_scan_packed1_ckpt(dw, CK=cs.CK,
                                          **examples.solve_statics(stw))
    jw = glw // cs.CK - min(3, glw // cs.CK)
    out["warm_first_launches"] = first_launches(
        dw, stw, fc.BankState(ft.bank_row(bankw, jw), bankw), jw)
    out["warm_device_ms"] = cs.warm_solve_times(dw, stw, glw)
    out["warm_suffix_enqueue_ms"] = k3k9.suffix_enqueue_ms(dw, stw, glw)
    launches, summary = cs.warm_tick_phase()
    out["warm_phase"] = dict(
        p50_ms=summary["p50_ms"], p99_ms=summary["p99_ms"],
        modes=summary["modes"],
        launches_per_tick=summary["launches_per_tick"])
    out["readings_kept_rule"] = "enqueue ms < sleep_ms"
    print("AB", tag, json.dumps(out), flush=True)
    return 0


#: ``expand4`` as csrc/packed_io.cu writes it, and a table in shared
#: memory in its place (the unpack kernel fills it before its units)
MULTIPLY = """__device__ __forceinline__ unsigned expand4(unsigned x) {
    return ((x & 15u) * 0x00204081u) & 0x01010101u;
}"""
TABLE = """__device__ __forceinline__ unsigned expand4(unsigned x) {
    extern __shared__ unsigned karp_nibbles[];
    return karp_nibbles[x & 15u];
}"""
KERNEL_HEAD = """    const unsigned lane = grid_lane();
    if (lane >= L) return;   // the (y, z) grid's spare lanes
    unpack_unit("""
KERNEL_HEAD_TABLE = """    const unsigned lane = grid_lane();
    if (lane >= L) return;   // the (y, z) grid's spare lanes
    extern __shared__ unsigned karp_nibbles[];
    if (threadIdx.x < 16)
        karp_nibbles[threadIdx.x] =
            (threadIdx.x * 0x00204081u) & 0x01010101u;
    __syncthreads();
    unpack_unit("""
LAUNCH = "unpack_bits_kernel<<<grid, kThreads, 0,"
LAUNCH_TABLE = "unpack_bits_kernel<<<grid, kThreads, 64,"


def lut_unpack(root):
    """The checkout's lane-axis unpack with the table in place of the
    multiply, built alone: a function (words [L, nw] view, nbits) ->
    bool [L, nbits] on the current stream."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    csrc = os.path.join(root, "karpenter_provider_aws_tpu_torch", "csrc")
    with open(os.path.join(csrc, "packed_io.cu")) as f:
        src = f.read()
    for old, new in ((MULTIPLY, TABLE), (KERNEL_HEAD, KERNEL_HEAD_TABLE),
                     (LAUNCH, LAUNCH_TABLE)):
        if src.count(old) != 1:
            raise RuntimeError(f"packed_io.cu has no single {old!r}")
        src = src.replace(old, new)
    tmp = tempfile.mkdtemp()
    cu, so = os.path.join(tmp, "packed_io_table.cu"), os.path.join(
        tmp, "libtable.so")
    with open(cu, "w") as f:
        f.write(src)
    p = subprocess.run([fc._nvcc(), *fc.NVCC_FLAGS, "-I", csrc, "-shared",
                        cu, "-o", so], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}\n{p.stderr}")
    lib = ctypes.CDLL(so)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.karp_unpack_bits.argtypes = [vp, ll, vp, ll, ll, vp]
    lib.karp_unpack_bits.restype = ctypes.c_int

    def unpack(words, nbits):
        out = torch.empty((words.shape[0], nbits), dtype=torch.bool,
                          device=words.device)
        err = lib.karp_unpack_bits(
            words.data_ptr(), nbits, out.data_ptr(), words.shape[0],
            words.stride(0), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the table unpack failed: error {err}")
        return out
    return unpack


if __name__ == "__main__":
    sys.exit(main())
