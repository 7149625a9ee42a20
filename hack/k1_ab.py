"""Time K1's output pack (``pack_outputs``) of one checkout of the port on a
card.

Runs, with the given checkout's package and this tree's ``chip_smoke.py``
(its helpers call only interfaces both trees have: the solver and
``ffd_cuda.pack_outputs_lanes``; an older checkout's pruned pack, which
asks for a trailing word with ``extra=`` and copies the bail word in
after the launch, is replayed so by ``replay``), the packs of the main
paths: BASELINE
config 2 at 50,000 pods (``CUDASolver(incremental=False).solve``, one
lane), the batches at B = 8 and 64 (``solve_batch`` on
``examples.batch_snapshots``) and config 7's pruned solve (50,000 pods,
10,000 signatures; one lane whose row ends with the bail word). Each is
solved once with the pack watched (``chip_smoke.capture_pack``), then the
pack is replayed on its own inputs (``chip_smoke.pack_times``: the rows
held to the plain version's, µs a call by CUDA events, the bound from the
bytes it must move, the CUDA kernels one call issues by the profiler);
config 2's and each batch's whole dispatch are timed too
(``chip_smoke.solve_device_ms``). Each pack is read READINGS times by
``chip_smoke.time_launches``, each reading beside the host's enqueue of
its timed calls (``watch_drain``): where the enqueue outlasts the
card's time of the 20M-cycle sleep before them (``sleep_ms``), the queue
drained and that mean counts the host's gaps. Prints one line ``AB <tag>
{json}``. To
compare two builds, run it on both checkouts in one call to the card, in
the order P N N P:

    for v in p n n p; do python3 hack/k1_ab.py path/to/$v $v; done
"""
import importlib.util
import json
import os
import sys
import time

#: the batch widths and config 7's size (chip_smoke's phases 8 and 9)
BATCHES = (8, 64)
C7 = dict(n_pods=50_000, n_sigs=10_000)
#: ``time_launches`` readings of each pack
READINGS = 5


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    spec = importlib.util.spec_from_file_location(
        "k1_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch
    import karpenter_provider_aws_tpu_torch as pkg
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}, not "
                           f"from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    dev = torch.device("cuda")
    drain = watch_drain(cs)
    out = dict(card=cs.smi_line(), sleep_ms=drain["sleep_ms"])

    def spied(solver, method):
        """Watch ``solver.<method>``: the list of its (args, kwargs)."""
        calls, orig = [], getattr(solver, method)

        def spy(*a, **kw):
            calls.append((a, kw))
            return orig(*a, **kw)
        setattr(solver, method, spy)
        return calls

    fenv.reset_pod_counter()
    env = fenv.Environment()
    snap = examples.config2(env, 50_000)
    solver = CUDASolver(incremental=False)
    disp = spied(solver, "_dispatch")
    _, packs = cs.capture_pack(lambda: solver.solve(snap))
    (buf,), statics = disp[-1]
    d_buf = torch.from_numpy(buf).to(dev)
    out["config2"] = dict(pack_times(cs, drain, *packs[-1]), solve_device_ms=(
        cs.solve_device_ms(lambda: ft.solve_scan_packed1(d_buf, **statics))))
    del snap, solver, d_buf

    for B in BATCHES:
        fenv.reset_pod_counter()
        snaps = examples.batch_snapshots(fenv.Environment(), batch=B,
                                         n_sigs=96)
        solver = CUDASolver(incremental=False)
        disp = spied(solver, "_dispatch_many")
        _, packs = cs.capture_pack(lambda: solver.solve_batch(snaps))
        (bufs,), statics = disp[-1]
        d_bufs = torch.from_numpy(np.stack(bufs)).to(dev)
        out[f"batch{B}"] = dict(pack_times(cs, drain, *packs[-1]),
                                solve_device_ms=cs.solve_device_ms(
            lambda: ft.solve_scan_packed1_many(d_bufs, **statics), reps=5))
        del snaps, solver, d_bufs

    fenv.reset_pod_counter()
    snap = examples.config7(fenv.Environment(), **C7)
    solver = CUDASolver()
    _, packs = cs.capture_pack(lambda: solver.solve(snap))
    ds = solver.last_dispatch_stats
    if ds["kernel"] != "pruned":
        raise AssertionError(f"config 7 ran {ds['kernel']}")
    out["config7_pruned"] = pack_times(cs, drain, *packs[-1])
    print("AB", tag, json.dumps(out), flush=True)
    return 0


def pack_times(cs, drain, a, kw):
    """``chip_smoke.pack_times`` of a captured pack call, replayed as its
    checkout makes it (``replay``), and READINGS readings of its µs, each
    (µs, the host's enqueue ms; ``watch_drain``)."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    kw, fn = replay(a, kw)
    out = cs.pack_times(a, kw, fn=fn)
    reads = [drain["readings"][-1]]
    if fn is None:
        def fn():
            return fc.pack_outputs_lanes(*a, **kw)
    for _ in range(READINGS - 1):
        cs.time_launches(fn)
        reads.append(drain["readings"][-1])
    out["readings"] = reads
    return out


def watch_drain(cs):
    """Wrap ``cs.time_launches`` (its statistic unchanged) so that each
    reading is logged as (µs a call, the host's ms from the start of the
    first timed call to the start of the last), and time its 20M-cycle
    sleep kernel on the card once: {"sleep_ms", "readings"}. A reading
    whose enqueue outlasts the sleep let the queue drain."""
    import torch
    orig = cs.time_launches
    log = dict(sleep_ms=orig(lambda: torch.cuda._sleep(20_000_000),
                             reps=3), readings=[])

    def timed(fn, reps=50, setup=None):
        t = []

        def g():
            t.append(time.perf_counter())
            return fn()
        ms = orig(g, reps=reps, setup=setup)
        log["readings"].append((ms * 1e3, (t[-1] - t[-reps]) * 1e3))
        return ms
    cs.time_launches = timed
    return log


def replay(a, kw):
    """A captured call's kwargs in this tree's interface (``bail=``) and
    the function that replays it: None (``pack_outputs_lanes(*a, **kw)``)
    but for an older checkout's pruned pack (``extra=1``), which copies
    the carry's bail word into the trailing word after the launch."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    if not kw.get("extra"):
        return kw, None

    def fn():
        out = fc.pack_outputs_lanes(*a, **kw)
        out[:, -1] = a[2].bail[:, 0].long()
        return out
    return {"bail": a[2].bail}, fn


if __name__ == "__main__":
    sys.exit(main())
