"""Time the sharded scan's group step (K10) of one checkout of the port on
a card.

Runs, with the given checkout's package and this tree's ``chip_smoke.py``
(its timing helpers call only interfaces both trees have), at world size
1 on NCCL: the mesh cells (``examples.MESH_CELLS``: config 2 at 50,000
pods on the type mesh, N = 256, and at 500,000 pods, N = 1,024), each
``CUDASolver(mesh=, force_mesh=True)`` solved once to settle its bucket,
then timed (p50 and median split), then the four K10 kernels at each
cell's last group step beside their bounds (``k10_times``); the
distributed ceiling (``examples.DIST_CEILING_SHAPE``, 1,000,064+ pods,
N = 4,224) through ``dispatch_dist``, its full tick, then patch ticks
(p50 and median split), the K10 kernels at its last group step at world
size 1 (``k10_times``, all 4,224 slots and 812 types on one rank), and
one group step of rank 0's shard of the 2 x 2 layout (Nl = 2,112, Tl =
406) launch by launch (``k11_times``); the
ceiling's step loop at world 1 (``parallel/mesh.py`` ``_mesh_scan``, five
launches a step, 64 steps) enqueued on the card (the host's time a step
and the card's span) and behind a sleep kernel (the host alone, as
``chip_smoke.py`` phase 8 takes it for config 7); then, with no process
group in this process, the ceiling on 2 hosts x 2 gloo ranks sharing the
card (``MeshGroup``): its full tick and patch ticks. ``k10_times`` also
times each ``mesh_fill`` phase (a, b, c and the one-launch fill) at
``examples.FILL_SHAPES`` (Nl = 256, 512, 2,112 and 4,224 rows, one pool
and eight with limits; ``fill_shapes_us``). ``mesh_new_caps`` is timed
at its main paths' shapes (``chip_smoke.caps_shape_times``: the tp cell
at world 1 and its rank of four gloo ranks, Tl = 203, the 500,000-pod
cell's rank of 2 x 2, Tl = 406, K11's shard and the ceiling at world 1,
and ``CAPS_CASES``' ``tp_floors`` with minValues floors; ``caps``), each
read READINGS times beside the host's enqueue (``k1_ab.watch_drain``). A third argument cuts the run to some of ``PARTS`` (``fill``:
those fill times alone; ``k11``: K11's step alone; ``caps``: the caps
alone, on config 2's arrays at 50,000 pods without a solve). Prints one
line ``AB <tag> {json}``. To compare two builds, run it on both
checkouts in one call to the card, in the order P N N P:

    for v in p n n p; do python3 hack/k10_ab.py path/to/$v $v; done
    for v in p n n p; do python3 hack/k10_ab.py path/to/$v $v fill,k11; done
    for v in p n n p; do python3 hack/k10_ab.py path/to/$v $v caps; done
"""
import datetime
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

#: timed solves of each mesh cell and patch ticks of the ceiling after
#: one warm-up; windows of the host-alone enqueue
ROUNDS = 5
HOST_REPS = 5
#: ``time_launches`` readings of each caps shape
READINGS = 3

#: what a run can be cut to (a third argument, comma-separated): the mesh
#: cells with everything at world 1 and on 2 x 2 gloo ranks (the K10
#: kernels at each cell, the fill's phases at ``examples.FILL_SHAPES``
#: and the caps at their shapes among them), K11's step alone, the fill's
#: shapes alone, the caps' shapes alone
PARTS = {"cells", "k11", "fill", "caps"}


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    spec = importlib.util.spec_from_file_location(
        "k10_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    import torch.distributed as dist
    import karpenter_provider_aws_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}, not "
                           f"from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    parts = set(sys.argv[3].split(",")) if len(sys.argv) > 3 else PARTS
    if parts - PARTS:
        raise ValueError(f"unknown parts {sorted(parts - PARTS)}; of "
                         f"{sorted(PARTS)}")
    here_examples(here)
    spec = importlib.util.spec_from_file_location(
        "k10_k1ab", os.path.join(here, "hack", "k1_ab.py"))
    k1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k1)
    drain = k1.watch_drain(cs)
    out = dict(card=cs.smi_line(), sleep_ms=drain["sleep_ms"])
    if "fill" in parts and "cells" not in parts:
        out["fill_shapes_us"] = cs.fill_shape_times()
    if "k11" in parts and "cells" not in parts:
        _, out["k11"] = cs.k11_times(ceiling_slab(),
                                     dict.fromkeys(cs.KERNELS, 0))
    if "caps" in parts and "cells" not in parts:
        # the 500,000-pod cell has config 2's types and groups
        c2 = config2_arrays()
        out["caps"] = caps_times(cs, drain, {"tp": c2, "dp2": c2})
    if "cells" not in parts:
        print("AB", tag, json.dumps(out), flush=True)
        return 0
    tmp = tempfile.mkdtemp(prefix="karp_k10ab_")
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        kept, out["cells"] = mesh_cells(cs)
        out["caps"] = caps_times(cs, drain, kept)
        kept["ceiling"] = ceiling_whole()
        _, out["k10"] = cs.k10_times(kept, dict.fromkeys(cs.KERNELS, 0))
        del kept
        torch.cuda.empty_cache()
        out["ceiling"] = ceiling(cs)
        _, out["k11"] = cs.k11_times(ceiling_slab(),
                                     dict.fromkeys(cs.KERNELS, 0))
        out["enqueue"] = enqueue(cs)
    finally:
        dist.destroy_process_group()
    out["ceiling_2x2"] = ceiling_2x2(cs)
    print("AB", tag, json.dumps(out), flush=True)
    return 0


def here_examples(here):
    """Give an older checkout's ``examples`` this tree's fill and caps
    states (``fill_state``, ``FILL_SHAPES``, ``caps_state``,
    ``CAPS_CASES``), which build a ``MeshState`` through interfaces both
    trees have: this tree's examples.py loaded as a module of the
    checkout's package. A checkout without ``mesh_cuda.caps_cluster`` ran
    one CTA a (group, pool), which its stand-in says."""
    import importlib.util
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    if not hasattr(mc, "caps_cluster"):
        mc.caps_cluster = lambda T, K: 1
    names = ("fill_state", "FILL_SHAPES", "caps_state", "CAPS_CASES")
    if all(hasattr(examples, n) for n in names):
        return
    spec = importlib.util.spec_from_file_location(
        "karpenter_provider_aws_tpu_torch._here_examples",
        os.path.join(here, "karpenter_provider_aws_tpu_torch", "examples.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for n in names:
        setattr(examples, n, getattr(mod, n))


def caps_times(cs, drain, kept):
    """``mesh_new_caps`` at ``chip_smoke.caps_states``' shapes (from the
    kept cells' arrays and the ceiling's slab) and on the floors state
    (``chip_smoke.caps_floors_state``), each with ``k1_ab.READINGS``
    readings of its µs, (µs, the host's enqueue ms; ``drain``, from
    ``k1_ab.watch_drain``)."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    dev = torch.device("cuda")
    states = cs.caps_states(kept, ceiling_slab(), dev)
    states["tp_floors"] = cs.caps_floors_state(examples, dev)
    n0 = len(drain["readings"])
    out = cs.caps_shape_times(states)
    for i, (name, st) in enumerate(states.items()):
        reads = [drain["readings"][n0 + 2 * i]]   # then the plain part's
        for _ in range(READINGS - 1):
            cs.time_launches(lambda: mc.mesh_new_caps(st))
            reads.append(drain["readings"][-1])
        out[name]["readings"] = reads
    return out


def mesh_cells(cs):
    """Each mesh cell at world size 1: ROUNDS timed solves after one that
    settles the bucket; (the kept arrays for ``k10_times``, a summary)."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.parallel import MeshComm
    dev = torch.device("cuda")
    comm, env = MeshComm(), fenv.Environment()
    kept, summary = {}, {}
    for name, n_pods, dp2_min in examples.MESH_CELLS:
        fenv.reset_pod_counter()
        snap = examples.config2(env, n_pods)
        solver = examples.mesh_cell_solver(comm, dp2_min)
        solver.solve(snap)                  # the bucket settles
        times, splits = [], []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            res = solver.solve(snap)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            splits.append(dict(solver.last_phase_stats))
        ds = dict(solver.last_dispatch_stats)
        if ds["kernel"] != "mesh":
            raise AssertionError(f"{name}: the solve ran {ds['kernel']}")
        p50, p99 = cs.p50_p99(times)
        keys = [k for k, v in splits[0].items() if k.endswith("_ms")
                and isinstance(v, (int, float))]
        summary[name] = dict(
            pods=n_pods, p50_ms=p50, p99_ms=p99,
            split_median_ms={k: statistics.median(x[k] for x in splits)
                             for k in keys},
            slot_bucket=ds["slot_bucket"], groups=ds["groups"],
            fingerprint=examples._fp_digest(res))
        enc = encode_snapshot(snap)
        arrays, stt = solver._prep_device_inputs(
            enc, *full_existing_encode(enc, []), mesh=True)
        kept[name] = (arrays, stt, solver._bucket)
        del snap, solver, res
    return kept, summary


def config2_arrays():
    """Config 2's sharded-scan arrays at 50,000 pods, as the mesh cell
    prepares them, at the solver's first slot bucket (the caps read no
    slot): (arrays, statics, n_max)."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    fenv.reset_pod_counter()
    enc = encode_snapshot(examples.config2(fenv.Environment(), 50_000))
    solver = CUDASolver(device="cpu")      # the arrays are numpy
    arrays, stt = solver._prep_device_inputs(
        enc, *full_existing_encode(enc, []), mesh=True)
    return arrays, stt, solver._bucket


def ceiling(cs):
    """The ceiling through ``dispatch_dist`` at world size 1: the full
    tick, then 1 + ROUNDS patch ticks; p50 and median split of the last
    ROUNDS."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.parallel import distmesh as dm
    shape, seed = examples.DIST_CEILING_SHAPE, examples.DIST_SEED
    comm = dm.dist_mesh2(nproc=1)
    Np, lo, hi = dm.slab_rows(shape["n_max"], shape["E"], comm.ndp)
    cache, times, splits, fps = {}, [], [], []
    for i in range(2 + ROUNDS):
        arrays, st = dm.tick_arrays(shape, seed, i, slab=(lo, hi, Np))
        t0 = time.perf_counter()
        res = dm.dispatch_dist(arrays, comm=comm, cache=cache, device="cuda",
                               dirty=list(dm.DIRTY_FIELDS) if i else None,
                               **st)
        times.append((time.perf_counter() - t0) * 1e3)
        splits.append(dict(cache["last_timing"]))
        fps.append(dm.result_fingerprint(res))
    p50, p99 = cs.p50_p99(times[2:])
    return dict(full_ms=times[0], patch_p50_ms=p50, patch_p99_ms=p99,
                split_p50_ms={k: 1e3 * statistics.median(s[k]
                                                         for s in splits[2:])
                              for k in splits[0]},
                fingerprints=fps[:2])


def ceiling_2x2(cs):
    """The ceiling on 2 hosts x 2 gloo ranks sharing the card
    (``MeshGroup``, as ``chip_smoke.py`` phase 15 (b) runs it): the full
    tick, then 1 + ROUNDS patch ticks; p50, median split and collective
    ms a step of the last ROUNDS."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fleet import MeshGroup
    from karpenter_provider_aws_tpu_torch.parallel import distmesh as dm
    shape, seed = examples.DIST_CEILING_SHAPE, examples.DIST_SEED
    mg = MeshGroup(workers=1, local_devices=2,
                   reply_timeout_s=cs.D15_TIMEOUT_S,
                   log_dir=tempfile.mkdtemp(prefix="karp_k10ab_logs_"))
    try:
        mg.start()
        if not mg.alive():
            raise AssertionError("the 2 x 2 mesh group did not form")
        times, splits, colls, fps = [], [], [], []
        for i in range(2 + ROUNDS):
            t0 = time.perf_counter()
            r = mg.solve_seeded(shape, seed, i,
                                dirty=list(dm.DIRTY_FIELDS) if i else None)
            times.append((time.perf_counter() - t0) * 1e3)
            if not r["distributed"]:
                raise AssertionError(f"2 x 2 tick {i} ran locally")
            splits.append(r["timing"])
            colls.append(r["ranks"][0]["mesh"])
            fps.append(r["fingerprint"])
    finally:
        mg.stop()
    p50, p99 = cs.p50_p99(times[2:])
    return dict(full_ms=times[0], patch_p50_ms=p50, patch_p99_ms=p99,
                split_p50_ms={k: 1e3 * statistics.median(x[k]
                                                         for x in splits[2:])
                              for k in splits[0]},
                collective_ms_per_step=1e3 * statistics.median(
                    c["collective_s"] for c in colls[2:]) / shape["G"],
                fingerprints=fps[:2])


def ceiling_whole():
    """The ceiling's tick 0 whole, as ``k10_times`` takes a cell: at world
    size 1 one rank holds all N = 4,224 slots and 812 types."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.parallel import distmesh as dm
    arrays, st = dm.tick_arrays(examples.DIST_CEILING_SHAPE,
                                examples.DIST_SEED, 0)
    return arrays, dict(st, V=0), st["n_max"]


def ceiling_slab():
    """Host 0's slab of the ceiling's tick 0 on 2 hosts of 2 ranks (the
    shard ``k11_times`` cuts rank 0's from)."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.parallel import distmesh as dm
    shape = examples.DIST_CEILING_SHAPE
    Np, lo, hi = dm.slab_rows(shape["n_max"], shape["E"], 2, 2, 0)
    return dm.tick_arrays(shape, examples.DIST_SEED, 0, slab=(lo, hi, Np))


def enqueue(cs):
    """The ceiling's step loop at world size 1 (the fill in three phases,
    as ``dispatch_dist`` runs it), from a fresh state each time: the
    host's time a step and the card's span a step with the card running
    the launches, then the host alone a step, the loop enqueued behind a
    sleep kernel (the first of HOST_REPS windows, and their median)."""
    import numpy as np
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.ops.ffd_torch import KernelInputs
    from karpenter_provider_aws_tpu_torch.parallel import distmesh as dm
    from karpenter_provider_aws_tpu_torch.parallel import mesh as pm
    shape = examples.DIST_CEILING_SHAPE
    arrays, st = dm.tick_arrays(shape, examples.DIST_SEED, 0)
    E, P, N = st["E"], st["P"], st["E"] + st["n_max"]
    T = np.asarray(arrays["A"]).shape[0]
    names = [f for f in pm.FIELDS if arrays.get(f) is not None]
    inp = KernelInputs(**pm._shard_inputs(arrays, dm.dist_mesh2(nproc=1),
                                          names, T, N, N, 0,
                                          torch.device("cuda")))
    G = inp.R.shape[0]

    def loop():
        # the layout dispatch_dist takes at world 1: its earlier-shard
        # prefixes are zeros made on the card, with no host copy that
        # would wait for the card
        s = mc.MeshState(inp, E=E, P=P, V=0, N=N, slot0=0)
        torch.cuda.synchronize()
        return s, dm.dist_mesh2(nproc=1)

    s, lay = loop()
    pm._mesh_scan(s, lay, split_fill=True)     # warm-up (and the rule)
    s, lay = loop()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    t0 = time.perf_counter()
    pm._mesh_scan(s, lay, split_fill=True)
    loop_us = (time.perf_counter() - t0) * 1e6 / G
    ev[1].record()
    torch.cuda.synchronize()
    host = []
    for _ in range(HOST_REPS):
        s, lay = loop()
        torch.cuda._sleep(400_000_000)
        t0 = time.perf_counter()
        pm._mesh_scan(s, lay, split_fill=True)
        host.append((time.perf_counter() - t0) * 1e6 / G)
        torch.cuda.synchronize()
    return dict(steps=G, launches_per_step=5, loop_us_per_step=loop_us,
                span_us_per_step=ev[0].elapsed_time(ev[1]) * 1e3 / G,
                host_us_per_step=host[0], host_us_windows=host,
                host_us_median=statistics.median(host))


if __name__ == "__main__":
    sys.exit(main())
