"""A small spawner of ranks: the port's counterpart of the reference's
``_pick_devices(force_host=True)`` (``parallel/mesh.py:128``), since the
port's mesh ranks are processes, not devices of one process.

``run_ranks(fn, world, backend, timeout_s)`` starts ``world`` processes
with ``torch.multiprocessing`` (spawn), joins them into one process group
through a ``file://`` rendezvous in a fresh temporary directory (no
network) with ``init_process_group(timeout=)``, calls ``fn(rank, world,
*args)`` in each and returns the ranks' return values in rank order. The
join has a deadline: when a rank fails, or the deadline passes, the
survivors are killed (a survivor may wait in a collective for a rank that
is gone) and ``run_ranks`` raises with every failed rank's traceback.
``fn`` must be importable by name (a module-level function of a module
that a fresh interpreter can import), and its return value picklable.

With ``build=True`` the kernel library is built once in the parent before
the spawn (``ops/ffd_cuda.py``), so the ranks load it and never race on
its build directory.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def pick_backend(world: int, device) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo`` (the
    CPU, or ranks sharing a card)."""
    if torch.device(device).type == "cuda" and \
            world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               tmp: str, timeout_s: float, threads: int, args: tuple,
               device=None) -> None:
    if threads:
        torch.set_num_threads(threads)
    try:
        if backend == "nccl" or (device is not None
                                 and torch.device(device).type == "cuda"):
            # a CUDA rank: its card current, as CUDASolver(mesh=) places
            # rank r (cuda:{r % device_count}) and distmesh.init_process
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'rdzv')}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"{rank}.out.tmp"), "wb") as f:
            pickle.dump(out, f)
        os.replace(os.path.join(tmp, f"{rank}.out.tmp"),
                   os.path.join(tmp, f"{rank}.out"))
    except BaseException:
        with open(os.path.join(tmp, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class RanksFailed(RuntimeError):
    """One or more ranks failed, or the join's deadline passed."""


def run_ranks(fn: Callable, world: int, backend: str = "gloo",
              timeout_s: float = 60.0, *, args: tuple = (),
              deadline_s: float = None, threads: int = 1,
              build: bool = False, device=None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks (module
    docstring). ``timeout_s`` is the process group's collective timeout;
    ``deadline_s`` (default 4 x ``timeout_s``) bounds the whole join.
    ``threads`` pins each rank's intra-op threads (0 leaves torch's
    default). A CUDA rank (the nccl backend, or a CUDA ``device``) makes
    ``cuda:{rank % device_count}`` its current device first."""
    if build:
        from ..ops import ffd_cuda
        ffd_cuda.build()
    deadline_s = 4 * timeout_s if deadline_s is None else deadline_s
    tmp = tempfile.mkdtemp(prefix="karp_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, tmp, timeout_s, threads,
                              tuple(args), device),
            nprocs=world, join=False, start_method="spawn")
        procs = ctx.processes
        end = time.monotonic() + deadline_s
        while True:
            codes = [p.exitcode for p in procs]
            if all(c is not None for c in codes):
                break
            if any(c not in (None, 0) for c in codes) or \
                    time.monotonic() > end:
                break
            time.sleep(0.02)
        timed_out = any(p.exitcode is None for p in procs) and \
            not any(p.exitcode not in (None, 0) for p in procs)
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join()
        errs = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0 and not os.path.exists(
                    os.path.join(tmp, f"{r}.out")):
                errs.append(f"rank {r}: exit code {p.exitcode}")
        if timed_out:
            raise RanksFailed(f"ranks did not finish within {deadline_s} s"
                              + ("\n" + "\n".join(errs) if errs else ""))
        if errs:
            raise RanksFailed("\n".join(errs))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.out"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
