"""The multi-process mesh (K11) on torch.distributed: the port of the
reference's ``parallel/distmesh.py``.

The distributed tier over ``parallel/mesh.py``: the slot axis of one
solve spans OS processes, and no process ever builds the whole arena.
The reference maps one process to a host with ``local_devices`` devices
and orders its global mesh process-major; here a rank is a process with
one device, so a reference *process* is a **host** of ``local_devices``
rank processes with consecutive ranks (``rank = host * local_devices +
local_rank``) and a reference *device* is a **rank**. ``dist_dp`` keeps
dp a multiple of the host count, so every dp row of the ``(ndp, ntp)``
layout (``MeshComm``, ranks row-major) lies inside one host: a host's
ranks own one contiguous run of padded slot rows (``local_slot_rows``),
the host's **slab**, and the type-axis max never leaves the host.

- **Slabs.** A host builds only its slab of the slot tables
  (``LocalSlab``: ``ex_alloc`` and ``ex_used0`` on rows, ``ex_compat`` on
  columns), and each of its ranks cuts its own rows from it
  (``mesh._cut_slab``, the counterpart of the reference's
  ``commit_global``), refusing rows outside it.
- **Seeded ticks.** ``tick_arrays`` is a counter-based generator: a host
  builds its slab from ``(seed, tick)`` alone, so ``solve_seeded`` sends
  no bulk bytes; ``solve_frame`` sends each rank only its host's slices.
- **Residency.** The rank's shard stays resident across ticks; a tick
  that names dirty fields re-places only those (``DIRTY_FIELDS``).
- **The program.** ``dispatch_dist`` runs K10's pods x types step loop
  (``mesh._mesh_scan`` over ``csrc/mesh.cu``, the fill always in its three
  phases with global slot ids, even on one rank, as the reference always
  runs ``_solve_sharded2``), then ONE flat gather of the outputs and a
  barrier on every tick (the reference's commit 2f1f684: a gather per
  output crashed gloo at random).

The control plane (``fleet/meshgroup.py``) speaks a loopback TCP wire to
the rank processes (``run_worker``; length-prefixed JSON header + npz
payload); the data plane is the torch.distributed process group, joined
at the coordinator's ``tcp://host:port`` by the ``mesh`` command (NCCL
when every rank has a card, gloo otherwise: ``ranks.pick_backend``).

Not ported: ``global_devices`` (a rank's device is its own) and the
``KARP_DIST_DP`` environment override (``dist_dp`` takes ``dp=``).
"""

from __future__ import annotations

import datetime
import hashlib
import io
import json
import logging
import os
import socket
import struct
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import device as _device
from ..ops import mesh_cuda as mc
from .mesh import (LocalSlab, MeshComm, _default_dp, _gather, _mesh_scan,
                   _out_dict, _place_resident, dispatch_mesh)
from .ranks import pick_backend

log = logging.getLogger(__name__)

#: env contract (the reference chart's solver-mesh-workers template)
COORDINATOR_ENV = "SOLVER_DISTMESH_COORDINATOR"
PROCESSES_ENV = "SOLVER_DISTMESH_PROCESSES"
PROCESS_ID_ENV = "SOLVER_DISTMESH_PROCESS_ID"
LOCAL_DEVICES_ENV = "SOLVER_DISTMESH_LOCAL_DEVICES"
WORKERS_ENV = "SOLVER_DISTMESH_WORKERS"

#: the fields a warm tick rewrites (fleet ticks move demand and the
#: existing nodes' usage; catalog and feasibility stay resident)
DIRTY_FIELDS = ("n", "ex_used0")

#: the process group's collective timeout when the caller gives none
COLLECTIVE_TIMEOUT_S = 900.0


class DistConfig(NamedTuple):
    """One host's identity in the distributed job."""
    coordinator: str       # "host:port" of the process group's store
    num_processes: int     # hosts
    process_id: int        # this host
    #: rank processes per host (None: one)
    local_devices: Optional[int] = None


def config_from_env() -> Optional[DistConfig]:
    """DistConfig from the chart's env contract, or None when unset. The
    process id falls back to the StatefulSet ordinal parsed from POD_NAME
    (+1: the coordinator sidecar is process 0, worker ordinal i is
    process i+1)."""
    coord = os.environ.get(COORDINATOR_ENV)
    if not coord:
        return None
    nproc = int(os.environ.get(PROCESSES_ENV) or
                (int(os.environ.get(WORKERS_ENV, "0")) + 1))
    pid_env = os.environ.get(PROCESS_ID_ENV)
    if pid_env is not None:
        pid = int(pid_env)
    else:
        pod = os.environ.get("POD_NAME", "")
        tail = pod.rsplit("-", 1)[-1]
        pid = int(tail) + 1 if tail.isdigit() else 0
    local = os.environ.get(LOCAL_DEVICES_ENV)
    return DistConfig(coord, nproc, pid, int(local) if local else None)


#: (config, local rank) this process joined as, once it has
_INITIALIZED: Optional[Tuple[DistConfig, int]] = None


def rank_device(rank: int, device=None) -> torch.device:
    """The device of global rank ``rank``: on CUDA, card ``rank`` modulo
    the card count (ranks share cards round-robin when there are fewer),
    else the CPU."""
    dev = _device.resolve(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_process(cfg: DistConfig, local_rank: int = 0, device=None,
                 timeout_s: float = COLLECTIVE_TIMEOUT_S) -> torch.device:
    """Join the distributed job as rank ``process_id * local_devices +
    local_rank`` of ``num_processes * local_devices`` (idempotent per
    process): ``init_process_group`` at ``tcp://<coordinator>`` (rank 0
    binds the store there), NCCL when every rank has a card of its own,
    else gloo, with ``timeout_s`` on every collective. A job of one rank
    joins no group (the reference initializes no distributed runtime for
    one process). Returns the rank's device, made current on CUDA."""
    global _INITIALIZED
    L = int(cfg.local_devices or 1)
    if not 0 <= local_rank < L:
        raise ValueError(f"local rank {local_rank} outside [0, {L})")
    if _INITIALIZED is not None:
        if _INITIALIZED != (cfg, local_rank):
            raise RuntimeError(
                f"distmesh already initialized as {_INITIALIZED}, refusing "
                f"re-init as {(cfg, local_rank)}")
        return rank_device(cfg.process_id * L + local_rank, device)
    world = cfg.num_processes * L
    rank = cfg.process_id * L + local_rank
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world > 1:
        dist.init_process_group(
            pick_backend(world, dev), init_method=f"tcp://{cfg.coordinator}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    _INITIALIZED = (cfg, local_rank)
    log.info("distmesh: rank %d/%d (host %d/%d) joined at %s on %s", rank,
             world, cfg.process_id, cfg.num_processes, cfg.coordinator, dev)
    return dev


def dist_dp(ndev: int, nproc: int, dp: Optional[int] = None) -> int:
    """dp extent of the distributed layout over ``ndev`` ranks on
    ``nproc`` hosts: a multiple of the host count (so every dp row lies
    inside one host) that divides the rank count. Default: nproc x the
    single-host default for the per-host share. ``dp`` overrides when
    valid (the reference's ``KARP_DIST_DP``); an invalid one is logged
    and ignored."""
    if dp:
        v = int(dp)
        if v >= nproc and v % nproc == 0 and ndev % v == 0:
            return v
        log.warning("dp=%r invalid for %d ranks / %d hosts; using default",
                    dp, ndev, nproc)
    if ndev % nproc:
        raise ValueError(
            f"{ndev} devices do not split evenly over {nproc} processes")
    return nproc * _default_dp(ndev // nproc)


def _host() -> Tuple[int, int]:
    """(hosts, this host) of the job this process joined, else (1, 0)."""
    if _INITIALIZED is None:
        return 1, 0
    return _INITIALIZED[0].num_processes, _INITIALIZED[0].process_id


def dist_mesh2(nproc: Optional[int] = None) -> MeshComm:
    """The distributed ``(ndp, ntp)`` layout over every rank of the job
    (one rank without a process group): ranks row-major and dp from
    ``dist_dp``, so each of the ``nproc`` hosts (default: the job's)
    holds whole dp rows."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    nproc = _host()[0] if nproc is None else int(nproc)
    return MeshComm(dist_dp(world, nproc))


def local_slot_rows(Np: int, nproc: int, pid: int) -> Tuple[int, int]:
    """The contiguous run [lo, hi) of PADDED global slot rows host
    ``pid`` owns. Holds because dp is a multiple of nproc, Np a multiple
    of dp, and ranks are host-major."""
    if Np % nproc:
        raise ValueError(f"Np={Np} not a multiple of nproc={nproc}")
    rows = Np // nproc
    return pid * rows, (pid + 1) * rows


def slab_rows(n_max: int, E: int, ndp: int, nproc: int = 1,
              pid: int = 0) -> Tuple[int, int, int]:
    """(Np, lo, hi) of host ``pid``'s slab of the solve's slot axis on a
    layout of ``ndp`` slot shards: Np the dp-padded slot range
    (``mesh._pad_slots``), [lo, hi) the rows the host places."""
    N = E + n_max
    Np = ((N + ndp - 1) // ndp) * ndp
    lo, hi = local_slot_rows(Np, nproc, pid)
    return Np, lo, hi


def collective_bill(P: int, dp: int, nproc: int, G: int) -> dict:
    """The reference's analytic per-step collective bill of the
    distributed 2-D program, split at the process boundary: tp-axis
    maxima stay inside a host, every dp-axis collective crosses hosts
    when nproc > 1, each moving O(dp) scalars. (The port merges them: one
    all_reduce, two all_gathers and one all_reduce a step; a solve adds
    the caps' all_reduce: ``cache["last_mesh"]["collectives"]``.)"""
    cross = (P + 1) + 2 if nproc > 1 else 0
    return {
        "steps": G,
        "per_step": {"tp_pmax": 1 + P, "dp_all_gather": P + 1,
                     "dp_psum": 2},
        "cross_process_per_step": cross,
        "cross_process_total": cross * G,
        "bytes_per_dp_collective": 8 * dp,
    }


# -- the deterministic tick harness ----------------------------------------

_M64 = (1 << 64) - 1


def _hash_u64(x):
    """splitmix64 over uint64 (vectorized): the value at global index i
    depends only on i and the stream key, so generating rows [lo, hi)
    equals slicing a full generation."""
    with np.errstate(over="ignore"):
        x = (np.asarray(x, np.uint64) + np.uint64(0x9E3779B97F4A7C15)) \
            & np.uint64(_M64)
        z = x
        z = ((z ^ (z >> np.uint64(30))) *
             np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_M64)
        z = ((z ^ (z >> np.uint64(27))) *
             np.uint64(0x94D049BB133111EB)) & np.uint64(_M64)
        return z ^ (z >> np.uint64(31))


def _field_key(seed: int, tick: int, field: str) -> int:
    """Stream key per field. Only DIRTY_FIELDS mix the tick in: every
    other field is bit-identical across ticks, as the dirty-list patch
    contract of the resident shard needs."""
    t = tick if field in DIRTY_FIELDS else 0
    h = hashlib.sha256(f"{seed}:{t}:{field}".encode()).digest()
    return int.from_bytes(h[:8], "big")


def _gen(seed, tick, field, rows, cols, lo=0):
    """uint64 grid for global rows [lo, lo+rows) x cols of ``field``."""
    key = np.uint64(_field_key(seed, tick, field))
    idx = (np.arange(lo, lo + rows, dtype=np.uint64)[:, None] *
           np.uint64(max(cols, 1)) +
           np.arange(cols, dtype=np.uint64)[None, :])
    with np.errstate(over="ignore"):
        return _hash_u64(idx + key)


def tick_arrays(shape: Dict[str, int], seed: int, tick: int,
                slab: Optional[Tuple[int, int, int]] = None
                ) -> Tuple[dict, dict]:
    """The deterministic multi-host workload: (arrays, statics) for one
    tick of a fleet whose demand (``n``) and existing-node usage
    (``ex_used0``) move every tick while the catalog stays put. With
    ``slab=(lo, hi, Np)`` the slot tables come back as LocalSlab covering
    only global rows [lo, hi) of the PADDED slot range (rows past E are
    zeros, the ``+1`` of ``ex_alloc`` only on true rows). shape keys: G,
    T, n_max, E, P, Z, C, D, pods_per_group."""
    G, T = shape["G"], shape["T"]
    n_max, E, P = shape["n_max"], shape["E"], shape["P"]
    Z, C, D = shape["Z"], shape["C"], shape["D"]
    ppg = shape["pods_per_group"]

    def g(field, rows, cols):
        return _gen(seed, tick, field, rows, cols)

    arrays = dict(
        A=(1 + g("A", T, D) % np.uint64(1 << 20)).astype(np.int64),
        avail_zc=(g("avail_zc", T, Z * C) % np.uint64(100)) <
        np.uint64(80),
        R=(1 + g("R", G, D) % np.uint64(1 << 8)).astype(np.int64),
        n=(np.uint64(ppg) + g("n", G, 1)[:, 0] %
           np.uint64(5)).astype(np.int64),
        F=(g("F", G, T) % np.uint64(100)) < np.uint64(70),
        agz=np.ones((G, Z), bool), agc=np.ones((G, C), bool),
        admit=np.ones((G, P), bool),
        daemon=np.zeros((G, P, D), np.int64),
        pool_types=np.ones((P, T), bool),
        pool_agz=np.ones((P, Z), bool),
        pool_agc=np.ones((P, C), bool),
        pool_limit=np.full((P, D), -1, np.int64),
        pool_used0=np.zeros((P, D), np.int64),
    )

    def slot_rows(field, lo, hi, cols, vmax, dtype):
        """Rows [lo, hi) of a slot table: true rows [0, E) carry data,
        rows past E are the inert padding _pad_slots would add."""
        out = np.zeros((hi - lo, cols), dtype)
        top = min(hi, E)
        if top > lo:
            vals = _gen(seed, tick, field, top - lo, cols, lo=lo)
            out[:top - lo] = (vals % np.uint64(vmax)).astype(dtype)
        return out

    if slab is None:
        arrays["ex_alloc"] = 1 + slot_rows("ex_alloc", 0, E, D,
                                           1 << 10, np.int64)
        arrays["ex_used0"] = slot_rows("ex_used0", 0, E, D, 4, np.int64)
        # slot-major grid (transposed into [G, E]) so a column slab of
        # the full table equals the slab-mode generation bit for bit
        arrays["ex_compat"] = (
            (_gen(seed, tick, "ex_compat", E, G) %
             np.uint64(100) < np.uint64(60)).T) if E else \
            np.zeros((G, 0), bool)
    else:
        lo, hi, Np = slab
        alloc = slot_rows("ex_alloc", lo, hi, D, 1 << 10, np.int64)
        alloc[:max(0, min(hi, E) - lo)] += 1
        arrays["ex_alloc"] = LocalSlab(alloc, lo, hi, 0, (Np, D))
        arrays["ex_used0"] = LocalSlab(
            slot_rows("ex_used0", lo, hi, D, 4, np.int64),
            lo, hi, 0, (Np, D))
        compat = np.zeros((G, hi - lo), bool)
        top = min(hi, E)
        if top > lo:
            grid = _gen(seed, tick, "ex_compat", top - lo, G, lo=lo)
            compat[:, :top - lo] = (grid % np.uint64(100) <
                                    np.uint64(60)).T
        arrays["ex_compat"] = LocalSlab(compat, lo, hi, 1, (G, Np))
    return arrays, dict(n_max=n_max, E=E, P=P)


def oracle_out(arrays: dict, *, n_max: int, E: int, P: int,
               device=None) -> dict:
    """The single-device oracle: the mesh dispatch on one rank
    (``dispatch_mesh`` with ``MeshComm.single()``, whatever process group
    this process belongs to) on ``device`` (default cuda): the
    fingerprint baseline every distributed solve must match bit for
    bit."""
    return dispatch_mesh(arrays, comm=MeshComm.single(), n_max=n_max, E=E,
                         P=P, V=0, cache={}, device=device)


def result_fingerprint(out: dict) -> str:
    """sha256 over every output's name, dtype, shape and bytes: the
    cross-rank and cross-arm decision-identity check."""
    h = hashlib.sha256()
    for k in sorted(out):
        a = np.ascontiguousarray(np.asarray(out[k]))
        h.update(f"{k}:{a.dtype}:{a.shape}:".encode())
        h.update(a.tobytes())
    return h.hexdigest()


# -- the distributed dispatch ----------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dispatch_dist(arrays: dict, *, n_max: int, E: int, P: int,
                  comm: MeshComm, cache: dict, dirty=None, metrics=None,
                  device=None, check=None) -> dict:
    """``dispatch_mesh``'s distributed twin on this rank of ``comm``'s
    layout: always the pods x types step loop with the fill in its three
    phases (``split_fill``, global slot ids, even on one rank); the
    rank's shard placed from the host's slabs (slot fields as
    ``LocalSlab``) or whole arrays, resident across ticks with the
    dirty-list contract of ``_place_resident`` (``full`` / ``patch`` /
    ``reuse``, ``cache["last_placement"]`` with kernel ``dist2``); ONE
    flat gather of the outputs, then a barrier on every tick of a
    multi-rank job (``cache["tick_seq"]``). ``check`` holds the first
    steps' launches against their plain parts (``mesh._mesh_scan``).
    Records ``cache["last_timing"]`` (commit / solve / gather seconds)
    and ``cache["last_mesh"]`` (layout, collectives and their seconds).
    No minValues floors (the reference's callers keep them on the type
    mesh). Returns the ``_out_dict`` outputs on every rank."""
    if arrays.get("mv_floor") is not None:
        raise ValueError("distributed mesh solve does not take "
                         "minValues floors")
    lay = comm
    N = E + n_max
    Np = -(-N // lay.ndp) * lay.ndp
    T = int(np.asarray(arrays["A"]).shape[0])
    Tp = -(-T // lay.ntp) * lay.ntp
    dev = _device.resolve(device)
    t0 = time.perf_counter()
    inp = _place_resident(arrays, lay, "dist2", Tp, Np, N,
                          ("dist2", lay.key, n_max, E, P), cache, dirty, 0,
                          dev)
    _sync(dev)
    commit_s = time.perf_counter() - t0
    mode = cache["last_placement"]["mode"]
    if metrics is not None:
        metrics.set_gauge("karpenter_solver_distmesh_processes", _host()[0])
        metrics.inc("karpenter_solver_distmesh_patch_total",
                    labels={"mode": mode})

    Nl = inp.ex_used0.shape[0]
    st = mc.MeshState(inp, E=E, P=P, V=0, N=N, slot0=lay.dp_idx * Nl)
    t0 = time.perf_counter()
    info = _mesh_scan(st, lay, check=check, split_fill=True)
    _sync(dev)
    solve_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    takes, leftover, carry = _gather(st.takes, st.leftover, st.carry, lay)
    out = _out_dict(takes, leftover, carry, T, N=N)
    if lay.world > 1:
        # the tick barrier: once every rank has passed it, no collective
        # of this tick is still in flight to meet the next tick's
        cache["tick_seq"] = cache.get("tick_seq", 0) + 1
        dist.barrier()
    gather_s = time.perf_counter() - t0
    cache["last_timing"] = {"commit_s": commit_s, "solve_s": solve_s,
                            "gather_s": gather_s}
    cache["last_mesh"] = dict(kernel="dist2", ndp=lay.ndp, ntp=lay.ntp,
                              backend=lay.backend, **info)
    return out


# -- worker control plane --------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return bytes(buf)


def _pack_arrays(arrays: Dict[str, np.ndarray]) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, **{k: np.asarray(v) for k, v in arrays.items()})
    return bio.getvalue()


def _unpack_arrays(payload: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _send_msg(sock: socket.socket, msg: dict,
              arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
    """One frame: !II (header len, payload len) + JSON header + npz
    payload."""
    payload = _pack_arrays(arrays) if arrays else b""
    head = json.dumps(msg).encode()
    sock.sendall(struct.pack("!II", len(head), len(payload)))
    sock.sendall(head)
    if payload:
        sock.sendall(payload)


def _recv_msg(sock: socket.socket
              ) -> Tuple[Optional[dict], Dict[str, np.ndarray]]:
    """Inverse of _send_msg; (None, {}) on orderly close."""
    try:
        raw = _recv_exact(sock, 8)
    except ConnectionError:
        return None, {}
    hl, pl = struct.unpack("!II", raw)
    msg = json.loads(_recv_exact(sock, hl).decode())
    arrays = _unpack_arrays(_recv_exact(sock, pl)) if pl else {}
    return msg, arrays


def _slabs_from_frame(msg: dict, arrays: Dict[str, np.ndarray]) -> dict:
    """Rebuild the LocalSlab fields a solve_frame message shipped: the
    header carries {field: [lo, hi, axis, global_shape]}."""
    out = dict(arrays)
    for f, (lo, hi, axis, gshape) in (msg.get("slabs") or {}).items():
        out[f] = LocalSlab(arrays[f], int(lo), int(hi), int(axis),
                           tuple(int(s) for s in gshape))
    return out


def run_worker(control: str, proc_id: int, device=None) -> None:
    """One rank process of a mesh group: pin its device (card ``proc_id``
    modulo the card count) and one intra-op thread, connect to the
    coordinator's control socket, then serve commands until halt or
    close. The process group is joined only at the ``mesh`` command, so
    the same loop also serves the oracle and batch roles. Exits through
    os._exit: after a peer dies, a process group's destructors can wait
    on collectives, and the coordinator owns the lifecycle."""
    torch.set_num_threads(1)
    host, _, port = control.rpartition(":")
    sock = socket.create_connection((host, int(port)))
    cache: dict = {"device": rank_device(proc_id, device)}
    if cache["device"].type == "cuda":
        torch.cuda.set_device(cache["device"])
    _send_msg(sock, {"hello": proc_id})
    code = 0
    while True:
        msg, arrays = _recv_msg(sock)
        if msg is None or msg.get("cmd") == "halt":
            break
        try:
            reply, rarrays = _worker_cmd(msg, arrays, proc_id, cache)
            if reply.get("_mesh_built") is not None:
                cache["mesh"] = reply.pop("_mesh_built")
            # epoch fencing: every reply echoes the REQUEST's mesh epoch,
            # so the coordinator can reject late bytes of an earlier group
            if "epoch" in msg:
                reply.setdefault("epoch", msg["epoch"])
            _send_msg(sock, reply, rarrays)
        except Exception as e:  # report, don't die: the coordinator decides
            log.exception("worker %d: command %r failed", proc_id,
                          msg.get("cmd"))
            try:
                err = {"ok": False, "error": repr(e)}
                if "epoch" in msg:
                    err["epoch"] = msg["epoch"]
                _send_msg(sock, err)
            except Exception:
                code = 1
                break
    os._exit(code)


def _launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    """The kernel launches since ``before`` (``ffd_cuda.LAUNCHES``)."""
    from ..ops.ffd_cuda import LAUNCHES
    return {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
            if v != before.get(k, 0)}


def _launches_now() -> Dict[str, int]:
    from ..ops.ffd_cuda import LAUNCHES
    return dict(LAUNCHES)


def _worker_cmd(msg: dict, arrays: Dict[str, np.ndarray], proc_id: int,
                cache: dict) -> Tuple[dict, Optional[Dict[str, np.ndarray]]]:
    """One command of a rank process (``run_worker``). ``cache`` holds
    the rank's device (``"device"``), its layout once formed
    (``"mesh"``), its host ((hosts, host): ``"host"``) and the resident
    shard."""
    cmd = msg["cmd"]
    dev = cache.get("device")
    if cmd == "mesh":
        cfg = DistConfig(msg["coordinator"], int(msg["num_processes"]),
                         int(msg["process_id"]), msg.get("local_devices"))
        dev = cache["device"] = init_process(
            cfg, int(msg.get("local_rank", 0)), device=dev,
            timeout_s=float(msg.get("timeout_s", COLLECTIVE_TIMEOUT_S)))
        cache["host"] = (cfg.num_processes, cfg.process_id)
        comm = dist_mesh2(nproc=cfg.num_processes)
        return {"ok": True, "_mesh_built": comm, "ndev": comm.world,
                "world": comm.world, "nproc": cfg.num_processes,
                "dp": comm.ndp, "tp": comm.ntp, "backend": comm.backend,
                "process_index": cfg.process_id, "rank": comm.rank,
                "device": str(dev)}, None

    if cmd in ("solve_seeded", "solve_frame", "canary"):
        comm = cache.get("mesh")
        if comm is None:
            raise RuntimeError("mesh not initialized (send 'mesh' first)")
        if cmd == "solve_frame":
            inp = _slabs_from_frame(msg, arrays)
            statics = {k: int(msg[k]) for k in ("n_max", "E", "P")}
        else:
            shape = msg["shape"]
            nproc, pid = cache.get("host", (1, 0))
            Np, lo, hi = slab_rows(shape["n_max"], shape["E"], comm.ndp,
                                   nproc, pid)
            inp, statics = tick_arrays(shape, int(msg["seed"]),
                                       int(msg["tick"]), slab=(lo, hi, Np))
        if cmd == "canary":
            # canary-gated re-admission: a throwaway cache, so proving the
            # fresh group solves right leaves production residency alone
            out = dispatch_dist(inp, comm=comm, cache={}, device=dev,
                                **statics)
            return {"ok": True,
                    "fingerprint": result_fingerprint(out)}, None
        records = None
        check = None
        if comm.rank in (msg.get("check") or ()):
            from ..examples import mesh_kernel_check
            records = []
            check = mesh_kernel_check(0, records)
        before = _launches_now()
        t0 = time.perf_counter()
        out = dispatch_dist(inp, comm=comm, cache=cache, device=dev,
                            dirty=msg.get("dirty"), check=check, **statics)
        wall = time.perf_counter() - t0
        res = cache["resident"]["dev"]
        reply = {"ok": True, "fingerprint": result_fingerprint(out),
                 "wall_s": wall, "rank": comm.rank,
                 "mode": cache["last_placement"]["mode"],
                 "timing": cache.get("last_timing", {}),
                 "mesh": cache.get("last_mesh", {}),
                 "launches": _launch_delta(before),
                 "slot_rows": {f: int(res[f].shape[1 if f == "ex_compat"
                                                   else 0])
                               for f in ("ex_alloc", "ex_used0",
                                         "ex_compat")}}
        if records is not None:
            reply["checks"] = [[n, list(a), d, e] for n, a, d, e in records]
        want = bool(msg.get("want_arrays")) and comm.rank == 0
        return reply, (out if want else None)

    if cmd == "solve_batch":
        # routed SolveBatch lanes: this rank's span of independent packed
        # solves in one K4 dispatch on its device, no collectives
        from ..ops.ffd_torch import solve_scan_packed1_many
        kv = {k: int(v) for k, v in msg["kv"].items()}
        stack = arrays["stack"]
        before = _launches_now()
        out = solve_scan_packed1_many(stack, device=dev, **kv)
        out = np.asarray(out.cpu())
        return {"ok": True, "lanes": int(stack.shape[0]),
                "launches": _launch_delta(before)}, {"out": out}

    if cmd == "solve_oracle":
        shape = msg["shape"]
        inp, statics = tick_arrays(shape, int(msg["seed"]),
                                   int(msg["tick"]))
        out = oracle_out(inp, device=dev, **statics)
        reply = {"ok": True, "fingerprint": result_fingerprint(out)}
        return reply, (out if msg.get("want_arrays") else None)

    if cmd == "sleep":
        # wedge injection for the coordinator's per-reply watchdog: hold
        # the reply for a bounded window
        time.sleep(float(msg["s"]))
        return {"ok": True}, None

    raise ValueError(f"unknown command {cmd!r}")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="distmesh rank process (fleet/meshgroup.py spawns "
                    "these; not a user-facing CLI)")
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--control", required=True,
                    help="host:port of the coordinator control socket")
    ap.add_argument("--proc-id", type=int, default=None,
                    help="global rank; defaults to the POD_NAME "
                         "StatefulSet ordinal + 1 (chart contract), else 0")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card per rank, round-robin) or cpu")
    args = ap.parse_args(argv)
    pid = args.proc_id
    if pid is None:
        tail = os.environ.get("POD_NAME", "").rsplit("-", 1)[-1]
        pid = int(tail) + 1 if tail.isdigit() else 0
    logging.basicConfig(level=logging.INFO)
    run_worker(args.control, pid, args.device)


if __name__ == "__main__":
    main()
