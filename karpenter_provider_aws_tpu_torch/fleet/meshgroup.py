"""MeshGroup: rank processes formed into ONE distributed solver (the port
of the reference's ``fleet/meshgroup.py``).

The coordinator spawns ``(workers + 1) * local_devices`` rank processes
(``parallel/distmesh.py`` ``run_worker``: ``workers + 1`` hosts of
``local_devices`` ranks, one control socket each), forms them into one
torch.distributed ``(dp, tp)`` layout, and routes work over a loopback
control protocol:

- ``solve_seeded`` / ``solve_frame``: one pods x types solve whose slot
  axis spans every host, each host placing only its own slab;
- ``solve_batch``: SolveBatch lanes split over the ranks in contiguous
  spans, each rank solving its span with K4 on its device (lanes are
  independent: no collectives).

Degradation keeps the reference's taxonomy: a lost rank makes the whole
group unusable (a collective with a dead peer hangs, or fails only at
its timeout), so the coordinator kills the remaining ranks, serves from
the single-device mesh dispatch on its own device (``dispatch_mesh`` on
``MeshComm.single()``; on the card that is the card), and forces EXACTLY
ONE full placement before patch ticks resume. A supervisor on the
dispatch path (``_check``) then re-forms the group with bounded
exponential backoff; a re-formed group serves only after a seeded canary
solve fingerprints identical to the coordinator's oracle, and every
formation bumps a mesh ``epoch`` carried in every control frame and
echoed in every reply, so a zombie's late bytes are rejected, never
merged. Liveness is the coordinator's poll and its per-reply deadline,
never a collective.

Where the reference reads ``KARP_DISTMESH_*`` timeouts and regroup knobs
from the environment, the port takes them as constructor arguments only.

Metrics (``metrics=``, the reference's names):
``karpenter_solver_distmesh_processes`` gauge,
``karpenter_solver_distmesh_dispatch_total{mode}``,
``karpenter_solver_distmesh_patch_total{mode}`` (rank-side),
``karpenter_solver_distmesh_degraded_total{reason}``,
``karpenter_solver_distmesh_recovered_total{reason}``,
``karpenter_solver_distmesh_regroup_ms``,
``karpenter_solver_distmesh_stale_rejected_total``.
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np

from .. import device as _device

log = logging.getLogger(__name__)

#: rank spawn/handshake deadline (cold python + torch import)
_HELLO_TIMEOUT_S = 120.0
#: per-command reply deadline; doubles as the wedge watchdog: a rank whose
#: socket stays open but whose solve never returns trips it
_REPLY_TIMEOUT_S = 900.0

#: supervised regroup defaults: first attempt after the base backoff,
#: doubling per failure up to the cap, then stay degraded for good
_REGROUP_ATTEMPTS = 3
_REGROUP_BACKOFF_S = 30.0
_REGROUP_BACKOFF_CAP_S = 300.0

#: bounded formation retries when the store port raced (_free_port picks
#: it here, rank 0 binds it later: a collision surfaces as a bind error
#: in the mesh reply)
_FORMATION_TRIES = 3
_PORT_RETRY_MARKERS = ("address already in use", "errno 98",
                       "eaddrinuse", "failed to bind")

#: frames to discard per rank while hunting the current-epoch reply
#: before declaring the socket poisoned
_STALE_REREADS = 4


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class MeshGroup:
    """Coordinator of one distributed solver (module docstring).

    ``workers`` is the number of EXTRA hosts beyond the coordinator-side
    host 0; each host runs ``local_devices`` rank processes. ``workers=0``
    is the local mode (no subprocesses: every dispatch runs the
    single-device mesh dispatch), which every degradation converges to.
    ``device`` is where the coordinator's local solves run and what the
    ranks run on (default cuda: a card per rank, round-robin; "cpu" runs
    the plain versions). ``reply_timeout_s`` is also the process
    group's collective timeout. ``log_dir`` keeps each rank's stdout and
    stderr in ``rank<r>.log`` there."""

    def __init__(self, workers: int, local_devices: int = 1,
                 metrics=None, python: Optional[str] = None,
                 hello_timeout_s: Optional[float] = None,
                 reply_timeout_s: Optional[float] = None,
                 regroup_attempts: Optional[int] = None,
                 regroup_backoff_s: Optional[float] = None,
                 clock=None, device=None, log_dir: Optional[str] = None):
        from ..sim.clock import monotonic_of
        #: the clock seam governs ONLY the regroup scheduling timers
        #: (degrade timestamps, backoff deadlines, outage accounting);
        #: _reap and socket timeouts stay wall-clock: they bound real OS
        #: processes and sockets
        self._clock = monotonic_of(clock)
        self.workers = max(0, int(workers))
        self.local_devices = max(1, int(local_devices))
        self.metrics = metrics
        self.device = _device.resolve(device)
        self.log_dir = log_dir
        self._python = python or sys.executable
        self.hello_timeout_s = _HELLO_TIMEOUT_S \
            if hello_timeout_s is None else float(hello_timeout_s)
        self.reply_timeout_s = _REPLY_TIMEOUT_S \
            if reply_timeout_s is None else float(reply_timeout_s)
        self.regroup_attempts = _REGROUP_ATTEMPTS \
            if regroup_attempts is None else int(regroup_attempts)
        self.regroup_backoff_s = _REGROUP_BACKOFF_S \
            if regroup_backoff_s is None else float(regroup_backoff_s)
        self._procs: list = []
        self._socks: Dict[int, socket.socket] = {}
        self._degraded = False
        self._degrade_pending_full = False
        self._local_cache: dict = {}
        self.mesh_info: Optional[dict] = None
        #: mesh epoch: bumped at every (re)formation attempt, carried in
        #: every control frame, echoed in every rank reply
        self.epoch = 0
        self._degrade_reason: Optional[str] = None
        self._degraded_at: Optional[float] = None
        #: deadline of the next supervised regroup attempt; None = none
        #: pending (healthy, stopped, or given up)
        self._regroup_at: Optional[float] = None
        self._regroup_attempt = 0
        self._regroup_lock = threading.Lock()
        self._closed = False
        #: each rank's lane span and launches in the last routed batch
        self.last_batch: list = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MeshGroup":
        """Spawn the ranks, collect hellos, form the layout. Any failure
        degrades instead of raising: a solver that cannot form its group
        still serves locally (and the supervisor keeps retrying)."""
        if self.workers <= 0:
            self._gauge_processes(1)
            return self
        try:
            self._form()
        except Exception:
            log.exception("mesh group formation failed; degrading to the "
                          "single-device mesh")
            self.degrade(reason="spawn_failed")
        return self

    def _form(self) -> None:
        """One group formation with bounded retry on store-port bind
        collisions (the _free_port race): a raced port surfaces as a bind
        failure in the mesh reply and is retried with a fresh one."""
        last: Optional[Exception] = None
        for attempt in range(_FORMATION_TRIES):
            try:
                self._start_distributed()
                return
            except Exception as e:
                self._teardown_attempt()
                last = e
                text = repr(e).lower()
                if not any(m in text for m in _PORT_RETRY_MARKERS):
                    raise
                log.warning("mesh formation attempt %d raced the store "
                            "port (%s); retrying with a fresh one",
                            attempt + 1, e)
        assert last is not None
        raise last

    def _start_distributed(self) -> None:
        self.epoch += 1
        nproc, L = self.workers + 1, self.local_devices
        nranks = nproc * L
        store_port = _free_port()
        if self.device.type == "cuda":
            # build the kernel library once here, so the ranks load it
            # and never race on its build directory
            from ..ops import ffd_cuda
            ffd_cuda.build()
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(nranks)
        listener.settimeout(self.hello_timeout_s)
        control = f"127.0.0.1:{listener.getsockname()[1]}"
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + \
            env.get("PYTHONPATH", "")
        try:
            for r in range(nranks):
                sink = subprocess.DEVNULL
                if self.log_dir:
                    os.makedirs(self.log_dir, exist_ok=True)
                    sink = open(os.path.join(
                        self.log_dir, f"rank{r}.log"), "ab")
                try:
                    self._procs.append(subprocess.Popen(
                        [self._python, "-m",
                         "karpenter_provider_aws_tpu_torch.parallel.distmesh",
                         "--worker", "--control", control, "--proc-id",
                         str(r), "--device", self.device.type],
                        cwd=repo_root, env=env, stdout=sink, stderr=sink))
                finally:
                    if sink is not subprocess.DEVNULL:
                        sink.close()
            for _ in range(nranks):
                conn, _addr = listener.accept()
                conn.settimeout(self.reply_timeout_s)
                msg, _ = self._distmesh()._recv_msg(conn)
                self._socks[int(msg["hello"])] = conn
        finally:
            listener.close()
        infos = self._broadcast(lambda r: ({
            "cmd": "mesh", "coordinator": f"127.0.0.1:{store_port}",
            "num_processes": nproc, "process_id": r // L,
            "local_devices": L, "local_rank": r % L,
            "timeout_s": self.reply_timeout_s}, None),
            degrade_on_error=False)
        self.mesh_info = {k: infos[0][0][k] for k in (
            "nproc", "world", "ndev", "dp", "tp", "backend")}
        self._gauge_processes(nproc)
        log.info("mesh group up: %d hosts, %d ranks, dp=%d tp=%d on %s, "
                 "epoch=%d", nproc, self.mesh_info["world"],
                 self.mesh_info["dp"], self.mesh_info["tp"],
                 self.mesh_info["backend"], self.epoch)

    def stop(self) -> None:
        self._closed = True
        self._regroup_at = None
        for sock in list(self._socks.values()):
            try:
                self._distmesh()._send_msg(sock, {"cmd": "halt"})
                sock.close()
            except Exception:
                pass
        self._socks.clear()
        # one shared deadline for the whole set: an N-rank shutdown is
        # bounded by ONE grace window, not N serial waits
        self._reap(self._procs, timeout=10.0)
        self._procs = []

    @staticmethod
    def _reap(procs, timeout: float = 10.0) -> None:
        """Wait for every process under ONE shared deadline, then kill
        the stragglers and collect them: no zombies, no unbounded
        shutdown."""
        deadline = time.monotonic() + timeout
        pending = [p for p in procs if p.poll() is None]
        while pending and time.monotonic() < deadline:
            time.sleep(0.02)
            pending = [p for p in pending if p.poll() is None]
        for p in pending:
            try:
                p.kill()
            except Exception:
                pass
        for p in pending:
            try:
                p.wait(timeout=5.0)
            except Exception:
                pass

    def alive(self) -> bool:
        """True while the distributed group is usable: every rank process
        running and its control socket open."""
        return (bool(self._socks) and not self._degraded
                and all(p.poll() is None for p in self._procs))

    def degrade(self, reason: str = "worker_lost") -> None:
        """Collapse to the single-device mesh: kill AND reap every rank
        (survivors would wait at their next collective on the dead peer),
        arm the one-full-placement flag, and schedule the supervised
        regroup."""
        if self._degraded:
            return
        self._degraded = True
        self._degrade_pending_full = True
        self._degrade_reason = reason
        self._degraded_at = self._clock()
        for p in self._procs:
            try:
                p.kill()
            except Exception:
                pass
        for sock in self._socks.values():
            try:
                sock.close()
            except Exception:
                pass
        self._socks.clear()
        self._reap(self._procs, timeout=5.0)
        self._procs = []
        self.mesh_info = None
        self._gauge_processes(1)
        if self.metrics is not None:
            self.metrics.inc("karpenter_solver_distmesh_degraded_total",
                             labels={"reason": reason})
        self._regroup_attempt = 0
        if (self.workers > 0 and not self._closed
                and self.regroup_attempts > 0):
            self._regroup_at = self._clock() + self.regroup_backoff_s
            log.warning("mesh group degraded (%s): serving from the "
                        "single-device mesh; next solve is a full "
                        "placement, regroup scheduled in %.1fs", reason,
                        self.regroup_backoff_s)
        else:
            self._regroup_at = None
            log.warning("mesh group degraded (%s): serving from the "
                        "single-device mesh; next solve is a full "
                        "placement", reason)

    # -- plumbing ----------------------------------------------------------

    @staticmethod
    def _distmesh():
        from ..parallel import distmesh
        return distmesh

    def _gauge_processes(self, n: int) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge("karpenter_solver_distmesh_processes", n)

    def _check(self) -> bool:
        """Poll rank liveness BEFORE dispatching: a dead peer is caught
        here, where degrading is cheap, not inside a collective. While
        degraded, this is also the supervisor tick that attempts the
        scheduled regroup."""
        if self._degraded:
            if not self._maybe_regroup():
                return False
        if not self._socks:
            return False
        if any(p.poll() is not None for p in self._procs):
            self.degrade(reason="worker_lost")
            return False
        return True

    # -- supervised regroup ------------------------------------------------

    def _teardown_attempt(self) -> None:
        """Reap one failed formation or regroup attempt's processes and
        sockets WITHOUT touching the degradation state."""
        for sock in self._socks.values():
            try:
                sock.close()
            except Exception:
                pass
        self._socks.clear()
        for p in self._procs:
            try:
                p.kill()
            except Exception:
                pass
        self._reap(self._procs, timeout=5.0)
        self._procs = []
        self.mesh_info = None

    def heal_async(self) -> None:
        """Kick the supervised regroup WITHOUT blocking the caller. No-op
        unless a regroup is due; the non-blocking lock in
        ``_maybe_regroup`` keeps concurrent kicks from double-forming."""
        if (self._regroup_at is None or self._closed
                or self._clock() < self._regroup_at):
            return
        threading.Thread(target=self._maybe_regroup,
                         name="meshgroup-regroup", daemon=True).start()

    def _maybe_regroup(self) -> bool:
        """One supervisor tick: past the scheduled deadline, re-form the
        group and canary-gate it. True when the group recovered. Failed
        attempts back off exponentially; after ``regroup_attempts``
        failures the group stays degraded."""
        if (self._regroup_at is None or self._closed
                or self.workers <= 0
                or self._clock() < self._regroup_at):
            return False
        if not self._regroup_lock.acquire(blocking=False):
            return False
        try:
            return self._regroup_once()
        finally:
            self._regroup_lock.release()

    def _regroup_once(self) -> bool:
        self._regroup_attempt += 1
        attempt = self._regroup_attempt
        try:
            self._form()
            if not self._canary_group():
                raise RuntimeError("regroup canary diverged from the "
                                   "local oracle")
        except Exception as e:
            self._teardown_attempt()
            self._gauge_processes(1)
            if attempt >= self.regroup_attempts:
                self._regroup_at = None
                log.error("mesh regroup attempt %d/%d failed (%s); "
                          "staying degraded", attempt,
                          self.regroup_attempts, e)
            else:
                delay = min(self.regroup_backoff_s * (2 ** attempt),
                            _REGROUP_BACKOFF_CAP_S)
                self._regroup_at = self._clock() + delay
                log.warning("mesh regroup attempt %d/%d failed (%s); next "
                            "attempt in %.1fs", attempt,
                            self.regroup_attempts, e, delay)
            return False
        reason = self._degrade_reason or "unknown"
        now = self._clock()
        outage_s = now - (self._degraded_at or now)
        self._degraded = False
        self._degrade_reason = None
        self._degraded_at = None
        self._regroup_at = None
        self._regroup_attempt = 0
        if self.metrics is not None:
            self.metrics.inc("karpenter_solver_distmesh_recovered_total",
                             labels={"reason": reason})
            self.metrics.observe("karpenter_solver_distmesh_regroup_ms",
                                 outage_s * 1e3)
        log.info("mesh group recovered from %s after %.1fs (attempt %d, "
                 "epoch %d): canary fingerprint matches the local oracle",
                 reason, outage_s, attempt, self.epoch)
        return True

    def _canary_group(self) -> bool:
        """Canary-gated re-admission of the JUST-FORMED group: one tiny
        seeded solve through every rank (a throwaway cache on their side),
        fingerprint-checked against the coordinator's oracle."""
        from .canary import CANARY_SEED, MESH_CANARY_SHAPE
        replies = self._broadcast(lambda r: ({
            "cmd": "canary", "shape": MESH_CANARY_SHAPE,
            "seed": CANARY_SEED, "tick": 0}, None),
            degrade_on_error=False)
        fps = {r["fingerprint"] for r, _ in replies}
        want = self.solve_oracle(MESH_CANARY_SHAPE, seed=CANARY_SEED,
                                 tick=0)["fingerprint"]
        return fps == {want}

    def _broadcast(self, make_msg, degrade_on_error: bool = True):
        """Send make_msg(rank) to every rank, then collect every reply
        (send-all-then-recv-all: the SPMD solve completes only once every
        rank has entered it). Every frame carries the mesh epoch and
        every reply must echo it: a zombie's late bytes from an earlier
        epoch are discarded. A reply-deadline timeout is the wedge
        signature and degrades as ``worker_wedged``; any other transport
        error or rank-reported failure as ``worker_lost``."""
        dm = self._distmesh()
        try:
            for r in sorted(self._socks):
                msg, arrays = make_msg(r)
                msg.setdefault("epoch", self.epoch)
                dm._send_msg(self._socks[r], msg, arrays)
            replies = {}
            for r in sorted(self._socks):
                for _ in range(_STALE_REREADS):
                    reply, arrays = dm._recv_msg(self._socks[r])
                    ep = None if reply is None else reply.get("epoch")
                    if ep is None or int(ep) == self.epoch:
                        break
                    log.warning("rank %d: rejected stale reply from mesh "
                                "epoch %s (current %d)", r, ep, self.epoch)
                    if self.metrics is not None:
                        self.metrics.inc(
                            "karpenter_solver_distmesh_"
                            "stale_rejected_total")
                else:
                    raise RuntimeError(
                        f"worker {r}: nothing but stale-epoch replies "
                        f"after {_STALE_REREADS} frames")
                if reply is None or not reply.get("ok"):
                    err = (reply or {}).get("error", "socket closed")
                    raise RuntimeError(f"worker {r}: {err}")
                replies[r] = (reply, arrays)
        except socket.timeout:
            if degrade_on_error:
                self.degrade(reason="worker_wedged")
            raise
        except Exception:
            if degrade_on_error:
                self.degrade(reason="worker_lost")
            raise
        return [replies[r] for r in sorted(replies)]

    # -- dispatch surfaces -------------------------------------------------

    def _dirty_for_local(self, dirty):
        """The one-full-placement taxonomy: the first local dispatch
        after a degrade ignores the caller's dirty list (residency was
        lost with the ranks), every later one honors it."""
        if self._degrade_pending_full:
            self._degrade_pending_full = False
            return None
        return dirty

    def _solve_local(self, arrays, statics, dirty, mode_label):
        from ..parallel.mesh import MeshComm, dispatch_mesh
        out = dispatch_mesh(arrays, comm=MeshComm.single(),
                            n_max=statics["n_max"], E=statics["E"],
                            P=statics["P"], V=0, cache=self._local_cache,
                            dirty=self._dirty_for_local(dirty),
                            device=self.device)
        if self.metrics is not None:
            self.metrics.inc("karpenter_solver_distmesh_dispatch_total",
                             labels={"mode": mode_label})
        return {"out": out,
                "fingerprint": self._distmesh().result_fingerprint(out),
                "mode": self._local_cache["last_placement"]["mode"],
                "distributed": False}

    def solve_seeded(self, shape: dict, seed: int, tick: int,
                     dirty=None, want_arrays: bool = False,
                     check_ranks=()) -> dict:
        """One distributed solve of the deterministic tick workload
        (``distmesh.tick_arrays``): each rank builds its host's slab, and
        nothing bulk crosses the control wire. Serves from the local mesh
        (full arrays, one device) when degraded. ``check_ranks``: the
        ranks that hold their first steps' kernel launches against the
        plain parts (records in the result's ``ranks``)."""
        statics = {k: shape[k] for k in ("n_max", "E", "P")}
        if not self._check():
            arrays, _ = self._distmesh().tick_arrays(shape, seed, tick)
            return self._solve_local(
                arrays, statics, dirty,
                "degraded" if self._degraded else "local")
        try:
            replies = self._broadcast(lambda r: ({
                "cmd": "solve_seeded", "shape": shape, "seed": seed,
                "tick": tick, "dirty": dirty, "check": list(check_ranks),
                "want_arrays": want_arrays and r == 0}, None))
        except Exception:
            arrays, _ = self._distmesh().tick_arrays(shape, seed, tick)
            return self._solve_local(arrays, statics, dirty, "degraded")
        return self._collect(replies, "seeded", want_arrays)

    def solve_frame(self, arrays: dict, statics: dict,
                    dirty=None, want_arrays: bool = False) -> dict:
        """One distributed solve of caller-supplied arrays (the frame
        arrived whole): the slot tables are sliced per host, so each rank
        still places only its host's slab."""
        if not self._check():
            return self._solve_local(
                arrays, statics, dirty,
                "degraded" if self._degraded else "local")
        dm = self._distmesh()
        nproc, L = self.workers + 1, self.local_devices
        dp = self.mesh_info["dp"]
        N = statics["E"] + statics["n_max"]
        Np = ((N + dp - 1) // dp) * dp

        def pad0(a, rows):
            a = np.asarray(a)
            out = np.zeros((rows,) + a.shape[1:], a.dtype)
            out[:a.shape[0]] = a
            return out

        ex_alloc = pad0(arrays["ex_alloc"], Np)
        ex_used0 = pad0(arrays["ex_used0"], Np)
        compat = np.asarray(arrays["ex_compat"])
        ex_compat = np.zeros(compat.shape[:1] + (Np,), compat.dtype)
        ex_compat[:, :compat.shape[1]] = compat
        repl = {k: np.asarray(v) for k, v in arrays.items()
                if k not in ("ex_alloc", "ex_used0", "ex_compat")
                and v is not None}

        def frame_for(r):
            lo, hi = dm.local_slot_rows(Np, nproc, r // L)
            payload = dict(repl)
            payload["ex_alloc"] = ex_alloc[lo:hi]
            payload["ex_used0"] = ex_used0[lo:hi]
            payload["ex_compat"] = ex_compat[:, lo:hi]
            slabs = {
                "ex_alloc": [lo, hi, 0, [Np, ex_alloc.shape[1]]],
                "ex_used0": [lo, hi, 0, [Np, ex_used0.shape[1]]],
                "ex_compat": [lo, hi, 1, [ex_compat.shape[0], Np]],
            }
            msg = {"cmd": "solve_frame", "dirty": dirty,
                   "want_arrays": want_arrays and r == 0, "slabs": slabs}
            msg.update({k: int(v) for k, v in statics.items()})
            return msg, payload

        try:
            replies = self._broadcast(frame_for)
        except Exception:
            return self._solve_local(arrays, statics, dirty, "degraded")
        return self._collect(replies, "frame", want_arrays)

    def _collect(self, replies, mode_label, want_arrays):
        fps = {r["fingerprint"] for r, _ in replies}
        if len(fps) != 1:
            # ranks disagreeing on a replicated output is a correctness
            # emergency, not a retry case
            self.degrade(reason="fingerprint_split")
            raise RuntimeError(
                f"cross-process fingerprint mismatch: {sorted(fps)}")
        r0, arrays0 = replies[0]
        if self.metrics is not None:
            self.metrics.inc("karpenter_solver_distmesh_dispatch_total",
                             labels={"mode": mode_label})
        keep = ("rank", "mode", "timing", "mesh", "launches", "slot_rows",
                "checks", "wall_s")
        return {"out": arrays0 if want_arrays else None,
                "fingerprint": r0["fingerprint"], "mode": r0["mode"],
                "timing": r0.get("timing", {}),
                "wall_s": r0.get("wall_s"), "distributed": True,
                "ranks": [{k: r[k] for k in keep if k in r}
                          for r, _ in replies]}

    def solve_batch(self, stack: np.ndarray, kv: dict
                    ) -> Optional[np.ndarray]:
        """Route SolveBatch lanes across the group: contiguous lane spans
        per rank, each solved by K4 on that rank's device, reassembled in
        order. None when the group cannot serve (degraded, routing error):
        the caller keeps its local path."""
        if not self._check():
            return None
        stack = np.asarray(stack)
        B = stack.shape[0]
        nranks = len(self._socks)
        spans = []
        base, extra = divmod(B, nranks)
        at = 0
        for r in range(nranks):
            take = base + (1 if r < extra else 0)
            spans.append((at, at + take))
            at += take

        def batch_for(r):
            lo, hi = spans[r]
            if hi == lo:  # an empty span still makes its round trip: the
                # broadcast is strict send-all/recv-all
                lo, hi = 0, 1
            return ({"cmd": "solve_batch",
                     "kv": {k: int(v) for k, v in kv.items()}},
                    {"stack": stack[lo:hi]})

        try:
            replies = self._broadcast(batch_for)
        except Exception:
            return None
        parts = []
        for r, (_, arrays) in enumerate(replies):
            lo, hi = spans[r]
            parts.append(arrays["out"][:hi - lo])
        self.last_batch = [dict(span=spans[r], launches=rep.get("launches",
                                                                 {}))
                           for r, (rep, _) in enumerate(replies)]
        if self.metrics is not None:
            self.metrics.inc("karpenter_solver_distmesh_dispatch_total",
                             labels={"mode": "batch"})
        return np.concatenate(parts, axis=0)

    def solve_oracle(self, shape: dict, seed: int, tick: int,
                     want_arrays: bool = False) -> dict:
        """The fingerprint baseline, computed in THIS process on its
        device by the single-device mesh dispatch
        (``distmesh.oracle_out``)."""
        dm = self._distmesh()
        arrays, statics = dm.tick_arrays(shape, seed, tick)
        out = dm.oracle_out(arrays, device=self.device, **statics)
        return {"out": out if want_arrays else None,
                "fingerprint": dm.result_fingerprint(out)}
