"""The CUDA solver: the packed FFD group scan behind the Solver interface.

The counterpart of the main path of the reference's ``TPUSolver``
(solver/tpu.py ``_solve_core`` on the device): encode, pad into pow2
shape buckets (``_prep_device_inputs``), pack one int64 arena
(ops/hostpack.py), move it to the device, run one packed solve, fetch
the one output buffer, unpack it, and decode. The new-node slot bucket
grows x4 and re-solves when a solve runs out of slots with pods left
over, exactly as the reference does.

``incremental=True`` (the default, as in the reference) is the warm
provisioning tick: the ``DeltaEncoder`` (models/delta.py) patches the
resident encoding, ``_arena_for`` patches the resident packed arena in
place (hostpack ``patch_inputs1``), and the solve is either the
checkpointed full scan (ops/ffd_torch.py ``solve_scan_packed1_ckpt``),
which records a device-resident bank of carries every CKPT_CHUNK groups,
or — on a steady-state tick whose dirty rows sit past a frontier — the
suffix re-solve from that bank (``solve_scan_suffix``, policy in
solver/incremental.py and ``_try_suffix``). Only the packed arena and
the output buffer cross between host and device; the bank stays on the
device. ``incremental=False`` encodes every snapshot from scratch and
runs ``solve_scan_packed1``.

The fused block scan (K5) follows the reference's plan
(``_prep_device_inputs``): without minValues floors and with
``dev_fuse_min_groups`` <= Gp <= ``dev_max_groups`` the arena is packed
at F = ``dev_fuse`` (4) with the encoder's ``fuse`` flags (admit runs
ANDed with existing-compat runs, the pad tail True), and the solve runs
``solve_scan_packed1(F=4)``, recorded as ``kernel="fused"``, an
incremental one too (the checkpointed scan is unfused). Single and
batch dispatches record ``fuse``, ``scan_steps``, ``fused_blocks`` and
``seq_blocks`` as the reference does.

The G axis follows the reference's routing (solver/tpu.py): past the
base scan's padded group cap (``dev_max_groups``, 4096) a solve runs the
pruned scan (ops/ffd_torch.py ``solve_scan_packed1_pruned``, K6) up to
``dev_max_groups_pruned`` (16384) groups. The host engine (ops/ffd.py,
``_run_host``) serves the snapshots that never reach the card: no
instance types (``no_types``), a group count past the effective cap
(``group_cap``; 4096 with minValues floors) and a priority arena past the
base cap (``priority_cap``). A pruned solve whose bail word is set
re-solves the same arena on the card with every slot selected (S = N:
exact, it cannot bail; ``reason="pruned_bail"``). Each solve is recorded
in ``last_dispatch_stats`` (``kernel``, ``reason``, ``bails``);
decisions never depend on which engine served. ``solve_batch`` runs many
snapshots of one statics bucket in one dispatch
(``solve_scan_packed1_many``, K4).

Topology spread and required pod (anti-)affinity follow the reference's
topology routing: inside the device pour's envelope (no existing nodes,
no minValues floors, no duplicate counter terms in a group) the solve
runs the topology scan (ops/topo_torch.py ``dispatch_topo``, K9) on
unpacked inputs; outside it, with no instance types, past
``dev_max_groups`` or where the pour cannot lay the groups' listed
counter rows out in one block's shared memory (asked before the first
launch), the host pour (ops/topo.py through ``_run_host``; ``reason``
``topo_envelope`` / ``no_types`` / ``group_cap`` / ``topo_layout``). A group
that overflows the event log bails, and the same inputs are solved
again on the device at ``safe_evcap`` (``reason="topo_bail"``). The
decode replays each topology group's placement runs from its event log
(``_runs_from_events``).

The sharded scan (K10) follows the reference's mesh route (solver/tpu.py
``_dispatch_mesh``): ``CUDASolver(mesh=comm)`` with a ``MeshComm``
(parallel/mesh.py) of more than one rank, or ``force_mesh=True`` at one,
solves SPMD: every rank calls ``solve`` on the same snapshot, runs its
shard of the scan (``dispatch_mesh``: the type mesh, or pods x types past
``dp2_min_slots`` slots without minValues floors) and decodes the same
gathered outputs. As in the reference the mesh arena carries no priority
section (Q = 0; the canonical group order already encodes priority), no
fused plan, no checkpoint bank and no pruned scan (past
``dev_max_groups`` the host engine serves, ``reason="group_cap"``); the
resident shard is patched with the delta's dirty fields (arrays only, no
packed arena). ``last_dispatch_stats`` records ``kernel="mesh"``,
``mesh_kernel`` (tp / dp2), ``ndp``, ``ntp``, ``backend``, ``placement``
(full / patch / reuse) and the collectives. Batches,
consolidation and preemption dispatches run single-device on each rank,
replicated (``mesh="replicated"``).

Soft preferences (preferred affinity, ScheduleAnyway spread) ride the
reference's relaxation wrapper (solver/preferences.py, through
``Solver.solve``): each relax round is a full ``_solve_core`` on the
hardened snapshot. Topology the pour does not model (a spread or
affinity key other than zone or hostname, or a zone-id requirement mixed
with topology: ``TopoEncoding.supported`` False) goes to the sequential
CPU oracle, as the reference's ``_oracle_fallback`` sends it
(``kernel="oracle"``, ``reason="unsupported_topology"``): decided from
the encoding before any launch, it launches no kernel.

There is no router or host twin here: on a CUDA device a solve the
kernels take runs them or raises, and nothing catches a kernel failure.
``device="cpu"`` runs the plain PyTorch versions of the same kernels
(tests).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..apis import labels as L
from ..apis.requirements import IN, Requirement, Requirements
from ..apis.resources import Resources
from ..models.delta import DeltaEncoder, full_existing_encode
from ..models.encoding import SnapshotEncoding, encode_snapshot
from ..models.encoding import canonical_pod_groups, independent_runs
from ..ops import ffd, ffd_cuda, topo_cuda
from ..ops.consolidation_torch import subset_solve
from ..ops.ffd_torch import (block_indep, kernel_inputs_from_numpy,
                             solve_scan_packed1,
                             solve_scan_packed1_ckpt,
                             solve_scan_packed1_many,
                             solve_scan_packed1_pruned, solve_scan_suffix)
from ..ops.hostpack import (DEV_FUSE, DEV_PRUNED_SLOTS, pack_inputs1,
                            pack_inputs1_state, patch_inputs1,
                            tier_leftovers, unpack_outputs1)
from ..ops.topo import (TopoState, build_topo_encoding, fill_group_topo,
                        record_plain_fill)
from ..ops.topo_torch import (K_ANTIRUN, K_CYC, dispatch_topo,
                              topo_rows_from_numpy)
from ..parallel.mesh import DP2_MIN_SLOTS, dispatch_mesh
from ..scheduling.preempt_torch import preempt_solve
from .cpu import CPUSolver
from .incremental import CKPT_CHUNK, ckpt_eligible, live_bound, suffix_plan
from .preferences import preference_count
from .types import (ExistingNode, NewNodeClaim, SchedulingSnapshot,
                    SolveResult, Solver)


def _slotmap(E: int, Ep: int, N: int) -> np.ndarray:
    """Row indices that drop the dead padded existing slots [E, Ep)."""
    return np.concatenate([np.arange(E), np.arange(Ep, N)])


def _runs_from_events(ev, gi: int):
    """The host pour's placement-run list of group ``gi`` from its row of
    the device event log (ops/topo_torch.py kinds): consecutive same-slot
    runs merge (ops/topo.py ``_commit``), a cyc entry's pattern is the
    last ``p`` events of the host-equivalent event tail, and the tail
    grows by the pattern after a jump exactly as the host's event log
    does. An anti run of m = 0 emits nothing. (The reference's
    solver/tpu.py function of the same name.)"""
    n = int(ev["n"][gi])
    runs = []
    tail = []  # (slot, len) of the host-equivalent event log tail
    for i in range(n):
        kind = int(ev["kind"][gi, i])
        slot = int(ev["slot"][gi, i])
        ln = int(ev["len"][gi, i])
        if kind == K_CYC:
            p = ln
            k = int(ev["aux"][gi, i])
            pattern = tail[-p:]
            runs.append(("cyc", list(pattern), k))
            tail.extend(pattern * (k if k < 3 else 2))
        elif kind == K_ANTIRUN:
            for j in range(ln):
                runs.append((slot + j, 1))
                tail.append((slot + j, 1))
        else:  # place / fix / open
            if runs and runs[-1][0] == slot:
                runs[-1] = (slot, runs[-1][1] + ln)
            else:
                runs.append((slot, ln))
            tail.append((slot, ln))
        if len(tail) > 64:
            del tail[:len(tail) - 64]
    return runs


def topo_arrays(enc: SnapshotEncoding, tenc):
    """The device pour's inputs of one encoding (the reference's
    ``_run_jax_topo`` padding): the base arrays with G, P padded to powers
    of two and no existing nodes, and the dense topology rows
    (``CUDASolver._topo_rows``) padded to Gp and to the counter buckets
    GZp / GHp (powers of two), with BIG as the skew pad and -1 as the
    membership pad. Returns (arrays, rows, statics Z/P/GZ/GH)."""
    D = enc.A.shape[1]
    G = len(enc.groups)
    z = np.zeros((0, D), np.int64)
    arrays, stt = pad_device_inputs(enc, z, z, np.zeros((G, 0), bool))
    for k in ("mv_floor", "mv_pairs_t", "mv_pairs_v", "prio"):
        arrays.pop(k, None)
    Gp = stt["G"]
    rows, GZ, GH = CUDASolver._topo_rows(enc, tenc)
    GZp = max(1, 1 << (GZ - 1).bit_length())
    GHp = max(1, 1 << (GH - 1).bit_length())
    big = np.int64(1) << 60

    def padC(a, width, fill):
        out = np.full((Gp, width), fill, a.dtype)
        out[:G, :a.shape[1]] = a
        return out

    topo_rows = dict(
        has_topo=np.pad(rows["has_topo"], (0, Gp - G)),
        zone_needed=np.pad(rows["zone_needed"], (0, Gp - G)),
        min_mask=np.pad(rows["min_mask"], [(0, Gp - G), (0, 0)]),
        zs_any=padC(rows["zs_any"], GZp, False),
        zs_skew=padC(rows["zs_skew"], GZp, big),
        hs_any=padC(rows["hs_any"], GHp, False),
        hs_skew=padC(rows["hs_skew"], GHp, big),
        za_any=padC(rows["za_any"], GZp, False),
        za_anti=padC(rows["za_anti"], GZp, False),
        za_own=padC(rows["za_own"], GZp, False),
        ha_any=padC(rows["ha_any"], GHp, False),
        ha_anti=padC(rows["ha_anti"], GHp, False),
        ha_own=padC(rows["ha_own"], GHp, False),
        member_z=np.pad(rows["member_z"], (0, Gp - G), constant_values=-1),
        member_h=np.pad(rows["member_h"], (0, Gp - G), constant_values=-1),
    )
    return arrays, topo_rows, dict(Z=stt["Z"], P=stt["P"], GZ=GZp, GH=GHp)


def safe_evcap(arrays: dict, rows: dict) -> int:
    """An event-log capacity the pour cannot overflow: every event places
    at least one pod except an anti run of m = 0, which ends its pool's
    opens (its budget or the free slots are spent), so a group logs at
    most n + P events; the next power of two of the largest topology
    group's n + P + 2."""
    n = np.asarray(arrays["n"])[np.asarray(rows["has_topo"], bool)]
    top = int(n.max()) if n.size else 0
    P = np.asarray(arrays["pool_types"]).shape[0]
    return 1 << (top + P + 2 - 1).bit_length()


def pad_device_inputs(enc: SnapshotEncoding, ex_alloc, ex_used, ex_compat):
    """Pad one snapshot's encoding into the kernel's shape buckets: G, E
    and P to powers of two (padded groups have n=0 and all-False rows,
    padded existing rows are dead, padded pools admit nothing) and D to
    8. Returns ``(arrays, statics)``; statics carry every pack/dispatch
    static except n_max, with F = 1 (``CUDASolver._prep_device_inputs``
    adds the fused-scan plan)."""
    T, D = enc.A.shape
    Z, C = len(enc.zones), enc.avail.shape[2]
    P = len(enc.pools)
    E = ex_alloc.shape[0]
    G = len(enc.groups)
    Gp = max(1, 1 << (G - 1).bit_length())
    Ep = 1 << (E - 1).bit_length() if E else 0
    Pp = max(1, 1 << (P - 1).bit_length())
    Dp = max(8, D)

    def padG(a):
        return np.pad(a, [(0, Gp - G)] + [(0, 0)] * (a.ndim - 1))

    def padD(a):
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, Dp - D)])

    arrays = dict(
        A=padD(enc.A),
        avail_zc=enc.avail.reshape(T, Z * C),
        R=padG(padD(enc.R)), n=padG(enc.n), F=padG(enc.F),
        agz=padG(enc.agz), agc=padG(enc.agc),
        admit=np.pad(padG(enc.admit), [(0, 0), (0, Pp - P)]),
        daemon=np.pad(padG(padD(enc.daemon)),
                      [(0, 0), (0, Pp - P), (0, 0)]),
    )
    pool_types = np.zeros((Pp, T), bool)
    pool_agz = np.zeros((Pp, Z), bool)
    pool_agc = np.zeros((Pp, C), bool)
    pool_limit = np.zeros((Pp, Dp), np.int64)  # limit 0: padded pools inert
    pool_used0 = np.zeros((Pp, Dp), np.int64)
    for p in enc.pools:
        pool_types[p.index] = p.type_rows
        pool_agz[p.index] = p.agz
        pool_agc[p.index] = p.agc
        lim = p.limit_vec if p.limit_vec is not None \
            else np.full(D, -1, dtype=np.int64)
        pool_limit[p.index, :D] = lim
        pool_limit[p.index, D:] = -1
        pool_used0[p.index, :D] = p.in_use_vec
    arrays.update(pool_types=pool_types, pool_agz=pool_agz,
                  pool_agc=pool_agc, pool_limit=pool_limit,
                  pool_used0=pool_used0)
    ex_alloc_p = np.zeros((Ep, Dp), np.int64)
    ex_used_p = np.zeros((Ep, Dp), np.int64)
    ex_compat_p = np.zeros((Gp, Ep), bool)
    if E:
        ex_alloc_p[:E, :D] = ex_alloc
        ex_used_p[:E, :D] = ex_used
        ex_compat_p[:G, :E] = ex_compat
    arrays.update(ex_alloc=ex_alloc_p, ex_used0=ex_used_p,
                  ex_compat=ex_compat_p)
    K, V, M = enc.mv_K, enc.mv_V, enc.mv_M
    if K:
        mv_floor_p = np.zeros((Pp, K), np.int64)
        mv_floor_p[:P] = enc.mv_floor
        arrays.update(mv_floor=mv_floor_p, mv_pairs_t=enc.mv_pairs_t,
                      mv_pairs_v=enc.mv_pairs_v)
    Q = 0
    if enc.prio is not None:
        Q = 1
        arrays["prio"] = padG(enc.prio)
    return arrays, dict(T=T, D=Dp, Z=Z, C=C, G=Gp, E=Ep, P=Pp,
                        K=K, V=V, M=M, F=1, Q=Q)


def _unpad(out: dict, G: int, E: int, Ep: int, n_bucket: int, D: int):
    """(takes [G, E + n_bucket], leftover [G], final) of one padded
    solve's outputs: padded groups, the dead padded existing rows
    [E, Ep) and the padded dims dropped."""
    takes = out["takes"][:G]
    takes = np.concatenate([takes[:, :E], takes[:, Ep:]], axis=1)
    sm = _slotmap(E, Ep, Ep + n_bucket)
    final = dict(
        types=out["types"][sm], zones=out["zones"][sm],
        ct=out["ct"][sm], pool=out["pool"][sm],
        alive=out["alive"][sm], used=out["used"][sm][:, :D], E=E)
    return takes, out["leftover"][:G], final


def fuse_flags(enc: SnapshotEncoding, ex_compat, Gp: int) -> np.ndarray:
    """The [Gp] ``fuse`` flags of the fused-scan plan: the encoder's
    admit runs ANDed with the existing-compat runs (a block inside one
    combined run is pairwise disjoint on both contention axes), the
    padded tail True (its groups place nothing)."""
    fuse = enc.fused_runs().copy()
    if ex_compat.shape[1]:
        fuse &= independent_runs(ex_compat)
    return np.concatenate([fuse, np.ones(Gp - len(enc.groups), dtype=bool)])


def dispatch_shape(Gp: int, Fu: int, fuse=None, fused_blocks: int = 0
                   ) -> dict:
    """The reference's dispatch evidence (solver/tpu.py
    ``_record_dispatch``): the block width, the scan's step count and
    its vectorized / sequential block split (``fused_blocks`` counted
    from ``fuse`` when given, else as passed: a batch's per-lane mean)."""
    steps = Gp // Fu if Fu > 1 else Gp
    if fuse is not None and Fu > 1:
        fused_blocks = fused_block_count(fuse, Fu)
    return dict(fuse=Fu, scan_steps=steps, fused_blocks=fused_blocks,
                seq_blocks=steps - fused_blocks)


def fused_block_count(fuse: np.ndarray, Fu: int) -> int:
    """How many of the Gp/Fu blocks take the vectorized branch (the
    reference's ``_fused_block_count``)."""
    return int(block_indep(torch.from_numpy(np.asarray(fuse)), Fu).sum())


class CUDASolver(Solver):
    name = "cuda"

    def __init__(self, n_max: int = 2048, device=None,
                 incremental: bool = True, *, mesh=None,
                 force_mesh: bool = False, dp: int = None,
                 dp2_min_slots: int = DP2_MIN_SLOTS):
        """n_max sizes the new-node slot arrays per solve. It is a
        CAPACITY, not a decision bound: a solve that exhausts every slot
        with pods left over grows n_max (x4, capped at the pod count) and
        re-runs, so decisions match the oracle, which opens nodes
        unboundedly. ``device`` defaults to cuda and raises without it.

        incremental: keep the last solve's encoding, packed arena and
        checkpoint bank RESIDENT and serve steady-state ticks by patching
        them (module docstring); off is the from-scratch path.

        mesh: a ``parallel.mesh.MeshComm``; with more than one rank (or
        ``force_mesh``) solves run the sharded scan (module docstring),
        ``dp`` and ``dp2_min_slots`` as ``dispatch_mesh`` takes them. A
        rank's device defaults to ``cuda:{rank % device_count}``."""
        if mesh is not None and device is None:
            _device.resolve("cuda")   # raises without a card
            device = f"cuda:{mesh.rank % torch.cuda.device_count()}"
        self.device = _device.resolve(device)
        #: the mesh communicator (None: one device)
        self.mesh = mesh
        self.force_mesh = force_mesh
        self.dp = dp
        self.dp2_min_slots = dp2_min_slots
        #: the mesh dispatch's cache: the resident shard, its placement
        self._mesh_cache: dict = {}
        self.n_max = n_max
        #: incremental encoder (None = from scratch every solve)
        self._delta = DeltaEncoder() if incremental else None
        #: the LAST encode's SnapshotDelta
        self._last_delta = None
        #: resident packed arena: dict(enc, arrays, stt, buf, bflat,
        #: version) — reused/patched by _arena_for
        self._pack_cache = None
        #: resident checkpoint bank: dict(key, CK, GL, token, bank, takes,
        #: leftover); the bank's tensors stay on self.device, takes and
        #: leftover are host copies of the padded rows it solves for
        self._ckpt_bank = None
        #: "full" or "suffix@<SUF>" of the LAST solve
        self._solve_mode = "full"
        #: current new-node slot bucket; grows on overflow, sticky across
        #: solves, shrinks back after 8 solves of small peaks
        self._bucket = min(256, n_max)
        self._bucket_peaks: list = []
        #: group/encode/kernel/decode wall split of the LAST solve (ms):
        #: group is the canonical pod grouping (Solver.solve), kernel
        #: covers pack/patch + h2d + the packed solve + d2h + unpack;
        #: plus ``solve`` ("full" or "suffix@<SUF>") and, when
        #: incremental, ``cache`` (the delta tier) and ``patched_rows``
        self.last_phase_stats: dict = {}
        #: kernel launches of the LAST solve (all of its bucket retries),
        #: per kernel, plus the slot bucket, the retry count, the kernel
        #: path, the full-solve reason and, for a suffix, resume_group,
        #: suffix_bucket and suffix_groups
        self.last_dispatch_stats: dict = {}
        self.last_tier_leftovers: dict = {}
        #: the union arena of the last consolidation subset round on
        #: self.device: (arrays, tprice, KernelInputs, tprice tensor),
        #: reused while the caller hands the same arrays back
        self._sub_arena = None
        #: BASE scan cap: past this padded group count the [N, T]-per-step
        #: scan is not run (its cost is O(G * N * T))
        self.dev_max_groups = 4096
        #: PRUNED scan cap: solves between the two caps ride the pruned
        #: kernel (no minValues floors, no priority section); a solve whose
        #: pruning was insufficient re-solves with every slot selected
        self.dev_max_groups_pruned = 16384
        #: exact-slot budget S per pruned step
        self.dev_pruned_slots = DEV_PRUNED_SLOTS
        #: fused-group block width of the base scan (K5): groups the
        #: encoder proves pairwise pool/existing-disjoint fill dev_fuse
        #: to a block. 0/1 disables. Gated per solve on no minValues
        #: floors and dev_fuse_min_groups <= Gp <= dev_max_groups.
        self.dev_fuse = DEV_FUSE
        #: below this padded group count the unfused scan serves
        self.dev_fuse_min_groups = 64
        # the grouping walk's one-shot build is paid here, never by the
        # first solve (the reference's constructor does the same)
        from ..models.encoding import _groupwalk
        _groupwalk()
        #: the sequential oracle for topology the pour does not model
        self._cpu_fallback = CPUSolver()

    def _oracle_fallback(self, snapshot: SchedulingSnapshot,
                         reason: str) -> SolveResult:
        """The reference's ``_oracle_fallback``: the oracle's full
        ``solve`` (its wrapper passes the hardened pods through)."""
        import logging
        logging.getLogger(__name__).warning(
            "CUDA solver falling back to CPU oracle (%s): %d pods",
            reason, len(snapshot.pods))
        if self.metrics is not None:
            self.metrics.inc("karpenter_solver_oracle_fallback_total",
                             labels={"reason": reason})
        return self._cpu_fallback.solve(snapshot)

    def solve(self, snapshot: SchedulingSnapshot) -> SolveResult:
        """Slot growth (``_grow_if_exhausted``) is scoped to ONE solve."""
        orig_n_max = self.n_max
        try:
            return super().solve(snapshot)
        finally:
            self.n_max = orig_n_max
            self._bucket = min(self._bucket, orig_n_max)

    def _grow_if_exhausted(self, snapshot: SchedulingSnapshot,
                           leftover, final) -> bool:
        """True iff the solve ran out of new-node slots with pods left
        over AND growing can help — the caller then re-solves with 4x
        slots."""
        if self.n_max >= len(snapshot.pods):
            return False  # nodes <= pods: genuine unschedulability
        if int(np.asarray(leftover).sum()) <= 0:
            return False
        alive = np.asarray(final["alive"])
        if int(alive[final["E"]:].sum()) < self.n_max:
            return False  # slots to spare: leftovers are real
        self.n_max = min(self.n_max * 4, len(snapshot.pods))
        self._bucket = min(self._bucket, self.n_max)
        return True

    def _settle_bucket(self, n_bucket: int, used_slots: int) -> int:
        """Sticky-bucket shrink: after 8 solves whose new-node peak keeps
        4x headroom at the width below, step the bucket down the same
        16/64/256 ladder the grow loop walks."""
        self._bucket_peaks.append(int(used_slots))
        if len(self._bucket_peaks) > 8:
            self._bucket_peaks.pop(0)
        if len(self._bucket_peaks) == 8:
            peak = max(max(self._bucket_peaks), 1)
            while n_bucket > 16 and peak * 4 <= n_bucket // 4:
                n_bucket //= 4
        return n_bucket

    # ------------------------------------------------------------------
    def _solve_core(self, snapshot: SchedulingSnapshot,
                    pod_groups=None) -> SolveResult:
        if not snapshot.pods:
            return SolveResult(new_nodes=[], existing_assignments={},
                               unschedulable={})
        t0 = time.perf_counter()
        existing = sorted(snapshot.existing_nodes, key=lambda n: n.name)
        if self._delta is not None:
            enc, (ex_alloc, ex_used, ex_compat), self._last_delta = \
                self._delta.encode(snapshot, pod_groups, existing)
        else:
            enc = encode_snapshot(snapshot, pod_groups=pod_groups)
            ex_alloc, ex_used, ex_compat = full_existing_encode(enc,
                                                                existing)
            self._last_delta = None
        tenc = None
        if enc.topo_any:
            tenc = build_topo_encoding(enc, snapshot, existing)
            if not tenc.supported:
                # decided from the encoding, before any launch; the
                # oracle's wall is the split's kernel_ms
                self._solve_mode = "full"
                before = dict(ffd_cuda.LAUNCHES)
                t_enc = time.perf_counter()
                res = self._oracle_fallback(snapshot, "unsupported-topology")
                self.last_dispatch_stats = dict(
                    device=str(self.device), kernel="oracle",
                    reason="unsupported_topology", topo_reason=tenc.reason,
                    bails=0, batch=1, launches=self._launches_since(before))
                self._set_phase_stats(t0, t_enc, time.perf_counter())
                return res
        t_enc = time.perf_counter()
        if not enc.types:
            # zero-width type axis: only the host engine takes T == 0
            takes, leftover, final = self._run_host(
                enc, ex_alloc, ex_used, ex_compat, "no_types", tenc=tenc,
                existing=existing)
        elif tenc is not None:
            # the reference's topology routing (solver/tpu.py:303-345):
            # the device pour inside its envelope, else the host pour
            topo_in = None
            if len(enc.groups) > self.dev_max_groups:
                reason = "group_cap"
            elif not self._topo_lowerable(enc, tenc, existing):
                reason = "topo_envelope"
            else:
                topo_in = topo_arrays(enc, tenc)
                reason = None if self._pour_fits(*topo_in) \
                    else "topo_layout"
            if reason is None:
                takes, leftover, final = self._run_topo(enc, *topo_in)
            else:
                takes, leftover, final = self._run_host(
                    enc, ex_alloc, ex_used, ex_compat, reason, tenc=tenc,
                    existing=existing)
        elif len(enc.groups) > self._dev_group_cap(enc):
            takes, leftover, final = self._run_host(
                enc, ex_alloc, ex_used, ex_compat, "group_cap")
        else:
            takes, leftover, final = self._run_device(enc, ex_alloc,
                                                      ex_used, ex_compat)
        if self._grow_if_exhausted(snapshot, leftover, final):
            return self._solve_core(snapshot, pod_groups=pod_groups)
        t_k = time.perf_counter()
        res = self._decode(enc, existing, takes, leftover, final)
        self._set_phase_stats(t0, t_enc, t_k)
        return res

    def _set_phase_stats(self, t0: float, t_enc: float, t_k: float):
        """The group/encode/kernel/decode split of the solve that just
        ended (decode runs from ``t_k`` to now), its mode and, when
        incremental, its delta tier."""
        now = time.perf_counter()
        self.last_phase_stats = dict(group_ms=self.last_group_ms,
                                     encode_ms=(t_enc - t0) * 1e3,
                                     kernel_ms=(t_k - t_enc) * 1e3,
                                     decode_ms=(now - t_k) * 1e3,
                                     solve=self._solve_mode)
        d = self._last_delta
        if d is not None:
            self.last_phase_stats["cache"] = d.tier
            self.last_phase_stats["patched_rows"] = d.patched_rows

    @property
    def on_mesh(self) -> bool:
        """Whether solves run the sharded scan (a mesh of more than one
        rank, or one forced)."""
        return self.mesh is not None and (self.mesh.world > 1
                                          or self.force_mesh)

    def _dev_group_cap(self, enc: SnapshotEncoding) -> int:
        """Effective device group cap for this snapshot: the pruned
        kernel's envelope without minValues floors (and off a mesh), else
        the base's."""
        if enc.mv_K == 0 and not self.on_mesh:
            return self.dev_max_groups_pruned
        return self.dev_max_groups

    def _run_host(self, enc, ex_alloc, ex_used, ex_compat, reason: str,
                  tenc=None, existing=()):
        """The host engine (ops/ffd.py, the reference's ``_run_numpy``
        interpreted path: one closed-form fill per group over a NodeState
        of ``n_max`` new-node slots); with ``tenc`` the host pour
        (ops/topo.py: ``fill_group_topo`` for the topology groups, the
        closed form plus ``record_plain_fill`` for the rest, counters
        seeded from ``existing``). Records ``kernel="host"`` and the
        reason in ``last_dispatch_stats``."""
        self._solve_mode = "full"
        st = ffd.NodeState.create(enc, self.n_max, ex_alloc, ex_used,
                                  ex_compat)
        ts = None if tenc is None else TopoState.create(
            tenc, st.Z, st.N, st.E, existing)
        takes = np.zeros((len(enc.groups), st.N), dtype=np.int64)
        leftover = np.zeros(len(enc.groups), dtype=np.int64)
        run_log = {}
        for g in enc.groups:
            if ts is not None and tenc.has_topo[g.index]:
                take, rem, run_log[g.index] = fill_group_topo(
                    st, enc, tenc, ts, g.index)
            else:
                take, rem = ffd.fill_group_closed_form(st, enc, g.index)
                if ts is not None:
                    record_plain_fill(tenc, ts, st, g.index, take)
            takes[g.index] = take
            leftover[g.index] = rem
        self.last_dispatch_stats = dict(
            device=str(self.device), kernel="host", reason=reason,
            bails=0, batch=1, launches=self._launches_since(None))
        final = dict(types=st.types, zones=st.zones, ct=st.ct, pool=st.pool,
                     alive=st.alive, used=st.used, E=st.E, run_log=run_log,
                     zfix=None if ts is None else ts.zfix)
        return takes, leftover, final

    @staticmethod
    def _launches_since(before) -> dict:
        """Kernel launches since the ``before`` snapshot of the counters
        (all 0 without one)."""
        return {k: v - (before[k] if before else v)
                for k, v in ffd_cuda.LAUNCHES.items()}

    # ------------------------------------------------------------------
    def _prep_device_inputs(self, enc: SnapshotEncoding, ex_alloc, ex_used,
                            ex_compat, fuse: bool = True,
                            mesh: bool = False):
        """``pad_device_inputs`` plus the reference's fused-scan plan
        (solver/tpu.py ``_prep_device_inputs``): with ``fuse``, no
        minValues floors, ``dev_fuse`` > 1 and ``dev_fuse_min_groups`` <=
        Gp <= ``dev_max_groups``, the arena carries the [Gp] ``fuse``
        flags and F = ``dev_fuse``. The consolidation union arena passes
        ``fuse=False`` (its subset lanes scan unfused, as the reference's
        ``ndev=2`` call there). ``mesh``: the sharded scan's arrays, without
        the priority section (Q = 0) and unfused. Returns ``(arrays,
        statics)``."""
        arrays, stt = pad_device_inputs(enc, ex_alloc, ex_used, ex_compat)
        if mesh:
            arrays.pop("prio", None)
            stt["Q"] = 0
            return arrays, stt
        Gp = stt["G"]
        if (fuse and stt["K"] == 0 and self.dev_fuse > 1
                and self.dev_fuse_min_groups <= Gp <= self.dev_max_groups):
            arrays["fuse"] = fuse_flags(enc, ex_compat, Gp)
            stt["F"] = min(self.dev_fuse, Gp)   # both pow2: F divides Gp
        return arrays, stt

    def pack(self, enc, ex_alloc, ex_used, ex_compat):
        """(arena, statics) of one encoding — what the device solves."""
        arrays, stt = self._prep_device_inputs(enc, ex_alloc, ex_used,
                                               ex_compat)
        buf = pack_inputs1(arrays, stt["T"], stt["D"], stt["Z"], stt["C"],
                           stt["G"], stt["E"], stt["P"], stt["K"],
                           stt["M"], stt["F"], stt["Q"])
        return buf, stt

    def _dispatch(self, buf: np.ndarray, **statics) -> np.ndarray:
        """One packed solve on the solver's device: one h2d copy, the
        solve, one d2h copy (the only synchronisation)."""
        d_buf = torch.from_numpy(buf).to(self.device)
        return solve_scan_packed1(d_buf, **statics).cpu().numpy()

    def _dispatch_pruned(self, buf: np.ndarray, **statics) -> np.ndarray:
        """The pruned G-axis solve: the base output buffer plus one
        trailing bail word (S arrives in ``statics``)."""
        d_buf = torch.from_numpy(buf).to(self.device)
        return solve_scan_packed1_pruned(d_buf, **statics).cpu().numpy()

    def _dispatch_many(self, bufs, **statics) -> np.ndarray:
        """B packed solves of one statics bucket in ONE dispatch: one
        h2d copy of the [B, W] stack, ``solve_scan_packed1_many``, one
        d2h copy of the [B, Wout] rows."""
        d_bufs = torch.from_numpy(np.stack(bufs)).to(self.device)
        return solve_scan_packed1_many(d_bufs, **statics).cpu().numpy()

    def _dispatch_ckpt(self, buf: np.ndarray, **statics):
        """The checkpointed full solve: the output buffer comes back to
        the host, the bank stays on the device."""
        d_buf = torch.from_numpy(buf).to(self.device)
        o_buf, bank = solve_scan_packed1_ckpt(d_buf, **statics)
        return o_buf.cpu().numpy(), bank

    def _dispatch_suffix(self, buf: np.ndarray, bank, **statics):
        """The suffix re-solve against the resident bank (spliced in
        place on the device); only the arena and the output cross."""
        d_buf = torch.from_numpy(buf).to(self.device)
        o_buf, bank = solve_scan_suffix(d_buf, bank, **statics)
        return o_buf.cpu().numpy(), bank

    # -- the resident packed arena -------------------------------------
    def _patch_pack_cache(self, pc, enc, ex_alloc, ex_used, ex_compat, d):
        """Bring the resident padded arrays + packed arena up to the
        current delta: re-pad only the dirty fields (the delta's
        dirty_fields() vocabulary) and patch their sections of the
        packed buffer in place (hostpack ``patch_inputs1``). Only fields
        a ``rows``-tier delta can move are handled. Returns the dirty
        field names (a mesh entry has no packed arena to patch)."""
        arrays, stt = pc["arrays"], pc["stt"]
        D = len(enc.dims)
        G, E = len(enc.groups), ex_alloc.shape[0]
        # prio never moves on a hit/rows tick (priority is part of the
        # signature), so it is never among these
        dirty64, dirtyb = d.dirty_fields()
        if "n" in dirty64:
            arrays["n"][:G] = enc.n
        if "pool_limit" in dirty64:
            pl, pu = arrays["pool_limit"], arrays["pool_used0"]
            for p in enc.pools:
                lim = p.limit_vec if p.limit_vec is not None \
                    else np.full(D, -1, dtype=np.int64)
                pl[p.index, :D] = lim
                pl[p.index, D:] = -1
                pu[p.index, :D] = p.in_use_vec
        if "ex_alloc" in dirty64:
            ap, up = arrays["ex_alloc"], arrays["ex_used0"]
            ap[:] = 0
            up[:] = 0
            if E:
                ap[:E, :D] = ex_alloc
                up[:E, :D] = ex_used
        if "ex_compat" in dirtyb:
            cp = arrays["ex_compat"]
            cp[:] = False
            if E:
                cp[:G, :E] = ex_compat
            if "fuse" in arrays:
                # the fused-scan plan ANDs the admit runs (unchanged in a
                # rows-tier delta) with the existing-compat runs
                arrays["fuse"][:] = fuse_flags(enc, ex_compat, stt["G"])
                dirtyb = dirtyb + ["fuse"]
        if (dirty64 or dirtyb) and pc["buf"] is not None:
            patch_inputs1(pc["buf"], pc["bflat"], arrays, dirty64, dirtyb,
                          stt["T"], stt["D"], stt["Z"], stt["C"], stt["G"],
                          stt["E"], stt["P"], stt["K"], stt["M"], stt["F"],
                          stt["Q"])
        return dirty64 + dirtyb

    def _arena_for(self, enc, ex_alloc, ex_used, ex_compat):
        """(arrays, stt, buf, dirty): the resident packed arena when the
        delta tier proves the shape class unchanged (same resident
        encoding object, same padded E bucket) — reused as is on a clean
        tick, patched in its dirty sections otherwise — else a fresh
        pack. A buffer lagging the encoder by more than one version
        (solves refused in between) is re-packed, never patched. On a
        mesh only the arrays are kept (``buf`` None), and ``dirty`` is
        the fields that moved since the last dispatch (None: unknown, the
        resident shard is placed whole)."""
        E = ex_alloc.shape[0]
        d = self._last_delta
        dver = self._delta.version if self._delta is not None else None
        pc = self._pack_cache
        if (pc is not None and d is not None and dver is not None
                and d.tier in ("hit", "rows")
                and pc["enc"] is enc
                and pc["stt"]["E"] == (1 << (E - 1).bit_length()
                                       if E else 0)
                and pc["version"] in (dver, dver - 1)):
            dirty = []
            if pc["version"] != dver:
                dirty = self._patch_pack_cache(pc, enc, ex_alloc, ex_used,
                                               ex_compat, d)
                pc["version"] = dver
            return pc["arrays"], pc["stt"], pc["buf"], dirty
        arrays, stt = self._prep_device_inputs(enc, ex_alloc, ex_used,
                                               ex_compat, mesh=self.on_mesh)
        buf = bflat = None
        if not self.on_mesh:
            buf, bflat = pack_inputs1_state(arrays, stt["T"], stt["D"],
                                            stt["Z"], stt["C"], stt["G"],
                                            stt["E"], stt["P"], stt["K"],
                                            stt["M"], stt["F"], stt["Q"])
        self._pack_cache = None if dver is None else dict(
            enc=enc, arrays=arrays, stt=stt, buf=buf, bflat=bflat,
            version=dver)
        return arrays, stt, buf, None

    # -- incremental solve (checkpointed scan prefix reuse) ------------
    def _bank_prev_token(self):
        """The ``(epoch, version)`` the resident arena held BEFORE this
        encode — where a bank must sit to be restorable: the current
        delta describes exactly the transition from that token to now.
        None when incremental encoding is off."""
        d, de = self._last_delta, self._delta
        if d is None or de is None:
            return None
        bumped = (d.n_dirty or d.pools_dirty or d.ex_rows_dirty
                  or d.ex_compat_dirty)
        return (de.epoch, de.version - (1 if bumped else 0))

    @staticmethod
    def _ckpt_statics(stt: dict, n_bucket: int) -> dict:
        """The solves' statics for this arena minus the fused width F
        (the ckpt/suffix scans are unfused: eligibility needs F = 1)."""
        return dict(T=stt["T"], D=stt["D"], Z=stt["Z"], C=stt["C"],
                    G=stt["G"], E=stt["E"], P=stt["P"], K=stt["K"],
                    V=stt["V"], M=stt["M"], Q=stt["Q"], n_max=n_bucket)

    def _adopt_bank(self, buf, stt, n_bucket, bank, out, CK) -> None:
        """Install a freshly recorded bank + the padded takes/leftover it
        solves for, stamped with the encoder token the arena now sits
        at. (The reference also pre-compiles the suffix ladder here,
        ``_prime_suffix``; these kernels are built once per process and
        take any shape, so there is nothing to prime.)"""
        gl = live_bound(buf, T=stt["T"], D=stt["D"], G=stt["G"], CK=CK)
        self._ckpt_bank = dict(
            key=(tuple(sorted(stt.items())), n_bucket), CK=CK, GL=gl,
            token=self._delta.state_token(), bank=bank,
            takes=out["takes"].copy(), leftover=out["leftover"].copy())

    def _try_suffix(self, buf, stt, n_bucket):
        """Serve this solve from the resident bank if every validity edge
        holds. Returns ``(out, reason, info)``: ``out`` is the full
        unpacked result (suffix rows spliced over the resident takes/
        leftover, carry fields straight from the suffix) or None, with
        ``reason`` naming why a full solve runs."""
        d = self._last_delta
        if d is None or self._delta is None:
            return None, "disabled", None
        if d.tier not in ("hit", "rows"):
            return None, "tier", None
        bk = self._ckpt_bank
        if bk is None:
            return None, "cold", None
        key = (tuple(sorted(stt.items())), n_bucket)
        if bk["key"] != key:
            return (None,
                    "bucket" if bk["key"][0] == key[0] else "shape", None)
        tok = self._bank_prev_token()
        if bk["token"] != tok:
            return (None,
                    "epoch" if bk["token"][0] != tok[0] else "version_lag",
                    None)
        if d.dirty_frontier <= 0:
            return None, "frontier", None
        Gp, CK = stt["G"], bk["CK"]
        gl = live_bound(buf, T=stt["T"], D=stt["D"], G=Gp, CK=CK)
        if gl != bk["GL"] or gl <= 0:
            # the live bound moved under a rows tick: re-record at the
            # new bound rather than scan a stale region
            return None, "shape", None
        jr, SUF = suffix_plan(min(d.dirty_frontier, Gp), Gp, CK, GL=gl)
        o_buf, bank = self._dispatch_suffix(
            buf, bk["bank"], CK=CK, SUF=SUF, GL=gl,
            **self._ckpt_statics(stt, n_bucket))
        sv = unpack_outputs1(o_buf, stt["T"], stt["D"], stt["Z"],
                             stt["C"], SUF * CK, stt["E"], stt["P"],
                             n_bucket)
        s0 = jr * CK
        bk["takes"][s0:gl] = sv["takes"]
        bk["leftover"][s0:gl] = sv["leftover"]
        # the kernel spliced the suffix's entry carries over the stale
        # bank tail: advance the token, the bank tracks the arena
        bk["bank"] = bank
        bk["token"] = self._delta.state_token()
        out = dict(sv)
        out["takes"] = bk["takes"].copy()
        out["leftover"] = bk["leftover"].copy()
        self._solve_mode = f"suffix@{SUF}"
        return out, d.tier, dict(resume_group=s0, suffix_bucket=SUF,
                                 suffix_groups=SUF * CK)

    def _run_device(self, enc, ex_alloc, ex_used, ex_compat):
        if self.on_mesh:
            return self._run_mesh(enc, ex_alloc, ex_used, ex_compat)
        D = enc.A.shape[1]
        G, E = len(enc.groups), ex_alloc.shape[0]
        arrays, stt, buf, _ = self._arena_for(enc, ex_alloc, ex_used,
                                              ex_compat)
        T, Dp, Z, C = stt["T"], stt["D"], stt["Z"], stt["C"]
        Gp, Ep, Pp = stt["G"], stt["E"], stt["P"]
        if stt["Q"] and Gp > self.dev_max_groups:
            # the pruned arena has no priority section
            return self._run_host(enc, ex_alloc, ex_used, ex_compat,
                                  "priority_cap")
        use_pruned = stt["K"] == 0 and Gp > self.dev_max_groups
        Fu = stt["F"]
        before = dict(ffd_cuda.LAUNCHES)
        n_bucket, retries, bails = self._bucket, 0, 0
        ck_on = (self._delta is not None and not use_pruned
                 and ckpt_eligible(Gp, Fu=Fu))
        self._solve_mode = "full"
        sreason, sinfo = ("disabled" if not ck_on else None), None
        while True:
            out = None
            if use_pruned:
                # after a bail every slot is selected: S = N is exact
                S = Ep + n_bucket if bails else self.dev_pruned_slots
                o_buf = self._dispatch_pruned(
                    buf, T=T, D=Dp, Z=Z, C=C, G=Gp, E=Ep, P=Pp,
                    n_max=n_bucket, S=S)
                if int(o_buf[-1]):
                    # the pruning was insufficient for this input: the same
                    # arena again on the card, every slot selected
                    if bails:
                        raise RuntimeError(
                            f"the pruned scan bailed at S = N = {S}")
                    bails += 1
                    continue
                out = unpack_outputs1(o_buf[:-1], T, Dp, Z, C, Gp, Ep, Pp,
                                      n_bucket)
            elif ck_on and sreason is None:
                out, sreason, sinfo = self._try_suffix(buf, stt, n_bucket)
            if out is None and ck_on:
                if self._solve_mode != "full":
                    # a suffix served but exhausted its slots: the grown
                    # retry is a bank-rebuilding full solve
                    self._solve_mode, sinfo = "full", None
                    sreason = "exhausted"
                o_buf, bank = self._dispatch_ckpt(
                    buf, CK=CKPT_CHUNK, **self._ckpt_statics(stt, n_bucket))
                out = unpack_outputs1(o_buf, T, Dp, Z, C, Gp, Ep, Pp,
                                      n_bucket)
                self._adopt_bank(buf, stt, n_bucket, bank, out, CKPT_CHUNK)
            elif out is None:
                o_buf = self._dispatch(buf, F=Fu,
                                       **self._ckpt_statics(stt, n_bucket))
                out = unpack_outputs1(o_buf, T, Dp, Z, C, Gp, Ep, Pp,
                                      n_bucket)
            exhausted = (out["leftover"].sum() > 0
                         and int(out["num_nodes"][0]) >= n_bucket)
            if not exhausted or n_bucket >= self.n_max:
                break
            n_bucket = min(n_bucket * 4, self.n_max)
            retries += 1
        self._bucket = self._settle_bucket(n_bucket,
                                           int(out["num_nodes"][0]))
        suffix = self._solve_mode != "full"
        self.last_dispatch_stats = dict(
            device=str(self.device), slot_bucket=n_bucket, retries=retries,
            groups=Gp, bails=bails, batch=1,
            kernel=("pruned" if use_pruned else "suffix" if suffix
                    else "ckpt" if ck_on else "fused" if Fu > 1 else "base"),
            reason=("pruned_bail" if bails else None) if use_pruned
            else None if suffix else sreason,
            launches=self._launches_since(before),
            **dispatch_shape(Gp, Fu, arrays.get("fuse")))
        if sinfo is not None:
            self.last_dispatch_stats.update(sinfo)
        return _unpad(out, G, E, Ep, n_bucket, D)

    def _run_mesh(self, enc, ex_alloc, ex_used, ex_compat):
        """The sharded solve on this rank (parallel/mesh.py
        ``dispatch_mesh``), SPMD with the other ranks of ``self.mesh``:
        the arrays-only resident arena and its dirty fields, the slot
        bucket's x4 retry, the gathered outputs (the same on every rank)."""
        D = enc.A.shape[1]
        G, E = len(enc.groups), ex_alloc.shape[0]
        arrays, stt, _, dirty = self._arena_for(enc, ex_alloc, ex_used,
                                                ex_compat)
        Gp, Ep, Pp = stt["G"], stt["E"], stt["P"]
        self._solve_mode = "full"
        before = dict(ffd_cuda.LAUNCHES)
        n_bucket, retries = self._bucket, 0
        while True:
            out = dispatch_mesh(arrays, comm=self.mesh, n_max=n_bucket, E=Ep,
                                P=Pp, V=stt["V"], cache=self._mesh_cache,
                                dirty=dirty, dp=self.dp,
                                dp2_min_slots=self.dp2_min_slots,
                                device=self.device)
            exhausted = (out["leftover"].sum() > 0
                         and int(out["num_nodes"][0]) >= n_bucket)
            if not exhausted or n_bucket >= self.n_max:
                break
            n_bucket = min(n_bucket * 4, self.n_max)
            retries += 1
        self._bucket = self._settle_bucket(n_bucket,
                                           int(out["num_nodes"][0]))
        m = self._mesh_cache["last_mesh"]
        self.last_dispatch_stats = dict(
            device=str(self.device), slot_bucket=n_bucket, retries=retries,
            groups=Gp, bails=0, batch=1, kernel="mesh", reason=None,
            mesh_kernel=m["kernel"], ndp=m["ndp"], ntp=m["ntp"],
            backend=m["backend"],
            placement=self._mesh_cache["last_placement"]["mode"],
            collectives=m["collectives"],
            collective_ms=m["collective_s"] * 1e3,
            launches=self._launches_since(before), **dispatch_shape(Gp, 1))
        return _unpad(out, G, E, Ep, n_bucket, D)

    def _replicated(self) -> dict:
        """The evidence of a single-device dispatch on a mesh rank: every
        rank runs it on its own device, with the same result."""
        return {"mesh": "replicated"} if self.mesh is not None else {}

    # -- the topology pour (K9) -----------------------------------------
    #: event-log capacity and jump period bound of the device pour; a
    #: group past TOPO_EVCAP events bails and the solve re-runs on the
    #: device at ``safe_evcap`` (it cannot bail)
    TOPO_EVCAP = 128
    TOPO_PMAX = 8

    def _topo_lowerable(self, enc, tenc, existing) -> bool:
        """The device pour's envelope (the reference's predicate): no
        existing nodes, no minValues floors, and no duplicate counter
        references inside one group's constraint lists (the dense rows
        merge duplicates, which would change the zone-choice score the
        host computes per constraint)."""
        if existing:
            return False
        if enc.mv_floor is not None and enc.mv_floor.any():
            return False
        for g in enc.groups:
            gi = g.index
            for lst in (tenc.zspread[gi], tenc.hspread[gi],
                        tenc.zaff[gi], tenc.haff[gi]):
                ids = [e[0] for e in lst]
                if len(ids) != len(set(ids)):
                    return False
        return True

    @staticmethod
    def _topo_rows(enc, tenc):
        """Densify the TopoEncoding into TopoGroupRows arrays (numpy,
        unpadded): (rows, GZ, GH)."""
        G = len(enc.groups)
        GZ = max(1, tenc.GZ)
        GH = max(1, tenc.GH)
        big = np.int64(1) << 60
        rows = dict(
            has_topo=np.array(tenc.has_topo, dtype=bool),
            zone_needed=np.array(tenc.zone_needed, dtype=bool),
            min_mask=np.asarray(tenc.min_mask, dtype=bool),
            zs_any=np.zeros((G, GZ), bool),
            zs_skew=np.full((G, GZ), big, np.int64),
            hs_any=np.zeros((G, GH), bool),
            hs_skew=np.full((G, GH), big, np.int64),
            za_any=np.zeros((G, GZ), bool),
            za_anti=np.zeros((G, GZ), bool),
            za_own=np.zeros((G, GZ), bool),
            ha_any=np.zeros((G, GH), bool),
            ha_anti=np.zeros((G, GH), bool),
            ha_own=np.zeros((G, GH), bool),
            member_z=np.full(G, -1, np.int32),
            member_h=np.full(G, -1, np.int32),
        )
        for g in range(G):
            for gz, sk, enforce in tenc.zspread[g]:
                rows["zs_any"][g, gz] = True
                if enforce:
                    rows["zs_skew"][g, gz] = min(rows["zs_skew"][g, gz], sk)
            for gh, sk, enforce in tenc.hspread[g]:
                rows["hs_any"][g, gh] = True
                if enforce:
                    rows["hs_skew"][g, gh] = min(rows["hs_skew"][g, gh], sk)
            for gz, anti, own in tenc.zaff[g]:
                rows["za_any"][g, gz] = True
                rows["za_anti"][g, gz] = anti
                rows["za_own"][g, gz] = own
            for gh, anti, own in tenc.haff[g]:
                rows["ha_any"][g, gh] = True
                rows["ha_anti"][g, gh] = anti
                rows["ha_own"][g, gh] = own
            # membership counters not already covered by the spread rows
            # (ops/topo.py ``_record``'s seen_z / seen_h dedup)
            mz = tenc.member_z[g]
            if mz >= 0 and not rows["zs_any"][g, mz]:
                rows["member_z"][g] = mz
            mh = tenc.member_h[g]
            if mh >= 0 and not rows["hs_any"][g, mh]:
                rows["member_h"][g] = mh
        return rows, GZ, GH

    def _pour_fits(self, arrays, rows, stt) -> bool:
        """Whether the device pour lays out the padded topology inputs of
        ``topo_arrays`` (``topo_cuda.pour_fits`` on the host rows: the
        listed counter rows' shared bytes within the card's limit, at most
        64 zones), asked before the scan's first launch; a snapshot that
        does not fit goes to the host pour (``reason="topo_layout"``)."""
        return topo_cuda.pour_fits(
            topo_rows_from_numpy(rows, "cpu"), Z=stt["Z"],
            C=arrays["agc"].shape[1], D=arrays["A"].shape[1], P=stt["P"],
            PMAX=self.TOPO_PMAX, device=self.device)

    def _run_topo(self, enc, arrays, rows, stt):
        """The device pour (the reference's ``_run_jax_topo`` without its
        resident cache) of ``topo_arrays``' padded inputs: they go to the
        device once per solve and serve every slot-bucket retry. A group
        that overflows the event log bails; the same inputs are then
        solved again on the device at ``safe_evcap``
        (``reason="topo_bail"``), where the reference re-solves on its
        host pour. A second bail raises."""
        D = enc.A.shape[1]
        G = len(enc.groups)
        self._solve_mode = "full"
        cache: dict = {}
        before = dict(ffd_cuda.LAUNCHES)
        n_bucket, retries, bails = self._bucket, 0, 0
        evcap = self.TOPO_EVCAP
        while True:
            out = dispatch_topo(arrays, rows, dict(
                stt, n_max=n_bucket, EVCAP=evcap, PMAX=self.TOPO_PMAX),
                device=self.device, cache=cache)
            if bool(out["bail"].any()):
                if bails:
                    raise RuntimeError(
                        f"the topology pour bailed at EVCAP = {evcap}, "
                        f"past every group's event bound")
                bails += 1
                evcap = max(evcap, safe_evcap(arrays, rows))
                continue
            leftover = out["leftover"].cpu().numpy()
            nn = int(out["num_nodes"][0])
            exhausted = leftover.sum() > 0 and nn >= n_bucket
            if not exhausted or n_bucket >= self.n_max:
                break
            n_bucket = min(n_bucket * 4, self.n_max)
            retries += 1
        self._bucket = self._settle_bucket(n_bucket, nn)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        self.last_dispatch_stats = dict(
            device=str(self.device), kernel="topo",
            reason="topo_bail" if bails else None, bails=bails, evcap=evcap,
            batch=1, groups=arrays["n"].shape[0], slot_bucket=n_bucket,
            retries=retries, launches=self._launches_since(before),
            **self._replicated())
        ev = {k[3:]: v for k, v in out.items() if k.startswith("ev_")}
        run_log = {g.index: _runs_from_events(ev, g.index)
                   for g in enc.groups if rows["has_topo"][g.index]}
        final = dict(types=out["types"], zones=out["zones"], ct=out["ct"],
                     pool=out["pool"], alive=out["alive"],
                     used=out["used"][:, :D], E=0, run_log=run_log,
                     zfix=out["zfix"])
        return out["takes"][:G], out["leftover"][:G], final

    # -- many snapshots in one dispatch -----------------------------------
    def solve_batch(self, snapshots) -> List[SolveResult]:
        """Solve many independent snapshots, eligible ones B per dispatch
        (``_dispatch_many``: one lane-axis solve of a statics bucket).
        Decisions are exactly ``[self.solve(s) for s in snapshots]``;
        a bucket of 64-4096 padded groups runs fused (F = 4), each lane
        its own branch per block:
        ineligible items (no pods, preferences, topology, no instance
        types, minValues floors, padded groups past ``dev_max_groups``),
        a bucket of fewer than 2 items, and an item whose lane ran out of
        new-node slots take the single-solve path. The reference's
        ``TPUSolver.solve_batch`` without its router. After a batch,
        ``last_dispatch_stats`` has ``kernel="batch"`` and the lane count
        (a later single solve overwrites it)."""
        snapshots = list(snapshots)
        results: List = [None] * len(snapshots)
        buckets: Dict[Tuple, List] = {}
        for i, snap in enumerate(snapshots):
            item = self._prep_batch_item(snap)
            if item is None:
                results[i] = self.solve(snap)
            else:
                key = tuple(sorted(item["statics"].items()))
                buckets.setdefault(key, []).append((i, item))
        for key, items in buckets.items():
            if len(items) < 2:
                # nothing to amortize: the single path also keeps its
                # slot-bucket retry
                for i, _ in items:
                    results[i] = self.solve(snapshots[i])
                continue
            statics = dict(key)
            n_bucket = self._bucket
            before = dict(ffd_cuda.LAUNCHES)
            o = self._dispatch_many([it["buf"] for _, it in items],
                                    n_max=n_bucket, **statics)
            fb = [it["fused_blocks"] for _, it in items]
            self.last_dispatch_stats = dict(
                device=str(self.device), kernel="batch", reason=None,
                bails=0, batch=len(items), groups=statics["G"],
                slot_bucket=n_bucket, launches=self._launches_since(before),
                **dispatch_shape(statics["G"], statics["F"],
                                 fused_blocks=round(sum(fb) / len(fb))),
                **self._replicated())
            for (i, it), o_buf in zip(items, o):
                res = self._finish_batch_item(it, o_buf, statics, n_bucket)
                # slot-bucket overflow: the single path re-solves with its
                # x4 retry loop (and slot growth), identically
                results[i] = res if res is not None \
                    else self.solve(snapshots[i])
        return results

    def _prep_batch_item(self, snapshot: SchedulingSnapshot):
        """Encode one snapshot for the batched dispatch, or None when it
        must take the single-solve path (the reference's gates minus its
        router): pods, no preferences, no topology, T > 0, K = 0 and a
        padded group count within ``dev_max_groups``. Packed with the
        fused-scan plan; ``fused_blocks`` is its vectorized block count."""
        if not snapshot.pods:
            return None
        groups = canonical_pod_groups(snapshot.pods)
        if any(preference_count(plist[0]) for _sig, plist in groups):
            return None
        enc = encode_snapshot(snapshot, pod_groups=groups)
        if enc.topo_any or not enc.types or enc.mv_K:
            return None
        existing = sorted(snapshot.existing_nodes, key=lambda n: n.name)
        ex_alloc, ex_used, ex_compat = full_existing_encode(enc, existing)
        arrays, stt = self._prep_device_inputs(enc, ex_alloc, ex_used,
                                               ex_compat)
        if stt["G"] > self.dev_max_groups:
            return None
        buf = pack_inputs1(arrays, stt["T"], stt["D"], stt["Z"], stt["C"],
                           stt["G"], stt["E"], stt["P"], stt["K"], stt["M"],
                           stt["F"], stt["Q"])
        fb = 0
        if stt["F"] > 1:
            fb = fused_block_count(arrays["fuse"], stt["F"])
        return dict(enc=enc, existing=existing, buf=buf, statics=stt,
                    D=enc.A.shape[1], E=ex_alloc.shape[0], fused_blocks=fb)

    def _finish_batch_item(self, it, o_buf, statics, n_bucket):
        """Decode one row of the batched output; None when the item
        exhausted the slot bucket (the caller re-solves it singly). The
        tail is ``_run_device``'s unpadding."""
        enc = it["enc"]
        G, E, D = len(enc.groups), it["E"], it["D"]
        Gp, Ep = statics["G"], statics["E"]
        out = unpack_outputs1(np.ascontiguousarray(o_buf), statics["T"],
                              statics["D"], statics["Z"], statics["C"], Gp,
                              Ep, statics["P"], n_bucket)
        if (out["leftover"].sum() > 0
                and int(out["num_nodes"][0]) >= n_bucket):
            return None
        takes, leftover, final = _unpad(out, G, E, Ep, n_bucket, D)
        return self._decode(enc, it["existing"], takes, leftover, final)

    # -- consolidation's whole-fleet search ------------------------------
    #: the solver interface's flag for a subset kernel; the reference's
    #: router reads it, the port's evaluator (no router) does not
    supports_subset_kernel = True

    def arena_epoch(self):
        """Coherence token for caches derived from this solver's resident
        encoding (consolidation ``_base_tables``): the delta encoder's
        structural epoch (None when incremental is off), and the mesh's
        resident generation (bumped by every full placement; 0 off a
        mesh)."""
        return (self._delta.epoch if self._delta is not None else None,
                self._mesh_cache.get("resident_gen", 0))

    def dispatch_subsets(self, arrays: dict, *, tprice, gid, n, dead, keep,
                         removed_price, n_max: int, E: int,
                         P: int) -> np.ndarray:
        """One whole-fleet consolidation subset batch on self.device: the
        padded union arena (``_prep_device_inputs``' arrays; on the
        device once and reused while the same arrays come back) and the
        per-lane stacks in ONE host-to-device copy, then
        ``ops.consolidation_torch.subset_solve`` (on CUDA: subset_gather,
        2·Gq lane-axis K2 launches, the last commit writing the rows) and
        one copy of the [B, 5] rows back."""
        sa = self._sub_arena
        if sa is None or sa[0] is not arrays or sa[1] is not tprice:
            arena = kernel_inputs_from_numpy(arrays, self.device)
            sa = self._sub_arena = (arrays, tprice, arena, torch.from_numpy(
                np.asarray(tprice, dtype=np.int64)).to(self.device))
        lanes = _device.upload(dict(
            gid=np.asarray(gid, dtype=np.int32),
            n=np.asarray(n, dtype=np.int64), dead=np.asarray(dead, bool),
            keep=np.asarray(keep, bool),
            removed_price=np.asarray(removed_price, dtype=np.int64)),
            self.device)
        before = dict(ffd_cuda.LAUNCHES)
        out = subset_solve(sa[2], sa[3], lanes["gid"], lanes["n"],
                           lanes["dead"], lanes["keep"],
                           lanes["removed_price"], n_max=n_max, E=E,
                           P=P).cpu().numpy()
        self.last_dispatch_stats = dict(
            device=str(self.device), kernel="subset", batch=len(out),
            groups=int(np.asarray(gid).shape[1]),
            launches=self._launches_since(before), **self._replicated())
        return out

    # -- the preemption victim-set search (K8) ---------------------------
    def dispatch_preempt(self, *, ex_alloc, ex_used, ex_compat, R, n,
                         freed) -> np.ndarray:
        """One preemption victim-set batch on self.device: the shared
        demand and node tables and the per-lane ``freed`` refund stack in
        ONE host-to-device copy, one K8 launch for every candidate prefix
        (scheduling/preempt_torch.py ``preempt_solve``; the plain version
        on the CPU), one copy of the [B] int64 leftovers back."""
        t = _device.upload(dict(
            ex_alloc=np.asarray(ex_alloc, dtype=np.int64),
            ex_used=np.asarray(ex_used, dtype=np.int64),
            ex_compat=np.asarray(ex_compat, dtype=bool),
            R=np.asarray(R, dtype=np.int64), n=np.asarray(n, dtype=np.int64),
            freed=np.asarray(freed, dtype=np.int64)), self.device)
        before = dict(ffd_cuda.LAUNCHES)
        out = preempt_solve(t["ex_alloc"], t["ex_used"], t["ex_compat"],
                            t["R"], t["n"], t["freed"]).cpu().numpy()
        B, G = t["freed"].shape[0], t["R"].shape[0]
        self.last_dispatch_stats = dict(
            device=str(self.device), kernel="preempt", batch=B, fuse=1,
            scan_steps=G, fused_blocks=0, seq_blocks=G,
            launches=self._launches_since(before), **self._replicated())
        return out

    # ------------------------------------------------------------------
    def _decode(self, enc: SnapshotEncoding,
                existing: Sequence[ExistingNode], takes: np.ndarray,
                leftover: np.ndarray, final: dict) -> SolveResult:
        E = final["E"]
        self.last_tier_leftovers = tier_leftovers(np.asarray(leftover),
                                                  enc.prio)
        assignments: Dict[str, str] = {}
        unschedulable: Dict[str, str] = {}
        slot_pods: Dict[int, List] = {}
        slot_groups: Dict[int, List[int]] = {}
        # one global nonzero: np.nonzero walks row-major, so each group's
        # slots arrive contiguous and ordered
        gnz, snz = np.nonzero(takes)
        bounds = np.searchsorted(gnz, np.arange(len(enc.groups) + 1))
        run_log = final.get("run_log") or {}
        for g in enc.groups:
            off = 0
            gp = g.pods

            def place(slot, chunk, gi=g.index):
                if slot < E:
                    for p in chunk:
                        assignments[p.full_name()] = existing[slot].name
                else:
                    slot_pods.setdefault(slot, []).extend(chunk)
                    sg = slot_groups.setdefault(slot, [])
                    if gi not in sg:
                        sg.append(gi)

            # topology pours stripe pods across slots: replay their
            # placement order. Plain fills are slot-order chunks.
            placement = run_log.get(g.index)
            if placement is None:
                lo, hi = bounds[g.index], bounds[g.index + 1]
                placement = [(int(s), int(takes[g.index, s]))
                             for s in snz[lo:hi]]
            for entry in placement:
                if entry[0] == "cyc":
                    # a committed periodic jump: ``pattern`` repeated k
                    # times; pods stripe round-robin over the pattern, so
                    # entry j of the pattern owns a strided slice
                    _, pattern, k = entry
                    d_n = sum(ln for _, ln in pattern)
                    pos = 0
                    for slot, ln in pattern:
                        if ln == 1:
                            chunk = gp[off + pos:off + d_n * k:d_n]
                        else:
                            chunk = []
                            for p_i in range(k):
                                base = off + pos + p_i * d_n
                                chunk.extend(gp[base:base + ln])
                        place(int(slot), chunk)
                        pos += ln
                    off += d_n * k
                    continue
                slot, cnt = entry
                place(int(slot), gp[off:off + cnt])
                off += cnt
            for p in gp[off:]:  # leftovers — could not be scheduled
                unschedulable[p.full_name()] = "no capacity in any nodepool"
        return self._decode_nodes(enc, assignments, unschedulable,
                                  slot_pods, slot_groups, final)

    def _decode_nodes(self, enc: SnapshotEncoding, assignments,
                      unschedulable, slot_pods, slot_groups,
                      final: dict) -> SolveResult:
        """Mint NewNodeClaims from the per-slot pod lists."""
        new_nodes: List[NewNodeClaim] = []
        #: (zone-mask, ct-mask) -> per-type best price
        best_cache: Dict[bytes, np.ndarray] = {}
        #: (type-mask, zone-mask, ct-mask) -> cheapest-first type names
        order_cache: Dict[bytes, List[str]] = {}
        #: (pool, groups, fixed zone) -> merged node requirements
        reqs_cache: Dict[Tuple, Requirements] = {}
        zfix = final.get("zfix")
        for slot in sorted(slot_pods):
            pods = slot_pods[slot]
            pool = enc.pools[int(final["pool"][slot])]
            tmask = final["types"][slot]
            zmask = final["zones"][slot]
            cmask = final["ct"][slot]
            ck = zmask.tobytes() + cmask.tobytes()
            ok = tmask.tobytes() + ck
            type_names = order_cache.get(ok)
            if type_names is None:
                best = best_cache.get(ck)
                if best is None:
                    pz = np.where(
                        enc.avail & zmask[None, :, None]
                        & cmask[None, None, :],
                        enc.price, np.int64(1) << 62)
                    best = best_cache[ck] = pz.min(axis=(1, 2))
                # (price, name) order: types are name-sorted in the
                # encoding, so a stable argsort on price breaks ties by name
                idx = np.nonzero(tmask)[0]
                order = idx[np.argsort(best[idx], kind="stable")]
                type_names = order_cache[ok] = \
                    [enc.type_names[i] for i in order]
            zf = int(zfix[slot]) if zfix is not None else -1
            gs = tuple(gi for gi in slot_groups[slot]
                       if enc.groups[gi].reqs)
            rk = (int(final["pool"][slot]), gs, zf)
            reqs = reqs_cache.get(rk)
            if reqs is None:
                reqs = pool.spec.nodepool.scheduling_requirements()
                for gi in gs:
                    reqs = reqs.union(enc.groups[gi].reqs)
                if zf >= 0:
                    # topology pinned this node's zone: the oracle narrows
                    # the node's requirements with ZONE IN [chosen]
                    reqs = reqs.add(Requirement.new(L.ZONE, IN,
                                                    [enc.zones[zf]]))
                reqs_cache[rk] = reqs
            used_vec = final["used"][slot]
            names = [p._full_name for p in pods]
            names.sort()
            new_nodes.append(NewNodeClaim(
                nodepool=pool.spec.nodepool.metadata.name,
                requirements=reqs,
                pod_names=names,
                instance_type_names=type_names,
                requests=Resources({d: int(used_vec[i])
                                    for i, d in enumerate(enc.dims)}),
                taints=list(pool.spec.nodepool.template.taints),
            ))
        return SolveResult(new_nodes=new_nodes,
                           existing_assignments=assignments,
                           unschedulable=unschedulable)
