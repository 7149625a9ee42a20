"""K10, the sharded scan: one rank's state and its four kernels.

``csrc/mesh.cu`` holds the per-rank kernels of the reference's
``shard_map`` scans (``ops/ffd_jax.py`` ``_solve`` with ``axis="tp"`` and
``_solve_dp``; ``parallel/mesh.py`` ``solve_scan_sharded`` and
``solve_scan_sharded2``): ``mesh_new_caps`` once per solve, then per group
``mesh_slot_headroom``, ``mesh_fill`` (phases a, b, c, or all three at
once on a mesh without a slot split) and ``mesh_commit``. The collectives
between the launches belong to the step loop (parallel/mesh.py
``_mesh_scan``); this module holds what one rank computes.

``MeshState`` is one rank's shard on one device: the shard's inputs
(types ``[tp*Tl, (tp+1)*Tl)``, slots ``[dp*Nl, (dp+1)*Nl)``), its carry,
the step scratch (``cand``, ``kh`` = k then the minValues maxima h1), the
group's new-node table over the rank's types (``candn`` / ``hrn`` [P,
Tl] and the partial caps ``capn`` [P, table_blocks(Tl)], which the
headroom launch writes without minValues floors and the commit reads;
with floors row 0 is the commit's scratch), the new-node caps, the fill
phases' sums (``red``, reduced in place over the slot shards) and the
earlier shards' prefixes (``before``), and the outputs. ``mesh_fill``
runs on one CTA of ``fill_threads(Nl)`` threads, each holding a
contiguous run of up to ``fill_rows(Nl)`` of the rank's rows in
registers. Without
minValues floors the commit runs on a thread-block cluster of
``cluster`` CTAs of ``threads`` (K2's rule at one lane,
``ffd_cuda.k2_shape``, asked for the state's device unless given).
Each wrapper checks the state's tensors, launches on the
state's device, on its current stream (``ffd_cuda._launch``; the step
loop enters the device's guard once), adds one to its entry of ``LAUNCHES``
(the kernel library's counters, ``ops/ffd_cuda.py``) and raises when the
C entry returns a CUDA error. A state on CUDA launches the kernel or
raises; only a state on the CPU takes the plain part (``*_ref`` below,
the same arithmetic in PyTorch ops that also run on CUDA tensors, which
is how the card holds a kernel against it).

Importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes

import torch

from .ffd_cuda import (LAUNCHES, _FfdArgs, _PTR_FIELDS, _lib, _need,
                       k2_shape, table_blocks)
from .ffd_cuda import _launch as _launch_kernel
from .ffd_torch import (BIG, Carry, KernelInputs, NewNodeTable, _headroom,
                        _mv_cap, _mv_h1, _new_node_table_ref,
                        _new_nodes_phase_ref, _pool_budget,
                        _slot_headroom_ref, carry0_dp)

_I64 = torch.int64

#: mesh_fill's phases: (a) overlay and pool sums, (b) pool caps and the
#: fill sum, (c) greedy fill and take-by-pool, or all three (no slot split)
PHASE_A, PHASE_B, PHASE_C, PHASE_ALL = 0, 1, 2, 3

#: most rows a thread of ``mesh_fill`` holds in registers (csrc/mesh.cu
#: ``kFillRows``): past threads x FILL_ROWS the rank's rows go in tiles
FILL_ROWS = 8

#: ``mesh_new_caps``: threads a CTA and the most CTAs of a (group, pool)
#: (csrc/mesh.cu ``kCapsThreads``, ``kCapsCluster``)
CAPS_THREADS = 128
CAPS_CLUSTER = 8

#: the kernels of this module, in launch order
KERNELS = ("mesh_new_caps", "mesh_slot_headroom", "mesh_fill",
           "mesh_commit")


class _MeshArgs(ctypes.Structure):
    """Mirror of ``struct MeshArgs`` in csrc/mesh.cu."""
    _fields_ = [("f", _FfdArgs), ("h1", ctypes.c_void_p),
                ("caps", ctypes.c_void_p), ("red", ctypes.c_void_p),
                ("before", ctypes.c_void_p),
                ("tbp", ctypes.c_void_p), ("slot0", ctypes.c_longlong),
                ("N", ctypes.c_longlong), ("E", ctypes.c_longlong),
                ("capn", ctypes.c_void_p), ("cluster", ctypes.c_longlong),
                ("threads", ctypes.c_longlong)]


class MeshState:
    """One rank's shard of a sharded scan and its scratch (module
    docstring). ``inp`` is the rank's shard on one device: A / avail_zc
    [Tl, ...], F / pool_types [..., Tl], ex_alloc / ex_used0 [Nl, D] and
    ex_compat [G, Nl] (the rank's rows of the slot-padded tables), the
    minValues pairs localized to the shard's types; ``slot0`` is the
    global id of its first slot row, ``N`` the true slot count E + n_max.
    ``cluster`` (1, 2, 4, 8) and ``threads`` (256, 512) force the
    commit's shape; with minValues floors it runs on one CTA.
    """

    def __init__(self, inp: KernelInputs, *, E: int, P: int, V: int, N: int,
                 slot0: int, cluster: int = None, threads: int = None):
        dev = inp.A.device
        self.inp, self.E, self.P, self.V, self.N = inp, E, P, V, N
        self.slot0 = slot0
        Tl, D = inp.A.shape
        G = inp.R.shape[0]
        Nl = inp.ex_used0.shape[0]
        K = 0 if inp.mv_floor is None else inp.mv_floor.shape[1]
        self.T, self.D, self.G, self.Nl, self.K = Tl, D, G, Nl, K
        self.M = 0 if K == 0 else inp.mv_pairs_t.shape[1]
        if cluster not in (None, 1, 2, 4, 8):
            raise ValueError(f"cluster={cluster} is not 1, 2, 4 or 8")
        if threads not in (None, 256, 512):
            raise ValueError(f"threads={threads} is not 256 or 512")
        if K and cluster not in (None, 1):
            raise ValueError("with minValues floors the commit runs on one "
                             "CTA")
        self.cluster, self.threads = cluster, threads
        self.slots = slot0 + torch.arange(Nl, device=dev)
        self.carry = carry0_dp(inp, self.slots, E)
        kv = K * V
        self.cand = torch.zeros((Nl, Tl), dtype=torch.bool, device=dev)
        self.kh = torch.zeros(Nl * (1 + kv), dtype=_I64, device=dev)
        self.caps = torch.zeros(G * P * (1 + kv), dtype=_I64, device=dev)
        self.red = torch.zeros(P + 1, dtype=_I64, device=dev)
        self.before = torch.zeros(P + 1, dtype=_I64, device=dev)
        self.hrn = torch.zeros((P, Tl), dtype=_I64, device=dev)
        self.candn = torch.zeros((P, Tl), dtype=torch.bool, device=dev)
        self.capn = torch.zeros((P, table_blocks(Tl)), dtype=_I64,
                                device=dev)
        self.takes = torch.zeros((G, Nl), dtype=torch.int32, device=dev)
        self.leftover = torch.zeros(G, dtype=_I64, device=dev)
        self._args = None

    @property
    def device(self) -> torch.device:
        return self.inp.A.device

    @property
    def k(self) -> torch.Tensor:
        """[Nl] the step's headroom, then its take (a view of ``kh``)."""
        return self.kh[:self.Nl]

    @property
    def h1(self) -> torch.Tensor:
        """[Nl, K, V] the minValues maxima of the step (a view of ``kh``)."""
        return self.kh[self.Nl:].view(self.Nl, self.K, self.V)

    def buffers(self) -> dict:
        """Every tensor a kernel writes (the carry, the scratch that
        carries between kernels and the outputs), by name."""
        out = {f"carry.{nm}": t for nm, t in zip(Carry._fields, self.carry)}
        out.update(cand=self.cand, kh=self.kh, candn=self.candn,
                   hrn=self.hrn, capn=self.capn, caps=self.caps,
                   red=self.red, before=self.before, takes=self.takes,
                   leftover=self.leftover)
        return out

    def table(self) -> NewNodeTable:
        """The group's new-node table over the rank's types as the
        headroom launch wrote it (no minValues floors): candn, hrn [P,
        Tl] and the rank's own cap [P], the max over the partial caps
        (the commit takes the caps reduced over the type shards)."""
        return NewNodeTable(self.candn, self.hrn, self.capn.amax(-1), None)

    def clone(self) -> "MeshState":
        """A copy with its own buffers (the inputs shared): the plain
        parts run on it beside the kernels."""
        c = MeshState.__new__(MeshState)
        c.__dict__.update(self.__dict__)
        c.carry = Carry(*[t.clone() for t in self.carry])
        for nm in ("cand", "kh", "caps", "red", "before", "hrn",
                   "candn", "capn", "takes", "leftover"):
            setattr(c, nm, getattr(self, nm).clone())
        c._args = None
        return c

    def args(self) -> _MeshArgs:
        """The ctypes argument block of the kernels (built once)."""
        if self._args is None:
            self._args = self._build_args()
        return self._args

    def _build_args(self) -> _MeshArgs:
        inp, c = self.inp, self.carry
        Tl, D, G, Nl, K, P = self.T, self.D, self.G, self.Nl, self.K, \
            self.P
        Z, C = inp.agz.shape[1], inp.agc.shape[1]
        i64, b = torch.int64, torch.bool
        for nm, dt, shp in (
                ("A", i64, (Tl, D)), ("avail_zc", b, (Tl, Z * C)),
                ("R", i64, (G, D)), ("n", i64, (G,)), ("F", b, (G, Tl)),
                ("agz", b, (G, Z)), ("agc", b, (G, C)),
                ("admit", b, (G, P)), ("daemon", i64, (G, P, D)),
                ("pool_types", b, (P, Tl)), ("pool_agz", b, (P, Z)),
                ("pool_agc", b, (P, C)), ("pool_limit", i64, (P, D)),
                ("ex_alloc", i64, (Nl, D)), ("ex_compat", b, (G, Nl))):
            _need(getattr(inp, nm), nm, dt, shp)
        if K:
            _need(inp.mv_floor, "mv_floor", i64, (P, K))
            _need(inp.mv_pairs_t, "mv_pairs_t", i64, (K, self.M))
            _need(inp.mv_pairs_v, "mv_pairs_v", i64, (K, self.M))
        for nm, t in self.buffers().items():
            _need(t, nm, t.dtype)
        src = dict(inp._asdict())
        src.update(c._asdict())
        src.update(cand=self.cand, k=self.kh, hrn=self.hrn,
                   candn=self.candn, takes=self.takes,
                   leftover=self.leftover)
        ptrs = {f: (src[f].data_ptr() if src.get(f) is not None
                    and src[f].numel() else None) for f in _PTR_FIELDS}
        f = _FfdArgs(**ptrs, T=Tl, D=D, Z=Z, C=C, G=G, E=0, P=P, N=Nl, K=K,
                     M=self.M, V=self.V, G0=0, L=1)
        if self.cluster is None or self.threads is None:
            cs, nt = k2_shape(1, K, self.V, P, D, Nl, self.device)
            self.cluster = cs if self.cluster is None else self.cluster
            self.threads = nt if self.threads is None else self.threads
        return _MeshArgs(
            f=f, h1=(self.kh.data_ptr() + Nl * 8) if K * self.V else None,
            caps=self.caps.data_ptr(), red=self.red.data_ptr(),
            before=self.before.data_ptr(),
            tbp=self.red.data_ptr(), slot0=self.slot0, N=self.N, E=self.E,
            capn=self.capn.data_ptr(), cluster=self.cluster,
            threads=self.threads)


def fill_threads(n: int) -> int:
    """``mesh_fill``'s threads (one CTA) for a rank of n slot rows
    (csrc/mesh.cu ``fill_threads``): 256 up to 2,048 rows, at most 8 a
    thread, else 512; past 512 x FILL_ROWS rows the CTA walks tiles."""
    return 256 if n <= 2048 else 512


def fill_rows(n: int) -> int:
    """Rows a thread of ``mesh_fill`` holds for a rank of n slot rows
    (csrc/mesh.cu ``fill_rows``, one build of the kernel each): the power
    of two at or above n / ``fill_threads(n)``, at most ``FILL_ROWS``."""
    nt, r = fill_threads(n), 1
    while r < FILL_ROWS and r * nt < n:
        r *= 2
    return r


def caps_cluster(T: int, K: int) -> int:
    """``mesh_new_caps``' CTAs a (group, pool), a thread-block cluster over
    the rank's T types (csrc/mesh.cu ``karp_mesh_caps_cluster``): one with
    minValues floors (K > 0), else the power of two at or above T /
    ``CAPS_THREADS``, at most ``CAPS_CLUSTER``; CTA r takes the types
    [r * ceil(T / X), (r + 1) * ceil(T / X))."""
    x = 1
    while K == 0 and x < CAPS_CLUSTER and x * CAPS_THREADS < T:
        x *= 2
    return x


def _launch(name: str, st: MeshState, *args) -> None:
    if not st.device.type == "cuda":
        raise ValueError(f"{name} needs a CUDA state, got {st.device}")
    _launch_kernel(name, getattr(_lib(), f"karp_{name}"),
                   (ctypes.byref(st.args()),) + args, st.kh)


# ---------------------------------------------------------------------------
# the wrappers: a CUDA state launches the kernel, a CPU state the plain part
# ---------------------------------------------------------------------------

def mesh_new_caps(st: MeshState) -> None:
    """The rank's new-node cap of every (group, pool) over its types into
    ``st.caps[:G*P]``, and with minValues floors the per-value maxima
    h1n [G, P, K, V] after them (before the max over the type shards)."""
    if st.device.type == "cpu":
        return _new_caps_ref(st)
    _launch("mesh_new_caps", st)


def mesh_slot_headroom(st: MeshState, g: int) -> None:
    """Steps 1-3 of group g on the rank's shard: ``st.cand`` [Nl, Tl],
    ``st.k`` (the max over the local types) and, without minValues
    floors, the group's new-node table over the rank's types
    (``st.table()``); with floors ``st.h1``."""
    if st.device.type == "cpu":
        return _slot_headroom_mesh_ref(st, g)
    _launch("mesh_slot_headroom", st, g)


def mesh_fill(st: MeshState, g: int, phase: int) -> None:
    """One phase of group g's fill on the rank's slots (module
    docstring); ``st.k`` becomes the take after phase c."""
    if phase not in (PHASE_A, PHASE_B, PHASE_C, PHASE_ALL):
        raise ValueError(f"unknown mesh_fill phase {phase}")
    if st.device.type == "cpu":
        return _fill_ref(st, g, phase)
    _launch("mesh_fill", st, g, phase)


def mesh_commit(st: MeshState, g: int) -> None:
    """Group g's new-node caps from the caps reduced over the type shards
    (with floors, min(cap, the minValues cap of the reduced h1n)), its
    narrowing (with the reduced take-by-pool in ``st.red``), new nodes on
    the rank's slots (from the table the headroom launch wrote; with
    floors computed pool by pool) and its takes row and leftover."""
    if st.device.type == "cpu":
        return _commit_mesh_ref(st, g)
    _launch("mesh_commit", st, g)


# ---------------------------------------------------------------------------
# the plain parts (CPU and CUDA tensors alike)
# ---------------------------------------------------------------------------

def _new_caps_ref(st: MeshState) -> None:
    """Plain version of ``mesh_new_caps``."""
    inp, P, K, V = st.inp, st.P, st.K, st.V
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    caps, h1n = [], []
    for g in range(st.G):
        zc = ((inp.agz[g][None, :, None] & inp.pool_agz[:, :, None])
              & (inp.agc[g][None, None, :] & inp.pool_agc[:, None, :])
              ).reshape(P, Z * C)
        off = (zc[:, None, :] & inp.avail_zc[None, :, :]).any(dim=-1)
        cand = inp.F[g][None, :] & inp.pool_types & off              # [P, Tl]
        hr = _headroom(inp.A[None, :, :], inp.daemon[g][:, None, :],
                       inp.R[g])
        hr = torch.where(cand, hr, torch.zeros_like(hr))
        caps.append(hr.amax(dim=1))
        if K:
            h1n.append(_mv_h1(torch.where(cand, hr + 1, torch.zeros_like(hr)),
                              inp.mv_pairs_t, inp.mv_pairs_v, V))
    GP = st.G * P
    st.caps[:GP] = torch.stack(caps).reshape(-1)
    if K:
        st.caps[GP:] = torch.stack(h1n).reshape(-1)


def _partial_caps(hrn: torch.Tensor) -> torch.Tensor:
    """[P, table_blocks(T)]: the max of each 256-type block of hrn [P, T]
    (every hrn is at least 0, so a short last block pads with 0)."""
    P, T = hrn.shape
    TB = table_blocks(T)
    pad = torch.zeros((P, TB * 256 - T), dtype=hrn.dtype, device=hrn.device)
    return torch.cat([hrn, pad], 1).view(P, TB, 256).amax(-1)


def _slot_headroom_mesh_ref(st: MeshState, g: int) -> None:
    """Plain version of ``mesh_slot_headroom``."""
    inp = st.inp
    cand, k = _slot_headroom_ref(inp._replace(mv_floor=None), st.carry, g,
                                 E=0, P=st.P, V=0)
    st.cand.copy_(cand)
    st.k.copy_(k)
    if st.K:
        hr = _headroom(inp.A[None, :, :], st.carry.used[:, None, :],
                       inp.R[g])
        st.h1.copy_(_mv_h1(torch.where(cand, hr + 1, torch.zeros_like(hr)),
                           inp.mv_pairs_t, inp.mv_pairs_v, st.V))
        return
    tab = _new_node_table_ref(inp, g, P=st.P)
    st.candn.copy_(tab.candn)
    st.hrn.copy_(tab.hrn)
    st.capn.copy_(_partial_caps(tab.hrn))


def _pool_sums(pool: torch.Tensor, x: torch.Tensor, P: int) -> torch.Tensor:
    """[P + 1] sums of x by pool (segment P: rows that are no pool's)."""
    pool = pool.long()
    seg = torch.where(pool >= 0, pool.clamp(0, P - 1),
                      torch.full_like(pool, P))
    return torch.zeros(P + 1, dtype=_I64, device=x.device).index_add(0, seg,
                                                                     x)


def _fill_ref(st: MeshState, g: int, phase: int) -> None:
    """Plain version of ``mesh_fill``."""
    inp, c, P, E = st.inp, st.carry, st.P, st.E
    R, n = inp.R[g], inp.n[g]
    k = st.k.clone()
    if phase in (PHASE_A, PHASE_ALL):
        is_ex = st.slots < E
        ex_ok = is_ex & c.alive & inp.ex_compat[g]
        k_ex = torch.where(ex_ok, _headroom(inp.ex_alloc, c.used, R),
                           torch.zeros_like(k))
        k = torch.where(is_ex, k_ex, k)
        if st.K:
            open_ = c.pool >= 0
            pc = c.pool.long().clamp(0, P - 1)
            f = torch.where(open_[:, None], inp.mv_floor[pc],
                            torch.zeros_like(inp.mv_floor[pc]))
            cap = _mv_cap(st.h1, f, st.V)
            k = torch.minimum(k, torch.where(open_, cap,
                                             torch.full_like(cap, BIG)))
        if phase == PHASE_A:
            st.red[:P] = _pool_sums(c.pool, k, P)[:P]
            st.k.copy_(k)
            return
    if phase in (PHASE_B, PHASE_ALL):
        for pi in range(P):
            if not bool((inp.pool_limit[pi] >= 0).any()):
                continue
            budget = _pool_budget(inp.pool_limit[pi], c.pool_used[pi], R)
            rows = c.pool == pi
            kp = torch.where(rows, k, torch.zeros_like(k))
            cum = torch.cumsum(kp, 0) - kp
            if phase == PHASE_B:
                cum = cum + st.before[pi]
            k = torch.where(rows, torch.minimum(kp, budget - cum).clamp(min=0),
                            k)
        if phase == PHASE_B:
            st.red[0] = k.sum()
            st.k.copy_(k)
            return
    cum = torch.cumsum(k, 0) - k
    if phase == PHASE_C:
        cum = cum + st.before[P]
    take = torch.minimum((n - cum).clamp(min=0), k)
    st.k.copy_(take)
    st.red.copy_(_pool_sums(c.pool, take, P))


def _commit_mesh_ref(st: MeshState, g: int) -> None:
    """Plain version of ``mesh_commit``."""
    inp, c, G, P, K, V = st.inp, st.carry, st.G, st.P, st.K, st.V
    R = inp.R[g]
    cap = st.caps[g * P:(g + 1) * P]
    if K:
        h1n = st.caps[G * P:].view(G, P, K, V)[g]
        cap = torch.minimum(cap, _mv_cap(h1n, inp.mv_floor, V))
    take = st.k.clone()
    n_rem = inp.n[g] - st.red.sum()
    used = c.used + take[:, None] * R[None, :]
    filled_open = (take > 0) & (c.pool >= 0)
    fit_all = (used[:, None, :] <= inp.A[None, :, :]).all(dim=-1)
    types = torch.where(filled_open[:, None], st.cand & fit_all, c.types)
    zones = torch.where(filled_open[:, None], c.zones & inp.agz[g][None],
                        c.zones)
    ct = torch.where(filled_open[:, None], c.ct & inp.agc[g][None], c.ct)
    pool_used = c.pool_used + st.red[:P, None] * R[None, :]
    # the new nodes from the table the headroom launch wrote, with the
    # reduced caps; with floors the phase computes each pool's, and row 0
    # of the table's buffers holds the last pool's (the kernel's scratch)
    table = None
    if K:
        last = _new_node_table_ref(inp, g, P=P)
        st.candn[0] = last.candn[P - 1]
        st.hrn[0] = last.hrn[P - 1]
    else:
        table = NewNodeTable(st.candn, st.hrn, cap, None)
    (take, used, types, zones, ct, pool, alive, num_nodes, pool_used, n_rem,
     _) = _new_nodes_phase_ref(
        inp, g, take, used, types, zones, ct, c.pool, c.alive, c.num_nodes,
        pool_used, n_rem, E=st.E, P=P, V=V, slots=st.slots, N=st.N,
        caps=cap, table=table)
    for dst, src in zip(c, (used, types, zones, ct, pool, alive, num_nodes,
                            pool_used)):
        dst.copy_(src)
    st.k.copy_(take)
    st.takes[g] = take.to(torch.int32)
    st.leftover[g] = n_rem


#: the plain part of each kernel, for the card's kernel-against-plain check
PLAIN = dict(mesh_new_caps=_new_caps_ref,
             mesh_slot_headroom=_slot_headroom_mesh_ref,
             mesh_fill=_fill_ref, mesh_commit=_commit_mesh_ref)

#: the wrapper of each kernel
WRAPPERS = dict(mesh_new_caps=mesh_new_caps,
                mesh_slot_headroom=mesh_slot_headroom, mesh_fill=mesh_fill,
                mesh_commit=mesh_commit)

