"""The sharded solve (K10) on torch.distributed: the port of the
reference's ``parallel/mesh.py``.

The reference runs one ``shard_map`` program over a mesh of devices from
one process. Here every rank is a process with its own device (or, on
gloo, a share of one), and every rank calls the same entry point on the
same host arrays (SPMD, as the reference's multi-controller tier does):
each cuts its own shard, runs its per-rank kernels (``ops/mesh_cuda.py``,
``csrc/mesh.cu``) and meets the others in ``torch.distributed``
collectives between launches. Two shapes, as in the reference:

1. **Type-parallel** (``solve_scan_sharded``, the reference's ``:614``):
   A, avail_zc, F, pool_types and the slots' candidate types split over
   the ranks; the slot state is replicated. One all_reduce(MAX) a step
   (the headroom k and, with minValues floors, its per-value maxima),
   and one a solve for every (group, pool)'s new-node cap.
2. **Pods x types** (``solve_scan_sharded2``, the reference's ``:377``):
   also the slots split over a dp axis of a ``(ndp, ntp)`` layout, by
   global slot id ``dp*Nl + row``; exclusive prefixes are the local
   prefix plus the earlier shards' totals (one all_gather of a [P]
   vector for the pool caps, one of a scalar for the fill), totals one
   all_reduce(SUM) of the [P + 1] take-by-pool vector. No minValues
   floors (the reference's callers take shape 1 then).

Decisions equal the single-device scan's in both (tests/test_torch_mesh.py
holds them to the reference's JAX mesh byte for byte). At the end every
rank gathers the outputs: the type slabs of ``types`` over tp, then the
slot slabs of every slot-indexed output over dp in ONE flat byte buffer
(one gather per output crashed gloo at random in the reference's
multi-process tier, its commit 2f1f684).

``MeshComm`` is the communicator: a layout over an initialized process
group, ranks in row-major order (dp = rank // ntp, tp = rank % ntp, as
``np.asarray(devices).reshape(ndp, ntp)``), one ``dist.new_group`` per tp
row and one per dp column. Its collectives take the tensors where they
lie: NCCL and gloo (ranks sharing a card) both take CUDA tensors, gloo
host tensors too. An axis of one rank is the identity, as ``axis=None``
is in the reference.

``dispatch_mesh`` picks the shape as the reference does and keeps each
rank's shard resident across ticks (``_place_resident``: ``full`` /
``patch`` / ``reuse``); a slot table may arrive as its host's slab
(``LocalSlab``, the distributed tier's input, ``distmesh.py``), from
which a rank cuts its rows and never more. Where the reference reads
``KARP_MESH_DP`` and ``KARP_MESH_DP2_MIN_SLOTS`` from the environment,
the port takes ``dp=`` and ``dp2_min_slots=`` as arguments and reads no
environment variable. The ``sum_only`` emulation of the reference (an
all_gather for the max, for a TPU backend that cannot lower an int64 Max
all-reduce) is not ported: NCCL and gloo both reduce int64 with MAX.
The batch lanes over devices (``shard_batch`` / ``shard_lanes``) are not
ported here (``fleet/meshgroup.py`` splits K4 lanes over its ranks).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import device as _device
from ..ops import mesh_cuda as mc
from ..ops.ffd_cuda import on_device
from ..ops.ffd_torch import (Carry, KernelInputs, _BOOL_FIELDS, _solve_dp_ref,
                             _solve_scan_ref)

#: the slot count below which dispatch_mesh keeps the type mesh even
#: when a dp factor is available (the reference's ``DP2_MIN_SLOTS``)
DP2_MIN_SLOTS = 2048

#: the kernel-input fields a mesh solve takes (no ``prio``, no ``fuse``)
FIELDS = tuple(f for f in KernelInputs._fields if f != "fuse")


def _default_dp(ndev: int) -> int:
    """dp-axis extent for a 2-D layout over ``ndev`` ranks (the
    reference's ``_default_dp`` without its environment override): the
    largest power-of-two divisor with dp <= tp. 8 ranks -> 2 x 4; 2 ranks
    -> 1 x 2 (the type mesh)."""
    dp = 1
    while ndev % (dp * 2) == 0 and (dp * 2) ** 2 <= ndev:
        dp *= 2
    return dp


class MeshComm:
    """A ``(ndp, ntp)`` layout over the initialized default process
    group (module docstring). Without one (or at world size 1, or
    ``solo``: ``MeshComm.single()``) every collective is the identity.
    ``seconds`` and ``calls`` add up the host wall clock spent in
    collectives."""

    def __init__(self, ndp: int = 1, _base: "MeshComm" = None, *,
                 solo: bool = False):
        solo = solo or (_base is not None and _base.solo)
        init = not solo and dist.is_available() and dist.is_initialized()
        self.solo = solo
        self.world = dist.get_world_size() if init else 1
        self.rank = dist.get_rank() if init else 0
        if ndp < 1 or self.world % ndp:
            raise ValueError(f"dp={ndp} does not divide {self.world} ranks")
        self.ndp, self.ntp = ndp, self.world // ndp
        self.dp_idx, self.tp_idx = divmod(self.rank, self.ntp)
        self.backend = str(dist.get_backend()) if init else "none"
        # an axis spanning every rank is the default group (None); with
        # both axes split every rank creates every group, in one order
        self.tp_group = self.dp_group = None
        if self.ntp > 1 and self.ndp > 1:
            for r in range(self.ndp):
                grp = dist.new_group(list(range(r * self.ntp,
                                                (r + 1) * self.ntp)))
                if r == self.dp_idx:
                    self.tp_group = grp
            for c in range(self.ntp):
                grp = dist.new_group([c + i * self.ntp
                                      for i in range(self.ndp)])
                if c == self.tp_idx:
                    self.dp_group = grp
        self._base = self if _base is None else _base
        if _base is None:
            self._layouts: Dict[int, MeshComm] = {ndp: self}
            self.seconds, self.calls = 0.0, 0

    @classmethod
    def single(cls) -> "MeshComm":
        """One rank, whatever process group this process belongs to: the
        layout of a single-device solve beside a mesh (the reference's
        ``ndev=1`` oracle)."""
        return cls(solo=True)

    @property
    def key(self) -> tuple:
        return (self.backend, self.world, self.ndp, self.ntp, self.rank)

    def layout(self, ndp: int) -> "MeshComm":
        """The layout of ``ndp`` dp shards over the same ranks (cached;
        building one creates its groups, so every rank asks for it at the
        same point)."""
        base = self._base
        lay = base._layouts.get(ndp)
        if lay is None:
            lay = base._layouts[ndp] = MeshComm(ndp, _base=base)
        return lay

    # -- the collectives ---------------------------------------------
    def _count(self, t0: float) -> None:
        self._base.seconds += time.perf_counter() - t0
        self._base.calls += 1

    def _all_reduce(self, x: torch.Tensor, op, group) -> torch.Tensor:
        t0 = time.perf_counter()
        dist.all_reduce(x, op=op, group=group)
        self._count(t0)
        return x

    def _all_gather(self, x: torch.Tensor, group, n: int
                    ) -> List[torch.Tensor]:
        """The n shards' ``x`` in rank order of the group."""
        t0 = time.perf_counter()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        self._count(t0)
        return parts

    def axis_max(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the type shards, in place (the reference's
        ``_axis_max``: ``pmax`` over tp)."""
        if self.ntp == 1:
            return x
        return self._all_reduce(x, dist.ReduceOp.MAX, self.tp_group)

    def dp_before(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` (per-shard totals, [m]) over the dp shards
        before this rank's: one all_gather (the reference's
        ``_dp_prefix``). Wraps as int64 sums do."""
        if self.ndp == 1:
            return torch.zeros_like(x)
        parts = self._all_gather(x, self.dp_group, self.ndp)
        return torch.stack(parts[:self.dp_idx]).sum(dim=0) if self.dp_idx \
            else torch.zeros_like(x)

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the dp shards, in place (the reference's ``_dp_sum``:
        ``psum`` over dp)."""
        if self.ndp == 1:
            return x
        return self._all_reduce(x, dist.ReduceOp.SUM, self.dp_group)

    def tp_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x] if self.ntp == 1 else \
            self._all_gather(x, self.tp_group, self.ntp)

    def dp_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x] if self.ndp == 1 else \
            self._all_gather(x, self.dp_group, self.ndp)


class LocalSlab(NamedTuple):
    """A host's slab of a slot-sharded table (the reference's
    ``distmesh.LocalSlab``): rows [lo, hi) along ``axis`` of a logical
    array of ``global_shape`` that already spans the padded slot range
    (rows past the true table are zeros). ``ex_alloc`` and ``ex_used0``
    are sharded on axis 0, ``ex_compat`` on axis 1."""
    array: np.ndarray
    lo: int
    hi: int
    axis: int
    global_shape: Tuple[int, ...]


def _as_comm(comm: Optional[MeshComm]) -> MeshComm:
    return MeshComm() if comm is None else comm


# ---------------------------------------------------------------------------
# host-side prep (copies of the reference's helpers, on dicts of arrays)
# ---------------------------------------------------------------------------

def _grow(a: np.ndarray, ax: int, size: int) -> np.ndarray:
    if a.shape[ax] >= size:
        return a
    shape = list(a.shape)
    shape[ax] = size - a.shape[ax]
    return np.concatenate([a, np.zeros(shape, a.dtype)], axis=ax)


def _pad_types(arrays: dict, n_shards: int) -> Tuple[dict, int]:
    """Pad the type axis to a multiple of the shard count (the
    reference's ``_pad_types``). Padded types have zero allocatable and no
    offerings: never candidates. Returns (arrays, true T)."""
    T = np.asarray(arrays["A"]).shape[0]
    Tp = ((T + n_shards - 1) // n_shards) * n_shards
    if Tp == T:
        return arrays, T
    out = dict(arrays)
    for nm in ("A", "avail_zc"):
        out[nm] = _grow(np.asarray(arrays[nm]), 0, Tp)
    for nm in ("F", "pool_types"):
        out[nm] = _grow(np.asarray(arrays[nm]), 1, Tp)
    return out, T


def _pad_slots(arrays: dict, E: int, n_max: int, ndp: int
               ) -> Tuple[dict, int]:
    """Pad the slot axis of the existing-node tables to the padded slot
    range Np = ceil(N/ndp)*ndp (the reference's ``_pad_slots``); rows past
    E are inert. Returns (arrays, true N)."""
    N = E + n_max
    Np = ((N + ndp - 1) // ndp) * ndp
    out = dict(arrays)
    for nm in ("ex_alloc", "ex_used0"):
        a = np.asarray(arrays[nm])
        g = np.zeros((Np,) + a.shape[1:], a.dtype)
        g[:a.shape[0]] = a
        out[nm] = g
    c = np.asarray(arrays["ex_compat"])
    g = np.zeros(c.shape[:1] + (Np,), np.bool_)
    g[:, :c.shape[1]] = c
    out["ex_compat"] = g
    return out, N


def _prep_field(name: str, a, Tp: int, Np: Optional[int]) -> np.ndarray:
    """One field's host prep for placement (the reference's
    ``_prep_field``): the type axis padded to Tp and, for the 2-D layout
    (Np set), the slot axis of the existing tables to Np."""
    a = np.asarray(a)
    if name in ("A", "avail_zc"):
        return _grow(a, 0, Tp)
    if name in ("F", "pool_types"):
        return _grow(a, 1, Tp)
    if Np is not None:
        if name in ("ex_alloc", "ex_used0"):
            return _grow(a, 0, Np)
        if name == "ex_compat":
            return _grow(a, 1, Np)
    return a


def _cut(name: str, a: np.ndarray, lay: MeshComm, Tl: int, Nl: int,
         arrays: dict, V: int) -> np.ndarray:
    """This rank's shard of one prepped field: its types [tp*Tl,
    (tp+1)*Tl) and its slot rows [dp*Nl, (dp+1)*Nl) of the existing
    tables (grown to ndp*Nl rows), the minValues pairs localized to its
    types (a pair of another shard's type points at the dump value V)."""
    t0, n0 = lay.tp_idx * Tl, lay.dp_idx * Nl
    if name in ("A", "avail_zc"):
        return a[t0:t0 + Tl]
    if name in ("F", "pool_types"):
        return a[:, t0:t0 + Tl]
    if name in ("ex_alloc", "ex_used0"):
        return _grow(a, 0, lay.ndp * Nl)[n0:n0 + Nl]
    if name == "ex_compat":
        return _grow(a, 1, lay.ndp * Nl)[:, n0:n0 + Nl]
    if name in ("mv_pairs_t", "mv_pairs_v"):
        t = np.asarray(arrays["mv_pairs_t"]) - t0
        ok = (t >= 0) & (t < Tl)
        if name == "mv_pairs_t":
            return np.where(ok, t, 0)
        return np.where(ok, a, V)
    return a


#: the slot-sharded fields and their slot axis
SLOT_AXIS = {"ex_alloc": 0, "ex_used0": 0, "ex_compat": 1}


def _cut_slab(name: str, s: LocalSlab, lay: MeshComm, Nl: int
              ) -> np.ndarray:
    """This rank's shard of a field that arrives as its host's slab (the
    counterpart of the reference's ``commit_global`` on a LocalSlab): the
    rank's global slot rows [dp*Nl, (dp+1)*Nl), remapped to slab-local
    rows. Raises when the rows fall outside the slab, or when the slab's
    logical shape does not span the layout's padded slot range (the
    layout and the slab geometry drifted); never pads."""
    axis = SLOT_AXIS.get(name)
    if axis is None or s.axis != axis:
        raise ValueError(f"{name} is not slot-sharded on axis {s.axis}")
    start, stop = lay.dp_idx * Nl, (lay.dp_idx + 1) * Nl
    gshape = tuple(int(x) for x in s.global_shape)
    if gshape[axis] != lay.ndp * Nl:
        raise ValueError(f"{name}: slab of global shape {gshape} does not "
                         f"span the {lay.ndp} x {Nl} padded slot rows")
    if start < s.lo or stop > s.hi:
        raise ValueError(f"rank {lay.rank} wants global rows [{start},"
                         f"{stop}) of {name} outside local slab "
                         f"[{s.lo},{s.hi})")
    a = np.asarray(s.array)
    if a.shape[axis] != s.hi - s.lo:
        raise ValueError(f"{name}: slab holds {a.shape[axis]} rows for "
                         f"[{s.lo},{s.hi})")
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(start - s.lo, stop - s.lo)
    return a[tuple(idx)]


def _shape_key(a) -> tuple:
    """A field's entry in the resident key: a slab by its geometry and
    its array's shape, anything else by its shape."""
    if isinstance(a, LocalSlab):
        return ("slab", int(a.lo), int(a.hi), int(a.axis),
                tuple(int(x) for x in a.global_shape),
                tuple(np.asarray(a.array).shape))
    return tuple(np.asarray(a).shape)


def _upload(fields: Dict[str, np.ndarray], device: torch.device
            ) -> Dict[str, torch.Tensor]:
    """The shard on ``device`` (one host-to-device copy on CUDA); bool
    fields as bool, the rest int64, every tensor its own memory."""
    host = {nm: np.array(a, dtype=bool if nm in _BOOL_FIELDS else np.int64)
            for nm, a in fields.items()}
    return _device.upload(host, device)


def _shard_inputs(arrays: dict, lay: MeshComm, names, Tp: int, Np_cut: int,
                  Np_prep: Optional[int], V: int, device) -> dict:
    """This rank's shard of the ``names`` fields, placed on ``device`` in
    one host-to-device copy. A field given whole is prepped and cut
    (``_prep_field``, ``_cut``); a slot field given as its host's slab is
    cut from the slab (``_cut_slab``)."""
    Tl, Nl = Tp // lay.ntp, Np_cut // lay.ndp
    return _upload({nm: _cut_slab(nm, arrays[nm], lay, Nl)
                    if isinstance(arrays[nm], LocalSlab) else
                    _cut(nm, _prep_field(nm, arrays[nm], Tp, Np_prep), lay,
                         Tl, Nl, arrays, V)
                    for nm in names}, device)


# ---------------------------------------------------------------------------
# the step loop and the output gather
# ---------------------------------------------------------------------------

def _checked(name: str, st: mc.MeshState, args: tuple, check) -> None:
    """Launch one kernel; with ``check``, also run its plain part on a
    copy of the entry state and hand both to ``check(name, args, st,
    plain)`` (the card's kernel-against-plain check)."""
    if check is None:
        mc.WRAPPERS[name](st, *args)
        return
    ref = st.clone()
    mc.WRAPPERS[name](st, *args)
    mc.PLAIN[name](ref, *args)
    check(name, args, st, ref)


#: the group steps a ``check`` hook sees (every launch of each, and the
#: caps): the first four, as the reference's tests hold the first steps
CHECK_STEPS = 4


def _mesh_scan(st: mc.MeshState, lay: MeshComm, *, check=None,
               split_fill: bool = False) -> dict:
    """The per-rank step loop of both shapes: the kernels (the plain
    parts on a CPU state) with the collectives between them. ``check``
    holds every launch of the first ``CHECK_STEPS`` groups (and the caps)
    against the plain part from the same entry state. The fill runs in
    its three phases when the slots are split (or ``split_fill``: the
    same decisions on one slot shard), else in one launch. Returns
    per-solve counts: steps, collectives and their seconds."""
    c0, s0 = lay._base.calls, lay._base.seconds
    # the launches go to the state's device: its guard once for the loop
    guard = on_device(st.device) if st.device.type == "cuda" else \
        contextlib.nullcontext()
    with guard:
        _checked("mesh_new_caps", st, (), check)
        lay.axis_max(st.caps)
        for g in range(st.G):
            chk = check if g < CHECK_STEPS else None
            _checked("mesh_slot_headroom", st, (g,), chk)
            lay.axis_max(st.kh)
            if lay.ndp == 1 and not split_fill:
                _checked("mesh_fill", st, (g, mc.PHASE_ALL), chk)
            else:
                _checked("mesh_fill", st, (g, mc.PHASE_A), chk)
                st.before[:st.P] = lay.dp_before(st.red[:st.P])
                _checked("mesh_fill", st, (g, mc.PHASE_B), chk)
                st.before[st.P:] = lay.dp_before(st.red[:1])
                _checked("mesh_fill", st, (g, mc.PHASE_C), chk)
                lay.dp_sum(st.red)
            _checked("mesh_commit", st, (g,), chk)
    return dict(steps=st.G, collectives=lay._base.calls - c0,
                collective_s=lay._base.seconds - s0)


def _gather(takes: torch.Tensor, leftover: torch.Tensor, carry: Carry,
            lay: MeshComm) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
    """Every rank's full outputs from its shard's: the type slabs of
    ``types`` over tp, then every slot-indexed output over dp in one flat
    byte buffer. Padding is left for the caller to strip."""
    types = carry.types
    if lay.ntp > 1:
        types = torch.cat(lay.tp_gather(types.contiguous()), 1)
    # widest dtype first: every slab's bytes start aligned for its dtype
    slabs = dict(used=carry.used, takes=takes.t(), pool=carry.pool,
                 types=types, zones=carry.zones, ct=carry.ct,
                 alive=carry.alive)
    if lay.ndp > 1:
        parts = [v.contiguous().reshape(-1).view(torch.uint8)
                 for v in slabs.values()]
        flat = torch.cat(parts)
        got = lay.dp_gather(flat)
        out = {}
        for nm, v in slabs.items():
            out[nm] = []
        for buf in got:
            off = 0
            for nm, v in slabs.items():
                nb = v.numel() * v.element_size()
                out[nm].append(buf[off:off + nb].view(v.dtype).reshape(
                    v.shape))
                off += nb
        slabs = {nm: torch.cat(ps, 0) for nm, ps in out.items()}
    return (slabs["takes"].t().contiguous(), leftover,
            carry._replace(used=slabs["used"], types=slabs["types"],
                           zones=slabs["zones"], ct=slabs["ct"],
                           pool=slabs["pool"], alive=slabs["alive"]))


def _run(inp: KernelInputs, lay: MeshComm, *, n_max: int, E: int, P: int,
         V: int, plain: bool, check=None, stats: Optional[dict] = None,
         split_fill: bool = False):
    """One sharded solve on this rank's shard ``inp``: the plain version
    (``plain``; the reference's step structure, line for line) or the
    per-rank kernels, then the gather."""
    N = E + n_max
    Nl = inp.ex_used0.shape[0]
    slot0 = lay.dp_idx * Nl
    if plain and lay.ndp == 1:
        replicated = inp._replace(ex_alloc=inp.ex_alloc[:E],
                                  ex_used0=inp.ex_used0[:E],
                                  ex_compat=inp.ex_compat[:, :E])
        takes, leftover, carry = _solve_scan_ref(replicated, n_max, E, P, V,
                                                 comm=lay)
    elif plain:
        takes, leftover, carry = _solve_dp_ref(inp, lay, n_max, E, P, slot0)
    else:
        st = mc.MeshState(inp, E=E, P=P, V=V, N=N, slot0=slot0)
        info = _mesh_scan(st, lay, check=check, split_fill=split_fill)
        if stats is not None:
            stats.update(info)
        takes, leftover, carry = st.takes, st.leftover, st.carry
    return _gather(takes, leftover, carry, lay)


def _strip(takes, leftover, carry: Carry, T: int, N: int):
    return (takes[:, :N], leftover,
            carry._replace(used=carry.used[:N], types=carry.types[:N, :T],
                           zones=carry.zones[:N], ct=carry.ct[:N],
                           pool=carry.pool[:N], alive=carry.alive[:N]))


def solve_scan_sharded(arrays: dict, comm: Optional[MeshComm], n_max: int,
                       E: int, P: int, V: int = 0, *, device=None,
                       plain: bool = False, check=None,
                       split_fill: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
    """Type-parallel solve over every rank of ``comm`` (the reference's
    ``solve_scan_sharded``): the full host arrays in (numpy, the
    reference's field set), (takes [G, N] int32, leftover [G], the final
    carry) out on every rank, decisions identical to the single-device
    scan. minValues floors allowed. ``plain`` runs the plain version
    (the reference's collectives, one by one), else the per-rank kernels
    (their plain parts on the CPU); ``check`` and ``split_fill`` as
    ``_mesh_scan`` takes them."""
    lay = _as_comm(comm).layout(1)
    dev = _device.resolve(device)
    T = np.asarray(arrays["A"]).shape[0]
    Tp = -(-T // lay.ntp) * lay.ntp
    N = E + n_max
    names = [f for f in FIELDS if arrays.get(f) is not None]
    inp = KernelInputs(**_shard_inputs(arrays, lay, names, Tp, N, None, V,
                                       dev))
    out = _run(inp, lay, n_max=n_max, E=E, P=P, V=V, plain=plain,
               check=check, split_fill=split_fill)
    return _strip(*out, T, N)


def solve_scan_sharded2(arrays: dict, comm: MeshComm, n_max: int, E: int,
                        P: int, *, device=None, plain: bool = False,
                        check=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
    """Pods x types solve over ``comm``'s ``(ndp, ntp)`` layout (the
    reference's ``solve_scan_sharded2``); the same contract as
    ``solve_scan_sharded``. No minValues floors."""
    if arrays.get("mv_floor") is not None:
        raise ValueError("2-D mesh solve does not take minValues floors; "
                         "use the type mesh (solve_scan_sharded)")
    lay = _as_comm(comm)
    dev = _device.resolve(device)
    T = np.asarray(arrays["A"]).shape[0]
    Tp = -(-T // lay.ntp) * lay.ntp
    N = E + n_max
    Np = -(-N // lay.ndp) * lay.ndp
    names = [f for f in FIELDS if arrays.get(f) is not None]
    inp = KernelInputs(**_shard_inputs(arrays, lay, names, Tp, Np, Np, 0,
                                       dev))
    out = _run(inp, lay, n_max=n_max, E=E, P=P, V=0, plain=plain,
               check=check)
    return _strip(*out, T, N)


# ---------------------------------------------------------------------------
# the solver's dispatch: shape choice and resident shards
# ---------------------------------------------------------------------------

def _place_resident(arrays: dict, lay: MeshComm, kern: str, Tp: int,
                    Np: Optional[int], N: int, statics_key, cache: dict,
                    dirty, V: int, device) -> KernelInputs:
    """The rank's resident shard for a mesh dispatch (the reference's
    ``_place_resident``). ``dirty=None``: no claim about the host arrays,
    full placement. A list: every field not listed is unchanged since
    the previous dispatch against this cache, so only the listed ones are
    re-prepped, re-cut and re-placed, provided the resident key (kernel,
    layout, statics, field shapes) matches exactly; a changed key places
    everything. Slot fields may arrive as their host's slabs
    (``LocalSlab``); the key then holds the slab geometry."""
    fields = [f for f in FIELDS if arrays.get(f) is not None]
    key = (statics_key, Tp, Np,
           tuple((f, _shape_key(arrays[f])) for f in fields))
    Np_cut = N if Np is None else Np
    res = cache.get("resident")
    if dirty is not None and res is not None and res["key"] == key:
        mode = "patch" if dirty else "reuse"
        placed = [f for f in dirty if f in fields]
        if "mv_pairs_t" in placed and "mv_pairs_v" not in placed:
            placed.append("mv_pairs_v")
        res["dev"].update(_shard_inputs(arrays, lay, placed, Tp, Np_cut, Np,
                                        V, device))
    else:
        mode = "full"
        res = cache["resident"] = dict(
            key=key, dev=_shard_inputs(arrays, lay, fields, Tp, Np_cut, Np,
                                       V, device))
        cache["resident_gen"] = cache.get("resident_gen", 0) + 1
        placed = list(fields)
    cache["last_placement"] = {"mode": mode, "kernel": kern,
                               "fields": list(placed)}
    return KernelInputs(**res["dev"])


def dispatch_mesh(arrays: dict, *, comm: Optional[MeshComm], n_max: int,
                  E: int, P: int, V: int, cache: dict, dirty=None,
                  dp: Optional[int] = None,
                  dp2_min_slots: int = DP2_MIN_SLOTS, device=None,
                  check=None) -> dict:
    """The solver's mesh dispatch (the reference's ``dispatch_mesh``):
    the pods x types shape when the dp factor (``dp``, default
    ``_default_dp`` of the world) is > 1, the slot count reaches
    ``dp2_min_slots`` and there are no minValues floors, else the type
    mesh; the rank's shard resident across ticks (``_place_resident``);
    the solve; the outputs as the dict of ``hostpack.unpack_outputs1``.
    ``cache["last_placement"]`` and ``cache["last_mesh"]`` record the
    placement and the shape."""
    comm = _as_comm(comm)
    has_mv = arrays.get("mv_floor") is not None
    N = E + n_max
    ndp = 1 if (has_mv or N < max(0, dp2_min_slots)) else \
        (dp if dp is not None else _default_dp(comm.world))
    lay = comm.layout(ndp)
    kern = "dp2" if lay.ndp > 1 else "tp"
    T = int(np.asarray(arrays["A"]).shape[0])
    Tp = -(-T // lay.ntp) * lay.ntp
    Np = -(-N // lay.ndp) * lay.ndp if kern == "dp2" else None
    dev = _device.resolve(device)
    inp = _place_resident(arrays, lay, kern, Tp, Np, N,
                          (kern, lay.key, n_max, E, P, V), cache, dirty, V,
                          dev)
    stats: dict = {}
    takes, leftover, carry = _run(inp, lay, n_max=n_max, E=E, P=P, V=V,
                                  plain=False, check=check, stats=stats)
    cache["last_mesh"] = dict(kernel=kern, ndp=lay.ndp, ntp=lay.ntp,
                              backend=lay.backend, **stats)
    return _out_dict(takes, leftover, carry, T,
                     N=N if kern == "dp2" else None)


def _out_dict(takes, leftover, carry: Carry, T: int,
              N: Optional[int] = None) -> dict:
    """The solve outputs as ``hostpack.unpack_outputs1``'s dict (the
    reference's ``_out_dict``): numpy, the type padding stripped and,
    when ``N`` is given (the slot-sharded shape), the slot padding."""
    c = {nm: np.asarray(t.cpu()) for nm, t in carry._asdict().items()}
    takes = np.asarray(takes.cpu())
    if N is not None:
        takes = takes[:, :N]
        for nm in ("used", "types", "zones", "ct", "pool", "alive"):
            c[nm] = c[nm][:N]
    return dict(takes=takes, leftover=np.asarray(leftover.cpu()),
                num_nodes=c["num_nodes"].reshape(1), used=c["used"],
                pool=c["pool"], pool_used=c["pool_used"],
                types=c["types"][:, :T], zones=c["zones"], ct=c["ct"],
                alive=c["alive"])
