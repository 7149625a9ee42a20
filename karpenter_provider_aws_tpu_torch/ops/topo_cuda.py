"""The CUDA kernels of the topology scan (K9): wrappers and the scan loop.

``csrc/topo.cu`` is built into the one kernel library of
``ops/ffd_cuda.py``. Each wrapper checks its inputs (``TopoScanState``),
launches on the state's device, on its current stream
(``ffd_cuda._launch``), adds one to its entry of
``ffd_cuda.LAUNCHES`` and raises when the C entry returns a CUDA error.
Nothing here falls back to the plain versions in ``ops/topo_torch.py``.

- ``topo_pool_statics``: the per-pool statics of opening a node and the
  anti-ladder gate of a chunk of topology groups (``chunk`` of them, the
  tables' rows; they read no carry), one launch before the chunk's first
  group; the chunk at rank 0 also packs each type's offerings into one
  Z*C-bit word;
- ``topo_group_start``: a topology group's candidates and per-slot room
  (after its chunk's statics);
- ``topo_pour``: the group's whole event loop and its group-end
  narrowing, in one block; its shared memory holds the counter rows a
  group lists (``listed_rows``), sized by the most any topology group
  lists, and a layout past the card's shared memory (or more than 64
  zones) raises ``TopoLayoutError``; ``pour_fits`` answers the same
  question before a scan, for the solver's routing.

A group without topology runs the K2 kernels, and its
``ffd_group_commit`` also records its membership in the counters (the
state's ``record``, ``ffd_cuda._RecordArgs``): no launch of its own.

``solve_scan_topo_cuda`` drives one scan (``topo_state``, then the
launches of ``topo_scan``): the K2 ``ScanState`` and the
``TopoScanState`` share one carry on the device, which every kernel updates
in place; per group two launches (and a chunk's statics) under one guard
of the state's device, no synchronisation after the one read of
``has_topo`` and the listed rows' counts.
"""

from __future__ import annotations

import ctypes

import torch

from .ffd_cuda import (LAUNCHES, ScanState, _FfdArgs, _check, _launch, _lib,
                       _need, _RecordArgs, ffd_group_commit,
                       ffd_slot_headroom, launching, on_device)
from .ffd_torch import BIG, KernelInputs, carry0
from .topo_torch import (GroupStart, PoolStatics, TopoGroupRows,
                         empty_events, statics_chunk)

_ROW_FIELDS = ("has_topo", "zone_needed", "min_mask", "zs_any", "zs_skew",
               "hs_any", "hs_skew", "za_any", "za_anti", "za_own", "ha_any",
               "ha_anti", "ha_own", "member_z", "member_h")
_PTR_FIELDS = _ROW_FIELDS + (
    "cz", "ch", "zfix", "take", "rem", "und", "cand_new", "hr_new",
    "open_ok0", "availz_p", "cap_pz", "cap_any", "zcand_pz", "anti_bulk",
    "ev_slot", "ev_zone", "ev_len", "ev_kind", "ev_aux", "ev_n", "bail",
    "srow", "tgid", "offw")


class _TopoArgs(ctypes.Structure):
    """Mirror of ``struct TopoArgs`` in csrc/topo.cu (8-byte fields)."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [(f, ctypes.c_longlong) for f in ("GZ", "GH", "EVCAP",
                                                    "PMAX", "NZ", "NH",
                                                    "CH")])


#: ``kLayoutTooLarge``: the pour's entry refuses a layout past the card's
#: shared memory for one block, or more than 64 zones
_LAYOUT_TOO_LARGE = -1


class TopoLayoutError(ValueError):
    """The pour's shared-memory layout does not fit one block of the
    card (or the shape has more than 64 zones)."""


def listed_rows(rows: TopoGroupRows):
    """[G] the zone and the hostname counter rows each group's pour lists
    (an enforced skew, an affinity term, a spread record or the
    membership row): the rows the pour's shared memory holds."""
    GZ, GH = rows.zs_any.shape[1], rows.hs_any.shape[1]
    dev = rows.zs_any.device
    mz = rows.member_z.long()[:, None] == torch.arange(GZ, device=dev)
    mh = rows.member_h.long()[:, None] == torch.arange(GH, device=dev)
    nz = ((rows.zs_skew < BIG) | rows.za_any | rows.zs_any | mz).sum(1)
    nh = ((rows.hs_skew < BIG) | rows.ha_any | rows.hs_any | mh).sum(1)
    return nz, nh


def listed_max(rows: TopoGroupRows):
    """The most zone and the most hostname counter rows a topology group
    lists (``listed_rows`` over the groups with topology; 0 without any),
    as two 0-d tensors on the rows' device: the NZ and NH that size the
    pour's shared memory."""
    topo = rows.has_topo
    return tuple(torch.cat([c.new_zeros(1), torch.where(topo, c, 0)]).max()
                 for c in listed_rows(rows))


def pour_fits(rows: TopoGroupRows, *, Z: int, C: int, D: int, P: int,
              PMAX: int, device) -> bool:
    """Whether the pour on ``device`` can lay out a scan of these rows:
    at most 64 zones, and the shared bytes the C entry
    ``karp_topo_pour_smem`` counts for the rows the groups list
    (``listed_max``) within the card's limit for one block. The solver
    asks before the scan's first launch and sends a snapshot that does
    not fit to the host pour. The plain pour on the CPU has no layout:
    True there."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return True
    if Z > 64:
        return False
    nz, nh = (int(x) for x in listed_max(rows))
    f = _FfdArgs(D=D, Z=Z, C=C, P=P)
    t = _TopoArgs(NZ=nz, NH=nh, PMAX=PMAX)
    nbytes, limit = ctypes.c_longlong(), ctypes.c_longlong()
    with on_device(dev):
        _check(_lib().karp_topo_pour_smem(ctypes.byref(f), ctypes.byref(t),
                                          ctypes.byref(nbytes),
                                          ctypes.byref(limit)),
               "topo_pour (layout)")
    return nbytes.value <= limit.value


class TopoScanState:
    """The topology side of one scan on the card, beside the K2
    ``ScanState`` ``st`` whose carry, candidate scratch, takes and
    leftover it shares: the rows, the counters ``cz`` [GZ, Z], ``ch``
    [GH, N] and ``zfix`` [N] (updated in place), the per-group scratch
    (``take``, ``rem``, the pour's undecided words ``und``), the pool
    statics of a chunk of ``chunk`` topology groups (``cand_new`` [CH, P,
    T] ..., ``anti_bulk`` [CH]: row ``rank[g] % chunk`` is group g's), the
    types' offering words ``offw`` [T], the event log ``ev`` (``[G,
    EVCAP]`` rows at their fill values, ``n`` [G]) and ``bail`` [G], plus
    the ctypes argument block and ``record``, the block that a plain
    group's ``ffd_group_commit`` records its membership with (the
    counters and the membership rows). ``nz`` / ``nh``: the most zone /
    hostname rows a topology group lists (``listed_rows``), which size
    the pour's shared memory; ``has_topo``: the rows' flags as a list (one
    read of the device for both); ``topo_groups``: the topology groups in
    order, ``rank`` [G] each one's index there (-1 for the others).
    ``chunk``: ``statics_chunk``'s rule."""

    def __init__(self, st: ScanState, rows: TopoGroupRows, cz, ch, zfix, *,
                 EVCAP: int, PMAX: int):
        inp = st.inp
        dev = inp.A.device
        T = inp.A.shape[0]
        G = inp.R.shape[0]
        Z, P = inp.agz.shape[1], inp.pool_types.shape[0]
        N = st.carry.used.shape[0]
        GZ, GH = cz.shape[0], ch.shape[0]
        if st.lanes is not None or st.s0 != 0 or st.s1 != G:
            raise ValueError("the topology scan takes one lane over every "
                             "group")
        if EVCAP < 1 or PMAX < 1:
            raise ValueError(f"EVCAP={EVCAP} and PMAX={PMAX} must be >= 1")
        chunk = statics_chunk(P, T, Z)
        b, i64, i32 = torch.bool, torch.int64, torch.int32
        for nm, dt, shp in (
                ("has_topo", b, (G,)), ("zone_needed", b, (G,)),
                ("min_mask", b, (G, Z)), ("zs_any", b, (G, GZ)),
                ("zs_skew", i64, (G, GZ)), ("hs_any", b, (G, GH)),
                ("hs_skew", i64, (G, GH)), ("za_any", b, (G, GZ)),
                ("za_anti", b, (G, GZ)), ("za_own", b, (G, GZ)),
                ("ha_any", b, (G, GH)), ("ha_anti", b, (G, GH)),
                ("ha_own", b, (G, GH)), ("member_z", i32, (G,)),
                ("member_h", i32, (G,))):
            _need(getattr(rows, nm), nm, dt, shp)
        _need(cz, "cz", i64, (GZ, Z))
        _need(ch, "ch", i64, (GH, N))
        _need(zfix, "zfix", i32, (N,))
        self.st, self.rows, self.chunk = st, rows, chunk
        self.cz, self.ch, self.zfix = cz, ch, zfix
        self.take = torch.empty(N, dtype=i64, device=dev)
        self.rem = torch.empty(N, dtype=i64, device=dev)
        self.und = torch.empty(2 * (-(-N // 32)), dtype=torch.int32,
                               device=dev)
        self.cand_new = torch.empty((chunk, P, T), dtype=b, device=dev)
        self.hr_new = torch.empty((chunk, P, T), dtype=i64, device=dev)
        self.open_ok0 = torch.empty((chunk, P), dtype=b, device=dev)
        self.availz_p = torch.empty((chunk, P, T, Z), dtype=b, device=dev)
        self.cap_pz = torch.empty((chunk, P, Z), dtype=i64, device=dev)
        self.cap_any = torch.empty((chunk, P), dtype=i64, device=dev)
        self.zcand_pz = torch.empty((chunk, P, Z), dtype=b, device=dev)
        self.anti_bulk = torch.empty(chunk, dtype=b, device=dev)
        self.offw = torch.empty(T, dtype=i64, device=dev)
        self.ev = empty_events(G, EVCAP, dev)
        self.bail = torch.zeros(G, dtype=b, device=dev)
        nz, nh = listed_max(rows)
        head = torch.cat([torch.stack([nz, nh]),
                          rows.has_topo.long()]).tolist()
        self.nz, self.nh = head[:2]
        self.has_topo = [bool(x) for x in head[2:]]
        self.topo_groups = [g for g, t in enumerate(self.has_topo) if t]
        self.rank = [-1] * G
        for r, g in enumerate(self.topo_groups):
            self.rank[g] = r
        # srow [G] (a topology group's table row, -1 for the others), then
        # tgid [n_topo]: one copy to the device
        idx = torch.tensor([r % chunk if r >= 0 else -1 for r in self.rank]
                           + self.topo_groups, dtype=i32).to(dev)
        self.srow, self.tgid = idx[:G], idx[G:]
        ptrs = {}
        for f in _PTR_FIELDS:
            if f in _ROW_FIELDS:
                t = getattr(rows, f)
            elif f.startswith("ev_"):
                t = self.ev[f[3:]]
            else:
                t = getattr(self, f)
            ptrs[f] = t.data_ptr() if t.numel() else None
        self.args = _TopoArgs(**ptrs, GZ=GZ, GH=GH, EVCAP=EVCAP, PMAX=PMAX,
                              NZ=self.nz, NH=self.nh, CH=chunk)
        self.record = _RecordArgs(**{f: ptrs[f] for f in (
            "cz", "ch", "zfix", "member_z", "member_h")})

    def chunks(self) -> int:
        """The scan's chunks of topology groups."""
        return -(-len(self.topo_groups) // self.chunk)

    def statics(self, g: int) -> PoolStatics:
        """Topology group g's row of the pool statics (views, no leading
        axis)."""
        j = self._row(g)
        return PoolStatics(*[getattr(self, f)[j]
                             for f in PoolStatics._fields])

    def load_statics(self, g: int, gs: GroupStart) -> None:
        """Group g's row of the pool statics set to those of ``gs`` (a
        plain group start), as its chunk's launch writes them."""
        for f, dst in zip(PoolStatics._fields, self.statics(g)):
            dst.copy_(getattr(gs, f).reshape(dst.shape))

    def _row(self, g: int) -> int:
        if not 0 <= g < len(self.rank) or self.rank[g] < 0:
            raise ValueError(f"group {g} is not a topology group")
        return self.rank[g] % self.chunk


def _topo_launch(name: str, ts: TopoScanState, g: int, stream,
                 entry=None) -> None:
    if not 0 <= g < ts.st.s1:
        raise ValueError(f"group {g} outside [0, {ts.st.s1})")
    _launch(name, entry or getattr(_lib(), f"karp_{name}"),
            (ctypes.byref(ts.st.args), ctypes.byref(ts.args), g), ts.take,
            stream)


def topo_pool_statics(ts: TopoScanState, c: int, stream: int = None) -> None:
    """The pool statics of chunk c (the topology groups of ranks [c·chunk,
    (c + 1)·chunk), table rows 0 ..) and, for chunk 0, the types'
    offering words ``ts.offw`` (kernel). ``stream``: the stream of the
    caller's ``launching`` guard."""
    if not 0 <= c < ts.chunks():
        raise ValueError(f"chunk {c} outside [0, {ts.chunks()})")
    r0 = c * ts.chunk
    nr = min(ts.chunk, len(ts.topo_groups) - r0)
    _launch("topo_pool_statics", _lib().karp_topo_pool_statics,
            (ctypes.byref(ts.st.args), ctypes.byref(ts.args), r0, nr),
            ts.take, stream)


def topo_group_start(ts: TopoScanState, g: int, stream: int = None) -> None:
    """Topology group g's candidates ``st.cand`` [N, T] and per-slot room
    ``ts.rem`` [N] (kernel), reading the offering words of the scan's
    chunk 0 (``topo_pool_statics`` first). ``stream``: the stream of the
    caller's ``launching`` guard."""
    ts._row(g)
    _topo_launch("topo_group_start", ts, g, stream)


def topo_pour(ts: TopoScanState, g: int, stream: int = None) -> None:
    """Topology group g's event loop and narrowing from its group-start
    state (its candidates and room, its chunk's row of the pool statics):
    updates the carry and counters in place and writes
    ``st.takes[g]``, ``st.leftover[g]``, the group's event-log row,
    ``ev["n"][g]`` and ``bail[g]`` (kernel). Raises TopoLayoutError,
    launching nothing, when the listed rows' layout exceeds the card's
    shared memory for one block or the shape has more than 64 zones."""

    def entry(a, t, g, stream):
        err = _lib().karp_topo_pour(a, t, g, stream)
        if err == _LAYOUT_TOO_LARGE:
            nbytes, limit = ctypes.c_longlong(), ctypes.c_longlong()
            _lib().karp_topo_pour_smem(a, t, ctypes.byref(nbytes),
                                       ctypes.byref(limit))
            inp = ts.st.inp
            raise TopoLayoutError(
                f"the pour's layout takes {nbytes.value} bytes of shared "
                f"memory for {ts.nz} zone and {ts.nh} hostname rows at "
                f"Z={inp.agz.shape[1]}, D={inp.A.shape[1]}; one block of "
                f"the card holds {limit.value}, and at most 64 zones")
        return err

    _topo_launch("topo_pour", ts, g, stream, entry)


def plain_commit(ts: TopoScanState, g: int, stream: int = None) -> None:
    """``ffd_group_commit`` of group g, a group without topology, with
    its membership recorded in the scan's counters in the same launch
    (kernel; after its ``ffd_slot_headroom``)."""
    if ts.has_topo[g]:
        raise ValueError(f"group {g} is a topology group")
    ffd_group_commit(ts.st, g, stream, ts.record)


def topo_state(inp: KernelInputs, rows: TopoGroupRows, cz0, ch0, *,
               n_max: int, P: int, EVCAP: int, PMAX: int) -> TopoScanState:
    """A fresh scan on the card: the initial carry (no existing nodes),
    copies of ``cz0`` / ``ch0``, every zone undecided."""
    st = ScanState(inp, carry0(inp, n_max, 0), E=0, P=P)
    zfix = torch.full((n_max,), -1, dtype=torch.int32, device=inp.A.device)
    return TopoScanState(st, rows, cz0.clone(), ch0.clone(), zfix, EVCAP=EVCAP,
                         PMAX=PMAX)


def solve_scan_topo_cuda(inp: KernelInputs, rows: TopoGroupRows, cz0, ch0,
                         *, n_max: int, P: int, EVCAP: int = 128,
                         PMAX: int = 8):
    """The whole topology scan on the card (``topo_state``, then
    ``topo_scan``). Returns the reference's outputs (takes [G, N] i64,
    leftover, events, zfix, bail, final Carry) on the card. The only
    synchronisation is one read of ``has_topo`` and the rows' listed
    counts (the pour's layout) before the first launch."""
    return topo_scan(topo_state(inp, rows, cz0, ch0, n_max=n_max, P=P,
                                EVCAP=EVCAP, PMAX=PMAX))


def topo_scan(ts: TopoScanState):
    """The launches of a scan from a fresh state, under one guard of its
    device and with no synchronisation: per chunk of topology groups
    ``topo_pool_statics`` (chunk 0 before the scan's first group, each
    later one before its first group), per topology group
    ``topo_group_start`` and ``topo_pour``, per other group the K2 pair,
    its commit recording the group's membership (``plain_commit``).
    Returns the outputs as ``solve_scan_topo_cuda``."""
    st = ts.st
    with launching(ts.take) as stream:
        if ts.topo_groups:
            topo_pool_statics(ts, 0, stream)
        for g, topo in enumerate(ts.has_topo):
            if topo:
                r = ts.rank[g]
                if r and r % ts.chunk == 0:
                    topo_pool_statics(ts, r // ts.chunk, stream)
                topo_group_start(ts, g, stream)
                topo_pour(ts, g, stream)
            else:
                ffd_slot_headroom(st, g, stream)
                plain_commit(ts, g, stream)
    return (st.takes.to(torch.int64), st.leftover, ts.ev, ts.zfix, ts.bail,
            st.carry)
