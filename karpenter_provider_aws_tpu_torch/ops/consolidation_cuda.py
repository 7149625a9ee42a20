"""The CUDA kernels of consolidation's batched search (K7): wrappers.

``csrc/consolidation.cu`` is built into the one kernel library of
``ops/ffd_cuda.py``. Each wrapper checks device, dtype, shape and
contiguity, allocates its outputs and scratch with ``torch.empty``,
launches on its tensors' device, on that device's current stream
(``ffd_cuda._launch``), adds one to its entry of ``ffd_cuda.LAUNCHES``
and raises when the C entry returns a CUDA error.
Nothing here falls back to the plain versions in
``ops/consolidation_torch.py``.

- ``consol_absorb(mode, ...)``: the absorption scans, one launch per
  batch whatever B or G: ``"deletions"`` (shared tables), ``"prescreen"``
  (shared tables + the one-new-node tail), ``"dense"`` (per-lane tables).
  A lane is one CTA of ``ABSORB_THREADS``; its threads keep their rows in
  registers, shared memory or a global scratch (``absorb_form``). B = 0
  launches nothing.
- ``preempt_absorb``: K8, the preemption victim-set search, as the fourth
  mode of the same kernel (``consol_absorb_preempt``): shared group rows,
  a per-lane refund, each lane's summed leftover out.
- ``subset_gather``: every lane's KernelInputs from the union arena, X
  CTAs a lane (``gather_ctas``: by bytes, about four waves of the card's
  resident CTAs), each field's rows cut into X slices, 16-byte stores.
- ``summary_args``: the [B, 5] rows' arguments, which the round's last
  ``ffd_group_commit`` launch takes (``csrc/ffd_scan.cu`` writes the rows
  after that commit).
- ``subset_solve_cuda``: gather, the K2 kernels on their lane axis
  (2·Gq launches, the last commit writing the rows); a round of no lanes
  or no groups launches nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import ffd_cuda
from .ffd_cuda import ScanState, _launch, _lib, _need
from .ffd_torch import KernelInputs, carry0

#: threads a CTA of the absorption scan; rows a thread keeps in registers
#: (form 0), each of at most ABSORB_REG_DIMS dims
ABSORB_THREADS = 256
ABSORB_REG_ROWS = 4
ABSORB_REG_DIMS = 8
#: the largest lane's rows kept in shared memory (form 1, bytes); larger
#: rows go to a global scratch (form 2)
ABSORB_SMEM_MAX = 160 * 1024

_MODES = {"deletions": 0, "prescreen": 1, "dense": 2}
#: the kernel's fourth mode, K8 (``preempt_absorb``)
_MODE_PREEMPT = 3

_vp, _ll = ctypes.c_void_p, ctypes.c_longlong


class _AbsorbArgs(ctypes.Structure):
    """Mirror of ``struct AbsorbArgs`` in csrc/consolidation.cu."""
    _fields_ = ([(f, _vp) for f in (
        "ex_alloc", "ex_used0", "compat", "R", "gid", "cid", "n", "alive",
        "type_alloc", "type_price", "tcompat", "padmit", "pool_types",
        "price_cap", "scratch", "leftover", "out", "freed", "total")]
        + [(f, _ll) for f in ("B", "G", "E", "D", "Sc", "T", "P",
                              "form")])


class _GatherArgs(ctypes.Structure):
    """Mirror of ``struct GatherArgs`` in csrc/consolidation.cu."""
    _fields_ = ([(f, _vp) for f in (
        "avail_zc", "R", "F", "agz", "agc", "admit", "daemon", "ex_compat",
        "ex_alloc", "ex_used0", "gid", "dead", "keep", "o_avail_zc", "o_R",
        "o_F", "o_agz", "o_agc", "o_admit", "o_daemon", "o_ex_compat",
        "o_ex_alloc", "o_ex_used0")]
        + [(f, _ll) for f in ("B", "Gq", "T", "ZC", "D", "Z", "C", "P",
                              "E")])


class _SummaryArgs(ctypes.Structure):
    """Mirror of ``struct SummaryArgs`` in csrc/ffd_common.cuh."""
    _fields_ = [(f, _vp) for f in ("keep", "tprice", "removed_price",
                                   "out")]


def _ptr(t):
    return t.data_ptr() if t is not None and t.numel() else None


def absorb_chunk(E: int) -> int:
    """The rows a thread of the absorption scan owns: ceil(E / the lane's
    threads)."""
    return -(-E // ABSORB_THREADS)


def absorb_form(E: int, D: int) -> int:
    """Where the scan's threads keep their rows: in registers (0) at up to
    ABSORB_REG_ROWS rows of ABSORB_REG_DIMS dims, in shared memory (1)
    while a lane's rows fit ABSORB_SMEM_MAX, else in a global scratch (2);
    csrc/consolidation.cu takes what it is given and refuses a form the
    shapes do not fit."""
    if absorb_chunk(E) <= ABSORB_REG_ROWS and D <= ABSORB_REG_DIMS:
        return 0
    return 1 if 8 * absorb_row_words(E, D) <= ABSORB_SMEM_MAX else 2


def absorb_row_words(E: int, D: int) -> int:
    """Words of one lane's rows in forms 1 and 2: each thread's chunk of
    rows, D slack words and k a row (``absorb_row_words``)."""
    return absorb_chunk(E) * (D + 1) * ABSORB_THREADS


def _absorb_launch(name: str, mode: int, args: _AbsorbArgs, B: int, E: int,
                   D: int, at) -> None:
    """One launch of the scan, its form set in ``args`` (a global scratch
    for form 2). Nothing at B = 0."""
    if B == 0:
        return
    form = absorb_form(E, D)
    scratch = None if form != 2 else torch.empty(
        (B, absorb_row_words(E, D)), dtype=torch.int64, device=at.device)
    args.form, args.scratch = form, _ptr(scratch)
    _launch(name, _lib().karp_consol_absorb, (ctypes.byref(args), mode), at)


def consol_absorb(mode: str, *, ex_alloc, ex_used0, compat, R, n, gid=None,
                  cid=None, alive=None, type_alloc=None, type_price=None,
                  tcompat=None, padmit=None, pool_types=None,
                  price_cap=None) -> torch.Tensor:
    """[B] bool. Shared modes: ex_alloc/ex_used0 [E, D], compat [Sc, E],
    R [S, D], gid/cid [B, G] int32, n [B, G], alive [B, E]; "prescreen"
    adds type_alloc [T, D], type_price [T], tcompat [Sc, T], padmit
    [P, Sc], pool_types [P, T], price_cap [B]. "dense": ex_alloc/ex_used0
    [B, E, D], compat [B, G, E], R [B, G, D], n [B, G]."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {tuple(_MODES)}")
    i64, b = torch.int64, torch.bool
    B, G = n.shape
    _need(n, "n", i64, (B, G))
    T = P = Sc = 0
    if mode == "dense":
        _, E, D = ex_alloc.shape
        _need(ex_alloc, "ex_alloc", i64, (B, E, D))
        _need(ex_used0, "ex_used0", i64, (B, E, D))
        _need(compat, "ex_compat", b, (B, G, E))
        _need(R, "R", i64, (B, G, D))
    else:
        E, D = ex_alloc.shape
        Sc = compat.shape[0]
        _need(ex_alloc, "ex_alloc", i64, (E, D))
        _need(ex_used0, "ex_used0", i64, (E, D))
        _need(compat, "compat_tab", b, (Sc, E))
        _need(R, "R_tab", i64, (R.shape[0], D))
        _need(gid, "gid", torch.int32, (B, G))
        _need(cid, "cid", torch.int32, (B, G))
        _need(alive, "alive", b, (B, E))
    if mode == "prescreen":
        T, P = type_alloc.shape[0], padmit.shape[0]
        _need(type_alloc, "type_alloc", i64, (T, D))
        _need(type_price, "type_price", i64, (T,))
        _need(tcompat, "tcompat", b, (Sc, T))
        _need(padmit, "padmit", b, (P, Sc))
        _need(pool_types, "pool_types", b, (P, T))
        _need(price_cap, "price_cap", i64, (B,))
    dev = n.device
    leftover = torch.empty((B, G), dtype=i64, device=dev)
    out = torch.empty(B, dtype=b, device=dev)
    args = _AbsorbArgs(
        ex_alloc=_ptr(ex_alloc), ex_used0=_ptr(ex_used0), compat=_ptr(compat),
        R=_ptr(R), gid=_ptr(gid), cid=_ptr(cid), n=_ptr(n),
        alive=_ptr(alive), type_alloc=_ptr(type_alloc),
        type_price=_ptr(type_price), tcompat=_ptr(tcompat),
        padmit=_ptr(padmit), pool_types=_ptr(pool_types),
        price_cap=_ptr(price_cap), leftover=_ptr(leftover), out=_ptr(out),
        B=B, G=G, E=E, D=D, Sc=Sc, T=T, P=P)
    _absorb_launch(f"consol_absorb_{mode}", _MODES[mode], args, B, E, D, n)
    return out


def preempt_absorb(ex_alloc, ex_used0, ex_compat, R, n, freed
                   ) -> torch.Tensor:
    """K8: [B] int64, each lane's leftover demand pods after the greedy
    fill of the G demand groups onto the E existing nodes, the lane's
    refund ``freed[b]`` taken off the usage first. ex_alloc/ex_used0
    [E, D], ex_compat [G, E] bool, R [G, D], n [G], freed [B, E, D]; one
    launch (a CTA a lane), none at B = 0."""
    i64 = torch.int64
    B, E, D = freed.shape
    G = R.shape[0]
    _need(freed, "freed", i64, (B, E, D))
    _need(ex_alloc, "ex_alloc", i64, (E, D))
    _need(ex_used0, "ex_used0", i64, (E, D))
    _need(ex_compat, "ex_compat", torch.bool, (G, E))
    _need(R, "R", i64, (G, D))
    _need(n, "n", i64, (G,))
    total = torch.empty(B, dtype=i64, device=freed.device)
    args = _AbsorbArgs(
        ex_alloc=_ptr(ex_alloc), ex_used0=_ptr(ex_used0),
        compat=_ptr(ex_compat), R=_ptr(R), n=_ptr(n), freed=_ptr(freed),
        total=_ptr(total), B=B, G=G, E=E, D=D)
    _absorb_launch("consol_absorb_preempt", _MODE_PREEMPT, args, B, E, D,
                   freed)
    return total


#: the gather's grid rule (csrc/consolidation.cu karp_subset_gather_grid):
#: the waves of resident CTAs it aims at, the least bytes a CTA writes
GATHER_WAVES = 4
GATHER_CTA_BYTES = 16 * 1024


def gather_lane_bytes(T: int, ZC: int, D: int, Z: int, C: int, P: int,
                      E: int, Gq: int) -> int:
    """The bytes ``subset_gather`` writes for one lane."""
    return (T * ZC + 16 * E * D
            + Gq * (8 * D + T + Z + C + P + 8 * P * D + E))


def gather_ctas(B: int, lane_bytes: int, slots: int) -> int:
    """The gather's CTAs a lane: ceil(GATHER_WAVES · slots / B) (``slots``:
    the card's resident CTAs of the kernel), at most the lane's bytes over
    GATHER_CTA_BYTES, at least 1; the C entry's rule."""
    x = -(-GATHER_WAVES * slots // max(B, 1))
    return max(1, min(x, lane_bytes // GATHER_CTA_BYTES))


def subset_gather_grid(args) -> tuple:
    """(X, slots) of the C entry for a ``_GatherArgs`` on the current
    device: the CTAs a lane the launch takes, and the card's resident
    CTAs of the kernel."""
    X, slots = ctypes.c_longlong(), ctypes.c_longlong()
    ffd_cuda._check(_lib().karp_subset_gather_grid(
        ctypes.byref(args), ctypes.byref(X), ctypes.byref(slots)),
        "subset_gather (grid)")
    return X.value, slots.value


def subset_gather(arena: KernelInputs, gid, n, dead, keep) -> KernelInputs:
    """Every lane's KernelInputs from the union ``arena``, lane-major: the
    fields of ``consolidation_torch.LANE_FIELDS`` gain a leading lane
    axis (``n`` is the lanes' own), the rest are the arena's."""
    _need(n, "n", torch.int64, tuple(gid.shape))
    args, o = gather_args(arena, gid, dead, keep)
    _launch("subset_gather", _lib().karp_subset_gather,
            (ctypes.byref(args),), gid)
    return arena._replace(n=n, **o)


def gather_args(arena: KernelInputs, gid, dead, keep):
    """The gather's checked arguments and its fresh outputs: (``_GatherArgs``,
    {field: [B, ...] tensor})."""
    i64, b = torch.int64, torch.bool
    T, D = arena.A.shape
    Gu, E = arena.ex_compat.shape
    Z, C, P = arena.agz.shape[1], arena.agc.shape[1], arena.admit.shape[1]
    B, Gq = gid.shape
    for nm, dt, shp in (
            ("A", i64, (T, D)), ("avail_zc", b, (T, Z * C)),
            ("R", i64, (Gu, D)), ("F", b, (Gu, T)), ("agz", b, (Gu, Z)),
            ("agc", b, (Gu, C)), ("admit", b, (Gu, P)),
            ("daemon", i64, (Gu, P, D)), ("ex_compat", b, (Gu, E)),
            ("ex_alloc", i64, (E, D)), ("ex_used0", i64, (E, D))):
        _need(getattr(arena, nm), nm, dt, shp)
    _need(gid, "gid", torch.int32, (B, Gq))
    _need(dead, "dead", b, (B, E))
    _need(keep, "keep", b, (B, T))
    dev = gid.device
    o = dict(avail_zc=torch.empty((B, T, Z * C), dtype=b, device=dev),
             R=torch.empty((B, Gq, D), dtype=i64, device=dev),
             F=torch.empty((B, Gq, T), dtype=b, device=dev),
             agz=torch.empty((B, Gq, Z), dtype=b, device=dev),
             agc=torch.empty((B, Gq, C), dtype=b, device=dev),
             admit=torch.empty((B, Gq, P), dtype=b, device=dev),
             daemon=torch.empty((B, Gq, P, D), dtype=i64, device=dev),
             ex_compat=torch.empty((B, Gq, E), dtype=b, device=dev),
             ex_alloc=torch.empty((B, E, D), dtype=i64, device=dev),
             ex_used0=torch.empty((B, E, D), dtype=i64, device=dev))
    args = _GatherArgs(
        **{f: _ptr(getattr(arena, f)) for f in (
            "avail_zc", "R", "F", "agz", "agc", "admit", "daemon",
            "ex_compat", "ex_alloc", "ex_used0")},
        gid=_ptr(gid), dead=_ptr(dead), keep=_ptr(keep),
        **{"o_" + f: _ptr(t) for f, t in o.items()},
        B=B, Gq=Gq, T=T, ZC=Z * C, D=D, Z=Z, C=C, P=P, E=E)
    return args, o


def summary_args(st: ScanState, keep, tprice, removed_price):
    """The summary rows' checked arguments over a lane-axis scan ``st``
    (each lane's leftover, num_nodes and types [N, T], its first new slot
    at ``st.args.E``), keep [B, T], tprice [T] and removed_price [B]:
    (``_SummaryArgs``, the fresh [B, 5] int64 rows that
    ``ffd_cuda.ffd_group_commit(st, last group, summary=...)`` writes)."""
    if st.lanes is None:
        raise ValueError("the summary rows take a scan on the lane axis")
    B, T = st.lanes, st.args.T
    if not 0 <= st.args.E < st.args.N:
        raise ValueError(f"first new slot {st.args.E} outside "
                         f"[0, {st.args.N})")
    _need(keep, "keep", torch.bool, (B, T))
    _need(tprice, "tprice", torch.int64, (T,))
    _need(removed_price, "removed_price", torch.int64, (B,))
    for t in (keep, tprice, removed_price):
        if t.device != st.k.device:
            raise ValueError(f"the summary's inputs lie on {t.device}, "
                             f"the scan on {st.k.device}")
    out = torch.empty((B, 5), dtype=torch.int64, device=st.k.device)
    return _SummaryArgs(keep=_ptr(keep), tprice=_ptr(tprice),
                        removed_price=_ptr(removed_price),
                        out=_ptr(out)), out


def subset_solve_cuda(arena: KernelInputs, tprice, gid, n, dead, keep,
                      removed_price, *, n_max: int, E: int,
                      P: int) -> torch.Tensor:
    """The whole-fleet subset round on the card: one subset_gather, the
    two K2 kernels per group on the lane axis (2·Gq launches for every
    lane at once), the last commit also writing the [B, 5] rows
    (``summary_args``); no synchronisation. With no lane or no group
    nothing launches and the rows are the reference's for an empty scan."""
    if arena.mv_floor is not None:
        raise ValueError("subset lanes take no minValues floors")
    if arena.ex_compat.shape[1] != E:
        raise ValueError(f"arena has {arena.ex_compat.shape[1]} existing "
                         f"rows, E={E}")
    B, Gq = gid.shape
    if B == 0 or Gq == 0:
        # no group to fill: each lane's row is the reference's start,
        # [0, 0, 0, 0, removed_price], with no launch
        _need(removed_price, "removed_price", torch.int64, (B,))
        out = torch.zeros((B, 5), dtype=torch.int64, device=gid.device)
        out[:, 4] = removed_price
        return out
    with ffd_cuda.on_device(ffd_cuda._device(gid)):
        lanes = subset_gather(arena, gid, n, dead, keep)
        carry = carry0(lanes, E + n_max, E, lanes=B)
        st = ScanState(lanes, carry, E=E, P=P, lanes=B)
        args, out = summary_args(st, keep, tprice, removed_price)
        with ffd_cuda.launching(gid) as stream:
            for g in range(Gq):
                ffd_cuda.ffd_slot_headroom(st, g, stream)
                ffd_cuda.ffd_group_commit(
                    st, g, stream, summary=args if g == Gq - 1 else None)
        return out
