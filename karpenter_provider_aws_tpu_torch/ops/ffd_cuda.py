"""The CUDA kernels of the packed FFD scan: build, binding and wrappers.

``csrc/packed_io.cu`` (K1: ``unpack_bits``, ``pack_outputs``; the
suffix re-solve's unpack also loads K3's resume row, its pack also
re-stamps K3's pad rows),
``csrc/ffd_scan.cu`` (K2: ``ffd_slot_headroom``, ``ffd_group_commit``;
the headroom also stores K3's chunk-entry bank rows, the commit also
records K9's plain groups and writes K7d's summary rows),
``csrc/fused.cu`` (K5: ``ffd_fused_headroom``, ``ffd_fused_commit``),
``csrc/consolidation.cu`` (K7: ``consol_absorb``, ``subset_gather``;
wrappers in ``ops/consolidation_cuda.py``) and
``csrc/pruned.cu`` (K6: ``ffd_pruned_probe``, ``ffd_pruned_commit``) and
``csrc/topo.cu`` (K9: ``topo_pool_statics``, ``topo_group_start``,
``topo_pour``; wrappers in ``ops/topo_cuda.py``) and
``csrc/mesh.cu`` (K10: ``mesh_new_caps``, ``mesh_slot_headroom``,
``mesh_fill``, ``mesh_commit``; wrappers in ``ops/mesh_cuda.py``) are
compiled with ``nvcc`` for ``sm_90a`` into one shared library with a
plain C interface, loaded with ctypes. The build runs at first use, into
``_build/`` inside this package, keyed by a hash of the sources; a failed
build raises with nvcc's output.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the device its
tensors live on, on that device's current stream (``_launch``), adds one
to its entry of ``LAUNCHES`` and raises when the C entry returns a CUDA
error. A loop of launches (a scan) enters the device's guard once
(``launching``) and hands its stream to each launch; a wrapper called on
its own enters the guard only when its device is not the current one.
Nothing here falls back to the plain versions in ``ops/ffd_torch.py``.

Importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import torch

from .ffd_torch import (CARRY_DTYPES, Carry, CarryP, KernelInputs,
                        _unpack_inputs, _unpack_inputs_lanes,
                        carry0, carry0_pruned)
from .hostpack import in_layout_bool, in_layout_i64, layout_sizes, nwords

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("packed_io.cu", "ffd_scan.cu", "consolidation.cu", "pruned.cu",
           "topo.cu", "fused.cu", "mesh.cu")
HEADERS = ("ffd_common.cuh", "ffd_step.cuh", "ffd_cluster.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: kernel name -> launches since the last reset (a plain counter per
#: wrapper, bumped where the kernel is launched and nowhere else)
LAUNCHES: Dict[str, int] = {"unpack_bits": 0, "ffd_slot_headroom": 0,
                            "ffd_group_commit": 0, "pack_outputs": 0,
                            "consol_absorb_deletions": 0,
                            "consol_absorb_prescreen": 0,
                            "consol_absorb_dense": 0,
                            "consol_absorb_preempt": 0, "subset_gather": 0,
                            "ffd_pruned_probe": 0,
                            "ffd_pruned_commit": 0, "topo_pool_statics": 0,
                            "topo_group_start": 0,
                            "topo_pour": 0,
                            "ffd_fused_headroom": 0, "ffd_fused_commit": 0,
                            "mesh_new_caps": 0, "mesh_slot_headroom": 0,
                            "mesh_fill": 0, "mesh_commit": 0}

_LIB = None
_BUILD_INFO: dict = {}
_MU = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _run(cmd) -> str:
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{p.stdout}\n{p.stderr}")
    return p.stdout + p.stderr


def build() -> dict:
    """Compile the kernels (one nvcc per source, all started together,
    then one link) unless a library of the same source hash exists.
    Returns {path, seconds, cached, ptxas}: ``ptxas`` holds the
    ``-Xptxas -v`` register and shared-memory report of a fresh build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"libkarp_ffd_{_source_hash()}.so")
    if os.path.exists(lib):
        return dict(path=lib, seconds=0.0, cached=True, ptxas="")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 os.path.join(CSRC, s), "-o", o]
                for s, o in zip(SOURCES, objs)]
        with ThreadPoolExecutor(len(cmds)) as ex:
            logs = list(ex.map(_run, cmds))
        out = os.path.join(tmp, "lib.so")
        _run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", out])
        os.replace(out, lib)
    return dict(path=lib, seconds=time.perf_counter() - t0, cached=False,
                ptxas="".join(logs))


def _lib():
    global _LIB, _BUILD_INFO
    with _MU:
        if _LIB is None:
            _BUILD_INFO = build()
            lib = ctypes.CDLL(_BUILD_INFO["path"])
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            lib.karp_unpack_bits.argtypes = [vp, ll, vp, ll, ll, vp]
            lib.karp_unpack_bits_load.argtypes = [vp, ll, vp, vp, ll, vp]
            lib.karp_pack_outputs.argtypes = [vp, vp, ll, ll, vp]
            lib.karp_ffd_slot_headroom.argtypes = [vp, ll, vp, ll, vp]
            lib.karp_ffd_group_commit.argtypes = [vp, ll, vp, vp, vp]
            lib.karp_ffd_k2_cluster.argtypes = [vp]
            lib.karp_consol_absorb.argtypes = [vp, ctypes.c_int, vp]
            lib.karp_subset_gather.argtypes = [vp, vp]
            lib.karp_subset_gather_grid.argtypes = [vp, vp, vp]
            for fn in (lib.karp_ffd_pruned_probe,
                       lib.karp_ffd_pruned_commit):
                fn.argtypes = [vp, ll, vp]
            lib.karp_ffd_pruned_cluster.argtypes = [vp]
            for fn in (lib.karp_topo_group_start, lib.karp_topo_pour):
                fn.argtypes = [vp, vp, ll, vp]
            lib.karp_topo_pour_smem.argtypes = [vp, vp, vp, vp]
            lib.karp_topo_pool_statics.argtypes = [vp, vp, ll, ll, vp]
            for fn in (lib.karp_ffd_fused_headroom,
                       lib.karp_ffd_fused_commit):
                fn.argtypes = [vp, ll, vp]
            lib.karp_ffd_fused_cluster.argtypes = [vp]
            lib.karp_ffd_fused_headroom_blocks.argtypes = [ll, ll, ll, ll]
            lib.karp_mesh_fill_threads.argtypes = [ll]
            lib.karp_mesh_fill_rows.argtypes = [ll]
            lib.karp_mesh_new_caps.argtypes = [vp, vp]
            lib.karp_mesh_caps_cluster.argtypes = [ll, ll]
            lib.karp_mesh_caps_cluster.restype = ll
            for fn in (lib.karp_mesh_slot_headroom, lib.karp_mesh_commit):
                fn.argtypes = [vp, ll, vp]
            lib.karp_mesh_fill.argtypes = [vp, ll, ctypes.c_int, vp]
            lib.karp_error_string.argtypes = [ctypes.c_int]
            lib.karp_error_string.restype = ctypes.c_char_p
            for fn in (lib.karp_unpack_bits, lib.karp_unpack_bits_load,
                       lib.karp_pack_outputs,
                       lib.karp_ffd_slot_headroom,
                       lib.karp_ffd_group_commit, lib.karp_ffd_k2_cluster,
                       lib.karp_consol_absorb, lib.karp_subset_gather,
                       lib.karp_subset_gather_grid, lib.karp_ffd_pruned_probe,
                       lib.karp_ffd_pruned_commit,
                       lib.karp_ffd_pruned_cluster, lib.karp_topo_group_start,
                       lib.karp_topo_pour,
                       lib.karp_topo_pour_smem, lib.karp_topo_pool_statics,
                       lib.karp_ffd_fused_headroom,
                       lib.karp_ffd_fused_commit, lib.karp_ffd_fused_cluster,
                       lib.karp_mesh_new_caps,
                       lib.karp_mesh_slot_headroom, lib.karp_mesh_fill,
                       lib.karp_mesh_commit,
                       lib.karp_ffd_fused_headroom_blocks,
                       lib.karp_mesh_fill_threads,
                       lib.karp_mesh_fill_rows):
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def build_info() -> dict:
    """What the build that loaded the library reported."""
    _lib()
    return dict(_BUILD_INFO)


def _check(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().karp_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({msg})")


def _device(t: torch.Tensor) -> torch.device:
    """The device of a launch: that of the tensors it reads and writes."""
    return t.device


def on_device(dev: torch.device):
    """A guard that makes ``dev`` the current CUDA device, or a null
    context when it already is (the kernel library launches on the
    current device)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _stream(dev: torch.device) -> int:
    """The current stream of ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream


@contextlib.contextmanager
def launching(at: torch.Tensor):
    """The guard of a loop of launches on the device of ``at``: entered
    once, it yields that device's current stream for the loop to hand to
    each launch (``stream=``)."""
    dev = _device(at)
    with on_device(dev):
        yield _stream(dev)


def _launch(name: str, fn, args: tuple, at, stream=None) -> None:
    """``fn(*args, stream)``, one kernel launch, counted in ``LAUNCHES``
    and checked. Inside a loop's guard the caller passes the ``stream``
    that ``launching`` gave it; a wrapper called on its own passes None
    and launches on the device of tensor ``at``, under its guard."""
    if stream is None:
        with launching(at) as stream:
            err = fn(*args, stream)
    else:
        err = fn(*args, stream)
    LAUNCHES[name] += 1
    _check(err, name)


def _need(t: torch.Tensor, name: str, dtype, shape=None,
          lanes: bool = False) -> None:
    """A CUDA tensor of ``dtype`` and ``shape``, contiguous; with
    ``lanes`` a [L, ...] field contiguous only within each lane, the
    lanes ``t.stride(0)`` elements apart (a view of a [L, W] stack)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not (t[0] if lanes and t.shape[0] else t).is_contiguous():
        raise ValueError(f"{name} must be contiguous"
                         + (" within each lane" if lanes else ""))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


# ---------------------------------------------------------------------------
# K1 wrappers
# ---------------------------------------------------------------------------

def unpack_bits(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """int64 words -> bool [nbits], little-endian (kernel): the one-lane
    launch of ``unpack_bits_lanes``."""
    _need(words, "words", torch.int64, (nwords(nbits),))
    return unpack_bits_lanes(words[None], nbits)[0]


def unpack_bits_lanes(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """[L, nwords] int64 words (lanes ``words.stride(0)`` apart, e.g. the
    bool sections of a [L, W] arena stack) -> bool [L, nbits], one launch
    whatever L is (kernel)."""
    L = words.shape[0]
    _need(words, "words", torch.int64, (L, nwords(nbits)), lanes=True)
    out = torch.empty((L, nbits), dtype=torch.bool, device=words.device)
    _launch("unpack_bits", _lib().karp_unpack_bits,
            (words.data_ptr(), nbits, out.data_ptr(), L, words.stride(0)),
            words)
    return out


def unpack_bits_load(words: torch.Tensor, nbits: int, bs: "BankState",
                     j: int, stream: int = None) -> torch.Tensor:
    """``unpack_bits`` of one lane and bank row j of ``bs`` into its
    working carry, in one launch (the suffix re-solve's prologue, counted
    as ``unpack_bits``); returns the bool plane. ``stream``: the stream
    of the caller's ``launching`` guard."""
    _need(words, "words", torch.int64, (nwords(nbits),))
    if not 0 <= j < bs.rows:
        raise ValueError(f"bank row {j} outside [0, {bs.rows})")
    if bs.carry.used.device != words.device:
        raise ValueError(f"the bank lies on {bs.carry.used.device}, the "
                         f"words on {words.device}")
    out = torch.empty(nbits, dtype=torch.bool, device=words.device)
    _launch("unpack_bits", _lib().karp_unpack_bits_load,
            (words.data_ptr(), nbits, out.data_ptr(), ctypes.byref(bs.args),
             j), words, stream)
    return out


def pack_outputs(takes: torch.Tensor, leftover: torch.Tensor,
                 carry: Carry, store: tuple = None,
                 stream: int = None) -> torch.Tensor:
    """The output buffer [i64 section | int32-pair takes | bit words]:
    the one-lane launch of ``pack_outputs_lanes``. With ``store`` = (a
    ``BankState`` over ``carry``, j, count) the same launch copies the
    carry into bank rows [j, j + count) (the suffix's pad re-stamp);
    ``stream``: the stream of the caller's ``launching`` guard."""
    return pack_outputs_lanes(takes[None], leftover[None],
                              Carry(*[f[None] for f in carry[:8]]),
                              store=store, stream=stream)[0]


#: the i64 section's fields, in the output buffer's order
PACK_FIELDS = ("leftover", "used", "pool", "num_nodes", "pool_used")
#: ``pack_outputs``' bit words a warp and warps a CTA (csrc/packed_io.cu
#: kBitWords, kPackWarps)
PACK_BIT_WORDS = 16
PACK_WARPS = 8


class _PackArgs(ctypes.Structure):
    """Mirror of ``struct PackArgs`` in csrc/packed_io.cu."""
    _fields_ = [("f_ptr", ctypes.c_void_p * 5),
                ("f_len", ctypes.c_longlong * 5),
                ("f_stride", ctypes.c_longlong * 5),
                ("f_i32", ctypes.c_longlong),
                ("takes", ctypes.c_void_p), ("n32", ctypes.c_longlong),
                ("takes_stride", ctypes.c_longlong),
                ("seg_ptr", ctypes.c_void_p * 4),
                ("seg_len", ctypes.c_longlong * 4),
                ("seg_stride", ctypes.c_longlong * 4),
                ("bail", ctypes.c_void_p), ("bail_stride", ctypes.c_longlong),
                ("out", ctypes.c_void_p), ("out_stride", ctypes.c_longlong),
                ("L", ctypes.c_longlong)]


def _lane_source(t: torch.Tensor, name: str, dtypes) -> tuple:
    """(t, elements a lane, lane stride) of a [L, ...] field whose lanes
    are each contiguous, of one of ``dtypes``."""
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    L = t.shape[0]
    if L and not t[0].is_contiguous():
        raise ValueError(f"{name} must be contiguous within each lane")
    n = 1
    for s in t.shape[1:]:
        n *= s
    return t, n, t.stride(0) if L > 1 else n


def pack_sources(takes: torch.Tensor, leftover: torch.Tensor, carry,
                 bail=None) -> dict:
    """What ``pack_outputs_lanes``' one launch reads, as the kernel reads
    it (any device): ``fields`` [(tensor, elements a lane, lane stride,
    int32?)] of the i64 section in ``PACK_FIELDS`` order, ``takes``
    (tensor, n32, lane stride), ``segs`` [(tensor, bools a lane, lane
    stride)] of types, zones, ct, alive, ``bail`` (tensor, lane stride) or
    None, and the row: ``n64`` words, ``w32`` takes words, ``nbits``
    bools in ``nwb`` words, ``W`` words in all (the bail word last)."""
    L = takes.shape[0]
    vals = dict(leftover=leftover, used=carry.used, pool=carry.pool,
                num_nodes=carry.num_nodes, pool_used=carry.pool_used)
    fields = []
    for nm in PACK_FIELDS:
        t, n, s = _lane_source(vals[nm], nm, (torch.int32, torch.int64))
        fields.append((t, n, s, t.dtype == torch.int32))
    tk = _lane_source(takes, "takes", (torch.int32,))
    segs = [_lane_source(s, f"bool segment {i}", (torch.bool,))
            for i, s in enumerate((carry.types, carry.zones, carry.ct,
                                   carry.alive))]
    bl = None
    if bail is not None:
        b = _lane_source(bail, "bail", (torch.bool,))
        if b[1] != 1:
            raise ValueError(f"bail must hold one bool a lane, got {b[1]}")
        bl = b[0], b[2]
    for t, *_ in fields + [tk] + segs + ([bl] if bl else []):
        if t.shape[0] != L:
            raise ValueError(f"every field needs {L} lanes, got "
                             f"{tuple(t.shape)}")
    n64 = sum(f[1] for f in fields)
    nbits = sum(s[1] for s in segs)
    w32 = (tk[1] + 1) // 2
    nwb = nwords(nbits)
    return dict(fields=fields, takes=tk, segs=segs, bail=bl, L=L, n64=n64,
                w32=w32, nbits=nbits, nwb=nwb,
                W=n64 + w32 + nwb + (bl is not None))


def pack_outputs_lanes(takes: torch.Tensor, leftover: torch.Tensor,
                       carry, bail: torch.Tensor = None, store: tuple = None,
                       stream: int = None) -> torch.Tensor:
    """[L, W]: row l the output buffer [i64 section | int32-pair takes |
    bit words] of lane l (takes [L, G, N] int32, leftover [L, G], carry
    fields [L, ...], each lane contiguous; int32 or int64 integers),
    with ``bail`` [L, 1] bool one trailing word a lane (the pruned scan's
    bail), in one kernel launch whatever L is. With ``store`` = (bs, j,
    count), one lane only, the launch also copies the carry into bank
    rows [j, j + count) of the ``BankState`` bs, whose working carry it
    must be (``_store_range``)."""
    src = pack_sources(takes, leftover, carry, bail)
    bank, j, count = _store_range(store, carry) if store else (None, 0, 0)
    dev = takes.device
    every = [f[0] for f in src["fields"]] + [src["takes"][0]] \
        + [s[0] for s in src["segs"]] + ([bail] if bail is not None else [])
    for i, t in enumerate(every):
        _need(t, f"pack_outputs source {i}", t.dtype, lanes=True)
        if t.device != dev:
            raise ValueError(f"pack_outputs needs every tensor on one "
                             f"device, got {t.device} beside {dev}")
    L, W = src["L"], src["W"]
    out = torch.empty((L, W), dtype=torch.int64, device=dev)
    fl = src["fields"]
    tk, segs = src["takes"], src["segs"]
    bl = src["bail"]
    args = _PackArgs(
        f_ptr=(ctypes.c_void_p * 5)(*[f[0].data_ptr() for f in fl]),
        f_len=(ctypes.c_longlong * 5)(*[f[1] for f in fl]),
        f_stride=(ctypes.c_longlong * 5)(*[f[2] for f in fl]),
        f_i32=sum(1 << j for j, f in enumerate(fl) if f[3]),
        takes=tk[0].data_ptr(), n32=tk[1], takes_stride=tk[2],
        seg_ptr=(ctypes.c_void_p * 4)(*[s[0].data_ptr() for s in segs]),
        seg_len=(ctypes.c_longlong * 4)(*[s[1] for s in segs]),
        seg_stride=(ctypes.c_longlong * 4)(*[s[2] for s in segs]),
        bail=bl[0].data_ptr() if bl else None,
        bail_stride=bl[1] if bl else 0, out=out.data_ptr(), out_stride=W,
        L=L)
    _launch("pack_outputs", _lib().karp_pack_outputs,
            (ctypes.byref(args), bank, j, count), takes, stream)
    return out


def _store_range(store: tuple, carry) -> tuple:
    """The checked re-stamp of a pack (``store`` = (BankState, j,
    count)) over the pack's [1, ...] ``carry``: (argument block, j,
    count)."""
    bs, j, count = store
    if carry.used.shape[0] != 1:
        raise ValueError("a bank store range takes a pack of one lane")
    if not (0 <= j and count >= 1 and j + count <= bs.rows):
        raise ValueError(f"bank rows [{j}, {j + count}) outside "
                         f"[0, {bs.rows})")
    if [c.data_ptr() for c in bs.carry] != \
            [c.data_ptr() for c in carry[:8]]:
        raise ValueError("the bank's working carry is not the pack's")
    return ctypes.byref(bs.args), j, count


# ---------------------------------------------------------------------------
# K2 wrappers
# ---------------------------------------------------------------------------

def table_blocks(T: int) -> int:
    """The new-node table's blocks per (group, pool): one per 256 types
    (csrc/ffd_step.cuh table_blocks), each with its partial cap."""
    return -(-T // 256)


_PTR_FIELDS = ("A", "avail_zc", "R", "n", "F", "agz", "agc", "admit",
               "daemon", "pool_types", "pool_agz", "pool_agc", "pool_limit",
               "ex_alloc", "ex_compat", "mv_floor", "mv_pairs_t",
               "mv_pairs_v", "used", "types", "zones", "ct", "pool",
               "alive", "num_nodes", "pool_used", "cand", "k", "hrn",
               "candn", "takes", "leftover")
_STATIC_FIELDS = ("T", "D", "Z", "C", "G", "E", "P", "N", "K", "M", "V",
                  "G0")


class _FfdArgs(ctypes.Structure):
    """Mirror of ``struct FfdArgs`` in csrc/ffd_common.cuh (8-byte
    fields throughout, so the layouts agree without padding rules)."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [(f, ctypes.c_longlong) for f in _STATIC_FIELDS]
                + [("L", ctypes.c_longlong),
                   ("lane_bytes", ctypes.c_longlong * len(_PTR_FIELDS))])


class ScanState:
    """Device buffers of one scan over the group window [s0, s1) (default
    every group): the inputs, the carry (updated in place by the
    kernels; the window's entry carry), the per-group scratch and the
    outputs, whose rows are those of the window, plus the ctypes
    argument block that points at them.

    ``lanes=L`` runs L independent scans of one shape in the same
    launches (the lane axis of csrc/ffd_common.cuh): an input field of
    shape ``(L,) + shape`` is per lane, one of ``shape`` is shared by
    every lane; the carry is per lane, and so are the scratch and the
    outputs (``takes`` [L, rows, N], ``leftover`` [L, rows]). Without
    ``lanes`` every shape is that of one solve. A per-lane input field
    may be a view of a [L, W] arena stack: each lane contiguous, the
    lanes ``stride(0)`` elements apart (the stride, not the field's own
    size, is the lane stride the kernels get).

    ``cand_rows`` sizes the candidate scratch ``cand`` (default N rows;
    the pruned scan keeps S selected rows there). ``Fu`` keeps that many
    groups' scratch side by side (the fused scan): ``cand`` [Fu*N, T]
    and ``k`` [Fu*N], group i's rows at i*N. ``candn`` / ``hrn`` hold the
    new-node table [table_rows, T] (default P rows: the group's table,
    which ``ffd_slot_headroom`` writes at K == 0 and ``table()`` reads;
    the fused scan: Fu*P, group i's pools at i*P) and ``capn`` its
    partial caps [table_rows, table_blocks(T)]; each lane has its own.

    ``cluster`` and ``threads`` are ``ffd_group_commit``'s CTAs a lane
    (1, 2, 4, 8) and threads a CTA (256, 512); by default the fixed rule
    of ``csrc/ffd_scan.cu`` (``k2_shape``) picks both from the lane count,
    the shapes and the card's occupancy when the commit first launches.
    With minValues floors the commit runs on one CTA a lane. ``rows``
    (1-16) is ``ffd_slot_headroom``'s slot rows a warp or ``warps`` (1,
    2, 4, 8) its warps a slot row, not both above 1 (default the kernel's
    rule on the lane and slot counts, ``k2_layout``)."""

    def __init__(self, inp: KernelInputs, carry: Carry, *, E: int, P: int,
                 V: int = 0, s0: int = 0, s1: int = None, lanes: int = None,
                 cand_rows: int = None, Fu: int = 1, table_rows: int = None,
                 cluster: int = None, threads: int = None, rows: int = None,
                 warps: int = None):
        dev = inp.A.device
        L = 1 if lanes is None else lanes
        lead = () if lanes is None else (L,)
        T, D = inp.A.shape[-2:]
        G = inp.R.shape[-2]
        s1 = G if s1 is None else s1
        if not 0 <= s0 <= s1 <= G:
            raise ValueError(f"group window [{s0}, {s1}) outside [0, {G})")
        if L < 1:
            raise ValueError(f"lanes={L} must be at least 1")
        self.s0, self.s1, self.lanes = s0, s1, lanes
        N = carry.used.shape[-2]
        Z, C = inp.agz.shape[-1], inp.agc.shape[-1]
        K = 0 if inp.mv_floor is None else inp.mv_floor.shape[-1]
        M = 0 if inp.mv_pairs_t is None else inp.mv_pairs_t.shape[-1]
        if T == 0:
            raise ValueError("the scan kernels need T > 0")
        if cluster not in (None, 1, 2, 4, 8):
            raise ValueError(f"cluster={cluster} is not 1, 2, 4 or 8")
        if threads not in (None, 256, 512):
            raise ValueError(f"threads={threads} is not 256 or 512")
        if K and cluster not in (None, 1):
            raise ValueError("with minValues floors the commit runs on one "
                             "CTA a lane")
        if rows is not None and not 1 <= rows <= 16:
            raise ValueError(f"rows={rows} must lie in [1, 16]")
        if warps not in (None, 1, 2, 4, 8):
            raise ValueError(f"warps={warps} is not 1, 2, 4 or 8")
        if (rows or 1) > 1 and (warps or 1) > 1:
            raise ValueError("a warp takes several rows or a row several "
                             "warps, not both")
        i64, b = torch.int64, torch.bool
        lane_bytes = {}

        def field(t, nm, dt, shp):
            # per lane when it carries the leading lane axis, else shared
            if lanes is not None and t.dim() == len(shp) + 1:
                _need(t, nm, dt, (L,) + tuple(shp), lanes=True)
                lane_bytes[nm] = t.stride(0) * t.element_size()
            else:
                _need(t, nm, dt, shp)

        for nm, dt, shp in (
                ("A", i64, (T, D)), ("avail_zc", b, (T, Z * C)),
                ("R", i64, (G, D)), ("n", i64, (G,)), ("F", b, (G, T)),
                ("agz", b, (G, Z)), ("agc", b, (G, C)),
                ("admit", b, (G, P)), ("daemon", i64, (G, P, D)),
                ("pool_types", b, (P, T)), ("pool_agz", b, (P, Z)),
                ("pool_agc", b, (P, C)), ("pool_limit", i64, (P, D)),
                ("ex_alloc", i64, (E, D)), ("ex_compat", b, (G, E))):
            field(getattr(inp, nm), nm, dt, shp)
        if K:
            field(inp.mv_floor, "mv_floor", i64, (P, K))
            field(inp.mv_pairs_t, "mv_pairs_t", i64, (K, M))
            field(inp.mv_pairs_v, "mv_pairs_v", i64, (K, M))
        for nm, dt, shp in (
                ("used", i64, (N, D)), ("types", b, (N, T)),
                ("zones", b, (N, Z)), ("ct", b, (N, C)),
                ("pool", torch.int32, (N,)), ("alive", b, (N,)),
                ("num_nodes", torch.int32, (1,)),
                ("pool_used", i64, (P, D))):
            t = getattr(carry, nm)
            _need(t, nm, dt, lead + shp)
            if lanes is not None:
                lane_bytes[nm] = t[0].numel() * t.element_size()
        self.inp, self.carry = inp, carry
        self.cand = torch.empty(lead + (Fu * (N if cand_rows is None else
                                              cand_rows), T),
                                dtype=b, device=dev)
        self.k = torch.empty(lead + (Fu * N,), dtype=i64, device=dev)
        trows = P if table_rows is None else table_rows
        self.hrn = torch.empty(lead + (trows, T), dtype=i64, device=dev)
        self.candn = torch.empty(lead + (trows, T), dtype=b, device=dev)
        self.capn = torch.empty(lead + (trows, table_blocks(T)), dtype=i64,
                                device=dev)
        self.takes = torch.empty(lead + (s1 - s0, N), dtype=torch.int32,
                                 device=dev)
        self.leftover = torch.empty(lead + (s1 - s0,), dtype=i64,
                                    device=dev)
        ptrs = {}
        for f in _PTR_FIELDS:
            t = getattr(inp, f, None) if f in KernelInputs._fields else \
                getattr(carry, f, None) if f in Carry._fields else \
                getattr(self, f)
            ptrs[f] = t.data_ptr() if t is not None and t.numel() else None
            if lanes is not None and f not in KernelInputs._fields \
                    and f not in Carry._fields:
                lane_bytes[f] = t[0].numel() * t.element_size()
        self.args = _FfdArgs(**ptrs, T=T, D=D, Z=Z, C=C, G=G, E=E, P=P, N=N,
                             K=K, M=M, V=V, G0=s0, L=L)
        for i, f in enumerate(_PTR_FIELDS):
            self.args.lane_bytes[i] = lane_bytes.get(f, 0)
        self.cluster, self.threads = cluster, threads
        self.rows, self.warps = rows, warps
        self._kargs = None

    @property
    def kargs(self) -> "_ScanArgs":
        """The K2 kernels' argument block (``struct ScanArgs``), built at
        the first launch: the commit's shape from the rule unless given."""
        if self._kargs is None:
            a = self.args
            if self.cluster is None or self.threads is None:
                cs, nt = k2_shape(a.L, a.K, a.V, a.P, a.D, a.N,
                                  _device(self.k))
                self.cluster = cs if self.cluster is None else self.cluster
                self.threads = nt if self.threads is None else self.threads
            self._kargs = _ScanArgs(
                f=a, capn=self.capn.data_ptr(),
                capn_lane_bytes=0 if self.lanes is None else
                self.capn[0].numel() * 8,
                cluster=self.cluster, threads=self.threads,
                rows=self.rows or 0, warps=self.warps or 0)
        return self._kargs

    def table(self):
        """The group's new-node table as ``ffd_slot_headroom`` wrote it
        (K == 0): (candn [(L,) P, T], hrn [(L,) P, T], cap [(L,) P], the
        max over the table blocks' partial caps, which the commit
        takes)."""
        return self.candn, self.hrn, self.capn.amax(-1)


class _ScanArgs(ctypes.Structure):
    """Mirror of ``struct ScanArgs`` in csrc/ffd_scan.cu."""
    _fields_ = [("f", _FfdArgs), ("capn", ctypes.c_void_p),
                ("capn_lane_bytes", ctypes.c_longlong),
                ("cluster", ctypes.c_longlong),
                ("threads", ctypes.c_longlong),
                ("rows", ctypes.c_longlong),
                ("warps", ctypes.c_longlong)]


_K2_SHAPES = {}


def k2_shape(L: int, K: int, V: int, P: int, D: int, N: int,
             device=None):
    """``ffd_group_commit``'s (CTAs a lane, threads a CTA) for L lanes of
    P pools, D resources and N slots, with K minValues floors over V
    values (K > 0: its shared memory holds them) or none: the first of
    (8, 512), (4, 512), (2, 512), (1, 512) whose L clusters the card
    holds at once and whose shared memory fits, else (1, 256); K > 0
    only CTAs of one (``karp_ffd_k2_cluster``, csrc/ffd_scan.cu). The
    card is asked once for each shape and each device (``device``: the
    state's; default the current one)."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    a = _ScanArgs()
    a.f.L, a.f.K, a.f.V, a.f.P, a.f.D, a.f.N = L, K, V, P, D, N
    code = _cluster_rule(_K2_SHAPES, (L, K, V, P, D, N),
                         _lib().karp_ffd_k2_cluster, a, dev,
                         "ffd_group_commit")
    return code % 16, 512 if code // 16 else 256


def _in_window(st: ScanState, g: int) -> None:
    if not st.s0 <= g < st.s1:
        raise ValueError(f"group {g} outside the scan window "
                         f"[{st.s0}, {st.s1})")


def ffd_slot_headroom(st: ScanState, g: int, stream: int = None,
                      bank: "BankState" = None, j: int = -1) -> None:
    """Steps 1-3 for group g: fills ``st.cand`` [N, T] and ``st.k`` [N]
    and, without minValues floors, the group's new-node table
    (``st.table()``). With ``bank`` (a ``BankState`` over ``st.carry``)
    and ``j >= 0`` the same launch copies the carry, which it reads and
    does not write, into bank row j: the store of a chunk entry (one
    lane only). ``stream``: the stream of the caller's ``launching``
    guard."""
    _in_window(st, g)
    ba = None
    if bank is not None and j >= 0:
        if st.lanes is not None:
            raise ValueError("a bank row takes a scan of one lane")
        if not 0 <= j < bank.rows:
            raise ValueError(f"bank row {j} outside [0, {bank.rows})")
        if bank.carry is not st.carry:
            raise ValueError("the bank's working carry is not the scan's")
        ba = ctypes.byref(bank.args)
    _launch("ffd_slot_headroom", _lib().karp_ffd_slot_headroom,
            (ctypes.byref(st.kargs), g, ba, j if ba else -1), st.k, stream)


class _RecordArgs(ctypes.Structure):
    """Mirror of ``struct RecordArgs`` in csrc/ffd_common.cuh: the
    topology scan's counters and membership rows, which
    ``ffd_group_commit`` updates with a plain group's takes."""
    _fields_ = [("cz", ctypes.c_void_p), ("ch", ctypes.c_void_p),
                ("zfix", ctypes.c_void_p), ("member_z", ctypes.c_void_p),
                ("member_h", ctypes.c_void_p)]


def ffd_group_commit(st: ScanState, g: int, stream: int = None,
                     record: _RecordArgs = None,
                     summary: ctypes.Structure = None) -> None:
    """Steps 4-7 for group g, its new nodes read from the table the
    headroom launch wrote (K == 0; with minValues floors the commit
    computes each pool's table and caps itself): updates the carry in
    place and writes ``st.takes[g - s0]`` and ``st.leftover[g - s0]``
    (``st.k`` becomes take), on ``st.cluster`` CTAs of ``st.threads`` a
    lane. With ``record`` (a topology scan's plain group, one lane) the
    same launch records the group's membership in the scan's counters
    (``topo_torch._topo_record_plain_ref`` of the int32 takes). With
    ``summary`` (``consolidation_cuda.summary_args``: a subset round's
    last group, no minValues floors, no record) it also writes each
    lane's summary row (``consolidation_torch._subset_summary_ref`` of
    the scan's leftover, num_nodes and types)."""
    _in_window(st, g)
    if record is not None and st.lanes is not None:
        raise ValueError("a membership record takes a scan of one lane")
    if summary is not None:
        if record is not None or st.args.K > 0:
            raise ValueError("a summary row takes a commit without "
                             "minValues floors or a record")
        if g != st.s1 - 1:
            raise ValueError(f"a summary row takes the window's last group "
                             f"{st.s1 - 1}, not {g}")
    _launch("ffd_group_commit", _lib().karp_ffd_group_commit,
            (ctypes.byref(st.kargs), g,
             None if record is None else ctypes.byref(record),
             None if summary is None else ctypes.byref(summary)), st.k,
            stream)


def k2_steps(st: ScanState, g0: int, g1: int) -> None:
    """Groups [g0, g1) of a K2 scan, two launches each, under one guard
    of the state's device; no synchronisation."""
    with launching(st.k) as stream:
        for g in range(g0, g1):
            ffd_slot_headroom(st, g, stream)
            ffd_group_commit(st, g, stream)


def solve_scan_cuda(inp: KernelInputs, n_max: int, E: int, P: int,
                    V: int = 0) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
    """The whole scan on the card: 2*G launches on the current stream,
    no synchronisation inside the loop."""
    st = ScanState(inp, carry0(inp, E + n_max, E), E=E, P=P, V=V)
    k2_steps(st, 0, inp.R.shape[0])
    return st.takes, st.leftover, st.carry


def _packed_inputs(buf: torch.Tensor, T, D, Z, C, G, E, P, K, M,
                   Q, F=1, load: tuple = None,
                   stream: int = None) -> KernelInputs:
    """The arena's inputs: one unpack_bits launch, then views (the
    ``fuse`` flags too when F > 1). With ``load`` = (BankState, j) the
    same launch copies bank row j into the bank's working carry
    (``unpack_bits_load``, on the ``stream`` of the caller's guard)."""
    _need(buf, "buf", torch.int64)
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, K, M, F, Q))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, K, M, F, Q))
    if buf.numel() != n_i64 + nwords(n_bits):
        raise ValueError(f"arena has {buf.numel()} words, the statics "
                         f"need {n_i64 + nwords(n_bits)}")
    bool_flat = unpack_bits(buf[n_i64:], n_bits) if load is None else \
        unpack_bits_load(buf[n_i64:], n_bits, *load, stream=stream)
    return _unpack_inputs(buf[:n_i64], bool_flat, T, D, Z, C, G, E, P, K, M,
                          F, Q)


def solve_scan_packed1_cuda(buf: torch.Tensor, *, T, D, Z, C, G, E, P,
                            n_max, K=0, V=0, M=0, Q=0) -> torch.Tensor:
    """The packed solve on the card: unpack_bits, the scan, pack_outputs."""
    inp = _packed_inputs(buf, T, D, Z, C, G, E, P, K, M, Q)
    takes, leftover, carry = solve_scan_cuda(inp, n_max, E, P, V)
    return pack_outputs(takes, leftover, carry)


# ---------------------------------------------------------------------------
# K3 wrappers: the checkpoint bank, and the checkpointed / suffix solves
# ---------------------------------------------------------------------------

class _BankArgs(ctypes.Structure):
    """Mirror of ``struct BankArgs`` in csrc/ffd_common.cuh."""
    _fields_ = [("carry", ctypes.c_void_p * 8),
                ("bank", ctypes.c_void_p * 8),
                ("row_bytes", ctypes.c_longlong * 8)]


def empty_bank(carry: Carry, rows: int) -> Carry:
    """An unwritten bank of ``rows`` carries shaped like ``carry``
    (num_nodes as [rows])."""
    return Carry(*[torch.empty((rows,) + (() if nm == "num_nodes"
                                          else tuple(c.shape)),
                               dtype=c.dtype, device=c.device)
                   for nm, c in zip(Carry._fields, carry)])


class BankState:
    """A working carry and a bank of its rows on the card, plus the
    ctypes argument block that points at their eight fields."""

    def __init__(self, carry: Carry, bank: Carry):
        rows = bank.used.shape[0]
        for nm, c, b in zip(Carry._fields, carry, bank):
            _need(c, f"carry.{nm}", CARRY_DTYPES[nm])
            _need(b, f"bank.{nm}", CARRY_DTYPES[nm],
                  (rows,) if nm == "num_nodes" else (rows,) + tuple(c.shape))
        if carry.num_nodes.numel() != 1:
            raise ValueError("carry.num_nodes must hold one value")
        self.carry, self.bank, self.rows = carry, bank, rows
        self.args = _BankArgs()
        for i, (c, b) in enumerate(zip(carry, bank)):
            self.args.carry[i] = c.data_ptr()
            self.args.bank[i] = b.data_ptr()
            self.args.row_bytes[i] = c.numel() * c.element_size()


def entry_row(g: int, s0: int, CK: int, j0: int, resumed: bool) -> int:
    """The bank row that group g's ``ffd_slot_headroom`` stores its entry
    carry into, in a scan of the window from s0 whose chunk entries s0,
    s0 + CK, ... take rows j0, j0 + 1, ...; -1 for no store. A resumed
    window (the suffix re-solve, loaded from row j0) stores nothing at
    s0: row j0 already holds that carry."""
    if (g - s0) % CK or (resumed and g == s0):
        return -1
    return j0 + (g - s0) // CK


def solve_scan_packed1_ckpt_cuda(buf: torch.Tensor, *, T, D, Z, C, G, E,
                                 P, n_max, K=0, V=0, M=0, Q=0, CK=4
                                 ) -> Tuple[torch.Tensor, Carry]:
    """The checkpointed full solve on the card: unpack_bits, then per
    group ffd_slot_headroom and ffd_group_commit, the headroom of every
    chunk entry storing the carry into its bank row (``entry_row``), then
    pack_outputs; no synchronisation and no launch of its own for the
    bank. Returns (output buffer, bank [G/CK, ...])."""
    if G % CK:
        raise ValueError(f"G={G} is not a multiple of CK={CK}")
    inp = _packed_inputs(buf, T, D, Z, C, G, E, P, K, M, Q)
    st = ScanState(inp, carry0(inp, E + n_max, E), E=E, P=P, V=V)
    bs = BankState(st.carry, empty_bank(st.carry, G // CK))
    with launching(st.k) as stream:
        for g in range(G):
            ffd_slot_headroom(st, g, stream, bs,
                              entry_row(g, 0, CK, 0, False))
            ffd_group_commit(st, g, stream)
    return pack_outputs(st.takes, st.leftover, st.carry), bs.bank


def solve_scan_suffix_cuda(buf: torch.Tensor, bank: Carry, *, T, D, Z, C,
                           G, E, P, n_max, K=0, V=0, M=0, Q=0, CK=4, SUF=1,
                           GL=None) -> Tuple[torch.Tensor, Carry]:
    """The suffix re-solve on the card, under one guard: one unpack_bits
    launch that also loads bank row jr = GL/CK - SUF into the working
    carry (``unpack_bits_load``), then per group of [GL - SUF*CK, GL) the
    two K2 kernels, the headroom of every later chunk entry storing the
    carry into its bank row (``entry_row``; row jr keeps the carry it
    holds), and pack_outputs over the SUF*CK window rows, whose launch
    also re-stamps the pad chunks [GL/CK, G/CK) with the final carry when
    there are any; no synchronisation. The bank is spliced in place and
    returned."""
    GL = G if GL is None else GL
    NC = G // CK
    if G % CK or GL % CK or not 0 < GL <= G or not 1 <= SUF <= GL // CK:
        raise ValueError(f"suffix plan G={G} GL={GL} CK={CK} SUF={SUF} "
                         "is not chunk-aligned inside the arena")
    N = E + n_max
    if bank.used.shape[:2] != (NC, N):
        raise ValueError(f"bank rows/slots {tuple(bank.used.shape[:2])}, "
                         f"the statics need {(NC, N)}")
    carry = Carry(*[torch.empty((1,) if nm == "num_nodes"
                                else tuple(b.shape[1:]),
                                dtype=b.dtype, device=b.device)
                    for nm, b in zip(Carry._fields, bank)])
    bs = BankState(carry, bank)
    jr, s0 = GL // CK - SUF, GL - SUF * CK
    with launching(buf) as stream:
        inp = _packed_inputs(buf, T, D, Z, C, G, E, P, K, M, Q,
                             load=(bs, jr), stream=stream)
        st = ScanState(inp, carry, E=E, P=P, V=V, s0=s0, s1=GL)
        for g in range(s0, GL):
            ffd_slot_headroom(st, g, stream, bs,
                              entry_row(g, s0, CK, jr, True))
            ffd_group_commit(st, g, stream)
        pad = (bs, GL // CK, NC - GL // CK) if NC > GL // CK else None
        out = pack_outputs(st.takes, st.leftover, st.carry, store=pad,
                           stream=stream)
    return out, bank


# ---------------------------------------------------------------------------
# K4: the packed solve on the lane axis
# ---------------------------------------------------------------------------

def _packed_inputs_lanes(bufs: torch.Tensor, T, D, Z, C, G, E, P, K, M,
                         Q, F=1) -> KernelInputs:
    """The [B, W] stack's inputs: one lane-axis unpack_bits launch, then
    [B, ...] views (each lane's i64 fields W words apart; the ``fuse``
    flags too when F > 1)."""
    _need(bufs, "bufs", torch.int64)
    if bufs.dim() != 2:
        raise ValueError(f"bufs must be [B, W], got {tuple(bufs.shape)}")
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, K, M, F, Q))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, K, M, F, Q))
    if bufs.shape[1] != n_i64 + nwords(n_bits):
        raise ValueError(f"arenas have {bufs.shape[1]} words, the statics "
                         f"need {n_i64 + nwords(n_bits)}")
    bools = unpack_bits_lanes(bufs[:, n_i64:], n_bits)
    return _unpack_inputs_lanes(bufs[:, :n_i64], bools, T, D, Z, C, G, E, P,
                                K, M, Q, F)


def solve_scan_packed1_many_cuda(bufs: torch.Tensor, *, T, D, Z, C, G, E, P,
                                 n_max, K=0, V=0, M=0, Q=0, F=1,
                                 cluster=None) -> torch.Tensor:
    """B packed solves on the card in one dispatch: one lane-axis
    unpack_bits, 2*G lane-axis K2 launches (F > 1: 2*G/F lane-axis K5
    launches, ``_fused_scan``, the commit on ``cluster`` CTAs a lane, by
    default ``fused_cluster``'s), one lane-axis pack_outputs, whatever B
    is; no synchronisation. Returns [B, Wout]."""
    B = bufs.shape[0]
    inp = _packed_inputs_lanes(bufs, T, D, Z, C, G, E, P, K, M, Q, F)
    carry = carry0(inp, E + n_max, E, lanes=B)
    if F > 1:
        st = _fused_scan(FusedState(inp, carry, E=E, P=P, Fu=F, lanes=B,
                                    cluster=cluster))
    else:
        st = ScanState(inp, carry, E=E, P=P, V=V, lanes=B)
        k2_steps(st, 0, G)
    return pack_outputs_lanes(st.takes, st.leftover, st.carry)


# ---------------------------------------------------------------------------
# K5 wrappers: the fused block scan
# ---------------------------------------------------------------------------

class _FusedArgs(ctypes.Structure):
    """Mirror of ``struct FusedArgs`` in csrc/fused.cu."""
    _fields_ = [("f", _FfdArgs), ("fuse", ctypes.c_void_p),
                ("capn", ctypes.c_void_p), ("Fu", ctypes.c_longlong),
                ("fuse_lane_bytes", ctypes.c_longlong),
                ("capn_lane_bytes", ctypes.c_longlong),
                ("cluster", ctypes.c_longlong)]


class FusedState(ScanState):
    """A ``ScanState`` with Fu groups' scratch side by side (``cand``
    [Fu*N, T], ``k`` [Fu*N]), the new-node tables of the block's groups
    (``candn`` / ``hrn`` [Fu*P, T], the partial caps ``capn`` [Fu, P,
    table_blocks(T)]) and the ``fuse``
    flags of the arena (``inp.fuse``, [G] or [L, G] for lanes, each lane
    contiguous), plus the ctypes argument block of the K5 kernels. No
    minValues floors.

    ``cluster`` is the commit's CTAs per lane (1, 2, 4 or 8); by default
    the fixed rule of ``csrc/fused.cu`` (``karp_ffd_fused_cluster``) picks
    it from the lane count and the card's occupancy."""

    def __init__(self, inp: KernelInputs, carry: Carry, *, E: int, P: int,
                 Fu: int, lanes: int = None, cluster: int = None):
        G = inp.R.shape[-2]
        if inp.mv_floor is not None:
            raise ValueError("the fused scan takes no minValues floors")
        if Fu < 2 or G % Fu:
            raise ValueError(f"fusion width Fu={Fu} must be at least 2 and "
                             f"divide G={G}")
        if cluster not in (None, 1, 2, 4, 8):
            raise ValueError(f"cluster={cluster} is not 1, 2, 4 or 8")
        super().__init__(inp, carry, E=E, P=P, lanes=lanes, Fu=Fu,
                         table_rows=Fu * P)
        if inp.fuse is None:
            raise ValueError("a fused scan needs the arena's fuse flags")
        _need(inp.fuse, "fuse", torch.bool,
              (G,) if lanes is None else (lanes, G), lanes=lanes is not None)
        self.Fu = Fu
        lead = () if lanes is None else (lanes,)
        self.capn = self.capn.view(lead + (Fu, P, -1))
        self.fargs = _FusedArgs(
            f=self.args, fuse=inp.fuse.data_ptr(),
            capn=self.capn.data_ptr(), Fu=Fu,
            fuse_lane_bytes=0 if lanes is None else inp.fuse.stride(0),
            capn_lane_bytes=0 if lanes is None else self.capn[0].numel() * 8,
            cluster=1)
        if cluster is None:
            cluster = fused_cluster(lanes or 1, Fu, P, inp.A.shape[-1],
                                    carry.used.shape[-2], _device(self.k))
        self.cluster = self.fargs.cluster = cluster

    def block_cand(self) -> torch.Tensor:
        """``cand`` as [(L,) Fu, N, T]."""
        N, T = self.carry.used.shape[-2], self.cand.shape[-1]
        return self.cand.view(self.cand.shape[:-2] + (self.Fu, N, T))

    def block_k(self) -> torch.Tensor:
        """``k`` as [(L,) Fu, N]."""
        return self.k.view(self.k.shape[:-1] + (self.Fu, -1))

    def block_table(self):
        """The block's new-node tables: (candn [(L,) Fu, P, T], hrn
        [(L,) Fu, P, T], cap [(L,) Fu, P], the max over the table blocks'
        partial caps, which the commit takes)."""
        T = self.hrn.shape[-1]
        lead = self.hrn.shape[:-2]
        shp = lead + (self.Fu, -1, T)
        return (self.candn.view(shp), self.hrn.view(shp),
                self.capn.amax(-1))


_CLUSTERS = {}


def _cluster_rule(cache: dict, key: tuple, fn, args, dev: torch.device,
                  name: str) -> int:
    """A cluster shape from the card's occupancy rule ``fn(args)`` (a
    negative answer is a CUDA error), asked once for each ``key`` on the
    device ``dev``, under its guard."""
    key = (dev.index,) + key
    if key not in cache:
        with on_device(dev):
            cs = fn(ctypes.byref(args))
        if cs < 0:
            _check(-cs, f"{name} (cluster size)")
        cache[key] = cs
    return cache[key]


def fused_cluster(L: int, Fu: int, P: int, D: int, N: int,
                  device=None) -> int:
    """The commit's CTAs per lane for L lanes of Fu groups, P pools, D
    resources and N slots: the largest of 8, 4, 2, 1 whose L clusters the
    card holds at once (``karp_ffd_fused_cluster``, csrc/fused.cu). The
    commit's shared memory, and so the answer, depends on these shapes
    alone; the card is asked once for each of them and each device
    (``device``: the state's; default the current one)."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    a = _FusedArgs(Fu=Fu)
    a.f.L, a.f.P, a.f.D, a.f.N = L, P, D, N
    return _cluster_rule(_CLUSTERS, (L, Fu, P, D, N),
                         _lib().karp_ffd_fused_cluster, a, dev,
                         "ffd_fused_commit")


def fused_headroom_blocks(N: int, Fu: int, P: int, T: int) -> int:
    """Blocks of ``ffd_fused_headroom`` a lane (csrc/fused.cu
    ``fused_headroom_blocks``): one CTA a slot covering all Fu groups,
    then the new-node table's Fu * P * table_blocks(T)."""
    return N + Fu * P * table_blocks(T)


def _fused_launch(name: str, fs: FusedState, g0: int, stream) -> None:
    if g0 % fs.Fu:
        raise ValueError(f"block start {g0} is not a multiple of Fu={fs.Fu}")
    _in_window(fs, g0)
    _launch(name, getattr(_lib(), f"karp_{name}"),
            (ctypes.byref(fs.fargs), g0), fs.k, stream)


def ffd_fused_headroom(fs: FusedState, g0: int, stream: int = None) -> None:
    """Steps 1-3 of groups [g0, g0 + Fu) from the carry as it stands
    (the block-start carry), and their new-node tables: fills
    ``fs.block_cand()``, ``fs.block_k()`` and ``fs.block_table()``."""
    _fused_launch("ffd_fused_headroom", fs, g0, stream)


def ffd_fused_commit(fs: FusedState, g0: int, stream: int = None) -> None:
    """The block of groups [g0, g0 + Fu), each lane by its own branch, on
    a cluster of ``fs.cluster`` CTAs a lane, its new nodes read from the
    tables: updates the carry in place and writes ``fs.takes`` /
    ``fs.leftover`` rows [g0, g0 + Fu)."""
    _fused_launch("ffd_fused_commit", fs, g0, stream)


def _fused_scan(fs: FusedState) -> FusedState:
    """Every block of the scan: two launches each, under one guard of
    the state's device; no synchronisation."""
    with launching(fs.k) as stream:
        for g0 in range(fs.s0, fs.s1, fs.Fu):
            ffd_fused_headroom(fs, g0, stream)
            ffd_fused_commit(fs, g0, stream)
    return fs


def solve_scan_packed1_fused_cuda(buf: torch.Tensor, *, T, D, Z, C, G, E,
                                  P, n_max, Q=0, F) -> torch.Tensor:
    """The fused packed solve on the card (F > 1, K = 0): the one-lane
    call of ``solve_scan_packed1_many_cuda``: unpack_bits, 2*G/F K5
    launches, pack_outputs."""
    _need(buf, "buf", torch.int64)
    return solve_scan_packed1_many_cuda(
        buf[None], T=T, D=D, Z=Z, C=C, G=G, E=E, P=P, n_max=n_max, Q=Q,
        F=F)[0]


# ---------------------------------------------------------------------------
# K6 wrappers: the pruned scan
# ---------------------------------------------------------------------------

_PRUNED_FIELDS = ("cap_hint", "bail", "sel", "cnt", "ks", "capn", "cap_row")


class _PrunedArgs(ctypes.Structure):
    """Mirror of ``struct PrunedArgs`` in csrc/pruned.cu."""
    _fields_ = ([("f", _FfdArgs)]
                + [(f, ctypes.c_void_p) for f in _PRUNED_FIELDS]
                + [("S", ctypes.c_longlong),
                   ("lane_bytes", ctypes.c_longlong * len(_PRUNED_FIELDS)),
                   ("cluster", ctypes.c_longlong),
                   ("rows", ctypes.c_longlong)])


class PrunedState:
    """Device buffers of one pruned scan (or of L lanes of one shape):
    a ``ScanState`` for the base fields (its ``cand`` holds the S
    selected rows, its ``k`` the per-slot headroom and take), the bound
    ``cap_hint`` and the ``bail`` flag of the carry (updated in place),
    the selection scratch (``sel`` [S] slots, ``cnt`` [2] = (n_sel,
    n_pos), ``ks`` [S] exact headroom), the group's new-node table
    (``table()``) and the ctypes argument block.

    ``cluster`` is the probe's CTAs a cluster (1, 2, 4 or 8) and
    ``rows`` its selecting clusters a lane (1, 2 or 4); by default the
    fixed rule of ``csrc/pruned.cu`` (``karp_ffd_pruned_cluster``) picks
    both from the lane count, the shapes and the card's occupancy (a
    given ``cluster`` alone takes ``rows`` 1)."""

    def __init__(self, inp: KernelInputs, carry: CarryP, *, E: int, P: int,
                 S: int, lanes: int = None, cluster: int = None,
                 rows: int = None):
        if inp.mv_floor is not None:
            raise ValueError("the pruned scan takes no minValues floors")
        N = carry.used.shape[-2]
        if not 1 <= S <= N:
            raise ValueError(f"S={S} must lie in [1, N={N}]")
        if cluster not in (None, 1, 2, 4, 8):
            raise ValueError(f"cluster={cluster} is not 1, 2, 4 or 8")
        if rows not in (None, 1, 2, 4):
            raise ValueError(f"rows={rows} is not 1, 2 or 4")
        L = 1 if lanes is None else lanes
        lead = () if lanes is None else (L,)
        D = inp.A.shape[-1]
        self.scan = ScanState(inp, Carry(*carry[:8]), E=E, P=P, lanes=lanes,
                              cand_rows=S, table_rows=P)
        _need(carry.cap_hint, "cap_hint", torch.int64, lead + (N, D))
        _need(carry.bail, "bail", torch.bool, lead + (1,))
        dev = inp.A.device
        self.carry, self.S = carry, S
        self.sel = torch.empty(lead + (S,), dtype=torch.int32, device=dev)
        self.cnt = torch.empty(lead + (2,), dtype=torch.int32, device=dev)
        self.ks = torch.empty(lead + (S,), dtype=torch.int64, device=dev)
        TB = table_blocks(inp.A.shape[-2])
        self.capn = self.scan.capn
        self.cap_row = torch.empty(lead + (P, TB, D), dtype=torch.int64,
                                   device=dev)
        bufs = dict(cap_hint=carry.cap_hint, bail=carry.bail, sel=self.sel,
                    cnt=self.cnt, ks=self.ks, capn=self.capn,
                    cap_row=self.cap_row)
        self.args = _PrunedArgs(f=self.scan.args, S=S, cluster=1, rows=1,
                                **{k: t.data_ptr() for k, t in bufs.items()})
        for i, f in enumerate(_PRUNED_FIELDS):
            t = bufs[f]
            self.args.lane_bytes[i] = 0 if lanes is None else \
                t[0].numel() * t.element_size()
        if cluster is None:
            a = self.scan.args
            shape = _cluster_rule(
                _PROBE_CLUSTERS, (L, a.N, S, a.T, a.D, a.Z, a.C, P),
                _lib().karp_ffd_pruned_cluster, self.args,
                _device(self.ks), "ffd_pruned_probe")
            cluster, rule_rows = shape % 16, shape // 16
            rows = rule_rows if rows is None else rows
        self.cluster = self.args.cluster = cluster
        self.rows = self.args.rows = 1 if rows is None else rows

    @property
    def takes(self) -> torch.Tensor:
        return self.scan.takes

    @property
    def leftover(self) -> torch.Tensor:
        return self.scan.leftover

    @property
    def cand(self) -> torch.Tensor:
        return self.scan.cand

    def table(self):
        """The group's new-node table: (candn [(L,) P, T], hrn [(L,) P,
        T], cap [(L,) P], cap_row [(L,) P, D]); cap and cap_row are the
        max over the table blocks' partials, which the commit takes."""
        return (self.scan.candn, self.scan.hrn, self.capn.amax(-1),
                self.cap_row.amax(-2))


_PROBE_CLUSTERS = {}


def _pruned_launch(name: str, ps: PrunedState, g: int, stream) -> None:
    _in_window(ps.scan, g)
    _launch(name, getattr(_lib(), f"karp_{name}"),
            (ctypes.byref(ps.args), g), ps.ks, stream)


def ffd_pruned_probe(ps: PrunedState, g: int, stream: int = None) -> None:
    """The bound pass, the compatibility screen and the selection for
    group g (``ps.sel``: the first S bound-positive compatible open slots
    in slot order, -1 past them; ``ps.cnt`` = (n_sel, n_pos)), the exact
    candidate rows ``ps.cand`` [S, T] and headroom ``ps.ks`` [S] of the
    selected slots (rows past n_sel: False and 0), and the group's
    new-node table ``ps.table()``: one launch, ``ps.rows`` selecting
    clusters of ``ps.cluster`` CTAs a lane and the table's."""
    _pruned_launch("ffd_pruned_probe", ps, g, stream)


def ffd_pruned_commit(ps: PrunedState, g: int, stream: int = None) -> None:
    """The fill, the bail flag, the narrowing and the new nodes (read
    from the table) for group g: updates the carry in place and writes
    ``ps.takes[g]`` and ``ps.leftover[g]``."""
    _pruned_launch("ffd_pruned_commit", ps, g, stream)


def pruned_steps(ps: PrunedState, g0: int, g1: int) -> None:
    """Groups [g0, g1) of a pruned scan: ``ffd_pruned_probe`` then
    ``ffd_pruned_commit`` each, under one guard of the state's device, on
    its current stream; no synchronisation."""
    if g0 < g1:
        _in_window(ps.scan, g0)
        _in_window(ps.scan, g1 - 1)
    lib = _lib()
    probe, commit = lib.karp_ffd_pruned_probe, lib.karp_ffd_pruned_commit
    args = ctypes.byref(ps.args)
    with launching(ps.ks) as stream:
        for g in range(g0, g1):
            _launch("ffd_pruned_probe", probe, (args, g), None, stream)
            _launch("ffd_pruned_commit", commit, (args, g), None, stream)


def _pruned_scan(inp: KernelInputs, *, G, E, P, n_max, S, lanes=None
                 ) -> PrunedState:
    ps = PrunedState(inp, carry0_pruned(inp, E + n_max, E, lanes=lanes),
                     E=E, P=P, S=S, lanes=lanes)
    pruned_steps(ps, 0, G)
    return ps


def solve_scan_packed1_pruned_many_cuda(bufs: torch.Tensor, *, T, D, Z, C,
                                        G, E, P, n_max, S) -> torch.Tensor:
    """B pruned solves on the card in one dispatch (B = 1: a single
    solve): one lane-axis unpack_bits, two lane-axis launches per group
    step, one lane-axis pack_outputs whose rows end with each lane's bail
    word; no synchronisation."""
    B = bufs.shape[0]
    inp = _packed_inputs_lanes(bufs, T, D, Z, C, G, E, P, 0, 0, 0)
    ps = _pruned_scan(inp, G=G, E=E, P=P, n_max=n_max, S=S, lanes=B)
    return pack_outputs_lanes(ps.takes, ps.leftover, ps.carry,
                              bail=ps.carry.bail)
