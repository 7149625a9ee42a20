"""Host-side (numpy-only) packing for the single-buffer solve.

The layout lists here are the single source of truth for BOTH sides of
the device boundary: the host packs kernel inputs into ONE int64 buffer
(bools bitpacked little-endian, 64 to a word) and unpacks the ONE int64
output buffer; ops/ffd_torch.py and ops/ffd_cuda.py walk the same
layouts on the device. A copy of the reference package's
ops/hostpack.py, byte-identical on every function carried here
(tests/test_torch_ffd.py and tests/test_torch_incremental.py hold the
two against each other). Where the reference may call its native
``deltawalk`` library, this copy runs the reference's numpy branch.
"""

from __future__ import annotations

import numpy as np

#: default fused-scan block width (groups batched per scan step when the
#: encoder's run detection proves them pairwise pool/existing-disjoint):
#: the one source for the solver knob (solver/cuda.py dev_fuse) and the
#: plain scan's default. 4 cuts the scan's block count 4x on run-heavy
#: snapshots (ops/ffd_torch.py ``_solve_fused_ref``; on the card
#: csrc/fused.cu, two launches a block).
DEV_FUSE = 4

#: default exact-slot budget per pruned-kernel step: the one source for
#: the kernel signature default (ops/ffd_torch.py) and the solver knob
#: (solver/cuda.py dev_pruned_slots). The compat-aware bound pass counts
#: only slots the exact step could fill, and BASELINE config 7 (50k pods,
#: ~10k signatures, ~5 pods/signature) clears its deepest fill at S=48;
#: 64 leaves margin without moving the O(S*T*D) step-cost class.
DEV_PRUNED_SLOTS = 64


def in_layout_i64(T, D, Z, C, G, E, P, K=0, M=0, F=1, Q=0):
    """(name, shape) of every int64 input, in buffer order. K/M are the
    minValues key/pair counts (0 = feature absent, zero extra bytes);
    Q is the priority-tier count gating the per-group priority vector
    under the same zero-when-absent discipline."""
    lay = [("A", (T, D)), ("R", (G, D)), ("n", (G,)),
           ("daemon", (G, P, D)), ("pool_limit", (P, D)),
           ("pool_used0", (P, D)), ("ex_alloc", (E, D)),
           ("ex_used0", (E, D)), ("mv_floor", (P, K)),
           ("mv_pairs_t", (K, M)), ("mv_pairs_v", (K, M))]
    if Q:
        # resolved per-group priority: data for per-tier reporting and
        # the preemption search — the base solve's decisions never read
        # it (canonical order already encodes priority)
        lay.append(("prio", (G,)))
    return lay


def in_layout_bool(T, D, Z, C, G, E, P, K=0, M=0, F=1, Q=0):
    base = [("avail_zc", (T, Z * C)), ("F", (G, T)), ("agz", (G, Z)),
            ("agc", (G, C)), ("admit", (G, P)),
            ("pool_types", (P, T)), ("pool_agz", (P, Z)),
            ("pool_agc", (P, C)), ("ex_compat", (G, E))]
    if F > 1:
        # same_run_as_prev flags (models/encoding.py independent_runs):
        # data, not statics — only the block width F keys the compile
        base.append(("fuse", (G,)))
    return base


def out_layout(T, D, Z, C, G, E, P, n_max):
    """((i64 name, shape)…), ((i32 name, shape)…), ((bool name, shape)…)
    of the packed outputs. takes rides the int32 section: a single
    slot's take is bounded by the pod count (< 2^31 by construction),
    so two lanes pack per int64 wire word and the dominant [G, N]
    output tensor halves on the d2h leg."""
    N = E + n_max
    i64 = [("leftover", (G,)), ("used", (N, D)),
           ("pool", (N,)), ("num_nodes", (1,)), ("pool_used", (P, D))]
    i32 = [("takes", (G, N))]
    bl = [("types", (N, T)), ("zones", (N, Z)), ("ct", (N, C)),
          ("alive", (N,))]
    return i64, i32, bl


def split(buf, layout) -> dict:
    """Walk a flat buffer by a (name, shape) layout list. Works on both
    numpy arrays and torch tensors; the ONLY buffer walker — host pack
    and device unpack share it so the layouts can never drift apart."""
    vals = {}
    off = 0
    for nm, shp in layout:
        sz = 1
        for s in shp:
            sz *= s
        vals[nm] = buf[off:off + sz].reshape(shp)
        off += sz
    return vals


def layout_sizes(layout) -> int:
    total = 0
    for _, shp in layout:
        sz = 1
        for s in shp:
            sz *= s
        total += sz
    return total


def nwords(nbits: int) -> int:
    return (nbits + 63) // 64


def nwords32(nvals: int) -> int:
    """int64 wire words needed for ``nvals`` int32 lanes (two per word)."""
    return (nvals + 1) // 2


def pack_i32_words(vals: np.ndarray) -> np.ndarray:
    """Host: flat int32-valued array -> int64 wire words, two lanes per
    word, little-lane-first — mirrors the device's bitcast packing
    (ops/ffd_cuda.py pack_outputs) so no layout assumption crosses."""
    v = np.asarray(vals).reshape(-1).astype(np.int64)
    if v.size % 2:
        v = np.concatenate([v, np.zeros(1, np.int64)])
    u = (v & np.int64(0xFFFFFFFF)).view(np.uint64)
    return (u[0::2] | (u[1::2] << np.uint64(32))).view(np.int64)


def unpack_i32_words(words: np.ndarray, nvals: int) -> np.ndarray:
    """Host: int64 wire words -> int64 array of the sign-extended int32
    lanes (callers keep doing int64 math on the result)."""
    u = np.ascontiguousarray(words).view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    out = np.empty(u.size * 2, dtype=np.int32)
    out[0::2] = lo.view(np.int32)
    out[1::2] = hi.view(np.int32)
    return out[:nvals].astype(np.int64)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """flat bool -> little-endian 64-bit words viewed as int64."""
    bits = np.ascontiguousarray(np.asarray(bits).reshape(-1), dtype=bool)
    padded = np.zeros(nwords(bits.size) * 64, dtype=bool)
    padded[:bits.size] = bits
    return np.packbits(padded, bitorder="little").view("<i8").astype(
        np.int64)


def unpack_bits(words: np.ndarray, nbits: int) -> np.ndarray:
    """int64 words -> flat bool [nbits] (inverse of pack_bits)."""
    words = np.ascontiguousarray(words).astype("<i8")
    return np.unpackbits(words.view(np.uint8),
                         bitorder="little")[:nbits].astype(bool)


def pack_inputs1(arrays: dict, T, D, Z, C, G, E, P, K=0, M=0,
                 F=1, Q=0) -> np.ndarray:
    """Host: all inputs -> ONE int64 buffer [i64 fields | bitpacked bools]."""
    return pack_inputs1_state(arrays, T, D, Z, C, G, E, P, K, M, F, Q)[0]


def pack_inputs1_state(arrays: dict, T, D, Z, C, G, E, P, K=0, M=0,
                       F=1, Q=0):
    """``pack_inputs1`` that also returns the pre-bitpack bool plane."""
    empty = np.zeros(0, dtype=np.int64)
    i64 = np.concatenate([
        np.asarray(arrays.get(nm, empty)).reshape(-1).astype(np.int64)
        for nm, _ in in_layout_i64(T, D, Z, C, G, E, P, K, M, F, Q)])
    bl = np.concatenate([arrays[nm].reshape(-1).astype(bool)
                         for nm, _ in in_layout_bool(T, D, Z, C, G, E, P,
                                                     K, M, F, Q)])
    return np.concatenate([i64, pack_bits(bl)]), bl


def patch_inputs1(buf: np.ndarray, bool_flat: np.ndarray, arrays: dict,
                  dirty_i64, dirty_bool, T, D, Z, C, G, E, P, K=0, M=0,
                  F=1, Q=0):
    """Patch dirty fields of a RESIDENT packed arena in place.

    ``(buf, bool_flat)`` must be the pair ``pack_inputs1_state``
    returned for the SAME statics; ``arrays`` carries the new field
    values (only the dirty names are read). i64 fields overwrite the
    changed run of their buffer words. Bool fields update the resident
    bool plane, then re-bitpack only the words covering the field's bit
    range — sections are not word-aligned, so the repack rounds out to
    the enclosing words and re-reads the neighbours from the plane,
    which is why the plane must stay resident. The result is
    byte-identical to a fresh pack of the same arrays.

    Returns the ``(start, stop)`` int64-word sections of ``buf`` that
    were overwritten (bool sections word-rounded, as repacked)."""
    sections = []
    lay64 = in_layout_i64(T, D, Z, C, G, E, P, K, M, F, Q)
    want64 = set(dirty_i64)
    off = 0
    for nm, shp in lay64:
        sz = 1
        for s in shp:
            sz *= s
        if nm in want64 and sz:
            fresh = np.asarray(arrays[nm]).reshape(-1).astype(np.int64)
            hit = np.nonzero(buf[off:off + sz] != fresh)[0]
            if hit.size:
                # one span per field: the changed word run
                w0, w1 = int(hit[0]), int(hit[-1]) + 1
                buf[off + w0:off + w1] = fresh[w0:w1]
                sections.append((off + w0, off + w1))
        off += sz
    layb = in_layout_bool(T, D, Z, C, G, E, P, K, M, F, Q)
    nbits = layout_sizes(layb)
    wantb = set(dirty_bool)
    boff = 0
    for nm, shp in layb:
        sz = 1
        for s in shp:
            sz *= s
        if nm in wantb and sz:
            fresh = np.asarray(arrays[nm]).reshape(-1)
            bool_flat[boff:boff + sz] = fresh.astype(bool)
            w0 = boff >> 6
            end = min(((boff + sz + 63) >> 6) << 6, nbits)
            words = pack_bits(np.ascontiguousarray(bool_flat[w0 << 6:end]))
            buf[off + w0:off + w0 + words.size] = words
            sections.append((off + w0, off + w0 + words.size))
        boff += sz
    return sections


#: arena fields whose leading axis is the canonical GROUP axis — the
#: only fields a dirty section can touch while still permitting a
#: suffix-only re-solve past its group index. Everything else (catalog,
#: pool vectors, existing-node tables) feeds the scan's INITIAL carry
#: or every step, so touching it forces frontier 0 (full solve).
GROUP_MAJOR_FIELDS = frozenset(
    ("R", "n", "daemon", "prio", "F", "agz", "agc", "admit", "ex_compat",
     "fuse"))


def tier_leftovers(leftover: np.ndarray, prio) -> dict:
    """Per-priority-tier unschedulable pod counts from the solve's [G]
    leftover output and the encoding's per-group priority vector (None =
    priority axis disabled -> single tier 0). Host-side reporting: the
    kernels never read priority (canonical order encodes it), so this is
    THE per-tier view both the device and CPU paths share."""
    left = np.asarray(leftover).reshape(-1)
    if prio is None:
        return {0: int(left.sum())}
    pr = np.asarray(prio).reshape(-1)[:left.size]
    out: dict = {}
    for tier in np.unique(pr):
        out[int(tier)] = int(left[: pr.size][pr == tier].sum())
    return out


def unpack_outputs1(buf, T, D, Z, C, G, E, P, n_max) -> dict:
    """Host: the single fetched buffer -> dict of arrays."""
    li, l32, lb = out_layout(T, D, Z, C, G, E, P, n_max)
    n_i64 = layout_sizes(li)
    n_32 = layout_sizes(l32)
    w32 = nwords32(n_32)
    n_bits = layout_sizes(lb)
    i32_flat = unpack_i32_words(buf[n_i64:n_i64 + w32], n_32)
    bool_flat = unpack_bits(np.ascontiguousarray(buf[n_i64 + w32:]), n_bits)
    vals = split(buf[:n_i64], li)
    vals.update(split(i32_flat, l32))
    vals.update(split(bool_flat, lb))
    return vals
