"""The consolidation gather (K7d, ``subset_gather``) and the subset
round's summary rows as their kernels compute them, held against the
plain versions and the reference package on the CPU.

``csrc/consolidation.cu`` ``subset_gather_kernel`` runs X CTAs a lane
(``consolidation_cuda.gather_ctas``), each taking a contiguous slice of
each field's rows: the lane's ``avail_zc & keep`` bytes cut at the
destination's 16-byte boundaries (CTA 0 also its head and tail bytes),
each 16-byte word masked by keep of its bytes' types (a counter from the
word's first type); the group rows a warp a row (R and daemon as 16-byte
words where the two rows share their alignment mod 16, F & keep and
ex_compat & ~dead as 16-byte words of source and mask read at their own
alignment, the short rows as bytes); the existing rows' ``ex_alloc`` /
``ex_used0`` two 8-byte words a thread, zero on the lane's dead rows (a
word's row by 32-bit division), or a word a thread where the tables'
alignments differ. Here a plain model of that decomposition, on
simulated addresses (the arena's fields at offsets that give every load
width), writes every output byte and checks that each is written once
and equals ``_subset_gather_ref``: rows of T and E not multiples of 16,
D odd, Gq = 1 and 128, dead rows at the CTAs' slice edges, 1 to 7 CTAs a
lane. The grid rule itself: ``gather_ctas`` at the rounds' shapes.

The lanes' summary rows (K7d's ``subset_summary``, consolidation_jax.py
:253-262) are written by the round's last ``ffd_group_commit`` launch
(``csrc/ffd_scan.cu`` ``summary_row``), on each lane's rank-0 CTA after
its final cluster barrier: the leftover over the window as a wrapping
sum, and over t0 = types[E] & keep (the first new slot's row, cut at its
own 16-byte boundaries: one 16-byte load of each row where keep shares
the row's address mod 16, bytes otherwise) the flex count and the
cheapest price, ``tprice`` read only for the types that are on, then
warp and CTA reductions (keep's span by 4-byte loads where it shares the
row's address mod 4 only). Its model, at every offset of the row mod 16
(keep aligned with it and not), 256 and 512 threads, is held to
``_subset_summary_ref``: no minted node, one and two, leftovers whose sum
wraps past 2^63, an empty t0, every type on with prices past BIG; and,
on the subset rounds of ``examples.subset_case`` at T = 813 (rows at
every offset), to the plain round and the reference's
``subset_solve_kernel``.

Tolerance: exact (int64 and bool).
"""

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu.ops import consolidation_jax as cj
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_BYTE_FIELDS = ("avail_zc", "F", "agz", "agc", "admit", "ex_compat")
_WORD_FIELDS = ("R", "daemon", "ex_alloc", "ex_used0")


class Buf:
    """A flat array at a simulated address: ``addr(i)`` of element i,
    the values, and for an output the count of writes of each
    element."""

    def __init__(self, values, base: int, out: bool = False):
        self.v = np.ascontiguousarray(values).reshape(-1).copy()
        self.item = self.v.dtype.itemsize
        self.base = base
        self.n = np.zeros(self.v.size, np.int64) if out else None

    def addr(self, i: int) -> int:
        return self.base + i * self.item

    def put(self, i: int, x) -> None:
        self.v[i] = x
        self.n[i] += 1


def row_cut(addr: int, n: int):
    """(head, nv, tail) of a row of n bytes at ``addr`` (``row_cut``)."""
    head = min((16 - addr % 16) % 16, n)
    nv = (n - head) // 16
    return head, nv, n - head - 16 * nv


def rel_align(src: int, dst: int) -> int:
    """The width ``ld16`` reads src with, dst 16-byte aligned."""
    d = (src - dst) % 16
    return 16 if d == 0 else (4 if d % 4 == 0 else 1)


def load16(buf: Buf, i: int, al: int):
    """16 bytes of ``buf`` from element i at width ``al``: each load of
    that width lands on an address of that alignment."""
    assert buf.addr(i) % al == 0, (buf.addr(i), al)
    return buf.v[i:i + 16].astype(np.uint8)


def and_row(dst: Buf, d0: int, src: Buf, s0: int, mask: Buf, m0: int,
            inv: bool, n: int) -> None:
    """``and_row_warp``: dst[i] = src[i] & mask[i] (& ~mask[i])."""
    head, nv, tail = row_cut(dst.addr(d0), n)
    flip = 0xff if inv else 0
    for i in list(range(head)) + list(range(head + 16 * nv, n)):
        dst.put(d0 + i, src.v[s0 + i] & (mask.v[m0 + i] ^ flip))
    a_s = rel_align(src.addr(s0 + head), dst.addr(d0 + head))
    a_m = rel_align(mask.addr(m0 + head), dst.addr(d0 + head))
    for k in range(nv):
        o = head + 16 * k
        assert dst.addr(d0 + o) % 16 == 0
        v = load16(src, s0 + o, a_s) & (load16(mask, m0 + o, a_m) ^ flip)
        for j in range(16):
            dst.put(d0 + o + j, v[j])


def copy_bytes(dst: Buf, d0: int, src: Buf, s0: int, n: int) -> None:
    for i in range(n):
        dst.put(d0 + i, src.v[s0 + i])


def copy_i64(dst: Buf, d0: int, src: Buf, s0: int, n: int) -> None:
    """``copy_i64_warp``: 16-byte words where the rows share their
    alignment mod 16, one word before and after them; else words."""
    if (dst.addr(d0) - src.addr(s0)) % 16:
        for i in range(n):
            dst.put(d0 + i, src.v[s0 + i])
        return
    h = 1 if dst.addr(d0) % 16 and n > 0 else 0
    nv = (n - h) // 2
    if h:
        dst.put(d0, src.v[s0])
    for k in range(nv):
        i = h + 2 * k
        assert dst.addr(d0 + i) % 16 == 0 and src.addr(s0 + i) % 16 == 0
        dst.put(d0 + i, src.v[s0 + i])
        dst.put(d0 + i + 1, src.v[s0 + i + 1])
    if h + 2 * nv < n:
        dst.put(d0 + n - 1, src.v[s0 + n - 1])


def gather_model(arena, gid, dead, keep, X: int, offsets: dict):
    """Every output of the gather, written as the kernel's X CTAs a lane
    write it; the arena's fields at ``offsets`` bytes past a 256-byte
    boundary (the outputs at one)."""
    B, Gq = gid.shape
    T, D = arena["A"].shape
    Gu, E = arena["ex_compat"].shape
    Z, C, P = (arena["agz"].shape[1], arena["agc"].shape[1],
               arena["admit"].shape[1])
    ZC = Z * C
    base = iter(range(1 << 20, 1 << 40, 1 << 24))
    src = {f: Buf(arena[f].astype(np.uint8) if f in _BYTE_FIELDS
                  else arena[f], next(base) + offsets.get(f, 0))
           for f in _BYTE_FIELDS + _WORD_FIELDS}
    kb = Buf(keep.astype(np.uint8), next(base) + offsets.get("keep", 0))
    db = Buf(dead.astype(np.uint8), next(base) + offsets.get("dead", 0))
    shapes = dict(avail_zc=(T, ZC), R=(Gq, D), F=(Gq, T), agz=(Gq, Z),
                  agc=(Gq, C), admit=(Gq, P), daemon=(Gq, P, D),
                  ex_compat=(Gq, E), ex_alloc=(E, D), ex_used0=(E, D))
    out = {f: Buf(np.zeros((B,) + shp, np.uint8 if f in _BYTE_FIELDS
                           else np.int64), next(base), out=True)
           for f, shp in shapes.items()}
    for b in range(B):
        for x in range(X):
            # avail_zc & keep[type]
            n = T * ZC
            o_a, s_a = out["avail_zc"], src["avail_zc"]
            head, nv, tail = row_cut(o_a.addr(b * n), n)
            if x == 0:
                for i in list(range(head)) + list(range(n - tail, n)):
                    o_a.put(b * n + i, s_a.v[i] & kb.v[b * T + i // ZC])
            al = rel_align(s_a.addr(head), o_a.addr(b * n + head))
            for k in range(nv * x // X, nv * (x + 1) // X):
                o = head + 16 * k
                v = load16(s_a, o, al)
                t, r = divmod(o, ZC)
                for j in range(16):
                    o_a.put(b * n + o + j, v[j] & kb.v[b * T + t])
                    r += 1
                    if r == ZC:
                        r, t = 0, t + 1
            # the group rows, a warp a row
            for q in range(Gq * x // X, Gq * (x + 1) // X):
                r = b * Gq + q
                g = int(gid[b, q])
                copy_i64(out["R"], r * D, src["R"], g * D, D)
                and_row(out["F"], r * T, src["F"], g * T, kb, b * T, False,
                        T)
                for f, w in (("agz", Z), ("agc", C), ("admit", P)):
                    copy_bytes(out[f], r * w, src[f], g * w, w)
                copy_i64(out["daemon"], r * P * D, src["daemon"],
                         g * P * D, P * D)
                and_row(out["ex_compat"], r * E, src["ex_compat"], g * E,
                        db, b * E, True, E)
            # the existing rows
            w0, w1 = E * x // X * D, E * (x + 1) // X * D
            da, du = out["ex_alloc"], out["ex_used0"]
            sa, su = src["ex_alloc"], src["ex_used0"]
            o0 = b * E * D

            def put(i):
                gone = db.v[b * E + i // D]
                da.put(o0 + i, 0 if gone else sa.v[i])
                du.put(o0 + i, 0 if gone else su.v[i])
            if ((da.addr(o0) - sa.addr(0)) | (du.addr(o0) - su.addr(0))
                    | (da.addr(o0) - du.addr(o0))) % 16 == 0:
                h = 1 if da.addr(o0 + w0) % 16 and w1 > w0 else 0
                npair = (w1 - w0 - h) // 2
                if h:
                    put(w0)
                for k in range(npair):
                    i = w0 + h + 2 * k
                    assert da.addr(o0 + i) % 16 == 0
                    assert sa.addr(i) % 16 == 0
                    e = i // D
                    e1 = e + 1 if i + 1 - e * D == D else e
                    assert e1 == (i + 1) // D
                    put(i)
                    put(i + 1)
                if w0 + h + 2 * npair < w1:
                    put(w1 - 1)
            else:
                for i in range(w0, w1):
                    put(i)
    for f, o in out.items():
        assert (o.n == 1).all(), (f, int(o.n.min()), int(o.n.max()))
    return {f: o.v.reshape((B,) + shapes[f]) for f, o in out.items()}


def _check_model(arena, lanes, X, offsets):
    inp = ft.kernel_inputs_from_numpy(arena, "cpu")
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    want = ct._subset_gather_ref(inp, t["gid"], t["n"], t["dead"],
                                 t["keep"])
    got = gather_model(arena, lanes["gid"], lanes["dead"], lanes["keep"],
                       X, offsets)
    for f, g in got.items():
        w = getattr(want, f).numpy()
        if w.dtype == bool:
            g = g.astype(bool)
        assert g.shape == w.shape and np.array_equal(g, w), f


#: arena field offsets past a 16-byte boundary: aligned, 8-byte words at
#: 8, byte rows at 4 (4-byte loads) and at odd offsets (byte loads)
OFFSETS = ({}, dict(R=8, daemon=8, ex_alloc=8, ex_used0=8, F=4, keep=12,
                    dead=4, avail_zc=4, ex_compat=8),
           dict(F=1, keep=3, dead=5, avail_zc=7, ex_compat=2, ex_used0=8))


@pytest.mark.parametrize("offsets", range(len(OFFSETS)))
@pytest.mark.parametrize("X", [1, 2, 7])
@pytest.mark.parametrize("shape", range(4))
def test_gather_model_matches_plain(shape, X, offsets):
    """The model of the kernel's decomposition on ``GATHER_SHAPES``' odd
    shapes (T = 813, 29, 17, 100; D = 7, 5, 1, 8; E = 37, 3, 1, 45; Gq = 1
    to 128), with dead rows at the CTAs' slice edges: each output written
    once and equal to the plain gather."""
    shp = examples.GATHER_SHAPES[shape]
    arena, _, lanes, _ = examples.subset_case("dead_nodes", shape, **shp)
    E = shp["Ep"]
    edges = sorted({e for x in range(X + 1) for e in
                    (E * x // X - 1, E * x // X) if 0 <= e < E})
    lanes["dead"][:, edges] = True
    lanes["dead"][1 % shp["B"], edges] = False
    _check_model(arena, lanes, X, OFFSETS[offsets])


def test_gather_model_round_widths():
    """Round (a)'s widths (T = 812, 12 offering pairs, E = 1,024, D = 8)
    on a few lanes, at the two CTAs a lane the card gives it, and
    round (b)'s 128 groups a lane on two lanes."""
    for shp, X in ((dict(examples.GATHER_SHAPES[5], B=3), 2),
                   (dict(examples.GATHER_SHAPES[4], B=2), 3)):
        arena, _, lanes, _ = examples.subset_case("dead_nodes", 5, **shp)
        _check_model(arena, lanes, X, OFFSETS[1])


def test_gather_ctas_rule():
    """CTAs a lane: about four waves of the resident CTAs (528 on the
    H100: 4 of 256 threads on each of 132 SMs), at least 16 KB each, at
    least one; round (a) (2,048 lanes), (b) (128 lanes of 128 groups),
    the 65,552 lanes of a round past grid y, a tiny lane."""
    a = cc.gather_lane_bytes(812, 12, 8, 4, 3, 1, 1024, 1)
    b = cc.gather_lane_bytes(812, 12, 8, 4, 3, 1, 1024, 128)
    assert a == 9744 + 16 * 1024 * 8 + 64 + 812 + 4 + 3 + 1 + 64 + 1024
    assert cc.gather_ctas(2048, a, 528) == 2
    assert cc.gather_ctas(128, b, 528) == 17
    assert cc.gather_ctas(65_552, a, 528) == 1
    assert cc.gather_ctas(4, 1000, 528) == 1
    assert cc.gather_ctas(1, 10 * cc.GATHER_CTA_BYTES, 528) == 10


# ---------------------------------------------------------------------------
# the summary rows in the round's last ffd_group_commit
# ---------------------------------------------------------------------------

_I64_MAX = (1 << 63) - 1
BIG = 1 << 60


def _wrap(x: int) -> int:
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


def summary_model(left, nn, t0, keep, tprice, rp, t0_addr, keep_addr,
                  NT=256):
    """``summary_row`` of one lane on simulated addresses of its t0 row
    and keep row: each of NT threads sums its leftover rows and takes
    units tid, tid + NT, ... of the row (the head, then 16-byte spans;
    a full span of t0 by one 16-byte load, of keep by one where keep
    shares t0's address mod 16, by four 4-byte loads where it shares it
    mod 4, bytes otherwise), counting the types on and reading their
    prices; the warps' sums and minima, then thread 0 over the warps.
    Checks that every type is taken once, every wide load is aligned to
    its width and a price is read only for a type that is on. Returns
    (the [5] row, units whose keep span took one 16-byte load)."""
    T = len(t0)
    h = min((16 - t0_addr % 16) % 16, T)
    kal = (keep_addr + h) % 16
    seen = np.zeros(T, np.int64)
    priced = np.zeros(T, np.int64)
    lefts, cnts, mps, nvec = [], [], [], 0
    for tid in range(NT):
        lsum = sum(int(x) for x in left[tid::NT])
        cnt, mp = 0, _I64_MAX
        for u in range(tid, T // 16 + 2, NT):
            lo = 0 if u == 0 else h + 16 * (u - 1)
            hi = h if u == 0 else min(lo + 16, T)
            if lo >= hi:
                continue
            if hi - lo == 16:
                assert (t0_addr + lo) % 16 == 0
                width = 16 if kal == 0 else 4 if kal % 4 == 0 else 1
                assert (keep_addr + lo) % width == 0
                nvec += width == 16
            seen[lo:hi] += 1
            for i in range(lo, hi):
                if t0[i] and keep[i]:
                    cnt += 1
                    priced[i] += 1
                    mp = min(mp, int(tprice[i]))
        lefts.append(lsum)
        cnts.append(cnt)
        mps.append(mp)
    assert (seen == 1).all()
    assert np.array_equal(priced, (np.asarray(t0) & np.asarray(keep))
                          .astype(np.int64))
    warp_left = [_wrap(sum(lefts[w:w + 32])) for w in range(0, NT, 32)]
    warp_cnt = [sum(cnts[w:w + 32]) for w in range(0, NT, 32)]
    warp_mp = [min(mps[w:w + 32]) for w in range(0, NT, 32)]
    left_total = _wrap(sum(warp_left))
    flex, mp = sum(warp_cnt), min(warp_mp)
    if flex < T:
        mp = min(mp, BIG)      # a type that is off counts BIG
    minted = nn > 0
    min_price = mp if minted else 0
    row = [left_total, nn, flex if minted else 0, min_price,
           _wrap(int(rp) - (min_price if nn == 1 else 0))]
    return np.array(row, np.int64), nvec


def _summary_want(left, nn, types, keep, tprice, rp, E):
    """``_subset_summary_ref`` of one lane."""
    return ct._subset_summary_ref(
        torch.from_numpy(np.asarray(left, np.int64))[None],
        torch.tensor([[nn]], dtype=torch.int32),
        torch.from_numpy(types)[None], torch.from_numpy(keep)[None],
        torch.from_numpy(tprice), torch.tensor([rp], dtype=torch.int64),
        E)[0].numpy()


#: (leftovers, num_nodes, t0 and keep pattern, prices): no minted node,
#: one, two, leftovers wrapping past 2^63 over 128 rows, an empty t0,
#: every type on with prices past BIG
SUMMARY_CASES = {
    "none_minted": ([3, 4], 0, "mixed", "low"),
    "one_node": ([0], 1, "mixed", "low"),
    "two_nodes": ([5, 0, 7], 2, "mixed", "low"),
    "wrapping_leftover": ([1 << 62] * 127 + [-(1 << 61)], 1, "mixed",
                          "low"),
    "empty_t0": ([2], 1, "no_keep", "low"),
    "all_on_past_big": ([1], 2, "all_on", "past_big"),
}


@pytest.mark.parametrize("NT", [256, 512])
@pytest.mark.parametrize("case", list(SUMMARY_CASES))
@pytest.mark.parametrize("T", [812, 813, 29])
def test_summary_model_matches_plain(T, case, NT):
    """The model of the commit's summary tail at every offset of the t0
    row mod 16, keep at the row's alignment (16-byte loads), 4 bytes off
    it (4-byte loads) and 1 byte off (bytes), against
    ``_subset_summary_ref``."""
    left, nn, pattern, prices = SUMMARY_CASES[case]
    rng = np.random.RandomState(T + len(case) + NT)
    N, E = 5, 3
    types = rng.rand(N, T) < 0.5
    keep = rng.rand(T) < 0.6
    if pattern == "no_keep":
        keep[:] = False
    elif pattern == "all_on":
        types[E] = keep[:] = True
    tprice = rng.randint(1, 1 << 20, T).astype(np.int64)
    if prices == "past_big":
        tprice = BIG + 1 + rng.randint(0, 1 << 20, T).astype(np.int64)
    else:
        tprice[rng.rand(T) < 0.1] = BIG
    rp = int(rng.randint(0, 1 << 21))
    want = _summary_want(left, nn, types, keep, tprice, rp, E)
    vec_units = 0
    for off in range(16):
        for keep_off in (off, off + 4, off + 1):
            got, nvec = summary_model(left, nn, types[E], keep, tprice, rp,
                                      (1 << 30) + off,
                                      (1 << 29) + keep_off, NT)
            assert np.array_equal(got, want), (off, keep_off)
            vec_units += nvec
    if T >= 32:
        assert vec_units > 0
    if case == "wrapping_leftover":
        assert want[0] < 0      # the sum wrapped
    if case == "all_on_past_big":
        assert want[3] > BIG


@pytest.mark.parametrize("hazard", examples.SUBSET_HAZARDS)
def test_summary_model_on_subset_rounds_matches_jax(hazard):
    """Every lane of ``subset_case(hazard)`` at T = 813 and E = 37 (the
    lanes' t0 rows at many offsets mod 16 in a [B, N, T] carry, keep rows
    at others): the model's rows from the plain scan's leftovers and
    final carries equal the plain round's and the reference's
    ``subset_solve_kernel``'s."""
    import jax.numpy as jnp
    arena, tprice, lanes, st = examples.subset_case(
        hazard, examples.SUBSET_HAZARDS.index(hazard), T=813, Ep=37)
    inp = ft.kernel_inputs_from_numpy(arena, "cpu")
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    g = ct._subset_gather_ref(inp, t["gid"], t["n"], t["dead"], t["keep"])
    E, P, n_max = st["E"], st["P"], st["n_max"]
    N, T = E + n_max, tprice.size
    rows, offs = [], set()
    for b in range(lanes["gid"].shape[0]):
        _, left, final = ft._solve_scan_ref(ct.lane_inputs(g, b), n_max, E,
                                            P)
        t0_addr = (1 << 30) + (b * N + E) * T
        offs.add(t0_addr % 16)
        row, _ = summary_model(left.numpy(), int(final.num_nodes[0]),
                               final.types[E].numpy(), lanes["keep"][b],
                               tprice, lanes["removed_price"][b], t0_addr,
                               (1 << 29) + b * T, 256)
        rows.append(row)
    got = np.stack(rows)
    plain = ct._subset_solve_ref(inp, torch.from_numpy(tprice), t["gid"],
                                 t["n"], t["dead"], t["keep"],
                                 t["removed_price"], **st).numpy()
    a = arena
    ref = np.asarray(cj.subset_solve_kernel(*map(jnp.asarray, (
        a["A"], a["avail_zc"], tprice, a["R"], a["n"], a["F"], a["agz"],
        a["agc"], a["admit"], a["daemon"], a["ex_compat"], a["pool_types"],
        a["pool_agz"], a["pool_agc"], a["pool_limit"], a["pool_used0"],
        a["ex_alloc"], a["ex_used0"], lanes["gid"], lanes["n"],
        lanes["dead"], lanes["keep"], lanes["removed_price"])), **st))
    assert np.array_equal(got, plain) and np.array_equal(got, ref)
    assert len(offs) > 4


# ---------------------------------------------------------------------------
# the absorption scan's three K7 modes (consol_absorb, redesigned)
# ---------------------------------------------------------------------------

def _wrap_sum(xs) -> int:
    return _wrap(sum(int(x) for x in xs))


def prescreen_tail_model(left, gid, cid, R_tab, type_alloc, type_price,
                         tcompat, padmit, pool_types, cap) -> bool:
    """The kernel's pre-screen tail on one lane's leftovers: any_active
    and the pool flags by votes over the groups, the aggregate by wrapping
    (shared atomic) adds of leftover * R over every group whose leftover
    is not 0, then a thread a type."""
    active = left > 0
    any_active = bool(active.any())
    D = R_tab.shape[1]
    agg = [_wrap_sum(int(left[g]) * int(R_tab[gid[g], d])
                     for g in range(len(left)) if left[g] != 0)
           for d in range(D)]
    pok = [all(padmit[p, cid[g]] for g in range(len(left)) if active[g])
           for p in range(padmit.shape[0])]
    found = False
    for t in range(type_alloc.shape[0]):
        ok = type_price[t] < cap
        ok = ok and all(tcompat[cid[g], t] for g in range(len(left))
                        if active[g])
        ok = ok and all(agg[d] <= type_alloc[t, d] for d in range(D))
        pool = any(pok[p] and pool_types[p, t]
                   for p in range(padmit.shape[0]))
        found |= bool(ok and pool)
    return found or not any_active


def k7_model(mode, a, ps=None, NT=256, reg=True):
    """The three K7 modes by ``test_torch_k8.absorb_model``: shared
    tables a = (ex_alloc, ex_used0, compat_tab, R_tab, gid, cid, n, alive)
    (+ ps, the pre-screen's tables), or dense a = (ex_alloc, ex_used0,
    ex_compat, R, n)."""
    from tests.test_torch_k8 import absorb_model
    if mode == "dense":
        alloc, used, compat, R, n = a
        B = n.shape[0]
        with np.errstate(over="ignore"):
            return np.array([(absorb_model(alloc[b] - used[b], compat[b],
                                           R[b], n[b], NT, reg)[0] == 0).all()
                             for b in range(B)], bool)
    alloc, used, compat_tab, R_tab, gid, cid, n, alive = a
    B = n.shape[0]
    out = np.zeros(B, bool)
    with np.errstate(over="ignore"):
        slack = alloc - used
    for b in range(B):
        left, _ = absorb_model(slack, compat_tab[cid[b]] & alive[b][None],
                               R_tab[gid[b]], n[b], NT, reg)
        if mode == "deletions":
            out[b] = (left == 0).all()
        else:
            out[b] = prescreen_tail_model(left, gid[b], cid[b], R_tab,
                                          *ps[:5], ps[5][b])
    return out


def _k7_jax(mode, a, ps):
    import jax.numpy as jnp
    j = [jnp.asarray(x) for x in a]
    if mode == "deletions":
        return np.asarray(cj.deletions_feasible_kernel(*j))
    if mode == "dense":
        return np.asarray(cj.deletions_feasible_dense(*j))
    p = [jnp.asarray(x) for x in ps]
    return np.asarray(cj.replacements_prescreen_kernel(*j[:4], *p[:5],
                                                       *j[4:], p[5]))


def _k7_plain(mode, a, ps):
    t = [torch.from_numpy(x) for x in a]
    if mode == "deletions":
        return ct._deletions_feasible_ref(*t).numpy()
    if mode == "dense":
        return ct._deletions_feasible_dense_ref(*t).numpy()
    p = [torch.from_numpy(x) for x in ps]
    return ct._replacements_prescreen_ref(*t[:4], *p[:5], *t[4:],
                                          p[5]).numpy()


#: the model's (threads a CTA, rows in registers): the kernel's, and
#: counts that do not divide E = 37 or 300
K7_LAYOUTS = [(256, True), (256, False), (32, True), (96, False)]


@pytest.mark.parametrize("E", [37, 300])
@pytest.mark.parametrize("mode", ["deletions", "prescreen", "dense"])
@pytest.mark.parametrize("hazard", examples.ABSORB_HAZARDS)
def test_absorb_model_matches_plain_and_jax(hazard, mode, E):
    """Each K7 mode of the redesigned scan (k once a row, thread-owned
    slack, fp64 or floordiv_rcp quotients, the warp-then-CTA prefix, the
    take sums carried to the next group's barrier, the pre-screen tail by
    votes) equal to the plain version and the reference's kernel, at every
    hazard of
    ``ABSORB_HAZARDS`` (an all-zero R row wrapping the prefix, over-
    committed and dead nodes, padded lanes and groups, counts past the
    nodes)."""
    seed = examples.ABSORB_HAZARDS.index(hazard)
    B = 6
    a = (examples.dense_case if mode == "dense" else examples.absorb_case)(
        hazard, seed, B=B, E=E, G=5)
    ps = examples.prescreen_tables(seed, B=B) if mode == "prescreen" \
        else None
    want = _k7_plain(mode, a, ps)
    assert np.array_equal(want, _k7_jax(mode, a, ps))
    for NT, reg in K7_LAYOUTS:
        assert np.array_equal(k7_model(mode, a, ps, NT, reg), want), \
            (NT, reg)


@pytest.mark.parametrize("cut", ["G=0", "B=0", "E=0"])
@pytest.mark.parametrize("mode", ["deletions", "prescreen", "dense"])
def test_absorb_model_edges(mode, cut):
    """No groups (every lane feasible), no lanes (an empty answer), no
    nodes: the model, the plain version and the reference agree."""
    B, E, G = (0, 32, 4) if cut == "B=0" else (5, 0 if cut == "E=0" else
                                               32, 0 if cut == "G=0" else 4)
    mk = examples.dense_case if mode == "dense" else examples.absorb_case
    a = [np.ascontiguousarray(x) for x in mk("overcommitted", 3, B=max(B, 1),
                                               E=max(E, 1), G=max(G, 1))]
    ps = list(examples.prescreen_tables(3, B=max(B, 1)))
    ps[5] = ps[5][:B]
    if mode == "dense":        # ex_alloc, ex_used0 [B, E, D], ex_compat
        a = [a[0][:B, :E], a[1][:B, :E], a[2][:B, :G, :E], a[3][:B, :G],
             a[4][:B, :G]]
    else:
        a = [a[0][:E], a[1][:E], a[2][:, :E], a[3], a[4][:B, :G],
             a[5][:B, :G], a[6][:B, :G], a[7][:B, :E]]
    want = _k7_plain(mode, a, ps)
    assert want.shape == (B,)
    assert np.array_equal(want, _k7_jax(mode, a, ps))
    for NT, reg in K7_LAYOUTS:
        assert np.array_equal(k7_model(mode, a, ps, NT, reg), want), \
            (NT, reg)


@pytest.mark.parametrize("mode", ["deletions", "prescreen", "dense",
                                  "preempt"])
def test_absorb_scan_of_no_groups_is_the_references(mode):
    """G = 0 at B = 3: ``_absorb_scan`` answers leftover [B, 0] (the
    reference's ``lax.scan`` of no steps), and each plain entry built on
    it equals the reference's kernel called on the same inputs: every lane
    feasible (K7a-c), every lane's total 0 (K8)."""
    from karpenter_provider_aws_tpu.scheduling import preempt_jax as pj
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch \
        as pt
    import jax.numpy as jnp
    B, E, D = 3, 32, 8
    i64 = torch.int64
    left = ct._absorb_scan(torch.ones((1, E, D), dtype=i64),
                           torch.zeros((B, E, D), dtype=i64),
                           torch.zeros((B, 0, E), dtype=torch.bool),
                           torch.zeros((B, 0, D), dtype=i64),
                           torch.zeros((B, 0), dtype=i64))
    assert left.shape == (B, 0) and left.dtype == i64
    if mode == "preempt":
        t = list(examples.preempt_case("plain", 3, E=E, B=B))
        t[2], t[3], t[4] = t[2][:0], t[3][:0], t[4][:0]
        want = np.asarray(pj.preempt_solve_kernel(*map(jnp.asarray, t)))
        got = pt._preempt_solve_ref(*map(torch.from_numpy, t)).numpy()
        assert np.array_equal(want, np.zeros(B, np.int64))
    else:
        mk = examples.dense_case if mode == "dense" else examples.absorb_case
        a = list(mk("plain", 3, B=B, E=E, G=1))
        if mode == "dense":
            a[2], a[3], a[4] = a[2][:, :0], a[3][:, :0], a[4][:, :0]
        else:
            a[4], a[5], a[6] = a[4][:, :0], a[5][:, :0], a[6][:, :0]
        a = [np.ascontiguousarray(x) for x in a]
        ps = examples.prescreen_tables(3, B=B) if mode == "prescreen" \
            else None
        want = _k7_jax(mode, a, ps)
        got = _k7_plain(mode, a, ps)
        assert np.array_equal(want, np.ones(B, bool))
    assert got.dtype == want.dtype and np.array_equal(got, want)
