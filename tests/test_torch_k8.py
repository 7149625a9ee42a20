"""The absorption scan (K7a-c and K8: ``csrc/consolidation.cu``
``consol_absorb_kernel``) as the redesigned kernel computes it, held
against the plain versions and the reference package on the CPU.

The kernel runs a lane on one CTA of ``ABSORB_THREADS`` threads; thread
t owns the contiguous rows [t*chunk, (t+1)*chunk) (chunk = ceil(E /
threads)) and keeps their slack alloc - used to itself for the whole
scan. Per group it computes each owned row's k once: in form 0 (rows in
registers) as fp64 while every slack of the thread lies in (-2^51, 2^51)
(the nearest integer of slack * 1/R, corrected by the exact remainder;
the thread's rows turn int64 for good once a take meets a negative R),
else, and in forms 1 and 2, by ``floordiv_rcp`` (csrc/ffd_common.cuh:
an fp64 product and one correction each way below 2^52, the integer
division past it). It takes the warp's inclusive scan of its k sum,
publishes the warp total, passes ONE barrier and adds the earlier warps'
totals, then takes clip(n - cum, 0, k) row by row and subtracts take * R
from the slack. The take sums of group g ride group g + 1's barrier
(K7's leftover[g]; the last after the loop), or each thread sums its
takes over the whole scan and one reduction gives K8's sum n - sum
taken, all wrapping in 64 bits. ``absorb_model`` below is that
decomposition in numpy, warp by warp; it is held byte for byte to
``_absorb_scan`` through ``_preempt_solve_ref`` and to the reference's
``preempt_solve_kernel`` on every ``examples.PREEMPT_HAZARDS`` table, at
thread counts that do not divide E, with the fp64 rows (form 0) and
without (forms 1, 2) (tests/test_torch_k7.py does the same for the three
K7 modes). Both quotients are checked on negative slacks (over-committed
nodes), slacks and rows past 2^51 and 2^52, R = 1, and random pairs; the
cases cover the hazards: an all-zero R row whose k = BIG wraps the
prefix, over-committed nodes, padded lanes and rows, G = 0, B = 0 and E
not a multiple of 32. The launcher's form rule (``absorb_form``) is
checked on its table.

Tolerance: exact (int64 and bool).
"""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu.scheduling import preempt_jax as pj
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch as pt


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


BIG = 1 << 60
LIM51 = 1 << 51
LIM52 = 1 << 52
#: threads a CTA of the model's runs: the kernel's 256, and narrower
#: counts that do not divide the cases' E
THREADS = [256, 32, 64, 96]


def rcp(b: int) -> float:
    """A staged reciprocal: 1 / b rounded for 0 < b < 2^52, else 0."""
    return float(np.float64(1.0) / np.float64(b)) if 0 < b < LIM52 else 0.0


def quot_fp(a: int, b: int) -> int:
    """Form 0's fp64 quotient, floor(a / b) for b > 0 and |a| < 2^51: the
    nearest integer of a * rcp(b) (the fma onto the bias 2^52 + 2^51
    rounds the exact product once, half to even), then one correction
    each way by the exact remainder."""
    assert -LIM51 < a < LIM51
    q = round(Fraction(a) * Fraction(rcp(b)))
    e = a - q * b
    q += e >= b
    q -= e < 0
    return q


def floordiv_rcp(a: int, b: int) -> int:
    """``floordiv_rcp`` (csrc/ffd_common.cuh), b > 0: below 2^52 the floor
    of the rounded fp64 product a * rcp(b) and one correction each way by
    the remainder; the integer floor division past it."""
    if a <= -LIM52 or a >= LIM52 or b >= LIM52:
        return a // b
    q = math.floor(float(np.float64(a) * np.float64(rcp(b))))
    r = a - q * b
    q -= r < 0
    q += r >= b
    return q


def quot_fp_vec(a: np.ndarray, b: int) -> np.ndarray:
    """quot_fp over an int64 array (the entries within (-2^51, 2^51);
    others give garbage the caller masks): the nearest integer of the
    rounded product (within one of the kernel's), then the same
    corrections, so the same floor."""
    with np.errstate(all="ignore"):
        q = np.rint(a.astype(np.float64) * np.float64(rcp(b)))
        q = np.where(np.abs(q) < LIM52, q, 0).astype(np.int64)
        e = a - q * np.int64(b)
        return q + (e >= b) - (e < 0)


def floordiv_rcp_vec(a: np.ndarray, b: int) -> np.ndarray:
    """floordiv_rcp over an int64 array, b a scalar."""
    big = (a <= -LIM52) | (a >= LIM52) | (b >= LIM52)
    with np.errstate(all="ignore"):
        q = np.floor(a.astype(np.float64) * np.float64(rcp(b)))
        q = np.where(big, 0, q).astype(np.int64)
        r = a - q * np.int64(b)
        q = q - (r < 0) + (r >= b)
    return np.where(big, a // np.int64(b), q)


def _u(x):
    return np.asarray(x, dtype=np.int64).view(np.uint64)


def _i(x):
    return np.asarray(x, dtype=np.uint64).view(np.int64)


def absorb_model(slack0, compat, R, n, NT=256, reg=True):
    """One lane's scan as the kernel decomposes it: slack0 [E, D] int64
    (alloc - used at the start), compat [G, E] bool (compatible and
    alive), R [G, D], n [G]; NT threads, ``reg`` the rows in registers
    (form 0: a thread's quotients in fp64 while its slacks allow) or not
    (forms 1, 2: floordiv_rcp). Returns (leftover [G] int64 as K7 writes
    it, the K8 total sum n - sum taken). Sums and products wrap."""
    with np.errstate(over="ignore"):
        return _absorb_model(slack0, compat, R, n, NT, reg)


def _absorb_model(slack0, compat, R, n, NT, reg):
    E, D = slack0.shape
    G = R.shape[0]
    W = NT // 32                                    # warps a CTA
    chunk = -(-E // NT)
    # thread t's row r is node row t * chunk + r (where below E)
    e_of = np.arange(NT)[:, None] * chunk + np.arange(chunk)[None, :]
    present = e_of < E
    e_cl = np.minimum(e_of, max(E - 1, 0))
    s = np.zeros((NT, chunk, D), np.int64)          # the thread's slack
    s[present] = slack0[e_of[present]]
    # form 0: the threads whose every slack lies in (-2^51, 2^51) hold
    # their rows as fp64
    fp = np.all((s > -LIM51) & (s < LIM51), axis=(1, 2)) if reg \
        else np.zeros(NT, bool)
    left = np.zeros(G, np.int64)
    wt_carry = None                                 # the warps' take sums
    ttot = np.zeros(NT, np.uint64)
    nsum = np.uint64(0)
    for g in range(G):
        Rg = R[g]
        ng = np.int64(n[g])
        on = present & (compat[g][e_cl] if E else False)
        k_fp = np.full((NT, chunk), BIG, np.int64)
        k_int = np.full((NT, chunk), BIG, np.int64)
        for d in range(D):
            if Rg[d] <= 0:
                continue
            k_fp = np.minimum(k_fp, quot_fp_vec(s[:, :, d], int(Rg[d])))
            k_int = np.minimum(k_int, floordiv_rcp_vec(s[:, :, d],
                                                       int(Rg[d])))
        k = np.where(fp[:, None], k_fp, k_int)
        k = np.where(on, np.maximum(k, 0), 0)
        local = _u(k).sum(axis=1, dtype=np.uint64)  # [NT]
        # the warp scan, then one barrier: the earlier warps' totals
        incl = np.cumsum(local.reshape(W, 32), axis=1, dtype=np.uint64)
        wk = incl[:, 31]                            # [W]
        before_w = np.cumsum(wk, dtype=np.uint64) - wk
        cum = (before_w[:, None] + incl - local.reshape(W, 32)).reshape(NT)
        if wt_carry is not None:                    # group g - 1's leftover
            left[g - 1] = _i(_u(n[g - 1]) - wt_carry.sum(dtype=np.uint64))
        tsum = np.zeros(NT, np.uint64)
        took = np.zeros(NT, bool)
        for r in range(chunk):
            x = _i(_u(ng) - cum)
            x = np.maximum(x, 0)
            take = np.minimum(x, k[:, r])
            cum = cum + _u(k[:, r])
            with np.errstate(all="ignore"):
                s[:, r, :] = s[:, r, :] - take[:, None] * Rg[None, :]
            tsum = tsum + _u(take)
            took |= take != 0
        if (Rg < 0).any():                          # the rows to int64
            fp &= ~took
        # each warp's take sum, carried to the next group's barrier
        wt_carry = tsum.reshape(W, 32).sum(axis=1, dtype=np.uint64)
        ttot = ttot + tsum
        nsum = nsum + _u(ng)
    if G:
        left[G - 1] = _i(_u(n[G - 1]) - wt_carry.sum(dtype=np.uint64))
    fin = ttot.reshape(W, 32).sum(axis=1, dtype=np.uint64)
    total = _i(nsum - fin.sum(dtype=np.uint64))
    return left, int(total)


def preempt_model(ex_alloc, ex_used0, ex_compat, R, n, freed, NT=256,
                  reg=True):
    """K8 by ``absorb_model``: each lane's refunded start, its total."""
    B = freed.shape[0]
    out = np.zeros(B, np.int64)
    for b in range(B):
        with np.errstate(all="ignore"):
            used = np.maximum(ex_used0 - freed[b], 0)
            slack = ex_alloc - used
        out[b] = absorb_model(slack, ex_compat, R, n, NT, reg)[1]
    return out


#: the model's layouts: (threads, rows in registers)
LAYOUTS = [(nt, reg) for nt in THREADS for reg in (True, False)]


def _preempt_plain(t):
    return pt._preempt_solve_ref(*[torch.from_numpy(x) for x in t]).numpy()


def _preempt_jax(t):
    return np.asarray(pj.preempt_solve_kernel(*[jnp.asarray(x) for x in t]))


#: (numerator, divisor) pairs of the quotients: negative slacks, R = 1,
#: the edges of 2^51 and 2^52, R past them, slacks past them
QUOT_PAIRS = [
    (-1, 3), (-7, 7), (-(1 << 40) - 3, 5), (-5, 1), (0, 9), (17, 1),
    ((1 << 51) - 1, 1), ((1 << 51) - 1, 3), (-(1 << 51) + 1, 1),
    ((1 << 51) - 1, (1 << 51) - 1), (1 << 51, 3), (-(1 << 51), 3),
    ((1 << 52) - 1, 1), (-(1 << 52) + 1, 3), ((1 << 52) + 1, 7), (BIG, 5),
    (BIG + 11, 1 << 53), (-(1 << 62), 1 << 52), ((1 << 63) - 1, 2),
    (-(1 << 63), 3), (12345678901, (1 << 51) - 1), (12345678901, 1 << 51),
    (-12345678901, (1 << 51) + 1), (-12345678901, (1 << 52) - 1),
    (-1, 1 << 62), (0, 1 << 62),
    (3 * 7 * 11 * 13 * 17 * 19 * 23 * 29 * 31 * 37 - 1, 23)]


@pytest.mark.parametrize("a,b", QUOT_PAIRS)
def test_floordiv_rcp_is_floor(a, b):
    """The int64 rows' quotient (forms 1 and 2, and form 0 past 2^51 or
    after a negative R): exact on negative slacks, at R = 1, at the edges
    of 2^51 and 2^52, R past them (rb = 0) and slacks past them (the
    integer division)."""
    assert floordiv_rcp(a, b) == a // b
    got = floordiv_rcp_vec(np.array([a], np.int64), b)
    assert int(got[0]) == a // b


@pytest.mark.parametrize("a,b", [(a, b) for a, b in QUOT_PAIRS
                                 if -LIM51 < a < LIM51])
def test_fp_quotient_is_floor(a, b):
    """Form 0's fp64 quotient on the pairs within its range (|slack| <
    2^51): exact on negative slacks, at R = 1, at the edge of 2^51 and R
    past 2^51 and 2^52."""
    assert quot_fp(a, b) == a // b
    got = quot_fp_vec(np.array([a], np.int64), b)
    assert int(got[0]) == a // b


@pytest.mark.parametrize("seed", range(4))
def test_quotients_random(seed):
    """Random numerators below and around 2^51 and 2^52 over divisors from
    1 to past 2^52, held to Python's floor division, by the kernel's
    arithmetic (some) and by the vector forms (all): floordiv_rcp on
    every numerator, the fp64 quotient on those below 2^51."""
    rng = np.random.RandomState(seed)
    a = np.concatenate([
        rng.randint(-(1 << 20), 1 << 20, 200),
        rng.randint(-(1 << 53), 1 << 53, 200, dtype=np.int64),
        rng.randint(-(1 << 62), 1 << 62, 50, dtype=np.int64)])
    small = (a > -LIM51) & (a < LIM51)
    for b in (1, 2, 3, 7, 1 << 9, 999, (1 << 31) + 1, (1 << 51) + 9,
              (1 << 52) - 3, (1 << 52) + 5, 1 << 61):
        want = np.array([int(x) // b for x in a], np.int64)
        assert np.array_equal(floordiv_rcp_vec(a, b), want), b
        assert np.array_equal(quot_fp_vec(a, b)[small], want[small]), b
        assert all(floordiv_rcp(int(x), b) == int(x) // b
                   for x in a[::9]), b
        assert all(quot_fp(int(x), b) == int(x) // b
                   for x in a[small][::9]), b


@pytest.mark.parametrize("hazard", examples.PREEMPT_HAZARDS)
def test_preempt_model_matches_plain_and_jax(hazard):
    """K8's redesigned scan, at every layout of ``LAYOUTS``, equal to the
    plain version and to the reference's kernel on each hazard table (E =
    37: no thread count divides it; wide_e at 4,096)."""
    E = 4096 if hazard == "wide_e" else 37
    t = examples.preempt_case(hazard, 1, E=E)
    want = _preempt_plain(t)
    assert np.array_equal(want, _preempt_jax(t))
    for NT, reg in LAYOUTS:
        assert np.array_equal(preempt_model(*t, NT=NT, reg=reg), want), \
            (NT, reg)


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_preempt_model_past_2_51(seed, small):
    """Slacks and R past 2^51 (floordiv_rcp's integer division), or small
    slacks with R past 2^51 and a negative R (the fp64 rows turned int64),
    R = 1, over-committed rows and refunds: the model equals the plain
    version and the reference."""
    t = examples.preempt_wide_values(seed, small=small)
    want = _preempt_plain(t)
    assert np.array_equal(want, _preempt_jax(t))
    for NT, reg in LAYOUTS[:4]:
        assert np.array_equal(preempt_model(*t, NT=NT, reg=reg), want)


@pytest.mark.parametrize("cut", ["G=0", "B=0", "E=0", "E=33"])
def test_preempt_model_edges(cut):
    """No groups (every lane 0), no lanes ([0]), no nodes (every pod left)
    and 33 nodes (one warp and one row over)."""
    t = list(examples.preempt_case("zero_r_row", 2, E=33 if cut == "E=33"
                                   else 32))
    if cut == "G=0":
        t[2], t[3], t[4] = t[2][:0], t[3][:0], t[4][:0]
    elif cut == "B=0":
        t[5] = t[5][:0]
    elif cut == "E=0":
        t[0], t[1], t[2] = t[0][:0], t[1][:0], t[2][:, :0]
        t[5] = t[5][:, :0]
    want = _preempt_plain(t)
    assert np.array_equal(want, _preempt_jax(t))
    for NT, reg in LAYOUTS:
        got = preempt_model(*t, NT=NT, reg=reg)
        assert got.shape == want.shape and np.array_equal(got, want)


def test_zero_r_row_wraps_the_prefix():
    """An all-zero R row compatible everywhere: k = BIG on every node, so
    the exclusive prefix passes 2^63 by the eighth row and wraps; the
    model's per-warp partial sums wrap the same way."""
    t = examples.preempt_case("zero_r_row", 0, E=300)
    k_rows = int(t[2][0].sum())
    assert k_rows * BIG >= 1 << 63
    want = _preempt_plain(t)
    for NT, reg in LAYOUTS:
        assert np.array_equal(preempt_model(*t, NT=NT, reg=reg), want)


@pytest.mark.parametrize("E,D,want", [
    (0, 8, 0), (1, 6, 0), (1000, 6, 0), (1024, 8, 0), (1025, 8, 1),
    (1500, 6, 1), (32, 9, 1), (1100, 8, 1), (2048, 8, 1), (2049, 8, 2),
    (4096, 8, 2), (4096, 4, 1), (4097, 4, 2)])
def test_absorb_form_rule(E, D, want):
    """Rows in registers at up to 4 a thread of at most 8 dims, in shared
    memory while a lane's rows fit ABSORB_SMEM_MAX, else global."""
    assert cc.absorb_form(E, D) == want
    if want:
        assert (8 * cc.absorb_row_words(E, D) <= cc.ABSORB_SMEM_MAX) \
            == (want == 1)
