"""The checkpoint bank's store (K3) as the chunk entry's
``ffd_slot_headroom`` launch does it, held against the plain store and
the reference package on the CPU.

``csrc/ffd_scan.cu`` ``ffd_slot_headroom_kernel`` given a bank row copies
the working carry into it with every thread of its grid
(``csrc/ffd_common.cuh`` ``bank_copy_plan`` / ``bank_copy_load``): each of
the carry's eight fields is cut into units, where the field's carry and
its bank row share their address mod 16 the bytes before the row's first
16-byte boundary, its 16-byte words and the bytes after them, any other
field byte by byte; thread i of S takes units i, i + S, ... Here a plain
model of that decomposition, on simulated addresses (bank rows of bool
planes of odd widths start at every offset mod 16; carries at aligned
and at shifted addresses), writes the bank row and checks that every
byte of every field is written once, whole, with each 16-byte unit on
16-byte boundaries of both sides, and equal to ``_bank_store_ref``: T =
813, 812 and 9, Z = 3, D = 7, N odd and even, 1 to 5 CTAs of 256 threads
and more threads than units.

The same plan run the other way (``bank_copy_plan(..., to_bank=false)``)
is the suffix re-solve's load of bank row jr into the working carry, made
by the copy blocks of its first launch (``csrc/packed_io.cu``
``unpack_bits_load``): the model of the reversed copy is held to
``bank_row`` at the same shapes, and the model of that whole launch (its
unpack blocks first, then its copy blocks, each block one or the other)
writes every byte of the bool plane and of the carry once, reads only the
arena's words and row jr, and writes none of what it reads.

The suffix's pad re-stamp rides its last launch, ``pack_outputs``
(``csrc/packed_io.cu`` ``store_unit``): copy blocks after the pack's,
every bank row [j, j + count) cut at its own 16-byte boundaries (row j +
r starts (j + r) * row_bytes past the field's row 0, so the cut moves
from row to row), the same units in every row (the head, then a unit a
16-byte span, n / 16 + 2 a field, the spare ones empty), a full span by
one 16-byte load and store where the carry and the row share their
address mod 16, bytes otherwise. Its model writes 1 to 3 rows at every
shift of the carry mod 16, odd-width bool planes among them: every byte
of the rows once, the other rows untouched, equal to ``_bank_store_ref``.

Then the two solves in the kernels' order (``ffd_cuda.entry_row``: the
checkpointed solve stores every chunk entry's carry from its headroom
launch, the suffix re-solve unpacks the arena and loads row jr in one
launch, stores nothing at its first group and every later chunk entry
from its headroom, and re-stamps its pad chunks in its pack's launch),
built from the plain group step and the models of the store, the
prologue and the pack with its re-stamp, are held byte for byte to the
reference's ``solve_scan_packed1_ckpt`` and ``solve_scan_suffix``: every
live bound GL and every SUF at CK = 2 and 4, with and without pad
chunks; the suffix leaves row jr's bytes as they were.

Tolerance: exact (integer and bool bytes).
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _example_arrays
from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu.ops import hostpack as hp_jax
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
from karpenter_provider_aws_tpu_torch.ops.hostpack import (in_layout_bool,
                                                           in_layout_i64,
                                                           layout_sizes)


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the folded copy on simulated addresses
# ---------------------------------------------------------------------------

def copy_plan(carry, bank0, row_bytes, j, to_bank=True):
    """``bank_copy_plan``: per field (src, dst, head, nv, end), from the
    carry's addresses into bank row j (``to_bank``) or from row j into the
    carry."""
    out, acc = [], 0
    for c, b0, n in zip(carry, bank0, row_bytes):
        s, d = (c, b0 + j * n) if to_bank else (b0 + j * n, c)
        h, nv = n, 0
        if (d - s) % 16 == 0:
            h = min((16 - d % 16) % 16, n)
            nv = (n - h) // 16
        acc += n - 15 * nv
        out.append((s, d, h, nv, acc))
    return out


def copy_unit(plan, u):
    """``bank_copy_load``: (field, byte offset, width) of unit u, or None
    past the copy's end."""
    if u >= plan[-1][4]:
        return None
    f = 0
    while plan[f][4] <= u:
        f += 1
    r = u - (plan[f - 1][4] if f else 0)
    _, _, h, nv, _ = plan[f]
    if h <= r < h + nv:
        return f, h + 16 * (r - h), 16
    return f, (r if r < h else r + 15 * nv), 1


def fold_store(bank_bytes, carry_bytes, j, S, src, dst0, to_bank=True):
    """The copy of the carry into bank row j (``to_bank``; or of row j
    into the carry) as a launch's S threads make it: thread u0 takes units
    u0, u0 + S, ... (the headroom's store loads its first unit before its
    CTA's work and stores it after). Writes ``bank_bytes`` (per field,
    [rows * row bytes] uint8) or ``carry_bytes`` and returns the count of
    writes of each byte of the destination, per field. ``src`` / ``dst0``
    are the carry's and the bank's simulated addresses."""
    row_bytes = [c.size for c in carry_bytes]
    plan = copy_plan(src, dst0, row_bytes, j, to_bank)
    total = plan[-1][4]
    hits = [np.zeros(n, np.int64) for n in row_bytes]
    for u0 in range(min(S, total)):
        for u in range(u0, total, S):
            f, off, w = copy_unit(plan, u)
            s, d = plan[f][0], plan[f][1]
            if w == 16:
                assert (s + off) % 16 == 0 and (d + off) % 16 == 0
            n = row_bytes[f]
            assert 0 <= off and off + w <= n
            row = slice(j * n + off, j * n + off + w)
            if to_bank:
                bank_bytes[f][row] = carry_bytes[f][off:off + w]
            else:
                carry_bytes[f][off:off + w] = bank_bytes[f][row]
            hits[f][off:off + w] += 1
    return hits


def _bytes(t):
    return t.contiguous().numpy().reshape(-1).view(np.uint8).copy()


def _random_carry(rng, N, T, Z, C, D, P):
    b = torch.bool
    return ft.Carry(
        used=torch.from_numpy(rng.randint(-(1 << 40), 1 << 40, (N, D))),
        types=torch.from_numpy(rng.rand(N, T) < 0.5).to(b),
        zones=torch.from_numpy(rng.rand(N, Z) < 0.5).to(b),
        ct=torch.from_numpy(rng.rand(N, C) < 0.5).to(b),
        pool=torch.from_numpy(rng.randint(-2, P, N).astype(np.int32)),
        alive=torch.from_numpy(rng.rand(N) < 0.5).to(b),
        num_nodes=torch.tensor([int(rng.randint(0, N))], dtype=torch.int32),
        pool_used=torch.from_numpy(rng.randint(0, 1 << 40, (P, D))))


#: (T, N, Z, C, D, P): the catalog's widths (813, 812), a narrow one, N
#: odd and even
COPY_SHAPES = [(813, 13, 3, 2, 7, 2), (812, 13, 3, 2, 7, 1),
               (812, 16, 3, 2, 8, 1), (9, 17, 3, 2, 7, 1),
               (9, 4, 3, 1, 7, 3)]


@pytest.mark.parametrize("shift", [0, 1, 8])
@pytest.mark.parametrize("ctas", [1, 3, 10_000])
@pytest.mark.parametrize("shape", COPY_SHAPES)
def test_folded_copy_model_matches_bank_store(shape, ctas, shift):
    """Every bank row j of five, written by the model of the headroom's
    copy: each field's row bytes written once, whole, equal to
    ``_bank_store_ref``; the other rows untouched. ``shift`` moves every
    carry field off its 256-byte boundary (a view), ``ctas`` sets the
    grid (256 threads a CTA; 10,000 CTAs: more threads than units)."""
    T, N, Z, C, D, P = shape
    rng = np.random.RandomState(T + N + ctas + shift)
    carry = _random_carry(rng, N, T, Z, C, D, P)
    rows = 5
    bank = fc.empty_bank(carry, rows)
    for b in bank:
        b.zero_()
    want = ft.Carry(*[b.clone() for b in bank])
    carry_bytes = [_bytes(c) for c in carry]
    bank_bytes = [_bytes(b) for b in bank]
    base = 1 << 30
    src = [base + (f + 1) * (1 << 24) + shift * (f + 1) for f in range(8)]
    dst0 = [base + (f + 9) * (1 << 24) for f in range(8)]
    S = 256 * ctas
    vec = 0
    for j in (3, 0, 4, 1, 2):
        hits = fold_store(bank_bytes, carry_bytes, j, S, src, dst0)
        ft._bank_store_ref(want, carry, j)
        for nm, h in zip(ft.Carry._fields, hits):
            assert (h == 1).all(), (j, nm)
        for nm, got, w in zip(ft.Carry._fields, bank_bytes, want):
            assert np.array_equal(got, _bytes(w)), (j, nm)
        plan = copy_plan(src, dst0, [c.size for c in carry_bytes], j)
        vec += sum(p[3] for p in plan)
    if shift == 0:
        # the aligned carry moves most of its bytes in 16-byte units
        assert 16 * vec > sum(c.size for c in carry_bytes)


@pytest.mark.parametrize("shift", [0, 1, 8])
@pytest.mark.parametrize("ctas", [1, 3, 10_000])
@pytest.mark.parametrize("shape", COPY_SHAPES)
def test_reversed_copy_model_matches_bank_row(shape, ctas, shift):
    """Bank row j of five into the working carry by the model of the
    reversed plan (the prologue's copy blocks): every byte of every carry
    field written once, whole, equal to ``bank_row``; the bank untouched.
    ``shift`` moves every carry field off its 256-byte boundary,
    ``ctas`` sets the copy blocks (10,000: more threads than units)."""
    T, N, Z, C, D, P = shape
    rng = np.random.RandomState(T + N + ctas + shift + 1)
    rows = 5
    carries = [_random_carry(rng, N, T, Z, C, D, P) for _ in range(rows)]
    bank = ft.Carry(*[torch.cat([c[i].reshape(
        (1,) + (() if nm == "num_nodes" else tuple(c[i].shape)))
        for c in carries]) for i, nm in enumerate(ft.Carry._fields)])
    bank_bytes = [_bytes(b) for b in bank]
    before = [b.copy() for b in bank_bytes]
    base = 1 << 30
    src = [base + (f + 1) * (1 << 24) + shift * (f + 1) for f in range(8)]
    dst0 = [base + (f + 9) * (1 << 24) for f in range(8)]
    vec = 0
    for j in (3, 0, 4, 1, 2):
        carry_bytes = [np.full(_bytes(c).size, 0xA5, np.uint8)
                       for c in carries[0]]
        hits = fold_store(bank_bytes, carry_bytes, j, 256 * ctas, src, dst0,
                          to_bank=False)
        want = ft.bank_row(bank, j)
        for nm, h, got, w in zip(ft.Carry._fields, hits, carry_bytes, want):
            assert (h == 1).all(), (j, nm)
            assert np.array_equal(got, _bytes(w)), (j, nm)
        plan = copy_plan(src, dst0, [c.size for c in carry_bytes], j, False)
        vec += sum(p[3] for p in plan)
    for got, b in zip(bank_bytes, before):
        assert np.array_equal(got, b)
    if shift == 0:
        assert 16 * vec > sum(c.size for c in carry_bytes)


def test_copy_plan_cuts_by_relative_alignment():
    """A field whose carry and bank row differ mod 16 goes byte by byte;
    one that agrees takes a head up to the row's first boundary, its
    words and a tail."""
    # row 1 of field 0 at 8192 + 813 (13 mod 16), its carry at 13 mod 16;
    # row 1 of field 1 at 8192 + 40 (8 mod 16), its carry at 3 mod 16
    p = copy_plan([4096 + 13, 4096 + 3], [8192, 8192], [813, 40], 1)
    assert p[0][2:4] == (3, 50)
    assert p[1][2:4] == (40, 0)
    assert p[-1][4] == 813 - 15 * 50 + 40
    units = [copy_unit(p, u) for u in range(p[-1][4])]
    assert [x for x in units if x[2] == 16][0] == (0, 3, 16)
    assert copy_unit(p, p[-1][4]) is None


# ---------------------------------------------------------------------------
# the pad re-stamp in the pack's launch, on simulated addresses
# ---------------------------------------------------------------------------

#: ``pack_outputs``' threads a CTA (csrc/packed_io.cu kThreads)
PACK_THREADS = 256


def row_store_end(row_bytes):
    """``RowStore.end``: each field's units in any row (``row_units``: n
    // 16 + 2), cumulated."""
    end, acc = [], 0
    for n in row_bytes:
        acc += n // 16 + 2
        end.append(acc)
    return end


def store_unit(src, dst0, row_bytes, end, j, count, u):
    """``store_unit``: (row r, field, byte offset, width, 16-byte move) of
    unit u of the re-stamp of rows [j, j + count), or None for a spare
    unit or one past the rows."""
    R = end[-1]
    r = u // R
    if r >= count:
        return None
    x = u - r * R
    f = 0
    while end[f] <= x:
        f += 1
    k = x - (end[f - 1] if f else 0)
    n = row_bytes[f]
    d = dst0[f] + (j + r) * n
    h = min((16 - d % 16) % 16, n)
    lo = 0 if k == 0 else h + 16 * (k - 1)
    hi = h if k == 0 else min(lo + 16, n)
    if lo >= hi:
        return None
    return r, f, lo, hi - lo, hi - lo == 16 and (d - src[f]) % 16 == 0


def restamp(bank_bytes, carry_bytes, j, count, src, dst0, pb=0):
    """The re-stamp's blocks [pb, pb + Bs) of a pack launch, a unit a
    thread: writes rows [j, j + count) of ``bank_bytes`` from
    ``carry_bytes`` and returns (per field the count of writes of each
    bank byte, 16-byte moves, the (address, width) spans read and
    written)."""
    row_bytes = [c.size for c in carry_bytes]
    end = row_store_end(row_bytes)
    blocks = -(-count * end[-1] // PACK_THREADS)
    hits = [np.zeros(b.size, np.int64) for b in bank_bytes]
    vec, reads, writes = 0, [], []
    for b in range(pb, pb + blocks):
        for t in range(PACK_THREADS):
            x = store_unit(src, dst0, row_bytes, end, j, count,
                           (b - pb) * PACK_THREADS + t)
            if x is None:
                continue
            r, f, off, w, v = x
            at = (j + r) * row_bytes[f] + off
            if v:
                assert (dst0[f] + at) % 16 == 0
                assert (src[f] + off) % 16 == 0
                vec += 1
            bank_bytes[f][at:at + w] = carry_bytes[f][off:off + w]
            hits[f][at:at + w] += 1
            reads.append((src[f] + off, w))
            writes.append((dst0[f] + at, w))
    return hits, vec, reads, writes


@pytest.mark.parametrize("shift", range(16))
@pytest.mark.parametrize("shape", COPY_SHAPES)
def test_restamp_model_matches_bank_store(shape, shift):
    """1, 2 and 3 bank rows from row j of six, re-stamped by the model of
    the pack's copy blocks with every carry field ``shift`` bytes past a
    16-byte boundary (so every carry-to-row shift mod 16 across the
    shapes' odd-width rows): each byte of the rows written once, the
    other rows untouched, the bank equal to ``_bank_store_ref``; a row
    that agrees with the carry mod 16 moves in 16-byte units."""
    T, N, Z, C, D, P = shape
    rng = np.random.RandomState(T + N + shift)
    carry = _random_carry(rng, N, T, Z, C, D, P)
    rows = 6
    base = 1 << 30
    src = [base + (f + 1) * (1 << 24) + shift for f in range(8)]
    dst0 = [base + (f + 9) * (1 << 24) for f in range(8)]
    carry_bytes = [_bytes(c) for c in carry]
    row_bytes = [c.size for c in carry_bytes]
    for count in (1, 2, 3):
        for j in sorted({0, 1, rows - count}):
            bank = fc.empty_bank(carry, rows)
            for b in bank:
                b.fill_(0x5A)
            want = ft.Carry(*[b.clone() for b in bank])
            ft._bank_store_ref(want, carry, j, count)
            bank_bytes = [_bytes(b) for b in bank]
            hits, vec, _, _ = restamp(bank_bytes, carry_bytes, j, count,
                                      src, dst0, pb=3)
            for nm, h, n, got, w in zip(ft.Carry._fields, hits, row_bytes,
                                        bank_bytes, want):
                inside = np.zeros(h.size, bool)
                inside[j * n:(j + count) * n] = True
                assert (h[inside] == 1).all(), (count, j, nm)
                assert (h[~inside] == 0).all(), (count, j, nm)
                assert np.array_equal(got, _bytes(w)), (count, j, nm)
            aligned = sum(n // 16 - 1 for r in range(j, j + count)
                          for n, s0, d0 in zip(row_bytes, src, dst0)
                          if (d0 + r * n - s0) % 16 == 0 and n >= 32)
            assert vec >= aligned


def test_restamp_units_cut_each_row_at_its_own_boundaries():
    """A 40-byte field whose rows start at 8 mod 16 in odd rows: row 1's
    head is 8 bytes, its spans [8, 24) and [24, 40), the unit after them
    spare; row 0 (aligned) has no head and three spans, the last 8
    bytes; a carry at 8 mod 16 moves row 1's spans in 16-byte units and
    row 0's bytewise."""
    src, dst0, rb = [8], [0], [40]
    end = row_store_end(rb)
    assert end == [4]
    units = [store_unit(src, dst0, rb, end, 0, 2, u) for u in range(8)]
    assert units[:4] == [None, (0, 0, 0, 16, False), (0, 0, 16, 16, False),
                         (0, 0, 32, 8, False)]
    assert units[4:] == [(1, 0, 0, 8, False), (1, 0, 8, 16, True),
                         (1, 0, 24, 16, True), None]
    assert store_unit(src, dst0, rb, end, 0, 2, 8) is None


# ---------------------------------------------------------------------------
# the two solves in the kernels' order against the reference
# ---------------------------------------------------------------------------

G = 8


def _case(T=9, D=7):
    """(packed arena, statics) of the existing-nodes case at odd widths
    (N = 17)."""
    arrays, st = examples.example_case("existing", base=_example_arrays,
                                       G=G, T=T, D=D, n_max=12)
    return arrays, st


def _arena(arrays, st, GL):
    a = dict(arrays, n=arrays["n"].copy())
    a["n"][GL:] = 0
    return hp_jax.pack_inputs1(a, *examples.pack_statics(st))


def _inputs(buf, st):
    return ft._packed_inputs_ref(torch.from_numpy(buf), *(
        st[k] for k in "T D Z C G E P K M Q".split()))


#: simulated addresses of the carry and the bank, and the headroom's
#: threads (three CTAs)
_SRC = [(1 << 30) + (f + 1) * (1 << 24) for f in range(8)]
_DST = [(1 << 30) + (f + 9) * (1 << 24) for f in range(8)]
_S = 768


def _store(bank, carry, j):
    """Bank row j written from ``carry`` by the model of the headroom's
    copy (in place)."""
    cb = [_bytes(c) for c in carry]
    bb = [_bytes(b) for b in bank]
    fold_store(bb, cb, j, _S, _SRC, _DST)
    for b, x in zip(bank, bb):
        b.copy_(torch.from_numpy(x.view(b.numpy().dtype)).reshape(b.shape))


def ckpt_in_kernel_order(inp, st, CK):
    """The checkpointed solve as the card runs it: per group the
    headroom, which stores the chunk entry's carry (``entry_row``), then
    the commit; no ``ffd_bank_store``. (output buffer, bank)."""
    E, P, V = st["E"], st["P"], st["V"]
    carry = ft.carry0(inp, E + st["n_max"], E)
    bank = fc.empty_bank(carry, G // CK)
    takes, lefts = [], []
    for g in range(G):
        j = fc.entry_row(g, 0, CK, 0, False)
        if j >= 0:
            _store(bank, carry, j)
        carry, take, n_rem = ft._group_step_ref(inp, carry, g, E=E, P=P,
                                                V=V)
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
    return ft._pack_outputs_ref(torch.stack(takes), torch.cat(lefts),
                                carry), bank


#: simulated addresses of the arena's bool words and of the bool plane
_WORDS, _PLANE = 1 << 29, (1 << 29) + (1 << 27) + 3


def prologue(buf, st, bank, j):
    """The suffix's first launch (``unpack_bits_load``) as its grid runs
    it: blocks [0, Bu) the unpack's units (``test_torch_k1``'s model),
    then the copy blocks, one unit a thread, of bank row j into the
    working carry (the reversed plan), each block wholly one or the other.
    Checks that every byte of the plane and of the carry is written once
    and that nothing written is read in the launch; returns (bool plane,
    carry)."""
    from tests.test_torch_k1 import UNPACK_THREADS, unpack_blocks, \
        unpack_unit
    T, D, Z, C, G_, E, P = (st[k] for k in "T D Z C G E P".split())
    K, M, Q = st["K"], st["M"], st["Q"]
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G_, E, P, K, M, 1, Q))
    nbits = layout_sizes(in_layout_bool(T, D, Z, C, G_, E, P, K, M, 1, Q))
    words = buf[n_i64:]
    assert words.size == -(-nbits // 64)
    bank_bytes = [_bytes(b) for b in bank]
    rows = [b.shape[0] for b in bank]
    row_bytes = [bb.size // r for bb, r in zip(bank_bytes, rows)]
    carry_bytes = [np.full(n, 0xA5, np.uint8) for n in row_bytes]
    plan = copy_plan(_SRC, _DST, row_bytes, j, to_bank=False)
    bu = unpack_blocks(nbits)
    blocks = bu + -(-plan[-1][4] // UNPACK_THREADS)
    plane = np.zeros(nbits, np.uint8)
    seen = np.zeros(nbits, np.int64)
    hits = [np.zeros(n, np.int64) for n in row_bytes]
    reads, writes = [], []
    for b in range(blocks):
        for t in range(UNPACK_THREADS):
            if b < bu:
                q = []
                x = unpack_unit(words, 0, nbits, _PLANE,
                                b * UNPACK_THREADS + t, q)
                reads += [(_WORDS + 8 * w, 8) for w in q]
                if x is None:
                    continue
                s, vals, _ = x
                plane[s:s + len(vals)] = vals
                seen[s:s + len(vals)] += 1
                writes.append((_PLANE + s, len(vals)))
                continue
            u = (b - bu) * UNPACK_THREADS + t
            x = copy_unit(plan, u)
            if x is None:
                continue
            f, off, w = x
            carry_bytes[f][off:off + w] = \
                bank_bytes[f][j * row_bytes[f] + off:][:w]
            hits[f][off:off + w] += 1
            reads.append((plan[f][0] + off, w))
            writes.append((plan[f][1] + off, w))
    assert (seen == 1).all() and all((h == 1).all() for h in hits)
    spans = sorted([(a, a + n, "r") for a, n in reads]
                   + [(a, a + n, "w") for a, n in writes])
    for (a0, a1, k0), (b0, b1, k1) in zip(spans, spans[1:]):
        assert b0 >= a1 or k0 == k1, "the launch reads what it writes"
    carry = ft.Carry(*[torch.from_numpy(x.view(
        b.numpy().dtype)).reshape((1,) if nm == "num_nodes" else
                                  tuple(b.shape[1:]))
        for nm, x, b in zip(ft.Carry._fields, carry_bytes, bank)])
    return torch.from_numpy(plane.astype(bool)), carry


def pack_launch(takes, lefts, carry, bank, j, count):
    """The suffix's last launch as its grid runs it: the pack's blocks
    (``test_torch_k1``'s model of the row, from the carry's own
    addresses), then, with count > 0, the re-stamp's blocks of bank rows
    [j, j + count) (``restamp`` at the simulated addresses of the carry
    and the bank). Checks that the re-stamp reads only the carry, which
    the launch does not write, and writes only rows [j, j + count);
    returns the output row and writes the rows in place."""
    from tests.test_torch_k1 import pack_model
    src = fc.pack_sources(takes[None], lefts[None],
                          ft.Carry(*[f[None] for f in carry]))
    out, _, _ = pack_model(src)
    if count:
        carry_bytes = [_bytes(c) for c in carry]
        bank_bytes = [_bytes(b) for b in bank]
        hits, _, reads, _ = restamp(bank_bytes, carry_bytes, j, count,
                                    _SRC, _DST)
        for a, n in reads:
            assert any(c <= a and a + n <= c + cb.size
                       for c, cb in zip(_SRC, carry_bytes))
        for h, cb in zip(hits, carry_bytes):
            n = cb.size
            assert (h[j * n:(j + count) * n] == 1).all()
            assert h[:j * n].sum() == h[(j + count) * n:].sum() == 0
        for b, x in zip(bank, bank_bytes):
            b.copy_(torch.from_numpy(x.view(b.numpy().dtype)).reshape(
                b.shape))
    return torch.from_numpy(out[0])


def suffix_in_kernel_order(buf, st, bank, CK, SUF, GL):
    """The suffix re-solve as the card runs it: one launch that unpacks
    the arena and loads row jr (``prologue``), per group of the window
    the headroom (storing every later chunk entry) and the commit, then
    the pack, whose launch also re-stamps the pad chunks when there are
    any (``pack_launch``). (output buffer, bank spliced in place, packs
    that carried a re-stamp)."""
    E, P, V = st["E"], st["P"], st["V"]
    NC, jr, s0 = G // CK, GL // CK - SUF, GL - SUF * CK
    bools, carry = prologue(buf, st, bank, jr)
    for nm, got, w in zip(ft.Carry._fields, carry, ft.bank_row(bank, jr)):
        assert torch.equal(got, w), nm
    n_i64 = buf.size - -(-bools.numel() // 64)
    inp = ft._unpack_inputs(torch.from_numpy(buf[:n_i64]), bools, *(
        st[k] for k in "T D Z C G E P K M".split()), 1, st["Q"])
    takes, lefts, stores = [], [], 0
    for g in range(s0, GL):
        j = fc.entry_row(g, s0, CK, jr, True)
        if j >= 0:
            _store(bank, carry, j)
        carry, take, n_rem = ft._group_step_ref(inp, carry, g, E=E, P=P,
                                                V=V)
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
    count = NC - GL // CK
    out = pack_launch(torch.stack(takes), torch.cat(lefts), carry, bank,
                      GL // CK, count)
    assert torch.equal(out, ft._pack_outputs_ref(torch.stack(takes),
                                                 torch.cat(lefts), carry))
    return out, bank, int(count > 0)


def _jax_bank(bank):
    return [np.asarray(f).reshape(-1) for f in bank]


def _assert_bank(got, want, what):
    for nm, g, w in zip(ft.Carry._fields, got, want):
        assert np.array_equal(g.numpy().reshape(-1), w), (what, nm)


@pytest.mark.parametrize("CK", [2, 4])
def test_kernel_order_solves_match_reference(CK):
    """Every GL and SUF of a G = 8 arena at CK: the checkpointed solve and
    each suffix in the kernels' order, byte for byte against the
    reference's ``solve_scan_packed1_ckpt`` and ``solve_scan_suffix``
    (output and bank); row jr unchanged by the tick; the pack re-stamps
    the pad chunks where GL < G, nothing at GL = G."""
    arrays, st = _case()
    ss = examples.solve_statics(st)
    assert (st["E"] + st["n_max"]) % 2 == 1      # N odd
    pads = set()
    for GL in range(CK, G + 1, CK):
        buf = _arena(arrays, st, GL)
        inp = _inputs(buf, st)
        out, bank = ckpt_in_kernel_order(inp, st, CK)
        ref_out, ref_bank = ffd_jax.solve_scan_packed1_ckpt(buf, CK=CK,
                                                            **ss)
        assert np.array_equal(out.numpy(), np.asarray(ref_out)), GL
        ref_bank_np = _jax_bank(ref_bank)
        _assert_bank(bank, ref_bank_np, f"ckpt GL={GL}")
        for SUF in range(1, GL // CK + 1):
            jr = GL // CK - SUF
            kb = ft.Carry(*[b.clone() for b in bank])
            row_jr = [b[jr].clone() for b in kb]
            o, kb, stores = suffix_in_kernel_order(buf, st, kb, CK, SUF,
                                                   GL)
            pads.add(stores)
            assert stores == int(GL < G)
            for nm, a, b in zip(ft.Carry._fields, kb, row_jr):
                assert torch.equal(a[jr], b), (GL, SUF, nm)
            w_out, w_bank = ffd_jax.solve_scan_suffix(
                buf, ref_bank, CK=CK, SUF=SUF, GL=GL, **ss)
            assert np.array_equal(o.numpy(), np.asarray(w_out)), (GL, SUF)
            _assert_bank(kb, _jax_bank(w_bank), f"suffix GL={GL} SUF={SUF}")
    assert pads == {0, 1}


def test_entry_rows_of_both_scans():
    """``entry_row``: the checkpointed solve stores rows 0 .. G/CK - 1 at
    groups 0, CK, ...; a suffix from row jr stores jr + 1 .. at its later
    chunk entries and nothing at its first group."""
    for CK in (2, 4):
        assert [fc.entry_row(g, 0, CK, 0, False) for g in range(8)] == \
            [g // CK if g % CK == 0 else -1 for g in range(8)]
        for jr, s0 in ((0, 0), (1, CK), (2, 2 * CK)):
            rows = [fc.entry_row(g, s0, CK, jr, True)
                    for g in range(s0, s0 + 3 * CK)]
            assert rows == [-1 if (g - s0) % CK or g == s0
                            else jr + (g - s0) // CK
                            for g in range(s0, s0 + 3 * CK)]
