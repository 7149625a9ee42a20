"""K1's output pack as its one-launch kernel computes it, held against the
plain version and the reference package on the CPU.

``csrc/packed_io.cu`` ``pack_outputs`` writes every word of each lane's
output row [i64 section | int32-pair takes | bit words | bail] in one
launch, from the sources ``ffd_cuda.pack_sources`` lists (the wrapper
builds its argument block from the same list). Here a plain model of the
kernel's decomposition reads those sources as the kernel does, on their
CPU addresses:

- warps [0, ws) the scalar words, a thread each: the i64 section's
  fields through their own pointers, lengths and lane strides (int32
  fields widened), a takes word by one 8-byte load where the pair is
  aligned (two 4-byte loads otherwise; an odd count pads the last high
  half with 0), the bail word after the bit words;
- the later warps ``PACK_BIT_WORDS`` bit words each: lane j takes bools
  16j .. 16j + 15 of each 512-bool pass by one 16-byte load where they
  lie in one segment at a 16-byte boundary, else byte by byte, each
  bool's segment found by comparing its index with the prefix lengths;
  lane 4q gathers word q from its three neighbours; bits past the last
  segment are 0;

and every word of the row is written exactly once. The model is held
against ``ffd_torch._pack_outputs_ref`` (plus the bail word) and the
reference's ``_pack_solve_outputs`` lane by lane, byte for byte, at
``examples.PACK_SHAPES`` (T = 813, Z = 3, C = 2 and odd N, so segments
straddle words; odd G*N; config 2's widths), L = 1 and 3 lanes (also as
views of a wider stack), with and without the bail word (set and clear).

Then ``unpack_bits``, the arena's way in, as its kernel cuts each lane's
bool row: a thread a unit, unit 0 the head (the bytes before the row's
first 16-byte boundary, bytewise), units 1 .. nv the row's 16-byte words
(one 16-byte store each, 16 bools expanded from 16 bits four at a time by
one multiply), unit nv + 1 the tail (bytewise); a unit's bits read from
one word, or two joined by an unsigned funnel shift where they straddle
(bit 48 on), never a word past the lane's nwords(nbits). The model runs
the launch's grid on simulated addresses (lane rows at every offset mod
16) and checks that every byte of every row is written once, each word
store on a 16-byte boundary, against ``_unpack_bits_ref`` and the
reference's ``_words_to_bits`` at ``examples.UNPACK_WIDTHS`` on 1, 3 and
17 lanes (words with bit 63 set, the last lane's last word at the end of
the tensor, lanes further apart than their words).

Tolerance: exact (int64 words, bool bytes).
"""

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu.ops import ffd_jax
from karpenter_provider_aws_tpu_torch import examples
from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft


def _lanes(t, n, stride):
    """[L, n] numpy view of a field whose lanes are ``stride`` elements
    apart (the kernel's reads), whatever the tensor's own strides."""
    L = t.shape[0]
    return torch.as_strided(t, (L, n), (stride, 1)).numpy()


def _addr(t, lane, stride, off):
    return t.data_ptr() + (lane * stride + off) * t.element_size()


def _s64(x: int) -> int:
    """An unsigned 64-bit word as the int64 the buffer holds."""
    return x - (1 << 64) if x >= 1 << 63 else x


def pack_model(src):
    """The kernel's row of every lane from ``pack_sources``' list: (out
    [L, W] int64, how many 16-bool chunks took the 16-byte load, how many
    takes words the 8-byte load)."""
    L, n64, w32 = src["L"], src["n64"], src["w32"]
    nwb, nbits, W = src["nwb"], src["nbits"], src["W"]
    fields = [(_lanes(t, n, s), n, t, s) for t, n, s, _ in src["fields"]]
    tk_t, n32, tk_s = src["takes"]
    takes = _lanes(tk_t, n32, tk_s)
    segs = [(_lanes(t, n, s) if n else None, n, t, s)
            for t, n, s in src["segs"]]
    bail = None
    if src["bail"] is not None:
        bail = _lanes(src["bail"][0], 1, src["bail"][1])
    ns = n64 + w32 + (bail is not None)
    ws = -(-ns // 32)
    warps = ws + -(-nwb // fc.PACK_BIT_WORDS)
    blocks = -(-warps // fc.PACK_WARPS)
    pre = [0]
    for _, n, _, _ in segs:
        pre.append(pre[-1] + n)
    out = np.zeros((L, W), np.int64)
    seen = np.zeros((L, W), np.int64)
    vec = pairs = 0

    def seg_of(i):
        return sum(i >= pre[k] for k in (1, 2, 3))

    for lane in range(L):
        for gw in range(blocks * fc.PACK_WARPS):
            if gw < ws:
                for ln in range(32):
                    s = gw * 32 + ln
                    if s >= ns:
                        continue
                    if s < n64:
                        off, f = s, 0
                        for j in range(4):
                            if f == j and off >= fields[j][1]:
                                off -= fields[j][1]
                                f = j + 1
                        out[lane, s] = int(fields[f][0][lane, off])
                        seen[lane, s] += 1
                    elif s < n64 + w32:
                        w = s - n64
                        lo = int(takes[lane, 2 * w]) & 0xFFFFFFFF
                        hi = 0
                        if 2 * w + 1 < n32:
                            hi = int(takes[lane, 2 * w + 1]) & 0xFFFFFFFF
                            pairs += _addr(tk_t, lane, tk_s, 2 * w) % 8 == 0
                        out[lane, s] = _s64(lo | hi << 32)
                        seen[lane, s] += 1
                    else:
                        out[lane, s + nwb] = int(bool(bail[lane, 0]))
                        seen[lane, s + nwb] += 1
                continue
            w0 = (gw - ws) * fc.PACK_BIT_WORDS
            if w0 >= nwb:
                continue
            for h in range(fc.PACK_BIT_WORDS // 8):
                m = [0] * 32
                for ln in range(32):
                    i = (w0 + 8 * h) * 64 + 16 * ln
                    if i >= nbits:
                        continue
                    j = seg_of(i)
                    arr, _, t, st = segs[j]
                    if i + 16 <= pre[j + 1] and \
                            _addr(t, lane, st, i - pre[j]) % 16 == 0:
                        vec += 1
                        bits = arr[lane, i - pre[j]:i - pre[j] + 16]
                        m[ln] = sum(int(b != 0) << k
                                    for k, b in enumerate(bits))
                        continue
                    for b in range(16):
                        x = i + b
                        if x >= nbits:
                            break
                        sj = seg_of(x)
                        m[ln] |= int(segs[sj][0][lane, x - pre[sj]] != 0) << b
                for ln in range(0, 32, 4):
                    w = w0 + 8 * h + ln // 4
                    if w < nwb:
                        word = (m[ln] | m[ln + 1] << 16 | m[ln + 2] << 32
                                | m[ln + 3] << 48)
                        out[lane, n64 + w32 + w] = _s64(word)
                        seen[lane, n64 + w32 + w] += 1
    assert (seen == 1).all(), "every word of the row written once"
    return out, vec, pairs


def _want(takes, leftover, carry, bail, lane):
    """The plain version's row of ``lane`` (and its bail word)."""
    c = ft.Carry(*[f[lane] for f in carry])
    row = ft._pack_outputs_ref(takes[lane], leftover[lane], c)
    if bail is not None:
        row = torch.cat([row, bail[lane].reshape(1).long()])
    return row.numpy()


def _jax_row(takes, leftover, carry, lane):
    """The reference's ``_pack_solve_outputs`` on lane ``lane``."""
    import jax.numpy as jnp
    c = ffd_jax.Carry(*[jnp.asarray(f[lane].numpy())
                        for f in carry[:len(ffd_jax.Carry._fields)]])
    return np.asarray(ffd_jax._pack_solve_outputs(
        jnp.asarray(takes[lane].numpy()), jnp.asarray(leftover[lane].numpy()),
        c))


def test_carry_fields_line_up():
    """The port's Carry and the reference's name the same fields in the
    same order (the JAX row above is built positionally)."""
    assert ft.Carry._fields[:len(ffd_jax.Carry._fields)] == \
        ffd_jax.Carry._fields


@pytest.mark.parametrize("bail", [False, True])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("shape", examples.PACK_SHAPES[:4])
def test_model_matches_plain_and_reference(shape, L, bail):
    takes, left, carry, bl = examples.pack_case(*shape, L, seed=sum(shape) + L,
                                                bail=bail)
    src = fc.pack_sources(takes, left, carry, bl)
    got, vec, _ = pack_model(src)
    assert got.shape == (L, src["W"])
    for lane in range(L):
        want = _want(takes, left, carry, bl, lane)
        assert np.array_equal(got[lane], want), (shape, lane)
        ref = _jax_row(takes, left, carry, lane)
        assert np.array_equal(got[lane, :ref.shape[0]], ref), (shape, lane)
    if bail:
        assert got[0, -1] == 1
        if L > 1:
            assert got[1, -1] == 0
    if shape[0] > 64:
        assert vec, "the 16-byte loads ran"


def test_config2_widths_one_lane():
    """Config 2's widths (T = 812, N = 256, G = 4): the types segment's
    16-byte loads carry nearly every bool; the row equals the plain
    version's and the reference's."""
    shape = examples.PACK_SHAPES[-1]
    takes, left, carry, _ = examples.pack_case(*shape, 1, seed=5)
    src = fc.pack_sources(takes, left, carry)
    got, vec, pairs = pack_model(src)
    assert np.array_equal(got[0], _want(takes, left, carry, None, 0))
    assert np.array_equal(got[0], _jax_row(takes, left, carry, 0))
    assert vec >= (256 * 812) // 16 - 2
    assert pairs == src["w32"]


def test_lane_views_of_a_wider_stack():
    """Fields that are views of a wider [L, W] stack (lanes further apart
    than their length, the takes at an odd int32 offset, so no pair is
    8-byte aligned in the odd lanes) read at their own lane strides."""
    shape = examples.PACK_SHAPES[0]
    takes, left, carry, bl = examples.pack_case(*shape, 3, seed=11, bail=True)

    def widen(t, pad):
        wide = torch.zeros((t.shape[0], t[0].numel() + pad), dtype=t.dtype)
        wide[:, pad:] = t.reshape(t.shape[0], -1)
        return wide[:, pad:].view(t.shape)

    takes_w = widen(takes, 1)
    carry_w = ft.Carry(*[widen(f, 3) for f in carry])
    src = fc.pack_sources(takes_w, widen(left, 2), carry_w, widen(bl, 5))
    assert src["takes"][2] == takes[0].numel() + 1
    got, _, pairs = pack_model(src)
    for lane in range(3):
        assert np.array_equal(got[lane], _want(takes, left, carry, bl, lane))
    assert pairs < 3 * (src["w32"] - 1)


def test_sources_refuse_what_the_kernel_does_not_read():
    takes, left, carry, bl = examples.pack_case(*examples.PACK_SHAPES[2], 2)
    with pytest.raises(ValueError, match="int32"):
        fc.pack_sources(takes.long(), left, carry)
    with pytest.raises(ValueError, match="contiguous"):
        fc.pack_sources(takes, left, carry._replace(
            types=carry.types.transpose(1, 2)))
    with pytest.raises(ValueError, match="one bool a lane"):
        fc.pack_sources(takes, left, carry, torch.ones((2, 2), dtype=bool))
    with pytest.raises(ValueError, match="CUDA"):
        fc.pack_outputs_lanes(takes, left, carry, bl)


# ---------------------------------------------------------------------------
# unpack_bits: the kernel's units on simulated addresses
# ---------------------------------------------------------------------------

M64 = (1 << 64) - 1
#: csrc/packed_io.cu kThreads
UNPACK_THREADS = 256


def unpack_blocks(nbits):
    """The unpack's CTAs a lane: one thread for each of ``unpack_units``."""
    return -(-(nbits // 16 + 2) // UNPACK_THREADS)


def expand4(x):
    """``expand4``: bits 0-3 of x as the bytes of a 32-bit word."""
    v = ((x & 15) * 0x00204081) & 0x01010101
    assert v < 1 << 32
    return [(v >> (8 * k)) & 0xFF for k in range(4)]


def unpack_unit(words, w0, nbits, row, u, reads):
    """``unpack_unit``: unit u of the row at simulated address ``row`` of
    the lane whose words start at index ``w0`` of the flat int64 array
    ``words``. Returns None or (first byte, its bytes, 16-byte store?) and
    appends each word index read (relative to the lane) to ``reads``."""
    nw = -(-nbits // 64)
    h = min((16 - row % 16) % 16, nbits)
    nv = (nbits - h) >> 4
    if u > nv + 1:
        return None
    s = 0 if u == 0 else h + 16 * (u - 1)
    e = h if u == 0 else (s + 16 if u <= nv else nbits)
    if s >= e:
        return None
    q, sh = s >> 6, s & 63
    reads.append(q)
    x = (int(words[w0 + q]) & M64) >> sh
    if sh > 48 and q + 1 < nw:
        reads.append(q + 1)
        x |= ((int(words[w0 + q + 1]) & M64) << (64 - sh)) & M64
    b = x & 0xFFFF
    if 0 < u <= nv:
        return s, sum((expand4(b >> (4 * k)) for k in range(4)), []), True
    return s, [(b >> k) & 1 for k in range(e - s)], False


def unpack_model(words, nbits, out_addr):
    """The launch of ``unpack_bits_lanes(words, nbits)`` with its output
    at simulated address ``out_addr``: (bool rows [L, nbits], 16-byte
    stores). Checks every read and write as it goes."""
    L, nw = words.shape
    stride = words.stride(0) if L > 1 else nw
    flat = torch.as_strided(words, ((L - 1) * stride + nw,),
                            (1,)).numpy()
    out = np.zeros((L, nbits), np.int64)
    seen = np.zeros((L, nbits), np.int64)
    vec = 0
    for lane in range(L):
        row = out_addr + lane * nbits
        for t in range(unpack_blocks(nbits) * UNPACK_THREADS):
            reads = []
            x = unpack_unit(flat, lane * stride, nbits, row, t, reads)
            assert all(0 <= q < nw for q in reads), (lane, t, reads)
            if x is None:
                continue
            s, vals, wide = x
            if wide:
                assert len(vals) == 16 and (row + s) % 16 == 0
                vec += 1
            else:
                assert len(vals) < 16
            assert s + len(vals) <= nbits
            out[lane, s:s + len(vals)] = vals
            seen[lane, s:s + len(vals)] += 1
    assert (seen == 1).all(), "every byte of every row written once"
    return out.astype(bool), vec


@pytest.mark.parametrize("out_shift", [0, 7])
@pytest.mark.parametrize("L", [1, 3, 17])
@pytest.mark.parametrize("nbits", examples.UNPACK_WIDTHS)
def test_unpack_model_matches_plain_and_reference(nbits, L, out_shift):
    """The unpack's units at every width and lane count, the output at a
    16-byte boundary and 7 bytes past one (17 lanes of an odd width put
    the rows at every offset mod 16); lanes 0 and L - 1 also against the
    reference's ``_words_to_bits``."""
    import jax.numpy as jnp
    words = examples.unpack_case(nbits, L, seed=nbits + L, pad=L % 2)
    got, vec = unpack_model(words, nbits, (1 << 20) + out_shift)
    for lane in range(L):
        want = ft._unpack_bits_ref(words[lane], nbits).numpy()
        assert np.array_equal(got[lane], want), lane
    for lane in {0, L - 1}:
        ref = np.asarray(ffd_jax._words_to_bits(
            jnp.asarray(words[lane].numpy()), nbits))
        assert np.array_equal(got[lane], ref), lane
    if nbits >= 48:
        assert vec, "the 16-byte stores ran"


def test_unpack_units_straddle_and_end_cases():
    """Hand-checked cuts. A 50-bit row at 7 mod 16: a 9-byte head, words
    from bits 9 and 25, a 9-byte tail from bit 41. A 65-bit row at 0 mod
    16: no head, bits [48, 64) from word 0 alone (bit 63 set), the tail
    bit 64 from word 1. A 128-bit row at 15 mod 16: the word from bit 49
    joins words 0 and 1. A 60-bit row at 15 mod 16: its tail from bit 49
    reads word 0 only, the lane's one word."""
    words = torch.tensor([-1 << 63 | 0x0123_4567_89AB_CDEF, 0x5A5A])
    w = words.numpy()
    bits = ft._unpack_bits_ref(words, 128).numpy()
    cuts = [unpack_unit(w, 0, 50, 7, u, []) for u in range(5)]
    assert [(c[0], len(c[1]), c[2]) for c in cuts[:4]] == \
        [(0, 9, False), (9, 16, True), (25, 16, True), (41, 9, False)]
    assert cuts[4] is None
    assert unpack_unit(w, 0, 65, 0, 0, []) is None
    reads = []
    s, vals, wide = unpack_unit(w, 0, 65, 0, 4, reads)
    assert (s, wide, reads) == (48, True, [0])
    assert vals == [(0x8123 >> k) & 1 for k in range(16)]
    reads = []
    assert unpack_unit(w, 0, 65, 0, 5, reads) == (64, [0], False)
    assert reads == [1]
    reads = []
    s, vals, wide = unpack_unit(w, 0, 128, 15, 4, reads)
    assert (s, wide, reads) == (49, True, [0, 1])
    assert vals == [int(b) for b in bits[49:65]]
    reads = []
    s, vals, wide = unpack_unit(w, 0, 60, 15, 4, reads)
    assert (s, len(vals), wide, reads) == (49, 11, False, [0])
    assert vals == [int(b) for b in bits[49:60]]
