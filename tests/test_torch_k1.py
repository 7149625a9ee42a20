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

Tolerance: exact (int64 words).
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
