"""Incremental-solve policy: when a checkpointed scan may serve, and
which suffix bucket a dirty frontier resolves to.

A copy of the reference package's solver/incremental.py. The scan carry
entering group *i* is a pure function of groups ``< i`` in the
restriction-stable canonical order (models/encoding.py), so a tick whose
dirty rows all sit at or past a frontier index can restore the deepest
checkpoint at or below the frontier and re-scan only the suffix —
byte-identical to the from-scratch solve by construction (the suffix
scans the SAME padded arena rows through the SAME group step from the
SAME carry the full solve would have reached).

- ``ckpt_eligible``: which shape classes record checkpoints at all (the
  unfused single-device scan, CK-aligned, at most ``CKPT_MAX_GROUPS``).
- ``suffix_plan``: frontier -> (resume chunk, suffix length). Suffix
  lengths round UP the {2^k, 1.5*2^k} ladder, so a warm frontier
  wobbling a few groups keeps one suffix shape; rounding up only ever
  resumes EARLIER (a deeper prefix re-scanned), which is always exact.
- ``suffix_buckets``: every suffix length a shape class can produce.
- ``live_bound``: the chunk-aligned end of the non-empty groups.

Bank *validity* is a token equality (delta epoch + the encoder version
the bank's arena reflected) owned by the solver (solver/cuda.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: checkpoint stride: one carry snapshot every CKPT_CHUNK groups. The
#: wasted prefix re-scan below the frontier is at most CKPT_CHUNK - 1
#: groups, and the bank holds G / CKPT_CHUNK carries.
CKPT_CHUNK = 2

#: largest padded group count that records checkpoints: past it the
#: bank's [G/CK, N, ...] carry stack stops being small next to the arena
CKPT_MAX_GROUPS = 512


def _pow2(v: int) -> int:
    return 1 << (v - 1).bit_length() if v > 0 else 0


def _pow15(v: int) -> int:
    """Next boundary in the {2^k, 1.5*2^k} ladder (1,2,3,4,6,8,12,...)."""
    if v <= 2:
        return max(v, 0)
    p = _pow2(v)
    mid = (p >> 1) + (p >> 2)
    return mid if v <= mid else p


def ckpt_eligible(Gp: int, *, ndev: int = 1, use_pruned: bool = False,
                  Fu: int = 1, CK: int = CKPT_CHUNK) -> bool:
    """May this dispatch record/consume a checkpoint bank? Purely a
    shape/engine gate — bank freshness is the caller's token check."""
    return (ndev <= 1 and not use_pruned and Fu <= 1
            and Gp >= 2 * CK and Gp <= CKPT_MAX_GROUPS
            and Gp % CK == 0)


def suffix_plan(frontier: int, Gp: int, CK: int = CKPT_CHUNK,
                GL: int = None) -> Tuple[int, int]:
    """``(resume_chunk, SUF)`` for a dirty frontier against a Gp-group
    arena whose live bound is GL (None means Gp): the suffix scans
    groups ``[resume_chunk*CK, GL)`` from the bank's entry carry at
    ``resume_chunk``. Invariants: ``resume_chunk * CK <= frontier``
    (never skips a dirty row) and ``SUF >= 1`` (even a clean tick
    re-scans one chunk)."""
    GLC = (GL if GL is not None else Gp) // CK
    j = min(max(frontier, 0) // CK, GLC - 1)
    SUF = min(_pow15(GLC - j), GLC)
    return GLC - SUF, SUF


def suffix_buckets(Gp: int, CK: int = CKPT_CHUNK,
                   GL: int = None) -> Tuple[int, ...]:
    """Every SUF value ``suffix_plan`` can emit for this arena shape,
    ascending."""
    GLC = (GL if GL is not None else Gp) // CK
    return tuple(sorted({min(_pow15(GLC - j), GLC) for j in range(GLC)}))


def live_bound(buf, *, T: int, D: int, G: int,
               CK: int = CKPT_CHUNK) -> int:
    """Chunk-aligned bound of the non-empty groups of a packed arena:
    the smallest multiple of CK covering every group with n > 0 (the
    ``n`` vector sits at word ``T*D + G*D`` of the i64 section —
    ops/hostpack.py in_layout_i64). An empty group is a carry no-op, so
    a suffix scan may stop there with byte-identical outputs. Returns 0
    for an all-empty arena."""
    off = T * D + G * D
    n = np.asarray(buf[off:off + G])
    nz = np.nonzero(n)[0]
    if not nz.size:
        return 0
    return -(-(int(nz[-1]) + 1) // CK) * CK
