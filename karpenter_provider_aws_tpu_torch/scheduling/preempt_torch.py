"""The preemption victim-set search (K8): plain PyTorch version and
dispatch.

The port of the reference package's ``scheduling/preempt_jax.py``
``preempt_solve_kernel``. Every candidate victim set is one lane: the
demand-group tables (``R``, ``n``, ``ex_compat``) and the node tables
(``ex_alloc``, ``ex_used0``) are shared, and each lane carries only its
refund ``freed[b]``, the summed requests of its victim prefix on the
victims' node rows. Per lane the usage starts at
``max(ex_used0 - freed[b], 0)`` and the groups fill the existing nodes
in order, exactly as consolidation's absorption scan does
(ops/consolidation_torch.py ``_absorb_scan``): headroom ``k`` is the min
over the dims with R > 0 of ``floor((alloc - used) / R)``, clipped to
[0, BIG] and 0 on incompatible nodes; ``take = clip(n - cumsum(k) + k,
0, k)``; ``used += take * R``. The answer is the lane's total leftover
pods, 0 iff evicting its victims schedules every demand pod. All int64,
wrapping like the reference's (a group whose R is all zero has
k = BIG on every compatible node, and eight such nodes overflow the
prefix).

``preempt_solve`` dispatches on the tensors' device: the plain version
below for CPU tensors, the CUDA kernel (ops/consolidation_cuda.py
``preempt_absorb``, the fourth mode of ``consol_absorb``) for CUDA
tensors. Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from ..ops.consolidation_torch import _absorb_scan


def _preempt_solve_ref(ex_alloc: torch.Tensor, ex_used0: torch.Tensor,
                       ex_compat: torch.Tensor, R: torch.Tensor,
                       n: torch.Tensor, freed: torch.Tensor) -> torch.Tensor:
    """[B] int64 leftover pods per lane; torch ops that run on the CPU
    and on CUDA alike."""
    B, E, D = freed.shape
    G = R.shape[0]
    used = (ex_used0[None] - freed).clamp(min=0)
    left = _absorb_scan(ex_alloc[None], used, ex_compat[None].expand(B, G, E),
                        R[None].expand(B, G, D), n[None].expand(B, G))
    return left.sum(dim=1)


def preempt_solve(ex_alloc, ex_used0, ex_compat, R, n,
                  freed) -> torch.Tensor:
    """[B] int64 leftover demand pods per candidate victim set: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if freed.is_cuda:
        from ..ops.consolidation_cuda import preempt_absorb
        return preempt_absorb(ex_alloc, ex_used0, ex_compat, R, n, freed)
    return _preempt_solve_ref(ex_alloc, ex_used0, ex_compat, R, n, freed)
