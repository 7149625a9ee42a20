"""Priority-aware preemptive scheduling.

PriorityClass resolution lives in ``apis/objects.py`` (the API surface);
this package owns the preemption *search*: given pending pods the base
solve could not place, find the cheapest set of strictly-lower-priority
victims whose eviction schedules all of them onto EXISTING capacity —
zero new nodes, or no preemption at all (kube-scheduler's preemption
contract, scoped to the capacity the autoscaler already owns).

- ``preempt.py``       — PreemptionPlanner, PreemptionVerdict,
  PreemptCommand
- ``preempt_torch.py`` — the batched victim-set search (K8): its plain
  PyTorch version and the dispatch to the CUDA kernel
"""

from .preempt import (MAX_LANES, PreemptCommand, PreemptionPlanner,
                      PreemptionVerdict)

__all__ = ["MAX_LANES", "PreemptCommand", "PreemptionPlanner",
           "PreemptionVerdict"]
