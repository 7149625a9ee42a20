from .cpu import CPUSolver
from .types import (DaemonOverhead, ExistingNode, NewNodeClaim, NodePoolSpec,
                    SchedulingSnapshot, SolveResult, Solver)

__all__ = ["Solver", "CUDASolver", "CPUSolver", "SchedulingSnapshot",
           "SolveResult", "NewNodeClaim", "NodePoolSpec", "ExistingNode",
           "DaemonOverhead"]


def __getattr__(name):
    # CUDASolver on first use: solver/cuda.py imports models/, whose
    # encoder imports solver/cpu.py, so an eager import here would make
    # ``import ...models.encoding`` circular when it comes first
    if name == "CUDASolver":
        from .cuda import CUDASolver
        return CUDASolver
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
