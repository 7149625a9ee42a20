"""Multi-rank solves on torch.distributed: the sharded scan (K10,
``mesh.py``) and the rank spawner (``ranks.py``)."""

from .mesh import (DP2_MIN_SLOTS, MeshComm, dispatch_mesh,
                   solve_scan_sharded, solve_scan_sharded2)
from .ranks import pick_backend, run_ranks

__all__ = ["DP2_MIN_SLOTS", "MeshComm", "dispatch_mesh", "pick_backend",
           "run_ranks", "solve_scan_sharded", "solve_scan_sharded2"]
