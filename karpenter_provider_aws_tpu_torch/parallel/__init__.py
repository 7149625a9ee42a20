"""Multi-rank solves on torch.distributed: the sharded scan (K10,
``mesh.py``), the rank spawner (``ranks.py``) and the multi-process mesh
(K11, ``distmesh.py``; its coordinator is ``fleet/meshgroup.py``)."""

from .mesh import (DP2_MIN_SLOTS, LocalSlab, MeshComm, dispatch_mesh,
                   solve_scan_sharded, solve_scan_sharded2)
from .ranks import pick_backend, run_ranks

__all__ = ["DP2_MIN_SLOTS", "LocalSlab", "MeshComm", "dispatch_mesh",
           "pick_backend", "run_ranks", "solve_scan_sharded",
           "solve_scan_sharded2"]
