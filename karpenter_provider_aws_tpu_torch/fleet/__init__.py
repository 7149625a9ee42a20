"""The distributed solver's coordinator (``meshgroup.py``) and the canary
workload it gates re-admission on (``canary.py``)."""

from .canary import CANARY_SEED, MESH_CANARY_SHAPE
from .meshgroup import MeshGroup

__all__ = ["CANARY_SEED", "MESH_CANARY_SHAPE", "MeshGroup"]
