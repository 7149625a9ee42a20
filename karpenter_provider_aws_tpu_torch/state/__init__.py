from .cluster import ClusterState, NOMINATION_TTL

__all__ = ["ClusterState", "NOMINATION_TTL"]
