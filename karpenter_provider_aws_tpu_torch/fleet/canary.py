"""The mesh group's canary workload (the reference's ``fleet/canary.py``,
only the part the mesh group reads): ``MeshGroup._canary_group`` solves
the seeded ``distmesh.tick_arrays`` workload of ``MESH_CANARY_SHAPE`` on
a freshly formed group and admits the group only when every rank's
fingerprint equals the coordinator's single-device oracle."""

#: tiny, but wide enough in slots to pad over the dp shards
MESH_CANARY_SHAPE = dict(G=2, T=5, n_max=16, E=4, P=1, Z=2, C=2, D=4,
                         pods_per_group=3)
CANARY_SEED = 1303
