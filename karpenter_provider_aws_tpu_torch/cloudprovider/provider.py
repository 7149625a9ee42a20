"""The CloudProvider, trimmed to what the provisioning controller reads.

A copy of the reference package's ``cloudprovider/provider.py`` cut to
its constructor and ``get_instance_types`` (pkg/cloudprovider/
cloudprovider.go GetInstanceTypes, :164-181): a NodePool's instance
types, resolved through its EC2NodeClass by this package's
``providers/instancetype.py``. ``Provisioner.build_snapshot`` is the one
caller. Create, Get/List, Delete, drift and the event recorder are not
carried (ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

import time

from ..apis.objects import NodePool
from ..fake.kube import FakeKube
from ..providers.instancetype import InstanceTypeProvider
from .types import InstanceTypes


class CloudProvider:
    def __init__(self, kube: FakeKube,
                 instance_types: InstanceTypeProvider,
                 cluster_name: str = "cluster", clock=time.time):
        self.kube = kube
        self.instance_types = instance_types
        self.cluster_name = cluster_name
        self.clock = clock

    # -- GetInstanceTypes (cloudprovider.go:164-181) -------------------
    def get_instance_types(self, nodepool: NodePool) -> InstanceTypes:
        """Raises ``fake.kube.NotFound`` when the pool's EC2NodeClass is
        missing (the provisioner then skips the pool)."""
        nodeclass = self.kube.get("EC2NodeClass",
                                  nodepool.template.node_class_ref.name)
        return self.instance_types.list(nodeclass)  # type: ignore[arg-type]
