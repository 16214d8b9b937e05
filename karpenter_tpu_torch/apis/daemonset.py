"""DaemonSet: per-node overhead for node sizing.

The reference's scheduler sizes every simulated node with the resources
of the daemonsets that will land on it (the core computes daemonset
overhead per provisioning group; `designs/bin-packing.md` bakes it into
the bin-packing inputs). This model carries the subset that drives that
computation: the daemonset's pod template requests plus the scheduling
constraints (node selector, tolerations) that decide whether it lands on
a given nodepool's nodes.

Copy of karpenter_tpu/apis/daemonset.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

from karpenter_tpu_torch.apis.objects import APIObject
from karpenter_tpu_torch.scheduling import Requirements, Resources, Toleration, tolerates_all
from karpenter_tpu_torch.scheduling import resources as res


class DaemonSet(APIObject):
    KIND = "DaemonSet"

    def __init__(
        self,
        name: str,
        namespace: str = "kube-system",
        requests: Optional[Resources] = None,
        node_selector: Optional[Mapping[str, str]] = None,
        tolerations: Sequence[Toleration] = (),
    ):
        super().__init__(name=name)
        self.metadata.namespace = namespace
        self.requests = requests or Resources()
        self.node_selector = dict(node_selector or {})
        self.tolerations = list(tolerations)

    def matches_pool(self, pool) -> bool:
        """Will this daemonset's pods land on the pool's nodes? The
        karpenter model: the daemonset's node constraints must be
        compatible with the nodepool's requirements AND its tolerations
        must cover the pool taints."""
        from karpenter_tpu_torch.apis import labels as wk

        reqs = Requirements.from_labels(self.node_selector)
        if not pool.requirements().compatible(reqs, allow_undefined=wk.WELL_KNOWN_LABELS):
            return False
        return tolerates_all(self.tolerations, pool.template.taints)


def pool_daemon_overhead(daemonsets: Sequence[DaemonSet], pool) -> Resources:
    """Per-node overhead a fresh node of this pool must reserve: the sum
    of requests (plus one pod slot each) of every daemonset that will
    schedule there."""
    total = Resources()
    for ds in daemonsets:
        if ds.matches_pool(pool):
            total = total + ds.requests + Resources.from_base_units({res.PODS: 1})
    return total


def overhead_by_pool(daemonsets: Sequence[DaemonSet], pools) -> Dict[str, Resources]:
    return {p.name: pool_daemon_overhead(daemonsets, p) for p in pools}
