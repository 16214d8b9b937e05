"""PodDisruptionBudget: the voluntary-disruption contract.

The reference relies on the Kubernetes eviction API honoring PDBs during
cordon-and-drain (core termination + consolidation simulate and evict
through it; `designs/deprovisioning.md` lists "a pod's disruption budget"
among the constraints a voluntary disruption must respect). This model
carries the subset that gates node disruption: a label selector over
same-namespace pods plus minAvailable/maxUnavailable (absolute or
percent).

Semantics (simplified against live state rather than workload-declared
replica counts, which the in-memory cluster does not track): the scale
base is the number of currently-matching pods; "healthy" is matching pods
bound to a node and not deleting. allowed_disruptions() is the eviction
API's `disruptionsAllowed`.

Copy of karpenter_tpu/apis/pdb.py, imports rewritten to the port's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from karpenter_tpu_torch.apis.objects import APIObject


def _resolve(value, total: int) -> int:
    """An absolute int or 'N%' against the scale base."""
    if isinstance(value, str) and value.endswith("%"):
        return math.ceil(float(value[:-1]) / 100.0 * total)
    return int(value)


class PodDisruptionBudget(APIObject):
    KIND = "PodDisruptionBudget"

    def __init__(
        self,
        name: str,
        namespace: str = "default",
        selector: Optional[Dict[str, str]] = None,
        min_available=None,
        max_unavailable=None,
    ):
        super().__init__(name=name)
        self.metadata.namespace = namespace
        self.selector = dict(selector or {})
        if min_available is not None and max_unavailable is not None:
            raise ValueError("minAvailable and maxUnavailable are mutually exclusive")
        self.min_available = min_available
        self.max_unavailable = max_unavailable

    def matches(self, pod) -> bool:
        if pod.metadata.namespace != self.metadata.namespace:
            return False
        labels = pod.metadata.labels
        return all(labels.get(k) == v for k, v in self.selector.items())

    def allowed_disruptions(self, total: int, healthy: int) -> int:
        """disruptionsAllowed given the current matching-pod counts.
        Never exceeds `healthy`: an allowance above the live pod count is
        meaningless (property-found edge: maxUnavailable > 0 with zero
        matching pods must report 0, not the raw budget)."""
        if self.max_unavailable is not None:
            budget = _resolve(self.max_unavailable, total)
            return min(healthy, max(0, budget - (total - healthy)))
        if self.min_available is not None:
            need = _resolve(self.min_available, total)
            return min(healthy, max(0, healthy - need))
        return max(0, healthy)  # no constraint declared
