"""NodePool API type, as far as the provisioning solve reads it.

Trimmed copy of karpenter_tpu/apis/nodepool.py: the template's labels,
requirements and taints, `NodePool.requirements()`, limits and weight.
The disruption policy (budgets, cron windows) and the drift hash belong
to the consolidation and controller slices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.objects import APIObject
from karpenter_tpu_torch.scheduling import Requirement, Requirements, Resources, Taint


@dataclass
class NodeClaimTemplate:
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    requirements: List[Requirement] = field(default_factory=list)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)


class NodePool(APIObject):
    KIND = "NodePool"

    def __init__(
        self,
        name: str,
        requirements: Sequence[Requirement] = (),
        limits: Optional[Resources] = None,
        weight: int = 0,
        template: Optional[NodeClaimTemplate] = None,
    ):
        super().__init__(name=name)
        self.template = template or NodeClaimTemplate()
        if requirements:
            self.template.requirements = list(requirements)
        self.limits = limits
        self.weight = weight

    def requirements(self) -> Requirements:
        """Template requirements + labels, as a single Requirements set
        (the scheduler's starting constraint set for this pool)."""
        reqs = Requirements(self.template.requirements)
        reqs = reqs.union(Requirements.from_labels(self.template.labels))
        reqs.add(Requirement(wk.NODEPOOL_LABEL, "In", [self.name]))
        return reqs
