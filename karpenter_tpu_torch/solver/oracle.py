"""Scheduling result types.

Copy of ExistingNode, NewNodeGroup and SchedulingResult from
karpenter_tpu/solver/oracle.py. The pure-Python oracle `Scheduler` that
the JAX package routes unsupported batches to belongs to the routing
slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from karpenter_tpu_torch.apis import NodePool, Pod
from karpenter_tpu_torch.providers.instancetype.types import InstanceType
from karpenter_tpu_torch.scheduling import Requirements, Resources, Taint
from karpenter_tpu_torch.scheduling import resources as res


@dataclass
class ExistingNode:
    """A live (or nominated in-flight) node the simulation can pack onto."""

    name: str
    labels: Dict[str, str]
    allocatable: Resources
    taints: List[Taint] = field(default_factory=list)
    used: Resources = field(default_factory=Resources)

    def remaining(self) -> Resources:
        return self.allocatable - self.used


@dataclass
class NewNodeGroup:
    """A simulated NodeClaim: pods packed together onto one future node."""

    nodepool: NodePool
    requirements: Requirements
    instance_types: List[InstanceType]
    taints: List[Taint]
    pods: List[Pod] = field(default_factory=list)
    requested: Resources = field(default_factory=lambda: Resources.from_base_units({res.PODS: 0}))


@dataclass
class SchedulingResult:
    existing_assignments: Dict[str, str] = field(default_factory=dict)  # pod name -> node name
    new_groups: List[NewNodeGroup] = field(default_factory=list)
    unschedulable: Dict[str, str] = field(default_factory=dict)  # pod name -> reason
