"""Taints and tolerations.

Copy of karpenter_tpu/scheduling/taints.py.

The reference relies on the core scheduler's taint/toleration matching during
bin-packing and consolidation simulation (startup taints on NodeClaims:
pkg/cloudprovider/cloudprovider.go instanceToNodeClaim path; kwok node
fabrication applies taints when registering fake nodes). Semantics follow
k8s: a pod tolerates a taint if a toleration matches (key, operator Equal/
Exists, value, effect); NoSchedule/NoExecute taints block scheduling unless
tolerated, PreferNoSchedule is soft (treated as non-blocking here, matching
the core scheduler's hard-constraint-only simulation).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

NO_SCHEDULE = "NoSchedule"
NO_EXECUTE = "NoExecute"
PREFER_NO_SCHEDULE = "PreferNoSchedule"


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str = NO_SCHEDULE
    value: str = ""

    def blocking(self) -> bool:
        return self.effect in (NO_SCHEDULE, NO_EXECUTE)


@dataclass(frozen=True)
class Toleration:
    key: str = ""                 # empty + Exists tolerates everything
    operator: str = "Equal"       # Equal | Exists
    value: str = ""
    effect: str = ""              # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


def tolerates(tolerations: Sequence[Toleration], taint: Taint) -> bool:
    if not taint.blocking():
        return True
    return any(t.tolerates(taint) for t in tolerations)


def tolerates_all(tolerations: Sequence[Toleration], taints: Sequence[Taint]) -> bool:
    return all(tolerates(tolerations, t) for t in taints)
