"""NodePool API type.

Rebuilt from the core CRD shipped by the reference
(pkg/apis/crds/karpenter.sh_nodepools.yaml): template (labels/annotations/
requirements/taints/startup-taints/node-class-ref/expire-after), disruption
policy (consolidation policy, consolidate-after, budgets), limits, weight.

Copy of karpenter_tpu/apis/nodepool.py, imports rewritten to the port's.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis.objects import APIObject
from karpenter_tpu_torch.scheduling import Requirement, Requirements, Resources, Taint

CONSOLIDATION_WHEN_EMPTY = "WhenEmpty"
CONSOLIDATION_WHEN_EMPTY_OR_UNDERUTILIZED = "WhenEmptyOrUnderutilized"


def _cron_field_matches(field_expr: str, value: int, lo: int, hi: int) -> bool:
    """One 5-field-cron field against a value: *, */step, lists, ranges
    (a-b, a-b/step), bare ints, N/step (= N-hi/step, standard cron).
    STRICT: an unparseable or out-of-range term raises ValueError --
    silently-never-matching garbage would turn a maintenance freeze into
    no freeze (admission validates; Budget.active fails closed)."""
    matched = False
    for term in field_expr.split(","):
        term = term.strip()
        step = 1
        stepped = False
        if "/" in term:
            term, step_s = term.split("/", 1)
            step = int(step_s)
            stepped = True
            if step <= 0:
                raise ValueError(f"cron step must be positive: {field_expr!r}")
        if term == "*":
            a, b = lo, hi
        elif "-" in term:
            a, b = (int(x) for x in term.split("-", 1))
        else:
            a = int(term)
            # N/step means N-hi/step in standard cron; bare N is exact
            b = hi if stepped else a
        if not (lo <= a <= hi and lo <= b <= hi and a <= b):
            raise ValueError(f"cron term out of range [{lo},{hi}]: {field_expr!r}")
        if a <= value <= b and (value - a) % step == 0:
            matched = True
    return matched


def cron_matches(expr: str, epoch: float) -> bool:
    """Does the 5-field cron (minute hour dom month dow, UTC) fire at the
    minute containing `epoch`? Standard semantics: when BOTH day-of-month
    and day-of-week are restricted, either matching suffices."""
    import time as _time

    parts = expr.split()
    if len(parts) != 5:
        raise ValueError(f"cron expression must have 5 fields: {expr!r}")
    minute, hour, dom, month, dow = parts
    t = _time.gmtime(epoch)
    if not _cron_field_matches(minute, t.tm_min, 0, 59):
        return False
    if not _cron_field_matches(hour, t.tm_hour, 0, 23):
        return False
    if not _cron_field_matches(month, t.tm_mon, 1, 12):
        return False
    cron_dow = (t.tm_wday + 1) % 7  # cron: 0=Sunday; tm_wday: 0=Monday
    dom_ok = _cron_field_matches(dom, t.tm_mday, 1, 31)
    # Sunday doubles as 7 (match either value); a field STARTING with '*'
    # (incl. */step) is unrestricted for the either-suffices rule, like
    # standard cron's star bit
    dow_ok = _cron_field_matches(dow, cron_dow, 0, 7) or (
        cron_dow == 0 and _cron_field_matches(dow, 7, 0, 7)
    )
    dom_star = dom.strip().startswith("*")
    dow_star = dow.strip().startswith("*")
    if not dom_star and not dow_star:
        return dom_ok or dow_ok
    return dom_ok and dow_ok


def validate_cron(expr: str) -> None:
    """Raise ValueError when `expr` is not a valid 5-field cron."""
    parts = expr.split()
    if len(parts) != 5:
        raise ValueError(f"cron expression must have 5 fields: {expr!r}")
    for field_expr, lo, hi in (
        (parts[0], 0, 59), (parts[1], 0, 23), (parts[2], 1, 31),
        (parts[3], 1, 12), (parts[4], 0, 7),
    ):
        _cron_field_matches(field_expr, lo, lo, hi)


@dataclass
class Budget:
    """Disruption budget: max share of nodes disruptable at once,
    optionally gated to reasons and a cron schedule window. A budget with
    a schedule constrains ONLY while inside its window: some occurrence
    of the 5-field cron within the trailing `duration` seconds (UTC, the
    upstream convention)."""

    nodes: str = "10%"  # absolute int or percentage
    reasons: Optional[List[str]] = None  # None = all reasons
    schedule: Optional[str] = None
    duration: Optional[float] = None

    def active(self, now: float) -> bool:
        """Is this budget constraining at epoch `now`? Scheduleless
        budgets always are; scheduled ones only inside the window."""
        if self.schedule is None:
            return True
        if not self.duration:
            # schedule without duration is inadmissible (CEL) -- for a
            # pre-validation object, fail CLOSED: before these fields were
            # consulted such a budget always constrained, and a freeze
            # must not silently lift on upgrade
            return True
        import math

        # fail CLOSED on a malformed schedule that slipped past admission:
        # treating the budget as constraining blocks disruption, the
        # conservative direction for a maintenance freeze
        try:
            validate_cron(self.schedule)
        except ValueError:
            return True

        # scan trailing minutes for a cron occurrence: duration is hours
        # in practice, so the walk is short and runs once per pass
        start_min = int(math.floor((now - self.duration) / 60.0)) + 1
        end_min = int(math.floor(now / 60.0))
        for m in range(end_min, start_min - 1, -1):
            if cron_matches(self.schedule, m * 60.0):
                return True
        return False

    def allowed(self, total_nodes: int) -> int:
        if self.nodes.endswith("%"):
            import math

            pct = float(self.nodes[:-1]) / 100.0
            # percentages scale up (k8s intstr semantics): "10%" of a
            # 1-node pool permits 1 disruption, not 0
            return math.ceil(total_nodes * pct)
        return int(self.nodes)


@dataclass
class Disruption:
    consolidation_policy: str = CONSOLIDATION_WHEN_EMPTY_OR_UNDERUTILIZED
    consolidate_after: float = 0.0  # seconds; 0 = immediately
    budgets: List[Budget] = field(default_factory=lambda: [Budget()])


@dataclass
class NodeClassRef:
    name: str = "default"
    kind: str = "TPUNodeClass"
    group: str = "karpenter.tpu"


@dataclass
class NodeClaimTemplate:
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    requirements: List[Requirement] = field(default_factory=list)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    node_class_ref: NodeClassRef = field(default_factory=NodeClassRef)
    expire_after: Optional[float] = None  # seconds; None = never
    termination_grace_period: Optional[float] = None


class NodePool(APIObject):
    KIND = "NodePool"

    def __init__(
        self,
        name: str,
        requirements: Sequence[Requirement] = (),
        limits: Optional[Resources] = None,
        weight: int = 0,
        template: Optional[NodeClaimTemplate] = None,
        disruption: Optional[Disruption] = None,
    ):
        super().__init__(name=name)
        self.template = template or NodeClaimTemplate()
        if requirements:
            self.template.requirements = list(requirements)
        self.limits = limits
        self.weight = weight
        self.disruption = disruption or Disruption()
        # status
        self.status_resources = Resources()  # aggregate of owned nodes

    def requirements(self) -> Requirements:
        """Template requirements + labels, as a single Requirements set
        (the scheduler's starting constraint set for this pool)."""
        reqs = Requirements(self.template.requirements)
        reqs = reqs.union(Requirements.from_labels(self.template.labels))
        from karpenter_tpu_torch.apis import labels as wk

        reqs.add(Requirement(wk.NODEPOOL_LABEL, "In", [self.name]))
        return reqs

    def static_hash(self) -> str:
        """Drift hash over the static template fields (reference:
        nodepool-hash annotation stamped by the core, mirrored by
        pkg/controllers/nodeclass/hash for the nodeclass)."""
        payload = {
            "labels": self.template.labels,
            "annotations": self.template.annotations,
            "taints": [(t.key, t.value, t.effect) for t in self.template.taints],
            "startup_taints": [(t.key, t.value, t.effect) for t in self.template.startup_taints],
            "expire_after": self.template.expire_after,
            "node_class_ref": (
                self.template.node_class_ref.group,
                self.template.node_class_ref.kind,
                self.template.node_class_ref.name,
            ),
        }
        return hashlib.blake2b(
            json.dumps(payload, sort_keys=True).encode(), digest_size=8
        ).hexdigest()

    def within_limits(self, usage: Resources) -> bool:
        if self.limits is None:
            return True
        return usage.within(self.limits)
