"""Admission validation for the API types.

The reference ships CEL validation rules compiled into its CRD manifests
(/root/reference/pkg/apis/crds/*.yaml `x-kubernetes-validations`, exercised
against a real apiserver by pkg/apis/v1/ec2nodeclass_validation_cel_test.go);
the apiserver rejects invalid objects at admission. This framework's
coordination bus is the in-memory cluster store, so the same invariants are
enforced HERE: `kwok.Cluster.create/update` runs these validators for the
three CRD kinds and refuses violations (AdmissionError), exactly where the
apiserver would.

Every rule mirrors a reference CEL rule (cited inline); the generated CRD
manifests (`hack/crd_gen.py` -> `karpenter_tpu_torch/apis/crds/*.yaml`) carry the
same rules as `x-kubernetes-validations` for a real apiserver deployment.

Copy of karpenter_tpu/apis/validation.py, imports rewritten to the port's.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, List, Optional

SUPPORTED_IMAGE_FAMILIES = ("standard", "accelerated", "minimal", "custom")
SUPPORTED_VOLUME_TYPES = ("ssd", "balanced", "throughput")
SUPPORTED_HTTP_TOKENS = ("required", "optional")
EVICTION_SIGNALS = (
    "memory.available",
    "nodefs.available",
    "nodefs.inodesFree",
    "imagefs.available",
    "imagefs.inodesFree",
    "pid.available",
)
RESERVED_RESOURCES = ("cpu", "memory", "ephemeral-storage", "pid")
VALID_TAINT_EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")
VALID_OPERATORS = ("In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt")
# tag namespace the controller owns; user tags may not forge it
# (reference: ec2nodeclass tags CEL forbids kubernetes.io/cluster/*,
# karpenter.sh/nodepool, karpenter.sh/nodeclaim, eks:eks-cluster-name).
# OUR ownership keys live under karpenter.sh (apis/labels.py NODEPOOL_LABEL,
# providers/instance NODECLAIM_TAG) -- the rules must guard THAT namespace
RESTRICTED_TAG_PATTERNS = (
    re.compile(r"^karpenter\.sh/nodepool$"),
    re.compile(r"^karpenter\.sh/nodeclaim$"),
    re.compile(r"^kubernetes\.io/cluster/"),
)

_ALIAS_RE = re.compile(r"^[a-zA-Z0-9]+@.+$")

# shared constraint vocabulary: the CRD generator (hack/crd_gen.py)
# imports THESE patterns into the YAML schemas, so the Python admission
# and the manifests cannot drift on them (single source; the parity test
# tests/test_crd_parity.py executes both sides against one corpus)
QUALIFIED_NAME = (
    r"^([a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*(\/))?"
    r"([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9]$"
)
LABEL_VALUE = r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$"
_QUALIFIED_NAME_RE = re.compile(QUALIFIED_NAME)
_LABEL_VALUE_RE = re.compile(LABEL_VALUE)
MAX_KEY_LENGTH = 316
MAX_LABEL_VALUE_LENGTH = 63
MAX_NODEPOOL_WEIGHT = 100


# karpenter.sh nodepool budgets.nodes CEL shape (0-100% cap is the
# reference's rule; PDB percents are NOT capped -- see _PDB_VALUE_RE)
_BUDGET_NODES_RE = re.compile(r"(100|[0-9]{1,2})%|[0-9]+")


@dataclass
class Violation:
    path: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}: {self.message}"


class AdmissionError(ValueError):
    """The in-memory store's stand-in for an apiserver admission refusal."""

    def __init__(self, kind: str, name: str, violations: List[Violation]):
        self.kind = kind
        self.name = name
        self.violations = violations
        detail = "; ".join(str(v) for v in violations)
        super().__init__(f"{kind}/{name} rejected: {detail}")


def _check_tags(tags, path: str, out: List[Violation], restricted: bool = False) -> None:
    for k, v in tags.items():
        # ref CEL: "empty tag keys or values aren't supported"
        if k == "" or v == "":
            out.append(Violation(path, "empty tag keys or values aren't supported"))
            break
    if restricted:
        for k in tags:
            if any(p.match(k) for p in RESTRICTED_TAG_PATTERNS):
                out.append(Violation(path, f"tag key {k!r} is restricted"))


def _check_selector_terms(
    terms, path: str, out: List[Violation], allow_name: bool = False, allow_alias: bool = False,
    required: bool = True,
) -> None:
    """Mirrors the reference's selector-term CEL block: at least one term,
    each term non-empty, 'id' mutually exclusive with everything else, and
    (for image terms) 'alias' exclusive and alone."""
    if required and not terms:
        fields = ["tags", "id"] + (["name"] if allow_name else []) + (["alias"] if allow_alias else [])
        out.append(Violation(path, f"expected at least one, got none, {fields}"))
        return
    n_alias = 0
    for i, t in enumerate(terms):
        tpath = f"{path}[{i}]"
        has_tags = bool(t.tags)
        has_id = bool(t.id)
        # every SelectorTerm supports name-based matching (SelectorTerm.matches);
        # allow_name only widens the "expected at least one" message
        has_name = bool(getattr(t, "name", ""))
        has_alias = bool(getattr(t, "alias", "")) if allow_alias else False
        if not (has_tags or has_id or has_name or has_alias):
            out.append(Violation(tpath, "expected at least one selector field, got none"))
            continue
        if has_id and (has_tags or has_name or has_alias):
            # ref CEL: "'id' is mutually exclusive, cannot be set with a
            # combination of other fields"
            out.append(Violation(tpath, "'id' is mutually exclusive with other selector fields"))
        if has_alias:
            n_alias += 1
            if has_tags or has_name:
                # ref CEL: "'alias' is mutually exclusive ..."
                out.append(Violation(tpath, "'alias' is mutually exclusive with other selector fields"))
            alias = t.alias
            if not _ALIAS_RE.match(alias):
                # ref CEL: "'alias' is improperly formatted, must match the
                # format 'family@version'"
                out.append(Violation(tpath, "'alias' must match the format 'family@version'"))
            else:
                family = alias.split("@", 1)[0].lower()
                if family not in SUPPORTED_IMAGE_FAMILIES:
                    # ref CEL: "family is not supported, must be one of ..."
                    out.append(
                        Violation(
                            tpath,
                            f"alias family {family!r} is not supported, must be one of {list(SUPPORTED_IMAGE_FAMILIES)}",
                        )
                    )
        _check_tags(t.tags, tpath + ".tags", out)
    if n_alias and len(terms) != 1:
        # ref CEL: "'alias' is mutually exclusive, cannot be set with a
        # combination of other image selector terms"
        out.append(Violation(path, "an 'alias' term must be the only image selector term"))


def _check_quantity_map(m, path: str, out: List[Violation], allowed_keys) -> None:
    from karpenter_tpu_torch.scheduling.resources import parse_quantity

    for k, v in m.items():
        if allowed_keys is not None and k not in allowed_keys:
            out.append(Violation(f"{path}.{k}", f"key must be one of {list(allowed_keys)}"))
            continue
        try:
            q = parse_quantity(v, k)
        except ValueError:
            out.append(Violation(f"{path}.{k}", f"unparseable quantity {v!r}"))
            continue
        if q < 0:
            # ref CEL: "... may not be negative" (systemReserved/kubeReserved)
            out.append(Violation(f"{path}.{k}", "quantity may not be negative"))


def validate_nodeclass(nc) -> List[Violation]:
    """The EC2NodeClass admission invariants
    (karpenter.k8s.aws_ec2nodeclasses.yaml x-kubernetes-validations),
    re-homed on TPUNodeClass vocabulary."""
    out: List[Violation] = []
    _check_selector_terms(
        nc.image_selector_terms, "spec.imageSelectorTerms", out,
        allow_name=True, allow_alias=True,
    )
    _check_selector_terms(nc.subnet_selector_terms, "spec.subnetSelectorTerms", out)
    _check_selector_terms(
        nc.security_group_selector_terms, "spec.securityGroupSelectorTerms", out,
        allow_name=True,
    )
    _check_selector_terms(
        nc.capacity_reservation_selector_terms, "spec.capacityReservationSelectorTerms",
        out, required=False,
    )
    # ref CEL on role/instanceProfile: both are single-ownership paths; the
    # pair is mutually exclusive and one must be set (ec2nodeclass.go
    # admission: "must specify one of role or instanceProfile")
    if nc.role and nc.instance_profile:
        out.append(Violation("spec", "'role' and 'instanceProfile' are mutually exclusive"))
    if not nc.role and not nc.instance_profile:
        out.append(Violation("spec", "one of 'role' or 'instanceProfile' must be set"))
    if nc.metadata_http_tokens not in SUPPORTED_HTTP_TOKENS:
        out.append(
            Violation("spec.metadataOptions.httpTokens", f"must be one of {list(SUPPORTED_HTTP_TOKENS)}")
        )
    _check_tags(nc.tags, "spec.tags", out, restricted=True)
    seen_devices = set()
    for i, b in enumerate(nc.block_device_mappings):
        bpath = f"spec.blockDeviceMappings[{i}]"
        if b.volume_size_gib < 1:
            out.append(Violation(bpath, "volumeSize must be at least 1Gi"))
        if b.volume_type not in SUPPORTED_VOLUME_TYPES:
            out.append(Violation(bpath, f"volumeType must be one of {list(SUPPORTED_VOLUME_TYPES)}"))
        if b.device_name in seen_devices:
            out.append(Violation(bpath, f"duplicate deviceName {b.device_name!r}"))
        seen_devices.add(b.device_name)
    k = nc.kubelet
    if k is not None:
        if k.max_pods is not None and k.max_pods < 1:
            out.append(Violation("spec.kubelet.maxPods", "must be at least 1"))
        if k.pods_per_core is not None and k.pods_per_core < 0:
            out.append(Violation("spec.kubelet.podsPerCore", "may not be negative"))
        _check_quantity_map(k.system_reserved, "spec.kubelet.systemReserved", out, RESERVED_RESOURCES)
        _check_quantity_map(k.kube_reserved, "spec.kubelet.kubeReserved", out, RESERVED_RESOURCES)
        for field_name, m in (("evictionHard", k.eviction_hard), ("evictionSoft", k.eviction_soft)):
            for key, value in m.items():
                # ref CEL: eviction signal enumeration
                if key not in EVICTION_SIGNALS:
                    out.append(
                        Violation(
                            f"spec.kubelet.{field_name}.{key}",
                            f"key must be one of {list(EVICTION_SIGNALS)}",
                        )
                    )
                    continue
                # values are an absolute quantity or a 0..100 percentage
                # (ref: mustParsePercentage bounds)
                if isinstance(value, str) and value.endswith("%"):
                    try:
                        pct = float(value[:-1])
                    except ValueError:
                        pct = -1.0
                    if not (0.0 <= pct <= 100.0):
                        out.append(
                            Violation(
                                f"spec.kubelet.{field_name}.{key}",
                                f"percentage {value!r} must be between 0% and 100%",
                            )
                        )
                else:
                    from karpenter_tpu_torch.scheduling.resources import parse_quantity

                    try:
                        parse_quantity(value, "memory")
                    except ValueError:
                        out.append(
                            Violation(
                                f"spec.kubelet.{field_name}.{key}",
                                f"unparseable eviction threshold {value!r}",
                            )
                        )
        # kubelet refuses soft thresholds without grace periods and vice
        # versa (ref CEL: evictionSoft keys must appear in
        # evictionSoftGracePeriod and the other way around)
        for key, value in k.eviction_soft_grace_period.items():
            # kubelet parses these as Go durations; reject what it would
            # crashloop on (validated here AND in the generated CEL)
            if not re.fullmatch(r"([0-9]+(ns|us|ms|s|m|h))+", str(value)) or value == "0s":
                out.append(
                    Violation(
                        f"spec.kubelet.evictionSoftGracePeriod.{key}",
                        f"{value!r} is not a positive Go duration (e.g. 2m, 90s)",
                    )
                )
        soft_keys = set(k.eviction_soft)
        grace_keys = set(k.eviction_soft_grace_period)
        for missing in sorted(soft_keys - grace_keys):
            out.append(
                Violation(
                    f"spec.kubelet.evictionSoft.{missing}",
                    "a matching evictionSoftGracePeriod entry is required",
                )
            )
        for extra in sorted(grace_keys - soft_keys):
            out.append(
                Violation(
                    f"spec.kubelet.evictionSoftGracePeriod.{extra}",
                    "has no matching evictionSoft entry",
                )
            )
    return out


def _check_requirements(reqs, path: str, out: List[Violation],
                        restrict_nodepool_key: bool = True) -> None:
    """Requirement objects normalize operators at construction (invalid
    operators and malformed Gt/Lt raise there, the CEL operator-enum and
    single-integer-value rules); what admission still owns is the key
    discipline (ref: karpenter.sh/nodepool is a restricted key)."""
    from karpenter_tpu_torch.apis import labels as wk

    for i, r in enumerate(reqs):
        rpath = f"{path}[{i}]"
        key = getattr(r, "key", "")
        if not key:
            out.append(Violation(rpath, "requirement key may not be empty"))
        elif len(key) > MAX_KEY_LENGTH:
            out.append(Violation(f"{rpath}.key", f"may not be longer than {MAX_KEY_LENGTH}"))
        elif not _QUALIFIED_NAME_RE.fullmatch(key):
            out.append(Violation(f"{rpath}.key", "must be a qualified name"))
        for j, v in enumerate(sorted(getattr(r, "values", ()) or ())):
            if len(v) > MAX_LABEL_VALUE_LENGTH:
                out.append(Violation(
                    f"{rpath}.values[{j}]",
                    f"may not be longer than {MAX_LABEL_VALUE_LENGTH}"))
            elif not _LABEL_VALUE_RE.fullmatch(v):
                out.append(Violation(f"{rpath}.values[{j}]", "must be a valid label value"))
        mv = getattr(r, "min_values", None)
        if mv is not None:
            # ref CRD: minValues 1..50, meaningful only for the operators
            # that admit an open or listed value set. Representation
            # (requirements.py): In = values w/o complement; Exists =
            # complement with NO values and no numeric window; NotIn =
            # complement WITH values; DoesNotExist = no values, no
            # complement.
            if not (1 <= mv <= 50):
                out.append(Violation(f"{rpath}.minValues", "must be between 1 and 50"))
            is_in = (not r.complement) and bool(r.values)
            is_exists = (
                r.complement and not r.values
                and r.greater_than is None and r.less_than is None
            )
            if not (is_in or is_exists):
                out.append(
                    Violation(
                        f"{rpath}.minValues",
                        "may only be set with the In or Exists operators",
                    )
                )
        if restrict_nodepool_key and key == wk.NODEPOOL_LABEL:
            # NODEPOOL templates only: a NodeClaim legitimately carries the
            # identity of the pool it is bound to (ref nodeclaims CRD
            # explicitly allows it)
            out.append(Violation(rpath, f"requirement key {key!r} is restricted"))


def _check_taints(taints, path: str, out: List[Violation]) -> None:
    for i, t in enumerate(taints):
        if t.effect and t.effect not in VALID_TAINT_EFFECTS:
            out.append(Violation(
                f"{path}[{i}].effect", f"must be one of {list(VALID_TAINT_EFFECTS)}"))
        key = getattr(t, "key", "")
        if not key:
            out.append(Violation(f"{path}[{i}].key", "taint key may not be empty"))
        elif not _QUALIFIED_NAME_RE.fullmatch(key):
            out.append(Violation(f"{path}[{i}].key", "must be a qualified name"))
        value = getattr(t, "value", "") or ""
        if len(value) > MAX_LABEL_VALUE_LENGTH:
            out.append(Violation(
                f"{path}[{i}].value",
                f"may not be longer than {MAX_LABEL_VALUE_LENGTH}"))
        elif value and not _LABEL_VALUE_RE.fullmatch(value):
            out.append(Violation(f"{path}[{i}].value", "must be a valid label value"))


def validate_nodepool(pool) -> List[Violation]:
    """NodePool admission invariants (karpenter.sh_nodepools.yaml)."""
    out: List[Violation] = []
    # ref CRD: weight 1..100 when set (0 = unset here; the manifest
    # serializer omits weight 0, keeping the two enforcement points
    # aligned on the boundary)
    if not (0 <= pool.weight <= MAX_NODEPOOL_WEIGHT):
        out.append(Violation(
            "spec.weight",
            f"must be at most {MAX_NODEPOOL_WEIGHT} (and at least 1 when "
            "serialized; 0 means unset and is omitted from the manifest)"))
    if pool.limits is not None:
        for key, value in pool.limits.items():
            if value < 0:
                out.append(Violation(f"spec.limits.{key}", "may not be negative"))
    d = pool.disruption
    if d.consolidate_after is not None and d.consolidate_after < 0:
        out.append(Violation("spec.disruption.consolidateAfter", "may not be negative"))
    for i, b in enumerate(d.budgets):
        nodes = getattr(b, "nodes", None)
        if isinstance(nodes, str):
            # ref CEL: budgets.nodes matches "^((100|[0-9]{1,2})%|[0-9]+)$"
            if not _BUDGET_NODES_RE.fullmatch(nodes):
                out.append(
                    Violation(
                        f"spec.disruption.budgets[{i}].nodes",
                        "must be an integer or a percentage between 0% and 100%",
                    )
                )
        # ref CEL: "'schedule' must be set with 'duration'"
        if (getattr(b, "schedule", None) is None) != (getattr(b, "duration", None) is None):
            out.append(
                Violation(
                    f"spec.disruption.budgets[{i}]",
                    "'schedule' must be set with 'duration'",
                )
            )
        sched = getattr(b, "schedule", None)
        if sched is not None:
            from karpenter_tpu_torch.apis.nodepool import validate_cron

            try:
                validate_cron(sched)
            except ValueError as e:
                out.append(
                    Violation(f"spec.disruption.budgets[{i}].schedule", str(e))
                )
        dur = getattr(b, "duration", None)
        if dur is not None and dur <= 0:
            out.append(
                Violation(f"spec.disruption.budgets[{i}].duration", "must be positive")
            )
    _check_taints(pool.template.taints, "spec.template.taints", out)
    _check_taints(pool.template.startup_taints, "spec.template.startupTaints", out)
    _check_requirements(pool.template.requirements, "spec.template.requirements", out)
    return out


def validate_nodeclaim(claim) -> List[Violation]:
    """NodeClaim admission invariants (karpenter.sh_nodeclaims.yaml)."""
    out: List[Violation] = []
    _check_taints(claim.taints, "spec.taints", out)
    _check_taints(claim.startup_taints, "spec.startupTaints", out)
    _check_requirements(claim.requirements, "spec.requirements", out,
                        restrict_nodepool_key=False)
    if claim.expire_after is not None and claim.expire_after < 0:
        out.append(Violation("spec.expireAfter", "may not be negative"))
    if claim.termination_grace_period is not None and claim.termination_grace_period < 0:
        out.append(Violation("spec.terminationGracePeriod", "may not be negative"))
    return out


# policy/v1 percent semantics: a STRING value must be an integer percent
# (the apiserver's IsValidPercent -- bare numeric strings are rejected;
# integers arrive as ints), with no 100% cap (minAvailable "150%" is a
# valid never-disrupt idiom); fullmatch so a trailing newline cannot slip
# past admission and crash _resolve later
_PDB_VALUE_RE = re.compile(r"[0-9]+%")


def validate_pdb(pdb) -> List[Violation]:
    """PodDisruptionBudget admission invariants (policy/v1 semantics:
    minAvailable xor maxUnavailable, each an integer or percent)."""
    out: List[Violation] = []
    if pdb.min_available is not None and pdb.max_unavailable is not None:
        out.append(Violation("spec", "minAvailable and maxUnavailable are mutually exclusive"))
    for field_name, value in (
        ("minAvailable", pdb.min_available),
        ("maxUnavailable", pdb.max_unavailable),
    ):
        if value is None:
            continue
        if isinstance(value, str):
            if not _PDB_VALUE_RE.fullmatch(value):
                out.append(
                    Violation(
                        f"spec.{field_name}",
                        "string values must be an integer percent (e.g. \"50%\")",
                    )
                )
        elif isinstance(value, bool) or not isinstance(value, int):
            out.append(Violation(f"spec.{field_name}", "must be an integer or percent string"))
        elif value < 0:
            out.append(Violation(f"spec.{field_name}", "may not be negative"))
    return out


VALIDATORS: dict = {}


def _register() -> None:
    from karpenter_tpu_torch.apis import NodeClaim, NodePool, PodDisruptionBudget
    from karpenter_tpu_torch.apis.nodeclass import TPUNodeClass

    VALIDATORS[TPUNodeClass.KIND] = validate_nodeclass
    VALIDATORS[NodePool.KIND] = validate_nodepool
    VALIDATORS[NodeClaim.KIND] = validate_nodeclaim
    VALIDATORS[PodDisruptionBudget.KIND] = validate_pdb


def admit(obj) -> None:
    """Raise AdmissionError when `obj` violates its kind's invariants
    (no-op for kinds without validators)."""
    if not VALIDATORS:
        _register()
    fn = VALIDATORS.get(getattr(obj, "KIND", None))
    if fn is None:
        return
    violations = fn(obj)
    if violations:
        raise AdmissionError(obj.KIND, obj.metadata.name, violations)
