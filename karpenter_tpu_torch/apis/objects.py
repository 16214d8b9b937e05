"""Object machinery shared by all API types.

The reference's types are k8s CRDs with metadata, spec, status, and
status conditions managed by controller chains
(e.g. pkg/controllers/nodeclass/controller.go:114-163). Without a kube
apiserver in this environment, this module provides the equivalent object
model: metadata (name/labels/annotations/finalizers/creation time/uid),
status conditions with transition times, resource-version optimistic
concurrency, and deep-copy -- the contract the in-memory API server in
karpenter_tpu_torch.kwok enforces.

Copy of karpenter_tpu/apis/objects.py, imports rewritten to the port's.
"""
from __future__ import annotations

import copy
import itertools
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_seq = itertools.count(1)


def now() -> float:
    return time.time()


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = field(default_factory=lambda: generate_uid())
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    owner_references: List[str] = field(default_factory=list)  # uids
    # 0.0 = unset; the cluster store stamps its (injectable) clock at create
    # time -- a wall-clock default here would poison FakeClock age math
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0
    generation: int = 1


@dataclass
class Condition:
    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=now)
    observed_generation: int = 0


class StatusConditions:
    """operatorpkg-style condition set: Set/Get/IsTrue + root readiness."""

    READY = "Ready"

    def __init__(self, root: str = READY):
        self._conds: Dict[str, Condition] = {}
        self._root = root

    def set_true(self, ctype: str, reason: str = "", message: str = "") -> None:
        self._set(ctype, "True", reason, message)

    def set_false(self, ctype: str, reason: str = "", message: str = "") -> None:
        self._set(ctype, "False", reason, message)

    def set_unknown(self, ctype: str, reason: str = "AwaitingReconciliation", message: str = "") -> None:
        self._set(ctype, "Unknown", reason, message)

    def _set(self, ctype: str, status: str, reason: str, message: str) -> None:
        prev = self._conds.get(ctype)
        if prev is not None and prev.status == status:
            prev.reason, prev.message = reason or prev.reason, message or prev.message
            return
        self._conds[ctype] = Condition(ctype, status, reason, message)

    def get(self, ctype: str) -> Optional[Condition]:
        return self._conds.get(ctype)

    def is_true(self, ctype: str) -> bool:
        c = self._conds.get(ctype)
        return c is not None and c.status == "True"

    def is_false(self, ctype: str) -> bool:
        c = self._conds.get(ctype)
        return c is not None and c.status == "False"

    def all(self) -> List[Condition]:
        return list(self._conds.values())

    def compute_root(self, dependents: List[str]) -> None:
        """Root condition = AND of dependents (operatorpkg semantics)."""
        if any(self.is_false(t) for t in dependents):
            bad = next(t for t in dependents if self.is_false(t))
            self.set_false(self._root, reason="UnhealthyDependents", message=f"{bad} is False")
        elif all(self.is_true(t) for t in dependents):
            self.set_true(self._root)
        else:
            self.set_unknown(self._root)


class APIObject:
    """Base for all stored objects."""

    KIND = "Object"

    def __init__(self, name: str = "", **meta_kwargs):
        self.metadata = ObjectMeta(name=name, **meta_kwargs)
        self.status_conditions = StatusConditions()


    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def uid(self) -> str:
        return self.metadata.uid

    @property
    def deleting(self) -> bool:
        return self.metadata.deletion_timestamp is not None

    def deep_copy(self):
        return copy.deepcopy(self)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.metadata.name!r})"


class Lease(APIObject):
    """Coordination lease for leader election (the coordination.k8s.io
    Lease analogue; see operator/election.py for the elector).

    `epoch` is the fencing token (serialized as leaseTransitions over a
    real apiserver): monotonically bumped on every change of holder (and
    on re-acquisition of an EXPIRED lease), never on a renew. Every cloud
    mutation is stamped with the epoch its issuer last won; the cloud
    seam rejects mutations whose epoch trails the lease's, so a deposed
    leader's in-flight work fails closed instead of split-braining
    (karpenter_tpu_torch/fencing.py)."""

    KIND = "Lease"

    def __init__(self, name: str = "", holder: str = "", renew_deadline: float = 0.0,
                 epoch: int = 0):
        super().__init__(name)
        self.holder = holder
        self.renew_deadline = renew_deadline
        self.epoch = epoch


class ProvisioningIntent(APIObject):
    """One durable write-ahead record at the cluster/cloud seam (the
    crash-consistency journal, karpenter_tpu_torch/journal.py): written to the
    coordination bus BEFORE the cloud mutation it describes, resolved
    (deleted) once the matching claim status committed. An intent that
    survives an operator crash is exactly the work the restart recovery
    sweep must replay -- and its idempotency `token`, stamped into the
    launch as a client token and onto the instance as a tag, is what
    makes that replay launch-at-most-once."""

    KIND = "Intent"

    OP_LAUNCH = "launch"
    OP_TERMINATE = "terminate"

    def __init__(self, name: str = "", op: str = OP_LAUNCH, claim_name: str = "",
                 token: str = "", epoch: int = 0, provider_id: str = ""):
        super().__init__(name)
        self.op = op
        self.claim_name = claim_name
        self.token = token
        self.epoch = epoch
        # terminate intents record the doomed instance so recovery can
        # finish the termination even after the claim object is gone
        self.provider_id = provider_id


# seedable name generation (seed discipline, sim subsystem): generated
# object names (NodeClaim suffixes, and through them kwok node names) are
# part of the scheduler's observable decision stream. Under a seed --
# Operator(Options(seed=...)) calls seed_object_names -- suffixes come
# from a dedicated deterministic RNG drawn once per claim on the single
# reconcile thread, so two replays of one trace emit byte-identical
# decision logs. Unseeded (production default) stays uuid4.
_name_rng = None


def seed_object_names(seed: Optional[int]) -> None:
    if seed is None:
        globals()["_name_rng"] = None
    else:
        import random

        globals()["_name_rng"] = random.Random(f"object-names:{seed}")


def generate_name(prefix: str) -> str:
    if _name_rng is not None:
        return f"{prefix}{_name_rng.getrandbits(32):08x}"
    return f"{prefix}{uuid.uuid4().hex[:8]}"


# object uids draw from their OWN seeded stream for the same reason the
# intent tokens below do: every object construction mints a uid, and
# sharing the name rng would shift every generated name -- invalidating
# the committed golden decision digests for a change that never touches
# a decision. Uids are identity-only (cache keys, owner references) and
# never enter decision lines, but a replay that logs or diffs raw
# objects deserves byte-identical output too. Unseeded stays uuid4.
_uid_rng = None


def seed_object_uids(seed: Optional[int]) -> None:
    if seed is None:
        globals()["_uid_rng"] = None
    else:
        import random

        globals()["_uid_rng"] = random.Random(f"object-uids:{seed}")


def generate_uid() -> str:
    if _uid_rng is not None:
        return str(uuid.UUID(int=_uid_rng.getrandbits(128), version=4))
    return str(uuid.uuid4())


# THE idempotency-token key: stamped on the claim as an annotation (to
# thread the token into the fleet call without changing the reference's
# CloudProvider.create signature) and onto the instance as a tag (the
# recovery sweep's correlation read). One constant -- the GC shield and
# by_token lookup silently stop matching if two copies drift.
INTENT_TOKEN_KEY = "karpenter.tpu/intent-token"

# journal idempotency tokens (karpenter_tpu_torch/journal.py) draw from their OWN
# seeded stream, NOT the object-name stream above: tokens are minted per
# launch intent, and sharing the name rng would shift every claim name a
# replay generates -- invalidating the committed golden decision digests
# for a change that never touches a decision. Unseeded stays uuid4.
_token_rng = None


def seed_intent_tokens(seed: Optional[int]) -> None:
    if seed is None:
        globals()["_token_rng"] = None
    else:
        import random

        globals()["_token_rng"] = random.Random(f"intent-tokens:{seed}")


def generate_intent_token() -> str:
    if _token_rng is not None:
        return f"it-{_token_rng.getrandbits(64):016x}"
    return f"it-{uuid.uuid4().hex}"
