"""Cloud error taxonomy.

Rebuilds pkg/errors/errors.go:68-200: a typed classification of cloud
failures (NotFound / AlreadyExists / RateLimited / UnfulfillableCapacity /
LaunchTemplateNotFound ...) plus ToReasonMessage for event reporting, so
controllers branch on semantics instead of string-matching messages.

Copy of karpenter_tpu/errors/errors.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Tuple

UNFULFILLABLE_CAPACITY_CODES = frozenset(
    {
        "InsufficientInstanceCapacity",
        "MaxSpotInstanceCountExceeded",
        "VcpuLimitExceeded",
        "UnfulfillableCapacity",
        "Unsupported",
        "InsufficientFreeAddressesInSubnet",
        "ReservationCapacityExceeded",
    }
)
RATE_LIMIT_CODES = frozenset({"RequestLimitExceeded", "Throttling", "ThrottlingException"})
NOT_FOUND_CODES = frozenset(
    {"InvalidInstanceID.NotFound", "InvalidLaunchTemplateName.NotFoundException", "NotFound"}
)


class CloudError(Exception):
    code: str = "CloudError"

    def __init__(self, message: str = "", code: str = ""):
        super().__init__(message or self.__class__.code)
        if code:
            self.code = code


class NotFoundError(CloudError):
    code = "NotFound"


class AlreadyExistsError(CloudError):
    code = "AlreadyExists"


class RateLimitedError(CloudError):
    code = "RequestLimitExceeded"


class InsufficientCapacityError(CloudError):
    code = "InsufficientInstanceCapacity"


class LaunchTemplateNotFoundError(NotFoundError):
    code = "InvalidLaunchTemplateName.NotFoundException"


class NodeClassNotReadyError(CloudError):
    code = "NodeClassNotReady"


class StaleFencingEpochError(CloudError):
    """A cloud mutation carried a fencing epoch older than the lease's:
    the issuer was deposed and must fail closed (karpenter_tpu_torch/fencing.py).
    A CloudError so in-flight launch fan-outs take the existing error
    path -- the claim is dropped and the NEW leader re-simulates -- instead
    of crashing the deposed replica's sweep."""

    code = "StaleFencingEpoch"


def is_not_found(err: Exception) -> bool:
    return isinstance(err, NotFoundError) or getattr(err, "code", "") in NOT_FOUND_CODES


def is_rate_limited(err: Exception) -> bool:
    return isinstance(err, RateLimitedError) or getattr(err, "code", "") in RATE_LIMIT_CODES


def is_unfulfillable_capacity(code: str) -> bool:
    return code in UNFULFILLABLE_CAPACITY_CODES


def to_reason_message(err: Exception) -> Tuple[str, str]:
    """(machine reason, human message) for events/conditions."""
    code = getattr(err, "code", type(err).__name__)
    return code, str(err)
