"""Copy of karpenter_tpu/errors/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.errors.errors import (
    CloudError,
    InsufficientCapacityError,
    NotFoundError,
    AlreadyExistsError,
    RateLimitedError,
    LaunchTemplateNotFoundError,
    NodeClassNotReadyError,
    StaleFencingEpochError,
    is_not_found,
    is_rate_limited,
    is_unfulfillable_capacity,
    to_reason_message,
)

__all__ = [
    "CloudError",
    "InsufficientCapacityError",
    "NotFoundError",
    "AlreadyExistsError",
    "RateLimitedError",
    "LaunchTemplateNotFoundError",
    "NodeClassNotReadyError",
    "StaleFencingEpochError",
    "is_not_found",
    "is_rate_limited",
    "is_unfulfillable_capacity",
    "to_reason_message",
]
