"""Copy of karpenter_tpu/cache/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.cache.ttl import TTLCache
from karpenter_tpu_torch.cache.unavailable_offerings import UnavailableOfferings

# Cache TTL constants (reference: pkg/cache/cache.go -- instance types /
# offerings 5 min, unavailable offerings ICE TTL 3 min, SSM 24h, discovered
# capacity 60 days; values in seconds).
DEFAULT_TTL = 60.0
INSTANCE_TYPES_AND_OFFERINGS_TTL = 5 * 60.0
UNAVAILABLE_OFFERINGS_TTL = 3 * 60.0
SSM_CACHE_TTL = 24 * 3600.0
DISCOVERED_CAPACITY_TTL = 60 * 24 * 3600.0
INSTANCE_PROFILE_TTL = 15 * 60.0
SUBNETS_TTL = 60.0
SECURITY_GROUPS_TTL = 5 * 60.0
INSTANCE_LINK_TTL = 10 * 60.0
VALIDATION_TTL = 10 * 60.0
CAPACITY_RESERVATION_TTL = 60.0

__all__ = [
    "TTLCache",
    "UnavailableOfferings",
    "DEFAULT_TTL",
    "INSTANCE_TYPES_AND_OFFERINGS_TTL",
    "UNAVAILABLE_OFFERINGS_TTL",
    "SSM_CACHE_TTL",
    "DISCOVERED_CAPACITY_TTL",
    "INSTANCE_PROFILE_TTL",
    "SUBNETS_TTL",
    "SECURITY_GROUPS_TTL",
    "INSTANCE_LINK_TTL",
    "VALIDATION_TTL",
    "CAPACITY_RESERVATION_TTL",
]
