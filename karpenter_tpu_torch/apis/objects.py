"""Object metadata shared by the API types the solve path reads.

Trimmed copy of karpenter_tpu/apis/objects.py: ObjectMeta and the
APIObject base that Pod, Node and NodePool build on. Status conditions,
the lease, journal-intent and seeded-name machinery belong to the
controllers, which the port has not reached yet.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def generate_uid() -> str:
    return str(uuid.uuid4())


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = field(default_factory=generate_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    owner_references: List[str] = field(default_factory=list)  # uids
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0
    generation: int = 1


class APIObject:
    """Base for all stored objects."""

    KIND = "Object"

    def __init__(self, name: str = "", **meta_kwargs):
        self.metadata = ObjectMeta(name=name, **meta_kwargs)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def uid(self) -> str:
        return self.metadata.uid

    @property
    def deleting(self) -> bool:
        return self.metadata.deletion_timestamp is not None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.metadata.name!r})"
