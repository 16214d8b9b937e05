"""Instance-profile provider: identity-profile lifecycle for spec.role.

Rebuilds pkg/providers/instanceprofile/instanceprofile.go:1-133: when a
nodeclass specifies a role (rather than a pre-made instance profile), own a
cloud instance profile for it -- create it on first use, keep its role
attachment converged, and delete it when the nodeclass goes away. Profile
names are deterministic (cluster + nodeclass) so leaders recover ownership
after restart without any local state.

Copy of karpenter_tpu/providers/instanceprofile/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional

from karpenter_tpu_torch.cloud.api import IdentityAPI


class InstanceProfileProvider:
    def __init__(self, identity_api: IdentityAPI, cluster_name: str, region: str = ""):
        self.identity_api = identity_api
        self.cluster_name = cluster_name
        self.region = region
        self._ensured: Dict[str, str] = {}  # nodeclass name -> profile name

    def profile_name(self, nodeclass_name: str) -> str:
        """Deterministic managed-profile name (the reference derives it from
        cluster name + region + nodeclass so it survives restarts)."""
        digest = hashlib.sha256(
            f"{self.cluster_name}/{self.region}/{nodeclass_name}".encode()
        ).hexdigest()[:10]
        return f"karpenter_{self.cluster_name}_{nodeclass_name}_{digest}"

    def ensure(self, nodeclass_name: str, role: str, tags: Optional[Dict[str, str]] = None) -> str:
        """Create-or-converge the managed profile; returns its name."""
        name = self.profile_name(nodeclass_name)
        prof = self.identity_api.get_instance_profile(name)
        if prof is None:
            self.identity_api.create_instance_profile(
                name,
                {
                    "karpenter.tpu/cluster": self.cluster_name,
                    "karpenter.tpu/nodeclass": nodeclass_name,
                    **(tags or {}),
                },
            )
            self.identity_api.add_role(name, role)
        elif prof.get("roles") != [role]:
            self.identity_api.add_role(name, role)
        self._ensured[nodeclass_name] = name
        return name

    def get(self, nodeclass_name: str) -> Optional[Dict]:
        return self.identity_api.get_instance_profile(self.profile_name(nodeclass_name))

    def delete(self, nodeclass_name: str) -> None:
        """Finalizer path: remove the managed profile (no-op when absent)."""
        self.identity_api.delete_instance_profile(self.profile_name(nodeclass_name))
        self._ensured.pop(nodeclass_name, None)
