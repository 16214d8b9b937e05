"""Launch-template provider.

Rebuilds pkg/providers/launchtemplate/launchtemplate.go: ensure-style
creation of one template per (image x maxPods x NIC count x reservation id)
group (EnsureAll :131-169 via amifamily.Resolve's grouping resolver.go:
145-186), content-hash naming so identical specs reuse templates
(LaunchTemplateName :182-184), a local cache backed by describe-then-create
(ensureLaunchTemplate :222-253), and invalidation when a fleet call reports
the template missing.

Copy of karpenter_tpu/providers/launchtemplate/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclass import TPUNodeClass
from karpenter_tpu_torch.cloud.api import ClusterAPI, ComputeAPI
from karpenter_tpu_torch.errors import CloudError
from karpenter_tpu_torch.cloud.types import LaunchTemplateInfo
from karpenter_tpu_torch.providers.image.provider import ImageProvider, ResolvedImage
from karpenter_tpu_torch.providers.launchtemplate import bootstrap
from karpenter_tpu_torch.providers.instancetype.types import InstanceType, pods_limit
from karpenter_tpu_torch.providers.securitygroup import SecurityGroupProvider


@dataclass
class ResolvedTemplate:
    """One launch-parameter group: an image plus the instance types that
    boot with identical config."""

    template_name: str
    image: ResolvedImage
    instance_types: List[InstanceType]
    max_pods: Optional[int]
    nic_count: int = 0
    capacity_reservation_id: Optional[str] = None


class LaunchTemplateProvider:
    def __init__(
        self,
        compute_api: ComputeAPI,
        cluster_api: ClusterAPI,
        images: ImageProvider,
        security_groups: SecurityGroupProvider,
        cluster_name: str = "kwok-cluster",
    ):
        self.compute_api = compute_api
        self.cluster_api = cluster_api
        self.images = images
        self.security_groups = security_groups
        self.cluster_name = cluster_name
        self._known: Dict[str, LaunchTemplateInfo] = {}

    # -- naming -------------------------------------------------------------
    @staticmethod
    def context_hash(labels: Optional[Dict[str, str]], taints: Sequence) -> str:
        """Labels/taints are rendered into user_data, so they are part of the
        template's identity -- without this, two nodepools sharing one
        nodeclass would collide on a template bootstrapping the wrong pool."""
        payload = json.dumps(
            {
                "labels": dict(labels or {}),
                "taints": [(t.key, t.value, t.effect) for t in taints],
            },
            sort_keys=True,
        )
        return hashlib.blake2b(payload.encode(), digest_size=6).hexdigest()

    def template_name(
        self,
        nodeclass: TPUNodeClass,
        image_id: str,
        max_pods: Optional[int],
        nic_count: int,
        reservation: Optional[str],
        ctx_hash: str = "",
    ) -> str:
        payload = json.dumps(
            {
                "nc": nodeclass.static_hash(),
                "img": image_id,
                "pods": max_pods,
                "nic": nic_count,
                "odcr": reservation,
                "cluster": self.cluster_name,
                "ctx": ctx_hash,
            },
            sort_keys=True,
        )
        return "kt-" + hashlib.blake2b(payload.encode(), digest_size=10).hexdigest()

    # -- resolution (amifamily.Resolve's grouping) --------------------------
    def resolve_groups(
        self,
        nodeclass: TPUNodeClass,
        instance_types: Sequence[InstanceType],
        capacity_reservation_id: Optional[str] = None,
        labels: Optional[Dict[str, str]] = None,
        taints: Sequence = (),
    ) -> List[ResolvedTemplate]:
        """Group instance types by (image, maxPods, NIC count): each group
        shares one launch template."""
        images = [
            ResolvedImage(id=i.id, name=i.name, requirements=_img_reqs(i))
            for i in nodeclass.status_images
        ] or self.images.resolve(nodeclass)
        ctx = self.context_hash(labels, taints)
        groups: Dict[tuple, ResolvedTemplate] = {}
        for it in instance_types:
            img = next((i for i in images if it.requirements.compatible(i.requirements)), None)
            if img is None:
                continue
            max_pods = int(it.capacity["pods"]) if "pods" in it.capacity else None
            nic = it.info.nic_count if it.info else 0
            key = (img.id, max_pods, nic, capacity_reservation_id)
            if key not in groups:
                groups[key] = ResolvedTemplate(
                    template_name=self.template_name(
                        nodeclass, img.id, max_pods, nic, capacity_reservation_id, ctx
                    ),
                    image=img,
                    instance_types=[],
                    max_pods=max_pods,
                    nic_count=nic,
                    capacity_reservation_id=capacity_reservation_id,
                )
            groups[key].instance_types.append(it)
        return list(groups.values())

    # -- ensure -------------------------------------------------------------
    def ensure_all(
        self,
        nodeclass: TPUNodeClass,
        instance_types: Sequence[InstanceType],
        labels: Dict[str, str],
        taints: Sequence = (),
        capacity_reservation_id: Optional[str] = None,
    ) -> List[ResolvedTemplate]:
        groups = self.resolve_groups(nodeclass, instance_types, capacity_reservation_id, labels, taints)
        sg_ids = [g.id for g in self.security_groups.list(nodeclass)]
        for group in groups:
            self._ensure(nodeclass, group, sg_ids, labels, taints)
        return groups

    def _ensure(self, nodeclass, group: ResolvedTemplate, sg_ids, labels, taints) -> None:
        name = group.template_name
        if name in self._known:
            return
        existing = self.compute_api.describe_launch_templates([name])
        if existing:
            self._known[name] = existing[0]
            return
        try:
            user_data = bootstrap.render(
                nodeclass.image_family,
                cluster_name=self.cluster_name,
                endpoint=self.cluster_api.cluster_endpoint(),
                ca_bundle=self.cluster_api.cluster_ca_bundle(),
                nodeclass=nodeclass,
                labels=labels,
                taints=list(taints),
                max_pods=group.max_pods,
            )
        except ValueError as e:
            # invalid user_data on ONE nodeclass must fail that launch, not
            # crash the whole provisioning tick (the provisioner catches
            # CloudError per launch; the reference surfaces the same class
            # of failure through nodeclass status validation)
            raise CloudError(
                f"nodeclass {nodeclass.name}: bootstrap rendering failed: {e}",
                code="InvalidUserData",
            ) from e
        lt = LaunchTemplateInfo(
            id="",
            name=name,
            image_id=group.image.id,
            security_group_ids=sg_ids,
            user_data=user_data,
            tags={**nodeclass.tags, wk.LABEL_NODECLASS: nodeclass.name},
            metadata_http_tokens=nodeclass.metadata_http_tokens,
            block_devices=[vars(b) for b in nodeclass.block_device_mappings],
            instance_profile=nodeclass.status_instance_profile or nodeclass.instance_profile,
            capacity_reservation_id=group.capacity_reservation_id,
            nic_count=group.nic_count,
        )
        self._known[name] = self.compute_api.create_launch_template(lt)

    def invalidate(self, name: str) -> None:
        """Fleet said NotFound: drop cache so next ensure recreates
        (reference: invalidation on fleet NotFound, launchtemplate.go)."""
        self._known.pop(name, None)

    def hydrate(self) -> None:
        """Leader-election cache hydration (launchtemplate.go:120-128)."""
        for lt in self.compute_api.describe_launch_templates():
            self._known[lt.name] = lt

    def delete_all(self, nodeclass: TPUNodeClass) -> None:
        """Finalizer path: remove templates owned by this nodeclass."""
        for lt in self.compute_api.describe_launch_templates():
            if lt.tags.get(wk.LABEL_NODECLASS) == nodeclass.name:
                self.compute_api.delete_launch_template(lt.name)
                self._known.pop(lt.name, None)


def _img_reqs(status_image):
    from karpenter_tpu_torch.scheduling import Requirements

    reqs = Requirements()
    for r in getattr(status_image, "requirements", []) or []:
        reqs.add(r)
    return reqs
