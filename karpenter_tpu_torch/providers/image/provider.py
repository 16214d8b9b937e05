"""Image (AMI-family analog) provider.

Rebuilds the discovery half of pkg/providers/amifamily: images found via
alias (param-store lookup, the SSM path), tags, ids, or names
(amifamily/ami.go DescribeImageQueries), each carrying arch requirements so
the launch path can match images to instance types
(reference: Resolve groups instance types by image at resolver.go:126-188).
Userdata bootstrapping lives in providers/launchtemplate/bootstrap.py.

Copy of karpenter_tpu/providers/image/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclass import TPUNodeClass
from karpenter_tpu_torch.cache.ttl import Clock
from karpenter_tpu_torch.cloud.api import ComputeAPI, ParamStoreAPI
from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements


@dataclass
class ResolvedImage:
    id: str
    name: str
    requirements: Requirements = field(default_factory=Requirements)
    creation_time: float = 0.0


class ImageProvider:
    def __init__(self, compute_api: ComputeAPI, params: ParamStoreAPI, clock: Optional[Clock] = None):
        from karpenter_tpu_torch.providers.params import ParamStoreProvider

        self.compute_api = compute_api
        # alias resolution goes through the param-store provider (the ssm
        # provider seam in the reference); accept either a raw ParamStoreAPI
        # (wrapped here) or a pre-built provider
        if isinstance(params, ParamStoreProvider):
            self.params = params
        else:
            self.params = ParamStoreProvider(params, clock)
        self._alias_params = set()  # param keys this provider resolved

    def invalidate_missing(self, live_ids) -> int:
        """Drop cached alias resolutions whose image id is no longer in the
        live set (mirrors the SSM-invalidation controller's contract in the
        reference, pkg/controllers/providers/ssm/invalidation); returns the
        number of entries dropped. Scoped to the alias params this provider
        resolved -- the param store is shared, and other consumers' values
        are not image ids."""
        return self.params.invalidate_missing(live_ids, keys=self._alias_params)

    def resolve(self, nodeclass: TPUNodeClass) -> List[ResolvedImage]:
        images = {i.id: i for i in self.compute_api.describe_images()}
        out: List[ResolvedImage] = []
        seen = set()
        for term in nodeclass.image_selector_terms:
            matches = []
            if term.alias:
                family, _, version = term.alias.partition("@")
                for arch in ("amd64", "arm64"):
                    param = f"/images/{family.lower()}/{version or 'latest'}/{arch}"
                    self._alias_params.add(param)
                    img_id = self.params.get(param)
                    if img_id and img_id in images:
                        matches.append(images[img_id])
            elif term.id:
                if term.id in images:
                    matches.append(images[term.id])
            else:
                for img in images.values():
                    if term.matches(id=img.id, name=img.name, tags=img.tags):
                        matches.append(img)
            for img in matches:
                if img.id in seen or img.deprecated:
                    continue
                seen.add(img.id)
                out.append(
                    ResolvedImage(
                        id=img.id,
                        name=img.name,
                        requirements=Requirements([Requirement(wk.ARCH_LABEL, Operator.IN, [img.arch])]),
                        creation_time=img.creation_time,
                    )
                )
        # newest image first (creation time desc, name as tiebreak), matching
        # the reference's deterministic ordering
        out.sort(key=lambda r: (-r.creation_time, r.name))
        return out
