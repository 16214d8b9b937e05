"""Per-API batchers over the generic window batcher.

Rebuilds pkg/batcher/{createfleet,describeinstances,terminateinstances}.go:
N concurrent single-instance calls inside one batching window coalesce into
one cloud RPC, then fan individual results back to each waiter. This is the
same window that feeds the TPU solver on the scheduling side (SURVEY.md
section 2.4): accumulate for up to 35 ms idle / 1 s max, then act once.

- CreateFleet (createfleet.go:36-63): requests hash by everything EXCEPT
  target capacity (template, capacity type, override signature, tags);
  identical requests merge into one fleet call with the summed capacity and
  each waiter receives exactly one of the launched instances (leftover
  errors fan out to the unfilled waiters).
- DescribeInstances (describeinstances.go): instance-id lookups union into
  one describe; each waiter gets the slice for its ids.
- TerminateInstances (terminateinstances.go): id sets union into one call.

Copy of karpenter_tpu/batcher/cloud.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.batcher.batcher import Batcher, BatchOptions
from karpenter_tpu_torch.cache.ttl import Clock
from karpenter_tpu_torch.cloud.api import ComputeAPI
from karpenter_tpu_torch.cloud.types import FleetRequest, FleetResult


class CloudBatchers:
    """The per-API batcher bundle the instance provider launches through
    (reference: the ec2Batcher struct built in operator.go).

    `fence` (optional fencing.Fence) is checked INSIDE the mutating
    executors, after the merge window closes and immediately before the
    cloud call: the provider-level check alone leaves a window where a
    leader deposed while its request waits in the batching rendezvous
    still mutates the cloud -- here the merged call fails closed and the
    stale-epoch error fans out to every waiter."""

    def __init__(self, compute_api: ComputeAPI, options: Optional[BatchOptions] = None,
                 clock: Optional[Clock] = None, background: bool = False, fence=None):
        self.create_fleet = CreateFleetBatcher(compute_api, options, clock, background, fence)
        self.describe_instances = DescribeInstancesBatcher(compute_api, options, clock, background)
        self.terminate_instances = TerminateInstancesBatcher(compute_api, options, clock, background, fence)

    def stop(self) -> None:
        for b in (self.create_fleet, self.describe_instances, self.terminate_instances):
            b.batcher.stop()


def _union_ids(id_groups: Sequence[Tuple[str, ...]]) -> List[str]:
    """Order-preserving union of the waiters' id groups."""
    union: List[str] = []
    seen = set()
    for ids in id_groups:
        for i in ids:
            if i not in seen:
                seen.add(i)
                union.append(i)
    return union


def _fleet_key(req: FleetRequest) -> Tuple:
    return (
        req.launch_template_name,
        req.capacity_type,
        tuple(
            (o.instance_type, o.subnet_id, o.zone, o.priority, o.image_id, o.capacity_reservation_id)
            for o in req.overrides
        ),
        tuple(sorted(req.tags.items())),
        req.context,
    )


class CreateFleetBatcher:
    def __init__(self, compute_api: ComputeAPI, options: Optional[BatchOptions] = None,
                 clock: Optional[Clock] = None, background: bool = False, fence=None):
        self.compute_api = compute_api
        self.fence = fence
        self.batcher: Batcher[FleetRequest, FleetResult] = Batcher(
            self._exec, options=options, hasher=_fleet_key, clock=clock,
            background=background, name="create_fleet",
        )

    def call(self, request: FleetRequest) -> FleetResult:
        return self.batcher.call(request)

    def _exec(self, requests: Sequence[FleetRequest]) -> List[FleetResult]:
        """All requests in a bucket are identical up to target capacity
        (hasher guarantees it); issue one fleet call for the sum and deal
        instances back one per request, reference createfleet.go:47-63."""
        total = sum(r.target_capacity for r in requests)
        # idempotency tokens ride OUTSIDE the bucket hash so identical
        # requests still merge; the merged call carries every waiter's
        # tokens slot-aligned with the summed capacity (a slot without a
        # token pads with None), and the positional instance deal below
        # hands each waiter the instance launched -- or idempotently
        # replayed -- for ITS token
        tokens: List[Optional[str]] = []
        for r in requests:
            slot_tokens = list(r.client_tokens)[: r.target_capacity]
            slot_tokens += [None] * (r.target_capacity - len(slot_tokens))
            tokens.extend(slot_tokens)
        merged = FleetRequest(
            launch_template_name=requests[0].launch_template_name,
            capacity_type=requests[0].capacity_type,
            overrides=requests[0].overrides,
            target_capacity=total,
            tags=requests[0].tags,
            context=requests[0].context,
            client_tokens=tuple(tokens),
        )
        if self.fence is not None:
            # last instant before the cloud mutation (the window closed on
            # this thread): a deposition that landed while the batch was
            # accumulating fails the WHOLE merged call closed
            self.fence.check("create_fleet")
        result = self.compute_api.create_fleet(merged)
        out: List[FleetResult] = []
        cursor = 0
        for r in requests:
            got = result.instances[cursor : cursor + r.target_capacity]
            cursor += len(got)
            # waiters that got no instance still see the fleet errors so the
            # ICE-cache parse happens for each caller exactly once in the
            # reference too (instance.go:441-484)
            out.append(FleetResult(instances=got, errors=result.errors))
        return out


class DescribeInstancesBatcher:
    def __init__(self, compute_api: ComputeAPI, options: Optional[BatchOptions] = None,
                 clock: Optional[Clock] = None, background: bool = False):
        self.compute_api = compute_api
        self.batcher: Batcher[Tuple[str, ...], list] = Batcher(
            self._exec, options=options, hasher=lambda ids: 0, clock=clock,
            background=background, name="describe_instances",
        )

    def call(self, ids: Sequence[str]) -> list:
        return self.batcher.call(tuple(ids))

    def _exec(self, id_groups: Sequence[Tuple[str, ...]]) -> List[list]:
        found = self.compute_api.describe_instances(_union_ids(id_groups))
        by_id: Dict[str, object] = {inst.id: inst for inst in found}
        return [[by_id[i] for i in ids if i in by_id] for ids in id_groups]


class TerminateInstancesBatcher:
    def __init__(self, compute_api: ComputeAPI, options: Optional[BatchOptions] = None,
                 clock: Optional[Clock] = None, background: bool = False, fence=None):
        self.compute_api = compute_api
        self.fence = fence
        self.batcher: Batcher[Tuple[str, ...], list] = Batcher(
            self._exec, options=options, hasher=lambda ids: 0, clock=clock,
            background=background, name="terminate_instances",
        )

    def call(self, ids: Sequence[str]) -> list:
        return self.batcher.call(tuple(ids))

    def _exec(self, id_groups: Sequence[Tuple[str, ...]]) -> List[list]:
        if self.fence is not None:
            self.fence.check("terminate_instances")
        terminated = set(self.compute_api.terminate_instances(_union_ids(id_groups)))
        return [[i for i in ids if i in terminated] for ids in id_groups]
