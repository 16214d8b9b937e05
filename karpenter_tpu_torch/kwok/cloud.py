"""In-memory cloud emulator -- the kwok/ec2 analogue and scale-benchmark rig.

Rebuilds the behavior of the reference's kwok harness (kwok/ec2/ec2.go:56-944):

- serves the instance-type/subnet/image catalog (ours from the deterministic
  gen_catalog pipeline rather than a live account, ec2.go:77-116)
- emulates CreateFleet: scores overrides lowest-price-first
  (ec2.go:432-461 + kwok/strategy/strategy.go:28-60), fabricates instances,
  and reports InsufficientInstanceCapacity per-override when a capacity pool
  is exhausted -- feeding the ICE cache exactly like real fleet errors
- per-API token-bucket rate limiting (kwok/ec2/ratelimiting.go:95-136)
- checkpoint/restore of the fabricated fleet (ec2.go:118-251 persists to
  ConfigMaps; here to a JSON-able dict)
- random kill switch to exercise repair/interruption paths
  (StartKillNodeThread ec2.go:253-281)

Also implements the Pricing/Queue/ParamStore/Identity/Cluster interfaces so
one object can back the whole provider graph in tests (the role of pkg/fake's
api fixtures, pkg/fake/ec2api.go et al.).

Copy of karpenter_tpu/kwok/cloud.py, imports rewritten to the port's.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.cloud.api import (
    ClusterAPI,
    ComputeAPI,
    IdentityAPI,
    ParamStoreAPI,
    PricingAPI,
    QueueAPI,
)
from karpenter_tpu_torch.cloud.types import (
    CapacityReservationInfo,
    CloudInstance,
    FleetError,
    FleetRequest,
    FleetResult,
    ImageInfo,
    InstanceTypeInfo,
    LaunchTemplateInfo,
    QueueMessage,
    SecurityGroupInfo,
    SubnetInfo,
    ZoneInfo,
)
from karpenter_tpu_torch.providers.instancetype import gen_catalog

ICE_CODE = "InsufficientInstanceCapacity"
RATE_LIMIT_CODE = "RequestLimitExceeded"
# idempotency-token tag: the journal's launch token rides onto the
# instance so a restart can correlate a launched instance with the intent
# whose claim status never committed (karpenter_tpu_torch/journal.py). The key
# itself lives in apis/objects (core, not the emulator) -- this is a
# re-export for the suites that read instance tags.
from karpenter_tpu_torch.apis.objects import INTENT_TOKEN_KEY as INTENT_TOKEN_TAG  # noqa: E402


class RateLimitError(Exception):
    code = RATE_LIMIT_CODE


class RateLimiter:
    """Token bucket (reference: kwok/ec2/ratelimiting.go:95-136)."""

    def __init__(self, rate_per_sec: float, burst: int, clock=None):
        self.rate = rate_per_sec
        self.burst = burst
        self._tokens = float(burst)
        self._last = None
        self._clock = clock
        self._lock = threading.Lock()

    def _now(self) -> float:
        return self._clock.now() if self._clock else time.monotonic()

    def allow(self) -> bool:
        with self._lock:
            now = self._now()
            if self._last is not None:
                self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


class FakeCloud(ComputeAPI, PricingAPI, QueueAPI, ParamStoreAPI, IdentityAPI, ClusterAPI):
    def __init__(
        self,
        clock=None,
        rate_limit: Optional[float] = None,
        capacity_pools: Optional[Dict[Tuple[str, str, str], int]] = None,
        subnet_ip_count: int = 4096,
    ):
        self._clock = clock
        self._lock = threading.RLock()
        self._id_seq = itertools.count(1)

        # catalog
        self._types: List[InstanceTypeInfo] = gen_catalog.generate_instance_types()
        self._types_by_name = {t.name: t for t in self._types}
        self._zones = list(gen_catalog.ZONES)
        self.region = gen_catalog.REGION

        # networking fixtures: one cluster subnet + SG per zone
        self._subnets = [
            SubnetInfo(
                id=f"subnet-{z.zone_id}",
                zone=z.name,
                zone_id=z.zone_id,
                available_ip_count=subnet_ip_count,
                tags={"karpenter.tpu/discovery": "testing", "Name": f"private-{z.name}"},
            )
            for z in self._zones
        ]
        self._security_groups = [
            SecurityGroupInfo(id="sg-nodes", name="cluster-nodes", tags={"karpenter.tpu/discovery": "testing"}),
            SecurityGroupInfo(id="sg-extra", name="cluster-extra", tags={"other": "tag"}),
        ]
        self._images = [
            ImageInfo(id="img-std-amd64", name="standard-k8s-1.32-amd64", arch="amd64", family="Standard", creation_time=100.0),
            ImageInfo(id="img-std-arm64", name="standard-k8s-1.32-arm64", arch="arm64", family="Standard", creation_time=100.0),
            ImageInfo(id="img-min-amd64", name="minimal-k8s-1.32-amd64", arch="amd64", family="Minimal", creation_time=90.0),
            ImageInfo(id="img-acc-amd64", name="accelerated-k8s-1.32-amd64", arch="amd64", family="Accelerated", creation_time=100.0),
        ]
        self._params = {
            "/images/standard/latest/amd64": "img-std-amd64",
            "/images/standard/latest/arm64": "img-std-arm64",
            "/images/minimal/latest/amd64": "img-min-amd64",
            "/images/accelerated/latest/amd64": "img-acc-amd64",
        }
        self._reservations: List[CapacityReservationInfo] = []

        # fleet state
        self._instances: Dict[str, CloudInstance] = {}
        # client-token idempotency (the EC2 ClientToken analogue): token ->
        # instance id. A replayed launch slot with a known token returns
        # the existing instance -- the cloud-side half of the journal's
        # launch-at-most-once contract.
        self._fleet_tokens: Dict[str, str] = {}
        self.idempotent_hits = 0
        self._launch_templates: Dict[str, LaunchTemplateInfo] = {}
        self._instance_profiles: Dict[str, Dict] = {}
        self._queue: List[QueueMessage] = []
        self._inflight: Dict[str, QueueMessage] = {}

        # capacity pools: (instance_type, zone, capacity_type) -> remaining.
        # None (absent key) = unlimited; tests/benchmarks inject exhaustion.
        self._capacity_pools: Dict[Tuple[str, str, str], int] = dict(capacity_pools or {})

        # rate limiting (off by default; the scale rig turns it on)
        self._limiters: Dict[str, RateLimiter] = {}
        if rate_limit:
            for api in ("create_fleet", "describe_instances", "terminate_instances", "describe_instance_types"):
                self._limiters[api] = RateLimiter(rate_limit, int(rate_limit * 2), clock)

        # call counters (test observability, like pkg/fake atomic slots)
        self.calls: Dict[str, int] = {}
        # injectable per-API errors: api name -> list of exceptions to raise
        self.inject_errors: Dict[str, List[Exception]] = {}
        # chaos observers (sim/trace.TraceRecorder): callbacks fired on
        # external mutations of the emulated cloud -- kills, interruption
        # sends, capacity-pool edits, price overrides -- so a live or
        # chaos run can be captured as a replayable trace at this seam
        self.chaos_observers: List = []
        # price overrides: instance type -> multiplicative factor applied
        # over the static catalog prices (sim `price` events; the pricing
        # provider picks the change up on its next refresh)
        self._price_factors: Dict[str, float] = {}

    def _notify_chaos(self, kind: str, **detail) -> None:
        for obs in list(self.chaos_observers):
            try:
                obs(kind, detail)
            except Exception:  # noqa: BLE001 -- observers must never fault the cloud
                from karpenter_tpu_torch import metrics

                metrics.HANDLED_ERRORS.inc(site="kwok.chaos_observer")

    # -- plumbing -----------------------------------------------------------
    def _now(self) -> float:
        return self._clock.now() if self._clock else time.time()

    def _enter(self, api: str) -> None:
        with self._lock:
            self.calls[api] = self.calls.get(api, 0) + 1
        lim = self._limiters.get(api)
        if lim and not lim.allow():
            raise RateLimitError(f"{api}: rate limited")
        errs = self.inject_errors.get(api)
        if errs:
            raise errs.pop(0)

    # -- ComputeAPI: catalog ------------------------------------------------
    def describe_zones(self) -> List[ZoneInfo]:
        self._enter("describe_zones")
        return list(self._zones)

    def describe_instance_types(self) -> List[InstanceTypeInfo]:
        self._enter("describe_instance_types")
        return list(self._types)

    def describe_instance_type_offerings(self) -> Dict[str, List[str]]:
        self._enter("describe_instance_type_offerings")
        return {t.name: list(t.zones) for t in self._types}

    def describe_subnets(self) -> List[SubnetInfo]:
        self._enter("describe_subnets")
        return [SubnetInfo(s.id, s.zone, s.zone_id, s.available_ip_count, dict(s.tags)) for s in self._subnets]

    def describe_security_groups(self) -> List[SecurityGroupInfo]:
        self._enter("describe_security_groups")
        return list(self._security_groups)

    def describe_images(self) -> List[ImageInfo]:
        self._enter("describe_images")
        return list(self._images)

    def describe_capacity_reservations(self) -> List[CapacityReservationInfo]:
        self._enter("describe_capacity_reservations")
        return [CapacityReservationInfo(**vars(r)) for r in self._reservations]

    def add_capacity_reservation(self, cr: CapacityReservationInfo) -> None:
        with self._lock:
            self._reservations.append(cr)

    # -- ComputeAPI: fleet --------------------------------------------------
    def set_capacity(self, instance_type: str, zone: str, capacity_type: str, count: int) -> None:
        """Exhaustible capacity pool; emulates ICE when drained."""
        with self._lock:
            self._capacity_pools[(instance_type, zone, capacity_type)] = count
        self._notify_chaos(
            "set_capacity", instance_type=instance_type, zone=zone,
            capacity_type=capacity_type, count=count,
        )

    def _pool_take(self, instance_type: str, zone: str, capacity_type: str) -> bool:
        key = (instance_type, zone, capacity_type)
        with self._lock:
            remaining = self._capacity_pools.get(key)
            if remaining is None:
                return True
            if remaining <= 0:
                return False
            self._capacity_pools[key] = remaining - 1
            return True

    def _reservation_take(self, reservation_id: str) -> bool:
        """Consume one reservation slot (the real cloud decrements reservation
        availability as instances launch into it; Describe reflects it)."""
        with self._lock:
            for r in self._reservations:
                if r.id == reservation_id:
                    if r.available_count <= 0:
                        return False
                    r.available_count -= 1
                    return True
            return False

    def _reservation_release(self, reservation_id: str) -> None:
        with self._lock:
            for r in self._reservations:
                if r.id == reservation_id and r.available_count < r.total_count:
                    r.available_count += 1

    def set_price_factor(self, instance_type: str, factor: float) -> None:
        """Multiplicative price override over the static catalog tables
        (sim `price` events: spot-market swings, list-price changes). Both
        the pricing APIs and the fleet's lowest-price ranking honor it."""
        with self._lock:
            if factor == 1.0:
                self._price_factors.pop(instance_type, None)
            else:
                self._price_factors[instance_type] = float(factor)
        self._notify_chaos(
            "set_price_factor", instance_type=instance_type, factor=factor,
        )

    def _price_factor(self, instance_type: str) -> float:
        return self._price_factors.get(instance_type, 1.0)

    def _score(self, instance_type: str, capacity_type: str, zone: str) -> float:
        """Lowest-price strategy (kwok/strategy/strategy.go:28-60)."""
        info = self._types_by_name.get(instance_type)
        if info is None:
            return float("inf")
        if capacity_type == wk.CAPACITY_TYPE_SPOT:
            return gen_catalog.spot_price(info, zone) * self._price_factor(instance_type)
        return gen_catalog.on_demand_price(info) * self._price_factor(instance_type)

    def create_fleet(self, request: FleetRequest) -> FleetResult:
        self._enter("create_fleet")
        lt = self._launch_templates.get(request.launch_template_name)
        if lt is None:
            raise KeyError(f"launch template {request.launch_template_name} not found")
        subnets_by_id = {s.id: s for s in self._subnets}
        ranked = sorted(
            request.overrides,
            key=lambda o: (o.priority, self._score(o.instance_type, request.capacity_type, o.zone)),
        )
        instances: List[CloudInstance] = []
        errors: List[FleetError] = []
        exhausted = set()
        for slot in range(request.target_capacity):
            token = (
                request.client_tokens[slot]
                if slot < len(request.client_tokens) else None
            )
            if token:
                with self._lock:
                    existing = self._instances.get(self._fleet_tokens.get(token, ""))
                if existing is not None and existing.state not in ("terminated",):
                    # idempotent replay: this slot's token already backs a
                    # live instance (a crashed operator's journal replaying
                    # its open launch intent) -- return it, launch nothing
                    with self._lock:
                        self.idempotent_hits += 1
                    instances.append(existing)
                    continue
            placed = False
            for o in ranked:
                key = (o.instance_type, o.zone)
                if key in exhausted:
                    continue
                subnet = subnets_by_id.get(o.subnet_id)
                if subnet is None or subnet.available_ip_count <= 0:
                    continue
                if not self._pool_take(o.instance_type, o.zone, request.capacity_type):
                    exhausted.add(key)
                    errors.append(
                        FleetError(
                            code=ICE_CODE,
                            message=f"no {request.capacity_type} capacity for {o.instance_type} in {o.zone}",
                            instance_type=o.instance_type,
                            zone=o.zone,
                            capacity_type=request.capacity_type,
                        )
                    )
                    continue
                if o.capacity_reservation_id and not self._reservation_take(o.capacity_reservation_id):
                    exhausted.add(key)
                    errors.append(
                        FleetError(
                            code="ReservationCapacityExceeded",
                            message=f"reservation {o.capacity_reservation_id} exhausted",
                            instance_type=o.instance_type,
                            zone=o.zone,
                            capacity_type=request.capacity_type,
                        )
                    )
                    continue
                iid = f"i-{next(self._id_seq):08x}"
                tags = dict(request.tags)
                if token:
                    tags[INTENT_TOKEN_TAG] = token
                inst = CloudInstance(
                    id=iid,
                    instance_type=o.instance_type,
                    zone=o.zone,
                    subnet_id=o.subnet_id,
                    capacity_type=request.capacity_type,
                    image_id=o.image_id or lt.image_id,
                    state="running",
                    launch_time=self._now(),
                    tags=tags,
                    capacity_reservation_id=o.capacity_reservation_id,
                    nic_count=lt.nic_count,
                    security_group_ids=list(lt.security_group_ids),
                )
                with self._lock:
                    self._instances[iid] = inst
                    subnet.available_ip_count -= 1
                    if token:
                        self._fleet_tokens[token] = iid
                instances.append(inst)
                placed = True
                break
            if not placed:
                if not errors:
                    errors.append(FleetError(code=ICE_CODE, message="no capacity in any override"))
                break
        return FleetResult(instances=instances, errors=errors)

    def describe_instances(self, ids: Sequence[str] = (), tag_filter: Optional[Dict[str, str]] = None) -> List[CloudInstance]:
        self._enter("describe_instances")
        with self._lock:
            out = []
            for inst in self._instances.values():
                if ids and inst.id not in ids:
                    continue
                if tag_filter and not all(
                    (inst.tags.get(k) == v or (v == "*" and k in inst.tags)) for k, v in tag_filter.items()
                ):
                    continue
                out.append(inst)
            return out

    def terminate_instances(self, ids: Sequence[str]) -> List[str]:
        self._enter("terminate_instances")
        done = []
        released = []
        with self._lock:
            for iid in ids:
                inst = self._instances.get(iid)
                if inst and inst.state not in ("terminated",):
                    inst.state = "terminated"
                    done.append(iid)
                    if inst.capacity_reservation_id:
                        released.append(inst.capacity_reservation_id)
        for rid in released:
            self._reservation_release(rid)
        return done

    def create_tags(self, resource_id: str, tags: Dict[str, str]) -> None:
        self._enter("create_tags")
        with self._lock:
            inst = self._instances.get(resource_id)
            if inst is None:
                raise KeyError(f"resource {resource_id} not found")
            inst.tags.update(tags)

    # -- ComputeAPI: launch templates ---------------------------------------
    def create_launch_template(self, lt: LaunchTemplateInfo) -> LaunchTemplateInfo:
        self._enter("create_launch_template")
        with self._lock:
            lt.created_at = self._now()
            if not lt.id:
                lt.id = f"lt-{next(self._id_seq):08x}"
            self._launch_templates[lt.name] = lt
        return lt

    def describe_launch_templates(self, names: Sequence[str] = ()) -> List[LaunchTemplateInfo]:
        self._enter("describe_launch_templates")
        with self._lock:
            if not names:
                return list(self._launch_templates.values())
            return [self._launch_templates[n] for n in names if n in self._launch_templates]

    def delete_launch_template(self, name: str) -> None:
        self._enter("delete_launch_template")
        with self._lock:
            self._launch_templates.pop(name, None)

    def spot_price_history(self) -> Dict[tuple, float]:
        self._enter("spot_price_history")
        out = {}
        for t in self._types:
            if "spot" in t.supported_usage_classes:
                for z in t.zones:
                    out[(t.name, z)] = gen_catalog.spot_price(t, z) * self._price_factor(t.name)
        return out

    # -- PricingAPI ---------------------------------------------------------
    def on_demand_prices(self) -> Dict[str, float]:
        self._enter("on_demand_prices")
        return {
            t.name: gen_catalog.on_demand_price(t) * self._price_factor(t.name)
            for t in self._types
        }

    # -- QueueAPI -----------------------------------------------------------
    def queue_url(self) -> str:
        return "mem://interruption-queue"

    def send(self, body: str) -> None:
        with self._lock:
            mid = f"msg-{next(self._id_seq):08x}"
            self._queue.append(QueueMessage(id=mid, receipt=mid, body=body))
        if self.chaos_observers:
            # capture seam: an interruption message entering the queue is
            # an external event worth a trace line (best-effort: only the
            # EventBridge detail.instance-id shape is replayable)
            try:
                iid = json.loads(body).get("detail", {}).get("instance-id")
            except (ValueError, AttributeError, TypeError, KeyError):
                # a malformed chaos payload carries no instance id; the
                # narrow net keeps real faults (and crashes) propagating
                iid = None
            if iid:
                self._notify_chaos("interruption", instance_id=iid)

    def receive(self, max_messages: int = 10) -> List[QueueMessage]:
        self._enter("receive")
        with self._lock:
            batch = self._queue[:max_messages]
            self._queue = self._queue[max_messages:]
            for m in batch:
                self._inflight[m.receipt] = m
            return batch

    def delete(self, receipt: str) -> None:
        self._enter("queue_delete")
        with self._lock:
            self._inflight.pop(receipt, None)

    # -- ParamStoreAPI ------------------------------------------------------
    def get_parameter(self, name: str) -> Optional[str]:
        self._enter("get_parameter")
        return self._params.get(name)

    # -- IdentityAPI --------------------------------------------------------
    def create_instance_profile(self, name: str, tags: Dict[str, str]) -> None:
        self._enter("create_instance_profile")
        with self._lock:
            if name in self._instance_profiles:
                raise KeyError(f"instance profile {name} already exists")
            self._instance_profiles[name] = {"name": name, "tags": dict(tags), "roles": []}

    def get_instance_profile(self, name: str) -> Optional[Dict]:
        self._enter("get_instance_profile")
        return self._instance_profiles.get(name)

    def delete_instance_profile(self, name: str) -> None:
        self._enter("delete_instance_profile")
        with self._lock:
            self._instance_profiles.pop(name, None)

    def add_role(self, profile_name: str, role: str) -> None:
        self._enter("add_role")
        prof = self._instance_profiles.get(profile_name)
        if prof is None:
            raise KeyError(f"instance profile {profile_name} not found")
        prof["roles"] = [role]

    # -- ClusterAPI ---------------------------------------------------------
    def cluster_endpoint(self) -> str:
        return "https://cluster.local:6443"

    def cluster_version(self) -> str:
        return "1.32"

    def cluster_ca_bundle(self) -> str:
        return "ca-bundle"

    # -- fault injection / chaos (rig features) -----------------------------
    def kill_instance(self, instance_id: str) -> bool:
        """Abruptly terminate (repair-path exercise; ec2.go:253-281)."""
        with self._lock:
            inst = self._instances.get(instance_id)
            if inst is None or inst.state == "terminated":
                return False
            inst.state = "terminated"
        self._notify_chaos("kill_instance", instance_id=instance_id)
        return True

    def degrade_instance(self, instance_id: str, condition: str = "Ready") -> bool:
        """Leave the instance RUNNING but unhealthy: its Node reports
        `condition`=False until replaced -- the auto-repair path (dead
        instances take the GC path instead; the reference kwok kill thread
        exercises both)."""
        with self._lock:
            inst = self._instances.get(instance_id)
            if inst is None or inst.state == "terminated":
                return False
            inst.impaired_condition = condition
            return True

    # -- checkpoint/restore (ec2.go:118-251) --------------------------------
    def checkpoint(self) -> str:
        with self._lock:
            doc = {
                "instances": [vars(i) for i in self._instances.values()],
                "launch_templates": [vars(lt) for lt in self._launch_templates.values()],
                "capacity_pools": [[list(k), v] for k, v in self._capacity_pools.items()],
                "subnet_ips": {s.id: s.available_ip_count for s in self._subnets},
                "id_seq": next(self._id_seq),
                "fleet_tokens": dict(self._fleet_tokens),
            }
        return json.dumps(doc)

    def restore(self, blob: str) -> None:
        doc = json.loads(blob)
        with self._lock:
            self._instances = {d["id"]: CloudInstance(**d) for d in doc["instances"]}
            self._launch_templates = {d["name"]: LaunchTemplateInfo(**d) for d in doc["launch_templates"]}
            self._capacity_pools = {tuple(k): v for k, v in doc["capacity_pools"]}
            for s in self._subnets:
                if s.id in doc["subnet_ips"]:
                    s.available_ip_count = doc["subnet_ips"][s.id]
            self._id_seq = itertools.count(doc["id_seq"])
            self._fleet_tokens = dict(doc.get("fleet_tokens", {}))
