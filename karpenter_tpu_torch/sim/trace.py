"""Trace format + recorder: the event-sourced ground truth of a run.

A trace is JSONL -- one event object per line, applied strictly in order.
The vocabulary covers everything that crosses into the operator from the
outside world (the kube/kwok cluster seam and the cloud seam); everything
the operator DOES in response is recomputed at replay time by the real
controller stack, which is what makes a trace a behavioral spec rather
than a log.

Event vocabulary (version 1):

    {"ev": "header", "version": 1, "scenario": ..., "seed": ...,
     "tick_seconds": ...}                      # optional first line
    {"ev": "advance", "dt": 3.0}               # clock.step(dt) + one tick
    {"ev": "pod_add", "pod": {...}}            # pending pod arrives
    {"ev": "pod_delete", "name": "..."}        # pod deleted out from under us
    {"ev": "kill_node", "pick": 0}             # abrupt instance death
    {"ev": "interruption", "pick": 0}          # spot-interruption message
    {"ev": "ice", "instance_type": t, "zone": z,
     "capacity_type": "spot", "count": 0}      # (ex|re)haust a capacity pool
    {"ev": "price", "instance_type": t, "factor": 1.5}  # pricing update
    {"ev": "device_lost", "device": 7}         # mesh device dies (the
                                               # topology epoch bumps; the
                                               # mesh backend reshards)
    {"ev": "device_returned", "device": 7}     # mesh device comes back
                                               # (re-promotion to full)
    {"ev": "crash", "site": "crash.launch"}    # arm a one-shot crash
                                               # failpoint; the next tick
                                               # that reaches the site dies
                                               # mid-flight and the engine
                                               # restarts the operator over
                                               # the surviving state
    {"ev": "operator_restart"}                 # clean restart between ticks
                                               # (kill -9 while idle):
                                               # fresh operator, new
                                               # identity, lease takeover
                                               # after expiry, recovery
                                               # sweep on the win
    {"ev": "failpoint",
     "spec": "rpc.server.dispatch=latency(0.003):times=12"}
                                               # arm a fault schedule
                                               # mid-trace (the overload
                                               # family's slow-sidecar
                                               # windows); wall-clock-only
                                               # faults never touch
                                               # decisions, so digests
                                               # stay backend-identical.
                                               # The engine disarms the
                                               # named sites at close.

The header may carry an ``options`` object: Operator Options overrides
for the replay, WHITELISTED by the engine to the COUNT-based overload
knobs (``admission_max_pods``, ``launch_max_groups``) -- the
overload-storm scenario pins its shedding digest through it.
``tick_deadline`` is deliberately rejected: its shedding is sized from
wall-clock EWMAs, which would make digests host-speed-dependent.

`pick` selects a victim deterministically at APPLY time: index into the
ready fleet ordered by node name (claim names are seed-deterministic, so
the same pick hits the same node on every backend; raw instance ids are
NOT stable across runs -- fleet batches assign them in thread-arrival
order -- and never appear in traces). Recorded traces also carry the
observed `node` name for human readers; replay prefers `pick`.

Pod specs serialize the scheduling-relevant subset (name, requests,
labels, node_selector, topology spread) -- enough for every scenario the
DSL generates and for capture of plain workloads; exotic pods degrade to
their resource shape with a `lossy` marker rather than failing capture.

Copy of karpenter_tpu/sim/trace.py, imports rewritten to the port's.
"""
from __future__ import annotations

import json
from typing import Iterable, List, Optional

TRACE_VERSION = 1

EVENT_KINDS = (
    "header", "advance", "pod_add", "pod_delete", "kill_node",
    "interruption", "ice", "price", "crash", "operator_restart",
    "failpoint", "device_lost", "device_returned",
)


class TraceFormatError(ValueError):
    pass


def validate_event(ev: dict, lineno: int = 0) -> dict:
    if not isinstance(ev, dict) or "ev" not in ev:
        raise TraceFormatError(f"line {lineno}: not an event object: {ev!r}")
    kind = ev["ev"]
    if kind not in EVENT_KINDS:
        raise TraceFormatError(f"line {lineno}: unknown event kind {kind!r}")
    if kind == "advance" and not isinstance(ev.get("dt"), (int, float)):
        raise TraceFormatError(f"line {lineno}: advance needs numeric dt")
    if kind == "pod_add" and not isinstance(ev.get("pod"), dict):
        raise TraceFormatError(f"line {lineno}: pod_add needs a pod object")
    if kind == "crash" and not (isinstance(ev.get("site"), str) and ev["site"]):
        raise TraceFormatError(f"line {lineno}: crash needs a failpoint site")
    if kind in ("device_lost", "device_returned") and not isinstance(
            ev.get("device"), int):
        raise TraceFormatError(
            f"line {lineno}: {kind} needs an integer device index")
    if kind == "failpoint" and not (isinstance(ev.get("spec"), str) and ev["spec"]):
        raise TraceFormatError(f"line {lineno}: failpoint needs a spec string")
    if kind == "header" and ev.get("version") != TRACE_VERSION:
        raise TraceFormatError(
            f"line {lineno}: unsupported trace version {ev.get('version')!r}"
        )
    return ev


def read_trace(path: str) -> List[dict]:
    events: List[dict] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            events.append(validate_event(json.loads(line), i))
    return events


def write_trace(path: str, events: Iterable[dict]) -> int:
    n = 0
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev, sort_keys=True, separators=(",", ":")) + "\n")
            n += 1
    return n


# -- pod (de)serialization ---------------------------------------------------

def pod_to_spec(pod) -> dict:
    """Scheduling-relevant subset of a Pod, round-trippable through
    pod_from_spec. Fields outside the subset mark the spec `lossy` so a
    replayed trace is honest about what it reproduces."""
    from karpenter_tpu_torch.scheduling.resources import format_quantity

    spec: dict = {
        "name": pod.metadata.name,
        "requests": {
            axis: format_quantity(v, axis) for axis, v in pod.requests.items()
        },
    }
    if pod.metadata.labels:
        spec["labels"] = dict(pod.metadata.labels)
    if pod.node_selector:
        spec["node_selector"] = dict(pod.node_selector)
    if pod.topology_spread:
        spec["spread"] = [
            {
                "key": t.topology_key,
                "max_skew": t.max_skew,
                "when_unsatisfiable": t.when_unsatisfiable,
                "selector": dict(t.label_selector),
            }
            for t in pod.topology_spread
        ]
    if (
        pod.node_affinity_terms or pod.affinity_terms
        or pod.preferred_node_affinity_terms or pod.preferred_affinity_terms
        or pod.volume_claims or pod.scheduling_gates
    ):
        spec["lossy"] = True
    return spec


def pod_from_spec(spec: dict):
    from karpenter_tpu_torch.apis import Pod
    from karpenter_tpu_torch.apis.pod import TopologySpreadConstraint
    from karpenter_tpu_torch.scheduling import Resources

    spread = [
        TopologySpreadConstraint(
            max_skew=int(t.get("max_skew", 1)),
            topology_key=t["key"],
            when_unsatisfiable=t.get("when_unsatisfiable", "DoNotSchedule"),
            label_selector=dict(t.get("selector", {})),
        )
        for t in spec.get("spread", ())
    ]
    return Pod(
        spec["name"],
        requests=Resources(spec.get("requests", {})),
        labels=dict(spec.get("labels", {})),
        node_selector=dict(spec.get("node_selector", {})),
        topology_spread=spread,
    )


def ranked_victims(cluster) -> list:
    """THE victim ranking for `pick` resolution: live (non-deleting) nodes
    with a provider id, ordered by node name. One copy shared by the
    recorder (rank -> pick at capture) and the replay engine (pick -> rank
    at apply) -- a drifted duplicate would make a recorded kill replay
    against the WRONG node whenever the two sets disagreed (e.g. a node
    mid-termination at capture time)."""
    from karpenter_tpu_torch.apis import Node

    return sorted(
        (n for n in cluster.list(Node) if n.provider_id and not n.deleting),
        key=lambda n: n.metadata.name,
    )


# -- capture hook ------------------------------------------------------------

class TraceRecorder:
    """Capture hook at the cluster/cloud seam: subscribes to the object
    store's watch stream for pod arrivals/deletions, to the cloud's chaos
    observer for kills/interruptions/ICE/pricing mutations, and is fed
    clock advances by the run loop (`record_tick`). The buffered event
    list is a replayable trace of everything external that happened.

    Pod MODIFIED events are deliberately not captured: binds, phase flips
    and claim bookkeeping are operator OUTPUT, recomputed at replay.
    """

    def __init__(self, cluster, clock, scenario: str = "recorded",
                 seed: Optional[int] = None):
        self.cluster = cluster
        self.clock = clock
        self.events: List[dict] = [{
            "ev": "header", "version": TRACE_VERSION, "scenario": scenario,
            **({"seed": seed} if seed is not None else {}),
        }]
        self._last_t = clock.now()
        self._attached_cloud = None

    # -- wiring --------------------------------------------------------------
    def attach(self, cloud=None) -> "TraceRecorder":
        from karpenter_tpu_torch.apis import Pod

        def on_event(event: str, obj) -> None:
            if not isinstance(obj, Pod):
                return
            if event == "ADDED":
                self.events.append({"ev": "pod_add", "pod": pod_to_spec(obj)})
            elif event in ("DELETED", "DELETING"):
                self.events.append({"ev": "pod_delete", "name": obj.metadata.name})

        self.cluster.on_event(on_event)
        if cloud is not None and hasattr(cloud, "chaos_observers"):
            cloud.chaos_observers.append(self._on_chaos)
            self._attached_cloud = cloud
        return self

    def _on_chaos(self, kind: str, detail: dict) -> None:
        """FakeCloud chaos-observer callback (kwok/cloud.py): external
        mutations of the emulated cloud become trace events. Victims are
        recorded as a deterministic `pick` (rank of the victim's node name
        in the sorted ready fleet) plus the observed name for readers."""
        if kind in ("kill_instance", "interruption"):
            pick, node = self._pick_for_instance(detail.get("instance_id", ""))
            if pick is None:
                return  # victim unknown to the cluster: nothing replayable
            self.events.append({
                "ev": "kill_node" if kind == "kill_instance" else "interruption",
                "pick": pick, "node": node,
            })
        elif kind == "set_capacity":
            self.events.append({
                "ev": "ice", "instance_type": detail["instance_type"],
                "zone": detail["zone"], "capacity_type": detail["capacity_type"],
                "count": detail["count"],
            })
        elif kind == "set_price_factor":
            self.events.append({
                "ev": "price", "instance_type": detail["instance_type"],
                "factor": detail["factor"],
            })

    def _pick_for_instance(self, instance_id: str):
        ranked = ranked_victims(self.cluster)
        for i, node in enumerate(ranked):
            if node.provider_id.endswith(f"/{instance_id}"):
                return i, node.metadata.name
        return None, None

    # -- clock ---------------------------------------------------------------
    def record_tick(self) -> None:
        """Called by the run loop once per sweep: the elapsed clock time
        since the previous tick becomes one `advance` event, so replay
        reproduces both the cadence and the fake-clock timeline."""
        now = self.clock.now()
        dt = max(0.0, now - self._last_t)
        self._last_t = now
        self.events.append({"ev": "advance", "dt": round(dt, 6)})

    def dump(self, path: str) -> int:
        return write_trace(path, self.events)
