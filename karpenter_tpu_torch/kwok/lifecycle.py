"""KWOK node-lifecycle simulator.

The reference's kwok harness fabricates corev1.Nodes for launched fake
instances so the whole controller stack sees a live cluster without kubelets
(kwok/ec2/ec2.go:884+ registers KWOK-backed nodes; node kill thread
:253-281). This simulator is step-driven:

step() advances, for every NodeClaim:
  launched + register delay elapsed  -> fabricate+register a Node carrying
                                        the claim's single-value labels,
                                        capacity/allocatable from the claim
  registered + initialize delay      -> node Ready, startup taints dropped,
                                        claim Initialized
and for every Node whose backing instance died -> node gone, pods unbound
(back to Pending), exercising repair/GC paths.

Copy of karpenter_tpu/kwok/lifecycle.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Dict, Optional

from karpenter_tpu_torch.apis import NodeClaim, Node, labels as wk
from karpenter_tpu_torch.apis.nodeclaim import COND_INITIALIZED, COND_LAUNCHED, COND_REGISTERED
from karpenter_tpu_torch.kwok.cloud import FakeCloud
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.scheduling import resources as res


class NodeLifecycle:
    def __init__(
        self,
        cluster: Cluster,
        cloud: FakeCloud,
        register_delay: float = 3.0,
        initialize_delay: float = 2.0,
    ):
        self.cluster = cluster
        self.cloud = cloud
        self.register_delay = register_delay
        self.initialize_delay = initialize_delay
        # Delays are measured on the cluster's (injectable) clock from when
        # this simulator first *observes* each state -- condition transition
        # timestamps use wall time and cannot be compared to a fake clock.
        self._launched_seen: Dict[str, float] = {}
        self._registered_at: Dict[str, float] = {}

    def step(self) -> None:
        now = self.cluster.clock.now()
        self._register_nodes(now)
        self._initialize_nodes(now)
        self._propagate_impairments()
        self._reap_dead_instances()
        self._sweep_orphan_csinodes()

    # -- registration -------------------------------------------------------
    def _register_nodes(self, now: float) -> None:
        for claim in self.cluster.list(NodeClaim):
            if not claim.launched() or claim.registered() or claim.deleting:
                continue
            first_seen = self._launched_seen.setdefault(claim.metadata.name, now)
            if now - first_seen < self.register_delay:
                continue
            node_name = claim.metadata.name
            if self.cluster.try_get(Node, node_name) is not None:
                continue
            labels = dict(claim.metadata.labels)
            labels.update(claim.requirements.labels())
            labels[wk.HOSTNAME_LABEL] = node_name
            node = Node(
                name=node_name,
                labels=labels,
                capacity=claim.capacity,
                allocatable=claim.allocatable,
                taints=list(claim.taints) + list(claim.startup_taints),
                provider_id=claim.provider_id,
            )
            self.cluster.create(node)
            # the kubelet-analogue also publishes the node's CSI driver
            # registry: attach limits live on CSINode in real clusters
            # (kube adapter overlays them onto the node at read time),
            # and node STATUS writes never carry the derived axis
            attach = node.allocatable.get(res.ATTACHABLE_VOLUMES)
            if attach:
                from karpenter_tpu_torch.apis.storage import CSINode

                self.cluster.create(
                    CSINode(node_name, drivers=[("csi.kwok.dev", int(attach))])
                )
            claim.node_name = node_name
            claim.status_conditions.set_true(COND_REGISTERED, "NodeRegistered")
            self.cluster.update(claim)
            self._registered_at[node_name] = now

    def _initialize_nodes(self, now: float) -> None:
        for claim in self.cluster.list(NodeClaim):
            if not claim.registered() or claim.initialized() or claim.deleting:
                continue
            reg_time = self._registered_at.get(claim.node_name)
            if reg_time is None:
                # a restarted operator lost the in-memory observation
                # timestamps (they are deliberately not durable -- delays
                # are a kubelet emulation, not cluster state): re-observe
                # NOW so an already-registered node initializes one delay
                # later instead of never (pre-journal this could not
                # happen; operator restarts over live state can hit it)
                reg_time = self._registered_at[claim.node_name] = now
            if now - reg_time < self.initialize_delay:
                continue
            node = self.cluster.try_get(Node, claim.node_name)
            if node is None:
                continue
            startup_keys = {t.key for t in claim.startup_taints}
            node.taints = [t for t in node.taints if t.key not in startup_keys]
            node.ready = True
            self.cluster.update(node)
            claim.status_conditions.set_true(COND_INITIALIZED, "NodeInitialized")
            self.cluster.update(claim)

    # -- failure propagation ------------------------------------------------
    def _propagate_impairments(self) -> None:
        """A degraded-but-running instance (FakeCloud.degrade_instance)
        surfaces its condition as False on the Node -- the kubelet/agent
        health reporting the auto-repair controller consumes. The node also
        stops accepting new pods (NotReady)."""
        impaired = {
            i.provider_id: i.impaired_condition
            for i in self.cloud.describe_instances()
            if i.impaired_condition and i.state in ("pending", "running")
        }
        if not impaired:
            return
        for node in self.cluster.list(Node):
            cond = impaired.get(node.provider_id)
            if cond and (node.ready or not node.status_conditions.is_false(cond)):
                # guard on the actual transition: unconditional updates
                # would emit a MODIFIED event per node per tick for the
                # whole toleration window
                node.status_conditions.set_false(cond, "InstanceImpaired")
                node.ready = False
                self.cluster.update(node)

    def _reap_dead_instances(self) -> None:
        live = {i.provider_id for i in self.cloud.describe_instances() if i.state in ("pending", "running")}
        for node in self.cluster.list(Node):
            if node.provider_id and node.provider_id not in live:
                self.cluster.unbind_pods(node.metadata.name)
                node.metadata.finalizers = []
                self.cluster.delete(Node, node.metadata.name)
        # A claim whose instance died is phantom capacity: if it survived,
        # the provisioner would keep counting it as an in-flight node and
        # never replace the lost pods (core nodeclaim-lifecycle behavior).
        for claim in self.cluster.list(NodeClaim):
            if claim.launched() and claim.provider_id and claim.provider_id not in live:
                claim.metadata.finalizers = []
                self.cluster.delete(NodeClaim, claim.metadata.name)
                self._launched_seen.pop(claim.metadata.name, None)
                self._registered_at.pop(claim.node_name, None)

    def _sweep_orphan_csinodes(self) -> None:
        """CSINode lifetime is this kubelet-analogue's job (as on a real
        cluster): whatever deleted the Node -- termination, GC, the reap
        above -- the companion CSINode follows on the next step, so no
        deletion call site needs to know about the cascade."""
        from karpenter_tpu_torch.apis.storage import CSINode

        names = {n.metadata.name for n in self.cluster.list(Node)}
        for c in self.cluster.list(CSINode):
            if c.metadata.name not in names:
                self.cluster.delete(CSINode, c.metadata.name)
