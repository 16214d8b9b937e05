"""NodeClaim termination: graceful drain -> instance delete -> finalizer.

Rebuilds the core termination controller behavior the reference plugs into
(CloudProvider.Delete at pkg/cloudprovider/cloudprovider.go:209-220; the
disrupted taint + cordon-and-drain flow the interruption controller also
uses, pkg/controllers/interruption/controller.go:233-248):

deleting NodeClaim -> taint+cordon its node -> evict reschedulable pods
(grace-period aware) -> when empty (or grace expired) terminate the cloud
instance -> drop finalizer -> node object removed.

Copy of karpenter_tpu/controllers/termination.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis import NodeClaim, Node
from karpenter_tpu_torch.cloudprovider import CloudProvider
from karpenter_tpu_torch.errors import NotFoundError
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.scheduling import Taint
from karpenter_tpu_torch.logging import get_logger

TERMINATION_FINALIZER = "karpenter.sh/termination"
DISRUPTED_TAINT = Taint("karpenter.sh/disrupted", effect="NoSchedule")
# system-cluster-critical / system-node-critical priority band: these pods
# drain LAST so the services they provide (DNS, CNI agents) outlive the
# workloads that depend on them during the drain (the reference's
# terminator drains in priority waves)
SYSTEM_CRITICAL_PRIORITY = 2_000_000_000


class TerminationController:
    log = get_logger("termination")

    def __init__(self, cluster: Cluster, cloud_provider: CloudProvider, recorder=None,
                 journal=None):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.recorder = recorder  # optional events.Recorder
        # optional IntentJournal: a durable terminate intent is written
        # once the drain completes, BEFORE the cloud delete, so a crash
        # between the two resumes promptly at the next recovery sweep
        # instead of waiting for the level-triggered retry to rediscover it
        self.journal = journal
        self._drain_started: dict = {}

    def reconcile_all(self) -> None:
        for claim in self.cluster.list(NodeClaim):
            if claim.deleting:
                self.reconcile(claim)

    def reconcile(self, claim: NodeClaim) -> None:
        node = self.cluster.node_for_nodeclaim(claim)
        now = self.cluster.clock.now()
        if node is not None and not node.deleting:
            # cordon + disrupted taint
            if not node.unschedulable:
                node.unschedulable = True
                if all(t.key != DISRUPTED_TAINT.key for t in node.taints):
                    node.taints.append(DISRUPTED_TAINT)
                self.cluster.update(node)
            started = self._drain_started.setdefault(claim.metadata.name, now)
            pods = self.cluster.pods_on_node(node.metadata.name)
            evictable = [p for p in pods if p.reschedulable()]
            blocked = [p for p in pods if not p.reschedulable()]
            grace = claim.termination_grace_period
            grace_expired = grace is not None and now - started >= grace
            # evictions go through the PDB guard (the eviction API's
            # disruptionsAllowed); budget-exhausted pods stay bound and the
            # drain retries next tick as budgets free up -- until the
            # claim's termination grace expires, after which pods are
            # drained regardless (the reference's terminationGracePeriod
            # force-drain semantics)
            from karpenter_tpu_torch.controllers.pdb_guard import PDBGuard

            # priority waves: non-critical pods drain first; cluster-
            # critical pods (DNS, node agents) go only once no lower-
            # priority pod remains bound, one wave per reconcile
            noncritical = [p for p in evictable if p.priority < SYSTEM_CRITICAL_PRIORITY]
            critical = [p for p in evictable if p.priority >= SYSTEM_CRITICAL_PRIORITY]
            # the critical wave waits for EVERY lower-priority pod to leave
            # the node -- including blocked (do-not-disrupt/static) ones
            # that only clear at grace expiry; evicting DNS while a blocked
            # workload keeps running would be exactly the outage the waves
            # exist to prevent
            lower_blocked = [p for p in blocked if p.priority < SYSTEM_CRITICAL_PRIORITY]
            wave = noncritical or (
                critical if (grace_expired or not lower_blocked) else []
            )
            guard = PDBGuard(self.cluster)
            pdb_deferred = 0
            for p in wave:
                if not grace_expired and not guard.try_evict(p):
                    pdb_deferred += 1
                    continue
                p.node_name = ""
                p.phase = "Pending"
                self.cluster.update(p)
            if pdb_deferred:
                self.log.info(
                    "drain waiting on pod disruption budgets",
                    nodeclaim=claim.metadata.name, deferred=pdb_deferred,
                )
                return
            if noncritical and critical:
                return  # critical pods drain on the next pass
            if blocked and not grace_expired:
                return  # wait for do-not-disrupt pods until grace expires
            # grace expired: non-reschedulable pods (static pods, bare pods)
            # die with the node rather than being requeued -- requeueing
            # would make the provisioner launch capacity for pods that are
            # not controller-replaced
            from karpenter_tpu_torch.apis import Pod as PodKind

            for p in blocked:
                p.metadata.finalizers = []
                self.cluster.delete(PodKind, p.metadata.name)
        # node drained (or gone): delete the instance, then the objects.
        # The terminate intent lands FIRST (write-ahead): a crash between
        # the cloud delete and the finalizer removal leaves a record the
        # recovery sweep resumes immediately
        intent = None
        if self.journal is not None and claim.provider_id:
            intent = self.journal.begin_terminate(claim)
        try:
            self.cloud_provider.delete(claim)
        except NotFoundError:
            pass
        # crash site: instance terminated, finalizer (and node object)
        # still in place -- restart must finish the teardown, not relaunch
        from karpenter_tpu_torch import failpoints

        failpoints.eval("crash.termination")
        if node is not None:
            node.metadata.finalizers = []
            self.cluster.delete(Node, node.metadata.name)
        self.cluster.remove_finalizer(claim, TERMINATION_FINALIZER)
        if intent is not None:
            self.journal.resolve(intent, "committed")
        self._drain_started.pop(claim.metadata.name, None)
        if self.recorder is not None:
            # the core publishes a terminated event per claim through its
            # events.Recorder at the end of the drain flow
            self.recorder.publish(claim, "Terminated", "drained and deleted")
        self.log.info("terminated node", nodeclaim=claim.metadata.name)
