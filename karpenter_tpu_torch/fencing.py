"""Leadership fencing: a monotonic epoch gating every cloud mutation.

Leader election alone does not prevent split-brain at the cloud seam: a
deposed leader with a launch fan-out already in flight (pool threads deep
in the batcher window) keeps mutating the cloud after the new leader's
recovery sweep has started -- the classic fencing problem. The fix is the
classic fencing token (Chubby/ZooKeeper style): the Lease carries a
monotonic `epoch`, bumped by the elector on every change of holder (and on
re-acquisition of an expired lease -- the restarted-process case), and
every replica records the epoch it last won. Each cloud mutation re-reads
the lease at the seam (providers/instance/provider.py wraps create-fleet /
terminate / create-tags in `Fence.check`) and fails closed with
StaleFencingEpochError when the issuer's epoch trails the lease's: the
deposed fan-out dies at the wire instead of double-launching against the
new leader.

The journal (karpenter_tpu_torch/journal.py) stamps the same epoch on every
intent record, so a split-brain write is auditable in /debug/journal.

Copy of karpenter_tpu/fencing.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.apis.objects import Lease
from karpenter_tpu_torch.errors import StaleFencingEpochError
from karpenter_tpu_torch.logging import get_logger


class Fence:
    log = get_logger("fencing")

    def __init__(self, cluster, lease_name: Optional[str] = None):
        if lease_name is None:
            from karpenter_tpu_torch.operator.election import LEASE_NAME

            lease_name = LEASE_NAME
        self.cluster = cluster
        self.lease_name = lease_name
        # the epoch THIS replica last won (0 = never elected; an
        # elector-less single-replica deployment never writes a lease, so
        # current() stays 0 and the gate is a no-op by construction)
        self.epoch = 0

    def observe(self, epoch: int) -> None:
        """Called on election win with the lease's epoch; monotonic."""
        if epoch > self.epoch:
            self.log.info("fencing epoch advanced", epoch=epoch)
        self.epoch = max(self.epoch, epoch)

    def current(self) -> int:
        """The bus's committed epoch (the lease is the source of truth the
        way the apiserver is for everything else)."""
        lease = self.cluster.try_get(Lease, self.lease_name)
        return getattr(lease, "epoch", 0) if lease is not None else 0

    def check(self, op: str) -> None:
        """Refuse the mutation when this replica's epoch is stale. Called
        at the cloud seam immediately before each mutating call is
        submitted (the last instant the issuer can still fail closed
        without having touched the cloud)."""
        current = self.current()
        if self.epoch < current:
            metrics.FENCING_REJECTED.inc(op=op)
            raise StaleFencingEpochError(
                f"{op} refused: fencing epoch {self.epoch} is stale "
                f"(lease epoch {current}); this replica was deposed"
            )
