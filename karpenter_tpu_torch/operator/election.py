"""Lease-based leader election.

The reference runs a single active replica behind controller-runtime leader
election, gating cache hydration on `op.Elected()` (SURVEY.md section 2.4;
launchtemplate.go:120-128, kwok/main.go:53-66). The same contract here: a
Lease object in the cluster store names the holder with a renew deadline;
the elector acquires when the lease is free or expired, renews while
holding, and the operator runs its controller sweep (and one-time cache
hydration) only while elected.

Copy of karpenter_tpu/operator/election.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Callable, List

from karpenter_tpu_torch.apis.objects import Lease

LEASE_NAME = "karpenter-tpu-leader"
LEASE_DURATION = 15.0


class LeaderElector:
    def __init__(
        self,
        cluster,
        identity: str,
        lease_name: str = LEASE_NAME,
        lease_duration: float = LEASE_DURATION,
    ):
        self.cluster = cluster
        self.identity = identity
        self.lease_name = lease_name
        self.lease_duration = lease_duration
        self._was_elected = False
        self.on_elected: List[Callable[[], None]] = []  # hydration hooks
        # the fencing epoch this replica last WON (apis/objects.Lease.epoch
        # bumps on every holder change or expired re-acquisition, never on
        # a renew); consumers -- the operator's Fence, the journal -- read
        # it after an on_elected hook fires
        self.won_epoch = 0

    @property
    def elected(self) -> bool:
        lease = self.cluster.try_get(Lease, self.lease_name)
        return bool(
            lease
            and lease.holder == self.identity
            and lease.renew_deadline > self.cluster.clock.now()
        )

    def tick(self) -> bool:
        """Acquire or renew; fires on_elected hooks on each transition into
        leadership (the reference re-hydrates caches on every election win,
        not only the first). Returns whether this replica currently leads."""
        from karpenter_tpu_torch.kwok.cluster import AlreadyExists, Conflict

        now = self.cluster.clock.now()
        lease = self.cluster.try_get(Lease, self.lease_name)
        try:
            if lease is None:
                lease = Lease(self.lease_name, self.identity,
                              now + self.lease_duration, epoch=1)
                self.cluster.create(lease)
            elif lease.holder == self.identity and lease.renew_deadline > now:
                # plain renew: same holder, unexpired -- the epoch does NOT
                # move (in-flight work stamped with it stays valid).
                # Mutate a COPY under optimistic concurrency: writing the
                # shared object in place before a 409 would leave a
                # half-acquired lease on the in-memory bus (a real
                # apiserver never persists a conflicted write)
                desired = lease.deep_copy()
                desired.renew_deadline = now + self.lease_duration
                self.cluster.update(
                    desired, expect_version=lease.metadata.resource_version)
            elif lease.holder == self.identity or lease.renew_deadline <= now:
                # takeover, or re-acquisition of an EXPIRED lease (the
                # restarted-process case): the fencing epoch bumps so any
                # work the previous holder (or incarnation) still has in
                # flight is rejected at the cloud seam
                desired = lease.deep_copy()
                desired.holder = self.identity
                desired.renew_deadline = now + self.lease_duration
                desired.epoch = getattr(lease, "epoch", 0) + 1
                self.cluster.update(
                    desired, expect_version=lease.metadata.resource_version)
        except (AlreadyExists, Conflict):
            # lost the acquire race to another replica (a real apiserver
            # surfaces this as 409); the re-read below decides leadership
            pass
        prev_epoch = self.won_epoch
        holding = self.elected
        if holding:
            held = self.cluster.try_get(Lease, self.lease_name)
            if held is not None:
                self.won_epoch = getattr(held, "epoch", 0)
        # hooks fire on every transition INTO leadership -- and on an
        # epoch advance while apparently-still-elected (a stalled replica
        # whose lease expired and was re-acquired without it ever
        # observing standby effectively began a new reign: caches must
        # re-hydrate and recovery must sweep under the new epoch)
        if holding and (not self._was_elected or self.won_epoch != prev_epoch):
            for hook in self.on_elected:
                hook()
        self._was_elected = holding
        return holding
