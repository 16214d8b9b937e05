"""Eviction gating against PodDisruptionBudgets.

Used at the two voluntary-disruption seams the reference routes through
the eviction API: node drain (controllers/termination.py) and disruption
candidacy (controllers/disruption.py). One guard instance snapshots PDB
state for one sweep and DECREMENTS its remaining allowance as evictions
are granted, so a single drain pass cannot evict five pods because each
looked individually admissible against the same snapshot.

Copy of karpenter_tpu/controllers/pdb_guard.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Dict, List

from karpenter_tpu_torch.apis.pdb import PodDisruptionBudget
from karpenter_tpu_torch.logging import get_logger


class PDBGuard:
    log = get_logger("pdb")

    def __init__(self, cluster):
        self.cluster = cluster
        self._pdbs: List[PodDisruptionBudget] = cluster.list(PodDisruptionBudget)
        self._remaining: Dict[str, int] = {}
        if self._pdbs:
            from karpenter_tpu_torch.apis import Pod

            pods = cluster.list(Pod)
            for pdb in self._pdbs:
                matching = [p for p in pods if pdb.matches(p)]
                healthy = [p for p in matching if p.node_name and not p.deleting]
                self._remaining[pdb.metadata.name] = pdb.allowed_disruptions(
                    len(matching), len(healthy)
                )

    def try_evict(self, pod) -> bool:
        """Consume allowance from every matching PDB; False (and no
        consumption) when any budget is exhausted -- the eviction API's
        429 path."""
        return self.try_evict_all([pod])

    def try_evict_all(self, pods, charge_on_fail: bool = False) -> bool:
        """Atomic candidacy check: either EVERY pod's eviction is
        admissible and all allowances are consumed, or nothing is
        consumed. A per-pod try_evict loop that short-circuits on the
        first refusal leaves partial consumption behind, wrongly blocking
        sibling candidates whose pods share the same budget (ADVICE
        round 3). With charge_on_fail (the terminationGracePeriod
        force-drain carve-out, where the caller drains regardless of the
        verdict) a failing set still consumes its allowance -- possibly
        past exhaustion -- so later candidates in the pass see it spent."""
        needed = self._needed(pods)
        short = [name for name, n in needed.items() if self._remaining[name] < n]
        ok = not short
        if short:
            self.log.debug(
                "eviction deferred by disruption budget",
                pods=[p.metadata.name for p in pods][:5], budgets=short,
            )
        if ok or charge_on_fail:
            for name, n in needed.items():
                self._remaining[name] -= n
        return ok

    def charge(self, pods) -> None:
        """Unconditionally consume allowance (may go negative) without a
        verdict -- the force-drain accounting for a candidate that never
        reached the atomic check (e.g. failed reschedulability first)."""
        for name, n in self._needed(pods).items():
            self._remaining[name] -= n

    def _needed(self, pods) -> Dict[str, int]:
        """Allowances the eviction of `pods` consumes, per matching PDB --
        the one matching sweep both try_evict_all and charge rely on."""
        needed: Dict[str, int] = {}
        for pod in pods:
            for p in self._pdbs:
                if p.matches(pod):
                    needed[p.metadata.name] = needed.get(p.metadata.name, 0) + 1
        return needed
