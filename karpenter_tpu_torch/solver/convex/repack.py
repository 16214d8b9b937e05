"""Global repack oracle: convex scoring of the LIVE placement.

The disruption controller's sweeps are local by construction --
singletons, disruption-cost prefixes, bounded pair windows. This oracle
looks at the whole fleet at once: it solves the host-side (float64,
off the hot path -- no device dispatch, no jit) LP relaxation over the
candidates' pods and attributes each class a FRACTIONAL per-pod price,
the price the relaxation pays for that shape. A node whose hourly price
exceeds the fractional cost of the pods it hosts carries REGRET: the
global optimum would buy that capacity cheaper. The proposed candidate
sets (top-regret singletons, then the top-regret pair and triple) are
exactly the sets the prefix/pair enumerations cannot see when the
regretful nodes sit far apart in disruption-cost order.

Verdicts stay with the existing machinery: the controller runs every
proposed set through the SAME simulate/price differential as its own
enumerations (tests/test_convex.py pins that agreement), so the oracle
can only ADD candidates, never bypass a safety check.

Copy of karpenter_tpu/solver/convex/repack.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.solver import encode
from karpenter_tpu_torch.solver.convex import relax

# enough iterations for a stable cost attribution at sweep cadence;
# the sweep runs off the tick path so the budget is a latency knob,
# not a retrace axis
REPACK_ITERS = 32
MAX_SETS = 6


class RepackOracle:
    """Stateless proposer: candidates in, index sets out. Constructed
    once (``__main__`` wires it when the convex tier is enabled) and
    shared by the disruption controller across sweeps."""

    def __init__(self, iters: int = REPACK_ITERS, max_sets: int = MAX_SETS):
        self.iters = iters
        self.max_sets = max_sets
        # last sweep's attribution, for the flight recorder / tests:
        # (regret per candidate, LP lower bound $/h)
        self.last_regret: Optional[np.ndarray] = None
        self.last_lower: float = 0.0

    def propose(
        self,
        candidates: Sequence,
        pools: Sequence,
        catalogs: Optional[Dict[str, list]],
    ) -> List[Tuple[int, ...]]:
        """Candidate index sets (into ``candidates``) worth judging,
        highest regret first. Empty when nothing scores: no catalog, no
        reschedulable pods, or no node prices above its fractional cost."""
        if not candidates or not catalogs:
            return []
        items = None
        pool = None
        for p in sorted(pools or [], key=lambda p: -p.weight):
            if catalogs.get(p.name):
                pool, items = p, catalogs[p.name]
                break
        if items is None:
            return []
        pods_of = [
            [p for p in c.pods if p.reschedulable()] for c in candidates
        ]
        all_pods = [p for pods in pods_of for p in pods]
        if not all_pods:
            return []
        classes = encode.group_pods(all_pods)
        key_of = {pc.key: i for i, pc in enumerate(classes)}
        catalog = encode.encode_catalog(items)
        cs = encode.encode_classes(
            classes, catalog, pool_taints=list(pool.template.taints),
        )
        x, lower, _ = relax.reference_relax(catalog, cs, iters=self.iters)
        feas, price_ck, _ = relax.host_feasibility(catalog, cs)
        counts = np.asarray(cs.count, dtype=np.float64)
        # fractional per-pod cost of each class: what the relaxation
        # pays for one pod of this shape (0 for unplaceable rows --
        # they cannot justify disrupting anything)
        paid = (np.where(feas, price_ck, 0.0) * x).sum(axis=-1)
        with np.errstate(invalid="ignore"):
            per_pod = np.where(counts > 0, paid / np.maximum(counts, 1.0), 0.0)
        regret = np.zeros(len(candidates), dtype=np.float64)
        for i, pods in enumerate(pods_of):
            frac = 0.0
            for p in pods:
                pc_reqs = p.scheduling_requirements()[0]
                ci = key_of.get(encode._class_key(p, pc_reqs))
                if ci is not None:
                    frac += per_pod[ci]
            price = float(getattr(candidates[i], "price", float("inf")))
            regret[i] = price - frac if np.isfinite(price) else 0.0
        self.last_regret = regret
        self.last_lower = float(lower)
        order = sorted(
            (i for i in range(len(candidates)) if regret[i] > 0.0),
            key=lambda i: (-regret[i], i),
        )
        if not order:
            return []
        sets: List[Tuple[int, ...]] = [(i,) for i in order[:3]]
        if len(order) >= 2:
            sets.append(tuple(order[:2]))
        if len(order) >= 3:
            sets.append(tuple(order[:3]))
        return sets[: self.max_sets]
