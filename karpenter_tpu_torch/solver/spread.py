"""Zone topology-spread as a host-side carry pass over pod classes.

Copy of karpenter_tpu/solver/spread.py.

SURVEY.md hard part #1: hard topology spread is stateful across placement
decisions (per-zone pod counts evolve as pods place), which fights
vectorization. The resolution: the state evolves *per class*, not per pod --
identical pods distribute over zones by sequential min-count placement,
whose closed form is water-filling. So a cheap sequential pass over the few
hundred classes (this module) splits each spread-constrained class into
zone-pinned sub-classes carrying the exact per-zone pod counts the oracle's
per-pod loop would produce, and the batched FFD solve (solver/ffd.py) then
runs unchanged on the pinned sub-classes.

Equivalence contract vs the oracle (tests/test_solver.py fuzz, 200+
seeds): for SPREAD-FREE batches, exact equality down to pod names. For
batches with hard spread: identical unschedulable sets, identical
per-(selector, zone) spread distributions, identical existing-node
placement totals, and group count within one per spread selector. NOT
contractual there: which mixed group a spread pod shares with plain pods
-- a joining spread pod narrows the group's zone, shifting its surviving
types and hence which plain classes share it; that pairing depends on the
order narrowings land across classes mid-solve, which a pre-pass provably
cannot observe. Both outcomes are valid FFD placements of the same
distribution.

Semantics mirrored from solver/oracle.py (greedy min-count spreading over
feasible domains):
- counts are keyed by the spread selector (different workloads spread
  independently) and shared across classes in the canonical scan order
- spread domains = zones with schedulable capacity for the class (some
  compatible type fits one pod and has an available offering there), so an
  exhausted zone steers spreading instead of blocking it
- each pod pins the lexicographically-first minimum-count zone among
  candidates where count+1-global_min <= max_skew (global min over the
  feasible domains, empty ones included)
- pods that do not match their own constraint's selector are unconstrained

Scope (routing in solver/service.py): single hard zone-spread constraint
per pod (existing nodes supported via seeded counts); hostname spread and
multi-constraint pods take the oracle path.

Soft (ScheduleAnyway) zone spread is a PREFERENCE carried by the same
water-fill (VERDICT round 3, item 4): a soft-spread class is split and
zone-pinned exactly like a hard one -- biasing pods toward the
least-loaded admissible zone -- but never produces unschedulable pods:
with no feasible domain the class passes through unconstrained, and pods
whose preferred zone cannot open a node fall into an UNPINNED residual
sub-class instead of failing. The oracle mirrors this as pin-then-relax
(oracle._place_pod retries a failed soft-spread pod with the preference
dropped). Soft non-zone constraints remain scoring no-ops on both paths
(parity: the reference core scores hostname spread too; documented in
docs/parity.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from karpenter_tpu_torch.apis import Pod, labels as wk
from karpenter_tpu_torch.apis.pod import TopologySpreadConstraint
from karpenter_tpu_torch.scheduling import Operator, Requirement
from karpenter_tpu_torch.solver import encode
from karpenter_tpu_torch.solver.encode import CatalogTensors, PodClass


def hard_zone_tsc(pod: Pod) -> Optional[TopologySpreadConstraint]:
    """The pod's single effective hard zone-spread constraint, or None.
    A constraint whose selector the pod itself does not match never
    constrains that pod's placement (oracle._spread_narrow_group gates on
    _pod_matches_selector)."""
    hard = [t for t in pod.topology_spread if t.hard()]
    if not hard:
        return None
    t = hard[0]
    if len(hard) > 1 or t.topology_key != wk.ZONE_LABEL:
        raise ValueError("route to oracle: multi-constraint or non-zone spread")
    if not all(pod.metadata.labels.get(k) == v for k, v in t.label_selector.items()):
        return None
    return t


# canonical definition lives in encode (the class signature needs it and
# this module imports encode); re-exported here as the public name
soft_zone_tsc = encode.soft_zone_tsc


def spread_eligible(pods: Sequence[Pod]) -> bool:
    """True when every pod's spread constraints are in this module's scope."""
    for p in pods:
        hard = [t for t in p.topology_spread if t.hard()]
        if not hard:
            continue
        if len(hard) > 1 or hard[0].topology_key != wk.ZONE_LABEL:
            return False
    return True


def _selector_key(t: TopologySpreadConstraint) -> tuple:
    return tuple(sorted(t.label_selector.items()))


@dataclass
class SpreadState:
    """Per-selector zone counts (the oracle's _TopologyState for the zone
    key), carried across classes in scan order. `seed` carries the counts
    pods already bound to live nodes contribute (the oracle's
    _TopologyState.seed_existing), so spread decisions on a steady-state
    cluster stay on the device path."""

    zones: List[str]
    counts: Dict[tuple, np.ndarray] = field(default_factory=dict)
    seed: Optional[Dict[tuple, Dict[str, int]]] = None

    def of(self, key: tuple) -> np.ndarray:
        c = self.counts.get(key)
        if c is None:
            c = self.counts[key] = np.zeros(len(self.zones), dtype=np.int64)
            if self.seed:
                for zone, n in self.seed.get(key, {}).items():
                    if zone in self.zones:
                        c[self.zones.index(zone)] = n
        return c


def _water_fill(counts: np.ndarray, order: np.ndarray, n: int) -> np.ndarray:
    """Place n pods by repeated min-count (ties -> earliest in `order`)
    among exactly the zones listed in `order`; returns per-zone additions.
    Closed form of the oracle's sequential pinning when every candidate
    zone is feasible."""
    take = np.zeros_like(counts)
    if n <= 0 or order.size == 0:
        return take
    c = counts[order].astype(np.int64)
    # fill lowest levels first: after placement, counts differ by <= 1
    # among candidates at the waterline
    lo = int(c.min())
    # final level L: pods needed to reach level x is sum(max(0, x - c))
    hi = lo + n + 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if int(np.maximum(0, mid - c).sum()) <= n:
            lo = mid
        else:
            hi = mid
    level = lo
    add = np.maximum(0, level - c)
    rem = n - int(add.sum())
    # remainder goes one each to the earliest zones (by `order`) at <= level
    at_line = np.nonzero(c + add <= level)[0]
    add[at_line[:rem]] += 1
    take[order] = add
    return take


class SplitResult:
    def __init__(self):
        self.classes: List[PodClass] = []
        self.unschedulable: Dict[str, str] = {}


def _per_new_for_zone(
    pc: PodClass, catalog: CatalogTensors, cat_z: int, compat_row: np.ndarray,
    node_overhead: Optional[np.ndarray] = None,
) -> int:
    """How many pods of class `pc` the batch solver will put on one fresh
    group pinned to catalog zone `cat_z` -- the host mirror of
    ffd._ffd_body's per-group sizing. Spread sub-classes always use the
    MAX-FIT envelope (env_count = 0 in the scan): spreading is an
    availability constraint, and the oracle's per-(class, zone) remaining
    count depends on cross-zone placement order neither path can see
    statically -- max fit is deterministic on both. Float32 so floors agree
    with the device bit-for-bit."""
    req32 = np.asarray(pc.requests, dtype=np.float32)
    pos = req32 > 0
    cap = catalog.cap
    if node_overhead is not None:
        # fresh nodes reserve the pool's daemonset overhead (same scaled
        # vector the device subtracts -- float32-exact, small ints)
        cap = np.maximum(cap - node_overhead[None, :].astype(np.float32), np.float32(0.0))
    n = np.floor(cap[:, pos] / req32[pos]).min(axis=1)     # [K] f32
    n = np.maximum(n, np.float32(0.0))
    mask = compat_row & catalog.tzone[:, cat_z]
    if not mask.any():
        return 0
    return int(n[mask].max())


def split_zone_spread(
    classes: Sequence[PodClass],
    catalog: CatalogTensors,
    class_set_zones: Sequence[str],
    compat: np.ndarray,           # [C, K] host compat (encode.compat_matrix)
    fits_one: np.ndarray,         # [C, K] one pod of class c fits type k
    seed_counts: Optional[Dict[tuple, Dict[str, int]]] = None,
    node_overhead: Optional[np.ndarray] = None,
) -> SplitResult:
    """The carry pass: returns classes with every spread class replaced by
    zone-pinned sub-classes (FFD order preserved).

    This runs inside every spread tick between encode and dispatch, on
    host numpy only: nothing here waits on the device.

    Sub-classes are emitted in GROUP-SIZED CHUNKS ordered by the oracle's
    per-pod chronology, not zone-major: the oracle's min-count pinning
    serves zones level by level (lexicographic within a level), so the k-th
    group of zone z opens when z's count reaches c_z + (k-1)*per_new_z + 1.
    Emitting one chunk per future group, sorted by that (level, zone)
    open-order key, makes the scan's group slot order equal the oracle's
    chronological open order -- later unconstrained classes then first-fit
    into the SAME groups on both paths. (With max-fit sizing one zone chunk
    rarely spans groups; the price objective sizes groups smaller, which is
    what exposed the ordering.)"""
    zones = sorted(class_set_zones)
    state = SpreadState(zones, seed=seed_counts)
    zone_to_idx = {z: i for i, z in enumerate(zones)}
    # catalog zone axis may be ordered differently
    cat_zone_idx = {z: i for i, z in enumerate(catalog.zones)}
    out = SplitResult()
    for ci, pc in enumerate(classes):
        t = hard_zone_tsc(pc.pods[0])
        soft = None
        if t is None:
            soft = t = soft_zone_tsc(pc.pods[0])
        if t is None:
            out.classes.append(pc)
            continue
        key = _selector_key(t)
        counts = state.of(key)
        # spread domains = zones the class can actually use: its own zone
        # requirement AND schedulable capacity (a compatible type that fits
        # one pod and has an available offering there). Exhausted zones
        # steer spreading instead of blocking it, and a pinned pod spreads
        # only over its reachable zones -- the oracle derives the same set
        # from the pod+pool requirements (_feasible_spread_zones). Since
        # every pod pins a minimum-count domain, the skew bound is always
        # satisfied: max_skew shapes nothing beyond domain choice, and the
        # closed-form water-fill covers every case.
        zreq = pc.requirements.get(wk.ZONE_LABEL)
        domains = [
            z
            for z in zones
            if (zreq is None or zreq.matches(z))
            and cat_zone_idx.get(z) is not None
            and bool(np.any(compat[ci] & fits_one[ci] & catalog.tzone[:, cat_zone_idx[z]]))
        ]
        if soft is not None and not domains:
            # a preference with no feasible domain constrains nothing:
            # the class schedules unconstrained (never unschedulable)
            out.classes.append(pc)
            continue
        n = len(pc.pods)
        order = np.array([zone_to_idx[z] for z in domains], dtype=np.int64)
        take = _water_fill(counts, order, n)
        failed_from = None if domains else "topology spread constraints unsatisfiable"
        # chunk each zone's allocation into future-group units and order
        # chunks by the oracle's chronological group-open key
        chunks = []  # (open_level, zone_lex_idx, zone, chunk_size)
        for zi in np.nonzero(take)[0]:
            z = zones[zi]
            per_new = _per_new_for_zone(pc, catalog, cat_zone_idx[z], compat[ci], node_overhead)
            total = int(take[zi])
            if per_new <= 0:
                if soft is not None:
                    # the preferred zone cannot open a node: drop the
                    # preference for these pods (they join the unpinned
                    # residual below) instead of pinning them into failure
                    take[zi] = 0
                    continue
                # no opening possible in this zone (the solver will mark
                # these unplaced); keep one chunk so pods route through
                chunks.append((int(counts[zi]) + 1, int(zi), z, total))
                continue
            done = 0
            g = 0
            while done < total:
                size = min(per_new, total - done)
                chunks.append((int(counts[zi]) + g * per_new + 1, int(zi), z, size))
                done += size
                g += 1
        chunks.sort(key=lambda ch: (ch[0], ch[1]))
        counts += take
        cursor = 0
        for _, _, z, size in chunks:
            sub_reqs = pc.requirements.copy()
            sub_reqs.add(Requirement(wk.ZONE_LABEL, Operator.IN, [z]))
            out.classes.append(
                PodClass(
                    pods=pc.pods[cursor : cursor + size],
                    requests=pc.requests,
                    requirements=sub_reqs,
                    key=pc.key + (z, cursor),
                    env_count=0,
                )
            )
            cursor += size
        if soft is not None:
            if cursor < n:
                # preference-dropped residual: unpinned, original envelope
                out.classes.append(
                    PodClass(
                        pods=pc.pods[cursor:],
                        requests=pc.requests,
                        requirements=pc.requirements,
                        key=pc.key + ("soft-residual",),
                        env_count=pc.env_count,
                    )
                )
            continue
        for p in pc.pods[cursor:]:
            out.unschedulable[p.metadata.name] = (
                failed_from or "topology spread constraints unsatisfiable"
            )
    return out
