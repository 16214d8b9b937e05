"""Dense tensor encoding: catalog and pod classes -> solver inputs.

Copy of karpenter_tpu/solver/encode.py. It stays NumPy: the host builds
the encoded arrays, and solver/ffd.py moves them to the device. Grouping,
in group_pods and in the cross-tick IncrementalGrouper, is the
C loop of native/_grouping.c when it built (the JAX package's extension,
copied byte for byte), else the pure-Python loop: the same classes in the
same order either way.

This is the bridge between the host-side constraint algebra and the
device decision plane.

Encoding scheme
===============
- Resources are scaled to *small exact integers* (cpu -> millicores,
  memory -> MiB, storage -> GiB, counts as-is) so every value is < 2^24 and
  float32 arithmetic (incl. floor division) is exact -- the differential
  guarantee vs the Python oracle depends on this.
- Label constraints lower to **bitset masks over per-dimension
  vocabularies**: the catalog contributes an int32 code per (type, dim);
  a pod class contributes packed uint32 allowed-bitmasks per dim. On device,
  compat[c, k] = AND_d bit(tcode[k, d]) in allowed[c, d]. Numeric
  requirements (Gt/Lt over cpu, memory...) lower to interval tests against
  numeric catalog columns.
- Zones and capacity types are small fixed axes (Z, CT) with explicit
  boolean masks, because they are offering properties (price/availability
  vary per (type, zone, captype)), not type properties.

Pods are grouped into equivalence classes by (requests, requirements,
tolerations) -- 50k pods typically collapse to a few hundred classes, which
turns the sequential FFD loop into a short scan with large per-step
vectorized work.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.apis import Pod, labels as wk
from karpenter_tpu_torch.native import grouping as _native_grouping
from karpenter_tpu_torch.providers.instancetype.types import InstanceType
from karpenter_tpu_torch.scheduling import Requirements, Resources, Taint, tolerates_all
from karpenter_tpu_torch.scheduling import resources as res
from karpenter_tpu_torch.utils import InternTable, gc_paused

# -- static solver shape parameters ------------------------------------------
R = res.NUM_RESOURCE_AXES          # resource axes
Z_PAD = 8                          # zone slots
CT = 3                             # capacity types: reserved, spot, on-demand
CAPTYPE_INDEX = {wk.CAPACITY_TYPE_RESERVED: 0, wk.CAPACITY_TYPE_SPOT: 1, wk.CAPACITY_TYPE_ON_DEMAND: 2}

# label dimensions lowered to bitset vocabularies, in fixed order
LABEL_DIMS: Tuple[str, ...] = (
    wk.INSTANCE_TYPE_LABEL,
    wk.ARCH_LABEL,
    wk.OS_LABEL,
    wk.LABEL_INSTANCE_CATEGORY,
    wk.LABEL_INSTANCE_FAMILY,
    wk.LABEL_INSTANCE_GENERATION,
    wk.LABEL_INSTANCE_SIZE,
    wk.LABEL_INSTANCE_CPU_MANUFACTURER,
    wk.LABEL_INSTANCE_HYPERVISOR,
    wk.LABEL_INSTANCE_GPU_NAME,
    wk.LABEL_INSTANCE_ACCELERATOR_NAME,
    wk.LABEL_INSTANCE_LOCAL_NVME,
    wk.LABEL_INSTANCE_ENCRYPTION_IN_TRANSIT,
    wk.NODEPOOL_LABEL,
    wk.REGION_LABEL,
)
D = len(LABEL_DIMS)

# numeric dims for Gt/Lt windows
NUMERIC_DIMS: Tuple[str, ...] = (
    wk.LABEL_INSTANCE_CPU,
    wk.LABEL_INSTANCE_MEMORY,
    wk.LABEL_INSTANCE_GENERATION,
    wk.LABEL_INSTANCE_NETWORK_BANDWIDTH,
    wk.LABEL_INSTANCE_EBS_BANDWIDTH,
    wk.LABEL_INSTANCE_GPU_COUNT,
    wk.LABEL_INSTANCE_ACCELERATOR_COUNT,
)
ND = len(NUMERIC_DIMS)

# requirement keys the tensor encoding can express; constraints on any
# OTHER key are invisible to the device compat (they ride into the decoded
# group requirements but cannot gate joins), so routing must keep classes
# with DIVERGENT un-encodable constraints off the device path
# (service.supports; the oracle's _try_group would refuse those joins)
ENCODABLE_KEYS = frozenset(LABEL_DIMS) | frozenset(NUMERIC_DIMS) | {
    wk.ZONE_LABEL,
    wk.CAPACITY_TYPE_LABEL,
}

# unit scaling per resource axis: raw base units -> small exact ints
_SCALE = np.ones((R,), dtype=np.float64)
_SCALE[res.AXIS_INDEX[res.MEMORY]] = 1.0 / 2**20          # bytes -> MiB
_SCALE[res.AXIS_INDEX[res.EPHEMERAL_STORAGE]] = 1.0 / 2**30  # bytes -> GiB


def scale_vector(v: Sequence[float]) -> np.ndarray:
    return np.asarray(v, dtype=np.float64) * _SCALE


def _pad_pow2_words(n: int) -> int:
    return (n + 31) // 32


def bucket(n: int, lo: int = 8) -> int:
    """Round up to a power of two (a small set of padded shapes)."""
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class Vocab:
    """Per-dimension value vocabulary; index 0 is reserved for 'absent'."""

    values: List[str] = field(default_factory=lambda: ["<absent>"])
    index: Dict[str, int] = field(default_factory=lambda: {"<absent>": 0})

    def code(self, value: Optional[str]) -> int:
        if value is None:
            return 0
        i = self.index.get(value)
        if i is None:
            i = len(self.values)
            self.values.append(value)
            self.index[value] = i
        return i

    def __len__(self):
        return len(self.values)


@dataclass
class CatalogTensors:
    """Device-ready encoding of one resolved instance-type catalog."""

    names: List[str]                 # K_real entries
    k_real: int
    k_pad: int
    cap: np.ndarray                  # [K, R] float32, scaled allocatable; 0 rows for padding
    tcode: np.ndarray                # [K, D] int32 label codes
    tnum: np.ndarray                 # [K, ND] float32 numeric label values
    tnum_present: np.ndarray         # [K, ND] bool: label defined on the type
    tzone: np.ndarray                # [K, Z] bool: has any offering in zone
    tcap: np.ndarray                 # [K, CT] bool: has any offering of captype
    price: np.ndarray                # [K, Z, CT] float32; +inf when no available offering
    vocabs: List[Vocab]
    zones: List[str]                 # zone axis order
    words: List[int]                 # bitmask words per dim


def encode_catalog(instance_types: Sequence[InstanceType], k_pad: Optional[int] = None) -> CatalogTensors:
    k_real = len(instance_types)
    if k_pad is None:
        k_pad = max(128, ((k_real + 127) // 128) * 128)
    vocabs = [Vocab() for _ in LABEL_DIMS]
    zones: List[str] = []
    zone_idx: Dict[str, int] = {}
    for it in instance_types:
        for o in it.offerings:
            if o.zone not in zone_idx:
                if len(zones) >= Z_PAD:
                    raise ValueError(f"more than {Z_PAD} zones; raise Z_PAD")
                zone_idx[o.zone] = len(zones)
                zones.append(o.zone)

    cap = np.zeros((k_pad, R), dtype=np.float32)
    tcode = np.zeros((k_pad, D), dtype=np.int32)
    tnum = np.zeros((k_pad, ND), dtype=np.float32)
    tnum_present = np.zeros((k_pad, ND), dtype=bool)
    tzone = np.zeros((k_pad, Z_PAD), dtype=bool)
    tcap = np.zeros((k_pad, CT), dtype=bool)
    price = np.full((k_pad, Z_PAD, CT), np.inf, dtype=np.float32)
    names = []
    for k, it in enumerate(instance_types):
        names.append(it.name)
        cap[k] = scale_vector(it.allocatable().to_vector())
        labels = it.requirements.labels()
        for d, dim in enumerate(LABEL_DIMS):
            tcode[k, d] = vocabs[d].code(labels.get(dim))
        for nd_i, dim in enumerate(NUMERIC_DIMS):
            val = labels.get(dim)
            try:
                tnum[k, nd_i] = float(val) if val is not None else 0.0
                tnum_present[k, nd_i] = val is not None
            except ValueError:
                tnum[k, nd_i] = 0.0
                tnum_present[k, nd_i] = False
        for o in it.offerings:
            z = zone_idx[o.zone]
            c = CAPTYPE_INDEX[o.capacity_type]
            if o.available:
                tzone[k, z] = True
                tcap[k, c] = True
                price[k, z, c] = min(price[k, z, c], o.price)
    words = [_pad_pow2_words(len(v)) for v in vocabs]
    return CatalogTensors(
        names=names, k_real=k_real, k_pad=k_pad, cap=cap, tcode=tcode, tnum=tnum,
        tnum_present=tnum_present, tzone=tzone, tcap=tcap, price=price, vocabs=vocabs,
        zones=zones, words=words,
    )


@dataclass
class PodClass:
    """One equivalence class of identical-for-scheduling pods."""

    pods: List[Pod]
    requests: np.ndarray             # [R] scaled, includes pods=1
    requirements: Requirements
    key: tuple
    # price-envelope pod count for fresh-group sizing (solver/ffd.py price
    # objective): -1 = use the in-scan leftover; spread sub-classes pin 1
    env_count: int = -1
    # OR of routing-relevant constraint bits over EVERY signature that
    # merged into this class. The TERMS themselves are not in _class_key
    # (pods with different affinity targets but one shape still share a
    # class -- the oracle reads each pod's own terms at placement), but
    # oracle_suffix_rank IS: plain pods never merge behind a constrained
    # representative, so these bits answer "does anyone here carry
    # affinity?" exactly for the whole class (round 5)
    has_affinity: bool = False
    multi_node_affinity: bool = False
    has_preferences: bool = False


@dataclass
class PodClassSet:
    classes: List[PodClass]
    c_real: int
    c_pad: int
    req: np.ndarray                  # [C, R] float32
    count: np.ndarray                # [C] int32
    env_count: np.ndarray            # [C] i32 price-envelope pod count:
                                     # >0 pinned; <0 in-scan leftover plus
                                     # (-env-1) shared-envelope tail pods
                                     # (-1 = plain leftover; see
                                     # service._unify_envelopes / ffd.py)
    allowed: List[np.ndarray]        # per dim: [C, W_d] uint32 bitmasks
    num_lo: np.ndarray               # [C, ND] float32 exclusive lower bounds (-inf none)
    num_hi: np.ndarray               # [C, ND] float32 exclusive upper bounds (+inf none)
    azone: np.ndarray                # [C, Z] bool allowed zones
    acap: np.ndarray                 # [C, CT] bool allowed captypes
    schedulable: np.ndarray          # [C] bool (taints tolerated etc.)
    # [R] f32 per-fresh-node reserve (daemonset overhead for the solved
    # pool, apis/daemonset.pool_daemon_overhead); zeros = no reserve
    node_overhead: np.ndarray = None
    # [C, K] bool open-restriction mask (merged multi-pool solves only;
    # None = open anywhere compat allows). See ffd.SolveInputs.open_allowed.
    open_allowed: np.ndarray = None
    # [C, K] bool join-restriction mask ANDed into compat (merged
    # multi-pool solves with per-pool TAINTS only; None = no restriction).
    # Encodes the oracle's _try_group toleration gate: a class may join a
    # group only on columns of pools whose taints it tolerates.
    join_allowed: np.ndarray = None
    # [C, R] float64 EXACT base-unit per-pod request vectors (requests +
    # one pod axis), used by the vectorized decode: group totals become one
    # matmul instead of a per-class Python loop. Host-side only -- never
    # shipped over the wire.
    base_req: np.ndarray = None


def pack_class_masks(class_set: "PodClassSet") -> "PodClassSet":
    """Convert the set's [C, K] bool open/join masks to the bit-packed
    [C, KW] uint32 form IN PLACE (solver/packing.py; no-op for absent or
    already-packed masks) and return the set. The packed rows are what a
    packed_masks solver stages and what the wire's negotiated form ships
    -- every kernel dispatches on dtype, so downstream is agnostic.
    Exactly invertible, so decisions are bit-identical by construction."""
    from karpenter_tpu_torch.solver import packing

    for name in ("open_allowed", "join_allowed"):
        m = getattr(class_set, name, None)
        if m is not None and not packing.is_packed(m):
            setattr(class_set, name, packing.pack_mask(m))
    return class_set


def soft_zone_tsc(pod: Pod):
    """The pod's single EFFECTIVE soft (ScheduleAnyway) zone-spread
    preference, or None. Applies only when the pod carries NO hard
    constraints (a hard constraint owns the pin -- one deterministic pin
    per pod is what keeps both paths equal) and the pod matches its own
    selector. With several soft zone constraints the first applies, the
    rest are scoring no-ops. Canonical definition (solver/spread.py
    re-exports; living here keeps the import graph acyclic since the
    class signature below needs it too)."""
    if any(t.hard() for t in pod.topology_spread):
        return None
    soft = [
        t for t in pod.topology_spread
        if not t.hard() and t.topology_key == wk.ZONE_LABEL
    ]
    if not soft:
        return None
    t = soft[0]
    if not all(pod.metadata.labels.get(k) == v for k, v in t.label_selector.items()):
        return None
    return t


def _spread_sig(pod: Pod) -> tuple:
    """Spread constraints that shape placement are part of scheduling
    identity: pods that spread differently (or match their own selector
    differently) must not collapse into one class (solver/spread.py
    distributes per class). That is every HARD constraint plus the
    single EFFECTIVE soft zone preference (soft_zone_tsc -- an INERT
    soft constraint must not fragment otherwise-identical classes);
    soft non-zone constraints stay scoring no-ops. when_unsatisfiable
    is in the tuple so a hard and a soft constraint of the same shape
    never share a class."""
    sig = tuple(
        (
            t.topology_key,
            t.max_skew,
            t.when_unsatisfiable,
            tuple(sorted(t.label_selector.items())),
            all(pod.metadata.labels.get(k) == v for k, v in t.label_selector.items()),
        )
        for t in pod.topology_spread
        if t.hard()
    )
    t = soft_zone_tsc(pod)
    if t is not None:
        sig += (
            (
                t.topology_key,
                t.max_skew,
                t.when_unsatisfiable,
                tuple(sorted(t.label_selector.items())),
                True,
            ),
        )
    return sig


def oracle_suffix_rank(pod: Pod) -> int:
    """1 for pods the device kernels cannot place -- pod (anti-)affinity,
    OR-of-node-affinity-terms, preferences -- the ORACLE-SUFFIX partition;
    0 for everything else. The rank LEADS the canonical sort, so every
    suffix pod schedules after every plain pod. That makes the class-level
    carve-out (device solves the plain prefix, the oracle continues with
    the suffix over the device's open state) order-equivalent to one full
    oracle pass over the whole batch (round 5): by the time a suffix pod
    places, the full pass and the split pass have built the same world.
    Scheduling constrained pods after their potential co-location targets
    also strictly helps required-affinity feasibility (the targets exist
    by then), replacing most uses of the self-match bootstrap rule."""
    return int(
        bool(pod.affinity_terms)
        or len(pod.node_affinity_terms) > 1
        or bool(pod.preferred_node_affinity_terms)
        or bool(pod.preferred_affinity_terms)
    )


def pod_sort_key(pod: Pod) -> tuple:
    """The canonical scheduling order: oracle-suffix pods last, then
    dominant resource descending, then a pool-independent class signature
    as the tie-break. BOTH the oracle's per-pod loop and group_pods' class
    order sort by this key, so pods of equal size but different classes
    are processed in the same relative order on both paths -- shared
    spread counts then evolve identically."""
    reqs = pod.scheduling_requirements()[0]
    return (
        oracle_suffix_rank(pod),
        -pod.requests.get(res.CPU),
        -pod.requests.get(res.MEMORY),
        # full request vector: classes may differ only in another axis
        # (gpu, storage); the tie-break must still order them identically
        tuple(-v for v in scale_vector((pod.requests + _one_pod()).to_vector())),
        reqs.stable_hash(),
        tuple(sorted((t.key, t.operator, t.value, t.effect) for t in pod.tolerations)),
        _spread_sig(pod),
    )


def _class_key(pod: Pod, reqs: Requirements) -> tuple:
    return (
        # suffix rank in the key: a class never mixes plain and
        # oracle-suffix pods, so the carve-out partitions EXACTLY along
        # class boundaries. Price envelopes deliberately IGNORE the rank
        # (oracle._env_key strips element 0) so a follower still shares
        # its anchor's envelope; the carve is blocked on such collisions
        # (service._aff_partition_blocked)
        oracle_suffix_rank(pod),
        tuple(np.asarray(scale_vector(
            (pod.requests + _one_pod()).to_vector()), dtype=np.float64)),
        reqs.stable_hash(),
        tuple(sorted((t.key, t.operator, t.value, t.effect) for t in pod.tolerations)),
        _spread_sig(pod),
    )


def _one_pod():
    return Resources.from_base_units({res.PODS: 1})


# global signature intern table (utils.InternTable, same design as the
# pod spec-token table): structural signature -> small monotone int, so
# the per-call grouping loop hashes a machine int instead of re-hashing a
# deep nested tuple for every one of 50k pods. Monotone ids make a
# generation counter unnecessary: an id from before an overflow clear can
# never collide with one from after, and a stale memo merely re-interns
# (splitting, never merging, lookup groups -- classes still converge via
# _class_key).
_SIGS = InternTable()
_intern_sig = _SIGS.intern


def group_pods(pods: Sequence[Pod], extra_requirements: Optional[Requirements] = None) -> List[PodClass]:
    """Collapse pods into equivalence classes. Pods with multiple affinity
    alternatives use their first term (the oracle handles full OR semantics;
    multi-term pods are rare and can be routed to the oracle).

    Four-level grouping keeps the 50k-pod hot path inside the latency
    budget. Fast path: pods carry a shared-spec identity token
    (Pod._spec_token -- ReplicaSet replicas constructed from the same
    interned spec objects share it), so the common case is ONE dict lookup
    per pod with the whole structural machinery running once per template.
    Slow path (spread pods, or pods built from per-pod spec copies): an
    interned small-int signature id (memoized across calls -- warm ticks
    hash machine ints, not tuples), distinct ids key by the structural
    signature (Pod.grouping_signature -- raw spec tuples), and ONE
    canonical key (Requirements construction + stable hash + scaled
    request vector) is computed per distinct signature. Signatures whose
    canonical keys coincide (e.g. the same constraint written as
    nodeSelector vs nodeAffinity) share a class, as do distinct tokens with
    equal signatures. The single ordered pass preserves input order within
    each class -- required for exact differential equivalence with the
    oracle's stable per-pod sort."""
    tok_to_class: Dict[tuple, PodClass] = {}
    id_to_class: Dict[tuple, PodClass] = {}
    groups: Dict[tuple, PodClass] = {}
    tok_get = tok_to_class.get
    id_get = id_to_class.get

    def classify(pod: Pod) -> PodClass:
        sid = pod._sig_id
        if sid is None:
            sid = pod._sig_id = _intern_sig(pod.grouping_signature())
        pc = id_get(sid)
        if pc is None:
            reqs = pod.scheduling_requirements()[0]
            if extra_requirements is not None:
                reqs = reqs.copy().add(*extra_requirements)
            key = _class_key(pod, reqs)
            pc = groups.get(key)
            if pc is None:
                requested = scale_vector((pod.requests + _one_pod()).to_vector()).astype(np.float32)
                pc = groups[key] = PodClass(pods=[], requests=requested, requirements=reqs, key=key)
            # routing bits OR over every signature the class absorbs.
            # oracle_suffix_rank in the class key means a constrained pod
            # can never merge behind a PLAIN representative; the bits are
            # uniform per class and the carve partitions along class
            # boundaries (TorchSolver._suffix_classes)
            if pod.affinity_terms:
                pc.has_affinity = True
            if len(pod.node_affinity_terms) > 1:
                pc.multi_node_affinity = True
            if pod.preferred_node_affinity_terms or pod.preferred_affinity_terms:
                pc.has_preferences = True
            id_to_class[sid] = pc
        return pc

    # gc paused: cold grouping of 50k fresh pods allocates ~400k young
    # containers; mid-loop generational collections multiply the cost ~6x
    with gc_paused():
        if _native_grouping is not None:
            # the C hot loop (native/_grouping.c): token attribute read +
            # dict probe + list append per pod, calling classify() back
            # only on per-template misses -- same semantics, less per-pod
            # cost (chip_smoke.py phase `times` holds the two loops)
            _native_grouping.group_by_token(pods, classify)
        else:
            for pod in pods:
                tok = pod._spec_token
                if tok is not None:
                    pc = tok_get(tok)
                    if pc is None:
                        pc = tok_to_class[tok] = classify(pod)
                else:
                    pc = classify(pod)
                pc.pods.append(pod)
    # FFD order: dominant resource descending with the canonical tie-break
    # (pod_sort_key) -- must match the oracle's sort for differential
    # equivalence, including between equal-sized classes
    out = list(groups.values())
    out.sort(key=lambda pc: pod_sort_key(pc.pods[0]))
    return out


class IncrementalGrouper:
    """Dirty-tracking grouping across scheduling ticks (the delta-solve
    engine's host layer). group() is drop-in equivalent to group_pods(pods)
    -- same classes, same order, same pods lists, fresh PodClass objects
    per call (pipelined tickets own their class lists) -- but every
    per-signature canonical computation is memoized ACROSS ticks instead
    of per call: Requirements construction, the class key, the scaled
    request vector, the routing flags, and the FFD sort key (a pure
    function of class identity: every pod_sort_key component is determined
    by the _class_key components). A warm steady-state tick's grouping
    therefore costs one token/signature dict probe + list append per pod
    (the same native C loop group_pods runs) plus canonical work ONLY for
    signatures never seen before -- classification cost scales with churn,
    not cluster size.

    Routing flags are memoized PER SIGNATURE and OR'd over the signatures
    present THIS tick (exactly group_pods' fresh semantics -- a class whose
    affinity-carrying pods all left does not keep a stale flag).

    last_stats reports the tick-over-tick churn: classes whose pod count
    changed, appeared, or vanished since the previous call -- the
    dirty-fraction signal the delta wire metrics and span attrs quote.

    Not thread-safe; owned by the (single-threaded) scheduling tick."""

    def __init__(self):
        # sig id -> (class key, Requirements, requests f32, flags)
        self._sig_memo: Dict[int, tuple] = {}
        self._sort_memo: Dict[tuple, tuple] = {}   # class key -> pod_sort_key
        self._prev_counts: Dict[tuple, int] = {}
        self.last_stats = {
            "pods": 0, "classes": 0, "dirty_classes": 0, "new_classes": 0,
            "removed_classes": 0, "dirty_fraction": 1.0, "full_rebuild": True,
        }

    def reset(self) -> None:
        self.__init__()

    def group(self, pods: Sequence[Pod]) -> List[PodClass]:
        if len(self._sig_memo) > (1 << 16):
            # bound memo growth under signature churn: a clear only
            # re-derives canonical keys once (ids are monotone, so a stale
            # _sig_id can never alias -- see the _SIGS intern table)
            self._sig_memo.clear()
            self._sort_memo.clear()
        first = not self._prev_counts
        sig_memo = self._sig_memo
        tok_to_class: Dict[int, PodClass] = {}
        id_to_class: Dict[int, PodClass] = {}
        groups: Dict[tuple, PodClass] = {}
        tok_get = tok_to_class.get
        id_get = id_to_class.get

        def classify(pod: Pod) -> PodClass:
            sid = pod._sig_id
            if sid is None:
                sid = pod._sig_id = _intern_sig(pod.grouping_signature())
            pc = id_get(sid)
            if pc is not None:
                return pc
            ent = sig_memo.get(sid)
            if ent is None:
                reqs = pod.scheduling_requirements()[0]
                key = _class_key(pod, reqs)
                requested = scale_vector(
                    (pod.requests + _one_pod()).to_vector()
                ).astype(np.float32)
                flags = (
                    bool(pod.affinity_terms),
                    len(pod.node_affinity_terms) > 1,
                    bool(pod.preferred_node_affinity_terms or pod.preferred_affinity_terms),
                )
                ent = sig_memo[sid] = (key, reqs, requested, flags)
            key, reqs, requested, flags = ent
            pc = groups.get(key)
            if pc is None:
                pc = groups[key] = PodClass(
                    pods=[], requests=requested, requirements=reqs, key=key
                )
            if flags[0]:
                pc.has_affinity = True
            if flags[1]:
                pc.multi_node_affinity = True
            if flags[2]:
                pc.has_preferences = True
            id_to_class[sid] = pc
            return pc

        with gc_paused():
            if _native_grouping is not None:
                _native_grouping.group_by_token(pods, classify)
            else:
                for pod in pods:
                    tok = pod._spec_token
                    if tok is not None:
                        pc = tok_get(tok)
                        if pc is None:
                            pc = tok_to_class[tok] = classify(pod)
                    else:
                        pc = classify(pod)
                    pc.pods.append(pod)
        sort_memo = self._sort_memo

        def order_key(pc: PodClass) -> tuple:
            k = sort_memo.get(pc.key)
            if k is None:
                k = sort_memo[pc.key] = pod_sort_key(pc.pods[0])
            return k

        out = list(groups.values())
        out.sort(key=order_key)
        prev = self._prev_counts
        counts = {pc.key: len(pc.pods) for pc in out}
        new = sum(1 for k in counts if k not in prev)
        changed = sum(1 for k, n in counts.items() if k in prev and prev[k] != n)
        removed = sum(1 for k in prev if k not in counts)
        self._prev_counts = counts
        n_classes = len(counts)
        self.last_stats = {
            "pods": len(pods),
            "classes": n_classes,
            "dirty_classes": new + changed,
            "new_classes": new,
            "removed_classes": removed,
            # denominator = |prev UNION cur| (= cur + removed), so a full
            # turnover reads 1.0, never above -- the histogram buckets and
            # the span attr both promise a fraction
            "dirty_fraction": (
                1.0 if first
                else (new + changed + removed) / max(1, n_classes + removed)
            ),
            "full_rebuild": first,
        }
        return out


def with_extra_requirements(classes: Sequence[PodClass], extra: Requirements) -> List[PodClass]:
    """Re-base already-grouped classes onto a nodepool's requirements --
    the per-class equivalent of group_pods(pods, extra_requirements=...),
    letting one grouping pass serve routing plus every pool's solve.
    Classes that would have merged under the extra requirements stay
    separate, which the solver handles as independent rows."""
    return [
        PodClass(
            pods=pc.pods, requests=pc.requests,
            requirements=pc.requirements.copy().add(*extra),
            key=pc.key, env_count=pc.env_count,
            has_affinity=pc.has_affinity, multi_node_affinity=pc.multi_node_affinity,
            has_preferences=pc.has_preferences,
        )
        for pc in classes
    ]


def _allowed_bits_for(reqs: Requirements, vocab: Vocab, dim: str, words: int) -> np.ndarray:
    """Packed allowed-set bitmask for one dim. Unknown values in an In-set
    are ignored (they can't match any type); absent requirement = all ones.

    Semantics mirror Requirements.compatible on the *type* side: a type that
    does not define the label (code 0, 'absent') is PERMISSIVELY compatible
    with any requirement on that label (e.g. the karpenter.sh/nodepool
    requirement never appears on catalog types) -- except DoesNotExist,
    where absent is the only admissible state and defined values are not."""
    r = reqs.get(dim)
    out = np.zeros((words,), dtype=np.uint64)
    if r is None:
        out[:] = np.uint64(0xFFFFFFFF)
        return out.astype(np.uint32)
    if r.is_does_not_exist():
        out[0] = np.uint64(1)  # only 'absent' allowed
        return out.astype(np.uint32)
    if r.complement:
        out[:] = np.uint64(0xFFFFFFFF)
        for v in r.values:
            i = vocab.index.get(v)
            if i is not None:
                out[i // 32] &= ~np.uint64(1 << (i % 32))
    else:
        for v in r.values:
            i = vocab.index.get(v)
            if i is not None:
                out[i // 32] |= np.uint64(1 << (i % 32))
    out[0] |= np.uint64(1)  # absent label on the type side is permissive
    return out.astype(np.uint32)


def _row_key(pc: PodClass, taints_sig: tuple) -> tuple:
    """Cache key for one class's encoded tensor ROW (encode_classes
    row_cache): the full canonical requirement content -- NOT a hash, so
    two distinct requirement sets can never collide into one row -- plus
    the representative's tolerations (schedulable depends on them), the
    pool taints, and the FLOAT64-exact scaled request vector (the same
    precision _class_key distinguishes classes at: the cached row carries
    the exact base_req, so keying on the float32-rounded pc.requests
    could alias two classes whose requests differ below a float32 ulp)."""
    return (
        tuple(sorted(
            (r.key, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than)
            for r in pc.requirements
        )),
        tuple(
            (t.key, t.operator, t.value, t.effect) for t in pc.pods[0].tolerations
        ),
        taints_sig,
        scale_vector((pc.pods[0].requests + _one_pod()).to_vector()).tobytes(),
    )


def encode_classes(
    classes: Sequence[PodClass],
    catalog: CatalogTensors,
    pool_taints: Sequence[Taint] = (),
    c_pad: Optional[int] = None,
    node_overhead: Optional[np.ndarray] = None,
    row_cache: Optional[Dict] = None,
) -> PodClassSet:
    """classes -> dense solver tensors (host-side numpy).

    `row_cache` (optional, scoped to
    ONE catalog encoding -- the caller keys it per staged-catalog entry)
    memoizes the per-class row products that are pure functions of
    (requirements, tolerations, pool taints, requests): the packed allowed
    bitmasks, numeric windows, zone/captype masks, schedulability, and the
    float64 base request vector. On a warm steady-state tick only CHANGED
    classes pay the row construction; counts and env_counts are always
    written fresh (they change every tick and cost one store)."""
    c_real = len(classes)
    if c_pad is None:
        c_pad = max(8, ((c_real + 7) // 8) * 8)
    req = np.zeros((c_pad, R), dtype=np.float32)
    count = np.zeros((c_pad,), dtype=np.int32)
    env_count = np.zeros((c_pad,), dtype=np.int32)
    allowed = [np.zeros((c_pad, w), dtype=np.uint32) for w in catalog.words]
    num_lo = np.full((c_pad, ND), -np.inf, dtype=np.float32)
    num_hi = np.full((c_pad, ND), np.inf, dtype=np.float32)
    azone = np.zeros((c_pad, Z_PAD), dtype=bool)
    acap = np.zeros((c_pad, CT), dtype=bool)
    schedulable = np.zeros((c_pad,), dtype=bool)
    base_req = np.zeros((c_pad, R), dtype=np.float64)
    taints_sig = tuple((t.key, t.value, t.effect) for t in pool_taints)
    n_zones = len(catalog.zones)
    one = _one_pod()
    for c, pc in enumerate(classes):
        req[c] = pc.requests
        count[c] = len(pc.pods)
        env_count[c] = pc.env_count
        reqs = pc.requirements
        row = rkey = None
        if row_cache is not None:
            rkey = _row_key(pc, taints_sig)
            row = row_cache.get(rkey)
        if row is None:
            arow = [
                _allowed_bits_for(reqs, catalog.vocabs[d], dim, catalog.words[d])
                for d, dim in enumerate(LABEL_DIMS)
            ]
            nlo = np.full((ND,), -np.inf, dtype=np.float32)
            nhi = np.full((ND,), np.inf, dtype=np.float32)
            for nd_i, dim in enumerate(NUMERIC_DIMS):
                r = reqs.get(dim)
                if r is not None:
                    if r.greater_than is not None:
                        nlo[nd_i] = r.greater_than
                    if r.less_than is not None:
                        nhi[nd_i] = r.less_than
                    # In-sets over numeric dims are handled via the bitset
                    # path when the dim is also a LABEL_DIM
            zreq = reqs.get(wk.ZONE_LABEL)
            az = np.array(
                [zreq is None or zreq.matches(zone) for zone in catalog.zones],
                dtype=bool,
            )
            creq = reqs.get(wk.CAPACITY_TYPE_LABEL)
            ac = np.zeros((CT,), dtype=bool)
            for name, idx in CAPTYPE_INDEX.items():
                ac[idx] = creq is None or creq.matches(name)
            sched = tolerates_all(pc.pods[0].tolerations, pool_taints)
            brow = np.asarray(
                (pc.pods[0].requests + one).to_vector(), dtype=np.float64
            )
            row = (arow, nlo, nhi, az, ac, sched, brow)
            if row_cache is not None:
                if len(row_cache) > 8192:
                    row_cache.clear()  # bound growth across catalog lifetime
                row_cache[rkey] = row
        arow, nlo, nhi, az, ac, sched, brow = row
        for d in range(D):
            allowed[d][c] = arow[d]
        num_lo[c] = nlo
        num_hi[c] = nhi
        azone[c, :n_zones] = az
        acap[c] = ac
        schedulable[c] = sched
        base_req[c] = brow
    return PodClassSet(
        classes=list(classes), c_real=c_real, c_pad=c_pad, req=req, count=count,
        env_count=env_count, allowed=allowed, num_lo=num_lo, num_hi=num_hi,
        azone=azone, acap=acap, schedulable=schedulable,
        node_overhead=(
            node_overhead.astype(np.float32)
            if node_overhead is not None else np.zeros((R,), dtype=np.float32)
        ),
        base_req=base_req,
    )


def compat_matrix(catalog: CatalogTensors, classes: PodClassSet) -> np.ndarray:
    """[C, K] bool: class c may run on type k (labels + numeric windows).
    Host/numpy reference implementation -- the solver computes the same
    thing on device (solver/ffd.py)."""
    C, K = classes.c_pad, catalog.k_pad
    ok = np.ones((C, K), dtype=bool)
    for d in range(D):
        codes = catalog.tcode[:, d]                       # [K]
        words = classes.allowed[d][:, codes // 32]        # [C, K]
        bits = (words >> (codes % 32).astype(np.uint32)) & 1
        ok &= bits.astype(bool)
    for nd_i in range(ND):
        v = catalog.tnum[:, nd_i][None, :]
        present = catalog.tnum_present[:, nd_i][None, :]
        in_window = (v > classes.num_lo[:, nd_i][:, None]) & (v < classes.num_hi[:, nd_i][:, None])
        # a type that does not define the numeric label is permissively
        # compatible (matches Requirements.compatible for missing keys)
        ok &= in_window | ~present
    # offering-level compat: some permitted zone AND captype must exist
    ok &= (classes.azone.astype(np.int8) @ catalog.tzone.T.astype(np.int8)) > 0
    ok &= (classes.acap.astype(np.int8) @ catalog.tcap.T.astype(np.int8)) > 0
    ok &= classes.schedulable[:, None]
    ok[:, catalog.k_real:] = False
    ok[classes.c_real:, :] = False
    return ok
