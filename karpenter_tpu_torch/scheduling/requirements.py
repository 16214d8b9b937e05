"""Label-requirement constraint algebra.

Copy of karpenter_tpu/scheduling/requirements.py.

The reference leans on the core module's `scheduling.Requirements` everywhere
(e.g. pkg/providers/instancetype/types.go:158-292 builds ~30 requirements per
instance type; pkg/providers/instance/instance.go:244-249 filters candidate
types via `.Compatible`). That algebra -- node-selector operators over label
sets, with intersection and compatibility -- is rebuilt here from its observed
semantics, as the host-side half of a dual representation:

- here: exact set algebra on small string sets (control plane, explainable)
- solver/encode.py: the same constraints lowered to boolean masks over the
  catalog's label columns (decision plane, vectorized)

Operator semantics follow k8s NodeSelectorOperator: In, NotIn, Exists,
DoesNotExist, Gt, Lt.
"""
from __future__ import annotations

import enum
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Set, Tuple


class Operator(str, enum.Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"


class Requirement:
    """One constraint on one label key.

    Internally normalized to one of three forms:
      - complement=False: allowed values = `values` (In / numeric windows)
      - complement=True:  allowed values = everything except `values`
        (Exists == complement of {}; NotIn; DoesNotExist == empty In)
      - additionally a numeric window [gt, lt] (exclusive bounds) that
        composes with the set form, mirroring how the core treats Gt/Lt.
    """

    __slots__ = ("key", "complement", "values", "greater_than", "less_than", "min_values")

    def __init__(
        self,
        key: str,
        operator: Operator | str,
        values: Sequence[str] = (),
        min_values: Optional[int] = None,
    ):
        operator = Operator(operator)
        self.key = key
        self.greater_than: Optional[float] = None
        self.less_than: Optional[float] = None
        self.min_values = min_values
        if operator == Operator.IN:
            self.complement = False
            self.values: Set[str] = set(values)
        elif operator == Operator.NOT_IN:
            self.complement = True
            self.values = set(values)
        elif operator == Operator.EXISTS:
            self.complement = True
            self.values = set()
        elif operator == Operator.DOES_NOT_EXIST:
            self.complement = False
            self.values = set()
        elif operator == Operator.GT:
            self.complement = True
            self.values = set()
            self.greater_than = float(values[0])
        elif operator == Operator.LT:
            self.complement = True
            self.values = set()
            self.less_than = float(values[0])
        else:  # pragma: no cover
            raise ValueError(f"unsupported operator {operator}")

    # -- predicates ---------------------------------------------------------
    def matches(self, value: Optional[str]) -> bool:
        """Does a concrete label value satisfy this requirement?
        `None` means the label is absent."""
        if value is None:
            # Absent label: only DoesNotExist (empty In == no allowed values?
            # no -- empty-In means unsatisfiable-for-present) matches.
            return self.complement is False and not self.values and self._window_open()
        if self.complement:
            if value in self.values:
                return False
        else:
            if value not in self.values:
                return False
        return self._in_window(value)

    def _window_open(self) -> bool:
        return self.greater_than is None and self.less_than is None

    def _in_window(self, value: str) -> bool:
        if self.greater_than is None and self.less_than is None:
            return True
        try:
            num = float(value)
        except ValueError:
            return False
        if self.greater_than is not None and not num > self.greater_than:
            return False
        if self.less_than is not None and not num < self.less_than:
            return False
        return True

    def is_does_not_exist(self) -> bool:
        return not self.complement and not self.values and self._window_open()

    # -- algebra ------------------------------------------------------------
    def intersect(self, other: "Requirement") -> "Requirement":
        """Tightest requirement satisfied only by values allowed by both."""
        assert self.key == other.key
        if self.complement and other.complement:
            out = Requirement(self.key, Operator.NOT_IN, sorted(self.values | other.values))
        elif self.complement and not other.complement:
            out = Requirement(self.key, Operator.IN, sorted(other.values - self.values))
        elif not self.complement and other.complement:
            out = Requirement(self.key, Operator.IN, sorted(self.values - other.values))
        else:
            out = Requirement(self.key, Operator.IN, sorted(self.values & other.values))
        gts = [g for g in (self.greater_than, other.greater_than) if g is not None]
        lts = [l for l in (self.less_than, other.less_than) if l is not None]
        out.greater_than = max(gts) if gts else None
        out.less_than = min(lts) if lts else None
        if not out.complement:
            out.values = {v for v in out.values if out._in_window(v)}
            out.greater_than = out.less_than = None
        out.min_values = max(filter(None, (self.min_values, other.min_values)), default=None)
        return out

    def intersects(self, other: "Requirement") -> bool:
        """Could any value satisfy both requirements?"""
        merged = self.intersect(other)
        if merged.complement:
            # complement sets always admit *some* value unless the numeric
            # window is empty
            if merged.greater_than is not None and merged.less_than is not None:
                return merged.less_than - merged.greater_than > 1
            return True
        return bool(merged.values)

    def allows(self, other: "Requirement") -> bool:
        """Is every value admitted by `other` also admitted by self?
        (i.e. other is at least as tight). Conservative on complements."""
        if not other.complement:
            return all(self.matches(v) for v in other.values)
        # `other` admits an open-ended set; only an Exists self safely covers it.
        return self.complement and not self.values and self._window_open()

    def copy(self) -> "Requirement":
        op = Operator.NOT_IN if self.complement else Operator.IN
        out = Requirement(self.key, op, sorted(self.values))
        out.greater_than = self.greater_than
        out.less_than = self.less_than
        out.min_values = self.min_values
        return out

    def __repr__(self) -> str:
        if self.complement:
            if not self.values and self._window_open():
                core = f"{self.key} Exists"
            else:
                core = f"{self.key} NotIn {sorted(self.values)}"
        else:
            core = f"{self.key} In {sorted(self.values)}"
        win = ""
        if self.greater_than is not None:
            win += f" >{self.greater_than:g}"
        if self.less_than is not None:
            win += f" <{self.less_than:g}"
        return f"Requirement({core}{win})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, Requirement):
            return NotImplemented
        return (
            self.key == other.key
            and self.complement == other.complement
            and self.values == other.values
            and self.greater_than == other.greater_than
            and self.less_than == other.less_than
        )

    def __hash__(self):
        return hash((self.key, self.complement, frozenset(self.values), self.greater_than, self.less_than))


class Requirements:
    """A conjunction of Requirements keyed by label.

    Mirrors the observed call surface of the core's scheduling.Requirements:
    NewRequirements/NewLabelRequirements, Add (tightening merge), Compatible,
    Intersects, Has/Get, Keys, Labels.
    """

    def __init__(self, reqs: Iterable[Requirement] = ()):
        self._m: Dict[str, Requirement] = {}
        for r in reqs:
            self.add(r)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_labels(cls, labels: Mapping[str, str]) -> "Requirements":
        return cls(Requirement(k, Operator.IN, [v]) for k, v in labels.items())

    @classmethod
    def from_node_selector(cls, selector: Mapping[str, str]) -> "Requirements":
        return cls.from_labels(selector)

    @classmethod
    def from_node_selector_terms(cls, terms: Sequence[Mapping]) -> List["Requirements"]:
        """nodeAffinity requiredDuringScheduling terms: OR of ANDs.
        Returns one Requirements per term; callers try each (the core treats
        terms as alternatives)."""
        out = []
        for term in terms:
            reqs = []
            for expr in term.get("matchExpressions", []):
                reqs.append(Requirement(expr["key"], expr["operator"], expr.get("values", [])))
            out.append(cls(reqs))
        return out

    # -- mutation -----------------------------------------------------------
    def add(self, *reqs: Requirement) -> "Requirements":
        for r in reqs:
            if r.key in self._m:
                self._m[r.key] = self._m[r.key].intersect(r)
            else:
                self._m[r.key] = r.copy()
        return self

    def union(self, other: "Requirements") -> "Requirements":
        out = Requirements(self._m.values())
        out.add(*other._m.values())
        return out

    # -- access -------------------------------------------------------------
    def has(self, key: str) -> bool:
        return key in self._m

    def get(self, key: str) -> Optional[Requirement]:
        return self._m.get(key)

    def keys(self) -> Set[str]:
        return set(self._m.keys())

    def __iter__(self) -> Iterator[Requirement]:
        return iter(self._m.values())

    def __len__(self) -> int:
        return len(self._m)

    def labels(self) -> Dict[str, str]:
        """Project requirements that pin a single value into a label map
        (how NodeClaim requirements become node labels in the reference)."""
        out = {}
        for k, r in self._m.items():
            if not r.complement and len(r.values) == 1:
                out[k] = next(iter(r.values))
        return out

    # -- algebra ------------------------------------------------------------
    def compatible(self, other: "Requirements", allow_undefined: Optional[Set[str]] = None) -> bool:
        """Can a single entity satisfy both requirement sets?

        For every key present in `other`, self must either intersect on that
        key or (if self lacks the key) the key must be in `allow_undefined`
        (mirrors the core's allowUndefinedWellKnownLabels compatibility used
        when matching pods against not-yet-labeled in-flight nodes).
        """
        for key, theirs in other._m.items():
            mine = self._m.get(key)
            if mine is None:
                if allow_undefined is not None and key not in allow_undefined:
                    return False
                if theirs.is_does_not_exist():
                    continue
                continue
            if theirs.is_does_not_exist():
                # other forbids the label; self defines it -> incompatible
                return False
            if not mine.intersects(theirs):
                return False
        return True

    def intersects(self, other: "Requirements") -> bool:
        return self.compatible(other) and other.compatible(self)

    def matches_labels(self, labels: Mapping[str, str]) -> bool:
        """Do concrete node labels satisfy every requirement?"""
        return all(r.matches(labels.get(k)) for k, r in self._m.items())

    def copy(self) -> "Requirements":
        return Requirements(r.copy() for r in self._m.values())

    def __repr__(self) -> str:
        return "Requirements(" + ", ".join(repr(r) for r in self._m.values()) + ")"

    def stable_hash(self) -> str:
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        for k in sorted(self._m):
            r = self._m[k]
            h.update(
                f"{k}|{r.complement}|{sorted(r.values)}|{r.greater_than}|{r.less_than};".encode()
            )
        return h.hexdigest()


def min_values_shortfall(reqs: "Requirements", instance_types) -> Optional[str]:
    """The first requirement key whose minValues flexibility is NOT met by
    `instance_types` (fewer distinct label values than required), or None.
    The karpenter v1 minValues contract: a NodeClaim must keep at least N
    distinct values of the key among its candidate types, guaranteeing
    launch flexibility."""
    for r in reqs:
        if r.min_values is None:
            continue
        distinct = {
            it.requirements.labels().get(r.key)
            for it in instance_types
            if it.requirements.labels().get(r.key) is not None
        }
        if len(distinct) < r.min_values:
            return r.key
    return None


def truncate_preserving_min_values(
    reqs: "Requirements", types_sorted, cap: int
):
    """Truncate a cheapest-first type list to `cap`, keeping minValues
    satisfied when the full list satisfies it: fill cheapest-first, then
    for each unmet key swap in the cheapest remaining type contributing a
    NEW value, evicting the most expensive chosen type whose removal
    breaks nothing. Mirrors the reference's truncation honoring
    spec.requirements[].minValues."""
    chosen = list(types_sorted[:cap])
    if len(types_sorted) <= cap:
        return chosen
    min_reqs = [r for r in reqs if r.min_values is not None]
    if not min_reqs:
        return chosen
    rest = list(types_sorted[cap:])

    def values_of(pool, key):
        out = {}
        for it in pool:
            v = it.requirements.labels().get(key)
            if v is not None:
                out.setdefault(v, 0)
                out[v] += 1
        return out

    for r in min_reqs:
        have = values_of(chosen, r.key)
        need = r.min_values - len(have)
        if need <= 0:
            continue
        for it in rest:
            if need <= 0:
                break
            v = it.requirements.labels().get(r.key)
            if v is None or v in have:
                continue
            # evict the priciest chosen type that is not the last holder
            # of any minValues-contributing value
            evict_idx = None
            for j in range(len(chosen) - 1, -1, -1):
                cand = chosen[j]
                safe = True
                for r2 in min_reqs:
                    v2 = cand.requirements.labels().get(r2.key)
                    if v2 is not None:
                        holders = values_of(chosen, r2.key)
                        if holders.get(v2, 0) <= 1 and len(holders) <= r2.min_values:
                            safe = False
                            break
                if safe:
                    evict_idx = j
                    break
            if evict_idx is None:
                break
            chosen.pop(evict_idx)
            chosen.append(it)
            have[v] = 1
            need -= 1
    return chosen
