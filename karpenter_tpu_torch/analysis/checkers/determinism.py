"""Determinism checker: replay-breaking entropy, caught at lint time.

Copy of karpenter_tpu/analysis/checkers/determinism.py over the port.
The golden-digest discipline (docs/simulation.md) holds only if every
RNG and clock a replay can observe derives from Options.seed through
karpenter_tpu_torch/seeding.py; a NodeClaim-name ``uuid4`` once showed
up only at replay time, and this checker finds the next one at lint time.
The port adds torch's generators: an explicit ``torch.Generator`` stream
(passed as ``generator=``) is blessed like seeding.py's streams, and a
draw from torch's GLOBAL generator is flagged like ``random.*``.

Call names are resolved through the module's import aliases before
matching (``import time as _time`` / ``from random import choice`` /
``from datetime import datetime as dt`` cannot launder an entropy or
clock read), mirroring the lock checker's import maps.

Rules:

- ``determinism/uuid4``     -- a ``uuid.uuid4()`` CALL. Exempt ONLY on
  the unseeded-fallback arm of an ``X_rng``-vs-None test: the documented
  shape of a seedable stream's production fallback (apis/objects.py
  generate_name / generate_uid / generate_intent_token). A uuid4 call on
  the SEEDED arm -- or anywhere else in a function that happens to touch
  a ``*_rng`` stream -- is a violation.
- ``determinism/random``    -- a ``random.X(...)`` or ``np.random.X(...)``
  call drawing from process-global entropy. Seeded STREAM CONSTRUCTION
  is exempt: ``random.Random(seed_expr)`` / ``np.random.default_rng(seed)``
  with arguments. The torch spellings: ``torch.rand*``/``randperm``/
  ``normal``/``bernoulli``/``multinomial``/``poisson`` and the in-place
  ``.uniform_()``/``.normal_()``/... without ``generator=``, and
  ``torch.manual_seed``/``torch.seed``/``torch.cuda.manual_seed*`` (they
  reseed the global generator every other module shares). Bare references (``rng=random.random`` as an
  injectable default) are not calls and never flagged -- injection
  points are the sanctioned pattern.
- ``determinism/wallclock`` -- ``time.time()`` / ``time.time_ns()`` /
  ``datetime.now()`` / ``datetime.utcnow()`` calls outside a function
  named ``now``/``_now``: wall-clock reads live behind a NAMED clock
  seam with an injectable clock (cache/ttl.py Clock), so FakeClock can
  own time everywhere else. ``time.monotonic``/``perf_counter`` measure
  durations, never feed decisions, and are not flagged.
- ``determinism/iter-order`` -- iteration whose order the runtime does
  not define: looping a set display / ``set(...)`` / set comprehension
  directly (PYTHONHASHSEED-dependent), or ``os.listdir``/``glob.glob``/
  ``os.scandir`` results consumed without ``sorted()`` anywhere above
  them (a listing feeding a comprehension inside ``sorted(...)`` is
  order-independent and exempt).

karpenter_tpu_torch/seeding.py is exempt wholesale: it IS the sanctioned
entropy seam.
"""
from __future__ import annotations

import ast
from typing import List, Set

from karpenter_tpu_torch.analysis.base import Module, Violation
from karpenter_tpu_torch.analysis.base import dotted as _dotted

EXEMPT_MODULES = ("karpenter_tpu_torch/seeding.py",)
CLOCK_SEAM_NAMES = ("now", "_now")
WALLCLOCK_CALLS = {
    ("time", "time"), ("time", "time_ns"),
    ("datetime", "now"), ("datetime", "utcnow"),
}
LISTING_CALLS = {
    ("os", "listdir"), ("os", "scandir"), ("glob", "glob"), ("glob", "iglob"),
}
# torch draws that take `generator=`: without one they use the global
# generator (a module-level `torch.X(...)` call or a tensor's in-place fill)
TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
})
TORCH_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "exponential_", "geometric_",
    "log_normal_", "cauchy_", "bernoulli_",
})
# calls that reseed torch's global generators
TORCH_GLOBAL_SEEDS = frozenset({
    ("torch", "manual_seed"), ("torch", "seed"),
    ("cuda", "manual_seed"), ("cuda", "manual_seed_all"), ("cuda", "seed"),
    ("cuda", "seed_all"), ("random", "manual_seed"), ("random", "seed"),
})


def _aliases(tree: ast.AST):
    """(imports, from_imports) like the lock checker's _collect: the
    canonicalizer resolves aliased call spellings through these."""
    imports = {}
    from_imports = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    imports[a.asname] = a.name
                else:
                    # `import os.path` binds the ROOT name to the root module
                    root = a.name.split(".")[0]
                    imports[root] = root
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                from_imports[a.asname or a.name] = (node.module, a.name)
    return imports, from_imports


def _uuid4_fallback_ids(tree: ast.AST) -> Set[int]:
    """Node ids on the unseeded-fallback arm of an ``X_rng``-vs-None test
    inside a function -- the one place a bare uuid4 is sanctioned. For
    `if X_rng is None:` / `if not X_rng:` the fallback arm is the body;
    for `if X_rng is not None:` / `if X_rng:` it is everything else in
    the function (the else-or-after region of the generate_* shape)."""
    exempt: Set[int] = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        fn_ids = None
        for iff in ast.walk(fn):
            if not isinstance(iff, ast.If):
                continue
            t = iff.test
            rng_expr = none_in_body = None
            if (isinstance(t, ast.Compare) and len(t.ops) == 1
                    and isinstance(t.ops[0], (ast.Is, ast.IsNot))
                    and isinstance(t.comparators[0], ast.Constant)
                    and t.comparators[0].value is None):
                rng_expr = t.left
                none_in_body = isinstance(t.ops[0], ast.Is)
            elif isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
                rng_expr = t.operand
                none_in_body = True
            elif isinstance(t, (ast.Name, ast.Attribute)):
                rng_expr = t
                none_in_body = False
            if rng_expr is None:
                continue
            name = _dotted(rng_expr) or ""
            if not name.split(".")[-1].endswith("_rng"):
                continue
            body_ids = {id(n) for st in iff.body for n in ast.walk(st)}
            if none_in_body:
                exempt |= body_ids
            else:
                if fn_ids is None:
                    fn_ids = {id(n) for n in ast.walk(fn)}
                exempt |= fn_ids - body_ids
    return exempt


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


class _Scan(ast.NodeVisitor):
    def __init__(self, mod: Module):
        self.mod = mod
        self.out: List[Violation] = []
        # enclosing def stack: names only (the clock-seam check)
        self.funcs: List[str] = []
        # call nodes anywhere INSIDE a sorted() first argument (the
        # listing may feed a filtering comprehension; the sort still
        # erases its order)
        self.sorted_args: Set[int] = set()
        self.imports, self.from_imports = _aliases(mod.tree)
        self.uuid4_fallback = _uuid4_fallback_ids(mod.tree)

    # -- scope tracking -------------------------------------------------------
    def _enter(self, node, name: str):
        self.funcs.append(name)
        self.generic_visit(node)
        self.funcs.pop()

    def visit_FunctionDef(self, node):
        self._enter(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._enter(node, node.name)

    def visit_Lambda(self, node):
        self._enter(node, "<lambda>")

    def _in_clock_seam(self) -> bool:
        return bool(self.funcs) and self.funcs[-1] in CLOCK_SEAM_NAMES

    def _canonical(self, dotted: str) -> str:
        """Resolve the spelling's root through the import aliases:
        `_time.time` -> `time.time`, `choice` -> `random.choice`,
        `dt.now` (from `datetime import datetime as dt`) ->
        `datetime.datetime.now`. Unknown roots pass through unchanged."""
        parts = dotted.split(".")
        head = parts[0]
        if head in self.imports:
            return ".".join([self.imports[head]] + parts[1:])
        if head in self.from_imports:
            mod, orig = self.from_imports[head]
            return ".".join([mod, orig] + parts[1:])
        return dotted

    # -- rules ----------------------------------------------------------------
    def visit_Call(self, node: ast.Call):
        dotted = _dotted(node.func)
        if dotted:
            self._check_dotted_call(node, dotted)
        self.generic_visit(node)

    def _check_dotted_call(self, node: ast.Call, dotted: str):
        v = self.mod.violation
        parts = tuple(self._canonical(dotted).split("."))
        tail2 = parts[-2:] if len(parts) >= 2 else (None, parts[-1])
        if parts[-1] == "uuid4":
            if id(node) not in self.uuid4_fallback:
                self.out.append(v("determinism/uuid4", node,
                                  "bare uuid.uuid4() outside a seedable *_rng "
                                  "stream's unseeded-fallback arm (derive from "
                                  "seeding.seeded_rng or baseline with a "
                                  "uniqueness justification)"))
            return
        if tail2 in WALLCLOCK_CALLS and not self._in_clock_seam():
            self.out.append(v("determinism/wallclock", node,
                              f"wall-clock read {dotted}() outside a now()/_now() "
                              "clock seam; thread an injectable clock instead"))
            return
        if tail2 in LISTING_CALLS and id(node) not in self.sorted_args:
            self.out.append(v("determinism/iter-order", node,
                              f"{dotted}() order is filesystem-dependent; wrap "
                              "in sorted(...)"))
            return
        if parts[0] == "torch" and (tail2 in TORCH_GLOBAL_SEEDS
                                    or parts[-2:] == ("random", "manual_seed")):
            self.out.append(v("determinism/random", node,
                              f"{dotted}() reseeds torch's global generator; "
                              "draw from an explicit torch.Generator stream"))
            return
        has_generator = any(kw.arg == "generator" for kw in node.keywords)
        if ((len(parts) == 2 and parts[0] == "torch" and parts[1] in TORCH_DRAWS)
                or (len(parts) >= 2 and parts[-1] in TORCH_INPLACE_DRAWS)) \
                and not has_generator:
            self.out.append(v("determinism/random", node,
                              f"{dotted}() draws from torch's global generator; "
                              "pass generator= (a seeding-derived torch.Generator)"))
            return
        # random.X(...) / np.random.X(...): module-level entropy draws
        if len(parts) >= 2 and parts[-2] == "random":
            if parts[-1] in ("Random", "default_rng", "RandomState") and node.args:
                return  # seeded stream construction
            self.out.append(v("determinism/random", node,
                              f"{dotted}() draws process-global entropy; use a "
                              "seeding.seeded_rng stream or inject the rng"))

    def visit_For(self, node: ast.For):
        if _is_set_expr(node.iter):
            self.out.append(self.mod.violation(
                "determinism/iter-order", node,
                "iterating a set: order is PYTHONHASHSEED-dependent; sort first"))
        self.generic_visit(node)

    def visit_comprehension_iter(self, node):  # helper, not a visitor hook
        pass

    def _check_comp(self, node):
        for gen in node.generators:
            if _is_set_expr(gen.iter):
                self.out.append(self.mod.violation(
                    "determinism/iter-order", node,
                    "comprehension over a set: order is PYTHONHASHSEED-"
                    "dependent; sort first"))
        self.generic_visit(node)

    def visit_ListComp(self, node):
        self._check_comp(node)

    def visit_GeneratorExp(self, node):
        self._check_comp(node)

    def visit_DictComp(self, node):
        self._check_comp(node)


def check(modules: List[Module]) -> List[Violation]:
    out: List[Violation] = []
    for mod in modules:
        if mod.rel in EXEMPT_MODULES:
            continue
        # collect sorted-arg subtrees FIRST (the sorted() wrapper may be
        # visited after the listing call it exempts): every node under a
        # sorted() first argument is order-erased
        scan = _Scan(mod)
        for n in ast.walk(mod.tree):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id == "sorted" and n.args):
                for sub in ast.walk(n.args[0]):
                    scan.sorted_args.add(id(sub))
        scan.visit(mod.tree)
        out.extend(scan.out)
    return out
