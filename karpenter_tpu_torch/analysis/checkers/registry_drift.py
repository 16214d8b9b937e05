"""Registry-drift checker: every registered name appears in its doc table.

Copy of karpenter_tpu/analysis/checkers/registry_drift.py over the port.
The port registers the JAX package's metric families, failpoint sites and
RPC feature flags under the JAX names, so it is held against the JAX
package's docs: docs/metrics.md, docs/operations.md and docs/*.md, READ
ONLY -- nothing here renders or writes a file (the JAX package's
hack/metrics_gen.py --check does that for its own registry). Statically,
with no imports, so it runs in a bare container:

- ``registry/metric-undocumented``    -- every metric family registered
  via ``REGISTRY.counter/gauge/histogram("karpenter_...")`` must appear
  in docs/metrics.md.
- ``registry/metric-unported``        -- every family docs/metrics.md
  documents is registered by the port (its modules or its witnesses), or
  is in ``OMITTED_FAMILIES`` with the reason it is left out; an omitted
  family the port registers after all is flagged too.
- ``registry/failpoint-undocumented`` -- every failpoint site evaluated
  in code (``failpoints.eval/corrupt/live("site")``) must appear in the
  site table in docs/operations.md.
- ``registry/feature-undocumented``   -- every RPC feature flag the
  server advertises (the ``features`` list in solver/rpc.py, plus
  conditional ``features.append``) must appear somewhere under docs/.
- ``registry/seam-unfailpointed``     -- every ``LADDER_SEAMS`` entry
  (checkers/errflow.py) must name a failpoint site that actually exists
  as a ``failpoints.eval/corrupt/live`` call in the package.
- ``registry/jit-entry-unregistered`` / ``registry/jit-entry-stale`` --
  obs/jitstats.py's hand-kept ``JIT_ENTRY_FUNCTIONS`` equals the device
  entries that really dispatch (``jit_entries_dispatched``): the kernel
  wrappers (each books its launch), the entries the warm-up ladder
  captures (``aot.try_call``'s seams must each name one of them), and the
  statics-taking entries the dispatch layer (service, sidecar, sweep
  engine, ladder) calls through their module attribute -- which is how
  jitstats' probes see them. A registered entry found by none of these is
  stale.

Metric and failpoint names match backtick-exact (`` `name` ``) against
their doc tables -- a plain substring test would let a name that merely
prefixes a documented one pass. Feature flags match as substrings across
docs/ (they appear in prose, not a canonical table).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.analysis.base import (PACKAGE_ROOT, REPO_ROOT, Module,
                                               Violation)
from karpenter_tpu_torch.analysis.base import dotted as _dotted

METRICS_DOC = "docs/metrics.md"
FAILPOINTS_DOC = "docs/operations.md"
_REGISTER_METHODS = {"counter", "gauge", "histogram"}
_SITE_FUNCS = {"eval", "corrupt", "live", "hits", "fires"}

# documented families the port leaves out on purpose, by name prefix ->
# why. Everything else docs/metrics.md lists, the port registers.
OMITTED_FAMILIES: Dict[str, str] = {
    "karpenter_tenant_":
        "the fleet coalescer's per-tenant families come with fleet/coalesce.py "
        "and SolverServer(coalescer=) (ROADMAP A11a)",
    "karpenter_mesh_":
        "the sharded engine's topology families come with parallel/mesh.py "
        "and fleet/shard.py (ROADMAP A11b)",
    "karpenter_solver_kernel_fallbacks_total":
        "the port never falls back: a wrapper given a CUDA tensor launches "
        "its kernel or raises, so there is no Pallas -> XLA pin to count "
        "(ROADMAP section C)",
}

# the witnesses register their families lazily, from the analysis
# package iter_modules() leaves out as tooling
WITNESS_MODULES = ("witness.py", "errwitness.py", "torch_witness.py")

JITSTATS_REL = "karpenter_tpu_torch/obs/jitstats.py"
# the dispatch layer: where a tick, a sidecar op, a sweep or the ladder
# calls a device entry through its module attribute
DISPATCH_LAYER = (
    "karpenter_tpu_torch/solver/service.py",
    "karpenter_tpu_torch/solver/rpc.py",
    "karpenter_tpu_torch/solver/disrupt/engine.py",
    "karpenter_tpu_torch/solver/aot.py",
)
KERNELS_PREFIX = "karpenter_tpu_torch/solver/kernels/"


def _doc_text(rel: str) -> str:
    p = REPO_ROOT / rel
    return p.read_text() if p.exists() else ""


def _collect_metric_families(modules: List[Module]) -> List[Tuple[Module, ast.Call, str]]:
    out = []
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr not in _REGISTER_METHODS or not node.args:
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str) \
                    and first.value.startswith("karpenter_"):
                out.append((mod, node, first.value))
    return out


def _collect_failpoint_sites(modules: List[Module]) -> List[Tuple[Module, ast.Call, str]]:
    out = []
    for mod in modules:
        if mod.rel == "karpenter_tpu_torch/failpoints.py":
            continue  # the framework's own docstring examples
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            is_site_call = (
                isinstance(f, ast.Attribute)
                and f.attr in _SITE_FUNCS
                and isinstance(f.value, ast.Name)
                and f.value.id in ("failpoints", "FAILPOINTS")
            )
            if not is_site_call:
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                out.append((mod, node, first.value))
    return out


def _collect_feature_flags(modules: List[Module]) -> List[Tuple[Module, ast.AST, str]]:
    out = []
    for mod in modules:
        if mod.rel != "karpenter_tpu_torch/solver/rpc.py":
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "features" \
                    and isinstance(node.value, (ast.List, ast.Tuple)):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                        out.append((mod, elt, elt.value))
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "append" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "features" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    out.append((mod, arg, arg.value))
    return out


def _witness_families() -> List[str]:
    """Families the runtime witnesses register (lazily) in the port's
    registry: parsed from the analysis package's witness modules."""
    out: List[str] = []
    for name in WITNESS_MODULES:
        path = PACKAGE_ROOT / "analysis" / name
        if not path.exists():
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REGISTER_METHODS and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append(node.args[0].value)
    return out


def _omitted(name: str) -> Optional[str]:
    for prefix, why in OMITTED_FAMILIES.items():
        if name.startswith(prefix):
            return why
    return None


def _dotted_module(rel: str) -> str:
    name = rel[:-3] if rel.endswith(".py") else rel
    name = name.replace("/", ".")
    return name[: -len(".__init__")] if name.endswith(".__init__") else name


def _str_args(call: ast.Call) -> List[Optional[str]]:
    return [a.value if isinstance(a, ast.Constant) and isinstance(a.value, str) else None
            for a in call.args]


def jit_entry_registry(modules: List[Module]) -> Optional[Set[Tuple[str, str]]]:
    """(module, function) pairs of obs/jitstats.py's JIT_ENTRY_FUNCTIONS,
    read from its AST; None when the module is not in the scan."""
    mod = next((m for m in modules if m.rel == JITSTATS_REL), None)
    if mod is None:
        return None
    out: Set[Tuple[str, str]] = set()
    for node in mod.tree.body:
        target = node.target if isinstance(node, ast.AnnAssign) else (
            node.targets[0] if isinstance(node, ast.Assign) and len(node.targets) == 1 else None)
        if not (isinstance(target, ast.Name) and target.id == "JIT_ENTRY_FUNCTIONS"
                and isinstance(node.value, ast.Dict)):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            if isinstance(k, ast.Constant) and isinstance(v, (ast.Tuple, ast.List)):
                for e in v.elts:
                    if isinstance(e, ast.Constant) and isinstance(e.value, str):
                        out.add((k.value, e.value))
    return out


def _module_aliases(mod: Module) -> Dict[str, str]:
    """local name -> dotted module, for `import a.b as x` and `from a import b`."""
    out: Dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def jit_entries_dispatched(modules: List[Module]) -> Dict[Tuple[str, str], str]:
    """The device entries that really dispatch, (module, function) -> how
    it was found (see the module docstring). An ``aot.try_call`` seam whose
    entry name resolves to none of them maps ("", name) -> "try_call seam"."""
    from karpenter_tpu_torch.analysis.checkers.torch_discipline import (captured_entries,
                                                                        kernel_entries)
    from karpenter_tpu_torch.analysis.sync_witness import SANCTIONED_FETCH

    by_name = {_dotted_module(m.rel): m for m in modules}
    found: Dict[Tuple[str, str], str] = {
        (_dotted_module(rel), name): "kernel wrapper" for rel, name in kernel_entries(modules)}
    for rel, name in captured_entries(modules):
        found[(_dotted_module(rel), name)] = "warm-up ladder"
    seams: Set[str] = set()
    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and (_dotted(node.func) or "").endswith(".try_call"):
                args = _str_args(node)
                if args and args[0]:
                    seams.add(args[0])
    # the dispatch layer's calls through a device module's attribute
    registry_mods = {m for m, _ in (jit_entry_registry(modules) or set())}
    registry_mods |= {m for m, _ in found}
    for rel in DISPATCH_LAYER:
        mod = next((m for m in modules if m.rel == rel), None)
        if mod is None:
            continue
        aliases = _module_aliases(mod)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)):
                continue
            target = aliases.get(node.func.value.id)
            callee = by_name.get(target or "")
            if target not in registry_mods or callee is None:
                continue
            fn = next((f for f in callee.tree.body if isinstance(f, ast.FunctionDef)
                       and f.name == node.func.attr), None)
            if fn is None or fn.name.startswith("_") or not fn.args.kwonlyargs:
                continue
            if (callee.rel, fn.name) in SANCTIONED_FETCH:
                continue    # a host barrier returns host data: not an entry
            # a stage another function of its module calls is booked on
            # the entry that runs it
            if any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                   and n.func.id == fn.name for n in ast.walk(callee.tree)):
                continue
            found.setdefault((target, fn.name), "dispatch layer")
    names = {name for _, name in found}
    for name in sorted(seams - names):
        found[("", name)] = "try_call seam"
    return found

def check(modules: List[Module]) -> List[Violation]:
    out: List[Violation] = []
    metrics_doc = _doc_text(METRICS_DOC)
    ops_doc = _doc_text(FAILPOINTS_DOC)
    docs_all = "\n".join(
        p.read_text() for p in sorted((REPO_ROOT / "docs").glob("*.md")))

    seen: Set[Tuple[str, str]] = set()
    for mod, node, name in _collect_metric_families(modules):
        if ("metric", name) in seen:
            continue
        seen.add(("metric", name))
        # backtick-exact, like the failpoint check below: a plain substring
        # test would let a name that PREFIXES a documented family pass
        # (e.g. karpenter_journal_writes inside karpenter_journal_writes_total)
        if f"`{name}`" not in metrics_doc:
            out.append(mod.violation(
                "registry/metric-undocumented", node,
                f"metric family {name} is not in {METRICS_DOC}: the port "
                "registers the JAX package's families under their names, so a "
                "family new to both is documented there first"))
    for mod, node, site in _collect_failpoint_sites(modules):
        if ("site", site) in seen:
            continue
        seen.add(("site", site))
        if f"`{site}`" not in ops_doc:
            out.append(mod.violation(
                "registry/failpoint-undocumented", node,
                f"failpoint site {site} is not in the site table in "
                f"{FAILPOINTS_DOC}"))
    for mod, node, flag in _collect_feature_flags(modules):
        if ("feature", flag) in seen:
            continue
        seen.add(("feature", flag))
        if flag not in docs_all:
            out.append(mod.violation(
                "registry/feature-undocumented", node,
                f"RPC feature flag {flag!r} is advertised by the server but "
                "documented nowhere under docs/"))

    # every degrade-ladder seam must have a live chaos drill: the
    # failpoint site its LADDER_SEAMS entry names has to exist in code
    from karpenter_tpu_torch.analysis.checkers.errflow import LADDER_SEAMS

    code_sites = {site for _, _, site in _collect_failpoint_sites(modules)}
    by_rel = {m.rel: m for m in modules}
    for seam in LADDER_SEAMS:
        mod = by_rel.get(seam.rel)
        if mod is None:
            continue  # fixture runs carry partial trees
        if not seam.failpoint:
            out.append(mod.violation(
                "registry/seam-unfailpointed", 1,
                f"LADDER_SEAMS entry {seam.key} declares no failpoint "
                "site: a degrade seam needs a chaos drill"))
        elif seam.failpoint not in code_sites:
            out.append(mod.violation(
                "registry/seam-unfailpointed", 1,
                f"LADDER_SEAMS entry {seam.key} names failpoint site "
                f"{seam.failpoint!r}, but no failpoints.eval/corrupt/live "
                "call evaluates that site anywhere in the package"))

    # every documented family is the port's, or omitted with a reason
    registered = {name for _, _, name in _collect_metric_families(modules)}
    if any(m.rel.startswith("karpenter_tpu_torch/metrics") for m in modules):
        registered.update(_witness_families())
        anchor = next(m for m in modules if m.rel.startswith("karpenter_tpu_torch/metrics"))
        import re

        for name in sorted(set(re.findall(r"`(karpenter_[a-z0-9_]+)`", metrics_doc))):
            why = _omitted(name)
            if name not in registered and why is None:
                out.append(anchor.violation(
                    "registry/metric-unported", 1,
                    f"docs/metrics.md documents {name}, which the port neither "
                    "registers nor lists in OMITTED_FAMILIES with a reason"))
            elif name in registered and why is not None:
                out.append(anchor.violation(
                    "registry/metric-unported", 1,
                    f"{name} is in OMITTED_FAMILIES ({why}) but the port "
                    "registers it: drop the omission"))

    # JIT_ENTRY_FUNCTIONS == the entries that really dispatch
    registry = jit_entry_registry(modules)
    if registry is not None:
        jmod = next(m for m in modules if m.rel == JITSTATS_REL)
        line = next((i for i, text in enumerate(jmod.lines, 1)
                     if text.startswith("JIT_ENTRY_FUNCTIONS")), 1)
        dispatched = jit_entries_dispatched(modules)
        by_name = {_dotted_module(m.rel): m for m in modules}
        for key in sorted(set(dispatched) - registry):
            what = (f"{key[0]}.{key[1]} dispatches ({dispatched[key]}) but is not in "
                    "JIT_ENTRY_FUNCTIONS: jitstats would never book it") if key[0] else (
                f"aot.try_call seam {key[1]!r} names no entry the ladder captures")
            out.append(jmod.violation("registry/jit-entry-unregistered", line, what))
        for key in sorted(registry - set(dispatched)):
            mod = by_name.get(key[0])
            exists = mod is not None and any(
                isinstance(f, ast.FunctionDef) and f.name == key[1] for f in mod.tree.body)
            out.append(jmod.violation(
                "registry/jit-entry-stale", line,
                f"JIT_ENTRY_FUNCTIONS names {key[0]}.{key[1]}, which "
                + ("does not exist" if not exists else "nothing dispatches")))
    return out
