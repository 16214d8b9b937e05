"""Checker plumbing: violation model, tree walking, baseline discipline.

Copy of karpenter_tpu/analysis/base.py over the port's tree: the package
root is karpenter_tpu_torch/, and the baseline lives inside the package
(karpenter_tpu_torch/analysis/lint_baseline.json).

Kept dependency-free (stdlib only): the witnesses' import path
(analysis/pytest_plugin.py, chip_smoke.py's witness child) runs BEFORE
torch/numpy are imported, and the CLI must work in a bare container.
Checkers are imported lazily by ``run_suite`` for the same reason.
"""
from __future__ import annotations

import ast
import json
import pathlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
PACKAGE_ROOT = REPO_ROOT / "karpenter_tpu_torch"
BASELINE_PATH = PACKAGE_ROOT / "analysis" / "lint_baseline.json"

# the analysis package itself is tooling, not production code: its rule
# tables mention the very constructs it hunts, and the witness's repr
# strings would trip the determinism scan
EXCLUDE_PARTS = ("analysis", "__pycache__")


@dataclass(frozen=True)
class Violation:
    """One rule firing at one site. ``line_text`` (the stripped source
    line) is part of the baseline match key so a baselined exception
    survives unrelated edits shifting line numbers -- but NOT edits to
    the excepted line itself, which must be re-vetted."""

    rule: str           # e.g. "determinism/uuid4"
    path: str           # repo-relative, forward slashes
    line: int
    message: str
    line_text: str = ""

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.line_text)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Module:
    """One parsed source file handed to every AST checker."""

    path: pathlib.Path
    rel: str
    source: str
    tree: ast.AST
    lines: List[str] = field(default_factory=list)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def violation(self, rule: str, node_or_line, message: str) -> Violation:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Violation(rule=rule, path=self.rel, line=int(line),
                         message=message, line_text=self.line_text(int(line)))


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None (the checkers' shared
    call-site flattener)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_modules(root: Optional[pathlib.Path] = None) -> List[Module]:
    """Parse every production source file under the package root,
    excluding tooling (see EXCLUDE_PARTS). Sorted walk: violation output
    and baseline files are diff-stable across filesystems."""
    root = root or PACKAGE_ROOT
    modules: List[Module] = []
    for path in sorted(root.rglob("*.py")):
        if any(part in EXCLUDE_PARTS for part in path.parts):
            continue
        source = path.read_text()
        try:
            tree = ast.parse(source, filename=str(path))
        except SyntaxError as e:  # pragma: no cover - the tree must parse
            raise SystemExit(f"lint: cannot parse {path}: {e}")
        try:
            rel = str(path.relative_to(REPO_ROOT))
        except ValueError:
            rel = str(path)
        modules.append(Module(path=path, rel=rel.replace("\\", "/"),
                              source=source, tree=tree,
                              lines=source.splitlines()))
    return modules


# -- baseline -----------------------------------------------------------------
#
# analysis/lint_baseline.json is the committed allowlist: the FEW intentional
# exceptions, each vetted and justified. Matching is by (rule, path,
# stripped source line): renumbering-only edits keep an entry valid,
# touching the excepted line invalidates it (forcing a re-vet), and a
# stale entry -- one matching nothing -- fails the run so the baseline
# can only shrink through deliberate edits.


def load_baseline(path: Optional[pathlib.Path] = None) -> List[dict]:
    path = path or BASELINE_PATH
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    entries = data.get("entries", data if isinstance(data, list) else [])
    for e in entries:
        for k in ("rule", "path", "line_text", "justification"):
            if not isinstance(e.get(k), str) or not e[k]:
                raise SystemExit(
                    f"lint: baseline entry {e!r} lacks required field {k!r} "
                    "(every exception carries a justification)")
    return entries


def write_baseline(violations: Sequence[Violation],
                   path: Optional[pathlib.Path] = None,
                   justifications: Optional[Dict[Tuple[str, str, str], str]] = None,
                   keep: Optional[Sequence[dict]] = None) -> None:
    """``keep`` carries prior entries to preserve verbatim -- a partial
    (--rules) rewrite must not drop the other families' vetted exceptions."""
    path = path or BASELINE_PATH
    entries = list(keep or [])
    for v in sorted(violations, key=lambda v: (v.rule, v.path, v.line)):
        just = (justifications or {}).get(v.key(), "TODO: justify or fix")
        entries.append({"rule": v.rule, "path": v.path, "line": v.line,
                        "line_text": v.line_text, "justification": just})
    entries.sort(key=lambda e: (e["rule"], e["path"], e["line"]))
    path.write_text(json.dumps({"entries": entries}, indent=2) + "\n")


def apply_baseline(violations: Sequence[Violation], entries: Sequence[dict]
                   ) -> Tuple[List[Violation], List[dict], List[dict]]:
    """Partition into (unbaselined violations, matched entries, stale
    entries). One baseline entry absorbs every violation with its key --
    a rule firing twice on one unchanged line is one exception."""
    by_key: Dict[Tuple[str, str, str], dict] = {}
    for e in entries:
        by_key[(e["rule"], e["path"], e["line_text"])] = e
    matched: Dict[Tuple[str, str, str], dict] = {}
    fresh: List[Violation] = []
    for v in violations:
        e = by_key.get(v.key())
        if e is not None:
            matched[v.key()] = e
        else:
            fresh.append(v)
    stale = [e for k, e in by_key.items() if k not in matched]
    return fresh, list(matched.values()), stale


# -- suite --------------------------------------------------------------------

CheckerFn = Callable[[List[Module]], List[Violation]]


def checkers() -> Dict[str, CheckerFn]:
    """The rule families, imported lazily (keeps `import
    karpenter_tpu_torch.analysis` feather-light for the witness path).
    The JAX package's ``jaxjit``/``jaxhost`` families become ``torchjit``
    (graph-capture and kernel-entry hazards) and ``torchhost`` (host
    syncs), checkers/torch_discipline.py."""
    from karpenter_tpu_torch.analysis.checkers import (determinism, errflow,
                                                       locks, registry_drift,
                                                       reslife, torch_discipline,
                                                       zerocopy)

    return {
        "determinism": determinism.check,
        "locks": locks.check,
        "zerocopy": zerocopy.check,
        "registry": registry_drift.check,
        "torchjit": torch_discipline.check_retrace,
        "torchhost": torch_discipline.check_hostsync,
        "errflow": errflow.check,
        "reslife": reslife.check,
    }


def run_suite(families: Optional[Iterable[str]] = None,
              root: Optional[pathlib.Path] = None) -> List[Violation]:
    modules = iter_modules(root)
    table = checkers()
    selected = list(families) if families else list(table)
    unknown = [f for f in selected if f not in table]
    if unknown:
        raise SystemExit(f"lint: unknown rule families {unknown}; have {sorted(table)}")
    out: List[Violation] = []
    for fam in selected:
        out.extend(table[fam](modules))
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out
