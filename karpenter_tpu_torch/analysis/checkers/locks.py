"""Lock-discipline checker: the static acquisition graph, cycle-checked.

Copy of karpenter_tpu/analysis/checkers/locks.py over the port's classes
(the solver's dispatch lock, the warm-up ladder's locks, the library
store's, the sidecar's, the operator's).

Every ``threading.Lock``/``RLock`` in the package is discovered at its
allocation site (``self._lock = threading.Lock()`` in a class, or a
module-level ``NAME = threading.Lock()``), then every function is walked
with a stack of statically-held locks: a ``with`` on lock B inside a
``with`` on lock A records the edge A->B, and a CALL made while holding
A records A->L for every lock L in the callee's transitive footprint
(callees resolved conservatively: ``self.method`` through the
same-module class hierarchy, module functions, and package-module
imports -- an unresolvable receiver contributes no edges).

The result is an over-approximate "possible edges" graph: if the static
pass finds no cycle, no interleaving of these lock sites can deadlock
through lock ordering. The runtime witness (analysis/witness.py) checks
the same property against ACTUAL acquisition orders, covering the
dynamic edges (callbacks, injected functions) this pass cannot resolve.

Rules:

- ``locks/order-cycle``   -- a cycle in the acquisition graph: two code
  paths that can take the same locks in opposite orders.
- ``locks/self-deadlock`` -- a non-reentrant ``threading.Lock`` whose
  holder can reach another acquisition of the SAME lock (an RLock
  self-edge is reentrancy and allowed).
- ``locks/mixed-guard``   -- an attribute of a lock-holding class
  written both under and outside its class's lock in non-constructor
  methods: either the lock is not needed or the unlocked write is a
  race (a scrape-vs-observe bug once, as a lint rule). A PRIVATE
  method whose every intra-class call site holds the lock counts as
  lock-held ("caller holds the lock" helpers, computed to fixed point).

``lock_graph(modules)`` exposes the graph (locks keyed by allocation
site) for the witness's static-correlation tag and the test suite's
cycle-free certification.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.analysis.base import Module, Violation
from karpenter_tpu_torch.analysis.base import dotted as _dotted

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
_INIT_METHODS = {"__init__", "__post_init__", "__new__", "__del__"}


@dataclass(frozen=True)
class LockDef:
    lock_id: str   # "module.Class.attr" or "module.NAME"
    kind: str      # "Lock" | "RLock" | "Condition"
    path: str      # repo-relative allocation file
    line: int      # allocation line

    @property
    def site(self) -> str:
        return f"{self.path}:{self.line}"


@dataclass
class Edge:
    src: str
    dst: str
    path: str
    line: int
    why: str


@dataclass
class _Class:
    name: str
    bases: List[str]
    lock_attrs: Dict[str, LockDef] = field(default_factory=dict)
    methods: Dict[str, ast.AST] = field(default_factory=dict)


@dataclass
class _ModInfo:
    mod: Module
    modname: str
    imports: Dict[str, str] = field(default_factory=dict)       # local name -> module
    from_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)  # name -> (module, orig)
    classes: Dict[str, _Class] = field(default_factory=dict)
    functions: Dict[str, ast.AST] = field(default_factory=dict)
    module_locks: Dict[str, LockDef] = field(default_factory=dict)


@dataclass
class LockGraph:
    locks: Dict[str, LockDef] = field(default_factory=dict)
    edges: List[Edge] = field(default_factory=list)

    def edge_set(self) -> Set[Tuple[str, str]]:
        return {(e.src, e.dst) for e in self.edges}

    def cycles(self) -> List[List[str]]:
        """Elementary cycles via SCC decomposition (iterative Tarjan --
        the graph is tiny, but recursion limits are not our bug to hit).
        Returns each non-trivial SCC as a sorted lock-id list; a
        self-edge is returned as a single-element cycle."""
        adj: Dict[str, Set[str]] = {}
        for e in self.edges:
            adj.setdefault(e.src, set()).add(e.dst)
            adj.setdefault(e.dst, set())
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]
        for root in sorted(adj):
            if root in index:
                continue
            work = [(root, iter(sorted(adj[root])))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for nxt in it:
                    if nxt not in index:
                        index[nxt] = low[nxt] = counter[0]
                        counter[0] += 1
                        stack.append(nxt)
                        on_stack.add(nxt)
                        work.append((nxt, iter(sorted(adj[nxt]))))
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        sccs.append(sorted(comp))
        # a self-edge on an RLock/Condition is reentrancy, not deadlock:
        # only non-reentrant Lock self-loops are cycles
        self_loops = sorted({
            e.src for e in self.edges
            if e.src == e.dst
            and (e.src not in self.locks or self.locks[e.src].kind == "Lock")
        })
        return sccs + [[s] for s in self_loops]


def _modname(rel: str) -> str:
    name = rel[:-3] if rel.endswith(".py") else rel
    name = name.replace("/", ".")
    for prefix in ("karpenter_tpu_torch.",):
        if name.startswith(prefix):
            name = name[len(prefix):]
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def _collect(mod: Module) -> _ModInfo:
    info = _ModInfo(mod=mod, modname=_modname(mod.rel))
    tree = mod.tree
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                info.imports[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                info.from_imports[a.asname or a.name] = (node.module, a.name)

    def lock_kind(call: ast.AST) -> Optional[str]:
        if not isinstance(call, ast.Call):
            return None
        d = _dotted(call.func)
        if d is None:
            return None
        parts = d.split(".")
        if len(parts) == 2 and parts[1] in _LOCK_FACTORIES:
            if info.imports.get(parts[0], "") == "threading":
                return parts[1]
        if len(parts) == 1 and parts[0] in _LOCK_FACTORIES:
            src = info.from_imports.get(parts[0])
            if src and src[0] == "threading":
                return src[1]
        return None

    # module-level locks
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            kind = lock_kind(node.value)
            if kind:
                name = node.targets[0].id
                info.module_locks[name] = LockDef(
                    f"{info.modname}.{name}", kind, mod.rel, node.lineno)

    # classes: bases, methods, self.<attr> = threading.Lock() anywhere in a method
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        cls = _Class(name=node.name,
                     bases=[b.id for b in node.bases if isinstance(b, ast.Name)])
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls.methods[item.name] = item
                for sub in ast.walk(item):
                    if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                        t = sub.targets[0]
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            kind = lock_kind(sub.value)
                            if kind:
                                cls.lock_attrs[t.attr] = LockDef(
                                    f"{info.modname}.{node.name}.{t.attr}",
                                    kind, mod.rel, sub.lineno)
        info.classes[node.name] = cls
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.functions[node.name] = node
    return info


class _Analyzer:
    """Cross-module resolution + edge extraction."""

    def __init__(self, modules: List[Module]):
        self.infos: Dict[str, _ModInfo] = {}
        for m in modules:
            info = _collect(m)
            self.infos[info.modname] = info
        # (modname, class) -> resolved lock attrs incl. same-module bases
        self._hier_cache: Dict[Tuple[str, str], Dict[str, LockDef]] = {}
        # function key -> transitive lock footprint
        self._footprints: Dict[Tuple[str, str, str], Set[str]] = {}

    # -- resolution -----------------------------------------------------------
    def class_locks(self, modname: str, clsname: str) -> Dict[str, LockDef]:
        key = (modname, clsname)
        if key in self._hier_cache:
            return self._hier_cache[key]
        self._hier_cache[key] = {}  # cycle guard
        info = self.infos.get(modname)
        out: Dict[str, LockDef] = {}
        if info and clsname in info.classes:
            cls = info.classes[clsname]
            for base in cls.bases:
                base_mod = modname
                if base in info.from_imports:
                    src_mod = _strip_pkg(info.from_imports[base][0])
                    base = info.from_imports[base][1]
                    base_mod = src_mod
                out.update(self.class_locks(base_mod, base))
            out.update(cls.lock_attrs)
        self._hier_cache[key] = out
        return out

    def resolve_lock(self, info: _ModInfo, clsname: Optional[str],
                     expr: ast.AST) -> Optional[LockDef]:
        """A lock-typed expression at an acquisition point -> LockDef."""
        if isinstance(expr, ast.Name):
            if expr.id in info.module_locks:
                return info.module_locks[expr.id]
            src = info.from_imports.get(expr.id)
            if src:
                other = self.infos.get(_strip_pkg(src[0]))
                if other and src[1] in other.module_locks:
                    return other.module_locks[src[1]]
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            if expr.value.id == "self" and clsname:
                return self.class_locks(info.modname, clsname).get(expr.attr)
            mod = info.imports.get(expr.value.id)
            if mod:
                other = self.infos.get(_strip_pkg(mod))
                if other:
                    return other.module_locks.get(expr.attr)
        return None

    def resolve_callee(self, info: _ModInfo, clsname: Optional[str],
                       call: ast.Call) -> Optional[Tuple[str, Optional[str], str]]:
        """A call site -> (modname, classname|None, funcname) when the
        target is confidently a package function/method; None otherwise."""
        f = call.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id == "self" and clsname:
                owner = self._find_method_owner(info.modname, clsname, f.attr)
                if owner:
                    return owner
                return None
            mod = info.imports.get(f.value.id)
            if mod:
                target = _strip_pkg(mod)
                if target in self.infos and f.attr in self.infos[target].functions:
                    return (target, None, f.attr)
            return None
        if isinstance(f, ast.Name):
            if f.id in info.functions:
                return (info.modname, None, f.id)
            src = info.from_imports.get(f.id)
            if src:
                target = _strip_pkg(src[0])
                if target in self.infos and src[1] in self.infos[target].functions:
                    return (target, None, src[1])
        return None

    def _find_method_owner(self, modname: str, clsname: str, meth: str,
                           _seen: Optional[Set] = None
                           ) -> Optional[Tuple[str, Optional[str], str]]:
        _seen = _seen if _seen is not None else set()
        if (modname, clsname) in _seen:
            return None
        _seen.add((modname, clsname))
        info = self.infos.get(modname)
        if not info or clsname not in info.classes:
            return None
        cls = info.classes[clsname]
        if meth in cls.methods:
            return (modname, clsname, meth)
        for base in cls.bases:
            base_mod = modname
            if base in info.from_imports:
                base_mod = _strip_pkg(info.from_imports[base][0])
                base = info.from_imports[base][1]
            hit = self._find_method_owner(base_mod, base, meth, _seen)
            if hit:
                return hit
        return None

    # -- footprints (fixed point over the resolvable call graph) --------------
    def footprint(self, modname: str, clsname: Optional[str],
                  fname: str) -> Set[str]:
        out, _ = self._footprint(modname, clsname, fname, set())
        return out

    def _footprint(self, modname: str, clsname: Optional[str], fname: str,
                   stack: Set) -> Tuple[Set[str], bool]:
        """Returns (locks, complete). The root call's result is always
        complete (a recursive re-entry only truncates locks the in-stack
        frames accumulate themselves), but an INNER cycle member's is
        not -- caching it would permanently drop the cycle's other locks
        from every later caller's edges, so only complete results memoize."""
        key = (modname, clsname or "", fname)
        if key in self._footprints:
            return self._footprints[key], True
        if key in stack:
            return set(), False
        stack.add(key)
        info = self.infos.get(modname)
        fn = None
        if info:
            if clsname and clsname in info.classes:
                fn = info.classes[clsname].methods.get(fname)
            else:
                fn = info.functions.get(fname)
        out: Set[str] = set()
        complete = True
        if fn is not None:
            for node in ast.walk(fn):
                if isinstance(node, ast.With):
                    for item in node.items:
                        ld = self.resolve_lock(info, clsname, item.context_expr)
                        if ld:
                            out.add(ld.lock_id)
                elif isinstance(node, ast.Call):
                    d = _dotted(node.func)
                    if d and d.endswith(".acquire"):
                        ld = self.resolve_lock(info, clsname, node.func.value)
                        if ld:
                            out.add(ld.lock_id)
                    callee = self.resolve_callee(info, clsname, node)
                    if callee:
                        sub, ok = self._footprint(callee[0], callee[1],
                                                  callee[2], stack)
                        out |= sub
                        complete = complete and ok
        stack.discard(key)
        if complete:
            self._footprints[key] = out
        return out, complete

    # -- edges ----------------------------------------------------------------
    def build_graph(self) -> LockGraph:
        g = LockGraph()
        for info in self.infos.values():
            for ld in info.module_locks.values():
                g.locks[ld.lock_id] = ld
            for cls in info.classes.values():
                for ld in cls.lock_attrs.values():
                    g.locks[ld.lock_id] = ld
        seen: Set[Tuple[str, str, str, int]] = set()

        def emit(src: str, dst: str, path: str, line: int, why: str):
            key = (src, dst, path, line)
            if key not in seen:
                seen.add(key)
                g.edges.append(Edge(src, dst, path, line, why))

        def expr_lock_op(info: _ModInfo, clsname: Optional[str],
                         stmt: ast.AST, op: str) -> Optional[LockDef]:
            """A bare `LOCK.acquire()` / `LOCK.release()` statement on a
            resolvable lock; try-acquires (blocking=False / a timeout) are
            the sanctioned out-of-order pattern and resolve to None."""
            if not (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Call)
                    and isinstance(stmt.value.func, ast.Attribute)
                    and stmt.value.func.attr == op):
                return None
            call = stmt.value
            if op == "acquire" and (call.keywords or call.args):
                return None
            return self.resolve_lock(info, clsname, call.func.value)

        def walk_block(info: _ModInfo, clsname: Optional[str],
                       stmts: List[ast.AST], held: List[LockDef]):
            """One statement list: explicit `X.acquire()` holds X until the
            matching `X.release()` (wherever it nests -- acquire-before-try
            / release-in-finally pops from the shared held list) or, as the
            over-approximation, the end of this block."""
            acquired: List[LockDef] = []
            for stmt in stmts:
                ld = expr_lock_op(info, clsname, stmt, "acquire")
                if ld is not None:
                    for h in held:
                        emit(h.lock_id, ld.lock_id, info.mod.rel,
                             stmt.lineno, "explicit acquire")
                    held.append(ld)
                    acquired.append(ld)
                    continue
                ld = expr_lock_op(info, clsname, stmt, "release")
                if ld is not None:
                    for i in range(len(held) - 1, -1, -1):
                        if held[i].lock_id == ld.lock_id:
                            del held[i]
                            break
                    continue
                walk(info, clsname, stmt, held)
            for ld in acquired:
                for i in range(len(held) - 1, -1, -1):
                    if held[i] is ld:
                        del held[i]
                        break

        def walk(info: _ModInfo, clsname: Optional[str], node: ast.AST,
                 held: List[LockDef]):
            if isinstance(node, ast.With):
                acquired = []
                for item in node.items:
                    ld = self.resolve_lock(info, clsname, item.context_expr)
                    if ld:
                        for h in held:
                            emit(h.lock_id, ld.lock_id, info.mod.rel,
                                 node.lineno, "nested with")
                        acquired.append(ld)
                held.extend(acquired)
                walk_block(info, clsname, node.body, held)
                for _ in acquired:
                    held.pop()
                return
            if isinstance(node, ast.Call) and held:
                callee = self.resolve_callee(info, clsname, node)
                if callee:
                    for lock_id in self.footprint(*callee):
                        for h in held:
                            emit(h.lock_id, lock_id, info.mod.rel,
                                 getattr(node, "lineno", 0),
                                 f"call {callee[2]}() while holding")
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and held:
                # a def inside a with-block does not RUN under the lock
                return
            for name, value in ast.iter_fields(node):
                if (isinstance(value, list) and value
                        and all(isinstance(v, ast.stmt) for v in value)):
                    walk_block(info, clsname, value, held)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.AST):
                            walk(info, clsname, v, held)
                elif isinstance(value, ast.AST):
                    walk(info, clsname, value, held)

        for info in self.infos.values():
            for fn in info.functions.values():
                walk(info, None, fn, [])
            for cls in info.classes.values():
                for meth in cls.methods.values():
                    walk(info, cls.name, meth, [])
        return g


def _strip_pkg(module: str) -> str:
    if module.startswith("karpenter_tpu_torch."):
        return module[len("karpenter_tpu_torch."):]
    return module


def lock_graph(modules: List[Module]) -> LockGraph:
    return _Analyzer(modules).build_graph()


# -- mixed-guard writes -------------------------------------------------------


def _mixed_guard(analyzer: _Analyzer) -> List[Violation]:
    out: List[Violation] = []
    for info in analyzer.infos.values():
        for cls in info.classes.values():
            own_locks = analyzer.class_locks(info.modname, cls.name)
            if not own_locks:
                continue
            own_ids = {ld.lock_id for ld in own_locks.values()}
            lock_attr_names = set(own_locks.keys())

            # "caller holds the lock" helpers: a PRIVATE method whose
            # every intra-class call site runs under the class lock is
            # treated as lock-held for the write scan (SolverClient._conn
            # and the degrade-ladder bookkeeping are this shape). Fixed
            # point so a helper called only from another such helper
            # qualifies too; public methods never do -- external callers
            # are invisible to a static pass.
            calls: List[Tuple[str, str, bool]] = []  # (caller, callee, under)

            def collect_calls(node: ast.AST, under: bool, caller: str):
                if isinstance(node, ast.With):
                    holds = any(
                        (ld := analyzer.resolve_lock(info, cls.name,
                                                     item.context_expr))
                        and ld.lock_id in own_ids
                        for item in node.items)
                    for child in ast.iter_child_nodes(node):
                        collect_calls(child, under or holds, caller)
                    return
                if isinstance(node, ast.Call):
                    f = node.func
                    if (isinstance(f, ast.Attribute)
                            and isinstance(f.value, ast.Name)
                            and f.value.id == "self"):
                        calls.append((caller, f.attr, under))
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    return
                for child in ast.iter_child_nodes(node):
                    collect_calls(child, under, caller)

            for name, meth in cls.methods.items():
                for child in ast.iter_child_nodes(meth):
                    collect_calls(child, False, name)

            always_locked: Set[str] = set()
            candidates = {name for name in cls.methods
                          if name.startswith("_") and not name.startswith("__")
                          and any(c[1] == name for c in calls)}
            while True:
                nxt = {m for m in candidates
                       if all(under or caller in always_locked
                              for caller, callee, under in calls
                              if callee == m)}
                if nxt == always_locked:
                    break
                always_locked = nxt

            locked_writes: Dict[str, int] = {}
            unlocked_writes: Dict[str, int] = {}

            def record(node: ast.AST, under: bool):
                targets: List[ast.AST] = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                flat: List[ast.AST] = []
                for t in targets:
                    # `self.a, self.b = ...` writes both attributes
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    for el in elts:
                        flat.append(el.value if isinstance(el, ast.Starred)
                                    else el)
                for t in flat:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                            and t.attr not in lock_attr_names):
                        book = locked_writes if under else unlocked_writes
                        book.setdefault(t.attr, node.lineno)

            def scan(node: ast.AST, under: bool):
                if isinstance(node, ast.With):
                    holds = any(
                        (ld := analyzer.resolve_lock(info, cls.name,
                                                     item.context_expr))
                        and ld.lock_id in own_ids
                        for item in node.items)
                    for child in node.body:
                        scan(child, under or holds)
                    return
                record(node, under)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    return
                for child in ast.iter_child_nodes(node):
                    scan(child, under)

            for name, meth in cls.methods.items():
                if name in _INIT_METHODS:
                    continue
                # enter at the method's CHILDREN: the nested-def guard in
                # scan() must stop inner defs, not the method itself
                for child in ast.iter_child_nodes(meth):
                    scan(child, name in always_locked)
            for attr in sorted(set(locked_writes) & set(unlocked_writes)):
                line = unlocked_writes[attr]
                out.append(info.mod.violation(
                    "locks/mixed-guard", line,
                    f"{cls.name}.{attr} is written under {sorted(own_ids)[0]} "
                    f"elsewhere (line {locked_writes[attr]}) but without it "
                    "here: either the lock is unnecessary or this write races"))
    return out


def check(modules: List[Module]) -> List[Violation]:
    analyzer = _Analyzer(modules)
    graph = analyzer.build_graph()
    out: List[Violation] = []
    edge_by_pair = {}
    for e in graph.edges:
        edge_by_pair.setdefault((e.src, e.dst), e)
    for cyc in graph.cycles():
        if len(cyc) == 1:
            lock = graph.locks.get(cyc[0])
            if lock is not None and lock.kind != "Lock":
                continue  # RLock/Condition self-edge = reentrancy
            e = edge_by_pair.get((cyc[0], cyc[0]))
            mod_stub = Violation(
                rule="locks/self-deadlock",
                path=e.path if e else (lock.path if lock else "?"),
                line=e.line if e else (lock.line if lock else 0),
                message=f"non-reentrant {cyc[0]} can be re-acquired by its "
                        f"own holder ({e.why if e else 'static edge'})",
                line_text="")
            out.append(mod_stub)
            continue
        # anchor the cycle report on its lexically-first edge
        anchors = [edge_by_pair.get((a, b))
                   for a, b in zip(cyc, cyc[1:] + cyc[:1])]
        anchors = [a for a in anchors if a is not None]
        anchor = min(anchors, key=lambda e: (e.path, e.line)) if anchors else None
        out.append(Violation(
            rule="locks/order-cycle",
            path=anchor.path if anchor else "?",
            line=anchor.line if anchor else 0,
            message="lock-order cycle: " + " -> ".join(cyc + [cyc[0]]),
            line_text=""))
    out.extend(_mixed_guard(analyzer))
    # line_text for baseline matching (cycle/self-deadlock stubs built
    # without module context above)
    by_rel = {m.rel: m for m in modules}
    fixed = []
    for v in out:
        if not v.line_text and v.path in by_rel:
            fixed.append(Violation(v.rule, v.path, v.line, v.message,
                                   by_rel[v.path].line_text(v.line)))
        else:
            fixed.append(v)
    return fixed
