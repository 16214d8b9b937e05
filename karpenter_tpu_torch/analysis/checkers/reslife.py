"""Resource-lifecycle checker: release on every path, error edges included.

Copy of karpenter_tpu/analysis/checkers/reslife.py. The port adds its own
resources to ``_FACTORIES``: ``ctypes.CDLL`` kernel-library handles
(released with ``_ctypes.dlclose``), ``torch.cuda.CUDAGraph`` (released
with ``reset()``) and graph memory pools (``graph_pool_handle``).

The degrade ladder's crash drills lean on ``shm.cleanup_stale`` to
reclaim segments a dead process left behind -- but a LIVE process that
leaks a socket per reconnect attempt, an fd per failed attach, or an
unjoined thread per breaker trip degrades just as surely, and no chaos
schedule asserts "zero leaked fds". This checker is the static analogue:
every resource ALLOCATION site in the package (sockets, shm
segments/mmaps, raw fds, files, tempfiles, threads) is discovered, and
release is verified on the error edges, not just the fall-through.

Discovery: a call to a known factory (``socket.socket``/
``create_connection``, ``ShmSegment.create/attach``, ``mmap.mmap``,
``os.open``/``os.fdopen``, builtin ``open``, ``tempfile.*``,
``threading.Thread``) assigned to a plain local name. Out-of-scope by
design (ownership moved, not leaked): allocation directly in a ``with``
item, a value returned/yielded, stored into ``self``/a container (the
class lifecycle rule below takes over), passed to another call, or
aliased away. A rebind through a call taking the old value
(``sock = ctx.wrap_socket(sock)``) is the SAME resource continued.

Rules:

- ``reslife/unreleased``     -- a local resource with no release verb
  (``close``/``destroy``/``shutdown``/``join``/``stop``/...) on any
  path and no ownership escape: a leak even on the happy path.
- ``reslife/leak-on-error``  -- a local resource whose release happens
  only in straight-line code: every release site sits outside any
  ``finally``/``except`` body and outside a ``with``, while a call
  between allocation and release can raise past it. The sanctioned
  shapes are exactly the repo's idioms: ``try/finally: x.close()``,
  ``except: x.close(); raise`` (the ``_conn``/``_try_shm``/
  ``_op_shm_open`` shape), or a with-statement.
- ``reslife/unjoined-thread`` -- a local non-daemon ``threading.Thread``
  that is started but never joined and never escapes: interpreter
  shutdown blocks on it, and nothing owns its lifetime.
- ``reslife/self-unreleased`` -- a resource stored into ``self.X``
  where no method of the class ever releases ``self.X``: the instance
  holds an fd/thread no lifecycle method can free (the class-held
  analogue of ``unreleased``; ``cleanup_stale`` cannot reclaim a
  mapping owned by a live process).

Daemon threads (``daemon=True``) are exempt -- dying with the process
is their lifecycle. ``tempfile.mkstemp``/``mkdtemp`` results are
tracked like fds (the unlink/rmtree verbs release them).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.analysis.base import Module, Violation
from karpenter_tpu_torch.analysis.base import dotted as _dotted

# factory dotted-name SUFFIXES -> resource kind (matched against the
# resolved call chain's last two components, so `shm_mod.ShmSegment.attach`
# and `ShmSegment.attach` both land)
_FACTORIES: Dict[str, str] = {
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "ShmSegment.create": "shm-segment",
    "ShmSegment.attach": "shm-segment",
    "mmap.mmap": "mmap",
    "os.open": "fd",
    "os.fdopen": "file",
    "os.pipe": "fd",
    "tempfile.NamedTemporaryFile": "tempfile",
    "tempfile.TemporaryDirectory": "tempfile",
    "tempfile.mkstemp": "tempfile",
    "tempfile.mkdtemp": "tempfile",
    "threading.Thread": "thread",
    # the port's own: kernel libraries, captured graphs and their pools
    "ctypes.CDLL": "cdll",
    "cuda.CUDAGraph": "cuda-graph",
    "cuda.graph_pool_handle": "graph-pool",
}
_BUILTIN_FACTORIES = {"open": "file"}

_RELEASE_VERBS = frozenset({
    "close", "destroy", "shutdown", "join", "stop", "release", "cleanup",
    "unlink", "terminate", "kill", "rmtree", "remove", "detach",
    "reset",    # torch.cuda.CUDAGraph: frees the graph and its pool's blocks
})


@dataclass
class _Alloc:
    name: str
    kind: str
    node: ast.AST        # the allocation statement
    lineno: int
    daemon: bool = False


def _factory_kind(call: ast.Call) -> Optional[str]:
    d = _dotted(call.func)
    if d is None:
        return None
    if d in _BUILTIN_FACTORIES:
        return _BUILTIN_FACTORIES[d]
    parts = d.split(".")
    for span in (3, 2):
        if len(parts) >= span:
            key = ".".join(parts[-2:])
            hit = _FACTORIES.get(key)
            if hit:
                return hit
    return None


def _is_daemon_thread(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


def _name_reads(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               and isinstance(n.ctx, ast.Load) for n in ast.walk(node))


class _FnScan:
    """One function's allocation/release/escape accounting."""

    def __init__(self, mod: Module, fn: ast.AST):
        self.mod = mod
        self.fn = fn
        self.allocs: List[_Alloc] = []
        # name -> release statements (and whether each is on a protected
        # position: inside a finalbody or an ExceptHandler body)
        self.releases: Dict[str, List[Tuple[ast.AST, bool]]] = {}
        self.escaped: Set[str] = set()
        # name -> line where ownership first left this function (a
        # self-store, a return, an argument pass): the error window the
        # leak-on-error rule judges ENDS there -- after the transfer the
        # new owner's lifecycle (class rule, caller) takes over
        self.escape_line: Dict[str, int] = {}
        self.joined: Set[str] = set()
        self.withed: Set[str] = set()
        # (id(call-node), name) pairs the generic argument-pass escape
        # must skip: a rebind-through-call (`sock = ctx.wrap_socket(sock)`)
        # CONTINUES the resource under the same name -- without the
        # exemption the value-call's own argument walk would mark it
        # escaped and the rebind special case would be dead code
        self._rebind_exempt: Set[Tuple[int, str]] = set()
        self._scan()

    def _escape(self, name: str, lineno: int) -> None:
        self.escaped.add(name)
        if name not in self.escape_line:
            self.escape_line[name] = lineno

    def _scan(self) -> None:
        fn = self.fn

        def handle_assign(node: ast.AST, protected: bool) -> None:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                return
            t = node.targets[0]
            value = node.value
            if isinstance(t, ast.Tuple) and isinstance(value, ast.Call):
                # fd, path = tempfile.mkstemp(): track the first element
                kind = _factory_kind(value)
                if kind and t.elts and isinstance(t.elts[0], ast.Name):
                    self.allocs.append(_Alloc(t.elts[0].id, kind, node,
                                              node.lineno))
                return
            if not isinstance(t, ast.Name):
                # self.X = FACTORY() is the class-lifecycle rule's domain;
                # an assign whose target is a subscript escapes ownership
                if isinstance(value, ast.Name):
                    self._escape(value.id, node.lineno)
                return
            if isinstance(value, ast.Call):
                kind = _factory_kind(value)
                if kind is not None:
                    if any(a.name == t.id for a in self.allocs):
                        # re-allocation into the same name: judged as one
                        return
                    self.allocs.append(_Alloc(
                        t.id, kind, node, node.lineno,
                        daemon=(kind == "thread" and _is_daemon_thread(value))))
                    return
                # rebind through a call CONSUMING the old value keeps the
                # resource alive under the same name (ssl wrap_socket);
                # passing a tracked name to any OTHER call escapes it
                consumed = {a.id for a in ast.walk(value)
                            if isinstance(a, ast.Name)
                            and isinstance(a.ctx, ast.Load)}
                for alloc in self.allocs:
                    if alloc.name not in consumed:
                        continue
                    if alloc.name == t.id:
                        # same-name rebind through a consuming call: the
                        # SAME resource continues under this name
                        self._rebind_exempt.add((id(value), alloc.name))
                    else:
                        self._escape(alloc.name, node.lineno)
                return
            if isinstance(value, ast.Name):
                # plain alias: ownership is ambiguous -- out of scope
                self._escape(value.id, node.lineno)

        def walk(node: ast.AST, protected: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                # nested defs capture names; treat captured resources as
                # escaped (a closure owns them now)
                for n in ast.walk(node):
                    if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                        self.escaped.add(n.id)
                return
            if isinstance(node, ast.Try):
                for s in node.body:
                    walk(s, protected)
                for h in node.handlers:
                    for s in h.body:
                        walk(s, True)
                for s in node.orelse:
                    walk(s, protected)
                for s in node.finalbody:
                    walk(s, True)
                return
            if isinstance(node, ast.With):
                for item in node.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Name):
                        self.withed.add(ce.id)
                    if isinstance(ce, ast.Call):
                        # with closing(sock) / contextlib shapes
                        for a in ce.args:
                            if isinstance(a, ast.Name):
                                self.withed.add(a.id)
                for s in node.body:
                    walk(s, protected)
                return
            handle_assign(node, protected)
            if isinstance(node, ast.Call):
                f = node.func
                d = _dotted(f)
                if d in ("os.close", "os.unlink", "os.remove", "os.rmdir",
                         "shutil.rmtree", "_ctypes.dlclose"):
                    # fd-style release: the resource is the ARGUMENT
                    if node.args and isinstance(node.args[0], ast.Name):
                        self.releases.setdefault(node.args[0].id, []).append(
                            (node, protected))
                    return
                if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                    if f.attr in _RELEASE_VERBS:
                        self.releases.setdefault(f.value.id, []).append(
                            (node, protected))
                        if f.attr == "join":
                            self.joined.add(f.value.id)
                # a tracked name passed as an ARGUMENT escapes ownership
                # (unless this very call is a same-name rebind, above)
                for a in list(node.args) + [kw.value for kw in node.keywords]:
                    for n in ast.walk(a):
                        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                                and (id(node), n.id) not in self._rebind_exempt:
                            self._escape(n.id, node.lineno)
            if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
                v = getattr(node, "value", None)
                if v is not None:
                    for n in ast.walk(v):
                        if isinstance(n, ast.Name):
                            self._escape(n.id, node.lineno)
            for child in ast.iter_child_nodes(node):
                walk(child, protected)

        for stmt in getattr(fn, "body", ()):
            walk(stmt, False)

    # -- judgments ------------------------------------------------------------
    def violations(self) -> List[Violation]:
        out: List[Violation] = []
        for alloc in self.allocs:
            if alloc.name in self.withed:
                continue
            if alloc.name in self.escaped:
                # ownership leaves this function -- but the window UP TO
                # the transfer is still this function's responsibility:
                # a call in it can raise with the resource unowned
                if alloc.kind == "thread":
                    continue
                rels = self.releases.get(alloc.name, [])
                if any(protected for _, protected in rels):
                    continue
                xfer = self.escape_line.get(alloc.name, alloc.lineno)
                risky = self._calls_between(alloc, xfer)
                if risky is not None:
                    out.append(self.mod.violation(
                        "reslife/leak-on-error", alloc.lineno,
                        f"{alloc.kind} {alloc.name!r} in "
                        f"{getattr(self.fn, 'name', '?')}() is handed off on "
                        f"line {xfer}, but the call on line {risky} can "
                        "raise first and nothing on that edge releases it: "
                        "close on the except edge and re-raise (the _conn "
                        "shape)"))
                continue
            if alloc.kind == "thread":
                if alloc.daemon:
                    continue
                if alloc.name not in self.joined:
                    out.append(self.mod.violation(
                        "reslife/unjoined-thread", alloc.lineno,
                        f"non-daemon Thread {alloc.name!r} in "
                        f"{getattr(self.fn, 'name', '?')}() is never joined "
                        "and never escapes: interpreter shutdown blocks on "
                        "it and nothing owns its lifetime (daemon=True or "
                        "join it)"))
                continue
            rels = self.releases.get(alloc.name, [])
            if not rels:
                out.append(self.mod.violation(
                    "reslife/unreleased", alloc.lineno,
                    f"{alloc.kind} {alloc.name!r} in "
                    f"{getattr(self.fn, 'name', '?')}() is never released "
                    "on any path (no close/destroy/... and no ownership "
                    "escape)"))
                continue
            if any(protected for _, protected in rels):
                continue  # finally / except-edge release: error-safe
            # straight-line-only release: any call between the allocation
            # and the first release can raise past the close
            first_rel = min(r.lineno for r, _ in rels)
            risky = self._calls_between(alloc, first_rel)
            if risky:
                out.append(self.mod.violation(
                    "reslife/leak-on-error", alloc.lineno,
                    f"{alloc.kind} {alloc.name!r} in "
                    f"{getattr(self.fn, 'name', '?')}() is released only on "
                    f"the fall-through path (line {first_rel}), but the "
                    f"call on line {risky} can raise past the release: use "
                    "with/try-finally, or close on the except edge and "
                    "re-raise"))
        return out

    def _calls_between(self, alloc: _Alloc, release_line: int) -> Optional[int]:
        """Line of the first Call strictly between the allocation
        statement and the release, excluding calls that are part of the
        allocation statement itself, calls inside except handlers or
        raise statements (error-edge code, not the happy-path window),
        and release verbs; None when that region is call-free."""
        lo, hi = alloc.lineno, release_line
        alloc_lines = {n.lineno for n in ast.walk(alloc.node)
                       if hasattr(n, "lineno")}
        skip_lines: Set[int] = set()
        for node in ast.walk(self.fn):
            if isinstance(node, (ast.ExceptHandler, ast.Raise)):
                skip_lines.update(n.lineno for n in ast.walk(node)
                                  if hasattr(n, "lineno"))
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Call) and hasattr(node, "lineno"):
                if lo <= node.lineno < hi and node.lineno not in alloc_lines \
                        and node.lineno not in skip_lines:
                    f = node.func
                    if isinstance(f, ast.Attribute) and \
                            f.attr in _RELEASE_VERBS:
                        continue
                    return node.lineno
        return None


def _class_lifecycle(mod: Module) -> List[Violation]:
    """reslife/self-unreleased: self.X = FACTORY() with no method of the
    class releasing self.X (or delegating to a method whose name is a
    release verb)."""
    out: List[Violation] = []
    for node in mod.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        methods = [m for m in node.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
        stores: Dict[str, Tuple[int, str, bool]] = {}  # attr -> (line, kind, daemon)
        released: Set[str] = set()
        for m in methods:
            for sub in ast.walk(m):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    t = sub.targets[0]
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                            and isinstance(sub.value, ast.Call)):
                        kind = _factory_kind(sub.value)
                        if kind:
                            stores.setdefault(t.attr, (
                                sub.lineno, kind,
                                kind == "thread"
                                and _is_daemon_thread(sub.value)))
                if isinstance(sub, ast.Call):
                    f = sub.func
                    if (isinstance(f, ast.Attribute)
                            and f.attr in _RELEASE_VERBS
                            and isinstance(f.value, ast.Attribute)
                            and isinstance(f.value.value, ast.Name)
                            and f.value.value.id == "self"):
                        released.add(f.value.attr)
                    # os.close(self._fd)-style: the resource is the arg
                    if (isinstance(f, ast.Attribute)
                            and f.attr in _RELEASE_VERBS and sub.args
                            and isinstance(sub.args[0], ast.Attribute)
                            and isinstance(sub.args[0].value, ast.Name)
                            and sub.args[0].value.id == "self"):
                        released.add(sub.args[0].attr)
        for attr, (line, kind, daemon) in sorted(stores.items()):
            if attr in released or daemon:
                continue
            out.append(mod.violation(
                "reslife/self-unreleased", line,
                f"{node.name}.{attr} holds a {kind} no method of the class "
                "ever releases: the instance pins an fd/mapping/thread for "
                "its whole lifetime with no lifecycle seam to free it"))
    return out


def check(modules: List[Module]) -> List[Violation]:
    out: List[Violation] = []
    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(_FnScan(mod, node).violations())
        out.extend(_class_lifecycle(mod))
    return out
