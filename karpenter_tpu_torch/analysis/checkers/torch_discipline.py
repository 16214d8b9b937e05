"""Device-discipline checker: the armed-graph and host-sync contract, static.

Counterpart of karpenter_tpu/analysis/checkers/jax_discipline.py. The
JAX checker guards the jit contract: no silent recompiles, no host syncs
mid-tick. The port compiles nothing per shape, but it has the same two
hazards in torch's form: a CUDA graph per distinct static value (the
warm-up ladder arms one graph per `exec_key`, solver/aot.py), and host
syncs that stall the tick on the card. Each JAX rule maps to the hazard
it becomes; ``analysis/torch_witness.py`` is the runtime complement.

``torchjit/*`` -- graph-capture and kernel-entry hazards:

- ``torchjit/unbounded-static`` (``jaxjit/unbounded-static``): every
  static that reaches an armed graph's ``exec_key`` -- the ``statics`` of
  ``aot.try_call`` and of the ladder's ``_lower_task`` -- must be declared
  in ``STATIC_ARG_BUCKETS``: an unbounded axis is one graph per value.
  Statics the checker cannot resolve to a literal dict fire too.
- ``torchjit/kernel-twin`` (``jaxjit/pallas-twin``): every ctypes kernel
  entry under solver/kernels/ (a public function that reaches a launch
  counter) has its plain twin in ``KERNEL_TWINS`` and a case builder in
  solver/kernels/cases.py (``KERNEL_CASES``); and no ``except`` around a
  launch calls the plain version -- the no-fallback contract, statically.
- ``torchjit/closure-state`` (``jaxjit/closure-state``): a function the
  ladder captures into a CUDA graph (and its module-local helpers) reads
  no ``self.X`` and no mutable module-level name: a graph must never bake
  a live tensor's address or a value read at capture time.
- ``torchjit/traced-branch`` (``jaxjit/traced-branch``): ``if``/``while``/
  ternary/``for`` on a device tensor in a hot function -- an implicit sync
  through ``__bool__`` (and a capture error inside a graph). Shape, dtype
  and device reads do not taint.
- ``torchjit/weak-dtype`` (``jaxjit/weak-dtype``): ``torch.zeros/ones/
  full/empty/arange/tensor/linspace/eye`` without both ``device=`` and
  ``dtype=`` in a hot function: the default device is the CPU and the
  default dtype is whatever the process set.

``torchhost/*`` -- host-sync discipline over ``DEVICE_HOT_PATH``, the
port's encode -> dispatch -> decode functions:

- ``torchhost/item``: ``.item()`` round-trips device -> host.
- ``torchhost/scalar-cast``: ``int()``/``float()``/``bool()`` of a device
  tensor (local dataflow from torch calls and device entries).
- ``torchhost/np-on-device``: ``.cpu()``, ``.numpy()``, and ``.tolist()``
  / ``np.asarray`` / ``np.array`` of a device tensor, outside the
  ``SANCTIONED_FETCH`` manifest -- the one manifest this checker and the
  runtime sync witness share (analysis/sync_witness.py).
- ``torchhost/synchronize`` (``jaxhost/block-until-ready``):
  ``torch.cuda.synchronize()``, ``Stream.synchronize()``,
  ``Event.synchronize()`` in a hot function.

Stdlib only: the lint run imports neither torch nor numpy.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from karpenter_tpu_torch.analysis.base import Module, Violation
from karpenter_tpu_torch.analysis.base import dotted as _dotted
from karpenter_tpu_torch.analysis.sync_witness import SANCTIONED_FETCH

# -- the bucketing manifest ------------------------------------------------------
#
# Every static that reaches an exec_key, with the argument for WHY its
# value set is bounded (so the armed table stays a handful of graphs per
# catalog geometry, not one per tick).

STATIC_ARG_BUCKETS: Dict[str, str] = {
    "g_max": "open-group slot budget: fixed per solver instance "
             "(TorchSolver(g_max=...)); one value per process",
    "nnz_max": "sparse-take budget: ffd.nnz_budget(c_pad, g_max), a pure "
               "function of the padded class bucket and g_max -- one value "
               "per (c_pad bucket, g_max) pair",
    "word_offsets": "packed-bitset geometry: cumsum of the catalog's "
                    "requirement-dimension word counts; one value per "
                    "catalog encoding (staged once per catalog)",
    "words": "packed-bitset geometry: per-dimension word counts, fixed by "
             "the catalog encoding alongside word_offsets",
    "objective": "closed enum {'price', 'fit'}: two graphs per bucket at most",
    "iters": "convex-tier iteration budget: relax.DEFAULT_ITERS, fixed per "
             "process -- one graph per budget actually used",
    "od_col": "on-demand column of the closed capacity-type vocabulary "
              "(encode.CAPTYPE_INDEX): one value per process",
}

SOLVER_PREFIX = "karpenter_tpu_torch/solver/"
KERNELS_PREFIX = "karpenter_tpu_torch/solver/kernels/"
CASES_REL = "karpenter_tpu_torch/solver/kernels/cases.py"
AOT_REL = "karpenter_tpu_torch/solver/aot.py"

# kernel entry (rel, wrapper) -> its plain twin (rel, function): the
# version the CPU runs and the card is held against -- never a fallback
KERNEL_TWINS: Dict[Tuple[str, str], Tuple[str, str]] = {
    ("karpenter_tpu_torch/solver/kernels/ffd_scan.py", "fused_scan"):
        ("karpenter_tpu_torch/solver/kernels/ffd_scan.py", "fused_scan_reference"),
    ("karpenter_tpu_torch/solver/kernels/disrupt_repack.py", "disrupt_repack"):
        ("karpenter_tpu_torch/solver/kernels/disrupt_repack.py", "repack_reference"),
    ("karpenter_tpu_torch/solver/kernels/disrupt_repack.py", "disrupt_repack_leftover"):
        ("karpenter_tpu_torch/solver/kernels/disrupt_repack.py", "repack_leftover_reference"),
}

# kernel entry -> the edge-case builders of solver/kernels/cases.py that
# hold it against its twin (tests and chip_smoke.py share them)
KERNEL_CASES: Dict[str, Tuple[str, ...]] = {
    "fused_scan": ("padded_between", "zero_request"),
    "disrupt_repack": ("gap_repack", "sparse_members"),
    "disrupt_repack_leftover": ("gap_repack", "sparse_members"),
}

# -- the device hot-path manifest ------------------------------------------------
#
# rel -> (module functions, {class: methods}): the per-tick encode ->
# dispatch -> decode functions. A host sync in any of them stalls the tick
# on the card (or serializes the pipelined begin/finish overlap).

DEVICE_HOT_PATH: Dict[str, Tuple[Tuple[str, ...], Dict[str, Tuple[str, ...]]]] = {
    "karpenter_tpu_torch/solver/ffd.py": (
        ("ffd_solve_fused", "fetch_fused", "expand_fused", "solve_dense_tuple"),
        {},
    ),
    "karpenter_tpu_torch/solver/bound.py": (
        ("fractional_price_bound", "fetch_bound"),
        {},
    ),
    "karpenter_tpu_torch/solver/convex/relax.py": (
        ("convex_relax", "fetch_relax"),
        {},
    ),
    "karpenter_tpu_torch/solver/service.py": (
        (),
        {"TorchSolver": ("solve_begin", "solve_finish", "_pack_existing", "_decode")},
    ),
    # the single-device back end: every kernel entry's dispatch (the
    # dense refetch reads inside ffd.solve_dense_tuple, sanctioned)
    "karpenter_tpu_torch/solver/device_engine.py": (
        (),
        {"DeviceEngine": ("solve_fused", "solve_compact", "solve_dense", "refetch_dense",
                          "price_bound", "convex_relax", "_repack_ops", "repack",
                          "repack_leftover", "replace")},
    ),
    "karpenter_tpu_torch/solver/disrupt/engine.py": (
        (),
        # `replace` is _evaluate_local's per-pool pass (a nested function)
        {"DisruptEngine": ("_dispatch_local", "_evaluate_local")},
    ),
    # the sidecar's ops: one per wire request, each with its one fetch
    "karpenter_tpu_torch/solver/rpc.py": (
        (),
        {"SolverServer": ("_op_solve_delta", "_staged_inputs", "_op_solve",
                          "_op_solve_compact", "_op_solve_disrupt", "_op_solve_convex")},
    ),
    # the mesh: the shards' split, run and gathers enqueue only; a
    # multi-process mesh's one barrier is the all-gather
    # (_fetch_multiprocess, sanctioned)
    "karpenter_tpu_torch/parallel/mesh.py": (
        ("run_shards", "shard_inputs", "sharded_scan_columns", "sharded_solve",
         "sharded_rates", "sharded_price_bound", "sharded_repack", "sharded_repack_leftover",
         "_sharded_repack", "sharded_replace",
         "_fetch_multiprocess"),
        {},
    ),
    # fleet subsystem: the mesh engine's dispatch methods run on every
    # tick of a mesh-configured solver/sidecar -- hot-path by
    # construction; its one designed barrier is `fetch` (sanctioned)
    "karpenter_tpu_torch/fleet/shard.py": (
        (),
        {"MeshSolveEngine": ("solve_fused", "solve_compact", "solve_dense", "refetch_dense",
                             "price_bound", "repack", "repack_leftover", "_repack", "replace",
                             "_scan", "_rung", "fetch")},
    ),
}

RULE_UNBOUNDED = "torchjit/unbounded-static"
RULE_TWIN = "torchjit/kernel-twin"
RULE_CLOSURE = "torchjit/closure-state"
RULE_BRANCH = "torchjit/traced-branch"
RULE_DTYPE = "torchjit/weak-dtype"
RULE_ITEM = "torchhost/item"
RULE_CAST = "torchhost/scalar-cast"
RULE_NP = "torchhost/np-on-device"
RULE_SYNC = "torchhost/synchronize"

# attribute reads that produce host values (no taint)
_SHAPE_ATTRS = ("shape", "dtype", "device", "ndim", "is_cuda", "layout", "requires_grad")
# calls whose result is never a device tensor regardless of arguments
_TAINT_KILLERS = ("len", "isinstance", "type", "range", "id", "repr", "str", "int",
                  "float", "bool", "tuple", "list", "dict", "sorted", "enumerate", "zip")
# tensor methods whose result is on the host (each is its own sync rule)
_HOST_METHODS = ("item", "tolist", "cpu", "numpy", "size", "dim", "numel", "stride",
                 "data_ptr", "element_size", "is_contiguous")
# torch.X that return host values
_TORCH_HOST_FNS = ("Size", "device", "dtype", "is_tensor", "get_default_dtype", "Generator",
                   "no_grad", "inference_mode", "finfo", "iinfo")
_CREATION_FNS = ("zeros", "ones", "full", "empty", "arange", "tensor", "linspace", "eye")


def _params(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _positional(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args if x.arg != "self"]
    if a.vararg:
        names.append(a.vararg.arg)
    return names


def _rel_of_module(modname: str) -> str:
    return modname.replace(".", "/") + ".py"


# -- kernel entries ---------------------------------------------------------------


def kernel_entries(modules: List[Module]) -> Dict[Tuple[str, str], ast.FunctionDef]:
    """(rel, name) -> FunctionDef of every public function in
    solver/kernels/ that reaches the module's launch counter
    (``launches += 1``) through module-local calls: the kernel wrappers."""
    out: Dict[Tuple[str, str], ast.FunctionDef] = {}
    for mod in modules:
        if not mod.rel.startswith(KERNELS_PREFIX):
            continue
        fns = {f.name: f for f in mod.tree.body if isinstance(f, ast.FunctionDef)}
        reach = {name for name, f in fns.items() if any(
            isinstance(n, ast.AugAssign) and isinstance(n.target, ast.Name)
            and n.target.id == "launches" for n in ast.walk(f))}
        grew = True
        while grew:
            grew = False
            for name, f in fns.items():
                if name not in reach and any(
                        isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                        and n.func.id in reach for n in ast.walk(f)):
                    reach.add(name)
                    grew = True
        for name in sorted(reach):
            if not name.startswith("_"):
                out[(mod.rel, name)] = fns[name]
    return out


def captured_entries(modules: List[Module]) -> List[Tuple[str, str]]:
    """(rel, function) of every entry the warm-up ladder captures into a
    CUDA graph: the literal (module, function) of each ``_lower_task``."""
    out: List[Tuple[str, str]] = []
    for mod in modules:
        if mod.rel != AOT_REL:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and (_dotted(node.func) or "").endswith("_lower_task"):
                a = node.args
                if len(a) >= 4 and all(isinstance(x, ast.Constant) and isinstance(x.value, str)
                                       for x in a[2:4]):
                    out.append((_rel_of_module(a[2].value), a[3].value))
    return sorted(set(out))


# -- torchjit/unbounded-static ----------------------------------------------------


def _enclosing_assigns(fn: ast.AST) -> Dict[str, List[ast.AST]]:
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out.setdefault(node.targets[0].id, []).append(node.value)
    return out


def _static_keys(expr: ast.AST, assigns: Dict[str, List[ast.AST]],
                 depth: int = 0) -> Optional[Set[str]]:
    """The keys of a statics expression: a dict display, ``dict(k=...,
    **other)``, or a local name bound to one of those; None when not
    resolvable to literal keys."""
    if depth > 4:
        return None
    if isinstance(expr, ast.Dict):
        keys: Set[str] = set()
        for k, v in zip(expr.keys, expr.values):
            if k is None:
                sub = _static_keys(v, assigns, depth + 1)
                if sub is None:
                    return None
                keys |= sub
            elif isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.add(k.value)
            else:
                return None
        return keys
    if isinstance(expr, ast.Call) and _dotted(expr.func) == "dict" and not expr.args:
        keys = set()
        for kw in expr.keywords:
            if kw.arg is None:
                sub = _static_keys(kw.value, assigns, depth + 1)
                if sub is None:
                    return None
                keys |= sub
            else:
                keys.add(kw.arg)
        return keys
    if isinstance(expr, ast.Name):
        bound = assigns.get(expr.id)
        if not bound:
            return None
        keys = set()
        for value in bound:
            sub = _static_keys(value, assigns, depth + 1)
            if sub is None:
                return None
            keys |= sub
        return keys
    return None


def _check_statics(mod: Module) -> List[Violation]:
    out: List[Violation] = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        assigns = _enclosing_assigns(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            tail = (_dotted(node.func) or "").split(".")[-1]
            if tail == "try_call" and len(node.args) >= 3:
                statics, where = node.args[2], "try_call"
            elif tail == "_lower_task" and len(node.args) >= 6:
                statics, where = node.args[5], "_lower_task"
            else:
                continue
            keys = _static_keys(statics, assigns)
            if keys is None:
                out.append(mod.violation(
                    RULE_UNBOUNDED, node,
                    f"{where}: statics must resolve to a literal dict so the "
                    "bucketing manifest can be checked"))
                continue
            for k in sorted(keys - set(STATIC_ARG_BUCKETS)):
                out.append(mod.violation(
                    RULE_UNBOUNDED, node,
                    f"{where}: static {k!r} reaches the exec_key but is not in "
                    "the bucketing manifest (STATIC_ARG_BUCKETS); an unbounded "
                    "static arms one CUDA graph per distinct value"))
    return out


# -- torchjit/kernel-twin ---------------------------------------------------------


def _check_twins(modules: List[Module]) -> List[Violation]:
    out: List[Violation] = []
    by_rel = {m.rel: m for m in modules}
    entries = kernel_entries(modules)
    cases = by_rel.get(CASES_REL)
    case_fns = {f.name for f in cases.tree.body if isinstance(f, ast.FunctionDef)} \
        if cases is not None else set()
    twin_names: Set[str] = set()
    for (rel, name), fn in sorted(entries.items()):
        mod = by_rel[rel]
        twin = KERNEL_TWINS.get((rel, name))
        if twin is None:
            out.append(mod.violation(
                RULE_TWIN, fn, f"{name}: kernel entry has no plain twin in KERNEL_TWINS "
                "(the version the CPU runs and the card is held against)"))
        else:
            twin_mod = by_rel.get(twin[0])
            if twin_mod is None or not any(isinstance(f, ast.FunctionDef) and f.name == twin[1]
                                           for f in twin_mod.tree.body):
                out.append(mod.violation(
                    RULE_TWIN, fn, f"{name}: declared plain twin {twin[0]}:{twin[1]} "
                    "does not exist"))
            twin_names.add(twin[1])
        builders = KERNEL_CASES.get(name, ())
        missing = [b for b in builders if b not in case_fns]
        if not builders or (cases is not None and missing):
            out.append(mod.violation(
                RULE_TWIN, fn, f"{name}: kernel entry has no case builder in "
                f"solver/kernels/cases.py (KERNEL_CASES; missing {missing or 'an entry'})"))
    # no except around a launch may run the plain version
    launch_names = {name for _, name in entries} | {name for _, name in KERNEL_TWINS} | {"_launch"}
    twin_names |= {t[1] for t in KERNEL_TWINS.values()}
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            launches = any(
                isinstance(n, ast.Call)
                and (_dotted(n.func) or "").split(".")[-1] in launch_names
                for s in node.body for n in ast.walk(s))
            if not launches:
                continue
            for h in node.handlers:
                for n in ast.walk(h):
                    if isinstance(n, ast.Call) and \
                            (_dotted(n.func) or "").split(".")[-1] in twin_names:
                        out.append(mod.violation(
                            RULE_TWIN, n, "a handler around a kernel launch calls the "
                            "plain version: the port never falls back (a wrapper given "
                            "a CUDA tensor launches its kernel or raises)"))
    return out


# -- the taint scan (hot and captured bodies) -------------------------------------


class _ModuleContext:
    def __init__(self, mod: Module):
        self.mod = mod
        self.functions: Dict[str, ast.FunctionDef] = {}
        self.mutables: Set[str] = set()
        imported: Set[str] = set()
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node  # type: ignore[assignment]
            elif isinstance(node, ast.ClassDef):
                imported.add(node.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    imported.add((a.asname or a.name).split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    imported.add(a.asname or a.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and not n.id.lstrip("_").isupper():
                            self.mutables.add(n.id)
        self.mutables -= imported


class _BodyScan:
    """Taint-tracking walk of one hot or captured body (plus module-local
    helpers, transitively). Taint = "this expression is a device tensor"."""

    def __init__(self, ctx: _ModuleContext, out: List[Violation], seen: Set[tuple],
                 entry_names: Set[str], captured: bool):
        self.ctx = ctx
        self.out = out
        self.seen = seen
        self.entry_names = entry_names
        self.captured = captured
        self.visited: Set[Tuple[int, frozenset]] = set()

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        key = (rule, getattr(node, "lineno", 0), msg)
        if key in self.seen:
            return
        self.seen.add(key)
        self.out.append(self.ctx.mod.violation(rule, node, msg))

    def taint(self, node: ast.AST, env: Dict[str, bool]) -> bool:
        if isinstance(node, ast.Name):
            return env.get(node.id, False)
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                return False
            return self.taint(node.value, env)
        if isinstance(node, ast.Subscript):
            return self.taint(node.value, env)
        if isinstance(node, ast.Call):
            f = _dotted(node.func) or ""
            parts = f.split(".")
            if f in _TAINT_KILLERS or parts[-1] in _HOST_METHODS:
                return False
            if parts[0] == "torch":
                return parts[-1] not in _TORCH_HOST_FNS and "cuda" not in parts
            if parts[-1] in self.entry_names:
                return True
            if isinstance(node.func, ast.Attribute) and self.taint(node.func.value, env):
                return True
            return False
        if isinstance(node, ast.BinOp):
            return self.taint(node.left, env) or self.taint(node.right, env)
        if isinstance(node, ast.BoolOp):
            return any(self.taint(v, env) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False    # identity tests (`t is None`) never read the device
            return self.taint(node.left, env) or any(self.taint(c, env) for c in node.comparators)
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand, env)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.taint(e, env) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.taint(node.body, env) or self.taint(node.orelse, env)
        if isinstance(node, ast.Starred):
            return self.taint(node.value, env)
        return False

    def bind(self, target: ast.AST, tainted: bool, env: Dict[str, bool]) -> None:
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                env[n.id] = tainted

    def scan_function(self, fn: ast.AST, traced: Optional[Iterable[str]] = None,
                      outer: Optional[Dict[str, bool]] = None) -> None:
        params = _params(fn)
        traced_set = set(traced) if traced is not None else set()
        key = (id(fn), frozenset(traced_set))
        if key in self.visited:
            return
        self.visited.add(key)
        env: Dict[str, bool] = dict(outer or {})
        for p in params:
            env[p] = p in traced_set
        self.block(fn.body, env)

    def block(self, body: List[ast.stmt], env: Dict[str, bool]) -> None:
        for stmt in body:
            self.stmt(stmt, env)

    def stmt(self, stmt: ast.stmt, env: Dict[str, bool]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.scan_function(stmt, None, outer=env)
            env[stmt.name] = False
            return
        if isinstance(stmt, ast.Assign):
            self.expr(stmt.value, env)
            t = self.taint(stmt.value, env)
            for target in stmt.targets:
                self.bind(target, t, env)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self.expr(stmt.value, env)
            self.bind(stmt.target, self.taint(stmt.value, env), env)
            return
        if isinstance(stmt, ast.AugAssign):
            self.expr(stmt.value, env)
            if self.taint(stmt.value, env):
                self.bind(stmt.target, True, env)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self.expr(stmt.test, env)
            if self.taint(stmt.test, env):
                self._emit(RULE_BRANCH, stmt,
                           "Python branch on a device tensor in a hot function: an "
                           "implicit sync through __bool__; use torch.where or fetch "
                           "at the sanctioned barrier")
            self.block(stmt.body, env)
            self.block(stmt.orelse, env)
            return
        if isinstance(stmt, ast.For):
            self.expr(stmt.iter, env)
            if self.taint(stmt.iter, env):
                self._emit(RULE_BRANCH, stmt,
                           "Python loop over a device tensor in a hot function: one "
                           "sync per element")
            self.bind(stmt.target, False, env)
            self.block(stmt.body, env)
            self.block(stmt.orelse, env)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self.expr(item.context_expr, env)
            self.block(stmt.body, env)
            return
        if isinstance(stmt, ast.Try):
            self.block(stmt.body, env)
            for h in stmt.handlers:
                self.block(h.body, env)
            self.block(stmt.orelse, env)
            self.block(stmt.finalbody, env)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self.expr(child, env)

    def expr(self, expr: ast.expr, env: Dict[str, bool]) -> None:
        for node in ast.walk(expr):
            if self.captured and isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) and node.value.id == "self" \
                    and isinstance(node.ctx, ast.Load):
                self._emit(RULE_CLOSURE, node,
                           f"a function captured into a CUDA graph reads self.{node.attr}: "
                           "the graph bakes what it read at capture -- pass it as an "
                           "argument")
            elif self.captured and isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load) \
                    and node.id in self.ctx.mutables and node.id not in env:
                self._emit(RULE_CLOSURE, node,
                           f"a function captured into a CUDA graph reads module-level "
                           f"mutable {node.id!r}: a rebind is invisible to the replay")
            elif isinstance(node, ast.IfExp) and self.taint(node.test, env):
                self._emit(RULE_BRANCH, node,
                           "ternary on a device tensor in a hot function; use torch.where")
            elif isinstance(node, ast.Call):
                self.call(node, env)

    def call(self, node: ast.Call, env: Dict[str, bool]) -> None:
        f = _dotted(node.func) or ""
        parts = f.split(".")
        if len(parts) == 2 and parts[0] == "torch" and parts[1] in _CREATION_FNS:
            kws = {kw.arg for kw in node.keywords}
            missing = [k for k in ("device", "dtype") if k not in kws]
            if missing:
                self._emit(RULE_DTYPE, node,
                           f"{f}() without {' and '.join(k + '=' for k in missing)} in a "
                           "hot function: the default device is the CPU and the default "
                           "dtype is process state")
        if len(parts) == 1 and parts[0] in self.ctx.functions:
            target = self.ctx.functions[parts[0]]
            params = _params(target)
            traced = {params[i] for i, a in enumerate(node.args)
                      if i < len(params) and self.taint(a, env)}
            traced |= {kw.arg for kw in node.keywords
                       if kw.arg in params and self.taint(kw.value, env)}
            self.scan_function(target, traced)


def _hot_functions(modules: List[Module]):
    """(module, function node, 'where', sanctioned) for every manifest function."""
    by_rel = {m.rel: m for m in modules}
    for rel, (func_names, class_methods) in DEVICE_HOT_PATH.items():
        mod = by_rel.get(rel)
        if mod is None:
            continue
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in func_names:
                yield mod, node, node.name, (rel, node.name) in SANCTIONED_FETCH
            elif isinstance(node, ast.ClassDef) and node.name in class_methods:
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and item.name in class_methods[node.name]:
                        yield (mod, item, f"{node.name}.{item.name}",
                               (rel, item.name) in SANCTIONED_FETCH)


def _entry_names(modules: List[Module]) -> Set[str]:
    """Names whose calls return device tensors: the kernel wrappers, the
    captured entries and obs/jitstats.py's registered entries."""
    from karpenter_tpu_torch.analysis.checkers.registry_drift import jit_entry_registry

    names = {name for _, name in kernel_entries(modules)}
    names |= {fn for _, fn in captured_entries(modules)}
    names |= {fn for _, fn in jit_entry_registry(modules) or ()}
    return names


def check_retrace(modules: List[Module]) -> List[Violation]:
    out: List[Violation] = []
    for mod in modules:
        if mod.rel.startswith(SOLVER_PREFIX):
            out.extend(_check_statics(mod))
    out.extend(_check_twins(modules))
    names = _entry_names(modules)
    by_rel = {m.rel: m for m in modules}
    seen: Set[tuple] = set()
    contexts: Dict[str, _ModuleContext] = {}

    def ctx_of(mod: Module) -> _ModuleContext:
        if mod.rel not in contexts:
            contexts[mod.rel] = _ModuleContext(mod)
        return contexts[mod.rel]

    # captured entries: every positional parameter is a device tensor
    for rel, fname in captured_entries(modules):
        mod = by_rel.get(rel)
        if mod is None:
            continue
        ctx = ctx_of(mod)
        fn = ctx.functions.get(fname)
        if fn is not None:
            _BodyScan(ctx, out, seen, names, captured=True).scan_function(fn, _positional(fn))
    # hot functions: taint from torch calls and device entries
    for mod, fn, _where, _sanctioned in _hot_functions(modules):
        _BodyScan(ctx_of(mod), out, seen, names, captured=False).scan_function(fn, ())
    return out


# -- host-sync rules --------------------------------------------------------------


def _scan_hot_function(mod: Module, fn: ast.AST, where: str, sanctioned: bool,
                       names: Set[str]) -> List[Violation]:
    out: List[Violation] = []
    scan = _BodyScan(_ModuleContext(mod), [], set(), names, captured=False)
    # source-order taint: the last assignment of each name decides
    env: Dict[str, bool] = {}
    assigns = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Assign)),
                     key=lambda n: (n.lineno, n.col_offset))
    tainted_at: Dict[str, List[Tuple[int, bool]]] = {}
    for node in assigns:
        t = scan.taint(node.value, env)
        for target in node.targets:
            for n in ast.walk(target):
                if isinstance(n, ast.Name):
                    env[n.id] = t
                    tainted_at.setdefault(n.id, []).append((node.lineno, t))

    def tainted(e: ast.AST, line: int) -> bool:
        while isinstance(e, (ast.Attribute, ast.Subscript)):
            if isinstance(e, ast.Attribute) and e.attr in _SHAPE_ATTRS:
                return False
            e = e.value
        if isinstance(e, ast.Call):
            return scan.taint(e, env)
        if not isinstance(e, ast.Name):
            return False
        state = False
        for ln, t in tainted_at.get(e.id, ()):
            if ln <= line:
                state = t
        return state

    # a nested function named in SANCTIONED_FETCH (the sweep's per-pool
    # `replace`) is its own designed barrier
    blessed: Set[int] = set()
    for node in ast.walk(fn):
        if node is not fn and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and (mod.rel, node.name) in SANCTIONED_FETCH:
            blessed |= {id(n) for n in ast.walk(node)}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        d = _dotted(f) or ""
        tail = d.split(".")[-1]
        if tail == "item" and isinstance(f, ast.Attribute):
            out.append(mod.violation(RULE_ITEM, node,
                                     f"{where}: .item() round-trips device -> host on the "
                                     "tick's hot path"))
        elif tail == "synchronize" and isinstance(f, ast.Attribute):
            out.append(mod.violation(RULE_SYNC, node,
                                     f"{where}: explicit {d}() on the hot path serializes "
                                     "the pipelined tick against the card"))
        elif d in ("float", "int", "bool") and node.args:
            if tainted(node.args[0], node.lineno):
                out.append(mod.violation(RULE_CAST, node,
                                         f"{where}: {d}() of a device tensor blocks on the "
                                         "card; fetch through the sanctioned barrier first"))
        elif not sanctioned and id(node) not in blessed:
            if isinstance(f, ast.Attribute) and tail in ("cpu", "numpy") and not node.args:
                out.append(mod.violation(RULE_NP, node,
                                         f"{where}: .{tail}() copies device -> host "
                                         "synchronously; route it through a SANCTIONED_FETCH "
                                         "site"))
            elif isinstance(f, ast.Attribute) and tail == "tolist" \
                    and tainted(f.value, node.lineno):
                out.append(mod.violation(RULE_NP, node,
                                         f"{where}: .tolist() of a device tensor syncs; "
                                         "route it through a SANCTIONED_FETCH site"))
            elif tail in ("asarray", "array") and len(d.split(".")) >= 2 \
                    and d.split(".")[-2] in ("np", "numpy") and node.args \
                    and tainted(node.args[0], node.lineno):
                out.append(mod.violation(RULE_NP, node,
                                         f"{where}: {d}() of a device tensor syncs; route "
                                         "it through a SANCTIONED_FETCH site"))
    return out


def check_hostsync(modules: List[Module]) -> List[Violation]:
    names = _entry_names(modules)
    out: List[Violation] = []
    for mod, fn, where, sanctioned in _hot_functions(modules):
        out.extend(_scan_hot_function(mod, fn, where, sanctioned, names))
    return out

