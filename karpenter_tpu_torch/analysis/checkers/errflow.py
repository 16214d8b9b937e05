"""Error-path soundness checker: the exception-propagation graph, seam-checked.

Copy of karpenter_tpu/analysis/checkers/errflow.py over the port. The
manifests (``LADDER_SEAMS``, ``SANCTIONED_CRASH_SWALLOWS``,
``SANCTIONED_ESCAPE_SITES``, ``FAILPOINT_INJECTS``, ``RAISE_SOURCES``)
name the port's own paths; the terminal rungs are ``TorchSolver``'s.
Entries whose code lives in the fleet and mesh modules the port does not
have yet are left out, and come with those modules: the tenant-dispatch
seam ``fleet/coalesce.py:DispatchCoalescer._run_one`` and the crash
terminal ``fleet/coalesce.py:_loop`` (ROADMAP A11a); the mesh seams
``fleet/shard.py:MeshSolveEngine._dispatch`` and ``._reshard``,
``fleet/straggler.py:ShardStragglerWatchdog.check_now`` and the
``mesh.`` failpoint prefix (ROADMAP A11b).

The repo's robustness claim -- every wire failure degrades through the
shm -> tcp -> breaker -> host ladder to a bit-identical decision, and a
crash (``OperatorCrashed``) is never converted into a handled cloud
error -- was enforced only dynamically, by the chaos soaks exercising
whatever fault schedules they contain. This checker makes the ladder a
lint-time contract, the way determinism, lock order, and jit discipline
already are:

The package's exception CLASS HIERARCHY (``CloudError``/``ShmError``/
``StaleSeqnumError``/``OperatorCrashed``/... merged with the builtin
tree) is discovered from the AST, every ``raise`` site is typed against
it, and each function's ESCAPE SET -- the exception classes that can
propagate out of it -- is computed interprocedurally: callees resolved
through the same conservative resolution the lock checker uses
(``self.method`` through the class hierarchy, module functions, package
imports, plus a unique-method-name fallback for duck-typed receivers),
raises filtered through the enclosing ``try``/``except`` structure
(handler bodies re-raise their caught set on a bare ``raise``; ``else``
and ``finally`` blocks are NOT protected by their try's handlers).
Socket-verb calls (``connect``/``recv``/``sendall``/...) seed ``OSError``
and ``failpoints.eval`` sites seed the injectable chaos set
(``ConnectionError``/``OSError``/``CloudError``/``OperatorCrashed``) --
a seam must statically handle what its failpoint can inject.

Rules:

- ``errflow/seam-ladder-escape``     -- a ``LADDER_SEAMS`` entry with a
  ``must_handle`` contract (a TERMINAL rung: ``TorchSolver._finish_remote``,
  ``DisruptEngine.evaluate``, the breaker probe) whose escape set still
  contains a must-handle ladder class: a wire failure that would leak
  past the degrade ladder instead of ending in a host-backend decision.
- ``errflow/seam-undeclared-escape`` -- a MID-ladder seam (client
  roundtrip/pipeline ops, shm framing) letting a ladder-class exception
  escape that its ``may_raise`` declaration does not cover: an error
  routed outside the breaker's accounting.
- ``errflow/seam-missing``           -- a manifest entry naming a
  function that no longer exists (a rename silently unguards the seam).
- ``errflow/swallow-crash``          -- a handler that can catch
  ``OperatorCrashed`` (bare ``except``, ``except BaseException``, or the
  class by name) without a ``raise`` in its body, outside
  ``SANCTIONED_CRASH_SWALLOWS``: the contract "controller seams
  cannot swallow a crash", as a lint rule.
- ``errflow/broad-swallow``          -- an ``except Exception`` handler
  that neither re-raises, converts to a typed error, counts into a
  metric, logs, nor forwards the error (event publish / future
  fan-out): a silent absorption point no operator can observe.
- ``errflow/return-in-finally``      -- a ``return``/``break``/
  ``continue`` inside a ``finally`` block: Python semantics silently
  swallow any in-flight exception, including ``OperatorCrashed``.

``exception_graph(modules)`` exposes the per-seam escape sets for
``python -m karpenter_tpu_torch.analysis --graph --family errflow`` and the
test suite's certification. The RUNTIME complement is
``analysis/errwitness.py``: the same sanctioned-site manifests drive a
settrace-based escape witness that counts actually-swallowed
ladder-class exceptions per handler site.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from karpenter_tpu_torch.analysis.base import Module, Violation
from karpenter_tpu_torch.analysis.base import dotted as _dotted

# -- the ladder-seam manifest -------------------------------------------------
#
# Every wire-dispatch seam of the degrade ladder, with its exception
# contract. ``must_handle``: ladder classes that must NOT escape (the
# seam terminates the ladder for them -- a violation means a wire
# failure leaks past the degrade path). ``may_raise``: ladder classes
# the seam is DECLARED to propagate to the next rung (anything else
# escaping is routed outside the breaker). ``failpoint`` names the chaos
# site that exercises this seam -- registry_drift checks it exists in
# code, so a seam cannot lose its drill. tests/test_analysis.py asserts
# every named function still exists (the HOT_PATH existence contract).


@dataclass(frozen=True)
class Seam:
    rel: str                            # repo-relative file
    cls: Optional[str]                  # class name, or None for a module fn
    func: str
    must_handle: Tuple[str, ...] = ()   # ladder classes that must not escape
    may_raise: Tuple[str, ...] = ()     # ladder classes allowed to escape
    failpoint: str = ""                 # chaos site that exercises this seam
    why: str = ""

    @property
    def key(self) -> str:
        return f"{self.rel}:{(self.cls + '.') if self.cls else ''}{self.func}"


LADDER_SEAMS: Tuple[Seam, ...] = (
    # -- terminal rungs: the ladder ENDS here in a host-backend decision
    Seam("karpenter_tpu_torch/solver/service.py", "TorchSolver", "_finish_remote",
         must_handle=("ConnectionError", "OSError", "TimeoutError",
                      "StaleSeqnumError", "StaleEpochError", "ShmError",
                      "RuntimeError"),
         failpoint="rpc.recv",
         why="the provisioning solve's terminal rung: every wire failure "
             "must end in the in-process host solve, never in the tick"),
    Seam("karpenter_tpu_torch/solver/disrupt/engine.py", "DisruptEngine", "evaluate",
         must_handle=("ConnectionError", "OSError", "TimeoutError",
                      "StaleSeqnumError", "StaleEpochError", "ShmError",
                      "RuntimeError"),
         failpoint="rpc.disrupt.dispatch",
         why="the consolidation sweep's terminal rung: wire failures fall "
             "back to the in-process kernels, bit-identically"),
    Seam("karpenter_tpu_torch/solver/service.py", "TorchSolver", "_finish_remote_wire",
         must_handle=("StaleSeqnumError", "StaleEpochError"),
         may_raise=("ConnectionError", "OSError", "TimeoutError", "ShmError",
                    "RuntimeError"),
         failpoint="rpc.recv",
         why="the wire degrade ladder itself: staging gaps (stale "
             "seqnum/epoch) terminate HERE via the synchronous "
             "restage-and-retry rungs; only transport/sidecar failures "
             "may surface to _finish_remote's host fallback"),
    Seam("karpenter_tpu_torch/solver/service.py", "TorchSolver", "_probe_sidecar",
         must_handle=("ConnectionError", "OSError", "TimeoutError",
                      "ShmError", "RuntimeError"),
         failpoint="rpc.client.connect",
         why="the breaker's half-open probe: any wire failure is data "
             "(probe failed), never an exception into the probe loop"),
    Seam("karpenter_tpu_torch/solver/breaker.py", "CircuitBreaker", "probe_now",
         must_handle=("ConnectionError", "OSError", "TimeoutError",
                      "ShmError", "RuntimeError"),
         failpoint="rpc.client.connect",
         why="the supervised-recovery entry: a probe callback failure "
             "re-opens the breaker instead of escaping"),
    # -- mid rungs: declared propagation to the rung above
    Seam("karpenter_tpu_torch/solver/rpc.py", "SolverClient", "_conn",
         may_raise=("ConnectionError", "OSError", "TimeoutError", "ShmError"),
         failpoint="rpc.client.connect",
         why="connection establishment: failures propagate into the "
             "roundtrip ladder's reconnect handling"),
    Seam("karpenter_tpu_torch/solver/rpc.py", "SolverClient", "_try_shm",
         must_handle=("ShmAttachError",),
         may_raise=("ConnectionError", "OSError", "TimeoutError"),
         failpoint="rpc.shm.attach",
         why="ring negotiation: every attach failure leaves the SOCKET "
             "stream intact (the shm->tcp degrade rung); only socket "
             "failures tear the connection down"),
    Seam("karpenter_tpu_torch/solver/rpc.py", "SolverClient", "_roundtrip",
         may_raise=("ConnectionError", "OSError", "TimeoutError", "ShmError"),
         failpoint="rpc.send",
         why="the synchronous request/response core: one reconnect retry, "
             "then the failure surfaces to the breaker-accounted caller"),
    Seam("karpenter_tpu_torch/solver/rpc.py", "SolverClient", "begin_solve_compact",
         may_raise=("ConnectionError", "OSError", "TimeoutError", "ShmError",
                    "RuntimeError"),
         failpoint="rpc.send",
         why="pipelined dispatch: a torn send closes the stream so the "
             "synchronous fallback reconnects onto a clean one"),
    Seam("karpenter_tpu_torch/solver/rpc.py", "SolverClient", "finish_solve_compact",
         may_raise=("ConnectionError", "OSError", "TimeoutError", "ShmError",
                    "StaleSeqnumError", "StaleEpochError", "RuntimeError"),
         failpoint="rpc.recv",
         why="pipelined claim: staging gaps surface as typed Stale* errors "
             "(no silent restage mid-pipeline); stream deaths as "
             "ConnectionError"),
    Seam("karpenter_tpu_torch/solver/rpc.py", "SolverClient", "_solve_op",
         may_raise=("ConnectionError", "OSError", "TimeoutError", "ShmError",
                    "RuntimeError"),
         failpoint="rpc.server.dispatch",
         why="the synchronous solve ladder (stage-if-needed + staging-gap "
             "retries): exhausted rungs surface RuntimeError to the "
             "breaker-accounted caller"),
    Seam("karpenter_tpu_torch/solver/rpc.py", "SolverClient", "_disrupt_roundtrip",
         may_raise=("ConnectionError", "OSError", "TimeoutError", "ShmError",
                    "RuntimeError"),
         failpoint="rpc.disrupt.dispatch",
         why="the consolidation solve's staging ladder, same contract as "
             "_solve_op"),
    Seam("karpenter_tpu_torch/solver/rpc.py", "SolverClient", "stage_catalog",
         may_raise=("ConnectionError", "OSError", "TimeoutError", "ShmError",
                    "RuntimeError"),
         failpoint="rpc.send",
         why="catalog staging rides the roundtrip ladder; a stage refusal "
             "is a RuntimeError the solve ladder above retries or degrades"),
    # -- shm framing: the ring's failure modes stay typed (ShmError family)
    Seam("karpenter_tpu_torch/solver/shm.py", "RingEndpoint", "sendmsg",
         may_raise=("ShmError", "OSError", "TimeoutError"),
         failpoint="rpc.shm.corrupt",
         why="ring send: peer-gone pre-send converts to ShmPeerGoneError "
             "(does not count toward the shm degrade ladder); wedged-peer "
             "timeouts surface as ShmSendTimeoutError"),
    Seam("karpenter_tpu_torch/solver/shm.py", "RingEndpoint", "recv_into",
         may_raise=("ShmError", "OSError", "TimeoutError"),
         failpoint="rpc.shm.corrupt",
         why="ring recv: closed/dead-peer states surface as ShmError so "
             "the client's stream ladder handles them as connection loss"),
    # -- server dispatch: errors cross the wire, never kill the connection loop
    Seam("karpenter_tpu_torch/solver/rpc.py", "SolverServer", "_dispatch",
         must_handle=("StaleSeqnumError", "StaleEpochError", "ValueError",
                      "KeyError"),
         may_raise=("ConnectionError", "OSError", "TimeoutError", "ShmError"),
         failpoint="rpc.server.dispatch",
         why="op dispatch: solver errors become error REPLIES (the client's "
             "ladder sees a typed refusal, not a dead sidecar); only "
             "transport failures may tear the connection down"),
    # -- convex tier: every fault lands on the FFD rung ----------------------
    # the convex candidate is strictly optional: a dispatch or rounding
    # fault costs the tick only that candidate, and the decision shipped
    # is the pure-FFD one, bit-identical to tier="ffd". Both seams catch
    # broad Exception ON PURPOSE (counted into
    # karpenter_convex_fallbacks_total + logged); OperatorCrashed is a
    # BaseException and still propagates through them.
    Seam("karpenter_tpu_torch/solver/service.py", "TorchSolver", "_dispatch_convex",
         must_handle=("ConnectionError", "OSError", "TimeoutError",
                      "RuntimeError", "ValueError"),
         failpoint="rpc.convex.dispatch",
         why="convex relax dispatch rides behind the fused FFD solve: a "
             "dispatch fault (device OOM, trace error, injected transport "
             "fault) nulls pending.cx and the finish barrier never sees a "
             "convex candidate -- counted as "
             "karpenter_convex_fallbacks_total{reason=dispatch}"),
    Seam("karpenter_tpu_torch/solver/service.py", "TorchSolver", "_finish_convex",
         must_handle=("ConnectionError", "OSError", "TimeoutError",
                      "RuntimeError", "ValueError"),
         failpoint="convex.rounding",
         why="the rounding rung: a fetch or deterministic-rounding fault "
             "(incl. the convex.rounding failpoint) yields dense_cx=None "
             "and choose() returns the FFD decision unchanged -- counted "
             "as karpenter_convex_fallbacks_total{reason=rounding}; no "
             "pod placement is ever lost to a convex-tier fault"),
)

# Handler sites sanctioned to absorb a crash (``OperatorCrashed``) or a
# bare ``except``/``BaseException`` without re-raising: ONLY the drivers
# that own the operator process. (rel, enclosing function) -> WHY.
# Shared verbatim with the runtime escape witness, so the static and
# dynamic passes bless exactly the same seams.
SANCTIONED_CRASH_SWALLOWS: Dict[Tuple[str, str], str] = {
    ("karpenter_tpu_torch/sim/replay.py", "do_tick"):
        "the replay engine IS the run-loop driver: a crash event abandons "
        "the operator mid-tick and _restart_operator brings up the next "
        "incarnation over the surviving cluster state (the crash-chaos "
        "soak's core loop)",
}

# Handler sites sanctioned to absorb a LADDER-CLASS exception at runtime
# (the escape witness's allowlist) beyond the LADDER_SEAMS functions
# themselves. (rel, enclosing function) -> WHY. Every entry is a
# designed absorption point whose silence is observable some other way
# (a metric, a log, an error reply, a recorded event).
SANCTIONED_ESCAPE_SITES: Dict[Tuple[str, str], str] = {
    ("karpenter_tpu_torch/controllers/provisioner.py", "launch_one"):
        "per-claim isolation on the launch fan-out: a CloudError becomes "
        "this claim's RETURN VALUE (recorded on the NodeClaim, counted), "
        "never an exception that kills the whole pool.map batch",
    ("karpenter_tpu_torch/controllers/provisioner.py", "_reconcile"):
        "a claim-level CloudError at bind/launch is recorded on the "
        "NodeClaim's status and retried by lifecycle, not re-raised into "
        "the tick",
    ("karpenter_tpu_torch/controllers/recovery.py", "sweep"):
        "per-intent isolation: a throttled cloud costs one intent's replay "
        "(logged + counted into karpenter_recovery_sweep_intents_total); "
        "OperatorCrashed still propagates (it is a BaseException)",
    ("karpenter_tpu_torch/controllers/recovery.py", "_terminate_half_launch"):
        "NotFoundError during a half-launch terminate means the instance "
        "is already gone -- exactly the recovery outcome wanted",
    ("karpenter_tpu_torch/controllers/recovery.py", "_replay_terminate"):
        "NotFoundError during a terminate replay: already terminated, "
        "the intent closes as done",
    ("karpenter_tpu_torch/controllers/garbagecollection.py", "reconcile"):
        "per-record isolation (logged, record stays open for the next "
        "pass) and already-gone instances (NotFoundError) closing as "
        "collected",
    ("karpenter_tpu_torch/controllers/interruption.py", "_process"):
        "per-message isolation: a handling failure publishes an "
        "InterruptionHandlingFailed event and deletes the message",
    ("karpenter_tpu_torch/controllers/termination.py", "reconcile"):
        "NotFoundError during termination means the instance is already "
        "gone: the node completes its drain",
    ("karpenter_tpu_torch/cloudprovider/cloudprovider.py", "is_drifted"):
        "NotFoundError while checking drift reads as 'drifted' (the "
        "backing instance vanished) -- the absorbing conversion is the "
        "contract",
    ("karpenter_tpu_torch/controllers/disruption.py", "_drift_reason"):
        "a CloudError while asking the provider about drift reads as "
        "'no drift verdict this tick' (None): the node stays put and the "
        "next reconcile retries -- disrupting on a throttled describe "
        "would be the bug",
    ("karpenter_tpu_torch/batcher/batcher.py", "_execute"):
        "the batch executor fans the error out to every waiter's future "
        "(set_exception): each caller re-raises it at result() -- the "
        "witness sees the waiter-side re-raise resolve most of these, "
        "but a shed waiter that timed out leaves the error unclaimed",
    ("karpenter_tpu_torch/solver/rpc.py", "handle"):
        "the server's per-connection loop: a dead/corrupt stream "
        "(ConnectionError family, incl. ShmError) ENDS the connection -- "
        "the client's degrade ladder owns retry; re-raising would only "
        "kill the handler thread noisily",
    ("karpenter_tpu_torch/solver/service.py", "solve_begin"):
        "dispatch-time wire failure on the pipelined begin: rpc_handle "
        "stays None and the barrier's synchronous ladder (reconnect, "
        "restage, CPU fallback) owns degradation -- counted via "
        "karpenter_scheduler_pipeline_fallbacks_total at the finish",
}


# -- exception hierarchy ------------------------------------------------------

# the builtin slice the wire ladder can meet (parents, not full CPython)
_BUILTIN_PARENTS: Dict[str, Tuple[str, ...]] = {
    "BaseException": (),
    "Exception": ("BaseException",),
    "KeyboardInterrupt": ("BaseException",),
    "SystemExit": ("BaseException",),
    "GeneratorExit": ("BaseException",),
    "ArithmeticError": ("Exception",),
    "ZeroDivisionError": ("ArithmeticError",),
    "OverflowError": ("ArithmeticError",),
    "AssertionError": ("Exception",),
    "AttributeError": ("Exception",),
    "BufferError": ("Exception",),
    "EOFError": ("Exception",),
    "ImportError": ("Exception",),
    "ModuleNotFoundError": ("ImportError",),
    "LookupError": ("Exception",),
    "IndexError": ("LookupError",),
    "KeyError": ("LookupError",),
    "MemoryError": ("Exception",),
    "NameError": ("Exception",),
    "OSError": ("Exception",),
    "ConnectionError": ("OSError",),
    "BrokenPipeError": ("ConnectionError",),
    "ConnectionAbortedError": ("ConnectionError",),
    "ConnectionRefusedError": ("ConnectionError",),
    "ConnectionResetError": ("ConnectionError",),
    "BlockingIOError": ("OSError",),
    "ChildProcessError": ("OSError",),
    "FileExistsError": ("OSError",),
    "FileNotFoundError": ("OSError",),
    "InterruptedError": ("OSError",),
    "IsADirectoryError": ("OSError",),
    "NotADirectoryError": ("OSError",),
    "PermissionError": ("OSError",),
    "ProcessLookupError": ("OSError",),
    "TimeoutError": ("OSError",),
    "ReferenceError": ("Exception",),
    "RuntimeError": ("Exception",),
    "NotImplementedError": ("RuntimeError",),
    "RecursionError": ("RuntimeError",),
    "StopIteration": ("Exception",),
    "StopAsyncIteration": ("Exception",),
    "SyntaxError": ("Exception",),
    "SystemError": ("Exception",),
    "TypeError": ("Exception",),
    "ValueError": ("Exception",),
    "UnicodeError": ("ValueError",),
}

# dotted spellings that alias a builtin (socket.timeout IS TimeoutError
# since 3.10; socket.error is OSError)
_DOTTED_ALIASES = {"timeout": "TimeoutError", "error": "OSError",
                   "herror": "OSError", "gaierror": "OSError"}

# the ladder name set: escapes of these (or their subclasses) are what
# the seam rules judge; anything else (ValueError on a malformed header,
# KeyError in a parser) is out of the wire ladder's scope
LADDER_CLASSES: Tuple[str, ...] = (
    "ConnectionError", "OSError", "TimeoutError", "ShmError",
    "StaleSeqnumError", "StaleEpochError", "StaleTopologyError",
    "OperatorCrashed", "CloudError", "RuntimeError",
)

# what an armed failpoints.eval() site can inject, by site-name prefix
# (error actions resolve builtin + cloud taxonomy classes; crash raises
# OperatorCrashed; the stall action can surface the watchdog's
# async-raised OperatorCrashed mid-stall): a seam containing a failpoint
# site must statically account for these. Wire sites inject transport
# faults, cloud-call sites inject the CloudError taxonomy, crash/stall
# sites inject the process death.
FAILPOINT_INJECTS: Dict[str, Tuple[str, ...]] = {
    "rpc.": ("ConnectionError", "OSError", "TimeoutError", "OperatorCrashed"),
    "solver.": ("ConnectionError", "OSError", "TimeoutError",
                "OperatorCrashed"),
    "instance.": ("CloudError", "ConnectionError", "OSError",
                  "OperatorCrashed"),
    "batcher.": ("CloudError", "ConnectionError", "OSError",
                 "OperatorCrashed"),
    "crash.": ("OperatorCrashed",),
    "stall.": ("OperatorCrashed",),
    # convex-tier sites inject generic compute faults (a poisoned rounding
    # pass surfaces as RuntimeError/ValueError) plus the crash rung
    "convex.": ("RuntimeError", "ValueError", "OperatorCrashed"),
}

# socket-object verbs whose calls seed OSError (the stdlib raises these;
# no `raise` statement exists in the tree for the checker to see)
_SOCKET_VERBS = frozenset({
    "connect", "accept", "recv", "recv_into", "recvmsg", "send", "sendall",
    "sendmsg", "shutdown", "wrap_socket", "create_connection", "makefile",
})

# functions whose bodies this pass cannot see deeply enough (C-level IO,
# dynamic dispatch) declared as raise sources: (modname, cls, func) ->
# classes. Same spirit as STATIC_ARG_BUCKETS: an explicit, test-pinned
# manifest instead of a silent gap.
RAISE_SOURCES: Dict[Tuple[str, str, str], Tuple[str, ...]] = {
    ("solver.rpc", "", "_send_frame"): ("ConnectionError", "OSError"),
    ("solver.rpc", "", "_recv_frame"): ("ConnectionError", "OSError"),
    ("solver.rpc", "", "_recv_exact"): ("ConnectionError", "OSError"),
    ("solver.rpc", "", "_recv_exact_into"): ("ConnectionError", "OSError"),
    ("solver.rpc", "", "_sendmsg_all"): ("ConnectionError", "OSError"),
}


class Hierarchy:
    """Exception-class hierarchy: builtins merged with every package
    class whose bases resolve (transitively) to an exception."""

    def __init__(self) -> None:
        self.parents: Dict[str, Tuple[str, ...]] = dict(_BUILTIN_PARENTS)
        # the crash contract is a constant of the checker, not of whatever
        # module list happens to be scanned: OperatorCrashed IS a
        # BaseException even when failpoints.py is outside the scan scope
        # (fixture runs); the real tree's discovery re-adds it identically
        self.parents["OperatorCrashed"] = ("BaseException",)
        self._anc: Dict[str, FrozenSet[str]] = {}

    def add(self, name: str, bases: Tuple[str, ...]) -> None:
        self.parents[name] = bases
        self._anc.clear()

    def known(self, name: str) -> bool:
        return name in self.parents

    def ancestors(self, name: str) -> FrozenSet[str]:
        """name and everything above it (multiple inheritance unioned)."""
        hit = self._anc.get(name)
        if hit is not None:
            return hit
        self._anc[name] = frozenset((name,))  # cycle guard
        out = {name}
        for p in self.parents.get(name, ()):
            out |= self.ancestors(p)
        self._anc[name] = frozenset(out)
        return self._anc[name]

    def catches(self, handler: str, raised: str) -> bool:
        """True when `except handler` absorbs a raised `raised`."""
        return handler in self.ancestors(raised)

    def is_ladder(self, name: str) -> bool:
        anc = self.ancestors(name)
        return any(lc in anc for lc in LADDER_CLASSES)


# -- module collection --------------------------------------------------------


@dataclass
class _FnInfo:
    node: ast.AST
    modname: str
    clsname: str  # "" for module functions


@dataclass
class _ModInfo:
    mod: Module
    modname: str
    imports: Dict[str, str] = field(default_factory=dict)
    from_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    functions: Dict[str, ast.AST] = field(default_factory=dict)
    classes: Dict[str, Dict[str, ast.AST]] = field(default_factory=dict)


def _modname(rel: str) -> str:
    name = rel[:-3] if rel.endswith(".py") else rel
    name = name.replace("/", ".")
    if name.startswith("karpenter_tpu_torch."):
        name = name[len("karpenter_tpu_torch."):]
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def _collect(mod: Module) -> _ModInfo:
    info = _ModInfo(mod=mod, modname=_modname(mod.rel))
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                info.imports[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                info.from_imports[a.asname or a.name] = (node.module, a.name)
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.functions[node.name] = node
        elif isinstance(node, ast.ClassDef):
            methods = {}
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods[item.name] = item
                elif isinstance(item, ast.ClassDef):
                    # one level of nesting (handler classes inside
                    # factories): methods keyed under the inner class too
                    for sub in item.body:
                        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            methods.setdefault(sub.name, sub)
            info.classes[node.name] = methods
    return info


# -- the analyzer -------------------------------------------------------------


class ExcAnalyzer:
    def __init__(self, modules: List[Module]):
        self.infos: Dict[str, _ModInfo] = {}
        for m in modules:
            info = _collect(m)
            self.infos[info.modname] = info
        self.hier = Hierarchy()
        self._build_hierarchy()
        # unique-name resolution index: method/function name -> owners
        self._by_name: Dict[str, List[Tuple[str, str, str]]] = {}
        for modname, info in self.infos.items():
            for fname in info.functions:
                self._by_name.setdefault(fname, []).append((modname, "", fname))
            for cname, methods in info.classes.items():
                for fname in methods:
                    self._by_name.setdefault(fname, []).append(
                        (modname, cname, fname))
        self._escapes: Dict[Tuple[str, str, str], FrozenSet[str]] = {}

    def _build_hierarchy(self) -> None:
        # package exception classes: a ClassDef is an exception when its
        # base chain reaches a known exception name (iterate to fixed
        # point so A(B), B(ShmError) both land)
        pending: List[Tuple[str, Tuple[str, ...]]] = []
        for info in self.infos.values():
            for node in ast.walk(info.mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                bases = []
                for b in node.bases:
                    d = _dotted(b)
                    if d:
                        bases.append(d.rsplit(".", 1)[-1])
                if bases:
                    pending.append((node.name, tuple(bases)))
        changed = True
        while changed:
            changed = False
            rest = []
            for name, bases in pending:
                if any(self.hier.known(b) for b in bases):
                    known = tuple(b for b in bases if self.hier.known(b))
                    if not self.hier.known(name) or \
                            self.hier.parents.get(name) != known:
                        self.hier.add(name, known)
                        changed = True
                else:
                    rest.append((name, bases))
            pending = rest

    # -- name resolution ------------------------------------------------------
    def exc_name(self, info: _ModInfo, expr: ast.AST) -> Optional[str]:
        """The exception CLASS a raise/handler expression names, or None
        when it is not confidently a known class."""
        if isinstance(expr, ast.Call):
            expr = expr.func
        d = _dotted(expr)
        if d is None:
            return None
        last = d.rsplit(".", 1)[-1]
        if "." in d and last in _DOTTED_ALIASES:
            last = _DOTTED_ALIASES[last]
        return last if self.hier.known(last) else None

    def resolve_callee(self, info: _ModInfo, clsname: str,
                       call: ast.Call) -> Optional[Tuple[str, str, str]]:
        f = call.func
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name):
                if f.value.id == "self" and clsname:
                    methods = self.infos[info.modname].classes.get(clsname, {})
                    if f.attr in methods:
                        return (info.modname, clsname, f.attr)
                mod = info.imports.get(f.value.id)
                if mod:
                    target = _strip_pkg(mod)
                    other = self.infos.get(target)
                    if other and f.attr in other.functions:
                        return (target, "", f.attr)
            # duck-typed receiver (self.client.X, wire.X, sock.X): when
            # exactly one package class defines the method, resolve to it
            owners = self._by_name.get(f.attr, ())
            if len(owners) == 1:
                return owners[0]
            return None
        if isinstance(f, ast.Name):
            if f.id in info.functions:
                return (info.modname, "", f.id)
            src = info.from_imports.get(f.id)
            if src:
                target = _strip_pkg(src[0])
                other = self.infos.get(target)
                if other and src[1] in other.functions:
                    return (target, "", src[1])
        return None

    # -- escape sets ----------------------------------------------------------
    def escapes(self, modname: str, clsname: str, fname: str) -> FrozenSet[str]:
        out, _ = self._escape(modname, clsname, fname, set())
        return out

    def _escape(self, modname: str, clsname: str, fname: str,
                stack: Set[Tuple[str, str, str]]
                ) -> Tuple[FrozenSet[str], bool]:
        """(escape classes, complete). Same memoization discipline as the
        lock checker's footprints: only complete (non-cycle-truncated)
        results cache."""
        key = (modname, clsname, fname)
        if key in self._escapes:
            return self._escapes[key], True
        if key in stack:
            return frozenset(), False
        if key in RAISE_SOURCES:
            out = frozenset(RAISE_SOURCES[key])
            self._escapes[key] = out
            return out, True
        info = self.infos.get(modname)
        fn = None
        if info is not None:
            if clsname:
                fn = info.classes.get(clsname, {}).get(fname)
            else:
                fn = info.functions.get(fname)
        if fn is None:
            return frozenset(), True
        stack.add(key)
        out: Set[str] = set()
        complete = [True]

        def emit(name: str, guards: List[Tuple[str, ...]]) -> None:
            for g in guards:
                if any(self.hier.catches(h, name) for h in g):
                    return
            out.add(name)

        def call_escapes(node: ast.Call, guards, caught) -> None:
            d = _dotted(node.func)
            if d:
                parts = d.split(".")
                if parts[-1] in ("eval", "corrupt") and \
                        parts[0] in ("failpoints", "FAILPOINTS"):
                    site = ""
                    if node.args and isinstance(node.args[0], ast.Constant) \
                            and isinstance(node.args[0].value, str):
                        site = node.args[0].value
                    for prefix, injects in FAILPOINT_INJECTS.items():
                        if site.startswith(prefix):
                            for n in injects:
                                emit(n, guards)
                            break
                    return
                if parts[-1] in _SOCKET_VERBS and len(parts) > 1:
                    emit("OSError", guards)
            callee = self.resolve_callee(info, clsname, node)
            if callee is not None:
                sub, ok = self._escape(callee[0], callee[1], callee[2], stack)
                complete[0] = complete[0] and ok
                for n in sub:
                    emit(n, guards)

        def walk(node: ast.AST, guards: List[Tuple[str, ...]],
                 caught: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return  # nested defs don't run here
            if isinstance(node, ast.Try):
                handler_names: List[str] = []
                for h in node.handlers:
                    handler_names.extend(_handler_names(self, info, h))
                inner = guards + [tuple(handler_names)] if handler_names \
                    else guards
                for s in node.body:
                    walk(s, inner, caught)
                for h in node.handlers:
                    hnames = tuple(_handler_names(self, info, h))
                    for s in h.body:
                        walk(s, guards, hnames or ("BaseException",))
                for s in node.orelse:   # NOT protected by the handlers
                    walk(s, guards, caught)
                for s in node.finalbody:
                    walk(s, guards, caught)
                return
            if isinstance(node, ast.Raise):
                if node.exc is None:
                    for n in caught:
                        emit(n, guards)
                else:
                    name = self.exc_name(info, node.exc)
                    if name is not None:
                        emit(name, guards)
                    elif isinstance(node.exc, ast.Name) and caught:
                        # `raise e` re-raising the caught variable
                        for n in caught:
                            emit(n, guards)
                if isinstance(node.exc, ast.Call):
                    call_escapes(node.exc, guards, caught)
                return
            if isinstance(node, ast.Call):
                call_escapes(node, guards, caught)
            for child in ast.iter_child_nodes(node):
                walk(child, guards, caught)

        for stmt in getattr(fn, "body", ()):
            walk(stmt, [], ())
        stack.discard(key)
        result = frozenset(out)
        if complete[0]:
            self._escapes[key] = result
        return result, complete[0]


def _handler_names(an: ExcAnalyzer, info: _ModInfo,
                   handler: ast.ExceptHandler) -> List[str]:
    """The class names one except clause catches; bare except ->
    BaseException; an UNRESOLVABLE name catches nothing -- the sound
    direction: a third-party class the hierarchy cannot place must not
    be credited with absorbing ladder escapes (escapes over-approximate,
    never under)."""
    t = handler.type
    if t is None:
        return ["BaseException"]
    exprs = t.elts if isinstance(t, ast.Tuple) else [t]
    names = []
    for e in exprs:
        n = an.exc_name(info, e)
        if n is not None:
            names.append(n)
    return names


def _strip_pkg(module: str) -> str:
    if module.startswith("karpenter_tpu_torch."):
        return module[len("karpenter_tpu_torch."):]
    return module


# -- the graph dump (--graph --family errflow) --------------------------------


def exception_graph(modules: List[Module],
                    analyzer: Optional[ExcAnalyzer] = None) -> dict:
    an = analyzer or ExcAnalyzer(modules)
    seams = {}
    for seam in LADDER_SEAMS:
        esc = sorted(an.escapes(_modname(seam.rel), seam.cls or "", seam.func))
        seams[seam.key] = {
            "escapes": esc,
            "ladder_escapes": sorted(n for n in esc if an.hier.is_ladder(n)),
            "must_handle": sorted(seam.must_handle),
            "may_raise": sorted(seam.may_raise),
            "failpoint": seam.failpoint,
        }
    classes = {
        name: sorted(parents)
        for name, parents in sorted(an.hier.parents.items())
        if name not in _BUILTIN_PARENTS
    }
    return {"seams": seams, "classes": classes}


# -- rules --------------------------------------------------------------------


_LOG_VERBS = frozenset({"warning", "error", "exception", "info", "debug",
                        "critical", "log"})
_METRIC_VERBS = frozenset({"inc", "observe", "set"})
_FORWARD_VERBS = frozenset({"publish", "set_exception", "record_failure"})


def _handler_is_silent(an: ExcAnalyzer, info: _ModInfo,
                       handler: ast.ExceptHandler) -> bool:
    """True when the handler body neither re-raises, converts to a typed
    error (raise or return of an exception construction), counts into a
    metric, logs, nor forwards the error object."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Call):
            n = an.exc_name(info, node.value)
            if n is not None:
                return False
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _METRIC_VERBS or attr in _LOG_VERBS \
                    or attr in _FORWARD_VERBS:
                return False
    return False if not handler.body else True


def _enclosing_functions(tree: ast.AST) -> Dict[int, str]:
    """Map each statement's id() -> name of its enclosing function (the
    witness-manifest granularity)."""
    owner: Dict[int, str] = {}

    def mark(node: ast.AST, name: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mark(child, child.name)
            else:
                owner[id(child)] = name
                mark(child, name)

    mark(tree, "<module>")
    return owner


def check(modules: List[Module],
          analyzer: Optional[ExcAnalyzer] = None) -> List[Violation]:
    an = analyzer or ExcAnalyzer(modules)
    out: List[Violation] = []
    by_rel = {m.rel: m for m in modules}

    # -- seam rules
    for seam in LADDER_SEAMS:
        mod = by_rel.get(seam.rel)
        if mod is None:
            continue  # partial module lists (fixtures) skip absent seams
        modname = _modname(seam.rel)
        info = an.infos[modname]
        fn = info.classes.get(seam.cls, {}).get(seam.func) if seam.cls \
            else info.functions.get(seam.func)
        if fn is None:
            out.append(mod.violation(
                "errflow/seam-missing", 1,
                f"LADDER_SEAMS names {seam.key} but the function does not "
                "exist: a rename silently unguards the seam"))
            continue
        esc = an.escapes(modname, seam.cls or "", seam.func)
        ladder_esc = {n for n in esc if an.hier.is_ladder(n)}
        for n in sorted(ladder_esc):
            if "OperatorCrashed" in an.hier.ancestors(n):
                # the ONE ladder class every seam must let through: a
                # crash propagates to the run-loop driver by contract
                # (swallow-crash polices the opposite direction)
                continue
            hit = [m for m in seam.must_handle if an.hier.catches(m, n)]
            if hit:
                out.append(mod.violation(
                    "errflow/seam-ladder-escape", fn.lineno,
                    f"{seam.key}: {n} can escape this seam, but the ladder "
                    f"contract says it must be handled here "
                    f"(must_handle={hit[0]}): a wire failure would leak "
                    "past the degrade ladder"))
            elif seam.may_raise and not any(
                    an.hier.catches(d, n) for d in seam.may_raise):
                out.append(mod.violation(
                    "errflow/seam-undeclared-escape", fn.lineno,
                    f"{seam.key}: ladder-class {n} can escape but is not in "
                    "the seam's may_raise declaration: an error routed "
                    "outside the breaker's accounting"))

    # -- handler rules (whole package)
    for info in an.infos.values():
        mod = info.mod
        owner = _enclosing_functions(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Try) and node.finalbody:
                for sub in node.finalbody:
                    for inner in ast.walk(sub):
                        if isinstance(inner, (ast.Return, ast.Break,
                                              ast.Continue)):
                            # a break/continue whose loop is INSIDE the
                            # finally does not swallow
                            if isinstance(inner, (ast.Break, ast.Continue)) \
                                    and _loop_inside(sub, inner):
                                continue
                            out.append(mod.violation(
                                "errflow/return-in-finally", inner.lineno,
                                "return/break/continue inside a finally "
                                "block silently swallows any in-flight "
                                "exception (including OperatorCrashed)"))
            if not isinstance(node, ast.ExceptHandler):
                continue
            names = _handler_names(an, info, node)
            fname = owner.get(id(node), "<module>")
            # rule: a handler that can catch OperatorCrashed must re-raise
            can_catch_crash = any(
                an.hier.catches(n, "OperatorCrashed") for n in names)
            if can_catch_crash and not any(
                    isinstance(s, ast.Raise) for s in ast.walk(node)):
                if (mod.rel, fname) not in SANCTIONED_CRASH_SWALLOWS:
                    out.append(mod.violation(
                        "errflow/swallow-crash", node.lineno,
                        f"handler in {fname}() can swallow OperatorCrashed "
                        "(a process death would become a handled error); "
                        "re-raise it, narrow the except, or add the site "
                        "to SANCTIONED_CRASH_SWALLOWS with a WHY"))
            # rule: broad `except Exception` must not be silent
            if node.type is not None and names == ["Exception"] \
                    and an.exc_name(info, node.type) == "Exception":
                if _handler_is_silent(an, info, node):
                    out.append(mod.violation(
                        "errflow/broad-swallow", node.lineno,
                        f"broad `except Exception` in {fname}() neither "
                        "re-raises, converts to a typed error, counts a "
                        "metric, logs, nor forwards the error: a silent "
                        "absorption point no operator can observe"))
    return out


def _loop_inside(root: ast.AST, target: ast.AST) -> bool:
    """True when `target` (a break/continue) sits inside a loop that is
    itself inside `root` -- such a jump never leaves the finally."""
    found = [False]

    def walk(node: ast.AST, in_loop: bool) -> None:
        if node is target:
            found[0] = found[0] or in_loop
            return
        enter = in_loop or isinstance(node, (ast.For, ast.While,
                                             ast.AsyncFor))
        for child in ast.iter_child_nodes(node):
            walk(child, enter)

    walk(root, False)
    return found[0]
