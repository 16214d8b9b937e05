"""Zero-copy wire checker: the ``payload_copies == 0`` contract, static.

Copy of karpenter_tpu/analysis/checkers/zerocopy.py; ``HOT_PATH`` names
the port's own framing functions in solver/rpc.py and solver/shm.py.

Wire v2 (docs/performance.md) made the framing layer zero-copy
end to end: scatter-gather sends over memoryviews, receives straight
into the tensor's own allocation. The runtime guard is the
``karpenter_wire_payload_copies_total`` counter asserted 0 on the warm
delta path -- but that only fires when a test drives the path. This
checker rejects copying constructs the moment they appear in the
framing hot-path functions.

Scope is an EXPLICIT manifest (``HOT_PATH``): the send/recv framing in
solver/rpc.py and the ring endpoint in solver/shm.py. Out-of-scope
copies in the same files (connection setup, attach validation, the
``recv()`` compat shim) are once-per-connection costs, not per-frame.

Rule ``zerocopy/copy-construct`` fires on, inside a hot-path function:

- ``X.tobytes()`` / ``X.copy()`` / ``np.copy(...)``
- ``bytes(expr)`` with a non-size argument (``bytes(view)`` copies;
  ``bytes(n)``/``bytearray(n)`` preallocate and are allowed)
- ``b"".join(...)`` (or any bytes-literal ``.join``): the joining copy
  the scatter-gather send exists to avoid

Intentional, metric-counted copies (the TLS join fallback, the
corrupt-drill join) are baseline entries -- each justified next to the
counter increment that keeps it honest.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.analysis.base import Module, Violation

# module rel-path -> (function names, class whose methods are in scope)
HOT_PATH: Dict[str, Tuple[Tuple[str, ...], Dict[str, Tuple[str, ...]]]] = {
    "karpenter_tpu_torch/solver/rpc.py": (
        ("_payload_views", "_sendmsg_all", "_send_frame",
         "_recv_exact", "_recv_exact_into", "_recv_frame"),
        {},
    ),
    "karpenter_tpu_torch/solver/shm.py": (
        (),
        # recv() is the compat shim for handshake-sized reads, not the
        # framing path (the framing layer always calls recv_into)
        {"RingEndpoint": ("_write_buf", "sendmsg", "sendall", "recv_into")},
    ),
}

RULE = "zerocopy/copy-construct"


def _is_size_arg(node: ast.AST) -> bool:
    """bytes(n)/bytearray(n) preallocation: an int-ish size expression.
    Constants, plain names, min/max/len arithmetic -- anything that is
    clearly a count, not a buffer."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int)
    if isinstance(node, ast.Name):
        return True  # bytes(n) with a name: sizes are names; buffers are too,
        # but buffer names feeding bytes() on the hot path are exactly
        # what line-level review should catch -- keep the rule on the
        # unambiguous cases and let the runtime counter own the rest
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("min", "max", "len", "int")
    if isinstance(node, ast.BinOp):
        return True  # arithmetic over sizes
    return False


def _scan_function(mod: Module, fn: ast.AST, where: str) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "tobytes":
                out.append(mod.violation(RULE, node,
                                         f"{where}: .tobytes() copies the payload; "
                                         "send the memoryview"))
            elif f.attr == "copy":
                out.append(mod.violation(RULE, node,
                                         f"{where}: .copy() on the framing path"))
            elif f.attr == "join" and isinstance(f.value, ast.Constant) \
                    and isinstance(f.value.value, (bytes, str)):
                out.append(mod.violation(RULE, node,
                                         f"{where}: joining copy on the framing path; "
                                         "scatter-gather the buffers instead"))
        elif isinstance(f, ast.Name) and f.id == "bytes" and node.args:
            if not _is_size_arg(node.args[0]):
                out.append(mod.violation(RULE, node,
                                         f"{where}: bytes(buffer) copies; pass the "
                                         "buffer/memoryview through"))
    return out


def check(modules: List[Module]) -> List[Violation]:
    out: List[Violation] = []
    by_rel = {m.rel: m for m in modules}
    for rel, (func_names, class_methods) in HOT_PATH.items():
        mod = by_rel.get(rel)
        if mod is None:
            continue
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in func_names:
                out.extend(_scan_function(mod, node, node.name))
            elif isinstance(node, ast.ClassDef) and node.name in class_methods:
                wanted = class_methods[node.name]
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and item.name in wanted:
                        out.extend(_scan_function(
                            mod, item, f"{node.name}.{item.name}"))
    return out


def hot_path_functions(rel: str) -> Optional[Tuple[Tuple[str, ...], Dict[str, Tuple[str, ...]]]]:
    """Manifest lookup for the docs/tests (the scope is part of the
    contract: a new framing function must be ADDED here to be guarded)."""
    return HOT_PATH.get(rel)
