"""Fleet service glue: the multi-cluster solver sidecar, assembled.

One solver process serves N operator replicas ("tenants" -- one per
cluster): the rpc server stages each tenant's catalogs/epochs under its
own ids, the DispatchCoalescer batches their concurrent solves into
shared device dispatch windows, and (when a mesh is configured) every
dispatch runs the mesh-sharded entries (fleet/shard.py). Tenant sizing reads the live device
memory ledger when one exists (tenant_staged_bytes: the resident
packed-mask staging). This module is the small assembly layer over
`SolverServer(mesh=, coalescer=)` -- the same shape the binary exposes as
`python -m karpenter_tpu_torch.solver.rpc --coalesce --mesh ... --tenant-budget ...`
-- shared by the sim fleet replay (sim/fleet.py) and ad-hoc embedders.

Sizing (docs/operations.md "Multi-tenant runbook"): each tenant's staged
state is bounded by the server's LRUs (4 catalogs + 4 class epochs + 4
disrupt epochs per process-wide store, pressure-evicted below the
headroom threshold), so tenant count is sized from measured headroom --
`max_tenants_for_headroom` is that arithmetic, fed by obs/hbm.py's
ledger (`torch.cuda.mem_get_info` and the caching allocator's figures on
the card; nothing on the CPU).

Copy of karpenter_tpu/fleet/service.py over the port. `device=` passes
through to the server (None = the card); a `$KARPENTER_TPU_MESH` spec
counts that device's kind (fleet/shard.py parse_mesh_spec).
"""
from __future__ import annotations

import os
from typing import Optional

from karpenter_tpu_torch.fleet.coalesce import DispatchCoalescer
from karpenter_tpu_torch.fleet.shard import (MESH_ENV, MeshSolveEngine, mesh_from_env,
                                             parse_mesh_spec)
from karpenter_tpu_torch.logging import get_logger
from karpenter_tpu_torch.obs import hbm as obs_hbm

__all__ = ["MESH_ENV", "build_fleet_server", "max_tenants_for_headroom", "tenant_staged_bytes"]

# fallback per-tenant footprint when no live ledger is available: the
# packed-mask staging profile (catalog ~1.6 MB + class epoch ~0.4 MB with
# the open/join masks bit-packed + headroom for one in-flight solve's
# temporaries); deliberately rounded UP -- sizing must err toward fewer
# tenants
TENANT_STAGED_BYTES_FALLBACK = 6 * 1024 * 1024

# in-flight multiplier over the ledger's resident bytes: a tenant's
# steady-state staging plus one dispatch's transient copies (the staged
# epoch being replaced lingers until the LRU drops it)
_LIVE_SIZING_HEADROOM = 2


def tenant_staged_bytes(solver=None) -> int:
    """Per-tenant resident staging footprint for sizing. With a live
    solver, reads its ledger (TorchSolver.staged_bytes_by_kind: catalog +
    class_masks + solve_temporaries -- the PACKED mask bytes, i.e. what
    is actually resident, not the full-width equivalent) and doubles it
    for in-flight headroom; an empty ledger or no solver falls back to
    the static profile. Never returns below the fallback -- a one-tenant
    measurement must not oversell capacity."""
    if solver is not None:
        try:
            kinds = solver.staged_bytes_by_kind()
        except Exception as e:  # noqa: BLE001 - sizing must never raise
            get_logger("fleet").warning(
                "tenant sizing: ledger read failed; using static fallback",
                error=f"{type(e).__name__}: {e}"[:200],
            )
            kinds = {}
        live = (
            int(kinds.get("catalog", 0))
            + int(kinds.get("class_masks", 0))
            + int(kinds.get("solve_temporaries", 0))
        )
        if live > 0:
            return max(_LIVE_SIZING_HEADROOM * live, TENANT_STAGED_BYTES_FALLBACK)
    return TENANT_STAGED_BYTES_FALLBACK


def max_tenants_for_headroom(
    headroom_bytes: Optional[int] = None,
    per_tenant_bytes: Optional[int] = None,
    reserve_fraction: float = 0.5,
    solver=None,
    engine=None,
) -> Optional[int]:
    """How many tenants the measured device headroom supports, keeping
    `reserve_fraction` of it free for solve temporaries and kernel
    workspace. Per-tenant bytes come from the live ledger when a
    `solver` is passed (tenant_staged_bytes), else the static fallback;
    an explicit `per_tenant_bytes` overrides both. None when no device
    ledger exists (a process that solved on the CPU) -- capacity is then
    bounded by the LRUs alone, and the operator sizes from the runbook's
    table instead.

    TOPOLOGY-AWARE when `engine` (the MeshSolveEngine) is passed: the
    headroom is read at call time on the device the engine stages on
    now (its primary: the current mesh's first shard, or the first
    healthy device on the unsharded rung), so an epoch bump that moves
    the primary moves the sizing with it. Unlike the JAX package, whose
    mesh spreads each tenant's staging over the shards and piles it onto
    the survivors after a loss (there per-tenant bytes scale by
    size/healthy), the port stages the catalog whole on the primary and
    the shards read views of it: losing a shard changes no device's
    staging, so the per-tenant bytes stay as measured."""
    if per_tenant_bytes is None:
        per_tenant_bytes = tenant_staged_bytes(solver)
    if headroom_bytes is None:
        devices = obs_hbm.poll().get("devices") or {}
        if engine is not None and getattr(engine, "topology", None) is not None:
            # only the primary holds the staging; a label that names no
            # polled device (label scheme drift, fake provider) falls
            # back to the unfiltered set -- sizing must degrade, not
            # vanish
            dev = engine.device
            label = f"{dev.type}:{0 if dev.index is None else dev.index}"
            devices = {k: v for k, v in devices.items() if k == label} or devices
        free = [
            int(d["bytes_limit"]) - int(d["bytes_in_use"])
            for d in devices.values()
            if int(d.get("bytes_limit", 0)) > 0
        ]
        if not free:
            return None
        headroom_bytes = min(free)
    usable = int(headroom_bytes * (1.0 - reserve_fraction))
    return max(usable // int(per_tenant_bytes), 0)


def build_fleet_server(
    *, path: Optional[str] = None, host: str = "127.0.0.1", port: int = 0,
    token: Optional[str] = None, insecure_tcp: bool = False,
    mesh=None, coalesce: bool = True,
    tenant_budget_s: float = 0.0, window_s: Optional[float] = None,
    device=None, **server_kw,
):
    """A started SolverServer wired for the fleet topology: the dispatch
    coalescer on (deterministic tenant ordering, per-tenant breaker and
    deadline budget) on `device` (None = the card) and, when `mesh` (or
    $KARPENTER_TPU_MESH) names a layout, the mesh-sharded solve engine.
    `mesh=None` consults the environment; any other falsy value (False,
    0, "") pins the single-device path regardless of it -- deterministic
    gates must not take hidden configuration. Returns the running
    server; callers own stop()."""
    from karpenter_tpu_torch.solver.rpc import SolverServer

    kind = "cuda" if device is None else device
    if mesh is None:
        mesh = mesh_from_env(kind)
    elif isinstance(mesh, str):
        # a spec counts real devices of the server's kind
        mesh = parse_mesh_spec(mesh, kind)
    engine = None
    if mesh:
        engine = mesh if isinstance(mesh, MeshSolveEngine) else MeshSolveEngine(mesh)
    coalescer = None
    if coalesce:
        kw = {"budget_s": tenant_budget_s}
        if window_s is not None:
            kw["window_s"] = window_s
        coalescer = DispatchCoalescer(**kw)
    server = SolverServer(
        host, port, path=path, token=token, insecure_tcp=insecure_tcp,
        mesh=engine, coalescer=coalescer, device=device, **server_kw,
    )
    return server.start()
