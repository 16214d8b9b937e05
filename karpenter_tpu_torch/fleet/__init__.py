"""Fleet subsystem: one H100 as the scheduling brain of a fleet.

Copy of karpenter_tpu/fleet/__init__.py over the port, single-device
half only:

- ``fleet/coalesce.py`` -- the multi-tenant dispatch coalescer: the rpc
  sidecar already stages catalogs under per-connection seqnums; the
  coalescer batches concurrent solves from N operator replicas into
  shared device dispatch windows with deterministic tenant ordering,
  per-tenant deadline budgets feeding the existing overload ladder, and
  a per-tenant breaker/degrade so one sick cluster never poisons
  another. ``multi-tenant == isolated`` is asserted via differential sim
  replay (``sim/fleet.py``, the ``multi-cluster-storm`` corpus scenario).

``fleet/service.py`` glues it into a deployable sidecar topology.

Not here yet (ROADMAP A11b): the mesh-sharded production solve
(``fleet/shard.py``: ``MeshSolveEngine``, ``mesh_from_env``,
``parse_mesh_spec``), its failure ladder (``fleet/topology.py``:
``TopologyTracker``, ``classify_device_error``; ``fleet/straggler.py``:
``ShardStragglerWatchdog``) and ``parallel/mesh.py``. Each exists only
across several devices.
"""
from karpenter_tpu_torch.fleet.coalesce import DispatchCoalescer, TenantRefusal

__all__ = [
    "DispatchCoalescer",
    "TenantRefusal",
]
