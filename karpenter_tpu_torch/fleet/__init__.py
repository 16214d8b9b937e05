"""Fleet subsystem: one H100 (or several) as the scheduling brain of a fleet.

Copy of karpenter_tpu/fleet/__init__.py over the port. Two halves:

- ``fleet/shard.py`` -- the mesh-sharded PRODUCTION solve over the
  port's positional mesh (``parallel/mesh.py``): the catalog and the
  candidate pools split across the mesh's shards, kernel A runs once on
  the primary shard over the gathered prologue, kernel B once per shard,
  and the pipelined ``solve_begin``/``solve_finish`` and delta-epoch
  contracts hold per shard. ``sharded == unsharded`` is byte identity
  asserted the way ``host == wire`` is (tests/test_torch_mesh.py, the
  ``mesh`` sim backend).

- ``fleet/coalesce.py`` -- the multi-tenant dispatch coalescer: the rpc
  sidecar already stages catalogs under per-connection seqnums; the
  coalescer batches concurrent solves from N operator replicas into
  shared device dispatch windows with deterministic tenant ordering,
  per-tenant deadline budgets feeding the existing overload ladder, and
  a per-tenant breaker/degrade so one sick cluster never poisons
  another. ``multi-tenant == isolated`` is asserted via differential sim
  replay (``sim/fleet.py``, the ``multi-cluster-storm`` corpus scenario).

``fleet/service.py`` glues both into a deployable sidecar topology;
``fleet/topology.py`` + ``fleet/straggler.py`` are its failure ladder
(topology epochs, the device-loss degrade ladder, and the shard-straggler
watchdog).
"""
from karpenter_tpu_torch.fleet.coalesce import DispatchCoalescer, TenantRefusal
from karpenter_tpu_torch.fleet.shard import MeshSolveEngine, mesh_from_env, parse_mesh_spec
from karpenter_tpu_torch.fleet.straggler import ShardStragglerWatchdog
from karpenter_tpu_torch.fleet.topology import TopologyTracker, classify_device_error

__all__ = [
    "DispatchCoalescer",
    "MeshSolveEngine",
    "ShardStragglerWatchdog",
    "TenantRefusal",
    "TopologyTracker",
    "classify_device_error",
    "mesh_from_env",
    "parse_mesh_spec",
]
