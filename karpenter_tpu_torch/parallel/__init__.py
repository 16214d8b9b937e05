"""Mesh sharding for the batched solve (copy of karpenter_tpu/parallel/
over torch devices; see mesh.py)."""
from karpenter_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, make_mesh_2d, sharded_repack, sharded_repack_leftover, sharded_solve,
)

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "sharded_repack", "sharded_repack_leftover",
           "sharded_solve"]
