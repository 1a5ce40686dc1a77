from ragmeup_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh, mesh_shape_for
from ragmeup_tpu_torch.parallel.sharded_index import (ShardedDenseIndex,
                                                      sharded_hybrid_search,
                                                      sharded_topk)
from ragmeup_tpu_torch.parallel.sharded_ivf import ShardedIVFView

__all__ = ["AXES", "Mesh", "make_mesh", "mesh_shape_for", "ShardedDenseIndex",
           "ShardedIVFView", "sharded_hybrid_search", "sharded_topk"]
