from ragmeup_tpu_torch.parallel.mesh import (AXES, LOGICAL_RULES, Mesh, all_gather,
                                             make_mesh, mesh_shape_for, psum)
from ragmeup_tpu_torch.parallel.sharded_index import (ShardedDenseIndex,
                                                      sharded_hybrid_search,
                                                      sharded_topk)
from ragmeup_tpu_torch.parallel.sharded_ivf import ShardedIVFView

__all__ = ["AXES", "LOGICAL_RULES", "Mesh", "all_gather", "make_mesh", "mesh_shape_for",
           "psum", "ShardedDenseIndex",
           "ShardedIVFView", "sharded_hybrid_search", "sharded_topk"]
