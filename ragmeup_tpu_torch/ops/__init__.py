from ragmeup_tpu_torch.ops.topk import dense_topk, topk_oracle
from ragmeup_tpu_torch.ops.fusion import rrf_fuse, mmr_select

__all__ = ["dense_topk", "topk_oracle", "rrf_fuse", "mmr_select"]
