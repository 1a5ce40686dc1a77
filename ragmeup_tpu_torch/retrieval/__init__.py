from ragmeup_tpu_torch.retrieval.dense import DenseIndex
from ragmeup_tpu_torch.retrieval.sparse import BM25Index, analyze, bm25_oracle, sanitize_query
from ragmeup_tpu_torch.retrieval.hybrid import HybridRetriever

__all__ = ["DenseIndex", "BM25Index", "HybridRetriever", "analyze",
           "bm25_oracle", "sanitize_query"]
