from ragmeup_tpu_torch.data.documents import Chunk, chunk_id, deduplicate, format_documents
from ragmeup_tpu_torch.data.splitters import RecursiveCharacterSplitter, SemanticSplitter, make_splitter
from ragmeup_tpu_torch.data.store import ChunkStore

__all__ = [
    "Chunk",
    "chunk_id",
    "deduplicate",
    "format_documents",
    "RecursiveCharacterSplitter",
    "SemanticSplitter",
    "make_splitter",
    "ChunkStore",
]
