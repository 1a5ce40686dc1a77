"""Document / chunk data model.

Chunk identity follows the reference's convention: ``id = md5(page_content)``
(reference ``server/RAGHelper.py:360-369``), which makes chunking
deterministic and dedup content-addressed. ``format_documents`` reproduces the
prompt-string contract of ``RAGHelper.format_documents``
(``server/RAGHelper.py:87-106``): ``content: <text>\\nsource: <source>`` per
document, joined with a ``<NEWDOC>`` separator.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

NEWDOC_SEPARATOR = "\n\n<NEWDOC>\n\n"

# Metadata keys kept by default when loading documents. The reference filters
# metadata down to just 'source' (RAGHelper.py:167-202, default
# splitter-dependent); we keep source plus the identifiers our indexes add.
DEFAULT_METADATA_KEYS = ("source", "id", "relevance_score", "provenance", "pk")


def chunk_id(content: str) -> str:
    """Content-addressed chunk id (md5 hex, parity with RAGHelper.py:365)."""
    return hashlib.md5(content.encode("utf-8")).hexdigest()


@dataclass
class Chunk:
    """One retrievable unit: a chunk of a source document.

    Equivalent to a LangChain ``Document`` in the reference, but with the id
    materialized as a field rather than recomputed at insert time.
    """

    content: str
    metadata: dict = field(default_factory=dict)
    id: str = ""

    def __post_init__(self):
        if not self.id:
            self.id = chunk_id(self.content)

    @property
    def source(self) -> str:
        return self.metadata.get("source", "")

    def to_dict(self) -> dict:
        return {"content": self.content, "metadata": self.metadata, "id": self.id}

    @staticmethod
    def from_dict(d: dict) -> "Chunk":
        return Chunk(content=d["content"], metadata=dict(d.get("metadata", {})), id=d.get("id", ""))


def deduplicate(chunks: Iterable[Chunk]) -> List[Chunk]:
    """Drop chunks with duplicate content ids, keeping first occurrence
    (parity with RAGHelper._deduplicate_chunks, RAGHelper.py:545-549)."""
    seen = set()
    out = []
    for c in chunks:
        if c.id not in seen:
            seen.add(c.id)
            out.append(c)
    return out


def filter_metadata(chunks: Iterable[Chunk], keep: Optional[Iterable[str]] = None) -> List[Chunk]:
    """Keep only whitelisted metadata keys (RAGHelper.py:167-202 semantics)."""
    keys = tuple(keep) if keep is not None else DEFAULT_METADATA_KEYS
    out = []
    for c in chunks:
        md = {k: v for k, v in c.metadata.items() if k in keys}
        out.append(Chunk(content=c.content, metadata=md, id=c.id))
    return out


def format_documents(chunks: Iterable[Chunk]) -> str:
    """Render retrieved chunks into the prompt context string.

    Contract from RAGHelper.format_documents (RAGHelper.py:87-106): each doc
    rendered as 'content: ...\\nsource: ...' and docs joined by <NEWDOC>.
    """
    parts = []
    for c in chunks:
        parts.append(f"content: {c.content}\nsource: {c.source}")
    return NEWDOC_SEPARATOR.join(parts)
