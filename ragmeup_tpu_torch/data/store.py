"""Chunk store: the system of record for the corpus.

Replaces the reference's pickle chunk cache (``RAGHelper.py:108-112,372-383``
— ``document_chunks_pickle``) with a versioned on-disk artifact:

    <index_directory>/
      chunks.jsonl      one JSON object per chunk {id, content, metadata}
      manifest.json     {version, count, sources: {source: [row indices]}}
      dense/…           dense index artifact (retrieval/dense.py)
      sparse/…          CSR postings artifact (retrieval/sparse.py)

The store is append-ordered: row position in chunks.jsonl is the stable
integer row id the device indexes use; deletions are tombstones here and
masks on device, compacted explicitly (SURVEY.md §5.4).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

from ragmeup_tpu_torch.data.documents import Chunk, deduplicate

MANIFEST_VERSION = 1


class ChunkStore:
    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        self.chunks: List[Chunk] = []
        self.tombstones: set = set()  # row indices deleted
        self._id_to_row: Dict[str, int] = {}

    # -- properties ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.chunks) - len(self.tombstones)

    @property
    def num_rows(self) -> int:
        """Total rows including tombstoned (device array length)."""
        return len(self.chunks)

    def live_chunks(self) -> List[Chunk]:
        return [c for i, c in enumerate(self.chunks) if i not in self.tombstones]

    def live_rows(self) -> List[int]:
        return [i for i in range(len(self.chunks)) if i not in self.tombstones]

    def __getitem__(self, row: int) -> Chunk:
        return self.chunks[row]

    def get_by_id(self, cid: str) -> Optional[Chunk]:
        row = self._id_to_row.get(cid)
        if row is None or row in self.tombstones:
            return None
        return self.chunks[row]

    def sources(self) -> List[str]:
        return sorted({c.source for c in self.live_chunks()})

    # -- mutation --------------------------------------------------------------

    def add(self, chunks: Iterable[Chunk]) -> List[int]:
        """Append chunks (deduped against the store by content id, parity with
        RAGHelper.py:545-549). Returns the new row indices."""
        rows: List[int] = []
        for c in deduplicate(chunks):
            existing = self._id_to_row.get(c.id)
            if existing is not None and existing not in self.tombstones:
                continue
            row = len(self.chunks)
            self.chunks.append(c)
            self._id_to_row[c.id] = row
            rows.append(row)
        return rows

    def delete_source(self, source: str) -> List[int]:
        """Tombstone every live chunk whose metadata.source == source (parity
        with the reference delete-by-source, server.py:373-377). Paths
        compare normalized: ingest may record './docs/a.txt' while the
        server resolves 'docs/a.txt' (an exact-string compare would delete
        the file but keep its chunks)."""
        want = os.path.normpath(source)
        rows = [i for i, c in enumerate(self.chunks)
                if i not in self.tombstones
                and os.path.normpath(c.source) == want]
        self.tombstones.update(rows)
        return rows

    def delete_rows(self, rows: Sequence[int]) -> None:
        self.tombstones.update(int(r) for r in rows)

    def compact(self) -> List[int]:
        """Drop tombstoned rows; returns old→new row mapping as a list where
        mapping[old_row] = new_row or -1."""
        mapping = [-1] * len(self.chunks)
        new_chunks: List[Chunk] = []
        for i, c in enumerate(self.chunks):
            if i not in self.tombstones:
                mapping[i] = len(new_chunks)
                new_chunks.append(c)
        self.chunks = new_chunks
        self.tombstones = set()
        self._id_to_row = {c.id: i for i, c in enumerate(self.chunks)}
        return mapping

    # -- persistence -----------------------------------------------------------

    def save(self, directory: Optional[str] = None) -> None:
        d = directory or self.directory
        if d is None:
            raise ValueError("no directory configured for ChunkStore.save")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "chunks.jsonl"), "w", encoding="utf-8") as f:
            for c in self.chunks:
                f.write(json.dumps(c.to_dict(), ensure_ascii=False) + "\n")
        manifest = {
            "version": MANIFEST_VERSION,
            "count": len(self.chunks),
            "tombstones": sorted(self.tombstones),
        }
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    @classmethod
    def load(cls, directory: str) -> "ChunkStore":
        store = cls(directory)
        chunks_path = os.path.join(directory, "chunks.jsonl")
        if not os.path.exists(chunks_path):
            return store
        with open(chunks_path, "r", encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    store.chunks.append(Chunk.from_dict(json.loads(line)))
        store._id_to_row = {c.id: i for i, c in enumerate(store.chunks)}
        manifest_path = os.path.join(directory, "manifest.json")
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)
            store.tombstones = set(manifest.get("tombstones", []))
        return store

    @classmethod
    def exists(cls, directory: str) -> bool:
        return os.path.exists(os.path.join(directory, "chunks.jsonl"))
