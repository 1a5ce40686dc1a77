"""RagSystem: the framework facade on one device.

Counterpart of ``ragmeup_tpu/pipeline/system.py``. Owns config, chunk
store, device indexes, models and the pipeline, and exposes the lifecycle
the HTTP server drives: startup (load the on-disk index artifact, or ingest
the data directory, embed and persist), ``add_document``,
``delete_document`` and ``chat``. The RAG state machine
(``RAGPipeline``), the chat backends, the chunk store, loaders and
splitters are the JAX package's, reused as they are (none imports jax).

Not ported yet, and refused with NotImplementedError: mesh layouts
(``parallel.*_axis > 1``), the batched paged serving engine
(``server.batched_llm``) and the GraphRAG wiring (``graph.enabled``).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

import numpy as np
import torch

from ragmeup_tpu.config import RagConfig
from ragmeup_tpu.data.documents import filter_metadata
from ragmeup_tpu.data.loaders import load_directory, load_file
from ragmeup_tpu.data.splitters import make_splitter
from ragmeup_tpu.data.store import ChunkStore
from ragmeup_tpu.pipeline.llm_backends import (ChatBackend, CloudChatBackend,
                                               LocalChatBackend,
                                               resolve_chat_template)
from ragmeup_tpu.pipeline.rag import RAGPipeline
from ragmeup_tpu_torch.models.hf_loader import (load_cross_encoder,
                                                load_local_llm,
                                                load_sentence_encoder)
from ragmeup_tpu_torch.retrieval.dense import DenseIndex
from ragmeup_tpu_torch.retrieval.hybrid import HybridRetriever
from ragmeup_tpu_torch.retrieval.sparse import BM25Index

logger = logging.getLogger("ragmeup_tpu_torch.system")


class RagSystem:
    def __init__(self, cfg: RagConfig, encoder=None, cross_encoder=None,
                 llm=None, backend: Optional[ChatBackend] = None,
                 extra_retrievers=(), eager_load: bool = True, device=None):
        """``device``: where the indexes and any model this constructor
        builds live (default: CUDA when present, else the CPU). Injected
        models keep their own device."""
        self.cfg = cfg
        p = cfg.parallel
        if p.corpus_axis > 1 or p.model_axis > 1 or p.data_axis > 1:
            raise NotImplementedError(
                "mesh layouts are not ported yet (ROADMAP queue 1: mesh)")
        if cfg.graph.enabled:
            raise NotImplementedError(
                "GraphRAG wiring is not ported yet (ROADMAP queue 1: HTTP layer)")
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.encoder = encoder or load_sentence_encoder(
            cfg.model.embedding_checkpoint, dim=cfg.model.embedding_dim,
            device=self.device)
        self.cross_encoder = cross_encoder
        if cross_encoder is None and cfg.retrieval.rerank:
            self.cross_encoder = load_cross_encoder(
                cfg.model.cross_encoder_checkpoint,
                kind=cfg.retrieval.rerank_model, device=self.device)
        self.llm = llm
        if backend is None:
            if cfg.model.use_cloud:
                backend = CloudChatBackend.from_config(cfg.model)
            else:
                if cfg.server.batched_llm:
                    raise NotImplementedError(
                        "the batched paged serving engine is not ported yet "
                        "(ROADMAP queue 1: paged serving)")
                if self.llm is None:
                    m = cfg.model
                    self.llm = load_local_llm(
                        m.llm_checkpoint, device=self.device,
                        quantization=m.quantization, int4_w4a8=m.int4_w4a8,
                        int4_group=m.int4_group, max_seq_len=m.llm_max_seq_len)
                backend = LocalChatBackend(
                    self.llm,
                    template=resolve_chat_template(cfg.model.llm_checkpoint),
                    assistant_token=cfg.model.llm_assistant_token)
        self.backend = backend
        self.extra_retrievers = list(extra_retrievers)

        # index mutation is serialized; queries only read
        self._mutation_lock = threading.RLock()
        self.store: ChunkStore = ChunkStore(cfg.data.index_directory)
        self.dense: Optional[DenseIndex] = None
        self.sparse: Optional[BM25Index] = None
        self.retriever: Optional[HybridRetriever] = None
        self.pipeline: Optional[RAGPipeline] = None
        if eager_load:
            self.load_data()

    # -- index lifecycle ---------------------------------------------------------

    def _splitter(self):
        return make_splitter(self.cfg, embed_fn=self.encoder.encode)

    def _make_dense(self) -> DenseIndex:
        return DenseIndex(self.cfg.model.embedding_dim,
                          dtype=self.cfg.retrieval.dense_dtype,
                          device=self.device)

    def _make_sparse(self) -> BM25Index:
        r = self.cfg.retrieval
        return BM25Index(k1=r.bm25_k1, b=r.bm25_b, device=self.device)

    def load_data(self) -> None:
        """Artifact cache hit → load; miss → ingest + embed + persist."""
        d = self.cfg.data
        idx_dir = d.index_directory
        if ChunkStore.exists(idx_dir) and DenseIndex.exists(idx_dir) \
                and BM25Index.exists(idx_dir):
            logger.info("loading index artifact from %s", idx_dir)
            self.store = ChunkStore.load(idx_dir)
            self.dense = DenseIndex.load(idx_dir, device=self.device)
            self.sparse = BM25Index.load(idx_dir, device=self.device)
        else:
            logger.info("building index from data dir %s", d.data_directory)
            self.store = ChunkStore(idx_dir)
            raw = []
            if os.path.isdir(d.data_directory):
                raw = load_directory(
                    d.data_directory, d.file_types,
                    json_schema=d.json_schema,
                    json_text_content=d.json_text_content,
                    xml_xpath=d.xml_xpath,
                    on_error=lambda p, e: logger.warning("load failed %s: %s", p, e))
            chunks = filter_metadata(self._splitter().split_chunks(raw))
            self.store.add(chunks)
            self.dense = self._make_dense()
            self.sparse = self._make_sparse()
            live = self.store.live_chunks()
            if live:
                vecs = self.encoder.encode([c.content for c in live])
                self.dense.add(vecs)
                self.sparse.add([c.content for c in live])
            self.save()
        self._wire()

    def _wire(self) -> None:
        r = self.cfg.retrieval
        self.retriever = HybridRetriever(
            self.store, self.dense, self.sparse,
            embed_query_fn=self.encoder.encode,
            k=r.vector_store_k, weights=r.hybrid_weights, rrf_c=r.rrf_c,
            search_type=r.search_type, mmr_fetch_k=r.mmr_fetch_k,
            mmr_lambda=r.mmr_lambda,
            reranker=self.cross_encoder if r.rerank else None,
            rerank_k=r.rerank_k,
            re2_prompt=self.cfg.prompts.re2_prompt if self.cfg.pipeline.use_re2 else None,
            ann=r.ann)
        self.pipeline = RAGPipeline(
            self.cfg, self.retriever, self.backend,
            cross_encoder=self.cross_encoder, encoder=self.encoder,
            llm=self.llm, extra_retrievers=self.extra_retrievers)

    def save(self) -> None:
        idx = self.cfg.data.index_directory
        os.makedirs(idx, exist_ok=True)
        self.store.save(idx)
        if self.dense is not None:
            self.dense.save(idx)
        if self.sparse is not None:
            self.sparse.save(idx)

    # -- CRUD ----------------------------------------------------------------------

    def add_document(self, path: str) -> int:
        """Ingest one file incrementally; returns number of new chunks."""
        with self._mutation_lock:
            return self._add_document_locked(path)

    def _add_document_locked(self, path: str) -> int:
        d = self.cfg.data
        raw = load_file(path, d.json_schema, d.json_text_content, d.xml_xpath)
        chunks = filter_metadata(self._splitter().split_chunks(raw))
        rows = self.store.add(chunks)
        if rows:
            new_chunks = [self.store[r] for r in rows]
            vecs = self.encoder.encode([c.content for c in new_chunks])
            dr = self.dense.add(np.asarray(vecs))
            sr = self.sparse.add([c.content for c in new_chunks])
            if dr != rows or sr != rows:
                raise RuntimeError("row id drift between store and indexes")
        self.save()
        return len(rows)

    def delete_document(self, source: str) -> int:
        """Tombstone all chunks of a source everywhere; returns count."""
        with self._mutation_lock:
            rows = self.store.delete_source(source)
            if rows:
                self.dense.delete_rows(rows)
                self.sparse.delete_rows(rows)
            self.save()
            return len(rows)

    # -- queries ----------------------------------------------------------------------

    def chat(self, prompt: str, history=None) -> dict:
        return self.pipeline.handle_user_interaction(prompt, history)
