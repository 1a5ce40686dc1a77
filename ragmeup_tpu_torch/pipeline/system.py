"""RagSystem: the framework facade on one device.

Counterpart of ``ragmeup_tpu/pipeline/system.py``. Owns config, chunk
store, device indexes, models and the pipeline, and exposes the lifecycle
the HTTP server (``server/app.py``) drives: startup (load the on-disk index
artifact, or ingest the data directory, embed and persist),
``add_document`` (a CSV also becomes graph rows when GraphRAG is on),
``delete_document``, ``compact``, ``list_documents`` and ``chat``. The RAG
state machine (``RAGPipeline``), the chat backends, the chunk store,
loaders, splitters and the graph modules are the port's own copies of the
JAX package's modules. ``server.batched_llm`` serves concurrent /chat
generations through the paged continuous-batching engine
(``pipeline/serving.py``); ``graph.enabled`` adds a ``GraphRetriever``
over the native ``PropertyGraph`` or a remote sidecar
(``graph.backend == "http"``).

``parallel.corpus_axis > 1`` shards the dense index and the BM25 head over
the 'corpus' axis of a mesh of ``devices`` (default: every visible card; a
device may repeat) and serves retrieval through the sharded program
(parallel/sharded_index.py), with ids equal to the single-device system's.
``retrieval.ann="ivf"`` serves dense search through the IVF view.
``parallel.model_axis > 1`` loads the local LLM tensor-parallel over the
'model' axis of the same mesh (``LocalLLM(mesh=...)``: sharded weights, KV
caches and page pools, the ring prefill when the corpus axis is > 1 too);
with ``corpus_axis == 1`` the indexes stay on one device. With
``parallel.data_axis > 1`` alone the system serves on one device with no
mesh, as the JAX package does.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional

import numpy as np
import torch

from ragmeup_tpu_torch.config import RagConfig
from ragmeup_tpu_torch.data.documents import filter_metadata
from ragmeup_tpu_torch.data.loaders import load_directory, load_file
from ragmeup_tpu_torch.data.splitters import make_splitter
from ragmeup_tpu_torch.data.store import ChunkStore
from ragmeup_tpu_torch.devices import resolve_device
from ragmeup_tpu_torch.graph.client import RemoteGraphClient
from ragmeup_tpu_torch.graph.retriever import (GraphRetriever, csv_to_graph,
                                               text_to_graph_llm)
from ragmeup_tpu_torch.graph.store import PropertyGraph
from ragmeup_tpu_torch.models.hf_loader import (load_cross_encoder,
                                                load_local_llm,
                                                load_sentence_encoder)
from ragmeup_tpu_torch.pipeline.llm_backends import (ChatBackend,
                                                     CloudChatBackend,
                                                     LocalChatBackend,
                                                     resolve_chat_template)
from ragmeup_tpu_torch.pipeline.rag import RAGPipeline
from ragmeup_tpu_torch.parallel.mesh import make_mesh, visible_devices
from ragmeup_tpu_torch.parallel.sharded_index import ShardedDenseIndex, make_shard_placer
from ragmeup_tpu_torch.pipeline.serving import BatchedChatBackend
from ragmeup_tpu_torch.retrieval.dense import DenseIndex
from ragmeup_tpu_torch.retrieval.hybrid import HybridRetriever
from ragmeup_tpu_torch.retrieval.sparse import BM25Index

logger = logging.getLogger("ragmeup_tpu_torch.system")


class RagSystem:
    def __init__(self, cfg: RagConfig, encoder=None, cross_encoder=None,
                 llm=None, backend: Optional[ChatBackend] = None,
                 extra_retrievers=(), eager_load: bool = True, device=None,
                 devices=None):
        """``device``: where the indexes and any model this constructor
        builds live: CUDA unless given another (``"cpu"``); raises without
        a card. Injected models keep their own device. ``devices``: the
        mesh's devices when ``parallel.corpus_axis > 1`` or
        ``parallel.model_axis > 1`` (default: every visible card; a device
        may repeat; ``["cpu"] * n`` on the CPU); the sharded indexes merge
        on the first, and the model-sharded LLM serves from it."""
        self.cfg = cfg
        p = cfg.parallel
        self.device = resolve_device(device)
        # the corpus axis: indexes shard over 'corpus', retrieval ids equal
        # the single-device system's; the model axis: the LLM shards over
        # 'model'
        self.mesh = None
        if p.corpus_axis > 1 or p.model_axis > 1:
            if p.corpus_axis & (p.corpus_axis - 1):
                # BM25 head capacities are tile_n * 2^j; the sharded program
                # splits them evenly over 'corpus'
                raise ValueError(
                    f"parallel.corpus_axis must be a power of two for the "
                    f"sharded retrieval program, got {p.corpus_axis}")
            devs = (visible_devices() if devices is None
                    else [resolve_device(d) for d in devices])
            if len(devs) < p.total_devices:
                raise ValueError(
                    f"parallel config needs {p.total_devices} devices "
                    f"(data={p.data_axis} corpus={p.corpus_axis} "
                    f"model={p.model_axis}); have {len(devs)}")
            self.mesh = make_mesh((p.data_axis, p.corpus_axis, p.model_axis),
                                  devices=devs[:p.total_devices])
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
                if self.llm is None:
                    m = cfg.model
                    self.llm = load_local_llm(
                        m.llm_checkpoint, device=self.device,
                        quantization=m.quantization,
                        head_quantization=m.head_quantization, int4_w4a8=m.int4_w4a8,
                        int4_group=m.int4_group, max_seq_len=m.llm_max_seq_len,
                        mesh=self.mesh if p.model_axis > 1 else None)
                template = resolve_chat_template(cfg.model.llm_checkpoint)
                s = cfg.server
                if s.batched_llm:
                    ekw = dict(num_pages=s.kv_pages, page_size=s.kv_page_size,
                               prefix_cache=s.kv_prefix_cache,
                               spec_accept_floor=s.llm_spec_accept_floor,
                               spec_reprobe_every=s.llm_spec_reprobe)
                    if s.kv_max_pages_per_seq > 0:
                        ekw["max_pages_per_seq"] = s.kv_max_pages_per_seq
                    backend = BatchedChatBackend(
                        self.llm, template=template,
                        assistant_token=cfg.model.llm_assistant_token,
                        wave_steps=s.llm_wave_steps,
                        spec_draft=s.llm_spec_draft, **ekw)
                else:
                    backend = LocalChatBackend(
                        self.llm, template=template,
                        assistant_token=cfg.model.llm_assistant_token)
        self.backend = backend
        self.extra_retrievers = list(extra_retrievers)
        # GraphRAG (the cloud helper's graph_retriever hook,
        # RAGHelper_cloud.py:202-278): the native in-process store, or a
        # remote sidecar speaking the reference contract
        self.graph = None
        if cfg.graph.enabled:
            if cfg.graph.backend == "http" and cfg.graph.neo4j_location:
                self.graph = RemoteGraphClient(cfg.graph.neo4j_location)
            else:
                self.graph = PropertyGraph(
                    os.path.join(cfg.data.index_directory, "graph.json"))
            self.extra_retrievers.append(
                GraphRetriever(self.graph, self.backend, cfg.prompts))

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

    @property
    def _corpus_sharded(self) -> bool:
        return self.mesh is not None and self.cfg.parallel.corpus_axis > 1

    def _make_dense(self):
        r = self.cfg.retrieval
        if self._corpus_sharded:
            return ShardedDenseIndex(self.mesh, self.cfg.model.embedding_dim,
                                     dtype=r.dense_dtype)
        return DenseIndex(self.cfg.model.embedding_dim, dtype=r.dense_dtype,
                          device=self.device)

    def _load_dense(self, idx_dir: str):
        if self._corpus_sharded:
            return ShardedDenseIndex.load(idx_dir, self.mesh)
        return DenseIndex.load(idx_dir, device=self.device)

    def _make_sparse(self) -> BM25Index:
        r = self.cfg.retrieval
        sparse = BM25Index(k1=r.bm25_k1, b=r.bm25_b, device=self._index_device)
        if self._corpus_sharded:
            sparse.shard_placer = make_shard_placer(self.mesh)
        return sparse

    @property
    def _index_device(self) -> torch.device:
        """Where query-side index tensors live: the mesh's first corpus
        device when sharded, else the system's device."""
        return self.mesh.axis_devices("corpus")[0] if self._corpus_sharded else self.device

    def load_data(self) -> None:
        """Artifact cache hit → load; miss → ingest + embed + persist."""
        d = self.cfg.data
        idx_dir = d.index_directory
        if ChunkStore.exists(idx_dir) and DenseIndex.exists(idx_dir) \
                and BM25Index.exists(idx_dir):
            logger.info("loading index artifact from %s", idx_dir)
            self.store = ChunkStore.load(idx_dir)
            self.dense = self._load_dense(idx_dir)
            self.sparse = BM25Index.load(idx_dir, device=self._index_device)
            if self._corpus_sharded:
                self.sparse.shard_placer = make_shard_placer(self.mesh)
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
            mesh=self.mesh if self._corpus_sharded else None,
            ann=r.ann, ivf_nprobe=r.ivf_nprobe, ivf_clusters=r.ivf_clusters)
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
        # graph upload hooks (RAGHelper.add_document, RAGHelper.py:712-737):
        # CSVs become graph rows; other documents optionally go through LLM
        # extraction
        if self.graph is not None:
            try:
                if path.lower().endswith(".csv"):
                    csv_to_graph(self.graph, path)
                elif self.cfg.graph.file_upload_using_llm:
                    for doc in raw:
                        text_to_graph_llm(
                            self.graph, self.backend, self.cfg.prompts,
                            doc.content,
                            dynamic_schema=self.cfg.graph.dynamic_schema)
            except Exception as e:  # graph upload is best-effort
                logger.warning("graph upload failed for %s: %s", path, e)
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

    def compact(self) -> None:
        """Rewrite the artifacts densely (periodic maintenance): the store
        and dense index drop tombstoned rows, BM25 is rebuilt from the live
        texts (its postings name rows)."""
        with self._mutation_lock:
            mapping = self.store.compact()
            self.dense.compact(mapping)
            self.sparse = self._make_sparse()
            self.sparse.add([c.content for c in self.store.live_chunks()])
            self.save()
            self._wire()

    # -- queries ----------------------------------------------------------------------

    def list_documents(self) -> List[str]:
        """Files in the data dir matching the configured types
        (server.py:306-324 semantics) plus any indexed sources."""
        d = self.cfg.data
        exts = {t.lower().lstrip(".") for t in d.file_types}
        out = set()
        if os.path.isdir(d.data_directory):
            for root, _dirs, files in os.walk(d.data_directory):
                for f in files:
                    if os.path.splitext(f)[1].lstrip(".").lower() in exts:
                        out.add(os.path.join(root, f))
        out.update(self.store.sources())
        return sorted(out)

    def chat(self, prompt: str, history=None) -> dict:
        return self.pipeline.handle_user_interaction(prompt, history)
