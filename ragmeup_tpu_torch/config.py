"""Typed configuration for ragmeup_tpu_torch (the same knobs, defaults and
env table as ``ragmeup_tpu/config.py``, kept as the port's own copy).

The reference configures everything through a flat ``.env`` file read with
``os.getenv`` at call time (~80 keys; reference ``server/.env.template`` and
``server/RAGHelper.py:56-85``).  This module keeps the same knob surface —
including the *prompt library as config*, the reference's most user-visible
feature — but as typed dataclasses with real booleans, env/file overrides and
a single load point instead of stringly ``== "True"`` checks scattered through
the code (quirks deliberately not reproduced, SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional

# ---------------------------------------------------------------------------
# Prompt library defaults (semantics from the reference .env.template).
# These are *rewritten* prompts with the same contract: same placeholder names
# ({context}, {question}, {query}, {answer}, {schema}, {data}) and the same
# yes/no or score-only output conventions the pipeline parses.
# ---------------------------------------------------------------------------

RAG_INSTRUCTION = (
    "Instruction: You are a digital librarian that answers questions quickly "
    "and succinctly using the documents retrieved from the library database "
    "below. Motivate your answer and always mention which of the documents "
    "you used to formulate it:\n\n{context}"
)

RAG_QUESTION_INITIAL = "The initial question you have to answer:\n\n{question}"

RAG_QUESTION_FOLLOWUP = "The follow-up question you have to answer:\n\n{question}"

RAG_FETCH_NEW_INSTRUCTION = (
    "Instruction: You are a digital librarian with a database of documents. "
    "Users either ask questions that require fetching new documents from the "
    "database, or follow-up questions about documents already retrieved. "
    "Decide whether new documents should be fetched for this user query. "
    "Answer with yes or no only."
)

RAG_FETCH_NEW_QUESTION = 'The user question is the following: "{question}"\n'

REWRITE_QUERY_INSTRUCTION = (
    "You must answer a user question based on documents retrieved from a "
    "document database. Decide whether the documents below contain the answer "
    "to the user's query. Answer with exactly yes or no. The documents "
    "currently fetched from the database are:\n\n{context}"
)

REWRITE_QUERY_QUESTION = "The user's question is:\n\n{question}"

# Shared-context layout (PipelineConfig.shared_context_layout): the ask
# rides in the USER turn under the same rag_instruction system block the
# generate thread uses, so both forwards token-share the context prefix
# and the paged-KV prefix cache serves the generate's prefill from the
# ask's pages.
REWRITE_QUERY_SHARED_QUESTION = (
    "Before answering: decide whether the documents above contain the "
    "answer to the user's question. Answer with exactly yes or no, nothing "
    "else. The user's question is:\n\n{question}"
)

REWRITE_QUERY_PROMPT = (
    "You are given a user query that is answered by looking up documents in a "
    "document store with a distance-based similarity measure. The documents "
    "fetched for the query below were found to be irrelevant. Rewrite the "
    "question into an alternative that increases the likelihood of retrieving "
    "relevant documents. Reply with the exact rephrasing only. The original "
    "question is: {question}"
)

RE2_PROMPT = "Read the question again: "

PROVENANCE_LLM_PROMPT = (
    "Instruction: You are a provenance auditor. Determine how much the answer "
    "given to a user question was based on the given input document, knowing "
    "that more documents than this one were considered. Documents may be used "
    "verbatim, partially, or in translation. Score how much the source "
    "document was used in the answer: 0 = not used at all, 1 = barely used, "
    "2 = moderately used, 3 = mostly used, 4 = almost fully used, 5 = full "
    "text included in the answer. Always answer with only the score from 0 "
    "to 5, with no explanation or extra text.\n\n"
    "The user's query is:\n\n{query}\n\n"
    "The answer given to this user query is:\n\n{answer}\n\n"
    "The source document you need to score is the following:\n\n{context}"
)

EVAL_QUESTION_INSTRUCTION = (
    "You direct another LLM with questions. Write one question that the LLM "
    "will be able to answer based on these existing documents. The question "
    "must be accurately answerable from the documents' contents. Reply with "
    "nothing but the question:\n{context}"
)

EVAL_QUESTION_QUERY = (
    "Generate a question that can be answered given the input documents, "
    "nothing else but the question and no explanation."
)

EVAL_ANSWER_INSTRUCTION = (
    "You are a digital librarian and must answer questions based on input "
    "documents. Here are the documents you are forced to base your answer "
    "on:\n\n{context}"
)

EVAL_ANSWER_QUERY = (
    "Answer the following question; give no explanation or output other than "
    "the answer itself:\n\n{question}"
)

GRAPH_RETRIEVAL_INSTRUCTION = (
    "Instruction: You are a graph database query assistant. Based on the "
    "graph schema below, generate a Cypher query that searches for the answer "
    "to the user's question. If the schema does not support the query, "
    "respond with 'None'.\nSchema:\n{schema}"
)

GRAPH_RETRIEVAL_FEW_SHOT = (
    "Few-shot examples:\n"
    "Example 1:\nUser query: 'What topics are available?'\n"
    "Output: MATCH (t:Topic) RETURN t.name\n\n"
    "Example 2:\nUser query: 'What is the size of an elephant?'\n"
    "Output: None"
)

GRAPH_RETRIEVAL_QUESTION = (
    "The user question is:\n\n{question}\n\n"
    "Please generate a Cypher query to answer it, or return None if it does "
    "not fit the schema."
)

GRAPH_INSERT_INSTRUCTION = (
    "You are a graph database assistant. Generate Cypher queries for "
    "inserting data into the graph database, using only the nodes, properties "
    "and relationships specified in the provided schema. All generated "
    "queries must be valid Cypher wrapped in valid JSON, and conform to the "
    "schema. Make at most 9 additions. If the input data cannot be mapped to "
    "the schema, return 'None' and do not generate any invalid query."
)

GRAPH_INSERT_SCHEMA = (
    "Instruction: Generate Cypher queries to insert data into the graph "
    "database, using only the nodes, properties and relationships defined in "
    "the following schema. If the input data cannot be mapped to the schema, "
    "return 'None'.\n\nSchema:\n{schema}\n\nInput data:\n{data}\n\nOutput: "
)

GRAPH_INSERT_DATA_ONLY = (
    "Instruction: Generate Cypher queries to insert data into the graph "
    "database, using only the nodes, properties and relationships defined in "
    "the following schema. If the input data cannot be mapped to the schema, "
    "return 'None'.\n\nSchema:\nNodes:\n- Topic: name\n- Fact: name\n"
    "Relationships:\n- IS_PART_OF: No properties\n\n"
    "Input data:\n{data}\n\nOutput: "
)


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().strip("'\"").lower() in ("true", "1", "yes", "on")


def _parse_opt(v: Any, typ):
    s = str(v).strip().strip("'\"")
    if s.lower() in ("none", ""):
        return None
    return typ(s)


@dataclass
class PromptLibrary:
    """The prompt library — user-overridable, same contract as the reference
    prompt keys in .env.template:49-71,7-22,89-167."""

    rag_instruction: str = RAG_INSTRUCTION
    rag_question_initial: str = RAG_QUESTION_INITIAL
    rag_question_followup: str = RAG_QUESTION_FOLLOWUP
    rag_fetch_new_instruction: str = RAG_FETCH_NEW_INSTRUCTION
    rag_fetch_new_question: str = RAG_FETCH_NEW_QUESTION
    rewrite_query_instruction: str = REWRITE_QUERY_INSTRUCTION
    rewrite_query_question: str = REWRITE_QUERY_QUESTION
    rewrite_query_shared_question: str = REWRITE_QUERY_SHARED_QUESTION
    rewrite_query_prompt: str = REWRITE_QUERY_PROMPT
    re2_prompt: str = RE2_PROMPT
    provenance_llm_prompt: str = PROVENANCE_LLM_PROMPT
    eval_question_instruction: str = EVAL_QUESTION_INSTRUCTION
    eval_question_query: str = EVAL_QUESTION_QUERY
    eval_answer_instruction: str = EVAL_ANSWER_INSTRUCTION
    eval_answer_query: str = EVAL_ANSWER_QUERY
    graph_retrieval_instruction: str = GRAPH_RETRIEVAL_INSTRUCTION
    graph_retrieval_few_shot: str = GRAPH_RETRIEVAL_FEW_SHOT
    graph_retrieval_question: str = GRAPH_RETRIEVAL_QUESTION
    graph_insert_instruction: str = GRAPH_INSERT_INSTRUCTION
    graph_insert_schema: str = GRAPH_INSERT_SCHEMA
    graph_insert_data_only: str = GRAPH_INSERT_DATA_ONLY
    # few-shot examples appended to the insert instruction
    # (.env.template neo4j_insert_few_shot)
    graph_insert_few_shot: str = ""


@dataclass
class ModelConfig:
    """Model selection (reference .env.template:1-5,80-87)."""

    llm_model: str = "meta-llama/Meta-Llama-3.1-8B-Instruct"
    llm_assistant_token: str = "assistant\n\n"
    embedding_model: str = "avsolatorio/GIST-small-Embedding-v0"
    embedding_dim: int = 384
    trust_remote_code: bool = True
    force_cpu: bool = False
    # Weight quantization for the local LLM (reference: 4-bit nf4 bitsandbytes,
    # RAGHelper_local.py:76-89). Here: int8/int4 weight-only.
    quantization: str = "int8"  # none | int8 | int4
    # int8 lm_head (untied checkpoints): halves the largest per-token read
    head_quantization: str = "none"  # none | int8
    # W4A8 for int4 checkpoints: int8-activation MXU dots over packed
    # nibbles (fastest measured int4 path; forces the 512-group
    # output-scaled quant layout — coarser than the nf4-class default).
    int4_w4a8: bool = False
    # int4 scale-group size along the input dim (0 = auto: 128-class).
    # 512 quarters the group-scale memory and takes the faster output-
    # scaled matmul path at coarser quant granularity — the capacity
    # knob for ~28B-total int4 MoE on one 16 GB chip.
    int4_group: int = 0
    # Cloud adapters (RAGHelper_cloud.py:60-88)
    use_openai: bool = False
    openai_model_name: str = "gpt-3.5-turbo"
    use_gemini: bool = False
    gemini_model_name: str = "gemini-pro"
    use_azure: bool = False
    use_ollama: bool = False
    ollama_model: str = "llama3.1"
    # Context ceiling for the local LLM. 0 = checkpoint's window capped
    # at 32768 (bounds the dense generate-path KV cache); any explicit
    # value caps at min(checkpoint, value).
    llm_max_seq_len: int = 0
    # Local checkpoint paths (safetensors); None → deterministic random init.
    llm_checkpoint: Optional[str] = None
    embedding_checkpoint: Optional[str] = None
    cross_encoder_checkpoint: Optional[str] = None

    @property
    def use_cloud(self) -> bool:
        return self.use_openai or self.use_gemini or self.use_azure or self.use_ollama


@dataclass
class DataConfig:
    """Ingestion knobs (reference .env.template:24-28,73-78)."""

    data_directory: str = "data"
    file_types: tuple = ("pdf", "json", "docx", "pptx", "xlsx", "csv", "xml", "txt", "md")
    json_schema: str = "."
    json_text_content: bool = False
    xml_xpath: str = "//*"
    splitter: str = "RecursiveCharacterTextSplitter"  # or SemanticChunker
    chunk_size: int = 512
    chunk_overlap: int = 20
    breakpoint_threshold_type: str = "percentile"
    breakpoint_threshold_amount: Optional[float] = None
    number_of_chunks: Optional[int] = None
    # Index artifact directory (replaces the reference's pickle caches +
    # Milvus data.db; SURVEY.md §5.4).
    index_directory: str = "index"


@dataclass
class RetrievalConfig:
    """Retrieval knobs (reference .env.template:30-43)."""

    vector_store_k: int = 10
    rerank: bool = True
    rerank_k: int = 3
    rerank_model: str = "cross-encoder"  # cross-encoder | flashrank-class small model
    hybrid_weights: tuple = (0.5, 0.5)  # sparse, dense (RAGHelper.py:502)
    search_type: str = "mmr"  # mmr | similarity (RAGHelper.py:497-499)
    mmr_lambda: float = 0.5
    mmr_fetch_k: int = 20
    max_document_limit: int = 10  # cloud-path doc cap (RAGHelper_cloud.py:47-49)
    # Dense index storage dtype: bf16 (default) or int8 (quantized, rescored).
    dense_dtype: str = "bfloat16"
    # BM25 parameters (Okapi; rank_bm25 defaults used by RAGHelper.py:440).
    bm25_k1: float = 1.5
    bm25_b: float = 0.75
    # RRF constant used by the ensemble fusion (LangChain EnsembleRetriever
    # semantics, RAGHelper.py:501-503).
    rrf_c: int = 60
    # Dense ANN engine: "exact" (fused brute-force, the default) or "ivf" (cluster-pruned, the
    # single-query-latency lever for very large corpora; SURVEY.md §7 hard
    # part #2). IVF trades a measured recall@10 drop for scoring only
    # nprobe·C_pad rows per query.
    ann: str = "exact"
    ivf_nprobe: int = 8
    ivf_clusters: int = 0  # 0 = auto (sqrt of corpus size)


@dataclass
class GenerationConfig:
    """Generation caps (reference .env.template:45-47)."""

    temperature: float = 0.2
    repetition_penalty: float = 1.1
    max_new_tokens: int = 1000


@dataclass
class PipelineConfig:
    """RAG-loop behavior (reference .env.template:49-71)."""

    use_rewrite_loop: bool = True
    use_re2: bool = True
    use_provenance: bool = True
    provenance_method: str = "rerank"  # rerank | attention | similarity | llm
    provenance_similarity_llm: str = "sentence-transformers/distiluse-base-multilingual-cased-v2"
    provenance_include_query: bool = False
    # Shared-context prompt layout: the rewrite-ask forward leads with the
    # SAME system block the generate thread uses (rag_instruction + context;
    # the ask rides in the user turn), so under the paged KV prefix cache
    # the generate forward of the same /chat reuses the ask's context pages
    # instead of re-prefilling them. Same task semantics; different prompt
    # text from the reference's rewrite_query_instruction (set False for
    # verbatim reference layout).
    shared_context_layout: bool = True


@dataclass
class GraphConfig:
    """GraphRAG knobs (reference .env.template:31,39-40,124-167)."""

    enabled: bool = False
    # 'native' = in-process property-graph store; 'http' = remote sidecar with
    # the reference's /schema /run_query /add_instances contract
    # (neo4j/server.py:131-185).
    backend: str = "native"
    neo4j_location: str = ""
    file_upload_using_llm: bool = False
    dynamic_schema: bool = False


@dataclass
class EvalConfig:
    """Generative-eval knobs (reference .env.template:89-122)."""

    sample_size: int = 200
    qa_pairs: int = 10
    timeout: int = 300
    max_workers: int = 1
    answer_relevancy_threshold: float = 0.7
    faithfulness_threshold: float = 0.7
    contextual_precision_threshold: float = 0.7
    contextual_recall_threshold: float = 0.7
    contextual_relevancy_threshold: float = 0.7
    hallucination_threshold: float = 0.5
    correctness_threshold: float = 0.5
    tool_correctness_threshold: float = 0.5


@dataclass
class ParallelConfig:
    """Mesh layout (SURVEY.md §2.4/§5.8 — first-class in this framework)."""

    # Mesh axes: queries batch over 'data', corpus rows shard over 'corpus',
    # large model forwards shard over 'model'.
    data_axis: int = 1
    corpus_axis: int = 1
    model_axis: int = 1

    @property
    def total_devices(self) -> int:
        return self.data_axis * self.corpus_axis * self.model_axis


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 5000
    # serve concurrent /chat generations through the continuous-batching
    # engine (pipeline/serving.py) instead of one-at-a-time generation
    batched_llm: bool = False
    kv_pages: int = 512
    kv_page_size: int = 128
    # page budget per sequence (bounds one request's prompt+generation
    # length at kv_max_pages_per_seq * kv_page_size tokens). 0 keeps the
    # engine default (16 → 2048 tokens at 128-token pages); raise it
    # together with llm_max_seq_len for long-context RAG prompts
    kv_max_pages_per_seq: int = 0
    # tokens decoded per device dispatch in the batched backend (waves
    # keep the sampling carry device-resident; 0 = stepwise debug path)
    llm_wave_steps: int = 8
    # speculative waves: per-row 2-gram drafts verified in-batch; greedy
    # requests emit up to this many tokens per forward, byte-identical.
    # 0 disables (plain waves).
    llm_spec_draft: int = 8
    # adaptive speculation: measured emitted-tokens-per-forward (EWMA over
    # greedy rows) below this floor falls back to plain waves, re-probing
    # spec every llm_spec_reprobe plain dispatches. A draft-8 chunk forward
    # costs more than a plain forward, so the floor keeps spec only when it
    # pays. 0 disables adaptation (spec always on).
    llm_spec_accept_floor: float = 1.35
    llm_spec_reprobe: int = 16
    # hash-block KV prefix reuse on the page pool: retired sequences
    # register their full pages (sha1 chain digests over the token
    # prefix), later prompts sharing the prefix skip re-prefilling it —
    # the 3-4 LLM forwards in one /chat share system+docs context, and
    # the next turn of a thread re-sends the whole history. Byte-
    # identical outputs; LRU eviction under page pressure.
    kv_prefix_cache: bool = True


@dataclass
class RagConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    prompts: PromptLibrary = field(default_factory=PromptLibrary)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# Mapping from reference .env keys → (section, field, parser). Keeps drop-in
# compatibility with an existing RAGMeUp .env file.
_ENV_KEYMAP = {
    "llm_model": ("model", "llm_model", str),
    "llm_assistant_token": ("model", "llm_assistant_token", str),
    "embedding_model": ("model", "embedding_model", str),
    "trust_remote_code": ("model", "trust_remote_code", _parse_bool),
    "force_cpu": ("model", "force_cpu", _parse_bool),
    "use_openai": ("model", "use_openai", _parse_bool),
    "openai_model_name": ("model", "openai_model_name", str),
    "use_gemini": ("model", "use_gemini", _parse_bool),
    "gemini_model_name": ("model", "gemini_model_name", str),
    "use_azure": ("model", "use_azure", _parse_bool),
    "use_ollama": ("model", "use_ollama", _parse_bool),
    "ollama_model": ("model", "ollama_model", str),
    "data_directory": ("data", "data_directory", str),
    "file_types": ("data", "file_types", lambda v: tuple(s.strip() for s in str(v).strip("'\"").split(","))),
    "json_schema": ("data", "json_schema", str),
    "json_text_content": ("data", "json_text_content", _parse_bool),
    "xml_xpath": ("data", "xml_xpath", str),
    "splitter": ("data", "splitter", str),
    "chunk_size": ("data", "chunk_size", int),
    "chunk_overlap": ("data", "chunk_overlap", int),
    "breakpoint_threshold_type": ("data", "breakpoint_threshold_type", str),
    "breakpoint_threshold_amount": ("data", "breakpoint_threshold_amount", lambda v: _parse_opt(v, float)),
    "number_of_chunks": ("data", "number_of_chunks", lambda v: _parse_opt(v, int)),
    # the reference's milvus db file path → our index artifact directory
    "vector_store_uri": ("data", "index_directory", str),
    "vector_store_k": ("retrieval", "vector_store_k", int),
    "rerank": ("retrieval", "rerank", _parse_bool),
    "rerank_k": ("retrieval", "rerank_k", int),
    "rerank_model": ("retrieval", "rerank_model", str),
    "llm_quantization": ("model", "quantization", str),
    "llm_head_quantization": ("model", "head_quantization", str),
    "llm_int4_w4a8": ("model", "int4_w4a8", _parse_bool),
    "llm_int4_group": ("model", "int4_group", int),
    "llm_max_seq_len": ("model", "llm_max_seq_len", int),
    "batched_llm": ("server", "batched_llm", _parse_bool),
    "kv_pages": ("server", "kv_pages", int),
    "kv_page_size": ("server", "kv_page_size", int),
    "kv_max_pages_per_seq": ("server", "kv_max_pages_per_seq", int),
    "kv_prefix_cache": ("server", "kv_prefix_cache", _parse_bool),
    "llm_wave_steps": ("server", "llm_wave_steps", int),
    "llm_spec_draft": ("server", "llm_spec_draft", int),
    "llm_spec_accept_floor": ("server", "llm_spec_accept_floor", float),
    "llm_spec_reprobe": ("server", "llm_spec_reprobe", int),
    "max_document_limit": ("retrieval", "max_document_limit", int),
    "temperature": ("generation", "temperature", float),
    "repetition_penalty": ("generation", "repetition_penalty", float),
    "max_new_tokens": ("generation", "max_new_tokens", int),
    "use_rewrite_loop": ("pipeline", "use_rewrite_loop", _parse_bool),
    "use_re2": ("pipeline", "use_re2", _parse_bool),
    "provenance_method": ("pipeline", "provenance_method", str),
    "provenance_similarity_llm": ("pipeline", "provenance_similarity_llm", str),
    "provenance_include_query": ("pipeline", "provenance_include_query", _parse_bool),
    "neo4j_location": ("graph", "neo4j_location", str),
    "file_upload_using_llm": ("graph", "file_upload_using_llm", _parse_bool),
    "dynamic_neo4j_schema": ("graph", "dynamic_schema", _parse_bool),
    "deepeval_sample_size": ("eval", "sample_size", int),
    "deepeval_answer_relevancy_threshold": ("eval", "answer_relevancy_threshold", float),
    "deepeval_faithfulness_threshold": ("eval", "faithfulness_threshold", float),
    "deepeval_contextual_precision_threshold": ("eval", "contextual_precision_threshold", float),
    "deepeval_contextual_recall_threshold": ("eval", "contextual_recall_threshold", float),
    "deepeval_contextual_relevancy_threshold": ("eval", "contextual_relevancy_threshold", float),
    "deepeval_hallucination_threshold": ("eval", "hallucination_threshold", float),
    "deepeval_correctness_threshold": ("eval", "correctness_threshold", float),
    "deepeval_tool_correctness_threshold": ("eval", "tool_correctness_threshold", float),
    "deepeval_qa_pairs": ("eval", "qa_pairs", int),
    "ragas_sample_size": ("eval", "sample_size", int),
    "ragas_qa_pairs": ("eval", "qa_pairs", int),
    "ragas_timeout": ("eval", "timeout", int),
    "ragas_max_workers": ("eval", "max_workers", int),
    # framework-specific (no reference counterpart): mesh layout knobs
    "parallel_data_axis": ("parallel", "data_axis", int),
    "parallel_corpus_axis": ("parallel", "corpus_axis", int),
    "parallel_model_axis": ("parallel", "model_axis", int),
    # dense ANN engine selection (retrieval/ivf.py)
    "retrieval_ann": ("retrieval", "ann", str),
    "retrieval_ivf_nprobe": ("retrieval", "ivf_nprobe", int),
    "retrieval_ivf_clusters": ("retrieval", "ivf_clusters", int),
}

_PROMPT_ENV_KEYS = {
    "rag_instruction": "rag_instruction",
    "rag_question_initial": "rag_question_initial",
    "rag_question_followup": "rag_question_followup",
    "rag_fetch_new_instruction": "rag_fetch_new_instruction",
    "rag_fetch_new_question": "rag_fetch_new_question",
    "rewrite_query_instruction": "rewrite_query_instruction",
    "rewrite_query_question": "rewrite_query_question",
    "rewrite_query_prompt": "rewrite_query_prompt",
    "re2_prompt": "re2_prompt",
    "provenance_llm_prompt": "provenance_llm_prompt",
    "deepeval_question_instruction": "eval_question_instruction",
    "deepeval_question_query": "eval_question_query",
    "deepeval_answer_instruction": "eval_answer_instruction",
    "deepeval_answer_query": "eval_answer_query",
    "ragas_question_instruction": "eval_question_instruction",
    "ragas_question_query": "eval_question_query",
    "ragas_answer_instruction": "eval_answer_instruction",
    "ragas_answer_query": "eval_answer_query",
    "rag_retrieval_instruction": "graph_retrieval_instruction",
    "retrieval_few_shot": "graph_retrieval_few_shot",
    "rag_retrieval_question": "graph_retrieval_question",
    "neo4j_insert_instruction": "graph_insert_instruction",
    "neo4j_insert_schema": "graph_insert_schema",
    "neo4j_insert_data_only": "graph_insert_data_only",
    "neo4j_insert_few_shot": "graph_insert_few_shot",
}


def _strip_quotes(v: str) -> str:
    v = v.strip()
    if len(v) >= 2 and v[0] == v[-1] and v[0] in ("'", '"'):
        return v[1:-1]
    return v


def parse_env_file(path: str) -> dict:
    """Parse a flat KEY=VALUE env file (reference .env format), tolerating
    multi-line quoted values (the reference's prompt entries span lines)."""
    out: dict = {}
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    key, buf, quote = None, [], None
    for line in text.splitlines():
        if key is None:
            if not line.strip() or line.lstrip().startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            k = k.strip()
            vs = v.strip()
            if vs and vs[0] in ("'", '"') and (len(vs) == 1 or vs[-1] != vs[0] or len(vs) == 1):
                # opening quote without closing on this line → multi-line
                if len(vs) >= 2 and vs[-1] == vs[0]:
                    out[k] = vs[1:-1]
                else:
                    key, quote, buf = k, vs[0], [vs[1:]]
            else:
                out[k] = _strip_quotes(vs)
        else:
            if line.rstrip().endswith(quote):
                buf.append(line.rstrip()[:-1])
                out[key] = "\n".join(buf)
                key, buf, quote = None, [], None
            else:
                buf.append(line)
    return out


def load_config(env_file: Optional[str] = None,
                json_file: Optional[str] = None,
                overrides: Optional[dict] = None,
                use_environ: bool = True) -> RagConfig:
    """Build a RagConfig from defaults ← env file ← os.environ ← overrides."""
    cfg = RagConfig()
    kv: dict = {}
    if env_file and os.path.exists(env_file):
        kv.update(parse_env_file(env_file))
    if use_environ:
        for k in list(_ENV_KEYMAP) + list(_PROMPT_ENV_KEYS):
            if k in os.environ:
                kv[k] = os.environ[k]
    for k, v in kv.items():
        if k in _ENV_KEYMAP:
            section, fname, parser = _ENV_KEYMAP[k]
            try:
                setattr(getattr(cfg, section), fname, parser(v))
            except (ValueError, TypeError):
                pass
        elif k in _PROMPT_ENV_KEYS:
            setattr(cfg.prompts, _PROMPT_ENV_KEYS[k], str(v))
    if json_file and os.path.exists(json_file):
        with open(json_file) as f:
            _apply_nested(cfg, json.load(f))
    if overrides:
        _apply_nested(cfg, overrides)
    # drop-in .env parity: the reference's llm_model takes an HF id OR a
    # local save_pretrained directory (transformers resolves both). An
    # env-only config therefore points llm_model at a local path; route
    # it to llm_checkpoint so load_local_llm reads it.
    if cfg.model.llm_checkpoint is None and os.path.isdir(cfg.model.llm_model):
        cfg.model.llm_checkpoint = cfg.model.llm_model
    return cfg


def _apply_nested(cfg: RagConfig, d: dict) -> None:
    for section, fields in d.items():
        target = getattr(cfg, section, None)
        if target is None or not isinstance(fields, dict):
            continue
        for fname, v in fields.items():
            if hasattr(target, fname):
                cur = getattr(target, fname)
                if isinstance(cur, bool):
                    v = _parse_bool(v)
                elif isinstance(cur, tuple) and isinstance(v, list):
                    v = tuple(v)
                setattr(target, fname, v)
