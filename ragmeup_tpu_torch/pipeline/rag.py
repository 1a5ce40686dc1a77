"""The RAG loop as an explicit state machine.

Orchestration semantics from the reference
(``RAGHelper_local.py:190-259``, ``RAGHelper_cloud.py:202-278``,
``server.py:238-303``), rebuilt as a deterministic pipeline over the device
engines:

    fetch-new decision → (retrieve → rewrite-once loop → re-retrieve?) →
    Re2 → prompt assembly → LLM → provenance → response contract

Reference quirks deliberately fixed toward documented intent (SURVEY.md §7):
the cloud helper's inverted retriever pick (``RAGHelper_cloud.py:226-227``)
and the delete path's ``loadData`` AttributeError (``server.py:383``).

The response dict is the server wire contract the Scala UI round-trips
(``server.py:276-303``): ``reply, history, documents [{s, c, pk,
provenance}], rewritten, question, fetched_new_documents``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence

from ragmeup_tpu_torch.config import RagConfig
from ragmeup_tpu_torch.data.documents import Chunk, format_documents
from ragmeup_tpu_torch.pipeline.llm_backends import ChatBackend, Message
from ragmeup_tpu_torch.pipeline import provenance as prov

logger = logging.getLogger("ragmeup_tpu_torch.pipeline")


def _is_yes(reply: str) -> bool:
    """Parse an LLM yes/no verdict (RAGHelper_local.py:219-226 semantics).

    Anchored to the FIRST word: punctuation/markup is stripped and the
    leading token must itself be an assent/dissent word. A bare substring
    scan is wrong — "no — yes would be wrong" must parse as no. If the
    first word is neither, fall back to scanning the first few words for
    a known token so verdicts like "Sure, yes." still resolve; an explicit
    leading "no" always wins.
    """
    words = [w.strip("\"'`*_.,;:!?()[]{}<>—–-") for w in reply.lower().split()]
    words = [w for w in words if w]
    if not words:
        return False
    _YES = {"yes", "y", "yep", "yeah", "true", "affirmative"}
    _NO = {"no", "n", "nope", "false", "negative"}
    if words[0] in _YES:
        return True
    if words[0] in _NO:
        return False
    for w in words[1:4]:
        if w in _YES:
            return True
        if w in _NO:
            return False
    return False


class RAGPipeline:
    """Chat orchestration over a retriever + chat backend.

    ``retriever`` is a HybridRetriever (or anything with ``retrieve(query)
    -> List[Chunk]``); extra retrievers (e.g. the graph store) can be
    attached via ``extra_retrievers`` — their chunks are prioritized and the
    combined list is capped at ``max_document_limit`` (the
    combine-and-limit semantics of RAGHelper_cloud.py:170-200).
    """

    def __init__(self, cfg: RagConfig, retriever, backend: ChatBackend,
                 cross_encoder=None, encoder=None, llm=None,
                 extra_retrievers: Sequence = ()):
        self.cfg = cfg
        self.retriever = retriever
        self.backend = backend
        self.cross_encoder = cross_encoder
        self.encoder = encoder
        self.llm = llm  # LocalLLM (needed for attention provenance)
        self.extra_retrievers = list(extra_retrievers)

    # -- decision stages -------------------------------------------------------

    def should_fetch_new_documents(self, prompt: str,
                                   history: Sequence[Message]) -> bool:
        """No history → always fetch; else LLM yes/no
        (RAGHelper_local.py:219-226)."""
        if not history:
            return True
        p = self.cfg.prompts
        msgs = [{"role": "system", "content": p.rag_fetch_new_instruction},
                {"role": "user",
                 "content": p.rag_fetch_new_question.replace("{question}", prompt)}]
        reply = self.backend.chat(msgs, max_new_tokens=16,
                                  temperature=self.cfg.generation.temperature,
                                  repetition_penalty=self.cfg.generation.repetition_penalty)
        return _is_yes(reply)

    def handle_rewrite(self, query: str, docs: List[Chunk]) -> Optional[str]:
        """Ask if docs answer the query; if 'no', rewrite once
        (RAGHelper_local.py:173-188). Returns the rewritten query or None.

        With ``shared_context_layout`` (default) the ask leads with the
        SAME system block the generate thread uses (rag_instruction +
        context) so, under a paged-KV prefix cache, the generate forward
        of this very request reuses the ask's context pages instead of
        re-prefilling them (intra-request hit; at 16k context this removes
        most of the second forward's prefill)."""
        p = self.cfg.prompts
        context = format_documents(docs)
        if getattr(self.cfg.pipeline, "shared_context_layout", False):
            ask = [{"role": "system",
                    "content": p.rag_instruction.replace("{context}", context)},
                   {"role": "user",
                    "content": p.rewrite_query_shared_question.replace(
                        "{question}", query)}]
        else:
            ask = [{"role": "system",
                    "content": p.rewrite_query_instruction.replace("{context}", context)},
                   {"role": "user",
                    "content": p.rewrite_query_question.replace("{question}", query)}]
        verdict = self.backend.chat(ask, max_new_tokens=8,
                                    temperature=self.cfg.generation.temperature,
                                    repetition_penalty=self.cfg.generation.repetition_penalty)
        if _is_yes(verdict):
            return None
        rewrite = [{"role": "user",
                    "content": p.rewrite_query_prompt.replace("{question}", query)}]
        return self.backend.chat(rewrite, max_new_tokens=128,
                                 temperature=self.cfg.generation.temperature,
                                 repetition_penalty=self.cfg.generation.repetition_penalty).strip()

    # -- document assembly ------------------------------------------------------

    def _gather_documents(self, query: str) -> List[Chunk]:
        """Extra (graph) retrievers first, then hybrid; cap at
        max_document_limit (RAGHelper_cloud.py:170-200)."""
        docs: List[Chunk] = []
        for r in self.extra_retrievers:
            try:
                docs.extend(r.retrieve(query))
            except Exception as e:  # graph errors are non-fatal (cloud helper behavior)
                logger.warning("extra retriever failed: %s", e)
        docs.extend(self.retriever.retrieve(query))
        seen = set()
        out = []
        for d in docs:
            if d.id not in seen:
                seen.add(d.id)
                out.append(d)
        return out[:self.cfg.retrieval.max_document_limit]

    def _build_thread(self, question: str, history: Sequence[Message],
                      docs: List[Chunk], fetch_new: bool = True
                      ) -> List[Message]:
        """Prompt-thread assembly (RAGHelper_local.py:228-239).

        Follow-up without a fetch (``fetch_new=False``): the thread is the
        sanitized history + the follow-up question — NO new system message
        (reference parity; history[0] already carries the turn-1 system
        block with its baked context). This also makes the follow-up's
        token stream a strict extension of the previous turn's registered
        pages, so the paged-KV prefix cache skips re-prefilling the whole
        prior thread (the 16k system+docs block dominates).

        With a fetch (or no history): a fresh system rag_instruction with
        the new context leads. Deviation from the reference kept on
        purpose: the reference DISCARDS history when fetching new
        documents (RAGHelper_local.py:231-233, ``thread = []``) — we keep
        it so multi-turn conversations survive a re-retrieval
        (test_thread_has_context_and_history codifies this).
        """
        p = self.cfg.prompts
        thread: List[Message] = []
        if fetch_new or not history:
            context = format_documents(docs)
            thread.append(
                {"role": "system",
                 "content": p.rag_instruction.replace("{context}", context)})
        for m in history:
            thread.append({"role": m.get("role", "user"),
                           "content": str(m.get("content", ""))})
        tmpl = p.rag_question_initial if not history else p.rag_question_followup
        thread.append({"role": "user",
                       "content": tmpl.replace("{question}", question)})
        return thread

    # -- provenance ---------------------------------------------------------------

    def track_provenance(self, query: str, answer: str,
                         docs: List[Chunk]) -> List[Chunk]:
        method = self.cfg.pipeline.provenance_method
        include_q = self.cfg.pipeline.provenance_include_query
        p = self.cfg.prompts
        try:
            if method == "rerank":
                if self.cross_encoder is None:
                    return docs
                scores = prov.compute_rerank_provenance(
                    self.cross_encoder, query, answer, docs,
                    include_query=include_q)
            elif method == "similarity":
                if self.encoder is None:
                    return docs
                scores = prov.compute_similarity_provenance(
                    self.encoder, query, answer, docs, include_query=include_q)
            elif method == "llm":
                scores = prov.compute_llm_provenance(
                    lambda s: self.backend.complete(
                        s, max_new_tokens=8,
                        temperature=self.cfg.generation.temperature),
                    p.provenance_llm_prompt, query, answer, docs)
            elif method == "attention":
                if self.llm is None:
                    return docs
                scores = prov.compute_attention_provenance(
                    self.llm, query, answer, docs, include_query=include_q)
            else:
                return docs
        except Exception as e:  # provenance must never break the reply
            logger.warning("provenance %s failed: %s", method, e)
            return docs
        return prov.attach_provenance(docs, scores)

    # -- main entry -----------------------------------------------------------------

    def handle_user_interaction(self, prompt: str,
                                history: Optional[Sequence[Message]] = None
                                ) -> Dict:
        history = list(history or [])
        gen = self.cfg.generation
        timings: Dict[str, float] = {}

        t0 = time.perf_counter()
        fetch_new = self.should_fetch_new_documents(prompt, history)
        timings["decision_ms"] = (time.perf_counter() - t0) * 1e3

        question = prompt
        rewritten = False
        docs: List[Chunk] = []
        if fetch_new:
            t0 = time.perf_counter()
            docs = self._gather_documents(question)
            timings["retrieval_ms"] = (time.perf_counter() - t0) * 1e3
            if self.cfg.pipeline.use_rewrite_loop and docs is not None:
                rw = self.handle_rewrite(question, docs)
                if rw:
                    question = rw
                    rewritten = True
                    t0 = time.perf_counter()
                    docs = self._gather_documents(question)
                    timings["retrieval_rewrite_ms"] = (time.perf_counter() - t0) * 1e3

        # Re2: read the question twice (RAGHelper_local.py:209-210)
        final_question = question
        if self.cfg.pipeline.use_re2:
            final_question = question + "\n" + self.cfg.prompts.re2_prompt + question

        thread = self._build_thread(final_question, history, docs, fetch_new)
        t0 = time.perf_counter()
        reply = self.backend.chat(thread, max_new_tokens=gen.max_new_tokens,
                                  temperature=gen.temperature,
                                  repetition_penalty=gen.repetition_penalty)
        timings["generation_ms"] = (time.perf_counter() - t0) * 1e3

        if fetch_new and docs and self.cfg.pipeline.use_provenance:
            t0 = time.perf_counter()
            docs = self.track_provenance(question, reply, docs)
            timings["provenance_ms"] = (time.perf_counter() - t0) * 1e3

        new_history = list(history)
        if not history:
            new_history.append({"role": "system",
                                "content": thread[0]["content"]})
        new_history.append({"role": "user", "content": prompt})
        new_history.append({"role": "assistant", "content": reply})

        documents = [{
            "s": d.source,
            "c": d.content,
            **({"pk": d.metadata["pk"]} if "pk" in d.metadata else {}),
            **({"provenance": d.metadata["provenance"]}
               if "provenance" in d.metadata else {}),
        } for d in docs]

        return {
            "reply": reply,
            "history": new_history,
            "documents": documents,
            "rewritten": rewritten,
            "question": question,
            "fetched_new_documents": fetch_new,
            "timings": timings,
        }
