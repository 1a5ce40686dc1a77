"""Generative evaluation harness.

The reference's Ragas/DeepEval flow (``Ragas_eval.py:41-146``,
``DeepEval_eval.py:178-238``, ``server.py:183-235``): sample corpus chunks,
have the pipeline's own LLM generate a question and ground-truth answer per
sample, run the *real* pipeline on each question, then score. The rewrite
loop is disabled during eval (``Ragas_eval.py:21``).

Scoring uses the deterministic embedding metrics in ``eval/metrics.py``
(with the configured thresholds) — self-contained, no external judge.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ragmeup_tpu_torch.data.documents import format_documents
from ragmeup_tpu_torch.eval import metrics as M


def generate_qa_pairs(system, sample_size: int, qa_count: int,
                      seed: int = 0, docs_per_pair: int = 10) -> List[Dict]:
    """Sample chunks and LLM-generate (question, ground_truth, contexts)."""
    rng = random.Random(seed)
    chunks = list(system.store.live_chunks())
    rng.shuffle(chunks)
    sample = chunks[:min(sample_size, len(chunks))]
    if not sample:
        return []
    p = system.cfg.prompts
    gen = system.cfg.generation
    pairs: List[Dict] = []
    for _ in range(qa_count):
        rng.shuffle(sample)
        selected = sample[:min(docs_per_pair, len(sample))]
        context = format_documents(selected)
        question = system.backend.chat(
            [{"role": "system",
              "content": p.eval_question_instruction.replace("{context}", context)},
             {"role": "user", "content": p.eval_question_query}],
            max_new_tokens=128, temperature=gen.temperature,
            repetition_penalty=gen.repetition_penalty).strip()
        answer = system.backend.chat(
            [{"role": "system",
              "content": p.eval_answer_instruction.replace("{context}", context)},
             {"role": "user",
              "content": p.eval_answer_query.replace("{question}", question)}],
            max_new_tokens=gen.max_new_tokens, temperature=gen.temperature,
            repetition_penalty=gen.repetition_penalty).strip()
        pairs.append({"question": question, "ground_truth": answer,
                      "context": [c.content for c in selected]})
    return pairs



def _expected_tools(system) -> list:
    """Expected tool set for a fresh eval question on this system's config:
    retrieval always (no history -> must fetch, RAGHelper_local.py:219-226);
    provenance iff enabled; the graph retriever iff one is wired."""
    expected = ["retriever"]
    if system.cfg.pipeline.use_provenance:
        expected.append("provenance")
    if getattr(system, "extra_retrievers", None):
        expected.append("graph_retriever")
    return expected


_JUDGE_PROMPT = (
    "You are grading a RAG answer. Question: {q}\n\nReference answer: "
    "{gt}\n\nRetrieved context (may be partial):\n{ctx}\n\nCandidate "
    "answer: {a}\n\nScore the candidate 0-10 for correctness and "
    "grounding in the context (10 = fully correct and grounded). Reply "
    "with the score only.")


def evaluate_pairs(system, pairs: List[Dict],
                   disable_rewrite: bool = True, judge_fn=None) -> Dict:
    """Run the real pipeline per question and score (the reference's
    evaluate loop, Ragas_eval.py:117-134 + deepeval.evaluate).

    ``judge_fn`` (optional, ``prompt -> reply``, e.g. the system's own
    ``backend.complete``) adds an ``llm_judge`` metric — the reference's
    LLM-judged scoring (DeepEval_eval.py:237) with the LOCAL model as
    judge, since network judges don't exist in a self-contained
    deployment. Scored against ``eval.correctness_threshold``."""
    if not pairs:
        return {"pairs": [], "summary": {}}
    saved_rewrite = system.cfg.pipeline.use_rewrite_loop
    if disable_rewrite:
        system.cfg.pipeline.use_rewrite_loop = False  # Ragas_eval.py:21
    enc = system.encoder
    th = system.cfg.eval
    results = []
    try:
        for pair in pairs:
            out = system.chat(pair["question"], history=None)
            contexts = [d["c"] for d in out["documents"]]
            scores = {
                "answer_relevancy": M.answer_relevancy(enc, pair["question"], out["reply"]),
                "faithfulness": M.faithfulness(enc, out["reply"], contexts),
                "contextual_precision": M.contextual_precision(enc, pair["question"], contexts),
                "contextual_recall": M.contextual_recall(enc, pair["ground_truth"], contexts),
                "contextual_relevancy": M.contextual_relevancy(enc, pair["question"], contexts),
                "hallucination": M.hallucination_score(enc, out["reply"], contexts),
                # the reference's two custom metrics (DeepEval_eval.py:58-126)
                "counterfactual_error_handling": M.counterfactual_error_handling(
                    enc, pair["question"], out["reply"], contexts),
                "long_distance_information_extraction":
                    M.long_distance_information_extraction(
                        enc, pair["question"], out["reply"], contexts),
                # the 7th stock metric (DeepEval_eval.py:43-51): a fresh
                # eval question must fetch documents; provenance/graph are
                # expected iff configured on this system
                "tool_correctness": M.tool_correctness(
                    M.tools_called_from_response(out),
                    _expected_tools(system)),
            }
            if judge_fn is not None:
                scores["llm_judge"] = M.llm_judge_score(
                    judge_fn, _JUDGE_PROMPT.format(
                        q=pair["question"], gt=pair["ground_truth"],
                        ctx="\n---\n".join(contexts)[:4000],
                        a=out["reply"]))
            passed = {
                "answer_relevancy": scores["answer_relevancy"] >= th.answer_relevancy_threshold,
                "faithfulness": scores["faithfulness"] >= th.faithfulness_threshold,
                "contextual_precision": scores["contextual_precision"] >= th.contextual_precision_threshold,
                "contextual_recall": scores["contextual_recall"] >= th.contextual_recall_threshold,
                "contextual_relevancy": scores["contextual_relevancy"] >= th.contextual_relevancy_threshold,
                "hallucination": scores["hallucination"] <= th.hallucination_threshold,
                "counterfactual_error_handling":
                    scores["counterfactual_error_handling"] >= th.correctness_threshold,
                "long_distance_information_extraction":
                    scores["long_distance_information_extraction"] >= th.correctness_threshold,
                "tool_correctness":
                    scores["tool_correctness"] >= th.tool_correctness_threshold,
            }
            if judge_fn is not None:
                passed["llm_judge"] = (scores["llm_judge"]
                                       >= th.correctness_threshold)
            results.append({"question": pair["question"],
                            "answer": out["reply"],
                            "ground_truth": pair["ground_truth"],
                            "contexts": contexts,
                            "scores": scores, "passed": passed})
    finally:
        system.cfg.pipeline.use_rewrite_loop = saved_rewrite
    summary = {}
    for metric in results[0]["scores"]:
        vals = [r["scores"][metric] for r in results]
        summary[metric] = {"mean": sum(vals) / len(vals),
                           "pass_rate": sum(r["passed"][metric] for r in results) / len(results)}
    return {"pairs": results, "summary": summary}


def build_eval_dataset(system, sample_size: Optional[int] = None,
                       qa_count: Optional[int] = None, seed: int = 0) -> List[Dict]:
    """The Ragas dataset shape {question, answer, contexts, ground_truth}
    (Ragas_eval.py:137-146) — exported for external judges."""
    cfg = system.cfg.eval
    pairs = generate_qa_pairs(system, sample_size or cfg.sample_size,
                              qa_count or cfg.qa_pairs, seed=seed)
    out = []
    for pair in pairs:
        res = system.chat(pair["question"], history=None)
        out.append({"question": pair["question"], "answer": res["reply"],
                    "contexts": [d["c"] for d in res["documents"]],
                    "ground_truth": pair["ground_truth"]})
    return out
