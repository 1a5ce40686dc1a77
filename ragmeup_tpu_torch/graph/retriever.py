"""GraphRAG: LLM→Cypher retrieval and graph ingestion flows.

Retrieval semantics from ``RAGHelper_cloud.graph_retriever``
(``RAGHelper_cloud.py:424-513``): fetch the schema, build a schema-aware
prompt with few-shots, let the LLM emit a Cypher query or "None", run it,
and join the result rows into a single Document with ``source="graph_db"``.
Failures are logged and produce no documents (the reference's behavior).

Ingestion flows from ``RAGHelper.py:568-710``:
- ``csv_to_graph``: CSV rows → MERGE Cypher batch (add_csv_to_graphdb).
- ``text_to_graph_llm``: schema prompt + document text → LLM emits a JSON
  array of {query, parameters} → validated → executed
  (add_document_to_graphdb; the reference escapes braces and parses JSON
  the same way).
"""

from __future__ import annotations

import csv as _csv
import json
import logging
import re
from typing import List, Optional, Sequence

from ragmeup_tpu_torch.data.documents import Chunk

logger = logging.getLogger("ragmeup_tpu_torch.graph")


def format_schema(schema: dict) -> str:
    """Render the /schema dict for prompts (RAGHelper_cloud.py:515-534)."""
    lines = ["Nodes:"]
    for nl in schema.get("node_labels", []):
        props = ", ".join(nl.get("properties", [])) or "No properties"
        lines.append(f"- {nl['label']}: {props}")
    lines.append("Relationships:")
    for rt in schema.get("relationship_types", []):
        props = ", ".join(rt.get("properties", [])) or "No properties"
        lines.append(f"- {rt['type']}: {props}")
    return "\n".join(lines)


def few_shot_from_schema(schema: dict) -> str:
    """Generate few-shot examples from the live schema
    (RAGHelper_cloud.py:536-567 shape)."""
    shots = []
    labels = schema.get("node_labels", [])
    if labels:
        lb = labels[0]
        prop = (lb.get("properties") or ["name"])[0]
        shots.append(
            f"Example 1:\nUser query: 'What {lb['label'].lower()}s are "
            f"available?'\nOutput: MATCH (n:{lb['label']}) RETURN n.{prop}")
    shots.append("Example 2:\nUser query: 'What is the size of an elephant?'"
                 "\nOutput: None")
    return "Few-shot examples:\n" + "\n\n".join(shots)


_CYPHER_FENCE_RE = re.compile(r"```(?:cypher)?\s*(.*?)```", re.S)


def extract_cypher(reply: str) -> Optional[str]:
    """Pull the Cypher (or None) out of an LLM reply."""
    reply = (reply or "").strip()
    m = _CYPHER_FENCE_RE.search(reply)
    if m:
        reply = m.group(1).strip()
    if not reply or reply.lower().startswith("none"):
        return None
    return reply


class GraphRetriever:
    """Pluggable over any graph backend exposing .schema() and .run()."""

    def __init__(self, graph, backend, prompts, max_rows: int = 25):
        self.graph = graph
        self.backend = backend
        self.prompts = prompts
        self.max_rows = max_rows

    def generate_cypher(self, question: str) -> Optional[str]:
        schema_str = format_schema(self.graph.schema())
        p = self.prompts
        msgs = [
            {"role": "system",
             "content": p.graph_retrieval_instruction.replace("{schema}", schema_str)
             + "\n" + (p.graph_retrieval_few_shot or few_shot_from_schema(self.graph.schema()))},
            {"role": "user",
             "content": p.graph_retrieval_question.replace("{question}", question)},
        ]
        reply = self.backend.chat(msgs, max_new_tokens=256, temperature=0.0)
        return extract_cypher(reply)

    def retrieve(self, question: str) -> List[Chunk]:
        """→ at most one Chunk(source='graph_db') holding the joined rows
        (RAGHelper_cloud.py:478-509)."""
        try:
            cypher = self.generate_cypher(question)
            if not cypher:
                return []
            rows = self.graph.run(cypher)
            if not rows:
                return []
            text = "\n".join(json.dumps(r, ensure_ascii=False, default=str)
                             for r in rows[:self.max_rows])
            return [Chunk(content=text,
                          metadata={"source": "graph_db", "cypher": cypher})]
        except Exception as e:  # graph errors are non-fatal
            logger.warning("graph retrieval failed: %s", e)
            return []


def csv_to_graph(graph, csv_path: str, label: str = "Row",
                 batch: bool = True) -> int:
    """CSV → MERGE per row (add_csv_to_graphdb, RAGHelper.py:568-598):
    each row becomes a node with its columns as properties."""
    instances = []
    with open(csv_path, newline="", encoding="utf-8", errors="replace") as f:
        reader = _csv.DictReader(f)
        for row in reader:
            props = {k: v for k, v in row.items() if v not in (None, "")}
            if not props:
                continue
            keys = list(props.keys())
            pattern = ", ".join(f"{_ident(k)}: ${_ident(k)}" for k in keys)
            instances.append({
                "query": f"MERGE (r:{label} {{{pattern}}})",
                "parameters": {_ident(k): props[k] for k in keys},
            })
    return graph.add_instances(instances)


def _ident(name: str) -> str:
    out = re.sub(r"[^A-Za-z0-9_]", "_", name)
    return out if out and not out[0].isdigit() else "c_" + out


_JSON_ARRAY_RE = re.compile(r"\[.*\]", re.S)


def text_to_graph_llm(graph, backend, prompts, text: str,
                      dynamic_schema: bool = False,
                      max_instances: int = 9) -> int:
    """LLM-driven insertion (add_document_to_graphdb, RAGHelper.py:600-710):
    prompt with schema (live if dynamic) + the text; parse the JSON array of
    {query, parameters}; execute at most max_instances."""
    p = prompts
    if dynamic_schema:
        schema_str = format_schema(graph.schema())
        prompt = (p.graph_insert_schema
                  .replace("{schema}", schema_str)
                  .replace("{data}", text))
    else:
        prompt = p.graph_insert_data_only.replace("{data}", text)
    system = p.graph_insert_instruction
    if getattr(p, "graph_insert_few_shot", ""):
        system = system + "\n" + p.graph_insert_few_shot
    msgs = [{"role": "system", "content": system},
            {"role": "user", "content": prompt}]
    reply = backend.chat(msgs, max_new_tokens=1024, temperature=0.0) or ""
    if reply.strip().lower().startswith("none"):
        return 0
    m = _JSON_ARRAY_RE.search(reply)
    if not m:
        logger.warning("graph insert: no JSON array in LLM reply")
        return 0
    try:
        instances = json.loads(m.group(0))
    except json.JSONDecodeError as e:
        logger.warning("graph insert: bad JSON: %s", e)
        return 0
    valid = [i for i in instances
             if isinstance(i, dict) and isinstance(i.get("query"), str)]
    return graph.add_instances(valid[:max_instances])
