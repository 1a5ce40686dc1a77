from ragmeup_tpu_torch.graph.store import PropertyGraph, CypherError
from ragmeup_tpu_torch.graph.retriever import GraphRetriever, csv_to_graph, text_to_graph_llm
from ragmeup_tpu_torch.graph.client import RemoteGraphClient

__all__ = ["PropertyGraph", "CypherError", "GraphRetriever",
           "RemoteGraphClient", "csv_to_graph", "text_to_graph_llm"]
