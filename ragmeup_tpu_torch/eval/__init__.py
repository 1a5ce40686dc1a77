from ragmeup_tpu_torch.eval.generative import generate_qa_pairs, evaluate_pairs
from ragmeup_tpu_torch.eval.metrics import (
    answer_relevancy, faithfulness, contextual_precision, contextual_recall,
    hallucination_score, retrieval_recall_at_k,
)

__all__ = [
    "generate_qa_pairs",
    "evaluate_pairs",
    "answer_relevancy",
    "faithfulness",
    "contextual_precision",
    "contextual_recall",
    "hallucination_score",
    "retrieval_recall_at_k",
]

from ragmeup_tpu_torch.eval.metrics import (  # noqa: E402
    counterfactual_error_handling, long_distance_information_extraction,
)

__all__ += ["counterfactual_error_handling",
            "long_distance_information_extraction"]
