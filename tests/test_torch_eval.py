"""The port's eval harness against the JAX package's: every metric of
``eval/metrics.py`` on the same stub encoder (to 1e-6), the answer metrics
on the port's ``SentenceEncoder`` against JAX's with the same converted
weights (to 1e-4), and ``generate_qa_pairs`` / ``evaluate_pairs`` /
``build_eval_dataset`` on ``StaticChatBackend`` systems."""

import dataclasses
import zlib

import jax
import numpy as np
import pytest
from flax import linen as nn

from ragmeup_tpu.config import RagConfig as JaxRagConfig
from ragmeup_tpu.eval import generative as jgen
from ragmeup_tpu.eval import metrics as jM
from ragmeup_tpu.models import encoder as jenc
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.pipeline.llm_backends import StaticChatBackend as JaxStatic
from ragmeup_tpu.pipeline.system import RagSystem as JaxRagSystem
from ragmeup_tpu_torch.config import RagConfig
from ragmeup_tpu_torch.eval import generative
from ragmeup_tpu_torch.eval import metrics as M
from ragmeup_tpu_torch.models import convert, encoder, tokenizer
from ragmeup_tpu_torch.pipeline.llm_backends import StaticChatBackend
from ragmeup_tpu_torch.pipeline.system import RagSystem
from ragmeup_tpu_torch.retrieval.sparse import analyze
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

Q = "what does the fox do"
GOOD = "The fox jumps over the lazy dog. It is quick and brown."
BAD = "Stock markets rallied strongly on earnings."
REFUSAL = "I cannot find that in the documents; the premise seems false."
CTX = ["The quick brown fox jumps over the lazy dog.",
       "Foxes live in forests and cities.", "TPU chips use a systolic array."]


class _Enc:
    def encode(self, texts, d=64):
        out = np.zeros((len(texts), d), np.float32)
        for i, t in enumerate(texts):
            for tok in analyze(t):
                out[i, zlib.crc32(tok.encode()) % d] += 1.0
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


# (function name, args after the encoder, keyword args)
ENCODER_CASES = [
    ("calibrate_baseline", (), {}),
    ("answer_relevancy", (Q, GOOD), {}), ("answer_relevancy", (Q, BAD), {}),
    ("faithfulness", (GOOD, CTX), {}), ("faithfulness", (BAD, CTX), {}),
    ("faithfulness", (GOOD, []), {}),
    ("hallucination_score", (GOOD, CTX), {}),
    ("contextual_precision", (Q, CTX), {}),
    ("contextual_precision", (Q, CTX[::-1]), {"relevance_threshold": 0.3}),
    ("contextual_precision", (Q, []), {}),
    ("contextual_recall", (GOOD, CTX), {}), ("contextual_recall", (BAD, CTX[2:]), {}),
    ("contextual_relevancy", (Q, CTX), {}), ("contextual_relevancy", (Q, []), {}),
    ("counterfactual_error_handling", (Q, GOOD, CTX), {}),
    ("counterfactual_error_handling", (Q, REFUSAL, CTX), {}),
    ("counterfactual_error_handling", (Q, GOOD, CTX), {"chat_fn": lambda p: "Score: 6"}),
    ("long_distance_information_extraction", (Q, GOOD, CTX), {}),
    ("long_distance_information_extraction", (Q, GOOD, CTX),
     {"support_threshold": 0.2}),
    ("long_distance_information_extraction", (Q, GOOD, CTX), {"chat_fn": lambda p: "9"}),
]


@pytest.mark.parametrize("name,args,kwargs", ENCODER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ENCODER_CASES)])
def test_encoder_metrics_match_jax(name, args, kwargs):
    got = getattr(M, name)(_Enc(), *args, **kwargs)
    want = getattr(jM, name)(_Enc(), *args, **kwargs)
    assert got == pytest.approx(want, abs=1e-6)
    assert 0.0 <= got <= 1.0 or name == "calibrate_baseline"


def test_plain_metrics_match_jax():
    for reply in ("Score: 7", "no numbers here", "100", "3.5 of 10"):
        assert M.llm_judge_score(lambda s: reply, "p") == \
            jM.llm_judge_score(lambda s: reply, "p")
    got, want = [[1, 2, 3], [4, 5], []], [[1, 2, 9], [4, 5], [7]]
    for k in (1, 2, 3, 10):
        assert M.retrieval_recall_at_k(got, want, k=k) == \
            jM.retrieval_recall_at_k(got, want, k=k)
    for called, expected in ((["retriever"], ["retriever"]), ([], ["retriever"]),
                             (["retriever", "rewriter"], ["retriever", "provenance"]),
                             ([], [])):
        for strict in (False, True):
            assert M.tool_correctness(called, expected, strict=strict) == \
                jM.tool_correctness(called, expected, strict=strict)
    for resp in ({"fetched_new_documents": True, "rewritten": True,
                  "documents": [{"s": "a.txt", "c": "x", "provenance": 0.5},
                                {"s": "graph_db", "c": "row"}]},
                 {"reply": "hi"}, {"fetched_new_documents": False, "documents": []}):
        assert M.tools_called_from_response(resp) == jM.tools_called_from_response(resp)


def test_answer_metrics_on_the_ports_encoder():
    """The port's SentenceEncoder on the CPU and JAX's, one set of weights."""
    bcfg = dict(dataclasses.asdict(jenc.BertConfig.tiny()), dtype="float32")
    j_enc = jenc.SentenceEncoder(jenc.BertConfig(**bcfg),
                                 jtok.SimpleTokenizer(bcfg["vocab_size"]), seed=0)
    tb = encoder.BertConfig(**bcfg)
    params = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(j_enc.params))
    t_enc = encoder.SentenceEncoder(tb, tokenizer.SimpleTokenizer(tb.vocab_size),
                                    model=convert.encoder_from_flax(tb, params))
    assert M.calibrate_baseline(t_enc) == pytest.approx(jM.calibrate_baseline(j_enc),
                                                        abs=1e-4)
    for name, args in (("answer_relevancy", (Q, GOOD)), ("faithfulness", (GOOD, CTX)),
                       ("hallucination_score", (BAD, CTX)),
                       ("contextual_precision", (Q, CTX)),
                       ("contextual_recall", (GOOD, CTX)),
                       ("contextual_relevancy", (Q, CTX)),
                       ("counterfactual_error_handling", (Q, REFUSAL, CTX)),
                       ("long_distance_information_extraction", (Q, GOOD, CTX))):
        assert getattr(M, name)(t_enc, *args) == \
            pytest.approx(getattr(jM, name)(j_enc, *args), abs=1e-4), name


def _system(root, monkeypatch, config_cls, system_cls, static, **kw):
    (root / "data").mkdir(parents=True)
    for name, text in (("fox.txt", CTX[0]), ("den.txt", CTX[1]), ("tpu.txt", CTX[2]),
                       ("fin.txt", BAD)):
        (root / "data" / name).write_text(text)
    monkeypatch.chdir(root)  # relative sources: the eval prompts quote them
    cfg = config_cls()
    cfg.data.data_directory, cfg.data.index_directory = "data", "index"
    cfg.model.embedding_dim = 64
    cfg.retrieval.dense_dtype = "float32"
    cfg.retrieval.rerank = False
    cfg.pipeline.use_provenance = False
    cfg.pipeline.use_rewrite_loop = True
    backend = static(rules=[("Generate a question", "What does the fox do?"),
                            ("Answer the following question", "The fox jumps.")],
                     default="The fox jumps over the lazy dog.")
    return system_cls(cfg, encoder=_Enc(), backend=backend, **kw)


def test_generate_and_evaluate_pairs_match_jax(tmp_path, monkeypatch):
    out = {}
    for side, config_cls, system_cls, static, mod, kw in (
            ("jax", JaxRagConfig, JaxRagSystem, JaxStatic, jgen, {}),
            ("torch", RagConfig, RagSystem, StaticChatBackend, generative,
             {"device": "cpu"})):
        system = _system(tmp_path / side, monkeypatch, config_cls, system_cls, static, **kw)
        pairs = mod.generate_qa_pairs(system, sample_size=3, qa_count=2, seed=1)
        res = mod.evaluate_pairs(system, pairs)
        judged = mod.evaluate_pairs(system, pairs[:1], judge_fn=lambda p: "7")
        kept = system.cfg.pipeline.use_rewrite_loop
        dataset = mod.build_eval_dataset(system, sample_size=2, qa_count=1, seed=3)
        out[side] = (pairs, res, judged, kept, dataset, mod._expected_tools(system),
                     system.backend.calls, mod.generate_qa_pairs(system, 3, 0))
    assert out["torch"] == out["jax"]
    pairs, res, judged, kept = out["torch"][:4]
    assert len(pairs) == 2 and kept is True
    assert set(res["summary"]) >= {"answer_relevancy", "faithfulness", "tool_correctness"}
    assert judged["summary"]["llm_judge"]["mean"] == pytest.approx(0.7)
