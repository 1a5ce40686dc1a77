"""The port's tokenizer reader in the system, against the JAX package's wheel.

- A tiny f32 Llama checkpoint with a Llama-3-structured ``tokenizer.json``
  (tests/tokenizer_fixtures.py), loaded by both packages: the chat
  template's prompt ids equal, its special tokens as their ids, the same
  greedy stream (or a first difference at a near-tie, as
  tests/test_torch_hf_loader.py holds streams) and the same decoded text
  through ``LocalLLM.generate_text``.
- A BERT embedder and a cross-encoder with a WordPiece ``tokenizer.json``:
  the same ids and pairs, embeddings and scores within the port's
  tolerance for the bf16 checkpoint factories (2e-2).
- Every file ``tools/synthetic_tokenizer.py`` writes for
  ``tools/synthetic_checkpoint.py`` (its structures for a small config ``vocab_size``)
  loads in the wheel with the reader's ids, and the goldens the card checks
  (``tools/tokenizer_goldens.py``, the full-size files) are the wheel's ids.
"""

import json
import os

import numpy as np
import pytest
import torch
import transformers
from tokenizers import Tokenizer

import tokenizer_fixtures as fx
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)
from ragmeup_tpu.models import hf_loader as jloader
from ragmeup_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer
from ragmeup_tpu_torch.models import hf_loader, tokenizer_json
from ragmeup_tpu_torch.models.tokenizer import HFTokenizer, load_tokenizer
from ragmeup_tpu_torch.pipeline.llm_backends import llama3_template
from ragmeup_tpu_torch.tools import synthetic_tokenizer as st
from ragmeup_tpu_torch.tools.tokenizer_goldens import GOLDEN_IDS

MESSAGES = [{"role": "system", "content": "You answer from the notes."},
            {"role": "user", "content": "What do the notes say about kalomi? 😀 日本"}]


def _save(model, tok_dir, path, generation=None):
    model.save_pretrained(str(path), safe_serialization=True)
    os.symlink(os.path.join(tok_dir, "tokenizer.json"), os.path.join(path, "tokenizer.json"))
    if generation:
        with open(os.path.join(path, "generation_config.json"), "w") as f:
            json.dump(generation, f)
    return str(path)


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    root = tmp_path_factory.mktemp("llama3")
    tok_dir = fx.llama3(str(root / "tok"))
    wheel = Tokenizer.from_file(os.path.join(tok_dir, "tokenizer.json"))
    eos = [wheel.token_to_id("<|end_of_text|>"), wheel.token_to_id("<|eot_id|>")]
    torch.manual_seed(3)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=wheel.get_vocab_size(), hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, tie_word_embeddings=False,
        torch_dtype="float32")).eval()
    return _save(model, tok_dir, root / "ckpt", {"eos_token_id": eos}), wheel


def test_llama3_chat_prompt_stream_and_text_match_jax(llama):
    d, wheel = llama
    port = hf_loader.load_local_llm(d, device="cpu")
    jax_llm = jloader.load_local_llm(d)
    assert isinstance(port.tokenizer, HFTokenizer)
    assert port.eos_ids == jax_llm.eos_ids == {wheel.token_to_id("<|end_of_text|>"),
                                               wheel.token_to_id("<|eot_id|>")}
    prompt = llama3_template(MESSAGES)
    ids = port.tokenizer.encode(prompt)
    assert ids == jax_llm.tokenizer.encode(prompt) == wheel.encode(prompt).ids
    specials = [wheel.token_to_id(t) for t in ("<|begin_of_text|>", "<|start_header_id|>",
                                                "<|end_header_id|>", "<|eot_id|>")]
    assert ids[:3] == [specials[0], specials[0], specials[1]]
    assert ids.count(specials[3]) == 2 and ids.count(specials[2]) == 3
    got = port.generate(ids, max_new_tokens=16, temperature=0.0, repetition_penalty=1.0)
    want = jax_llm.generate(ids, max_new_tokens=16, temperature=0.0, repetition_penalty=1.0)
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        assert got == want
        text = port.generate_text(prompt, max_new_tokens=16, temperature=0.0,
                                  repetition_penalty=1.0)
        assert text == jax_llm.generate_text(prompt, max_new_tokens=16, temperature=0.0,
                                             repetition_penalty=1.0)
        assert text == wheel.decode(got)
    else:  # a near-tie: within one bf16 ulp of the largest logit
        logits = port.forward_logits(ids + got[:n])
        ulp = 2.0 ** (np.floor(np.log2(np.abs(logits).max())) - 7)
        assert abs(float(logits[got[n]]) - float(logits[want[n]])) <= ulp
    assert port.tokenizer.decode(got) == jax_llm.tokenizer.decode(got)


def _bert_dir(root, tok_dir, name, num_labels=None):
    wheel = Tokenizer.from_file(os.path.join(tok_dir, "tokenizer.json"))
    cfg = transformers.BertConfig(
        vocab_size=wheel.get_vocab_size(), hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, max_position_embeddings=128,
        type_vocab_size=2, initializer_range=0.2)
    torch.manual_seed(1)
    if num_labels:
        cfg.num_labels = num_labels
        model = transformers.BertForSequenceClassification(cfg).eval()
    else:
        model = transformers.BertModel(cfg).eval()
    return _save(model, tok_dir, root / name)


def test_wordpiece_encoders_match_jax(tmp_path):
    tok_dir = fx.bert(str(tmp_path / "tok"))
    texts = fx.hazard_strings(3, 24)[1:] + ["the quick brown fox", "kalomi notes 2024"]
    enc_dir = _bert_dir(tmp_path, tok_dir, "encoder")
    enc_t = hf_loader.load_sentence_encoder(enc_dir, device="cpu")
    enc_j = jloader.load_sentence_encoder(enc_dir)
    assert isinstance(enc_t.tokenizer, HFTokenizer)
    for t in texts:
        assert enc_t.tokenizer.encode(t) == enc_j.tokenizer.encode(t), t
    np.testing.assert_allclose(enc_t.encode(texts), np.asarray(enc_j.encode(texts)),
                               atol=2e-2)
    ce_dir = _bert_dir(tmp_path, tok_dir, "cross", num_labels=1)
    ce_t = hf_loader.load_cross_encoder(ce_dir, device="cpu")
    ce_j = jloader.load_cross_encoder(ce_dir)
    pairs = [(texts[-1], t) for t in texts]
    for a, b in pairs:
        assert (ce_t.tokenizer.encode_pair(a, b, max_len=ce_t.max_len)
                == ce_j.tokenizer.encode_pair(a, b, max_len=ce_j.max_len))
    np.testing.assert_allclose(ce_t.score(pairs), np.asarray(ce_j.score(pairs)), atol=2e-2)


# -- the synthetic checkpoints' files ------------------------------------------------

# each model's tokenizer for a small config vocab_size: model vocabularies of
# 600 (Llama-3, Qwen), 900 (Mixtral, Phi-3), 1000 (Gemma) and 700 (BERT)
SMALL = {"llama31_8b": 856, "qwen25_7b": 622, "qwen3_30b_a3b": 626, "mixtral_8x7b": 900,
         "phi3_mini_4k": 911, "gemma_7b": 1000, "gemma2_9b": 1000, "gist_small": 700,
         "minilm_l6_cross": 700}


@pytest.mark.parametrize("model", list(st.STRUCTURES))
def test_synthetic_tokenizers_load_in_the_wheel_with_the_readers_ids(tmp_path, model):
    d = str(tmp_path)
    r = st.write_tokenizer(d, model, seed=5, vocab_size=SMALL[model])
    path = os.path.join(d, "tokenizer.json")
    wheel, port, jax_tok = Tokenizer.from_file(path), load_tokenizer(d), jax_load_tokenizer(d)
    assert r["tokens"] == wheel.get_vocab_size() == port.vocab_size == SMALL[model]
    obj = json.load(open(path, encoding="utf-8"))
    merges = obj["model"].get("merges", [])
    vocab = obj["model"]["vocab"]
    for merge in merges:   # valid BPE: both parts and the result are tokens
        a, b = merge.split(" ") if isinstance(merge, str) else merge
        assert a in vocab and b in vocab and a + b in vocab
    for s in fx.hazard_strings(2, 120) + list(st.GOLDEN_STRINGS):
        assert port.encode(s) == jax_tok.encode(s) == wheel.encode(s).ids, s
        ids = wheel.encode(s).ids
        assert port.decode(ids) == jax_tok.decode(ids), s
    assert port.encode_pair("a b", "c d") == jax_tok.encode_pair("a b", "c d")
    assert port.pad_id == jax_tok.pad_id


def test_synthetic_special_ids_sit_where_the_configs_put_them(tmp_path):
    """The EOS / BOS / PAD ids of generation_config.json, and BERT's."""
    from ragmeup_tpu_torch.tools.synthetic_checkpoint import MODELS
    for model, names in {"llama31_8b": {128000: "<|begin_of_text|>",
                                        128001: "<|end_of_text|>", 128009: "<|eot_id|>"},
                         "qwen25_7b": {151643: "<|endoftext|>", 151645: "<|im_end|>"},
                         "qwen3_30b_a3b": {151645: "<|im_end|>"},
                         "mixtral_8x7b": {1: "<s>", 2: "</s>"},
                         "phi3_mini_4k": {1: "<s>", 32000: "<|endoftext|>",
                                          32001: "<|assistant|>", 32007: "<|end|>"},
                         "gemma_7b": {0: "<pad>", 1: "<eos>", 2: "<bos>"},
                         "gist_small": {0: "[PAD]", 100: "[UNK]", 101: "[CLS]",
                                        102: "[SEP]", 103: "[MASK]"}}.items():
        obj = st.tokenizer_file(model, vocab=None if model != "gemma_7b" else 1000)
        reader = tokenizer_json.Tokenizer(obj)
        for tid, token in names.items():
            assert reader.id_to_token(tid) == token, (model, tid)
        assert max(st.file_ids(obj)) < MODELS[model][0]["vocab_size"], model
        generation = MODELS[model][1] or {}
        for key in ("eos_token_id", "bos_token_id", "pad_token_id"):
            for tid in np.atleast_1d(generation.get(key, [])).tolist():
                assert tid in names, (model, key, tid)


@pytest.mark.parametrize("structure", list(st.GOLDEN_MODELS))
def test_goldens_are_the_wheels_ids(tmp_path, structure):
    d = str(tmp_path)
    st.write_tokenizer(d, st.GOLDEN_MODELS[structure], seed=st.GOLDEN_SEED)
    wheel = Tokenizer.from_file(os.path.join(d, "tokenizer.json"))
    reader = load_tokenizer(d)
    want = [wheel.encode(s).ids for s in st.GOLDEN_STRINGS]
    assert GOLDEN_IDS[structure] == want
    assert [reader.encode(s) for s in st.GOLDEN_STRINGS] == want
