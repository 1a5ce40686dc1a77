"""The port stands alone: no module of ``ragmeup_tpu_torch`` (nor
``chip_smoke.py``) imports jax, flax, the JAX package, or the packages the
card does not have (safetensors, ml_dtypes, transformers, werkzeug,
requests, and the tokenizer libraries tokenizers, regex and sentencepiece),
its copies of the
JAX package's host modules (config, data loaders and splitters, pipeline)
behave as the originals, and its entry points run on the card unless they
are given ``device="cpu"``.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ragmeup_tpu import config as jconfig
from ragmeup_tpu.data import loaders as jloaders
from ragmeup_tpu.data import splitters as jsplitters
from ragmeup_tpu_torch import RagConfig, load_config
from ragmeup_tpu_torch.data import loaders, splitters
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ragmeup_tpu", "safetensors", "ml_dtypes",
             "transformers", "werkzeug", "requests", "tokenizers", "regex", "sentencepiece")


def _port_sources():
    root = os.path.join(REPO, "ragmeup_tpu_torch")
    paths = [os.path.join(d, f) for d, _, files in os.walk(root)
             for f in files if f.endswith(".py")]
    return sorted(paths) + [os.path.join(REPO, "chip_smoke.py")]


def _imported_modules(path):
    """Every module an import statement in ``path`` names, at any depth
    (inside functions and classes too)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    paths = _port_sources()
    assert len(paths) > 30
    for new in ("models/safetensors.py", "tools/synthetic_checkpoint.py",
                "server/app.py", "server/wsgi.py", "server/ui.py", "graph/sidecar.py",
                "graph/client.py", "eval/generative.py", "train/__init__.py",
                "train/train.py", "train/checkpoint.py", "parallel/dcn.py",
                "tools/dcn_dryrun.py", "models/tokenizer_json.py",
                "tools/synthetic_tokenizer.py", "tools/tokenizer_goldens.py"):
        assert os.path.join(REPO, "ragmeup_tpu_torch", new) in paths
    bad = [(os.path.relpath(p, REPO), m) for p in paths
           for m in _imported_modules(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_scan_catches_nested_imports(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("def f():\n    from ragmeup_tpu.ops import topk\n"
                   "    import jax.numpy as jnp\n"
                   "import ragmeup_tpu_torch.ops\n")
    roots = [m.split(".")[0] for m in _imported_modules(str(src))]
    assert [r for r in roots if r in FORBIDDEN] == ["ragmeup_tpu", "jax"]
    src.write_text("import requests\nfrom werkzeug.utils import secure_filename\n")
    assert [m.split(".")[0] for m in _imported_modules(str(src))] == \
        ["requests", "werkzeug"]


def test_default_config_matches_jax():
    assert dataclasses.asdict(RagConfig()) == dataclasses.asdict(jconfig.RagConfig())


def test_env_file_config_matches_jax(tmp_path):
    env = tmp_path / ".env"
    env.write_text("\n".join([
        "# comment", "vector_store_k=7", "use_rewrite_loop=False",
        "batched_llm=True", "kv_page_size='64'", "llm_wave_steps=4",
        'rag_instruction="Answer briefly: {context} {question}"',
        "temperature=0.0", "rerank_k=abc", "embedding_dim = 128"]))
    got = load_config(str(env), use_environ=False)
    want = jconfig.load_config(str(env), use_environ=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.server.batched_llm and got.server.kv_page_size == 64
    assert got.retrieval.vector_store_k == 7


def _write_corpus(root):
    (root / "notes.txt").write_text(
        "Foxes are small omnivores. They live in forests and cities.\n\n"
        "A fox can run fast. " * 12)
    (root / "table.csv").write_text("title,text\nrivers,Rivers carry water to the sea.\n"
                                    "trains,The night train leaves at ten.\n")
    (root / "items.json").write_text(json.dumps(
        [{"name": "qubit", "text": "Quantum computers use qubits."},
         {"name": "album", "text": "The band released an album."}]))
    (root / "skip.bin").write_bytes(b"\x00\x01")


def _summary(chunks):
    return [(c.content, c.metadata, c.id) for c in chunks]


def test_loaders_and_splitters_match_jax(tmp_path):
    _write_corpus(tmp_path)
    kinds = ["txt", "csv", "json"]
    raw = loaders.load_directory(str(tmp_path), kinds)
    jraw = jloaders.load_directory(str(tmp_path), kinds)
    assert len(raw) >= 4 and _summary(raw) == _summary(jraw)
    for splitter in ("RecursiveCharacterTextSplitter", "SemanticChunker"):
        cfg, jcfg = RagConfig(), jconfig.RagConfig()
        for c in (cfg, jcfg):
            c.data.splitter = splitter
            c.data.chunk_size = 80
            c.data.chunk_overlap = 10

        def embed(texts):
            rng = np.random.default_rng(len(texts))
            v = rng.standard_normal((len(texts), 8)).astype(np.float32)
            return v / np.linalg.norm(v, axis=1, keepdims=True)
        got = splitters.make_splitter(cfg, embed_fn=embed).split_chunks(raw)
        want = jsplitters.make_splitter(jcfg, embed_fn=embed).split_chunks(jraw)
        assert len(got) > len(raw) and _summary(got) == _summary(want)


def test_entry_points_need_a_card_unless_given_the_cpu(monkeypatch, tmp_path):
    """Without a card every entry point raises instead of moving to the
    CPU, the loaders given a checkpoint directory too (before they read
    it); with device="cpu" it builds there."""
    from ragmeup_tpu_torch.models import decoder, encoder, hf_loader, tokenizer
    from ragmeup_tpu_torch.parallel import dcn
    from ragmeup_tpu_torch.pipeline.system import RagSystem
    from ragmeup_tpu_torch.train import make_decoder_train_step, make_encoder_train_step
    from ragmeup_tpu_torch.retrieval.dense import DenseIndex
    from ragmeup_tpu_torch.retrieval.sparse import BM25Index
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = decoder.LlamaConfig.tiny()
    tok = tokenizer.SimpleTokenizer(cfg.vocab_size)
    calls = (lambda: RagSystem(RagConfig(), eager_load=False),
             lambda: decoder.LocalLLM(cfg, tok),
             lambda: DenseIndex(8), lambda: BM25Index(),
             lambda: hf_loader.load_sentence_encoder(None, dim=64),
             lambda: hf_loader.load_cross_encoder(None),
             lambda: hf_loader.load_local_llm(None),
             lambda: hf_loader.load_sentence_encoder(str(tmp_path)),
             lambda: hf_loader.load_cross_encoder(str(tmp_path)),
             lambda: hf_loader.load_local_llm(str(tmp_path), quantization="int8"),
             lambda: make_decoder_train_step(cfg),
             lambda: make_encoder_train_step(encoder.BertConfig.tiny()),
             lambda: dcn.initialize_slice("tcp://localhost:1", 1, 0))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert decoder.LocalLLM(cfg, tok, device="cpu").device.type == "cpu"
    assert DenseIndex(8, device="cpu").device.type == "cpu"
    state, _ = make_decoder_train_step(cfg, device="cpu")
    assert state.params["token_embedding"].device.type == "cpu"
    # the server's entry point exits non-zero with resolve_device's message
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "ragmeup_tpu_torch.server", "--port", "0",
                           "--env-file", str(tmp_path / "none.env")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
