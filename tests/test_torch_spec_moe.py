"""Speculative decoding on the port's MoE decoders against the JAX
package's: the tiny float-expert decoder of test_torch_moe.py and the
tiny packed-int4-expert decoder of test_torch_moe_int4.py, on the same
weights. At T = 0 ``generate`` takes ``generate_speculative`` in both
packages, and its verify forwards route 8 tokens at once: another MoE
route than a decode step's.
"""

import numpy as np
import pytest

from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import hf_loader as jloader
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu_torch.models import convert, decoder, tokenizer
import test_torch_moe
import test_torch_moe_int4
from test_torch_moe import _numpy_tree
from test_torch_spec import _both
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)


def _moe_pair(kind):
    """(JAX, port) over the tiny MoE decoders of test_torch_moe.py (float
    experts) and test_torch_moe_int4.py (packed int4 experts)."""
    if kind == "moe":
        return test_torch_moe._tiny_pair()
    cfg = test_torch_moe_int4.TINY
    tok = jtok.SimpleTokenizer(cfg["vocab_size"])
    base = jdec.LocalLLM(jdec.LlamaConfig(**dict(cfg, quantization="none")), tok, seed=3)
    params = _numpy_tree(jloader.quantize_decoder_params(_numpy_tree(base.params), bits=4))
    j = jdec.LocalLLM(jdec.LlamaConfig(**cfg), tok, params=params)
    t = decoder.LocalLLM(decoder.LlamaConfig(**cfg),
                         tokenizer.SimpleTokenizer(cfg["vocab_size"]),
                         params=convert.flax_to_state_dict(params), device="cpu")
    return j, t


@pytest.fixture(scope="module", params=["moe", "int4-moe"])
def moe_llms(request):
    return _moe_pair(request.param)


def test_moe_speculative_matches_jax(moe_llms):
    """``generate_speculative`` at the default penalty equals JAX's and the
    port's plain greedy, with drafts accepted, and ``generate``'s default
    T = 0 route gives the same tokens. (JAX's stats are not compared: its
    loop runs to a power of two past the first token and cuts the tokens
    after.)"""
    j, t = moe_llms
    p = [int(x) for x in np.random.default_rng(1).integers(4, 512, 60)]
    want = j.generate_speculative(p, max_new_tokens=24)
    got, stats = t.generate_speculative(p, max_new_tokens=24, return_stats=True)
    plain = t.generate(p, max_new_tokens=24, temperature=0.0, speculative="off")
    assert got == want == plain and len(got) == 24
    assert stats["accepted"] > 0
    assert t.generate(p, max_new_tokens=24, temperature=0.0) == want


def test_moe_spec_wave_matches_jax(moe_llms):
    """Spec waves on the MoE decoders (3 rows and a pad row, 4-token
    chunks) equal the JAX engine's, streams and acceptance EWMA."""
    prompts = {"a": [5, 17, 101, 42, 5, 17], "b": [9, 8, 7, 6, 5],
               "c": [200, 300, 200, 300]}

    def drive(eng):
        for k, v in prompts.items():
            eng.add_request(k, v, max_new_tokens=8, temperature=0.0,
                            repetition_penalty=1.1)
        return eng.run_spec(iters=2, draft=4), eng._spec_accept
    want, got = _both(moe_llms, drive)
    assert got == want
