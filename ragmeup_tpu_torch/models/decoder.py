"""Llama-class causal decoder: the local chat LLM.

Counterpart of ``ragmeup_tpu/models/decoder.py`` for the dense-cache
generate path: RMSNorm → GQA attention with RoPE (llama3/linear frequency
scaling) → SwiGLU, weight-only int8 projections (``QuantDense``), a KV cache
of shape (b, cache_len, nkv, hd) updated in place, prefill through the
causal flash kernel and decode through a grouped einsum with the additive
mask. ``LocalLLM.generate`` samples at T > 0 (an explicit
``torch.Generator``) and decodes greedily at T = 0.

Parameters keep the JAX package's names and layouts (kernels are
``(in, out)``; int8 kernels ``kernel_q (in, out)`` with ``scale (out,)``),
so ``models/convert.py`` loads flax trees as they are. Paged serving, MoE,
int4, tensor parallelism, speculative decoding and ``qk_forward`` are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ragmeup_tpu_torch.models.layers import RMSNorm
from ragmeup_tpu_torch.ops.attention import flash_attention, flash_attention_gqa
from ragmeup_tpu_torch.ops.quant_matmul import MAX_ROWS, int8_matmul

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_BLOCK = 128  # prefill takes the flash kernel when s and kv_len are multiples


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    rope_theta: float = 500000.0
    max_seq_len: int = 8192
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    quantization: str = "none"  # none | int8
    tie_embeddings: bool = True  # Llama-3.1-8B uses an untied lm_head
    # the int8 decode kernel for QuantDense with at most 8 rows
    quant_kernel: bool = False
    # the causal flash kernel for prefill
    use_flash: bool = False
    rope_scaling_type: str = "none"  # none | llama3 | linear
    rope_scaling_factor: float = 1.0
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_position: int = 8192

    def __post_init__(self):
        if self.quantization not in ("none", "int8"):
            raise NotImplementedError(
                f"quantization={self.quantization!r}: only none and int8 are "
                "ported (ROADMAP queue 1: int4)")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                    num_kv_heads=2, intermediate_size=128, max_seq_len=256,
                    rope_theta=10000.0)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama31_8b(**kw) -> "LlamaConfig":
        """Llama-3.1-8B's shape (scripts/make_synthetic_8b.py): the defaults
        above with int8 weights, an untied lm_head and llama3 rope scaling."""
        base = dict(quantization="int8", tie_embeddings=False,
                    rope_scaling_type="llama3", rope_scaling_factor=8.0,
                    rope_scaling_low_freq_factor=1.0,
                    rope_scaling_high_freq_factor=4.0,
                    rope_scaling_original_max_position=8192)
        base.update(kw)
        return LlamaConfig(**base)


def scale_inv_freq_llama3(inv: np.ndarray, factor: float,
                          low_freq_factor: float, high_freq_factor: float,
                          original_max_position: int) -> np.ndarray:
    """Llama-3.1 rope scaling (HF _compute_llama3_parameters): long
    wavelengths divided by `factor`, short ones untouched, smooth
    interpolation between the two wavelength thresholds."""
    low_wavelen = original_max_position / low_freq_factor
    high_wavelen = original_max_position / high_freq_factor
    wavelen = 2.0 * np.pi / inv
    smooth = (original_max_position / wavelen - low_freq_factor) / \
        max(high_freq_factor - low_freq_factor, 1e-9)
    interp = (1.0 - smooth) * inv / factor + smooth * inv
    out = np.where(wavelen > low_wavelen, inv / factor, inv)
    mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return np.where(mid, interp, out)


def rope_inv_freq(head_dim: int, theta: float,
                  cfg: Optional[LlamaConfig] = None) -> np.ndarray:
    """(hd/2,) inverse frequencies with any configured scaling applied."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if cfg is not None and cfg.rope_scaling_type == "llama3":
        inv = scale_inv_freq_llama3(
            inv, cfg.rope_scaling_factor, cfg.rope_scaling_low_freq_factor,
            cfg.rope_scaling_high_freq_factor,
            cfg.rope_scaling_original_max_position)
    elif cfg is not None and cfg.rope_scaling_type == "linear":
        inv = inv / cfg.rope_scaling_factor
    return inv.astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, hd); cos/sin: (s, hd/2). Computes in f32."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def quantize_kernel_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an (in, out) kernel →
    (kernel_q int8 (in, out), scale f32 (out,)); runs where w lives."""
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=0, keepdim=True), 1e-8) / 127
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale[0]


class QuantDense(nn.Module):
    """Weight-only int8 linear (per-output-channel scale), or a plain f32
    kernel when quantization is off. Rows ≤ 8 with 512-multiple dims take
    the int8 kernel (``use_kernel``); other shapes dequantize and multiply."""

    def __init__(self, in_features: int, features: int, quantize: bool,
                 dtype: torch.dtype, use_kernel: bool = False, device=None):
        super().__init__()
        self.features = features
        self.quantize = quantize
        self.dtype = dtype
        self.use_kernel = use_kernel
        if quantize:
            self.register_buffer("kernel_q", torch.zeros(
                in_features, features, dtype=torch.int8, device=device))
            self.register_buffer("scale", torch.ones(features, device=device))
        else:
            self.kernel = nn.Parameter(torch.zeros(in_features, features,
                                                   device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        d_in = x.shape[-1]
        x2 = x.reshape(-1, d_in)
        if not self.quantize:
            out = x2 @ self.kernel.to(self.dtype)
        elif (self.use_kernel and x2.shape[0] <= MAX_ROWS
              and d_in % 512 == 0 and self.features % 512 == 0):
            # decode: the int8 weights are read once, dequant in the epilogue
            out = int8_matmul(x2.to(self.dtype), self.kernel_q, self.scale)
        else:
            wd = self.kernel_q.to(self.dtype) * self.scale.to(self.dtype)[None, :]
            out = x2.to(self.dtype) @ wd
        return out.reshape(*lead, self.features)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        hd, nh, nkv = c.head_dim, c.num_heads, c.num_kv_heads
        quant = c.quantization == "int8"
        dt = c.torch_dtype

        def dense(i, o):
            return QuantDense(i, o, quant, dt, c.quant_kernel, device)
        self.q_proj = dense(c.hidden_size, nh * hd)
        self.k_proj = dense(c.hidden_size, nkv * hd)
        self.v_proj = dense(c.hidden_size, nkv * hd)
        self.o_proj = dense(nh * hd, c.hidden_size)

    def forward(self, x, cos, sin, attn_bias=None, cache=None, cache_pos=0):
        c = self.cfg
        b, s, _ = x.shape
        hd, nh, nkv = c.head_dim, c.num_heads, c.num_kv_heads
        dt = c.torch_dtype
        q = self.q_proj(x).reshape(b, s, nh, hd)
        k = self.k_proj(x).reshape(b, s, nkv, hd)
        v = self.v_proj(x).reshape(b, s, nkv, hd)
        # rope rotates in f32, then back to the model dtype
        q = apply_rope(q, cos, sin).to(dt)
        k = apply_rope(k, cos, sin).to(dt)
        if cache is not None:
            ck, cv = cache  # (b, L, nkv, hd), updated in place
            ck[:, cache_pos:cache_pos + s] = k
            cv[:, cache_pos:cache_pos + s] = v
            k, v = ck, cv
        rep = nh // nkv
        scale = 1.0 / float(np.sqrt(hd))
        kv_len = k.shape[1]
        use_flash = (c.use_flash and s > 1 and s % FLASH_BLOCK == 0
                     and kv_len % FLASH_BLOCK == 0)
        if use_flash:
            # prefill: causal flash; padded keys sit past every real query
            # row, so the causal mask subsumes the padding mask (the additive
            # bias is not read, as in the JAX flash path)
            kf = k.transpose(1, 2).reshape(b * nkv, kv_len, hd)
            vf = v.transpose(1, 2).reshape(b * nkv, kv_len, hd)
            if rep > 1:
                qg = q.transpose(1, 2).reshape(b * nkv, rep, s, hd)
                og = flash_attention_gqa(qg, kf, vf, causal=True, sm_scale=scale)
            else:
                qf = q.transpose(1, 2).reshape(b * nh, s, hd)
                og = flash_attention(qf, kf, vf, causal=True, sm_scale=scale)
            out = og.reshape(b, nh, s, hd).transpose(1, 2)
        else:
            # grouped-query attention without repeating K/V: q head h reads
            # kv head h // rep
            q5 = q.reshape(b, s, nkv, rep, hd)
            logits = torch.einsum("bqnrd,bknd->bnrqk", q5.float(), k.float()) * scale
            if attn_bias is not None:
                logits = logits + attn_bias[..., None, :, :]
            weights = torch.softmax(logits, dim=-1)
            out = torch.einsum("bnrqk,bknd->bqnrd", weights.to(dt), v)
        return self.o_proj(out.reshape(b, s, nh * hd))


class LlamaMlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        quant = cfg.quantization == "int8"
        dt = cfg.torch_dtype
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = QuantDense(h, f, quant, dt, cfg.quant_kernel, device)
        self.up_proj = QuantDense(h, f, quant, dt, cfg.quant_kernel, device)
        self.down_proj = QuantDense(f, h, quant, dt, cfg.quant_kernel, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        dt = cfg.torch_dtype
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dt, device)
        self.attention = LlamaAttention(cfg, device)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dt, device)
        self.mlp = LlamaMlp(cfg, device)

    def forward(self, x, cos, sin, attn_bias, cache, cache_pos):
        x = x + self.attention(self.input_norm(x), cos, sin, attn_bias, cache,
                               cache_pos)
        return x + self.mlp(self.post_attn_norm(x))


class LlamaModel(nn.Module):
    """Causal LM over a dense KV cache (prefill: full prompt from position
    0; decode: one token at ``cache_pos``)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.token_embedding = nn.Parameter(
            torch.zeros(c.vocab_size, c.hidden_size, device=device))
        self.layers = nn.ModuleList(LlamaBlock(c, device)
                                    for _ in range(c.num_layers))
        self.final_norm = RMSNorm(c.hidden_size, c.rms_eps, c.torch_dtype, device)
        if not c.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros(c.hidden_size, c.vocab_size, device=device))
        self.register_buffer("inv_freq", torch.from_numpy(
            rope_inv_freq(c.head_dim, c.rope_theta, cfg=c)).to(device),
            persistent=False)
        self._head_f32: Optional[torch.Tensor] = None

    def head(self) -> Tuple[torch.Tensor, torch.dtype]:
        """(head (hidden, vocab) as f32, its stored dtype). The stored head
        may be bf16; logits are f32 sums of products of its values, so the
        head is widened once and kept (serving never changes weights)."""
        w = self.token_embedding.T if self.cfg.tie_embeddings else self.lm_head
        if self._head_f32 is None:
            self._head_f32 = w.detach().float()
        return self._head_f32, w.dtype

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                caches: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
                cache_pos: int = 0, head_at: Optional[int] = None
                ) -> torch.Tensor:
        """→ f32 logits (b, s, vocab), or (b, 1, vocab) at ``head_at``."""
        c = self.cfg
        x = self.token_embedding[input_ids].to(c.torch_dtype)
        ang = positions.float()[..., None] * self.inv_freq
        cos, sin = torch.cos(ang), torch.sin(ang)
        for i, layer in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            x = layer(x, cos, sin, attn_bias, cache, cache_pos)
        x = self.final_norm(x)
        if head_at is not None:
            x = x[:, head_at:head_at + 1]
        head, head_dtype = self.head()
        return x.to(head_dtype).float() @ head


def causal_bias(q_len: int, kv_len: int, device=None) -> torch.Tensor:
    """(1, 1, q, kv) additive causal mask; query i may attend kv positions
    <= i."""
    qpos = torch.arange(q_len, device=device)[:, None]
    kpos = torch.arange(kv_len, device=device)[None, :]
    return torch.where(kpos <= qpos, 0.0, -1e30)[None, None]


def init_decoder_params(cfg: LlamaConfig, generator: torch.Generator,
                        device=None, std: float = 0.02
                        ) -> Dict[str, torch.Tensor]:
    """Random weights drawn on ``device``: N(0, std) kernels and embeddings,
    unit norms. With ``cfg.quantization == "int8"`` every kernel is
    quantized right after it is drawn and the embeddings/lm_head stored in
    bf16 (the int8 branch of ``quantize_decoder_params``), so an 8B model
    never exists in f32 at once."""
    c = cfg
    hd = c.head_dim
    quant = c.quantization == "int8"
    out: Dict[str, torch.Tensor] = {}

    def draw(*shape):
        return torch.empty(shape, device=device).normal_(0.0, std,
                                                         generator=generator)

    def kernel(name, i, o):
        w = draw(i, o)
        if quant:
            out[f"{name}.kernel_q"], out[f"{name}.scale"] = quantize_kernel_int8(w)
        else:
            out[f"{name}.kernel"] = w

    def ones(name, n):
        out[name] = torch.ones(n, device=device)

    emb_dtype = torch.bfloat16 if quant else torch.float32
    out["token_embedding"] = draw(c.vocab_size, c.hidden_size).to(emb_dtype)
    for i in range(c.num_layers):
        p = f"layers.{i}"
        ones(f"{p}.input_norm.scale", c.hidden_size)
        kernel(f"{p}.attention.q_proj", c.hidden_size, c.num_heads * hd)
        kernel(f"{p}.attention.k_proj", c.hidden_size, c.num_kv_heads * hd)
        kernel(f"{p}.attention.v_proj", c.hidden_size, c.num_kv_heads * hd)
        kernel(f"{p}.attention.o_proj", c.num_heads * hd, c.hidden_size)
        ones(f"{p}.post_attn_norm.scale", c.hidden_size)
        kernel(f"{p}.mlp.gate_proj", c.hidden_size, c.intermediate_size)
        kernel(f"{p}.mlp.up_proj", c.hidden_size, c.intermediate_size)
        kernel(f"{p}.mlp.down_proj", c.intermediate_size, c.hidden_size)
    ones("final_norm.scale", c.hidden_size)
    if not c.tie_embeddings:
        out["lm_head"] = draw(c.hidden_size, c.vocab_size).to(emb_dtype)
    return out


class LocalLLM:
    """Generation wrapper: prefill + stepwise decode with temperature
    sampling and repetition penalty."""

    PREFILL_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)

    def __init__(self, cfg: LlamaConfig, tokenizer,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, eos_ids: Sequence[int] = (), device=None):
        """``params``: a state dict (``init_decoder_params``,
        ``convert.flax_to_state_dict``); its tensors are adopted as they are
        (dtype and device). None draws ``init_decoder_params`` from
        ``seed`` on ``device``."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.eos_ids = set(int(e) for e in eos_ids)
        self.device = torch.device(device or "cpu")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_decoder_params(cfg, gen, self.device)
        with torch.device("meta"):
            model = LlamaModel(cfg)
        model.load_state_dict(params, strict=True, assign=True)
        # the rope table is not a weight: rebuild it where the weights live
        model.inv_freq = torch.from_numpy(
            rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg=cfg)).to(self.device)
        self.model = model.requires_grad_(False).eval()

    # -- prefill / decode -------------------------------------------------------

    def _prefill(self, ids: torch.Tensor, length: int, cache_len: int):
        """ids: (1, L) padded prompt; length: real prompt length. Returns
        (logits of the last real token (vocab,), caches of cache_len)."""
        c = self.cfg
        L = ids.shape[1]
        dev = self.device
        kmask = torch.where(torch.arange(cache_len, device=dev) < length,
                            0.0, -1e30)[None, None, None, :]
        bias = causal_bias(L, cache_len, device=dev) + kmask
        caches = [tuple(torch.zeros((1, cache_len, c.num_kv_heads, c.head_dim),
                                    dtype=c.torch_dtype, device=dev)
                        for _ in range(2))
                  for _ in range(c.num_layers)]
        logits = self.model(ids, torch.arange(L, device=dev), attn_bias=bias,
                            caches=caches, cache_pos=0, head_at=length - 1)
        return logits[0, 0], caches

    def _decode(self, token: int, pos: int, caches):
        """One token at absolute position ``pos`` against the cache."""
        dev = self.device
        kv_len = caches[0][0].shape[1]
        kmask = torch.where(torch.arange(kv_len, device=dev) <= pos,
                            0.0, -1e30)[None, None, None, :]
        ids = torch.tensor([[token]], device=dev)
        logits = self.model(ids, torch.tensor([pos], device=dev),
                            attn_bias=kmask, caches=caches, cache_pos=pos)
        return logits[0, -1]

    def _bucket(self, n: int) -> int:
        for b in self.PREFILL_BUCKETS:
            if n <= b:
                return min(b, self.cfg.max_seq_len)
        return self.cfg.max_seq_len

    def _padded(self, ids: Sequence[int], L: int) -> torch.Tensor:
        padded = torch.zeros((1, L), dtype=torch.long)
        padded[0, :len(ids)] = torch.as_tensor(list(ids), dtype=torch.long)
        return padded.to(self.device)

    # -- public ------------------------------------------------------------------

    @torch.inference_mode()
    def forward_logits(self, ids: Sequence[int]) -> np.ndarray:
        """Logits after the last token of ``ids`` (tests/eval)."""
        L = self._bucket(len(ids))
        logits, _ = self._prefill(self._padded(ids, L), len(ids), cache_len=L)
        return logits.cpu().numpy()

    @torch.inference_mode()
    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int = 100,
                 temperature: float = 0.2, repetition_penalty: float = 1.1,
                 seed: int = 0) -> List[int]:
        """Continuation token ids (prompt not included): greedy at
        temperature 0, else sampled from softmax(logits / T) with a
        ``torch.Generator`` seeded by ``seed``."""
        max_prompt = self.cfg.max_seq_len - min(max_new_tokens,
                                                self.cfg.max_seq_len // 2)
        if len(prompt_ids) > max_prompt:
            prompt_ids = list(prompt_ids)[-max_prompt:]
        n = len(prompt_ids)
        cache_len = self._bucket(n + max_new_tokens)
        logits, caches = self._prefill(self._padded(prompt_ids, self._bucket(n)),
                                       n, cache_len=cache_len)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        penalize = bool(repetition_penalty) and repetition_penalty != 1.0
        seen = torch.zeros(self.cfg.vocab_size, dtype=torch.bool,
                           device=self.device)
        if penalize and n:
            seen[torch.as_tensor(sorted(set(map(int, prompt_ids))),
                                 device=self.device)] = True
        out: List[int] = []
        pos = n
        for _ in range(max_new_tokens):
            lg = logits
            if penalize:
                pen = torch.where(lg > 0, lg / repetition_penalty,
                                  lg * repetition_penalty)
                lg = torch.where(seen, pen, lg)
            if temperature and temperature > 0:
                probs = torch.softmax(lg / temperature, dim=-1)
                tok = int(torch.multinomial(probs, 1, generator=gen))
            else:
                tok = int(torch.argmax(lg))
            if tok in self.eos_ids:
                break
            out.append(tok)
            seen[tok] = True
            logits = self._decode(tok, pos, caches)
            pos += 1
            if pos >= cache_len:
                break
        return out

    def generate_text(self, prompt: str, max_new_tokens: int = 100,
                      temperature: float = 0.2, repetition_penalty: float = 1.1,
                      seed: int = 0) -> str:
        ids = self.tokenizer.encode(prompt)
        out = self.generate(ids, max_new_tokens, temperature,
                            repetition_penalty, seed)
        if hasattr(self.tokenizer, "decode"):
            return self.tokenizer.decode(out)
        return " ".join(str(t) for t in out)
